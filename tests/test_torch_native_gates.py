"""tests/test_native.py's gates on the port's native merge and KD-tree
(native/kdtree.cpp through native/__init__.py), against brute force."""
import numpy as np

from acceleratedvolrenderer_tpu_torch import native


def test_native_builds():
    assert native.is_available(), "g++ toolchain should be present here"


def test_merge_semantics_sequential():
    """A point joins the nearest vertex within the radius in insertion
    order (free_graph_builder.cpp:99-117)."""
    pts = np.array([[0.0, 0.0, 0.0], [0.05, 0.0, 0.0], [0.2, 0.0, 0.0],
                    [0.13, 0.0, 0.0], [5.0, 5.0, 5.0]], np.float32)
    labels, verts, counts = native.merge_points(pts, radius=0.1)
    assert labels.tolist() == [0, 0, 1, 1, 2]
    assert len(verts) == 3
    assert counts.tolist() == [2, 2, 1]
    assert np.allclose(verts[1], [0.2, 0.0, 0.0])


def test_merge_matches_bruteforce_random():
    rng = np.random.default_rng(3)
    pts = rng.random((500, 3)).astype(np.float32)
    radius = 0.08
    labels, verts, counts = native.merge_points(pts, radius)
    bverts, blabels = [], []
    for p in pts:
        if bverts:
            d2 = ((np.asarray(bverts) - p) ** 2).sum(1)
            j = int(np.argmin(d2))
            if d2[j] <= radius * radius:
                blabels.append(j)
                continue
        blabels.append(len(bverts))
        bverts.append(p)
    assert labels.tolist() == blabels
    assert len(verts) == len(bverts)
    assert counts.sum() == len(pts)


def test_knn_matches_bruteforce():
    rng = np.random.default_rng(0)
    pts = rng.random((800, 3)).astype(np.float32)
    q = rng.random((50, 3)).astype(np.float32)
    idx, d2 = native.KDTree(pts).knn(q, 5)
    ref_d2 = np.sort(((q[:, None] - pts[None]) ** 2).sum(-1), axis=1)[:, :5]
    assert np.allclose(np.sort(d2, axis=1), ref_d2, rtol=1e-5)


def test_radius_stats_matches_bruteforce():
    rng = np.random.default_rng(1)
    pts = rng.random((400, 3)).astype(np.float32)
    q = rng.random((30, 3)).astype(np.float32)
    counts, sumd2 = native.KDTree(pts).radius_stats(q, 0.2)
    d2f = ((q[:, None] - pts[None]) ** 2).sum(-1)
    m = d2f <= 0.04
    assert (counts == m.sum(1)).all()
    assert np.allclose(sumd2, np.where(m, d2f, 0).sum(1), rtol=1e-4)


def test_knn_small_n_padding():
    idx, d2 = native.KDTree(np.zeros((2, 3), np.float32)).knn(
        np.zeros((1, 3), np.float32), 5)
    assert (idx[0, 2:] == -1).all()
    assert np.isinf(d2[0, 2:]).all()
