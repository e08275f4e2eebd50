"""tests/test_trigrid.py's gates on the port's uniform-grid triangle
accelerator (ops/trigrid.py through models/shapes.py::TriangleMesh): the
grid's closest hits equal the brute-force scan's, misses and t_max clip,
and the CSR grid lists every triangle in its centroid's cell."""
import numpy as np
import torch

from acceleratedvolrenderer_tpu_torch.models import shapes as shp
from acceleratedvolrenderer_tpu_torch.ops import trigrid


def _random_mesh(n_tri, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    c = rng.random((n_tri, 3)) * 2 - 1
    a = c + rng.normal(0, 0.08, (n_tri, 3))
    b = c + rng.normal(0, 0.08, (n_tri, 3))
    v = np.concatenate([c, a, b]).astype(np.float32) * scale
    idx = np.stack([np.arange(n_tri), np.arange(n_tri) + n_tri,
                    np.arange(n_tri) + 2 * n_tri], -1).astype(np.int32)
    return v, idx


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_grid_matches_bruteforce():
    v, idx = _random_mesh(800, seed=3)
    brute = shp.TriangleMesh(vertices=v, indices=idx, grid_threshold=10**9)
    grid = shp.TriangleMesh(vertices=v, indices=idx, grid_threshold=1)
    rng = np.random.default_rng(1)
    n = 512
    o = _t(rng.random((n, 3)) * 4 - 2)
    d = rng.normal(size=(n, 3))
    d = _t(d / np.linalg.norm(d, axis=1, keepdims=True))
    tb, nb, _ = brute.intersect(o, d, torch.inf)
    tg, ng, _ = grid.intersect(o, d, torch.inf)
    tb, tg = tb.numpy(), tg.numpy()
    hit = np.isfinite(tb)
    assert np.array_equal(hit, np.isfinite(tg))
    assert np.allclose(tb[hit], tg[hit], rtol=1e-5, atol=1e-5)
    assert np.allclose(nb.numpy()[hit], ng.numpy()[hit], rtol=1e-4,
                       atol=1e-4)


def test_grid_misses_and_tmax():
    v, idx = _random_mesh(600, seed=5)
    mesh = shp.TriangleMesh(vertices=v, indices=idx, grid_threshold=1)
    n = 64
    o = torch.broadcast_to(_t([5.0, 5.0, 5.0]), (n, 3))
    d = torch.broadcast_to(_t([1.0, 0.0, 0.0]), (n, 3))
    t, _, _ = mesh.intersect(o, d, torch.inf)
    assert not np.isfinite(t.numpy()).any()
    o2, d2 = _t([[0.0, 0.0, -5.0]]), _t([[0.0, 0.0, 1.0]])
    t_hit, _, _ = mesh.intersect(o2, d2, torch.inf)
    if np.isfinite(float(t_hit[0])):
        t_clip, _, _ = mesh.intersect(o2, d2, float(t_hit[0]) * 0.5)
        assert not np.isfinite(float(t_clip[0]))


def test_grid_build_csr_consistent():
    v, idx = _random_mesh(100, seed=7)
    g = trigrid.build_tri_grid(v, idx)
    rx, ry, rz = g.res
    cs, ids = g.cell_start.numpy(), g.tri_ids.numpy()
    assert cs[0] == 0 and cs[-1] == ids.shape[0]
    assert (np.diff(cs) >= 0).all()
    cen = g.p0.numpy() + (g.e1.numpy() + g.e2.numpy()) / 3
    lo, hi = g.bbox_lo.numpy(), g.bbox_hi.numpy()
    cc = np.clip(((cen - lo) / (hi - lo) * [rx, ry, rz]).astype(int), 0,
                 np.array([rx, ry, rz]) - 1)
    flat = (cc[:, 2] * ry + cc[:, 1]) * rx + cc[:, 0]
    for t in range(0, 100, 7):
        assert t in ids[cs[flat[t]]: cs[flat[t] + 1]]
