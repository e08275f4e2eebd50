"""The port's graph radiance-cache layer (graph/, native/,
models/integrators/graph.py, parallel/render.py::render_graph,
cli/graph_maker.py) against the JAX package's, at small sizes.

Each stage gets identical inputs (the JAX stage's outputs where it follows
another), so that ulps in one stage cannot flip a merge in the next.
Tolerances:
- files, entry rays, the node radius, merges, search ranges, vertex ids,
  the host power iteration's inputs, analyzer counts and voxel shells:
  equal (the same numpy code and the same native merge, built with the
  same flags);
- traced scatter points: rtol 1e-5 / atol 1e-6 on >= 99% of paths, the
  valid masks equal on >= 99% (exp, log1p and pow differ by ulps between
  XLA:CPU and torch, and a flipped comparison reroutes a path);
- light vector, final light (host and device paths), cache lookups: rtol
  1e-5 (sums taken in another order); the light vector with atol 1e-7,
  1e-5 of a typical vertex's light (where density equals the majorant,
  sig_n cancels to a few ulps that XLA and torch round differently, so a
  shadow ray may keep T ~ 1e-7 in one package and reach 0 in the other);
- graph renders: frame means to 1e-3 relative, >= 99% of pixels to rtol
  1e-3 / atol 1e-5;
- the whole build and lighting: equal vertex and edge counts, light scalars
  to rtol 1e-4 on >= 99% of vertices."""
import subprocess
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.graph import analyzer as janalyzer
from acceleratedvolrenderer_tpu.graph import builder as jbuilder
from acceleratedvolrenderer_tpu.graph import lighting as jlighting
from acceleratedvolrenderer_tpu.graph import voxels as jvoxels
from acceleratedvolrenderer_tpu.graph.config import (
    GraphBuilderConfig as JBuilderConfig)
from acceleratedvolrenderer_tpu.graph.model import Graph as JGraph
from acceleratedvolrenderer_tpu.models import lights as jlights
from acceleratedvolrenderer_tpu.models.cameras import (
    PerspectiveCamera as JCamera)
from acceleratedvolrenderer_tpu.models.film import BoxFilter as JBox
from acceleratedvolrenderer_tpu.models.integrators import graph as jgi
from acceleratedvolrenderer_tpu.ops import dda as jdda
from acceleratedvolrenderer_tpu.parallel import render as jrender
from acceleratedvolrenderer_tpu.scene import Scene as JScene
from acceleratedvolrenderer_tpu.utils import vecmath as jvm
from acceleratedvolrenderer_tpu_torch import native
from acceleratedvolrenderer_tpu_torch.cli import graph_maker
from acceleratedvolrenderer_tpu_torch.graph import analyzer as tanalyzer
from acceleratedvolrenderer_tpu_torch.graph import builder as tbuilder
from acceleratedvolrenderer_tpu_torch.graph import lighting as tlighting
from acceleratedvolrenderer_tpu_torch.graph import voxels as tvoxels
from acceleratedvolrenderer_tpu_torch.graph.config import (
    GraphBuilderConfig, GraphConfig, LightingCalculatorConfig)
from acceleratedvolrenderer_tpu_torch.graph.model import Graph
from acceleratedvolrenderer_tpu_torch.models.integrators import graph as tgi
from acceleratedvolrenderer_tpu_torch.models.media import MediumSpec
from acceleratedvolrenderer_tpu_torch.ops import dda as tdda
from acceleratedvolrenderer_tpu_torch.parallel import render as trender
from acceleratedvolrenderer_tpu_torch.scene import convert, presets
from acceleratedvolrenderer_tpu_torch.utils import spectrum as tsp

from test_graph import sphere_medium_spec
from test_voxel_boundary import _sphere_majorant
from torch_port_util import arrays_from_jax_scene

torch.set_num_threads(2)

LIGHT = np.array([0.0, -1.0, 0.0])
# tests/test_graph.py::test_build_and_light_and_render's configuration
BUILD = dict(dimension_steps=24, iterations_per_step=2, radius_modifier=20.0,
             max_depth=4)
LIGHTING = dict(light_rays=8, bounces=3)
SEED = 1
FIELDS = ("positions", "light_scalar", "search_range", "vertex_samples",
          "edges", "edge_samples", "edge_weight", "coors", "paths_flat",
          "paths_index")


def port_spec():
    """The port's copy of tests/test_graph.py's 32^3 sphere medium."""
    js = sphere_medium_spec()
    return MediumSpec(
        sigma_a_spec=tsp.constant_spectrum(0.1),
        sigma_s_spec=tsp.constant_spectrum(0.9), g=0.0, scale=3.0,
        density=torch.as_tensor(js.density), bounds_lo=js.bounds_lo,
        bounds_hi=js.bounds_hi, majorant_res=(8, 8, 8))


@pytest.fixture(scope="module")
def jax_graph():
    """The JAX package's graph of test_graph.py's build, lit."""
    js = sphere_medium_spec()
    g = jbuilder.FreeGraphBuilder(js, LIGHT, JBuilderConfig(**BUILD),
                                  seed=SEED).build()
    L0 = jlighting.light_vector(g, js, LIGHT, LIGHTING["light_rays"],
                                seed=SEED)
    g.light_scalar = jlighting.compute_final_light(g, L0,
                                                   LIGHTING["bounces"])
    return g, L0


def port_graph(jg):
    """The port's Graph of the same arrays."""
    return Graph(**{k: getattr(jg, k) for k in FIELDS}, kind=jg.kind,
                 description=jg.description, vertex_radius=jg.vertex_radius,
                 spacing=jg.spacing)


def assert_graphs_equal(a, b):
    assert (a.kind, a.description, a.vertex_radius, a.spacing) == (
        b.kind, b.description, b.vertex_radius, b.spacing)
    for k in FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def random_graph(cls, with_paths):
    rng = np.random.default_rng(0)
    kw = {}
    if with_paths:
        kw = dict(paths_flat=rng.integers(0, 40, 12).astype(np.int32),
                  paths_index=np.array([[0, 5], [5, 7]], np.int32),
                  edge_weight=rng.random(90).astype(np.float32),
                  coors=rng.integers(-3, 9, (40, 3)).astype(np.int32),
                  kind="uniform", spacing=0.25)
    return cls(
        positions=rng.random((40, 3)).astype(np.float32),
        light_scalar=rng.random(40).astype(np.float32),
        search_range=rng.random(40).astype(np.float32),
        vertex_samples=rng.integers(1, 9, 40).astype(np.int32),
        edges=rng.integers(0, 40, (90, 2)).astype(np.int32),
        edge_samples=rng.integers(1, 5, 90).astype(np.int32),
        vertex_radius=0.01 if not with_paths else 0.0, description="t", **kw)


@pytest.mark.parametrize("fmt", ["txt", "npz"])
@pytest.mark.parametrize("with_paths", [False, True])
def test_graph_files_cross(tmp_path, fmt, with_paths):
    """A graph written by the JAX package reads back in the port with equal
    arrays, and the reverse; the text files are byte-identical."""
    jg, tg = random_graph(JGraph, with_paths), random_graph(Graph, with_paths)
    j_path, t_path = str(tmp_path / f"j.{fmt}"), str(tmp_path / f"t.{fmt}")
    getattr(jg, f"write_{'text' if fmt == 'txt' else fmt}")(j_path)
    getattr(tg, f"write_{'text' if fmt == 'txt' else fmt}")(t_path)
    read = "read_text" if fmt == "txt" else "read_npz"
    assert_graphs_equal(getattr(Graph, read)(j_path),
                        getattr(JGraph, read)(j_path))
    assert_graphs_equal(getattr(JGraph, read)(t_path),
                        getattr(Graph, read)(t_path))
    if fmt == "txt":
        assert (tmp_path / "j.txt").read_bytes() == \
            (tmp_path / "t.txt").read_bytes()
    assert tg.stats() == jg.stats()


def test_entry_rays_and_radius_equal():
    js, ts = sphere_medium_spec(), port_spec()
    for a, b in zip(jbuilder.entry_rays(js, LIGHT, 24),
                    tbuilder.entry_rays(ts, torch.tensor(LIGHT), 24)):
        np.testing.assert_array_equal(a, b)
    assert tbuilder.same_spot_radius(ts, 20.0) == \
        jbuilder.same_spot_radius(js, 20.0)


def test_trace_scatter_paths_matches_jax():
    js, ts = sphere_medium_spec(), port_spec()
    o, d = jbuilder.entry_rays(js, LIGHT, 24)
    n = o.shape[0]
    rng = jdda.seed_stream(jnp.arange(n), jnp.full((n,), 1, jnp.uint32),
                           salt=SEED)
    jm = js.build_arrays(jnp.zeros((1, 4)))
    jp, jv, jr = jbuilder.trace_scatter_paths(
        jm, jnp.asarray(o), jnp.asarray(d), rng, js.maj_res(), False, 4)
    tm = ts.build_arrays(torch.zeros((1, 4)))
    tp, tv, tr = tbuilder.trace_scatter_paths(
        tm, torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(np.asarray(rng).astype(np.int64)), ts.maj_res(),
        False, 4)
    jp, jv = np.asarray(jp), np.asarray(jv)
    tp, tv = tp.numpy(), tv.numpy()
    assert tp.shape == jp.shape and tv.shape == jv.shape
    same = (tv == jv).all(-1)
    assert same.mean() >= 0.99 and jv.sum() > n // 4
    close = np.isclose(tp, jp, rtol=1e-5, atol=1e-6).all((-1, -2))
    assert close.mean() >= 0.99
    assert (tr.numpy() == np.asarray(jr).astype(np.int64)).mean() >= 0.99


@pytest.fixture(scope="module")
def jax_points():
    """Scatter points of the JAX trace, for the merges."""
    js = sphere_medium_spec()
    o, d = jbuilder.entry_rays(js, LIGHT, 32)
    n = o.shape[0]
    rng = jdda.seed_stream(jnp.arange(n), jnp.zeros((n,), jnp.uint32), salt=3)
    pts, valid, _ = jbuilder.trace_scatter_paths(
        js.build_arrays(jnp.zeros((1, 4))), jnp.asarray(o), jnp.asarray(d),
        rng, js.maj_res(), False, 4)
    return np.asarray(pts), np.asarray(valid)


def as_port(g):
    return port_graph(g) if isinstance(g, JGraph) else g


@pytest.mark.parametrize("exact", [True, False])
def test_merges_on_jax_points_equal(jax_points, exact):
    """merge_paths_to_graph, merge_graphs, compute_search_ranges and
    _positions_to_ids fed the JAX trace's points give identical graphs."""
    pts, valid = jax_points
    radius = jbuilder.same_spot_radius(sphere_medium_spec(), 5.0)
    ja = jbuilder.merge_paths_to_graph(pts, valid, radius, exact=exact)
    ta = tbuilder.merge_paths_to_graph(pts, valid, radius, exact=exact)
    assert_graphs_equal(ta, port_graph(ja))
    assert ja.n_vertices > 100 and ja.n_edges > 50, (ja.n_vertices,
                                                     ja.n_edges)
    if not exact:
        return
    half = pts.shape[0] // 2
    jb = jbuilder.merge_paths_to_graph(pts[half:], valid[half:], radius)
    tb = tbuilder.merge_paths_to_graph(pts[half:], valid[half:], radius)
    assert_graphs_equal(tbuilder.merge_graphs(ta, tb, radius),
                        port_graph(jbuilder.merge_graphs(ja, jb, radius)))
    for k, rounds in ((8, 1), (3, 0), (4, 2)):
        np.testing.assert_array_equal(
            tbuilder.compute_search_ranges(ta.positions, k, rounds, ta.edges),
            jbuilder.compute_search_ranges(ja.positions, k, rounds, ja.edges))
    q = np.concatenate([ja.positions[::7], ja.positions[:5] + 0.3 * radius,
                        ja.positions[:5] + 3.0 * radius])
    np.testing.assert_array_equal(
        tbuilder._positions_to_ids(ta, q, radius),
        jbuilder._positions_to_ids(ja, q, radius))


def test_light_vector_matches_jax(jax_graph):
    jg, L0 = jax_graph
    got = tlighting.light_vector(port_graph(jg), port_spec(), LIGHT,
                                 LIGHTING["light_rays"], seed=SEED,
                                 device="cpu")
    np.testing.assert_allclose(got, L0, rtol=1e-5, atol=1e-7)
    assert got.max() > 0


def test_light_vector_batches_wrap_as_jax(jax_graph):
    """A batch smaller than the work: the last batch wraps to the first
    rays (idx % total) and its extra lanes stay inactive."""
    jg, _ = jax_graph
    sub = JGraph(positions=jg.positions[:37], vertex_radius=jg.vertex_radius)
    ref = jlighting.light_vector(sub, sphere_medium_spec(), LIGHT, 5,
                                 seed=4, batch=64)
    got = tlighting.light_vector(port_graph(sub), port_spec(), LIGHT, 5,
                                 seed=4, batch=64, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("on_device", [False, True])
def test_compute_final_light_matches_jax(jax_graph, on_device):
    """The host loop and the index_add_ power iteration, against the JAX
    package's host loop and segment-sum iteration."""
    jg, L0 = jax_graph
    tg = port_graph(jg)
    for a, b in zip(tlighting.transport_matrix(tg),
                    jlighting.transport_matrix(jg)):
        np.testing.assert_array_equal(a, b)
    for bounces in (0, 1, 3, 8):
        ref = jlighting.compute_final_light(jg, L0, bounces,
                                            device=on_device)
        got = tlighting.compute_final_light(tg, L0, bounces,
                                            on_device=on_device,
                                            device="cpu")
        np.testing.assert_allclose(got, ref, rtol=1e-5)
    # a chain, and an early stop on an all-zero term
    chain = Graph(positions=np.zeros((3, 3), np.float32),
                  vertex_samples=np.array([2, 2, 2], np.int32),
                  edges=np.array([[0, 1], [1, 2]], np.int32),
                  edge_samples=np.array([2, 2], np.int32))
    L = np.array([1.0, 0.0, 0.0], np.float32)
    for b, want in ((2, [1, 1, 1]), (9, [1, 1, 1]), (1, [1, 1, 0])):
        np.testing.assert_allclose(tlighting.compute_final_light(
            chain, L, b, on_device=on_device, device="cpu"), want)


def test_final_light_device_random_graph():
    """tests/test_graph.py's device-vs-host gate over the port, and both
    against the JAX paths."""
    rs = np.random.RandomState(1)
    V, E = 500, 3000
    kw = dict(positions=rs.rand(V, 3).astype(np.float32),
              vertex_samples=rs.randint(1, 50, V).astype(np.int32),
              edges=rs.randint(0, V, (E, 2)).astype(np.int32),
              edge_samples=rs.randint(1, 5, E).astype(np.int32))
    L0 = rs.rand(V).astype(np.float32)
    tg, jg = Graph(**kw), JGraph(**kw)
    h = tlighting.compute_final_light(tg, L0, 6, on_device=False)
    d = tlighting.compute_final_light(tg, L0, 6, on_device=True, device="cpu")
    np.testing.assert_allclose(d, h, rtol=2e-4)
    np.testing.assert_allclose(
        h, jlighting.compute_final_light(jg, L0, 6, device=False), rtol=1e-5)
    np.testing.assert_allclose(
        d, jlighting.compute_final_light(jg, L0, 6, device=True), rtol=1e-5)


def lookup_points(jg, n=3000, seed=5):
    rs = np.random.default_rng(seed)
    near = jg.positions[rs.integers(0, jg.n_vertices, n // 2)]
    near = near + rs.normal(scale=0.03, size=near.shape)
    far = rs.random((n - n // 2, 3)) * 1.6 - 0.3
    return np.concatenate([near, far]).astype(np.float32)


def test_connect_to_graph_matches_jax(jax_graph):
    jg, _ = jax_graph
    p = lookup_points(jg)
    jidx = jgi.build_connect_index(jg)
    tidx = tgi.build_connect_index(port_graph(jg), device="cpu")
    np.testing.assert_array_equal(tidx.table.numpy(), np.asarray(jidx.table))
    assert (tidx.dims, tidx.r_mid, tidx.r_max) == (jidx.dims, jidx.r_mid,
                                                   jidx.r_max)
    js, jf = jgi.connect_to_graph(jidx, jnp.asarray(p))
    ts, tf = tgi.connect_to_graph(tidx, torch.as_tensor(p))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert 0.3 < tf.numpy().mean() < 1.0
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-9)
    # split over rays: the same numbers
    with mock.patch.object(tgi, "LOOKUP_CHUNK", 700):
        ts2, tf2 = tgi.connect_to_graph(tidx, torch.as_tensor(p))
    assert torch.equal(ts2, ts) and torch.equal(tf2, tf)


def test_connect_uniform_and_debug_image_match_jax(jax_graph):
    jg, _ = jax_graph
    jug = jg.to_uniform(0.05)
    tug = port_graph(jg).to_uniform(0.05)
    assert_graphs_equal(tug, port_graph(jug))
    jui = jgi.build_uniform_index(jug)
    tui = tgi.build_uniform_index(tug, device="cpu")
    np.testing.assert_array_equal(tui.light.numpy(), np.asarray(jui.light))
    np.testing.assert_array_equal(tui.lo.numpy(), np.asarray(jui.lo))
    p = lookup_points(jg, seed=6)
    js, jf = jgi.connect_uniform(jui, jnp.asarray(p))
    ts, tf = tgi.connect_uniform(tui, torch.as_tensor(p))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tf.numpy().any()
    jscene = jax_scene(12)
    tscene = convert.scene_from_arrays(arrays_from_jax_scene(jscene), "cpu")
    ref = jgi.debug_image(jui, jscene.camera, 12, 12)
    got = tgi.debug_image(tui, tscene.camera, 12, 12)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert got.shape == (12, 12, 3) and got.max() > 0


def test_graph_entry_points_need_cuda_unless_asked(jax_graph, tmp_path,
                                                  monkeypatch):
    """device=None means the CUDA card; without one every entry point of
    the graph path raises instead of running on the CPU."""
    jg, L0 = jax_graph
    g = port_graph(jg)
    ug = g.to_uniform(0.05)
    scene = convert.scene_from_arrays(arrays_from_jax_scene(jax_scene(8)),
                                      "cpu")
    spec = port_spec()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: tgi.build_connect_index(g),
        lambda: tgi.build_uniform_index(ug),
        lambda: tlighting.light_vector(g, spec, LIGHT, 2),
        lambda: tlighting.compute_final_light(g, L0, 2, on_device=True),
        lambda: tlighting.LightingCalculator(
            g, spec, LIGHT, LightingCalculatorConfig(light_rays=2)).run(),
        lambda: tbuilder.FreeGraphBuilder(
            spec, LIGHT, GraphBuilderConfig(**BUILD)).build(),
        lambda: tanalyzer.analyze(scene, g, np.zeros((1, 2), np.int64)),
        lambda: trender.make_graph_wave_renderer(scene, g),
        lambda: trender.render_graph(scene, g),
        lambda: presets.sphere_medium(8, 8, spp=1),
        lambda: graph_maker.main(["preset:sphere", "--quiet",
                                  "--out", str(tmp_path / "g")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def jax_scene(res, spp=2):
    """tests/test_graph.py's render scene at res x res."""
    cam = JCamera(c2w=jvm.look_at((0.5, 0.5, -2.2), (0.5, 0.5, 0.5),
                                  (0, 1, 0)),
                  fov_deg=30.0, width=res, height=res)
    return JScene(camera=cam, medium=sphere_medium_spec(),
                  lights=[jlights.DistantLight(
                      direction=LIGHT, spectrum=jsp_flat(3.0),
                      scene_radius=10.0)],
                  max_depth=4, filter=JBox(), spp=spp)


def jsp_flat(c):
    from acceleratedvolrenderer_tpu.utils import spectrum as jsp
    return jsp.constant_spectrum(c)


def assert_frames_close(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert img.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()


@pytest.mark.parametrize("kind", ["free", "uniform"])
def test_render_graph_matches_jax(jax_graph, kind):
    """16x16 at spp 2 with the same graph (a uniform one by voxel
    lookup)."""
    jg, _ = jax_graph
    if kind == "uniform":
        jg = jg.to_uniform(0.05)
    jscene = jax_scene(16)
    ref, _ = jrender.render_graph(jscene, jg)
    tscene = convert.scene_from_arrays(arrays_from_jax_scene(jscene), "cpu")
    img, stats = trender.render_graph(tscene, port_graph(jg), device="cpu")
    assert_frames_close(img, ref)
    assert stats["spp"] == 2 and len(stats["iterations"]) == 2
    assert min(stats["iterations"]) > 0 and stats["rays_per_sec"] > 0


def test_analyze_counts_match_jax(jax_graph):
    jg, _ = jax_graph
    jscene = jax_scene(16)
    pixels = np.array([[x, y] for y in range(4, 12, 2) for x in range(4, 12)])
    ref = janalyzer.analyze(jscene, jg, pixels, spp=4)
    tscene = convert.scene_from_arrays(arrays_from_jax_scene(jscene), "cpu")
    got = tanalyzer.analyze(tscene, port_graph(jg), pixels, spp=4,
                            device="cpu")
    assert (got.total_scatters, got.node_scatters, got.search_scatters) == (
        ref.total_scatters, ref.node_scatters, ref.search_scatters)
    assert got.total_scatters > 0 and got.search_scatters > 0
    assert got.avg_in_range_dist == pytest.approx(ref.avg_in_range_dist,
                                                  rel=1e-5)


def test_voxels_match_jax():
    """graph/voxels.py as tests/test_voxel_boundary.py checks it, and equal
    to the JAX package's at every step."""
    maj = _sphere_majorant()
    lo, hi = np.zeros(3), np.ones(3)
    g = tvoxels.capture_boundary(maj, lo, hi, equator_step=0.6, num_steps=12)
    jg = jvoxels.capture_boundary(maj, lo, hi, equator_step=0.6, num_steps=12)
    np.testing.assert_array_equal(g.positions, jg.positions)
    assert g.n_vertices > 100
    r = np.linalg.norm(g.positions - 0.5, axis=1)
    assert 0.30 < r.mean() < 0.42 and (r < 0.5).all()
    uni = tvoxels.shrink_to_count(g, wanted_vertices=400)
    assert_graphs_equal(uni, port_graph(jvoxels.shrink_to_count(jg, 400)))
    assert 0 < uni.n_vertices <= 400 * 1.3
    layer = tvoxels.to_single_layer(uni, lo, hi)
    assert_graphs_equal(layer, port_graph(jvoxels.to_single_layer(
        port_graph(uni), lo, hi)))
    assert layer.kind == "uniform" and layer.n_vertices > 0
    out = tvoxels.capture_boundary_uniform(maj, lo, hi, wanted_vertices=300,
                                           equator_step=0.8, num_steps=10)
    assert_graphs_equal(out, port_graph(jvoxels.capture_boundary_uniform(
        maj, lo, hi, wanted_vertices=300, equator_step=0.8, num_steps=10)))
    assert out.kind == "uniform" and out.n_vertices > 0


def test_full_build_and_lighting_match_jax(jax_graph):
    """FreeGraphBuilder (both reinforcements on) and LightingCalculator on
    test_graph.py's configuration, end to end in each package."""
    jg, _ = jax_graph
    cfg = GraphConfig(builder=GraphBuilderConfig(**BUILD),
                      lighting=LightingCalculatorConfig(**LIGHTING))
    ts = port_spec()
    g = tbuilder.FreeGraphBuilder(ts, torch.tensor(LIGHT), cfg.builder,
                                  seed=SEED, device="cpu").build()
    g = tlighting.LightingCalculator(g, ts, LIGHT, cfg.lighting, seed=SEED,
                                     device="cpu").run()
    assert (g.n_vertices, g.n_edges) == (jg.n_vertices, jg.n_edges)
    assert g.n_vertices > 50 and g.n_edges > 20
    np.testing.assert_allclose(g.positions, jg.positions, atol=1e-6)
    np.testing.assert_array_equal(g.edges, jg.edges)
    close = np.isclose(g.light_scalar, jg.light_scalar, rtol=1e-4)
    assert close.mean() >= 0.99
    np.testing.assert_allclose(g.search_range, jg.search_range, rtol=1e-5)


def test_graph_maker_refuses_pbrt_scenes(tmp_path, capsys):
    """graph_maker takes .pbrt scenes through the port's parser; it refuses
    one without a medium, or without a distant light, as the reference
    does, and a missing file."""
    with pytest.raises(FileNotFoundError):
        graph_maker.main([str(tmp_path / "scene.pbrt"), "--cpu"])
    scene = tmp_path / "scene.pbrt"
    head = ('Camera "perspective"\nWorldBegin\n'
            'LightSource "infinite" "rgb L" [1 1 1]\n')
    medium = ('MakeNamedMedium "fog" "string type" "homogeneous"\n'
              'MediumInterface "fog" ""\nShape "sphere"\n')
    for text, why in ((head, "no medium"), (head + medium, "distant light")):
        scene.write_text(text)
        with pytest.raises(SystemExit):
            graph_maker.main([str(scene), "--cpu", "--quiet"])
        assert why in capsys.readouterr().err


def test_graph_maker_cli_on_cpu(tmp_path):
    """preset:sphere through the CLI on the CPU at a small configuration:
    the files it writes read back, in both packages."""
    import json

    cfg = GraphConfig(builder=GraphBuilderConfig(
        dimension_steps=6, iterations_per_step=1, max_depth=3),
        lighting=LightingCalculatorConfig(light_rays=2, bounces=2))
    cfg.to_json(str(tmp_path / "cfg.json"))
    out = str(tmp_path / "g")
    assert graph_maker.main(["preset:sphere", "--cpu", "--quiet", "--config",
                             str(tmp_path / "cfg.json"), "--out", out,
                             "--bounces", "1", "2"]) == 0
    stats = json.loads((tmp_path / "g_stats.json").read_text())
    assert stats["vertices"] > 0 and len(stats["files"]) == 4
    a = JGraph.read_text(out + "_d2.txt")
    b = Graph.read_npz(out + "_d2.npz")
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.light_scalar, b.light_scalar)
    assert b.light_scalar.max() > 0


def test_native_loader_raises_without_a_compiler(tmp_path, monkeypatch):
    """No fallback merge: when g++ cannot run, the loader raises."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "lib.so")

    def no_compiler(*args, **kwargs):
        raise FileNotFoundError(2, "No such file or directory", "g++")

    with mock.patch.object(subprocess, "run", side_effect=no_compiler):
        with pytest.raises(RuntimeError, match="no fallback"):
            native.merge_points(np.zeros((3, 3), np.float32), 0.1)
        with pytest.raises(RuntimeError, match="no fallback"):
            tbuilder.merge_paths_to_graph(np.zeros((1, 2, 3), np.float32),
                                          np.ones((1, 2), bool), 0.1)
        failed = subprocess.CalledProcessError(1, ["g++"], stderr="boom")
        with mock.patch.object(subprocess, "run", side_effect=failed):
            with pytest.raises(RuntimeError, match="boom"):
                native.KDTree(np.zeros((3, 3), np.float32))
    assert not (tmp_path / "lib.so").exists()
    # the voxel-hash merge stays reachable when asked for
    g = tbuilder.merge_paths_to_graph(np.zeros((1, 2, 3), np.float32),
                                      np.ones((1, 2), bool), 0.1, exact=False)
    assert g.n_vertices == 1


def test_delta_track_iterations_counted():
    before = tdda.delta_track_iterations
    ts = port_spec()
    o, d = tbuilder.entry_rays(ts, LIGHT, 6)
    n = o.shape[0]
    tbuilder.trace_scatter_paths(
        ts.build_arrays(torch.zeros((1, 4))), torch.as_tensor(o),
        torch.as_tensor(d), tdda.seed_stream(torch.arange(n),
                                             torch.zeros(n, dtype=torch.long)),
        ts.maj_res(), False, 2)
    assert tdda.delta_track_iterations > before
