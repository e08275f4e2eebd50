"""The port's samplers (models/samplers.py, models/pmj02.py), the function
integrator (models/integrators/function.py) and pspec (cli/pspec.py)
against the JAX package's, and the reference's sampler gates
(tests/test_samplers.py, test_function_analyzer.py,
test_cli.py::test_pspec_blue_noise_deficit) on the port.

The samplers are integer hashes, table lookups, an exact 24-bit float
conversion and float32 radical-inverse sums in the reference's order, so
every kind equals the JAX package bit for bit: film_sample's u1, u2 and
stream with and without pixel coordinates (pad pixels among them),
path_dim_sample over dims 0-40 and PathSampler past max_dims, and the
pmj02bn tables.  render_function's estimates and power_spectrum's spectra
follow from those points: equal to float32 / float64 rounding (rtol 1e-6;
the MSE curve also to atol 1e-10).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.cli import pspec as jpspec
from acceleratedvolrenderer_tpu.models import pmj02 as jpmj
from acceleratedvolrenderer_tpu.models import samplers as js
from acceleratedvolrenderer_tpu.models.integrators import function as jfun
from acceleratedvolrenderer_tpu_torch.cli import pspec as tpspec
from acceleratedvolrenderer_tpu_torch.models import pmj02 as tpmj
from acceleratedvolrenderer_tpu_torch.models import samplers as ts
from acceleratedvolrenderer_tpu_torch.models.integrators import (
    function as tfun)
from acceleratedvolrenderer_tpu_torch.ops import dda as tdda

torch.set_num_threads(2)

N = 3000


@pytest.fixture(scope="module", autouse=True)
def jax_tables():
    """The port's pmj02bn tables (held to the JAX package's generators bit
    for bit by test_pmj02_tables_match_jax) in the JAX package's in-memory
    cache, so its samplers never touch its on-disk cache: it writes that
    file in place, and test processes generating it at once could read a
    partial file."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jpmj._CACHE, ("tables", 0), tpmj.get_tables(0))
        yield


def _bits(x):
    """A float32 array's bits, an integer array as int64 (uint32 values)."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x.astype(np.int64)


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.fixture(scope="module")
def lanes():
    """Random pixel indices, pixel coordinates of a 1280x720 frame and
    sample indices; the first lanes are pad pixels (-1)."""
    rng = np.random.default_rng(9)
    pixidx = rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    pixidx[:7] = 0xFFFFFFFF
    pix = np.stack([rng.integers(0, 1280, N), rng.integers(0, 720, N)],
                   -1).astype(np.int32)
    pix[:7] = -1
    sidx = {spp: rng.integers(0, 3 * spp, N).astype(np.uint32)
            for spp in (1, 16, 1500)}
    return pixidx, pix, sidx


@pytest.mark.parametrize("kind", ts.KINDS)
def test_film_sample_matches_jax(lanes, kind):
    """u1, u2 and the advanced stream, bitwise, for spp 1 / 16 / 1500
    (pmj02bn past its 1024-entry table) under seeds 0 / 5 / 0, with and
    without pixel coordinates."""
    pixidx, pix, sidx = lanes
    for (spp, s), seed in zip(sidx.items(), (0, 5, 0)):
        for with_pix in (False, True):
            want = js.film_sample(
                kind, jnp.asarray(pixidx), jnp.asarray(s), spp,
                seed=seed, pix=jnp.asarray(pix) if with_pix else None)
            got = ts.film_sample(
                kind, torch.as_tensor(pixidx.astype(np.int64)),
                torch.as_tensor(s.astype(np.int64)), spp, seed=seed,
                pix=torch.as_tensor(pix) if with_pix else None)
            _equal(got, want)
            assert got[0].dtype == torch.float32
            assert got[2].dtype == torch.int64


@pytest.mark.parametrize("kind", ts.KINDS)
def test_path_dim_sample_matches_jax(lanes, kind):
    pixidx, _, sidx = lanes
    s = sidx[16]
    for dim in range(41):
        want = js.path_dim_sample(kind, jnp.asarray(pixidx), jnp.asarray(s),
                                  16, dim, seed=3)
        got = ts.path_dim_sample(kind, torch.as_tensor(pixidx.astype(np.int64)),
                                 torch.as_tensor(s.astype(np.int64)), 16, dim,
                                 seed=3)
        _equal([got], [want])


@pytest.mark.parametrize("kind", ["halton", "pmj02bn", "stratified"])
def test_path_sampler_matches_jax_past_max_dims(lanes, kind):
    pixidx, _, sidx = lanes
    s = sidx[16]
    j = js.PathSampler(kind, jnp.asarray(pixidx), jnp.asarray(s), 16,
                       seed=0x9A7, max_dims=6)
    t = ts.PathSampler(kind, torch.as_tensor(pixidx.astype(np.int64)),
                       torch.as_tensor(s.astype(np.int64)), 16, seed=0x9A7,
                       max_dims=6)
    for _ in range(10):
        _equal([t.next()], [j.next()])
    assert t.dim == j.dim == 6
    _equal([t.rng], [j.rng])


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown sampler"):
        ts.film_sample("sobolish", torch.zeros(2, dtype=torch.int64),
                       torch.zeros(2, dtype=torch.int64), 4)


def test_pmj02_tables_match_jax():
    """The port's tables (cached in build/pmj02/) against the JAX package's
    generators, and a freshly generated small table and texture,
    bitwise."""
    tt, tb = tpmj.get_tables(0)
    jt = np.stack([jpmj.generate_pmj02bn(jpmj.TABLE_SIZE, s)
                   for s in range(jpmj.N_SETS)])
    jb = np.stack([jpmj.blue_noise_texture(64, 0),
                   jpmj.blue_noise_texture(64, 7919)], -1)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tpmj.generate_pmj02bn(64, 3),
                                  jpmj.generate_pmj02bn(64, 3))
    np.testing.assert_array_equal(tpmj.blue_noise_texture(16, 2),
                                  jpmj.blue_noise_texture(16, 2))
    assert tpmj.validate_pmj02(tpmj.generate_pmj02bn(64, 3))
    bad = tpmj.generate_pmj02bn(16, 1)
    bad[1] = bad[0]
    assert not tpmj.validate_pmj02(bad)


@pytest.mark.parametrize("name,sampler", [("gaussian", "zsobol"),
                                          ("checkerboard", "pmj02bn"),
                                          ("rotatedcheckerboard", "halton"),
                                          ("disk", "sobol")])
def test_render_function_matches_jax(name, sampler):
    want_est, want_curve = jfun.render_function(name, width=8, height=6,
                                                spp=16, sampler=sampler,
                                                seed=2)
    est, curve = tfun.render_function(name, width=8, height=6, spp=16,
                                      sampler=sampler, seed=2, device="cpu")
    np.testing.assert_allclose(est, want_est, rtol=1e-6, atol=0)
    assert [n for n, _ in curve] == [n for n, _ in want_curve]
    # the MSE of a near-converged estimate: the squared error (2e-4 at
    # 16 samples) times float32 ulps of exp, so an absolute 1e-10 too
    np.testing.assert_allclose([m for _, m in curve],
                               [m for _, m in want_curve], rtol=1e-5,
                               atol=1e-10)


@pytest.mark.parametrize("kind", ["zsobol", "pmj02bn"])
def test_power_spectrum_matches_jax(kind):
    want = jpspec.power_spectrum(kind, 16, 16, 3)
    got = tpspec.power_spectrum(kind, 16, 16, 3, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tpspec.radial_average(got, 8),
                               jpspec.radial_average(want, 8), rtol=1e-6)


def test_pspec_main_writes_exr(tmp_path, capsys):
    out = tmp_path / "spec.exr"
    assert tpspec.main(["halton", "--npoints", "8", "--resolution", "8",
                        "--nsets", "2", "-o", str(out), "--cpu"]) == 0
    assert out.stat().st_size > 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 32


# ---- the reference's gates (tests/test_samplers.py), on the port ----

def _gather(kind, n_pix=64, spp=64):
    pix = torch.arange(n_pix, dtype=torch.int64)
    pts = []
    for s in range(spp):
        u1, u2, _ = ts.film_sample(kind, pix, torch.full((n_pix,), s), spp)
        pts.append(np.stack([u1.numpy(), u2.numpy()], -1))
    return np.stack(pts, 1)


@pytest.mark.parametrize("kind", ts.KINDS)
def test_all_in_unit_square(kind):
    p = _gather(kind, 8, 16)
    assert p.min() >= 0.0 and p.max() < 1.0, kind


def test_stratified_covers_strata():
    p = _gather("stratified", 4, 16)
    for i in range(4):
        cells = (p[i, :, 0] * 4).astype(int) + 4 * (p[i, :, 1] * 4).astype(int)
        assert len(set(cells.tolist())) == 16, cells


def test_sobol_stratification_beats_independent():
    def max_cell_count(p, g):
        cells = (p[..., 0] * g).astype(int) + g * (p[..., 1] * g).astype(int)
        return max(np.bincount(c, minlength=g * g).max() for c in cells)

    assert max_cell_count(_gather("sobol", 16, 64), 8) == 1
    assert max_cell_count(_gather("independent", 16, 64), 8) >= 3


def test_pixels_decorrelated():
    p = _gather("sobol", 32, 16)
    assert not np.allclose(p[0], p[1])


def test_halton_base3_stratification():
    p = _gather("halton", 8, 9)
    for i in range(8):
        assert len(set((p[i, :, 1] * 9).astype(int).tolist())) == 9


def test_zsobol_stratified_per_pixel():
    spp = 16
    pix = torch.as_tensor(np.stack([np.arange(16) % 4, np.arange(16) // 4],
                                   -1).astype(np.int32))
    pts = []
    for s in range(spp):
        u1, u2, _ = ts.film_sample("zsobol", torch.arange(16),
                                   torch.full((16,), s), spp, pix=pix)
        pts.append(np.stack([u1.numpy(), u2.numpy()], -1))
    p = np.stack(pts, 1)
    for i in range(16):
        cells = (p[i, :, 0] * 4).astype(int) + 4 * (p[i, :, 1] * 4).astype(int)
        assert len(set(cells.tolist())) == spp, (i, sorted(cells.tolist()))


def test_paddedsobol_permutes_within_pixel():
    seen = [set() for _ in range(4)]
    for s in range(16):
        u1, u2, _ = ts.film_sample("paddedsobol", torch.arange(4),
                                   torch.full((4,), s), 16)
        for i in range(4):
            seen[i].add((round(float(u1[i]), 6), round(float(u2[i]), 6)))
    assert all(len(x) == 16 for x in seen)


def test_path_dim_sample_stratified_every_dim():
    pix = torch.zeros(16, dtype=torch.int64)
    idx = torch.arange(16)
    for dim, base, k in [(0, 2, 4), (1, 3, 2), (2, 5, 1), (3, 7, 1)]:
        n = base ** k
        u = ts.path_dim_sample("halton", pix[:n], idx[:n], 16, dim).numpy()
        assert len(set((u * n).astype(int).tolist())) == n, dim


def test_path_dim_decorrelated_across_pixels_and_dims():
    idx = torch.arange(64)
    a = ts.path_dim_sample("halton", torch.zeros(64, dtype=torch.int64), idx,
                           64, 0).numpy()
    b = ts.path_dim_sample("halton", torch.full((64,), 9), idx, 64, 0).numpy()
    c = ts.path_dim_sample("halton", torch.zeros(64, dtype=torch.int64), idx,
                           64, 5).numpy()
    assert not np.allclose(a, b) and not np.allclose(a, c)


def test_path_sampler_source_variance_reduction():
    spp = 64
    pix = torch.zeros(spp, dtype=torch.int64)
    idx = torch.arange(spp)
    src = ts.PathSampler("halton", pix, idx, spp, seed=3)
    rng = tdda.seed_stream(pix, idx, salt=11)
    err_ld, err_wn = [], []
    for _ in range(6):
        err_ld.append(abs(float(src.next().mean()) - 0.5))
        rng, uw = tdda.pcg_uniform(rng)
        err_wn.append(abs(float(uw.mean()) - 0.5))
    assert np.mean(err_ld) < 0.5 * np.mean(err_wn), (err_ld, err_wn)


def test_stratified_path_dims():
    u = ts.path_dim_sample("stratified", torch.zeros(16, dtype=torch.int64),
                           torch.arange(16), 16, 0).numpy()
    assert sorted((u * 16).astype(int).tolist()) == list(range(16))


def test_pmj02_tables_valid():
    tables, bn = tpmj.get_tables(0)
    assert tables.shape == (tpmj.N_SETS, tpmj.TABLE_SIZE, 2)
    assert all(tpmj.validate_pmj02(t) for t in tables)
    assert np.unique(bn[..., 0]).size == bn.shape[0] * bn.shape[1]


def test_pmj02_film_sample_stratified_convergence():
    spp = 256
    pix = torch.zeros(spp, dtype=torch.int64)
    idx = torch.arange(spp)
    u1, u2, _ = ts.film_sample("pmj02bn", pix, idx, spp, seed=1,
                               pix=torch.zeros((spp, 2), dtype=torch.int32))
    exact = (2.0 / np.pi) * (1.0 / 3.0)
    f = np.sin(np.pi * u1.numpy()) * u2.numpy() ** 2
    ui, vi, _ = ts.film_sample("independent", pix, idx, spp, seed=1)
    fi = np.sin(np.pi * ui.numpy()) * vi.numpy() ** 2
    assert abs(f.mean() - exact) < max(abs(fi.mean() - exact), 0.01)
    assert ((u1 >= 0) & (u1 < 1)).all()


def test_pmj02_pixel_decorrelation():
    idx = torch.arange(16)
    z = torch.zeros(16, dtype=torch.int64)
    a = ts.film_sample("pmj02bn", z, idx, 16,
                       pix=torch.zeros((16, 2), dtype=torch.int32))[0]
    b = ts.film_sample("pmj02bn", z, idx, 16,
                       pix=torch.full((16, 2), 9, dtype=torch.int32))[0]
    assert not np.allclose(a.numpy(), b.numpy())


# ---- the function integrator's and pspec's gates, on the port ----

@pytest.mark.parametrize("name", ["step", "diagonal", "disk", "gaussian"])
def test_function_estimates_converge(name):
    est, curve = tfun.render_function(name, width=8, height=8, spp=64,
                                      sampler="independent", device="cpu")
    assert abs(est.mean() - tfun.FUNCTIONS[name][1]) < 0.15
    assert curve[-1][1] < curve[0][1], curve


def test_stratified_beats_independent_on_smooth():
    run = lambda s: tfun.render_function("gaussian", width=8, height=8,
                                         spp=64, sampler=s, device="cpu")[1]
    assert run("sobol")[-1][1] < run("independent")[-1][1]


def test_mse_file(tmp_path):
    _, curve = tfun.render_function("step", width=4, height=4, spp=16,
                                    device="cpu")
    p = tmp_path / "step-mse.txt"
    tfun.write_mse_file(str(p), curve)
    lines = p.read_text().strip().splitlines()
    assert len(lines) == len(curve) and lines[0].split()[0] == "1"
    with pytest.raises(ValueError, match="unknown function"):
        tfun.render_function("nope", device="cpu")


def test_pspec_blue_noise_deficit():
    si = tpspec.radial_average(tpspec.power_spectrum("independent", 32, 32, 8,
                                                     device="cpu"), 8)
    sz = tpspec.radial_average(tpspec.power_spectrum("zsobol", 32, 32, 8,
                                                     device="cpu"), 8)
    assert sz[1:3].mean() < si[1:3].mean()


# ---- the path integrator's uniform_source seam ----

@pytest.mark.parametrize("kind", ["halton", "pmj02bn"])
def test_li_path_with_path_sampler_matches_jax(kind):
    """li_path (depth 2) drawing from a PathSampler (max_dims 12, so the
    PCG fallback runs too), outside jit on both sides: radiance to rtol 1e-4 /
    atol 1e-6 and the returned streams on 99% of lanes, as
    tests/test_torch_path.py holds li_path."""
    from test_torch_path import _compare, setup as path_setup

    s = path_setup.__wrapped__()
    n = s["t"][2].shape[0]
    idx = np.arange(n)
    jsrc = js.PathSampler(kind, jnp.asarray(idx % 7), jnp.asarray(idx), 16,
                          seed=5, max_dims=12)
    tsrc = ts.PathSampler(kind, torch.as_tensor(idx % 7),
                          torch.as_tensor(idx), 16, seed=5, max_dims=12)
    from acceleratedvolrenderer_tpu.models.integrators import path as jpath
    from acceleratedvolrenderer_tpu_torch.models.integrators import (
        path as tpath)

    _compare(tpath.li_path(*s["t"], max_depth=2, uniform_source=tsrc),
             jpath.li_path(*s["j"], max_depth=2, uniform_source=jsrc))
    assert tsrc.dim == jsrc.dim == 12


def test_render_path_halton_matches_jax():
    """render() of tests/test_torch_path.py's room through `path` with the
    halton sampler: a PathSampler per chunk (seed + 0x9A7), the film
    jitter by film_sample(pix=); phase 5's frame rule."""
    import dataclasses

    from acceleratedvolrenderer_tpu.parallel import render as jrender
    from acceleratedvolrenderer_tpu_torch.parallel import render as trender
    from acceleratedvolrenderer_tpu_torch.scene import convert
    from test_torch_path import _room, assert_frames_close
    from torch_surface_util import surface_arrays_from_jax_scene

    jscene = dataclasses.replace(_room("path"), sampler="halton")
    ref, _ = jrender.render(jscene)
    tscene = convert.scene_from_arrays(surface_arrays_from_jax_scene(jscene),
                                       "cpu")
    assert tscene.sampler == "halton"
    img, _ = trender.render(tscene, device="cpu")
    assert_frames_close(img, ref)
