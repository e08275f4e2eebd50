"""The port's homogeneous, emissive and RGB-grid media against the JAX
package's: the presets (fog_box, emissive_volume, explosion), the grids
and spectra they need, the analytic gates of tests/test_volpath.py and the
anisotropy gradient of tests/test_diff.py.

Tolerances:
- presets, majorant and minorant grids: equal (the same numpy bakes and
  float32 host reductions); spectra to rtol 1e-6 (torch and XLA differ by
  ulps in exp);
- trilerp_vec* and Smits' RGB -> spectrum: rtol 1e-6 / atol 1e-6; the
  blackbody, a chain of float32 powers, products and exp: rtol 1e-5;
- frames against the JAX package: test_torch_slice.py's, frame means to
  1e-3 relative and >= 99% of pixels to rtol 1e-3 / atol 1e-5 (ulps in
  exp, log1p and erfinv, and one flipped choice reroutes a sample);
- the port's regen frame against its own render(): tests/test_regen.py's
  _compare, max |diff| / max |frame| < 2e-4 (the same per-sample
  estimates, added to the film in another order);
- the analytic gates at test_volpath.py's own tolerances;
- the anisotropy gradient: FD == AD to test_diff.py's 5e-2, the port's AD
  to the JAX AD to 1e-4 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import lights as jlights
from acceleratedvolrenderer_tpu.models.integrators import volpath_fused as jvol
from acceleratedvolrenderer_tpu.ops import dda as jdda
from acceleratedvolrenderer_tpu.ops import grid as jgrid
from acceleratedvolrenderer_tpu.parallel import render as jrender
from acceleratedvolrenderer_tpu.scene import presets as jpresets
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu_torch.models import lights as tlights
from acceleratedvolrenderer_tpu_torch.models import media as tmedia
from acceleratedvolrenderer_tpu_torch.models.cameras import PerspectiveCamera
from acceleratedvolrenderer_tpu_torch.models.film import BoxFilter
from acceleratedvolrenderer_tpu_torch.models.integrators import (
    volpath_fused as tvol)
from acceleratedvolrenderer_tpu_torch.ops import dda as tdda
from acceleratedvolrenderer_tpu_torch.ops import gather, march
from acceleratedvolrenderer_tpu_torch.ops import grid as tgrid
from acceleratedvolrenderer_tpu_torch.parallel import render as trender
from acceleratedvolrenderer_tpu_torch.scene import convert
from acceleratedvolrenderer_tpu_torch.scene import presets as tpresets
from acceleratedvolrenderer_tpu_torch.scene.types import Scene
from acceleratedvolrenderer_tpu_torch.utils import spectrum as tsp
from acceleratedvolrenderer_tpu_torch.utils.vecmath import look_at

from torch_port_util import arrays_from_jax_scene

torch.set_num_threads(2)

PRESETS = {"fog_box": dict(res=24, spp=4),
           "emissive_volume": dict(res=24, spp=2),
           "explosion": dict(res=12, spp=8)}
TOL = dict(rtol=1e-6, atol=1e-6)


def assert_frames_close(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert img.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("name", list(PRESETS))
def test_preset_matches_jax_scene(name):
    """The port's preset builds what scene_from_arrays reads off the JAX
    preset: grids, majorant, transforms, lights and spectra."""
    js = getattr(jpresets, name)(**PRESETS[name])
    ref = convert.scene_from_arrays(arrays_from_jax_scene(js), "cpu")
    sc = getattr(tpresets, name)(**PRESETS[name], device="cpu")
    m, r = sc.medium, ref.medium
    for f in ("density", "sigma_a_rgb", "sigma_s_rgb", "Le_rgb"):
        a, b = getattr(m, f), getattr(r, f)
        assert (a is None) == (b is None), f
        assert a is None or torch.equal(a, b), f
    assert (m.homogeneous, m.rgb) == (r.homogeneous, r.rgb)
    assert torch.equal(m.build_majorant(), r.build_majorant())
    assert m.maj_res() == r.maj_res()
    np.testing.assert_allclose(m.world_to_unit(), r.world_to_unit(),
                               rtol=1e-12, atol=1e-12)
    assert torch.equal(sc.camera.c2w.m, ref.camera.c2w.m)
    assert [type(lt) for lt in sc.lights] == [type(lt) for lt in ref.lights]
    lam = torch.linspace(380.0, 780.0, 41)
    specs = [(m.sigma_a_spec, r.sigma_a_spec), (m.sigma_s_spec,
                                                r.sigma_s_spec)]
    specs += [(a.spectrum, b.spectrum) for a, b in zip(sc.lights, ref.lights)]
    if m.Le_spec is not None:
        specs.append((m.Le_spec, r.Le_spec))
    for a, b in specs:
        np.testing.assert_allclose(a(lam).numpy(), b(lam).numpy(), rtol=1e-6)
    for a, b in zip(sc.lights, ref.lights):
        if isinstance(a, tlights.DistantLight):
            assert torch.equal(a.direction, b.direction)
    for f in ("g", "scale", "Le_scale"):
        assert getattr(m, f) == getattr(r, f), f
    for f in ("max_depth", "spp", "seed", "max_march_steps", "scene_radius",
              "width", "height"):
        assert getattr(sc, f) == getattr(ref, f), f


@pytest.fixture(scope="module", params=list(PRESETS))
def preset_frames(request):
    """(name, JAX render, JAX regen, port render, port regen) of a preset."""
    name = request.param
    js = getattr(jpresets, name)(**PRESETS[name])
    ts = getattr(tpresets, name)(**PRESETS[name], device="cpu")
    g0, m0 = gather.launches, march.launches
    frames = (jrender.render(js)[0], jrender.render_regen(js, n_lanes=1024)[0],
              trender.render(ts, device="cpu")[0],
              trender.render_regen(ts, device="cpu", n_lanes=1024)[0])
    assert (gather.launches, march.launches) == (g0, m0)   # CPU: no kernel
    return (name, *frames)


def test_preset_render_matches_jax(preset_frames):
    _, jren, _, tren, _ = preset_frames
    assert_frames_close(tren, jren)


def test_preset_regen_matches_jax(preset_frames):
    _, _, jreg, _, treg = preset_frames
    assert_frames_close(treg, jreg)


def test_preset_regen_matches_own_render(preset_frames):
    """tests/test_regen.py::_compare on the port: regen and render() give
    the same per-sample estimates."""
    _, _, _, tren, treg = preset_frames
    err = np.max(np.abs(treg - tren)) / max(float(np.abs(tren).max()), 1e-6)
    assert err < 2e-4, err


@pytest.mark.parametrize("res", [(4, 4, 4), (16, 16, 16), (3, 5, 7)])
def test_extremum_grids_match_jax(res):
    dens = np.random.default_rng(sum(res)).random((24, 20, 28)).astype(
        np.float32)
    assert np.array_equal(tgrid.build_majorant_grid(dens, res),
                          jgrid.build_majorant_grid(dens, res))
    assert np.array_equal(tgrid.build_minorant_grid(dens, res),
                          jgrid.build_minorant_grid(dens, res))


def test_build_majorant_homogeneous_and_rgb_match_jax():
    """MediumSpec.build_majorant: a 1^3 table of ones for a homogeneous
    medium, the per-cell channel max of (sigma_a + sigma_s) * scale for an
    RGB one, equal to the JAX package's."""
    from acceleratedvolrenderer_tpu.models import media as jmedia

    flat = lambda c: None
    jh = jmedia.homogeneous_box(flat, flat, (0, 0, 0), (1, 1, 1))
    th = tmedia.homogeneous_box(flat, flat, (0, 0, 0), (1, 1, 1))
    assert th.homogeneous and not th.rgb and th.maj_res() == (1, 1, 1)
    assert np.array_equal(th.build_majorant().numpy(), jh.build_majorant())
    rng = np.random.default_rng(5)
    sa, ss = (rng.random((20, 12, 16, 3)).astype(np.float32)
              for _ in range(2))
    jr = jmedia.MediumSpec(flat, flat, scale=1.7, sigma_a_rgb=sa,
                           sigma_s_rgb=ss, majorant_res=(4, 3, 5))
    tr = tmedia.MediumSpec(flat, flat, scale=1.7, sigma_a_rgb=_t(sa),
                           sigma_s_rgb=_t(ss), majorant_res=(4, 3, 5))
    assert tr.rgb and not tr.homogeneous
    assert np.array_equal(tr.build_majorant().numpy(), jr.build_majorant())


def test_minorant_grid_bounds():
    """tests/test_regen.py::test_minorant_grid_bounds on the port: the
    minorant lower-bounds and the majorant upper-bounds every trilerp value
    in its cell."""
    rng = np.random.default_rng(3)
    dens = rng.random((24, 20, 28)).astype(np.float32)
    res = (4, 4, 4)
    maj = tgrid.build_majorant_grid(dens, res)
    mino = tgrid.build_minorant_grid(dens, res)
    assert np.all(mino <= maj)
    p = rng.random((4096, 3)).astype(np.float32)
    vals = tgrid.trilerp(_t(dens), _t(p)).numpy()
    cell = np.minimum((p * np.asarray(res)).astype(np.int64),
                      np.asarray(res) - 1)
    lo = mino[cell[:, 2], cell[:, 1], cell[:, 0]]
    hi = maj[cell[:, 2], cell[:, 1], cell[:, 0]]
    assert np.all(vals >= lo - 1e-5)
    assert np.all(vals <= hi + 1e-5)


def test_trilerp_vec_matches_jax():
    rng = np.random.default_rng(7)
    grid = rng.uniform(0.0, 3.0, (6, 5, 7, 3)).astype(np.float32)
    p = rng.uniform(-0.1, 1.1, (2000, 3)).astype(np.float32)
    u3 = rng.random((2000, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgrid.trilerp_vec(_t(grid), _t(p)).numpy(),
        np.asarray(jgrid.trilerp_vec(jnp.asarray(grid), jnp.asarray(p))),
        **TOL)
    np.testing.assert_allclose(
        tgrid.trilerp_vec_stochastic(_t(grid), _t(p), _t(u3)).numpy(),
        np.asarray(jgrid.trilerp_vec_stochastic(
            jnp.asarray(grid), jnp.asarray(p), jnp.asarray(u3))), **TOL)
    np.testing.assert_allclose(
        tgrid.trilerp(_t(grid[..., 0]), _t(p)).numpy(),
        np.asarray(jgrid.trilerp(jnp.asarray(grid[..., 0]), jnp.asarray(p))),
        **TOL)


def test_smits_and_blackbody_match_jax():
    rng = np.random.default_rng(9)
    rgb = rng.uniform(0.0, 4.0, (3000, 3)).astype(np.float32)
    rgb[:6] = [[1, 1, 1], [0, 0, 0], [1, 2, 3], [3, 2, 1], [2, 1, 3],
               [2, 3, 1]]                     # ties and every ordering
    lam = rng.uniform(340.0, 840.0, (3000, 4)).astype(np.float32)
    lam[0] = [380.0, 720.0, 300.0, 900.0]     # the table's ends and beyond
    np.testing.assert_allclose(
        tsp.rgb_to_spectrum_smits_batched(_t(rgb), _t(lam)).numpy(),
        np.asarray(jsp.rgb_to_spectrum_smits_batched(jnp.asarray(rgb),
                                                     jnp.asarray(lam))),
        **TOL)
    for T in (1500.0, 3000.0, 6504.0):
        np.testing.assert_allclose(
            tsp.blackbody_normalized(T)(_t(lam)).numpy(),
            np.asarray(jsp.blackbody_normalized(T)(jnp.asarray(lam))),
            rtol=1e-5)


# ---- tests/test_volpath.py's analytic gates (l. 38-104), on the port ----

def _lum(img):
    return img @ np.array([0.2126, 0.7152, 0.0722])


def _box_scene(sa, ss, g=0.0, le=None, sky=1.0, eye=(0.5, 0.5, -2.0),
               max_depth=5, spp=128):
    flat = tsp.constant_spectrum
    med = tmedia.homogeneous_box(flat(sa), flat(ss), lo=(0, 0, 0),
                                 hi=(1, 1, 1), g=g,
                                 Le_spec=None if le is None else flat(le))
    cam = PerspectiveCamera(c2w=look_at(eye, (0.5, 0.5, 0.5), (0, 1, 0),
                                        "cpu"),
                            fov_deg=30.0, width=8, height=8)
    lights = ([] if sky is None
              else [tlights.UniformInfiniteLight(spectrum=flat(sky))])
    return Scene(camera=cam, medium=med, lights=lights, max_depth=max_depth,
                 filter=BoxFilter(), spp=spp)


def _analytic_render(scene):
    """The scene through render_regen with a lane per (pixel, sample): the
    per-sample estimates of render(), in one loop."""
    img, _ = trender.render_regen(scene, device="cpu",
                                  n_lanes=64 * scene.spp)
    return img


@pytest.mark.parametrize("g, ss, depth", [(0.0, 0.5, 40), (0.6, 1.0, 50)])
def test_scattering_furnace(g, ss, depth):
    """An albedo-1 medium in a radiance-1 environment: L == 1 (NEE, MIS and
    phase sampling weights cancel), for isotropic and anisotropic g."""
    img = _analytic_render(_box_scene(0.0, ss, g=g, max_depth=depth))
    assert abs(_lum(img).mean() - 1.0) < 0.025, _lum(img).mean()
    if g == 0.0:
        assert np.abs(_lum(img) - 1.0).max() < 0.08


def test_absorption_against_environment():
    sa = 1.5
    img = _analytic_render(_box_scene(sa, 0.0, eye=(0.5, 0.5, -3.0),
                                      spp=256))
    center = _lum(img)[3:5, 3:5].mean()
    assert abs(center - np.exp(-sa)) < 0.02, (center, np.exp(-sa))


def test_emissive_medium():
    """Emissive absorber with no light: L = Le (1 - exp(-sigma_a chord))."""
    sa, le = 2.0, 3.0
    img = _analytic_render(_box_scene(sa, 0.0, le=le, sky=None,
                                      eye=(0.5, 0.5, -3.0), spp=256))
    center = _lum(img)[3:5, 3:5].mean()
    expect = le * (1.0 - np.exp(-sa))
    assert abs(center - expect) / expect < 0.03, (center, expect)


def test_g_gradient_matches_fd_and_jax():
    """tests/test_diff.py::test_g_gradient_nonzero on the port: homogeneous
    li with fixed_steps and a frozen sampling-side g_s; the anisotropy
    gradient flows through the p / pdf phase factor."""
    N = 512
    o = np.tile([[0.5, 0.5, -2.0]], (N, 1)).astype(np.float32)
    d = np.tile([[0.0, 0.0, 1.0]], (N, 1)).astype(np.float32)
    lam = np.tile(np.linspace(400.0, 700.0, 4, dtype=np.float32)[None],
                  (N, 1))
    sun = np.array([0.0, -1.0, 0.0])
    kw = dict(maj_res=(1, 1, 1), homogeneous=True, max_depth=4,
              fixed_steps=128)

    def jloss(gval):
        med = jdda.MediumArrays(
            density=jnp.ones((1, 1, 1)), majorant=jnp.ones((1, 1, 1)),
            w2m=jnp.eye(4), g=gval, sigma_a=jnp.full((1, 4), 0.1),
            sigma_s=jnp.full((1, 4), 1.5), Le=jnp.zeros((1, 4)),
            g_s=jnp.float32(0.3))
        lights = [jlights.DistantLight(direction=sun,
                                       spectrum=jsp.constant_spectrum(5.0),
                                       scene_radius=10.0)]
        rng = jdda.seed_stream(jnp.arange(N), jnp.zeros(N, jnp.int32))
        res = jvol.li(med, lights, jnp.asarray(o), jnp.asarray(d),
                      jnp.asarray(lam), rng, scene_radius=10.0, **kw)
        return jnp.mean(res.L)

    lights = [tlights.DistantLight(
        direction=torch.tensor(sun, dtype=torch.float32),
        spectrum=tsp.constant_spectrum(5.0), scene_radius=10.0)]

    def tloss(gval):
        med = tdda.MediumArrays(
            density=torch.ones((1, 1, 1)), majorant=torch.ones((1, 1, 1)),
            w2m=torch.eye(4), g=gval, sigma_a=torch.full((1, 4), 0.1),
            sigma_s=torch.full((1, 4), 1.5), Le=torch.zeros((1, 4)),
            g_s=torch.tensor(0.3))
        rng = tdda.seed_stream(torch.arange(N), torch.zeros(N,
                                                            dtype=torch.int64))
        res = tvol.li(med, lights, _t(o), _t(d), _t(lam), rng, **kw)
        return torch.mean(res.L)

    g0 = torch.tensor(0.3, requires_grad=True)
    (ad,) = torch.autograd.grad(tloss(g0), g0)
    ad = float(ad)
    eps = 1e-3
    with torch.no_grad():
        fd = (float(tloss(torch.tensor(0.3 + eps)))
              - float(tloss(torch.tensor(0.3 - eps)))) / (2 * eps)
    assert abs(ad) > 1e-5
    assert abs(fd - ad) <= 5e-2 * max(abs(fd), abs(ad)), (fd, ad)
    jad = float(jax.grad(jloss)(jnp.float32(0.3)))
    assert abs(ad - jad) <= 1e-4 * abs(jad), (ad, jad)


def test_scene_from_arrays_spectra():
    """A named blackbody emission, an empty light list and a homogeneous
    medium (no density) cross through scene_from_arrays."""
    js = jpresets.emissive_volume(res=8, spp=1)
    arrays = arrays_from_jax_scene(js)
    assert arrays["Le"] == ("blackbody", 3000.0)
    arrays.update(sun_L=None, sky_L=None, density=None,
                  majorant=np.ones((1, 1, 1), np.float32))
    ts = convert.scene_from_arrays(arrays, "cpu")
    assert ts.lights == [] and ts.medium.homogeneous
    assert ts.medium.maj_res() == (1, 1, 1)
    with pytest.raises(ValueError, match="unknown spectrum"):
        convert.scene_from_arrays(dict(arrays, Le=("rgb", 1.0)), "cpu")
    assert dataclasses.replace(ts).to("cpu").medium.homogeneous
