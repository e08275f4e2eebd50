"""The port's image-based and projector lights (models/lights.py:
ImageInfiniteLight, PortalImageInfiniteLight, ProjectionLight,
GoniometricLight) and utils/sky.py against the JAX package's, the
reference's portal-light gates (tests/test_portal_light.py) and
environment-only gate (tests/test_volpath.py:132) on the port, and small
frames of the cloud under an environment map with the zsobol and pmj02bn
samplers through render() and regen.

Tolerances.  The image light's texel choice is an exact float32 inverse
CDF, so its sample's pdf, validity and distance are equal bit for bit; its
direction, radiance and the pdf of a given direction go through acos,
atan2, sin and cos, which differ by ulps between XLA:CPU and torch: rtol
1e-5 / atol 1e-6.  The portal light's 24-step bisections can flip a late
comparison on such an ulp and pick the neighbouring texel: its samples are
held on at least 99.9% of lanes (pdf and radiance to rtol 1e-5, direction
to atol 2e-5), and pdf_li of the JAX sample's direction to rtol 1e-5.  The
projector and goniometric lights to rtol 1e-5 / atol 1e-6.  Frames under
phase 5's rule (means to 1e-3, 99% of pixels to rtol 1e-3 / atol 1e-5).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import lights as jl
from acceleratedvolrenderer_tpu.models import pmj02 as jpmj
from acceleratedvolrenderer_tpu.models import textures as jt
from acceleratedvolrenderer_tpu.parallel import render as jrender
from acceleratedvolrenderer_tpu.scene import presets as jpresets
from acceleratedvolrenderer_tpu.utils import sky as jsky
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu_torch.models import lights as tl
from acceleratedvolrenderer_tpu_torch.models import pmj02 as tpmj
from acceleratedvolrenderer_tpu_torch.parallel import render as trender
from acceleratedvolrenderer_tpu_torch.scene import convert, presets
from acceleratedvolrenderer_tpu_torch.utils import sky as tsky

import chip_smoke
from torch_surface_util import (_plain_light, portal_light,
                                surface_arrays_from_jax_scene)

torch.set_num_threads(2)

N = 4096
PORTAL = np.array([[-1, -1, 5], [-1, 1, 5], [1, 1, 5], [1, -1, 5]],
                  np.float32)
SMALL = dict(width=32, height=24, spp=4, max_depth=8, grid_res=32)
SKY_SMALL = dict(SMALL, spp=2)
SMALL_KNOBS = dict(n_lanes=256, k_substeps=8, stochastic_filter=True,
                   accum_spp=True, retire_groups=4, work_stride="auto")


@pytest.fixture(scope="module", autouse=True)
def jax_tables():
    """The port's pmj02bn tables (equal to the JAX package's bit for bit:
    tests/test_torch_samplers.py) in the JAX package's in-memory cache, so
    its pmj02bn frames never touch its on-disk cache, which it writes in
    place (test processes generating it at once could read a partial
    file)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jpmj._CACHE, ("tables", 0), tpmj.get_tables(0))
        yield


def _env(h=16, w=32):
    """An equirect map with flat (black) rows and a flat run in a row, so
    the CDFs hold ties."""
    img = np.random.default_rng(1).random((h, w, 3)).astype(np.float32) * 2
    img[3:5] = 0.0
    img[8, 5:12] = 0.0
    return img


def _inputs(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    p = (rng.normal(size=(N, 3)) * scale).astype(np.float32)
    u2 = rng.random((N, 2), dtype=np.float32)
    lam = rng.uniform(360, 830, (N, 4)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p, u2, lam, d


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _t(*a):
    return [torch.as_tensor(x) for x in a]


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_search_rows_matches_searchsorted():
    """The per-lane binary search against torch.searchsorted on each
    lane's row: ties (flat rows and runs), u equal to a CDF entry, u 0 and
    u 1."""
    light = tl.ImageInfiniteLight(_env())
    H, W = light._H, light._W
    cdf = torch.as_tensor(light._cdf_cols)
    rng = np.random.default_rng(4)
    row = torch.as_tensor(rng.integers(0, H, N))
    u = torch.as_tensor(rng.random(N, dtype=np.float32))
    u[:64] = cdf[row[:64], torch.as_tensor(rng.integers(0, W, 64))]
    u[64:80] = 0.0
    u[80:96] = 1.0
    row[96:200] = 3            # a flat (black) row: its CDF is linear
    row[200:300] = 8           # a row with a flat run
    u[200:260] = cdf[8, 5:12].repeat(10)[:60]
    got = tl._search_rows(cdf.reshape(-1), W, row, u)
    want = torch.searchsorted(cdf[row], u[:, None]).reshape(-1)
    assert torch.equal(got, want)
    assert (np.diff(light._cdf_cols[8, 4:13]) == 0).any()


def test_image_infinite_light_matches_jax():
    env = _env()
    j = jl.ImageInfiniteLight(env, scale=1.5, scene_radius=50.0)
    t = convert.object_from(_plain_light(j), "cpu")
    assert isinstance(t, tl.ImageInfiniteLight)
    p, u2, lam, d = _inputs(2)
    u2[:16] = 0.0
    u2[16:32, 0] = np.asarray(j._cdf_rows)[:16]
    u2[32:64, 1] = np.asarray(j._cdf_cols)[0]
    got = t.sample_li(*_t(p, u2, lam))
    want = j.sample_li(*_j(p, u2, lam))
    for name in ("dist", "pdf", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    _close(got.wi, want.wi)
    _close(got.L, want.L)
    _close(t.pdf_li(*_t(p, d)), j.pdf_li(*_j(p, d)))
    _close(t.le_escaped(*_t(d, lam)), j.le_escaped(*_j(d, lam)))
    assert t.power_estimate() == j.power_estimate()
    assert tl.light_power(t) == jl.light_power(j)


def test_portal_light_matches_jax():
    img = np.random.default_rng(7).random((64, 64, 3), np.float32) + 0.05
    j = portal_light(img, PORTAL, scale=1.2)
    t = convert.object_from(_plain_light(j), "cpu")
    p, u2, lam, d = _inputs(3, 0.5)
    got = t.sample_li(*_t(p, u2, lam))
    want = j.sample_li(*_j(p, u2, lam))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    ok = (np.isclose(got.pdf.numpy(), want.pdf, rtol=1e-5, atol=0)
          & np.isclose(got.L.numpy(), want.L, rtol=1e-5, atol=1e-6).all(-1)
          & np.isclose(got.wi.numpy(), want.wi, rtol=0, atol=2e-5).all(-1)
          & (got.valid.numpy() == np.asarray(want.valid)))
    assert ok.mean() >= 0.999, ok.mean()
    assert np.asarray(want.valid).mean() > 0.99
    # pdf_li of the JAX sample's direction
    _close(t.pdf_li(torch.as_tensor(p), torch.as_tensor(np.array(want.wi))),
           j.pdf_li(jnp.asarray(p), want.wi), atol=0)
    _close(t.pdf_li(*_t(p, d)), j.pdf_li(*_j(p, d)), atol=0)
    _close(t.le_escaped(*_t(d, lam)), j.le_escaped(*_j(d, lam)))
    assert t.power_estimate() == j.power_estimate()


def test_projection_and_goniometric_lights_match_jax():
    tex = np.random.default_rng(5).random((8, 16, 3)).astype(np.float32)
    flat = jsp.constant_spectrum
    jlights = [
        jl.ProjectionLight(position=np.array([0.2, 3.0, 0.1]),
                           direction=np.array([0.0, -1.0, 0.1]),
                           image=jt.ImageTexture(tex), spectrum=flat(2.0),
                           scale=1.3, fov_deg=60.0),
        jl.GoniometricLight(position=np.array([0.2, 0.3, 0.1]),
                            image=jt.ImageTexture(tex), spectrum=flat(2.0),
                            scale=1.3),
    ]
    p, u2, lam, d = _inputs(4)
    for j in jlights:
        t = convert.object_from(_plain_light(j), "cpu")
        got = t.sample_li(*_t(p, u2, lam))
        want = j.sample_li(*_j(p, u2, lam))
        for a, b in zip(got, want):
            _close(a, b)
        assert float(np.asarray(want.L).max()) > 0
        assert not t.pdf_li(*_t(p, d)).any()
        assert not t.le_escaped(*_t(d, lam)).any()
        assert t.power_estimate() == j.power_estimate()
        assert tl._light_center(t).tolist() == jl._light_center(j).tolist()


@pytest.mark.parametrize("strategy", ["uniform", "power", "bvh"])
def test_light_sampling_with_image_lights_matches_jax(strategy):
    """sample_one_light / pdf_one_light / escaped_radiance over a sun, an
    environment map, a projector and a goniometric light: light_power's
    and the bvh importance's view of the new lights."""
    tex = np.random.default_rng(5).random((8, 16, 3)).astype(np.float32)
    flat = jsp.constant_spectrum
    jlights = [
        jl.DistantLight(direction=np.array([0.3, -1.0, 0.2]) / 1.06,
                        spectrum=flat(2.0), scene_radius=20.0),
        jl.ImageInfiniteLight(_env(), scale=0.4, scene_radius=20.0),
        jl.ProjectionLight(position=np.array([0.0, 3.0, 0.0]),
                           direction=np.array([0.1, -1.0, 0.0]),
                           image=jt.ImageTexture(tex), spectrum=flat(3.0)),
        jl.GoniometricLight(position=np.array([1.0, 1.0, 0.0]),
                            image=jt.ImageTexture(tex), spectrum=flat(1.0)),
    ]
    tlights = [convert.object_from(_plain_light(lt), "cpu") for lt in jlights]
    p, u2, lam, d = _inputs(6)
    u1 = np.random.default_rng(8).random(N, dtype=np.float32)
    got, got_delta = tl.sample_one_light(tlights, *_t(p, u1, u2, lam),
                                         strategy)
    want, want_delta = jl.sample_one_light(jlights, *_j(p, u1, u2, lam),
                                           strategy)
    for a, b in zip(got, want):
        _close(a, b)
    np.testing.assert_array_equal(got_delta.numpy(), np.asarray(want_delta))
    _close(tl.pdf_one_light(tlights, *_t(p, d), strategy),
           jl.pdf_one_light(jlights, *_j(p, d), strategy))
    for a, b in zip(tl.escaped_radiance(tlights, *_t(d, lam)),
                    jl.escaped_radiance(jlights, *_j(d, lam))):
        _close(a, b)


def test_sky_matches_jax():
    np.testing.assert_array_equal(tsky.make_sky_image(16, 35.0, 4.0),
                                  jsky.make_sky_image(16, 35.0, 4.0))
    uv = np.random.default_rng(2).random((500, 2))
    d = tsky.equal_area_square_to_sphere(uv)
    np.testing.assert_array_equal(d, jsky.equal_area_square_to_sphere(uv))
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-12)
    np.testing.assert_allclose(tsky.equal_area_sphere_to_square(d), uv,
                               atol=1e-9)
    eq = np.random.default_rng(3).random((8, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(tsky.lat_long_to_equal_area(eq),
                                  jsky.lat_long_to_equal_area(eq))


def test_chip_smoke_cloud_under_sky():
    """chip_smoke.py's phase 25 scene at 32x24: the sun kept, the uniform
    sky replaced by the sky map at the sun's elevation with the uniform
    sky's mean luminance."""
    sc = chip_smoke.cloud_under_sky(presets.cloud(**SMALL, device="cpu"),
                                    res=16)
    sun, env = sc.lights
    assert sun.is_delta and isinstance(env, tl.ImageInfiniteLight)
    assert env.image.shape == (16, 32, 3) and np.isfinite(env.image).all()
    lum = (0.2126 * env.image[..., 0] + 0.7152 * env.image[..., 1]
           + 0.0722 * env.image[..., 2]).mean() * env.scale
    assert abs(lum - 0.03) < 1e-6
    assert 45.0 < chip_smoke.sun_elevation_deg(sc) < 55.0


# ---- the reference's portal-light gates (tests/test_portal_light.py) ----

@pytest.fixture(scope="module")
def portal():
    img = np.random.default_rng(7).random((64, 64, 3), np.float32) + 0.05
    return tl.PortalImageInfiniteLight(img, PORTAL, scale=1.0)


def test_portal_sample_pdf_consistency(portal):
    rng = np.random.default_rng(3)
    n = 2048
    p = torch.zeros((n, 3))
    s = portal.sample_li(p, torch.as_tensor(rng.random((n, 2), np.float32)),
                         torch.full((n, 4), 550.0))
    assert float(s.valid.float().mean()) > 0.99
    pl = portal.pdf_li(p, s.wi).numpy()
    ok = s.valid.numpy()
    pdf = s.pdf.numpy()
    assert (np.abs(pl[ok] - pdf[ok]) / pdf[ok]).max() < 1e-4


def test_portal_pdf_integrates_to_one(portal):
    d = np.random.default_rng(5).standard_normal((100000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pli = portal.pdf_li(torch.zeros((d.shape[0], 3)),
                        torch.as_tensor(d, dtype=torch.float32)).numpy()
    assert abs(pli.mean() * 4 * np.pi - 1.0) < 0.06


def test_portal_energy_unbiased(portal):
    rng = np.random.default_rng(11)
    n = 8192
    s = portal.sample_li(torch.zeros((n, 3)),
                         torch.as_tensor(rng.random((n, 2), np.float32)),
                         torch.full((n, 4), 550.0))
    ok = s.valid.numpy()
    est = (s.L.numpy()[ok, 0] / s.pdf.numpy()[ok]).mean()
    d = rng.standard_normal((200000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    le = portal.le_escaped(torch.as_tensor(d, dtype=torch.float32),
                           torch.full((d.shape[0], 4), 550.0)).numpy()[:, 0]
    ref = le.mean() * 4 * np.pi
    assert abs(est - ref) / ref < 0.1


def test_portal_back_side_invalid(portal):
    p = torch.tensor([[0.0, 0.0, 20.0]] * 4)
    u2 = torch.as_tensor(np.random.default_rng(0).random((4, 2), np.float32))
    assert not portal.sample_li(p, u2, torch.full((4, 4), 550.0)).valid.any()
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    assert float(portal.pdf_li(p, d).max()) == 0.0


def test_portal_le_escaped_windowed(portal):
    le = portal.le_escaped(torch.tensor([[0, 0, 1.0], [0, 0, -1.0]]),
                           torch.full((2, 4), 550.0)).numpy()
    assert le[0].sum() > 0 and le[1].sum() == 0


# ---- frames ----

def test_environment_map_only_frame():
    """tests/test_volpath.py:132's gate with a constant environment map:
    no medium, no surface, a luminance-0.7 map: every pixel 0.7."""
    from acceleratedvolrenderer_tpu.models.cameras import PerspectiveCamera
    from acceleratedvolrenderer_tpu.models.film import BoxFilter
    from acceleratedvolrenderer_tpu.scene import Scene as JScene
    from acceleratedvolrenderer_tpu.utils import vecmath as jvm

    env = np.full((8, 16, 3), 0.7, np.float32)
    cam = PerspectiveCamera(c2w=jvm.look_at((0, 0, -3), (0, 0, 0), (0, 1, 0)),
                            fov_deg=40.0, width=4, height=4)
    js = JScene(camera=cam, medium=None,
                lights=[jl.ImageInfiniteLight(env, scene_radius=10.0)],
                filter=BoxFilter(), spp=32, scene_radius=10.0)
    ref, _ = jrender.render(js)
    ts = convert.scene_from_arrays(surface_arrays_from_jax_scene(js), "cpu")
    img, _ = trender.render(ts, device="cpu")
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)
    lum = img @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    np.testing.assert_allclose(lum.mean(), 0.7, atol=0.02)


@pytest.fixture(scope="module")
def sky_scenes():
    """The 32x24 cloud at spp 2 under a 16x32 sky map (the JAX scene and
    the port's), by sampler."""
    env = chip_smoke.sky_env_map(16, 50.0)
    out = {}
    for kind in ("zsobol", "pmj02bn"):
        js = jpresets.cloud(**SKY_SMALL)
        js = dataclasses.replace(js, sampler=kind, lights=[
            js.lights[0], jl.ImageInfiniteLight(env, scale=0.01,
                                                scene_radius=js.scene_radius)])
        out[kind] = (js, convert.scene_from_arrays(
            surface_arrays_from_jax_scene(js), "cpu"))
    return out


def assert_frames_close(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert img.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()


@pytest.mark.parametrize("kind", ["zsobol", "pmj02bn"])
@pytest.mark.parametrize("entry", ["render", "regen"])
def test_cloud_under_sky_matches_jax(sky_scenes, kind, entry):
    js, ts = sky_scenes[kind]
    if entry == "render":
        ref, _ = jrender.render(js)
        img, _ = trender.render(ts, device="cpu")
    else:
        ref, _ = jrender.render_regen(js, **SMALL_KNOBS)
        img, _ = trender.render_regen(ts, device="cpu", **SMALL_KNOBS)
    assert_frames_close(img, ref)
