"""The port's sensor and spectral film (models/film.py: white_balance_matrix,
PixelSensor, SpectralFilm) and the render entries beside render()
(parallel/render.py: render_with_aovs, render_gbuffer, render_spectral)
against the JAX package's, with the reference's gates
(tests/test_film_sensor.py, tests/test_volpath.py:188) on the port.

Tolerances: the white-balance matrix is the same float64 numpy, equal; the
sensor's fitted matrix comes from float32 spectra that differ by ulps of exp
between XLA:CPU and torch (atol 1e-5); film sums to float32 rounding (rtol
1e-6 / atol 1e-7: scatter-adds in another order); frames under phase 5's
rule (means to 1e-3, 99% of pixels to rtol 1e-3 / atol 1e-5); the G-buffer's
geometry to rtol 1e-5 / atol 1e-5 on 99.9% of pixels (a ray grazing an
edge may hit on one side only).  Within the port, render_spectral's RGB
equals render()'s bit for bit: the same waves through the same film sums.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import film as jfilm
from acceleratedvolrenderer_tpu.models import lights as jl
from acceleratedvolrenderer_tpu.models import materials as jm
from acceleratedvolrenderer_tpu.models import shapes as jshapes
from acceleratedvolrenderer_tpu.models.cameras import PerspectiveCamera
from acceleratedvolrenderer_tpu.models.media import homogeneous_box
from acceleratedvolrenderer_tpu.parallel import render as jrender
from acceleratedvolrenderer_tpu.scene import Scene as JScene
from acceleratedvolrenderer_tpu.scene import presets as jpresets
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu.utils import vecmath as jvm
from acceleratedvolrenderer_tpu.utils.image import read_exr
from acceleratedvolrenderer_tpu_torch.models import film as tfilm
from acceleratedvolrenderer_tpu_torch.parallel import render as trender
from acceleratedvolrenderer_tpu_torch.scene import convert
from acceleratedvolrenderer_tpu_torch.utils import spectrum as tsp

from torch_port_util import arrays_from_jax_scene
from torch_surface_util import surface_arrays_from_jax_scene

torch.set_num_threads(2)

flat = jsp.constant_spectrum


def assert_frames_close(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert img.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()


def _samples(n=512, seed=3, h=6, w=5):
    rng = np.random.default_rng(seed)
    pix = np.stack([rng.integers(-1, w + 1, n), rng.integers(-1, h + 1, n)],
                   -1).astype(np.int32)
    lam = rng.uniform(360, 830, (n, 4)).astype(np.float32)
    pdf = rng.uniform(0.0, 0.01, (n, 4)).astype(np.float32)
    pdf[:20, 1] = 0.0
    L = rng.uniform(0, 2, (n, 4)).astype(np.float32)
    return pix, L, lam, pdf


def test_white_balance_and_sensors_match_jax():
    src, dst = (0.4476, 0.4074), (0.3127, 0.3290)   # illuminant A -> D65
    np.testing.assert_array_equal(tfilm.white_balance_matrix(src, dst),
                                  jfilm.white_balance_matrix(src, dst))
    for kw in (dict(), dict(sensor_illum_xy=src),
               dict(response=None, sensor_illum_xy=dst, imaging_ratio=2.0)):
        t, j = tfilm.PixelSensor(**kw), jfilm.PixelSensor(**kw)
        np.testing.assert_allclose(t.xyz_from_rgb, j.xyz_from_rgb, atol=1e-5)
        _, L, lam, pdf = _samples()
        got = t.to_xyz(torch.as_tensor(L), tsp.SampledWavelengths(
            torch.as_tensor(lam), torch.as_tensor(pdf)))
        want = j.to_xyz(jnp.asarray(L), jsp.SampledWavelengths(
            jnp.asarray(lam), jnp.asarray(pdf)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_spectral_film_add_samples_matches_jax():
    pix, L, lam, pdf = _samples()
    t = tfilm.SpectralFilm.create(6, 5, n_buckets=7, device="cpu")
    j = jfilm.SpectralFilm.create(6, 5, n_buckets=7)
    for _ in range(2):
        t = t.add_samples(torch.as_tensor(pix), torch.as_tensor(L),
                          tsp.SampledWavelengths(torch.as_tensor(lam),
                                                 torch.as_tensor(pdf)),
                          max_component=50.0)
        j = j.add_samples(jnp.asarray(pix), jnp.asarray(L),
                          jsp.SampledWavelengths(jnp.asarray(lam),
                                                 jnp.asarray(pdf)),
                          max_component=50.0)
    for a, b in zip(t[:4], j[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(t.bucket_images().numpy(),
                               np.asarray(j.bucket_images()), rtol=1e-6,
                               atol=1e-7)
    assert t.channel_names() == j.channel_names()


# ---- the reference's gates (tests/test_film_sensor.py), on the port ----

def test_default_sensor_matches_to_xyz():
    lam = torch.tensor([[450.0, 550.0, 600.0, 650.0]])
    swl = tsp.SampledWavelengths(lam, torch.ones_like(lam))
    L = torch.tensor([[1.0, 2.0, 0.5, 1.5]])
    np.testing.assert_allclose(tfilm.PixelSensor().to_xyz(L, swl).numpy(),
                               tsp.to_xyz(L, swl).numpy(), atol=1e-6)


def test_white_balance_maps_whites():
    src, dst = (0.4476, 0.4074), (0.3127, 0.3290)
    out = tfilm.white_balance_matrix(src, dst) @ np.array(
        [src[0] / src[1], 1.0, (1 - src[0] - src[1]) / src[1]])
    assert np.allclose(out[:2] / out.sum(), dst, atol=1e-4)


def test_trained_sensor_near_identity_for_cie():
    s = tfilm.PixelSensor(sensor_illum_xy=(0.3127, 0.3290))
    assert np.allclose(s.xyz_from_rgb, np.eye(3), atol=0.05)


def test_spectral_film_buckets():
    film = tfilm.SpectralFilm.create(4, 4, n_buckets=8, device="cpu")
    lam = torch.tensor([[400.0, 500.0, 600.0, 700.0]] * 2)
    film = film.add_samples(torch.tensor([[1, 1], [2, 2]]), torch.ones(2, 4),
                            tsp.SampledWavelengths(lam, torch.ones_like(lam)))
    b = film.bucket_images().numpy()
    assert (b[1, 1] > 0).sum() == 4 and (b[0, 0] == 0).all()
    names = film.channel_names()
    assert len(names) == 8 and names[0].startswith("C01_")


@pytest.fixture(scope="module")
def emissive():
    js = jpresets.emissive_volume(res=12, spp=2)
    return js, convert.scene_from_arrays(arrays_from_jax_scene(js), "cpu")


def test_spectral_render_matches_jax_and_render(emissive, tmp_path):
    """render_spectral of test_film_sensor.py's emissive volume: RGB and
    buckets against the JAX package's, RGB equal to the port's render()
    bit for bit, and the EXR of R, G, B and four buckets."""
    js, ts = emissive
    jf, _ = jrender.render_spectral(js, n_buckets=4)
    tf, st = trender.render_spectral(ts, n_buckets=4, device="cpu")
    img = tf.to_image().numpy()
    assert_frames_close(img, np.asarray(jf.to_image()))
    buckets = tf.bucket_images().numpy()
    want = np.asarray(jf.bucket_images())
    assert np.isfinite(buckets).all() and buckets.max() > 0
    assert abs(buckets.mean() - want.mean()) / want.mean() < 1e-3
    ref, _ = trender.render(ts, device="cpu")
    np.testing.assert_array_equal(img, ref)
    assert st["spp"] == 2 and st["rays_per_sec"] > 0
    path = tmp_path / "spec.exr"
    tf.write(str(path), spp=2)
    chans, names, _ = read_exr(str(path))
    assert chans.shape[-1] == 7
    assert sorted(names) == sorted(["R", "G", "B"] + tf.channel_names())


def _sphere_scene(res=16):
    sph = jshapes.Sphere(center=np.array([0.0, 0.0, 3.0]), radius=1.0,
                         material=jm.DiffuseMaterial(reflectance=flat(0.5)))
    quad = jshapes.Quad(origin=np.array([-3.0, -1.0, 1.0]),
                        e1=np.array([6.0, 0.0, 0.0]),
                        e2=np.array([0.0, 0.0, 6.0]),
                        material=jm.DiffuseMaterial(reflectance=flat(0.8)))
    cam = PerspectiveCamera(c2w=jvm.look_at((0, 0.3, 0), (0, 0, 1), (0, 1, 0)),
                            fov_deg=45.0, width=res, height=res)
    return JScene(camera=cam, medium=None,
                  lights=[jl.PointLight(position=np.zeros(3),
                                        spectrum=flat(1.0))],
                  primitives=[sph, quad], max_depth=2,
                  filter=jfilm.BoxFilter(), spp=1, scene_radius=10.0)


def test_gbuffer_matches_jax():
    js = _sphere_scene()
    want, _ = jrender.render_gbuffer(js)
    ts = convert.scene_from_arrays(surface_arrays_from_jax_scene(js), "cpu")
    got, st = trender.render_gbuffer(ts, device="cpu")
    assert set(got) == set(want) and st["render_time"] >= 0
    fin = np.isfinite(want["depth"])
    np.testing.assert_array_equal(np.isfinite(got["depth"]), fin)
    for k in ("P", "N", "albedo", "uv", "depth"):
        a, b = got[k], np.asarray(want[k])
        assert a.shape == b.shape, k
        close = np.isclose(a, b, rtol=1e-5, atol=1e-5)
        close = close.reshape(close.shape[0], close.shape[1], -1).all(-1)
        assert close.mean() >= 0.999, (k, close.mean())


def test_gbuffer_pass():
    """test_film_sensor.py::test_gbuffer_pass on the port (its sphere
    alone)."""
    js = _sphere_scene()
    js.primitives.pop()
    ts = convert.scene_from_arrays(surface_arrays_from_jax_scene(js), "cpu")
    aovs, _ = trender.render_gbuffer(ts, device="cpu")
    d = aovs["depth"]
    assert np.isfinite(d[8, 8]) and 1.5 < d[8, 8] < 2.5
    assert not np.isfinite(d[0, 0])
    assert abs(aovs["N"][8, 8][2]) > 0.9
    assert aovs["albedo"][8, 8].mean() > 0.1


def test_gbuffer_without_surfaces(emissive):
    aovs, _ = trender.render_gbuffer(emissive[1], device="cpu")
    assert not np.isfinite(aovs["depth"]).any()
    assert not aovs["N"].any() and aovs["uv"].shape == (12, 12, 2)


def _furnace_scene():
    """test_volpath.py:188's scene: a unit scattering box under a unit
    environment."""
    from acceleratedvolrenderer_tpu.models.film import BoxFilter

    med = homogeneous_box(flat(0.0), flat(1.0), lo=(0, 0, 0), hi=(1, 1, 1))
    cam = PerspectiveCamera(
        c2w=jvm.look_at((0.5, 0.5, -2.5), (0.5, 0.5, 0.5), (0, 1, 0)),
        fov_deg=30.0, width=8, height=8)
    return JScene(camera=cam, medium=med,
                  lights=[jl.UniformInfiniteLight(spectrum=flat(1.0))],
                  max_depth=10, filter=BoxFilter(), spp=16)


def test_render_with_aovs_matches_jax_and_gate():
    """The image against the JAX package's render_with_aovs and
    test_volpath.py:188's gate: variance finite, positive, higher inside
    the furnace than on its background."""
    js = _furnace_scene()
    want_img, want_aovs, _ = jrender.render_with_aovs(js)
    ts = convert.scene_from_arrays(arrays_from_jax_scene(js), "cpu")
    img, aovs, st = trender.render_with_aovs(ts, device="cpu")
    assert_frames_close(img, want_img)
    var = aovs["variance"]
    assert var.shape == img.shape and np.isfinite(var).all()
    assert var.mean() > 0
    assert var[3:5, 3:5].mean() > var[0, 0].mean()
    rel = abs(var.mean() - want_aovs["variance"].mean()) / var.mean()
    assert rel < 1e-2, rel
    assert np.isfinite(aovs["relative_variance"]).all()
    assert st["spp"] == 16
