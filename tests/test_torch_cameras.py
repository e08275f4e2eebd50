"""The port's cameras (models/cameras.py) and the spectrum and vecmath pieces
the scene parser needs, against the JAX package's: generate_rays of the
perspective, orthographic, spherical and realistic cameras on the same
pixels and jitters (to 1e-6), tests/test_realistic_camera.py's four gates on
the port, equal_area_square_to_sphere, the torch twin of np.interp (inside
and outside its table), Smits' RGB spectra and the named spectra at 64
wavelengths (to rtol 1e-6: the two packages differ by an ulp in exp and in
an interpolation's rounding)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import cameras as jcam
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu.utils import vecmath as jvm
from acceleratedvolrenderer_tpu_torch.models import cameras as tcam
from acceleratedvolrenderer_tpu_torch.utils import spectrum as tsp
from acceleratedvolrenderer_tpu_torch.utils import vecmath as tvm

EYE, LOOK, UP = (0.3, 0.5, -2.0), (0.5, 0.4, 0.5), (0, 1, 0)


def _pixels(w, h, n, seed=0):
    rng = np.random.default_rng(seed)
    pxy = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], -1)
    return pxy.astype(np.int32), rng.random((n, 2)).astype(np.float32)


def _pair(kind, w=24, h=16):
    """The same camera in both packages."""
    jc2w = jvm.look_at(EYE, LOOK, UP)
    tc2w = tvm.look_at(EYE, LOOK, UP, "cpu")
    if kind == "perspective":
        return (jcam.PerspectiveCamera(jc2w, 35.0, w, h),
                tcam.PerspectiveCamera(tc2w, 35.0, w, h))
    if kind == "orthographic":
        return (jcam.OrthographicCamera(jc2w, 1.5, w, h),
                tcam.OrthographicCamera(tc2w, 1.5, w, h))
    if kind == "spherical":
        return (jcam.SphericalCamera(jc2w, w, h),
                tcam.SphericalCamera(tc2w, w, h))
    kw = dict(elements=jcam.SIMPLE_LENS, width=w, height=h, rear_offset=0.045)
    return jcam.RealisticCamera(jc2w, **kw), tcam.RealisticCamera(tc2w, **kw)


@pytest.mark.parametrize("kind", ["perspective", "orthographic", "spherical",
                                  "realistic"])
@pytest.mark.parametrize("shape", [(24, 16), (16, 24)])
def test_generate_rays_matches_jax(kind, shape):
    jc, tc = _pair(kind, *shape)
    pxy, u = _pixels(*shape, 512)
    o_j, d_j = jc.generate_rays(jnp.asarray(pxy), jnp.asarray(u))
    o_t, d_t = tc.generate_rays(torch.as_tensor(pxy), torch.as_tensor(u))
    o_j, d_j = np.asarray(o_j), np.asarray(d_j)
    o_t, d_t = o_t.numpy(), d_t.numpy()
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-6)
    # the vignetted sentinel origin 1e8 compares relatively
    np.testing.assert_allclose(o_t, o_j, rtol=1e-6, atol=1e-6)
    assert np.isfinite(d_t).all()


def test_realistic_lens_samples_match_jax():
    jc, tc = _pair("realistic", 32, 32)
    pxy, u = _pixels(32, 32, 256, seed=3)
    ul = np.random.default_rng(4).random((256, 2)).astype(np.float32)
    o_j, d_j = jc.generate_rays(jnp.asarray(pxy), jnp.asarray(u),
                                jnp.asarray(ul))
    o_t, d_t = tc.generate_rays(torch.as_tensor(pxy), torch.as_tensor(u),
                                torch.as_tensor(ul))
    valid = np.asarray(o_j)[:, 0] < 1e6
    assert 0.2 < valid.mean() < 1.0
    np.testing.assert_array_equal(o_t.numpy()[:, 0] < 1e6, valid)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-6,
                               atol=1e-6)


def test_cameras_move_to_a_device():
    for kind in ("perspective", "orthographic", "spherical", "realistic"):
        _, tc = _pair(kind)
        moved = tc.to("cpu")
        assert type(moved) is type(tc)
        assert torch.equal(moved.c2w.m, tc.c2w.m)


# tests/test_realistic_camera.py's four gates, on the port

def _realistic():
    return tcam.RealisticCamera(
        c2w=tvm.look_at((0, 0, 0), (0, 0, 1), (0, 1, 0), "cpu"),
        elements=tcam.SIMPLE_LENS, width=32, height=32, rear_offset=0.045)


def test_realistic_center_ray_goes_forward():
    o, d = _realistic().generate_rays(torch.tensor([[16, 16]]),
                                      torch.full((1, 2), 0.5),
                                      torch.full((1, 2), 0.5))
    assert float(d[0, 2]) > 0.9
    assert torch.isfinite(o).all()


def test_realistic_aperture_vignettes_corners():
    cam, n = _realistic(), 256
    u_lens = torch.as_tensor(np.random.default_rng(0).random((n, 2)),
                             dtype=torch.float32)
    u_film = torch.full((n, 2), 0.5)
    o_c, _ = cam.generate_rays(torch.tensor([[16, 16]]).repeat(n, 1),
                               u_film, u_lens)
    o_k, _ = cam.generate_rays(torch.tensor([[0, 0]]).repeat(n, 1), u_film,
                               u_lens)
    frac = lambda o: float((o[:, 0] < 1e6).float().mean())
    assert frac(o_c) >= frac(o_k)
    assert frac(o_c) > 0.3


def test_realistic_rays_focus():
    cam, n = _realistic(), 64
    u_lens = torch.as_tensor(
        0.25 + 0.5 * np.random.default_rng(1).random((n, 2)),
        dtype=torch.float32)
    o, d = cam.generate_rays(torch.tensor([[16, 16]]).repeat(n, 1),
                             torch.full((n, 2), 0.5), u_lens)
    o, d = o.numpy(), d.numpy()
    ok = np.isfinite(o[:, 0]) & (np.abs(o[:, 0]) < 1e6)
    o, d = o[ok], d[ok]
    assert len(o) > 8

    def spread(z):
        t = (z - o[:, 2]) / d[:, 2]
        return (o + t[:, None] * d)[:, :2].std()

    assert spread(3.0) < spread(30.0)


def test_load_lens_file(tmp_path):
    f = tmp_path / "lens.dat"
    f.write_text("# test lens\n35.0 2.0 1.52 26.0\n0 4.0 1 18.0\n"
                 "-35.0 30.0 1.0 26.0\n")
    e = tcam.load_lens_file(str(f))
    assert e.shape == (3, 4)
    assert abs(e[0, 0] - (-0.035)) < 1e-9
    assert abs(e[2, 3] - 0.013) < 1e-9
    np.testing.assert_array_equal(e, jcam.load_lens_file(str(f)))


def test_equal_area_square_to_sphere_matches_jax():
    rng = np.random.default_rng(2)
    uv = rng.random((4096, 2)).astype(np.float32)
    uv[:4] = [[0.5, 0.5], [0.0, 0.0], [1.0, 0.5], [0.5, 1.0]]
    a = np.asarray(jvm.equal_area_square_to_sphere(jnp.asarray(uv)))
    b = tvm.equal_area_square_to_sphere(torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(b, axis=-1), 1.0, atol=1e-5)


def test_matrix_helpers_match_jax():
    np.testing.assert_array_equal(
        np.asarray(jvm.look_at(EYE, LOOK, UP).m),
        tvm.look_at_matrix(EYE, LOOK, UP).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(jvm.rotate(37.0, (1, 2, 3)).m),
        tvm.rotate_matrix(37.0, (1, 2, 3)).astype(np.float32))


@pytest.mark.parametrize("table", ["smits", "metal", "two points"])
def test_interp_matches_numpy(table):
    """spectrum.interp against np.interp in float32, inside the table, on
    its points and outside on both sides."""
    xp, fp = {"smits": (tsp._SMITS_LAMBDA, tsp._SMITS_CYAN),
              "metal": tsp._METAL_IOR["metal-Au-k"],
              "two points": ((450.0, 650.0), (2.0, -1.0))}[table]
    xp32, fp32 = np.float32(xp), np.float32(fp)
    x = np.concatenate([np.linspace(300, 900, 257), xp32,
                        [xp32[0] - 1, xp32[-1] + 1]]).astype(np.float32)
    got = tsp.interp(torch.as_tensor(x), xp, fp).numpy()
    want = np.interp(x, xp32, fp32).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[0] == fp32[0] and got[-1] == fp32[-1]


LAM = np.linspace(360.0, 830.0, 64).astype(np.float32)


def _both(jf, tf):
    return (np.asarray(jf(jnp.asarray(LAM))),
            tf(torch.as_tensor(LAM)).numpy())


@pytest.mark.parametrize("rgb", [(1, 1, 1), (0.8, 0.1, 0.1), (0.1, 0.5, 0.9),
                                 (0.3, 0.9, 0.2), (0.5, 0.2, 0.7),
                                 (0.2, 0.7, 0.5), (0.9, 0.6, 0.3)])
def test_rgb_albedo_spectrum_matches_jax(rgb):
    a, b = _both(jsp.rgb_albedo_spectrum(rgb), tsp.rgb_albedo_spectrum(rgb))
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(jsp._GLASS_SELLMEIER)
                         + sorted(jsp._METAL_IOR)
                         + ["stdillum-A", "stdillum-D50", "stdillum-D65",
                            "canonical", "illum-acesD60"])
def test_named_spectrum_matches_jax(name):
    a, b = _both(jsp.named_spectrum(name), tsp.named_spectrum(name))
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_unknown_named_spectrum_is_none():
    assert tsp.named_spectrum("no-such-spectrum") is None
    assert jsp.named_spectrum("no-such-spectrum") is None


def test_d_illuminant_matches_jax():
    a, b = _both(jsp.d_illuminant(5500.0), tsp.d_illuminant(5500.0))
    np.testing.assert_allclose(b, a, rtol=1e-6)
