"""The port's SPPM integrator (models/integrators/sppm.py) against the JAX
package's: _hash_cell bit for bit (negative cells included), the
wavelength strata, the camera pass's visible points, the photon pass's
flux, counts and truncated candidates on an 8x8 scene whose candidate runs
pass the cap, and render_sppm at 8x8 over 2 iterations.

The passes run outside jit on both sides with the same streams and
wavelengths: the visible points and Ld to rtol 1e-4 / atol 1e-6 on at
least 98% of the pixels (a lobe choice may flip on an ulp), M and the
truncated count equal and Phi to rtol 1e-4 / atol 1e-6 (the
scatter-add's summation order differs).  render_sppm runs the JAX
package's iteration under jax.disable_jit (its jitted form takes a minute
to compile here): the means to 1e-3 relative and at least 95% of the pixels
to rtol 1e-3 / atol 1e-5, and the truncated counts within 1% (one photon
that rounds into another cell moves a whole run).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import cameras as jcam
from acceleratedvolrenderer_tpu.models import lights as jl
from acceleratedvolrenderer_tpu.models import materials as jm
from acceleratedvolrenderer_tpu.models import shapes as js
from acceleratedvolrenderer_tpu.models.film import BoxFilter
from acceleratedvolrenderer_tpu.models.integrators import sppm as jsppm
from acceleratedvolrenderer_tpu.ops import dda as jdda
from acceleratedvolrenderer_tpu.scene import Scene as JScene
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu.utils import vecmath as jvm
from acceleratedvolrenderer_tpu_torch.models.integrators import sppm as tsppm
from acceleratedvolrenderer_tpu_torch.ops import dda as tdda
from acceleratedvolrenderer_tpu_torch.scene import convert

from torch_surface_util import surface_arrays_from_jax_scene

torch.set_num_threads(2)

flat = jsp.constant_spectrum
RES = 8


def _scene(spp=2, light="point"):
    """A diffuse enclosure (the reference's furnace sphere, R 3) with a
    glass and a rough conductor sphere inside, lit by a point light or by
    an emissive quad."""
    prims = [
        js.Sphere(center=np.zeros(3), radius=3.0,
                  material=jm.DiffuseMaterial(reflectance=flat(0.5))),
        js.Sphere(center=np.array([0.8, -0.5, 1.8]), radius=0.5,
                  material=jm.DielectricMaterial(eta=1.5)),
        js.Sphere(center=np.array([-0.9, -0.6, 2.0]), radius=0.5,
                  material=jm.ConductorMaterial(eta=0.2, k=3.0,
                                                roughness=0.3)),
    ]
    lights = []
    if light == "point":
        lights = [jl.PointLight(position=np.array([0.0, 1.5, 1.0]),
                                spectrum=flat(20.0))]
    else:
        prims.append(js.Quad(
            origin=np.array([-0.5, 2.0, 0.5]), e1=np.array([1.0, 0, 0]),
            e2=np.array([0, 0, 1.0]),
            material=jm.DiffuseMaterial(reflectance=flat(0.0),
                                        emission=flat(8.0))))
    cam = jcam.PerspectiveCamera(
        c2w=jvm.look_at((0, 0, -1.0), (0, -0.3, 2.0), (0, 1, 0)),
        fov_deg=60.0, width=RES, height=RES)
    return JScene(camera=cam, medium=None, lights=lights, primitives=prims,
                  max_depth=5, filter=BoxFilter(), spp=spp, scene_radius=20.0,
                  integrator="sppm")


def _port(jscene):
    return convert.scene_from_arrays(surface_arrays_from_jax_scene(jscene),
                                     "cpu")


def test_hash_cell_bit_for_bit():
    rng = np.random.default_rng(0)
    c = rng.integers(-(1 << 20), 1 << 20, (3, 4096)).astype(np.int32)
    c[:, :4] = [[-1, 0, 2 ** 31 - 1, -2 ** 31]] * 3
    for size in (16, 1 << 12, 1 << 21):
        want = np.asarray(jsppm._hash_cell(*map(jnp.asarray, c), size))
        got = tsppm._hash_cell(*map(torch.as_tensor, c), size).numpy()
        assert (got == want.astype(np.int64)).all()
        assert got.min() >= 0 and got.max() < size


def test_radical_inverse():
    for i in range(40):
        assert (tsppm._radical_inverse_base2(i)
                == jsppm._radical_inverse_base2(i))


def test_render_sppm_matches_jax():
    """The area light's passes are held above; the frame runs the point
    light (the JAX package's eager iteration takes ~45 s here)."""
    jscene = _scene(light="point")
    kw = dict(n_iterations=2, photons_per_iter=1024, max_candidates=4)
    with jax.disable_jit():
        ref, jst = jsppm.render_sppm(jscene, **kw)
    img, st = tsppm.render_sppm(_port(jscene), device="cpu", **kw)
    assert img.shape == ref.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    assert st["photons"] == jst["photons"] == 2048
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.95, close.mean()
    assert (abs(st["truncated_candidates"] - jst["truncated_candidates"])
            <= 0.01 * jst["truncated_candidates"])


def _inputs(jscene, tscene, it=0):
    """Both packages' pass inputs: pixels, the iteration's wavelengths and
    the camera streams, as render_sppm makes them."""
    n = RES * RES
    ys, xs = np.meshgrid(np.arange(RES), np.arange(RES), indexing="ij")
    pix = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)
    u = np.float32(jsppm._radical_inverse_base2(it + 1))
    jswl = jsp.sample_wavelengths_visible(jnp.full((1,), u))
    lam = np.broadcast_to(np.asarray(jswl.lam), (n, 4)).copy()
    idx = np.arange(n)
    return (dict(pix=jnp.asarray(pix), pixidx=jnp.asarray(idx, jnp.uint32),
                 lam=jnp.asarray(lam),
                 rng=jdda.seed_stream(jnp.asarray(idx, jnp.uint32),
                                      jnp.full((n,), it, jnp.uint32))),
            dict(pix=torch.as_tensor(pix).long(),
                 pixidx=torch.as_tensor(idx), lam=torch.as_tensor(lam),
                 rng=tdda.seed_stream(torch.as_tensor(idx),
                                      torch.full((n,), it))))


def _camera_passes(light):
    jscene = _scene(light=light)
    tscene = _port(jscene)
    ji, ti = _inputs(jscene, tscene)
    kw = dict(max_depth=jscene.max_depth, light_strategy="uniform")
    j = jsppm._camera_pass(tuple(jscene.primitives), jscene.lights,
                           jscene.camera, ji["pix"], ji["pixidx"], ji["lam"],
                           ji["rng"], **kw)
    t = tsppm._camera_pass(tuple(tscene.primitives), tscene.lights,
                           tscene.camera, ti["pix"], ti["pixidx"], ti["lam"],
                           ti["rng"], **kw)
    return jscene, tscene, ji, ti, j, t


@pytest.mark.parametrize("light", ["point", "area"])
def test_camera_pass_matches_jax(light):
    _, _, _, _, (jLd, jvp, jrng), (tLd, tvp, trng) = _camera_passes(light)
    ok = np.isclose(tLd.numpy(), np.asarray(jLd), rtol=1e-4,
                    atol=1e-6).all(-1)
    for k in ("p", "n", "wo", "beta", "albedo"):
        ok &= np.isclose(tvp[k].numpy(), np.asarray(jvp[k]), rtol=1e-4,
                         atol=1e-5).all(-1)
    ok &= tvp["valid"].numpy() == np.asarray(jvp["valid"])
    assert ok.mean() >= 0.98, ok.mean()
    assert np.asarray(jvp["valid"]).mean() > 0.5
    assert (np.asarray(jrng).astype(np.int64) == trng.numpy()).mean() >= 0.98


@pytest.mark.parametrize("light,cap", [("point", 4), ("area", 8)])
def test_photon_pass_matches_jax(light, cap):
    """Both photon passes deposit onto the JAX camera pass's visible
    points; a large radius and a small cap make runs pass the cap."""
    jscene, tscene, _, _, (_, jvp, _), _ = _camera_passes(light)
    n = RES * RES
    n_ph = 1024
    tvp = {k: torch.as_tensor(np.asarray(v)) for k, v in jvp.items()}
    radius = np.full((n,), 0.6, np.float32)
    radius[::3] = 0.3
    u = np.float32(jsppm._radical_inverse_base2(1))
    lam = np.broadcast_to(np.asarray(jsp.sample_wavelengths_visible(
        jnp.full((1,), u)).lam), (n_ph, 4)).copy()
    pidx = np.arange(n_ph)
    kw = dict(max_depth=jscene.max_depth, light_strategy="uniform",
              max_candidates=cap, hash_size=128)
    jPhi, jM, jtr, jrng = jsppm._photon_pass(
        tuple(jscene.primitives), jscene.lights, n_ph, jnp.asarray(lam),
        jdda.seed_stream(jnp.asarray(pidx, jnp.uint32),
                         jnp.zeros(n_ph, jnp.uint32), salt=777),
        jvp, jnp.asarray(radius), **kw)
    tPhi, tM, ttr, trng = tsppm._photon_pass(
        tuple(tscene.primitives), tscene.lights, n_ph, torch.as_tensor(lam),
        tdda.seed_stream(torch.as_tensor(pidx),
                         torch.zeros(n_ph, dtype=torch.int64), salt=777),
        tvp, torch.as_tensor(radius), **kw)
    assert int(jtr) > 0, "the cap is not reached"
    assert int(ttr) == int(jtr)
    assert (tM.numpy() == np.asarray(jM)).all()
    assert tM.dtype == torch.int32 and np.asarray(jM).sum() > 0
    np.testing.assert_allclose(tPhi.numpy(), np.asarray(jPhi), rtol=1e-4,
                               atol=1e-6)
    assert (np.asarray(jrng).astype(np.int64) == trng.numpy()).mean() >= 0.99


def test_render_sppm_furnace():
    """tests/test_sppm.py's point-light furnace on the port: a Kd 0.5
    closed sphere of radius R around a point light of I = pi R^2 gives
    L = 1."""
    R = 10.0
    cam = jcam.PerspectiveCamera(c2w=jvm.look_at((0, 0, 0), (0, 0, 1),
                                                 (0, 1, 0)),
                                 fov_deg=50.0, width=RES, height=RES)
    jscene = JScene(
        camera=cam, medium=None,
        lights=[jl.PointLight(position=np.zeros(3),
                              spectrum=flat(np.pi * R * R))],
        primitives=[js.Sphere(center=np.zeros(3), radius=R,
                              material=jm.DiffuseMaterial(
                                  reflectance=flat(0.5)))],
        max_depth=14, filter=BoxFilter(), spp=12, scene_radius=30.0,
        integrator="sppm")
    img, _ = tsppm.render_sppm(_port(jscene), n_iterations=12,
                               photons_per_iter=4096, initial_radius=1.0,
                               device="cpu")
    avg = (img @ np.array([0.2126, 0.7152, 0.0722])).mean()
    assert np.isfinite(img).all() and abs(avg - 1.0) < 0.08, avg


def test_render_sppm_measured_matches_jax(tmp_path):
    """The glass sphere as a measured BRDF: SPPM's NEE and both passes'
    bounces go through the measured dispatch as in the JAX package (one
    iteration, under jax.disable_jit), at test_render_sppm_matches_jax's
    tolerances."""
    import dataclasses

    from torch_surface_util import measured_pair

    jb, _ = measured_pair(tmp_path / "ggx.bsdf")
    jscene = _scene(light="point")
    prims = list(jscene.primitives)
    prims[1] = dataclasses.replace(prims[1],
                                   material=jm.MeasuredMaterial(brdf=jb))
    jscene = dataclasses.replace(jscene, primitives=prims)
    kw = dict(n_iterations=1, photons_per_iter=1024, max_candidates=4)
    with jax.disable_jit():
        ref, _ = jsppm.render_sppm(jscene, **kw)
    img, _ = tsppm.render_sppm(_port(jscene), device="cpu", **kw)
    assert np.isfinite(img).all() and ref.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.95, close.mean()
