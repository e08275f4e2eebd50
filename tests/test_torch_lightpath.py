"""The port's light path integrator (models/integrators/light_path.py:
sample_le, trace_light_paths; parallel/render.py::render_lightpath) and the
perspective camera's projection seam (film_area_z1, project, position)
against the JAX package's, on the same uniforms, wavelengths and PCG
streams made from a numpy seed.

Both sides run their ops outside jit, so every lane draws the same numbers:
sample_le to rtol 1e-5 / atol 1e-6, trace_light_paths' splat pixels equal
on at least 99.5% of the splats (a raster coordinate on a pixel edge may
round the other way on an ulp) and their values to rtol 1e-4 / atol 1e-6
where the pixels agree.  render_lightpath at 12x12 spp 2 runs the JAX
package's jitted wave: the means to 1e-3 relative and at least 97% of the
pixels to rtol 1e-3 / atol 1e-5 (one splat of a few hundred that lands on
the other side of a pixel edge moves two pixels).  The camera is checked
against float64 numpy geometry to 1e-5, card free.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import cameras as jcam
from acceleratedvolrenderer_tpu.models import lights as jl
from acceleratedvolrenderer_tpu.models import materials as jm
from acceleratedvolrenderer_tpu.models import shapes as js
from acceleratedvolrenderer_tpu.models.film import BoxFilter
from acceleratedvolrenderer_tpu.models.integrators import light_path as jlp
from acceleratedvolrenderer_tpu.models.integrators import path as jpath
from acceleratedvolrenderer_tpu.ops import dda as jdda
from acceleratedvolrenderer_tpu.parallel import render as jrender
from acceleratedvolrenderer_tpu.scene import Scene as JScene
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu.utils import vecmath as jvm
from acceleratedvolrenderer_tpu_torch.models import cameras as tcam
from acceleratedvolrenderer_tpu_torch.models.integrators import (
    light_path as tlp)
from acceleratedvolrenderer_tpu_torch.models.integrators import path as tpath
from acceleratedvolrenderer_tpu_torch.ops import dda as tdda
from acceleratedvolrenderer_tpu_torch.parallel import render as trender
from acceleratedvolrenderer_tpu_torch.scene import convert
from acceleratedvolrenderer_tpu_torch.utils import vecmath as tvm

from torch_surface_util import (_plain_light, plain,
                                surface_arrays_from_jax_scene)

torch.set_num_threads(2)

flat = jsp.constant_spectrum
N = 512


def _quad(o, e1, e2, m):
    return js.Quad(origin=np.array(o, float), e1=np.array(e1, float),
                   e2=np.array(e2, float), material=m)


def _prims():
    """tests/test_lightpath.py's floor and lamp (its emissive side facing
    the floor), with a rough conductor and a glass sphere."""
    return [
        _quad([-4, 0, -4], [8, 0, 0], [0, 0, 8],
              jm.DiffuseMaterial(reflectance=flat(0.6))),
        _quad([-1, 3, 1], [2, 0, 0], [0, 0, 2],
              jm.DiffuseMaterial(reflectance=flat(0.0), emission=flat(6.0))),
        js.Sphere(center=np.array([-0.8, 0.5, 1.0]), radius=0.5,
                  material=jm.ConductorMaterial(eta=0.2, k=3.0,
                                                roughness=0.3)),
        js.Sphere(center=np.array([0.9, 0.6, 1.5]), radius=0.6,
                  material=jm.DielectricMaterial(eta=1.5)),
    ]


def _lights():
    return [
        jl.PointLight(position=np.array([0.0, 2.5, 0.5]), spectrum=flat(8.0)),
        jl.DistantLight(direction=np.array([0.2, -1.0, 0.3]) / 1.063,
                        spectrum=flat(1.5), scene_radius=20.0),
    ]


def _camera(w=12, h=12):
    return jcam.PerspectiveCamera(
        c2w=jvm.look_at((0, 2.0, -5), (0, 0.5, 1), (0, 1, 0)), fov_deg=55.0,
        width=w, height=h)


def _scene(prims, lights, spp=2, integrator="lightpath", **kw):
    return JScene(camera=_camera(), medium=None, lights=lights,
                  primitives=prims, max_depth=4, filter=BoxFilter(), spp=spp,
                  scene_radius=50.0, integrator=integrator, **kw)


def _port(jscene):
    return convert.scene_from_arrays(surface_arrays_from_jax_scene(jscene),
                                     "cpu")


def _streams(n, salt=5):
    idx = np.arange(n)
    return (jdda.seed_stream(jnp.asarray(idx), jnp.zeros(n, jnp.int32),
                             salt=salt),
            tdda.seed_stream(torch.as_tensor(idx),
                             torch.zeros(n, dtype=torch.int64), salt=salt))


def _lam(n, seed=3):
    lam = np.random.default_rng(seed).uniform(380, 720, (n, 4))
    return lam.astype(np.float32)


# ---- the camera seam ------------------------------------------------------

@pytest.mark.parametrize("shape", [(24, 16), (16, 24)])
def test_camera_projection_float64(shape):
    """film_area_z1, project and position against float64 numpy geometry,
    and against the JAX camera."""
    w, h = shape
    eye, look = (0.3, 0.5, -2.0), (0.5, 0.4, 0.5)
    jc = jcam.PerspectiveCamera(jvm.look_at(eye, look, (0, 1, 0)), 35.0, w, h)
    tc = tcam.PerspectiveCamera(tvm.look_at(eye, look, (0, 1, 0), "cpu"),
                                35.0, w, h)
    tan_half = np.tan(np.deg2rad(35.0) / 2)
    a = w / h
    sx, sy = ((tan_half * a, tan_half) if a > 1 else
              (tan_half, tan_half / a))
    assert tc.film_area_z1() == pytest.approx(4 * sx * sy, rel=1e-12)
    assert tc.film_area_z1() == jc.film_area_z1()
    np.testing.assert_allclose(tc.position.numpy(), eye, atol=1e-6)

    # points in front of, beside and behind the camera
    rng = np.random.default_rng(11)
    pts = rng.uniform([-2, -1, -4], [3, 2, 4], (256, 3))
    m = np.asarray(jvm.look_at(eye, look, (0, 1, 0)).m, np.float64)
    pc = (np.linalg.inv(m) @ np.c_[pts, np.ones(256)].T).T[:, :3]
    z = pc[:, 2]
    px = (pc[:, 0] / z / sx + 1) * 0.5 * w
    py = (1 - pc[:, 1] / z / sy) * 0.5 * h
    inside = (z > 1e-6) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    cos_t = z / np.linalg.norm(pc, axis=1)
    raster, cos_p, ins = tc.project(torch.as_tensor(pts, dtype=torch.float32))
    front = z > 1e-6
    np.testing.assert_allclose(raster.numpy()[front],
                               np.c_[px, py][front], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(cos_p.numpy(), cos_t, atol=1e-5)
    edge = (np.abs(px - np.round(px)) < 1e-3) | (np.abs(py - np.round(py))
                                                 < 1e-3)
    assert (ins.numpy() == inside)[~edge].all()
    assert inside.sum() > 20 and (~inside).sum() > 20
    rj, cj, ij = jc.project(jnp.asarray(pts, jnp.float32))
    np.testing.assert_allclose(raster.numpy()[front], np.asarray(rj)[front],
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(cos_p.numpy(), np.asarray(cj), atol=1e-6)
    assert (ins.numpy() == np.asarray(ij)).all()


def test_transform_inverse():
    t = tvm.look_at((0.3, 0.5, -2.0), (0.5, 0.4, 0.5), (0, 1, 0), "cpu")
    inv = t.inverse()
    assert inv.m is t.m_inv and inv.m_inv is t.m
    p = torch.tensor([[0.1, -0.4, 2.0]])
    np.testing.assert_allclose(inv.apply_point(t.apply_point(p)).numpy(),
                               p.numpy(), atol=1e-6)


# ---- sample_le ------------------------------------------------------------

@pytest.mark.parametrize("kinds", [("area",), ("point",), ("distant",),
                                   ("area", "point", "distant")])
@pytest.mark.parametrize("strategy", ["uniform", "power"])
def test_sample_le_matches_jax(kinds, strategy):
    prims = _prims()
    jlights = [lt for lt, k in zip(_lights(), ("point", "distant"))
               if k in kinds]
    jall = [lt for lt in jpath.scene_lights_with_area(
        jlights, prims if "area" in kinds else []) if not lt.is_infinite]
    tprims = [convert.object_from(plain(p), "cpu") for p in prims]
    tlights = [convert.object_from(_plain_light(lt), "cpu") for lt in jlights]
    tall = [lt for lt in tpath.scene_lights_with_area(
        tlights, tprims if "area" in kinds else []) if not lt.is_infinite]
    assert [type(x).__name__ for x in tall] == [type(x).__name__
                                                for x in jall]
    # the reference's selection pmf (light_path.py l. 128-132)
    if strategy == "power":
        pw = np.asarray([jl.light_power(lt) for lt in jall])
        pmfs = pw / pw.sum()
    else:
        pmfs = np.full((len(jall),), 1.0 / len(jall))
    np.testing.assert_allclose(tlp._light_pmfs(tall, strategy), pmfs,
                               rtol=1e-6)
    u = np.random.default_rng(7).random((5, N)).astype(np.float32)
    lam = _lam(N)
    got = tlp.sample_le(tall, pmfs, torch.as_tensor(u[0]),
                        torch.as_tensor(u[1:3].T.copy()),
                        torch.as_tensor(u[3:5].T.copy()),
                        torch.as_tensor(lam))
    want = jlp.sample_le(jall, pmfs, jnp.asarray(u[0]),
                         jnp.asarray(u[1:3].T), jnp.asarray(u[3:5].T),
                         jnp.asarray(lam))
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == bool:
            assert (g.numpy() == w).all()
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)
    assert got[5].all() and (got[3] > 0).any()


# ---- trace_light_paths ----------------------------------------------------

@pytest.mark.parametrize("lights,strategy,min_valid", [
    ((), "uniform", N // 4), ((0,), "power", N // 4),
    ((0, 1), "uniform", N // 8)])
def test_trace_light_paths_matches_jax(lights, strategy, min_valid):
    prims = _prims()
    jlights = [_lights()[i] for i in lights]
    tprims = tuple(convert.object_from(plain(p), "cpu") for p in prims)
    tlights = [convert.object_from(_plain_light(lt), "cpu") for lt in jlights]
    jrng, trng = _streams(N)
    lam = _lam(N)
    jcamera = _camera(16, 12)
    tcamera = tcam.PerspectiveCamera(
        tvm.Transform.from_numpy(np.asarray(jcamera.c2w.m),
                                 np.asarray(jcamera.c2w.m_inv), "cpu"),
        55.0, 16, 12)
    kw = dict(max_depth=4, light_strategy=strategy)
    tpix, tval, trng_out = tlp.trace_light_paths(
        tprims, tlights, tcamera, N, torch.as_tensor(lam), trng, **kw)
    jpix, jval, jrng_out = jlp.trace_light_paths(
        tuple(prims), jlights, jcamera, N, jnp.asarray(lam), jrng, **kw)
    jpix, jval = np.asarray(jpix), np.asarray(jval)
    assert tpix.shape == jpix.shape == (N * 5, 2)
    same = (tpix.numpy() == jpix).all(-1)
    assert same.mean() >= 0.995, same.mean()
    valid = jpix[:, 0] >= 0
    assert valid.sum() > min_valid
    np.testing.assert_allclose(tval.numpy()[same], jval[same], rtol=1e-4,
                               atol=1e-6)
    assert (np.asarray(jrng_out).astype(np.int64)
            == trng_out.numpy()).mean() >= 0.99


# ---- render_lightpath -----------------------------------------------------

@pytest.mark.parametrize("lights", [(), (0,)])
def test_render_lightpath_matches_jax(lights):
    jscene = _scene(_prims(), [_lights()[i] for i in lights])
    ref, jst = jrender.render_lightpath(jscene)
    img, st = trender.render_lightpath(_port(jscene), device="cpu")
    assert img.shape == ref.shape == (12, 12, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    assert st["n_paths"] == jst["n_paths"] == 2 * 144
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.97, close.mean()


def test_render_lightpath_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trender.render_lightpath(_port(_scene(_prims(), [])))


def test_render_lightpath_matches_path_mean():
    """tests/test_lightpath.py's gate on the port: the splat image's mean
    within 15% of the path tracer's on the floor-and-lamp scene."""
    prims = _prims()[:2]
    img_f, _ = trender.render(_port(_scene(prims, [], spp=64,
                                           integrator="path")),
                              device="cpu")
    img_l, _ = trender.render_lightpath(_port(_scene(prims, [], spp=16)),
                                        device="cpu")
    lum = np.array([0.2126, 0.7152, 0.0722])
    a, b = float((img_f @ lum).mean()), float((img_l @ lum).mean())
    assert a > 0.01 and abs(a - b) / a < 0.15, (a, b)


def test_render_lightpath_paths_per_wave():
    jscene = dataclasses.replace(_scene(_prims(), []), spp=1)
    img, st = trender.render_lightpath(_port(jscene), spp=1,
                                       n_paths_per_wave=64, device="cpu")
    assert st["n_paths"] == 64 and img.shape == (12, 12, 3)


def test_render_lightpath_measured_matches_jax(tmp_path):
    """The floor as a measured BRDF (the .bsdf of measured.synthesize_ggx):
    the light path's camera connection and bounce go through the measured
    dispatch as in the JAX package; its jitted wave against the port, at
    the tolerances of test_render_lightpath_matches_jax."""
    from torch_surface_util import measured_pair

    jb, _ = measured_pair(tmp_path / "ggx.bsdf")
    prims = _prims()
    prims[0] = dataclasses.replace(prims[0],
                                   material=jm.MeasuredMaterial(brdf=jb))
    jscene = _scene(prims, [_lights()[0]])
    ref, _ = jrender.render_lightpath(jscene)
    img, _ = trender.render_lightpath(_port(jscene), device="cpu")
    assert np.isfinite(img).all() and ref.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.97, close.mean()
