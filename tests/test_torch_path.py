"""The port's surface path integrators (models/integrators/path.py: li_path
with NEE and MIS, SimplePath's light-sampling mode, li_random_walk, li_ao)
against the JAX package's, on the same rays, wavelengths and PCG streams
made from a numpy seed, and the wave renderer's surface branches
(parallel/render.py: integrator path / simplepath / randomwalk / ao).

The integrators are called outside jit on both sides (the reference's own
ops, unfused), so every lane draws the same numbers: radiance to rtol 1e-4 /
atol 1e-6 on at least 99% of the lanes (a grazing hit or a lobe choice
u < F may flip on an ulp and reroute a lane), and the returned streams
equal on the same share.  The render() frames run the JAX package's jitted
render(): means to 1e-3 relative and at least 99% of pixels to rtol 1e-3 /
atol 1e-5, as the medium slice's frames.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import lights as jl
from acceleratedvolrenderer_tpu.models import materials as jm
from acceleratedvolrenderer_tpu.models import shapes as js
from acceleratedvolrenderer_tpu.models import textures as jt
from acceleratedvolrenderer_tpu.models.cameras import PerspectiveCamera
from acceleratedvolrenderer_tpu.models.film import BoxFilter
from acceleratedvolrenderer_tpu.models.integrators import path as jpath
from acceleratedvolrenderer_tpu.ops import dda as jdda
from acceleratedvolrenderer_tpu.parallel import render as jrender
from acceleratedvolrenderer_tpu.scene import Scene as JScene
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu.utils import vecmath as jvm
from acceleratedvolrenderer_tpu_torch.models.integrators import path as tpath
from acceleratedvolrenderer_tpu_torch.ops import dda as tdda
from acceleratedvolrenderer_tpu_torch.parallel import render as trender
from acceleratedvolrenderer_tpu_torch.scene import convert

from torch_surface_util import (_plain_light, plain,
                                surface_arrays_from_jax_scene)

torch.set_num_threads(2)

flat = jsp.constant_spectrum
N = 512


def _quad(o, e1, e2, m):
    return js.Quad(origin=np.array(o, float), e1=np.array(e1, float),
                   e2=np.array(e2, float), material=m)


def _prims():
    """A room of every material kind the path integrator samples."""
    diffuse = lambda c: jm.DiffuseMaterial(reflectance=flat(c))
    return [
        _quad([-3, -1, -3], [6, 0, 0], [0, 0, 6], diffuse(0.6)),
        _quad([-3, -1, 3], [0, 4, 0], [6, 0, 0],
              jm.DiffuseMaterial(reflectance=jt.CheckerboardTexture(
                  jt.ConstantRGBTexture((0.8, 0.2, 0.1)),
                  jt.ConstantRGBTexture((0.5, 0.5, 0.5)), 4.0, 4.0))),
        _quad([-0.5, 2.5, 0.5], [1, 0, 0], [0, 0, 1],
              jm.DiffuseMaterial(reflectance=flat(0.0),
                                 emission=flat(6.0))),
        js.Sphere(center=np.array([-1.5, 0.0, 1.0]), radius=0.6,
                  material=jm.ConductorMaterial(eta=0.2, k=3.0,
                                                roughness=0.3)),
        js.Sphere(center=np.array([-0.2, -0.3, 1.5]), radius=0.5,
                  material=jm.ConductorMaterial(eta=0.3, k=2.0)),
        js.Sphere(center=np.array([1.2, 0.0, 1.2]), radius=0.6,
                  material=jm.DielectricMaterial(eta=1.5, roughness=0.2)),
        js.Sphere(center=np.array([0.5, 1.0, 2.2]), radius=0.4,
                  material=jm.DielectricMaterial(eta=1.4)),
        _quad([1.8, -1, 0], [0, 3, 0], [0, 0, 2],
              jm.ThinDielectricMaterial(eta=1.5)),
        _quad([-2.6, -1, -1], [0, 0, 2], [0, 2.5, 0],
              jm.DiffuseTransmissionMaterial(reflectance=flat(0.3),
                                             transmittance=flat(0.5))),
        js.Sphere(center=np.array([0.8, -0.5, 0.3]), radius=0.4,
                  material=jm.CoatedDiffuseMaterial(
                      reflectance=flat(0.6), eta=1.5, roughness=0.1)),
        js.Sphere(center=np.array([-0.8, 1.0, 0.6]), radius=0.35,
                  material=jm.CoatedDiffuseMaterial(
                      reflectance=flat(0.5), eta=1.5, roughness=0.05,
                      thickness=0.05, g=0.2, albedo_med=flat(0.8),
                      stochastic=True)),
        js.Sphere(center=np.array([0.0, 0.6, -0.6]), radius=0.3,
                  material=jm.MixMaterial(
                      diffuse(0.9), jm.ConductorMaterial(eta=0.2, k=3.0,
                                                         roughness=0.4),
                      0.4)),
    ]


def _lights():
    return [
        jl.DistantLight(direction=np.array([0.2, -1.0, 0.3]) / 1.063,
                        spectrum=flat(1.5), scene_radius=20.0),
        jl.PointLight(position=np.array([0.0, 2.0, 0.0]), spectrum=flat(2.0)),
        jl.SpotLight(position=np.array([1.0, 2.0, -1.0]),
                     direction=np.array([-0.3, -1.0, 0.5]),
                     spectrum=flat(4.0), cone_angle_deg=40.0),
        jl.UniformInfiniteLight(spectrum=flat(0.3), scene_radius=20.0),
    ]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(17)
    o = np.tile(np.array([[0.0, 0.5, -2.5]], np.float32), (N, 1))
    aim = rng.uniform([-2, -1, 0], [2, 2, 3], (N, 3))
    d = aim - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    lam = rng.uniform(380, 720, (N, 4)).astype(np.float32)
    prims = _prims()
    lights = _lights()
    idx = np.arange(N)
    return dict(
        j=(tuple(prims), lights, jnp.asarray(o), jnp.asarray(d),
           jnp.asarray(lam),
           jdda.seed_stream(jnp.asarray(idx), jnp.zeros(N, jnp.int32))),
        t=(tuple(convert.object_from(plain(p), "cpu") for p in prims),
           [convert.object_from(_plain_light(lt), "cpu") for lt in lights],
           torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(lam),
           tdda.seed_stream(torch.as_tensor(idx),
                            torch.zeros(N, dtype=torch.int64))))


def _compare(got, want, lit=0.3):
    """Radiance and the returned streams lane for lane; at least `lit` of
    the lanes carry light."""
    (tL, trng), (jL, jrng) = got, want
    jL = np.asarray(jL)
    ok = np.isclose(tL.numpy(), jL, rtol=1e-4, atol=1e-6).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    assert (np.asarray(jrng).astype(np.int64) == trng.numpy()).mean() >= 0.99
    assert (jL > 0).any(-1).mean() > lit


@pytest.mark.parametrize("case", [
    dict(light_strategy="uniform"),
    dict(light_strategy="power", regularize=True),
    dict(light_strategy="bvh"),
    dict(nee=True, mis=False),
    dict(nee=False),
])
def test_li_path_matches_jax(setup, case):
    """li_path over every material kind (textures, coated analytic and
    stochastic, mix) with point, spot, distant, infinite and area lights:
    PathIntegrator by each light sampler (and BSDF::Regularize),
    SimplePath's light-sampling mode and BSDF sampling alone."""
    kw = dict(max_depth=3, **case)
    _compare(tpath.li_path(*setup["t"], **kw),
             jpath.li_path(*setup["j"], **kw))


def test_li_random_walk_and_ao_match_jax(setup):
    _compare(tpath.li_random_walk(*setup["t"], max_depth=3),
             jpath.li_random_walk(*setup["j"], max_depth=3), lit=0.1)
    _compare(tpath.li_ao(*setup["t"]), jpath.li_ao(*setup["j"]))
    _compare(tpath.li_ao(*setup["t"], cos_sample=False, max_distance=2.0),
             jpath.li_ao(*setup["j"], cos_sample=False, max_distance=2.0))


def test_scene_lights_with_area(setup):
    got = tpath.scene_lights_with_area(setup["t"][1], setup["t"][0])
    want = jpath.scene_lights_with_area(setup["j"][1], setup["j"][0])
    assert [type(x).__name__ for x in got] == [type(x).__name__
                                               for x in want]
    assert got[-1].shape is setup["t"][0][2]


def assert_frames_close(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert img.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()


def _room(integrator, res=10, spp=2):
    """tests/test_path.py's lamp over a floor, with a glass sphere."""
    floor = _quad([-5, 0, -5], [10, 0, 0], [0, 0, 10],
                  jm.DiffuseMaterial(reflectance=flat(0.5)))
    lamp = _quad([-1, 3, 1], [2, 0, 0], [0, 0, 2],
                 jm.DiffuseMaterial(reflectance=flat(0.0),
                                    emission=flat(5.0)))
    ball = js.Sphere(center=np.array([0.5, 0.6, 2.0]), radius=0.6,
                     material=jm.DielectricMaterial(eta=1.5))
    cam = PerspectiveCamera(c2w=jvm.look_at((0, 1.5, -4), (0, 0.5, 2),
                                            (0, 1, 0)),
                            fov_deg=50.0, width=res, height=res)
    return JScene(camera=cam, medium=None,
                  lights=[jl.UniformInfiniteLight(spectrum=flat(0.2),
                                                  scene_radius=50.0)],
                  primitives=[floor, lamp, ball], max_depth=4,
                  filter=BoxFilter(), spp=spp, scene_radius=50.0,
                  integrator=integrator, light_sampler="bvh")


@pytest.mark.parametrize("integrator", ["path", "simplepath", "randomwalk",
                                        "ao"])
def test_render_path_integrators_match_jax(integrator):
    jscene = _room(integrator)
    ref, _ = jrender.render(jscene)
    tscene = convert.scene_from_arrays(surface_arrays_from_jax_scene(jscene),
                                       "cpu")
    img, st = trender.render(tscene, device="cpu")
    assert_frames_close(img, ref)
    assert st["iterations"] == 0          # no fused loop on these branches


def test_render_environment_only_matches_jax():
    """A scene with neither a medium nor a surface: the infinite lights'
    radiance, as the reference's escaped_radiance branch."""
    jscene = dataclasses.replace(_room("path"), primitives=[])
    ref, _ = jrender.render(jscene)
    tscene = convert.scene_from_arrays(surface_arrays_from_jax_scene(jscene),
                                       "cpu")
    img, _ = trender.render(tscene, device="cpu")
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)
    assert img.mean() > 0
