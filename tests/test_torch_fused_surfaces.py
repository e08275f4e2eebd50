"""The fused integrator's surface branch (volpath_fused.li with prims,
reference l. 220-1401) against the JAX package's, in wave mode (render())
and in regen mode (render_regen), on small scenes of tests/test_surfaces.py,
tests/test_rough_fused.py and tests/test_volpath.py.

Tolerances: frame means to 1e-3 relative and at least 99% of pixels to rtol
1e-3 / atol 1e-5, as the medium slice's tests (tests/test_torch_slice.py):
the two sides draw from the same (pixel, sample) PCG streams, and one
flipped choice reroutes a sample.  The glass + rough metal + fog scene of
tests/test_rough_fused.py reroutes more: under render()'s jit XLA fuses the
set-up of the JAX li and changes about 2% of its lanes against the same li
run outside jit, by ulps that flip a branch.  That scene is held instead to
the JAX functions run under jax.disable_jit (the reference's own ops,
unfused), where the port agrees with it pixel for pixel (means to 1e-5,
every pixel to rtol 1e-4 / atol 1e-6).  The point-light furnace of
tests/test_surfaces.py is compared statistically, as its own gate is: its
camera and light sit on a corner of the empty medium's unit cube, where a
shadow segment's medium test flips on an ulp and draws once more from the
stream, so the rest of that path differs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import lights as jl
from acceleratedvolrenderer_tpu.models import materials as jm
from acceleratedvolrenderer_tpu.models import shapes as js
from acceleratedvolrenderer_tpu.models.cameras import PerspectiveCamera
from acceleratedvolrenderer_tpu.models.film import BoxFilter
from acceleratedvolrenderer_tpu.models.media import homogeneous_box
from acceleratedvolrenderer_tpu.parallel import render as jrender
from acceleratedvolrenderer_tpu.scene import Scene as JScene
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu.utils import vecmath as jvm
from acceleratedvolrenderer_tpu_torch.models import materials as tm
from acceleratedvolrenderer_tpu_torch.models import shapes as ts
from acceleratedvolrenderer_tpu_torch.models import textures as tt
from acceleratedvolrenderer_tpu_torch.models.integrators import (
    volpath_fused as tvol)
from acceleratedvolrenderer_tpu_torch.parallel import render as trender
from acceleratedvolrenderer_tpu_torch.scene import convert

from test_rough_fused import glass_metal_fog
from torch_surface_util import surface_arrays_from_jax_scene

torch.set_num_threads(2)

flat = jsp.constant_spectrum


def _diffuse(c=0.5):
    return jm.DiffuseMaterial(reflectance=flat(c))


def assert_frames_close(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert img.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()


def cam(res, eye=(0, 0, 0), look=(0, 0, 1), fov=50.0):
    return PerspectiveCamera(c2w=jvm.look_at(eye, look, (0, 1, 0)),
                             fov_deg=fov, width=res, height=res)


def _dt_slab(sunx=1.0):
    """tests/test_rough_fused.py's translucent slab (diffuse transmission)."""
    sun = np.array([sunx, -0.25, 0.15])
    slab = js.Quad(origin=np.array([0.0, -4.0, -4.0]),
                   e1=np.array([0.0, 8.0, 0.0]), e2=np.array([0.0, 0.0, 8.0]),
                   material=jm.DiffuseTransmissionMaterial(
                       reflectance=flat(0.2), transmittance=flat(0.5)))
    return JScene(
        camera=cam(10, eye=(-1.5, 0.3, 0.0), look=(0.0, 0.3, 0.0)),
        medium=None,
        lights=[jl.DistantLight(direction=sun / np.linalg.norm(sun),
                                spectrum=flat(3.0), scene_radius=20.0)],
        primitives=[slab], max_depth=4, filter=BoxFilter(), spp=4,
        scene_radius=20.0)


def _fog_floor():
    """tests/test_surfaces.py's foggy box over a lit floor."""
    floor = js.Quad(origin=np.array([-10.0, 0.0, -10.0]),
                    e1=np.array([20.0, 0.0, 0.0]),
                    e2=np.array([0.0, 0.0, 20.0]), material=_diffuse(0.4))
    med = homogeneous_box(flat(0.1), flat(0.4), lo=(-2, 0, -2), hi=(2, 2, 2))
    return JScene(
        camera=cam(8, eye=(0, 1.0, -4), look=(0, 0.8, 0)), medium=med,
        lights=[jl.DistantLight(direction=np.array([0.2, -1.0, 0.1]),
                                spectrum=flat(3.0), scene_radius=50.0)],
        primitives=[floor], max_depth=8, filter=BoxFilter(), spp=8,
        scene_radius=50.0)


def _two_lights(strategy):
    """tests/test_volpath.py:206's fog box lit by a sun and a point light,
    under a light sampler (no surface: the fused NEE's strategies)."""
    med = homogeneous_box(flat(0.05), flat(0.6), lo=(0, 0, 0), hi=(1, 1, 1),
                          g=0.2)
    return JScene(
        camera=PerspectiveCamera(
            c2w=jvm.look_at((0.5, 0.5, -2.2), (0.5, 0.5, 0.5), (0, 1, 0)),
            fov_deg=32.0, width=10, height=10),
        medium=med,
        lights=[jl.DistantLight(direction=np.array([0.1, -1.0, 0.2]),
                                spectrum=flat(4.0), scene_radius=10.0),
                jl.PointLight(position=np.array([0.5, 1.6, 0.5]),
                              spectrum=flat(0.8))],
        max_depth=4, filter=BoxFilter(), spp=4, scene_radius=10.0,
        light_sampler=strategy)


WAVE_SCENES = {
    "dt_slab_sun_behind": lambda: _dt_slab(1.0),
    "dt_slab_sun_front": lambda: _dt_slab(-1.0),
    "fog_floor": _fog_floor,
    "two_lights_power": lambda: _two_lights("power"),
    "two_lights_bvh": lambda: _two_lights("bvh"),
}


@pytest.mark.parametrize("name", sorted(WAVE_SCENES))
def test_fused_wave_matches_jax(name):
    """render() (the fused li in wave mode, or volpath over an empty medium
    where the scene has none) on scenes of tests/test_surfaces.py,
    test_rough_fused.py and test_volpath.py."""
    jscene = WAVE_SCENES[name]()
    ref, _ = jrender.render(jscene)
    tscene = convert.scene_from_arrays(surface_arrays_from_jax_scene(jscene),
                                       "cpu")
    img, st = trender.render(tscene, device="cpu")
    assert_frames_close(img, ref)
    assert st["iterations"] > 0


@pytest.mark.parametrize("mode", ["wave", "regen"])
def test_fused_matches_unfused_jax(mode):
    """The glass + rough metal + fog scene of tests/test_rough_fused.py (a
    smooth dielectric, a rough conductor, a diffuse floor inside a
    homogeneous medium under sun and sky), 6x6, spp 2, max_depth 3, by
    render() and by render_regen, against the JAX package's render() and
    render_regen run under jax.disable_jit (see the module docstring)."""
    import jax

    jscene = dataclasses.replace(glass_metal_fog(res=6, spp=2), max_depth=3)
    knobs = dict(n_lanes=64, k_substeps=8, accum_spp=True, retire_groups=2)
    tscene = convert.scene_from_arrays(surface_arrays_from_jax_scene(jscene),
                                       "cpu")
    with jax.disable_jit():
        ref, _ = (jrender.render(jscene) if mode == "wave"
                  else jrender.render_regen(jscene, **knobs))
    img, _ = (trender.render(tscene, device="cpu") if mode == "wave"
              else trender.render_regen(tscene, device="cpu", **knobs))
    assert img.shape == ref.shape and img.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-5
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-6)


def test_point_light_furnace_statistical():
    """tests/test_surfaces.py::test_point_light_furnace through the port's
    empty-medium volpath at the reference's gate (|mean - 1| < 0.04; the
    frame is compared statistically, see the module docstring), and the
    JAX frame's mean to 3%."""
    R = 10.0
    jscene = JScene(
        camera=cam(8), medium=None,
        lights=[jl.PointLight(position=np.zeros(3),
                              spectrum=flat(np.pi * R * R))],
        primitives=[js.Sphere(center=np.zeros(3), radius=R,
                              material=_diffuse())],
        max_depth=40, filter=BoxFilter(), spp=32, scene_radius=30.0)
    ref, _ = jrender.render(jscene)
    tscene = convert.scene_from_arrays(surface_arrays_from_jax_scene(jscene),
                                       "cpu")
    img, _ = trender.render(tscene, device="cpu")
    lum = lambda a: (a @ np.array([0.2126, 0.7152, 0.0722])).mean()
    assert abs(lum(img) - 1.0) < 0.04, lum(img)
    assert abs(lum(img) - lum(ref)) < 0.03, (lum(img), lum(ref))


def test_texture_roughness_counts_as_0_3():
    """The fused surface branch takes a texture roughness as alpha 0.3 (the
    reference's _rough_of, volpath_fused.py l. 251-253), kept as it is."""
    mat = tm.ConductorMaterial(eta=0.2, k=3.0,
                               roughness=tt.ConstantTexture(0.05))
    tables = tvol._SurfaceTables(
        [ts.Sphere(center=np.zeros(3), radius=1.0, material=mat)],
        torch.full((4, 4), 550.0), 4, True)
    assert tables.has_rough and not tables.has_spec
    assert tables.alpha.tolist() == [pytest.approx(0.3)]
