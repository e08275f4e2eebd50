"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run every pl.pallas_call of the JAX package in interpret mode, so a
    TPU kernel itself runs on the CPU."""
    from jax.experimental import pallas

    jax.clear_caches()
    monkeypatch.setattr(pallas, "pallas_call",
                        functools.partial(pallas.pallas_call, interpret=True))
    yield
    jax.clear_caches()


def _emission(spec):
    """The plain form of a JAX emission spectrum: ("blackbody", T) for a
    normalized blackbody, else the constant spectrum's value."""
    if spec.__qualname__.startswith("blackbody_normalized."):
        return ("blackbody", inspect.getclosurevars(spec).nonlocals["T"])
    return float(np.asarray(spec(jnp.full((1,), 550.0)))[0])


def arrays_from_jax_scene(js):
    """The plain arrays and floats that scene_from_arrays takes, read off a
    JAX scene with a homogeneous, grid or RGB grid medium of constant
    spectra (emission: constant or a normalized blackbody), at most one
    distant and one uniform infinite light, and any look_at camera.  Each
    constant spectrum is evaluated at one wavelength."""
    from acceleratedvolrenderer_tpu.models import lights as jl

    lam = jnp.full((1,), 550.0)
    med = js.medium
    one = lambda spec: float(np.asarray(spec(lam))[0])
    grid = lambda a: None if a is None else np.asarray(a, np.float32)
    sun = [lt for lt in js.lights if isinstance(lt, jl.DistantLight)]
    sky = [lt for lt in js.lights
           if isinstance(lt, jl.UniformInfiniteLight)]
    assert len(sun) + len(sky) == len(js.lights) and len(sun) <= 1 >= len(sky)
    filt = js.filter
    return dict(
        density=grid(med.density),
        sigma_a_rgb=grid(med.sigma_a_rgb), sigma_s_rgb=grid(med.sigma_s_rgb),
        Le_rgb=grid(med.Le_rgb),
        majorant=np.asarray(med.build_majorant(), np.float32),
        w2m=med.world_to_unit(),
        c2w=np.asarray(js.camera.c2w.m, np.float64),
        fov_deg=js.camera.fov_deg, width=js.width, height=js.height,
        sun_dir=(np.asarray(sun[0].direction) if sun
                 else np.zeros(3, np.float32)),
        sun_L=one(sun[0].spectrum) * sun[0].scale if sun else None,
        sky_L=one(sky[0].spectrum) * sky[0].scale if sky else None,
        sigma_a=one(med.sigma_a_spec), sigma_s=one(med.sigma_s_spec),
        scale=med.scale, g=med.g, spp=js.spp, max_depth=js.max_depth,
        seed=js.seed, max_march_steps=js.max_march_steps,
        scene_radius=js.scene_radius, sampler=js.sampler,
        Le=_emission(med.Le_spec) if med.Le_spec is not None else None,
        Le_scale=med.Le_scale,
        filter=(type(filt).__name__.replace("Filter", "").lower(), *filt),
        disable_pixel_jitter=js.disable_pixel_jitter,
        disable_wavelength_jitter=js.disable_wavelength_jitter,
        pixel_bounds=js.pixel_bounds)
