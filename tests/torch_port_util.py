"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""
import functools

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


def arrays_from_jax_scene(js):
    """The plain arrays and floats that scene_from_arrays takes, read off a
    JAX cloud scene.  Its spectra are constant, so each is evaluated at one
    wavelength."""
    lam = jnp.full((1,), 550.0)
    med = js.medium
    sun, sky = js.lights
    one = lambda spec: float(np.asarray(spec(lam))[0])
    return dict(
        density=np.asarray(med.density, np.float32),
        majorant=np.asarray(med.build_majorant(), np.float32),
        w2m=med.world_to_unit(),
        c2w=np.asarray(js.camera.c2w.m, np.float64),
        fov_deg=js.camera.fov_deg, width=js.width, height=js.height,
        sun_dir=np.asarray(sun.direction), sun_L=one(sun.spectrum) * sun.scale,
        sky_L=one(sky.spectrum) * sky.scale,
        sigma_a=one(med.sigma_a_spec), sigma_s=one(med.sigma_s_spec),
        scale=med.scale, g=med.g, spp=js.spp, max_depth=js.max_depth,
        seed=js.seed, max_march_steps=js.max_march_steps,
        scene_radius=js.scene_radius)
