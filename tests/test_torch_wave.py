"""The port's wave renderer (parallel/render.py::render, make_wave_renderer,
volpath_fused.li in wave mode, models/film.py::Film) against the JAX
package's, on the 32x24 test cloud (spp 4, 32^3 grid, max_depth 8).

At 256 rays per chunk the port takes the fused march route, at 200 the
window route (200 % 128 != 0); the JAX package runs its window route on the
CPU.  Tolerances, as the regen slice's (test_torch_slice.py): frame means
to 1e-3 relative and at least 99% of pixels to rtol 1e-3 / atol 1e-5 (exp,
log1p and erfinv differ by ulps between XLA:CPU and torch, and one flipped
choice reroutes a sample).  Within the port, renders that share every
per-pixel stream are compared bitwise; the fixed-step loop against the
while loop to rtol 1e-5 / atol 1e-6, as tests/test_diff.py compares them;
the film and the filters to float32 rounding (rtol 1e-6)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import film as jfilm
from acceleratedvolrenderer_tpu.models.integrators import volpath_fused as jvol
from acceleratedvolrenderer_tpu.ops import dda as jdda
from acceleratedvolrenderer_tpu.parallel import render as jrender
from acceleratedvolrenderer_tpu.scene import presets as jpresets
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu_torch.models import film as tfilm
from acceleratedvolrenderer_tpu_torch.models.integrators import (
    volpath_fused as tvol)
from acceleratedvolrenderer_tpu_torch.ops import dda as tdda
from acceleratedvolrenderer_tpu_torch.ops import march
from acceleratedvolrenderer_tpu_torch.parallel import render as trender
from acceleratedvolrenderer_tpu_torch.scene import convert
from acceleratedvolrenderer_tpu_torch.scene.types import Scene
from acceleratedvolrenderer_tpu_torch.utils import spectrum as tsp

from test_diff import small_scene
from torch_port_util import arrays_from_jax_scene
from torch_surface_util import surface_arrays_from_jax_scene
from torch_wave_util import wave_frame

torch.set_num_threads(2)

SMALL = dict(width=32, height=24, spp=4, max_depth=8, grid_res=32)


def assert_frames_close(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert img.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()


@pytest.fixture(scope="module")
def jax_scene():
    return jpresets.cloud(**SMALL)


@pytest.fixture(scope="module")
def port_scene(jax_scene):
    return convert.scene_from_arrays(arrays_from_jax_scene(jax_scene), "cpu")


@pytest.fixture(scope="module")
def port_256(port_scene):
    return wave_frame(port_scene, 256, "cpu")


@pytest.mark.parametrize("rays_per_wave", [256, 200])
def test_render_matches_jax(jax_scene, port_scene, port_256, rays_per_wave):
    """render()'s loop at 256 and 200 rays per chunk (make_wave_renderer
    and Film) against the JAX render()."""
    ref, _ = jrender.render(jax_scene)
    img, chunk_its = (port_256 if rays_per_wave == 256 else wave_frame(
        port_scene, rays_per_wave, "cpu"))
    assert_frames_close(img, ref)
    n_chunks = -(-32 * 24 // rays_per_wave)
    assert len(chunk_its) == SMALL["spp"] * n_chunks and min(chunk_its) > 0
    # the route the chunk's lane count takes over the 16^3 majorant
    assert march.available(16 ** 3, rays_per_wave) == (rays_per_wave == 256)


def test_render_default_chunk_equals_smaller_chunks(port_scene, port_256):
    """render() itself (one chunk of the default 262144 rays here) gives
    the 256-ray chunks' frame bitwise: every pixel keys its own streams."""
    img, st = trender.render(port_scene, device="cpu")
    assert np.array_equal(img, port_256[0])
    assert len(st["chunk_iterations"]) == SMALL["spp"]
    assert st["iterations"] == sum(st["chunk_iterations"]) > 0
    assert st["spp"] == SMALL["spp"] and st["rays_per_sec"] > 0


def test_knobs_and_pixel_bounds_match_jax(jax_scene, port_256):
    """pixel_bounds, disable_pixel_jitter and disable_wavelength_jitter
    cross to the port; pixels inside the bounds equal the full frame's when
    only the bounds change (streams are keyed by the flat pixel index)."""
    bounds = (4, 20, 3, 15)
    js = dataclasses.replace(jax_scene, pixel_bounds=bounds,
                             disable_pixel_jitter=True,
                             disable_wavelength_jitter=True)
    ref, _ = jrender.render(js)
    ts = convert.scene_from_arrays(arrays_from_jax_scene(js), "cpu")
    img, _ = wave_frame(ts, 256, "cpu")
    assert_frames_close(img, ref)
    inside = np.zeros(img.shape[:2], bool)
    inside[3:15, 4:20] = True
    assert not img[~inside].any() and (img[inside] > 0).any()

    ts_b = dataclasses.replace(
        convert.scene_from_arrays(arrays_from_jax_scene(jax_scene), "cpu"),
        pixel_bounds=bounds)
    img_b, _ = wave_frame(ts_b, 256, "cpu")
    assert np.array_equal(img_b[inside], port_256[0][inside])


def test_pixel_bounds_clip_and_reject(port_scene):
    with pytest.warns(UserWarning, match="clipped"):
        trender.make_wave_renderer(
            dataclasses.replace(port_scene, pixel_bounds=(-3, 8, 0, 99)),
            device="cpu")
    with pytest.raises(ValueError, match="do not intersect"):
        trender.make_wave_renderer(
            dataclasses.replace(port_scene, pixel_bounds=(40, 50, 0, 4)),
            device="cpu")


@pytest.mark.parametrize("what", ["environment only", "surfaces"])
def test_no_medium_raises(jax_scene, what):
    """A scene without a medium renders (it raised before surfaces were
    ported) and matches the JAX frame: the sky alone (the reference's
    escaped_radiance branch), or a diffuse sphere and a rough metal quad
    under the cloud's sun and sky (volpath over an empty medium) at spp 1.
    The JAX frame of the surfaces runs under jax.disable_jit: under
    render()'s jit XLA fuses the li set-up and flips a few lanes' branches
    on ulps (tests/test_torch_fused_surfaces.py)."""
    import jax

    from acceleratedvolrenderer_tpu.models import materials as jm
    from acceleratedvolrenderer_tpu.models import shapes as js

    prims = [] if what == "environment only" else [
        js.Sphere(center=np.array([0.0, 0.0, 0.0]), radius=60.0,
                  material=jm.DiffuseMaterial(
                      reflectance=jsp.constant_spectrum(0.6))),
        js.Quad(origin=np.array([-150.0, -80.0, -150.0]),
                e1=np.array([0.0, 0.0, 300.0]), e2=np.array([300.0, 0.0, 0.0]),
                material=jm.ConductorMaterial(eta=0.2, k=3.0, roughness=0.3))]
    js_ = dataclasses.replace(jax_scene, medium=None, primitives=prims,
                              max_depth=4, spp=1)
    with jax.disable_jit():
        ref, _ = jrender.render(js_)
    scene = convert.scene_from_arrays(surface_arrays_from_jax_scene(js_),
                                      "cpu")
    img, _ = trender.render(scene, device="cpu")
    assert_frames_close(img, ref)


def _wave_inputs(n=256):
    """tests/test_diff.py::test_fixed_steps_matches_while_loop_forward's
    rays: n parallel rays into the 4^3 scene, 4 fixed wavelengths."""
    o = np.tile([[0.5, 0.5, -2.0]], (n, 1)).astype(np.float32)
    d = np.tile([[0.0, 0.0, 1.0]], (n, 1)).astype(np.float32)
    lam = np.tile(np.linspace(400.0, 700.0, 4, dtype=np.float32)[None],
                  (n, 1))
    return o, d, lam


def test_li_wave_matches_jax_and_fixed_steps():
    """The wave-mode li of the port against the JAX li on the same rays,
    and its fixed-step (checkpointed) loop against its while loop."""
    js = small_scene()
    spec = js.medium
    ts = convert.scene_from_arrays(arrays_from_jax_scene(js), "cpu")
    o, d, lam = _wave_inputs()
    n = o.shape[0]
    dens = np.asarray(spec.density, np.float32)
    maj = np.asarray(ts.medium.build_majorant())
    w2m = np.asarray(spec.world_to_unit(), np.float32)
    jmed = jdda.MediumArrays(
        density=jnp.asarray(dens), majorant=jnp.asarray(maj),
        w2m=jnp.asarray(w2m), g=jnp.float32(0.0),
        sigma_a=jnp.full((1, 4), 0.5), sigma_s=jnp.full((1, 4), 1.0),
        Le=jnp.zeros((1, 4)))
    jrng = jdda.seed_stream(jnp.arange(n), jnp.zeros(n, jnp.int32))
    kw = dict(maj_res=(2, 2, 2), homogeneous=False, max_depth=3)
    ref = jvol.li(jmed, js.lights, jnp.asarray(o), jnp.asarray(d),
                  jnp.asarray(lam), jrng, scene_radius=10.0, **kw)
    tmed = tdda.MediumArrays(
        density=torch.as_tensor(dens), majorant=torch.as_tensor(maj),
        w2m=torch.as_tensor(w2m), g=torch.tensor(0.0),
        sigma_a=torch.full((1, 4), 0.5), sigma_s=torch.full((1, 4), 1.0),
        Le=torch.zeros((1, 4)))
    trng = tdda.seed_stream(torch.arange(n), torch.zeros(n, dtype=torch.int64))
    args = (tmed, ts.lights, torch.as_tensor(o), torch.as_tensor(d),
            torch.as_tensor(lam), trng)
    r_while = tvol.li(*args, **kw)
    r_scan = tvol.li(*args, fixed_steps=96, **kw)
    assert r_while.film_rgb is None and r_while.iterations < 96
    got, want = r_while.L.numpy(), np.asarray(ref.L)
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())
    assert np.isclose(got, want, rtol=1e-3, atol=1e-5).all(-1).mean() >= 0.99
    assert r_scan.iterations == 96
    np.testing.assert_allclose(r_scan.L.numpy(), got, rtol=1e-5, atol=1e-6)


def test_film_add_samples_matches_jax():
    rng = np.random.default_rng(3)
    n, H, W = 500, 5, 7
    pix = np.stack([rng.integers(-2, W + 2, n), rng.integers(-2, H + 2, n)],
                   -1).astype(np.int32)
    L = rng.uniform(0.0, 4.0, (n, 4)).astype(np.float32)
    L[:3, 0] = [np.nan, np.inf, -np.inf]
    lam = rng.uniform(360.0, 830.0, (n, 4)).astype(np.float32)
    pdf = rng.uniform(0.0, 0.01, (n, 4)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    ref = jfilm.Film.create(H, W).add_samples(
        jnp.asarray(pix), jnp.asarray(L),
        jsp.SampledWavelengths(jnp.asarray(lam), jnp.asarray(pdf)),
        weight=jnp.asarray(w), max_component=2.0)
    got = tfilm.Film.create(H, W, "cpu").add_samples(
        torch.as_tensor(pix), torch.as_tensor(L),
        tsp.SampledWavelengths(torch.as_tensor(lam), torch.as_tensor(pdf)),
        weight=torch.as_tensor(w), max_component=2.0)
    for a, b in ((got.rgb_sum, ref.rgb_sum), (got.weight_sum, ref.weight_sum),
                 (got.to_image(), ref.to_image())):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert got.weight_sum.sum() > 0


@pytest.mark.parametrize("name", ["GaussianFilter", "BoxFilter",
                                  "TriangleFilter"])
def test_filter_sample_offset_matches_jax(name):
    u = np.random.default_rng(4).random((300, 2)).astype(np.float32)
    ref = getattr(jfilm, name)().sample_offset(jnp.asarray(u))
    got = getattr(tfilm, name)().sample_offset(torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_scene_defaults_hold_the_wave_knobs():
    sc = Scene(camera=None)
    assert (sc.primitives, sc.pixel_bounds) == ([], None)
    assert not (sc.disable_pixel_jitter or sc.disable_wavelength_jitter)
