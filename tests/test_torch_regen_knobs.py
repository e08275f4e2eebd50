"""The port's residual shadow tracking and the regen loop's knobs against
the JAX package's, on tests/test_regen.py's 32x24 cloud (spp 3, 48^3 grid,
max_depth 8): residual_shadow on the fused route (256 lanes) and the window
route (200 lanes), event_groups, retire_every, per-sample retire (accum_spp
off), sub_rounds, count_events, record_alive with fixed_steps and the
retire's max_component clamp.  Also the gradients' light strategy: both
gradient paths sample lights uniformly, as the reference's do, whatever
the scene's light_sampler.

Tolerances: frames as test_torch_slice.py's (means to 1e-3 relative, >= 99%
of pixels to rtol 1e-3 / atol 1e-5); event counts exactly; renders of the
port that share every per-sample stream bitwise (event_groups) or to
tests/test_regen.py's 2e-5 of the frame's maximum (the film's add order);
losses and gradients as test_torch_diff.py's (1e-3; relative L2 1e-2 and
>= 99% of voxels within rtol 1e-3 / atol 1e-6 * max|g|)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models.integrators import volpath_fused as jvol
from acceleratedvolrenderer_tpu.ops import dda as jdda
from acceleratedvolrenderer_tpu.parallel import diff as jdiff
from acceleratedvolrenderer_tpu.parallel import render as jrender
from acceleratedvolrenderer_tpu.scene import presets as jpresets
from acceleratedvolrenderer_tpu_torch.models.integrators import (
    volpath_fused as tvol)
from acceleratedvolrenderer_tpu_torch.ops import dda as tdda
from acceleratedvolrenderer_tpu_torch.ops import march
from acceleratedvolrenderer_tpu_torch.parallel import diff as tdiff
from acceleratedvolrenderer_tpu_torch.parallel import render as trender
from acceleratedvolrenderer_tpu_torch.scene import convert

from test_diff import small_scene
from torch_port_util import arrays_from_jax_scene

torch.set_num_threads(2)


def assert_frames_close(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert img.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()


@pytest.fixture(scope="module")
def scenes():
    js = jpresets.cloud(width=32, height=24, spp=3, max_depth=8, grid_res=48)
    js.max_march_steps = 3000
    return js, convert.scene_from_arrays(arrays_from_jax_scene(js), "cpu")


@pytest.fixture(scope="module")
def port_plain(scenes):
    """The port's per-sample regen frame at 512 lanes, every knob off."""
    return trender.render_regen(scenes[1], device="cpu", n_lanes=512)[0]


@pytest.mark.parametrize("n_lanes", [256, 200])
def test_residual_shadow_matches_jax(scenes, n_lanes):
    """residual_shadow through the fused route (256 lanes) and the window
    route (200 lanes: march_window's two gathers)."""
    js, ts = scenes
    kw = dict(n_lanes=n_lanes, residual_shadow=True)
    ref, _ = jrender.render_regen(js, **kw)
    assert march.available(16 ** 3, n_lanes) == (n_lanes == 256)
    img, _ = trender.render_regen(ts, device="cpu", **kw)
    assert_frames_close(img, ref)
    plain, _ = trender.render_regen(ts, device="cpu", n_lanes=n_lanes)
    assert not np.array_equal(img, plain)      # the residual tracker ran


@pytest.mark.parametrize("knob", [
    dict(accum_spp=True, retire_groups=4, event_groups=2,
         work_stride="auto"),
    dict(retire_every=2),
    dict(accum_spp=False),
    dict(sub_rounds=2, retire_groups=2)])
def test_knob_matches_jax(scenes, port_plain, knob):
    js, ts = scenes
    ref, _ = jrender.render_regen(js, n_lanes=512, **knob)
    img, _ = trender.render_regen(ts, device="cpu", n_lanes=512, **knob)
    assert_frames_close(img, ref)
    # every knob keeps each (pixel, sample) estimate
    err = np.max(np.abs(img - port_plain)) / float(np.abs(port_plain).max())
    assert err < 2e-5, err


def test_event_groups_bitwise(scenes):
    """event_groups=2 equals event_groups=1 bitwise: a lane's streams
    advance only at its own events (tests/test_regen.py:67's claim)."""
    kw = dict(n_lanes=512, accum_spp=True, retire_groups=4,
              work_stride="auto")
    a, sa = trender.render_regen(scenes[1], device="cpu", **kw)
    b, sb = trender.render_regen(scenes[1], device="cpu", event_groups=2,
                                 **kw)
    assert np.array_equal(a, b)
    assert sb["iterations"] > sa["iterations"]


def test_count_events_matches_jax(scenes):
    js, ts = scenes
    run, dens, maj = jrender.make_regen_renderer(js, n_lanes=512,
                                                 count_events=True)
    film, ev = run(dens, maj, jnp.zeros(3 * (32 * 24 + 1)))
    img, st = trender.render_regen(ts, device="cpu", n_lanes=512,
                                   count_events=True)
    assert st["ev_counts"] == np.asarray(ev).tolist()
    assert min(st["ev_counts"]) > 0
    assert_frames_close(img, trender.film_to_image(
        torch.as_tensor(np.array(film)), 24, 32, 3))


def test_max_component_clamp_matches_jax(scenes):
    js, ts = scenes
    js.max_component = ts.max_component = 0.05
    try:
        ref, _ = jrender.render_regen(js, n_lanes=512)
        img, _ = trender.render_regen(ts, device="cpu", n_lanes=512)
    finally:
        del js.max_component, ts.max_component
    assert_frames_close(img, ref)
    unclamped, _ = trender.render_regen(ts, device="cpu", n_lanes=512)
    assert img.max() < unclamped.max()


def test_record_alive_ignores_fixed_steps():
    """record_alive with fixed_steps runs the open loop, as the reference's
    does: the same radiance and iterations as without fixed_steps, and the
    JAX package's radiance."""
    js = small_scene()
    ts = convert.scene_from_arrays(arrays_from_jax_scene(js), "cpu")
    n = 256
    o = np.tile([[0.5, 0.5, -2.0]], (n, 1)).astype(np.float32)
    d = np.tile([[0.0, 0.0, 1.0]], (n, 1)).astype(np.float32)
    lam = np.tile(np.linspace(400.0, 700.0, 4, dtype=np.float32)[None],
                  (n, 1))
    dens = np.asarray(js.medium.density, np.float32)
    maj = ts.medium.build_majorant()
    w2m = np.asarray(js.medium.world_to_unit(), np.float32)
    kw = dict(maj_res=(2, 2, 2), homogeneous=False, max_depth=3)
    tmed = tdda.MediumArrays(
        density=torch.as_tensor(dens), majorant=maj,
        w2m=torch.as_tensor(w2m), g=torch.tensor(0.0),
        sigma_a=torch.full((1, 4), 0.5), sigma_s=torch.full((1, 4), 1.0),
        Le=torch.zeros((1, 4)))
    rng = tdda.seed_stream(torch.arange(n), torch.zeros(n, dtype=torch.int64))
    args = (tmed, ts.lights, torch.as_tensor(o), torch.as_tensor(d),
            torch.as_tensor(lam), rng)
    open_loop = tvol.li(*args, record_alive=True, **kw)
    fixed = tvol.li(*args, record_alive=True, fixed_steps=5, **kw)
    assert fixed.iterations == open_loop.iterations > 5
    assert torch.equal(fixed.L, open_loop.L)
    assert torch.equal(fixed.alive_hist, open_loop.alive_hist)
    jmed = jdda.MediumArrays(
        density=jnp.asarray(dens), majorant=jnp.asarray(maj.numpy()),
        w2m=jnp.asarray(w2m), g=jnp.float32(0.0),
        sigma_a=jnp.full((1, 4), 0.5), sigma_s=jnp.full((1, 4), 1.0),
        Le=jnp.zeros((1, 4)))
    jrng = jdda.seed_stream(jnp.arange(n), jnp.zeros(n, jnp.int32))
    ref = jvol.li(jmed, js.lights, jnp.asarray(o), jnp.asarray(d),
                  jnp.asarray(lam), jrng, scene_radius=10.0,
                  record_alive=True, fixed_steps=5, **kw)
    got, want = fixed.L.numpy(), np.asarray(ref.L)
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())
    assert np.isclose(got, want, rtol=1e-3, atol=1e-5).all(-1).mean() >= 0.99


def _assert_grads_close(got, ref):
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.linalg.norm(got - ref) <= 1e-2 * np.linalg.norm(ref)
    close = np.isclose(got, ref, rtol=1e-3, atol=1e-6 * np.abs(ref).max())
    assert close.mean() >= 0.99, close.mean()


@pytest.fixture(scope="module")
def power_scenes():
    """tests/test_diff.py's 6x6 scene with the "power" light sampler, which
    the port's light sampling does not have: the gradients must not ask
    for it."""
    js = small_scene()
    js.light_sampler = "power"
    ts = convert.scene_from_arrays(arrays_from_jax_scene(js), "cpu")
    ts.light_sampler = "power"
    return js, ts, np.asarray(js.medium.density, np.float32)


def test_diff_regen_light_strategy_matches_jax(power_scenes):
    js, ts, dens = power_scenes
    kw = dict(fixed_steps=48, spp=2, n_lanes=72)
    jloss, jgrad = jdiff.make_diff_regen_renderer(js, **kw)
    tloss, tgrad = tdiff.make_diff_regen_renderer(ts, device="cpu", **kw)
    d = torch.as_tensor(dens)
    ref = float(jloss(jnp.asarray(dens)))
    assert ref > 0
    np.testing.assert_allclose(float(tloss(d)), ref, rtol=1e-3)
    _assert_grads_close(tgrad(d).numpy(), np.asarray(jgrad(jnp.asarray(
        dens))))


def test_diff_multi_light_strategy_matches_jax(power_scenes):
    js, ts, dens = power_scenes
    kw = dict(fixed_steps=48, spp=1)
    jloss, jgrad = jdiff.make_diff_renderer_multi(js, **kw)
    tloss, tgrad = tdiff.make_diff_renderer_multi(ts, device="cpu", **kw)
    ref = float(jloss({"density": jnp.asarray(dens)}))
    assert ref > 0
    np.testing.assert_allclose(float(tloss({"density": dens})), ref,
                               rtol=1e-3)
    _assert_grads_close(tgrad({"density": dens})["density"].numpy(),
                        np.asarray(jgrad({"density": jnp.asarray(dens)})[
                            "density"]))
