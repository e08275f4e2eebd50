"""The port's wave-path gradient (parallel/diff.py: make_diff_renderer_multi,
make_diff_renderer, image_and_density_grad) against the JAX package's, on
tests/test_diff.py's small scene (6x6, a random 4^3 density, a 2^3
majorant: the window route), and the FD gates of tests/test_diff.py run on
the port.

Tolerances:
- loss and every DIFF_PARAMS family's gradient against JAX: loss to rtol
  1e-4; each gradient to relative L2 1e-3 and, elementwise, rtol 1e-3 /
  atol 1e-6 * max|g| (the same float32 formulas; XLA:CPU and torch differ
  by ulps in exp, log1p and erfinv);
- FD == AD as tests/test_diff.py holds the JAX package: density 2e-3,
  sigma_a / sigma_s and Le_grid 5e-3 of the larger magnitude (the detached
  estimator with counter-based streams: central differences of the
  estimator itself).  test_g_gradient_nonzero needs homogeneous media,
  which the port does not have yet."""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.parallel import diff as jdiff
from acceleratedvolrenderer_tpu_torch.parallel import diff as tdiff
from acceleratedvolrenderer_tpu_torch.scene import convert

from test_diff import small_scene
from torch_port_util import arrays_from_jax_scene

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

KW = dict(fixed_steps=96, spp=2)


def port_scene(js):
    return convert.scene_from_arrays(arrays_from_jax_scene(js), "cpu")


@pytest.fixture(scope="module")
def multi():
    """(JAX scene, params as numpy, JAX loss, JAX grads, port loss_fn,
    port grad_fn) of test_multi_param_grads_match_fd's set-up."""
    js = small_scene(sigma_a=0.6, sigma_s=0.9, le=1.5)
    params = {
        "density": np.asarray(js.medium.density, np.float32),
        "sigma_a": np.float32(1.0), "sigma_s": np.float32(1.0),
        "Le_grid": (0.5 + np.random.default_rng(1).random((4, 4, 4)))
        .astype(np.float32)}
    jl, jg = jdiff.make_diff_renderer_multi(js, **KW)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref_loss = float(jl(jp))
    ref_grad = {k: np.asarray(v) for k, v in jg(jp).items()}
    tl, tg = tdiff.make_diff_renderer_multi(port_scene(js), device="cpu",
                                            **KW)
    return js, params, ref_loss, ref_grad, tl, tg


@pytest.fixture(scope="module")
def port_grad(multi):
    return {k: v.numpy() for k, v in multi[5](multi[1]).items()}


def test_multi_loss_matches_jax(multi):
    _, params, ref_loss, _, loss_fn, _ = multi
    with torch.no_grad():
        got = loss_fn(params)
    assert got.shape == () and ref_loss > 0
    np.testing.assert_allclose(float(got), ref_loss, rtol=1e-4)


@pytest.mark.parametrize("key", tdiff.DIFF_PARAMS)
def test_multi_grad_matches_jax(multi, port_grad, key):
    ref, got = multi[3][key], port_grad[key]
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got).max() > 0, f"{key} gradient identically zero"
    assert np.linalg.norm(got - ref) <= 1e-3 * np.linalg.norm(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-3,
                               atol=1e-6 * np.abs(ref).max())


def test_multi_param_grads_match_fd(multi, port_grad):
    """tests/test_diff.py::test_multi_param_grads_match_fd on the port."""
    _, params, _, _, loss_fn, _ = multi

    def fd(key, delta, eps):
        p1 = dict(params, **{key: params[key] + delta})
        p2 = dict(params, **{key: params[key] - delta})
        with torch.no_grad():
            return (float(loss_fn(p1)) - float(loss_fn(p2))) / (2 * eps)

    for key, eps in (("sigma_a", 1e-3), ("sigma_s", 1e-3)):
        f, a = fd(key, np.float32(eps), eps), float(port_grad[key])
        assert abs(f - a) <= 5e-3 * max(abs(f), abs(a), 1e-3), (key, f, a)
    gl = port_grad["Le_grid"]
    fi = int(np.argmax(np.abs(gl)))
    e = np.zeros(gl.size, np.float32)
    e[fi] = 2e-3
    f = fd("Le_grid", e.reshape(gl.shape), 2e-3)
    a = float(gl.reshape(-1)[fi])
    assert abs(f - a) <= 5e-3 * max(abs(f), abs(a), 1e-4), (f, a)


def _density_fd(loss_fn, dens, g, order_picks, eps=2e-3):
    order = np.argsort(np.abs(g).reshape(-1))[::-1]
    for fi in order[list(order_picks)]:
        e = np.zeros(dens.size, np.float32)
        e[fi] = eps
        e = e.reshape(dens.shape)
        with torch.no_grad():
            f = (float(loss_fn(torch.as_tensor(dens + e)))
                 - float(loss_fn(torch.as_tensor(dens - e)))) / (2 * eps)
        a = float(g.reshape(-1)[fi])
        assert abs(f - a) <= 2e-3 * max(abs(f), abs(a), 1e-3), (fi, f, a)


def test_density_grad_matches_fd():
    """tests/test_diff.py::test_density_grad_matches_fd on the port, through
    make_diff_renderer and image_and_density_grad."""
    js = small_scene()
    ts = port_scene(js)
    loss_fn, grad_fn = tdiff.make_diff_renderer(ts, device="cpu", **KW)
    dens = np.asarray(js.medium.density, np.float32)
    g = grad_fn(torch.as_tensor(dens)).numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    _density_fd(loss_fn, dens, g, (0, 3, 9, 30))
    loss, g2 = tdiff.image_and_density_grad(ts, device="cpu", **KW)
    with torch.no_grad():
        assert loss == float(loss_fn(torch.as_tensor(dens)))
    np.testing.assert_array_equal(g2, g)


def test_density_grad_emissive():
    """tests/test_diff.py::test_density_grad_emissive on the port: emission
    and absorption, no lights."""
    js = small_scene(sigma_a=1.0, sigma_s=0.2, with_light=False, le=2.0)
    loss_fn, grad_fn = tdiff.make_diff_renderer(port_scene(js), device="cpu",
                                                **KW)
    dens = np.asarray(js.medium.density, np.float32)
    g = grad_fn(torch.as_tensor(dens)).numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    _density_fd(loss_fn, dens, g, (0,))


def test_chip_smoke_scene_is_the_test_scene(multi):
    """chip_smoke.py builds test_diff's small scene through the port alone;
    its loss equals the JAX loss on the JAX-built scene."""
    _, params, ref_loss, _, _, _ = multi
    loss_fn, _ = tdiff.make_diff_renderer_multi(
        chip_smoke.diff_small_scene(torch.device("cpu")), device="cpu", **KW)
    with torch.no_grad():
        np.testing.assert_allclose(float(loss_fn(params)), ref_loss,
                                   rtol=1e-4)


def test_entry_points_need_cuda_unless_asked(monkeypatch):
    """device=None means the CUDA card; without one the entry points raise
    instead of running on the CPU."""
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import presets

    scene = presets.cloud(8, 6, spp=1, max_depth=2, grid_res=8,
                          device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: presets.cloud(8, 6, spp=1, max_depth=2, grid_res=8),
        lambda: render.render(scene),
        lambda: render.make_wave_renderer(scene),
        lambda: render.render_regen(scene, n_lanes=16),
        lambda: render.make_regen_renderer(scene),
        lambda: tdiff.make_diff_renderer_multi(scene),
        lambda: tdiff.make_diff_renderer(scene),
        lambda: tdiff.image_and_density_grad(scene),
        lambda: tdiff.make_diff_regen_renderer(scene),
        lambda: tdiff.make_regen_film_vjp(scene),
        lambda: convert.scene_from_arrays(
            arrays_from_jax_scene(small_scene())),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
