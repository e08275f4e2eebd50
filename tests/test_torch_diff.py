"""The port's differentiable regen path (parallel/diff.py) against the JAX
package's (acceleratedvolrenderer_tpu/parallel/diff.py), on the same small
cloud: 16x12, spp 2, max_depth 4, a 16^3 grid and majorant, the bench
knobs (accum_spp, stochastic filter, k 8, grouped retirement, strided work
order) over a 96-step loop checkpointed in windows of 16.  The forward
render finishes in fewer than 64 iterations, so every sample is in the
loss on both sides.  96 lanes take the window route in the port (and in
the JAX package, which takes it whenever it runs off the TPU); 128 lanes
take the fused route in the port.

Tolerances:
- losses to 1e-3 relative, as the forward slice's frames;
- gradients: relative L2 <= 1e-2 and >= 99% of voxels within rtol 1e-3 /
  atol 1e-6 * max|g|.  The two programs run the same float32 formulas,
  but XLA:CPU and torch differ by ulps in exp, log1p and erfinv, and one
  flipped `u < p` choice sends a sample down another path, which moves the
  few voxels that path touches;
- FD == AD to 1% of the larger magnitude, as the reference's
  test_regen_accum_spp_grad_matches_fd: float32 central differences
  through the fixed-step loop carry that much roundoff;
- slim (loss-cotangent retire) and film-scatter retire: loss to 1e-6,
  gradient to rtol 1e-5 (the same estimates summed in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.parallel import diff as jdiff
from acceleratedvolrenderer_tpu.scene import presets as jpresets
from acceleratedvolrenderer_tpu_torch.parallel import diff as tdiff
from acceleratedvolrenderer_tpu_torch.scene import convert

from torch_port_util import arrays_from_jax_scene

torch.set_num_threads(2)

SMALL = dict(width=16, height=12, spp=2, max_depth=4, grid_res=16)
KW = dict(fixed_steps=96, spp=2, accum_spp=True, retire_groups=2,
          k_substeps=8, stochastic_filter=True, remat_window=16,
          work_stride="auto")


@pytest.fixture(scope="module")
def scenes():
    js = jpresets.cloud(**SMALL)
    return js, convert.scene_from_arrays(arrays_from_jax_scene(js), "cpu")


@pytest.fixture(scope="module")
def density(scenes):
    return np.asarray(scenes[0].medium.density, np.float32)


@pytest.fixture(scope="module")
def port96(scenes):
    return tdiff.make_diff_regen_renderer(scenes[1], device="cpu",
                                          n_lanes=96, **KW)


@pytest.fixture(scope="module")
def grad96(port96, density):
    g = port96[1](torch.as_tensor(density)).numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    return g


@pytest.mark.parametrize("n_lanes", [96, 128])
def test_loss_matches_jax(scenes, density, n_lanes):
    js, ts = scenes
    jloss, _ = jdiff.make_diff_regen_renderer(js, n_lanes=n_lanes, **KW)
    tloss, _ = tdiff.make_diff_regen_renderer(ts, device="cpu",
                                              n_lanes=n_lanes, **KW)
    ref = float(jloss(jnp.asarray(density)))
    got = tloss(torch.as_tensor(density))
    assert got.shape == () and ref > 0
    np.testing.assert_allclose(float(got), ref, rtol=1e-3)


def test_grad_matches_jax(scenes, density, grad96):
    _, jgrad = jdiff.make_diff_regen_renderer(scenes[0], n_lanes=96, **KW)
    ref = np.asarray(jgrad(jnp.asarray(density)))
    assert grad96.shape == ref.shape == density.shape
    assert np.linalg.norm(grad96 - ref) <= 1e-2 * np.linalg.norm(ref)
    close = np.isclose(grad96, ref, rtol=1e-3, atol=1e-6 * np.abs(ref).max())
    assert close.mean() >= 0.99, close.mean()


def test_grad_matches_fd(port96, density, grad96):
    loss_fn, _ = port96
    eps = 2e-3
    order = np.argsort(np.abs(grad96).reshape(-1))[::-1]
    for fi in order[[0, 7]]:
        e = np.zeros_like(density)
        e.reshape(-1)[fi] = eps
        fd = (float(loss_fn(torch.as_tensor(density + e)))
              - float(loss_fn(torch.as_tensor(density - e)))) / (2 * eps)
        ad = float(grad96.reshape(-1)[fi])
        assert abs(fd - ad) <= 1e-2 * max(abs(fd), abs(ad), 1e-3), (
            f"voxel {fi}: fd={fd} ad={ad}")


def test_slim_matches_film_scatter(scenes, density, port96, grad96):
    loss_f, grad_f = tdiff.make_diff_regen_renderer(
        scenes[1], device="cpu", n_lanes=96, slim=False, **KW)
    d = torch.as_tensor(density)
    np.testing.assert_allclose(float(loss_f(d)), float(port96[0](d)),
                               rtol=1e-6)
    np.testing.assert_allclose(grad_f(d).numpy(), grad96, rtol=1e-5,
                               atol=1e-9)


def test_film_vjp_matches_mean_grad(scenes, density, grad96):
    H, W = SMALL["height"], SMALL["width"]
    vjp_fn = tdiff.make_regen_film_vjp(scenes[1], device="cpu", n_lanes=96,
                                       **KW)
    d = torch.as_tensor(density)
    cot_mean = torch.full((H, W, 3), 1.0 / (3 * H * W * SMALL["spp"]))
    np.testing.assert_allclose(vjp_fn(d, cot_mean).numpy(), grad96,
                               rtol=1e-5, atol=1e-10)
    # a one-hot pixel cotangent isolates that pixel's voxel gradients
    cot_px = torch.zeros((H, W, 3))
    cot_px[10, 6, :] = 1.0                    # a pixel inside the cloud
    g_px = vjp_fn(d, cot_px).numpy()
    assert np.isfinite(g_px).all() and np.abs(g_px).max() > 0
