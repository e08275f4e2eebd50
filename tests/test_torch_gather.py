"""The port's window route of the march step and its gather.

- ops/gather.py's plain gather against the TPU row-select kernel itself
  (ops/pallas_gather.py::_pallas_table_gather) run in Pallas interpret
  mode: bitwise equal, out-of-range indices reading 0 on both sides.
- march.march_window against march.march_block_plain, lane for lane, in
  plain and residual mode: bitwise equal, integers and floats (the window
  sums the optical and control depths in the fused kernel's order, so no
  tolerance is needed).
- march.available against pallas_march.available's rule, its backend test
  set to the TPU.
- On CPU tensors neither wrapper launches a kernel.
- A frame rendered on the window route equals the fused route's frame up
  to the film's add order (per-sample estimates do not depend on the lane
  count): means to 1e-6 relative, pixels to rtol 1e-5 / atol 1e-7."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.ops import pallas_gather, pallas_march
from acceleratedvolrenderer_tpu_torch.ops import gather, march
from acceleratedvolrenderer_tpu_torch.parallel import render
from acceleratedvolrenderer_tpu_torch.scene import presets

from torch_port_util import interpret_pallas  # noqa: F401  (fixture)

torch.set_num_threads(2)


@pytest.mark.parametrize("v", [128, 4096, 32768])
def test_plain_gather_matches_pallas_kernel(interpret_pallas, v):
    rng = np.random.default_rng(v)
    n = 1664
    table = rng.uniform(0.0, 2.0, v).astype(np.float32)
    idx = rng.integers(0, v, n).astype(np.int32)
    idx[:4] = [-1, -129, v, v + 200]          # no row matches: reads 0
    ref = pallas_gather._pallas_table_gather(
        jnp.asarray(table.reshape(v // 128, 128)),
        jnp.asarray(idx.reshape(n // 128, 128)), v // 128)
    out = gather.table_gather_plain(torch.as_tensor(table),
                                    torch.as_tensor(idx))
    assert np.array_equal(np.asarray(ref).reshape(-1), out.numpy())
    assert (out[:4] == 0).all() and (out[4:] > 0).any()


@pytest.mark.parametrize("res", [(16, 16, 16), (32, 32, 32)])
@pytest.mark.parametrize("K", [1, 8, 16])
def test_march_window_matches_plain(res, K):
    lanes = {k: torch.as_tensor(v) for k, v in
             march.random_lanes(1024, res, seed=K + res[0]).items()}
    out = march.march_window(K=K, maj_res=res, **lanes)
    ref = march.march_block_plain(K=K, maj_res=res, **lanes)
    assert set(out) == set(ref)
    assert ref["landed"].any() and ref["escaped"].any()
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(out[k].numpy(), ref[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("n", [200, 1024])
@pytest.mark.parametrize("K", [1, 8, 16])
def test_march_window_residual_matches_plain(n, K):
    """Residual mode (the minorant table): march_window's two gathers and
    column-by-column control depth against march_block_plain, lane for
    lane."""
    res = (16, 16, 16)
    lanes = {k: torch.as_tensor(v) for k, v in
             march.random_lanes(n, res, seed=n + K, residual=True).items()}
    out = march.march_window(K=K, maj_res=res, **lanes)
    ref = march.march_block_plain(K=K, maj_res=res, **lanes)
    assert list(out) == list(ref)
    assert ref["landed"].any() and ref["escaped"].any()
    assert (ref["ctrl_since"] != lanes["csince_in"]).any()
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(out[k].numpy(), ref[k].numpy(),
                                      err_msg=k)


def test_available_matches_pallas_rule(monkeypatch):
    monkeypatch.setattr(pallas_march.jax, "default_backend", lambda: "tpu")
    sizes = [0, 64, 128, 4096, 4096 + 128, 32768, 64 ** 3, 64 ** 3 + 128,
             2 * 64 ** 3]
    lanes = [0, 96, 128, 208, 256, 1000, 1024, 1152, 16384, 16384 + 128]
    for v in sizes:
        for n in lanes:
            assert march.available(v, n) == pallas_march.available(v, n), (
                v, n)
    assert march.available(4096, 16384) and not march.available(4096, 208)


def test_cpu_wrappers_launch_nothing():
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.random(4096).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, 4096, (208, 8)).astype(np.int32))
    g0, m0 = gather.launches, march.launches
    assert torch.equal(gather.table_gather(table, idx),
                       gather.table_gather_plain(table, idx))
    lanes = {k: torch.as_tensor(v) for k, v in
             march.random_lanes(208, (16, 16, 16), seed=2).items()}
    march.march_window(K=8, maj_res=(16, 16, 16), **lanes)
    assert (gather.launches, march.launches) == (g0, m0)


def test_window_route_frame_matches_fused_route():
    scene = presets.cloud(16, 12, spp=2, max_depth=4, grid_res=16,
                          device="cpu")
    knobs = dict(k_substeps=8, stochastic_filter=True, accum_spp=True,
                 retire_groups=2, work_stride="auto")
    win, _ = render.render_regen(scene, device="cpu", n_lanes=96, **knobs)
    fused, _ = render.render_regen(scene, device="cpu", n_lanes=128,
                                   **knobs)
    assert win.mean() > 0
    np.testing.assert_allclose(win.mean(), fused.mean(), rtol=1e-6)
    np.testing.assert_allclose(win, fused, rtol=1e-5, atol=1e-7)
