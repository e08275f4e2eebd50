"""The port's plain march (ops/march.py::march_block_plain, the CPU path
of the CUDA kernel's wrapper) against the TPU Pallas kernel itself
(ops/pallas_march.py::march_block) run in Pallas interpret mode.

Integer outputs and flags must be equal; floats agree to rtol 1e-6 (same
float32 formulas; the kernels differ only in op order).  The 16^3 table
takes the TPU kernel's row-select gather, the 64^3 table its one-hot MXU
gather; 64^3 values are pre-rounded to bf16 in numpy so that the MXU
path's bf16 rounding is a no-op and both sides read the same majorant."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.ops import pallas_march
from acceleratedvolrenderer_tpu_torch.ops import march

from torch_port_util import interpret_pallas  # noqa: F401  (fixture)

torch.set_num_threads(2)

N = 1024


def _bf16(a):
    """Round float32 to the nearest bf16-representable value (numpy)."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("res", [(16, 16, 16), (64, 64, 64)])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("K", [1, 8])
def test_plain_march_matches_pallas_kernel(interpret_pallas, res, residual, K):
    lanes = march.random_lanes(N, res, seed=K + 3 * residual + res[0],
                               residual=residual)
    if res[0] == 64:
        lanes["majorant"] = _bf16(lanes["majorant"])
        if residual:
            lanes["control"] = _bf16(lanes["control"])
    jout = pallas_march.march_block(
        K=K, maj_res=res, **{k: jnp.asarray(v) for k, v in lanes.items()})
    tout = march.march_block(
        K=K, maj_res=res, **{k: torch.as_tensor(v) for k, v in lanes.items()})
    assert set(jout) == set(tout)
    assert tout["landed"].any() and tout["escaped"].any()
    for k, jv in jout.items():
        jv, tv = np.asarray(jv), tout[k].numpy()
        if jv.dtype.kind in "biu":
            assert np.array_equal(jv.astype(tv.dtype), tv), k
        else:
            np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=0, err_msg=k)


def test_cpu_wrapper_counts_no_launch():
    """On CPU tensors the wrapper runs the plain version, launches nothing
    and leaves the kernel counter alone."""
    lanes = march.random_lanes(256, (16, 16, 16), seed=0)
    before = march.launches
    out = march.march_block(K=4, maj_res=(16, 16, 16),
                            **{k: torch.as_tensor(v) for k, v in lanes.items()})
    ref = march.march_block_plain(
        K=4, maj_res=(16, 16, 16),
        **{k: torch.as_tensor(v) for k, v in lanes.items()})
    assert march.launches == before
    for k in ref:
        assert torch.equal(out[k], ref[k]), k
