"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device.  The file
imports no JAX, so it runs on a machine with only PyTorch and the CUDA
toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Integer outputs and flags must be equal; floats agree to rtol 1e-6 (the
kernel is built without multiply-add contraction, so it rounds as the eager
version does)."""
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu_torch.ops import march

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _lanes(n, res, seed, residual, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in
            march.random_lanes(n, res, seed=seed, residual=residual).items()}


@pytest.mark.parametrize("res", [(16, 16, 16), (32, 32, 32), (64, 64, 64)])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("K", [1, 8, 16])
def test_march_kernel_matches_plain(dev, res, residual, K):
    lanes = _lanes(1000, res, K + res[0], residual, dev)
    before = march.launches
    out = march.march_block(K=K, maj_res=res, **lanes)
    assert march.launches == before + 1
    ref = march.march_block_plain(K=K, maj_res=res, **lanes)
    torch.cuda.synchronize()
    assert set(out) == set(ref)
    for k in ref:
        x, y = out[k].cpu().numpy(), ref[k].cpu().numpy()
        if x.dtype.kind in "biu":
            assert np.array_equal(x, y), k
        else:
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=0, err_msg=k)


def test_march_wrapper_rejects_bad_input(dev):
    lanes = _lanes(256, (16, 16, 16), 0, False, dev)
    before = march.launches
    bad = dict(lanes, t_cur=lanes["t_cur"].double())
    with pytest.raises(TypeError):
        march.march_block(K=4, maj_res=(16, 16, 16), **bad)
    bad = dict(lanes, voxel=lanes["voxel"].t().contiguous().t())
    with pytest.raises(ValueError):
        march.march_block(K=4, maj_res=(16, 16, 16), **bad)
    assert march.launches == before
