"""Host-side layout of the march kernel's call (ops/march.py): the one
output buffer the wrapper carves into the plain version's outputs, and the
packed argument record of the C entry (csrc/march.cu::MarchCall).

The kernel stores 4-byte words and the flags' bytes, so every output must
start on a 4-byte boundary of the buffer (16-byte when N is a multiple of
16, as on the main path), none may overlap another, and each must have the
dtype, shape and contiguous layout of march_block_plain's output of the
same name."""
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu_torch.ops import march

NS = [1, 2, 3, 4, 5, 15, 16, 17, 31, 127, 128, 129, 1000, 16383, 16384,
      16385, 262144]


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("residual", [False, True])
def test_output_layout_aligned_and_packed(n, residual):
    layout, size = march.output_layout(n, residual)
    names = [name for name, *_ in layout]
    want = (["voxel", "next_t", "t_cur", "dl_target", "dl_since", "maxd"]
            + ["ctrld", "ctrl_since"] * residual + ["landed", "escaped"])
    assert names == want
    end = 0
    for name, dtype, shape, off in layout:
        assert off % 4 == 0 and (n % 16 or off % 16 == 0), name
        assert end <= off < end + 4, name         # after the previous one
        end = off + dtype.itemsize * int(np.prod(shape))
    assert size % 4 == 0 and end <= size < end + 4


@pytest.mark.parametrize("n", [1, 4, 16, 31, 129, 16384, 16385])
@pytest.mark.parametrize("residual", [False, True])
def test_alloc_outputs_are_the_plain_outputs(n, residual):
    """On CPU tensors: the views have the plain version's keys, dtypes,
    shapes and contiguity, the addresses of the C record, and writing one
    output leaves every other one as it was."""
    lanes = {k: torch.as_tensor(v) for k, v in march.random_lanes(
        n, (16, 16, 16), seed=n, residual=residual).items()}
    ref = march.march_block_plain(K=8, maj_res=(16, 16, 16), **lanes)
    out, ptrs = march.alloc_outputs(n, residual, torch.device("cpu"))
    assert list(out) == list(ref)
    assert len(ptrs) == 10
    order = ["voxel", "next_t", "t_cur", "dl_target", "dl_since", "maxd",
             "landed", "escaped", "ctrld", "ctrl_since"]
    for k, p in zip(order, ptrs):
        assert p == (out[k].data_ptr() if k in out else 0), k
    for k, v in ref.items():
        o = out[k]
        assert (o.dtype, o.shape, o.is_contiguous()) == (v.dtype, v.shape,
                                                          True), k
        assert (o.data_ptr() - ptrs[0]) % 4 == 0, k
    for k in out:
        out[k].zero_()
    for k, v in ref.items():
        out[k].copy_(v)
        for j in out:
            if j != k:
                assert not out[j].any(), (k, j)
        out[k].zero_()


def test_call_record_is_33_fields():
    """25 addresses, 7 integers and the stream, 8 bytes each, as
    MarchCall lays them out."""
    assert march._CALL.size == 33 * 8
