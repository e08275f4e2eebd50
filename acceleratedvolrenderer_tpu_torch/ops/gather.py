"""Gather from a small table
(counterpart of acceleratedvolrenderer_tpu/ops/pallas_gather.py).

`table_gather` is the wrapper of the hand-written CUDA kernel
`csrc/gather.cu`; `table_gather_plain` is the same gather in eager
PyTorch.  The reference entry serves only tables of V % 128 == 0 and
V <= 32^3 entries and index batches of a multiple of 128 with its kernel
(a TPU tiling and VMEM limit) and takes `jnp.take` for the rest; the CUDA
kernel has no such limit, so on CUDA tensors the wrapper launches it for
every shape, or raises on a bad input.  Tensors on the CPU take the plain
version and launch nothing.  `launches` counts kernel launches, so a run
can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels

launches = 0

# the reference kernel's tiling and table cap (V % LANES == 0, V <=
# MAX_TABLE; pallas_gather.py l. 29-30); the CUDA kernel has neither limit
LANES = 128
MAX_TABLE = 32768


def table_gather_plain(table, idx):
    """table[idx] for a (V,) table and integer indices of any shape; an
    index outside [0, V) reads 0, as the reference's row-select kernel
    (no row matches) and csrc/gather.cu do."""
    v = table.shape[0]
    idx = idx.long()
    inside = (idx >= 0) & (idx < v)
    return torch.where(inside, table[torch.clamp(idx, 0, v - 1)], 0.0)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _fn = kernels.entry("avrt_table_gather",
                            [p, i, p, p, ctypes.c_longlong, i, p])
    return _fn


def table_gather(table, idx):
    """table[idx]: table (V,) float32 with 0 < V < 2^31, idx int32 of any
    shape.  CPU tensors run the plain version; CUDA tensors launch
    csrc/gather.cu."""
    global launches
    dev = table.device
    if dev.type == "cpu" and idx.device.type == "cpu":
        return table_gather_plain(table, idx)
    index, stream = kernels.launch_target("table_gather", dev)
    kernels.check_tensor("table_gather", "table", table, torch.float32, 1,
                         dev)
    kernels.check_tensor("table_gather", "idx", idx, torch.int32, None, dev)
    v, n = table.shape[0], idx.numel()
    if not 0 < v < 2 ** 31:
        raise ValueError(f"table_gather: table of {v} entries, expected "
                         "0 < V < 2^31")
    if n == 0:
        return torch.empty(idx.shape, dtype=torch.float32, device=dev)
    idx_ptr = idx.data_ptr()
    # the kernel's 16-byte loads and stores need out at idx's offset modulo
    # 16 bytes; a fresh allocation is at offset 0
    phase = idx_ptr % 16 // 4
    if phase:
        out = torch.empty(n + 3, dtype=torch.float32, device=dev)[
            phase:phase + n].view(idx.shape)
    else:
        out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    err = _kernel()(table.data_ptr(), v, idx_ptr, out.data_ptr(), n, index,
                    stream)
    if err != 0:
        raise RuntimeError(f"table_gather: CUDA kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return out
