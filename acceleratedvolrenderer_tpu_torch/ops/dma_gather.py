"""Per-lane tile-DMA gather, the gather-design measurement's second design
(counterpart of scripts/measure_gather_designs.py::dma_gather, kernel
_dma_kernel).

The design fetches, for every index j of a chunk, the 4 KB tile
`table.view(-1, 8, 128)[tile_idx[j]]` into slot j % 16 of a ring of 16
tiles, with at most 16 copies in flight, and returns the ring's slot 0 at
the end: the tile of tile_idx[j*], j* = 16 * floor((chunk - 1) / 16).  An
out-of-range tile id fills its slot with zeros; nothing outside the table
is read.

`dma_gather` is the wrapper of the hand-written CUDA kernel
`csrc/dma_gather.cu` (bulk copies into a shared-memory ring, one mbarrier
per slot); `dma_gather_plain` is the same function in eager PyTorch (it
reads only the one tile that reaches the output).  Tensors on the CPU take
the plain version and launch nothing.  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels

TILE = (8, 128)          # one f32 tile, 4 KB
TILE_ELEMS = TILE[0] * TILE[1]
SLOTS = 16               # copies in flight

launches = 0


def last_slot0(chunk: int) -> int:
    """The index j* whose tile the ring's slot 0 holds at the end."""
    return SLOTS * ((int(chunk) - 1) // SLOTS)


def dma_gather_plain(table, tile_idx):
    """(8, 128) tile of tile_idx[j*] from `table` viewed as (-1, 8, 128);
    zeros when that id is out of range."""
    t3 = table.reshape(-1, *TILE)
    n = t3.shape[0]
    tid = tile_idx[last_slot0(tile_idx.shape[0])].long()
    inside = (tid >= 0) & (tid < n)
    return torch.where(inside, t3[torch.clamp(tid, 0, n - 1)], 0.0)


_argtypes = None


def _entry():
    global _argtypes
    fn = kernels.library().avrt_dma_gather
    if _argtypes is None:
        p = ctypes.c_void_p
        _argtypes = [p, ctypes.c_longlong, p, ctypes.c_int, p, p]
        fn.argtypes = _argtypes
        fn.restype = ctypes.c_int
    return fn


def dma_gather(table, tile_idx):
    """The tile-DMA design: table float32 with a multiple of 1024 elements,
    tile_idx int32 (chunk,), chunk >= 1.  CPU tensors run the plain
    version; CUDA tensors launch csrc/dma_gather.cu."""
    global launches
    dev = table.device
    if dev.type == "cpu" and tile_idx.device.type == "cpu":
        return dma_gather_plain(table, tile_idx)
    if dev.type != "cuda":
        raise ValueError(f"dma_gather: unsupported device {dev}")
    v, chunk = table.numel(), tile_idx.shape[0]
    check = functools.partial(kernels.check_arg, "dma_gather")
    check("table", table, torch.float32, tuple(table.shape), dev)
    check("tile_idx", tile_idx, torch.int32, (chunk,), dev)
    if v % TILE_ELEMS or v == 0:
        raise ValueError(f"dma_gather: table of {v} elements, expected a "
                         f"positive multiple of {TILE_ELEMS}")
    if not 0 < chunk < 2 ** 31:
        raise ValueError(f"dma_gather: chunk {chunk}, expected 1..2^31-1")
    if table.data_ptr() % 16:
        # cp.async.bulk faults on a source address not 16-byte aligned
        raise ValueError("dma_gather: table must start on a 16-byte "
                         "boundary")
    out = torch.empty(TILE, dtype=torch.float32, device=dev)
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(table.data_ptr(), v // TILE_ELEMS, tile_idx.data_ptr(),
                 chunk, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dma_gather: CUDA kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return out
