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
`csrc/dma_gather.cu` (bulk copies into a shared-memory ring with one
mbarrier per slot, a ring in each block, the chunk cut into a slice per
block: `launch_geometry`); `dma_gather_plain` is the same function in eager
PyTorch (it reads only the one tile that reaches the output).  Tensors on
the CPU take the plain version and launch nothing.  `launches` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels

TILE = (8, 128)          # one f32 tile, 4 KB
TILE_ELEMS = TILE[0] * TILE[1]
SLOTS = 16               # ring slots, copies in flight per block
MAX_PER = 1024           # ids a block stages in shared memory

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


def launch_geometry(chunk: int, max_blocks: int):
    """(blocks, per): the chunk cut into `blocks` contiguous slices of
    `per` ids, block b taking ids [b * per, min((b + 1) * per, chunk)).
    About `max_blocks` slices, none empty and none longer than MAX_PER; the
    slice that holds j* = last_slot0(chunk) is block j* // per."""
    per = min(-(-chunk // max_blocks), MAX_PER)
    return -(-chunk // per), per


_fn = None
_sms = {}                # device index -> SM count


def _kernel():
    global _fn
    if _fn is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _fn = kernels.entry("avrt_dma_gather",
                            [p, ctypes.c_longlong, p, i, i, i, p, i, p])
    return _fn


def dma_gather(table, tile_idx):
    """The tile-DMA design: table float32 with a multiple of 1024 elements,
    tile_idx int32 (chunk,), chunk >= 1.  CPU tensors run the plain
    version; CUDA tensors launch csrc/dma_gather.cu, about one block per
    SM."""
    global launches
    dev = table.device
    if dev.type == "cpu" and tile_idx.device.type == "cpu":
        return dma_gather_plain(table, tile_idx)
    index, stream = kernels.launch_target("dma_gather", dev)
    kernels.check_tensor("dma_gather", "table", table, torch.float32, None,
                         dev)
    kernels.check_tensor("dma_gather", "tile_idx", tile_idx, torch.int32, 1,
                         dev)
    v, chunk = table.numel(), tile_idx.shape[0]
    if v % TILE_ELEMS or v == 0:
        raise ValueError(f"dma_gather: table of {v} elements, expected a "
                         f"positive multiple of {TILE_ELEMS}")
    if not 0 < chunk < 2 ** 31:
        raise ValueError(f"dma_gather: chunk {chunk}, expected 1..2^31-1")
    table_ptr = table.data_ptr()
    if table_ptr % 16:
        # cp.async.bulk faults on a source address not 16-byte aligned
        raise ValueError("dma_gather: table must start on a 16-byte "
                         "boundary")
    sms = _sms.get(index)
    if sms is None:
        sms = _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    blocks, per = launch_geometry(chunk, sms)
    out = torch.empty(TILE, dtype=torch.float32, device=dev)
    err = _kernel()(table_ptr, v // TILE_ELEMS, tile_idx.data_ptr(), chunk,
                    per, blocks, out.data_ptr(), index, stream)
    if err != 0:
        raise RuntimeError(f"dma_gather: CUDA kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return out
