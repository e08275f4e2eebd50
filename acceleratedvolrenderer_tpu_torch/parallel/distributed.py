"""Multi-process set-up
(port of acceleratedvolrenderer_tpu/parallel/distributed.py: initialize
and host_pixel_shard).

Every process runs the same program over one `torch.distributed` process
group: scene data (grids, lights) is built in every rank, each rank renders
its slice of the pixel batch, and the only cross-rank traffic is the film's
all-reduce (and the density gradient's reduction in parallel/diff.py).  On
a single process nothing is initialized, so one entry point serves one card
and many.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch.distributed as dist

#: the backends a group may use: "nccl" with one card per rank, "gloo" for
#: CPU ranks or several ranks that share one card (NCCL refuses those)
BACKENDS = ("nccl", "gloo")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None) -> bool:
    """Initialize the default process group if the arguments or the
    environment ask for one, and return whether they did.

    The explicit arguments come first, then the variables torchrun sets
    (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK).  The coordinator address
    is an init_method URL or "host:port" (taken as tcp://host:port).  With
    neither an address nor a process count this returns False and creates
    no group, as the reference does on a single host.  `backend` ("nccl" or
    "gloo", see BACKENDS) must be given when a group is created."""
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = (f"tcp://{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    nproc = num_processes or _int_env("WORLD_SIZE")
    pid = process_id if process_id is not None else _int_env("RANK")
    if addr is None and nproc is None:
        return False
    if backend not in BACKENDS:
        raise ValueError(f"initialize: backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if addr is None or nproc is None or pid is None:
        raise ValueError("initialize: a process group needs an address, a "
                         "process count and a process id (arguments or "
                         "MASTER_ADDR / WORLD_SIZE / RANK)")
    if "://" not in addr:
        addr = "tcp://" + addr
    dist.init_process_group(backend, init_method=addr, world_size=int(nproc),
                            rank=int(pid))
    return True


def _int_env(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def host_pixel_shard(height: int, width: int):
    """This process's contiguous slice of the pixel batch (an equal split
    over the processes, a single one without a process group): its (P, 2)
    int32 (x, y) pixels and their (P,) uint32 flat indices."""
    rank, size = ((dist.get_rank(), dist.get_world_size())
                  if dist.is_initialized() else (0, 1))
    total = height * width
    per = (total + size - 1) // size
    start = rank * per
    stop = min(start + per, total)
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    pix = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)
    return pix[start:stop], np.arange(start, stop, dtype=np.uint32)
