#!/usr/bin/env python
"""Three designs of the density tap's gather, timed on the CUDA card (the
port's counterpart of scripts/measure_gather_designs.py).

Each leg runs `iters` dependent steps over N indices into the 256^3 f32
density-sized table (64 MB): the next step's indices depend on the values
this step gathered, so no step can start before the previous one ends.

  1. baseline   - the gather table[idx] of N elements;
  2. tile DMA   - ops/dma_gather.py (csrc/dma_gather.cu): one 4 KB tile
                  bulk copy per index into a 16-slot shared-memory ring,
                  the chunk spread over about one block per SM, each with
                  its own ring and 16 copies in flight; the loop carries
                  tile[0, 0] into the next tile ids;
  3. sort bound - argsort of the N keys, a lower bound on the brick-binned
                  design (sort by brick, then select), which pays it every
                  step before any select work.

Timing: the `iters` steps of a leg are captured in one CUDA graph after an
eager warm-up step, and the graph is replayed three times from the same
start; the best replay, timed by CUDA events, gives nanoseconds per element
(replay ms / iters / N).  So the number is the card's, without Python's
per-step launch cost.  A wrapper call made while the graph is captured
records its kernel without running it, so the tile-DMA kernel runs
1 + 3 * iters times: `dma_kernel_runs` counts them from the wrapper's
counter (`dma_wrapper_calls` = 1 + iters).

Usage: python scripts/measure_gather_designs_torch.py [--n 16384] [--iters 200]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from acceleratedvolrenderer_tpu_torch.ops import dma_gather as dma  # noqa: E402
from acceleratedvolrenderer_tpu_torch.utils.device import resolve  # noqa: E402

V = 256 ** 3
REPLAYS = 3


def timed_graph(step, state, iters, count=lambda: 0):
    """(best replay ms, runs) of a CUDA graph of `iters` calls of
    step(state), which updates the tensors of `state` in place; the state
    is reset to its start before every replay.  `runs` is how often the
    kernel whose wrapper counter `count()` reads ran on the card: each
    eager call once, each captured call once per replay."""
    start = [t.clone() for t in state]
    c0 = count()
    step(state)                          # eager warm-up (builds, allocates)
    eager = count() - c0
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            step(state)
    captured = count() - c0 - eager
    best = float("inf")
    for _ in range(REPLAYS):
        for t, t0 in zip(state, start):
            t.copy_(t0)
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        graph.replay()
        ev1.record()
        torch.cuda.synchronize()
        best = min(best, ev0.elapsed_time(ev1))
    del graph
    return best, eager + REPLAYS * captured


def measure(n=16384, iters=200, device=None):
    """ns per element of the three legs on the card; a dict with the JAX
    script's keys plus the device name and the tile-DMA kernel's wrapper
    calls and runs."""
    dev = resolve(device)
    if dev.type != "cuda":
        raise RuntimeError("measure_gather_designs_torch: the timings need "
                           f"a CUDA device, got {dev}")
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.rand(V, generator=gen, device=dev)
    idx0 = torch.as_tensor(np.random.default_rng(1).integers(0, V, n),
                           dtype=torch.int64, device=dev)
    n_tiles = V // dma.TILE_ELEMS
    out = {"n": n, "iters": iters, "table_mb": round(V * 4 / 1e6, 1),
           "device": torch.cuda.get_device_name(dev)}
    ns = lambda ms: ms * 1e6 / iters / n

    def mutate(idx, acc):
        # serial dependence: the next indices depend on gathered values
        return (idx * 2654435761 + acc.long()) % V

    def step_gather(st):
        idx, acc = st
        v = table[idx]
        idx.copy_(mutate(idx, v * 1e3))
        acc.add_(v)

    state = (idx0.clone(), torch.zeros(n, device=dev))
    out["xla_gather_ns_per_el"] = ns(timed_graph(step_gather, state,
                                                 iters)[0])

    def step_dma(st):
        tid, acc = st
        tile = dma.dma_gather(table, tid)
        tid.copy_((tid.long() * 48271 + tile[0, 0].long()) % n_tiles)
        acc.add_(tile.mean())

    state = ((idx0 // dma.TILE_ELEMS).to(torch.int32),
             torch.zeros((), device=dev))
    calls0 = dma.launches
    ms, runs = timed_graph(step_dma, state, iters, lambda: dma.launches)
    out["dma_tile_ns_per_el"] = ns(ms)
    out["dma_wrapper_calls"] = dma.launches - calls0
    out["dma_kernel_runs"] = runs
    out["dma_note"] = ("one 4 KB tile bulk copy per element, a 16-slot ring "
                       "in each of about one block per SM "
                       "(csrc/dma_gather.cu)")

    def step_sort(st):
        (idx,) = st
        order = torch.argsort(idx)
        idx.copy_(mutate(idx, order.float()))

    out["argsort_ns_per_el"] = ns(timed_graph(step_sort, (idx0.clone(),),
                                              iters)[0])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()
    print(json.dumps(measure(args.n, args.iters)))


if __name__ == "__main__":
    main()
