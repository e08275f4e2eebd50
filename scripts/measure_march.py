#!/usr/bin/env python
"""Host cost of the march kernel's wrapper by piece, on one GPU.

    python scripts/measure_march.py

ops/march.py::march_block at N 16384, K 8, 16^3 (the regen loop's call):
mean us per call over back-to-back calls, best of 5 rounds, on the host
clock, of each piece of its launch path and of the whole call.  Beside
them, the alternatives the wrapper does not take: one torch.empty per
output, the outputs carved by one as_strided each, and a ctypes call with
31 integer arguments instead of one packed record (both to libc's labs,
which launches nothing).
"""
import ctypes
import math
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from acceleratedvolrenderer_tpu_torch import kernels  # noqa: E402
from acceleratedvolrenderer_tpu_torch.ops import march  # noqa: E402


def host_us(fn, reps=2000, rounds=5):
    best = math.inf
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps)
    torch.cuda.synchronize()
    return best * 1e6


def strided_views(n, dev):
    """The outputs carved by as_strided, one call per output."""
    buf = torch.empty(11 * n, dtype=torch.float32, device=dev)
    i32, b8 = buf.view(torch.int32), buf.view(torch.bool)
    return {"voxel": i32.as_strided((n, 3), (3, 1), 0),
            "next_t": buf.as_strided((n, 3), (3, 1), 3 * n),
            "t_cur": buf.as_strided((n,), (1,), 6 * n),
            "dl_target": buf.as_strided((n,), (1,), 7 * n),
            "dl_since": buf.as_strided((n,), (1,), 8 * n),
            "maxd": buf.as_strided((n,), (1,), 9 * n),
            "landed": b8.as_strided((n,), (1,), 40 * n),
            "escaped": b8.as_strided((n,), (1,), 41 * n)}


def empties(n, dev):
    """One torch.empty per output."""
    e = lambda shape, dtype: torch.empty(shape, dtype=dtype, device=dev)
    f32 = torch.float32
    return {"voxel": e((n, 3), torch.int32), "next_t": e((n, 3), f32),
            "t_cur": e((n,), f32), "dl_target": e((n,), f32),
            "dl_since": e((n,), f32), "maxd": e((n,), f32),
            "landed": e((n,), torch.bool), "escaped": e((n,), torch.bool)}


def host_pieces(dev):
    n = 16384
    lanes = chip_smoke.to_dev(march.random_lanes(n, (16, 16, 16), seed=7),
                              dev)
    kw = dict(K=8, maj_res=(16, 16, 16), **lanes)
    index, stream = kernels.launch_target("march_block", dev)
    out, o_ptrs = march.alloc_outputs(n, False, dev)
    order = march._ARG_NAMES[:11]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    args = tuple((lanes[k], dtype, shape) for k, dtype, shape in zip(
        order, (f32, i32, f32, f32, i32) + (f32,) * 5 + (b8,),
        [(16 ** 3,)] + [(n, 3)] * 4 + [(n,)] * 6))

    def pack():
        p = [lanes[k].data_ptr() for k in order]
        return march._CALL.pack(p[0], 0, *p[1:], 0, 0, 0, *o_ptrs, 4096, n,
                                8, 16, 16, 16, index, stream)

    record = pack()
    fn = march._kernel()
    libc = ctypes.CDLL(None)
    f31 = libc.labs
    f31.argtypes = [ctypes.c_void_p] * 25 + [ctypes.c_int] * 6
    f31.restype = ctypes.c_long
    f1 = ctypes.CDLL(None).labs
    f1.argtypes = [ctypes.c_char_p]
    f1.restype = ctypes.c_long
    ints31 = [lanes["t_cur"].data_ptr()] * 25 + [1] * 6
    res_kw = dict(K=8, maj_res=(16, 16, 16), **chip_smoke.to_dev(
        march.random_lanes(n, (16, 16, 16), seed=7, residual=True), dev))
    pieces = [
        ("kernels.launch_target", lambda: kernels.launch_target(
            "march_block", dev)),
        ("11 input checks", lambda: march._check_args(args, index, dev)),
        ("alloc_outputs (one torch.empty, split)", lambda:
            march.alloc_outputs(n, False, dev)),
        ("one torch.empty, 8 as_strided views", lambda: strided_views(
            n, dev)),
        ("8 torch.empty", lambda: empties(n, dev)),
        ("one torch.empty of (N,) float32", lambda: torch.empty(
            (n,), dtype=torch.float32, device=dev)),
        ("11 data_ptr and the packed record", pack),
        ("ctypes call with the record, and the launch", lambda: fn(record)),
        ("ctypes call, 31 integer arguments, no launch", lambda: f31(
            *ints31)),
        ("ctypes call, one packed record, no launch", lambda: f1(record)),
        ("whole wrapper", lambda: march.march_block(**kw)),
        ("whole wrapper, residual mode", lambda: march.march_block(
            **res_kw)),
    ]
    for name, fn_ in pieces:
        print(f"host N {n}: {name}: {host_us(fn_):.3f} us per call",
              flush=True)


def main():
    if not torch.cuda.is_available():
        print("measure_march: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"card: {chip_smoke.card_line()}", flush=True)
    kernels.library()
    print(kernels.build_log.strip(), flush=True)
    host_pieces(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
