"""How many march_kernel launches torch.profiler records in a window, on
one GPU, in a fresh process: windows of 1 and 200 calls of the march
kernel (N 16384, K 8, 16^3, without and with the residual table), warm
and after a 256 MB flush, profiled as chip_smoke.py::device_us profiles
them (plain, and with a synchronize and a 20 ms pause first), and under a
torch.profiler schedule with one warm-up cycle.  Prints (launches
recorded, device us in all) per window.

    python scripts/probe_profiler_windows.py
"""
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, schedule

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from acceleratedvolrenderer_tpu_torch import kernels  # noqa: E402
from acceleratedvolrenderer_tpu_torch.ops import march  # noqa: E402


def count(prof, name):
    run = [e for e in prof.key_averages()
           if e.self_device_time_total > 0 and name in e.key]
    return (sum(e.count for e in run),
            sum(e.self_device_time_total for e in run))


def plain(fn, reps, pre=None):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if pre:
            pre()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return count(prof, "march_kernel")


def scheduled(fn, reps):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return count(prof, "march_kernel")


def pause():
    torch.cuda.synchronize()
    time.sleep(0.02)


def main():
    if not torch.cuda.is_available():
        print("probe_profiler_windows: CUDA is not available",
              file=sys.stderr)
        return 1
    kernels.library()
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 2 ** 20, device=dev).zero_
    for residual in (False, True):
        lanes = {k: torch.as_tensor(v, device=dev)
                 for k, v in march.random_lanes(
                     16384, (16, 16, 16), seed=7, residual=residual).items()}
        call = lambda: march.march_block(K=8, maj_res=(16, 16, 16), **lanes)
        cold = lambda: (flush(), call())
        for label, fn in (("warm", call), ("cold", cold)):
            for reps in (1, 200):
                for _ in range(4):
                    print(f"residual {residual} {label} reps {reps}: plain "
                          f"{plain(fn, reps)}, pause first "
                          f"{plain(fn, reps, pre=pause)}, schedule "
                          f"{scheduled(fn, reps)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
