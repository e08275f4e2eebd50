#!/usr/bin/env python
"""Profile the PyTorch/CUDA port's cloud render on one GPU.

    python scripts/profile_port.py [--out profile.txt]

1. March kernel: device time per call (torch.profiler, CUPTI), of the
   kernel alone (by its name) and of everything the call launches, and
   wrapper time per call (CUDA events over back-to-back calls) at the
   render's shape (N 16384, K 8, 16^3), beside the plain version's.
   Gather kernel: the same two times at n 16384*8 and 208*8 (V 4096)
   and at n 16384*8 from a 64^3 table.
2. Slice window: the 1280x720 cloud, 256^3 grid, bench knobs, spp 16,
   with max_march_steps = 1, which caps the loop at refills + 1 = 901
   iterations of the real workload.  One unprofiled timed run gives the
   host time per iteration; one profiled run (device activity only) gives
   the device busy time per iteration, the kernel count per iteration and
   the kernels that take the device time.  Idle share = 1 - busy / wall.
3. Gradient window: the same scene at spp 4 (8 retire groups), the
   gradient over its first 72 steps in two checkpointed windows of 36.
   The loss alone under no_grad, then the gradient, each timed once
   unprofiled; then one profiled gradient for the device busy time,
   kernels per step and idle share.
The kernel tables go to --out.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from acceleratedvolrenderer_tpu_torch.ops import gather, march  # noqa: E402
from acceleratedvolrenderer_tpu_torch.parallel import diff, render  # noqa: E402
from acceleratedvolrenderer_tpu_torch.scene import presets  # noqa: E402

KNOBS = dict(k_substeps=8, stochastic_filter=True, accum_spp=True,
             work_stride="auto", retire_groups=32, n_lanes=16384)


def timed(fn):
    """(result, seconds) of fn() between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def device_us(prof, name=None):
    """Total device time (us) of the kernels in a profile, or of those
    whose name holds `name`."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if name is None or name in e.key)


def events_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile.txt")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    report = [f"card: {card}"]

    lanes = {k: torch.as_tensor(v, device=dev) for k, v in
             march.random_lanes(16384, (16, 16, 16), seed=7).items()}
    kw = dict(K=8, maj_res=(16, 16, 16), **lanes)
    cases = [("march kernel", march.march_block, kw, 200),
             ("march plain", march.march_block_plain, kw, 20)]
    for n, v in ((16384, 4096), (208, 4096), (16384, 64 ** 3)):
        idx = dict(table=torch.rand(v, device=dev), idx=torch.randint(
            0, v, (n, 8), dtype=torch.int32, device=dev))
        name = f"n {n}*8 V {v}"
        cases += [(f"gather kernel {name}", gather.table_gather, idx, 200),
                  (f"gather plain {name}", gather.table_gather_plain, idx,
                   200)]
    for name, fn, fn_kw, reps in cases:
        call_ms = events_ms(lambda: fn(**fn_kw), reps)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(**fn_kw)
            torch.cuda.synchronize()
        line = (f"{name}: {call_ms:.4f} ms per call (CUDA events, back to "
                f"back), device time {device_us(prof) / reps:.2f} us per "
                "call (profiler)")
        if name == "march kernel":
            line += (f", of which the kernel alone "
                     f"{device_us(prof, 'march_kernel') / reps:.2f} us")
        print(line, flush=True)
        report += [line, prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=8)]

    scene = presets.cloud(1280, 720, spp=16, max_depth=16, grid_res=256,
                          device=dev)
    scene.max_march_steps = 1
    render.render_regen(scene, device=dev, **KNOBS)          # warm-up
    _, st = render.render_regen(scene, device=dev, **KNOBS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, st_p = render.render_regen(scene, device=dev, **KNOBS)
    it = st["iterations"]
    busy_ms = device_us(prof) / 1e3
    n_kernels = sum(e.count for e in prof.key_averages())
    wall_ms = st["render_time"] * 1e3
    line = (f"slice window: {it} iterations, host {wall_ms / it:.3f} ms per "
            f"iteration, device busy {busy_ms / st_p['iterations']:.3f} ms "
            f"per iteration, {n_kernels / st_p['iterations']:.0f} kernels "
            f"per iteration, idle share {1 - busy_ms / wall_ms:.4f}")
    print(line, flush=True)
    report += [line, prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=25)]

    steps, window = 72, 36
    loss_fn, grad_fn = diff.make_diff_regen_renderer(
        scene, device=dev, fixed_steps=steps, remat_window=window, spp=4,
        **dict(KNOBS, retire_groups=8))
    dens = scene.medium.density
    grad_fn(dens)                                            # warm-up
    with torch.no_grad():
        _, t_loss = timed(lambda: loss_fn(dens))
    _, t_grad = timed(lambda: grad_fn(dens))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        timed(lambda: grad_fn(dens))
    busy_ms = device_us(prof) / 1e3
    n_kernels = sum(e.count for e in prof.key_averages())
    line = (f"gradient window: {steps} steps in windows of {window}: loss "
            f"alone {t_loss * 1e3 / steps:.3f} ms per step, gradient "
            f"{t_grad * 1e3 / steps:.3f} ms per step, device busy "
            f"{busy_ms / steps:.3f} ms per step, {n_kernels / steps:.0f} "
            f"kernels per step, idle share {1 - busy_ms / (t_grad * 1e3):.4f}")
    print(line, flush=True)
    report += [line, prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=25)]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(report) + "\n")
    return 0


if __name__ == "__main__":
    t0 = time.time()
    rc = main()
    print(f"profile_port: {time.time() - t0:.1f} s", flush=True)
    sys.exit(rc)
