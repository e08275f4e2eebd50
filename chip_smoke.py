#!/usr/bin/env python
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. device: requires CUDA; prints the card and its power limit;
  2. build: compiles the CUDA kernels from acceleratedvolrenderer_tpu_torch/csrc
     with nvcc into build/kernels/ and prints the build time;
  3. kernel vs plain: the march kernel against its eager PyTorch version on
     random lanes (N 16384 and 1000, K 1/8/16, 16^3/32^3/64^3 tables,
     residual mode off and on): integers and flags equal, floats to
     rtol 1e-6; times both at the render's shape (N 16384, K 8, 16^3);
  4. small frame: the 32x24 test cloud rendered through the port on the GPU
     and on the CPU must agree (frame means to 1e-3 relative, >= 99% of
     pixels to rtol 1e-3 / atol 1e-5: transcendental functions differ by
     ulps between the two, and one flipped choice reroutes a sample);
  5. slice: the 1280x720 cloud over the 256^3 grid, 16384 lanes, the bench
     knobs, spp 16: one warm-up render, then one timed render.  The film
     must be finite with a positive mean, and the march kernel must have
     launched exactly once per loop iteration.
The last two lines are the kernels' JSON record and the result JSON.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

SPP = 16
SMALL = dict(width=32, height=24, spp=4, max_depth=8, grid_res=32)
SMALL_KNOBS = dict(n_lanes=256, k_substeps=8, stochastic_filter=True,
                   accum_spp=True, retire_groups=4, work_stride="auto")
BENCH_KNOBS = dict(k_substeps=8, stochastic_filter=True, accum_spp=True,
                   work_stride="auto", retire_groups=32, n_lanes=16384)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def to_dev(lanes, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in lanes.items()}


def compare_march(a, b):
    """Equal integers / flags, floats to rtol 1e-6; returns max |a - b|."""
    err = 0.0
    for k in a:
        x, y = a[k].cpu().numpy(), b[k].cpu().numpy()
        if x.dtype.kind in "biu":
            if not np.array_equal(x, y):
                raise AssertionError(f"march {k}: {int((x != y).sum())} "
                                     "lanes differ")
            continue
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=0, err_msg=k)
        fin = np.isfinite(x) & np.isfinite(y)
        if fin.any():
            err = max(err, float(np.abs(x[fin] - y[fin]).max()))
    return err


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernel(dev):
    from acceleratedvolrenderer_tpu_torch.ops import march

    max_err = 0.0
    cases = 0
    for n in (16384, 1000):
        for res in ((16, 16, 16), (32, 32, 32), (64, 64, 64)):
            for residual in (False, True):
                lanes = to_dev(march.random_lanes(n, res, seed=n + res[0],
                                                  residual=residual), dev)
                for K in (1, 8, 16):
                    out = march.march_block(K=K, maj_res=res, **lanes)
                    ref = march.march_block_plain(K=K, maj_res=res, **lanes)
                    torch.cuda.synchronize()
                    max_err = max(max_err, compare_march(out, ref))
                    cases += 1
    lanes = to_dev(march.random_lanes(16384, (16, 16, 16), seed=7), dev)
    kw = dict(K=8, maj_res=(16, 16, 16), **lanes)
    ms = time_ms(lambda: march.march_block(**kw), 200)
    plain_ms = time_ms(lambda: march.march_block_plain(**kw), 20)
    print(f"kernel vs plain: {cases} cases equal, max |err| {max_err:.3e}; "
          f"N 16384 K 8 16^3: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
          flush=True)
    return max_err, ms, plain_ms


def phase_small_frame(dev):
    from acceleratedvolrenderer_tpu_torch.ops import march
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import presets

    imgs, runs = [], []
    for d in (dev, torch.device("cpu")):
        scene = presets.cloud(**SMALL, device=d)
        before = march.launches
        img, st = render.render_regen(scene, device=d, **SMALL_KNOBS)
        imgs.append(img)
        runs.append((st["iterations"], march.launches - before))
    gpu, cpu = imgs
    if gpu.shape != (24, 32, 3) or not np.isfinite(gpu).all():
        raise AssertionError("small frame: bad shape or non-finite pixels")
    if runs[0][1] != runs[0][0] or runs[1][1] != 0:
        raise AssertionError(f"small frame: (iterations, launches) {runs}")
    rel = abs(gpu.mean() - cpu.mean()) / cpu.mean()
    close = np.isclose(gpu, cpu, rtol=1e-3, atol=1e-5).all(-1).mean()
    print(f"small frame gpu vs cpu: mean {gpu.mean():.7f} vs "
          f"{cpu.mean():.7f} (rel diff {rel:.3e}), max |diff| "
          f"{np.abs(gpu - cpu).max():.3e}, pixels close {close:.4f}, "
          f"(iterations, launches) gpu {runs[0]} cpu {runs[1]}", flush=True)
    if not (rel < 1e-3 and close >= 0.99):
        raise AssertionError("small frame: GPU and CPU renders disagree")


def phase_slice(dev, card):
    from acceleratedvolrenderer_tpu_torch.ops import march
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import presets

    t0 = time.time()
    scene = presets.cloud(1280, 720, spp=SPP, max_depth=16, grid_res=256,
                          device=dev)
    scene.max_march_steps = 4096
    print(f"scene built in {time.time() - t0:.1f} s", flush=True)
    render.render_regen(scene, device=dev, record_alive=True,
                        **BENCH_KNOBS)                       # warm-up
    march.launches = 0
    img, st = render.render_regen(scene, device=dev, record_alive=True,
                                  **BENCH_KNOBS)
    launches = march.launches
    if img.shape != (720, 1280, 3) or not np.isfinite(img).all():
        raise AssertionError("slice: bad shape or non-finite film")
    if not img.mean() > 0:
        raise AssertionError("slice: film mean is not positive")
    if not (st["iterations"] > 0 and launches == st["iterations"]):
        raise AssertionError(f"slice: {launches} march launches for "
                             f"{st['iterations']} loop iterations")
    mrays = 1280 * 720 * SPP / st["render_time"] / 1e6
    print(f"slice 1280x720 spp {SPP} grid 256^3 lanes 16384: "
          f"{st['iterations']} iterations, occupancy {st['occupancy']:.4f}, "
          f"{st['render_time']:.3f} s, {mrays:.4f} Mrays/s, film mean "
          f"{img.mean():.6f} on {card}", flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name} ({torch.cuda.device_count()} visible)", flush=True)
    print(f"card: {card}", flush=True)

    from acceleratedvolrenderer_tpu_torch import kernels

    kernels.library()
    built = ("reused " + str(kernels.LIB_PATH) if kernels.build_seconds is None
             else f"{kernels.build_seconds:.1f} s")
    print(f"build: {built}\n{kernels.build_log.strip()}", flush=True)

    max_err, ms, plain_ms = phase_kernel(dev)
    phase_small_frame(dev)
    launches = phase_slice(dev, card)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "march_block", "route": "cuda",
        "source": "acceleratedvolrenderer_tpu_torch/csrc/march.cu",
        "replaces": "acceleratedvolrenderer_tpu/ops/pallas_march.py:105",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
