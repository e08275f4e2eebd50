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
  4. gather kernel vs plain: the table gather against its eager version,
     V 128 / 1000 / 4096 / 32768 / 64^3 (staged in shared memory, or read
     in place above the opt-in limit) and n 100 / 96*8 / 208*8 / 1000*8 /
     16384*8 random indices (a few out of range), bitwise equal, one
     launch each; times both at n 16384*8, V 4096; the window route of the
     march step on the card against the plain march (N 1000, 208 and
     16384, K 8, 16^3), as phase 3 compares, one gather launch each;
  5. small frame: the 32x24 test cloud rendered through the port on the GPU
     and on the CPU must agree (frame means to 1e-3 relative, >= 99% of
     pixels to rtol 1e-3 / atol 1e-5: transcendental functions differ by
     ulps between the two, and one flipped choice reroutes a sample);
  6. window frame: the same cloud at 208 lanes (208 % 128 != 0: the window
     route) on the GPU.  The gather kernel must launch once per loop
     iteration and the march kernel never; the frame must agree, at phase
     5's tolerances, with the CPU render at 208 lanes and with phase 5's
     GPU frame at 256 lanes (the fused route): per-sample estimates do not
     depend on the lane count.  Then the two routes at the same 208 lanes,
     alternated twice (the fused route forced by patching march.available):
     frames agree at phase 5's tolerances, and the host ms per loop
     iteration of each;
  7. gradient FD gate: d(mean film)/d(density) of a 16x12 cloud (16^3
     grid, spp 2, max_depth 4) at 96 lanes (window route) and 128 lanes
     (fused route); central differences on the 3 largest-gradient voxels
     equal the gradient to 1%;
  8. slice: the 1280x720 cloud over the 256^3 grid, 16384 lanes, the bench
     knobs, spp 16: one warm-up render, then one timed render.  The film
     must be finite with a positive mean, and the march kernel must have
     launched exactly once per loop iteration;
  9. full-frame gradient: the same scene at spp 4 (bench.py's backward
     leg): a record_alive forward gives the iterations, then the gradient
     over int(1.12 * iterations) + 16 checkpointed steps in windows of
     max(sqrt(steps), 16).  Loss finite and positive, gradient finite with
     a nonzero maximum, and the march kernel launched twice per step run
     (forward sweep and recompute); prints the seconds, Mrays/s and peak
     device memory.
The last two lines are the kernels' JSON record and the result JSON.
"""
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

SPP = 16
GRAD_SPP = 4
SMALL = dict(width=32, height=24, spp=4, max_depth=8, grid_res=32)
SMALL_KNOBS = dict(n_lanes=256, k_substeps=8, stochastic_filter=True,
                   accum_spp=True, retire_groups=4, work_stride="auto")
WINDOW_LANES = 208
BENCH_KNOBS = dict(k_substeps=8, stochastic_filter=True, accum_spp=True,
                   work_stride="auto", retire_groups=32, n_lanes=16384)
GRAD_SMALL = dict(width=16, height=12, spp=2, max_depth=4, grid_res=16)
GRAD_SMALL_KW = dict(fixed_steps=96, spp=2, accum_spp=True, retire_groups=2,
                     k_substeps=8, stochastic_filter=True, remat_window=16,
                     work_stride="auto")


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


def phase_gather(dev):
    from acceleratedvolrenderer_tpu_torch.ops import gather, march

    cases, err = 0, 0.0
    for v in (128, 1000, 4096, 32768, 64 ** 3):
        for n in (100, 96 * 8, 208 * 8, 1000 * 8, 16384 * 8):
            rng = np.random.default_rng(v + n)
            table = torch.as_tensor(
                rng.uniform(0.0, 2.0, v).astype(np.float32), device=dev)
            idx = rng.integers(0, v, n).astype(np.int32)
            idx[:3] = [-1, v, v + 77]
            idx = torch.as_tensor(idx.reshape(-1, 8) if n % 8 == 0 else idx,
                                  device=dev)
            before = gather.launches
            out = gather.table_gather(table, idx)
            ref = gather.table_gather_plain(table, idx)
            torch.cuda.synchronize()
            if gather.launches != before + 1 or not torch.equal(out, ref):
                raise AssertionError(f"gather V {v} n {n}: kernel and plain "
                                     "disagree or the kernel did not launch")
            err = max(err, float((out - ref).abs().max()))
            cases += 1
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.uniform(0.0, 2.0, 4096).astype(np.float32),
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, 4096, (16384, 8)).astype(np.int32),
                          device=dev)
    ms = time_ms(lambda: gather.table_gather(table, idx), 200)
    plain_ms = time_ms(lambda: gather.table_gather_plain(table, idx), 200)
    win_err = 0.0
    for n in (1000, WINDOW_LANES, 16384):
        lanes = to_dev(march.random_lanes(n, (16, 16, 16), seed=n), dev)
        kw = dict(K=8, maj_res=(16, 16, 16), **lanes)
        before = (march.launches, gather.launches)
        out = march.march_window(**kw)
        if (march.launches, gather.launches) != (before[0], before[1] + 1):
            raise AssertionError(f"window route N {n}: the gather kernel "
                                 "must launch once and the march kernel "
                                 "never")
        win_err = max(win_err, compare_march(out,
                                             march.march_block_plain(**kw)))
    print(f"gather vs plain: {cases} cases bitwise equal; n 16384*8 V 4096: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; window route vs "
          f"plain march (N 1000, {WINDOW_LANES} and 16384, K 8): equal, one "
          f"gather launch each, max |err| {win_err:.3e}", flush=True)
    return err, ms, plain_ms


def compare_frames(what, a, b):
    """Frame means to 1e-3 relative and >= 99% of pixels to rtol 1e-3 /
    atol 1e-5 (see phase 5)."""
    rel = abs(a.mean() - b.mean()) / b.mean()
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1).mean()
    print(f"{what}: mean {a.mean():.7f} vs {b.mean():.7f} (rel diff "
          f"{rel:.3e}), max |diff| {np.abs(a - b).max():.3e}, pixels close "
          f"{close:.4f}", flush=True)
    if not (rel < 1e-3 and close >= 0.99):
        raise AssertionError(f"{what}: frames disagree")


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
    print(f"small frame: (iterations, launches) gpu {runs[0]} cpu "
          f"{runs[1]}", flush=True)
    if runs[0][1] != runs[0][0] or runs[1][1] != 0:
        raise AssertionError(f"small frame: (iterations, launches) {runs}")
    compare_frames("small frame gpu vs cpu", gpu, cpu)
    return gpu


def phase_window_frame(dev, fused_gpu):
    from acceleratedvolrenderer_tpu_torch.ops import gather, march
    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import presets

    knobs = dict(SMALL_KNOBS, n_lanes=WINDOW_LANES)
    march.launches = gather.launches = 0
    img, st = render.render_regen(presets.cloud(**SMALL, device=dev),
                                  device=dev, **knobs)
    counts = (march.launches, gather.launches)
    cpu, _ = render.render_regen(
        presets.cloud(**SMALL, device=torch.device("cpu")),
        device=torch.device("cpu"), **knobs)
    print(f"window frame ({WINDOW_LANES} lanes): {st['iterations']} "
          f"iterations, (march, gather) launches {counts}", flush=True)
    if img.shape != (24, 32, 3) or not np.isfinite(img).all():
        raise AssertionError("window frame: bad shape or non-finite pixels")
    if counts != (0, st["iterations"]):
        raise AssertionError("window frame: the gather kernel must launch "
                             "once per iteration and the march kernel never")
    compare_frames("window frame gpu vs cpu", img, cpu)
    compare_frames("window frame vs fused frame (256 lanes, gpu)", img,
                   fused_gpu)
    scene = presets.cloud(**SMALL, device=dev)
    ms = {"window": [], "fused": []}
    for route in ("window", "fused", "window", "fused"):
        with mock.patch.object(march, "available",
                               lambda v, n: route == "fused"):
            march.launches = gather.launches = 0
            img_r, st_r = render.render_regen(scene, device=dev, **knobs)
        it = st_r["iterations"]
        want = (0, it) if route == "window" else (it, 0)
        if (march.launches, gather.launches) != want:
            raise AssertionError(f"{route} route at {WINDOW_LANES} lanes: "
                                 f"(march, gather) launches "
                                 f"{(march.launches, gather.launches)}")
        compare_frames(f"{route} route at {WINDOW_LANES} lanes vs window "
                       "frame", img_r, img)
        ms[route].append(st_r["render_time"] * 1e3 / it)
    print(f"routes at {WINDOW_LANES} lanes (equal frames; host ms per "
          f"iteration, alternated): window {ms['window']}, fused "
          f"{ms['fused']}", flush=True)
    return counts[1]


def phase_grad_fd(dev):
    from acceleratedvolrenderer_tpu_torch.ops import gather, march
    from acceleratedvolrenderer_tpu_torch.parallel import diff
    from acceleratedvolrenderer_tpu_torch.scene import presets

    eps = 2e-3
    steps = GRAD_SMALL_KW["fixed_steps"]
    for n_lanes, route in ((96, "window"), (128, "fused")):
        scene = presets.cloud(**GRAD_SMALL, device=dev)
        loss_fn, grad_fn = diff.make_diff_regen_renderer(
            scene, device=dev, n_lanes=n_lanes, **GRAD_SMALL_KW)
        dens = scene.medium.density
        march.launches = gather.launches = 0
        g = grad_fn(dens)
        counts = (march.launches, gather.launches)
        want = (0, 2 * steps) if route == "window" else (2 * steps, 0)
        if counts != want:
            raise AssertionError(f"grad fd {route}: (march, gather) "
                                 f"launches {counts}, expected {want}")
        g = g.cpu().numpy()
        if not (np.isfinite(g).all() and np.abs(g).max() > 0):
            raise AssertionError(f"grad fd {route}: gradient not finite or "
                                 "identically zero")
        rows = []
        for fi in np.argsort(np.abs(g).reshape(-1))[::-1][:3]:
            e = torch.zeros(dens.numel(), device=dev)
            e[int(fi)] = eps
            e = e.reshape(dens.shape)
            with torch.no_grad():
                fd = (float(loss_fn(dens + e))
                      - float(loss_fn(dens - e))) / (2 * eps)
            ad = float(g.reshape(-1)[fi])
            rows.append(f"voxel {int(fi)} fd {fd:.6e} ad {ad:.6e}")
            if abs(fd - ad) > 1e-2 * max(abs(fd), abs(ad), 1e-3):
                raise AssertionError(f"grad fd {route}: {rows[-1]}")
        print(f"grad fd == ad ({route} route, {n_lanes} lanes, (march, "
              f"gather) launches {counts}): " + "; ".join(rows), flush=True)


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
    return launches, scene


def phase_grad_full(dev, scene, card):
    from acceleratedvolrenderer_tpu_torch.ops import gather, march
    from acceleratedvolrenderer_tpu_torch.parallel import diff, render

    H, W = scene.height, scene.width
    groups = min(32, 2 * GRAD_SPP)
    knobs = dict(n_lanes=16384, k_substeps=8, stochastic_filter=True,
                 accum_spp=True, retire_groups=groups, work_stride="auto")
    run, density, majorant = render.make_regen_renderer(
        scene, device=dev, spp=GRAD_SPP, record_alive=True, **knobs)
    res = run(density, majorant,
              torch.zeros((3 * (H * W + 1),), dtype=torch.float32,
                          device=dev))
    iters = int((res.alive_hist > 0).sum())
    steps = int(iters * 1.12) + 16
    window = max(int(np.sqrt(steps)), 16)
    n_win = -(-steps // window)
    loss_fn, grad_fn = diff.make_diff_regen_renderer(
        scene, device=dev, fixed_steps=steps, spp=GRAD_SPP,
        remat_window=window, **knobs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    march.launches = gather.launches = 0
    t0 = time.time()
    g = grad_fn(density)
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = (march.launches, gather.launches)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        loss = float(loss_fn(density))
    g_max = float(g.abs().max())
    mrays = H * W * GRAD_SPP / dt / 1e6
    print(f"grad full frame {W}x{H} spp {GRAD_SPP} grid 256^3 lanes 16384 "
          f"groups {groups}: forward {iters} live iterations, fixed_steps "
          f"{steps}, remat_window {window} ({n_win} windows), grad step "
          f"{dt:.3f} s, {mrays:.4f} Mrays/s (grad_density), peak device "
          f"memory {peak / 2**30:.3f} GiB, loss {loss:.6e}, max |grad| "
          f"{g_max:.4e}, (march, gather) launches {counts} on {card}",
          flush=True)
    if not (np.isfinite(loss) and loss > 0):
        raise AssertionError("grad full frame: loss not finite and positive")
    if not (bool(torch.isfinite(g).all()) and g_max > 0):
        raise AssertionError("grad full frame: gradient not finite or zero")
    if counts != (2 * n_win * window, 0):
        raise AssertionError(f"grad full frame: (march, gather) launches "
                             f"{counts}, expected ({2 * n_win * window}, 0)")
    return counts[0]


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
    g_err, g_ms, g_plain_ms = phase_gather(dev)
    fused_gpu = phase_small_frame(dev)
    g_launches = phase_window_frame(dev, fused_gpu)
    phase_grad_fd(dev)
    launches, scene = phase_slice(dev, card)
    phase_grad_full(dev, scene, card)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "march_block", "route": "cuda",
        "source": "acceleratedvolrenderer_tpu_torch/csrc/march.cu",
        "replaces": "acceleratedvolrenderer_tpu/ops/pallas_march.py:105",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms}, {
        "name": "table_gather", "route": "cuda",
        "source": "acceleratedvolrenderer_tpu_torch/csrc/gather.cu",
        "replaces": "acceleratedvolrenderer_tpu/ops/pallas_gather.py:33",
        "launches": g_launches, "max_abs_err": g_err, "ms": g_ms,
        "plain_ms": g_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
