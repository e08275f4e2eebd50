"""Rehearse chip_smoke.py's phase 28 (the scene file) on the CPU.

    python scripts/rehearse_scene_file.py [--width 64 --height 36 --grid 256]
    python scripts/rehearse_scene_file.py --compare [--width 320
        --height 180 --spp 4]

The first form runs chip_smoke.phase_scene_file on the CPU at a small frame
over a grid_res^3 cloud: the .nvdb write, nanovdb2pbrt, the parse and the
CLI's render with their seconds, and the fog-box checkpoint leg.  The
card's counters are stood in for by wrappers that count a launch where the
card would launch (march_block on the fused route, table_gather on the
window route), the peak-memory calls return 0, and the mean gate against
render() of the preset is off: it needs the 1280x720 frame, whose spp-1
noise is small enough for FULL_MEAN_TOL.

--compare renders presets.cloud and the same scene parsed from a .pbrt file
whose grid carries nanovdb2pbrt's extra background layer (grid_res + 1 per
axis over the same box) through render() on the CPU, and prints both
means: how far the converter's layer moves the frame, apart from the
spp-1 noise of phase 28's 1280x720 frame.
"""
import argparse
import io
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from acceleratedvolrenderer_tpu_torch.cli import nanovdb2pbrt  # noqa: E402
from acceleratedvolrenderer_tpu_torch.ops import gather, march  # noqa: E402
from acceleratedvolrenderer_tpu_torch.parallel import render  # noqa: E402
from acceleratedvolrenderer_tpu_torch.scene import parser, presets  # noqa: E402


def counting(mod, name):
    fn = getattr(mod, name)

    def wrapper(*args, **kw):
        mod.launches += 1
        return fn(*args, **kw)

    return wrapper


def rehearse(width, height, grid):
    cpu = torch.device("cpu")
    with mock.patch.object(torch.cuda, "reset_peak_memory_stats",
                           lambda d: None), \
            mock.patch.object(torch.cuda, "max_memory_allocated",
                              lambda d: 0), \
            mock.patch.object(march, "march_block",
                              counting(march, "march_block")), \
            mock.patch.object(gather, "table_gather",
                              counting(gather, "table_gather")), \
            mock.patch("acceleratedvolrenderer_tpu_torch.cli.pbrt._device",
                       lambda args: cpu), \
            mock.patch("acceleratedvolrenderer_tpu_torch.utils.device."
                       "resolve", lambda d=None: torch.device(d or "cpu")), \
            mock.patch.object(chip_smoke, "FULL_MEAN_TOL", float("inf")):
        scene = presets.cloud(width, height, spp=1, max_depth=16,
                              grid_res=grid, device=cpu)
        t0 = time.time()
        wave_img, st = render.render(scene, spp=1, device=cpu)
        print(f"render() of the preset: {time.time() - t0:.2f} s, "
              f"{st['iterations']} iterations", flush=True)
        print(chip_smoke.phase_scene_file(cpu, scene, wave_img, "the CPU"))


def compare(width, height, grid, spp):
    sc0 = presets.cloud(width, height, spp=spp, max_depth=16, grid_res=grid,
                        device="cpu")
    padded = np.zeros((grid + 1,) * 3, np.float32)
    padded[:grid, :grid, :grid] = sc0.medium.density.numpy()
    block = io.StringIO()
    nanovdb2pbrt.emit_pbrt(padded, [-100.0] * 3, [100.0] * 3, "density",
                           block)
    sc = parser.PbrtParser(device="cpu").parse_string(
        chip_smoke.scene_file_text(block.getvalue(), width, height))
    means = [float(render.render(s, spp=spp, device="cpu")[0].mean())
             for s in (sc0, sc)]
    print(f"{width}x{height} spp {spp}, grid {grid}^3: preset mean "
          f"{means[0]:.6f}, scene file ({grid + 1}^3) mean {means[1]:.6f}, "
          f"rel diff {abs(means[1] - means[0]) / means[0]:.4e}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--compare", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(4)
    if args.compare:
        compare(args.width or 320, args.height or 180, args.grid, args.spp)
    else:
        rehearse(args.width or 64, args.height or 36, args.grid)


if __name__ == "__main__":
    main()
