"""chip_smoke.py's phases 32 (image formats), 33 (image writers, which
converts phase 32's map frame), 34 (block-compressed maps, which reuses
phase 32's medium file, ground samples and 8-bit TIFF and holds its
frame's mean against phase 32's uniform sky's), 35 (JPEG 2000 maps,
which reuses the medium file and the mean), 36 (more image writers,
which converts phase 35's frame), 38 (PIL-only maps, which reuses the
medium file, the ground samples and the mean), 39 (AVIF maps, which
reuses the medium file and the mean), 40 (AVIF tools maps, as 39) and
41 (AVIF screen and grain maps, as 39) alone on the CUDA
card, with the phases they need: 8 (the 1280x720 cloud over the 256^3
grid), 14 (its wave frame) and 28 (the grid through a .nvdb and
nanovdb2pbrt into the block phase 32 Includes, and the CLI's frame
written as PNG), then 37 (the decodes of the committed fixtures of
utils/image_read_more.py's and utils/image_read_pil.py's formats and of
the AVIF crops, which the full script runs in its side process).

    python3 scripts/phase32_alone.py [--frame-out PATH] [--maps-only]

--maps-only skips phases 33-38 and runs 39-41 (and 37) after 32.

--frame-out copies phase 32's map frame (the EXR phase 33 converts) to
PATH.  Needs one CUDA card; it builds the kernels (nvcc).
"""
import argparse
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    from acceleratedvolrenderer_tpu_torch import kernels

    ap = argparse.ArgumentParser()
    ap.add_argument("--frame-out")
    ap.add_argument("--maps-only", action="store_true")
    args = ap.parse_args()

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    kernels.library()
    _, scene, slice_rec = cs.timed("slice", cs.phase_slice, dev, card)
    wave_img = cs.timed("wave full", cs.phase_wave_full, dev, scene,
                        slice_rec[0], card)
    with tempfile.TemporaryDirectory() as keep:
        cs.timed("scene file", cs.phase_scene_file, dev, scene, wave_img,
                 card, keep)
        *formats, uniform_mean = cs.timed(
            "image formats", cs.phase_image_formats, dev, keep, card)
        print(formats, uniform_mean)
        if args.frame_out:
            Path(args.frame_out).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(Path(keep) / cs.IMAGE_MAP_FRAME, args.frame_out)
        if not args.maps_only:
            print(cs.timed("image writers", cs.phase_image_writers, keep,
                           card))
            print(cs.timed("block maps", cs.phase_block_maps, dev, keep,
                           uniform_mean, card))
            print(cs.timed("JPEG 2000 maps", cs.phase_j2k_maps, dev, keep,
                           uniform_mean, card))
            print(cs.timed("more image writers", cs.phase_more_writers,
                           keep, card))
            print(cs.timed("PIL-only maps", cs.phase_pil_only_maps, dev,
                           keep, uniform_mean, card))
        print(cs.timed("AVIF maps", cs.phase_avif_maps, dev, keep,
                       uniform_mean, card))
        print(cs.timed("AVIF tools maps", cs.phase_avif_tools_maps, dev,
                       keep, uniform_mean, card))
        print(cs.timed("AVIF screen and grain maps",
                       cs.phase_avif_screen_grain_maps, dev, keep,
                       uniform_mean, card))
    cs.timed("read formats", cs.phase_read_formats, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
