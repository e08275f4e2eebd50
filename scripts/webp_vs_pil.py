"""The port's WebP writer (utils/webp_write.py) against PIL's Image.save on
seeded random images: how many files are PIL's byte for byte, and the
encode seconds of each side.  Needs PIL with WebP support and g++ (the
port's encoder builds on first use); runs on the CPU.

    python3 scripts/webp_vs_pil.py [--count N] [--seed S] [--big]

Each image is one of six kinds (uniform noise, checkerboards of random
cell size, sparse impulses on a flat colour, sinusoids, random 8x8
blocks, clipped normal noise), of random width and height in 1..199.
--big adds a 5800x5800 uniform noise image, large enough that libwebp's
first partition passes its 512 KiB limit on the first pass and the
macroblock loop runs again with fewer intra-4 header bits (about 30 s
for PIL and 60 s for the port on an 8-core Xeon).
"""
import argparse
import io
import sys
import time
from pathlib import Path

import numpy as np
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from acceleratedvolrenderer_tpu_torch.utils import webp_write  # noqa: E402


def image(rng, kind, w, h):
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "noise":
        a = rng.integers(0, 256, (h, w, 3))
    elif kind == "checker":
        c = rng.integers(1, 9)
        a = (((yy // c + xx // c) % 2) * 255)[..., None] * np.ones(3)
    elif kind == "impulses":
        a = np.full((h, w, 3), rng.integers(0, 256))
        m = rng.random((h, w)) < 0.02
        a[m] = rng.integers(0, 256, (int(m.sum()), 3))
    elif kind == "sines":
        a = 127 + 127 * np.sin(np.stack([xx / 7.0, yy / 11.0,
                                         (xx + yy) / 5.0], -1))
    elif kind == "blocks":
        a = rng.integers(0, 256, ((h + 7) // 8, (w + 7) // 8, 3))
        a = np.repeat(np.repeat(a, 8, 0), 8, 1)[:h, :w]
    else:
        a = rng.normal(128, 60, (h, w, 3))
    return np.clip(a, 0, 255).astype(np.uint8)


KINDS = ("noise", "checker", "impulses", "sines", "blocks", "normal")


def compare(px):
    """(equal, port seconds, PIL seconds) for one image."""
    t = time.perf_counter()
    ours = webp_write.encode_webp(px)
    t_ours = time.perf_counter() - t
    buf = io.BytesIO()
    t = time.perf_counter()
    Image.fromarray(px).save(buf, "WEBP")
    t_pil = time.perf_counter() - t
    return ours == buf.getvalue(), t_ours, t_pil


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--count", type=int, default=120)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--big", action="store_true")
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    webp_write.encode_webp(np.zeros((1, 1, 3), np.uint8))   # build the C++
    equal = 0
    for i in range(args.count):
        h, w = rng.integers(1, 200, 2)
        px = image(rng, KINDS[i % len(KINDS)], int(w), int(h))
        same, _, _ = compare(px)
        equal += same
        if not same:
            print(f"image {i} ({KINDS[i % len(KINDS)]}, {w}x{h}): the "
                  "files differ")
    print(f"{equal} of {args.count} random images: the port's file is "
          "PIL's byte for byte")
    if args.big:
        px = np.random.default_rng(2).integers(
            0, 256, (5800, 5800, 3)).astype(np.uint8)
        same, t_ours, t_pil = compare(px)
        print(f"5800x5800 noise: {'equal' if same else 'DIFFERENT'} files; "
              f"port {t_ours:.1f} s, PIL {t_pil:.1f} s")
        equal += same
        args.count += 1
    return 0 if equal == args.count else 1


if __name__ == "__main__":
    sys.exit(main())
