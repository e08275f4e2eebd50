"""cyhair2pbrt: CyHair (.hair, Cem Yuksel's format) to pbrt curves (port of
acceleratedvolrenderer_tpu/cli/cyhair2pbrt.py; pbrt cmd/cyhair2pbrt.cpp).

    python -m acceleratedvolrenderer_tpu_torch.cli.cyhair2pbrt in.hair out.pbrt

pbrt's converter loads strands, converts each to cubic
Bezier segments (Catmull-Rom through the strand points), and emits
`Shape "curve" "string type" ["cylinder"] "point3 P" [...] "float width0/1"`
statements our parser consumes directly.

CyHair layout: 4-byte magic "HAIR", uint32 strand count, uint32 total
point count, uint32 flags (bit0 segments array, bit1 points, bit2
thickness, bit3 transparency, bit4 colors), uint32 default segments,
float default thickness/transparency, 3 floats default color, 88-byte
info string; then the optional arrays.
"""
from __future__ import annotations

import argparse
import struct
import sys

import numpy as np


def read_cyhair(path: str):
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"HAIR":
            raise ValueError(f"{path}: not a CyHair file")
        n_strands, n_points, flags, d_segments = struct.unpack(
            "<IIII", f.read(16))
        d_thickness, d_transparency = struct.unpack("<ff", f.read(8))
        d_color = struct.unpack("<fff", f.read(12))
        f.read(88)  # info
        segments = (np.frombuffer(f.read(2 * n_strands), "<u2").astype(int)
                    if flags & 1 else np.full(n_strands, d_segments, int))
        if not flags & 2:
            raise ValueError(f"{path}: CyHair file without a points array")
        points = np.frombuffer(f.read(12 * n_points),
                               "<f4").reshape(-1, 3).copy()
        thickness = (np.frombuffer(f.read(4 * n_points), "<f4").copy()
                     if flags & 4 else np.full(n_points, d_thickness,
                                               np.float32))
    return segments, points, thickness


def strand_to_beziers(pts, widths):
    """Catmull-Rom through the strand points -> cubic Bezier segments
    (cyhair2pbrt.cpp's toCubicBezierCurves behavior)."""
    n = len(pts)
    if n < 2:
        return []
    out = []
    for i in range(n - 1):
        p0 = pts[max(i - 1, 0)]
        p1 = pts[i]
        p2 = pts[i + 1]
        p3 = pts[min(i + 2, n - 1)]
        b0 = p1
        b1 = p1 + (p2 - p0) / 6.0
        b2 = p2 - (p3 - p1) / 6.0
        b3 = p2
        out.append((np.stack([b0, b1, b2, b3]),
                    float(widths[i]), float(widths[i + 1])))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser("avrt-torch-cyhair2pbrt")
    ap.add_argument("hairfile")
    ap.add_argument("outfile")
    ap.add_argument("--max-strands", type=int, default=0,
                    help="limit strand count (0 = all)")
    ap.add_argument("--user-thickness", type=float, default=0.0,
                    help="override thickness (cyhair2pbrt's 3rd arg)")
    args = ap.parse_args(argv)

    segments, points, thickness = read_cyhair(args.hairfile)
    if args.user_thickness > 0:
        thickness = np.full_like(thickness, args.user_thickness)
    n_curves = 0
    off = 0
    with open(args.outfile, "w") as f:
        f.write(f'# Converted from "{args.hairfile}" by cyhair2pbrt\n')
        f.write(f"# The number of strands = {len(segments)}. "
                f"user_thickness = {args.user_thickness:f}\n\n")
        for si, seg in enumerate(segments):
            if args.max_strands and si >= args.max_strands:
                break
            npts = seg + 1
            pts = points[off:off + npts]
            ws = thickness[off:off + npts]
            off += npts
            for cp, w0, w1 in strand_to_beziers(pts, ws):
                f.write('Shape "curve" "string type" [ "cylinder" ] '
                        '"point3 P" [ ')
                f.write(" ".join(f"{v:f}" for v in cp.reshape(-1)))
                f.write(f' ] "float width0" [ {w0:f} ] '
                        f'"float width1" [ {w1:f} ]\n')
                n_curves += 1
    print(f"Converted {n_curves} curve segments "
          f"from {len(segments)} strands.", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
