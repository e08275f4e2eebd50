"""plytool CLI: mesh inspection and processing (port of
acceleratedvolrenderer_tpu/cli/plytool.py; pbrt cmd/plytool.cpp
subcommands info, cat, split, displace), on utils/ply.py.

    python -m acceleratedvolrenderer_tpu_torch.cli.plytool info mesh.ply
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..utils import ply


def cmd_info(args):
    for path in args.files:
        m = ply.read_ply(path)
        v = m["vertices"]
        f = m["faces"]
        lo, hi = v.min(0), v.max(0)
        print(f"{path}: {len(v)} vertices, {len(f)} triangles, "
              f"normals={'normals' in m}, uvs={'uvs' in m}")
        print(f"  bounds [{lo[0]:g} {lo[1]:g} {lo[2]:g}] - "
              f"[{hi[0]:g} {hi[1]:g} {hi[2]:g}]")
    return 0


def cmd_cat(args):
    m = ply.read_ply(args.files[0])
    for p in m["vertices"]:
        print(f"v {p[0]:g} {p[1]:g} {p[2]:g}")
    for f in m["faces"]:
        print(f"f {f[0]} {f[1]} {f[2]}")
    return 0


def cmd_split(args):
    """Split into chunks of at most --maxfaces triangles (plytool split)."""
    m = ply.read_ply(args.files[0])
    faces = m["faces"]
    n = max(args.maxfaces, 1)
    base = args.files[0].rsplit(".", 1)[0]
    for i in range(0, len(faces), n):
        chunk = faces[i:i + n]
        used = np.unique(chunk)
        remap = np.zeros(used.max() + 1, np.int32)
        remap[used] = np.arange(len(used))
        out = f"{base}_{i // n}.ply"
        ply.write_ply(out, m["vertices"][used], remap[chunk],
                      normals=m.get("normals", None)[used]
                      if m.get("normals") is not None else None)
        print(f"wrote {out} ({len(chunk)} tris)")
    return 0


def cmd_displace(args):
    """Displace vertices along normals by a scalar image lookup
    (plytool displace)."""
    from ..utils.image import read_exr

    m = ply.read_ply(args.files[0])
    if "normals" not in m or "uvs" not in m:
        print("displace requires normals and uvs", file=sys.stderr)
        return 1
    img, _, _ = read_exr(args.image)
    h, w = img.shape[:2]
    uv = np.clip(m["uvs"], 0, 1)
    x = np.minimum((uv[:, 0] * (w - 1)).astype(int), w - 1)
    y = np.minimum((uv[:, 1] * (h - 1)).astype(int), h - 1)
    d = img[y, x, 0] * args.scale
    v = m["vertices"] + m["normals"] * d[:, None]
    ply.write_ply(args.outfile, v, m["faces"], normals=m["normals"],
                  uvs=m["uvs"])
    print(f"wrote {args.outfile}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser("avrt-torch-plytool")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("info", "cat"):
        p = sub.add_parser(name)
        p.add_argument("files", nargs="+")
    p = sub.add_parser("split")
    p.add_argument("files", nargs=1)
    p.add_argument("--maxfaces", type=int, default=100000)
    p = sub.add_parser("displace")
    p.add_argument("files", nargs=1)
    p.add_argument("--image", required=True)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--outfile", required=True)
    args = ap.parse_args(argv)
    return {"info": cmd_info, "cat": cmd_cat, "split": cmd_split,
            "displace": cmd_displace}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
