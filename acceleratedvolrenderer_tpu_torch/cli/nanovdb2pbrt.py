"""nanovdb2pbrt: a density grid -> pbrt "uniformgrid" parameter text
(port of acceleratedvolrenderer_tpu/cli/nanovdb2pbrt.py; numpy only).

Reads a NanoVDB FogVolume grid (utils/nvdb.py: NONE, ZIP and BLOSC codecs)
or a dense array (.npy, .npz with a named array, raw float32 with --dims)
and prints the `"integer nx/ny/nz"`, `"point3 p0"/"p1"`, `"float density"
[ ... ]` block that drops into a `MakeNamedMedium "..." "string type"
"uniformgrid"` statement.  A .nvdb grid is densified over
[indexBBox.min, indexBBox.max + 1] (one layer of background past the
stored voxels, as pbrt's converter does) and p0/p1 come from its
worldBBox.  --downsample halves the resolution N times by 2x2x2 mean
pooling.  The text is character for character the reference's.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def load_nvdb(path: str, grid: str):
    """Densify a .nvdb float grid with the reference converter's exact
    semantics: values over the inclusive index bbox plus one extra layer
    (tree getValue returns background outside stored nodes), world-space
    p0/p1 = the grid's worldBBox (nanovdb2pbrt.cpp:97-116)."""
    from ..utils import nvdb

    g = nvdb.read_nvdb(path, grid)
    if not (g.is_fog_volume or g.grid_class == nvdb.GRID_CLASS_UNKNOWN):
        raise SystemExit(f'{path}: "{grid}" isn\'t a FogVolume grid?')
    nz, ny, nx = g.data.shape
    arr = np.full((nz + 1, ny + 1, nx + 1), g.background, np.float32)
    arr[:nz, :ny, :nx] = g.data
    return arr, g.world_bbox[0], g.world_bbox[1]


def load_grid(path: str, grid: str, dims=None):
    if path.endswith(".npy"):
        arr = np.load(path)
    elif path.endswith(".npz"):
        data = np.load(path)
        if grid in data:
            arr = data[grid]
        elif len(data.files) == 1:
            arr = data[data.files[0]]
        else:
            raise SystemExit(
                f"{path}: grid '{grid}' not found (have {data.files})")
    elif path.endswith(".raw") or path.endswith(".bin"):
        if dims is None:
            raise SystemExit("raw input requires --dims nx,ny,nz")
        nx, ny, nz = dims
        arr = np.fromfile(path, np.float32)
        if arr.size != nx * ny * nz:
            raise SystemExit(
                f"{path}: {arr.size} floats != {nx}*{ny}*{nz}")
        arr = arr.reshape(nz, ny, nx)
    else:
        raise SystemExit(f"{path}: unsupported input (npy/npz/raw)")
    if arr.ndim != 3:
        raise SystemExit(f"{path}: expected 3D grid, got {arr.shape}")
    return np.asarray(arr, np.float32)


def downsample2(arr: np.ndarray) -> np.ndarray:
    """2x2x2 mean pooling (pad odd dims by edge replication)."""
    nz, ny, nx = arr.shape
    pz, py, px = nz % 2, ny % 2, nx % 2
    if pz or py or px:
        arr = np.pad(arr, ((0, pz), (0, py), (0, px)), mode="edge")
    z, y, x = arr.shape
    return arr.reshape(z // 2, 2, y // 2, 2, x // 2, 2).mean((1, 3, 5))


def _grid_text(flat: np.ndarray) -> str:
    """The values of `flat` as the reference prints them: "0" for a zero,
    else "%f" of the value; a newline after every 20th value, a space after
    the others.  Formatted from float64 copies in bulk (the same
    characters as formatting each float32 value, in a fraction of the
    time)."""
    parts = ["0" if d == 0 else f"{d:f}"
             for d in flat.astype(np.float64).tolist()]
    n = len(parts)
    if n == 0:
        return ""
    lines = [" ".join(parts[i:i + 20]) for i in range(0, n, 20)]
    return "\n".join(lines) + ("\n" if n % 20 == 0 else " ")


def emit_pbrt(arr: np.ndarray, p0, p1, grid_name: str, out=sys.stdout):
    nz, ny, nx = arr.shape
    out.write(f'"integer nx" {nx} "integer ny" {ny}  "integer nz" {nz}\n')
    out.write('\t"point3 p0" [ %f %f %f ] "point3 p1" [ %f %f %f ]\n'
              % (p0[0], p0[1], p0[2], p1[0], p1[1], p1[2]))
    out.write(f'\t"float {grid_name}" [\n')
    out.write(_grid_text(arr.reshape(-1)))
    out.write("]\n")


def main(argv=None):
    ap = argparse.ArgumentParser(
        "avrt-nanovdb2pbrt",
        description="dense density grid -> pbrt uniformgrid parameters")
    ap.add_argument("filename")
    ap.add_argument("--grid", default="density",
                    help='array name inside .npz (default "density")')
    ap.add_argument("--downsample", type=int, default=0,
                    help="halve resolution this many times (2x2x2 mean)")
    ap.add_argument("--dims", default=None,
                    help="nx,ny,nz for raw float32 input")
    ap.add_argument("--p0", default="0,0,0", help="world-space min corner")
    ap.add_argument("--p1", default="1,1,1", help="world-space max corner")
    ap.add_argument("-o", "--outfile", default=None)
    args = ap.parse_args(argv)

    dims = tuple(int(x) for x in args.dims.split(",")) if args.dims else None
    if args.filename.endswith(".nvdb"):
        arr, p0, p1 = load_nvdb(args.filename, args.grid)
    else:
        arr = load_grid(args.filename, args.grid, dims)
        p0 = [float(x) for x in args.p0.split(",")]
        p1 = [float(x) for x in args.p1.split(",")]
    for _ in range(max(args.downsample, 0)):
        arr = downsample2(arr)
    if args.outfile:
        with open(args.outfile, "w") as fh:
            emit_pbrt(arr, p0, p1, args.grid, fh)
    else:
        emit_pbrt(arr, p0, p1, args.grid)
    return 0


if __name__ == "__main__":
    sys.exit(main())
