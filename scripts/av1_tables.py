"""Write acceleratedvolrenderer_tpu_torch/native/av1_tables.h, the tables
of the AV1 intra decoder (native/av1_dec.cpp).

The default CDFs and the constant tables of the AV1 specification are
copied out of the libavif shared object that Pillow bundles (it links
libaom, whose tables follow the specification's layout, and dav1d); the
scan orders, the cosine table and the self-guided filter's reciprocals
are derived here and held to the library's copies.  Each table is found
by its offset in that file and checked against values of the
specification before it is written; a wrong entry would show as a
mismatch in tests/test_torch_image_formats_avif.py.

Run it where Pillow 12.1.0's wheel is installed:

    python scripts/av1_tables.py            # rewrites the header
    python scripts/av1_tables.py --check    # exits 1 if the header differs

Nothing reads the shared object at run time: the decoder includes the
committed header.
"""
from __future__ import annotations

import argparse
import glob
import math
import sys
from pathlib import Path

import numpy as np

OUT = (Path(__file__).resolve().parents[1] / "acceleratedvolrenderer_tpu_torch"
       / "native" / "av1_tables.h")
SO_GLOB = "libavif-01e67780.so.16.3.0"


def _library() -> bytes:
    import PIL

    libs = Path(PIL.__file__).resolve().parents[1] / "pillow.libs"
    hits = glob.glob(str(libs / SO_GLOB))
    if not hits:
        sys.exit(f"av1_tables: {SO_GLOB} not found under {libs}")
    return Path(hits[0]).read_bytes()


class Lib:
    def __init__(self, data: bytes):
        self.b = data

    def arr(self, off, dtype, shape):
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        return np.frombuffer(self.b[off:off + n], dtype).reshape(shape).copy()


def _check_cdf(v, n, where):
    """v: a CDF of n symbols in the decoder's layout (n - 1 inverted
    probabilities, 0, a zero counter)."""
    v = [int(x) for x in v]
    if len(v) != n + 1 or v[n - 1] != 0 or v[n] != 0:
        raise SystemExit(f"av1_tables: {where}: not an {n}-symbol CDF: {v}")
    if any(b > a for a, b in zip(v[:n - 1], v[1:n])) or not 0 < v[0] < 32768:
        raise SystemExit(f"av1_tables: {where}: not decreasing: {v}")


def aom_cdfs(lib, off, shape, stride, nsyms):
    """aom's layout: each CDF takes `stride` uint16, the first nsyms + 1
    of them the decoder's layout."""
    a = lib.arr(off, np.uint16, (*shape, stride))[..., :nsyms + 1]
    for idx in np.ndindex(*shape):
        _check_cdf(a[idx], nsyms, f"{off:#x}{list(idx)}")
    return a


def dav1d_cdfs(lib, off, shape, stride, nsyms):
    """dav1d's layout: n - 1 inverted probabilities, the counter, padding."""
    a = lib.arr(off, np.uint16, (*shape, stride))[..., :nsyms - 1]
    z = np.zeros((*shape, 2), np.uint16)
    a = np.concatenate([a, z], -1)
    for idx in np.ndindex(*shape):
        _check_cdf(a[idx], nsyms, f"{off:#x}{list(idx)}")
    return a


def _spec_probe(a, idx, first):
    got = [32768 - int(x) for x in a[idx][:len(first)]]
    if got != list(first):
        raise SystemExit(f"av1_tables: {idx}: {got} is not the "
                         f"specification's {first}")


def scan(w, h):
    """The specification's default scan of a w x h block (raster index
    row * w + col): zig-zag for squares, one-way diagonals otherwise."""
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]
        if w > h or w == h:
            cells = cells[::-1]
        if w == h and d % 2 == 1:
            cells = cells[::-1]
        out += [r * w + c for r, c in cells]
    return out


# the specification's Cdef_Directions ((dy, dx) of each direction's two
# taps) and Cdef_Uv_Dir[subsampling_x][subsampling_y][direction]
CDEF_DIRECTIONS = [[(-1, 1), (-2, 2)], [(0, 1), (-1, 2)], [(0, 1), (0, 2)],
                   [(0, 1), (1, 2)], [(1, 1), (2, 2)], [(1, 0), (2, 1)],
                   [(1, 0), (2, 0)], [(1, 0), (2, -1)]]
CDEF_UV_DIR = [[[0, 1, 2, 3, 4, 5, 6, 7], [1, 2, 2, 2, 3, 4, 6, 0]],
               [[7, 0, 2, 4, 5, 6, 6, 6], [0, 1, 2, 3, 4, 5, 6, 7]]]


def build(lib) -> dict:
    t = {}
    # --- default CDFs (libaom's copies, dav1d's where aom's are folded)
    t["kf_y_mode"] = aom_cdfs(lib, 0x445000, (5, 5), 14, 13)
    _spec_probe(t["kf_y_mode"], (0, 0), [15588, 17027, 19338, 20218])
    t["uv_mode_nocfl"] = aom_cdfs(lib, 0x444180, (13,), 15, 13)
    _spec_probe(t["uv_mode_nocfl"], (0,), [22631, 24152, 25378, 25661])
    t["uv_mode_cfl"] = aom_cdfs(lib, 0x444306, (13,), 15, 14)
    t["angle_delta"] = aom_cdfs(lib, 0x444f80, (8,), 8, 7)
    part = lib.arr(0x443f40, np.uint16, (20, 11))
    for i in range(20):          # 8x8: 4 symbols, 128x128: 8, else 10
        n = 4 if i < 4 else (8 if i >= 16 else 10)
        _check_cdf(part[i][:n + 1], n, f"partition {i}")
    t["partition"] = part
    _spec_probe(part, (0,), [19132, 25510, 30392])
    t["skip"] = dav1d_cdfs(lib, 0x4793bc, (3,), 2, 2)
    _spec_probe(t["skip"], (0,), [31671])
    txsz = lib.arr(0x442800, np.uint16, (4, 3, 4))
    for i in range(4):
        for j in range(3):
            _check_cdf(txsz[i, j][:3 if i == 0 else 4], 2 if i == 0 else 3,
                       f"tx_size {i} {j}")
    t["tx_size"] = txsz
    _spec_probe(txsz, (0, 0), [19968])
    ext = lib.arr(0x442A80, np.uint16, (3, 4, 13, 17))
    t["intra_tx_set1"] = ext[1, :2, :, :8].copy()
    t["intra_tx_set2"] = ext[2, :3, :, :6].copy()
    for idx in np.ndindex(2, 13):
        _check_cdf(t["intra_tx_set1"][idx], 7, f"set1 {idx}")
    for idx in np.ndindex(3, 13):
        _check_cdf(t["intra_tx_set2"][idx], 5, f"set2 {idx}")
    t["cfl_sign"] = dav1d_cdfs(lib, 0x478c50, (), 8, 8)
    _spec_probe(t["cfl_sign"], (), [1418, 2123, 13340, 18405])
    t["cfl_alpha"] = aom_cdfs(lib, 0x4426e0, (6,), 17, 16)
    _spec_probe(t["cfl_alpha"], (0,), [7637, 20719, 31401, 32481])
    t["use_filter_intra"] = aom_cdfs(lib, 0x444520, (22,), 3, 2)
    _spec_probe(t["use_filter_intra"], (0,), [4621])
    t["filter_intra_mode"] = dav1d_cdfs(lib, 0x478ce0, (), 8, 5)
    _spec_probe(t["filter_intra_mode"], (), [8949, 12776, 17211, 29558])
    t["restore_switchable"] = dav1d_cdfs(lib, 0x4792f0, (), 4, 3)
    _spec_probe(t["restore_switchable"], (), [9413, 22581])
    t["restore_wiener"] = dav1d_cdfs(lib, 0x4792f8, (), 2, 2)
    _spec_probe(t["restore_wiener"], (), [11570])
    t["restore_sgrproj"] = dav1d_cdfs(lib, 0x4792fc, (), 2, 2)
    _spec_probe(t["restore_sgrproj"], (), [16855])
    # coefficient CDFs, by the 4 quantizer contexts
    t["txb_skip"] = aom_cdfs(lib, 0x44D140, (4, 5, 13), 3, 2)
    _spec_probe(t["txb_skip"], (0, 0, 0), [31849])
    t["eob_extra"] = aom_cdfs(lib, 0x44C8C0, (4, 5, 2, 9), 3, 2)
    t["dc_sign"] = aom_cdfs(lib, 0x44C820, (4, 2, 3), 3, 2)
    _spec_probe(t["dc_sign"], (0, 0, 0), [128 * 125])
    for k, (off, n) in enumerate([(0x445FE0, 5), (0x445F00, 6),
                                  (0x445E00, 7), (0x445CE0, 8),
                                  (0x445BA0, 9), (0x445A40, 10),
                                  (0x4458C0, 11)]):
        t[f"eob_pt_{16 << k}"] = aom_cdfs(lib, off, (4, 2, 2), n + 1, n)
    t["coeff_base_eob"] = aom_cdfs(lib, 0x4460A0, (4, 5, 2, 4), 4, 3)
    t["coeff_base"] = aom_cdfs(lib, 0x4465A0, (4, 5, 2, 42), 5, 4)
    _spec_probe(t["coeff_base"], (0, 0, 0, 0), [4034, 8930, 12727])
    t["coeff_br"] = aom_cdfs(lib, 0x44A740, (4, 5, 2, 21), 5, 4)
    _spec_probe(t["coeff_br"], (0, 0, 0, 0), [14298, 20718, 24174])
    # --- constant tables
    t["dc_qlookup"] = lib.arr(0x437D80, np.int16, (256,))
    t["ac_qlookup"] = lib.arr(0x4386C0, np.int16, (256,))
    if t["dc_qlookup"][255] != 1336 or t["ac_qlookup"][255] != 1828:
        raise SystemExit("av1_tables: quantizer lookups end wrong")
    t["dr_intra_derivative"] = lib.arr(0x450A20, np.uint16, (90,))
    t["sm_weights"] = lib.arr(0x470BA2, np.uint8, (126,))
    if t["sm_weights"][:6].tolist() != [255, 128, 255, 149, 85, 64]:
        raise SystemExit("av1_tables: smooth weights")
    t["filter_intra_taps"] = lib.arr(0x442370, np.int8, (5, 8, 8))
    sgr = lib.arr(0x3E03C0, np.int32, (16, 4))
    if sgr[0].tolist() != [2, 1, 140, 3236]:
        raise SystemExit("av1_tables: sgr params")
    t["sgr_params"] = sgr          # r0, r1, s0, s1 (s: the scale)
    t["coeff_base_ctx_offset"] = lib.arr(0x471940, np.uint8, (3, 5, 5))
    cos = [round(4096 * math.cos(math.pi * i / 128)) for i in range(65)]
    if cos[:64] != lib.arr(0x4517E0, np.int32, (64,)).tolist():
        raise SystemExit("av1_tables: cosine table")
    t["cos128"] = np.array(cos, np.int32)
    if lib.arr(0x4515AC, np.int32, (4,)).tolist() != [1321, 2482, 3344, 3803]:
        raise SystemExit("av1_tables: sinpi")
    # CDEF (spec 7.15): the direction offsets (dy, dx) of Cdef_Directions
    # and Cdef_Uv_Dir, held to dav1d's copies (offsets in a 12-wide
    # buffer; the directions of 4:2:2 and 4:4:0) and libaom's (144 wide)
    dirs = np.array(CDEF_DIRECTIONS, np.int8)
    pad = [6, 7] + list(range(8)) + [0, 1]
    if (lib.arr(0x471840, np.int8, (12, 2)).tolist()
            != [[dy * 12 + dx for dy, dx in CDEF_DIRECTIONS[d]] for d in pad]
            or lib.arr(0x44D7B0, np.int32, (12, 2)).tolist()
            != [[dy * 144 + dx for dy, dx in CDEF_DIRECTIONS[d]]
                for d in pad]):
        raise SystemExit("av1_tables: CDEF directions")
    t["cdef_directions"] = dirs
    uv = np.array(CDEF_UV_DIR, np.uint8)
    if (lib.arr(0x4854D0, np.uint8, (2, 8)).tolist() != [uv[0][0].tolist(),
                                                       uv[1][0].tolist()]
            or lib.arr(0x44D780, np.int32, (8,)).tolist() != uv[1][0].tolist()
            or lib.arr(0x44D760, np.int32, (8,)).tolist() != uv[0][1].tolist()
            or uv[0][0].tolist() != uv[1][1].tolist()):
        raise SystemExit("av1_tables: Cdef_Uv_Dir")
    t["cdef_uv_dir"] = uv
    div = lib.arr(0x44D820, np.int32, (9,))
    if div.tolist() != [0, 840, 420, 280, 210, 168, 140, 120, 105]:
        raise SystemExit("av1_tables: CDEF Div_Table")
    t["cdef_div_table"] = div
    # Quantizer_Matrix (spec 7.12.3): libaom's iwt_matrix_ref, levels 0-14
    # (15 is flat), luma and chroma, each the 14 coded sizes of at most
    # 32x32 one after another (3,344 weights)
    qm = lib.arr(0x3E3D20, np.uint8, (15, 2, 3344))
    if (qm[0, 0, :16].tolist() != [32, 43, 73, 97, 43, 67, 94, 110, 73, 94,
                                   137, 150, 97, 110, 150, 200]
            or qm[14].min() < 30 or qm[14].max() > 32
            or lib.arr(0x3E3D20 + qm.size, np.uint8, (4,)).tolist()
            != [32, 24, 14, 11]):     # libaom's wt_matrix_ref follows
        raise SystemExit("av1_tables: Quantizer_Matrix")
    t["quantizer_matrix"] = qm
    # the delta q CDF (Default_Delta_Q_Cdf)
    t["delta_q"] = aom_cdfs(lib, 0x4427C0, (), 5, 4)
    _spec_probe(t["delta_q"], (), [28160, 32120, 32677])
    # --- screen content (palette, intra block copy) and its inter syntax
    t["palette_y_mode"] = aom_cdfs(lib, 0x444EC0, (7, 3), 3, 2)
    _spec_probe(t["palette_y_mode"], (0, 0), [31676])
    _spec_probe(t["palette_y_mode"], (6, 1), [7946])
    t["palette_uv_mode"] = dav1d_cdfs(lib, 0x47941C, (2,), 2, 2)
    _spec_probe(t["palette_uv_mode"], (0,), [32461])
    _spec_probe(t["palette_uv_mode"], (1,), [21488])
    t["palette_y_size"] = aom_cdfs(lib, 0x445840, (7,), 8, 7)
    _spec_probe(t["palette_y_size"], (0,), [7952, 13000, 18149, 21478])
    t["palette_uv_size"] = aom_cdfs(lib, 0x4457C0, (7,), 8, 7)
    _spec_probe(t["palette_uv_size"], (0,), [8713, 19979, 27128, 29609])
    # the colour index CDFs of palettes of 2-8 colours (n symbols each in
    # a 9-wide row), by the 5 colour contexts
    for plane, off, probe in (("y", 0x445540, 28710), ("uv", 0x4452C0,
                                                        29089)):
        a = lib.arr(off, np.uint16, (7, 5, 9))
        for n in range(2, 9):
            for ctx in range(5):
                _check_cdf(a[n - 2, ctx][:n + 1], n,
                           f"palette {plane} colour {n} {ctx}")
                if a[n - 2, ctx][n + 1:].any():
                    raise SystemExit(f"av1_tables: palette {plane} {n}")
        _spec_probe(a, (0, 0), [probe])
        _spec_probe(a, (0, 1), [16384])
        t[f"palette_{plane}_color"] = a
    t["intrabc"] = dav1d_cdfs(lib, 0x479424, (), 2, 2)
    _spec_probe(t["intrabc"], (), [30531])
    t["txfm_split"] = aom_cdfs(lib, 0x444D40, (21,), 3, 2)
    _spec_probe(t["txfm_split"], (0,), [28581])
    _spec_probe(t["txfm_split"], (20,), [16088])
    # inter transform types (libaom's av1_default_inter_ext_tx_cdf, sets
    # 1-3 by the square size): 16, 12 and 2 symbols
    for k, n in ((1, 16), (2, 12), (3, 2)):
        t[f"inter_tx_set{k}"] = aom_cdfs(lib, 0x442860 + k * 4 * 17 * 2,
                                         (4,), 17, n)
    _spec_probe(t["inter_tx_set1"], (0,), [4458, 5560, 7695, 9709])
    _spec_probe(t["inter_tx_set3"], (1,), [4167])
    # motion vectors (libaom's default_nmv_context: the joint, then per
    # component the classes, class0_fp, fp, sign, class0_hp, hp, class0
    # and the bits; intra block copy reads no fractional bits)
    t["mv_joint"] = aom_cdfs(lib, 0x458400, (), 5, 4)
    _spec_probe(t["mv_joint"], (), [4096, 11264, 19328])
    comp = [0x45840A + c * 138 for c in range(2)]
    t["mv_class"] = np.stack([aom_cdfs(lib, o, (), 12, 11) for o in comp])
    _spec_probe(t["mv_class"], (1,), [28672, 30976, 31858, 32320])
    t["mv_sign"] = np.stack([aom_cdfs(lib, o + 54, (), 3, 2) for o in comp])
    _spec_probe(t["mv_sign"], (0,), [16384])
    t["mv_class0_bit"] = np.stack([aom_cdfs(lib, o + 72, (), 3, 2)
                                   for o in comp])
    _spec_probe(t["mv_class0_bit"], (1,), [27648])
    t["mv_bit"] = np.stack([aom_cdfs(lib, o + 78, (10,), 3, 2)
                            for o in comp])
    for i, p in enumerate((136, 140, 148, 160, 176, 192, 224, 234, 234,
                           240)):
        _spec_probe(t["mv_bit"], (1, i), [128 * p])
    # film grain: the specification's Gaussian_Sequence (2048 entries,
    # multiples of 4 within +-2048)
    gauss = lib.arr(0x46F9C0, np.int16, (2048,))
    if (gauss[:8].tolist() != [56, 568, -180, 172, 124, -84, 172, -64]
            or (gauss % 4).any() or np.abs(gauss).max() >= 2048
            or abs(int(gauss.astype(np.int64).sum())) > 2048 * 16):
        raise SystemExit("av1_tables: Gaussian_Sequence")
    t["gaussian_sequence"] = gauss
    # scans of every coded size: the library holds each (its raster or
    # its transpose) among its copies
    sizes = [(4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16),
             (16, 8), (16, 32), (32, 16), (4, 16), (16, 4), (8, 32), (32, 8)]
    for w, h in sizes:
        s = np.array(scan(w, h), np.int16)
        tr = np.array([(p % w) * h + p // w for p in s], np.int16)
        if not any(c.tobytes() in lib.b for c in (s, tr)):
            raise SystemExit(f"av1_tables: scan {w}x{h} not in the library")
        t[f"scan_{w}x{h}"] = s
    return t


_CTYPE = {np.uint16: "uint16_t", np.int16: "int16_t", np.uint8: "uint8_t",
          np.int8: "int8_t", np.int32: "int32_t"}


def render(t: dict) -> str:
    lines = ["// Generated by scripts/av1_tables.py: the AV1 intra decoder's",
             "// tables (default CDFs as 32768 - cdf, a 0 and a counter per",
             "// CDF; quantizer lookups and matrices; prediction and filter",
             "// constants; film grain's Gaussian sequence; scan orders).",
             "// Do not edit.",
             "#pragma once", "#include <cstdint>", ""]
    for name, a in t.items():
        a = np.asarray(a)
        ctype = _CTYPE[a.dtype.type]
        dims = "".join(f"[{d}]" for d in a.shape)
        flat = a.reshape(-1).tolist()
        body = []
        for i in range(0, len(flat), 16):
            body.append("  " + ", ".join(str(v) for v in flat[i:i + 16]) + ",")
        lines.append(f"static const {ctype} AV1_{name.upper()}"
                     f"{dims or '[1]'} = {{")
        lines += body
        lines.append("};")
    return "\n".join(lines) + "\n"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    text = render(build(Lib(_library())))
    if args.check:
        same = OUT.exists() and OUT.read_text() == text
        print("av1_tables.h", "matches" if same else "differs")
        sys.exit(0 if same else 1)
    OUT.write_text(text)
    print(f"wrote {OUT} ({len(text)} bytes)")


if __name__ == "__main__":
    main()
