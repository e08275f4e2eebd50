"""Native (C++) host code, loaded with ctypes (port of
acceleratedvolrenderer_tpu/native/__init__.py: merge_points and KDTree of
the graph layer, and the LZ4 block codec of utils/blosc.py; and, the
port's own, the JPEG 2000 tier 1 of utils/jpeg2000.py, j2k_t1.cpp, and
the VP8 encoder of utils/webp_write.py, vp8_enc.cpp, and the AV1 intra
decoder of utils/avif.py, av1_dec.cpp).

Each source is compiled with g++ on first use (not at import) into its own
library under build/native/ at the repository root, with the reference's
flags, and rebuilt when the source is newer than the library.  kdtree.cpp
has no fallback: when it cannot be built or loaded, its entry points
raise, because a silent fallback to another merge would change the graph.
The LZ4 entries return None when lz4.cpp cannot be built or loaded, as
the reference's do, and utils/blosc.py then runs its pure-Python codec
(the reference's choice, made there and only there).  j2k_decode_blocks
returns None the same way, and utils/jpeg2000.py then runs the numpy
twin (utils/j2k_t1.py), which gives the same samples.  j2k_encode_blocks
has no fallback: it raises when j2k_t1.cpp cannot be built or loaded, and
so does utils/jpeg2000_write.py, whose plain-Python twin (utils/j2k_t1.py's
encode_blocks) is far too slow for a frame and holds the C++ encoder in
the tests only.  vp8_enc.cpp, the lossy WebP encoder of
utils/webp_write.py, has no fallback and no twin: vp8_enc_library raises
when it cannot be built or loaded.  av1_dec.cpp, the AV1 decoder of
utils/avif.py, includes its tables from av1_tables.h (written by
scripts/av1_tables.py) and has no fallback either: av1_library raises,
naming g++, when it cannot be built.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "kdtree.cpp"
BUILD_DIR = SRC.parents[2] / "build" / "native"
LIB_PATH = BUILD_DIR / "libavrt_kdtree.so"
LZ4_SRC = SRC.with_name("lz4.cpp")
LZ4_LIB_PATH = BUILD_DIR / "libavrt_lz4.so"
J2K_SRC = SRC.with_name("j2k_t1.cpp")
J2K_LIB_PATH = BUILD_DIR / "libavrt_j2k_t1.so"
VP8_SRC = SRC.with_name("vp8_enc.cpp")
VP8_LIB_PATH = BUILD_DIR / "libavrt_vp8_enc.so"
AV1_SRC = SRC.with_name("av1_dec.cpp")
AV1_LIB_PATH = BUILD_DIR / "libavrt_av1_dec.so"
# headers a source includes: the library is rebuilt when one is newer
DEPENDS = {"av1_dec.cpp": ("av1_tables.h",)}
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_lz4_lib = None
_lz4_tried = False
_j2k_lib = None
_j2k_tried = False
_vp8_lib = None
_av1_lib = None
# what a failed build of each source leaves its callers
NO_FALLBACK = {"kdtree.cpp": "the graph layer has no fallback merge: ",
               "j2k_t1.cpp": "JPEG 2000 writing has no fallback encoder: ",
               "vp8_enc.cpp": "WebP writing has no fallback encoder: ",
               "av1_dec.cpp": "AVIF reading has no fallback decoder: "}


def _build(lib_path: Path, src: Path = SRC):
    """Compile `src` into lib_path (atomically) when it is missing or
    older than the source; raises RuntimeError when g++ fails."""
    deps = [src] + [src.with_name(h) for h in DEPENDS.get(src.name, ())]
    if lib_path.exists() and all(lib_path.stat().st_mtime >= d.stat().st_mtime
                                 for d in deps):
        return
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", str(tmp)],
                       check=True, capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as e:
        log = getattr(e, "stderr", "") or str(e)
        raise RuntimeError(f"native: building {src.name} with g++ failed; "
                           f"{NO_FALLBACK.get(src.name, '')}{log}") from e
    os.replace(tmp, lib_path)


def library():
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        _build(LIB_PATH)
        lib = ctypes.CDLL(str(LIB_PATH))
        lib.avrt_merge_points.restype = ctypes.c_int
        lib.avrt_merge_points.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.avrt_kd_build.restype = ctypes.c_void_p
        lib.avrt_kd_build.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.avrt_kd_free.argtypes = [ctypes.c_void_p]
        lib.avrt_kd_knn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
        lib.avrt_kd_radius_stats.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
        return lib


def is_available() -> bool:
    """Whether kdtree.cpp builds with g++ and loads.  The graph layer does
    not fall back when it does not: library() raises there."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def merge_points(pts: np.ndarray, radius: float):
    """Sequential exact-radius merge: returns (labels (n,), verts (V, 3),
    counts (V,)).  Each point, in order, joins the nearest existing vertex
    within `radius` or founds a new vertex at its own position."""
    pts = np.ascontiguousarray(pts, np.float32)
    n = len(pts)
    if n == 0:
        return (np.zeros(0, np.int32), np.zeros((0, 3), np.float32),
                np.zeros(0, np.int32))
    lib = library()
    labels = np.empty(n, np.int32)
    verts = np.empty((n, 3), np.float32)
    counts = np.zeros(n, np.int32)
    v = lib.avrt_merge_points(_ptr(pts), n, ctypes.c_float(radius),
                              _ptr(labels), _ptr(verts), _ptr(counts))
    return labels, verts[:v].copy(), counts[:v].copy()


class KDTree:
    """Static 3D KD-tree with kNN and radius statistics."""

    def __init__(self, pts: np.ndarray):
        self.pts = np.ascontiguousarray(pts, np.float32)
        self.n = len(self.pts)
        self._lib = library()
        self._h = self._lib.avrt_kd_build(_ptr(self.pts), self.n)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.avrt_kd_free(self._h)
            self._h = None

    def knn(self, queries: np.ndarray, k: int):
        """(idx (nq, k) int32, -1 padded; d2 (nq, k) float32, inf padded)."""
        q = np.ascontiguousarray(queries, np.float32)
        nq = len(q)
        idx = np.empty((nq, k), np.int32)
        d2 = np.empty((nq, k), np.float32)
        self._lib.avrt_kd_knn(self._h, _ptr(q), nq, k, _ptr(idx), _ptr(d2))
        return idx, d2

    def radius_stats(self, queries: np.ndarray, radius: float):
        """(count (nq,), sum_d2 (nq,)) of the points within `radius`."""
        q = np.ascontiguousarray(queries, np.float32)
        nq = len(q)
        counts = np.empty(nq, np.int32)
        sumd2 = np.empty(nq, np.float32)
        self._lib.avrt_kd_radius_stats(
            self._h, _ptr(q), nq, ctypes.c_float(radius * radius),
            _ptr(counts), _ptr(sumd2))
        return counts, sumd2


def lz4_library():
    """The loaded LZ4 library, built on first use; None when it cannot be
    built or loaded (the reference's semantics)."""
    global _lz4_lib, _lz4_tried
    with _lock:
        if _lz4_tried:
            return _lz4_lib
        _lz4_tried = True
        try:
            _build(LZ4_LIB_PATH, LZ4_SRC)
            lib = ctypes.CDLL(str(LZ4_LIB_PATH))
        except (OSError, RuntimeError):
            return None
        lib.avrt_lz4_compress.restype = ctypes.c_int64
        lib.avrt_lz4_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        lib.avrt_lz4_decompress.restype = ctypes.c_int64
        lib.avrt_lz4_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        _lz4_lib = lib
        return lib


def lz4_compress_block(src: bytes):
    """Native LZ4 block encode; None when the library is unavailable (the
    caller then runs the pure-Python encoder)."""
    lib = lz4_library()
    if lib is None:
        return None
    n = len(src)
    cap = n + n // 255 + 16
    dst = np.empty(cap, np.uint8)
    r = lib.avrt_lz4_compress(src, n, _ptr(dst), cap)
    if r < 0:
        raise ValueError("lz4: compress overflow")
    return dst[:r].tobytes()


def lz4_decompress_block(src: bytes, dst_size: int):
    """Native LZ4 block decode; None when the library is unavailable."""
    lib = lz4_library()
    if lib is None:
        return None
    dst = np.empty(max(dst_size, 1), np.uint8)
    r = lib.avrt_lz4_decompress(src, len(src), _ptr(dst), dst_size)
    if r != dst_size:
        raise ValueError(f"lz4: decoded {r} bytes, expected {dst_size}")
    return dst[:dst_size].tobytes()



def j2k_library(required: bool = False):
    """The loaded JPEG 2000 tier-1 library, built on first use; None when
    it cannot be built or loaded (required: raise instead)."""
    global _j2k_lib, _j2k_tried
    with _lock:
        if _j2k_lib is not None or (_j2k_tried and not required):
            return _j2k_lib
        _j2k_tried = True
        try:
            _build(J2K_LIB_PATH, J2K_SRC)
            lib = ctypes.CDLL(str(J2K_LIB_PATH))
        except (OSError, RuntimeError):
            if required:
                raise
            return None
        lib.avrt_j2k_decode_blocks.restype = None
        lib.avrt_j2k_decode_blocks.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int64, ctypes.c_void_p]
        lib.avrt_j2k_encode_blocks.restype = ctypes.c_int64
        lib.avrt_j2k_encode_blocks.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int64] + [ctypes.c_void_p] * 5
        _j2k_lib = lib
        return lib


def j2k_decode_blocks(blocks, required: bool = False):
    """Tier 1 of JPEG 2000 code-blocks in C++ (j2k_t1.cpp), with the
    arguments and results of utils/j2k_t1.py's decode_blocks; None when
    the library is unavailable and not required."""
    from ..utils.j2k_t1 import pack

    lib = j2k_library(required)
    if lib is None:
        return None
    buf, starts, npass = pack(blocks)
    cols = [np.array([b[k] for b in blocks], np.int32).reshape(-1)
            for k in (2, 3, 4, 5)]
    sizes = cols[2].astype(np.int64) * cols[3]
    outoffs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    out = np.zeros(max(int(sizes.sum()), 1), np.int32)
    lib.avrt_j2k_decode_blocks(_ptr(buf), _ptr(starts), _ptr(npass),
                               *(_ptr(c) for c in cols), _ptr(outoffs),
                               len(blocks), _ptr(out))
    return [out[o:o + s].reshape(h, w) for o, s, h, w in
            zip(outoffs, sizes, cols[2], cols[3])]


def j2k_encode_blocks(blocks):
    """Tier 1 of JPEG 2000 code-blocks in C++ (j2k_t1.cpp), with the
    arguments and results of utils/j2k_t1.py's encode_blocks; raises when
    the library cannot be built or loaded."""
    lib = j2k_library(required=True)
    if not blocks:
        return []
    coefs = [np.ascontiguousarray(c, np.int32).reshape(-1) for c, _ in blocks]
    sizes = np.array([c.size for c in coefs], np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    hs = np.array([c.shape[0] for c, _ in blocks], np.int32)
    ws = np.array([c.shape[1] for c, _ in blocks], np.int32)
    orient = np.array([o for _, o in blocks], np.int32)
    caps = 3 * sizes + 64       # room for 8-bit images (<= 11 bit-planes)
    out_offs = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int64)
    out = np.zeros(int(caps.sum()), np.uint8)
    coef = np.concatenate(coefs)
    nbps = np.zeros(len(blocks), np.int32)
    lens = np.zeros(len(blocks), np.int64)
    r = lib.avrt_j2k_encode_blocks(
        _ptr(coef), _ptr(offs), _ptr(hs), _ptr(ws), _ptr(orient),
        len(blocks), _ptr(out), _ptr(out_offs), _ptr(caps), _ptr(nbps),
        _ptr(lens))
    if r < 0:
        raise RuntimeError(f"j2k tier 1: code-block {-1 - r} outgrew its "
                           "buffer")
    return [(int(n), out[o:o + k].tobytes())
            for n, o, k in zip(nbps, out_offs, lens)]


def vp8_enc_library():
    """The loaded VP8 encoder library (vp8_enc.cpp), built on first use;
    raises RuntimeError (naming g++) when it cannot be built, as WebP
    writing has no fallback."""
    global _vp8_lib
    with _lock:
        if _vp8_lib is not None:
            return _vp8_lib
        _build(VP8_LIB_PATH, VP8_SRC)
        lib = ctypes.CDLL(str(VP8_LIB_PATH))
        lib.avrt_vp8_analyze.restype = None
        lib.avrt_vp8_analyze.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
        lib.avrt_vp8_encode.restype = ctypes.c_int64
        lib.avrt_vp8_encode.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
            ctypes.c_int64]
        _vp8_lib = lib
        return lib


def _planes(y, u, v):
    """The Y, U, V planes as contiguous uint8 arrays, checked against each
    other: (H, W) and ((H + 1) // 2, (W + 1) // 2)."""
    y, u, v = (np.ascontiguousarray(a, np.uint8) for a in (y, u, v))
    h, w = y.shape
    if u.shape != ((h + 1) // 2, (w + 1) // 2) or v.shape != u.shape:
        raise ValueError(f"vp8: chroma planes {u.shape}, {v.shape} do not "
                         f"fit a {w}x{h} luma plane")
    return y, u, v, w, h


def vp8_analyze(y, u, v, tables):
    """libwebp's analysis pass (vp8_enc.cpp) over the Y, U, V planes:
    (each macroblock's segment in raster order (uint8), the four
    segments' alphas, their betas, the mean chroma alpha)."""
    lib = vp8_enc_library()
    y, u, v, w, h = _planes(y, u, v)
    segment = np.zeros(((w + 15) // 16) * ((h + 15) // 16), np.uint8)
    out = np.zeros(10, np.int32)
    lib.avrt_vp8_analyze(_ptr(y), _ptr(u), _ptr(v), w, h, _ptr(tables),
                         _ptr(segment), _ptr(out))
    return segment, out[:4].tolist(), out[4:8].tolist(), int(out[9])


def vp8_encode(y, u, v, tables, segment, params):
    """The VP8 key frame (vp8_enc.cpp) of the planes with each
    macroblock's segment and params (utils/webp_write.py's
    segment_params)."""
    lib = vp8_enc_library()
    y, u, v, w, h = _planes(y, u, v)
    segment = np.ascontiguousarray(segment, np.uint8)
    params = np.ascontiguousarray(params, np.int32)
    if segment.shape != (((w + 15) // 16) * ((h + 15) // 16),) or \
            params.shape != (14,):
        raise ValueError("vp8: a segment per macroblock and 14 params")
    cap = 4 * w * h + 4096
    while True:                 # at most twice: a short buffer says its need
        dst = np.zeros(cap, np.uint8)
        n = lib.avrt_vp8_encode(_ptr(y), _ptr(u), _ptr(v), w, h,
                                _ptr(tables), _ptr(segment), _ptr(params),
                                _ptr(dst), cap)
        if n >= 0:
            return dst[:n].tobytes()
        cap = -n


def av1_library():
    """The loaded AV1 decoder library (av1_dec.cpp), built on first use;
    raises RuntimeError (naming g++) when it cannot be built, as AVIF
    reading has no fallback."""
    global _av1_lib
    with _lock:
        if _av1_lib is not None:
            return _av1_lib
        _build(AV1_LIB_PATH, AV1_SRC)
        lib = ctypes.CDLL(str(AV1_LIB_PATH))
        lib.avrt_av1_decode.restype = ctypes.c_int
        lib.avrt_av1_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64] + [
            ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
            ctypes.c_int]
        _av1_lib = lib
        return lib


def _grain_params(g) -> list:
    """film_grain_params (utils/avif.py's frame["grain"], None where the
    frame applies none) in av1_dec.cpp's P_FG_* layout: apply, seed, the
    luma points (14 value, scaling pairs), chroma_scaling_from_luma, the
    Cb and Cr points (10 pairs each), the scaling shift, the AR lag, the
    AR coefficients (24 luma, 25 Cb, 25 Cr), the AR shift, the grain
    scale shift, the Cb and Cr multipliers and offsets, overlap_flag and
    clip_to_restricted_range."""
    if g is None:
        return [0] * 160

    def points(pts, n):
        flat = [v for p in pts for v in p]
        return [len(pts)] + flat + [0] * (2 * n - len(flat))

    def pad(v, n):
        return list(v) + [0] * (n - len(v))

    return ([1, g["seed"]] + points(g["y"], 14) + [g["from_luma"]]
            + points(g["cb"], 10) + points(g["cr"], 10)
            + [g["scaling_shift"], g["lag"]] + pad(g["ar_y"], 24)
            + pad(g["ar_cb"], 25) + pad(g["ar_cr"], 25)
            + [g["ar_shift"], g["grain_scale_shift"]]
            + [g[k] for k in ("cb_mult", "cb_luma_mult", "cb_offset",
                              "cr_mult", "cr_luma_mult", "cr_offset")]
            + [g["overlap"], g["clip"]])


def av1_decode(data: bytes, seq: dict, frame: dict, tiles, stats=None):
    """The (Y, U, V) uint8 planes of an AV1 intra frame (av1_dec.cpp),
    film grain applied where the frame asks for it; U and V are None for
    4:0:0.  seq, frame and tiles are utils/avif.py's parse_av1.  A dict
    given as stats gets the decoder's counts: `delta_q_blocks` (blocks
    whose delta_qindex is not 0), `cdef_blocks` (64x64 blocks that read
    a cdef_idx, where CDEF has a strength that is not 0),
    `palette_blocks` (blocks predicted from a palette in some plane),
    `palette_uv_blocks` (those with a chroma palette) and
    `intrabc_blocks` (blocks copied by intra block copy)."""
    lib = av1_library()
    w, h = frame["w"], frame["h"]
    ssx, ssy = seq["ss"]
    params = np.array(
        [w, h, ssx, ssy, seq["mono"], seq["use128"], seq["filter_intra"],
         seq["edge_filter"], frame["disable_cdf_update"], frame["base_q"],
         *frame["dq"], frame["lossless"], *frame["lf"],
         frame["lf_sharpness"], frame["lf_delta_enabled"],
         frame["lf_ref_deltas"][0], *frame["lr_type"], *frame["lr_size"],
         frame["tx_mode"], frame["reduced_tx_set"],
         len(frame["col_starts"]) - 1, len(frame["row_starts"]) - 1,
         frame["cdef"], frame["cdef_damping"], frame["cdef_bits"],
         *frame["cdef_y_pri"], *frame["cdef_y_sec"], *frame["cdef_uv_pri"],
         *frame["cdef_uv_sec"], *frame["qm_level"],
         frame["delta_q_present"], frame["delta_q_res"], frame["screen"],
         frame["intrabc"], int(seq["cicp"][2] == 0),
         *_grain_params(frame["grain"])], np.int32)
    cols = np.array(frame["col_starts"], np.int32)
    rows = np.array(frame["row_starts"], np.int32)
    t = np.array(tiles, np.int64).reshape(-1, 3)
    y = np.zeros((h, w), np.uint8)
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    u = np.zeros((ch, cw), np.uint8)
    v = np.zeros((ch, cw), np.uint8)
    counts = np.zeros(5, np.int32)
    err = ctypes.create_string_buffer(256)
    r = lib.avrt_av1_decode(data, len(data), _ptr(params), _ptr(cols),
                            _ptr(rows), _ptr(t), len(t), _ptr(y), _ptr(u),
                            _ptr(v), _ptr(counts), err, len(err))
    if r != 0:
        raise ValueError(f"avif: AV1 decode failed: {err.value.decode()}")
    if stats is not None:
        stats.update(delta_q_blocks=int(counts[0]),
                     cdef_blocks=int(counts[1]),
                     palette_blocks=int(counts[2]),
                     intrabc_blocks=int(counts[3]),
                     palette_uv_blocks=int(counts[4]))
    if seq["mono"]:
        return y, None, None
    return y, u, v
