"""Native (C++) host code of the graph layer, loaded with ctypes
(port of acceleratedvolrenderer_tpu/native/__init__.py: merge_points and
KDTree).

kdtree.cpp is compiled with g++ on first use (not at import) into
build/native/ at the repository root, with the reference's flags, and
rebuilt when the source is newer than the library.  There is no fallback:
when the library cannot be built or loaded, every entry point raises,
because a silent fallback to another merge would change the graph.
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
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def _build(lib_path: Path):
    """Compile kdtree.cpp into lib_path (atomically) when it is missing or
    older than the source; raises RuntimeError when g++ fails."""
    if lib_path.exists() and lib_path.stat().st_mtime >= SRC.stat().st_mtime:
        return
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as e:
        log = getattr(e, "stderr", "") or str(e)
        raise RuntimeError(f"native: building {SRC.name} with g++ failed; "
                           f"the graph layer has no fallback merge: "
                           f"{log}") from e
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
