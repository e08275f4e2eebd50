"""Build and load the package's CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` into one shared library with a
plain C interface, `build/kernels/libavrt_kernels.so` at the repository
root, on first use, and loaded with ctypes.  The library is rebuilt when a
source is newer than it.  `-fmad=false` keeps the kernels' float32 rounding
identical to the eager PyTorch versions they are checked against (no
multiply-add contraction).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libavrt_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lib = None
build_seconds = None    # wall time of this process's build, None if reused
build_log = ""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (looked on PATH and in /usr/local/cuda/bin)")


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > built for src in CSRC.glob("*.cu*"))


def build() -> Path:
    """Compile csrc/*.cu into LIB_PATH (atomically) when it is stale."""
    global build_seconds, build_log
    if not _stale():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *sorted(str(p) for p in CSRC.glob("*.cu"))]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, LIB_PATH)
    build_seconds = time.time() - t0
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib
