"""Build and load the package's CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc` process, all started
together, and the objects are linked into one shared library with a plain C
interface, `build/kernels/libavrt_kernels.so` at the repository root, on
first use; it is loaded with ctypes.  The library is rebuilt when a source
is newer than it.  `-fmad=false` keeps the kernels' float32 rounding
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

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libavrt_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    """Compile csrc/*.cu, one nvcc per source in parallel, and link them
    into LIB_PATH (atomically) when it is stale."""
    global build_seconds, build_log
    if not _stale():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    tag = f"tmp{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    t0 = time.time()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    build_log = "\n".join(f"[{s.name}]\n{log}" for s, log in zip(srcs, logs))
    failed = [s.name for s, p in zip(srcs, procs) if p.returncode != 0]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp = LIB_PATH.with_suffix(f".so.{tag}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *(str(o) for o in objs)],
                              capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{build_log}")
        os.replace(tmp, LIB_PATH)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_seconds = time.time() - t0
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def check_arg(who, name, t, dtype, shape, device):
    """Raise unless tensor `t` lies on `device` with `dtype`, `shape` and a
    contiguous layout, as a kernel wrapper requires of its arguments."""
    if t.device != device:
        raise ValueError(f"{who}: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{who}: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} is not contiguous")


def entry(name, argtypes):
    """The C function `name` of the kernel library (built on first use),
    with its ctypes argument types and a cudaError_t (int) result."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_tensor(who, name, t, dtype, ndim, device):
    """check_arg in one test for a wrapper's launch path: `t` on `device`
    with `dtype`, `ndim` dimensions (any number if None) and a contiguous
    layout.  The field-by-field check runs only to name a fault."""
    if (t.device == device and t.dtype == dtype and t.is_contiguous()
            and (ndim is None or t.dim() == ndim)):
        return
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{who}: {name} has {t.dim()} dimensions, expected "
                         f"{ndim}")
    check_arg(who, name, t, dtype, tuple(t.shape), device)


def launch_target(who, device):
    """(device index, PyTorch's current stream on `device` as an int) for a
    kernel launch; raises unless `device` is a CUDA device.  Read on every
    call: a CUDA graph capture changes the current stream.  The C entry
    makes the device current only if it is not already, in place of a
    torch.cuda.device context around the call.  The stream comes from a
    private binding, cheaper than torch.cuda.current_stream; a card test
    in tests/test_torch_cuda.py holds the two equal."""
    if device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {device}")
    return device.index, torch._C._cuda_getCurrentRawStream(device.index)
