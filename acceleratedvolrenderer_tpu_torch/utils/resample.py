"""libImaging's Resample.c for 8-bit RGB, without PIL: Image.resize(size,
BICUBIC) and Image.thumbnail(size, LANCZOS, reducing_gap=None) of PIL
12.1.0, pixel for pixel the same (ICNS and ICO writers resize through
them).

Two separable passes, rows first (over the source rows the columns need),
then columns, each with 8-bit rounding between.  Each output sample's
taps: the filter's support scaled by the reduction factor (at least 1),
centred on (x + 0.5) * scale, its bounds rounded as C casts them, the
weights computed in double and normalised to sum 1, then made 22-bit
fixed point (rounded half away from zero); a sample is the sum of the
taps times the samples plus half, shifted right 22 and clamped to
0..255.  The filters are Resample.c's: bicubic with a = -0.5 (support 2)
and Lanczos-3 (sinc(x) sinc(x / 3), support 3), evaluated with the math
module's sin, the C library's.
"""
from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


FILTERS = {"bicubic": (_bicubic, 2.0), "lanczos": (_lanczos, 3.0)}


def coefficients(in_size: int, out_size: int, kind: str):
    """Resample.c's precompute_coeffs and normalize_coeffs_8bpc over the
    whole input: (first tap (out,), int64 fixed-point taps (out, ksize),
    zero past each output's tap count)."""
    fn, support = FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    taps = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(k)
        if ww != 0.0:
            k = [v / ww for v in k]
        first[xx] = xmin
        taps[xx, :xmax] = [int(v * (1 << PRECISION_BITS) + (
            -0.5 if v < 0 else 0.5)) for v in k]
    return first, taps


def _pass(a: np.ndarray, out_size: int, kind: str, axis: int) -> np.ndarray:
    """One pass of uint8 a along axis (0 rows of samples, 1 columns)."""
    first, taps = coefficients(a.shape[axis], out_size, kind)
    a = np.moveaxis(a, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + a.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    last = a.shape[0] - 1
    shape = (out_size,) + (1,) * (a.ndim - 1)
    for k in range(taps.shape[1]):
        acc += a[np.minimum(first + k, last)] * taps[:, k].reshape(shape)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(px: np.ndarray, size: tuple[int, int],
           kind: str = "bicubic") -> np.ndarray:
    """Image.resize((W, H), BICUBIC or LANCZOS) of uint8 px (h, w, C)."""
    w, h = size
    if (px.shape[1], px.shape[0]) == (w, h):
        return px.copy()
    out = px
    if w != px.shape[1]:
        out = _pass(out, w, kind, 1)
    if h != px.shape[0]:
        out = _pass(out, h, kind, 0)
    return out


def thumbnail_size(w: int, h: int, size: tuple[int, int]):
    """Image.thumbnail's size for a w x h image fitted into size keeping
    its aspect, or None where it already fits."""
    x, y = size

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    if x >= w and y >= h:
        return None
    aspect = w / h
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect,
                         key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def thumbnail(px: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Image.thumbnail(size, LANCZOS, reducing_gap=None) of uint8 px: a
    copy of px resized to thumbnail_size."""
    fit = thumbnail_size(px.shape[1], px.shape[0], size)
    if fit is None:
        return px.copy()
    return resize(px, fit, "lanczos")
