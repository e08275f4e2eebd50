"""Scalar math helpers (port of acceleratedvolrenderer_tpu/utils/math.py)."""
from __future__ import annotations

import torch

INV_PI = 0.31830988618379067154
INV_2PI = 0.15915494309189533577
INV_4PI = 0.07957747154594766788
PI_OVER_2 = 1.57079632679489661923
PI_OVER_4 = 0.78539816339744830961
SQRT_2 = 1.41421356237309504880

# largest float32 below 1 (exactly representable, so a python float is exact)
ONE_MINUS_EPSILON = 1.0 - 2.0 ** -24


def exact_div(x, c):
    """x / c, correctly rounded on every device: CUDA divides a tensor by a
    python number as x * (1 / c), which can differ from x / c in the last
    bit, but divides by a tensor on the card exactly."""
    return x / torch.full((), float(c), dtype=x.dtype, device=x.device)


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


def sqr(x):
    return x * x


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_div(a, b, eps=0.0):
    """a / b, and 0 where b == eps (pbrt's guard of divisions by sampled
    pdfs)."""
    ok = b != eps
    return torch.where(ok, a / torch.where(ok, b, torch.ones_like(b)), 0.0)


def safe_acos(x):
    return torch.arccos(torch.clamp(x, -1.0, 1.0))


def smoothstep(x, a, b):
    t = torch.clamp((x - a) / (b - a), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def difference_of_products(a, b, c, d):
    """a * b - c * d in float32 (pbrt's DifferenceOfProducts compensates
    the rounding with an FMA; the reference accepts the rounding)."""
    return a * b - c * d
