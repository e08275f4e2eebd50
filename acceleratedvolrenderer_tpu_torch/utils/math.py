"""Scalar math helpers (port of acceleratedvolrenderer_tpu/utils/math.py)."""
from __future__ import annotations

import torch

INV_4PI = 0.07957747154594766788

# largest float32 below 1 (exactly representable, so a python float is exact)
ONE_MINUS_EPSILON = 1.0 - 2.0 ** -24


def exact_div(x, c):
    """x / c, correctly rounded on every device: CUDA divides a tensor by a
    python number as x * (1 / c), which can differ from x / c in the last
    bit, but divides by a tensor on the card exactly."""
    return x / torch.full((), float(c), dtype=x.dtype, device=x.device)


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def smoothstep(x, a, b):
    t = torch.clamp((x - a) / (b - a), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)
