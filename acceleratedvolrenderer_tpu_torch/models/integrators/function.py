"""The function integrator: a sampler-convergence harness
(port of acceleratedvolrenderer_tpu/models/integrators/function.py).

cpu/integrators.h:481, cpu/integrators.cpp:3355-3560: every pixel Monte
Carlo integrates a known 2D function with the sampler's per-pixel points,
and the mean squared error against the exact integral is recorded at
power-of-two sample counts ("<function>-mse.txt").  All pixels are lanes
of one estimate; the sample count advances in a host loop.  The samplers
measured are those of the film jitter (models/samplers.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import samplers as samplers_mod
from ...utils.device import resolve

_SQRT2 = 1.414213562373095


def _gauss_integral(x0, x1, mu=0.0, sigma=1.0):
    return 0.5 * (math.erf((mu - x0) / (sigma * _SQRT2))
                  - math.erf((mu - x1) / (sigma * _SQRT2)))


def _checkerboard(u, v):
    freq = 10
    pix = (u * freq).to(torch.int32)
    piy = (v * freq).to(torch.int32)
    return torch.where(((pix & 1) ^ (piy & 1)) != 0, 2.0, 0.0)


def _gauss1(x):
    return torch.exp(-((x - 0.5) ** 2) / 2.0) / np.sqrt(2 * np.pi)


# name -> (f(u, v), its exact integral over [0, 1]^2)
FUNCTIONS = {
    "step": (lambda u, v: torch.where(u < 0.5, 2.0, 0.0), 1.0),
    "diagonal": (lambda u, v: torch.where(u + v < 1.0, 2.0, 0.0), 1.0),
    "disk": (lambda u, v: torch.where(
        (u - 0.5) ** 2 + (v - 0.5) ** 2 < 0.25, 1.0 / (np.pi * 0.25), 0.0),
        1.0),
    "checkerboard": (_checkerboard, 1.0),
    "rotatedcheckerboard": (
        lambda u, v: _checkerboard(
            10.0 + u * np.cos(np.pi / 4) - v * np.sin(np.pi / 4),
            10.0 + u * np.sin(np.pi / 4) + v * np.cos(np.pi / 4),
        ) / 1.00006866455078125,
        1.0),
    "gaussian": (lambda u, v: _gauss1(u) * _gauss1(v),
                 _gauss_integral(-0.5, 0.5) ** 2),
}


def render_function(func_name: str = "step", *, width: int = 16,
                    height: int = 16, spp: int = 256,
                    sampler: str = "independent", seed: int = 0,
                    device=None):
    """Run the convergence test on `device` (the CUDA card by default):
    returns ((H, W) estimates at the full spp, [(n_samples, mse), ...] at
    the power-of-two counts, the content of <function>-mse.txt)."""
    if func_name not in FUNCTIONS:
        raise ValueError(
            f"unknown function '{func_name}' (have {sorted(FUNCTIONS)})")
    dev = resolve(device)
    f, exact = FUNCTIONS[func_name]
    n_pix = width * height
    pix_idx = torch.arange(n_pix, dtype=torch.int64, device=dev)
    pix_xy = torch.stack([pix_idx % width, pix_idx // width], -1)
    acc = torch.zeros((n_pix,), dtype=torch.float32, device=dev)
    mse_curve = []
    for s in range(spp):
        u1, u2, _ = samplers_mod.film_sample(
            sampler, pix_idx, torch.full((n_pix,), s, dtype=torch.int64,
                                         device=dev),
            spp, seed=seed, pix=pix_xy)
        acc = acc + f(u1, u2)
        n = s + 1
        if (n & (n - 1)) == 0:      # a power-of-two count
            mse_curve.append((n, float(torch.mean((acc / n - exact) ** 2))))
    est = (acc / spp).cpu().numpy().reshape(height, width)
    return est, mse_curve


def write_mse_file(path: str, mse_curve) -> None:
    """The "<function>-mse.txt" file (integrators.cpp:3412)."""
    with open(path, "w") as fh:
        for n, mse in mse_curve:
            fh.write(f"{n} {mse}\n")
