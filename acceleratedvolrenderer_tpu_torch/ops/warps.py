"""Sampling warps (port of acceleratedvolrenderer_tpu/ops/warps.py: the sphere,
hemisphere, concentric-disk and cosine-hemisphere warps)."""
from __future__ import annotations

import numpy as np
import torch

from ..utils.math import safe_sqrt


def sample_uniform_sphere(u):
    """u: (..., 2) -> unit directions (..., 3)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * np.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


UNIFORM_SPHERE_PDF = 1.0 / (4.0 * np.pi)


def sample_uniform_hemisphere(u):
    z = u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * np.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


UNIFORM_HEMISPHERE_PDF = 1.0 / (2.0 * np.pi)


def sample_uniform_disk_concentric(u):
    """Concentric (Shirley) disk mapping; u: (..., 2) -> (..., 2)."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(
        use_x,
        (np.pi / 4.0) * (oy / torch.where(ox == 0.0, 1.0, ox)),
        (np.pi / 2.0) - (np.pi / 4.0) * (ox / torch.where(oy == 0.0, 1.0,
                                                          oy)))
    degenerate = (ox == 0.0) & (oy == 0.0)
    x = torch.where(degenerate, 0.0, r * torch.cos(theta))
    y = torch.where(degenerate, 0.0, r * torch.sin(theta))
    return torch.stack([x, y], dim=-1)


def sample_cosine_hemisphere(u):
    d = sample_uniform_disk_concentric(u)
    z = safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return torch.stack([d[..., 0], d[..., 1], z], dim=-1)
