"""Sampling warps (port of acceleratedvolrenderer_tpu/ops/warps.py, the parts
the cloud render uses)."""
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
