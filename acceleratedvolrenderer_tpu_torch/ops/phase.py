"""Henyey-Greenstein phase function (port of acceleratedvolrenderer_tpu/ops/phase.py).

`g` is a float32 tensor (0-d or broadcastable), as in the reference, so
every product involving it rounds in float32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import vecmath as vm
from ..utils.math import INV_4PI


def hg_p(cos_theta, g):
    g = torch.clamp(g, -0.99, 0.99)
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    denom = torch.clamp(denom, min=1e-7)
    return INV_4PI * (1.0 - g * g) / (denom * torch.sqrt(denom))


def hg_phase(wo, wi, g):
    """p(wo, wi), both pointing away from the scatter point."""
    return hg_p(vm.dot(wo, wi), g)


def hg_pdf(wo, wi, g):
    return hg_phase(wo, wi, g)


def sample_hg(wo, u, g):
    """Sample wi around wo by exact inversion; returns (wi, pdf)."""
    g = torch.clamp(g, -0.99, 0.99)
    gnz = torch.abs(g) > 1e-3
    sqr_term = (1.0 - g * g) / (1.0 + g - 2.0 * g * u[..., 0])
    cos_theta_aniso = (-(1.0 + g * g - sqr_term * sqr_term)
                       / (2.0 * g + torch.where(gnz, 0.0, 1.0)))
    cos_theta_iso = 1.0 - 2.0 * u[..., 0]
    cos_theta = torch.where(gnz, cos_theta_aniso, cos_theta_iso)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * np.pi * u[..., 1]
    wl = vm.spherical_direction(sin_theta, cos_theta, phi)
    x, y, z = vm.frame_from_z(wo)
    wi = vm.from_local(x, y, z, wl)
    return wi, hg_p(cos_theta, g)


def hg_phase_scalar_np(cos_theta, g):
    """HG phase value by cos(theta) in numpy float64, for table bakes
    (util/scattering.h HenyeyGreenstein)."""
    denom = 1 + g * g + 2 * g * np.asarray(cos_theta)
    return (1 - g * g) / (4 * np.pi * np.maximum(denom, 1e-9)
                          * np.sqrt(np.maximum(denom, 1e-9)))
