"""Sampling warps (port of acceleratedvolrenderer_tpu/ops/warps.py: the
exponential, three-way discrete, sphere, hemisphere, concentric-disk,
cosine-hemisphere, triangle and cone warps, their pdfs, and the MIS
heuristics)."""
from __future__ import annotations

import numpy as np
import torch

from ..utils.math import ONE_MINUS_EPSILON, safe_sqrt


def sample_exponential(u, a):
    """t ~ a exp(-a t) (pbrt sampling.h:222); u = 1 is clamped below 1."""
    u = torch.clamp(u, max=ONE_MINUS_EPSILON)
    return -torch.log1p(-u) / a


def exponential_pdf(x, a):
    return a * torch.exp(-a * x)


def sample_discrete3(u, w0, w1, w2):
    """One of three outcomes with probabilities proportional to (w0, w1,
    w2) (pbrt's SampleDiscrete, sampling.h:31): (index, pdf, u remapped
    into [0, 1) within the chosen outcome, reused as pbrt reuses it)."""
    total = w0 + w1 + w2
    p0, p1, p2 = w0 / total, w1 / total, w2 / total
    c1 = p0
    c2 = p0 + p1
    idx = torch.where(u < c1, 0, torch.where(u < c2, 1, 2))
    pdf = torch.where(idx == 0, p0, torch.where(idx == 1, p1, p2))
    lo = torch.where(idx == 0, 0.0, torch.where(idx == 1, c1, c2))
    u_new = torch.clamp((u - lo) / torch.clamp(pdf, min=1e-24),
                        max=ONE_MINUS_EPSILON)
    return idx, pdf, u_new


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


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta / np.pi


def sample_uniform_triangle(u):
    """Barycentrics (b0, b1, b2) of a uniform point on a triangle (pbrt's
    SampleUniformTriangle: the square folded onto b0 + b1 <= 1)."""
    b0 = u[..., 0] / 2.0
    b1 = u[..., 1] - b0
    flip = b0 > b1
    b0f = torch.where(flip, u[..., 0] - u[..., 1] / 2.0, b0)
    b1f = torch.where(flip, u[..., 1] / 2.0, b1)
    return torch.stack([b0f, b1f, 1.0 - b0f - b1f], dim=-1)


def sample_uniform_cone(u, cos_theta_max):
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * np.pi * u[..., 1]
    return torch.stack([sin_theta * torch.cos(phi),
                        sin_theta * torch.sin(phi), cos_theta], dim=-1)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * np.pi * (1.0 - cos_theta_max))


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """The beta = 2 power heuristic of MIS (pbrt's PowerHeuristic)."""
    f = nf * f_pdf
    g = ng * g_pdf
    f2 = f * f
    s = f2 + g * g
    return torch.where(s > 0.0, f2 / torch.clamp(s, min=1e-24), 0.0)


def balance_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    return torch.where(f + g > 0.0, f / torch.clamp(f + g, min=1e-24), 0.0)
