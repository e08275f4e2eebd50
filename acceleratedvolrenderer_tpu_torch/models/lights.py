"""Lights and uniform light sampling (port of acceleratedvolrenderer_tpu/models/lights.py:
DistantLight, UniformInfiniteLight, sample_one_light and escaped_radiance)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, NamedTuple

import torch

from ..ops import warps


class LightLiSample(NamedTuple):
    L: torch.Tensor       # (N, LANES)
    wi: torch.Tensor      # (N, 3)
    dist: torch.Tensor    # (N,) distance to the light sample
    pdf: torch.Tensor     # (N,) solid-angle pdf
    valid: torch.Tensor   # (N,) bool


@dataclass(frozen=True)
class DistantLight:
    """Directional light; `direction` is the (3,) float32 unit propagation
    direction of the emitted radiance, on the render device."""
    direction: torch.Tensor
    spectrum: Callable                  # lam -> emitted radiance
    scale: float = 1.0
    scene_radius: float = 1e4
    is_delta = True
    is_infinite = False

    def to(self, device):
        return DistantLight(self.direction.to(device), self.spectrum,
                            self.scale, self.scene_radius)

    def sample_li(self, p, u2, lam):
        n = p.shape[0]
        wi = (-self.direction).expand(n, 3)
        L = (self.spectrum(lam) * self.scale).expand(lam.shape)
        dist = torch.full((n,), 2.0 * self.scene_radius, device=p.device)
        ones = torch.ones((n,), device=p.device)
        return LightLiSample(L, wi, dist, ones, ones > 0)


@dataclass(frozen=True)
class UniformInfiniteLight:
    """Constant environment light."""
    spectrum: Callable
    scale: float = 1.0
    scene_radius: float = 1e4
    is_delta = False
    is_infinite = True

    def to(self, device):
        return self

    def sample_li(self, p, u2, lam):
        n = p.shape[0]
        wi = warps.sample_uniform_sphere(u2)
        L = (self.spectrum(lam) * self.scale).expand(lam.shape)
        dist = torch.full((n,), 2.0 * self.scene_radius, device=p.device)
        pdf = torch.full((n,), warps.UNIFORM_SPHERE_PDF, device=p.device)
        return LightLiSample(L, wi, dist, pdf,
                             torch.ones((n,), dtype=torch.bool,
                                        device=p.device))

    def pdf_li(self, p, wi):
        return torch.full((p.shape[0],), warps.UNIFORM_SPHERE_PDF,
                          device=p.device)

    def le_escaped(self, d, lam):
        return self.spectrum(lam) * self.scale


def sample_one_light(lights: List, p, u1, u2, lam, strategy: str = "uniform"):
    """Pick one light with pmf 1/K and return its sample, pdf times pmf,
    plus the per-lane delta flag."""
    if strategy != "uniform":
        raise NotImplementedError(f"light sampler {strategy!r}: only "
                                  "'uniform' is ported")
    k = len(lights)
    n = p.shape[0]
    if k == 0:
        z = torch.zeros((n,), device=p.device)
        return (LightLiSample(torch.zeros_like(lam),
                              torch.zeros((n, 3), device=p.device), z, z,
                              z > 0), z > 0)
    idx = torch.clamp((u1 * k).to(torch.int32), max=k - 1)
    samples = [lt.sample_li(p, u2, lam) for lt in lights]
    out = samples[0]
    is_delta = torch.full((n,), bool(lights[0].is_delta), device=p.device)
    for i in range(1, k):
        sel = idx == i
        s = samples[i]
        out = LightLiSample(
            torch.where(sel[:, None], s.L, out.L),
            torch.where(sel[:, None], s.wi, out.wi),
            torch.where(sel, s.dist, out.dist),
            torch.where(sel, s.pdf, out.pdf),
            torch.where(sel, s.valid, out.valid),
        )
        is_delta = torch.where(sel, bool(lights[i].is_delta), is_delta)
    pmf = float(torch.tensor(1.0 / k, dtype=torch.float32))
    return LightLiSample(out.L, out.wi, out.dist, out.pdf * pmf,
                         out.valid), is_delta


def escaped_radiance(lights: List, d, lam):
    """Sum of Le over infinite lights for escaped rays, plus the uniform
    sampler's MIS pdf (pmf * PDF_Li) over the non-delta ones."""
    L = torch.zeros_like(lam)
    pdf = torch.zeros((d.shape[0],), device=d.device)
    k = max(len(lights), 1)
    for lt in lights:
        if lt.is_infinite:
            L = L + lt.le_escaped(d, lam)
            pdf = pdf + lt.pdf_li(d, d) / k
    return L, pdf
