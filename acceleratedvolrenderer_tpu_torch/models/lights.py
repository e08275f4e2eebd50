"""Lights and light sampling (port of acceleratedvolrenderer_tpu/models/lights.py:
DistantLight, PointLight, SpotLight, UniformInfiniteLight, DiffuseAreaLight,
the uniform, power and bvh light samplers, pdf_one_light and
escaped_radiance).

Every light is a set of batched functions of the shading points; the light
sampler evaluates the K candidate samples unbranched and selects by the
sampled index.  Spectra are callables lam -> value.  The image, portal,
projection and goniometric lights are not ported and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, NamedTuple

import numpy as np
import torch

from ..ops import warps
from ..utils import vecmath as vm
from ..utils.device import per_device
from ..utils.math import smoothstep


class LightLiSample(NamedTuple):
    L: torch.Tensor       # (N, LANES)
    wi: torch.Tensor      # (N, 3)
    dist: torch.Tensor    # (N,) distance to the light sample
    pdf: torch.Tensor     # (N,) solid-angle pdf
    valid: torch.Tensor   # (N,) bool


def _f32_on(lt, device, *arrays):
    return per_device(lt, device, lambda dev: tuple(
        torch.as_tensor(np.asarray(a, np.float32), device=dev)
        for a in arrays))


class _NoEscape:
    """A light that contributes nothing to escaped rays and is never hit
    by path sampling: its pdf_li is 0."""

    def pdf_li(self, p, wi):
        return torch.zeros((p.shape[0],), device=p.device)

    def le_escaped(self, d, lam):
        return torch.zeros_like(lam)

    def to(self, device):
        return self


@dataclass(frozen=True)
class DistantLight(_NoEscape):
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


def _toward(pl, p):
    """(wi, dist, dist^2) from points p toward the point pl."""
    to = pl - p
    d2 = torch.clamp(vm.length_squared(to), min=1e-12)
    dist = torch.sqrt(d2)
    return to / dist[..., None], dist, d2


@dataclass(frozen=True)
class PointLight(_NoEscape):
    position: np.ndarray
    spectrum: Callable                  # lam -> radiant intensity
    scale: float = 1.0
    is_delta = True
    is_infinite = False

    def sample_li(self, p, u2, lam):
        (pl,) = _f32_on(self, p.device, self.position)
        wi, dist, d2 = _toward(pl, p)
        L = self.spectrum(lam) * self.scale / d2[..., None]
        return LightLiSample(L, wi, dist, torch.ones_like(dist),
                             torch.ones(dist.shape, dtype=torch.bool,
                                        device=p.device))


@dataclass(frozen=True)
class SpotLight(_NoEscape):
    """Spot light (lights.h:742): smooth falloff between the cosines of
    cone_angle - cone_delta and cone_angle."""
    position: np.ndarray
    direction: np.ndarray               # unit cone axis
    spectrum: Callable
    scale: float = 1.0
    cone_angle_deg: float = 30.0
    cone_delta_deg: float = 5.0
    is_delta = True
    is_infinite = False

    def sample_li(self, p, u2, lam):
        pl, axis = _f32_on(self, p.device, self.position, self.direction)
        wi, dist, d2 = _toward(pl, p)
        cos_t = vm.dot(-wi, axis)
        cos_end = np.cos(np.deg2rad(self.cone_angle_deg))
        cos_start = np.cos(np.deg2rad(self.cone_angle_deg
                                      - self.cone_delta_deg))
        falloff = smoothstep(cos_t, cos_end, cos_start)
        L = (self.spectrum(lam) * self.scale * falloff[..., None]
             / d2[..., None])
        return LightLiSample(L, wi, dist, torch.ones_like(dist), falloff > 0)


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


@dataclass(frozen=True)
class DiffuseAreaLight:
    """Area emitter over a shape (lights.h:415): uniform-area sampling
    turned into solid angle; pdf_li intersects the shape again."""
    shape: object                       # models/shapes.py
    spectrum: Callable                  # lam -> emitted radiance
    scale: float = 1.0
    two_sided: bool = False
    is_delta = False
    is_infinite = False

    def to(self, device):
        return self

    def sample_li(self, p, u2, lam):
        pl, nl, pdf_area = self.shape.sample(u2)
        wi, dist, d2 = _toward(pl, p)
        cos_l = vm.dot(nl, -wi)
        emit = (cos_l > 0) | self.two_sided
        pdf_sa = pdf_area * d2 / torch.clamp(torch.abs(cos_l), min=1e-9)
        L = torch.where(emit[..., None],
                        (self.spectrum(lam) * self.scale).expand(lam.shape),
                        0.0)
        return LightLiSample(L, wi, dist * (1.0 - 1e-3), pdf_sa,
                             emit & (torch.abs(cos_l) > 1e-9))

    def pdf_li(self, p, wi):
        t, n, _ = self.shape.intersect(p, wi, torch.inf)
        cos_l = torch.abs(vm.dot(n, -wi))
        return torch.where(torch.isfinite(t), t * t / (
            torch.clamp(cos_l, min=1e-9) * self.shape.area()), 0.0)

    def le_escaped(self, d, lam):
        return torch.zeros_like(lam)

    def power_estimate(self) -> float:
        # phi = L * area * pi (* 2 when two-sided)
        sides = 2.0 if self.two_sided else 1.0
        return float(self.scale * self.shape.area() * np.pi * sides)


class _NextSlice:
    """A light of the reference that waits for the next slice of the port."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__}: not ported yet: the image, portal, "
            "projection and goniometric lights come with the sampler slice "
            "(ROADMAP Queue 1 item 3)")


class ImageInfiniteLight(_NextSlice):
    pass


class PortalImageInfiniteLight(_NextSlice):
    pass


class ProjectionLight(_NextSlice):
    pass


class GoniometricLight(_NextSlice):
    pass


def light_power(lt) -> float:
    """Scalar power proxy of the power light sampler (lightsamplers.h)."""
    if hasattr(lt, "power_estimate"):
        return max(lt.power_estimate(), 1e-9)
    if isinstance(lt, PointLight):
        return max(4 * np.pi * lt.scale, 1e-9)
    if isinstance(lt, SpotLight):
        cos_end = np.cos(np.deg2rad(lt.cone_angle_deg))
        return max(2 * np.pi * (1 - cos_end) * lt.scale, 1e-9)
    if isinstance(lt, DistantLight):
        return max(np.pi * lt.scene_radius ** 2 * lt.scale, 1e-9)
    if isinstance(lt, UniformInfiniteLight):
        return max(4 * np.pi * np.pi * lt.scene_radius ** 2 * lt.scale, 1e-9)
    return 1.0


def _light_center(lt):
    """A representative position for the adaptive (bvh) importance."""
    if hasattr(lt, "position"):
        return np.asarray(lt.position, np.float32)
    shape = getattr(lt, "shape", None)
    if shape is not None:
        if hasattr(shape, "center"):
            return np.asarray(shape.center, np.float32)
        if hasattr(shape, "origin"):
            o = np.asarray(shape.origin, np.float32)
            e1 = np.asarray(getattr(shape, "e1", 0.0), np.float32)
            e2 = np.asarray(getattr(shape, "e2", 0.0), np.float32)
            return o + 0.5 * e1 + 0.5 * e2
    return np.zeros(3, np.float32)


def _bvh_consts(lt, device):
    """(center, spot axis or None, area-light normal or None) as tensors."""
    def make(dev):
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                         device=dev)
        axis = nrm = None
        if isinstance(lt, SpotLight):
            axis = as_t(lt.direction)
            axis = axis / torch.linalg.norm(axis)
        elif isinstance(lt, DiffuseAreaLight) and hasattr(lt.shape, "e1"):
            nv = np.cross(np.asarray(lt.shape.e1, np.float64),
                          np.asarray(lt.shape.e2, np.float64))
            ln = np.linalg.norm(nv)
            if ln > 0:
                nrm = as_t((nv / ln).astype(np.float32))
        return as_t(_light_center(lt)), axis, nrm
    return per_device(lt, ("bvh", str(device)), lambda _: make(device))


def _adaptive_pmfs(lights: List, p):
    """Per-point light pmfs (N, K): the BVH light sampler's importance
    phi cos(theta') / d^2 (lightsamplers.h:260) computed exactly over all K
    lights, with the reference's pInfinite split for infinite lights."""
    n = p.shape[0]
    dev = p.device
    k = len(lights)
    inf_mask = [bool(lt.is_infinite) for lt in lights]
    n_inf = sum(inf_mask)
    n_fin = k - n_inf
    p_infinite = n_inf / (n_inf + (1 if n_fin else 0)) if k else 0.0
    imps = []
    for lt in lights:
        if lt.is_infinite:
            imps.append(torch.zeros((n,), device=dev))
            continue
        phi = float(light_power(lt))
        if isinstance(lt, DistantLight):
            # an unbounded directional light: constant importance
            imps.append(torch.full((n,), phi, device=dev))
            continue
        c, axis, nrm = _bvh_consts(lt, dev)
        to = p - c
        d2 = torch.clamp(vm.length_squared(to), min=1e-8)
        imp = phi / d2
        if axis is not None:
            # the cone's falloff (LightBounds orientation cone)
            cos_p = vm.dot(to, axis) / torch.sqrt(d2)
            cos_cone = float(np.cos(np.deg2rad(lt.cone_angle_deg)))
            imp = imp * torch.where(cos_p >= cos_cone, 1.0, 1e-3)
        elif nrm is not None and not lt.two_sided:
            cos_t = vm.dot(to, nrm) / torch.sqrt(d2)
            imp = imp * torch.clamp(cos_t, min=1e-3)
        imps.append(imp)
    imp_mat = torch.stack(imps, -1)
    fin_sum = torch.clamp(torch.sum(imp_mat, -1), min=1e-30)
    pmf = imp_mat / fin_sum[:, None] * (1.0 - p_infinite)
    if n_inf:
        # the infinite lights' columns (importance 0) take pInfinite / n_inf
        share = torch.full((n,), float(np.float32(p_infinite / n_inf)),
                           device=dev)
        pmf = torch.stack([share if inf else pmf[:, i]
                           for i, inf in enumerate(inf_mask)], -1)
    return pmf


def _power_pmfs(lights):
    pw = np.asarray([light_power(lt) for lt in lights], np.float64)
    return pw / pw.sum()


def sample_one_light(lights: List, p, u1, u2, lam, strategy: str = "uniform"):
    """Pick one light with pmf 1/K ("uniform"), proportional to its power
    ("power") or to its importance at each point ("bvh"), and return its
    sample with the pmf folded into the pdf, plus the per-lane delta flag."""
    if strategy not in ("uniform", "power", "bvh"):
        raise ValueError(f"unknown light sampler {strategy!r}")
    k = len(lights)
    n = p.shape[0]
    dev = p.device
    if k == 0:
        z = torch.zeros((n,), device=dev)
        return (LightLiSample(torch.zeros_like(lam),
                              torch.zeros((n, 3), device=dev), z, z, z > 0),
                z > 0)
    pmf = None
    if strategy == "bvh":
        pmf_point = _adaptive_pmfs(lights, p)
        cdf = torch.cumsum(pmf_point, -1)
        idx = torch.clamp((u1[:, None] >= cdf).sum(-1), 0, k - 1)
        pmf = torch.gather(pmf_point, 1, idx[:, None])[:, 0]
    elif strategy == "power":
        pmfs = _power_pmfs(lights).astype(np.float32)
        cdf = np.cumsum(_power_pmfs(lights)).astype(np.float32)
        # searchsorted (left) on the float32 cdf: the count of entries < u1
        idx = torch.clamp(sum((u1 > float(c)).to(torch.int64) for c in cdf),
                          0, k - 1)
        pmf = torch.full((n,), float(pmfs[0]), device=dev)
        for i in range(1, k):
            pmf = torch.where(idx == i, float(pmfs[i]), pmf)
    else:
        idx = torch.clamp((u1 * k).to(torch.int64), max=k - 1)
    samples = [lt.sample_li(p, u2, lam) for lt in lights]
    out = samples[0]
    is_delta = torch.full((n,), bool(lights[0].is_delta), device=dev)
    for i in range(1, k):
        sel = idx == i
        s = samples[i]
        out = LightLiSample(
            torch.where(sel[:, None], s.L, out.L),
            torch.where(sel[:, None], s.wi, out.wi),
            torch.where(sel, s.dist, out.dist),
            torch.where(sel, s.pdf, out.pdf),
            torch.where(sel, s.valid, out.valid))
        is_delta = torch.where(sel, bool(lights[i].is_delta), is_delta)
    if pmf is None:
        # the uniform pmf, rounded to float32 as the reference's table is
        pmf = float(np.float32(1.0 / k))
    return LightLiSample(out.L, out.wi, out.dist, out.pdf * pmf,
                         out.valid), is_delta


def pdf_one_light(lights: List, p, wi, strategy: str = "uniform"):
    """The pmf-weighted PDF_Li summed over the non-delta lights: the light
    strategy's pdf of a path-sampled emitter hit, for MIS."""
    k = len(lights)
    n = p.shape[0]
    pdf = torch.zeros((n,), device=p.device)
    if k == 0:
        return pdf
    if strategy == "bvh":
        pmf_mat = _adaptive_pmfs(lights, p)
        for i, lt in enumerate(lights):
            if not lt.is_delta:
                pdf = pdf + lt.pdf_li(p, wi) * pmf_mat[:, i]
        return pdf
    pmfs = (_power_pmfs(lights) if strategy == "power"
            else np.full((k,), 1.0 / k))
    for lt, pm in zip(lights, pmfs):
        if not lt.is_delta:
            pdf = pdf + lt.pdf_li(p, wi) * float(pm)
    return pdf


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
