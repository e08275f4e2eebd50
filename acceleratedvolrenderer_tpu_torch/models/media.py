"""Participating media (port of acceleratedvolrenderer_tpu/models/media.py:
MediumSpec with build_arrays, world_to_unit, the procedural cloud bake and
homogeneous_box)."""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops import grid as gridops
from ..ops.dda import MediumArrays

BAKE_SLAB = 4     # z-planes per task of bake_cloud_density's thread pool


@dataclass(frozen=True)
class MediumSpec:
    """A homogeneous medium (no density, no RGB grids), a scalar grid
    (`density`, a (nz, ny, nx) float32 tensor) or an RGB grid medium
    (`sigma_a_rgb` / `sigma_s_rgb` and optionally `Le_rgb`, (nz, ny, nx, 3)
    float32 tensors; `density` is then ignored), its tensors on the device
    the scene was built for.  `majorant`, when given, is the prebuilt
    (rz, ry, rx) majorant (else build_majorant makes it)."""
    sigma_a_spec: Callable             # lam -> absorption cross-section
    sigma_s_spec: Callable             # lam -> scattering cross-section
    g: float = 0.0
    scale: float = 1.0
    density: Optional[torch.Tensor] = None
    bounds_lo: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    bounds_hi: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    Le_spec: Optional[Callable] = None
    Le_scale: float = 1.0
    majorant_res: Tuple[int, int, int] = (16, 16, 16)
    m2w: Optional[np.ndarray] = None   # optional (4, 4) medium -> world
    majorant: Optional[torch.Tensor] = None
    sigma_a_rgb: Optional[torch.Tensor] = None
    sigma_s_rgb: Optional[torch.Tensor] = None
    Le_rgb: Optional[torch.Tensor] = None

    @property
    def rgb(self) -> bool:
        return self.sigma_a_rgb is not None

    @property
    def homogeneous(self) -> bool:
        return self.density is None and not self.rgb

    def maj_res(self):
        return (1, 1, 1) if self.homogeneous else tuple(self.majorant_res)

    def build_majorant(self, device=None) -> torch.Tensor:
        """(rz, ry, rx) per-cell majorant: a 1^3 table of ones for a
        homogeneous medium; for an RGB medium the per-cell max over the
        channels of (sigma_a + sigma_s) * scale (pbrt media.cpp:364-376);
        else the per-cell max density.  On `device`, else on the grid's
        device (the CPU for a homogeneous medium)."""
        if self.majorant is not None:
            return self.majorant.to(device)
        if self.homogeneous:
            return torch.ones((1, 1, 1), dtype=torch.float32, device=device)
        grid = self.sigma_a_rgb if self.rgb else self.density
        if self.rgb:
            st = (self.sigma_a_rgb.cpu().numpy().astype(np.float32)
                  + self.sigma_s_rgb.cpu().numpy().astype(np.float32)
                  ).max(axis=-1)
            maj = gridops.build_majorant_grid(st * self.scale, self.maj_res())
        else:
            maj = gridops.build_majorant_grid(self.density.cpu().numpy(),
                                              self.maj_res())
        return torch.as_tensor(maj, device=device or grid.device)

    def world_to_unit(self) -> np.ndarray:
        """(4, 4) float64 world -> [0,1]^3 medium matrix."""
        lo = np.asarray(self.bounds_lo, np.float64)
        hi = np.asarray(self.bounds_hi, np.float64)
        s = np.eye(4)
        s[:3, :3] = np.diag(1.0 / (hi - lo))
        s[:3, 3] = -lo / (hi - lo)
        if self.m2w is not None:
            return s @ np.linalg.inv(np.asarray(self.m2w, np.float64))
        return s

    def build_arrays(self, lam) -> MediumArrays:
        """MediumArrays at the sampled wavelengths lam ((N, LANES) or
        (1, LANES)), every tensor on lam's device."""
        dev = lam.device
        f32 = torch.float32
        if self.homogeneous or self.rgb:
            dens = torch.ones((1, 1, 1), dtype=f32, device=dev)
        else:
            dens = torch.as_tensor(self.density, dtype=f32, device=dev)
        Le = (self.Le_spec(lam) * self.Le_scale if self.Le_spec is not None
              else torch.zeros_like(lam))
        kw = {}
        if self.rgb:
            grid = lambda t, s: torch.as_tensor(t, dtype=f32, device=dev) * s
            kw = dict(sigma_a_rgb=grid(self.sigma_a_rgb, self.scale),
                      sigma_s_rgb=grid(self.sigma_s_rgb, self.scale),
                      Le_rgb=(grid(self.Le_rgb, self.Le_scale)
                              if self.Le_rgb is not None else None))
        return MediumArrays(
            density=dens, majorant=self.build_majorant(dev),
            w2m=torch.as_tensor(self.world_to_unit(), dtype=f32, device=dev),
            g=torch.tensor(self.g, dtype=f32, device=dev),
            sigma_a=self.sigma_a_spec(lam) * self.scale,
            sigma_s=self.sigma_s_spec(lam) * self.scale, Le=Le, **kw)


def bake_cloud_density(res=(128, 128, 128), density=1.0, wispiness=1.0,
                       extent=0.5, frequency=5.0, seed=0) -> np.ndarray:
    """Procedural cumulus-style density baked to a dense (nz, ny, nx) grid:
    a radial falloff sphere modulated by hash-based fractal value noise.
    Host-side numpy, identical to the reference bake bit for bit: each
    voxel takes the same operations, done in slabs of BAKE_SLAB z-planes
    on a pool of threads (numpy's loops release the GIL)."""
    nx, ny, nz = res
    lz, ly, lx = (np.linspace(0, 1, nz), np.linspace(0, 1, ny),
                  np.linspace(0, 1, nx))
    table = np.random.default_rng(seed).random(4096).astype(np.float32)

    def value_noise(q, f):
        qi = np.floor(q * f).astype(np.int64)
        qf = q * f - qi
        qf = qf * qf * (3 - 2 * qf)

        def h(ix, iy, iz):
            v = (ix * 73856093) ^ (iy * 19349663) ^ (iz * 83492791)
            return table[np.abs(v) % table.size]

        c000 = h(qi[..., 0], qi[..., 1], qi[..., 2])
        c100 = h(qi[..., 0] + 1, qi[..., 1], qi[..., 2])
        c010 = h(qi[..., 0], qi[..., 1] + 1, qi[..., 2])
        c110 = h(qi[..., 0] + 1, qi[..., 1] + 1, qi[..., 2])
        c001 = h(qi[..., 0], qi[..., 1], qi[..., 2] + 1)
        c101 = h(qi[..., 0] + 1, qi[..., 1], qi[..., 2] + 1)
        c011 = h(qi[..., 0], qi[..., 1] + 1, qi[..., 2] + 1)
        c111 = h(qi[..., 0] + 1, qi[..., 1] + 1, qi[..., 2] + 1)
        fx, fy, fz = qf[..., 0], qf[..., 1], qf[..., 2]
        c00 = c000 * (1 - fx) + c100 * fx
        c10 = c010 * (1 - fx) + c110 * fx
        c01 = c001 * (1 - fx) + c101 * fx
        c11 = c011 * (1 - fx) + c111 * fx
        return (c00 * (1 - fy) + c10 * fy) * (1 - fz) + (c01 * (1 - fy) + c11 * fy) * fz

    noise = np.zeros((nz, ny, nx), np.float32)
    base = np.empty((nz, ny, nx))

    def slab(z0):
        zs, ys, xs = np.meshgrid(lz[z0:z0 + BAKE_SLAB], ly, lx, indexing="ij")
        p = np.stack([xs, ys, zs], -1) - 0.5
        n = noise[z0:z0 + BAKE_SLAB]
        amp, f = 1.0, frequency
        for _ in range(4):
            n += amp * value_noise(p + 0.5, f)
            amp *= 0.5 * wispiness
            f *= 2.0
        r = np.linalg.norm(p, axis=-1)
        base[z0:z0 + BAKE_SLAB] = np.clip(1.0 - r / extent, 0.0, 1.0)

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(slab, range(0, nz, BAKE_SLAB)))
    noise /= noise.max() + 1e-9
    d = density * base * (0.5 + 0.5 * noise)
    return d.astype(np.float32)


def homogeneous_box(sigma_a_spec, sigma_s_spec, lo, hi, g=0.0, scale=1.0,
                    Le_spec=None, Le_scale=1.0) -> MediumSpec:
    """A homogeneous medium filling the box [lo, hi]."""
    return MediumSpec(
        sigma_a_spec=sigma_a_spec, sigma_s_spec=sigma_s_spec, g=g, scale=scale,
        density=None, bounds_lo=np.asarray(lo, np.float32),
        bounds_hi=np.asarray(hi, np.float32), Le_spec=Le_spec,
        Le_scale=Le_scale)
