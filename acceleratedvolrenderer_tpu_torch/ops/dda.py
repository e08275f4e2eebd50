"""Per-ray PCG streams, medium arrays and DDA set-up
(port of acceleratedvolrenderer_tpu/ops/dda.py).

uint32 arithmetic: CPU torch cannot add, shift or compare uint32 tensors,
so a PCG state is an int64 tensor holding a value in [0, 2^32), and every
step masks with 0xFFFFFFFF.  Products by constants >= 2^31 would reach
2^64 and wrap in int64; `_mul32` splits them into 16-bit halves so every
intermediate stays below 2^49 and the low 32 bits are exact.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.vecmath import intersect_aabb

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64 and a constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def pcg_step(state):
    """Advance PCG-RXS-M-XS-32; returns (new_state, output_bits)."""
    new = (state * 747796405 + 2891336453) & _M32
    # 277803737 < 2^29: the product stays below 2^61
    word = (((new >> ((new >> 28) + 4)) ^ new) * 277803737) & _M32
    out = (word >> 22) ^ word
    return new, out


def pcg_uniform(state):
    state, bits = pcg_step(state)
    return state, (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def pcg_uniform_masked(state, consume):
    """Draw a uniform; advance the stream only where `consume` is True."""
    new, u = pcg_uniform(state)
    return torch.where(consume, new, state), u


def seed_stream(pixel_index, sample_index, salt: int = 0):
    """Per-(pixel, sample, purpose) stream seed; indices are int64 tensors
    holding uint32 values (or python ints)."""
    x = torch.as_tensor(pixel_index, dtype=torch.int64) & _M32
    s = torch.as_tensor(sample_index, dtype=torch.int64,
                        device=x.device) & _M32
    h = (_mul32(x, 0x9E3779B9) + _mul32(s, 0x85EBCA6B) + (salt & _M32)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


class MediumArrays(NamedTuple):
    """Resolved per-render medium data, on the render device.

    density:  (nz, ny, nx) float32 density grid
    majorant: (rz, ry, rx) per-cell max density
    w2m:      (4, 4) world -> unit-cube medium transform
    g:        0-d float32 HG asymmetry
    density_s: optional frozen sampling-side density grid for the detached
              differentiable estimator (None => the density itself,
              detached); see volpath_fused
    sigma_a, sigma_s, Le: per-ray (N, L) or broadcastable spectra of the
              wave path (the regen path evaluates its own per lane)
    Le_grid:  optional per-voxel emission scale grid
    sigma_a_s, sigma_s_s: optional frozen sampling-side spectra
    g_s:      optional frozen sampling-side HG asymmetry
    minorant: optional (rz, ry, rx) per-cell min density, the control grid
              of residual ratio tracking on shadow segments
    sigma_a_rgb, sigma_s_rgb, Le_rgb: (nz, ny, nx, 3) per-voxel RGB
              coefficient grids of an RGB medium (Le_rgb optional)
    """
    density: torch.Tensor
    majorant: torch.Tensor
    w2m: torch.Tensor
    g: torch.Tensor
    density_s: Optional[torch.Tensor] = None
    sigma_a: Optional[torch.Tensor] = None
    sigma_s: Optional[torch.Tensor] = None
    Le: Optional[torch.Tensor] = None
    Le_grid: Optional[torch.Tensor] = None
    sigma_a_s: Optional[torch.Tensor] = None
    sigma_s_s: Optional[torch.Tensor] = None
    g_s: Optional[torch.Tensor] = None
    minorant: Optional[torch.Tensor] = None
    sigma_a_rgb: Optional[torch.Tensor] = None
    sigma_s_rgb: Optional[torch.Tensor] = None
    Le_rgb: Optional[torch.Tensor] = None


def world_to_medium(w2m, p):
    # elementwise multiply-add, as the reference writes it
    return (p[..., 0:1] * w2m[:3, 0] + p[..., 1:2] * w2m[:3, 1]
            + p[..., 2:3] * w2m[:3, 2] + w2m[:3, 3])


def world_dir_to_medium(w2m, d):
    return (d[..., 0:1] * w2m[:3, 0] + d[..., 1:2] * w2m[:3, 1]
            + d[..., 2:3] * w2m[:3, 2])


class DDAState(NamedTuple):
    voxel: torch.Tensor     # (N, 3) int32
    next_t: torch.Tensor    # (N, 3) world-t of the next axis crossing
    dt: torch.Tensor        # (N, 3) world-t per voxel (inf if axis-parallel)
    step: torch.Tensor      # (N, 3) int32 +-1
    t_exit: torch.Tensor    # (N,) world-t where the march stops
    in_medium: torch.Tensor  # (N,) bool


def dda_init(o, d, t_max, w2m, maj_res):
    """Amanatides-Woo set-up over the majorant grid; maj_res = (rx, ry, rz).
    Returns (DDAState, t0)."""
    om = world_to_medium(w2m, o)
    dm = world_dir_to_medium(w2m, d)
    hit, t0, t1 = intersect_aabb(om, dm, t_max, (0.0, 0.0, 0.0),
                                 (1.0, 1.0, 1.0))
    t0 = torch.where(hit, t0, 0.0)
    t1 = torch.where(hit, t1, 0.0)

    eps = 1e-6
    te = (t0 + eps)[..., None]
    p_entry = om + te * dm
    res = [float(r) for r in maj_res]
    pidx = torch.stack([p_entry[..., i] * res[i] for i in range(3)], dim=-1)
    voxel = torch.stack(
        [torch.clamp(torch.floor(pidx[..., i]).to(torch.int32), 0,
                     int(maj_res[i]) - 1) for i in range(3)], dim=-1)
    d_idx = torch.stack([dm[..., i] * res[i] for i in range(3)], dim=-1)
    pos = torch.where(d_idx > 0, 1.0, 0.0)
    nz = torch.abs(d_idx) > 1e-12
    inv = 1.0 / torch.where(nz, d_idx, 1.0)
    next_b = voxel.to(torch.float32) + pos
    next_t = torch.where(nz, te + (next_b - pidx) * inv, torch.inf)
    dt = torch.where(nz, torch.abs(inv), torch.inf)
    step = torch.where(d_idx > 0, 1, -1).to(torch.int32)
    return DDAState(voxel, next_t, dt, step, t1, hit), t0
