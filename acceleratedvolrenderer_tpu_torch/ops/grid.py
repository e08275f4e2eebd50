"""Dense grids, majorant and minorant grids
(port of acceleratedvolrenderer_tpu/ops/grid.py).

A grid is a float32 tensor in z-major order, (z * ny + y) * nx + x, with an
optional trailing channel axis (the RGB media's coefficient grids); lookups
out of range read 0, as pbrt's SampledGrid::Lookup.
"""
from __future__ import annotations

import numpy as np
import torch

_CORNERS = [(ox, oy, oz) for oz in (0, 1) for oy in (0, 1) for ox in (0, 1)]


def _cell(p_unit, dims):
    """Per-axis integer cell and fraction of the sample position p*n - 0.5."""
    nz, ny, nx = dims
    ps = torch.stack([p_unit[..., 0] * float(nx) - 0.5,
                      p_unit[..., 1] * float(ny) - 0.5,
                      p_unit[..., 2] * float(nz) - 0.5], dim=-1)
    pi0 = torch.floor(ps)
    return pi0.to(torch.int32), ps - pi0


def _flat_index(cx, cy, cz, dims):
    nz, ny, nx = dims
    inside = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
              & (cz >= 0) & (cz < nz))
    flat = ((torch.clamp(cz, 0, nz - 1) * ny + torch.clamp(cy, 0, ny - 1)) * nx
            + torch.clamp(cx, 0, nx - 1))
    return flat, inside


def _corners(p_unit, dims):
    """Flat indices (..., 8) of the 8 trilerp corners and their weights,
    out-of-range corners weighted 0."""
    pi, d = _cell(p_unit, dims)
    corner = torch.tensor(_CORNERS, dtype=torch.int32, device=pi.device)
    c = pi[..., None, :] + corner                       # (..., 8, 3)
    flat, inside = _flat_index(c[..., 0], c[..., 1], c[..., 2], dims)
    up = corner == 1
    w3 = torch.where(up, d[..., None, :], 1.0 - d[..., None, :])
    w = torch.where(inside, w3[..., 0] * w3[..., 1] * w3[..., 2], 0.0)
    return flat.long(), w


def trilerp_flat(grid_flat, dims, p_unit):
    """Trilinear lookup of a flat (nz*ny*nx,) grid at [0,1]^3 points."""
    flat, w = _corners(p_unit, dims)
    return torch.sum(grid_flat[flat] * w, dim=-1)


def trilerp(grid, p_unit):
    """Trilinear lookup of an (nz, ny, nx) grid at [0,1]^3 points (x, y, z);
    sample positions p * n - 0.5, as pbrt's."""
    return trilerp_flat(grid.reshape(-1), tuple(grid.shape), p_unit)


def trilerp_vec(grid, p_unit):
    """Trilinear lookup of an (nz, ny, nx, C) grid -> (..., C)."""
    nz, ny, nx, C = grid.shape
    flat, w = _corners(p_unit, (nz, ny, nx))
    return torch.sum(grid.reshape(-1, C)[flat] * w[..., None], dim=-2)


def max_value_range(density: np.ndarray, lo: np.ndarray,
                    hi: np.ndarray) -> float:
    """Max over the density-sample index range covering the continuous
    bounds [lo, hi] in [0,1]^3 (pbrt's SampledGrid::MaxValue), host-side."""
    nz, ny, nx = density.shape
    n = np.array([nx, ny, nz], np.float64)
    p0 = np.maximum(np.floor(lo * n - 0.5).astype(np.int64), 0)
    p1 = np.minimum(np.floor(hi * n - 0.5).astype(np.int64) + 1,
                    n.astype(np.int64) - 1)
    if np.any(p1 < p0):
        return 0.0
    return float(
        density[p0[2]: p1[2] + 1, p0[1]: p1[1] + 1, p0[0]: p1[0] + 1].max())


def _axis_ranges(r, nn):
    c = np.arange(r)
    lo = np.maximum(np.floor(c / r * nn - 0.5).astype(np.int64), 0)
    hi = np.minimum(np.floor((c + 1) / r * nn - 0.5).astype(np.int64) + 1,
                    nn - 1)
    return lo, hi


def _extremum_grid(density, res, op: str):
    """Per-cell extremum (op 'amax' or 'amin') of a (nz, ny, nx) numpy
    array or tensor over each of the res = (rx, ry, rz) cells' continuous
    bounds, reduced along x, then y, then z: an (rz, ry, rx) grid of the
    same kind (a tensor's stays on its device and carries its gradient)."""
    xp = torch if torch.is_tensor(density) else np
    rx, ry, rz = res
    nz, ny, nx = density.shape
    lox, hix = _axis_ranges(rx, nx)
    loy, hiy = _axis_ranges(ry, ny)
    loz, hiz = _axis_ranges(rz, nz)
    red = lambda a, l, h, ax: getattr(xp, op)(
        a[(slice(None),) * ax + (slice(int(l), int(h) + 1),)], ax)
    mx = xp.stack([red(density, l, h, 2) for l, h in zip(lox, hix)], -1)
    mxy = xp.stack([red(mx, l, h, 1) for l, h in zip(loy, hiy)], 1)
    return xp.stack([red(mxy, l, h, 0) for l, h in zip(loz, hiz)], 0)


def build_majorant_grid(density: np.ndarray, res=(16, 16, 16)) -> np.ndarray:
    """Host-side (rz, ry, rx) per-cell max density over each cell's
    continuous bounds (pbrt media.cpp:240-246)."""
    return _extremum_grid(np.asarray(density, np.float32), res, "amax")


def build_majorant_grid_torch(density: torch.Tensor,
                              res=(16, 16, 16)) -> torch.Tensor:
    """build_majorant_grid of a density tensor on its own device (the
    reference's build_majorant_grid_jax): rebuilt when an optimized density
    changes, with the same index ranges."""
    return _extremum_grid(density, res, "amax")


def build_minorant_grid(density: np.ndarray, res=(16, 16, 16)) -> np.ndarray:
    """Host-side (rz, ry, rx) per-cell MIN density over the same bounds: the
    control grid of residual ratio tracking.  Every trilerp (or 1-tap)
    value inside a cell is a convex combination of the cell's samples, so
    it is a lower bound."""
    return _extremum_grid(np.asarray(density, np.float32), res, "amin")


def stochastic_corner(dims, p_unit, u3):
    """Pick ONE trilerp corner, the upper one per axis with probability
    frac, so E[grid[corner]] == trilerp.  Returns (flat index, inside)."""
    pi, d = _cell(p_unit, dims)
    c = pi + (u3 < d).to(torch.int32)
    return _flat_index(c[..., 0], c[..., 1], c[..., 2], dims)


def trilerp_stochastic_flat(grid_flat, dims, p_unit, u3):
    """1-tap stochastic trilerp (see stochastic_corner)."""
    flat, inside = stochastic_corner(dims, p_unit, u3)
    return torch.where(inside, grid_flat[flat.long()], 0.0)


def trilerp_vec_stochastic(grid, p_unit, u3):
    """1-tap stochastic trilerp of an (nz, ny, nx, C) grid -> (..., C); the
    C channels share the corner draw."""
    nz, ny, nx, C = grid.shape
    flat, inside = stochastic_corner((nz, ny, nx), p_unit, u3)
    return torch.where(inside[..., None], grid.reshape(-1, C)[flat.long()],
                       0.0)
