"""VoxelBoundary: capture of a medium's boundary as a voxel shell
(port of acceleratedvolrenderer_tpu/graph/voxels.py, plain numpy).

Sphere-point ray grids record the first non-zero-majorant crossing per ray
(a vectorized DDA against the majorant grid), a binary search shrinks the
voxel spacing to a target vertex count, and a 6-neighbour dilation to a
fixpoint keeps one boundary layer and fills the interior.  Outputs are
graph/model.py::Graph objects.
"""
from __future__ import annotations

import numpy as np

from .model import Graph


def sphere_surface_points(center, radius, equator_step: float) -> np.ndarray:
    """Latitude-ring sphere points (graph/util.h:134
    GetSphereSurfacePoints): rings spaced so arc length ~ equator_step."""
    center = np.asarray(center, np.float64)
    n_rings = max(int(np.ceil(np.pi * radius / equator_step)), 2)
    pts = []
    for i in range(n_rings + 1):
        theta = np.pi * i / n_rings
        r_ring = radius * np.sin(theta)
        n_pts = max(int(np.ceil(2 * np.pi * r_ring / equator_step)), 1)
        phi = 2 * np.pi * np.arange(n_pts) / n_pts
        pts.append(np.stack([
            r_ring * np.cos(phi),
            np.full(n_pts, radius * np.cos(theta)),
            r_ring * np.sin(phi)], -1))
    return (center + np.concatenate(pts)).astype(np.float32)


def _first_nonzero_crossing(majorant, lo, hi, o, d):
    """Vectorized DDA: entry point of each ray's first non-zero-majorant
    voxel (NaN rows where none).  o, d: (N, 3) world; grid bounds lo..hi."""
    maj = np.asarray(majorant)
    rz, ry, rx = maj.shape
    res = np.array([rx, ry, rz], np.float64)
    ext = hi - lo
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    inv_d = 1.0 / np.where(np.abs(d) > 1e-12, d,
                           np.where(d >= 0, 1e-12, -1e-12))
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_near = np.maximum(np.minimum(t0, t1).max(-1), 0.0)
    t_far = np.maximum(t0, t1).min(-1)
    alive = t_near <= t_far
    t = t_near + 1e-6
    n = o.shape[0]
    out = np.full((n, 3), np.nan, np.float32)
    found = np.zeros(n, bool)
    max_steps = int(res.sum()) + 3
    cell_w = ext / res
    for _ in range(max_steps):
        active = alive & ~found & (t <= t_far)
        if not active.any():
            break
        p = o + t[:, None] * d
        c = np.clip(((p - lo) / ext * res).astype(np.int64), 0,
                    (res - 1).astype(np.int64))
        nz = maj[c[:, 2], c[:, 1], c[:, 0]] > 0
        hit = active & nz
        out[hit] = p[hit]
        found |= hit
        # advance to the next voxel boundary
        nxt = lo + (c + (d >= 0)) * cell_w
        t_step = ((nxt - p) * inv_d).min(-1)
        t = np.where(active & ~hit, t + np.maximum(t_step, 1e-6) + 1e-6, t)
    return out, found


def capture_boundary(majorant, bounds_lo, bounds_hi,
                     equator_step: float = 0.1,
                     num_steps: int = 100) -> Graph:
    """FreeGraph of boundary entry points (voxel_boundary.cpp:13
    CaptureBoundary): for every sphere origin, a (2*num_steps+1)^2 grid of
    parallel rays toward the center, each contributing its first
    non-zero-majorant crossing."""
    lo = np.asarray(bounds_lo, np.float64)
    hi = np.asarray(bounds_hi, np.float64)
    center = 0.5 * (lo + hi)
    radius = float(np.linalg.norm(hi - center))
    origins = sphere_surface_points(center, 2.0 * radius, equator_step)
    step = radius / num_steps

    all_pts = []
    for origin in origins:
        dirv = center - origin
        dirv = dirv / np.linalg.norm(dirv)
        # CoordinateSystem(dir) — any orthonormal pair
        up = (np.array([0, 1, 0.0]) if abs(dirv[1]) < 0.9
              else np.array([1, 0, 0.0]))
        xv = np.cross(up, dirv)
        xv /= np.linalg.norm(xv)
        yv = np.cross(dirv, xv)
        ij = np.arange(-num_steps, num_steps + 1) * step
        gx, gy = np.meshgrid(ij, ij, indexing="ij")
        o = (origin[None, :] + gx.reshape(-1, 1) * xv[None]
             + gy.reshape(-1, 1) * yv[None])
        dmat = np.broadcast_to(dirv, o.shape)
        pts, found = _first_nonzero_crossing(majorant, lo, hi, o, dmat)
        if found.any():
            all_pts.append(pts[found])
    if all_pts:
        verts = np.concatenate(all_pts).astype(np.float32)
    else:
        verts = np.zeros((0, 3), np.float32)
    return Graph(positions=verts, kind="free")


def shrink_to_count(free: Graph, wanted_vertices: int,
                    mult_range: float = 1000.0) -> Graph:
    """Binary-search the uniform spacing until the quantized boundary has
    <= wanted_vertices (voxel_boundary.cpp:64-95)."""
    steps = int(np.ceil(np.log2(mult_range))) + 1
    gte1 = free.to_uniform(1.0).n_vertices >= wanted_vertices
    lo_m, hi_m = 1.0, mult_range
    cur = None
    for _ in range(steps - 1):
        mid = lo_m + (hi_m - lo_m) / 2
        cur = free.to_uniform(mid / (1.0 if gte1 else mult_range))
        if cur.n_vertices > wanted_vertices:
            lo_m = mid
        else:
            hi_m = mid
    return cur


def to_single_layer(uniform: Graph, bounds_lo, bounds_hi) -> Graph:
    """Keep one boundary voxel layer and fill interior gaps
    (voxel_boundary.cpp ToSingleLayerAndSaveCast): flood the exterior from
    the bbox shell (6-neighbour dilation to fixpoint); the single layer =
    occupied-or-interior cells adjacent to the exterior."""
    spacing = float(uniform.spacing)
    lo = np.asarray(bounds_lo, np.float64)
    hi = np.asarray(bounds_hi, np.float64)
    res = np.maximum(np.ceil((hi - lo) / spacing).astype(int) + 2, 3)
    occ = np.zeros(tuple(res[::-1]), bool)          # (z, y, x)
    pos = np.asarray(uniform.positions, np.float64)
    if pos.shape[0] == 0:
        return uniform
    c = np.clip(((pos - lo) / spacing).astype(int) + 1, 0, res - 1)
    occ[c[:, 2], c[:, 1], c[:, 0]] = True

    # exterior flood fill: seed = domain hull, dilate through empty cells
    ext = np.zeros_like(occ)
    ext[0, :, :] = ext[-1, :, :] = True
    ext[:, 0, :] = ext[:, -1, :] = True
    ext[:, :, 0] = ext[:, :, -1] = True
    ext &= ~occ
    while True:
        grown = ext.copy()
        grown[1:, :, :] |= ext[:-1, :, :]
        grown[:-1, :, :] |= ext[1:, :, :]
        grown[:, 1:, :] |= ext[:, :-1, :]
        grown[:, :-1, :] |= ext[:, 1:, :]
        grown[:, :, 1:] |= ext[:, :, :-1]
        grown[:, :, :-1] |= ext[:, :, 1:]
        grown &= ~occ
        if (grown == ext).all():
            break
        ext = grown

    solid = ~ext                                    # occupied + interior
    nb_ext = np.zeros_like(occ)
    nb_ext[1:, :, :] |= ext[:-1, :, :]
    nb_ext[:-1, :, :] |= ext[1:, :, :]
    nb_ext[:, 1:, :] |= ext[:, :-1, :]
    nb_ext[:, :-1, :] |= ext[:, 1:, :]
    nb_ext[:, :, 1:] |= ext[:, :, :-1]
    nb_ext[:, :, :-1] |= ext[:, :, 1:]
    layer = solid & nb_ext
    zz, yy, xx = np.nonzero(layer)
    pts = (np.stack([xx, yy, zz], -1) - 1 + 0.5) * spacing + lo
    return Graph(positions=pts.astype(np.float32), kind="uniform",
                 spacing=spacing)


def capture_boundary_uniform(majorant, bounds_lo, bounds_hi,
                             wanted_vertices: int,
                             equator_step: float = 0.3,
                             num_steps: int = 40) -> Graph:
    """Full pipeline: capture -> shrink to target count -> single layer."""
    free = capture_boundary(majorant, bounds_lo, bounds_hi,
                            equator_step=equator_step, num_steps=num_steps)
    uni = shrink_to_count(free, wanted_vertices)
    return to_single_layer(uni, bounds_lo, bounds_hi)
