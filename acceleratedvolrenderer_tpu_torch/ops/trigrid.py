"""Uniform-grid triangle acceleration for meshes
(port of acceleratedvolrenderer_tpu/ops/trigrid.py).

numpy builds a CSR cell -> triangle table on the host; the traversal is a
loop in which every lane either tests the next K triangles of its current
cell (one gather and one batched Moller-Trumbore) or takes an
Amanatides-Woo step to the next cell.  A hit ends a lane once it lies
inside the current cell (best_t <= cell exit), the grid closest-hit rule.
The loop runs on the host and stops when no lane is active: one flag read
per iteration, as ops/dda.py::delta_track reads its own.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import vecmath as vm

_EPS = 1e-4


class TriGridData(NamedTuple):
    p0: torch.Tensor          # (T, 3)
    e1: torch.Tensor          # (T, 3)
    e2: torch.Tensor          # (T, 3)
    cell_start: torch.Tensor  # (ncells + 1,) CSR offsets
    tri_ids: torch.Tensor     # (P,)
    bbox_lo: torch.Tensor     # (3,)
    bbox_hi: torch.Tensor     # (3,)
    res: tuple                # (rx, ry, rz)


def build_tri_grid(vertices: np.ndarray, indices: np.ndarray, res=None,
                   device="cpu") -> TriGridData:
    """The CSR grid, built on the host (vectorized over triangle-cell
    pairs), its tensors on `device`."""
    v = np.asarray(vertices, np.float64)
    idx = np.asarray(indices, np.int64)
    T = idx.shape[0]
    p0 = v[idx[:, 0]]
    p1 = v[idx[:, 1]]
    p2 = v[idx[:, 2]]
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    blo = lo.min(0)
    bhi = hi.max(0)
    ext = np.maximum(bhi - blo, 1e-6)
    blo = blo - 1e-4 * ext
    bhi = bhi + 1e-4 * ext
    ext = bhi - blo
    if res is None:
        # pbrt's grid heuristic: ~cbrt(3T) cells per axis, extent-weighted
        r = max(int(np.ceil((3.0 * T) ** (1.0 / 3.0))), 1)
        res = tuple(int(np.clip(np.ceil(r * e / ext.max()), 1, 128))
                    for e in ext)
    rx, ry, rz = res
    rv = np.array([rx, ry, rz], np.float64)
    rv_hi = np.array([rx - 1, ry - 1, rz - 1], np.int64)
    c0 = np.clip(((lo - blo) / ext * rv).astype(np.int64), 0, rv_hi)
    c1 = np.clip(((hi - blo) / ext * rv).astype(np.int64), 0, rv_hi)
    spans = c1 - c0 + 1
    counts = spans.prod(1)
    P = int(counts.sum())
    pair_tri = np.repeat(np.arange(T), counts)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    r = np.arange(P) - np.repeat(first, counts)
    sx = spans[pair_tri, 0]
    sy = spans[pair_tri, 1]
    cx = c0[pair_tri, 0] + r % sx
    cy = c0[pair_tri, 1] + (r // sx) % sy
    cz = c0[pair_tri, 2] + r // (sx * sy)
    cell = (cz * ry + cy) * rx + cx
    order = np.argsort(cell, kind="stable")
    tri_ids = pair_tri[order]
    cell_start = np.searchsorted(cell[order], np.arange(rx * ry * rz + 1))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return TriGridData(
        p0=f32(p0), e1=f32(p1 - p0), e2=f32(p2 - p0),
        cell_start=i64(cell_start),
        tri_ids=i64(tri_ids if P else np.zeros(1)),
        bbox_lo=f32(blo), bbox_hi=f32(bhi), res=(int(rx), int(ry), int(rz)))


def intersect_grid(g: TriGridData, o, d, t_max, k_tris: int = 8):
    """Closest-hit grid traversal: (t (N,), tri_id (N,) [-1: miss], u, v)."""
    N = o.shape[0]
    dev = o.device
    rx, ry, rz = g.res
    res_f = torch.tensor([rx, ry, rz], dtype=torch.float32, device=dev)
    res_i = torch.tensor([rx, ry, rz], dtype=torch.int64, device=dev)
    t_max = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                               device=dev), (N,))
    inv_ext = 1.0 / (g.bbox_hi - g.bbox_lo)

    # ---- bbox entry (slab test) ----
    inv_d = 1.0 / torch.where(torch.abs(d) > 1e-12, d,
                              torch.where(d >= 0, 1e-12, -1e-12))
    t0s = (g.bbox_lo - o) * inv_d
    t1s = (g.bbox_hi - o) * inv_d
    t_near = torch.amax(torch.minimum(t0s, t1s), -1)
    t_far = torch.amin(torch.maximum(t0s, t1s), -1)
    t_enter = torch.clamp(t_near, min=0.0)
    active = (t_enter <= t_far) & (t_enter < t_max)

    # ---- DDA set-up at the entry point (grid space) ----
    gp = (o + (t_enter + 1e-5)[:, None] * d - g.bbox_lo) * inv_ext * res_f
    voxel = torch.minimum(torch.clamp(gp.to(torch.int64), min=0), res_i - 1)
    step = torch.where(d >= 0, 1, -1)
    cell_w = (g.bbox_hi - g.bbox_lo) / res_f
    nxt_bound = g.bbox_lo + (voxel + (step > 0)).to(torch.float32) * cell_w
    nonzero = torch.abs(d) > 1e-12
    next_t = torch.where(nonzero, (nxt_bound - o) * inv_d, torch.inf)
    dt = torch.where(nonzero, torch.abs(cell_w * inv_d), torch.inf)

    def cell_of(vox):
        return (vox[:, 2] * ry + vox[:, 1]) * rx + vox[:, 0]

    flat0 = cell_of(voxel)
    cur = torch.where(active, g.cell_start[flat0], 0)
    end = torch.where(active, g.cell_start[flat0 + 1], 0)
    cell_exit = torch.minimum(torch.amin(next_t, -1), t_far)
    best_t = torch.full((N,), torch.inf, device=dev)
    best_id = torch.full((N,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((N,), device=dev)
    best_v = torch.zeros((N,), device=dev)
    n_ids = g.tri_ids.shape[0]
    ks = torch.arange(k_tris, device=dev)
    t_stop = torch.minimum(t_max, t_far)

    while bool(active.any()):
        # ---- lanes with triangles pending: test the next K ----
        testing = active & (cur < end)
        offs = cur[:, None] + ks
        valid = testing[:, None] & (offs < end[:, None])
        ids = g.tri_ids[torch.clamp(offs, 0, n_ids - 1)]
        tp0, te1, te2 = g.p0[ids], g.e1[ids], g.e2[ids]      # (N, K, 3)
        h = vm.cross(d[:, None, :], te2)
        a = vm.dot(te1, h)
        inv_a = 1.0 / torch.where(torch.abs(a) > 1e-12, a, 1e-12)
        sv = o[:, None, :] - tp0
        u = vm.dot(sv, h) * inv_a
        q = vm.cross(sv, te1)
        v = vm.dot(d[:, None, :], q) * inv_a
        t = vm.dot(te2, q) * inv_a
        ok = (valid & (torch.abs(a) > 1e-12) & (u >= 0) & (v >= 0)
              & (u + v <= 1) & (t > _EPS) & (t < t_max[:, None])
              & (t < best_t[:, None]))
        t = torch.where(ok, t, torch.inf)
        ct, ci = torch.min(t, dim=1)
        ci = ci[:, None]
        closer = ct < best_t
        best_t = torch.where(closer, ct, best_t)
        best_id = torch.where(closer, torch.gather(ids, 1, ci)[:, 0], best_id)
        best_u = torch.where(closer, torch.gather(u, 1, ci)[:, 0], best_u)
        best_v = torch.where(closer, torch.gather(v, 1, ci)[:, 0], best_v)
        cur = torch.where(testing, cur + k_tris, cur)

        # ---- lanes whose cell is exhausted: confirm a hit or step ----
        stepping = active & ~testing
        hit_here = stepping & (best_t <= cell_exit + 1e-5)
        onehot = torch.nn.functional.one_hot(torch.argmin(next_t, dim=-1), 3)
        vox2 = voxel + onehot * step
        out = ((vox2 < 0) | (vox2 >= res_i)).any(dim=-1)
        nt2 = torch.where(onehot != 0, next_t + dt, next_t)
        past = torch.amin(next_t, -1) > t_stop
        die = stepping & (hit_here | out | past)
        move = stepping & ~die
        voxel = torch.where(move[:, None], vox2, voxel)
        next_t = torch.where(move[:, None], nt2, next_t)
        cell_exit = torch.where(
            move, torch.minimum(torch.amin(next_t, -1), t_far), cell_exit)
        flat = torch.clamp(cell_of(voxel), 0, rx * ry * rz - 1)
        cur = torch.where(move, g.cell_start[flat], cur)
        end = torch.where(move, g.cell_start[flat + 1], end)
        active = active & ~die
    return best_t, best_id, best_u, best_v
