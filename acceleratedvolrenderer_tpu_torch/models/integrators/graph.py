"""GraphIntegrator: render-time radiance-cache lookups
(port of acceleratedvolrenderer_tpu/models/integrators/graph.py).

A camera ray delta-tracks to its first real scatter; there the cache is
read: the vertices of a uniform voxel-hash grid's 27-cell neighbourhood
(27 x K candidates) are weighted by inverse squared distance within the
first non-empty of three radii (the node radius, the 99th percentile and
the maximum of the search ranges), and L = light spectrum x the weighted
light scalar.  A uniform (lattice-quantized) graph is read by a dense voxel
lookup instead.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...graph.model import Graph
from ...ops import dda
from ...utils.device import resolve

_OFFSETS = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)]


class ConnectIndex(NamedTuple):
    """Padded uniform-grid spatial index over the cache vertices."""
    table: torch.Tensor      # (n_cells, K) int32 vertex ids, -1 = empty
    grid_lo: torch.Tensor    # (3,)
    cell_size: torch.Tensor  # 0-d float32
    dims: tuple              # (nx, ny, nz)
    positions: torch.Tensor  # (V, 3)
    light: torch.Tensor      # (V,)
    vertex_radius: float
    r_mid: float             # 99th-percentile search range
    r_max: float             # max search range


def build_connect_index(graph: Graph, max_per_cell: int = 32,
                        device=None) -> ConnectIndex:
    """Bin the vertices into cells of the largest search range (doubled
    until at most 2^22 cells), at most max_per_cell per cell, on the host;
    the tables go to `device` (None: the CUDA card)."""
    device = resolve(device)
    V = graph.n_vertices
    pos = graph.positions
    sr = (graph.search_range if graph.search_range is not None
          else np.full(V, graph.vertex_radius * 4))
    r_mid = float(np.percentile(sr, 99)) if V else 0.0
    r_max = float(sr.max()) if V else 0.0
    cell = max(r_max, 1e-6)
    lo = pos.min(axis=0) - cell if V else np.zeros(3)
    hi = pos.max(axis=0) + cell if V else np.ones(3)
    dims = np.maximum(np.ceil((hi - lo) / cell).astype(int), 1)
    while int(np.prod(dims)) > 2 ** 22:
        cell *= 2.0
        dims = np.maximum(np.ceil((hi - lo) / cell).astype(int), 1)
    n_cells = int(np.prod(dims))
    table = np.full((n_cells, max_per_cell), -1, np.int32)
    counts = np.zeros(n_cells, np.int32)
    if V:
        ci = np.clip(np.floor((pos - lo) / cell).astype(np.int64), 0,
                     dims - 1)
        flat = (ci[:, 2] * dims[1] + ci[:, 1]) * dims[0] + ci[:, 0]
        for v in np.argsort(flat, kind="stable"):
            f = flat[v]
            if counts[f] < max_per_cell:
                table[f, counts[f]] = v
                counts[f] += 1
    light = (graph.light_scalar if graph.light_scalar is not None
             else np.zeros(V, np.float32))
    f32 = torch.float32
    return ConnectIndex(
        table=torch.as_tensor(table, device=device),
        grid_lo=torch.as_tensor(np.asarray(lo, np.float32), device=device),
        cell_size=torch.tensor(cell, dtype=f32, device=device),
        dims=tuple(int(x) for x in dims),
        positions=torch.as_tensor(
            pos if V else np.zeros((1, 3), np.float32), device=device),
        light=torch.as_tensor(
            light if V else np.zeros(1, np.float32), device=device),
        vertex_radius=float(graph.vertex_radius), r_mid=r_mid, r_max=r_max)


def _candidates(index: ConnectIndex, p):
    """The 27 x K candidate vertex ids around each point (N, 27K), -1 for
    none."""
    nx, ny, nz = index.dims
    K = index.table.shape[1]
    ci = torch.floor((p - index.grid_lo) / index.cell_size).to(torch.int32)
    offs = torch.tensor(_OFFSETS, dtype=torch.int32, device=p.device)
    cells = ci[:, None, :] + offs[None, :, :]                  # (N, 27, 3)
    dims = torch.tensor([nx, ny, nz], dtype=torch.int32, device=p.device)
    ok = torch.all((cells >= 0) & (cells < dims), dim=-1)
    flat = (cells[..., 2] * ny + cells[..., 1]) * nx + cells[..., 0]
    cand = index.table[torch.where(ok, flat, 0).long()]       # (N, 27, K)
    return torch.where(ok[..., None], cand, -1).reshape(p.shape[0], 27 * K)


def candidate_d2(index: ConnectIndex, p, cand):
    """Squared distances (N, 27K) from p to its candidates, inf for none."""
    cpos = index.positions[torch.clamp(cand, min=0).long()]   # (N, 27K, 3)
    d2 = torch.sum((cpos - p[:, None, :]) ** 2, dim=-1)
    return torch.where(cand >= 0, d2, torch.inf)


# points per connect_to_graph pass: bounds its (points, 27K) temporaries
# (~2 GB at 65,536 x 864) and changes no result
LOOKUP_CHUNK = 65536


def connect_to_graph(index: ConnectIndex, p):
    """Weighted cache lookup at points p (N, 3): (scalar (N,), found (N,)
    bool), the three-stage radius escalation computed branch-free, over at
    most LOOKUP_CHUNK points at a time."""
    n = LOOKUP_CHUNK
    if p.shape[0] <= n:
        return _connect_chunk(index, p)
    parts = [_connect_chunk(index, p[i:i + n])
             for i in range(0, p.shape[0], n)]
    return torch.cat([a for a, _ in parts]), torch.cat([f for _, f in parts])


def _connect_chunk(index: ConnectIndex, p):
    cand = _candidates(index, p)
    d2 = candidate_d2(index, p, cand)
    clight = index.light[torch.clamp(cand, min=0).long()]

    def stage(r):
        m = d2 <= r * r
        w = torch.where(m, 1.0 / torch.clamp(d2, min=1e-12), 0.0)
        wsum = torch.sum(w, dim=-1)
        avg = torch.sum(w * clight, dim=-1) / torch.clamp(wsum, min=1e-24)
        return avg, torch.any(m, dim=-1)

    a1, f1 = stage(index.vertex_radius)
    a2, f2 = stage(index.r_mid)
    a3, f3 = stage(index.r_max)
    avg = torch.where(f1, a1, torch.where(f2, a2, a3))
    found = f1 | f2 | f3
    return torch.where(found, avg, 0.0), found


def _first_scatter(med, o, d, rng, maj_res, homogeneous, max_march_steps,
                   lanes):
    N = o.shape[0]
    ones = torch.ones((N, lanes), device=o.device)
    res = dda.delta_track(
        med, o, d, torch.full((N,), torch.inf, device=o.device), ones, ones,
        ones, rng, torch.ones((N,), dtype=torch.bool, device=o.device),
        maj_res, collect_emission=False, homogeneous=homogeneous,
        max_steps=max_march_steps)
    return res, res.event == dda.EVT_SCATTER, o + res.t_event[:, None] * d


def li(med: dda.MediumArrays, index: ConnectIndex, light_spectrum, o, d,
       lam, rng, *, maj_res, homogeneous: bool,
       max_march_steps: int = 100000):
    """Accelerated Li: one delta-tracking march to the first real scatter,
    then a cache lookup; light_spectrum (N, LANES) is the light's
    radiance."""
    res, sc, p = _first_scatter(med, o, d, rng, maj_res, homogeneous,
                                max_march_steps, lam.shape[-1])
    scalar, found = connect_to_graph(index, p)
    return torch.where((sc & found)[:, None],
                       res.beta * light_spectrum * scalar[:, None], 0.0)


class UniformIndex(NamedTuple):
    """Dense voxel lookup of a uniform (lattice-quantized) graph."""
    light: torch.Tensor     # (nz, ny, nx) light scalar, 0 = empty
    occupied: torch.Tensor  # (nz, ny, nx) bool
    lo: torch.Tensor        # (3,) lattice origin (cell 0 corner), world
    spacing: float
    dims: tuple


def build_uniform_index(graph: Graph, device=None) -> UniformIndex:
    """The dense lattice of a uniform graph's light scalars, on `device`
    (None: the CUDA card)."""
    device = resolve(device)
    assert graph.kind == "uniform" and graph.spacing, \
        "build_uniform_index needs a uniform graph (Graph.to_uniform)"
    coors = (graph.coors if graph.coors is not None else np.floor(
        graph.positions / graph.spacing).astype(np.int32))
    lo = coors.min(axis=0)
    nx, ny, nz = (int(x) for x in coors.max(axis=0) - lo + 1)
    light = np.zeros((nz, ny, nx), np.float32)
    occ = np.zeros((nz, ny, nx), bool)
    c = coors - lo
    light[c[:, 2], c[:, 1], c[:, 0]] = (
        graph.light_scalar if graph.light_scalar is not None
        else np.zeros(graph.n_vertices, np.float32))
    occ[c[:, 2], c[:, 1], c[:, 0]] = True
    return UniformIndex(
        light=torch.as_tensor(light, device=device),
        occupied=torch.as_tensor(occ, device=device),
        lo=torch.as_tensor(lo.astype(np.float32) * np.float32(graph.spacing),
                           device=device),
        spacing=float(graph.spacing), dims=(nx, ny, nz))


def connect_uniform(index: UniformIndex, p):
    """The cache value of the cell that holds each point p (N, 3):
    (scalar (N,), found (N,) bool)."""
    nx, ny, nz = index.dims
    ci = torch.floor((p - index.lo) / index.spacing).to(torch.int32)
    dims = torch.tensor([nx, ny, nz], dtype=torch.int32, device=p.device)
    ok = torch.all((ci >= 0) & (ci < dims), dim=-1)
    cx = torch.clamp(ci[..., 0], 0, nx - 1).long()
    cy = torch.clamp(ci[..., 1], 0, ny - 1).long()
    cz = torch.clamp(ci[..., 2], 0, nz - 1).long()
    found = ok & index.occupied[cz, cy, cx]
    return torch.where(found, index.light[cz, cy, cx], 0.0), found


def li_uniform(med, uindex: UniformIndex, light_spectrum, o, d, lam, rng, *,
               maj_res, homogeneous: bool, max_march_steps: int = 100000):
    """Accelerated Li over a uniform graph: delta-track to the first real
    scatter, then a voxel lookup."""
    res, sc, p = _first_scatter(med, o, d, rng, maj_res, homogeneous,
                                max_march_steps, lam.shape[-1])
    scalar, found = connect_uniform(uindex, p)
    return torch.where((sc & found)[:, None],
                       res.beta * light_spectrum * scalar[:, None], 0.0)


def debug_image(uindex: UniformIndex, camera, width: int, height: int,
                max_steps: int = 4096) -> np.ndarray:
    """The voxel view of a uniform graph: camera rays (pixel centres) step
    the lattice at half a cell from their entry into its box; each pixel
    shows the cache value of the first occupied voxel crossed, as an
    (height, width, 3) float32 image."""
    dev = uindex.light.device
    f32 = torch.float32
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    pix = torch.as_tensor(np.stack([xs.reshape(-1), ys.reshape(-1)], -1),
                          dtype=torch.int32, device=dev)
    N = width * height
    o, d = camera.generate_rays(pix, torch.full((N, 2), 0.5, device=dev))
    nx, ny, nz = uindex.dims
    lo = uindex.lo
    hi = lo + torch.tensor([nx, ny, nz], dtype=f32, device=dev) * uindex.spacing
    inv = 1.0 / torch.where(torch.abs(d) > 1e-12, d, 1e-12)
    t0s = (lo - o) * inv
    t1s = (hi - o) * inv
    t_in = torch.clamp(torch.amax(torch.minimum(t0s, t1s), dim=-1), min=0.0)
    t_out = torch.amin(torch.maximum(t0s, t1s), dim=-1)
    n_steps = int(min(max_steps, np.linalg.norm([nx, ny, nz]) * 2 + 16))
    # (i + 0.5) * step in float32, as the reference's traced loop rounds it
    offs = ((torch.arange(n_steps, dtype=f32, device=dev) + 0.5)
            * torch.tensor(uindex.spacing * 0.5, dtype=f32, device=dev))
    val = torch.zeros((N,), dtype=f32, device=dev)
    seen = torch.zeros((N,), dtype=torch.bool, device=dev)
    for i in range(n_steps):
        t = t_in + offs[i]
        sval, f = connect_uniform(uindex, o + t[:, None] * d)
        hit = f & (t <= t_out)
        val = torch.where(~seen & hit, sval, val)
        seen = seen | hit
    img = val.cpu().numpy().reshape(height, width)
    return np.repeat(img[:, :, None], 3, axis=2).astype(np.float32)
