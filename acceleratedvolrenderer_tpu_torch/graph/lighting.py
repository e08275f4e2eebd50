"""LightingCalculator: turn the graph into a radiance cache
(port of acceleratedvolrenderer_tpu/graph/lighting.py).

light_vector: each vertex's initial light, the Monte Carlo ratio-tracked
transmittance from the directional light to uniform points of the vertex
sphere, times 1/(4 pi); one (vertex, sample) lane per ray, in fixed
batches on the device.  transport_matrix: T[i->j] = edge samples / vertex
samples, as COO arrays.  compute_final_light: total = sum_k T^k L0 for
k <= bounces with the reference's NaN/Inf early stop, on the host
(float64) or on the device (float32 index_add_).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.media import MediumSpec
from ..ops import dda, transmittance
from ..ops.warps import sample_uniform_sphere
from ..utils.device import resolve
from ..utils.math import INV_4PI
from .builder import as_numpy
from .config import LightingCalculatorConfig
from .model import Graph


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def light_vector(graph: Graph, med_spec: MediumSpec, light_dir, n_rays: int,
                 seed: int = 0, batch: int = 262144,
                 device=None) -> np.ndarray:
    """Per-vertex Monte Carlo transmittance from the directional light:
    n_rays rays from outside the medium along the light direction to
    uniform points of the vertex sphere; L0 = mean(T) / (4 pi).

    The rays run in batches of min(batch, next power of two of V * n_rays)
    lanes, the last wrapped around to the first rays (idx % total) and its
    extra lanes inactive; ray idx's stream is seed_stream(idx, 0, seed + 7),
    so the batching is part of the result, as in the reference."""
    V = graph.n_vertices
    if V == 0:
        return np.zeros((0,), np.float32)
    dev = resolve(device)
    radius = graph.vertex_radius
    med = med_spec.build_arrays(torch.zeros((1, 4), device=dev))
    maj_res = med_spec.maj_res()
    homogeneous = med_spec.homogeneous
    d = as_numpy(light_dir).astype(np.float64)
    d = (d / np.linalg.norm(d)).astype(np.float32)
    diag = float(np.linalg.norm(np.asarray(med_spec.bounds_hi)
                                - np.asarray(med_spec.bounds_lo)))

    out = np.zeros(V, np.float64)
    total = V * n_rays
    batch = min(batch, _next_pow2(total))
    dirs = torch.as_tensor(d, device=dev).expand(batch, 3)
    tmax = torch.full((batch,), diag * 2.0, device=dev)
    positions = torch.as_tensor(graph.positions, device=dev)
    lanes = torch.arange(batch, dtype=torch.int64, device=dev)
    zeros = torch.zeros(batch, dtype=torch.int64, device=dev)
    for start in range(0, total, batch):
        n = min(batch, total - start)
        idx = (lanes + start) % total
        rng = dda.seed_stream(idx, zeros, salt=seed + 7)
        rng, ua = dda.pcg_uniform(rng)
        rng, ub = dda.pcg_uniform(rng)
        sphere = sample_uniform_sphere(torch.stack([ua, ub], -1)) * radius
        targets = positions[idx // n_rays] + sphere
        o = targets - dirs * (diag * 2.0)
        t = _tr_core(med, o, dirs, tmax, rng, lanes < n, maj_res,
                     homogeneous)
        v_idx = np.arange(start, start + n) // n_rays
        np.add.at(out, v_idx, t[:n].cpu().numpy())
    return (out / n_rays * INV_4PI).astype(np.float32)


def _tr_core(med, o, dirs, tmax, rng, active, maj_res, homogeneous):
    res = transmittance.ratio_track(med, o, dirs, tmax, rng, active, maj_res,
                                    homogeneous=homogeneous)
    # the delta-light estimator: T_ray / avg(r_l)
    return res.T_ray[:, 0] / torch.clamp(torch.mean(res.r_l, -1), min=1e-24)


def transport_matrix(graph: Graph):
    """COO transport (rows, cols, vals): T[i->j] = edge_samples(i->j) /
    vertex_samples(i)."""
    if graph.n_edges == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32))
    vs = (graph.vertex_samples if graph.vertex_samples is not None
          else np.ones(graph.n_vertices, np.int32)).astype(np.float64)
    es = (graph.edge_samples if graph.edge_samples is not None
          else np.ones(graph.n_edges, np.int32)).astype(np.float64)
    rows = graph.edges[:, 0].astype(np.int32)   # from
    cols = graph.edges[:, 1].astype(np.int32)   # to
    vals = (es / np.maximum(vs[rows], 1.0)).astype(np.float32)
    return rows, cols, vals


#: edge count from which compute_final_light runs on the device when the
#: caller does not choose (the reference's threshold)
_DEVICE_EDGE_THRESHOLD = 100_000


def compute_final_light(graph: Graph, L0: np.ndarray, bounces: int,
                        on_device=None, device=None) -> np.ndarray:
    """total = sum_{k=0..bounces} T^k L0, stopping early when a term is not
    finite or is all zero.  on_device (the reference's `device` flag):
    True runs the iteration on `device` (the CUDA card by default) in
    float32 with index_add_, whose atomics on the card add in no fixed
    order; False on the host in float64; None chooses the device from
    _DEVICE_EDGE_THRESHOLD edges."""
    rows, cols, vals = transport_matrix(graph)
    V = graph.n_vertices
    if on_device is None:
        on_device = rows.size >= _DEVICE_EDGE_THRESHOLD
    if on_device and rows.size:
        return _final_light_device(rows, cols, vals, L0, V, bounces,
                                   resolve(device))
    total = L0.astype(np.float64).copy()
    cur = L0.astype(np.float64).copy()
    for _ in range(bounces):
        nxt = np.zeros(V, np.float64)
        if rows.size:
            np.add.at(nxt, cols, vals * cur[rows])
        if not np.all(np.isfinite(nxt)):
            break
        total += nxt
        cur = nxt
        if cur.max(initial=0.0) == 0.0:
            break
    return total.astype(np.float32)


def _final_light_device(rows, cols, vals, L0, V, bounces, dev):
    """The power iteration as `bounces` index_add_ matvecs on `dev`, one
    read of the stop flags per bounce."""
    rows = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    cols = torch.as_tensor(cols, dtype=torch.int64, device=dev)
    vals = torch.as_tensor(vals, dtype=torch.float32, device=dev)
    cur = torch.as_tensor(np.asarray(L0, np.float32), device=dev)
    total = cur.clone()
    for _ in range(bounces):
        nxt = torch.zeros(V, dtype=torch.float32, device=dev).index_add_(
            0, cols, vals * cur[rows])
        finite, zero = torch.stack([torch.isfinite(nxt).all(),
                                    nxt.max() <= 0.0]).tolist()
        if not finite:
            break
        total += nxt
        cur = nxt
        if zero:
            break
    return total.cpu().numpy()


@dataclass
class LightingCalculator:
    graph: Graph
    med_spec: MediumSpec
    light_dir: object
    config: LightingCalculatorConfig
    seed: int = 0
    device: object = None

    def run(self) -> Graph:
        L0 = light_vector(self.graph, self.med_spec, self.light_dir,
                          self.config.light_rays, seed=self.seed,
                          device=self.device)
        self.graph.light_scalar = compute_final_light(
            self.graph, L0, self.config.bounces, device=self.device)
        return self.graph
