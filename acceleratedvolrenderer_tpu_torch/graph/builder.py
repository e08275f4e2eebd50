"""FreeGraphBuilder: the light-path tracing precompute of the radiance
cache (port of acceleratedvolrenderer_tpu/graph/builder.py).

A dimension_steps^2 grid of entry rays along the light direction, traced
iterations_per_step times each, delta-tracks through up to max_depth
scatter events per path.  Every (entry ray, iteration) is a lane of one
batched trace on the device; the scatter points come back to the host,
where vertices within the node radius merge by sequential insertion
(native/kdtree.cpp) and consecutive scatters of a path become edges with
visit counts.  Then the sparse-vertex reinforcement (both criteria) and
the per-vertex render search ranges.  Streams are keyed by (work index,
iteration), so a path does not depend on the batch it runs in.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..models.media import MediumSpec
from ..ops import dda, phase as phase_ops
from ..ops.warps import sample_uniform_sphere
from ..utils.device import resolve
from .config import GraphBuilderConfig
from .model import Graph


def as_numpy(v) -> np.ndarray:
    """A vector given as a tensor (on any device) or an array, as numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def same_spot_radius(med_spec: MediumSpec, radius_modifier: float) -> float:
    """The node radius: the medium's bounds diagonal / 1000 * modifier."""
    diag = float(np.linalg.norm(np.asarray(med_spec.bounds_hi, np.float64)
                                - np.asarray(med_spec.bounds_lo, np.float64)))
    return diag / 1000.0 * radius_modifier


def _disk_basis(light_dir: np.ndarray):
    d = light_dir / np.linalg.norm(light_dir)
    a = np.array([1.0, 0, 0]) if abs(d[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(d, a)
    u /= np.linalg.norm(u)
    v = np.cross(d, u)
    return d, u, v


def entry_rays(med_spec: MediumSpec, light_dir, dimension_steps: int):
    """A grid of rays along the light direction over the disk that covers
    the medium's bounding sphere: (origins (B, 3), dirs (B, 3)) float32."""
    lo = np.asarray(med_spec.bounds_lo, np.float64)
    hi = np.asarray(med_spec.bounds_hi, np.float64)
    center = (lo + hi) / 2
    radius = float(np.linalg.norm(hi - lo)) / 2
    d, u, v = _disk_basis(as_numpy(light_dir).astype(np.float64))
    s = np.linspace(-radius, radius, dimension_steps)
    uu, vv = np.meshgrid(s, s, indexing="ij")
    keep = (uu ** 2 + vv ** 2) <= radius ** 2
    uu, vv = uu[keep], vv[keep]
    origins = ((center - d * (radius * 2.0))[None, :] + uu[:, None] * u
               + vv[:, None] * v)
    dirs = np.broadcast_to(d, origins.shape)
    return origins.astype(np.float32), dirs.astype(np.float32)


class TraceOutput(tuple):
    """The reference's result type of trace_scatter_paths, an empty tuple
    subclass that it declares and never returns; kept so every public name
    of the reference has its counterpart."""


def trace_scatter_paths(med: dda.MediumArrays, o, d, rng, maj_res,
                        homogeneous: bool, max_depth: int,
                        max_march_steps: int = 50000):
    """Delta-track every ray through up to max_depth scatter events:
    (points (B, D, 3), valid (B, D) bool, rng (B,)), tensors on o's device.
    Absorption or escape ends a path; at each scatter the new direction is
    an HG sample of the medium's phase function.  (The reference pads the
    batch to a power of two to reuse one compiled program; streams are
    keyed by lane, so the port traces the batch as it is.)"""
    B = o.shape[0]
    dev = o.device
    ones = torch.ones((B, med.sigma_a.shape[-1]), device=dev)
    t_inf = torch.full((B,), torch.inf, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    points, valid = [], []
    cur_o, cur_d = o, d
    for _ in range(max_depth):
        res = dda.delta_track(med, cur_o, cur_d, t_inf, ones, ones, ones, rng,
                              active, maj_res, collect_emission=False,
                              homogeneous=homogeneous,
                              max_steps=max_march_steps)
        rng = res.rng
        sc = active & (res.event == dda.EVT_SCATTER)
        p = cur_o + res.t_event[:, None] * cur_d
        points.append(torch.where(sc[:, None], p, 0.0))
        valid.append(sc)
        rng, ua = dda.pcg_uniform_masked(rng, sc)
        rng, ub = dda.pcg_uniform_masked(rng, sc)
        wi, _ = phase_ops.sample_hg(-cur_d, torch.stack([ua, ub], -1), med.g)
        cur_o = torch.where(sc[:, None], p, cur_o)
        cur_d = torch.where(sc[:, None], wi, cur_d)
        active = sc
    return torch.stack(points, 1), torch.stack(valid, 1), rng


def _stream_ids(n: int, salt: int, dev):
    return (torch.arange(n, dtype=torch.int64, device=dev),
            torch.full((n,), salt, dtype=torch.int64, device=dev))


@dataclass
class FreeGraphBuilder:
    """Builds the radiance-cache graph of a medium under a directional
    light, tracing on `device` (the CUDA card by default)."""
    med_spec: MediumSpec
    light_dir: object
    config: GraphBuilderConfig
    seed: int = 0
    device: object = None

    def build(self) -> Graph:
        cfg = self.config
        dev = resolve(self.device)
        radius = same_spot_radius(self.med_spec, cfg.radius_modifier)
        med = self.med_spec.build_arrays(torch.zeros((1, 4), device=dev))
        maj_res = self.med_spec.maj_res()
        homogeneous = self.med_spec.homogeneous

        o_np, d_np = entry_rays(self.med_spec, self.light_dir,
                                cfg.dimension_steps)
        n_entry = o_np.shape[0]
        o = torch.as_tensor(o_np, device=dev)
        d = torch.as_tensor(d_np, device=dev)
        all_pts, all_valid = [], []
        for it in range(cfg.iterations_per_step):
            rng = dda.seed_stream(*_stream_ids(n_entry, it, dev),
                                  salt=self.seed)
            pts, valid, _ = trace_scatter_paths(med, o, d, rng, maj_res,
                                                homogeneous, cfg.max_depth)
            all_pts.append(pts.cpu().numpy())
            all_valid.append(valid.cpu().numpy())
        graph = merge_paths_to_graph(np.concatenate(all_pts),
                                     np.concatenate(all_valid), radius)
        graph.description = "free graph"
        graph.vertex_radius = radius

        graph = self._reinforce(graph, med, maj_res, homogeneous, radius)
        graph.search_range = compute_search_ranges(
            graph.positions, cfg.search_range.neighbours_to_use,
            cfg.search_range.smoothing_rounds, graph.edges)
        return graph

    def _reinforce(self, graph: Graph, med, maj_res, homogeneous,
                   radius: float) -> Graph:
        """Re-trace, round by round, the vertices with too few distinct
        out-edges and those with too few graph neighbours within
        radius * range_modifier, each from `reinforcement_rays` paths, until
        the unsatisfied ratios (against the initial vertex count) fall below
        their thresholds.  Candidates are tracked by position (the exact
        merge keeps founding positions) and their lists only shrink."""
        cfg = self.config
        er, nr = cfg.edge_reinforcement, cfg.neighbour_reinforcement
        if not (er.active or nr.active) or graph.n_vertices == 0:
            return graph
        initial_V = graph.n_vertices
        neigh_radius = radius * nr.range_modifier

        def few_edges_of(g, ids):
            deg = (np.bincount(g.edges[:, 0], minlength=g.n_vertices)
                   if g.n_edges else np.zeros(g.n_vertices, int))
            ids = ids[ids < g.n_vertices]
            return ids[deg[ids] < er.min_edges]

        def neighbour_counts(g, pos):
            # the query vertex itself is in the tree, so it counts itself
            cnt, _ = native.KDTree(g.positions).radius_stats(pos,
                                                             neigh_radius)
            return cnt

        few_e = (few_edges_of(graph, np.arange(initial_V)) if er.active
                 else np.zeros(0, int))
        if nr.active:
            cnt = neighbour_counts(graph, graph.positions)
            few_n_pos = graph.positions[cnt < nr.min_neighbours]
        else:
            few_n_pos = np.zeros((0, 3), np.float32)
        few_e_pos = graph.positions[few_e]

        e_ok = (not er.active) or (len(few_e_pos) / initial_V
                                   < er.unsatisfied_ratio)
        n_ok = (not nr.active) or (len(few_n_pos) / initial_V
                                   < nr.unsatisfied_ratio)
        cycle = 0
        max_rounds = max(er.max_rounds, nr.max_rounds)
        while (not e_ok or not n_ok) and cycle < max_rounds:
            if er.active and not e_ok and len(few_e_pos):
                graph = self._reinforce_batch(
                    graph, med, maj_res, homogeneous, radius, few_e_pos,
                    er.reinforcement_rays, 1000 + cycle)
                idx = _positions_to_ids(graph, few_e_pos, radius)
                few_e_pos = graph.positions[few_edges_of(graph, idx)]
                e_ok = len(few_e_pos) / initial_V < er.unsatisfied_ratio
            if nr.active and not n_ok and len(few_n_pos):
                graph = self._reinforce_batch(
                    graph, med, maj_res, homogeneous, radius, few_n_pos,
                    nr.reinforcement_rays, 5000 + cycle)
                cnt = neighbour_counts(graph, few_n_pos)
                few_n_pos = few_n_pos[cnt < nr.min_neighbours]
                n_ok = len(few_n_pos) / initial_V < nr.unsatisfied_ratio
            cycle += 1
        return graph

    def _reinforce_batch(self, graph, med, maj_res, homogeneous, radius,
                         src_pos: np.ndarray, rays: int, salt_round: int):
        """One reinforcement pass: from each sparse vertex, `rays` paths
        start at uniform points inside its node sphere in a phase-sampled
        direction; the vertex heads each path, so its out-edges grow."""
        cfg = self.config
        dev = med.majorant.device
        n = src_pos.shape[0] * rays
        rng = dda.seed_stream(*_stream_ids(n, salt_round, dev),
                              salt=self.seed)
        # a uniform point in the vertex sphere: r = R * u^(1/3)
        rng, u1 = dda.pcg_uniform(rng)
        rng, u2 = dda.pcg_uniform(rng)
        rng, u3 = dda.pcg_uniform(rng)
        sph = sample_uniform_sphere(torch.stack([u1, u2], -1))
        rr = radius * u3 ** (1.0 / 3.0)
        heads = np.repeat(src_pos, rays, axis=0)
        origins = torch.as_tensor(heads, device=dev) + sph * rr[:, None]
        # the outgoing direction: a phase sample about inDir (1, 0, 0)
        rng, ua = dda.pcg_uniform(rng)
        rng, ub = dda.pcg_uniform(rng)
        wo = torch.tensor([-1.0, 0.0, 0.0], device=dev).expand(n, 3)
        dirs, _ = phase_ops.sample_hg(wo, torch.stack([ua, ub], -1), med.g)
        pts_r, valid_r, _ = trace_scatter_paths(
            med, origins, dirs, rng, maj_res, homogeneous, cfg.max_depth)
        pts2 = np.concatenate([heads[:, None, :], pts_r.cpu().numpy()], 1)
        valid2 = np.concatenate(
            [np.ones((n, 1), bool), valid_r.cpu().numpy()], 1)
        return merge_graphs(graph, merge_paths_to_graph(pts2, valid2, radius),
                            radius)


def merge_paths_to_graph(pts: np.ndarray, valid: np.ndarray, radius: float,
                         exact: bool = True) -> Graph:
    """Vertex merge and edge accumulation of scatter points pts (B, D, 3)
    with valid (B, D).

    exact=True: sequential nearest-within-radius insertion
    (native.merge_points; it raises when the library cannot be built).
    exact=False, only when asked: voxel-hash quantization at the node
    radius, order-independent but cell-quantized.  Edges join consecutive
    valid scatters of a path, counted."""
    B, D, _ = pts.shape
    flat = pts.reshape(-1, 3)
    vmask = valid.reshape(-1)
    if not vmask.any():
        return Graph(positions=np.zeros((0, 3), np.float32))
    if exact:
        labels, verts, counts = native.merge_points(flat[vmask], radius)
        Vn = len(verts)
        vid = np.full(flat.shape[0], -1, np.int64)
        vid[vmask] = labels
        vw = counts.astype(np.float64)
        pos = verts.astype(np.float64)
    else:
        cell = np.floor(flat / radius).astype(np.int64)
        key = ((cell[:, 0] * 73856093) ^ (cell[:, 1] * 19349663)
               ^ (cell[:, 2] * 83492791))
        key = np.where(vmask, key, np.int64(-(2 ** 62)))
        uniq, inv = np.unique(key, return_inverse=True)
        # index 0 of uniq may be the invalid sentinel
        offset = 1 if uniq[0] == -(2 ** 62) else 0
        Vn = uniq.size - offset
        vid = inv - offset          # -1 for invalid
        vw = np.bincount(vid[vmask], minlength=Vn).astype(np.float64)
        pos = np.stack(
            [np.bincount(vid[vmask], weights=flat[vmask, i], minlength=Vn)
             for i in range(3)], -1) / vw[:, None]

    vid2 = vid.reshape(B, D)
    emask = valid[:, :-1] & valid[:, 1:]
    ef = vid2[:, :-1][emask]
    et = vid2[:, 1:][emask]
    keep = ef != et
    ef, et = ef[keep], et[keep]
    if ef.size:
        ekey = ef.astype(np.int64) * Vn + et
        euniq, ecnt = np.unique(ekey, return_counts=True)
        edges = np.stack([euniq // Vn, euniq % Vn], -1).astype(np.int32)
        esamp = ecnt.astype(np.int32)
    else:
        edges = np.zeros((0, 2), np.int32)
        esamp = np.zeros((0,), np.int32)
    return Graph(positions=pos.astype(np.float32),
                 vertex_samples=vw.astype(np.int32), edges=edges,
                 edge_samples=esamp, kind="free", vertex_radius=radius)


def _positions_to_ids(graph: Graph, pos: np.ndarray, radius: float):
    """The ids of the graph vertices nearest to query positions, those
    within the node radius, unique."""
    if pos.shape[0] == 0 or graph.n_vertices == 0:
        return np.zeros(0, np.int64)
    idx, d2 = native.KDTree(graph.positions).knn(pos, 1)
    ids = idx[:, 0].astype(np.int64)
    keep = (ids >= 0) & (d2[:, 0] <= radius * radius + 1e-12)
    return np.unique(ids[keep])


def merge_graphs(a: Graph, b: Graph, radius: float) -> Graph:
    """Merge graph b into a with the initial build's sequential insertion:
    a's vertices first (mutually farther apart than the radius, they keep
    their positions and order), then each of b's joins the nearest vertex
    within the radius or founds a new one.  Weights and edge counts add."""
    w_a = (a.vertex_samples if a.vertex_samples is not None
           else np.ones(a.n_vertices, np.int32)).astype(np.float64)
    w_b = (b.vertex_samples if b.vertex_samples is not None
           else np.ones(b.n_vertices, np.int32)).astype(np.float64)
    pos = np.concatenate([a.positions, b.positions])
    w = np.concatenate([w_a, w_b])
    labels, verts, _ = native.merge_points(pos, radius)
    Vn = len(verts)
    inv = labels.astype(np.int64)
    vw = np.bincount(inv, weights=w, minlength=Vn)
    edges, samps = [], []
    for g, m in ((a, inv[: a.n_vertices]), (b, inv[a.n_vertices:])):
        if g.n_edges:
            e = m[g.edges]
            keep = e[:, 0] != e[:, 1]
            edges.append(e[keep])
            es = (g.edge_samples if g.edge_samples is not None
                  else np.ones(g.n_edges, np.int32))
            samps.append(es[keep])
    if edges:
        e = np.concatenate(edges)
        es = np.concatenate(samps).astype(np.int64)
        ekey = e[:, 0].astype(np.int64) * Vn + e[:, 1]
        euniq, einv = np.unique(ekey, return_inverse=True)
        es2 = np.bincount(einv, weights=es.astype(np.float64)).astype(np.int32)
        e2 = np.stack([euniq // Vn, euniq % Vn], -1).astype(np.int32)
    else:
        e2 = np.zeros((0, 2), np.int32)
        es2 = np.zeros((0,), np.int32)
    return Graph(positions=verts.astype(np.float32),
                 vertex_samples=vw.astype(np.int32), edges=e2,
                 edge_samples=es2, kind="free", vertex_radius=radius,
                 description=a.description)


def compute_search_ranges(positions: np.ndarray, k: int,
                          smoothing_rounds: int,
                          edges: np.ndarray) -> np.ndarray:
    """Per-vertex mean distance to the k nearest neighbours (native
    KD-tree), then averaged over graph neighbours `smoothing_rounds`
    times."""
    V = positions.shape[0]
    if V == 0:
        return np.zeros((0,), np.float32)
    k_eff = min(k + 1, V)
    _, d2 = native.KDTree(positions).knn(positions, k_eff)
    d = np.sqrt(np.maximum(d2, 0.0))
    sr = (d[:, 1:].mean(axis=1) if k_eff > 1 else np.zeros(V)).astype(
        np.float32)
    for _ in range(smoothing_rounds):
        if edges is None or edges.shape[0] == 0:
            break
        acc = sr.copy()
        cnt = np.ones(V)
        np.add.at(acc, edges[:, 0], sr[edges[:, 1]])
        np.add.at(cnt, edges[:, 0], 1.0)
        np.add.at(acc, edges[:, 1], sr[edges[:, 0]])
        np.add.at(cnt, edges[:, 1], 1.0)
        sr = (acc / cnt).astype(np.float32)
    return sr
