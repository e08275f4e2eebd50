"""IntegrationAnalyzer: how well the radiance cache covers the scatters of
camera paths (port of acceleratedvolrenderer_tpu/graph/analyzer.py).

For chosen pixels, camera rays are delta-tracked through the medium and
every real scatter is tested against the cache: the fraction within the
node radius of some vertex, the fraction within some vertex's render
search range, and the mean distance to the in-range vertices.  Both tests
read the same 27-cell voxel-hash candidates as the render-time lookup.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.integrators.graph import (ConnectIndex, _candidates,
                                        build_connect_index, candidate_d2)
from ..ops import dda
from ..utils.device import resolve
from . import builder as builder_mod
from .model import Graph


@dataclass
class AnalysisResult:
    total_scatters: int
    node_scatters: int       # within the vertex radius of some vertex
    search_scatters: int     # within some vertex's render search range
    avg_in_range_dist: float

    @property
    def node_fraction(self) -> float:
        return self.node_scatters / max(self.total_scatters, 1)

    @property
    def search_fraction(self) -> float:
        return self.search_scatters / max(self.total_scatters, 1)

    def __str__(self):
        return (f"{self.node_scatters} / {self.total_scatters} "
                f"({self.node_fraction:.3f}) | "
                f"{self.search_scatters} / {self.total_scatters} "
                f"({self.search_fraction:.3f}), {self.avg_in_range_dist:.5f}")


def _candidate_d2(index: ConnectIndex, p, search_range):
    """The 27-cell candidates' squared distances (N, 27K), inf where there
    is none, and their search ranges."""
    cand = _candidates(index, p)
    return (candidate_d2(index, p, cand),
            search_range[torch.clamp(cand, min=0).long()])


def analyze(scene, graph: Graph, pixels, spp: int = 4,
            device=None) -> AnalysisResult:
    """Run the analyzer over `pixels` ((M, 2) int array of (x, y)) on
    `device` (the CUDA card by default)."""
    dev = resolve(device)
    scene = scene.to(dev)
    med_spec = scene.medium
    pixels = np.atleast_2d(np.asarray(pixels, np.int32))
    M = pixels.shape[0]
    lam = torch.full((M * spp, 4), 550.0, device=dev)
    density = (torch.ones((1, 1, 1), device=dev) if med_spec.density is None
               else med_spec.density.to(dev, torch.float32))
    med = dda.MediumArrays(
        density=density, majorant=med_spec.build_majorant(dev),
        w2m=torch.as_tensor(np.asarray(med_spec.world_to_unit(), np.float32),
                            device=dev),
        g=torch.tensor(med_spec.g, dtype=torch.float32, device=dev),
        sigma_a=med_spec.sigma_a_spec(lam) * med_spec.scale,
        sigma_s=med_spec.sigma_s_spec(lam) * med_spec.scale,
        Le=torch.zeros_like(lam))

    pix_rep = torch.as_tensor(np.repeat(pixels, spp, axis=0), device=dev)
    o, d = scene.camera.generate_rays(
        pix_rep, torch.full((M * spp, 2), 0.5, device=dev))
    ids = torch.arange(M * spp, dtype=torch.int64, device=dev)
    rng = dda.seed_stream(ids, torch.zeros_like(ids), salt=scene.seed + 99)
    pts, valid, _ = builder_mod.trace_scatter_paths(
        med, o, d, rng, med_spec.maj_res(), med_spec.homogeneous,
        max_depth=scene.max_depth)

    p = pts.reshape(-1, 3)
    v = valid.reshape(-1).cpu().numpy()
    total = int(v.sum())
    if total == 0 or graph.n_vertices == 0:
        return AnalysisResult(total, 0, 0, 0.0)

    index = build_connect_index(graph, device=dev)
    sr = torch.as_tensor(
        graph.search_range if graph.search_range is not None
        else np.full(graph.n_vertices, graph.vertex_radius * 4, np.float32),
        device=dev)
    d2, cand_sr = _candidate_d2(index, p, sr)
    d2 = d2.cpu().numpy()
    cand_sr = cand_sr.cpu().numpy()

    in_node = (d2 <= index.vertex_radius ** 2).any(axis=1) & v
    in_range_mask = (d2 <= cand_sr ** 2) & v[:, None]
    in_range = in_range_mask.any(axis=1)
    dists = (np.sqrt(d2[in_range_mask & np.isfinite(d2)])
             if in_range_mask.any() else np.zeros(0))
    return AnalysisResult(
        total_scatters=total, node_scatters=int(in_node.sum()),
        search_scatters=int(in_range.sum()),
        avg_in_range_dist=float(dists.mean()) if dists.size else 0.0)
