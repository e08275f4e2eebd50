"""Graph data model and its (de)serialization
(port of acceleratedvolrenderer_tpu/graph/model.py, plain numpy).

The radiance-cache graph as a struct of arrays: positions, light scalars,
search ranges, (from, to) edge index pairs and visit counts.  Two formats:
text, in the field order of the reference tooling's files/format.txt, and
a compressed .npz.  Both read and write the same files as the JAX
package's Graph.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Graph:
    """Struct-of-arrays radiance-cache graph.

    positions:      (V, 3) float32 world-space vertex positions
    light_scalar:   (V,)   cached incident-light scalars (lighting.py)
    search_range:   (V,)   per-vertex render search range (builder.py)
    vertex_samples: (V,)   int32 visit counts
    edges:          (E, 2) int32 (from, to) vertex indices
    edge_samples:   (E,)   int32 visit counts
    edge_weight:    (E,)   float32 optional weights
    vertex_radius:  scalar merge radius ('free' graph extra meta)
    spacing:        scalar voxel spacing ('uniform' graph extra meta)
    coors:          (V, 3) int32 voxel coordinates (uniform graphs)
    paths:          optional (flat int32 vertex ids, (P, 2) [offset, size])
    """
    positions: np.ndarray
    light_scalar: Optional[np.ndarray] = None
    search_range: Optional[np.ndarray] = None
    vertex_samples: Optional[np.ndarray] = None
    edges: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int32))
    edge_samples: Optional[np.ndarray] = None
    edge_weight: Optional[np.ndarray] = None
    kind: str = "free"                      # 'free' | 'uniform'
    description: str = ""
    vertex_radius: float = 0.0
    spacing: float = 0.0
    coors: Optional[np.ndarray] = None
    paths_flat: Optional[np.ndarray] = None
    paths_index: Optional[np.ndarray] = None

    @property
    def n_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        """Mirrors Graph::AddStats (graph.cpp:439): vertex/edge counts,
        degree distribution, light statistics."""
        V, E = self.n_vertices, self.n_edges
        out = {"vertices": V, "edges": E}
        if E:
            deg_out = np.bincount(self.edges[:, 0], minlength=V)
            deg_in = np.bincount(self.edges[:, 1], minlength=V)
            out.update(
                mean_out_degree=float(deg_out.mean()),
                max_out_degree=int(deg_out.max()),
                mean_in_degree=float(deg_in.mean()),
            )
        if self.light_scalar is not None and V:
            out.update(
                mean_light=float(np.mean(self.light_scalar)),
                max_light=float(np.max(self.light_scalar)),
            )
        if self.search_range is not None and V:
            out.update(mean_search_range=float(np.mean(self.search_range)))
        return out

    # ------------------------------------------------------- uniform quantize
    def to_uniform(self, spacing: float) -> "Graph":
        """FreeGraph::ToUniform (graph.cpp:597): quantize vertices to a
        voxel lattice, merging cohabitants (light scalars sample-weighted)."""
        coors = np.floor(self.positions / spacing).astype(np.int64)
        key = (coors[:, 0] * 73856093) ^ (coors[:, 1] * 19349663) ^ (coors[:, 2] * 83492791)
        uniq, inv = np.unique(key, return_inverse=True)
        Vn = uniq.shape[0]
        samples = (self.vertex_samples if self.vertex_samples is not None
                   else np.ones(self.n_vertices, np.int64)).astype(np.float64)
        wsum = np.bincount(inv, weights=samples, minlength=Vn)
        pos = np.stack(
            [np.bincount(inv, weights=self.positions[:, i] * samples, minlength=Vn)
             for i in range(3)], -1
        ) / wsum[:, None]
        light = None
        if self.light_scalar is not None:
            light = (np.bincount(inv, weights=self.light_scalar * samples, minlength=Vn)
                     / wsum).astype(np.float32)
        new_coors = np.floor(pos / spacing).astype(np.int32)
        edges = self.edges
        if edges.shape[0]:
            e = inv[edges]
            keep = e[:, 0] != e[:, 1]
            e = e[keep]
            es = (self.edge_samples[keep] if self.edge_samples is not None
                  else np.ones(e.shape[0], np.int64))
            ekey = e[:, 0].astype(np.int64) * Vn + e[:, 1]
            euniq, einv = np.unique(ekey, return_inverse=True)
            es2 = np.bincount(einv, weights=es.astype(np.float64))
            e2 = np.stack([euniq // Vn, euniq % Vn], -1).astype(np.int32)
        else:
            e2 = np.zeros((0, 2), np.int32)
            es2 = np.zeros((0,), np.float64)
        return Graph(
            positions=pos.astype(np.float32),
            light_scalar=light,
            vertex_samples=wsum.astype(np.int32),
            edges=e2, edge_samples=es2.astype(np.int32),
            kind="uniform", description=self.description,
            spacing=spacing, coors=new_coors,
        )

    # --------------------------------------------------------------- text io
    def write_text(self, path: str):
        """files/format.txt layout: desc, extra meta, flags, base meta,
        vertices, edges, paths."""
        with open(path, "w") as f:
            f.write(f"{self.kind} {self.description or 'graph'}\n")
            if self.kind == "uniform":
                f.write(f"uniform {self.spacing}\n")
            else:
                f.write(f"free {self.vertex_radius}\n")
            flags = [
                "useCoors" if self.coors is not None else "noCoors",
                "useSamples" if self.vertex_samples is not None else "noSamples",
                "noRayVertexTypes",
                "useLighting" if self.light_scalar is not None else "noLighting",
                "useWeights" if self.edge_weight is not None else "noWeights",
            ]
            f.write(" ".join(flags) + "\n")
            P = 0 if self.paths_index is None else self.paths_index.shape[0]
            f.write(f"{self.n_vertices} {self.n_edges} {P} "
                    f"{self.n_vertices} {self.n_edges} {P}\n")
            sr = self.search_range
            for i in range(self.n_vertices):
                parts = [str(i)] + [repr(float(x)) for x in self.positions[i]]
                if self.light_scalar is not None:
                    parts.append(repr(float(self.light_scalar[i])))
                if self.vertex_samples is not None:
                    parts.append(str(int(self.vertex_samples[i])))
                if sr is not None:
                    parts.append(repr(float(sr[i])))
                if self.coors is not None:
                    parts += [str(int(x)) for x in self.coors[i]]
                f.write(" ".join(parts) + "\n")
            for i in range(self.n_edges):
                parts = [str(i), str(int(self.edges[i, 0])), str(int(self.edges[i, 1]))]
                if self.edge_samples is not None:
                    parts.append(str(int(self.edge_samples[i])))
                if self.edge_weight is not None:
                    parts.append(repr(float(self.edge_weight[i])))
                f.write(" ".join(parts) + "\n")
            if self.paths_index is not None:
                for i, (off, size) in enumerate(self.paths_index):
                    ids = self.paths_flat[off: off + size]
                    f.write(" ".join([str(i), str(size)] + [str(int(x)) for x in ids]) + "\n")

    @staticmethod
    def read_text(path: str) -> "Graph":
        with open(path) as f:
            kind, _, desc = f.readline().partition(" ")
            kind = kind.strip()
            extra = f.readline().split()
            vertex_radius = spacing = 0.0
            if extra and extra[0] == "uniform":
                spacing = float(extra[1])
            elif extra and extra[0] == "free":
                vertex_radius = float(extra[1])
            flags = f.readline().split()
            use_coors = "useCoors" in flags
            use_samples = "useSamples" in flags
            use_lighting = "useLighting" in flags
            use_weights = "useWeights" in flags
            meta = [int(x) for x in f.readline().split()]
            V, E, P = meta[3], meta[4], meta[5]
            pos = np.zeros((V, 3), np.float32)
            light = np.zeros(V, np.float32) if use_lighting else None
            samples = np.zeros(V, np.int32) if use_samples else None
            coors = np.zeros((V, 3), np.int32) if use_coors else None
            sr = None
            for _ in range(V):
                parts = f.readline().split()
                i = int(parts[0])
                pos[i] = [float(x) for x in parts[1:4]]
                j = 4
                if use_lighting:
                    light[i] = float(parts[j]); j += 1
                if use_samples:
                    samples[i] = int(parts[j]); j += 1
                rem = len(parts) - j - (3 if use_coors else 0)
                if rem >= 1:
                    if sr is None:
                        sr = np.zeros(V, np.float32)
                    sr[i] = float(parts[j]); j += 1
                if use_coors:
                    coors[i] = [int(x) for x in parts[j: j + 3]]
            edges = np.zeros((E, 2), np.int32)
            esamp = np.zeros(E, np.int32) if use_samples else None
            ew = np.zeros(E, np.float32) if use_weights else None
            for _ in range(E):
                parts = f.readline().split()
                i = int(parts[0])
                edges[i] = [int(parts[1]), int(parts[2])]
                j = 3
                if use_samples:
                    esamp[i] = int(parts[j]); j += 1
                if use_weights:
                    ew[i] = float(parts[j]); j += 1
            pf = pi = None
            if P:
                flat, index = [], []
                for _ in range(P):
                    parts = f.readline().split()
                    size = int(parts[1])
                    index.append((len(flat), size))
                    flat += [int(x) for x in parts[2: 2 + size]]
                pf = np.asarray(flat, np.int32)
                pi = np.asarray(index, np.int32)
        return Graph(
            positions=pos, light_scalar=light, search_range=sr,
            vertex_samples=samples, edges=edges, edge_samples=esamp,
            edge_weight=ew, kind=kind, description=desc.strip(),
            vertex_radius=vertex_radius, spacing=spacing, coors=coors,
            paths_flat=pf, paths_index=pi,
        )

    # ---------------------------------------------------------------- npz io
    def write_npz(self, path: str):
        data = {"positions": self.positions, "edges": self.edges,
                "kind": np.asarray(self.kind), "description": np.asarray(self.description),
                "vertex_radius": np.float32(self.vertex_radius),
                "spacing": np.float32(self.spacing)}
        for name in ("light_scalar", "search_range", "vertex_samples",
                     "edge_samples", "edge_weight", "coors", "paths_flat",
                     "paths_index"):
            v = getattr(self, name)
            if v is not None:
                data[name] = v
        np.savez_compressed(path, **data)

    @staticmethod
    def read_npz(path: str) -> "Graph":
        z = np.load(path, allow_pickle=False)
        kw = {}
        for name in ("light_scalar", "search_range", "vertex_samples",
                     "edge_samples", "edge_weight", "coors", "paths_flat",
                     "paths_index"):
            if name in z:
                kw[name] = z[name]
        return Graph(
            positions=z["positions"], edges=z["edges"],
            kind=str(z["kind"]), description=str(z["description"]),
            vertex_radius=float(z["vertex_radius"]), spacing=float(z["spacing"]),
            **kw,
        )
