"""Precompute configuration schema
(port of acceleratedvolrenderer_tpu/graph/config.py, plain numpy).

GraphBuilderConfig, LightingCalculatorConfig, the two reinforcement
criteria and the render search ranges, loaded from a per-scene JSON with
the reference's field names.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Optional


@dataclass
class EdgeReinforcementConfig:
    # re-trace vertices whose distinct out-edge count is below min_edges
    # until the unsatisfied ratio (vs the INITIAL vertex count) falls under
    # threshold (free_graph_builder.cpp:281-471; schema util.h:707-716)
    active: bool = True
    min_edges: int = 4                 # edgesForNotSparse
    unsatisfied_ratio: float = 0.1     # unsatisfiedAllowedRatio
    reinforcement_rays: int = 16       # reinforcementRays per sparse vertex
    max_rounds: int = 4                # safety cap (reference loops forever)


@dataclass
class NeighbourReinforcementConfig:
    # re-trace vertices with fewer than min_neighbours graph vertices
    # within node_radius * range_modifier (free_graph_builder.cpp:287,
    # squaredNeighbourSearchRadius; schema util.h:718-721)
    active: bool = True
    min_neighbours: int = 4            # neighboursForNotSparse
    unsatisfied_ratio: float = 0.1
    reinforcement_rays: int = 16
    range_modifier: float = 2.0        # neighbourRangeModifier
    max_rounds: int = 4


@dataclass
class RenderSearchRangeConfig:
    # per-vertex mean distance to this many nearest neighbours, smoothed
    # over neighbours (free_graph_builder.cpp:498-548)
    neighbours_to_use: int = 8
    smoothing_rounds: int = 1


@dataclass
class GraphBuilderConfig:
    dimension_steps: int = 64          # entry-ray grid resolution
    iterations_per_step: int = 4       # traces per entry ray
    radius_modifier: float = 1.0       # node radius = same-spot radius * mod
    max_depth: int = 8                 # scatter events per trace
    edge_reinforcement: EdgeReinforcementConfig = field(
        default_factory=EdgeReinforcementConfig)
    neighbour_reinforcement: NeighbourReinforcementConfig = field(
        default_factory=NeighbourReinforcementConfig)
    search_range: RenderSearchRangeConfig = field(
        default_factory=RenderSearchRangeConfig)


@dataclass
class LightingCalculatorConfig:
    light_rays: int = 64               # MC rays per vertex for the light vector
    bounces: int = 4                   # power-iteration order


@dataclass
class GraphConfig:
    builder: GraphBuilderConfig = field(default_factory=GraphBuilderConfig)
    lighting: LightingCalculatorConfig = field(default_factory=LightingCalculatorConfig)

    @staticmethod
    def from_json(path: str) -> "GraphConfig":
        with open(path) as f:
            d = json.load(f)
        cfg = GraphConfig()
        b = d.get("builder", d.get("graphBuilder", {}))
        for k_json, k_attr in [
            ("dimensionSteps", "dimension_steps"),
            ("iterationsPerStep", "iterations_per_step"),
            ("radiusModifier", "radius_modifier"),
            ("maxDepth", "max_depth"),
        ]:
            if k_json in b:
                setattr(cfg.builder, k_attr, type(getattr(cfg.builder, k_attr))(b[k_json]))
        li = d.get("lighting", d.get("lightingCalculator", {}))
        for k_json, k_attr in [("lightRays", "light_rays"), ("bounces", "bounces")]:
            if k_json in li:
                setattr(cfg.lighting, k_attr, int(li[k_json]))
        sr = d.get("searchRange", {})
        if "neighboursToUse" in sr:
            cfg.builder.search_range.neighbours_to_use = int(sr["neighboursToUse"])
        # reinforcement blocks use the reference's field names (util.h:754+)
        er = b.get("edgeReinforcement", {})
        for k_json, k_attr in [
            ("active", "active"),
            ("unsatisfiedAllowedRatio", "unsatisfied_ratio"),
            ("reinforcementRays", "reinforcement_rays"),
            ("edgesForNotSparse", "min_edges"),
        ]:
            if k_json in er:
                cur = getattr(cfg.builder.edge_reinforcement, k_attr)
                setattr(cfg.builder.edge_reinforcement, k_attr,
                        type(cur)(er[k_json]))
        nr = b.get("neighbourReinforcement", {})
        for k_json, k_attr in [
            ("active", "active"),
            ("unsatisfiedAllowedRatio", "unsatisfied_ratio"),
            ("reinforcementRays", "reinforcement_rays"),
            ("neighboursForNotSparse", "min_neighbours"),
            ("neighbourRangeModifier", "range_modifier"),
        ]:
            if k_json in nr:
                cur = getattr(cfg.builder.neighbour_reinforcement, k_attr)
                setattr(cfg.builder.neighbour_reinforcement, k_attr,
                        type(cur)(nr[k_json]))
        return cfg

    def to_json(self, path: str):
        with open(path, "w") as f:
            json.dump(
                {
                    "builder": {
                        "dimensionSteps": self.builder.dimension_steps,
                        "iterationsPerStep": self.builder.iterations_per_step,
                        "radiusModifier": self.builder.radius_modifier,
                        "maxDepth": self.builder.max_depth,
                        "edgeReinforcement": {
                            "active": self.builder.edge_reinforcement.active,
                            "unsatisfiedAllowedRatio":
                                self.builder.edge_reinforcement.unsatisfied_ratio,
                            "reinforcementRays":
                                self.builder.edge_reinforcement.reinforcement_rays,
                            "edgesForNotSparse":
                                self.builder.edge_reinforcement.min_edges,
                        },
                        "neighbourReinforcement": {
                            "active": self.builder.neighbour_reinforcement.active,
                            "unsatisfiedAllowedRatio":
                                self.builder.neighbour_reinforcement.unsatisfied_ratio,
                            "reinforcementRays":
                                self.builder.neighbour_reinforcement.reinforcement_rays,
                            "neighboursForNotSparse":
                                self.builder.neighbour_reinforcement.min_neighbours,
                            "neighbourRangeModifier":
                                self.builder.neighbour_reinforcement.range_modifier,
                        },
                    },
                    "lighting": {
                        "lightRays": self.lighting.light_rays,
                        "bounces": self.lighting.bounces,
                    },
                    "searchRange": {
                        "neighboursToUse": self.builder.search_range.neighbours_to_use,
                    },
                },
                f, indent=2,
            )
