"""Graph precompute CLI (port of acceleratedvolrenderer_tpu/cli/graph_maker.py).

    python -m acceleratedvolrenderer_tpu_torch.cli.graph_maker \\
        scene.pbrt|preset:sphere|preset:cloud [--config cfg.json] \\
        [--node-radius M] [--bounces B ...] [--out BASE] \\
        [--format txt|npz|both] [--quiet] [--cpu]

Builds the scene's graph (FreeGraphBuilder), its light vector and, for
each bounce count, the final light (compute_final_light), and writes
<out>_d<bounces>.txt / .npz and <out>_stats.json.  The work runs on the
CUDA card; --cpu runs it on the CPU.  A .pbrt scene goes through
scene/parser.py::load_scene; without --config, a <scene>.json beside it is
the config.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="avrt-torch-graph-maker",
        description="Precompute the graph radiance cache for a volumetric "
                    "scene")
    ap.add_argument("scene",
                    help=".pbrt scene file or preset:sphere / preset:cloud")
    ap.add_argument("--config", default=None, help="JSON config")
    ap.add_argument("--node-radius", type=float, default=None,
                    help="override the radius modifier")
    ap.add_argument("--bounces", type=int, nargs="*", default=None,
                    help="write one graph per bounce count (default: the "
                         "config's)")
    ap.add_argument("--out", default=None, help="output basename")
    ap.add_argument("--format", choices=["txt", "npz", "both"],
                    default="both")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)

    from ..graph.builder import FreeGraphBuilder
    from ..graph.config import GraphConfig
    from ..graph.lighting import compute_final_light, light_vector
    from ..models import lights as lm
    from ..utils.device import resolve

    device = resolve("cpu" if args.cpu else None)
    if args.scene.startswith("preset:"):
        from ..scene import presets

        base = args.scene.split(":", 1)[1]
        make = {"sphere": presets.sphere_medium, "cloud": presets.cloud}
        if base not in make:
            ap.error(f"unknown preset {base!r}: one of {sorted(make)}")
        scene = make[base](device=device)
    else:
        from ..scene.parser import load_scene

        scene = load_scene(args.scene, device=device)
        base = os.path.splitext(os.path.basename(args.scene))[0]

    if scene.medium is None:
        ap.error("scene has no medium")
    distant = [lt for lt in scene.lights if isinstance(lt, lm.DistantLight)]
    if not distant:
        ap.error("graph precompute needs a distant light")
    light_dir = distant[0].direction.cpu().numpy()

    # config: explicit > the scene file's <name>.json > defaults
    cfg_path = args.config
    if cfg_path is None and not args.scene.startswith("preset:"):
        auto = os.path.splitext(args.scene)[0] + ".json"
        if os.path.exists(auto):
            cfg_path = auto
    cfg = GraphConfig.from_json(cfg_path) if cfg_path else GraphConfig()
    if args.node_radius is not None:
        cfg.builder.radius_modifier = args.node_radius

    t0 = time.time()
    graph = FreeGraphBuilder(scene.medium, light_dir, cfg.builder,
                             seed=scene.seed, device=device).build()
    t_build = time.time() - t0
    if not args.quiet:
        print(f"graph built: {graph.n_vertices} vertices, {graph.n_edges} "
              f"edges ({t_build:.1f}s)", file=sys.stderr)

    t0 = time.time()
    L0 = light_vector(graph, scene.medium, light_dir,
                      cfg.lighting.light_rays, seed=scene.seed,
                      device=device)
    t_light = time.time() - t0

    out_base = args.out or base
    written = []
    for b in (args.bounces or [cfg.lighting.bounces]):
        graph.light_scalar = compute_final_light(graph, L0, b, device=device)
        stem = f"{out_base}_d{b}"
        if args.format in ("txt", "both"):
            graph.write_text(stem + ".txt")
            written.append(stem + ".txt")
        if args.format in ("npz", "both"):
            graph.write_npz(stem + ".npz")
            written.append(stem + ".npz")

    stats = {**graph.stats(), "build_seconds": t_build,
             "lighting_seconds": t_light,
             "node_radius": graph.vertex_radius, "files": written}
    with open(out_base + "_stats.json", "w") as f:
        json.dump(stats, f, indent=2)
    if not args.quiet:
        print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
