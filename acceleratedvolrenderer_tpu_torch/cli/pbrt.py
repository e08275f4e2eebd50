"""The renderer's command line, pbrt's equivalent (port of
acceleratedvolrenderer_tpu/cli/pbrt.py, the same flags).

    python -m acceleratedvolrenderer_tpu_torch.cli.pbrt scene.pbrt -o out.exr

Renders a .pbrt file (scene/parser.py) or a preset on the CUDA card
(`--gpu-device N` picks cuda:N), or on the CPU with `--cpu`; without CUDA
and without `--cpu` it raises.  --integrator routes volpath (default),
simplevolpath, path, simplepath, randomwalk and ao through render(), graph
(with --graph-data, or --graph-debug) through render_graph, analyzer and
function to their back ends, and lightpath, bdpt, sppm and mlt to their
renderers (render_lightpath, render_bdpt, render_sppm, render_mlt), whether
the flag or the scene file names them (the reference routes these four on
the flag only and renders such a file with volpath).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _device(args):
    """The device to render on: the CPU with --cpu, else cuda:N with
    --gpu-device N, else the CUDA card; without CUDA it raises."""
    import torch

    from ..utils.device import resolve

    if args.cpu:
        return resolve("cpu")
    if args.gpu_device is not None:
        if not torch.cuda.is_available():
            raise RuntimeError("--gpu-device: no CUDA device is available; "
                               "pass --cpu to render on the CPU")
        return resolve(f"cuda:{args.gpu_device}")
    return resolve(None)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="avrt-torch-pbrt",
        description="volumetric renderer on a CUDA card (pbrt-compatible "
                    "subset)",
    )
    ap.add_argument("scene", help=".pbrt scene file or preset: "
                    "preset:cloud / preset:fog_box / preset:emissive / preset:sphere")
    ap.add_argument("--outfile", "-o", default=None, help="output EXR path")
    ap.add_argument("--spp", type=int, default=None, help="samples per pixel")
    ap.add_argument("--maxdepth", type=int, default=None)
    ap.add_argument("--integrator", default=None,
                    help="volpath (default) | simplevolpath | graph | path | "
                         "simplepath | randomwalk | ao | lightpath | mlt | "
                         "bdpt | sppm | function | analyzer")
    ap.add_argument("--function", default="step",
                    help="2D test function for --integrator function")
    ap.add_argument("--analyze-pixels", default=None,
                    help='pixels for --integrator analyzer, "x,y;x,y;..."')
    ap.add_argument("--lightsampler", default=None,
                    help="uniform | power | bvh")
    ap.add_argument("--regularize", action="store_true",
                    help="widen near-specular BSDFs after the first bounce")
    ap.add_argument("--graph-data", default=None,
                    help="precomputed graph file (.txt or .npz) for --integrator graph")
    ap.add_argument("--graph-debug", action="store_true",
                    help="visualize the uniform graph's cache voxels instead "
                         "of rendering (graph_integrator.cpp:104-131)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stats", action="store_true", help="print render statistics")
    ap.add_argument("--write-png", action="store_true")
    ap.add_argument("--mse-reference-image", default=None,
                    help="EXR to compute MSE against (stored in output metadata)")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU instead of the CUDA card")
    ap.add_argument("--debugstart", default=None, metavar="X,Y,S",
                    help="deterministic replay of one pixel sample: render "
                         "only pixel (x, y) sample s and print its radiance "
                         "(the reference's --debugstart, "
                         "cpu/integrators.cpp:73-93 — trivially exact here "
                         "because RNG streams are keyed by (pixel, sample))")
    ap.add_argument("--res", default=None, help="override WxH, e.g. 640x360")
    ap.add_argument("--quick", action="store_true",
                    help="1/4 the pixel samples (cmd/pbrt.cpp --quick)")
    ap.add_argument("--pixelstats", action="store_true",
                    help="write per-pixel statistic images "
                         "(<out>_variance.exr etc., util/stats.h "
                         "STAT_PIXEL_COUNTER / --pixelstats)")
    ap.add_argument("--write-partial-images", action="store_true",
                    dest="write_partial",
                    help="write the in-progress film at power-of-2 waves")
    ap.add_argument("--checkpoint", default=None, metavar="PATH.npz",
                    help="periodically save the film accumulator + next "
                         "sample index; if PATH exists the render RESUMES "
                         "from it bitwise-exactly (counter-based RNG keys "
                         "waves by sample index)")
    ap.add_argument("--checkpoint-every", type=int, default=32,
                    metavar="N", help="checkpoint every N samples")
    ap.add_argument("--display-server", default=None, metavar="HOST:PORT",
                    help="stream wave images to a tev display server")
    ap.add_argument("--log-utilization", action="store_true",
                    help="sample CPU/memory use once a second "
                         "(reference options.h:52)")
    # ---- remaining reference flag surface (cmd/pbrt.cpp:136-214) ----
    ap.add_argument("--cropwindow", default=None, metavar="X0,X1,Y0,Y1",
                    help="NDC crop window; only pixels inside are rendered")
    ap.add_argument("--pixelbounds", default=None, metavar="X0,X1,Y0,Y1",
                    help="integer pixel bounds; only pixels inside rendered")
    ap.add_argument("--pixel", default=None, metavar="X,Y",
                    help="render a single pixel (debugging)")
    ap.add_argument("--disable-pixel-jitter", action="store_true",
                    help="force camera samples to the pixel center")
    ap.add_argument("--disable-wavelength-jitter", action="store_true",
                    help="use fixed hero-wavelength strata every sample")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress non-error output")
    ap.add_argument("--log-level", default="error",
                    choices=["verbose", "error", "fatal"])
    ap.add_argument("--log-file", default=None)
    ap.add_argument("--mse-reference-out", default=None,
                    help="append 'spp mse seconds' per pow2 wave to this file")
    ap.add_argument("--mse-final-only", action="store_true",
                    help="only record the final wave's MSE")
    ap.add_argument("--nthreads", type=int, default=None,
                    help="host-side thread count (torch and BLAS pools)")
    ap.add_argument("--render-coord-sys", default="cameraworld",
                    choices=["camera", "cameraworld", "world"],
                    help="rendering coordinate system (accepted for parity; "
                         "this renderer computes in world space, which only "
                         "affects float conditioning, not results)")
    ap.add_argument("--interactive", action="store_true")
    ap.add_argument("--fullscreen", action="store_true")
    ap.add_argument("--wavefront", action="store_true",
                    help="accepted for parity: the wave renderer is the "
                         "wavefront design")
    ap.add_argument("--gpu", action="store_true",
                    help="accepted for parity: the CUDA card is the "
                         "default")
    ap.add_argument("--gpu-device", type=int, default=None,
                    help="CUDA device index (cuda:N)")
    ap.add_argument("--format", action="store_true",
                    help="reformat the scene file to stdout and exit")
    ap.add_argument("--toply", default=None, metavar="OUT.pbrt",
                    help="reformat with inline meshes extracted to PLY")
    ap.add_argument("--upgrade", action="store_true",
                    help="accepted for parity (scenes are parsed as pbrt-v4)")
    args = ap.parse_args(argv)

    if args.interactive or args.fullscreen:
        ap.error("--interactive/--fullscreen need a local display (GLFW); "
                 "use --display-server HOST:PORT for live preview instead")
    if args.nthreads:
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
            os.environ[var] = str(args.nthreads)
        import torch

        torch.set_num_threads(args.nthreads)

    if args.format or args.toply:
        from ..scene.parser import format_scene

        text = format_scene(args.scene, toply=args.toply)
        if args.toply:
            with open(args.toply, "w") as f:
                f.write(text)
            if not args.quiet:
                print(f"wrote {args.toply}")
        else:
            sys.stdout.write(text)
        return 0

    import logging

    logging.basicConfig(
        filename=args.log_file,
        level={"verbose": logging.DEBUG, "error": logging.ERROR,
               "fatal": logging.CRITICAL}[args.log_level])

    util_logger = None
    if args.log_utilization:
        from ..utils.stats import UtilizationLogger

        util_logger = UtilizationLogger(stream=sys.stderr).start()
        import atexit

        atexit.register(
            lambda: (util_logger.stop(),
                     print(util_logger.report(), file=sys.stderr)))

    device = _device(args)

    from ..scene import presets
    from ..scene.parser import load_scene

    if args.scene.startswith("preset:"):
        name = args.scene.split(":", 1)[1]
        kw = {}
        if args.res:
            w, h = args.res.split("x")
            if name == "cloud":
                kw = {"width": int(w), "height": int(h)}
            else:
                kw = {"res": int(w)}
        scene = {
            "cloud": presets.cloud,
            "fog_box": presets.fog_box,
            "emissive": presets.emissive_volume,
            "sphere": presets.sphere_medium,
        }[name](**kw, device=device)
    else:
        scene = load_scene(args.scene, device=device)
    integ = args.integrator or scene.integrator
    if args.spp is not None:
        scene.spp = args.spp
    if args.quick:
        scene.spp = max(1, scene.spp // 4)
    if args.maxdepth is not None:
        scene.max_depth = args.maxdepth
    scene.seed = args.seed
    if args.lightsampler:
        scene.light_sampler = args.lightsampler
    if args.regularize:
        scene.regularize = True
    scene.disable_pixel_jitter = args.disable_pixel_jitter
    scene.disable_wavelength_jitter = args.disable_wavelength_jitter
    if args.pixel:
        x, y = (int(v) for v in args.pixel.split(","))
        scene.pixel_bounds = (x, x + 1, y, y + 1)
    elif args.pixelbounds:
        x0, x1, y0, y1 = (int(v) for v in args.pixelbounds.split(","))
        scene.pixel_bounds = (x0, x1, y0, y1)
    elif args.cropwindow:
        import math

        cx0, cx1, cy0, cy1 = (float(v) for v in args.cropwindow.split(","))
        W, H = scene.width, scene.height
        # NDC→pixels with ceil on both bounds, matching the reference
        # (film.cpp:134-137 pMin=ceil(full.pMin + crop.pMin*diag) etc.)
        x0, x1 = math.ceil(cx0 * W), math.ceil(cx1 * W)
        y0, y1 = math.ceil(cy0 * H), math.ceil(cy1 * H)
        scene.pixel_bounds = (x0, max(x0 + 1, x1), y0, max(y0 + 1, y1))
    from ..parallel import render as render_mod

    t0 = time.time()
    if args.debugstart:
        x, y, sidx = (int(v) for v in args.debugstart.split(","))
        # render the frame up to sample sidx and read back the requested
        # pixel (replay is exact: a sample's RNG stream depends only on
        # (pixel, sample))
        img, _ = render_mod.render_regen(scene, spp=sidx + 1, device=device) \
            if scene.medium is not None else render_mod.render(
                scene, spp=sidx + 1, device=device)
        print(json.dumps({"pixel": [x, y], "sample": sidx,
                          "rgb_mean_up_to_sample": [float(v) for v in img[y, x]]}))
        return 0

    # pixel-bounds / jitter options are honored only by the wave/regen
    # renderers; the reference applies PBRTOptions globally, so warn loudly
    # when an integrator that ignores them is selected (ADVICE r1).
    if integ in ("mlt", "bdpt", "sppm", "lightpath", "analyzer"):
        ignored = []
        if getattr(scene, "pixel_bounds", None) is not None:
            ignored.append("--pixel/--pixelbounds/--cropwindow")
        if args.disable_pixel_jitter:
            ignored.append("--disable-pixel-jitter")
        if args.disable_wavelength_jitter:
            ignored.append("--disable-wavelength-jitter")
        if ignored:
            import warnings

            warnings.warn(
                f"--integrator {integ} ignores "
                f"{', '.join(ignored)}; rendering the full frame with "
                f"default jitter")

    if args.integrator == "graph" and args.graph_debug:
        import time as _time

        from ..graph.model import Graph
        from ..models.integrators import graph as graph_mod

        assert args.graph_data, "--graph-debug requires --graph-data"
        graph = (Graph.read_npz(args.graph_data)
                 if args.graph_data.endswith(".npz")
                 else Graph.read_text(args.graph_data))
        if getattr(graph, "kind", "free") != "uniform":
            import numpy as _np

            ext = graph.positions.max(0) - graph.positions.min(0)
            graph = graph.to_uniform(
                max(float(_np.linalg.norm(ext)) / 64.0,
                    graph.vertex_radius * 2.0))
        uindex = graph_mod.build_uniform_index(graph, device)
        t0 = _time.time()
        img = graph_mod.debug_image(uindex, scene.camera, scene.width,
                                    scene.height)
        stats = {"render_time": _time.time() - t0, "spp": 1,
                 "rays_per_sec": 0.0}
    elif args.integrator == "graph":
        if not args.graph_data:
            ap.error("--integrator graph requires --graph-data")
        from ..graph.model import Graph

        graph = (Graph.read_npz(args.graph_data) if args.graph_data.endswith(".npz")
                 else Graph.read_text(args.graph_data))
        img, stats = render_mod.render_graph(scene, graph, device=device)
    elif integ == "lightpath":
        img, stats = render_mod.render_lightpath(scene, device=device)
        stats.setdefault("rays_per_sec",
                         stats["n_paths"] / max(stats["render_time"], 1e-9))
    elif integ == "bdpt":
        from ..models.integrators import bdpt as bdpt_mod

        img, stats, _ = bdpt_mod.render_bdpt(
            scene, max_depth=scene.max_depth, spp=scene.spp,
            keep_strategies=False, device=device)
        stats.setdefault("rays_per_sec", 0.0)
    elif integ == "sppm":
        from ..models.integrators import sppm as sppm_mod

        img, stats = sppm_mod.render_sppm(scene, device=device)
    elif integ == "mlt":
        from ..models.integrators import mlt as mlt_mod

        img, stats = mlt_mod.render_mlt(scene, seed=args.seed, device=device)
        # a black bootstrap returns {"b": 0.0} alone
        stats.setdefault("render_time", 0.0)
        stats.setdefault("spp", scene.spp)
        stats.setdefault("rays_per_sec", stats.get("mutations", 0)
                         / max(stats["render_time"], 1e-9))
    elif args.integrator == "function":
        import time as _time

        from ..models.integrators import function as func_mod

        t0 = _time.time()
        est, curve = func_mod.render_function(
            args.function, width=scene.width, height=scene.height,
            spp=scene.spp, sampler=scene.sampler, seed=scene.seed,
            device=device)
        func_mod.write_mse_file(f"{args.function}-mse.txt", curve)
        img = est[:, :, None].repeat(3, axis=2)
        stats = {"render_time": _time.time() - t0, "spp": scene.spp,
                 "rays_per_sec": 0.0, "mse_curve": curve}
    elif args.integrator == "analyzer":
        import time as _time

        from ..graph import analyzer as analyzer_mod
        from ..graph.model import Graph

        assert args.graph_data, "--integrator analyzer requires --graph-data"
        graph = (Graph.read_npz(args.graph_data)
                 if args.graph_data.endswith(".npz")
                 else Graph.read_text(args.graph_data))
        pixels = ([(scene.width // 2, scene.height // 2)]
                  if not args.analyze_pixels else
                  [tuple(map(int, p.split(","))) for p in
                   args.analyze_pixels.split(";")])
        t0 = _time.time()
        res = analyzer_mod.analyze(scene, graph, pixels, spp=scene.spp,
                                   device=device)
        print(res)
        stats = {"render_time": _time.time() - t0, "spp": scene.spp,
                 "rays_per_sec": 0.0, "analysis": str(res)}
        img = None
    elif args.pixelstats:
        # per-pixel statistic images (reference --pixelstats): variance /
        # relative-variance planes from the GBuffer-style AOV renderer
        if args.integrator is not None:
            scene.integrator = args.integrator
        img, aovs, stats = render_mod.render_with_aovs(scene, device=device)
        from ..utils.image import write_exr

        base = (args.outfile or "out.exr").rsplit(".", 1)[0]
        for k, plane in aovs.items():
            write_exr(f"{base}_{k}.exr", plane.astype("float32"))
            print(f"wrote {base}_{k}.exr")
    elif args.write_partial or args.display_server or args.mse_reference_out:
        # the wave loop with per-pow2-wave partial writes + tev streaming
        # (reference --write-partial-images, util/display.h DisplayDynamic)
        if args.integrator is not None:
            scene.integrator = args.integrator
        import numpy as np

        from ..models.film import Film

        disp = None
        if args.display_server:
            from ..utils.display import TevDisplay

            host, port = args.display_server.rsplit(":", 1)
            disp = TevDisplay(host, int(port))
        mse_ref = None
        if args.mse_reference_out:
            if not args.mse_reference_image:
                ap.error("--mse-reference-out requires --mse-reference-image")
            from ..utils.image import read_exr

            mse_ref, _, _ = read_exr(args.mse_reference_image)
            mse_log = open(args.mse_reference_out, "w")
        render_wave, density, majorant = render_mod.make_wave_renderer(
            scene, device=device)
        film = Film.create(scene.height, scene.width, device)
        t0 = time.time()
        base = (args.outfile or "out.exr").rsplit(".", 1)[0]
        for s in range(scene.spp):
            film, _ = render_wave(film, density, majorant, s)
            if (s & (s + 1)) == 0 or s == scene.spp - 1:
                partial = film.to_image().cpu().numpy()
                if args.write_partial and s != scene.spp - 1:
                    from ..models.film import write_film as _wf

                    _wf(f"{base}_partial_s{s + 1}.exr", partial,
                        render_time=time.time() - t0, spp=s + 1)
                if disp is not None:
                    disp.update("render", partial)
                if mse_ref is not None and (not args.mse_final_only
                                            or s == scene.spp - 1):
                    from ..utils.image import mse as _mse

                    # per-wave "spp mse seconds" log (volpath_custom.cpp:86-114)
                    mse_log.write(f"{s + 1} "
                                  f"{_mse(partial, mse_ref[:, :, :3]):.9g} "
                                  f"{time.time() - t0:.3f}\n")
        if mse_ref is not None:
            mse_log.close()
        dt = time.time() - t0
        img = film.to_image().cpu().numpy()
        stats = {"render_time": dt, "spp": scene.spp,
                 "rays_per_sec": scene.width * scene.height * scene.spp / dt}
    elif args.checkpoint:
        if args.integrator is not None:
            scene.integrator = args.integrator
        from ..parallel import checkpoint as ckpt_mod

        img, stats = ckpt_mod.render_with_checkpoints(
            scene, checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every, device=device)
        stats.setdefault("rays_per_sec",
                         scene.width * scene.height * stats["spp"]
                         / max(stats["render_time"], 1e-9))
    else:
        if args.integrator is not None:
            scene.integrator = args.integrator
        img, stats = render_mod.render(scene, device=device)

    if img is None:   # analysis-only integrators write no image
        if args.stats:
            print(json.dumps(stats))
        return 0

    mse_val = None
    if args.mse_reference_image:
        from ..utils.image import mse, read_exr

        ref, _, _ = read_exr(args.mse_reference_image)
        if ref.shape[:2] == img.shape[:2]:
            mse_val = mse(img, ref[:, :, :3])

    out = args.outfile or "out.exr"
    from ..models.film import write_film

    write_film(out, img, render_time=stats["render_time"], spp=stats["spp"],
               mse=mse_val)
    if args.write_png:
        from ..utils.image import write_png

        write_png(out.rsplit(".", 1)[0] + ".png", img)
    if args.stats:
        print(json.dumps({**stats, "mse": mse_val, "outfile": out}))
    elif not args.quiet:
        print(f"wrote {out} ({stats['render_time']:.1f}s, "
              f"{stats.get('rays_per_sec', 0.0) / 1e6:.3f} Mrays/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
