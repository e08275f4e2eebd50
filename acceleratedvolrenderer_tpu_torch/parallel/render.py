"""Render entry points
(port of acceleratedvolrenderer_tpu/parallel/render.py: work_stride_for,
make_wave_renderer, make_regen_renderer, render_regen, render,
render_lightpath, render_with_aovs, render_gbuffer, render_spectral,
make_graph_wave_renderer and render_graph).

Every entry point runs on the CUDA card unless given another `device`
(utils/device.py::resolve)."""
from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..models import lights as lights_mod
from ..models import samplers
from ..models.film import Film
from ..models.integrators import path as path_mod
from ..models.integrators import volpath_fused as volpath
from ..ops import dda
from ..ops import grid as gridops
from ..utils import spectrum as sp
from ..utils.device import resolve


def work_stride_for(hw: int) -> int:
    """Coprime stride for the work -> pixel permutation, so every refill
    batch mixes sky and in-medium pixels; below 2^31 / hw so the modular
    product cannot overflow 32 bits, and gcd(stride, hw) == 1."""
    if hw <= 4:
        return 1
    cap = max((1 << 31) // hw - 1, 1)
    s = max(int(cap * 0.618), 1) | 1
    while np.gcd(s, hw) != 1:
        s += 2
    return int(s) if s < hw else hw - 1


def _wave_pixels(W, H, pixel_bounds):
    """(P, 2) int32 (x, y) of the pixels a wave renders: the whole frame, or
    the film-clipped `pixel_bounds` (x0, x1, y0, y1) rectangle."""
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)
    if pixel_bounds is None:
        return pix
    x0, x1, y0, y1 = (int(v) for v in pixel_bounds)
    cx0, cx1, cy0, cy1 = max(0, x0), min(W, x1), max(0, y0), min(H, y1)
    if cx0 >= cx1 or cy0 >= cy1:
        raise ValueError(f"pixel bounds ({x0},{x1},{y0},{y1}) do not "
                         f"intersect the {W}x{H} film")
    if (cx0, cx1, cy0, cy1) != (x0, x1, y0, y1):
        warnings.warn(f"pixel bounds clipped to film extent: "
                      f"({cx0},{cx1},{cy0},{cy1})")
    keep = ((pix[:, 0] >= cx0) & (pix[:, 0] < cx1)
            & (pix[:, 1] >= cy0) & (pix[:, 1] < cy1))
    return pix[keep]


def _medium_tables(med_spec, device):
    """(density, majorant) tensors on `device`: the grid, or a 1^3 density
    of ones for a homogeneous or RGB medium (an RGB one's coefficients are
    in its RGB grids), and the medium's majorant."""
    density = med_spec.density
    if density is None:
        density = torch.ones((1, 1, 1), dtype=torch.float32, device=device)
    return density, med_spec.build_majorant(device)


def _rgb_arrays(med_spec):
    """MediumArrays' RGB grids of an RGB medium, scaled ({} otherwise)."""
    if not med_spec.rgb:
        return {}
    return dict(
        sigma_a_rgb=med_spec.sigma_a_rgb * med_spec.scale,
        sigma_s_rgb=med_spec.sigma_s_rgb * med_spec.scale,
        Le_rgb=(med_spec.Le_rgb * med_spec.Le_scale
                if med_spec.Le_rgb is not None else None))


def make_wave_renderer(scene, *, rays_per_wave: Optional[int] = None,
                       device=None, pixels=None):
    """Single-wave renderer: one camera sample for every pixel, traced in
    chunks of `rays_per_wave` rays (default 262144; the last chunk is padded
    with pixel (-1, -1), whose samples the film drops).  PCG streams are
    keyed by the flat pixel index, so a pixel-bounds render reproduces the
    full frame's pixels.

    Returns (render_wave, density, majorant), where render_wave(film,
    density, majorant, sample_idx) -> (film, [loop iterations of each
    chunk]).  A scene with a medium (homogeneous, grid or RGB grid, with or
    without surfaces) runs the fused volpath; without a medium, surfaces run
    scene.integrator (path, simplepath, randomwalk, ao, or volpath over an
    empty medium, whose loop iterations are counted; the path integrators
    count 0), and a scene with no surface returns the infinite lights'
    radiance.  The film may be a Film or a SpectralFilm.  `pixels`, a
    (P, 2) int32 array of (x, y), renders those pixels in place of the
    frame (rows of -1 render nothing): one shard of parallel/mesh.py's
    sharded wave render."""
    device = resolve(device)
    scene = scene.to(device)
    cam = scene.camera
    H, W = cam.height, cam.width
    med_spec = scene.medium
    prims = tuple(scene.primitives)
    integ = scene.integrator
    if med_spec is not None:
        maj_res = med_spec.maj_res()
        density, majorant = _medium_tables(med_spec, device)
        rgb_kw = _rgb_arrays(med_spec)
        w2m = torch.as_tensor(np.asarray(med_spec.world_to_unit(),
                                         np.float32), device=device)
        g = torch.tensor(med_spec.g, dtype=torch.float32, device=device)
    else:
        density = torch.ones((1, 1, 1), dtype=torch.float32, device=device)
        majorant = torch.ones((1, 1, 1), dtype=torch.float32, device=device)
        # volpath over an empty medium: a zero majorant, unit density
        empty = dda.MediumArrays(
            density=density, majorant=torch.zeros_like(majorant),
            w2m=torch.eye(4, device=device),
            g=torch.zeros((), dtype=torch.float32, device=device))

    pix_all = (_wave_pixels(W, H, scene.pixel_bounds) if pixels is None
               else np.asarray(pixels, np.int32))
    total = len(pix_all)
    chunk = min(rays_per_wave or 262144, total)
    n_chunks = (total + chunk - 1) // chunk
    pad = n_chunks * chunk - total
    if pad:
        pix_all = np.concatenate([pix_all, np.full((pad, 2), -1, np.int32)])
    idx_all = (pix_all[:, 1].astype(np.int64) * W + pix_all[:, 0]) & 0xFFFFFFFF
    pix_chunks = torch.as_tensor(pix_all.reshape(n_chunks, chunk, 2),
                                 device=device)
    idx_chunks = torch.as_tensor(idx_all.reshape(n_chunks, chunk),
                                 device=device)

    def render_chunk(film, density, majorant, sample_idx, pix, pixidx):
        sidx = torch.full(pixidx.shape, int(sample_idx), dtype=torch.int64,
                          device=device)
        ua, ub, rng = samplers.film_sample(scene.sampler, pixidx, sidx,
                                           scene.spp, seed=scene.seed,
                                           pix=pix)
        off = scene.filter.sample_offset(torch.stack([ua, ub], -1)) + 0.5
        if scene.disable_pixel_jitter:
            off = torch.full_like(off, 0.5)
        rng, ul = dda.pcg_uniform(rng)
        if scene.disable_wavelength_jitter:
            ul = torch.full_like(ul, 0.5)
        swl = sp.sample_wavelengths_visible(ul)
        o, d = cam.generate_rays(pix, off)
        L, iterations = trace(o, d, swl.lam, rng, pixidx, sidx)
        return film.add_samples(pix, L, swl), iterations

    def trace(o, d, lam, rng, pixidx, sidx):
        """(L, loop iterations) of the chunk's camera rays, by the
        reference's branches (its render.py l. 133-218)."""
        if med_spec is not None:
            Le = (med_spec.Le_spec(lam) * med_spec.Le_scale
                  if med_spec.Le_spec is not None else torch.zeros_like(lam))
            med = dda.MediumArrays(
                density=density, majorant=majorant, w2m=w2m, g=g,
                sigma_a=med_spec.sigma_a_spec(lam) * med_spec.scale,
                sigma_s=med_spec.sigma_s_spec(lam) * med_spec.scale, Le=Le,
                **rgb_kw)
            res = volpath.li(
                med, scene.lights, o, d, lam, rng, maj_res=maj_res,
                homogeneous=med_spec.homogeneous, max_depth=scene.max_depth,
                max_march_steps=scene.max_march_steps, rgb_mode=med_spec.rgb,
                prims=prims, light_strategy=scene.light_sampler)
            return res.L, res.iterations
        if not prims:
            return lights_mod.escaped_radiance(scene.lights, d, lam)[0], 0
        if integ == "path":
            # a low-discrepancy sampler covers the path dimensions too
            # (samplers.h Get1D advancing `dimension`); its fallback past
            # max_dims runs on a stream of its own, not the caller's
            usrc = (None if scene.sampler == "independent" else
                    samplers.PathSampler(scene.sampler, pixidx, sidx,
                                         scene.spp, seed=scene.seed + 0x9A7))
            L, _ = path_mod.li_path(
                prims, scene.lights, o, d, lam, rng,
                max_depth=scene.max_depth,
                light_strategy=scene.light_sampler,
                regularize=scene.regularize, uniform_source=usrc)
        elif integ == "simplepath":
            # SimplePathIntegrator's defaults: light sampling without MIS
            L, _ = path_mod.li_path(prims, scene.lights, o, d, lam, rng,
                                    max_depth=scene.max_depth, nee=True,
                                    mis=False)
        elif integ == "randomwalk":
            L, _ = path_mod.li_random_walk(prims, scene.lights, o, d, lam,
                                           rng, max_depth=scene.max_depth)
        elif integ == "ao":
            L, _ = path_mod.li_ao(prims, scene.lights, o, d, lam, rng)
        else:
            # volpath over an empty medium; the reference passes no light
            # strategy on this branch (uniform)
            zero = torch.zeros_like(lam)
            res = volpath.li(
                empty._replace(sigma_a=zero, sigma_s=zero, Le=zero),
                scene.lights, o, d, lam, rng, maj_res=(1, 1, 1),
                homogeneous=True, max_depth=scene.max_depth,
                max_march_steps=scene.max_march_steps, prims=prims)
            return res.L, res.iterations
        return L, 0

    def render_wave(film, density, majorant, sample_idx):
        iterations = []
        for ci in range(n_chunks):
            film, it = render_chunk(film, density, majorant, sample_idx,
                                    pix_chunks[ci], idx_chunks[ci])
            iterations.append(it)
        return film, iterations

    return render_wave, density, majorant


def make_regen_renderer(scene, *, device=None, n_lanes: int = 4096,
                        spp: Optional[int] = None, k_substeps: int = 16,
                        stochastic_filter: bool = False,
                        retire_every: int = 1,
                        retire_groups: int = 1,
                        sub_rounds: int = 1,
                        accum_spp: bool = False,
                        event_groups: int = 1,
                        work_stride=1,
                        record_alive: bool = False,
                        count_events: bool = False,
                        residual_shadow: bool = False,
                        work_base: int = 0,
                        local_total: Optional[int] = None):
    """Path-regeneration renderer on `device`: a retiring lane immediately
    pulls the next work item, so the whole frame x spp workload runs near
    full lane occupancy.  Returns (run, density, majorant), where
    run(density, majorant, film_rgb) -> volpath_fused.LiResult adds the
    frame into the flat channel-major film (in place); the result holds
    alive_hist with record_alive and ev_counts with count_events.
    residual_shadow on a scalar grid builds the minorant grid of residual
    ratio tracking.  A scene's `max_component` attribute, when it has one,
    clamps each retired rgb.  `work_base` and `local_total` render only
    the local_total (pixel, sample) work items from work_base on of the
    frame's H*W*spp (pixel-aligned with accum_spp), items past the frame's
    end discarded: one shard of parallel/mesh.py's sharded render."""
    device = resolve(device)
    max_component = getattr(scene, "max_component", float("inf"))
    scene = scene.to(device)
    cam = scene.camera
    H, W = cam.height, cam.width
    spp = spp if spp is not None else scene.spp
    med_spec = scene.medium
    assert med_spec is not None, "regen renderer requires a medium"
    maj_res = med_spec.maj_res()
    LANES = sp.N_SPECTRUM_SAMPLES
    density, majorant = _medium_tables(med_spec, device)
    minorant = None
    if (residual_shadow and not med_spec.homogeneous
            and med_spec.density is not None and not med_spec.rgb):
        minorant = torch.as_tensor(gridops.build_minorant_grid(
            med_spec.density.cpu().numpy(), maj_res), device=device)
    rgb_kw = _rgb_arrays(med_spec)
    global_total = H * W * spp
    total_work = global_total if local_total is None else int(local_total)
    N = int(min(n_lanes, total_work))
    refills = (total_work + N - 1) // N
    iter_cap = int(scene.max_march_steps) * (refills + 1)
    w2m = torch.as_tensor(np.asarray(med_spec.world_to_unit(), np.float32),
                          device=device)
    g = torch.tensor(med_spec.g, dtype=torch.float32, device=device)

    def sigma_a_fn(lam):
        return med_spec.sigma_a_spec(lam) * med_spec.scale

    def sigma_s_fn(lam):
        return med_spec.sigma_s_spec(lam) * med_spec.scale

    def Le_fn(lam):
        return (med_spec.Le_spec(lam) * med_spec.Le_scale
                if med_spec.Le_spec is not None else torch.zeros_like(lam))

    def run(density, majorant, film_rgb):
        med = dda.MediumArrays(density=density, majorant=majorant, w2m=w2m,
                               g=g, minorant=minorant, **rgb_kw)
        regen = dict(
            camera=cam, filter=scene.filter, sampler=scene.sampler,
            spp=spp, H=H, W=W, total_work=total_work, seed=scene.seed,
            work_base=work_base, global_total=global_total,
            sigma_a_fn=sigma_a_fn, sigma_s_fn=sigma_s_fn, Le_fn=Le_fn,
            film_rgb=film_rgb,
            max_component=max_component,
            work_stride=(work_stride_for(H * W) if work_stride == "auto"
                         else int(work_stride)),
        )
        f32 = torch.float32
        return volpath.li(
            med, scene.lights,
            torch.zeros((N, 3), dtype=f32, device=device),
            torch.zeros((N, 3), dtype=f32, device=device),
            torch.zeros((N, LANES), dtype=f32, device=device),
            torch.zeros((N,), dtype=torch.int64, device=device),
            maj_res=maj_res, homogeneous=med_spec.homogeneous,
            max_depth=scene.max_depth, max_march_steps=iter_cap,
            rgb_mode=med_spec.rgb,
            k_substeps=k_substeps, stochastic_filter=stochastic_filter,
            retire_every=retire_every, retire_groups=retire_groups,
            sub_rounds=sub_rounds, accum_spp=accum_spp,
            event_groups=event_groups, prims=tuple(scene.primitives),
            regen=regen, light_strategy=scene.light_sampler,
            record_alive=record_alive, count_events=count_events,
            residual_shadow=residual_shadow)

    return run, density, majorant


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def film_to_image(film_rgb, H, W, spp):
    """Flat channel-major film (3 * (H*W + 1),) -> (H, W, 3) float32 numpy
    image; the per-sample weight is 1, so the normalizer is spp."""
    f = film_rgb.detach().cpu().numpy().reshape(3, H * W + 1)[:, :H * W]
    return (f.T / float(spp)).reshape(H, W, 3).astype(np.float32)


def render_regen(scene, spp: Optional[int] = None, n_lanes: int = 4096,
                 k_substeps: int = 16, stochastic_filter: bool = False, *,
                 device=None, **knobs):
    """Full render via path regeneration on `device`: ((H, W, 3) numpy
    image, stats).  Extra knobs (retire_groups, accum_spp, work_stride,
    record_alive, count_events, residual_shadow, ...) forward to
    make_regen_renderer.  The stats hold the loop's iteration count, with
    record_alive the mean lane occupancy over the iterations that had a
    live lane, and with count_events the [main, shadow] collision counts."""
    dev = resolve(device)
    spp = spp if spp is not None else scene.spp
    H, W = scene.height, scene.width
    run, density, majorant = make_regen_renderer(
        scene, device=dev, n_lanes=n_lanes, spp=spp,
        k_substeps=k_substeps, stochastic_filter=stochastic_filter, **knobs)
    film_rgb = torch.zeros((3 * (H * W + 1),), dtype=torch.float32,
                           device=dev)
    _sync(dev)
    t0 = time.time()
    res = run(density, majorant, film_rgb)
    _sync(dev)
    dt = time.time() - t0
    stats = {"render_time": dt, "spp": spp,
             "rays_per_sec": H * W * spp / dt, "iterations": res.iterations}
    if res.alive_hist is not None:
        h = res.alive_hist.cpu().numpy()
        live = int((h > 0).sum())
        n = min(n_lanes, H * W * spp)
        stats["occupancy"] = float(h.sum()) / (live * n) if live else 0.0
    if res.ev_counts is not None:
        stats["ev_counts"] = res.ev_counts.tolist()
    return film_to_image(res.film_rgb, H, W, spp), stats


def render(scene, spp: Optional[int] = None, progress: bool = False, *,
           device=None):
    """Full render through the wave renderer (chunks of the default
    262144 rays), the library's default entry: returns ((H, W, 3) numpy
    image, stats).  The stats hold the render seconds, spp, rays per
    second, the loop iterations summed over the chunks and waves, and those
    of each chunk in wave order.  Other chunk sizes: make_wave_renderer."""
    dev = resolve(device)
    spp = spp if spp is not None else scene.spp
    H, W = scene.height, scene.width
    render_wave, density, majorant = make_wave_renderer(scene, device=dev)
    film = Film.create(H, W, dev)
    chunk_iterations = []
    _sync(dev)
    t0 = time.time()
    for s in range(spp):
        film, its = render_wave(film, density, majorant, s)
        chunk_iterations += its
        if progress and (s & (s + 1)) == 0:
            _sync(dev)
            print(f"  wave {s + 1}/{spp}  {time.time() - t0:.1f}s",
                  flush=True)
    img = film.to_image().cpu().numpy()
    dt = time.time() - t0
    return img, {"render_time": dt, "spp": spp,
                 "rays_per_sec": H * W * spp / dt,
                 "iterations": sum(chunk_iterations),
                 "chunk_iterations": chunk_iterations}


def render_lightpath(scene, spp: Optional[int] = None, n_paths_per_wave=None,
                     *, device=None):
    """The LightPath integrator's renderer: each wave traces H*W light paths
    (or n_paths_per_wave) and splats them through the camera
    (models/integrators/light_path.py); the image is the splat sum over the
    number of traced paths.  Returns ((H, W, 3) numpy image, stats)."""
    from ..models.integrators import light_path as lp_mod
    from ..utils import colorspace

    dev = resolve(device)
    scene = scene.to(dev)
    spp = spp if spp is not None else scene.spp
    H, W = scene.height, scene.width
    n_paths = n_paths_per_wave or (H * W)
    pidx = torch.arange(n_paths, dtype=torch.int64, device=dev)
    splat = torch.zeros((H * W + 1, 3), dtype=torch.float32, device=dev)
    _sync(dev)
    t0 = time.time()
    for s in range(spp):
        rng = dda.seed_stream(pidx, torch.full_like(pidx, s),
                              salt=scene.seed + 17)
        rng, ul = dda.pcg_uniform(rng)
        swl = sp.sample_wavelengths_visible(ul)
        pix, val, _ = lp_mod.trace_light_paths(
            tuple(scene.primitives), scene.lights, scene.camera, n_paths,
            swl.lam, rng, max_depth=scene.max_depth,
            light_strategy=scene.light_sampler)
        reps = pix.shape[0] // n_paths
        swl_r = sp.SampledWavelengths(swl.lam.repeat(reps, 1),
                                      swl.pdf.repeat(reps, 1))
        rgb = torch.nan_to_num(colorspace.xyz_to_rgb(sp.to_xyz(val, swl_r)),
                               nan=0.0, posinf=0.0, neginf=0.0)
        # invalid splats land in the last row, which the image drops
        flat = torch.where(pix[:, 0] >= 0, pix[:, 1] * W + pix[:, 0], H * W)
        splat.index_add_(0, flat, rgb)
    img = (splat[:H * W].reshape(H, W, 3) / (spp * n_paths)).cpu().numpy()
    dt = time.time() - t0
    return img, {"render_time": dt, "spp": spp, "n_paths": spp * n_paths}


def render_with_aovs(scene, spp: Optional[int] = None, *, device=None):
    """render() plus per-pixel variance (the GBufferFilm variance channels,
    film.h:319), by Welford's update over the per-wave images: returns
    ((H, W, 3) image, {"variance", "relative_variance"}, stats); the
    variance is that of the mean image."""
    dev = resolve(device)
    spp = spp if spp is not None else scene.spp
    H, W = scene.height, scene.width
    render_wave, density, majorant = make_wave_renderer(scene, device=dev)
    mean = np.zeros((H, W, 3), np.float64)
    m2 = np.zeros((H, W, 3), np.float64)
    prev = np.zeros((H, W, 3), np.float32)
    prev_w = np.zeros((H, W), np.float32)
    film = Film.create(H, W, dev)
    _sync(dev)
    t0 = time.time()
    for s in range(spp):
        film, _ = render_wave(film, density, majorant, s)
        cur_sum = film.rgb_sum.cpu().numpy()
        cur_w = film.weight_sum.cpu().numpy()
        dw = np.maximum(cur_w - prev_w, 1e-12)[..., None]
        wave_img = (cur_sum - prev) / dw
        prev, prev_w = cur_sum, cur_w
        delta = wave_img - mean
        mean += delta / (s + 1)
        m2 += delta * (wave_img - mean)
    img = film.to_image().cpu().numpy()
    dt = time.time() - t0
    var = (m2 / max(spp - 1, 1) / spp).astype(np.float32)
    aovs = {"variance": var,
            "relative_variance": var / (img.astype(np.float64) ** 2 + 1e-4)}
    return img, aovs, {"render_time": dt, "spp": spp}


def render_gbuffer(scene, spp: Optional[int] = None, *, device=None):
    """Geometric AOVs of the first surface hit of each pixel-centre camera
    ray (the GBufferFilm channels, film.h:319): P, N, albedo (the mean
    over four 550 nm lanes as RGB), uv and depth, from one intersect_all
    over the opaque primitives; a pixel without a hit has depth inf and
    zeros.  Returns ({name: numpy array}, stats)."""
    from ..models import shapes as shapes_mod
    from ..utils import colorspace as cspace

    dev = resolve(device)
    scene = scene.to(dev)
    H, W = scene.height, scene.width
    opaque = tuple(p for p in scene.primitives if p.material is not None)
    N = H * W
    _sync(dev)
    t0 = time.time()
    pix = torch.as_tensor(_wave_pixels(W, H, None), device=dev)
    o, d = scene.camera.generate_rays(
        pix, torch.full((N, 2), 0.5, device=dev))
    if opaque:
        hit = shapes_mod.intersect_all(opaque, o, d, torch.inf)
        found = torch.isfinite(hit.t)
        lam = torch.full((N, sp.N_SPECTRUM_SAMPLES), 550.0, device=dev)
        p_ctx = torch.where(found[:, None],
                            o + torch.nan_to_num(hit.t, posinf=0.0)[:, None]
                            * d, o)
        prm = path_mod._gather_mat_params(opaque, lam, hit.uv, N, p=p_ctx,
                                          n=hit.n)
        alb_spec = path_mod._take(
            prm["albedo"], torch.clamp(hit.prim_id, 0, len(opaque) - 1))
        swl = sp.SampledWavelengths(lam, torch.ones_like(lam))
        p_hit = torch.where(found[:, None], o + hit.t[:, None] * d, 0.0)
        n_hit = torch.where(found[:, None], hit.n, 0.0)
        alb = torch.where(found[:, None], alb_spec, 0.0)
        alb_rgb = cspace.xyz_to_rgb(sp.to_xyz(alb * sp.CIE_Y_INTEGRAL, swl))
        uv = torch.where(found[:, None], hit.uv, 0.0)
        depth = hit.t
    else:
        p_hit = n_hit = alb_rgb = torch.zeros((N, 3), device=dev)
        uv = torch.zeros((N, 2), device=dev)
        depth = torch.full((N,), torch.inf, device=dev)
    host = lambda t, *shape: t.cpu().numpy().reshape(H, W, *shape)
    aovs = {"P": host(p_hit, 3), "N": host(n_hit, 3),
            "albedo": host(torch.clamp(alb_rgb, min=0.0), 3),
            "uv": host(uv, 2), "depth": host(depth)}
    return aovs, {"render_time": time.time() - t0}


def render_spectral(scene, spp: Optional[int] = None, n_buckets: int = 16,
                    *, device=None):
    """Render through the wave driver into a SpectralFilm (film.h:401): RGB
    plus one image per wavelength bucket.  Returns (film, stats)."""
    from ..models.film import SpectralFilm

    dev = resolve(device)
    spp = spp if spp is not None else scene.spp
    H, W = scene.height, scene.width
    render_wave, density, majorant = make_wave_renderer(scene, device=dev)
    film = SpectralFilm.create(H, W, n_buckets=n_buckets, device=dev)
    _sync(dev)
    t0 = time.time()
    for s in range(spp):
        film, _ = render_wave(film, density, majorant, s)
    _sync(dev)
    dt = time.time() - t0
    return film, {"render_time": dt, "spp": spp,
                  "rays_per_sec": H * W * spp / dt}


def make_graph_wave_renderer(scene, graph, *, device=None):
    """Wave renderer of the graph-cache integrator: every pixel's camera
    ray delta-tracks to its first real scatter and reads the cache there
    (models/integrators/graph.py), a uniform graph by voxel lookup, a free
    one by the radius-escalated weighted search.  The light spectrum is the
    scene's first delta light's.  A homogeneous or scalar-grid medium.

    Returns (render_wave, density, majorant), where render_wave(film,
    density, majorant, sample_idx) -> film adds one sample of every pixel;
    streams are keyed by (flat pixel index, sample index)."""
    from ..models.integrators import graph as graph_integrator

    device = resolve(device)
    scene = scene.to(device)
    cam = scene.camera
    H, W = cam.height, cam.width
    med_spec = scene.medium
    if med_spec is None or med_spec.rgb:
        raise ValueError("render_graph needs a homogeneous or scalar-grid "
                         "medium")
    maj_res = med_spec.maj_res()
    uniform = getattr(graph, "kind", "free") == "uniform"
    index = (graph_integrator.build_uniform_index(graph, device) if uniform
             else graph_integrator.build_connect_index(graph, device=device))
    li_fn = graph_integrator.li_uniform if uniform else graph_integrator.li
    light = next(lt for lt in scene.lights if lt.is_delta)
    density, majorant = _medium_tables(med_spec, device)
    w2m = torch.as_tensor(np.asarray(med_spec.world_to_unit(), np.float32),
                          device=device)
    g = torch.tensor(med_spec.g, dtype=torch.float32, device=device)
    pix = torch.as_tensor(_wave_pixels(W, H, None), device=device)
    pixidx = torch.arange(H * W, dtype=torch.int64, device=device)

    def render_wave(film, density, majorant, sample_idx):
        sidx = torch.full((H * W,), int(sample_idx), dtype=torch.int64,
                          device=device)
        rng = dda.seed_stream(pixidx, sidx, salt=scene.seed)
        rng, ua = dda.pcg_uniform(rng)
        rng, ub = dda.pcg_uniform(rng)
        off = scene.filter.sample_offset(torch.stack([ua, ub], -1)) + 0.5
        rng, ul = dda.pcg_uniform(rng)
        swl = sp.sample_wavelengths_visible(ul)
        o, d = cam.generate_rays(pix, off)
        med = dda.MediumArrays(
            density=density, majorant=majorant, w2m=w2m, g=g,
            sigma_a=med_spec.sigma_a_spec(swl.lam) * med_spec.scale,
            sigma_s=med_spec.sigma_s_spec(swl.lam) * med_spec.scale,
            Le=torch.zeros_like(swl.lam))
        L = li_fn(med, index, light.spectrum(swl.lam) * light.scale, o, d,
                  swl.lam, rng, maj_res=maj_res,
                  homogeneous=med_spec.homogeneous,
                  max_march_steps=scene.max_march_steps)
        return film.add_samples(pix, L, swl)

    return render_wave, density, majorant


def render_graph(scene, graph, spp: Optional[int] = None, *, device=None):
    """Render `scene` with the radiance cache `graph` (light scalars set):
    ((H, W, 3) numpy image, stats).  The stats hold the render seconds
    (after a device synchronize), spp, rays per second and the
    delta-tracking loop iterations of each wave."""
    dev = resolve(device)
    spp = spp if spp is not None else scene.spp
    H, W = scene.height, scene.width
    render_wave, density, majorant = make_graph_wave_renderer(
        scene, graph, device=dev)
    film = Film.create(H, W, dev)
    iterations = []
    _sync(dev)
    t0 = time.time()
    for s in range(spp):
        before = dda.delta_track_iterations
        film = render_wave(film, density, majorant, s)
        iterations.append(dda.delta_track_iterations - before)
    img = film.to_image().cpu().numpy()
    _sync(dev)
    dt = time.time() - t0
    return img, {"render_time": dt, "spp": spp,
                 "rays_per_sec": H * W * spp / dt, "iterations": iterations}
