"""Render entry points, path-regeneration form
(port of acceleratedvolrenderer_tpu/parallel/render.py: work_stride_for,
make_regen_renderer and render_regen)."""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..models.integrators import volpath_fused as volpath
from ..ops import dda
from ..utils import spectrum as sp


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


def make_regen_renderer(scene, *, device, n_lanes: int = 4096,
                        spp: Optional[int] = None, k_substeps: int = 16,
                        stochastic_filter: bool = False,
                        retire_every: int = 1,
                        retire_groups: int = 1,
                        accum_spp: bool = False,
                        event_groups: int = 1,
                        work_stride=1,
                        record_alive: bool = False,
                        residual_shadow: bool = False):
    """Path-regeneration renderer on `device`: a retiring lane immediately
    pulls the next work item, so the whole frame x spp workload runs near
    full lane occupancy.  Returns (run, density, majorant), where
    run(density, majorant, film_rgb) -> volpath_fused.LiResult adds the
    frame into the flat channel-major film (in place)."""
    scene = scene.to(device)
    cam = scene.camera
    H, W = cam.height, cam.width
    spp = spp if spp is not None else scene.spp
    med_spec = scene.medium
    assert med_spec is not None, "regen renderer requires a medium"
    maj_res = med_spec.maj_res()
    LANES = sp.N_SPECTRUM_SAMPLES
    density = med_spec.density
    majorant = med_spec.build_majorant()
    total_work = H * W * spp
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
                               g=g)
        regen = dict(
            camera=cam, filter=scene.filter, sampler=scene.sampler,
            spp=spp, H=H, W=W, total_work=total_work, seed=scene.seed,
            sigma_a_fn=sigma_a_fn, sigma_s_fn=sigma_s_fn, Le_fn=Le_fn,
            film_rgb=film_rgb,
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
            k_substeps=k_substeps, stochastic_filter=stochastic_filter,
            retire_every=retire_every, retire_groups=retire_groups,
            accum_spp=accum_spp,
            event_groups=event_groups, regen=regen,
            light_strategy=scene.light_sampler,
            record_alive=record_alive, residual_shadow=residual_shadow)

    return run, density, majorant


def film_to_image(film_rgb, H, W, spp):
    """Flat channel-major film (3 * (H*W + 1),) -> (H, W, 3) float32 numpy
    image; the per-sample weight is 1, so the normalizer is spp."""
    f = film_rgb.detach().cpu().numpy().reshape(3, H * W + 1)[:, :H * W]
    return (f.T / float(spp)).reshape(H, W, 3).astype(np.float32)


def render_regen(scene, spp: Optional[int] = None, n_lanes: int = 4096,
                 k_substeps: int = 16, stochastic_filter: bool = False, *,
                 device, **knobs):
    """Full render via path regeneration on `device`: ((H, W, 3) numpy
    image, stats).  Extra knobs (retire_groups, accum_spp, work_stride,
    record_alive, ...) forward to make_regen_renderer.  The stats hold the
    loop's iteration count and, with record_alive, the mean lane occupancy
    over the iterations that had a live lane."""
    spp = spp if spp is not None else scene.spp
    H, W = scene.height, scene.width
    run, density, majorant = make_regen_renderer(
        scene, device=device, n_lanes=n_lanes, spp=spp,
        k_substeps=k_substeps, stochastic_filter=stochastic_filter, **knobs)
    film_rgb = torch.zeros((3 * (H * W + 1),), dtype=torch.float32,
                           device=device)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    res = run(density, majorant, film_rgb)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    stats = {"render_time": dt, "spp": spp,
             "rays_per_sec": H * W * spp / dt, "iterations": res.iterations}
    if res.alive_hist is not None:
        h = res.alive_hist.cpu().numpy()
        live = int((h > 0).sum())
        n = min(n_lanes, H * W * spp)
        stats["occupancy"] = float(h.sum()) / (live * n) if live else 0.0
    return film_to_image(res.film_rgb, H, W, spp), stats
