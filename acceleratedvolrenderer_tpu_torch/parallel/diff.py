"""Differentiable rendering
(port of acceleratedvolrenderer_tpu/parallel/diff.py: DIFF_PARAMS,
_diff_setup, _make_render_L, make_diff_renderer_multi, make_diff_renderer,
image_and_density_grad, _regen_loss_builder, mean_loss_cotangent,
make_diff_regen_renderer and make_regen_film_vjp).

The estimator is the detached-sampling form (volpath_fused docstring):
with the majorant frozen at `majorant_inflation` x the build-time density
maximum and the sampling-side density frozen at the build-time field,
sample paths do not depend on the density parameter, so autograd through
the weight products is an unbiased gradient, and because the RNG streams
are counter-based, central differences of the estimator itself (same
streams, same majorant) agree with it to float precision.

The wave path (`make_diff_renderer_multi`) differentiates every family of
DIFF_PARAMS: the density grid, the sigma_a / sigma_s spectrum
coefficients (their sampling side frozen at the base spectra) and the
per-voxel emission scale grid Le_grid.  The regen path differentiates the
density only, as in the reference.  Both sample lights uniformly, as the
reference's gradients do, whatever the scene's `light_sampler`.  The sharded `make_sharded_loss` and
`make_sharded_regen_grad` are not ported yet.  Entry points run on the
CUDA card unless given another `device`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.integrators import volpath_fused
from ..ops import dda
from ..ops import grid as gridops
from ..utils import spectrum as sp
from ..utils.device import resolve
from .render import work_stride_for

#: differentiable parameter families of the reference (BASELINE contract)
DIFF_PARAMS = ("density", "sigma_a", "sigma_s", "Le_grid")


def _diff_setup(scene, majorant_inflation):
    """(medium spec, maj_res, frozen majorant, frozen sampling density),
    on the scene's device."""
    med_spec = scene.medium
    assert med_spec is not None and not med_spec.homogeneous, (
        "differentiable path optimizes a density grid")
    maj_res = med_spec.maj_res()
    density = med_spec.density
    majorant = (gridops.build_majorant_grid(density.cpu().numpy(), maj_res)
                * majorant_inflation)
    majorant_const = torch.as_tensor(majorant, dtype=torch.float32,
                                     device=density.device)
    # frozen sampling-side density: decisions and pdfs stay at the
    # build-time field, so the sample distribution is parameter-independent
    density_s_const = density.to(torch.float32).detach()
    return med_spec, maj_res, majorant_const, density_s_const


def _make_render_L(scene, fixed_steps, majorant_inflation, device):
    """Shared differentiable per-ray radiance body.  Returns
    render_L(params, sample_idx, pix, pixidx) -> (L, swl) plus the frozen
    density (the default when params has no 'density')."""
    scene = scene.to(device)
    cam = scene.camera
    med_spec, maj_res, majorant_const, density_s_const = _diff_setup(
        scene, majorant_inflation)
    w2m = torch.as_tensor(np.asarray(med_spec.world_to_unit(), np.float32),
                          device=device)
    g = torch.tensor(med_spec.g, dtype=torch.float32, device=device)

    def render_L(params, sample_idx, pix, pixidx):
        sidx = torch.full(pixidx.shape, int(sample_idx), dtype=torch.int64,
                          device=device)
        rng = dda.seed_stream(pixidx, sidx, salt=scene.seed)
        rng, ua = dda.pcg_uniform(rng)
        rng, ub = dda.pcg_uniform(rng)
        off = scene.filter.sample_offset(torch.stack([ua, ub], -1)) + 0.5
        rng, ul = dda.pcg_uniform(rng)
        swl = sp.sample_wavelengths_visible(ul)
        o, d = cam.generate_rays(pix, off)
        sa0 = med_spec.sigma_a_spec(swl.lam) * med_spec.scale
        ss0 = med_spec.sigma_s_spec(swl.lam) * med_spec.scale
        Le = (med_spec.Le_spec(swl.lam) * med_spec.Le_scale
              if med_spec.Le_spec is not None else torch.zeros_like(swl.lam))
        med = dda.MediumArrays(
            density=params.get("density", density_s_const),
            majorant=majorant_const, w2m=w2m, g=g,
            sigma_a=sa0 * params.get("sigma_a", 1.0),
            sigma_s=ss0 * params.get("sigma_s", 1.0), Le=Le,
            density_s=density_s_const, Le_grid=params.get("Le_grid", None),
            # sampling side frozen at the base spectra: sample paths do not
            # depend on the coefficients, so FD of the estimator == AD
            sigma_a_s=sa0.detach(), sigma_s_s=ss0.detach())
        res = volpath_fused.li(
            med, scene.lights, o, d, swl.lam, rng, maj_res=maj_res,
            homogeneous=False, max_depth=scene.max_depth,
            fixed_steps=fixed_steps)
        return res.L, swl

    return render_L, density_s_const


def _as_params(params, device):
    """The params dict with every value a float32 tensor on `device`."""
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in params.items()}


def make_diff_renderer_multi(scene, *, fixed_steps: int = 256, spp: int = 4,
                             majorant_inflation: float = 1.5, device=None):
    """Multi-parameter differentiable renderer on `device`.

    Returns (loss_fn(params) -> 0-d tensor, grad_fn(params) -> dict of
    gradients), over a params dict with keys from DIFF_PARAMS (any subset;
    missing entries take the scene's values and get no gradient).  Loss =
    mean pixel luminance over `spp` samples, every ray traced for exactly
    `fixed_steps` loop iterations under per-step checkpointing.  The
    majorant is frozen at `majorant_inflation` x the build-time density
    maximum, so it stays an upper bound under perturbations; sigma
    coefficients must stay within the same headroom."""
    device = resolve(device)
    H, W = scene.camera.height, scene.camera.width
    render_L, _ = _make_render_L(scene, fixed_steps, majorant_inflation,
                                 device)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix = torch.as_tensor(np.stack([xs.reshape(-1), ys.reshape(-1)], -1)
                          .astype(np.int32), device=device)
    pixidx = torch.arange(H * W, dtype=torch.int64, device=device)

    def loss_fn(params):
        params = _as_params(params, device)
        total = 0.0
        for s in range(spp):
            L, swl = render_L(params, s, pix, pixidx)
            total = total + torch.sum(sp.y_luminance(L, swl))
        return total / (spp * H * W)

    def grad_fn(params):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in _as_params(params, device).items()}
        grads = torch.autograd.grad(loss_fn(leaves), list(leaves.values()),
                                    allow_unused=True)
        return {k: torch.zeros_like(v) if gk is None else gk
                for (k, v), gk in zip(leaves.items(), grads)}

    return loss_fn, grad_fn


def make_diff_renderer(scene, *, fixed_steps: int = 256, spp: int = 4,
                       majorant_inflation: float = 1.5, device=None):
    """Density-only form of make_diff_renderer_multi: returns
    (loss_fn(density), grad_fn(density))."""
    loss_multi, grad_multi = make_diff_renderer_multi(
        scene, fixed_steps=fixed_steps, spp=spp,
        majorant_inflation=majorant_inflation, device=device)

    def loss_fn(density):
        return loss_multi({"density": density})

    def grad_fn(density):
        return grad_multi({"density": density})["density"]

    return loss_fn, grad_fn


def image_and_density_grad(scene, density=None, *, device=None, **kw):
    """Mean-luminance loss value and d loss / d density grid (numpy)."""
    device = resolve(device)
    loss_fn, grad_fn = make_diff_renderer(scene, device=device, **kw)
    dens = torch.as_tensor(scene.medium.density if density is None
                           else density, dtype=torch.float32, device=device)
    with torch.no_grad():
        loss = float(loss_fn(dens))
    return loss, grad_fn(dens).cpu().numpy()


def _regen_loss_builder(scene, *, device, fixed_steps=192, n_lanes=None,
                        spp=2, majorant_inflation=1.5, accum_spp=False,
                        k_substeps=8, retire_groups=1,
                        stochastic_filter=False, remat_window=None,
                        work_stride=1, slim=True):
    """Shared core of the differentiable regen path.

    Returns (loss_core, (H, W)), where loss_core(density, cot_flat) =
    sum(cot . film_render(density)): the film is a pure scatter-add of
    retired samples, so its dot with a cotangent commutes with the
    accumulation.  slim=True accumulates that dot in the loop instead of
    the film (loss-cotangent mode: the film never enters the carry, so the
    checkpointed carries stay small); slim=False keeps the film scatter in
    the loop, the contract check that both give the same gradient."""
    scene = scene.to(device)
    med_spec, maj_res, majorant_const, density_s_const = _diff_setup(
        scene, majorant_inflation)
    cam = scene.camera
    H, W = cam.height, cam.width
    LANES = sp.N_SPECTRUM_SAMPLES
    total_work = H * W * spp
    N = int(n_lanes or min(4096, total_work))
    n_here = int(min(N, total_work))
    f32 = torch.float32
    w2m = torch.as_tensor(np.asarray(med_spec.world_to_unit(), np.float32),
                          device=device)
    g = torch.tensor(med_spec.g, dtype=f32, device=device)

    def sigma_a_fn(lam):
        return med_spec.sigma_a_spec(lam) * med_spec.scale

    def sigma_s_fn(lam):
        return med_spec.sigma_s_spec(lam) * med_spec.scale

    def Le_fn(lam):
        return (med_spec.Le_spec(lam) * med_spec.Le_scale
                if med_spec.Le_spec is not None else torch.zeros_like(lam))

    def loss_core(density, cot_flat):
        med = dda.MediumArrays(density=density, majorant=majorant_const,
                               w2m=w2m, g=g, density_s=density_s_const)
        regen = dict(
            camera=cam, filter=scene.filter, sampler=scene.sampler,
            spp=spp, H=H, W=W, total_work=total_work, seed=scene.seed,
            sigma_a_fn=sigma_a_fn, sigma_s_fn=sigma_s_fn, Le_fn=Le_fn,
            film_rgb=torch.zeros((1,) if slim else (3 * (H * W + 1),),
                                 dtype=f32, device=device),
            work_stride=(work_stride_for(H * W) if work_stride == "auto"
                         else int(work_stride)),
        )
        if slim:
            regen["loss_cotangent"] = cot_flat
        res = volpath_fused.li(
            med, scene.lights,
            torch.zeros((n_here, 3), dtype=f32, device=device),
            torch.zeros((n_here, 3), dtype=f32, device=device),
            torch.zeros((n_here, LANES), dtype=f32, device=device),
            torch.zeros((n_here,), dtype=torch.int64, device=device),
            maj_res=maj_res, homogeneous=False,
            max_depth=scene.max_depth, fixed_steps=fixed_steps,
            remat_window=remat_window, k_substeps=k_substeps,
            stochastic_filter=stochastic_filter,
            retire_groups=retire_groups, accum_spp=accum_spp, regen=regen)
        if slim:
            return res.film_rgb[0]
        return torch.sum(res.film_rgb * cot_flat)

    return loss_core, (H, W)


def mean_loss_cotangent(H, W, spp, device="cpu"):
    """Flat channel-major cotangent for loss = mean(film / spp): every
    real film element weighs 1/(3*H*W*spp); the per-channel discard slot
    (out-of-frame / out-of-queue splats) weighs 0."""
    cot = np.full((3, H * W + 1), 1.0 / (3 * H * W * spp), np.float32)
    cot[:, H * W] = 0.0
    return torch.as_tensor(cot.reshape(-1), device=device)


def _grad(loss_core, density, cot):
    """d loss_core(density, cot) / d density, through a leaf copy."""
    leaf = density.detach().clone().requires_grad_(True)
    loss = loss_core(leaf, cot)
    (g,) = torch.autograd.grad(loss, leaf, allow_unused=True)
    return torch.zeros_like(leaf) if g is None else g


def make_diff_regen_renderer(scene, *, device=None, fixed_steps: int = 192,
                             n_lanes: Optional[int] = None, spp: int = 2,
                             majorant_inflation: float = 1.5,
                             accum_spp: bool = False,
                             k_substeps: int = 8, retire_groups: int = 1,
                             stochastic_filter: bool = False,
                             remat_window: Optional[int] = None,
                             work_stride=1, slim: bool = True):
    """Differentiable production path on `device`: gradients through the
    film that the path-regeneration renderer produces (the same program as
    render.make_regen_renderer, with the loop run for exactly `fixed_steps`
    iterations under checkpointing; `remat_window` checkpoints windows of
    that many iterations).

    Returns (loss_fn(density) -> 0-d tensor, grad_fn(density) -> tensor of
    the density's shape); loss = mean film rgb."""
    device = resolve(device)
    loss_core, (H, W) = _regen_loss_builder(
        scene, device=device, fixed_steps=fixed_steps, n_lanes=n_lanes,
        spp=spp, majorant_inflation=majorant_inflation, accum_spp=accum_spp,
        k_substeps=k_substeps, retire_groups=retire_groups,
        stochastic_filter=stochastic_filter, remat_window=remat_window,
        work_stride=work_stride, slim=slim)
    cot = mean_loss_cotangent(H, W, spp, device)

    def loss_fn(density):
        return loss_core(density, cot)

    def grad_fn(density):
        return _grad(loss_core, density, cot)

    return loss_fn, grad_fn


def make_regen_film_vjp(scene, *, device=None, **kw):
    """Pixel-gradient VJP of the production regen film: returns
    vjp_fn(density, image_cot) -> d(sum(image_cot . film)) / d(density)
    for an (H, W, 3) cotangent image (a one-hot pixel cotangent gives that
    pixel's voxel gradients).  Keywords are make_diff_regen_renderer's."""
    device = resolve(device)
    loss_core, (H, W) = _regen_loss_builder(scene, device=device, slim=True,
                                            **kw)

    def vjp_fn(density, image_cot):
        image_cot = torch.as_tensor(image_cot, dtype=torch.float32,
                                    device=device)
        cot = torch.cat([image_cot.reshape(H * W, 3).T,
                         torch.zeros((3, 1), dtype=torch.float32,
                                     device=device)], 1).reshape(-1)
        return _grad(loss_core, density, cot)

    return vjp_fn
