"""Differentiable rendering
(port of acceleratedvolrenderer_tpu/parallel/diff.py: DIFF_PARAMS,
_diff_setup, _make_render_L, make_diff_renderer_multi, make_diff_renderer,
image_and_density_grad, _regen_loss_builder, mean_loss_cotangent,
make_diff_regen_renderer, make_regen_film_vjp, make_sharded_loss and
make_sharded_regen_grad; size_fixed_steps sizes the regen gradients'
loops).

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
reference's gradients do, whatever the scene's `light_sampler`.
`make_sharded_loss` and `make_sharded_regen_grad` run over a
parallel/mesh.py Mesh (one process per rank).  Entry points run on the
CUDA card unless given another `device`.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.integrators import volpath_fused
from ..ops import dda
from ..ops import grid as gridops
from ..utils import spectrum as sp
from ..utils.device import resolve
from .mesh import all_reduce
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

    Returns (loss_core, (H, W)), where loss_core(density, cot_flat,
    work_base=0, local_total=None) = sum(cot . film_render(density)) over
    the local_total (pixel, sample) work items from work_base on (default:
    the whole frame): the film is a pure scatter-add of
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

    def loss_core(density, cot_flat, work_base=0, local_total=None):
        med = dda.MediumArrays(density=density, majorant=majorant_const,
                               w2m=w2m, g=g, density_s=density_s_const)
        lt = total_work if local_total is None else int(local_total)
        n_here = int(min(N, lt))
        regen = dict(
            camera=cam, filter=scene.filter, sampler=scene.sampler,
            spp=spp, H=H, W=W, total_work=lt, seed=scene.seed,
            work_base=work_base, global_total=total_work,
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


def make_sharded_loss(scene, mesh, *, fixed_steps: int = 256, spp: int = 2,
                      majorant_inflation: float = 1.5):
    """Data-parallel form of make_diff_renderer_multi over a
    parallel/mesh.py Mesh: pixels split into one contiguous slice per rank,
    parameters replicated.  loss_fn(params) sums this rank's pixels and
    all-reduces the sum; grad_fn(params) takes this rank's autograd
    gradient of its part of the loss and all-reduces each entry (the
    replicated-model data-parallel step).  PCG streams key on the global
    pixel index, so both equal the single-device ones up to the order of
    the sums."""
    H, W = scene.camera.height, scene.camera.width
    if (H * W) % mesh.size:
        raise ValueError(f"make_sharded_loss: film {W}x{H} must divide "
                         f"evenly over {mesh.size} ranks")
    device = mesh.device
    render_L, _ = _make_render_L(scene, fixed_steps, majorant_inflation,
                                 device)
    per = H * W // mesh.size
    lo = mesh.rank * per
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix = torch.as_tensor(np.stack([xs.reshape(-1), ys.reshape(-1)], -1)
                          [lo:lo + per].astype(np.int32), device=device)
    pixidx = torch.arange(lo, lo + per, dtype=torch.int64, device=device)

    def local_loss(params):
        total = 0.0
        for s in range(spp):
            L, swl = render_L(params, s, pix, pixidx)
            total = total + torch.sum(sp.y_luminance(L, swl))
        return total / (spp * H * W)

    def loss_fn(params):
        with torch.no_grad():
            loss = local_loss(_as_params(params, device)).reshape(1)
        all_reduce(mesh, loss)
        return loss[0]

    def grad_fn(params):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in _as_params(params, device).items()}
        grads = torch.autograd.grad(local_loss(leaves),
                                    list(leaves.values()), allow_unused=True)
        out = {}
        for (k, v), gk in zip(leaves.items(), grads):
            gk = torch.zeros_like(v) if gk is None else gk.contiguous()
            all_reduce(mesh, gk)
            out[k] = gk
        return out

    return loss_fn, grad_fn


def make_sharded_regen_grad(scene, mesh, *, fixed_steps: int,
                            n_lanes: int = 4096, spp: int = 2,
                            microbatches: int = 2,
                            majorant_inflation: float = 1.5,
                            accum_spp: bool = True,
                            k_substeps: int = 8, retire_groups: int = 1,
                            stochastic_filter: bool = False,
                            remat_window: Optional[int] = None,
                            overlap: bool = True, work_stride=1):
    """Gradient of the production regen loss over a parallel/mesh.py Mesh,
    its reduction overlapped with the backward sweeps.

    Each rank renders its contiguous slice of the global work queue (pixels
    with accum_spp), split into `microbatches` regen programs of
    `fixed_steps` iterations each.  With overlap=True, as soon as
    microbatch m's backward gives its density gradient, that gradient is
    reduce-scattered over the mesh (async; waited on before the next
    accumulation, so it runs under microbatch m+1's forward and backward)
    and each rank accumulates only its flat shard of ceil(n_vox / size)
    voxels.  overlap=False sums the microbatches locally and all-reduces
    the full grid once at the end.  `work_stride` is
    make_diff_regen_renderer's work -> pixel permutation.

    Returns loss_and_grad(density) -> (loss, grad): grad is this rank's
    shard (shape (ceil(n_vox / size),)) with overlap, else the full grid.
    loss_and_grad.timings lists, per call, each microbatch's seconds of
    forward and backward ("compute") and the seconds its collective held
    up the work after it ("wait": from before the wait on the collective
    to after its shard is added, or the terminal all-reduce).  On a card
    both are read from CUDA events on the compute stream, so nothing but
    the collective's own handle is waited on inside the loop; on the CPU
    they are host seconds.  The sums do not depend on the world size or
    the microbatch count, up to float order."""
    H, W = scene.camera.height, scene.camera.width
    device = mesh.device
    slices = _sharded_slices(scene, mesh, spp, accum_spp, microbatches)
    loss_core, _ = _regen_loss_builder(
        scene, device=device, fixed_steps=fixed_steps, n_lanes=n_lanes,
        spp=spp, majorant_inflation=majorant_inflation, accum_spp=accum_spp,
        k_substeps=k_substeps, retire_groups=retire_groups,
        stochastic_filter=stochastic_filter, remat_window=remat_window,
        work_stride=work_stride, slim=True)
    cot = mean_loss_cotangent(H, W, spp, device)
    n_vox = int(scene.medium.density.numel())
    shard_len = -(-n_vox // mesh.size)
    pad = mesh.size * shard_len - n_vox
    timings = []

    def loss_and_grad(density):
        density = torch.as_tensor(density, dtype=torch.float32,
                                  device=device)
        loss = torch.zeros((1,), dtype=torch.float32, device=device)
        g_acc = torch.zeros((shard_len,) if overlap else density.shape,
                            dtype=torch.float32, device=device)
        pending = None
        marks = []    # per microbatch: [start, end, (wait marks) or None]
        for base, total in slices:
            t0 = _mark(device)
            leaf = density.detach().clone().requires_grad_(True)
            lm = loss_core(leaf, cot, work_base=base, local_total=total)
            (gm,) = torch.autograd.grad(lm, leaf, allow_unused=True)
            gm = torch.zeros_like(leaf) if gm is None else gm
            loss += lm.detach()
            marks.append([t0, _mark(device), None])
            if not overlap:
                g_acc += gm
                continue
            flat = gm.reshape(-1)
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            if pending is not None:
                marks[-2][2] = _accumulate(pending, g_acc, device)
            pending = _reduce_scatter(mesh, flat, shard_len)
        if pending is not None:
            marks[-1][2] = _accumulate(pending, g_acc, device)
        if not overlap:
            w0 = _mark(device)
            all_reduce(mesh, g_acc)
            marks[-1][2] = (w0, _mark(device))
        all_reduce(mesh, loss)
        timings.append([{"compute": _seconds(a, b),
                         "wait": _seconds(*w) if w else 0.0}
                        for a, b, w in marks])
        return loss[0], g_acc

    loss_and_grad.timings = timings
    return loss_and_grad


def _sharded_slices(scene, mesh, spp, accum_spp, microbatches):
    """(work_base, local_total) of each of this rank's microbatches in
    make_sharded_regen_grad: the rank's contiguous slice of the global
    queue (pixels with accum_spp) cut into `microbatches` equal parts,
    both in (pixel, sample) work items."""
    H, W = scene.camera.height, scene.camera.width
    n_items = H * W if accum_spp else H * W * spp
    if n_items % (mesh.size * microbatches):
        raise ValueError(f"make_sharded_regen_grad: {n_items} work items "
                         f"must divide over {mesh.size} ranks x "
                         f"{microbatches} microbatches")
    per_rank = n_items // mesh.size
    per_mb = per_rank // microbatches
    unit = spp if accum_spp else 1      # work_base is in (pixel, sample)
    return [((mesh.rank * per_rank + m * per_mb) * unit, per_mb * unit)
            for m in range(microbatches)]


def size_fixed_steps(scene, mesh=None, *, device=None, spp: int = 2,
                     microbatches: int = 1, majorant_inflation: float = 1.5,
                     accum_spp: bool = True, **knobs):
    """fixed_steps for make_diff_regen_renderer (mesh None: the whole
    frame) or make_sharded_regen_grad (this rank's microbatches, the most
    over the mesh) with the same scene, spp, microbatches,
    majorant_inflation, accum_spp and regen knobs (n_lanes, k_substeps,
    stochastic_filter, retire_groups, work_stride): the open-loop forward
    of each slice under the gradient's own majorant (majorant_inflation x
    the build-time one, as the gradient freezes it), then int(1.12 x the
    most live iterations) + 16, bench.py's margin.  A gradient loop of
    fewer steps drops the samples still running at its end.  Returns (fixed_steps, the most
    live iterations)."""
    from .render import make_regen_renderer

    device = mesh.device if mesh is not None else resolve(device)
    H, W = scene.camera.height, scene.camera.width
    slices = ([(0, None)] if mesh is None else
              _sharded_slices(scene, mesh, spp, accum_spp, microbatches))
    _, _, majorant, _ = _diff_setup(scene.to(device), majorant_inflation)
    live = 0
    for base, total in slices:
        run, density, _ = make_regen_renderer(
            scene, device=device, spp=spp, accum_spp=accum_spp,
            record_alive=True, work_base=base, local_total=total, **knobs)
        res = run(density, majorant,
                  torch.zeros((3 * (H * W + 1),), dtype=torch.float32,
                              device=device))
        live = max(live, int((res.alive_hist > 0).sum()))
    if mesh is not None and mesh.group is not None:
        t = torch.tensor([live], device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
        live = int(t)
    return int(live * 1.12) + 16, live


def _mark(device):
    """A point in time: a CUDA event recorded on the current stream of a
    card, the host clock on the CPU."""
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _seconds(a, b):
    """Seconds between two _mark points (waits for b's event)."""
    if isinstance(a, float):
        return b - a
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def _reduce_scatter(mesh, flat, shard_len):
    """(handle, shard): the async reduce-scatter of `flat` (size *
    shard_len,) over the mesh into this rank's shard; a world of one
    keeps the whole of it (handle None)."""
    if mesh.group is None:
        return None, flat
    shard = flat.new_empty(shard_len)
    work = dist.reduce_scatter_tensor(shard, flat, group=mesh.group,
                                      async_op=True)
    return work, shard


def _accumulate(pending, g_acc, device):
    """Wait for a pending reduce-scatter (its handle only) and add its
    shard into g_acc; returns the _mark points around the two."""
    t0 = _mark(device)
    work, shard = pending
    if work is not None:
        work.wait()
    g_acc += shard
    return t0, _mark(device)
