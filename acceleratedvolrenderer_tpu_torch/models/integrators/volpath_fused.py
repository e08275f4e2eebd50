"""VolPath in fused, path-regeneration form
(port of acceleratedvolrenderer_tpu/models/integrators/volpath_fused.py::li).

Every lane carries one path through a small program counter (MARCH / NEE /
DONE).  Each loop iteration advances every unfinished lane: a K-voxel march
to the next tentative collision, the masked event block (density tap,
absorb / scatter / null choice, HG bounce, ratio-tracked NEE shadow
segment), and (regen mode) the retire stage, which splats each finished
sample into the film and refills its lane with the next work item, or with
accum_spp banks a finished sample, runs the pixel's next sample in the
same lane and splats the pixel once all its samples are banked.

The march takes one of two routes, chosen as the reference chooses them
(ops/march.py::available, the rule of pallas_march.available): the fused
route, one launch of the march kernel (csrc/march.cu), or the window route
(march.march_window: the walk in eager PyTorch and one gather of the
window's majorants through the kernel of ops/gather.py).  Per-sample
estimates do not depend on the route or on the lane count.

Differentiability (the reference docstring's detached estimator): with the
majorant held fixed, sample positions and event choices do not depend on
the medium parameters, so every pdf denominator, pdf-ratio tracker
(r_u / r_l / r_l_s / r_u_s), event probability and sampled distance is
detached, and only the sigma(x) numerators carry gradient.  The
sampling-side density is `med.density_s` when given (frozen), else the
density detached.  Detaching is an identity in the forward pass, so one
code path serves both.

Ported: homogeneous, scalar-grid and RGB-grid media (`rgb_mode`: per-voxel
RGB coefficients through Smits' RGB -> spectrum at every collision, sigma_t
of the lane spectrum 1), spectral emission (`Le`, the `Le_grid` scale) and
RGB emission (`Le_rgb`), and residual ratio tracking on shadow segments
(`residual_shadow` with `med.minorant`: shadow collisions sample the rate
majorant - minorant and the control part exp(-sigma_t * minorant depth)
applies in closed form).  Regen mode retires per sample, or per pixel with
accum_spp; wave mode (`regen=None`) traces the given camera rays once, has
no retire stage, and returns the per-lane radiance `L`.  Wave mode takes
the reference's optional medium fields: the `Le_grid` emission scale,
frozen sampling-side spectra `sigma_a_s` / `sigma_s_s` and a frozen
sampling-side `g_s`.

Surfaces (`prims`, the primitives of models/shapes.py with a material) bound
each main segment: init_segment intersects them and cuts the segment's t_max
at the closest hit, so the march kernel walks only up to the surface.  A
segment that ends there without a medium event shades the surface as the
reference does: one-sided emission (path-sampled, weight 1 / mean(r_u)),
NEE (occluded by the opaque primitives) with the Lambertian,
diffuse-transmission or rough microfacet lobe, and a cosine, VNDF or
diffuse-transmission bounce; smooth conductors, dielectrics and thin
dielectrics bounce at once on their delta lobes; Russian roulette past
depth 1.  Other material kinds take the Lambertian albedo lobe, with a
warning, as in the reference.  Scenes without opaque primitives run exactly
the medium-only program: the surface registers are (1,) placeholders.

The loop runs on the host: `n_steps` is a python int, so the retire group,
the event group and the retire tick (`retire_every`) are plain slices and
`if`s.  Without `fixed_steps` (or with `record_alive`, which like the
reference runs the open loop and ignores `fixed_steps`), termination is
checked every `CHECK_EVERY` iterations (iterations after completion are
exact no-ops: every lane is DONE, no work is left, and masked draws do not
advance streams).  With `fixed_steps=n` the loop runs exactly n iterations
with no readback, the film (or the loss-cotangent scalar) is updated out
of place, and every iteration runs under torch.utils.checkpoint, so a
backward pass through the loop keeps one carry per iteration;
`remat_window=w` checkpoints windows of w iterations instead (ceil(n / w)
* w iterations run), keeping one carry per window plus one window's saved
tensors.  Either way the backward sweep runs each iteration's forward once
more.

Lane tensors are rebuilt with torch.where each stage, as the reference
does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ...ops import grid as gridops
from ...ops import march
from ...ops import phase as phase_ops
from ...ops import warps
from ...ops.dda import (MediumArrays, dda_init, pcg_uniform,
                        pcg_uniform_masked, world_to_medium)
from ...utils import colorspace as cspace
from ...utils import spectrum as spu
from ...utils import vecmath as vmu
from ...utils.math import ONE_MINUS_EPSILON
from .. import lights as lights_mod
from .. import samplers
from .. import shapes as shapes_mod

PC_MARCH = 0
PC_NEE = 1
PC_DONE = 2

CHECK_EVERY = 16

_SURF_EPS = 1e-4


class LiResult(NamedTuple):
    film_rgb: Optional[torch.Tensor]        # regen: (3 * (H*W + 1),) film
    iterations: int                         # loop iterations run
    alive_hist: Optional[torch.Tensor] = None   # (iterations,) alive lanes
    L: Optional[torch.Tensor] = None        # wave mode: (N, L) radiance
    ev_counts: Optional[torch.Tensor] = None    # (2,) [main, shadow]
    #   collisions, with count_events


@dataclasses.dataclass
class _Regs:
    pc: torch.Tensor          # (N,) program counter
    depth: torch.Tensor       # (N,) real-scatter count
    rng: torch.Tensor         # (N,) PCG state (uint32 in int64)
    lam: torch.Tensor         # (N, L) sampled wavelengths
    lam_pdf: torch.Tensor
    s_t: torch.Tensor         # (N, L) sigma_t at unit density (1: RGB)
    s_a: torch.Tensor
    s_s: torch.Tensor
    s_le: torch.Tensor
    so: torch.Tensor          # (N, 3) segment origin (main path or shadow)
    sd: torch.Tensor          # (N, 3) segment direction
    d_main: torch.Tensor      # (N, 3) path direction
    # surface registers ((1,) placeholders in a scene without surfaces)
    t_surf: torch.Tensor      # (N,) surface hit bounding the main segment
    n_surf: torch.Tensor      # (N, 3) its normal
    mat_id: torch.Tensor      # (N,) its index in the opaque list (-1: none)
    at_surface: torch.Tensor  # (N,) the NEE / resume vertex is a surface
    spec_last: torch.Tensor   # (N,) the last bounce was a delta lobe
    voxel: torch.Tensor       # DDA registers of the active segment
    next_t: torch.Tensor
    dt: torch.Tensor
    step: torch.Tensor
    t_exit: torch.Tensor
    t_cur: torch.Tensor
    dl_target: torch.Tensor
    dl_since: torch.Tensor
    reached: torch.Tensor
    seg_escaped: torch.Tensor
    maxd: torch.Tensor        # majorant of the current voxel
    ctrld: torch.Tensor       # residual mode: minorant of the event voxel,
    ctrl_since: torch.Tensor  # control depth since the last event ((1,) off)
    L: torch.Tensor           # (N, L) spectral state
    beta: torch.Tensor
    r_u: torch.Tensor
    r_l: torch.Tensor
    T_ray: torch.Tensor       # NEE context, valid while pc == NEE
    r_l_s: torch.Tensor
    r_u_s: torch.Tensor
    ls_L: torch.Tensor
    ls_pdf: torch.Tensor
    f_spec: torch.Tensor
    spdf_d: torch.Tensor
    is_delta: torch.Tensor
    ev_counts: torch.Tensor   # (2,) [main, shadow] collisions (count_events)
    work: torch.Tensor        # (N,) current work item, -1 = none
    cursor: torch.Tensor      # 0-d next unissued work item
    samp: torch.Tensor        # accum_spp: (N,) current sample of the pixel
    rgb_acc: torch.Tensor     # accum_spp: (N, 3) banked rgb of the pixel


def _take(table, mid):
    """table[mid[i], i] for an (M, N, ...) per-primitive table."""
    return table[mid, torch.arange(mid.shape[0], device=mid.device)]


class _SurfaceTables:
    """The opaque primitives' material tables of the surface branch
    (reference li l. 220-345): per-primitive masks and constants, and the
    spectral tables (M, N, L), evaluated once in wave mode (`const`) or
    at every call on the lanes' current wavelengths in regen mode."""

    def __init__(self, prims, lam, lanes, const: bool):
        from .. import materials as mm

        self.opaque = tuple(p for p in prims if p.material is not None)
        self.has_surf = len(self.opaque) > 0
        self.has_spec = self.has_rough = self.has_dt = False
        self.lanes = lanes
        if not self.has_surf:
            return
        mats = [p.material for p in self.opaque]
        dev = lam.device

        def rough_of(m):
            # a texture roughness counts as 0.3, as in the reference
            r = getattr(m, "roughness", 0.0)
            return float(r) if isinstance(r, (int, float)) else 0.3

        k_cond, k_diel, k_thin = (mm.KIND_CONDUCTOR, mm.KIND_DIELECTRIC,
                                  mm.KIND_THIN_DIELECTRIC)
        spec = [m.kind in (k_cond, k_diel, k_thin) and rough_of(m) == 0.0
                for m in mats]
        rough = [m.kind in (k_cond, k_diel) and rough_of(m) > 0.0
                 for m in mats]
        self.cond = [m.kind == k_cond and (s or r)
                     for s, r, m in zip(spec, rough, mats)]
        self.dt = [m.kind == mm.KIND_DIFFUSE_TRANSMISSION for m in mats]
        self.has_spec, self.has_rough = any(spec), any(rough)
        self.has_dt = any(self.dt)
        mask = lambda v: torch.tensor(v, dtype=torch.bool, device=dev)
        self.emissive_mask = mask([m.emissive for m in mats])
        self.spec_mask, self.rough_mask = mask(spec), mask(rough)
        self.cond_mask = mask(self.cond)
        self.thin_mask = mask([s and m.kind == k_thin
                               for s, m in zip(spec, mats)])
        self.dt_mask = mask(self.dt)
        self.alpha = torch.tensor([rough_of(m) for m in mats],
                                  dtype=torch.float32, device=dev)
        self.diel_eta = torch.tensor(
            [float(getattr(m, "eta", 1.5)) if m.kind in (k_diel, k_thin)
             and isinstance(getattr(m, "eta", 1.5), (int, float)) else 1.5
             for m in mats], dtype=torch.float32, device=dev)
        # kinds outside the lobe set take a Lambertian albedo lobe here, as
        # in the reference: warn rather than render them wrong quietly
        supported = (mm.KIND_DIFFUSE, k_cond, k_diel, k_thin,
                     mm.KIND_DIFFUSE_TRANSMISSION)
        unsupported = sorted({type(m).__name__ for m in mats
                              if m.kind not in supported})
        if unsupported:
            import warnings

            warnings.warn(
                "fused volpath: material kind(s) "
                f"{', '.join(unsupported)} approximate to a Lambert albedo "
                "lobe in medium-bearing scenes", stacklevel=3)
        self._const = None
        if const:
            self._const = self.spectra(lam)

    def spectra(self, lam):
        """(albedos, emissions, conductor eta, conductor k, DT
        transmittance) as (M, N, L) tables at wavelengths lam (wave mode:
        the tables made once at the given lam); the last three are None
        where no primitive needs them."""
        if self._const is not None:
            return self._const
        from .. import materials as mm

        nw = lam.shape[0]
        shape = (nw, self.lanes)
        zeros = torch.zeros(shape, dtype=torch.float32, device=lam.device)
        ones = torch.ones(shape, dtype=torch.float32, device=lam.device)
        mats = [p.material for p in self.opaque]
        albedos = torch.stack([mm._eval_spectral(
            getattr(m, "reflectance", 0.5), lam) for m in mats])
        emissions = torch.stack([
            (m.emission(lam) * m.emission_scale if m.emissive else zeros)
            * ones for m in mats])
        eta_c = k_c = trans = None
        if self.has_spec or self.has_rough:
            eta_c = torch.stack([m.eta_spectrum(lam) * ones if c else ones
                                 for c, m in zip(self.cond, mats)])
            k_c = torch.stack([m.k_spectrum(lam) * ones if c else zeros
                               for c, m in zip(self.cond, mats)])
        if self.has_dt:
            trans = torch.stack([
                mm._eval_spectral(getattr(m, "transmittance", None), lam)
                * ones if d else zeros for d, m in zip(self.dt, mats)])
        return albedos, emissions, eta_c, k_c, trans


def _fields(c: _Regs) -> tuple:
    """The carry's tensors in field order (_Regs(*t) rebuilds it)."""
    return tuple(getattr(c, f.name) for f in dataclasses.fields(c))


def li(
    med: MediumArrays,
    lights: list,
    o, d,
    lam,
    rng,
    *,
    maj_res,
    homogeneous: bool,
    max_depth: int = 5,
    max_march_steps: int = 100000,
    k_substeps: int = 8,
    fixed_steps=None,
    remat_window=None,
    rgb_mode: bool = False,
    prims: tuple = (),
    record_alive: bool = False,
    regen=None,
    stochastic_filter: bool = False,
    retire_every: int = 1,
    retire_groups: int = 1,
    sub_rounds: int = 1,
    accum_spp: bool = False,
    event_groups: int = 1,
    light_strategy: str = "uniform",
    count_events: bool = False,
    residual_shadow: bool = False,
) -> LiResult:
    """Wave mode (`regen=None`): trace the rays o / d with wavelengths lam
    and PCG streams rng through `med` (whose sigma_a / sigma_s / Le hold
    the per-ray spectra) and return their radiance `L`.  Regen mode: render
    the workload described by `regen` (see
    parallel/render.py::make_regen_renderer); o / d / lam / rng only give
    the lane count, wavelength count and device.  `regen["loss_cotangent"]`,
    a flat (3 * (H*W + 1),) cotangent, makes the retire stage accumulate
    sum(cot . film) into the (1,) `regen["film_rgb"]` instead of the film
    (parallel/diff.py); `regen["max_component"]` clamps each retired rgb.
    `regen["work_base"]` (default 0) offsets the queue's work ids into a
    global queue of `regen["global_total"]` (pixel, sample) items (default
    total_work), whose items past the end are discarded: one shard of a
    sharded render (parallel/mesh.py)."""
    has_samp_sigma = med.sigma_a_s is not None
    if has_samp_sigma and (rgb_mode or regen is not None
                           or event_groups > 1):
        raise ValueError(
            "volpath_fused.li: sampling-side sigma overrides serve only the "
            "plain spectral wave path; the reference refuses them too")
    if regen is not None and accum_spp and retire_every != 1:
        raise ValueError("volpath_fused.li: accum_spp requires retire_every "
                         "== 1, as in the reference")

    N = o.shape[0]
    LANES = lam.shape[-1]
    dev = o.device
    f32 = torch.float32
    i64 = torch.int64
    surf = _SurfaceTables(prims, lam, LANES, regen is None)
    has_surf = surf.has_surf
    has_spec, has_rough, has_dt = surf.has_spec, surf.has_rough, surf.has_dt
    opaque = surf.opaque
    g = med.g
    g_samp = (g if med.g_s is None else med.g_s).detach()
    rz, ry, rx = med.majorant.shape
    maj_flat = med.majorant.reshape(-1).contiguous()
    dens_flat = med.density.reshape(-1)
    dens_s_flat = (med.density_s.reshape(-1) if med.density_s is not None
                   else None)
    dens_dims = tuple(int(x) for x in med.density.shape)
    route = (march.march_block if march.available(maj_flat.numel(), N)
             else march.march_window)
    # residual ratio tracking on shadow segments: scalar grids only
    residual_on = bool(residual_shadow and not homogeneous and not rgb_mode
                       and med.minorant is not None)
    ctrl_flat = (med.minorant.reshape(-1).contiguous().detach()
                 if residual_on else None)

    le_grid_flat = (med.Le_grid.reshape(-1) if med.Le_grid is not None
                    else None)
    le_grid_dims = (tuple(int(x) for x in med.Le_grid.shape)
                    if le_grid_flat is not None else None)

    if regen is not None:
        R_H, R_W, R_spp = regen["H"], regen["W"], regen["spp"]
        R_HW = R_H * R_W
        R_total = int(regen["total_work"])
        R_cam, R_filt = regen["camera"], regen["filter"]
        R_kind, R_seed = regen["sampler"], regen["seed"]
        R_stride = int(regen.get("work_stride", 1))
        R_cot = regen.get("loss_cotangent", None)
        R_maxc = float(regen.get("max_component", math.inf))
        # sharded operation: this queue's work ids start at work_base in
        # the global queue of global_total (pixel, sample) items; items
        # past the global end splat to the discard slot
        R_base = int(regen.get("work_base", 0))
        R_gtotal = int(regen.get("global_total", R_total))
        if accum_spp:
            assert R_total % R_spp == 0, "accum_spp: total_work % spp != 0"
            assert R_base % R_spp == 0, "accum_spp: work_base % spp != 0"
            R_items = R_total // R_spp   # a work item is one PIXEL
            R_gitems, R_ibase = R_gtotal // R_spp, R_base // R_spp
        else:
            R_items = R_total            # a work item is one (pixel, sample)
            R_gitems, R_ibase = R_gtotal, R_base

        def work_pixel(gw):
            p_raw = gw % R_HW
            if R_stride == 1:
                return p_raw
            return (p_raw * R_stride) % R_HW

        def spawn(work, samp):
            """Camera ray, wavelengths and PCG stream for (pixel, sample):
            the sample is `samp` with accum_spp, else work // (H*W), of the
            global work id."""
            gw = work + R_ibase
            p_idx = work_pixel(gw)
            s_idx = samp if accum_spp else gw // R_HW
            pixxy = torch.stack([p_idx % R_W, p_idx // R_W],
                                -1).to(torch.int32)
            ua, ub, rng_s = samplers.film_sample(R_kind, p_idx, s_idx,
                                                 R_spp, seed=R_seed,
                                                 pix=pixxy)
            off = R_filt.sample_offset(torch.stack([ua, ub], -1)) + 0.5
            rng_s, ul = pcg_uniform(rng_s)
            swl = spu.sample_wavelengths_visible(ul)
            o_s, d_s = R_cam.generate_rays(pixxy, off)
            return o_s, d_s, swl.lam, swl.pdf, rng_s

        def spectra_for(lam_cur):
            s_a = regen["sigma_a_fn"](lam_cur)
            s_s = regen["sigma_s_fn"](lam_cur)
            s_le = regen["Le_fn"](lam_cur)
            # an RGB medium's majorant holds sigma_t: its lane spectrum is 1
            s_t = torch.ones_like(s_a) if rgb_mode else s_a + s_s
            return s_t, s_a, s_s, s_le

    if has_samp_sigma:
        # frozen sampling-side spectra: sample paths stay independent of
        # the evaluation-side sigma_a / sigma_s (the FD == AD contract)
        _sa_smp = torch.broadcast_to(med.sigma_a_s.detach(), (N, LANES))
        _ss_smp = torch.broadcast_to(med.sigma_s_s.detach(), (N, LANES))
        _st_smp = _sa_smp + _ss_smp

        def samp_sigma(c: _Regs):
            return _sa_smp, _ss_smp, _st_smp
    else:
        def samp_sigma(c: _Regs):
            """Sampling-side spectra: the live ones, detached."""
            return c.s_a.detach(), c.s_s.detach(), c.s_t.detach()

    def init_segment(so, sd, t_max, rng, need, old, need_main=None):
        """(Re)initialize the DDA registers of lanes in `need` and draw
        their first optical-depth target.  Lanes in `need_main` also
        intersect the opaque primitives, which bound the segment (t_surf)."""
        surf_regs = {}
        if has_surf and need_main is not None:
            hit = shapes_mod.intersect_all(opaque, so, sd, torch.inf)
            surf_regs = dict(
                t_surf=torch.where(need_main, hit.t, old.t_surf),
                n_surf=torch.where(need_main[:, None], hit.n, old.n_surf),
                mat_id=torch.where(need_main, hit.prim_id, old.mat_id))
            t_max = torch.where(need_main,
                                torch.minimum(t_max, surf_regs["t_surf"]),
                                t_max)
        dda, t0 = dda_init(so, sd, t_max, med.w2m, maj_res)
        rng, u0 = pcg_uniform_masked(rng, need & dda.in_medium)
        u0 = torch.clamp(u0, max=ONE_MINUS_EPSILON)
        st0 = samp_sigma(old)[2][:, 0]   # sampling stays detached
        dl0 = torch.where(st0 > 0, -torch.log1p(-u0)
                          / torch.clamp(st0, min=1e-30), torch.inf)
        sel = need
        sel3 = need[:, None]
        ctrl = {}
        if residual_on:
            ctrl = dict(ctrld=torch.where(sel, 0.0, old.ctrld),
                        ctrl_since=torch.where(sel, 0.0, old.ctrl_since))
        return dataclasses.replace(
            old,
            so=torch.where(sel3, so, old.so),
            sd=torch.where(sel3, sd, old.sd),
            voxel=torch.where(sel3, dda.voxel, old.voxel),
            next_t=torch.where(sel3, dda.next_t, old.next_t),
            dt=torch.where(sel3, dda.dt, old.dt),
            step=torch.where(sel3, dda.step, old.step),
            t_exit=torch.where(sel, dda.t_exit, old.t_exit),
            t_cur=torch.where(sel, t0, old.t_cur),
            dl_target=torch.where(sel, dl0, old.dl_target),
            dl_since=torch.where(sel, 0.0, old.dl_since),
            reached=torch.where(sel, False, old.reached),
            # a segment that misses the medium is immediately "escaped"
            seg_escaped=torch.where(sel, ~dda.in_medium, old.seg_escaped),
            rng=rng, **ctrl, **surf_regs,
        )

    zeros_i = torch.zeros((N,), dtype=i64, device=dev)
    zero_s = torch.zeros((N, LANES), dtype=f32, device=dev)
    one_s = torch.ones((N, LANES), dtype=f32, device=dev)
    zero_n = torch.zeros((N,), dtype=f32, device=dev)
    false_n = torch.zeros((N,), dtype=torch.bool, device=dev)
    if regen is not None:
        # ---- initial work items: the first N work items ----
        work0 = torch.arange(N, dtype=i64, device=dev)
        need0 = work0 < R_items
        o, d, lam, lam_pdf0, rng = spawn(
            torch.clamp(work0, max=R_items - 1), zeros_i)
        s_t0, s_a0, s_s0, s_le0 = spectra_for(lam)
        work_init = torch.where(need0, work0, -1)
        cursor_init = torch.tensor(min(N, R_items), dtype=i64, device=dev)
        ch_off = torch.arange(3, dtype=i64, device=dev) * (R_HW + 1)
    else:
        # ---- wave mode: every lane starts its given camera ray ----
        need0 = torch.ones((N,), dtype=torch.bool, device=dev)
        lam_pdf0 = one_s
        shape = (N, LANES)
        s_a0 = torch.broadcast_to(med.sigma_a, shape)
        s_s0 = torch.broadcast_to(med.sigma_s, shape)
        s_t0 = (one_s if rgb_mode
                else torch.broadcast_to(med.sigma_a + med.sigma_s, shape))
        s_le0 = torch.broadcast_to(med.Le, shape)
        work_init = torch.zeros((1,), dtype=i64, device=dev)
        cursor_init = torch.zeros((), dtype=i64, device=dev)
    accum = regen is not None and accum_spp
    # registers a mode does not use are (1,) placeholders
    n_res = N if residual_on else 1
    n_srf = N if has_surf else 1
    regs = _Regs(
        pc=torch.where(need0, PC_MARCH, PC_DONE),
        depth=zeros_i, rng=rng, lam=lam, lam_pdf=lam_pdf0,
        s_t=s_t0, s_a=s_a0, s_s=s_s0, s_le=s_le0,
        so=o, sd=d, d_main=d,
        t_surf=torch.full((n_srf,), torch.inf, dtype=f32, device=dev),
        n_surf=torch.zeros((n_srf, 3), dtype=f32, device=dev),
        mat_id=torch.full((n_srf,), -1, dtype=i64, device=dev),
        at_surface=torch.zeros((n_srf,), dtype=torch.bool, device=dev),
        spec_last=torch.zeros((n_srf,), dtype=torch.bool, device=dev),
        voxel=torch.zeros((N, 3), dtype=torch.int32, device=dev),
        next_t=torch.zeros((N, 3), dtype=f32, device=dev),
        dt=torch.zeros((N, 3), dtype=f32, device=dev),
        step=torch.zeros((N, 3), dtype=torch.int32, device=dev),
        t_exit=zero_n, t_cur=zero_n, dl_target=zero_n, dl_since=zero_n,
        reached=false_n, seg_escaped=false_n, maxd=zero_n,
        ctrld=torch.zeros((n_res,), dtype=f32, device=dev),
        ctrl_since=torch.zeros((n_res,), dtype=f32, device=dev),
        L=zero_s, beta=one_s, r_u=one_s, r_l=one_s,
        T_ray=one_s, r_l_s=one_s, r_u_s=one_s,
        ls_L=zero_s, ls_pdf=zero_n, f_spec=zero_s, spdf_d=zero_n,
        is_delta=false_n,
        ev_counts=torch.zeros((2,), dtype=i64, device=dev),
        work=work_init, cursor=cursor_init,
        samp=zeros_i if accum else torch.zeros((1,), dtype=i64, device=dev),
        rgb_acc=torch.zeros((N if accum else 1, 3), dtype=f32, device=dev),
    )
    inf_n = torch.full((N,), torch.inf, dtype=f32, device=dev)
    regs = init_segment(o, d, inf_n, rng, need0, regs, need_main=need0)

    def block_substep(c: _Regs, K: int) -> _Regs:
        """K-voxel march of every hunting lane, by the route chosen above.
        Its outputs are sampling-side quantities: detached."""
        hunting = (c.pc != PC_DONE) & ~c.reached & ~c.seg_escaped
        ctrl_kw = {}
        if residual_on:
            ctrl_kw = dict(control=ctrl_flat, resid=c.pc == PC_NEE,
                           ctrld_in=c.ctrld, csince_in=c.ctrl_since)
        r = route(
            maj_flat, c.voxel, c.next_t, c.dt, c.step, c.t_exit, c.t_cur,
            c.dl_target, c.dl_since, c.maxd, hunting, K, (rx, ry, rz),
            **ctrl_kw)
        r = {k: v.detach() for k, v in r.items()}
        return dataclasses.replace(
            c, voxel=r["voxel"], next_t=r["next_t"], t_cur=r["t_cur"],
            dl_target=r["dl_target"], dl_since=r["dl_since"], maxd=r["maxd"],
            ctrld=r.get("ctrld", c.ctrld),
            ctrl_since=r.get("ctrl_since", c.ctrl_since),
            reached=c.reached | r["landed"],
            seg_escaped=c.seg_escaped | r["escaped"])

    def handle_events(c: _Regs) -> _Regs:
        """Collision classification and segment-end transitions, over the
        lanes of `c` (all N, or one event group's slice)."""
        n = c.pc.shape[0]
        col_any = c.reached & (c.pc != PC_DONE)
        rng = c.rng
        u3f = None
        if stochastic_filter and not homogeneous:
            # one corner draw per collision: E[1-tap] == trilerp
            rng, uf1 = pcg_uniform_masked(rng, col_any)
            rng, uf2 = pcg_uniform_masked(rng, col_any)
            rng, uf3 = pcg_uniform_masked(rng, col_any)
            u3f = torch.stack([uf1, uf2, uf3], -1)
        if not homogeneous:
            p_m = world_to_medium(med.w2m, c.so + c.t_cur[:, None] * c.sd)
        if u3f is not None:
            tap = lambda grid, dims=dens_dims: (
                gridops.trilerp_stochastic_flat(grid, dims, p_m, u3f))
            tap_vec = lambda grid: gridops.trilerp_vec_stochastic(grid, p_m,
                                                                  u3f)
        else:
            tap = lambda grid, dims=dens_dims: gridops.trilerp_flat(
                grid, dims, p_m)
            tap_vec = lambda grid: gridops.trilerp_vec(grid, p_m)
        maxd = c.maxd
        if rgb_mode:
            # RGB medium: the collision's coefficients from the RGB grids
            sa = spu.rgb_to_spectrum_smits_batched(tap_vec(med.sigma_a_rgb),
                                                   c.lam)
            ss = spu.rgb_to_spectrum_smits_batched(tap_vec(med.sigma_s_rgb),
                                                   c.lam)
        else:
            # unit density throughout a homogeneous medium
            dens = (torch.ones((n,), dtype=f32, device=dev) if homogeneous
                    else tap(dens_flat))
            sa = c.s_a * dens[:, None]             # evaluation side (diff)
            ss = c.s_s * dens[:, None]
        sig_maj = c.s_t * maxd[:, None]
        T_maj = torch.exp(-c.s_t * c.dl_since[:, None])
        sig_n = torch.clamp(sig_maj - sa - ss, min=0.0)
        # decision / pdf side: the same values detached (no launch), or
        # recomputed from the frozen density when one is given
        sa_smp, ss_smp, st_smp = samp_sigma(c)
        if has_samp_sigma:
            sig_maj_d = st_smp * maxd[:, None]
            T_maj_d = torch.exp(-st_smp * c.dl_since[:, None])
        else:
            sig_maj_d, T_maj_d = sig_maj.detach(), T_maj.detach()
        if rgb_mode or (dens_s_flat is None and not has_samp_sigma):
            sa_d, ss_d, sig_n_d = sa.detach(), ss.detach(), sig_n.detach()
        else:
            dens_d = (dens.detach() if homogeneous or dens_s_flat is None
                      else tap(dens_s_flat))
            sa_d = sa_smp * dens_d[:, None]
            ss_d = ss_smp * dens_d[:, None]
            sig_n_d = torch.clamp(sig_maj_d - sa_d - ss_d, min=0.0)
        sig_maj0 = sig_maj_d[:, 0]
        if residual_on:
            # shadow lanes: the collision rate (and its pdf) shrink to
            # majorant - minorant while the null weight keeps the full
            # majorant - density; the control part is exp(-sigma_t * ctrl
            # depth).  ctrld / ctrl_since are 0 on main-path lanes.
            sig_majr_d = (st_smp * (maxd - c.ctrld)[:, None]).detach()
            sig_majr0 = sig_majr_d[:, 0]
            ctrlT = torch.exp(-c.s_t * c.ctrl_since[:, None])
            ctrlT_d = torch.exp(-st_smp * c.ctrl_since[:, None]).detach()
        else:
            sig_majr_d, sig_majr0 = sig_maj_d, sig_maj0

        # ---- main-path collisions (pc == MARCH) ----
        col_m = col_any & (c.pc == PC_MARCH)
        pos = sig_maj0 > 0
        maj0_c = torch.clamp(sig_maj0, min=1e-30)
        p_absorb = torch.where(pos, sa_d[:, 0] / maj0_c, 0.0)
        p_scatter = torch.where(pos, ss_d[:, 0] / maj0_c, 0.0)
        rng, u_ev = pcg_uniform_masked(rng, col_m)
        is_absorb = col_m & (u_ev < p_absorb)
        is_scatter = col_m & ~is_absorb & (u_ev < p_absorb + p_scatter)
        is_null = col_m & ~is_absorb & ~is_scatter

        # emission at every main collision while depth < max_depth (pdf and
        # ratio trackers detached: sampling-side quantities)
        pdf_e = (sig_maj0 * T_maj_d[:, 0]).detach()
        pdf_e_c = torch.clamp(pdf_e, min=1e-30)[:, None]
        betap = c.beta * T_maj / pdf_e_c
        r_e = (c.r_u * sig_maj_d * T_maj_d).detach() / pdf_e_c
        r_e_avg = torch.mean(r_e, dim=-1).detach()
        if rgb_mode and med.Le_rgb is not None:
            Le_here = spu.rgb_to_spectrum_smits_batched(tap_vec(med.Le_rgb),
                                                        c.lam)
        elif le_grid_flat is not None and not homogeneous:
            # per-voxel emission scale (GridMedium's LeScale grid analogue)
            Le_here = c.s_le * tap(le_grid_flat, le_grid_dims)[:, None]
        else:
            Le_here = c.s_le
        contrib_e = (betap * sa * Le_here
                     / torch.clamp(r_e_avg, min=1e-30)[:, None])
        emit_ok = col_m & (pdf_e > 0) & (r_e_avg > 0) & (c.depth < max_depth)
        L_acc = c.L + torch.where(emit_ok[:, None], contrib_e, 0.0)

        # null / scatter weights: pdf denominators and ratio trackers on
        # the sampling side; only beta's sigma numerators carry gradient
        pdf_null = (T_maj_d[:, 0] * sig_n_d[:, 0]).detach()
        null_ok = (pdf_null > 0)[:, None]
        pdf_null_c = torch.clamp(pdf_null, min=1e-30)[:, None]
        f_null = torch.where(null_ok, T_maj * sig_n / pdf_null_c, 0.0)
        f_null_d = torch.where(null_ok, T_maj_d * sig_n_d / pdf_null_c,
                               0.0).detach()
        f_null_l = torch.where(null_ok, T_maj_d * sig_maj_d / pdf_null_c,
                               0.0).detach()
        pdf_sc = (T_maj_d[:, 0] * ss_d[:, 0]).detach()
        sc_ok = (pdf_sc > 0)[:, None]
        pdf_sc_c = torch.clamp(pdf_sc, min=1e-30)[:, None]
        f_sc = torch.where(sc_ok, T_maj * ss / pdf_sc_c, 0.0)
        f_sc_d = torch.where(sc_ok, T_maj_d * ss_d / pdf_sc_c, 0.0).detach()

        nul3, sca3 = is_null[:, None], is_scatter[:, None]
        beta = torch.where(nul3, c.beta * f_null,
                           torch.where(sca3, c.beta * f_sc, c.beta))
        r_u = torch.where(nul3, c.r_u * f_null_d,
                          torch.where(sca3, c.r_u * f_sc_d, c.r_u)).detach()
        r_l = torch.where(nul3, c.r_l * f_null_l, c.r_l).detach()
        dead_null = is_null & ~(r_u != 0.0).any(dim=-1)

        # a scatter at the depth cap terminates
        over = is_scatter & (c.depth >= max_depth)
        do_scatter = is_scatter & ~over
        depth = c.depth + do_scatter.to(c.depth.dtype)

        # ---- main-path segment end (pc == MARCH): the sky or a surface ----
        esc_m = c.seg_escaped & (c.pc == PC_MARCH)
        # residual T_maj / T_maj[0]: evaluation numerator over the
        # sampling-side pdf; the trackers take the all-sampling-side form
        T_res = torch.exp(-c.s_t * c.dl_since[:, None])
        T_res_d = T_maj_d if has_samp_sigma else T_res.detach()
        T0_c = torch.clamp(T_res_d[:, 0:1], min=1e-30)
        f_res = T_res / T0_c
        f_res_d = T_res_d / T0_c if has_samp_sigma else f_res.detach()
        esc3 = esc_m[:, None]
        beta = torch.where(esc3, beta * f_res, beta)
        r_u = torch.where(esc3, r_u * f_res_d, r_u).detach()
        r_l = torch.where(esc3, r_l * f_res_d, r_l).detach()
        if has_surf:
            hit_surf = esc_m & torch.isfinite(c.t_surf)
            to_sky = esc_m & ~torch.isfinite(c.t_surf)
        else:
            to_sky = esc_m

        # the sky: infinite lights with MIS; after a delta bounce (or at
        # depth 0) no light-sampling pdf competes, full weight
        Le_inf, pdf_inf = lights_mod.escaped_radiance(lights, c.d_main, c.lam)
        first = (c.depth == 0) | c.spec_last if has_surf else c.depth == 0
        denom_first = torch.mean(r_u, dim=-1)
        denom_mis = torch.mean(r_u + r_l * pdf_inf[:, None], dim=-1)
        denom = torch.where(first, denom_first, denom_mis).detach()
        contrib_inf = beta * Le_inf / torch.clamp(denom, min=1e-30)[:, None]
        L_acc = L_acc + torch.where((to_sky & (denom > 0))[:, None],
                                    contrib_inf, 0.0)

        false = torch.zeros((n,), dtype=torch.bool, device=dev)
        hit_emit = over_s = do_surf = do_spec = do_rough = false
        if has_surf:
            # ---- surface shading set-up ----
            albedos, emissions, eta_cs, k_cs, trans_s = surf.spectra(c.lam)
            p_hit = c.so + c.t_surf[:, None] * c.sd
            wo_s = -c.d_main
            mid = torch.clamp(c.mat_id, 0, len(opaque) - 1)
            albedo = _take(albedos, mid)
            Le_mat = _take(emissions, mid)
            if has_dt:
                trans_hit = _take(trans_s, mid)
                dt_l = surf.dt_mask[mid]
            is_emissive = surf.emissive_mask[mid]
            n_f = vmu.face_forward(c.n_surf, wo_s)
            front = vmu.dot(c.n_surf, wo_s) > 0
            # emitters are found by path sampling only: weight
            # 1 / mean(r_u); one-sided emission
            hit_emit = hit_surf & is_emissive & front
            contrib_le = (beta * Le_mat
                          / torch.clamp(denom_first, min=1e-30)[:, None])
            L_acc = L_acc + torch.where(hit_emit[:, None], contrib_le, 0.0)
            # diffuse-like: NEE + cosine bounce; rough microfacet: NEE (MIS
            # with the VNDF lobe) + VNDF bounce; smooth specular: an
            # immediate mirror / refraction bounce, no NEE
            hit_diff = hit_surf & ~is_emissive
            hit_spec = hit_rough = false
            if has_spec or has_rough:
                spec_hit = surf.spec_mask[mid]
                rough_hit = surf.rough_mask[mid]
                hit_spec = hit_diff & spec_hit
                hit_rough = hit_diff & rough_hit
                hit_diff = hit_diff & ~spec_hit & ~rough_hit
            over_s = (hit_diff | hit_spec | hit_rough) & (c.depth >= max_depth)
            do_surf = hit_diff & ~over_s
            do_spec = hit_spec & ~over_s
            do_rough = hit_rough & ~over_s
            depth = depth + (do_surf | do_spec | do_rough).to(depth.dtype)
            # the local frame on the true geometric normal: the non-diffuse
            # lobes are two-sided, and a dielectric's eta side is a property
            # of the surface, not of the side the ray came from
            if has_spec or has_rough or has_dt:
                from .. import bxdfs as bxdfs_mod

                sbx, sby, sbz = vmu.frame_from_z(c.n_surf)
                wo_sl = vmu.to_local(sbx, sby, sbz, wo_s)
            if has_spec or has_rough:
                eta_c_hit = _take(eta_cs, mid)
                k_c_hit = _take(k_cs, mid)
                alpha_hit = surf.alpha[mid]
                eta_m = surf.diel_eta[mid]
                is_cond_l = surf.cond_mask[mid]

        # ---- NEE set-up: a volume scatter or a surface vertex ----
        p_scat = c.so + c.t_cur[:, None] * c.sd
        wo = -c.d_main
        want_nee = do_scatter | do_surf | do_rough
        rng, u1 = pcg_uniform_masked(rng, want_nee)
        rng, u2a = pcg_uniform_masked(rng, want_nee)
        rng, u2b = pcg_uniform_masked(rng, want_nee)
        at_surf = do_surf | do_rough
        p_vertex = (torch.where(at_surf[:, None], p_hit + n_f * _SURF_EPS,
                                p_scat) if has_surf else p_scat)
        ls, is_delta = lights_mod.sample_one_light(
            lights, p_vertex, u1, torch.stack([u2a, u2b], -1), c.lam,
            strategy=light_strategy)
        f_hat = phase_ops.hg_phase(wo, ls.wi, g)
        f_hat_d = phase_ops.hg_phase(wo, ls.wi, g_samp).detach()  # pdf role
        if has_surf:
            cos_l = vmu.dot(ls.wi, n_f)
            cos_p = torch.clamp(cos_l, min=0.0)
            f_spec = torch.where(do_surf[:, None],
                                 albedo / np.pi * cos_p[:, None],
                                 f_hat[:, None])
            spdf_d = torch.where(do_surf, (cos_p / np.pi).detach(), f_hat_d)
            diff_nee_ok = cos_l > 0
            if has_dt:
                # DT lanes are two-sided: the light on wo's side takes the
                # reflectance lobe, behind the surface the transmittance one
                wi_dl = vmu.to_local(sbx, sby, sbz, ls.wi)
                f_dt = (bxdfs_mod.diffuse_transmission_f(
                    wo_sl, wi_dl, albedo, trans_hit)
                    * torch.abs(cos_l)[:, None])
                spdf_dt = bxdfs_mod.diffuse_transmission_pdf(
                    wo_sl, wi_dl, torch.amax(albedo, -1),
                    torch.amax(trans_hit, -1)).detach()
                dt_nee = do_surf & dt_l
                f_spec = torch.where(dt_nee[:, None], f_dt, f_spec)
                spdf_d = torch.where(dt_nee, spdf_dt, spdf_d)
                diff_nee_ok = torch.where(dt_l, (f_dt > 0).any(-1),
                                          diff_nee_ok)
            rough_nee_ok = false
            if has_rough:
                # the microfacet f |cos| and pdf toward the light, the MIS
                # companion of the VNDF bounce
                wi_nl = vmu.to_local(sbx, sby, sbz, ls.wi)
                f_c_nee = bxdfs_mod.conductor_f(wo_sl, wi_nl, eta_c_hit,
                                                k_c_hit, alpha_hit)
                p_c_nee = bxdfs_mod.conductor_pdf(wo_sl, wi_nl, alpha_hit)
                f_d_nee = bxdfs_mod.dielectric_f(wo_sl, wi_nl, eta_m,
                                                 alpha_hit)
                p_d_nee = bxdfs_mod.dielectric_pdf(wo_sl, wi_nl, eta_m,
                                                   alpha_hit)
                f_r_nee = (torch.where(is_cond_l[:, None], f_c_nee, f_d_nee)
                           * torch.abs(wi_nl[..., 2])[:, None])
                p_r_nee = torch.where(is_cond_l, p_c_nee, p_d_nee).detach()
                f_spec = torch.where(do_rough[:, None], f_r_nee, f_spec)
                spdf_d = torch.where(do_rough, p_r_nee, spdf_d)
                rough_nee_ok = (p_r_nee > 0) & (f_r_nee > 0).any(-1)
            # the shadow ray leaves a surface on the light's side (pbrt
            # SpawnRayTo), so a transmitted direction does not start
            # inside the surface
            side = torch.where(vmu.dot(c.n_surf, ls.wi) > 0, _SURF_EPS,
                               -_SURF_EPS)
            p_occl = torch.where(at_surf[:, None],
                                 p_hit + c.n_surf * side[:, None], p_vertex)
            occl = shapes_mod.occluded(opaque, p_occl, ls.wi, ls.dist)
            extra_ok = torch.where(
                do_surf, diff_nee_ok,
                torch.where(do_rough, rough_nee_ok, f_hat_d > 0)) & ~occl
        else:
            f_spec = f_hat[:, None].expand(n, LANES)
            spdf_d = f_hat_d
            extra_ok = f_hat_d > 0
        nee_valid = want_nee & ls.valid & (ls.pdf > 0) & extra_ok
        skip_nee = want_nee & ~nee_valid

        # ---- NEE collisions (pc == NEE): ratio tracking ----
        col_s = col_any & (c.pc == PC_NEE)
        pdf_rt = (T_maj_d[:, 0] * sig_majr0).detach()
        inv_rt = (1.0 / torch.clamp(pdf_rt, min=1e-30))[:, None]
        rt3 = (col_s & (pdf_rt > 0))[:, None]
        # T_ray keeps the full null magnitude sig_n; in residual mode the
        # pdf takes the residual rate and the control factor applies
        # deterministically.  r_l_s tracks the distance sampler's pdf (no
        # control factor); r_u_s the sampling-side null products
        if residual_on:
            T_ray = torch.where(rt3, c.T_ray * T_maj * ctrlT * sig_n * inv_rt,
                                c.T_ray)
            r_u_s = torch.where(
                rt3, c.r_u_s * T_maj_d * ctrlT_d * sig_n_d * inv_rt,
                c.r_u_s).detach()
        else:
            T_ray = torch.where(rt3, c.T_ray * T_maj * sig_n * inv_rt,
                                c.T_ray)
            r_u_s = torch.where(rt3, c.r_u_s * T_maj_d * sig_n_d * inv_rt,
                                c.r_u_s).detach()
        r_l_s = torch.where(rt3, c.r_l_s * T_maj_d * sig_majr_d * inv_rt,
                            c.r_l_s).detach()
        denom_rr = torch.mean(r_l_s + r_u_s, dim=-1)
        Tr = r_u_s / torch.clamp(denom_rr, min=1e-30)[:, None]
        rr = col_s & (torch.amax(Tr, dim=-1) < 0.05)
        rng, u_rr = pcg_uniform_masked(rng, rr)
        killed = rr & (u_rr < 0.75)
        T_ray = torch.where(killed[:, None], 0.0,
                            torch.where(rr[:, None], T_ray / 0.25, T_ray))
        shadow_dead = col_s & (killed | ~(r_u_s != 0.0).any(dim=-1))

        # ---- NEE segment complete (pc == NEE) ----
        # the gap factor f_res, and in residual mode the control factor of
        # the depth marched since the last event (shadow_dead lanes applied
        # this iteration's at their collision)
        esc_s = (c.seg_escaped | shadow_dead) & (c.pc == PC_NEE)
        fin3 = (esc_s & ~shadow_dead)[:, None]
        if residual_on:
            T_ray_f = torch.where(fin3, T_ray * f_res * ctrlT, T_ray)
            r_u_sf = torch.where(fin3, r_u_s * f_res_d * ctrlT_d, r_u_s)
        else:
            T_ray_f = torch.where(fin3, T_ray * f_res, T_ray)
            r_u_sf = torch.where(fin3, r_u_s * f_res_d, r_u_s)
        r_l_sf = torch.where(fin3, r_l_s * f_res_d, r_l_s)
        r_l_nee = r_l_sf * c.r_u * c.ls_pdf[:, None]
        r_u_nee = r_u_sf * c.r_u * c.spdf_d[:, None]
        denom_nee = torch.where(c.is_delta, torch.mean(r_l_nee, dim=-1),
                                torch.mean(r_l_nee + r_u_nee,
                                           dim=-1)).detach()
        contrib_nee = (c.beta * c.f_spec * T_ray_f * c.ls_L
                       / torch.clamp(denom_nee, min=1e-30)[:, None])
        L_acc = L_acc + torch.where((esc_s & (denom_nee > 0))[:, None],
                                    contrib_nee, 0.0)

        # ---- resume: NEE done, a vertex that skipped NEE, or a specular
        # surface hit bouncing at once ----
        resume = esc_s | skip_nee | do_spec
        if has_surf:
            # skip_nee surface lanes have not set at_surface yet
            res_surf = (esc_s & c.at_surface) | (skip_nee & at_surf)
        rng, u3a = pcg_uniform_masked(rng, resume)
        rng, u3b = pcg_uniform_masked(rng, resume)
        u3 = torch.stack([u3a, u3b], -1)
        wo2 = -c.d_main
        wi, ps_pdf = phase_ops.sample_hg(wo2, u3, g_samp)
        ps_pdf = ps_pdf.detach()
        # beta *= p(theta) / pdf: 1 in the forward pass
        p_theta = phase_ops.hg_phase(wo2, wi, g)
        f_over = (p_theta[:, None]
                  / torch.clamp(ps_pdf, min=1e-30)[:, None])
        if has_surf:
            # surfaces: a cosine-sampled bounce about the stored normal
            # (mid, n_f, wo_sl and the microfacet parameters all derive from
            # c.mat_id and c.n_surf, so they hold for NEE-returning lanes)
            n_rf = vmu.face_forward(c.n_surf, wo2)
            local = warps.sample_cosine_hemisphere(u3)
            bx, by, bz = vmu.frame_from_z(n_rf)
            wi_surf = vmu.from_local(bx, by, bz, local)
            pdf_surf = (torch.clamp(vmu.dot(wi_surf, n_rf), min=0.0)
                        / np.pi).detach()
            res_rough = false
            res_diff = res_surf
            if has_rough:
                lane_rough = surf.rough_mask[mid]
                res_rough = res_surf & lane_rough
                res_diff = res_surf & ~lane_rough
            wi = torch.where(res_diff[:, None], wi_surf, wi)
            ps_pdf = torch.where(res_diff, pdf_surf, ps_pdf)
            # f cos / pdf = albedo for a cosine-sampled Lambertian
            f_over = torch.where(res_diff[:, None], albedo,
                                 p_theta[:, None] / torch.clamp(
                                     ps_pdf, min=1e-30)[:, None])
            if has_dt:
                # the transmission lobe with probability pt / (pr + pt), the
                # cosine sample in the far hemisphere; its pdf carries the
                # side choice, consistent with the NEE pdf above
                dt_res = res_diff & surf.dt_mask[mid]
                rng, u_dt = pcg_uniform_masked(rng, dt_res)
                bs_dt = bxdfs_mod.diffuse_transmission_sample(
                    wo_sl, u_dt, u3, albedo, trans_hit)
                cos_dt = torch.abs(bs_dt.wi[..., 2])
                wi = torch.where(dt_res[:, None],
                                 vmu.from_local(sbx, sby, sbz, bs_dt.wi), wi)
                ps_pdf = torch.where(dt_res, bs_dt.pdf.detach(), ps_pdf)
                f_over = torch.where(
                    dt_res[:, None],
                    bs_dt.f * (cos_dt / torch.clamp(bs_dt.pdf,
                                                    min=1e-30))[:, None],
                    f_over)
                go_dt_t = dt_res & bs_dt.transmitted
            if has_rough:
                # the rough microfacet bounce: a Trowbridge-Reitz VNDF sample
                # of the conductor or dielectric lobe
                rng, u_lb = pcg_uniform_masked(rng, res_rough & ~is_cond_l)
                bs_c = bxdfs_mod.conductor_sample(wo_sl, u3, eta_c_hit,
                                                  k_c_hit, alpha_hit)
                bs_dl = bxdfs_mod.dielectric_sample(wo_sl, u_lb, u3, eta_m,
                                                    alpha_hit)
                cond3 = is_cond_l[:, None]
                wi_rl = torch.where(cond3, bs_c.wi, bs_dl.wi)
                f_rs = torch.where(cond3, bs_c.f, bs_dl.f)
                pdf_rs = torch.where(is_cond_l, bs_c.pdf, bs_dl.pdf).detach()
                ok_rs = torch.where(is_cond_l, bs_c.pdf > 0, bs_dl.pdf > 0)
                cos_rs = torch.abs(wi_rl[..., 2])
                wi = torch.where(res_rough[:, None],
                                 vmu.from_local(sbx, sby, sbz, wi_rl), wi)
                ps_pdf = torch.where(res_rough,
                                     torch.where(ok_rs, pdf_rs, 0.0), ps_pdf)
                f_over = torch.where(
                    res_rough[:, None],
                    f_rs * (cos_rs / torch.clamp(pdf_rs,
                                                 min=1e-30))[:, None],
                    f_over)
                # a transmitted sample crosses to the other hemisphere
                trans_rough = res_rough & (wi_rl[..., 2] * wo_sl[..., 2] < 0)

        if has_spec:
            # ---- smooth specular lobes (the delta cases of the
            # conductor, dielectric and thin dielectric) ----
            is_thin_l = surf.thin_mask[mid]
            cos_o = torch.clamp(vmu.dot(wo_s, n_f), min=1e-6)
            wi_mirror = bxdfs_mod.reflect(wo_s, n_f)
            sgn_cos = vmu.dot(wo_s, c.n_surf)    # signed vs the outward normal
            F_d = bxdfs_mod.fresnel_dielectric(sgn_cos, eta_m)
            # thin slab: the total reflectance with internal bounces
            F_thin = torch.where(F_d < 1.0, 2.0 * F_d / (1.0 + F_d), 1.0)
            F_prob = torch.where(is_thin_l, F_thin, F_d)
            rng, u_lobe = pcg_uniform_masked(rng, do_spec & ~is_cond_l)
            ok_refr, wt, eta_p = bxdfs_mod.refract(wo_s, c.n_surf, eta_m)
            refl = is_cond_l | (u_lobe < F_prob) | (~is_thin_l & ~ok_refr)
            wt_dir = torch.where(is_thin_l[:, None], -wo_s, wt)
            wi_sp = torch.where(refl[:, None], wi_mirror, wt_dir)
            F_c = bxdfs_mod.fresnel_conductor(
                cos_o[:, None] * torch.ones((n, LANES), device=dev),
                eta_c_hit, k_c_hit)
            # the lobe is chosen with probability F (or 1 - F): the weights
            # cancel to 1 but for the conductor's Fresnel and the 1 / eta^2
            # radiance scale of a refraction
            f_sp = torch.where(
                is_cond_l[:, None], F_c,
                torch.where((refl | is_thin_l)[:, None], 1.0,
                            (1.0 / torch.clamp(eta_p * eta_p,
                                               min=1e-12))[:, None]))
            p_spec_o = p_hit + c.n_surf * torch.where(
                refl == (sgn_cos > 0), _SURF_EPS, -_SURF_EPS)[:, None]
            wi = torch.where(do_spec[:, None], wi_sp, wi)
            ps_pdf = torch.where(do_spec, 1.0, ps_pdf)
            f_over = torch.where(do_spec[:, None], f_sp, f_over)
        ps_ok = ps_pdf > 0
        go = resume & ps_ok
        beta = beta * torch.where(go[:, None], f_over, 1.0)
        r_l_new = torch.where(go[:, None],
                              r_u / torch.clamp(ps_pdf, min=1e-30)[:, None],
                              r_l).detach()
        rr_kill = false
        if has_surf:
            # Russian roulette after surface bounces past depth 1
            rr_beta = torch.amax(beta.detach() / torch.clamp(
                torch.mean(r_u, dim=-1), min=1e-30)[:, None], dim=-1)
            rr_cand = res_surf & ps_ok & (c.depth > 1) & (rr_beta < 1.0)
            q = torch.clamp(1.0 - rr_beta, 0.0, 0.95)
            rng, u_rr2 = pcg_uniform_masked(rng, rr_cand)
            rr_kill = rr_cand & (u_rr2 < q)
            beta = torch.where((rr_cand & ~rr_kill)[:, None],
                               beta / torch.clamp(1.0 - q, min=1e-6)[:, None],
                               beta)

        # the resume origin: NEE-returning lanes from the stored shadow
        # origin (the vertex), skip_nee lanes from the fresh vertex,
        # specular lanes from the side-offset hit point
        p_fresh = p_scat
        if has_surf:
            p_fresh = torch.where(at_surf[:, None], p_vertex, p_scat)
            if has_spec:
                p_fresh = torch.where(do_spec[:, None], p_spec_o, p_fresh)
        p_resume = torch.where(esc_s[:, None], c.so, p_fresh)
        # transmitted microfacet and diffuse-transmission lanes continue on
        # the far side: the vertex sits _SURF_EPS on wo's side
        for crossed in ((trans_rough,) if has_rough else ()) + (
                (go_dt_t,) if has_dt else ()):
            p_resume = torch.where(crossed[:, None],
                                   p_resume - n_rf * (2.0 * _SURF_EPS),
                                   p_resume)
        d_new = torch.where(go[:, None], wi, c.d_main)

        # ---- program counter ----
        march_on = go & ~rr_kill
        pc = c.pc
        pc = torch.where(is_absorb | dead_null | over | to_sky | hit_emit
                         | over_s, PC_DONE, pc)
        pc = torch.where(nee_valid, PC_NEE, pc)
        pc = torch.where(march_on, PC_MARCH, pc)
        pc = torch.where(resume & (~ps_ok | rr_kill), PC_DONE, pc)

        # ---- null continuation: a fresh optical-depth target in place ----
        st0 = st_smp[:, 0]
        st0_c = torch.clamp(st0, min=1e-30)
        rng, u_n = pcg_uniform_masked(rng, is_null & ~dead_null)
        u_n = torch.clamp(u_n, max=ONE_MINUS_EPSILON)
        dl_new = torch.where(st0 > 0, -torch.log1p(-u_n) / st0_c, torch.inf)
        rng, u_n2 = pcg_uniform_masked(rng, col_s & ~shadow_dead)
        u_n2 = torch.clamp(u_n2, max=ONE_MINUS_EPSILON)
        dl_new2 = torch.where(st0 > 0, -torch.log1p(-u_n2) / st0_c,
                              torch.inf)
        dl_target = torch.where(
            is_null & ~dead_null, dl_new,
            torch.where(col_s & ~shadow_dead, dl_new2, c.dl_target))
        dl_since = torch.where(col_any, 0.0, c.dl_since)

        extra = {}
        if count_events:
            extra["ev_counts"] = c.ev_counts + torch.stack(
                [col_m.sum(), col_s.sum()])
        if residual_on:
            extra["ctrl_since"] = torch.where(col_any, 0.0, c.ctrl_since)
        if has_surf:
            extra["at_surface"] = torch.where(
                nee_valid, at_surf,
                torch.where(resume, False, c.at_surface))
            extra["spec_last"] = torch.where(
                do_spec, True,
                torch.where(do_scatter | (resume & ~do_spec), False,
                            c.spec_last))
        nv3 = nee_valid[:, None]
        c2 = dataclasses.replace(
            c, pc=pc, depth=depth, rng=rng, d_main=d_new,
            L=L_acc, beta=beta, r_u=r_u, r_l=r_l_new,
            T_ray=torch.where(nv3, 1.0, T_ray_f),
            r_l_s=torch.where(nv3, 1.0, r_l_sf),
            r_u_s=torch.where(nv3, 1.0, r_u_sf),
            ls_L=torch.where(nv3, ls.L, c.ls_L),
            ls_pdf=torch.where(nee_valid, ls.pdf, c.ls_pdf),
            f_spec=torch.where(nv3, f_spec, c.f_spec),
            spdf_d=torch.where(nee_valid, spdf_d, c.spdf_d),
            is_delta=torch.where(nee_valid, is_delta, c.is_delta),
            dl_target=dl_target, dl_since=dl_since,
            reached=c.reached & ~col_any, **extra,
        )

        # ---- segment (re)initialization: a shadow ray from the vertex, or
        # the next main segment (which intersects the surfaces again) ----
        new_o = torch.where(nv3, p_vertex, p_resume)
        new_d = torch.where(nv3, ls.wi, wi)
        new_tmax = torch.where(nee_valid, ls.dist, torch.inf)
        return init_segment(new_o, new_d, new_tmax, c2.rng,
                            nee_valid | march_on, c2, need_main=march_on)

    def sliced_events(c: _Regs, n_step: int) -> _Regs:
        """The event block on event group n_step % event_groups, a
        contiguous 1/E slice of the lanes.  A lane's streams advance only
        at its own events, so every estimate equals event_groups=1's."""
        assert N % event_groups == 0, "event_groups must divide the lanes"
        lo = (n_step % event_groups) * (N // event_groups)
        hi = lo + N // event_groups
        # per-lane registers are sliced; the cursor, the counters and the
        # (1,) placeholders pass through
        lane = [f.name for f in dataclasses.fields(c)
                if f.name != "ev_counts" and getattr(c, f.name).dim() > 0
                and getattr(c, f.name).shape[0] == N]
        sub = handle_events(dataclasses.replace(
            c, **{k: getattr(c, k)[lo:hi] for k in lane}))
        return dataclasses.replace(sub, **{
            k: torch.cat([getattr(c, k)[:lo], getattr(sub, k),
                          getattr(c, k)[hi:]]) for k in lane})

    def retired_rgb(c: _Regs):
        """Each lane's rgb, clamped to max_component (only when that is
        finite: a clamp by inf would give autograd 0 * inf), finite."""
        swl = spu.SampledWavelengths(c.lam, c.lam_pdf)
        rgb = cspace.xyz_to_rgb(spu.to_xyz(c.L, swl))
        if math.isfinite(R_maxc):
            m = torch.amax(rgb, dim=-1)
            rgb = rgb * torch.where(m > R_maxc,
                                    R_maxc / torch.clamp(m, min=1e-24),
                                    1.0)[:, None]
        return torch.nan_to_num(rgb, nan=0.0, posinf=0.0, neginf=0.0)

    def group(n_step: int):
        """Lanes [lo, hi) of this iteration's retire group, and its mask."""
        if retire_groups == 1:
            return 0, N, None
        grp_sz = N // retire_groups
        lo = (n_step % retire_groups) * grp_sz
        active = torch.zeros((N,), dtype=torch.bool, device=dev)
        active[lo:lo + grp_sz] = True
        return lo, lo + grp_sz, active

    def splat(film, tgt, vals, lo, hi):
        """Add the (N, 3) rows vals[lo:hi] to the film pixels tgt[lo:hi]
        (R_HW: the discard slot); with a loss cotangent, add sum(cot .
        film) of those rows to the (1,) scalar instead."""
        tgt3 = (tgt[lo:hi, None] + ch_off).reshape(-1)
        vals = vals[lo:hi].reshape(-1)
        if R_cot is not None:
            return film + torch.sum(R_cot[tgt3] * vals)[None]
        if fixed_steps is None:
            return film.index_add_(0, tgt3, vals)
        return film.index_add(0, tgt3, vals)   # autograd, checkpointing

    def respawn(c: _Regs, can, sp_work, sp_samp, **regs):
        """Start the (pixel, sample) of work item sp_work in lanes `can`,
        with fresh path state, and set `regs`."""
        o2, d2, lam2, pdf2, rng2 = spawn(sp_work, sp_samp)
        s_t2, s_a2, s_s2, s_le2 = spectra_for(lam2)
        sel = can[:, None]
        c = dataclasses.replace(
            c,
            pc=torch.where(can, PC_MARCH, c.pc),
            depth=torch.where(can, 0, c.depth),
            rng=torch.where(can, rng2, c.rng),
            lam=torch.where(sel, lam2, c.lam),
            lam_pdf=torch.where(sel, pdf2, c.lam_pdf),
            s_t=torch.where(sel, s_t2, c.s_t),
            s_a=torch.where(sel, s_a2, c.s_a),
            s_s=torch.where(sel, s_s2, c.s_s),
            s_le=torch.where(sel, s_le2, c.s_le),
            d_main=torch.where(sel, d2, c.d_main),
            L=torch.where(sel, 0.0, c.L),
            beta=torch.where(sel, one_s, c.beta),
            r_u=torch.where(sel, one_s, c.r_u),
            r_l=torch.where(sel, one_s, c.r_l),
            T_ray=torch.where(sel, one_s, c.T_ray),
            r_l_s=torch.where(sel, one_s, c.r_l_s),
            r_u_s=torch.where(sel, one_s, c.r_u_s),
            **regs)
        if has_surf:
            c = dataclasses.replace(
                c, at_surface=torch.where(can, False, c.at_surface),
                spec_last=torch.where(can, False, c.spec_last))
        return init_segment(o2, d2, inf_n, c.rng, can, c, need_main=can)

    def retire_respawn(c: _Regs, film, n_step: int):
        """Splat each finished sample of this iteration's retire group and
        refill its lane with the next unissued work item (rank-ordered).
        Returns (c, film)."""
        lo, hi, active = group(n_step)
        done = (c.pc == PC_DONE) & (c.work >= 0)
        if active is not None:
            done = done & active
        gw = c.work + R_ibase
        tgt = torch.where(done & (gw < R_gitems), work_pixel(gw), R_HW)
        film = splat(film, tgt,
                     torch.where(done[:, None], retired_rgb(c), 0.0), lo, hi)
        rank = torch.cumsum(done.to(i64), 0) - 1
        new_work = c.cursor + rank
        can = done & (new_work < R_total)
        sp_work = torch.where(can, new_work, 0)
        c = respawn(
            c, can, sp_work, None,
            work=torch.where(can, new_work, torch.where(done, -1, c.work)),
            cursor=torch.clamp(c.cursor + done.sum(), max=R_total))
        return c, film

    def retire_respawn_accum(c: _Regs, film, n_step: int):
        """Bank each finished sample's rgb in registers, run the pixel's next
        sample in the same lane, and splat a pixel once all its samples are
        banked; only the lanes of this iteration's retire group may splat.
        Returns (c, film): the film, or with a loss cotangent the (1,)
        running sum(cot . film)."""
        fresh = (c.pc == PC_DONE) & (c.work >= 0) & (c.samp < R_spp)
        rgb_acc = c.rgb_acc + torch.where(fresh[:, None], retired_rgb(c), 0.0)
        samp = c.samp + fresh.to(c.samp.dtype)

        lo, hi, active = group(n_step)
        retire = (c.pc == PC_DONE) & (c.work >= 0) & (samp >= R_spp)
        if active is not None:
            retire = retire & active
        gw = c.work + R_ibase
        tgt = torch.where(retire & (gw < R_gitems), work_pixel(gw), R_HW)
        film = splat(film, tgt, torch.where(retire[:, None], rgb_acc, 0.0),
                     lo, hi)

        # respawn: the next sample of the same pixel, or a fresh pixel
        nxt = fresh & (samp < R_spp)
        rank = torch.cumsum(retire.to(i64), 0) - 1
        new_work = c.cursor + rank
        can_new = retire & (new_work < R_items)
        sp_work = torch.where(nxt, c.work, torch.where(can_new, new_work, 0))
        c = respawn(
            c, nxt | can_new, sp_work, torch.where(nxt, samp, 0),
            work=torch.where(can_new, new_work,
                             torch.where(retire, -1, c.work)),
            samp=torch.where(can_new, 0, samp),
            rgb_acc=torch.where(retire[:, None], 0.0, rgb_acc),
            cursor=torch.clamp(c.cursor + retire.sum(), max=R_items))
        return c, film

    def busy(c: _Regs) -> bool:
        live = c.pc != PC_DONE
        return bool((live if regen is None else live | (c.work >= 0)).any())

    def step(c: _Regs, film, n_step: int):
        for _ in range(sub_rounds):
            c = block_substep(c, k_substeps)
            c = (sliced_events(c, n_step) if event_groups > 1
                 else handle_events(c))
        if regen is None:
            return c, film
        if retire_every > 1:
            # splat and refill every retire_every-th iteration only
            if n_step % retire_every != retire_every - 1:
                return c, film
            return retire_respawn(c, film, n_step)
        if accum_spp:
            return retire_respawn_accum(c, film, n_step)
        return retire_respawn(c, film, n_step)

    hist = []
    # wave mode carries a (1,) placeholder in the film's place
    c, film = regs, (regen["film_rgb"] if regen is not None
                     else torch.zeros((1,), dtype=f32, device=dev))
    if fixed_steps is None or record_alive:
        # record_alive runs the open loop and ignores fixed_steps, as the
        # reference does
        n_steps = 0
        while n_steps < max_march_steps:
            if n_steps % CHECK_EVERY == 0 and not busy(c):
                break
            if record_alive:
                hist.append((c.pc != PC_DONE).sum())
            c, film = step(c, film, n_steps)
            n_steps += 1
    else:
        w = (int(remat_window) if remat_window is not None
             and int(fixed_steps) > int(remat_window) else 1)
        n_win = -(-int(fixed_steps) // w)

        def window(start: int, *state):
            c, film = _Regs(*state[:-1]), state[-1]
            for i in range(w):
                c, film = step(c, film, start + i)
            return (*_fields(c), film)

        state = (*_fields(c), film)
        for k in range(n_win):
            state = checkpoint(window, k * w, *state, use_reentrant=False,
                               preserve_rng_state=False)
        c, film = _Regs(*state[:-1]), state[-1]
        n_steps = n_win * w
    return LiResult(
        film_rgb=film if regen is not None else None, iterations=n_steps,
        alive_hist=(torch.stack(hist) if hist else
                    torch.zeros((0,), dtype=i64, device=dev))
        if record_alive else None,
        L=c.L if regen is None else None,
        ev_counts=c.ev_counts if count_events else None)
