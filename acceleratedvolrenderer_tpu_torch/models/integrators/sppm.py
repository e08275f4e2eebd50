"""SPPM, stochastic progressive photon mapping (port of
acceleratedvolrenderer_tpu/models/integrators/sppm.py).

Each iteration (pbrt's SPPMIntegrator::Render):
  1. a camera pass stores one visible point per pixel at its first diffuse
     vertex while it accumulates direct lighting;
  2. a photon pass traces light particles and deposits their flux on the
     visible points within their search radius;
  3. the per-pixel statistics contract: N' = N + gamma M,
     R' = R sqrt(N' / (N + M)), tau' = (tau + beta Phi) (R' / R)^2.

The hashed grid of visible-point lists is a sort: each visible point emits
up to 27 (hash(cell), index) pairs for the cells its radius box overlaps
(the cell size is the iteration's largest radius), the pairs are sorted by
hash (stably, so equal hashes keep their index order, as the reference's
order), and a photon binary-searches its cell's hash and scans at most
`max_candidates` pairs of the run; what lies past the cap is counted
(stats["truncated_candidates"]).  Deposition is a scatter-add
(index_add_, atomics in no fixed order on the card).  The wavelengths are
drawn once per iteration and shared by both passes; tau and Ld accumulate
in RGB.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ...ops import dda
from ...utils import colorspace as cspace
from ...utils import spectrum as sp
from ...utils import vecmath as vmu
from ...utils.device import resolve
from .. import lights as lights_mod
from .. import materials as materials_mod
from .. import shapes as shapes_mod
from .light_path import _light_pmfs, sample_le
from .path import (PCGSource, _bsdf_f_pdf, _bsdf_sample, _gather_mat_params,
                   _side, _take, scene_lights_with_area)

_SURF_EPS = 1e-4
_GAMMA = 2.0 / 3.0  # pbrt's radius-contraction exponent
_M32 = 0xFFFFFFFF


def _hash_cell(cx, cy, cz, size):
    """The 3D cell hash of the reference: uint32 arithmetic, in int64
    tensors masked to 32 bits (a negative cell index wraps as its uint32
    cast does)."""
    h = (dda._mul32(cx.to(torch.int64) & _M32, 73856093)
         ^ dda._mul32(cy.to(torch.int64) & _M32, 19349663)
         ^ dda._mul32(cz.to(torch.int64) & _M32, 83492791))
    return h % size


def _radical_inverse_base2(i: int) -> float:
    """Van der Corput's sequence: the iteration's wavelength stratum."""
    v, f, inv = i, 0.0, 0.5
    while v:
        f += (v & 1) * inv
        v >>= 1
        inv *= 0.5
    return f


def _camera_pass(prims, lights, cam, pix, pixidx, lam, rng, *, max_depth,
                 light_strategy):
    """Trace the camera paths: returns (Ld (N, L), the visible points, the
    advanced streams).  Direct lighting by NEE without MIS (emission counts
    only after specular chains) accumulates into Ld; a path stops and
    stores its visible point at its first diffuse vertex."""
    N = pix.shape[0]
    dev = lam.device
    L_LANES = lam.shape[-1]
    opaque = tuple(p for p in prims if p.material is not None)
    non_emitters = tuple(pp for pp in opaque if not pp.material.emissive)
    emitters = tuple(pp for pp in opaque if pp.material.emissive)
    src = PCGSource(rng)
    lights_all = scene_lights_with_area(lights, opaque)

    o_cur, d_cur = cam.generate_rays(pix, torch.full((N, 2), 0.5,
                                                     device=dev))
    zeros_l = lambda: torch.zeros((N, L_LANES), device=dev)
    Ld = zeros_l()
    beta = torch.ones((N, L_LANES), device=dev)
    alive = torch.ones((N,), dtype=torch.bool, device=dev)
    spec_prev = torch.ones((N,), dtype=torch.bool, device=dev)
    stored = torch.zeros((N,), dtype=torch.bool, device=dev)
    vp_p = torch.zeros((N, 3), device=dev)
    vp_n = torch.zeros((N, 3), device=dev)
    vp_wo = torch.zeros((N, 3), device=dev)
    vp_beta, vp_albedo = zeros_l(), zeros_l()

    for depth in range(max_depth + 1):
        hit = shapes_mod.intersect_all(opaque, o_cur, d_cur, torch.inf)
        escaped = alive & ~torch.isfinite(hit.t)
        Le_inf, _ = lights_mod.escaped_radiance(lights, d_cur, lam)
        w_spec = torch.where(spec_prev, 1.0, 0.0)[:, None]
        Ld = Ld + torch.where(escaped[:, None], beta * Le_inf * w_spec, 0.0)

        surf = alive & torch.isfinite(hit.t)
        mid = torch.clamp(hit.prim_id, 0, len(opaque) - 1)
        p_hit = o_cur + hit.t[:, None] * d_cur
        wo = -d_cur
        stacks = _gather_mat_params(opaque, lam, hit.uv, N)
        kind_ids = _take(stacks["kind"], mid)
        prm = {k: _take(v, mid) for k, v in stacks.items()
               if k not in ("kind", "emissive") and not k.startswith("_")}
        emissive_mask = torch.tensor(stacks["emissive"], device=dev)[mid]

        hit_emit = surf & emissive_mask & (vmu.dot(hit.n, wo) > 0)
        Ld = Ld + torch.where(hit_emit[:, None],
                              beta * prm["emission"] * w_spec, 0.0)

        shade = surf & ~emissive_mask
        n_g = hit.n
        bx, by, bz = vmu.frame_from_z(n_g)
        wo_l = vmu.to_local(bx, by, bz, wo)

        # NEE at every vertex
        u1 = src.next(shade)
        u2 = torch.stack([src.next(shade), src.next(shade)], -1)
        ls, _ = lights_mod.sample_one_light(
            lights_all, p_hit + n_g * _side(n_g, wo), u1, u2, lam,
            strategy=light_strategy)
        wi_l_nee = vmu.to_local(bx, by, bz, ls.wi)
        f_nee, _ = _bsdf_f_pdf(kind_ids, prm, wo_l, wi_l_nee, lam,
                               stacks["_measured_tables"])
        cos_nee = torch.abs(wi_l_nee[..., 2])
        p_off = p_hit + n_g * _side(n_g, ls.wi)
        occl = shapes_mod.occluded(non_emitters, p_off, ls.wi, ls.dist)
        for pp in emitters:
            t_e, _, _ = pp.intersect(p_off, ls.wi, ls.dist)
            occl = occl | torch.isfinite(t_e)
        ok_nee = (shade & ls.valid & (ls.pdf > 0) & ~occl
                  & (f_nee > 0).any(-1))
        Ld = Ld + torch.where(ok_nee[:, None], beta * f_nee
                              * cos_nee[:, None] * ls.L
                              / torch.clamp(ls.pdf, min=1e-20)[:, None], 0.0)

        # store the visible point at the first diffuse vertex
        store_now = (shade & (kind_ids == materials_mod.KIND_DIFFUSE)
                     & ~stored)
        s3 = store_now[:, None]
        vp_p = torch.where(s3, p_hit, vp_p)
        vp_n = torch.where(s3, n_g, vp_n)
        vp_wo = torch.where(s3, wo, vp_wo)
        vp_beta = torch.where(s3, beta, vp_beta)
        vp_albedo = torch.where(s3, prm["albedo"], vp_albedo)
        stored = stored | store_now
        if depth == max_depth:
            break

        # go on through the non-diffuse lobes only
        cont = shade & ~store_now
        u_lobe = src.next(cont)
        u2b = torch.stack([src.next(cont), src.next(cont)], -1)
        bs = _bsdf_sample(kind_ids, prm, wo_l, u_lobe, u2b, lam,
                          stacks["_measured_tables"])
        cos_b = torch.abs(bs.wi[..., 2])
        ok_b = cont & (bs.pdf > 0) & (bs.f > 0).any(-1)
        beta = torch.where(ok_b[:, None], beta * bs.f * (
            cos_b / torch.clamp(bs.pdf, min=1e-20))[:, None], beta)
        wi_w = vmu.from_local(bx, by, bz, bs.wi)
        o_cur = torch.where(ok_b[:, None], p_hit + n_g * _side(n_g, wi_w),
                            o_cur)
        d_cur = torch.where(ok_b[:, None], wi_w, d_cur)
        spec_prev = torch.where(ok_b, bs.specular, spec_prev)
        alive = ok_b

    vp = dict(p=vp_p, n=vp_n, wo=vp_wo, beta=vp_beta, albedo=vp_albedo,
              valid=stored)
    return Ld, vp, src.rng


def _photon_pass(prims, lights, n_photons, lam, rng, vp, radius, *,
                 max_depth, light_strategy, max_candidates, hash_size):
    """Trace the photons and deposit their flux on the visible points:
    returns (Phi (Nvp, L), M (Nvp,) int32, truncated candidates (0-dim
    int64), the advanced streams)."""
    Nvp = vp["p"].shape[0]
    dev = lam.device
    L_LANES = lam.shape[-1]
    opaque = tuple(p for p in prims if p.material is not None)
    src = PCGSource(rng)
    lights_all = [lt for lt in scene_lights_with_area(lights, opaque)
                  if not lt.is_infinite]
    assert lights_all, "SPPM needs at least one finite light"
    pmfs = _light_pmfs(lights_all, light_strategy)

    # the grid: (hash, visible point) pairs over the <= 27 cells each
    # point's radius box overlaps
    valid = vp["valid"] & (vp["beta"] > 0).any(-1)
    r = torch.where(valid, radius, 0.0)
    cell = torch.clamp(torch.max(r), min=1e-6)       # the largest radius
    lo = torch.floor((vp["p"] - r[:, None]) / cell).to(torch.int32)
    hi = torch.floor((vp["p"] + r[:, None]) / cell).to(torch.int32)
    offs = np.stack(np.meshgrid(np.arange(3), np.arange(3), np.arange(3),
                                indexing="ij"), -1).reshape(27, 3)
    offs = torch.as_tensor(offs, dtype=torch.int32, device=dev)
    cells = lo[:, None, :] + offs[None, :, :]                 # (Nvp, 27, 3)
    in_box = (cells <= hi[:, None, :]).all(-1) & valid[:, None]
    h = _hash_cell(cells[..., 0], cells[..., 1], cells[..., 2], hash_size)
    h = torch.where(in_box, h, _M32).reshape(-1)
    vp_idx = torch.arange(Nvp, device=dev)[:, None].expand(Nvp, 27)
    order = torch.argsort(h, stable=True)
    sorted_h = h[order]
    sorted_vp = vp_idx.reshape(-1)[order]
    n_pairs = sorted_h.shape[0]

    # emission
    Np = n_photons
    u1 = src.next()
    u_pos = torch.stack([src.next(), src.next()], -1)
    u_dir = torch.stack([src.next(), src.next()], -1)
    lam_p = lam[:1].expand(Np, L_LANES) if lam.shape[0] != Np else lam
    p_cur, _, d_cur, beta, _, ok = sample_le(lights_all, pmfs, u1, u_pos,
                                             u_dir, lam_p)
    p_cur = p_cur + d_cur * _SURF_EPS
    alive = ok

    Phi = torch.zeros((Nvp + 1, L_LANES), device=dev)   # row Nvp: discard
    M = torch.zeros((Nvp + 1,), dtype=torch.int32, device=dev)
    truncated = torch.zeros((), dtype=torch.int64, device=dev)
    ks = torch.arange(max_candidates, device=dev)

    for depth in range(max_depth):
        hit = shapes_mod.intersect_all(opaque, p_cur, d_cur, torch.inf)
        surf = alive & torch.isfinite(hit.t)
        p_hit = p_cur + hit.t[:, None] * d_cur
        wi = -d_cur  # the direction the photon arrives from, at the point

        # deposit, after the first bounce only
        if depth > 0:
            pc = torch.floor(p_hit / cell).to(torch.int32)
            hp = _hash_cell(pc[..., 0], pc[..., 1], pc[..., 2], hash_size)
            s = torch.searchsorted(sorted_h, hp, side="left")
            e = torch.searchsorted(sorted_h, hp, side="right")
            truncated = truncated + torch.where(
                surf, torch.clamp(e - s - max_candidates, min=0), 0).sum()
            j = torch.clamp(s[:, None] + ks[None, :], max=n_pairs - 1)
            match = surf[:, None] & (s[:, None] + ks[None, :] < e[:, None])
            vj = sorted_vp[j]                                  # (Np, K)
            dp = p_hit[:, None, :] - vp["p"][vj]
            d2 = (dp * dp).sum(-1)
            within = match & (d2 <= radius[vj] ** 2) & vp["valid"][vj]
            # the diffuse BRDF at the point: its reflection side only
            nj = vp["n"][vj]
            same_side = ((wi[:, None, :] * nj).sum(-1)
                         * (vp["wo"][vj] * nj).sum(-1)) > 0
            within = within & same_side
            contrib = beta[:, None, :] * (vp["albedo"][vj] / np.pi)
            tgt = torch.where(within, vj, Nvp).reshape(-1)
            Phi.index_add_(0, tgt, torch.where(
                within[..., None], contrib, 0.0).reshape(-1, L_LANES))
            M.index_add_(0, tgt, within.reshape(-1).to(torch.int32))
        if depth == max_depth - 1:
            break

        # bounce: a BSDF sample and the beta-ratio Russian roulette
        mid = torch.clamp(hit.prim_id, 0, len(opaque) - 1)
        stacks = _gather_mat_params(opaque, lam_p, hit.uv, Np)
        kind_ids = _take(stacks["kind"], mid)
        prm = {k: _take(v, mid) for k, v in stacks.items()
               if k not in ("kind", "emissive") and not k.startswith("_")}
        emissive_mask = torch.tensor(stacks["emissive"], device=dev)[mid]
        shade = surf & ~emissive_mask
        n_g = hit.n
        bx, by, bz = vmu.frame_from_z(n_g)
        wo_l = vmu.to_local(bx, by, bz, -d_cur)
        u_lobe = src.next(shade)
        u2b = torch.stack([src.next(shade), src.next(shade)], -1)
        bs = _bsdf_sample(kind_ids, prm, wo_l, u_lobe, u2b, lam_p,
                          stacks["_measured_tables"])
        cos_b = torch.abs(bs.wi[..., 2])
        ok_b = shade & (bs.pdf > 0) & (bs.f > 0).any(-1)
        beta_new = beta * bs.f * (cos_b / torch.clamp(bs.pdf,
                                                      min=1e-20))[:, None]
        # the reference's photon roulette: q = max(0, 1 - betaNew / beta)
        ratio = (beta_new.mean(-1)
                 / torch.clamp(beta.mean(-1), min=1e-20))
        q = torch.clamp(1.0 - ratio, min=0.0)
        killed = ok_b & (src.next(ok_b) < q)
        beta = torch.where((ok_b & ~killed)[:, None], beta_new / torch.clamp(
            1.0 - q, min=1e-6)[:, None], beta)
        wi_w = vmu.from_local(bx, by, bz, bs.wi)
        p_cur = torch.where(ok_b[:, None], p_hit + n_g * _side(n_g, wi_w),
                            p_cur)
        d_cur = torch.where(ok_b[:, None], wi_w, d_cur)
        alive = ok_b & ~killed

    return Phi[:Nvp], M[:Nvp], truncated, src.rng


def render_sppm(scene, *, n_iterations=None, photons_per_iter=None,
                initial_radius=None, max_candidates=64, seed=None,
                device=None):
    """The SPPM renderer: returns ((H, W, 3) numpy image, stats), with the
    candidates past the cap summed over the iterations."""
    dev = resolve(device)
    scene = scene.to(dev)
    H, W = scene.height, scene.width
    n_iterations = n_iterations or scene.spp
    Np = photons_per_iter or (H * W)
    seed = scene.seed if seed is None else seed
    prims = tuple(scene.primitives)
    opaque = tuple(p for p in prims if p.material is not None)
    assert opaque, "SPPM requires opaque primitives"
    if initial_radius is None:
        # about 1/50 of the primitives' spread
        cs = np.array([np.asarray(getattr(p, "center",
                                          getattr(p, "origin", (0, 0, 0))),
                                  np.float32) for p in opaque])
        ext = (float(np.linalg.norm(cs.max(0) - cs.min(0))) if len(cs) > 1
               else 1.0)
        initial_radius = max(ext, 1.0) / 50.0

    Nvp = H * W
    hash_size = 1 << int(np.ceil(np.log2(max(2 * Nvp, 16))))
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix = torch.as_tensor(np.stack([xs.reshape(-1), ys.reshape(-1)], -1),
                          device=dev)
    pixidx = torch.arange(Nvp, device=dev)
    photon_idx = torch.arange(Np, device=dev)

    def iteration(Ld_rgb, tau_rgb, Ncnt, radius, it, u_lam):
        # the iteration's wavelengths, shared by every lane
        swl1 = sp.sample_wavelengths_visible(
            torch.full((1,), u_lam, dtype=torch.float32, device=dev))
        lam = swl1.lam.expand(Nvp, swl1.lam.shape[-1])
        swl = sp.SampledWavelengths(lam, swl1.pdf.expand(lam.shape))
        rng = dda.seed_stream(pixidx, torch.full_like(pixidx, it), salt=seed)
        Ld, vp, _ = _camera_pass(
            prims, scene.lights, scene.camera, pix, pixidx, lam, rng,
            max_depth=scene.max_depth, light_strategy=scene.light_sampler)
        rng_p = dda.seed_stream(photon_idx, torch.full_like(photon_idx, it),
                                salt=seed + 777)
        lam_p = swl1.lam.expand(Np, swl1.lam.shape[-1])
        Phi, M, truncated, _ = _photon_pass(
            prims, scene.lights, Np, lam_p, rng_p, vp, radius,
            max_depth=scene.max_depth, light_strategy=scene.light_sampler,
            max_candidates=max_candidates, hash_size=hash_size)

        # the statistics update
        Mf = M.float()
        has = Mf > 0
        Nnew = Ncnt + _GAMMA * Mf
        Rnew = torch.where(has, radius * torch.sqrt(
            Nnew / torch.clamp(Ncnt + Mf, min=1e-6)), radius)
        phi_rgb = torch.nan_to_num(
            cspace.xyz_to_rgb(sp.to_xyz(vp["beta"] * Phi, swl)),
            nan=0.0, posinf=0.0, neginf=0.0)
        ratio2 = torch.where(has, (Rnew / torch.clamp(radius, min=1e-12))
                             ** 2, 1.0)
        tau_rgb = (tau_rgb + phi_rgb) * ratio2[:, None]
        Ncnt = torch.where(has, Nnew, Ncnt)
        ld_rgb = torch.nan_to_num(cspace.xyz_to_rgb(sp.to_xyz(Ld, swl)),
                                  nan=0.0, posinf=0.0, neginf=0.0)
        return Ld_rgb + ld_rgb, tau_rgb, Ncnt, Rnew, truncated

    Ld_rgb = torch.zeros((Nvp, 3), device=dev)
    tau_rgb = torch.zeros((Nvp, 3), device=dev)
    Ncnt = torch.zeros((Nvp,), device=dev)
    radius = torch.full((Nvp,), initial_radius, dtype=torch.float32,
                        device=dev)
    total_trunc = torch.zeros((), dtype=torch.int64, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    with torch.no_grad():
        for it in range(n_iterations):
            Ld_rgb, tau_rgb, Ncnt, radius, trunc = iteration(
                Ld_rgb, tau_rgb, Ncnt, radius, it,
                _radical_inverse_base2(it + 1))
            total_trunc = total_trunc + trunc
        L = (Ld_rgb.cpu().numpy() / n_iterations
             + tau_rgb.cpu().numpy() / (n_iterations * Np * np.pi
                                        * radius.cpu().numpy()[:, None] ** 2))
    dt = time.time() - t0
    img = L.reshape(H, W, 3).astype(np.float32)
    return img, {"render_time": dt, "spp": n_iterations,
                 "photons": n_iterations * Np,
                 "truncated_candidates": int(total_trunc),
                 "rays_per_sec": (H * W + Np) * n_iterations / dt}
