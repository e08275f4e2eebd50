"""Volumetric bidirectional path tracing with per-strategy films (port of
acceleratedvolrenderer_tpu/models/integrators/bdpt.py).

pbrt's BDPTIntegrator (GenerateCameraSubpath, GenerateLightSubpath,
ConnectBDPT, MISWeight) over volumetric scenes lit by a distant light:
  * the camera subpath records medium scatter vertices of the staged delta
    tracking (ops/dda.py::delta_track; beta carries the null-collision
    ratio weights) and surface vertices with their real BSDFs
    (path.py's masked lobes; delta-sampled vertices are not connectible);
  * the light subpath starts on the light's disk outside the medium, along
    the light direction (DistantLight::SampleLe), and walks the same way
    with importance transport on its surfaces;
  * strategies: (s >= 1, t >= 2) connections with ratio-tracked
    transmittance (ops/transmittance.py::ratio_track) and the
    inverse-square geometry term; t = 1 splats of light vertices through
    the pinhole with the importance 1 / (A cos^3 theta d^2); medium
    emission along the camera subpath as the (0, 0) pseudo-strategy;
  * MIS: the balance heuristic over same-length strategies by the r_i
    recursion over stored forward and reverse area pdfs;
  * splats accumulate in a separate plane scaled by 1 / spp (a scatter-add,
    atomics in no fixed order on the card), added to the weighted image.
Each strategy's unweighted and weighted contributions can be kept as films
of their own (write_strategy_films: bdpt_dDD_sSS_tTT.exr).

Every walk vertex runs delta_track and every connection ratio_track, each
a loop that reads one flag from the device per iteration, so the render is
host bound; the subpath tensors are preallocated and filled in place.
"""
from __future__ import annotations

import os
import time
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ...ops import dda, phase as phase_ops, transmittance
from ...ops.dda import EVT_ESCAPED, EVT_SCATTER
from ...ops.warps import sample_uniform_disk_concentric
from ...utils import colorspace
from ...utils import spectrum as sp
from ...utils import vecmath as vmu
from ...utils.device import resolve
from .. import lights as lights_mod
from .. import materials as materials_mod
from .. import shapes as shapes_mod
from ..film import Film
from .path import _bsdf_f_pdf, _bsdf_sample, _gather_mat_params, _take

_BDPT_EPS = 1e-4


class Subpath(NamedTuple):
    """Vertex storage of one subpath family: every tensor is (N, V, ...).
    A vertex is a medium scatter or a surface hit (is_surf); a surface
    vertex keeps its true geometric normal and its material parameters
    (`prm`, the dict path._bsdf_f_pdf takes; {} without surfaces)."""
    p: torch.Tensor         # (N, V, 3) positions
    wi: torch.Tensor        # (N, V, 3) direction into the vertex
    beta: torch.Tensor      # (N, V, LANES) throughput up to the vertex
    valid: torch.Tensor     # (N, V) bool
    pdf_fwd: torch.Tensor   # (N, V) area-measure forward pdf
    pdf_rev: torch.Tensor   # (N, V) area-measure reverse pdf
    is_surf: torch.Tensor   # (N, V) bool
    n: torch.Tensor         # (N, V, 3) surface normal (0 in the medium)
    kind: torch.Tensor      # (N, V) material kind (surfaces only)
    spec: torch.Tensor      # (N, V) bool: a delta-lobe-sampled vertex
    prm: dict               # key -> (N, V, ...) material parameters
    lam: torch.Tensor = None    # (N, LANES) wavelengths (measured BRDFs)
    measured: tuple = ()        # the measured-BRDF registry

    def _surf_f_pdf(self, k: int, w, adjoint: bool = False):
        """(f, pdf) of the vertex-k BSDF toward w, wo back along the
        incoming ray.  adjoint=True: importance transport, which cancels
        the dielectric's radiance-convention 1 / etap^2 on transmitted
        lanes (only DielectricBxDF carries it)."""
        bx, by, bz = vmu.frame_from_z(self.n[:, k])
        wo_l = vmu.to_local(bx, by, bz, -self.wi[:, k])
        wi_l = vmu.to_local(bx, by, bz, w)
        prm_k = {key: v[:, k] for key, v in self.prm.items()}
        f, p = _bsdf_f_pdf(self.kind[:, k], prm_k, wo_l, wi_l, self.lam,
                           self.measured)
        if adjoint:
            is_diel = self.kind[:, k] == materials_mod.KIND_DIELECTRIC
            transmitted = (wo_l[..., 2] * wi_l[..., 2] < 0) & is_diel
            eta = prm_k["eta_d"]
            etap = torch.where(wo_l[..., 2] > 0, eta,
                               1.0 / torch.clamp(eta, min=1e-6))
            f = torch.where(transmitted[:, None], f * (etap ** 2)[:, None],
                            f)
        return f, p

    def f_toward(self, k: int, w, g, adjoint: bool = False):
        """The scattering value at vertex k toward w: HG in the medium, the
        BSDF on a surface (delta lobes 0)."""
        ph = phase_ops.hg_phase(-self.wi[:, k], w, g)[:, None]
        if not self.prm:
            return ph
        f_s, _ = self._surf_f_pdf(k, w, adjoint=adjoint)
        return torch.where(self.is_surf[:, k][:, None], f_s, ph)

    def pdf_toward_sa(self, k: int, w, g):
        """The solid-angle pdf of vertex k's sampler toward w."""
        ph = phase_ops.hg_phase(-self.wi[:, k], w, g)
        if not self.prm:
            return ph
        _, p_s = self._surf_f_pdf(k, w)
        return torch.where(self.is_surf[:, k], p_s, ph)

    def conv_cos(self, k: int, w):
        """The |cos| of pbrt's ConvertDensity at vertex k along w (1 in the
        medium)."""
        return torch.where(self.is_surf[:, k],
                           torch.abs(vmu.dot(self.n[:, k], w)), 1.0)


def _walk(med, o, d, beta0, rng, n_vertices, maj_res, homogeneous, pdf0,
          first_pdf_area=None, max_march_steps=50000,
          collect_emission=False, prims=(), mat_fn=None, adjoint=False,
          mat_static=None):
    """Random-walk the batch, recording medium scatter and surface
    vertices: delta tracking bounded by the closest surface hit (a segment
    that reaches the surface keeps its residual ratio weights), HG
    directions in the medium and BSDF samples on surfaces (beta *= f |cos|
    / pdf).  pdf_fwd of vertex k is the incoming direction's solid-angle
    pdf in area measure (with the surface |cos|); the first vertex's comes
    from pdf0, or first_pdf_area for a parallel beam.  Returns (Subpath,
    rng, the volumetric emission gathered along the walk)."""
    N = o.shape[0]
    dev = o.device
    LANES = beta0.shape[-1]
    V = n_vertices
    has_surf = len(prims) > 0
    ms = mat_static or {}
    coated = ms.get("coated_stochastic", False)
    m_lam, m_tables = ms.get("lam"), ms.get("measured", ())
    z = lambda *shape, dtype=torch.float32: torch.zeros(
        (N, V) + shape, dtype=dtype, device=dev)
    p_all, wi_all, n_all = z(3), z(3), z(3)
    beta_all = z(LANES)
    valid_all, surf_all = z(dtype=torch.bool), z(dtype=torch.bool)
    spec_all = z(dtype=torch.bool)
    pdf_fwd, pdf_rev = z(), z()
    kind_all = z(dtype=torch.int64)
    prm_all: dict = {}

    ones = torch.ones((N, LANES), device=dev)
    beta = beta0
    active = torch.ones((N,), dtype=torch.bool, device=dev)
    cur_o, cur_d = o, d
    prev_pdf_sa = pdf0          # solid-angle pdf of the incoming direction
    L_emit = torch.zeros((N, LANES), device=dev)
    for k in range(V):
        if has_surf:
            hit = shapes_mod.intersect_all(prims, cur_o, cur_d, torch.inf)
            t_max = hit.t
        else:
            t_max = torch.full((N,), torch.inf, device=dev)
        res = dda.delta_track(med, cur_o, cur_d, t_max, ones, ones, ones,
                              rng, active, maj_res,
                              collect_emission=collect_emission,
                              homogeneous=homogeneous,
                              max_steps=max_march_steps)
        rng = res.rng
        if collect_emission:
            # the volumetric Le along the segment, at the throughput of
            # its start
            L_emit = L_emit + torch.where(active[:, None],
                                          beta * res.L_emit, 0.0)
        sc_med = active & (res.event == EVT_SCATTER)
        # a surface vertex needs the segment to reach t_max (escaped): an
        # absorbed or step-capped lane ended inside the medium
        sc_surf = ((active & (res.event == EVT_ESCAPED)
                    & torch.isfinite(hit.t)) if has_surf
                   else torch.zeros((N,), dtype=torch.bool, device=dev))
        sc = sc_med | sc_surf
        t_ev = torch.where(sc_surf, t_max, res.t_event)
        p = cur_o + t_ev[:, None] * cur_d
        dist2 = torch.clamp(t_ev ** 2, min=1e-12)
        beta = beta * res.beta

        if has_surf:
            # the true geometric normal, not face-forwarded: both subpaths
            # must agree on which side of a dielectric a direction lies
            n_true = hit.n
            kind_ids, prm_k = mat_fn(hit, p)
            surf_all[:, k] = sc_surf
            n_all[:, k] = torch.where(sc_surf[:, None], n_true, 0.0)
            kind_all[:, k] = torch.where(sc_surf, kind_ids, 0)
            for key, v in prm_k.items():
                if key not in prm_all:
                    prm_all[key] = torch.zeros((N, V) + v.shape[1:],
                                               dtype=v.dtype, device=dev)
                mask = sc_surf.reshape((N,) + (1,) * (v.dim() - 1))
                prm_all[key][:, k] = torch.where(mask, v, prm_all[key][:, k])
        p_all[:, k] = torch.where(sc[:, None], p, 0.0)
        wi_all[:, k] = torch.where(sc[:, None], cur_d, 0.0)
        beta_all[:, k] = torch.where(sc[:, None], beta, 0.0)
        valid_all[:, k] = sc
        conv = (torch.where(sc_surf, torch.abs(vmu.dot(n_all[:, k], cur_d)),
                            1.0) if has_surf
                else torch.ones((N,), device=dev))
        if k == 0 and first_pdf_area is not None:
            # a parallel beam: the area density is the disk's, whatever
            # the distance travelled
            pdf_fwd[:, k] = torch.where(sc, first_pdf_area, 0.0)
        else:
            pdf_fwd[:, k] = torch.where(sc, prev_pdf_sa * conv / dist2, 0.0)

        # go on: an HG direction in the medium, a BSDF sample on a surface
        rng, ua = dda.pcg_uniform_masked(rng, sc)
        rng, ub = dda.pcg_uniform_masked(rng, sc)
        u2 = torch.stack([ua, ub], -1)
        wi, ps_pdf = phase_ops.sample_hg(-cur_d, u2, med.g)
        if has_surf:
            rng, ulobe = dda.pcg_uniform_masked(rng, sc)
            bx, by, bz = vmu.frame_from_z(n_true)
            wo_l = vmu.to_local(bx, by, bz, -cur_d)
            bs = _bsdf_sample(kind_ids, prm_k, wo_l, ulobe, u2, m_lam,
                              m_tables, coated_stochastic=coated)
            wi_s = vmu.from_local(bx, by, bz, bs.wi)
            cos_s = torch.abs(bs.wi[..., 2])
            ok_s = (bs.pdf > 0) & (bs.f > 0).any(-1)
            # the previous vertex's reverse pdf is defined for a lane whose
            # sample drew a direction but failed the pdf / f gate
            sc_rev = sc_med | (sc_surf & (torch.abs(bs.wi) > 0).any(-1))
            sc_surf = sc_surf & ok_s
            sc = sc_med | sc_surf
            wi = torch.where(sc_surf[:, None], wi_s, wi)
            ps_pdf = torch.where(sc_surf, bs.pdf, ps_pdf)
            w_b = bs.f * (cos_s / torch.clamp(bs.pdf, min=1e-20))[:, None]
            if adjoint:
                # importance transport: eta_scale = etap^2 on transmitted
                # lanes cancels the sampled f's 1 / etap^2
                w_b = w_b * bs.eta_scale[:, None]
            beta = torch.where(sc_surf[:, None], beta * w_b, beta)
            spec_all[:, k] = sc_surf & bs.specular
        # the previous vertex's reverse pdf: vertex k's sampler back along
        # -cur_d with the roles swapped, in area measure over the same
        # squared distance (and the previous vertex's |cos| on a surface)
        if k > 0:
            rev_sa = phase_ops.hg_phase(wi, cur_d, med.g)
            if has_surf:
                wi_back_l = vmu.to_local(bx, by, bz, -cur_d)
                # the raw sampled direction, so a failed sample still
                # evaluates the reverse pdf of what it drew
                surf_rev = sc_rev & ~sc_med
                wo_new_l = vmu.to_local(bx, by, bz, torch.where(
                    surf_rev[:, None], wi_s, wi))
                _, p_back = _bsdf_f_pdf(kind_ids, prm_k, wo_new_l,
                                        wi_back_l, m_lam, m_tables)
                rev_sa = torch.where(surf_rev, p_back, rev_sa)
                prev_conv = torch.where(
                    surf_all[:, k - 1],
                    torch.abs(vmu.dot(n_all[:, k - 1], cur_d)), 1.0)
                rev_mask = sc_rev
            else:
                prev_conv = 1.0
                rev_mask = sc
            pdf_rev[:, k - 1] = torch.where(rev_mask,
                                            rev_sa * prev_conv / dist2,
                                            pdf_rev[:, k - 1])
        prev_pdf_sa = ps_pdf
        if has_surf:
            off = (n_all[:, k] * _BDPT_EPS
                   * torch.sign(vmu.dot(n_all[:, k], wi))[:, None])
            cur_o = torch.where(sc[:, None], p + off, cur_o)
        else:
            cur_o = torch.where(sc[:, None], p, cur_o)
        cur_d = torch.where(sc[:, None], wi, cur_d)
        active = sc

    return (Subpath(p_all, wi_all, beta_all, valid_all, pdf_fwd, pdf_rev,
                    surf_all, n_all, kind_all, spec_all, prm_all,
                    m_lam, m_tables),
            rng, L_emit)


def _tr_estimate(med, a, b, rng, maj_res, homogeneous):
    """The ratio-tracked transmittance estimate between the points a and b,
    T_ray[0] / mean(r_l); returns (tr, unit direction, distance, rng)."""
    dv = b - a
    dist = torch.sqrt(torch.clamp(vmu.length_squared(dv), min=1e-12))
    dn = dv / dist[:, None]
    res = transmittance.ratio_track(
        med, a, dn, dist, rng,
        torch.ones(a.shape[0], dtype=torch.bool, device=a.device), maj_res,
        homogeneous=homogeneous)
    tr = res.T_ray[:, 0] / torch.clamp(res.r_l.mean(-1), min=1e-30)
    return tr, dn, dist, res.rng


def _sum_ri(path: Subpath, k0: int, first_rev, sum_ri=None):
    """The r_i recursion of MISWeight down one subpath from vertex k0:
    sum_i prod (rev / fwd), first_rev the reverse density of vertex k0 and
    the stored ones below it; a strategy that breaks the path at (k-1, k)
    counts only where neither end is a delta lobe."""
    n = path.p.shape[0]
    if sum_ri is None:
        sum_ri = torch.zeros(n, device=path.p.device)
    ri = torch.ones(n, device=path.p.device)
    for k in range(k0, -1, -1):
        fwd = torch.clamp(path.pdf_fwd[:, k], min=1e-20)
        rev = torch.clamp(first_rev if k == k0 else path.pdf_rev[:, k],
                          min=1e-20)
        ri = ri * rev / fwd
        ok = path.valid[:, k] & ~path.spec[:, k]
        if k > 0:
            ok = ok & ~path.spec[:, k - 1]
        sum_ri = sum_ri + torch.where(ok, ri, 0.0)
    return sum_ri


def _mis_weight(cam_path: Subpath, light_path: Subpath, ci: int, li_: int,
                pdf_l_sa, pdf_c_sa, dist, g, inv_area, conv_c=1.0,
                conv_l=1.0):
    """The balance heuristic of an (s >= 2, t >= 2) connection over the
    implemented same-length strategies: the camera side down to its first
    vertex (the t = 1 splat competes), the light side down to s = 1 (the
    NEE connection; s = 0 has pdf 0 for a delta light).  The endpoint
    reverse densities are the connection's scattering pdfs in area
    measure."""
    d2 = torch.clamp(dist ** 2, min=1e-8)
    sum_ri = _sum_ri(cam_path, ci, pdf_l_sa * conv_c / d2)
    sum_ri = _sum_ri(light_path, li_, pdf_c_sa * conv_l / d2, sum_ri)
    return 1.0 / (1.0 + sum_ri)


def _mis_weight_nee(cam_path: Subpath, ci: int, inv_area):
    """The MIS weight of the s = 1 (direct light) strategy: alternatives
    move camera vertices to the light side; the connecting vertex's density
    under the parallel beam is the disk pdf 1/A (inv_area, per lane or a
    number)."""
    n = cam_path.p.shape[0]
    first = torch.as_tensor(inv_area, dtype=torch.float32,
                            device=cam_path.p.device).expand(n)
    return 1.0 / (1.0 + _sum_ri(cam_path, ci, first))


def _mis_weight_t1(light_path: Subpath, li_: int, pdf_cam_area):
    """The MIS weight of the t = 1 (light-tracing splat) strategy:
    alternatives transfer light vertices to the camera side one by one; the
    connecting vertex's reverse density is the camera's directional pdf in
    area measure."""
    return 1.0 / (1.0 + _sum_ri(light_path, li_, pdf_cam_area))


def render_bdpt(scene, max_depth: int = 4, spp: int = 8,
                keep_strategies: bool = True, *, device=None):
    """Render with BDPT; returns ((H, W, 3) numpy image, stats,
    strategy images), the latter mapping (s, t) -> the unweighted strategy
    image and ('w', s, t) -> the MIS-weighted one (empty without
    keep_strategies)."""
    dev = resolve(device)
    scene = scene.to(dev)
    cam = scene.camera
    H, W = cam.height, cam.width
    N = H * W
    med_spec = scene.medium
    assert med_spec is not None, "BDPT targets volumetric scenes"
    homogeneous = med_spec.homogeneous
    maj_res = med_spec.maj_res()
    distant = [lt for lt in scene.lights
               if isinstance(lt, lights_mod.DistantLight)]
    assert distant, "BDPT needs a distant light"
    light = distant[0]
    T_CAM = S_LIGHT = max_depth     # vertices of each subpath

    # surface vertices join both subpaths with their real BSDFs
    opaque = tuple(p for p in scene.primitives if p.material is not None)
    has_surf = len(opaque) > 0

    def mat_fn_of(lam):
        """(mat_fn, mat_static): the per-hit parameter gather and the
        static context the BSDF sampler needs (the wavelengths, the
        measured-BRDF registry, the stochastic-coated flag)."""
        if not has_surf:
            return None, None
        probe = _gather_mat_params(opaque, lam[:1],
                                   torch.zeros((1, 2), device=dev), 1)

        def mat_fn(hit, p_world):
            stacks = _gather_mat_params(opaque, lam, hit.uv, hit.t.shape[0],
                                        p=p_world, n=hit.n)
            mid = torch.clamp(hit.prim_id, 0, len(opaque) - 1)
            prm = {k: _take(v, mid) for k, v in stacks.items()
                   if k not in ("kind", "emissive") and not k.startswith("_")}
            return _take(stacks["kind"], mid), prm

        return mat_fn, {"lam": lam, "measured": probe["_measured_tables"],
                        "coated_stochastic": probe["_coated_stochastic"]}

    def no_hit(a):
        return torch.zeros((a.shape[0],), dtype=torch.bool, device=dev)

    def occluded_between(a, b):
        """Surface occlusion of a connection (the medium's transmittance is
        ratio tracked apart)."""
        if not has_surf:
            return no_hit(a)
        dv = b - a
        dist = torch.sqrt(torch.clamp(vmu.length_squared(dv), min=1e-12))
        dn = dv / dist[:, None]
        return shapes_mod.occluded(opaque, a + dn * _BDPT_EPS, dn,
                                   dist - 2 * _BDPT_EPS)

    def occluded_dir(a, w, dist):
        if not has_surf:
            return no_hit(a)
        return shapes_mod.occluded(opaque, a + w * _BDPT_EPS, w, dist)

    lo = np.asarray(med_spec.bounds_lo, np.float64)
    hi = np.asarray(med_spec.bounds_hi, np.float64)
    center = (lo + hi) / 2
    radius = float(np.linalg.norm(hi - lo)) / 2
    ldir = light.direction.cpu().numpy().astype(np.float64)
    ldir /= np.linalg.norm(ldir)
    lu = np.cross(ldir, [1, 0, 0] if abs(ldir[0]) < 0.9 else [0, 1, 0])
    lu /= np.linalg.norm(lu)
    lv = np.cross(ldir, lu)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    l_center, l_u, l_v = (f32(center - ldir * radius * 2.0), f32(lu),
                          f32(lv))
    l_dir = f32(ldir)
    sun_wi = -l_dir.expand(N, 3)

    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix = torch.as_tensor(np.stack([xs.reshape(-1), ys.reshape(-1)], -1),
                          device=dev)
    pixidx = torch.arange(N, device=dev)
    hi_pix = torch.tensor([W - 1, H - 1], device=dev)
    A = cam.film_area_z1()
    cam_fwd = vmu.normalize(cam.c2w.apply_vector(
        torch.tensor([0.0, 0.0, 1.0], device=dev)))
    cam_pos = cam.position
    inv_area = 1.0 / (np.pi * radius * radius)

    def wave(sample_idx):
        rng = dda.seed_stream(pixidx, torch.full_like(pixidx, sample_idx),
                              salt=scene.seed + 31)
        rng, ua = dda.pcg_uniform(rng)
        rng, ub = dda.pcg_uniform(rng)
        off = scene.filter.sample_offset(torch.stack([ua, ub], -1)) + 0.5
        rng, ul = dda.pcg_uniform(rng)
        swl = sp.sample_wavelengths_visible(ul)
        lam = swl.lam
        LANES = lam.shape[-1]
        med = med_spec.build_arrays(lam)
        g = med.g

        o, d = cam.generate_rays(pix, off)
        # the camera's directional pdf 1 / (A cos^3): the first camera
        # vertex gets a real area pdf, so the t = 1 family enters every
        # MIS weight
        cos0 = torch.clamp((d * cam_fwd[None, :]).sum(-1), 1e-4, 1.0)
        pdf0_cam = 1.0 / (A * cos0 ** 3)
        mat_fn, mat_static = mat_fn_of(lam)
        cam_path, rng, L_emit = _walk(
            med, o, d, torch.ones((N, LANES), device=dev), rng, T_CAM,
            maj_res, homogeneous, pdf0_cam, collect_emission=True,
            prims=opaque, mat_fn=mat_fn, mat_static=mat_static)

        # the light subpath: a point of the disk outside the medium and the
        # light direction; beta0 = Le / (pdf_pos pdf_dir), pdf_pos =
        # 1 / (pi r^2), a delta direction
        rng, ula = dda.pcg_uniform(rng)
        rng, ulb = dda.pcg_uniform(rng)
        disk = sample_uniform_disk_concentric(
            torch.stack([ula, ulb], -1)) * radius
        l_o = (l_center[None, :] + disk[:, 0:1] * l_u[None, :]
               + disk[:, 1:2] * l_v[None, :])
        Le = light.spectrum(lam) * light.scale
        beta0_l = Le.expand(N, LANES) / inv_area
        light_path, rng, _ = _walk(
            med, l_o, l_dir.expand(N, 3), beta0_l, rng, S_LIGHT, maj_res,
            homogeneous, torch.ones((N,), device=dev),
            first_pdf_area=inv_area, prims=opaque, mat_fn=mat_fn,
            adjoint=True, mat_static=mat_static)

        # medium emission seen by the camera subpath: no other strategy
        # samples it, weight 1
        contribs = {(0, 0): (L_emit, L_emit)}
        splats = {}

        # t = 1: light-tracing splats
        for li_ in range(S_LIGHT):
            s_ = li_ + 2
            if s_ - 1 > max_depth:
                break
            pv_l = light_path.p[:, li_]
            raster, cos_t, inside = cam.project(pv_l)
            to_cam = cam_pos[None, :] - pv_l
            dist = torch.sqrt(torch.clamp(vmu.length_squared(to_cam),
                                          min=1e-12))
            wi_c = to_cam / dist[:, None]
            ok = (light_path.valid[:, li_] & inside & (cos_t > 1e-4)
                  & ~occluded_dir(pv_l, wi_c, dist))
            res_tr = transmittance.ratio_track(med, pv_l, wi_c, dist, rng,
                                               ok, maj_res,
                                               homogeneous=homogeneous)
            rng = res_tr.rng
            tr = res_tr.T_ray[:, 0] / torch.clamp(res_tr.r_l.mean(-1),
                                                  min=1e-30)
            # scattering toward the camera in importance transport
            f_l = light_path.f_toward(li_, wi_c, g, adjoint=True)
            cos_lv = light_path.conv_cos(li_, wi_c)
            cos3 = torch.clamp(cos_t, min=1e-4) ** 3
            d2 = torch.clamp(dist ** 2, min=1e-8)
            Wi = 1.0 / (A * cos3 * d2)   # We / pdf_omega
            c_unw = light_path.beta[:, li_] * f_l * (cos_lv * tr
                                                     * Wi)[:, None]
            c_unw = torch.where(ok[:, None], c_unw, 0.0)
            pdf_cam_area = 1.0 / (A * cos3) / d2
            w = _mis_weight_t1(light_path, li_,
                               pdf_cam_area * light_path.conv_cos(li_, wi_c))
            c_w = c_unw * torch.where(ok, w, 0.0)[:, None]
            rast_i = torch.minimum(torch.clamp(raster.long(), min=0), hi_pix)
            splats[(s_, 1)] = (rast_i, c_unw, c_w)

        # (s, t) in pbrt's convention: s light vertices including the
        # light, t camera vertices including the camera
        for t in range(2, T_CAM + 2):
            ci = t - 2
            # s = 1: the camera vertex to the light (NEE)
            if t - 1 <= max_depth:
                pv_c = cam_path.p[:, ci]
                ok = cam_path.valid[:, ci] & ~occluded_dir(
                    pv_c, sun_wi, torch.full((N,), radius * 8.0, device=dev))
                res_tr = transmittance.ratio_track(
                    med, pv_c, sun_wi,
                    torch.full((N,), radius * 4.0, device=dev), rng, ok,
                    maj_res, homogeneous=homogeneous)
                rng = res_tr.rng
                tr1 = res_tr.T_ray[:, 0] / torch.clamp(res_tr.r_l.mean(-1),
                                                       min=1e-30)
                f_c1 = cam_path.f_toward(ci, sun_wi, g)
                cos_cv1 = cam_path.conv_cos(ci, sun_wi)
                c_unw = (cam_path.beta[:, ci] * f_c1
                         * (cos_cv1 * tr1)[:, None] * Le)
                c_unw = torch.where(ok[:, None], c_unw, 0.0)
                w = _mis_weight_nee(cam_path, ci,
                                    inv_area * cam_path.conv_cos(ci, sun_wi))
                contribs[(1, t)] = (c_unw,
                                    c_unw * torch.where(ok, w, 0.0)[:, None])

            # s >= 2: vertex-to-vertex connections, at most max_depth
            # scatters in all
            for s_ in range(2, S_LIGHT + 2):
                if (s_ - 1) + (t - 1) > max_depth:
                    continue
                li_ = s_ - 2
                pv_l = light_path.p[:, li_]
                pv_c = cam_path.p[:, ci]
                ok = (light_path.valid[:, li_] & cam_path.valid[:, ci]
                      & ~occluded_between(pv_c, pv_l))
                tr, dn, dist, rng = _tr_estimate(med, pv_c, pv_l, rng,
                                                 maj_res, homogeneous)
                f_c = cam_path.f_toward(ci, dn, g)
                f_l = light_path.f_toward(li_, -dn, g, adjoint=True)
                conv_c = cam_path.conv_cos(ci, dn)
                conv_l = light_path.conv_cos(li_, -dn)
                G = conv_c * conv_l / torch.clamp(dist ** 2, min=1e-8)
                c_unw = (cam_path.beta[:, ci] * f_c * (tr * G)[:, None]
                         * f_l * light_path.beta[:, li_])
                c_unw = torch.where(ok[:, None], c_unw, 0.0)
                w = _mis_weight(cam_path, light_path, ci, li_,
                                light_path.pdf_toward_sa(li_, -dn, g),
                                cam_path.pdf_toward_sa(ci, dn, g),
                                dist, g, inv_area, conv_c, conv_l)
                contribs[(s_, t)] = (c_unw,
                                     c_unw * torch.where(ok, w, 0.0)[:, None])
        return contribs, splats, swl

    def splat_rgb(acc, rast_i, L, swl):
        """RGBFilm::AddSplat: sensor rgb, scatter-added."""
        rgb = torch.nan_to_num(colorspace.xyz_to_rgb(sp.to_xyz(L, swl)),
                               nan=0.0, posinf=0.0, neginf=0.0)
        acc.index_put_((rast_i[:, 1], rast_i[:, 0]), rgb, accumulate=True)

    film_total = Film.create(H, W, dev)
    films: Dict[Tuple, Film] = {}
    splat_total = torch.zeros((H, W, 3), device=dev)
    splat_films: Dict[Tuple, torch.Tensor] = {}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    with torch.no_grad():
        for sidx in range(spp):
            contribs, splats, swl = wave(sidx)
            total = None
            for key, (c_unw, c_w) in contribs.items():
                total = c_w if total is None else total + c_w
                if keep_strategies:
                    wkey = ("w",) + key
                    if key not in films:
                        films[key] = Film.create(H, W, dev)
                        films[wkey] = Film.create(H, W, dev)
                    films[key] = films[key].add_samples(pix, c_unw, swl)
                    films[wkey] = films[wkey].add_samples(pix, c_w, swl)
            film_total = film_total.add_samples(pix, total, swl)
            for key, (rast_i, c_unw, c_w) in splats.items():
                splat_rgb(splat_total, rast_i, c_w, swl)
                if keep_strategies:
                    wkey = ("w",) + key
                    if key not in splat_films:
                        splat_films[key] = torch.zeros((H, W, 3), device=dev)
                        splat_films[wkey] = torch.zeros((H, W, 3),
                                                        device=dev)
                    splat_rgb(splat_films[key], rast_i, c_unw, swl)
                    splat_rgb(splat_films[wkey], rast_i, c_w, swl)
        # the weighted samples plus the splat plane / spp
        img = (film_total.to_image() + splat_total / spp).cpu().numpy()
    dt = time.time() - t0
    strategy_imgs = {k: f.to_image().cpu().numpy() for k, f in films.items()}
    for k, s_img in splat_films.items():
        strategy_imgs[k] = (s_img / spp).cpu().numpy()
    return img, {"render_time": dt, "spp": spp}, strategy_imgs


def write_strategy_films(strategy_imgs, out_dir: str, depth: int):
    """Write bdpt_dDD_sSS_tTT.exr (pbrt's naming) into out_dir/weights and
    out_dir/no_weights_L."""
    from ...utils import image

    os.makedirs(os.path.join(out_dir, "weights"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "no_weights_L"), exist_ok=True)
    for key, img in strategy_imgs.items():
        if key[0] == "w":
            _, s, t = key
            sub = "weights"
        else:
            s, t = key
            sub = "no_weights_L"
        name = f"bdpt_d{depth:02d}_s{s:02d}_t{t:02d}.exr"
        image.write_exr(os.path.join(out_dir, sub, name), img)
