"""Surface path integrators: Path (NEE + MIS), SimplePath, RandomWalk and AO
(port of acceleratedvolrenderer_tpu/models/integrators/path.py).

Every ray bounces in lockstep through a python loop over max_depth;
material polymorphism is masked evaluation over the static BxDF families
(models/bxdfs.py), gathered from per-primitive parameter stacks.  Draws
come through a uniform source, in the reference's order: a `PCGSource` over
the per-ray PCG streams, or for `li_path` a samplers.PathSampler or the MLT
integrator's `VectorSource`.  A measured material's lanes go through its
BRDF's tables (models/measured.py, one registry slot per distinct BRDF);
a subsurface hit samples an exit point (models/bssrdf.py) and continues
from it as a Lambertian vertex.
"""
from __future__ import annotations

import numpy as np
import torch

from ...ops import dda
from ...ops import warps
from ...utils import vecmath as vmu
from .. import bxdfs
from .. import lights as lights_mod
from .. import materials as materials_mod
from .. import shapes as shapes_mod

_SURF_EPS = 1e-4


class PCGSource:
    """Draws from the per-ray PCG streams (ops/dda.py counters)."""

    def __init__(self, rng):
        self.rng = rng

    def next(self, mask=None):
        if mask is None:
            self.rng, u = dda.pcg_uniform(self.rng)
        else:
            self.rng, u = dda.pcg_uniform_masked(self.rng, mask)
        return u


class VectorSource:
    """Draws column after column from a fixed primary-sample vector (N, D),
    the PSSMLT sample space (pbrt's MLTSampler); past the last column it
    repeats it.  The mask is ignored: every lane consumes every draw."""

    def __init__(self, u_vec):
        self.u = u_vec
        self.idx = 0

    def next(self, mask=None):
        u = self.u[:, min(self.idx, self.u.shape[1] - 1)]
        self.idx += 1
        return u


def _uv_hash(uv):
    """MixMaterial's per-hit choice value in [0, 1): the reference's uint32
    hash of the uv, in int64 arithmetic masked to 32 bits."""
    m32 = 0xFFFFFFFF
    u = (uv[..., 0] * 65535).to(torch.int64) & m32
    v = (uv[..., 1] * 65535).to(torch.int64) & m32
    bits = ((u * 73856093) & m32) ^ ((v * 19349663) & m32)
    return (bits % 65536).to(torch.float32) / 65536.0


def _mat_param_row(m, lam, uv, N, p=None, n=None, mreg=None):
    """The parameters of ONE material at the hit points, each (N, ...);
    MixMaterial resolves per lane by hashing the hit uv against `amount`
    (materials.h MixMaterial::ChooseMaterial).  mreg maps id(measured
    BRDF) to its registry slot."""
    dev = lam.device
    L = lam.shape[-1]
    zeros_s = torch.zeros((N, L), device=dev)
    if isinstance(m, materials_mod.MixMaterial):
        a = _mat_param_row(m.m1, lam, uv, N, p, n, mreg)
        b = _mat_param_row(m.m2, lam, uv, N, p, n, mreg)
        h = (_uv_hash(uv) if uv is not None
             else torch.zeros((N,), device=dev))
        pick_a = h < m.amount
        return {k: torch.where(pick_a if a[k].dim() == 1 else pick_a[:, None],
                               a[k], b[k]) for k in a}
    kind = getattr(m, "kind", materials_mod.KIND_DIFFUSE)
    ed = getattr(m, "eta", 1.5)
    spectral = lambda v: materials_mod._eval_spectral(v, lam, uv, p, n)
    full = lambda v: torch.full((N,), float(v), device=dev)
    conductor = kind == materials_mod.KIND_CONDUCTOR
    if kind == materials_mod.KIND_SUBSURFACE:
        rgb = lambda v: torch.as_tensor(
            np.asarray(v, np.float32), device=dev).expand(N, 3)
        ss_albedo, ss_ell = rgb(m.reflectance_rgb), rgb(m.mfp_rgb)
    else:
        ss_albedo = torch.zeros((N, 3), device=dev)
        ss_ell = torch.full((N, 3), 1e-3, device=dev)
    slot = -1
    if kind == materials_mod.KIND_MEASURED and mreg is not None:
        slot = mreg.get(id(m.brdf), -1)
    return dict(
        kind=torch.full((N,), int(kind), dtype=torch.int64, device=dev),
        measured_slot=torch.full((N,), slot, dtype=torch.int64, device=dev),
        ss_albedo=ss_albedo, ss_ell=ss_ell,
        albedo=spectral(getattr(m, "reflectance", None)),
        refl=spectral(getattr(m, "reflectance", None)),
        trans=spectral(getattr(m, "transmittance", None)),
        eta_c=spectral(getattr(m, "eta", None)) if conductor else zeros_s,
        k_c=spectral(getattr(m, "k", None)) if conductor else zeros_s,
        eta_d=full(ed if isinstance(ed, (int, float)) else 1.5),
        alpha=materials_mod._eval_float(getattr(m, "roughness", 0.0), uv,
                                        (N,), p, n, device=dev),
        ct_thick=full(getattr(m, "thickness", 0.01)),
        ct_g=full(getattr(m, "g", 0.0)),
        ct_stoch=torch.full((N,), bool(getattr(m, "stochastic", False)),
                            device=dev),
        ct_alb=(spectral(m.albedo_med)
                if getattr(m, "albedo_med", None) is not None else zeros_s),
        emission=(spectral(m.emission) * m.emission_scale if m.emissive
                  else zeros_s),
    )


def _any_stochastic(m):
    if isinstance(m, materials_mod.MixMaterial):
        return _any_stochastic(m.m1) or _any_stochastic(m.m2)
    return bool(getattr(m, "stochastic", False))


def _collect_measured(m, registry):
    """Add m's measured BRDFs (through MixMaterials) to registry, a pair
    ({id(brdf): slot}, [brdf, ...])."""
    if isinstance(m, materials_mod.MixMaterial):
        _collect_measured(m.m1, registry)
        _collect_measured(m.m2, registry)
    elif getattr(m, "kind", None) == materials_mod.KIND_MEASURED:
        if id(m.brdf) not in registry[0]:
            registry[0][id(m.brdf)] = len(registry[1])
            registry[1].append(m.brdf)


def _gather_mat_params(opaque, lam, uv, N, p=None, n=None):
    """Per-primitive parameter stacks: a dict of (M, N, ...) tensors, with
    `kind` per lane (M, N) so a MixMaterial resolves per hit; the python
    `emissive` flags; and, under keys starting with "_", python objects:
    `_measured_tables` (the measured BRDFs by registry slot) and
    `_coated_stochastic`."""
    registry = ({}, [])
    for pr in opaque:
        _collect_measured(pr.material, registry)
    rows = [_mat_param_row(pr.material, lam, uv, N, p, n, registry[0])
            for pr in opaque]
    out = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    out["emissive"] = [bool(pr.material.emissive) for pr in opaque]
    out["_measured_tables"] = tuple(registry[1])
    out["_coated_stochastic"] = any(_any_stochastic(pr.material)
                                    for pr in opaque)
    return out


def _take(arr, idx):
    return arr[idx, torch.arange(idx.shape[0], device=idx.device)]


def _select(samples, kinds, kind_ids):
    """Per-lane choice among BSDFSamples by material kind (the first is
    the default)."""
    out = samples[0]
    for s, kid in zip(samples[1:], kinds[1:]):
        sel = kind_ids == kid
        out = bxdfs.BSDFSample(*(torch.where(
            sel[:, None] if a.dim() == 2 else sel, a, b)
            for a, b in zip(s, out)))
    return out


_KINDS = (materials_mod.KIND_DIFFUSE, materials_mod.KIND_CONDUCTOR,
          materials_mod.KIND_DIELECTRIC, materials_mod.KIND_THIN_DIELECTRIC,
          materials_mod.KIND_DIFFUSE_TRANSMISSION,
          materials_mod.KIND_COATED_DIFFUSE)


def _bsdf_sample(kind_ids, prm, wo_l, u_lobe, u2, lam=None, measured=(),
                 coated_stochastic=False):
    """Masked-select BSDF sampling over the static lobe families; the
    lanes of measured registry slot i sample measured[i] (at lam)."""
    s_dif = bxdfs.diffuse_sample(wo_l, u2, prm["albedo"])
    s_con = bxdfs.conductor_sample(wo_l, u2, prm["eta_c"], prm["k_c"],
                                   prm["alpha"])
    s_die = bxdfs.dielectric_sample(wo_l, u_lobe, u2, prm["eta_d"],
                                    prm["alpha"])
    s_thn = bxdfs.thin_dielectric_sample(wo_l, u_lobe, prm["eta_d"])
    s_dft = bxdfs.diffuse_transmission_sample(wo_l, u_lobe, u2, prm["refl"],
                                              prm["trans"])
    s_cod = bxdfs.coated_diffuse_sample(wo_l, u_lobe, u2, prm["albedo"],
                                        prm["eta_d"], prm["alpha"])
    if coated_stochastic:
        # the reference's LayeredBxDF walk: a counter stream hashed from the
        # primary draws keeps the walk deterministic per (pixel, sample)
        to_u32 = lambda x: (x * (1 << 24)).to(torch.int64)
        rng_w = dda.seed_stream(to_u32(u_lobe), to_u32(u2[..., 0]),
                                salt=0xC0A7)
        rng_w = rng_w ^ to_u32(u2[..., 1])
        s_walk, _ = bxdfs.layered_sample(
            wo_l, rng_w, prm["albedo"], prm["eta_d"], prm["alpha"],
            thickness=prm["ct_thick"], g=prm["ct_g"],
            med_albedo=prm["ct_alb"])
        # the walk's (f, pdf) is the unbiased weight; rescale so the pdf
        # reported for MIS is the analytic mixture's
        pdf_mis = bxdfs.coated_diffuse_pdf(wo_l, s_walk.wi, prm["eta_d"],
                                           prm["alpha"])
        conv = ~s_walk.specular & (s_walk.pdf > 0) & (pdf_mis > 0)
        f_adj = torch.where(conv[:, None], s_walk.f * (
            pdf_mis / torch.clamp(s_walk.pdf, min=1e-30))[:, None], s_walk.f)
        s_wsel = s_walk._replace(f=f_adj,
                                 pdf=torch.where(conv, pdf_mis, s_walk.pdf))
        # only materials with stochastic=True take the walk
        stoch = prm["ct_stoch"]
        s_cod = bxdfs.BSDFSample(*(torch.where(
            stoch[:, None] if a.dim() == 2 else stoch, a, b)
            for a, b in zip(s_wsel, s_cod)))
    out = _select([s_dif, s_con, s_die, s_thn, s_dft, s_cod], _KINDS,
                  kind_ids)
    if measured and lam is not None:
        from .. import measured as measured_mod

        for slot, brdf in enumerate(measured):
            sel = _measured_lanes(kind_ids, prm, slot)
            wi_m, f_m, p_m, valid_m = measured_mod.measured_sample(
                brdf, wo_l, u2, lam)
            out = bxdfs.BSDFSample(
                torch.where(sel[:, None], wi_m, out.wi),
                torch.where(sel[:, None], f_m, out.f),
                torch.where(sel, torch.where(valid_m, p_m, 0.0), out.pdf),
                torch.where(sel, False, out.specular),
                torch.where(sel, 1.0, out.eta_scale),
                torch.where(sel, False, out.transmitted))
    return out


def _measured_lanes(kind_ids, prm, slot):
    return ((kind_ids == materials_mod.KIND_MEASURED)
            & (prm["measured_slot"] == slot))


def _bsdf_f_pdf(kind_ids, prm, wo_l, wi_l, lam=None, measured=()):
    """Masked-select f and pdf over the lobe families (delta lobes: 0);
    the lanes of measured registry slot i evaluate measured[i]."""
    f_dif = bxdfs.diffuse_f(wo_l, wi_l, prm["albedo"])
    p_dif = bxdfs.diffuse_pdf(wo_l, wi_l)
    f_con = bxdfs.conductor_f(wo_l, wi_l, prm["eta_c"], prm["k_c"],
                              prm["alpha"])
    p_con = bxdfs.conductor_pdf(wo_l, wi_l, prm["alpha"])
    f_die = bxdfs.dielectric_f(wo_l, wi_l, prm["eta_d"], prm["alpha"])
    p_die = bxdfs.dielectric_pdf(wo_l, wi_l, prm["eta_d"], prm["alpha"])
    pr = torch.amax(prm["refl"], -1)
    pt = torch.amax(prm["trans"], -1)
    f_dft = bxdfs.diffuse_transmission_f(wo_l, wi_l, prm["refl"],
                                         prm["trans"])
    p_dft = bxdfs.diffuse_transmission_pdf(wo_l, wi_l, pr, pt)
    f_cod = bxdfs.coated_diffuse_f(wo_l, wi_l, prm["albedo"], prm["eta_d"],
                                   prm["alpha"])
    p_cod = bxdfs.coated_diffuse_pdf(wo_l, wi_l, prm["eta_d"], prm["alpha"])
    fs = [f_dif, f_con, f_die, torch.zeros_like(f_dif), f_dft, f_cod]
    ps = [p_dif, p_con, p_die, torch.zeros_like(p_dif), p_dft, p_cod]
    f, p = fs[0], ps[0]
    for fi, pi, kid in zip(fs[1:], ps[1:], _KINDS[1:]):
        sel = kind_ids == kid
        f = torch.where(sel[:, None], fi, f)
        p = torch.where(sel, pi, p)
    if measured and lam is not None:
        from .. import measured as measured_mod

        for slot, brdf in enumerate(measured):
            sel = _measured_lanes(kind_ids, prm, slot)
            f = torch.where(sel[:, None],
                            measured_mod.measured_f(brdf, wo_l, wi_l, lam), f)
            p = torch.where(sel, measured_mod.measured_pdf(brdf, wo_l, wi_l),
                            p)
    return f, p


def scene_lights_with_area(lights, prims):
    """scene.lights plus a DiffuseAreaLight over every emissive primitive:
    the lights NEE samples (pbrt turns emissive shapes into area lights)."""
    out = list(lights)
    for p in prims:
        if p.material is not None and p.material.emissive:
            out.append(lights_mod.DiffuseAreaLight(
                shape=p, spectrum=p.material.emission,
                scale=p.material.emission_scale))
    return out


def _power_heuristic(pf, pg):
    pf2 = pf * pf
    return torch.where(pf > 0, pf2 / torch.clamp(pf2 + pg * pg, min=1e-20),
                       0.0)


def _side(n, w):
    """+-_SURF_EPS: the offset along n to the side w points to."""
    return torch.where(vmu.dot(n, w) > 0, _SURF_EPS, -_SURF_EPS)[:, None]


def _subsurface_exit(src, opaque, hit, mid, p_hit, wo, surf, kind_ids, prm,
                     lam, tab):
    """The subsurface branch of li_path (SeparableBSSRDF exit sampling,
    cpu/integrators.cpp:526-592, reshaped): a subsurface hit moves to a
    profile-sampled exit point on the same primitive and goes on as a
    Lambertian vertex whose albedo carries (1 - F(wo)) and the
    channel-MIS profile weight, Smits-converted.  Draws u_ch, u_r, u_phi
    on the subsurface lanes; updates prm["albedo"] in place and returns
    (p_hit, hit, kind_ids)."""
    from .. import bssrdf as bssrdf_mod
    from ...utils import spectrum as sp

    is_ss = surf & (kind_ids == materials_mod.KIND_SUBSURFACE)
    u_ch = src.next(is_ss)
    u_r = src.next(is_ss)
    u_phi = src.next(is_ss)
    n_entry = vmu.face_forward(hit.n, wo)
    if tab is not None:
        exit_p, exit_n, w_rgb, _ = bssrdf_mod.sample_exit_tabulated(
            opaque, mid, p_hit, n_entry, tab, u_ch, u_r, u_phi)
    else:
        exit_p, exit_n, w_rgb, _ = bssrdf_mod.sample_exit(
            opaque, mid, p_hit, n_entry, prm["ss_albedo"], prm["ss_ell"],
            u_ch, u_r, u_phi)
    f_o = bxdfs.fresnel_dielectric(torch.abs(vmu.dot(n_entry, wo)),
                                   prm["eta_d"])
    w_spec = (sp.rgb_to_spectrum_smits_batched(
        torch.clamp(w_rgb, min=0.0), lam) * (1.0 - f_o)[:, None])
    ss3 = is_ss[:, None]
    prm["albedo"] = torch.where(ss3, w_spec, prm["albedo"])
    return (torch.where(ss3, exit_p, p_hit),
            hit._replace(n=torch.where(ss3, exit_n, hit.n)),
            torch.where(is_ss, materials_mod.KIND_DIFFUSE, kind_ids))


def li_path(prims: tuple, lights: list, o, d, lam, rng, *, max_depth: int = 5,
            light_strategy: str = "uniform", regularize: bool = False,
            uniform_source=None, nee: bool = True, mis: bool = True):
    """PathIntegrator Li (cpu/integrators.cpp PathIntegrator::Li /
    SampleLd): returns (L, rng), rng the draws' source's advanced stream.
    uniform_source: where the draws come from, a PCGSource over rng by
    default, or a samplers.PathSampler (the low-discrepancy path
    dimensions).  nee=False is SimplePath's BSDF-sampling mode, mis=False
    with nee its light-sampling mode."""
    N = o.shape[0]
    dev = o.device
    opaque = tuple(p for p in prims if p.material is not None)
    assert opaque, "li_path requires opaque primitives"
    src = uniform_source if uniform_source is not None else PCGSource(rng)
    lights_all = scene_lights_with_area(lights, opaque)
    emitters = tuple(pp for pp in opaque if pp.material.emissive)
    non_emitters = tuple(pp for pp in opaque if not pp.material.emissive)
    ss_mats = [pp.material for pp in opaque
               if getattr(pp.material, "kind", 0)
               == materials_mod.KIND_SUBSURFACE]
    ss_tab = None
    # the tabulated beam diffusion profile when the scene's one subsurface
    # material asks for it; several subsurface materials take Burley's
    if len(ss_mats) == 1 and getattr(ss_mats[0], "profile",
                                     "burley") == "tabulated":
        from .. import bssrdf as bssrdf_mod

        m0 = ss_mats[0]
        ss_tab = bssrdf_mod.tabulated_channel_arrays(
            bssrdf_mod.compute_beam_diffusion_table(
                g=float(getattr(m0, "g", 0.0)), eta=float(m0.eta)),
            np.asarray(m0.reflectance_rgb), np.asarray(m0.mfp_rgb), dev)

    L = torch.zeros_like(lam)
    beta = torch.ones_like(lam)
    alive = torch.ones((N,), dtype=torch.bool, device=dev)
    spec_prev = torch.ones((N,), dtype=torch.bool, device=dev)  # the camera
    pdf_prev = torch.ones((N,), device=dev)
    eta_scale = torch.ones((N,), device=dev)
    o_cur, d_cur = o, d

    def emitted_weight(pdf_l):
        """The weight of a path-sampled emitter: no NEE -> 1; NEE without
        MIS -> only after a delta bounce; with MIS the power heuristic."""
        if not nee:
            return torch.ones((N,), device=dev)
        if not mis:
            return torch.where(spec_prev, 1.0, 0.0)
        return torch.where(spec_prev, 1.0,
                           _power_heuristic(pdf_prev, pdf_l()))

    for depth in range(max_depth + 1):
        hit = shapes_mod.intersect_all(opaque, o_cur, d_cur, torch.inf)
        escaped = alive & ~torch.isfinite(hit.t)

        # ---- escaped: infinite lights, MIS against NEE of the same ----
        Le_inf, _ = lights_mod.escaped_radiance(lights, d_cur, lam)
        w_esc = emitted_weight(lambda: lights_mod.pdf_one_light(
            lights_all, o_cur, d_cur, light_strategy))
        L = L + torch.where(escaped[:, None], beta * Le_inf * w_esc[:, None],
                            0.0)

        surf = alive & torch.isfinite(hit.t)
        mid = torch.clamp(hit.prim_id, 0, len(opaque) - 1)
        p_hit = o_cur + hit.t[:, None] * d_cur
        wo = -d_cur
        stacks = _gather_mat_params(opaque, lam, hit.uv, N, p=p_hit,
                                    n=hit.n)
        kind_ids = _take(stacks["kind"], mid)
        prm = {k: _take(v, mid) for k, v in stacks.items()
               if k not in ("kind", "emissive") and not k.startswith("_")}
        emissive_mask = torch.tensor(stacks["emissive"], device=dev)[mid]
        measured = stacks["_measured_tables"]
        if ss_mats:
            p_hit, hit, kind_ids = _subsurface_exit(
                src, opaque, hit, mid, p_hit, wo, surf, kind_ids, prm, lam,
                ss_tab)

        # ---- an emissive hit (one-sided), MIS against NEE ----
        hit_emit = surf & emissive_mask & (vmu.dot(hit.n, wo) > 0)
        w_emit = emitted_weight(lambda: lights_mod.pdf_one_light(
            lights_all, o_cur, d_cur, light_strategy))
        L = L + torch.where(hit_emit[:, None],
                            beta * prm["emission"] * w_emit[:, None], 0.0)
        if depth == max_depth:
            break

        shade = surf & ~emissive_mask
        n_g = hit.n
        # the local frame on the geometric normal (two-sided lobes handle a
        # wo below the horizon)
        bx, by, bz = vmu.frame_from_z(n_g)
        wo_l = vmu.to_local(bx, by, bz, wo)

        # ---- NEE ----
        if nee:
            u1 = src.next(shade)
            u2 = torch.stack([src.next(shade), src.next(shade)], -1)
            ls, is_delta = lights_mod.sample_one_light(
                lights_all, p_hit + n_g * _side(n_g, wo), u1, u2, lam,
                strategy=light_strategy)
            wi_l_nee = vmu.to_local(bx, by, bz, ls.wi)
            f_nee, pdf_b_nee = _bsdf_f_pdf(kind_ids, prm, wo_l, wi_l_nee,
                                           lam, measured)
            if stacks["_coated_stochastic"]:
                # stochastic coated lanes evaluate the slab-aware layered
                # BRDF that their walk samples (the reference's
                # LayeredBxDF::f)
                ct_lanes = (shade & (kind_ids
                                     == materials_mod.KIND_COATED_DIFFUSE)
                            & prm["ct_stoch"])
                to_u32 = lambda x: (x * (1 << 24)).to(torch.int64)
                rng_f = dda.seed_stream(to_u32(src.next(ct_lanes)),
                                        to_u32(src.next(ct_lanes)),
                                        salt=0xF1A7)
                f_walk, _ = bxdfs.layered_f(
                    wo_l, wi_l_nee, rng_f, prm["albedo"], prm["eta_d"],
                    prm["alpha"], thickness=prm["ct_thick"], g=prm["ct_g"],
                    med_albedo=prm["ct_alb"])
                f_nee = torch.where(ct_lanes[:, None], f_walk, f_nee)
            cos_nee = torch.abs(wi_l_nee[..., 2])
            p_off = p_hit + n_g * _side(n_g, ls.wi)
            occl = shapes_mod.occluded(non_emitters, p_off, ls.wi, ls.dist)
            # emitters occlude each other's NEE too; the sampled light's own
            # distance is shortened by DiffuseAreaLight (dist * (1 - 1e-3))
            for pp in emitters:
                t_e, _, _ = pp.intersect(p_off, ls.wi, ls.dist)
                occl = occl | torch.isfinite(t_e)
            w_nee = (torch.ones((N,), device=dev) if not mis
                     else torch.where(is_delta, 1.0, _power_heuristic(
                         ls.pdf, pdf_b_nee)))
            ok = (shade & ls.valid & (ls.pdf > 0) & ~occl
                  & (f_nee > 0).any(-1))
            contrib = (beta * f_nee * cos_nee[:, None] * ls.L
                       * (w_nee / torch.clamp(ls.pdf, min=1e-20))[:, None])
            L = L + torch.where(ok[:, None], contrib, 0.0)

        # ---- BSDF sampling ----
        u_lobe = src.next(shade)
        u2b = torch.stack([src.next(shade), src.next(shade)], -1)
        prm_s = prm
        if regularize:
            # pbrt BSDF::Regularize: widen near-specular lobes after a
            # non-specular bounce
            prm_s = dict(prm, alpha=torch.where(
                spec_prev, prm["alpha"], torch.clamp(prm["alpha"], min=0.3)))
        bs = _bsdf_sample(kind_ids, prm_s, wo_l, u_lobe, u2b, lam, measured,
                          coated_stochastic=stacks["_coated_stochastic"])
        cos_b = torch.abs(bs.wi[..., 2])
        ok_b = shade & (bs.pdf > 0) & (bs.f > 0).any(-1)
        beta_new = beta * bs.f * (cos_b / torch.clamp(bs.pdf,
                                                      min=1e-20))[:, None]
        wi_w = vmu.from_local(bx, by, bz, bs.wi)

        # Russian roulette on beta * etaScale
        eta_scale_new = eta_scale * bs.eta_scale
        rr_beta = torch.amax(beta_new, -1) * eta_scale_new
        do_rr = ok_b & (depth > 1) & (rr_beta < 1.0)
        q = torch.clamp(1.0 - rr_beta, 0.0, 0.95)
        killed = do_rr & (src.next(do_rr) < q)
        beta_new = torch.where((do_rr & ~killed)[:, None],
                               beta_new / torch.clamp(1.0 - q,
                                                      min=1e-6)[:, None],
                               beta_new)

        alive = ok_b & ~killed
        a3 = alive[:, None]
        beta = torch.where(a3, beta_new, beta)
        eta_scale = torch.where(alive, eta_scale_new, eta_scale)
        o_cur = torch.where(a3, p_hit + n_g * _side(n_g, wi_w), o_cur)
        d_cur = torch.where(a3, wi_w, d_cur)
        spec_prev = torch.where(alive, bs.specular, spec_prev)
        pdf_prev = torch.where(alive, bs.pdf, pdf_prev)
    # a VectorSource has no stream: rng comes back as it went in
    return L, getattr(src, "rng", rng)


def li_random_walk(prims, lights, o, d, lam, rng, *, max_depth=5):
    """RandomWalkIntegrator (cpu/integrators.cpp:114): uniform-sphere
    directions, emitted light only."""
    N = o.shape[0]
    opaque = tuple(p for p in prims if p.material is not None)
    src = PCGSource(rng)
    L = torch.zeros_like(lam)
    beta = torch.ones_like(lam)
    alive = torch.ones((N,), dtype=torch.bool, device=o.device)
    o_cur, d_cur = o, d
    for depth in range(max_depth + 1):
        hit = shapes_mod.intersect_all(opaque, o_cur, d_cur, torch.inf)
        escaped = alive & ~torch.isfinite(hit.t)
        Le_inf, _ = lights_mod.escaped_radiance(lights, d_cur, lam)
        L = L + torch.where(escaped[:, None], beta * Le_inf, 0.0)
        surf = alive & torch.isfinite(hit.t)
        mid = torch.clamp(hit.prim_id, 0, len(opaque) - 1)
        p_hit = o_cur + hit.t[:, None] * d_cur
        wo = -d_cur
        stacks = _gather_mat_params(opaque, lam, hit.uv, N, p=p_hit,
                                    n=hit.n)
        emissive_mask = torch.tensor(stacks["emissive"], device=o.device)[mid]
        emission = _take(stacks["emission"], mid)
        albedo = _take(stacks["albedo"], mid)
        front = vmu.dot(hit.n, wo) > 0
        L = L + torch.where((surf & emissive_mask & front)[:, None],
                            beta * emission, 0.0)
        if depth == max_depth:
            break
        shade = surf & ~emissive_mask
        u2 = torch.stack([src.next(shade), src.next(shade)], -1)
        wi = warps.sample_uniform_sphere(u2)
        cos_w = torch.abs(vmu.dot(wi, hit.n))
        # the diffuse BRDF reflects only: f = 0 when wi crosses the surface
        same = (vmu.dot(wi, hit.n) * vmu.dot(wo, hit.n)) > 0
        f = albedo / np.pi
        beta = torch.where(
            shade[:, None],
            beta * f * (cos_w / warps.UNIFORM_SPHERE_PDF)[:, None], beta)
        o_cur = torch.where(shade[:, None], p_hit + hit.n * _side(hit.n, wi),
                            o_cur)
        d_cur = torch.where(shade[:, None], wi, d_cur)
        alive = shade & same
    return L, src.rng


def li_ao(prims, lights, o, d, lam, rng, *, max_distance=float("inf"),
          cos_sample=True, illuminant_scale=1.0):
    """AOIntegrator (cpu/integrators.cpp:296): cosine-weighted visibility."""
    N = o.shape[0]
    dev = o.device
    opaque = tuple(p for p in prims if p.material is not None)
    src = PCGSource(rng)
    hit = shapes_mod.intersect_all(opaque, o, d, torch.inf)
    surf = torch.isfinite(hit.t)
    p_hit = o + hit.t[:, None] * d
    n_f = vmu.face_forward(hit.n, -d)
    u2 = torch.stack([src.next(surf), src.next(surf)], -1)
    if cos_sample:
        local = warps.sample_cosine_hemisphere(u2)
        pdf = torch.clamp(local[..., 2], min=1e-9) / np.pi
    else:
        local = warps.sample_uniform_hemisphere(u2)
        pdf = torch.full((N,), warps.UNIFORM_HEMISPHERE_PDF, device=dev)
    bx, by, bz = vmu.frame_from_z(n_f)
    wi = vmu.from_local(bx, by, bz, local)
    occ = shapes_mod.occluded(opaque, p_hit + n_f * _SURF_EPS, wi,
                              torch.full((N,), max_distance, device=dev))
    cos_w = torch.clamp(vmu.dot(wi, n_f), min=0.0)
    a = torch.where(surf & ~occ, cos_w / (np.pi * pdf), 0.0)
    return a[:, None] * torch.ones_like(lam) * illuminant_scale, src.rng
