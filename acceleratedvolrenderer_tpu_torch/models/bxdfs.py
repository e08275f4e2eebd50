"""BxDFs: surface scattering lobes, batched over rays in local frames
(port of acceleratedvolrenderer_tpu/models/bxdfs.py).

pbrt's conventions: wo and wi point away from the surface, the local frame
has the normal at +z, cos_theta(w) = w.z.  Spectral values carry a trailing
wavelength axis.  Every lobe family is a branch-free function of (N,)
batched local directions; the integrators select per lane by material kind.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import vecmath as vm
from ..utils.math import safe_sqrt

INV_PI = 1.0 / np.pi


def _t(x, like):
    """x as a float32 tensor on like's device (a number becomes a 0-d
    tensor, filled on the device rather than copied to it)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def _unit(v):
    """v / max(|v|, 1e-12) over the last axis, and |v|."""
    n = torch.sqrt(vm.dot(v, v))[..., None]
    return v / torch.clamp(n, min=1e-12), n[..., 0]


def _flip_z(w, s):
    """w with its z component multiplied by s (..., 1)."""
    return torch.cat([w[..., :2], w[..., 2:3] * s], -1)


def _mirror(wo):
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)


def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def same_hemisphere(wa, wb):
    return wa[..., 2] * wb[..., 2] > 0


def reflect(wo, n):
    return -wo + 2.0 * vm.dot(wo, n)[..., None] * n


def refract(wi, n, eta):
    """Snell refraction of wi about n.  Returns (ok, wt, etap), etap the
    relative index of the transmission side."""
    eta = _t(eta, wi)
    cos_i = vm.dot(wi, n)
    flip = cos_i < 0
    cos_i = torch.abs(cos_i)
    n = torch.where(flip[..., None], -n, n)
    eta_p = torch.where(flip, 1.0 / eta, eta)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = sin2_i / (eta_p * eta_p)
    tir = sin2_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    wt = -wi / eta_p[..., None] + (cos_i / eta_p - cos_t)[..., None] * n
    return ~tir, wt, eta_p


def fresnel_dielectric(cos_i, eta):
    """Unpolarized Fresnel reflectance, real eta (pbrt FrDielectric)."""
    eta = _t(eta, cos_i)
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    flip = cos_i < 0
    cos_i = torch.abs(cos_i)
    eta = torch.where(flip, 1.0 / eta, eta)
    sin2_i = 1.0 - cos_i * cos_i
    sin2_t = sin2_i / (eta * eta)
    tir = sin2_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    r_par = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t,
                                                min=1e-12)
    r_per = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t,
                                                min=1e-12)
    F = 0.5 * (r_par * r_par + r_per * r_per)
    return torch.where(tir, 1.0, F)


def fresnel_conductor(cos_i, eta, k):
    """Unpolarized conductor Fresnel with complex IOR eta - i k (exact
    complex arithmetic, elementwise; eta and k may be spectral)."""
    cos_i = torch.clamp(torch.abs(cos_i), 0.0, 1.0)
    eta_c = torch.complex(_t(eta, cos_i), -_t(k, cos_i))
    zero = torch.zeros_like(cos_i)
    cos_i_c = torch.complex(cos_i, zero)
    sin2 = torch.complex(1.0 - cos_i * cos_i, zero)
    sin2_t = sin2 / (eta_c * eta_c)
    cos_t = torch.sqrt(1.0 - sin2_t)
    r_par = (eta_c * cos_i_c - cos_t) / (eta_c * cos_i_c + cos_t)
    r_per = (cos_i_c - eta_c * cos_t) / (cos_i_c + eta_c * cos_t)
    return 0.5 * (torch.abs(r_par) ** 2 + torch.abs(r_per) ** 2)


# --------------------------------------------------------------------------
# Trowbridge-Reitz (GGX) microfacet distribution, isotropic
# --------------------------------------------------------------------------

def _tr_d(wm, alpha):
    """Normal distribution D(wm), upper hemisphere."""
    c2 = torch.clamp(wm[..., 2] * wm[..., 2], min=1e-12)
    t2 = (1.0 - c2) / c2
    a2 = alpha * alpha
    denom = np.pi * a2 * c2 * c2 * (1.0 + t2 / a2) ** 2
    return torch.where(wm[..., 2] > 0, 1.0 / torch.clamp(denom, min=1e-24),
                       0.0)


def tr_lambda(w, alpha):
    c2 = torch.clamp(w[..., 2] * w[..., 2], min=1e-12)
    t2 = (1.0 - c2) / c2
    return 0.5 * (safe_sqrt(1.0 + alpha * alpha * t2) - 1.0)


def tr_g1(w, alpha):
    return 1.0 / (1.0 + tr_lambda(w, alpha))


def tr_g(wo, wi, alpha):
    return 1.0 / (1.0 + tr_lambda(wo, alpha) + tr_lambda(wi, alpha))


def tr_d_visible(w, wm, alpha):
    """Visible-normal density D_w(wm) = G1(w) D(wm) |w.wm| / |cos w|."""
    return (tr_g1(w, alpha) / torch.clamp(abs_cos_theta(w), min=1e-7)
            * _tr_d(wm, alpha) * torch.abs(vm.dot(w, wm)))


def tr_sample_wm(w, u2, alpha):
    """Sample a visible microfacet normal (Heitz 2018 VNDF, pbrt-v4
    TrowbridgeReitzDistribution::Sample_wm)."""
    alpha = _t(alpha, w)
    wh = torch.stack([alpha * w[..., 0], alpha * w[..., 1], w[..., 2]], -1)
    wh = wh * torch.sign(wh[..., 2:3] + 1e-30)
    wh, _ = _unit(wh)
    near_z = (torch.abs(wh[..., 2]) < 0.999).to(torch.float32)
    up = torch.stack([1.0 - near_z, torch.zeros_like(near_z), near_z], -1)
    t1, _ = _unit(vm.cross(up, wh))
    t2 = vm.cross(wh, t1)
    r = safe_sqrt(u2[..., 0])
    phi = 2.0 * np.pi * u2[..., 1]
    px = r * torch.cos(phi)
    py = r * torch.sin(phi)
    h = safe_sqrt(1.0 - px * px)
    s = 0.5 * (1.0 + wh[..., 2])
    py = (1.0 - s) * h + s * py
    pz = safe_sqrt(torch.clamp(1.0 - px * px - py * py, min=0.0))
    nh = px[..., None] * t1 + py[..., None] * t2 + pz[..., None] * wh
    wm = torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                      torch.clamp(nh[..., 2], min=1e-6)], -1)
    return _unit(wm)[0]


def tr_pdf(wo, wm, alpha):
    return tr_d_visible(wo, wm, alpha)


def tr_effectively_smooth(alpha):
    return alpha < 1e-3


# --------------------------------------------------------------------------
# Lobe closed forms: spectra (N, L), pdfs (N,)
# --------------------------------------------------------------------------

class BSDFSample(NamedTuple):
    wi: torch.Tensor          # (N, 3) local
    f: torch.Tensor           # (N, L)
    pdf: torch.Tensor         # (N,)
    specular: torch.Tensor    # (N,) bool: a delta lobe (no MIS vs lights)
    eta_scale: torch.Tensor   # (N,) radiance scale (transmission eta^2)
    transmitted: torch.Tensor  # (N,) bool: wi crosses the surface


def _flags(wo):
    return (torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device),
            torch.ones(wo.shape[:-1], device=wo.device))


def diffuse_f(wo, wi, albedo):
    return torch.where(same_hemisphere(wo, wi)[..., None], albedo * INV_PI,
                       0.0)


def diffuse_pdf(wo, wi):
    return torch.where(same_hemisphere(wo, wi), abs_cos_theta(wi) * INV_PI,
                       0.0)


def diffuse_sample(wo, u2, albedo):
    from ..ops import warps

    local = warps.sample_cosine_hemisphere(u2)
    wi = torch.where(wo[..., 2:3] < 0, _flip_z(local, -1.0), local)
    zeros, ones = _flags(wo)
    return BSDFSample(wi, albedo * INV_PI, abs_cos_theta(wi) * INV_PI, zeros,
                      ones, zeros)


def diffuse_transmission_f(wo, wi, refl, trans):
    return torch.where(same_hemisphere(wo, wi)[..., None], refl * INV_PI,
                       trans * INV_PI)


def diffuse_transmission_pdf(wo, wi, pr, pt):
    tot = torch.clamp(pr + pt, min=1e-12)
    return (abs_cos_theta(wi) * INV_PI
            * torch.where(same_hemisphere(wo, wi), pr / tot, pt / tot))


def diffuse_transmission_sample(wo, u_lobe, u2, refl, trans):
    from ..ops import warps

    pr = torch.amax(refl, -1)
    pt = torch.amax(trans, -1)
    tot = torch.clamp(pr + pt, min=1e-12)
    go_r = u_lobe < pr / tot
    local = warps.sample_cosine_hemisphere(u2)
    # reflection: the same side as wo; transmission: the other side
    sgn_o = torch.sign(wo[..., 2:3] + 1e-30)
    wi = torch.where(go_r[..., None], _flip_z(local, sgn_o),
                     _flip_z(local, -sgn_o))
    f = torch.where(go_r[..., None], refl * INV_PI, trans * INV_PI)
    pdf = abs_cos_theta(wi) * INV_PI * torch.where(go_r, pr / tot, pt / tot)
    zeros, ones = _flags(wo)
    return BSDFSample(wi, f, pdf, zeros, ones, ~go_r)


def conductor_f(wo, wi, eta, k, alpha):
    """Rough conductor (Torrance-Sparrow); 0 when smooth (a delta lobe)."""
    eta, alpha = _t(eta, wo), _t(alpha, wo)
    cos_o = torch.clamp(abs_cos_theta(wo), min=1e-7)
    cos_i = torch.clamp(abs_cos_theta(wi), min=1e-7)
    wm, wm_len = _unit(wo + wi)
    F = fresnel_conductor(vm.dot(wo, wm)[..., None] * torch.ones_like(eta),
                          eta, k)
    val = (_tr_d(wm * torch.sign(wm[..., 2:3] + 1e-30), alpha)
           * tr_g(wo, wi, alpha) / (4.0 * cos_o * cos_i))[..., None] * F
    ok = (same_hemisphere(wo, wi) & (wm_len > 1e-9)
          & ~tr_effectively_smooth(alpha))
    return torch.where(ok[..., None], val, 0.0)


def conductor_pdf(wo, wi, alpha):
    alpha = _t(alpha, wo)
    wm, wm_len = _unit(wo + wi)
    wm = wm * torch.sign(wm[..., 2:3] + 1e-30)
    pdf = (tr_pdf(wo * torch.sign(wo[..., 2:3] + 1e-30), wm, alpha)
           / torch.clamp(4.0 * torch.abs(vm.dot(wo, wm)), min=1e-9))
    ok = (same_hemisphere(wo, wi) & (wm_len > 1e-9)
          & ~tr_effectively_smooth(alpha))
    return torch.where(ok, pdf, 0.0)


def conductor_sample(wo, u2, eta, k, alpha):
    eta, alpha = _t(eta, wo), _t(alpha, wo)
    smooth = tr_effectively_smooth(alpha)
    # smooth: a perfect mirror
    wi_s = _mirror(wo)
    cos_s = torch.clamp(abs_cos_theta(wi_s), min=1e-7)
    F_s = fresnel_conductor(cos_s[..., None] * torch.ones_like(eta), eta, k)
    f_smooth = F_s / cos_s[..., None]
    # rough: a VNDF sample
    sgn = torch.sign(wo[..., 2:3] + 1e-30)
    wm_w = _flip_z(tr_sample_wm(_flip_z(wo, sgn), u2, alpha), sgn)
    wi_r = reflect(wo, wm_w)
    a_r = torch.clamp(alpha, min=2e-3)
    f_rough = conductor_f(wo, wi_r, eta, k, a_r)
    pdf_rough = conductor_pdf(wo, wi_r, a_r)
    ok_r = same_hemisphere(wo, wi_r)
    wi = torch.where(smooth[..., None], wi_s, wi_r)
    f = torch.where(smooth[..., None], f_smooth,
                    torch.where(ok_r[..., None], f_rough, 0.0))
    pdf = torch.where(smooth, 1.0, torch.where(ok_r, pdf_rough, 0.0))
    zeros, ones = _flags(wo)
    return BSDFSample(wi, f, pdf, torch.broadcast_to(smooth, zeros.shape),
                      ones, zeros)


def _dielectric_half(wo, wi, eta):
    """(cos_o, cos_i, reflecting, etap, wm_n, |wm|) of the generalized
    half vector."""
    cos_o = cos_theta(wo)
    cos_i = cos_theta(wi)
    reflecting = cos_o * cos_i > 0
    etap = torch.where(reflecting, 1.0,
                       torch.where(cos_o > 0, eta, 1.0 / eta))
    wm_n, wm_len = _unit(wi * etap[..., None] + wo)
    wm_n = wm_n * torch.sign(wm_n[..., 2:3] + 1e-30)
    return cos_o, cos_i, reflecting, etap, wm_n, wm_len


def dielectric_f(wo, wi, eta, alpha):
    """Rough dielectric BRDF + BTDF (pbrt DielectricBxDF::f); 0 when smooth."""
    eta, alpha = _t(eta, wo), _t(alpha, wo)
    cos_o, cos_i, reflecting, etap, wm_n, wm_len = _dielectric_half(wo, wi,
                                                                    eta)
    # discard backfacing microfacets
    ok = ((vm.dot(wm_n, wi) * cos_i >= 0) & (vm.dot(wm_n, wo) * cos_o >= 0)
          & (wm_len > 1e-9) & (torch.abs(cos_o) > 1e-7)
          & (torch.abs(cos_i) > 1e-7) & ~tr_effectively_smooth(alpha))
    F = fresnel_dielectric(vm.dot(wo, wm_n), eta)
    D = _tr_d(wm_n, alpha)
    G = tr_g(wo, wi, alpha)
    f_refl = D * F * G / torch.clamp(torch.abs(4.0 * cos_i * cos_o),
                                     min=1e-12)
    denom_t = (vm.dot(wi, wm_n) + vm.dot(wo, wm_n) / etap) ** 2
    f_trans = (D * (1.0 - F) * G
               * torch.abs(vm.dot(wi, wm_n) * vm.dot(wo, wm_n))
               / torch.clamp(torch.abs(cos_i * cos_o) * denom_t, min=1e-12)
               / (etap * etap))
    val = torch.where(reflecting, f_refl, f_trans)
    return torch.where(ok, val, 0.0)[..., None]


def dielectric_pdf(wo, wi, eta, alpha):
    eta, alpha = _t(eta, wo), _t(alpha, wo)
    cos_o, cos_i, reflecting, etap, wm_n, wm_len = _dielectric_half(wo, wi,
                                                                    eta)
    ok = ((vm.dot(wm_n, wi) * cos_i >= 0) & (vm.dot(wm_n, wo) * cos_o >= 0)
          & (wm_len > 1e-9) & ~tr_effectively_smooth(alpha))
    F = fresnel_dielectric(vm.dot(wo, wm_n), eta)
    pr = F
    pt = 1.0 - F
    tot = torch.clamp(pr + pt, min=1e-12)
    dwm = tr_pdf(wo * torch.sign(wo[..., 2:3] + 1e-30), wm_n, alpha)
    pdf_refl = (dwm / torch.clamp(4.0 * torch.abs(vm.dot(wo, wm_n)),
                                  min=1e-12) * pr / tot)
    denom_t = (vm.dot(wi, wm_n) + vm.dot(wo, wm_n) / etap) ** 2
    dwm_dwi = torch.abs(vm.dot(wi, wm_n)) / torch.clamp(denom_t, min=1e-12)
    pdf_trans = dwm * dwm_dwi * pt / tot
    return torch.where(ok, torch.where(reflecting, pdf_refl, pdf_trans), 0.0)


def dielectric_sample(wo, u_lobe, u2, eta, alpha):
    eta, alpha = _t(eta, wo), _t(alpha, wo)
    smooth = tr_effectively_smooth(alpha)
    n_loc = torch.zeros_like(wo)
    n_loc[..., 2] = 1.0

    # ---- smooth: delta reflection / transmission by Fresnel ----
    F_s = fresnel_dielectric(cos_theta(wo), eta)
    go_r_s = u_lobe < F_s
    wi_refl = _mirror(wo)
    ok_t, wi_trans, etap_s = refract(wo, n_loc, eta)
    wi_s = torch.where(go_r_s[..., None], wi_refl, wi_trans)
    cos_ws = torch.clamp(abs_cos_theta(wi_s), min=1e-7)
    f_s = torch.where(go_r_s, F_s / cos_ws,
                      (1.0 - F_s) / cos_ws / (etap_s * etap_s))
    pdf_s = torch.where(go_r_s, F_s, 1.0 - F_s)
    valid_s = go_r_s | ok_t
    eta_sc_s = torch.where(go_r_s, 1.0, etap_s * etap_s)

    # ---- rough: a VNDF microfacet sample ----
    sgn = torch.sign(wo[..., 2:3] + 1e-30)
    a_r = torch.clamp(alpha, min=2e-3)
    wm_w = _flip_z(tr_sample_wm(_flip_z(wo, sgn), u2, a_r), sgn)
    F_r = fresnel_dielectric(vm.dot(wo, wm_w), eta)
    go_r_r = u_lobe < F_r
    wi_rr = reflect(wo, wm_w)
    ok_rt, wi_rt, etap_r = refract(wo, wm_w, eta)
    wi_r = torch.where(go_r_r[..., None], wi_rr, wi_rt)
    f_r = dielectric_f(wo, wi_r, eta, a_r)[..., 0]
    pdf_r = dielectric_pdf(wo, wi_r, eta, a_r)
    valid_r = torch.where(go_r_r, same_hemisphere(wo, wi_rr), ok_rt)
    eta_sc_r = torch.where(go_r_r, 1.0, etap_r * etap_r)

    wi = torch.where(smooth[..., None], wi_s, wi_r)
    f = torch.where(smooth, f_s, f_r)[..., None]
    pdf = torch.where(smooth, pdf_s, pdf_r)
    valid = torch.where(smooth, valid_s, valid_r)
    eta_sc = torch.where(smooth, eta_sc_s, eta_sc_r)
    trans = torch.where(smooth, ~go_r_s, ~go_r_r)
    pdf = torch.where(valid, pdf, 0.0)
    return BSDFSample(wi, f, pdf, torch.broadcast_to(smooth, pdf.shape),
                      eta_sc, trans)


def thin_dielectric_sample(wo, u_lobe, eta):
    """Thin slab: specular reflection or pass-through with the double-
    interface Fresnel R' = R + TTR / (1 - R^2) (pbrt ThinDielectricBxDF)."""
    F = torch.clamp(fresnel_dielectric(torch.abs(cos_theta(wo)), eta),
                    max=1.0)
    R = F + (1.0 - F) * (1.0 - F) * F / torch.clamp(1.0 - F * F, min=1e-9)
    T = 1.0 - R
    go_r = u_lobe < R
    wi = torch.where(go_r[..., None], _mirror(wo), -wo)
    cos_w = torch.clamp(abs_cos_theta(wi), min=1e-7)
    f = torch.where(go_r, R / cos_w, T / cos_w)
    pdf = torch.where(go_r, R, T)
    zeros, ones = _flags(wo)
    return BSDFSample(wi, f[..., None], pdf, ~zeros, ones, ~go_r)


# ---------------------------------------------------------------------------
# Coated diffuse: the reference's Fresnel-coupled analytic model of a
# dielectric coat over a Lambertian base (its bxdfs.py l. 400-502)
# ---------------------------------------------------------------------------

def _fresnel_avg(eta):
    """Average Fresnel reflectance of a dielectric (fitted form)."""
    return (eta - 1.0) / (4.08567 + 1.00071 * eta)


def _coat_half(wo, wi):
    wm = wo + wi
    wml = torch.sqrt(vm.dot(wm, wm))
    return wm / torch.clamp(wml, min=1e-12)[..., None], wml


def coated_diffuse_f(wo, wi, albedo, eta, alpha):
    eta, alpha = _t(eta, wo), _t(alpha, wo)
    up = same_hemisphere(wo, wi) & (cos_theta(wo) > 0)
    f_o = fresnel_dielectric(abs_cos_theta(wo), eta)
    f_i = fresnel_dielectric(abs_cos_theta(wi), eta)
    re = _fresnel_avg(eta)
    eta2 = torch.clamp(eta * eta, min=1e-6)
    ri = 1.0 - (1.0 - re) / eta2
    diff = (albedo / np.pi
            * ((1.0 - f_o) * (1.0 - f_i) / eta2)[..., None]
            / torch.clamp(1.0 - albedo * ri[..., None], min=1e-3))
    smooth = tr_effectively_smooth(alpha)
    wm_n, wml = _coat_half(wo, wi)
    d = _tr_d(wm_n, alpha)
    g = tr_g(wo, wi, alpha)
    f_h = fresnel_dielectric(torch.abs(vm.dot(wo, wm_n)), eta)
    denom = 4.0 * abs_cos_theta(wo) * abs_cos_theta(wi)
    spec = torch.where(smooth | (wml < 1e-9), 0.0,
                       d * g * f_h / torch.clamp(denom, min=1e-9))
    return torch.where(up[..., None], diff + spec[..., None], 0.0)


def coated_diffuse_pdf(wo, wi, eta, alpha):
    eta, alpha = _t(eta, wo), _t(alpha, wo)
    up = same_hemisphere(wo, wi) & (cos_theta(wo) > 0)
    q = torch.clamp(fresnel_dielectric(abs_cos_theta(wo), eta), 0.1, 0.9)
    p_diff = diffuse_pdf(wo, wi)
    smooth = tr_effectively_smooth(alpha)
    wm_n, wml = _coat_half(wo, wi)
    p_spec = torch.where(
        smooth | (wml < 1e-9), 0.0,
        tr_pdf(wo, wm_n, alpha) / torch.clamp(
            4.0 * torch.abs(vm.dot(wo, wm_n)), min=1e-9))
    return torch.where(up, q * p_spec + (1.0 - q) * p_diff, 0.0)


def coated_diffuse_sample(wo, u_lobe, u2, albedo, eta, alpha):
    """One-sample lobe choice: the coat reflection with probability q."""
    eta, alpha = _t(eta, wo), _t(alpha, wo)
    q = torch.clamp(fresnel_dielectric(abs_cos_theta(wo), eta), 0.1, 0.9)
    pick_spec = u_lobe < q
    smooth = tr_effectively_smooth(alpha)
    wi_rough = reflect(wo, tr_sample_wm(wo, u2, alpha))
    wi_spec = torch.where(smooth[..., None], _mirror(wo), wi_rough)
    # the diffuse base
    sgn = torch.sign(torch.where(cos_theta(wo) == 0, 1.0, cos_theta(wo)))
    z = torch.sqrt(torch.clamp(1.0 - u2[..., 0], 0.0, 1.0))
    r = torch.sqrt(torch.clamp(u2[..., 0], 0.0, 1.0))
    phi = 2.0 * np.pi * u2[..., 1]
    wi_dif = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z * sgn],
                         -1)
    wi = torch.where(pick_spec[..., None], wi_spec, wi_dif)
    f = coated_diffuse_f(wo, wi, albedo, eta, alpha)
    pdf = coated_diffuse_pdf(wo, wi, eta, alpha)
    # a smooth coat's specular pick is a delta lobe
    f_o = fresnel_dielectric(abs_cos_theta(wo), eta)
    delta_pick = pick_spec & smooth
    f_delta = torch.zeros_like(f) + (
        f_o / torch.clamp(abs_cos_theta(wi), min=1e-9))[..., None]
    f = torch.where(delta_pick[..., None], f_delta, f)
    pdf = torch.where(delta_pick, q, pdf)
    ok = cos_theta(wo) > 0
    return BSDFSample(
        wi=wi, f=torch.where(ok[..., None], f, 0.0),
        pdf=torch.where(ok, pdf, 0.0), specular=delta_pick,
        eta_scale=torch.ones_like(pdf), transmitted=torch.zeros_like(ok))


# --------------------------------------------------------------------------
# Stochastic layered BSDF (bxdfs.h:432 LayeredBxDF; CoatedDiffuseBxDF =
# LayeredBxDF<DielectricBxDF, DiffuseBxDF>): a random walk between the coat
# and the base, every lane in lockstep under masks for max_depth steps, its
# draws from the per-lane PCG streams.  The pdf it returns is proportional
# (pbrt pdfIsProportional): f / pdf is the unbiased weight.
# --------------------------------------------------------------------------

def _draws(rng):
    from ..ops import dda

    def draw(rng):
        return dda.pcg_uniform(rng)

    def draw2(rng):
        rng, u1 = dda.pcg_uniform(rng)
        rng, u2 = dda.pcg_uniform(rng)
        return rng, torch.stack([u1, u2], -1)

    return draw, draw2


def layered_sample(wo, rng, albedo, eta, alpha, thickness=0.01, g=0.0,
                   med_albedo=None, max_depth=8):
    """Sample the coated-diffuse layered BSDF by random walk: wo (N, 3)
    local, rng (N,) PCG states, albedo (N, L), eta / alpha (N,), thickness
    / g (N,) or numbers, med_albedo (N, L) or None (the single-scattering
    albedo of the slab's medium, sigma_t = 1).  Returns (BSDFSample, rng);
    a walk that does not exit has f = 0 and pdf = 0."""
    from ..ops import phase as phase_mod

    N = wo.shape[0]
    dev = wo.device
    eta, alpha = _t(eta, wo), _t(alpha, wo)
    thickness = torch.broadcast_to(_t(thickness, wo), (N,))
    g = torch.broadcast_to(_t(g, wo), (N,))
    has_med = med_albedo is not None
    draw, draw2 = _draws(rng)

    # two-sided: walk in the upper-hemisphere frame, flip wi at the end
    sflip = torch.where(wo[..., 2] < 0, -1.0, 1.0)[..., None]
    wo_u = wo * sflip

    # ---- entrance interface: the dielectric coat ----
    rng, uc = draw(rng)
    rng, u2 = draw2(rng)
    bs = dielectric_sample(wo_u, uc, u2, eta, alpha)
    ok0 = (bs.pdf > 0) & (torch.abs(bs.wi[..., 2]) > 1e-9)
    refl0 = ok0 & ~bs.transmitted
    wi_out = bs.wi
    f_out = torch.where(refl0[..., None], bs.f, 0.0)
    pdf_out = torch.where(refl0, bs.pdf, 0.0)
    spec_out = refl0 & bs.specular
    exited = refl0

    walking = ok0 & bs.transmitted
    f = bs.f * abs_cos_theta(bs.wi)[..., None]
    pdf = torch.clamp(bs.pdf, min=1e-30)
    w = bs.wi
    z = thickness
    spec_path = bs.specular

    for depth in range(max_depth):
        # Russian roulette (the reference's depth > 3 && beta < 0.25)
        rr_beta = torch.amax(f, dim=-1) / pdf
        rng, u_rr = draw(rng)
        if depth > 3:
            q = torch.where(rr_beta < 0.25,
                            torch.clamp(1.0 - rr_beta, 0.0, 1.0), 0.0)
            die = walking & (u_rr < q)
            pdf = torch.where(walking & ~die & (q > 0), pdf * (1.0 - q), pdf)
            walking = walking & ~die
        walking = walking & (torch.abs(w[..., 2]) > 1e-9)

        scattered = torch.zeros((N,), dtype=torch.bool, device=dev)
        if has_med:
            # a possible scattering event in the slab's medium (sigma_t 1)
            rng, u_t = draw(rng)
            dz = (-torch.log1p(-torch.clamp(u_t, max=1.0 - 1e-7))
                  * torch.abs(w[..., 2]))
            zp = torch.where(w[..., 2] > 0, z + dz, z - dz)
            inside = (zp > 0) & (zp < thickness)
            rng, u_p = draw2(rng)
            wi_ph, p_ph = phase_mod.sample_hg(-w, u_p, g)
            scattered = walking & inside
            f = torch.where(scattered[..., None],
                            f * med_albedo * p_ph[..., None], f)
            pdf = torch.where(scattered, pdf * torch.clamp(p_ph, min=1e-30),
                              pdf)
            w = torch.where(scattered[..., None], wi_ph, w)
            z = torch.where(scattered, zp, torch.where(
                walking, torch.minimum(torch.clamp(zp, min=0.0), thickness),
                z))
            spec_path = spec_path & ~scattered
        else:
            # a pure absorber between the layers: cross to the other one
            z_new = torch.where(z <= 0.0, thickness, 0.0)
            tr = torch.exp(-thickness / torch.clamp(torch.abs(w[..., 2]),
                                                    min=1e-9))
            f = torch.where(walking[..., None], f * tr[..., None], f)
            z = torch.where(walking, z_new, z)

        at_interface = walking & ~scattered
        at_bottom = at_interface & (z <= 0.0)
        at_top = at_interface & (z >= thickness)

        # ---- interface sample (bottom: the diffuse base; top: the coat) ----
        rng, uc = draw(rng)
        rng, u2 = draw2(rng)
        bs_b = diffuse_sample(-w, u2, albedo)
        bs_t = dielectric_sample(-w, uc, u2, eta, alpha)
        b_f = torch.where(at_bottom[..., None], bs_b.f, bs_t.f)
        b_pdf = torch.where(at_bottom, bs_b.pdf, bs_t.pdf)
        b_wi = torch.where(at_bottom[..., None], bs_b.wi, bs_t.wi)
        b_spec = torch.where(at_bottom, bs_b.specular, bs_t.specular)
        b_trans = torch.where(at_bottom, bs_b.transmitted, bs_t.transmitted)
        ok = ((b_pdf > 0) & (torch.abs(b_wi[..., 2]) > 1e-9)
              & (torch.amax(b_f, dim=-1) > 0))
        walking = torch.where(at_interface, walking & ok, walking)

        upd = at_interface & ok
        f = torch.where(upd[..., None], f * b_f, f)
        pdf = torch.where(upd, pdf * torch.clamp(b_pdf, min=1e-30), pdf)
        spec_path = torch.where(upd, spec_path & b_spec, spec_path)

        # transmission through the top coat leaves the layers
        exit_now = upd & at_top & b_trans
        wi_out = torch.where(exit_now[..., None], b_wi, wi_out)
        f_out = torch.where(exit_now[..., None], f, f_out)
        pdf_out = torch.where(exit_now, pdf, pdf_out)
        spec_out = torch.where(exit_now, spec_path, spec_out)
        exited = exited | exit_now
        walking = walking & ~exit_now

        # continuing lanes take the interface cosine
        cont = upd & ~exit_now
        f = torch.where(cont[..., None],
                        f * abs_cos_theta(b_wi)[..., None], f)
        w = torch.where(cont[..., None], b_wi, w)

    dead = ~exited
    return BSDFSample(
        wi=wi_out * sflip, f=torch.where(dead[..., None], 0.0, f_out),
        pdf=torch.where(dead, 0.0, pdf_out), specular=spec_out,
        eta_scale=torch.ones((N,), device=dev),
        transmitted=torch.zeros((N,), dtype=torch.bool, device=dev)), rng


def layered_f(wo, wi, rng, albedo, eta, alpha, thickness=0.01, g=0.0,
              med_albedo=None, max_depth=8):
    """One-sample stochastic estimate of the layered BSDF value f(wo, wi)
    (the reference's LayeredBxDF::f random walk with exit-side importance
    transmission): the NEE companion of layered_sample.  Returns
    (f (N, L), rng); wo and wi in opposite hemispheres give 0."""
    from ..ops import phase as phase_mod

    N = wo.shape[0]
    dev = wo.device
    eta, alpha = _t(eta, wo), _t(alpha, wo)
    thickness = torch.broadcast_to(_t(thickness, wo), (N,))
    g = torch.broadcast_to(_t(g, wo), (N,))
    has_med = med_albedo is not None
    draw, draw2 = _draws(rng)

    valid = (same_hemisphere(wo, wi) & (abs_cos_theta(wo) > 1e-7)
             & (abs_cos_theta(wi) > 1e-7))
    sflip = torch.where(wo[..., 2] < 0, -1.0, 1.0)[..., None]
    wo_u = wo * sflip
    wi_u = wi * sflip

    # term 1: the coat-reflection lobe wo -> wi (analytic; 0 for a smooth
    # coat, whose delta has no density at a fixed wi)
    f_est = torch.where(
        (valid & ~tr_effectively_smooth(alpha))[..., None],
        dielectric_f(wo_u, wi_u, eta, torch.clamp(alpha, min=2e-3)), 0.0)

    # ---- entry transmission sample along wo ----
    rng, uc = draw(rng)
    rng, u2 = draw2(rng)
    bs_o = dielectric_sample(wo_u, uc, u2, eta, alpha)
    walk0 = (valid & bs_o.transmitted & (bs_o.pdf > 0)
             & (torch.abs(bs_o.wi[..., 2]) > 1e-7))
    beta = torch.where(walk0[..., None],
                       bs_o.f * abs_cos_theta(bs_o.wi)[..., None]
                       / torch.clamp(bs_o.pdf, min=1e-30)[..., None], 0.0)

    # ---- exit-side importance transmission sample along wi ----
    rng, uc2 = draw(rng)
    rng, u22 = draw2(rng)
    bs_i = dielectric_sample(wi_u, uc2, u22, eta, alpha)
    ok_i = (valid & bs_i.transmitted & (bs_i.pdf > 0)
            & (torch.abs(bs_i.wi[..., 2]) > 1e-7))
    # importance transport drops the radiance 1 / eta_p^2 compression
    beta_exit = torch.where(
        ok_i[..., None],
        bs_i.f * (bs_i.eta_scale
                  / torch.clamp(bs_i.pdf, min=1e-30))[..., None], 0.0)
    w_exit = bs_i.wi          # points into the slab (z < 0)
    cos_exit = torch.clamp(torch.abs(w_exit[..., 2]), min=1e-7)

    walking = walk0 & ok_i
    w = bs_o.wi
    z = thickness

    for depth in range(max_depth):
        rr_beta = torch.amax(beta, dim=-1)
        rng, u_rr = draw(rng)
        if depth > 3:
            q = torch.where(rr_beta < 0.25,
                            torch.clamp(1.0 - rr_beta, 0.0, 1.0), 0.0)
            die = walking & (u_rr < q)
            beta = torch.where((walking & ~die & (q > 0))[..., None],
                               beta / torch.clamp(1.0 - q,
                                                  min=1e-6)[..., None], beta)
            walking = walking & ~die
        walking = walking & (torch.abs(w[..., 2]) > 1e-7)

        scattered = torch.zeros((N,), dtype=torch.bool, device=dev)
        if has_med:
            rng, u_t = draw(rng)
            dz = (-torch.log1p(-torch.clamp(u_t, max=1.0 - 1e-7))
                  * torch.abs(w[..., 2]))
            zp = torch.where(w[..., 2] > 0, z + dz, z - dz)
            inside = (zp > 0) & (zp < thickness)
            scattered = walking & inside
            # NEE: the phase vertex connects to the exit through wis
            p_conn = phase_mod.hg_phase(-w, -w_exit, g)
            zc = torch.minimum(torch.clamp(zp, min=0.0), thickness)
            tr_up = torch.exp(-(thickness - zc) / cos_exit)
            f_est = f_est + torch.where(
                scattered[..., None],
                beta * med_albedo * p_conn[..., None] * tr_up[..., None]
                * beta_exit, 0.0)
            # continuation: exact HG sampling (p / pdf = 1)
            rng, u_p = draw2(rng)
            wi_ph, _ = phase_mod.sample_hg(-w, u_p, g)
            beta = torch.where(scattered[..., None], beta * med_albedo, beta)
            w = torch.where(scattered[..., None], wi_ph, w)
            z = torch.where(scattered, zp, torch.where(walking, zc, z))
        else:
            tr = torch.exp(-thickness / torch.clamp(torch.abs(w[..., 2]),
                                                    min=1e-7))
            beta = torch.where(walking[..., None], beta * tr[..., None],
                               beta)
            z = torch.where(walking, torch.where(z <= 0.0, thickness, 0.0),
                            z)

        at_interface = walking & ~scattered
        at_bottom = at_interface & (z <= 0.0)
        at_top = at_interface & (z >= thickness)

        # bottom NEE: the diffuse base connects to the exit
        f_bot = diffuse_f(-w, -w_exit, albedo)
        tr_full = torch.exp(-thickness / cos_exit)
        f_est = f_est + torch.where(
            at_bottom[..., None],
            beta * f_bot * cos_exit[..., None] * tr_full[..., None]
            * beta_exit, 0.0)

        # continuation through the interface (bottom: a diffuse bounce;
        # top: the coat, whose transmission leaves and is already counted)
        rng, uc3 = draw(rng)
        rng, u23 = draw2(rng)
        bs_b = diffuse_sample(-w, u23, albedo)
        bs_t = dielectric_sample(-w, uc3, u23, eta, alpha)
        b_f = torch.where(at_bottom[..., None], bs_b.f, bs_t.f)
        b_pdf = torch.where(at_bottom, bs_b.pdf, bs_t.pdf)
        b_wi = torch.where(at_bottom[..., None], bs_b.wi, bs_t.wi)
        b_trans = torch.where(at_bottom, bs_b.transmitted, bs_t.transmitted)
        ok = ((b_pdf > 0) & (torch.abs(b_wi[..., 2]) > 1e-7)
              & (torch.amax(b_f, dim=-1) > 0))
        walking = torch.where(at_interface, walking & ok, walking)
        exit_top = at_interface & at_top & ok & b_trans
        walking = walking & ~exit_top
        upd = at_interface & ok & ~exit_top
        beta = torch.where(upd[..., None],
                           beta * b_f * abs_cos_theta(b_wi)[..., None]
                           / torch.clamp(b_pdf, min=1e-30)[..., None], beta)
        w = torch.where(upd[..., None], b_wi, w)

    return torch.where(valid[..., None], f_est, 0.0), rng
