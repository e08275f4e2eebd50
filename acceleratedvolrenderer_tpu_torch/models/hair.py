"""Hair BxDF: the Chiang et al. 2016 fiber scattering model (port of
acceleratedvolrenderer_tpu/models/hair.py; pbrt bxdfs.h HairBxDF).

pMax = 3 lobes and a residual: the longitudinal lobe Mp (normalized
von-Mises-like in sin theta, per-lobe variance v_p from beta_m), the
azimuthal lobe Np (a trimmed logistic around the specular azimuth
Phi_p(gamma_o, gamma_t), width s from beta_n) and the attenuation A_p
(Fresnel and interior absorption).  Sampling picks a lobe by its
attenuation and inverts Mp and Np.

Every lobe is computed for every lane and summed.  The hair frame is
pbrt's: x the curve tangent, theta from the normal plane, h in [-1, 1]
the offset across the fiber.  sigma_a_from_concentration /
sigma_a_from_reflectance are the reference's helpers (numpy).
"""
from __future__ import annotations

import numpy as np
import torch

P_MAX = 3
_SQRT_PI_OVER_8 = 0.626657069


def _i0(x):
    """The modified Bessel function I0 by its series (pbrt I0)."""
    val = torch.zeros_like(x)
    x2i = torch.ones_like(x)
    ifact = 1.0
    for i in range(10):
        if i > 0:
            ifact *= i
        val = val + x2i / (ifact * ifact * (4.0 ** i) / 1.0)
        x2i = x2i * x * x
    return val


def _log_i0(x):
    big = x > 12.0
    safe = torch.clamp(x, max=12.0)
    return torch.where(
        big,
        x + 0.5 * (-np.log(2 * np.pi)
                   + torch.log(1 / torch.clamp(x, min=1e-9))
                   + 1 / torch.clamp(8 * x, min=1e-9)),
        torch.log(torch.clamp(_i0(safe), min=1e-30)))


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """The longitudinal lobe (pbrt Mp), stable for small v."""
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    if v <= 0.1:
        return torch.exp(_log_i0(a) - b - 1 / max(v, 1e-9)
                         + 0.6931 + np.log(1 / max(2 * v, 1e-30)))
    return (torch.exp(-b) * _i0(a)
            / (max(np.sinh(1 / max(v, 1e-9)), 1e-30) * 2 * v))


def _logistic(x, s):
    x = torch.abs(x)
    e = torch.exp(-x / s)
    return e / (s * (1 + e) ** 2)


def _logistic_cdf(x, s):
    if isinstance(x, float):
        return 1.0 / (1.0 + np.exp(-x / s))
    return 1.0 / (1.0 + torch.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _sample_trimmed_logistic(u, s, a, b):
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    x = -s * torch.log(1 / torch.clamp(u * k + _logistic_cdf(a, s),
                                       min=1e-12) - 1)
    return torch.clamp(x, a, b)


def _phi(p, gamma_o, gamma_t):
    return 2 * p * gamma_t - 2 * gamma_o + p * np.pi


def _fr_dielectric(cos_i, eta):
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = (1 - cos_i ** 2) / eta ** 2
    cos_t = torch.sqrt(torch.clamp(1 - sin2_t, 0.0, 1.0))
    r_par = ((eta * cos_i - cos_t)
             / torch.clamp(eta * cos_i + cos_t, min=1e-9))
    r_per = ((cos_i - eta * cos_t)
             / torch.clamp(cos_i + eta * cos_t, min=1e-9))
    return torch.where(sin2_t >= 1.0, 1.0, 0.5 * (r_par ** 2 + r_per ** 2))


class HairParams:
    """The per-material constants of the HairBxDF constructor."""

    def __init__(self, eta=1.55, beta_m=0.3, beta_n=0.3, alpha=2.0):
        self.eta = float(eta)
        bm = float(beta_m)
        bn = float(beta_n)
        v0 = (0.726 * bm + 0.812 * bm ** 2 + 3.7 * bm ** 20) ** 2
        self.v = [v0, 0.25 * v0, 4 * v0, 4 * v0]   # per-lobe variances
        self.s = _SQRT_PI_OVER_8 * (
            0.265 * bn + 1.194 * bn ** 2 + 5.372 * bn ** 22)
        a = np.deg2rad(alpha)
        self.sin2k_alpha = [np.sin(a)]
        self.cos2k_alpha = [np.cos(a)]
        for _ in range(1, 3):
            sa, ca = self.sin2k_alpha[-1], self.cos2k_alpha[-1]
            self.sin2k_alpha.append(2 * ca * sa)
            self.cos2k_alpha.append(ca * ca - sa * sa)


def _tilted(p, sin_to, cos_to, prm):
    """(sin, cos) of theta_o tilted by the scales' angle for lobe p (the
    residual lobe p = P_MAX is not tilted)."""
    k = {0: 1, 1: 0, 2: 2}.get(p)
    if k is None:
        return sin_to, cos_to
    sa, ca = float(prm.sin2k_alpha[k]), float(prm.cos2k_alpha[k])
    if p == 0:
        return sin_to * ca - cos_to * sa, cos_to * ca + sin_to * sa
    return sin_to * ca + cos_to * sa, cos_to * ca - sin_to * sa


def _ap(cos_theta_o, eta, h, T):
    """The attenuation of each lobe (pbrt Ap): a list of (..., C)."""
    cos_gamma_o = torch.sqrt(torch.clamp(1 - h ** 2, 0.0, 1.0))
    f = _fr_dielectric(cos_theta_o * cos_gamma_o, eta)[..., None]
    a0 = torch.broadcast_to(f, T.shape)
    a1 = (1 - f) ** 2 * T
    a2 = a1 * T * f
    a3 = a2 * T * f / torch.clamp(1 - T * f, min=1e-4)   # the residual sum
    return [a0, a1, a2, a3]


def _angles(w):
    """(sin theta, cos theta, phi) of a hair-frame direction."""
    sin_t = torch.clamp(w[..., 0], -1, 1)
    cos_t = torch.sqrt(torch.clamp(1 - sin_t ** 2, 0.0, 1.0))
    return sin_t, cos_t, torch.atan2(w[..., 2], w[..., 1])


def _gammas(sin_to, cos_to, h, eta):
    """(gamma_o, gamma_t, cos gamma_t) of the refracted ray."""
    etap = (torch.sqrt(torch.clamp(eta ** 2 - sin_to ** 2, min=1e-9))
            / torch.clamp(cos_to, min=1e-9))
    sin_gt = torch.clamp(h / etap, -1, 1)
    cos_gt = torch.sqrt(torch.clamp(1 - sin_gt ** 2, 0.0, 1.0))
    return (torch.arcsin(torch.clamp(h, -1, 1)), torch.arcsin(sin_gt),
            cos_gt)


def _transmittance(sigma_a, cos_gt, cos_tt):
    return torch.exp(-sigma_a * (2 * cos_gt
                                 / torch.clamp(cos_tt, min=1e-5))[..., None])


def hair_f(wo, wi, h, sigma_a, prm: HairParams):
    """f(wo, wi) per spectral channel (..., C); wo / wi in the hair frame
    (x the tangent)."""
    sin_to, cos_to, phi_o = _angles(wo)
    sin_ti, cos_ti, phi_i = _angles(wi)
    sin_tt = sin_to / prm.eta
    cos_tt = torch.sqrt(torch.clamp(1 - sin_tt ** 2, 0.0, 1.0))
    gamma_o, gamma_t, cos_gt = _gammas(sin_to, cos_to, h, prm.eta)
    T = _transmittance(sigma_a, cos_gt, cos_tt)
    ap = _ap(cos_to, prm.eta, h, T)

    phi = phi_i - phi_o
    fsum = torch.zeros_like(T)
    for p in range(P_MAX):
        sin_top, cos_top = _tilted(p, sin_to, cos_to, prm)
        mp = _mp(cos_ti, torch.abs(cos_top), sin_ti, sin_top, prm.v[p])
        dphi = phi - _phi(p, gamma_o, gamma_t)
        dphi = torch.atan2(torch.sin(dphi), torch.cos(dphi))  # to [-pi, pi]
        np_ = _trimmed_logistic(dphi, prm.s, -np.pi, np.pi)
        fsum = fsum + (mp * np_)[..., None] * ap[p]
    mp_last = _mp(cos_ti, cos_to, sin_ti, sin_to, prm.v[P_MAX])
    fsum = fsum + (mp_last / (2 * np.pi))[..., None] * ap[P_MAX]
    abs_cos = torch.abs(wi[..., 2])
    return torch.where(abs_cos[..., None] > 1e-4,
                       fsum / torch.clamp(abs_cos, min=1e-4)[..., None],
                       fsum)


def _ap_pdf(cos_to, eta, h, sigma_a):
    """Each lobe's share of the attenuation (the lobe choice pdf)."""
    sin_to = torch.sqrt(torch.clamp(1 - cos_to ** 2, 0, 1))
    sin_tt = sin_to / eta
    cos_tt = torch.sqrt(torch.clamp(1 - sin_tt ** 2, 0, 1))
    _, _, cos_gt = _gammas(sin_to, cos_to, h, eta)
    ap = _ap(cos_to, eta, h, _transmittance(sigma_a, cos_gt, cos_tt))
    lum = [a.mean(-1) for a in ap]
    tot = sum(lum)
    return [lm / torch.clamp(tot, min=1e-12) for lm in lum]


def hair_pdf(wo, wi, h, sigma_a, prm: HairParams):
    sin_to, cos_to, phi_o = _angles(wo)
    sin_ti, cos_ti, phi_i = _angles(wi)
    gamma_o, gamma_t, _ = _gammas(sin_to, cos_to, h, prm.eta)
    apdf = _ap_pdf(cos_to, prm.eta, h, sigma_a)
    phi = phi_i - phi_o
    pdf = torch.zeros_like(cos_to)
    for p in range(P_MAX):
        sin_top, cos_top = _tilted(p, sin_to, cos_to, prm)
        mp = _mp(cos_ti, torch.abs(cos_top), sin_ti, sin_top, prm.v[p])
        dphi = phi - _phi(p, gamma_o, gamma_t)
        dphi = torch.atan2(torch.sin(dphi), torch.cos(dphi))
        pdf = pdf + mp * apdf[p] * _trimmed_logistic(dphi, prm.s,
                                                     -np.pi, np.pi)
    mp_last = _mp(cos_ti, cos_to, sin_ti, sin_to, prm.v[P_MAX])
    return pdf + mp_last * apdf[P_MAX] / (2 * np.pi)


def hair_sample(wo, h, sigma_a, prm: HairParams, u):
    """Sample wi; u (..., 4) uniforms.  Returns (wi, f, pdf)."""
    sin_to, cos_to, phi_o = _angles(wo)
    apdf = _ap_pdf(cos_to, prm.eta, h, sigma_a)
    # the lobe, chosen by its attenuation
    c0 = apdf[0]
    c1 = c0 + apdf[1]
    c2 = c1 + apdf[2]
    u0 = u[..., 0]
    p_sel = ((u0 >= c0).to(torch.int64) + (u0 >= c1).to(torch.int64)
             + (u0 >= c2).to(torch.int64))

    sin_top = torch.zeros_like(sin_to)
    cos_top = torch.zeros_like(cos_to)
    v_sel = torch.zeros_like(sin_to)
    for p in range(P_MAX + 1):
        st, ct = _tilted(p, sin_to, cos_to, prm)
        m = p_sel == p
        sin_top = torch.where(m, st, sin_top)
        cos_top = torch.where(m, torch.abs(ct), cos_top)
        v_sel = torch.where(m, prm.v[p], v_sel)

    # Mp by inversion (pbrt SampleMp)
    u1 = torch.clamp(u[..., 1], min=1e-5)
    cos_theta = 1 + v_sel * torch.log(
        u1 + (1 - u1) * torch.exp(-2 / torch.clamp(v_sel, min=1e-9)))
    sin_theta = torch.sqrt(torch.clamp(1 - cos_theta ** 2, 0.0, 1.0))
    cos_phi = torch.cos(2 * np.pi * u[..., 2])
    sin_ti = -cos_theta * sin_top + sin_theta * cos_phi * cos_top
    cos_ti = torch.sqrt(torch.clamp(1 - sin_ti ** 2, 0.0, 1.0))

    # Np
    gamma_o, gamma_t, _ = _gammas(sin_to, cos_to, h, prm.eta)
    dphi_last = 2 * np.pi * u[..., 3]
    dphi_p = _phi(p_sel, gamma_o, gamma_t) + _sample_trimmed_logistic(
        u[..., 3], prm.s, -np.pi, np.pi)
    phi_i = phi_o + torch.where(p_sel < P_MAX, dphi_p, dphi_last)
    wi = torch.stack([sin_ti, cos_ti * torch.cos(phi_i),
                      cos_ti * torch.sin(phi_i)], -1)
    return (wi, hair_f(wo, wi, h, sigma_a, prm),
            hair_pdf(wo, wi, h, sigma_a, prm))


def sigma_a_from_concentration(ce, cp):
    """Eumelanin / pheomelanin concentrations -> RGB sigma_a."""
    eumelanin = np.array([0.419, 0.697, 1.37])
    pheomelanin = np.array([0.187, 0.4, 1.05])
    return ce * eumelanin + cp * pheomelanin


def sigma_a_from_reflectance(c, beta_n):
    """The inverse mapping from a fiber's colour under white light."""
    c = np.asarray(c, np.float64)
    denom = (5.969 - 0.215 * beta_n + 2.532 * beta_n ** 2
             - 10.73 * beta_n ** 3 + 5.574 * beta_n ** 4
             + 0.245 * beta_n ** 5)
    return (np.log(np.maximum(c, 1e-4)) / denom) ** 2
