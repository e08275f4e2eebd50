"""BSSRDF: subsurface scattering by diffusion-profile exit sampling
(port of acceleratedvolrenderer_tpu/models/bssrdf.py; pbrt bssrdf.{h,cpp}
and VolPath's BSSRDF branch, cpu/integrators.cpp:526-592).

Two radial profiles.  The Christensen-Burley normalized diffusion fit,
Sp(r) = A s (e^{-s r / l} + e^{-s r / (3 l)}) / (8 pi l r), whose CDF
1 - e^{-x}/4 - 3 e^{-x/3}/4 (x = s r / l) is inverted by Newton steps;
and the reference's tabulated photon beam diffusion profile, a table
baked in numpy (compute_beam_diffusion_table) and sampled by its CDF.

Exit sampling (SampleSp's probe): a radius is drawn from the profile of a
uniformly chosen RGB channel, a probe ray is cast through the disk point
along the inward normal, and its hit on the same primitive is the exit
vertex.  The weight is the channel-MIS estimator A_k p_k(d) / mean_j
p_j(d) at the realized distance d; the integrator continues from the exit
as a Lambertian vertex.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import vecmath as vmu

# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def scaling_factor(albedo):
    """Burley's fit s(A) for the searchlight configuration."""
    a = torch.as_tensor(albedo, dtype=torch.float32)
    return 1.85 - a + 7.0 * torch.abs(a - 0.8) ** 3


def profile(r, albedo, ell):
    """Sp(r) per channel: r (N,), albedo / ell (N, C) -> (N, C)."""
    s = scaling_factor(albedo)
    ell = torch.clamp(ell, min=1e-6)
    x = s * r[:, None] / ell
    rr = torch.clamp(r[:, None], min=1e-6)
    return (albedo * s * (torch.exp(-x) + torch.exp(-x / 3.0))
            / (8.0 * np.pi * ell * rr))


def pdf_r(r, albedo, ell):
    """The normalized radial pdf p(r) = Sp(r) / A (planar measure, per
    channel)."""
    s = scaling_factor(albedo)
    ell = torch.clamp(ell, min=1e-6)
    x = s * r[:, None] / ell
    rr = torch.clamp(r[:, None], min=1e-6)
    return (s * (torch.exp(-x) + torch.exp(-x / 3.0))
            / (8.0 * np.pi * ell * rr))


def sample_r(u, albedo_ch, ell_ch, n_newton: int = 8):
    """r from u (N,) by inverting cdf(x) = 1 - e^{-x}/4 - 3 e^{-x/3}/4;
    albedo_ch / ell_ch (N,) of the chosen channel."""
    u = torch.clamp(u, 1e-5, 1.0 - 1e-5)
    # start from the larger exponential's inverse
    x = -3.0 * torch.log1p(-u)
    for _ in range(n_newton):
        cdf = 1.0 - 0.25 * torch.exp(-x) - 0.75 * torch.exp(-x / 3.0)
        pdf = 0.25 * torch.exp(-x) + 0.25 * torch.exp(-x / 3.0)
        x = torch.clamp(x - (cdf - u) / torch.clamp(pdf, min=1e-9),
                        1e-6, 80.0)
    s = scaling_factor(albedo_ch)
    return x * torch.clamp(ell_ch, min=1e-6) / torch.clamp(s, min=1e-6)


def fresnel_moment_c(eta: float) -> float:
    """c = 1 - 2 FresnelMoment1(eta), the Sw normalizer (bssrdf.h)."""
    return max(1.0 - 2.0 * fresnel_moment1(eta), 1e-3)


def _probe_exit(prims, prim_ids, entry_p, entry_n, r, u_phi):
    """The probe of SampleSp: a disk point at radius r around entry_p,
    lifted by h = 2r along the normal, cast back along -n with t_max 4h;
    a hit on the same primitive is the exit.  Returns (exit_p, exit_n,
    d, found), d the realized entry-exit distance."""
    from . import shapes as shapes_mod

    phi = 2.0 * np.pi * u_phi
    bx, by, _ = vmu.frame_from_z(entry_n)
    disk = ((torch.cos(phi) * r)[:, None] * bx
            + (torch.sin(phi) * r)[:, None] * by)
    h = torch.clamp(2.0 * r, min=1e-4)
    probe_o = entry_p + disk + entry_n * h[:, None]
    probe_d = -entry_n
    hit = shapes_mod.intersect_all(prims, probe_o, probe_d, 4.0 * h)
    found = torch.isfinite(hit.t) & (hit.prim_id == prim_ids)
    exit_p = torch.where(found[:, None], probe_o + hit.t[:, None] * probe_d,
                         entry_p)
    exit_n = torch.where(found[:, None], hit.n, entry_n)
    d = torch.clamp(torch.linalg.vector_norm(exit_p - entry_p, dim=-1),
                    min=1e-5)
    return exit_p, exit_n, d, found


def _channel(u_ch, n_channels):
    return torch.clamp((u_ch * n_channels).to(torch.int64),
                       max=n_channels - 1)


def sample_exit(prims, prim_ids, entry_p, entry_n, albedo, ell,
                u_ch, u_r, u_phi, r_max_factor: float = 12.0):
    """Burley exit sampling.  prims: the primitive tuple; prim_ids (N,)
    entry primitives; entry_p / entry_n (N, 3); albedo / ell (N, C); u_*
    (N,) uniforms.  Returns (exit_p, exit_n, weight (N, C), found)."""
    C = albedo.shape[-1]
    ch = _channel(u_ch, C)[:, None]
    r = sample_r(u_r, albedo.gather(1, ch)[:, 0], ell.gather(1, ch)[:, 0])
    # beyond ~r_max the profile carries negligible energy
    r = torch.minimum(r, r_max_factor * torch.amax(ell, -1))
    exit_p, exit_n, d, found = _probe_exit(prims, prim_ids, entry_p,
                                           entry_n, r, u_phi)
    # the channel-MIS weight at the realized distance
    p_all = pdf_r(d, albedo, ell)
    sel_pdf = p_all.mean(-1)                  # uniform channel choice
    w = albedo * p_all / torch.clamp(sel_pdf, min=1e-12)[:, None]
    return exit_p, exit_n, w, found


# ---------------------------------------------------------------------------
# The tabulated photon beam diffusion profile (bssrdf.cpp
# ComputeBeamDiffusionBSSRDF / TabulatedBSSRDF; PBR book 15.5), baked in
# numpy float64 when a material needs it: for each single-scattering albedo
# rho, the radial profile 2 pi r Sr(r) at unit sigma_t, the dipole's
# multiple scattering with Grosjean's diffusion coefficient plus the single
# scattering integral; a medium scales it as Sr(r) = sigma_t^2
# Sr_unit(sigma_t r).
# ---------------------------------------------------------------------------


def fresnel_moment1(eta: float) -> float:
    e2, e3, e4, e5 = eta ** 2, eta ** 3, eta ** 4, eta ** 5
    if eta < 1:
        return (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
                + 2.49277 * e4 - 0.68441 * e5)
    return (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
            - 1.27198 * e4 + 0.12746 * e5)


def fresnel_moment2(eta: float) -> float:
    e2, e3, e4, e5 = eta ** 2, eta ** 3, eta ** 4, eta ** 5
    if eta < 1:
        return (0.27614 - 0.87350 * eta + 1.12077 * e2 - 0.65095 * e3
                - 0.07883 * e4 + 0.04860 * e5)
    return (-547.033 + 45.3087 / e3 - 218.725 / e2 + 458.843 / eta
            + 404.557 * eta - 189.519 * e2 + 54.9327 * e3 - 9.00603 * e4
            + 0.63942 * e5)


def _fr_dielectric_np(cos_i, eta):
    """Fresnel reflectance for the single-scattering integrand (numpy)."""
    cos_i = np.clip(cos_i, -1.0, 1.0)
    eta_p = np.where(cos_i < 0, 1.0 / eta, eta)
    cos_i = np.abs(cos_i)
    sin2_t = (1.0 - cos_i ** 2) / eta_p ** 2
    cos_t = np.sqrt(np.maximum(1.0 - sin2_t, 0.0))
    r_par = (eta_p * cos_i - cos_t) / np.maximum(eta_p * cos_i + cos_t, 1e-9)
    r_per = (cos_i - eta_p * cos_t) / np.maximum(cos_i + eta_p * cos_t, 1e-9)
    return np.where(sin2_t >= 1.0, 1.0, 0.5 * (r_par ** 2 + r_per ** 2))


def beam_diffusion_ms(sigma_s, sigma_a, g, eta, r, n_samples=100):
    """Multiple-scattering beam diffusion at the radii r (numpy)."""
    r = np.atleast_1d(np.asarray(r, np.float64))
    sigmap_s = sigma_s * (1 - g)
    sigmap_t = sigma_a + sigmap_s
    if sigmap_t <= 0:
        return np.zeros_like(r)
    rhop = sigmap_s / sigmap_t
    d_g = (2 * sigma_a + sigmap_s) / (3 * sigmap_t ** 2)
    sigma_tr = np.sqrt(max(sigma_a / d_g, 0.0))
    fm1, fm2 = fresnel_moment1(eta), fresnel_moment2(eta)
    ze = -2 * d_g * (1 + 3 * fm2) / (1 - 2 * fm1)
    c_phi = 0.25 * (1 - 2 * fm1)
    c_e = 0.5 * (1 - 3 * fm2)
    i = np.arange(n_samples)
    zr = -np.log(1 - (i + 0.5) / n_samples) / sigmap_t          # (S,)
    zv = -zr + 2 * ze
    dr = np.sqrt(r[:, None] ** 2 + zr[None, :] ** 2)            # (R, S)
    dv = np.sqrt(r[:, None] ** 2 + zv[None, :] ** 2)
    inv4pi = 1.0 / (4.0 * np.pi)
    phi_d = inv4pi / d_g * (np.exp(-sigma_tr * dr) / dr
                            - np.exp(-sigma_tr * dv) / dv)
    ed_n = inv4pi * (zr[None, :] * (1 + sigma_tr * dr)
                     * np.exp(-sigma_tr * dr) / dr ** 3
                     - zv[None, :] * (1 + sigma_tr * dv)
                     * np.exp(-sigma_tr * dv) / dv ** 3)
    e_term = phi_d * c_phi + ed_n * c_e
    kappa = 1 - np.exp(-2 * sigmap_t * (dr + zr[None, :]))
    return (rhop * rhop * np.exp(-sigma_a * zr[None, :]) * kappa
            * e_term).mean(axis=1)


def beam_diffusion_ss(sigma_s, sigma_a, g, eta, r, n_samples=100):
    """Single scattering along the refracted beam at the radii r (numpy)."""
    from ..ops.phase import hg_phase_scalar_np

    r = np.atleast_1d(np.asarray(r, np.float64))
    sigma_t = sigma_a + sigma_s
    if sigma_t <= 0:
        return np.zeros_like(r)
    rho = sigma_s / sigma_t
    t_crit = r * np.sqrt(max(eta * eta - 1.0, 0.0))             # (R,)
    i = np.arange(n_samples)
    dt = -np.log(1 - (i + 0.5) / n_samples) / sigma_t           # (S,)
    ti = t_crit[:, None] + dt[None, :]                          # (R, S)
    d = np.sqrt(r[:, None] ** 2 + ti ** 2)
    cos_o = ti / d
    ph = hg_phase_scalar_np(cos_o, g)
    fres = 1.0 - _fr_dielectric_np(-cos_o, eta)
    return (rho * np.exp(-sigma_t * (d + t_crit[:, None])) / d ** 2
            * ph * fres * np.abs(cos_o)).mean(axis=1)


@functools.lru_cache(maxsize=16)
def _beam_diffusion_table(g: float, eta: float, n_rho: int, n_radius: int):
    rho = (1 - np.exp(-8 * np.arange(n_rho) / (n_rho - 1))) / (1 - np.exp(-8.0))
    radius = np.zeros(n_radius)
    radius[1] = 2.5e-3
    for k in range(2, n_radius):
        radius[k] = radius[k - 1] * 1.2
    prof = np.zeros((n_rho, n_radius))
    for j, rh in enumerate(rho):
        if rh <= 0:
            continue
        prof[j] = np.maximum(2 * np.pi * radius * (
            beam_diffusion_ms(rh, 1 - rh, g, eta, radius)
            + beam_diffusion_ss(rh, 1 - rh, g, eta, radius)), 0.0)
    # rho_eff: the polar profile's integral over the radius (trapezoid on
    # the geometric grid; pbrt integrates by Catmull-Rom)
    rho_eff = _trapezoid(prof, radius, axis=1)
    cdf = np.concatenate(
        [np.zeros((n_rho, 1)),
         np.cumsum(0.5 * (prof[:, 1:] + prof[:, :-1])
                   * np.diff(radius)[None, :], axis=1)], axis=1)
    cdf = cdf / np.maximum(cdf[:, -1:], 1e-12)
    return dict(rho=rho, radius=radius, profile=prof, rho_eff=rho_eff,
                cdf=cdf)


def compute_beam_diffusion_table(g: float = 0.0, eta: float = 1.33,
                                 n_rho: int = 40, n_radius: int = 64):
    """The BSSRDF table: rho (R,), radius (M,), profile (R, M) = 2 pi r
    Sr_unit, rho_eff (R,) and cdf (R, M), at unit sigma_t (numpy float64);
    kept per (g, eta, n_rho, n_radius).  Callers must not modify it."""
    return _beam_diffusion_table(round(g, 5), round(eta, 5), n_rho,
                                 n_radius)


def subsurface_from_diffuse(table, reflectance, mfp):
    """Per-channel (sigma_a, sigma_s, rho) whose profile has the effective
    albedo `reflectance` at mean free path `mfp` (bssrdf.cpp
    SubsurfaceFromDiffuse)."""
    reflectance = np.clip(np.asarray(reflectance, np.float64), 0.0,
                          float(table["rho_eff"].max()) - 1e-4)
    rho = np.interp(reflectance, table["rho_eff"], table["rho"])
    sigma_t = 1.0 / np.maximum(np.asarray(mfp, np.float64), 1e-6)
    return (1 - rho) * sigma_t, rho * sigma_t, rho


def tabulated_channel_arrays(table, reflectance_rgb, mfp_rgb, device="cpu"):
    """The tables of tabulated exit sampling, float32 tensors on `device`:
    radius (M,), each channel's profile and cdf rows (C, M), interpolated
    between the table's rho rows at the channel's inverted albedo,
    sigma_t (C,) and rho_eff (C,)."""
    table_rho = table["rho"]
    _, _, rho_ch = subsurface_from_diffuse(table, reflectance_rgb, mfp_rgb)
    sigma_t = 1.0 / np.maximum(np.asarray(mfp_rgb, np.float64), 1e-6)
    idx = np.clip(np.searchsorted(table_rho, rho_ch) - 1, 0,
                  len(table_rho) - 2)
    f = np.clip((rho_ch - table_rho[idx])
                / np.maximum(table_rho[idx + 1] - table_rho[idx], 1e-9),
                0.0, 1.0)
    prof = ((1 - f)[:, None] * table["profile"][idx]
            + f[:, None] * table["profile"][idx + 1])
    cdf = ((1 - f)[:, None] * table["cdf"][idx]
           + f[:, None] * table["cdf"][idx + 1])
    cdf = cdf / np.maximum(cdf[:, -1:], 1e-12)
    rho_eff = _trapezoid(prof, table["radius"], axis=1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return dict(radius=t(table["radius"]), profile=t(prof), cdf=t(cdf),
                sigma_t=t(sigma_t), rho_eff=t(rho_eff))


def tabulated_sample_r(tab, ch, u):
    """A world radius from channel ch's tabulated profile by its inverse
    CDF (TabulatedBSSRDF::Sample_Sr); ch, u (N,)."""
    cdf = tab["cdf"][ch]                      # (N, M)
    radius = tab["radius"]
    m = radius.shape[0]
    k = torch.clamp((u[:, None] >= cdf).sum(-1) - 1, 0, m - 2)
    c0 = cdf.gather(1, k[:, None])[:, 0]
    c1 = cdf.gather(1, (k + 1)[:, None])[:, 0]
    t = torch.clamp((u - c0) / torch.clamp(c1 - c0, min=1e-9), 0.0, 1.0)
    r_u = radius[k] * (1 - t) + radius[k + 1] * t
    return r_u / torch.clamp(tab["sigma_t"][ch], min=1e-9)


def tabulated_pdf_r(tab, d):
    """Every channel's planar pdf at the world distances d (N,) -> (N, C):
    Sr_unit(sigma_t d) sigma_t^2 / rho_eff, Sr_unit = profile / (2 pi
    r_unit)."""
    radius = tab["radius"]
    m = radius.shape[0]
    sig = tab["sigma_t"][None, :]             # (1, C)
    r_u = d[:, None] * sig                    # (N, C)
    k = torch.clamp((r_u[..., None] >= radius).sum(-1) - 1, 0, m - 2)
    r0, r1 = radius[k], radius[k + 1]
    t = torch.clamp((r_u - r0) / torch.clamp(r1 - r0, min=1e-9), 0.0, 1.0)
    prof = tab["profile"]                     # (C, M)
    rows = torch.arange(prof.shape[0], device=d.device)[None, :]
    prof_v = prof[rows, k] * (1 - t) + prof[rows, k + 1] * t
    sr_u = prof_v / torch.clamp(2 * np.pi * r_u, min=1e-9)
    return sr_u * sig ** 2 / torch.clamp(tab["rho_eff"][None, :], min=1e-9)


def sample_exit_tabulated(prims, prim_ids, entry_p, entry_n, tab,
                          u_ch, u_r, u_phi):
    """Tabulated exit sampling: sample_exit's probe, the weight rho_eff_k
    p_k(d) / mean_j p_j(d)."""
    C = tab["sigma_t"].shape[0]
    r = tabulated_sample_r(tab, _channel(u_ch, C), u_r)
    r = torch.minimum(r, tab["radius"][-1]
                      / torch.clamp(tab["sigma_t"].min(), min=1e-9))
    exit_p, exit_n, d, found = _probe_exit(prims, prim_ids, entry_p,
                                           entry_n, r, u_phi)
    p_all = tabulated_pdf_r(tab, d)
    sel_pdf = p_all.mean(-1)
    w = (tab["rho_eff"][None, :] * p_all
         / torch.clamp(sel_pdf, min=1e-12)[:, None])
    return exit_p, exit_n, w, found
