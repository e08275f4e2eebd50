"""Sampled spectra, the 4-wavelength point-sample representation
(port of acceleratedvolrenderer_tpu/utils/spectrum.py: CIE fits, visible
wavelength sampling, constant and blackbody spectra, Smits' RGB ->
spectrum and spectrum -> XYZ)."""
from __future__ import annotations

from typing import NamedTuple

import torch

N_SPECTRUM_SAMPLES = 4
LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0
CIE_Y_INTEGRAL = 106.856895


def _pgauss(lam, mu, s1, s2):
    t = (lam - mu) * torch.where(lam < mu, 1.0 / s1, 1.0 / s2)
    return torch.exp(-0.5 * t * t)


def cie_x(lam):
    return (1.056 * _pgauss(lam, 599.8, 37.9, 31.0)
            + 0.362 * _pgauss(lam, 442.0, 16.0, 26.7)
            - 0.065 * _pgauss(lam, 501.1, 20.4, 26.2))


def cie_y(lam):
    return (0.821 * _pgauss(lam, 568.8, 46.9, 40.5)
            + 0.286 * _pgauss(lam, 530.9, 16.3, 31.1))


def cie_z(lam):
    return (1.217 * _pgauss(lam, 437.0, 11.8, 36.0)
            + 0.681 * _pgauss(lam, 459.0, 26.0, 13.8))


def cie_xyz(lam):
    return torch.stack([cie_x(lam), cie_y(lam), cie_z(lam)], dim=-1)


class SampledWavelengths(NamedTuple):
    lam: torch.Tensor   # (..., N_SPECTRUM_SAMPLES)
    pdf: torch.Tensor


def _visible_pdf(lam):
    c = torch.cosh(0.0072 * (lam - 538.0))
    pdf = 0.0039398042 / (c * c)
    return torch.where((lam >= LAMBDA_MIN) & (lam <= LAMBDA_MAX), pdf, 0.0)


def sample_wavelengths_visible(u):
    """Importance-sample wavelengths ~ photopic sensitivity; u: (...,)."""
    offs = torch.arange(N_SPECTRUM_SAMPLES, dtype=u.dtype,
                        device=u.device) / N_SPECTRUM_SAMPLES
    up = u[..., None] + offs
    up = torch.where(up > 1.0, up - 1.0, up)
    lam = 538.0 - 138.888889 * torch.atanh(0.85691062 - 1.82750197 * up)
    lam = torch.clamp(lam, LAMBDA_MIN, LAMBDA_MAX)
    return SampledWavelengths(lam, _visible_pdf(lam))


def constant_spectrum(c):
    def f(lam):
        return torch.full(lam.shape, float(c), dtype=torch.float32,
                          device=lam.device)
    return f


def blackbody(lam_nm, T):
    """Planck's law, W/(m^2 sr m), at wavelengths lam_nm (nm)."""
    lam = lam_nm * 1e-9
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    l5 = lam ** 5
    return (2.0 * h * c * c) / (l5 * (torch.exp(torch.clamp(
        (h * c) / (lam * kb * T), max=80.0)) - 1.0))


def blackbody_normalized(T):
    """Blackbody spectrum divided by its value at the Wien peak."""
    lam_max_nm = 2.8977721e-3 / T * 1e9
    peak = blackbody(torch.tensor(lam_max_nm, dtype=torch.float32), T)

    def f(lam):
        return blackbody(lam, T) / peak.to(lam.device)

    return f


# Smits' (1999) RGB -> spectrum box basis, sampled at ten wavelengths
_SMITS_LAMBDA = (380.0, 417.8, 455.6, 493.3, 531.1, 568.9, 606.7, 644.4,
                 682.2, 720.0)
_SMITS_WHITE = (1.0, 1.0, .9999, .9993, .9992, .9998, 1.0, 1.0, 1.0, 1.0)
_SMITS_CYAN = (.9710, .9426, 1.0007, 1.0007, 1.0007, 1.0007, .1564, .0000,
               .0000, .0000)
_SMITS_MAGENTA = (1.0, 1.0, .9685, .2229, .0000, .0458, .8369, 1.0, 1.0,
                  .9959)
_SMITS_YELLOW = (.0001, .0000, .1088, .6651, 1.0, 1.0, .9996, .9586, .9685,
                 .9840)
_SMITS_RED = (.1012, .0515, .0000, .0000, .0000, .0000, .8325, 1.0149,
              1.0149, 1.0149)
_SMITS_GREEN = (.0000, .0000, .0273, .7937, 1.0, .9418, .1719, .0000, .0000,
                .0025)
_SMITS_BLUE = (1.0, 1.0, .8916, .3323, .0000, .0000, .0003, .0369, .0483,
               .0496)


def _smits_interp(table, lam):
    """Piecewise-linear interpolation of `table` over _SMITS_LAMBDA at lam,
    held at the end values outside (numpy's interp)."""
    xp = torch.tensor(_SMITS_LAMBDA, dtype=torch.float32, device=lam.device)
    fp = torch.tensor(table, dtype=torch.float32, device=lam.device)
    i = torch.clamp(torch.searchsorted(xp, lam.contiguous(), right=True), 1,
                    len(xp) - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    f = f0 + ((lam - x0) / (xp[i] - x0)) * (fp[i] - f0)
    f = torch.where(lam < xp[0], fp[0], f)
    return torch.where(lam > xp[-1], fp[-1], f)


def rgb_to_spectrum_smits_batched(rgb, lam):
    """Smits' RGB -> spectrum at wavelengths lam (..., L) for rgb (..., 3),
    every component ordering evaluated and selected by mask; (..., L)."""
    r, g, b = rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]
    white = _smits_interp(_SMITS_WHITE, lam)
    cyan = _smits_interp(_SMITS_CYAN, lam)
    magenta = _smits_interp(_SMITS_MAGENTA, lam)
    yellow = _smits_interp(_SMITS_YELLOW, lam)
    red = _smits_interp(_SMITS_RED, lam)
    green = _smits_interp(_SMITS_GREEN, lam)
    blue = _smits_interp(_SMITS_BLUE, lam)
    c1 = (r <= g) & (r <= b)
    out1 = r * white + torch.where(g <= b, (g - r) * cyan + (b - g) * blue,
                                   (b - r) * cyan + (g - b) * green)
    c2 = (g <= r) & (g <= b) & ~c1
    out2 = g * white + torch.where(r <= b, (r - g) * magenta + (b - r) * blue,
                                   (b - g) * magenta + (r - b) * red)
    out3 = b * white + torch.where(r <= g, (r - b) * yellow + (g - r) * green,
                                   (g - b) * yellow + (r - g) * red)
    out = torch.where(c1, out1, torch.where(c2, out2, out3))
    return torch.clamp(out, min=0.0)


def to_xyz(values, swl: SampledWavelengths):
    """MC estimate of the XYZ tristimulus of a spectral sample -> (..., 3)."""
    xyz = cie_xyz(swl.lam)
    ok = swl.pdf > 0.0
    w = torch.where(ok, values / torch.where(ok, swl.pdf, 1.0), 0.0)
    return torch.mean(w[..., None] * xyz, dim=-2) / CIE_Y_INTEGRAL


def y_luminance(values, swl: SampledWavelengths):
    """MC estimate of the luminance Y of a spectral sample -> (...,)."""
    ok = swl.pdf > 0.0
    w = torch.where(ok, values / torch.where(ok, swl.pdf, 1.0), 0.0)
    return torch.mean(w * cie_y(swl.lam), dim=-1) / CIE_Y_INTEGRAL
