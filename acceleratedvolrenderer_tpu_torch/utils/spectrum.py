"""Sampled spectra, the 4-wavelength point-sample representation
(port of acceleratedvolrenderer_tpu/utils/spectrum.py: CIE fits, visible
wavelength sampling, constant spectra and spectrum -> XYZ)."""
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
