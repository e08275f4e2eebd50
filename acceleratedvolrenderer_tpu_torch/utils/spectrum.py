"""Sampled spectra, the 4-wavelength point-sample representation
(port of acceleratedvolrenderer_tpu/utils/spectrum.py: CIE fits, visible
wavelength sampling, constant and blackbody spectra, the daylight
stand-in, Smits' RGB -> spectrum, the named spectra of glasses, metals and
illuminants, piecewise-linear spectra and spectrum -> XYZ)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import resolve

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

    def terminate_secondary(self):
        """Keep the hero wavelength only (pbrt's TerminateSecondary,
        spectrum.h:185): the other lanes' pdf goes to 0 and lane 0's is
        divided by N; idempotent."""
        already = torch.all(self.pdf[..., 1:] == 0.0, dim=-1, keepdim=True)
        new_pdf = torch.cat([self.pdf[..., :1] / N_SPECTRUM_SAMPLES,
                             torch.zeros_like(self.pdf[..., 1:])], -1)
        return SampledWavelengths(self.lam,
                                  torch.where(already, self.pdf, new_pdf))


def sample_wavelengths_uniform(u):
    """Stratified uniform wavelengths (pbrt SampledWavelengths::
    SampleUniform, spectrum.h:155); u: (...,) in [0, 1)."""
    lam0 = LAMBDA_MIN + u[..., None] * (LAMBDA_MAX - LAMBDA_MIN)
    delta = (LAMBDA_MAX - LAMBDA_MIN) / N_SPECTRUM_SAMPLES
    lam = lam0 + torch.arange(N_SPECTRUM_SAMPLES, dtype=lam0.dtype,
                              device=u.device) * delta
    lam = torch.where(lam > LAMBDA_MAX, LAMBDA_MIN + (lam - LAMBDA_MAX), lam)
    return SampledWavelengths(
        lam, torch.full_like(lam, 1.0 / (LAMBDA_MAX - LAMBDA_MIN)))


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


class DenselySampledSpectrum:
    """A spectrum sampled every 1 nm over [LAMBDA_MIN, LAMBDA_MAX], its 471
    values a tensor; evaluation reads the nearest sample (pbrt's
    DenselySampledSpectrum).  The table lives on `device` (the card unless
    given), put there once; `lam` must be on the same device."""

    def __init__(self, values, device=None):
        self.values = torch.as_tensor(values, dtype=torch.float32,
                                      device=resolve(device))

    def __call__(self, lam):
        idx = torch.clamp(torch.round(lam - LAMBDA_MIN).to(torch.int64), 0,
                          self.values.shape[0] - 1)
        return self.values[idx]


def spectrum_to_photometric(spec_fn):
    """Luminous scale K with K * sum(spec * V) = 1 photometric unit (pbrt
    SpectrumToPhotometric), over 1 nm steps, on the host."""
    lam = torch.arange(LAMBDA_MIN, LAMBDA_MAX + 1.0, 1.0,
                       dtype=torch.float32)
    integ = float(torch.sum(spec_fn(lam) * cie_y(lam)))
    return 683.0 * integ / CIE_Y_INTEGRAL if integ > 0 else 0.0


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


def d_illuminant(T=6504.0):
    """Daylight at correlated colour temperature T as a normalized
    blackbody, the reference's stand-in for the tabulated CIE D series."""
    return blackbody_normalized(T)


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


def interp(x, xp, fp):
    """np.interp of float32 x over the increasing sample points xp with
    values fp (python sequences or numpy arrays, cast to float32): linear
    between the points, held at the end values outside."""
    xp = torch.as_tensor(np.asarray(xp, np.float32), device=x.device)
    fp = torch.as_tensor(np.asarray(fp, np.float32), device=x.device)
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    len(xp) - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    f = f0 + ((x - x0) / (xp[i] - x0)) * (fp[i] - f0)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def piecewise_linear_spectrum(lam_nm, values):
    """The spectrum of (wavelength, value) samples, a "spectrum"
    parameter's pairs: np.interp of lam over them."""
    lam_nm = np.asarray(lam_nm, np.float32)
    values = np.asarray(values, np.float32)

    def f(lam):
        return interp(lam, lam_nm, values)

    return f


def _smits_interp(table, lam):
    """Piecewise-linear interpolation of `table` over _SMITS_LAMBDA at lam,
    held at the end values outside (numpy's interp)."""
    return interp(lam, _SMITS_LAMBDA, table)


def rgb_albedo_spectrum(rgb):
    """An RGB reflectance as a smooth spectrum by Smits' basis: rgb is a
    python or numpy triple, the branch is chosen on the host."""
    r, g, b = float(rgb[0]), float(rgb[1]), float(rgb[2])
    if r <= g and r <= b:
        terms = [(r, _SMITS_WHITE)] + (
            [(g - r, _SMITS_CYAN), (b - g, _SMITS_BLUE)] if g <= b
            else [(b - r, _SMITS_CYAN), (g - b, _SMITS_GREEN)])
    elif g <= r and g <= b:
        terms = [(g, _SMITS_WHITE)] + (
            [(r - g, _SMITS_MAGENTA), (b - r, _SMITS_BLUE)] if r <= b
            else [(b - g, _SMITS_MAGENTA), (r - b, _SMITS_RED)])
    else:
        terms = [(b, _SMITS_WHITE)] + (
            [(r - b, _SMITS_YELLOW), (g - r, _SMITS_GREEN)] if r <= g
            else [(g - b, _SMITS_YELLOW), (r - g, _SMITS_RED)])

    def f(lam):
        out = torch.zeros(lam.shape, dtype=torch.float32, device=lam.device)
        for w, table in terms:
            out = out + w * _smits_interp(table, lam)
        return torch.clamp(out, min=0.0)

    return f


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


def _sellmeier(b, c):
    """Index of refraction n(lambda) from Sellmeier coefficients (lambda in
    nm, the formula in um)."""
    b1, b2, b3 = b
    c1, c2, c3 = c

    def f(lam_nm):
        u2 = (lam_nm * 1e-3) ** 2
        n2 = 1.0 + b1 * u2 / (u2 - c1) + b2 * u2 / (u2 - c2) \
            + b3 * u2 / (u2 - c3)
        return torch.sqrt(torch.clamp(n2, min=1.0))

    return f


_GLASS_SELLMEIER = {
    "glass-BK7": ((1.03961212, 0.231792344, 1.01046945),
                  (0.00600069867, 0.0200179144, 103.560653)),
    "glass-BAF10": ((1.5851495, 0.143559385, 1.08521269),
                    (0.00926681282, 0.0424489805, 105.613573)),
    "glass-FK51A": ((0.971247817, 0.216901417, 0.904651666),
                    (0.00472301995, 0.0153575612, 168.68133)),
    "glass-LASF9": ((2.00029547, 0.298926886, 1.80691843),
                    (0.0121426017, 0.0538736236, 156.530829)),
    "glass-F5": ((1.52481889, 0.187085527, 1.42729015),
                 (0.011254756, 0.0588995392, 129.141675)),
    "glass-F10": ((1.62153902, 0.256287842, 1.64447552),
                  (0.0122241457, 0.0595736775, 147.468793)),
    "glass-F11": ((1.73759695, 0.313747346, 1.89878101),
                  (0.013188707, 0.0623068142, 155.23629)),
}

# (lambda_nm, value) visible-range samples; linearly interpolated, clamped
_METAL_IOR = {
    "metal-Au-eta": ((400, 450, 500, 550, 600, 650, 700),
                     (1.658, 1.426, 0.855, 0.347, 0.180, 0.143, 0.131)),
    "metal-Au-k": ((400, 450, 500, 550, 600, 650, 700),
                   (1.956, 1.846, 1.895, 2.731, 3.068, 3.800, 4.103)),
    "metal-Ag-eta": ((400, 450, 500, 550, 600, 650, 700),
                     (0.054, 0.045, 0.050, 0.057, 0.059, 0.057, 0.041)),
    "metal-Ag-k": ((400, 450, 500, 550, 600, 650, 700),
                   (2.120, 2.568, 3.037, 3.464, 3.890, 4.296, 4.693)),
    "metal-Cu-eta": ((400, 450, 500, 550, 600, 650, 700),
                     (1.175, 1.150, 1.120, 1.041, 0.454, 0.221, 0.213)),
    "metal-Cu-k": ((400, 450, 500, 550, 600, 650, 700),
                   (2.163, 2.399, 2.598, 2.591, 3.010, 3.435, 3.808)),
    "metal-Al-eta": ((400, 450, 500, 550, 600, 650, 700),
                     (0.490, 0.618, 0.769, 0.958, 1.200, 1.468, 1.830)),
    "metal-Al-k": ((400, 450, 500, 550, 600, 650, 700),
                   (4.861, 5.471, 6.080, 6.690, 7.260, 7.790, 8.310)),
    "metal-CuZn-eta": ((400, 500, 600, 700),
                       (1.350, 0.960, 0.450, 0.440)),
    "metal-CuZn-k": ((400, 500, 600, 700),
                     (1.750, 2.050, 3.000, 3.650)),
    "metal-MgO-eta": ((400, 550, 700), (1.762, 1.737, 1.724)),
    "metal-MgO-k": ((400, 550, 700), (0.0, 0.0, 0.0)),
    "metal-TiO2-eta": ((400, 500, 600, 700),
                       (2.98, 2.73, 2.61, 2.55)),
    "metal-TiO2-k": ((400, 500, 600, 700), (0.0, 0.0, 0.0, 0.0)),
}


def named_spectrum(name):
    """The spectrum of a pbrt named spectrum, or None if unknown."""
    if name in _GLASS_SELLMEIER:
        return _sellmeier(*_GLASS_SELLMEIER[name])
    if name in _METAL_IOR:
        return piecewise_linear_spectrum(*_METAL_IOR[name])
    if name == "stdillum-A":
        return blackbody_normalized(2856.0)
    if name == "stdillum-D50":
        return d_illuminant(5003.0)
    if name in ("stdillum-D65", "stdillum-dci", "canonical"):
        return d_illuminant(6504.0)
    if name == "illum-acesD60":
        return d_illuminant(6000.0)
    return None


# ---------------------------------------------------------------------------
# RGBSigmoidPolynomial (util/spectrum.h) and the table generator of pbrt's
# cmd/rgb2spec_opt.cpp.  As in the reference, the whole coefficient lattice
# is one batched Levenberg-Marquardt fit, every lattice point a lane, here
# with the closed-form Jacobian of the three coefficients; the error is
# taken in linear sRGB (the reference's CIELAB and this drive in-gamut
# residuals to ~0, where the model is exact).
# ---------------------------------------------------------------------------

_SRGB_XYZ_TO_RGB = np.array([
    [3.2406, -1.5372, -0.4986],
    [-0.9689, 1.8758, 0.0415],
    [0.0557, -0.2040, 1.0570]], np.float64)


def sigmoid(x):
    """s(x) = 1/2 + x / (2 sqrt(1 + x^2)) (RGBSigmoidPolynomial::s)."""
    return 0.5 + x / (2.0 * torch.sqrt(1.0 + x * x))


def sigmoid_polynomial_eval(coeffs, lam):
    """The sigmoid-polynomial reflectance: coeffs (..., 3) = (c0, c1, c2)
    over the wavelength in nm, lam (...,) nm; values in (0, 1)."""
    x = (coeffs[..., 0] * lam + coeffs[..., 1]) * lam + coeffs[..., 2]
    return sigmoid(x)


def _sigmoid_fit_basis(q: int = 95, device="cpu"):
    """(lam01 (Q,), basis (Q, 3)) on device: the normalized quadrature
    wavelengths and M_xyz2rgb (xbar, ybar, zbar D65) weights, normalized so
    that a unit reflectance maps to RGB (1, 1, 1)."""
    lam_nm = np.linspace(LAMBDA_MIN, LAMBDA_MAX, q)
    lam01 = (lam_nm - LAMBDA_MIN) / (LAMBDA_MAX - LAMBDA_MIN)
    lam_t = torch.as_tensor(lam_nm, dtype=torch.float32)
    ill = d_illuminant()(lam_t).numpy().astype(np.float64)
    xyz = cie_xyz(lam_t).numpy().astype(np.float64)
    w = xyz * ill[:, None]
    w /= (ill * xyz[:, 1]).sum()                       # white -> Y = 1
    basis = w @ _SRGB_XYZ_TO_RGB.T                     # (Q, 3)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return t(lam01), t(basis)


def fit_sigmoid_polynomial(rgb, iters: int = 60, device=None):
    """Batched Levenberg-Marquardt fit of sigmoid-polynomial coefficients
    to linear-sRGB reflectances, one lane per colour (rgb2spec_opt.cpp's
    optimization).  rgb: (N, 3) in [0, 1], a tensor (fitted on its device)
    or an array (fitted on `device`, the CUDA card by default).  Returns
    (N, 3) float32 coefficients in the nanometre domain of
    sigmoid_polynomial_eval."""
    if not isinstance(rgb, torch.Tensor):
        rgb = torch.as_tensor(np.asarray(rgb, np.float32),
                              device=resolve(device))
    rgb = rgb.to(torch.float32)
    dev = rgb.device
    lam01, basis = _sigmoid_fit_basis(device=dev)
    powers = torch.stack([lam01 * lam01, lam01, torch.ones_like(lam01)])

    def model(c):
        """(residual's model RGB (N, 3), ds/dx (N, Q)) at coefficients c."""
        x = (c[:, 0:1] * lam01 + c[:, 1:2]) * lam01 + c[:, 2:3]
        xx = 1.0 + x * x
        return sigmoid(x) @ basis, 0.5 / (xx * torch.sqrt(xx))

    eye = torch.eye(3, device=dev)
    # start from a flat spectrum at the mean reflectance: c = (0, 0, logit)
    m = torch.clamp(rgb.mean(-1), 1e-3, 1 - 1e-3)
    z = (2 * m - 1) / (2.0 * torch.sqrt(torch.clamp(m * (1 - m), min=1e-6)))
    c = torch.stack([torch.zeros_like(z), torch.zeros_like(z), z], -1)
    mu = torch.full((rgb.shape[0],), 1e-2, device=dev)
    for _ in range(iters):
        rgb_c, ds = model(c)
        r = rgb_c - rgb                                # (N, 3)
        # J[n, i, j] = sum_q basis[q, i] ds[n, q] (lam01^(2 - j))[q]
        J = torch.einsum("nq,qi,jq->nij", ds, basis, powers)
        JtJ = torch.einsum("nij,nik->njk", J, J)
        Jtr = torch.einsum("nij,ni->nj", J, r)
        dc = torch.linalg.solve(JtJ + mu[:, None, None] * eye,
                                Jtr[..., None])[..., 0]
        c_new = c - dc
        better = (((model(c_new)[0] - rgb) ** 2).sum(-1)
                  < (r ** 2).sum(-1))
        c = torch.where(better[:, None], c_new, c)
        mu = torch.where(better, mu * 0.5, mu * 4.0)
    # normalized lam01 -> nm: x = a t^2 + b t + c, t = (lam - L0) / DL
    dl = LAMBDA_MAX - LAMBDA_MIN
    a, b, cc = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack([a / dl ** 2,
                        b / dl - 2 * a * LAMBDA_MIN / dl ** 2,
                        cc - b * LAMBDA_MIN / dl + a * (LAMBDA_MIN / dl) ** 2],
                       -1)


def make_rgb2spec_table(res: int = 32, iters: int = 60, device=None):
    """An RGBToSpectrumTable-style coefficient lattice (rgb2spec_opt.cpp's
    main loop): for each max-component axis l in {r, g, b} and lattice
    point (z = the max value, x, y = the other components / max), the
    fitted coefficients, on `device` (the CUDA card by default).  Returns
    a (3, res, res, res, 3) float32 numpy array (l, z, y, x, c)."""
    zs = (np.arange(res) + 0.5) / res                  # the max component
    xs = (np.arange(res) + 0.5) / res
    out = np.zeros((3, res, res, res, 3), np.float32)
    for l in range(3):
        zz, yy, xx = np.meshgrid(zs, xs, xs, indexing="ij")
        rgb = np.zeros(zz.shape + (3,), np.float32)
        rgb[..., l] = zz
        rgb[..., (l + 1) % 3] = xx * zz
        rgb[..., (l + 2) % 3] = yy * zz
        coeffs = fit_sigmoid_polynomial(rgb.reshape(-1, 3), iters=iters,
                                        device=device)
        out[l] = coeffs.cpu().numpy().reshape(res, res, res, 3)
    return out


def rgb_albedo_spectrum_sigmoid(rgb, iters: int = 40):
    """An RGB reflectance as a smooth sigmoid-polynomial spectrum callable
    (RGBAlbedoSpectrum, spectrum.h), fitted once on the CPU (a scene-build
    step); the callable evaluates on its wavelengths' device."""
    c = fit_sigmoid_polynomial(np.asarray(rgb, np.float32).reshape(1, 3),
                               iters=iters, device="cpu")[0]

    def f(lam):
        return sigmoid_polynomial_eval(c.to(lam.device), lam)

    return f
