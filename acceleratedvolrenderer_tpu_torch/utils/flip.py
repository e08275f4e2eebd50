"""LDR-FLIP perceptual image difference (Andersson et al. 2020), a copy of
acceleratedvolrenderer_tpu/utils/flip.py (host numpy, as there).

`imgtool diff` reports MSE, MRSE, L1 and FLIP (pbrt
src/pbrt/cmd/imgtool.cpp:129-146, vendored src/ext/flip).
This is a numpy implementation of the published LDR-FLIP
pipeline: YCxCz opponent space -> CSF spatial filtering -> Hunt-adjusted
HyAB color difference with perceptual remap, combined with a Gaussian-
derivative feature (edge/point) difference; per-pixel error
= deltaE_color ^ (1 - deltaE_feature).

Inputs are LINEAR RGB images (the renderer's native output); they are
clipped to [0,1] and sRGB-encoded internally, matching how the reference
feeds LDR-FLIP with tonemapped renders.
"""
from __future__ import annotations

import numpy as np

_GP = 0.425  # paper's Hunt-adjustment/feature constants
_QC, _PC, _PT = 0.7, 0.4, 0.95
_QF = 0.5

# sRGB D65 matrices
_RGB2XYZ = np.array([
    [0.41238656, 0.35759149, 0.18045049],
    [0.21263682, 0.71518298, 0.07218020],
    [0.01933062, 0.11919716, 0.95037259],
])
_XYZ2RGB = np.linalg.inv(_RGB2XYZ)
_D65 = _RGB2XYZ @ np.ones(3)  # white point (X, Y, Z) of RGB=(1,1,1)


def _srgb_to_linear(c):
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c):
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.0031308, 12.92 * c,
                    1.055 * np.maximum(c, 1e-10) ** (1 / 2.4) - 0.055)


def _linrgb_to_ycxcz(rgb):
    xyz = rgb @ _RGB2XYZ.T
    x, y, z = xyz[..., 0] / _D65[0], xyz[..., 1] / _D65[1], xyz[..., 2] / _D65[2]
    return np.stack([116.0 * y - 16.0, 500.0 * (x - y), 200.0 * (y - z)], -1)


def _ycxcz_to_linrgb(ycc):
    y = (ycc[..., 0] + 16.0) / 116.0
    x = ycc[..., 1] / 500.0 + y
    z = y - ycc[..., 2] / 200.0
    xyz = np.stack([x * _D65[0], y * _D65[1], z * _D65[2]], -1)
    return xyz @ _XYZ2RGB.T


def _linrgb_to_lab(rgb):
    xyz = rgb @ _RGB2XYZ.T
    t = xyz / _D65

    f = np.where(t > (6 / 29) ** 3, np.cbrt(np.maximum(t, 1e-12)),
                 t / (3 * (6 / 29) ** 2) + 4 / 29)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return np.stack([L, a, b], -1)


def _hunt(lab):
    L = lab[..., 0]
    return np.stack([L, 0.01 * L * lab[..., 1], 0.01 * L * lab[..., 2]], -1)


def _hyab(a, b):
    d = a - b
    return np.abs(d[..., 0]) + np.linalg.norm(d[..., 1:], axis=-1)


def _sep_filter(img, k1d):
    """Separable 2D convolution with reflect padding (2D input)."""
    r = len(k1d) // 2
    p = np.pad(img, ((r, r), (0, 0)), mode="reflect")
    out = np.zeros_like(img)
    for i, w in enumerate(k1d):
        out += w * p[i:i + img.shape[0]]
    p = np.pad(out, ((0, 0), (r, r)), mode="reflect")
    out = np.zeros_like(img)
    for i, w in enumerate(k1d):
        out += w * p[:, i:i + img.shape[1]]
    return out


def _csf_kernel(a1, b1, a2, b2, ppd):
    """Spatial-domain CSF filter (sum of two Gaussians), sampled per pixel.

    S(x) = a1*sqrt(pi/b1)*exp(-pi^2 x^2 / b1) + a2*sqrt(pi/b2)*exp(...),
    x in degrees of visual angle."""
    dx = 1.0 / ppd
    rad = int(np.ceil(3.0 * np.sqrt(0.04 / (2.0 * np.pi ** 2)) * ppd))
    xs = np.arange(-rad, rad + 1) * dx
    g = (a1 * np.sqrt(np.pi / b1) * np.exp(-np.pi ** 2 * xs ** 2 / b1)
         + a2 * np.sqrt(np.pi / b2) * np.exp(-np.pi ** 2 * xs ** 2 / b2))
    return g / g.sum()


def _feature_kernels(ppd):
    """First/second Gaussian-derivative kernels for edge/point detection."""
    w = 0.082
    sigma = 0.5 * w * ppd
    rad = int(np.ceil(3.0 * sigma))
    xs = np.arange(-rad, rad + 1, dtype=np.float64)
    g = np.exp(-xs ** 2 / (2.0 * sigma ** 2))
    edge = -xs * g            # d/dx gaussian
    point = (xs ** 2 / sigma ** 2 - 1.0) * g
    # normalize as in the reference implementation
    edge /= np.abs(edge[: rad]).sum() if rad > 0 else 1.0
    point /= np.abs(point).sum() / 2.0 if np.abs(point).sum() else 1.0
    g = g / g.sum()
    return g, edge, point


def flip_ldr(ref_lin, test_lin, ppd: float = 67.0):
    """Per-pixel LDR-FLIP error map for two LINEAR-RGB images in [0, inf).

    Returns (H, W) float array in [0, 1]."""
    ref = _srgb_to_linear(_linear_to_srgb(np.asarray(ref_lin, np.float64)))
    tst = _srgb_to_linear(_linear_to_srgb(np.asarray(test_lin, np.float64)))

    # ---- color pipeline ----
    ycc_r = _linrgb_to_ycxcz(ref)
    ycc_t = _linrgb_to_ycxcz(tst)
    params = {
        0: (1.0, 0.0047, 1e-5, 1e-5),    # achromatic (A)
        1: (1.0, 0.0053, 1e-5, 1e-5),    # red-green
        2: (34.1, 0.04, 13.5, 0.025),    # blue-yellow
    }
    fr = np.empty_like(ycc_r)
    ft = np.empty_like(ycc_t)
    for c, (a1, b1, a2, b2) in params.items():
        k = _csf_kernel(a1, b1, a2, b2, ppd)
        fr[..., c] = _sep_filter(ycc_r[..., c], k)
        ft[..., c] = _sep_filter(ycc_t[..., c], k)
    # clamp back to displayable gamut
    rgb_r = np.clip(_ycxcz_to_linrgb(fr), 0.0, 1.0)
    rgb_t = np.clip(_ycxcz_to_linrgb(ft), 0.0, 1.0)
    hunt_r = _hunt(_linrgb_to_lab(rgb_r))
    hunt_t = _hunt(_linrgb_to_lab(rgb_t))
    de = _hyab(hunt_r, hunt_t)

    # normalization: HyAB distance between Hunt-adjusted green and blue
    green = _hunt(_linrgb_to_lab(np.array([[0.0, 1.0, 0.0]])))
    blue = _hunt(_linrgb_to_lab(np.array([[0.0, 0.0, 1.0]])))
    cmax = float(_hyab(green, blue)[0]) ** _QC
    pccmax = _PC * cmax
    de = de ** _QC
    de_c = np.where(
        de < pccmax,
        (_PT / pccmax) * de,
        _PT + ((de - pccmax) / (cmax - pccmax)) * (1.0 - _PT),
    )
    de_c = np.clip(de_c, 0.0, 1.0)

    # ---- feature pipeline (on [0,1]-normalized achromatic channel) ----
    ya_r = (ycc_r[..., 0] + 16.0) / 116.0
    ya_t = (ycc_t[..., 0] + 16.0) / 116.0
    g, edge, point = _feature_kernels(ppd)

    def _sep2(img, kx, ky):
        ry = len(ky) // 2
        rx = len(kx) // 2
        p = np.pad(img, ((ry, ry), (0, 0)), mode="reflect")
        tmp = np.zeros_like(img)
        for i, w in enumerate(ky):
            tmp += w * p[i:i + img.shape[0]]
        p = np.pad(tmp, ((0, 0), (rx, rx)), mode="reflect")
        out = np.zeros_like(img)
        for i, w in enumerate(kx):
            out += w * p[:, i:i + img.shape[1]]
        return out

    def fdet(img, k):
        # separable derivative: k along one axis, gaussian along the other
        return np.stack([_sep2(img, k, g), _sep2(img, g, k)], -1)

    e_r = np.linalg.norm(fdet(ya_r, edge), axis=-1)
    e_t = np.linalg.norm(fdet(ya_t, edge), axis=-1)
    p_r = np.linalg.norm(fdet(ya_r, point), axis=-1)
    p_t = np.linalg.norm(fdet(ya_t, point), axis=-1)
    de_f = np.maximum(np.abs(e_r - e_t), np.abs(p_r - p_t))
    de_f = np.clip((1.0 / np.sqrt(2.0)) * de_f, 0.0, 1.0) ** _QF

    return (de_c ** (1.0 - de_f)).astype(np.float32)


def flip_mean(ref_lin, test_lin, ppd: float = 67.0) -> float:
    """Scalar FLIP score (mean of the error map) — imgtool diff's number."""
    return float(flip_ldr(ref_lin, test_lin, ppd).mean())
