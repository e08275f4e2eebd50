"""Analytic daylight sky and the equal-area octahedral sphere mapping
(port of acceleratedvolrenderer_tpu/utils/sky.py, numpy as there).

`imgtool makesky` (cmd/imgtool.cpp:328) and `imgtool makeequiarea` (util/
math.h EqualAreaSquareToSphere) of the reference renderer: the Preetham et
al. 1999 daylight model from its published formulas, with sun elevation,
turbidity and resolution, written in the equal-area octahedral layout that
the image lights consume.  The portal light uses the equal-area mapping
(models/lights.py).
"""
from __future__ import annotations

import numpy as np

# Perez coefficients as linear functions of turbidity T (Preetham Table 2)
_PEREZ = {
    "Y": [(0.1787, -1.4630), (-0.3554, 0.4275), (-0.0227, 5.3251),
          (0.1206, -2.5771), (-0.0670, 0.3703)],
    "x": [(-0.0193, -0.2592), (-0.0665, 0.0008), (-0.0004, 0.2125),
          (-0.0641, -0.8989), (-0.0033, 0.0452)],
    "y": [(-0.0167, -0.2608), (-0.0950, 0.0092), (-0.0079, 0.2102),
          (-0.0441, -1.6537), (-0.0109, 0.0529)],
}


def _perez(channel, T):
    return [a * T + b for a, b in _PEREZ[channel]]


def _perez_f(coef, cos_theta, gamma):
    A, B, C, D, E = coef
    cos_theta = np.maximum(cos_theta, 1e-3)
    return ((1 + A * np.exp(B / cos_theta))
            * (1 + C * np.exp(D * gamma) + E * np.cos(gamma) ** 2))


def _zenith_chromaticity(T, ts):
    t2, t3 = ts * ts, ts ** 3
    xz = (T * T * (0.00166 * t3 - 0.00375 * t2 + 0.00209 * ts)
          + T * (-0.02903 * t3 + 0.06377 * t2 - 0.03202 * ts + 0.00394)
          + (0.11693 * t3 - 0.21196 * t2 + 0.06052 * ts + 0.25886))
    yz = (T * T * (0.00275 * t3 - 0.00610 * t2 + 0.00317 * ts)
          + T * (-0.04214 * t3 + 0.08970 * t2 - 0.04153 * ts + 0.00516)
          + (0.15346 * t3 - 0.26756 * t2 + 0.06670 * ts + 0.26688))
    return xz, yz


def sky_radiance(dirs, sun_dir, turbidity=3.0):
    """Preetham sky radiance for unit directions (N, 3), z-up.

    Returns linear sRGB (N, 3); below-horizon directions fade to black."""
    d = np.asarray(dirs, np.float64)
    sun = np.asarray(sun_dir, np.float64)
    sun = sun / np.linalg.norm(sun)
    T = float(turbidity)

    cos_theta = np.clip(d[..., 2], -1, 1)
    cos_gamma = np.clip(d @ sun, -1, 1)
    gamma = np.arccos(cos_gamma)
    ts = np.arccos(np.clip(sun[2], -1, 1))   # sun zenith angle

    chi = (4.0 / 9.0 - T / 120.0) * (np.pi - 2 * ts)
    Yz = (4.0453 * T - 4.9710) * np.tan(chi) - 0.2155 * T + 2.4192  # kcd/m^2
    Yz = max(Yz, 0.0) * 1000.0
    xz, yz = _zenith_chromaticity(T, ts)

    def channel(name, zenith):
        coef = _perez(name, T)
        return (zenith * _perez_f(coef, cos_theta, gamma)
                / _perez_f(coef, np.cos(ts) if False else 1.0, ts))

    # normalization uses F(0, theta_s) — cos(0) = 1
    Y = channel("Y", Yz)
    x = channel("x", xz)
    y = channel("y", yz)

    # Yxy -> XYZ -> linear sRGB
    y_safe = np.maximum(y, 1e-6)
    X = x / y_safe * Y
    Z = (1 - x - y) / y_safe * Y
    xyz = np.stack([X, Y, Z], -1) / 1000.0     # scale to renderer units
    m = np.array([
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ])
    rgb = xyz @ m.T
    horizon = np.clip(cos_theta / 0.02, 0.0, 1.0)[..., None]
    return np.maximum(rgb, 0.0) * horizon


def equal_area_square_to_sphere(uv):
    """[0,1]^2 -> unit sphere, equal-area octahedral mapping
    (util/math.h EqualAreaSquareToSphere)."""
    uv = np.asarray(uv, np.float64)
    up = 2 * uv[..., 0] - 1
    vp = 2 * uv[..., 1] - 1
    au, av = np.abs(up), np.abs(vp)
    sd = 1 - (au + av)
    dd = np.abs(sd)
    r = 1 - dd
    phi = np.where(r == 0, 1.0, (av - au) / np.maximum(r, 1e-12) + 1) \
        * np.pi / 4
    z = np.copysign(1 - r * r, sd)
    s = r * np.sqrt(np.maximum(2 - r * r, 0.0))
    x = np.copysign(np.cos(phi), up) * s
    y = np.copysign(np.sin(phi), vp) * s
    return np.stack([x, y, z], -1)


def equal_area_sphere_to_square(d):
    """Inverse mapping (util/math.h EqualAreaSphereToSquare)."""
    d = np.asarray(d, np.float64)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay = np.abs(x), np.abs(y)
    r = np.sqrt(np.clip(1 - np.abs(z), 0.0, 2.0))
    denom = np.maximum(ax + ay, 1e-12)
    a = np.where(ax >= ay, ay / denom, ax / denom)
    phi = np.arctan2(np.minimum(ax, ay), np.maximum(ax, ay)) * 2 / np.pi
    v_ = phi * r
    u_ = r - v_
    u2 = np.where(ax >= ay, u_, v_)
    v2 = np.where(ax >= ay, v_, u_)
    u2, v2 = np.where(z < 0, 1 - v2, u2), np.where(z < 0, 1 - u2, v2)
    u2 = np.copysign(u2, x)
    v2 = np.copysign(v2, y)
    return np.stack([0.5 * (u2 + 1), 0.5 * (v2 + 1)], -1)


def make_sky_image(resolution=512, elevation_deg=10.0, turbidity=3.0):
    """Equal-area octahedral sky EXR content (imgtool makesky)."""
    us = (np.arange(resolution) + 0.5) / resolution
    uu, vv = np.meshgrid(us, us)
    dirs = equal_area_square_to_sphere(np.stack([uu, vv], -1))
    el = np.deg2rad(elevation_deg)
    sun = np.array([np.cos(el), 0.0, np.sin(el)])
    rgb = sky_radiance(dirs.reshape(-1, 3), sun, turbidity)
    return rgb.reshape(resolution, resolution, 3).astype(np.float32)


def lat_long_to_equal_area(img, resolution=None):
    """Convert an equirectangular env map to the equal-area octahedral
    layout (imgtool makeequiarea)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    res = resolution or h
    us = (np.arange(res) + 0.5) / res
    uu, vv = np.meshgrid(us, us)
    d = equal_area_square_to_sphere(np.stack([uu, vv], -1))
    theta = np.arccos(np.clip(d[..., 2], -1, 1))
    phi = np.arctan2(d[..., 1], d[..., 0]) % (2 * np.pi)
    x = np.minimum((phi / (2 * np.pi) * w).astype(int), w - 1)
    y = np.minimum((theta / np.pi * h).astype(int), h - 1)
    return img[y, x]
