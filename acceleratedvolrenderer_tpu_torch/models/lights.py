"""Lights and light sampling (port of acceleratedvolrenderer_tpu/models/lights.py:
DistantLight, PointLight, SpotLight, UniformInfiniteLight, DiffuseAreaLight,
ImageInfiniteLight, PortalImageInfiniteLight, ProjectionLight,
GoniometricLight, the uniform, power and bvh light samplers, pdf_one_light
and escaped_radiance).

Every light is a set of batched functions of the shading points; the light
sampler evaluates the K candidate samples unbranched and selects by the
sampled index.  Spectra are callables lam -> value.  A light keeps numpy
arrays and makes its tensors once per device (utils/device.py::per_device).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, NamedTuple

import numpy as np
import torch

from ..ops import warps
from ..utils import sky
from ..utils import spectrum as sp
from ..utils import vecmath as vm
from ..utils.device import per_device
from ..utils.math import smoothstep


class LightLiSample(NamedTuple):
    L: torch.Tensor       # (N, LANES)
    wi: torch.Tensor      # (N, 3)
    dist: torch.Tensor    # (N,) distance to the light sample
    pdf: torch.Tensor     # (N,) solid-angle pdf
    valid: torch.Tensor   # (N,) bool


def _f32_on(lt, device, *arrays):
    return per_device(lt, device, lambda dev: tuple(
        torch.as_tensor(np.asarray(a, np.float32), device=dev)
        for a in arrays))


class _NoEscape:
    """A light that contributes nothing to escaped rays and is never hit
    by path sampling: its pdf_li is 0."""

    def pdf_li(self, p, wi):
        return torch.zeros((p.shape[0],), device=p.device)

    def le_escaped(self, d, lam):
        return torch.zeros_like(lam)

    def to(self, device):
        return self


@dataclass(frozen=True)
class DistantLight(_NoEscape):
    """Directional light; `direction` is the (3,) float32 unit propagation
    direction of the emitted radiance, on the render device."""
    direction: torch.Tensor
    spectrum: Callable                  # lam -> emitted radiance
    scale: float = 1.0
    scene_radius: float = 1e4
    is_delta = True
    is_infinite = False

    def to(self, device):
        return DistantLight(self.direction.to(device), self.spectrum,
                            self.scale, self.scene_radius)

    def sample_li(self, p, u2, lam):
        n = p.shape[0]
        wi = (-self.direction).expand(n, 3)
        L = (self.spectrum(lam) * self.scale).expand(lam.shape)
        dist = torch.full((n,), 2.0 * self.scene_radius, device=p.device)
        ones = torch.ones((n,), device=p.device)
        return LightLiSample(L, wi, dist, ones, ones > 0)


def _toward(pl, p):
    """(wi, dist, dist^2) from points p toward the point pl."""
    to = pl - p
    d2 = torch.clamp(vm.length_squared(to), min=1e-12)
    dist = torch.sqrt(d2)
    return to / dist[..., None], dist, d2


@dataclass(frozen=True)
class PointLight(_NoEscape):
    position: np.ndarray
    spectrum: Callable                  # lam -> radiant intensity
    scale: float = 1.0
    is_delta = True
    is_infinite = False

    def sample_li(self, p, u2, lam):
        (pl,) = _f32_on(self, p.device, self.position)
        wi, dist, d2 = _toward(pl, p)
        L = self.spectrum(lam) * self.scale / d2[..., None]
        return LightLiSample(L, wi, dist, torch.ones_like(dist),
                             torch.ones(dist.shape, dtype=torch.bool,
                                        device=p.device))


@dataclass(frozen=True)
class SpotLight(_NoEscape):
    """Spot light (lights.h:742): smooth falloff between the cosines of
    cone_angle - cone_delta and cone_angle."""
    position: np.ndarray
    direction: np.ndarray               # unit cone axis
    spectrum: Callable
    scale: float = 1.0
    cone_angle_deg: float = 30.0
    cone_delta_deg: float = 5.0
    is_delta = True
    is_infinite = False

    def sample_li(self, p, u2, lam):
        pl, axis = _f32_on(self, p.device, self.position, self.direction)
        wi, dist, d2 = _toward(pl, p)
        cos_t = vm.dot(-wi, axis)
        cos_end = np.cos(np.deg2rad(self.cone_angle_deg))
        cos_start = np.cos(np.deg2rad(self.cone_angle_deg
                                      - self.cone_delta_deg))
        falloff = smoothstep(cos_t, cos_end, cos_start)
        L = (self.spectrum(lam) * self.scale * falloff[..., None]
             / d2[..., None])
        return LightLiSample(L, wi, dist, torch.ones_like(dist), falloff > 0)


@dataclass(frozen=True)
class UniformInfiniteLight:
    """Constant environment light."""
    spectrum: Callable
    scale: float = 1.0
    scene_radius: float = 1e4
    is_delta = False
    is_infinite = True

    def to(self, device):
        return self

    def sample_li(self, p, u2, lam):
        n = p.shape[0]
        wi = warps.sample_uniform_sphere(u2)
        L = (self.spectrum(lam) * self.scale).expand(lam.shape)
        dist = torch.full((n,), 2.0 * self.scene_radius, device=p.device)
        pdf = torch.full((n,), warps.UNIFORM_SPHERE_PDF, device=p.device)
        return LightLiSample(L, wi, dist, pdf,
                             torch.ones((n,), dtype=torch.bool,
                                        device=p.device))

    def pdf_li(self, p, wi):
        return torch.full((p.shape[0],), warps.UNIFORM_SPHERE_PDF,
                          device=p.device)

    def le_escaped(self, d, lam):
        return self.spectrum(lam) * self.scale


@dataclass(frozen=True)
class DiffuseAreaLight:
    """Area emitter over a shape (lights.h:415): uniform-area sampling
    turned into solid angle; pdf_li intersects the shape again."""
    shape: object                       # models/shapes.py
    spectrum: Callable                  # lam -> emitted radiance
    scale: float = 1.0
    two_sided: bool = False
    is_delta = False
    is_infinite = False

    def to(self, device):
        return self

    def sample_li(self, p, u2, lam):
        pl, nl, pdf_area = self.shape.sample(u2)
        wi, dist, d2 = _toward(pl, p)
        cos_l = vm.dot(nl, -wi)
        emit = (cos_l > 0) | self.two_sided
        pdf_sa = pdf_area * d2 / torch.clamp(torch.abs(cos_l), min=1e-9)
        L = torch.where(emit[..., None],
                        (self.spectrum(lam) * self.scale).expand(lam.shape),
                        0.0)
        return LightLiSample(L, wi, dist * (1.0 - 1e-3), pdf_sa,
                             emit & (torch.abs(cos_l) > 1e-9))

    def pdf_li(self, p, wi):
        t, n, _ = self.shape.intersect(p, wi, torch.inf)
        cos_l = torch.abs(vm.dot(n, -wi))
        return torch.where(torch.isfinite(t), t * t / (
            torch.clamp(cos_l, min=1e-9) * self.shape.area()), 0.0)

    def le_escaped(self, d, lam):
        return torch.zeros_like(lam)

    def power_estimate(self) -> float:
        # phi = L * area * pi (* 2 when two-sided)
        sides = 2.0 if self.two_sided else 1.0
        return float(self.scale * self.shape.area() * np.pi * sides)


def _search_rows(cdf_flat, width: int, row, u):
    """Per lane, jnp.searchsorted(cdf[row], u) (side left: the count of
    entries < u) in the row-major (rows, width) CDF held flat: a binary
    search of ceil(log2(width + 1)) steps, one gather each, instead of
    gathering a whole (N, width) row per lane."""
    lo = torch.zeros_like(row)
    hi = torch.full_like(row, width)
    base = row * width
    for _ in range(int(np.ceil(np.log2(width + 1)))):
        mid = (lo + hi) >> 1
        less = cdf_flat[base + torch.clamp(mid, max=width - 1)] < u
        open_ = lo < hi
        lo = torch.where(open_ & less, mid + 1, lo)
        hi = torch.where(open_ & ~less, mid, hi)
    return lo


_TWO_PI = 2.0 * np.pi
# 2 pi^2: the Jacobian of the equirect (u, v) -> direction map over sin theta
_TWO_PI_SQ = 2.0 * np.pi * np.pi


def _mod_2pi(phi):
    """phi in (-pi, pi] to [0, 2 pi), as jnp's `%` by 2 pi (float32)."""
    return torch.where(phi < 0, phi + _TWO_PI, phi)


def _pixel(u, size):
    """clip(int(u * size), 0, size - 1)."""
    return torch.clamp((u * size).to(torch.int64), 0, size - 1)


def _le_spectral(image, uv, lam, scale):
    """The spectrum of an RGB image's texel at uv (nearest), by Smits."""
    H, W = image.shape[:2]
    rgb = image[_pixel(uv[..., 1], H), _pixel(uv[..., 0], W)]
    return sp.rgb_to_spectrum_smits_batched(rgb, lam) * scale


class ImageInfiniteLight:
    """Environment map (lights.h:552 ImageInfiniteLight): an equirect
    (H, W, 3) image, sampled by the 2D inverse CDF of its luminance times
    sin(theta).  The arrays are numpy; their tensors are made once per
    device."""
    is_delta = False
    is_infinite = True

    def __init__(self, image: np.ndarray, scale: float = 1.0,
                 scene_radius: float = 1e4, rotation=None):
        img = np.array(image, np.float32)       # a writable host copy
        assert img.ndim == 3 and img.shape[-1] == 3
        self.image = img
        self.scale = float(scale)
        self.scene_radius = float(scene_radius)
        H, W, _ = img.shape
        lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
        # the sin(theta) weight of the equirect solid-angle measure
        theta = (np.arange(H) + 0.5) / H * np.pi
        w = lum * np.sin(theta)[:, None] + 1e-12
        self._pdf_img = np.asarray(w / w.sum() * (H * W), np.float32)
        marg = w.sum(1)
        self._cdf_rows = np.asarray(np.cumsum(marg) / marg.sum(), np.float32)
        cond = np.cumsum(w, axis=1)
        self._cdf_cols = np.asarray(cond / cond[:, -1:], np.float32)
        self._H, self._W = H, W

    def to(self, device):
        return self

    def _tensors(self, device):
        return per_device(self, device, lambda dev: {
            k: torch.as_tensor(v, device=dev) for k, v in (
                ("image", self.image), ("pdf", self._pdf_img),
                ("cdf_rows", self._cdf_rows),
                ("cdf_cols", self._cdf_cols.reshape(-1)))})

    @staticmethod
    def _dir_to_uv(d):
        theta = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0))
        phi = _mod_2pi(torch.atan2(d[..., 1], d[..., 0]))
        return torch.stack([phi / _TWO_PI, theta / np.pi], -1)

    @staticmethod
    def _uv_to_dir(uv):
        phi = uv[..., 0] * 2 * np.pi
        theta = uv[..., 1] * np.pi
        st = torch.sin(theta)
        return torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                            torch.cos(theta)], -1)

    def _pdf_omega(self, t, uv):
        """The solid-angle pdf of the texel at uv: p(u, v) / (2 pi^2
        sin(theta))."""
        pdf_uv = t["pdf"][_pixel(uv[..., 1], self._H),
                          _pixel(uv[..., 0], self._W)]
        return pdf_uv / torch.clamp(
            _TWO_PI_SQ * torch.sin(uv[..., 1] * np.pi), min=1e-9)

    def sample_li(self, p, u2, lam):
        n = p.shape[0]
        t = self._tensors(p.device)
        H, W = self._H, self._W
        row = torch.clamp(torch.searchsorted(t["cdf_rows"],
                                             u2[..., 0].contiguous()),
                          0, H - 1)
        col = torch.clamp(_search_rows(t["cdf_cols"], W, row, u2[..., 1]),
                          0, W - 1)
        uv = torch.stack([(col + 0.5) / W, (row + 0.5) / H], -1)
        pdf = self._pdf_omega(t, uv)
        L = _le_spectral(t["image"], uv, lam, self.scale)
        dist = torch.full((n,), 2.0 * self.scene_radius, device=p.device)
        return LightLiSample(L, self._uv_to_dir(uv), dist, pdf, pdf > 0)

    def pdf_li(self, p, wi):
        return self._pdf_omega(self._tensors(wi.device), self._dir_to_uv(wi))

    def le_escaped(self, d, lam):
        return _le_spectral(self._tensors(d.device)["image"],
                            self._dir_to_uv(d), lam, self.scale)

    def power_estimate(self) -> float:
        img = self.image
        lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
        return float(4 * np.pi * np.pi * self.scale * lum.mean())


class PortalImageInfiniteLight:
    """Environment light seen through a portal (lights.h:639,
    lights.cpp:1109-1337).  The environment map is rectified once, on the
    host, into the portal's (alpha, beta) = (atan(x/z), atan(y/z))
    parameterization; a shading point samples it within the image window
    the portal subtends, by inverting a bilinearly read summed-area table
    with a fixed 24-step bisection per axis (exact on a piecewise-constant
    density), in place of WindowedPiecewiseConstant2D's binary search."""
    is_delta = False
    is_infinite = True

    def __init__(self, image: np.ndarray, portal, scale: float = 1.0,
                 scene_center=(0.0, 0.0, 0.0), scene_radius: float = 1e4,
                 mapping: str = "equalarea"):
        img = np.array(image, np.float32)       # a writable host copy
        assert img.ndim == 3 and img.shape[-1] == 3
        p = np.asarray(portal, np.float64)
        assert p.shape == (4, 3), "portal needs 4 vertices"
        self.portal = p.astype(np.float32)
        self.scale = float(scale)
        self.scene_radius = float(scene_radius)
        self.scene_center = np.asarray(scene_center, np.float32)

        # the portal frame (Frame::FromXY(p03, p01), lights.cpp:1152)
        def _nrm(v):
            return v / np.linalg.norm(v)

        fx = _nrm(p[3] - p[0])
        fy = _nrm(p[1] - p[0])
        fz = _nrm(np.cross(fx, fy))
        self._frame = np.stack([fx, fy, fz]).astype(np.float32)

        # rectify the map into the portal parameterization
        # (lights.cpp:1156-1173), keeping a square resolution
        R = min(img.shape[0], img.shape[1])
        self._R = R
        ix = (np.arange(R) + 0.5) / R
        uu, vv = np.meshgrid(ix, ix)
        tx, ty = np.tan(-np.pi / 2 + uu * np.pi), np.tan(-np.pi / 2 + vv * np.pi)
        wl = np.stack([tx, ty, np.ones_like(tx)], -1)
        wl /= np.linalg.norm(wl, axis=-1, keepdims=True)
        wworld = wl[..., 0:1] * fx + wl[..., 1:2] * fy + wl[..., 2:3] * fz
        if mapping == "equalarea":
            src_uv = sky.equal_area_sphere_to_square(wworld)
            sx = np.clip((src_uv[..., 0] * img.shape[1]).astype(np.int64),
                         0, img.shape[1] - 1)
            sy = np.clip((src_uv[..., 1] * img.shape[0]).astype(np.int64),
                         0, img.shape[0] - 1)
        else:  # an equirect source
            th = np.arccos(np.clip(wworld[..., 2], -1, 1))
            ph = np.arctan2(wworld[..., 1], wworld[..., 0]) % (2 * np.pi)
            sx = np.clip((ph / (2 * np.pi) * img.shape[1]).astype(np.int64),
                         0, img.shape[1] - 1)
            sy = np.clip((th / np.pi * img.shape[0]).astype(np.int64),
                         0, img.shape[0] - 1)
        rect = img[sy, sx]
        self.image = rect

        # sampling weights mean(rgb) * dw/duv, so that pdf_omega ~ L
        # (Image::GetSamplingDistribution with duv_dw, lights.cpp:1175-1181)
        dw_duv = (np.pi ** 2 * (1 - wl[..., 0] ** 2) * (1 - wl[..., 1] ** 2)
                  / np.maximum(wl[..., 2], 1e-9))
        d = np.maximum(rect.mean(-1), 0.0).astype(np.float64) * dw_duv
        self._d = d.astype(np.float32)
        # sat[j, i]: the sum of d over pixels [0..i) x [0..j), scaled so the
        # whole window integrates to mean(d) (uv measure)
        sat = np.zeros((R + 1, R + 1), np.float64)
        np.cumsum(np.cumsum(d, 0), 1, out=sat[1:, 1:])
        self._sat = (sat / (R * R)).astype(np.float32)
        # Phi (lights.cpp:1183): fluence times area
        self._area = float(np.linalg.norm(p[1] - p[0])
                           * np.linalg.norm(p[3] - p[0]))
        lum = rect.mean(-1).astype(np.float64)
        self._phi = float(scale * self._area
                          * (lum / np.maximum(dw_duv, 1e-9)).mean())

    def to(self, device):
        return self

    def _tensors(self, device):
        return per_device(self, device, lambda dev: {
            k: torch.as_tensor(v, device=dev) for k, v in (
                ("frame", self._frame), ("portal", self.portal),
                ("center", self.scene_center), ("image", self.image),
                ("d", self._d), ("sat", self._sat))})

    # ---- the portal-space mapping (lights.h:685-715) ----
    @staticmethod
    def _image_from_render(t, w):
        lx = vm.dot(w, t["frame"][0])
        ly = vm.dot(w, t["frame"][1])
        lz = vm.dot(w, t["frame"][2])
        valid = lz > 1e-7
        lzs = torch.clamp(lz, min=1e-7)
        u = torch.clamp((torch.atan2(lx, lzs) + np.pi / 2) / np.pi, 0.0, 1.0)
        v = torch.clamp((torch.atan2(ly, lzs) + np.pi / 2) / np.pi, 0.0, 1.0)
        dw_duv = np.pi ** 2 * (1 - lx * lx) * (1 - ly * ly) / lzs
        return torch.stack([u, v], -1), dw_duv, valid

    @staticmethod
    def _render_from_image(t, uv):
        x = torch.tan(-np.pi / 2 + uv[..., 0] * np.pi)
        y = torch.tan(-np.pi / 2 + uv[..., 1] * np.pi)
        wl = torch.stack([x, y, torch.ones_like(x)], -1)
        wl = wl / vm.length(wl)[..., None]
        f = t["frame"]
        w = wl[..., 0:1] * f[0] + wl[..., 1:2] * f[1] + wl[..., 2:3] * f[2]
        dw_duv = (np.pi ** 2 * (1 - wl[..., 0] ** 2) * (1 - wl[..., 1] ** 2)
                  / torch.clamp(wl[..., 2], min=1e-9))
        return w, dw_duv

    def _bounds(self, t, pt):
        """The image-space window the portal subtends from pt (lights.h
        ImageBounds): (lo, hi, valid)."""
        uv0, _, v0 = self._image_from_render(
            t, vm.normalize(t["portal"][0] - pt))
        uv1, _, v1 = self._image_from_render(
            t, vm.normalize(t["portal"][2] - pt))
        return torch.minimum(uv0, uv1), torch.maximum(uv0, uv1), v0 & v1

    # ---- the windowed distribution: bilinear SAT and bisection ----
    def _sat_at(self, t, u, v):
        R = self._R
        xf = torch.clamp(u, 0.0, 1.0) * R
        yf = torch.clamp(v, 0.0, 1.0) * R
        x0 = torch.clamp(xf.to(torch.int64), 0, R - 1)
        y0 = torch.clamp(yf.to(torch.int64), 0, R - 1)
        fx = xf - x0
        fy = yf - y0
        s = t["sat"]
        return ((1 - fx) * (1 - fy) * s[y0, x0] + fx * (1 - fy) * s[y0, x0 + 1]
                + (1 - fx) * fy * s[y0 + 1, x0] + fx * fy * s[y0 + 1, x0 + 1])

    def _window_integral(self, t, lo, hi):
        return (self._sat_at(t, hi[..., 0], hi[..., 1])
                - self._sat_at(t, lo[..., 0], hi[..., 1])
                - self._sat_at(t, hi[..., 0], lo[..., 1])
                + self._sat_at(t, lo[..., 0], lo[..., 1]))

    def _density(self, t, uv):
        R = self._R
        return t["d"][_pixel(uv[..., 1], R), _pixel(uv[..., 0], R)]

    def _bisect(self, integral, tgt, a, b):
        """24 halvings of [a, b] toward integral(x) = tgt; the midpoint."""
        for _ in range(24):
            m = 0.5 * (a + b)
            gt = integral(m) < tgt
            a, b = torch.where(gt, m, a), torch.where(gt, b, m)
        return 0.5 * (a + b)

    def _sample_windowed(self, t, u2, lo, hi):
        """uv ~ d within the window: (uv, pdf_uv within it, total > 0)."""
        x0, y0 = lo[..., 0], lo[..., 1]
        x1, y1 = hi[..., 0], hi[..., 1]
        sat = lambda u, v: self._sat_at(t, u, v)

        def colint(x):  # the integral over [x0, x] x [y0, y1]
            return sat(x, y1) - sat(x, y0) - sat(x0, y1) + sat(x0, y0)

        total = colint(x1)
        x = self._bisect(colint, u2[..., 0] * total, x0, x1)
        # the conditional along the sampled pixel column
        R = self._R
        ix = torch.clamp((x * R).to(torch.int64), 0, R - 1)
        cx0, cx1 = ix / R, (ix + 1) / R

        def rowint(y):  # the integral over the column x [y0, y]
            return sat(cx1, y) - sat(cx0, y) - sat(cx1, y0) + sat(cx0, y0)

        y = self._bisect(rowint, u2[..., 1] * rowint(y1), y0, y1)
        uv = torch.stack([x, y], -1)
        # each pixel's weight d covers uv-area 1/R^2 and the SAT is scaled
        # by 1/R^2, so the density at uv is d[pixel] itself
        pdf_uv = self._density(t, uv) / torch.clamp(total, min=1e-20)
        return uv, pdf_uv, total > 0

    # ---- the light interface ----
    def sample_li(self, p, u2, lam):
        n = p.shape[0]
        t = self._tensors(p.device)
        lo, hi, bvalid = self._bounds(t, p)
        uv, pdf_uv, ok = self._sample_windowed(t, u2, lo, hi)
        wi, dw_duv = self._render_from_image(t, uv)
        # pdf_omega = pdf_uv / (dw/duv) (lights.cpp:1243)
        pdf = pdf_uv / torch.clamp(dw_duv, min=1e-9)
        L = _le_spectral(t["image"], uv, lam, self.scale)
        dist = torch.full((n,), 2.0 * self.scene_radius, device=p.device)
        return LightLiSample(L, wi, dist, torch.clamp(pdf, min=1e-20),
                             bvalid & ok & (pdf > 0))

    def _inside(self, t, uv, pt):
        lo, hi, bvalid = self._bounds(t, pt)
        inside = torch.all(uv >= lo, -1) & torch.all(uv <= hi, -1)
        return lo, hi, bvalid & inside

    def pdf_li(self, p, wi):
        t = self._tensors(p.device)
        uv, dw_duv, dvalid = self._image_from_render(t, wi)
        lo, hi, inside = self._inside(t, uv, p)
        integ = self._window_integral(t, lo, hi)
        pdf_uv = self._density(t, uv) / torch.clamp(integ, min=1e-20)
        return torch.where(dvalid & inside & (integ > 0),
                           pdf_uv / torch.clamp(dw_duv, min=1e-9), 0.0)

    def le_escaped(self, d, lam):
        # the reference's Le tests ray.o's window (lights.cpp:1208); an
        # escaped ray carries its direction only, so the scene centre
        # stands in for its origin
        t = self._tensors(d.device)
        uv, _, dvalid = self._image_from_render(t, d)
        _, _, inside = self._inside(t, uv, t["center"].expand(d.shape))
        L = _le_spectral(t["image"], uv, lam, self.scale)
        return torch.where((dvalid & inside)[..., None], L, 0.0)

    def power_estimate(self) -> float:
        return max(self._phi, 1e-9)


@dataclass(frozen=True)
class ProjectionLight(_NoEscape):
    """Image projector (lights.h:308): a point light whose intensity is
    modulated by an image over the field of view along `direction`."""
    position: np.ndarray
    direction: np.ndarray
    image: object                        # textures.ImageTexture (rgb)
    spectrum: Callable
    scale: float = 1.0
    fov_deg: float = 45.0
    is_delta = True
    is_infinite = False

    def _consts(self, device):
        def make(dev):
            z = np.asarray(self.direction, np.float64)
            z = z / np.linalg.norm(z)
            up = (np.array([0, 1, 0.0]) if abs(z[1]) < 0.9
                  else np.array([1, 0, 0.0]))
            x = np.cross(up, z)
            x /= np.linalg.norm(x)
            y = np.cross(z, x)
            return tuple(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                         for a in (self.position, x, y, z))
        return per_device(self, device, make)

    def sample_li(self, p, u2, lam):
        pl, bx, by, bz = self._consts(p.device)
        wi, dist, d2 = _toward(pl, p)
        w = -wi  # from the light to the point
        lz = vm.dot(w, bz)
        tan_half = float(np.float32(np.tan(np.deg2rad(self.fov_deg) / 2)))
        lzs = torch.clamp(lz, min=1e-9)
        u = vm.dot(w, bx) / lzs / tan_half * 0.5 + 0.5
        v = vm.dot(w, by) / lzs / tan_half * 0.5 + 0.5
        inside = (lz > 0) & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
        mod = sp.rgb_to_spectrum_smits_batched(
            self.image.eval(torch.stack([u, v], -1)), lam)
        L = (self.spectrum(lam) * self.scale) * mod / d2[..., None]
        L = torch.where(inside[..., None], L, 0.0)
        return LightLiSample(L, wi, dist, torch.ones_like(dist), inside)

    def power_estimate(self) -> float:
        return float(self.scale)


@dataclass(frozen=True)
class GoniometricLight(_NoEscape):
    """A point light whose intensity over directions comes from an
    equirect image (lights.h:361)."""
    position: np.ndarray
    image: object                        # textures.ImageTexture
    spectrum: Callable
    scale: float = 1.0
    is_delta = True
    is_infinite = False

    def sample_li(self, p, u2, lam):
        (pl,) = _f32_on(self, p.device, self.position)
        wi, dist, d2 = _toward(pl, p)
        uv = ImageInfiniteLight._dir_to_uv(-wi)
        rgb = self.image.eval(uv)
        mod = (sp.rgb_to_spectrum_smits_batched(rgb, lam)
               if rgb.ndim == uv.ndim else rgb[..., None])
        L = self.spectrum(lam) * self.scale * mod / d2[..., None]
        return LightLiSample(L, wi, dist, torch.ones_like(dist),
                             torch.ones(dist.shape, dtype=torch.bool,
                                        device=p.device))

    def power_estimate(self) -> float:
        return float(4 * np.pi * self.scale)


def light_power(lt) -> float:
    """Scalar power proxy of the power light sampler (lightsamplers.h)."""
    if hasattr(lt, "power_estimate"):
        return max(lt.power_estimate(), 1e-9)
    if isinstance(lt, PointLight):
        return max(4 * np.pi * lt.scale, 1e-9)
    if isinstance(lt, SpotLight):
        cos_end = np.cos(np.deg2rad(lt.cone_angle_deg))
        return max(2 * np.pi * (1 - cos_end) * lt.scale, 1e-9)
    if isinstance(lt, DistantLight):
        return max(np.pi * lt.scene_radius ** 2 * lt.scale, 1e-9)
    if isinstance(lt, UniformInfiniteLight):
        return max(4 * np.pi * np.pi * lt.scene_radius ** 2 * lt.scale, 1e-9)
    return 1.0


def _light_center(lt):
    """A representative position for the adaptive (bvh) importance."""
    if hasattr(lt, "position"):
        return np.asarray(lt.position, np.float32)
    shape = getattr(lt, "shape", None)
    if shape is not None:
        if hasattr(shape, "center"):
            return np.asarray(shape.center, np.float32)
        if hasattr(shape, "origin"):
            o = np.asarray(shape.origin, np.float32)
            e1 = np.asarray(getattr(shape, "e1", 0.0), np.float32)
            e2 = np.asarray(getattr(shape, "e2", 0.0), np.float32)
            return o + 0.5 * e1 + 0.5 * e2
    return np.zeros(3, np.float32)


def _bvh_consts(lt, device):
    """(center, spot axis or None, area-light normal or None) as tensors."""
    def make(dev):
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                         device=dev)
        axis = nrm = None
        if isinstance(lt, SpotLight):
            axis = as_t(lt.direction)
            axis = axis / torch.linalg.norm(axis)
        elif isinstance(lt, DiffuseAreaLight) and hasattr(lt.shape, "e1"):
            nv = np.cross(np.asarray(lt.shape.e1, np.float64),
                          np.asarray(lt.shape.e2, np.float64))
            ln = np.linalg.norm(nv)
            if ln > 0:
                nrm = as_t((nv / ln).astype(np.float32))
        return as_t(_light_center(lt)), axis, nrm
    return per_device(lt, ("bvh", str(device)), lambda _: make(device))


def _adaptive_pmfs(lights: List, p):
    """Per-point light pmfs (N, K): the BVH light sampler's importance
    phi cos(theta') / d^2 (lightsamplers.h:260) computed exactly over all K
    lights, with the reference's pInfinite split for infinite lights."""
    n = p.shape[0]
    dev = p.device
    k = len(lights)
    inf_mask = [bool(lt.is_infinite) for lt in lights]
    n_inf = sum(inf_mask)
    n_fin = k - n_inf
    p_infinite = n_inf / (n_inf + (1 if n_fin else 0)) if k else 0.0
    imps = []
    for lt in lights:
        if lt.is_infinite:
            imps.append(torch.zeros((n,), device=dev))
            continue
        phi = float(light_power(lt))
        if isinstance(lt, DistantLight):
            # an unbounded directional light: constant importance
            imps.append(torch.full((n,), phi, device=dev))
            continue
        c, axis, nrm = _bvh_consts(lt, dev)
        to = p - c
        d2 = torch.clamp(vm.length_squared(to), min=1e-8)
        imp = phi / d2
        if axis is not None:
            # the cone's falloff (LightBounds orientation cone)
            cos_p = vm.dot(to, axis) / torch.sqrt(d2)
            cos_cone = float(np.cos(np.deg2rad(lt.cone_angle_deg)))
            imp = imp * torch.where(cos_p >= cos_cone, 1.0, 1e-3)
        elif nrm is not None and not lt.two_sided:
            cos_t = vm.dot(to, nrm) / torch.sqrt(d2)
            imp = imp * torch.clamp(cos_t, min=1e-3)
        imps.append(imp)
    imp_mat = torch.stack(imps, -1)
    fin_sum = torch.clamp(torch.sum(imp_mat, -1), min=1e-30)
    pmf = imp_mat / fin_sum[:, None] * (1.0 - p_infinite)
    if n_inf:
        # the infinite lights' columns (importance 0) take pInfinite / n_inf
        share = torch.full((n,), float(np.float32(p_infinite / n_inf)),
                           device=dev)
        pmf = torch.stack([share if inf else pmf[:, i]
                           for i, inf in enumerate(inf_mask)], -1)
    return pmf


def _power_pmfs(lights):
    pw = np.asarray([light_power(lt) for lt in lights], np.float64)
    return pw / pw.sum()


def sample_one_light(lights: List, p, u1, u2, lam, strategy: str = "uniform"):
    """Pick one light with pmf 1/K ("uniform"), proportional to its power
    ("power") or to its importance at each point ("bvh"), and return its
    sample with the pmf folded into the pdf, plus the per-lane delta flag."""
    if strategy not in ("uniform", "power", "bvh"):
        raise ValueError(f"unknown light sampler {strategy!r}")
    k = len(lights)
    n = p.shape[0]
    dev = p.device
    if k == 0:
        z = torch.zeros((n,), device=dev)
        return (LightLiSample(torch.zeros_like(lam),
                              torch.zeros((n, 3), device=dev), z, z, z > 0),
                z > 0)
    pmf = None
    if strategy == "bvh":
        pmf_point = _adaptive_pmfs(lights, p)
        cdf = torch.cumsum(pmf_point, -1)
        idx = torch.clamp((u1[:, None] >= cdf).sum(-1), 0, k - 1)
        pmf = torch.gather(pmf_point, 1, idx[:, None])[:, 0]
    elif strategy == "power":
        pmfs = _power_pmfs(lights).astype(np.float32)
        cdf = np.cumsum(_power_pmfs(lights)).astype(np.float32)
        # searchsorted (left) on the float32 cdf: the count of entries < u1
        idx = torch.clamp(sum((u1 > float(c)).to(torch.int64) for c in cdf),
                          0, k - 1)
        pmf = torch.full((n,), float(pmfs[0]), device=dev)
        for i in range(1, k):
            pmf = torch.where(idx == i, float(pmfs[i]), pmf)
    else:
        idx = torch.clamp((u1 * k).to(torch.int64), max=k - 1)
    samples = [lt.sample_li(p, u2, lam) for lt in lights]
    out = samples[0]
    is_delta = torch.full((n,), bool(lights[0].is_delta), device=dev)
    for i in range(1, k):
        sel = idx == i
        s = samples[i]
        out = LightLiSample(
            torch.where(sel[:, None], s.L, out.L),
            torch.where(sel[:, None], s.wi, out.wi),
            torch.where(sel, s.dist, out.dist),
            torch.where(sel, s.pdf, out.pdf),
            torch.where(sel, s.valid, out.valid))
        is_delta = torch.where(sel, bool(lights[i].is_delta), is_delta)
    if pmf is None:
        # the uniform pmf, rounded to float32 as the reference's table is
        pmf = float(np.float32(1.0 / k))
    return LightLiSample(out.L, out.wi, out.dist, out.pdf * pmf,
                         out.valid), is_delta


def pdf_one_light(lights: List, p, wi, strategy: str = "uniform"):
    """The pmf-weighted PDF_Li summed over the non-delta lights: the light
    strategy's pdf of a path-sampled emitter hit, for MIS."""
    k = len(lights)
    n = p.shape[0]
    pdf = torch.zeros((n,), device=p.device)
    if k == 0:
        return pdf
    if strategy == "bvh":
        pmf_mat = _adaptive_pmfs(lights, p)
        for i, lt in enumerate(lights):
            if not lt.is_delta:
                pdf = pdf + lt.pdf_li(p, wi) * pmf_mat[:, i]
        return pdf
    pmfs = (_power_pmfs(lights) if strategy == "power"
            else np.full((k,), 1.0 / k))
    for lt, pm in zip(lights, pmfs):
        if not lt.is_delta:
            pdf = pdf + lt.pdf_li(p, wi) * float(pm)
    return pdf


def escaped_radiance(lights: List, d, lam):
    """Sum of Le over infinite lights for escaped rays, plus the uniform
    sampler's MIS pdf (pmf * PDF_Li) over the non-delta ones."""
    L = torch.zeros_like(lam)
    pdf = torch.zeros((d.shape[0],), device=d.device)
    k = max(len(lights), 1)
    for lt in lights:
        if lt.is_infinite:
            L = L + lt.le_escaped(d, lam)
            pdf = pdf + lt.pdf_li(d, d) / k
    return L, pdf
