"""Textures: material parameters that vary over the surface
(port of acceleratedvolrenderer_tpu/models/textures.py).

A texture is a batched function of the hit's uv (N, 2), and through
eval_texture of its position p and normal n: a float texture returns (N,),
an rgb texture (N, 3), which the materials turn into spectra by Smits'
conversion.  Every texture and mapping the reference's eval_texture reaches
is ported; ImageTexture's filtered (MIP-map) lookup is not.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def _full(uv, value):
    return torch.full(uv.shape[:-1], float(value), dtype=torch.float32,
                      device=uv.device)


@dataclass(frozen=True)
class ConstantTexture:
    value: float = 1.0

    def eval(self, uv):
        return _full(uv, self.value)


@dataclass(frozen=True)
class ConstantRGBTexture:
    rgb: tuple = (1.0, 1.0, 1.0)

    def eval(self, uv):
        return torch.tensor(self.rgb, dtype=torch.float32,
                            device=uv.device).expand(uv.shape[:-1] + (3,))


@dataclass(frozen=True)
class ScaleTexture:
    base: object
    scale: float = 1.0

    def eval_ctx(self, uv, p=None, n=None):
        return eval_texture(self.base, uv, p=p, n=n) * float(np.float32(
            self.scale))

    def eval(self, uv):
        return self.eval_ctx(uv)


def _select(odd, a, b):
    if a.dim() > odd.dim():
        odd = odd[..., None]
    return torch.where(odd, b, a)


@dataclass(frozen=True)
class CheckerboardTexture:
    """2D checker in uv (pbrt CheckerboardTexture, dimension 2)."""
    tex1: object
    tex2: object
    uscale: float = 1.0
    vscale: float = 1.0

    def eval_ctx(self, uv, p=None, n=None):
        iu = torch.floor(uv[..., 0] * self.uscale).to(torch.int32)
        iv = torch.floor(uv[..., 1] * self.vscale).to(torch.int32)
        odd = ((iu + iv) % 2) != 0
        return _select(odd, eval_texture(self.tex1, uv, p=p, n=n),
                       eval_texture(self.tex2, uv, p=p, n=n))

    def eval(self, uv):
        return self.eval_ctx(uv)


@dataclass(frozen=True)
class UVTexture:
    """Debug: rgb = (u, v, 0)."""

    def eval(self, uv):
        return torch.cat([uv, torch.zeros_like(uv[..., :1])], -1)


@dataclass(frozen=True)
class MixTexture:
    tex1: object
    tex2: object
    amount: float = 0.5

    def eval_ctx(self, uv, p=None, n=None):
        a = eval_texture(self.tex1, uv, p=p, n=n)
        b = eval_texture(self.tex2, uv, p=p, n=n)
        return a * (1.0 - self.amount) + b * self.amount

    def eval(self, uv):
        return self.eval_ctx(uv)


class ImageTexture:
    """Bilinear image lookup, wrap-repeat (pbrt ImageTexture).
    `filtered=True` builds a MIP map (models/mipmap.py: trilinear and
    fixed-probe EWA) for eval_filtered / eval_ewa, which take the uv
    footprint a caller tracks from ray differentials."""

    def __init__(self, image: np.ndarray, scale: float = 1.0,
                 invert: bool = False, filtered: bool = False,
                 max_anisotropy: float = 8.0):
        img = np.array(image, np.float32)
        if img.ndim == 2:
            img = img[..., None]
        self.image = img                        # (H, W, C) host copy
        self.scale = float(scale)
        self.invert = bool(invert)
        self._device_image = {}
        self.mipmap = None
        if filtered:
            from .mipmap import MIPMap

            self.mipmap = MIPMap(img, max_anisotropy=max_anisotropy)

    def _post(self, out):
        out = out * self.scale
        if self.invert:
            out = 1.0 - out
        if self.image.shape[2] == 1:
            out = out[..., 0]
        return out

    def _mip(self):
        if self.mipmap is None:
            raise ValueError("ImageTexture: construct with filtered=True "
                             "for a filtered lookup")
        return self.mipmap

    def eval_filtered(self, uv, width):
        """Trilinear MIP lookup (MIPMap::Filter); width = uv footprint."""
        return self._post(self._mip().lookup_trilinear(uv, width))

    def eval_ewa(self, uv, duv0, duv1):
        """Anisotropic EWA lookup (MIPMap::EWA)."""
        return self._post(self._mip().lookup_ewa(uv, duv0, duv1))

    def eval(self, uv):
        key = str(uv.device)
        if key not in self._device_image:
            self._device_image[key] = torch.as_tensor(self.image,
                                                      device=uv.device)
        im = self._device_image[key]
        H, W, _ = im.shape
        u = uv[..., 0] % 1.0
        v = uv[..., 1] % 1.0
        x = u * W - 0.5
        y = v * H - 0.5
        x0 = torch.floor(x).to(torch.int64)
        y0 = torch.floor(y).to(torch.int64)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        x0w, x1w = x0 % W, (x0 + 1) % W
        y0w, y1w = y0 % H, (y0 + 1) % H
        return self._post(
            (1 - fy) * ((1 - fx) * im[y0w, x0w] + fx * im[y0w, x1w])
            + fy * ((1 - fx) * im[y1w, x0w] + fx * im[y1w, x1w]))


# ---------------------------------------------------------------------------
# Noise textures (textures.h FBm, Wrinkled, Windy, Marble, Dots): gradient
# noise over a hashed permutation, as the reference builds it.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _hash3(ix, iy, iz):
    """The reference's uint32 hash, in int64 arithmetic masked to 32 bits."""
    u = lambda a: a.to(torch.int64) & _M32
    h = (((u(ix) * 0x9E3779B1) & _M32) ^ ((u(iy) * 0x85EBCA77) & _M32)
         ^ ((u(iz) * 0xC2B2AE3D) & _M32))
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _M32
    return h ^ (h >> 12)


def _grad(ix, iy, iz, fx, fy, fz):
    h = _hash3(ix, iy, iz) & 15
    u = torch.where(h < 8, fx, fy)
    v = torch.where(h < 4, fy, torch.where((h == 12) | (h == 14), fx, fz))
    return (torch.where(h & 1 == 0, u, -u) + torch.where(h & 2 == 0, v, -v))


def perlin_noise(p):
    """Gradient noise at points p (..., 3) -> (...,) in about [-1, 1]."""
    pi = torch.floor(p)
    pf = p - pi
    ix, iy, iz = (pi[..., k].to(torch.int32) for k in range(3))
    fx, fy, fz = pf[..., 0], pf[..., 1], pf[..., 2]

    def fade(t):
        return t * t * t * (t * (t * 6 - 15) + 10)

    wx, wy, wz = fade(fx), fade(fy), fade(fz)
    n = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            n00 = _grad(ix, iy + dy, iz + dz, fx, fy - dy, fz - dz)
            n10 = _grad(ix + 1, iy + dy, iz + dz, fx - 1, fy - dy, fz - dz)
            nx = n00 + wx * (n10 - n00)
            if dy == 0:
                ny0 = nx
            else:
                ny = ny0 + wy * (nx - ny0)
                if dz == 0:
                    nz0 = ny
                else:
                    n = nz0 + wz * (ny - nz0)
    return n


def fbm(p, octaves: int = 6, omega: float = 0.5):
    """Fractional Brownian motion (util/math.cpp FBm)."""
    total = 0.0
    lam, o = 1.0, 1.0
    for _ in range(octaves):
        total = total + o * perlin_noise(p * lam)
        lam *= 1.99
        o *= omega
    return total


def turbulence(p, octaves: int = 6, omega: float = 0.5):
    """Sum of |noise| octaves (util/math.cpp Turbulence)."""
    total = 0.0
    lam, o = 1.0, 1.0
    for _ in range(octaves):
        total = total + o * torch.abs(perlin_noise(p * lam))
        lam *= 1.99
        o *= omega
    return total


def _uv3(uv, scale):
    return torch.stack([uv[..., 0] * scale, uv[..., 1] * scale,
                        torch.zeros_like(uv[..., 0])], -1)


@dataclass(frozen=True)
class FBmTexture:
    octaves: int = 6
    omega: float = 0.5
    scale: float = 8.0

    def eval(self, uv):
        return fbm(_uv3(uv, self.scale), self.octaves, self.omega)


@dataclass(frozen=True)
class WrinkledTexture:
    octaves: int = 6
    omega: float = 0.5
    scale: float = 8.0

    def eval(self, uv):
        return turbulence(_uv3(uv, self.scale), self.octaves, self.omega)


@dataclass(frozen=True)
class WindyTexture:
    """Low-frequency wind strength modulating higher-frequency waves."""
    scale: float = 8.0

    def eval(self, uv):
        p = _uv3(uv, self.scale)
        strength = torch.abs(fbm(0.1 * p, 3, 0.5))
        return strength * torch.abs(fbm(p, 6, 0.5))


_MARBLE = ((0.58, 0.58, 0.6), (0.58, 0.58, 0.6), (0.58, 0.58, 0.6),
           (0.5, 0.5, 0.5), (0.6, 0.59, 0.58), (0.58, 0.58, 0.6),
           (0.58, 0.58, 0.6), (0.2, 0.2, 0.33), (0.58, 0.58, 0.6))


@dataclass(frozen=True)
class MarbleTexture:
    """sin-warped fbm through a color spline; returns (N, 3) rgb."""
    scale: float = 4.0
    variation: float = 0.2
    octaves: int = 6
    omega: float = 0.5

    def eval(self, uv):
        p = _uv3(uv, self.scale)
        t = 0.5 + 0.5 * torch.sin(
            self.scale * uv[..., 1]
            + self.variation * fbm(p, self.octaves, self.omega) * 10.0)
        c = torch.tensor(_MARBLE, dtype=torch.float32, device=uv.device)
        k = t * (len(_MARBLE) - 1)
        i0 = torch.clamp(k.to(torch.int64), 0, len(_MARBLE) - 2)
        f = (k - i0)[..., None]
        return c[i0] * (1 - f) + c[i0 + 1] * f


@dataclass(frozen=True)
class DotsTexture:
    """Polka dots with hashed per-cell centers."""
    inside: float = 1.0
    outside: float = 0.0
    scale: float = 8.0

    def eval(self, uv):
        su = uv[..., 0] * self.scale
        sv = uv[..., 1] * self.scale
        cu = torch.floor(su).to(torch.int32)
        cv = torch.floor(sv).to(torch.int32)
        h = _hash3(cu, cv, torch.zeros_like(cu))
        has_dot = (h & 0xFF) < 128
        byte = lambda s: ((h >> s) & 0xFF).to(torch.float32) / 255.0
        cx = cu + 0.35 + 0.3 * byte(8)
        cy = cv + 0.35 + 0.3 * byte(16)
        r = 0.35 * byte(24) + 0.1
        inside = has_dot & ((su - cx) ** 2 + (sv - cy) ** 2 < r * r)
        return torch.where(inside, float(self.inside), float(self.outside))


# ---------------------------------------------------------------------------
# Texture-coordinate mappings (textures.h:86-248).  map(uv, p) takes the hit
# parameterization (N, 2) and the render-space hit position (N, 3).
# ---------------------------------------------------------------------------

def _xform_p(m, p, uv=None):
    """Apply a 4x4 texture-from-render transform to points (N, 3).  Without
    a hit position, uv lifted to 3D stands in for it, as in the reference."""
    if p is None:
        if uv is None:
            raise ValueError("positional texture mapping evaluated with "
                             "neither hit position nor uv")
        p = torch.cat([uv[..., :2], torch.zeros_like(uv[..., :1])], -1)
    if m is None:
        return p
    m = torch.as_tensor(np.asarray(m, np.float32), device=p.device)
    return p @ m[:3, :3].T + m[:3, 3]


@dataclass(frozen=True)
class UVMapping:
    """st = (su * u + du, sv * v + dv) (textures.h:86)."""
    su: float = 1.0
    sv: float = 1.0
    du: float = 0.0
    dv: float = 0.0

    def map(self, uv, p=None):
        return torch.stack([uv[..., 0] * self.su + self.du,
                            uv[..., 1] * self.sv + self.dv], -1)


@dataclass(frozen=True)
class SphericalMapping:
    """(theta / pi, phi / 2pi) of the texture-space hit point."""
    texture_from_render: Optional[tuple] = None

    def map(self, uv, p=None):
        pt = _xform_p(self.texture_from_render, p, uv)
        v = pt / torch.clamp(torch.linalg.norm(pt, dim=-1, keepdim=True),
                             min=1e-20)
        theta = torch.acos(torch.clamp(v[..., 2], -1.0, 1.0))
        phi = torch.atan2(v[..., 1], v[..., 0])
        phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
        return torch.stack([theta / np.pi, phi / (2 * np.pi)], -1)


@dataclass(frozen=True)
class CylindricalMapping:
    """((pi + atan2(y, x)) / 2pi, z) (textures.h:147)."""
    texture_from_render: Optional[tuple] = None

    def map(self, uv, p=None):
        pt = _xform_p(self.texture_from_render, p, uv)
        s = (np.pi + torch.atan2(pt[..., 1], pt[..., 0])) / (2 * np.pi)
        return torch.stack([s, pt[..., 2]], -1)


@dataclass(frozen=True)
class PlanarMapping:
    """st = (ds + p . vs, dt + p . vt) (textures.h:175)."""
    vs: tuple = (1.0, 0.0, 0.0)
    vt: tuple = (0.0, 1.0, 0.0)
    ds: float = 0.0
    dt: float = 0.0
    texture_from_render: Optional[tuple] = None

    def map(self, uv, p=None):
        pt = _xform_p(self.texture_from_render, p, uv)
        vs = torch.tensor(self.vs, dtype=torch.float32, device=pt.device)
        vt = torch.tensor(self.vt, dtype=torch.float32, device=pt.device)
        return torch.stack([self.ds + pt @ vs, self.dt + pt @ vt], -1)


@dataclass(frozen=True)
class PointTransformMapping:
    """3D mapping: the texture-space point itself (textures.h:229)."""
    texture_from_render: Optional[tuple] = None

    def map(self, uv, p=None):
        return _xform_p(self.texture_from_render, p, uv)


@dataclass(frozen=True)
class MappedTexture:
    """A TextureMapping2D applied before evaluating `base`."""
    base: object
    mapping: object

    def eval_ctx(self, uv, p=None, n=None):
        return eval_texture(self.base, self.mapping.map(uv, p), p=p, n=n)

    def eval(self, uv):
        return self.eval_ctx(uv)


@dataclass(frozen=True)
class DirectionMixTexture:
    """amt = |n . dir|; amt * tex1 + (1 - amt) * tex2 (textures.h:832)."""
    tex1: object
    tex2: object
    dir: tuple = (0.0, 1.0, 0.0)

    def eval_ctx(self, uv, p=None, n=None):
        a = eval_texture(self.tex1, uv, p=p, n=n)
        b = eval_texture(self.tex2, uv, p=p, n=n)
        if n is None:
            amt = _full(uv, 1.0)
        else:
            d = torch.tensor(self.dir, dtype=torch.float32, device=n.device)
            d = d / torch.clamp(torch.linalg.norm(d), min=1e-20)
            amt = torch.abs(n @ d)
        if a.dim() > amt.dim():
            amt = amt[..., None]
        return amt * a + (1.0 - amt) * b

    def eval(self, uv):
        return self.eval_ctx(uv)


def eval_texture(tex, uv, p=None, n=None):
    """Evaluate any texture with the full hit context: eval_ctx(uv, p, n)
    where a texture defines it, else eval(uv) (textures.h:1140)."""
    f = getattr(tex, "eval_ctx", None)
    if f is not None:
        return f(uv, p=p, n=n)
    return tex.eval(uv)


@dataclass(frozen=True)
class BilerpTexture:
    """Bilinear blend of four corner values."""
    v00: float = 0.0
    v01: float = 1.0
    v10: float = 0.0
    v11: float = 1.0

    def eval(self, uv):
        u = torch.clamp(uv[..., 0], 0.0, 1.0)
        v = torch.clamp(uv[..., 1], 0.0, 1.0)
        return ((1 - u) * (1 - v) * self.v00 + (1 - u) * v * self.v01
                + u * (1 - v) * self.v10 + u * v * self.v11)


@dataclass(frozen=True)
class Checkerboard3DTexture:
    """Solid 3D checker over texture-space position (textures.h:386)."""
    tex1: object
    tex2: object
    texture_from_render: Optional[tuple] = None

    def eval_ctx(self, uv, p=None, n=None):
        c = torch.floor(_xform_p(self.texture_from_render, p, uv)).to(
            torch.int32)
        odd = ((c[..., 0] + c[..., 1] + c[..., 2]) % 2) != 0
        return _select(odd, eval_texture(self.tex1, uv, p=p, n=n),
                       eval_texture(self.tex2, uv, p=p, n=n))

    def eval(self, uv):
        return self.eval_ctx(uv)
