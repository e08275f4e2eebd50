"""MIP map: an image pyramid with trilinear and EWA filtered lookups
(port of acceleratedvolrenderer_tpu/models/mipmap.py; pbrt util/mipmap.h).

The pyramid is built in numpy when the texture is made, as in the
reference: the base image resampled to a power of two by a bilinear
filter, then 2x2 box levels down to 1x1, all levels in one flat
(sum_l H_l * W_l, C) table.  Lookups are batched tensor gathers on the
device of the uv they are given.  The EWA lookup is the reference's fixed
probe count: the ellipse's minor axis picks the level, `n_probes`
Gaussian-weighted trilinear taps lie along the major axis.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import per_device


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class MIPMap:
    """Box-filter pyramid over a wrap-repeat image."""

    def __init__(self, image: np.ndarray, max_anisotropy: float = 8.0,
                 n_probes: int = 6):
        img = np.asarray(image, np.float32)
        if img.ndim == 2:
            img = img[..., None]
        H, W, C = img.shape
        # resample to a power of two by bilinear interpolation (keeps the
        # mean; the reference's separable filter stands behind it)
        H2, W2 = _next_pow2(H), _next_pow2(W)
        if (H2, W2) != (H, W):
            ys = (np.arange(H2) + 0.5) * H / H2 - 0.5
            xs = (np.arange(W2) + 0.5) * W / W2 - 0.5
            y0 = np.floor(ys).astype(int)
            x0 = np.floor(xs).astype(int)
            fy = (ys - y0)[:, None, None]
            fx = (xs - x0)[None, :, None]
            y0w, y1w = y0 % H, (y0 + 1) % H
            x0w, x1w = x0 % W, (x0 + 1) % W
            img = ((1 - fy) * ((1 - fx) * img[np.ix_(y0w, x0w)]
                               + fx * img[np.ix_(y0w, x1w)])
                   + fy * ((1 - fx) * img[np.ix_(y1w, x0w)]
                           + fx * img[np.ix_(y1w, x1w)]))
        levels = [img]
        while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
            prev = levels[-1]
            h, w = prev.shape[:2]
            nh, nw = max(h // 2, 1), max(w // 2, 1)
            # 2x2 box (Image::GeneratePyramid)
            p = prev[: nh * 2 if h > 1 else 1, : nw * 2 if w > 1 else 1]
            if h > 1 and w > 1:
                p = p.reshape(nh, 2, nw, 2, C).mean(axis=(1, 3))
            elif h > 1:
                p = p.reshape(nh, 2, 1, C).mean(axis=1)
            else:
                p = p.reshape(1, nw, 2, C).mean(axis=2)
            levels.append(p.astype(np.float32))
        self.n_levels = len(levels)
        self.shapes = [(lv.shape[0], lv.shape[1]) for lv in levels]
        self.offsets = np.cumsum([0] + [h * w for h, w in self.shapes])[:-1]
        self.flat = np.concatenate([lv.reshape(-1, C) for lv in levels],
                                   axis=0).astype(np.float32)
        self.channels = C
        self.max_anisotropy = float(max_anisotropy)
        self.n_probes = int(n_probes)

    def _tables(self, device):
        """(flat, offsets, hs, ws) on `device`, made once per device."""
        def make(dev):
            t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                              device=dev)
            return (t(self.flat, torch.float32),
                    t(self.offsets, torch.int64),
                    t([h for h, _ in self.shapes], torch.int64),
                    t([w for _, w in self.shapes], torch.int64))

        return per_device(self, device, make)

    def _bilerp_level(self, uv, level):
        """uv (N, 2) in [0, 1) wrapped; level (N,) int -> (N, C)."""
        flat, offsets, hs, ws = self._tables(uv.device)
        hi, wi = hs[level], ws[level]
        h, w = hi.to(torch.float32), wi.to(torch.float32)
        off = offsets[level]
        x = (uv[..., 0] % 1.0) * w - 0.5
        y = (uv[..., 1] % 1.0) * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
        x0w, x1w = x0i % wi, (x0i + 1) % wi
        y0w, y1w = y0i % hi, (y0i + 1) % hi
        g = lambda yy, xx: flat[off + yy * wi + xx]
        return ((1 - fy) * ((1 - fx) * g(y0w, x0w) + fx * g(y0w, x1w))
                + fy * ((1 - fx) * g(y1w, x0w) + fx * g(y1w, x1w)))

    def lookup_trilinear(self, uv, width):
        """Isotropic filtered lookup (MIPMap::Filter): `width` is the
        filter footprint in uv units; blends the two bracketing levels."""
        width = torch.clamp(torch.as_tensor(width, dtype=torch.float32,
                                            device=uv.device), min=1e-8)
        lod = torch.clamp(self.n_levels - 1 + torch.log2(width), 0.0,
                          self.n_levels - 1)
        l0 = torch.floor(lod).to(torch.int64)
        l1 = torch.clamp(l0 + 1, max=self.n_levels - 1)
        t = (lod - l0.to(torch.float32))[..., None]
        return ((1 - t) * self._bilerp_level(uv, l0)
                + t * self._bilerp_level(uv, l1))

    def lookup_ewa(self, uv, duv0, duv1):
        """Anisotropic lookup (MIPMap::EWA): duv0 / duv1 (N, 2) are the
        footprint's axes in uv; the minor axis picks the level, n_probes
        Gaussian taps lie along the major one."""
        len0 = torch.sqrt((duv0 * duv0).sum(-1))
        len1 = torch.sqrt((duv1 * duv1).sum(-1))
        swap = len1 > len0
        major = torch.where(swap[..., None], duv1, duv0)
        maj_len = torch.where(swap, len1, len0)
        min_len = torch.where(swap, len0, len1)
        # clamp the eccentricity (mipmap.cpp maxAnisotropy): widen the
        # minor axis rather than blur the major one
        min_len = torch.maximum(min_len, maj_len / self.max_anisotropy)
        lod_width = torch.clamp(min_len, min=1e-8)
        n = self.n_probes
        ts = (2.0 * (np.arange(n) + 0.5) / n - 1.0).astype(np.float32)
        wts = np.exp(-2.0 * ts ** 2).astype(np.float32)
        wts /= wts.sum()
        out = 0.0
        for t, wt in zip(ts, wts):
            p = uv + major * float(t)
            out = out + float(wt) * self.lookup_trilinear(p, lod_width)
        return out


__all__ = ["MIPMap"]
