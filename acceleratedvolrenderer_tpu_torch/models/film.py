"""Film filters, sample accumulation and EXR output
(port of acceleratedvolrenderer_tpu/models/film.py: GaussianFilter, BoxFilter,
TriangleFilter, Film and write_film)."""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils import colorspace
from ..utils import image
from ..utils import spectrum as sp


class GaussianFilter(NamedTuple):
    radius: float = 1.5
    sigma: float = 0.5

    def sample_offset(self, u):
        """Inverse-CDF sample of the truncated Gaussian per axis; u (..., 2)
        -> offset (..., 2) in [-radius, radius] with constant weight."""
        r, s = self.radius, self.sigma
        c = math.erf(r / (s * math.sqrt(2.0)))
        x = torch.special.erfinv((2.0 * u - 1.0) * c) * (s * np.sqrt(2.0))
        return torch.clamp(x, -r, r)


class BoxFilter(NamedTuple):
    radius: float = 0.5

    def sample_offset(self, u):
        return (u - 0.5) * (2.0 * self.radius)


class TriangleFilter(NamedTuple):
    radius: float = 2.0

    def sample_offset(self, u):
        """Tent sampling by its inverse CDF."""
        t = 2.0 * u - 1.0
        off = torch.sign(t) * (1.0 - torch.sqrt(
            torch.clamp(1.0 - torch.abs(t), min=0.0)))
        return off * self.radius


class Film(NamedTuple):
    """Accumulation state: (H, W, 3) rgb sum and (H, W) weight sum."""
    rgb_sum: torch.Tensor
    weight_sum: torch.Tensor

    @staticmethod
    def create(height: int, width: int, device):
        f32 = torch.float32
        return Film(torch.zeros((height, width, 3), dtype=f32, device=device),
                    torch.zeros((height, width), dtype=f32, device=device))

    def add_samples(self, pixel_xy, L, swl, weight=None,
                    max_component=math.inf):
        """Accumulate spectral radiance samples (RGBFilm::AddSample): sensor
        RGB clamped to `max_component`, then a weighted scatter-add over
        flat pixel indices.  pixel_xy (N, 2) integer, -1 or out of frame =
        dropped.  Out of place, so autograd can run through it."""
        rgb = colorspace.xyz_to_rgb(sp.to_xyz(L, swl))
        m = torch.amax(rgb, dim=-1)
        scale = torch.where(m > max_component,
                            max_component / torch.clamp(m, min=1e-24), 1.0)
        rgb = torch.nan_to_num(rgb * scale[..., None], nan=0.0, posinf=0.0,
                               neginf=0.0)
        w = (torch.ones(rgb.shape[0], dtype=rgb.dtype, device=rgb.device)
             if weight is None else weight)
        x, y = pixel_xy[:, 0].long(), pixel_xy[:, 1].long()
        H, W = self.weight_sum.shape
        ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        wm = torch.where(ok, w, 0.0)
        flat = torch.where(ok, y * W + x, 0)
        rgb_sum = self.rgb_sum.reshape(-1, 3).index_add(
            0, flat, rgb * wm[:, None]).reshape(H, W, 3)
        weight_sum = self.weight_sum.reshape(-1).index_add(
            0, flat, wm).reshape(H, W)
        return Film(rgb_sum, weight_sum)

    def to_image(self):
        return self.rgb_sum / torch.clamp(self.weight_sum, min=1e-12)[..., None]


def write_film(path, film_img, render_time=None, spp=None, mse=None, w2c=None):
    """Write an (H, W, 3) image (tensor or array) as EXR with pbrt
    metadata."""
    if isinstance(film_img, torch.Tensor):
        film_img = film_img.detach().cpu().numpy()
    md = image.ImageMetadata(
        render_time_seconds=render_time, samples_per_pixel=spp, mse=mse,
        world_to_camera=w2c,
    )
    image.write_exr(path, np.asarray(film_img), md)
