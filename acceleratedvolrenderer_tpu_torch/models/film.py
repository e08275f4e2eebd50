"""Film filter and EXR output (port of acceleratedvolrenderer_tpu/models/film.py:
GaussianFilter.sample_offset and write_film)."""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


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


def write_film(path, film_img, render_time=None, spp=None, mse=None, w2c=None):
    """Write an (H, W, 3) image (tensor or array) as EXR with pbrt metadata,
    through the reference package's JAX-free image module."""
    from acceleratedvolrenderer_tpu.utils import image

    if isinstance(film_img, torch.Tensor):
        film_img = film_img.detach().cpu().numpy()
    md = image.ImageMetadata(
        render_time_seconds=render_time, samples_per_pixel=spp, mse=mse,
        world_to_camera=w2c,
    )
    image.write_exr(path, np.asarray(film_img), md)
