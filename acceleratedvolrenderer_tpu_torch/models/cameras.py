"""Perspective camera, batched primary rays
(port of acceleratedvolrenderer_tpu/models/cameras.py::PerspectiveCamera)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.vecmath import Transform, normalize


class PerspectiveCamera(NamedTuple):
    c2w: Transform          # camera-to-world, tensors on the render device
    fov_deg: float          # field of view of the shorter image axis
    width: int
    height: int

    def to(self, device):
        return self._replace(c2w=self.c2w.to(device))

    def generate_rays(self, pxy, u_film):
        """pxy: (N, 2) integer pixel coords; u_film: (N, 2) offsets.
        Returns world-space (o, d) with unit d."""
        w, h = self.width, self.height
        tan_half = float(np.tan(np.deg2rad(self.fov_deg) / 2.0))
        aspect = w / h
        if aspect > 1.0:
            sx, sy = tan_half * aspect, tan_half
        else:
            sx, sy = tan_half, tan_half / aspect
        px = (pxy[..., 0] + u_film[..., 0]) / w
        py = (pxy[..., 1] + u_film[..., 1]) / h
        x_cam = (2.0 * px - 1.0) * sx
        y_cam = (1.0 - 2.0 * py) * sy
        d_cam = torch.stack([x_cam, y_cam, torch.ones_like(x_cam)], dim=-1)
        o_w = self.c2w.apply_point(torch.zeros_like(d_cam))
        d_w = normalize(self.c2w.apply_vector(d_cam))
        return o_w, d_w
