"""Color space conversion (port of acceleratedvolrenderer_tpu/utils/colorspace.py)."""
from __future__ import annotations

import numpy as np
import torch

# sRGB primaries, D65 white (IEC 61966-2-1)
XYZ_TO_SRGB = np.array(
    [
        [3.2406, -1.5372, -0.4986],
        [-0.9689, 1.8758, 0.0415],
        [0.0557, -0.2040, 1.0570],
    ],
    np.float32,
)
SRGB_TO_XYZ = np.linalg.inv(XYZ_TO_SRGB.astype(np.float64)).astype(np.float32)
_M = XYZ_TO_SRGB.tolist()   # float32 values, exact as python floats


def xyz_to_rgb(xyz):
    """(..., 3) XYZ -> linear sRGB as explicit multiply-adds (fixed order)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return torch.stack([x * r[0] + y * r[1] + z * r[2] for r in _M], dim=-1)


def _mat3(v, m):
    """(..., 3) times (3, 3)^T as broadcast multiply-adds in a fixed order;
    m a numpy matrix or a tensor."""
    m = torch.as_tensor(m, device=v.device)
    return (v[..., 0:1] * m[:, 0] + v[..., 1:2] * m[:, 1]
            + v[..., 2:3] * m[:, 2])


def rgb_to_xyz(rgb):
    return _mat3(rgb, SRGB_TO_XYZ)


def linear_to_srgb(x):
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(x, 1.0 / 2.4) - 0.055)


def srgb_to_linear(x):
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow((x + 0.055) / 1.055, 2.4))
