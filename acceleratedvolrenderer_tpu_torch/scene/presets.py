"""Preset scenes (port of acceleratedvolrenderer_tpu/scene/presets.py::cloud,
the disney-cloud-720p analog)."""
from __future__ import annotations

import numpy as np
import torch

from ..models import lights as lm
from ..models.cameras import PerspectiveCamera
from ..models.film import GaussianFilter
from ..models.media import MediumSpec, bake_cloud_density
from ..ops import grid as gridops
from ..utils import spectrum as sp
from ..utils.device import resolve
from ..utils.vecmath import Transform
from .types import Scene


def flat(c):
    return sp.constant_spectrum(c)


# camera of the disney-cloud-720p EXR (worldToCamera metadata)
CLOUD_W2C = np.array([
    [-3.1525575e-02, -4.0441036e-04, -9.9950278e-01, -4.3427013e+01],
    [2.7316687e-01, 9.6192437e-01, -9.0052327e-03, -9.8271866e+01],
    [-9.6144992e-01, 2.7331498e-01, 3.0214753e-02, 6.4755157e+02],
    [0.0, 0.0, 0.0, 1.0],
])
CLOUD_SUN_DIR = np.array([-0.5826, -0.7660, -0.2717])


def cloud(width=1280, height=720, spp=16, max_depth=40, grid_res=256,
          g=0.877, sigma_scale=2.0, *, device=None):
    """Disney-cloud-720p analog: baked procedural grid_res^3 density with a
    16^3 majorant, strong forward scattering, sun plus sky.  Every tensor
    of the scene is created on `device` (the CUDA card by default)."""
    device = resolve(device)
    density = bake_cloud_density(res=(grid_res, grid_res, grid_res),
                                 density=1.0, extent=0.48, frequency=6.0)
    half = 100.0
    maj_res = (16, 16, 16)
    med = MediumSpec(
        sigma_a_spec=flat(0.0), sigma_s_spec=flat(1.0), g=g,
        scale=sigma_scale / (2 * half) * 20.0,
        density=torch.as_tensor(density, device=device),
        bounds_lo=np.array([-half, -half, -half], np.float32),
        bounds_hi=np.array([half, half, half], np.float32),
        majorant_res=maj_res,
        majorant=torch.as_tensor(gridops.build_majorant_grid(density, maj_res),
                                 device=device),
    )
    c2w = Transform.from_numpy(np.linalg.inv(CLOUD_W2C), CLOUD_W2C, device)
    cam = PerspectiveCamera(c2w=c2w, fov_deg=31.07, width=width, height=height)
    sun_dir = CLOUD_SUN_DIR / np.linalg.norm(CLOUD_SUN_DIR)
    return Scene(
        camera=cam, medium=med,
        lights=[
            lm.DistantLight(
                direction=torch.as_tensor(sun_dir, dtype=torch.float32,
                                          device=device),
                spectrum=flat(2.6), scene_radius=1500.0),
            lm.UniformInfiniteLight(spectrum=flat(0.03), scene_radius=1500.0),
        ],
        max_depth=max_depth, spp=spp, scene_radius=1500.0,
        filter=GaussianFilter(),
    )
