"""Preset scenes (port of acceleratedvolrenderer_tpu/scene/presets.py:
fog_box, cloud, the disney-cloud-720p analog, emissive_volume, sphere_medium
and explosion).  Every tensor of a scene is created on `device` (the CUDA card
by default)."""
from __future__ import annotations

import numpy as np
import torch

from ..models import lights as lm
from ..models.cameras import PerspectiveCamera
from ..models.film import GaussianFilter
from ..models.media import MediumSpec, bake_cloud_density, homogeneous_box
from ..ops import grid as gridops
from ..utils import spectrum as sp
from ..utils.device import resolve
from ..utils.vecmath import Transform, look_at
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


def _direction(v, device):
    v = np.asarray(v, np.float64)
    return torch.as_tensor(v / np.linalg.norm(v), dtype=torch.float32,
                           device=device)


def fog_box(res=256, spp=64, max_depth=5, *, device=None):
    """Homogeneous fog box (BASELINE config 1): single and multiple
    scattering under a distant light and a dim sky."""
    device = resolve(device)
    med = homogeneous_box(flat(0.5), flat(2.0), lo=(0, 0, 0), hi=(1, 1, 1),
                          g=0.0)
    cam = PerspectiveCamera(
        c2w=look_at((0.5, 0.5, -2.6), (0.5, 0.5, 0.5), (0, 1, 0), device),
        fov_deg=35.0, width=res, height=res)
    return Scene(
        camera=cam, medium=med,
        lights=[
            lm.DistantLight(direction=_direction([0.3, -1.0, 0.4], device),
                            spectrum=flat(3.0), scene_radius=10.0),
            lm.UniformInfiniteLight(spectrum=flat(0.1), scene_radius=10.0),
        ],
        max_depth=max_depth, spp=spp, scene_radius=10.0)


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


def emissive_volume(res=256, spp=64, *, device=None):
    """Emissive volume (BASELINE config 3): a normalized 3000 K blackbody
    emitted by an absorbing, scattering plume over a 96^3 baked density."""
    device = resolve(device)
    density = bake_cloud_density(res=(96, 96, 96), density=2.0, extent=0.45,
                                 frequency=4.0, seed=3)
    med = MediumSpec(
        sigma_a_spec=flat(4.0), sigma_s_spec=flat(1.0), g=0.0, scale=1.0,
        density=torch.as_tensor(density, device=device),
        bounds_lo=np.zeros(3, np.float32), bounds_hi=np.ones(3, np.float32),
        Le_spec=sp.blackbody_normalized(3000.0), Le_scale=2.0,
        majorant_res=(16, 16, 16))
    cam = PerspectiveCamera(
        c2w=look_at((0.5, 0.6, -2.2), (0.5, 0.45, 0.5), (0, 1, 0), device),
        fov_deg=32.0, width=res, height=res)
    return Scene(
        camera=cam, medium=med,
        lights=[lm.UniformInfiniteLight(spectrum=flat(0.02),
                                        scene_radius=10.0)],
        max_depth=8, spp=spp, scene_radius=10.0)


def sphere_medium(res=640, height=480, spp=16, max_depth=8, *, device=None):
    """The graph precompute's evaluation scene: a hard sphere of density 1
    over a 96^3 grid with a 16^3 majorant, lit by a distant light from
    above."""
    device = resolve(device)
    n = 96
    zs, ys, xs = np.meshgrid(*([np.linspace(0, 1, n)] * 3), indexing="ij")
    r = np.linalg.norm(np.stack([xs, ys, zs], -1) - 0.5, axis=-1)
    density = np.clip(1.0 - r / 0.48, 0.0, 1.0).astype(np.float32)
    density = (density > 0).astype(np.float32)
    med = MediumSpec(
        sigma_a_spec=flat(0.05), sigma_s_spec=flat(0.95), g=0.0, scale=3.0,
        density=torch.as_tensor(density, device=device),
        bounds_lo=np.zeros(3, np.float32), bounds_hi=np.ones(3, np.float32),
        majorant_res=(16, 16, 16))
    cam = PerspectiveCamera(
        c2w=look_at((0.5, 0.5, -2.5), (0.5, 0.5, 0.5), (0, 1, 0), device),
        fov_deg=30.0, width=res, height=height)
    return Scene(
        camera=cam, medium=med,
        lights=[lm.DistantLight(direction=_direction([0.0, -1.0, 0.0], device),
                                spectrum=flat(3.0), scene_radius=10.0)],
        max_depth=max_depth, spp=spp, scene_radius=10.0)


def explosion(res=256, spp=32, *, device=None):
    """Explosion (BASELINE config 3, full form): an RGB grid medium with
    per-voxel RGB sigma_a / sigma_s and RGB emission over an 80^3 grid, a
    hot core inside an orange shell."""
    device = resolve(device)
    n = 80
    dens = bake_cloud_density(res=(n, n, n), density=1.0, extent=0.42,
                              frequency=4.5, seed=7)
    zs, ys, xs = np.meshgrid(*([np.linspace(0, 1, n)] * 3), indexing="ij")
    r = np.linalg.norm(np.stack([xs, ys, zs], -1) - 0.5, axis=-1) / 0.42
    heat = np.clip(1.0 - r, 0.0, 1.0) ** 1.5 * dens
    grid = lambda chans: torch.as_tensor(
        np.stack(chans, -1).astype(np.float32), device=device)
    med = MediumSpec(
        sigma_a_spec=flat(1.0), sigma_s_spec=flat(1.0), g=0.0, scale=1.0,
        bounds_lo=np.zeros(3, np.float32), bounds_hi=np.ones(3, np.float32),
        sigma_a_rgb=grid([dens * 3.0, dens * 3.6, dens * 4.2]),
        sigma_s_rgb=grid([dens * 0.8, dens * 0.7, dens * 0.6]),
        Le_rgb=grid([heat * 8.0, heat * 3.0, heat * 0.8]),
        majorant_res=(16, 16, 16))
    cam = PerspectiveCamera(
        c2w=look_at((0.5, 0.55, -2.3), (0.5, 0.48, 0.5), (0, 1, 0), device),
        fov_deg=32.0, width=res, height=res)
    return Scene(
        camera=cam, medium=med,
        lights=[lm.UniformInfiniteLight(spectrum=flat(0.01),
                                        scene_radius=10.0)],
        max_depth=6, spp=spp, scene_radius=10.0)
