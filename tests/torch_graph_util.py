"""The 32^3 test sphere (tests/test_graph.py's) as the port's tracking
inputs and scene, for the card tests and chip_smoke.py.  Imports no JAX."""
import numpy as np
import torch


def _sphere_density():
    c = np.linspace(0, 1, 32)
    zs, ys, xs = np.meshgrid(c, c, c, indexing="ij")
    r = np.linalg.norm(np.stack([xs, ys, zs], -1) - 0.5, axis=-1)
    return (r < 0.45).astype(np.float32)


def sphere_tracking_inputs(n, emission, device, seed=0):
    """Rays towards the sphere (over an 8^3 majorant), with per-ray
    spectra, on `device`: (MediumArrays, o, d, active, rng).  The same
    numbers on every device."""
    from acceleratedvolrenderer_tpu_torch.ops import dda, grid

    rs = np.random.default_rng(seed)
    dens = _sphere_density()
    maj = grid.build_majorant_grid(dens, (8, 8, 8))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    spec = lambda lo, span: t(rs.random((n, 4)) * span + lo)
    med = dda.MediumArrays(
        density=t(dens), majorant=t(maj), w2m=t(np.eye(4)),
        g=t(0.3), sigma_a=spec(0.2, 0.5), sigma_s=spec(0.5, 2.0),
        Le=spec(0.0, 1.0) if emission else t(np.zeros((n, 4))))
    o = rs.random((n, 3)) * 0.4 + np.array([0.3, 0.3, -1.0])
    d = rs.normal(size=(n, 3))
    d[:, 2] = np.abs(d[:, 2]) * 4.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = torch.as_tensor(rs.random(n) < 0.9, device=device)
    ids = torch.arange(n, device=device)
    rng = dda.seed_stream(ids, torch.zeros_like(ids), salt=seed)
    return med, t(o), t(d), active, rng


def graph_test_scene(res, device, spp=2):
    """The sphere scene (8^3 majorant, a distant light from above, box
    filter, max_depth 4) at res x res on `device`."""
    from acceleratedvolrenderer_tpu_torch.models import lights
    from acceleratedvolrenderer_tpu_torch.models.cameras import (
        PerspectiveCamera)
    from acceleratedvolrenderer_tpu_torch.models.film import BoxFilter
    from acceleratedvolrenderer_tpu_torch.models.media import MediumSpec
    from acceleratedvolrenderer_tpu_torch.scene.types import Scene
    from acceleratedvolrenderer_tpu_torch.utils.spectrum import (
        constant_spectrum)
    from acceleratedvolrenderer_tpu_torch.utils.vecmath import look_at

    med = MediumSpec(
        sigma_a_spec=constant_spectrum(0.1),
        sigma_s_spec=constant_spectrum(0.9), g=0.0, scale=3.0,
        density=torch.as_tensor(_sphere_density(), device=device),
        majorant_res=(8, 8, 8))
    cam = PerspectiveCamera(
        c2w=look_at((0.5, 0.5, -2.2), (0.5, 0.5, 0.5), (0, 1, 0), device),
        fov_deg=30.0, width=res, height=res)
    return Scene(camera=cam, medium=med, lights=[lights.DistantLight(
        direction=torch.tensor([0.0, -1.0, 0.0], device=device),
        spectrum=constant_spectrum(3.0), scene_radius=10.0)],
        max_depth=4, filter=BoxFilter(), spp=spp)
