"""Scene description (port of acceleratedvolrenderer_tpu/scene/types.py)."""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional

from ..models.film import GaussianFilter
from ..models.media import MediumSpec


@dataclass
class Scene:
    # PerspectiveCamera / OrthographicCamera / SphericalCamera /
    # RealisticCamera (models/cameras.py)
    camera: object
    medium: Optional[MediumSpec] = None
    lights: List = field(default_factory=list)
    max_depth: int = 5
    filter: object = field(default_factory=GaussianFilter)
    scene_radius: float = 1e4
    spp: int = 16
    seed: int = 0
    sampler: str = "independent"   # independent | stratified | sobol |
    #   paddedsobol | zsobol | pmj02bn | halton (models/samplers.py)
    max_march_steps: int = 100000
    light_sampler: str = "uniform"   # uniform | power | bvh
    primitives: List = field(default_factory=list)   # models/shapes.py
    # volpath (default; the fused integrator) | simplevolpath | path |
    # simplepath | randomwalk | ao (models/integrators/path.py, scenes
    # without a medium) | graph | lightpath | bdpt | sppm | mlt (cli/pbrt.py
    # runs the last four through their own entries)
    integrator: str = "volpath"
    regularize: bool = False         # widen near-specular lobes (path)
    # wave renderer knobs (--disable-pixel-jitter, --disable-wavelength-
    # jitter, --pixelbounds (x0, x1, y0, y1))
    disable_pixel_jitter: bool = False
    disable_wavelength_jitter: bool = False
    pixel_bounds: Optional[tuple] = None

    @property
    def width(self):
        return self.camera.width

    @property
    def height(self):
        return self.camera.height

    def to(self, device):
        """The same scene with every tensor on `device`."""
        med = self.medium
        if med is not None:
            move = lambda t: None if t is None else t.to(device)
            med = replace(med, **{k: move(getattr(med, k)) for k in (
                "density", "majorant", "sigma_a_rgb", "sigma_s_rgb",
                "Le_rgb")})
        return replace(self, camera=self.camera.to(device), medium=med,
                       lights=[lt.to(device) for lt in self.lights])
