"""Build a port Scene from plain arrays and floats.

This is how state crosses from another implementation (the JAX package's
scene, a file, a test) into the port: every field is a numpy array or a
python number, so the two renderers see identical inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import lights as lm
from ..models import materials, shapes, textures
from ..models.cameras import PerspectiveCamera
from ..models.film import BoxFilter, GaussianFilter, TriangleFilter
from ..models.media import MediumSpec
from ..utils.device import resolve
from ..utils.spectrum import blackbody_normalized, constant_spectrum
from ..utils.vecmath import Transform
from .types import Scene

MEDIUM_KEYS = ("density", "majorant", "w2m", "sigma_a", "sigma_s", "scale",
               "g")
KEYS = MEDIUM_KEYS + ("c2w", "fov_deg", "width", "height", "sun_dir",
                      "sun_L", "sky_L", "spp", "max_depth", "seed",
                      "max_march_steps", "scene_radius")
# the classes a plain record may name, by class name
_KINDS = {name: getattr(mod, name)
          for mod in (shapes, materials, textures, lm)
          for name in dir(mod) if isinstance(getattr(mod, name), type)}
# the fields whose plain value is a spectrum (see spectrum_from)
_SPECTRA = ("emission", "spectrum")

FILTERS = {"gaussian": GaussianFilter, "box": BoxFilter,
           "triangle": TriangleFilter}


def spectrum_from(spec):
    """A spectrum from its plain form: a number (a constant spectrum) or
    ("blackbody", T), the blackbody at T kelvin normalized at its peak."""
    if isinstance(spec, (tuple, list)):
        name, *args = spec
        if name != "blackbody":
            raise ValueError(f"scene_from_arrays: unknown spectrum {name!r}")
        return blackbody_normalized(float(args[0]))
    return constant_spectrum(spec)


def object_from(plain, device):
    """A primitive, material, texture or light from its plain form: a dict
    whose "kind" names the class (Sphere, Quad, ..., DiffuseMaterial, ...,
    CheckerboardTexture, ..., PointLight, DiffuseAreaLight, ...) and whose
    other keys are its constructor's arguments, as numpy arrays, numbers,
    tuples or nested plain forms; an `emission` or `spectrum` is a
    spectrum's plain form (spectrum_from), and a DistantLight's direction
    goes to `device` as float32."""
    if not (isinstance(plain, dict) and "kind" in plain):
        return plain
    if plain["kind"] not in _KINDS:
        raise ValueError(f"scene_from_arrays: unknown kind {plain['kind']!r}")
    kw = {k: (None if v is None else spectrum_from(v)) if k in _SPECTRA
          else object_from(v, device)
          for k, v in plain.items() if k != "kind"}
    if plain["kind"] == "DistantLight":
        kw["direction"] = torch.as_tensor(
            np.asarray(kw["direction"], np.float32), device=device)
    return _KINDS[plain["kind"]](**kw)


def scene_from_arrays(arrays: dict, device=None) -> Scene:
    """arrays: density (nz, ny, nx), or None for a homogeneous medium or an
    RGB one; majorant (rz, ry, rx); w2m (4, 4) world -> unit-cube medium,
    c2w (4, 4) camera -> world, fov_deg, width, height, sun_dir (3,)
    propagation direction, sun_L / sky_L constant radiances (None: no such
    light; both None: no light), sigma_a / sigma_s / scale / g medium
    constants, spp, max_depth, seed, max_march_steps and scene_radius.
    Optional: sigma_a_rgb / sigma_s_rgb / Le_rgb (nz, ny, nx, 3) grids of an
    RGB medium; Le medium emission (a number or ("blackbody", T), see
    spectrum_from) and Le_scale; filter (name, *args) with a name of FILTERS
    (default Gaussian); and the wave renderer's disable_pixel_jitter,
    disable_wavelength_jitter and pixel_bounds.  Tensors go to `device`
    (the CUDA card by default).

    A scene without a medium gives majorant None (the other medium keys may
    then be left out).  Optional surfaces and lights: `primitives`, a list of
    plain primitives (object_from; each with its material's plain form or
    None), and `lights`, plain lights added after the sun and sky (the
    image, portal, projection and goniometric lights among them, with their
    numpy images; a projector's or goniometric light's `image` the plain
    form of an ImageTexture); and the scene's `integrator`, `sampler`,
    `light_sampler` and `regularize`."""
    a = arrays
    needed = (KEYS if a.get("majorant") is not None
              else KEYS[len(MEDIUM_KEYS):])
    missing = [k for k in needed if k not in a]
    if missing:
        raise KeyError(f"scene_from_arrays: missing {missing}")
    device = resolve(device)
    grid = lambda k: (None if a.get(k) is None else torch.as_tensor(
        np.asarray(a[k], np.float32), device=device))
    med = None
    if a.get("majorant") is not None:
        majorant = np.asarray(a["majorant"], np.float32)
        le = a.get("Le")
        med = MediumSpec(
            sigma_a_spec=constant_spectrum(a["sigma_a"]),
            sigma_s_spec=constant_spectrum(a["sigma_s"]),
            g=float(a["g"]), scale=float(a["scale"]),
            density=grid("density"),
            Le_spec=None if le is None else spectrum_from(le),
            Le_scale=float(a.get("Le_scale", 1.0)),
            m2w=np.linalg.inv(np.asarray(a["w2m"], np.float64)),
            majorant_res=tuple(int(r) for r in majorant.shape[::-1]),
            majorant=torch.as_tensor(majorant, device=device),
            sigma_a_rgb=grid("sigma_a_rgb"), sigma_s_rgb=grid("sigma_s_rgb"),
            Le_rgb=grid("Le_rgb"),
        )
    c2w = np.asarray(a["c2w"], np.float64)
    cam = PerspectiveCamera(
        c2w=Transform.from_numpy(c2w, np.linalg.inv(c2w), device),
        fov_deg=float(a["fov_deg"]), width=int(a["width"]),
        height=int(a["height"]))
    radius = float(a["scene_radius"])
    lights = []
    if a["sun_L"] is not None:
        lights.append(lm.DistantLight(
            direction=torch.as_tensor(np.asarray(a["sun_dir"]),
                                      dtype=torch.float32, device=device),
            spectrum=constant_spectrum(a["sun_L"]), scene_radius=radius))
    if a["sky_L"] is not None:
        lights.append(lm.UniformInfiniteLight(
            spectrum=constant_spectrum(a["sky_L"]), scene_radius=radius))
    lights += [object_from(lt, device) for lt in a.get("lights", ())]
    name, *fargs = a.get("filter", ("gaussian",))
    return Scene(
        camera=cam, medium=med, lights=lights,
        primitives=[object_from(p, device) for p in a.get("primitives", ())],
        integrator=a.get("integrator", "volpath"),
        sampler=a.get("sampler", "independent"),
        light_sampler=a.get("light_sampler", "uniform"),
        regularize=bool(a.get("regularize", False)),
        max_depth=int(a["max_depth"]), spp=int(a["spp"]),
        seed=int(a["seed"]), max_march_steps=int(a["max_march_steps"]),
        scene_radius=radius, filter=FILTERS[name](*fargs),
        disable_pixel_jitter=bool(a.get("disable_pixel_jitter", False)),
        disable_wavelength_jitter=bool(a.get("disable_wavelength_jitter",
                                             False)),
        pixel_bounds=a.get("pixel_bounds"),
    )
