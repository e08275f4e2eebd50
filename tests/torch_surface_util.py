"""Plain forms of a JAX scene's surfaces and lights, for the port's
scene_from_arrays (tests/test_torch_surfaces.py, test_torch_path.py and
test_torch_bxdfs.py), and the small surface scenes those tests render."""
import dataclasses

import jax.numpy as jnp
import numpy as np

from acceleratedvolrenderer_tpu.models import lights as jl
from acceleratedvolrenderer_tpu.models import textures as jtex

from torch_port_util import _emission, arrays_from_jax_scene

# the fields of a JAX object that hold a callable spectrum
_SPECTRA = ("emission", "spectrum")


def _spectrum_value(v):
    """A spectrum-like value's plain form: a callable constant spectrum as
    its value (evaluated at 550 nm), a normalized blackbody as
    ("blackbody", T); numbers pass through."""
    if callable(v) and not hasattr(v, "eval"):
        return _emission(v)
    return v


def plain(obj):
    """The plain form (convert.object_from) of a JAX primitive, material,
    texture or light: {"kind": class name, field: value, ...}."""
    if obj is None or isinstance(obj, (int, float, str, bool, tuple)):
        return obj
    if isinstance(obj, (np.ndarray, jnp.ndarray)):
        return np.asarray(obj)
    if isinstance(obj, jtex.ImageTexture):
        return dict(kind="ImageTexture", image=np.asarray(obj.image),
                    scale=obj.scale, invert=obj.invert)
    if isinstance(obj, jl.ImageInfiniteLight):
        return dict(kind="ImageInfiniteLight", image=np.asarray(obj.image),
                    scale=obj.scale, scene_radius=obj.scene_radius)
    if isinstance(obj, jl.PortalImageInfiniteLight):
        # the JAX light keeps only its rectified image: portal_light()
        # records the arguments it was built from
        return dict(obj.port_plain)
    if callable(obj) and not dataclasses.is_dataclass(obj):
        return _spectrum_value(obj)
    out = {"kind": type(obj).__name__}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name in _SPECTRA:
            out[f.name] = None if v is None else _emission(v)
        else:
            out[f.name] = plain(_spectrum_value(v))
    return out


def portal_light(image, portal, **kw):
    """A JAX PortalImageInfiniteLight that knows its plain form."""
    lt = jl.PortalImageInfiniteLight(image, portal, **kw)
    lt.port_plain = dict(kind="PortalImageInfiniteLight",
                         image=np.asarray(image, np.float32),
                         portal=np.asarray(portal, np.float32), **kw)
    return lt


def _plain_light(lt):
    rec = plain(lt)
    if isinstance(lt, jl.DistantLight):
        rec["direction"] = np.asarray(lt.direction, np.float32)
    return rec


def surface_arrays_from_jax_scene(js):
    """What scene_from_arrays takes for a JAX scene with surfaces: the
    medium (if any) as arrays_from_jax_scene reads it, every light in
    order under `lights`, the primitives, and the integrator settings."""
    if js.medium is not None:
        arrays = arrays_from_jax_scene(dataclasses.replace(js, lights=[]))
    else:
        filt = js.filter
        arrays = dict(
            majorant=None, c2w=np.asarray(js.camera.c2w.m, np.float64),
            fov_deg=js.camera.fov_deg, width=js.width, height=js.height,
            spp=js.spp, max_depth=js.max_depth, seed=js.seed,
            max_march_steps=js.max_march_steps,
            scene_radius=js.scene_radius,
            filter=(type(filt).__name__.replace("Filter", "").lower(),
                    *filt),
            disable_pixel_jitter=js.disable_pixel_jitter,
            disable_wavelength_jitter=js.disable_wavelength_jitter,
            pixel_bounds=js.pixel_bounds)
    arrays.update(
        sun_dir=np.zeros(3, np.float32), sun_L=None, sky_L=None,
        sampler=js.sampler,
        lights=[_plain_light(lt) for lt in js.lights],
        primitives=[plain(p) for p in js.primitives],
        integrator=js.integrator, light_sampler=js.light_sampler,
        regularize=js.regularize)
    return arrays
