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
    if hasattr(obj, "port_brdf"):
        # a JAX MeasuredBRDF made by measured_pair: the port's BRDF of the
        # same file (object_from passes it through)
        return obj.port_brdf
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


def measured_pair(path, alpha=0.3, res=16, n_theta=4):
    """(JAX MeasuredBRDF, port MeasuredBRDF) read from one .bsdf file that
    the port's synthesize_ggx writes at `path`; the JAX one knows its port
    twin, so plain() of a JAX MeasuredMaterial carries the port's BRDF."""
    from acceleratedvolrenderer_tpu.models import measured as jms
    from acceleratedvolrenderer_tpu_torch.models import measured as tms

    tms.write_tensor_file(str(path), tms.tensors_of(
        tms.synthesize_ggx(alpha=alpha, res=res, n_theta=n_theta)))
    jb = jms.MeasuredBRDF.from_file(str(path))
    object.__setattr__(jb, "port_brdf", tms.MeasuredBRDF.from_file(str(path)))
    return jb, jb.port_brdf


def li_path_frames(prims, lights, width, height, spp, max_depth, fov=40.0,
                   **kw):
    """li_path of the JAX package (outside jit, under jax.disable_jit) and
    of the port (CPU) on the same camera rays, wavelengths and PCG streams:
    a pinhole at the origin looking down +z (y up) over width x height
    pixels, spp numpy-jittered rays per pixel.  Returns (port frame, JAX
    frame), each (height, width, 4): the spectral radiance's mean over
    the pixel's rays."""
    import jax
    import torch

    from acceleratedvolrenderer_tpu.models.integrators import path as jpath
    from acceleratedvolrenderer_tpu.ops import dda as jdda
    from acceleratedvolrenderer_tpu_torch.models.integrators import (
        path as tpath)
    from acceleratedvolrenderer_tpu_torch.ops import dda as tdda
    from acceleratedvolrenderer_tpu_torch.scene import convert

    rng = np.random.default_rng(7)
    n = width * height * spp
    yy, xx, _ = np.meshgrid(np.arange(height), np.arange(width),
                            np.arange(spp), indexing="ij")
    jit = rng.random((n, 2))
    tan = np.tan(np.deg2rad(fov) / 2)
    px = ((xx.reshape(-1) + jit[:, 0]) / width * 2 - 1) * tan
    py = (1 - (yy.reshape(-1) + jit[:, 1]) / height * 2) * tan * height / width
    d = np.stack([px, py, np.ones(n)], -1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.zeros((n, 3), np.float32)
    lam = rng.uniform(380, 720, (n, 4)).astype(np.float32)
    idx = np.arange(n)
    with jax.disable_jit():
        jL, _ = jpath.li_path(
            tuple(prims), lights, jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(lam),
            jdda.seed_stream(jnp.asarray(idx), jnp.zeros(n, jnp.int32)),
            max_depth=max_depth, **kw)
    tL, _ = tpath.li_path(
        tuple(convert.object_from(plain(p), "cpu") for p in prims),
        [convert.object_from(_plain_light(lt), "cpu") for lt in lights],
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(lam),
        tdda.seed_stream(torch.as_tensor(idx),
                         torch.zeros(n, dtype=torch.int64)),
        max_depth=max_depth, **kw)
    frame = lambda L: np.asarray(L).reshape(height, width, spp, 4).mean(2)
    return frame(tL.numpy()), frame(jL)
