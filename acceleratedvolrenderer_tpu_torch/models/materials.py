"""Materials: the surface scattering models a primitive carries
(port of acceleratedvolrenderer_tpu/models/materials.py).

material = None on a primitive is a transparent medium interface.  There is
no per-ray dispatch: the integrators stack every primitive's parameters and
select per lane by the material's `kind`.  A reflectance-like parameter is
a number, a callable of the wavelengths, or a texture of models/textures.py
evaluated at the hit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

KIND_DIFFUSE = 0
KIND_CONDUCTOR = 1
KIND_DIELECTRIC = 2
KIND_THIN_DIELECTRIC = 3
KIND_DIFFUSE_TRANSMISSION = 4
KIND_COATED_DIFFUSE = 5
KIND_SUBSURFACE = 6
KIND_MEASURED = 7


def _eval_spectral(value, lam, uv=None, p=None, n=None):
    """A reflectance-like parameter as an (N, L) spectrum: a number, a
    callable of lam, an rgb texture (Smits-converted) or a float texture
    (broadcast over the wavelengths).  Without a hit uv (the fused
    integrator's constant table) a texture is evaluated at uv 0.5, as in
    the reference."""
    N, L = lam.shape
    if value is None:
        return torch.zeros((N, L), dtype=torch.float32, device=lam.device)
    if isinstance(value, (int, float)):
        return torch.full((N, L), float(value), dtype=torch.float32,
                          device=lam.device)
    if hasattr(value, "eval"):
        from . import textures as tex_mod

        if uv is None:
            uv = torch.full((N, 2), 0.5, dtype=torch.float32,
                            device=lam.device)
        out = tex_mod.eval_texture(value, uv, p=p, n=n)
        if out.dim() == lam.dim() and out.shape[-1] == 3:
            from ..utils import spectrum as sp

            return sp.rgb_to_spectrum_smits_batched(out, lam)
        return torch.broadcast_to(out[..., None], (N, L))
    return torch.broadcast_to(value(lam).to(torch.float32), (N, L))


def _eval_float(value, uv=None, shape=None, p=None, n=None, device=None):
    """A float parameter as a `shape` tensor: a number, or a texture (an rgb
    texture reduced to its channel mean, as the reference does)."""
    if isinstance(value, (int, float)):
        return torch.full(shape, float(value), dtype=torch.float32,
                          device=device if uv is None else uv.device)
    from . import textures as tex_mod

    out = tex_mod.eval_texture(value, uv, p=p, n=n).to(torch.float32)
    if shape is not None and out.dim() == len(shape) + 1:
        out = out.mean(dim=-1)
    return torch.broadcast_to(out, shape)


class _Emissive:
    @property
    def emissive(self) -> bool:
        return self.emission is not None


@dataclass(frozen=True)
class DiffuseMaterial(_Emissive):
    """Lambertian: f = reflectance / pi; cosine-importance-sampled."""
    reflectance: Union[Callable, float, object]
    emission: Optional[Callable] = None   # lam -> emitted radiance
    emission_scale: float = 1.0

    kind = KIND_DIFFUSE

    def albedo_spectrum(self, lam, uv=None):
        return _eval_spectral(self.reflectance, lam, uv)


@dataclass(frozen=True)
class ConductorMaterial(_Emissive):
    """Metal with complex IOR eta - i k; roughness 0 is a mirror."""
    eta: Union[Callable, float] = 0.2
    k: Union[Callable, float] = 3.0
    roughness: Union[float, object] = 0.0     # GGX alpha (or a texture)
    emission: Optional[Callable] = None
    emission_scale: float = 1.0

    kind = KIND_CONDUCTOR

    def eta_spectrum(self, lam, uv=None):
        return _eval_spectral(self.eta, lam, uv)

    def k_spectrum(self, lam, uv=None):
        return _eval_spectral(self.k, lam, uv)


@dataclass(frozen=True)
class DielectricMaterial(_Emissive):
    """Glass: real scalar eta, GGX roughness."""
    eta: float = 1.5
    roughness: Union[float, object] = 0.0
    emission: Optional[Callable] = None
    emission_scale: float = 1.0

    kind = KIND_DIELECTRIC


@dataclass(frozen=True)
class ThinDielectricMaterial(_Emissive):
    eta: float = 1.5
    emission: Optional[Callable] = None
    emission_scale: float = 1.0

    kind = KIND_THIN_DIELECTRIC


@dataclass(frozen=True)
class DiffuseTransmissionMaterial(_Emissive):
    reflectance: Union[Callable, float, object] = 0.25
    transmittance: Union[Callable, float, object] = 0.25
    emission: Optional[Callable] = None
    emission_scale: float = 1.0

    kind = KIND_DIFFUSE_TRANSMISSION


@dataclass(frozen=True)
class CoatedDiffuseMaterial(_Emissive):
    """Dielectric coat over a Lambertian base: the Fresnel-coupled analytic
    model by default, the layered random walk (bxdfs.layered_sample) with
    stochastic=True."""
    reflectance: Union[Callable, float, object] = 0.5
    eta: float = 1.5
    roughness: Union[Callable, float] = 0.0
    thickness: float = 0.01
    g: float = 0.0
    albedo_med: Union[Callable, float, object, None] = None
    stochastic: bool = False
    emission: Optional[Callable] = None
    emission_scale: float = 1.0

    kind = KIND_COATED_DIFFUSE


@dataclass(frozen=True)
class MixMaterial:
    """Per-hit choice between two materials by a hash of the hit uv against
    `amount`, the probability of m1 (materials.h MixMaterial)."""
    m1: object
    m2: object
    amount: float = 0.5

    emission = None
    emission_scale = 1.0

    @property
    def emissive(self) -> bool:
        return bool(getattr(self.m1, "emissive", False)
                    or getattr(self.m2, "emissive", False))

    @property
    def kind(self):
        return getattr(self.m1, "kind", KIND_DIFFUSE)


@dataclass(frozen=True)
class SubsurfaceMaterial(_Emissive):
    """Subsurface scattering (materials.h subsurface, bssrdf.{h,cpp}):
    a diffusion BSSRDF given by its diffuse reflectance and mean free path
    per RGB channel.  models/bssrdf.py samples the exit point; path.py
    continues from it as a Lambertian vertex."""
    reflectance_rgb: tuple = (0.5, 0.5, 0.5)
    mfp_rgb: tuple = (0.01, 0.01, 0.01)
    eta: float = 1.33
    #: "burley" = normalized diffusion; "tabulated" = the photon beam
    #: diffusion table (bssrdf.compute_beam_diffusion_table)
    profile: str = "burley"
    g: float = 0.0
    emission: Optional[Callable] = None
    emission_scale: float = 1.0

    kind = KIND_SUBSURFACE

    @property
    def reflectance(self):
        """The albedo an integrator without a BSSRDF walk uses (the fused
        volumetric surface branch): mean(reflectance_rgb)."""
        return float(np.mean(self.reflectance_rgb))


@dataclass(frozen=True)
class MeasuredMaterial(_Emissive):
    """A measured BRDF (materials.h MeasuredMaterial, bxdfs.h
    MeasuredBxDF): the RGL .bsdf tables of models/measured.py, dispatched
    per lane through the integrators' measured-table registry."""
    brdf: object                        # models.measured.MeasuredBRDF
    filename: str = ""
    emission: Optional[Callable] = None
    emission_scale: float = 1.0

    kind = KIND_MEASURED
    roughness = 1.0                     # never treated as specular
    eta = 1.5
