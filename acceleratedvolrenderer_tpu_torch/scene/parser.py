""".pbrt scene-description parser (a subset) and scene builder (port of
acceleratedvolrenderer_tpu/scene/parser.py: tokenize, the PbrtParser
handlers, load_scene and format_scene).

The statements and their parameters are pbrt-v4's (parser.h's Tokenizer
and ParserTarget, scene.h's BasicSceneBuilder): LookAt / Translate / Scale
/ Rotate / Transform / ConcatTransform and the CTM stack, Camera
(perspective, orthographic, spherical, realistic), Film, PixelFilter,
Sampler, Integrator, WorldBegin, AttributeBegin/End, LightSource
(distant, infinite with or without an image and a portal, point, spot),
AreaLightSource, MakeNamedMedium (uniformgrid, rgbgrid, homogeneous),
MediumInterface, Material / MakeNamedMaterial / NamedMaterial, Texture,
Shape (sphere, disk, cylinder, trianglemesh, plymesh, bilinearmesh,
curve; a shape inside a medium bounds it), Include and Import.  Unknown
directives warn and skip their parameter lists.

The transforms and the parsed arrays are numpy, float64 where the
reference computes in float64 and cast to float32 where it casts, so a
file gives the same numbers in both packages.  The tokenizer reads a long
bracketed list of numbers as one block, parsed in bulk (_Numbers); its
tokens are the reference tokenizer's.  load_scene returns a Scene whose
tensors are on the CUDA card unless the caller asks for another device.
"""
from __future__ import annotations

import dataclasses
import os
import re
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import lights as lm
from ..models.cameras import OrthographicCamera, PerspectiveCamera, SphericalCamera
from ..models.film import BoxFilter, GaussianFilter, TriangleFilter
from ..models import textures as tex_mod
from ..models.media import MediumSpec
from ..utils import spectrum as sp
from ..utils import vecmath as vmu
from ..utils.device import resolve
from .types import Scene

_DIRECTIVES = {
    "LookAt", "Translate", "Scale", "Rotate", "Transform", "ConcatTransform",
    "Identity", "Camera", "Film", "PixelFilter", "Sampler", "Integrator",
    "WorldBegin", "WorldEnd", "AttributeBegin", "AttributeEnd",
    "TransformBegin", "TransformEnd", "ObjectBegin", "ObjectEnd",
    "ObjectInstance", "LightSource", "AreaLightSource", "MakeNamedMedium",
    "MediumInterface", "Material", "MakeNamedMaterial", "NamedMaterial",
    "Texture", "Shape", "Include", "Import", "Option", "ReverseOrientation",
    "CoordinateSystem", "CoordSysTransform", "Accelerator", "ColorSpace",
    "Attribute",
}


# one token of the reference tokenizer, or (group "num") a bracketed list
# of numbers, or an unterminated string (the last alternative)
_TOKEN = re.compile(r'[ \t\r\n]+|#[^\n]*|"[^"]*"'
                    r'|\[(?P<num>[0-9eE+\-. \t\r\n]*)\]'
                    r'|[\[\]]|[^ \t\r\n"\[\]#]+|"')
# a list of numbers longer than this many characters stays one block
_BULK_CHARS = 4096


class _Numbers:
    """The tokens of a long bracketed list of numbers, kept as its text:
    `array` parses them in bulk (float64, each equal to float(token)),
    iteration and indexing give the tokens themselves."""

    def __init__(self, text: str):
        self.text = text
        self._array = None
        self._tokens = None

    @property
    def array(self) -> np.ndarray:
        if self._array is None:
            with warnings.catch_warnings():
                # a token np.fromstring cannot read warns: parse it alone,
                # so it raises as float() does in the reference
                warnings.simplefilter("error", DeprecationWarning)
                try:
                    self._array = np.fromstring(self.text, np.float64,
                                                sep=" ")
                except DeprecationWarning:
                    self._array = np.asarray([float(v) for v in self],
                                             np.float64)
        return self._array

    def tokens(self):
        if self._tokens is None:
            self._tokens = self.text.split()
        return self._tokens

    def __iter__(self):
        return iter(self.tokens())

    def __len__(self):
        return len(self.array)

    def __getitem__(self, i):
        return self.tokens()[i]

    def __str__(self):
        return f"[{len(self)} numbers]"


def _scan(text: str):
    """The reference tokenizer's tokens (parser.h:124: whitespace-separated;
    quoted strings; [ ] as tokens; # comments to the end of the line),
    except that a bracketed list of numbers longer than _BULK_CHARS comes
    as "[", one _Numbers, "]"."""
    tokens = []
    for m in _TOKEN.finditer(text):
        tok = m.group()
        c = tok[0]
        if c in " \t\r\n#":
            continue
        if c == "[" and len(tok) > 1:
            num = m.group("num")
            tokens.append("[")
            if len(num) > _BULK_CHARS:
                tokens.append(_Numbers(num))
            else:
                tokens.extend(num.split())
            tokens.append("]")
        elif tok == '"':
            raise ValueError("unterminated string")
        else:
            tokens.append(tok)
    return tokens


def tokenize(text: str):
    """pbrt tokenizer (parser.h:124): whitespace-separated; quoted strings;
    [ ] as separate tokens; # comments to end of line."""
    out = []
    for tok in _scan(text):
        if isinstance(tok, _Numbers):
            out.extend(tok.tokens())
        else:
            out.append(tok)
    return out


def _parse_params(tokens, pos):
    """Parse a pbrt parameter list: '"type name" [values]'* returning
    (dict name -> (type, values), new_pos)."""
    params = {}
    n = len(tokens)
    while pos < n:
        t = tokens[pos]
        if not (t.startswith('"') and " " in t):
            break
        decl = t[1:-1]
        ptype, pname = decl.split(None, 1)
        pos += 1
        vals = []
        if (pos + 2 < n and tokens[pos] == "["
                and isinstance(tokens[pos + 1], _Numbers)):
            vals = tokens[pos + 1]
            pos += 3
        elif pos < n and tokens[pos] == "[":
            pos += 1
            while pos < n and tokens[pos] != "]":
                vals.append(tokens[pos])
                pos += 1
            pos += 1  # ']'
        elif pos < n:
            vals.append(tokens[pos])
            pos += 1
        params[pname] = (ptype, vals)
    return params, pos


def _floats(vals):
    if isinstance(vals, _Numbers):
        return vals.array.tolist()
    return [float(v) for v in vals]


def _f32(vals):
    """np.asarray(_floats(vals), np.float32), in bulk for a _Numbers."""
    if isinstance(vals, _Numbers):
        return vals.array.astype(np.float32)
    return np.asarray(_floats(vals), np.float32)


def _np_normalize(v):
    v = np.asarray(v, np.float64)
    return (v / max(np.linalg.norm(v), 1e-30)).astype(np.float32)


def _to_spectrum(ptype, vals):
    """Parameter -> spectrum callable."""
    if ptype in ("rgb", "color"):
        return sp.rgb_albedo_spectrum(_floats(vals))
    if ptype == "blackbody":
        return sp.blackbody_normalized(float(vals[0]))
    if ptype == "float" and len(vals) == 1:
        return sp.constant_spectrum(float(vals[0]))
    if ptype == "spectrum":
        if len(vals) == 1 and vals[0].startswith('"'):
            name = vals[0][1:-1]
            named = sp.named_spectrum(name)
            if named is not None:
                return named
            warnings.warn(f"named spectrum '{name}' approximated as constant 1")
            return sp.constant_spectrum(1.0)
        pairs = _floats(vals)
        return sp.piecewise_linear_spectrum(pairs[0::2], pairs[1::2])
    return sp.constant_spectrum(float(vals[0]))


@dataclass
class _GState:
    ctm: np.ndarray = field(default_factory=lambda: np.eye(4))
    material: Optional[object] = "diffuse"   # material object or kind str
    area_light: Optional[tuple] = None       # (spectrum, scale, two_sided)
    inside_medium: Optional[str] = None
    outside_medium: Optional[str] = None
    reverse_orientation: bool = False


class PbrtParser:
    """Tokenizer-driven builder producing a Scene (ParserTarget +
    BasicSceneBuilder in one, scene.h:382)."""

    def __init__(self, base_dir=".", device=None):
        self.base_dir = base_dir
        self.device = resolve(device)
        self.state = _GState()
        self.stack: List[_GState] = []
        self.named_media: Dict[str, MediumSpec] = {}
        self.named_materials: Dict[str, object] = {}
        self.named_textures: Dict[str, object] = {}
        self.primitives: List = []
        self.lights: List = []
        self.camera = None
        self.cam_kind = "perspective"
        self.cam_params = {}
        self.camera_ctm = np.eye(4)
        self.film_res = (1280, 720)
        self.film_name = "out.exr"
        self.filter = GaussianFilter()
        self.integrator = "volpath"
        self.max_depth = 5
        self.spp = 16
        self.sampler = "independent"
        self.world = False
        self.camera_medium: Optional[str] = None
        self.shapes = []

    # -------------------------------------------------------------- driving
    def parse_file(self, path: str) -> Scene:
        with open(path) as f:
            text = f.read()
        self.base_dir = os.path.dirname(os.path.abspath(path))
        self.parse_tokens(_scan(text))
        return self.build()

    def parse_string(self, text: str) -> Scene:
        self.parse_tokens(_scan(text))
        return self.build()

    def parse_tokens(self, tokens):
        pos = 0
        n = len(tokens)
        while pos < n:
            tok = tokens[pos]
            pos += 1
            handler = (getattr(self, f"_h_{tok}", None)
                       if isinstance(tok, str) else None)
            if handler is None:
                if tok in _DIRECTIVES:
                    # recognized but unsupported: skip its parameter list
                    if pos < n and tokens[pos].startswith('"'):
                        pos += 1
                    _, pos = _parse_params(tokens, pos)
                    warnings.warn(f"directive '{tok}' ignored")
                    continue
                raise ValueError(f"unknown token '{tok}'")
            pos = handler(tokens, pos)

    # ------------------------------------------------------------ transforms
    def _h_LookAt(self, t, p):
        v = _floats(t[p: p + 9])
        eye, look, up = v[0:3], v[3:6], v[6:9]
        # the inverse of the camera-to-world matrix, rounded to float32 as
        # the reference's Transform holds it
        w2c = np.linalg.inv(vmu.look_at_matrix(eye, look, up))
        self.state.ctm = self.state.ctm @ w2c.astype(np.float32).astype(
            np.float64)
        return p + 9

    def _h_Translate(self, t, p):
        m = np.eye(4)
        m[:3, 3] = _floats(t[p: p + 3])
        self.state.ctm = self.state.ctm @ m
        return p + 3

    def _h_Scale(self, t, p):
        m = np.diag(_floats(t[p: p + 3]) + [1.0])
        self.state.ctm = self.state.ctm @ m
        return p + 3

    def _h_Rotate(self, t, p):
        v = _floats(t[p: p + 4])
        m = vmu.rotate_matrix(v[0], v[1:4]).astype(np.float32).astype(
            np.float64)
        self.state.ctm = self.state.ctm @ m
        return p + 4

    @staticmethod
    def _matrix16(t, p):
        """Read 16 floats at t[p:], with or without surrounding brackets."""
        if t[p] == "[":
            v = _floats(t[p + 1: p + 17])
            assert t[p + 17] == "]", "Transform matrix missing closing ']'"
            return v, p + 18
        return _floats(t[p: p + 16]), p + 16

    def _h_Transform(self, t, p):
        v, p = self._matrix16(t, p)
        # pbrt matrices are column-major in the file
        self.state.ctm = np.asarray(v, np.float64).reshape(4, 4).T
        return p

    def _h_ConcatTransform(self, t, p):
        v, p = self._matrix16(t, p)
        self.state.ctm = self.state.ctm @ np.asarray(v, np.float64).reshape(4, 4).T
        return p

    def _h_Identity(self, t, p):
        self.state.ctm = np.eye(4)
        return p

    def _h_ReverseOrientation(self, t, p):
        self.state.reverse_orientation = not self.state.reverse_orientation
        return p

    def _h_CoordinateSystem(self, t, p):
        return p + 1

    def _h_CoordSysTransform(self, t, p):
        return p + 1

    # ------------------------------------------------------------ pre-world
    def _h_Camera(self, t, p):
        self.cam_kind = t[p][1:-1]
        params, p = _parse_params(t, p + 1)
        self.cam_params = params
        # world-to-camera is the CTM at the Camera statement
        self.camera_ctm = self.state.ctm.copy()
        return p

    def _h_Film(self, t, p):
        _kind = t[p][1:-1]
        params, p = _parse_params(t, p + 1)
        xr = int(params.get("xresolution", (None, [1280]))[1][0])
        yr = int(params.get("yresolution", (None, [720]))[1][0])
        self.film_res = (xr, yr)
        if "filename" in params:
            self.film_name = params["filename"][1][0][1:-1]
        return p

    def _h_PixelFilter(self, t, p):
        kind = t[p][1:-1]
        params, p = _parse_params(t, p + 1)
        if kind == "box":
            r = float(params.get("xradius", (None, [0.5]))[1][0])
            self.filter = BoxFilter(radius=r)
        elif kind == "triangle":
            self.filter = TriangleFilter()
        else:
            r = float(params.get("xradius", (None, [1.5]))[1][0])
            s = float(params.get("sigma", (None, [0.5]))[1][0])
            self.filter = GaussianFilter(radius=r, sigma=s)
        return p

    def _h_Sampler(self, t, p):
        kind = t[p][1:-1]
        params, p = _parse_params(t, p + 1)
        if "pixelsamples" in params:
            self.spp = int(params["pixelsamples"][1][0])
        # every pbrt sampler name maps 1:1 (models.samplers implements the
        # full family for film AND path-interior dims)
        known = ("stratified", "sobol", "paddedsobol", "zsobol", "halton",
                 "pmj02bn", "independent")
        self.sampler = kind if kind in known else "independent"
        return p

    def _h_Integrator(self, t, p):
        self.integrator = t[p][1:-1]
        params, p = _parse_params(t, p + 1)
        if "maxdepth" in params:
            self.max_depth = int(params["maxdepth"][1][0])
        return p

    def _h_Option(self, t, p):
        _, p = _parse_params(t, p)
        return p

    def _h_Accelerator(self, t, p):
        _ = t[p]
        _, p = _parse_params(t, p + 1)
        return p

    def _h_ColorSpace(self, t, p):
        return p + 1

    # ---------------------------------------------------------------- world
    def _h_WorldBegin(self, t, p):
        self.world = True
        self.state = _GState()
        return p

    def _h_WorldEnd(self, t, p):
        return p

    def _h_AttributeBegin(self, t, p):
        import copy

        self.stack.append(copy.deepcopy(self.state))
        return p

    def _h_AttributeEnd(self, t, p):
        self.state = self.stack.pop()
        return p

    _h_TransformBegin = _h_AttributeBegin
    _h_TransformEnd = _h_AttributeEnd

    def _h_Attribute(self, t, p):
        _ = t[p]
        _, p = _parse_params(t, p + 1)
        return p

    def _h_LightSource(self, t, p):
        kind = t[p][1:-1]
        params, p = _parse_params(t, p + 1)
        scale = float(params.get("scale", (None, [1.0]))[1][0])
        ctm = self.state.ctm

        def xf_point(q):
            q = np.asarray(q + [1.0])
            r = ctm @ q
            return (r[:3] / r[3]).astype(np.float32)

        def xf_vec(q):
            return (ctm[:3, :3] @ np.asarray(q)).astype(np.float32)

        if kind == "distant":
            Lt, Lv = params.get("L", ("rgb", ["1", "1", "1"]))
            spec = _to_spectrum(Lt, Lv)
            frm = _floats(params.get("from", (None, ["0", "0", "0"]))[1])
            to = _floats(params.get("to", (None, ["0", "0", "1"]))[1])
            d = xf_point(to) - xf_point(frm)
            d = d / np.linalg.norm(d)
            self.lights.append(lm.DistantLight(
                direction=torch.as_tensor(d, dtype=torch.float32),
                spectrum=spec, scale=scale))
        elif kind == "infinite":
            Lt, Lv = params.get("L", ("rgb", ["1", "1", "1"]))
            spec = _to_spectrum(Lt, Lv)
            img = None
            if "filename" in params:
                fn = params["filename"][1][0].strip('"')
                try:
                    from ..utils import image as im

                    img, _meta = im.read_image(fn)
                except Exception as e:   # missing/unsupported file
                    warnings.warn(f"infinite light image '{fn}': {e}; "
                                  "falling back to uniform")
            if img is not None and "portal" in params:
                pv = _floats(params["portal"][1])
                portal = np.asarray(pv, np.float64).reshape(4, 3)
                portal = np.stack([xf_point(list(q)) for q in portal])
                mapping = ("equalarea" if img.shape[0] == img.shape[1]
                           else "equirect")
                self.lights.append(lm.PortalImageInfiniteLight(
                    img, portal, scale=scale, mapping=mapping))
            elif img is not None:
                if img.shape[0] == img.shape[1]:
                    # pbrt-v4 equal-area octahedral env map -> equirect
                    from ..utils import sky as _sky

                    H = img.shape[0]
                    th = (np.arange(H) + 0.5) / H * np.pi
                    ph = (np.arange(2 * H) + 0.5) / (2 * H) * 2 * np.pi
                    tt, pp = np.meshgrid(th, ph, indexing="ij")
                    st = np.sin(tt)
                    d = np.stack([st * np.cos(pp), st * np.sin(pp),
                                  np.cos(tt)], -1)
                    uv = _sky.equal_area_sphere_to_square(d)
                    sx = np.clip((uv[..., 0] * img.shape[1]).astype(np.int64),
                                 0, img.shape[1] - 1)
                    sy = np.clip((uv[..., 1] * img.shape[0]).astype(np.int64),
                                 0, img.shape[0] - 1)
                    img = img[sy, sx]
                self.lights.append(lm.ImageInfiniteLight(img, scale=scale))
            else:
                self.lights.append(
                    lm.UniformInfiniteLight(spectrum=spec, scale=scale))
        elif kind == "point":
            It, Iv = params.get("I", ("rgb", ["1", "1", "1"]))
            spec = _to_spectrum(It, Iv)
            frm = _floats(params.get("from", (None, ["0", "0", "0"]))[1])
            self.lights.append(lm.PointLight(position=xf_point(frm), spectrum=spec, scale=scale))
        elif kind == "spot":
            It, Iv = params.get("I", ("rgb", ["1", "1", "1"]))
            spec = _to_spectrum(It, Iv)
            frm = _floats(params.get("from", (None, ["0", "0", "0"]))[1])
            to = _floats(params.get("to", (None, ["0", "0", "1"]))[1])
            cone = float(params.get("coneangle", (None, ["30"]))[1][0])
            delta = float(params.get("conedeltaangle", (None, ["5"]))[1][0])
            pos_w = xf_point(frm)
            d = xf_point(to) - pos_w
            d = d / np.linalg.norm(d)
            self.lights.append(lm.SpotLight(
                position=pos_w, direction=d, spectrum=spec, scale=scale,
                cone_angle_deg=cone, cone_delta_deg=delta))
        else:
            warnings.warn(f"light '{kind}' unsupported; skipped")
        return p

    def _h_AreaLightSource(self, t, p):
        _ = t[p]   # "diffuse"
        params, p = _parse_params(t, p + 1)
        L = (_to_spectrum(*params["L"]) if "L" in params
             else sp.constant_spectrum(1.0))
        scale = float(params.get("scale", (None, ["1"]))[1][0])
        two = params.get("twosided", (None, ["false"]))[1][0] == "true"
        self.state.area_light = (L, scale, two)
        return p

    def _h_MakeNamedMedium(self, t, p):
        name = t[p][1:-1]
        params, p = _parse_params(t, p + 1)
        kind = params.get("type", ("string", ['"homogeneous"']))[1][0].strip('"')
        sa = _to_spectrum(*params.get("sigma_a", ("rgb", ["1", "1", "1"])))
        ss = _to_spectrum(*params.get("sigma_s", ("rgb", ["1", "1", "1"])))
        g = float(params.get("g", (None, ["0"]))[1][0])
        scale = float(params.get("scale", (None, ["1"]))[1][0])
        Le = _to_spectrum(*params["Le"]) if "Le" in params else None
        Le_scale = float(params.get("Lescale", (None, ["1"]))[1][0])
        m2w = self.state.ctm.copy()
        if kind == "rgbgrid":
            # RGBGridMedium: per-voxel RGB sigma_a/sigma_s (+Le) arrays
            nx = int(params["nx"][1][0])
            ny = int(params["ny"][1][0])
            nz = int(params["nz"][1][0])
            p0 = _floats(params.get("p0", (None, ["0", "0", "0"]))[1])
            p1 = _floats(params.get("p1", (None, ["1", "1", "1"]))[1])

            def grid3(key):
                if key not in params:
                    return None
                return torch.as_tensor(_f32(params[key][1]).reshape(nz, ny, nx, 3))

            spec = MediumSpec(
                sigma_a_spec=sa, sigma_s_spec=ss, g=g, scale=scale,
                bounds_lo=np.asarray(p0, np.float32),
                bounds_hi=np.asarray(p1, np.float32),
                Le_scale=Le_scale,
                sigma_a_rgb=grid3("sigma_a"),
                sigma_s_rgb=grid3("sigma_s"),
                Le_rgb=grid3("Le"),
                majorant_res=(16, 16, 16),
                m2w=m2w if not np.allclose(m2w, np.eye(4)) else None,
            )
        elif kind == "uniformgrid":
            nx = int(params["nx"][1][0])
            ny = int(params["ny"][1][0])
            nz = int(params["nz"][1][0])
            p0 = _floats(params.get("p0", (None, ["0", "0", "0"]))[1])
            p1 = _floats(params.get("p1", (None, ["1", "1", "1"]))[1])
            dens = torch.as_tensor(_f32(params["density"][1]).reshape(nz, ny, nx))
            # medium-to-world: ctm maps the p0..p1 box
            spec = MediumSpec(
                sigma_a_spec=sa, sigma_s_spec=ss, g=g, scale=scale,
                density=dens, bounds_lo=np.asarray(p0, np.float32),
                bounds_hi=np.asarray(p1, np.float32),
                Le_spec=Le, Le_scale=Le_scale,
                majorant_res=(16, 16, 16),   # media.cpp:229
                m2w=m2w if not np.allclose(m2w, np.eye(4)) else None,
            )
        elif kind == "homogeneous":
            spec = MediumSpec(
                sigma_a_spec=sa, sigma_s_spec=ss, g=g, scale=scale,
                density=None, Le_spec=Le, Le_scale=Le_scale,
                m2w=m2w if not np.allclose(m2w, np.eye(4)) else None,
            )
        else:
            warnings.warn(f"medium type '{kind}' unsupported; homogeneous stand-in")
            spec = MediumSpec(sigma_a_spec=sa, sigma_s_spec=ss, g=g, scale=scale)
        self.named_media[name] = spec
        return p

    def _h_MediumInterface(self, t, p):
        inside = t[p][1:-1]
        outside = t[p + 1][1:-1] if p + 1 < len(t) and t[p + 1].startswith('"') else ""
        self.state.inside_medium = inside or None
        self.state.outside_medium = outside or None
        if not self.world:
            self.camera_medium = inside or None
        return p + (2 if p + 1 < len(t) and t[p + 1].startswith('"') else 1)

    def _build_material(self, kind, params):
        """Material statement -> models.materials object (materials.h
        factory subset: diffuse/conductor/dielectric/thindielectric/
        diffusetransmission/coateddiffuse/mix)."""
        from ..models import materials as mats

        def spec(name, default):
            if name in params:
                ptype, vals = params[name]
                if ptype == "texture":
                    # "texture <param>" "name" — reference resolves named
                    # textures in the material factory (materials.cpp)
                    tx = self.named_textures.get(vals[0].strip('"'))
                    if tx is not None:
                        return tx
                    warnings.warn(f"unknown texture '{vals[0]}' for "
                                  f"'{name}'; using {default}")
                    return sp.constant_spectrum(default)
                return _to_spectrum(ptype, vals)
            return sp.constant_spectrum(default)

        def flt(name, default):
            if name in params:
                ptype, vals = params[name]
                if ptype == "texture":
                    tx = self.named_textures.get(vals[0].strip('"'))
                    if tx is not None:
                        return tx
                    return default
                return float(vals[0])
            return default

        if kind in ("", None):
            return None
        if kind == "conductor":
            return mats.ConductorMaterial(
                eta=spec("eta", 0.2), k=spec("k", 3.9),
                roughness=flt("roughness", 0.0))
        if kind == "dielectric":
            return mats.DielectricMaterial(eta=flt("eta", 1.5),
                                           roughness=flt("roughness", 0.0))
        if kind == "thindielectric":
            return mats.ThinDielectricMaterial(eta=flt("eta", 1.5))
        if kind == "diffusetransmission":
            return mats.DiffuseTransmissionMaterial(
                reflectance=spec("reflectance", 0.25),
                transmittance=spec("transmittance", 0.25))
        if kind == "coateddiffuse":
            def sflt(name, default):
                v = flt(name, default)
                return v if isinstance(v, (int, float)) else default

            # explicit slab parameters opt into the reference's stochastic
            # LayeredBxDF interface walk (bxdfs.h:432); otherwise the
            # deterministic Fresnel-coupled model is used
            layered = any(k in params for k in
                          ("thickness", "albedo", "g", "maxdepth",
                           "nsamples"))
            return mats.CoatedDiffuseMaterial(
                reflectance=spec("reflectance", 0.5),
                eta=sflt("eta", 1.5), roughness=flt("roughness", 0.0),
                thickness=sflt("thickness", 0.01), g=sflt("g", 0.0),
                albedo_med=(_to_spectrum(*params["albedo"])
                            if "albedo" in params else None),
                stochastic=layered)
        if kind == "subsurface":
            def rgb3(name, default):
                if name in params:
                    return tuple(_floats(params[name][1]))
                return (default,) * 3

            return mats.SubsurfaceMaterial(
                reflectance_rgb=rgb3("reflectance", 0.5),
                mfp_rgb=rgb3("mfp", 0.01), eta=flt("eta", 1.33))
        if kind == "measured":
            from ..models import measured as measured_mod

            fn = params.get("filename", (None, ['""']))[1][0].strip('"')
            return mats.MeasuredMaterial(
                brdf=measured_mod.MeasuredBRDF.from_file(fn), filename=fn)
        if kind == "mix":
            names = [v.strip('"') for v in
                     params.get("materials", (None, []))[1]]
            _default = mats.DiffuseMaterial(
                reflectance=sp.constant_spectrum(0.5))
            m1 = self.named_materials.get(names[0] if names else "", _default)
            m2 = self.named_materials.get(
                names[1] if len(names) > 1 else "", _default)
            amt = flt("amount", 0.5)
            if not isinstance(amt, (int, float)):
                amt = 0.5      # texture amount: per-lane choice round-3
            return mats.MixMaterial(m1=m1, m2=m2, amount=amt)
        if kind != "diffuse":
            warnings.warn(f"material '{kind}' approximated as diffuse")
        return mats.DiffuseMaterial(reflectance=spec("reflectance", 0.5))

    def _h_Material(self, t, p):
        kind = t[p][1:-1]
        params, p = _parse_params(t, p + 1)
        self.state.material = self._build_material(kind, params)
        return p

    def _h_MakeNamedMaterial(self, t, p):
        name = t[p][1:-1]
        params, p = _parse_params(t, p + 1)
        kind = params.get("type", ("string", ['"diffuse"']))[1][0].strip('"')
        self.named_materials[name] = self._build_material(kind, params)
        return p

    def _h_NamedMaterial(self, t, p):
        name = t[p][1:-1]
        self.state.material = self.named_materials.get(name)
        return p + 1

    def _h_Texture(self, t, p):
        # Texture "name" "type" "class" params  (parser.cpp Texture ->
        # Float/SpectrumTexture::Create, textures.cpp)
        name = t[p][1:-1]
        cls = t[p + 2][1:-1]
        params, p = _parse_params(t, p + 3)
        try:
            self.named_textures[name] = self._build_texture(cls, params)
        except Exception as e:
            warnings.warn(f"texture '{name}' ({cls}): {e}; using constant")
            self.named_textures[name] = tex_mod.ConstantTexture(0.5)
        return p

    def _tex_param(self, params, pname, default):
        """Texture-or-value parameter inside a Texture statement."""
        if pname not in params:
            return tex_mod.ConstantTexture(default)
        ptype, vals = params[pname]
        if ptype == "texture":
            return self.named_textures.get(
                vals[0].strip('"'), tex_mod.ConstantTexture(default))
        if ptype in ("rgb", "color", "spectrum"):
            return tex_mod.ConstantRGBTexture(tuple(_floats(vals[:3])))
        return tex_mod.ConstantTexture(float(vals[0]))

    def _build_texture(self, cls, params):
        """Texture factory (textures.cpp Create* subset).  Non-uv
        parameterizations compose via MappedTexture + a TextureMapping2D
        built from the "mapping"/uscale/vscale/udelta/vdelta/v1/v2
        parameters and the CTM at declaration (renderFromTexture)."""
        def flt(pname, default):
            return (float(params[pname][1][0]) if pname in params
                    else default)

        def s(pname, default):
            return (params[pname][1][0].strip('"') if pname in params
                    else default)

        if cls == "constant":
            if "value" in params and params["value"][0] in ("rgb", "color"):
                return tex_mod.ConstantRGBTexture(
                    tuple(_floats(params["value"][1][:3])))
            return tex_mod.ConstantTexture(flt("value", 1.0))
        if cls == "scale":
            return tex_mod.ScaleTexture(
                base=self._tex_param(params, "tex", 1.0),
                scale=flt("scale", 1.0))
        if cls == "mix":
            return tex_mod.MixTexture(
                tex1=self._tex_param(params, "tex1", 0.0),
                tex2=self._tex_param(params, "tex2", 1.0),
                amount=flt("amount", 0.5))
        if cls == "directionmix":
            d = (_floats(params["dir"][1]) if "dir" in params
                 else [0.0, 1.0, 0.0])
            return tex_mod.DirectionMixTexture(
                tex1=self._tex_param(params, "tex1", 0.0),
                tex2=self._tex_param(params, "tex2", 1.0), dir=tuple(d))
        if cls in ("imagemap", "ptex"):
            if cls == "ptex":
                raise ValueError("ptex textures unsupported (face-indexed "
                                 "Ptex requires per-face uv; see README)")
            from ..utils import image as im

            fn = s("filename", "")
            if not os.path.isabs(fn):
                fn = os.path.join(self.base_dir, fn)
            img, _meta = im.read_image(fn)
            base = tex_mod.ImageTexture(
                img, scale=flt("scale", 1.0),
                invert=s("invert", "false") == "true")
            return self._wrap_mapping(base, params)
        if cls == "checkerboard":
            base = tex_mod.CheckerboardTexture(
                tex1=self._tex_param(params, "tex1", 1.0),
                tex2=self._tex_param(params, "tex2", 0.0))
            return self._wrap_mapping(base, params)
        if cls == "fbm":
            return tex_mod.FBmTexture(octaves=int(flt("octaves", 6)),
                                      omega=flt("roughness", 0.5))
        if cls == "wrinkled":
            return tex_mod.WrinkledTexture(octaves=int(flt("octaves", 6)),
                                           omega=flt("roughness", 0.5))
        if cls == "windy":
            return tex_mod.WindyTexture()
        if cls == "marble":
            return tex_mod.MarbleTexture(
                scale=flt("scale", 4.0), variation=flt("variation", 0.2),
                octaves=int(flt("octaves", 6)), omega=flt("roughness", 0.5))
        if cls == "dots":
            return self._wrap_mapping(tex_mod.DotsTexture(
                inside=flt("inside", 1.0), outside=flt("outside", 0.0)),
                params)
        if cls == "bilerp":
            return tex_mod.BilerpTexture(
                v00=flt("v00", 0.0), v01=flt("v01", 1.0),
                v10=flt("v10", 0.0), v11=flt("v11", 1.0))
        raise ValueError(f"unknown texture class '{cls}'")

    def _wrap_mapping(self, base, params):
        """Apply the "mapping" parameter family (TextureMapping2D::Create,
        textures.cpp:40-76)."""
        def flt(pname, default):
            return (float(params[pname][1][0]) if pname in params
                    else default)

        kind = (params["mapping"][1][0].strip('"') if "mapping" in params
                else "uv")
        tfr = tuple(map(tuple, np.linalg.inv(self.state.ctm)))
        if kind == "uv":
            su, sv = flt("uscale", 1.0), flt("vscale", 1.0)
            du, dv = flt("udelta", 0.0), flt("vdelta", 0.0)
            if (su, sv, du, dv) == (1.0, 1.0, 0.0, 0.0):
                return base
            return tex_mod.MappedTexture(base, tex_mod.UVMapping(
                su=su, sv=sv, du=du, dv=dv))
        if kind == "spherical":
            return tex_mod.MappedTexture(
                base, tex_mod.SphericalMapping(texture_from_render=tfr))
        if kind == "cylindrical":
            return tex_mod.MappedTexture(
                base, tex_mod.CylindricalMapping(texture_from_render=tfr))
        if kind == "planar":
            v1 = (_floats(params["v1"][1]) if "v1" in params
                  else [1.0, 0.0, 0.0])
            v2 = (_floats(params["v2"][1]) if "v2" in params
                  else [0.0, 1.0, 0.0])
            return tex_mod.MappedTexture(base, tex_mod.PlanarMapping(
                vs=tuple(v1), vt=tuple(v2), ds=flt("udelta", 0.0),
                dt=flt("vdelta", 0.0), texture_from_render=tfr))
        warnings.warn(f"unknown texture mapping '{kind}'; using uv")
        return base

    def _h_Shape(self, t, p):
        kind = t[p][1:-1]
        params, p = _parse_params(t, p + 1)
        # shapes bounding a medium: record the interface; the medium's own
        # bounds drive the march, matching MediumData's single-medium
        # aggregate model (graph util.h:61-91)
        if self.state.inside_medium:
            self.shapes.append((kind, params, self.state.inside_medium,
                                self.state.ctm.copy()))
        elif self.state.material is not None:
            self._add_opaque_shape(kind, params)
        return p

    def _add_opaque_shape(self, kind, params):
        """Opaque primitive construction (shapes.h factory subset) with the
        current transform, material, and area-light emission applied."""
        import dataclasses as _dc

        from ..models import materials as mats
        from ..models import shapes as shp

        mat = self.state.material
        if isinstance(mat, str):
            mat = mats.DiffuseMaterial(
                reflectance=sp.constant_spectrum(0.5))
        if self.state.area_light is not None and mat is not None \
                and not isinstance(mat, mats.MixMaterial):
            L, scale, _two = self.state.area_light
            mat = _dc.replace(mat, emission=L, emission_scale=scale)

        m = self.state.ctm
        o2w = np.linalg.inv(m) if False else m   # ctm is world-from-object
        def xf(pt):
            pt = np.asarray(pt, np.float64)
            return (o2w[:3, :3] @ pt + o2w[:3, 3]).astype(np.float32)
        def xfv(v):
            return (o2w[:3, :3] @ np.asarray(v, np.float64)).astype(np.float32)
        uscale = float(np.cbrt(max(abs(np.linalg.det(o2w[:3, :3])), 1e-30)))

        def flt(name, default):
            return (float(params[name][1][0]) if name in params else default)

        if kind == "sphere":
            self.primitives.append(shp.Sphere(
                center=xf([0, 0, 0]), radius=flt("radius", 1.0) * uscale,
                material=mat))
        elif kind == "disk":
            h = flt("height", 0.0)
            self.primitives.append(shp.Disk(
                center=xf([0, 0, h]), normal=_np_normalize(xfv([0, 0, 1])),
                radius=flt("radius", 1.0) * uscale,
                inner_radius=flt("innerradius", 0.0) * uscale, material=mat))
        elif kind == "cylinder":
            self.primitives.append(shp.Cylinder(
                p0=xf([0, 0, flt("zmin", -1.0)]),
                p1=xf([0, 0, flt("zmax", 1.0)]),
                radius=flt("radius", 1.0) * uscale, material=mat))
        elif kind == "trianglemesh":
            P = np.asarray(_floats(params["P"][1]), np.float64).reshape(-1, 3)
            idx = np.asarray([int(v) for v in params["indices"][1]],
                             np.int32).reshape(-1, 3)
            V = np.stack([xf(q) for q in P])
            uv = None
            if "uv" in params or "st" in params:
                key = "uv" if "uv" in params else "st"
                uv = _f32(params[key][1]).reshape(-1, 2)
            self.primitives.append(shp.TriangleMesh(
                vertices=V, indices=idx, material=mat, uvs=uv))
        elif kind == "plymesh":
            from ..utils import ply as ply_mod

            fname = params["filename"][1][0].strip('"')
            mesh = ply_mod.read_ply(os.path.join(self.base_dir, fname))
            V = np.stack([xf(q) for q in mesh["vertices"]])
            self.primitives.append(shp.TriangleMesh(
                vertices=V, indices=mesh["faces"], material=mat,
                uvs=mesh.get("uvs")))
        elif kind == "bilinearmesh":
            P = np.asarray(_floats(params["P"][1]), np.float64).reshape(-1, 3)
            idx = (np.asarray([int(v) for v in params["indices"][1]],
                              np.int32).reshape(-1, 4)
                   if "indices" in params
                   else np.arange(len(P), dtype=np.int32).reshape(-1, 4))
            for quad in idx:
                self.primitives.append(shp.BilinearPatch(
                    p00=xf(P[quad[0]]), p10=xf(P[quad[1]]),
                    p01=xf(P[quad[2]]), p11=xf(P[quad[3]]), material=mat))
        elif kind == "curve":
            P = np.asarray(_floats(params["P"][1]), np.float64).reshape(-1, 3)
            w0 = flt("width0", flt("width", 0.01))
            w1 = flt("width1", flt("width", 0.01))
            for i in range(0, len(P) - 3, 3):
                self.primitives.append(shp.Curve(
                    cp=np.stack([xf(q) for q in P[i:i + 4]]),
                    width0=w0 * uscale, width1=w1 * uscale, material=mat))
        else:
            warnings.warn(f"opaque shape '{kind}' unsupported; skipped")

    def _h_Include(self, t, p):
        path = t[p][1:-1]
        full = os.path.join(self.base_dir, path)
        with open(full) as f:
            sub = _scan(f.read())
        self.parse_tokens(sub)
        return p + 1

    _h_Import = _h_Include

    # ---------------------------------------------------------------- build
    def build(self) -> Scene:
        w, h = self.film_res
        c2w_np = np.linalg.inv(self.camera_ctm)
        c2w = vmu.Transform.from_numpy(c2w_np, self.camera_ctm, "cpu")
        fov = float(self.cam_params.get("fov", (None, ["90"]))[1][0]) if self.cam_params else 90.0
        if self.cam_kind == "orthographic":
            camera = OrthographicCamera(c2w=c2w, screen_scale=1.0, width=w, height=h)
        elif self.cam_kind == "spherical":
            camera = SphericalCamera(c2w=c2w, width=w, height=h)
        elif self.cam_kind == "realistic":
            from ..models.cameras import (RealisticCamera, SIMPLE_LENS,
                                          load_lens_file)

            lf = self.cam_params.get("lensfile")
            elems = (load_lens_file(
                os.path.join(self.base_dir, lf[1][0].strip('"')))
                if lf else SIMPLE_LENS)
            camera = RealisticCamera(c2w=c2w, elements=elems, width=w,
                                     height=h, rear_offset=0.045)
        else:
            camera = PerspectiveCamera(c2w=c2w, fov_deg=fov, width=w, height=h)

        medium = None
        if self.named_media:
            used = {s[2] for s in self.shapes}
            name = next(iter(used)) if used else next(iter(self.named_media))
            medium = self.named_media[name]
            if not medium.homogeneous:
                # the 16^3 majorant, once, from the parsed grid
                medium = dataclasses.replace(
                    medium, majorant=medium.build_majorant())

        return Scene(
            camera=camera, medium=medium, lights=self.lights,
            primitives=self.primitives,
            max_depth=self.max_depth, filter=self.filter, spp=self.spp,
            sampler=self.sampler, integrator=self.integrator,
        ).to(self.device)


def load_scene(path: str, device=None) -> Scene:
    """The Scene of a .pbrt file, its tensors on `device` (the CUDA card by
    default; utils/device.py::resolve)."""
    return PbrtParser(device=device).parse_file(path)


# --------------------------------------------------------------------------
# pbrt --format / --toply: statement-level reformatting of a scene file
# (reference cmd/pbrt.cpp `format`/`toPly` modes, via FormattingParserTarget).

_BLOCK_OPEN = {"AttributeBegin", "TransformBegin", "ObjectBegin"}
_BLOCK_CLOSE = {"AttributeEnd", "TransformEnd", "ObjectEnd"}


def _statements(tokens):
    """Group a token stream into (directive, args, params) statements.
    args are the fixed positional tokens (numbers / quoted type names);
    params is the trailing '"type name" [values]' list, kept as tokens."""
    out = []
    pos, n = 0, len(tokens)
    while pos < n:
        direc = tokens[pos]
        pos += 1
        args = []
        # positional args: everything until the next directive or param decl
        while pos < n and not tokens[pos][0].isalpha():
            if tokens[pos].startswith('"') and " " in tokens[pos]:
                break
            # keep bracket tokens verbatim so bracketed positional args
            # (Transform/ConcatTransform matrices) round-trip through
            # format_scene → parse (reference FormattingParserTarget
            # preserves brackets, parser.cpp)
            args.append(tokens[pos])
            pos += 1
        params, pos = _parse_params(tokens, pos)
        out.append((direc, args, params))
    return out


def format_scene(path: str, toply: str = None) -> str:
    """Reformat a .pbrt file with canonical indentation. With `toply`,
    inline trianglemesh shapes are written to <toply>_NNN.ply and replaced
    by plymesh references (the reference's `pbrt --toply out.pbrt`)."""
    with open(path) as f:
        toks = tokenize(f.read())
    lines, indent, nply = [], 0, 0
    for direc, args, params in _statements(toks):
        if direc in _BLOCK_CLOSE:
            indent = max(0, indent - 1)
        if (toply and direc == "Shape" and args
                and args[0] == '"trianglemesh"' and "P" in params
                and "indices" in params):
            verts = np.asarray(_floats(params["P"][1]),
                               np.float32).reshape(-1, 3)
            faces = np.asarray([int(v) for v in params["indices"][1]],
                               np.int32).reshape(-1, 3)
            norms = (np.asarray(_floats(params["N"][1]),
                                np.float32).reshape(-1, 3)
                     if "N" in params else None)
            uvs = (np.asarray(_floats(params["uv"][1]),
                              np.float32).reshape(-1, 2)
                   if "uv" in params else None)
            from ..utils.ply import write_ply

            ply_path = f"{toply.rsplit('.', 1)[0]}_{nply:03d}.ply"
            write_ply(ply_path, verts, faces, normals=norms, uvs=uvs)
            nply += 1
            rest = {k: v for k, v in params.items()
                    if k not in ("P", "indices", "N", "uv")}
            args = ['"plymesh"']
            params = {"filename": ("string", [f'"{ply_path}"']), **rest}
        pad = "    " * indent
        head = " ".join([direc] + args)
        body = []
        for pname, (ptype, vals) in params.items():
            v = " ".join(str(x) for x in vals)
            body.append(f'{pad}    "{ptype} {pname}" [ {v} ]')
        lines.append(pad + head)
        lines.extend(body)
        if direc in _BLOCK_OPEN:
            indent += 1
    return "\n".join(lines) + "\n"
