"""The port's surface layer against the JAX package's: shapes
(models/shapes.py, with ops/trigrid.py for meshes at or above
grid_threshold), textures, materials, lights and light samplers, on inputs
made from a numpy seed; and the scenes of chip_smoke.py's surface phases.

Tolerance: elementwise, floats to rtol 1e-4 / atol 1e-5 (float32 sqrt,
atan2 and acos differ by ulps between XLA:CPU and torch); hit / miss and
every integer and flag equal on at least 99.5% of the rays (a grazing ray
flips on an ulp).  The fused integrator's surface branch is held to the
JAX package in tests/test_torch_fused_surfaces.py.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import lights as jl
from acceleratedvolrenderer_tpu.models import materials as jm
from acceleratedvolrenderer_tpu.models import shapes as js
from acceleratedvolrenderer_tpu.models import textures as jt
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu_torch.models import lights as tl
from acceleratedvolrenderer_tpu_torch.models import materials as tm
from acceleratedvolrenderer_tpu_torch.models import samplers as tsamplers
from acceleratedvolrenderer_tpu_torch.models import shapes as ts
from acceleratedvolrenderer_tpu_torch.models import textures as tt
from acceleratedvolrenderer_tpu_torch.scene import convert
from acceleratedvolrenderer_tpu_torch.scene import presets as tpresets

from torch_surface_util import _plain_light, plain

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

flat = jsp.constant_spectrum
N = 2048


def _port(obj):
    return convert.object_from(plain(obj), "cpu")


def _close(got, want, rtol=1e-4, atol=1e-5, flips=0.005):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == bool or want.dtype.kind in "iu":
        ok = got == want
    else:
        ok = np.isclose(got, want, rtol=rtol, atol=atol, equal_nan=True)
    lanes = ok.reshape(ok.shape[0], -1).all(-1)
    assert lanes.mean() >= 1.0 - flips, (lanes.mean(), got[~lanes][:3],
                                         want[~lanes][:3])


def _rays(seed, n=N, target=(0.0, 0.0, 0.0), spread=1.5, dist=4.0):
    """Rays from a sphere of radius `dist` around target toward points
    within `spread` of it."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * dist + target
    aim = np.asarray(target) + rng.uniform(-spread, spread, (n, 3))
    d = aim - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _mesh(n_theta, n_phi):
    """A closed unit UV-sphere mesh of 2 * n_phi * (n_theta - 1) triangles
    (chip_smoke.py's, at the origin)."""
    return chip_smoke.uv_sphere_mesh(n_theta, n_phi, 1.0, (0.0, 0.0, 0.0))


def _diffuse(c=0.5):
    return jm.DiffuseMaterial(reflectance=flat(c))


V_SMALL, I_SMALL = _mesh(6, 8)
V_BIG, I_BIG = _mesh(20, 24)
assert len(I_SMALL) < 512 <= len(I_BIG)

SHAPES = {
    "sphere": js.Sphere(center=np.array([0.2, -0.1, 0.3]), radius=0.9,
                        material=_diffuse()),
    "quad": js.Quad(origin=np.array([-1.0, -1.0, 0.2]),
                    e1=np.array([2.0, 0.3, 0.0]),
                    e2=np.array([0.1, 1.8, 0.4]), material=_diffuse()),
    "disk": js.Disk(center=np.array([0.1, 0.0, 0.0]),
                    normal=np.array([0.3, 0.2, 1.0]), radius=1.2,
                    inner_radius=0.3, material=_diffuse()),
    "cylinder": js.Cylinder(p0=np.array([0.0, -1.0, 0.0]),
                            p1=np.array([0.2, 1.0, 0.1]), radius=0.6,
                            material=_diffuse()),
    "box": js.Box(lo=np.array([-0.8, -0.5, -0.6]),
                  hi=np.array([0.7, 0.9, 0.5]), material=_diffuse()),
    "mesh": js.TriangleMesh(vertices=V_SMALL, indices=I_SMALL,
                            material=_diffuse()),
    "mesh_grid": js.TriangleMesh(
        vertices=V_BIG, indices=I_BIG, material=_diffuse(),
        uvs=np.random.default_rng(2).random((len(V_BIG), 2))
        .astype(np.float32)),
    "bilinear": js.BilinearPatch(
        p00=np.array([-1.0, -1.0, 0.0]), p10=np.array([1.0, -1.0, 0.5]),
        p01=np.array([-1.0, 1.0, 0.4]), p11=np.array([1.0, 1.0, -0.2]),
        material=_diffuse()),
    "curve": js.Curve(cp=np.array([[-1.0, 0, 0], [-0.3, 0.8, 0.1],
                                   [0.3, -0.8, 0], [1.0, 0.1, 0.2]]),
                      width0=0.5, width1=0.3, material=_diffuse()),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_shape_matches_jax(name):
    """intersect (t, normal and uv where hit), sample and area."""
    jshape = SHAPES[name]
    tshape = _port(jshape)
    o, d = _rays(sorted(SHAPES).index(name))
    t_max = np.where(np.arange(N) % 5 == 0, 2.5, np.inf).astype(np.float32)
    jt_, jn, juv = jshape.intersect(jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(t_max))
    tt_, tn, tuv = tshape.intersect(torch.as_tensor(o), torch.as_tensor(d),
                                    torch.as_tensor(t_max))
    jt_, tt_ = np.asarray(jt_), tt_.numpy()
    hit = np.isfinite(jt_)
    assert 0.05 < hit.mean() < 1.0, hit.mean()
    _close(np.isfinite(tt_), hit)
    both = hit & np.isfinite(tt_)
    _close(tt_[both], jt_[both])
    _close(tn.numpy()[both], np.asarray(jn)[both])
    # uv of a sphere / cylinder wraps at phi = +-pi: compare on the circle
    du = np.abs(tuv.numpy()[both] - np.asarray(juv)[both])
    du = np.minimum(du, np.abs(1.0 - du))
    assert (du < 1e-3).all(-1).mean() >= 0.995
    u2 = np.random.default_rng(7).random((N, 2), dtype=np.float32)
    for a, b in zip(tshape.sample(torch.as_tensor(u2)),
                    jshape.sample(jnp.asarray(u2))):
        _close(a, b)
    assert tshape.area() == pytest.approx(jshape.area(), rel=1e-12)


def test_intersect_all_and_occluded():
    """The closest hit over a primitive list with a medium interface
    (material None: invisible to occluded) and occlusion at finite
    distances."""
    prims = [SHAPES["sphere"], SHAPES["box"], SHAPES["quad"],
             js.Sphere(center=np.zeros(3), radius=1.5, material=None),
             SHAPES["mesh_grid"]]
    tprims = [_port(p) for p in prims]
    o, d = _rays(5)
    jo, jd, to, td = jnp.asarray(o), jnp.asarray(d), torch.as_tensor(o), \
        torch.as_tensor(d)
    jh = js.intersect_all(prims, jo, jd, jnp.inf)
    th = ts.intersect_all(tprims, to, td, torch.inf)
    _close(th.prim_id.numpy().astype(np.int32), np.asarray(jh.prim_id))
    same = th.prim_id.numpy() == np.asarray(jh.prim_id)
    fin = same & np.isfinite(np.asarray(jh.t))
    _close(th.t.numpy()[fin], np.asarray(jh.t)[fin])
    _close(th.n.numpy()[fin], np.asarray(jh.n)[fin])
    dist = np.random.default_rng(9).uniform(0.5, 6.0, N).astype(np.float32)
    want = np.asarray(js.occluded(prims, jo, jd, jnp.asarray(dist)))
    got = ts.occluded(tprims, to, td, torch.as_tensor(dist)).numpy()
    assert 0.1 < want.mean() < 0.95
    _close(got, want)


TEXTURES = {
    "constant": jt.ConstantTexture(0.3),
    "rgb": jt.ConstantRGBTexture((0.2, 0.5, 0.9)),
    "scale": jt.ScaleTexture(jt.UVTexture(), 0.7),
    "checker": jt.CheckerboardTexture(jt.ConstantTexture(0.1),
                                      jt.ConstantTexture(0.9), 4.0, 3.0),
    "mix": jt.MixTexture(jt.UVTexture(), jt.ConstantRGBTexture((1, 0, 0)),
                         0.3),
    "image": jt.ImageTexture(np.random.default_rng(4).random(
        (5, 7, 3)).astype(np.float32), scale=0.8, invert=True),
    "image_gray": jt.ImageTexture(np.random.default_rng(5).random(
        (4, 6)).astype(np.float32)),
    "fbm": jt.FBmTexture(octaves=4),
    "wrinkled": jt.WrinkledTexture(),
    "windy": jt.WindyTexture(),
    "marble": jt.MarbleTexture(),
    "dots": jt.DotsTexture(),
    "bilerp": jt.BilerpTexture(0.1, 0.4, 0.7, 0.2),
    "uv_map": jt.MappedTexture(jt.UVTexture(), jt.UVMapping(2.0, 3.0, 0.1,
                                                             0.2)),
    "spherical": jt.MappedTexture(jt.UVTexture(), jt.SphericalMapping()),
    "cylindrical": jt.MappedTexture(
        jt.FBmTexture(), jt.CylindricalMapping(
            texture_from_render=tuple(map(tuple, np.eye(4) * 2)))),
    "planar": jt.MappedTexture(jt.UVTexture(), jt.PlanarMapping(
        vs=(1.0, 0.5, 0.0), vt=(0.0, 0.3, 1.0), ds=0.1)),
    "point3d": jt.MappedTexture(jt.UVTexture(), jt.PointTransformMapping()),
    "direction_mix": jt.DirectionMixTexture(
        jt.ConstantRGBTexture((1.0, 0.5, 0.2)), jt.UVTexture(),
        dir=(0.2, 1.0, 0.1)),
    "checker3d": jt.Checkerboard3DTexture(jt.ConstantTexture(0.2),
                                          jt.ConstantTexture(0.8)),
}


@pytest.mark.parametrize("name", sorted(TEXTURES))
def test_texture_matches_jax(name):
    tex = TEXTURES[name]
    ttex = _port(tex)
    rng = np.random.default_rng(12)
    uv = rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    p = rng.normal(size=(N, 3)).astype(np.float32) * 2
    n = rng.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    want = jt.eval_texture(tex, jnp.asarray(uv), p=jnp.asarray(p),
                           n=jnp.asarray(n))
    got = tt.eval_texture(ttex, torch.as_tensor(uv), p=torch.as_tensor(p),
                          n=torch.as_tensor(n))
    _close(got, np.asarray(want, np.float32), atol=1e-4)


def test_materials_eval_matches_jax():
    """_eval_spectral / _eval_float on numbers, spectra, rgb and float
    textures, with a hit uv and without one (the fused integrator's
    constant table, which evaluates a texture at uv 0.5: a difference from
    pbrt-v4, kept as the reference has it)."""
    rng = np.random.default_rng(3)
    lam = rng.uniform(380, 720, (N, 4)).astype(np.float32)
    uv = rng.random((N, 2), dtype=np.float32)
    values = [None, 0.4, flat(0.7), jsp.blackbody_normalized(4000.0),
              TEXTURES["marble"], TEXTURES["checker"]]
    for v in values:
        tv_ = (convert.spectrum_from(plain(v)) if callable(v)
               and not hasattr(v, "eval") else _port(v))
        for u in (None, uv):
            want = jm._eval_spectral(v, jnp.asarray(lam),
                                     None if u is None else jnp.asarray(u))
            got = tm._eval_spectral(tv_, torch.as_tensor(lam),
                                    None if u is None else torch.as_tensor(u))
            _close(got, want)
    half = tm._eval_spectral(_port(TEXTURES["marble"]),
                             torch.as_tensor(lam))
    at_half = tm._eval_spectral(_port(TEXTURES["marble"]),
                                torch.as_tensor(lam),
                                torch.full((N, 2), 0.5))
    assert torch.equal(half, at_half)
    for v in (0.25, TEXTURES["fbm"], TEXTURES["rgb"]):
        want = jm._eval_float(v, jnp.asarray(uv), (N,))
        got = tm._eval_float(_port(v), torch.as_tensor(uv), (N,))
        _close(got, want)


def _light_list():
    quad = js.Quad(origin=np.array([-0.5, 2.0, -0.5]),
                   e1=np.array([0.0, 0.0, 1.0]), e2=np.array([1.0, 0.0, 0.0]))
    sph = js.Sphere(center=np.array([1.5, 0.5, 1.0]), radius=0.3)
    return [
        jl.DistantLight(direction=np.array([0.3, -1.0, 0.2]) / 1.06,
                        spectrum=flat(2.0), scene_radius=20.0),
        jl.PointLight(position=np.array([0.0, 1.5, 0.5]), spectrum=flat(3.0)),
        jl.SpotLight(position=np.array([-1.0, 1.0, 0.0]),
                     direction=np.array([0.5, -1.0, 0.0]),
                     spectrum=flat(5.0), cone_angle_deg=35.0),
        jl.UniformInfiniteLight(spectrum=flat(0.2), scene_radius=20.0),
        jl.DiffuseAreaLight(shape=quad, spectrum=flat(4.0)),
        jl.DiffuseAreaLight(shape=sph, spectrum=flat(2.0), two_sided=True,
                            scale=0.5),
    ]


@pytest.mark.parametrize("strategy", ["uniform", "power", "bvh"])
def test_light_sampling_matches_jax(strategy):
    """Every light's sample_li, and sample_one_light / pdf_one_light /
    escaped_radiance over the list, by each light sampler."""
    jlights = _light_list()
    tlights = [convert.object_from(_plain_light(lt), "cpu") for lt in jlights]
    rng = np.random.default_rng(21)
    p = rng.uniform(-1.0, 1.0, (N, 3)).astype(np.float32)
    u1 = rng.random(N, dtype=np.float32)
    u2 = rng.random((N, 2), dtype=np.float32)
    lam = rng.uniform(380, 720, (N, 4)).astype(np.float32)
    wi = rng.normal(size=(N, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    j = [jnp.asarray(a) for a in (p, u1, u2, lam, wi)]
    t = [torch.as_tensor(a) for a in (p, u1, u2, lam, wi)]
    if strategy == "uniform":
        for jlt, tlt in zip(jlights, tlights):
            for a, b in zip(tlt.sample_li(t[0], t[2], t[3]),
                            jlt.sample_li(j[0], j[2], j[3])):
                _close(a, b)
            _close(tlt.pdf_li(t[0], t[4]), jlt.pdf_li(j[0], j[4]))
            _close(tlt.le_escaped(t[4], t[3]),
                   np.broadcast_to(jlt.le_escaped(j[4], j[3]), lam.shape))
        for a, b in zip(tl.escaped_radiance(tlights, t[4], t[3]),
                        jl.escaped_radiance(jlights, j[4], j[3])):
            _close(a, b)
    ls_t, delta_t = tl.sample_one_light(tlights, t[0], t[1], t[2], t[3],
                                        strategy)
    ls_j, delta_j = jl.sample_one_light(jlights, j[0], j[1], j[2], j[3],
                                        strategy)
    for a, b in zip(ls_t, ls_j):
        _close(a, b)
    _close(delta_t, delta_j)
    _close(tl.pdf_one_light(tlights, t[0], t[4], strategy),
           jl.pdf_one_light(jlights, j[0], j[4], strategy))
    if strategy == "bvh":
        _close(tl._adaptive_pmfs(tlights, t[0]),
               jl._adaptive_pmfs(jlights, j[0]), rtol=1e-5, atol=1e-7)


def test_filtered_texture_and_item_7_materials_raise(tmp_path):
    """What the port refused before it was ported (name kept): the
    filtered image texture (the MIP map) and the subsurface and measured
    materials now construct and equal the JAX objects.  Every sampler and
    light of the reference is ported."""
    from acceleratedvolrenderer_tpu.models import measured as jms
    from acceleratedvolrenderer_tpu_torch.models import measured as tms

    for kind in tsamplers.KINDS:
        tsamplers.film_sample(kind, torch.zeros(4, dtype=torch.int64),
                              torch.zeros(4, dtype=torch.int64), 4)
    tl.ImageInfiniteLight(np.ones((2, 4, 3), np.float32))
    img = np.random.default_rng(0).random((6, 10, 3)).astype(np.float32)
    tex = tt.ImageTexture(img, filtered=True, max_anisotropy=4.0)
    jtex = jt.ImageTexture(img, filtered=True, max_anisotropy=4.0)
    assert tex.mipmap.shapes == jtex.mipmap.shapes
    np.testing.assert_array_equal(tex.mipmap.flat, np.asarray(jtex.mipmap.flat))
    ss_kw = dict(reflectance_rgb=(0.8, 0.5, 0.3), mfp_rgb=(0.05, 0.1, 0.2),
                 eta=1.4, profile="tabulated", g=0.1)
    ss, jss = tm.SubsurfaceMaterial(**ss_kw), jm.SubsurfaceMaterial(**ss_kw)
    assert (ss.kind, ss.reflectance, ss.emissive) == (
        jss.kind, jss.reflectance, jss.emissive)
    fn = str(tmp_path / "g.bsdf")
    tms.write_tensor_file(fn, tms.tensors_of(tms.synthesize_ggx(res=8,
                                                                n_theta=2)))
    me = tm.MeasuredMaterial(brdf=tms.MeasuredBRDF.from_file(fn), filename=fn)
    jme = jm.MeasuredMaterial(brdf=jms.MeasuredBRDF.from_file(fn),
                              filename=fn)
    assert (me.kind, me.roughness, me.eta, me.filename, me.emissive) == (
        jme.kind, jme.roughness, jme.eta, jme.filename, jme.emissive)
    np.testing.assert_array_equal(me.brdf.vndf.data.reshape(-1),
                                  np.asarray(jme.brdf.vndf._vals).reshape(-1))


def test_chip_smoke_cloud_surfaces_in_view():
    """chip_smoke.py's phase A scene (the cloud with a ground quad, a rough
    conductor sphere and a glass sphere) at 64x36: each primitive is the
    first hit of at least 1% of the pixel-centre rays."""
    sc = chip_smoke.cloud_with_surfaces(
        tpresets.cloud(64, 36, spp=1, max_depth=4, grid_res=8,
                       device="cpu"))
    frac = chip_smoke.first_hit_fractions(sc)
    assert len(frac) == 3 and min(frac) >= 0.01, frac


def test_chip_smoke_room_in_view():
    """chip_smoke.py's phase B room at 64x36: every primitive is the first
    hit of at least 1% of the pixel-centre rays, and the mesh takes the
    grid route."""
    sc = chip_smoke.cornell_room(64, 36, spp=1, device="cpu")
    frac = chip_smoke.first_hit_fractions(sc)
    mesh = [p for p in sc.primitives if isinstance(p, ts.TriangleMesh)]
    assert len(mesh) == 1 and len(mesh[0].indices) >= mesh[0].grid_threshold
    assert min(frac) >= 0.01, frac
