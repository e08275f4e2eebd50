"""The port's MLT integrator (models/integrators/mlt.py) and its seams
against the JAX package's: path.VectorSource, the staged volpath.li with a
uniform_source, and the target functions _eval_F and _eval_F_vol on the
same primary-sample vectors (and free-flight seeds).  The chains draw from
a torch.Generator where the reference draws from jax.random, so render_mlt
and render_mlt_vol are held by the reference's own statistical gates
(tests/test_mlt.py): the mean within 15% of the forward render and the
pixel-luminance correlation above 0.8 on the surface scene, the mean
within 15% and the 60th-percentile overlap above 0.5 on the fog box.

Tolerances: the VectorSource draws exactly; li and the targets run outside
jit on both sides, radiance and rgb to rtol 1e-4 / atol 1e-6 and the
pixels equal on at least 98% of the lanes (an ulp may flip a collision or
a lobe).
"""
import jax.numpy as jnp
import numpy as np
import torch

from acceleratedvolrenderer_tpu.models import cameras as jcam
from acceleratedvolrenderer_tpu.models import lights as jl
from acceleratedvolrenderer_tpu.models import materials as jm
from acceleratedvolrenderer_tpu.models import shapes as js
from acceleratedvolrenderer_tpu.models.film import BoxFilter
from acceleratedvolrenderer_tpu.models.integrators import mlt as jmlt
from acceleratedvolrenderer_tpu.models.integrators import path as jpath
from acceleratedvolrenderer_tpu.models.integrators import volpath as jvolpath
from acceleratedvolrenderer_tpu.models.media import homogeneous_box
from acceleratedvolrenderer_tpu.ops import dda as jdda
from acceleratedvolrenderer_tpu.scene import Scene as JScene
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu.utils import vecmath as jvm
from acceleratedvolrenderer_tpu_torch.models.integrators import mlt as tmlt
from acceleratedvolrenderer_tpu_torch.models.integrators import path as tpath
from acceleratedvolrenderer_tpu_torch.models.integrators import (
    volpath as tvolpath)
from acceleratedvolrenderer_tpu_torch.ops import dda as tdda
from acceleratedvolrenderer_tpu_torch.parallel import render as trender
from acceleratedvolrenderer_tpu_torch.scene import convert

from torch_surface_util import surface_arrays_from_jax_scene

torch.set_num_threads(2)

flat = jsp.constant_spectrum
N = 256
LUM = np.array([0.2126, 0.7152, 0.0722])


def _surface_scene(res=10, spp=256, integrator="path"):
    """tests/test_mlt.py::test_mlt_matches_path's floor, ball and lamp."""
    floor = js.Quad(origin=np.array([-4.0, 0.0, -4.0]),
                    e1=np.array([8.0, 0.0, 0.0]), e2=np.array([0.0, 0.0, 8.0]),
                    material=jm.DiffuseMaterial(reflectance=flat(0.6)))
    ball = js.Sphere(center=np.array([0.0, 0.7, 0.5]), radius=0.7,
                     material=jm.DiffuseMaterial(reflectance=flat(0.4)))
    lamp = js.Quad(origin=np.array([-1.0, 3.0, -0.5]),
                   e1=np.array([2.0, 0.0, 0.0]), e2=np.array([0.0, 0.0, 2.0]),
                   material=jm.DiffuseMaterial(reflectance=flat(0.0),
                                               emission=flat(6.0)))
    cam = jcam.PerspectiveCamera(
        c2w=jvm.look_at((0, 2.0, -5), (0, 0.5, 1), (0, 1, 0)), fov_deg=55.0,
        width=res, height=res)
    return JScene(camera=cam, medium=None, lights=[],
                  primitives=[floor, ball, lamp], max_depth=4,
                  filter=BoxFilter(), spp=spp, scene_radius=50.0,
                  integrator=integrator)


def _fog_scene(res=10, spp=64):
    """tests/test_mlt.py's volumetric fog box."""
    med = homogeneous_box(flat(0.1), flat(0.9), lo=(0, 0, 0), hi=(1, 1, 1),
                          g=0.3)
    cam = jcam.PerspectiveCamera(
        c2w=jvm.look_at((0.5, 0.5, -3.0), (0.5, 0.5, 0.5), (0, 1, 0)),
        fov_deg=30.0, width=res, height=res)
    return JScene(camera=cam, medium=med,
                  lights=[jl.DistantLight(direction=np.array([0.0, -1.0, 0.0]),
                                          spectrum=flat(5.0),
                                          scene_radius=10.0)],
                  max_depth=3, filter=BoxFilter(), spp=spp, scene_radius=10.0)


def _port(jscene):
    return convert.scene_from_arrays(surface_arrays_from_jax_scene(jscene),
                                     "cpu")


def test_vector_source_matches_jax():
    u = np.random.default_rng(0).random((8, 5)).astype(np.float32)
    js_, ts_ = jpath.VectorSource(jnp.asarray(u)), tpath.VectorSource(
        torch.as_tensor(u))
    mask = torch.zeros(8, dtype=torch.bool)
    for _ in range(7):          # past the last column it repeats it
        np.testing.assert_array_equal(ts_.next(mask).numpy(),
                                      np.asarray(js_.next()))
    assert ts_.idx == js_.idx == 7


def _u_vec(d, n=N, seed=1):
    return np.random.default_rng(seed).random((n, d)).astype(np.float32)


def test_volpath_li_uniform_source_matches_jax():
    jscene = _fog_scene()
    tscene = _port(jscene)
    rng = np.random.default_rng(2)
    o = np.tile(np.array([[0.5, 0.5, -3.0]], np.float32), (N, 1))
    aim = rng.uniform(0.1, 0.9, (N, 3))
    d = aim - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    lam = rng.uniform(380, 720, (N, 4)).astype(np.float32)
    depth = jscene.max_depth
    u = _u_vec(5 * (depth + 1))
    idx = np.arange(N)
    kw = dict(maj_res=(1, 1, 1), homogeneous=True, max_depth=depth,
              scene_radius=10.0)
    want = jvolpath.li(
        jscene.medium.build_arrays(jnp.asarray(lam)), jscene.lights,
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(lam),
        jdda.seed_stream(jnp.asarray(idx), jnp.zeros(N, jnp.int32)),
        uniform_source=jpath.VectorSource(jnp.asarray(u)), **kw)
    src = tpath.VectorSource(torch.as_tensor(u))
    got = tvolpath.li(
        tscene.medium.build_arrays(torch.as_tensor(lam)), tscene.lights,
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(lam),
        tdda.seed_stream(torch.as_tensor(idx),
                         torch.zeros(N, dtype=torch.int64)),
        uniform_source=src, **kw)
    # every bounce ran, whatever the lanes did: 5 draws per bounce
    assert src.idx == 5 * (depth + 1)
    jL = np.asarray(want.L)
    ok = np.isclose(got.L.numpy(), jL, rtol=1e-4, atol=1e-6).all(-1)
    ok &= np.asarray(want.rng).astype(np.int64) == got.rng.numpy()
    assert ok.mean() >= 0.98, ok.mean()
    assert (jL > 0).any(-1).mean() > 0.3


def _compare_F(got, want, lit):
    (tpix, trgb, tlum), (jpix, jrgb, jlum) = got, want
    ok = (tpix.numpy() == np.asarray(jpix)).all(-1)
    assert ok.mean() == 1.0                # the film position is exact
    ok &= np.isclose(trgb.numpy(), np.asarray(jrgb), rtol=1e-4,
                     atol=1e-6).all(-1)
    ok &= np.isclose(tlum.numpy(), np.asarray(jlum), rtol=1e-4, atol=1e-6)
    assert ok.mean() >= 0.98, ok.mean()
    assert (np.asarray(jlum) > 0).mean() > lit


def test_eval_F_matches_jax():
    jscene = _surface_scene()
    tscene = _port(jscene)
    u = _u_vec(jmlt._dims_for_depth(jscene.max_depth))
    assert tmlt._dims_for_depth(4) == jmlt._dims_for_depth(4) == 38
    jprims = tuple(jscene.primitives)
    _compare_F(tmlt._eval_F(torch.as_tensor(u), tscene,
                            tuple(tscene.primitives), tscene.lights),
               jmlt._eval_F(jnp.asarray(u), jscene, jprims, jscene.lights),
               lit=0.2)


def test_eval_F_vol_matches_jax():
    jscene = _fog_scene()
    tscene = _port(jscene)
    u = _u_vec(jmlt._dims_for_depth_vol(jscene.max_depth))
    assert tmlt._dims_for_depth_vol(3) == jmlt._dims_for_depth_vol(3) == 23
    seeds = np.random.default_rng(4).integers(0, 1 << 32, N, np.uint64)
    _compare_F(tmlt._eval_F_vol(torch.as_tensor(u),
                                torch.as_tensor(seeds.astype(np.int64)),
                                tscene),
               jmlt._eval_F_vol(jnp.asarray(u),
                                jnp.asarray(seeds.astype(np.uint32)),
                                jscene), lit=0.1)


def test_render_mlt_matches_path():
    """test_mlt.py::test_mlt_matches_path's gates on the port, at its
    size: the means within 15%, the luminance correlation above 0.8."""
    jscene = _surface_scene()
    img_f, _ = trender.render(_port(jscene), device="cpu")
    img_m, stats = tmlt.render_mlt(_port(jscene), n_chains=2048,
                                   n_mutations=48, n_bootstrap=4096, seed=3,
                                   device="cpu")
    assert stats["b"] > 0 and stats["mutations"] == 2048 * 48
    assert np.isfinite(img_m).all()
    a, b = (img_f @ LUM).mean(), (img_m @ LUM).mean()
    assert abs(a - b) / max(a, 1e-9) < 0.15, (a, b)
    corr = np.corrcoef((img_f @ LUM).reshape(-1),
                       (img_m @ LUM).reshape(-1))[0, 1]
    assert corr > 0.8, corr


def test_render_mlt_vol_converges_to_volpath():
    """test_mlt.py::test_mlt_volumetric_converges_to_volpath's gates on the
    port: render_mlt dispatches on the medium."""
    jscene = _fog_scene()
    img_m, stats = tmlt.render_mlt(_port(jscene), n_chains=2048,
                                   n_mutations=48, n_bootstrap=8192, seed=3,
                                   device="cpu")
    img_r, _ = trender.render(_port(jscene), device="cpu")
    assert stats["b"] > 0
    m_mlt, m_ref = (img_m @ LUM).mean(), (img_r @ LUM).mean()
    assert m_ref > 0 and m_mlt > 0
    assert abs(m_mlt - m_ref) / m_ref < 0.15, (m_mlt, m_ref)
    bm = (img_m @ LUM) > np.percentile(img_m @ LUM, 60)
    br = (img_r @ LUM) > np.percentile(img_r @ LUM, 60)
    assert (bm & br).sum() / max(br.sum(), 1) > 0.5


def test_render_mlt_same_seed_same_image():
    """The chain's numbers come from a generator seeded with `seed`: two
    runs give the same image, another seed another."""
    tscene = _port(_surface_scene(res=6))
    kw = dict(n_chains=256, n_mutations=4, n_bootstrap=512, device="cpu")
    a, _ = tmlt.render_mlt(tscene, seed=1, **kw)
    b, _ = tmlt.render_mlt(tscene, seed=1, **kw)
    c, _ = tmlt.render_mlt(tscene, seed=2, **kw)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_render_mlt_dark_scene():
    jscene = _surface_scene(res=4)
    jscene.primitives = jscene.primitives[:2]    # no lamp
    img, stats = tmlt.render_mlt(_port(jscene), n_chains=64, n_mutations=2,
                                 n_bootstrap=128, device="cpu")
    assert stats == {"b": 0.0} and not img.any() and img.shape == (4, 4, 3)
