"""The port's building blocks against the JAX package's, on identical
inputs made with numpy from a seed.  Tolerance rtol 1e-6 / atol 1e-6: the
same float32 formulas, with op order and transcendental implementations
(exp, atanh, cosh, erfinv) differing by a few ulps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import film as jfilm
from acceleratedvolrenderer_tpu.models import lights as jlights
from acceleratedvolrenderer_tpu.models import media as jmedia
from acceleratedvolrenderer_tpu.ops import dda as jdda
from acceleratedvolrenderer_tpu.ops import grid as jgrid
from acceleratedvolrenderer_tpu.ops import phase as jphase
from acceleratedvolrenderer_tpu.scene import presets as jpresets
from acceleratedvolrenderer_tpu.utils import colorspace as jcs
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu.utils import vecmath as jvm
from acceleratedvolrenderer_tpu_torch.models import film as tfilm
from acceleratedvolrenderer_tpu_torch.models import lights as tlights
from acceleratedvolrenderer_tpu_torch.models import media as tmedia
from acceleratedvolrenderer_tpu_torch.ops import dda as tdda
from acceleratedvolrenderer_tpu_torch.ops import grid as tgrid
from acceleratedvolrenderer_tpu_torch.ops import phase as tphase
from acceleratedvolrenderer_tpu_torch.scene import convert
from acceleratedvolrenderer_tpu_torch.utils import colorspace as tcs
from acceleratedvolrenderer_tpu_torch.utils import spectrum as tsp
from acceleratedvolrenderer_tpu_torch.utils import vecmath as tvm

from torch_port_util import arrays_from_jax_scene

torch.set_num_threads(2)

N = 4096
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def scenes():
    js = jpresets.cloud(64, 36, spp=2, max_depth=8, grid_res=8)
    return js, convert.scene_from_arrays(arrays_from_jax_scene(js), "cpu")


def _t(a):
    return torch.tensor(np.array(a))


def _close(j, t):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_world_to_medium_and_dda_init(scenes):
    js, _ = scenes
    w2m = np.asarray(js.medium.world_to_unit(), np.float32)
    rng = np.random.default_rng(0)
    o = rng.uniform(-300, 300, (N, 3)).astype(np.float32)
    d = _unit(rng, N)
    d[:32, 1:] = 0.0                       # axis-parallel rays
    d[:32, 0] = 1.0
    t_max = np.where(rng.random(N) < 0.5, np.inf,
                     rng.uniform(10, 500, N)).astype(np.float32)
    _close(jdda.world_to_medium(jnp.asarray(w2m), jnp.asarray(o)),
           tdda.world_to_medium(_t(w2m), _t(o)))
    for res in [(16, 16, 16), (32, 16, 8)]:
        jst, jt0 = jdda.dda_init(jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(t_max), jnp.asarray(w2m), res)
        tst, tt0 = tdda.dda_init(_t(o), _t(d), _t(t_max), _t(w2m), res)
        assert tst.in_medium.any() and not tst.in_medium.all()
        for name in ("voxel", "step", "in_medium"):
            assert np.array_equal(np.asarray(getattr(jst, name)),
                                  getattr(tst, name).numpy()), name
        for name in ("next_t", "dt", "t_exit"):
            _close(getattr(jst, name), getattr(tst, name))
        _close(jt0, tt0)


def test_look_at_transform_and_aabb():
    rng = np.random.default_rng(6)
    eye, look = rng.uniform(-50, 50, 3), rng.uniform(-50, 50, 3)
    jt = jvm.look_at(eye, look, (0.0, 1.0, 0.0))
    tt = tvm.look_at(eye, look, (0.0, 1.0, 0.0), "cpu")
    assert np.array_equal(np.asarray(jt.m), tt.m.numpy())
    assert np.array_equal(np.asarray(jt.m_inv), tt.m_inv.numpy())
    p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    _close(jt.apply_point(jnp.asarray(p)), tt.apply_point(_t(p)))
    _close(jvm.normalize(jt.apply_vector(jnp.asarray(p))),
           tvm.normalize(tt.apply_vector(_t(p))))
    d = _unit(rng, N)
    d[:16, :2] = 0.0                       # axis-parallel rays: inf slabs
    d[:16, 2] = 1.0
    t_max = rng.uniform(0.5, 5.0, N).astype(np.float32)
    lo, hi = (-0.5, -1.0, 0.0), (1.0, 0.5, 2.0)
    jh = jvm.intersect_aabb(jnp.asarray(p), jnp.asarray(d),
                            jnp.asarray(t_max), jnp.float32(lo),
                            jnp.float32(hi))
    th = tvm.intersect_aabb(_t(p), _t(d), _t(t_max), lo, hi)
    assert np.array_equal(np.asarray(jh[0]), th[0].numpy())
    assert th[0].any() and not th[0].all()
    _close(jh[1], th[1])
    _close(jh[2], th[2])


def test_grids_bake_and_majorant_exact():
    jd = jmedia.bake_cloud_density(res=(32, 32, 32), density=1.0,
                                   extent=0.48, frequency=6.0)
    td = tmedia.bake_cloud_density(res=(32, 32, 32), density=1.0,
                                   extent=0.48, frequency=6.0)
    assert td.dtype == np.float32 and np.array_equal(jd, td)
    for res in [(16, 16, 16), (8, 4, 2)]:
        assert np.array_equal(jgrid.build_majorant_grid(jd, res),
                              tgrid.build_majorant_grid(td, res))


@pytest.mark.parametrize("res, kw", [
    ((9, 13, 11), dict(density=2.0, extent=0.45, frequency=4.0, seed=3)),
    ((21, 7, 33), dict(wispiness=0.7, frequency=5.0, seed=1)),
])
def test_bake_slabs_equal_reference(res, kw):
    """The port bakes in slabs of BAKE_SLAB z-planes on threads; a depth
    that is no multiple of it and uneven sides keep the reference's bits."""
    assert res[2] % tmedia.BAKE_SLAB
    jd = jmedia.bake_cloud_density(res=res, **kw)
    td = tmedia.bake_cloud_density(res=res, **kw)
    assert td.shape == (res[2], res[1], res[0]) and np.array_equal(jd, td)


def test_trilerp_stochastic_and_flat():
    rng = np.random.default_rng(1)
    dims = (12, 10, 8)
    grid = rng.random(dims).astype(np.float32)
    p = rng.uniform(-0.1, 1.1, (N, 3)).astype(np.float32)
    u3 = rng.random((N, 3)).astype(np.float32)
    gf = grid.reshape(-1)
    j = jgrid.trilerp_stochastic_flat(jnp.asarray(gf), dims, jnp.asarray(p),
                                      jnp.asarray(u3))
    t = tgrid.trilerp_stochastic_flat(_t(gf), dims, _t(p), _t(u3))
    assert np.array_equal(np.asarray(j), t.numpy())
    jf, ji = jgrid.stochastic_corner(dims, jnp.asarray(p), jnp.asarray(u3))
    tf, ti = tgrid.stochastic_corner(dims, _t(p), _t(u3))
    assert np.array_equal(np.asarray(jf), tf.numpy())
    assert np.array_equal(np.asarray(ji), ti.numpy())
    _close(jgrid.trilerp_flat(jnp.asarray(gf), dims, jnp.asarray(p)),
           tgrid.trilerp_flat(_t(gf), dims, _t(p)))


@pytest.mark.parametrize("g", [0.877, 0.0, -0.3])
def test_hg_phase_and_sample(g):
    rng = np.random.default_rng(2)
    wo, wi = _unit(rng, N), _unit(rng, N)
    u = rng.random((N, 2)).astype(np.float32)
    jg, tg = jnp.float32(g), torch.tensor(g, dtype=torch.float32)
    _close(jphase.hg_phase(jnp.asarray(wo), jnp.asarray(wi), jg),
           tphase.hg_phase(_t(wo), _t(wi), tg))
    jw, jp = jphase.sample_hg(jnp.asarray(wo), jnp.asarray(u), jg)
    tw, tp = tphase.sample_hg(_t(wo), _t(u), tg)
    _close(jw, tw)
    # the pdf formula on identical inputs: the cosine of the direction JAX
    # sampled.  Near the peak at g = 0.877 one ulp of cos(theta) moves the
    # pdf by ~100 ulps, so each sampler's pdf of its own cosine may differ.
    cos = np.sum(wo * np.asarray(jw), -1, dtype=np.float32)
    _close(jphase.hg_p(jnp.asarray(cos), jg), tphase.hg_p(_t(cos), tg))
    assert torch.isfinite(tp).all() and (tp > 0).all()


def test_wavelengths_and_xyz_to_rgb():
    rng = np.random.default_rng(3)
    u = rng.random(N).astype(np.float32)
    jw = jsp.sample_wavelengths_visible(jnp.asarray(u))
    tw = tsp.sample_wavelengths_visible(_t(u))
    _close(jw.lam, tw.lam)
    _close(jw.pdf, tw.pdf)
    L = rng.exponential(1.0, (N, 4)).astype(np.float32)
    # the same wavelengths on both sides isolate the XYZ / RGB formulas
    lam, pdf = np.asarray(jw.lam), np.asarray(jw.pdf)
    jx = jsp.to_xyz(jnp.asarray(L), jsp.SampledWavelengths(jnp.asarray(lam),
                                                           jnp.asarray(pdf)))
    tx = tsp.to_xyz(_t(L), tsp.SampledWavelengths(_t(lam), _t(pdf)))
    _close(jx, tx)
    _close(jcs.xyz_to_rgb(jx), tcs.xyz_to_rgb(tx))


def test_camera_rays_and_filter(scenes):
    js, ts = scenes
    rng = np.random.default_rng(4)
    pix = np.stack([rng.integers(0, js.width, N),
                    rng.integers(0, js.height, N)], -1).astype(np.int32)
    u = rng.random((N, 2)).astype(np.float32)
    joff = jfilm.GaussianFilter().sample_offset(jnp.asarray(u))
    toff = tfilm.GaussianFilter().sample_offset(_t(u))
    _close(joff, toff)
    off = np.asarray(joff) + 0.5
    jo, jd = js.camera.generate_rays(jnp.asarray(pix), jnp.asarray(off))
    to, td = ts.camera.generate_rays(_t(pix), _t(off))
    _close(jo, to)
    _close(jd, td)


def test_lights_sample_and_escape(scenes):
    js, ts = scenes
    rng = np.random.default_rng(5)
    p = rng.uniform(-100, 100, (N, 3)).astype(np.float32)
    d = _unit(rng, N)
    u1 = rng.random(N).astype(np.float32)
    u2 = rng.random((N, 2)).astype(np.float32)
    lam = np.asarray(jsp.sample_wavelengths_visible(
        jnp.asarray(rng.random(N).astype(np.float32))).lam)
    for jl, tl in zip(js.lights, ts.lights):
        a = jl.sample_li(jnp.asarray(p), jnp.asarray(u2), jnp.asarray(lam))
        b = tl.sample_li(_t(p), _t(u2), _t(lam))
        for x, y in zip(a, b):
            _close(x, y)
    jls, jdel = jlights.sample_one_light(js.lights, jnp.asarray(p),
                                         jnp.asarray(u1), jnp.asarray(u2),
                                         jnp.asarray(lam))
    tls, tdel = tlights.sample_one_light(ts.lights, _t(p), _t(u1), _t(u2),
                                         _t(lam))
    for x, y in zip(jls, tls):
        _close(x, y)
    assert np.array_equal(np.asarray(jdel), tdel.numpy())
    assert 0 < tdel.float().mean() < 1
    jL, jpdf = jlights.escaped_radiance(js.lights, jnp.asarray(d),
                                        jnp.asarray(lam))
    tL, tpdf = tlights.escaped_radiance(ts.lights, _t(d), _t(lam))
    _close(jL, tL)
    _close(jpdf, tpdf)
