"""The port's BDPT (models/integrators/bdpt.py) against the JAX package's:
_walk's Subpath on a thin fog box with a diffuse floor and a glass sphere
(camera and light walks, importance transport on the light side), the three
MIS weights on fixed random subpaths, render_bdpt at 6x6, max_depth 2,
spp 1 with its strategy films (with and without surfaces), and
write_strategy_films' file names.

Both walks run outside jit from the same rays, wavelengths and PCG
streams: every Subpath field to rtol 1e-4 / atol 1e-6 on at least 98% of
the lanes (an ulp may flip a collision or a lobe and reroute a lane).  The
MIS weights take the same tensors: rtol 1e-6.  render_bdpt runs the JAX
package's wave under jax.disable_jit (its jitted form takes minutes to
compile here): the image and every strategy film to rtol 1e-3 / atol 1e-5
on at least 97% of the pixels, the means to 1e-3 relative (2e-3 for a
strategy film holding a few splats).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import cameras as jcam
from acceleratedvolrenderer_tpu.models import lights as jl
from acceleratedvolrenderer_tpu.models import materials as jm
from acceleratedvolrenderer_tpu.models import shapes as js
from acceleratedvolrenderer_tpu.models.film import BoxFilter
from acceleratedvolrenderer_tpu.models.integrators import bdpt as jbdpt
from acceleratedvolrenderer_tpu.models.integrators import path as jpath
from acceleratedvolrenderer_tpu.models.media import homogeneous_box
from acceleratedvolrenderer_tpu.ops import dda as jdda
from acceleratedvolrenderer_tpu.scene import Scene as JScene
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu.utils import vecmath as jvm
from acceleratedvolrenderer_tpu_torch.models.integrators import bdpt as tbdpt
from acceleratedvolrenderer_tpu_torch.models.integrators import path as tpath
from acceleratedvolrenderer_tpu_torch.ops import dda as tdda
from acceleratedvolrenderer_tpu_torch.scene import convert

from torch_surface_util import surface_arrays_from_jax_scene

torch.set_num_threads(2)

flat = jsp.constant_spectrum
N = 256


def _scene(surfaces=True, ss=0.6, res=6):
    """tests/test_bdpt.py's fog box lit from above, with a diffuse floor
    under it and a glass sphere inside."""
    med = homogeneous_box(flat(0.1), flat(ss), lo=(0, 0, 0), hi=(1, 1, 1),
                          g=0.3)
    prims = []
    if surfaces:
        prims = [
            js.Quad(origin=np.array([-1.0, -0.05, -1.0]),
                    e1=np.array([0.0, 0.0, 3.0]), e2=np.array([3.0, 0.0, 0.0]),
                    material=jm.DiffuseMaterial(reflectance=flat(0.6))),
            js.Sphere(center=np.array([0.6, 0.4, 0.5]), radius=0.25,
                      material=jm.DielectricMaterial(eta=1.5)),
        ]
    cam = jcam.PerspectiveCamera(
        c2w=jvm.look_at((0.5, 0.9, -2.5), (0.5, 0.4, 0.5), (0, 1, 0)),
        fov_deg=35.0, width=res, height=res)
    return JScene(
        camera=cam, medium=med,
        lights=[jl.DistantLight(direction=np.array([0.3, -1.0, 0.2]) / 1.063,
                                spectrum=flat(5.0), scene_radius=10.0)],
        primitives=prims, max_depth=2, filter=BoxFilter(), spp=1,
        scene_radius=10.0, integrator="bdpt")


def _port(jscene):
    return convert.scene_from_arrays(surface_arrays_from_jax_scene(jscene),
                                     "cpu")


def _jax_mat(opaque, lam):
    """The JAX render_bdpt's mat_fn and mat_static (its l. 383-410)."""
    probe = jpath._gather_mat_params(opaque, lam[:1], jnp.zeros((1, 2)), 1)
    static = {"lam": lam, "measured": probe["_measured_tables"],
              "coated_stochastic": probe["_coated_stochastic"]}

    def mat_fn(hit, p):
        stacks = jpath._gather_mat_params(opaque, lam, hit.uv,
                                          hit.t.shape[0], p=p, n=hit.n)
        mid = jnp.clip(hit.prim_id, 0, len(opaque) - 1)
        prm = {k: jpath._take(v, mid) for k, v in stacks.items()
               if k not in ("kind", "emissive") and not k.startswith("_")}
        return jpath._take(stacks["kind"], mid), prm

    return mat_fn, static


def _tport_mat(opaque, lam):
    def mat_fn(hit, p):
        stacks = tpath._gather_mat_params(opaque, lam, hit.uv,
                                          hit.t.shape[0], p=p, n=hit.n)
        mid = torch.clamp(hit.prim_id, 0, len(opaque) - 1)
        prm = {k: tpath._take(v, mid) for k, v in stacks.items()
               if k not in ("kind", "emissive") and not k.startswith("_")}
        return tpath._take(stacks["kind"], mid), prm

    return mat_fn, {"coated_stochastic": False}


_FIELDS = ("p", "wi", "beta", "valid", "pdf_fwd", "pdf_rev", "is_surf", "n",
           "kind", "spec")


def _compare_subpaths(tsub, jsub):
    ok = np.ones(N, bool)
    for f in _FIELDS:
        a, b = getattr(tsub, f).numpy(), np.asarray(getattr(jsub, f))
        close = np.isclose(a, b.astype(a.dtype), rtol=1e-4, atol=1e-6)
        ok &= close.reshape(N, -1).all(-1)
    for key, v in jsub.prm.items():
        if key in tsub.prm:
            a = tsub.prm[key].numpy()
            ok &= np.isclose(a, np.asarray(v).astype(a.dtype), rtol=1e-4,
                             atol=1e-6).reshape(N, -1).all(-1)
    return ok


@pytest.mark.parametrize("side", ["camera", "light"])
def test_walk_matches_jax(side):
    jscene = _scene()
    tscene = _port(jscene)
    rng = np.random.default_rng(5)
    if side == "camera":
        o = np.tile(np.array([[0.5, 0.9, -2.5]], np.float32), (N, 1))
        aim = rng.uniform([0.0, -0.1, 0.0], [1.0, 1.0, 1.0], (N, 3))
    else:
        aim = rng.uniform([0.0, 0.0, 0.0], [1.0, 0.0, 1.0], (N, 3))
        o = (aim + np.array([-0.6, 2.0, -0.4])).astype(np.float32)
    d = aim - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    lam = rng.uniform(380, 720, (N, 4)).astype(np.float32)
    idx = np.arange(N)
    pdf0 = rng.uniform(0.5, 2.0, N).astype(np.float32)
    jlam = jnp.asarray(lam)
    tlam = torch.as_tensor(lam)
    jmed = jscene.medium.build_arrays(jlam)
    tmed = tscene.medium.build_arrays(tlam)
    jopq = tuple(jscene.primitives)
    topq = tuple(tscene.primitives)
    kw = dict(collect_emission=side == "camera", adjoint=side == "light",
              first_pdf_area=0.5 if side == "light" else None)
    jm_fn, jm_static = _jax_mat(jopq, jlam)
    tm_fn, tm_static = _tport_mat(topq, tlam)
    jsub, jrng, jLe = jbdpt._walk(
        jmed, jnp.asarray(o), jnp.asarray(d), jnp.ones((N, 4)),
        jdda.seed_stream(jnp.asarray(idx), jnp.zeros(N, jnp.int32), salt=9),
        3, (1, 1, 1), True, jnp.asarray(pdf0), prims=jopq, mat_fn=jm_fn,
        mat_static=jm_static, **kw)
    tsub, trng, tLe = tbdpt._walk(
        tmed, torch.as_tensor(o), torch.as_tensor(d), torch.ones((N, 4)),
        tdda.seed_stream(torch.as_tensor(idx),
                         torch.zeros(N, dtype=torch.int64), salt=9),
        3, (1, 1, 1), True, torch.as_tensor(pdf0), prims=topq,
        mat_fn=tm_fn, mat_static=tm_static, **kw)
    ok = _compare_subpaths(tsub, jsub)
    ok &= np.isclose(tLe.numpy(), np.asarray(jLe), rtol=1e-4,
                     atol=1e-6).all(-1)
    ok &= np.asarray(jrng).astype(np.int64) == trng.numpy()
    assert ok.mean() >= 0.98, ok.mean()
    valid = np.asarray(jsub.valid)
    assert valid[:, 0].mean() > 0.3 and np.asarray(jsub.is_surf).any()
    assert valid[:, 1:].any()


def _random_subpath(pkg, rng, n, v):
    """A Subpath of random densities and flags, as JAX or torch arrays."""
    arr = dict(
        p=rng.normal(size=(n, v, 3)), wi=rng.normal(size=(n, v, 3)),
        beta=rng.random((n, v, 4)), valid=rng.random((n, v)) < 0.8,
        pdf_fwd=10 ** rng.uniform(-3, 1, (n, v)),
        pdf_rev=10 ** rng.uniform(-3, 1, (n, v)),
        is_surf=rng.random((n, v)) < 0.3, n=rng.normal(size=(n, v, 3)),
        kind=np.zeros((n, v), np.int32), spec=rng.random((n, v)) < 0.15)
    arr = {k: a.astype(np.float32) if a.dtype == np.float64 else a
           for k, a in arr.items()}
    if pkg == "jax":
        return jbdpt.Subpath(**{k: jnp.asarray(a) for k, a in arr.items()},
                             prm={})
    return tbdpt.Subpath(**{k: torch.as_tensor(a) for k, a in arr.items()},
                         prm={})


def test_mis_weights_match_jax():
    n, v = 512, 4
    subs = {}
    for pkg in ("jax", "torch"):
        rng = np.random.default_rng(21)
        subs[pkg] = (_random_subpath(pkg, rng, n, v),
                     _random_subpath(pkg, rng, n, v))
    rng = np.random.default_rng(3)
    x = {k: rng.uniform(0.05, 3.0, n).astype(np.float32)
         for k in ("pl", "pc", "dist", "cc", "cl", "area")}
    J = {k: jnp.asarray(a) for k, a in x.items()}
    T = {k: torch.as_tensor(a) for k, a in x.items()}
    (jc, jlp), (tc, tlp) = subs["jax"], subs["torch"]
    for ci in range(v):
        for li in range(v):
            want = jbdpt._mis_weight(jc, jlp, ci, li, J["pl"], J["pc"],
                                     J["dist"], 0.3, 0.1, J["cc"], J["cl"])
            got = tbdpt._mis_weight(tc, tlp, ci, li, T["pl"], T["pc"],
                                    T["dist"], 0.3, 0.1, T["cc"], T["cl"])
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)
        for inv_area in (0.1, J["area"]):
            want = jbdpt._mis_weight_nee(jc, ci, inv_area)
            got = tbdpt._mis_weight_nee(
                tc, ci, inv_area if isinstance(inv_area, float)
                else T["area"])
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)
        want = jbdpt._mis_weight_t1(jlp, ci, J["area"])
        got = tbdpt._mis_weight_t1(tlp, ci, T["area"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        w = got.numpy()
        assert (w > 0).all() and (w <= 1).all() and (w < 1).any()


def _close_images(img, ref, mean_tol=1e-3):
    assert img.shape == ref.shape and np.isfinite(img).all()
    if ref.mean() > 0:
        assert abs(img.mean() - ref.mean()) / ref.mean() < mean_tol, (
            img.mean(), ref.mean())
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.97, close.mean()


@pytest.mark.parametrize("surfaces", [False, True])
def test_render_bdpt_matches_jax(surfaces):
    jscene = _scene(surfaces)
    with jax.disable_jit():
        ref, _, jstrat = jbdpt.render_bdpt(jscene, max_depth=2, spp=1)
    img, st, strat = tbdpt.render_bdpt(_port(jscene), max_depth=2, spp=1,
                                       device="cpu")
    assert st["spp"] == 1 and img.mean() > 0
    _close_images(img, ref)
    assert sorted(map(str, strat)) == sorted(map(str, jstrat))
    for key, s_img in strat.items():
        # (s, 1) splat films hold few splats: their means to 2e-3
        _close_images(s_img, jstrat[key],
                      2e-3 if key[-1] == 1 else 1e-3)
    keys = [k for k in strat if k[0] != "w"]
    assert (1, 2) in keys and (2, 1) in keys and (0, 0) in keys
    for k in keys:
        assert (strat[("w",) + k] <= strat[k] + 1e-5).all()


def test_render_bdpt_no_strategies():
    tscene = _port(_scene(False))
    img, _, strat = tbdpt.render_bdpt(tscene, max_depth=2, spp=1,
                                      keep_strategies=False, device="cpu")
    ref, _, _ = tbdpt.render_bdpt(tscene, max_depth=2, spp=1, device="cpu")
    assert strat == {}
    np.testing.assert_array_equal(img, ref)


def test_write_strategy_films_names(tmp_path):
    img = np.zeros((4, 4, 3), np.float32)
    strat = {(1, 2): img, ("w", 1, 2): img, (3, 1): img, ("w", 3, 1): img}
    tbdpt.write_strategy_films(strat, str(tmp_path / "t"), depth=4)
    jbdpt.write_strategy_films(strat, str(tmp_path / "j"), depth=4)
    names = lambda root: sorted(str(p.relative_to(root))
                                for p in root.rglob("*.exr"))
    assert names(tmp_path / "t") == names(tmp_path / "j") == [
        "no_weights_L/bdpt_d04_s01_t02.exr",
        "no_weights_L/bdpt_d04_s03_t01.exr",
        "weights/bdpt_d04_s01_t02.exr", "weights/bdpt_d04_s03_t01.exr"]


def test_render_bdpt_measured_matches_jax(tmp_path):
    """The floor as a measured BRDF: both subpaths sample it, and the
    connections evaluate it, through the measured dispatch as in the JAX
    package (under jax.disable_jit), at test_render_bdpt_matches_jax's
    tolerances."""
    import dataclasses

    from torch_surface_util import measured_pair

    jb, _ = measured_pair(tmp_path / "ggx.bsdf")
    jscene = _scene(True)
    prims = list(jscene.primitives)
    prims[0] = dataclasses.replace(prims[0],
                                   material=jm.MeasuredMaterial(brdf=jb))
    jscene = dataclasses.replace(jscene, primitives=prims)
    with jax.disable_jit():
        ref, _, _ = jbdpt.render_bdpt(jscene, max_depth=2, spp=1,
                                      keep_strategies=False)
    img, _, _ = tbdpt.render_bdpt(_port(jscene), max_depth=2, spp=1,
                                  keep_strategies=False, device="cpu")
    assert img.mean() > 0
    _close_images(img, ref)
