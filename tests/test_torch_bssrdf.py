"""The port's BSSRDF (models/bssrdf.py) and li_path's subsurface branch
(models/integrators/path.py) against the JAX package's, on the same
numpy-seeded inputs; and tests/test_bssrdf.py's gates on the port.

Tolerances: the profile functions to rtol 1e-5 / atol 1e-6; the beam
diffusion table (numpy float64 on both sides) bit for bit; exit points to
atol 1e-5 on at least 99.9% of the lanes (a probe that grazes the sphere's
silhouette may hit or miss on an ulp), their weights to rtol 1e-4 there.
li_path frames at 8x8 (both sides outside jit, the JAX side under
jax.disable_jit): means to 1e-3 relative and 99% of the pixels to rtol
1e-3 / atol 1e-5, as tests/test_torch_path.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import bssrdf as jb
from acceleratedvolrenderer_tpu.models import lights as jl
from acceleratedvolrenderer_tpu.models import materials as jm
from acceleratedvolrenderer_tpu.models import shapes as js
from acceleratedvolrenderer_tpu.models.cameras import PerspectiveCamera
from acceleratedvolrenderer_tpu.models.film import BoxFilter
from acceleratedvolrenderer_tpu.scene import Scene as JScene
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu.utils import vecmath as jvm
from acceleratedvolrenderer_tpu_torch.models import bssrdf as tb
from acceleratedvolrenderer_tpu_torch.parallel import render as trender
from acceleratedvolrenderer_tpu_torch.scene import convert

from torch_surface_util import li_path_frames, plain, \
    surface_arrays_from_jax_scene

torch.set_num_threads(2)

flat = jsp.constant_spectrum
TOL = dict(rtol=1e-5, atol=1e-6)
t = torch.as_tensor


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(kw or TOL))


def test_profile_functions_match_jax():
    rng = np.random.default_rng(0)
    n = 2048
    r = np.exp(rng.uniform(-9, 0, n)).astype(np.float32)
    alb = rng.uniform(0.05, 0.99, (n, 3)).astype(np.float32)
    ell = np.exp(rng.uniform(-6, -1, (n, 3))).astype(np.float32)
    u = rng.random(n).astype(np.float32)
    _close(tb.scaling_factor(t(alb)), jb.scaling_factor(jnp.asarray(alb)))
    _close(tb.profile(t(r), t(alb), t(ell)),
           jb.profile(jnp.asarray(r), jnp.asarray(alb), jnp.asarray(ell)))
    _close(tb.pdf_r(t(r), t(alb), t(ell)),
           jb.pdf_r(jnp.asarray(r), jnp.asarray(alb), jnp.asarray(ell)))
    _close(tb.sample_r(t(u), t(alb[:, 0]), t(ell[:, 0])),
           jb.sample_r(jnp.asarray(u), jnp.asarray(alb[:, 0]),
                       jnp.asarray(ell[:, 0])))
    for eta in (0.8, 1.0, 1.33, 1.5):
        assert tb.fresnel_moment_c(eta) == jb.fresnel_moment_c(eta)
        assert tb.fresnel_moment1(eta) == jb.fresnel_moment1(eta)
        assert tb.fresnel_moment2(eta) == jb.fresnel_moment2(eta)


@pytest.mark.parametrize("g,eta", [(0.0, 1.33), (0.3, 1.5)])
def test_beam_diffusion_table_equals_jax(g, eta):
    want = jb.compute_beam_diffusion_table(g=g, eta=eta)
    got = tb.compute_beam_diffusion_table(g=g, eta=eta)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    refl, mfp = np.array([0.5, 0.7, 0.2]), np.array([0.01, 0.02, 0.05])
    for a, b in zip(tb.subsurface_from_diffuse(got, refl, mfp),
                    jb.subsurface_from_diffuse(want, refl, mfp)):
        np.testing.assert_array_equal(a, b)
    tab = tb.tabulated_channel_arrays(got, refl, mfp, "cpu")
    jtab = jb.tabulated_channel_arrays(want, refl, mfp)
    for k in jtab:
        np.testing.assert_array_equal(tab[k].numpy(), np.asarray(jtab[k]))
    rng = np.random.default_rng(1)
    d = np.exp(rng.uniform(-9, 0, 1024)).astype(np.float32)
    ch = rng.integers(0, 3, 1024)
    u = rng.random(1024).astype(np.float32)
    _close(tb.tabulated_pdf_r(tab, t(d)),
           jb.tabulated_pdf_r(jtab, jnp.asarray(d)))
    _close(tb.tabulated_sample_r(tab, t(ch), t(u)),
           jb.tabulated_sample_r(jtab, jnp.asarray(ch, jnp.int32),
                                 jnp.asarray(u)))


def _exit_scene():
    mat = jm.DiffuseMaterial(reflectance=flat(0.5))
    return [js.Sphere(center=np.array([0.0, 0.0, 3.0]), radius=1.0,
                      material=mat),
            js.Quad(origin=np.array([-3.0, -1.0, 0.0]),
                    e1=np.array([6.0, 0, 0]), e2=np.array([0, 0, 6.0]),
                    material=mat)]


@pytest.mark.parametrize("profile", ["burley", "tabulated"])
def test_sample_exit_matches_jax(profile):
    prims = _exit_scene()
    tprims = tuple(convert.object_from(plain(p), "cpu") for p in prims)
    rng = np.random.default_rng(2)
    n = 4096
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:, 2] = -np.abs(v[:, 2])                 # the camera-facing half
    p = (np.array([0.0, 0.0, 3.0]) + v).astype(np.float32)
    nrm = v.astype(np.float32)
    ids = np.zeros(n, np.int64)
    us = [rng.random(n).astype(np.float32) for _ in range(3)]
    refl, mfp = np.array([0.8, 0.5, 0.3]), np.array([0.05, 0.1, 0.2])
    if profile == "burley":
        alb = np.broadcast_to(refl, (n, 3)).astype(np.float32)
        ell = np.broadcast_to(mfp, (n, 3)).astype(np.float32)
        got = tb.sample_exit(tprims, t(ids), t(p), t(nrm), t(alb), t(ell),
                             *map(t, us))
        want = jb.sample_exit(tuple(prims), jnp.asarray(ids, jnp.int32),
                              jnp.asarray(p), jnp.asarray(nrm),
                              jnp.asarray(alb), jnp.asarray(ell),
                              *map(jnp.asarray, us))
    else:
        tab = tb.tabulated_channel_arrays(
            tb.compute_beam_diffusion_table(), refl, mfp, "cpu")
        jtab = jb.tabulated_channel_arrays(
            jb.compute_beam_diffusion_table(), refl, mfp)
        got = tb.sample_exit_tabulated(tprims, t(ids), t(p), t(nrm), tab,
                                       *map(t, us))
        want = jb.sample_exit_tabulated(tuple(prims),
                                        jnp.asarray(ids, jnp.int32),
                                        jnp.asarray(p), jnp.asarray(nrm),
                                        jtab, *map(jnp.asarray, us))
    (ep, en, w, found), (jep, jen, jw, jfound) = got, map(np.asarray, want)
    ok = (np.isclose(ep.numpy(), jep, rtol=0, atol=1e-5).all(-1)
          & (found.numpy() == jfound))
    assert ok.mean() >= 0.999, ok.mean()
    assert jfound.mean() > 0.5
    np.testing.assert_allclose(en.numpy()[ok], jen[ok], rtol=0, atol=1e-5)
    np.testing.assert_allclose(w.numpy()[ok], jw[ok], rtol=1e-4, atol=1e-6)


def _subsurface_prims(mat):
    return [js.Sphere(center=np.array([0.0, 0.0, 3.0]), radius=1.0,
                      material=mat),
            js.Quad(origin=np.array([-3.0, -1.0, 0.0]),
                    e1=np.array([6.0, 0, 0]), e2=np.array([0, 0, 6.0]),
                    material=jm.DiffuseMaterial(reflectance=flat(0.5)))]


@pytest.mark.parametrize("profile", ["burley", "tabulated"])
def test_li_path_subsurface_frame_matches_jax(profile):
    mat = jm.SubsurfaceMaterial(reflectance_rgb=(0.8, 0.5, 0.3),
                                mfp_rgb=(0.05, 0.05, 0.05), eta=1.33,
                                profile=profile)
    lights = [jl.PointLight(position=np.array([0.0, 3.0, 3.0]),
                            spectrum=flat(30.0)),
              jl.UniformInfiniteLight(spectrum=flat(0.3), scene_radius=20.0)]
    img, ref = li_path_frames(_subsurface_prims(mat), lights, 8, 8, spp=2,
                              max_depth=3)
    assert np.isfinite(img).all() and ref.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()


def test_subsurface_material_equals_jax():
    kw = dict(reflectance_rgb=(0.6, 0.5, 0.4), mfp_rgb=(0.05, 0.1, 0.2),
              eta=1.4, profile="tabulated", g=0.2)
    m = convert.object_from(plain(jm.SubsurfaceMaterial(**kw)), "cpu")
    j = jm.SubsurfaceMaterial(**kw)
    for f in dataclasses.fields(j):
        assert getattr(m, f.name) == getattr(j, f.name), f.name
    assert m.kind == j.kind and m.reflectance == j.reflectance
    assert not m.emissive


# ---- tests/test_bssrdf.py's gates on the port ----

def test_profile_integrates_to_albedo():
    rs = np.linspace(1e-4, 0.5, 20000)
    dr = rs[1] - rs[0]
    A, ell = 0.7, 0.01
    sp = tb.profile(t(rs, dtype=torch.float32), torch.full((len(rs), 1), A),
                    torch.full((len(rs), 1), ell)).numpy()[:, 0]
    integral = (sp * 2 * np.pi * rs * dr).sum()
    assert abs(integral - A) < 0.02 * A, integral


def test_sample_r_matches_cdf():
    rng = np.random.default_rng(0)
    n = 20000
    A, ell = 0.5, 0.02
    u = t(rng.random(n), dtype=torch.float32)
    r = tb.sample_r(u, torch.full((n,), A), torch.full((n,), ell)).numpy()
    s = float(tb.scaling_factor(A))
    x = s * np.median(r) / ell
    cdf_med = 1 - np.exp(-x) / 4 - 3 * np.exp(-x / 3) / 4
    assert abs(cdf_med - 0.5) < 0.02


def _sphere_scene(mat, light, width, spp, eye=(0, 0, 0), look=(0, 0, 3),
                  center=(0.0, 0.0, 3.0), fov=40.0, radius=10.0):
    sphere = js.Sphere(center=np.array(center), radius=1.0, material=mat)
    cam = PerspectiveCamera(c2w=jvm.look_at(eye, look, (0, 1, 0)),
                            fov_deg=fov, width=width, height=width)
    sc = JScene(camera=cam, medium=None, lights=[light], primitives=[sphere],
                max_depth=5, filter=BoxFilter(), spp=spp,
                scene_radius=radius, integrator="path")
    return convert.scene_from_arrays(surface_arrays_from_jax_scene(sc),
                                     "cpu")


def test_subsurface_furnace_bounded():
    """A white subsurface sphere under a point light: energy within MC
    noise of, and below the bound of, a diffuse sphere."""
    light = jl.PointLight(position=np.array([0.0, 3.0, 3.0]),
                          spectrum=flat(30.0))

    def run(mat):
        return trender.render(_sphere_scene(mat, light, 12, 32),
                              device="cpu")[0]

    img_ss = run(jm.SubsurfaceMaterial(reflectance_rgb=(0.8, 0.8, 0.8),
                                       mfp_rgb=(0.05, 0.05, 0.05)))
    img_d = run(jm.DiffuseMaterial(reflectance=flat(0.8)))
    assert np.isfinite(img_ss).all() and img_ss.max() > 0
    assert img_ss.mean() < img_d.mean() * 1.5
    assert img_ss.mean() > img_d.mean() * 0.2


def test_subsurface_translucency_tint():
    """A channel-dependent mfp tints multiply scattered light: red bleeds
    farther when mfp_r >> mfp_gb."""
    mat = jm.SubsurfaceMaterial(reflectance_rgb=(0.9, 0.9, 0.9),
                                mfp_rgb=(0.2, 0.01, 0.01))
    light = jl.PointLight(position=np.array([2.5, 0.0, 4.5]),
                          spectrum=flat(40.0))
    img, _ = trender.render(_sphere_scene(mat, light, 16, 48), device="cpu")
    left = img[:, :6][img[:, :6].sum(-1) > 1e-5]
    assert len(left) > 0
    assert left[:, 0].mean() > left[:, 2].mean()


def test_beam_diffusion_table_properties():
    """The tabulated profile: effective albedo monotone in rho, spanning
    ~[0, 1]; each channel's planar pdf integrates to 1; inverse-CDF
    sampling reproduces the pdf's mean radius."""
    tab0 = tb.compute_beam_diffusion_table(g=0.0, eta=1.33)
    assert np.all(np.diff(tab0["rho_eff"]) >= -1e-9)
    assert tab0["rho_eff"][0] == 0.0 and tab0["rho_eff"][-1] > 0.9
    tab = tb.tabulated_channel_arrays(tab0, np.array([0.5, 0.7, 0.2]),
                                      np.array([0.01, 0.01, 0.02]), "cpu")
    r = np.linspace(1e-5, 0.3, 30000)
    pdf = tb.tabulated_pdf_r(tab, t(r, dtype=torch.float32)).numpy()
    integ = np.trapezoid(pdf * 2 * np.pi * r[:, None], r, axis=0)
    np.testing.assert_allclose(integ, 1.0, atol=0.03)
    u = t(np.linspace(1e-4, 1 - 1e-4, 4096), dtype=torch.float32)
    rs = tb.tabulated_sample_r(tab, torch.zeros(4096, dtype=torch.int64),
                               u).numpy()
    mean_pdf = np.trapezoid(pdf[:, 0] * 2 * np.pi * r * r, r)
    assert abs(rs.mean() - mean_pdf) / mean_pdf < 0.08, (rs.mean(), mean_pdf)


def test_tabulated_profile_render_matches_burley():
    """Both profiles target the same diffuse reflectance: the rendered
    sphere's means agree to ~12%."""
    def build(profile):
        mat = jm.SubsurfaceMaterial(reflectance_rgb=(0.6, 0.5, 0.4),
                                    mfp_rgb=(0.05, 0.05, 0.05),
                                    profile=profile)
        light = jl.UniformInfiniteLight(spectrum=flat(1.0),
                                        scene_radius=30.0)
        sc = _sphere_scene(mat, light, 10, 64, eye=(0, 0.4, -3.2),
                           look=(0, 0, 0), center=(0.0, 0.0, 0.0), fov=36.0,
                           radius=30.0)
        return float(trender.render(sc, device="cpu")[0].mean())

    m_b, m_t = build("burley"), build("tabulated")
    assert abs(m_t - m_b) / max(m_b, 1e-9) < 0.12, (m_b, m_t)
