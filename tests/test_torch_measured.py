"""The port's measured BRDF (models/measured.py), MeasuredMaterial and the
path integrator's measured dispatch against the JAX package's, on the
same .bsdf file and numpy-seeded directions; and tests/test_measured.py's
gates on the port, at the reference's sizes (the port side is fast; the
JAX side runs at res 16, n_theta 4, eagerly).

Tolerances: the .bsdf round trip bit for bit; the warps' eval to rtol
1e-5 / atol 1e-6.  measured_f and measured_pdf to rtol 1e-5 / atol 1e-6 on
at least 99.5% of the lanes and to rtol 1e-3 on all: XLA's float32 arccos
and atan2 differ from torch's by an ulp on 17-19% of their inputs, and a
steep table cell turns that ulp of an angle into ~3e-5 of the value.
Sampled directions to atol 1e-5 on at least 99.9% of the lanes (a
bisection step may flip at a cell edge), f and pdf to rtol 1e-4 on 99.9%.
The li_path frame at 8x8 as tests/test_torch_path.py's (means to 1e-3, 99%
of pixels to rtol 1e-3 / atol 1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import lights as jl
from acceleratedvolrenderer_tpu.models import materials as jm
from acceleratedvolrenderer_tpu.models import measured as jms
from acceleratedvolrenderer_tpu.models import shapes as js
from acceleratedvolrenderer_tpu.scene import parser as jparser
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu_torch.models import lights as tl
from acceleratedvolrenderer_tpu_torch.models import materials as tm
from acceleratedvolrenderer_tpu_torch.models import measured as ms
from acceleratedvolrenderer_tpu_torch.models import shapes as ts
from acceleratedvolrenderer_tpu_torch.models.integrators.path import li_path
from acceleratedvolrenderer_tpu_torch.scene import parser as tparser
from acceleratedvolrenderer_tpu_torch.utils import spectrum as sp

from torch_surface_util import li_path_frames, measured_pair

torch.set_num_threads(2)

flat = jsp.constant_spectrum
ALPHA = 0.3
t = torch.as_tensor


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return measured_pair(tmp_path_factory.mktemp("bsdf") / "ggx.bsdf")


@pytest.fixture(scope="module")
def brdf():
    return ms.synthesize_ggx(alpha=ALPHA, res=64, n_theta=16)


def _dirs(rng, n, upper=True):
    v = rng.normal(size=(n, 3))
    if upper:
        v[:, 2] = np.abs(v[:, 2])
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_tensor_file_crosses_both_ways(tmp_path):
    """A file the port writes reads back equal through both readers, and
    the port reads the JAX writer's file equal."""
    rng = np.random.default_rng(0)
    fields = {
        "theta_i": rng.random(8).astype(np.float32),
        "vndf": rng.random((1, 8, 16, 16)).astype(np.float32),
        "counts": rng.integers(0, 9, (3, 2)).astype(np.int64),
        "half": rng.random(5).astype(np.float16),
        "description": np.frombuffer(b"hello", np.uint8),
    }
    a, b = tmp_path / "a.bsdf", tmp_path / "b.bsdf"
    ms.write_tensor_file(str(a), fields)
    jms.write_tensor_file(str(b), fields)
    assert a.read_bytes() == b.read_bytes()
    for back in (ms.read_tensor_file(str(a)), jms.read_tensor_file(str(a)),
                 ms.read_tensor_file(str(b))):
        assert list(back) == list(fields)
        for k in fields:
            assert back[k].dtype == fields[k].dtype
            np.testing.assert_array_equal(back[k], fields[k])


def test_synthesize_ggx_equals_jax():
    got = ms.synthesize_ggx(alpha=ALPHA, res=16, n_theta=4)
    want = jms.synthesize_ggx(alpha=ALPHA, res=16, n_theta=4)
    for name in ("ndf", "sigma", "vndf", "luminance", "spectra"):
        g, w = getattr(got, name), getattr(want, name)
        np.testing.assert_allclose(
            g.data.reshape(-1), np.asarray(w._vals).reshape(-1), rtol=1e-5,
            atol=1e-6, err_msg=name)
    assert got.isotropic and want.isotropic
    np.testing.assert_array_equal(got.wavelengths, want.wavelengths)
    # the .bsdf a synthesized BRDF saves holds its own tables
    back = ms.MeasuredBRDF.from_tensors(ms.tensors_of(got))
    for name in ("ndf", "sigma", "vndf", "luminance", "spectra"):
        np.testing.assert_array_equal(getattr(back, name).data,
                                      getattr(got, name).data)


@pytest.mark.parametrize("n_params", [0, 2, 3])
def test_piecewise_linear_2d_matches_jax(n_params):
    rng = np.random.default_rng(n_params)
    params = [np.array([0.0, 1.0], np.float32),
              np.sort(rng.random(5)).astype(np.float32),
              np.array([400.0, 550.0, 700.0], np.float32)][:n_params]
    data = rng.random(tuple(len(p) for p in params) + (9, 12))
    got = ms.PiecewiseLinear2D(data.astype(np.float32), params)
    want = jms.PiecewiseLinear2D(data.astype(np.float32), params)
    n = 2048
    u = rng.random((n, 2)).astype(np.float32)
    pv = [rng.uniform(p[0] - 0.1 * (p[-1] - p[0]),
                      p[-1] + 0.1 * (p[-1] - p[0]), n).astype(np.float32)
          for p in params]
    tp, jp = tuple(map(t, pv)), tuple(map(jnp.asarray, pv))
    np.testing.assert_allclose(got.eval(t(u), tp).numpy(),
                               np.asarray(want.eval(jnp.asarray(u), jp)),
                               rtol=1e-5, atol=1e-6)
    for fn in ("sample", "invert"):
        (a, pa), (b, pb) = (getattr(got, fn)(t(u), tp),
                            getattr(want, fn)(jnp.asarray(u), jp))
        ok = np.isclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5).all(-1)
        assert ok.mean() >= 0.999, (fn, ok.mean())
        np.testing.assert_allclose(pa.numpy()[ok], np.asarray(pb)[ok],
                                   rtol=1e-4, atol=1e-6)


def _wo_wi(n, seed):
    rng = np.random.default_rng(seed)
    wo, wi = _dirs(rng, n, upper=False), _dirs(rng, n, upper=False)
    lam = rng.uniform(380, 720, (n, 4)).astype(np.float32)
    return wo, wi, lam, rng.random((n, 2)).astype(np.float32)


def _share_close(got, want, share, rtol, atol=1e-6):
    """At least `share` of the lanes (rows) close to rtol / atol."""
    got, want = np.asarray(got), np.asarray(want)
    ok = np.isclose(got, want, rtol=rtol, atol=atol)
    ok = ok.reshape(len(ok), -1).all(-1)
    assert ok.mean() >= share, ok.mean()


def test_measured_f_and_pdf_match_jax(pair):
    jb, tb = pair
    wo, wi, lam, _ = _wo_wi(4096, 3)
    f = ms.measured_f(tb, t(wo), t(wi), t(lam)).numpy()
    jf = jms.measured_f(jb, jnp.asarray(wo), jnp.asarray(wi),
                        jnp.asarray(lam))
    pdf = ms.measured_pdf(tb, t(wo), t(wi)).numpy()
    jpdf = jms.measured_pdf(jb, jnp.asarray(wo), jnp.asarray(wi))
    for got, want in ((f, jf), (pdf, jpdf)):
        _share_close(got, want, 0.995, rtol=1e-5)
        _share_close(got, want, 1.0, rtol=1e-3)
    assert (np.asarray(jf) > 0).any(-1).mean() > 0.3


def test_measured_sample_matches_jax(pair):
    jb, tb = pair
    wo, _, lam, u2 = _wo_wi(4096, 4)
    wi, f, pdf, valid = ms.measured_sample(tb, t(wo), t(u2), t(lam))
    jwi, jf, jpdf, jvalid = map(np.asarray, jms.measured_sample(
        jb, jnp.asarray(wo), jnp.asarray(u2), jnp.asarray(lam)))
    ok = (np.isclose(wi.numpy(), jwi, rtol=0, atol=1e-5).all(-1)
          & (valid.numpy() == jvalid))
    assert ok.mean() >= 0.999, ok.mean()
    assert jvalid.mean() > 0.5
    _share_close(f.numpy()[ok], jf[ok], 0.999, rtol=1e-4)
    _share_close(pdf.numpy()[ok], jpdf[ok], 0.999, rtol=1e-4)


def test_li_path_measured_frame_matches_jax(pair):
    jb, _ = pair
    prims = [js.Sphere(center=np.array([0.3, 0.0, 3.0]), radius=0.8,
                       material=jm.MeasuredMaterial(brdf=jb)),
             js.Quad(origin=np.array([-3.0, -1.0, 0.0]),
                     e1=np.array([6.0, 0, 0]), e2=np.array([0, 0, 6.0]),
                     material=jm.MeasuredMaterial(brdf=jb))]
    lights = [jl.PointLight(position=np.array([0.0, 3.0, 2.0]),
                            spectrum=flat(30.0)),
              jl.UniformInfiniteLight(spectrum=flat(0.3), scene_radius=20.0)]
    img, ref = li_path_frames(prims, lights, 8, 8, spp=2, max_depth=3)
    assert np.isfinite(img).all() and ref.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()


def test_parser_builds_measured_material(pair, tmp_path):
    """Material "measured" of a .pbrt file: the port's parser loads the
    file's tables as the JAX parser does."""
    jb, _ = pair
    fn = tmp_path / "m.bsdf"
    ms.write_tensor_file(str(fn), ms.tensors_of(jb.port_brdf))
    text = ('Camera "perspective" "float fov" [45]\n'
            'Film "rgb" "integer xresolution" [4] "integer yresolution" [4]\n'
            "WorldBegin\n"
            'LightSource "point" "rgb I" [5 5 5]\n'
            f'Material "measured" "string filename" ["{fn}"]\n'
            'Shape "sphere" "float radius" [1]\n')
    sf = tmp_path / "s.pbrt"
    sf.write_text(text)
    m = tparser.load_scene(str(sf), device="cpu").primitives[0].material
    jmat = jparser.load_scene(str(sf)).primitives[0].material
    assert isinstance(m, tm.MeasuredMaterial) and m.filename == str(fn)
    assert m.kind == jmat.kind and m.roughness == 1.0 and m.eta == 1.5
    for name in ("ndf", "vndf", "spectra"):
        np.testing.assert_array_equal(
            getattr(m.brdf, name).data.reshape(-1),
            np.asarray(getattr(jmat.brdf, name)._vals).reshape(-1))


# ---- tests/test_measured.py's gates on the port ----

def _wo(theta_deg, n):
    th = np.deg2rad(theta_deg)
    return torch.tensor([np.sin(th), 0.0, np.cos(th)],
                        dtype=torch.float32).expand(n, 3)


def _lam(n):
    return torch.tensor([450.0, 550.0, 650.0, 600.0]).expand(n, 4)


def test_tensor_file_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    fields = {
        "theta_i": rng.random(8).astype(np.float32),
        "vndf": rng.random((1, 8, 16, 16)).astype(np.float32),
        "description": np.frombuffer(b"hello", np.uint8),
        "jacobian": np.zeros(1, np.uint8),
    }
    p = tmp_path / "t.bsdf"
    ms.write_tensor_file(str(p), fields)
    back = ms.read_tensor_file(str(p))
    assert set(back) == set(fields)
    for k in fields:
        assert np.array_equal(back[k], fields[k]), k


def test_sample_pdf_consistency(brdf):
    """measured_pdf of a sampled wi equals the sample's own pdf."""
    rng = np.random.default_rng(1)
    n = 2048
    wo = _wo(30.0, n)
    u2 = t(rng.random((n, 2)), dtype=torch.float32)
    wi, fr, pdf, valid = ms.measured_sample(brdf, wo, u2, _lam(n))
    ok = valid.numpy()
    assert ok.mean() > 0.85
    p2 = ms.measured_pdf(brdf, wo, wi).numpy()
    rel = np.abs(p2[ok] - pdf.numpy()[ok]) / np.maximum(pdf.numpy()[ok], 1e-9)
    assert rel.max() < 5e-3


def test_f_matches_analytic_ggx(brdf):
    """The synthesized tables encode f = D G2 / (4 cos_o cos_i): the full
    invert -> spectra -> ndf / sigma chain reproduces it."""
    rng = np.random.default_rng(2)
    n = 512
    wo = _wo(30.0, n)
    u2 = t(rng.random((n, 2)), dtype=torch.float32)
    wi, _, _, valid = ms.measured_sample(brdf, wo, u2, _lam(n))
    sel = valid.numpy() & (wi.numpy()[:, 2] > 0.05)
    wiv, wov = wi.numpy()[sel], wo.numpy()[sel]

    def lam_g(ct):
        ct = np.clip(ct, 1e-6, 1)
        t2 = (1 - ct ** 2) / ct ** 2
        return (np.sqrt(1 + ALPHA ** 2 * t2) - 1) / 2

    h = wiv + wov
    h /= np.linalg.norm(h, axis=1, keepdims=True)
    ct2 = np.clip(h[:, 2], 0, 1) ** 2
    D = ALPHA ** 2 / np.maximum(np.pi * (ct2 * (ALPHA ** 2 - 1) + 1) ** 2,
                                1e-12)
    G2 = 1 / (1 + lam_g(wov[:, 2]) + lam_g(wiv[:, 2]))
    fa = D * G2 / (4 * wov[:, 2] * wiv[:, 2])
    fm = ms.measured_f(brdf, t(wov), t(wiv), _lam(len(wov))).numpy()[:, 1]
    ratio = fm / np.maximum(fa, 1e-9)
    assert abs(np.mean(ratio) - 1.0) < 0.02
    assert np.percentile(np.abs(ratio - 1.0), 90) < 0.05


def test_energy_conservation(brdf):
    """E[f cos / pdf] of the white synthetic BRDF: below 1 (single
    scattering GGX loses energy) and above 0.75."""
    rng = np.random.default_rng(3)
    n = 8192
    u2 = t(rng.random((n, 2)), dtype=torch.float32)
    wi, fr, pdf, valid = ms.measured_sample(brdf, _wo(45.0, n), u2, _lam(n))
    ok = valid.numpy()
    est = (fr.numpy()[ok][:, 0] * wi.numpy()[ok][:, 2]
           / pdf.numpy()[ok]).mean()
    assert 0.75 < est <= 1.02


def test_path_render_with_measured():
    """A measured quad under a distant light renders non-black through
    li_path's measured dispatch."""
    mat = tm.MeasuredMaterial(brdf=ms.synthesize_ggx(alpha=0.4, res=32,
                                                     n_theta=8))
    quad = ts.Quad(origin=np.array([-2, -2, 0.0], np.float32),
                   e1=np.array([4, 0, 0.0], np.float32),
                   e2=np.array([0, 4, 0.0], np.float32), material=mat)
    light = tl.DistantLight(direction=torch.tensor([0, 0, -1.0]),
                            spectrum=sp.constant_spectrum(3.0))
    n = 256
    o = torch.tensor([0, 0, 3.0]).expand(n, 3)
    d = torch.tensor([0, 0, -1.0]).expand(n, 3)
    rng = torch.arange(n, dtype=torch.int64)
    L, _ = li_path((quad,), [light], o, d, _lam(n), rng, max_depth=2)
    Lm = float(L.mean())
    assert np.isfinite(Lm) and Lm > 0.01


def test_fused_route_warns_as_the_reference():
    """A medium scene with a measured and a subsurface sphere: the fused
    integrator gives both a Lambert albedo lobe and warns with the
    reference's message (volpath_fused.py l. 309-327), the kinds sorted by
    class name."""
    import warnings

    from acceleratedvolrenderer_tpu_torch.parallel import render
    from acceleratedvolrenderer_tpu_torch.scene import presets

    import chip_smoke

    sc = chip_smoke.cloud_with_item1(presets.cloud(
        8, 6, spp=1, max_depth=2, grid_res=8, device="cpu"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        img, _ = render.render(sc, device="cpu")
    msgs = {str(w.message) for w in caught if "fused volpath" in
            str(w.message)}
    want = ("fused volpath: material kind(s) "
            f"{', '.join(['MeasuredMaterial', 'SubsurfaceMaterial'])} "
            "approximate to a Lambert albedo lobe in medium-bearing scenes")
    assert msgs == {want} == {chip_smoke.ITEM1_FUSED_WARNING}
    assert np.isfinite(img).all()
