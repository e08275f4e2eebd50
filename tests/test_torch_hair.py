"""The port's hair BxDF (models/hair.py) against the JAX package's, on the
same numpy-seeded directions, offsets and absorption; and
tests/test_hair.py's gates on the port (the JAX side runs a few hundred
lanes eagerly; the reference marks its own file slow for compile time).

hair_f and hair_pdf to rtol 1e-5 / atol 1e-6 on every lane; hair_sample's
directions, f and pdf together on at least 99% of the lanes (a lobe choice u0 >=
c_p may flip on an ulp), at beta 0.05 (the small-variance Mp branch), 0.3
and 0.6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import hair as jh
from acceleratedvolrenderer_tpu_torch.models import hair as th

import chip_smoke

torch.set_num_threads(2)

N = 512
TOL = dict(rtol=1e-5, atol=1e-6)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return dict(wo=_unit(rng, N), wi=_unit(rng, N),
                h=rng.uniform(-1, 1, N).astype(np.float32),
                sa=rng.uniform(0, 2, (N, 3)).astype(np.float32),
                u=rng.random((N, 4)).astype(np.float32))


def _both(x):
    return torch.as_tensor(x), jnp.asarray(x)


@pytest.mark.parametrize("beta", [0.05, 0.3, 0.6])
def test_hair_f_pdf_sample_match_jax(inputs, beta):
    tp = th.HairParams(beta_m=beta, beta_n=0.3, alpha=2.0)
    jp = jh.HairParams(beta_m=beta, beta_n=0.3, alpha=2.0)
    assert tp.v == jp.v and tp.s == jp.s
    (two, jwo), (twi, jwi), (thh, jhh), (tsa, jsa), (tu, ju) = map(
        _both, (inputs[k] for k in ("wo", "wi", "h", "sa", "u")))
    np.testing.assert_allclose(th.hair_f(two, twi, thh, tsa, tp).numpy(),
                               np.asarray(jh.hair_f(jwo, jwi, jhh, jsa, jp)),
                               **TOL)
    np.testing.assert_allclose(th.hair_pdf(two, twi, thh, tsa, tp).numpy(),
                               np.asarray(jh.hair_pdf(jwo, jwi, jhh, jsa,
                                                      jp)), **TOL)
    got = th.hair_sample(two, thh, tsa, tp, tu)
    want = jh.hair_sample(jwo, jhh, jsa, jp, ju)
    ok = np.ones(N, bool)
    for a, b in zip(got, want):
        ok &= np.isclose(a.numpy(), np.asarray(b), **TOL).reshape(N, -1).all(-1)
    assert ok.mean() >= 0.99, ok.mean()


def test_sigma_a_helpers_equal_jax():
    for ce, cp in ((1.3, 0.0), (0.2, 0.8)):
        np.testing.assert_array_equal(th.sigma_a_from_concentration(ce, cp),
                                      jh.sigma_a_from_concentration(ce, cp))
    np.testing.assert_array_equal(
        th.sigma_a_from_reflectance([0.5, 0.3, 0.1], 0.3),
        jh.sigma_a_from_reflectance([0.5, 0.3, 0.1], 0.3))


# ---- tests/test_hair.py's gates on the port ----

def _rand_wo(rng, n):
    return torch.as_tensor(_unit(rng, n))


def _albedo(prm, wo, h, sigma_a, u):
    wi, f, pdf = th.hair_sample(wo, h, sigma_a, prm, u)
    ok = pdf.numpy() > 1e-7
    w = (f.numpy()[:, 0] * np.abs(wi.numpy()[:, 2])
         / np.maximum(pdf.numpy(), 1e-9))
    return w[ok].mean()


def test_white_albedo():
    """sigma_a = 0: every bit of energy leaves the fiber, E[f |cos| / pdf]
    ~ 1 (bsdfs_test.cpp Hair WhiteAlbedo)."""
    rng = np.random.default_rng(0)
    n = 4096
    alb = _albedo(th.HairParams(beta_m=0.4, beta_n=0.4), _rand_wo(rng, n),
                  torch.as_tensor(rng.uniform(-1, 1, n), dtype=torch.float32),
                  torch.zeros((n, 3)),
                  torch.as_tensor(rng.random((n, 4)), dtype=torch.float32))
    assert 0.85 < alb < 1.15, alb


def test_absorption_reduces_albedo():
    rng = np.random.default_rng(1)
    prm = th.HairParams(beta_m=0.3, beta_n=0.3)
    n = 4096
    wo = _rand_wo(rng, n)
    h = torch.as_tensor(rng.uniform(-1, 1, n), dtype=torch.float32)
    u = torch.as_tensor(rng.random((n, 4)), dtype=torch.float32)
    albedo = lambda sa: _albedo(prm, wo, h, torch.full((n, 3), sa), u)
    assert albedo(2.0) < albedo(0.1) < 1.1


def test_pdf_normalizes():
    """The pdf integrates to ~1 over the sphere (MC, uniform directions)."""
    rng = np.random.default_rng(2)
    prm = th.HairParams(beta_m=0.5, beta_n=0.5)
    n = 8192
    wo = torch.tensor([[0.3, 0.8, np.sqrt(1 - 0.09 - 0.64)]],
                      dtype=torch.float32).expand(n, 3)
    pdf = th.hair_pdf(wo, _rand_wo(rng, n), torch.full((n,), 0.3),
                      torch.full((n, 3), 0.5), prm).numpy()
    integral = pdf.mean() * 4 * np.pi
    assert 0.8 < integral < 1.2, integral


def test_sigma_a_helpers():
    sa = th.sigma_a_from_concentration(1.3, 0.0)
    assert sa.shape == (3,) and (sa > 0).all()
    sa2 = th.sigma_a_from_reflectance([0.5, 0.3, 0.1], 0.3)
    assert (np.diff(sa2) > 0).all()   # darker channels absorb more


def test_cyhair_roundtrip(tmp_path):
    """A synthetic CyHair file converted by the port's cyhair2pbrt parses
    back through the port's parser as 4 curves."""
    from acceleratedvolrenderer_tpu_torch.cli import cyhair2pbrt
    from acceleratedvolrenderer_tpu_torch.scene.parser import load_scene

    path = tmp_path / "t.hair"
    chip_smoke.write_cyhair(path)
    out = tmp_path / "hair.pbrt"
    assert cyhair2pbrt.main([str(path), str(out)]) == 0
    txt = out.read_text()
    assert txt.count('Shape "curve"') == 4  # 2 segments x 2 strands
    sf = tmp_path / "s.pbrt"
    sf.write_text('Camera "perspective" "float fov" [45]\n'
                  'Film "rgb" "integer xresolution" [8] '
                  '"integer yresolution" [8]\n'
                  "WorldBegin\n"
                  'LightSource "point" "rgb I" [5 5 5]\n' + txt)
    sc = load_scene(str(sf), device="cpu")
    assert len(sc.primitives) == 4
    assert type(sc.primitives[0]).__name__ == "Curve"
