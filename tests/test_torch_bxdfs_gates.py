"""tests/test_bxdfs.py's gates (pbrt bsdfs_test.cpp pattern: sampling and
pdf consistency, energy conservation, Fresnel closed forms, the stochastic
LayeredBxDF walk) on the port's lobes (models/bxdfs.py), thresholds
unchanged; uniforms from torch generators seeded as the reference's PRNG
keys are numbered, walk streams from the port's seed_stream."""
import numpy as np
import torch

from acceleratedvolrenderer_tpu_torch.models import bxdfs
from acceleratedvolrenderer_tpu_torch.ops import dda


def _rand_u(seed, n, d=None):
    shape = (n,) if d is None else (n, d)
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def _rand_wo(seed, n, upper=True):
    u = _rand_u(seed, n, 2)
    z = u[:, 0] * (0.98 if upper else 1.96) + 0.01 - (0.0 if upper else 0.98)
    phi = 2 * np.pi * u[:, 1]
    s = torch.sqrt(torch.clamp(1 - z * z, min=0.0))
    return torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], -1)


def _full(shape, v):
    return torch.full(shape, v, dtype=torch.float32)


def test_fresnel_conductor_matches_dielectric_at_k0():
    cos_i = torch.linspace(0.05, 1.0, 64)
    eta = _full((64,), 1.5)
    fd = bxdfs.fresnel_dielectric(cos_i, eta)
    fc = bxdfs.fresnel_conductor(cos_i, eta, torch.zeros_like(eta))
    np.testing.assert_allclose(fc.numpy(), fd.numpy(), atol=1e-4)


def test_fresnel_dielectric_normal_incidence():
    F = bxdfs.fresnel_dielectric(torch.tensor([1.0]), torch.tensor([1.5]))
    np.testing.assert_allclose(float(F[0]), (0.5 / 2.5) ** 2, rtol=1e-5)


def test_diffuse_white_furnace():
    n = 4096
    s = bxdfs.diffuse_sample(_rand_wo(1, n), _rand_u(2, n, 2),
                             _full((n, 4), 0.7))
    est = s.f * bxdfs.abs_cos_theta(s.wi)[:, None] / torch.clamp(
        s.pdf, min=1e-9)[:, None]
    np.testing.assert_allclose(float(torch.mean(est)), 0.7, rtol=1e-3)


def test_conductor_rough_sample_pdf_consistency():
    n = 2048
    wo = _rand_wo(3, n)
    eta, k, alpha = _full((n, 1), 0.2), _full((n, 1), 3.0), _full((n,), 0.3)
    s = bxdfs.conductor_sample(wo, _rand_u(4, n, 2), eta, k, alpha)
    ok = s.pdf > 1e-5
    np.testing.assert_allclose(bxdfs.conductor_pdf(wo, s.wi, alpha)[ok]
                               .numpy(), s.pdf[ok].numpy(), rtol=2e-3)
    np.testing.assert_allclose(
        bxdfs.conductor_f(wo, s.wi, eta, k, alpha)[ok].numpy(),
        s.f[ok].numpy(), rtol=3e-3, atol=1e-5)


def test_conductor_energy_bounded():
    n = 8192
    wo = _rand_wo(5, n)
    s = bxdfs.conductor_sample(wo, _rand_u(6, n, 2), _full((n, 1), 0.2),
                               _full((n, 1), 3.0), _full((n,), 0.25))
    w = torch.where(s.pdf > 1e-7, s.f[:, 0] * bxdfs.abs_cos_theta(s.wi)
                    / torch.clamp(s.pdf, min=1e-9), 0.0)
    assert float(torch.mean(w)) <= 1.02


def test_dielectric_smooth_energy():
    n = 4096
    wo = _rand_wo(7, n, upper=False)
    s = bxdfs.dielectric_sample(wo, _rand_u(8, n), _rand_u(9, n, 2),
                                _full((n,), 1.5), torch.zeros((n,)))
    est = (s.f[:, 0] * bxdfs.abs_cos_theta(s.wi)
           / torch.clamp(s.pdf, min=1e-9)) * s.eta_scale
    np.testing.assert_allclose(est.numpy(), 1.0, atol=1e-3)


def test_dielectric_rough_sample_pdf_consistency():
    n = 4096
    wo = _rand_wo(10, n, upper=False)
    eta, alpha = _full((n,), 1.5), _full((n,), 0.3)
    s = bxdfs.dielectric_sample(wo, _rand_u(11, n), _rand_u(12, n, 2), eta,
                                alpha)
    ok = s.pdf > 1e-4
    np.testing.assert_allclose(
        bxdfs.dielectric_pdf(wo, s.wi, eta, alpha)[ok].numpy(),
        s.pdf[ok].numpy(), rtol=5e-3, atol=1e-6)
    np.testing.assert_allclose(
        bxdfs.dielectric_f(wo, s.wi, eta, alpha)[:, 0][ok].numpy(),
        s.f[ok][:, 0].numpy(), rtol=1e-2, atol=1e-5)


def test_dielectric_rough_energy_reasonable():
    n = 16384
    s = bxdfs.dielectric_sample(_rand_wo(13, n), _rand_u(14, n),
                                _rand_u(15, n, 2), _full((n,), 1.5),
                                _full((n,), 0.2))
    est = torch.where(s.pdf > 1e-7, s.f[:, 0] * bxdfs.abs_cos_theta(s.wi)
                      / torch.clamp(s.pdf, min=1e-9) * s.eta_scale, 0.0)
    m = float(torch.mean(est))
    assert 0.7 < m <= 1.02, m


def test_thin_dielectric_partition():
    n = 1024
    s = bxdfs.thin_dielectric_sample(_rand_wo(16, n), _rand_u(17, n),
                                     _full((n,), 1.5))
    est = s.f[:, 0] * bxdfs.abs_cos_theta(s.wi) / torch.clamp(s.pdf,
                                                              min=1e-9)
    np.testing.assert_allclose(est.numpy(), 1.0, atol=1e-3)


def test_diffuse_transmission_partition():
    n = 4096
    wo = _rand_wo(18, n)
    refl, trans = _full((n, 4), 0.4), _full((n, 4), 0.35)
    s = bxdfs.diffuse_transmission_sample(wo, _rand_u(19, n),
                                          _rand_u(20, n, 2), refl, trans)
    est = s.f * bxdfs.abs_cos_theta(s.wi)[:, None] / torch.clamp(
        s.pdf, min=1e-9)[:, None]
    np.testing.assert_allclose(float(torch.mean(est)), 0.75, rtol=2e-2)
    pdf2 = bxdfs.diffuse_transmission_pdf(wo, s.wi, refl.amax(-1),
                                          trans.amax(-1))
    np.testing.assert_allclose(pdf2.numpy(), s.pdf.numpy(), rtol=1e-4)


def test_vndf_sampled_normals_visible():
    n = 4096
    wo = _rand_wo(21, n)
    wm = bxdfs.tr_sample_wm(wo, _rand_u(22, n, 2), _full((n,), 0.4))
    assert bool(torch.all(wm[:, 2] > 0))
    assert bool(torch.all(torch.sum(wm * wo, -1) > -1e-5))


def _layered_R(alb_val, thickness, med_albedo=None, cosw=0.6, n=16384,
               g=0.0, seed=9):
    rng = dda.seed_stream(torch.arange(n, dtype=torch.int64),
                          torch.zeros((n,), dtype=torch.int64), salt=seed)
    wo = torch.broadcast_to(torch.tensor(
        [np.sqrt(1 - cosw ** 2), 0.0, cosw], dtype=torch.float32), (n, 3))
    med = _full((n, 4), med_albedo) if med_albedo is not None else None
    bs, _ = bxdfs.layered_sample(wo, rng, _full((n, 4), alb_val),
                                 _full((n,), 1.5), torch.zeros((n,)),
                                 thickness=thickness, g=g, med_albedo=med,
                                 max_depth=16)
    pdf = bs.pdf.numpy()
    w = bs.f[:, 0].numpy() * bxdfs.abs_cos_theta(bs.wi).numpy()
    return float(np.where(pdf > 0, w / np.maximum(pdf, 1e-30), 0.0).mean())


def test_layered_white_furnace():
    R = _layered_R(1.0, 1e-4)
    assert 0.95 < R < 1.01, R


def test_layered_absorption_monotone():
    r0, r1, r2 = (_layered_R(0.8, 1e-3), _layered_R(0.8, 0.2),
                  _layered_R(0.8, 0.6))
    assert r0 > r1 > r2, (r0, r1, r2)


def test_layered_scattering_medium_conserves():
    r_scat = _layered_R(1.0, 0.5, med_albedo=1.0)
    r_abs = _layered_R(1.0, 0.5, med_albedo=None)
    assert r_scat > r_abs + 0.1, (r_scat, r_abs)
    assert r_scat < 1.02, r_scat


def test_layered_matches_analytic_model():
    n = 16384
    cosw = 0.6
    R_walk = _layered_R(0.5, 1e-3, cosw=cosw, n=n)
    rng = np.random.default_rng(3)
    wo = torch.broadcast_to(torch.tensor(
        [np.sqrt(1 - cosw ** 2), 0.0, cosw], dtype=torch.float32), (n, 3))
    s = bxdfs.coated_diffuse_sample(
        wo, torch.as_tensor(rng.random(n), dtype=torch.float32),
        torch.as_tensor(rng.random((n, 2)), dtype=torch.float32),
        _full((n, 4), 0.5), _full((n,), 1.5), torch.zeros((n,)))
    pdf = s.pdf.numpy()
    w = s.f[:, 0].numpy() * bxdfs.abs_cos_theta(s.wi).numpy()
    R_analytic = float(np.where(pdf > 0, w / np.maximum(pdf, 1e-30),
                                0.0).mean())
    assert abs(R_walk - R_analytic) < 0.05, (R_walk, R_analytic)


def test_layered_deterministic():
    n = 64
    rng = dda.seed_stream(torch.arange(n, dtype=torch.int64),
                          torch.zeros((n,), dtype=torch.int64), salt=1)
    wo = torch.broadcast_to(torch.tensor([0.0, 0.0, 1.0]), (n, 3))
    args = (_full((n, 4), 0.7), _full((n,), 1.5), torch.zeros((n,)))
    a, _ = bxdfs.layered_sample(wo, rng, *args)
    b, _ = bxdfs.layered_sample(wo, rng, *args)
    np.testing.assert_array_equal(a.f.numpy(), b.f.numpy())
    np.testing.assert_array_equal(a.wi.numpy(), b.wi.numpy())
