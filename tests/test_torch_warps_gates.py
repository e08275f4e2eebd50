"""tests/test_warps.py's statistical gates (pbrt sampling_test.cpp) run on
the port's warps (ops/warps.py), thresholds unchanged; uniforms from torch
generators seeded as the reference's PRNG keys are numbered."""
import numpy as np
import torch

from acceleratedvolrenderer_tpu_torch.ops import warps


def _u(seed, shape):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def test_sample_exponential_mean():
    a = 2.5
    x = warps.sample_exponential(_u(0, (200_000,)), a)
    assert abs(float(torch.mean(x)) - 1.0 / a) < 5e-3
    assert float(x.min()) >= 0.0
    np.testing.assert_allclose(warps.exponential_pdf(x[:8], a).numpy(),
                               a * np.exp(-a * x[:8].numpy()), rtol=1e-6)


def test_sample_discrete3():
    u = _u(1, (200_000,))
    idx, pdf, u2 = warps.sample_discrete3(u, 1.0, 2.0, 5.0)
    counts = np.bincount(idx.numpy(), minlength=3) / idx.shape[0]
    np.testing.assert_allclose(counts, [1 / 8, 2 / 8, 5 / 8], atol=5e-3)
    np.testing.assert_allclose(
        pdf.numpy(), np.array([1 / 8, 2 / 8, 5 / 8])[idx.numpy()], rtol=1e-5)
    assert abs(float(torch.mean(u2)) - 0.5) < 5e-3
    assert float(u2.max()) < 1.0


def test_uniform_sphere():
    v = warps.sample_uniform_sphere(_u(2, (100_000, 2)))
    np.testing.assert_allclose(torch.linalg.norm(v, dim=-1).numpy(), 1.0,
                               atol=1e-5)
    frac = float(torch.mean(((v[:, 0] > 0) & (v[:, 1] > 0)
                             & (v[:, 2] > 0)).float()))
    assert abs(frac - 0.125) < 5e-3
    np.testing.assert_allclose(torch.mean(v, dim=0).numpy(), 0.0, atol=1e-2)


def test_cosine_hemisphere():
    v = warps.sample_cosine_hemisphere(_u(3, (100_000, 2)))
    assert float(v[:, 2].min()) >= 0.0
    assert abs(float(torch.mean(v[:, 2])) - 2.0 / 3.0) < 5e-3
    np.testing.assert_allclose(warps.cosine_hemisphere_pdf(v[:, 2]).numpy(),
                               v[:, 2].numpy() / np.pi, rtol=1e-6)


def test_concentric_disk():
    d = warps.sample_uniform_disk_concentric(_u(4, (100_000, 2)))
    r2 = d[:, 0] ** 2 + d[:, 1] ** 2
    assert float(r2.max()) <= 1.0 + 1e-6
    assert abs(float(torch.mean(r2)) - 0.5) < 5e-3


def test_uniform_cone():
    ctm = 0.8
    v = warps.sample_uniform_cone(_u(5, (100_000, 2)), ctm)
    assert float(v[:, 2].min()) >= ctm - 1e-6
    assert abs(float(torch.mean(v[:, 2])) - (1 + ctm) / 2) < 5e-3
    assert abs(warps.uniform_cone_pdf(ctm) - 1 / (2 * np.pi * 0.2)) < 1e-9


def test_power_heuristic():
    t = lambda x: torch.tensor(x)
    assert abs(float(warps.power_heuristic(1, t(1.0), 1, t(1.0))) - 0.5) < 1e-6
    assert float(warps.power_heuristic(1, t(10.0), 1, t(0.1))) > 0.99
    assert float(warps.power_heuristic(1, t(0.0), 1, t(0.0))) == 0.0
    assert abs(float(warps.balance_heuristic(1, t(3.0), 1, t(1.0)))
               - 0.75) < 1e-6
    assert float(warps.balance_heuristic(1, t(0.0), 1, t(0.0))) == 0.0


def test_uniform_triangle():
    b = warps.sample_uniform_triangle(_u(6, (50_000, 2))).numpy()
    assert np.all(b >= -1e-6)
    np.testing.assert_allclose(b.sum(-1), 1.0, atol=1e-5)
