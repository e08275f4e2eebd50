"""tests/test_phase.py's gates (pbrt media_test.cpp: normalization, the
sampled pdf equal to p, the mean cosine, the isotropic limit) run on the
port's HG phase function (ops/phase.py), thresholds unchanged; uniforms
from torch generators seeded as the reference's PRNG keys are numbered."""
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu_torch.ops import phase, warps


def _u(seed, shape):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def _g(g):
    return torch.tensor(g, dtype=torch.float32)


@pytest.mark.parametrize("g", [-0.6, -0.2, 0.0, 0.3, 0.7])
def test_hg_normalization(g):
    wi = warps.sample_uniform_sphere(_u(0, (200_000, 2)))
    wo = torch.tensor([0.0, 0.0, 1.0])
    integral = float(torch.mean(phase.hg_phase(wo, wi, _g(g)))) * 4.0 * np.pi
    assert abs(integral - 1.0) < 1.5e-2, integral


@pytest.mark.parametrize("g", [-0.5, 0.0, 0.6])
def test_hg_sample_pdf_equals_p(g):
    wo = warps.sample_uniform_sphere(_u(2, (4096, 2)))
    wi, pdf = phase.sample_hg(wo, _u(1, (4096, 2)), _g(g))
    p = phase.hg_phase(wo, wi, _g(g))
    np.testing.assert_allclose(pdf.numpy(), p.numpy(), rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("g", [-0.6, 0.0, 0.4, 0.8])
def test_hg_mean_cosine(g):
    """Sampled around +wo, E[dot(wo, wi)] == -g (pbrt's convention: forward
    scattering continues along -wo)."""
    wo = torch.broadcast_to(torch.tensor([0.0, 0.0, 1.0]), (400_000, 3))
    wi, _ = phase.sample_hg(wo, _u(3, (400_000, 2)), _g(g))
    mean_cos = float(torch.mean(torch.sum(wo * wi, dim=-1)))
    assert abs(mean_cos - (-g)) < 5e-3, (mean_cos, g)


def test_hg_isotropic_limit():
    wo = torch.tensor([0.0, 0.0, 1.0])
    wi = warps.sample_uniform_sphere(_u(4, (1024, 2)))
    p = phase.hg_phase(wo, wi, _g(0.0))
    np.testing.assert_allclose(p.numpy(), 1.0 / (4 * np.pi), rtol=1e-5)
