"""The port's MIP map (models/mipmap.py) and filtered image texture
(models/textures.py::ImageTexture(filtered=True)) against the JAX
package's, on the same numpy-seeded images, uv and footprints; and
tests/test_mipmap.py's gates on the port.

The pyramid is numpy on both sides: equal bit for bit.  The lookups are
float32 gathers and lerps in the same order: rtol 1e-5 / atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import textures as jt
from acceleratedvolrenderer_tpu.models.mipmap import MIPMap as JMIPMap
from acceleratedvolrenderer_tpu_torch.models import textures as tt
from acceleratedvolrenderer_tpu_torch.models.mipmap import MIPMap

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(64, 32, 3), (48, 20, 3), (17, 33, 1),
                                   (1, 8, 2)])
def test_pyramid_equals_jax(shape):
    img = np.random.default_rng(0).random(shape).astype(np.float32)
    m, j = MIPMap(img), JMIPMap(img)
    assert m.n_levels == j.n_levels and m.shapes == j.shapes
    np.testing.assert_array_equal(m.flat, np.asarray(j.flat))
    np.testing.assert_array_equal(m.offsets, np.asarray(j.offsets))


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    width = np.exp(rng.uniform(-9, 1, n)).astype(np.float32)
    duv0 = (rng.normal(size=(n, 2)) * np.exp(rng.uniform(-6, -1, (n, 1))))
    duv1 = (rng.normal(size=(n, 2)) * np.exp(rng.uniform(-8, -2, (n, 1))))
    return uv, width, duv0.astype(np.float32), duv1.astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 32, 3), (48, 20, 3)])
def test_lookups_match_jax(shape):
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    m, j = MIPMap(img, max_anisotropy=8.0, n_probes=6), JMIPMap(img)
    uv, width, duv0, duv1 = _inputs(1024, 2)
    t = torch.as_tensor
    _close(m.lookup_trilinear(t(uv), t(width)),
           j.lookup_trilinear(jnp.asarray(uv), jnp.asarray(width)))
    _close(m.lookup_ewa(t(uv), t(duv0), t(duv1)),
           j.lookup_ewa(jnp.asarray(uv), jnp.asarray(duv0),
                        jnp.asarray(duv1)))
    levels = np.random.default_rng(3).integers(0, m.n_levels, 1024)
    _close(m._bilerp_level(t(uv), t(levels)),
           j._bilerp_level(jnp.asarray(uv), jnp.asarray(levels, jnp.int32)))


@pytest.mark.parametrize("channels,invert", [(3, False), (1, True)])
def test_filtered_texture_matches_jax(channels, invert):
    img = np.random.default_rng(4).random((32, 24, channels))
    img = img.astype(np.float32)
    kw = dict(scale=1.5, invert=invert, filtered=True, max_anisotropy=4.0)
    tex, jtex = tt.ImageTexture(img, **kw), jt.ImageTexture(img, **kw)
    uv, width, duv0, duv1 = _inputs(512, 5)
    t = torch.as_tensor
    got = tex.eval_filtered(t(uv), t(width))
    assert got.shape == ((512, 3) if channels == 3 else (512,))
    _close(got, jtex.eval_filtered(jnp.asarray(uv), jnp.asarray(width)))
    _close(tex.eval_ewa(t(uv), t(duv0), t(duv1)),
           jtex.eval_ewa(jnp.asarray(uv), jnp.asarray(duv0),
                         jnp.asarray(duv1)))
    _close(tex.eval(t(uv)), jtex.eval(jnp.asarray(uv)))


def test_unfiltered_texture_refuses_filtered_lookup():
    tex = tt.ImageTexture(np.ones((2, 2, 3), np.float32))
    with pytest.raises(ValueError, match="filtered=True"):
        tex.eval_filtered(torch.zeros((1, 2)), torch.ones(1))


# ---- tests/test_mipmap.py's gates on the port ----

def _checker(h, w):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return (((yy // 4) + (xx // 4)) % 2).astype(np.float32)


def test_pyramid_levels_and_mean():
    img = np.random.RandomState(0).rand(64, 32, 3).astype(np.float32)
    m = MIPMap(img)
    assert m.n_levels == 7  # 64x32 -> ... -> 1x1
    assert m.shapes[0] == (64, 32) and m.shapes[-1] == (1, 1)
    np.testing.assert_allclose(m.flat[m.offsets[-1]],
                               img.mean(axis=(0, 1)), rtol=1e-5)


def test_trilinear_width0_matches_bilinear():
    img = np.random.RandomState(1).rand(32, 32, 1).astype(np.float32)
    tex = tt.ImageTexture(img, filtered=True)
    uv = torch.as_tensor(np.random.RandomState(2).rand(128, 2),
                         dtype=torch.float32)
    fine = tex.eval_filtered(uv, torch.zeros((128,)) + 1e-9)
    np.testing.assert_allclose(fine.numpy(), tex.eval(uv).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_trilinear_wide_width_is_mean():
    img = _checker(64, 64)[..., None]
    m = MIPMap(img)
    uv = torch.tensor([[0.3, 0.7], [0.9, 0.1]])
    out = m.lookup_trilinear(uv, torch.full((2,), 4.0))  # footprint >> image
    np.testing.assert_allclose(out.numpy()[:, 0], img.mean(), atol=1e-3)


def test_lod_monotone_blur():
    """Wider footprints move the checker lookup toward the global mean."""
    img = _checker(128, 128)[..., None]
    m = MIPMap(img)
    uv = torch.as_tensor(np.random.RandomState(3).rand(256, 2),
                         dtype=torch.float32)
    spread_prev = None
    for width in [1 / 128, 1 / 16, 1 / 4, 1.0]:
        out = m.lookup_trilinear(uv, torch.full((256,), width)).numpy()
        spread = np.abs(out[:, 0] - img.mean()).mean()
        if spread_prev is not None:
            assert spread <= spread_prev + 1e-6
        spread_prev = spread
    assert spread_prev < 0.02


def test_ewa_anisotropic_beats_trilinear():
    """A footprint long in u and thin in v over stripes that vary in v: EWA
    follows the major axis and blurs v far less than an isotropic filter
    of the same area."""
    h = w = 128
    yy = np.arange(h)
    img = np.broadcast_to(((yy // 8) % 2).astype(np.float32)[:, None],
                          (h, w)).copy()[..., None]
    m = MIPMap(img, max_anisotropy=16.0, n_probes=8)
    rs = np.random.RandomState(4)
    uv = torch.as_tensor(rs.rand(512, 2) * 0.8 + 0.1, dtype=torch.float32)
    duv0 = torch.tensor([0.25, 0.0]).expand(512, 2)       # major: u
    duv1 = torch.tensor([0.0, 1 / 128]).expand(512, 2)
    ewa = m.lookup_ewa(uv, duv0, duv1).numpy()[:, 0]
    gt = m.lookup_trilinear(uv, torch.full((512,), 1 / 128)).numpy()[:, 0]
    iso = m.lookup_trilinear(uv, torch.full((512,), 0.25)).numpy()[:, 0]
    err_ewa = np.abs(ewa - gt).mean()
    err_iso = np.abs(iso - gt).mean()
    assert err_ewa < err_iso * 0.5, (err_ewa, err_iso)


def test_nonpow2_resample_keeps_mean():
    img = np.random.RandomState(5).rand(48, 20, 3).astype(np.float32)
    m = MIPMap(img)
    assert m.shapes[0] == (64, 32)
    np.testing.assert_allclose(m.flat[m.offsets[-1]],
                               img.mean(axis=(0, 1)), atol=5e-3)
