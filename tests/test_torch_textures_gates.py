"""tests/test_textures.py's gates (pbrt textures.h family: noise,
procedural textures, mappings, context textures) on the port's textures
(models/textures.py), thresholds unchanged."""
import numpy as np
import torch

from acceleratedvolrenderer_tpu_torch.models import textures as tx


def _uv(n=512, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.random((n, 2)), dtype=torch.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_perlin_range_and_smoothness():
    uv = _uv()
    p = torch.cat([uv * 10, torch.zeros((uv.shape[0], 1))], -1)
    n = tx.perlin_noise(p).numpy()
    assert np.abs(n).max() <= 1.5
    assert n.std() > 0.05
    assert abs(float(tx.perlin_noise(_t([[1.0, 2.0, 3.0]]))[0])) < 1e-5


def test_fbm_turbulence():
    uv = _uv()
    f = tx.FBmTexture().eval(uv).numpy()
    w = tx.WrinkledTexture().eval(uv).numpy()
    assert np.isfinite(f).all() and np.isfinite(w).all()
    assert (w >= 0).all()
    assert f.std() > 0.05


def test_marble_windy_dots_bilerp():
    uv = _uv()
    m = tx.MarbleTexture().eval(uv).numpy()
    assert m.shape[-1] == 3 and (m >= 0).all() and (m <= 1).all()
    assert (tx.WindyTexture().eval(uv).numpy() >= 0).all()
    d = tx.DotsTexture().eval(uv).numpy()
    assert set(np.unique(d)).issubset({0.0, 1.0})
    b = tx.BilerpTexture(0, 1, 0, 1).eval(
        _t([[0.0, 0.0], [0.0, 1.0], [0.5, 0.5]])).numpy()
    assert abs(b[0]) < 1e-6 and abs(b[1] - 1) < 1e-6 and abs(b[2] - 0.5) < 1e-6


def test_uv_mapping_scale_offset():
    uv = _uv()
    st = tx.UVMapping(su=2.0, sv=3.0, du=0.25, dv=-0.5).map(uv).numpy()
    assert np.allclose(st, uv.numpy() * [2.0, 3.0] + [0.25, -0.5], atol=1e-6)


def test_spherical_mapping_poles_and_equator():
    p = _t([[0, 0, 1.0], [0, 0, -1.0], [1.0, 0, 0], [0, 1.0, 0]])
    st = tx.SphericalMapping().map(torch.zeros((4, 2)), p).numpy()
    assert abs(st[0, 0] - 0.0) < 1e-5
    assert abs(st[1, 0] - 1.0) < 1e-5
    assert abs(st[2, 0] - 0.5) < 1e-5
    assert abs(st[2, 1] - 0.0) < 1e-5
    assert abs(st[3, 1] - 0.25) < 1e-5


def test_cylindrical_planar_mapping():
    p = _t([[1.0, 0, 0.7], [-1.0, 0, -0.3]])
    uv = torch.zeros((2, 2))
    st = tx.CylindricalMapping().map(uv, p).numpy()
    assert abs(st[0, 0] - 0.5) < 1e-5
    assert abs(st[0, 1] - 0.7) < 1e-5
    pl = tx.PlanarMapping(vs=(1, 0, 0), vt=(0, 0, 1), ds=0.1, dt=0.2)
    st2 = pl.map(uv, p).numpy()
    assert np.allclose(st2[:, 0], [1.1, -0.9], atol=1e-6)
    assert np.allclose(st2[:, 1], [0.9, -0.1], atol=1e-6)


def test_point_transform_mapping_applies_matrix():
    m4 = np.eye(4, dtype=np.float32)
    m4[:3, 3] = [1.0, 2.0, 3.0]
    m = tx.PointTransformMapping(texture_from_render=tuple(map(tuple, m4)))
    out = m.map(None, _t([[0.5, 0.5, 0.5]])).numpy()
    assert np.allclose(out, [[1.5, 2.5, 3.5]], atol=1e-6)


def test_mapped_texture_checker_through_spherical():
    base = tx.CheckerboardTexture(tx.ConstantTexture(1.0),
                                  tx.ConstantTexture(0.0),
                                  uscale=2.0, vscale=1.0)
    t = tx.MappedTexture(base, tx.SphericalMapping())
    p = _t([[0, 0.1, 1.0], [0, 0.1, -1.0]])
    v = t.eval_ctx(torch.zeros((2, 2)), p=p).numpy()
    assert v[0] != v[1]


def test_direction_mix_texture():
    t = tx.DirectionMixTexture(tx.ConstantTexture(1.0),
                               tx.ConstantTexture(0.0), dir=(0, 1, 0))
    uv = torch.zeros((3, 2))
    n = _t([[0, 1, 0], [0, -1, 0], [1, 0, 0]])
    assert np.allclose(t.eval_ctx(uv, n=n).numpy(), [1.0, 1.0, 0.0],
                       atol=1e-6)
    t2 = tx.DirectionMixTexture(tx.ConstantRGBTexture((1, 0, 0)),
                                tx.ConstantRGBTexture((0, 0, 1)),
                                dir=(0, 1, 0))
    v2 = t2.eval_ctx(uv, n=n).numpy()
    assert np.allclose(v2[0], [1, 0, 0], atol=1e-6)
    assert np.allclose(v2[2], [0, 0, 1], atol=1e-6)


def test_eval_texture_dispatch():
    uv = _uv(8)
    assert np.allclose(tx.eval_texture(tx.ConstantTexture(0.7), uv).numpy(),
                       0.7)
    d = tx.DirectionMixTexture(tx.ConstantTexture(1.0),
                               tx.ConstantTexture(0.0))
    assert np.allclose(tx.eval_texture(d, uv).numpy(), 1.0)


def test_mapped_texture_nested_without_hit_position():
    """A mapped texture inside Checkerboard / Mix / Scale, or evaluated
    without a hit position, falls back to uv-lifted positions."""
    uv = _uv(16)
    mapped = tx.MappedTexture(base=tx.ConstantTexture(0.7),
                              mapping=tx.SphericalMapping())
    for parent in (tx.CheckerboardTexture(mapped, tx.ConstantTexture(0.2)),
                   tx.MixTexture(mapped, tx.ConstantTexture(0.1)),
                   tx.ScaleTexture(mapped, 2.0)):
        assert np.isfinite(parent.eval(uv).numpy()).all()
    for mp in (tx.SphericalMapping(), tx.CylindricalMapping(),
               tx.PlanarMapping(), tx.PointTransformMapping()):
        assert np.isfinite(mp.map(uv, None).numpy()).all()
    p = torch.as_tensor(np.random.default_rng(1).random((16, 3)),
                        dtype=torch.float32)
    assert not np.allclose(tx.SphericalMapping().map(uv, p).numpy(),
                           tx.SphericalMapping().map(uv, None).numpy())


def test_checkerboard3d():
    t = tx.Checkerboard3DTexture(tx.ConstantTexture(1.0),
                                 tx.ConstantTexture(0.0))
    p = _t([[0.5, 0.5, 0.5], [1.5, 0.5, 0.5], [1.5, 1.5, 0.5],
            [0.2, 0.1, 1.9]])
    np.testing.assert_allclose(t.eval_ctx(torch.zeros((4, 2)), p=p).numpy(),
                               [1.0, 0.0, 1.0, 0.0])
