"""tests/test_shapes2.py's gates on the port's bilinear patch and curve
(models/shapes.py): a planar patch behaves as its parallelogram, a saddle
is hit at its bilinear point, a sampled point re-intersects, a straight
and a bent curve are hit where their swept spheres lie."""
import numpy as np
import torch

from acceleratedvolrenderer_tpu_torch.models.shapes import BilinearPatch, Curve


def _ray(o, d):
    o = torch.tensor([o], dtype=torch.float32)
    d = torch.tensor([d], dtype=torch.float32)
    return o, d / torch.linalg.norm(d)


def _saddle():
    return BilinearPatch(p00=np.array([0., 0., 2.]), p10=np.array([1., 0., 3.]),
                         p01=np.array([0., 1., 3.]), p11=np.array([1., 1., 2.]))


def test_bilinear_planar_matches_quad():
    bp = BilinearPatch(p00=np.array([0., 0., 2.]), p10=np.array([1., 0., 2.]),
                       p01=np.array([0., 1., 2.]), p11=np.array([1., 1., 2.]))
    t, n, uv = bp.intersect(*_ray([0.25, 0.25, 0.0], [0.0, 0.0, 1.0]),
                            torch.inf)
    assert abs(float(t[0]) - 2.0) < 1e-4
    assert abs(abs(float(n[0, 2])) - 1.0) < 1e-4
    assert np.allclose(uv[0].numpy(), [0.25, 0.25], atol=1e-3)
    t, _, _ = bp.intersect(*_ray([1.5, 0.5, 0.0], [0.0, 0.0, 1.0]), torch.inf)
    assert not np.isfinite(float(t[0]))


def test_bilinear_nonplanar_hit():
    t, _, uv = _saddle().intersect(*_ray([0.5, 0.5, 0.0], [0.0, 0.0, 1.0]),
                                   torch.inf)
    assert abs(float(t[0]) - 2.5) < 1e-3
    assert np.allclose(uv[0].numpy(), [0.5, 0.5], atol=1e-3)


def test_bilinear_sample_on_surface():
    bp = _saddle()
    p, n, pdf = bp.sample(torch.tensor([[0.3, 0.7]]))
    t, _, _ = bp.intersect(p - 0.5 * n, n, torch.inf)
    assert abs(float(t[0]) - 0.5) < 1e-3


def test_curve_hit_and_miss():
    cp = np.array([[0., 0., 2.], [0.33, 0., 2.], [0.66, 0., 2.], [1., 0., 2.]])
    cv = Curve(cp=cp, width0=0.2, width1=0.2)
    t, n, uv = cv.intersect(*_ray([0.5, 0.0, 0.0], [0.0, 0.0, 1.0]),
                            torch.inf)
    assert abs(float(t[0]) - 1.9) < 0.02
    assert 0.4 < float(uv[0, 0]) < 0.6
    t, _, _ = cv.intersect(*_ray([0.5, 0.5, 0.0], [0.0, 0.0, 1.0]), torch.inf)
    assert not np.isfinite(float(t[0]))


def test_curve_bent():
    cp = np.array([[0., 0., 2.], [0.4, 0.5, 2.], [0.6, 0.5, 2.], [1., 0., 2.]])
    cv = Curve(cp=cp, width0=0.1, width1=0.1)
    t, _, _ = cv.intersect(*_ray([0.5, 0.375, 0.0], [0.0, 0.0, 1.0]),
                           torch.inf)
    assert np.isfinite(float(t[0]))
