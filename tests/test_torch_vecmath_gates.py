"""tests/test_vecmath.py's gates (pbrt vecmath_test.cpp) run on the port's
vector, transform and bounds math (utils/vecmath.py), tolerances
unchanged; random inputs from numpy generators seeded as the reference's."""
import numpy as np
import torch

from acceleratedvolrenderer_tpu_torch.utils import vecmath as vm

CPU = "cpu"


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_normalize_dot_cross():
    n = vm.normalize(_t([[3.0, 0.0, 4.0], [0.0, 2.0, 0.0]]))
    np.testing.assert_allclose(vm.length(n).numpy(), [1.0, 1.0], atol=1e-6)
    a, b = _t([1.0, 0.0, 0.0]), _t([0.0, 1.0, 0.0])
    np.testing.assert_allclose(vm.cross(a, b).numpy(), [0.0, 0.0, 1.0],
                               atol=1e-7)
    assert float(vm.dot(a, b)) == 0.0
    assert float(vm.absdot(a, -a)) == 1.0
    assert float(vm.distance(a, b)) == np.float32(np.sqrt(2.0))


def test_coordinate_system_orthonormal():
    rng = np.random.default_rng(1)
    v = vm.normalize(_t(rng.normal(size=(128, 3))))
    t, b = vm.coordinate_system(v)
    for x, y in ((t, v), (b, v), (t, b)):
        np.testing.assert_allclose(vm.dot(x, y).numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(vm.length(t).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(vm.length(b).numpy(), 1.0, atol=1e-5)


def test_local_frame_roundtrip():
    rng = np.random.default_rng(2)
    z = vm.normalize(_t(rng.normal(size=(16, 3))))
    x, y, zz = vm.frame_from_z(z)
    w = vm.normalize(_t(rng.normal(size=(16, 3))))
    w2 = vm.from_local(x, y, zz, vm.to_local(x, y, zz, w))
    np.testing.assert_allclose(w2.numpy(), w.numpy(), atol=1e-5)
    # spherical angles of the local direction give it back
    wl = vm.to_local(x, y, zz, w)
    back = vm.spherical_direction(torch.sin(vm.spherical_theta(wl)),
                                  torch.cos(vm.spherical_theta(wl)),
                                  vm.spherical_phi(wl))
    np.testing.assert_allclose(back.numpy(), wl.numpy(), atol=1e-5)
    assert float(vm.spherical_phi(wl).min()) >= 0.0


def test_transform_compose_inverse():
    t = (vm.translate([1.0, 2.0, 3.0], CPU) @ vm.rotate(37.0, [0.0, 1.0, 0.0],
                                                        CPU)
         @ vm.scale(2.0, CPU))
    p = _t([0.5, -1.0, 2.0])
    back = t.inverse().apply_point(t.apply_point(p))
    np.testing.assert_allclose(back.numpy(), p.numpy(), atol=1e-5)
    np.testing.assert_allclose((t.m @ t.m_inv).numpy(), np.eye(4), atol=1e-5)
    m = vm.transform_from_matrix(t.m.numpy(), CPU)
    np.testing.assert_allclose((m.m @ m.m_inv).numpy(), np.eye(4), atol=1e-5)
    ident = vm.identity_transform(CPU)
    np.testing.assert_array_equal(ident.apply_point(p).numpy(), p.numpy())


def test_look_at():
    t = vm.look_at([0, 0, -5], [0, 0, 0], [0, 1, 0], CPU)
    np.testing.assert_allclose(t.apply_vector(_t([0.0, 0.0, 1.0])).numpy(),
                               [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(t.apply_point(_t([0.0, 0.0, 0.0])).numpy(),
                               [0, 0, -5], atol=1e-6)
    # camera space -> NDC: a point on the optical axis maps to x = y = 0
    persp = vm.perspective(60.0, CPU)
    q = persp.apply_point(_t([0.0, 0.0, 10.0]))
    np.testing.assert_allclose(q.numpy()[:2], 0.0, atol=1e-6)


def test_intersect_aabb():
    o = _t([[-2.0, 0.5, 0.5], [0.5, 0.5, 0.5], [-2.0, 5.0, 0.5]])
    d = _t([[1.0, 0.0, 0.0]] * 3)
    hit, t0, t1 = vm.intersect_aabb(o, d, torch.tensor(torch.inf),
                                    torch.zeros(3), torch.ones(3))
    assert bool(hit[0]) and bool(hit[1]) and not bool(hit[2])
    np.testing.assert_allclose(float(t0[0]), 2.0, atol=1e-5)
    np.testing.assert_allclose(float(t1[0]), 3.0, rtol=1e-5)
    np.testing.assert_allclose(float(t0[1]), 0.0, atol=1e-6)
    bb = vm.bounds_union(vm.Bounds3(torch.zeros(3), torch.ones(3)),
                         vm.Bounds3(_t([-1, 0.5, 0.5]), _t([0.5, 2, 0.5])))
    assert bb.contains(o).tolist() == [False, True, False]
    np.testing.assert_allclose(bb.offset(_t([0.0, 1.0, 0.5])).numpy(),
                               [0.5, 0.5, 0.5])


def test_equal_area_square_to_sphere():
    rng = np.random.default_rng(3)
    v = vm.equal_area_square_to_sphere(_t(rng.random((256, 2))))
    np.testing.assert_allclose(vm.length(v).numpy(), 1.0, atol=1e-4)
