"""Vector / transform / bounds math on [..., 3] tensors
(port of acceleratedvolrenderer_tpu/utils/vecmath.py).

Dot products and 3x3 products are written as explicit multiply-adds in a
fixed order, like the reference, so float32 results do not depend on a
library's reduction order.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .math import safe_sqrt


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def absdot(a, b):
    return torch.abs(dot(a, b))


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def length_squared(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(dot(v, v))


def normalize(v):
    return v / torch.clamp(length(v)[..., None], min=1e-24)


def distance(a, b):
    return length(a - b)


def face_forward(n, v):
    """Flip n so it lies in the same hemisphere as v."""
    return torch.where((dot(n, v) < 0.0)[..., None], -n, n)


def coordinate_system(v):
    """Orthonormal basis (t, b) completing unit v (Duff et al. 2017)."""
    sign = torch.where(v[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + v[..., 2])
    b = v[..., 0] * v[..., 1] * a
    t = torch.stack(
        [1.0 + sign * v[..., 0] * v[..., 0] * a, sign * b, -sign * v[..., 0]],
        dim=-1)
    bt = torch.stack([b, sign + v[..., 1] * v[..., 1] * a, -v[..., 1]], dim=-1)
    return t, bt


def spherical_direction(sin_theta, cos_theta, phi):
    sin_theta = torch.clamp(sin_theta, -1.0, 1.0)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta],
        dim=-1)


def spherical_theta(v):
    return torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + 2.0 * np.pi, p)


def frame_from_z(z):
    x, y = coordinate_system(z)
    return x, y, z


def to_local(x, y, z, v):
    return torch.stack([dot(v, x), dot(v, y), dot(v, z)], dim=-1)


def from_local(x, y, z, v):
    return v[..., 0:1] * x + v[..., 1:2] * y + v[..., 2:3] * z


class Transform(NamedTuple):
    """(4, 4) float32 matrix and its inverse, on the render device."""
    m: torch.Tensor
    m_inv: torch.Tensor

    @staticmethod
    def from_numpy(m, m_inv, device):
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                         device=device)
        return Transform(as_t(m), as_t(m_inv))

    def to(self, device):
        return Transform(self.m.to(device), self.m_inv.to(device))

    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    def inverse(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def _mat3_vec(self, m, v):
        return (v[..., 0:1] * m[:3, 0] + v[..., 1:2] * m[:3, 1]
                + v[..., 2:3] * m[:3, 2])

    def apply_point(self, p):
        r = self._mat3_vec(self.m, p) + self.m[:3, 3]
        w = (p[..., 0] * self.m[3, 0] + p[..., 1] * self.m[3, 1]
             + p[..., 2] * self.m[3, 2] + self.m[3, 3])
        return r / w[..., None]

    def apply_vector(self, v):
        return self._mat3_vec(self.m, v)

    def apply_normal(self, n):
        """Normals transform by the inverse transpose."""
        m = self.m_inv
        return (n[..., 0:1] * m[0, :3] + n[..., 1:2] * m[1, :3]
                + n[..., 2:3] * m[2, :3])

    def apply_ray(self, o, d):
        return self.apply_point(o), self.apply_vector(d)


def identity_transform(device) -> Transform:
    return Transform.from_numpy(np.eye(4), np.eye(4), device)


def translate(delta, device) -> Transform:
    delta = np.asarray(delta, np.float32)
    m, mi = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    m[:3, 3] = delta
    mi[:3, 3] = -delta
    return Transform.from_numpy(m, mi, device)


def scale(s, device) -> Transform:
    s = np.broadcast_to(np.asarray(s, np.float32), (3,))
    m = np.diag(np.concatenate([s, [1.0]]).astype(np.float32))
    mi = np.diag(np.concatenate([1.0 / s, [1.0]]).astype(np.float32))
    return Transform.from_numpy(m, mi, device)


def rotate(angle_deg: float, axis, device) -> Transform:
    """Rotation by angle_deg about `axis` (pbrt Rotate)."""
    m = rotate_matrix(angle_deg, axis)
    return Transform.from_numpy(m, m.T, device)


def perspective(fov_deg: float, device, z_near: float = 1e-2,
                z_far: float = 1000.0) -> Transform:
    """Camera-to-NDC projective transform (pbrt Perspective,
    cameras.cpp)."""
    persp = np.zeros((4, 4))
    persp[0, 0] = persp[1, 1] = 1.0
    persp[2, 2] = z_far / (z_far - z_near)
    persp[2, 3] = -z_far * z_near / (z_far - z_near)
    persp[3, 2] = 1.0
    inv_tan = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    m = np.diag([inv_tan, inv_tan, 1.0, 1.0]) @ persp
    return Transform.from_numpy(m, np.linalg.inv(m), device)


def transform_from_matrix(m, device) -> Transform:
    m = np.asarray(m, np.float64).reshape(4, 4)
    return Transform.from_numpy(m, np.linalg.inv(m), device)


def look_at_matrix(eye, look, up) -> np.ndarray:
    """(4, 4) float64 camera-to-world matrix of pbrt's LookAt
    (left-handed, +z forward)."""
    eye = np.asarray(eye, np.float64)
    d = np.asarray(look, np.float64) - eye
    d = d / np.linalg.norm(d)
    up = np.asarray(up, np.float64)
    right = np.cross(up / np.linalg.norm(up), d)
    nr = np.linalg.norm(right)
    if nr < 1e-12:
        raise ValueError("LookAt: up vector parallel to viewing direction")
    right = right / nr
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = np.cross(d, right)
    c2w[:3, 2] = d
    c2w[:3, 3] = eye
    return c2w


def look_at(eye, look, up, device) -> Transform:
    """Camera-to-world transform (pbrt LookAt: left-handed, +z forward)."""
    c2w = look_at_matrix(eye, look, up)
    return Transform.from_numpy(c2w, np.linalg.inv(c2w), device)


def rotate_matrix(angle_deg: float, axis) -> np.ndarray:
    """(4, 4) float64 rotation by angle_deg about `axis` (pbrt Rotate)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    theta = np.deg2rad(angle_deg)
    s, c = np.sin(theta), np.cos(theta)
    m = np.eye(4)
    x, y, z = a
    m[0, 0] = x * x + (1 - x * x) * c
    m[0, 1] = x * y * (1 - c) - z * s
    m[0, 2] = x * z * (1 - c) + y * s
    m[1, 0] = x * y * (1 - c) + z * s
    m[1, 1] = y * y + (1 - y * y) * c
    m[1, 2] = y * z * (1 - c) - x * s
    m[2, 0] = x * z * (1 - c) - y * s
    m[2, 1] = y * z * (1 - c) + x * s
    m[2, 2] = z * z + (1 - z * z) * c
    return m


class Bounds3(NamedTuple):
    """Axis-aligned bounds: (..., 3) lower and upper corners."""
    lo: torch.Tensor
    hi: torch.Tensor

    @property
    def diagonal(self):
        return self.hi - self.lo

    def offset(self, p):
        """Continuous [0,1]^3 coordinates of p inside the bounds."""
        return (p - self.lo) / torch.clamp(self.hi - self.lo, min=1e-24)

    def lerp_point(self, t):
        return self.lo + t * (self.hi - self.lo)

    def contains(self, p):
        return torch.all((p >= self.lo) & (p <= self.hi), dim=-1)


def bounds_union(a: Bounds3, b: Bounds3) -> Bounds3:
    return Bounds3(torch.minimum(a.lo, b.lo), torch.maximum(a.hi, b.hi))


def intersect_aabb(o, d, t_max, lo, hi):
    """Slab-test ray/AABB intersection -> (hit, t0, t1), t0 clamped >= 0.
    lo / hi are python sequences of 3 floats."""
    inv_d = 1.0 / d
    t_lo = torch.stack([(lo[i] - o[..., i]) * inv_d[..., i] for i in range(3)],
                       dim=-1)
    t_hi = torch.stack([(hi[i] - o[..., i]) * inv_d[..., i] for i in range(3)],
                       dim=-1)
    t_near = torch.minimum(t_lo, t_hi)
    t_far = torch.maximum(t_lo, t_hi)
    t_near = torch.where(torch.isnan(t_near), -torch.inf, t_near)
    t_far = torch.where(torch.isnan(t_far), torch.inf, t_far)
    t0 = torch.amax(t_near, dim=-1)
    t1 = torch.amin(t_far, dim=-1)
    t1 = t1 * (1.0 + 4.0 * float(np.finfo(np.float32).eps))
    hit = (t0 <= t1) & (t1 > 0.0) & (t0 < t_max)
    t0 = torch.clamp(t0, min=0.0)
    return hit, t0, torch.minimum(t1, t_max)


def equal_area_square_to_sphere(p):
    """Low-distortion [0,1]^2 -> S^2 mapping (Clarberg 2008); p (..., 2)."""
    u = 2.0 * p[..., 0] - 1.0
    v = 2.0 * p[..., 1] - 1.0
    up = torch.abs(u)
    vp = torch.abs(v)
    sd = 1.0 - (up + vp)
    d = torch.abs(sd)
    r = 1.0 - d
    phi = torch.where(r == 0.0, 1.0,
                      (vp - up) / torch.clamp(r, min=1e-24) + 1.0) * (
        np.pi / 4.0)
    z = torch.copysign(1.0 - r * r, sd)
    cos_phi = torch.copysign(torch.cos(phi), u)
    sin_phi = torch.copysign(torch.sin(phi), v)
    rr = r * safe_sqrt(2.0 - r * r)
    return torch.stack([cos_phi * rr, sin_phi * rr, z], dim=-1)
