"""Shapes and the primitive list: batched closest-hit intersection and
uniform-area sampling (port of acceleratedvolrenderer_tpu/models/shapes.py).

A shape keeps its geometry as numpy arrays and floats, as the reference
does; the float32 tensors it intersects with are made on the rays' device
at first use and kept per device (`_on`), so a render loop does not copy
them to the card on every call.

Every shape provides:
  intersect(o, d, t_max) -> (t, n, uv)   batched closest hit (t inf: none)
  area() -> float                        total surface area
  sample(u2) -> (p, n, pdf_area)         uniform-area point sampling
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..utils import vecmath as vm
from ..utils.device import per_device as _on
from ..utils.math import safe_sqrt

_EPS = 1e-4


class Hit(NamedTuple):
    t: torch.Tensor        # (N,) inf where no hit
    n: torch.Tensor        # (N, 3) geometric normal
    prim_id: torch.Tensor  # (N,) int64, -1 where none
    uv: torch.Tensor       # (N, 2) surface parameterization


def _f32(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _tmax(t_max, o):
    """t_max as a float32 tensor on o's device (a number filled there)."""
    if isinstance(t_max, torch.Tensor):
        return t_max
    return torch.full((), float(t_max), dtype=torch.float32, device=o.device)


def _norm(v):
    return torch.sqrt(vm.dot(v, v))


@dataclass(frozen=True)
class Sphere:
    center: np.ndarray
    radius: float
    material: Optional[object] = None    # None: medium interface (invisible)

    def intersect(self, o, d, t_max):
        c = _on(self, o.device, lambda dev: _f32(self.center, dev))
        oc = o - c
        b = vm.dot(oc, d)
        cq = vm.length_squared(oc) - self.radius ** 2
        disc = b * b - cq
        sq = safe_sqrt(disc)
        t0 = -b - sq
        t1 = -b + sq
        t = torch.where(t0 > _EPS, t0, torch.where(t1 > _EPS, t1, torch.inf))
        t = torch.where((disc >= 0) & (t < t_max), t, torch.inf)
        p = o + t[..., None] * d
        n = vm.normalize(p - c)
        # spherical uv (pbrt: phi / 2pi, theta / pi)
        phi = torch.atan2(n[..., 1], n[..., 0])
        u = (phi / (2 * np.pi)) % 1.0
        v = torch.acos(torch.clamp(n[..., 2], -1, 1)) / np.pi
        return t, n, torch.stack([u, v], -1)

    def area(self) -> float:
        return float(4.0 * np.pi * self.radius ** 2)

    def sample(self, u2):
        z = 1.0 - 2.0 * u2[..., 0]
        r = safe_sqrt(1.0 - z * z)
        phi = 2.0 * np.pi * u2[..., 1]
        n = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
        p = _on(self, u2.device, lambda dev: _f32(self.center, dev)) \
            + self.radius * n
        pdf = torch.full(u2.shape[:-1], 1.0 / self.area(), device=u2.device)
        return p, n, pdf


@dataclass(frozen=True)
class Quad:
    """Parallelogram: origin + edges e1, e2 (pbrt BilinearPatch, planar)."""
    origin: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    material: Optional[object] = None

    def _consts(self, device):
        def make(dev):
            p0, e1, e2 = (_f32(a, dev) for a in (self.origin, self.e1,
                                                 self.e2))
            n = vm.cross(e1, e2)
            nn = n / torch.clamp(_norm(n), min=1e-24)
            a11, a12, a22 = vm.dot(e1, e1), vm.dot(e1, e2), vm.dot(e2, e2)
            return p0, e1, e2, nn, a11, a12, a22, a11 * a22 - a12 * a12
        return _on(self, device, make)

    def intersect(self, o, d, t_max):
        p0, e1, e2, nn, a11, a12, a22, det = self._consts(o.device)
        denom = vm.dot(d, nn)
        t = vm.dot(p0 - o, nn) / torch.where(torch.abs(denom) > 1e-9, denom,
                                             1e-9)
        p = o + t[..., None] * d
        rel = p - p0
        b1 = vm.dot(rel, e1)
        b2 = vm.dot(rel, e2)
        u = (a22 * b1 - a12 * b2) / det
        v = (a11 * b2 - a12 * b1) / det
        ok = ((torch.abs(denom) > 1e-9) & (t > _EPS) & (t < t_max)
              & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1))
        t = torch.where(ok, t, torch.inf)
        return t, nn.expand(o.shape), torch.stack([u, v], -1)

    def area(self) -> float:
        return float(np.linalg.norm(np.cross(self.e1, self.e2)))

    def sample(self, u2):
        p0, e1, e2, nn = self._consts(u2.device)[:4]
        p = p0 + u2[..., 0:1] * e1 + u2[..., 1:2] * e2
        pdf = torch.full(u2.shape[:-1], 1.0 / self.area(), device=u2.device)
        return p, nn.expand(p.shape), pdf


@dataclass(frozen=True)
class Disk:
    """Disk at `center` with unit `normal`, radius (pbrt shapes.h:426)."""
    center: np.ndarray
    normal: np.ndarray
    radius: float
    inner_radius: float = 0.0
    material: Optional[object] = None

    def _frame(self, device):
        def make(dev):
            n = np.asarray(self.normal, np.float64)
            n = n / np.linalg.norm(n)
            up = (np.array([0.0, 0.0, 1.0]) if abs(n[2]) < 0.9
                  else np.array([1.0, 0.0, 0.0]))
            t1 = np.cross(up, n)
            t1 /= np.linalg.norm(t1)
            t2 = np.cross(n, t1)
            return (_f32(t1, dev), _f32(t2, dev), _f32(n, dev),
                    _f32(self.center, dev))
        return _on(self, device, make)

    def intersect(self, o, d, t_max):
        t1, t2, nn, c = self._frame(o.device)
        denom = vm.dot(d, nn)
        t = vm.dot(c - o, nn) / torch.where(torch.abs(denom) > 1e-9, denom,
                                            1e-9)
        p = o + t[..., None] * d
        rel = p - c
        r2 = vm.length_squared(rel)
        ok = ((torch.abs(denom) > 1e-9) & (t > _EPS) & (t < t_max)
              & (r2 <= self.radius ** 2) & (r2 >= self.inner_radius ** 2))
        t = torch.where(ok, t, torch.inf)
        u = vm.dot(rel, t1) / self.radius * 0.5 + 0.5
        v = vm.dot(rel, t2) / self.radius * 0.5 + 0.5
        return t, nn.expand(o.shape), torch.stack([u, v], -1)

    def area(self) -> float:
        return float(np.pi * (self.radius ** 2 - self.inner_radius ** 2))

    def sample(self, u2):
        t1, t2, nn, c = self._frame(u2.device)
        r = torch.sqrt(self.inner_radius ** 2 + u2[..., 0]
                       * (self.radius ** 2 - self.inner_radius ** 2))
        phi = 2.0 * np.pi * u2[..., 1]
        p = c + r[..., None] * (torch.cos(phi)[..., None] * t1
                                + torch.sin(phi)[..., None] * t2)
        pdf = torch.full(u2.shape[:-1], 1.0 / self.area(), device=u2.device)
        return p, nn.expand(p.shape), pdf


def _perp1(axis):
    up = torch.tensor([0.0, 0.0, 1.0] if abs(float(axis[2])) < 0.9
                      else [1.0, 0.0, 0.0], device=axis.device)
    t = vm.cross(up, axis)
    return t / torch.clamp(_norm(t), min=1e-12)


@dataclass(frozen=True)
class Cylinder:
    """Open cylinder from p0 to p1 with radius (pbrt shapes.h:596)."""
    p0: np.ndarray
    p1: np.ndarray
    radius: float
    material: Optional[object] = None

    def _height(self) -> float:
        return float(np.linalg.norm(np.asarray(self.p1, np.float64)
                                    - np.asarray(self.p0, np.float64)))

    def _consts(self, device):
        def make(dev):
            a = (np.asarray(self.p1, np.float64)
                 - np.asarray(self.p0, np.float64))
            axis = _f32(a / np.linalg.norm(a), dev)
            t1 = _perp1(axis)
            return axis, _f32(self.p0, dev), t1, vm.cross(axis, t1)
        return _on(self, device, make)

    def intersect(self, o, d, t_max):
        axis, pa, t1v, t2v = self._consts(o.device)
        h = self._height()
        oc = o - pa
        d_par = vm.dot(d, axis)
        oc_par = vm.dot(oc, axis)
        d_perp = d - d_par[..., None] * axis
        oc_perp = oc - oc_par[..., None] * axis
        a = vm.length_squared(d_perp)
        b = vm.dot(d_perp, oc_perp)
        c = vm.length_squared(oc_perp) - self.radius ** 2
        disc = b * b - a * c
        sq = safe_sqrt(disc)
        inv_a = 1.0 / torch.clamp(a, min=1e-12)
        t0 = (-b - sq) * inv_a
        t1 = (-b + sq) * inv_a
        z0 = oc_par + t0 * d_par
        z1 = oc_par + t1 * d_par
        ok0 = (t0 > _EPS) & (z0 >= 0) & (z0 <= h)
        ok1 = (t1 > _EPS) & (z1 >= 0) & (z1 <= h)
        t = torch.where(ok0, t0, torch.where(ok1, t1, torch.inf))
        t = torch.where((disc >= 0) & (a > 1e-12) & (t < t_max), t,
                        torch.inf)
        p = o + t[..., None] * d
        z = vm.dot(p - pa, axis)
        rel = p - pa - z[..., None] * axis
        n = vm.normalize(rel)
        phi = torch.atan2(vm.dot(rel, t2v), vm.dot(rel, t1v))
        uv = torch.stack([(phi / (2 * np.pi)) % 1.0, z / h], -1)
        return t, n, uv

    def area(self) -> float:
        return float(2.0 * np.pi * self.radius * self._height())

    def sample(self, u2):
        axis, pa, t1, t2 = self._consts(u2.device)
        phi = 2.0 * np.pi * u2[..., 0]
        z = u2[..., 1] * self._height()
        n = torch.cos(phi)[..., None] * t1 + torch.sin(phi)[..., None] * t2
        p = pa + z[..., None] * axis + self.radius * n
        pdf = torch.full(u2.shape[:-1], 1.0 / self.area(), device=u2.device)
        return p, n, pdf


@dataclass(frozen=True)
class Box:
    lo: np.ndarray
    hi: np.ndarray
    material: Optional[object] = None

    def _consts(self, device):
        def make(dev):
            lo, hi = _f32(self.lo, dev), _f32(self.hi, dev)
            return lo, hi, (lo + hi) * 0.5, (hi - lo) * 0.5
        return _on(self, device, make)

    def intersect(self, o, d, t_max):
        lo, hi, c, h = self._consts(o.device)
        t_max = _tmax(t_max, o)
        hit, t0, t1 = vm.intersect_aabb(o, d, t_max, lo, hi)
        t = torch.where(hit & (t0 > _EPS), t0,
                        torch.where(hit & (t1 > _EPS), t1, torch.inf))
        p = o + t[..., None] * d
        # face normal: the axis of the largest |offset| in half-extents
        rel = (p - c) / torch.clamp(h, min=1e-24)
        ax = torch.argmax(torch.abs(rel), dim=-1)
        n = (torch.sign(torch.gather(rel, -1, ax[..., None]))
             * torch.eye(3, device=o.device)[ax])
        uv = torch.clamp((rel[..., :2] + 1.0) * 0.5, 0.0, 1.0)
        return t, n, uv

    def area(self) -> float:
        e = np.asarray(self.hi, np.float64) - np.asarray(self.lo, np.float64)
        return float(2.0 * (e[0] * e[1] + e[1] * e[2] + e[0] * e[2]))

    def sample(self, u2):
        # uniform over the 6 faces, weighted by face area
        lo = np.asarray(self.lo, np.float64)
        hi = np.asarray(self.hi, np.float64)
        e = hi - lo
        areas = np.array([e[1] * e[2], e[1] * e[2], e[0] * e[2],
                          e[0] * e[2], e[0] * e[1], e[0] * e[1]])
        cdf = np.cumsum(areas / areas.sum())
        dev = u2.device
        u0 = u2[..., 0]
        face = torch.clamp(torch.searchsorted(_f32(cdf, dev),
                                              u0.contiguous()), 0, 5)
        lo_t, hi_t = _f32(lo, dev), _f32(hi, dev)
        cdf_t = torch.cat([torch.zeros((1,), device=dev), _f32(cdf, dev)])
        u0r = (u0 - cdf_t[face]) / torch.clamp(cdf_t[face + 1] - cdf_t[face],
                                               min=1e-12)
        normals = torch.tensor([[-1, 0, 0], [1, 0, 0], [0, -1, 0],
                                [0, 1, 0], [0, 0, -1], [0, 0, 1]],
                               dtype=torch.float32, device=dev)
        n = normals[face]
        axis = face // 2
        hi_side = (face % 2) == 1
        free = torch.stack([u0r, u2[..., 1]], -1)
        cols = [torch.zeros(u2.shape[:-1], device=dev) for _ in range(3)]
        for ax in range(3):
            sel = axis == ax
            cols[ax] = torch.where(sel, torch.where(hi_side, hi_t[ax],
                                                    lo_t[ax]), cols[ax])
            for k, oax in enumerate(a for a in range(3) if a != ax):
                v = lo_t[oax] + free[..., k] * (hi_t[oax] - lo_t[oax])
                cols[oax] = torch.where(sel, v, cols[oax])
        pdf = torch.full(u2.shape[:-1], 1.0 / self.area(), device=dev)
        return torch.stack(cols, -1), n, pdf


@dataclass(frozen=True)
class TriangleMesh:
    """Indexed triangle mesh: batched Moller-Trumbore over triangle chunks,
    or at or above `grid_threshold` triangles the uniform-grid traversal of
    ops/trigrid.py."""
    vertices: np.ndarray           # (V, 3) float32
    indices: np.ndarray            # (T, 3) int32
    material: Optional[object] = None
    uvs: Optional[np.ndarray] = None   # (V, 2) optional vertex uvs
    chunk: int = 256
    grid_threshold: int = 512

    def _tris(self, device):
        def make(dev):
            v = np.asarray(self.vertices, np.float32)
            idx = np.asarray(self.indices, np.int32)
            p0 = v[idx[:, 0]]
            return (_f32(p0, dev), _f32(v[idx[:, 1]] - p0, dev),
                    _f32(v[idx[:, 2]] - p0, dev),
                    torch.as_tensor(idx.astype(np.int64), device=dev),
                    None if self.uvs is None else _f32(self.uvs, dev))
        return _on(self, device, make)

    def _grid(self, device):
        from ..ops import trigrid

        return _on(self, ("grid", str(device)), lambda _: trigrid.build_tri_grid(
            self.vertices, self.indices, device=device))

    def _shade(self, best_t, tri, bu, bv, device):
        """Normal and uv of the hit triangles (both routes)."""
        _, e1, e2, idx, uvv = self._tris(device)
        n = vm.normalize(vm.cross(e1[tri], e2[tri]))
        if uvv is not None:
            uv = ((1 - bu - bv)[:, None] * uvv[idx[tri, 0]]
                  + bu[:, None] * uvv[idx[tri, 1]]
                  + bv[:, None] * uvv[idx[tri, 2]])
        else:
            uv = torch.stack([bu, bv], -1)
        return best_t, n, uv

    def intersect(self, o, d, t_max):
        dev = o.device
        N = o.shape[0]
        t_max = torch.broadcast_to(_tmax(t_max, o), (N,))
        T = np.asarray(self.indices).shape[0]
        if T >= self.grid_threshold:
            from ..ops import trigrid

            bt, tri_id, bu, bv = trigrid.intersect_grid(self._grid(dev), o, d,
                                                        t_max)
            return self._shade(bt, torch.clamp(tri_id, min=0), bu, bv, dev)
        p0, e1, e2 = self._tris(dev)[:3]
        C = min(self.chunk, T)
        best_t = torch.full((N,), torch.inf, device=dev)
        best_tri = torch.full((N,), -1, dtype=torch.int64, device=dev)
        best_u = torch.zeros((N,), device=dev)
        best_v = torch.zeros((N,), device=dev)
        for base in range(0, T, C):
            tp0, te1, te2 = (a[base:base + C] for a in (p0, e1, e2))
            if tp0.shape[0] < C:     # the reference pads the last chunk
                pad = torch.zeros((C - tp0.shape[0], 3), device=dev)
                tp0, te1, te2 = (torch.cat([a, pad]) for a in (tp0, te1, te2))
            # Moller-Trumbore: rays (N, 1, 3) x triangles (1, C, 3)
            h = vm.cross(d[:, None, :], te2[None, :, :])
            a = vm.dot(te1[None], h)
            inv_a = 1.0 / torch.where(torch.abs(a) > 1e-12, a, 1e-12)
            s = o[:, None, :] - tp0[None]
            u = vm.dot(s, h) * inv_a
            q = vm.cross(s, te1[None])
            v = vm.dot(d[:, None, :], q) * inv_a
            t = vm.dot(te2[None], q) * inv_a
            ok = ((torch.abs(a) > 1e-12) & (u >= 0) & (v >= 0)
                  & (u + v <= 1) & (t > _EPS) & (t < t_max[:, None]))
            t = torch.where(ok, t, torch.inf)
            ct, ci = torch.min(t, dim=1)
            cu = torch.gather(u, 1, ci[:, None])[:, 0]
            cv = torch.gather(v, 1, ci[:, None])[:, 0]
            closer = ct < best_t
            best_t = torch.where(closer, ct, best_t)
            best_tri = torch.where(closer, base + ci, best_tri)
            best_u = torch.where(closer, cu, best_u)
            best_v = torch.where(closer, cv, best_v)
        return self._shade(best_t, torch.clamp(best_tri, 0, T - 1), best_u,
                           best_v, dev)

    def _areas(self):
        v = np.asarray(self.vertices, np.float64)
        idx = np.asarray(self.indices, np.int64)
        e1 = v[idx[:, 1]] - v[idx[:, 0]]
        e2 = v[idx[:, 2]] - v[idx[:, 0]]
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)

    def area(self) -> float:
        return float(self._areas().sum())

    def sample(self, u2):
        dev = u2.device
        areas = self._areas()
        cdf = np.cumsum(areas / areas.sum()).astype(np.float32)
        cdf_t = _f32(cdf, dev)
        tri = torch.clamp(torch.searchsorted(cdf_t, u2[..., 0].contiguous()),
                          0, len(areas) - 1)
        cdf0 = torch.cat([torch.zeros((1,), device=dev), cdf_t])
        u0r = (u2[..., 0] - cdf0[tri]) / torch.clamp(cdf0[tri + 1]
                                                     - cdf0[tri], min=1e-12)
        # uniform barycentrics (square-root warp)
        su = safe_sqrt(u0r)
        b0 = 1.0 - su
        b1 = u2[..., 1] * su
        v = _f32(self.vertices, dev)
        idx = self._tris(dev)[3]
        p0, p1, p2 = v[idx[tri, 0]], v[idx[tri, 1]], v[idx[tri, 2]]
        p = (b0[..., None] * p0 + b1[..., None] * p1
             + (1 - b0 - b1)[..., None] * p2)
        n = vm.normalize(vm.cross(p1 - p0, p2 - p0))
        pdf = torch.full(u2.shape[:-1], 1.0 / self.area(), device=dev)
        return p, n, pdf


@dataclass(frozen=True)
class BilinearPatch:
    """Bilinear patch over corners p00, p10, p01, p11 (shapes.h
    BilinearPatch): p(u, v) = lerp(v, lerp(u, p00, p10), lerp(u, p01,
    p11)); the ray-patch quadratic in u, then v and t on the u-isoline."""
    p00: np.ndarray
    p10: np.ndarray
    p01: np.ndarray
    p11: np.ndarray
    material: Optional[object] = None

    def _corners(self, device):
        return _on(self, device, lambda dev: tuple(
            _f32(a, dev) for a in (self.p00, self.p10, self.p01, self.p11)))

    def intersect(self, o, d, t_max):
        p00, p10, p01, p11 = self._corners(o.device)
        e10 = p10 - p00
        e01 = p01 - p00
        qn = vm.cross(e10, p01 - p11)
        a = vm.dot(qn, d)
        pd0 = p00 - o
        pd1 = p10 - o
        c = vm.dot(vm.cross(pd0, d), e01)
        b = vm.dot(vm.cross(pd1, d), p11 - p10) - (a + c)
        disc = b * b - 4 * a * c
        ok = disc >= 0
        sq = safe_sqrt(disc)
        qq = -0.5 * (b + torch.where(b >= 0, sq, -sq))
        lin = torch.abs(a) < 1e-12
        u1 = torch.where(lin, -c / torch.where(torch.abs(b) > 1e-12, b, 1e-12),
                         qq / torch.where(torch.abs(a) > 1e-12, a, 1e-12))
        u2 = torch.where(lin, torch.inf,
                         c / torch.where(torch.abs(qq) > 1e-12, qq, 1e-12))

        def eval_u(u):
            pa = p00 + u[..., None] * e10
            pb = p01 + u[..., None] * (p11 - p01)
            eab = pb - pa
            n2 = vm.cross(eab, d)
            den = vm.dot(n2, n2)
            rel = o - pa
            den_c = torch.where(den > 1e-20, den, 1e-20)
            v = vm.dot(vm.cross(rel, d), n2) / den_c
            t = vm.dot(vm.cross(rel, eab), n2) / den_c
            valid = ((u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
                     & (t > _EPS) & (den > 1e-20))
            return torch.where(valid, t, torch.inf), v

        t_a, v_a = eval_u(torch.clamp(u1, -1e6, 1e6))
        t_b, v_b = eval_u(torch.clamp(u2, -1e6, 1e6))
        pick_a = t_a <= t_b
        t = torch.where(pick_a, t_a, t_b)
        u = torch.where(pick_a, u1, u2)
        v = torch.where(pick_a, v_a, v_b)
        t = torch.where(ok & (t < t_max), t, torch.inf)
        dpdu = (1 - v)[..., None] * e10 + v[..., None] * (p11 - p01)
        dpdv = (1 - u)[..., None] * e01 + u[..., None] * (p11 - p10)
        n = vm.normalize(vm.cross(dpdu, dpdv))
        return t, n, torch.stack([torch.clamp(u, 0, 1),
                                  torch.clamp(v, 0, 1)], -1)

    def area(self) -> float:
        p00, p10, p01, p11 = [np.asarray(x, np.float64)
                              for x in (self.p00, self.p10, self.p01,
                                        self.p11)]
        a1 = 0.5 * np.linalg.norm(np.cross(p10 - p00, p01 - p00))
        a2 = 0.5 * np.linalg.norm(np.cross(p11 - p10, p01 - p10))
        return float(a1 + a2)

    def sample(self, u2):
        p00, p10, p01, p11 = self._corners(u2.device)
        u = u2[..., 0:1]
        v = u2[..., 1:2]
        p = ((1 - v) * ((1 - u) * p00 + u * p10)
             + v * ((1 - u) * p01 + u * p11))
        dpdu = (1 - v) * (p10 - p00) + v * (p11 - p01)
        dpdv = (1 - u) * (p01 - p00) + u * (p11 - p10)
        n = vm.normalize(vm.cross(dpdu, dpdv))
        pdf = torch.full(u2.shape[:-1], 1.0 / max(self.area(), 1e-12),
                         device=u2.device)
        return p, n, pdf


@dataclass(frozen=True)
class Curve:
    """Swept-sphere curve (shapes.h Curve): a cubic Bezier spine with
    linearly interpolated width, intersected as n_seg capsules."""
    cp: np.ndarray          # (4, 3) Bezier control points
    width0: float = 0.01
    width1: float = 0.01
    material: Optional[object] = None
    n_seg: int = 16

    def _polyline(self):
        ts = np.linspace(0.0, 1.0, self.n_seg + 1)
        cp = np.asarray(self.cp, np.float64)
        pts = np.stack([
            ((1 - t) ** 3 * cp[0] + 3 * (1 - t) ** 2 * t * cp[1]
             + 3 * (1 - t) * t ** 2 * cp[2] + t ** 3 * cp[3]) for t in ts])
        ws = (1 - ts) * self.width0 + ts * self.width1
        return pts.astype(np.float32), ws.astype(np.float32)

    def intersect(self, o, d, t_max):
        pts, ws = self._polyline()
        pts_t = _on(self, o.device, lambda dev: _f32(pts, dev))
        t_best = torch.full(o.shape[:-1], torch.inf, device=o.device)
        n_best = torch.zeros_like(o)
        u_best = torch.zeros(o.shape[:-1], device=o.device)
        for i in range(self.n_seg):
            a = pts_t[i]
            ab = pts_t[i + 1] - a
            r = float(0.5 * (ws[i] + ws[i + 1])) * 0.5
            ab2 = max(float(np.dot(pts[i + 1] - pts[i], pts[i + 1] - pts[i])),
                      1e-12)
            ao = o - a
            # the infinite cylinder's quadratic, then the axis parameter
            # clamped to the segment
            dn = d - (vm.dot(d, ab) / ab2)[..., None] * ab
            on = ao - (vm.dot(ao, ab) / ab2)[..., None] * ab
            A = vm.dot(dn, dn)
            B = 2.0 * vm.dot(dn, on)
            C = vm.dot(on, on) - r * r
            disc = B * B - 4 * A * C
            sq = safe_sqrt(disc)
            t0 = (-B - sq) / torch.where(torch.abs(A) > 1e-12, 2 * A, 1e-12)
            hit_p = o + t0[..., None] * d
            s = vm.dot(hit_p - a, ab) / ab2
            valid = ((disc >= 0) & (t0 > _EPS) & (s >= 0.0) & (s <= 1.0)
                     & (t0 < t_max))
            t0 = torch.where(valid, t0, torch.inf)
            closer = t0 < t_best
            sc = torch.clamp(s, 0, 1)
            nrm = vm.normalize(hit_p - (a + sc[..., None] * ab))
            t_best = torch.where(closer, t0, t_best)
            n_best = torch.where(closer[..., None], nrm, n_best)
            u_best = torch.where(closer, (i + sc) / self.n_seg, u_best)
        return t_best, n_best, torch.stack([u_best, torch.zeros_like(u_best)],
                                           -1)

    def area(self) -> float:
        pts, ws = self._polyline()
        seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
        return float((seg * 0.5 * (ws[:-1] + ws[1:]) * np.pi).sum())

    def sample(self, u2):
        # uniform along the spine (curves are rarely emitters)
        pts, _ = self._polyline()
        pts_t = _on(self, u2.device, lambda dev: _f32(pts, dev))
        s = u2[..., 0] * self.n_seg
        i = torch.clamp(s.to(torch.int64), 0, self.n_seg - 1)
        frac = s - i
        a, b = pts_t[i], pts_t[i + 1]
        p = a + frac[..., None] * (b - a)
        n = torch.stack([torch.zeros_like(frac), torch.zeros_like(frac),
                         torch.ones_like(frac)], -1)
        pdf = torch.full(u2.shape[:-1], 1.0 / max(self.area(), 1e-12),
                         device=u2.device)
        return p, n, pdf


def intersect_all(prims: List, o, d, t_max):
    """Closest hit over the primitive list (a branch-free min-reduce)."""
    n_rays = o.shape[0]
    dev = o.device
    best_t = torch.full((n_rays,), torch.inf, device=dev)
    best_n = torch.zeros((n_rays, 3), device=dev)
    best_id = torch.full((n_rays,), -1, dtype=torch.int64, device=dev)
    best_uv = torch.zeros((n_rays, 2), device=dev)
    for i, prim in enumerate(prims):
        t, nrm, uv = prim.intersect(o, d, t_max)
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best_n = torch.where(closer[:, None], nrm, best_n)
        best_id = torch.where(closer, i, best_id)
        best_uv = torch.where(closer[:, None], uv, best_uv)
    return Hit(best_t, best_n, best_id, best_uv)


def occluded(prims: List, o, d, dist):
    """Any hit of a shadow ray against the opaque primitives."""
    blocked = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    for prim in prims:
        if prim.material is None:
            continue  # a medium interface does not block light
        t, _, _ = prim.intersect(o, d, dist)
        blocked = blocked | torch.isfinite(t)
    return blocked
