"""Cameras, batched primary rays (port of
acceleratedvolrenderer_tpu/models/cameras.py: PerspectiveCamera,
OrthographicCamera, SphericalCamera, RealisticCamera, load_lens_file and
SIMPLE_LENS).

pbrt's fov convention: the field of view spans the shorter image axis.
Every camera is a NamedTuple with generate_rays(pxy, u_film) -> world-space
(o, d) with unit d, and to(device), which moves its transform."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.warps import sample_uniform_disk_concentric
from ..utils.vecmath import Transform, equal_area_square_to_sphere, normalize


class PerspectiveCamera(NamedTuple):
    c2w: Transform          # camera-to-world, tensors on the render device
    fov_deg: float          # field of view of the shorter image axis
    width: int
    height: int

    def to(self, device):
        return self._replace(c2w=self.c2w.to(device))

    def generate_rays(self, pxy, u_film):
        """pxy: (N, 2) integer pixel coords; u_film: (N, 2) offsets.
        Returns world-space (o, d) with unit d."""
        w, h = self.width, self.height
        tan_half = float(np.tan(np.deg2rad(self.fov_deg) / 2.0))
        aspect = w / h
        if aspect > 1.0:
            sx, sy = tan_half * aspect, tan_half
        else:
            sx, sy = tan_half, tan_half / aspect
        px = (pxy[..., 0] + u_film[..., 0]) / w
        py = (pxy[..., 1] + u_film[..., 1]) / h
        x_cam = (2.0 * px - 1.0) * sx
        y_cam = (1.0 - 2.0 * py) * sy
        d_cam = torch.stack([x_cam, y_cam, torch.ones_like(x_cam)], dim=-1)
        o_w = self.c2w.apply_point(torch.zeros_like(d_cam))
        d_w = normalize(self.c2w.apply_vector(d_cam))
        return o_w, d_w

    def _screen_half_extents(self):
        # np.tan on the host: the card's tan is an ulp off the CPU's
        tan_half = float(np.tan(np.deg2rad(self.fov_deg) / 2.0))
        aspect = self.width / self.height
        if aspect > 1.0:
            return tan_half * aspect, tan_half
        return tan_half, tan_half / aspect

    def film_area_z1(self) -> float:
        """Area of the image window on the z=1 camera plane: the A of the
        perspective importance We = 1 / (A cos^4 theta)."""
        sx, sy = self._screen_half_extents()
        return float(4.0 * sx * sy)

    def project(self, p_world):
        """World points (N, 3) -> (raster xy (N, 2) float, cos theta against
        the camera's forward axis, inside the frustum): the camera end of a
        light-tracing connection (pbrt's PerspectiveCamera::SampleWi)."""
        pc = self.c2w.inverse().apply_point(p_world)
        z = pc[..., 2]
        ok_z = z > 1e-6
        zs = torch.where(ok_z, z, 1.0)
        x_cam = pc[..., 0] / zs
        y_cam = pc[..., 1] / zs
        sx, sy = self._screen_half_extents()
        px = (x_cam / sx + 1.0) * 0.5 * self.width
        py = (1.0 - y_cam / sy) * 0.5 * self.height
        inside = (ok_z & (px >= 0) & (px < self.width)
                  & (py >= 0) & (py < self.height))
        dist = torch.linalg.norm(pc, dim=-1)
        cos_t = torch.where(dist > 0, z / torch.clamp(dist, min=1e-12), 0.0)
        return torch.stack([px, py], -1), cos_t, inside

    @property
    def position(self):
        """The pinhole in world space, (3,)."""
        return self.c2w.apply_point(torch.zeros((3,), device=self.c2w.m.device))


class OrthographicCamera(NamedTuple):
    c2w: Transform
    screen_scale: float     # half-extent of the screen window, short axis
    width: int
    height: int

    def to(self, device):
        return self._replace(c2w=self.c2w.to(device))

    def generate_rays(self, pxy, u_film):
        w, h = self.width, self.height
        aspect = w / h
        sx = self.screen_scale * (aspect if aspect > 1 else 1.0)
        sy = self.screen_scale * (1.0 if aspect > 1 else 1.0 / aspect)
        px = (pxy[..., 0] + u_film[..., 0]) / w
        py = (pxy[..., 1] + u_film[..., 1]) / h
        o_cam = torch.stack([(2 * px - 1) * sx, (1 - 2 * py) * sy,
                             torch.zeros_like(px)], dim=-1)
        d_cam = torch.zeros_like(o_cam)
        d_cam[..., 2] = 1.0
        return (self.c2w.apply_point(o_cam),
                normalize(self.c2w.apply_vector(d_cam)))


class SphericalCamera(NamedTuple):
    """Equal-area spherical capture: the film is the equal-area square."""
    c2w: Transform
    width: int
    height: int

    def to(self, device):
        return self._replace(c2w=self.c2w.to(device))

    def generate_rays(self, pxy, u_film):
        w, h = self.width, self.height
        uv = torch.stack([(pxy[..., 0] + u_film[..., 0]) / w,
                          (pxy[..., 1] + u_film[..., 1]) / h], dim=-1)
        d_cam = equal_area_square_to_sphere(uv)
        o_cam = torch.zeros_like(d_cam)
        return (self.c2w.apply_point(o_cam),
                normalize(self.c2w.apply_vector(d_cam)))


def _unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


class RealisticCamera(NamedTuple):
    """Lens-system camera (pbrt's RealisticCamera): rays go from the film
    through a stack of spherical interfaces (rows of curvature radius,
    thickness, ior, aperture radius in meters, film to scene), refracting
    at each and clipped by each aperture.  A vignetted ray comes back as
    origin 1e8, direction +z (a black sample), in place of pbrt's
    exit-pupil resampling."""
    c2w: Transform
    elements: np.ndarray        # (E, 4), film to scene
    width: int
    height: int
    film_diag: float = 0.035    # meters (35mm)
    rear_offset: float = 0.0    # film -> first element distance

    def to(self, device):
        return self._replace(c2w=self.c2w.to(device))

    def generate_rays(self, pxy, u_film, u_lens=None):
        w, h = self.width, self.height
        aspect = w / h
        fh = self.film_diag / np.sqrt(1 + aspect * aspect)
        fw = fh * aspect
        px = (pxy[..., 0] + u_film[..., 0]) / w
        py = (pxy[..., 1] + u_film[..., 1]) / h
        # film plane at z = 0; the lens stack extends toward +z
        x_f = (0.5 - px) * fw
        y_f = (py - 0.5) * fh
        n = px.shape[0]
        dev = px.device
        o = torch.stack([x_f, y_f, torch.zeros_like(x_f)], -1)
        if u_lens is None:
            u_lens = torch.full((n, 2), 0.5, device=dev)
        lens_p = sample_uniform_disk_concentric(u_lens) * float(
            self.elements[0, 3])
        z0 = self.rear_offset
        target = torch.cat([lens_p, torch.full_like(lens_p[..., :1], z0)],
                           -1)
        d = _unit(target - o)
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
        z = z0
        eta_prev = 1.0
        for i in range(self.elements.shape[0]):
            rad = float(self.elements[i, 0])
            thick = float(self.elements[i, 1])
            eta = float(self.elements[i, 2]) or 1.0
            ap = float(self.elements[i, 3])
            if rad == 0.0:
                # aperture stop: advance to its plane, clip
                t = (z - o[..., 2]) / torch.where(
                    torch.abs(d[..., 2]) > 1e-9, d[..., 2], 1e-9)
                p = o + t[..., None] * d
                r2 = p[..., 0] ** 2 + p[..., 1] ** 2
                valid = valid & (r2 <= ap * ap) & (t > 0)
                o = p
            else:
                # sphere centred on the axis at z + rad
                c = torch.tensor([0.0, 0.0, z + rad], dtype=torch.float32,
                                 device=dev)
                oc = o - c
                b = torch.sum(oc * d, -1)
                cc = torch.sum(oc * oc, -1) - rad * rad
                disc = b * b - cc
                sq = torch.sqrt(torch.clamp(disc, min=0.0))
                use_closer = (d[..., 2] > 0) ^ (rad < 0)
                t = torch.where(use_closer, -b - sq, -b + sq)
                p = o + t[..., None] * d
                r2 = p[..., 0] ** 2 + p[..., 1] ** 2
                valid = valid & (disc >= 0) & (r2 <= ap * ap) & (t > 0)
                nrm = (p - c) / rad
                nrm = torch.where((torch.sum(nrm * d, -1) > 0)[..., None],
                                  -nrm, nrm)
                # refract d about nrm from eta_prev to eta
                ratio = eta_prev / eta
                cos_i = -torch.sum(d * nrm, -1)
                sin2_t = ratio * ratio * torch.clamp(1 - cos_i * cos_i,
                                                     min=0.0)
                tir = sin2_t > 1.0
                cos_t = torch.sqrt(torch.clamp(1 - sin2_t, min=0.0))
                d = _unit(ratio * d + (ratio * cos_i - cos_t)[..., None] * nrm)
                valid = valid & ~tir
                o = p
                eta_prev = eta
            z += thick
        o_w = self.c2w.apply_point(o)
        d_w = normalize(self.c2w.apply_vector(d))
        d_w = torch.where(valid[..., None], d_w,
                          torch.tensor([0.0, 0.0, 1.0], device=dev))
        o_w = torch.where(valid[..., None], o_w,
                          torch.full((3,), 1e8, device=dev))
        return o_w, d_w


def load_lens_file(path: str) -> np.ndarray:
    """pbrt .dat lens file: rows of curvature_radius thickness eta
    aperture_diameter (mm); returns (E, 4) meters with the aperture
    radius, film to scene."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) == 4:
                rows.append(vals)
    e = np.asarray(rows, np.float64)
    e[:, 0] *= 1e-3        # radius mm -> m
    e[:, 1] *= 1e-3        # thickness
    e[:, 3] *= 0.5e-3      # diameter mm -> radius m
    # pbrt lens files list the elements scene to film
    return e[::-1].copy()


# a simple double-convex + stop + meniscus prescription, the default and
# the tests' lens
SIMPLE_LENS = np.array([
    #  radius(m) thick(m)  eta   ap_radius(m)
    [0.0350, 0.0020, 1.5168, 0.0130],
    [-0.2350, 0.0045, 1.0, 0.0130],
    [0.0, 0.0040, 1.0, 0.0090],       # stop
    [0.0420, 0.0025, 1.5168, 0.0110],
    [-0.0500, 0.0300, 1.0, 0.0110],
], np.float64)
