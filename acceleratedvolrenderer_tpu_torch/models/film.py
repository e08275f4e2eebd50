"""Film filters, sample accumulation, sensors and EXR output
(port of acceleratedvolrenderer_tpu/models/film.py: GaussianFilter, BoxFilter,
TriangleFilter, Film, write_film, white_balance_matrix, PixelSensor and
SpectralFilm)."""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils import colorspace
from ..utils import image
from ..utils import spectrum as sp
from ..utils.math import exact_div


class GaussianFilter(NamedTuple):
    radius: float = 1.5
    sigma: float = 0.5

    def sample_offset(self, u):
        """Inverse-CDF sample of the truncated Gaussian per axis; u (..., 2)
        -> offset (..., 2) in [-radius, radius] with constant weight."""
        r, s = self.radius, self.sigma
        c = math.erf(r / (s * math.sqrt(2.0)))
        x = torch.special.erfinv((2.0 * u - 1.0) * c) * (s * np.sqrt(2.0))
        return torch.clamp(x, -r, r)


class BoxFilter(NamedTuple):
    radius: float = 0.5

    def sample_offset(self, u):
        return (u - 0.5) * (2.0 * self.radius)


class TriangleFilter(NamedTuple):
    radius: float = 2.0

    def sample_offset(self, u):
        """Tent sampling by its inverse CDF."""
        t = 2.0 * u - 1.0
        off = torch.sign(t) * (1.0 - torch.sqrt(
            torch.clamp(1.0 - torch.abs(t), min=0.0)))
        return off * self.radius


class Film(NamedTuple):
    """Accumulation state: (H, W, 3) rgb sum and (H, W) weight sum."""
    rgb_sum: torch.Tensor
    weight_sum: torch.Tensor

    @staticmethod
    def create(height: int, width: int, device):
        f32 = torch.float32
        return Film(torch.zeros((height, width, 3), dtype=f32, device=device),
                    torch.zeros((height, width), dtype=f32, device=device))

    def add_samples(self, pixel_xy, L, swl, weight=None,
                    max_component=math.inf):
        """Accumulate spectral radiance samples (RGBFilm::AddSample): sensor
        RGB clamped to `max_component`, then a weighted scatter-add over
        flat pixel indices.  pixel_xy (N, 2) integer, -1 or out of frame =
        dropped.  Out of place, so autograd can run through it."""
        rgb = colorspace.xyz_to_rgb(sp.to_xyz(L, swl))
        m = torch.amax(rgb, dim=-1)
        scale = torch.where(m > max_component,
                            max_component / torch.clamp(m, min=1e-24), 1.0)
        rgb = torch.nan_to_num(rgb * scale[..., None], nan=0.0, posinf=0.0,
                               neginf=0.0)
        w = (torch.ones(rgb.shape[0], dtype=rgb.dtype, device=rgb.device)
             if weight is None else weight)
        x, y = pixel_xy[:, 0].long(), pixel_xy[:, 1].long()
        H, W = self.weight_sum.shape
        ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        wm = torch.where(ok, w, 0.0)
        flat = torch.where(ok, y * W + x, 0)
        rgb_sum = self.rgb_sum.reshape(-1, 3).index_add(
            0, flat, rgb * wm[:, None]).reshape(H, W, 3)
        weight_sum = self.weight_sum.reshape(-1).index_add(
            0, flat, wm).reshape(H, W)
        return Film(rgb_sum, weight_sum)

    def to_image(self):
        return self.rgb_sum / torch.clamp(self.weight_sum, min=1e-12)[..., None]


def write_film(path, film_img, render_time=None, spp=None, mse=None, w2c=None):
    """Write an (H, W, 3) image (tensor or array) as EXR with pbrt
    metadata."""
    if isinstance(film_img, torch.Tensor):
        film_img = film_img.detach().cpu().numpy()
    md = image.ImageMetadata(
        render_time_seconds=render_time, samples_per_pixel=spp, mse=mse,
        world_to_camera=w2c,
    )
    image.write_exr(path, np.asarray(film_img), md)


# ---------------------------------------------------------------------------
# PixelSensor: spectral radiance -> sensor RGB -> XYZ, with white balance
# ---------------------------------------------------------------------------

_BRADFORD = np.array([
    [0.8951, 0.2664, -0.1614],
    [-0.7502, 1.7135, 0.0367],
    [0.0389, -0.0685, 1.0296],
], np.float64)


def _xy_to_xyz(xy):
    x, y = float(xy[0]), float(xy[1])
    return np.array([x / y, 1.0, (1.0 - x - y) / y], np.float64)


def white_balance_matrix(src_xy, dst_xy):
    """3x3 XYZ -> XYZ chromatic adaptation, von Kries in Bradford LMS
    (WhiteBalance, util/color.cpp), as float32."""
    src = _BRADFORD @ _xy_to_xyz(src_xy)
    dst = _BRADFORD @ _xy_to_xyz(dst_xy)
    scale = np.diag(dst / src)
    return (np.linalg.inv(_BRADFORD) @ scale @ _BRADFORD).astype(np.float32)


# 24 training swatches: Macbeth-chart sRGB values lifted to smooth spectra
# by the Smits basis, used only to fit the 3x3 sensor matrix by least
# squares (in place of film.cpp's measured swatch reflectances)
_SWATCH_RGBS = np.array([
    [0.45, 0.32, 0.27], [0.76, 0.58, 0.51], [0.37, 0.48, 0.61],
    [0.35, 0.42, 0.26], [0.52, 0.50, 0.69], [0.40, 0.74, 0.67],
    [0.84, 0.49, 0.17], [0.31, 0.36, 0.65], [0.76, 0.35, 0.39],
    [0.36, 0.23, 0.42], [0.62, 0.74, 0.25], [0.88, 0.64, 0.18],
    [0.22, 0.24, 0.59], [0.28, 0.58, 0.29], [0.69, 0.21, 0.23],
    [0.91, 0.78, 0.12], [0.73, 0.34, 0.58], [0.03, 0.52, 0.63],
    [0.95, 0.95, 0.95], [0.79, 0.79, 0.79], [0.63, 0.63, 0.63],
    [0.48, 0.48, 0.48], [0.33, 0.33, 0.33], [0.20, 0.20, 0.20],
], np.float32)


class PixelSensor:
    """Camera sensor (film.h:36): spectral samples to sensor RGB by the
    response curves, then to XYZ by a 3x3 matrix fitted by least squares
    over training swatches (film.h:45-80).  The default sensor is the CIE
    1931 observer with the identity matrix (pbrt's CreateDefault);
    `sensor_illum_xy` adds the Bradford adaptation from that illuminant to
    `out_illum_xy`.  response: lam (..., L) -> (..., L, 3)."""

    def __init__(self, response=None, imaging_ratio: float = 1.0,
                 sensor_illum_xy=None, out_illum_xy=(0.3127, 0.3290)):
        self.response = response
        self.imaging_ratio = float(imaging_ratio)
        if response is None and sensor_illum_xy is None:
            self.xyz_from_rgb = np.eye(3, dtype=np.float32)
            return
        lam = torch.as_tensor(np.linspace(sp.LAMBDA_MIN, sp.LAMBDA_MAX, 95),
                              dtype=torch.float32)
        resp = self._resp(lam).numpy()                        # (95, 3)
        cie = sp.cie_xyz(lam).numpy()
        sw = sp.rgb_to_spectrum_smits_batched(
            torch.as_tensor(_SWATCH_RGBS),
            lam.expand(24, 95)).numpy()                       # (24, 95)
        rgb_cam = sw @ resp
        rgb_cam /= np.maximum((np.ones(95) @ resp)[None, 1], 1e-9)
        xyz_out = sw @ cie
        xyz_out /= np.maximum((np.ones(95) @ cie)[None, 1], 1e-9)
        m, *_ = np.linalg.lstsq(rgb_cam, xyz_out, rcond=None)
        self.xyz_from_rgb = m.T.astype(np.float32)
        if sensor_illum_xy is not None:
            self.xyz_from_rgb = (white_balance_matrix(sensor_illum_xy,
                                                      out_illum_xy)
                                 @ self.xyz_from_rgb)

    def _resp(self, lam):
        return sp.cie_xyz(lam) if self.response is None else self.response(lam)

    def to_sensor_rgb(self, L, swl):
        """Monte Carlo sensor RGB of spectral samples (ToSensorRGB,
        film.h:97)."""
        resp = self._resp(swl.lam)
        ok = swl.pdf > 0
        w = torch.where(ok, L / torch.where(ok, swl.pdf, 1.0), 0.0)
        rgb = torch.mean(w[..., None] * resp, dim=-2) / sp.CIE_Y_INTEGRAL
        return rgb * self.imaging_ratio

    def to_xyz(self, L, swl):
        return colorspace._mat3(self.to_sensor_rgb(L, swl),
                                self.xyz_from_rgb)


# ---------------------------------------------------------------------------
# SpectralFilm: accumulation per wavelength bucket (film.h:401)
# ---------------------------------------------------------------------------

class SpectralFilm(NamedTuple):
    """RGB accumulation plus `n_buckets` equal wavelength bands over
    [lambda_min, lambda_max] (SpectralFilm, film.h:401): each spectral
    sample lands in its band with its pdf-normalized value.  Channels are
    named as the reference's ("C01_0360.00nm-0389.38nm", ...)."""
    rgb_sum: torch.Tensor        # (H, W, 3)
    weight_sum: torch.Tensor     # (H, W)
    bucket_sum: torch.Tensor     # (H, W, B)
    bucket_w: torch.Tensor       # (H, W, B)
    lambda_min: float
    lambda_max: float

    @staticmethod
    def create(height, width, n_buckets=16, lambda_min=360.0,
               lambda_max=830.0, *, device):
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=device)
        return SpectralFilm(z(height, width, 3), z(height, width),
                            z(height, width, n_buckets),
                            z(height, width, n_buckets),
                            float(lambda_min), float(lambda_max))

    def add_samples(self, pixel_xy, L, swl, weight=None,
                    max_component=math.inf):
        base = Film(self.rgb_sum, self.weight_sum).add_samples(
            pixel_xy, L, swl, weight=weight, max_component=max_component)
        H, W, B = self.bucket_sum.shape
        x, y = pixel_xy[:, 0].long(), pixel_xy[:, 1].long()
        ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        b = torch.clamp((exact_div(swl.lam - self.lambda_min,
                                   self.lambda_max - self.lambda_min) * B)
                        .to(torch.int64), 0, B - 1)           # (N, L)
        pos = swl.pdf > 0
        val = torch.where(pos, L / torch.where(pos, swl.pdf, 1.0), 0.0)
        val = torch.nan_to_num(val, nan=0.0, posinf=0.0, neginf=0.0)
        wm = torch.where(ok, 1.0, 0.0)[:, None].expand_as(val)
        flat = (torch.where(ok, y * W + x, 0)[:, None] * B + b).reshape(-1)
        bucket_sum = self.bucket_sum.reshape(-1).index_add(
            0, flat, (val * wm).reshape(-1)).reshape(H, W, B)
        bucket_w = self.bucket_w.reshape(-1).index_add(
            0, flat, wm.reshape(-1)).reshape(H, W, B)
        return SpectralFilm(base.rgb_sum, base.weight_sum, bucket_sum,
                            bucket_w, self.lambda_min, self.lambda_max)

    def to_image(self):
        return Film(self.rgb_sum, self.weight_sum).to_image()

    def bucket_images(self):
        return self.bucket_sum / torch.clamp(self.bucket_w, min=1e-12)

    def channel_names(self):
        B = self.bucket_sum.shape[-1]
        edges = np.linspace(self.lambda_min, self.lambda_max, B + 1)
        return [f"C{i + 1:02d}_{edges[i]:07.2f}nm-{edges[i + 1]:07.2f}nm"
                for i in range(B)]

    def write(self, path, render_time=None, spp=None):
        """An EXR of R, G, B and the bucket images."""
        chans = torch.cat([self.to_image(), self.bucket_images()], -1)
        md = image.ImageMetadata(render_time_seconds=render_time,
                                 samples_per_pixel=spp)
        image.write_exr(path, chans.detach().cpu().numpy(), md,
                        channel_names=tuple(["R", "G", "B"]
                                            + self.channel_names()))
