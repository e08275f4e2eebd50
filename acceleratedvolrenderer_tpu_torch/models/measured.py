"""Measured BRDFs: RGL (Dupuy & Jakob 2018) data-driven reflectance
(port of acceleratedvolrenderer_tpu/models/measured.py; pbrt bxdfs.h
MeasuredBxDF, bxdfs.cpp MeasuredBxDFData and its tensor_file reader, and
util/math.h PiecewiseLinear2D).

A measured BRDF stores, per incident direction (theta_i, phi_i), the
visible-NDF warp over the half-vector square (`vndf`), a second warp
toward the measured luminance (`luminance`), the spectral interpolant
(`spectra`) and the fitted NDF and projected area (`ndf`, `sigma`).
f = spectra(R^-1(wm), phi_o, theta_o, lambda) ndf(wm) / (4 sigma(wo)
cos(theta_i)).

As in the reference, each warp is a pair of cell-averaged CDF tables (numpy
at load), and Sample / Invert are fixed-step bisections over the whole
batch; the conditioning parameters blend the bracketing slices' CDFs
inside the bisection.  Sample, Invert and the pdf use the cell-averaged
(piecewise-constant) density, so they agree with each other exactly;
Evaluate keeps the reference's multilinear interpolation.  The tables go
to a device once, on first use there.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..utils.device import per_device

# ---------------------------------------------------------------------------
# tensor_file I/O (bxdfs.cpp Tensor)
# ---------------------------------------------------------------------------

_DTYPES = {
    1: np.uint8, 2: np.int8, 3: np.uint16, 4: np.int16, 5: np.uint32,
    6: np.int32, 7: np.uint64, 8: np.int64, 9: np.float16, 10: np.float32,
    11: np.float64,
}
_DTYPE_IDS = {np.dtype(v): k for k, v in _DTYPES.items()}


def read_tensor_file(path: str) -> dict:
    """An RGL 'tensor_file' (the .bsdf container) -> {name: ndarray}."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:12] != b"tensor_file\x00":
        raise ValueError(f"{path}: invalid tensor file header")
    ver = (data[12], data[13])
    if ver != (1, 0):
        raise ValueError(f"{path}: unsupported tensor file version {ver}")
    (n_fields,) = struct.unpack_from("<I", data, 14)
    pos = 18
    out = {}
    for _ in range(n_fields):
        (name_len,) = struct.unpack_from("<H", data, pos)
        pos += 2
        name = data[pos:pos + name_len].decode()
        pos += name_len
        ndim, dtype = struct.unpack_from("<HB", data, pos)
        pos += 3
        (offset,) = struct.unpack_from("<Q", data, pos)
        pos += 8
        shape = struct.unpack_from("<" + "Q" * ndim, data, pos)
        pos += 8 * ndim
        count = int(np.prod(shape)) if ndim else 1
        arr = np.frombuffer(data, _DTYPES[dtype], count, offset)
        out[name] = arr.reshape(shape).copy()
    return out


def write_tensor_file(path: str, fields: dict):
    """{name: ndarray} in the RGL tensor_file layout (read back by
    read_tensor_file and the reference's Tensor reader)."""
    header = bytearray(b"tensor_file\x00" + bytes([1, 0]))
    header += struct.pack("<I", len(fields))
    dir_size = 18
    for name in fields:
        dir_size += 2 + len(name.encode()) + 3 + 8 + 8 * fields[name].ndim
    blobs = []
    offset = dir_size
    for name, arr in fields.items():
        arr = np.ascontiguousarray(arr)
        nb = name.encode()
        header += struct.pack("<H", len(nb)) + nb
        header += struct.pack("<HB", arr.ndim, _DTYPE_IDS[arr.dtype])
        header += struct.pack("<Q", offset)
        for s in arr.shape:
            header += struct.pack("<Q", s)
        blobs.append(arr.tobytes())
        offset += len(blobs[-1])
    with open(path, "wb") as f:
        f.write(bytes(header))
        for b in blobs:
            f.write(b)


# ---------------------------------------------------------------------------
# the parameter-conditioned 2D warp
# ---------------------------------------------------------------------------

def _param_weights(values, x):
    """The bracketing index and lerp weight of a conditioning parameter;
    values a float32 tensor of the parameter's samples."""
    n = values.shape[0]
    if n == 1:
        return (torch.zeros(x.shape, dtype=torch.int64, device=x.device),
                torch.zeros(x.shape, dtype=torch.float32, device=x.device))
    i = torch.clamp(torch.searchsorted(values, x.contiguous(), right=True)
                    - 1, 0, n - 2)
    w = (x - values[i]) / torch.clamp(values[i + 1] - values[i], min=1e-9)
    return i, torch.clamp(w, 0.0, 1.0)


class PiecewiseLinear2D:
    """A 2D distribution over [0, 1]^2 conditioned on up to 3 parameters.

    data: (*param_sizes, ny, nx) vertex values, x fastest (pbrt's
    layout); kept as `data` with the parameter samples `params`.
    eval is the multilinear interpolation of the reference; sample and
    invert use the cell-averaged CDFs (see the module docstring)."""

    def __init__(self, data: np.ndarray, params: List[np.ndarray] = ()):
        data = np.asarray(data, np.float32)
        self.data = data
        self.params = [np.asarray(p, np.float32) for p in params]
        psizes = tuple(p.shape[0] for p in self.params)
        if data.shape[:len(psizes)] != psizes:
            raise ValueError(f"PiecewiseLinear2D: data {data.shape} does "
                             f"not match the parameters {psizes}")
        self.ny, self.nx = data.shape[-2], data.shape[-1]
        S = int(np.prod(psizes)) if psizes else 1
        vals = data.reshape(S, self.ny, self.nx).astype(np.float64)
        cell = np.maximum(0.25 * (vals[:, :-1, :-1] + vals[:, :-1, 1:]
                                  + vals[:, 1:, :-1] + vals[:, 1:, 1:]), 0.0)
        row = cell.sum(-1)                                   # (S, ny-1)
        self._host = dict(
            vals=vals.astype(np.float32), row_cdf=np.cumsum(row, -1),
            cond_cdf=np.cumsum(cell, -1),
            total=np.maximum(row.sum(-1), 1e-30))
        self._psizes = psizes

    def _t(self, device):
        """The tables as float32 tensors on `device`, flattened: vals,
        row_cdf, cond_cdf, total and the parameter samples."""
        def make(dev):
            t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                          device=dev)
            h = self._host
            return dict(vals=t(h["vals"]).reshape(-1),
                        row_cdf=t(h["row_cdf"]).reshape(-1),
                        cond_cdf=t(h["cond_cdf"]).reshape(-1),
                        total=t(h["total"]),
                        params=[t(p) for p in self.params])

        return per_device(self, device, make)

    def _slices(self, pvals: Tuple, tabs):
        """The bracketing slices' ids and weights (up to 8)."""
        if len(pvals) != len(self.params):
            raise ValueError("PiecewiseLinear2D: wrong parameter count")
        if not self.params:
            return [0], [1.0]
        idxs, wts = zip(*(_param_weights(p, x)
                          for p, x in zip(tabs["params"], pvals)))
        strides = [int(np.prod(self._psizes[j + 1:]))
                   for j in range(len(self._psizes))]
        sids, sws = [], []
        for bits in range(1 << len(self.params)):
            sid = 0
            w = 1.0
            for j in range(len(self.params)):
                hi = (bits >> j) & 1
                ij = torch.clamp(idxs[j] + hi, max=self._psizes[j] - 1)
                sid = sid + ij * strides[j]
                w = w * (wts[j] if hi else 1.0 - wts[j])
            sids.append(sid)
            sws.append(w)
        return sids, sws

    @staticmethod
    def _gather(arr_flat, sids, sws, inner, idx):
        """arr[sid, idx] blended over the bracketing slices."""
        out = 0.0
        for sid, w in zip(sids, sws):
            out = out + w * arr_flat[sid * inner + idx]
        return out

    def eval(self, u, pvals: Tuple = ()):
        """Multilinear interpolation (the reference's Evaluate)."""
        tabs = self._t(u.device)
        sids, sws = self._slices(pvals, tabs)
        x = torch.clamp(u[..., 0], 0.0, 1.0) * (self.nx - 1)
        y = torch.clamp(u[..., 1], 0.0, 1.0) * (self.ny - 1)
        x0 = torch.clamp(x.to(torch.int64), 0, self.nx - 2)
        y0 = torch.clamp(y.to(torch.int64), 0, self.ny - 2)
        fx, fy = x - x0, y - y0
        inner = self.ny * self.nx

        def at(dy, dx):
            return self._gather(tabs["vals"], sids, sws, inner,
                                (y0 + dy) * self.nx + (x0 + dx))

        return ((1 - fx) * (1 - fy) * at(0, 0) + fx * (1 - fy) * at(0, 1)
                + (1 - fx) * fy * at(1, 0) + fx * fy * at(1, 1))

    def _bisect(self, cdf_flat, sids, sws, inner, n, lo_idx, target):
        """The largest count c in [0, n] with cdf[c - 1] <= target (entry i
        is the mass of cells 0..i), clamped to [0, n - 1]."""
        lo = torch.zeros(target.shape, dtype=torch.int64,
                         device=target.device)
        hi = torch.full_like(lo, n)
        for _ in range(int(np.ceil(np.log2(max(n, 2)))) + 1):
            mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
            v = self._gather(cdf_flat, sids, sws, inner,
                             lo_idx + torch.clamp(mid - 1, min=0))
            below = (mid == 0) | (v <= target)
            lo = torch.where(below, mid, lo)
            hi = torch.where(below, hi, mid - 1)
        return torch.clamp(lo, 0, n - 1)

    def _total(self, tabs, sids, sws):
        total = 0.0
        for sid, w in zip(sids, sws):
            total = total + w * tabs["total"][sid]
        return total

    def _row_masses(self, tabs, sids, sws, r):
        """(the row cdf below row r, row r's mass)."""
        rc = tabs["row_cdf"]
        ny1 = self.ny - 1
        cdf_lo = torch.where(r > 0, self._gather(
            rc, sids, sws, ny1, torch.clamp(r - 1, min=0)), 0.0)
        return cdf_lo, self._gather(rc, sids, sws, ny1, r) - cdf_lo

    def sample(self, u2, pvals: Tuple = ()):
        """The warp of uniform u2 -> (p in [0, 1]^2, pdf in unit-square
        measure)."""
        tabs = self._t(u2.device)
        sids, sws = self._slices(pvals, tabs)
        ny1, nx1 = self.ny - 1, self.nx - 1
        rc, cc = tabs["row_cdf"], tabs["cond_cdf"]
        total = self._total(tabs, sids, sws)
        t_row = u2[..., 1] * total
        zero = torch.zeros(t_row.shape, dtype=torch.int64,
                           device=t_row.device)
        r = self._bisect(rc, sids, sws, ny1, ny1, zero, t_row)
        cdf_lo, row_mass = self._row_masses(tabs, sids, sws, r)
        fy = torch.clamp((t_row - cdf_lo)
                         / torch.clamp(row_mass, min=1e-20), 0, 1)
        y = (r + fy) / ny1

        t_col = u2[..., 0] * row_mass
        c = self._bisect(cc, sids, sws, ny1 * nx1, nx1, r * nx1, t_col)
        ccdf_lo = torch.where(c > 0, self._gather(
            cc, sids, sws, ny1 * nx1, r * nx1 + torch.clamp(c - 1, min=0)),
            0.0)
        cell_mass = self._gather(cc, sids, sws, ny1 * nx1,
                                 r * nx1 + c) - ccdf_lo
        fx = torch.clamp((t_col - ccdf_lo)
                         / torch.clamp(cell_mass, min=1e-20), 0, 1)
        x = (c + fx) / nx1
        pdf = cell_mass * (ny1 * nx1) / torch.clamp(total, min=1e-20)
        return torch.stack([x, y], -1), pdf

    def invert(self, p, pvals: Tuple = ()):
        """The inverse warp: position -> (uniform u2, pdf)."""
        tabs = self._t(p.device)
        sids, sws = self._slices(pvals, tabs)
        ny1, nx1 = self.ny - 1, self.nx - 1
        cc = tabs["cond_cdf"]
        total = self._total(tabs, sids, sws)
        y = torch.clamp(p[..., 1], 0.0, 1.0) * ny1
        x = torch.clamp(p[..., 0], 0.0, 1.0) * nx1
        r = torch.clamp(y.to(torch.int64), 0, ny1 - 1)
        c = torch.clamp(x.to(torch.int64), 0, nx1 - 1)
        fy, fx = y - r, x - c
        cdf_lo, row_mass = self._row_masses(tabs, sids, sws, r)
        u_y = (cdf_lo + fy * row_mass) / torch.clamp(total, min=1e-20)
        ccdf_lo = torch.where(c > 0, self._gather(
            cc, sids, sws, ny1 * nx1, r * nx1 + torch.clamp(c - 1, min=0)),
            0.0)
        cell_mass = self._gather(cc, sids, sws, ny1 * nx1,
                                 r * nx1 + c) - ccdf_lo
        u_x = (ccdf_lo + fx * cell_mass) / torch.clamp(row_mass, min=1e-20)
        pdf = cell_mass * (ny1 * nx1) / torch.clamp(total, min=1e-20)
        return (torch.stack([torch.clamp(u_x, 0, 1), torch.clamp(u_y, 0, 1)],
                            -1), pdf)


# ---------------------------------------------------------------------------
# MeasuredBxDF
# ---------------------------------------------------------------------------

def _theta2u(theta):
    return torch.sqrt(torch.clamp(theta * (2.0 / np.pi), min=0.0))


def _u2theta(u):
    return u * u * (np.pi / 2.0)


def _phi2u(phi):
    return phi * (1.0 / (2.0 * np.pi)) + 0.5


def _u2phi(u):
    return (2.0 * u - 1.0) * np.pi


@dataclass(frozen=True)
class MeasuredBRDF:
    """The loaded tables of a measured BRDF (MeasuredBxDFData)."""
    wavelengths: np.ndarray
    ndf: PiecewiseLinear2D
    sigma: PiecewiseLinear2D
    vndf: PiecewiseLinear2D
    luminance: PiecewiseLinear2D
    spectra: PiecewiseLinear2D
    isotropic: bool

    @staticmethod
    def from_tensors(t: dict) -> "MeasuredBRDF":
        phi_i = np.asarray(t["phi_i"], np.float32)
        theta_i = np.asarray(t["theta_i"], np.float32)
        wav = np.asarray(t["wavelengths"], np.float32)
        return MeasuredBRDF(
            wavelengths=wav,
            ndf=PiecewiseLinear2D(t["ndf"]),
            sigma=PiecewiseLinear2D(t["sigma"]),
            vndf=PiecewiseLinear2D(t["vndf"], [phi_i, theta_i]),
            luminance=PiecewiseLinear2D(t["luminance"], [phi_i, theta_i]),
            spectra=PiecewiseLinear2D(t["spectra"], [phi_i, theta_i, wav]),
            isotropic=phi_i.shape[0] <= 2,
        )

    @staticmethod
    def from_file(path: str) -> "MeasuredBRDF":
        return MeasuredBRDF.from_tensors(read_tensor_file(path))


def _spherical(w):
    theta = torch.arccos(torch.clamp(w[..., 2], -1.0, 1.0))
    phi = torch.atan2(w[..., 1], w[..., 0])
    return theta, phi


def _spectra_eval(brdf: MeasuredBRDF, u, phi_o, theta_o, lam):
    """The spectral interpolant at the wavelength lanes lam (..., L)."""
    return torch.stack([torch.clamp(brdf.spectra.eval(
        u, (phi_o, theta_o, lam[..., i])), min=0.0)
        for i in range(lam.shape[-1])], -1)


def _half_vector_uv(brdf, wo, wi):
    """(wm, |wo + wi|, theta_o, phi_o, u_wm): the half vector and its
    coordinates in the vndf's square (phi relative to phi_o when
    isotropic)."""
    wm = wi + wo
    wm_len = torch.linalg.vector_norm(wm, dim=-1, keepdim=True)
    wm = wm / torch.clamp(wm_len, min=1e-12)
    theta_o, phi_o = _spherical(wo)
    theta_m, phi_m = _spherical(wm)
    u_wm_y = _phi2u(phi_m - phi_o if brdf.isotropic else phi_m)
    u_wm_y = u_wm_y - torch.floor(u_wm_y)
    u_wm = torch.stack([_theta2u(theta_m), u_wm_y], -1)
    return wm, wm_len[..., 0], theta_o, phi_o, u_wm


def _upper(wo, wi):
    """wo, wi flipped into wo's upper hemisphere; and the same-side mask."""
    same = wo[..., 2] * wi[..., 2] > 0
    flip = (wo[..., 2] < 0)[..., None]
    return torch.where(flip, -wo, wo), torch.where(flip, -wi, wi), same


def measured_f(brdf: MeasuredBRDF, wo, wi, lam):
    """MeasuredBxDF::f: spectra(R^-1(wm)) ndf(wm) / (4 sigma(wo) cos)."""
    wo, wi, same = _upper(wo, wi)
    _, wm_len, theta_o, phi_o, u_wm = _half_vector_uv(brdf, wo, wi)
    u_wo = torch.stack([_theta2u(theta_o), _phi2u(phi_o)], -1)
    ui, _ = brdf.vndf.invert(u_wm, (phi_o, theta_o))
    fr = _spectra_eval(brdf, ui, phi_o, theta_o, lam)
    scale = (brdf.ndf.eval(u_wm) / torch.clamp(
        4.0 * brdf.sigma.eval(u_wo) * wi[..., 2], min=1e-9))
    ok = same & (wm_len > 0)
    return torch.where(ok[..., None], fr * scale[..., None], 0.0)


def measured_sample(brdf: MeasuredBRDF, wo, u2, lam):
    """MeasuredBxDF::Sample_f: the luminance warp, the vndf warp, a
    reflection about the half vector.  Returns (wi, f, pdf, valid)."""
    flip = (wo[..., 2] <= 0)[..., None]
    wo = torch.where(flip, -wo, wo)
    theta_o, phi_o = _spherical(wo)
    u_l, lum_pdf = brdf.luminance.sample(u2, (phi_o, theta_o))
    u_wm, pdf = brdf.vndf.sample(u_l, (phi_o, theta_o))
    phi_m = _u2phi(u_wm[..., 1])
    theta_m = _u2theta(u_wm[..., 0])
    if brdf.isotropic:
        phi_m = phi_m + phi_o
    st, ct = torch.sin(theta_m), torch.cos(theta_m)
    wm = torch.stack([st * torch.cos(phi_m), st * torch.sin(phi_m), ct], -1)
    wi = -wo + 2.0 * (wo * wm).sum(-1, keepdim=True) * wm
    valid = wi[..., 2] > 0
    fr = _spectra_eval(brdf, u_l, phi_o, theta_o, lam)
    u_wo = torch.stack([_theta2u(theta_o), _phi2u(phi_o)], -1)
    fr = fr * (brdf.ndf.eval(u_wm) / torch.clamp(
        4.0 * brdf.sigma.eval(u_wo) * torch.abs(wi[..., 2]),
        min=1e-9))[..., None]
    jac = 4.0 * (wo * wm).sum(-1) * torch.clamp(
        2.0 * np.pi ** 2 * u_wm[..., 0] * st, min=1e-6)
    pdf_out = pdf * lum_pdf / torch.clamp(jac, min=1e-9)
    wi = torch.where(flip, -wi, wi)
    return (wi, torch.where(valid[..., None], fr, 0.0),
            torch.where(valid, pdf_out, 0.0), valid)


def measured_pdf(brdf: MeasuredBRDF, wo, wi):
    """MeasuredBxDF::PDF: the vndf inverse's pdf times the luminance
    density over the jacobian."""
    wo, wi, same = _upper(wo, wi)
    wm, wm_len, theta_o, phi_o, u_wm = _half_vector_uv(brdf, wo, wi)
    ui, vndf_pdf = brdf.vndf.invert(u_wm, (phi_o, theta_o))
    # the luminance density at the unwarped point (by cell, as sample)
    _, lum_pdf = brdf.luminance.invert(ui, (phi_o, theta_o))
    sin_tm = torch.sqrt(torch.clamp(wm[..., 0] ** 2 + wm[..., 1] ** 2,
                                    min=0.0))
    jac = 4.0 * (wo * wm).sum(-1) * torch.clamp(
        2.0 * np.pi ** 2 * u_wm[..., 0] * sin_tm, min=1e-6)
    pdf = vndf_pdf * lum_pdf / torch.clamp(jac, min=1e-9)
    return torch.where(same & (wm_len > 0), pdf, 0.0)


# ---------------------------------------------------------------------------
# synthetic data: GGX-derived measured tables (tests, the chip check)
# ---------------------------------------------------------------------------

def synthesize_ggx(alpha: float = 0.3, res: int = 64, n_theta: int = 16,
                   reflectance: float = 1.0) -> MeasuredBRDF:
    """MeasuredBRDF tables from an analytic GGX microfacet model, the
    construction the RGL pipeline performs on measurements (Dupuy & Jakob
    2018 section 4); the spectra are filled through the vndf warp on the
    CPU."""
    theta_i = np.linspace(0, np.pi / 2 * 0.98, n_theta).astype(np.float32)
    phi_i = np.zeros((1,), np.float32)
    wav = np.array([400.0, 550.0, 700.0], np.float32)

    ut = (np.arange(res) / (res - 1)).astype(np.float64)      # theta coord
    up = (np.arange(res) / (res - 1)).astype(np.float64)      # phi coord
    th_m = ut ** 2 * np.pi / 2
    ph_m = (2 * up - 1) * np.pi
    stm, ctm = np.sin(th_m), np.cos(th_m)

    def D(ct):  # the GGX NDF
        ct2 = np.clip(ct, 0, 1) ** 2
        return np.where(ct > 0, alpha ** 2 / np.maximum(
            np.pi * (ct2 * (alpha ** 2 - 1) + 1) ** 2, 1e-12), 0.0)

    def Lambda(ct):
        ct = np.clip(ct, 1e-6, 1)
        t2 = (1 - ct ** 2) / ct ** 2
        return (np.sqrt(1 + alpha ** 2 * t2) - 1) / 2

    ndf = np.broadcast_to(D(ctm)[None, :], (res, res)).astype(np.float32)
    # sigma(wo) on the (u_theta, u_phi) grid of wo
    sig = np.zeros((res, res), np.float32)
    ct_o = np.cos(ut ** 2 * np.pi / 2)
    sig[:] = (ct_o / (1 + Lambda(ct_o)))[None, :]

    # the vndf slices: density over (u_phi, u_theta) with the warp jacobian
    vndf = np.zeros((1, n_theta, res, res), np.float32)
    lum = np.ones((1, n_theta, res, res), np.float32)
    spec = np.zeros((1, n_theta, len(wav), res, res), np.float32)
    jac = (2 * np.pi ** 2) * ut[None, :] * stm[None, :]       # du -> dw
    wm = np.stack([stm[None, :] * np.cos(ph_m[:, None]),
                   stm[None, :] * np.sin(ph_m[:, None]),
                   np.broadcast_to(ctm[None, :], (res, res))], -1)
    for k, t_o in enumerate(theta_i):
        wo = np.array([np.sin(t_o), 0.0, np.cos(t_o)])
        dot = np.clip(wm @ wo, 0.0, None)
        s = float(np.cos(t_o) / (1 + Lambda(np.cos(t_o))))
        dv = D(ctm)[None, :] * dot / max(s, 1e-9)
        vndf[0, k] = (dv * jac).astype(np.float32)
    vndf_w = PiecewiseLinear2D(vndf, [phi_i, theta_i])
    # spectra such that f == reflectance D G2 / (4 cos_o cos_i): spectra(u)
    # is reflectance G2(wo, wi(u)) sigma(wo) / cos_o
    uu = np.stack(np.meshgrid(ut, up, indexing="xy"), -1)      # (res,res,2)
    grid_u = torch.as_tensor(uu.reshape(-1, 2), dtype=torch.float32)
    for k, t_o in enumerate(theta_i):
        wo = np.array([np.sin(t_o), 0.0, np.cos(t_o)])
        po = torch.zeros((res * res,))
        to = torch.full((res * res,), float(t_o))
        u_wm = vndf_w.sample(grid_u, (po, to))[0].numpy()
        th = u_wm[:, 0] ** 2 * np.pi / 2
        ph = (2 * u_wm[:, 1] - 1) * np.pi
        wm_s = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                         np.cos(th)], -1)
        wi = -wo + 2 * (wm_s @ wo)[:, None] * wm_s
        g2 = 1.0 / (1 + Lambda(np.cos(t_o))
                    + Lambda(np.clip(wi[:, 2], 1e-6, 1)))
        g2 = np.where(wi[:, 2] > 0, g2, 0.0)
        s = float(np.cos(t_o) / (1 + Lambda(np.cos(t_o))))
        val = (reflectance * g2 * s
               / max(np.cos(t_o), 1e-6)).reshape(res, res)
        spec[0, k, :] = val.astype(np.float32)
    return MeasuredBRDF(
        wavelengths=wav,
        ndf=PiecewiseLinear2D(ndf),
        sigma=PiecewiseLinear2D(sig),
        vndf=vndf_w,
        luminance=PiecewiseLinear2D(lum, [phi_i, theta_i]),
        spectra=PiecewiseLinear2D(spec, [phi_i, theta_i, wav]),
        isotropic=True,
    )


def to_tensors(brdf: MeasuredBRDF, theta_i, phi_i, ndf, sigma, vndf,
               luminance, spectra) -> dict:
    """The raw arrays as a tensor_file field dict, with the description
    and jacobian fields the reference's reader expects."""
    return {
        "description": np.frombuffer(b"avrt synthetic measured brdf",
                                     np.uint8),
        "theta_i": np.asarray(theta_i, np.float32),
        "phi_i": np.asarray(phi_i, np.float32),
        "wavelengths": np.asarray(brdf.wavelengths, np.float32),
        "ndf": np.asarray(ndf, np.float32),
        "sigma": np.asarray(sigma, np.float32),
        "vndf": np.asarray(vndf, np.float32),
        "luminance": np.asarray(luminance, np.float32),
        "spectra": np.asarray(spectra, np.float32),
        "jacobian": np.zeros((1,), np.uint8),
    }


def tensors_of(brdf: MeasuredBRDF) -> dict:
    """to_tensors of a loaded or synthesized BRDF's own tables: what
    write_tensor_file needs to save it as a .bsdf file."""
    phi_i, theta_i = brdf.vndf.params
    return to_tensors(brdf, theta_i, phi_i, brdf.ndf.data, brdf.sigma.data,
                      brdf.vndf.data, brdf.luminance.data, brdf.spectra.data)
