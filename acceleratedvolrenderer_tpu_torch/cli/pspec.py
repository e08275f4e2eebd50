"""pspec: power spectra of the samplers (port of
acceleratedvolrenderer_tpu/cli/pspec.py; cmd/pspec.cpp).

Accumulates the Fourier power spectrum of a sampler's 2D point sets over
independent realizations, prints its radial average and optionally writes
it as an EXR.  Blue-noise samplers (zsobol, pmj02bn) show a deficit of
low-frequency energy.

    python -m acceleratedvolrenderer_tpu_torch.cli.pspec zsobol --cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..models import samplers
from ..utils.device import resolve


def power_spectrum(kind: str, n_points: int, res: int, n_sets: int,
                   seed: int = 0, device=None):
    """(res, res) float64 power spectrum averaged over n_sets point sets of
    n_points each; set t is pixel t's first n_points samples (seed + t),
    drawn on `device` (the CUDA card by default)."""
    dev = resolve(device)
    fx = np.fft.fftshift(np.fft.fftfreq(res, d=1.0 / res))
    FX, FY = np.meshgrid(fx, fx)
    acc = np.zeros((res, res), np.float64)
    sidx = torch.arange(n_points, dtype=torch.int64, device=dev)
    for trial in range(n_sets):
        u1, u2, _ = samplers.film_sample(
            kind, torch.full((n_points,), trial, dtype=torch.int64,
                             device=dev), sidx, n_points, seed=seed + trial)
        pts = np.stack([u1.cpu().numpy(), u2.cpu().numpy()], -1).astype(
            np.float64)
        # the continuous Fourier transform of the point set (pspec.cpp):
        # P(f) = |sum_j exp(-2 pi i f . x_j)|^2 / N
        phase = -2j * np.pi * (FX[..., None] * pts[:, 0]
                               + FY[..., None] * pts[:, 1])
        acc += np.abs(np.exp(phase).sum(-1)) ** 2 / n_points
    return acc / n_sets


def radial_average(spec: np.ndarray, n_bins: int = 32):
    res = spec.shape[0]
    yy, xx = np.mgrid[0:res, 0:res]
    r = np.hypot(xx - res / 2, yy - res / 2)
    bins = np.minimum((r / (res / 2) * n_bins).astype(int), n_bins - 1)
    out = np.zeros(n_bins)
    for b in range(n_bins):
        m = bins == b
        out[b] = spec[m].mean() if m.any() else 0.0
    return out


def main(argv=None):
    ap = argparse.ArgumentParser("avrt-torch-pspec")
    ap.add_argument("sampler", help="|".join(samplers.KINDS))
    ap.add_argument("--npoints", type=int, default=64)
    ap.add_argument("--resolution", type=int, default=64)
    ap.add_argument("--nsets", type=int, default=16)
    ap.add_argument("-o", "--outfile", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="draw the points on the CPU")
    args = ap.parse_args(argv)
    spec = power_spectrum(args.sampler, args.npoints, args.resolution,
                          args.nsets, device="cpu" if args.cpu else None)
    prof = radial_average(spec)
    for i, v in enumerate(prof):
        print(f"{i / len(prof):.3f} {v:.4f}")
    if args.outfile:
        from ..utils.image import write_exr

        write_exr(args.outfile, spec.astype(np.float32)[..., None],
                  channel_names=("Y",))
    return 0


if __name__ == "__main__":
    sys.exit(main())
