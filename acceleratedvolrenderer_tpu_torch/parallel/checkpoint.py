"""Render checkpoint and resume (port of
acceleratedvolrenderer_tpu/parallel/checkpoint.py: save, load and
render_with_checkpoints).

The film accumulator (rgb_sum, weight_sum) and the next sample index
round-trip through an npz.  The RNG streams are keyed by (pixel, sample
index), so the waves a resumed render runs are the waves the uninterrupted
one would have run, and on the same device its final image is the same
bit for bit.
"""
from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.film import Film
from ..utils.device import resolve

_VERSION = 1


def save(path: str, film: Film, next_sample: int, meta: Optional[dict] = None):
    """Write the film and the next sample index to `path` (atomically:
    a temporary file, then a rename)."""
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp,
        version=_VERSION,
        rgb_sum=film.rgb_sum.detach().cpu().numpy(),
        weight_sum=film.weight_sum.detach().cpu().numpy(),
        next_sample=np.int64(next_sample),
        **{f"meta_{k}": v for k, v in (meta or {}).items()},
    )
    # np.savez appends .npz if missing
    actual_tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(actual_tmp, path)


def load(path: str, device=None) -> Tuple[Film, int, dict]:
    """(film on `device` (the CUDA card by default), next sample index,
    meta) of a checkpoint."""
    device = resolve(device)
    z = np.load(path, allow_pickle=False)
    if int(z["version"]) != _VERSION:
        raise ValueError(f"checkpoint version {int(z['version'])} unsupported")
    film = Film(torch.as_tensor(z["rgb_sum"], device=device),
                torch.as_tensor(z["weight_sum"], device=device))
    meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
    return film, int(z["next_sample"]), meta


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_with_checkpoints(scene, spp=None, checkpoint_path=None,
                            checkpoint_every=32, resume=True, *,
                            device=None):
    """The wave loop of render() with a checkpoint every `checkpoint_every`
    samples; resumes from checkpoint_path if it exists and removes it when
    the render completes.  Returns ((H, W, 3) numpy image, stats) with the
    render seconds, spp, the sample it resumed from and the loop
    iterations summed over chunks and waves (this run's)."""
    from . import render as render_mod

    device = resolve(device)
    spp = spp if spp is not None else scene.spp
    H, W = scene.height, scene.width
    render_wave, density, majorant = render_mod.make_wave_renderer(
        scene, device=device)
    start = 0
    film = Film.create(H, W, device)
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        film, start, _ = load(checkpoint_path, device)
        assert film.weight_sum.shape == (H, W), "checkpoint resolution mismatch"
    iterations = 0
    _sync(device)
    t0 = time.time()
    for s in range(start, spp):
        film, its = render_wave(film, density, majorant, s)
        iterations += sum(its)
        if checkpoint_path and (s + 1) % checkpoint_every == 0 and s + 1 < spp:
            save(checkpoint_path, film, s + 1, {"spp_target": spp})
    img = film.to_image().cpu().numpy()
    dt = time.time() - t0
    if checkpoint_path and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)  # completed: the checkpoint is spent
    return img, {"render_time": dt, "spp": spp, "resumed_from": start,
                 "iterations": iterations}
