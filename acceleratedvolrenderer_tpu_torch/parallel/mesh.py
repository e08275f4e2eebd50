"""Sharded rendering over a torch.distributed process group
(port of acceleratedvolrenderer_tpu/parallel/mesh.py: make_mesh,
shard_rays, make_sharded_wave_renderer, render_sharded,
make_sharded_regen_renderer and render_sharded_regen).

The reference shards over a `jax.sharding.Mesh` of devices; here every
rank is a process with one device, and a `Mesh` names its group, rank,
size and device.  Pixels (wave) or work items (regen) split into
contiguous slices, one per rank; the density and majorant grids and the
lights are built in every rank; the film's sums are all-reduced (per wave,
or once at the end of a regen render), so every rank ends with the whole
frame.  PCG streams are keyed by the global (pixel, sample), so the image
does not depend on the world size, up to the order of film additions.

Collectives take the group's backend as it is: "nccl" with a card per
rank, "gloo" for CPU ranks or ranks sharing one card
(parallel/distributed.py::initialize).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.film import Film
from ..utils.device import resolve
from . import render as render_mod


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a sharded render: the process group (None: a
    world of one, no collective), its rank and size, and the device the
    rank renders on."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device


def make_mesh(group=None, *, device=None) -> Mesh:
    """The mesh of `group`, or of the default process group when one is
    initialized, else a world of one; `device` as utils/device.py::resolve
    takes it (the CUDA card by default)."""
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(None, 0, 1, resolve(device))
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                resolve(device))


def all_reduce(mesh: Mesh, t: torch.Tensor) -> float:
    """Sum `t` over the mesh in place; returns the collective's seconds
    (host clock, the device synchronized on both sides)."""
    if mesh.group is None:
        return 0.0
    render_mod._sync(t.device)
    t0 = time.time()
    dist.all_reduce(t, group=mesh.group)
    render_mod._sync(t.device)
    return time.time() - t0


def shard_rays(mesh: Mesh, *arrays):
    """This rank's contiguous slice of each array's leading dimension
    (which must divide evenly over the mesh), as tensors on its device."""
    out = []
    for a in arrays:
        n = len(a)
        if n % mesh.size:
            raise ValueError(f"shard_rays: {n} rows do not divide over "
                             f"{mesh.size} ranks")
        per = n // mesh.size
        out.append(torch.as_tensor(np.asarray(a[mesh.rank * per:
                                                (mesh.rank + 1) * per]),
                                   device=mesh.device))
    return tuple(out)


def make_sharded_wave_renderer(scene, mesh: Mesh, *,
                               rays_per_wave: Optional[int] = None):
    """Sharded single-wave renderer: the frame's pixels, padded with
    (-1, -1) to a multiple of the world size, split into one contiguous
    slice per rank; each rank traces its slice (render.make_wave_renderer,
    in chunks of `rays_per_wave`) into a local film whose two sums are
    all-reduced, so every rank holds the full frame.

    Returns (render_wave, density, majorant), where render_wave(film,
    density, majorant, sample_idx) -> (film, seconds of the all-reduce)."""
    H, W = scene.height, scene.width
    pix = render_mod._wave_pixels(W, H, scene.pixel_bounds)
    pad = (-len(pix)) % mesh.size
    if pad:
        pix = np.concatenate([pix, np.full((pad, 2), -1, np.int32)])
    local = pix.reshape(mesh.size, -1, 2)[mesh.rank]
    wave, density, majorant = render_mod.make_wave_renderer(
        scene, rays_per_wave=rays_per_wave, device=mesh.device, pixels=local)

    def render_wave(film, density, majorant, sample_idx):
        part, _ = wave(Film.create(H, W, mesh.device), density, majorant,
                       sample_idx)
        secs = all_reduce(mesh, part.rgb_sum) + all_reduce(mesh,
                                                           part.weight_sum)
        return Film(film.rgb_sum + part.rgb_sum,
                    film.weight_sum + part.weight_sum), secs

    return render_wave, density, majorant


def render_sharded(scene, mesh: Optional[Mesh] = None,
                   spp: Optional[int] = None):
    """render() over the mesh: ((H, W, 3) numpy image, stats with the render
    and all-reduce seconds, spp, rays per second and the world size)."""
    mesh = mesh or make_mesh()
    spp = spp if spp is not None else scene.spp
    H, W = scene.height, scene.width
    render_wave, density, majorant = make_sharded_wave_renderer(scene, mesh)
    film = Film.create(H, W, mesh.device)
    render_mod._sync(mesh.device)
    t0 = time.time()
    reduce_s = 0.0
    for s in range(spp):
        film, secs = render_wave(film, density, majorant, s)
        reduce_s += secs
    img = film.to_image().cpu().numpy()
    dt = time.time() - t0
    return img, {"render_time": dt, "allreduce_time": reduce_s, "spp": spp,
                 "rays_per_sec": H * W * spp / dt, "n_devices": mesh.size}


def _regen_shard(H, W, spp, accum_spp, mesh: Mesh):
    """(work_base, work items) of this rank's contiguous slice of the
    global (pixel, sample) queue; with accum_spp the slices are
    pixel-aligned.  Every rank takes the same count, so the last slice may
    run past the queue's end (those items are discarded)."""
    if accum_spp:
        per = ((H * W + mesh.size - 1) // mesh.size) * spp
    else:
        per = (H * W * spp + mesh.size - 1) // mesh.size
    return mesh.rank * per, per


def make_sharded_regen_renderer(scene, mesh: Mesh, *, n_lanes: int = 4096,
                                spp: Optional[int] = None,
                                k_substeps: int = 16,
                                accum_spp: bool = False, **knobs):
    """Sharded path-regeneration renderer: each rank runs the regen loop
    (render.make_regen_renderer, whose other knobs `knobs` forwards) over
    its contiguous slice of the global work queue, offset by its work_base;
    the films are all-reduced once at the end.

    Returns (run, density, majorant), where run(density, majorant) ->
    (flat channel-major film of the whole frame, LiResult of this rank,
    seconds of the all-reduce)."""
    spp = spp if spp is not None else scene.spp
    H, W = scene.height, scene.width
    base, per = _regen_shard(H, W, spp, accum_spp, mesh)
    run_local, density, majorant = render_mod.make_regen_renderer(
        scene, device=mesh.device, n_lanes=n_lanes, spp=spp,
        k_substeps=k_substeps, accum_spp=accum_spp, work_base=base,
        local_total=per, **knobs)

    def run(density, majorant):
        film = torch.zeros((3 * (H * W + 1),), dtype=torch.float32,
                           device=mesh.device)
        res = run_local(density, majorant, film)
        return res.film_rgb, res, all_reduce(mesh, res.film_rgb)

    return run, density, majorant


def render_sharded_regen(scene, mesh: Optional[Mesh] = None,
                         spp: Optional[int] = None, n_lanes: int = 4096,
                         **knobs):
    """render_regen over the mesh: ((H, W, 3) numpy image, stats with the
    render seconds (this rank's loop and the all-reduce), the all-reduce's,
    spp, rays per second, this rank's loop iterations and the world
    size)."""
    mesh = mesh or make_mesh()
    spp = spp if spp is not None else scene.spp
    H, W = scene.height, scene.width
    run, density, majorant = make_sharded_regen_renderer(
        scene, mesh, n_lanes=n_lanes, spp=spp, **knobs)
    render_mod._sync(mesh.device)
    t0 = time.time()
    film, res, reduce_s = run(density, majorant)
    render_mod._sync(mesh.device)
    dt = time.time() - t0
    return render_mod.film_to_image(film, H, W, spp), {
        "render_time": dt, "allreduce_time": reduce_s, "spp": spp,
        "rays_per_sec": H * W * spp / dt, "iterations": res.iterations,
        "n_devices": mesh.size}
