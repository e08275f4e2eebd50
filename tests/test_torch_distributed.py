"""Two real processes, one torch.distributed (gloo) group, on the CPU: the
port's sharded regen renderer across the process boundary
(tests/test_distributed.py) and its sharding overhead
(tests/test_scaling.py).

- test_distributed: two ranks (tests/torch_shard_worker.py) render the
  32x32 sphere medium at spp 2, 128 lanes, accum_spp; both ranks' films
  are equal bit for bit and equal the port's single-device film within
  3e-5, and 99% of their values are within 3e-5 of the JAX package's
  sharded regen film on 8 virtual devices (0.9941 measured: float32 ulps
  flip a collision at the hard sphere's edge for a few samples, as they
  do between the JAX package's own jitted and unjitted li, 0.226 apart at
  the worst pixel).
- host_pixel_shard: the two ranks' slices tile the frame in order;
  initialize makes no group unless asked and refuses one without a
  backend or a rank; a failing rank fails the launch (the other rank,
  blocked in a collective, is killed).
- test_scaling: the 64x64 sphere medium at spp 4, a world of 1 (1,024
  lanes) and of 2 (512 lanes per rank): the images agree within 3e-5 and
  T(2) <= 1.25 T(1), each T the best of 5 runs after a warm-up in each
  of SCALING_ROUNDS launches, the launches of the two worlds alternated,
  timed inside the ranks (process start-up and set-up excluded).  T is
  the render thread's CPU seconds (time.thread_time), not its wall
  seconds: under xdist the two one-thread ranks share cores with other
  workers, and a rank descheduled there would fail a wall-clock bound
  with no fault in the code.  At this size a rank's work is its loop's
  per-iteration overhead more than its lanes, so T(2) / T(1) sits near
  1.0 (0.95-1.16 measured on an idle 8-core host), and a slow spell
  that falls on one world's three runs alone once took it past 1.25;
  the best over more runs and over alternated launches does not hang
  on one spell.  The bound so holds the work sharding adds to a rank
  (the slice's set-up, the lanes' tail, the film's all-reduce); the
  wall seconds are printed beside it.
"""
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from acceleratedvolrenderer_tpu.parallel import mesh as jmesh
from acceleratedvolrenderer_tpu.scene import presets as jpresets
from acceleratedvolrenderer_tpu_torch.parallel import distributed
from acceleratedvolrenderer_tpu_torch.parallel import mesh as tmesh
from acceleratedvolrenderer_tpu_torch.scene import convert

import torch_shard_worker
from torch_port_util import arrays_from_jax_scene

torch.set_num_threads(2)

JAX_SHARE = 0.99
# test_scaling's launches, alternated world 1, world 2, world 1, ...
SCALING_ROUNDS = 2


def test_two_process_distributed_matches_single(tmp_path):
    scene = jpresets.sphere_medium(res=32, height=32, spp=2, max_depth=4)
    arrays = arrays_from_jax_scene(scene)
    kw = dict(n_lanes=128, spp=2, accum_spp=True)
    launch = torch_shard_worker.Launch(
        {"s": arrays}, [("film", "film", "s", kw),
                        ("pix", "pixel_shard", "s", {})], 2, tmp_path)
    run, density, majorant = tmesh.make_sharded_regen_renderer(
        convert.scene_from_arrays(arrays, "cpu"),
        tmesh.make_mesh(device="cpu"), **kw)
    single = run(density, majorant)[0].numpy()
    results = launch.results()
    films = [r["film"]["film"] for r in results]
    np.testing.assert_array_equal(films[0], films[1])
    # host_pixel_shard: the two processes' slices tile the frame in order
    pix, idx = distributed.host_pixel_shard(32, 32)     # no group: all
    assert np.array_equal(np.concatenate([r["pix"]["idx"] for r in results]),
                          idx) and idx.tolist() == list(range(32 * 32))
    assert np.array_equal(np.concatenate([r["pix"]["pix"] for r in results]),
                          pix)
    np.testing.assert_allclose(films[0], single, atol=3e-5)
    mesh = Mesh(np.array(jax.devices()[:8]), ("rays",))
    jrun, jdens, jmaj = jmesh.make_sharded_regen_renderer(scene, mesh, **kw)
    close = np.abs(films[0] - np.asarray(jrun(jdens, jmaj))) < 3e-5
    assert close.mean() >= JAX_SHARE, close.mean()


def test_sharding_overhead_and_agreement(tmp_path):
    arrays = arrays_from_jax_scene(
        jpresets.sphere_medium(res=64, height=64, spp=4, max_depth=4))
    times, wall, imgs = {1: [], 2: []}, {1: [], 2: []}, {}
    for r in range(SCALING_ROUNDS):
        for n in (1, 2):
            kw = dict(n_lanes=max(1024 // n, 128), spp=4)
            out = tmp_path / f"round{r}_world{n}"
            out.mkdir()
            ranks = torch_shard_worker.Launch(
                {"s": arrays}, [("t", "timed_film", "s", kw)], n,
                out).results()
            times[n].append(max(x["t"]["cpu_seconds"] for x in ranks))
            wall[n].append(max(x["t"]["seconds"] for x in ranks))
            imgs[n] = ranks[0]["t"]["film"]
    np.testing.assert_allclose(imgs[2], imgs[1], atol=3e-5)
    # the reference's bound: >= 85% efficiency allows ~1.18x, +25% for
    # host timing jitter
    assert min(times[2]) <= min(times[1]) * 1.25, (times, wall)


def test_initialize_asks_for_a_group_only_when_told(monkeypatch):
    """No address and no process count, in the arguments or torchrun's
    environment: no group, False.  A group without an explicit backend, or
    without a rank, is refused."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="backend"):
        distributed.initialize("127.0.0.1:1", 2, 0)
    with pytest.raises(ValueError, match="process id"):
        distributed.initialize("127.0.0.1:1", 2, backend="gloo")
    assert not torch.distributed.is_initialized()


def test_a_failing_rank_fails_the_launch(tmp_path):
    """One rank raises while the other waits in a collective: the launch
    kills the waiting rank and raises with the failing rank's output, well
    before its time limit."""
    arrays = arrays_from_jax_scene(
        jpresets.sphere_medium(res=8, height=8, spp=1, max_depth=2))
    launch = torch_shard_worker.Launch(
        {"s": arrays}, [("x", "fail_on_rank1", "s", {})], 2, tmp_path,
        timeout=120)
    t0 = time.time()
    with pytest.raises(AssertionError, match="rank 1 fails on purpose"):
        launch.results()
    assert time.time() - t0 < 60
    assert all(p.poll() is not None for p in launch.procs)
