"""One rank of the port's sharded renders and gradients, for the CPU tests
(tests/test_torch_multichip.py, test_torch_multichip_grad.py,
test_torch_distributed.py).  It imports only the port, never JAX.

    python tests/torch_shard_worker.py JOB RANK WORLD PORT

JOB is a pickle written by the test: {"scenes": {name: arrays for
convert.scene_from_arrays}, "tasks": [(key, task, scene name, kwargs)],
"out": directory}.  Each rank joins a gloo group of WORLD ranks at
tcp://127.0.0.1:PORT on the CPU (one thread), runs the tasks in order and
writes {key: result} to OUT/rank{RANK}.pkl.  A failure exits non-zero with
the traceback on stderr.
"""
import os
import pickle
import socket
import subprocess
import sys
import time

import torch

from acceleratedvolrenderer_tpu_torch.parallel import diff, distributed
from acceleratedvolrenderer_tpu_torch.parallel import mesh as pmesh
from acceleratedvolrenderer_tpu_torch.scene import convert


def _regen(scene, mesh, kw):
    img, st = pmesh.render_sharded_regen(scene, mesh, **kw)
    return {"img": img, "n_devices": st["n_devices"]}


def _wave(scene, mesh, kw):
    img, st = pmesh.render_sharded(scene, mesh, **kw)
    return {"img": img, "n_devices": st["n_devices"]}


def _film(scene, mesh, kw):
    """The raw all-reduced film of the sharded regen renderer."""
    run, density, majorant = pmesh.make_sharded_regen_renderer(scene, mesh,
                                                                **kw)
    film, _, _ = run(density, majorant)
    return {"film": film.numpy()}


def _timed_film(scene, mesh, kw):
    """test_scaling's timing: the film and the best of 5 runs after a
    warm-up, timed inside the rank, the group's barrier before each, in
    wall seconds and in the render thread's CPU seconds (time.thread_time:
    the render and the film's all-reduce as this thread runs them; gloo's
    own threads, and time the rank waits or is descheduled, do not
    count)."""
    run, density, majorant = pmesh.make_sharded_regen_renderer(scene, mesh,
                                                                **kw)
    film, _, _ = run(density, majorant)
    best, best_cpu = float("inf"), float("inf")
    for _ in range(5):
        if mesh.group is not None:
            torch.distributed.barrier(mesh.group)
        t0, c0 = time.perf_counter(), time.thread_time()
        film, _, _ = run(density, majorant)
        best = min(best, time.perf_counter() - t0)
        best_cpu = min(best_cpu, time.thread_time() - c0)
    return {"film": film.numpy(), "seconds": best, "cpu_seconds": best_cpu}


def _loss(scene, mesh, kw):
    loss_fn, grad_fn = diff.make_sharded_loss(scene, mesh, **kw)
    params = {"density": scene.medium.density, "sigma_a": 1.0}
    g = grad_fn(params)
    return {"loss": float(loss_fn(params)),
            "grad": {k: v.numpy() for k, v in g.items()}}


def _regen_grad(scene, mesh, kw):
    lg = diff.make_sharded_regen_grad(scene, mesh, **kw)
    loss, g = lg(scene.medium.density)
    return {"loss": float(loss), "grad": g.numpy()}


def _pixel_shard(scene, mesh, kw):
    pix, idx = distributed.host_pixel_shard(scene.height, scene.width)
    return {"pix": pix, "idx": idx}


def _fail_on_rank1(scene, mesh, kw):
    """Rank 1 raises; the others block in a collective it never joins."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    pmesh.all_reduce(mesh, torch.zeros(1))
    return {}


TASKS = dict(regen=_regen, wave=_wave, film=_film, timed_film=_timed_film,
             loss=_loss, regen_grad=_regen_grad, pixel_shard=_pixel_shard,
             fail_on_rank1=_fail_on_rank1)


def main(job_path, rank, world, port):
    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    if world > 1:
        distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                               backend="gloo")
    mesh = pmesh.make_mesh(device="cpu")
    scenes = {k: convert.scene_from_arrays(a, "cpu")
              for k, a in job["scenes"].items()}
    out = {}
    for key, task, scene, kw in job["tasks"]:
        out[key] = TASKS[task](scenes[scene], mesh, kw)
    with open(f"{job['out']}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    if world > 1:
        torch.distributed.destroy_process_group()
    return 0


class Launch:
    """`world` worker processes (this file, started with sys.executable)
    running `tasks` over `scenes`, their output in out_dir/rank{r}.log;
    results() waits for them and returns each rank's results, or raises
    with the workers' output when one fails or the time limit passes (the
    others are killed)."""

    def __init__(self, scenes, tasks, world, out_dir, timeout=300):
        self.out_dir, self.world, self.timeout = str(out_dir), world, timeout
        job = os.path.join(self.out_dir, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump({"scenes": scenes, "tasks": tasks,
                         "out": self.out_dir}, f)
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [root] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        self.logs = [os.path.join(self.out_dir, f"rank{r}.log")
                     for r in range(world)]
        self.procs = []
        for r, log in enumerate(self.logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), job, str(r),
                     str(world), str(port)], env=env, stdout=f,
                    stderr=subprocess.STDOUT))
        self.t0 = time.time()
        self._results = None

    def results(self):
        if self._results is not None:
            return self._results
        procs = self.procs
        try:
            # a rank that fails leaves the others blocked in a collective:
            # stop waiting at the first failure or at the time limit
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.time() - self.t0 < self.timeout):
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode != 0 for p in procs):
            outs = [open(log).read()[-4000:] for log in self.logs]
            raise AssertionError("shard worker failed:\n" + "\n".join(
                f"--- rank {r} (rc {p.returncode})\n{o}"
                for r, (p, o) in enumerate(zip(procs, outs))))
        self._results = []
        for r in range(self.world):
            with open(os.path.join(self.out_dir, f"rank{r}.pkl"), "rb") as f:
                self._results.append(pickle.load(f))
        return self._results


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], *(int(a) for a in sys.argv[2:5])))
