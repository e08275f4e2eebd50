"""The port's sharded gradients (parallel/diff.py::make_sharded_loss and
make_sharded_regen_grad) at world sizes 2 and 4, in gloo ranks on the CPU
(tests/torch_shard_worker.py), against the port's single-device gradients
and the JAX package's: tests/test_diff.py's
test_sharded_grad_matches_single_device (8x8, fixed_steps 96, spp 2) and
test_sharded_regen_grad_overlap_matches_single (fixed_steps 192, 16 lanes,
spp 2, accum_spp, 2 microbatches, remat_window 48; the single device at
448 steps).

Tolerances, the reference's, against the port's single device and the
JAX package alike: losses rtol 1e-5, density gradients rtol 1e-4 / atol
1e-7 (sharded loss) and 1e-8 (regen gradient), sigma_a's gradient rtol
1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models.cameras import PerspectiveCamera
from acceleratedvolrenderer_tpu.parallel import diff as jdiff
from acceleratedvolrenderer_tpu.utils import vecmath as jvm
from acceleratedvolrenderer_tpu_torch.parallel import diff as tdiff
from acceleratedvolrenderer_tpu_torch.scene import convert

import torch_shard_worker
from test_diff import small_scene
from torch_port_util import arrays_from_jax_scene

torch.set_num_threads(2)

WORLDS = (2, 4)
LOSS_KW = dict(fixed_steps=96, spp=2)
REGEN_KW = dict(fixed_steps=192, n_lanes=16, spp=2, accum_spp=True,
                microbatches=2, remat_window=48)
SINGLE_KW = dict(fixed_steps=448, n_lanes=16, spp=2, accum_spp=True,
                 remat_window=48)


@pytest.fixture(scope="module")
def jscene():
    sc = small_scene()
    sc.camera = PerspectiveCamera(
        c2w=jvm.look_at((0.5, 0.5, -2.5), (0.5, 0.5, 0.5), (0, 1, 0)),
        fov_deg=30.0, width=8, height=8)
    return sc


@pytest.fixture(scope="module")
def arrays(jscene):
    return arrays_from_jax_scene(jscene)


@pytest.fixture(scope="module")
def tscene(arrays):
    return convert.scene_from_arrays(arrays, "cpu")


@pytest.fixture(scope="module")
def ranks(arrays, tmp_path_factory):
    tasks = [("loss", "loss", "s", LOSS_KW),
             ("overlap", "regen_grad", "s", dict(REGEN_KW, overlap=True)),
             ("terminal", "regen_grad", "s", dict(REGEN_KW, overlap=False))]
    # every world size starts at once; the tests wait for their own
    launches = {w: torch_shard_worker.Launch(
        {"s": arrays}, tasks, w, tmp_path_factory.mktemp(f"grad{w}"))
        for w in WORLDS}
    yield lambda world: launches[world].results()
    for launch in launches.values():
        launch.results()


def _jax_mesh(world):
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:world]), ("rays",))


@pytest.fixture(scope="module")
def single_loss(tscene):
    loss_fn, grad_fn = tdiff.make_diff_renderer_multi(tscene, device="cpu",
                                                      **LOSS_KW)
    params = {"density": tscene.medium.density, "sigma_a": 1.0}
    with torch.no_grad():
        loss = float(loss_fn(params))
    return loss, {k: v.numpy() for k, v in grad_fn(params).items()}


@pytest.fixture(scope="module")
def single_regen(tscene):
    loss_fn, grad_fn = tdiff.make_diff_regen_renderer(tscene, device="cpu",
                                                      **SINGLE_KW)
    dens = tscene.medium.density
    with torch.no_grad():
        loss = float(loss_fn(dens))
    return loss, grad_fn(dens).numpy()


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_grad_matches_single_device(ranks, single_loss, jscene,
                                            world):
    """Replicated parameters, sharded pixels: the all-reduced loss and
    gradients equal the single-device ones (every rank holds the same)."""
    results = ranks(world)
    loss1, g1 = single_loss
    for r in results:
        res = r["loss"]
        np.testing.assert_allclose(res["loss"], loss1, rtol=1e-5)
        np.testing.assert_allclose(res["grad"]["density"], g1["density"],
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(float(res["grad"]["sigma_a"]),
                                   float(g1["sigma_a"]), rtol=1e-4)
    params = {"density": jnp.asarray(jscene.medium.density),
              "sigma_a": jnp.float32(1.0)}
    jloss, jgrad = jdiff.make_sharded_loss(jscene, _jax_mesh(world),
                                           **LOSS_KW)
    res = results[0]["loss"]
    np.testing.assert_allclose(res["loss"], float(jloss(params)), rtol=1e-5)
    jg = jgrad(params)
    np.testing.assert_allclose(res["grad"]["density"],
                               np.asarray(jg["density"]), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(float(res["grad"]["sigma_a"]),
                               float(jg["sigma_a"]), rtol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_regen_grad_overlap_matches_single(ranks, single_regen,
                                                   jscene, world):
    """The microbatched reduce-scatter gradient (each rank's shard of
    ceil(n_vox / world) voxels) and the terminal all-reduce equal the
    single-device gradient and the JAX package's sharded one."""
    results = ranks(world)
    l1, g1 = single_regen
    n_vox = g1.size
    shards = [r["overlap"]["grad"] for r in results]
    assert all(s.shape == (-(-n_vox // world),) for s in shards)
    go = np.concatenate(shards)[:n_vox].reshape(g1.shape)
    for r in results:
        np.testing.assert_allclose(r["overlap"]["loss"], l1, rtol=1e-5)
        np.testing.assert_allclose(r["terminal"]["loss"], l1, rtol=1e-5)
        np.testing.assert_allclose(r["terminal"]["grad"], g1, rtol=1e-4,
                                   atol=1e-8)
    np.testing.assert_allclose(go, g1, rtol=1e-4, atol=1e-8)
    lg = jdiff.make_sharded_regen_grad(jscene, _jax_mesh(world),
                                       overlap=True, **REGEN_KW)
    jl, jg = lg(jnp.asarray(jscene.medium.density))
    np.testing.assert_allclose(results[0]["overlap"]["loss"], float(jl),
                               rtol=1e-5)
    np.testing.assert_allclose(
        go, np.asarray(jg).reshape(-1)[:n_vox].reshape(g1.shape), rtol=1e-4,
        atol=1e-8)


def test_world_of_one_regen_grad_equals_single(tscene, single_regen):
    """Without a process group the overlapped gradient is the whole grid
    (no collective), equal to the single-device gradient."""
    from acceleratedvolrenderer_tpu_torch.parallel import mesh as tmesh

    l1, g1 = single_regen
    lg = tdiff.make_sharded_regen_grad(
        tscene, tmesh.make_mesh(device="cpu"), overlap=True,
        **dict(REGEN_KW, fixed_steps=SINGLE_KW["fixed_steps"]))
    loss, g = lg(tscene.medium.density)
    assert g.shape == (g1.size,) and len(lg.timings[-1]) == 2
    np.testing.assert_allclose(float(loss), l1, rtol=1e-5)
    np.testing.assert_allclose(g.numpy().reshape(g1.shape), g1, rtol=1e-4,
                               atol=1e-8)


def test_size_fixed_steps_drops_nothing(tscene, single_regen):
    """size_fixed_steps sizes the loop under the gradient's own majorant:
    at its fixed_steps the regen loss equals the one at SINGLE_KW's 448
    steps, while a loop cut to half the live iterations drops samples;
    a world of one sizes each microbatch no longer than the frame."""
    from acceleratedvolrenderer_tpu_torch.parallel import mesh as tmesh

    knobs = dict(n_lanes=16, spp=2, accum_spp=True)
    steps, live = tdiff.size_fixed_steps(tscene, device="cpu", **knobs)
    assert 0 < live and steps == int(live * 1.12) + 16
    assert steps <= SINGLE_KW["fixed_steps"]
    losses = []
    for n in (steps, live // 2):
        loss_fn, _ = tdiff.make_diff_regen_renderer(
            tscene, device="cpu", fixed_steps=n, remat_window=48, **knobs)
        with torch.no_grad():
            losses.append(float(loss_fn(tscene.medium.density)))
    np.testing.assert_allclose(losses[0], single_regen[0], rtol=1e-6)
    assert losses[1] < 0.99 * losses[0]
    mb_steps, mb_live = tdiff.size_fixed_steps(
        tscene, tmesh.make_mesh(device="cpu"), microbatches=2, **knobs)
    assert 0 < mb_live <= live and mb_steps == int(mb_live * 1.12) + 16
