"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device.  The file
imports no JAX, so it runs on a machine with only PyTorch and the CUDA
toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

March: integer outputs and flags must be equal; floats agree to rtol 1e-6
(the kernel is built without multiply-add contraction, so it rounds as the
eager version does).  Gather and tile-DMA gather: bitwise equal (they do
no arithmetic).  The small gradients and wave frames on the card against
the same on the CPU: loss to 1e-3 relative, gradient to relative L2 1e-2
with 99% of voxels within rtol 1e-3 / atol 1e-6 * max|g|, frame means to
1e-3 and 99% of pixels to rtol 1e-3 / atol 1e-5 (exp, log1p and erfinv
differ by ulps between the two devices, and one flipped choice reroutes a
sample)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu_torch import kernels
from acceleratedvolrenderer_tpu_torch.ops import dma_gather as dma
from acceleratedvolrenderer_tpu_torch.ops import gather, march
from acceleratedvolrenderer_tpu_torch.parallel import diff
from acceleratedvolrenderer_tpu_torch.scene import presets

from torch_graph_util import graph_test_scene, sphere_tracking_inputs
from torch_wave_util import wave_frame

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _lanes(n, res, seed, residual, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in
            march.random_lanes(n, res, seed=seed, residual=residual).items()}


def _march_case(lanes, K, res):
    """One kernel launch against the plain version: the same keys, dtypes,
    shapes, contiguous outputs, integers and flags equal, floats to rtol
    1e-6."""
    before = march.launches
    out = march.march_block(K=K, maj_res=res, **lanes)
    assert march.launches == before + 1
    ref = march.march_block_plain(K=K, maj_res=res, **lanes)
    torch.cuda.synchronize()
    assert list(out) == list(ref)
    for k in ref:
        assert (out[k].dtype, out[k].shape) == (ref[k].dtype, ref[k].shape), k
        assert out[k].is_contiguous(), k
        x, y = out[k].cpu().numpy(), ref[k].cpu().numpy()
        if x.dtype.kind in "biu":
            assert np.array_equal(x, y), k
        else:
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=0, err_msg=k)
    return out


@pytest.mark.parametrize("res", [(16, 16, 16), (32, 32, 32), (64, 64, 64)])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("K", [1, 8, 16])
def test_march_kernel_matches_plain(dev, res, residual, K):
    _march_case(_lanes(1000, res, K + res[0], residual, dev), K, res)


@pytest.mark.parametrize("n", [1, 31, 127, 129, 16383, 16385, 262144])
@pytest.mark.parametrize("residual", [False, True])
def test_march_kernel_lane_counts(dev, n, residual):
    """Lane counts around the 128-thread block (a masked last block) and
    the wave chunk's 262,144."""
    _march_case(_lanes(n, (16, 16, 16), n, residual, dev), 8, (16, 16, 16))


@pytest.mark.parametrize("residual", [False, True])
def test_march_kernel_32_table_twice(dev, residual):
    """A 128 KB table twice in a row: the second launch must not depend on
    anything the first set up other than once-per-kernel state."""
    for seed in (1, 2):
        _march_case(_lanes(16384, (32, 32, 32), seed, residual, dev), 8,
                    (32, 32, 32))


@pytest.mark.parametrize("residual", [False, True])
def test_march_kernel_unaligned_views(dev, residual):
    """Inputs that are contiguous views 4 bytes past a 16-byte boundary
    (table and lane registers): the kernel takes its 4-byte paths."""
    lanes = _lanes(1000, (16, 16, 16), 5, residual, dev)
    shifted = {}
    for k, v in lanes.items():
        big = torch.empty(v.numel() + 1, dtype=v.dtype, device=dev)
        view = big[1:].view(v.shape)
        view.copy_(v)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        shifted[k] = view
    _march_case(shifted, 8, (16, 16, 16))


# profiles CALLS march_block calls at (K, residual) in a process of its
# own and prints every kernel that took device time, with its count
_PROFILE_WINDOW = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from acceleratedvolrenderer_tpu_torch.ops import march
K, residual, calls = int(sys.argv[1]), sys.argv[2] == "1", int(sys.argv[3])
dev = torch.device("cuda", 0)
lanes = {k: torch.as_tensor(v, device=dev) for k, v in march.random_lanes(
    16384, (16, 16, 16), seed=3, residual=residual).items()}
march.march_block(K=K, maj_res=(16, 16, 16), **lanes)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
        march.march_block(K=K, maj_res=(16, 16, 16), **lanes)
    torch.cuda.synchronize()
print(json.dumps([[e.key, e.count] for e in prof.key_averages()
                  if e.self_device_time_total > 0]))
"""


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("K", [1, 8])
def test_march_call_is_one_kernel(dev, residual, K):
    """A march_block call launches exactly one kernel, the march kernel:
    the flags come out of it as bool planes, with no decoding kernels.  A
    window of CALLS calls is profiled in a fresh process (the profiler has
    missed the events of a window of one call, and late in a long process
    it has recorded fewer launches than were made): every device event in
    it is the march kernel's, CALLS of them."""
    calls = 8
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.run(
        [sys.executable, "-c", _PROFILE_WINDOW, str(K), str(int(residual)),
         str(calls)], cwd=root, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    run = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(run) == 1, run
    assert "march_kernel" in run[0][0] and run[0][1] == calls, run


def test_march_wrapper_rejects_bad_input(dev):
    lanes = _lanes(256, (16, 16, 16), 0, False, dev)
    before = march.launches
    bad = dict(lanes, t_cur=lanes["t_cur"].double())
    with pytest.raises(TypeError):
        march.march_block(K=4, maj_res=(16, 16, 16), **bad)
    bad = dict(lanes, voxel=lanes["voxel"].t().contiguous().t())
    with pytest.raises(ValueError):
        march.march_block(K=4, maj_res=(16, 16, 16), **bad)
    # a freshly computed mask that is a strided view; short or misplaced
    # planes and tables
    hunting = torch.stack([lanes["hunting"]] * 2, 1)[:, 0]
    assert not hunting.is_contiguous()
    for k, v in (("hunting", hunting), ("dl_since", lanes["dl_since"][:100]),
                 ("majorant", lanes["majorant"][:100]),
                 ("maxd_in", lanes["maxd_in"].cpu())):
        with pytest.raises(ValueError):
            march.march_block(K=4, maj_res=(16, 16, 16),
                              **dict(lanes, **{k: v}))
    # a grid whose sizes multiply to the table's but are not all positive:
    # the C entry refuses it without launching
    with pytest.raises(RuntimeError):
        march.march_block(K=4, maj_res=(-16, -16, 16), **lanes)
    assert march.launches == before


@pytest.mark.parametrize("res", [(16, 16, 16), (32, 32, 32)])
@pytest.mark.parametrize("K", [1, 8, 16])
@pytest.mark.parametrize("n", [1000, 1024])
def test_march_window_matches_plain(dev, res, K, n):
    lanes = _lanes(n, res, K + res[0], False, dev)
    before = (march.launches, gather.launches)
    out = march.march_window(K=K, maj_res=res, **lanes)
    ref = march.march_block_plain(K=K, maj_res=res, **lanes)
    torch.cuda.synchronize()
    assert (march.launches, gather.launches) == (before[0], before[1] + 1)
    for k in ref:
        np.testing.assert_array_equal(out[k].cpu().numpy(),
                                      ref[k].cpu().numpy(), err_msg=k)


@pytest.mark.parametrize("n", [208, 1000, 16384])
def test_march_window_residual_matches_plain(dev, n):
    """The window route in residual mode: two gather launches (majorant
    and minorant), outputs equal to the plain march's."""
    res = (16, 16, 16)
    lanes = _lanes(n, res, n + 3, True, dev)
    before = (march.launches, gather.launches)
    out = march.march_window(K=8, maj_res=res, **lanes)
    ref = march.march_block_plain(K=8, maj_res=res, **lanes)
    torch.cuda.synchronize()
    assert (march.launches, gather.launches) == (before[0], before[1] + 2)
    assert list(out) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k].cpu().numpy(),
                                      ref[k].cpu().numpy(), err_msg=k)


def test_gather_kernel_one_entry_table(dev):
    """A 1-entry table at the fog box's shape (16384 x 8 indices, the
    window route over a 1^3 majorant), some indices out of range."""
    table = torch.tensor([0.75], device=dev)
    rng = np.random.default_rng(11)
    idx = torch.as_tensor(np.where(rng.random((16384, 8)) < 0.02, 1, 0)
                          .astype(np.int32), device=dev)
    before = gather.launches
    out = gather.table_gather(table, idx)
    assert gather.launches == before + 1
    ref = gather.table_gather_plain(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and (out == 0).any() and (out > 0).any()


def _gather_inputs(v, n, seed, dev):
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(rng.uniform(0.0, 2.0, v).astype(np.float32),
                            device=dev)
    idx = rng.integers(0, v, n).astype(np.int32)
    idx[:3] = [-1, v, v + 77][:n]             # out of range: reads 0
    return table, torch.as_tensor(idx, device=dev)


@pytest.mark.parametrize("v", [128, 1000, 4096, 32768, 64 ** 3])
@pytest.mark.parametrize("n", [100, 96 * 8, 208 * 8, 1000 * 8, 16384 * 8])
def test_gather_kernel_matches_plain(dev, v, n):
    table, idx = _gather_inputs(v, n, v + n, dev)
    if n % 8 == 0:
        idx = idx.reshape(-1, 8)
    before = gather.launches
    out = gather.table_gather(table, idx)
    assert gather.launches == before + 1
    ref = gather.table_gather_plain(table, idx)
    torch.cuda.synchronize()
    assert out.shape == idx.shape
    assert torch.equal(out, ref)


@pytest.mark.parametrize("v", [1, 4096, 64 ** 3])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_gather_kernel_views_and_tails(dev, v, offset):
    """idx views 0-3 elements past a 16-byte boundary (the kernel's 16-byte
    body starts after a scalar head) and n 1 .. 9 (scalar tails)."""
    for n in (*range(1, 10), 16384 * 8 + 5):
        table, idx = _gather_inputs(v, n + offset, v + n + offset, dev)
        idx = idx[offset:]
        assert idx.data_ptr() % 16 == 4 * offset
        before = gather.launches
        out = gather.table_gather(table, idx)
        assert gather.launches == before + 1
        ref = gather.table_gather_plain(table, idx)
        torch.cuda.synchronize()
        assert out.shape == idx.shape
        assert torch.equal(out, ref), n


def test_gather_wrapper_rejects_bad_input(dev):
    table, idx = _gather_inputs(4096, 1664, 0, dev)
    before = gather.launches
    with pytest.raises(TypeError):
        gather.table_gather(table, idx.long())
    with pytest.raises(TypeError):
        gather.table_gather(table.double(), idx)
    with pytest.raises(ValueError):
        gather.table_gather(table, idx.reshape(-1, 2).t())
    with pytest.raises(ValueError):
        gather.table_gather(table.cpu(), idx)
    with pytest.raises(ValueError):
        gather.table_gather(table[:0], idx)
    assert gather.table_gather(table, idx[:0]).shape == (0,)
    assert gather.launches == before
    # any shape the reference entry leaves to jnp.take launches the kernel
    out = gather.table_gather(table[:1000], idx[:100])
    assert gather.launches == before + 1
    assert torch.equal(out, gather.table_gather_plain(table[:1000],
                                                      idx[:100]))


@pytest.mark.parametrize("n_lanes", [96, 128])
def test_small_gradient_matches_cpu(dev, n_lanes):
    kw = dict(n_lanes=n_lanes, fixed_steps=96, spp=2, accum_spp=True,
              retire_groups=2, k_substeps=8, stochastic_filter=True,
              remat_window=16, work_stride="auto")
    out = []
    for d in (dev, torch.device("cpu")):
        scene = presets.cloud(16, 12, spp=2, max_depth=4, grid_res=16,
                              device=d)
        loss_fn, grad_fn = diff.make_diff_regen_renderer(scene, device=d,
                                                         **kw)
        dens = scene.medium.density
        out.append((float(loss_fn(dens)), grad_fn(dens).cpu().numpy()))
    (lg, gg), (lc, gc) = out
    assert np.isfinite(gg).all() and np.abs(gg).max() > 0
    np.testing.assert_allclose(lg, lc, rtol=1e-3)
    assert np.linalg.norm(gg - gc) <= 1e-2 * np.linalg.norm(gc)
    close = np.isclose(gg, gc, rtol=1e-3, atol=1e-6 * np.abs(gc).max())
    assert close.mean() >= 0.99, close.mean()


@pytest.mark.parametrize("chunk", [1, 16, 100, 1000, 16384])
@pytest.mark.parametrize("n_tiles", [64, 16384])
def test_dma_kernel_matches_plain(dev, chunk, n_tiles):
    rng = np.random.default_rng(chunk + n_tiles)
    table = torch.as_tensor(rng.random(n_tiles * 1024).astype(np.float32),
                            device=dev)
    idx = rng.integers(0, n_tiles, chunk).astype(np.int32)
    before = dma.launches
    out = dma.dma_gather(table, torch.as_tensor(idx, device=dev))
    assert dma.launches == before + 1
    torch.cuda.synchronize()
    want = table.reshape(-1, 8, 128)[int(idx[dma.last_slot0(chunk)])]
    assert torch.equal(out, want)


def _dma_case(n_tiles, ids, dev):
    """The kernel's tile against the plain version's, bitwise, one launch."""
    table = torch.as_tensor(np.random.default_rng(n_tiles).random(
        n_tiles * 1024).astype(np.float32), device=dev)
    idx = torch.as_tensor(np.asarray(ids, np.int32), device=dev)
    before = dma.launches
    out = dma.dma_gather(table, idx)
    assert dma.launches == before + 1
    ref = dma.dma_gather_plain(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    return out


@pytest.mark.parametrize("chunk", [1, 15, 16, 17, 131, 132 * 16, 16384,
                                   65536])
def test_dma_kernel_chunks_match_plain(dev, chunk):
    _dma_case(4096, np.random.default_rng(chunk).integers(0, 4096, chunk),
              dev)


def _owner_positions(max_blocks):
    """A chunk for each place j* can take in its block's slice."""
    found = {}
    for chunk in range(17, 70000):
        _, per = dma.launch_geometry(chunk, max_blocks)
        j = dma.last_slot0(chunk)
        first = j // per * per
        last = min(first + per, chunk) - 1
        where = ("start" if j == first else "end" if j == last
                 else "middle") if first < last else None
        if where is not None:
            found.setdefault(where, chunk)
    return found


@pytest.mark.parametrize("where", ["start", "end", "middle"])
def test_dma_kernel_owner_slice_positions(dev, where):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk = _owner_positions(sms)[where]
    _dma_case(4096, np.random.default_rng(chunk).integers(0, 4096, chunk),
              dev)


def test_dma_kernel_all_out_of_range(dev):
    ids = np.where(np.arange(1000) % 2 == 0, -7, 64 + np.arange(1000))
    assert not _dma_case(64, ids, dev).any()


def test_dma_kernel_repeated_ids(dev):
    _dma_case(64, np.repeat(np.arange(64)[::-1], 37), dev)
    _dma_case(64, np.full(16384, 5), dev)


@pytest.mark.parametrize("bad", [-1, 64, 10 ** 6])
def test_dma_kernel_out_of_range_reads_zeros(dev, bad):
    table = torch.rand(64 * 1024, device=dev)
    idx = np.random.default_rng(0).integers(-3, 67, 100).astype(np.int32)
    idx[dma.last_slot0(100)] = bad
    idx = torch.as_tensor(idx, device=dev)
    out = dma.dma_gather(table, idx)
    torch.cuda.synchronize()
    assert not out.any() and torch.equal(out, dma.dma_gather_plain(table,
                                                                   idx))


def test_dma_wrapper_rejects_bad_input(dev):
    table = torch.rand(64 * 1024, device=dev)
    idx = torch.zeros(32, dtype=torch.int32, device=dev)
    before = dma.launches
    for args, err in (((table, idx.long()), TypeError),
                      ((table[:1000], idx), ValueError),
                      ((table, idx[:0]), ValueError),
                      ((table, idx.cpu()), ValueError)):
        with pytest.raises(err):
            dma.dma_gather(*args)
    assert dma.launches == before


def test_dma_wrapper_rejects_misaligned_table(dev):
    big = torch.rand(65 * 1024, device=dev)
    table = big[1:1 + 64 * 1024]          # contiguous, 4 bytes past 16
    assert table.is_contiguous() and table.data_ptr() % 16 == 4
    idx = torch.zeros(32, dtype=torch.int32, device=dev)
    before = dma.launches
    with pytest.raises(ValueError, match="16-byte"):
        dma.dma_gather(table, idx)
    assert dma.launches == before
    out = dma.dma_gather(big[4:4 + 64 * 1024], idx)    # aligned: launches
    torch.cuda.synchronize()
    assert torch.equal(out, big[4:4 + 1024].reshape(8, 128))


@pytest.mark.parametrize("where", ["outside", "capture"])
def test_launch_target_reads_the_current_stream(dev, where):
    """launch_target reads the current stream through a private PyTorch
    binding: it must name torch.cuda.current_stream's stream on the default
    stream and a side stream, and inside a CUDA graph capture."""
    def check():
        assert kernels.launch_target("test", dev) == (
            dev.index, torch.cuda.current_stream(dev).cuda_stream)

    if where == "outside":
        check()
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            check()
        return
    x = torch.zeros(4, device=dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        check()
        x.add_(1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(x, torch.ones(4, device=dev))


def test_gather_designs_count_the_dma_kernel_runs(dev):
    """measure() captures its dependent steps in a CUDA graph: the wrapper
    is called for the warm-up and each captured step, and the kernel runs
    once for the warm-up and once per step in each replay."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import measure_gather_designs_torch as designs

    before = dma.launches
    out = designs.measure(1024, 5, device=dev)
    assert dma.launches - before == out["dma_wrapper_calls"] == 1 + 5
    assert out["dma_kernel_runs"] == 1 + designs.REPLAYS * 5
    for k in ("xla_gather_ns_per_el", "dma_tile_ns_per_el",
              "argsort_ns_per_el"):
        assert out[k] > 0


@pytest.mark.parametrize("rays_per_wave", [256, 200])
def test_wave_frame_matches_cpu(dev, rays_per_wave):
    imgs = []
    for d in (dev, torch.device("cpu")):
        march.launches = gather.launches = 0
        img, chunk_its = wave_frame(
            presets.cloud(32, 24, spp=2, max_depth=8, grid_res=32, device=d),
            rays_per_wave, d)
        imgs.append(img)
        if d.type == "cuda":
            it = sum(chunk_its)
            fused = rays_per_wave == 256
            assert (march.launches, gather.launches) == (
                (it, 0) if fused else (0, it))
    gpu, cpu = imgs
    assert np.isfinite(gpu).all() and gpu.mean() > 0
    assert abs(gpu.mean() - cpu.mean()) / cpu.mean() < 1e-3
    assert np.isclose(gpu, cpu, rtol=1e-3, atol=1e-5).all(-1).mean() >= 0.99


def test_wave_multi_gradient_matches_cpu(dev):
    out = []
    for d in (dev, torch.device("cpu")):
        scene = presets.cloud(16, 16, spp=2, max_depth=4, grid_res=16,
                              device=d)
        loss_fn, grad_fn = diff.make_diff_renderer_multi(
            scene, fixed_steps=64, spp=1, device=d)
        params = {"density": scene.medium.density, "sigma_s": 1.0}
        with torch.no_grad():
            loss = float(loss_fn(params))
        out.append((loss, {k: v.cpu().numpy()
                           for k, v in grad_fn(params).items()}))
    (lg, gg), (lc, gc) = out
    np.testing.assert_allclose(lg, lc, rtol=1e-3)
    np.testing.assert_allclose(gg["sigma_s"], gc["sigma_s"], rtol=1e-3)
    a, b = gg["density"], gc["density"]
    assert np.isfinite(a).all() and np.abs(a).max() > 0
    assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b)
    close = np.isclose(a, b, rtol=1e-3, atol=1e-6 * np.abs(b).max())
    assert close.mean() >= 0.99, close.mean()


# ---------------------------------------------------------------------------
# the staged tracking and the graph render, on the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("emission", [False, True])
def test_delta_track_matches_cpu(dev, emission):
    """Events equal for >= 99% of 4096 rays; where they agree, t_event,
    beta, r_u, r_l and L_emit to rtol 1e-5 / atol 1e-6."""
    from acceleratedvolrenderer_tpu_torch.ops import dda

    n = 4096
    out = {}
    for where in ("cpu", dev):
        med, o, d, active, rng = sphere_tracking_inputs(n, emission, where)
        one = torch.ones((n, 4), device=where)
        out[str(where)] = dda.delta_track(
            med, o, d, torch.full((n,), torch.inf, device=where), one, one,
            one, rng, active, (8, 8, 8), collect_emission=emission)
    cpu, gpu = out["cpu"], out[str(dev)]
    ev = (gpu.event.cpu() == cpu.event).numpy()
    assert ev.mean() >= 0.99
    for k in ("t_event", "beta", "r_u", "r_l", "L_emit"):
        np.testing.assert_allclose(getattr(gpu, k).cpu().numpy()[ev],
                                   getattr(cpu, k).numpy()[ev], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_ratio_track_matches_cpu(dev):
    """T_ray to rtol 1e-5 / atol 1e-6 on >= 99% of 4096 rays, r_l and r_u
    the same where T_ray is nonzero."""
    from acceleratedvolrenderer_tpu_torch.ops import transmittance

    n = 4096
    out = {}
    for where in ("cpu", dev):
        med, o, d, active, rng = sphere_tracking_inputs(n, False, where,
                                                        seed=3)
        out[str(where)] = transmittance.ratio_track(
            med, o, d, torch.full((n,), 2.5, device=where), rng, active,
            (8, 8, 8))
    cpu, gpu = out["cpu"], out[str(dev)]
    tc, tg = cpu.T_ray.numpy(), gpu.T_ray.cpu().numpy()
    assert np.isclose(tg, tc, rtol=1e-5, atol=1e-6).all(-1).mean() >= 0.99
    live = (tc != 0).any(-1) | (tg != 0).any(-1)
    for k in ("r_l", "r_u"):
        a = getattr(gpu, k).cpu().numpy()[live]
        b = getattr(cpu, k).numpy()[live]
        assert np.isclose(a, b, rtol=1e-5, atol=1e-6).all(-1).mean() >= 0.99


def test_render_graph_matches_cpu(dev):
    """A graph built and lit on the CPU (tests/test_graph.py's sphere and
    configuration), rendered at 12x12, spp 2, on the card and on the CPU:
    means to 1e-3, >= 99% of pixels to rtol 1e-3 / atol 1e-5."""
    from acceleratedvolrenderer_tpu_torch.graph.builder import FreeGraphBuilder
    from acceleratedvolrenderer_tpu_torch.graph.config import (
        GraphBuilderConfig, LightingCalculatorConfig)
    from acceleratedvolrenderer_tpu_torch.graph.lighting import (
        LightingCalculator)
    from acceleratedvolrenderer_tpu_torch.parallel import render

    scene = graph_test_scene(12, "cpu")
    light = scene.lights[0].direction
    graph = FreeGraphBuilder(
        scene.medium, light, GraphBuilderConfig(
            dimension_steps=24, iterations_per_step=2, radius_modifier=20.0,
            max_depth=4), seed=1, device="cpu").build()
    graph = LightingCalculator(graph, scene.medium, light,
                               LightingCalculatorConfig(light_rays=8,
                                                        bounces=3),
                               seed=1, device="cpu").run()
    cpu, _ = render.render_graph(scene, graph, device="cpu")
    gpu, stats = render.render_graph(scene, graph, device=dev)
    assert np.isfinite(gpu).all() and gpu.mean() > 0
    assert abs(gpu.mean() - cpu.mean()) / cpu.mean() < 1e-3
    assert np.isclose(gpu, cpu, rtol=1e-3, atol=1e-5).all(-1).mean() >= 0.99
    assert min(stats["iterations"]) > 0


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


def _assert_frames_close(gpu, cpu, mean_tol=1e-3):
    assert np.isfinite(gpu).all() and gpu.mean() > 0
    assert abs(gpu.mean() - cpu.mean()) / cpu.mean() < mean_tol
    assert np.isclose(gpu, cpu, rtol=1e-3, atol=1e-5).all(-1).mean() >= 0.99


def test_cloud_surfaces_frame_matches_cpu(dev):
    """The 32x24 cloud with chip_smoke.py's surfaces (a ground quad, a rough
    conductor and a glass sphere) by render_regen on the card and the CPU,
    one march launch per loop iteration on the card; means to
    chip_smoke.SURF_MEAN_TOL (see its comment), pixels as above."""
    from acceleratedvolrenderer_tpu_torch.parallel import render

    cs = _chip_smoke()
    imgs = []
    for d in (dev, torch.device("cpu")):
        march.launches = gather.launches = 0
        sc = cs.cloud_with_surfaces(presets.cloud(**cs.SMALL, device=d))
        img, st = render.render_regen(sc, device=d, **cs.SMALL_KNOBS)
        imgs.append(img)
        if d.type == "cuda":
            assert (march.launches, gather.launches) == (st["iterations"], 0)
    _assert_frames_close(*imgs, mean_tol=cs.SURF_MEAN_TOL)


@pytest.mark.parametrize("integrator", ["path", "volpath"])
def test_room_frame_matches_cpu(dev, integrator):
    """chip_smoke.py's room (no medium; a 912-triangle mesh on the trigrid
    route) at 32x24 through render() on the card and the CPU."""
    import dataclasses

    from acceleratedvolrenderer_tpu_torch.parallel import render

    cs = _chip_smoke()
    imgs = [render.render(dataclasses.replace(
        cs.cornell_room(32, 24, 2, d), integrator=integrator), device=d)[0]
        for d in (dev, torch.device("cpu"))]
    _assert_frames_close(*imgs)


def test_march_on_surface_cut_segments_matches_plain(dev):
    """march_block's inputs captured in a regen frame of the cloud with
    surfaces (segments cut at the surface hits) through the kernel and its
    plain version, as _march_case compares them."""
    from unittest import mock

    from acceleratedvolrenderer_tpu_torch.parallel import render

    cs = _chip_smoke()
    calls = []
    kernel = march.march_block

    def capture(*args, **kw):
        if len(calls) < 40:
            calls.append(([a.clone() if torch.is_tensor(a) else a
                           for a in args], dict(kw)))
        return kernel(*args, **kw)

    sc = cs.cloud_with_surfaces(presets.cloud(32, 24, spp=2, max_depth=8,
                                              grid_res=32, device=dev))
    with mock.patch.object(march, "march_block", capture):
        render.render_regen(sc, device=dev, **cs.SMALL_KNOBS)
    assert len(calls) == 40
    for args, kw in calls[::8]:
        names = ("majorant", "voxel", "next_t", "dt", "step", "t_exit",
                 "t_cur", "dl_target", "dl_since", "maxd_in", "hunting")
        _march_case(dict(zip(names, args[:11]), **kw), args[11], args[12])


@pytest.mark.parametrize("kind", ["independent", "stratified", "sobol",
                                  "paddedsobol", "zsobol", "pmj02bn",
                                  "halton"])
def test_film_sample_card_equals_cpu(dev, kind):
    """film_sample on the card equals the CPU bit for bit: u1, u2 and the
    stream, with and without pixel coordinates (pad pixels among them), at
    sample indices past the pmj02bn table."""
    from acceleratedvolrenderer_tpu_torch.models import samplers

    rng = np.random.default_rng(2)
    n = 20000
    pixidx = torch.as_tensor(rng.integers(0, 2 ** 32, n, dtype=np.int64))
    pixidx[:9] = -1
    pix = torch.as_tensor(np.stack([rng.integers(0, 1280, n),
                                    rng.integers(0, 720, n)], -1))
    pix[:9] = -1
    for spp in (1, 7, 1500):
        sidx = torch.as_tensor(rng.integers(0, 3 * spp, n, dtype=np.int64))
        for p in (None, pix):
            cpu = samplers.film_sample(kind, pixidx, sidx, spp, seed=3, pix=p)
            card = samplers.film_sample(
                kind, pixidx.to(dev), sidx.to(dev), spp, seed=3,
                pix=None if p is None else p.to(dev))
            for a, b in zip(card, cpu):
                assert a.device.type == "cuda"
                assert torch.equal(a.cpu(), b), (kind, spp, p is None)
        for dim in (0, 1, 7, 33):
            cpu = samplers.path_dim_sample(kind, pixidx, sidx, spp, dim)
            card = samplers.path_dim_sample(kind, pixidx.to(dev),
                                            sidx.to(dev), spp, dim)
            assert torch.equal(card.cpu(), cpu), (kind, dim)


def test_image_light_search_matches_searchsorted_on_card(dev):
    """The image light's per-lane binary search on the card against
    torch.searchsorted over each lane's row: ties, u on CDF entries, u 0
    and 1, flat rows."""
    from acceleratedvolrenderer_tpu_torch.models import lights

    rng = np.random.default_rng(4)
    img = rng.random((64, 128, 3)).astype(np.float32)
    img[10:12] = 0.0
    img[20, 30:60] = 0.0
    light = lights.ImageInfiniteLight(img)
    cdf = torch.as_tensor(light._cdf_cols, device=dev)
    n = 262144
    row = torch.as_tensor(rng.integers(0, 64, n), device=dev)
    u = torch.as_tensor(rng.random(n, dtype=np.float32), device=dev)
    u[:1000] = cdf[row[:1000], torch.as_tensor(rng.integers(0, 128, 1000),
                                               device=dev)]
    u[1000:1100] = 0.0
    u[1100:1200] = 1.0
    row[1200:3000] = 10
    row[3000:5000] = 20
    got = lights._search_rows(cdf.reshape(-1), 128, row, u)
    want = torch.searchsorted(cdf[row], u[:, None]).reshape(-1)
    assert torch.equal(got, want)
    cpu = lights._search_rows(cdf.reshape(-1).cpu(), 128, row.cpu(), u.cpu())
    assert torch.equal(got.cpu(), cpu)


def test_cli_scene_file_matches_cpu(dev, tmp_path):
    """The port's CLI on a 64x48 .pbrt cloud (chip_smoke.scene_file_text
    around a 32^3 grid printed by nanovdb2pbrt) on the card and with --cpu:
    the EXRs at phase 5's tolerances, one march launch per loop iteration
    on the card and none on the CPU."""
    import contextlib
    import io
    import json

    from acceleratedvolrenderer_tpu_torch.cli import nanovdb2pbrt, pbrt
    from acceleratedvolrenderer_tpu_torch.utils.image import read_exr

    cs = _chip_smoke()
    density = presets.cloud(64, 48, grid_res=32,
                            device="cpu").medium.density.numpy()
    block = io.StringIO()
    nanovdb2pbrt.emit_pbrt(density, [-100.0] * 3, [100.0] * 3, "density",
                           block)
    path = tmp_path / "cloud.pbrt"
    path.write_text(cs.scene_file_text(block.getvalue(), 64, 48))
    imgs = []
    for extra in ([], ["--cpu"]):
        out = str(tmp_path / f"cloud{len(extra)}.exr")
        buf = io.StringIO()
        march.launches = gather.launches = 0
        with contextlib.redirect_stdout(buf):
            assert pbrt.main([str(path), "-o", out, "--spp", "2", "--stats",
                              *extra]) == 0
        st = json.loads(buf.getvalue().strip().splitlines()[-1])
        want = (0, 0) if extra else (st["iterations"], 0)
        assert (march.launches, gather.launches) == want
        imgs.append(read_exr(out)[0])
    _assert_frames_close(*imgs)


@pytest.mark.parametrize("integ", ["lightpath", "bdpt", "sppm", "mlt"])
def test_cli_other_integrators_match_cpu(dev, tmp_path, integ):
    """cli/pbrt.py --integrator lightpath / bdpt / sppm / mlt on a 32x24
    file (chip_smoke.room_file_text; the fog box for BDPT) on the card and
    with --cpu, at chip_smoke.INTEG_MEAN_TOL and INTEG_PIXEL_SHARE (see
    their comment); MLT, whose chain may part on an accept that rounds the
    other way, by the reference's 15% mean gate.  No kernel launches."""
    import contextlib
    import io

    from acceleratedvolrenderer_tpu_torch.cli import pbrt
    from acceleratedvolrenderer_tpu_torch.ops import dma_gather
    from acceleratedvolrenderer_tpu_torch.utils.image import read_exr

    cs = _chip_smoke()
    path = tmp_path / "s.pbrt"
    path.write_text(cs.fog_box_file_text(24, 1) if integ == "bdpt"
                    else cs.room_file_text(32, 24))
    imgs = []
    for extra in ([], ["--cpu"]):
        out = str(tmp_path / f"o{len(extra)}.exr")
        march.launches = gather.launches = dma_gather.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            assert pbrt.main([str(path), "--integrator", integ, "-o", out,
                              *extra]) == 0
        assert (march.launches, gather.launches, dma_gather.launches) == (
            0, 0, 0)
        imgs.append(read_exr(out)[0][..., :3])
    gpu, cpu = imgs
    assert np.isfinite(gpu).all() and gpu.mean() > 0
    rel = abs(gpu.mean() - cpu.mean()) / cpu.mean()
    if integ == "mlt":
        assert rel < 0.15
    else:
        assert rel < cs.INTEG_MEAN_TOL
        close = np.isclose(gpu, cpu, rtol=1e-3, atol=1e-5).all(-1).mean()
        assert close >= cs.INTEG_PIXEL_SHARE


# ---- the MIP map, the subsurface and measured materials, hair and the
# sigmoid fit on the card against the CPU (chip_smoke phase 30's modules).
# The card's float32 arccos, atan2, sin, cos, exp and log differ from the
# CPU's by 1-2 ulp on 4-33% of their arguments (scripts/card_ulp_diag.py
# on an NVIDIA H100), and the measured BRDF's and hair's steep maps carry
# that past rtol 1e-5 on 0.3-0.6% of lanes (measured_f 99.445%, sampled
# directions 99.707%, hair_sample 99.518%; with the CPU's results for those
# functions 99.994%, 99.994% and 99.854%, no sample in another table row),
# so 99% of lanes at rtol 1e-5, and every lane within a bound: 1e-3 for
# values; a sample's f and pdf against the CPU's evaluation at the card's
# own direction ----

def _share_close(got, want, share, rtol, atol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    ok = np.isclose(got, want, rtol=rtol, atol=atol)
    ok = ok.reshape(len(ok), -1).all(-1)
    assert ok.mean() >= share, ok.mean()


def _both(dev, arrays):
    return ({k: torch.as_tensor(v, device=dev) for k, v in arrays.items()},
            {k: torch.as_tensor(v) for k, v in arrays.items()})


def test_item1_mipmap_matches_cpu(dev):
    from acceleratedvolrenderer_tpu_torch.models.mipmap import MIPMap

    rng = np.random.default_rng(0)
    mip = MIPMap(rng.random((96, 64, 3)).astype(np.float32))
    n = 8192
    on, cpu = _both(dev, dict(
        uv=rng.uniform(-1, 2, (n, 2)).astype(np.float32),
        w=np.exp(rng.uniform(-9, 0, n)).astype(np.float32),
        d0=(rng.normal(size=(n, 2)) * 0.05).astype(np.float32),
        d1=(rng.normal(size=(n, 2)) * 0.002).astype(np.float32)))
    for fn in (lambda a: mip.lookup_trilinear(a["uv"], a["w"]),
               lambda a: mip.lookup_ewa(a["uv"], a["d0"], a["d1"])):
        np.testing.assert_allclose(fn(on).cpu().numpy(), fn(cpu).numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("profile", ["burley", "tabulated"])
def test_item1_subsurface_exit_matches_cpu(dev, profile):
    from acceleratedvolrenderer_tpu_torch.models import bssrdf, materials
    from acceleratedvolrenderer_tpu_torch.models import shapes

    mat = materials.DiffuseMaterial(reflectance=0.5)
    prims = (shapes.Sphere(center=np.array([0.0, 0.0, 3.0]), radius=1.0,
                           material=mat),
             shapes.Quad(origin=np.array([-3.0, -1.0, 0.0]),
                         e1=np.array([6.0, 0, 0]), e2=np.array([0, 0, 6.0]),
                         material=mat))
    rng = np.random.default_rng(1)
    n = 16384
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    refl, mfp = np.array([0.8, 0.5, 0.3]), np.array([0.05, 0.1, 0.2])
    arrays = dict(ids=np.zeros(n, np.int64),
                  p=(np.array([0.0, 0.0, 3.0]) + v).astype(np.float32),
                  nrm=v.astype(np.float32),
                  alb=np.broadcast_to(refl, (n, 3)).astype(np.float32),
                  ell=np.broadcast_to(mfp, (n, 3)).astype(np.float32),
                  u0=rng.random(n).astype(np.float32),
                  u1=rng.random(n).astype(np.float32),
                  u2=rng.random(n).astype(np.float32))
    outs = []
    for a, d in zip(_both(dev, arrays), (dev, "cpu")):
        us = (a["u0"], a["u1"], a["u2"])
        if profile == "burley":
            outs.append(bssrdf.sample_exit(prims, a["ids"], a["p"], a["nrm"],
                                           a["alb"], a["ell"], *us))
        else:
            tab = bssrdf.tabulated_channel_arrays(
                bssrdf.compute_beam_diffusion_table(), refl, mfp, d)
            outs.append(bssrdf.sample_exit_tabulated(
                prims, a["ids"], a["p"], a["nrm"], tab, *us))
    (ep, en, w, found), (cep, cen, cw, cfound) = (
        [x.cpu().numpy() for x in o] for o in outs)
    ok = np.isclose(ep, cep, rtol=0, atol=1e-5).all(-1) & (found == cfound)
    assert ok.mean() >= 0.999 and cfound.mean() > 0.5
    _share_close(w[ok], cw[ok], 0.999, rtol=1e-4)


def test_item1_measured_matches_cpu(dev):
    from acceleratedvolrenderer_tpu_torch.models import measured

    brdf = measured.synthesize_ggx(alpha=0.3, res=32, n_theta=8)
    rng = np.random.default_rng(2)
    n = 16384
    dirs = lambda: (lambda v: v / np.linalg.norm(v, axis=1, keepdims=True))(
        rng.normal(size=(n, 3))).astype(np.float32)
    on, cpu = _both(dev, dict(
        wo=dirs(), wi=dirs(), u=rng.random((n, 2)).astype(np.float32),
        lam=rng.uniform(380, 720, (n, 4)).astype(np.float32)))
    for fn in (lambda a: measured.measured_f(brdf, a["wo"], a["wi"],
                                             a["lam"]),
               lambda a: measured.measured_pdf(brdf, a["wo"], a["wi"])):
        got, want = fn(on).cpu().numpy(), fn(cpu).numpy()
        _share_close(got, want, 0.99, rtol=1e-5)
        _share_close(got, want, 1.0, rtol=1e-3)
    wi, f, pdf, valid = (x.cpu().numpy() for x in measured.measured_sample(
        brdf, on["wo"], on["u"], on["lam"]))
    cwi, cf, cpdf, cvalid = (x.numpy() for x in measured.measured_sample(
        brdf, cpu["wo"], cpu["u"], cpu["lam"]))
    ok = np.isclose(wi, cwi, rtol=0, atol=1e-5).all(-1) & (valid == cvalid)
    assert ok.mean() >= 0.99
    _share_close(f[ok], cf[ok], 0.99, rtol=1e-4)
    _share_close(pdf[ok], cpdf[ok], 0.99, rtol=1e-4)
    # every valid lane: the card's f and pdf are the CPU's measured_f and
    # measured_pdf at the card's own direction, to the rtol at which the
    # CPU's own samples meet its own evaluation (f 1e-3; pdf 1e-2, as
    # measured_pdf inverts the warps again and a point within an ulp of a
    # cell edge takes the next cell's density)
    at = torch.as_tensor(wi)
    _share_close(f[valid], measured.measured_f(
        brdf, cpu["wo"], at, cpu["lam"]).numpy()[valid], 1.0, rtol=1e-3)
    _share_close(pdf[valid], measured.measured_pdf(
        brdf, cpu["wo"], at).numpy()[valid], 1.0, rtol=1e-2)


def test_item1_hair_matches_cpu(dev):
    from acceleratedvolrenderer_tpu_torch.models import hair

    rng = np.random.default_rng(3)
    n = 16384
    unit = lambda v: (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
        np.float32)
    on, cpu = _both(dev, dict(
        wo=unit(rng.normal(size=(n, 3))), wi=unit(rng.normal(size=(n, 3))),
        h=rng.uniform(-1, 1, n).astype(np.float32),
        sa=rng.uniform(0, 2, (n, 3)).astype(np.float32),
        u=rng.random((n, 4)).astype(np.float32)))
    prm = hair.HairParams(beta_m=0.3, beta_n=0.3)
    for fn in (lambda a: hair.hair_f(a["wo"], a["wi"], a["h"], a["sa"], prm),
               lambda a: hair.hair_pdf(a["wo"], a["wi"], a["h"], a["sa"],
                                       prm)):
        got, want = fn(on).cpu().numpy(), fn(cpu).numpy()
        _share_close(got, want, 0.999, rtol=1e-5)
        _share_close(got, want, 1.0, rtol=1e-3)
    got = hair.hair_sample(on["wo"], on["h"], on["sa"], prm, on["u"])
    want = hair.hair_sample(cpu["wo"], cpu["h"], cpu["sa"], prm, cpu["u"])
    ok = np.ones(n, bool)
    for a, b in zip(got, want):
        ok &= np.isclose(a.cpu().numpy(), b.numpy(), rtol=1e-5,
                         atol=1e-6).reshape(n, -1).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    # every lane: the card's f and pdf are the CPU's hair_f and hair_pdf at
    # the card's own direction
    wi, f, pdf = (x.cpu() for x in got)
    args = (cpu["wo"], wi, cpu["h"], cpu["sa"], prm)
    _share_close(f.numpy(), hair.hair_f(*args).numpy(), 1.0, rtol=1e-3)
    _share_close(pdf.numpy(), hair.hair_pdf(*args).numpy(), 1.0, rtol=1e-3)


def test_item1_sigmoid_fit_matches_cpu(dev):
    from acceleratedvolrenderer_tpu_torch.utils import spectrum as sp

    rgb = np.random.default_rng(4).random((512, 3)).astype(np.float32)
    got = sp.fit_sigmoid_polynomial(torch.as_tensor(rgb, device=dev))
    want = sp.fit_sigmoid_polynomial(rgb, device="cpu")
    assert got.device.type == "cuda"
    # rtol 1e-4, and an atol of 1e-5 of each coefficient's largest
    # magnitude: c0 crosses zero (1e-4 typical; 4e-10 apart on the card)
    want = want.numpy()
    scale = np.abs(want).max(0)
    np.testing.assert_array_less(np.abs(got.cpu().numpy() - want),
                                 1e-4 * np.abs(want) + 1e-5 * scale)


def test_item1_room_file_matches_cpu(dev, tmp_path):
    """chip_smoke.item1_file_text (the room with a subsurface and a
    measured sphere) at 32x24 by the pbrt CLI on the card and with --cpu,
    at chip_smoke.INTEG_MEAN_TOL / INTEG_PIXEL_SHARE; no kernel launches."""
    import contextlib
    import io

    from acceleratedvolrenderer_tpu_torch.cli import pbrt
    from acceleratedvolrenderer_tpu_torch.ops import dma_gather
    from acceleratedvolrenderer_tpu_torch.utils.image import read_exr

    cs = _chip_smoke()
    bsdf = tmp_path / "ggx.bsdf"
    cs.write_ggx_bsdf(bsdf)
    path = tmp_path / "s.pbrt"
    path.write_text(cs.item1_file_text(32, 24, bsdf))
    imgs = []
    for extra in ([], ["--cpu"]):
        out = str(tmp_path / f"o{len(extra)}.exr")
        march.launches = gather.launches = dma_gather.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            assert pbrt.main([str(path), "-o", out, *extra]) == 0
        assert (march.launches, gather.launches, dma_gather.launches) == (
            0, 0, 0)
        imgs.append(read_exr(out)[0][..., :3])
    gpu, cpu = imgs
    assert np.isfinite(gpu).all() and gpu.mean() > 0
    assert abs(gpu.mean() - cpu.mean()) / cpu.mean() < cs.INTEG_MEAN_TOL
    close = np.isclose(gpu, cpu, rtol=1e-3, atol=1e-5).all(-1).mean()
    assert close >= cs.INTEG_PIXEL_SHARE


@pytest.mark.parametrize("what", ["cloud", "fog_box"])
def test_sharding_world1_nccl_matches_render_regen(dev, what):
    """A world of one over NCCL: render_sharded_regen of a 32x24 cloud
    (the march kernel, one launch per iteration) and of
    tests/test_multichip.py's 16x16 fog box (its 1^3 table: the window
    route, one gather launch per iteration) equals render_regen's frame
    with the same knobs within 3e-5 (test_multichip.py's bound)."""
    import socket

    import torch.distributed as dist

    from acceleratedvolrenderer_tpu_torch.parallel import distributed
    from acceleratedvolrenderer_tpu_torch.parallel import mesh as pmesh
    from acceleratedvolrenderer_tpu_torch.parallel import render

    if what == "cloud":
        scene = presets.cloud(32, 24, spp=2, max_depth=8, grid_res=32,
                              device=dev)
        knobs = dict(n_lanes=256, k_substeps=8, accum_spp=True,
                     retire_groups=2)
        counter = march
    else:
        scene = presets.fog_box(res=16, spp=4, device=dev)
        knobs = dict(n_lanes=64)
        counter = gather
    ref, _ = render.render_regen(scene, device=dev, **knobs)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    assert distributed.initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        mesh = pmesh.make_mesh(device=dev)
        assert (mesh.rank, mesh.size) == (0, 1)
        before = counter.launches
        img, st = pmesh.render_sharded_regen(scene, mesh, **knobs)
        assert counter.launches - before == st["iterations"] > 0
    finally:
        dist.destroy_process_group()
    assert st["n_devices"] == 1
    assert np.abs(img - ref).max() <= 3e-5


@pytest.mark.parametrize("seed", [0, 42, 2 ** 31 - 1])
def test_threefry_keys_card_equals_cpu(dev, seed):
    """utils/rng.py on the card: the keys, hashes and uniforms of 65,536
    random (pixel, sample) pairs equal the CPU's bit for bit."""
    from acceleratedvolrenderer_tpu_torch.utils import rng

    g = np.random.default_rng(seed % 1000)
    p = g.integers(-2 ** 31, 2 ** 31, 65536).astype(np.int32)
    s = g.integers(0, 2 ** 31, 65536).astype(np.int32)
    out = {}
    for d in (dev, torch.device("cpu")):
        key = rng.base_key(seed, device=d)
        k = rng.pixel_sample_key(key, torch.as_tensor(p, device=d),
                                 torch.as_tensor(s, device=d))
        h = rng.hash_uint32(k[:, 0])
        out[d.type] = [x.cpu().numpy() for x in (k, h,
                                                 rng.uniform_from_bits(h))]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert np.array_equal(a, b)
