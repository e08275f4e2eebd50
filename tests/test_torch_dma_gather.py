"""The port's tile-DMA gather (ops/dma_gather.py) against the TPU kernel of
scripts/measure_gather_designs.py (dma_gather, _dma_kernel) run in Pallas
interpret mode, and against a numpy reference.

- dma_gather_plain equals the Pallas kernel bitwise (a copy does no
  arithmetic) at chunk 16 / 100 / 1000 over a 64-tile table: the ring's
  slot 0 at the end holds the tile of index 16 * floor((chunk - 1) / 16).
- Out-of-range tile ids (which the Pallas kernel cannot take): the numpy
  reference fills the slot with zeros.
- On CPU tensors the wrapper runs the plain version and launches nothing.

The script sets the JAX compilation-cache options in its module body; the
fixture restores them, so they do not leak into later tests on the same
worker."""
import importlib.util
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu_torch.ops import dma_gather as dma

from torch_port_util import interpret_pallas  # noqa: F401  (fixture)

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / \
    "measure_gather_designs.py"
N_TILES = 64
_CONFIG = ("jax_compilation_cache_dir",
           "jax_persistent_cache_min_compile_time_secs")
_ENV = "JAX_COMPILATION_CACHE_DIR"


@pytest.fixture(scope="module")
def designs():
    """The JAX script as a module, with the global settings its import
    changes restored afterwards."""
    saved = {k: getattr(jax.config, k) for k in _CONFIG}
    env, path = os.environ.get(_ENV), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "measure_gather_designs", SCRIPT)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        if env is None:
            os.environ.pop(_ENV, None)
        else:
            os.environ[_ENV] = env
        sys.path[:] = path
    return mod, saved


def _table():
    return np.random.default_rng(0).random(N_TILES * 1024).astype(np.float32)


def test_script_import_leaves_config(designs):
    mod, saved = designs
    assert mod.SLOTS == dma.SLOTS
    assert {k: getattr(jax.config, k) for k in _CONFIG} == saved


@pytest.mark.parametrize("chunk", [16, 100, 1000])
def test_plain_matches_pallas_kernel(interpret_pallas, designs, chunk):
    table = _table()
    idx = np.random.default_rng(chunk).integers(0, N_TILES, chunk) \
        .astype(np.int32)
    ref = np.asarray(designs[0].dma_gather(jnp.asarray(table),
                                           jnp.asarray(idx), chunk))
    out = dma.dma_gather_plain(torch.as_tensor(table), torch.as_tensor(idx))
    assert out.shape == ref.shape == (8, 128)
    assert np.array_equal(out.numpy(), ref)
    j = dma.last_slot0(chunk)
    assert np.array_equal(ref, table.reshape(-1, 8, 128)[idx[j]])


@pytest.mark.parametrize("chunk", [1, 15, 16, 17, 100])
@pytest.mark.parametrize("bad", [-1, N_TILES, N_TILES + 9])
def test_out_of_range_fills_zeros(chunk, bad):
    """numpy reference of the ring: every fetch lands in slot j % 16, an
    out-of-range id zeroes its slot; the output is slot 0."""
    table = _table()
    idx = np.random.default_rng(chunk).integers(0, N_TILES, chunk) \
        .astype(np.int32)
    idx[dma.last_slot0(chunk)] = bad
    t3 = table.reshape(-1, 8, 128)
    ring = np.full((dma.SLOTS, 8, 128), np.nan, np.float32)
    for j, t in enumerate(idx):
        ring[j % dma.SLOTS] = t3[t] if 0 <= t < N_TILES else 0.0
    out = dma.dma_gather(torch.as_tensor(table), torch.as_tensor(idx))
    assert np.array_equal(out.numpy(), ring[0])
    assert not out.any()


def test_cpu_wrapper_launches_nothing():
    before = dma.launches
    idx = torch.arange(40, dtype=torch.int32)
    out = dma.dma_gather(torch.as_tensor(_table()), idx)
    assert dma.launches == before
    assert torch.equal(out, torch.as_tensor(_table()).reshape(-1, 8, 128)[32])


@pytest.mark.parametrize("max_blocks", [1, 2, 3, 16, 131, 132, 133, 264])
def test_launch_geometry_covers_the_chunk(max_blocks):
    """Over chunk 1 .. 70,000: the slices [b * per, min((b + 1) * per,
    chunk)) of the blocks cover every id exactly once, none is empty or
    longer than MAX_PER, there are about max_blocks of them (more only
    where MAX_PER forces it), and the owner j* // per holds j*."""
    for chunk in range(1, 70001):
        blocks, per = dma.launch_geometry(chunk, max_blocks)
        assert 1 <= per <= dma.MAX_PER
        assert (blocks - 1) * per < chunk <= blocks * per
        assert blocks <= max(max_blocks, -(-chunk // dma.MAX_PER))
        j = dma.last_slot0(chunk)
        owner = j // per
        assert owner < blocks and owner * per <= j < min((owner + 1) * per,
                                                         chunk)


def test_launch_geometry_slices_are_disjoint():
    """The slices, laid end to end, are the ids 0 .. chunk - 1 in order,
    for every max_blocks from 1 to 264."""
    for max_blocks in range(1, 265):
        for chunk in (1, 15, 16, 17, 131, 132 * 16, 16384, 65536, 70000):
            blocks, per = dma.launch_geometry(chunk, max_blocks)
            ids = np.concatenate([np.arange(b * per,
                                            min((b + 1) * per, chunk))
                                  for b in range(blocks)])
            assert np.array_equal(ids, np.arange(chunk)), (chunk, max_blocks)
