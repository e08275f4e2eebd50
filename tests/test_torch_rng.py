"""The port's PCG streams and stream seeds are bitwise equal to the JAX
package's (ops/dda.py) over 10^5 random uint32 states, including states
and indices near 2^32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.ops import dda as jdda
from acceleratedvolrenderer_tpu_torch.ops import dda as tdda

torch.set_num_threads(2)

N = 100_000


def _u32(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** 32, N, dtype=np.uint64)
    x[:64] = 2 ** 32 - 1 - np.arange(64, dtype=np.uint64)   # near 2^32
    x[64:72] = np.arange(8, dtype=np.uint64)                # near 0
    return x.astype(np.uint32)


def _t(x):
    return torch.as_tensor(x.astype(np.int64))


def test_pcg_step_bitwise():
    s = _u32(0)
    js, jbits = jdda.pcg_step(jnp.asarray(s))
    ts, tbits = tdda.pcg_step(_t(s))
    assert np.array_equal(np.asarray(js).astype(np.int64), ts.numpy())
    assert np.array_equal(np.asarray(jbits).astype(np.int64), tbits.numpy())


def test_pcg_uniform_stream_bitwise():
    """Eight successive draws: states and float32 uniforms identical."""
    s = _u32(1)
    js, ts = jnp.asarray(s), _t(s)
    for _ in range(8):
        js, ju = jdda.pcg_uniform(js)
        ts, tu = tdda.pcg_uniform(ts)
        assert tu.dtype == torch.float32
        assert np.array_equal(np.asarray(ju), tu.numpy())
    assert np.array_equal(np.asarray(js).astype(np.int64), ts.numpy())


def test_pcg_uniform_masked_advances_only_consumed():
    s = _u32(2)
    consume = np.random.default_rng(3).random(N) < 0.5
    js, ju = jdda.pcg_uniform_masked(jnp.asarray(s), jnp.asarray(consume))
    ts, tu = tdda.pcg_uniform_masked(_t(s), torch.as_tensor(consume))
    assert np.array_equal(np.asarray(js).astype(np.int64), ts.numpy())
    assert np.array_equal(np.asarray(ju), tu.numpy())
    assert np.array_equal(ts.numpy()[~consume], s[~consume].astype(np.int64))


@pytest.mark.parametrize("salt", [0, 17, 0x9A7, 2 ** 32 - 1])
def test_seed_stream_bitwise(salt):
    """Products such as x * 0x9E3779B9 reach 2^64: the port splits them
    into 16-bit halves, and must keep the low 32 bits exactly."""
    p, s = _u32(4 + salt % 7), _u32(5 + salt % 11)
    jh = jdda.seed_stream(jnp.asarray(p), jnp.asarray(s), salt=salt)
    th = tdda.seed_stream(_t(p), _t(s), salt=salt)
    assert np.array_equal(np.asarray(jh).astype(np.int64), th.numpy())
    assert th.min() >= 0 and th.max() < 2 ** 32
