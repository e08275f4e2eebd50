"""The port's PCG streams and stream seeds are bitwise equal to the JAX
package's (ops/dda.py) over 10^5 random uint32 states, including states
and indices near 2^32; its Threefry keys and hashes (utils/rng.py) to
JAX's legacy uint32 keys (jax.random.PRNGKey / fold_in), with
jax_threefry_partitionable on (tests/conftest.py) and off."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.ops import dda as jdda
from acceleratedvolrenderer_tpu.utils import rng as jrng
from acceleratedvolrenderer_tpu_torch.ops import dda as tdda
from acceleratedvolrenderer_tpu_torch.utils import rng as trng

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


SEEDS = [0, 1, 42, 7919, 2 ** 31 - 1, -5]


def _jkey_words(key):
    return np.asarray(key).astype(np.int64)


@pytest.fixture(params=[True, False], ids=["partitionable", "classic"])
def threefry_mode(request):
    """jax_threefry_partitionable on (the suite's setting) and off."""
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    yield
    jax.config.update("jax_threefry_partitionable", before)


@pytest.mark.parametrize("seed", SEEDS)
def test_base_key_bitwise(seed, threefry_mode):
    assert np.array_equal(_jkey_words(jrng.base_key(seed)),
                          trng.base_key(seed, device="cpu").numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_pixel_sample_key_bitwise(seed, threefry_mode):
    """Random (pixel, sample) arrays over the whole int32 range, so
    pixel * 9781 + sample wraps around."""
    rng = np.random.default_rng(abs(seed) % 1000)
    p = rng.integers(-2 ** 31, 2 ** 31, 4096).astype(np.int32)
    s = rng.integers(0, 2 ** 31, 4096).astype(np.int32)
    p[:4] = [2 ** 31 - 1, -2 ** 31, 219_557, 0]    # 219,557 * 9781 > 2^31
    want = _jkey_words(jrng.pixel_sample_key(jrng.base_key(seed),
                                             jnp.asarray(p), jnp.asarray(s)))
    got = trng.pixel_sample_key(trng.base_key(seed, device="cpu"), torch.as_tensor(p),
                                torch.as_tensor(s)).numpy()
    assert got.shape == (4096, 2)
    assert np.array_equal(want, got)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_array_bitwise(seed, threefry_mode):
    d = _u32(seed % 5)[:4096].reshape(64, 64)
    want = _jkey_words(jrng.fold_in_array(jrng.base_key(seed),
                                          jnp.asarray(d)))
    got = trng.fold_in_array(trng.base_key(seed, device="cpu"), _t(d)).numpy()
    assert got.shape == (64, 64, 2)
    assert np.array_equal(want, got)


def test_hash_and_uniform_bitwise():
    x = _u32(6)
    assert np.array_equal(
        np.asarray(jrng.hash_uint32(jnp.asarray(x))).astype(np.int64),
        trng.hash_uint32(_t(x)).numpy())
    u = trng.uniform_from_bits(_t(x))
    assert u.dtype == torch.float32
    assert np.array_equal(np.asarray(jrng.uniform_from_bits(jnp.asarray(x))),
                          u.numpy())


def test_entries_need_the_card_or_a_device(monkeypatch):
    """Without CUDA and without device=, base_key and the dense spectrum's
    table raise rather than fall back to the CPU."""
    from acceleratedvolrenderer_tpu_torch.utils import spectrum as tsp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trng.base_key(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsp.DenselySampledSpectrum(np.ones(471, np.float32))
    assert trng.base_key(0, device="cpu").device.type == "cpu"
