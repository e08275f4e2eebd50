"""Counter-based RNG keys
(port of acceleratedvolrenderer_tpu/utils/rng.py: base_key,
pixel_sample_key, fold_in_array, hash_uint32 and uniform_from_bits).

Every random number is a function of (pixel, sample, depth, purpose)
folded into a key, so any path is replayable from its indices alone.  The
keys are JAX's legacy uint32 Threefry-2x32 keys bit for bit
(`jax.random.PRNGKey`, `jax.random.fold_in`): a key is a (..., 2) tensor
of its two words.  torch has no full uint32 arithmetic, so the words are
int64 tensors held below 2^32 (`& 0xFFFFFFFF` after every add, shift and
product).  `jax_threefry_partitionable` changes how JAX splits keys and
draws bits from them, not PRNGKey or fold_in.
"""
from __future__ import annotations

import torch

from ..ops.dda import _mul32
from .device import resolve

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds, JAX's) of the count words x0, x1
    under the key words k0, k1; all int64 tensors below 2^32 that
    broadcast.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def base_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed): the (2,) words (high, low 32 bits of the
    seed; a 32-bit seed's high word is 0), on `device` (the card unless
    given).  fold_in_array and pixel_sample_key follow the key's device."""
    seed = int(seed)
    hi = (seed >> 32) & _M32 if not -2 ** 31 <= seed < 2 ** 32 else 0
    return torch.tensor([hi, seed & _M32], dtype=torch.int64,
                        device=resolve(device))


def fold_in_array(key, data):
    """jax.random.fold_in of `key` with every element of the integer array
    `data` (taken mod 2^32, as its uint32 cast): keys of shape
    data.shape + (2,)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], -1)


def pixel_sample_key(key, pixel_index, sample_index):
    """Key of one (pixel, spp-index) pair, arguments may be arrays:
    fold_in(key, 0), then fold_in of pixel * 9781 + sample (int32
    arithmetic with wraparound)."""
    k = fold_in_array(key, torch.zeros((), dtype=torch.int64))
    p = torch.as_tensor(pixel_index, device=key.device).to(torch.int64)
    s = torch.as_tensor(sample_index, device=key.device).to(torch.int64)
    return fold_in_array(k, (_mul32(p & _M32, 9781) + s) & _M32)


def hash_uint32(x):
    """MurmurHash3's finalizer of uint32 values (held in int64)."""
    x = torch.as_tensor(x).to(torch.int64) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform_from_bits(bits):
    """uint32 bits (held in int64) -> float32 in [0, 1)."""
    bits = torch.as_tensor(bits).to(torch.int64) & _M32
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
