"""Pixel-sample generation (port of acceleratedvolrenderer_tpu/models/samplers.py).

Reference: src/pbrt/samplers.h (Independent :442, Stratified :568, Halton
:33, Sobol :479, PaddedSobol :144, ZSobol :225, PMJ02BN :367).  A sampler
has no state: every dimension is a pure function of (pixel index, sample
index, purpose).  `film_sample` gives the film jitter of a camera sample
and the PCG stream of its later draws; `path_dim_sample` and `PathSampler`
give the path-interior dimensions of the `path` integrator.

  independent — PCG uniforms
  stratified  — the sample index mapped to a sqrt(spp) x sqrt(spp) stratum,
                jittered
  sobol       — the Owen-scrambled (0,2) sequence (van der Corput and the
                second Sobol dimension), scrambled per pixel
  paddedsobol — the (0,2) pair at a per-pixel permutation of the index
  zsobol      — the index from a hashed, nested base-4 permutation of the
                (pixel, sample) Morton code, then the (0,2) point
  halton      — radical inverses in bases 2 and 3, digits scrambled per
                pixel
  pmj02bn     — generated pmj02bn tables (models/pmj02.py), shifted per
                pixel by a blue-noise texture

uint32 arithmetic: values in [0, 2^32) are held in int64 tensors and every
step masks with 0xFFFFFFFF (as ops/dda.py's PCG streams); a product of two
such values is split into 16-bit halves (`_mul32v`), so no intermediate
passes 2^49.  The bit-serial loops of the reference (the Sobol matrix, the
Morton interleave, the bit reversal) run as XORs / ORs of byte tables:
the same bits in a fraction of the launches.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..ops import dda
from ..ops.dda import _mul32
from ..utils.device import per_device
from ..utils.math import exact_div
from . import pmj02 as pmj02_mod

_M32 = 0xFFFFFFFF
KINDS = ("independent", "stratified", "sobol", "paddedsobol", "zsobol",
         "pmj02bn", "halton")


def _u32(x, device=None):
    """x as an int64 tensor holding its uint32 value (-1 -> 0xFFFFFFFF, as
    jnp.asarray(x, jnp.uint32) turns it)."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def _mul32v(x, y):
    """(x * y) mod 2^32 for x, y in [0, 2^32) held in int64 (y a tensor)."""
    lo = x * (y & 0xFFFF)
    hi = ((x * (y >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


# ---- byte tables, built on the host once and copied once per device ----

def _rev8():
    return np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.int64)


def _sobol2_bytes():
    """(1024,) table: entry 256 k + b is the XOR of the dimension-2 Sobol
    direction numbers v_{8k + j} over the set bits j of byte b."""
    vs, vv = [], 1 << 31
    for _ in range(32):
        vs.append(vv)
        vv = vv ^ (vv >> 1)
    out = np.zeros(1024, np.int64)
    for k in range(4):
        for b in range(256):
            acc = 0
            for j in range(8):
                if (b >> j) & 1:
                    acc ^= vs[8 * k + j]
            out[256 * k + b] = acc
    return out


def _spread8():
    """(256,) table: the 8 bits of b at the even positions of 16 bits."""
    return np.array([sum(((b >> j) & 1) << (2 * j) for j in range(8))
                     for b in range(256)], np.int64)


_HOST_TABLES = {"rev8": _rev8(), "sobol2": _sobol2_bytes(),
                "spread8": _spread8()}
# holders of the per-device copies (utils/device.py::per_device)
_BYTE_TABLES, _PMJ02_TABLES = SimpleNamespace(), SimpleNamespace()


def _table(name, device):
    return per_device(_BYTE_TABLES, device, lambda dev: {
        k: torch.as_tensor(v, device=dev) for k, v in _HOST_TABLES.items()
    })[name]


def _pmj02_tensors(device):
    """The pmj02bn tables (N_SETS, T, 2) and blue-noise texture (64, 64, 2)
    as float32 tensors on `device` (generated or read once)."""
    return per_device(_PMJ02_TABLES, device, lambda dev: tuple(
        torch.as_tensor(a, device=dev) for a in pmj02_mod.get_tables(0)))


def _reverse_bits32(x):
    r = _table("rev8", x.device)
    return ((r[x & 255] << 24) | (r[(x >> 8) & 255] << 16)
            | (r[(x >> 16) & 255] << 8) | r[(x >> 24) & 255])


def _sobol_dim2(i):
    """Second Sobol dimension (direction numbers v_k = v_{k-1} ^ (v_{k-1}
    >> 1), v_0 = 2^31): the XOR of the columns of the set bits of i."""
    t = _table("sobol2", i.device)
    return (t[i & 255] ^ t[256 + ((i >> 8) & 255)]
            ^ t[512 + ((i >> 16) & 255)] ^ t[768 + ((i >> 24) & 255)])


def _owen_hash(x, seed):
    """Laine-Karras hash scramble of a reversed-bit sequence value (the
    cheap Owen scrambling of modern Sobol samplers); seed a tensor or an
    int."""
    x = x ^ _mul32(x, 0x3D20ADEA)
    x = (x + seed) & _M32
    m = (seed >> 16) | 1
    x = _mul32(x, m) if isinstance(m, int) else _mul32v(x, m)
    x = x ^ _mul32(x, 0x05526C56)
    x = x ^ _mul32(x, 0x53A22864)
    return x


def _u01(bits):
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _feistel_pow2(i, bits: int, key):
    """Bijective permutation of [0, 2^bits): a 4-round balanced Feistel
    network keyed by a uint32 (PermutationElement, util/hash.h, on
    power-of-two domains)."""
    hb = bits // 2
    lb = bits - hb
    L = (i >> lb) & ((1 << hb) - 1)
    R = i & ((1 << lb) - 1)
    for r in range(4):
        f = _owen_hash(R ^ ((r * 0x68BC21EB) & _M32), key)
        L, R = R, L ^ (f & ((1 << hb) - 1))
        hb, lb = lb, hb
    return ((L << lb) | R) & ((1 << bits) - 1)


def _pmj02_index(i, key, permute_epoch0: bool = False):
    """Sample index -> pmj02 table slot: epoch 0 keeps the designed
    progressive order (unless permute_epoch0), each later wrap epoch covers
    the table in a bijective order of its own."""
    T = pmj02_mod.TABLE_SIZE
    tbits = int(np.log2(T))
    epoch = i // T
    ekey = _owen_hash(epoch, key | 1)
    perm = _feistel_pow2(i & (T - 1), tbits, ekey)
    if permute_epoch0:
        return perm
    return torch.where(epoch == 0, i & (T - 1), perm)


def _radical_inverse_digits(i, perm_seed, base: int, n_digits: int):
    """Digit-scrambled radical inverse in `base` over n_digits digits; the
    shift of each digit comes from an LCG of perm_seed.  float32 sums in
    the reference's order, each weight the float32 rounding of the python
    double 1 / base^k."""
    frac = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    inv = 1.0 / base
    x = i
    s = perm_seed
    for _ in range(n_digits):
        digit = x % base
        s = (_mul32(s, 0x9E3779B9) + 1) & _M32
        shift = (s >> 16) % base
        frac = frac + ((digit + shift) % base).to(torch.float32) * float(
            np.float32(inv))
        inv /= base
        x = x // base
    return torch.clamp(frac, max=float(np.float32(1.0 - 1e-7)))


def _radical_inverse_base3(i, perm_seed):
    """Base-3 radical inverse with per-pixel digit shifts (3^20 > 2^31)."""
    return _radical_inverse_digits(i, perm_seed, 3, 20)


def _morton2(x, y, bits=16):
    """Interleave the low `bits` of x (even positions) and y (odd)."""
    s = _table("spread8", x.device)
    m = torch.zeros_like(x)
    for k in range((bits + 7) // 8):
        mask = (1 << min(8, bits - 8 * k)) - 1
        m = (m | (s[(x >> (8 * k)) & mask] << (16 * k))
             | (s[(y >> (8 * k)) & mask] << (16 * k + 1)))
    return m


def _zsobol_index(pix, sample_index, spp: int, seed):
    """ZSobolSampler index assignment (samplers.h:225): the (pixel, sample)
    Morton code under a nested, hash-keyed base-4 digit permutation (each
    digit's permutation keyed by the digits above it)."""
    log2_spp = max(int(np.ceil(np.log2(max(spp, 1)))), 0)
    m = _morton2(pix[..., 0], pix[..., 1], bits=12)
    idx = ((m << log2_spp) & _M32) | sample_index
    n_digits = (24 + log2_spp + 1) // 2
    out = torch.zeros_like(idx)
    prefix = torch.zeros_like(idx)
    for d in range(n_digits - 1, -1, -1):
        digit = (idx >> (2 * d)) & 3
        key = _owen_hash(prefix ^ (0x55 + d), seed)
        out = out | (((digit + (key >> 24)) & 3) << (2 * d))
        prefix = ((prefix << 2) & _M32) | digit
    return out


def _sobol02(i, scr):
    """The Owen-scrambled (0,2) point of index i: van der Corput hashed in
    the index domain, and the second Sobol dimension scrambled apart."""
    d1 = _reverse_bits32(_owen_hash(i, scr))
    d2 = _reverse_bits32(_owen_hash(_reverse_bits32(_sobol_dim2(i)),
                                    scr ^ 0x9E3779B9))
    return _u01(d1), _u01(d2)


def film_sample(kind: str, pixel_index, sample_index, spp: int, seed: int = 0,
                pix=None):
    """((N,) u1, (N,) u2) film-jitter uniforms plus the advanced PCG stream
    for the sample's later draws.  pixel_index / sample_index: integer
    tensors holding uint32 values (or -1 for a pad pixel); pix: optional
    (N, 2) integer pixel coordinates, the spatial index of zsobol and
    pmj02bn (a hash of pixel_index without it)."""
    if kind not in KINDS:
        raise ValueError(f"unknown sampler '{kind}'")
    p_idx = _u32(pixel_index)
    dev = p_idx.device
    s_idx = _u32(sample_index, dev)
    rng = dda.seed_stream(p_idx, s_idx, salt=seed)
    rng, ua = dda.pcg_uniform(rng)
    rng, ub = dda.pcg_uniform(rng)
    if kind == "independent":
        return ua, ub, rng

    if kind == "stratified":
        nx = max(int(np.floor(np.sqrt(spp))), 1)
        ny = max(spp // nx, 1)
        s = s_idx % (nx * ny)
        u1 = exact_div((s % nx).to(torch.float32) + ua, nx)
        u2 = exact_div((s // nx).to(torch.float32) + ub, ny)
        return u1, u2, rng

    if kind == "zsobol":
        sd = seed & _M32
        xy = (_u32(pix, dev) if pix is not None else
              torch.stack([p_idx & 0xFFF, p_idx >> 12], -1))
        idx = _zsobol_index(xy, s_idx, spp, sd)
        # one global scramble: the spatial decorrelation is the index
        # permutation's, which gives the blue-noise error distribution
        u1, u2 = _sobol02(idx, 0xA511E9B3 ^ sd)
        return u1, u2, rng

    if kind == "pmj02bn":
        tables, bn = _pmj02_tensors(dev)
        i = _pmj02_index(s_idx, (0xE0C0 ^ (seed * 0x9E37)) & _M32)
        u = tables[0][i]
        if pix is not None:
            xy = _u32(pix, dev)
            bx, by = xy[..., 0] % 64, xy[..., 1] % 64
        else:
            bx, by = p_idx % 64, (p_idx // 64) % 64
        # the seed rotates the texture, so independent renders decorrelate
        sx = int(_owen_hash(_u32(seed), 0x51)) % 64
        shift = bn[(by + sx) % 64, (bx + sx) % 64]
        s1 = u[..., 0] + shift[..., 0]
        s2 = u[..., 1] + shift[..., 1]
        # x mod 1 of a sum in [0, 2): exact, as the reference's remainder
        return s1 - torch.floor(s1), s2 - torch.floor(s2), rng

    pix_seed = dda.seed_stream(p_idx, torch.zeros_like(p_idx),
                               salt=seed + 77)
    if kind == "sobol":
        u1, u2 = _sobol02(s_idx, pix_seed)
        return u1, u2, rng

    if kind == "paddedsobol":
        # per pixel a permuted slice of the sequence: a 4-round Feistel
        # network over the next power of two of spp (PaddedSobolSampler)
        bits = max(int(np.ceil(np.log2(max(spp, 2)))), 2)
        lo_b = bits // 2
        hi_b = bits - lo_b
        lo = s_idx & ((1 << lo_b) - 1)
        hi = (s_idx >> lo_b) & ((1 << hi_b) - 1)
        for r in range(4):
            f = _owen_hash(lo ^ ((r * 0x68BC21EB) & _M32), pix_seed)
            hi, lo = lo & ((1 << lo_b) - 1), hi ^ (f & ((1 << hi_b) - 1))
            lo_b, hi_b = hi_b, lo_b
        u1, u2 = _sobol02(((hi << lo_b) | lo) & _M32, pix_seed)
        return u1, u2, rng

    # halton: base 2 scrambled by the hash, base 3 by digit shifts
    d1 = _reverse_bits32(_owen_hash(s_idx, pix_seed))
    u2 = _radical_inverse_base3(s_idx, pix_seed ^ 0x68BC21EB)
    return _u01(d1), u2, rng


# ---------------------------------------------------------------------------
# Path-interior dimensions: a per-dimension scrambled radical inverse in the
# first 32 prime bases, a pure function of (pixel, sample index, dim), with
# per-(pixel, dim) digit scrambling (the PaddedSobol padding construction).
# ---------------------------------------------------------------------------

_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
           59, 61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113,
           127, 131)


def _radical_inverse_scrambled(base: int, i, perm_seed):
    """Digit-scrambled radical inverse in `base` (util/lowdiscrepancy.h
    ScrambledRadicalInverse); perm_seed (N,) the per-lane key, so lanes of
    one key share one permutation.  Base 2 is the hash scramble."""
    if base == 2:
        return _u01(_reverse_bits32(_owen_hash(i, perm_seed)))
    return _radical_inverse_digits(i, perm_seed, base,
                                   int(np.ceil(32.0 / np.log2(base))))


def path_dim_sample(kind: str, pixel_index, sample_index, spp: int,
                    dim: int, seed: int = 0):
    """One (N,) uniform of path dimension `dim`: halton, sobol, zsobol and
    paddedsobol a scrambled radical inverse in the dim-th prime base;
    pmj02bn the remaining table sets with a blue-noise shift; stratified 1D
    strata over spp with hashed jitter; any other kind PCG noise keyed by
    (pixel, sample, dim)."""
    pix = _u32(pixel_index)
    i = _u32(sample_index, pix.device)
    if kind == "stratified":
        rng = dda.seed_stream(pix, i, salt=(seed ^ (0x5D1 + 0x9E37 * dim))
                              & _M32)
        _, jit = dda.pcg_uniform(rng)
        shift_rng = dda.seed_stream(pix, torch.zeros_like(pix),
                                    salt=(seed ^ (0xA51 + 0x68BC * dim))
                                    & _M32)
        _, shift = dda.pcg_uniform(shift_rng)
        n = max(int(spp), 1)
        stratum = ((i + (shift * n).to(torch.int64)) & _M32) % n
        return exact_div(stratum.to(torch.float32) + jit, n)
    if kind == "pmj02bn":
        tables, bn = _pmj02_tensors(pix.device)
        n_sets = pmj02_mod.N_SETS
        tab = tables[1 + (dim % (n_sets - 1))]
        # a dimension that reuses a set takes it in a dim-keyed bijective
        # order, so dims d and d + 4 are not rank-correlated
        reuse = dim // (n_sets - 1)
        ii = _pmj02_index(i, (0xC2B2AE35 * (reuse + seed + 1)) & _M32,
                          permute_epoch0=reuse > 0)
        u = tab[ii, dim % 2]
        bx, by = pix % 64, (pix // 64) % 64
        sx = (0x9E3779B9 * (dim + seed + 1)) % 64
        s = u + bn[(by + sx) % 64, (bx + 2 * sx) % 64, dim % 2]
        return s - torch.floor(s)
    if kind in ("halton", "sobol", "zsobol", "paddedsobol"):
        scr = dda.seed_stream(pix, torch.zeros_like(pix),
                              salt=(seed ^ (0x77 + 0x9E3779B9 * dim)) & _M32)
        return _radical_inverse_scrambled(_PRIMES[dim % len(_PRIMES)], i,
                                          scr)
    rng = dda.seed_stream(pix, i, salt=(seed ^ (0xD1CE + 0x85EB * dim))
                          & _M32)
    return dda.pcg_uniform(rng)[1]


class PathSampler:
    """A uniform source over the path dimensions (the `uniform_source` seam
    of models/integrators/path.py::li_path, beside PCGSource): successive
    next() calls take dimensions 0, 1, 2, ... of the (pixel, sample) point;
    past `max_dims` it draws from its own PCG stream, as the reference's
    Sobol samplers wrap past their table width."""

    def __init__(self, kind, pixel_index, sample_index, spp, seed=0,
                 max_dims: int = 32, rng=None):
        self.kind = kind
        self.pixel_index = pixel_index
        self.sample_index = sample_index
        self.spp = int(spp)
        self.seed = int(seed)
        self.max_dims = int(max_dims)
        self.dim = 0
        if rng is None:
            p = _u32(pixel_index)
            rng = dda.seed_stream(p, _u32(sample_index, p.device),
                                  salt=seed + 0x51)
        self.rng = rng

    def next(self, mask=None):
        if self.dim >= self.max_dims:
            self.rng, u = dda.pcg_uniform(self.rng)
            return u
        u = path_dim_sample(self.kind, self.pixel_index, self.sample_index,
                            self.spp, self.dim, self.seed)
        self.dim += 1
        return u
