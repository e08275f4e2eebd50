"""Progressive multi-jittered (0,2) sample tables with blue noise
(port of acceleratedvolrenderer_tpu/models/pmj02.py, numpy as there).

The PMJ02BN sampler (samplers.h:367) draws from pmj02bn point sets
(Christensen, Kensler & Kilpatrick 2018) plus blue-noise textures for
per-pixel shifts.  Both are generated at first use rather than vendored:

  * `generate_pmj02bn(n, seed)` adds samples one at a time under the
    progressive (0,2) elementary-interval constraint (valid cells tracked
    exactly on the fine grid), taking among candidate cells the point with
    the largest minimum toroidal distance to the set (best candidate);
    a dead-ended pass restarts;
  * `blue_noise_texture(res, seed)` ranks a texture by void-and-cluster
    (Ulichney 1993) with FFT-based toroidal Gaussian filtering.

The tables are cached in build/pmj02/ under the repository root
(gitignored); the same seeds give the same tables bit for bit.
"""
from __future__ import annotations

import os

import numpy as np

N_SETS = 5          # nPMJ02bnSets in the reference
TABLE_SIZE = 1024   # samples per set (spp above this falls back, like
#                     the reference's wrap past its table width)
_CACHE = {}


def _cache_dir():
    d = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "build", "pmj02")
    os.makedirs(d, exist_ok=True)
    return d


def generate_pmj02bn(n: int, seed: int, n_candidates: int = 10,
                     rng=None) -> np.ndarray:
    """One pmj02bn table of n samples (n a power of two), shape (n, 2)."""
    assert n & (n - 1) == 0, "table size must be a power of two"
    rng = rng or np.random.default_rng(seed)
    samples = np.empty((n, 2), np.float64)
    samples[0] = rng.random(2)
    count = 1

    while count < n:
        target = 2 * count
        L = int(np.log2(target))
        shifts = [(i, L - i) for i in range(L + 1)]
        occs = [np.zeros((1 << i, 1 << j), bool) for i, j in shifts]

        def mark(pt):
            for (i, j), occ in zip(shifts, occs):
                occ[min(int(pt[0] * (1 << i)), (1 << i) - 1),
                    min(int(pt[1] * (1 << j)), (1 << j) - 1)] = True

        for k in range(count):
            mark(samples[k])

        # exact free-cell tracking on the fine (2^L, 2^L) grid: the AND of
        # all stratification occupancies, built once per pass and updated
        # incrementally (each insert invalidates one block per level)
        gx = 1 << L
        valid = np.ones((gx, gx), bool)
        for (i, j), occ in zip(shifts, occs):
            valid &= ~occ[np.arange(gx)[:, None] >> (L - i),
                          np.arange(gx)[None, :] >> (L - j)]

        def insert(pt, slot):
            samples[slot] = pt
            mark(pt)
            fx = min(int(pt[0] * gx), gx - 1)
            fy = min(int(pt[1] * gx), gx - 1)
            for (i, j) in shifts:
                x0 = (fx >> (L - i)) << (L - i)
                y0 = (fy >> (L - j)) << (L - j)
                valid[x0:x0 + (1 << (L - i)), y0:y0 + (1 << (L - j))] = False

        added = 0
        stuck = False
        while count + added < target:
            vx, vy = np.nonzero(valid)
            if len(vx) == 0:
                stuck = True
                break
            picks = rng.integers(len(vx), size=min(n_candidates, len(vx)))
            pool = np.stack([(vx[picks] + rng.random(len(picks))) / gx,
                             (vy[picks] + rng.random(len(picks))) / gx], -1)
            # blue noise: best candidate by min toroidal distance
            cur = samples[:count + added]
            d = np.abs(pool[:, None, :] - cur[None, :, :])
            d = np.minimum(d, 1.0 - d)
            dmin = (d * d).sum(-1).min(axis=1)
            insert(pool[int(np.argmax(dmin))], count + added)
            added += 1
        if stuck:
            continue   # restart this pass with fresh randomness
        count = target
    return samples.astype(np.float32)


def blue_noise_texture(res: int = 64, seed: int = 0,
                       sigma: float = 1.9) -> np.ndarray:
    """(res, res) float32 in [0,1): void-and-cluster dither ranking."""
    rng = np.random.default_rng(seed)
    n = res * res

    # toroidal Gaussian kernel in Fourier space
    yy = np.minimum(np.abs(np.arange(res)), res - np.abs(np.arange(res)))
    ky = np.exp(-yy ** 2 / (2 * sigma * sigma))
    kern = ky[:, None] * ky[None, :]
    K = np.fft.fft2(kern / kern.sum())

    def energy(mask):
        return np.real(np.fft.ifft2(np.fft.fft2(mask.astype(float)) * K))

    # initial pattern: ~10% ones, relaxed by swapping tightest cluster
    # with largest void until stable
    mask = np.zeros((res, res), bool)
    ones = rng.choice(n, n // 10, replace=False)
    mask.reshape(-1)[ones] = True
    for _ in range(n):
        e = energy(mask)
        cluster = np.unravel_index(np.argmax(np.where(mask, e, -np.inf)),
                                   mask.shape)
        mask[cluster] = False
        e = energy(mask)
        void = np.unravel_index(np.argmin(np.where(mask, np.inf, e)),
                                mask.shape)
        if void == cluster:
            mask[cluster] = True
            break
        mask[void] = True

    rank = np.zeros((res, res), np.int64)
    # phase 1: rank the initial ones by removing tightest clusters
    work = mask.copy()
    k = work.sum()
    for r in range(int(k) - 1, -1, -1):
        e = energy(work)
        c = np.unravel_index(np.argmax(np.where(work, e, -np.inf)),
                             work.shape)
        work[c] = False
        rank[c] = r
    # phase 2: fill the remaining pixels by largest void
    work = mask.copy()
    for r in range(int(k), n):
        e = energy(work)
        v = np.unravel_index(np.argmin(np.where(work, np.inf, e)),
                             work.shape)
        work[v] = True
        rank[v] = r
    return (rank.astype(np.float32) + 0.5) / n


def get_tables(seed: int = 0):
    """(tables (N_SETS, TABLE_SIZE, 2), bn_texture (64, 64, 2)): generated
    once and cached on disk (build/pmj02/pmj02bn_*.npz, gitignored)."""
    key = ("tables", seed)
    if key in _CACHE:
        return _CACHE[key]
    path = os.path.join(_cache_dir(),
                        f"pmj02bn_s{seed}_n{TABLE_SIZE}_k{N_SETS}.npz")
    if os.path.exists(path):
        z = np.load(path)
        if z["bn"].ndim == 3:
            out = (z["tables"], z["bn"])
            _CACHE[key] = out
            return out
        os.remove(path)   # stale single-channel cache
    tables = np.stack([
            generate_pmj02bn(TABLE_SIZE, seed * 101 + s)
            for s in range(N_SETS)])
    # two independent ranking channels (the reference uses separate
    # blue-noise textures per shift channel)
    bn = np.stack([blue_noise_texture(64, seed),
                   blue_noise_texture(64, seed + 7919)], -1)
    # written under a temporary name and renamed: processes that generate
    # the tables at once never read a partial file
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, tables=tables, bn=bn)
    os.replace(tmp, path)
    out = (tables, bn)
    _CACHE[key] = out
    return out


def validate_pmj02(samples: np.ndarray) -> bool:
    """Check the progressive (0,2) property: every power-of-two prefix is
    stratified on every elementary-interval factorization."""
    n = len(samples)
    m = 1
    while m <= n:
        L = int(np.log2(m))
        for i in range(L + 1):
            j = L - i
            cx = np.minimum((samples[:m, 0] * (1 << i)).astype(int),
                            (1 << i) - 1)
            cy = np.minimum((samples[:m, 1] * (1 << j)).astype(int),
                            (1 << j) - 1)
            cells = cx * (1 << j) + cy
            if len(np.unique(cells)) != m:
                return False
        m *= 2
    return True
