"""Block-compressed (BCn / DXTn) texture decoding in numpy, as PIL 12.1.0's
BcnDecode.c decodes a DDS file's first surface (the reference reads images
through PIL): every block of a file at once, by whole-array operations.

  - BC1 (DXT1): RGBA; c0 <= c1 gives three colours and transparent black;
  - BC2 (DXT3): BC1's four colours and an explicit 4-bit alpha;
  - BC3 (DXT5): BC1's four colours and a BC4 alpha block;
  - BC4: L, one BC4 block (8 or 6 interpolated values);
  - BC5: RGB, a BC4 block each for red and green, blue 0; signed BC5 (BC5S)
    reads each endpoint byte as int8 plus 128, and its blue is 128;
  - BC6H (UF16 and SF16): RGB, the half floats clamped to [0, 1] and
    truncated to 8 bits (PIL's "RGB" of an HDR format); every mode, the
    transformed endpoints, the 32 two-region partitions; a reserved mode
    gives black;
  - BC7: RGBA, every mode with its partitions, p-bits, rotation and index
    selection; a block whose mode byte is 0 gives opaque black.

decode(data, offset, width, height, kind) -> (H, W, C) uint8.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# shared tables (the BPTC specification's, as BcnDecode.c holds them)
# ---------------------------------------------------------------------------

_WEIGHTS = {2: np.array([0, 21, 43, 64]),
            3: np.array([0, 9, 18, 27, 37, 46, 55, 64]),
            4: np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51,
                         55, 60, 64])}

# two-region partitions: bit i is pixel i's region
_P2 = np.array([
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800,
    0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e,
    0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce, 0x088c, 0x3110, 0x6666,
    0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa, 0xf0f0, 0x5a5a, 0x33cc,
    0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996,
    0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c,
    0x39c6, 0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744,
    0xee22], np.int64)
# three-region partitions: bits 2i, 2i+1 are pixel i's region
_P3 = np.array([
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254], np.int64)
# anchor pixels: region 1 of two, regions 1 and 2 of three
_A2 = np.array([
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2,
    8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2, 15, 15, 6, 8, 2, 8, 15, 15,
    2, 8, 2, 2, 2, 15, 15, 6, 6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15,
    2, 2, 15])
_A3A = np.array([
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3,
    6, 10, 5, 8, 8, 6, 8, 5, 15, 15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15,
    5, 15, 15, 15, 15, 3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3])
_A3B = np.array([
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3,
    15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8, 15, 3, 15, 10, 10, 8, 9, 10,
    6, 15, 8, 15, 3, 6, 6, 8, 15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    3, 15, 15, 8])
_PIX = np.arange(16)
# (64, 16): each partition's region of each pixel, and whether the pixel
# is an anchor (its index one bit short), for one, two and three regions
_REGION = {1: np.zeros((64, 16), np.int64),
           2: (_P2[:, None] >> _PIX) & 1,
           3: (_P3[:, None] >> (2 * _PIX)) & 3}
_ANCHOR = {1: np.broadcast_to(_PIX == 0, (64, 16)),
           2: (_PIX == 0) | (_PIX == _A2[:, None]),
           3: (_PIX == 0) | (_PIX == _A3A[:, None]) | (_PIX == _A3B[:, None])}


def _bits(blocks: np.ndarray) -> np.ndarray:
    """(n, 128) bits of 16-byte blocks, least significant first."""
    return np.unpackbits(blocks, axis=1, bitorder="little")


def _field(bits: np.ndarray, pos: int, count: int) -> np.ndarray:
    """The count-bit fields at bit pos of every block, (n,) int64."""
    if not count:
        return np.zeros(len(bits), np.int64)
    return (bits[:, pos:pos + count].astype(np.int64)
            << np.arange(count)).sum(1)


def _indices(bits: np.ndarray, start: int, width: int, regions: int,
             partition: np.ndarray) -> np.ndarray:
    """(n, 16) index of each pixel: width bits each from bit start on, an
    anchor's (the partition's) one bit short."""
    anchor = _ANCHOR[regions][partition]                    # (n, 16)
    widths = width - anchor
    offs = start + np.cumsum(widths, 1) - widths
    out = np.zeros(offs.shape, np.int64)
    for k in range(width):
        b = np.take_along_axis(bits, np.minimum(offs + k, 127), 1)
        out |= np.where(k < widths, b.astype(np.int64) << k, 0)
    return out


def _layout(blocks: np.ndarray, width: int, height: int) -> np.ndarray:
    """(n, 16, C) block pixels -> (height, width, C), blocks row-major."""
    bw, bh = -(-width // 4), -(-height // 4)
    c = blocks.shape[-1]
    img = blocks.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(img.reshape(4 * bh, 4 * bw, c)[:height,
                                                                :width])


# ---------------------------------------------------------------------------
# BC1-BC5
# ---------------------------------------------------------------------------

def _bc1_colors(b: np.ndarray, four: bool) -> np.ndarray:
    """(n, 16, 4) RGBA of the BC1 colour blocks b (n, 8); four: always the
    four-colour mode (BC2 and BC3), else c0 <= c1 selects three colours and
    transparent black."""
    w = b.astype(np.int64)
    c0, c1 = w[:, 0] | (w[:, 1] << 8), w[:, 2] | (w[:, 3] << 8)
    lut = w[:, 4] | (w[:, 5] << 8) | (w[:, 6] << 16) | (w[:, 7] << 24)

    def rgb(x):
        r, g, bl = (x & 0xF800) >> 8, (x & 0x7E0) >> 3, (x & 0x1F) << 3
        return np.stack([r | (r >> 5), g | (g >> 6), bl | (bl >> 5)], -1)

    e0, e1 = rgb(c0), rgb(c1)
    mode4 = np.ones(len(b), bool) if four else c0 > c1
    p2 = np.where(mode4[:, None], (2 * e0 + e1) // 3, (e0 + e1) // 2)
    p3 = np.where(mode4[:, None], (e0 + 2 * e1) // 3, 0)
    pal = np.stack([e0, e1, p2, p3], 1)                     # (n, 4, 3)
    alpha = np.full((len(b), 4), 255)
    alpha[:, 3] = np.where(mode4, 255, 0)
    pal = np.concatenate([pal, alpha[..., None]], -1)
    idx = (lut[:, None] >> (2 * _PIX)) & 3
    return np.take_along_axis(pal, idx[..., None], 1)


def _bc4_values(b: np.ndarray, signed: bool = False) -> np.ndarray:
    """(n, 16) values of the BC4 blocks b (n, 8): a0 > a1 interpolates six
    values between them (sevenths), else four (fifths) and 0 and 255;
    signed endpoints read as int8 plus 128."""
    w = b.astype(np.int64)
    a0, a1 = w[:, 0], w[:, 1]
    if signed:
        a0, a1 = (a0 ^ 0x80), (a1 ^ 0x80)                  # int8 + 128
    k = np.arange(1, 7)
    seven = ((7 - k) * a0[:, None] + k * a1[:, None]) // 7
    five = ((5 - k[:4]) * a0[:, None] + k[:4] * a1[:, None]) // 5
    five = np.concatenate([five, np.zeros((len(b), 1), np.int64),
                           np.full((len(b), 1), 255)], 1)
    pal = np.concatenate([np.stack([a0, a1], 1),
                          np.where((a0 > a1)[:, None], seven, five)], 1)
    lut = sum(w[:, 2 + i] << (8 * i) for i in range(6))
    idx = (lut[:, None] >> (3 * _PIX)) & 7
    return np.take_along_axis(pal, idx, 1)


def _decode_bc1_5(raw: np.ndarray, kind: str) -> np.ndarray:
    if kind == "BC1":
        return _bc1_colors(raw, False)
    if kind == "BC2":
        out = _bc1_colors(raw[:, 8:], True)
        w = raw[:, :8].astype(np.int64)
        a = np.stack([w & 15, w >> 4], -1).reshape(-1, 16)
        out[..., 3] = a * 17
        return out
    if kind == "BC3":
        out = _bc1_colors(raw[:, 8:], True)
        out[..., 3] = _bc4_values(raw[:, :8])
        return out
    if kind == "BC4":
        return _bc4_values(raw)[..., None]
    signed = kind == "BC5S"
    r, g = _bc4_values(raw[:, :8], signed), _bc4_values(raw[:, 8:], signed)
    return np.stack([r, g, np.full_like(r, 128 if signed else 0)], -1)


# ---------------------------------------------------------------------------
# BC6H
# ---------------------------------------------------------------------------

# the 14 modes in BcnDecode.c's order (the specification's modes 1-14):
# (regions, transformed, endpoint bits, delta bits r, g, b, mode bits,
# the endpoint fields after the mode bits, lowest bit first: "rw0:9" is
# bits 0-9 of the first endpoint's red, "rw15:10" bits 15 down to 10)
_BC6_MODES = [
    (2, 1, 10, (5, 5, 5), 2, "gy4 by4 bz4 rw0:9 gw0:9 bw0:9 rx0:4 gz4 gy0:3 "
     "gx0:4 bz0 gz0:3 bx0:4 bz1 by0:3 ry0:4 bz2 rz0:4 bz3"),
    (2, 1, 7, (6, 6, 6), 2, "gy5 gz4 gz5 rw0:6 bz0 bz1 by4 gw0:6 by5 bz2 gy4 "
     "bw0:6 bz3 bz5 bz4 rx0:5 gy0:3 gx0:5 gz0:3 bx0:5 by0:3 ry0:5 rz0:5"),
    (2, 1, 11, (5, 4, 4), 5, "rw0:9 gw0:9 bw0:9 rx0:4 rw10 gy0:3 gx0:3 gw10 "
     "bz0 gz0:3 bx0:3 bw10 bz1 by0:3 ry0:4 bz2 rz0:4 bz3"),
    (2, 1, 11, (4, 5, 4), 5, "rw0:9 gw0:9 bw0:9 rx0:3 rw10 gz4 gy0:3 gx0:4 "
     "gw10 gz0:3 bx0:3 bw10 bz1 by0:3 ry0:3 bz0 bz2 rz0:3 gy4 bz3"),
    (2, 1, 11, (4, 4, 5), 5, "rw0:9 gw0:9 bw0:9 rx0:3 rw10 by4 gy0:3 gx0:3 "
     "gw10 bz0 gz0:3 bx0:4 bw10 by0:3 ry0:3 bz1 bz2 rz0:3 bz4 bz3"),
    (2, 1, 9, (5, 5, 5), 5, "rw0:8 by4 gw0:8 gy4 bw0:8 bz4 rx0:4 gz4 gy0:3 "
     "gx0:4 bz0 gz0:3 bx0:4 bz1 by0:3 ry0:4 bz2 rz0:4 bz3"),
    (2, 1, 8, (6, 5, 5), 5, "rw0:7 gz4 by4 gw0:7 bz2 gy4 bw0:7 bz3 bz4 rx0:5 "
     "gy0:3 gx0:4 bz0 gz0:3 bx0:4 bz1 by0:3 ry0:5 rz0:5"),
    (2, 1, 8, (5, 6, 5), 5, "rw0:7 bz0 by4 gw0:7 gy5 gy4 bw0:7 gz5 bz4 rx0:4 "
     "gz4 gy0:3 gx0:5 gz0:3 bx0:4 bz1 by0:3 ry0:4 bz2 rz0:4 bz3"),
    (2, 1, 8, (5, 5, 6), 5, "rw0:7 bz1 by4 gw0:7 by5 gy4 bw0:7 bz5 bz4 rx0:4 "
     "gz4 gy0:3 gx0:4 bz0 gz0:3 bx0:5 by0:3 ry0:4 bz2 rz0:4 bz3"),
    (2, 0, 6, (6, 6, 6), 5, "rw0:5 gz4 bz0 bz1 by4 gw0:5 gy5 by5 bz2 gy4 "
     "bw0:5 gz5 bz3 bz5 bz4 rx0:5 gy0:3 gx0:5 gz0:3 bx0:5 by0:3 ry0:5 rz0:5"),
    (1, 0, 10, (10, 10, 10), 5, "rw0:9 gw0:9 bw0:9 rx0:9 gx0:9 bx0:9"),
    (1, 1, 11, (9, 9, 9), 5, "rw0:9 gw0:9 bw0:9 rx0:8 rw10 gx0:8 gw10 bx0:8 "
     "bw10"),
    (1, 1, 12, (8, 8, 8), 5, "rw0:9 gw0:9 bw0:9 rx0:7 rw11:10 gx0:7 gw11:10 "
     "bx0:7 bw11:10"),
    (1, 1, 16, (4, 4, 4), 5, "rw0:9 gw0:9 bw0:9 rx0:3 rw15:10 gx0:3 gw15:10 "
     "bx0:3 bw15:10"),
]
_BC6_NAMES = ["rw", "gw", "bw", "rx", "gx", "bx", "ry", "gy", "by", "rz",
              "gz", "bz"]


def _bc6_fields(text: str):
    """[(endpoint component, bit)] of a mode's fields, in stream order."""
    out = []
    for tok in text.split():
        comp = _BC6_NAMES.index(tok[:2])
        lo, _, hi = tok[2:].partition(":")
        a, b = int(lo), int(hi or lo)
        step = 1 if b >= a else -1
        out += [(comp, k) for k in range(a, b + step, step)]
    return out


_BC6_FIELDS = [_bc6_fields(m[5]) for m in _BC6_MODES]


def _sign_extend(x: np.ndarray, bits: int) -> np.ndarray:
    x = x & ((1 << bits) - 1)
    return np.where(x >= 1 << (bits - 1), x - (1 << bits), x)


def _bc6_unquantize(x: np.ndarray, bits: int, signed: bool) -> np.ndarray:
    if not signed:
        if bits >= 15:
            return x
        return np.where(x == 0, 0, np.where(
            x == (1 << bits) - 1, 0xFFFF, ((x << 15) + 0x4000) >> (bits - 1)))
    if bits >= 16:
        return x
    mag = np.abs(x)
    q = np.where(mag == 0, 0, np.where(
        mag >= (1 << (bits - 1)) - 1, 0x7FFF,
        ((mag << 15) + 0x4000) >> (bits - 1)))
    return np.where(x < 0, -q, q)


def _half_to_u8(h: np.ndarray) -> np.ndarray:
    """8-bit samples of half-float bits h: the value clamped to [0, 1],
    times 255, truncated, in integers (a half times 255 is exact in
    float32, as PIL computes it)."""
    e, m = (h >> 10) & 31, h & 1023
    v = np.where(e == 0, (m * 255) >> 24,
                 ((1024 + m) * 255) >> np.maximum(25 - e, 0))
    return np.where(h & 0x8000, 0, np.where(e >= 15, 255, v)).astype(
        np.uint8)


_HALF_U8 = _half_to_u8(np.arange(1 << 16))


def _ends(ep: np.ndarray, region: np.ndarray, regions: int):
    """Each pixel's two endpoints, (n, 16 or 1, C) each, of the blocks'
    endpoints ep (n, 2 * regions, C) by the pixels' regions (n, 16)."""
    if regions == 1:
        return ep[:, :1], ep[:, 1:2]
    return (np.take_along_axis(ep, (2 * region)[..., None], 1),
            np.take_along_axis(ep, (2 * region + 1)[..., None], 1))


def _decode_bc6(raw: np.ndarray, signed: bool) -> np.ndarray:
    n = len(raw)
    bits = _bits(raw)
    m5 = raw[:, 0].astype(np.int64) & 0x1F
    mode = np.where((m5 & 3) < 2, m5 & 3,
                    np.where((m5 & 3) == 2, 2 + (m5 >> 2), 10 + (m5 >> 2)))
    out = np.zeros((n, 16, 3), np.uint8)
    for m, (regions, tr, epb, deltas, mbits, _) in enumerate(_BC6_MODES):
        sel = np.flatnonzero(mode == m)
        if not len(sel):
            continue
        b = bits[sel]
        ep = np.zeros((len(sel), 12), np.int64)
        for i, (comp, k) in enumerate(_BC6_FIELDS[m]):
            ep[:, comp] |= b[:, mbits + i].astype(np.int64) << k
        numep = 6 * regions
        ep = ep[:, :numep]
        if signed or tr:
            for c in range(3, numep):
                ep[:, c] = _sign_extend(ep[:, c], deltas[c % 3])
        if signed:
            ep[:, :3] = _sign_extend(ep[:, :3], epb)
        if tr:
            w0 = np.tile(ep[:, :3], (1, regions * 2 - 1))
            ep[:, 3:] = (ep[:, 3:] + w0) & ((1 << epb) - 1)
        if signed:                      # the sums kept as 16-bit words
            ep = _sign_extend(ep, 16)
        ueps = _bc6_unquantize(ep, epb, signed).reshape(-1, regions * 2, 3)
        if regions == 2:
            part = _field(b, 77, 5)
            idx = _indices(b, 82, 3, 2, part)
            weights = _WEIGHTS[3][idx]
        else:
            part = np.zeros(len(sel), np.int64)
            idx = _indices(b, 65, 4, 1, part)
            weights = _WEIGHTS[4][idx]
        e0, e1 = _ends(ueps, _REGION[regions][part], regions)
        wt = weights[..., None]
        v = (e0 * (64 - wt) + e1 * wt) >> 6
        if signed:
            mag = (np.abs(v) * 31) >> 5
            half = np.where(v < 0, 0x8000 | mag, mag)
        else:
            half = (v * 31) >> 6
        out[sel] = _HALF_U8[half]
    return out


# ---------------------------------------------------------------------------
# BC7
# ---------------------------------------------------------------------------

# per mode: (regions, partition bits, rotation bits, index-selection bit,
# colour bits, alpha bits, p-bit per endpoint, p-bit per region, index
# bits, second index bits)
_BC7_MODES = [(3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
              (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
              (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
              (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0)]


def _decode_bc7(raw: np.ndarray) -> np.ndarray:
    n = len(raw)
    bits = _bits(raw)
    first = raw[:, 0].astype(np.int64)
    mode = np.where(first == 0, 8, np.log2(np.maximum(
        first & -first, 1)).astype(np.int64))
    out = np.zeros((n, 16, 4), np.int64)
    out[mode == 8, :, 3] = 255                              # no mode bit
    for m, (ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2) in enumerate(
            _BC7_MODES):
        sel = np.flatnonzero(mode == m)
        if not len(sel):
            continue
        b = bits[sel]
        pos = m + 1
        part = _field(b, pos, pb)
        rot = _field(b, pos + pb, rb)
        isel = _field(b, pos + pb + rb, isb)
        pos += pb + rb + isb
        numep = 2 * ns
        ep = np.zeros((len(sel), numep, 4), np.int64)
        for c in range(3):
            for i in range(numep):
                ep[:, i, c] = _field(b, pos, cb)
                pos += cb
        for i in range(numep):
            if ab:
                ep[:, i, 3] = _field(b, pos, ab)
                pos += ab
            else:
                ep[:, i, 3] = 255
        chans = 4 if ab else 3
        if epb or spb:
            count = numep if epb else ns
            p = b[:, pos:pos + count].astype(np.int64)
            pos += count
            if spb:
                p = np.repeat(p, 2, 1)
            ep[:, :, :chans] = (ep[:, :, :chans] << 1) | p[..., None]
            cb, ab = cb + 1, ab + 1 if ab else 0
        for c in range(chans):          # to 8 bits, the top bits repeated
            nb, v = (ab if c == 3 else cb), ep[..., c]
            ep[..., c] = ((v << (8 - nb)) | (v >> (2 * nb - 8))) & 0xFF
        i0 = _indices(b, pos, ib, ns, part)
        e0, e1 = _ends(ep, _REGION[ns][part], ns)
        cw = _WEIGHTS[ib][i0]
        if ab and ib2:
            i1 = _indices(b, pos + 16 * ib - ns, ib2, 1,
                          np.zeros(len(sel), np.int64))
            aw = _WEIGHTS[ib2][i1]
            s = isel[:, None].astype(bool)
            wc, wa = np.where(s, aw, cw), np.where(s, cw, aw)
        else:
            wc = wa = cw
        wts = np.stack([wc, wc, wc, wa], -1)
        px = ((64 - wts) * e0 + wts * e1 + 32) >> 6
        for r in (1, 2, 3):                                 # rotation
            hit = rot == r
            px[hit, :, r - 1], px[hit, :, 3] = (px[hit, :, 3].copy(),
                                                px[hit, :, r - 1].copy())
        out[sel] = px
    return out.astype(np.uint8)


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

# bytes per block and channels of each kind
KINDS = {"BC1": (8, 4), "BC2": (16, 4), "BC3": (16, 4), "BC4": (8, 1),
         "BC5": (16, 3), "BC5S": (16, 3), "BC6H": (16, 3), "BC6HS": (16, 3),
         "BC7": (16, 4)}


def decode(data: bytes, offset: int, width: int, height: int,
           kind: str) -> np.ndarray:
    """The (height, width, C) uint8 samples of the blocks of `kind` (a key
    of KINDS) at data[offset:], four rows of blocks of four pixels each,
    left to right, top to bottom (see the module docstring)."""
    size, _ = KINDS[kind]
    n = -(-width // 4) * -(-height // 4)
    if len(data) < offset + n * size:
        raise ValueError(f"DDS ({kind}): truncated data")
    raw = np.frombuffer(data, np.uint8, n * size, offset).reshape(n, size)
    if kind in ("BC6H", "BC6HS"):
        blocks = _decode_bc6(raw, kind == "BC6HS")
    elif kind == "BC7":
        blocks = _decode_bc7(raw)
    else:
        blocks = _decode_bc1_5(raw, kind).astype(np.uint8)
    return _layout(blocks, width, height)
