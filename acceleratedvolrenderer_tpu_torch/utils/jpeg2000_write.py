"""JPEG 2000 writing without OpenJPEG: the files PIL 12.1.0 writes for an
8-bit RGB image under Image.save's defaults (Jpeg2KImagePlugin._save,
libImaging/Jpeg2KEncode.c, OpenJPEG 2.5.4), byte for byte the same.

Those defaults: the reversible 5/3 wavelet, one quality layer holding
every coding pass (lossless), LRCP progression, 64x64 code-blocks, no
mode switches, no precincts (one per resolution), one tile, no colour
transform (each channel coded alone), two guard bits, and
min(6, floor(log2(min(W, H))) + 1) resolutions (PIL's encoder lowers
OpenJPEG's 6 until the smaller side holds 2 ** (resolutions - 1)
samples).  The codestream: SIZ, COD, QCD, a COM "Created by OpenJPEG
version 2.5.4", one tile-part (SOT, SOD), the packets, EOC.  A `.j2k`
path gets that codestream alone; every other JPEG 2000 extension (.jp2,
and .jpc, .j2c, .jpf, .jpx, which PIL writes as JP2 too) gets it inside
the JP2 boxes: the signature, ftyp ('jp2 '), jp2h (ihdr, colr sRGB) and
jp2c.

The path: DC level shift, the forward 5/3 (T.800 Annex F, OpenJPEG's
dwt.c: columns, then rows, at each level), code-blocks in raster order per
sub-band, tier 1 (native/j2k_t1.cpp, built by g++ on first use; without
it the writer raises, as there is no fallback: utils/j2k_t1.py's
plain-Python encoder holds it in the tests), tier 2 as
OpenJPEG's t2.c writes a first layer: the empty-packet bit, inclusion and
zero bit-plane tag trees, the number of passes, Lblock's increment and
one codeword segment per code-block, in OpenJPEG's bit writer (a 0 bit
stuffed after a 0xFF byte).
"""
from __future__ import annotations

import os
import struct

import numpy as np

COMMENT = b"Created by OpenJPEG version 2.5.4"
GUARD_BITS = 2
CBLK = 64                       # code-block width and height


def resolutions(w: int, h: int) -> int:
    """The number of resolutions PIL's encoder gives a W x H image."""
    return min(6, min(w, h).bit_length())


def _fdwt53(x: np.ndarray, axis: int) -> np.ndarray:
    """One level of the forward 5/3 along `axis` of int64 x, its low-pass
    half first (OpenJPEG's opj_dwt_encode_1 for an even first sample,
    edges mirrored); a single sample stays as it is."""
    x = np.moveaxis(x, axis, -1)
    n = x.shape[-1]
    if n == 1:
        return np.moveaxis(x.copy(), -1, axis)
    s = x[..., 0::2].copy()
    d = x[..., 1::2].copy()
    sn, dn = s.shape[-1], d.shape[-1]
    right = s[..., np.minimum(np.arange(1, dn + 1), sn - 1)]
    d -= (s[..., :dn] + right) >> 1
    left = d[..., np.maximum(np.arange(sn) - 1, 0)]
    here = d[..., np.minimum(np.arange(sn), dn - 1)]
    s += (left + here + 2) >> 2
    return np.moveaxis(np.concatenate([s, d], -1), -1, axis)


def subbands(plane: np.ndarray, levels: int):
    """The sub-bands of one DC-shifted plane (H, W) after `levels` levels:
    a list per resolution, [LL] first, then [HL, LH, HH] of each level
    from the coarsest, each (orientation, int64 coefficients)."""
    a = plane.astype(np.int64)
    h, w = a.shape
    details = []
    for _ in range(levels):
        a[:h, :w] = _fdwt53(_fdwt53(a[:h, :w], 0), 1)
        lh, lw = (h + 1) // 2, (w + 1) // 2
        details.append([(1, a[:lh, lw:w].copy()), (2, a[lh:h, :lw].copy()),
                        (3, a[lh:h, lw:w].copy())])
        h, w = lh, lw
    return [[(0, a[:h, :w].copy())]] + details[::-1]


def _blocks(band: np.ndarray):
    """The code-blocks of a band in raster order, and the grid's size
    (across, down)."""
    bh, bw = band.shape
    ys, xs = range(0, bh, CBLK), range(0, bw, CBLK)
    return ([band[y:y + CBLK, x:x + CBLK] for y in ys for x in xs],
            (len(xs), len(ys)))


class _BitWriter:
    """OpenJPEG's bio.c writer: bits MSB first, a byte after a 0xFF
    carrying 7 bits, the flush writing the last byte and a 0 after a
    0xFF."""

    def __init__(self):
        self.out = bytearray()
        self.buf, self.ct = 0, 8

    def _byteout(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.out.append(self.buf >> 8)

    def bits(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            if self.ct == 0:
                self._byteout()
            self.ct -= 1
            self.buf |= ((v >> i) & 1) << self.ct

    def flush(self) -> bytes:
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


class _TagTree:
    """A tag tree over a w x h grid of leaves (T.800 B.10.2), encoded as
    OpenJPEG's tgt.c encodes it."""

    def __init__(self, w: int, h: int, values):
        levels, base, dims = [], 0, (w, h)         # (first node, size)
        while True:
            levels.append((base, dims))
            base += dims[0] * dims[1]
            if dims == (1, 1):
                break
            dims = ((dims[0] + 1) // 2, (dims[1] + 1) // 2)
        self.parent = [-1] * base
        for (b0, (w0, h0)), (b1, (w1, _)) in zip(levels, levels[1:]):
            for y in range(h0):
                for x in range(w0):
                    self.parent[b0 + y * w0 + x] = b1 + (y // 2) * w1 + x // 2
        self.value = [999] * base
        self.low = [0] * base
        self.known = [False] * base
        for leaf, v in enumerate(values):
            node = leaf
            while node >= 0 and self.value[node] > v:
                self.value[node] = v
                node = self.parent[node]

    def encode(self, bw: _BitWriter, leaf: int, threshold: int):
        stack, node = [], leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bw.bits(1, 1)
                        self.known[node] = True
                    break
                bw.bits(0, 1)
                low += 1
            self.low[node] = low
            if not stack:
                return
            node = stack.pop()


def _num_passes(bw: _BitWriter, n: int):
    if n == 1:
        bw.bits(0, 1)
    elif n == 2:
        bw.bits(2, 2)
    elif n <= 5:
        bw.bits(0xC | (n - 3), 4)
    elif n <= 36:
        bw.bits(0x1E0 | (n - 6), 9)
    else:
        bw.bits(0xFF80 | (n - 37), 16)


def _floorlog2(v: int) -> int:
    return max(v, 1).bit_length() - 1


def _packet(bands) -> bytes:
    """One packet of the first (only) layer: bands a list of (Mb, grid,
    [(coded bit-planes, bytes) per code-block]).  Its first bit says "not
    empty" even where no code-block is included, as OpenJPEG writes it."""
    bw = _BitWriter()
    bw.bits(1, 1)
    body = []
    for mb, (gw, gh), coded in bands:
        incl = _TagTree(gw, gh, [0 if nb else 999 for nb, _ in coded])
        imsb = _TagTree(gw, gh, [mb - nb for nb, _ in coded])
        for k, (nb, data) in enumerate(coded):
            incl.encode(bw, k, 1)
            if not nb:
                continue
            imsb.encode(bw, k, 999)
            npass = 3 * nb - 2
            _num_passes(bw, npass)
            inc = max(0, _floorlog2(len(data)) + 1 - (3 + _floorlog2(npass)))
            bw.bits((1 << (inc + 1)) - 2, inc + 1)          # comma code
            bw.bits(len(data), 3 + inc + _floorlog2(npass))
            body.append(data)
    return bw.flush() + b"".join(body)


def _tier1(blocks):
    """Tier 1 of (coefficients, orientation) pairs by the C++ encoder."""
    from .. import native

    return native.j2k_encode_blocks(blocks)


def _marker(code: int, body: bytes) -> bytes:
    return struct.pack(">HH", code, len(body) + 2) + body


def encode_codestream(px: np.ndarray) -> bytes:
    """The raw codestream PIL writes for uint8 RGB px (H, W, 3)."""
    px = np.asarray(px, np.uint8)
    h, w, nc = px.shape
    nres = resolutions(w, h)
    comps = [subbands(px[..., c].astype(np.int64) - 128, nres - 1)
             for c in range(nc)]
    gain = (0, 1, 1, 2)
    # the packets in LRCP order (one layer), each its bands' (Mb, grid,
    # number of code-blocks); every code-block through tier 1 at once
    layout, jobs = [], []
    for r in range(nres):
        for c in range(nc):
            bands = []
            for orient, band in comps[c][r]:
                blocks, grid = _blocks(band)
                jobs += [(blk, orient) for blk in blocks]
                bands.append((GUARD_BITS + 8 + gain[orient] - 1, grid,
                              len(blocks)))
            layout.append(bands)
    coded = iter(_tier1(jobs))
    data = b"".join(_packet([(mb, grid, [next(coded) for _ in range(n)])
                             for mb, grid, n in bands]) for bands in layout)
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, w, h, 0, 0, nc) + \
        b"\x07\x01\x01" * nc
    cod = struct.pack(">BBHBBBBBB", 0, 0, 1, 0, nres - 1, 4, 4, 0, 1)
    qcd = bytes([GUARD_BITS << 5]) + bytes(
        (8 + (0 if i == 0 else gain[(i - 1) % 3 + 1])) << 3
        for i in range(3 * nres - 2))
    sot = struct.pack(">HIBB", 0, 12 + 2 + len(data), 0, 1)
    return (b"\xff\x4f" + _marker(0xFF51, siz) + _marker(0xFF52, cod)
            + _marker(0xFF5C, qcd) + _marker(0xFF64, b"\x00\x01" + COMMENT)
            + _marker(0xFF90, sot) + b"\xff\x93" + data + b"\xff\xd9")


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body) + 8) + kind + body


def encode_jp2(px: np.ndarray) -> bytes:
    """The JP2 file PIL writes for uint8 RGB px (H, W, 3)."""
    h, w, nc = np.shape(px)
    ihdr = struct.pack(">IIHBBBB", h, w, nc, 7, 7, 0, 0)
    colr = struct.pack(">BBBI", 1, 0, 0, 16)
    return (_box(b"jP  ", b"\r\n\x87\n")
            + _box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")
            + _box(b"jp2h", _box(b"ihdr", ihdr) + _box(b"colr", colr))
            + _box(b"jp2c", encode_codestream(px)))


def encode_jpeg2000(px: np.ndarray, path: str) -> bytes:
    """PIL's JPEG 2000 file for path: a raw codestream for .j2k, else JP2
    (PIL's choice, made by the extension alone)."""
    if os.path.splitext(os.fspath(path))[1].lower() == ".j2k":
        return encode_codestream(px)
    return encode_jp2(px)
