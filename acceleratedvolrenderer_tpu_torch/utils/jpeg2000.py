"""JPEG 2000 Part 1 reading without OpenJPEG: the JP2 boxes (T.800 Annex I)
and the codestream (Annexes A-H), decoded as the reference's read_image
decodes them, through PIL (Jpeg2KImagePlugin.py, libImaging/Jpeg2KDecode.c)
and OpenJPEG 2.5, so the samples equal PIL's.

decode_jp2(data) reads a JP2 / JPX file, decode_j2k(data) a raw
codestream.  Both return (H, W, C): uint8 for L, LA, RGB and RGBA, uint16
for a one-component file of more than 8 bits (PIL's I;16, scaled to 16
bits as PIL's unpacker scales it), palette colours where PIL gives
indices, and a CMYK file converted as PIL's convert("RGB") converts it.

The path: markers (SIZ, COD/COC, QCD/QCC, SOT/SOD, several tiles and
tile-parts; COM, TLM, PLM, PLT and CRG skipped), geometry (tile-components,
resolutions, sub-bands, precincts, code-blocks by T.800's ceil-divided
coordinates), tier 2 (packet headers under the five progressions, tag
trees, several quality layers), tier 1 (utils/j2k_t1.py, or its C++ twin
native/j2k_t1.cpp where it builds), dequantization (reconstruction at the
middle of the last decoded bit-plane, as OpenJPEG does), the inverse 5/3
(integer) and 9/7 (float32, OpenJPEG's constants and order) wavelets, the
inverse RCT / ICT, DC level shift and clamp, then PIL's unpacking.

What PIL's writer cannot make raises ValueError naming it: code-block
mode switches, HTJ2K (CAP), ROI (RGN), POC, packed headers (PPM, PPT),
SOP / EPH markers, sub-sampled components, colour samples over 8 bits,
samples over 16 bits, ICC colour, a JP2 header that disagrees with the
codestream, a palette with alpha (PA).  What PIL refuses is refused too.
"""
from __future__ import annotations

import base64
import struct

import numpy as np

JP2_MAGIC = b"\0\0\0\x0cjP  \r\n\x87\n"
J2K_MAGIC = b"\xff\x4f\xff\x51"

_REFUSED_MARKERS = {0xFF50: "HTJ2K (CAP marker)", 0xFF59: "HTJ2K (CPF marker)",
                    0xFF5E: "ROI (RGN marker)", 0xFF5F: "POC marker",
                    0xFF60: "packed headers (PPM marker)",
                    0xFF61: "packed headers (PPT marker)"}
# TLM, PLM, PLT, CRG, COM
_SKIPPED_MARKERS = (0xFF55, 0xFF57, 0xFF58, 0xFF63, 0xFF64)
_MODE_SWITCHES = ("BYPASS", "RESET", "TERMALL", "VSC", "PTERM", "SEGSYM")

# OpenJPEG's 9/7 constants (dwt.c): lifting steps, K, and the "two_invK"
# its decoder scales the high-pass samples by
_ALPHA = np.float32(-1.586134342)
_BETA = np.float32(-0.052980118)
_GAMMA = np.float32(0.882911075)
_DELTA = np.float32(0.443506852)
_K = np.float32(1.230174105)
_TWO_INV_K = np.float32(1.625732422)


def _u16(d, p):
    return struct.unpack_from(">H", d, p)[0]


def _u32(d, p):
    return struct.unpack_from(">I", d, p)[0]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# main and tile-part headers
# ---------------------------------------------------------------------------

class _Coding:
    """COD / COC parameters of one tile-component."""

    def __init__(self, d: bytes, p: int, scod: int):
        self.levels = d[p]
        self.xcb = (d[p + 1] & 15) + 2
        self.ycb = (d[p + 2] & 15) + 2
        style = d[p + 3]
        if style & 0x40:
            raise ValueError("JPEG 2000: HTJ2K code-blocks are not read")
        if style & 0x3F:
            names = [n for i, n in enumerate(_MODE_SWITCHES)
                     if style & (1 << i)]
            raise ValueError("JPEG 2000: code-block mode switches ("
                             + ", ".join(names) + ") are not read")
        self.reversible = d[p + 4] == 1
        if d[p + 4] > 1:
            raise ValueError("JPEG 2000: custom wavelets are not read")
        n = self.levels + 1
        if scod & 1:
            self.precincts = [(d[p + 5 + r] & 15, d[p + 5 + r] >> 4)
                              for r in range(n)]
        else:
            self.precincts = [(15, 15)] * n


class _Quant:
    """QCD / QCC parameters: guard bits and (exponent, mantissa) per
    sub-band, in the order LL, then HL, LH, HH per resolution."""

    def __init__(self, d: bytes, p: int, end: int):
        s = d[p]
        self.guard = s >> 5
        self.style = s & 31
        if self.style == 0:
            self.steps = [(d[q] >> 3, 0) for q in range(p + 1, end)]
        elif self.style in (1, 2):
            self.steps = [(v >> 11, v & 0x7FF) for v in
                          struct.unpack_from(f">{(end - p - 1) // 2}H", d,
                                             p + 1)]
        else:
            raise ValueError(f"JPEG 2000: quantization style {self.style} "
                             "is not read")

    def step(self, band: int) -> tuple[int, int]:
        if self.style == 1:                 # scalar derived (OpenJPEG)
            e, m = self.steps[0]
            return max(e - (band - 1) // 3, 0) if band else e, m
        if band >= len(self.steps):
            raise ValueError("JPEG 2000: quantization for too few sub-bands")
        return self.steps[band]


class _Params:
    """The coding style of a tile (or, main None, the main header's)."""

    def __init__(self, ncomp: int, main: "_Params | None" = None):
        self.main = main
        self.cod = main.cod if main else None
        self.progression = main.progression if main else 0
        self.layers = main.layers if main else 1
        self.mct = main.mct if main else 0
        self.qcd = main.qcd if main else None
        self.coc = [None] * ncomp
        self.qcc = [None] * ncomp

    def coding(self, c: int) -> _Coding:
        """Tile COC, tile COD, main COC, main COD: the first given."""
        if self.coc[c] is not None:
            return self.coc[c]
        if self.main and self.cod is self.main.cod and self.main.coc[c]:
            return self.main.coc[c]
        return self.cod

    def quant(self, c: int) -> _Quant:
        """Tile QCC, tile QCD, main QCC, main QCD: the first given."""
        if self.qcc[c] is not None:
            return self.qcc[c]
        if self.main and self.qcd is self.main.qcd and self.main.qcc[c]:
            return self.main.qcc[c]
        return self.qcd


def _read_segment(d: bytes, p: int, marker: int, params: _Params,
                  ncomp: int):
    """Apply one COD / COC / QCD / QCC segment (body at p, end at the
    segment's end) to params."""
    end = p + _u16(d, p)
    p += 2
    cbytes = 1 if ncomp < 257 else 2
    if marker == 0xFF52:                                  # COD
        scod = d[p]
        if scod & 6:
            raise ValueError("JPEG 2000: SOP / EPH markers are not read")
        params.progression = d[p + 1]
        if params.progression > 4:
            raise ValueError("JPEG 2000: unknown progression order")
        params.layers = _u16(d, p + 2)
        params.mct = d[p + 4]
        params.cod = _Coding(d, p + 5, scod)
    elif marker == 0xFF53:                                # COC
        c = d[p] if cbytes == 1 else _u16(d, p)
        params.coc[c] = _Coding(d, p + cbytes + 1, d[p + cbytes])
    elif marker == 0xFF5C:                                # QCD
        params.qcd = _Quant(d, p, end)
    else:                                                 # QCC
        c = d[p] if cbytes == 1 else _u16(d, p)
        params.qcc[c] = _Quant(d, p + cbytes, end)


def _header(d: bytes, p: int, stop: int, params: _Params, ncomp: int,
            styles: bool = True) -> int:
    """Read the marker segments from p up to the marker `stop`, applying
    the coding-style ones to params (refused where styles is False);
    returns stop's position."""
    while (m := _u16(d, p)) != stop:
        if m in _REFUSED_MARKERS:
            raise ValueError(f"JPEG 2000: {_REFUSED_MARKERS[m]} is not read")
        if m in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D):
            if not styles:
                raise ValueError("JPEG 2000: coding style in a later "
                                 "tile-part is not read")
            _read_segment(d, p + 2, m, params, ncomp)
        elif m not in _SKIPPED_MARKERS:
            raise ValueError(f"JPEG 2000: unknown marker {m:#06x}")
        p += 2 + _u16(d, p + 2)
    return p


class _Siz:
    def __init__(self, d: bytes, p: int):
        (_, rsiz, self.x1, self.y1, self.x0, self.y0, self.tw, self.th,
         self.tx0, self.ty0, n) = struct.unpack_from(">HHIIIIIIIIH", d, p)
        if rsiz & 0x4000:
            raise ValueError("JPEG 2000: HTJ2K (Part 15) is not read")
        self.prec, self.signed = [], []
        for c in range(n):
            s, dx, dy = d[p + 38 + 3 * c:p + 41 + 3 * c]
            if dx != 1 or dy != 1:
                raise ValueError("JPEG 2000: sub-sampled components are not "
                                 "read")
            self.prec.append((s & 0x7F) + 1)
            self.signed.append(bool(s & 0x80))
        if max(self.prec) > 16:
            raise ValueError("JPEG 2000: samples over 16 bits are not read")
        self.ntx = _ceil_div(self.x1 - self.tx0, self.tw)
        self.nty = _ceil_div(self.y1 - self.ty0, self.th)


def _parse(d: bytes):
    """Main header and tile-parts -> (siz, {tile: (params, data)})."""
    if d[:4] != J2K_MAGIC:
        raise ValueError("not a JPEG 2000 codestream")
    siz = _Siz(d, 4)
    ncomp = len(siz.prec)
    main = _Params(ncomp)
    p = _header(d, 4 + _u16(d, 4), 0xFF90, main, ncomp)
    if main.cod is None or main.qcd is None:
        raise ValueError("JPEG 2000: no COD or QCD in the main header")
    tiles = {}
    while p + 2 <= len(d) and _u16(d, p) == 0xFF90:
        t, psot = _u16(d, p + 4), _u32(d, p + 6)
        end = len(d) if psot == 0 else p + psot
        if end > len(d):
            raise ValueError("JPEG 2000: truncated tile-part")
        params, chunks = tiles.setdefault(t, (_Params(ncomp, main), []))
        q = _header(d, p + 12, 0xFF93, params, ncomp, styles=not chunks)
        chunks.append(d[q + 2:end])
        p = end
    return siz, {t: (pr, b"".join(ch)) for t, (pr, ch) in tiles.items()}


# ---------------------------------------------------------------------------
# tier 2: geometry, tag trees, packets
# ---------------------------------------------------------------------------

class _Bits:
    """The packet-header bit reader (OpenJPEG bio.c): MSB first, seven
    bits in the byte after an 0xFF."""

    def __init__(self, d: bytes, p: int):
        self.d, self.p, self.buf, self.ct = d, p, 0, 0

    def bit(self) -> int:
        if self.ct == 0:
            self._bytein()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def _bytein(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.p < len(self.d):
            self.buf |= self.d[self.p]
            self.p += 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> int:
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0
        return self.p


class _TagTree:
    """A tag tree over w x h leaves (T.800 B.10.2), as OpenJPEG's tgt.c
    keeps it: each node's parent (-1 at the root), value and low bound,
    the leaves first, row by row, then each coarser level."""

    def __init__(self, w: int, h: int):
        self.parents = []
        base = 0
        while True:
            pw, ph = _ceil_div(w, 2), _ceil_div(h, 2)
            top = (w, h) == (1, 1) or w * h == 0
            self.parents += [-1 if top else base + w * h + (j // 2) * pw
                             + i // 2 for j in range(h) for i in range(w)]
            base += w * h
            if top:
                break
            w, h = pw, ph
        self.value = [999] * base
        self.low = [0] * base

    def decode(self, bits: _Bits, leaf: int, threshold: int) -> bool:
        """opj_tgt_decode: whether the leaf's value is below threshold."""
        stack, node = [], leaf
        while self.parents[node] >= 0:
            stack.append(node)
            node = self.parents[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bits.bit():
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()
        return self.value[node] < threshold


class _Block:
    __slots__ = ("x0", "y0", "x1", "y1", "chunks", "passes", "lblock",
                 "nbps", "included")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.chunks, self.passes, self.lblock = [], 0, 3
        self.nbps, self.included = 0, False


class _Band:
    """One sub-band of a resolution: its coordinates (T.800 B-15), where it
    lies in OpenJPEG's layout of the tile (ox, oy: after the lower
    resolution's width / height where high-pass), its step (exponent,
    mantissa), bit-planes (Mb) and per precinct its code-blocks (cw x ch)
    and two tag trees."""

    def __init__(self, tc, orient, lv, quant, qb):
        half = (1 << lv) >> 1
        xo, yo = orient & 1, orient >> 1
        self.x0, self.y0, self.x1, self.y1 = (
            _ceil_div(v - o * half, 1 << lv)
            for v, o in zip(tc, (xo, yo, xo, yo)))
        self.ox = _ceil_div(tc[2], 1 << lv) - _ceil_div(tc[0], 1 << lv) \
            if xo else 0
        self.oy = _ceil_div(tc[3], 1 << lv) - _ceil_div(tc[1], 1 << lv) \
            if yo else 0
        self.orient = orient
        self.step = quant.step(qb)
        self.mb = self.step[0] + quant.guard - 1
        self.empty = self.x0 >= self.x1 or self.y0 >= self.y1
        self.precincts = []


class _Resolution:
    """Resolution r of a tile-component tc (x0, y0, x1, y1): its
    coordinates, precinct grid (pw x ph of 2^ppx x 2^ppy) and bands."""

    def __init__(self, tc, r, coding, quant):
        nl = coding.levels
        s = 1 << (nl - r)
        self.x0, self.y0 = _ceil_div(tc[0], s), _ceil_div(tc[1], s)
        self.x1, self.y1 = _ceil_div(tc[2], s), _ceil_div(tc[3], s)
        ppx, ppy = coding.precincts[r]
        self.ppx, self.ppy = ppx, ppy
        px0 = (self.x0 >> ppx) << ppx
        py0 = (self.y0 >> ppy) << ppy
        px1 = _ceil_div(self.x1, 1 << ppx) << ppx
        py1 = _ceil_div(self.y1, 1 << ppy) << ppy
        self.pw = 0 if self.x0 == self.x1 else (px1 - px0) >> ppx
        self.ph = 0 if self.y0 == self.y1 else (py1 - py0) >> ppy
        if r == 0:
            cbx0, cby0, cgw, cgh = px0, py0, ppx, ppy
        else:
            cbx0, cby0 = _ceil_div(px0, 2), _ceil_div(py0, 2)
            cgw, cgh = ppx - 1, ppy - 1
        xcb, ycb = min(coding.xcb, cgw), min(coding.ycb, cgh)
        self.bands = []
        for orient in (0,) if r == 0 else (1, 2, 3):
            band = (_Band(tc, 0, nl, quant, 0) if r == 0 else
                    _Band(tc, orient, nl - r + 1, quant, 3 * r - 3 + orient))
            bx0, by0, bx1, by1 = band.x0, band.y0, band.x1, band.y1
            self.bands.append(band)
            if band.empty:
                continue
            for pn in range(self.pw * self.ph):
                gx0 = cbx0 + (pn % self.pw) * (1 << cgw)
                gy0 = cby0 + (pn // self.pw) * (1 << cgh)
                x0, y0 = max(gx0, bx0), max(gy0, by0)
                x1 = min(gx0 + (1 << cgw), bx1)
                y1 = min(gy0 + (1 << cgh), by1)
                tx0 = (x0 >> xcb) << xcb
                ty0 = (y0 >> ycb) << ycb
                cw = max((_ceil_div(x1, 1 << xcb) << xcb) - tx0, 0) >> xcb
                ch = max((_ceil_div(y1, 1 << ycb) << ycb) - ty0, 0) >> ycb
                blocks = []
                for j in range(ch):
                    for i in range(cw):
                        bx = tx0 + (i << xcb)
                        by = ty0 + (j << ycb)
                        blocks.append(_Block(max(bx, x0), max(by, y0),
                                             min(bx + (1 << xcb), x1),
                                             min(by + (1 << ycb), y1)))
                band.precincts.append((blocks, _TagTree(cw, ch),
                                       _TagTree(cw, ch)))


def _num_passes(bits: _Bits) -> int:
    if not bits.bit():
        return 1
    if not bits.bit():
        return 2
    n = bits.bits(2)
    if n != 3:
        return 3 + n
    n = bits.bits(5)
    if n != 31:
        return 6 + n
    return 37 + bits.bits(7)


def _read_packet(d: bytes, p: int, res: _Resolution, prec: int,
                 layer: int) -> int:
    """One packet (opj_t2_read_packet_header / _data) at p; returns the
    position after it."""
    bits = _Bits(d, p)
    if p >= len(d) or not bits.bit():
        return bits.align() if p < len(d) else p
    included = []
    for band in res.bands:
        if band.empty:
            continue
        blocks, incl, imsb = band.precincts[prec]
        for k, blk in enumerate(blocks):
            if not blk.included:
                inc = incl.decode(bits, k, layer + 1)
            else:
                inc = bits.bit()
            if not inc:
                continue
            if not blk.included:
                i = 0
                while not imsb.decode(bits, k, i):
                    i += 1
                blk.nbps = band.mb + 1 - i
                blk.included = True
            n = _num_passes(bits)
            while bits.bit():
                blk.lblock += 1
            length = bits.bits(blk.lblock + n.bit_length() - 1)
            blk.passes += n
            included.append((blk, length))
    p = bits.align()
    for blk, length in included:
        blk.chunks.append(d[p:p + length])
        p += length
    return p


def _packets(params, tile_box, comps):
    """(layer, resolution, component, precinct) in the tile's progression
    order, as OpenJPEG's pi.c iterates them (components not sub-sampled)."""
    order = params.progression
    layers = params.layers
    nc = len(comps)
    if order in (0, 1):
        for a in range(layers if order == 0 else
                       max(len(c) for c in comps)):
            for b in range(max(len(c) for c in comps) if order == 0 else
                           layers):
                lay, r = (a, b) if order == 0 else (b, a)
                for c in range(nc):
                    if r >= len(comps[c]):
                        continue
                    res = comps[c][r]
                    for pn in range(res.pw * res.ph):
                        yield lay, r, c, pn
        return
    tx0, ty0, tx1, ty1 = tile_box
    seen = set()

    def steps(cs):
        dx = dy = 0
        for c in cs:
            nres = len(comps[c])
            for r, res in enumerate(comps[c]):
                sx = 1 << (res.ppx + nres - 1 - r)
                sy = 1 << (res.ppy + nres - 1 - r)
                dx = sx if not dx else min(dx, sx)
                dy = sy if not dy else min(dy, sy)
        return dx, dy

    def at(x, y, c, r):
        """The precinct of component c, resolution r at (x, y), or None."""
        nres = len(comps[c])
        if r >= nres:
            return None
        res = comps[c][r]
        lv = nres - 1 - r
        trx0, try0 = _ceil_div(tx0, 1 << lv), _ceil_div(ty0, 1 << lv)
        trx1, try1 = _ceil_div(tx1, 1 << lv), _ceil_div(ty1, 1 << lv)
        rpx, rpy = res.ppx + lv, res.ppy + lv
        if not (y % (1 << rpy) == 0 or (y == ty0 and
                                         (try0 << lv) % (1 << rpy))):
            return None
        if not (x % (1 << rpx) == 0 or (x == tx0 and
                                         (trx0 << lv) % (1 << rpx))):
            return None
        if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        pi = (_ceil_div(x, 1 << lv) >> res.ppx) - (trx0 >> res.ppx)
        pj = (_ceil_div(y, 1 << lv) >> res.ppy) - (try0 >> res.ppy)
        return pi + pj * res.pw

    def grid(dx, dy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += dx - x % dx
            y += dy - y % dy

    def emit(lay_range, r, c, pn):
        for lay in lay_range:
            key = (lay, r, c, pn)
            if key not in seen:
                seen.add(key)
                yield key

    nres = max(len(c) for c in comps)
    if order == 2:                                         # RPCL
        dx, dy = steps(range(nc))
        for r in range(nres):
            for x, y in grid(dx, dy):
                for c in range(nc):
                    pn = at(x, y, c, r)
                    if pn is not None:
                        yield from emit(range(layers), r, c, pn)
    elif order == 3:                                       # PCRL
        dx, dy = steps(range(nc))
        for x, y in grid(dx, dy):
            for c in range(nc):
                for r in range(nres):
                    pn = at(x, y, c, r)
                    if pn is not None:
                        yield from emit(range(layers), r, c, pn)
    else:                                                  # CPRL
        for c in range(nc):
            dx, dy = steps([c])
            for x, y in grid(dx, dy):
                for r in range(len(comps[c])):
                    pn = at(x, y, c, r)
                    if pn is not None:
                        yield from emit(range(layers), r, c, pn)


# ---------------------------------------------------------------------------
# inverse wavelets
# ---------------------------------------------------------------------------

def _lift_index(n: int, first: int):
    """Targets of one parity (starting at `first`) of a length-n signal and
    their left / right neighbours, mirrored at the ends."""
    t = np.arange(first, n, 2)
    left = np.abs(t - 1)
    right = t + 1
    right = np.where(right >= n, 2 * (n - 1) - right, right)
    return t, left, right


def _idwt_1d(x: np.ndarray, sn: int, cas: int, reversible: bool):
    """Inverse 1D transform along the last axis of x (low samples first,
    sn of them; cas: the first sample is odd), in place."""
    n = x.shape[-1]
    lo_pos = np.arange(cas, n, 2)
    hi_pos = np.arange(1 - cas, n, 2)
    y = np.empty_like(x)
    y[..., lo_pos] = x[..., :sn]
    y[..., hi_pos] = x[..., sn:]
    if n == 1:
        if cas and reversible:
            y = np.where(y < 0, -((-y) // 2), y // 2).astype(y.dtype)
        x[...] = y
        return
    lo = _lift_index(n, cas)
    hi = _lift_index(n, 1 - cas)
    if reversible:
        t, le, ri = lo
        y[..., t] -= (y[..., le] + y[..., ri] + 2) >> 2
        t, le, ri = hi
        y[..., t] += (y[..., le] + y[..., ri]) >> 1
    else:
        y[..., lo[0]] *= _K
        y[..., hi[0]] *= _TWO_INV_K
        for (t, le, ri), c in ((lo, _DELTA), (hi, _GAMMA), (lo, _BETA),
                               (hi, _ALPHA)):
            y[..., t] = y[..., t] - c * (y[..., le] + y[..., ri])
    x[...] = y


def _idwt(a: np.ndarray, res: list, reversible: bool):
    """The inverse 2D transform of a tile-component laid out as OpenJPEG
    lays it out (each resolution's low half first on both axes)."""
    for r in range(1, len(res)):
        lo, cur = res[r - 1], res[r]
        w, h = cur.x1 - cur.x0, cur.y1 - cur.y0
        if w == 0 or h == 0:
            continue
        sw, sh = lo.x1 - lo.x0, lo.y1 - lo.y0
        _idwt_1d(a[:h, :w], sw, cur.x0 & 1, reversible)
        _idwt_1d(a[:h, :w].T, sh, cur.y0 & 1, reversible)


# ---------------------------------------------------------------------------
# tile decoding
# ---------------------------------------------------------------------------

def _tier1(blocks, native: bool | None = None):
    """Tier 1 of every code-block: the C++ twin where it builds (native
    None or True; True raises when it does not), else numpy."""
    if native is not False:
        from .. import native as nat

        out = nat.j2k_decode_blocks(blocks, required=native is True)
        if out is not None:
            return out
    from .j2k_t1 import decode_blocks

    return decode_blocks(blocks)


def decode_codestream(d: bytes, native: bool | None = None):
    """A raw codestream -> (list of per-component int32 (H, W) sample
    planes, after DC shift and clamp, precisions, signedness)."""
    siz, tiles = _parse(d)
    nc = len(siz.prec)
    W, H = siz.x1 - siz.x0, siz.y1 - siz.y0
    planes = [np.zeros((H, W), np.int32) for _ in range(nc)]
    work = []
    for t, (params, data) in sorted(tiles.items()):
        tx, ty = t % siz.ntx, t // siz.ntx
        box = (max(siz.tx0 + tx * siz.tw, siz.x0),
               max(siz.ty0 + ty * siz.th, siz.y0),
               min(siz.tx0 + (tx + 1) * siz.tw, siz.x1),
               min(siz.ty0 + (ty + 1) * siz.th, siz.y1))
        comps = []
        for c in range(nc):
            coding, quant = params.coding(c), params.quant(c)
            comps.append([_Resolution(box, r, coding, quant)
                          for r in range(coding.levels + 1)])
        p = 0
        for lay, r, c, pn in _packets(params, box, comps):
            p = _read_packet(data, p, comps[c][r], pn, lay)
        work.append((params, box, comps))
    # tier 1 of every code-block of the image at once
    jobs = [(b"".join(b.chunks), b.passes, b.nbps, band.orient,
             b.y1 - b.y0, b.x1 - b.x0)
            for _, _, comps in work for _, band, b in _blocks(comps)]
    coeffs = iter(_tier1(jobs, native))
    for params, box, comps in work:
        rev = [params.coding(c).reversible for c in range(nc)]
        tile = [np.zeros((box[3] - box[1], box[2] - box[0]),
                         np.int32 if rev[c] else np.float32)
                for c in range(nc)]
        for c, band, b in _blocks(comps):
            v = next(coeffs)
            if rev[c]:
                v = np.where(v < 0, -((-v) >> 1), v >> 1)
            else:                       # half the step: v is doubled
                expn, mant = band.step
                v = v.astype(np.float32) * np.float32(
                    (1.0 + mant / 2048.0) * 2.0 ** (siz.prec[c] - expn - 1))
            y0, x0 = band.oy + b.y0 - band.y0, band.ox + b.x0 - band.x0
            tile[c][y0:y0 + v.shape[0], x0:x0 + v.shape[1]] = v
        for c in range(nc):
            _idwt(tile[c], comps[c], rev[c])
        if params.mct and nc >= 3:
            tile[:3] = _inverse_mct(tile[:3], rev[0])
        for c, a in enumerate(tile):
            prec, sg = siz.prec[c], siz.signed[c]
            lo, hi = ((-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sg
                      else (0, (1 << prec) - 1))
            if a.dtype == np.float32:
                a = np.rint(a)
            planes[c][box[1] - siz.y0:box[3] - siz.y0,
                      box[0] - siz.x0:box[2] - siz.x0] = np.clip(
                a.astype(np.int64) + (0 if sg else 1 << (prec - 1)), lo, hi)
    return planes, siz


def _blocks(comps):
    """(component, band, code-block) of every code-block of a tile, in
    one fixed order."""
    for c, res in enumerate(comps):
        for rl in res:
            for band in rl.bands:
                if not band.empty:
                    for blocks, _, _ in band.precincts:
                        for b in blocks:
                            yield c, band, b


def _inverse_mct(t, reversible: bool):
    y, u, v = t
    if reversible:
        g = y - ((u + v) >> 2)
        return [v + g, g, u + g]
    r = y + v * np.float32(1.402)
    g = (y - u * np.float32(0.34413)) - v * np.float32(0.71414)
    b = y + u * np.float32(1.772)
    return [r, g, b]


# ---------------------------------------------------------------------------
# PIL's unpacking (Jpeg2KDecode.c)
# ---------------------------------------------------------------------------

# PIL's YCbCr -> RGB (Convert.c ImagingConvertYCbCr2RGB): r = y + R[cr],
# g = y + ((Gcb[cb] + Gcr[cr]) >> 6), b = y + B[cb], clamped; integer
# tables that reproduce it on every input, as int16 little-endian
_YCC = np.frombuffer(base64.b64decode(
    "TP9N/0//UP9S/1P/VP9W/1f/Wf9a/1v/Xf9e/2D/Yf9i/2T/Zf9n/2j/av9r/2z/bv9v/3H/"
    "cv9z/3X/dv94/3n/ev98/33/f/+A/4H/g/+E/4b/h/+I/4r/i/+N/47/j/+R/5L/lP+V/5b/"
    "mP+Z/5v/nP+d/5//oP+i/6P/pP+m/6f/qf+q/6v/rf+u/7D/sf+y/7T/tf+3/7j/uf+7/7z/"
    "vv+//8D/wv/D/8X/xv/H/8n/yv/M/83/zv/Q/9H/0//U/9X/1//Y/9r/2//c/97/3//h/+L/"
    "4//l/+b/6P/p/+r/7P/t/+//8P/y//P/9P/2//f/+f/6//v//f/+/wAAAQACAAQABQAHAAgA"
    "CQALAAwADgAPABAAEgATABUAFgAXABkAGgAcAB0AHgAgACEAIwAkACUAJwAoACoAKwAsAC4A"
    "LwAxADIAMwA1ADYAOAA5ADoAPAA9AD8AQABBAEMARABGAEcASABKAEsATQBOAE8AUQBSAFQA"
    "VQBWAFgAWQBbAFwAXQBfAGAAYgBjAGQAZgBnAGkAagBrAG0AbgBwAHEAcgB0AHUAdwB4AHkA"
    "ewB8AH4AfwCAAIIAgwCFAIYAiACJAIoAjACNAI8AkACRAJMAlACWAJcAmACaAJsAnQCeAJ8A"
    "oQCiAKQApQCmAKgAqQCrAKwArQCvALAAsgAd/x7/IP8i/yT/Jv8n/yn/K/8t/y7/MP8y/zT/"
    "Nv83/zn/O/89/z7/QP9C/0T/Rf9H/0n/S/9N/07/UP9S/1T/Vf9X/1n/W/9c/17/YP9i/2T/"
    "Zf9n/2n/a/9s/27/cP9y/3T/df93/3n/e/98/37/gP+C/4P/hf+H/4n/i/+M/47/kP+S/5P/"
    "lf+X/5n/m/+c/57/oP+i/6P/pf+n/6n/qv+s/67/sP+y/7P/tf+3/7n/uv+8/77/wP/C/8P/"
    "xf/H/8n/yv/M/87/0P/R/9P/1f/X/9n/2v/c/97/4P/h/+P/5f/n/+j/6v/s/+7/8P/x//P/"
    "9f/3//j/+v/8//7/AAABAAMABQAHAAgACgAMAA4ADwARABMAFQAXABgAGgAcAB4AHwAhACMA"
    "JQAmACgAKgAsAC4ALwAxADMANQA2ADgAOgA8AD4APwBBAEMARQBGAEgASgBMAE0ATwBRAFMA"
    "VQBWAFgAWgBcAF0AXwBhAGMAZQBmAGgAagBsAG0AbwBxAHMAdAB2AHgAegB8AH0AfwCBAIMA"
    "hACGAIgAigCLAI0AjwCRAJMAlACWAJgAmgCbAJ0AnwChAKMApACmAKgAqgCrAK0ArwCxALIA"
    "tAC2ALgAugC7AL0AvwDBAMIAxADGAMgAygDLAM0AzwDRANIA1ADWANgA2QDbAN0A3wDhAAEL"
    "9wrJCsEKkwqJCn8KUwpJCj0KEwoHCv0J0gnFCb0JkAmFCXwJTglFCToJDgkECfkIzgjCCLkI"
    "iwiBCHgISQhBCDYICQgACNMHyQe+B5MHiAd9B1MHRgc9BxEHBQf9Bs8GxQa7Bo4GhQZ5Bk4G"
    "QwY5Bg0GAQb5BcsFwQW4BYkFgQV2BUkFQAUTBQkF/QTTBMcEvQSSBIUEfQRQBEUEPAQOBAUE"
    "+gPOA8QDuQOOA4IDeQNMA0EDOQMKAwED9wLJAsECkwKJAn8CUwJJAj0CEwIHAv0B0gHFAb0B"
    "jwGFAXsBTgFFATkBDgEDAfkAzQDBALkAiwCBAHgASQBBADYACQAAANP/yf+//5P/if99/1P/"
    "R/89/xL/Bf/9/tD+xf68/o7+hf56/k7+RP45/g3+Af75/cv9wf24/Yn9gf12/Un9QP0T/Qn9"
    "/vzT/Mj8vfyT/Ib8ffxR/EX8PfwP/AX8+/vO+8X7ufuO+4P7eftN+0H7OfsL+wH7+PrJ+sH6"
    "k/qJ+n/6U/pJ+j36E/oH+v350vnF+b35kPmF+Xz5TvlF+Tr5DvkE+fn4zvjC+Ln4jPiB+Hn4"
    "SvhB+Df4CfgB+NP3yfe/95P3ifd991P3Rvc99xH3Bff99s/2xfa79o72hfZ59k72Q/Y59g32"
    "Afb59cv1wfW49Yn1gfV29Un1QPUT9Qn17Ra3Fn8WRxYyFvsVwxWtFXcVPxUHFfIUuxSDFG0U"
    "NxT/E8cTsxN7E0MTLRP3Er8ShxJzEjsSAxLtEbcRfxFHETMR+xDDEK4QdxA/EAcQ8w+7D4MP"
    "bg83D/8OyA6zDnsOQw4uDvcNvw2IDXMNOw0DDe4Mtwx/DEgMMwz7C8QLrgt3Cz8LCAvzCrsK"
    "hApuCjcK/wnICbMJewlECS4J9wjACIgIcwg7CAQI7ge3B4AHSAczB/sGxAauBncGQAYIBvMF"
    "vAWEBW4FNwUABcgEswR8BEQELgT4A8ADiANzAzwDBAPuArgCgAJIAjMC/AHEAa4BeAFAAQgB"
    "9AC8AIQAbgA4AAAAyf+1/33/Rf8v//n+wf6J/nX+Pf4F/vD9uf2B/Un9Nf39/MX8sPx5/EH8"
    "Cfz1+737hftw+zn7AfvK+rX6ffpF+jD6+fnB+Yr5dfk9+Qb58Pi5+IH4Svg1+P33xvew93n3"
    "QfcK9/X2vfaG9nD2OfYC9sr1tfV99Ub1MPX59ML0ivR19D30BvTw87nzgvNK8zXz/vLG8rDy"
    "efJC8gry9fG+8YbxcPE58QLxyvC18H7wRvAw8Prvwu+K73XvPu8G7/Duuu6C7kruNu7+7cbt"
    "sO167ULtCu327L7shuxw7DrsAuzK67brfutG6zHr+urC6orqduo+6gbq8em66YLpbOk="),
    "<i2").astype(np.int64).reshape(4, 256)


def _ycbcr_to_rgb(px: np.ndarray) -> np.ndarray:
    y, cb, cr = (px[..., k].astype(np.int64) for k in range(3))
    r = y + _YCC[0][cr]
    g = y + ((_YCC[2][cb] + _YCC[3][cr]) >> 6)
    b = y + _YCC[1][cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _unpack(planes, siz, mode: str, space: str, palette=None):
    """The samples PIL's unpacker gives for this mode and colour space,
    then the port's conventions."""
    nc = len(planes)
    kinds = {("L", "gray", 1), ("I;16", "gray", 1), ("LA", "gray", 2),
             ("P", "srgb", 1), ("RGB", "srgb", 3), ("RGB", "sycc", 3),
             ("RGBA", "srgb", 4), ("RGBA", "sycc", 4), ("CMYK", "cmyk", 4)}
    if (mode, space, nc) not in kinds:
        raise ValueError(f"JPEG 2000: {nc} components in {space} colour as "
                         f"PIL's {mode} are not read")
    if nc > 1 and max(siz.prec) > 8:
        raise ValueError("JPEG 2000: colour samples over 8 bits are not read")
    depth = 16 if mode == "I;16" else 8
    out = []
    for c, a in enumerate(planes):
        prec = siz.prec[c]
        v = a.astype(np.int64) + ((1 << (prec - 1)) if siz.signed[c] else 0)
        sh = depth - prec
        v = v << sh if sh >= 0 else (v + (1 << (-sh - 1))) >> -sh
        out.append(v & ((1 << depth) - 1))
    px = np.stack(out, -1).astype(np.uint16 if depth == 16 else np.uint8)
    if space == "sycc":
        px = np.concatenate([_ycbcr_to_rgb(px), px[..., 3:]], -1)
    if mode == "CMYK":
        from .image import cmyk_to_rgb

        return cmyk_to_rgb(px)
    if mode == "P":
        return palette[px[..., 0]]
    return px


def _malformed(fn):
    """fn with a header or box cut short raising ValueError, as every
    other unreadable file does."""
    def wrapped(data, native=None):
        try:
            return fn(data, native)
        except (struct.error, IndexError) as e:
            raise ValueError(f"JPEG 2000: truncated or malformed ({e})") \
                from e
    wrapped.__name__, wrapped.__doc__ = fn.__name__, fn.__doc__
    return wrapped


@_malformed
def decode_j2k(data: bytes, native: bool | None = None) -> np.ndarray:
    """A raw JPEG 2000 codestream's samples (see the module docstring),
    in PIL's mode from SIZ (Jpeg2KImagePlugin._parse_codestream)."""
    d = bytes(data)
    if d[:4] != J2K_MAGIC:
        raise ValueError("not a JPEG 2000 codestream")
    siz = _Siz(d, 4)
    nc = len(siz.prec)
    if nc == 1:
        mode = "I;16" if siz.prec[0] > 8 else "L"
    else:
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}.get(nc)
        if mode is None:
            raise ValueError(f"JPEG 2000: {nc} components are not read")
    planes, siz = decode_codestream(d, native)
    return _unpack(planes, siz, mode, "gray" if nc <= 2 else "srgb")


def _boxes(d: bytes, p: int, end: int):
    while p < end:
        n, kind = struct.unpack_from(">I4s", d, p)
        hl = 8
        if n == 1:
            n, hl = struct.unpack_from(">Q", d, p + 8)[0], 16
        elif n == 0:
            n = end - p
        if n < hl or p + n > end:
            raise ValueError("JPEG 2000: malformed box")
        yield kind, p + hl, p + n
        p += n


_SPACES = {16: "srgb", 17: "gray", 18: "sycc", 12: "cmyk"}


@_malformed
def decode_jp2(data: bytes, native: bool | None = None) -> np.ndarray:
    """A JP2 / JPX file's samples (see the module docstring): the header
    boxes read as PIL's _parse_jp2_header reads them (mode from ihdr, CMYK
    from colr, a palette from pclr; cdef, cmap and res change nothing, as
    they change nothing in PIL's tile-by-tile decode), the colour space
    from the first colr box as OpenJPEG takes it."""
    d = bytes(data)
    if d[:12] != JP2_MAGIC:
        raise ValueError("not a JP2 file")
    header = code = None
    for kind, p, end in _boxes(d, 12, len(d)):
        if kind == b"jp2h" and header is None:
            header = (p, end)
        elif kind == b"jp2c" and code is None:
            code = d[p:end]
    if header is None or code is None:
        raise ValueError("JPEG 2000: no jp2h or jp2c box")
    mode = nc = bpc = space = palette = None
    for kind, p, end in _boxes(d, *header):
        if kind == b"ihdr":
            _, _, nc, bpc = struct.unpack_from(">IIHB", d, p)
            mode = ("I;16" if nc == 1 and (bpc & 0x7F) > 8 else
                    {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc))
        elif kind == b"colr":
            meth, _, _, enum = struct.unpack_from(">BBBI", d, p)
            if meth != 1:
                raise ValueError("JPEG 2000: ICC colour is not read")
            if space is None:
                space = _SPACES.get(enum)
                if space is None:
                    raise ValueError(f"JPEG 2000: colour space {enum} is not "
                                     "read")
            if nc == 4 and enum == 12:
                mode = "CMYK"
        elif kind == b"pclr" and mode in ("L", "LA"):
            ne, npc = struct.unpack_from(">HB", d, p)
            depths = d[p + 3:p + 3 + npc]
            if max(depths) <= 8:
                if mode == "LA":
                    raise ValueError("JPEG 2000: a palette with alpha (PA) "
                                     "is not read")
                ent = np.frombuffer(d, np.uint8, ne * npc, p + 3 + npc)
                palette = _pil_palette(ent.reshape(ne, npc))
                mode = "P"
    if mode is None or space is None:
        raise ValueError("JPEG 2000: malformed JP2 header")
    if code[:4] != J2K_MAGIC:
        raise ValueError("JPEG 2000: no codestream in the jp2c box")
    siz = _Siz(code, 4)
    if len(siz.prec) != nc or (nc == 1 and (siz.prec[0] > 8) != (
            mode == "I;16")):
        raise ValueError("JPEG 2000: the JP2 header and the codestream "
                         "disagree")
    planes, siz = decode_codestream(code, native)
    return _unpack(planes, siz, mode, space, palette)


def _pil_palette(ent: np.ndarray) -> np.ndarray:
    """The colours PIL's convert gives each index: its palette holds each
    colour once, in order of first appearance (ImagePalette.getcolor), the
    rest black."""
    seen = {}
    for row in map(tuple, ent):
        seen.setdefault(row, len(seen))
    pal = np.zeros((256, ent.shape[1]), np.uint8)
    if seen:
        pal[:len(seen)] = np.array(list(seen), np.uint8)
    if ent.shape[1] == 4:
        return pal
    return pal[:, :3]
