"""PIZ decompression of EXR scanline chunks (port of
acceleratedvolrenderer_tpu/utils/piz.py, numpy only).

The PIZ scheme (bitmap-LUT range compaction, 2D integer wavelet, canonical
Huffman coding) from the OpenEXR file-format specification; decode only
(utils/image.py writes ZIP).  The Huffman inner loop is table-driven (a
14-bit fast table).
"""
from __future__ import annotations

import struct

import numpy as np

USHORT_RANGE = 1 << 16
BITMAP_SIZE = USHORT_RANGE >> 3

HUF_ENCBITS = 16
HUF_DECBITS = 14
HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1
HUF_DECSIZE = 1 << HUF_DECBITS
HUF_DECMASK = HUF_DECSIZE - 1

SHORT_ZEROCODE_RUN = 59
LONG_ZEROCODE_RUN = 63
SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN


def _reverse_lut_from_bitmap(bitmap: np.ndarray):
    bits = np.unpackbits(bitmap, bitorder="little")
    bits[0] = 1
    lut = np.nonzero(bits)[0].astype(np.uint16)
    max_value = lut.size - 1
    full = np.zeros(USHORT_RANGE, np.uint16)
    full[: lut.size] = lut
    return full, max_value


class _BitReader:
    __slots__ = ("data", "pos", "c", "lc")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.c = 0
        self.lc = 0

    def get_bits(self, n: int) -> int:
        while self.lc < n:
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= n
        return (self.c >> self.lc) & ((1 << n) - 1)


def _unpack_enc_table(br: _BitReader, im: int, iM: int):
    hcode = np.zeros(HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        l = br.get_bits(6)
        hcode[i] = l
        if l == LONG_ZEROCODE_RUN:
            zerun = br.get_bits(8) + SHORTEST_LONG_RUN
            hcode[i: i + zerun] = 0
            i += zerun
        elif l >= SHORT_ZEROCODE_RUN:
            zerun = l - SHORT_ZEROCODE_RUN + 2
            hcode[i: i + zerun] = 0
            i += zerun
        else:
            i += 1
    _canonical_code_table(hcode)
    return hcode


def _canonical_code_table(hcode: np.ndarray):
    n = np.zeros(59, np.int64)
    lens = hcode[hcode > 0]
    cnt = np.bincount(lens, minlength=59)
    n[: cnt.size] = cnt[:59]
    c = 0
    for i in range(58, -1, -1):
        nc = (c + n[i]) >> 1
        n[i] = c
        c = nc
    for i in range(HUF_ENCSIZE):
        l = int(hcode[i])
        if l > 0:
            hcode[i] = l | (n[l] << 6)
            n[l] += 1


def _build_dec_table(hcode: np.ndarray, im: int, iM: int):
    # fast table: for codes with len <= HUF_DECBITS store (len, lit);
    # long codes go into a per-slot python list
    dec_len = np.zeros(HUF_DECSIZE, np.int32)
    dec_lit = np.zeros(HUF_DECSIZE, np.int64)
    dec_long = {}
    for sym in range(im, iM + 1):
        entry = int(hcode[sym])
        l = entry & 63
        if l == 0:
            continue
        c = entry >> 6
        if l > HUF_DECBITS:
            slot = c >> (l - HUF_DECBITS)
            dec_long.setdefault(slot, []).append(sym)
        else:
            base = c << (HUF_DECBITS - l)
            cnt = 1 << (HUF_DECBITS - l)
            dec_len[base: base + cnt] = l
            dec_lit[base: base + cnt] = sym
    return dec_len, dec_lit, dec_long


def _huf_decode(hcode, dec_len, dec_lit, dec_long, data: bytes, ni: int, rlc: int, no: int):
    out = np.zeros(no, np.uint16)
    oi = 0
    c = 0
    lc = 0
    i = 0
    n_bytes = (ni + 7) >> 3

    def emit(sym):
        nonlocal oi, c, lc, i
        if sym == rlc:
            if lc < 8:
                c = (c << 8) | data[i]
                i += 1
                lc += 8
            lc -= 8
            cs = (c >> lc) & 0xFF
            out[oi: oi + cs] = out[oi - 1]
            oi += cs
        else:
            out[oi] = sym
            oi += 1

    while i < n_bytes:
        c = (c << 8) | data[i]
        i += 1
        lc += 8
        while lc >= HUF_DECBITS:
            idx = (c >> (lc - HUF_DECBITS)) & HUF_DECMASK
            l = dec_len[idx]
            if l:
                lc -= l
                emit(dec_lit[idx])
            else:
                # long code: linear search candidates registered at this slot
                found = False
                for sym in dec_long.get(idx, ()):
                    entry = int(hcode[sym])
                    sl = entry & 63
                    sc = entry >> 6
                    while lc < sl and i < n_bytes:
                        c = (c << 8) | data[i]
                        i += 1
                        lc += 8
                    if lc >= sl and ((c >> (lc - sl)) & ((1 << sl) - 1)) == sc:
                        lc -= sl
                        emit(sym)
                        found = True
                        break
                if not found:
                    raise ValueError("PIZ: invalid Huffman code")
    # drop padding bits of the final partial byte, then flush
    pad = (8 - ni) & 7
    c >>= pad
    lc -= pad
    while lc > 0:
        idx = (c << (HUF_DECBITS - lc)) & HUF_DECMASK
        l = dec_len[idx]
        if l and l <= lc:
            lc -= l
            emit(dec_lit[idx])
        else:
            break
    if oi != no:
        raise ValueError(f"PIZ: Huffman decoded {oi} of {no} symbols")
    return out


def _huf_uncompress(data: bytes, n_out: int) -> np.ndarray:
    im, iM, table_len, n_bits, _room = struct.unpack("<5I", data[:20])
    br = _BitReader(data[20:])
    hcode = _unpack_enc_table(br, im, iM)
    dec_len, dec_lit, dec_long = _build_dec_table(hcode, im, iM)
    bit_data_start = 20 + br.pos
    return _huf_decode(hcode, dec_len, dec_lit, dec_long, data[bit_data_start:],
                       n_bits, iM, n_out)


def _wav2_decode(buf: np.ndarray, nx: int, ox: int, ny: int, oy: int, mx: int):
    """In-place 2D wavelet decode on a strided view; vectorized over rows/cols
    per level (OpenEXR wav2Decode semantics)."""
    w14 = mx < (1 << 14)
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1

    def wdec14(l, h):
        ls = l.astype(np.int16).astype(np.int32)
        hs = h.astype(np.int16).astype(np.int32)
        ai = ls + (hs & 1) + (hs >> 1)
        a = ai
        b = ai - hs
        return a.astype(np.uint16), b.astype(np.uint16)

    A_OFFSET = 1 << 15
    MOD_MASK = (1 << 16) - 1

    def wdec16(l, h):
        m = l.astype(np.int32)
        d = h.astype(np.int32)
        bb = (m - (d >> 1)) & MOD_MASK
        aa = (d + bb - A_OFFSET) & MOD_MASK
        return aa.astype(np.uint16), bb.astype(np.uint16)

    wdec = wdec14 if w14 else wdec16

    # view buffer as (ny, nx) with given element strides
    assert ox == 1 or oy == 1 or True
    view = np.lib.stride_tricks.as_strided(
        buf, shape=(ny, nx), strides=(oy * buf.itemsize, ox * buf.itemsize), writeable=True
    ) if (oy * (ny - 1) + ox * (nx - 1)) < buf.size else None
    if view is None:
        raise ValueError("bad strides")

    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if ys.size and xs.size:
            g00 = view[np.ix_(ys, xs)]
            g01 = view[np.ix_(ys, xs + p)]
            g10 = view[np.ix_(ys + p, xs)]
            g11 = view[np.ix_(ys + p, xs + p)]
            i00, i10 = wdec(g00, g10)
            i01, i11 = wdec(g01, g11)
            a00, a01 = wdec(i00, i01)
            a10, a11 = wdec(i10, i11)
            view[np.ix_(ys, xs)] = a00
            view[np.ix_(ys, xs + p)] = a01
            view[np.ix_(ys + p, xs)] = a10
            view[np.ix_(ys + p, xs + p)] = a11
        if (nx & p) and ys.size:
            # odd column at x = xs_end (the position after the loop)
            xcol = xs[-1] + p2 if xs.size else 0
            if xcol < nx:
                c0 = view[np.ix_(ys, [xcol])]
                c1 = view[np.ix_(ys + p, [xcol])]
                a, b = wdec(c0, c1)
                view[np.ix_(ys, [xcol])] = a
                view[np.ix_(ys + p, [xcol])] = b
        if (ny & p) and xs.size:
            yrow = ys[-1] + p2 if ys.size else 0
            if yrow < ny:
                r0 = view[np.ix_([yrow], xs)]
                r1 = view[np.ix_([yrow], xs + p)]
                a, b = wdec(r0, r1)
                view[np.ix_([yrow], xs)] = a
                view[np.ix_([yrow], xs + p)] = b
        p2 = p
        p >>= 1
    return buf


def piz_decompress(data: bytes, width: int, ny: int, channels) -> bytes:
    """Decompress one PIZ chunk.

    channels: list of (name, pixel_type, xsampling, ysampling) in header
    order. Returns raw scanline-interleaved bytes (per line, per channel)."""
    pos = 0
    min_nz, max_nz = struct.unpack("<HH", data[pos: pos + 4])
    pos += 4
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        count = max_nz - min_nz + 1
        bitmap[min_nz: max_nz + 1] = np.frombuffer(data[pos: pos + count], np.uint8)
        pos += count
    lut, max_value = _reverse_lut_from_bitmap(bitmap)

    (length,) = struct.unpack("<i", data[pos: pos + 4])
    pos += 4

    nbytes = {0: 4, 1: 2, 2: 4}
    sizes = [nbytes[pt] // 2 for _, pt, _, _ in channels]  # ushorts per sample
    total = sum(width * ny * s for s in sizes)
    decoded = _huf_uncompress(data[pos: pos + length], total)

    # split per channel, wavelet-decode, apply lut
    out_chans = []
    off = 0
    for (name, pt, _, _), size in zip(channels, sizes):
        n = width * ny * size
        cbuf = decoded[off: off + n].copy()
        off += n
        for j in range(size):
            _wav2_decode(cbuf[j:], width, size, ny, width * size, max_value)
        cbuf = lut[cbuf]
        out_chans.append(cbuf.reshape(ny, width * size))

    # interleave per scanline in header channel order
    out = bytearray()
    for y in range(ny):
        for cbuf in out_chans:
            out += cbuf[y].tobytes()
    return bytes(out)
