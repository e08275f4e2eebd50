"""WebP decoding without libwebp: the RIFF container (simple `VP8 `, simple
`VP8L`, extended `VP8X` with `ALPH`, the first frame of an animation), the
lossless VP8L stream in numpy and Python, and the lossy VP8 key frame
(utils/vp8.py) turned into RGB by libwebp's fancy upsampling and its 14-bit
fixed-point YUV -> RGB conversion, the path PIL's decode takes.  Every step follows libwebp's decoder
(src/dec/vp8l_dec.c, alpha_dec.c, src/dsp/upsampling.c, yuv.h,
lossless.c, filters.c), so the samples equal PIL's bit for bit.

decode_webp(data) -> (H, W, 3) or (H, W, 4) uint8 (RGB, or RGBA where the
file carries alpha; RGB is not premultiplied).
"""
from __future__ import annotations

import struct

import numpy as np

from .vp8 import decode_frame

# ---------------------------------------------------------------------------
# VP8L: the lossless stream
# ---------------------------------------------------------------------------

_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                      13, 14, 15)
# (dy, dx) of the 120 short distance codes, packed as dy << 4 | (8 - dx)
_CODE_TO_PLANE = (
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54,
    58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52,
    60, 3, 87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2,
    103, 105, 18, 30, 102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120,
    1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78, 118, 122, 33, 47, 117, 123,
    49, 63, 99, 109, 82, 94, 0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115,
    125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112)
_PREDICTOR, _CROSS_COLOR, _SUBTRACT_GREEN, _COLOR_INDEXING = range(4)


class _Bits:
    """LSB-first bit reader over a byte string (VP8LBitReader): `w[i]` is
    the little-endian 32-bit word at byte i, so up to 25 bits are read
    from one lookup."""

    def __init__(self, data: bytes, pos: int = 0):
        b = np.frombuffer(bytes(data) + b"\0" * 8, np.uint8).astype(np.uint32)
        self.w = (b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16)
                  | (b[3:] << 24)).tolist()
        self.pos = 8 * pos
        self.end = 8 * len(data)

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        if self.pos > self.end:
            raise ValueError("WebP: truncated lossless stream")
        return (self.w[p >> 3] >> (p & 7)) & ((1 << n) - 1)


class _Code:
    """A canonical prefix code read LSB first through one table indexed by
    the next `bits` bits (its longest code's length; 0 for a code of one
    symbol, which reads no bits)."""

    def __init__(self, lengths):
        lengths = np.asarray(lengths, np.int64)
        used = np.flatnonzero(lengths)
        if len(used) == 0:
            raise ValueError("WebP: empty prefix code")
        if len(used) == 1:
            self.bits, self.sym, self.len = 0, [int(used[0])], [0]
            return
        maxlen = int(lengths.max())
        order = used[np.lexsort((used, lengths[used]))]     # by length, symbol
        lens = lengths[order]
        code, codes, prev = 0, [], lens[0]
        for ln in lens.tolist():
            code <<= ln - prev
            codes.append(code)
            code += 1
            prev = ln
        if code != 1 << maxlen:
            raise ValueError("WebP: incomplete prefix code")
        size = 1 << maxlen
        sym = np.zeros(size, np.int64)
        ln_t = np.zeros(size, np.int64)
        for s, c, ln in zip(order.tolist(), codes, lens.tolist()):
            r = int(f"{c:0{ln}b}"[::-1], 2)                  # bit-reversed
            idx = r + (np.arange(size >> ln) << ln)
            sym[idx] = s
            ln_t[idx] = ln
        self.bits, self.sym, self.len = maxlen, sym.tolist(), ln_t.tolist()

    def read(self, br: _Bits) -> int:
        p = br.pos
        i = (br.w[p >> 3] >> (p & 7)) & ((1 << self.bits) - 1)
        br.pos = p + self.len[i]
        if br.pos > br.end:
            raise ValueError("WebP: truncated lossless stream")
        return self.sym[i]


def _read_code(br: _Bits, alphabet: int) -> _Code:
    """ReadHuffmanCode: a simple code of one or two symbols, or code lengths
    coded by a code-length code."""
    lengths = [0] * alphabet
    if br.read(1):                                      # simple code
        n = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        lengths[first] = 1
        if n == 2:
            lengths[br.read(8)] = 1
        return _Code(lengths)
    cl = [0] * 19
    for i in range(br.read(4) + 4):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    lcode = _Code(cl)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise ValueError("WebP: bad code length count")
    else:
        max_symbol = alphabet
    sym, prev = 0, 8
    while sym < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = lcode.read(br)
        if c < 16:
            lengths[sym] = c
            sym += 1
            if c:
                prev = c
            continue
        extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
        rep = br.read(extra) + offset
        if sym + rep > alphabet:
            raise ValueError("WebP: code lengths overrun the alphabet")
        lengths[sym:sym + rep] = [prev if c == 16 else 0] * rep
        sym += rep
    return _Code(lengths)


def _copy_length(sym: int, br: _Bits) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _sub_size(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _decode_pixels(br: _Bits, w: int, h: int, top: bool) -> np.ndarray:
    """The entropy-coded ARGB pixels of one image (DecodeImageStream after
    its transforms): colour cache, meta prefix codes (at the top level
    only), literals, LZ77 copies and cache hits; uint32 (h * w,)."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError("WebP: bad colour cache size")
    meta_bits, meta = 0, None
    if top and br.read(1):
        meta_bits = br.read(3) + 2
        mw = _sub_size(w, meta_bits)
        img = _decode_pixels(br, mw, _sub_size(h, meta_bits), False)
        meta = ((img >> 8) & 0xFFFF).astype(np.int64).reshape(-1, mw)
    n_groups = 1 if meta is None else int(meta.max()) + 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = [[_read_code(br, a) for a in (256 + 24 + cache_size, 256, 256,
                                           256, 40)]
              for _ in range(n_groups)]
    total = w * h
    out = [0] * total
    cache = [0] * max(cache_size, 1)
    shift = 32 - cache_bits
    mask = (1 << meta_bits) - 1 if meta is not None else -1
    green, red, blue, alpha, dist = groups[0]
    pos = col = row = cached = 0
    while pos < total:
        if meta is not None and not col & mask:
            green, red, blue, alpha, dist = groups[meta[row >> meta_bits,
                                                        col >> meta_bits]]
        c = green.read(br)
        if c < 256:
            r = red.read(br)
            b = blue.read(br)
            out[pos] = (alpha.read(br) << 24) | (r << 16) | (c << 8) | b
            pos += 1
            col += 1
            if col >= w:
                col = 0
                row += 1
        elif c < 280:
            length = _copy_length(c - 256, br)
            code = _copy_length(dist.read(br), br)
            if code > 120:
                d = code - 120
            else:
                p = _CODE_TO_PLANE[code - 1]
                d = max((p >> 4) * w + 8 - (p & 15), 1)
            if d > pos or pos + length > total:
                raise ValueError("WebP: bad backward reference")
            for i in range(pos, pos + length):
                out[i] = out[i - d]
            pos += length
            col += length
            while col >= w:
                col -= w
                row += 1
            if meta is not None and pos < total and col & mask:
                green, red, blue, alpha, dist = groups[
                    meta[row >> meta_bits, col >> meta_bits]]
        else:
            if cache_bits == 0 or c - 280 >= cache_size:
                raise ValueError("WebP: bad colour cache index")
            while cached < pos:                         # insert lazily
                v = out[cached]
                cache[((v * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = v
                cached += 1
            out[pos] = cache[c - 280]
            pos += 1
            col += 1
            if col >= w:
                col = 0
                row += 1
        if cache_bits:
            while cached < pos:
                v = out[cached]
                cache[((v * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = v
                cached += 1
    return np.array(out, np.uint32)


def _add(a, b):
    """Per-channel sum mod 256 of packed ARGB words (VP8LAddPixels)."""
    return ((((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00)
            | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF))


def _avg2(a, b):
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _channels(p):
    return [(p >> s) & 0xFF for s in (24, 16, 8, 0)]


def _pack(chans):
    return (chans[0] << 24) | (chans[1] << 16) | (chans[2] << 8) | chans[3]


def _select(t, l, tl):
    """Predictor 11: T when sum |L - TL| <= sum |T - TL|, else L."""
    s = 0
    for a, b, c in zip(_channels(t), _channels(l), _channels(tl)):
        s += abs(b - c) - abs(a - c)
    return t if s <= 0 else l


def _clamp_full(l, t, tl):
    return _pack([min(max(a + b - c, 0), 255) for a, b, c in zip(
        _channels(l), _channels(t), _channels(tl))])


def _clamp_half(l, t, tl):
    ave = _avg2(l, t)
    return _pack([min(max(a + int((a - b) / 2), 0), 255)
                  for a, b in zip(_channels(ave), _channels(tl))])


def _predict(mode, l, t, tl, tr):
    if mode == 1:
        return l
    if mode == 2:
        return t
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _avg2(_avg2(l, tr), t)
    if mode == 6:
        return _avg2(l, tl)
    if mode == 7:
        return _avg2(l, t)
    if mode == 8:
        return _avg2(tl, t)
    if mode == 9:
        return _avg2(t, tr)
    if mode == 10:
        return _avg2(_avg2(l, tl), _avg2(t, tr))
    if mode == 11:
        return _select(t, l, tl)
    if mode == 12:
        return _clamp_full(l, t, tl)
    if mode == 13:
        return _clamp_half(l, t, tl)
    return 0xFF000000                           # 0, and 14-15 as libwebp


def _inverse_predictor(px, w, h, bits, modes):
    """PredictorInverseTransform: row 0 predicted from black then the left
    pixel, column 0 from the pixel above, the rest by their tile's mode;
    the top-right of the last column is the first pixel of the row."""
    out = px.astype(np.int64).tolist()
    out[0] = _add(out[0], 0xFF000000)
    for x in range(1, w):
        out[x] = _add(out[x], out[x - 1])
    mw = _sub_size(w, bits)
    modes = ((modes >> 8) & 0xF).astype(np.int64).tolist()
    for y in range(1, h):
        base = y * w
        out[base] = _add(out[base], out[base - w])
        mrow = modes[(y >> bits) * mw:(y >> bits) * mw + mw]
        for x in range(1, w):
            i = base + x
            pred = _predict(mrow[x >> bits], out[i - 1], out[i - w],
                            out[i - w - 1], out[i - w + 1])
            out[i] = _add(out[i], pred)
    return np.array(out, np.uint32)


def _inverse_cross_color(px, w, h, bits, codes):
    mw = _sub_size(w, bits)
    yy, xx = np.divmod(np.arange(w * h), w)
    m = codes.astype(np.int64)[(yy >> bits) * mw + (xx >> bits)]

    def s8(v):
        return ((v & 0xFF) ^ 0x80) - 0x80

    g2r, g2b, r2b = s8(m), s8(m >> 8), s8(m >> 16)
    p = px.astype(np.int64)
    green = s8(p >> 8)
    red = ((p >> 16) + ((g2r * green) >> 5)) & 0xFF
    blue = (p + ((g2b * green) >> 5) + ((r2b * s8(red)) >> 5)) & 0xFF
    return ((p & 0xFF00FF00) | (red << 16) | blue).astype(np.uint32)


def _inverse_subtract_green(px):
    p = px.astype(np.int64)
    g = (p >> 8) & 0xFF
    rb = (p & 0x00FF00FF) + ((g << 16) | g)
    return ((p & 0xFF00FF00) | (rb & 0x00FF00FF)).astype(np.uint32)


def _inverse_color_indexing(px, w, h, bits, palette):
    lut = np.zeros(256, np.uint32)
    lut[:len(palette)] = palette[:256]
    pw = _sub_size(w, bits)
    idx = ((px.astype(np.int64) >> 8) & 0xFF).reshape(h, pw)
    if bits:
        per = 1 << bits
        bpp = 8 >> bits
        sub = idx[:, :, None] >> (np.arange(per) * bpp)
        idx = (sub & ((1 << bpp) - 1)).reshape(h, pw * per)[:, :w]
    return lut[idx].reshape(-1)


def _decode_stream(br: _Bits, w: int, h: int) -> np.ndarray:
    """A level-0 image stream (transforms, then the coded pixels) -> ARGB
    uint32 (h * w,)."""
    transforms, seen, xsize = [], set(), w
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise ValueError("WebP: a transform repeated")
        seen.add(kind)
        if kind in (_PREDICTOR, _CROSS_COLOR):
            bits = br.read(3) + 2
            data = _decode_pixels(br, _sub_size(xsize, bits),
                                  _sub_size(h, bits), False)
            transforms.append((kind, xsize, bits, data))
        elif kind == _COLOR_INDEXING:
            n = br.read(8) + 1
            bits = 3 if n <= 2 else 2 if n <= 4 else 1 if n <= 16 else 0
            pal = _decode_pixels(br, n, 1, False)
            pal = np.array([int(v) for v in pal], np.uint64)
            for i in range(1, n):
                pal[i] = _add(int(pal[i]), int(pal[i - 1]))
            transforms.append((kind, xsize, bits, pal.astype(np.uint32)))
            xsize = _sub_size(xsize, bits)
        else:
            transforms.append((kind, xsize, 0, None))
    px = _decode_pixels(br, xsize, h, True)
    for kind, tw, bits, data in reversed(transforms):
        if kind == _PREDICTOR:
            px = _inverse_predictor(px, tw, h, bits, data)
        elif kind == _CROSS_COLOR:
            px = _inverse_cross_color(px, tw, h, bits, data)
        elif kind == _SUBTRACT_GREEN:
            px = _inverse_subtract_green(px)
        else:
            px = _inverse_color_indexing(px, tw, h, bits, data)
    return px


def decode_vp8l(payload: bytes):
    """A VP8L chunk -> (RGBA uint8 (H, W, 4), alpha_is_used)."""
    if len(payload) < 5 or payload[0] != 0x2F:
        raise ValueError("WebP: not a lossless (VP8L) stream")
    br = _Bits(payload, 1)
    w, h = br.read(14) + 1, br.read(14) + 1
    has_alpha = bool(br.read(1))
    if br.read(3):
        raise ValueError("WebP: lossless stream version is not 0")
    return _argb_to_rgba(_decode_stream(br, w, h), w, h), has_alpha


def _argb_to_rgba(px, w, h):
    p = px.astype(np.uint32)
    return np.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF, p >> 24],
                    -1).astype(np.uint8).reshape(h, w, 4)


# ---------------------------------------------------------------------------
# ALPH: the alpha plane of a lossy image
# ---------------------------------------------------------------------------

def _unfilter(a: np.ndarray, method: int) -> np.ndarray:
    """The inverse of ALPH's spatial filter (dsp/filters.c, mod 256): 1
    horizontal, 2 vertical, 3 gradient; each row's first sample predicted
    from the one above it, row 0's first from 0 and the rest of row 0 from
    the left."""
    if method == 0:
        return a
    h, w = a.shape
    out = np.empty((h, w), np.uint8)
    out[0] = np.cumsum(a[0], dtype=np.int64) & 0xFF
    for y in range(1, h):
        prev = out[y - 1].astype(np.int64)
        row = a[y].astype(np.int64)
        if method == 1:
            row[0] += prev[0]
            out[y] = np.cumsum(row) & 0xFF
        elif method == 2:
            out[y] = (prev + row) & 0xFF
        else:
            left, top_left = int(prev[0]), int(prev[0])
            r = row.tolist()
            p = prev.tolist()
            for x in range(w):
                top = p[x]
                left = (r[x] + min(max(left + top - top_left, 0), 255)) & 0xFF
                top_left = top
                r[x] = left
            out[y] = r
    return out


def decode_alpha(payload: bytes, w: int, h: int) -> np.ndarray:
    """An ALPH chunk -> (h, w) uint8 alpha."""
    if not payload:
        raise ValueError("WebP: empty ALPH chunk")
    head = payload[0]
    method, filt = head & 3, (head >> 2) & 3
    if method == 0:
        if len(payload) - 1 < w * h:
            raise ValueError("WebP: truncated alpha plane")
        a = np.frombuffer(payload, np.uint8, w * h, 1).reshape(h, w)
    elif method == 1:
        px = _decode_stream(_Bits(payload, 1), w, h)
        a = ((px >> 8) & 0xFF).astype(np.uint8).reshape(h, w)
    else:
        raise ValueError(f"WebP: alpha compression {method} is not defined")
    return _unfilter(a, filt)


# ---------------------------------------------------------------------------
# VP8: the lossy key frame, then YUV 4:2:0 -> RGB
# ---------------------------------------------------------------------------

def _yuv_to_rgb(y, u, v):
    """libwebp's VP8YUVToR/G/B: 14-bit coefficients, results in 6
    fraction bits clipped to 0..255."""
    def mult_hi(a, c):
        return (a * c) >> 8

    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6,
                        np.where(x < 0, 0, 255)).astype(np.uint8)

    yy = mult_hi(y, 19077)
    return np.stack([clip8(yy + mult_hi(v, 26149) - 14234),
                     clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708),
                     clip8(yy + mult_hi(u, 33050) - 17685)], -1)


def _upsample(plane, w, h):
    """A (ceil(h/2), ceil(w/2)) chroma plane -> (h, w) by libwebp's fancy
    upsampler (UPSAMPLE_FUNC, u and v of its packed words apart), walked
    as EmitFancyRGB walks it: row 0 from chroma row 0 alone, rows 2k-1
    and 2k from chroma rows k-1 and k (each pair's upper row nearer row
    k-1), an even height's last row from the last chroma row alone."""
    c = plane.astype(np.int64)
    ch = c.shape[0]
    r = np.arange(h)
    k = (r + 1) >> 1
    top = np.where(r == 0, 0, k - 1)
    cur = np.minimum(k, ch - 1)
    if not h & 1 and h > 1:
        top[h - 1] = cur[h - 1] = ch - 1
    bottom = (r > 0) & (r & 1 == 0)
    T, C = c[top], c[cur]
    tl, t, l, cc = T[:, :-1], T[:, 1:], C[:, :-1], C[:, 1:]
    avg = tl + t + l + cc + 8
    diag_12 = (avg + 2 * (t + l)) >> 3
    diag_03 = (avg + 2 * (tl + cc)) >> 3
    b = bottom[:, None]
    near = np.where(b, C, T)
    far = np.where(b, T, C)
    out = np.empty((h, w), np.int64)
    out[:, 0] = (3 * near[:, 0] + far[:, 0] + 2) >> 2
    n = (w - 1) >> 1
    odd = np.where(b, (diag_03 + l) >> 1, (diag_12 + tl) >> 1)
    even = np.where(b, (diag_12 + cc) >> 1, (diag_03 + t) >> 1)
    out[:, 1:2 * n:2] = odd[:, :n]
    out[:, 2:2 * n + 1:2] = even[:, :n]
    if not w & 1:
        out[:, w - 1] = (3 * near[:, -1] + far[:, -1] + 2) >> 2
    return out


def decode_vp8(payload: bytes) -> np.ndarray:
    """A `VP8 ` chunk (a key frame) -> (H, W, 3) uint8 RGB."""
    if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError("WebP: bad lossy (VP8) frame header")
    w, h = (struct.unpack_from("<H", payload, 6)[0] & 0x3FFF,
            struct.unpack_from("<H", payload, 8)[0] & 0x3FFF)
    if not w or not h:
        raise ValueError("WebP: lossy frame of zero size")
    y, u, v = decode_frame(payload, w, h)
    return _yuv_to_rgb(y.astype(np.int64), _upsample(u, w, h),
                       _upsample(v, w, h))


# ---------------------------------------------------------------------------
# the RIFF container
# ---------------------------------------------------------------------------

def _chunks(data: bytes, pos: int, end: int):
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        if pos + 8 + size > end:
            raise ValueError(f"WebP: truncated {tag.decode('latin-1')!r} "
                             "chunk")
        yield tag, data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)


def _frame(chunks):
    """The image of a frame's chunks (ALPH then VP8, or VP8L) -> (pixels,
    has_alpha)."""
    alph = None
    for tag, body in chunks:
        if tag == b"ALPH":
            alph = body
        elif tag == b"VP8 ":
            rgb = decode_vp8(body)
            if alph is None:
                return rgb, False
            a = decode_alpha(alph, rgb.shape[1], rgb.shape[0])
            return np.concatenate([rgb, a[:, :, None]], -1), True
        elif tag == b"VP8L":
            return decode_vp8l(body)
    raise ValueError("WebP: no image data")


def decode_webp(data: bytes) -> np.ndarray:
    """A WebP file's samples: (H, W, 3) RGB, or (H, W, 4) RGBA where the
    file carries alpha (as PIL opens it: RGBA when VP8X flags alpha or a
    VP8L header says it is used).  An animation gives its first frame on a
    canvas cleared to transparent black, as libwebp's WebPAnimDecoder
    composes a key frame."""
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    end = min(len(data), 8 + struct.unpack_from("<I", data, 4)[0])
    chunks = list(_chunks(data, 12, end))
    if not chunks:
        raise ValueError("WebP: no chunks")
    tag, body = chunks[0]
    if tag == b"VP8 ":
        return decode_vp8(body)
    if tag == b"VP8L":
        px, alpha = decode_vp8l(body)
        return px if alpha else px[:, :, :3]
    if tag != b"VP8X":
        raise ValueError(f"WebP: unknown first chunk {tag!r}")
    flags = body[0]
    cw = int.from_bytes(body[4:7], "little") + 1
    chh = int.from_bytes(body[7:10], "little") + 1
    has_alpha = bool(flags & 0x10)
    if flags & 0x02:                                    # animation
        anmf = next((b for t, b in chunks if t == b"ANMF"), None)
        if anmf is None:
            raise ValueError("WebP: animation without frames")
        fx = 2 * int.from_bytes(anmf[0:3], "little")
        fy = 2 * int.from_bytes(anmf[3:6], "little")
        px, _ = _frame(_chunks(anmf, 16, len(anmf)))
        canvas = np.zeros((chh, cw, 4), np.uint8)
        fh, fw = px.shape[:2]
        if fx + fw > cw or fy + fh > chh:
            raise ValueError("WebP: frame outside the canvas")
        canvas[fy:fy + fh, fx:fx + fw, :px.shape[2]] = px
        if px.shape[2] == 3:
            canvas[fy:fy + fh, fx:fx + fw, 3] = 255
        return canvas if has_alpha else canvas[:, :, :3]
    px, _ = _frame(chunks[1:])
    if px.shape[:2] != (chh, cw):
        raise ValueError("WebP: image size differs from the VP8X canvas")
    if has_alpha and px.shape[2] == 3:
        px = np.concatenate([px, np.full((chh, cw, 1), 255, np.uint8)], -1)
    return px if has_alpha else px[:, :, :3]
