"""Image encoders behind utils/image.py::write_png, numpy only: the files
PIL 12.1.0's Image.save writes for an 8-bit RGB image, chosen by the
path's extension as Image.save chooses (the reference's write_png ends in
PIL), byte for byte the same.

  - JPEG (.jpg .jpeg .jpe .jfif, and .mpo: PIL's one-frame MPO is the
    same file): baseline, as PIL's libjpeg-turbo writes under its
    defaults: a JFIF 1.01 APP0 (density 1:1), the Annex K tables scaled
    to quality 75, 4:2:0 (Y at 2x2), the Annex K.3 Huffman tables, no
    restart interval; RGB -> YCbCr by jccolor.c's fixed-point tables,
    h2v2 downsampling with jcsample.c's alternating bias, edges
    replicated out to whole blocks and jccoefct.c's dummy blocks (DC of
    the block before, AC 0) out to whole MCUs, the islow integer forward
    DCT (jfdctint.c) and jcdctmgr.c's reciprocal quantization.  All
    blocks at once; the Huffman stream too (symbols, codes and bits as
    arrays, packed by np.packbits);
  - BMP / DIB: 24-bit BI_RGB, bottom-up, rows padded to 4 bytes (a DIB
    without the 14-byte file header);
  - TGA: uncompressed 24-bit, bottom-up, with the TRUEVISION-XFILE footer;
  - TIFF: little-endian, uncompressed, one strip;
  - PPM: binary P6, whichever netpbm extension (.pfm included) names it;
  - PCX: version 5, three 8-bit planes, PcxEncode.c's run-length code;
  - SGI: verbatim, channel planes bottom-up, the file's stem as the name;
  - IM: PIL's text header (the file's name in it), planar rows bottom-up;
  - DDS: uncompressed 24-bit BGR with PIL's header and masks;
  - QOI: PIL's encoder, whose index starts empty (not write_qoi's);
  - EPS (.eps, .ps): EpsEncode.c's hex lines under PIL's header;
  - PDF: one page, the image a DCTDecode stream of encode_jpeg's bytes,
    dated time.gmtime() at the call as PIL dates it;
  - GIF: utils/gif_write.py (Quant.c's median cut, GifEncode.c's LZW);
  - JPEG 2000 (.jp2 .j2k .jpc .jpf .jpx .j2c): utils/jpeg2000_write.py
    (lossless 5/3; a raw codestream for .j2k only, JP2 for the others);
  - WebP: utils/webp_write.py (libwebp 1.6.0's lossy VP8 at quality 80,
    method 4; its macroblock loop in native/vp8_enc.cpp, built by g++ on
    first use, without which writing .webp raises);
  - PNG: encode_png (PIL's filter choice and deflate settings; the bytes
    PIL's where the zlib is PIL's);
  - ICO and ICNS: PIL's directories over PNG entries (encode_png's) of
    the image resized as PIL resizes it (utils/resample.py).

encode(path, px) returns the file's bytes or raises what PIL raises for
the extension: ValueError for an unknown or missing one, KeyError for a
format PIL only reads, OSError / ValueError (PIL's words) where PIL
refuses RGB or lacks the handler, and ValueError naming the format where
PIL writes it and this module does not yet (AVIF).
"""
from __future__ import annotations

import os
import struct

import numpy as np


def _slots(counts: np.ndarray):
    """For tokens of counts[i] output units (bytes or bits) each, in
    order: each output unit's token and its place within the token."""
    owner = np.repeat(np.arange(len(counts)), counts)
    return owner, np.arange(owner.size) - (np.cumsum(counts) - counts)[owner]


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

# zigzag position -> natural (row-major) index
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# the Annex K.1 tables, natural order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)

# the Annex K.3 Huffman tables as DHT bodies: class / id, 16 counts, values
_DHT = [bytes.fromhex(h) for h in (
    "00" "00010501010101010100000000000000" "000102030405060708090a0b",
    "10" "0002010303020403050504040000017d"
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa",
    "01" "00030101010101010101010000000000" "000102030405060708090a0b",
    "11" "00020102040403040705040400010277"
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")]


def _huffman_codes(dht: bytes):
    """(code, length) arrays indexed by symbol, of a DHT body (Annex C)."""
    counts = dht[1:17]
    symbols = dht[17:]
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def quality_table(base: np.ndarray) -> np.ndarray:
    """An Annex K table scaled to libjpeg's default quality 75
    (jpeg_quality_scaling: 200 - 2 * 75 = 50 percent), natural order,
    clamped to 1..255 (force_baseline)."""
    return np.clip((base * 50 + 50) // 100, 1, 255)


def _fix(x):
    return int(x * 65536 + 0.5)


def rgb_to_ycc(px: np.ndarray):
    """jccolor.c's RGB -> YCbCr of uint8 px (..., 3): three int64 planes."""
    r, g, b = (px[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + off
          + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + off
          + half - 1) >> 16
    return y, cb, cr


def _pad(plane, h, w):
    """plane edge-replicated out to (h, w)."""
    return np.pad(plane, ((0, h - plane.shape[0]), (0, w - plane.shape[1])),
                  mode="edge")


def downsample_h2v2(plane: np.ndarray) -> np.ndarray:
    """jcsample.c's h2v2_downsample: each 2x2 sum plus a bias alternating
    1, 2, 1, ... along each output row, shifted right by 2."""
    s = plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2] \
        + plane[1::2, 1::2]
    bias = 1 + (np.arange(s.shape[1]) & 1)
    return (s + bias) >> 2


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _fdct_pass(d, shift_even, shift_odd):
    """One 1-D pass of jfdctint.c along the last axis of d (..., 8), int64;
    the DC and the 4th output shifted by shift_even (a left shift where it
    is negative), the rest descaled by shift_odd."""
    t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    out = np.empty_like(d)
    if shift_even < 0:
        out[..., 0] = (t10 + t11) << -shift_even
        out[..., 4] = (t10 - t11) << -shift_even
    else:
        out[..., 0] = _descale(t10 + t11, shift_even)
        out[..., 4] = _descale(t10 - t11, shift_even)
    z1 = (t12 + t13) * 4433
    out[..., 2] = _descale(z1 + t13 * 6270, shift_odd)
    out[..., 6] = _descale(z1 - t12 * 15137, shift_odd)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * 9633
    t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    out[..., 7] = _descale(t4 + z1 + z3, shift_odd)
    out[..., 5] = _descale(t5 + z2 + z4, shift_odd)
    out[..., 3] = _descale(t6 + z2 + z3, shift_odd)
    out[..., 1] = _descale(t7 + z1 + z4, shift_odd)
    return out


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """jfdctint.c's jpeg_fdct_islow of level-shifted blocks (..., 8, 8)
    int64: rows (scaled by 4), then columns; the result is the DCT
    scaled by 8, as jcdctmgr.c divides it."""
    rows = _fdct_pass(blocks, -2, 13 - 2)
    cols = _fdct_pass(np.swapaxes(rows, -1, -2), 2, 13 + 2)
    return np.swapaxes(cols, -1, -2)


def quantize(coef: np.ndarray, table: np.ndarray) -> np.ndarray:
    """jcdctmgr.c's quantization of fdct_islow output (..., 64) by the
    natural-order table: each divisor q << 3 by its reciprocal,
    correction and shift (compute_reciprocal), the sign kept apart."""
    div = table.astype(np.int64) << 3
    b = np.floor(np.log2(div)).astype(np.int64)
    r = 16 + b
    fq = (np.int64(1) << r) // div
    fr = (np.int64(1) << r) % div
    c = div // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, fq)
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= div // 2), c + 1, c)
    fq = np.where(~pow2 & (fr > div // 2), fq + 1, fq)
    mag = ((np.abs(coef) + c) * fq) >> r
    return np.where(coef < 0, -mag, mag)


def _component_blocks(plane, bh, bw):
    """Quantizable blocks (bh, bw, 8, 8) of a plane padded to whole blocks,
    level-shifted."""
    return (plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128)


def _zigzag_coefficients(px: np.ndarray):
    """The quantized zigzag coefficients (n, 64) of every block in entropy
    order (MCU by MCU: Y 2x2, Cb, Cr) and each block's component (n,)."""
    h, w = px.shape[:2]
    y, cb, cr = rgb_to_ycc(px)
    mh, mw = -(-h // 16), -(-w // 16)             # MCUs down, across
    yh, yw = -(-h // 8), -(-w // 8)               # Y blocks with pixels
    qy, qc = quality_table(_Q_LUMA), quality_table(_Q_CHROMA)
    ycoef = quantize(fdct_islow(_component_blocks(
        _pad(y, 8 * yh, 8 * yw), yh, yw)).reshape(yh, yw, 64), qy)
    full = np.zeros((2 * mh, 2 * mw, 64), np.int64)
    full[:yh, :yw] = ycoef
    if yw % 2:              # a dummy column: DC of the block to its left
        full[:yh, yw, 0] = ycoef[:, yw - 1, 0]
    if yh % 2:              # a dummy row: DC of the MCU's upper right block
        full[yh, :, 0] = np.repeat(full[yh - 1, 1::2, 0], 2)
    # chroma: rows padded to a pair, columns to whole MCUs, then the
    # downsampled rows padded to whole blocks (jcprepct.c pads twice)
    chroma = [quantize(fdct_islow(_component_blocks(_pad(downsample_h2v2(
        _pad(c, h + (h & 1), 16 * mw)), 8 * mh, 8 * mw), mh, mw)).reshape(
            mh, mw, 64), qc) for c in (cb, cr)]
    mcu = np.concatenate([
        full.reshape(mh, 2, mw, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
            mh, mw, 4, 64),
        chroma[0][:, :, None], chroma[1][:, :, None]], axis=2)
    zz = mcu.reshape(-1, 64)[:, _ZIGZAG]
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mh * mw)
    return zz, comp


def _bit_size(v):
    """The JPEG magnitude category (bit length of |v|) of int64 v."""
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    while True:
        nz = a > 0
        if not nz.any():
            return n
        n += nz
        a >>= 1


def _extra_bits(v, size):
    """The appended bits of v in its category: v, or v - 1 when negative,
    masked to size bits."""
    return np.where(v < 0, v - 1, v) & ((np.int64(1) << size) - 1)


def _huffman_stream(zz: np.ndarray, comp: np.ndarray) -> bytes:
    """The entropy-coded segment of the blocks zz (n, 64) in order, each
    coded with its component's tables (0 luma, else chroma): DC
    differences per component, AC runs with ZRL and EOB, padded with
    one bits and 0xFF bytes stuffed with 0x00.  Every code word is made
    at once, ordered by (block, position) keys, and packed to bits."""
    n = len(zz)
    tab = (comp > 0).astype(np.int64)
    dc_codes, ac_codes = ([np.stack(t) for t in zip(*(
        _huffman_codes(_DHT[i]) for i in pair))] for pair in ((0, 2), (1, 3)))
    keys, words, lengths = [], [], []

    def emit(key, codes, t, sym, value=0, size=0):
        keys.append(key)
        words.append((codes[0][t, sym] << size) | value)
        lengths.append(codes[1][t, sym] + size)

    diff = np.empty(n, np.int64)
    for c in np.unique(comp):
        sel = np.flatnonzero(comp == c)
        diff[sel] = np.diff(zz[sel, 0], prepend=0)
    size = _bit_size(diff)
    emit(np.arange(n) * 260, dc_codes, tab, size, _extra_bits(diff, size),
         size)
    bi, ki = np.nonzero(zz[:, 1:])
    k = ki + 1
    v = zz[bi, k]
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    run = k - np.where(first, 0, np.concatenate([[0], k[:-1]])) - 1
    for j in range(3):                  # a ZRL for each 16 zeros skipped
        z = np.flatnonzero(run >= 16 * (j + 1))
        emit(bi[z] * 260 + k[z] * 4 + j, ac_codes, tab[bi[z]], 0xF0)
    vs = _bit_size(v)
    emit(bi * 260 + k * 4 + 3, ac_codes, tab[bi], ((run & 15) << 4) | vs,
         _extra_bits(v, vs), vs)
    last = np.zeros(n, np.int64)        # each block's last nonzero
    end = np.append(bi[1:] != bi[:-1], True)[:len(bi)]
    last[bi[end]] = k[end]
    eob = np.flatnonzero(last < 63)
    emit(eob * 260 + 259, ac_codes, tab[eob], 0)
    order = np.argsort(np.concatenate(keys), kind="stable")
    word = np.concatenate(words)[order]
    length = np.concatenate(lengths)[order]
    owner, pos = _slots(length)
    bits = ((word[owner] >> (length[owner] - 1 - pos)) & 1).astype(np.uint8)
    out = np.packbits(np.concatenate([bits, np.ones(-len(bits) % 8,
                                                    np.uint8)]))
    return np.insert(out, np.flatnonzero(out == 0xFF) + 1, 0).tobytes()


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def encode_jpeg(px: np.ndarray) -> bytes:
    """A baseline JPEG of uint8 RGB px (H, W, 3), byte for byte what PIL
    12.1.0 (libjpeg-turbo 3.1.3) writes for Image.save(path.jpg) at
    quality 75 (see the module docstring)."""
    px = np.asarray(px, np.uint8)
    h, w = px.shape[:2]
    zz, comp = _zigzag_coefficients(px)
    dqt = b"".join(_segment(0xDB, bytes([i]) + bytes(
        quality_table(t)[_ZIGZAG].astype(np.uint8)))
        for i, t in enumerate((_Q_LUMA, _Q_CHROMA)))
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes(
        [1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (b"\xff\xd8"
            + _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + dqt + _segment(0xC0, sof)
            + b"".join(_segment(0xC4, t) for t in _DHT)
            + _segment(0xDA, sos) + _huffman_stream(zz, comp) + b"\xff\xd9")


# ---------------------------------------------------------------------------
# uncompressed and run-length formats
# ---------------------------------------------------------------------------


def encode_bmp(px: np.ndarray, file_header: bool = True) -> bytes:
    """PIL's 24-bit BMP (a DIB without the file header): BGR rows
    bottom-up, each padded to 4 bytes, 96 dpi (3780 pixels per metre)."""
    h, w = px.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = px[::-1, :, ::-1].reshape(h, 3 * w)
    info = struct.pack("<IIIHHIIIIII", 40, w, h, 1, 24, 0, stride * h, 3780,
                       3780, 0, 0)
    head = b""
    if file_header:
        head = b"BM" + struct.pack("<III", 54 + stride * h, 0, 54)
    return head + info + rows.tobytes()


def encode_tga(px: np.ndarray) -> bytes:
    """PIL's uncompressed 24-bit TGA: BGR rows bottom-up and the version 2
    footer."""
    h, w = px.shape[:2]
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 24, 0)
    return (head + np.ascontiguousarray(px[::-1, :, ::-1]).tobytes()
            + b"\0" * 8 + b"TRUEVISION-XFILE.\0")


def encode_tiff(px: np.ndarray) -> bytes:
    """PIL's uncompressed little-endian RGB TIFF: the IFD at 8, its ten
    tags, BitsPerSample's three values, then one strip of the samples."""
    h, w = px.shape[:2]
    n = w * h * 3
    data_at = 8 + 2 + 10 * 12 + 4 + 6
    entries = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 3, data_at - 6),
               (259, 3, 1, 1), (262, 3, 1, 2), (273, 4, 1, data_at),
               (277, 3, 1, 3), (278, 4, 1, h), (279, 4, 1, n), (284, 3, 1, 1)]
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHI", tag, typ, cnt)
        + (struct.pack("<HH", val, 0) if typ == 3 and cnt == 1
           else struct.pack("<I", val)) for tag, typ, cnt, val in entries)
    return (b"II*\0" + struct.pack("<I", 8) + ifd + b"\0" * 4
            + struct.pack("<HHH", 8, 8, 8)
            + np.ascontiguousarray(px).tobytes())


def encode_ppm(px: np.ndarray) -> bytes:
    """PIL's binary P6 with maxval 255."""
    h, w = px.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(px).tobytes()


def encode_pcx(px: np.ndarray) -> bytes:
    """PIL's PCX of RGB px: version 5, 100 dpi, three 8-bit planes of an
    even stride per row, run-length coded as PcxEncode.c codes them: runs
    of one plane row cut into pieces of 63, a piece of one byte below 0xC0
    stored bare, any other piece as 0xC0 | count and the byte; a pad byte
    (0) after each plane row of odd width.  At width 1 the encoder stops
    each row after its second plane, and so does this."""
    h, w = px.shape[:2]
    stride = w + (w & 1)
    head = (struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, w - 1, h - 1, 100,
                        100) + b"\0" * 24 + b"\xff" * 24
            + struct.pack("<BBHHHH", 0, 3, stride, 1, w, h) + b"\0" * 54)
    planes = px.transpose(0, 2, 1)
    if w == 1:          # PcxEncode.c ends a row of width 1 after 2 planes
        planes = planes[:, :2]
    flat = np.ascontiguousarray(planes).reshape(-1)
    start = np.ones(flat.size, bool)
    start[1:] = flat[1:] != flat[:-1]
    start[::w] = True                           # runs end with the row
    first = np.flatnonzero(start)
    length = np.diff(np.append(first, flat.size))
    value = flat[first]
    full, rem = length // 63, length % 63
    bare = (rem == 1) & (value < 0xC0)
    # each run: `full` pairs (0xFF, v), then a bare byte or a pair
    counts = 2 * full + np.where(rem == 0, 0, np.where(bare, 1, 2))
    run, pos = _slots(counts)
    in_full = pos < 2 * full[run]
    is_count = np.where(in_full, pos % 2 == 0,
                        (pos == 2 * full[run]) & ~bare[run])
    out = np.where(is_count, np.where(in_full, 0xFF, 0xC0 | rem[run]),
                   value[run]).astype(np.uint8)
    if w & 1:                   # a pad byte after each plane row
        row = first // w
        row_last = np.flatnonzero(np.append(row[1:] != row[:-1], True))
        out = np.insert(out, np.cumsum(counts)[row_last], 0)
    return head + out.tobytes()


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def encode_sgi(px: np.ndarray, path: str) -> bytes:
    """PIL's verbatim 8-bit SGI: the 512-byte header (the name the file's
    stem, ASCII, at most 79 characters), then each channel's rows
    bottom-up."""
    h, w = px.shape[:2]
    name = _stem(path).encode("ascii", "ignore")[:79]
    head = (struct.pack(">hBBHHHHll", 474, 0, 1, 3, w, h, 3, 0, 255)
            + b"\0" * 4 + name.ljust(80, b"\0") + struct.pack(">l", 0)
            + b"\0" * 404)
    return head + np.ascontiguousarray(
        px[::-1].transpose(2, 0, 1)).tobytes()


def encode_im(px: np.ndarray, path: str) -> bytes:
    """PIL's RGB IM file: the text header (the file's name, its stem cut
    to leave 92 characters with the extension), NULs to byte 511 and
    0x1A, then each row bottom-up as its three planes."""
    h, w = px.shape[:2]
    head = b"Image type: RGB image\r\n"
    base = os.path.basename(path)
    if base:
        stem, ext = os.path.splitext(base)
        head += f"Name: {stem[:92 - len(ext)]}{ext}\r\n".encode("ascii")
    head += (f"Image size (x*y): {w}*{h}\r\n"
             f"File size (no of images): 1\r\n").encode("ascii")
    head += b"\0" * (511 - len(head)) + b"\x1a"
    return head + np.ascontiguousarray(px[::-1].transpose(0, 2, 1)).tobytes()


def encode_dds(px: np.ndarray) -> bytes:
    """PIL's uncompressed DDS of RGB px: 24-bit BGR, its masks, pitch
    3 * W."""
    h, w = px.shape[:2]
    head = (b"DDS " + struct.pack("<7I", 124, 0x100F, h, w, 3 * w, 0, 0)
            + b"\0" * 44 + struct.pack("<4I", 32, 0x40, 0, 24)
            + struct.pack("<4I", 0xFF0000, 0xFF00, 0xFF, 0)
            + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    return head + np.ascontiguousarray(px[:, :, ::-1]).tobytes()


def encode_qoi(px: np.ndarray) -> bytes:
    """PIL's QOI of RGB px (colorspace 1), whole arrays at a time.  PIL's
    encoder starts its index empty but for (0, 0, 0, 0) in slot 0, which
    no opaque pixel matches, and the previous pixel opaque black; a
    pixel equal to the previous one extends a run (cut at 62), else it is
    an INDEX op where the last earlier pixel of its hash (one of a
    leading run of opaque black excepted: runs store nothing) equals it,
    else DIFF, LUMA or RGB against the previous pixel."""
    h, w = px.shape[:2]
    p = px.reshape(-1, 3).astype(np.int64)
    n = len(p)
    prev = np.concatenate([[[0, 0, 0]], p[:-1]])
    same = (p == prev).all(1)
    word = (p[:, 0] << 16) | (p[:, 1] << 8) | p[:, 2]
    hsh = (p[:, 0] * 3 + p[:, 1] * 5 + p[:, 2] * 7 + 255 * 11) % 64
    lead = int(np.argmin(same)) if not same.all() else n
    order = np.lexsort((np.arange(n), hsh))     # by hash, then position
    before = np.full(n, -1)
    grp = hsh[order]
    link = np.flatnonzero(grp[1:] == grp[:-1])
    before[order[link + 1]] = order[link]
    hit = (before >= lead) & (word[np.maximum(before, 0)] == word)
    d = ((p - prev + 128) & 255) - 128          # wrapped deltas
    dr, dg, db = d[:, 0], d[:, 1], d[:, 2]
    small = (d >= -2).all(1) & (d < 2).all(1)
    dgr = ((dr - dg + 128) & 255) - 128
    dgb = ((db - dg + 128) & 255) - 128
    luma = (dgr >= -8) & (dgr < 8) & (dg >= -32) & (dg < 32) & \
        (dgb >= -8) & (dgb < 8)
    op = np.where(same, 0, np.where(hit, 1, np.where(small, 2, np.where(
        luma, 3, 4))))
    # runs: each maximal stretch of `same` pixels, its bytes (pieces of
    # at most 62) before the next pixel's (or at the end)
    edge = np.diff(np.concatenate([[0], same.astype(np.int8), [0]]))
    r0, r1 = np.flatnonzero(edge == 1), np.flatnonzero(edge == -1)
    rlen = r1 - r0
    # tokens: each pixel (2 i + 1) and each run (before its end pixel, 2 r1)
    order = np.argsort(np.concatenate([np.arange(n) * 2 + 1, r1 * 2]),
                       kind="stable")
    counts = np.concatenate([np.array([0, 1, 1, 2, 4])[op],
                             -(-rlen // 62)])[order]
    tok, pos = _slots(counts)
    tok = order[tok]
    isrun = tok >= n
    ri = tok[isrun] - n
    piece = np.minimum(rlen[ri] - 62 * pos[isrun], 62)
    out = np.zeros(tok.size, np.int64)
    out[isrun] = 0xC0 | (piece - 1)
    pi, pp = tok[~isrun], pos[~isrun]
    o = op[pi]
    out[~isrun] = np.select(
        [o == 1, o == 2, (o == 3) & (pp == 0), o == 3, pp == 0, pp == 1,
         pp == 2],
        [hsh[pi],
         0x40 | ((dr[pi] + 2) << 4) | ((dg[pi] + 2) << 2) | (db[pi] + 2),
         0x80 | (dg[pi] + 32),
         ((dgr[pi] + 8) << 4) | (dgb[pi] + 8),
         0xFE, p[pi, 0], p[pi, 1]], p[pi, 2])
    return (b"qoif" + struct.pack(">IIBB", w, h, 3, 1)
            + out.astype(np.uint8).tobytes() + b"\0" * 7 + b"\x01")


# ---------------------------------------------------------------------------
# EPS and PDF
# ---------------------------------------------------------------------------


def encode_eps(px: np.ndarray) -> bytes:
    """PIL's EPS of RGB px (EpsImagePlugin._save): the EPSF-3.0 header (its
    ImageData comment behind a single '%', as PIL formats it) and a
    `false 3 colorimage` procedure, then the samples as lower-case hex
    as EpsEncode.c writes them: a newline after every 39 samples, across
    rows, none after the last; then the trailer (its EndBinary behind four
    '%', unformatted in PIL)."""
    h, w = px.shape[:2]
    head = (b"%!PS-Adobe-3.0 EPSF-3.0\n%%Creator: PIL 0.1 EpsEncode\n"
            + b"%%%%BoundingBox: 0 0 %d %d\n" % (w, h)
            + b"%%Pages: 1\n%%EndComments\n%%Page: 1 1\n"
            + b"%%ImageData: %d %d " % (w, h)     # one '%', as PIL's
            + b'8 3 0 1 1 "false 3 colorimage"\n'
            + b"gsave\n10 dict begin\n/buf %d string def\n" % (3 * w)
            + b"%d %d scale\n%d %d 8\n" % (w, h, w, h)
            + b"[%d 0 0 -%d 0 %d]\n" % (w, h, h)
            + b"{ currentfile buf readhexstring pop } bind\n"
            + b"false 3 colorimage\n")
    hexed = np.ascontiguousarray(px).tobytes().hex().encode("ascii")
    body = b"\n".join(hexed[i:i + 78] for i in range(0, len(hexed), 78))
    return head + body + b"\n%%%%EndBinary\ngrestore end\n"


def _pdf_string(s: str) -> bytes:
    """PdfParser's literal of a text string: UTF-16BE behind its byte-order
    mark, backslashes and parentheses escaped."""
    b = b"\xfe\xff" + s.encode("utf_16_be")
    return b"(" + b.replace(b"\\", b"\\\\").replace(b"(", b"\\(").replace(
        b")", b"\\)") + b")"


def encode_pdf(px: np.ndarray, path: str) -> bytes:
    """PIL's one-page PDF of RGB px (PdfImagePlugin._save at 72 dpi):
    objects 4 (catalog), 5 (pages), 1 (the image, a DCTDecode XObject of
    encode_jpeg's bytes), 2 (the page), 3 (its contents) and 6 (the
    information: the file's stem as title, unless empty, and the creation
    and modification dates, both time.gmtime() at the call, as PIL stamps
    them), then the cross-reference table and the trailer."""
    import time

    h, w = px.shape[:2]
    stamp = b"(D:" + time.strftime("%Y%m%d%H%M%SZ", time.gmtime()).encode(
        "ascii") + b")"
    jpeg = encode_jpeg(px)
    size = b"%r %r" % (float(w), float(h))
    contents = b"q %f 0 0 %f 0 0 cm /image Do Q\n" % (w, h)
    title = _stem(path)
    info = ((b"\n/Title " + _pdf_string(title)) if title else b"") + (
        b"\n/CreationDate " + stamp + b"\n/ModDate " + stamp)

    def obj(n, body, stream=None):
        out = b"%d 0 obj<<" % n + body
        if stream is None:
            return out + b"\n>>endobj\n"
        return (out + b"\n/Length %d\n>>stream\n" % len(stream) + stream
                + b"\nendstream\nendobj\n")

    objs = [
        (4, obj(4, b"\n/Type /Catalog\n/Pages 5 0 R")),
        (5, obj(5, b"\n/Type /Pages\n/Count 1\n/Kids [ 2 0 R ]")),
        (1, obj(1, b"\n/Type /XObject\n/Subtype /Image\n/Width %d\n/Height %d"
                b"\n/Filter /DCTDecode\n/BitsPerComponent 8\n"
                b"/ColorSpace /DeviceRGB" % (w, h), jpeg)),
        (2, obj(2, b"\n/Resources <<\n/ProcSet [ /PDF /ImageC ]\n/XObject <<"
                b"\n/image 1 0 R\n>>\n>>\n/MediaBox [ 0 0 " + size
                + b" ]\n/Contents 3 0 R\n/Type /Page\n/Parent 5 0 R")),
        (3, obj(3, b"", contents)),
        (6, obj(6, info)),
    ]
    out = b"%PDF-1.4\n% created by Pillow PDF driver\n"
    at = {}
    for n, body in objs:
        at[n] = len(out)
        out += body
    xref = b"xref\n0 7\n0000000000 65536 f \n" + b"".join(
        b"%010d 00000 n \n" % at[n] for n in range(1, 7))
    return (out + xref + b"trailer\n<<\n/Root 4 0 R\n/Size 7\n/Info 6 0 R\n>>"
            + b"\nstartxref\n%d\n%%%%EOF" % len(out))


# ---------------------------------------------------------------------------
# ICO and ICNS: resized copies, each a PNG
# ---------------------------------------------------------------------------

ICO_SIZES = (16, 24, 32, 48, 64, 128, 256)
# ICNS entry types and their square sizes, in the order PIL writes them
ICNS_SIZES = ((b"ic07", 128), (b"ic08", 256), (b"ic09", 512),
              (b"ic10", 1024), (b"ic11", 32), (b"ic12", 64), (b"ic13", 256),
              (b"ic14", 512))


def encode_ico(px: np.ndarray) -> bytes:
    """PIL's ICO of RGB px (IcoImagePlugin._save): for each of ICO_SIZES
    no larger than the image on either side, the image fitted into that
    square keeping its aspect (resample.thumbnail, LANCZOS); the header,
    one 16-byte entry per such frame (width and height, 256 stored as 0;
    no palette; 32 bits per pixel, as PIL states it; size and offset),
    then each frame as a PNG (encode_png).  An image under 16 pixels on a
    side gets no entry: the 6-byte file PIL writes, which PIL cannot
    open."""
    from .image import encode_png
    from .resample import thumbnail

    h, w = px.shape[:2]
    frames = [thumbnail(px, (s, s)) for s in ICO_SIZES if s <= w and s <= h]
    pngs = [encode_png(f) for f in frames]
    head = b"\0\0\1\0" + struct.pack("<H", len(frames))
    at = len(head) + 16 * len(frames)
    for f, png in zip(frames, pngs):
        fh, fw = f.shape[:2]
        head += struct.pack("<BBBBHHII", fw % 256, fh % 256, 0, 0, 0, 32,
                            len(png), at)
        at += len(png)
    return head + b"".join(pngs)


def encode_icns(px: np.ndarray) -> bytes:
    """PIL's ICNS of RGB px (IcnsImagePlugin._save): the header, the table
    of contents of the entries ic07 ... ic14 in that order, then the
    entries, each the PNG (encode_png) of px resized to its square size
    (resample.resize, BICUBIC), whatever px's aspect."""
    from .image import encode_png
    from .resample import resize

    streams = {s: encode_png(resize(px, (s, s)))
               for s in {s for _, s in ICNS_SIZES}}
    entries = [(kind, streams[s]) for kind, s in ICNS_SIZES]
    toc = b"TOC " + struct.pack(">i", 8 + 8 * len(entries)) + b"".join(
        kind + struct.pack(">i", 8 + len(st)) for kind, st in entries)
    body = b"".join(kind + struct.pack(">i", 8 + len(st)) + st
                    for kind, st in entries)
    return b"icns" + struct.pack(">i", 8 + len(toc) + len(body)) + toc + body


# ---------------------------------------------------------------------------
# the extension table of PIL 12.1.0's Image.save, for an RGB image
# ---------------------------------------------------------------------------

def _png(px, path):
    from .image import encode_png

    return encode_png(px)


def _gif(px):
    from .gif_write import encode_gif

    return encode_gif(px)


def _jpeg2000(px, path):
    from .jpeg2000_write import encode_jpeg2000

    return encode_jpeg2000(px, path)


def _webp(px):
    from .webp_write import encode_webp

    return encode_webp(px)


WRITERS = {
    "PNG": _png,
    "JPEG": lambda px, path: encode_jpeg(px),
    "MPO": lambda px, path: encode_jpeg(px),
    "BMP": lambda px, path: encode_bmp(px),
    "DIB": lambda px, path: encode_bmp(px, file_header=False),
    "TGA": lambda px, path: encode_tga(px),
    "TIFF": lambda px, path: encode_tiff(px),
    "PPM": lambda px, path: encode_ppm(px),
    "PCX": lambda px, path: encode_pcx(px),
    "SGI": encode_sgi,
    "IM": encode_im,
    "DDS": lambda px, path: encode_dds(px),
    "QOI": lambda px, path: encode_qoi(px),
    "EPS": lambda px, path: encode_eps(px),
    "PDF": encode_pdf,
    "GIF": lambda px, path: _gif(px),
    "JPEG2000": lambda px, path: _jpeg2000(px, path),
    "ICO": lambda px, path: encode_ico(px),
    "ICNS": lambda px, path: encode_icns(px),
    "WEBP": lambda px, path: _webp(px),
}

# format of each extension PIL registers
EXTENSIONS = {
    ".png": "PNG", ".apng": "PNG",
    ".jpg": "JPEG", ".jpeg": "JPEG", ".jpe": "JPEG", ".jfif": "JPEG",
    ".mpo": "MPO",
    ".bmp": "BMP", ".dib": "DIB",
    ".tga": "TGA", ".icb": "TGA", ".vda": "TGA", ".vst": "TGA",
    ".tif": "TIFF", ".tiff": "TIFF",
    ".pbm": "PPM", ".pgm": "PPM", ".ppm": "PPM", ".pnm": "PPM",
    ".pfm": "PPM",
    ".pcx": "PCX",
    ".sgi": "SGI", ".rgb": "SGI", ".rgba": "SGI", ".bw": "SGI",
    ".im": "IM",
    ".dds": "DDS",
    ".qoi": "QOI",
    ".gif": "GIF",
    ".jp2": "JPEG2000", ".j2k": "JPEG2000", ".jpc": "JPEG2000",
    ".jpf": "JPEG2000", ".jpx": "JPEG2000", ".j2c": "JPEG2000",
    ".ico": "ICO", ".icns": "ICNS", ".eps": "EPS", ".ps": "EPS",
    ".pdf": "PDF",
    ".webp": "WEBP",
    # written by PIL, not yet here
    ".avif": "AVIF", ".avifs": "AVIF",
    # PIL refuses an RGB image
    ".blp": "BLP", ".msp": "MSP", ".palm": "PALM", ".xbm": "XBM",
    # PIL has no handler installed
    ".bufr": "BUFR", ".grib": "GRIB", ".h5": "HDF5", ".hdf": "HDF5",
    ".wmf": "WMF", ".emf": "WMF",
    # PIL reads these and has no writer
    ".cur": "CUR", ".dcx": "DCX", ".fit": "FITS", ".fits": "FITS",
    ".flc": "FLI", ".fli": "FLI", ".ftc": "FTEX", ".ftu": "FTEX",
    ".gbr": "GBR", ".iim": "IPTC", ".mpeg": "MPEG", ".mpg": "MPEG",
    ".pcd": "PCD", ".psd": "PSD", ".pxr": "PIXAR", ".ras": "SUN",
    ".xpm": "XPM",
}

# formats PIL writes and this module does not yet, in the order they are
# queued
NOT_YET = ("AVIF",)
_REFUSED = {"BLP": (ValueError, "Unsupported BLP image mode"),
            "MSP": (OSError, "cannot write mode RGB as MSP"),
            "PALM": (OSError, "cannot write mode RGB as Palm"),
            "XBM": (OSError, "cannot write mode RGB as XBM")}
_NO_HANDLER = ("BUFR", "GRIB", "HDF5", "WMF")


def format_of(path: str) -> str:
    """The format PIL's Image.save picks for path by its lower-cased
    extension; raises ValueError for an unknown or missing one, as PIL
    does."""
    ext = os.path.splitext(os.fspath(path))[1].lower()
    if ext not in EXTENSIONS:
        raise ValueError(f"unknown file extension: {ext}")
    return EXTENSIONS[ext]


def encode(path: str, px: np.ndarray) -> bytes:
    """The bytes PIL writes for the uint8 RGB image px (H, W, 3) saved to
    path, or the exception PIL raises (see the module docstring)."""
    fmt = format_of(path)
    if fmt in WRITERS:
        return WRITERS[fmt](np.ascontiguousarray(px, np.uint8),
                            os.fspath(path))
    if fmt in NOT_YET:
        raise ValueError(f"{path}: writing {fmt} images is not ported yet "
                         "(the reference writes them through PIL)")
    if fmt in _REFUSED:
        kind, words = _REFUSED[fmt]
        raise kind(words)
    if fmt in _NO_HANDLER:
        raise OSError(f"{fmt} save handler not installed")
    raise KeyError(fmt)
