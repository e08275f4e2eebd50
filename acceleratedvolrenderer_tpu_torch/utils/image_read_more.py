"""Decoders of XBM, MSP, SPIDER, BLP, SUN raster and XPM, numpy only: the
samples PIL 12.1.0 gives for each file (the reference reads images
through PIL), as colours where PIL gives palette indices or booleans, and
a float image as stored.  The dispatch by magic bytes (SPIDER by its
header's values) is image.py::_decode_image's, in PIL's order of plugins.

  - XBM (XbmImagePlugin, XbmDecode.c): the `#define` width / height (and
    hotspot) lines matched in the first 512 bytes, then the bits: each
    'x' starts a byte of the next two characters (any character not a
    hex digit counts 0), rows of (w + 7) // 8 bytes, LSB first, a set bit
    255;
  - MSP (MspImagePlugin): the 32-byte header whose 16 words XOR to 0;
    version 1 (DanM) raw rows, version 2 (LinS) a table of row lengths and
    runs (0, count, value) or literals (count, bytes), a row of length 0
    blank (0xFF); the rows' bytes as one stream, MSB first, a set bit 255;
  - SPIDER (SpiderImagePlugin): 27 float32 header words, big-endian if
    isSpiderHeader accepts them so, else little-endian; a 2D image
    (iform 1), alone or the first of a stack, float32 as stored;
  - BLP (BlpImagePlugin): BLP1 with a palette (encodings 4 and 5; the
    indices follow the palette) or JPEG (the shared header, then the
    first mip, decoded by image.py's decode_jpeg, YCCK taken as CMYK as
    PIL has libjpeg take it, its channels reversed as PIL's "BGR" rawmode
    reverses them); BLP2 with a
    palette or DXT1 / DXT3 / DXT5 blocks, decoded as PIL's Python
    decode_dxt1/3/5 decode them (565 endpoints shifted, not replicated;
    thirds and halves truncated) and laid out as PIL lays them out: whole
    blocks in rows of the padded width, read back at the image's width;
    alpha, where the header has it, from the palette or the blocks;
  - SUN raster (SunImagePlugin): depths 1 (a set bit 0), 4 and 8 (gray,
    or palette indices through a planar RGB map, which PIL cannot load
    at other depths), 24 and 32 (BGR / BGRX,
    RGB / RGBX for type 3); types 0, 1, 3, 4 and 5 raw in rows padded to
    16 bits, type 2 run-length coded (0x80 escapes; the stream cut into
    rows of the unpadded width, as PIL's sun_rle decoder cuts it);
  - XPM (XpmImagePlugin): the `"w h ncolors cpp` line, ncolors lines of
    `c #rrggbb` or `c None`, then the pixels' quoted strings, cpp
    characters per pixel, as one stream.

What PIL refuses raises ValueError naming the format and what is refused.
"""
from __future__ import annotations

import re
import struct

import numpy as np


def _rows_of(stream: np.ndarray, h: int, row_bytes: int, what: str):
    """The first h rows of row_bytes bytes of a decoded stream; raises as
    PIL's raw decoder does when the stream is short."""
    if stream.size < h * row_bytes:
        raise ValueError(f"{what}: not enough image data")
    return stream[:h * row_bytes].reshape(h, row_bytes)


def _bits(rows: np.ndarray, w: int, lsb_first=False, set_value=255):
    """(H, W, 1) uint8 of packed 1-bit rows: set_value where a bit is set,
    255 - set_value where clear."""
    bits = np.unpackbits(rows, axis=1,
                         bitorder="little" if lsb_first else "big")[:, :w]
    return np.where(bits == 1, set_value, 255 - set_value).astype(
        np.uint8)[..., None]


# ---------------------------------------------------------------------------
# XBM
# ---------------------------------------------------------------------------

_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")
_HEX = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"0123456789abcdef"):
    _HEX[_c] = _HEX[bytes([_c]).upper()[0]] = _i


def is_xbm(data: bytes) -> bool:
    """PIL's test: the first 16 bytes, leading white space stripped, start
    with #define."""
    return data[:16].lstrip().startswith(b"#define")


def decode_xbm(data: bytes) -> np.ndarray:
    """An XBM file's samples, (H, W, 1) uint8 0 / 255."""
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise ValueError("XBM: no width and height defines before _bits[] "
                         "in the first 512 bytes")
    w, h = int(m.group("width")), int(m.group("height"))
    stride = (w + 7) // 8
    buf = np.frombuffer(data, np.uint8)[m.end():]
    xs = np.flatnonzero(buf == ord("x"))
    if np.any(np.diff(xs) < 3):         # an 'x' among a byte's two digits
        keep, nxt = [], 0
        for x in xs.tolist():
            if x >= nxt:
                keep.append(x)
                nxt = x + 3
        xs = np.array(keep, np.int64)
    xs = xs[:h * stride]
    if xs.size < h * stride or xs[-1] + 2 >= buf.size:
        raise ValueError("XBM: image file is truncated")
    rows = ((_HEX[buf[xs + 1]] << 4) | _HEX[buf[xs + 2]]).reshape(h, stride)
    return _bits(rows, w, lsb_first=True)


# ---------------------------------------------------------------------------
# MSP
# ---------------------------------------------------------------------------


def decode_msp(data: bytes) -> np.ndarray:
    """A Windows Paint file's samples, (H, W, 1) uint8 0 / 255."""
    if len(data) < 32 or data[:4] not in (b"DanM", b"LinS"):
        raise ValueError("not an MSP file")
    if np.bitwise_xor.reduce(np.frombuffer(data[:32], "<u2")) != 0:
        raise ValueError("MSP: bad header checksum")
    w, h = struct.unpack_from("<HH", data, 4)
    stride = (w + 7) // 8
    if data[:4] == b"DanM":
        if len(data) < 32 + h * stride:
            raise ValueError("MSP: image file is truncated")
        rows = np.frombuffer(data, np.uint8, h * stride, 32).reshape(h, stride)
        return _bits(rows, w)
    if len(data) < 32 + 2 * h:
        raise ValueError("MSP: truncated file in row map")
    lengths = struct.unpack_from(f"<{h}H", data, 32)
    out, pos = bytearray(), 32 + 2 * h
    for y, n in enumerate(lengths):
        if n == 0:
            out += b"\xff" * stride
            continue
        row = data[pos:pos + n]
        if len(row) != n:
            raise ValueError(f"MSP: truncated file, row {y}")
        pos += n
        i = 0
        while i < n:
            if row[i] == 0:                     # run: 0, count, value
                if i + 2 >= n:
                    raise ValueError(f"MSP: corrupted run in row {y}")
                out += row[i + 2:i + 3] * row[i + 1]
                i += 3
            else:                               # literal: count, bytes
                out += row[i + 1:i + 1 + row[i]]
                i += 1 + row[i]
    stream = np.frombuffer(bytes(out), np.uint8)
    return _bits(_rows_of(stream, h, stride, "MSP"), w)


# ---------------------------------------------------------------------------
# SPIDER
# ---------------------------------------------------------------------------

_SPIDER_IFORMS = (1, 3, -11, -12, -21, -22)


def _is_int(f: float) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def _spider_header(t) -> int:
    """SpiderImagePlugin.isSpiderHeader: the header's byte length, or 0."""
    h = (99,) + tuple(t)
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in _SPIDER_IFORMS:
        return 0
    labbyt = int(h[22])
    return labbyt if labbyt == int(h[13]) * int(h[23]) else 0


def spider_header(data: bytes):
    """(byte order '>' or '<', the 27 header words, the header's length) of
    a SPIDER file, big-endian first as PIL tries; None if neither order
    gives a SPIDER header."""
    if len(data) < 108:
        return None
    for order in "><":
        t = struct.unpack_from(order + "27f", data)
        n = _spider_header(t)
        if n:
            return order, t, n
    return None


def decode_spider(data: bytes) -> np.ndarray:
    """A SPIDER 2D image's samples, (H, W, 1) float32 as stored; of a stack
    the first image, as PIL opens it."""
    head = spider_header(data)
    if head is None:
        raise ValueError("not a SPIDER file")
    order, t, hdrlen = head
    h = (99,) + t
    if int(h[5]) != 1:
        raise ValueError(f"SPIDER: not a 2D image (iform {int(h[5])})")
    w, ht = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = 2 * hdrlen                     # the stack's first image
    elif istack == 0 and imgnumber > 0:
        raise ValueError("SPIDER: an image header of a stack (image number "
                         f"{imgnumber}) is not read, as PIL reads none")
    else:
        raise ValueError("SPIDER: inconsistent stack header values")
    if w <= 0 or ht <= 0 or len(data) < offset + 4 * w * ht:
        raise ValueError("SPIDER: image file is truncated")
    px = np.frombuffer(data, order + "f4", w * ht, offset).reshape(ht, w, 1)
    return px.astype(np.float32)


# ---------------------------------------------------------------------------
# BLP
# ---------------------------------------------------------------------------


def _blp_palette_pixels(data, pos, length, palette, alpha, w, h):
    """_read_bgra: length index bytes at pos through the BGRA palette, as
    RGB (RGBA when alpha) rows of w."""
    idx = np.frombuffer(data, np.uint8, min(length, len(data) - pos), pos)
    if idx.size < length:
        raise ValueError("BLP: truncated file")
    px = palette[idx][:, [2, 1, 0, 3] if alpha else [2, 1, 0]]
    c = px.shape[1]
    return _rows_of(px.reshape(-1), h, w * c, "BLP").reshape(h, w, c)


def _unpack_565(c):
    c = c.astype(np.int64)
    return np.stack([((c >> 11) & 0x1F) << 3, ((c >> 5) & 0x3F) << 2,
                     (c & 0x1F) << 3], -1)


def _dxt_colours(block8, four):
    """Each block's 16 RGB colours (n, 16, 3) and whether the three-colour
    mode's transparent index picked it (n, 16), as decode_dxt1/3/5 make
    them; four forces the four-colour mode (DXT3, DXT5)."""
    c0 = block8[:, 0].astype(np.int64) | block8[:, 1].astype(np.int64) << 8
    c1 = block8[:, 2].astype(np.int64) | block8[:, 3].astype(np.int64) << 8
    p0, p1 = _unpack_565(c0), _unpack_565(c1)
    gt = ((c0 > c1) | four)[:, None]
    table = np.stack([p0, p1, np.where(gt, (2 * p0 + p1) // 3,
                                       (p0 + p1) // 2),
                      np.where(gt, (2 * p1 + p0) // 3, 0)], 1)
    code = block8[:, 4:8].copy().view("<u4")[:, 0].astype(np.int64)
    sel = (code[:, None] >> (2 * np.arange(16))) & 3
    colours = np.take_along_axis(table, sel[..., None], 1)
    return colours, (sel == 3) & ~gt


def _dxt3_alpha(block):
    a = block[:, :8].astype(np.int64)
    nib = np.stack([a & 0xF, a >> 4], -1).reshape(-1, 16)
    return nib * 17


def _dxt5_alpha(block):
    a0, a1 = block[:, 0:1].astype(np.int64), block[:, 1:2].astype(np.int64)
    bits = np.zeros(len(block), np.int64)
    for k in range(6):
        bits |= block[:, 2 + k].astype(np.int64) << (8 * k)
    c = (bits[:, None] >> (3 * np.arange(16))) & 7
    eight = ((8 - c) * a0 + (c - 1) * a1) // 7
    six = np.where(c == 6, 0, np.where(c == 7, 255,
                                       ((6 - c) * a0 + (c - 1) * a1) // 5))
    return np.where(c == 0, a0, np.where(c == 1, a1,
                                         np.where(a0 > a1, eight, six)))


def _blp_dxt(data, pos, kind, alpha, w, h):
    """BLP2's DXT mip 0 at pos, as PIL lays it out (module docstring)."""
    bw, bh = (w + 3) // 4, (h + 3) // 4
    size = 8 if kind == "DXT1" else 16
    n = bw * bh * size
    if len(data) < pos + n:
        raise ValueError("BLP: truncated file")
    block = np.frombuffer(data, np.uint8, n, pos).reshape(-1, size)
    if kind == "DXT1":
        rgb, clear = _dxt_colours(block, False)
        chans = [rgb, np.where(clear, 0, 255)[..., None]] if alpha else [rgb]
    else:
        rgb, _ = _dxt_colours(block[:, 8:], True)
        a = _dxt3_alpha(block) if kind == "DXT3" else _dxt5_alpha(block)
        chans = [rgb, a[..., None]]
    px = np.concatenate(chans, -1).astype(np.uint8)
    c = px.shape[-1]
    stream = px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(-1)
    mode_c = 4 if alpha else 3
    return _rows_of(stream, h, w * mode_c, "BLP").reshape(h, w, mode_c)


_BLP_DXT = {0: "DXT1", 1: "DXT3", 7: "DXT5"}


def decode_blp(data: bytes) -> np.ndarray:
    """A BLP file's first mip, (H, W, 3) RGB or (H, W, 4) RGBA where the
    header has alpha.  What PIL refuses (BLPFormatError) raises
    ValueError naming the compression or encoding."""
    from .image import decode_jpeg

    magic = data[:4]
    if magic not in (b"BLP1", b"BLP2"):
        raise ValueError("not a BLP file")
    if magic == b"BLP1":
        compression, alpha, w, h, encoding = struct.unpack_from("<iIIIi",
                                                                data, 4)
        alpha_encoding, start = None, 28
    else:
        compression, encoding, alpha, alpha_encoding = struct.unpack_from(
            "<ibbb", data, 4)
        w, h = struct.unpack_from("<II", data, 12)
        start = 20
    alpha = alpha != 0
    if len(data) < start + 128:
        raise ValueError("BLP: truncated file")
    offsets = struct.unpack_from("<16I", data, start)
    lengths = struct.unpack_from("<16I", data, start + 64)
    pos = start + 128

    def palette():
        if len(data) < pos + 1024:
            raise ValueError("BLP: truncated palette")
        return np.frombuffer(data, np.uint8, 1024, pos).reshape(256, 4)

    if magic == b"BLP1":
        if compression == 0:                    # JPEG
            (n,) = struct.unpack_from("<I", data, pos)
            header = data[pos + 4:pos + 4 + n]
            if offsets[0] < pos + 4 + n or len(data) < offsets[0] + lengths[0]:
                raise ValueError("BLP: truncated file")
            rgb = decode_jpeg(header + data[offsets[0]:offsets[0]
                                            + lengths[0]],
                              ycck_as_cmyk=True)
            if rgb.shape[2] == 1:
                rgb = np.repeat(rgb, 3, axis=2)
            rgb = _rows_of(rgb.reshape(-1), h, 3 * w, "BLP").reshape(h, w, 3)
            rgb = rgb[..., ::-1]                # PIL's "BGR" rawmode
            if alpha:
                rgb = np.concatenate(
                    [rgb, np.full((h, w, 1), 255, np.uint8)], -1)
            return np.ascontiguousarray(rgb)
        if compression != 1:
            raise ValueError(f"BLP: unsupported BLP1 compression "
                             f"{compression}")
        if encoding not in (4, 5):
            raise ValueError(f"BLP: unsupported BLP1 encoding {encoding}")
        return _blp_palette_pixels(data, pos + 1024, lengths[0], palette(),
                                   alpha, w, h)
    if compression != 1:
        raise ValueError(f"BLP: unknown BLP2 compression {compression}")
    if encoding == 1:
        return _blp_palette_pixels(data, offsets[0], lengths[0], palette(),
                                   alpha, w, h)
    if encoding != 2:
        raise ValueError(f"BLP: unknown BLP2 encoding {encoding}")
    if alpha_encoding not in _BLP_DXT:
        raise ValueError(f"BLP: unsupported alpha encoding {alpha_encoding}")
    palette()                                   # read (and unused) by PIL
    return _blp_dxt(data, offsets[0], _BLP_DXT[alpha_encoding], alpha, w, h)


# ---------------------------------------------------------------------------
# SUN raster
# ---------------------------------------------------------------------------

SUN_MAGIC = b"\x59\xa6\x6a\x95"


def _sun_rle(data: bytes, pos: int, n: int) -> np.ndarray:
    """The first n bytes of the Sun run-length stream at pos: 0x80 0 is a
    literal 0x80, 0x80 k v a run of k + 1 v's, any other byte itself."""
    out, i, end = bytearray(), pos, len(data)
    while len(out) < n:
        j = data.find(b"\x80", i, min(end, i + n - len(out)))
        if j < 0:                               # literals up to the need
            j = min(end, i + n - len(out))
        out += data[i:j]
        i = j
        if len(out) >= n or i + 1 >= end:
            break
        k = data[i + 1]
        if k == 0:
            out.append(0x80)
            i += 2
        elif i + 2 < end:
            out += data[i + 2:i + 3] * (k + 1)
            i += 3
        else:
            break
    if len(out) < n:
        raise ValueError("SUN: image file is truncated")
    return np.frombuffer(bytes(out[:n]), np.uint8)


def decode_sun(data: bytes) -> np.ndarray:
    """A Sun raster file's samples: (H, W, 1) gray (0 / 255 at depth 1),
    (H, W, 3) colours of palette and 24- / 32-bit files."""
    if len(data) < 32 or data[:4] != SUN_MAGIC:
        raise ValueError("not a SUN raster file")
    w, h, depth, _, ftype, ptype, plen = struct.unpack_from(">7I", data, 4)
    if depth not in (1, 4, 8, 24, 32):
        raise ValueError(f"SUN: unsupported depth {depth}")
    pos, colours = 32, None
    if plen:
        if plen > 1024:
            raise ValueError(f"SUN: unsupported colour map of {plen} bytes")
        if ptype != 1:
            raise ValueError(f"SUN: unsupported colour map type {ptype}")
        if depth not in (4, 8):
            raise ValueError(f"SUN: a colour map on a {depth}-bit image (PIL "
                             "cannot load one)")
        n = plen // 3                           # PIL's P: RGB;L, planar
        colours = np.zeros((256, 3), np.uint8)
        colours[:n] = np.frombuffer(data, np.uint8, 3 * n,
                                    pos).reshape(3, n).T
        pos += plen
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise ValueError(f"SUN: unsupported file type {ftype}")
    row_bytes = (w * depth + 7) // 8
    if ftype == 2:                              # rows of the unpadded width
        rows = _sun_rle(data, pos, h * row_bytes).reshape(h, row_bytes)
    else:
        stride = ((w * depth + 15) // 16) * 2
        if h and len(data) < pos + (h - 1) * stride + row_bytes:
            raise ValueError("SUN: image file is truncated")
        buf = np.frombuffer(data, np.uint8)
        rows = buf[pos + np.arange(h)[:, None] * stride
                   + np.arange(row_bytes)]
    if depth == 1:
        return _bits(rows, w, set_value=0)
    if depth == 4:
        idx = np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)[:, :w]
        return (colours[idx] if colours is not None
                else (idx * 17).astype(np.uint8)[..., None])
    if depth == 8:
        return colours[rows] if colours is not None else rows[..., None]
    px = rows[:, :w * depth // 8].reshape(h, w, depth // 8)[..., :3]
    return np.ascontiguousarray(px if ftype == 3 else px[..., ::-1])


# ---------------------------------------------------------------------------
# XPM
# ---------------------------------------------------------------------------

_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def decode_xpm(data: bytes) -> np.ndarray:
    """An XPM file's colours, (H, W, 3) uint8."""
    if not data.startswith(b"/* XPM */"):
        raise ValueError("not an XPM file")
    lines = data[9:].split(b"\n")
    lines = [ln + b"\n" for ln in lines[:-1]] + ([lines[-1]] if lines[-1]
                                                 else [])
    it = iter(lines)
    for line in it:
        m = _XPM_HEAD.match(line)
        if m:
            break
    else:
        raise ValueError("XPM: broken file (no size line)")
    try:
        w, h, ncolours, cpp = (int(g) for g in m.groups())
    except ValueError:
        raise ValueError("XPM: bad size line") from None
    if cpp <= 0:
        raise ValueError("XPM: no characters per pixel")
    table = {}
    for _ in range(ncolours):
        line = next(it, b"").rstrip()
        key, words = line[1:cpp + 1], line[cpp + 1:-2].split()
        for i in range(0, len(words), 2):
            if words[i] == b"c":
                if i + 1 >= len(words):
                    raise ValueError("XPM: a colour key without a value")
                value = words[i + 1]
                if value == b"None":            # transparent: no colour
                    pass
                elif value.startswith(b"#"):
                    v = int(value[1:], 16)
                    table[key] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                else:
                    raise ValueError(f"XPM: colour {value.decode('latin-1')}"
                                     " is not read (only #rrggbb and None)")
                break
        else:
            raise ValueError("XPM: a colour line without a 'c' key")
    need, keys, header = w * h, [], False
    for line in it:
        if len(keys) >= need:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        body = b'"'.join(line.split(b'"')[1:-1])
        for i in range(0, len(body), cpp):
            key = body[i:i + cpp]
            if key not in table:
                raise ValueError(f"XPM: pixel {key!r} names no colour")
            keys.append(key)
    if len(keys) < need:
        raise ValueError("XPM: not enough image data")
    lut = {k: i for i, k in enumerate(table)}
    colours = np.array(list(table.values()), np.uint8).reshape(-1, 3)
    idx = np.fromiter((lut[k] for k in keys[:need]), np.int64, need)
    return colours[idx].reshape(h, w, 3)
