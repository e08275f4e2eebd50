"""Image I/O and metrics (port of acceleratedvolrenderer_tpu/utils/image.py:
ImageMetadata, the ZIP-compressed scanline EXR writer write_exr, the
scanline EXR reader read_exr (NONE, RLE, ZIPS, ZIP and PIZ chunks),
read_image, write_png, mse / mrse / mae, PFM and QOI), numpy, struct and
zlib only: PNG files are written and read here too (8- and 16-bit gray,
gray + alpha, RGB and RGBA), and JPEG, BMP, TGA, GIF, QOI and netpbm
files read, which the reference reads through PIL (TIFF in tiff.py, WebP
in webp.py, PCX, SGI, IM and DDS in image_read.py).  write_png writes the
format the path's extension names, as the reference's PIL does
(image_write.py).  EXR files are byte-identical to the reference writer's.
"""
from __future__ import annotations

import re
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

_EXR_MAGIC = 0x01312F76
_UINT, _HALF, _FLOAT = 0, 1, 2     # pixel types
# compression ids
_NO_COMPRESSION, _RLE, _ZIPS, _ZIP, _PIZ = 0, 1, 2, 3, 4


@dataclass
class ImageMetadata:
    """Typed EXR attributes the renderer writes (the reference's
    ImageMetadata)."""
    render_time_seconds: Optional[float] = None
    samples_per_pixel: Optional[int] = None
    mse: Optional[float] = None
    world_to_camera: Optional[np.ndarray] = None  # (4,4)
    world_to_ndc: Optional[np.ndarray] = None     # (4,4)
    pixel_bounds: Optional[tuple] = None          # (x0, y0, x1, y1) data window
    full_resolution: Optional[tuple] = None       # (w, h) display window
    strings: Dict[str, str] = field(default_factory=dict)


def _zip_filter_encode(raw: bytes) -> bytes:
    """OpenEXR's ZIP pre-filter: split even / odd bytes, then a delta
    predictor."""
    data = np.frombuffer(raw, np.uint8)
    n = data.size
    half = (n + 1) // 2
    tmp = np.empty(n, np.uint8)
    tmp[:half] = data[0::2]
    tmp[half:] = data[1::2]
    d = tmp.astype(np.int16)
    d[1:] = d[1:] - tmp[:-1].astype(np.int16) + (128 + 256)
    return d.astype(np.uint8).tobytes()


def _zip_filter_decode(raw: bytes) -> bytes:
    """Inverse of _zip_filter_encode."""
    tmp = np.frombuffer(raw, np.uint8).astype(np.uint8).copy()
    # inverse predictor (sequential; cumsum formulation keeps it vectorized)
    d = tmp.astype(np.int64)
    d[1:] -= 128
    out = np.cumsum(d, dtype=np.int64) & 0xFF
    tmp = out.astype(np.uint8)
    n = tmp.size
    half = (n + 1) // 2
    res = np.empty(n, np.uint8)
    res[0::2] = tmp[:half]
    res[1::2] = tmp[half:]
    return res.tobytes()


def _attr(name: str, type_: str, data: bytes) -> bytes:
    return (name.encode() + b"\0" + type_.encode() + b"\0"
            + struct.pack("<i", len(data)) + data)


def _chlist(channels, pixel_type=_FLOAT) -> bytes:
    out = b""
    for name in channels:
        out += name.encode() + b"\0" + struct.pack("<iBBBBii", pixel_type,
                                                   0, 0, 0, 0, 1, 1)
    return out + b"\0"


def write_exr(path: str, rgb: np.ndarray,
              metadata: Optional[ImageMetadata] = None,
              channel_names=("R", "G", "B"), half: bool = False):
    """Write an (H, W, C) float array as a ZIP-compressed scanline EXR; the
    channel list is stored alphabetically, as EXR requires."""
    rgb = np.asarray(rgb, np.float32)
    if rgb.ndim == 2:
        rgb = rgb[:, :, None]
    h, w, c = rgb.shape
    assert c == len(channel_names)
    order = sorted(range(c), key=lambda i: channel_names[i])
    sorted_names = [channel_names[i] for i in order]
    pixel_type = _HALF if half else _FLOAT

    header = _attr("channels", "chlist", _chlist(sorted_names, pixel_type))
    header += _attr("compression", "compression", struct.pack("<B", _ZIP))
    window = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", window)
    header += _attr("displayWindow", "box2i", window)
    header += _attr("lineOrder", "lineOrder", struct.pack("<B", 0))
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    md = metadata or ImageMetadata()
    if md.render_time_seconds is not None:
        header += _attr("renderTimeSeconds", "float",
                        struct.pack("<f", md.render_time_seconds))
    if md.samples_per_pixel is not None:
        header += _attr("samplesPerPixel", "int",
                        struct.pack("<i", md.samples_per_pixel))
    if md.mse is not None:
        header += _attr("MSE", "float", struct.pack("<f", md.mse))
    for key, m in (("worldToCamera", md.world_to_camera),
                   ("worldToNDC", md.world_to_ndc)):
        if m is not None:
            header += _attr(key, "m44f", struct.pack(
                "<16f", *np.asarray(m, np.float32).reshape(-1)))
    for k, v in md.strings.items():
        header += _attr(k, "string", v.encode())
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    lines_per_chunk = 16  # ZIP
    n_chunks = (h + lines_per_chunk - 1) // lines_per_chunk
    chunks = []
    cast = rgb.astype(np.float16) if half else rgb
    for ci in range(n_chunks):
        y0 = ci * lines_per_chunk
        y1 = min(y0 + lines_per_chunk, h)
        block = b"".join(cast[y, :, k].tobytes()
                         for y in range(y0, y1) for k in order)
        comp = zlib.compress(_zip_filter_encode(block), 6)
        if len(comp) >= len(block):
            comp = block
        chunks.append(struct.pack("<ii", y0, len(comp)) + comp)

    with open(path, "wb") as f:
        f.write(struct.pack("<II", _EXR_MAGIC, 2))
        f.write(header)
        offset = f.tell() + 8 * n_chunks
        for chunk in chunks:
            f.write(struct.pack("<Q", offset))
            offset += len(chunk)
        for chunk in chunks:
            f.write(chunk)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _read_attrs(f):
    attrs = {}
    while True:
        name = _read_cstr(f)
        if name == "":
            break
        type_ = _read_cstr(f)
        (size,) = struct.unpack("<i", f.read(4))
        attrs[name] = (type_, f.read(size))
    return attrs


def _read_cstr(f) -> str:
    out = b""
    while True:
        ch = f.read(1)
        if ch in (b"\0", b""):
            return out.decode("latin-1")
        out += ch


def _parse_chlist(data: bytes):
    channels = []
    i = 0
    while data[i] != 0:
        j = data.index(0, i)
        name = data[i:j].decode()
        ptype, _, _, _, _, xs, ys = struct.unpack("<iBBBBii", data[j + 1: j + 17])
        channels.append((name, ptype, xs, ys))
        i = j + 17
    return channels


def read_exr(path: str):
    """Read a scanline EXR -> (image (H, W, C) float32, channel names,
    attrs dict).  Channels come back in R,G,B-first order when present."""
    from . import piz as _piz

    with open(path, "rb") as f:
        magic, version = struct.unpack("<II", f.read(8))
        if magic != _EXR_MAGIC:
            raise ValueError(f"{path}: not an EXR file")
        if version & 0x200:
            raise NotImplementedError("tiled EXR not supported")
        attrs = _read_attrs(f)
        channels = _parse_chlist(attrs["channels"][1])
        compression = attrs["compression"][1][0]
        x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
        w, h = x1 - x0 + 1, y1 - y0 + 1
        lines_per_chunk = {_NO_COMPRESSION: 1, _RLE: 1, _ZIPS: 1, _ZIP: 16, _PIZ: 32}[compression]
        n_chunks = (h + lines_per_chunk - 1) // lines_per_chunk
        f.read(8 * n_chunks)  # offset table; chunks are sequential

        nbytes = {0: 4, 1: 2, 2: 4}
        dtypes = {0: np.uint32, 1: np.float16, 2: np.float32}
        out = {name: np.zeros((h, w), np.float32) for name, *_ in channels}
        for _ in range(n_chunks):
            cy, size = struct.unpack("<ii", f.read(8))
            data = f.read(size)
            ny = min(lines_per_chunk, y1 - cy + 1)
            raw_size = ny * w * sum(nbytes[pt] for _, pt, _, _ in channels)
            if compression in (_ZIP, _ZIPS):
                if size < raw_size:
                    data = _zip_filter_decode(zlib.decompress(data))
            elif compression == _PIZ:
                if size < raw_size:
                    data = _piz.piz_decompress(data, w, ny, channels)
            elif compression == _RLE:
                if size < raw_size:
                    data = _zip_filter_decode(_rle_decode(data))
            i = 0
            for line in range(ny):
                for name, ptype, _, _ in channels:
                    nb = w * nbytes[ptype]
                    vals = np.frombuffer(data[i:i + nb], dtypes[ptype]).astype(np.float32)
                    out[name][cy - y0 + line] = vals
                    i += nb

    names = [c[0] for c in channels]
    pref = [n for n in ("R", "G", "B", "A") if n in names] + [n for n in sorted(names) if n not in ("R", "G", "B", "A")]
    img = np.stack([out[n] for n in pref], axis=-1)
    parsed_attrs = {}
    for k, (t, v) in attrs.items():
        if t == "float":
            parsed_attrs[k] = struct.unpack("<f", v)[0]
        elif t == "int":
            parsed_attrs[k] = struct.unpack("<i", v)[0]
        elif t == "string":
            parsed_attrs[k] = v.decode("latin-1")
        elif t == "m44f":
            parsed_attrs[k] = np.frombuffer(v, np.float32).reshape(4, 4)
        else:
            parsed_attrs[k] = (t, v)
    return img, pref, parsed_attrs


def _rle_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        count = struct.unpack("<b", data[i:i + 1])[0]
        i += 1
        if count < 0:
            out += data[i:i - count]
            i += -count
        else:
            out += data[i:i + 1] * (count + 1)
            i += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# PNG / metrics
# ---------------------------------------------------------------------------

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# color type -> channels (8-bit samples): gray, RGB, gray + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_filters(rows: np.ndarray, bpp: int):
    """Each row of rows (H, N) uint8 under the filters None, Up, Sub and
    Paeth (PNG spec 9.2; zero bytes above the first row and left of the
    first pixel), (4, H, N) uint8 in that order, and each filtered row's
    cost (4, H): the sum of its bytes' absolute values read as signed."""
    x = rows.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    corner = np.zeros_like(x)
    corner[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - corner
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - corner)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, corner))
    filtered = np.stack([x, x - up, x - left, x - paeth]).astype(np.uint8)
    cost = np.abs(filtered.view(np.int8).astype(np.int32)).sum(-1)
    return filtered, cost


def encode_png(pixels: np.ndarray) -> bytes:
    """A PNG of uint8 (8-bit) or uint16 (16-bit, big-endian) pixels (H, W)
    gray or (H, W, C) with C 1-4 (gray, gray + alpha, RGB, RGBA), the
    bytes PIL 12.1.0's Image.save writes for them.  Other dtypes are cast
    to uint8.  PIL's recipe (ZipEncode.c): each row starts from None and
    takes Up, then Sub, then Paeth where its filtered bytes, read as
    signed, have a strictly smaller sum of absolute values (Average only
    under optimize, which save does not set); the filtered rows, each with
    its type byte, go one by one through deflate at level 6, window 15,
    memLevel 9, strategy Z_FILTERED; ImageFile._save cuts the stream into
    IDAT chunks of max(65536, 4 * width) bytes, between IHDR and IEND.
    The file equals PIL's where the zlib is PIL's (1.2.13); the stream
    zlib.decompress gives back depends on this code alone."""
    a = np.asarray(pixels)
    if a.dtype != np.uint16:
        a = a.astype(np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    rows = a.astype(a.dtype.newbyteorder(">")).reshape(h, -1).view(np.uint8)
    filtered, cost = _png_filters(rows, c * a.dtype.itemsize)
    pick = np.zeros(h, np.int64)            # None, then Up, Sub and Paeth
    best = cost[0].copy()
    for k in (1, 2, 3):
        better = cost[k] < best
        pick[better] = k
        best[better] = cost[k][better]
    types = np.array([0, 2, 1, 4], np.uint8)[pick]
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    parts = [z.compress(bytes((types[i],)) + filtered[pick[i], i].tobytes())
             for i in range(h)]
    parts.append(z.flush())
    stream = b"".join(parts)
    size = max(65536, 4 * w)
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (_PNG_MAGIC
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h,
                                              8 * a.dtype.itemsize, ctype,
                                              0, 0, 0))
            + b"".join(_png_chunk(b"IDAT", stream[i:i + size])
                       for i in range(0, len(stream), size))
            + _png_chunk(b"IEND", b""))


def _unfilter_row(ftype, row, prev, bpp):
    """One scanline's bytes with its filter undone (PNG spec 9.2); row and
    prev uint8 arrays (prev zeros for the first row)."""
    if ftype == 0:
        return row
    if ftype == 2:                                      # Up
        return (row + prev).astype(np.uint8)
    if ftype == 1:                                      # Sub
        r = row.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(r, axis=0) % 256).astype(np.uint8).reshape(-1)
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    n = len(out)
    if ftype == 3:                                      # Average
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
    elif ftype == 4:                                    # Paeth
        for i in range(n):
            a = out[i - bpp] if i >= bpp else 0
            b = up[i]
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    else:
        raise ValueError(f"PNG: unknown filter type {ftype}")
    return np.frombuffer(bytes(out), np.uint8)


# PNG bit depths by color type: gray, RGB, palette, gray + alpha, RGBA
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_samples(rows, w, c, depth):
    """(h, w, c) samples of unfiltered scanlines rows (h, stride) uint8:
    uint16 at depth 16, else uint8 (sub-byte samples unpacked, unscaled)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :w * c].reshape(h, w, c)
    if depth == 16:
        b = rows[:, :2 * w * c].reshape(h, w, c, 2).astype(np.uint16)
        return (b[..., 0] << 8) | b[..., 1]
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def decode_png(data: bytes) -> np.ndarray:
    """The pixels (H, W, C) of a PNG: gray, gray + alpha, RGB or RGBA as
    stored, a palette expanded to RGB (RGBA with a tRNS chunk); uint16 for
    16-bit files, else uint8 (gray of 1, 2 or 4 bits scaled to 8); plain
    or Adam7-interlaced, all five filter types."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, idat, hdr, plte, trns = 8, [], None, None, None
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth not in _PNG_DEPTHS.get(ctype, ()) or interlace > 1:
        raise ValueError(f"PNG: bit depth {depth}, color type {ctype}, "
                         f"interlace {interlace} is not a valid PNG")
    if ctype == 3 and plte is None:
        raise ValueError("PNG: palette image without a PLTE chunk")
    c = _PNG_CHANNELS.get(ctype, 1)
    bpp = max(1, c * depth // 8)            # the filters' byte distance
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    out = np.zeros((h, w, c), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * c * depth + 7) // 8
        block = raw[pos:pos + ph * (1 + stride)].reshape(ph, 1 + stride)
        pos += ph * (1 + stride)
        rows = np.empty((ph, stride), np.uint8)
        prev = np.zeros(stride, np.uint8)
        for y in range(ph):
            prev = rows[y] = _unfilter_row(int(block[y, 0]), block[y, 1:],
                                           prev, bpp)
        out[y0::dy, x0::dx] = _png_samples(rows, pw, c, depth)
    if ctype == 3:
        idx = out[..., 0]
        pal = plte
        if trns is not None:
            alpha = np.full(len(plte), 255, np.uint8)
            alpha[:len(trns)] = trns[:len(plte)]
            pal = np.concatenate([plte, alpha[:, None]], axis=1)
        return pal[np.minimum(idx, len(pal) - 1)]
    if ctype == 0 and depth < 8:
        out *= 255 // ((1 << depth) - 1)
    return out


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def png_unit(pixels: np.ndarray) -> np.ndarray:
    """decode_png's integer pixels as float32 in [0, 1]."""
    return pixels.astype(np.float32) / np.iinfo(pixels.dtype).max


def to_8bit(rgb: np.ndarray, tonemap: bool = True) -> np.ndarray:
    """write_png's samples of a linear image: clipped to [0, 1],
    sRGB-encoded when tonemap (else stored as is), rounded to uint8."""
    x = np.clip(np.asarray(rgb, np.float32), 0.0, 1.0)
    if tonemap:
        x = np.where(x <= 0.0031308, 12.92 * x,
                     1.055 * np.power(np.maximum(x, 1e-8), 1 / 2.4) - 0.055)
    return (x * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, rgb: np.ndarray, tonemap: bool = True):
    """The 8-bit image to_8bit makes of a linear image (H, W, 3), in the
    format PIL's Image.save picks by path's extension, as the reference
    writes it: PNG (its pixels), JPEG, BMP, TGA, TIFF, PPM, PCX, SGI, IM,
    DDS and QOI byte for byte the reference's files.  Other extensions
    raise what PIL raises (image_write.encode); nothing is written then."""
    from .image_write import encode

    data = encode(path, to_8bit(rgb, tonemap))
    with open(path, "wb") as f:
        f.write(data)


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def mrse(a: np.ndarray, b: np.ndarray, eps: float = 1e-2) -> float:
    """Mean relative squared error (imgtool diff's MRSE metric,
    cmd/imgtool.cpp)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2 / (b * b + eps)))


def mae(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# ---------------------------------------------------------------------------
# JPEG (Huffman: baseline, extended sequential, progressive), TGA and BMP,
# decoded with numpy: the formats the reference reads through PIL.  The
# JPEG decoder follows libjpeg-turbo's defaults, as PIL decodes: the islow
# integer IDCT (jidctint.c), "fancy" triangular chroma upsampling
# (jdsample.c) and its YCbCr -> RGB tables (jdcolor.c).
# ---------------------------------------------------------------------------

_JPEG_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63], np.int64)
_ZZ = _JPEG_NATURAL.tolist()
_JPEG_UNREAD = {0xC5: "hierarchical", 0xC6: "hierarchical",
                0xC7: "hierarchical lossless",
                0xCB: "arithmetic-coded lossless",
                0xCD: "arithmetic-coded hierarchical",
                0xCE: "arithmetic-coded hierarchical",
                0xCF: "arithmetic-coded hierarchical lossless"}


def _huffman_lookup(counts, symbols):
    """(symbol, code length) of every 16-bit prefix of a canonical Huffman
    table (lists; a prefix no code starts gives symbol 0, length 16)."""
    sym = np.zeros(1 << 16, np.int64)
    ln = np.full(1 << 16, 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            sym[lo:hi] = symbols[k]
            ln[lo:hi] = length
            code += 1
            k += 1
        code <<= 1
    return sym.tolist(), ln.tolist()


def _bit_windows(segment: bytes):
    """24-bit big-endian windows w[i] = bytes i..i+2 of an entropy-coded
    segment (stuffing removed), zero past its end, as libjpeg reads."""
    a = np.frombuffer(segment + b"\0" * 8, np.uint8).astype(np.int64)
    return ((a[:-2] << 16) | (a[1:-1] << 8) | a[2:]).tolist()


def _scan_segments(data: bytes, pos: int):
    """The entropy-coded data from pos to the next marker other than RSTn:
    (its restart segments with byte stuffing removed, the marker's
    position)."""
    end = pos
    while True:
        end = data.find(b"\xff", end)
        if end < 0 or end + 1 >= len(data):
            raise ValueError("JPEG: truncated file (entropy-coded data "
                             "runs past the end)")
        nxt = data[end + 1]
        if nxt == 0 or 0xD0 <= nxt <= 0xD7:
            end += 2
            continue
        break
    parts = re.split(rb"\xff[\xd0-\xd7]", data[pos:end])
    return [p.replace(b"\xff\x00", b"\xff") for p in parts], end


def _scan_units(frame, sc):
    """The scan's MCUs, each a list of (component index, offset of its
    block's 64 coefficients): blocks in order for one component, else the
    interleaved MCUs."""
    comps = frame["comps"]
    if len(sc) == 1:                        # non-interleaved: block order
        ci = sc[0][0]
        c = comps[ci]
        return [[(ci, (by * c["bw_pad"] + bx) * 64)]
                for by in range(c["bh"]) for bx in range(c["bw"])]
    units = []
    for my in range(frame["mcuy"]):
        for mx in range(frame["mcux"]):
            u = []
            for ci, _, _ in sc:
                c = comps[ci]
                for v in range(c["v"]):
                    for h in range(c["h"]):
                        u.append((ci, ((my * c["v"] + v) * c["bw_pad"]
                                       + mx * c["h"] + h) * 64))
            units.append(u)
    return units


def _decode_scan(frame, scan, segments, restart):
    """Decode one scan's Huffman data into the frame's coefficient lists
    (natural order, 64 per block, padded block grid per component)."""
    comps = frame["comps"]
    ss, se, ah, al = scan["ss"], scan["se"], scan["ah"], scan["al"]
    sc = scan["comps"]                      # (component index, dc, ac)
    progressive = frame["progressive"]
    units = _scan_units(frame, sc)
    tables = {ci: (dc, ac) for ci, dc, ac in sc}
    per = restart if restart else len(units)
    n_seg = -(-len(units) // per) if units else 0
    if len(segments) < n_seg:
        raise ValueError("JPEG: fewer restart intervals than the scan needs")
    zz = _ZZ
    for si in range(n_seg):
        w = _bit_windows(segments[si])
        pos = 0
        pred = {ci: 0 for ci in tables}
        eobrun = 0
        for unit in units[si * per:(si + 1) * per]:
            for ci, b in unit:
                out = comps[ci]["coef"]
                dsym, dlen = tables[ci][0] or (None, None)
                asym, alen = tables[ci][1] or (None, None)
                if not progressive:
                    p = (w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF
                    s = dsym[p]
                    pos += dlen[p]
                    if s:
                        v = (w[pos >> 3] >> (24 - (pos & 7) - s)) & ((1 << s) - 1)
                        pos += s
                        if v < (1 << (s - 1)):
                            v -= (1 << s) - 1
                        pred[ci] += v
                    out[b] = pred[ci]
                    k = 1
                    while k < 64:
                        p = (w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF
                        rs = asym[p]
                        pos += alen[p]
                        s = rs & 15
                        if s:
                            k += rs >> 4
                            v = (w[pos >> 3] >> (24 - (pos & 7) - s)) & ((1 << s) - 1)
                            pos += s
                            if v < (1 << (s - 1)):
                                v -= (1 << s) - 1
                            out[b + zz[k]] = v
                            k += 1
                        elif rs == 0xF0:
                            k += 16
                        else:
                            break
                elif ss == 0 and ah == 0:       # DC, first scan
                    p = (w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF
                    s = dsym[p]
                    pos += dlen[p]
                    if s:
                        v = (w[pos >> 3] >> (24 - (pos & 7) - s)) & ((1 << s) - 1)
                        pos += s
                        if v < (1 << (s - 1)):
                            v -= (1 << s) - 1
                        pred[ci] += v
                    out[b] = pred[ci] * (1 << al)
                elif ss == 0:                   # DC, refinement
                    if (w[pos >> 3] >> (23 - (pos & 7))) & 1:
                        out[b] |= 1 << al
                    pos += 1
                elif ah == 0:                   # AC, first scan
                    if eobrun:
                        eobrun -= 1
                        continue
                    k = ss
                    while k <= se:
                        p = (w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF
                        rs = asym[p]
                        pos += alen[p]
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            v = (w[pos >> 3] >> (24 - (pos & 7) - s)) & ((1 << s) - 1)
                            pos += s
                            if v < (1 << (s - 1)):
                                v -= (1 << s) - 1
                            out[b + zz[k]] = v * (1 << al)
                            k += 1
                        elif r == 15:
                            k += 16
                        else:
                            eobrun = (1 << r) - 1
                            if r:
                                eobrun += (w[pos >> 3] >> (24 - (pos & 7) - r)) & ((1 << r) - 1)
                                pos += r
                            break
                else:                           # AC, refinement
                    p1, m1 = 1 << al, -1 << al
                    k = ss
                    if not eobrun:
                        while k <= se:
                            p = (w[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF
                            rs = asym[p]
                            pos += alen[p]
                            r, s = rs >> 4, rs & 15
                            if s:
                                s = p1 if (w[pos >> 3] >> (23 - (pos & 7))) & 1 else m1
                                pos += 1
                            elif r != 15:
                                eobrun = 1 << r
                                if r:
                                    eobrun += (w[pos >> 3] >> (24 - (pos & 7) - r)) & ((1 << r) - 1)
                                    pos += r
                                break
                            while k <= se:
                                z = b + zz[k]
                                if out[z]:
                                    if (w[pos >> 3] >> (23 - (pos & 7))) & 1:
                                        if not out[z] & p1:
                                            out[z] += p1 if out[z] >= 0 else m1
                                    pos += 1
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                k += 1
                            if s and k <= se:
                                out[b + zz[k]] = s
                            k += 1
                    if eobrun:
                        while k <= se:
                            z = b + zz[k]
                            if out[z]:
                                if (w[pos >> 3] >> (23 - (pos & 7))) & 1:
                                    if not out[z] & p1:
                                        out[z] += p1 if out[z] >= 0 else m1
                                pos += 1
                            k += 1
                        eobrun -= 1


# libjpeg's jpeg_aritab (jaricom.c, T.81 Table D.2): per state, Qe << 16 |
# next state after an MPS << 8 | MPS switch << 7 | next state after an LPS;
# state 113 is the fixed (0.5) bin
_ARITAB = (
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171,
)


class _BadArithCode(Exception):
    """A magnitude or position past its range in an arithmetic-coded scan."""


class _QMDecoder:
    """libjpeg's arith_decode (jdarith.c, T.81 D.2) over one restart
    interval's bytes, zeros past their end."""

    def __init__(self, seg: bytes):
        self.seg, self.n = seg, len(seg)
        self.c, self.a, self.ct, self.pos = 0, 0, -16, 0

    def decode(self, st, i):
        """One binary decision with statistics bin st[i] (its state updated
        in place)."""
        c, a, ct = self.c, self.a, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                pos = self.pos
                c = (c << 8) | (self.seg[pos] if pos < self.n else 0)
                self.pos = pos + 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:                 # the 2 initial bytes are in
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = _ARITAB[sv & 0x7F]
        nl = qe & 0xFF
        nm = (qe >> 8) & 0xFF
        qe >>= 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:                          # conditional LPS exchange
                st[i] = (sv & 0x80) ^ nm
            else:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            a = qe
        elif a < 0x8000:                        # conditional MPS exchange
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.c, self.a, self.ct = c, a, ct
        return sv >> 7

    def value(self, st, k, m):
        """T.81 F.24: the bits below magnitude m's top bit from bin k + 14,
        plus one."""
        v = m
        k += 14
        m >>= 1
        while m:
            if self.decode(st, k):
                v |= m
            m >>= 1
        return v + 1


def _decode_arith_scan(frame, scan, segments, restart, dac):
    """Decode one arithmetic-coded scan (SOF9 sequential, SOF10
    progressive) into the frame's coefficient lists, as libjpeg's jdarith.c
    does: per-table DC (64) and AC (256) statistics reset at the scan's
    start and at each restart, DC conditioning (L, U) and the AC split
    point K from a DAC marker (defaults 0, 1 and 5).  A code past its
    range stops the restart interval, leaving its coefficients as they
    are, as libjpeg does (it warns)."""
    sc, tids = scan["comps"], scan["tids"]
    units = _scan_units(frame, sc)
    per = restart if restart else len(units)
    n_seg = -(-len(units) // per) if units else 0
    if len(segments) < n_seg:
        raise ValueError("JPEG: fewer restart intervals than the scan needs")
    dct = {ci: t for (ci, _, _), t in zip(sc, tids)}
    for si in range(n_seg):
        stats = ({t[0]: [0] * 64 for t in tids},
                 {t[1]: [0] * 256 for t in tids})
        try:
            _arith_units(units[si * per:(si + 1) * per], frame, scan, dct,
                         _QMDecoder(segments[si]), stats, dac)
        except _BadArithCode:
            pass


def _arith_units(units, frame, scan, dct, q, stats, dac):
    """The MCUs of one restart interval of an arithmetic-coded scan: T.81
    F.1.4.4 (sequential; DC differences modulo 2^16), G.1.3 (progressive
    first and refinement passes)."""
    comps, prog = frame["comps"], frame["progressive"]
    ss, se, ah, al = scan["ss"], scan["se"], scan["ah"], scan["al"]
    do_dc = not prog or (ss == 0 and ah == 0)
    do_ac = not prog or ss > 0
    p1, m1 = 1 << al, -1 << al
    zz = _ZZ
    decode = q.decode
    dc_stats, ac_stats = stats
    fixed = [113]
    last = {ci: 0 for ci in dct}
    ctx = {ci: 0 for ci in dct}
    for unit in units:
        for ci, b in unit:
            out = comps[ci]["coef"]
            td, ta = dct[ci]
            if prog and ah and ss == 0:             # DC refinement
                if decode(fixed, 0):
                    out[b] |= p1
                continue
            if do_dc:                               # F.1.4.4.1
                st = dc_stats[td]
                if not decode(st, ctx[ci]):
                    ctx[ci] = 0
                else:
                    sign = decode(st, ctx[ci] + 1)
                    k = ctx[ci] + 2 + sign
                    m = decode(st, k)
                    if m:
                        k = 20
                        while decode(st, k):
                            m <<= 1
                            if m == 0x8000:
                                raise _BadArithCode
                            k += 1
                    cs = dac.get((0, td), 0x10)
                    if m < (1 << (cs & 15)) >> 1:
                        ctx[ci] = 0
                    elif m > (1 << (cs >> 4)) >> 1:
                        ctx[ci] = 12 + sign * 4
                    else:
                        ctx[ci] = 4 + sign * 4
                    v = q.value(st, k, m)
                    last[ci] += -v if sign else v
                if prog:
                    out[b] = last[ci] * (1 << al)
                else:
                    last[ci] &= 0xFFFF
                    out[b] = ((last[ci] + 0x8000) & 0xFFFF) - 0x8000
            if not do_ac:
                continue
            st = ac_stats[ta]
            kk = dac.get((1, ta), 5)
            k, end = (1, 63) if not prog else (ss, se)
            if prog and ah:                         # AC refinement
                kex = end
                while kex > 0 and not out[b + zz[kex]]:
                    kex -= 1
                while k <= end:
                    i = 3 * (k - 1)
                    if k > kex and decode(st, i):
                        break
                    while True:
                        z = b + zz[k]
                        if out[z]:
                            if decode(st, i + 2):
                                out[z] += m1 if out[z] < 0 else p1
                            break
                        if decode(st, i + 1):
                            out[z] = m1 if decode(fixed, 0) else p1
                            break
                        i += 3
                        k += 1
                        if k > end:
                            raise _BadArithCode
                    k += 1
                continue
            while k <= end:                         # F.1.4.4.2
                i = 3 * (k - 1)
                if decode(st, i):
                    break                           # end of block
                while not decode(st, i + 1):
                    i += 3
                    k += 1
                    if k > end:
                        raise _BadArithCode
                sign = decode(fixed, 0)
                i += 2
                m = decode(st, i)
                if m and decode(st, i):
                    m <<= 1
                    i = 189 if k <= kk else 217
                    while decode(st, i):
                        m <<= 1
                        if m == 0x8000:
                            raise _BadArithCode
                        i += 1
                v = q.value(st, i, m)
                out[b + zz[k]] = (-v if sign else v) * (1 << al if prog
                                                        else 1)
                k += 1


def _decode_lossless_scan(frame, scan, segments, restart):
    """Decode one lossless (SOF3) scan: each sample's difference (a DC-like
    category SSSS and its bits, 16 meaning 32768), then the samples of
    each of the scan's components by predictor scan["ss"] (T.81 H.1.2.1,
    libjpeg-turbo's jdpred.c), modulo 2^16: the first row of the image and
    of each restart interval from 2^(7 - Pt) and the left sample, each
    other row's first sample from the one above."""
    psv, pt = scan["ss"], scan["al"]
    if not 1 <= psv <= 7:
        raise ValueError(f"JPEG: lossless predictor {psv} is not defined")
    w, h = frame["w"], frame["h"]
    sc = scan["comps"]
    n, total = len(sc), w * h
    if restart and restart % w:
        raise ValueError("lossless JPEG whose restart interval is not whole "
                         "rows is not read")
    per = restart or total
    if len(segments) < -(-total // per):
        raise ValueError("JPEG: fewer restart intervals than the scan needs")
    diffs = [0] * (total * n)
    tables = [dc for _, dc, _ in sc]
    for si in range(-(-total // per)):
        win = _bit_windows(segments[si])
        pos = 0
        for i in range(si * per * n, min((si + 1) * per, total) * n):
            sym, ln = tables[i % n]
            p = (win[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF
            s = sym[p]
            pos += ln[p]
            if s == 16:
                diffs[i] = 32768
            elif s:
                v = (win[pos >> 3] >> (24 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                diffs[i] = v - (1 << s) + 1 if v < (1 << (s - 1)) else v
    d_all = np.array(diffs, np.int64).reshape(h, w, n)
    first = 1 << (7 - pt)
    restart_rows = per // w
    for k, (ci, _, _) in enumerate(sc):
        d = d_all[:, :, k]
        x = np.empty((h, w), np.int64)
        for r in range(h):
            if r % restart_rows == 0:
                x[r] = (first + np.cumsum(d[r])) & 0xFFFF
                continue
            prev = x[r - 1]
            if psv == 1:
                x[r] = (prev[0] + np.cumsum(d[r])) & 0xFFFF
            elif psv == 2:
                x[r] = (prev + d[r]) & 0xFFFF
            elif psv == 3:
                x[r, 0] = (prev[0] + d[r, 0]) & 0xFFFF
                x[r, 1:] = (prev[:-1] + d[r, 1:]) & 0xFFFF
            else:
                rb_row, dr = prev.tolist(), d[r].tolist()
                ra = (rb_row[0] + dr[0]) & 0xFFFF
                out = [ra]
                for c in range(1, w):
                    rb, rc = rb_row[c], rb_row[c - 1]
                    if psv == 4:
                        pred = ra + rb - rc
                    elif psv == 5:
                        pred = ra + ((rb - rc) >> 1)
                    elif psv == 6:
                        pred = rb + ((ra - rc) >> 1)
                    else:
                        pred = (ra + rb) >> 1
                    ra = (pred + dr[c]) & 0xFFFF
                    out.append(ra)
                x[r] = out
        frame["comps"][ci]["samples"] = x << pt


def _idct_pass(x, shift):
    """One 1-D pass of libjpeg's jpeg_idct_islow over the last axis of
    eight int64 arrays x[0..7] (CONST_BITS 13); outputs descaled by
    `shift` bits."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * 4433                       # FIX_0_541196100
    tmp2 = z1 + z3 * -15137                     # FIX_1_847759065
    tmp3 = z1 + z2 * 6270                       # FIX_0_765366865
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = x[7], x[5], x[3], x[1]
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * 9633                       # FIX_1_175875602
    tmp0 = tmp0 * 2446                          # FIX_0_298631336
    tmp1 = tmp1 * 16819                         # FIX_2_053119869
    tmp2 = tmp2 * 25172                         # FIX_3_072711026
    tmp3 = tmp3 * 12299                         # FIX_1_501321110
    z1 = z1 * -7373                             # FIX_0_899976223
    z2 = z2 * -20995                            # FIX_2_562915447
    z3 = z3 * -16069 + z5                       # FIX_1_961570560
    z4 = z4 * -3196 + z5                        # FIX_0_390180644
    tmp0 += z1 + z3
    tmp1 += z2 + z4
    tmp2 += z2 + z3
    tmp3 += z1 + z4
    r = 1 << (shift - 1)
    return [(t10 + tmp3 + r) >> shift, (t11 + tmp2 + r) >> shift,
            (t12 + tmp1 + r) >> shift, (t13 + tmp0 + r) >> shift,
            (t13 - tmp0 + r) >> shift, (t12 - tmp1 + r) >> shift,
            (t11 - tmp2 + r) >> shift, (t10 - tmp3 + r) >> shift]


def _idct_range_table():
    """libjpeg's post-IDCT range limit (jdmaster.c), indexed by the
    descaled value & 1023: clamp of v + 128 to 0..255 for v in
    [-512, 511]."""
    v = np.arange(1024)
    v = np.where(v >= 512, v - 1024, v)
    return np.clip(v + 128, 0, 255).astype(np.uint8)


_IDCT_RANGE = _idct_range_table()


def _idct_islow(coef, qt):
    """(n, 64) natural-order coefficients and their quantization table ->
    (n, 8, 8) uint8 samples, as jpeg_idct_islow computes them."""
    c = (coef * qt).reshape(-1, 8, 8)
    cols = _idct_pass([c[:, r, :] for r in range(8)], 11)   # pass 1
    ws = np.stack(cols, 1)                                  # (n, 8, 8)
    rows = _idct_pass([ws[:, :, u] for u in range(8)], 18)  # pass 2
    return _IDCT_RANGE[np.stack(rows, -1) & 1023]


def _upsample_fancy(x, h, v):
    """libjpeg-turbo's upsampling of a (rows, cols) uint8 plane by integer
    factors (h, v), edge samples replicated (jdsample.c): fancy (triangle)
    for 2x1 and 2x2 where the plane is more than 2 wide, fancy for 1x2,
    and box replication (h2v1_upsample, h2v2_upsample, int_upsample) for
    every other ratio and width."""
    x = x.astype(np.int64)
    if (h, v) == (1, 1):
        return x
    if (h, v) == (1, 2):                        # h1v2_fancy_upsample
        up = np.concatenate([x[:1], x[:-1]], 0)
        down = np.concatenate([x[1:], x[-1:]], 0)
        return np.stack([(3 * x + up + 1) >> 2, (3 * x + down + 2) >> 2],
                        1).reshape(-1, x.shape[1])
    if (h, v) not in ((2, 1), (2, 2)) or x.shape[1] <= 2:
        return np.repeat(np.repeat(x, v, 0), h, 1)
    if v == 2:
        up = np.concatenate([x[:1], x[:-1]], 0)
        down = np.concatenate([x[1:], x[-1:]], 0)
        sums = np.stack([3 * x + up, 3 * x + down], 1).reshape(-1, x.shape[1])
        left = np.concatenate([sums[:, :1], sums[:, :-1]], 1)
        right = np.concatenate([sums[:, 1:], sums[:, -1:]], 1)
        out = np.stack([(3 * sums + left + 8) >> 4,
                        (3 * sums + right + 7) >> 4], -1)
        return out.reshape(sums.shape[0], -1)
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.stack([(3 * x + left + 1) >> 2, (3 * x + right + 2) >> 2], -1)
    return out.reshape(x.shape[0], -1)


def _ycc_to_rgb(y, cb, cr):
    """jdcolor.c's ycc_rgb_convert: its fixed-point tables (16 fraction
    bits) and range limit."""
    one_half = 1 << 15
    fix = lambda f: int(f * (1 << 16) + 0.5)
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, ycck_as_cmyk: bool = False) -> np.ndarray:
    """A JPEG file's 8-bit samples, (H, W, 3) RGB or (H, W, 1) gray: Huffman
    baseline / extended sequential (SOF0 / SOF1), progressive (SOF2) and
    8-bit lossless (SOF3, unsubsampled, predictors 1-7), restart intervals, any sampling whose factors divide the largest
    (libjpeg-turbo's upsampling for each ratio), and libjpeg-turbo's
    choice of colour space: gray, YCbCr or RGB (JFIF; else an Adobe
    marker's transform; else the component ids 'R', 'G', 'B'), CMYK or
    YCCK (an Adobe marker's transform 0 or any other), whose inks come out
    as PIL's convert("RGB") of its (Adobe-inverted) CMYK makes them (a
    YCCK frame's components taken as CMYK when ycck_as_cmyk, as PIL's BLP
    reader has libjpeg take them).  Raises ValueError naming the format on
    anything else (hierarchical, arithmetic-coded lossless, 12-bit, 2
    components, other sampling)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    qts, dcs, acs = {}, {}, {}
    restart, frame, adobe, scans, jfif = 0, None, None, 0, False
    dac = {}                    # arithmetic conditioning: (class, table)
    pos = 2
    while True:
        start = pos
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data) - 1 and scans:
            break                   # no end-of-image marker: libjpeg warns
        if pos >= len(data) - 1:
            raise ValueError("JPEG: truncated file")
        if pos == start:
            raise ValueError("JPEG: marker expected")
        m = data[pos]
        pos += 1
        if m == 0xD9:
            break
        if m == 0xD8 or 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        size = int.from_bytes(data[pos:pos + 2], "big")
        if pos + size > len(data):
            raise ValueError("JPEG: truncated file")
        seg = data[pos + 2:pos + size]
        pos += size
        if m in _JPEG_UNREAD:
            raise ValueError(f"{_JPEG_UNREAD[m]} JPEG (marker 0x{m:02X}) "
                             "is not read")
        if m == 0xDB:                               # DQT
            i = 0
            while i < len(seg):
                prec, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if prec else 64
                vals = np.frombuffer(seg[i + 1:i + 1 + n],
                                     ">u2" if prec else np.uint8)
                q = np.zeros(64, np.int64)
                q[_JPEG_NATURAL] = vals
                qts[tq] = q
                i += 1 + n
        elif m == 0xC4:                             # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                n = sum(counts)
                table = _huffman_lookup(counts, list(seg[i + 17:i + 17 + n]))
                (acs if tc else dcs)[th] = table
                i += 17 + n
        elif m == 0xDD:                             # DRI
            restart = int.from_bytes(seg[:2], "big")
        elif m == 0xE0 and seg[:5] == b"JFIF\0":
            jfif = True
        elif m == 0xEE and seg[:5] == b"Adobe":
            adobe = seg[11] if len(seg) > 11 else 0
        elif m == 0xCC:                             # DAC
            for i in range(0, len(seg) - 1, 2):
                tc, tb, cs = seg[i] >> 4, seg[i] & 15, seg[i + 1]
                dac[(tc, tb)] = cs
        elif m in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):  # SOF
            if seg[0] != 8:
                raise ValueError(f"{seg[0]}-bit JPEG is not read")
            hgt, wid, nc = (int.from_bytes(seg[1:3], "big"),
                            int.from_bytes(seg[3:5], "big"), seg[5])
            if hgt == 0:
                raise ValueError("JPEG with a DNL marker is not read")
            if nc not in (1, 3, 4):
                raise ValueError(f"JPEG with {nc} components is not read")
            comps = [dict(h=seg[7 + 3 * i] >> 4, v=seg[7 + 3 * i] & 15,
                          tq=seg[8 + 3 * i]) for i in range(nc)]
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux, mcuy = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
            for c in comps:
                c["dw"] = -(-wid * c["h"] // hmax)      # downsampled size
                c["dh"] = -(-hgt * c["v"] // vmax)
                c["bw"], c["bh"] = -(-c["dw"] // 8), -(-c["dh"] // 8)
                c["bw_pad"], c["bh_pad"] = mcux * c["h"], mcuy * c["v"]
                c["coef"] = [0] * (c["bw_pad"] * c["bh_pad"] * 64)
                if hmax % c["h"] or vmax % c["v"]:
                    raise ValueError(f"JPEG sampling {c['h']}x{c['v']} of "
                                     f"{hmax}x{vmax} is not read")
            ids = [seg[6 + 3 * i] for i in range(nc)]
            if m == 0xC3 and (hmax, vmax) != (1, 1):
                raise ValueError("subsampled lossless JPEG is not read")
            frame = dict(w=wid, h=hgt, comps=comps, ids=ids, hmax=hmax,
                         vmax=vmax, mcux=mcux, mcuy=mcuy,
                         progressive=m in (0xC2, 0xCA), lossless=m == 0xC3,
                         arithmetic=m in (0xC9, 0xCA))
        elif m == 0xDA:                             # SOS
            if frame is None:
                raise ValueError("JPEG: scan before the frame header")
            ns = seg[0]
            sc, tids = [], []
            for i in range(ns):
                ci = frame["ids"].index(seg[1 + 2 * i])
                td, ta = seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15
                sc.append((ci, dcs.get(td), acs.get(ta)))
                tids.append((td, ta))
            ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
            ah, al = seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
            if frame["progressive"] and (
                    se < ss or se > 63 or (ss == 0) != (se == 0)
                    or (ss and ns != 1) or al > 13
                    or (ah and ah != al + 1)):    # jdphuff.c / jdarith.c
                raise ValueError(f"JPEG: bad progressive scan (Ss {ss}, Se "
                                 f"{se}, Ah {ah}, Al {al})")
            segments, pos = _scan_segments(data, pos)
            scan = dict(comps=sc, ss=ss, se=se, ah=ah, al=al, tids=tids)
            if frame["arithmetic"]:
                _decode_arith_scan(frame, scan, segments, restart, dac)
            elif frame["lossless"]:
                _decode_lossless_scan(frame, scan, segments, restart)
            else:
                _decode_scan(frame, scan, segments, restart)
            scans += 1
    if frame is None:
        raise ValueError("JPEG: no frame header")
    planes = []
    for c in frame["comps"]:
        if frame["lossless"]:
            if "samples" not in c:
                raise ValueError("JPEG: a component no scan carried")
            planes.append(np.clip(c["samples"], 0, 255))
            continue
        if c["tq"] not in qts:
            raise ValueError("JPEG: missing quantization table")
        blocks = _idct_islow(np.asarray(c["coef"], np.int64).reshape(-1, 64),
                             qts[c["tq"]])
        img = blocks.reshape(c["bh_pad"], c["bw_pad"], 8, 8).transpose(
            0, 2, 1, 3).reshape(c["bh_pad"] * 8, c["bw_pad"] * 8)
        img = _upsample_fancy(img[:c["dh"], :c["dw"]],
                              frame["hmax"] // c["h"], frame["vmax"] // c["v"])
        planes.append(img[:frame["h"], :frame["w"]].astype(np.int64))
    if len(planes) == 1:
        return planes[0].astype(np.uint8)[:, :, None]
    if len(planes) == 3:
        # jdapimin.c default_decompress_parms: JFIF, else Adobe, else ids
        # (1, 2, 3 or unknown: YCbCr, but RGB in a lossless frame)
        rgb = (not jfif and (adobe == 0 if adobe is not None
                             else frame["ids"] == [82, 71, 66]
                             or frame["lossless"]))
        if rgb:
            return np.stack(planes, -1).astype(np.uint8)
        if frame["lossless"]:                   # libjpeg-turbo refuses too
            raise ValueError("lossless JPEG in YCbCr is not read")
        return _ycc_to_rgb(*planes)
    if adobe is not None and adobe != 0 and not ycck_as_cmyk:  # jdcolor.c
        if frame["lossless"]:
            raise ValueError("lossless JPEG in YCCK is not read")
        planes[:3] = np.moveaxis(255 - _ycc_to_rgb(*planes[:3]).astype(
            np.int64), -1, 0)
    # PIL reads libjpeg's CMYK inverted ("CMYK;I") before converting it
    return cmyk_to_rgb(255 - np.stack(planes, -1))


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """PIL's CMYK -> RGB (Convert.c cmyk2rgb): MULDIV255(255 - c, 255 - k),
    rounded as its integer macro rounds; (..., 4) -> (..., 3) uint8."""
    c = cmyk.astype(np.int64)
    t = (255 - c[..., :3]) * (255 - c[..., 3:4]) + 128
    return (((t >> 8) + t) >> 8).astype(np.uint8)


def _bgr_words(v, masks=((0x7C00, 10), (0x3E0, 5), (0x1F, 0))):
    """16-bit pixels -> 8-bit RGB by their bit masks (5-5-5 by default), each
    field scaled as PIL's unpackers scale it: value * 255 // field max."""
    out = []
    for mask, shift in masks:
        top = mask >> shift
        out.append(((v & mask) >> shift) * 255 // top)
    return np.stack(out, -1).astype(np.uint8)


def decode_tga(data: bytes) -> np.ndarray:
    """A Truevision TGA file's 8-bit samples, (H, W, C): true-color (16-bit
    5-5-5 as RGB, 24- and 32-bit BGR(A) -> RGB(A)), gray (8-bit, 16-bit
    with alpha) and colour-mapped (8-bit indices into a 16- or 24-bit map,
    expanded to RGB as PIL's convert expands its palette),
    uncompressed or RLE, either origin.  Raises ValueError naming the kind
    on anything else (15-bit or other depths, which PIL refuses too)."""
    if len(data) < 18:
        raise ValueError("TGA: truncated header")
    idlen, cmtype, itype = data[0], data[1], data[2]
    cm_first, cm_len = struct.unpack_from("<HH", data, 3)
    cm_depth = data[7]
    w, h = struct.unpack_from("<HH", data, 12)
    depth, desc = data[16], data[17]
    if itype not in (1, 2, 3, 9, 10, 11):
        raise ValueError(f"TGA image type {itype} is not read")
    kind = {1: "colour-mapped", 2: "true-color", 3: "gray"}[itype & 7]
    ok = {1: (8,), 2: (16, 24, 32), 3: (8, 16)}[itype & 7]
    if depth not in ok:
        raise ValueError(f"{depth}-bit {kind} TGA is not read")
    # PIL refuses maps of other entry sizes, and fails to load a
    # colour-mapped image through a 32-bit map
    if cmtype and (cm_depth not in (16, 24, 32) or (
            itype & 7 == 1 and cm_depth == 32)):
        raise ValueError(f"TGA colour map of {cm_depth}-bit entries is not "
                         "read")
    bpp = depth // 8
    off = 18 + idlen
    cmap = None
    if cmtype:
        eb = cm_depth // 8
        raw = np.frombuffer(data, np.uint8, cm_len * eb, off).reshape(-1, eb)
        off += cm_len * eb
        if eb == 2:
            v = raw[:, 0].astype(np.int64) | (raw[:, 1].astype(np.int64) << 8)
            entries = _bgr_words(v)
        else:
            entries = raw[:, [2, 1, 0, 3][:eb]]
        cmap = np.zeros((cm_first + cm_len, entries.shape[1]), np.uint8)
        cmap[cm_first:] = entries               # indices count from 0
    n = w * h
    if not itype & 8:
        px = np.frombuffer(data, np.uint8, n * bpp, off)
    else:                                           # RLE packets
        src = np.frombuffer(data, np.uint8, offset=off)
        out = np.empty((n, bpp), np.uint8)
        i = j = 0
        while j < n:
            head = int(src[i])
            count = min((head & 0x7F) + 1, n - j)
            if head & 0x80:
                out[j:j + count] = src[i + 1:i + 1 + bpp]
                i += 1 + bpp
            else:
                out[j:j + count] = src[i + 1:i + 1 + count * bpp].reshape(
                    -1, bpp)
                i += 1 + count * bpp
            j += count
        px = out
    px = px.reshape(h, w, bpp)
    if itype & 7 == 1:
        if cmap is not None:
            px = cmap[np.minimum(px[:, :, 0], len(cmap) - 1)]
    elif itype & 7 == 2:
        if bpp == 2:
            v = px[:, :, 0].astype(np.int64) | (px[:, :, 1].astype(
                np.int64) << 8)
            px = _bgr_words(v)
        else:
            px = px[:, :, [2, 1, 0, 3][:bpp]]
    if not desc & 0x20:                             # bottom-left origin
        px = px[::-1]
    if desc & 0x10:                                 # right-to-left
        px = px[:, ::-1]
    return np.ascontiguousarray(px)


def _bmp_rle(data: bytes, off: int, w: int, h: int, rle4: bool):
    """RLE8 / RLE4 pixel indices (h, w), bottom row first as stored: runs,
    absolute runs (padded to 16 bits), end of line, end of bitmap and
    deltas; pixels not written stay 0."""
    idx = np.zeros((h, w), np.uint8)
    x = y = 0
    i, n = off, len(data)
    while i + 1 < n and y < h:
        count, val = data[i], data[i + 1]
        i += 2
        if count:
            k = min(count, max(w - x, 0))
            if rle4:
                idx[y, x:x + k] = np.where(np.arange(k) % 2 == 0, val >> 4,
                                           val & 15)
            else:
                idx[y, x:x + k] = val
            x += count
        elif val == 0:                              # end of line
            x, y = 0, y + 1
        elif val == 1:                              # end of bitmap
            break
        elif val == 2:                              # delta
            x += data[i]
            y += data[i + 1]
            i += 2
        else:                                       # absolute run
            nbytes = (val + 1) // 2 if rle4 else val
            raw = np.frombuffer(data, np.uint8, min(nbytes, n - i), i)
            if rle4:
                raw = np.stack([raw >> 4, raw & 15], -1).reshape(-1)
            k = min(val, len(raw), max(w - x, 0))
            idx[y, x:x + k] = raw[:k]
            x += val
            i += nbytes + (nbytes & 1)
    return idx


def decode_bmp(data: bytes) -> np.ndarray:
    """A Windows BMP's 8-bit RGB samples, (H, W, 3): 16-bit (5-5-5, or
    BI_BITFIELDS 5-6-5 / 5-5-5 masks, scaled as PIL scales them), 24- and
    32-bit (BI_RGB or 8-bit BI_BITFIELDS masks), and 1/4/8-bit palette
    images, raw or RLE4 / RLE8, expanded through their palette; bottom-up
    or top-down.  Raises ValueError naming the kind on anything else
    (JPEG / PNG payloads, other masks)."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    off, hsize = struct.unpack_from("<II", data, 10)
    if hsize == 12:                                 # OS/2 core header
        w, h, _, bpp = struct.unpack_from("<HhHH", data, 18)
        comp, n_pal, pal_bytes = 0, 0, 3
    else:
        w, h, _, bpp, comp = struct.unpack_from("<iiHHI", data, 18)
        n_pal = struct.unpack_from("<I", data, 46)[0]
        pal_bytes = 4
    top_down = h < 0
    h = abs(h)
    if not (comp in (0, 3) or (comp, bpp) in ((1, 8), (2, 4))) or (
            comp == 3 and bpp not in (16, 32)):
        raise ValueError(f"BMP compression {comp} at {bpp} bits is not read")
    stride = ((w * bpp + 31) // 32) * 4
    if comp in (1, 2):
        rows = None
    else:
        rows = np.frombuffer(data, np.uint8, stride * h, off).reshape(h,
                                                                      stride)
    if bpp == 24:
        px = rows[:, :w * 3].reshape(h, w, 3)[:, :, ::-1]
    elif bpp == 16:
        v = rows[:, :w * 2].copy().view("<u2").reshape(h, w).astype(np.int64)
        masks = (struct.unpack_from("<III", data, 14 + 40) if comp == 3
                 else (0x7C00, 0x3E0, 0x1F))
        if masks not in ((0x7C00, 0x3E0, 0x1F), (0xF800, 0x7E0, 0x1F)):
            raise ValueError("BMP 16-bit masks "
                             f"{tuple(hex(m) for m in masks)} are not read")
        px = _bgr_words(v, [(m, (m & -m).bit_length() - 1) for m in masks])
    elif bpp == 32:
        v = rows[:, :w * 4].copy().view("<u4").reshape(h, w)
        masks = (struct.unpack_from("<III", data, 14 + 40) if comp == 3
                 else (0xFF0000, 0xFF00, 0xFF))
        chans = []
        for mask in masks:
            shift = (mask & -mask).bit_length() - 1
            if mask >> shift != 0xFF:
                raise ValueError(f"BMP bit mask 0x{mask:08X} is not read")
            chans.append((v >> shift) & 0xFF)
        px = np.stack(chans, -1).astype(np.uint8)
    elif bpp in (1, 4, 8):
        n_pal = n_pal or (1 << bpp)
        pal = np.frombuffer(data, np.uint8, n_pal * pal_bytes,
                            14 + hsize).reshape(n_pal, pal_bytes)[:, 2::-1]
        if rows is None:
            idx = _bmp_rle(data, off, w, h, comp == 2)
        else:
            bits = np.unpackbits(rows, axis=1).reshape(h, -1, bpp)
            idx = (bits * (1 << np.arange(bpp - 1, -1, -1))).sum(-1)[:, :w]
        px = pal[np.minimum(idx, n_pal - 1)]
    else:
        raise ValueError(f"{bpp}-bit BMP is not read")
    if not top_down:
        px = px[::-1]
    return np.ascontiguousarray(px)


# the header sizes PIL's DIB plugin accepts (BmpImagePlugin._dib_accept)
DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)


def is_dib(data: bytes) -> bool:
    """PIL's test of a DIB (a BMP without its 14-byte file header): the
    little-endian u32 at offset 0 is one of DIB_HEADERS."""
    return len(data) >= 4 and struct.unpack_from("<I", data)[0] in DIB_HEADERS


def decode_dib(data: bytes) -> np.ndarray:
    """A DIB's samples as decode_bmp gives a BMP's.  The pixels start where
    PIL's DibImageFile finds them: after the header, the three bit masks
    that follow a 40-byte header under BI_BITFIELDS, and, at 8 bits or
    fewer, the palette (3-byte entries after a 12-byte header, else 4;
    the header's colour count, else 1 << bits)."""
    if not is_dib(data) or len(data) < 16:
        raise ValueError("not a DIB file")
    hsize = struct.unpack_from("<I", data)[0]
    if hsize == 12:
        (bpp,) = struct.unpack_from("<H", data, 10)
        comp, n_pal, entry = 0, 0, 3
    else:
        bpp, comp = struct.unpack_from("<HI", data, 14)
        (n_pal,), entry = struct.unpack_from("<I", data, 32), 4
    off = hsize + (12 if comp == 3 and hsize == 40 else 0)
    if bpp <= 8:
        off += entry * (n_pal or 1 << bpp)
    head = struct.pack("<2sIHHI", b"BM", 14 + len(data), 0, 0, 14 + off)
    return decode_bmp(head + data)


def decode_gif(data: bytes) -> np.ndarray:
    """A GIF's first frame as colours, (H, W, 3) RGB or (H, W, 4) RGBA where
    it names a transparent index (alpha 0 there): the logical screen,
    filled with the transparent index (else 0) as PIL fills it, the frame
    decoded (LZW, variable code width) at its offset through its local or
    the global colour table (no table: the indices as gray), interlaced
    rows put back in order."""
    from .tiff import lzw_decode

    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    sw, sh, flags = struct.unpack_from("<HHB", data, 6)
    pos = 13
    gct = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        gct = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3)
        pos += 3 * n
    transparent = None
    while pos < len(data):
        block = data[pos]
        if block == 0x21:                           # extension
            label = data[pos + 1]
            pos += 2
            first = True
            while data[pos]:
                size = data[pos]
                if label == 0xF9 and first and size >= 4 and \
                        data[pos + 1] & 1:
                    transparent = data[pos + 4]
                first = False
                pos += 1 + size
            pos += 1
        elif block == 0x2C:                         # image descriptor
            x0, y0, fw, fh, fflags = struct.unpack_from("<HHHHB", data,
                                                        pos + 1)
            pos += 10
            table = gct
            if fflags & 0x80:
                n = 2 << (fflags & 7)
                table = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n,
                                                                          3)
                pos += 3 * n
            min_bits = data[pos]
            pos += 1
            parts = []
            while pos < len(data) and data[pos]:
                parts.append(data[pos + 1:pos + 1 + data[pos]])
                pos += 1 + data[pos]
            raw = lzw_decode(b"".join(parts), min_bits, msb=False, early=0,
                             limit=fw * fh)
            idx = np.zeros(fw * fh, np.uint8)
            got = np.frombuffer(raw[:fw * fh], np.uint8)
            idx[:len(got)] = got
            idx = idx.reshape(fh, fw)
            if fflags & 0x40:                       # interlaced
                order = np.concatenate([np.arange(0, fh, 8),
                                        np.arange(4, fh, 8),
                                        np.arange(2, fh, 4),
                                        np.arange(1, fh, 2)])
                deint = np.empty_like(idx)
                deint[order] = idx
                idx = deint
            screen = np.full((sh, sw), transparent or 0, np.uint8)
            x1, y1 = min(x0 + fw, sw), min(y0 + fh, sh)
            screen[y0:y1, x0:x1] = idx[:y1 - y0, :x1 - x0]
            if table is None:
                px = np.repeat(screen[:, :, None], 3, 2)
            else:
                px = table[np.minimum(screen, len(table) - 1)]
            if transparent is None:
                return np.ascontiguousarray(px)
            alpha = np.where(screen == transparent, 0, 255).astype(np.uint8)
            return np.concatenate([px, alpha[:, :, None]], -1)
        elif block == 0x3B:
            break
        else:
            raise ValueError(f"GIF: unknown block 0x{block:02X}")
    raise ValueError("GIF: no image")


_NETPBM = {b"P1": (1, True, False), b"P2": (1, False, False),
           b"P3": (3, False, False), b"P4": (1, True, True),
           b"P5": (1, False, True), b"P6": (3, False, True)}


def decode_netpbm(data: bytes) -> np.ndarray:
    """A PBM / PGM / PPM file (P1-P6, ASCII or binary), (H, W, C): bilevel
    as 0 / 255 uint8 (1 is black); maxval 255 as stored; a lower maxval
    scaled to 0..255 and a higher one to 0..65535 (uint16), each as PIL
    rounds, round(v / maxval * top).  PAM (P7) raises, as PIL refuses it."""
    magic = data[:2]
    if magic == b"P7":
        raise ValueError("PAM (P7) images are not read")
    if magic not in _NETPBM:
        raise ValueError("not a netpbm file")
    chans, bilevel, binary = _NETPBM[magic]
    pos, toks = 2, []
    need = 2 if bilevel else 3
    while len(toks) < need:
        m = re.compile(rb"(?:\s|#[^\n\r]*)*(\d+)").match(data, pos)
        if not m:
            raise ValueError("netpbm: bad header")
        toks.append(int(m.group(1)))
        pos = m.end()
    w, h = toks[:2]
    maxval = 1 if bilevel else toks[2]
    if not 0 < maxval < 65536:
        raise ValueError(f"netpbm: maxval {maxval} out of range")
    n = w * h * chans
    if binary:
        pos += 1                                    # one whitespace byte
        if bilevel:
            stride = (w + 7) // 8
            rows = np.frombuffer(data, np.uint8, stride * h, pos).reshape(
                h, stride)
            v = np.unpackbits(rows, axis=1)[:, :w].reshape(-1)
        else:
            dt = np.uint8 if maxval < 256 else np.dtype(">u2")
            v = np.frombuffer(data, dt, n, pos)
    else:
        body = re.sub(rb"#[^\n\r]*", b" ", data[pos:])
        if bilevel:
            v = np.frombuffer(re.sub(rb"[^01]", b"", body)[:n],
                              np.uint8) - ord("0")
        else:
            v = np.array(body.split()[:n], np.int64)
        if len(v) < n:
            raise ValueError("netpbm: truncated data")
    v = np.asarray(v, np.int64)
    if bilevel:
        return ((1 - v) * 255).astype(np.uint8).reshape(h, w, 1)
    if (v > maxval).any():
        raise ValueError("netpbm: sample above maxval")
    if maxval in (255, 65535):
        out = v
    else:
        top = 255 if maxval < 256 else 65535
        out = np.round(v / maxval * top)
    dt = np.uint8 if maxval < 256 else np.uint16
    return out.astype(dt).reshape(h, w, chans)


def decode_qoi(data: bytes, index_start: int = 0) -> np.ndarray:
    """A QOI file's samples, (H, W, 3) or (H, W, 4) uint8 by its header's
    channel count.  The 64-entry index takes every decoded pixel and
    starts with every entry the packed RGBA word index_start: 0 (all
    zero) as qoi.h and PIL start it, 0xFF (opaque black) as write_qoi and
    the reference's read_qoi do."""
    if data[:4] != b"qoif":
        raise ValueError("not a QOI file")
    w, h = struct.unpack_from(">II", data, 4)
    channels = data[12]
    if channels not in (3, 4):
        raise ValueError(f"QOI with {channels} channels is not read")
    n = w * h
    px = [0] * n                                    # packed RGBA words
    index = [index_start] * 64
    r = g = b = 0
    a = 255
    pos, i, end = 14, 0, len(data)
    while i < n:
        if pos >= end:
            raise ValueError("QOI: truncated data")
        b0 = data[pos]
        pos += 1
        if b0 == 0xFE:                              # RGB
            r, g, b = data[pos], data[pos + 1], data[pos + 2]
            pos += 3
        elif b0 == 0xFF:                            # RGBA
            r, g, b, a = data[pos], data[pos + 1], data[pos + 2], data[pos + 3]
            pos += 4
        elif b0 < 0x40:                             # index
            v = index[b0]
            r, g, b, a = v >> 24, (v >> 16) & 255, (v >> 8) & 255, v & 255
        elif b0 < 0x80:                             # diff
            r = (r + ((b0 >> 4) & 3) - 2) & 255
            g = (g + ((b0 >> 2) & 3) - 2) & 255
            b = (b + (b0 & 3) - 2) & 255
        elif b0 < 0xC0:                             # luma
            dg = (b0 & 0x3F) - 32
            b1 = data[pos]
            pos += 1
            r = (r + dg + (b1 >> 4) - 8) & 255
            g = (g + dg) & 255
            b = (b + dg + (b1 & 15) - 8) & 255
        else:                                       # run
            run = min((b0 & 0x3F) + 1, n - i)
            px[i:i + run] = [(r << 24) | (g << 16) | (b << 8) | a] * run
            i += run
            continue
        v = (r << 24) | (g << 16) | (b << 8) | a
        index[(r * 3 + g * 5 + b * 7 + a * 11) & 63] = v
        px[i] = v
        i += 1
    p = np.array(px, np.uint32).reshape(h, w)
    out = np.stack([p >> 24, (p >> 16) & 255, (p >> 8) & 255, p & 255],
                   -1).astype(np.uint8)
    return out[:, :, :channels]


# formats read_image names but does not read (their magic bytes)
_UNREAD_MAGIC = ((b"PF", "PFM"), (b"Pf", "PFM"))
_NETPBM_EXT = (".pbm", ".pgm", ".ppm", ".pnm")


def _decode_image(path: str, data: bytes) -> np.ndarray:
    """Samples (H, W, C) of a PNG, JPEG, BMP, DIB, TIFF (also BigTIFF),
    WebP, GIF, QOI, netpbm, AVIF (utils/avif.py), PCX, DCX, SGI, IM, DDS
    (uncompressed, palette and BC1-BC7), PSD, ICO, CUR, ICNS, JPEG 2000
    (JP2 or raw codestream), BLP, MSP, SPIDER, SUN raster, XBM, XPM, FITS,
    FLI / FLC, FTEX, GBR, IMT, IPTC, McIDAS, PhotoCD, PIXAR, XV thumbnail
    or (by its extension) TGA file, each recognised as PIL recognises it and, TGA aside, in
    PIL's order of plugins (an uncompressed TGA starts with CUR's magic
    bytes).  IMT, IPTC and PhotoCD files have no magic bytes at the start
    and GBR files a loose test: where PIL's plugin declines such a file
    the next is tried, as PIL tries it.  uint8 colours, uint16 for 16-bit
    samples, int32 for 32-bit integer ones (FITS, McIDAS), float32 for a
    float TIFF, SPIDER or FITS image; raises ValueError naming any other
    format."""
    from . import avif, image_read, image_read_more as more, jpeg2000
    from . import image_read_pil as pil

    ext = path.lower()
    if data[:8] == _PNG_MAGIC:
        return decode_png(data)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    if data[:2] == b"BM":
        return decode_bmp(data)
    if is_dib(data):
        return decode_dib(data)
    if data[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        from .tiff import decode_tiff

        return decode_tiff(data)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        from .webp import decode_webp

        return decode_webp(data)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return decode_gif(data)
    if data[:4] == b"qoif":
        return decode_qoi(data)
    if ext.endswith(".tga"):
        return decode_tga(data)
    # PIL's PPM plugin does not take P7 (PAM), which the netpbm reader
    # reads: the XV thumbnail, PIL's last plugin, is tested before it
    if data[:6] == pil.XV_MAGIC:
        return pil.decode_xvthumb(data)
    if data[:1] == b"P" and data[1:2] in b"1234567" and len(data) > 2 and (
            data[2:3].isspace() or ext.endswith(_NETPBM_EXT)):
        return decode_netpbm(data)
    # PIL's AVIF plugin comes first of those not pre-initialised
    if avif.is_avif(data) and (px := pil.attempt(avif.decode_avif,
                                                 data)) is not None:
        return px
    if data[:4] in (b"BLP1", b"BLP2"):
        return more.decode_blp(data)
    if image_read.is_pcx(data):
        return image_read.decode_pcx(data)
    if data[:4] == pil.DCX_MAGIC:
        return pil.decode_dcx(data)
    if data[:2] == b"\x01\xda":
        return image_read.decode_sgi(data)
    if data[:4] == b"DDS ":
        return image_read.decode_dds(data)
    if data[:6] == b"SIMPLE" and (px := pil.attempt(pil.decode_fits,
                                                   data)) is not None:
        return px
    if pil.is_fli(data) and (px := pil.attempt(pil.decode_fli,
                                               data)) is not None:
        return px
    if data[:4] == b"FTEX":
        return pil.decode_ftex(data)
    if pil.is_gbr(data) and (px := pil.attempt(pil.decode_gbr,
                                               data)) is not None:
        return px
    if image_read.is_im(data):
        return image_read.decode_im(data)
    if (px := pil.attempt(pil.decode_imt, data)) is not None:
        return px
    if data[:1] == b"\x1c" and (px := pil.attempt(pil.decode_iptc,
                                                  data)) is not None:
        return px
    if data[:8] == pil.MCIDAS_MAGIC:
        return pil.decode_mcidas(data)
    if data[:4] == b"8BPS":
        return image_read.decode_psd(data)
    if data[:4] == b"\0\0\1\0":
        return image_read.decode_ico(data)
    if data[:4] == b"\0\0\2\0":
        return image_read.decode_cur(data)
    if data[:4] == b"icns":
        return image_read.icns_array(data)
    if data[:12] == jpeg2000.JP2_MAGIC:
        return jpeg2000.decode_jp2(data)
    if data[:4] == jpeg2000.J2K_MAGIC:
        return jpeg2000.decode_j2k(data)
    if data[:4] in (b"DanM", b"LinS"):
        return more.decode_msp(data)
    if pil.is_pcd(data):
        return pil.decode_pcd(data)
    if data[:4] == pil.PIXAR_MAGIC:
        return pil.decode_pixar(data)
    if more.spider_header(data) is not None:
        return more.decode_spider(data)
    if data[:4] == more.SUN_MAGIC:
        return more.decode_sun(data)
    if more.is_xbm(data):
        return more.decode_xbm(data)
    if data[:9] == b"/* XPM */":
        return more.decode_xpm(data)
    for magic, name in _UNREAD_MAGIC:
        if data.startswith(magic):
            raise ValueError(f"{path}: {name} images are not read")
    raise ValueError(f"{path}: not an EXR, PNG, JPEG, BMP, DIB, TIFF, WebP, "
                     "GIF, QOI, netpbm, AVIF, PCX, DCX, SGI, IM, DDS, PSD, "
                     "ICO, CUR, ICNS, JPEG 2000, BLP, MSP, SPIDER, SUN, XBM, "
                     "XPM, FITS, FLI, FTEX, GBR, IMT, IPTC, McIDAS, PhotoCD, "
                     "PIXAR, XV thumbnail or TGA image")


def read_image(path: str):
    """Generic loader -> (rgb (H, W, 3) float32, attrs dict): EXR by the
    reader above; PNG, JPEG, BMP, DIB, TIFF (also BigTIFF), WebP, GIF, QOI,
    netpbm, AVIF, PCX, DCX, SGI, IM, DDS (uncompressed, palette and
    BC1-BC7), PSD, ICO, CUR, ICNS, JPEG 2000 (JP2 and raw codestream), BLP, MSP,
    SPIDER, SUN raster, XBM, XPM, FITS, FLI / FLC, FTEX, GBR, IMT, IPTC,
    McIDAS, PhotoCD, PIXAR, XV thumbnail and TGA decoded here (by
    _decode_image, in PIL's order of plugins; TGA by its extension), their
    colours (palettes expanded, bilevel images 0 / 255, gray repeated,
    alpha dropped) by png_unit's rule for the samples' dtype: uint8 over
    255, uint16 over 65535 and int32 (PIL's mode I: FITS BITPIX 32,
    4-byte McIDAS) over 2**31 - 1, then sRGB -> linear (Image::Read's
    LinearColorEncoding handling, util/image.cpp); a float TIFF, SPIDER
    or FITS image is kept as stored, as EXR and PFM are.  Other formats
    raise, naming the format."""
    if path.endswith(".exr"):
        img, _names, attrs = read_exr(path)
        return np.asarray(img[:, :, :3], np.float32), attrs
    with open(path, "rb") as f:
        data = f.read()
    px = _decode_image(path, data)
    x = px.astype(np.float32) if px.dtype == np.float32 else png_unit(px)
    if x.shape[2] < 3:                  # gray (+ alpha)
        x = np.repeat(x[:, :, :1], 3, axis=2)
    x = x[:, :, :3]
    if px.dtype == np.float32:
        return np.ascontiguousarray(x), {}
    lin = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    return lin.astype(np.float32), {}


# ---------------------------------------------------------------------------
# PFM (portable float map) — util/image.cpp ReadPFM/WritePFM
# ---------------------------------------------------------------------------

def write_pfm(path: str, rgb: np.ndarray):
    """Write (H, W, 3) or (H, W) float32 as binary PFM (bottom-up rows,
    little-endian scale=-1, matching the reference's WritePFM)."""
    a = np.asarray(rgb, np.float32)
    color = a.ndim == 3 and a.shape[2] == 3
    hdr = b"PF\n" if color else b"Pf\n"
    h, w = a.shape[:2]
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.000000\n")
        f.write(np.ascontiguousarray(a[::-1]).tobytes())


def read_pfm(path: str):
    """Read a PFM -> (H, W, 3) or (H, W) float32."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] not in (b"PF", b"Pf"):
        raise ValueError(f"{path}: not a PFM file")
    color = data[:2] == b"PF"
    # header = 3 whitespace-delimited tokens
    pos = 2
    toks = []
    while len(toks) < 3:
        while data[pos] in b" \t\r\n":
            pos += 1
        start = pos
        while data[pos] not in b" \t\r\n":
            pos += 1
        toks.append(data[start:pos])
    pos += 1      # single whitespace after the scale
    w, h = int(toks[0]), int(toks[1])
    scale = float(toks[2])
    count = w * h * (3 if color else 1)
    dt = "<f4" if scale < 0 else ">f4"
    a = np.frombuffer(data, dt, count, pos).astype(np.float32)
    a = a.reshape(h, w, 3) if color else a.reshape(h, w)
    if abs(scale) != 1.0:
        a = a * abs(scale)
    return a[::-1].copy()


# ---------------------------------------------------------------------------
# QOI ("quite ok image") — ext/qoi, util/image.cpp QOI leg (8-bit sRGB)
# ---------------------------------------------------------------------------

def write_qoi(path: str, rgb: np.ndarray, linear_input: bool = True):
    """Encode (H, W, 3) to QOI.  linear_input: apply sRGB transfer first
    (the reference stores 8-bit formats sRGB-encoded)."""
    x = np.asarray(rgb, np.float32)
    if linear_input:
        x = np.where(x <= 0.0031308, 12.92 * x,
                     1.055 * np.power(np.maximum(x, 1e-8), 1 / 2.4) - 0.055)
    px = (np.clip(x, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    h, w = px.shape[:2]
    out = bytearray()
    out += b"qoif"
    out += w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([3, 0])
    index = [(0, 0, 0, 255)] * 64
    prev = (0, 0, 0, 255)
    run = 0
    flat = px.reshape(-1, 3)
    for r, g, b in flat:
        cur = (int(r), int(g), int(b), 255)
        if cur == prev:
            run += 1
            if run == 62:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        idx = (cur[0] * 3 + cur[1] * 5 + cur[2] * 7 + 255 * 11) % 64
        if index[idx] == cur:
            out.append(idx)
        else:
            index[idx] = cur
            dr = (cur[0] - prev[0]) & 0xFF
            dg = (cur[1] - prev[1]) & 0xFF
            db = (cur[2] - prev[2]) & 0xFF
            dr = dr - 256 if dr > 127 else dr
            dg = dg - 256 if dg > 127 else dg
            db = db - 256 if db > 127 else db
            if -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
                out.append(0x40 | ((dr + 2) << 4) | ((dg + 2) << 2)
                           | (db + 2))
            elif (-32 <= dg <= 31 and -8 <= dr - dg <= 7
                  and -8 <= db - dg <= 7):
                out.append(0x80 | (dg + 32))
                out.append(((dr - dg + 8) << 4) | (db - dg + 8))
            else:
                out.append(0xFE)
                out += bytes(cur[:3])
        prev = cur
    if run:
        out.append(0xC0 | (run - 1))
    out += b"\x00\x00\x00\x00\x00\x00\x00\x01"
    with open(path, "wb") as f:
        f.write(bytes(out))


def read_qoi(path: str, to_linear: bool = True):
    """Decode a QOI file -> (H, W, 3) float32 (linear if to_linear)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"qoif":
        raise ValueError(f"{path}: not a QOI file")
    # write_qoi's index starts opaque black: files it writes index black
    # (slot 53) before any black pixel has been seen
    x = decode_qoi(data, 0xFF)[:, :, :3].astype(np.float32) / 255.0
    if to_linear:
        x = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    return x.astype(np.float32)
