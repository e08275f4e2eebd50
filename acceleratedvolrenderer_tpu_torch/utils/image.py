"""Image I/O and metrics (port of acceleratedvolrenderer_tpu/utils/image.py:
ImageMetadata, the ZIP-compressed scanline EXR writer write_exr, the
scanline EXR reader read_exr (NONE, RLE, ZIPS, ZIP and PIZ chunks),
read_image, write_png, mse / mrse / mae, PFM and QOI), numpy, struct and
zlib only: PNG files are written and read here too (8-bit gray, gray +
alpha, RGB and RGBA, non-interlaced).  EXR files are byte-identical to the
reference writer's.
"""
from __future__ import annotations

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


def encode_png(pixels: np.ndarray) -> bytes:
    """An 8-bit PNG of uint8 pixels (H, W) gray or (H, W, C) with C 1-4
    (gray, gray + alpha, RGB, RGBA); every row unfiltered (type 0)."""
    a = np.asarray(pixels, np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          a.reshape(h, w * c)], axis=1)
    return (_PNG_MAGIC
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
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


def write_png(path: str, rgb: np.ndarray, tonemap: bool = True):
    """An 8-bit PNG of a linear image: clipped to [0, 1], sRGB-encoded when
    tonemap (else stored as is), rounded to 8 bits."""
    rgb = np.asarray(rgb, np.float32)
    x = np.clip(rgb, 0.0, 1.0)
    if tonemap:
        x = np.where(x <= 0.0031308, 12.92 * x,
                     1.055 * np.power(np.maximum(x, 1e-8), 1 / 2.4) - 0.055)
    with open(path, "wb") as f:
        f.write(encode_png((x * 255.0 + 0.5).astype(np.uint8)))


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


def read_image(path: str):
    """Generic loader -> (rgb (H, W, 3) float32, attrs dict): EXR by the
    reader above; PNG decoded here, sRGB -> linear (Image::Read's
    LinearColorEncoding handling, util/image.cpp).  Other formats (JPEG
    among them) raise."""
    if path.endswith(".exr"):
        img, _names, attrs = read_exr(path)
        return np.asarray(img[:, :, :3], np.float32), attrs
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: only EXR and PNG images are read")
    x = png_unit(decode_png(data))
    if x.shape[2] < 3:                  # gray (+ alpha)
        x = np.repeat(x[:, :, :1], 3, axis=2)
    x = x[:, :, :3]
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
    w = int.from_bytes(data[4:8], "big")
    h = int.from_bytes(data[8:12], "big")
    channels = data[12]
    pos = 14
    n = w * h
    px = np.zeros((n, 4), np.uint8)
    index = [(0, 0, 0, 255)] * 64
    prev = (0, 0, 0, 255)
    i = 0
    while i < n:
        b0 = data[pos]
        pos += 1
        if b0 == 0xFE:                       # RGB
            prev = (data[pos], data[pos + 1], data[pos + 2], prev[3])
            pos += 3
        elif b0 == 0xFF:                     # RGBA
            prev = tuple(data[pos:pos + 4])
            pos += 4
        elif b0 >> 6 == 0:                   # index
            prev = index[b0]
        elif b0 >> 6 == 1:                   # diff
            dr = ((b0 >> 4) & 3) - 2
            dg = ((b0 >> 2) & 3) - 2
            db = (b0 & 3) - 2
            prev = ((prev[0] + dr) & 0xFF, (prev[1] + dg) & 0xFF,
                    (prev[2] + db) & 0xFF, prev[3])
        elif b0 >> 6 == 2:                   # luma
            dg = (b0 & 0x3F) - 32
            b1 = data[pos]
            pos += 1
            dr = dg + ((b1 >> 4) & 0xF) - 8
            db = dg + (b1 & 0xF) - 8
            prev = ((prev[0] + dr) & 0xFF, (prev[1] + dg) & 0xFF,
                    (prev[2] + db) & 0xFF, prev[3])
        else:                                # run
            runl = (b0 & 0x3F) + 1
            px[i:i + runl] = prev
            i += runl
            continue
        idx = (prev[0] * 3 + prev[1] * 5 + prev[2] * 7
               + prev[3] * 11) % 64
        index[idx] = prev
        px[i] = prev
        i += 1
    x = px[:, :3].reshape(h, w, 3).astype(np.float32) / 255.0
    if to_linear:
        x = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    return x.astype(np.float32)
