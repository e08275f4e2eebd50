"""Image I/O and metrics (port of acceleratedvolrenderer_tpu/utils/image.py:
ImageMetadata, the ZIP-compressed scanline EXR writer write_exr, the
scanline EXR reader read_exr (NONE, RLE, ZIPS, ZIP and PIZ chunks),
read_image, write_png, mse / mrse / mae, PFM and QOI), numpy, struct and
zlib only; PIL is imported by write_png and by read_image of a non-EXR
file, when they run.  Files are byte-identical to the reference writer's.
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

def write_png(path: str, rgb: np.ndarray, tonemap: bool = True):
    from PIL import Image as PILImage

    rgb = np.asarray(rgb, np.float32)
    if tonemap:
        x = np.clip(rgb, 0.0, 1.0)
        x = np.where(x <= 0.0031308, 12.92 * x, 1.055 * np.power(np.maximum(x, 1e-8), 1 / 2.4) - 0.055)
    else:
        x = np.clip(rgb, 0.0, 1.0)
    PILImage.fromarray((x * 255.0 + 0.5).astype(np.uint8)).save(path)


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
    """Generic loader -> (rgb (H, W, 3) float32, attrs dict).  EXR via the
    native reader; PNG/JPG via PIL with sRGB -> linear decode (matches
    Image::Read's LinearColorEncoding handling, util/image.cpp)."""
    if path.endswith(".exr"):
        img, _names, attrs = read_exr(path)
        return np.asarray(img[:, :, :3], np.float32), attrs
    from PIL import Image as PILImage

    x = np.asarray(PILImage.open(path), np.float32) / 255.0
    if x.ndim == 2:
        x = np.repeat(x[:, :, None], 3, axis=2)
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
