"""EXR output (port of acceleratedvolrenderer_tpu/utils/image.py: ImageMetadata
and the ZIP-compressed scanline writer write_exr), numpy, struct and zlib
only.  Files are byte-identical to the reference writer's."""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

_EXR_MAGIC = 0x01312F76
_HALF, _FLOAT = 1, 2      # pixel types
_ZIP = 3                  # compression id


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
