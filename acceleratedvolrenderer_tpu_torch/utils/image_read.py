"""Decoders of the formats utils/image.py's other readers do not cover:
PCX, SGI, IM, DDS, PSD, ICO, CUR and ICNS, numpy only.  Each gives the samples
PIL 12.1.0 gives for the file (the reference reads images through PIL),
as colours where PIL gives palette indices; the dispatch by magic bytes
is image.py::_decode_image's.

  - PCX: 1-bit (0 / 255), 1-bit in 2 or 4 planes (PIL's P;2L / P;4L
    through the header's 16-colour palette), 8-bit gray or palette (the
    256-entry VGA palette at the end, as PIL takes it: a linear gray one
    keeps the samples as stored) and 24-bit in three planes, run-length
    coded (PcxDecode.c, whose band shuffle for strides that do not divide
    the row is kept);
  - SGI: verbatim and RLE, 8- and 16-bit (PIL keeps a 16-bit sample's high
    byte), 1, 3 or 4 channels, rows bottom-up;
  - IM: PIL's text header; 1-bit (0 / 255), L, LA, RGB, RGBA (planar
    rows, bottom-up) and L with a colour lookup table (PIL's P: expanded
    to colours; a gray table keeps the samples, as PIL ignores it);
  - DDS: uncompressed, read by its bit masks (RGB, RGBA, BGR(A), any
    widths), luminance (8-bit), luminance with alpha (16-bit), a DX10
    header naming R8G8B8A8, 8-bit palette (RGBA colours) and the block
    formats PIL decodes (DXT1, DXT3, DXT5, BC4, BC5 and signed BC5 by
    FourCC; BC1-BC5, BC6H and BC7 by DX10 header) through utils/bcn.py.
    Others (DXT2, DXT4, BC4S, sRGB BC1-BC3, BC4 SNORM) raise, naming
    their format;
  - PSD: the merged image of 8-bit files (and 1-bit bitmaps), raw or
    PackBits, whatever their layers;
  - ICO: the entry PIL loads, PNG or bitmap (the AND mask or the 32-bit
    pixels' fourth byte as alpha); CUR: the entry PIL loads, its bitmap;
  - ICNS: the entry PIL loads (the largest size, by PIL's table of types):
    a PNG, or a JPEG 2000 (utils/jpeg2000.py) made RGBA, or the legacy
    RGB (it32, ih32, il32, is32: raw or PackBits-like runs per channel)
    with its 8-bit mask (t8mk, h8mk, l8mk, s8mk) as alpha where present.
"""
from __future__ import annotations

import re
import struct

import numpy as np

# ---------------------------------------------------------------------------
# PCX
# ---------------------------------------------------------------------------


def is_pcx(data: bytes) -> bool:
    """PIL's test: byte 0 is 10 and the version is 0, 2, 3 or 5."""
    return len(data) >= 2 and data[0] == 10 and data[1] in (0, 2, 3, 5)


def _pcx_tokens(a: np.ndarray):
    """(value, count) of each token of PCX run-length code a (uint8): a
    byte with both high bits set counts (its low 6 bits) copies of the
    next byte, any other byte is itself.  Which bytes start a token is
    found at once: the first of each stretch of bytes >= 0xC0 does, the
    next one of the stretch does not, and so on alternately; the byte
    after the stretch starts one where the stretch's last byte did not.
    A count in the last byte has no value and is dropped."""
    ctrl = a >= 0xC0
    prev = np.concatenate([[False], ctrl[:-1]])
    idx = np.arange(len(a))
    parity = (idx - np.maximum.accumulate(np.where(ctrl & ~prev, idx, 0))) & 1
    prev_parity = np.concatenate([[0], parity[:-1]])
    start = np.where(ctrl, parity == 0, ~prev | (prev_parity == 1))
    pos = np.flatnonzero(start & (~ctrl | (idx + 1 < len(a))))
    run = ctrl[pos]
    value = np.where(run, a[np.minimum(pos + 1, len(a) - 1)], a[pos])
    return value, np.where(run, a[pos] & 0x3F, 1)


def decode_pcx(data: bytes, offset: int = 0) -> np.ndarray:
    """The samples of a PCX file, or of the PCX image at offset in a DCX
    file (see the module docstring): (H, W, 1) for 1-bit and gray, (H, W,
    3) for 24-bit and palette files.  PIL takes an 8-bit image's palette
    from the end of the file, whatever the offset, and so does this."""
    head = data[offset:offset + 128]
    if not is_pcx(head) or len(head) < 128:
        raise ValueError("not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from("<4H", head, 4)
    w, h = x1 + 1 - x0, y1 + 1 - y0
    if w <= 0 or h <= 0:
        raise ValueError("PCX: bad image size")
    version, bits, planes = head[1], head[3], head[65]
    (provided,) = struct.unpack_from("<H", head, 66)
    palette = None
    if bits == 1 and planes == 1:
        kind = "1"
    elif bits == 1 and planes in (2, 4):
        kind = "planes"                 # PIL's P;2L / P;4L, 16 colours
        palette = np.frombuffer(head, np.uint8, 48, 16).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        kind = "L"
        tail = data[-769:]
        if len(tail) == 769 and tail[0] == 12:
            pal = np.frombuffer(tail, np.uint8, 768, 1).reshape(256, 3)
            if not (pal == np.arange(256)[:, None]).all():
                kind, palette = "P", pal
    elif version == 5 and bits == 8 and planes == 3:
        kind = "RGB"
    else:
        raise ValueError(f"PCX with {bits}-bit samples in {planes} planes "
                         f"(version {version}) is not read")
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    line = planes * stride
    value, count = _pcx_tokens(np.frombuffer(data, np.uint8,
                                             offset=offset + 128))
    ends = np.cumsum(count)
    if not len(ends) or ends[-1] < h * line:
        raise ValueError("PCX: truncated data")
    k = int(np.searchsorted(ends, h * line)) + 1
    value, count, ends = value[:k], count[:k], ends[:k]
    if ((count > 1) & ((ends - count) // line != (ends - 1) // line)).any():
        raise ValueError("PCX: a run crosses the end of a row")
    rows = np.repeat(value, count)[:h * line].reshape(h, line)
    # PcxDecode.c's band move (the planes of a P;2L / P;4L row move
    # together, as the planes case below reads them)
    if line % w and line > w and kind != "planes":
        bands = line // w
        step = line // bands
        for i in range(1, bands):
            rows[:, i * w:(i + 1) * w] = rows[:, i * step:i * step + w].copy()
    if kind == "1":
        bits_ = np.unpackbits(rows, axis=1)[:, :w]
        return (bits_ * 255).astype(np.uint8)[..., None]
    if kind == "RGB":
        return np.ascontiguousarray(
            rows[:, :3 * w].reshape(h, 3, w).transpose(0, 2, 1))
    if kind == "planes":
        # PcxDecode.c moves each plane's first (w + 7) // 8 bytes together
        # and Unpack.c's P;2L / P;4L read them: plane p, bit p
        idx = sum(np.unpackbits(rows[:, p * stride:(p + 1) * stride],
                                axis=1)[:, :w] << p for p in range(planes))
        return palette[idx]
    idx = rows[:, :w]
    return palette[idx] if palette is not None else idx[..., None]


# ---------------------------------------------------------------------------
# SGI
# ---------------------------------------------------------------------------

# (bytes per sample, dimension, channels) PIL reads
_SGI_MODES = {(1, 1, 1), (1, 2, 1), (2, 1, 1), (2, 2, 1), (1, 3, 3),
              (2, 3, 3), (1, 3, 4), (2, 3, 4)}


def _sgi_rle_row(src: bytes, pos: int, n: int, w: int, bpc: int):
    """One RLE row of an SGI channel from src at pos, as SgiRleDecode.c's
    expandrow / expandrow2 read it: at most n packets (n the row's length
    in the length table), each a control unit (a byte, or a big-endian
    word whose low byte counts) whose low 7 bits count and whose high bit
    copies that many units, else repeats the next one; 0 ends the row."""
    dt = ">u2" if bpc == 2 else np.uint8
    units = np.frombuffer(src, dt, (len(src) - pos) // bpc, pos)
    out = np.zeros(w, np.int64)
    x = i = 0
    for k in range(n, 0, -1):
        if i >= len(units):
            raise ValueError("SGI: truncated RLE row")
        ctrl = int(units[i]) & 0xFF
        i += 1
        if k == 1 and ctrl:
            raise ValueError("SGI: an RLE row does not end")
        count = ctrl & 0x7F
        if not count:
            break
        if x + count > w:
            raise ValueError("SGI: a run overruns its row")
        if ctrl & 0x80:
            if i + count > len(units):
                raise ValueError("SGI: truncated RLE row")
            out[x:x + count] = units[i:i + count]
            i += count
        else:
            if i >= len(units):
                raise ValueError("SGI: truncated RLE row")
            out[x:x + count] = units[i]
            i += 1
        x += count
    return out


def decode_sgi(data: bytes) -> np.ndarray:
    """An SGI file's samples, (H, W, Z) uint8 for Z 1, 3 or 4 channels
    (see the module docstring)."""
    if len(data) < 512 or struct.unpack_from(">h", data)[0] != 474:
        raise ValueError("not an SGI file")
    rle, bpc = data[2], data[3]
    dim, w, h, z = struct.unpack_from(">4H", data, 4)
    if (bpc, dim, z) not in _SGI_MODES:
        raise ValueError(f"SGI with {bpc} bytes per sample, dimension {dim}, "
                         f"{z} channels is not read")
    if rle == 0:
        dt = ">u2" if bpc == 2 else np.uint8
        if len(data) < 512 + w * h * z * bpc:
            raise ValueError("SGI: truncated data")
        v = np.frombuffer(data, dt, w * h * z, 512).reshape(z, h, w)
    elif rle == 1:
        tabs = np.frombuffer(data, ">u4", 2 * h * z, 512).reshape(2, z, h)
        v = np.stack([np.stack([
            _sgi_rle_row(data, int(tabs[0, c, r]), int(tabs[1, c, r]), w, bpc)
            for r in range(h)]) for c in range(z)])
    else:
        raise ValueError(f"SGI with compression {rle} is not read")
    v = v.astype(np.int64) >> (8 * (bpc - 1))     # a word's high byte
    return np.ascontiguousarray(v.astype(np.uint8).transpose(1, 2, 0)[::-1])


# ---------------------------------------------------------------------------
# IM (IFUNC Image Memory)
# ---------------------------------------------------------------------------

_IM_TAGS = ("Comment", "Date", "Digitalization equipment",
            "File size (no of images)", "Lut", "Name", "Scale (x,y)",
            "Image size (x*y)", "Image type")
_IM_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
# image type -> channels, planar rows (0: one bit per sample)
_IM_KINDS = {"0 1 image": 0, "L 1 image": 0, "B1 image": 0,
             "Greyscale image": 1, "Grayscale image": 1, "LA image": 2,
             "RGB image": 3, "RGBA image": 4}


def is_im(data: bytes) -> bool:
    """An IM header starts with one of its tags."""
    return any(data.startswith(t.encode() + b":") for t in _IM_TAGS)


def decode_im(data: bytes) -> np.ndarray:
    """An IM file's first frame, (H, W, C) uint8 (see the module
    docstring)."""
    info, pos = {}, 0
    while pos < len(data):
        c = data[pos:pos + 1]
        if c == b"\r":
            pos += 1
            continue
        if c in (b"", b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s = data[pos:end]
        pos = end
        if len(s) > 100:
            raise ValueError("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s.rstrip(b"\n")
        m = _IM_LINE.match(s)
        if not m:
            raise ValueError(f"IM: syntax error in the header: {s!r}")
        info[m.group(1).decode("latin-1")] = m.group(2).decode("latin-1")
    if not any(t in info for t in _IM_TAGS):
        raise ValueError("not an IM file")
    kind = info.get("Image type", "Greyscale image")
    if kind not in _IM_KINDS:
        raise ValueError(f"IM images of type {kind!r} are not read")
    w, h = (int(v) for v in info.get("Image size (x*y)", "512*512").split(
        "*"))
    start = data.find(b"\x1a", pos)
    if start < 0:
        raise ValueError("IM: truncated header")
    pos = start + 1
    palette = None
    if "Lut" in info:
        lut = np.frombuffer(data, np.uint8, 768, pos).reshape(3, 256).T
        pos += 768
        gray = (lut == lut[:, :1]).all()
        if _IM_KINDS[kind] == 1 and not gray:
            palette = lut
    c = _IM_KINDS[kind]
    if c == 0:
        stride = (w + 7) // 8
        if len(data) < pos + stride * h:
            raise ValueError("IM: truncated data")
        rows = np.frombuffer(data, np.uint8, stride * h, pos).reshape(h, -1)
        bits = np.unpackbits(rows, axis=1)[::-1, :w]
        return np.ascontiguousarray(bits * np.uint8(255))[..., None]
    if len(data) < pos + w * h * c:
        raise ValueError("IM: truncated data")
    rows = np.frombuffer(data, np.uint8, w * h * c, pos).reshape(h, c, w)
    px = np.ascontiguousarray(rows.transpose(0, 2, 1)[::-1])
    return palette[px[..., 0]] if palette is not None else px


# ---------------------------------------------------------------------------
# DDS
# ---------------------------------------------------------------------------

_DDPF_ALPHA, _DDPF_FOURCC, _DDPF_PALETTE = 0x1, 0x4, 0x20
_DDPF_RGB, _DDPF_LUMINANCE = 0x40, 0x20000
_DXGI_RGBA8 = (27, 28, 29)
# the FourCCs and DXGI formats PIL decodes as blocks (utils/bcn.py's kinds)
_BLOCK_FOURCCS = {"DXT1": "BC1", "DXT3": "BC2", "DXT5": "BC3", "BC4U": "BC4",
                  "ATI1": "BC4", "BC5U": "BC5", "ATI2": "BC5", "BC5S": "BC5S"}
_DXGI_BLOCKS = {70: "BC1", 71: "BC1", 73: "BC2", 74: "BC2", 76: "BC3",
                77: "BC3", 79: "BC4", 80: "BC4", 82: "BC5", 83: "BC5",
                84: "BC5S", 95: "BC6H", 96: "BC6HS", 97: "BC7", 98: "BC7",
                99: "BC7"}
# block formats PIL does not decode, named in the error
_DXGI_UNREAD = {72: "BC1_UNORM_SRGB", 75: "BC2_UNORM_SRGB",
                78: "BC3_UNORM_SRGB", 81: "BC4_SNORM", 94: "BC6H_TYPELESS"}


def _mask_channel(v: np.ndarray, mask: int) -> np.ndarray:
    """A channel of packed pixels v by its bit mask, scaled to 8 bits as
    PIL's DdsRgbDecoder scales it: int(value / mask_max * 255)."""
    if not mask:
        return np.zeros(v.shape, np.uint8)
    shift = (mask & -mask).bit_length() - 1
    top = mask >> shift
    x = (v & mask) >> shift
    return np.floor(x / top * 255).astype(np.uint8)


def decode_dds(data: bytes) -> np.ndarray:
    """A DDS file's first surface, (H, W, C) uint8 (see the module
    docstring); other pixel formats raise ValueError naming the format."""
    from . import bcn

    if data[:4] != b"DDS ":
        raise ValueError("not a DDS file")
    (size,) = struct.unpack_from("<I", data, 4)
    if size != 124 or len(data) < 128:
        raise ValueError(f"DDS: header size {size} is not read")
    h, w = struct.unpack_from("<2I", data, 12)
    pf_flags, fourcc, bitcount = struct.unpack_from("<3I", data, 80)
    masks = struct.unpack_from("<4I", data, 92)
    pos = 128
    if pf_flags & _DDPF_RGB:
        n = 4 if pf_flags & _DDPF_ALPHA else 3
        step = bitcount // 8
        if step < 1 or len(data) < pos + w * h * step:
            raise ValueError("DDS: truncated data")
        b = np.frombuffer(data, np.uint8, w * h * step, pos).reshape(
            -1, step).astype(np.int64)
        v = (b << (8 * np.arange(step))).sum(1)
        px = np.stack([_mask_channel(v, m) for m in masks[:n]], -1)
        return px.reshape(h, w, n)
    if pf_flags & _DDPF_LUMINANCE:
        if bitcount == 8:
            c = 1
        elif bitcount == 16 and pf_flags & _DDPF_ALPHA:
            c = 2
        else:
            raise ValueError(f"DDS: {bitcount}-bit luminance is not read")
    elif pf_flags & _DDPF_PALETTE:
        if len(data) < pos + 1024 + w * h:
            raise ValueError("DDS: truncated data")
        pal = np.frombuffer(data, np.uint8, 1024, pos).reshape(256, 4)
        idx = np.frombuffer(data, np.uint8, w * h, pos + 1024)
        return pal[idx].reshape(h, w, 4)
    elif pf_flags & _DDPF_FOURCC:
        name = struct.pack("<I", fourcc).decode("latin-1")
        if name in _BLOCK_FOURCCS:
            return bcn.decode(data, pos, w, h, _BLOCK_FOURCCS[name])
        if name != "DX10":
            raise ValueError(f"DDS of pixel format {name!r} is not read")
        (dxgi,) = struct.unpack_from("<I", data, 128)
        if dxgi in _DXGI_BLOCKS:
            return bcn.decode(data, 148, w, h, _DXGI_BLOCKS[dxgi])
        if dxgi not in _DXGI_RGBA8:
            name = _DXGI_UNREAD.get(dxgi, str(dxgi))
            raise ValueError(f"DDS of DXGI format {name} is not read")
        c, pos = 4, 148
    else:
        raise ValueError(f"DDS: pixel format flags {pf_flags:#x} are not read")
    if len(data) < pos + w * h * c:
        raise ValueError("DDS: truncated data")
    px = np.frombuffer(data, np.uint8, w * h * c, pos)
    return px.reshape(h, w, c).copy()


# ---------------------------------------------------------------------------
# PSD
# ---------------------------------------------------------------------------

# (colour mode, bits) -> PIL's mode and the channels it reads
_PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
              (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
              (7, 8): ("L", 1), (8, 8): ("L", 1)}
_PSD_NAMES = {0: "bitmap", 1: "grayscale", 2: "indexed", 3: "RGB",
              4: "CMYK", 7: "multichannel", 8: "duotone", 9: "LAB"}


def decode_psd(data: bytes) -> np.ndarray:
    """A PSD file's merged image, as PIL reads it: 8-bit gray (also
    multichannel and duotone, their first channel), indexed (the palette's
    colours, (H, W, 3)), RGB, RGBA (four channels), CMYK (converted as
    PIL's convert("RGB") converts) and 1-bit bitmap (0 / 255); raw or
    PackBits, the layers skipped.  LAB, 16- and 32-bit files raise."""
    from .image import cmyk_to_rgb
    from .tiff import packbits_decode

    if len(data) < 26 or data[:4] != b"8BPS" or \
            struct.unpack_from(">H", data, 4)[0] != 1:
        raise ValueError("not a PSD file")
    chans, h, w, bits, mode = struct.unpack_from(">HIIHH", data, 12)
    if (mode, bits) not in _PSD_MODES:
        raise ValueError(f"{bits}-bit {_PSD_NAMES.get(mode, mode)} PSD "
                         "images are not read")
    kind, n = _PSD_MODES[(mode, bits)]
    if n > chans:
        raise ValueError("PSD: not enough channels")
    if kind == "RGB" and chans == 4:
        kind, n = "RGBA", 4
    pos = 26
    (size,) = struct.unpack_from(">I", data, pos)
    palette = None
    if kind == "P":
        if size != 768:
            raise ValueError("PSD: indexed image without a 768-byte palette")
        palette = np.frombuffer(data, np.uint8, 768, pos + 4).reshape(3, 256).T
    pos += 4 + size
    for _ in range(2):                  # image resources, layers and masks
        pos += 4 + struct.unpack_from(">I", data, pos)[0]
    (comp,) = struct.unpack_from(">H", data, pos)
    pos += 2
    stride = (w + 7) // 8 if kind == "1" else w
    if comp == 0:
        if len(data) < pos + n * h * stride:
            raise ValueError("PSD: truncated data")
        planes = [np.frombuffer(data, np.uint8, h * stride, pos + c * w * h)
                  for c in range(n)]
    elif comp == 1:
        # PIL's table holds rows of the channels it reads, not of all the
        # file's: the data it reads starts right after them
        counts = np.frombuffer(data, ">u2", n * h, pos).astype(np.int64)
        starts = pos + 2 * n * h + np.concatenate(
            [[0], np.cumsum(counts.reshape(n, h).sum(1))])
        planes = []
        for c in range(n):
            # the channel's bytes by the table, else on past them, as PIL
            # reads them
            p = packbits_decode(data[starts[c]:starts[c + 1]], h * stride,
                                stride)
            if len(p) < h * stride:
                p = packbits_decode(data[starts[c]:], h * stride, stride)
            if len(p) < h * stride:
                raise ValueError("PSD: truncated data")
            planes.append(p)
    else:
        raise ValueError(f"PSD compression {comp} (ZIP) is not read")
    px = np.stack([p.reshape(h, stride) for p in planes], -1)
    if kind == "1":
        return np.unpackbits(px[..., 0], axis=1)[:, :w, None] * np.uint8(255)
    if kind == "P":
        return palette[px[..., 0]]
    if kind == "CMYK":
        return cmyk_to_rgb(255 - px)
    return np.ascontiguousarray(px)


# ---------------------------------------------------------------------------
# ICO and CUR
# ---------------------------------------------------------------------------


def _dib(data: bytes, offset: int):
    """The XOR image of the icon bitmap (a DIB, its height counting the
    AND mask too) at offset -> (decode_bmp's RGB samples, width, height,
    bits per pixel, the pixel data's offset)."""
    from .image import decode_bmp

    hsize, w, h2 = struct.unpack_from("<Iii", data, offset)
    if hsize < 40:
        raise ValueError(f"icon bitmap header of {hsize} bytes is not read")
    bpp, comp, n_pal = struct.unpack_from("<HI12xI", data, offset + 14)
    h = int(h2 / 2)
    masks = 12 if comp == 3 and hsize == 40 else 0
    pal = 4 * (n_pal or 1 << bpp) if bpp <= 8 else 0
    off = 14 + hsize + masks + pal
    dib = bytearray(data[offset:])
    struct.pack_into("<i", dib, 8, h)
    head = struct.pack("<2sIHHI", b"BM", 14 + len(dib), 0, 0, off)
    return decode_bmp(head + bytes(dib)), w, h, bpp, offset + off - 14


def decode_ico(data: bytes) -> np.ndarray:
    """The entry PIL's ICO reader loads: the largest, of those the lowest
    colour depth, the first of those.  A PNG entry decoded by decode_png;
    a bitmap as RGBA, its alpha the 32-bit pixels' fourth byte, else the
    AND mask's (0 where set), found where PIL finds it: at the end of the
    entry's stated size."""
    import math

    from .image import _PNG_MAGIC, decode_png

    (count,) = struct.unpack_from("<H", data, 4)
    entries = []
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        w, h, ncol = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (ncol != 0 and math.ceil(math.log(ncol, 2))) or 256
        entries.append((w * h, depth, bpp, size, offset))
    if not entries:
        raise ValueError("ICO: no images")
    entries = sorted(entries, key=lambda e: e[1])
    _, _, bpp, size, offset = sorted(entries, key=lambda e: e[0],
                                     reverse=True)[0]
    if data[offset:offset + 8] == _PNG_MAGIC:
        return decode_png(data[offset:])
    rgb, w, h, _, pix = _dib(data, offset)
    if bpp == 32:                       # the directory's depth, as in PIL
        raw = np.frombuffer(data, np.uint8, w * h * 4, pix)
        alpha = raw[3::4].reshape(h, w)[::-1]
    else:
        wp = -(-w // 32) * 32
        total = wp * h // 8
        rows = np.frombuffer(data, np.uint8, total,
                             offset + size - total).reshape(h, wp // 8)
        alpha = (1 - np.unpackbits(rows, axis=1)[::-1, :w]) * np.uint8(255)
    return np.concatenate([rgb, alpha[..., None]], -1)


def decode_cur(data: bytes) -> np.ndarray:
    """The cursor PIL's CUR reader loads: the first entry, or a later one
    larger in both stated sizes (the bytes, 0 counting as 0); its bitmap's
    XOR image as RGB, no alpha, but for a 32-bit bitmap at byte 22 (a
    file of one cursor), whose fourth bytes PIL's BMP reader takes as
    alpha.  A PNG entry raises, as in PIL."""
    from .image import _PNG_MAGIC

    (count,) = struct.unpack_from("<H", data, 4)
    m = None
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        if m is None or (s[0] > m[0] and s[1] > m[1]):
            m = s
    if m is None:
        raise ValueError("CUR: no cursors")
    (offset,) = struct.unpack_from("<I", m, 12)
    if data[offset:offset + 8] == _PNG_MAGIC:
        raise ValueError("CUR with a PNG image is not read")
    rgb, w, h, bpp, pix = _dib(data, offset)
    if offset != 22 or bpp != 32 or struct.unpack_from(
            "<I", data, offset + 16)[0] != 0:
        return rgb
    raw = np.frombuffer(data, np.uint8, w * h * 4, pix)
    return np.concatenate([rgb, raw[3::4].reshape(h, w)[::-1, :, None]], -1)


# ---------------------------------------------------------------------------
# ICNS
# ---------------------------------------------------------------------------

# IcnsImagePlugin's table: (width, height, scale) -> entry types in the
# order PIL reads them ("png": PNG or JPEG 2000, "rgb": legacy 24-bit,
# "rgb32t": the same behind 4 zero bytes, "mask": 8-bit alpha)
ICNS_TYPES = {
    (512, 512, 2): [(b"ic10", "png")],
    (512, 512, 1): [(b"ic09", "png")],
    (256, 256, 2): [(b"ic14", "png")],
    (256, 256, 1): [(b"ic08", "png")],
    (128, 128, 2): [(b"ic13", "png")],
    (128, 128, 1): [(b"ic07", "png"), (b"it32", "rgb32t"), (b"t8mk", "mask")],
    (64, 64, 1): [(b"icp6", "png")],
    (32, 32, 2): [(b"ic12", "png")],
    (48, 48, 1): [(b"ih32", "rgb"), (b"h8mk", "mask")],
    (32, 32, 1): [(b"icp5", "png"), (b"il32", "rgb"), (b"l8mk", "mask")],
    (16, 16, 2): [(b"ic11", "png")],
    (16, 16, 1): [(b"icp4", "png"), (b"is32", "rgb"), (b"s8mk", "mask")],
}


def _icns_rgb(data: bytes, start: int, length: int, n: int) -> np.ndarray:
    """A legacy entry's n samples of each of R, G, B: raw when it holds
    3 n bytes, else each channel in runs (a byte b < 128: b + 1 bytes
    follow; else the next byte b - 125 times)."""
    if length == 3 * n:
        return np.frombuffer(data, np.uint8, 3 * n, start).reshape(n, 3)
    planes, pos = [], start
    for _ in range(3):
        out, left = [], n
        while left > 0 and pos < len(data):
            b = data[pos]
            if b & 0x80:
                k = b - 125
                out.append(data[pos + 1:pos + 2] * k)
                pos += 2
            else:
                k = b + 1
                out.append(data[pos + 1:pos + 1 + k])
                pos += 1 + k
            left -= k
        if left != 0:
            raise ValueError(f"ICNS: error reading channel [{left} left]")
        planes.append(np.frombuffer(b"".join(out)[:n], np.uint8))
    return np.stack(planes, 1)


_PNG_MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}


def decode_icns(data: bytes):
    """(the samples PIL's ICNS reader loads, see the module docstring;
    their PIL mode: a PNG entry's own, RGBA for a JPEG 2000 one, RGB or,
    with a mask, RGBA for a legacy one)."""
    return _icns(data)[:2]


def _icns(data: bytes):
    """decode_icns's (samples, mode) and the fourth byte PIL keeps beside
    each RGB pixel: 255 where an unpacker made the image, 0 where a
    legacy entry's runs were put band by band into a new image."""
    from . import jpeg2000
    from .image import _PNG_MAGIC, decode_png

    (size,) = struct.unpack_from(">I", data, 4)
    blocks, i = {}, 8
    while i < size:
        sig, n = struct.unpack_from(">4sI", data, i)
        if n <= 0 or n > 0x7FFFFFFF:
            raise ValueError("ICNS: invalid block header")
        blocks[sig] = (i + 8, n - 8)
        i += n
    sizes = [s for s, kinds in ICNS_TYPES.items()
             if any(k in blocks for k, _ in kinds)]
    if not sizes:
        raise ValueError("ICNS: no 32-bit icon resources found")
    best = max(sizes)
    side = best[0] * best[2]
    got = {}
    for kind, how in ICNS_TYPES[best]:
        if kind not in blocks:
            continue
        start, length = blocks[kind]
        if how == "png":
            entry = data[start:start + length]
            if entry[:8] == _PNG_MAGIC:
                mode = _PNG_MODES.get(entry[25], "?")
                if mode == "L" and entry[24] == 16:
                    mode = "I;16"
                elif mode == "L" and entry[24] == 1:
                    mode = "1"
                got["RGBA"] = (decode_png(entry), mode, 255)
                continue
            if entry[:4] == jpeg2000.J2K_MAGIC:
                px = jpeg2000.decode_j2k(entry)
            elif entry[:12] == jpeg2000.JP2_MAGIC:
                px = jpeg2000.decode_jp2(entry)
            else:
                raise ValueError("ICNS: unsupported icon subimage format")
            if px.dtype != np.uint8:
                raise ValueError("ICNS: a JPEG 2000 entry of 16-bit samples "
                                 "is not read")
            if px.ndim == 2:
                px = px[..., None]
            c = px.shape[2]
            rgb = np.repeat(px[..., :1], 3, 2) if c <= 2 else px[..., :3]
            alpha = px[..., c - 1:] if c in (2, 4) else np.full(
                px.shape[:2] + (1,), 255, np.uint8)
            got["RGBA"] = (np.concatenate([rgb, alpha], 2), "RGBA", 255)
        elif how == "mask":
            got["A"] = np.frombuffer(data, np.uint8, side * side,
                                     start).reshape(side, side)
        else:
            if how == "rgb32t":
                if data[start:start + 4] != b"\0\0\0\0":
                    raise ValueError("ICNS: unknown signature, expecting "
                                     "0x00000000")
                start, length = start + 4, length - 4
            got["RGB"] = _icns_rgb(data, start, length,
                                   side * side).reshape(side, side, 3)
            pad = 255 if length == 3 * side * side else 0
    if "RGBA" in got:
        return got["RGBA"]
    if "A" in got:
        return (np.concatenate([got["RGB"], got["A"][..., None]], 2), "RGBA",
                255)
    return got["RGB"], "RGB", pad


def icns_array(data: bytes) -> np.ndarray:
    """What np.asarray(PIL.Image.open(file)) gives for an ICNS file, as the
    reference's read_image and imgtool's loader take it.  PIL opens an
    ICNS as RGBA and learns the entry's own mode only when the array's
    bytes load it, packed as RGBA all the same: an RGBA entry comes out
    right, an RGB one as its RGBX bytes regrouped in threes (a hazard of
    the reference, kept; X as _icns gives it), any other mode raises as
    PIL does."""
    px, mode, pad = _icns(data)
    if px.dtype == np.uint16:                   # PIL keeps the high byte
        px = (px >> 8).astype(np.uint8)
    if mode == "RGBA":
        return px
    if mode != "RGB":
        raise ValueError(f"No packer found from {mode} to RGBA")
    h, w = px.shape[:2]
    rgbx = np.concatenate([px, np.full((h, w, 1), pad, np.uint8)], 2)
    return rgbx.reshape(-1)[:h * w * 3].reshape(h, w, 3)
