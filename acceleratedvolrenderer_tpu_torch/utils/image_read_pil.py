"""Decoders of the formats PIL 12.1.0 reads but does not write: DCX, PIXAR,
FTEX, GBR, XV thumbnails, McIDAS, IMT, FITS, IPTC, FLI / FLC and PhotoCD,
numpy only.  Each gives PIL's samples for the file (the reference reads
images through PIL), as colours where PIL gives palette indices, PIL's
quirks kept; the dispatch, in PIL's order of plugins, is image.py::
_decode_image's.

  - DCX (DcxImagePlugin): the page table, page 0 read as PCX at its offset
    (image_read.decode_pcx), an 8-bit page's palette taken from the end
    of the file, as PIL's PCX reader takes it;
  - PIXAR (PixarImagePlugin): raw RGB at byte 1024 when the header's
    channel words are (14, 2), the only mode PIL sets;
  - FTEX (FtexImagePlugin): one format, 1 raw RGB or 0 DXT1 blocks decoded
    as PIL's BcnDecode.c decodes them (utils/bcn.py), RGBA;
  - GBR (GbrImagePlugin): GIMP brushes v1 and v2, depth 1 (L) or 4 (RGBA);
  - XV thumbnail (XVThumbImagePlugin): `P7 332`, comment lines, the size
    line, then indices into PIL's 3-3-2 palette;
  - McIDAS (McIdasImagePlugin): the area directory's 64 big-endian words,
    1-, 2- and 4-byte samples (L, I;16B, I;32B as uint8, uint16, int32),
    rows at PIL's offset and stride;
  - IMT (ImtImagePlugin): PIL's line parser (`width`, `height`, `pixel
    n8`), raw L after the form feed;
  - FITS (FitsImagePlugin): the first HDU with an image (primary, IMAGE
    or any other extension read raw, or a GZIP_1 tile-compressed
    BINTABLE).  PIL reads the raw samples with rawmode equal to the mode,
    and so does this: BITPIX 16 as little-endian uint16 and 32 as
    little-endian int32 (the stored big-endian values byte-swapped),
    -32 as little-endian float32, -64 as little-endian float32 from the
    first half of the data; BZERO and BSCALE ignored; rows bottom first.
    A GZIP_1 table's tiles are gunzipped together and each pixel taken
    from the low min(ZBITPIX / 8, 4) bytes of a 4-byte word;
  - IPTC (IptcImagePlugin): the IIM records, the image in records 8:10,
    raw (PIL's PGM of the first w x h bytes) or JPEG (image.py's
    decode_jpeg); a 3- or 4-layer image (RGB, CMYK) holds that one gray
    plane in band record 3:65 minus 1 (band 0 without it), the others 0;
  - FLI / FLC (FliImagePlugin, FliDecode.c): frame 0, as np.asarray sees
    a fresh file, over the palette of frame 0's first COLOR_256 (4) or
    COLOR_64 (11, shifted left 2) chunk (gray without one); the chunks
    BLACK 13, BRUN 15, COPY 16, LC 12 and SS2 7 (colour and PSTAMP 18
    skipped); any other chunk type is refused, as PIL refuses it;
  - PhotoCD (PcdImagePlugin, PcdDecode.c): the 768x512 base image only, at
    96 * 2048: each pair of rows two luma rows, then C1 and C2 at half
    resolution, through PIL's YCC;P unpacker (_YCC_TABLES), turned by 90
    or 270 degrees when the orientation bits are 1 or 3.

Where PIL's plugin declines a file (its SyntaxError: PIL tries the next
plugin) the decoder raises Declined; what PIL refuses raises ValueError
naming the format and what is refused.
"""
from __future__ import annotations

import gzip
import re
import struct
import zlib

import numpy as np


class Declined(ValueError):
    """PIL's plugin does not take the file (its SyntaxError): PIL goes on
    to the next plugin, and so does image.py::_decode_image."""


def attempt(decode, data: bytes):
    """decode(data), or None where the decoder declines the file."""
    try:
        return decode(data)
    except Declined:
        return None


def _raw(data: bytes, offset: int, h: int, row: int, what: str,
         stride: int = 0) -> np.ndarray:
    """(h, row) uint8: h rows of `row` bytes at offset, `stride` apart (row
    when 0); raises as PIL's raw decoder does when the file is short."""
    stride = stride or row
    if offset < 0 or h <= 0 or offset + (h - 1) * stride + row > len(data):
        raise ValueError(f"{what}: image file is truncated")
    idx = offset + stride * np.arange(h)[:, None] + np.arange(row)
    return np.frombuffer(data, np.uint8)[idx]


# ---------------------------------------------------------------- DCX

DCX_MAGIC = struct.pack("<I", 0x3ADE68B1)


def decode_dcx(data: bytes) -> np.ndarray:
    """A DCX file's first page, as image_read.decode_pcx reads a PCX."""
    from .image_read import decode_pcx, is_pcx

    offsets = []
    for pos in range(4, 4 + 4 * 1024, 4):
        if pos + 4 > len(data):
            raise ValueError("DCX: the page table is truncated")
        (off,) = struct.unpack_from("<I", data, pos)
        if not off:
            break
        offsets.append(off)
    if not offsets:
        raise ValueError("DCX: no pages")
    if not is_pcx(data[offsets[0]:offsets[0] + 2]):
        raise ValueError(f"DCX: no PCX page at offset {offsets[0]}")
    return decode_pcx(data, offsets[0])


# ---------------------------------------------------------------- PIXAR

PIXAR_MAGIC = b"\x80\xe8\x00\x00"


def decode_pixar(data: bytes) -> np.ndarray:
    """A PIXAR file's RGB samples, (H, W, 3) uint8."""
    if len(data) < 512:
        raise ValueError("PIXAR: header is truncated")
    h, w = struct.unpack_from("<2H", data, 416)
    c, d = struct.unpack_from("<2H", data, 424)
    if (c, d) != (14, 2):
        raise ValueError(f"PIXAR: channel words ({c}, {d}) are not read "
                         "(only (14, 2), RGB)")
    if not w or not h:
        raise ValueError("PIXAR: empty image")
    return _raw(data, 1024, h, 3 * w, "PIXAR").reshape(h, w, 3)


# ---------------------------------------------------------------- FTEX


def decode_ftex(data: bytes) -> np.ndarray:
    """An FTEX texture's samples: (H, W, 3) for raw RGB, (H, W, 4) for
    DXT1."""
    from . import bcn

    if len(data) < 36:
        raise ValueError("FTEX: header is truncated")
    w, h, _mips, n_formats, fmt, where = struct.unpack_from("<6i", data, 8)
    if n_formats != 1:
        raise ValueError(f"FTEX: {n_formats} formats (PIL asserts one)")
    if w <= 0 or h <= 0:
        raise ValueError(f"FTEX: size {w}x{h}")
    if fmt not in (0, 1):
        raise ValueError(f"FTEX: invalid texture compression format {fmt}")
    if where < 0 or where + 4 > len(data):
        raise ValueError("FTEX: no mipmap at the format's offset")
    (size,) = struct.unpack_from("<i", data, where)
    payload = data[where + 4:] if size < 0 else \
        data[where + 4:where + 4 + size]
    if fmt == 1:
        return _raw(payload, 0, h, 3 * w, "FTEX").reshape(h, w, 3)
    if len(payload) < -(-w // 4) * -(-h // 4) * 8:
        raise ValueError("FTEX: image file is truncated")
    return bcn.decode(payload, 0, w, h, "BC1")


# ---------------------------------------------------------------- GBR


def is_gbr(data: bytes) -> bool:
    """PIL's test: a header size of 20 or more, then version 1 or 2."""
    return len(data) >= 8 and struct.unpack_from(">I", data)[0] >= 20 and \
        struct.unpack_from(">I", data, 4)[0] in (1, 2)


def decode_gbr(data: bytes) -> np.ndarray:
    """A GIMP brush's samples: (H, W, 1) for depth 1, (H, W, 4) RGBA for
    depth 4."""
    if len(data) < 20:
        raise Declined("GBR: header is truncated")
    size, version, w, h, depth = struct.unpack_from(">5I", data, 0)
    if size < 20 or version not in (1, 2) or not w or not h:
        raise Declined("not a GIMP brush")
    if depth not in (1, 4):
        raise Declined(f"GBR: color depth {depth}")
    if version == 2 and data[20:24] != b"GIMP":
        raise Declined("not a GIMP brush, bad magic number")
    # v2's comment is read from byte 28: a header shorter than that reads
    # the comment to the end of the file and leaves no samples
    start = size if version == 1 or size >= 28 else len(data)
    n = w * h * depth
    if start + n > len(data):
        raise ValueError("GBR: not enough image data")
    return np.frombuffer(data, np.uint8, n, start).reshape(h, w, depth)


# ---------------------------------------------------------------- XV

XV_MAGIC = b"P7 332"


def _readline(data: bytes, pos: int):
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def decode_xvthumb(data: bytes) -> np.ndarray:
    """An XV thumbnail's colours, (H, W, 3) uint8 of PIL's 3-3-2 palette."""
    _, pos = _readline(data, len(XV_MAGIC))
    while True:
        s, pos = _readline(data, pos)
        if not s:
            raise ValueError("XV thumbnail: unexpected end of file in the "
                             "header")
        if s[0] != 35:                          # not a '#' comment
            break
    words = s.strip().split(maxsplit=2)[:2]
    try:
        w, h = (int(v) for v in words)
    except ValueError:
        raise ValueError(f"XV thumbnail: bad size line {s!r}") from None
    if w <= 0 or h <= 0:
        raise ValueError(f"XV thumbnail: size {w}x{h}")
    v = _raw(data, pos, h, w, "XV thumbnail").astype(np.int32)
    return np.stack([(v >> 5) * 255 // 7, ((v >> 2) & 7) * 255 // 7,
                     (v & 3) * 255 // 3], -1).astype(np.uint8)


# ---------------------------------------------------------------- McIDAS

MCIDAS_MAGIC = b"\x00\x00\x00\x00\x00\x00\x00\x04"
_MCIDAS_TYPES = {1: ">u1", 2: ">u2", 4: ">i4"}


def decode_mcidas(data: bytes) -> np.ndarray:
    """A McIDAS area file's samples, (H, W, 1) uint8, uint16 or int32."""
    if len(data) < 256:
        raise ValueError("McIDAS: the area directory is truncated")
    w = (0,) + struct.unpack_from(">64i", data, 0)
    nb = w[11]
    if nb not in _MCIDAS_TYPES:
        raise ValueError(f"McIDAS: {nb}-byte samples are not read")
    width, height = w[10], w[9]
    if width <= 0 or height <= 0:
        raise ValueError(f"McIDAS: size {width}x{height}")
    row = width * nb
    stride = w[15] + w[10] * w[11] * w[14]
    if stride and stride < row:
        raise ValueError(f"McIDAS: line stride {stride} under the row's "
                         f"{row} bytes")
    rows = _raw(data, w[34] + w[15], height, row, "McIDAS", stride)
    dt = np.dtype(_MCIDAS_TYPES[nb])
    return rows.view(dt).astype(dt.newbyteorder("="))[..., None]


# ---------------------------------------------------------------- IMT

_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def decode_imt(data: bytes) -> np.ndarray:
    """An IM Tools file's samples, (H, W, 1) uint8: ImtImagePlugin's parser
    byte for byte (it has no magic: any file with a line feed in its first
    100 bytes is parsed)."""
    buffer, pos = data[:100], min(100, len(data))
    if b"\n" not in buffer:
        raise Declined("not an IMT file")
    xsize = ysize = 0
    mode, tile = "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s, pos = data[pos:pos + 1], min(pos + 1, len(data))
        if not s:
            break
        if s == b"\x0c":
            tile = pos - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += data[pos:pos + 100]
            pos = min(pos + 100, len(data))
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord("*"):
            continue                            # comment
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                xsize = int(v)
            elif k == b"height":
                ysize = int(v)
        except ValueError:
            raise ValueError(f"IMT: bad value {v!r} of {k.decode()}") \
                from None
        if k == b"pixel" and v == b"n8":
            mode = "L"
    if mode != "L" or xsize <= 0 or ysize <= 0:
        raise Declined("not an IMT file")
    if tile is None:
        raise ValueError("IMT: no image data (no form feed after the "
                         "header)")
    return _raw(data, tile, ysize, xsize, "IMT")[..., None]


# ---------------------------------------------------------------- FITS

# BITPIX -> the dtype PIL's rawmode reads (its mode's, little-endian)
_FITS_DTYPES = {8: "|u1", 16: "<u2", 32: "<i4", -32: "<f4", -64: "<f4"}


def _fits_size(headers, prefix):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _fits_hdu(headers):
    """(decoder, offset, size, BITPIX) of the cards read so far, as
    FitsImageFile._parse_headers finds them; None without an image."""
    prefix, decoder, offset = b"", "raw", 0
    try:
        if (headers.get(b"XTENSION") == b"'BINTABLE'"
                and headers.get(b"ZIMAGE") == b"T"
                and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
            w, h = _fits_size(headers, prefix) or (0, 0)
            offset = w * h * (int(headers[b"BITPIX"]) // 8)
            prefix, decoder = b"Z", "gzip"
        size = _fits_size(headers, prefix)
        if not size:
            return None
        return decoder, offset, size, int(headers[prefix + b"BITPIX"])
    except KeyError as e:
        raise Declined(f"FITS: no {e.args[0].decode()} card") from None
    except ValueError as e:
        raise ValueError(f"FITS: {e}") from None


def decode_fits(data: bytes) -> np.ndarray:
    """A FITS file's first image, (H, W, 1) of PIL's samples (see the
    module docstring): uint8, uint16, int32 or float32."""
    headers, in_header, hdu, pos = {}, False, None, 0
    while True:
        card = data[pos:pos + 80]
        pos += len(card)
        if not card:
            raise ValueError("FITS: truncated file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_header = True
        elif headers and not in_header:
            break                               # a data unit
        elif keyword == b"END":
            pos = -(-pos // 2880) * 2880
            if hdu is None:
                hdu = _fits_hdu(headers)
            in_header = False
            continue
        if hdu is not None:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (keyword != b"SIMPLE" or value != b"T"):
            raise Declined("not a FITS file")
        headers[keyword] = value
    if hdu is None:
        raise ValueError("FITS: no image data")
    decoder, offset, (w, h), bitpix = hdu
    if bitpix not in _FITS_DTYPES:
        raise ValueError(f"FITS: BITPIX {bitpix} is not read")
    if w <= 0 or h <= 0:
        raise ValueError(f"FITS: size {w}x{h}")
    dt = np.dtype(_FITS_DTYPES[bitpix])
    offset += pos - 80
    if decoder == "raw":
        rows = _raw(data, offset, h, w * dt.itemsize, "FITS")
    else:
        try:
            words = np.frombuffer(gzip.decompress(data[offset:]), np.uint8)
        except (OSError, EOFError, zlib.error) as e:
            raise ValueError(f"FITS: GZIP_1 tiles: {e}") from None
        nb = min(bitpix // 8, 4)
        if nb <= 0 or words.size < 4 * w * h:
            raise ValueError(f"FITS: not enough image data in the GZIP_1 "
                             f"tiles (ZBITPIX {bitpix})")
        rows = words[:4 * w * h].reshape(h, w, 4)[:, :, 4 - nb:].reshape(
            h, w * nb)
    px = rows[::-1].copy().view(dt).astype(dt.newbyteorder("="))
    return px[..., None]


# ---------------------------------------------------------------- IPTC


def _iptc_field(data: bytes, pos: int):
    """(tag, size, position after the field's header) of the IIM field at
    pos; tag None at the end (IptcImageFile.field)."""
    s = data[pos:pos + 5]
    pos += len(s)
    if not s.strip(b"\x00"):
        return None, 0, pos
    if len(s) < 5:
        raise Declined("IPTC: truncated field")
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise Declined("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise ValueError("IPTC: illegal field length")
    if size == 128:
        size = 0
    elif size > 128:
        n = size - 128
        size = int.from_bytes(data[pos:pos + n][-4:], "big")
        pos += n
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size, pos


def decode_iptc(data: bytes) -> np.ndarray:
    """An IPTC/NAA file's samples: (H, W, 1) for one layer, (H, W, 3) RGB
    or (H, W, 4) CMYK with the one plane in its band (see the module
    docstring)."""
    from .image import decode_jpeg

    info, pos = {}, 0
    while True:
        start = pos
        tag, size, pos = _iptc_field(data, pos)
        if not tag or tag == (8, 10):
            break
        value = data[pos:pos + size] if size else None
        pos += size
        if tag in info:
            info[tag] = (info[tag] if isinstance(info[tag], list)
                         else [info[tag]]) + [value]
        else:
            info[tag] = value

    def number(key):
        v = info.get(key)
        if not isinstance(v, bytes):
            raise Declined(f"IPTC: no record {key[0]}:{key[1]}")
        return int.from_bytes(v[-4:], "big")

    rec = info.get((3, 60))
    if not isinstance(rec, bytes) or len(rec) < 2:
        raise Declined("IPTC: no layers record 3:60")
    layers, component = rec[0], rec[1]
    band, bands = None, 1
    if not (layers == 1 and not component):
        bands = layers if component and layers in (3, 4) else 0
        band = 0
        if (3, 65) in info:
            if not isinstance(info[(3, 65)], bytes) or not info[(3, 65)]:
                raise Declined("IPTC: bad band record 3:65")
            band = info[(3, 65)][0] - 1
    w, h = number((3, 20)), number((3, 30))
    compression = {1: "raw", 5: "jpeg"}.get(number((3, 120)))
    if compression is None:
        raise ValueError("IPTC: unknown image compression "
                         f"{number((3, 120))}")
    if not bands or w <= 0 or h <= 0:
        raise Declined(f"IPTC: {layers} layers of {w}x{h}")
    if tag != (8, 10):
        raise ValueError("IPTC: no image records 8:10")
    body, pos = b"", start
    while True:
        try:
            tag, size, pos = _iptc_field(data, pos)
        except Declined as e:
            raise ValueError(str(e)) from None
        if tag != (8, 10):
            break
        body += data[pos:pos + size]
        pos += size
    if compression == "raw":
        plane = _raw(body, 0, h, w, "IPTC")
    else:
        if body[:2] != b"\xff\xd8":
            raise ValueError("IPTC: the JPEG image is not a JPEG")
        px = decode_jpeg(body)
        if px.shape[2] != 1 or px.shape[:2] != (h, w):
            raise ValueError(f"IPTC: a {px.shape[1]}x{px.shape[0]} JPEG of "
                             f"{px.shape[2]} channels in a {w}x{h} "
                             f"{bands}-layer image")
        plane = px[..., 0]
    if band is None:
        return plane[..., None]
    if not -bands <= band < bands:
        raise ValueError(f"IPTC: band {band} of {bands}")
    out = np.zeros((h, w, bands), np.uint8)
    out[..., band] = plane
    return out


# ---------------------------------------------------------------- FLI


def is_fli(data: bytes) -> bool:
    """PIL's test: the magic 0xAF11 / 0xAF12 and flags 0 or 3."""
    return len(data) >= 16 and struct.unpack_from("<H", data, 4)[0] in (
        0xAF11, 0xAF12) and struct.unpack_from("<H", data, 14)[0] in (0, 3)


def _fli_palette(data: bytes, pos: int, shift: int):
    """FliImageFile._palette: the colour chunk's packets over a gray
    ramp."""
    pal = np.repeat(np.arange(256, dtype=np.int64)[:, None], 3, 1)
    try:
        (count,) = struct.unpack_from("<H", data, pos)
        pos += 2
        i = 0
        for _ in range(count):
            i += data[pos]
            n = data[pos + 1] or 256
            pos += 2
            s = np.frombuffer(data[pos:pos + 3 * n], np.uint8)
            pos += 3 * n
            k = s.size // 3
            if s.size % 3 or (k and i + k > 256):
                raise IndexError
            pal[i:i + k] = (s[:3 * k].reshape(k, 3).astype(np.int64)
                            << shift) & 255
            i += k
    except (IndexError, struct.error):
        raise Declined("FLI: truncated colour chunk") from None
    return pal.astype(np.uint8)


def _fli_frame(buf: bytes, w: int, h: int) -> np.ndarray:
    """FliDecode.c over frame 0's bytes: the (h, w) indices."""
    out = np.zeros((h, w), np.uint8)
    n = len(buf)
    if n < 4 or n + n % 2 < struct.unpack_from("<I", buf, 0)[0]:
        raise ValueError("FLI: image file is truncated")
    if n < 8:
        raise ValueError("FLI: frame header is truncated")
    if struct.unpack_from("<H", buf, 4)[0] != 0xF1FA:
        raise ValueError("FLI: frame 0 is not a frame chunk")
    (chunks,) = struct.unpack_from("<H", buf, 6)
    ptr = 16
    for _ in range(chunks):
        if n - ptr < 10:
            raise ValueError("FLI: chunk header is truncated")
        kind = struct.unpack_from("<H", buf, ptr + 4)[0]
        _fli_chunk(kind, buf, ptr + 6, n, out)
        (advance,) = struct.unpack_from("<i", buf, ptr)
        if advance == 0:
            raise ValueError("FLI: chunk of size 0")
        if advance < 0 or advance > n - ptr:
            raise ValueError("FLI: chunk overruns the frame")
        ptr += advance
    return out


def _fli_chunk(kind, buf, d, end, out):
    """One chunk of FliDecode.c at buf[d:] (the frame ends at end)."""
    h, w = out.shape

    def need(k):
        if d + k > end:
            raise ValueError(f"FLI: chunk {kind} overruns the frame")

    if kind in (4, 11, 18):                     # colour, PSTAMP
        return
    if kind == 13:                              # BLACK
        out[:] = 0
    elif kind == 16:                            # COPY
        if d + w * h > end:
            raise ValueError("FLI: image file is truncated")
        out[:] = np.frombuffer(buf, np.uint8, w * h, d).reshape(h, w)
    elif kind == 15:                            # BRUN
        for y in range(h):
            d += 1                              # the packet count: unused
            x = 0
            while x < w:
                need(2)
                if buf[d] & 0x80:
                    i = 256 - buf[d]
                    if x + i > w:
                        break
                    need(i + 1)
                    out[y, x:x + i] = np.frombuffer(buf, np.uint8, i, d + 1)
                    d += i + 1
                else:
                    i = buf[d]
                    if x + i > w:
                        break
                    out[y, x:x + i] = buf[d + 1]
                    d += 2
                x += i
            if x != w:
                raise ValueError("FLI: BRUN row does not fill the width")
    elif kind == 12:                            # LC
        y, lines = struct.unpack_from("<HH", buf, d)
        ymax = y + lines
        d += 4
        while y < ymax and y < h:
            need(1)
            packets, p, x = buf[d], 0, 0
            d += 1
            while p < packets:
                need(2)
                x += buf[d]
                if buf[d + 1] & 0x80:
                    i = 256 - buf[d + 1]
                    if x + i > w:
                        break
                    need(3)
                    out[y, x:x + i] = buf[d + 2]
                    d += 3
                else:
                    i = buf[d + 1]
                    if x + i > w:
                        break
                    need(2 + i)
                    out[y, x:x + i] = np.frombuffer(buf, np.uint8, i, d + 2)
                    d += 2 + i
                p += 1
                x += i
            if p < packets:
                break
            y += 1
        if y < ymax:
            raise ValueError("FLI: LC lines overrun the image")
    elif kind == 7:                             # SS2
        (lines,) = struct.unpack_from("<H", buf, d)
        d += 2
        line = y = 0
        while line < lines and y < h:
            row = y
            need(2)
            (packets,) = struct.unpack_from("<H", buf, d)
            d += 2
            while packets & 0x8000:
                if packets & 0x4000:
                    y += 65536 - packets        # skip lines
                    if y >= h:
                        raise ValueError("FLI: SS2 skips past the image")
                    row = y
                else:                           # the last byte of a row
                    out[row, w - 1] = packets & 0xFF
                need(2)
                (packets,) = struct.unpack_from("<H", buf, d)
                d += 2
            p = x = 0
            while p < packets:
                need(2)
                x += buf[d]
                if buf[d + 1] >= 128:
                    need(4)
                    i = 256 - buf[d + 1]
                    if x + 2 * i > w:
                        break
                    out[row, x:x + 2 * i] = np.tile(
                        np.frombuffer(buf, np.uint8, 2, d + 2), i)
                    x += 2 * i
                    d += 4
                else:
                    i = 2 * buf[d + 1]
                    if x + i > w:
                        break
                    need(2 + i)
                    out[row, x:x + i] = np.frombuffer(buf, np.uint8, i, d + 2)
                    d += 2 + i
                    x += i
                p += 1
            if p < packets:
                break
            line += 1
            y += 1
        if line < lines:
            raise ValueError("FLI: SS2 lines overrun the image")
    else:
        raise ValueError(f"FLI: chunk type {kind} is not read")


def decode_fli(data: bytes) -> np.ndarray:
    """An FLI / FLC animation's frame 0 as colours, (H, W, 3) uint8."""
    s = data[:128]
    if not (is_fli(s) and s[20:22] == b"\0\0" and s[42:80] == bytes(38)
            and s[88:] == bytes(40)):
        raise Declined("not an FLI/FLC file")
    frames, w, h = struct.unpack_from("<3H", s, 6)
    if not frames or not w or not h or len(data) < 132:
        raise Declined("FLI: no frames")
    pos = 128
    head = data[pos:pos + 16]
    try:
        if struct.unpack_from("<H", head, 4)[0] == 0xF100:     # prefix
            pos = 128 + struct.unpack_from("<I", head, 0)[0]
            head = data[pos:pos + 16]
        pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        if struct.unpack_from("<H", head, 4)[0] == 0xF1FA:
            pos += 16
            size = None
            for _ in range(struct.unpack_from("<H", head, 6)[0]):
                if size is not None:
                    pos += size - 6
                kind = struct.unpack_from("<H", data, pos + 4)[0]
                if kind in (4, 11):
                    pal = _fli_palette(data, pos + 6, 2 if kind == 11 else 0)
                    break
                size = struct.unpack_from("<I", data, pos)[0]
                pos += 6
                if not size:
                    break
    except struct.error:
        raise Declined("FLI: truncated header chunk") from None
    (framesize,) = struct.unpack_from("<I", data, 128)
    return pal[_fli_frame(data[128:128 + framesize], w, h)]


# ---------------------------------------------------------------- PCD

PCD_OFFSET = 96 * 2048
_I = np.arange(256, dtype=np.int64)


def _trunc_div(n, q):
    return np.where(n >= 0, n // q, -((-n) // q))


# PIL's YCC;P unpacker (PhotoYCC in 8 bits) adds integer tables and clips:
# R = L[Y] + CR[C2], G = L[Y] + GR[C2] + GB[C1], B = L[Y] + CB[C1].  Its C
# source is not at hand: the tables were solved from PIL 12.1.0's decodes
# of every (Y, C1, C2), and each is the closed form below on all 256
# entries (the split of G's constant between GR and GB is this module's);
# tests/test_torch_image_formats_pil_only.py holds the conversion on
# every input
_YCC_TABLES = {"L": (235 * _I + 86) // 173,
               "CR": _trunc_div(51 * _I - 6973, 28),
               "CB": _trunc_div(621 * _I - 96736, 280),
               "GR": _trunc_div(12241 - 89 * _I, 96),
               "GB": _trunc_div(5815 - 37 * _I, 86)}


def ycc_to_rgb(y, c1, c2) -> np.ndarray:
    """PIL's YCC;P conversion of uint8 planes: (..., 3) uint8 RGB."""
    t = _YCC_TABLES
    lum = t["L"][y]
    rgb = np.stack([lum + t["CR"][c2], lum + t["GR"][c2] + t["GB"][c1],
                    lum + t["CB"][c1]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def is_pcd(data: bytes) -> bool:
    """PIL's test: `PCD_` at byte 2048, and the orientation byte there."""
    return len(data) >= 2048 + 1539 and data[2048:2052] == b"PCD_"


def decode_pcd(data: bytes) -> np.ndarray:
    """A PhotoCD file's base image, (512, 768, 3) uint8 RGB, or (768, 512,
    3) when its orientation turns it."""
    if not is_pcd(data):
        raise Declined("not a PCD file")
    rows = _raw(data, PCD_OFFSET, 256, 3 * 768, "PCD").reshape(256, 2304)
    y = rows[:, :1536].reshape(512, 768)
    c1, c2 = (np.repeat(np.repeat(rows[:, a:a + 384], 2, 0), 2, 1)
              for a in (1536, 1920))
    rgb = ycc_to_rgb(y, c1, c2)
    turn = {1: 1, 3: 3}.get(data[2048 + 1538] & 3, 0)
    return np.ascontiguousarray(np.rot90(rgb, turn))
