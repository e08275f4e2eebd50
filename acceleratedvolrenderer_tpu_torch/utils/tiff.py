"""TIFF decoding in numpy (no libtiff): the first image (IFD) of a little- or
big-endian file, classic or BigTIFF, in strips or tiles, uncompressed, LZW
(libtiff's current codes and its old-style, bit-reversed ones), Deflate or
PackBits, with the horizontal (8 and 16 bits) and floating-point
predictors, planar configuration 1 or 2; bilevel and gray (either
polarity), RGB, RGBA and other extra samples, palette, and CMYK.
JPEG-in-TIFF and every other compression raise, naming it.

decode_tiff(data) -> samples (H, W, C): uint8 for 1/2/4/8-bit images
(bilevel and sub-byte gray scaled to 0..255, palettes expanded to RGB as
PIL's convert("RGB") expands them, CMYK converted as PIL converts it),
uint16 for 16-bit ones and float32 for 32-bit IEEE floats.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from .image import cmyk_to_rgb

# bytes per value of the IFD field types (1-13; 16-18 are BigTIFF's)
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
_TYPE_CODE = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
              12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}
_COMPRESSION = {2: "CCITT modified Huffman", 3: "CCITT T.4 (fax)",
                4: "CCITT T.6 (fax)", 6: "old-style JPEG", 7: "JPEG",
                34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA",
                50000: "Zstandard", 50001: "WebP"}
(_WIDTH, _HEIGHT, _BITS, _COMPRESS, _PHOTOMETRIC, _FILL_ORDER, _STRIPS,
 _SPP, _ROWS_PER_STRIP, _STRIP_BYTES, _PLANAR, _PREDICTOR, _COLORMAP,
 _TILE_W, _TILE_H, _TILES, _TILE_BYTES, _SAMPLE_FORMAT) = (
    256, 257, 258, 259, 262, 266, 273, 277, 278, 279, 284, 317, 320, 322,
    323, 324, 325, 339)


def _ifd(data: bytes):
    """The first IFD's fields -> {tag: tuple of values}, of a classic TIFF
    (4-byte offsets, 12-byte entries) or a BigTIFF (8-byte offsets and
    counts, 20-byte entries, the 8-byte integer types 16-18)."""
    if data[:4] in (b"II*\0", b"II+\0"):
        bo = "<"
    elif data[:4] in (b"MM\0*", b"MM\0+"):
        bo = ">"
    else:
        raise ValueError("not a TIFF file")
    if data[2:4] in (b"+\0", b"\0+"):
        if struct.unpack_from(bo + "HH", data, 4) != (8, 0):
            raise ValueError("BigTIFF: bad header")
        off_fmt, count_fmt, entry, inline = "Q", "Q", 20, 8
        off = struct.unpack_from(bo + "Q", data, 8)[0]
    else:
        off_fmt, count_fmt, entry, inline = "I", "H", 12, 4
        off = struct.unpack_from(bo + "I", data, 4)[0]
    head = struct.calcsize(count_fmt)
    if off + head > len(data):
        raise ValueError("TIFF: truncated header")
    n = struct.unpack_from(bo + count_fmt, data, off)[0]
    fields = {}
    for i in range(n):
        tag, typ, count, value = struct.unpack_from(
            f"{bo}HH{off_fmt}{inline}s", data, off + head + entry * i)
        size = _TYPE_SIZE.get(typ)
        if size is None:
            continue                            # a type this reader skips
        raw = value if size * count <= inline else data[
            struct.unpack(bo + off_fmt, value)[0]:][:size * count]
        if len(raw) < size * count:
            raise ValueError(f"TIFF: field {tag} runs past the file")
        if typ in (2, 7):
            fields[tag] = (raw[:count],)
        elif typ in (5, 10):
            v = struct.unpack(bo + ("I" if typ == 5 else "i") * 2 * count,
                              raw[:8 * count])
            fields[tag] = tuple(v[2 * k] / v[2 * k + 1] if v[2 * k + 1]
                                else 0.0 for k in range(count))
        else:
            fields[tag] = struct.unpack(bo + _TYPE_CODE[typ] * count,
                                        raw[:size * count])
    return bo, fields


def _lzw_widths(min_bits: int, early: int) -> np.ndarray:
    """The width of each code after a clear code, while the table grows:
    code j (j >= 1 adds an entry) is read when the table holds
    clear + 2 + max(j - 1, 0) entries, and the width grows when that count
    reaches 2^n - early."""
    first = (1 << min_bits) + 2
    size = first + np.maximum(np.arange(4096 - first + 2) - 1, 0)
    nbits = np.full(len(size), min_bits + 1)
    for n in range(min_bits + 1, 12):
        nbits += size >= (1 << n) - early
    return nbits


def lzw_decode(data: bytes, min_bits: int = 8, msb: bool = True,
               early: int = 1, limit: int | None = None) -> bytes:
    """Variable-width LZW with a clear code (1 << min_bits) and an end code
    after it: TIFF's (min_bits 8, codes MSB first, the width growing one
    code early), TIFF's old-style and GIF's (LSB first, early 0).  A full
    table of 4096 entries stops growing (12-bit codes); decoding stops at
    the end code, the end of the data or `limit` output bytes.  The codes
    between two clear codes have known widths, so numpy cuts them out of
    the bit stream and only the table is built serially."""
    clear, eoi = 1 << min_bits, (1 << min_bits) + 1
    b = np.frombuffer(bytes(data) + b"\0" * 4, np.uint8).astype(np.int64)
    if msb:
        w = (b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]
    else:
        w = b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16) | (b[3:] << 24)
    end = 8 * len(data)

    def cut(starts, nb):
        if msb:
            return (w[starts >> 3] >> (32 - (starts & 7) - nb)) & (
                (1 << nb) - 1)
        return (w[starts >> 3] >> (starts & 7)) & ((1 << nb) - 1)

    widths = _lzw_widths(min_bits, early)
    offsets = np.concatenate([[0], np.cumsum(widths)])
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    limit = limit if limit is not None else 1 << 62
    out = []
    n_out, pos = 0, 0
    while n_out < limit:
        starts = pos + offsets[:-1]
        fits = starts + widths <= end
        codes = cut(starts[fits], widths[fits])
        stop = np.flatnonzero((codes == clear) | (codes == eoi))
        if len(stop):
            k = int(stop[0])
            seg, stop_code = codes[:k].tolist(), int(codes[k])
            after = int(starts[k] + widths[k])
        elif len(codes) == len(widths):         # a full table: 12-bit codes
            rest = pos + int(offsets[-1])
            more = cut(rest + 12 * np.arange((end - rest) // 12), 12)
            stop = np.flatnonzero((more == clear) | (more == eoi))
            k = int(stop[0]) if len(stop) else len(more)
            seg = codes.tolist() + more[:k].tolist()
            stop_code = int(more[k]) if len(stop) else eoi
            after = rest + 12 * (k + 1)
        else:                                   # the data ran out
            seg, stop_code, after = codes.tolist(), eoi, end
        if seg:
            if seg[0] >= clear:
                raise ValueError("LZW: bad first code")
            table = list(base)
            append = table.append
            prev = table[seg[0]]
            done = [prev]
            for code in seg[1:]:
                nxt = len(table)
                if code < nxt:
                    s = table[code]
                    if nxt < 4096:
                        append(prev + s[:1])
                elif code == nxt and nxt < 4096:
                    s = prev + prev[:1]
                    append(s)
                else:
                    raise ValueError("LZW: code out of range")
                done.append(s)
                prev = s
            chunk = b"".join(done)
            out.append(chunk)
            n_out += len(chunk)
        if stop_code == eoi:
            break
        pos = after
    return b"".join(out)


def _chain(nxt: np.ndarray) -> np.ndarray:
    """The nodes reached from node 0 by following nxt (each node's
    successor; the last node, the end, points to itself), found at once by
    pointer doubling: after round j every node within 2^(j+1) steps of
    node 0 is marked."""
    mark = np.zeros(len(nxt), bool)
    mark[0] = True
    jump = nxt
    while True:
        grown = mark.copy()
        grown[jump[mark]] = True
        if (grown == mark).all():
            return np.flatnonzero(mark[:-1])
        mark, jump = grown, jump[jump]


def packbits_decode(data: bytes, limit: int,
                    line: int | None = None) -> np.ndarray:
    """PackBits (Apple / TIFF compression 32773): a header byte n, then
    n + 1 literal bytes (n < 128) or one byte repeated 257 - n times
    (n > 128); 128 is a no-op.  Up to `limit` bytes out (fewer where the
    data runs out), in lines of `line` bytes (default limit): a packet
    that fills its line loses what it has beyond it and the next line
    starts at the next packet, as PIL's PackbitsDecode.c (PSD) reads;
    libtiff drops a strip's excess the same way.  The packet headers, and
    the packets that start lines, each form a chain, found at once."""
    a = np.frombuffer(data, np.uint8)
    n, line = len(a), line or limit
    if not n or not limit:
        return a[:0]
    h = a.astype(np.int64)
    step = np.where(h < 128, h + 2, np.where(h > 128, 2, 1))
    pos = _chain(np.append(np.minimum(np.arange(n) + step, n), n))
    hp = h[pos]
    lit = hp < 128
    count = np.where(lit, np.minimum(hp + 1, n - 1 - pos),
                     np.where((hp > 128) & (pos + 1 < n), 257 - hp, 0))
    k = len(pos)
    cum = np.concatenate([[0], np.cumsum(count)])
    # the packet after the one that fills the line starting at each packet
    after = np.searchsorted(cum, cum[:-1] + line, "left")
    starts = _chain(np.append(np.minimum(after, k), k))[:-(-limit // line)]
    # each packet's place in its line (past the line's end after the last
    # line: nothing kept)
    off = cum[:-1] - cum[starts[np.searchsorted(starts, np.arange(k),
                                                "right") - 1]]
    kept = np.clip(np.minimum(count, line - off), 0, None)
    owner = np.repeat(np.arange(k), kept)
    within = np.arange(len(owner)) - (np.cumsum(kept) - kept)[owner]
    return a[pos[owner] + 1 + np.where(lit[owner], within, 0)][:limit]


def _decompress(chunk: bytes, compression: int, size: int) -> np.ndarray:
    """One strip's or tile's bytes, padded or cut to `size`."""
    if compression == 1:
        raw = chunk
    elif compression == 5:
        old = len(chunk) >= 2 and chunk[0] == 0 and chunk[1] & 1
        raw = lzw_decode(chunk, 8, msb=not old, early=0 if old else 1,
                         limit=size)
    elif compression in (8, 32946):
        d = zlib.decompressobj()
        raw = d.decompress(chunk, size)
    elif compression == 32773:
        raw = packbits_decode(chunk, size)
    else:
        name = _COMPRESSION.get(compression, f"compression {compression}")
        raise ValueError(f"{name} TIFF is not read")
    a = np.frombuffer(raw[:size], np.uint8)
    if len(a) < size:
        a = np.concatenate([a, np.zeros(size - len(a), np.uint8)])
    return a


def _undo_predictor(block: np.ndarray, rows: int, width: int, spp: int,
                    bits: int, predictor: int, bo: str,
                    fmt: int) -> np.ndarray:
    """A decompressed block of `rows` rows of `width` pixels of `spp`
    samples -> its samples (rows, width * spp), unsigned integers or (fmt
    3) IEEE floats, with the predictor undone: 2 sums each sample's
    integer differences along the row (libtiff's horAcc8/16/32, floats by
    their bits), 3 sums the bytes and regroups the row's byte planes
    (fpAcc)."""
    if bits < 8:
        if predictor != 1:
            raise ValueError(f"TIFF predictor {predictor} at {bits} bits "
                             "is not read")
        return block.reshape(rows, -1)
    nbytes = bits // 8
    if predictor == 3:
        if bits not in (16, 32, 64):
            raise ValueError(f"TIFF floating-point predictor at {bits} bits "
                             "is not read")
        row = block.reshape(rows, width * spp * nbytes).astype(np.int64)
        acc = row.reshape(rows, -1, spp).cumsum(1).reshape(rows, -1) & 0xFF
        planes = acc.astype(np.uint8).reshape(rows, nbytes, width * spp)
        be = np.ascontiguousarray(planes.transpose(0, 2, 1))    # MSB first
        return be.view(f">f{nbytes}").reshape(rows, width * spp)
    vals = block.view(f"{bo}u{nbytes}").astype(f"=u{nbytes}").reshape(
        rows, width * spp)
    if predictor == 2:
        if bits not in (8, 16, 32):
            raise ValueError(f"TIFF horizontal predictor at {bits} bits is "
                             "not read")
        acc = vals.astype(np.uint64).reshape(rows, width, spp).cumsum(1)
        vals = (acc & ((1 << bits) - 1)).astype(f"u{nbytes}").reshape(
            rows, width * spp)
    elif predictor != 1:
        raise ValueError(f"TIFF predictor {predictor} is not read")
    if fmt == 3:
        return vals.view(f"=f{nbytes}")
    return vals


def _unpack_sub_byte(rows: np.ndarray, width: int, spp: int, bits: int):
    bitsarr = np.unpackbits(rows, axis=1)
    n = width * spp
    per = bitsarr[:, :n * bits].reshape(rows.shape[0], n, bits)
    return (per.astype(np.int64) << np.arange(bits - 1, -1, -1)).sum(-1)


def decode_tiff(data: bytes) -> np.ndarray:
    """The first image of a TIFF file (see the module docstring)."""
    bo, f = _ifd(data)

    def one(tag, default=None):
        v = f.get(tag)
        if v is None:
            if default is None:
                raise ValueError(f"TIFF: required field {tag} missing")
            return default
        return v[0]

    w, h = int(one(_WIDTH)), int(one(_HEIGHT))
    spp = int(one(_SPP, 1))
    bits_all = f.get(_BITS, (1,) * spp)
    if len(set(bits_all)) != 1:
        raise ValueError(f"TIFF with mixed bits per sample {bits_all} is "
                         "not read")
    bits = int(bits_all[0])
    compression = int(one(_COMPRESS, 1))
    photometric = int(one(_PHOTOMETRIC, 1))
    planar = int(one(_PLANAR, 1))
    # libtiff sets the predictor up for the LZW and Deflate codecs only
    predictor = int(one(_PREDICTOR, 1)) if compression in (5, 8, 32946) \
        else 1
    fmt = int(f.get(_SAMPLE_FORMAT, (1,))[0])
    if int(one(_FILL_ORDER, 1)) != 1:
        raise ValueError("TIFF with fill order 2 (bit-reversed) is not read")
    if photometric not in (0, 1, 2, 3, 5):
        name = {4: "transparency mask", 6: "YCbCr", 8: "CIE L*a*b*",
                9: "ICC L*a*b*", 10: "ITU L*a*b*", 32844: "LogL",
                32845: "LogLuv"}.get(photometric, str(photometric))
        raise ValueError(f"TIFF photometric {name} is not read")
    if fmt == 3 and bits != 32:
        raise ValueError(f"{bits}-bit float TIFF is not read")
    if fmt == 2:
        raise ValueError("signed-integer TIFF is not read")
    if fmt not in (1, 3) or (fmt == 1 and bits not in (1, 2, 4, 8, 16)):
        raise ValueError(f"{bits}-bit TIFF (sample format {fmt}) is not read")
    if photometric == 3 and (spp != 1 or bits > 8):
        raise ValueError("TIFF palette of this layout is not read")
    nplanes = spp if planar == 2 else 1
    ps = 1 if planar == 2 else spp                  # samples per stored pixel
    if _TILES in f:
        tw, th = int(one(_TILE_W)), int(one(_TILE_H))
        offsets, counts = f[_TILES], f.get(_TILE_BYTES)
        across, down = -(-w // tw), -(-h // th)
        layout = [(t // across, t % across) for t in range(across * down)]
    else:
        rps = min(int(one(_ROWS_PER_STRIP, h)), h)
        tw, th = w, rps
        offsets, counts = f[_STRIPS], f.get(_STRIP_BYTES)
        across, down = 1, -(-h // rps)
        layout = [(t, 0) for t in range(down)]
    if counts is None:
        if compression != 1:
            raise ValueError("TIFF: strip byte counts missing")
        counts = [-(-tw * ps * bits // 8) * th] * len(offsets)
    per_plane = across * down
    if len(offsets) < per_plane * nplanes:
        raise ValueError("TIFF: too few strips or tiles")
    row_bytes = -(-tw * ps * bits // 8)
    planes = []
    for p in range(nplanes):
        out = None
        for t, (ty, tx) in enumerate(layout):
            k = p * per_plane + t
            chunk = data[offsets[k]:offsets[k] + counts[k]]
            block = _decompress(chunk, compression, row_bytes * th)
            vals = _undo_predictor(block, th, tw, ps, bits, predictor, bo,
                                   fmt)
            if bits < 8:
                vals = _unpack_sub_byte(vals, tw, ps, bits)
            vals = vals.reshape(th, tw, ps)
            if out is None:
                out = np.zeros((down * th, across * tw, ps), vals.dtype)
            out[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw] = vals
        planes.append(out[:h, :w])
    px = planes[0] if nplanes == 1 else np.concatenate(planes, -1)
    if fmt == 3:
        return px.astype(np.float32)
    if photometric == 3:                            # palette -> RGB
        cmap = np.asarray(f[_COLORMAP], np.int64).reshape(3, -1)
        pal = (cmap.T >> 8).astype(np.uint8)        # PIL's 16 -> 8 bits
        return pal[np.minimum(px[..., 0], pal.shape[0] - 1)]
    if bits < 8:
        px = (px * (255 // ((1 << bits) - 1))).astype(np.uint8)
    if photometric == 0:                            # white is zero
        px = px.copy()
        top = 255 if bits <= 8 else 65535
        px[..., :1] = top - px[..., :1]
    if photometric == 5:                            # CMYK
        if spp < 4 or bits != 8:
            raise ValueError("TIFF CMYK of this layout is not read")
        return cmyk_to_rgb(px[..., :4])
    return np.ascontiguousarray(px)
