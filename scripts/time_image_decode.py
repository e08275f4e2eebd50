"""Host seconds of the port's image decoders (acceleratedvolrenderer_tpu_torch/
utils/image.py, tiff.py, webp.py) at an environment map's size, 2048x1024,
the cost a scene with such a map pays once when it loads; and the small
writers that make those files without PIL (the card's host has none).

    python3 scripts/time_image_decode.py [--width 2048 --height 1024]

Each image is procedural (sinusoids, with noise for the JPEG), written by
the encoders below, and decoded three times:

  - JPEG: 4:2:0 baseline through `encode_jpeg` (float DCT, the JPEG
    standard's example quantization tables scaled to quality 90 as libjpeg
    scales them, flat Huffman tables of 4- and 5-bit (DC) and 8- and
    9-bit (AC) codes), so its coefficient and symbol counts are a
    photograph's kind; the decode's PSNR against the source must exceed
    20 dB;
  - TIFF: 8-bit RGB, LZW with the horizontal predictor, and 16-bit RGB,
    LZW with the predictor (the sky map of chip_smoke.py's phase 32);
  - GIF: 256 colours, interlaced; QOI: RGB; PPM: binary, maxval 255;
  - WebP: a lossy quality-90 file made by PIL, committed under
    tests/data/images/ (scripts/make_image_fixtures.py), when given;
  - JPEG 2000: the committed fixtures (a 2048x1024 9/7 JP2, a 1024x512
    5/3 codestream, a 512x256 lossless JP2) or the files given with
    --j2k (say a lossless 2048x1024 JP2 that PIL wrote), decoded once
    with the C++ tier 1 (native/j2k_t1.cpp) and, with --twin, once with
    the numpy twin (utils/j2k_t1.py); both must give the same samples,
    at images.json's hash of PIL's where it records the file.

    python3 scripts/time_image_decode.py --j2k a.jp2 b.j2k --twin

The lossless files must decode to the written samples exactly.  Prints
the host's CPU, each file's size and write seconds and each decode's
seconds; `time_formats` returns the same records (chip_smoke.py phase 32
(d) prints them beside the card).  The CPU tests' writers of the other
kinds (JPEG of any sampling, colour space and markers, arithmetic-coded
and lossless JPEG; TIFF of every layout and compression) are in
tests/torch_image_writers.py, built on the pieces here.
"""
import argparse
import json
import os
import platform
import struct
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
J2K_FIXTURES = ("sky_2048x1024_97.jp2", "ground_1024x512_53.j2k",
                "sky_512x256_lossless.jp2")
sys.path.insert(0, str(ROOT))

from acceleratedvolrenderer_tpu_torch.utils import image  # noqa: E402

Q_LUMA = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
          14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
          18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
          49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103,
          99]
Q_CHROMA = [17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4 + [
    24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38
# libjpeg's quality scaling at quality 90: 20% of the example tables
Q_LUMA, Q_CHROMA = ([max(1, (q * 20 + 50) // 100) for q in t]
                    for t in (Q_LUMA, Q_CHROMA))
# canonical tables without an all-ones code: DC symbols 0-14 in 4 bits and
# 15 in 5 (libjpeg takes DC symbols up to 15); AC 0-253 in 8 bits, 254-255
# in 9
DC_COUNTS = [0, 0, 0, 15, 1] + [0] * 11
DC_CODES = {s: (s, 4) for s in range(15)}
DC_CODES[15] = (30, 5)
AC_COUNTS = [0] * 7 + [254, 2] + [0] * 7
AC_CODES = {s: (s, 8) for s in range(254)}
AC_CODES.update({254: (508, 9), 255: (509, 9)})


def scene(w, h, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 7.0),
                    128 + 90 * np.cos(yy / 5.0 + xx / 11.0),
                    (xx * 3 + yy * 5) % 256], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(
        np.uint8)


def sky(w, h, top=65535):
    """A smooth sky of sinusoids, (h, w, 3) in 0..top: the kind of map an
    environment light reads, which LZW with the predictor compresses."""
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.stack([0.5 + 0.4 * np.sin(xx / 37.0) * np.cos(yy / 53.0),
                  0.5 + 0.35 * np.sin(xx / 71.0 + yy / 29.0),
                  0.62 + 0.23 * np.cos(yy / 41.0)], -1)
    return np.round(f * top).astype(np.uint16 if top > 255 else np.uint8)


# ---------------------------------------------------------------------------
# JPEG (baseline, Huffman-coded)
# ---------------------------------------------------------------------------

def blocks(plane, q):
    """(by, bx, 64) zigzag-ordered quantized DCT coefficients."""
    h, w = plane.shape
    u = np.arange(8)
    c = np.sqrt(np.where(u == 0, 1 / 8, 2 / 8))[:, None] * np.cos(
        (2 * u[None, :] + 1) * u[:, None] * np.pi / 16)
    b = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3) - 128.0
    f = c @ b @ c.T
    coef = np.round(f.reshape(h // 8, w // 8, 64) / np.asarray(q))
    return coef[:, :, image._JPEG_NATURAL].astype(np.int64)


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code, length):
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def put_value(bw, codes, sym_base, v):
    s = abs(v).bit_length()
    bw.put(*codes[sym_base | s])
    if s:
        bw.put(v if v > 0 else v + (1 << s) - 1, s)


def _put_block(bw, blk, pred):
    put_value(bw, DC_CODES, 0, blk[0] - pred)
    run = 0
    last = max([k for k in range(1, 64) if blk[k]], default=0)
    for k in range(1, last + 1):
        if not blk[k]:
            run += 1
            continue
        while run > 15:
            bw.put(*AC_CODES[0xF0])
            run -= 16
        put_value(bw, AC_CODES, run << 4, blk[k])
        run = 0
    if last < 63:
        bw.put(*AC_CODES[0x00])
    return blk[0]


def segment(marker, body):
    """A JPEG marker segment: the marker, its length, its body."""
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


JFIF = segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def dqt():
    """The two quantization tables (0 luma, 1 chroma), zigzag order."""
    zz = lambda q: bytes(np.asarray(q)[image._JPEG_NATURAL].tolist())
    return segment(0xDB, b"\x00" + zz(Q_LUMA) + b"\x01" + zz(Q_CHROMA))


def ycc(x):
    """JFIF's Y, Cb, Cr planes of float RGB x (H, W, >=3)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return [0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128]


def jpeg_planes(comps, sampling, w, h):
    """Each component plane, edge-padded to whole MCUs, box-averaged down by
    its (h, v) factors of `sampling` and quantized (the first by the luma
    table) into blocks: ([(by, bx, 64)], (mcus across, mcus down))."""
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    planes = []
    for plane, (ch, cv) in zip(comps, sampling):
        fx, fy = hmax // ch, vmax // cv
        full = np.pad(plane, ((0, mcuy * 8 * vmax - h),
                              (0, mcux * 8 * hmax - w)), mode="edge")
        sub = full.reshape(full.shape[0] // fy, fy, full.shape[1] // fx,
                           fx).mean((1, 3))
        q = Q_LUMA if not planes else Q_CHROMA
        planes.append(blocks(np.clip(np.round(sub), 0, 255), q))
    return planes, (mcux, mcuy)


def baseline_jpeg(comps, sampling, w, h, head=JFIF, ids=None):
    """A baseline (SOF0) JPEG of the float component planes `comps` (h, w),
    each subsampled by its (h, v) of `sampling`, one interleaved scan (one
    component: non-interleaved), the marker segments `head` after SOI,
    component ids `ids` (default 1, 2, ...)."""
    n = len(comps)
    sampling = list(sampling)[:n]
    planes, (mcux, mcuy) = jpeg_planes(comps, sampling, w, h)
    bw = BitWriter()
    pred = [0] * n
    if n == 1:
        for by in range(-(-h // 8)):
            for bx in range(-(-w // 8)):
                pred[0] = _put_block(bw, planes[0][by, bx].tolist(), pred[0])
    else:
        for my in range(mcuy):
            for mx in range(mcux):
                for ci, (ch, cv) in enumerate(sampling):
                    for i in range(cv):
                        for j in range(ch):
                            blk = planes[ci][my * cv + i, mx * ch + j]
                            pred[ci] = _put_block(bw, blk.tolist(), pred[ci])
    dc = bytes(DC_COUNTS) + bytes(range(16))
    ac = bytes(AC_COUNTS) + bytes(range(256))
    ids = ids or list(range(1, n + 1))
    sof = b"\x08" + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([n])
    sos = bytes([n])
    for i, (ch, cv) in enumerate(sampling):
        sof += bytes([ids[i], ch << 4 | cv, 0 if i == 0 else 1])
        sos += bytes([ids[i], 0])
    sos += b"\x00\x3f\x00"
    return (b"\xff\xd8" + head + dqt() + segment(0xC0, sof)
            + segment(0xC4, b"\x00" + dc + b"\x10" + ac) + segment(0xDA, sos)
            + bw.flush() + b"\xff\xd9")


def encode_jpeg(img):
    """A 4:2:0 JFIF YCbCr baseline JPEG of uint8 RGB img (H, W, 3)."""
    h, w = img.shape[:2]
    return baseline_jpeg(ycc(img.astype(np.float64)),
                         ((2, 2), (1, 1), (1, 1)), w, h)


# ---------------------------------------------------------------------------
# LZW, TIFF, GIF, QOI, netpbm
# ---------------------------------------------------------------------------

def lzw_encode(data, min_bits=8, msb=True, early=1):
    """LZW codes of `data` (bytes) as utils/tiff.py's lzw_decode reads them:
    a clear code first, a clear again before the table passes 4093
    entries, an end code last; each code as wide as the decoder's table
    then needs (the k-th code after a clear is read while the table holds
    clear + 2 + max(k - 1, 0) entries)."""
    clear, eoi = 1 << min_bits, (1 << min_bits) + 1
    first = clear + 2
    codes, since = [clear], [0]         # since: codes since the last clear
    table, nxt, k = {}, first, 0
    w = -1
    for c in data:
        if w < 0:
            w = c
            continue
        key = (w << 8) | c
        v = table.get(key)
        if v is not None:
            w = v
            continue
        codes.append(w)
        since.append(k)
        k += 1
        table[key] = nxt
        nxt += 1
        w = c
        if nxt >= 4093:
            codes += [w, clear]
            since += [k, k + 1]
            table, nxt, k, w = {}, first, 0, -1
    if w >= 0:
        codes.append(w)
        since.append(k)
        k += 1
    codes.append(eoi)
    since.append(k)
    size = first + np.maximum(np.array(since, np.int64) - 1, 0)
    widths = np.full(len(size), min_bits + 1, np.int64)
    for nb in range(min_bits + 1, 12):
        widths += size >= (1 << nb) - early
    return _pack_bits(np.array(codes, np.int64), widths, msb)


def _pack_bits(codes, widths, msb):
    """Codes of the given widths packed MSB first (bytes filled from their
    top bit) or LSB first."""
    total = int(widths.sum())
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
    bits = np.zeros(total + 7, np.uint8)
    maxw = int(widths.max())
    for b in range(maxw):
        sel = widths > b
        if msb:
            pos = starts[sel] + widths[sel] - 1 - b
        else:
            pos = starts[sel] + b
        bits[pos] = (codes[sel] >> b) & 1
    bits = bits[:(total + 7) // 8 * 8]
    return np.packbits(bits, bitorder="big" if msb else "little").tobytes()


def tiff_entry(bo, tag, typ, values):
    """An IFD entry of SHORT (3) or LONG (4) values, byte order bo."""
    code = {3: "H", 4: "I"}[typ]
    return tag, typ, len(values), struct.pack(bo + code * len(values),
                                              *values)


def tiff_file(chunks, entries, bo="<", tile=None, rows_per_strip=None):
    """A TIFF of the compressed strips (rows_per_strip rows each) or tiles
    (tw, th) `chunks` under the IFD `entries` (tiff_entry's), which gain
    the chunks' offsets and byte counts; byte order bo."""
    data = bytearray(8)
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c + b"\0" * (len(c) & 1)
    counts = [len(c) for c in chunks]
    if tile:
        entries = entries + [tiff_entry(bo, 322, 4, [tile[0]]),
                             tiff_entry(bo, 323, 4, [tile[1]]),
                             tiff_entry(bo, 324, 4, offsets),
                             tiff_entry(bo, 325, 4, counts)]
    else:
        entries = entries + [tiff_entry(bo, 273, 4, offsets),
                             tiff_entry(bo, 278, 4, [rows_per_strip]),
                             tiff_entry(bo, 279, 4, counts)]
    entries.sort()
    ifd_at = len(data)
    tail = bytearray()
    body = struct.pack(bo + "H", len(entries))
    after = ifd_at + 2 + 12 * len(entries) + 4
    for tag, typ, count, val in entries:
        if len(val) <= 4:
            body += struct.pack(bo + "HHI", tag, typ, count) + val.ljust(4,
                                                                     b"\0")
        else:
            body += struct.pack(bo + "HHII", tag, typ, count,
                                after + len(tail))
            tail += val + b"\0" * (len(val) & 1)
    data += body + b"\0\0\0\0" + tail
    data[:8] = (b"MM\0*" if bo == ">" else b"II*\0") + struct.pack(
        bo + "I", ifd_at)
    return bytes(data)


def encode_tiff(px, predictor=2, rows_per_strip=64):
    """A little-endian LZW TIFF of px (H, W, C) uint8 / uint16, gray (C 1)
    or RGB (C 3), in strips of rows_per_strip rows, with the horizontal
    predictor when predictor is 2."""
    h, w, spp = px.shape
    bits = px.dtype.itemsize * 8
    rows_per_strip = min(rows_per_strip, h)
    chunks = []
    for y in range(0, h, rows_per_strip):
        v = px[y:y + rows_per_strip].reshape(-1, w, spp)
        if predictor == 2:
            u = v.astype(np.int64)
            u = np.concatenate([u[:, :1], np.diff(u, axis=1)], 1)
            v = (u & ((1 << bits) - 1)).astype(px.dtype)
        chunks.append(lzw_encode(np.ascontiguousarray(v).astype(
            v.dtype.newbyteorder("<")).tobytes()))
    entries = [tiff_entry("<", 256, 4, [w]), tiff_entry("<", 257, 4, [h]),
               tiff_entry("<", 258, 3, [bits] * spp),
               tiff_entry("<", 259, 3, [5]),
               tiff_entry("<", 262, 3, [1 if spp < 3 else 2]),
               tiff_entry("<", 277, 3, [spp]), tiff_entry("<", 284, 3, [1]),
               tiff_entry("<", 339, 3, [1] * spp)]
    if predictor != 1:
        entries.append(tiff_entry("<", 317, 3, [predictor]))
    return tiff_file(chunks, entries, rows_per_strip=rows_per_strip)


def encode_gif(idx, palette, interlace=False, transparent=None, screen=None,
               offset=(0, 0)):
    """A GIF89a of one frame: idx (h, w) palette indices, palette (n, 3)
    uint8 (n a power of two, 2..256) as the global table; the frame at
    `offset` on a screen (sw, sh) (default its own size), interlaced if
    asked, with a transparent index if given."""
    fh, fw = idx.shape
    sw, sh = screen or (fw, fh)
    n = len(palette)
    size_bits = max(n - 1, 1).bit_length()
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", sw, sh,
                                             0x80 | 0x70 | (size_bits - 1),
                                             0, 0))
    pal = np.zeros((1 << size_bits, 3), np.uint8)
    pal[:n] = palette
    out += pal.tobytes()
    if transparent is not None:
        out += b"\x21\xf9\x04\x01\x00\x00" + bytes([transparent]) + b"\0"
    out += b"\x2c" + struct.pack("<HHHHB", offset[0], offset[1], fw, fh,
                                 0x40 if interlace else 0)
    rows = idx
    if interlace:
        order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                np.arange(2, fh, 4), np.arange(1, fh, 2)])
        rows = idx[order]
    min_bits = max(2, size_bits)
    lzw = lzw_encode(rows.astype(np.uint8).tobytes(), min_bits, msb=False,
                     early=0)
    out += bytes([min_bits])
    for i in range(0, len(lzw), 255):
        part = lzw[i:i + 255]
        out += bytes([len(part)]) + part
    out += b"\0\x3b"
    return bytes(out)


def encode_qoi(px):
    """A QOI file of uint8 px (h, w, 3 or 4), as qoi.h encodes."""
    h, w, c = px.shape
    out = bytearray(b"qoif" + struct.pack(">IIBB", w, h, c, 0))
    flat = px.reshape(-1, c).astype(np.int64)
    if c == 3:
        flat = np.concatenate([flat, np.full((len(flat), 1), 255)], 1)
    words = ((flat[:, 0] << 24) | (flat[:, 1] << 16) | (flat[:, 2] << 8)
             | flat[:, 3]).tolist()
    index = [0] * 64
    prev, run = 0x000000FF, 0
    for v in words:
        if v == prev:
            run += 1
            if run == 62:
                out.append(0xC0 | 61)
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        r, g, b, a = v >> 24, (v >> 16) & 255, (v >> 8) & 255, v & 255
        slot = (r * 3 + g * 5 + b * 7 + a * 11) & 63
        if index[slot] == v:
            out.append(slot)
        else:
            index[slot] = v
            if a == prev & 255:
                dr = ((r - (prev >> 24)) + 128 & 255) - 128
                dg = ((g - ((prev >> 16) & 255)) + 128 & 255) - 128
                db = ((b - ((prev >> 8) & 255)) + 128 & 255) - 128
                if -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
                    out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2
                               | (db + 2))
                elif -32 <= dg <= 31 and -8 <= dr - dg <= 7 and \
                        -8 <= db - dg <= 7:
                    out += bytes([0x80 | (dg + 32),
                                  (dr - dg + 8) << 4 | (db - dg + 8)])
                else:
                    out += bytes([0xFE, r, g, b])
            else:
                out += bytes([0xFF, r, g, b, a])
        prev = v
    if run:
        out.append(0xC0 | (run - 1))
    return bytes(out + b"\0" * 7 + b"\1")


def encode_netpbm(px, maxval=255, plain=False):
    """PBM (bool px), PGM ((h, w) or (h, w, 1)) or PPM ((h, w, 3)), binary
    or plain (ASCII), samples up to maxval (two bytes each above 255)."""
    px = np.asarray(px)
    if px.dtype == bool:
        h, w = px.shape[:2]
        bits = px.reshape(h, w).astype(np.uint8)
        if plain:
            body = "\n".join(" ".join(map(str, r)) for r in bits.tolist())
            return f"P1\n{w} {h}\n".encode() + body.encode() + b"\n"
        return f"P4\n{w} {h}\n".encode() + np.packbits(bits, 1).tobytes()
    px = px.reshape(px.shape[0], px.shape[1], -1)
    h, w, c = px.shape
    magic = {(1, True): "P2", (3, True): "P3", (1, False): "P5",
             (3, False): "P6"}[(c, plain)]
    head = f"{magic}\n# written by scripts/time_image_decode.py\n{w} {h}\n" \
           f"{maxval}\n".encode()
    if plain:
        return head + " ".join(map(str, px.reshape(-1).tolist())).encode()
    dt = np.uint8 if maxval < 256 else np.dtype(">u2")
    return head + px.astype(dt).tobytes()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def sky_tiff(width, height):
    """The 16-bit RGB sky as an LZW TIFF with the horizontal predictor, in
    strips of 64 rows (chip_smoke.py phase 32's map)."""
    return encode_tiff(sky(width, height))


def cpu_line():
    model = next((ln.split(":", 1)[1].strip() for ln in
                  Path("/proc/cpuinfo").read_text().splitlines()
                  if ln.startswith("model name")), "model not reported")
    return f"{model}, {platform.machine()}, {os.cpu_count()} cores"


def time_jpeg2000(paths, record=None, twin=()):
    """[(name, bytes, shape, C++ seconds, numpy seconds or None, ok)]: each
    JPEG 2000 file decoded once by utils/image.py's _decode_image (tier 1
    in C++, which must build) and, for the names in twin, once more with
    the numpy tier 1; ok: the two decodes are equal, and the samples'
    SHA-256 is record[name]["sha256_of_pil_samples"] where record holds
    the name."""
    import hashlib

    from acceleratedvolrenderer_tpu_torch import native
    from acceleratedvolrenderer_tpu_torch.utils import jpeg2000

    native.j2k_library(required=True)
    out = []
    for path in map(Path, paths):
        data = path.read_bytes()
        t0 = time.time()
        got = image._decode_image(str(path), data)
        secs = time.time() - t0
        ok = True
        twin_secs = None
        if path.name in twin:
            fn = (jpeg2000.decode_jp2 if data[:12] == jpeg2000.JP2_MAGIC
                  else jpeg2000.decode_j2k)
            t0 = time.time()
            ok = np.array_equal(fn(data, native=False), got)
            twin_secs = time.time() - t0
        rec = (record or {}).get(path.name)
        if rec is not None:
            digest = hashlib.sha256(np.ascontiguousarray(got).tobytes())
            ok = ok and digest.hexdigest() == rec["sha256_of_pil_samples"] \
                and list(got.shape) == rec["shape"]
        out.append((path.name, len(data), got.shape, secs, twin_secs,
                    bool(ok)))
    return out


def time_formats(width=2048, height=1024, webp_path=None, reps=3,
                 sky16=None, files=None, j2k=(), twin=False):
    """[(name, file bytes, write seconds, [decode seconds] * reps, ok)]:
    each format written at width x height and decoded `reps` times by
    utils/image.py's _decode_image (the path read_image takes); ok: the
    decode equals the written samples (the JPEG: PSNR > 20 dB; the WebP:
    its shape).  sky16: sky_tiff's bytes when the caller has them (its
    write is then not timed again).  files: a dict that gains each
    written file's bytes under its kind ("jpeg", "tiff 8-bit", ...).
    j2k: JPEG 2000 files, decoded once each by time_jpeg2000 (twin: also
    by the numpy tier 1, a record of its own), held to images.json."""
    from acceleratedvolrenderer_tpu_torch.utils import webp

    s8, s16 = sky(width, height, 255), sky(width, height)
    rgb = scene(width, height)
    i = np.arange(256)                              # 8 x 8 x 4 levels
    pal = np.stack([(i >> 5) * 36, (i >> 2 & 7) * 36, (i & 3) * 85],
                   -1).astype(np.uint8)
    gif_idx = ((s8[..., 0].astype(np.int64) >> 5 << 5)
               | (s8[..., 1] >> 5 << 2) | (s8[..., 2] >> 6))
    cases = [
        ("JPEG 4:2:0 baseline", lambda: encode_jpeg(rgb), rgb, "jpeg"),
        ("TIFF 8-bit RGB LZW + predictor", lambda: encode_tiff(s8), s8,
         "tiff 8-bit"),
        ("TIFF 16-bit RGB LZW + predictor",
         lambda: sky16 or sky_tiff(width, height), s16, "tiff 16-bit"),
        ("GIF 256 colours, interlaced",
         lambda: encode_gif(gif_idx.astype(np.uint8), pal, interlace=True),
         pal[gif_idx], "gif"),
        ("QOI RGB", lambda: encode_qoi(s8), s8, "qoi"),
        ("PPM binary", lambda: encode_netpbm(s8), s8, "ppm"),
    ]
    out = []
    for name, make, want, kind in cases:
        t0 = time.time()
        data = make()
        write = time.time() - t0
        if files is not None:
            files[kind] = data
        secs, got = [], None
        for _ in range(reps):
            t0 = time.time()
            got = image._decode_image(f"x.{kind.split()[0]}", data)
            secs.append(time.time() - t0)
        if kind == "jpeg":
            mse = float(np.mean((got.astype(float) - want) ** 2))
            ok = got.shape == want.shape and 10 * np.log10(255 ** 2 / mse) > 20
        else:
            ok = got.shape == want.shape and np.array_equal(got, want)
        out.append((name, len(data), write, secs, bool(ok)))
    if webp_path is not None:
        data = Path(webp_path).read_bytes()
        secs = []
        for _ in range(reps):
            t0 = time.time()
            got = webp.decode_webp(data)
            secs.append(time.time() - t0)
        out.append((f"WebP lossy ({Path(webp_path).name})", len(data), 0.0,
                    secs, got.shape[:2] == (height, width)))
    record = json.loads((ROOT / "tests/data/images/images.json").read_text(
    )) if j2k else None
    names = [Path(p).name for p in j2k] if twin else ()
    for name, size, shape, secs, twin_secs, ok in time_jpeg2000(
            j2k, record, names):
        what = f"JPEG 2000 {name} {shape[1]}x{shape[0]}"
        out.append((f"{what} (C++ tier 1)", size, 0.0, [secs], ok))
        if twin_secs is not None:
            out.append((f"{what} (numpy tier 1)", size, 0.0, [twin_secs],
                        ok))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--webp", default=str(
        ROOT / "tests/data/images/sky_2048x1024_q90.webp"))
    ap.add_argument("--j2k", nargs="*", default=[
        str(ROOT / "tests/data/images" / n) for n in J2K_FIXTURES])
    ap.add_argument("--twin", action="store_true",
                    help="also time the numpy tier 1 of each JPEG 2000")
    a = ap.parse_args()
    webp_path = a.webp if Path(a.webp).exists() and (
        a.width, a.height) == (2048, 1024) else None
    print(f"host CPU: {cpu_line()}")
    bad = []
    for name, size, write, secs, ok in time_formats(
            a.width, a.height, webp_path, j2k=a.j2k, twin=a.twin):
        at = "" if name.startswith("JPEG 2000") else \
            f" {a.width}x{a.height}"
        print(f"{name}{at}: {size} bytes, written in {write:.2f} s; decode "
              f"{', '.join(f'{s:.3f}' for s in secs)} s; "
              f"{'equal to the source' if ok else 'WRONG'}")
        if not ok:
            bad.append(name)
    if bad:
        raise SystemExit(f"decode does not match the source: {bad}")


if __name__ == "__main__":
    main()
