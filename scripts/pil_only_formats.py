"""Writers, without PIL, of the files utils/image_read_pil.py reads (formats
PIL reads but does not write), and the host seconds of one decode of each
committed fixture of those formats:

    python3 scripts/pil_only_formats.py

  - DCX: the page table and PCX pages (utils/image_write.py's encode_pcx
    writes PIL's RGB PCX);
  - PIXAR: the 1024-byte header (size at 416 / 418, channel words at 424 /
    426) and raw RGB;
  - FTEX: one format, raw RGB (1) or DXT1 blocks (0, scripts/block_maps.py's
    encode_bc1);
  - GBR: GIMP brush v1 or v2 (`GIMP` and a spacing), depth 1 or 4;
  - XV thumbnail: `P7 332`, comment lines, the size line, 3-3-2 indices;
  - McIDAS: the 64-word area directory, 1-, 2- or 4-byte samples, line
    prefixes and bands;
  - IMT: `width`, `height` and `pixel n8` lines, a form feed, raw L;
  - FITS: a primary or IMAGE-extension HDU of BITPIX 8, 16, 32, -32 or
    -64 (big-endian, rows bottom first, BZERO and BSCALE cards where
    given), or a GZIP_1 tile-compressed BINTABLE (one gzip member per row
    of 4-byte big-endian words, the layout PIL's decoder reads);
  - IPTC: the IIM records 3:20 / 3:30 / 3:60 / 3:65 / 3:120, then the
    image in 8:10 records, raw or JPEG;
  - FLI / FLC: the 128-byte header and frames of chunks: COLOR_256,
    COLOR_64, BLACK, BRUN, COPY, LC, SS2 and PSTAMP;
  - PhotoCD: the base image at 96 * 2048, row pairs of luma and the two
    chroma planes at half resolution; pcd_of_rgb converts RGB to PhotoYCC
    (the inverse of PIL's YCC;P tables, rounded).

tests/torch_image_writers.py hands these to the CPU tests;
scripts/make_image_fixtures.py writes the committed fixtures
(tests/data/images/*.dcx ...) with them, and records the SHA-256 of each
file and of PIL's decode of it (colours for palette images) in
images.json, beside those of the PhotoCD sky and the FTEX ground that
chip_smoke.py phase 38 writes on the card's host with `phase38_files`;
chip_smoke.py's side process decodes each committed fixture with
`decode_fixtures` and holds it to that record.
"""
import gzip
import hashlib
import json
import struct
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

FIXTURES = ROOT / "tests" / "data" / "images"
READ_BY = "utils/image_read_pil.py"
# chip_smoke.py phase 38's maps: written on the card's host, recorded in
# images.json (`rebuilt_by`), not committed
PCD_SKY = "sky_768x512.pcd"
FTEX_GROUND = "ground_1024x512_dxt1.ftc"


# ---------------------------------------------------------------- DCX


def dcx_file(pages):
    """A DCX of the PCX files `pages`, in order."""
    head = struct.pack("<I", 0x3ADE68B1)
    pos = 4 + 4 * (len(pages) + 1)
    offsets = []
    for p in pages:
        offsets.append(pos)
        pos += len(p)
    return (head + struct.pack(f"<{len(pages) + 1}I", *offsets, 0)
            + b"".join(pages))


# ---------------------------------------------------------------- PIXAR


def pixar_file(px, words=(14, 2)):
    """A PIXAR file of RGB px (H, W, 3) with the channel words `words`."""
    h, w = px.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<2H", head, 416, h, w)
    struct.pack_into("<2H", head, 424, *words)
    return bytes(head) + np.ascontiguousarray(px, np.uint8).tobytes()


# ---------------------------------------------------------------- FTEX


def ftex_file(w, h, payload, fmt, n_formats=1):
    """An FTEX texture of one mipmap, `payload` in format fmt (0 DXT1, 1
    raw RGB), its format directory holding n_formats entries alike."""
    where = 24 + 8 * n_formats
    return (b"FTEX" + struct.pack("<5i", 1, w, h, 1, n_formats)
            + struct.pack("<2i", fmt, where) * n_formats
            + struct.pack("<i", len(payload)) + payload)


def ftex_rgb(px):
    h, w = px.shape[:2]
    return ftex_file(w, h, np.ascontiguousarray(px, np.uint8).tobytes(), 1)


def ftex_dxt1(px):
    """px (H, W, 3) as DXT1 blocks (block_maps.encode_bc1; the edge
    pixels repeated to whole blocks)."""
    from block_maps import encode_bc1

    h, w = px.shape[:2]
    full = np.pad(px, ((0, -h % 4), (0, -w % 4), (0, 0)), mode="edge")
    return ftex_file(w, h, encode_bc1(full), 0)


# ---------------------------------------------------------------- GBR


def gbr_file(px, version=2, spacing=25, comment=b"brush"):
    """A GIMP brush of px: (H, W) or (H, W, 1) gray (depth 1) or (H, W, 4)
    RGBA (depth 4); the comment NUL-terminated."""
    px = np.asarray(px, np.uint8)
    px = px.reshape(px.shape[0], px.shape[1], -1)
    h, w, depth = px.shape
    text = comment + b"\0"
    size = (20 if version == 1 else 28) + len(text)
    head = struct.pack(">5I", size, version, w, h, depth)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", spacing)
    return head + text + px.tobytes()


# ---------------------------------------------------------------- XV


def rgb_to_332(px):
    """PIL's 3-3-2 palette index of RGB px: red and green's top three bits,
    blue's top two."""
    px = np.asarray(px, np.uint8)
    return ((px[..., 0] >> 5) << 5 | (px[..., 1] >> 5) << 2
            | px[..., 2] >> 6).astype(np.uint8)


def xvthumb_file(idx, comments=(b"#XVVERSION:Version 3.10a",
                                b"#IMGINFO:128x96 RGB",
                                b"#END_OF_COMMENTS")):
    """An XV thumbnail of 3-3-2 indices idx (H, W)."""
    h, w = idx.shape
    return (b"P7 332\n" + b"".join(c + b"\n" for c in comments)
            + f"{w} {h} 255\n".encode() + np.ascontiguousarray(
                idx, np.uint8).tobytes())


# ---------------------------------------------------------------- McIDAS


def mcidas_file(values, nbytes, prefix=0, bands=1, offset=256):
    """A McIDAS area of values (H, W) as nbytes-byte big-endian samples
    (band 0 of `bands`, the others 0), each line after `prefix` bytes, the
    data at `offset`."""
    h, w = values.shape
    words = [0] * 65
    words[2], words[9], words[10], words[11] = 4, h, w, nbytes
    words[14], words[15], words[34] = bands, prefix, offset
    head = struct.pack(">64i", *words[1:])
    dt = {1: ">u1", 2: ">u2", 4: ">i4"}[nbytes]
    line = np.zeros((h, w * bands), dt)
    line[:, :w] = values
    rows = np.concatenate([np.full((h, prefix), 0xA5, np.uint8),
                           line.view(np.uint8).reshape(h, -1)], 1)
    return head + bytes(offset - 256) + rows.tobytes()


# ---------------------------------------------------------------- IMT


def imt_file(gray, extra=(b"* written by scripts/pil_only_formats.py",)):
    """An IM Tools file of gray (H, W)."""
    h, w = gray.shape
    lines = list(extra) + [f"width {w}".encode(), f"height {h}".encode(),
                           b"pixel n8"]
    return (b"\n".join(lines) + b"\n\x0c"
            + np.ascontiguousarray(gray, np.uint8).tobytes())


# ---------------------------------------------------------------- FITS

_FITS_DT = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}


def _cards(pairs):
    """80-byte header cards of (keyword, value) pairs, END, padded to
    2880 with spaces."""
    out = b""
    for k, v in pairs:
        if isinstance(v, bool):
            v = "T" if v else "F"
        elif isinstance(v, str) and not v.startswith("'"):
            v = f"'{v:<8}'"
        out += f"{k:<8}= {str(v):>20}".ljust(80).encode("ascii")
    out += b"END".ljust(80)
    return out + b" " * (-len(out) % 2880)


def _pad(data):
    return data + bytes(-len(data) % 2880)


def fits_file(values, bitpix, extension=False, naxis1=False, extra=()):
    """A FITS file of values (H, W) at BITPIX bitpix, rows stored bottom
    first (FITS's order: PIL's decode of BITPIX 8 is values), in the
    primary HDU or, with extension, an IMAGE extension after an empty
    primary; naxis1 stores one row of H * W values as NAXIS 1; extra
    cards (BZERO, BSCALE ...) after the axes."""
    h, w = values.shape
    axes = [("NAXIS", 1), ("NAXIS1", h * w)] if naxis1 else \
        [("NAXIS", 2), ("NAXIS1", w), ("NAXIS2", h)]
    data = np.ascontiguousarray(values[::-1]).astype(_FITS_DT[bitpix])
    hdu = [("BITPIX", bitpix)] + axes + list(extra)
    if not extension:
        return _cards([("SIMPLE", True)] + hdu) + _pad(data.tobytes())
    primary = _cards([("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0),
                      ("EXTEND", True)])
    return primary + _cards([("XTENSION", "IMAGE"), *hdu, ("PCOUNT", 0),
                             ("GCOUNT", 1)]) + _pad(data.tobytes())


def fits_gzip_file(values, zbitpix):
    """A GZIP_1 tile-compressed FITS image of integer values (H, W): one
    tile per row, each a gzip member of 4-byte big-endian words, the rows
    bottom first."""
    h, w = values.shape
    tiles = [gzip.compress(np.ascontiguousarray(row).astype(">i4")
                           .tobytes(), mtime=0) for row in values[::-1]]
    heap = b"".join(tiles)
    table, pos = b"", 0
    for t in tiles:
        table += struct.pack(">2i", len(t), pos)
        pos += len(t)
    primary = _cards([("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0),
                      ("EXTEND", True)])
    head = _cards([("XTENSION", "BINTABLE"), ("BITPIX", 8), ("NAXIS", 2),
                   ("NAXIS1", 8), ("NAXIS2", h), ("PCOUNT", len(heap)),
                   ("GCOUNT", 1), ("TFIELDS", 1),
                   ("TTYPE1", "COMPRESSED_DATA"),
                   ("TFORM1", f"1PB({max(map(len, tiles))})"),
                   ("ZIMAGE", True), ("ZBITPIX", zbitpix), ("ZNAXIS", 2),
                   ("ZNAXIS1", w), ("ZNAXIS2", h), ("ZTILE1", w),
                   ("ZTILE2", 1), ("ZCMPTYPE", "GZIP_1")])
    return primary + head + _pad(table + heap)


# ---------------------------------------------------------------- IPTC


def iptc_record(rec, tag, data, extended=False):
    """One IIM dataset; extended writes PIL's reading of an extended
    length: 128 + n in the first length byte, then n bytes of length."""
    if extended:
        return bytes([0x1C, rec, tag, 0x84, 0]) + struct.pack(
            ">I", len(data)) + data
    return struct.pack(">BBBH", 0x1C, rec, tag, len(data)) + data


def iptc_file(image, w, h, layers=1, band=None, compression=1,
              chunk=32000, extended=False):
    """An IPTC/NAA file: records 3:20, 3:30, 3:60 (layers and whether
    interleaved), 3:65 (band + 1, where given) and 3:120 (1 raw, 5 JPEG),
    then `image` (bytes) in 8:10 records of at most `chunk` bytes (one
    extended record with extended)."""
    out = (iptc_record(2, 0, b"\0\x04") + iptc_record(3, 20, struct.pack(
        ">H", w)) + iptc_record(3, 30, struct.pack(">H", h))
        + iptc_record(3, 60, bytes([layers, 0 if layers == 1 else 1])))
    if band is not None:
        out += iptc_record(3, 65, bytes([band + 1]))
    out += iptc_record(3, 120, bytes([compression]))
    if extended:
        return out + iptc_record(8, 10, image, extended=True)
    for i in range(0, len(image), chunk):
        out += iptc_record(8, 10, image[i:i + chunk])
    return out


# ---------------------------------------------------------------- FLI


def fli_chunk(kind, body):
    body = body + b"\0" * (len(body) % 2)
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli_color(palette, shift=0, kind=4, start=0):
    """A COLOR_256 (kind 4) or COLOR_64 (kind 11, values >> shift) chunk of
    palette (n, 3) from entry `start`: one packet."""
    p = (np.asarray(palette, np.int64) >> shift).astype(np.uint8)
    return fli_chunk(kind, struct.pack("<HBB", 1, start, len(p) & 255)
                     + p.tobytes())


def fli_brun(idx):
    """A BRUN chunk of idx (H, W): per row, runs of 3 or more as (count,
    value), the rest as literals of up to 128 bytes."""
    body = b""
    for row in np.asarray(idx, np.uint8):
        packets, x, w = b"", 0, len(row)
        n = 0
        while x < w:
            run = 1
            while x + run < w and row[x + run] == row[x] and run < 127:
                run += 1
            if run >= 3:
                packets += bytes([run, row[x]])
                x += run
            else:
                end = x
                while end < w and end - x < 128 and not (
                        end + 2 < w and row[end] == row[end + 1]
                        == row[end + 2]):
                    end += 1
                end = max(end, x + 1)
                packets += bytes([256 - (end - x)]) + row[x:end].tobytes()
                x = end
            n += 1
        body += bytes([n & 255]) + packets
    return fli_chunk(15, body)


def fli_copy(idx):
    return fli_chunk(16, np.ascontiguousarray(idx, np.uint8).tobytes())


def fli_black():
    return fli_chunk(13, b"")


def fli_pstamp(idx):
    h, w = idx.shape
    return fli_chunk(18, struct.pack("<3H", h, w, 1) + fli_copy(idx))


def fli_lc(prev, idx):
    """An LC (byte delta) chunk turning prev into idx: the changed lines'
    span, per line packets of (skip, literal) and (skip, -run, value)."""
    prev, idx = np.asarray(prev, np.uint8), np.asarray(idx, np.uint8)
    rows = np.flatnonzero((prev != idx).any(1))
    if not len(rows):
        return fli_chunk(12, struct.pack("<2H", 0, 0))
    y0, y1 = int(rows[0]), int(rows[-1]) + 1
    body = struct.pack("<2H", y0, y1 - y0)
    for y in range(y0, y1):
        packets, x, n, w = b"", 0, 0, idx.shape[1]
        diff = prev[y] != idx[y]
        while True:
            nxt = np.flatnonzero(diff[x:])
            if not len(nxt):
                break
            skip = int(nxt[0])
            while skip > 255:                   # an empty literal packet
                packets += bytes([255, 0])
                n, x, skip = n + 1, x + 255, skip - 255
            x += skip
            run = 1
            while x + run < w and idx[y, x + run] == idx[y, x] and run < 128:
                run += 1
            if run >= 3:
                packets += bytes([skip, 256 - run, idx[y, x]])
            else:
                run = min(int(np.flatnonzero(~diff[x:])[0]) if (
                    ~diff[x:]).any() else w - x, 127)
                packets += bytes([skip, run]) + idx[y, x:x + run].tobytes()
            x += run
            n += 1
        body += bytes([n]) + packets
    return fli_chunk(12, body)


def fli_ss2(prev, idx):
    """An SS2 (word delta) chunk turning prev into idx (even-width words;
    an odd width's last byte by the flag word): a skip word before each
    run of unchanged lines, per line packets of (skip, words) and (skip,
    -count, word)."""
    prev, idx = np.asarray(prev, np.uint8), np.asarray(idx, np.uint8)
    h, w = idx.shape
    we = w - w % 2
    body, lines, skip_lines = b"", 0, 0
    for y in range(h):
        if (prev[y] == idx[y]).all():
            skip_lines += 1
            continue
        words = b""
        if skip_lines:
            words += struct.pack("<H", 65536 - skip_lines)
            skip_lines = 0
        if w % 2:
            words += struct.pack("<H", 0x8000 | int(idx[y, w - 1]))
        packets, x, n = b"", 0, 0
        pairs = idx[y, :we].reshape(-1, 2)
        while x < we:
            k = x // 2
            run = 1
            while k + run < len(pairs) and (pairs[k + run] == pairs[k]).all() \
                    and run < 128:
                run += 1
            if run >= 2:
                packets += bytes([0, 256 - run]) + pairs[k].tobytes()
                x += 2 * run
            else:
                m = min(127, len(pairs) - k)
                packets += bytes([0, m]) + pairs[k:k + m].tobytes()
                x += 2 * m
            n += 1
        body += words + struct.pack("<H", n) + packets
        lines += 1
    return fli_chunk(7, struct.pack("<H", lines) + body)


def fli_file(w, h, frames, flc=True, prefix=False):
    """An FLI (magic 0xAF11) or FLC (0xAF12) file of frames, each a list of
    chunks; prefix puts an FLC prefix chunk (0xF100) before frame 0."""
    body = b""
    if prefix:
        body += struct.pack("<IH10x", 16, 0xF100)
    for chunks in frames:
        data = b"".join(chunks)
        body += struct.pack("<IHH8x", 16 + len(data), 0xF1FA,
                            len(chunks)) + data
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(body),
                     0xAF12 if flc else 0xAF11, len(frames), w, h, 8,
                     3 if flc else 0, 5)
    return bytes(head) + body


# ---------------------------------------------------------------- PhotoCD


def pcd_file(y, c1, c2, orientation=0):
    """A PhotoCD file of luma y (512, 768) and chroma c1, c2 (256, 384),
    uint8, its orientation bits `orientation`."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    rows = np.concatenate([np.asarray(y, np.uint8).reshape(256, 1536),
                           np.asarray(c1, np.uint8),
                           np.asarray(c2, np.uint8)], 1)
    return bytes(head) + rows.tobytes()


def pcd_of_rgb(px, orientation=0):
    """A PhotoCD file of RGB px (512, 768, 3): PhotoYCC by the inverse of
    PIL's tables (luma 1.3584 Y; C1 = (B - L) / 2.2179 + 156, C2 = (R - L)
    / 1.8215 + 137, each averaged over 2x2 pixels), rounded."""
    x = np.asarray(px, np.float64)
    lum = x @ np.array([0.299, 0.587, 0.114])
    q = lambda v: np.clip(np.round(v), 0, 255).astype(np.uint8)  # noqa
    box = lambda v: v.reshape(256, 2, 384, 2).mean((1, 3))     # noqa
    return pcd_file(q(lum / 1.3584), q(box((x[..., 2] - lum) / 2.2179 + 156)),
                    q(box((x[..., 0] - lum) / 1.8215 + 137)), orientation)


def phase38_files(sky_px, ground_px):
    """{name: bytes} of chip_smoke.py phase 38's maps: the sky (the
    768x512 sinusoids, time_image_decode.sky) as PhotoCD and the ground's
    decoded samples as FTEX DXT1."""
    return {PCD_SKY: pcd_of_rgb(sky_px), FTEX_GROUND: ftex_dxt1(ground_px)}


# ---------------------------------------------------------------- timing


def fixture_records():
    """The images.json records of the committed fixtures of these formats
    (those with `read_by` naming utils/image_read_pil.py)."""
    record = json.loads((FIXTURES / "images.json").read_text())
    return {k: v for k, v in record.items() if v.get("read_by") == READ_BY}


def decode_fixtures():
    """[(name, seconds, samples' shape, equal to the record)], one decode
    each through image.py's _decode_image, held to the SHA-256 of its
    bytes and of PIL's samples (colours) that images.json records."""
    from acceleratedvolrenderer_tpu_torch.utils import image

    out = []
    for name, rec in sorted(fixture_records().items()):
        data = (FIXTURES / name).read_bytes()
        t = time.perf_counter()
        px = image._decode_image(name, data)
        dt = time.perf_counter() - t
        ok = (hashlib.sha256(data).hexdigest() == rec["sha256_of_bytes"]
              and hashlib.sha256(np.ascontiguousarray(px).tobytes())
              .hexdigest() == rec["sha256_of_pil_samples"])
        out.append((name, dt, px.shape, ok))
    return out


def main():
    import time_image_decode as tid

    print(f"host CPU: {tid.cpu_line()}")
    for name, dt, shape, ok in decode_fixtures():
        print(f"{name}: {shape} decoded in {dt:.4f} s, "
              f"{'equal to PIL' if ok else 'WRONG'}")


if __name__ == "__main__":
    main()
