"""Writers, without PIL, of the files utils/image_read_more.py reads (XBM,
MSP, SPIDER, BLP, SUN raster, XPM), and the host seconds of one decode of
each committed fixture of those formats:

    python3 scripts/more_read_formats.py

  - XBM: the X11 text (`#define` width, height and an optional hotspot,
    then `static char <name>_bits[]` of 0x.. bytes, LSB first);
  - MSP: version 1 (DanM, raw rows) and version 2 (LinS: a row-length
    table, runs of 0, count, value and literals of count, bytes), headers
    whose 16 words XOR to 0;
  - SPIDER: makeSpiderHeader's header of float32 words, either byte
    order, one image or a stack (its header, then each image's header and
    samples);
  - BLP: BLP1 with a palette or JPEG (a baseline JPEG without PIL, cut at
    its first SOS into the shared header and mip 0), BLP2 with a palette
    (any alpha depth and encoding byte) or DXT1 / DXT3 / DXT5 blocks
    (scripts/block_maps.py's BC1 colours, explicit 4-bit alpha for DXT3,
    BC4-coded alpha for DXT5), or any bytes as blocks;
  - SUN raster: depths 1, 4, 8 (gray or a planar RGB map), 24 and 32, raw
    (rows padded to 16 bits) or run-length coded (type 2, the padded
    stream);
  - XPM: `c #rrggbb` colours (and `c None`) of 1 or more characters per
    pixel, an optional `/* pixels */` line.

tests/torch_image_writers.py hands these to the CPU tests;
scripts/make_image_fixtures.py writes the committed fixtures
(tests/data/images/*.xbm ...) with them and PIL, and records the SHA-256
of each file and of PIL's decode of it (colours for bilevel and palette
images) in images.json; chip_smoke.py's side process decodes each
fixture with `decode_fixtures` and holds it to that record.
"""
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


# ---------------------------------------------------------------- XBM


def xbm_file(bits, hotspot=None, name="im", per_line=12, upper=False):
    """An XBM of bits (H, W) (nonzero = set)."""
    h, w = bits.shape
    rows = np.packbits(bits != 0, axis=1, bitorder="little")
    fmt = "0x%02X" if upper else "0x%02x"
    vals = [fmt % v for v in rows.reshape(-1).tolist()]
    text = f"#define {name}_width {w}\n#define {name}_height {h}\n"
    if hotspot is not None:
        text += (f"#define {name}_x_hot {hotspot[0]}\n"
                 f"#define {name}_y_hot {hotspot[1]}\n")
    text += f"static char {name}_bits[] = {{\n"
    text += ",\n".join(", ".join(vals[i:i + per_line])
                       for i in range(0, len(vals), per_line))
    return (text + "\n};\n").encode("ascii")


# ---------------------------------------------------------------- MSP


def _msp_header(magic, w, h):
    words = [struct.unpack("<H", magic[:2])[0],
             struct.unpack("<H", magic[2:])[0], w, h, 1, 1, 1, 1, w, h,
             0, 0, 0, 0, 0, 0]
    check = 0
    for v in words:
        check ^= v
    words[12] = check
    return struct.pack("<16H", *words)


def msp_v1(bits):
    """A version-1 MSP of bits (H, W): raw rows, MSB first."""
    h, w = bits.shape
    return _msp_header(b"DanM", w, h) + np.packbits(bits != 0,
                                                    axis=1).tobytes()


def _msp_rle(row: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(row):
        j = i
        while j < len(row) and row[j] == row[i] and j - i < 255:
            j += 1
        if j - i >= 3:
            out += bytes([0, j - i, row[i]])
            i = j
            continue
        k = i
        while k < len(row) and k - i < 255 and not (
                k + 2 < len(row) and row[k] == row[k + 1] == row[k + 2]):
            k += 1
        out += bytes([k - i]) + row[i:k]
        i = k
    return bytes(out)


def msp_v2(bits, blank=()):
    """A version-2 MSP of bits (H, W): a row-length table, then each row
    in runs and literals; rows in `blank` stored with length 0 (PIL
    fills them white)."""
    h, w = bits.shape
    rows = np.packbits(bits != 0, axis=1)
    coded = [b"" if y in blank else _msp_rle(rows[y].tobytes())
             for y in range(h)]
    return (_msp_header(b"LinS", w, h)
            + struct.pack(f"<{h}H", *[len(c) for c in coded])
            + b"".join(coded))


# ---------------------------------------------------------------- SPIDER


def _spider_header(w, h, n_images=0, number=0):
    lenbyt = w * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    hdr = [0.0] * (labbyt // 4 + 1)
    hdr[1], hdr[2], hdr[5], hdr[12] = 1.0, float(h), 1.0, float(w)
    hdr[13], hdr[22], hdr[23] = float(labrec), float(labbyt), float(lenbyt)
    hdr[24] = float(n_images > 0)
    hdr[26] = float(n_images)
    hdr[27] = float(number)
    return hdr[1:], labbyt


def spider_file(images, big_endian=True):
    """A SPIDER file of float32 images (H, W): one image, or a stack (its
    header, then each image's header and samples) when given a list."""
    order = ">" if big_endian else "<"
    stack = isinstance(images, (list, tuple))
    imgs = list(images) if stack else [images]
    h, w = imgs[0].shape
    if not stack:
        hdr, _ = _spider_header(w, h)
        return struct.pack(f"{order}{len(hdr)}f", *hdr) + imgs[0].astype(
            order + "f4").tobytes()
    hdr, _ = _spider_header(w, h, n_images=len(imgs))
    out = struct.pack(f"{order}{len(hdr)}f", *hdr)
    for k, img in enumerate(imgs):
        sub, _ = _spider_header(w, h, number=k + 1)
        out += struct.pack(f"{order}{len(sub)}f", *sub)
        out += img.astype(order + "f4").tobytes()
    return out


# ---------------------------------------------------------------- BLP


def _mips(n0, start):
    """The 16 offsets and lengths of one mip of n0 bytes at start."""
    return (struct.pack("<16I", start, *(0,) * 15)
            + struct.pack("<16I", n0, *(0,) * 15))


def blp1_palette(idx, palette_bgra, alpha=False, encoding=4):
    """A BLP1 of indices idx (H, W) through palette_bgra (256, 4) BGRA."""
    h, w = idx.shape
    head = b"BLP1" + struct.pack("<iIIIiI", 1, 8 if alpha else 0, w, h,
                                 encoding, 1)
    start = 28 + 128 + 1024
    return (head + _mips(w * h, start) + palette_bgra.astype(np.uint8)
            .tobytes() + idx.astype(np.uint8).tobytes())


def blp1_jpeg(jpeg: bytes, w, h, alpha=False):
    """A BLP1 of a JPEG: its bytes before the first SOS as the shared
    header, the rest as mip 0, after a gap of 4 bytes."""
    cut = jpeg.index(b"\xff\xda")
    header, body = jpeg[:cut], jpeg[cut:]
    head = b"BLP1" + struct.pack("<iIIIiI", 0, 8 if alpha else 0, w, h, 5, 1)
    start = 28 + 128 + 4 + len(header) + 4
    return (head + _mips(len(body), start) + struct.pack("<I", len(header))
            + header + b"\0" * 4 + body)


def blp2_palette(idx, palette_bgra, alpha_depth=0, alpha_encoding=0):
    """A BLP2 of indices idx (H, W) through palette_bgra (256, 4) BGRA."""
    h, w = idx.shape
    head = b"BLP2" + struct.pack("<ibbbbII", 1, 1, alpha_depth,
                                 alpha_encoding, 0, w, h)
    start = 20 + 128 + 1024
    return (head + _mips(w * h, start) + palette_bgra.astype(np.uint8)
            .tobytes() + idx.astype(np.uint8).tobytes())


_DXT_CODES = {"DXT1": 0, "DXT3": 1, "DXT5": 7}


def blp2_blocks(blocks: bytes, w, h, kind, alpha_depth=8, compression=1,
                encoding=2):
    """A BLP2 of DXT blocks (bytes) of `kind` at w x h; the palette PIL
    reads and ignores is zeros."""
    head = b"BLP2" + struct.pack("<ibbbbII", compression, encoding,
                                 alpha_depth, _DXT_CODES.get(kind, kind), 0,
                                 w, h)
    start = 20 + 128 + 1024
    return head + _mips(len(blocks), start) + bytes(1024) + blocks


def dxt_blocks(px, kind):
    """DXT blocks of RGBA px (H, W, 4), H and W multiples of 4: BC1 colours
    (block_maps' encoder), with explicit 4-bit alpha (DXT3) or BC4-coded
    alpha (DXT5) before them."""
    import block_maps

    if kind == "DXT1":
        return block_maps.encode_bc1(px)
    if kind == "DXT5":
        return block_maps.encode_bc3(px)
    b = block_maps.blocks_of(px)
    a = (b[..., 3] + 8) // 17
    alpha = (a[:, 0::2] | (a[:, 1::2] << 4)).astype(np.uint8)
    colour = np.frombuffer(block_maps.encode_bc1(px), np.uint8).reshape(
        -1, 8)
    return np.concatenate([alpha, colour], 1).tobytes()


# ---------------------------------------------------------------- SUN


def _sun_runs(raw: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(raw):
        j = i
        while j < len(raw) and raw[j] == raw[i] and j - i < 256:
            j += 1
        n = j - i
        if n >= 3 or raw[i] == 0x80:
            if n == 1:
                out += b"\x80\x00"
            elif n == 2 and raw[i] == 0x80:
                out += b"\x80\x00\x80\x00"
            else:
                out += bytes([0x80, n - 1, raw[i]])
            i = j
        else:
            out += raw[i:j]
            i = j
    return bytes(out)


def sun_file(px, depth, rle=False, palette=None, rgb_order=False):
    """A Sun raster file of px: (H, W) bits (depth 1, nonzero = set), 4- or
    8-bit values (H, W), or (H, W, 3) RGB (depths 24 and 32, stored BGR(X)
    or with rgb_order RGB(X), type 3); palette (n, 3) RGB written planar
    (map type 1); rows padded to 16 bits, run-length coded when rle."""
    h, w = px.shape[:2]
    if depth == 1:
        rows = np.packbits(px != 0, axis=1)
    elif depth == 4:
        v = np.zeros((h, w + (w & 1)), np.uint8)
        v[:, :w] = px
        rows = (v[:, 0::2] << 4) | v[:, 1::2]
    elif depth == 8:
        rows = px.astype(np.uint8)
    else:
        c = px[..., :3] if rgb_order else px[..., 2::-1]
        if depth == 32:
            c = np.concatenate([c, np.full((h, w, 1), 0xA5, np.uint8)], -1)
        rows = c.reshape(h, -1)
    stride = ((w * depth + 15) // 16) * 2
    raw = np.zeros((h, stride), np.uint8)
    raw[:, :rows.shape[1]] = rows
    body = raw.tobytes()
    ftype = 2 if rle else (3 if rgb_order else 1)
    if rle:
        body = _sun_runs(body)
    cmap = b""
    if palette is not None:
        cmap = np.asarray(palette, np.uint8).T.tobytes()
    head = struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), ftype,
                       1 if palette is not None else 0, len(cmap))
    return head + cmap + body


# ---------------------------------------------------------------- XPM

_XPM_CHARS = ("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
              "0123456789.+@#$%&*=-;>,')!~{]^/(_:<[}|`")


def xpm_file(idx, palette, cpp=1, none_key=None, pixels_line=True,
             extra_words=False):
    """An XPM of indices idx (H, W) into palette (n, 3) RGB, cpp characters
    per pixel; none_key, if given, an extra `c None` entry's key (which
    no pixel uses, as PIL cannot read one that does); extra_words puts an
    `m` key before each `c`."""
    h, w = idx.shape
    n = len(palette)
    keys = []
    for i in range(n):
        k, s = i, ""
        for _ in range(cpp):
            s += _XPM_CHARS[k % len(_XPM_CHARS)]
            k //= len(_XPM_CHARS)
        keys.append(s)
    lines = ["/* XPM */", "static char *image[] = {",
             f'"{w} {h} {n + (none_key is not None)} {cpp}",']
    for k, (r, g, b) in zip(keys, np.asarray(palette).tolist()):
        m = "m #000000 " if extra_words else ""
        lines.append(f'"{k} {m}c #{r:02x}{g:02x}{b:02x}",')
    if none_key is not None:
        lines.append(f'"{none_key} c None",')
    if pixels_line:
        lines.append("/* pixels */")
    for y in range(h):
        lines.append('"' + "".join(keys[i] for i in idx[y]) + '"'
                     + ("," if y < h - 1 else ""))
    lines.append("};")
    return ("\n".join(lines) + "\n").encode("ascii")


# ---------------------------------------------------------------- timing


def fixture_records():
    """The images.json records of the committed fixtures of these formats
    (those with `read_by` naming utils/image_read_more.py)."""
    record = json.loads((FIXTURES / "images.json").read_text())
    return {k: v for k, v in record.items()
            if v.get("read_by") == "utils/image_read_more.py"}


def decode_fixtures():
    """[(name, seconds, samples' shape, equal to the record)], one decode
    each through image.py's _decode_image, held to the SHA-256 of PIL's
    samples (colours) that images.json records."""
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
