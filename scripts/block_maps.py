"""Writers, without PIL (the card's host has none), of the files the port's
newer readers take, and the host seconds of their decodes at an
environment map's size, 2048x1024:

    python3 scripts/block_maps.py [--width 2048 --height 1024]

  - block-compressed DDS: small encoders in integer numpy arithmetic, so a
    file's bytes are the same on any host: BC1, BC3 (BC1 colours and a BC4
    alpha), BC4 and BC5 (DXT1, DXT5, BC4U and BC5U FourCCs), BC6H UF16 in
    its one-region mode 11 (10-bit endpoints, 4-bit indices; samples taken
    as 8-bit targets of PIL's decode, half floats clamped to [0, 1]) and
    BC7 in mode 6 (7-bit RGBA endpoints with a p-bit each, 4-bit indices),
    each block's endpoints its extremes and its indices their projections
    (DX10 headers for BC6H and BC7); `dds_blocks` puts any blocks under
    a header;
  - palette DDS (8-bit indices, a 256-entry RGBA palette);
  - PSD: any colour mode and depth, raw or PackBits (`packbits_rows`, all
    rows at once), with or without a layer;
  - BigTIFF: a classic TIFF's strips and fields under a BigTIFF header
    (`bigtiff`);
  - ICO and CUR: entries of PNG (utils/image.py's encode_png) or bitmaps
    (1-, 4-, 8-, 24- and 32-bit, with their AND masks).

chip_smoke.py phase 34 rebuilds its maps by `block_files` (the sky) and
`encode_dds` (the ground) and decodes them and `lossless_files` by
`decode_all`; scripts/make_image_fixtures.py records the SHA-256 of each
block-compressed file and of PIL's decode of it in
tests/data/images/images.json; tests/torch_image_writers.py hands these
writers to the CPU tests.
"""
import argparse
import struct
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from acceleratedvolrenderer_tpu_torch.utils import image  # noqa: E402

import time_image_decode as tid  # noqa: E402

# ---------------------------------------------------------------------------
# block encoders
# ---------------------------------------------------------------------------

W4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64])


def blocks_of(px):
    """(H, W, C) with H, W multiples of 4 -> (n, 16, C) int64, blocks
    row-major, pixels row-major within each."""
    h, w, c = px.shape
    b = px.reshape(h // 4, 4, w // 4, 4, c).transpose(0, 2, 1, 3, 4)
    return b.reshape(-1, 16, c).astype(np.int64)


def _levels(p, e0, e1, weights):
    """(n, 16) index of the weight (of 64ths from e0 to e1, increasing)
    nearest each pixel's projection onto the segment e0 -> e1 (n, C), the
    lower of two as near; integers only but the midpoints' halves."""
    d = e1 - e0
    den = (d * d).sum(-1)[:, None]
    num = ((p - e0[:, None]) * d[:, None]).sum(-1)
    t64 = np.where(den > 0, (128 * num + den) // np.maximum(2 * den, 1), 0)
    w = np.asarray(weights)
    return np.searchsorted((w[1:] + w[:-1]) / 2, t64, "left")


def _pack(fields, n):
    """Blocks of (values (n,) or (n, k), bits each) fields, lowest bit
    first, into (n, 16) bytes (two little-endian 64-bit words)."""
    words = np.zeros((n, 2), np.uint64)
    pos = 0
    for v, nb in fields:
        for col in np.asarray(v, np.int64).reshape(n, -1).T:
            c = col.astype(np.uint64) & np.uint64((1 << nb) - 1)
            w, sh = divmod(pos, 64)
            words[:, w] |= c << np.uint64(sh)
            if sh + nb > 64:
                words[:, w + 1] |= c >> np.uint64(64 - sh)
            pos += nb
    assert pos == 128
    return words.astype("<u8").view(np.uint8).reshape(n, 16)


def _bc4_block(v):
    """(n, 8) BC4 blocks of (n, 16) values: a0 the largest, a1 the
    smallest, eight-value mode."""
    a0, a1 = v.max(1), v.min(1)
    q = _levels(v[..., None], a0[:, None], a1[:, None], np.arange(8) * 64 // 7)
    idx = np.array([0, 2, 3, 4, 5, 6, 7, 1])[q]
    idx = np.where((a0 == a1)[:, None], 0, idx)
    lut = (idx << (3 * np.arange(16))).sum(1)
    out = np.zeros((len(v), 8), np.uint8)
    out[:, 0], out[:, 1] = a0, a1
    for i in range(6):
        out[:, 2 + i] = (lut >> (8 * i)) & 0xFF
    return out


def _bc1_block(p):
    """(n, 8) BC1 blocks of (n, 16, 3) colours: the channels' maxima and
    minima in 5-6-5, four-colour mode (all index 0 where they are equal)."""
    hi, lo = p.max(1), p.min(1)

    def q565(c):
        r, g, b = ((c[:, 0] * 31 + 127) // 255, (c[:, 1] * 63 + 127) // 255,
                   (c[:, 2] * 31 + 127) // 255)
        return (r << 11) | (g << 5) | b

    def rgb(x):
        r, g, b = (x >> 11) << 3, ((x >> 5) & 63) << 2, (x & 31) << 3
        return np.stack([r | (r >> 5), g | (g >> 6), b | (b >> 5)], -1)

    c0, c1 = q565(hi), q565(lo)
    q = _levels(p, rgb(c0), rgb(c1), [0, 21, 43, 64])
    idx = np.where((c0 == c1)[:, None], 0, np.array([0, 2, 3, 1])[q])
    lut = (idx << (2 * np.arange(16))).sum(1)
    out = np.zeros((len(p), 8), np.uint8)
    for i, v in enumerate((c0, c0 >> 8, c1, c1 >> 8, lut, lut >> 8,
                           lut >> 16, lut >> 24)):
        out[:, i] = v & 0xFF
    return out


def encode_bc1(px):
    return _bc1_block(blocks_of(px[..., :3])).tobytes()


def encode_bc3(px):
    """px (H, W, 4): BC4-coded alpha, then BC1 colours."""
    b = blocks_of(px)
    return np.concatenate([_bc4_block(b[..., 3]), _bc1_block(b[..., :3])],
                          1).tobytes()


def encode_bc4(px):
    return _bc4_block(blocks_of(px[..., :1])[..., 0]).tobytes()


def encode_bc5(px):
    b = blocks_of(px[..., :2])
    return np.concatenate([_bc4_block(b[..., 0]), _bc4_block(b[..., 1])],
                          1).tobytes()


def encode_bc7(px):
    """BC7 mode 6 of RGB px: endpoints the channels' minima and maxima
    with the low bit 1 (every p-bit 1: alpha 127 and its p-bit give 255),
    4-bit indices, the anchor's high bit cleared by swapping the ends."""
    p = blocks_of(px[..., :3])
    n = len(p)
    e = np.stack([p.min(1), p.max(1)], 1) >> 1              # (n, 2, 3) 7-bit
    q = _levels(p, 2 * e[:, 0] + 1, 2 * e[:, 1] + 1, W4)
    swap = q[:, 0] >= 8
    e = np.where(swap[:, None, None], e[:, ::-1], e)
    q = np.where(swap[:, None], 15 - q, q)
    return _pack([(np.full(n, 64), 7)]
                 + [(e[:, :, c], 7) for c in range(3)]
                 + [(np.full((n, 2), 127), 7), (np.ones((n, 2)), 1),
                    (q[:, :1], 3), (q[:, 1:], 4)], n).tobytes()


def _half_u8(hb):
    """PIL's 8-bit sample of the half floats with bits hb >= 0: the value
    clamped to [0, 1] times 255, truncated, in integers."""
    e, m = hb >> 10, hb & 1023
    sub = (m * 255) >> 24
    norm = ((1024 + m) * 255) >> np.maximum(25 - e, 0)
    return np.where(e == 0, sub, np.where(e >= 15, 255, norm))


# for each 8-bit target, the middle of the unquantized 16-bit endpoint
# values (e -> half bits (e * 31) >> 6) that PIL decodes to it
_E = np.arange(1 << 16)
_E_U8 = _half_u8((_E * 31) >> 6)
E_OF_U8 = np.array([(_E[_E_U8 == t].min() + _E[_E_U8 == t].max()) // 2
                    for t in range(256)])


def encode_bc6h(px):
    """BC6H UF16 mode 11 (one region, 10-bit endpoints, 4-bit indices) of
    uint8 RGB px, each sample the target of PIL's 8-bit decode: endpoints
    the channels' extremes of the targets' unquantized values."""
    p = E_OF_U8[blocks_of(px[..., :3])]                     # (n, 16, 3)
    n = len(p)
    x = np.stack([p.min(1), p.max(1)], 1) // 64             # 10-bit
    unq = np.where(x == 0, 0, np.where(x == 1023, 0xFFFF,
                                       ((x << 15) + 0x4000) >> 9))
    q = _levels(p, unq[:, 0], unq[:, 1], W4)
    swap = q[:, 0] >= 8
    x = np.where(swap[:, None, None], x[:, ::-1], x)
    q = np.where(swap[:, None], 15 - q, q)
    return _pack([(np.full(n, 3), 5), (x[:, 0], 10), (x[:, 1], 10),
                  (q[:, :1], 3), (q[:, 1:], 4)], n).tobytes()


# ---------------------------------------------------------------------------
# DDS
# ---------------------------------------------------------------------------

FOURCC = {"BC1": b"DXT1", "BC2": b"DXT3", "BC3": b"DXT5", "BC4": b"BC4U",
          "BC5": b"BC5U", "BC5S": b"BC5S"}
DXGI = {"BC1": 71, "BC2": 74, "BC3": 77, "BC4": 80, "BC5": 83, "BC5S": 84,
        "BC6H": 95, "BC6HS": 96, "BC7": 98}
ENCODERS = {"BC1": encode_bc1, "BC3": encode_bc3, "BC4": encode_bc4,
            "BC5": encode_bc5, "BC6H": encode_bc6h, "BC7": encode_bc7}


def _dds_head(w, h, pf_flags, fourcc=b"\0\0\0\0", bitcount=0,
              masks=(0, 0, 0, 0)):
    return (b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 1)
            + b"\0" * 44 + struct.pack("<2I", 32, pf_flags) + fourcc
            + struct.pack("<5I", bitcount, *masks)
            + struct.pack("<5I", 0x1000, 0, 0, 0, 0))


def dds_blocks(kind, blocks, w, h, dx10=None, fourcc=None):
    """A DDS of the block bytes `blocks` of `kind` (a key of DXGI) at w x h:
    under the FourCC `fourcc`, else the kind's where it has one and dx10
    is not asked, else under a DX10 header naming the DXGI format dx10
    (default the kind's)."""
    if fourcc or (kind in FOURCC and dx10 is None):
        return _dds_head(w, h, 0x4, fourcc or FOURCC[kind]) + bytes(blocks)
    return (_dds_head(w, h, 0x4, b"DX10")
            + struct.pack("<5I", dx10 or DXGI[kind], 3, 0, 1, 0)
            + bytes(blocks))


def encode_dds(kind, px):
    """px (H, W, C) uint8, H and W multiples of 4, block-compressed."""
    h, w = px.shape[:2]
    return dds_blocks(kind, ENCODERS[kind](px), w, h)


def palette_dds(idx, palette):
    """An 8-bit palette DDS of idx (H, W) and palette (256, 4) RGBA."""
    h, w = idx.shape
    return (_dds_head(w, h, 0x20, bitcount=8)
            + np.asarray(palette, np.uint8).tobytes()
            + np.asarray(idx, np.uint8).tobytes())


# ---------------------------------------------------------------------------
# PackBits and PSD
# ---------------------------------------------------------------------------


def packbits_rows(rows):
    """PackBits of each row of rows (R, L) uint8 -> (bytes, per-row byte
    counts): runs of 3 or more equal bytes as repeats of at most 128 (a
    one-byte tail as a literal), the rest as literals of at most 128."""
    rows = np.asarray(rows, np.uint8)
    r, n = rows.shape
    a = rows.reshape(-1).astype(np.int64)
    pos = np.arange(a.size)
    new = np.ones(a.size, bool)
    new[1:] = (a[1:] != a[:-1]) | (pos[1:] % n == 0)
    starts = np.flatnonzero(new)
    lens = np.diff(np.append(starts, a.size))
    run = lens >= 3
    # a token: a run, or a stretch of literal bytes within a row
    kind = np.repeat(run, lens)
    tok_new = (pos % n == 0) | (kind & new)
    tok_new[1:] |= ~kind[1:] & kind[:-1]
    tstart = np.flatnonzero(tok_new)
    tlen = np.diff(np.append(tstart, a.size))
    trun = kind[tstart]
    # chunks of at most 128 bytes
    nch = -(-tlen // 128)
    cowner = np.repeat(np.arange(len(tstart)), nch)
    cpos = np.arange(len(cowner)) - (np.cumsum(nch) - nch)[cowner]
    cstart = tstart[cowner] + 128 * cpos
    clen = np.minimum(tlen[cowner] - 128 * cpos, 128)
    crun = trun[cowner] & (clen >= 2)
    header = np.where(crun, 257 - clen, clen - 1)
    payload = np.where(crun, 1, clen)
    osize = 1 + payload
    owner = np.repeat(np.arange(len(cstart)), osize)
    within = np.arange(len(owner)) - (np.cumsum(osize) - osize)[owner]
    out = np.where(within == 0, header[owner],
                   a[np.minimum(cstart[owner] + np.where(
                       crun[owner], 0, within - 1), a.size - 1)])
    counts = np.bincount(cstart // n, weights=osize, minlength=r).astype(
        np.int64)
    return out.astype(np.uint8).tobytes(), counts


PSD_MODES = {"1": (0, 1), "L": (1, 8), "P": (2, 8), "RGB": (3, 8),
             "CMYK": (4, 8), "multichannel": (7, 8), "duotone": (8, 8),
             "LAB": (9, 8)}


def psd_file(planes, mode, rle=False, palette=None, layer=False,
             depth=None):
    """A PSD of the channel planes (C, H, W) uint8 (for mode "1", the rows
    packed 8 pixels a byte, (1, H, ceil(W / 8))) in colour mode `mode` (a
    key of PSD_MODES; depth overrides its bits), raw or PackBits; palette
    (256, 3) for mode "P"; an image resource always, and with layer a
    layer section (one layer of the first channels)."""
    planes = np.asarray(planes, np.uint8)
    c, h = planes.shape[:2]
    cmode, bits = PSD_MODES[mode]
    bits = depth or bits
    w = planes.shape[2] * 8 if mode == "1" else planes.shape[2]
    out = b"8BPS" + struct.pack(">H6xHIIHH", 1, c, h, w, bits, cmode)
    cmd = b""
    if palette is not None:
        cmd = np.asarray(palette, np.uint8).T.tobytes()
    elif mode == "duotone":
        cmd = b"\0" * 20
    out += struct.pack(">I", len(cmd)) + cmd
    res = b"8BIM" + struct.pack(">H", 1005) + b"\0\0" + struct.pack(
        ">I", 16) + b"\0" * 16
    out += struct.pack(">I", len(res)) + res
    lay = b""
    if layer:
        n = min(c, 3)
        rec = struct.pack(">iiiiH", 0, 0, h, w, n)
        for i in range(n):
            rec += struct.pack(">hI", i, 2 + h * w)
        rec += b"8BIMnorm" + bytes([255, 0, 0, 0])
        extra = struct.pack(">II", 0, 0) + b"\x05layer" + b"\0" * 2
        rec += struct.pack(">I", len(extra)) + extra
        chans = b"".join(b"\0\0" + planes[i].tobytes() for i in range(n))
        info = struct.pack(">h", 1) + rec + chans
        info += b"\0" * (len(info) & 1)
        lay = struct.pack(">I", len(info)) + info + struct.pack(">I", 0)
    out += struct.pack(">I", len(lay)) + lay
    if rle:
        body, counts = packbits_rows(planes.reshape(c * h, -1))
        out += struct.pack(">H", 1) + counts.astype(">u2").tobytes() + body
    else:
        out += struct.pack(">H", 0) + planes.tobytes()
    return out


# ---------------------------------------------------------------------------
# BigTIFF
# ---------------------------------------------------------------------------

_TSIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
          11: 4, 12: 8, 13: 4}


def bigtiff(data, long8=(273, 279, 324, 325)):
    """The classic TIFF `data` as a BigTIFF: its image data kept where it
    is (the header grows 8 bytes: offsets move), its first IFD's fields
    as 20-byte entries, the offsets and byte counts of strips and tiles
    (the tags in long8) as LONG8 (type 16)."""
    bo = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(bo + "I", data, 4)
    (n,) = struct.unpack_from(bo + "H", data, ifd)
    fields = []
    for i in range(n):
        tag, typ, count, value = struct.unpack_from(bo + "HHI4s", data,
                                                    ifd + 2 + 12 * i)
        size = _TSIZE[typ] * count
        raw = value[:size] if size <= 4 else data[
            struct.unpack(bo + "I", value)[0]:][:size]
        fields.append((tag, typ, count, raw))
    shift = 8
    body = bytearray(b"\0" * 16) + data[8:]
    out = []
    for tag, typ, count, raw in fields:
        if tag in long8:
            code = {3: "H", 4: "I"}[typ]
            vals = struct.unpack(bo + code * count, raw)
            if tag in (273, 324):
                vals = [v + shift for v in vals]
            typ, raw = 16, struct.pack(bo + "Q" * count, *vals)
        out.append((tag, typ, count, raw))
    at = len(body) + (len(body) & 1)
    body += b"\0" * (len(body) & 1)
    tail_at = at + 8 + 20 * len(out) + 8
    ents, tail = b"", b""
    for tag, typ, count, raw in out:
        if len(raw) <= 8:
            ents += struct.pack(bo + "HHQ", tag, typ, count) + raw.ljust(
                8, b"\0")
        else:
            ents += struct.pack(bo + "HHQQ", tag, typ, count,
                                tail_at + len(tail))
            tail += raw + b"\0" * (len(raw) & 1)
    body += struct.pack(bo + "Q", len(out)) + ents + b"\0" * 8 + tail
    body[:16] = data[:2] + struct.pack(bo + "HHHQ", 43, 8, 0, at)
    return bytes(body)


# ---------------------------------------------------------------------------
# ICO and CUR
# ---------------------------------------------------------------------------


def icon_dib(px, bpp, mask=None, palette=None):
    """An icon bitmap: a BITMAPINFOHEADER (height doubled), the XOR image
    of px (H, W, 3 or 4; for bpp <= 8, indices (H, W) into palette
    (n, 3)), bottom-up, rows padded to 4 bytes, then the AND mask (H, W)
    of 0 / 1 (default from the alpha of a 32-bit px, else 0), rows padded
    to 32 bits."""
    px = np.asarray(px)
    h, w = px.shape[:2]
    pal = b""
    if bpp <= 8:
        pal = np.concatenate([np.asarray(palette, np.uint8)[:, ::-1],
                              np.zeros((len(palette), 1), np.uint8)],
                             1).tobytes()
        bits = np.unpackbits(px.astype(np.uint8)[..., None], axis=-1)[
            ..., 8 - bpp:]
        packed = np.packbits(bits.reshape(h, -1), axis=1)
    elif bpp == 24:
        packed = px[..., 2::-1].reshape(h, -1)
    else:
        packed = px[..., [2, 1, 0, 3]].reshape(h, -1)
    stride = (w * bpp + 31) // 32 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :packed.shape[1]] = packed
    if mask is None:
        mask = (px[..., 3] == 0) if bpp == 32 else np.zeros((h, w), bool)
    mstride = (w + 31) // 32 * 4
    mrows = np.zeros((h, mstride), np.uint8)
    m = np.packbits(np.asarray(mask, np.uint8), axis=1)
    mrows[:, :m.shape[1]] = m
    head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bpp, 0,
                       stride * h + mstride * h, 0, 0, len(pal) // 4, 0)
    return head + pal + rows[::-1].tobytes() + mrows[::-1].tobytes()


def icon_file(entries, cursor=False):
    """An ICO (or with cursor a CUR) of entries [(w, h, bpp, payload)]: each
    payload a PNG or icon_dib's bitmap."""
    out = struct.pack("<HHH", 0, 2 if cursor else 1, len(entries))
    off = 6 + 16 * len(entries)
    body = b""
    for w, h, bpp, payload in entries:
        ncol = 1 << bpp if bpp < 8 else 0
        out += struct.pack("<BBBBHHII", w & 255, h & 255, ncol, 0,
                           1 if not cursor else 0, bpp, len(payload),
                           off + len(body))
        body += payload
    return out + body


# ---------------------------------------------------------------------------
# phase 34's maps and timing
# ---------------------------------------------------------------------------

SKY = (2048, 1024)


def _gray_alpha(s8):
    """The sky's alpha plane for BC3: bands of its blue channel."""
    return (s8[..., 2].astype(np.int64) * 3 & 255).astype(np.uint8)


def block_files(width=SKY[0], height=SKY[1]):
    """{name: DDS bytes} of the sky at width x height in each block format
    phase 34 (c) times (images.json holds each's hashes at 2048x1024)."""
    s8 = tid.sky(width, height, 255)
    rgba = np.concatenate([s8, _gray_alpha(s8)[..., None]], -1)
    return {f"sky_{width}x{height}_{k.lower()}.dds": encode_dds(k, src)
            for k, src in (("BC1", s8), ("BC3", rgba), ("BC4", s8),
                           ("BC5", s8), ("BC6H", s8), ("BC7", s8))}


def lossless_files(width=SKY[0], height=SKY[1], tiff8=None):
    """[(name, bytes, samples the decode must give)] of the lossless files
    phase 34 (c) times: a palette DDS, a PackBits RGB PSD, an LZW BigTIFF
    (the strips of tiff8, time_image_decode's 8-bit LZW sky TIFF, when
    given) and an ICO of a 256x256 32-bit bitmap entry and a 256x256 PNG
    entry (PIL loads the first of the largest and shallowest: the
    bitmap, its alpha the pixels' fourth bytes)."""
    s8 = tid.sky(width, height, 255)
    i = np.arange(256)
    pal = np.stack([(i >> 5) * 36, (i >> 2 & 7) * 36, (i & 3) * 85,
                    255 - i], -1).astype(np.uint8)
    idx = ((s8[..., 0].astype(np.int64) >> 5 << 5)
           | (s8[..., 1] >> 5 << 2) | (s8[..., 2] >> 6))
    tiff8 = tiff8 or tid.encode_tiff(s8)
    icon = np.concatenate([s8[:256, :256], _gray_alpha(s8[:256, :256])[
        ..., None]], -1)
    ico = icon_file([(256, 256, 32, icon_dib(icon, 32)),
                     (256, 256, 32, image.encode_png(icon))])
    return [("DDS 8-bit palette", palette_dds(idx, pal), pal[idx]),
            ("PSD RGB PackBits", psd_file(s8.transpose(2, 0, 1), "RGB",
                                          rle=True), s8),
            ("BigTIFF 8-bit RGB LZW + predictor", bigtiff(tiff8), s8),
            ("ICO 256x256 32-bit bitmap + PNG", ico, icon)]


def decode_all(blocks, lossless, record=None):
    """[(name, file bytes, decode seconds, samples' shape, ok)], one decode
    each by utils/image.py's _decode_image of the block-compressed files
    blocks {name: bytes} (ok: the bytes and the samples at the SHA-256 of
    record's (images.json's) entry of the name; always, without record)
    and of the lossless files [(name, bytes, samples)] (ok: equal to the
    samples)."""
    import hashlib

    out = []
    for name, data, want in [(n, d, None) for n, d in blocks.items()] + [
            tuple(f) for f in lossless]:
        t0 = time.time()
        got = image._decode_image(name, data)
        secs = time.time() - t0
        if want is not None:
            ok = got.shape == want.shape and np.array_equal(got, want)
        elif record is None:
            ok = True
        else:
            rec = record.get(name, {})
            ok = (hashlib.sha256(data).hexdigest() == rec.get(
                "sha256_of_bytes") and list(got.shape[:2]) == rec.get(
                "shape", [])[:2] and hashlib.sha256(np.ascontiguousarray(
                    got).tobytes()).hexdigest() == rec.get(
                "sha256_of_pil_samples"))
        out.append((name, len(data), secs, got.shape, bool(ok)))
    return out


def main():
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=SKY[0])
    ap.add_argument("--height", type=int, default=SKY[1])
    a = ap.parse_args()
    record = None                       # images.json's files are 2048x1024
    if (a.width, a.height) == SKY:
        record = json.loads((ROOT / "tests/data/images/images.json")
                            .read_text())
    print(f"host CPU: {tid.cpu_line()}")
    t0 = time.time()
    blocks = block_files(a.width, a.height)
    t1 = time.time()
    lossless = lossless_files(a.width, a.height)
    print(f"block-compressed files written in {t1 - t0:.2f} s, lossless "
          f"files in {time.time() - t1:.2f} s")
    bad = []
    for name, size, secs, shape, ok in decode_all(blocks, lossless, record):
        print(f"{name} {shape[1]}x{shape[0]}: {size} bytes; decode "
              f"{secs:.3f} s; {'right' if ok else 'WRONG'}")
        if not ok:
            bad.append(name)
    if bad:
        raise SystemExit(f"wrong decodes: {bad}")


if __name__ == "__main__":
    main()
