"""Image files for the image-format tests, written without PIL where PIL
cannot write them: JPEG of any sampling, colour space and markers,
arithmetic-coded (libjpeg's QM coder, jcarith.c) and lossless (SOF3)
JPEG; TIFF of every compression, predictor, layout and byte order; RLE
BMP; DIB under 12-, 40-, 108- and 124-byte headers; RLE and 16-bit SGI;
1-bit PCX in one, two or four planes.  Built on
scripts/time_image_decode.py's writers, whose procedural images and GIF,
QOI, netpbm and LZW writers are imported here too, as are
scripts/block_maps.py's (block-compressed and palette DDS, PSD, BigTIFF,
ICO and CUR), scripts/more_read_formats.py's (XBM, MSP, SPIDER, BLP,
SUN raster, XPM) and scripts/pil_only_formats.py's (DCX, PIXAR, FTEX, GBR,
XV thumbnail, McIDAS, IMT, FITS, IPTC, FLI / FLC, PhotoCD), so that the
tests take their files from this one module.
"""
import io
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

from acceleratedvolrenderer_tpu_torch.utils import image

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from time_image_decode import (  # noqa: E402,F401
    JFIF, BitWriter, baseline_jpeg, dqt, encode_gif, encode_netpbm,
    encode_qoi, jpeg_planes, lzw_encode, scene, segment, sky, tiff_entry,
    tiff_file, ycc)
from block_maps import (  # noqa: E402,F401
    bigtiff, block_files, dds_blocks, encode_dds, icon_dib, icon_file,
    packbits_rows, palette_dds, psd_file)
from more_read_formats import (  # noqa: E402,F401
    blp1_jpeg, blp1_palette, blp2_blocks, blp2_palette, dxt_blocks,
    msp_v1, msp_v2, spider_file, sun_file, xbm_file, xpm_file)
from pil_only_formats import (  # noqa: E402,F401
    dcx_file, fits_file, fits_gzip_file, fli_black, fli_brun, fli_chunk,
    fli_color, fli_copy, fli_file, fli_lc, fli_pstamp, fli_ss2, ftex_dxt1,
    ftex_file, ftex_rgb, gbr_file, imt_file, iptc_file, mcidas_file,
    pcd_file, pcd_of_rgb, pixar_file, rgb_to_332, xvthumb_file)


# ---------------------------------------------------------------- JPEG


def encode_jpeg(img, sampling=((2, 2), (1, 1), (1, 1)), space="ycc",
                adobe=None, jfif=True, ids=None):
    """A baseline JPEG of uint8 img (H, W, C): components made by `space`
    ("gray" one, "ycc" JFIF YCbCr of RGB, "rgb" as given, "cmyk" / "ycck"
    four: the given channels, or YCbCr of the first three and the
    fourth), each (h, v) of `sampling` (box-averaged down), an APP0 JFIF
    marker when jfif, an APP14 Adobe marker with transform `adobe` when
    not None, component ids `ids` (default 1, 2, ...)."""
    h, w = img.shape[:2]
    x = img.astype(np.float64).reshape(h, w, -1)
    if space in ("ycc", "ycck"):
        comps = ycc(x) + ([x[..., 3]] if space == "ycck" else [])
    else:
        comps = [x[..., i] for i in range(x.shape[2])]
    head = JFIF if jfif else b""
    if adobe is not None:
        head += segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                        + bytes([adobe]))
    return baseline_jpeg(comps, sampling, w, h, head, ids)


def encode_jpeg_lossless(img, predictor=1, pt=0, restart_rows=0, ids=None,
                         adobe=None, jfif=False):
    """An 8-bit lossless (SOF3) JPEG of uint8 img (H, W, C): predictor
    1-7 on the samples shifted right by the point transform pt, each
    difference's category in a flat table of 5-bit codes, a restart every
    restart_rows rows; markers and ids as encode_jpeg's."""
    h, w = img.shape[:2]
    x = img.reshape(h, w, -1).astype(np.int64) >> pt
    n = x.shape[2]
    codes = {s: (s, 5) for s in range(17)}
    bw, out = BitWriter(), b""
    first = 1 << (7 - pt)
    for r in range(h):
        if restart_rows and r and r % restart_rows == 0:
            out += bw.flush() + bytes([0xFF, 0xD0 + (r // restart_rows - 1)
                                       % 8])
            bw = BitWriter()
        top = restart_rows and r % restart_rows == 0 or r == 0
        for c in range(w):
            for ci in range(n):
                ra = x[r, c - 1, ci] if c else 0
                rb = x[r - 1, c, ci] if r else 0
                rc = x[r - 1, c - 1, ci] if r and c else 0
                if top:
                    pred = ra if c else first
                elif c == 0:
                    pred = rb
                else:
                    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                            5: ra + ((rb - rc) >> 1),
                            6: rb + ((ra - rc) >> 1),
                            7: (ra + rb) >> 1}[predictor]
                d = ((int(x[r, c, ci] - pred) + 32768) & 0xFFFF) - 32768
                s = abs(d).bit_length()
                bw.put(*codes[s])
                if 0 < s < 16:
                    bw.put(d if d > 0 else d + (1 << s) - 1, s)
    ids = ids or list(range(1, n + 1))
    sof = b"\x08" + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([n])
    sos = bytes([n])
    for i in range(n):
        sof += bytes([ids[i], 0x11, 0])
        sos += bytes([ids[i], 0])
    sos += bytes([predictor, 0, pt])
    head = b"\xff\xd8"
    if jfif:
        head += JFIF
    if adobe is not None:
        head += segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                        + bytes([adobe]))
    if restart_rows:
        head += segment(0xDD, (restart_rows * w).to_bytes(2, "big"))
    dht = b"\x00" + bytes([0, 0, 0, 0, 17] + [0] * 11) + bytes(range(17))
    return (head + segment(0xC3, sof) + segment(0xC4, dht)
            + segment(0xDA, sos) + out + bw.flush() + b"\xff\xd9")


class QMEncoder:
    """libjpeg's arith_encode and finish_pass (jcarith.c, T.81 D.1): the
    bytes it emits carry their own 0xFF 0x00 stuffing."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = (
            0, 0x10000, 0, 0, 11, -1)

    def _flush_pending(self, byte):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self.out += b"\0" * self.zc
            self.zc = 0
            self.out.append(self.buffer)
        if self.sc:
            self.out += b"\0" * self.zc
            self.zc = 0
            self.out += b"\xff\0" * self.sc
            self.sc = 0
        self.buffer = byte

    def _carry(self):
        if self.buffer >= 0:
            self.out += b"\0" * self.zc
            self.zc = 0
            self.out.append(self.buffer + 1)
            if self.buffer + 1 == 0xFF:
                self.out.append(0)
        self.zc += self.sc
        self.sc = 0

    def encode(self, st, i, val):
        sv = st[i]
        qe = image._ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:                  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:                         # renormalization, D.1.6
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_pending(temp & 0xFF)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._flush_pending(self.buffer)
            self.buffer = -1
        if self.c & 0x7FFF800:
            self.out += b"\0" * self.zc
            self.zc = 0
            for shift, mask in ((19, 0x7FFF800), (11, 0x7F800)):
                if shift == 11 and not self.c & mask:
                    break
                byte = (self.c >> shift) & 0xFF
                self.out.append(byte)
                if byte == 0xFF:
                    self.out.append(0)
        return bytes(self.out)


def _arith_value(q, st, i, v, ac_k=None, k=0, ac=None):
    """T.81 F.6-F.9: a nonzero magnitude v >= 1 from bin i (its category,
    then its bits); for AC the category continues at 189 / 217 by k."""
    m = 0
    v -= 1
    if v:
        q.encode(st, i, 1)
        m = 1
        v2 = v >> 1
        if ac is not None:
            if v2:
                q.encode(st, i, 1)
                m <<= 1
                i = 189 if k <= ac_k else 217
                v2 >>= 1
                while v2:
                    q.encode(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
        else:
            i = 20
            while v2:
                q.encode(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
    q.encode(st, i, 0)
    i += 14
    m >>= 1
    while m:
        q.encode(st, i, 1 if m & v else 0)
        m >>= 1


def encode_jpeg_arith(img, sampling=((2, 2), (1, 1), (1, 1)),
                      progressive=False, restart=0, dac=None):
    """An arithmetic-coded JPEG (SOF9 sequential, SOF10 progressive with
    libjpeg's simple progression script) of uint8 RGB or gray img, JFIF
    YCbCr; a restart every `restart` MCUs of each scan; `dac` a dict
    {(class, table): value} written as a DAC marker (DC: U << 4 | L,
    AC: K)."""
    h, w = img.shape[:2]
    x = img.astype(np.float64).reshape(h, w, -1)
    if x.shape[2] == 3:
        comps = ycc(x)
    else:
        comps = [x[..., 0]]
        sampling = ((1, 1),)
    n = len(comps)
    sampling = list(sampling)[:n]
    hmax = max(t[0] for t in sampling)
    vmax = max(t[1] for t in sampling)
    planes, (mcux, mcuy) = jpeg_planes(comps, sampling, w, h)
    planes = [p.tolist() for p in planes]
    dac = dac or {}
    ac_k = {t: dac.get((1, t), 5) for t in (0, 1)}
    dc_lu = {t: dac.get((0, t), 0x10) for t in (0, 1)}
    if not progressive:
        script = [(tuple(range(n)), 0, 63, 0, 0)]
    elif n == 3:
        script = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                  ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                  ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                  ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                  ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    else:
        script = [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                  ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                  ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]

    def units(cis):
        if len(cis) == 1:
            ci = cis[0]
            ch, cv = sampling[ci]
            bw = -(-(-(-w * ch // hmax)) // 8)
            bh = -(-(-(-h * cv // vmax)) // 8)
            return [[(ci, by, bx)] for by in range(bh) for bx in range(bw)]
        out = []
        for my in range(mcuy):
            for mx in range(mcux):
                out.append([(ci, my * sampling[ci][1] + i,
                             mx * sampling[ci][0] + j) for ci in cis
                            for i in range(sampling[ci][1])
                            for j in range(sampling[ci][0])])
        return out

    def tshift(v, al):                      # AC point transform, to zero
        return v >> al if v >= 0 else -((-v) >> al)

    scans = b""
    for cis, ss, se, ah, al in script:
        us = units(list(cis))
        data = b""
        for start in range(0, len(us), restart or len(us)):
            if start:
                data += bytes([0xFF, 0xD0 + (start // restart - 1) % 8])
            q = QMEncoder()
            dc_st = {t: [0] * 64 for t in (0, 1)}
            ac_st = {t: [0] * 256 for t in (0, 1)}
            fixed = [113]
            last = [0] * n
            ctx = [0] * n
            for unit in us[start:start + (restart or len(us))]:
                for ci, by, bx in unit:
                    blk = planes[ci][by][bx]
                    t = 0 if ci == 0 else 1
                    if ss == 0 and ah:              # DC refinement
                        q.encode(fixed, 0, (blk[0] >> al) & 1)
                        continue
                    if ss == 0:
                        m = blk[0] >> al
                        st = dc_st[t]
                        v = m - last[ci]
                        if v == 0:
                            q.encode(st, ctx[ci], 0)
                            ctx[ci] = 0
                        else:
                            last[ci] = m
                            q.encode(st, ctx[ci], 1)
                            i = ctx[ci]
                            q.encode(st, i + 1, 0 if v > 0 else 1)
                            ctx[ci] = 4 if v > 0 else 8
                            i += 2 if v > 0 else 3
                            mag = abs(v)
                            cat = (mag - 1).bit_length()
                            lo, hi = dc_lu[t] & 15, dc_lu[t] >> 4
                            mm = (1 << (cat - 1)) if cat else 0
                            if mm < (1 << lo) >> 1:
                                ctx[ci] = 0
                            elif mm > (1 << hi) >> 1:
                                ctx[ci] += 8
                            _arith_value(q, st, i, mag)
                        if progressive:
                            continue
                    if progressive and se == 0:
                        continue
                    st = ac_st[t]
                    k0, k1 = (1, 63) if not progressive else (ss, se)
                    coef = [tshift(blk[k], al) for k in range(64)]
                    ke = k1
                    while ke > 0 and ke >= k0 and not coef[ke]:
                        ke -= 1
                    if progressive and ah:          # AC refinement
                        kex = ke
                        while kex > 0 and not tshift(blk[kex], ah):
                            kex -= 1
                        k = k0
                        while k <= ke:
                            i = 3 * (k - 1)
                            if k > kex:
                                q.encode(st, i, 0)
                            while True:
                                v = abs(coef[k])
                                if v:
                                    if v >> 1:
                                        q.encode(st, i + 2, v & 1)
                                    else:
                                        q.encode(st, i + 1, 1)
                                        q.encode(fixed, 0,
                                                 1 if coef[k] < 0 else 0)
                                    break
                                q.encode(st, i + 1, 0)
                                i += 3
                                k += 1
                            k += 1
                        if k <= k1:
                            q.encode(st, 3 * (k - 1), 1)
                        continue
                    k = k0
                    while k <= ke:
                        i = 3 * (k - 1)
                        q.encode(st, i, 0)
                        while not coef[k]:
                            q.encode(st, i + 1, 0)
                            i += 3
                            k += 1
                        q.encode(st, i + 1, 1)
                        q.encode(fixed, 0, 1 if coef[k] < 0 else 0)
                        _arith_value(q, st, i + 2, abs(coef[k]), ac_k[t], k,
                                     ac=True)
                        k += 1
                    if k <= k1:
                        q.encode(st, 3 * (k - 1), 1)
            data += q.finish()
        sos = bytes([len(cis)])
        for ci in cis:
            t = 0 if ci == 0 else 1
            sos += bytes([ci + 1, t << 4 | t])
        sos += bytes([ss, se, ah << 4 | al])
        scans += segment(0xDA, sos) + data
    sof = b"\x08" + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([n])
    for i, (ch, cv) in enumerate(sampling):
        sof += bytes([i + 1, ch << 4 | cv, 0 if i == 0 else 1])
    head = b"\xff\xd8" + JFIF + dqt()
    if dac:
        head += segment(0xCC, b"".join(bytes([c << 4 | t, v])
                                   for (c, t), v in sorted(dac.items())))
    if restart:
        head += segment(0xDD, restart.to_bytes(2, "big"))
    return (head + segment(0xCA if progressive else 0xC9, sof) + scans
            + b"\xff\xd9")


# ---------------------------------------------------------------- TIFF


def encode_tiff(px, compression="lzw", predictor=1, big_endian=False,
                rows_per_strip=None, tile=None, planar=1, photometric=None,
                colormap=None):
    """A TIFF of px (H, W, C) uint8 / uint16 / float32 (or bool for
    bilevel): compression "none", "lzw", "lzw_old" (LSB first, no early
    change), "deflate" or "packbits"; predictor 1, 2 (horizontal) or 3
    (floating point); strips of rows_per_strip rows or tiles (tw, th);
    planar 1 (contiguous) or 2 (a plane after another); photometric
    default 1 (gray, gray + alpha) or 2 (RGB, RGBA), 3 with colormap
    ((3, 2^bits) uint16)."""
    bo = ">" if big_endian else "<"
    px = np.asarray(px)
    if px.ndim == 2:
        px = px[:, :, None]
    h, w, spp = px.shape
    bilevel = px.dtype == bool
    bits = 1 if bilevel else px.dtype.itemsize * 8
    if photometric is None:
        photometric = 3 if colormap is not None else (1 if spp < 3 else 2)
    fmt = 3 if px.dtype.kind == "f" else 1
    nplanes = spp if planar == 2 else 1
    ps = 1 if planar == 2 else spp
    if tile:
        tw, th = tile
        across, down = -(-w // tw), -(-h // th)
        grid = [(ty, tx) for ty in range(down) for tx in range(across)]
    else:
        tw, th = w, min(rows_per_strip or h, h)
        across, down = 1, -(-h // th)
        grid = [(ty, 0) for ty in range(down)]
    chunks = []
    for p in range(nplanes):
        plane = px[:, :, p:p + 1] if planar == 2 else px
        for ty, tx in grid:
            blk = plane[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
            if tile:                                # full tiles, zero padded
                full = np.zeros((th, tw, ps), plane.dtype)
                full[:blk.shape[0], :blk.shape[1]] = blk
                blk = full
            rows = blk.shape[0]
            if bilevel:
                raw = np.packbits(blk[:, :, 0], axis=1).tobytes()
            elif predictor == 3:
                be = blk.astype(f">f{bits // 8}").view(np.uint8).reshape(
                    rows, -1, bits // 8)
                planes_ = be.transpose(0, 2, 1).reshape(rows, -1).astype(
                    np.int64)
                d = planes_.reshape(rows, -1, ps)
                d = np.concatenate([d[:, :1], np.diff(d, axis=1)], 1) & 0xFF
                raw = d.astype(np.uint8).tobytes()
            else:
                v = blk.reshape(rows, -1, ps)
                if predictor == 2:
                    u = v.view(f"u{bits // 8}").astype(np.int64)
                    u = np.concatenate([u[:, :1], np.diff(u, axis=1)], 1)
                    v = (u & ((1 << bits) - 1)).astype(f"u{bits // 8}")
                raw = np.ascontiguousarray(v).astype(
                    v.dtype.newbyteorder(bo)).tobytes()
            if compression == "lzw":
                raw = lzw_encode(raw)
            elif compression == "lzw_old":
                raw = lzw_encode(raw, msb=False, early=0)
            elif compression == "deflate":
                raw = zlib.compress(raw)
            elif compression == "packbits":
                raw = packbits_encode(raw)
            chunks.append(raw)
    comp = {"none": 1, "lzw": 5, "lzw_old": 5, "deflate": 8,
            "packbits": 32773}[compression]
    entries = [tiff_entry(bo, 256, 4, [w]), tiff_entry(bo, 257, 4, [h]),
               tiff_entry(bo, 258, 3, [bits] * spp),
               tiff_entry(bo, 259, 3, [comp]),
               tiff_entry(bo, 262, 3, [photometric]),
               tiff_entry(bo, 277, 3, [spp]),
               tiff_entry(bo, 284, 3, [planar]),
               tiff_entry(bo, 339, 3, [fmt] * spp)]
    if predictor != 1:
        entries.append(tiff_entry(bo, 317, 3, [predictor]))
    if colormap is not None:
        entries.append(tiff_entry(bo, 320, 3,
                                  np.asarray(colormap).reshape(-1).tolist()))
    return tiff_file(chunks, entries, bo, (tw, th) if tile else None, th)


def packbits_encode(raw):
    """PackBits: runs of 3+ equal bytes as repeats, the rest as literals."""
    out = bytearray()
    a = np.frombuffer(raw, np.uint8)
    n = len(a)
    i = 0
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and a[j] == a[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), a[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and a[j] == a[j + 1] == a[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + a[i:j].tobytes()
        i = j
    return bytes(out)


# ---------------------------------------------------------------- BMP


def bmp_file(body, w, h, bpp, comp=0, palette=b"", masks=b""):
    off = 14 + 40 + len(masks) + len(palette)
    head = struct.pack("<2sIHHI", b"BM", off + len(body), 0, 0, off)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, comp, len(body),
                       2835, 2835, len(palette) // 4, 0)
    return head + info + masks + palette + body


def dib_file(px, bpp, hsize=40, palette=None, masks=None):
    """A DIB (a BMP without its file header) of px, bottom-up: indices
    (H, W) through palette (n, 3) RGB at 1-8 bits, or RGB (H, W, 3) at 24
    bits, or 16 / 32 bits under BI_BITFIELDS masks (R, G, B): after a
    40-byte header, or inside a 108- (V4) or 124-byte (V5) one (alpha mask
    0).  A 12-byte (OS/2 core) header takes 3-byte palette entries."""
    h, w = px.shape[:2]
    if bpp <= 8:
        bits = np.unpackbits(px.astype(np.uint8)[..., None], axis=-1)[
            ..., 8 - bpp:]
        rows = np.packbits(bits.reshape(h, -1), axis=1)
    elif bpp == 24:
        rows = px[..., ::-1].reshape(h, -1)
    else:
        r, g, b = (px[..., i].astype(np.int64) for i in range(3))
        v = 0
        for c, m in zip((r, g, b), masks):
            top = m.bit_length()
            width = top - (m & -m).bit_length() + 1
            v = v | ((c >> (8 - width)) << (top - width))
        rows = v.astype("<u4" if bpp == 32 else "<u2").view(np.uint8).reshape(
            h, -1)
    stride = (w * bpp + 31) // 32 * 4
    body = np.zeros((h, stride), np.uint8)
    body[:, :rows.shape[1]] = rows
    body = body[::-1].tobytes()
    comp = 3 if masks is not None else 0
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]
        if hsize != 12:
            p = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1)
        pal = p.tobytes()
    if hsize == 12:
        return struct.pack("<IHHHH", 12, w, h, 1, bpp) + pal + body
    head = struct.pack("<IiiHHIIiiII", hsize, w, h, 1, bpp, comp, len(body),
                       2835, 2835, 0 if palette is None else len(palette), 0)
    mask_bytes = struct.pack("<III", *masks) if masks is not None else b""
    if hsize == 40:
        return head + mask_bytes + pal + body
    extra = (mask_bytes or bytes(12)) + bytes(4)         # alpha mask 0
    head += extra + bytes(hsize - len(head) - len(extra))
    return head + pal + body


def rle8(idx):
    """RLE8 rows, bottom-up: runs of 3+ as encoded runs, others absolute
    (3+ bytes, padded to 16 bits) or one-pixel runs; end of line / bitmap."""
    out = bytearray()
    for row in idx[::-1]:
        i = 0
        while i < len(row):
            j = i + 1
            while j < len(row) and j - i < 255 and row[j] == row[i]:
                j += 1
            if j - i >= 3 or len(row) - i < 3:
                out += bytes([j - i, row[i]])
                i = j
                continue
            j = min(i + 3, len(row))
            while j < len(row) and j - i < 255 and not (
                    j + 2 < len(row) and row[j] == row[j + 1] == row[j + 2]):
                j += 1
            lit = bytes(row[i:j])
            out += bytes([0, len(lit)]) + lit + b"\0" * (len(lit) & 1)
            i = j
        out += b"\0\0"
    return bytes(out + b"\0\1")


def rle4(idx):
    """RLE4 rows: two-pixel encoded runs (alternating nibbles) and even
    absolute runs, which PIL and the port read alike."""
    out = bytearray()
    for row in idx[::-1]:
        i = 0
        while i < len(row):
            k = min(4, len(row) - i)
            if k >= 4 and k % 2 == 0:
                nib = bytes([(row[i + 2 * t] << 4) | row[i + 2 * t + 1]
                             for t in range(k // 2)])
                out += bytes([0, k]) + nib + b"\0" * ((k // 2) & 1)
            else:
                pair = (row[i] << 4) | (row[i + 1] if k > 1 else 0)
                out += bytes([k, pair])
            i += k
        out += b"\0\0"
    return bytes(out + b"\0\1")


# ---------------------------------------------------------------- SGI, PCX


def sgi_file(px, rle=False, bpc=1, name=b""):
    """An SGI file of samples px (H, W) or (H, W, Z), Z 1, 3 or 4, uint8 or
    (bpc 2) uint16: verbatim, or RLE with each row's runs of 3+ equal
    samples repeated and the rest copied (packets of at most 127), rows
    bottom-up, channel by channel."""
    a = np.asarray(px)
    if a.ndim == 2:
        a = a[..., None]
    h, w, z = a.shape
    dim = 3 if z > 1 else (1 if h == 1 else 2)
    dt = np.dtype(">u2") if bpc == 2 else np.dtype(np.uint8)
    head = (struct.pack(">hBBHHHHll", 474, int(rle), bpc, dim, w, h, z, 0,
                        65535 if bpc == 2 else 255) + b"\0" * 4
            + name[:79].ljust(80, b"\0") + struct.pack(">l", 0)
            + b"\0" * 404)
    chans = a[::-1].transpose(2, 0, 1).astype(dt)
    if not rle:
        return head + chans.tobytes()
    rows, starts, lengths = [], [], []
    pos = 512 + 8 * h * z
    for c in range(z):
        for r in range(h):
            row = chans[c, r]
            out = []
            i = 0
            while i < w:
                j = i + 1
                while j < w and j - i < 127 and row[j] == row[i]:
                    j += 1
                if j - i >= 3:
                    out.append(np.array([j - i, row[i]], dt))
                    i = j
                    continue
                j = i
                while j < w and j - i < 127 and not (
                        j + 2 < w and row[j] == row[j + 1] == row[j + 2]):
                    j += 1
                out.append(np.concatenate([np.array([0x80 | (j - i)], dt),
                                           row[i:j]]))
                i = j
            out.append(np.array([0], dt))
            body = np.concatenate(out).astype(dt).tobytes()
            starts.append(pos)
            lengths.append(len(body))
            rows.append(body)
            pos += len(body)
    tabs = np.array(starts, ">u4").tobytes() + np.array(lengths,
                                                        ">u4").tobytes()
    return head + tabs + b"".join(rows)


def pcx_1bit(bits, planes=1, palette=None, even=True):
    """A 1-bit PCX (version 5) of bits (H, W) in {0, 1} (with planes 2 or 4,
    indices (H, W) below 2^planes, plane p holding bit p, and the 16-colour
    header palette (16, 3)), rows of the stride (even where `even`, else
    the bytes the row needs) run-length coded as PIL codes them."""
    h, w = bits.shape
    stride = (w + 7) // 8
    stride += stride % 2 if even else 0
    rows = np.zeros((h, planes, stride * 8), np.uint8)
    for p in range(planes):
        rows[:, p, :w] = (np.asarray(bits) >> p) & 1
    packed = np.packbits(rows, axis=2).reshape(h, planes * stride)
    body = bytearray()
    for row in packed:
        i = 0
        while i < len(row):
            j = i + 1
            while j < len(row) and j - i < 63 and row[j] == row[i]:
                j += 1
            if j - i == 1 and row[i] < 0xC0:
                body.append(int(row[i]))
            else:
                body += bytes([0xC0 | (j - i), int(row[i])])
            i = j
    pal = (b"\0" * 24 + b"\xff" * 24 if palette is None
           else np.asarray(palette, np.uint8).tobytes())
    head = (struct.pack("<BBBBHHHHHH", 10, 5, 1, 1, 0, 0, w - 1, h - 1, 100,
                        100) + pal
            + struct.pack("<BBHHHH", 0, planes, stride, 1, w, h) + b"\0" * 54)
    return head + bytes(body)


# ---------------------------------------------------------------- PIL's


def pil_jpeg(**kw):
    """PIL's JPEG of scene(37, 23), written with its save options kw."""
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(scene(37, 23)).save(b, "JPEG", **kw)
    return b.getvalue()


def patch_sof(data, marker=None, precision=None):
    """A baseline JPEG with its SOF0 marker or sample precision changed."""
    i = data.index(b"\xff\xc0")
    data = bytearray(data)
    if marker is not None:
        data[i + 1] = marker
    if precision is not None:
        data[i + 4] = precision
    return bytes(data)
