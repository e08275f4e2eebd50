"""WebP writing without libwebp: the file PIL 12.1.0 writes for an 8-bit RGB
image under Image.save's defaults (WebPImagePlugin._save: lossy, quality
80, method 4, no ICC, EXIF or XMP), which is libwebp 1.6.0's encoder under
WebPConfigPreset(DEFAULT, 80): four segments, sns_strength 50,
filter_strength 60, sharpness 0, the normal loop filter, one token
partition.

The file: RIFF, its size, WEBP, one `VP8 ` chunk (no VP8X) holding a key
frame, and the pad byte when the frame's length is odd (the chunk's size
counts it, as libwebp writes it).

The path, in libwebp's order:
  - RGB -> YUV 4:2:0 here in numpy, as WebPPictureARGBToYUVA makes it of
    PIL's ARGB picture (picture_csp_enc.c): luma by VP8RGBToY's fixed
    point, chroma of each 2x2 block averaged in libwebp's gamma-compressed
    space (its GammaToLinear / LinearToGamma tables, gamma 0.8), an odd
    last row or column averaged over its two samples;
  - the analysis pass in C++ (native/vp8_enc.cpp): each macroblock's
    susceptibility from its DCT histograms, k-means into four segments,
    each segment's alpha and beta;
  - the per-segment quantizers and filter levels here, in double as
    libwebp computes them (quant_enc.c VP8SetSegmentParams,
    QualityToCompression, SetupFilterStrength, SimplifySegments);
  - the macroblock loop and the bitstream in C++ again (mode decision,
    quantization, reconstruction, tokens, probabilities, both partitions).
The C++ is built with g++ on first use; without it writing .webp raises,
as there is no fallback encoder.
"""
from __future__ import annotations

import math
import struct

import numpy as np

from . import vp8

SEGMENTS = 4
SNS_STRENGTH = 50
FILTER_STRENGTH = 60
QUALITY = 80.0
MAX_DQ_UV, MIN_DQ_UV = 6, -4
MID_ALPHA, MIN_ALPHA, MAX_ALPHA = 64, 30, 100

# utils/vp8.py's tables, packed in the order vp8_enc.cpp's InitTables
# reads them
_TABLES = np.ascontiguousarray(np.concatenate(
    [np.frombuffer(vp8._COEFFS0, np.uint8),
     np.frombuffer(vp8._COEFFS_UPDATE, np.uint8),
     np.frombuffer(vp8._BMODES, np.uint8),
     np.frombuffer(vp8._DC_TABLE, np.uint8), np.asarray(vp8._AC_TABLE),
     np.asarray(vp8._ZIGZAG), np.asarray(vp8._BANDS)]
    + [np.asarray(c) for c in vp8._CAT3456]), np.int32)


def _gamma_tables():
    """libwebp's kGammaToLinearTab (256, 12-bit) and kLinearToGammaTab
    (33 entries at 7 fractional bits), gamma 0.8."""
    g2l = np.array([int(math.pow(v / 255.0, 0.8) * 4095 + .5)
                    for v in range(256)], np.int64)
    scale = (1 << 7) / 4095
    l2g = np.array([int(255.0 * math.pow(scale * v, 1 / 0.8) + .5)
                    for v in range(33)], np.int64)
    return g2l, l2g


_G2L, _L2G = _gamma_tables()


def _linear_to_gamma(base: np.ndarray, shift: int) -> np.ndarray:
    """LinearToGamma: a sum of 4 (shift 0) or 2 (shift 1) linear samples
    back to gamma space, in the 4x scale VP8RGBToU/V take."""
    v = base << shift
    pos, x = v >> 9, v & 511
    return (_L2G[pos + 1] * x + _L2G[pos] * (512 - x) + 64) >> 7


def rgb_to_yuv420(px: np.ndarray):
    """(y, u, v) uint8 planes of the RGB image px (H, W, 3), as libwebp
    converts it: (H, W) and ((H + 1) // 2, (W + 1) // 2)."""
    p = np.asarray(px, np.int64)
    h, w = p.shape[:2]
    r, g, b = p[..., 0], p[..., 1], p[..., 2]
    y = (16839 * r + 33059 * g + 6420 * b + (1 << 15) + (16 << 16)) >> 16
    lin = _G2L[p]
    he, we = h & ~1, w & ~1
    acc = np.zeros(((h + 1) // 2, (w + 1) // 2, 3), np.int64)
    acc[:he // 2, :we // 2] = _linear_to_gamma(
        lin[0:he:2, 0:we:2] + lin[0:he:2, 1:we:2]
        + lin[1:he:2, 0:we:2] + lin[1:he:2, 1:we:2], 0)
    if w & 1:
        acc[:he // 2, -1] = _linear_to_gamma(
            lin[0:he:2, -1] + lin[1:he:2, -1], 1)
    if h & 1:
        acc[-1, :we // 2] = _linear_to_gamma(
            lin[-1, 0:we:2] + lin[-1, 1:we:2], 1)
        if w & 1:
            acc[-1, -1] = _linear_to_gamma(2 * lin[-1, -1], 1)
    r4, g4, b4 = acc[..., 0], acc[..., 1], acc[..., 2]

    def clip_uv(t):
        return np.clip((t + (1 << 17) + (128 << 18)) >> 18, 0, 255)

    u = clip_uv(-9719 * r4 - 19081 * g4 + 28800 * b4)
    v = clip_uv(28800 * r4 - 24116 * g4 - 4684 * b4)
    return (y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8))


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def quality_to_compression(c: float) -> float:
    """libwebp's QualityToCompression (quality / 100 -> the base of the
    segments' power law)."""
    linear_c = c * (2. / 3.) if c < 0.75 else 2. * c - 1.
    return math.pow(linear_c, 1 / 3.)


def _filter_level(quant: int, beta: int) -> int:
    """SetupFilterStrength's level of a segment (sharpness 0)."""
    qstep = vp8._AC_TABLE[min(max(quant, 0), 127)] >> 2
    f = min(qstep, 63) * 5 * FILTER_STRENGTH // (256 + beta)
    return 0 if f < 2 else min(f, 63)


def segment_params(seg_alpha, seg_beta, uv_alpha: int, segment: np.ndarray):
    """VP8SetSegmentParams at quality 80: each segment's quantizer and
    filter level from the analysis' alphas and betas, the chroma deltas,
    and the segments merged where quantizer and level agree.  Returns
    (the encoder's params, the macroblocks' remapped segments).  params:
    the number of segments, quantizers [4], levels [4], the base
    quantizer, dq_uv_dc, dq_uv_ac, and the quantizer and level an unused
    segment gets when the loop runs again (VP8SetSegmentParams' fill-in
    of the base quantizer over the merged segments' last one)."""
    amp = 0.9 * SNS_STRENGTH / 100. / 128.
    c_base = quality_to_compression(QUALITY / 100.)
    quant = []
    for a in seg_alpha:
        c = math.pow(c_base, 1. - amp * a)
        quant.append(min(max(int(127. * (1. - c)), 0), 127))
    base = quant[0]
    dq_uv_ac = _cdiv((uv_alpha - MID_ALPHA) * (MAX_DQ_UV - MIN_DQ_UV),
                     MAX_ALPHA - MIN_ALPHA)
    dq_uv_ac = min(max(_cdiv(dq_uv_ac * SNS_STRENGTH, 100), MIN_DQ_UV),
                   MAX_DQ_UV)
    dq_uv_dc = min(max(_cdiv(-4 * SNS_STRENGTH, 100), -15), 15)
    seg = [(q, _filter_level(q, b), b) for q, b in zip(quant, seg_beta)]
    # SimplifySegments: a segment equal in quantizer and level to an
    # earlier one merges into it; the slots left copy the last one kept
    remap = list(range(SEGMENTS))
    final = 1
    for s1 in range(1, SEGMENTS):
        s2 = next((k for k in range(final)
                   if seg[k][:2] == seg[s1][:2]), final)
        remap[s1] = s2
        if s2 == final:
            seg[final] = seg[s1]
            final += 1
    if final < SEGMENTS:
        segment = np.asarray(remap, np.uint8)[segment]
        seg[final:] = [seg[final - 1]] * (SEGMENTS - final)
    params = [final, *(q for q, _, _ in seg), *(lv for _, lv, _ in seg),
              base, dq_uv_dc, dq_uv_ac, base,
              _filter_level(base, seg[-1][2])]
    return params, segment


def encode_vp8(px: np.ndarray) -> bytes:
    """The VP8 key frame (the `VP8 ` chunk's payload) of the RGB image
    px (H, W, 3) uint8, as libwebp encodes it under PIL's defaults."""
    from .. import native

    px = np.ascontiguousarray(px, np.uint8)
    if px.ndim != 3 or px.shape[2] != 3:
        raise ValueError(f"WebP: expected an RGB image (H, W, 3), got "
                         f"{px.shape}")
    h, w = px.shape[:2]
    if not (0 < w < 16384 and 0 < h < 16384):     # VP8's 14-bit sizes
        raise ValueError(f"WebP: cannot encode a {w}x{h} image")
    yuv = rgb_to_yuv420(px)
    segment, alpha, beta, uv_alpha = native.vp8_analyze(*yuv, _TABLES)
    params, segment = segment_params(alpha, beta, uv_alpha, segment)
    return native.vp8_encode(*yuv, _TABLES, segment, params)


def encode_webp(px: np.ndarray) -> bytes:
    """The .webp file PIL 12.1.0 writes for the uint8 RGB image px."""
    frame = encode_vp8(px)
    frame += b"\0" * (len(frame) & 1)
    return (b"RIFF" + struct.pack("<I", 12 + len(frame)) + b"WEBPVP8 "
            + struct.pack("<I", len(frame)) + frame)


def header_fields(data: bytes) -> dict:
    """The container's layout and the VP8 frame header's fields of a
    simple lossy .webp (RIFF, WEBP, one `VP8 ` chunk): what a file of
    this writer is held to against PIL's.  Per-segment quantizers and
    filter levels are the segment header's (absolute where `absolute`)."""
    if data[:4] != b"RIFF" or data[8:16] != b"WEBPVP8 ":
        raise ValueError("WebP: not a simple lossy file")
    riff, chunk = struct.unpack("<II", data[4:8] + data[16:20])
    p = data[20:20 + chunk]
    tag = p[0] | p[1] << 8 | p[2] << 16
    part0 = tag >> 5
    br = vp8._Bool(p, 10, 10 + part0)
    out = {"riff_size": riff, "chunk_size": chunk, "file_size": len(data),
           "key_frame": 1 - (tag & 1), "profile": tag >> 1 & 7,
           "show": tag >> 4 & 1, "start_code": p[3:6].hex(),
           "width": p[6] | p[7] << 8, "height": p[8] | p[9] << 8,
           "colorspace": br.bits(1), "clamping": br.bits(1),
           "segments": br.bits(1), "update_map": 0, "absolute": 0,
           "quant": [], "level": []}
    if out["segments"]:
        out["update_map"] = br.bits(1)
        if br.bits(1):
            out["absolute"] = br.bits(1)
            out["quant"] = [br.signed(7) if br.bits(1) else 0
                            for _ in range(4)]
            out["level"] = [br.signed(6) if br.bits(1) else 0
                            for _ in range(4)]
        if out["update_map"]:
            for _ in range(3):
                if br.bits(1):
                    br.bits(8)
    out["filter_type"] = "simple" if br.bits(1) else "normal"
    out["filter_level"] = br.bits(6)
    out["sharpness"] = br.bits(3)
    out["lf_deltas"] = br.bits(1)
    if out["lf_deltas"] and br.bits(1):
        for _ in range(8):
            if br.bits(1):
                br.signed(6)
    out["partitions"] = 1 << br.bits(2)
    out["base_quant"] = br.bits(7)
    out["quant_deltas"] = [br.signed(4) if br.bits(1) else 0
                           for _ in range(5)]
    return out
