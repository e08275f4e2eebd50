"""The VP8 key frame (RFC 6386) of a lossy WebP, decoded in Python and numpy
into its Y, U and V planes as libwebp's decoder makes them (src/dec/vp8_dec.c,
tree_dec.c, quant_dec.c, frame_dec.c, src/dsp/dec.c), bit for bit: the
boolean decoder, the frame and segment headers, the coefficient tokens, the
dequantizer, the inverse WHT and DCT, intra prediction and the normal and
simple loop filters.  utils/webp.py turns the planes into RGB.

The token parse, the prediction of each block from its reconstructed
neighbours and each loop-filter edge (which reads the last one's output)
are serial, in Python; the inverse DCT of every block runs at once in
numpy, since a block's residual does not depend on its prediction.

decode_frame(payload, width, height) -> (y, u, v): (height, width) and
((height + 1) // 2, (width + 1) // 2) uint8.
"""
from __future__ import annotations

import numpy as np

_YMODES4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_CAT3456 = ((173, 148, 140), (176, 155, 140, 135),
            (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's mode numbers (its enum order, in which _BMODES is laid out)
(B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU) = range(10)
DC_NOTOP, DC_NOLEFT, DC_NOTOPLEFT = 10, 11, 12
BPS = 32                    # the work areas' row stride, as libwebp's
# clipping by lookup: _CLIP8[v + _OFF] is v clipped to 0..255 for any
# |v| < _OFF (a residual is under 2^16 in magnitude); _S1 / _S2 clip the
# loop filter's differences to -128..127 and -16..15 the same way
_OFF = 1 << 17
_CLIP8 = [0] * _OFF + list(range(256)) + [255] * _OFF
_S1 = [-128] * 896 + list(range(-128, 128)) + [127] * 896
_S2 = [-16] * 112 + list(range(-16, 16)) + [15] * 112

# libwebp's CoeffsProba0: the default token probabilities, by block type,
# band, context and tree node (4 x 8 x 3 x 11)
_COEFFS0 = bytes((
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128, 189,
    129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214,
    209, 255, 255, 128, 128, 128, 1, 98, 248, 255, 236, 226, 255, 255, 128,
    128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128, 78, 134,
    202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255,
    128, 128, 128, 128, 128, 184, 150, 247, 255, 236, 224, 128, 128, 128, 128,
    128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128, 1, 101, 251,
    255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255,
    255, 128, 128, 128, 37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128, 207, 160, 250, 255,
    238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128,
    128, 128, 128, 1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177,
    135, 243, 255, 234, 225, 128, 128, 128, 128, 128, 80, 129, 211, 255, 194,
    224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128,
    128, 128, 246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 198, 35, 237, 223, 193, 187,
    162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221,
    1, 68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255,
    221, 224, 255, 255, 128, 128, 128, 184, 141, 234, 253, 222, 220, 255, 199,
    128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128, 1,
    129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201,
    198, 255, 202, 128, 128, 128, 23, 91, 163, 242, 170, 187, 247, 210, 255,
    255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128, 109, 178,
    241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192,
    255, 255, 128, 128, 128, 1, 132, 239, 251, 219, 209, 255, 165, 128, 128,
    128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128, 22, 100, 174,
    245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128,
    128, 128, 128, 128, 124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128, 1, 157, 247, 255,
    236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255,
    128, 128, 128, 45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1,
    251, 255, 213, 255, 128, 128, 128, 128, 128, 203, 1, 248, 255, 255, 128,
    128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128,
    128, 253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224,
    243, 193, 185, 249, 198, 255, 255, 128, 73, 17, 171, 221, 161, 179, 236,
    167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248,
    188, 195, 255, 255, 128, 128, 128, 1, 24, 239, 251, 218, 219, 255, 205,
    128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128, 69,
    46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255,
    128, 128, 128, 128, 128, 128, 223, 165, 249, 255, 213, 255, 128, 128, 128,
    128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128, 1, 16,
    248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255,
    128, 128, 128, 128, 128, 149, 1, 255, 128, 128, 128, 128, 128, 128, 128,
    128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128, 247, 192, 255,
    128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128,
    128, 128, 128, 128, 1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128, 55, 93, 255, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 202, 24, 213, 235, 186,
    191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255,
    187, 128, 61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112,
    230, 250, 199, 191, 247, 159, 255, 255, 128, 166, 109, 228, 252, 211, 215,
    255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255,
    128, 1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191,
    243, 183, 193, 250, 221, 255, 255, 128, 24, 71, 130, 219, 154, 170, 243,
    182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242,
    183, 194, 254, 223, 255, 255, 128, 1, 81, 230, 252, 204, 203, 255, 192,
    128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128, 20,
    95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216,
    213, 128, 128, 128, 128, 128, 168, 175, 246, 252, 235, 205, 255, 255, 128,
    128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128, 1, 121,
    236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202,
    255, 219, 128, 128, 128, 42, 80, 160, 240, 162, 185, 255, 205, 128, 128,
    128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 244, 1, 255, 128,
    128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128,
    128, 128, 128
))
# CoeffsUpdateProba: the probability that the frame header replaces each
# of those (with 8 bits of its own)
_COEFFS_UPDATE = bytes((
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255, 223,
    241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 244, 252, 255, 255, 255, 255, 255, 255,
    255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 239, 253, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250,
    255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 217, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255,
    255, 234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 223, 254, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 247,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 253,
    255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234,
    251, 244, 254, 255, 255, 255, 255, 255, 255, 255, 251, 251, 243, 253, 254,
    255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253,
    253, 254, 254, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 248, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255,
    255, 255, 255, 255, 248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 246, 253, 253, 255,
    255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255,
    255, 255, 255, 255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248,
    254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 254, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 255, 255, 255,
    255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 249, 255, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255
))
# kBModesProba: a 4x4 block's mode probabilities by its top and left modes
_BMODES = bytes((
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118,
    46, 70, 95, 175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218,
    189, 17, 13, 152, 114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80,
    195, 26, 62, 44, 64, 85, 144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46,
    55, 19, 136, 160, 33, 206, 71, 63, 20, 8, 114, 114, 208, 12, 9, 226, 81,
    40, 11, 96, 182, 84, 29, 16, 36, 134, 183, 89, 137, 98, 101, 106, 165,
    148, 72, 187, 100, 130, 157, 111, 32, 75, 80, 66, 102, 167, 99, 74, 62,
    40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107, 74, 43, 26, 146, 73,
    166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128, 104, 79, 12, 27,
    217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23, 47, 41, 14,
    110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22, 88, 88,
    147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61, 39,
    53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166,
    73, 107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225,
    114, 34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50,
    48, 51, 193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219,
    228, 21, 18, 111, 112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1,
    196, 245, 209, 10, 25, 109, 88, 43, 29, 140, 166, 213, 37, 43, 154, 61,
    63, 30, 155, 67, 45, 68, 1, 209, 100, 80, 8, 43, 154, 1, 51, 26, 71, 142,
    78, 78, 16, 255, 128, 34, 197, 171, 41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82, 138, 31, 36, 171, 27, 166, 38, 44,
    229, 67, 87, 58, 169, 82, 115, 26, 59, 179, 63, 59, 90, 180, 59, 166, 93,
    73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175, 47, 15, 16, 183, 34, 223,
    49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183, 57, 46, 22, 24, 128, 1,
    54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205, 40, 3, 9, 115, 51,
    192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47, 104, 55, 44, 218, 9,
    54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57, 54, 57, 112, 184,
    5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134, 39, 19, 53,
    221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73, 75, 32, 12,
    51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85, 56, 21,
    23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98, 125,
    98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196,
    26, 57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68,
    1, 26, 102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28,
    222, 37, 68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85,
    55, 62, 70, 37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64,
    32, 201, 85, 75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255,
    25, 248, 1, 56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135,
    57, 26, 121, 40, 164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44,
    131, 131, 123, 31, 6, 158, 86, 40, 64, 135, 148, 224, 45, 183, 128, 22,
    26, 17, 131, 240, 154, 14, 1, 209, 45, 16, 21, 91, 64, 222, 7, 1, 197, 56,
    21, 39, 155, 60, 138, 23, 102, 213, 83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171, 18, 11, 7, 63, 144, 171, 4, 4,
    246, 35, 27, 10, 146, 174, 171, 12, 26, 128, 190, 80, 35, 99, 180, 80,
    126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32, 101, 75, 128, 139, 118,
    146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62, 71, 30, 17, 119,
    118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142, 146, 36, 19,
    30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64, 32, 41,
    20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24
))
# the dequantizer's DC and AC steps by quantizer index (RFC 6386 14.1)
_DC_TABLE = bytes((
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20,
    21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50,
    51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68,
    69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85,
    86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110,
    112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143,
    145, 148, 151, 154, 157
))
_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
    42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60,
    62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96,
    98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131,
    134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177,
    181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239,
    245, 249, 254, 259, 264, 269, 274, 279, 284
)


class _Bool:
    """RFC 6386 section 7.3's boolean decoder (libwebp's VP8BitReader,
    reading zeros past its end as libwebp does)."""
    __slots__ = ("data", "pos", "end", "value", "range", "count")

    def __init__(self, data, start, stop):
        self.data, self.pos, self.end = data, start, stop
        self.value = (self._next() << 8) | self._next()
        self.range, self.count = 255, 0

    def _next(self):
        if self.pos < self.end:
            self.pos += 1
            return self.data[self.pos - 1]
        return 0

    def bit(self, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            self.range -= split
            self.value -= big
            b = 1
        else:
            self.range = split
            b = 0
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                self.value |= self._next()
        return b

    def bits(self, n):
        v = 0
        while n > 0:
            n -= 1
            v |= self.bit(0x80) << n
        return v

    def signed(self, n):
        v = self.bits(n)
        return -v if self.bit(0x80) else v


def _wrap16(v):
    """v as the int16 libwebp stores it."""
    return ((v + 32768) & 0xFFFF) - 32768


def _large_value(br, p):
    """A token's value above 1 (libwebp's GetLargeValue)."""
    if not br.bit(p[3]):
        return 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        return 7 + 2 * br.bit(165) + br.bit(145)
    bit1 = br.bit(p[8])
    cat = 2 * bit1 + br.bit(p[9 + bit1])
    v = 0
    for prob in _CAT3456[cat]:
        v += v + br.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br, probas, ctx, dq, n, out, base):
    """libwebp's GetCoeffs: one block's tokens from position n on into
    out[base:base + 16] (raster order, dequantized by dq = (dc, ac));
    probas[band][ctx] of the block's type.  Returns the position after the
    last non-zero token (n if none)."""
    p = probas[_BANDS[n]][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            p = probas[_BANDS[n]][0]
            if n == 16:
                return 16
        band = probas[_BANDS[n + 1]]
        if not br.bit(p[2]):
            v = 1
            p = band[1]
        else:
            v = _large_value(br, p)
            p = band[2]
        if br.bit(0x80):
            v = -v
        out[base + _ZIGZAG[n]] = _wrap16(v * (dq[1] if n else dq[0]))
        n += 1
    return 16


def _wht(dc, out):
    """The inverse Walsh-Hadamard transform of the 16 luma DCs into the DC
    slots of out's 16 blocks (libwebp's TransformWHT)."""
    tmp = [0] * 16
    for i in range(4):
        a0 = dc[i] + dc[12 + i]
        a1 = dc[4 + i] + dc[8 + i]
        a2 = dc[4 + i] - dc[8 + i]
        a3 = dc[i] - dc[12 + i]
        tmp[i] = a0 + a1
        tmp[8 + i] = a0 - a1
        tmp[4 + i] = a3 + a2
        tmp[12 + i] = a3 - a2
    for i in range(4):
        d = tmp[4 * i] + 3
        a0 = d + tmp[4 * i + 3]
        a1 = tmp[4 * i + 1] + tmp[4 * i + 2]
        a2 = tmp[4 * i + 1] - tmp[4 * i + 2]
        a3 = d - tmp[4 * i + 3]
        o = 64 * i
        out[o] = _wrap16((a0 + a1) >> 3)
        out[o + 16] = _wrap16((a3 + a2) >> 3)
        out[o + 32] = _wrap16((a0 - a1) >> 3)
        out[o + 48] = _wrap16((a3 - a2) >> 3)


def _residuals(co):
    """(N, 16) dequantized coefficients (raster order) -> (N, 16) residuals
    (row-major) of libwebp's TransformOne, before they are added."""
    x = co.reshape(-1, 4, 4)

    def mul1(a):
        return ((a * 20091) >> 16) + a

    def mul2(a):
        return (a * 35468) >> 16

    a, b = x[:, 0] + x[:, 2], x[:, 0] - x[:, 2]     # vertical pass, by column
    c = mul2(x[:, 1]) - mul1(x[:, 3])
    d = mul1(x[:, 1]) + mul2(x[:, 3])
    t = np.stack([a + d, b + c, b - c, a - d], -1)  # (N, column, row)
    dc = t[:, 0] + 4                                # horizontal pass, by row
    a, b = dc + t[:, 2], dc - t[:, 2]
    c = mul2(t[:, 1]) - mul1(t[:, 3])
    d = mul1(t[:, 1]) + mul2(t[:, 3])
    return np.stack([(a + d) >> 3, (b + c) >> 3, (b - c) >> 3, (a - d) >> 3],
                    -1).reshape(-1, 16)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _pred4(w, d, mode):
    """A 4x4 luma block's intra prediction into w at d (libwebp's
    DC4, TM4, VE4, HE4, RD4, VR4, LD4, VL4, HD4, HU4)."""
    t = d - BPS
    if mode == B_DC:
        row = [(4 + sum(w[t:t + 4]) + w[d - 1] + w[d - 1 + BPS]
                + w[d - 1 + 2 * BPS] + w[d - 1 + 3 * BPS]) >> 3] * 4
        rows = (row, row, row, row)
    elif mode == B_TM:
        tl = w[t - 1]
        top = w[t:t + 4]
        clip = _CLIP8
        rows = [[clip[v + l + _OFF] for v in top]
                for l in (w[d - 1] - tl, w[d - 1 + BPS] - tl,
                          w[d - 1 + 2 * BPS] - tl, w[d - 1 + 3 * BPS] - tl)]
    elif mode == B_VE:
        X, A, B, C, D, E = w[t - 1:t + 5]
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D),
               _avg3(C, D, E)]
        rows = (row, row, row, row)
    elif mode == B_HE:
        A, B, C = w[t - 1], w[d - 1], w[d - 1 + BPS]
        D, E = w[d - 1 + 2 * BPS], w[d - 1 + 3 * BPS]
        rows = ([_avg3(A, B, C)] * 4, [_avg3(B, C, D)] * 4,
                [_avg3(C, D, E)] * 4, [_avg3(D, E, E)] * 4)
    else:
        I, J, K, L = (w[d - 1], w[d - 1 + BPS], w[d - 1 + 2 * BPS],
                      w[d - 1 + 3 * BPS])
        X = w[t - 1]
        A, B, C, D, E, F, G, H = w[t:t + 8]
        if mode == B_RD:
            r0, r1, r2 = _avg3(A, X, I), _avg3(X, I, J), _avg3(I, J, K)
            t1, t2, t3 = _avg3(B, A, X), _avg3(C, B, A), _avg3(D, C, B)
            rows = ((r0, t1, t2, t3), (r1, r0, t1, t2), (r2, r1, r0, t1),
                    (_avg3(J, K, L), r2, r1, r0))
        elif mode == B_LD:
            v = (_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E),
                 _avg3(D, E, F), _avg3(E, F, G), _avg3(F, G, H),
                 _avg3(G, H, H))
            rows = (v[0:4], v[1:5], v[2:6], v[3:7])
        elif mode == B_VR:
            xa, ab, bc = (X + A + 1) >> 1, (A + B + 1) >> 1, (B + C + 1) >> 1
            ixa, xab, abc = _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C)
            rows = ((xa, ab, bc, (C + D + 1) >> 1),
                    (ixa, xab, abc, _avg3(B, C, D)),
                    (_avg3(J, I, X), xa, ab, bc),
                    (_avg3(K, J, I), ixa, xab, abc))
        elif mode == B_VL:
            bc, cd, de = (B + C + 1) >> 1, (C + D + 1) >> 1, (D + E + 1) >> 1
            bcd, cde, def_ = _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F)
            rows = (((A + B + 1) >> 1, bc, cd, de),
                    (_avg3(A, B, C), bcd, cde, def_),
                    (bc, cd, de, _avg3(E, F, G)),
                    (bcd, cde, def_, _avg3(F, G, H)))
        elif mode == B_HD:
            ix, ji, kj = (I + X + 1) >> 1, (J + I + 1) >> 1, (K + J + 1) >> 1
            ixa, jix, kji = _avg3(I, X, A), _avg3(J, I, X), _avg3(K, J, I)
            rows = ((ix, ixa, _avg3(X, A, B), _avg3(A, B, C)),
                    (ji, jix, ix, ixa), (kj, kji, ji, jix),
                    ((L + K + 1) >> 1, _avg3(L, K, J), kj, kji))
        else:                                       # B_HU
            jk, kl = (J + K + 1) >> 1, (K + L + 1) >> 1
            jkl, kll = _avg3(J, K, L), _avg3(K, L, L)
            rows = (((I + J + 1) >> 1, _avg3(I, J, K), jk, jkl),
                    (jk, jkl, kl, kll), (kl, kll, L, L), (L, L, L, L))
    w[d:d + 4] = rows[0]
    w[d + BPS:d + BPS + 4] = rows[1]
    w[d + 2 * BPS:d + 2 * BPS + 4] = rows[2]
    w[d + 3 * BPS:d + 3 * BPS + 4] = rows[3]


def _pred_block(w, d, mode, size, shift):
    """A 16x16 luma (size 16, shift 5) or 8x8 chroma (8, 4) block's intra
    prediction into w at d (libwebp's DC, TM, VE, HE and the DC variants
    at the frame's top and left edges)."""
    if mode == B_TM:
        tl = w[d - BPS - 1]
        top = w[d - BPS:d - BPS + size]
        clip = _CLIP8
        for y in range(size):
            o = d + y * BPS
            l = w[o - 1] - tl + _OFF
            w[o:o + size] = [clip[v + l] for v in top]
        return
    if mode == B_VE:
        top = w[d - BPS:d - BPS + size]
        for y in range(size):
            w[d + y * BPS:d + y * BPS + size] = top
        return
    if mode == B_HE:
        for y in range(size):
            o = d + y * BPS
            w[o:o + size] = [w[o - 1]] * size
        return
    left = sum(w[d - 1 + j * BPS] for j in range(size))
    top = sum(w[d - BPS:d - BPS + size])
    if mode == B_DC:
        v = (size + top + left) >> shift
    elif mode == DC_NOTOP:
        v = ((size >> 1) + left) >> (shift - 1)
    elif mode == DC_NOLEFT:
        v = ((size >> 1) + top) >> (shift - 1)
    else:                                           # DC_NOTOPLEFT
        v = 0x80
    row = [v] * size
    for y in range(size):
        w[d + y * BPS:d + y * BPS + size] = row


def _add(w, d, r):
    """A 4x4 residual r (row-major) added to w at d, clipped to 0..255."""
    clip = _CLIP8
    for k in (0, 4, 8, 12):
        o = d + (k >> 2) * BPS
        a, b, c, e = w[o:o + 4]
        w[o:o + 4] = (clip[a + r[k] + _OFF], clip[b + r[k + 1] + _OFF],
                      clip[c + r[k + 2] + _OFF], clip[e + r[k + 3] + _OFF])


def _check_mode(mb_x, mb_y, mode):
    """A DC mode at the frame's top or left edge reads only what exists."""
    if mode == B_DC:
        if mb_x == 0:
            return DC_NOTOPLEFT if mb_y == 0 else DC_NOLEFT
        return DC_NOTOP if mb_y == 0 else B_DC
    return mode


def _header(br):
    """The rest of the frame header in the first partition: (segment map
    probabilities or None, per-segment (y1, y2, uv) dequantizer pairs, per
    segment and i4x4 flag (limit, inner limit, hev threshold), filter type
    0 none / 1 simple / 2 normal, token partition count, token
    probabilities [type][band][ctx], skip probability or None)."""
    br.bits(2)                                      # colour space, clamping
    use_segment, update_map, absolute = br.bits(1), 0, 0
    quantizer, strength, seg_proba = [0] * 4, [0] * 4, None
    if use_segment:
        update_map = br.bits(1)
        if br.bits(1):                              # segment data
            absolute = br.bits(1)
            quantizer = [br.signed(7) if br.bits(1) else 0 for _ in range(4)]
            strength = [br.signed(6) if br.bits(1) else 0 for _ in range(4)]
        if update_map:
            seg_proba = [br.bits(8) if br.bits(1) else 255 for _ in range(3)]
    simple, level, sharpness = br.bits(1), br.bits(6), br.bits(3)
    use_lf_delta = br.bits(1)
    ref_lf = mode_lf = [0] * 4
    if use_lf_delta and br.bits(1):
        ref_lf = [br.signed(6) if br.bits(1) else 0 for _ in range(4)]
        mode_lf = [br.signed(6) if br.bits(1) else 0 for _ in range(4)]
    num_parts = 1 << br.bits(2)

    base_q0 = br.bits(7)
    dy1_dc, dy2_dc, dy2_ac, duv_dc, duv_ac = [
        br.signed(4) if br.bits(1) else 0 for _ in range(5)]
    quants = []
    for s in range(4):                              # VP8ParseQuant
        q = (quantizer[s] + (0 if absolute else base_q0) if use_segment
             else base_q0)
        y2_ac = _AC_TABLE[min(max(q + dy2_ac, 0), 127)] * 101581 >> 16
        quants.append((
            (_DC_TABLE[min(max(q + dy1_dc, 0), 127)],
             _AC_TABLE[min(max(q, 0), 127)]),
            (_DC_TABLE[min(max(q + dy2_dc, 0), 127)] * 2, max(y2_ac, 8)),
            (_DC_TABLE[min(max(q + duv_dc, 0), 117)],
             _AC_TABLE[min(max(q + duv_ac, 0), 127)])))
    br.bits(1)                                      # refresh entropy probs
    flat = [br.bits(8) if br.bit(_COEFFS_UPDATE[i]) else _COEFFS0[i]
            for i in range(4 * 8 * 3 * 11)]
    probas = [[[flat[i:i + 11] for i in range((t * 8 + b) * 33,
                                              (t * 8 + b + 1) * 33, 11)]
               for b in range(8)] for t in range(4)]
    skip_proba = br.bits(8) if br.bits(1) else None

    filters = []                                    # PrecomputeFilterStrengths
    for s in range(4):
        base = (strength[s] + (0 if absolute else level) if use_segment
                else level)
        pair = []
        for i4x4 in (0, 1):
            lvl = base
            if use_lf_delta:
                lvl += ref_lf[0] + (mode_lf[0] if i4x4 else 0)
            lvl = min(max(lvl, 0), 63)
            limit = ilevel = hev_t = 0
            if lvl > 0:
                ilevel = lvl
                if sharpness > 0:
                    ilevel >>= 2 if sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - sharpness)
                ilevel = max(ilevel, 1)
                limit = 2 * lvl + ilevel
                hev_t = 2 if lvl >= 40 else 1 if lvl >= 15 else 0
            pair.append((limit, ilevel, hev_t))
        filters.append(pair)
    filter_type = 0 if level == 0 else 1 if simple else 2
    return (seg_proba, quants, filters, filter_type, num_parts, probas,
            skip_proba)


def _modes(br, mb_w, mb_h, seg_proba, skip_proba):
    """Every macroblock's (segment, skip, i4x4, luma mode(s), chroma mode)
    from the rest of the first partition (libwebp's ParseIntraMode)."""
    mbs = []
    intra_t = [B_DC] * (4 * mb_w)
    for _ in range(mb_h):
        left = [B_DC] * 4
        for mb_x in range(mb_w):
            seg = 0
            if seg_proba is not None:
                seg = (br.bit(seg_proba[2]) + 2 if br.bit(seg_proba[0])
                       else br.bit(seg_proba[1]))
            skip = br.bit(skip_proba) if skip_proba is not None else 0
            i4x4 = not br.bit(145)
            if not i4x4:
                ymode = ((B_TM if br.bit(128) else B_HE) if br.bit(156)
                         else (B_VE if br.bit(163) else B_DC))
                modes = ymode
                top = [ymode] * 4
                left = [ymode] * 4
            else:
                top = intra_t[4 * mb_x:4 * mb_x + 4]
                modes = []
                for y in range(4):
                    ymode = left[y]
                    for x in range(4):
                        base = (top[x] * 10 + ymode) * 9
                        i = _YMODES4[br.bit(_BMODES[base])]
                        while i > 0:
                            i = _YMODES4[2 * i + br.bit(_BMODES[base + i])]
                        ymode = -i
                        top[x] = ymode
                    modes += top
                    left[y] = ymode
            intra_t[4 * mb_x:4 * mb_x + 4] = top
            uv = (B_DC if not br.bit(142) else B_VE if not br.bit(114)
                  else B_TM if br.bit(183) else B_HE)
            mbs.append((seg, skip, i4x4, modes, uv))
    return mbs


def _tokens(parts, mbs, mb_w, mb_h, quants, probas):
    """Every macroblock's 384 dequantized coefficients (16 luma, 4 U and 4
    V blocks, raster order; the luma DCs through the WHT for a 16x16
    mode) and whether any block has a non-zero AC or DC (libwebp's
    ParseResiduals)."""
    coeffs = np.zeros((mb_w * mb_h, 384), np.int64)
    any_nz = [False] * (mb_w * mb_h)
    nz_top = [0] * (9 * mb_w)                       # 4 Y, 2 U, 2 V, 1 DC
    y1_p, y2_p, uv_p, i4_p = probas[0], probas[1], probas[2], probas[3]
    for mb_y in range(mb_h):
        br = parts[mb_y & (len(parts) - 1)]
        nz_left = [0] * 9
        for mb_x in range(mb_w):
            k = mb_y * mb_w + mb_x
            seg, skip, i4x4, _, _ = mbs[k]
            t = 9 * mb_x
            if skip:
                nz_top[t:t + 8] = nz_left[:8] = [0] * 8
                if not i4x4:
                    nz_top[t + 8] = nz_left[8] = 0
                continue
            q = quants[seg]
            co = [0] * 384
            if not i4x4:
                dc = [0] * 16
                nz = _coeffs(br, y2_p, nz_top[t + 8] + nz_left[8], q[1], 0,
                             dc, 0)
                nz_top[t + 8] = nz_left[8] = int(nz > 0)
                _wht(dc, co)
                first, p = 1, y1_p
            else:
                first, p = 0, i4_p
            nonzero = False
            for y in range(4):
                lf = nz_left[y]
                for x in range(4):
                    b = 64 * y + 16 * x
                    nz = _coeffs(br, p, lf + nz_top[t + x], q[0], first, co, b)
                    lf = int(nz > first)
                    nz_top[t + x] = lf
                    nonzero = nonzero or nz > 1 or co[b] != 0
                nz_left[y] = lf
            for ch in (4, 6):
                for y in range(2):
                    lf = nz_left[ch + y]
                    for x in range(2):
                        b = 256 + 32 * (ch - 4) + 32 * y + 16 * x
                        nz = _coeffs(br, uv_p, lf + nz_top[t + ch + x], q[2],
                                     0, co, b)
                        lf = int(nz > 0)
                        nz_top[t + ch + x] = lf
                        nonzero = nonzero or nz > 1 or co[b] != 0
                    nz_left[ch + y] = lf
            coeffs[k] = co
            any_nz[k] = nonzero
    return coeffs, any_nz


def _reconstruct(mbs, res, mb_w, mb_h):
    """The unfiltered planes (bytearrays, macroblock-aligned): each block
    predicted from its reconstructed neighbours in libwebp's work areas
    (row -1 above, column -1 on the left; 127 above the frame, 129 left of
    it) and its residual added."""
    ys, uvs = 16 * mb_w, 8 * mb_w
    Y = bytearray(16 * mb_h * ys)
    U = bytearray(8 * mb_h * uvs)
    V = bytearray(8 * mb_h * uvs)
    yw, uw, vw = [0] * (BPS * 17), [0] * (BPS * 9), [0] * (BPS * 9)
    d = BPS + 8                                     # a block's origin there
    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            k = mb_y * mb_w + mb_x
            _, _, i4x4, modes, uv = mbs[k]
            r = res[k]
            fy = 16 * mb_y * ys + 16 * mb_x
            fu = 8 * mb_y * uvs + 8 * mb_x
            if mb_y == 0:
                yw[d - BPS - 1:d - BPS + 20] = [127] * 21
                uw[d - BPS - 1:d - BPS + 8] = vw[d - BPS - 1:d - BPS + 8] = \
                    [127] * 9
            else:
                if mb_x == 0:
                    yw[d - BPS - 1] = uw[d - BPS - 1] = vw[d - BPS - 1] = 129
                else:
                    yw[d - BPS - 1] = Y[fy - ys - 1]
                    uw[d - BPS - 1] = U[fu - uvs - 1]
                    vw[d - BPS - 1] = V[fu - uvs - 1]
                yw[d - BPS:d - BPS + 16] = Y[fy - ys:fy - ys + 16]
                uw[d - BPS:d - BPS + 8] = U[fu - uvs:fu - uvs + 8]
                vw[d - BPS:d - BPS + 8] = V[fu - uvs:fu - uvs + 8]
            if mb_x:
                yw[d - 1:d - 1 + 16 * BPS:BPS] = Y[fy - 1:fy - 1 + 16 * ys:ys]
                uw[d - 1:d - 1 + 8 * BPS:BPS] = U[fu - 1:fu - 1 + 8 * uvs:uvs]
                vw[d - 1:d - 1 + 8 * BPS:BPS] = V[fu - 1:fu - 1 + 8 * uvs:uvs]
            else:
                yw[d - 1:d - 1 + 16 * BPS:BPS] = [129] * 16
                uw[d - 1:d - 1 + 8 * BPS:BPS] = [129] * 8
                vw[d - 1:d - 1 + 8 * BPS:BPS] = [129] * 8
            if i4x4:
                tr = d - BPS + 16                   # the top-right pixels
                if mb_y > 0:
                    yw[tr:tr + 4] = (Y[fy - ys + 16:fy - ys + 20]
                                     if mb_x < mb_w - 1
                                     else [Y[fy - ys + 15]] * 4)
                for kk in (1, 2, 3):                # for the right column
                    yw[tr + 4 * kk * BPS:tr + 4 * kk * BPS + 4] = \
                        yw[tr:tr + 4]
                for n in range(16):
                    o = d + 4 * (n & 3) + 4 * (n >> 2) * BPS
                    _pred4(yw, o, modes[n])
                    _add(yw, o, r[n])
            else:
                _pred_block(yw, d, _check_mode(mb_x, mb_y, modes), 16, 5)
                for n in range(16):
                    _add(yw, d + 4 * (n & 3) + 4 * (n >> 2) * BPS, r[n])
            uvm = _check_mode(mb_x, mb_y, uv)
            _pred_block(uw, d, uvm, 8, 4)
            _pred_block(vw, d, uvm, 8, 4)
            for n in range(4):
                o = d + 4 * (n & 1) + 4 * (n >> 1) * BPS
                _add(uw, o, r[16 + n])
                _add(vw, o, r[20 + n])
            for j in range(16):
                Y[fy + j * ys:fy + j * ys + 16] = bytes(
                    yw[d + j * BPS:d + j * BPS + 16])
            for j in range(8):
                U[fu + j * uvs:fu + j * uvs + 8] = bytes(
                    uw[d + j * BPS:d + j * BPS + 8])
                V[fu + j * uvs:fu + j * uvs + 8] = bytes(
                    vw[d + j * BPS:d + j * BPS + 8])
    return Y, U, V


def _simple_filter(P, p, hs, vs, thresh):
    """libwebp's SimpleVFilter16 / SimpleHFilter16 across one edge."""
    t2 = 2 * thresh + 1
    clip, s1, s2 = _CLIP8, _S1, _S2
    for _ in range(16):
        p1, p0, q0, q1 = P[p - 2 * hs], P[p - hs], P[p], P[p + hs]
        if 4 * abs(p0 - q0) + abs(p1 - q1) <= t2:
            a = 3 * (q0 - p0) + s1[p1 - q1 + 1024]
            P[p - hs] = clip[p0 + s2[((a + 3) >> 3) + 128] + _OFF]
            P[p] = clip[q0 - s2[((a + 4) >> 3) + 128] + _OFF]
        p += vs


def _filter_loop(P, p, hs, vs, n, thresh, ithresh, hev_t, edge):
    """libwebp's FilterLoop26 (a macroblock edge: six taps where the edge
    is not of high variance) or FilterLoop24 (an inner edge: four) along n
    pixels; hs steps across the edge, vs along it."""
    t2 = 2 * thresh + 1
    clip, s1, s2 = _CLIP8, _S1, _S2
    for _ in range(n):
        p1, p0, q0, q1 = P[p - 2 * hs], P[p - hs], P[p], P[p + hs]
        if 4 * abs(p0 - q0) + abs(p1 - q1) <= t2:
            p3, p2 = P[p - 4 * hs], P[p - 3 * hs]
            q2, q3 = P[p + 2 * hs], P[p + 3 * hs]
            if (abs(p3 - p2) <= ithresh and abs(p2 - p1) <= ithresh
                    and abs(p1 - p0) <= ithresh and abs(q3 - q2) <= ithresh
                    and abs(q2 - q1) <= ithresh and abs(q1 - q0) <= ithresh):
                if abs(p1 - p0) > hev_t or abs(q1 - q0) > hev_t:
                    a = 3 * (q0 - p0) + s1[p1 - q1 + 1024]
                    P[p - hs] = clip[p0 + s2[((a + 3) >> 3) + 128] + _OFF]
                    P[p] = clip[q0 - s2[((a + 4) >> 3) + 128] + _OFF]
                elif edge:
                    a = s1[3 * (q0 - p0) + s1[p1 - q1 + 1024] + 1024]
                    a1 = (27 * a + 63) >> 7
                    a2 = (18 * a + 63) >> 7
                    a3 = (9 * a + 63) >> 7
                    P[p - 3 * hs] = clip[p2 + a3 + _OFF]
                    P[p - 2 * hs] = clip[p1 + a2 + _OFF]
                    P[p - hs] = clip[p0 + a1 + _OFF]
                    P[p] = clip[q0 - a1 + _OFF]
                    P[p + hs] = clip[q1 - a2 + _OFF]
                    P[p + 2 * hs] = clip[q2 - a3 + _OFF]
                else:
                    a = 3 * (q0 - p0)
                    a1 = s2[((a + 4) >> 3) + 128]
                    a2 = s2[((a + 3) >> 3) + 128]
                    a3 = (a1 + 1) >> 1
                    P[p - 2 * hs] = clip[p1 + a3 + _OFF]
                    P[p - hs] = clip[p0 + a2 + _OFF]
                    P[p] = clip[q0 - a1 + _OFF]
                    P[p + hs] = clip[q1 - a3 + _OFF]
        p += vs


def _loop_filter(Y, U, V, mb_w, mb_h, finfo, filter_type):
    """Every macroblock's edges in raster order, as libwebp's DoFilter:
    its left edge, inner vertical edges, top edge and inner horizontal
    edges, on the reconstructed planes."""
    ys, uvs = 16 * mb_w, 8 * mb_w
    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            limit, il, ht, inner = finfo[mb_y * mb_w + mb_x]
            if limit == 0:
                continue
            y = 16 * mb_y * ys + 16 * mb_x
            if filter_type == 1:
                if mb_x > 0:
                    _simple_filter(Y, y, 1, ys, limit + 4)
                if inner:
                    for k in (1, 2, 3):
                        _simple_filter(Y, y + 4 * k, 1, ys, limit)
                if mb_y > 0:
                    _simple_filter(Y, y, ys, 1, limit + 4)
                if inner:
                    for k in (1, 2, 3):
                        _simple_filter(Y, y + 4 * k * ys, ys, 1, limit)
                continue
            u = 8 * mb_y * uvs + 8 * mb_x
            if mb_x > 0:
                _filter_loop(Y, y, 1, ys, 16, limit + 4, il, ht, True)
                _filter_loop(U, u, 1, uvs, 8, limit + 4, il, ht, True)
                _filter_loop(V, u, 1, uvs, 8, limit + 4, il, ht, True)
            if inner:
                for k in (1, 2, 3):
                    _filter_loop(Y, y + 4 * k, 1, ys, 16, limit, il, ht,
                                 False)
                _filter_loop(U, u + 4, 1, uvs, 8, limit, il, ht, False)
                _filter_loop(V, u + 4, 1, uvs, 8, limit, il, ht, False)
            if mb_y > 0:
                _filter_loop(Y, y, ys, 1, 16, limit + 4, il, ht, True)
                _filter_loop(U, u, uvs, 1, 8, limit + 4, il, ht, True)
                _filter_loop(V, u, uvs, 1, 8, limit + 4, il, ht, True)
            if inner:
                for k in (1, 2, 3):
                    _filter_loop(Y, y + 4 * k * ys, ys, 1, 16, limit, il,
                                 ht, False)
                _filter_loop(U, u + 4 * uvs, uvs, 1, 8, limit, il, ht,
                             False)
                _filter_loop(V, u + 4 * uvs, uvs, 1, 8, limit, il, ht,
                             False)


def decode_frame(payload: bytes, width: int, height: int):
    """A `VP8 ` chunk's key frame -> its (y, u, v) planes, (height, width)
    and ((height + 1) // 2, (width + 1) // 2) uint8; raises ValueError on
    a frame libwebp refuses."""
    if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError("WebP: bad lossy (VP8) frame header")
    tag = payload[0] | payload[1] << 8 | payload[2] << 16
    if tag & 1:
        raise ValueError("WebP: the VP8 frame is not a key frame")
    if (tag >> 1 & 7) > 3:
        raise ValueError("WebP: unknown VP8 profile")
    part0 = tag >> 5
    size = len(payload)
    if part0 > size - 10:
        raise ValueError("WebP: truncated VP8 partitions")
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    br = _Bool(payload, 10, 10 + part0)
    (seg_proba, quants, filters, filter_type, num_parts, probas,
     skip_proba) = _header(br)
    sizes = 10 + part0                              # the token partitions
    start = sizes + 3 * (num_parts - 1)
    if start > size:
        raise ValueError("WebP: truncated VP8 partitions")
    parts = []
    for p in range(num_parts):
        stop = size
        if p < num_parts - 1:
            stop = min(size, start + int.from_bytes(
                payload[sizes + 3 * p:sizes + 3 * p + 3], "little"))
        parts.append(_Bool(payload, start, stop))
        start = stop
    mbs = _modes(br, mb_w, mb_h, seg_proba, skip_proba)
    coeffs, any_nz = _tokens(parts, mbs, mb_w, mb_h, quants, probas)
    res = _residuals(coeffs.reshape(-1, 16)).reshape(-1, 24, 16).tolist()
    Y, U, V = _reconstruct(mbs, res, mb_w, mb_h)
    if filter_type:
        finfo = [filters[seg][int(i4x4)] + (int(i4x4) or nz,)
                 for (seg, _, i4x4, _, _), nz in zip(mbs, any_nz)]
        _loop_filter(Y, U, V, mb_w, mb_h, finfo, filter_type)
    y = np.frombuffer(Y, np.uint8).reshape(16 * mb_h, 16 * mb_w)
    u = np.frombuffer(U, np.uint8).reshape(8 * mb_h, 8 * mb_w)
    v = np.frombuffer(V, np.uint8).reshape(8 * mb_h, 8 * mb_w)
    ch, cw = (height + 1) // 2, (width + 1) // 2
    return y[:height, :width], u[:ch, :cw], v[:ch, :cw]
