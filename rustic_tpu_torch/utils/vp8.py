"""A NumPy decoder of lossy WebP: the VP8 key frame of a "VP8 " chunk,
for utils/webp.py (which reads the container and the ALPH alpha plane).

The result is libwebp 1.6.0's, as Pillow decodes it (`WebPAnimDecoder`,
`MODE_RGBA`, default options: the in-loop filter on, fancy upsampling,
no dithering): RGBA uint8 [H, W, 4], alpha 255. It covers the frame
header and the boolean entropy decoder; segments and their quantisers
and filter levels, absolute or relative; the 16x16, 4x4 and chroma intra
modes; the coefficient tokens under the frame's probability updates, in
1, 2, 4 or 8 token partitions (macroblock row y reads partition y mod
n; Pillow's writer emits one); libwebp's inverse WHT and DCT (its
constants 20091 and 35468, its rounding); the simple and normal loop
filters with the sharpness and the per-mode and per-reference deltas;
libwebp's fancy 4:2:0 upsampler and its 14-bit fixed-point YUV to RGB.
Inter frames, which a WebP file does not hold, raise
NotImplementedError.

The header is read here; the macroblock loop (modes and tokens), the
serial entropy decode, is host C++ (csrc/image_entropy.cpp, built by g++
at first use). The inverse transforms run over all blocks at once.
Intra prediction and the loop filter need their left, top and top-right
neighbours done first: they run one anti-diagonal of macroblocks at a
time (mb_x + 2 mb_y constant), vectorised over the macroblocks on it,
which gives the raster order's results. Upsampling and colour conversion
run over the whole image.
"""

from __future__ import annotations

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO, _entropy
from rustic_tpu_torch.utils._entropy import ptr

# libwebp's tables (src/dec/quant_dec.c, src/dec/tree_dec.c), as RFC 6386 gives them.
# The intra 4x4 modes are numbered as libwebp numbers them: DC, TM, VE, HE, RD, VR, LD,
# VL, HD, HU; BMODE_PROBS is indexed [mode above][mode left].
AC_TABLE = np.array([
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52,
    53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94,
    96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140,
    143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205,
    209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
], np.int64)

DC_TABLE = np.array([
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22, 23,
    23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44,
    45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67,
    68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91,
    93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122, 124, 126, 128, 130,
    132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
], np.int64)

COEFF_UPDATE_PROBS = np.array([
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 244, 252, 255, 255, 255, 255, 255, 255, 255,
    255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255, 239, 253, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 217, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255,
    255, 234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 247, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 186, 251, 250, 255,
    255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255, 251,
    251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255,
    255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 248, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255, 248, 254, 249,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255,
    255, 255, 255, 255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255,
    255, 255, 255, 255, 255, 255, 253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 245, 251, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 255, 255, 255, 255,
    255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 249,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
], np.int64).reshape(4, 8, 3, 11)

COEFF_PROBS = np.array([
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228,
    219, 128, 128, 128, 128, 128, 189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126,
    227, 252, 214, 209, 255, 255, 128, 128, 128, 1, 98, 248, 255, 236, 226, 255, 255, 128, 128,
    128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128, 78, 134, 202, 247, 198, 180, 255,
    219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128, 184, 150, 247, 255,
    236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128, 1,
    101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128,
    128, 128, 37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255,
    128, 128, 128, 128, 128, 207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231,
    255, 211, 171, 128, 128, 128, 128, 128, 1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128, 80, 129, 211, 255, 194, 224, 128, 128,
    128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 246, 1, 255, 128, 128, 128,
    128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 198, 35, 237,
    223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1, 68,
    47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128,
    128, 128, 184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190,
    249, 202, 255, 255, 128, 1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210,
    250, 201, 198, 255, 202, 128, 128, 128, 23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1,
    200, 246, 255, 234, 255, 128, 128, 128, 128, 128, 109, 178, 241, 255, 231, 245, 255, 255, 128,
    128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128, 1, 132, 239, 251, 219, 209,
    255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128, 22, 100, 174,
    245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205,
    128, 128, 128, 1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225,
    227, 255, 255, 128, 128, 128, 45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251,
    255, 213, 255, 128, 128, 128, 128, 128, 203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128, 253, 9, 248, 251, 207, 208, 255, 192, 128,
    128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128, 73, 17, 171, 221, 161, 179,
    236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128, 239, 90, 244, 250,
    211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128, 1, 24,
    239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128,
    128, 69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128,
    128, 128, 128, 223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255,
    128, 128, 128, 128, 128, 128, 1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230,
    255, 236, 255, 128, 128, 128, 128, 128, 149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1,
    226, 255, 128, 128, 128, 128, 128, 128, 128, 128, 247, 192, 255, 128, 128, 128, 128, 128, 128,
    128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 134, 252, 255, 255, 128,
    128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128, 55, 93, 255,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169,
    184, 228, 174, 255, 187, 128, 61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230,
    250, 199, 191, 247, 159, 255, 255, 128, 166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128, 1, 52, 220, 246, 198, 199, 249, 220, 255,
    255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128, 24, 71, 130, 219, 154, 170,
    243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128, 149, 150, 226,
    252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233,
    128, 128, 128, 20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213,
    128, 128, 128, 128, 128, 168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215,
    255, 211, 212, 255, 255, 128, 128, 128, 1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128, 42, 80, 160, 240, 162, 185, 255, 205,
    128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 244, 1, 255, 128, 128, 128,
    128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
], np.int64).reshape(4, 8, 3, 11)

BMODE_PROBS = np.array([
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95, 175, 69,
    143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152, 114, 26, 17, 163, 44,
    195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85, 144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71, 63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96,
    182, 84, 29, 16, 36, 134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111,
    32, 75, 80, 66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107, 74,
    43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128, 104, 79, 12, 27,
    217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23, 47, 41, 14, 110, 182, 183, 21, 17,
    194, 66, 45, 25, 102, 197, 189, 23, 18, 22, 88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97,
    183, 117, 85, 38, 35, 179, 61, 39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114,
    102, 29, 93, 77, 39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114, 34, 19, 21, 102,
    132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51, 193, 101, 35, 159, 215, 111, 89, 46,
    111, 60, 148, 31, 172, 219, 228, 21, 18, 111, 112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42,
    1, 196, 245, 209, 10, 25, 109, 88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45,
    68, 1, 209, 100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171, 41,
    40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82, 138, 31, 36, 171, 27,
    166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179, 63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175, 47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183,
    6, 98, 15, 32, 183, 57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47, 104, 55, 44, 218, 9,
    54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57, 54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134, 39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234,
    2, 15, 1, 118, 73, 75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98, 125, 98, 42, 88,
    104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45, 75, 79, 123, 47, 51, 128, 81,
    171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49, 38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67,
    138, 77, 110, 90, 47, 114, 115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101,
    196, 26, 57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26, 102, 61,
    71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37, 68, 45, 128, 34, 1, 47, 11,
    245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70, 37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9,
    92, 136, 28, 64, 32, 201, 85, 75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25,
    248, 1, 56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40, 164, 50,
    31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158, 86, 40, 64, 135, 148,
    224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209, 45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213, 83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85,
    128, 128, 32, 146, 171, 18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26,
    128, 190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32, 101, 75, 128,
    139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62, 71, 30, 17, 119, 118, 255,
    17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142, 146, 36, 19, 30, 171, 255, 97, 27, 20, 138,
    45, 61, 62, 219, 1, 81, 188, 64, 32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195,
    128, 48, 4, 24,
], np.int64).reshape(10, 10, 9)

DC, TM, VE, HE, RD, VR, LD, VL, HD, HU = range(10)  # V_PRED = VE, H_PRED = HE for 16x16, chroma
_NORM = [0] + [7 - (r.bit_length() - 1) for r in range(1, 256)]  # the shift that renormalises r


def _refuse(variant: str):
    raise NotImplementedError(f"WebP {variant} is not decoded ({FORMATS_TODO})")


class _Bool:
    """The boolean entropy decoder (RFC 6386 section 7, libwebp's form): a
    window of the stream in `value`, `bits` bits of it below the 8 that
    are compared; past the end, zeros."""

    def __init__(self, data: bytes):
        self.data = bytes(data)
        self.pos = 0
        self.value = 0
        self.bits = -8
        self.range = 255

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            chunk = self.data[self.pos : self.pos + 7]
            self.pos += 7
            self.value = (self.value << 56) | int.from_bytes(chunk.ljust(7, b"\0"), "big")
            self.bits += 56
        split = ((self.range - 1) * prob) >> 8  # one less than the RFC's split
        if (self.value >> self.bits) > split:
            rng = self.range - split - 1
            self.value -= (split + 1) << self.bits
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = _NORM[rng]
        self.range = rng << shift
        self.bits -= shift
        return bit

    def value_bits(self, n: int) -> int:
        v = 0
        for i in range(n - 1, -1, -1):
            v |= self.bit(128) << i
        return v

    def signed(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(128) else v

    def flag(self) -> int:
        return self.bit(128)


class _Header:
    """The key frame's header: segments, filter, partitions, quantisers
    and the coefficient probabilities."""

    def __init__(self, bd: _Bool):
        bd.flag()  # colour space
        bd.flag()  # clamping type
        self.use_segment = bd.flag()
        self.update_map = 0
        self.absolute = 1
        self.seg_quant = [0] * 4
        self.seg_filter = [0] * 4
        self.seg_probs = [255] * 3
        if self.use_segment:
            self.update_map = bd.flag()
            if bd.flag():  # segment data
                self.absolute = bd.flag()
                self.seg_quant = [bd.signed(7) if bd.flag() else 0 for _ in range(4)]
                self.seg_filter = [bd.signed(6) if bd.flag() else 0 for _ in range(4)]
            if self.update_map:
                self.seg_probs = [bd.value_bits(8) if bd.flag() else 255 for _ in range(3)]
        self.simple = bd.flag()
        self.level = bd.value_bits(6)
        self.sharpness = bd.value_bits(3)
        self.ref_delta = [0] * 4
        self.mode_delta = [0] * 4
        self.use_delta = bd.flag()
        if self.use_delta and bd.flag():
            for deltas in (self.ref_delta, self.mode_delta):
                for i in range(4):
                    if bd.flag():
                        deltas[i] = bd.signed(6)
        self.partitions = 1 << bd.value_bits(2)
        self.base_q = bd.value_bits(7)
        self.dq = [bd.signed(4) if bd.flag() else 0 for _ in range(5)]  # y1dc y2dc y2ac uvdc uvac
        bd.flag()  # refresh entropy probabilities: one frame, so no matter
        probs = COEFF_PROBS.copy()
        upd = COEFF_UPDATE_PROBS.reshape(-1).tolist()
        flat = probs.reshape(-1)
        for i, p in enumerate(upd):
            if bd.bit(p):
                flat[i] = bd.value_bits(8)
        self.probs = probs
        self.use_skip = bd.flag()
        self.skip_prob = bd.value_bits(8) if self.use_skip else 0

    def quant(self):
        """Each segment's (y1 dc, y1 ac, y2 dc, y2 ac, uv dc, uv ac) factors."""
        def dc(v, top=127):
            return int(DC_TABLE[min(max(v, 0), top)])

        def ac(v):
            return int(AC_TABLE[min(max(v, 0), 127)])

        out = []
        for s in range(4):
            q = self.base_q
            if self.use_segment:
                q = self.seg_quant[s] + (0 if self.absolute else self.base_q)
            y1dc, y2dc, y2ac, uvdc, uvac = (q + d for d in self.dq)
            out.append((dc(y1dc), ac(q), dc(y2dc) * 2, max(ac(y2ac) * 101581 >> 16, 8),  # x*155/100
                        dc(uvdc, 117), ac(uvac)))
        return out

    def filter_levels(self):
        """[segment][is 4x4] -> (limit, inner level, hev threshold); limit 0:
        not filtered (libwebp's PrecomputeFilterStrengths)."""
        out = []
        for s in range(4):
            base = self.level
            if self.use_segment:
                base = self.seg_filter[s] + (0 if self.absolute else self.level)
            row = []
            for i4 in (0, 1):
                level = base
                if self.use_delta:
                    level += self.ref_delta[0] + (self.mode_delta[0] if i4 else 0)
                level = min(max(level, 0), 63)
                if level == 0:
                    row.append((0, 0, 0))
                    continue
                ilevel = level
                if self.sharpness > 0:
                    ilevel >>= 2 if self.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - self.sharpness)
                ilevel = max(ilevel, 1)
                row.append((2 * level + ilevel, ilevel, 2 if level >= 40 else 1 if level >= 15
                            else 0))
            out.append(row)
        return out


def _parse(data: bytes):
    """A key frame -> (width, height, header, per-macroblock arrays): the
    header here, the macroblock loop in C++ (csrc/image_entropy.cpp)."""
    if len(data) < 10:
        raise ValueError("VP8 frame is truncated")
    tag = data[0] | data[1] << 8 | data[2] << 16
    if tag & 1:
        _refuse("inter frame")
    if (tag >> 1) & 7 > 3:
        raise ValueError("VP8 profile above 3")
    part0 = tag >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("VP8 key frame start code missing")
    width = (data[6] | data[7] << 8) & 0x3FFF
    height = (data[8] | data[9] << 8) & 0x3FFF
    if part0 > len(data) - 10:
        raise ValueError("VP8 first partition runs past the end")
    first = data[10 : 10 + part0]
    bd = _Bool(first)
    hdr = _Header(bd)
    # the token partitions: the sizes of all but the last, 3 bytes each, then the data
    n_parts = hdr.partitions
    rest = data[10 + part0 :]
    if len(rest) < 3 * (n_parts - 1):
        raise ValueError("VP8 token partition sizes run past the end")
    starts, at = [0], 3 * (n_parts - 1)
    for p in range(n_parts - 1):
        size = int.from_bytes(rest[3 * p : 3 * p + 3], "little")
        at = min(at + size, len(rest))  # libwebp cuts a size that runs past the end
        starts.append(at - 3 * (n_parts - 1))
    starts.append(len(rest) - 3 * (n_parts - 1))
    tokens = np.frombuffer(rest[3 * (n_parts - 1) :] + b"\0", np.uint8)
    part_start = np.asarray(starts, np.int64)
    mbw, mbh = (width + 15) >> 4, (height + 15) >> 4
    n = mbw * mbh
    out = {name: np.zeros(n, np.int32) for name in ("segment", "skip", "is_i4", "ymode", "uvmode")}
    out["bmodes"] = np.zeros((n, 16), np.int32)
    coef = np.zeros((n, 24, 16), np.int16)
    y2 = np.zeros((n, 16), np.int16)
    quant = np.ascontiguousarray(hdr.quant(), np.int32)
    u8 = [np.ascontiguousarray(a, np.uint8) for a in (np.frombuffer(first + b"\0", np.uint8),
                                                       hdr.seg_probs, hdr.probs, BMODE_PROBS)]
    err = _entropy.library().vp8_macroblocks(
        ptr(u8[0]), len(first), bd.pos, bd.value, bd.bits, bd.range, ptr(tokens),
        ptr(part_start), n_parts, mbw, mbh, hdr.update_map, ptr(u8[1]), hdr.use_skip,
        hdr.skip_prob, ptr(u8[2]), ptr(quant), ptr(u8[3]),
        *(ptr(out[k]) for k in ("segment", "skip", "is_i4", "ymode", "uvmode", "bmodes")),
        ptr(coef), ptr(y2))
    if err:
        raise ValueError("VP8 data ends before its last macroblock")
    mb = {k: v.astype(np.int64) for k, v in out.items()}
    mb["is_i4"] = out["is_i4"].astype(bool)
    mb["coef"] = coef.astype(np.int64)
    mb["y2"] = y2.astype(np.int64)
    return width, height, hdr, mb


def _int16(a: np.ndarray) -> np.ndarray:
    """Values as libwebp stores them: wrapped to int16, held in int64."""
    return ((a + 32768) & 0xFFFF) - 32768


# ---- the inverse transforms (libwebp's TransformWHT and TransformOne), over all blocks -------

def _wht(dc: np.ndarray) -> np.ndarray:
    """The Y2 block's inverse Walsh-Hadamard transform: int [N, 16] ->
    each luma block's DC [N, 16]."""
    x = dc.reshape(-1, 4, 4)
    a0, a1 = x[:, 0] + x[:, 3], x[:, 1] + x[:, 2]
    a2, a3 = x[:, 1] - x[:, 2], x[:, 0] - x[:, 3]
    tmp = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], 1)  # rows 0..3 of tmp, [N, 4, 4]
    dc0 = tmp[:, :, 0] + 3
    b0, b1 = dc0 + tmp[:, :, 3], tmp[:, :, 1] + tmp[:, :, 2]
    b2, b3 = tmp[:, :, 1] - tmp[:, :, 2], dc0 - tmp[:, :, 3]
    out = np.stack([(b0 + b1) >> 3, (b3 + b2) >> 3, (b0 - b1) >> 3, (b3 - b2) >> 3], 2)
    return _int16(out.reshape(-1, 16))


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(coef: np.ndarray) -> np.ndarray:
    """Dequantised blocks int [N, 16] (raster order) -> residuals [N, 4, 4]
    ((v + 4) >> 3 of the second pass, as libwebp adds them)."""
    x = coef.reshape(-1, 4, 4)
    a = x[:, 0] + x[:, 2]  # vertical pass, per column: [N, 4]
    b = x[:, 0] - x[:, 2]
    c = _mul2(x[:, 1]) - _mul1(x[:, 3])
    d = _mul1(x[:, 1]) + _mul2(x[:, 3])
    tmp = np.stack([a + d, b + c, b - c, a - d], 1)  # [N, row i, column]
    dc = tmp[:, :, 0] + 4  # horizontal pass, per row i
    a, b = dc + tmp[:, :, 2], dc - tmp[:, :, 2]
    c = _mul2(tmp[:, :, 1]) - _mul1(tmp[:, :, 3])
    d = _mul1(tmp[:, :, 1]) + _mul2(tmp[:, :, 3])
    return np.stack([(a + d) >> 3, (b + c) >> 3, (b - c) >> 3, (a - d) >> 3], 2)


# ---- intra prediction --------------------------------------------------------------------------

# the 13 neighbours of a 4x4 block: X (above-left), A-H (the row above and above-right), I-L
# (the column to the left)
_NB = {name: i for i, name in enumerate("XABCDEFGHIJKL")}


def _avg3(a, b, c):
    return {a: 1}, {b: 2}, {c: 1}, 2, 2


def _avg2(a, b):
    return {a: 1}, {b: 1}, 1, 1


def _rules4():
    """libwebp's 4x4 predictors (dsp/dec.c) but TrueMotion: mode ->
    {(x, y): the rule of that pixel}."""
    v = {}
    top = "XABCDE"
    v[VE] = {(x, y): _avg3(top[x], top[x + 1], top[x + 2]) for x in range(4) for y in range(4)}
    side = "XIJKLL"
    v[HE] = {(x, y): _avg3(side[y], side[y + 1], side[y + 2]) for x in range(4) for y in range(4)}
    v[DC] = {(x, y): ({n: 1 for n in "ABCDIJKL"}, 4, 3) for x in range(4) for y in range(4)}

    def table(groups):
        out = {}
        for cells, rule in groups:
            for cell in cells:
                out[cell] = rule
        return out

    v[RD] = table([
        (((0, 3),), _avg3("J", "K", "L")), (((1, 3), (0, 2)), _avg3("I", "J", "K")),
        (((2, 3), (1, 2), (0, 1)), _avg3("X", "I", "J")),
        (((3, 3), (2, 2), (1, 1), (0, 0)), _avg3("A", "X", "I")),
        (((3, 2), (2, 1), (1, 0)), _avg3("B", "A", "X")), (((3, 1), (2, 0)), _avg3("C", "B", "A")),
        (((3, 0),), _avg3("D", "C", "B"))])
    v[LD] = table([
        (((0, 0),), _avg3("A", "B", "C")), (((1, 0), (0, 1)), _avg3("B", "C", "D")),
        (((2, 0), (1, 1), (0, 2)), _avg3("C", "D", "E")),
        (((3, 0), (2, 1), (1, 2), (0, 3)), _avg3("D", "E", "F")),
        (((3, 1), (2, 2), (1, 3)), _avg3("E", "F", "G")), (((3, 2), (2, 3)), _avg3("F", "G", "H")),
        (((3, 3),), _avg3("G", "H", "H"))])
    v[VR] = table([
        (((0, 0), (1, 2)), _avg2("X", "A")), (((1, 0), (2, 2)), _avg2("A", "B")),
        (((2, 0), (3, 2)), _avg2("B", "C")), (((3, 0),), _avg2("C", "D")),
        (((0, 3),), _avg3("K", "J", "I")), (((0, 2),), _avg3("J", "I", "X")),
        (((0, 1), (1, 3)), _avg3("I", "X", "A")), (((1, 1), (2, 3)), _avg3("X", "A", "B")),
        (((2, 1), (3, 3)), _avg3("A", "B", "C")), (((3, 1),), _avg3("B", "C", "D"))])
    v[VL] = table([
        (((0, 0),), _avg2("A", "B")), (((1, 0), (0, 2)), _avg2("B", "C")),
        (((2, 0), (1, 2)), _avg2("C", "D")), (((3, 0), (2, 2)), _avg2("D", "E")),
        (((0, 1),), _avg3("A", "B", "C")), (((1, 1), (0, 3)), _avg3("B", "C", "D")),
        (((2, 1), (1, 3)), _avg3("C", "D", "E")), (((3, 1), (2, 3)), _avg3("D", "E", "F")),
        (((3, 2),), _avg3("E", "F", "G")), (((3, 3),), _avg3("F", "G", "H"))])
    v[HU] = table([
        (((0, 0),), _avg2("I", "J")), (((2, 0), (0, 1)), _avg2("J", "K")),
        (((2, 1), (0, 2)), _avg2("K", "L")), (((1, 0),), _avg3("I", "J", "K")),
        (((3, 0), (1, 1)), _avg3("J", "K", "L")), (((3, 1), (1, 2)), _avg3("K", "L", "L")),
        (((3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3)), ({"L": 1}, 0, 0))])
    v[HD] = table([
        (((0, 0), (2, 1)), _avg2("I", "X")), (((0, 1), (2, 2)), _avg2("J", "I")),
        (((0, 2), (2, 3)), _avg2("K", "J")), (((0, 3),), _avg2("L", "K")),
        (((3, 0),), _avg3("A", "B", "C")), (((2, 0),), _avg3("X", "A", "B")),
        (((1, 0), (3, 1)), _avg3("I", "X", "A")), (((1, 1), (3, 2)), _avg3("J", "I", "X")),
        (((1, 2), (3, 3)), _avg3("K", "J", "I")), (((1, 3),), _avg3("L", "K", "J"))])
    return v


def _weights4():
    """The 4x4 predictors as integer forms: mode -> weights [16, 13], a
    rounding term [16] and a shift [16] (pixel y * 4 + x); TrueMotion's
    rows are zero (it clips, so it is computed apart)."""
    w = np.zeros((10, 16, 13), np.int64)
    r = np.zeros((10, 16), np.int64)
    s = np.zeros((10, 16), np.int64)
    for mode, cells in _rules4().items():
        for (x, y), rule in cells.items():
            *parts, rnd, shift = rule
            for part in parts:
                for name, weight in part.items():
                    w[mode, 4 * y + x, _NB[name]] += weight
            r[mode, 4 * y + x], s[mode, 4 * y + x] = rnd, shift
    return w, r, s


_W4, _R4, _S4 = _weights4()


def _predict_block(plane, my, mx, size, modes):
    """The 16x16 luma or 8x8 chroma predictions of the macroblocks at
    (my, mx) [k] of a padded plane (row 0 and column 0 the borders: 127
    above, 129 left) -> [k, size, size]. DC has libwebp's edge forms."""
    r0, c0 = size * my, size * mx  # the padded row above, the padded column to the left
    ar = np.arange(size)
    top = plane[r0[:, None], c0[:, None] + 1 + ar]
    left = plane[r0[:, None] + 1 + ar, c0[:, None]]
    tl = plane[r0, c0][:, None, None]
    shift = 4 if size == 16 else 3
    dc = np.where((my > 0) & (mx > 0), (top.sum(1) + left.sum(1) + size) >> (shift + 1),
                  np.where(my > 0, (top.sum(1) + size // 2) >> shift,
                           np.where(mx > 0, (left.sum(1) + size // 2) >> shift, 128)))
    m = modes[:, None, None]
    return np.where(m == DC, dc[:, None, None],
                    np.where(m == VE, top[:, None, :],
                             np.where(m == HE, left[:, :, None],
                                      np.clip(left[:, :, None] + top[:, None, :] - tl, 0, 255))))


def _block_indices(my, mx, width: int):
    """For each macroblock's 4x4 blocks (raster order), the flat indices in
    the padded luma plane (`width` wide) of their 13 neighbours [n, 16, 13]
    and of their pixels [n, 16, 16]. A block in the last column takes the
    macroblock's top-right (above-right of its top row) as its E-H, as
    libwebp replicates it down."""
    r, c = np.divmod(np.arange(16), 4)
    row = (16 * my[:, None] + 4 * r)[..., None]  # the padded row above each block
    col = (16 * mx[:, None] + 4 * c)[..., None]  # the padded column to its left
    a4 = np.arange(4)
    right = np.where(c[:, None] < 3, row * width + col + 5 + a4,
                     (16 * my[:, None, None]) * width + 16 * mx[:, None, None] + 17 + a4)
    nb = np.concatenate([row * width + col, row * width + col + 1 + a4, right,
                         (row + 1 + a4) * width + col], -1)
    out = (row[..., None] + 1 + a4[:, None]) * width + col[..., None] + 1 + a4
    return nb, out.reshape(len(my), 16, 16)


def _reconstruct(mb, mbw: int, mbh: int, res: np.ndarray):
    """Prediction plus residual, one anti-diagonal of macroblocks at a
    time -> the unfiltered Y, U, V planes [16 mbh, 16 mbw], [8 mbh, 8 mbw]."""
    hm, wm = 16 * mbh, 16 * mbw
    ys = np.zeros((hm + 1, wm + 5), np.int64)  # 4 columns more: the last column's top-right
    ys[0], ys[1:, 0] = 127, 129
    us = np.zeros((hm // 2 + 1, wm // 2 + 1), np.int64)
    us[0], us[1:, 0] = 127, 129
    vs = us.copy()
    n = mbw * mbh
    my_all, mx_all = np.divmod(np.arange(n), mbw)
    res_y = res[:, :16].reshape(n, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4).reshape(n, 16, 16)
    res_u = res[:, 16:20].reshape(n, 2, 2, 4, 4).transpose(0, 1, 3, 2, 4).reshape(n, 8, 8)
    res_v = res[:, 20:24].reshape(n, 2, 2, 4, 4).transpose(0, 1, 3, 2, 4).reshape(n, 8, 8)
    res4 = res[:, :16].reshape(n, 16, 16)
    nb4, out4 = _block_indices(my_all, mx_all, wm + 5)
    t = mx_all + 2 * my_all
    order = np.argsort(t, kind="stable")
    bounds = np.searchsorted(t[order], np.arange(t.max() + 2))
    a16, a8 = np.arange(16), np.arange(8)
    is_i4 = mb["is_i4"]
    for step in range(len(bounds) - 1):
        ks = order[bounds[step] : bounds[step + 1]]
        my, mx = my_all[ks], mx_all[ks]
        big = ~is_i4[ks]
        if big.any():
            k, y, x = ks[big], my[big], mx[big]
            rec = np.clip(_predict_block(ys, y, x, 16, mb["ymode"][k]) + res_y[k], 0, 255)
            ys[(16 * y + 1)[:, None, None] + a16[:, None], (16 * x + 1)[:, None, None] + a16] = rec
        if (~big).any():
            k = ks[~big]
            flat = ys.reshape(-1)
            for b in range(16):
                nb = flat[nb4[k, b]]
                m = mb["bmodes"][k, b]
                lin = (np.einsum("kpn,kn->kp", _W4[m], nb) + _R4[m]) >> _S4[m]
                tm = nb[:, 9:13, None] + nb[:, None, 1:5] - nb[:, 0, None, None]
                pred = np.where((m == TM)[:, None], np.clip(tm.reshape(-1, 16), 0, 255), lin)
                flat[out4[k, b]] = np.clip(pred + res4[k, b], 0, 255)
        uvm = mb["uvmode"][ks]
        for plane, rr in ((us, res_u), (vs, res_v)):
            rec = np.clip(_predict_block(plane, my, mx, 8, uvm) + rr[ks], 0, 255)
            plane[(8 * my + 1)[:, None, None] + a8[:, None], (8 * mx + 1)[:, None, None] + a8] = rec
        last = mx == mbw - 1  # their bottom-right pixel is the next row's top-right
        ys[16 * my[last] + 16, wm + 1 : wm + 5] = ys[16 * my[last] + 16, wm][:, None]
    return ys[1 : hm + 1, 1 : wm + 1], us[1:, 1:], vs[1:, 1:]


# ---- the loop filter (libwebp's DoFilter, dsp/dec.c) -------------------------------------------

def _clamp(v, lo, hi):
    return np.minimum(np.maximum(v, lo), hi)


def _filter_lines(buf, idx, thresh2, ithresh, hev_t, kind: str):
    """Filter the edges across lines of 8 pixels p3 p2 p1 p0 | q0 q1 q2 q3
    at buf[idx] ([n, 8]); per-line thresholds [n]. kind: "simple", "edge"
    (a macroblock edge) or "inner"."""
    v = buf[idx]
    p3, p2, p1, p0, q0, q1, q2, q3 = v.T
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= thresh2
    if kind != "simple":
        it = ithresh
        mask &= ((np.abs(p3 - p2) <= it) & (np.abs(p2 - p1) <= it) & (np.abs(p1 - p0) <= it)
                 & (np.abs(q3 - q2) <= it) & (np.abs(q2 - q1) <= it) & (np.abs(q1 - q0) <= it))
    if not mask.any():
        return
    out = v.copy()
    if kind == "simple":
        hev = np.ones_like(mask)
    else:
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    # DoFilter2: the simple filter, and the normal one where the edge variance is high
    a = 3 * (q0 - p0) + _clamp(p1 - q1, -128, 127)
    a1 = _clamp((a + 4) >> 3, -16, 15)
    a2 = _clamp((a + 3) >> 3, -16, 15)
    two = mask & hev
    out[:, 3] = np.where(two, _clamp(p0 + a2, 0, 255), out[:, 3])
    out[:, 4] = np.where(two, _clamp(q0 - a1, 0, 255), out[:, 4])
    rest = mask & ~hev
    if kind == "inner":  # DoFilter4
        a = 3 * (q0 - p0)
        a1 = _clamp((a + 4) >> 3, -16, 15)
        a2 = _clamp((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        for col, val in ((2, p1 + a3), (3, p0 + a2), (4, q0 - a1), (5, q1 - a3)):
            out[:, col] = np.where(rest, _clamp(val, 0, 255), out[:, col])
    elif kind == "edge":  # DoFilter6
        a = _clamp(3 * (q0 - p0) + _clamp(p1 - q1, -128, 127), -128, 127)
        a1 = (27 * a + 63) >> 7
        a2 = (18 * a + 63) >> 7
        a3 = (9 * a + 63) >> 7
        for col, val in ((1, p2 + a3), (2, p1 + a2), (3, p0 + a1), (4, q0 - a1), (5, q1 - a2),
                         (6, q2 - a3)):
            out[:, col] = np.where(rest, _clamp(val, 0, 255), out[:, col])
    buf[idx] = out


def _mb_lines(my, mx, size, width, base, offset, vertical):
    """The flat indices [n, size, 8] of the lines of 8 pixels across one
    edge of each macroblock (a plane `width` wide at `base`): a vertical
    edge `offset` pixels into it (the lines are rows), or a horizontal one
    (the lines are columns)."""
    j = np.arange(size)[:, None]
    across = np.arange(-4, 4)
    if vertical:
        y = size * my[:, None, None] + j
        x = size * mx[:, None, None] + offset + across
    else:
        y = size * my[:, None, None] + offset + across
        x = size * mx[:, None, None] + j
    return base + y * width + x


def _loop_filter(planes, mb, hdr: _Header, mbw: int, mbh: int):
    """Filter the Y, U, V planes in place, in raster order's result: one
    anti-diagonal of macroblocks at a time, each edge of each macroblock
    on it (luma and chroma lines together) in one call."""
    if hdr.level == 0:
        return
    simple = bool(hdr.simple)
    levels = np.array(hdr.filter_levels())  # [segment, is 4x4, (limit, inner level, hev)]
    seg, i4 = mb["segment"], mb["is_i4"].astype(np.int64)
    limit, ilevel, hev_t = levels[seg, i4].T
    inner = i4.astype(bool) | (mb["coef"] != 0).any(axis=(1, 2))
    n = mbw * mbh
    my_all, mx_all = np.divmod(np.arange(n), mbw)
    y_plane, u_plane, v_plane = planes
    buf = np.concatenate([p.reshape(-1) for p in planes]).astype(np.int32)
    wy, wc = 16 * mbw, 8 * mbw
    lines = {}  # (vertical, edge) -> flat indices [n, lines, 8]: luma, then U and V
    for vertical in (True, False):
        for e, offset in enumerate((0, 4, 8, 12)):
            parts = [_mb_lines(my_all, mx_all, 16, wy, 0, offset, vertical)]
            if offset < 8 and not simple:  # chroma: its edge and one inner edge
                parts += [_mb_lines(my_all, mx_all, 8, wc, y_plane.size + i * u_plane.size,
                                    offset, vertical) for i in (0, 1)]
            lines[vertical, e] = np.concatenate(parts, axis=1)
    t = mx_all + 2 * my_all
    order = np.argsort(t, kind="stable")
    order = order[limit[order] > 0]
    bounds = np.searchsorted(t[order], np.arange(t.max() + 2))
    for step in range(len(bounds) - 1):
        ks = order[bounds[step] : bounds[step + 1]]
        if len(ks) == 0:
            continue
        for vertical in (True, False):
            first = (mx_all[ks] > 0) if vertical else (my_all[ks] > 0)
            for e, sel in enumerate((first, inner[ks], inner[ks], inner[ks])):
                if not sel.any():
                    continue
                k = ks[sel]
                idx = lines[vertical, e][k]
                per = idx.shape[1]
                kind = "simple" if simple else "edge" if e == 0 else "inner"
                lim = limit[k] + (4 if e == 0 else 0)
                _filter_lines(buf, idx.reshape(-1, 8), np.repeat(2 * lim + 1, per),
                              np.repeat(ilevel[k], per), np.repeat(hev_t[k], per), kind)
    sizes = np.cumsum([p.size for p in planes])
    for p, part in zip(planes, np.split(buf, sizes[:-1])):
        p[...] = part.reshape(p.shape)


# ---- upsampling and colour (libwebp's UpsampleRgbaLinePair and yuv.h) -------------------------

def _upsample_rows(near: np.ndarray, far: np.ndarray, width: int) -> np.ndarray:
    """One output row from its nearer chroma row and the farther one
    ([R, cw]), libwebp's fancy upsampler -> [R, width]."""
    out = np.empty((near.shape[0], width), np.int64)
    out[:, 0] = (3 * near[:, 0] + far[:, 0] + 2) >> 2
    pairs = (width - 1) >> 1
    if pairs:
        tl, t = near[:, :pairs], near[:, 1 : pairs + 1]
        l, c = far[:, :pairs], far[:, 1 : pairs + 1]
        avg = tl + t + l + c + 8
        out[:, 1 : 2 * pairs : 2] = (((avg + 2 * (t + l)) >> 3) + tl) >> 1
        out[:, 2 : 2 * pairs + 1 : 2] = (((avg + 2 * (tl + c)) >> 3) + t) >> 1
    if width % 2 == 0:
        out[:, width - 1] = (3 * near[:, pairs] + far[:, pairs] + 2) >> 2
    return out


def _upsample(plane: np.ndarray, height: int, width: int) -> np.ndarray:
    """A chroma plane [ceil(H / 2), ceil(W / 2)] -> [H, W]: row 0 from
    chroma row 0 alone; row 2j - 1 from rows j - 1 (near) and j, row 2j
    from rows j (near) and j - 1; a last odd row from its own."""
    r = np.arange(height)
    j = (r + 1) >> 1
    near = np.where(r % 2, j - 1, j)
    far = np.minimum(np.where(r % 2, j, j - 1), plane.shape[0] - 1)
    far[0] = 0
    return _upsample_rows(plane[near], plane[far], width)


def _clip8(v):
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def _to_rgb(y, u, v) -> np.ndarray:
    """libwebp's 14-bit fixed-point BT.601 conversion -> uint8 [H, W, 3]."""
    def hi(a, c):
        return (a * c) >> 8

    yy = hi(y, 19077)
    r = _clip8(yy + hi(v, 26149) - 14234)
    g = _clip8(yy - hi(u, 6419) - hi(v, 13320) + 8708)
    b = _clip8(yy + hi(u, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def decode_vp8(data: bytes) -> np.ndarray:
    """A VP8 key frame -> uint8 [H, W, 4], alpha 255."""
    width, height, hdr, mb = _parse(bytes(data))
    mbw, mbh = (width + 15) >> 4, (height + 15) >> 4
    coef = mb["coef"]
    big = ~mb["is_i4"]
    coef[big, :16, 0] = _wht(mb["y2"][big])
    res = _idct(coef.reshape(-1, 16)).reshape(-1, 24, 4, 4)
    planes = [p.copy() for p in _reconstruct(mb, mbw, mbh, res)]
    _loop_filter(planes, mb, hdr, mbw, mbh)
    y, u, v = planes
    cw, ch = (width + 1) >> 1, (height + 1) >> 1
    u = _upsample(u[:ch, :cw], height, width)
    v = _upsample(v[:ch, :cw], height, width)
    out = np.empty((height, width, 4), np.uint8)
    out[..., :3] = _to_rgb(y[:height, :width], u, v)
    out[..., 3] = 255
    return out
