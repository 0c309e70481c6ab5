"""The AV1 tables of rustic_tpu_torch/csrc/av1_tables.h: the default CDFs an
intra frame reads, read out of dav1d 1.5.1's copy in Pillow 12.1.0's bundled
libavif, and the AV1 specification's other tables that the tile decoder
(csrc/av1_intra.cpp) and its in-loop filters (csrc/av1_filters.h) use.

The library holds the default CDFs twice, as inverted 15-bit values
(32768 - x) with a counter slot after each CDF:

- dav1d's (src/cdf.c): one struct of the intra mode contexts, one of the
  key-frame y modes and the MV contexts, and four of the coefficient
  contexts (one per quantiser context), each table at a fixed offset in
  its struct and each CDF at a stride of 2, 4, 8 or 16 slots. The structs
  are found by the first CDF of each (`ANCHORS`), and each table is read
  at its offset (`DAV1D`), its rows checked to be CDFs.
- libaom's (av1/common/entropymode.c, entropymv.c, token_cdfs.h): each
  table an array of the specification's shape with N + 1 slots for N
  symbols (the partition CDFs one array of 11 slots, the UV modes' of 15,
  the palette colour indices' of 9). `libaom_bytes` lays a table out so;
  the tests find it in the library.

The header keeps the specification's form: increasing values, the last
32768, then the counter (0). dav1d keeps 41 of the specification's 42
Coeff_Base contexts (the last is never read) and Coeff_Br for the first
four transform sizes (the specification reads Min(txSzCtx, TX_32X32)), so
the header does too.

    python -m tests.test_torch_image_formats_avif --tables

rewrites the header; only a host with Pillow's libavif can.
"""

from __future__ import annotations

import glob
import os

import numpy as np

HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "rustic_tpu_torch", "csrc", "av1_tables.h")


def library_bytes() -> bytes:
    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    with open(glob.glob(os.path.join(libs, "libavif-*.so*"))[0], "rb") as f:
        return f.read()


# The first CDF of each dav1d struct, inverted, as stored, and its stride in slots (the
# padding tells it from libaom's copy of the same values).
ANCHORS = {
    "mode": ([10137, 8616, 7390, 7107, 6782, 6248, 5713, 4845, 4524, 2709, 1827, 807], 16),
    "kfym": ([17180, 15741, 13430, 12550, 12086, 11658, 10943, 9524, 8579, 4603, 3675, 2302], 16),
    "coef": ([31928, 31729, 30788, 27873], 8),
}
COEF_STRUCT = 6208  # sizeof(CdfCoefContext), the four quantiser contexts back to back

# dav1d's BlockSize order (BS_128x128 ... BS_4x4) -> the specification's BLOCK_ index
_SPEC_BLOCKS = ["4X4", "4X8", "8X4", "8X8", "8X16", "16X8", "16X16", "16X32", "32X16", "32X32",
                "32X64", "64X32", "64X64", "64X128", "128X64", "128X128", "4X16", "16X4",
                "8X32", "32X8", "16X64", "64X16"]
_DAV1D_BLOCKS = ["128X128", "128X64", "64X128", "64X64", "64X32", "64X16", "32X64", "32X32",
                 "32X16", "32X8", "16X64", "16X32", "16X16", "16X8", "16X4", "8X32", "8X16",
                 "8X8", "8X4", "4X16", "4X8", "4X4"]

# name -> (struct, byte offset, dims, dav1d stride in slots, symbols, libaom stride)
# dims are the specification's; each row is one CDF.
DAV1D = {
    "Default_Partition_W8_Cdf": ("mode", 1344, (4,), 16, 4, 11),
    "Default_Partition_W16_Cdf": ("mode", 1216, (4,), 16, 10, 11),
    "Default_Partition_W32_Cdf": ("mode", 1088, (4,), 16, 10, 11),
    "Default_Partition_W64_Cdf": ("mode", 960, (4,), 16, 10, 11),
    "Default_Partition_W128_Cdf": ("mode", 832, (4,), 16, 8, 11),
    "Default_Intra_Frame_Y_Mode_Cdf": ("kfym", 0, (5, 5), 16, 13, 14),
    "Default_Uv_Mode_Cfl_Not_Allowed_Cdf": ("mode", 0, (13,), 16, 13, 15),
    "Default_Uv_Mode_Cfl_Allowed_Cdf": ("mode", 416, (13,), 16, 14, 15),
    "Default_Angle_Delta_Cdf": ("mode", 2816, (8,), 8, 7, 8),
    "Default_Intrabc_Cdf": ("mode", 4804, (), 2, 2, 3),
    "Default_Skip_Cdf": ("mode", 4700, (3,), 2, 2, 3),
    "Default_Filter_Intra_Cdfs": ("mode", 4528, (22,), 2, 2, 3),
    "Default_Filter_Intra_Mode_Cdf": ("mode", 2944, (), 8, 5, 6),
    "Default_Cfl_Sign_Cdf": ("mode", 2800, (), 8, 8, 9),
    "Default_Cfl_Alpha_Cdf": ("mode", 1472, (6,), 16, 16, 17),
    "Default_Palette_Y_Mode_Cdf": ("mode", 4712, (7, 3), 2, 2, 3),
    "Default_Palette_Uv_Mode_Cdf": ("mode", 4796, (2,), 2, 2, 3),
    "Default_Palette_Y_Size_Cdf": ("mode", 3008, (7,), 8, 7, 8),
    "Default_Palette_Uv_Size_Cdf": ("mode", 3008 + 7 * 16, (7,), 8, 7, 8),
    "Default_Segment_Id_Cdf": ("mode", 2960, (3,), 8, 8, 9),
    "Default_Delta_Q_Cdf": ("mode", 4448, (), 4, 4, 5),
    "Default_Delta_Lf_Cdf": ("mode", 4456 + 4 * 8, (), 4, 4, 5),
    "Default_Delta_Lf_Multi_Cdf": ("mode", 4456, (4,), 4, 4, 5),
    "Default_Mv_Joint_Cdf": ("kfym", -32, (), 4, 4, 5),
    "Default_Mv_Class_Cdf": ("kfym", -160, (), 16, 11, 12),
    "Default_Mv_Sign_Cdf": ("kfym", -128, (), 2, 2, 3),
    "Default_Mv_Class0_Bit_Cdf": ("kfym", -124, (), 2, 2, 3),
    "Default_Mv_Class0_Fr_Cdf": ("kfym", -120, (2,), 4, 4, 5),
    "Default_Mv_Class0_Hp_Cdf": ("kfym", -104, (), 2, 2, 3),
    "Default_Mv_Bit_Cdf": ("kfym", -100, (10,), 2, 2, 3),
    "Default_Mv_Fr_Cdf": ("kfym", -56, (), 4, 4, 5),
    "Default_Mv_Hp_Cdf": ("kfym", -48, (), 2, 2, 3),
    # tx_depth by the block's largest transform (dav1d's txsz[4][3], 2 symbols at 8x8)
    "Default_Tx_8x8_Cdf": ("mode", 4352, (3,), 4, 2, 4),
    "Default_Tx_16x16_Cdf": ("mode", 4376, (3,), 4, 3, 4),
    "Default_Tx_32x32_Cdf": ("mode", 4400, (3,), 4, 3, 4),
    "Default_Tx_64x64_Cdf": ("mode", 4424, (3,), 4, 3, 4),
    "Default_Txfm_Split_Cdf": ("mode", 4616, (21,), 2, 2, 3),
    # the transform types by Tx_Size_Sqr (and the intra direction); libaom's arrays hold
    # every set at 17 slots a CDF
    "Default_Intra_Tx_Type_Set1_Cdf": ("mode", 1760, (2, 13), 8, 7, 17),
    "Default_Intra_Tx_Type_Set2_Cdf": ("mode", 2176, (3, 13), 8, 5, 17),
    "Default_Inter_Tx_Type_Set1_Cdf": ("mode", 1664, (2,), 16, 16, 17),
    "Default_Inter_Tx_Type_Set2_Cdf": ("mode", 1728, (), 16, 12, 17),
    "Default_Inter_Tx_Type_Set3_Cdf": ("mode", 4512, (4,), 2, 2, 17),
    # loop restoration: restoration_type (RESTORE_SWITCHABLE), use_wiener, use_sgrproj
    "Default_Restoration_Type_Cdf": ("mode", 4496, (), 4, 3, 4),
    "Default_Use_Wiener_Cdf": ("mode", 4504, (), 2, 2, 3),
    "Default_Use_Sgrproj_Cdf": ("mode", 4508, (), 2, 2, 3),
}
for _n in range(2, 9):
    for _k, _plane in enumerate(("Y", "Uv")):
        DAV1D[f"Default_Palette_Size_{_n}_{_plane}_Color_Cdf"] = (
            "mode", 3232 + _k * 7 * 5 * 16 + (_n - 2) * 5 * 16, (5,), 8, _n, 9)

# the coefficient CDFs: name -> (offset in a CdfCoefContext, dims after the quantiser
# context, dav1d stride, symbols, libaom stride)
COEF = {
    "Default_Eob_Pt_16_Cdf": (0, (2, 2), 8, 5, 6),
    "Default_Eob_Pt_32_Cdf": (64, (2, 2), 8, 6, 7),
    "Default_Eob_Pt_64_Cdf": (128, (2, 2), 8, 7, 8),
    "Default_Eob_Pt_128_Cdf": (192, (2, 2), 8, 8, 9),
    "Default_Eob_Pt_256_Cdf": (256, (2, 2), 16, 9, 10),
    "Default_Eob_Pt_512_Cdf": (384, (2,), 16, 10, 11),
    "Default_Eob_Pt_1024_Cdf": (448, (2,), 16, 11, 12),
    "Default_Coeff_Base_Eob_Cdf": (512, (5, 2, 4), 4, 3, 4),
    "Default_Coeff_Base_Cdf": (832, (5, 2, 41), 4, 4, 5),
    "Default_Coeff_Br_Cdf": (4112, (4, 2, 21), 4, 4, 5),
    "Default_Txb_Skip_Cdf": (5896, (5, 13), 2, 2, 3),
    "Default_Eob_Extra_Cdf": (5456, (5, 2, 11), 2, 2, 3),  # dav1d's 11; the spec's 9 are 2-10
    "Default_Dc_Sign_Cdf": (6156, (2, 3), 2, 2, 3),
}


def _find(data: bytes, anchor) -> int:
    values, stride = anchor
    key = np.array(values + [0] * (stride - len(values)), np.uint16).tobytes()
    at = data.find(key)
    if at < 0 or data.find(key, at + 1) >= 0:
        raise ValueError(f"anchor {values[:3]} not found once in the library")
    return at


def _rows(data: bytes, at: int, count: int, stride: int, n: int) -> np.ndarray:
    """`count` inverted CDFs of `n` symbols at a stride of `stride` slots ->
    [count, n + 1] in the specification's form; raises unless each row is a
    CDF with zeros after it."""
    raw = np.frombuffer(data[at : at + 2 * count * stride], np.uint16).reshape(count, stride)
    body = raw[:, : n - 1].astype(np.int64)
    if (raw[:, n - 1 :] != 0).any() or (body <= 0).any() or (np.diff(body, axis=1) > 0).any():
        raise ValueError(f"no CDF of {n} symbols at byte {at}")
    out = np.zeros((count, n + 1), np.int64)
    out[:, : n - 1] = 32768 - body
    out[:, n - 1] = 32768
    return out


def read_tables(data: bytes = None) -> dict:
    """name -> int64 array of the specification's shape (each CDF's N values
    and its counter) read from dav1d's copy."""
    data = data or library_bytes()
    bases = {k: _find(data, v) for k, v in ANCHORS.items()}
    out = {}
    for name, (struct, off, dims, stride, n, _) in DAV1D.items():
        count = int(np.prod(dims)) if dims else 1
        rows = _rows(data, bases[struct] + off, count, stride, n)
        if name == "Default_Filter_Intra_Cdfs":  # dav1d's block order -> the spec's
            rows = rows[[_DAV1D_BLOCKS.index(b) for b in _SPEC_BLOCKS]]
        out[name] = rows.reshape(*dims, n + 1)
    for name, (off, dims, stride, n, _) in COEF.items():
        count = int(np.prod(dims))
        q = [_rows(data, bases["coef"] + COEF_STRUCT * k + off, count, stride, n).reshape(
            *dims, n + 1) for k in range(4)]
        out[name] = np.stack(q)
    out["Default_Eob_Extra_Cdf"] = out["Default_Eob_Extra_Cdf"][:, :, :, 2:]
    return out


# libaom's build moved these small tables into instruction immediates (its frame-context
# set-up copies them), so they are found two slots at a time.
IMMEDIATE = ("Default_Skip_Cdf", "Default_Cfl_Sign_Cdf", "Default_Palette_Uv_Mode_Cdf",
             "Default_Segment_Id_Cdf", "Default_Intrabc_Cdf", "Default_Filter_Intra_Mode_Cdf",
             "Default_Mv_Sign_Cdf", "Default_Mv_Class0_Bit_Cdf", "Default_Mv_Class0_Hp_Cdf",
             "Default_Mv_Hp_Cdf", "Default_Delta_Q_Cdf", "Default_Delta_Lf_Cdf",
             "Default_Use_Wiener_Cdf")


def libaom_bytes(name: str, table: np.ndarray) -> list:
    """The table as libaom lays it out -> the byte strings its copy holds:
    the whole table where libaom's array has its shape, else its blocks
    (libaom keeps 42 Coeff_Base contexts and five Coeff_Br transform sizes,
    and a second, unused context row after each Eob_Pt_512 and _1024 CDF)."""
    n = table.shape[-1] - 1
    stride = DAV1D[name][5] if name in DAV1D else COEF[name][4]
    rows = table.reshape(-1, n + 1)
    out = np.zeros((len(rows), stride), np.uint16)
    out[:, :n] = 32768 - rows[:, :n]
    if name in ("Default_Coeff_Base_Cdf", "Default_Coeff_Br_Cdf"):
        per = table.shape[-2]
        return [out[i : i + per].tobytes() for i in range(0, len(out), per)]
    if name in ("Default_Eob_Pt_512_Cdf", "Default_Eob_Pt_1024_Cdf"):
        return [row.tobytes() for row in out]
    if name in IMMEDIATE:
        raw = out.tobytes()
        return [raw[i : i + 4] for i in range(0, len(raw), 4)]
    return [out.tobytes()]


# ---- the specification's other tables ------------------------------------------------------

SM_WEIGHTS = {
    4: [255, 149, 85, 64],
    8: [255, 197, 146, 105, 73, 50, 37, 32],
    16: [255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33, 26, 20, 17, 16],
    32: [255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111, 101, 92, 83, 74, 66, 59, 52,
         45, 39, 34, 29, 25, 21, 17, 14, 12, 10, 9, 8, 8],
    64: [255, 248, 240, 233, 225, 218, 210, 203, 196, 189, 182, 176, 169, 163, 156, 150, 144, 138,
         133, 127, 121, 116, 111, 106, 101, 96, 91, 86, 82, 77, 73, 69, 65, 61, 57, 54, 50, 47, 44,
         41, 38, 35, 32, 29, 27, 25, 22, 20, 18, 16, 15, 13, 12, 10, 9, 8, 7, 6, 6, 5, 5, 4, 4, 4],
}
DR_INTRA_DERIVATIVE = [0] * 90
for _a, _v in {3: 1023, 6: 547, 9: 372, 14: 273, 17: 215, 20: 178, 23: 151, 26: 132, 29: 116,
               32: 102, 36: 90, 39: 80, 42: 71, 45: 64, 48: 57, 51: 51, 54: 45, 58: 40, 61: 35,
               64: 31, 67: 27, 70: 23, 73: 19, 76: 15, 81: 11, 84: 7, 87: 3}.items():
    DR_INTRA_DERIVATIVE[_a] = _v
MODE_TO_ANGLE = [0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0]
INTRA_FILTER_TAPS = [
    [[-6, 10, 0, 0, 0, 12, 0], [-5, 2, 10, 0, 0, 9, 0], [-3, 1, 1, 10, 0, 7, 0],
     [-3, 1, 1, 2, 10, 5, 0], [-4, 6, 0, 0, 0, 2, 12], [-3, 2, 6, 0, 0, 2, 9],
     [-3, 2, 2, 6, 0, 2, 7], [-3, 1, 2, 2, 6, 3, 5]],
    [[-10, 16, 0, 0, 0, 10, 0], [-6, 0, 16, 0, 0, 6, 0], [-4, 0, 0, 16, 0, 4, 0],
     [-2, 0, 0, 0, 16, 2, 0], [-10, 16, 0, 0, 0, 0, 10], [-6, 0, 16, 0, 0, 0, 6],
     [-4, 0, 0, 16, 0, 0, 4], [-2, 0, 0, 0, 16, 0, 2]],
    [[-8, 8, 0, 0, 0, 16, 0], [-8, 0, 8, 0, 0, 16, 0], [-8, 0, 0, 8, 0, 16, 0],
     [-8, 0, 0, 0, 8, 16, 0], [-4, 4, 0, 0, 0, 0, 16], [-4, 0, 4, 0, 0, 0, 16],
     [-4, 0, 0, 4, 0, 0, 16], [-4, 0, 0, 0, 4, 0, 16]],
    [[-2, 8, 0, 0, 0, 10, 0], [-1, 3, 8, 0, 0, 6, 0], [-1, 2, 3, 8, 0, 4, 0],
     [0, 1, 2, 3, 8, 2, 0], [-1, 4, 0, 0, 0, 3, 10], [-1, 3, 4, 0, 0, 4, 6],
     [-1, 2, 3, 4, 0, 4, 4], [-1, 2, 2, 3, 4, 3, 3]],
    [[-12, 14, 0, 0, 0, 14, 0], [-10, 0, 14, 0, 0, 12, 0], [-9, 0, 0, 14, 0, 11, 0],
     [-8, 0, 0, 0, 14, 10, 0], [-10, 12, 0, 0, 0, 0, 14], [-9, 1, 12, 0, 0, 0, 12],
     [-8, 0, 0, 12, 0, 1, 11], [-7, 0, 0, 1, 12, 1, 9]],
]
# the transform sizes: TX_4X4 ... TX_64X16 as the specification numbers them
TX_SIZES_ALL = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4), (8, 16), (16, 8),
                (16, 32), (32, 16), (32, 64), (64, 32), (4, 16), (16, 4), (8, 32), (32, 8),
                (16, 64), (64, 16)]  # (width, height)
SCAN_SIZES = [(4, 8), (8, 4), (8, 8), (8, 16), (16, 8), (16, 16), (16, 32), (32, 16), (32, 32),
              (4, 16), (16, 4), (8, 32), (32, 8)]
MROW_SIZES = [(4, 8), (8, 4), (8, 8), (8, 16), (16, 8), (16, 16), (4, 16), (16, 4)]


def default_scan(w: int, h: int) -> list:
    """Default_Scan_WxH: positions row * w + col. Square sizes zig-zag
    (the odd anti-diagonals down from the top row, the even ones up from
    the left column); the others walk each anti-diagonal along the longer
    side (down the rows where h > w, along the columns where w > h)."""
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]
        if (w == h and d % 2 == 0) or w > h:
            cells = cells[::-1]
        out += [r * w + c for r, c in cells]
    return out


def mrow_scan(w: int, h: int) -> list:
    return list(range(w * h))


def mcol_scan(w: int, h: int) -> list:
    return [r * w + c for c in range(w) for r in range(h)]


DC_QLOOKUP = [4, 8, 8, 9, 10, 11, 12, 12, 13, 14, 15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25,
    26, 26, 27, 28, 29, 30, 31, 32, 32, 33, 34, 35, 36, 37, 38, 38, 39, 40, 41, 42, 43, 43, 44,
    45, 46, 47, 48, 48, 49, 50, 51, 52, 53, 53, 54, 55, 56, 57, 57, 58, 59, 60, 61, 62, 62, 63,
    64, 65, 66, 66, 67, 68, 69, 70, 70, 71, 72, 73, 74, 74, 75, 76, 77, 78, 78, 79, 80, 81, 81,
    82, 83, 84, 85, 85, 87, 88, 90, 92, 93, 95, 96, 98, 99, 101, 102, 104, 105, 107, 108, 110,
    111, 113, 114, 116, 117, 118, 120, 121, 123, 125, 127, 129, 131, 134, 136, 138, 140, 142, 144,
    146, 148, 150, 152, 154, 156, 158, 161, 164, 166, 169, 172, 174, 177, 180, 182, 185, 187, 190,
    192, 195, 199, 202, 205, 208, 211, 214, 217, 220, 223, 226, 230, 233, 237, 240, 243, 247, 250,
    253, 257, 261, 265, 269, 272, 276, 280, 284, 288, 292, 296, 300, 304, 309, 313, 317, 322, 326,
    330, 335, 340, 344, 349, 354, 359, 364, 369, 374, 379, 384, 389, 395, 400, 406, 411, 417, 423,
    429, 435, 441, 447, 454, 461, 467, 475, 482, 489, 497, 505, 513, 522, 530, 539, 549, 559, 569,
    579, 590, 602, 614, 626, 640, 654, 668, 684, 700, 717, 736, 755, 775, 796, 819, 843, 869, 896,
    925, 955, 988, 1022, 1058, 1098, 1139, 1184, 1232, 1282, 1336]  # Dc_Qlookup[0]: 8-bit
AC_QLOOKUP = [4, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97,
    98, 99, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 120, 122, 124, 126, 128, 130,
    132, 134, 136, 138, 140, 142, 144, 146, 148, 150, 152, 155, 158, 161, 164, 167, 170, 173, 176,
    179, 182, 185, 188, 191, 194, 197, 200, 203, 207, 211, 215, 219, 223, 227, 231, 235, 239, 243,
    247, 251, 255, 260, 265, 270, 275, 280, 285, 290, 295, 300, 305, 311, 317, 323, 329, 335, 341,
    347, 353, 359, 366, 373, 380, 387, 394, 401, 408, 416, 424, 432, 440, 448, 456, 465, 474, 483,
    492, 501, 510, 520, 530, 540, 550, 560, 571, 582, 593, 604, 615, 627, 639, 651, 663, 676, 689,
    702, 715, 729, 743, 757, 771, 786, 801, 816, 832, 848, 864, 881, 898, 915, 933, 951, 969, 988,
    1007, 1026, 1046, 1066, 1087, 1108, 1129, 1151, 1173, 1196, 1219, 1243, 1267, 1292, 1317,
    1343, 1369, 1396, 1423, 1451, 1479, 1508, 1537, 1567, 1597, 1628, 1660, 1692, 1725, 1759,
    1793, 1828]
COS128_LOOKUP = [round(4096 * np.cos(i * np.pi / 128)) for i in range(65)]  # cos128(0..64)
# DCT_DCT, ADST_DCT, DCT_ADST or ADST_ADST by intra mode (UV_CFL_PRED last)
MODE_TO_TXFM = [0, 1, 2, 0, 3, 1, 2, 2, 1, 3, 1, 2, 3, 0]
TRANSFORM_ROW_SHIFT = [0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2]
MAX_TX_SIZE_RECT = [0, 5, 6, 1, 7, 8, 2, 9, 10, 3, 11, 12, 4, 4, 4, 4, 13, 14, 15, 16, 17, 18]
MAX_TX_DEPTH = [0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 4, 4, 4, 2, 2, 3, 3, 4, 4]
SPLIT_TX_SIZE = [0, 0, 1, 2, 3, 0, 0, 1, 1, 2, 2, 3, 3, 5, 6, 7, 8, 9, 10]
ADJUSTED_TX_SIZE = [0, 1, 2, 3, 3, 5, 6, 7, 8, 9, 10, 3, 3, 13, 14, 15, 16, 9, 10]
# the read tx type -> TxType, per set (TX_SET_INTRA_1/2, TX_SET_INTER_1/2/3)
TX_TYPE_INTRA_INV_SET1 = [9, 0, 10, 11, 3, 1, 2]
TX_TYPE_INTRA_INV_SET2 = [9, 0, 3, 1, 2]
TX_TYPE_INTER_INV_SET1 = [9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 4, 5, 3, 6, 7, 8]
TX_TYPE_INTER_INV_SET2 = [9, 10, 11, 0, 1, 2, 4, 5, 3, 6, 7, 8]
TX_TYPE_INTER_INV_SET3 = [9, 0]
TX_TYPE_IN_SET_INTRA = [[1] + [0] * 15, [1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0],
                        [1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0]]
TX_TYPE_IN_SET_INTER = [[1] + [0] * 15, [1] * 16, [1] * 12 + [0] * 4,
                        [1] + [0] * 8 + [1] + [0] * 6]

INTRA_EDGE_KERNEL = [[0, 4, 8, 4, 0], [0, 5, 6, 5, 0], [2, 4, 4, 4, 2]]
INTRA_EDGE_UPSAMPLE = [-1, 9, 9, -1]  # the taps of the intra edge upsample process
DEFAULT_SCAN_4X4 = [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]
MROW_SCAN_4X4 = list(range(16))
MCOL_SCAN_4X4 = [0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15]
COEFF_BASE_CTX_OFFSET_4X4 = [[0, 1, 6, 6, 0], [1, 6, 6, 21, 0], [6, 6, 21, 21, 0],
                             [6, 21, 21, 21, 0], [0, 0, 0, 0, 0]]
_CTX_SQUARE = [[0, 1, 6, 6, 21], [1, 6, 6, 21, 21], [6, 6, 21, 21, 21], [6, 21, 21, 21, 21],
               [21] * 5]
_CTX_WIDE = [[0, 16, 6, 6, 21], [16, 16, 6, 21, 21]] + [[16, 16, 21, 21, 21]] * 3
_CTX_TALL = [[0, 11, 11, 11, 11], [11] * 5, [6, 6, 21, 21, 21], [6, 21, 21, 21, 21], [21] * 5]


def coeff_base_ctx_offset(w: int, h: int) -> list:
    """Coeff_Base_Ctx_Offset[txSz] ([row][col], rows and columns past the
    coded block's 0): by the transform's own shape, 64x32 wide and 32x64
    tall though each codes its 32x32 corner."""
    table = _CTX_SQUARE if w == h else _CTX_WIDE if w > h else _CTX_TALL
    w, h = min(w, 32), min(h, 32)
    return [[table[r][c] if r < h and c < w else 0 for c in range(5)] for r in range(5)]


COEFF_BASE_CTX_OFFSET = [coeff_base_ctx_offset(w, h) for w, h in TX_SIZES_ALL]
assert COEFF_BASE_CTX_OFFSET[0] == COEFF_BASE_CTX_OFFSET_4X4
COEFF_BASE_POS_CTX_OFFSET = [26, 31, 36]
SIG_REF_DIFF_OFFSET = [[[0, 1], [1, 0], [1, 1], [0, 2], [2, 0]],  # TX_CLASS_2D, _HORIZ, _VERT
                       [[0, 1], [1, 0], [0, 2], [0, 3], [0, 4]],
                       [[0, 1], [1, 0], [2, 0], [3, 0], [4, 0]]]
MAG_REF_OFFSET_WITH_TX_CLASS = [[[0, 1], [1, 0], [1, 1]], [[0, 1], [1, 0], [0, 2]],
                                [[0, 1], [1, 0], [2, 0]]]
PALETTE_COLOR_CONTEXT = [-1, -1, 0, -1, -1, 4, 3, 2, 1]
PALETTE_COLOR_HASH_MULTIPLIERS = [1, 2, 2]

# the in-loop filters (7.15-7.17): CDEF's chroma direction at 4:2:2 and 4:4:0 (by
# subsampling_x, subsampling_y), its tap offsets (row, column) by direction, its taps and
# the direction search's divisors; the self-guided filter's radius and eps pairs, its
# x / (x + 1) in 8 bits, and the Wiener and self-guided coefficients' ranges
CDEF_UV_DIR = [[[0, 1, 2, 3, 4, 5, 6, 7], [1, 2, 2, 2, 3, 4, 6, 0]],
               [[7, 0, 2, 4, 5, 6, 6, 6], [0, 1, 2, 3, 4, 5, 6, 7]]]
CDEF_DIRECTIONS = [[[-1, 1], [-2, 2]], [[0, 1], [-1, 2]], [[0, 1], [0, 2]], [[0, 1], [1, 2]],
                   [[1, 1], [2, 2]], [[1, 0], [2, 1]], [[1, 0], [2, 0]], [[1, 0], [2, -1]]]
CDEF_PRI_TAPS = [[4, 2], [3, 3]]
CDEF_SEC_TAPS = [[2, 1], [2, 1]]
DIV_TABLE = [0, 840, 420, 280, 210, 168, 140, 120, 105]
SGR_PARAMS = [[2, 12, 1, 4], [2, 15, 1, 6], [2, 18, 1, 8], [2, 21, 1, 9], [2, 24, 1, 10],
              [2, 29, 1, 11], [2, 36, 1, 12], [2, 45, 1, 13], [2, 56, 1, 14], [2, 68, 1, 15],
              [0, 0, 1, 5], [0, 0, 1, 8], [0, 0, 1, 11], [0, 0, 1, 14], [2, 30, 0, 0],
              [2, 75, 0, 0]]  # (r0, eps0, r1, eps1)
SGR_X_BY_XPLUS1 = [1] + [((z << 8) + z // 2) // (z + 1) for z in range(1, 255)] + [256]
WIENER_TAPS_MIN, WIENER_TAPS_MID, WIENER_TAPS_MAX = [-5, -23, -17], [3, -7, 15], [10, 8, 46]
WIENER_TAPS_K = [1, 2, 3]
SGRPROJ_XQD_MIN, SGRPROJ_XQD_MID, SGRPROJ_XQD_MAX = [-96, -32], [-32, 31], [31, 95]

OTHER = {  # name -> (C type, values)
    **{f"Sm_Weights_Tx_{n}x{n}": ("uint8_t", SM_WEIGHTS[n]) for n in SM_WEIGHTS},
    "Dr_Intra_Derivative": ("int16_t", DR_INTRA_DERIVATIVE),
    "Mode_To_Angle": ("int16_t", MODE_TO_ANGLE),
    "Intra_Filter_Taps": ("int8_t", INTRA_FILTER_TAPS),
    "Intra_Edge_Kernel": ("int8_t", INTRA_EDGE_KERNEL),
    "Intra_Edge_Upsample_Taps": ("int8_t", INTRA_EDGE_UPSAMPLE),
    "Default_Scan_4x4": ("uint16_t", DEFAULT_SCAN_4X4),
    "Mrow_Scan_4x4": ("uint16_t", MROW_SCAN_4X4),
    "Mcol_Scan_4x4": ("uint16_t", MCOL_SCAN_4X4),
    **{f"Default_Scan_{w}x{h}": ("uint16_t", default_scan(w, h)) for w, h in SCAN_SIZES},
    **{f"Mrow_Scan_{w}x{h}": ("uint16_t", mrow_scan(w, h)) for w, h in MROW_SIZES},
    **{f"Mcol_Scan_{w}x{h}": ("uint16_t", mcol_scan(w, h)) for w, h in MROW_SIZES},
    "Coeff_Base_Ctx_Offset": ("uint8_t", COEFF_BASE_CTX_OFFSET),
    "Coeff_Base_Pos_Ctx_Offset": ("uint8_t", COEFF_BASE_POS_CTX_OFFSET),
    "Sig_Ref_Diff_Offset": ("int8_t", SIG_REF_DIFF_OFFSET),
    "Mag_Ref_Offset_With_Tx_Class": ("int8_t", MAG_REF_OFFSET_WITH_TX_CLASS),
    "Dc_Qlookup": ("int16_t", DC_QLOOKUP),
    "Cos128_Lookup": ("int16_t", COS128_LOOKUP),
    "Ac_Qlookup": ("int16_t", AC_QLOOKUP),
    "Mode_To_Txfm": ("uint8_t", MODE_TO_TXFM),
    "Transform_Row_Shift": ("uint8_t", TRANSFORM_ROW_SHIFT),
    "Max_Tx_Size_Rect": ("uint8_t", MAX_TX_SIZE_RECT),
    "Max_Tx_Depth": ("uint8_t", MAX_TX_DEPTH),
    "Split_Tx_Size": ("uint8_t", SPLIT_TX_SIZE),
    "Adjusted_Tx_Size": ("uint8_t", ADJUSTED_TX_SIZE),
    "Tx_Type_Intra_Inv_Set1": ("uint8_t", TX_TYPE_INTRA_INV_SET1),
    "Tx_Type_Intra_Inv_Set2": ("uint8_t", TX_TYPE_INTRA_INV_SET2),
    "Tx_Type_Inter_Inv_Set1": ("uint8_t", TX_TYPE_INTER_INV_SET1),
    "Tx_Type_Inter_Inv_Set2": ("uint8_t", TX_TYPE_INTER_INV_SET2),
    "Tx_Type_Inter_Inv_Set3": ("uint8_t", TX_TYPE_INTER_INV_SET3),
    "Tx_Type_In_Set_Intra": ("uint8_t", TX_TYPE_IN_SET_INTRA),
    "Tx_Type_In_Set_Inter": ("uint8_t", TX_TYPE_IN_SET_INTER),
    "Palette_Color_Context": ("int8_t", PALETTE_COLOR_CONTEXT),
    "Palette_Color_Hash_Multipliers": ("uint8_t", PALETTE_COLOR_HASH_MULTIPLIERS),
    "Cdef_Uv_Dir": ("uint8_t", CDEF_UV_DIR),
    "Cdef_Directions": ("int8_t", CDEF_DIRECTIONS),
    "Cdef_Pri_Taps": ("uint8_t", CDEF_PRI_TAPS),
    "Cdef_Sec_Taps": ("uint8_t", CDEF_SEC_TAPS),
    "Div_Table": ("int16_t", DIV_TABLE),
    "Sgr_Params": ("int16_t", SGR_PARAMS),
    "Sgr_X_By_Xplus1": ("int16_t", SGR_X_BY_XPLUS1),
    "Wiener_Taps_Min": ("int8_t", WIENER_TAPS_MIN),
    "Wiener_Taps_Mid": ("int8_t", WIENER_TAPS_MID),
    "Wiener_Taps_Max": ("int8_t", WIENER_TAPS_MAX),
    "Wiener_Taps_K": ("int8_t", WIENER_TAPS_K),
    "Sgrproj_Xqd_Min": ("int8_t", SGRPROJ_XQD_MIN),
    "Sgrproj_Xqd_Mid": ("int8_t", SGRPROJ_XQD_MID),
    "Sgrproj_Xqd_Max": ("int8_t", SGRPROJ_XQD_MAX),
}


def _c_array(values) -> str:
    a = np.asarray(values)
    if a.ndim == 1:
        return "{" + ", ".join(str(int(v)) for v in a) + "}"
    return "{" + ", ".join(_c_array(v) for v in a) + "}"


def header_text(tables: dict = None) -> str:
    tables = tables if tables is not None else read_tables()
    lines = ["// The AV1 tables of csrc/av1_intra.cpp and csrc/av1_filters.h, under the AV1",
             "// specification's names.",
             "// Generated by `python -m tests.test_torch_image_formats_avif --tables`: the",
             "// default CDFs are read from dav1d 1.5.1's copy in Pillow 12.1.0's libavif",
             "// (tests/av1_cdf_tables.py), in the specification's form (increasing values,",
             "// the last 32768, then the adaptation counter). Do not edit.",
             "#pragma once", "#include <cstdint>", ""]
    for name, table in tables.items():
        dims = "".join(f"[{d}]" for d in table.shape)
        lines.append(f"static const uint16_t {name}{dims} = {_c_array(table)};")
    lines.append("")
    for name, (ctype, values) in OTHER.items():
        dims = "".join(f"[{d}]" for d in np.asarray(values).shape)
        lines.append(f"static const {ctype} {name}{dims} = {_c_array(values)};")
    return "\n".join(lines) + "\n"


def write_header(path: str = HEADER) -> str:
    with open(path, "w") as f:
        f.write(header_text())
    return path


def parse_header(text: str) -> dict:
    """The CDF tables of a header `header_text` wrote -> name -> flat list."""
    out = {}
    for line in text.splitlines():
        if line.startswith("static const uint16_t "):
            name = line.split()[3].split("[")[0]
            body = line.split("=", 1)[1].strip().rstrip(";")
            out[name] = [int(v) for v in body.replace("{", " ").replace("}", " ").replace(
                ",", " ").split()]
    return out
