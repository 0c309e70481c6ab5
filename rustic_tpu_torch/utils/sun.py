"""A Sun raster decoder, as Pillow 12.1.0 reads it (PIL/SunImagePlugin.py,
its SunRleDecode.c and raw unpackers) and converts it to RGBA.

The 32-byte big-endian header: magic 0x59A66A95, width, height, depth,
length, type, colour-map type and colour-map length. Depth 1 reads "1"
(a set bit black), 4 and 8 grey ("L"; 4-bit levels times 17), 24 and 32
"RGB" (BGR and BGRX byte order, or RGB and RGBX for type 3). A colour
map (type 1, at most 1024 bytes: its reds, then greens, then blues)
turns grey into a palette image ("P"). Rows are padded to 16 bits. Type 2
is run-length coded (decoded by the host C++ loop `sun_rle`,
csrc/image_entropy.cpp, as SunRleDecode.c: 0x80 0 is a literal 0x80,
0x80 n v a run of n + 1 bytes v, which carries over into the next rows);
as in Pillow, its rows are not padded.

A header Pillow turns away (another depth, a colour map over 1024 bytes
or of another type, a file type other than 0-5) raises an error of PASSED_ON and
the file passes on; data cut short ends the decode (ValueError).
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils import _entropy
from rustic_tpu_torch.utils._entropy import ptr
from rustic_tpu_torch.utils.modes import check_pixels, to_rgba, unpack_bits

MAGIC = 0x59A66A95


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 4 and struct.unpack_from(">I", prefix)[0] == MAGIC


class Sun(NamedTuple):
    width: int
    height: int
    depth: int
    rgb_order: bool  # type 3: RGB(X), else BGR(X)
    palette: np.ndarray  # uint8 [256, 3] of a colour-mapped grey image, else None
    offset: int
    rle: bool


def open_sun(raw: bytes) -> Sun:
    """SunImageFile._open -> Sun."""
    s = raw[:32]
    if not accept(s):
        raise SyntaxError("not a Sun raster file")
    width, height, depth, _, file_type, map_type, map_length = struct.unpack_from(">7I", s, 4)
    if depth not in (1, 4, 8, 24, 32):
        raise SyntaxError(f"Sun raster of depth {depth}")
    offset, palette = 32, None
    if map_length:
        if map_length > 1024:
            raise SyntaxError("unsupported Sun colour map length")
        if map_type != 1:
            raise SyntaxError("unsupported Sun colour map type")
        offset += map_length
        if depth in (4, 8):
            entries = raw[32 : 32 + map_length]
            n = len(entries) // 3
            palette = np.zeros((256, 3), np.uint8)
            palette[:n] = np.frombuffer(entries, np.uint8, count=3 * n).reshape(3, n).T
    if file_type not in (0, 1, 2, 3, 4, 5):
        raise SyntaxError(f"unsupported Sun raster file type {file_type}")
    if width == 0 or height == 0:
        raise SyntaxError(f"Sun raster of size {width}x{height}")
    check_pixels(width, height, "Sun raster")
    return Sun(width, height, depth, file_type == 3, palette, offset, file_type == 2)


def decode_sun(raw: bytes, s: Sun = None) -> np.ndarray:
    """Sun raster bytes (or their `open_sun` header) -> uint8 [H, W, 4]."""
    raw = bytes(raw)
    s = s or open_sun(raw)
    w, h, depth = s.width, s.height, s.depth
    line = (w * depth + 7) // 8
    if s.rle:
        rows = np.empty((h, line), np.uint8)
        data = np.frombuffer(raw, np.uint8)[s.offset :]
        if _entropy.library().sun_rle(ptr(data), len(data), line, h, ptr(rows)) < 0:
            raise ValueError("Sun raster RLE data is truncated")
    else:
        stride = ((w * depth + 15) // 16) * 2
        if len(raw) < s.offset + stride * (h - 1) + line:
            raise ValueError("Sun raster image data is truncated")
        flat = np.frombuffer(raw, np.uint8, offset=s.offset)
        rows = np.lib.stride_tricks.as_strided(flat, (h, line), (stride, 1))
    if depth == 1:
        return to_rgba("1", (1 - unpack_bits(rows, 1, w)) * np.uint8(255))
    if depth in (4, 8):
        v = unpack_bits(rows, depth, w)
        if s.palette is not None:
            return to_rgba("P", v, s.palette)
        return to_rgba("L", v * np.uint8(17) if depth == 4 else v)
    px = rows[:, : w * (depth // 8)].reshape(h, w, depth // 8)[..., :3]
    return to_rgba("RGB", px if s.rgb_order else px[..., ::-1])
