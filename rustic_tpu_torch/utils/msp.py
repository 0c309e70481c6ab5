"""A Windows Paint (MSP) decoder, as Pillow 12.1.0 reads it
(PIL/MspImagePlugin.py) and converts it to RGBA.

The 32-byte header ("DanM" version 1, "LinS" version 2) holds the size
at bytes 4 and 6; its sixteen little-endian words must XOR to 0. Version
1 is raw 1-bit rows (most significant bit first, a set bit white, rows
padded to bytes) from byte 32. Version 2 has a row map (a 16-bit length
for each row) and RLE rows, decoded by the host C++ loop `msp_rows`
(csrc/image_entropy.cpp) as Pillow's Python MspDecoder does: a run (0,
count, value) or a literal (count, bytes); a row of length 0 is white.
The rows are joined as they come and read as the 1-bit image, so a row
that decodes to more or fewer bytes than the stride shifts the rest, as
in Pillow.

A header cut short or with a bad checksum (or a size of 0) raises
an error of PASSED_ON and the file passes on; a row map or row cut short, a run
without its count and value, or too few bytes for the image end the
decode (ValueError).
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils import _entropy
from rustic_tpu_torch.utils._entropy import ptr
from rustic_tpu_torch.utils.modes import check_pixels, to_rgba, unpack_bits


def accept(prefix: bytes) -> bool:
    return prefix.startswith((b"DanM", b"LinS"))


class Msp(NamedTuple):
    version: int
    width: int
    height: int


def open_msp(raw: bytes) -> Msp:
    """MspImageFile._open -> Msp."""
    s = raw[:32]
    if not accept(s):
        raise SyntaxError("not an MSP file")
    words = struct.unpack("<16H", s)
    if np.bitwise_xor.reduce(np.array(words)) != 0:
        raise SyntaxError("bad MSP checksum")
    width, height = words[2], words[3]
    if width == 0 or height == 0:
        raise SyntaxError(f"MSP of size {width}x{height}")
    check_pixels(width, height, "MSP")
    return Msp(1 if s.startswith(b"DanM") else 2, width, height)


def decode_msp(raw: bytes, m: Msp = None) -> np.ndarray:
    """MSP bytes (or their `open_msp` header) -> uint8 [H, W, 4]."""
    raw = bytes(raw)
    m = m or open_msp(raw)
    stride = (m.width + 7) // 8
    need = stride * m.height
    if m.version == 1:
        if len(raw) < 32 + need:
            raise ValueError("MSP image data is truncated")
        rows = np.frombuffer(raw, np.uint8, count=need, offset=32)
    else:
        if len(raw) < 32 + 2 * m.height:
            raise ValueError("truncated MSP file in row map")
        rowlen = np.frombuffer(raw, "<u2", count=m.height, offset=32).astype(np.uint16)
        data = np.frombuffer(raw, np.uint8)
        rows = np.zeros(need, np.uint8)
        made = _entropy.library().msp_rows(ptr(data), len(raw), 32 + 2 * m.height, ptr(rowlen),
                                           m.height, stride, ptr(rows), need)
        if made == -1:
            raise ValueError("truncated MSP file: a row is cut short")
        if made == -2:
            raise ValueError("corrupted MSP file: a run lacks its count or value")
        if made < need:
            raise ValueError("MSP image data: not enough image data")
    bits = unpack_bits(rows.reshape(m.height, stride), 1, m.width)
    return to_rgba("1", bits * np.uint8(255))
