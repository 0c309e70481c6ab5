"""A McIdas area file decoder, as Pillow 12.1.0 reads it
(PIL/McIdasImagePlugin.py) and converts it to RGBA: a 256-byte directory
of 64 big-endian 32-bit words w[1]..w[64] (the file starts with the words
0 and 4); w[11] bytes a pixel, 1 ("L"), 2 ("I;16B", clipped to 255) or 4
("I" from big-endian signed words, clipped to 0..255); w[10] x w[9]
pixels; the rows from byte w[34] + w[15], each w[15] + w[10] * w[11] *
w[14] bytes apart (Pillow's stride; 0 means the rows touch), the pixels
at the start of each.

A directory cut short, another w[11] or an empty size raises an error of
PASSED_ON and the file passes on; a stride shorter than a row, a negative
offset or rows cut short end the decode (ValueError), as Pillow's raw
decoder and its seek refuse them.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils.modes import check_pixels, to_rgba

MAGIC = b"\x00\x00\x00\x00\x00\x00\x00\x04"
_MODES = {1: ("L", np.uint8), 2: ("I;16B", ">u2"), 4: ("I", ">i4")}  # w[11] -> mode, sample type


class McIdas(NamedTuple):
    width: int
    height: int
    depth: int  # bytes a pixel
    offset: int
    stride: int


def open_mcidas(raw: bytes) -> McIdas:
    """McIdasImageFile._open -> McIdas."""
    s = raw[:256]
    if not s.startswith(MAGIC) or len(s) != 256:
        raise SyntaxError("not an McIdas area file")
    w = (0, *struct.unpack(">64i", s))
    if w[11] not in _MODES:
        raise SyntaxError("unsupported McIdas format")
    if w[10] <= 0 or w[9] <= 0:
        raise SyntaxError(f"McIdas area of {w[10]}x{w[9]} pixels (an empty size: Pillow's "
                          "ImageFile refuses it)")
    check_pixels(w[10], w[9], "McIdas area")
    return McIdas(w[10], w[9], w[11], w[34] + w[15], w[15] + w[10] * w[11] * w[14])


def decode_mcidas(raw: bytes, m: McIdas = None) -> np.ndarray:
    """McIdas area bytes (or their `open_mcidas` header) -> uint8 [H, W, 4]."""
    raw = bytes(raw)
    m = m or open_mcidas(raw)
    row = m.width * m.depth
    step = m.stride or row
    if m.stride and m.stride < row:
        raise ValueError(f"McIdas stride {m.stride} is shorter than a row of {row} bytes "
                         "(Pillow's raw decoder: bad configuration)")
    if m.offset < 0:
        raise ValueError(f"McIdas data at {m.offset} (Pillow: negative seek value)")
    if m.offset + (m.height - 1) * step + row > len(raw):
        raise ValueError("McIdas image data is truncated")
    buf = np.frombuffer(raw, np.uint8)[m.offset :]
    rows = np.lib.stride_tricks.as_strided(buf, (m.height, row), (step, 1))
    mode, kind = _MODES[m.depth]
    return to_rgba(mode, np.ascontiguousarray(rows).view(kind).reshape(m.height, m.width))
