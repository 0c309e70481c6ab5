"""A PIXAR raster decoder, as Pillow 12.1.0 reads it
(PIL/PixarImagePlugin.py) and converts it to RGBA: the 512-byte header
(little-endian words: height at 416, width at 418, and the kind at 424
and 426, which must be 14 and 2 for Pillow's only mode, "RGB"), then
pixel-interleaved RGB bytes from byte 1024.

A header cut short, or of another kind (Pillow leaves the mode unset),
raises an error of PASSED_ON and the file passes on; pixels cut short end the
decode (ValueError).
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils.modes import check_pixels, to_rgba

MAGIC = b"\200\350\000\000"
OFFSET = 1024


class Pixar(NamedTuple):
    width: int
    height: int


def open_pixar(raw: bytes) -> Pixar:
    """PixarImageFile._open -> Pixar."""
    if not raw.startswith(MAGIC):
        raise SyntaxError("not a PIXAR file")
    s = raw[:512]
    height, width, _, _, a, b = struct.unpack_from("<6H", s, 416)
    if (a, b) != (14, 2) or width == 0 or height == 0:
        raise SyntaxError(f"PIXAR of kind {(a, b)} and size {width}x{height}")
    check_pixels(width, height, "PIXAR")
    return Pixar(width, height)


def decode_pixar(raw: bytes, p: Pixar = None) -> np.ndarray:
    """PIXAR bytes (or their `open_pixar` header) -> uint8 [H, W, 4]."""
    raw = bytes(raw)
    p = p or open_pixar(raw)
    n = p.width * p.height * 3
    if len(raw) < OFFSET + n:
        raise ValueError("PIXAR image data is truncated")
    return to_rgba("RGB", np.frombuffer(raw, np.uint8, count=n, offset=OFFSET).reshape(
        p.height, p.width, 3))
