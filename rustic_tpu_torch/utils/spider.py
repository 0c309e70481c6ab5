"""A SPIDER 2D image decoder, as Pillow 12.1.0 reads it
(PIL/SpiderImagePlugin.py) and converts it to RGBA.

SPIDER has no test of the first bytes: `Image.open` runs its header
reader on every file that reaches it in its order (after SGI), and
utils/png.py does the same. The header is 27 float32s, big-endian tried
first: words 1, 2, 5, 12, 13, 22 and 23 must be whole numbers, the form
(5) one of 1, 3, -11, -12, -21, -22, and the header bytes (22) the
records (13) times the record length (23). A 2D image (form 1) of
word 12 x word 2 float32 samples in the header's byte order follows the
header; a stack (word 24 > 0) holds its first image after a second
header. Mode "F" converts to RGBA as Pillow's convert does: each sample
clipped to 0..255 and cut toward zero.

A header that is not SPIDER's (or not a 2D image, or of an inconsistent
stack) raises an error of PASSED_ON and the file passes on; a stack word that is
not a number, or an image number without a stack (Pillow's reader then
fails), ends the decode; data cut short raises ValueError.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils.modes import check_pixels, to_rgba

_FORMS = (1, 3, -11, -12, -21, -22)


class Spider(NamedTuple):
    width: int
    height: int
    offset: int
    dtype: str  # ">f4" or "<f4"


def _is_int(f: float) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def _header_bytes(t: tuple) -> int:
    """isSpiderHeader: the header's length, 0 where it is not SPIDER's."""
    h = (99,) + t
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in _FORMS:
        return 0
    labbyt = int(h[22])
    return 0 if labbyt != int(h[13]) * int(h[23]) else labbyt


def open_spider(raw: bytes) -> Spider:
    """SpiderImageFile._open -> Spider."""
    f = raw[:108]
    try:
        order, t = ">f4", struct.unpack(">27f", f)
        hdrlen = _header_bytes(t)
        if hdrlen == 0:
            order, t = "<f4", struct.unpack("<27f", f)
            hdrlen = _header_bytes(t)
        if hdrlen == 0:
            raise SyntaxError("not a valid Spider file")
    except struct.error as e:
        raise SyntaxError("not a valid Spider file") from e
    h = (99,) + t
    if int(h[5]) != 1:
        raise SyntaxError("not a Spider 2D image")
    width, height = int(h[12]), int(h[2])
    try:  # words Pillow reads without a check: ValueError or OverflowError end the open
        istack, imgnumber = int(h[24]), int(h[27])
        if istack > 0 and imgnumber == 0:
            int(h[26])  # the stack's image count
    except (ValueError, OverflowError) as e:
        raise ValueError(f"SPIDER stack words: {e}") from e
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = hdrlen * 2
    elif istack == 0 and imgnumber > 0:
        raise ValueError("SPIDER image of a stack, without its stack header (Pillow's reader "
                         "fails on it: no stack offset)")
    else:
        raise SyntaxError("inconsistent stack header values")
    if width <= 0 or height <= 0:
        raise SyntaxError(f"SPIDER of size {width}x{height}")
    check_pixels(width, height, "SPIDER")
    return Spider(width, height, offset, order)


def decode_spider(raw: bytes, s: Spider = None) -> np.ndarray:
    """SPIDER bytes (or their `open_spider` header) -> uint8 [H, W, 4]."""
    raw = bytes(raw)
    s = s or open_spider(raw)
    n = s.width * s.height
    if s.offset < 0 or len(raw) < s.offset + 4 * n:
        raise ValueError("SPIDER image data is truncated")
    px = np.frombuffer(raw, s.dtype, count=n, offset=s.offset).reshape(s.height, s.width)
    return to_rgba("F", px.astype(np.float32))
