"""An X11 bitmap (XBM) decoder, as Pillow 12.1.0 reads it
(PIL/XbmImagePlugin.py, its XbmDecode.c) and converts it to RGBA.

The header, matched in the first 512 bytes by Pillow's pattern: the
width and height #defines, an optional hotspot pair, and anything up to
"_bits[]". After it, each "x" and the two bytes that follow it are one
byte of the image (a byte that is not a hex digit counts 0); scanning
resumes after those two bytes. Rows are (width + 7) // 8 bytes, their
least significant bit first, a set bit white.

A file whose first 512 bytes do not match raises an error of PASSED_ON and
passes on; too few bytes for the image end the decode (ValueError).
"""

from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils.modes import check_pixels, to_rgba

HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
# a hex digit's value, 0 for any other byte
_HEX = np.zeros(256, np.uint8)
for _c in b"0123456789abcdef":
    _HEX[_c] = int(chr(_c), 16)
    _HEX[ord(chr(_c).upper())] = int(chr(_c), 16)


def accept(prefix: bytes) -> bool:
    return prefix.lstrip().startswith(b"#define")


class Xbm(NamedTuple):
    width: int
    height: int
    offset: int


def open_xbm(raw: bytes) -> Xbm:
    """XbmImageFile._open -> Xbm."""
    m = HEAD.match(raw[:512])
    if not m:
        raise SyntaxError("not an XBM file")
    width, height = int(m.group("width")), int(m.group("height"))
    if width == 0 or height == 0:
        raise SyntaxError(f"XBM of size {width}x{height}")
    check_pixels(width, height, "XBM")
    return Xbm(width, height, m.end())


def _taken(xs: np.ndarray) -> np.ndarray:
    """The "x" positions the decoder reads: each one at least 3 bytes
    after the last one read."""
    if len(xs) < 2 or (np.diff(xs) >= 3).all():
        return xs
    keep, last = [], -3
    for x in xs.tolist():
        if x >= last + 3:
            keep.append(x)
            last = x
    return np.array(keep, np.int64)


def decode_xbm(raw: bytes, x: Xbm = None) -> np.ndarray:
    """XBM bytes (or their `open_xbm` header) -> uint8 [H, W, 4]."""
    raw = bytes(raw)
    x = x or open_xbm(raw)
    stride = (x.width + 7) // 8
    need = stride * x.height
    data = np.frombuffer(raw, np.uint8)[x.offset :]
    xs = _taken(np.flatnonzero(data == ord("x")))
    xs = xs[xs + 2 < len(data)][:need]  # an "x" needs its two bytes
    if len(xs) < need:
        raise ValueError("XBM image data is truncated")
    rows = ((_HEX[data[xs + 1]] << 4) | _HEX[data[xs + 2]]).reshape(x.height, stride)
    bits = (rows[:, :, None] >> np.arange(8, dtype=np.uint8)) & 1  # least significant first
    return to_rgba("1", bits.reshape(x.height, -1)[:, : x.width] * np.uint8(255))
