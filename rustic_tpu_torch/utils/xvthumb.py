"""An XV thumbnail decoder, as Pillow 12.1.0 reads it
(PIL/XVThumbImagePlugin.py) and converts it to RGBA: the magic "P7 332",
the rest of its line, comment lines starting with "#", a line whose first
two words are the width and height, then width x height palette indices
into the fixed 3-3-2 palette (red and green in 8 steps, blue in 4).

A file that ends before the size line raises an error of PASSED_ON and
passes on, as does an empty size; a size line without two integers, or
pixels cut short, ends the decode (ValueError), as in Pillow.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils.modes import check_pixels, to_rgba

MAGIC = b"P7 332"
FORMAT = "XVThumb"  # Image.open(...).format (the plugin is registered as XVTHUMB)
# index r << 5 | g << 2 | b -> (r * 255 // 7, g * 255 // 7, b * 255 // 3)
PALETTE = np.array([(r * 255 // 7, g * 255 // 7, b * 255 // 3) for r in range(8)
                    for g in range(8) for b in range(4)], np.uint8)


class XVThumb(NamedTuple):
    width: int
    height: int
    offset: int


def _line(raw: bytes, pos: int):
    """BytesIO.readline from `pos` -> (the line with its newline, the next pos)."""
    end = raw.find(b"\n", pos)
    end = len(raw) if end < 0 else end + 1
    return raw[pos:end], end


def open_xvthumb(raw: bytes) -> XVThumb:
    """XVThumbImageFile._open -> XVThumb."""
    if not raw.startswith(MAGIC):
        raise SyntaxError("not an XV thumbnail file")
    _, pos = _line(raw, len(MAGIC))
    while True:
        s, pos = _line(raw, pos)
        if not s:
            raise SyntaxError("Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:  # not a comment
            break
    words = s.strip().split(maxsplit=2)[:2]
    if len(words) < 2:
        raise ValueError(f"XV thumbnail size line {s!r} (Pillow: not enough values to unpack)")
    width, height = int(words[0]), int(words[1])
    if width <= 0 or height <= 0:
        raise SyntaxError(f"XV thumbnail of {width}x{height} pixels (an empty size: Pillow's "
                          "ImageFile refuses it)")
    check_pixels(width, height, "XV thumbnail")
    return XVThumb(width, height, pos)


def decode_xvthumb(raw: bytes, x: XVThumb = None) -> np.ndarray:
    """XV thumbnail bytes (or their `open_xvthumb` header) -> uint8 [H, W, 4]."""
    raw = bytes(raw)
    x = x or open_xvthumb(raw)
    n = x.width * x.height
    if x.offset + n > len(raw):
        raise ValueError("XV thumbnail image data is truncated")
    idx = np.frombuffer(raw, np.uint8, count=n, offset=x.offset).reshape(x.height, x.width)
    return to_rgba("P", idx, PALETTE)
