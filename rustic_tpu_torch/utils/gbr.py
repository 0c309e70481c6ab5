"""A GIMP brush (GBR) decoder, as Pillow 12.1.0 reads it
(PIL/GbrImagePlugin.py) and converts it to RGBA.

The header (big-endian 32-bit words): its size (at least 20), the
version (1 or 2), width, height and bytes a pixel (1: "L", 4: "RGBA");
version 2 adds the magic "GIMP" and the spacing. The comment fills the
header to its size; the pixels follow.

Pillow's test is weak (a first word of 20 or more and a second of 1 or
2): a header it then turns away (a size of 0, other bytes a pixel, no
"GIMP" in version 2, a file cut short in the header) raises an error of PASSED_ON
and the file passes on; pixels cut short end the decode (ValueError).
"""

from __future__ import annotations

import io
import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils.modes import check_pixels, to_rgba


def accept(prefix: bytes) -> bool:
    return (len(prefix) >= 8 and struct.unpack_from(">I", prefix)[0] >= 20
            and struct.unpack_from(">I", prefix, 4)[0] in (1, 2))


class Gbr(NamedTuple):
    width: int
    height: int
    depth: int  # bytes a pixel: 1 or 4
    offset: int


def open_gbr(raw: bytes) -> Gbr:
    """GbrImageFile._open -> Gbr."""
    fp = io.BytesIO(raw)

    def i32():
        return struct.unpack(">I", fp.read(4))[0]

    header_size = i32()
    if header_size < 20:
        raise SyntaxError("not a GIMP brush")
    version = i32()
    if version not in (1, 2):
        raise SyntaxError(f"unsupported GIMP brush version: {version}")
    width, height, depth = i32(), i32(), i32()
    if width == 0 or height == 0:
        raise SyntaxError("not a GIMP brush")
    if depth not in (1, 4):
        raise SyntaxError(f"unsupported GIMP brush colour depth: {depth}")
    if version == 1:
        comment_length = header_size - 20
    else:
        comment_length = header_size - 28
        if fp.read(4) != b"GIMP":
            raise SyntaxError("not a GIMP brush, bad magic number")
        i32()  # the spacing
    fp.read(comment_length)  # a negative length reads the rest, as in Pillow
    check_pixels(width, height, "GBR")
    return Gbr(width, height, depth, fp.tell())


def decode_gbr(raw: bytes, g: Gbr = None) -> np.ndarray:
    """GBR bytes (or their `open_gbr` header) -> uint8 [H, W, 4]."""
    raw = bytes(raw)
    g = g or open_gbr(raw)
    n = g.width * g.height * g.depth
    if len(raw) < g.offset + n:
        raise ValueError("GBR image data: not enough image data")
    px = np.frombuffer(raw, np.uint8, count=n, offset=g.offset).reshape(g.height, g.width, -1)
    return to_rgba("L" if g.depth == 1 else "RGBA", px[..., 0] if g.depth == 1 else px)
