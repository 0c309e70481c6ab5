"""An FTEX (Independence War 2 texture) decoder, as Pillow 12.1.0 reads
it (PIL/FtexImagePlugin.py) and converts it to RGBA.

The header: "FTEX", a version, the size and the mipmap and format counts
(int32s); one format entry (its kind and where its mipmap starts); at
that offset mipmap 0's length and bytes. Format 0 is DXT1, decoded by
Pillow's C "bcn" decoder, the one its DDS plugin uses: utils/dds.py's
BC1 reads it (alpha 0 where a three-colour block's index is 3). Format 1
is raw RGB.

A header cut short or a size that is not positive raises an error of PASSED_ON
(the file passes on); a format count other than one (Pillow's assert)
or a mipmap cut short ends the decode (ValueError), and a format other
than 0 and 1, which Pillow refuses, raises NotImplementedError naming it.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO
from rustic_tpu_torch.utils.dds import _surface
from rustic_tpu_torch.utils.modes import check_pixels, to_rgba

MAGIC = b"FTEX"


class Ftex(NamedTuple):
    width: int
    height: int
    format: int  # 0 DXT1, 1 raw RGB
    data: bytes  # mipmap 0, as far as the file holds it


def open_ftex(raw: bytes) -> Ftex:
    """FtexImageFile._open -> Ftex."""
    if not raw.startswith(MAGIC):
        raise SyntaxError("not an FTEX file")
    width, height, _mipmaps, formats = struct.unpack_from("<4i", raw, 8)
    if formats != 1:
        raise ValueError(f"FTEX of {formats} formats (Pillow asserts one)")
    fmt, where = struct.unpack_from("<2i", raw, 24)
    if where < 0:
        raise ValueError(f"FTEX mipmap at a negative offset {where}")
    (size,) = struct.unpack("<i", raw[where : where + 4])
    data = raw[where + 4 :] if size < 0 else raw[where + 4 : where + 4 + size]
    if fmt not in (0, 1):
        raise NotImplementedError(f"FTEX texture format {fmt}, which Pillow refuses, is not "
                                  f"decoded ({FORMATS_TODO})")
    if width <= 0 or height <= 0:
        raise SyntaxError(f"FTEX of size {width}x{height}")
    check_pixels(width, height, "FTEX")
    return Ftex(width, height, fmt, data)


def decode_ftex(raw: bytes, f: Ftex = None) -> np.ndarray:
    """FTEX bytes (or their `open_ftex` header) -> uint8 [H, W, 4]."""
    f = f or open_ftex(bytes(raw))
    if f.format == 0:
        need = ((f.width + 3) // 4) * ((f.height + 3) // 4) * 8
        if len(f.data) < need:
            raise ValueError("FTEX DXT1 mipmap is truncated")
        return _surface("BC1", f.data, 0, f.width, f.height)
    need = f.width * f.height * 3
    if len(f.data) < need:
        raise ValueError("FTEX RGB mipmap is truncated")
    return to_rgba("RGB", np.frombuffer(f.data, np.uint8, count=need).reshape(
        f.height, f.width, 3))
