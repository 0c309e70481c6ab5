"""Windows icon (ICO) and cursor (CUR) decoders, as Pillow 12.1.0 reads
them (PIL/IcoImagePlugin.py, PIL/CurImagePlugin.py) and converts them to
RGBA.

- ICO: Pillow sorts the directory's entries by colour depth (the entry's
  bit count, else ceil(log2) of its colour count, else 256), then, stably,
  by area, largest first, and reads the first: the largest icon, and of
  those the one of fewest bits. A payload that starts with PNG's signature
  is a PNG (utils/png.py `decode_png`); any other is a DIB (the core of
  utils/bmp_tga.py) of twice the icon's height, read to half its height,
  and masked: where the entry says 32 bits, the alpha is every fourth byte
  from the pixels on (whatever the DIB's own depth); else the AND mask (1
  bit a pixel, rows padded to 32 bits, ending where the entry's byte count
  ends) makes its set bits transparent. `Image.open` reads an ICO whole,
  so `open_ico` returns the pixels.
- CUR: of the directory's entries Pillow takes the first, and a later one
  only where it is both wider and taller (a width byte of 0 is 0); its
  bitmap is a DIB read through Pillow's BMP reader: half its height, no
  mask, and alpha only for a 32-bit bitmap that starts at byte 22.

A directory or header that Pillow turns away so that `Image.open` tries
the next plugin (no entries, a field cut short, a size of zero) raises
NotThisFormat; what ends Pillow's open (a truncated bitmap or mask, a
mask offset before the file's start) raises ValueError; the DIB variants
the core refuses raise NotImplementedError naming them.
"""

from __future__ import annotations

import math
import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils import NotThisFormat
from rustic_tpu_torch.utils.bmp_tga import dib_rgba, read_dib

ICO_SIGNATURE = b"\0\0\1\0"
CUR_SIGNATURE = b"\0\0\2\0"


class IconEntry(NamedTuple):
    width: int
    height: int
    bpp: int
    size: int
    offset: int
    color_depth: int


def ico_entries(raw: bytes) -> list:
    """IcoFile.__init__: the directory, in Pillow's order (its first entry
    is the one it reads)."""
    if raw[:4] != ICO_SIGNATURE or len(raw) < 6:
        raise NotThisFormat("not an ICO file")
    (count,) = struct.unpack_from("<H", raw, 4)
    entries = []
    for i in range(count):
        s = raw[6 + 16 * i : 22 + 16 * i]
        if len(s) < 16:
            raise NotThisFormat("ICO directory is cut short")
        width, height, nb_color = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) or 256
        entries.append(IconEntry(width, height, bpp, size, offset, depth))
    entries.sort(key=lambda e: e.color_depth)
    entries.sort(key=lambda e: e.width * e.height, reverse=True)
    if not entries:
        raise NotThisFormat("ICO has no entries")
    return entries


def _ico_dib(raw: bytes, e: IconEntry) -> np.ndarray:
    """IcoFile.frame for a DIB payload -> uint8 [H, W, 4]."""
    dib = read_dib(raw, e.offset, what="ICO bitmap")
    if dib.width <= 0 or dib.height <= 0:
        raise NotThisFormat(f"ICO bitmap of size {dib.width}x{dib.height}")
    w, h = dib.width, dib.height // 2
    out = dib_rgba(raw, dib, h)
    if e.bpp == 32:  # the fourth byte of each pixel from the rows on, bottom-up
        alpha = np.frombuffer(raw[dib.offset : dib.offset + w * h * 4][3::4], np.uint8)
        if len(alpha) < w * h:
            raise ValueError("ICO alpha is truncated")
        out[..., 3] = alpha[: w * h].reshape(h, w)[::-1]
        return out
    stride = -(-w // 32) * 4  # the AND mask's rows, 1 bit a pixel, padded to 32 bits
    start = e.offset + e.size - stride * h
    if start < 0:
        raise ValueError(f"ICO mask offset {start} is before the file's start")
    need = stride * (h - 1) + (w + 7) // 8 if h else 0
    if len(raw) - start < need:
        raise ValueError("ICO AND mask is truncated")
    data = np.zeros(stride * h, np.uint8)
    data[:need] = np.frombuffer(raw, np.uint8, count=need, offset=start)
    bits = np.unpackbits(data.reshape(h, stride), axis=1)[::-1, :w]
    out[..., 3] = np.where(bits != 0, 0, 255)
    return out


def open_ico(raw: bytes) -> np.ndarray:
    """IcoImageFile._open, which loads the image -> uint8 [H, W, 4], as
    Pillow's convert("RGBA")."""
    from rustic_tpu_torch.utils.png import PNG_SIGNATURE, decode_png

    e = ico_entries(raw)[0]
    if raw[e.offset : e.offset + 8] == PNG_SIGNATURE:
        return decode_png(raw[e.offset :])
    return _ico_dib(raw, e)


def open_cur(raw: bytes):
    """CurImageFile._open -> (the bitmap's Dib, the rows Pillow reads)."""
    if raw[:4] != CUR_SIGNATURE or len(raw) < 6:
        raise NotThisFormat("not a CUR file")
    (count,) = struct.unpack_from("<H", raw, 4)
    m = b""
    for i in range(count):
        s = raw[6 + 16 * i : 22 + 16 * i]
        if not m:
            m = s
        elif not s or s[0] > m[0] and (len(s) < 2 or len(m) < 2):  # Pillow: IndexError
            raise NotThisFormat("CUR directory is cut short")
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise NotThisFormat("no cursors were found")
    if len(m) < 16:
        raise NotThisFormat("CUR directory entry is cut short")
    (start,) = struct.unpack_from("<I", m, 12)
    # Pillow seeks to the bitmap unless its offset is 0: then it reads on from the directory
    pos = start or min(len(raw), 6 + 16 * count)
    dib = read_dib(raw, pos, what="CUR bitmap", cur_start=start)
    rows = dib.height // 2
    if dib.width <= 0 or rows <= 0:
        raise NotThisFormat(f"CUR bitmap of size {dib.width}x{rows}")
    return dib, rows
