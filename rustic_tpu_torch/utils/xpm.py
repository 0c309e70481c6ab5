"""An X11 pixmap (XPM) decoder, as Pillow 12.1.0 reads it
(PIL/XpmImagePlugin.py) and converts it to RGBA.

After "/* XPM */", the first line that starts '"w h colours chars' gives
the size, the palette length and the key length; each of the next
palette lines is '"<key> ... c <colour>' (the first "c" pair counts):
"#rrggbb" (an integer in hex, of which the low 24 bits are taken) or
"None". The palette length of the size line, not the count of colours,
picks the mode: up to 256 the image is "P", its palette the colours in
the order their keys first came (a "None" key is left out of it); above
256 it is "RGB". The pixel lines that follow (a "/* pixels */" line
skipped once) are the text between each line's first and last quote, cut
into keys of the key length; lines are read until the image has its
pixels, and their keys run on from line to line whatever the width.

As in Pillow, "None" sets the image's transparency to the key's bytes,
which convert("RGBA") of a "P" image reads as the alphas of palette
entries 0, 1, ... (the byte values of the key), and a pixel whose key is
"None" or not in the palette ends the decode (ValueError). An "RGB"
image with a "None" colour is refused by name: Pillow's convert("RGBA")
passes the key's bytes to its colour-key conversion, which raises
TypeError whatever the key's length.

A file without a size line raises an error of PASSED_ON and passes on; a palette
line without "c", a number that is not one, or too few pixels end the
decode (ValueError); a colour that is neither "#..." nor "None" (a name,
which Pillow refuses) raises NotImplementedError naming it.
"""

from __future__ import annotations

import io
import re
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO
from rustic_tpu_torch.utils.modes import check_pixels, to_rgba

HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')
MAGIC = b"/* XPM */"


class Xpm(NamedTuple):
    width: int
    height: int
    bpp: int
    palette_length: int  # the size line's: above 256 the image is "RGB"
    keys: list  # the palette's keys, in order
    colours: np.ndarray  # uint8 [len(keys), 3]
    transparency: bytes  # the "None" key, else None
    offset: int


def open_xpm(raw: bytes) -> Xpm:
    """XpmImageFile._open -> Xpm."""
    if not raw.startswith(MAGIC):
        raise SyntaxError("not an XPM file")
    fp = io.BytesIO(raw)
    fp.seek(len(MAGIC))
    while True:
        line = fp.readline()
        if not line:
            raise SyntaxError("broken XPM file: no size line")
        m = HEAD.match(line)
        if m:
            break
    try:
        width, height, palette_length, bpp = (int(g) for g in m.groups())
    except ValueError as e:
        raise ValueError(f"XPM size line {line[:40]!r}: {e}") from e
    palette, transparency = {}, None
    for _ in range(palette_length):
        line = fp.readline().rstrip()
        c = line[1 : bpp + 1]
        s = line[bpp + 1 : -2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                if i + 1 >= len(s):
                    raise SyntaxError("XPM colour line ends at its 'c'")
                rgb = s[i + 1]
                if rgb == b"None":
                    transparency = c
                elif rgb.startswith(b"#"):
                    try:
                        v = int(rgb[1:], 16)
                    except ValueError as e:
                        raise ValueError(f"XPM colour {rgb!r}") from e
                    palette[c] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                else:
                    raise NotImplementedError(f"XPM colour {rgb.decode('latin-1')!r} (Pillow reads "
                                              f"only '#...' and 'None') is not decoded "
                                              f"({FORMATS_TODO})")
                break
        else:
            raise ValueError(f"cannot read this XPM file: palette line {line[:40]!r}")
    if width == 0 or height == 0:
        raise SyntaxError(f"XPM of size {width}x{height}")
    check_pixels(width, height, "XPM")
    colours = np.array(list(palette.values()), np.uint8).reshape(-1, 3)
    return Xpm(width, height, bpp, palette_length, list(palette), colours, transparency, fp.tell())


def _indices(text: bytes, bpp: int, lut: dict) -> np.ndarray:
    """One pixel line's keys (the last one shorter where the line's length
    is not a whole number of keys) -> their palette indices; a key not in
    `lut` raises ValueError."""
    whole = len(text) // bpp
    keys, inverse = np.unique(np.frombuffer(text, f"V{bpp}", count=whole), return_inverse=True)
    tail = [text[whole * bpp :]] if len(text) % bpp else []
    try:
        found = np.array([lut[bytes(k)] for k in keys] + [lut[k] for k in tail], np.int64)
    except KeyError as e:
        raise ValueError("XPM pixel key not in the palette") from e
    return np.concatenate([found[inverse.reshape(-1)], found[len(keys) :]])


def _pixel_lines(raw: bytes, x: Xpm):
    """XpmDecoder's lines: the text between each line's first and last
    quote, a "/* pixels */" line skipped once."""
    header_seen = False
    for line in raw[x.offset :].split(b"\n"):
        if line.rstrip() == b"/* pixels */" and not header_seen:
            header_seen = True
            continue
        yield b'"'.join(line.split(b'"')[1:-1])


def decode_xpm(raw: bytes, x: Xpm = None) -> np.ndarray:
    """XPM bytes (or their `open_xpm` header) -> uint8 [H, W, 4]."""
    raw = bytes(raw)
    x = x or open_xpm(raw)
    n, bpp = x.width * x.height, x.bpp
    if bpp <= 0:
        raise ValueError(f"XPM keys of {bpp} bytes (Pillow: range() arg 3 must not be zero)")
    if x.palette_length > 256 and x.transparency is not None:
        raise NotImplementedError(f"XPM of {x.palette_length} colours (RGB) with a 'None' colour "
                                  f"(Pillow's convert raises TypeError on its key) is not decoded "
                                  f"({FORMATS_TODO})")
    if not x.keys:
        raise ValueError("XPM has no colours: a pixel key is not in the palette")
    lut = {k: i for i, k in enumerate(x.keys)}
    indices, got = [], 0
    for text in _pixel_lines(raw, x):
        if got >= n:
            break
        if not text:
            continue
        indices.append(_indices(text, bpp, lut))
        got += len(indices[-1])
    if got < n:
        raise ValueError("XPM image data: not enough image data")
    idx = np.concatenate(indices)[:n].reshape(x.height, x.width)
    if x.palette_length > 256:
        return to_rgba("RGB", x.colours[idx])
    palette = np.zeros((256, 3), np.uint8)
    palette[: len(x.colours)] = x.colours
    return to_rgba("P", idx.astype(np.uint8), palette, x.transparency)
