"""An Autodesk FLI / FLC animation decoder: the first frame, as Pillow
12.1.0 shows it (PIL/FliImagePlugin.py, its FliDecode.c) and converts it
to RGBA.

The 128-byte header (magic 0xAF11 FLI or 0xAF12 FLC, flags 0 or 3, and
the zero fields Pillow checks) gives the size. The palette starts as a
grey ramp; the first COLOR256 (4) or COLOR (11, its levels shifted left by 2
and cut to a byte) chunk of the first frame (after a prefix chunk 0xF100, where
the file has one) sets its entries: packets of a skip and a count (0:
256) of RGB triples. The frame at byte 128 is drawn onto a zero image by
the host C++ loop `fli_frame` (csrc/image_entropy.cpp), FliDecode.c's
rules: BRUN byte runs, LC byte deltas, SS2 word deltas, BLACK and COPY;
COLOR and PSTAMP chunks are skipped. As in Pillow, the first frame is
read from byte 128 even where a prefix chunk stands there (and then
fails as a chunk that is not a frame).

A header Pillow turns away (its zero fields, a palette packet past 256
entries, a file cut short in the header) raises
an error of PASSED_ON and the file passes on; a frame cut short, an unknown
chunk or one that overruns ends the decode (ValueError).
"""

from __future__ import annotations

import io
import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils import _entropy
from rustic_tpu_torch.utils._entropy import ptr
from rustic_tpu_torch.utils.modes import check_pixels, to_rgba

_ERRORS = {1: "the file ends inside the frame", 2: "a chunk overruns its data or the image",
           3: "a chunk that is not a frame or of an unknown type", 4: "a chunk of size 0"}


def _i16(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<H", b, o)[0]


def _i32(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<I", b, o)[0]


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 16 and _i16(prefix, 4) in (0xAF11, 0xAF12) and _i16(prefix, 14) in (0, 3)


class Fli(NamedTuple):
    width: int
    height: int
    palette: np.ndarray  # uint8 [256, 3]
    framesize: int


def _palette(fp, palette: list, shift: int):
    i = 0
    for _ in range(_i16(fp.read(2))):
        s = fp.read(2)
        i = i + s[0]
        n = s[1] or 256
        s = fp.read(n * 3)
        for k in range(0, len(s), 3):
            palette[i] = (s[k] << shift, s[k + 1] << shift, s[k + 2] << shift)
            i += 1


def open_fli(raw: bytes) -> Fli:
    """FliImageFile._open -> Fli."""
    fp = io.BytesIO(raw)
    s = fp.read(128)
    if not (accept(s) and s[20:22] == b"\0" * 2 and s[42:80] == b"\0" * 38
            and s[88:] == b"\0" * 40):
        raise SyntaxError("not an FLI/FLC file")
    width, height = _i16(s, 8), _i16(s, 10)
    palette = [(a, a, a) for a in range(256)]
    s = fp.read(16)
    if _i16(s, 4) == 0xF100:
        fp.seek(128 + _i32(s))
        s = fp.read(16)
    if _i16(s, 4) == 0xF1FA:
        chunk_size = None
        for _ in range(_i16(s, 6)):
            if chunk_size is not None:
                fp.seek(chunk_size - 6, io.SEEK_CUR)
            s = fp.read(6)
            kind = _i16(s, 4)
            if kind in (4, 11):
                _palette(fp, palette, 2 if kind == 11 else 0)
                break
            chunk_size = _i32(s)
            if not chunk_size:
                break
    pal = np.array(palette, np.int64) & 255  # Pillow's o8 keeps the low byte
    s = raw[128:132]
    if not s:
        raise EOFError("missing frame size")
    framesize = _i32(s)
    if width <= 0 or height <= 0:
        raise SyntaxError(f"FLI of size {width}x{height}")
    check_pixels(width, height, "FLI")
    return Fli(width, height, pal.astype(np.uint8), framesize)


def decode_fli(raw: bytes, f: Fli = None) -> np.ndarray:
    """FLI / FLC bytes (or their `open_fli` header) -> uint8 [H, W, 4]: the
    first frame."""
    raw = bytes(raw)
    f = f or open_fli(raw)
    frame = np.frombuffer(raw[128 : 128 + f.framesize], np.uint8)
    im = np.zeros((f.height, f.width), np.uint8)
    status = _entropy.library().fli_frame(ptr(frame), len(frame), f.width, f.height, ptr(im))
    if status:
        raise ValueError(f"FLI first frame: {_ERRORS[status]}")
    return to_rgba("P", im, f.palette)
