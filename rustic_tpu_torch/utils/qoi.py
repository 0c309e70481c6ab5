"""A QOI ("Quite OK Image") decoder, as Pillow 12.1.0 reads it
(PIL/QoiImagePlugin.py) and converts it to RGBA.

The header gives the width and height (big-endian) and the channel
count: 3 is RGB, anything else RGBA; the colour-space byte is not read.
The op loop (INDEX, DIFF, LUMA, RUN, RGB, RGBA) is serial, and runs in
host C++ (csrc/image_entropy.cpp `qoi_pixels`, built by g++ at first use)
as Pillow's QoiDecoder runs it: the previous pixel starts as (0, 0, 0,
255), the table of seen pixels starts empty (an INDEX of an empty slot
reads (0, 0, 0, 0); a RUN does not enter the pixel it repeats); the end
marker is not read. A header cut short or a size of zero raises
NotThisFormat (Pillow passes the file on); ops that run past the end of
the file, or a size over Pillow's decompression-bomb limit (which runs
let a small file claim), ValueError.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils import NotThisFormat, _entropy
from rustic_tpu_torch.utils._entropy import ptr
from rustic_tpu_torch.utils.modes import check_pixels, to_rgba

QOI_SIGNATURE = b"qoif"
HEADER = 14


class Qoi(NamedTuple):
    width: int
    height: int
    bands: int  # 3 (RGB) or 4 (RGBA)


def open_qoi(raw: bytes) -> Qoi:
    """QoiImageFile._open -> Qoi."""
    if raw[:4] != QOI_SIGNATURE:
        raise NotThisFormat("not a QOI file")
    if len(raw) < 13:
        raise NotThisFormat("QOI header is cut short")
    width, height, channels = struct.unpack_from(">IIB", raw, 4)
    if width == 0 or height == 0:
        raise NotThisFormat(f"QOI of size {width}x{height}")
    check_pixels(width, height, "QOI")
    return Qoi(width, height, 3 if channels == 3 else 4)


def decode_qoi(raw: bytes, q: Qoi = None) -> np.ndarray:
    """QOI bytes (or their `open_qoi` header) -> uint8 [H, W, 4], as
    Pillow's convert("RGBA")."""
    raw = bytes(raw)
    q = q or open_qoi(raw)
    n = q.width * q.height
    out = np.empty((q.height, q.width, q.bands), np.uint8)
    src = np.frombuffer(raw, np.uint8)
    if _entropy.library().qoi_pixels(ptr(src), len(raw), HEADER, n, q.bands, ptr(out)) < 0:
        raise ValueError("QOI data ends before the image does")
    return to_rgba("RGB" if q.bands == 3 else "RGBA", out)
