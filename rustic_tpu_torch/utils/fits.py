"""A FITS decoder, as Pillow 12.1.0 reads it (PIL/FitsImagePlugin.py) and
converts it to RGBA, quirks included.

The header is 80-byte cards ("KEYWORD = value / comment"), the first
SIMPLE = T; an END card ends a header unit, padded to 2880 bytes. The
first unit with a size (NAXIS 1: 1 x NAXIS1; NAXIS 2 and up: NAXIS1 x
NAXIS2) gives the image: BITPIX 8 reads "L", 16 "I;16", 32 "I", -32
and -64 "F". As in Pillow, and so in the JAX package:
- the samples are read in the machine's little-endian order (a FITS
  file's are big-endian): a 16-bit sample 0x0001 reads as 256;
- BITPIX -64 reads 4-byte floats (the first half of the data's bytes);
- rows are read bottom-up;
- the data starts 80 bytes before where the reader stands after the card
  that follows END: on a data unit shorter than 80 bytes, inside the
  header's padding.
A binary table with ZIMAGE = T and ZCMPTYPE 'GZIP_1' holds the image
(ZNAXIS1 x ZNAXIS2, ZBITPIX) as one gzip stream after the table: each
sample is 4 bytes of which the last 1, 2 or 4 (for 8, 16 or 32 bits) are
read, rows bottom-up; a negative ZBITPIX reads no bytes, and fails as in
Pillow ("not enough image data").

A file whose first card is not SIMPLE = T, or a header that lacks a key
Pillow reads, raises an error of PASSED_ON and passes on; a header with no image
("No image data"), a file that ends in its header, a value that is not a
number, or data cut short ends the decode (ValueError).
"""

from __future__ import annotations

import gzip
import io
import math
import zlib
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils.modes import check_pixels, to_rgba

_MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}
_RAW = {"L": ("u1", 1), "I;16": ("<u2", 2), "I": ("<i4", 4), "F": ("<f4", 4)}


class Fits(NamedTuple):
    mode: str
    width: int
    height: int
    offset: int
    gzip_bits: int  # the ZBITPIX of a GZIP_1 image, else None


def accept(prefix: bytes) -> bool:
    return prefix.startswith(b"SIMPLE")


def _size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _parse(headers: dict):
    """FitsImageFile._parse_headers -> (mode, size, offset, gzip bits) or None."""
    prefix, offset, bits = b"", 0, None
    if (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        table = _size(headers, prefix) or (0, 0)
        offset = table[0] * table[1] * (int(headers[b"BITPIX"]) // 8)
        prefix = b"Z"
    size = _size(headers, prefix)
    if not size:
        return None
    number_of_bits = int(headers[prefix + b"BITPIX"])
    if prefix:
        bits = number_of_bits
    return _MODES.get(number_of_bits, ""), size, offset, bits


def open_fits(raw: bytes) -> Fits:
    """FitsImageFile._open -> Fits (int() of a value that is not a number
    raises ValueError, which ends the open, as in Pillow)."""
    fp, headers, in_progress, parsed = io.BytesIO(raw), {}, False, None
    while True:
        card = fp.read(80)
        if not card:
            raise OSError("truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b"END":
            fp.seek(math.ceil(fp.tell() / 2880) * 2880)
            if not parsed:
                parsed = _parse(headers)
            in_progress = False
            continue
        if parsed:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not accept(keyword) or value != b"T"):
            raise SyntaxError("not a FITS file")
        headers[keyword] = value
    if not parsed:
        raise ValueError("FITS file has no image data")
    mode, (width, height), offset, bits = parsed
    if not mode or width <= 0 or height <= 0:
        raise SyntaxError(f"FITS image of mode {mode!r} and size {width}x{height}")
    check_pixels(width, height, "FITS")
    return Fits(mode, width, height, offset + fp.tell() - 80, bits)


def decode_fits(raw: bytes, f: Fits = None) -> np.ndarray:
    """FITS bytes (or their `open_fits` header) -> uint8 [H, W, 4]."""
    raw = bytes(raw)
    f = f or open_fits(raw)
    dtype, size = _RAW[f.mode]
    w, h = f.width, f.height
    if f.gzip_bits is None:
        if f.offset < 0 or len(raw) < f.offset + w * h * size:
            raise ValueError("FITS image data is truncated")
        px = np.frombuffer(raw, dtype, count=w * h, offset=f.offset).reshape(h, w)[::-1]
    else:
        try:
            value = gzip.decompress(raw[max(f.offset, 0) :])
        except (OSError, EOFError, zlib.error) as e:
            raise ValueError(f"FITS GZIP_1 data: {e}") from e
        nb = min(f.gzip_bits // 8, 4)
        if nb <= 0 or len(value) < 4 * w * h:
            raise ValueError("FITS GZIP_1 image: not enough image data")
        words = np.frombuffer(value, np.uint8, count=4 * w * h).reshape(h, w, 4)[::-1]
        px = np.frombuffer(words[..., 4 - nb :].tobytes(), dtype).reshape(h, w)
    if f.mode == "F":
        px = px.astype(np.float32)
    return to_rgba(f.mode, px)
