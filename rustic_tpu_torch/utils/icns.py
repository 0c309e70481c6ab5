"""A Mac OS icon (ICNS) decoder, as Pillow 12.1.0 reads it
(PIL/IcnsImagePlugin.py) and converts it to RGBA.

The file is "icns", its length, then blocks (a type and a length). Pillow
opens the largest size (its SIZES, compared as (width, height, scale))
that any block holds, and reads every block of that size in SIZES'
order:
- a PNG or JPEG 2000 entry (ic07-ic14, icp4-icp6): decoded by the port's
  PNG or JPEG 2000 decoder; as in Pillow, a PNG's tRNS does not reach
  the result (its transparency stays with the PNG's own image);
- a 32-bit entry (it32, after four zero bytes; ih32, il32, is32): raw RGB
  where its length is three bytes a pixel, else three channels of runs
  (a byte b >= 0x80: b - 125 copies of the next byte; else b + 1 literal
  bytes), decoded by the host C++ loop `icns_rle`
  (csrc/image_entropy.cpp);
- its 8-bit mask (t8mk, h8mk, l8mk, s8mk): the alpha.
A PNG or JPEG 2000 entry is the image; else the RGB entry, with the mask
as alpha where there is one. An entry whose size is not one the file
lists, scaled, ends the decode as in Pillow.

A file cut short in its block list (Pillow reads block headers up to the
length the header gives), a block of length 0 or less, or no block of a
size Pillow knows raises an error of PASSED_ON and the file passes on; a bad
entry (no four zero bytes before it32's runs, runs that do not add up,
data cut short) ends the decode (ValueError), and a subimage that is
neither PNG nor JPEG 2000, which Pillow refuses, raises
NotImplementedError naming it.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO, _entropy
from rustic_tpu_torch.utils._entropy import ptr

MAGIC = b"icns"
_PNG, _RGB32, _RGB32T, _MASK = "png_or_jpeg2000", "rgb", "rgb after four zero bytes", "mask"
SIZES = {
    (512, 512, 2): [(b"ic10", _PNG)],
    (512, 512, 1): [(b"ic09", _PNG)],
    (256, 256, 2): [(b"ic14", _PNG)],
    (256, 256, 1): [(b"ic08", _PNG)],
    (128, 128, 2): [(b"ic13", _PNG)],
    (128, 128, 1): [(b"ic07", _PNG), (b"it32", _RGB32T), (b"t8mk", _MASK)],
    (64, 64, 1): [(b"icp6", _PNG)],
    (32, 32, 2): [(b"ic12", _PNG)],
    (48, 48, 1): [(b"ih32", _RGB32), (b"h8mk", _MASK)],
    (32, 32, 1): [(b"icp5", _PNG), (b"il32", _RGB32), (b"l8mk", _MASK)],
    (16, 16, 2): [(b"ic11", _PNG)],
    (16, 16, 1): [(b"icp4", _PNG), (b"is32", _RGB32), (b"s8mk", _MASK)],
}


class Icns(NamedTuple):
    blocks: dict  # type -> (start, length)
    sizes: list  # the SIZES keys the file holds, in SIZES' order
    best: tuple  # the largest


def open_icns(raw: bytes) -> Icns:
    """IcnsImageFile._open (IcnsFile) -> Icns."""
    sig, filesize = struct.unpack_from(">4sI", raw)
    if sig != MAGIC:
        raise SyntaxError("not an icns file")
    blocks, i = {}, 8
    while i < filesize:
        if i + 8 > len(raw):
            raise SyntaxError("ICNS block list cut short")
        sig, blocksize = struct.unpack_from(">4sI", raw, i)
        if blocksize <= 0:
            raise SyntaxError("invalid ICNS block header")
        i += 8
        blocks[sig] = (i, blocksize - 8)
        i += blocksize - 8
    sizes = [size for size, fmts in SIZES.items() if any(code in blocks for code, _ in fmts)]
    if not sizes:
        raise SyntaxError("no 32-bit icon resources found")
    return Icns(blocks, sizes, max(sizes))


def _subimage(raw: bytes, start: int, length: int) -> np.ndarray:
    from rustic_tpu_torch.utils.jpeg2000 import decode_jpeg2000
    from rustic_tpu_torch.utils.png import PNG_SIGNATURE, decode_png

    sig = raw[start : start + 12]
    if sig.startswith(PNG_SIGNATURE):
        return decode_png(raw[start:], transparency=False)
    if (sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a"))
            or sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"):
        return decode_jpeg2000(raw[start : start + length])
    raise NotImplementedError(f"ICNS subimage of first bytes {sig[:8].hex()} (Pillow reads PNG "
                              f"and JPEG 2000 ones) is not decoded ({FORMATS_TODO})")


def _rgb32(raw: bytes, start: int, length: int, side: int) -> np.ndarray:
    n = side * side
    if length == n * 3:
        if len(raw) < start + length:
            raise ValueError("ICNS RGB entry: not enough image data")
        return np.frombuffer(raw, np.uint8, count=length, offset=start).reshape(side, side, 3)
    data = np.frombuffer(raw, np.uint8)
    planes = np.zeros((3, n), np.uint8)
    got = np.zeros(3, np.int64)
    if _entropy.library().icns_rle(ptr(data), len(raw), start, n, ptr(planes), ptr(got)) < 0:
        raise ValueError("ICNS RGB entry: error reading a channel (its runs do not add up)")
    if (got < n).any():
        raise ValueError("ICNS RGB entry: not enough image data")
    return planes.reshape(3, side, side).transpose(1, 2, 0)


def _check_size(f: Icns, width: int, height: int):
    """IcnsImageFile's size setter: the loaded image must be one of the
    file's sizes, scaled."""
    for w, h, scale in f.sizes:
        if (h * scale) / height == (w * scale) // width:
            return
    raise ValueError(f"ICNS entry of {width}x{height} is not one of the allowed sizes")


def decode_icns(raw: bytes, f: Icns = None) -> np.ndarray:
    """ICNS bytes (or their `open_icns` header) -> uint8 [H, W, 4]."""
    raw = bytes(raw)
    f = f or open_icns(raw)
    side = f.best[0] * f.best[2]
    channels = {}
    for code, kind in SIZES[f.best]:
        if code not in f.blocks:
            continue
        start, length = f.blocks[code]
        if kind == _PNG:
            channels["RGBA"] = _subimage(raw, start, length)
        elif kind == _MASK:
            if len(raw) < start + side * side:
                raise ValueError("ICNS mask: not enough image data")
            channels["A"] = np.frombuffer(raw, np.uint8, count=side * side,
                                          offset=start).reshape(side, side)
        else:
            if kind == _RGB32T:
                if raw[start : start + 4] != b"\0\0\0\0":
                    raise ValueError("unknown ICNS it32 signature, expecting 0x00000000")
                start, length = start + 4, length - 4
            channels["RGB"] = _rgb32(raw, start, length, side)
    if "RGBA" in channels:
        img = channels["RGBA"]
    elif "RGB" not in channels:
        raise ValueError(f"ICNS size {f.best} has a mask and no image")
    else:
        img = np.full((side, side, 4), 255, np.uint8)
        img[..., :3] = channels["RGB"]
        if "A" in channels:
            img[..., 3] = channels["A"]
    _check_size(f, img.shape[1], img.shape[0])
    return img
