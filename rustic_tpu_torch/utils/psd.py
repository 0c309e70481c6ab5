"""A Photoshop (PSD) decoder for scene textures and LDR skyboxes: the
composite image of a PSD, as Pillow 12.1.0 reads it (PIL/PsdImagePlugin.py)
and converts it to RGBA.

The JAX package opens a PSD with Pillow; this module gives the same
uint8 [H, W, 4]. Pillow takes the mode from the header's (colour mode,
depth) pair and reads the first channels of the composite image, plane
by plane, after the colour-mode data, the image resources and the layer
and mask section (each skipped by its length; the ICC profile changes no
pixel):

- bitmap at 1 bit ("1": a set bit is white, as Pillow's raw "1" reads it),
  greyscale, multichannel and duotone at 8 bits (L: the first channel);
- indexed (P): the 768-byte colour-mode data as 256 reds, greens and
  blues (with any other length Pillow keeps no palette: every index
  black);
- RGB: 3 channels, 4 -> RGBA, 5 or more -> RGB (the rest ignored);
- CMYK: 4 channels, each stored inverted, then Pillow's CMYK -> RGB
  (255 - k - c * (255 - k) / 255, in its fixed-point MULDIV255);
- Lab: 3 channels, a and b stored with 128 for 0 (the planes go into
  Pillow's "LAB" bands as they are), then LittleCMS's Lab -> sRGB as
  Pillow's convert runs it: utils/modes.py `lab_to_rgb`, the transform of
  a CIELab TIFF, whose a and b are signed. Alpha is 0: the transform
  copies the fourth byte of each LAB pixel, which Pillow's chunky TIFF
  unpacker sets to 255 and its plane-by-plane PSD reading leaves at 0.

Both compressions are read: raw (0), each channel a plane at its
offset, and PackBits (1), with the per-row byte counts of the channels
Pillow reads (only those: a file with extra channels is read from where
Pillow reads it) and rows decoded as PackDecode.c decodes them
(csrc/bcn_decode.cpp `packbits_rows`).

Pillow raises for, and this module refuses by name with
NotImplementedError citing FORMATS_TODO: 16- and 32-bit depths and any
other (mode, depth) pair, PSB (version 2), ZIP compression (2, 3), and
fewer channels than the mode needs. A truncated or malformed file raises
ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO, NotThisFormat, _entropy
from rustic_tpu_torch.utils._entropy import ptr
from rustic_tpu_torch.utils.modes import check_pixels, lab_to_rgb, muldiv255, note_core

PSD_SIGNATURE = b"8BPS"
# (colour mode, depth) -> (Pillow mode, channels it reads)
_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
          (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
          (9, 8): ("LAB", 3)}
_COMPRESSIONS = {2: "ZIP", 3: "ZIP with prediction"}


def _refuse(variant: str):
    raise NotImplementedError(f"PSD {variant} is not decoded ({FORMATS_TODO})")


class _Reader:
    def __init__(self, raw: bytes, pos: int = 0):
        self.raw, self.pos = raw, pos

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.raw):
            raise ValueError(f"PSD is truncated: {n} bytes at {self.pos}, the file ends at "
                             f"{len(self.raw)}")
        out = self.raw[self.pos : self.pos + n]
        self.pos += n
        return out

    def u16(self) -> int:
        return struct.unpack(">H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]


def _skip_resources(r: _Reader):
    """Step over the image resources entry by entry, as Pillow does: the
    section ends its length after that length's own 4 bytes, a last entry
    that overruns it moves the image data with it, and a read past the
    file's end stops there (a file read), except where a number is cut
    short (Pillow's struct.error, or IndexError for the name's length:
    Image.open passes the file on)."""
    end = r.pos + 4
    end += r.u32()
    raw = r.raw

    def read(n):
        out = raw[r.pos : r.pos + n]
        r.pos += len(out)
        return out

    def number(n):
        b = read(n)
        if len(b) < n:
            raise NotThisFormat("PSD image resource is cut short")
        return int.from_bytes(b, "big")

    while r.pos < end:
        read(4)  # signature
        number(2)  # id
        name = read(number(1))
        if not len(name) & 1:
            read(1)
        data = read(number(4))
        if len(data) & 1:
            read(1)


def _planes(r: _Reader, compression: int, channels: int, rows: int, row_bytes: int,
            width: int) -> np.ndarray:
    """The channels' planes -> uint8 [channels, rows, row_bytes]."""
    raw = r.raw
    if compression == 0:
        # each plane at start + c * width * rows, as Pillow lays them
        if r.pos + (channels - 1) * width * rows + rows * row_bytes > len(raw):
            raise ValueError("PSD image data is truncated")
        return np.stack([np.frombuffer(raw, np.uint8, rows * row_bytes, r.pos + c * width * rows)
                         .reshape(rows, row_bytes) for c in range(channels)])
    counts = np.frombuffer(r.take(2 * channels * rows), ">u2").astype(np.int64)
    out = np.empty((channels, rows, row_bytes), np.uint8)
    data = np.frombuffer(raw, np.uint8)
    lib = _entropy.bcn_library()
    start = r.pos
    for c in range(channels):
        src = data[start:]
        plane = np.empty((rows, row_bytes), np.uint8)
        if lib.packbits_rows(ptr(src), len(src), row_bytes, rows, ptr(plane)) < 0:
            raise ValueError(f"PSD PackBits data of channel {c} is truncated")
        out[c] = plane
        start += int(counts[c * rows : (c + 1) * rows].sum())
    return out


def open_psd(raw: bytes):
    """PsdImageFile._open and Image.open's checks after it (utils/png.py
    runs it at the open, as Pillow does): a size of zero passes the file
    on, a decompression bomb ends the open."""
    decode_psd(raw, _stop=True)


def decode_psd(raw: bytes, _stop: bool = False) -> np.ndarray:
    """PSD bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    raw = bytes(raw)
    r = _Reader(raw)
    head = r.take(26)
    if head[:4] != PSD_SIGNATURE:
        raise ValueError("not a PSD file")
    version, = struct.unpack(">H", head[4:6])
    if version == 2:
        _refuse("large document format (PSB, version 2)")
    if version != 1:
        raise ValueError(f"PSD version {version}")
    psd_channels, height, width, depth, colour = struct.unpack(">HIIHH", head[12:26])
    if (colour, depth) not in _MODES:
        _refuse(f"colour mode {colour} at {depth} bits")
    mode, channels = _MODES[(colour, depth)]
    if channels > psd_channels:
        _refuse(f"{mode} with {psd_channels} channels (it needs {channels})")
    if mode == "RGB" and psd_channels == 4:
        mode, channels = "RGBA", 4
    colour_data = r.take(r.u32())
    _skip_resources(r)
    r.take(r.u32())  # the layer and mask section
    compression = r.u16()
    if compression not in (0, 1):
        _refuse(_COMPRESSIONS.get(compression, f"compression {compression}"))
    if width <= 0 or height <= 0:  # ImageFile's SyntaxError for an empty size
        raise NotThisFormat(f"PSD of size {width}x{height}")
    check_pixels(width, height, "PSD")
    if _stop:
        return None
    row_bytes = (width + 7) // 8 if mode == "1" else width
    planes = _planes(r, compression, channels, height, row_bytes, width)
    note_core(mode)
    out = np.full((height, width, 4), 255, np.uint8)
    if mode == "1":
        bits = np.unpackbits(planes[0], axis=1)[:, :width]
        out[..., 0:3] = (bits * np.uint8(255))[..., None]
    elif mode == "L":
        out[..., 0:3] = planes[0][..., None]
    elif mode == "P":
        palette = np.zeros((256, 3), np.uint8)
        if len(colour_data) == 768:
            palette = np.frombuffer(colour_data, np.uint8).reshape(3, 256).T
        out[..., 0:3] = palette[planes[0]]
        note_core(mode, planes[0], palette)
    elif mode == "CMYK":
        ink = 255 - planes.astype(np.int64)  # stored inverted
        nk = 255 - ink[3]
        for i in range(3):
            out[..., i] = np.clip(nk - muldiv255(ink[i], nk), 0, 255)
    elif mode == "LAB":  # 128 for a and b of 0: lab_to_rgb takes them signed
        out[..., :3] = lab_to_rgb(planes.transpose(1, 2, 0) ^ np.array([0, 128, 128], np.uint8))
        out[..., 3] = 0  # the fourth byte of Pillow's LAB pixel, which no plane fills
    else:
        out[..., :channels] = planes.transpose(1, 2, 0)
    return out
