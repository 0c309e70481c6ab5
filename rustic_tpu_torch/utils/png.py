"""A NumPy PNG decoder for scene textures and LDR skyboxes, and the
encoder of image output.

The JAX package decodes images with Pillow (`Image.open(...).convert("RGBA")`,
rustic_tpu/scene/gltf.py `_decode_image`); the port runs where Pillow may
be absent, so it carries this decoder for the PNGs it renders: 8-bit,
non-interlaced, grey (0), RGB (2), grey + alpha (4) or RGBA (6), with the
five scanline filters of the PNG specification (None, Sub, Up, Average,
Paeth). The result is what Pillow's `convert("RGBA")` gives: uint8
[H, W, 4], alpha 255 where the image has none. Anything else (palettes,
other depths, interlacing, a tRNS key colour, JPEG) raises
NotImplementedError. `encode_png` writes 8-bit RGB or RGBA with filter 0
(None) on every scanline, which any decoder reads.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
FORMATS_TODO = "ROADMAP.md queue 3: image formats the port does not decode"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _unfilter_sequential(kind: int, filt: bytes, prev: bytes, bpp: int) -> bytearray:
    """Average (3) or Paeth (4): each byte depends on the one bpp left."""
    out = bytearray(len(filt))
    for i, f in enumerate(filt):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            out[i] = (f + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        out[i] = (f + pred) & 0xFF
    return out


def _unfilter(data: bytes, height: int, width: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters -> uint8 [height, width * bpp]."""
    stride = width * bpp
    if len(data) < height * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(data, np.uint8, count=height * (stride + 1)).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, filt = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = filt.copy()
        elif kind == 1:  # Sub: a running sum per channel, mod 256
            cur = np.cumsum(filt.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = filt + prev
        elif kind in (3, 4):
            cur = np.frombuffer(
                _unfilter_sequential(kind, filt.tobytes(), prev.tobytes(), bpp), np.uint8
            )
        else:
            raise ValueError(f"PNG filter type {kind} is not defined")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(raw: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    if raw[:8] != PNG_SIGNATURE:
        raise NotImplementedError(f"only PNG images are decoded ({FORMATS_TODO})")
    pos = 8
    header = None
    idat = []
    while pos + 8 <= len(raw):
        length, kind = struct.unpack(">I4s", raw[pos : pos + 8])
        body = raw[pos + 8 : pos + 8 + length]
        pos += 12 + length  # length, type, data, CRC
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind in (b"PLTE", b"tRNS"):
            raise NotImplementedError(
                f"PNG {kind.decode()} chunks (palettes, key colours) are not decoded "
                f"({FORMATS_TODO})"
            )
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, colour, _compression, _filter, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise NotImplementedError(
            f"PNG bit depth {depth}, colour type {colour}, interlace {interlace}: only 8-bit "
            f"non-interlaced grey, RGB, grey+alpha and RGBA are decoded ({FORMATS_TODO})"
        )
    n = _CHANNELS[colour]
    px = _unfilter(zlib.decompress(b"".join(idat)), height, width, n).reshape(height, width, n)
    out = np.full((height, width, 4), 255, np.uint8)
    if colour in (0, 4):
        out[..., 0:3] = px[..., 0:1]
    else:
        out[..., 0:3] = px[..., 0:3]
    if colour in (4, 6):
        out[..., 3] = px[..., -1]
    return out


def decode_image_rgba(raw: bytes) -> np.ndarray:
    """An image file's bytes -> float32 [H, W, 4] in [0, 1], as the JAX
    package's `np.asarray(Image.open(...).convert("RGBA"), np.float32) / 255`."""
    return np.asarray(decode_png(raw), np.float32) / 255.0


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF
    )


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> PNG bytes: 8 bits a
    sample, not interlaced, every scanline filter 0 (None)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"encode_png takes uint8 [H, W, 3 or 4], not {img.dtype} {img.shape}")
    height, width, n = img.shape
    rows = np.zeros((height, width * n + 1), np.uint8)  # column 0: the filter byte
    rows[:, 1:] = img.reshape(height, width * n)
    header = struct.pack(">IIBBBBB", width, height, 8, 2 if n == 3 else 6, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))
