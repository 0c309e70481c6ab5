"""NumPy decoders of Windows BMP and Truevision TGA images, for scene
textures and LDR skyboxes.

The JAX package reads both through Pillow (`Image.open(...).convert("RGBA")`);
these give the same uint8 [H, W, 4]:

- BMP: the 40-byte BITMAPINFOHEADER and its longer forms (52, 56, 64,
  V4's 108 and V5's 124 bytes); 24 bits a pixel; 32 bits uncompressed
  (the fourth byte ignored, alpha 255, as Pillow reads it) or with
  BI_BITFIELDS masks of whole bytes (alpha where a mask names it); 1, 4
  and 8-bit palettes; rows bottom-up, or top-down where the height is
  negative.
- TGA: true colour (types 2 and 10) at 24 and 32 bits (alpha kept), grey
  (types 3 and 11) at 8 bits and 16 (grey + alpha), colour-mapped (types
  1 and 9) with 8-bit indices into a 24-bit map; run-length coding
  (types 9-11); the origin bits (top or bottom, left or right).

RLE-compressed BMPs, 16-bit pixels and maps, OS/2 headers and other
layouts raise NotImplementedError naming the variant. TGA has no
signature: `decode_image_rgba` (utils/png.py) takes a TGA by its name,
and every other format it reads (PNG, JPEG, BMP, GIF, TIFF, WebP) by
its signature.
"""

from __future__ import annotations

import struct

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO

_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS = 0, 1, 2, 3
_BMP_HEADERS = (40, 52, 56, 64, 108, 124)
# the 32-bit (R, G, B, A) bit-field masks Pillow reads (BmpImagePlugin SUPPORTED)
_BMP_MASKS = (
    (0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
    (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0),
)


def _refuse(variant: str):
    raise NotImplementedError(f"{variant} is not decoded ({FORMATS_TODO})")


def _unpack_bits(rows: np.ndarray, bits: int, width: int) -> np.ndarray:
    """uint8 [H, stride] of `bits`-bit samples, most significant first ->
    [H, width] sample values."""
    if bits == 8:
        return rows[:, :width]
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    return ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(len(rows), -1)[:, :width]


def decode_bmp(raw: bytes) -> np.ndarray:
    """BMP bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    if raw[:2] != b"BM":
        raise ValueError("not a BMP file")
    (offset,) = struct.unpack("<I", raw[10:14])
    (header,) = struct.unpack("<I", raw[14:18])
    if header not in _BMP_HEADERS:
        _refuse(f"BMP with a {header}-byte header")
    width, height, _planes, bits, compression, _size, _xppm, _yppm, colors = struct.unpack(
        "<iiHHIIiiI", raw[18:50])
    top_down = height < 0
    height = abs(height)
    if width <= 0 or height == 0:
        raise ValueError(f"BMP size {width}x{height}")
    if compression in (_BI_RLE8, _BI_RLE4):
        _refuse(f"RLE{8 if compression == _BI_RLE8 else 4}-compressed BMP")
    if compression not in (_BI_RGB, _BI_BITFIELDS):
        _refuse(f"BMP compression {compression}")
    if bits not in (1, 4, 8, 24, 32):
        _refuse(f"{bits}-bit BMP")
    stride = ((width * bits + 31) >> 3) & ~3
    data = np.frombuffer(raw, np.uint8, count=stride * height, offset=offset)
    rows = data.reshape(height, stride)
    if not top_down:
        rows = rows[::-1]
    out = np.full((height, width, 4), 255, np.uint8)
    if bits <= 8:
        if compression != _BI_RGB:
            raise ValueError("BMP bit fields on a palette image")
        n = colors or 1 << bits
        start = 14 + header
        palette = np.zeros((max(n, 256), 4), np.uint8)
        palette[:n] = np.frombuffer(raw, np.uint8, count=4 * n, offset=start).reshape(n, 4)
        idx = _unpack_bits(rows, bits, width)
        out[..., :3] = palette[idx][..., 2::-1]  # BGRX entries
        return out
    px = rows[:, : width * bits // 8].reshape(height, width, bits // 8)
    if bits == 24:
        if compression == _BI_BITFIELDS and raw[54:66] != struct.pack("<III", 0xFF0000, 0xFF00, 0xFF):
            _refuse("24-bit BMP bit fields other than BGR")
        out[..., :3] = px[..., ::-1]
        return out
    if compression == _BI_RGB:  # BGRX: the fourth byte is not alpha
        out[..., :3] = px[..., 2::-1]
        return out
    # the masks follow a 40-byte header and end a 52-byte one; alpha's from 56 bytes on
    masks = struct.unpack("<III", raw[54:66]) + (
        struct.unpack("<I", raw[66:70]) if header > 52 else (0,))
    if masks not in _BMP_MASKS:
        _refuse(f"BMP bit fields {tuple(hex(m) for m in masks)}")
    if masks == (0, 0, 0, 0):  # Pillow reads these as BGRA
        masks = (0xFF0000, 0xFF00, 0xFF, 0xFF000000)
    value = np.ascontiguousarray(px).view("<u4")[..., 0]
    for ch, mask in enumerate(masks):
        if mask:
            out[..., ch] = (value >> (mask.bit_length() - 8)) & 0xFF
    return out


def _tga_rle(raw: bytes, pos: int, n: int, size: int) -> np.ndarray:
    """Run-length packets from `pos` -> uint8 [n, size] (n pixels of
    `size` bytes; a packet may run across rows)."""
    out = bytearray()
    want = n * size
    while len(out) < want:
        if pos >= len(raw):
            raise ValueError("TGA run-length data is truncated")
        head = raw[pos]
        count = (head & 0x7F) + 1
        if head & 0x80:
            out += raw[pos + 1 : pos + 1 + size] * count
            pos += 1 + size
        else:
            out += raw[pos + 1 : pos + 1 + size * count]
            pos += 1 + size * count
    return np.frombuffer(bytes(out[:want]), np.uint8).reshape(n, size)


def decode_tga(raw: bytes) -> np.ndarray:
    """TGA bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    if len(raw) < 18:
        raise ValueError("TGA header is truncated")
    id_len, map_type, kind = raw[0], raw[1], raw[2]
    map_start, map_len, map_depth = struct.unpack("<HHB", raw[3:8])
    width, height, depth, flags = struct.unpack("<HHBB", raw[12:18])
    if map_type not in (0, 1) or width == 0 or height == 0:
        raise ValueError("not a TGA file")
    base = kind & 7
    if base not in (1, 2, 3) or kind not in (1, 2, 3, 9, 10, 11):
        _refuse(f"TGA image type {kind}")
    if base == 2 and depth not in (24, 32) or base == 3 and depth not in (8, 16) or (
            base == 1 and depth != 8):
        _refuse(f"{depth}-bit TGA of type {kind}")
    pos = 18 + id_len
    palette = None
    if map_type:
        if map_depth != 24:  # Pillow 12 reads no 16- or 32-bit map either
            _refuse(f"TGA with a {map_depth}-bit colour map")
        entries = np.frombuffer(raw, np.uint8, count=3 * map_len, offset=pos)
        palette = np.zeros((max(256, map_start + map_len), 3), np.uint8)
        palette[map_start : map_start + map_len] = entries.reshape(map_len, 3)[:, ::-1]
        pos += 3 * map_len
    size = depth // 8
    n = width * height
    if kind & 8:
        px = _tga_rle(raw, pos, n, size)
    else:
        px = np.frombuffer(raw, np.uint8, count=n * size, offset=pos).reshape(n, size)
    px = px.reshape(height, width, size)
    if not flags & 0x20:  # bottom-up rows
        px = px[::-1]
    if flags & 0x10:  # right-to-left
        px = px[:, ::-1]
    out = np.full((height, width, 4), 255, np.uint8)
    if base == 2:
        out[..., :3] = px[..., 2::-1]
        if depth == 32:
            out[..., 3] = px[..., 3]
    elif base == 3:
        out[..., :3] = px[..., :1]
        if depth == 16:
            out[..., 3] = px[..., 1]
    elif palette is None:  # colour-mapped without a map: Pillow reads the index as grey
        out[..., :3] = px[..., :1]
    else:
        out[..., :3] = palette[px[..., 0]]
    return out
