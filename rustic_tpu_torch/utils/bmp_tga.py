"""NumPy decoders of Windows BMP, the bare DIB and Truevision TGA
images, for scene textures and LDR skyboxes.

The JAX package reads them through Pillow (`Image.open(...).convert("RGBA")`);
these give the same uint8 [H, W, 4]:

- The DIB core (`read_dib`, `dib_rgba`), Pillow's BmpImagePlugin
  `_bitmap`, which BMP, the bare DIB (`DibImageFile`, a BMP without its
  14-byte file header) and the bitmaps of ICO and CUR files
  (utils/ico.py) share: the 40-byte BITMAPINFOHEADER and its longer forms
  (52, 56, 64, V4's 108 and V5's 124 bytes); 24 bits a pixel; 32 bits
  uncompressed (the fourth byte ignored, alpha 255, as Pillow reads it;
  alpha where a CUR's bitmap starts at byte 22) or with BI_BITFIELDS masks
  of whole bytes (alpha where a mask names it); 1, 4 and 8-bit palettes,
  and Pillow's reading of a grey palette: two entries black and white ->
  its mode "1" (one bit a pixel, whatever the depth), entries i = (i, i,
  i) -> mode "L" (one byte a pixel, whatever the depth; Pillow refuses
  the rows that are narrower than that); rows bottom-up, or top-down where
  the height's top byte is 0xFF. The pixel data ends where Pillow's raw
  decoder stops: the last row needs no padding.
- BMP: the file header's pixel offset (moved past the palette where it
  points at it, as Pillow moves it); the bare DIB: the pixels right after
  the header, its masks and its palette.
- TGA: true colour (types 2 and 10) at 24 and 32 bits (alpha kept), grey
  (types 3 and 11) at 8 bits and 16 (grey + alpha) and uncompressed at 1
  bit (Pillow's mode "1"), colour-mapped (types
  1 and 9) with 8-bit indices into a 24-bit map; run-length coding
  (types 9-11); the origin bits (top or bottom, left or right).

RLE-compressed BMPs, 16-bit pixels and maps, OS/2 headers and other
layouts raise NotImplementedError naming the variant. A header that
Pillow's plugin turns away so that `Image.open` tries the next one
(a header cut short, a size of zero) raises NotThisFormat; a truncated
file ValueError. TGA has no signature: `decode_image_u8` (utils/png.py)
takes a TGA by its name, at TGA's place in Pillow's order, once
`tga_refusal` finds nothing Pillow's TgaImagePlugin would turn away.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO, NotThisFormat
from rustic_tpu_torch.utils.modes import to_rgba, unpack_bits

_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS = 0, 1, 2, 3
_BMP_HEADERS = (40, 52, 56, 64, 108, 124)
DIB_HEADERS = (12,) + _BMP_HEADERS  # BmpImagePlugin `_dib_accept`
# the 32-bit (R, G, B, A) bit-field masks Pillow reads (BmpImagePlugin SUPPORTED)
_BMP_MASKS = (
    (0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
    (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0),
)
_BGRX, _BGRA = (0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF0000, 0xFF00, 0xFF, 0xFF000000)


def _refuse(variant: str):
    raise NotImplementedError(f"{variant} is not decoded ({FORMATS_TODO})")


class Dib(NamedTuple):
    """A DIB header as Pillow's `_bitmap` reads it."""
    width: int
    height: int  # the header's rows (ICO and CUR halve them)
    mode: str  # Pillow's image mode: "1", "L", "P", "RGB" or "RGBA"
    unpack: object  # a row's samples: "1", "L", "P;1", "P;4", "P", "BGR" or 32-bit RGBA masks
    palette: object  # uint8 [256, 3] for mode "P"
    offset: int  # where the rows start
    stride: int  # bytes a row in the file
    top_down: bool


def _u32(raw: bytes, pos: int) -> int:
    if pos < 0 or len(raw) < pos + 4:
        raise NotThisFormat("a DIB field is cut short")  # Pillow: struct.error
    return struct.unpack_from("<I", raw, pos)[0]


def read_dib(raw: bytes, pos: int, offset: int = 0, what: str = "BMP",
             cur_start: int = 0) -> Dib:
    """The DIB header at `pos` -> Dib. `offset` is the BMP file header's
    pixel offset (0: the rows follow the header, its masks and its
    palette); `cur_start` the CUR directory's offset of the bitmap
    (Pillow reads a 32-bit one that starts at byte 22 with its alpha)."""
    header = _u32(raw, pos)
    if header > 4 and len(raw) < pos + header:
        raise ValueError(f"{what} header is truncated")
    if header == 12 or header not in _BMP_HEADERS:
        _refuse(f"{what} with a {header}-byte header")
    hd = raw[pos + 4 : pos + header]
    top_down = hd[7] == 0xFF
    width, height, _planes, bits, compression = struct.unpack_from("<IIHHI", hd)
    if top_down:
        height = 2**32 - height
    (colors,) = struct.unpack_from("<I", hd, 28)
    cursor = pos + header
    masks = None
    if compression == _BI_BITFIELDS:
        if header >= 52:  # the masks end a 52-byte header; alpha's from 56 bytes on
            masks = struct.unpack_from("<III", hd, 36) + (
                struct.unpack_from("<I", hd, 48) if header >= 56 else (0,))
        else:  # they follow a 40-byte one
            masks = (_u32(raw, cursor), _u32(raw, cursor + 4), _u32(raw, cursor + 8), 0)
            cursor += 12
    colors = colors or 1 << bits
    if offset == 14 + header and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        _refuse(f"{bits}-bit {what}")
    if compression == _BI_BITFIELDS:
        if bits == 16:
            _refuse(f"16-bit {what}")
        if bits == 24 and masks[:3] != _BGRX[:3] or bits == 32 and masks not in _BMP_MASKS:
            _refuse(f"{what} bit fields {tuple(hex(m) for m in masks[:3 if bits == 24 else 4])}")
        if bits < 16:
            _refuse(f"{what} bit fields on a {bits}-bit palette image")
        unpack = "BGR" if bits == 24 else (_BGRA if masks == (0, 0, 0, 0) else masks)
    elif compression == _BI_RGB:
        if bits == 16:
            _refuse(f"16-bit {what}")
        unpack = {24: "BGR", 32: _BGRA if cur_start == 22 else _BGRX}.get(bits, f"P;{bits}")
    elif compression in (_BI_RLE8, _BI_RLE4):
        _refuse(f"RLE{8 if compression == _BI_RLE8 else 4}-compressed {what}")
    else:
        _refuse(f"{what} compression {compression}")
    mode = "RGBA" if bits == 32 and unpack[3] else "RGB"
    palette = None
    if bits <= 8:
        unpack = "P" if bits == 8 else unpack
        if not 0 < colors <= 65536:
            _refuse(f"{what} palette of {colors} colours")
        entries = raw[cursor : cursor + 4 * colors]
        cursor += len(entries)
        mode = _grey(entries, colors) or "P"
        if mode != "P":
            unpack = mode
        else:
            n = len(entries) // 4  # the entries the file holds
            if n > 256:  # Pillow's putpalette: "invalid palette size"
                raise ValueError(f"{what} palette of {n} colours is longer than 256")
            palette = np.zeros((256, 3), np.uint8)
            palette[:n] = np.frombuffer(entries, np.uint8, count=4 * n).reshape(n, 4)[:, 2::-1]
    stride = ((width * bits + 31) >> 3) & ~3
    return Dib(width, height, mode, unpack, palette, offset or cursor, stride, top_down)


def _grey(entries: bytes, colors: int):
    """Pillow's test of a palette: "1" where its two entries are black and
    white, "L" where entry i is (i, i, i) for every i, else None."""
    want = np.array((0, 255) if colors == 2 else np.arange(colors) & 0xFF, np.uint8)
    if len(entries) < 4 * (colors - 1) + 3:
        return None
    pal = np.frombuffer(entries + b"\0", np.uint8, count=4 * colors).reshape(colors, 4)[:, :3]
    if not (pal == want[:, None]).all():
        return None
    return "1" if colors == 2 else "L"


def dib_rgba(raw: bytes, dib: Dib, rows: int = None) -> np.ndarray:
    """The first `rows` rows (default: all) of a DIB's pixels, as Pillow's
    raw decoder lays them into an image that many rows high -> uint8
    [rows, W, 4] (the mode's RGBA)."""
    rows = dib.height if rows is None else rows
    width, stride = dib.width, dib.stride
    bits = {"1": 1, "L": 8, "P;1": 1, "P;4": 4, "P": 8, "BGR": 24}.get(dib.unpack, 32)
    row_bytes = (width * bits + 7) // 8
    if row_bytes > stride:  # the raw decoder's "codec configuration error"
        _refuse(f"grey-palette DIB of {width} one-byte pixels in rows of {stride} bytes")
    need = stride * (rows - 1) + row_bytes if rows else 0
    if dib.offset + need > len(raw):
        raise ValueError("DIB pixel data is truncated")
    data = np.zeros(stride * rows, np.uint8)
    data[:need] = np.frombuffer(raw, np.uint8, count=need, offset=dib.offset)
    px = data.reshape(rows, stride)
    if not dib.top_down:
        px = px[::-1]
    if dib.unpack in ("1", "L", "P;1", "P;4", "P"):
        idx = unpack_bits(px, bits, width)
        if dib.unpack == "1":
            idx = np.where(idx != 0, 255, 0).astype(np.uint8)
        return to_rgba(dib.mode, idx, dib.palette)
    px = px[:, : width * bits // 8].reshape(rows, width, bits // 8)
    out = np.full((rows, width, 4), 255, np.uint8)
    if bits == 24:
        out[..., :3] = px[..., ::-1]
        return out
    value = np.ascontiguousarray(px).view("<u4")[..., 0]
    for ch, mask in enumerate(dib.unpack):
        if mask:
            out[..., ch] = (value >> (mask.bit_length() - 8)) & 0xFF
    return out


def open_bmp(raw: bytes) -> Dib:
    """BmpImageFile._open: the file header, then the DIB at byte 14."""
    if raw[:2] != b"BM":
        raise ValueError("not a BMP file")
    (offset,) = struct.unpack_from("<I", raw, 10) if len(raw) >= 14 else (None,)
    if offset is None:
        raise NotThisFormat("BMP file header is cut short")
    return _sized(read_dib(raw, 14, offset))


def open_dib(raw: bytes) -> Dib:
    """DibImageFile._open: a DIB header at byte 0, no file header."""
    return _sized(read_dib(raw, 0, what="DIB"))


def _sized(dib: Dib) -> Dib:
    if dib.width <= 0 or dib.height <= 0:
        raise NotThisFormat(f"bitmap of size {dib.width}x{dib.height}")
    return dib


def tga_refusal(raw: bytes):
    """Why Pillow's TgaImagePlugin turns the file away (SyntaxError or
    IndexError: Image.open tries the next plugin), or None."""
    if len(raw) < 18:
        return "TGA header is cut short"
    map_type, kind, depth = raw[1], raw[2], raw[16]
    width, height = struct.unpack_from("<HH", raw, 12)
    if map_type not in (0, 1) or width == 0 or height == 0 or depth not in (1, 8, 16, 24, 32):
        return "not a TGA file"
    if kind not in (1, 2, 3, 9, 10, 11):
        return f"TGA image type {kind}"
    if map_type and raw[7] not in (16, 24, 32):
        return f"TGA colour map of {raw[7]} bits"
    return None


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
    if base == 2 and depth not in (24, 32) or base == 3 and depth not in (8, 16) and (
            depth != 1 or kind & 8) or base == 1 and depth != 8:
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
    if depth == 1:  # Pillow's raw "1": rows of whole bytes, a set bit white
        stride = (width + 7) // 8
        rows = np.frombuffer(raw, np.uint8, count=stride * height, offset=pos)
        px = (unpack_bits(rows.reshape(height, stride), 1, width) * 255).reshape(n, 1)
    elif kind & 8:
        px = _tga_rle(raw, pos, n, size)
    else:
        px = np.frombuffer(raw, np.uint8, count=n * size, offset=pos).reshape(n, size)
    px = px.reshape(height, width, -1)
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
