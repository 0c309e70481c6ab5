"""NumPy decoders of Windows BMP, the bare DIB and Truevision TGA
images, for scene textures and LDR skyboxes.

The JAX package reads them through Pillow (`Image.open(...).convert("RGBA")`);
these give the same uint8 [H, W, 4]:

- The DIB core (`read_dib`, `dib_rgba`), Pillow's BmpImagePlugin
  `_bitmap`, which BMP, the bare DIB (`DibImageFile`, a BMP without its
  14-byte file header) and the bitmaps of ICO and CUR files
  (utils/ico.py) share: the 12-byte OS/2 core header (16-bit width and
  height, 3-byte palette entries, no compression, always bottom-up), the
  40-byte BITMAPINFOHEADER and its longer forms (52, 56, 64, V4's 108 and
  V5's 124 bytes); 24 bits a pixel; 16 bits uncompressed (Pillow's
  "BGR;15": 5 bits a channel, x * 255 // 31) or with the bit fields
  0x7C00/0x3E0/0x1F ("BGR;15") or 0xF800/0x7E0/0x1F ("BGR;16"); 32 bits
  uncompressed (the fourth byte ignored, alpha 255, as Pillow reads it;
  alpha where a CUR's bitmap starts at byte 22) or with BI_BITFIELDS masks
  of whole bytes (alpha where a mask names it); 1, 4 and 8-bit palettes,
  and Pillow's reading of a grey palette: two entries black and white ->
  its mode "1" (one bit a pixel, whatever the depth), entries i = (i, i,
  i) -> mode "L" (one byte a pixel, whatever the depth; Pillow refuses
  the rows that are narrower than that); rows bottom-up, or top-down where
  the height's top byte is 0xFF. The pixel data ends where Pillow's raw
  decoder stops: the last row needs no padding.
- RLE8 and RLE4 (`rle_indices`), as Pillow's Python `BmpRleDecoder` reads
  them, quirks included: a run past the row's end is cut there (the
  column stays at the row's end), an absolute run is not cut and RLE4's
  reads count // 2 bytes, the word padding after it follows the byte's
  position in the whole file, a delta skips two bytes and reads its
  (right, up) from the next two, and a stream that ends, or ends the
  bitmap, before every pixel is filled is refused ("not enough image
  data", ValueError), as Pillow refuses it.
- BMP: the file header's pixel offset (moved past 4 bytes a palette
  entry where it points at the palette, as Pillow moves it, also for the
  3-byte entries of the OS/2 header); the bare DIB: the pixels right
  after the header, its masks and its palette.
- TGA: true colour (types 2 and 10) at 16 bits (Pillow's "BGRA;15Z": 5
  bits a channel, alpha 0 where the top bit is set, else 255; the
  descriptor's attribute bits ignored), 24 and 32 bits (alpha kept), grey
  (types 3 and 11) at 8 bits and 16 (grey + alpha) and uncompressed at 1
  bit (Pillow's mode "1"), colour-mapped (types 1 and 9) with 8-bit
  indices into a 24-bit map or a 16-bit one ("BGRA;15Z" entries);
  run-length coding (types 9-11); the origin bits (top or bottom, left or
  right).

Pillow refuses, and so does the port (NotImplementedError naming the
variant): 16-bit bit fields other than those two, 24- and 32-bit masks
outside its list, BI_JPEG and BI_PNG, depths other than 1, 4, 8, 16, 24
and 32, and 32-bit TGA colour maps (no raw mode for them in Pillow 12).
A header that
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
from rustic_tpu_torch.utils.modes import check_pixels, note_core, to_rgba, unpack_bits

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
# the 16-bit (R, G, B) bit-field masks Pillow reads, and its raw mode of each
_BMP_MASKS16 = {(0xF800, 0x7E0, 0x1F): "BGR;16", (0x7C00, 0x3E0, 0x1F): "BGR;15"}


def _refuse(variant: str):
    raise NotImplementedError(f"{variant} is not decoded ({FORMATS_TODO})")


class Dib(NamedTuple):
    """A DIB header as Pillow's `_bitmap` reads it."""
    width: int
    height: int  # the header's rows (ICO and CUR halve them)
    mode: str  # Pillow's image mode: "1", "L", "P", "RGB" or "RGBA"
    unpack: object  # a row's samples: "1", "L", "P;1", "P;4", "P", "BGR", "BGR;15",
    # "BGR;16" or 32-bit RGBA masks
    palette: object  # uint8 [256, 3] for mode "P"
    offset: int  # where the rows start
    stride: int  # bytes a row in the file
    top_down: bool
    rle: int = 0  # 8 or 4 for BI_RLE8 / BI_RLE4


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
    if header not in DIB_HEADERS:
        _refuse(f"{what} with a {header}-byte header")
    hd = raw[pos + 4 : pos + header]
    entry = 4  # bytes a palette entry
    if header == 12:  # OS/2 1.x / BITMAPCOREHEADER: 16-bit sizes, 3-byte entries, bottom-up
        width, height, _planes, bits = struct.unpack_from("<HHHH", hd)
        top_down, compression, colors, entry = False, _BI_RGB, 0, 3
    else:
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
    rle = 0
    if compression == _BI_BITFIELDS:
        if bits == 16 and masks[:3] not in _BMP_MASKS16 or bits == 24 and masks[:3] != _BGRX[:3] \
                or bits == 32 and masks not in _BMP_MASKS:
            _refuse(f"{what} bit fields {tuple(hex(m) for m in masks[:4 if bits == 32 else 3])}")
        if bits < 16:
            _refuse(f"{what} bit fields on a {bits}-bit palette image")
        unpack = {16: _BMP_MASKS16.get(masks[:3]), 24: "BGR"}.get(
            bits, _BGRA if masks == (0, 0, 0, 0) else masks)
    elif compression in (_BI_RGB, _BI_RLE8, _BI_RLE4):
        unpack = {16: "BGR;15", 24: "BGR", 32: _BGRA if cur_start == 22 else _BGRX}.get(
            bits, f"P;{bits}")
        rle = {_BI_RLE8: 8, _BI_RLE4: 4}.get(compression, 0)
    else:
        _refuse(f"{what} compression {compression}")
    mode = "RGBA" if bits == 32 and unpack[3] else "RGB"
    palette = None
    if bits <= 8:
        unpack = "P" if bits == 8 else unpack
        if not 0 < colors <= 65536:
            _refuse(f"{what} palette of {colors} colours")
        entries = raw[cursor : cursor + entry * colors]
        cursor += len(entries)
        mode = _grey(entries, colors, entry) or "P"
        if mode != "P":
            unpack = mode
        else:
            n = len(entries) // entry  # the entries the file holds
            if n > 256:  # Pillow's putpalette: "invalid palette size"
                raise ValueError(f"{what} palette of {n} colours is longer than 256")
            palette = np.zeros((256, 3), np.uint8)
            palette[:n] = np.frombuffer(entries, np.uint8, count=entry * n).reshape(
                n, entry)[:, 2::-1]
    stride = ((width * bits + 31) >> 3) & ~3
    return Dib(width, height, mode, unpack, palette, offset or cursor, stride, top_down, rle)


def _grey(entries: bytes, colors: int, entry: int = 4):
    """Pillow's test of a palette of `entry`-byte entries: "1" where its
    two entries are black and white, "L" where entry i is (i, i, i) for
    every i, else None."""
    want = np.array((0, 255) if colors == 2 else np.arange(colors) & 0xFF, np.uint8)
    if len(entries) < entry * (colors - 1) + 3:
        return None
    pal = np.frombuffer(entries + b"\0", np.uint8, count=entry * colors).reshape(
        colors, entry)[:, :3]
    if not (pal == want[:, None]).all():
        return None
    return "1" if colors == 2 else "L"


def rle_indices(raw: bytes, pos: int, width: int, height: int, rle4: bool) -> np.ndarray:
    """BmpRleDecoder.decode from byte `pos` of the whole file (its word
    padding follows the file's positions; the loop is csrc/image_entropy.cpp
    `bmp_rle`) -> uint8 [height, width] of samples, in the file's row
    order. Every pixel must be filled."""
    from rustic_tpu_torch.utils import _entropy

    check_pixels(width, height, "RLE-compressed bitmap")
    want = width * height
    buf = np.frombuffer(raw, np.uint8)
    out = np.zeros(want + 512, np.uint8)
    n = _entropy.library().bmp_rle(_entropy.ptr(buf), len(buf), pos, width, want, int(rle4),
                                   _entropy.ptr(out), len(out))
    if n < 0:
        raise ValueError("BMP RLE delta is cut short")  # Pillow: unpacking its (right, up) fails
    if n < want:
        raise ValueError("not enough image data")  # Pillow's set_as_raw
    return out[:want].reshape(height, width)


def dib_rgba(raw: bytes, dib: Dib, rows: int = None) -> np.ndarray:
    """The first `rows` rows (default: all) of a DIB's pixels, as Pillow's
    raw decoder lays them into an image that many rows high -> uint8
    [rows, W, 4] (the mode's RGBA)."""
    rows = dib.height if rows is None else rows
    width, stride = dib.width, dib.stride
    if dib.rle:
        if dib.mode not in ("P", "L"):  # Pillow's raw "P" into another mode
            raise ValueError("unknown raw mode for given image mode")
        idx = rle_indices(raw, dib.offset, width, rows, dib.rle == 4)
        return to_rgba(dib.mode, idx if dib.top_down else idx[::-1], dib.palette)
    bits = {"1": 1, "L": 8, "P;1": 1, "P;4": 4, "P": 8, "BGR": 24, "BGR;15": 16,
            "BGR;16": 16}.get(dib.unpack, 32)
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
    note_core(dib.mode)
    out = np.full((rows, width, 4), 255, np.uint8)
    if bits == 24:
        out[..., :3] = px[..., ::-1]
        return out
    if bits == 16:
        return _rgb16(np.ascontiguousarray(px).view("<u2")[..., 0], dib.unpack == "BGR;16")
    value = np.ascontiguousarray(px).view("<u4")[..., 0]
    for ch, mask in enumerate(dib.unpack):
        if mask:
            out[..., ch] = (value >> (mask.bit_length() - 8)) & 0xFF
    return out


def _rgb16(value: np.ndarray, green6: bool = False, alpha: bool = False) -> np.ndarray:
    """16-bit pixels -> uint8 [..., 4] as Pillow unpacks "BGR;15" (5 bits a
    channel), "BGR;16" (`green6`: 5, 6, 5) and "BGRA;15Z" (`alpha`: 0 where
    the top bit is set, else 255); each channel x * 255 // (2^bits - 1)."""
    v = value.astype(np.int64)
    out = np.full(value.shape + (4,), 255, np.uint8)
    out[..., 0] = ((v >> (11 if green6 else 10)) & 31) * 255 // 31
    out[..., 1] = ((v >> 5) & 63) * 255 // 63 if green6 else ((v >> 5) & 31) * 255 // 31
    out[..., 2] = (v & 31) * 255 // 31
    if alpha:
        out[..., 3] = np.where(v >> 15, 0, 255)
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


def _tga_core(base, depth, px, palette):
    """Pillow's mode of a TGA image and its one band's samples."""
    if base == 2:
        return ("RGBA" if depth in (16, 32) else "RGB"),
    if base == 3:
        return ("LA",) if depth == 16 else ("1" if depth == 1 else "L", px[..., 0])
    if palette is None:
        return "L", px[..., 0]
    return "P", px[..., 0], palette[:, :3]


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
    if base == 2 and depth not in (16, 24, 32) or base == 3 and depth not in (8, 16) and (
            depth != 1 or kind & 8) or base == 1 and depth != 8:
        _refuse(f"{depth}-bit TGA of type {kind}")
    pos = 18 + id_len
    palette = None
    if map_type:
        if map_depth not in (16, 24):  # Pillow 12 has no raw mode for a 32-bit map
            _refuse(f"TGA with a {map_depth}-bit colour map")
        size = map_depth // 8
        entries = np.frombuffer(raw, np.uint8, count=size * map_len, offset=pos)
        palette = np.zeros((max(256, map_start + map_len), 4), np.uint8)
        palette[:, 3] = 255
        if map_depth == 16:  # "BGRA;15Z" entries, an RGBA palette
            palette[map_start : map_start + map_len] = _rgb16(entries.view("<u2"), alpha=True)
        else:
            palette[map_start : map_start + map_len, :3] = entries.reshape(map_len, 3)[:, ::-1]
        pos += size * map_len
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
    note_core(*_tga_core(base, depth, px, palette))
    out = np.full((height, width, 4), 255, np.uint8)
    if base == 2 and depth == 16:
        out[:] = _rgb16(np.ascontiguousarray(px).view("<u2")[..., 0], alpha=True)
    elif base == 2:
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
        out[:] = palette[px[..., 0]]
    return out
