"""A DirectDraw Surface (DDS) decoder for scene textures and LDR skyboxes,
as Pillow 12.1.0 reads these files (PIL/DdsImagePlugin.py and its C
block decoder BcnDecode.c).

The JAX package opens a DDS with Pillow and converts it to RGBA; this
module gives the same uint8 [H, W, 4]. It reads the 124-byte header and
the first surface that follows it (mipmaps, cube faces, array slices
and depth are ignored, as Pillow ignores them):

- DDPF_RGB, with or without DDPF_ALPHAPIXELS: 3 or 4 channel masks over
  little-endian pixels of bitcount // 8 bytes. Each channel is Pillow's
  `int(((v & m) >> shift) / (m >> shift) * 255)`, in float64 and cut
  toward zero (0 for a zero mask); 3 masks give alpha 255.
- DDPF_LUMINANCE at 8 bits (L) and at 16 bits with DDPF_ALPHAPIXELS
  (L, then A).
- DDPF_PALETTEINDEXED8: a 1024-byte RGBA palette after the header, then
  one index a pixel.
- FourCC DXT1, DXT3, DXT5 (BC1-BC3), ATI1/BC4U (BC4, grey), ATI2/BC5U
  and BC5S (BC5: red and green, blue 0, or 128 for the signed form), and
  the DX10 extension with the DXGI formats BC1-BC5 (TYPELESS, UNORM,
  BC5 SNORM), BC6H (UF16, SF16), BC7 (TYPELESS, UNORM, UNORM_SRGB) and
  R8G8B8A8 (TYPELESS, UNORM, UNORM_SRGB). The sRGB formats reach Pillow
  only as info["gamma"]: their pixels are read as they are.

BC1-BC5 are decoded here in NumPy, over every block at once; BC6H and
BC7 in host C++ (csrc/bcn_decode.cpp, built by g++ at first use). Each
follows BcnDecode.c, not the specifications where the two differ: BC1's
three-colour mode (c0 <= c1, its fourth colour transparent black) only
in BC1 itself, 565 expanded by bit replication, the 1/3 and 2/3 (and
1/2) interpolants cut toward zero, the same for the 1/7 and 1/5 steps of
BC3-BC5's 8- and 6-value modes, a signed endpoint mapped to its value +
128 before the same interpolation, BC7's reserved mode (a first byte of
0) opaque black, BC6H's reserved modes black, and BC6H's half floats
clamped to [0, 1] and cut toward zero after times 255. Blocks that
overhang the right or bottom edge are cropped.

Where Pillow raises, this module raises at the same point: a header
size other than 124, 16-bit luminance without alpha, another bitcount
of luminance, FourCCs and DXGI formats Pillow does not list, unknown
pixel-format flags. Those Pillow calls unimplemented raise
NotImplementedError naming the variant and FORMATS_TODO; a truncated or
malformed file raises ValueError (Pillow reads a truncated DDPF_RGB
surface as if it ended in zeros, and so does the port); a size of zero
raises NotThisFormat (Image.open passes the file on), a decompression
bomb ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO, NotThisFormat, _entropy
from rustic_tpu_torch.utils._entropy import ptr
from rustic_tpu_torch.utils.modes import check_pixels

DDS_SIGNATURE = b"DDS "
_ALPHAPIXELS, _FOURCC, _PALETTE, _RGB, _LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000
_HEADER_END = 128  # the signature and the 124-byte header

# FourCC -> block kind
_FOURCCS = {b"DXT1": "BC1", b"DXT3": "BC2", b"DXT5": "BC3", b"BC4U": "BC4", b"ATI1": "BC4",
            b"BC5S": "BC5S", b"BC5U": "BC5", b"ATI2": "BC5"}
# DXGI format -> block kind, or "RGBA" for 8-bit RGBA pixels
_DXGI = {70: "BC1", 71: "BC1", 73: "BC2", 74: "BC2", 76: "BC3", 77: "BC3", 79: "BC4", 80: "BC4",
         82: "BC5", 83: "BC5", 84: "BC5S", 95: "BC6H", 96: "BC6HS", 97: "BC7", 98: "BC7",
         99: "BC7", 27: "RGBA", 28: "RGBA", 29: "RGBA"}
_BLOCK_BYTES = {"BC1": 8, "BC4": 8}  # every other kind: 16
_CPP_KINDS = {"BC6H": 0, "BC6HS": 1, "BC7": 2}


def _refuse(variant: str):
    raise NotImplementedError(f"DDS {variant} is not decoded ({FORMATS_TODO})")


class _Opened(Exception):
    """The header is read (`open_dds`)."""


def _opened(width: int, height: int, stop: bool):
    """What Image.open checks once DdsImageFile._open has read the header:
    a size of zero passes the file on (ImageFile's SyntaxError for an
    empty size), a decompression bomb ends the open; `stop`: the open is all
    that was asked for."""
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"DDS of size {width}x{height}")
    check_pixels(width, height, "DDS")
    if stop:
        raise _Opened


def open_dds(raw: bytes):
    """DdsImageFile._open and Image.open's checks after it (utils/png.py
    runs it at the open, as Pillow does)."""
    try:
        decode_dds(raw, _stop=True)
    except _Opened:
        return None


def _bytes(raw: bytes, start: int, count: int) -> np.ndarray:
    if start + count > len(raw):
        raise ValueError(f"DDS surface is truncated: {count} bytes from {start}, "
                         f"the file ends at {len(raw)}")
    return np.frombuffer(raw, np.uint8, count=count, offset=start)


# ---- BC1-BC5 in NumPy: every block of the surface at once ------------------------------------

def _bits(words: np.ndarray, n: int, width: int) -> np.ndarray:
    """[nb] integers -> [nb, n] fields of `width` bits, lowest first."""
    shifts = np.arange(n, dtype=np.uint64) * np.uint64(width)
    return ((words.astype(np.uint64)[:, None] >> shifts) & np.uint64((1 << width) - 1)).astype(
        np.int64)


def _le(b: np.ndarray) -> np.ndarray:
    """uint8 [nb, k] -> the little-endian integers [nb] (k <= 8)."""
    out = np.zeros(len(b), np.uint64)
    for i in range(b.shape[1]):
        out |= b[:, i].astype(np.uint64) << np.uint64(8 * i)
    return out


def _rgb565(c: np.ndarray) -> np.ndarray:
    """[nb] 565 colours -> int64 [nb, 3], each channel widened by
    replicating its high bits."""
    r = (c & 0xF800) >> 8
    g = (c & 0x7E0) >> 3
    b = (c & 0x1F) << 3
    return np.stack([r | r >> 5, g | g >> 6, b | b >> 5], -1)


def _bc1_colour(blocks: np.ndarray, separate_alpha: bool) -> np.ndarray:
    """uint8 [nb, 8] colour blocks -> uint8 [nb, 16, 4]."""
    c0 = _le(blocks[:, 0:2]).astype(np.int64)
    c1 = _le(blocks[:, 2:4]).astype(np.int64)
    e0, e1 = _rgb565(c0), _rgb565(c1)
    four = (c0 > c1) | separate_alpha
    pal = np.empty((len(blocks), 4, 4), np.int64)
    pal[:, 0, :3], pal[:, 1, :3] = e0, e1
    pal[:, 2, :3] = np.where(four[:, None], (2 * e0 + e1) // 3, (e0 + e1) // 2)
    pal[:, 3, :3] = np.where(four[:, None], (e0 + 2 * e1) // 3, 0)
    pal[:, :3, 3] = 255
    pal[:, 3, 3] = np.where(four, 255, 0)
    idx = _bits(_le(blocks[:, 4:8]), 16, 2)
    return np.take_along_axis(pal, idx[:, :, None], 1).astype(np.uint8)


def _bc3_channel(blocks: np.ndarray, signed: bool) -> np.ndarray:
    """uint8 [nb, 8] alpha / BC4 blocks -> uint8 [nb, 16]."""
    a0 = blocks[:, 0:1].astype(np.int64)
    a1 = blocks[:, 1:2].astype(np.int64)
    if signed:  # two's complement bytes, mapped to value + 128
        a0, a1 = a0 ^ 0x80, a1 ^ 0x80
    k7, k5 = np.arange(1, 7), np.arange(1, 5)
    eight = ((7 - k7) * a0 + k7 * a1) // 7
    six = np.concatenate([((5 - k5) * a0 + k5 * a1) // 5, 0 * a0, 0 * a0 + 255], 1)
    pal = np.concatenate([a0, a1, np.where(a0 > a1, eight, six)], 1)
    idx = _bits(_le(blocks[:, 2:8]), 16, 3)
    return np.take_along_axis(pal, idx, 1).astype(np.uint8)


def _bc2_alpha(blocks: np.ndarray) -> np.ndarray:
    """uint8 [nb, 8] explicit 4-bit alphas -> uint8 [nb, 16]."""
    nib = np.stack([blocks & 0xF, blocks >> 4], -1).reshape(len(blocks), 16)
    return nib * np.uint8(17)


def _decode_blocks(kind: str, blocks: np.ndarray) -> np.ndarray:
    """uint8 [nb, block bytes] -> uint8 [nb, 16, 4] RGBA as Pillow's
    convert("RGBA") leaves it (grey for BC4, alpha 255 for BC4-BC6H)."""
    nb = len(blocks)
    if kind in _CPP_KINDS:
        out = np.empty((nb, 16, 4), np.uint8)
        blocks = np.ascontiguousarray(blocks)
        if _entropy.bcn_library().bcn_blocks(ptr(blocks), nb, _CPP_KINDS[kind], ptr(out)) != 0:
            raise ValueError(f"DDS {kind} blocks were not decoded")
        return out
    if kind == "BC1":
        return _bc1_colour(blocks, False)
    if kind in ("BC2", "BC3"):
        out = _bc1_colour(blocks[:, 8:16], True)
        out[..., 3] = _bc2_alpha(blocks[:, 0:8]) if kind == "BC2" else _bc3_channel(
            blocks[:, 0:8], False)
        return out
    out = np.full((nb, 16, 4), 255, np.uint8)
    if kind == "BC4":
        out[..., 0:3] = _bc3_channel(blocks, False)[..., None]
        return out
    signed = kind == "BC5S"
    out[..., 0] = _bc3_channel(blocks[:, 0:8], signed)
    out[..., 1] = _bc3_channel(blocks[:, 8:16], signed)
    out[..., 2] = 128 if signed else 0
    return out


def _surface(kind: str, raw: bytes, start: int, width: int, height: int) -> np.ndarray:
    bw, bh = -(-width // 4), -(-height // 4)
    size = _BLOCK_BYTES.get(kind, 16)
    blocks = _bytes(raw, start, bw * bh * size).reshape(bw * bh, size)
    px = _decode_blocks(kind, blocks).reshape(bh, bw, 4, 4, 4)
    return px.transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, 4)[:height, :width]


# ---- uncompressed surfaces --------------------------------------------------------------------

def _masked(raw: bytes, width: int, height: int, bitcount: int, masks) -> np.ndarray:
    """DDPF_RGB pixels, as Pillow's DdsRgbDecoder reads them."""
    nbytes = bitcount // 8
    n = width * height
    if nbytes == 0:
        value = np.zeros(n, np.uint64)
    else:
        # each pixel's first 4 bytes (the masks are 32 bits: the bytes above never count); a
        # surface cut short reads on in zeros (Pillow: a missing read is int.from_bytes(b""))
        k = min(nbytes, 4)
        at = _HEADER_END + np.arange(n, dtype=np.int64)[:, None] * nbytes + np.arange(k)
        data = np.concatenate([np.frombuffer(raw, np.uint8), np.zeros(1, np.uint8)])
        px = data[np.minimum(at, len(raw))]
        value = _le(px)
    out = np.full((height, width, 4), 255, np.uint8)
    for i, mask in enumerate(masks):
        if mask == 0:
            out[..., i] = 0
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        v = ((value & np.uint64(mask)) >> np.uint64(shift)).astype(np.float64)
        out[..., i] = ((v / total) * 255).astype(np.uint8).reshape(height, width)
    return out


def decode_dds(raw: bytes, _stop: bool = False) -> np.ndarray:
    """DDS bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA")."""
    raw = bytes(raw)
    if raw[:4] != DDS_SIGNATURE:
        raise ValueError("not a DDS file")
    if len(raw) < 8:
        raise ValueError("DDS header is truncated")
    (header_size,) = struct.unpack("<I", raw[4:8])
    if header_size != 124:
        _refuse(f"header size {header_size}")
    if len(raw) < _HEADER_END:
        raise ValueError(f"DDS header is truncated: {len(raw) - 8} of 120 bytes")
    height, width = struct.unpack("<2I", raw[12:20])
    pfflags, = struct.unpack("<I", raw[80:84])
    fourcc = raw[84:88]
    bitcount, = struct.unpack("<I", raw[88:92])
    if pfflags & _RGB:
        count = 4 if pfflags & _ALPHAPIXELS else 3
        _opened(width, height, _stop)
        return _masked(raw, width, height, bitcount, struct.unpack(f"<{count}I",
                                                                 raw[92 : 92 + 4 * count]))
    n = width * height
    if pfflags & _LUMINANCE:
        if bitcount == 8:
            _opened(width, height, _stop)
            grey, alpha = _bytes(raw, _HEADER_END, n).reshape(height, width), 255
        elif bitcount == 16 and pfflags & _ALPHAPIXELS:
            _opened(width, height, _stop)
            la = _bytes(raw, _HEADER_END, 2 * n).reshape(height, width, 2)
            grey, alpha = la[..., 0], la[..., 1]
        else:
            _refuse(f"luminance at {bitcount} bits (pixel-format flags {pfflags:#x})")
        _opened(width, height, _stop)
        out = np.empty((height, width, 4), np.uint8)
        out[..., 0:3] = grey[..., None]
        out[..., 3] = alpha
        return out
    if pfflags & _PALETTE:
        _opened(width, height, _stop)
        palette = _bytes(raw, _HEADER_END, 1024).reshape(256, 4)
        return palette[_bytes(raw, _HEADER_END + 1024, n).reshape(height, width)]
    if not pfflags & _FOURCC:
        _refuse(f"pixel-format flags {pfflags:#x}")
    if fourcc in _FOURCCS:
        _opened(width, height, _stop)
        return _surface(_FOURCCS[fourcc], raw, _HEADER_END, width, height)
    if fourcc != b"DX10":
        _refuse(f"pixel format {fourcc!r}")
    if len(raw) < _HEADER_END + 20:
        raise ValueError("DDS DX10 header is truncated")
    (dxgi,) = struct.unpack("<I", raw[_HEADER_END : _HEADER_END + 4])
    if dxgi not in _DXGI:
        _refuse(f"DXGI format {dxgi}")
    start = _HEADER_END + 20
    _opened(width, height, _stop)
    if _DXGI[dxgi] == "RGBA":
        return _bytes(raw, start, 4 * n).reshape(height, width, 4).copy()
    return _surface(_DXGI[dxgi], raw, start, width, height)
