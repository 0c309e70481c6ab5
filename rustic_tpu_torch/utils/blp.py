"""A Blizzard Mipmap (BLP1, BLP2) decoder, as Pillow 12.1.0 reads it
(PIL/BlpImagePlugin.py) and converts it to RGBA. Only mipmap 0 is read.

The header gives the size and whether the image has alpha ("RGBA" if so,
else "RGB"); then 16 mipmap offsets and 16 lengths. BLP1 (its data read
from byte 156):
- compression 0: a JPEG, its shared header (a length and that many
  bytes) joined to mipmap 0's bytes, decoded (utils/jpeg.py; four
  components as CMYK, never YCCK, as Pillow forces), taken as RGB bytes
  and read back as BGR: red and blue swap, as in Pillow;
- compression 1, encoding 4 or 5: a 256-entry BGRA palette, then
  mipmap 0's bytes (read straight after the palette) as indices.
BLP2 (data at mipmap 0's offset, after the palette at byte 148):
- encoding 1: palette indices, as BLP1's; the palette's alpha is the
  pixel's where the header's alpha depth is not 0;
- encoding 2: DXT1 (alpha encoding 0; with alpha, colour index 3 of a
  three-colour block is transparent black), DXT3 (1) or DXT5 (7), as the
  plugin's own Python block decoders read them: 565 endpoints widened by
  a shift alone (no bit replication), interpolated with floor division,
  DXT3 always in four-colour mode; their alphas are DDS's.
Pixels are laid out as Pillow's raw reader lays the decoded bytes: the
blocks' rows, each a whole number of blocks wide, are joined and read
row by row at the image's width and bytes a pixel (3 for "RGB", 4 for
"RGBA"), so a width that is not a multiple of 4, or a DXT3/DXT5 image
without alpha, reads the bytes skewed as Pillow does.

A file cut short in its header raises an error of PASSED_ON (the file passes on);
in its tables or data, ValueError. What Pillow refuses (BLPFormatError,
a NotImplementedError that ends the open: BLP1 compression other than 0
and 1 or encoding other than 4 and 5, BLP2 compression other than 1,
encodings other than 1 and 2, which leaves out raw BGRA (3), and alpha
encodings other than 0, 1 and 7) raises NotImplementedError naming it.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO, PASSED_ON, jpeg
from rustic_tpu_torch.utils.dds import _bc2_alpha, _bc3_channel, _bits, _le
from rustic_tpu_torch.utils.modes import check_pixels, to_rgba


class Blp(NamedTuple):
    version: int  # 1 or 2
    compression: int
    encoding: int
    alpha: bool
    alpha_encoding: int  # BLP2's, else 0
    width: int
    height: int


def accept(prefix: bytes) -> bool:
    return prefix.startswith((b"BLP1", b"BLP2"))


def open_blp(raw: bytes) -> Blp:
    """BlpImageFile._open -> Blp."""
    if not accept(raw[:4]):
        raise NotImplementedError(f"bad BLP magic {raw[:4]!r} ({FORMATS_TODO})")
    (compression,) = struct.unpack_from("<i", raw, 4)
    if raw[3:4] == b"1":
        alpha, alpha_encoding = struct.unpack_from("<I", raw, 8)[0] != 0, 0
        width, height, encoding = struct.unpack_from("<IIi", raw, 12)
        version = 1
    else:
        encoding, alpha, alpha_encoding = struct.unpack_from("<bbb", raw, 8)
        alpha = alpha != 0
        width, height = struct.unpack_from("<II", raw, 12)
        version = 2
    if width == 0 or height == 0:
        raise SyntaxError(f"BLP of size {width}x{height}")
    check_pixels(width, height, "BLP")
    return Blp(version, compression, encoding, alpha, alpha_encoding, width, height)


def _refuse(variant: str):
    raise NotImplementedError(f"BLP {variant}, which Pillow refuses, is not decoded "
                              f"({FORMATS_TODO})")


def _read(raw: bytes, pos: int, n: int) -> bytes:
    """ImageFile._safe_read: n bytes from pos, or the file is truncated."""
    if n <= 0:
        return b""
    if pos + n > len(raw):
        raise ValueError(f"BLP file is truncated: {n} bytes from {pos}, the file ends at "
                         f"{len(raw)}")
    return raw[pos : pos + n]


def _jpeg_rgb(data: bytes) -> np.ndarray:
    """A BLP1 JPEG as Pillow reads it: a JpegImageFile of its bytes (its
    header errors end the load), four components read as CMYK whatever the
    file's Adobe segment says, converted to RGB."""
    try:
        jpeg.open_jpeg(data)
    except (*PASSED_ON, OSError) as e:
        raise ValueError(f"BLP1 JPEG: {type(e).__name__}: {e}") from e
    return jpeg.decode_jpeg(data, cmyk=True)[..., :3]


def _palette(raw: bytes, pos: int) -> np.ndarray:
    """256 BGRA entries -> uint8 [256, 4] RGBA."""
    bgra = np.frombuffer(_read(raw, pos, 1024), np.uint8).reshape(256, 4)
    return bgra[:, [2, 1, 0, 3]]


def _indexed(raw: bytes, pos: int, length: int, palette: np.ndarray, alpha: bool) -> bytes:
    idx = np.frombuffer(_read(raw, pos, length), np.uint8)
    return palette[idx][:, : 4 if alpha else 3].tobytes()


def _unpack_565(c: np.ndarray) -> np.ndarray:
    return np.stack([((c >> 11) & 0x1F) << 3, ((c >> 5) & 0x3F) << 2, (c & 0x1F) << 3], -1)


def _colours(c0: np.ndarray, c1: np.ndarray, codes: np.ndarray, three: np.ndarray):
    """[nb] endpoints, [nb, 16] codes -> int64 [nb, 16, 3] colours and the
    [nb, 16] mask of transparent texels (code 3 where `three`)."""
    e0, e1 = _unpack_565(c0), _unpack_565(c1)
    pal = np.stack([e0, e1,
                    np.where(three[:, None], (e0 + e1) // 2, (2 * e0 + e1) // 3),
                    np.where(three[:, None], 0, (2 * e1 + e0) // 3)], 1)
    rgb = np.take_along_axis(pal, codes[:, :, None], 1)
    return rgb, three[:, None] & (codes == 3)


def dxt_blocks(kind: int, blocks: np.ndarray, alpha: bool = True) -> np.ndarray:
    """uint8 [nb, 8 or 16] blocks -> uint8 [nb, 16, 3 or 4] texels in
    row-major order, as BlpImagePlugin's decode_dxt1 (kind 0; 3 bytes a
    texel where `alpha` is false), decode_dxt3 (1) and decode_dxt5 (7). The
    alphas are DDS's (utils/dds.py: DXT3's nibbles times 17, DXT5's
    interpolation), the colours the plugin's own."""
    c0 = _le(blocks[:, -8:-6]).astype(np.int64)
    c1 = _le(blocks[:, -6:-4]).astype(np.int64)
    codes = _bits(_le(blocks[:, -4:]), 16, 2)
    three = (c0 <= c1) if kind == 0 else np.zeros(len(blocks), bool)
    rgb, clear = _colours(c0, c1, codes, three)
    if kind == 0:
        if not alpha:
            return rgb.astype(np.uint8)
        a = np.where(clear, 0, 255)
    elif kind == 1:
        a = _bc2_alpha(blocks[:, :8])
    else:
        a = _bc3_channel(blocks[:, :8], False)
    return np.concatenate([rgb, a[..., None]], -1).astype(np.uint8)


def _dxt(raw: bytes, pos: int, b: Blp) -> bytes:
    size = 8 if b.alpha_encoding == 0 else 16
    bw, bh = (b.width + 3) // 4, (b.height + 3) // 4
    blocks = np.frombuffer(_read(raw, pos, bw * bh * size), np.uint8).reshape(bw * bh, size)
    texels = dxt_blocks(b.alpha_encoding, blocks, b.alpha)
    # [bh, bw, 4 rows, 4 columns, bytes]: rows of blocks, each a run of 4 pixel rows
    return texels.reshape(bh, bw, 4, 4, -1).transpose(0, 2, 1, 3, 4).tobytes()


def decode_blp(raw: bytes, b: Blp = None) -> np.ndarray:
    """BLP bytes (or their `open_blp` header) -> uint8 [H, W, 4]."""
    raw = bytes(raw)
    b = b or open_blp(raw)
    start = 28 if b.version == 1 else 20
    tables = struct.unpack("<32I", _read(raw, start, 128))
    offset0, length0 = tables[0], tables[16]
    pos = start + 128
    rawmode = None
    if b.version == 1:
        if b.compression == 0:
            (header_size,) = struct.unpack("<I", _read(raw, pos, 4))
            header = _read(raw, pos + 4, header_size)
            pos += 4 + header_size
            pos += len(_read(raw, pos, offset0 - pos))
            rgb = _jpeg_rgb(header + _read(raw, pos, length0))
            data, rawmode = rgb.tobytes(), "BGR"
        elif b.compression == 1:
            if b.encoding not in (4, 5):
                _refuse(f"BLP1 encoding {b.encoding}")
            data = _indexed(raw, pos + 1024, length0, _palette(raw, pos), b.alpha)
        else:
            _refuse(f"BLP1 compression {b.compression}")
    else:
        palette = _palette(raw, pos)
        if b.compression != 1:
            _refuse(f"BLP2 compression {b.compression}")
        if b.encoding == 1:
            data = _indexed(raw, offset0, length0, palette, b.alpha)
        elif b.encoding == 2:
            if b.alpha_encoding not in (0, 1, 7):
                _refuse(f"BLP2 alpha encoding {b.alpha_encoding}")
            data = _dxt(raw, offset0, b)
        else:
            _refuse(f"BLP2 encoding {b.encoding}" + (" (raw BGRA)" if b.encoding == 3 else ""))
    bands = 3 if rawmode == "BGR" or not b.alpha else 4
    n = b.width * b.height * bands
    if len(data) < n:
        raise ValueError("BLP image data: not enough image data")
    px = np.frombuffer(data, np.uint8, count=n).reshape(b.height, b.width, bands)
    return to_rgba("RGB" if bands == 3 else "RGBA", px[..., ::-1] if rawmode else px)
