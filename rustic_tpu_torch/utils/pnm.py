"""A NumPy decoder of the Netpbm formats (PBM, PGM, PPM and PFM) and
Pillow's own PNM kinds, as Pillow 12.1.0 reads them (PIL/PpmImagePlugin.py)
and converts them to RGBA.

The JAX package opens these with Pillow; this module gives the same uint8
[H, W, 4]. Pillow reads every magic number of its MODES:

- P1 and P4 (mode "1": a 1 is black), P2 and P5 ("L"), P3 and P6 ("RGB"),
  P0CMYK ("CMYK"), Pf (a float "F", rows bottom-up, little-endian where
  the scale is negative), and Pillow's PyP ("P" with no palette: every
  index black), PyRGBA and PyCMYK;
- the header's tokens as Pillow's `_read_token` reads them: whitespace
  between them, a "#" comment running to the end of its line anywhere
  (a token goes on after it), at most 10 bytes a token;
- maxval 1-65535: raw samples of one byte below 256 and two (big-endian)
  above, each rescaled as round(v / maxval * 255) (Python's rounding,
  half to even) and capped at 255 unless maxval is 255; a grey image
  with maxval above 255 is Pillow's mode "I", rescaled to 0..65535 (raw
  16-bit samples where maxval is 65535), which `convert` clips to 255;
- the plain (ASCII) kinds P1-P3 read block by block as Pillow's
  PpmPlainDecoder reads them (SAFEBLOCK bytes a block, comments dropped
  across blocks, a token cut by a block's end joined to the next, every
  byte of a P1 block held to "0" and "1", a sample above maxval refused).

Where Pillow passes the file on to the next plugin (a magic number it
does not know, a width or height of zero) this raises NotThisFormat;
where Pillow ends the open or the load (a bad token, maxval out of
range, a PFM scale of zero or not finite, too few samples) ValueError.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils import NotThisFormat
from rustic_tpu_torch.utils.modes import to_rgba

WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
SAFEBLOCK = 1024 * 1024  # PIL.ImageFile.SAFEBLOCK: the plain decoder's block
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
         b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[:1] == b"P" and prefix[1] in b"0123456fy"


class Pnm(NamedTuple):
    mode: str  # Pillow's: "1", "L", "I", "RGB", "RGBA", "CMYK", "P" or "F"
    width: int
    height: int
    plain: bool
    maxval: int  # 0 for "1" and "F"
    little: bool  # "F": little-endian floats
    offset: int  # where the samples start


class _Reader:
    def __init__(self, raw: bytes):
        self.raw, self.pos = raw, 0

    def read1(self) -> bytes:
        c = self.raw[self.pos : self.pos + 1]
        self.pos += len(c)
        return c

    def token(self) -> bytes:
        """PpmImageFile._read_token."""
        token = b""
        while len(token) <= 10:
            c = self.read1()
            if not c:
                break
            if c in WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":
                while self.read1() not in b"\r\n":
                    pass
                continue
            token += c
        if not token:
            raise ValueError("PNM: reached the end of the file while reading the header")
        if len(token) > 10:
            raise ValueError(f"PNM: token too long in the header: {token!r}")
        return token


def open_pnm(raw: bytes) -> Pnm:
    """PpmImageFile._open -> Pnm."""
    r = _Reader(raw)
    magic = b""
    for _ in range(6):
        c = r.read1()
        if not c or c in WHITESPACE:
            break
        magic += c
    if magic not in MODES:
        raise NotThisFormat(f"not a PNM file (magic {magic!r})")
    mode = MODES[magic]
    width = int(r.token())
    height = int(r.token())
    maxval, little = 0, False
    if mode == "F":
        scale = float(r.token())
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("PFM scale must be finite and non-zero")
        little = scale < 0
    elif mode != "1":
        maxval = int(r.token())
        if not 0 < maxval < 65536:
            raise ValueError(f"PNM maxval {maxval} is not in 1..65535")
        if maxval > 255 and mode == "L":
            mode = "I"
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"PNM of size {width}x{height}")
    return Pnm(mode, width, height, magic in (b"P1", b"P2", b"P3"), maxval, little, r.pos)


def _rescale(v: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """round(v / maxval * out_max) as Python computes it (float64, half
    to even)."""
    return np.rint(v.astype(np.float64) / maxval * out_max).astype(np.int64)


def _raw_samples(raw: bytes, p: Pnm) -> np.ndarray:
    """The binary kinds -> samples [H, W, bands] (or [H, W] for "1" and
    "F"), as Pillow's raw decoder or PpmDecoder give them."""
    h, w = p.height, p.width
    if p.mode == "1":  # rawmode "1;I": rows of whole bytes, a set bit black
        stride = (w + 7) // 8
        data = _take(raw, p.offset, stride * h)
        bits = np.unpackbits(data.reshape(h, stride), axis=1)[:, :w]
        return np.where(bits != 0, 0, 255).astype(np.uint8)
    if p.mode == "F":
        data = _take(raw, p.offset, 4 * w * h)
        return data.view("<f4" if p.little else ">f4").reshape(h, w)[::-1]
    bands = _BANDS[p.mode]
    if p.maxval == 255:
        return _take(raw, p.offset, w * h * bands).reshape(h, w, bands)
    if p.mode == "I" and p.maxval == 65535:  # rawmode "I;16B"
        return _take(raw, p.offset, 2 * w * h).view(">u2").reshape(h, w, 1).astype(np.int64)
    # PpmDecoder: whole pixels of one- or two-byte samples, rescaled
    size = 1 if p.maxval < 256 else 2
    n = w * h * bands
    avail = (len(raw) - p.offset) // (size * bands) * bands if len(raw) > p.offset else 0
    if avail < n:
        raise ValueError(f"PNM image data is truncated: {avail} of {n} samples")
    v = np.frombuffer(raw, ">u2" if size == 2 else np.uint8, count=n, offset=p.offset)
    out_max = 65535 if p.mode == "I" else 255
    return np.minimum(out_max, _rescale(v, p.maxval, out_max)).reshape(h, w, bands)


def _take(raw: bytes, offset: int, n: int) -> np.ndarray:
    if len(raw) < offset + n:
        raise ValueError(f"PNM image data is truncated: {max(0, len(raw) - offset)} of {n} bytes")
    return np.frombuffer(raw, np.uint8, count=n, offset=offset)


class _Blocks:
    """PpmPlainDecoder's block reader and comment stripper."""

    def __init__(self, raw: bytes, pos: int):
        self.raw, self.pos, self.comment_spans = raw, pos, False

    def read(self) -> bytes:
        block = self.raw[self.pos : self.pos + SAFEBLOCK]
        self.pos += len(block)
        return block

    @staticmethod
    def _comment_end(block: bytes, start: int = 0) -> int:
        a = block.find(b"\n", start)
        b = block.find(b"\r", start)
        return min(a, b) if a * b > 0 else max(a, b)

    def strip(self, block: bytes) -> bytes:
        if self.comment_spans:
            while block:
                end = self._comment_end(block)
                if end != -1:
                    block = block[end + 1 :]
                    break
                block = self.read()
        self.comment_spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = self._comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1 :]
            else:
                block = block[:start]
                self.comment_spans = True
                break
        return block


def _plain_bitonal(raw: bytes, p: Pnm) -> np.ndarray:
    total = p.width * p.height
    blocks = _Blocks(raw, p.offset)
    data = b""
    while len(data) != total:
        block = blocks.read()
        if not block:
            break
        tokens = b"".join(blocks.strip(block).split())
        bad = tokens.translate(None, b"01")
        if bad:
            raise ValueError(f"PBM: invalid token for this mode: {bad[:1]!r}")
        data = (data + tokens)[:total]
    if len(data) != total:
        raise ValueError(f"PBM image data is truncated: {len(data)} of {total} pixels")
    px = np.frombuffer(data, np.uint8).reshape(p.height, p.width)
    return np.where(px == ord("1"), 0, 255).astype(np.uint8)


def _plain_values(raw: bytes, p: Pnm) -> np.ndarray:
    """PpmPlainDecoder._decode_blocks -> rescaled samples [H, W, bands]."""
    bands = _BANDS[p.mode]
    total = p.width * p.height * bands
    out_max = 65535 if p.mode == "I" else 255
    blocks = _Blocks(raw, p.offset)
    values, count, half = [], 0, b""
    while count != total:
        block = blocks.read()
        if not block:
            if not half:
                break
            block = b" "  # flush the half token
        block = blocks.strip(block)
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():  # the block may cut a token
            half = tokens.pop()
            if len(half) > 10:
                raise ValueError(f"PNM: token too long in the data: {half[:11]!r}")
        tokens = tokens[: total - count]
        if any(len(t) > 10 for t in tokens):
            raise ValueError("PNM: token too long in the data")
        v = np.array([int(t) for t in tokens], np.int64)
        if (v < 0).any():
            raise ValueError(f"PNM: channel value is negative: {int(v.min())}")
        if (v > p.maxval).any():
            raise ValueError(f"PNM: channel value too large for this mode: {int(v.max())}")
        values.append(_rescale(v, p.maxval, out_max))
        count += len(v)
    if count != total:
        raise ValueError(f"PNM image data is truncated: {count} of {total} samples")
    return np.concatenate(values).reshape(p.height, p.width, bands)


def decode_pnm(raw: bytes, p: Pnm = None) -> np.ndarray:
    """PNM / PFM bytes (or their `open_pnm` header) -> uint8 [H, W, 4], as
    Pillow's convert("RGBA")."""
    raw = bytes(raw)
    p = p or open_pnm(raw)
    if p.mode == "1":
        px = _plain_bitonal(raw, p) if p.plain else _raw_samples(raw, p)
    elif p.plain:
        px = _plain_values(raw, p)
    else:
        px = _raw_samples(raw, p)
    if px.ndim == 3 and px.shape[2] == 1:
        px = px[..., 0]
    if p.mode not in ("I", "F"):
        px = px.astype(np.uint8)
    return to_rgba(p.mode, px)
