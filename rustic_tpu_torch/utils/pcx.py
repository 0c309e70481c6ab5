"""PC Paintbrush (PCX) and Intel DCX decoders, as Pillow 12.1.0 reads
them (PIL/PcxImagePlugin.py, PIL/DcxImagePlugin.py) and converts them to
RGBA.

Pillow reads these (bits a sample, planes) layouts; every other one ends
its open, and raises NotImplementedError here naming it:

- 1 bit, 1 plane: mode "1" (a set bit white);
- 1 bit, 2 or 4 planes: a palette image of 4 or 16 colours, each line's
  planes one after the other, its colours the header's 16-entry palette;
- version 5, 8 bits, 1 plane: greyscale, or a palette image where the
  file ends in byte 12 and a 768-byte palette that is not the grey ramp
  (Pillow reads the last 769 bytes of the file, whatever their place);
- version 5, 8 bits, 3 planes: RGB, a line's red, green and blue planes
  one after the other.

A line is planes x stride bytes, the stride ceil(width x bits / 8), made
even where the header's own stride differs from it. The lines are
run-length coded (a byte of the top two bits set repeats the next byte
its low six bits times): the runs are found and expanded in NumPy, and a
run that crosses the end of a line raises ValueError, as Pillow's decoder
raises its buffer overrun there. Pillow's PcxDecode.c then moves the
8-bit planes of a line whose length is not a multiple of the width (and
is longer than it) to the width apart, and its unpackers read them the
width apart; this module does the same, so a line whose padding Pillow
does not move out of the way (an RGB image 1 or 3 pixels wide, its
stride made even) reads as Pillow reads it. 1-bit planes are read a
stride apart, as they lie.

DCX: the first of its (up to 1024) PCX images, as Pillow shows it; the
768-byte palette is still read from the end of the whole file. A header
Pillow turns away so that `Image.open` tries the next plugin (a field
cut short, a bad image size, a DCX without images) raises NotThisFormat.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO, NotThisFormat
from rustic_tpu_torch.utils.modes import to_rgba

DCX_MAGIC = 0x3ADE68B1
HEADER = 128


def accept_pcx(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


def accept_dcx(prefix: bytes) -> bool:
    return len(prefix) >= 4 and struct.unpack_from("<I", prefix)[0] == DCX_MAGIC


class Pcx(NamedTuple):
    mode: str  # Pillow's: "1", "P", "L" or "RGB"
    unpack: str  # its raw mode: "1", "P;2L", "P;4L", "L", "P" or "RGB;L"
    width: int
    height: int
    palette: object  # uint8 [256, 3] for "P"
    offset: int  # where the run-length data starts
    line: int  # bytes a decoded line


def read_pcx(raw: bytes, pos: int = 0, what: str = "PCX") -> Pcx:
    """PcxImageFile._open of the image at `pos` -> Pcx."""
    s = raw[pos : pos + 68]
    if not accept_pcx(s):
        raise NotThisFormat(f"not a {what} image")
    if len(s) < 12:
        raise NotThisFormat(f"{what} header is cut short")
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", s, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise NotThisFormat(f"bad {what} image size")
    if len(s) < 68:
        raise NotThisFormat(f"{what} header is cut short")
    version, bits, planes = s[1], s[3], s[65]
    (given_stride,) = struct.unpack_from("<H", s, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = unpack = "1"
    elif bits == 1 and planes in (2, 4):
        mode, unpack = "P", f"P;{planes}L"
        palette = np.zeros((256, 3), np.uint8)
        palette[:16] = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = unpack = "L"
        tail = raw[max(0, len(raw) - 769) :]  # Pillow: seek(-769, SEEK_END) on the whole file
        if len(tail) == 769 and tail[0] == 12:
            entries = np.frombuffer(tail, np.uint8, offset=1).reshape(256, 3)
            if not (entries == np.arange(256, dtype=np.uint8)[:, None]).all():
                mode = unpack = "P"
                palette = entries
    elif version == 5 and bits == 8 and planes == 3:
        mode, unpack = "RGB", "RGB;L"
    else:
        raise NotImplementedError(f"{what} of {bits}-bit samples in {planes} planes "
                                  f"(version {version}) is not decoded ({FORMATS_TODO})")
    width, height = x1 + 1 - x0, y1 + 1 - y0
    stride = (width * bits + 7) // 8
    if given_stride != stride:
        stride += stride % 2
    return Pcx(mode, unpack, width, height, palette, pos + HEADER, planes * stride)


def open_dcx(raw: bytes) -> Pcx:
    """DcxImageFile._open: the directory, then its first image."""
    if not accept_dcx(raw[:4]):
        raise NotThisFormat("not a DCX file")
    offsets = []
    for i in range(1024):  # the whole directory is read: an entry cut short turns the file away
        if len(raw) < 8 + 4 * i:
            raise NotThisFormat("DCX directory is cut short")
        (offset,) = struct.unpack_from("<I", raw, 4 + 4 * i)
        if not offset:
            break
        offsets.append(offset)
    if not offsets:
        raise NotThisFormat("DCX holds no images")
    return read_pcx(raw, offsets[0], "DCX")


def _runs(data: np.ndarray, total: int, line: int) -> np.ndarray:
    """PCX run-length data -> its first `total` decoded bytes (lines of
    `line` bytes), the runs found and expanded in NumPy."""
    n = len(data)
    hi = data >= 0xC0
    idx = np.arange(n)
    # a run of bytes >= 0xC0 starts with a run head and alternates head, value
    block_start = np.maximum.accumulate(np.where(hi, -1, idx)) + 1
    head = hi & ((idx - block_start) % 2 == 0)
    value_of_head = np.zeros(n, bool)
    value_of_head[1:] = head[:-1]
    op = head | (~hi & ~value_of_head)  # run heads and literals, in stream order
    pos = np.flatnonzero(op)
    is_run = head[pos]
    counts = np.where(is_run, data[pos] & 0x3F, 1).astype(np.int64)
    ends = np.cumsum(counts)
    starts = ends - counts
    used = starts < total
    if ends[-1:].sum() < total or (is_run[used] & (pos[used] + 1 >= n)).any():
        raise ValueError("PCX data ends before the image does")
    cross = used & is_run & (counts > 0) & (starts // line != (ends - 1) // line)
    if cross.any():
        raise ValueError("PCX run crosses the end of a line (Pillow's buffer overrun)")
    pos, is_run, counts = pos[used], is_run[used], counts[used]
    values = data[np.minimum(pos + is_run, n - 1)]
    return np.repeat(values, counts)[:total]


def decode_pcx(raw: bytes, p: Pcx = None) -> np.ndarray:
    """PCX bytes (or their `read_pcx` header) -> uint8 [H, W, 4], as
    Pillow's convert("RGBA")."""
    raw = bytes(raw)
    p = p or read_pcx(raw)
    w, h, line = p.width, p.height, p.line
    data = np.frombuffer(raw, np.uint8)[p.offset :]
    lines = _runs(data, h * line, line).reshape(h, line)
    if p.unpack in ("L", "P", "RGB;L") and line % w and line > w:
        # PcxDecode.c moves 8-bit planes to the width apart
        bands = line // w
        gap = line // bands
        for i in range(1, bands):
            lines[:, i * w : i * w + w] = lines[:, i * gap : i * gap + w].copy()
    if p.unpack in ("L", "P"):
        return to_rgba(p.mode, lines[:, :w], p.palette)
    if p.unpack == "RGB;L":
        return to_rgba("RGB", np.stack([lines[:, c * w : c * w + w] for c in range(3)], -1))
    planes = 1 if p.unpack == "1" else int(p.unpack[2])
    s = line // planes  # 1-bit planes are read a stride apart, as they lie
    idx = np.zeros((h, w), np.uint8)
    for k in range(planes):
        idx |= np.unpackbits(lines[:, k * s : k * s + s], axis=1)[:, :w] << k
    if p.unpack == "1":
        return to_rgba("1", idx * np.uint8(255))
    return to_rgba("P", idx, p.palette)
