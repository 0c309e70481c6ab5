"""An SGI image (.rgb, .rgba, .bw, .sgi) decoder, as Pillow 12.1.0 reads it
(PIL/SgiImagePlugin.py, its SgiRleDecode.c) and converts it to RGBA.

Pillow reads the (bytes a sample, dimension, channels) kinds of its
MODES: 1 or 2 bytes a sample (a 16-bit sample gives its high byte), one
channel at dimension 1 or 2 ("L"), three ("RGB") or four ("RGBA") at
dimension 3; any other kind ends its open ("Unsupported SGI image mode")
and raises NotImplementedError here, as does a compression byte other
than 0 (verbatim) and 1 (RLE). Rows are stored bottom-up, channel by
channel, from byte 512.

RLE: the tables of each row's start and length follow the header; each
row of each channel is a stream of ops (a count byte, or word at 16 bits:
the low 7 bits count pixels, bit 7 copies that many samples, else the
next sample repeats; a count of 0 ends the row). The streams are parsed
in lockstep over every row with NumPy and expanded with `np.repeat`, with
SgiRleDecode.c's rules: the length is the number of ops a row may read,
not of bytes; a row whose last allowed op is not the end marker stops
the decode without an error, leaving that row and the rows above it
zero; a sample a row does not write keeps the value the row below left
in the decoder's line buffer; a row that starts inside the header or
overruns its width or the file raises ValueError, as Pillow's decoder
raises its overrun.

A header cut short or a size of zero raises NotThisFormat (Pillow passes
the file on); verbatim data cut short, or a size over Pillow's
decompression-bomb limit, ValueError.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO, NotThisFormat
from rustic_tpu_torch.utils.modes import check_pixels, to_rgba

HEADER = 512
MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L", (1, 3, 3): "RGB",
         (2, 3, 3): "RGB", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and struct.unpack_from(">H", prefix)[0] == 474


class Sgi(NamedTuple):
    mode: str  # "L", "RGB" or "RGBA"
    bpc: int  # bytes a sample
    width: int
    height: int
    rle: bool


def open_sgi(raw: bytes) -> Sgi:
    """SgiImageFile._open -> Sgi."""
    if not accept(raw[:2]):
        raise NotThisFormat("not an SGI file")
    if len(raw) < 12:
        raise NotThisFormat("SGI header is cut short")
    compression, bpc = raw[2], raw[3]
    dimension, width, height, zsize = struct.unpack_from(">HHHH", raw, 4)
    if (bpc, dimension, zsize) not in MODES:
        raise NotImplementedError(f"SGI of {bpc} bytes a sample, dimension {dimension} and "
                                  f"{zsize} channels is not decoded ({FORMATS_TODO})")
    if width == 0 or height == 0:
        raise NotThisFormat(f"SGI of size {width}x{height}")
    check_pixels(width, height, "SGI")
    if compression not in (0, 1):
        raise NotImplementedError(f"SGI compression {compression} is not decoded "
                                  f"({FORMATS_TODO})")
    return Sgi(MODES[(bpc, dimension, zsize)], bpc, width, height, compression == 1)


def _verbatim(raw: bytes, s: Sgi, bands: int) -> np.ndarray:
    """Planes from byte 512 -> [bands, rows (file order), W] of high bytes."""
    page = s.width * s.height * s.bpc
    if len(raw) < HEADER + bands * page:
        raise ValueError("SGI image data is truncated")
    data = np.frombuffer(raw, np.uint8, count=bands * page, offset=HEADER)
    return data.reshape(bands, s.height, s.width, s.bpc)[..., 0]


def _rle(raw: bytes, s: Sgi, bands: int) -> np.ndarray:
    """The RLE rows -> [bands, rows (file order), W], as SgiRleDecode.c
    lays them into the image (zero above a stop)."""
    w, h, bpc = s.width, s.height, s.bpc
    body = np.frombuffer(raw, np.uint8)[HEADER:]
    size = len(body)
    chunks = bands * h
    if size < 8 * chunks:
        raise ValueError("SGI RLE tables are truncated")
    # chunk k = row r, channel c in the decoder's order (r major); its table index r + c * h
    r, c = np.divmod(np.arange(chunks), bands)
    table = r + c * h
    start = body[: 4 * chunks].view(">u4").astype(np.int64)[table] - HEADER
    # a row's length bounds the ops it may read, as a C int (2**31 and up: none)
    length = body[4 * chunks : 8 * chunks].view(">i4").astype(np.int64)[table]
    bad = start < 0
    last = size - 1  # the decoder's end_of_buffer: its last byte
    status = np.full(chunks, -2)  # -2 running, 0 done, 1 stop, -1 overrun
    status[bad] = -1
    p, n, x = np.maximum(start, 0), length.copy(), np.zeros(chunks, np.int64)
    ops = []  # (chunk, x, count, copy, source) a step
    live = np.flatnonzero(status == -2)
    while len(live):
        done = n[live] <= 0
        status[live[done]] = 0
        live = live[~done]
        q = p[live]
        over = q + (bpc - 1) > last
        pixel = body[np.minimum(q + bpc - 1, last)].astype(np.int64)
        q = q + bpc
        count = pixel & 0x7F
        stop = ~over & (n[live] == 1) & (pixel != 0)
        end = ~over & ~stop & (count == 0)
        over |= ~stop & ~end & (x[live] + count > w)
        copy = (pixel & 0x80) != 0
        need = np.where(copy, bpc * count, bpc)
        over |= ~stop & ~end & (q + need - 1 > last)
        status[live[over]] = -1
        status[live[stop]] = 1
        status[live[end]] = 0
        go = ~(over | stop | end)
        k = live[go]
        ops.append((k, x[k].copy(), count[go], copy[go], q[go]))
        p[k] = q[go] + need[go]
        x[k] += count[go]
        n[k] -= 1
        live = k
    first_bad = np.flatnonzero(status != 0)
    rows = h
    if len(first_bad):
        k0 = first_bad[0]
        if status[k0] == -1:
            raise ValueError(f"SGI RLE row {k0 // bands} channel {k0 % bands} starts in the "
                             "header or overruns its width or the file")
        rows = k0 // bands  # a stop: the rows from here on stay zero
    value = np.zeros(h * bands * w, np.uint8)
    written = np.zeros(h * bands * w, bool)
    if ops:
        k, x0, count, copy, src = (np.concatenate(a) for a in zip(*ops))
        op = np.repeat(np.arange(len(count)), count)  # the op of each sample
        within = np.arange(len(op)) - (np.cumsum(count) - count)[op]
        source = src[op] + within * np.where(copy, bpc, 0)[op]  # a run repeats its sample
        flat = k[op] * w + x0[op] + within  # chunk k = row r, channel c: (r * bands + c) * w
        value[flat] = body[source]
        written[flat] = True
    value, written = value.reshape(h, bands, w), written.reshape(h, bands, w)
    if written[:rows].all():
        filled = value
    else:  # the decoder's line buffer keeps what an earlier row wrote where this one writes nothing
        src_row = np.maximum.accumulate(np.where(written, np.arange(h)[:, None, None], -1), axis=0)
        filled = np.where(src_row >= 0, np.take_along_axis(value, np.maximum(src_row, 0), 0), 0)
    filled[rows:] = 0
    return filled.transpose(1, 0, 2)


def decode_sgi(raw: bytes, s: Sgi = None) -> np.ndarray:
    """SGI bytes (or their `open_sgi` header) -> uint8 [H, W, 4], as
    Pillow's convert("RGBA")."""
    raw = bytes(raw)
    s = s or open_sgi(raw)
    bands = len(s.mode)
    planes = _rle(raw, s, bands) if s.rle else _verbatim(raw, s, bands)
    px = planes[:, ::-1].transpose(1, 2, 0)  # bottom-up rows
    return to_rgba(s.mode, px[..., 0] if bands == 1 else px)
