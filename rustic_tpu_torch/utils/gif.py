"""A NumPy GIF decoder for scene textures and LDR skyboxes.

The JAX package reads GIFs through Pillow (`Image.open(...).convert("RGBA")`);
`decode_gif` gives the same uint8 [H, W, 4]: GIF87a and GIF89a, the first
frame (the one `Image.open` shows), its local colour table or else the
global one, the transparency index of its graphic control extension,
interlaced rows, and LZW with variable code widths, clear and end codes.
A frame smaller than the logical screen is placed at its offset on a
canvas of index 0 (of the transparency index where there is one), and a
frame that reaches past the screen grows the image, as Pillow does. A
colour table that is exactly the grey ramp (entry i = (i, i, i)) makes
Pillow open the image as "L": the indices are then the grey levels. An
index past the end of the colour table is black, as Pillow shows it.
Image data that ends before the frame's last pixel raises ValueError, as
Pillow refuses the file as truncated.

Only the LZW decode is a Python loop: each code's string is looked up in
a list of byte strings; the colour lookup and the interlace run over the
whole frame at once.
"""

from __future__ import annotations

import struct

import numpy as np

from rustic_tpu_torch.utils.modes import note_core

_PASSES = ((0, 8), (4, 8), (2, 4), (1, 2))  # interlaced rows: (first, step)


def _sub_blocks(raw: bytes, pos: int):
    """The data sub-blocks from `pos` -> (their bytes joined, the position
    after the terminating empty block)."""
    out = bytearray()
    while pos < len(raw):
        n = raw[pos]
        pos += 1
        if n == 0:
            return bytes(out), pos
        out += raw[pos : pos + n]
        pos += n
    return bytes(out), pos  # Pillow reads a truncated stream as far as it goes


def _lzw(data: bytes, min_bits: int, count: int) -> bytes:
    """GIF's LZW: codes read least significant bit first, the width
    starting at min_bits + 1 and growing to 12 when the next free code
    reaches 1 << width; a clear code resets the table, the end code (or
    the end of the data, or `count` output bytes) stops."""
    if not 1 <= min_bits <= 11:
        raise ValueError(f"GIF LZW code size {min_bits}")
    clear, end = 1 << min_bits, (1 << min_bits) + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    b = np.frombuffer(data + bytes(4), np.uint8).astype(np.uint32)
    words = (b[:-3] | b[1:-2] << 8 | b[2:-1] << 16 | b[3:] << 24).tolist()  # 32 bits from byte i
    nbits = 8 * len(data)
    out = bytearray()
    table = list(base)
    width = min_bits + 1
    mask = (1 << width) - 1
    prev = None
    p = 0
    while p + width <= nbits and len(out) < count:
        code = (words[p >> 3] >> (p & 7)) & mask
        p += width
        if code == clear:
            table = list(base)
            width = min_bits + 1
            mask = (1 << width) - 1
            prev = None
            continue
        if code == end:
            break
        if prev is None:
            if code >= clear:
                raise ValueError("GIF LZW stream starts with an undefined code")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table):  # the code being defined: prev + its own first byte
            entry = prev + prev[:1]
            if len(table) < 4096:
                table.append(entry)
        else:
            raise ValueError(f"GIF LZW code {code} is not defined yet")
        out += entry
        prev = entry
        if len(table) == 1 << width and width < 12:
            width += 1
            mask = (1 << width) - 1
    return bytes(out[:count])


def _grey_ramp(palette: bytes) -> bool:
    """Pillow's `_is_palette_needed`, negated: entry i is (i, i, i)."""
    p = np.frombuffer(palette, np.uint8).reshape(-1, 3)
    return bool((p == np.arange(len(p))[:, None]).all())


def decode_gif(raw: bytes, transparency: bool = True) -> np.ndarray:
    """GIF bytes -> uint8 [H, W, 4] of the first frame, as Pillow's
    convert("RGBA"); without `transparency`, the transparency index makes
    no pixel transparent (Pillow's image of a GIF embedded in another
    file, whose info it does not keep)."""
    raw = bytes(raw)
    keep = transparency  # the name below holds the transparency index
    if raw[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    width, height, flags = struct.unpack("<HHB", raw[6:11])
    pos = 13
    palette = None  # None: no table read; a grey ramp counts as none (mode "L")
    if flags & 0x80:
        size = 3 << ((flags & 7) + 1)
        table = raw[pos : pos + size]
        pos += size
        if not _grey_ramp(table):
            palette = table
    transparency = None
    while True:
        if pos >= len(raw) or raw[pos] == 0x3B:
            raise ValueError("GIF has no image")
        kind = raw[pos]
        if kind == 0x21:  # extension: label, sub-blocks
            label = raw[pos + 1]
            body, after = _sub_blocks(raw, pos + 2)
            if label == 0xF9 and len(body) >= 4:  # graphic control: flags, delay, index
                transparency = body[3] if body[0] & 1 else None
            pos = after
            continue
        if kind != 0x2C:
            raise ValueError(f"GIF block {kind:#x} at byte {pos}")
        x0, y0, w, h, iflags = struct.unpack("<HHHHB", raw[pos + 1 : pos + 10])
        pos += 10
        if iflags & 0x80:
            size = 3 << ((iflags & 7) + 1)
            table = raw[pos : pos + size]
            pos += size
            palette = None if _grey_ramp(table) else table
        min_bits = raw[pos]
        data, _ = _sub_blocks(raw, pos + 1)
        break
    width, height = max(width, x0 + w), max(height, y0 + h)
    idx = np.frombuffer(_lzw(data, min_bits, w * h), np.uint8)
    if len(idx) < w * h:  # Pillow refuses such a file as truncated
        raise ValueError("GIF image data ends before its last pixel")
    frame = idx.reshape(h, w)
    if iflags & 0x40:  # interlaced: the rows arrive in four passes
        order = np.concatenate([np.arange(first, h, step) for first, step in _PASSES])
        rows = np.empty_like(frame)
        rows[order] = frame
        frame = rows
    canvas = np.full((height, width), 0 if transparency is None else transparency, np.uint8)
    canvas[y0 : y0 + h, x0 : x0 + w] = frame
    colours = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)  # "L": the index
    if palette is not None:  # "P": the table, black past its end
        table = np.frombuffer(palette, np.uint8).reshape(-1, 3)
        colours[:] = 0
        colours[: len(table)] = table
    note_core("L" if palette is None else "P", canvas, colours, transparency)
    out = np.empty((height, width, 4), np.uint8)
    out[..., :3] = colours[canvas]
    out[..., 3] = 255
    if transparency is not None and keep:
        out[..., 3] = np.where(canvas == transparency, 0, 255)
    return out

