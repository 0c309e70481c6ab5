"""Pillow 12.1.0's `convert("RGBA")` from each image mode the classic
decoders (utils/pnm.py, qoi.py, ico.py, pcx.py, sgi.py and the DIB core of
utils/bmp_tga.py) produce, on NumPy arrays:

- "1" (0 or 255), "L" and "P" (indices into a [256, 3] palette; no
  palette reads as every index black, as Pillow's empty one does): grey
  or looked-up RGB, alpha 255;
- "RGB", "RGBA";
- "CMYK": 255 - k - c * (255 - k) / 255 in Pillow's fixed-point MULDIV255;
- "I" (32-bit integers): each value clipped to 0..255;
- "F" (float32): clipped to 0..255 and cut toward zero (NaN reads 0).
"""

from __future__ import annotations

import numpy as np

# PIL.Image.MAX_IMAGE_PIXELS: above twice this Image.open raises DecompressionBombError
MAX_PIXELS = 2 * 89478485


def check_pixels(width: int, height: int, what: str):
    """Pillow's decompression-bomb refusal, for a header whose pixels the
    file's size does not bound (run-length data)."""
    if width * height > MAX_PIXELS:
        raise ValueError(f"{what} of {width}x{height} pixels is over Pillow's limit of "
                         f"{MAX_PIXELS} (a decompression bomb)")


def muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def to_rgba(mode: str, px: np.ndarray, palette: np.ndarray = None) -> np.ndarray:
    """An image of Pillow mode `mode` ([H, W] for one band, [H, W, n] for
    more) -> uint8 [H, W, 4]."""
    h, w = px.shape[:2]
    out = np.full((h, w, 4), 255, np.uint8)
    if mode in ("1", "L"):
        out[..., :3] = px[..., None]
    elif mode == "P":
        pal = np.zeros((256, 3), np.uint8) if palette is None else palette
        out[..., :3] = pal[px]
    elif mode in ("RGB", "RGBA"):
        out[..., : px.shape[2]] = px
    elif mode == "CMYK":
        c = px.astype(np.int64)
        nk = 255 - c[..., 3]
        for i in range(3):
            out[..., i] = np.clip(nk - muldiv255(c[..., i], nk), 0, 255)
    elif mode == "I":
        out[..., :3] = np.clip(px, 0, 255).astype(np.uint8)[..., None]
    elif mode == "F":
        with np.errstate(invalid="ignore"):  # a signalling NaN widened to float64
            v = np.clip(np.nan_to_num(px.astype(np.float64), nan=0.0), 0, 255)
        out[..., :3] = v.astype(np.uint8)[..., None]
    else:
        raise ValueError(f"mode {mode!r}")
    return out


def unpack_bits(rows: np.ndarray, bits: int, width: int) -> np.ndarray:
    """uint8 [H, stride] of `bits`-bit samples, most significant first ->
    [H, width] sample values."""
    if bits == 8:
        return rows[:, :width]
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    return ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(len(rows), -1)[:, :width]
