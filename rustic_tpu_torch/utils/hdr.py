"""Radiance RGBE (.hdr) reader and writer: copies of `read_hdr` and
`write_hdr` of rustic_tpu/utils/hdr.py (NumPy only), which the port may
not import.

Shared-exponent RGBE pixels, new-style per-component RLE scanlines,
old-style repeat shifts and flat files; f = byte * 2^(e - 136), zero
when e == 0 (the Radiance reference implementation).
"""

from __future__ import annotations

import re

import numpy as np


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """[..., 4] uint8 RGBE -> [..., 3] float32 radiance."""
    rgbe = rgbe.astype(np.int32)
    scale = np.where(
        rgbe[..., 3:4] == 0, 0.0, np.ldexp(1.0, rgbe[..., 3:4] - 136)
    ).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] float radiance -> [..., 4] uint8 RGBE."""
    rgb = np.maximum(rgb.astype(np.float32), 0.0)
    v = rgb.max(axis=-1)
    m, e = np.frexp(v)  # v = m * 2^e, m in [0.5, 1)
    scale = np.where(v < 1e-32, 0.0, m * 256.0 / np.maximum(v, 1e-32))
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    # +0.5: round like the Radiance reference encoder (half-quantum error)
    out[..., :3] = np.clip(rgb * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    out[..., 3] = np.where(v < 1e-32, 0, np.clip(e + 128, 0, 255)).astype(np.uint8)
    return out


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file -> float32 [H, W, 3] linear radiance."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"not a Radiance HDR file: {path}")
    head_end = data.find(b"\n\n")  # the header ends at the first blank line
    if head_end < 0:
        raise ValueError(f"malformed HDR header: {path}")
    header = data[:head_end].decode(errors="replace")
    if "FORMAT=32-bit_rle_rgbe" not in header:
        raise ValueError(f"unsupported HDR pixel format in {path}")
    res_end = data.find(b"\n", head_end + 2)
    res = data[head_end + 2 : res_end].decode(errors="replace")
    m = re.match(r"-Y (\d+) \+X (\d+)", res)
    if not m:
        raise ValueError(f"unsupported HDR orientation {res!r} in {path}")
    height, width = int(m.group(1)), int(m.group(2))
    buf = np.frombuffer(data, np.uint8, offset=res_end + 1)

    rows = np.empty((height, width, 4), np.uint8)
    pos = 0
    for y in range(height):
        if (
            8 <= width < 32768
            and pos + 4 <= len(buf)
            and buf[pos] == 2
            and buf[pos + 1] == 2
            and (int(buf[pos + 2]) << 8 | int(buf[pos + 3])) == width
        ):
            pos += 4  # new style: four per-component RLE streams
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[pos])
                    pos += 1
                    if count > 128:  # run
                        rows[y, x : x + count - 128, c] = buf[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        rows[y, x : x + count, c] = buf[pos : pos + count]
                        pos += count
                        x += count
        else:  # flat or old style, with (1, 1, 1, n) repeat shifts
            x = 0
            shift = 0
            while x < width:
                px = buf[pos : pos + 4]
                pos += 4
                if px[0] == 1 and px[1] == 1 and px[2] == 1:
                    n = int(px[3]) << shift
                    rows[y, x : x + n] = rows[y, x - 1]
                    x += n
                    shift += 8
                else:
                    rows[y, x] = px
                    x += 1
                    shift = 0
    return _rgbe_to_float(rows)


def write_hdr(path: str, rgb: np.ndarray) -> None:
    """Write float radiance [H, W, 3] as a flat (non-RLE) .hdr file."""
    rgb = np.asarray(rgb)
    if rgb.ndim != 3 or rgb.shape[-1] < 3:
        raise ValueError("write_hdr expects [H, W, 3]")
    h, w = rgb.shape[:2]
    rgbe = _float_to_rgbe(rgb[..., :3])
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
