"""Reads back from Pillow 12.1.0 the YCC tables of the port's
rustic_tpu_torch/utils/modes.py (ConvertYCbCr.c, used by convert("RGB")
of a "YCbCr" image) and utils/pcd.py (UnpackYCC.c, the "YCC;P" raw mode
of PhotoCD), and writes them as the base64 of zlib'd little-endian int16
[4, 256] that those modules load with `modes.int16_tables`.

Run `python -m tests.derive_ycc_tables` to print both blobs;
tests/test_torch_image_formats_legacy.py holds the modules' tables to
`ycbcr_tables()` and `photo_ycc_tables()`.

YCbCr: r = y + dR[cr] and b = y + dB[cb] are read where they do not clip,
so dR and dB are Pillow's. g = y + ((gCb[cb] + gCr[cr]) >> 6) shows only
D[cb, cr] = (gCb[cb] + gCr[cr]) >> 6: gCb and gCr are the greatest
integers (gCb[128] = 0) with 64 D <= gCb[cb] + gCr[cr] <= 64 D + 63 for
every (cb, cr), a system of difference constraints solved by
Bellman-Ford. They give Pillow's g on every input, not its tables.

PhotoYCC: r = L[y] + CR[cr], g = L[y] + GB[cb] + GR[cr], b = L[y] + CB[cb]
with L[y] = round(1.3584 y), each read where it does not clip: CR and CB
are Pillow's; GB + GR is, and GB[0] = 0 fixes the split.
"""

from __future__ import annotations

import base64
import zlib

import numpy as np
from PIL import Image

LUMAS = (0, 94, 128, 255)  # between them, every difference below is read unclipped


def _grid(y: int) -> np.ndarray:
    """uint8 [256, 256, 3]: (y, cb, cr) with cb the row and cr the column."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    return np.stack([np.full_like(cb, y), cb, cr], -1).astype(np.uint8)


def _unclipped(outs: dict, base) -> np.ndarray:
    """outs: y -> int [256, 256, 3] Pillow RGB. -> [256, 256, 3] of
    out - base(y), read at a y where the channel did not clip."""
    got = np.full((256, 256, 3), np.iinfo(np.int64).min, np.int64)
    for y, out in outs.items():
        ok = (out > 0) & (out < 255) & (got == np.iinfo(np.int64).min)
        got[ok] = (out - base(y))[ok]
    assert (got != np.iinfo(np.int64).min).all(), "a difference clipped at every luma"
    return got


def ycbcr_tables() -> np.ndarray:
    """int64 [4, 256]: dR[cr], dB[cb], gCb[cb], gCr[cr]."""
    outs = {y: np.asarray(Image.fromarray(_grid(y), "YCbCr").convert("RGB")).astype(np.int64)
            for y in LUMAS}
    d = _unclipped(outs, lambda y: y)
    d_r, d_b, g = d[0, :, 0], d[:, 0, 2], d[..., 1]
    assert (d[..., 0] == d_r).all() and (d[..., 2] == d_b[:, None]).all()
    # gCb[cb] - n[cr] <= 64 g + 63 and n[cr] - gCb[cb] <= -64 g, n = -gCr
    a, n = np.zeros(256, np.int64), np.zeros(256, np.int64)
    for _ in range(513):
        a2 = np.minimum(a, (n[None, :] + 64 * g + 63).min(1))
        n2 = np.minimum(n, (a2[:, None] - 64 * g).min(0))
        if (a2 == a).all() and (n2 == n).all():
            break
        a, n = a2, n2
    else:
        raise AssertionError("no integer tables give Pillow's g")
    a, n = a - a[128], n - a[128]
    assert ((a[:, None] - n[None, :]) >> 6 == g).all()
    return np.stack([d_r, d_b, a, -n])


def photo_ycc_tables() -> np.ndarray:
    """int64 [4, 256]: CR[cr], CB[cb], GB[cb], GR[cr]."""
    lum = np.round(1.3584 * np.arange(256)).astype(np.int64)
    outs = {y: np.asarray(Image.frombytes("RGB", (256, 256), _grid(y).tobytes(), "raw",
                                          "YCC;P")).astype(np.int64) for y in LUMAS}
    d = _unclipped(outs, lambda y: lum[y])
    t_cr, t_cb, s = d[0, :, 0], d[:, 0, 2], d[..., 1]
    assert (d[..., 0] == t_cr).all() and (d[..., 2] == t_cb[:, None]).all()
    g_cr = s[0]
    g_cb = s[:, 0] - g_cr[0]
    assert (g_cb[:, None] + g_cr[None, :] == s).all()
    return np.stack([t_cr, t_cb, g_cb, g_cr])


def blob(tables: np.ndarray) -> str:
    return base64.b64encode(zlib.compress(tables.astype("<i2").tobytes(), 9)).decode()


if __name__ == "__main__":
    for name, tables in (("utils/modes.py", ycbcr_tables()), ("utils/pcd.py", photo_ycc_tables())):
        print(f"{name}:\n{blob(tables)}")
