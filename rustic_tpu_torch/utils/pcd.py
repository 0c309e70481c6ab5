"""A Kodak PhotoCD (PCD) decoder, as Pillow 12.1.0 reads it
(PIL/PcdImagePlugin.py, its PcdDecode.c and the PhotoYCC unpacker of
UnpackYCC.c) and converts it to RGBA.

PCD has no test of the first bytes: `Image.open` runs its header reader
on every file that reaches it in its order (after MSP), and utils/png.py
does the same. The header is "PCD_" at byte 2048; byte 2048 + 1538 holds
the orientation in its low two bits. The base image, 768x512, starts at
sector 96 (byte 196608): each pair of rows is 768 luma samples of the
first row, 768 of the second, then 384 Cb and 384 Cr samples the two
rows share (one a pair of columns). PhotoYCC -> RGB: r = L[y] + CR[cr],
g = L[y] + GB[cb] + GR[cr], b = L[y] + CB[cb], each clipped to 0..255,
with L[y] = round(1.3584 y) and the other four tables (YCC_TABLES) read
back from Pillow's unpacker by tests/derive_ycc_tables.py: the suite
holds them to it on all 2**24 inputs. Orientation 1 turns the image 90 degrees
counter-clockwise, 3 turns it 270 (Pillow's rotate with expand): a
512x768 result.

A file without "PCD_" at byte 2048, or too short to hold the orientation
byte, raises an error of PASSED_ON and passes on; a base image cut short raises
ValueError, as Pillow's load raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils.modes import int16_tables

WIDTH, HEIGHT = 768, 512
OFFSET = 96 * 2048  # the base image's sector
_L = np.round(1.3584 * np.arange(256)).astype(np.int64)
_YCC = (
    "eNpN1Yt/z3UcxfGTRJJEkkiSS5JE0iJJLkmaJC2S5JIkkiSSXJK0SGLMzFzmthm72Nhmm5nbWC5jMZdZ5raMMffb"
    "fE6nD98+/Z5/we/xeZ33tzTLsCzLsTwrsCIrsTKrsCqrsTprsCZrsQ7rsh7rswEbshEbswmb0ofN2Jwt2JKt2Jpt"
    "2Y7t2YEd6ctO7Mwu7Eo/dmN39mBP9mJv9mU/9ucADuQgDuYQDuUwDucIjuQojuYYjuN4TuBETqI/J3MKp3IapzOA"
    "sxjIIAYzhPO5gKFczKUM43JGcCWjGMNYxnENE7iWyVzHVKZxIzcznduYwe3cyUzuYRb3MpsHeIiHmcsjPMrjPMl8"
    "nuJpFvIcz/MCL/EKr/EGi3mLJFACJXEPSqMMyqIcyuNBVEQlVEYVVEU1VEcN1EQt1EZd1EN9NEBDPIfGaIKm8MFL"
    "aI4WaIlWaI02aIf26ICO8EUndEYXdIUf3kd39EBP9EJv9EE/9McADMTnGIwhGIphGI5vMBKjMBpjMA7jMQETMQn+"
    "+AVTMBXTMB0BmIlABCEYIZiHBQjFYixFGMIRgZWIQgxiEYc1SMBaJCMFqUjDRmxGOrYiA9uxE5nYjSzsRTaWmXAT"
    "YSJNtFll4ky8STRJJsWkmg1mk9litpoMs8PsMrtNltln9puDJsfkmjxzzJww+abAnDFnTZG5YC6bq+a6uWmMAUuw"
    "JEv9ryqvKVeU15OrybXkleQ68ipyDbmCvH5cPV47rhyvG1eNa8YrxvXi1eJacaV4nbhKvEZcIa4Prw7XhleG68JV"
    "4TXhivB6cDV4LbgSXAdeBa4BrwD3/u71b7/9AeTg35/+Do11S4rlpnVDrss166pckcvWJbkoF+S8VSTn5KxVKGfk"
    "tFUgp+RvK19OygnruByTo1aeHJG/rFw5LDnWITkoB6z9ki37rL3yp2RZe2S3ZFq7ZKfskO3WH5Ih26ytki5brM2y"
    "STZaGyRN1lupsk5S/pMsSdZaSZQEK17WyGorTmJllRUj0RJlRcpKWSER1nIJlzBrmSyVJdZiWSSh1kJZIPOteRIi"
    "c61gmSNB1mwJlFnWTAmQGdygNtarkHXqJFmSVEyiuolXPavVUCxWqaVoFRWFSJW1Qn0tV2VhWKbalqi5RSovFAtV"
    "4HxdoxDMVY9zVOVstTlLZupezVCrv6vY39Ttr6p3shr2l59V809q+keV/YP6Hoex6vx71T4a36n6b9X+CC1gOL7W"
    "Er7SHr6UIfhC6xikmzkQn2krn2oxn2g3faWPrurH2tFHWtOH2tQHWlY33Vw/eU9Le1d7e0ere1vb88Vb2uCbWmIH"
    "vKFFvq5dttU62+h2v6advqq1tsQrWu3L2m4z3XYfvKglv6A9P69VN0YjrbshntXKn9HWn9bin9Lu6+jbUFsX4End"
    "gSd0DR7XTXhMl6EqHtWFeEQq42Hdi4d0NSrodpTHA7oh9+uSlMV9uij36q6U0heoJO7WlbnLLvT2OovtKq/bNV6x"
    "K7x4Z39FdnmFdnEFdmn5dxZ23G4rz24q127pkN3Q7f38A2IVjE4="
)
YCC_TABLES = int16_tables(_YCC)  # CR[cr], CB[cb], GB[cb], GR[cr]


class Pcd(NamedTuple):
    turns: int  # quarter turns counter-clockwise: 0, 1 or 3


def open_pcd(raw: bytes) -> Pcd:
    """PcdImageFile._open -> Pcd."""
    s = raw[2048 : 2048 + 1539]
    if not s.startswith(b"PCD_"):
        raise SyntaxError("not a PCD file: no PCD_ at byte 2048")
    if len(s) < 1539:
        raise SyntaxError("PCD header cut short before its orientation byte")
    return Pcd({1: 1, 3: 3}.get(s[1538] & 3, 0))


def photo_ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """uint8 planes of PhotoYCC -> uint8 [..., 3] RGB, as Pillow's unpacker."""
    l_y = _L[y]
    t_cr, t_cb, g_cb, g_cr = YCC_TABLES
    rgb = np.stack([l_y + t_cr[cr], l_y + g_cb[cb] + g_cr[cr], l_y + t_cb[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def decode_pcd(raw: bytes, p: Pcd = None) -> np.ndarray:
    """PCD bytes (or their `open_pcd` header) -> uint8 [H, W, 4]."""
    raw = bytes(raw)
    p = p or open_pcd(raw)
    chunk = 3 * WIDTH  # two rows of luma, then the pair's Cb and Cr
    need = chunk * HEIGHT // 2
    if len(raw) < OFFSET + need:
        raise ValueError("PCD base image is truncated")
    pairs = np.frombuffer(raw, np.uint8, count=need, offset=OFFSET).reshape(HEIGHT // 2, chunk)
    y = pairs[:, : 2 * WIDTH].reshape(HEIGHT, WIDTH)
    half = np.arange(WIDTH) // 2
    cb = np.repeat(pairs[:, 2 * WIDTH + half], 2, axis=0)
    cr = np.repeat(pairs[:, 2 * WIDTH + WIDTH // 2 + half], 2, axis=0)
    out = np.full((HEIGHT, WIDTH, 4), 255, np.uint8)
    out[..., :3] = photo_ycc_to_rgb(y, cb, cr)
    return np.ascontiguousarray(np.rot90(out, p.turns))
