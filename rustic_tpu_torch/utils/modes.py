"""Pillow 12.1.0's `convert("RGBA")` from each image mode the classic and
legacy decoders (utils/pnm.py, qoi.py, ico.py, pcx.py, sgi.py, the DIB
core of utils/bmp_tga.py, im.py, iptc.py, spider.py, blp.py, fits.py,
fli.py, gbr.py, msp.py, sun.py, xbm.py, xpm.py...) produce, on NumPy
arrays:

- "1" (0 or 255), "L" and "P" (indices into a [256, 3] palette; no
  palette reads as every index black, as Pillow's empty one does): grey
  or looked-up RGB, alpha 255;
- "RGB", "RGBA";
- "CMYK": 255 - k - c * (255 - k) / 255 in Pillow's fixed-point MULDIV255;
- "I" (32-bit integers): each value clipped to 0..255;
- "F" (float32): clipped to 0..255 and cut toward zero (NaN reads 0);
- "I;16" (16-bit unsigned, either byte order once read): clipped to 255;
- "LA" and "PA": grey or looked-up RGB, with the second band as alpha;
- "P" with a transparency: an index (its alpha 0) or bytes (Pillow's
  `putpalettealphas`: the alpha of indices 0, 1, ... is each byte's value);
- "YCbCr": Pillow's ConvertYCbCr.c, r = y + dR[cr], b = y + dB[cb] and
  g = y + ((gCb[cb] + gCr[cr]) >> 6), each clipped to 0..255. The four
  tables (YCC_TABLES) are read back from Pillow 12.1.0's conversion by
  tests/derive_ycc_tables.py: dR and dB exactly, gCb and gCr as integer
  tables that give its g on all 2**24 inputs (the suite holds them to
  it).
"""

from __future__ import annotations

import base64
import zlib

import numpy as np

# PIL.Image.MAX_IMAGE_PIXELS: above twice this Image.open raises DecompressionBombError
MAX_PIXELS = 2 * 89478485


_YCC = (
    "eNo11IlfHPUZx/Hv7NwDLMcCtn3VVFuPtlaMoYGSZBMIR0JM8CDaarRVq/WKiCIQAoQAAVkSSRSr1rP1aj1CMRiB"
    "EEIgQIBUosG2Wtta21cP7nN3dnZ25ulv9wX/wvP+fJ/ttIOupxvoJsqnnXQL/ZhupdtoF91BP6U76S66m+6he+k+"
    "up8epIdoNxXQI/QoPUZFVEwltIfKaC9VUCVV0X6qplo6QPX0BDVQIx2kJ6mJDtNT9DQ9Q7+kZ+l5+hW9SC/Ry/Qq"
    "/Zpeo9fpDXqLfktv0zv0Lh2lFmql9+kYfUDHqZ06qJO66CSdoh46TX10hgZokM7SMI3QH+gjGqWP6RMao0/pj/Rn"
    "+oz+Ql/QX+nv9CV9Rf+kf9G/6T/0PxqnCZqiaZqlOVqgRVoiH+lkUIBMssgmgIMDAkTIUKAiApFwIhoxiIMLCUjE"
    "Rfg6voFv4mKswiW4FN/BZbgcV+K7+D6uwg+QhGtwLdYgGWuRgh8hDeuwAW5sQjoykIks5GALtmIbrsMO5OF63Iib"
    "sBM34xb8BLdiF27HHfgZ7sTd+DnuwS9wHx7Ag3gID6MAhXgUj+FxFKMUe1CGclRgH6qwHzWoRR3q0QAPGnEIT+Iw"
    "juApNOMZPIvn8DxewIt4Ga/gVfwGr+ENvIm38Du8jXfxHo7i92jFMVxMq+gS+jZdRlfQlfQ9uoqupiRaTWvoh5RC"
    "qZRG68lNGymdNlMWZdMWyqXrWDN54WZ20s3hYnbR7eFeVmp5YLmVQlbK46yUUtZJOetkH6ukhlVSxxrxsEIOsUKO"
    "sD6aWR/PLdfxynIbby6X8V64i2PUFq6ik06Em1gpYqWHlRpCLXzOWgiV8A9WQqiD/7IOQhXMsAbmWQNeVoCfFRBc"
    "9ueX9bVl+9iw/EX4Wth9Fb4VVr8cV4TNV8RXvEPaG5l2yDqbWYektzPpkHP+svJty8Z3MeF7mfD9zHc3832E6RYx"
    "3RJmu5fJVjLZauZ6IOzaiINh1RXTFdGQ5+vMM6T5DtMMWb7PLD/Ah+jACXShGz3oRR/6MYghjOAcPsJ5fIIL+BR/"
    "wmf4HF/gb/gSX4GL0LVhrVdr1jxalZav5WpuzaXJmqVeUAfUbvWIWqdWqHlqtrpOdaqCaiijSp/SqRxUqpU9Sq6S"
    "oaQoqgJlTB6WT8nNcoNcKefLObJbjpVF2ZLOSwNSl9Qk1UllUp6UKaVJURInGeI5sVfsED1itVgi5orpoktURUsY"
    "E84K3cLTQp1QKdwgZAsbBKcgCgF+lO/nO/kmvoYv47fzGXwar/EcrzuGHb2OZofHUeXId+Q63A6XQ3ZY3AVugOvm"
    "DnN1XDmXx2VzaZyT4zmD3aAXneym1ezaucwrhe0dGGMF9bACPeyL5bO+3RRHIln2x/aAfdJusuvsvXaenWWn2VE2"
    "ZxvWOavX6rA8VrVVYuVa6ZbLUi07OBYcCnYHm4P1wcrgjcHsoDsYHRSDpjlqDpidZpNZa5aZO8wMM82MMDnTHxgO"
    "9AaaA55AVSA/kBtwB1wBOWAZF4wBo9s4YtQZFUaekW2sM5yGYBj+UX+fv9N/yF/tL/Nv82f4U/2qn/OP6cN6j96s"
    "e/RKPV/P0d16rC7qlu+8b8DX5Wvy1fnKfHm+TF+aL8rH+QzvOW+vt8Pr8VZ7S7y53nSvy6t6pxPbE6sStySuSTQT"
    "ziQcTShN2JQgJyzEd8XXxj8cnxpPrrOuNle5K9N1tUuP64l7Iq4obn0cHzcd2x5bFbslNjnWjDkT0xJTGrMpRo5Z"
    "jO6Kro0uiE6NJueQs81Z7sx0Jjn1qJ6ohqiiqPVRfNRMZHtkVeTWyORIM6I/oiWiNGJThBKxqHVpB7QCLVUjdUht"
    "U8vVLDVJ1ZXTSoNSpKxXBGVGbpf3y1vlZNmU+qUWqVRKlxRpUTwpHhALxFQR4pDQJlQIWUKS4OdP8w18Eb+BF/gZ"
    "R4djv2OrI9kR5Pq5Fm4Pl84p3BJOso0VsPUCw+yvVLLPdg0Zdq/tsYttty3ac1YnE8611lpWcCDYGiwLZgTVoNfs"
    "NuvMQqbImSOB44HKQHZgdcAweo1Go9hwG5Ixx5yqmdFav6UP6q16mZ6ha7rX1+2r9xUyCYdvxHvcW+nN8a72Gkt9"
    "S41LxUvuJWlpbrFzsWZx2+LaRXthcKF1oWxh84K24J0/NV8/XzifNu+YH5k7PrdvLmdu9Vxgtm+2cbZ4duOsNDs3"
    "c2KmZmbbTMqMPT043Tq9d3rztDbtmzo1VT9VOLVuyjE1Mvnh5L7JnMlrJwMTfRONEyUTGyekifnxE+M147vH/w+K"
    "XfX2"
)


def int16_tables(blob: str) -> np.ndarray:
    """The base64 of zlib'd little-endian int16 [4, 256] that
    tests/derive_ycc_tables.py writes -> int64 [4, 256]."""
    return np.frombuffer(zlib.decompress(base64.b64decode(blob)), "<i2").reshape(4, 256).astype(
        np.int64)


YCC_TABLES = int16_tables(_YCC)  # dR[cr], dB[cb], gCb[cb], gCr[cr]


def check_pixels(width: int, height: int, what: str):
    """Pillow's decompression-bomb refusal, for a header whose pixels the
    file's size does not bound (run-length data)."""
    if width * height > MAX_PIXELS:
        raise ValueError(f"{what} of {width}x{height} pixels is over Pillow's limit of "
                         f"{MAX_PIXELS} (a decompression bomb)")


def muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def ycbcr_to_rgb(px: np.ndarray) -> np.ndarray:
    """uint8 [..., 3] YCbCr -> uint8 [..., 3] RGB, as Pillow converts."""
    y, cb, cr = (px[..., i].astype(np.int64) for i in range(3))
    d_r, d_b, g_cb, g_cr = YCC_TABLES
    rgb = np.stack([y + d_r[cr], y + ((g_cb[cb] + g_cr[cr]) >> 6), y + d_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def to_rgba(mode: str, px: np.ndarray, palette: np.ndarray = None,
            transparency=None) -> np.ndarray:
    """An image of Pillow mode `mode` ([H, W] for one band, [H, W, n] for
    more) -> uint8 [H, W, 4]. `transparency` is a "P" image's: an index,
    or bytes of alphas."""
    h, w = px.shape[:2]
    out = np.full((h, w, 4), 255, np.uint8)
    if mode in ("1", "L"):
        out[..., :3] = px[..., None]
    elif mode == "LA":
        out[..., :3] = px[..., :1]
        out[..., 3] = px[..., 1]
    elif mode in ("P", "PA"):
        pal = np.zeros((256, 3), np.uint8) if palette is None else palette
        idx = px[..., 0] if mode == "PA" else px
        out[..., :3] = pal[idx]
        if mode == "PA":
            out[..., 3] = px[..., 1]
        elif transparency is not None:
            alpha = np.full(256, 255, np.uint8)
            if isinstance(transparency, bytes):
                alpha[: len(transparency)] = np.frombuffer(transparency[:256], np.uint8)
            else:
                alpha[transparency] = 0
            out[..., 3] = alpha[idx]
    elif mode == "YCbCr":
        out[..., :3] = ycbcr_to_rgb(px)
    elif mode == "I;16":
        out[..., :3] = np.minimum(px, 255).astype(np.uint8)[..., None]
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
