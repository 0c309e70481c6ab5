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
- "LAB" (a and b signed bytes): Pillow's `convert` sends it through
  LittleCMS 2.17 (ImageCms, its built-in Lab V2 profile to sRGB,
  perceptual): a and b offset by 128, each 8-bit band widened to 16 bits
  (x * 257), then LittleCMS's optimised transform: the pipeline Lab ->
  XYZ (D50) -> the inverse of sRGB's colorant matrix (Rec. 709 primaries
  and D65 adapted to D50 by Bradford) -> the inverse sRGB curve, sampled
  on a 33^3 grid of 16-bit nodes (float stages, each node rounded as
  _cmsQuickSaturateWord rounds), read by tetrahedral interpolation in
  16-bit fixed point (TetrahedralInterp16) and cut to 8 bits
  ((x * 65281 + 2^23) >> 24). `lab_nodes` computes the grid; the suite
  holds the result to Pillow's on every L and a against a spread of b.
"""

from __future__ import annotations

import base64
import functools
import threading
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


# ---- LAB -> RGB as LittleCMS 2.17 computes it under Pillow 12.1.0 ------------------------------

_MAX_XYZ = 1.0 + 32767.0 / 32768.0  # LittleCMS's XYZ encoding (MAX_ENCODEABLE_XYZ)
_D50 = (0.9642, 1.0, 0.8249)
_LAB_GRID = 33  # _cmsReasonableGridpointsByColorspace for three channels


def _inv3(a):
    """_cmsMAT3inverse, in its order of operations."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _mul3(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j] for j in range(3)]
            for i in range(3)]


def _eval3(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3)]


def _srgb_to_xyz_d50():
    """cmsCreate_sRGBProfile's colorants: _cmsBuildRGB2XYZtransferMatrix of
    Rec. 709 under D65, adapted to D50 by Bradford (_cmsAdaptMatrixToD50)."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    coef = _eval3(_inv3([[xr, xg, xb], [yr, yg, yb], [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]),
                  [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    m = [[coef[0] * xr, coef[1] * xg, coef[2] * xb], [coef[0] * yr, coef[1] * yg, coef[2] * yb],
         [coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)]]
    brad = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367], [0.0389, -0.0685, 1.0296]]
    src = _eval3(brad, [(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0])
    dst = _eval3(brad, list(_D50))
    cone = [[dst[0] / src[0], 0.0, 0.0], [0.0, dst[1] / src[1], 0.0], [0.0, 0.0, dst[2] / src[2]]]
    return _mul3(_mul3(_inv3(brad), _mul3(cone, brad)), m)


def _saturate_word(d: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord: d + 0.5, clipped, floored at the 2^-16 its
    magic-number floor keeps."""
    d = np.asarray(d, np.float64) + 0.5
    magic = 68719476736.0 * 1.5
    floor = np.floor(((d - 32767.0) + magic - magic) * 65536.0).astype(np.int64) >> 16
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, floor + 32767))


@functools.lru_cache(maxsize=None)
def lab_nodes() -> np.ndarray:
    """The 33^3 grid LittleCMS samples its Lab -> sRGB pipeline on -> int64
    [33, 33, 33, 3] (L, a, b -> R, G, B, 16-bit)."""
    f32 = np.float32
    q = _saturate_word(np.arange(_LAB_GRID) * 65535.0 / (_LAB_GRID - 1))  # _cmsQuantizeVal
    planes = [(x.astype(f32) / f32(65535.0)).astype(np.float64)
              for x in np.meshgrid(q, q, q, indexing="ij")]  # From16ToFloat
    y = (planes[0] * 100.0 + 16.0) / 116.0  # EvaluateLab2XYZ, cmsLab2XYZ
    xyz = []
    for t, white in ((y + 0.002 * (planes[1] * 255.0 - 128.0), _D50[0]), (y, _D50[1]),
                     (y - 0.005 * (planes[2] * 255.0 - 128.0), _D50[2])):
        f = np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t)
        xyz.append((f * white / _MAX_XYZ).astype(f32).astype(np.float64))
    inv = _inv3(_srgb_to_xyz_d50())
    g, a, b, c, d = 2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045
    disc = (a * d + b) ** g
    out = []
    for i in range(3):  # the matrix (float out), then the inverse curve (parametric type -4)
        r = (xyz[0] * (inv[i][0] * _MAX_XYZ) + xyz[1] * (inv[i][1] * _MAX_XYZ)
             + xyz[2] * (inv[i][2] * _MAX_XYZ)).astype(f32).astype(np.float64)
        v = np.where(r >= disc, (np.power(np.maximum(r, 0.0), 1.0 / g) - b) / a, r / c)
        out.append(_saturate_word(v.astype(f32).astype(np.float64) * 65535.0))
    return np.stack(out, -1)


def lab_to_rgb(px: np.ndarray) -> np.ndarray:
    """uint8 [..., 3] of Pillow's "LAB" (a and b signed) -> uint8 [..., 3]
    RGB, as its convert computes it (TetrahedralInterp16 on `lab_nodes`)."""
    shape = px.shape[:-1]
    v = px.reshape(-1, 3).astype(np.int64)
    v[:, 1:] ^= 128
    v *= 257
    g = _LAB_GRID
    table = lab_nodes().reshape(-1, 3)
    f = v * (g - 1)
    f += (f + 0x7FFF) // 0xFFFF  # _cmsToFixedDomain
    r = f & 0xFFFF
    rx, ry, rz = r[:, 0], r[:, 1], r[:, 2]
    base = (f[:, 0] >> 16) * g * g + (f[:, 1] >> 16) * g + (f[:, 2] >> 16)
    step = np.where(v == 0xFFFF, 0, np.array([g * g, g, 1]))
    x, y, z = step[:, 0], step[:, 1], step[:, 2]
    # the six tetrahedra: the vertices after the first, in the order the weights take them
    case = np.select([(rx >= ry) & (ry >= rz), (rx >= ry) & (rz >= rx), rx >= ry, rx >= rz,
                      ry >= rz], [0, 1, 2, 3, 4], 5)
    order = np.array([[0, 1, 2], [2, 0, 1], [0, 2, 1], [1, 0, 2], [1, 2, 0], [2, 1, 0]])[case]
    w = np.take_along_axis(r, order, 1)  # the weights, largest first
    steps = np.take_along_axis(np.stack([x, y, z], 1), order, 1)
    p0 = table[base]
    p1 = table[base + steps[:, 0]]
    p2 = table[base + steps[:, 0] + steps[:, 1]]
    p3 = table[base + steps[:, 0] + steps[:, 1] + steps[:, 2]]
    rest = (p1 - p0) * w[:, :1] + (p2 - p1) * w[:, 1:2] + (p3 - p2) * w[:, 2:] + 0x8001
    out16 = (p0 + ((rest + (rest >> 16)) >> 16)) & 0xFFFF
    return ((out16 * 65281 + 8388608) >> 24).astype(np.uint8).reshape(shape + (3,))


_CAPTURES = threading.local()  # each thread's captures open (core_of), innermost last


def _captures() -> list:
    stack = getattr(_CAPTURES, "stack", None)
    if stack is None:
        stack = _CAPTURES.stack = []
    return stack


def note_core(mode: str, px: np.ndarray = None, palette: np.ndarray = None, transparency=None):
    """Record the image a decoder has made as Pillow's core holds it: its
    mode, its samples (None where only the mode is told), a "P" image's
    palette and the transparency Pillow keeps in its info. to_rgba notes
    every image it converts; decoders that convert on their own note
    theirs. Nothing is kept unless a `core_of` is open in this thread."""
    stack = _captures()
    if stack:
        stack[-1].append((mode, px, palette, transparency))


def turn_core(turn):
    """Apply a decoder's last step (a transposition of the image) to the
    samples it noted last."""
    stack = _captures()
    if stack and stack[-1] and stack[-1][-1][1] is not None:
        mode, px, palette, transparency = stack[-1][-1]
        stack[-1][-1] = (mode, np.ascontiguousarray(turn(px)), palette, transparency)


def core_of(decode):
    """Run `decode` -> (its RGBA, the last (mode, samples, palette,
    transparency) noted in this thread while it ran whose samples are of
    the decode's size (or untold), or None): Pillow's core image of a
    file, which utils/iptc.py takes as Pillow's IPTC load takes it."""
    stack = _captures()
    stack.append([])
    try:
        rgba = decode()
    finally:
        noted = stack.pop()
    for note in reversed(noted):
        if note[1] is None or note[1].shape[:2] == rgba.shape[:2]:
            return rgba, note
    return rgba, None


def to_rgba(mode: str, px: np.ndarray, palette: np.ndarray = None,
            transparency=None) -> np.ndarray:
    """An image of Pillow mode `mode` ([H, W] for one band, [H, W, n] for
    more) -> uint8 [H, W, 4]. `transparency` is a "P" image's: an index,
    or bytes of alphas."""
    note_core(mode, px, palette, transparency)
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
    elif mode == "LAB":
        out[..., :3] = lab_to_rgb(px)
    elif mode.startswith("I;16"):  # any byte order: the samples are values here
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
