"""IFUNC Image Memory (IM) and IM Tools (IMT) decoders, as Pillow 12.1.0
reads them (PIL/ImImagePlugin.py, ImtImagePlugin.py) and converts them to
RGBA.

Neither plugin has a test of the first bytes: `Image.open` runs their
header readers on every file that reaches them in its order (IM and IMT
after ICO), and utils/png.py does the same.

IM: a text header of "Key: value" lines (each at most 100 bytes; "\\r"
skipped; a NUL or ^Z ends it), then the data after the ^Z. "Image type"
names the mode and raw mode (OPEN below), "Image size (x*y)" the size
(512x512 by default) and "Lut" a 768-byte palette after the ^Z: a
palette that is not grey turns "L" into "P" and "LA" into "PA"; a grey
one is read and dropped. Rows are read by Pillow's raw unpackers: "1"
(bits, most significant first, rows padded to bytes), "P;2" and "P;4",
one byte a band, line-interleaved bands (";L": each row holds the first
band's samples, then the second's...), 16-bit samples in either byte
order, 32-bit signed integers, and 8/16/32-bit integers or 32-bit floats
read as "F"; the rows are stored bottom-up. The old "RGB3"/"RYB3" files
hold three planes, read as G, R and B. Only the first frame is read.

IMT: lowercase "key value" lines; "width", "height" and "pixel n8"; a
form feed at the start of a line begins the 8-bit grey data.

The n-bit samples of "L*n" images (n 2..31 but 8 and 16) are read as
Pillow's bit decoder reads them, by the host C++ loop `im_bits`
(csrc/image_entropy.cpp), quirk included: at a row's end the decoder
forgets how many bits it holds but not the bits, which it then OR-s into
the next row's first byte.

A header Pillow turns away (no newline in the first 100 bytes, a line
that is not "Key: value", no known key, no ^Z, a palette cut short, a
size that is not a pair) raises an error of PASSED_ON, and the file passes on;
a number Pillow cannot parse ends the decode (ValueError), as in Pillow.
Kinds Pillow opens and cannot load ("RLB", "RYB" and "PA" images, an
unknown image type) raise NotImplementedError naming them.
"""

from __future__ import annotations

import io
import re
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO, _entropy
from rustic_tpu_torch.utils._entropy import ptr
from rustic_tpu_torch.utils.modes import check_pixels, to_rgba, unpack_bits

# ImImagePlugin's tags and its OPEN table: image type -> (mode, raw mode)
FRAMES, LUT, SIZE, MODE = "File size (no of images)", "Lut", "Image size (x*y)", "Image type"
TAGS = ("Comment", "Date", "Digitalization equipment", FRAMES, LUT, "Name", "Scale (x,y)", SIZE,
        MODE)
OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
    "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"),
    "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"), "RYB3 image": ("RGB", "RYB;T"),
    "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ["8", "8S", "16", "16S", "32", "32F"]:
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ["16", "16L", "16B"]:
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")

# raw mode -> (the dtype of one sample, the bands a row holds line by line)
_SAMPLES = {
    "L": ("u1", 1), "P": ("u1", 1), "RGB": ("u1", 3), "RGB;L": ("u1", 3), "LA;L": ("u1", 2),
    "PA;L": ("u1", 2), "RGBA;L": ("u1", 4), "RGBX;L": ("u1", 4), "CMYK;L": ("u1", 4),
    "YCbCr;L": ("u1", 3), "I;16": ("<u2", 1), "I;16L": ("<u2", 1), "I;16B": (">u2", 1),
    "I;32": ("<i4", 1), "I;32S": ("<i4", 1), "F;8": ("u1", 1), "F;8S": ("i1", 1),
    "F;16": ("<u2", 1), "F;16S": ("<i2", 1), "F;32": ("<u4", 1), "F;32F": ("<f4", 1),
}


# the (mode, raw mode) pairs Pillow loads: OPEN's, but "RLB" and "PA;L" into "LA", and the
# n-bit samples of its bit decoder; and the palette images a Lut makes
_READ = {(m, r) for m, r in OPEN.values() if r in _SAMPLES or r in ("1", "P;2", "P;4", "RGB;T",
                                                                    "RYB;T")} - {("LA", "PA;L")}
_READ |= {("P", "P"), ("PA", "PA;L")}


class Im(NamedTuple):
    mode: str
    rawmode: str
    size: tuple  # as the header gives it: (width, height) for a file Pillow loads
    offset: int  # the first byte of the data
    palette: np.ndarray  # uint8 [256, 3] of a "P" or "PA" image, else None


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def open_im(raw: bytes) -> Im:
    """ImImageFile._open -> Im."""
    if b"\n" not in raw[:100]:
        raise SyntaxError("not an IM file: no newline in the first 100 bytes")
    fp = io.BytesIO(raw)
    info = {MODE: "L", SIZE: (512, 512), FRAMES: 1}
    rawmode, n = "L", 0
    while True:
        s = fp.read(1)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        s = s + fp.readline()
        if len(s) > 100:
            raise SyntaxError("not an IM file: a header line over 100 bytes")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _SPLIT.match(s)
        if not m:
            raise SyntaxError(f"syntax error in IM header: {s[:40]!r}")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in (FRAMES, "Scale (x,y)", SIZE):
            v = tuple(map(_number, v.replace("*", ",").split(",")))  # ValueError ends the open
            if len(v) == 1:
                v = v[0]
        elif k == MODE and v in OPEN:
            v, rawmode = OPEN[v]
        info[k] = v
        n += k in TAGS
    if not n:
        raise SyntaxError("not an IM file: no IM header key")
    size, mode = info[SIZE], info[MODE]
    while s and not s.startswith(b"\x1a"):
        s = fp.read(1)
    if not s:
        raise SyntaxError("IM file truncated: no ^Z before the data")
    palette = None
    if LUT in info:
        lut = fp.read(768)
        if len(lut) < 768:
            raise SyntaxError("IM palette cut short")
        p = np.frombuffer(lut, np.uint8).reshape(3, 256)
        if mode in ("L", "LA", "P", "PA") and not (p == p[:1]).all():
            mode, rawmode = ("P", "P") if mode in ("L", "P") else ("PA", "PA;L")
            palette = np.ascontiguousarray(p.T)
    try:  # ImageFile's checks of what _open set
        bad = not mode or size[0] <= 0 or size[1] <= 0
    except (TypeError, IndexError) as e:
        raise SyntaxError(f"IM size {size!r}") from e
    if bad:
        raise SyntaxError(f"IM of mode {mode!r} and size {size!r}")
    check_pixels(size[0], size[1], "IM")
    return Im(mode, rawmode, size, fp.tell(), palette)


def _refuse(variant: str):
    raise NotImplementedError(f"IM {variant} is not decoded ({FORMATS_TODO})")


def _rows(raw: bytes, offset: int, w: int, h: int, dtype: str, bands: int,
          lines: bool = True) -> np.ndarray:
    """h rows of w samples of `bands` bands, line-interleaved (or pixel-
    interleaved) -> [h, w, bands]."""
    count = w * h * bands
    if len(raw) < offset + count * np.dtype(dtype).itemsize:
        raise ValueError("IM image data is truncated")
    rows = np.frombuffer(raw, dtype, count=count, offset=offset)
    return rows.reshape(h, bands, w).transpose(0, 2, 1) if lines else rows.reshape(h, w, bands)


def _bits(raw: bytes, offset: int, w: int, h: int, bits: int) -> np.ndarray:
    stride = (w * bits + 7) // 8
    if len(raw) < offset + stride * h:
        raise ValueError("IM image data is truncated")
    rows = np.frombuffer(raw, np.uint8, count=stride * h, offset=offset).reshape(h, stride)
    return unpack_bits(rows, bits, w)


def _bit_samples(raw: bytes, offset: int, w: int, h: int, bits: int) -> np.ndarray:
    """The "bit" decoder's n-bit samples (host C++ `im_bits`) -> float32 [h, w]."""
    data = np.frombuffer(raw, np.uint8)[offset:]
    out = np.zeros((h, w), np.float32)
    if _entropy.library().im_bits(ptr(data), len(data), bits, w, h, ptr(out)) < 0:
        raise ValueError("IM image data is truncated")
    return out


def decode_im(raw: bytes, im: Im = None) -> np.ndarray:
    """IM bytes (or their `open_im` header) -> uint8 [H, W, 4], as Pillow's
    convert("RGBA")."""
    raw = bytes(raw)
    im = im or open_im(raw)
    mode, rawmode = im.mode, im.rawmode
    if not (len(im.size) == 2 and all(isinstance(v, int) for v in im.size)):
        raise ValueError(f"IM size {im.size!r} is not two integers")
    w, h = im.size
    if mode == "F" and rawmode[2:].isdigit() and int(rawmode[2:]) not in (8, 16, 32):
        return to_rgba("F", _bit_samples(raw, im.offset, w, h, int(rawmode[2:])))
    if (mode, rawmode) not in _READ:
        _refuse(f"image type {mode!r} read as {rawmode!r} (Pillow has no unpacker for it)")
    # every tile of the plugin is read bottom-up
    if rawmode == "1":
        return to_rgba("1", _bits(raw, im.offset, w, h, 1)[::-1] * np.uint8(255))
    if rawmode in ("P;2", "P;4"):
        return to_rgba("P", _bits(raw, im.offset, w, h, int(rawmode[2]))[::-1], im.palette)
    if rawmode in ("RGB;T", "RYB;T"):
        g, r, b = (_rows(raw, im.offset + k * w * h, w, h, "u1", 1)[::-1, :, 0] for k in range(3))
        return to_rgba("RGB", np.stack([r, g, b], -1))
    px = _rows(raw, im.offset, w, h, *_SAMPLES[rawmode], lines=rawmode.endswith(";L"))[::-1]
    if mode == "F":
        return to_rgba("F", px[..., 0].astype(np.float32))
    if mode == "I":
        return to_rgba("I", px[..., 0])
    if mode.startswith("I;16"):
        return to_rgba(mode, px[..., 0])
    if rawmode == "RGBX;L":
        px = px[..., :3]
    return to_rgba(mode, px[..., 0] if px.shape[2] == 1 else px, im.palette)


class Imt(NamedTuple):
    width: int
    height: int
    offset: int  # None where no form feed begins the data


def open_imt(raw: bytes) -> Imt:
    """ImtImageFile._open -> Imt."""
    fp = io.BytesIO(raw)
    buffer = fp.read(100)
    if b"\n" not in buffer:
        raise SyntaxError("not an IM Tools file: no newline in the first 100 bytes")
    xsize = ysize = 0
    size, mode, offset = (0, 0), "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s:
            break
        if s == b"\x0c":
            offset = fp.tell() - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            xsize = int(v)  # ValueError ends the open
            size = xsize, ysize
        elif k == b"height":
            ysize = int(v)
            size = xsize, ysize
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise SyntaxError(f"IM Tools header of mode {mode!r} and size {size}")
    check_pixels(size[0], size[1], "IMT")
    return Imt(size[0], size[1], offset)


def decode_imt(raw: bytes, t: Imt = None) -> np.ndarray:
    """IMT bytes (or their `open_imt` header) -> uint8 [H, W, 4]."""
    raw = bytes(raw)
    t = t or open_imt(raw)
    if t.offset is None:
        raise ValueError("IM Tools file has no form feed before its data: no image to load")
    return to_rgba("L", _rows(raw, t.offset, t.width, t.height, "u1", 1)[..., 0])
