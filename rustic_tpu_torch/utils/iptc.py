"""An IPTC/NAA image decoder, as Pillow 12.1.0 reads it
(PIL/IptcImagePlugin.py) and converts it to RGBA.

IPTC has no test of the first bytes: `Image.open` runs its header reader
on every file that reaches it in its order (after IM and IMT), and
utils/png.py does the same. The file is a run of fields: 0x1C, a record
and dataset number, and a 15-bit size (or, above 128, a size of that
many bytes less 128). Fields up to the first image field (8, 10) are
read; (3, 60) gives the layers and the component flag (one layer and no
flag: "L"; three or four with the flag: "RGB" or "CMYK", of which the
image holds the band (3, 65) names), (3, 20) and (3, 30) the size, and
(3, 120) the compression: 1, raw, or 5, a file of its own.

The image fields' data is joined. Raw data gets a "P5" header of the
size and is read as a PGM (utils/pnm.py); compression 5 data is opened
as Pillow opens any file (utils/png.py's walk, TGA tried at its place as
Pillow tries it on a file without a name). Pillow's IPTC load keeps that
file's core image and nothing of its info, so the decoders note the core
they make (utils/modes.py `note_core`, `core_of`: its mode, samples and
palette). A grey image is that core through Pillow's C convert: a
transparency kept in the info (a PNG's tRNS, a GIF's or an XPM's index)
is dropped, and a mode the C convert has no way from (16-bit grey, "F",
LAB) raises ValueError as Pillow's does. A colour image is the merge of
that image as its band and zero bands, so the result has the embedded
image's size: the bands after the first must be "L", the first any
one-band image, whose bytes Image.merge takes ("1" as 0 and 255, "P"
its indices, 16-bit words the first row bytes of each row).

A field that is not an IPTC field (or cut short) before the image, or a
header without the fields Pillow reads, raises an error of PASSED_ON and the
file passes on; a field length over 132, a band Pillow cannot place, or
an embedded image Pillow cannot read ends the decode (ValueError); a
compression other than 1 and 5 (Pillow refuses it), a band of a file
whose mode the port does not tell (one no decoder notes, and not a JPEG,
PNM or PNG), and a first band of mode "I" or "F" (Pillow's merge of
32-bit samples ends its process) raise NotImplementedError naming them.
"""

from __future__ import annotations

import io
import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO, xpm
from rustic_tpu_torch.utils.modes import check_pixels, to_rgba

COMPRESSION = {1: "raw", 5: "jpeg"}
_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)


class Iptc(NamedTuple):
    mode: str  # "L", "RGB" or "CMYK"
    band: int  # the band the image is, None for "L"
    width: int
    height: int
    compression: str
    offset: int  # the first image field, None where the file has none


def _i(c: bytes) -> int:
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


def _field(fp):
    """IptcImageFile.field -> (tag, size), (None, 0) at the end."""
    s = fp.read(5)
    if not s.strip(b"\x00"):
        return None, 0
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in _RECORDS:
        raise SyntaxError("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise OSError("illegal field length in IPTC/NAA file")
    if size == 128:
        return tag, 0
    if size > 128:
        return tag, _i(fp.read(size - 128))
    return tag, struct.unpack_from(">H", s, 3)[0]


def open_iptc(raw: bytes) -> Iptc:
    """IptcImageFile._open -> Iptc."""
    fp, info = io.BytesIO(raw), {}
    while True:
        offset = fp.tell()
        tag, size = _field(fp)
        if not tag or tag == (8, 10):
            break
        data = fp.read(size) if size else None
        if tag in info:
            info[tag] = info[tag] + [data] if isinstance(info[tag], list) else [info[tag], data]
        else:
            info[tag] = data
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode, band = "", None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    size = _i(info[(3, 20)]), _i(info[(3, 30)])
    try:
        compression = COMPRESSION[_i(info[(3, 120)])]
    except KeyError as e:  # Pillow's OSError: it ends the open
        raise NotImplementedError(f"IPTC image compression other than 1 (raw) and 5 (a file), "
                                  f"which Pillow refuses, is not decoded ({FORMATS_TODO})") from e
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise SyntaxError(f"IPTC image of mode {mode!r} and size {size}")
    check_pixels(size[0], size[1], "IPTC image")
    return Iptc(mode, band, size[0], size[1], compression, offset if tag == (8, 10) else None)


def _grey_jpeg(data: bytes) -> bool:
    """Whether a JPEG's frame has one component (Pillow's mode "L")."""
    pos = 2
    while pos + 4 <= len(data):
        marker, length = data[pos + 1], struct.unpack_from(">H", data, pos + 2)[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return pos + 9 < len(data) and data[pos + 9] == 1
        pos += 2 + length
    return False


def decode_iptc(raw: bytes, t: Iptc = None) -> np.ndarray:
    """IPTC bytes (or their `open_iptc` header) -> uint8 [H, W, 4]."""
    from rustic_tpu_torch.utils import png  # png.py dispatches to this module

    raw = bytes(raw)
    t = t or open_iptc(raw)
    if t.offset is None:
        raise ValueError("IPTC file has no image field: no image to load")
    fp, out = io.BytesIO(raw), io.BytesIO()
    if t.compression == "raw":
        out.write(b"P5\n%d %d\n255\n" % (t.width, t.height))
    fp.seek(t.offset)
    while True:
        try:
            kind, size = _field(fp)
        except (SyntaxError, IndexError, struct.error, OSError) as e:
            raise ValueError(f"IPTC image field: {e}") from e
        if kind != (8, 10):
            break
        out.write(fp.read(size))
    data = out.getvalue()
    fmt, decode = png._identify(data, ".tga")  # Pillow's open tries TGA on any file
    if fmt == "XPM":  # the "None" colour is kept in the info, which the record drops
        decode = lambda: xpm.decode_xpm(data, xpm.open_xpm(data)._replace(  # noqa: E731
            transparency=None))
    if t.band is None:
        return _as_iptc(fmt, data, decode)
    rgba, core = _core(fmt, data, decode)
    mode = core[0] if core else _band_mode(fmt, data)
    if mode is None:
        raise NotImplementedError(f"IPTC {t.mode} image whose band is a {fmt} file is not "
                                  f"decoded ({FORMATS_TODO})")
    first = -len(t.mode) <= t.band < len(t.mode) and t.band % len(t.mode) == 0
    if mode != "L" and not first:  # Image.merge holds the bands after the first to "L"
        raise ValueError(f"IPTC {t.mode} band of a {mode} image (Pillow's merge: mode "
                         "mismatch)")
    if mode not in _ONE_BAND:
        raise ValueError(f"IPTC {t.mode} band of a {mode} image (Pillow's merge: image has "
                         "wrong mode)")
    band = _merged_band(mode, rgba, core)
    if band is None:
        raise NotImplementedError(f"IPTC {t.mode} image whose band is a {fmt} file of mode "
                                  f"{mode} is not decoded ({FORMATS_TODO})")
    bands = [np.zeros(band.shape, np.uint8)] * len(t.mode)
    try:
        bands[t.band] = band
    except IndexError as e:
        raise ValueError(f"IPTC band {t.band} of a {t.mode} image") from e
    return to_rgba(t.mode, np.stack(bands, -1))


# the modes Pillow's C convert takes to RGBA (ImagingConvert); from the rest it raises
# ValueError, and the IPTC image's own mode ("L", "RGB", "CMYK") gives it no second way
_C_CONVERT = ("1", "L", "P", "PA", "LA", "RGB", "RGBA", "RGBa", "CMYK", "I")
_ONE_BAND = ("1", "L", "P", "I", "F", "I;16", "I;16L", "I;16B", "I;16N")


def _core(fmt: str, data: bytes, decode):
    """The embedded file's decode and Pillow's core image of it, as its
    decoder noted it (utils/modes.py `core_of`): (mode, samples, palette,
    transparency) or None."""
    from rustic_tpu_torch.utils.modes import core_of

    if fmt == "PNG":
        from rustic_tpu_torch.utils import png

        decode = lambda: png.decode_png(data, transparency=False)  # noqa: E731
    return core_of(decode)


def _as_iptc(fmt: str, data: bytes, decode) -> np.ndarray:
    """The embedded image as the IPTC image converts it: Pillow's IPTC
    load takes the embedded file's core image and nothing of its info, so
    convert("RGBA") is the C conversion alone: a transparency kept in the
    info (a PNG's tRNS, a GIF's or an XPM's index) is dropped, and a mode
    only Python-side steps convert (16-bit grey, floats, LAB, YCbCr) is
    refused as the C convert refuses it."""
    rgba, core = _core(fmt, data, decode)
    if core is None:
        return rgba
    mode, px, palette, transparency = core
    if mode not in _C_CONVERT:
        raise ValueError(f"IPTC image holding a {fmt} file of mode {mode} (Pillow: conversion "
                         f"from {mode} to RGBA not supported)")
    if transparency is not None and px is not None:
        return to_rgba(mode, px, palette)
    return rgba


def _merged_band(mode: str, rgba: np.ndarray, core):
    """The bytes Image.merge takes from a one-band image: its samples
    where they are bytes ("1" as 0 and 255, "P" its indices), the first
    row bytes of each row of 16-bit words; None where the port does not
    hold them (or Pillow's merge of 32-bit samples ends its process)."""
    px = core[1] if core else None
    if mode in ("1", "L"):
        return rgba[..., 0]
    if mode == "P" and px is not None:
        return px.astype(np.uint8)
    if mode.startswith("I;16") and px is not None:
        words = px.astype(">u2" if mode == "I;16B" else "<u2")
        return words.view(np.uint8).reshape(px.shape[0], -1)[:, : px.shape[1]]
    return None


def _band_mode(fmt: str, data: bytes):
    """Pillow's mode of an embedded JPEG, PNM or PNG, which Image.merge
    checks; None for another format."""
    from rustic_tpu_torch.utils import pnm

    if fmt == "JPEG":
        return "L" if _grey_jpeg(data) else "RGB"
    if fmt == "PPM":
        return pnm.open_pnm(data).mode
    if fmt == "PNG" and len(data) >= 26:
        depth, colour = data[24], data[25]
        return {0: {1: "1", 16: "I;16"}.get(depth, "L"), 2: "RGB", 3: "P", 4: "LA",
                6: "RGBA"}.get(colour)
    return None
