"""A NumPy TIFF decoder for scene textures and LDR skyboxes.

The JAX package reads TIFFs through Pillow (`Image.open(...).convert("RGBA")`,
libtiff 4.7.1 underneath for compressed files); `decode_tiff` gives the
same uint8 [H, W, 4]. It reads classic TIFF, little-endian (II) and
big-endian (MM), its first IFD (page 0, as Pillow's directory reader
reads it: it stops at an entry or value past the file's end): strips or
tiles; compression none (1), PackBits (32773), LZW (5: most significant
bit first, codes widened one code early), Deflate (8, and the old code
32946), CCITT modified Huffman (2), T.4 (3: one-dimensional, or
two-dimensional where Group3Options' bit 0 is set) and T.6 (4), JPEG (7)
and LZMA (34925: one .xz stream a strip, through csrc/image_entropy.cpp
`xz_strip`, which keeps what liblzma writes before an error, as libtiff's
LZMADecode keeps it; an error once the strip's bytes are all out goes
unseen); predictor 1, and horizontal differencing (predictor 2) at 8
and 16 bits; planar configuration 1 (chunky) and 2 (one plane a sample);
fill order 1, and 2 where Pillow's OPEN_INFO has the layout with it
(grey and palette at 1-8 bits, little-endian grey at 16, RGB at 8): every
byte of the strips bit-reversed, as libtiff reverses them (its fax decoder
reads them least significant bit first) and Pillow's ";R" raw modes read
them, except under JPEG, whose codec does not reverse bits; the raw modes
Pillow lacks (P;1R, P;2R, P;4R, L;IR) refuse an uncompressed file as
Pillow does. The image is then turned by its orientation as
TiffImageFile.load_end turns it (ImageOps.exif_transpose on both of
Pillow's paths): tag 274's first value of a numeric type, else the first
tiff:Orientation digit of the XMP packet (tag 700); 5-8 swap the sides.
Pixels follow Pillow's table of modes (TiffImagePlugin.OPEN_INFO) and its
conversions to RGBA:

- grey, min-is-black or min-is-white, at 1, 2, 4 and 8 bits (scaled to
  0-255; min-is-white inverted), with an unassociated alpha at 8 bits;
- grey at 16 bits, which Pillow reads as "I;16" and clips to 255 — and
  does not invert for min-is-white (its table maps both to "I;16");
  big-endian min-is-white at 16 bits is a mode Pillow does not open;
- RGB at 8 and 16 bits (16-bit samples cut to their high byte), with an
  extra sample that is unassociated alpha (2, or none named: alpha),
  associated alpha (1: divided out as Pillow's "RGBa" does,
  min(255, c * 255 // a), all zero where a is 0) or unspecified (0:
  dropped);
- palette at 1, 2, 4 and 8 bits, each 16-bit colour map entry cut to its
  high byte;
- CMYK at 8 bits (with up to two unspecified extra samples) and 16 (cut
  to the high byte), converted as Pillow's "CMYK" (not inverted);
- CIELab at 8 bits, a and b signed, through LittleCMS's transform as
  Pillow's convert runs it (utils/modes.py `lab_to_rgb`);
- YCbCr at 8 bits, chunky: with JPEG compression libjpeg converts it to
  RGB (Pillow sets JPEGCOLORMODE_RGB); with LZW, Deflate, LZMA or
  PackBits through libtiff's RGBA interface (TIFFRGBAImage: each data
  unit's h x v luma samples with its Cb and Cr, subsamplings 1x1, 1x2,
  2x1, 2x2, 4x1, 4x2 and 4x4, ReferenceBlackWhite and YCbCrCoefficients in
  tif_color.c's float and 16.16 fixed-point tables; the strip read as
  ceil(rows / v) x v rows of TIFFScanlineSize, its last bytes 0 where v
  does not divide a row of units; a tile cut at the image's right edge
  stepped over as the put routine steps, 10 bytes a 4x4 unit; the
  horizontal predictor undone 3 bytes apart over each such row, or the
  tile width x 3, and not at all where they are not whole, as horAcc8
  errs; a strip the codec fails on put from what it wrote into a zeroed
  buffer, as TIFFRGBAImage goes on with stoponerr 0); uncompressed, as
  Pillow reads it without libtiff: rawmode "RGBX", 4 bytes a pixel from
  each strip's offset, nothing converted;
- YCbCr at 8 bits in planar configuration 2: compressed, through
  TIFFRGBAImage's putseparate8bitYCbCr11tile, which only a YCbCrSubsampling
  of 1x1 reaches (others, and the default 2x2, libtiff refuses); under
  JPEG each plane's strip a one-component JPEG whose samples libtiff takes
  as they are (it converts colour only in planar configuration 1);
  uncompressed, Pillow's reader takes the planes as R, G and B.

CCITT data goes through csrc/image_entropy.cpp `ccitt_rows`, libtiff's
decoder (its repairs of a bad row, its reading of T.4 data without EOLs,
run arrays and Pillow's strip buffer kept from strip to strip). JPEG
strips and tiles go through utils/jpeg.py `decode_tiff_jpeg`, libtiff's
use of libjpeg: JPEGTables loaded first, then each abbreviated stream;
YCbCr converted to RGB and upsampled, any other photometric's components
taken as they are; each strip's sampling held to the first's; a JPEG
smaller than its strip or tile fills what it reaches.

An uncompressed strip or tile is read from its offset as far as its
pixels need, whatever its byte count says (as Pillow reads it); a strip
or tile that holds fewer bytes than its pixels raises ValueError, as
Pillow refuses it, and so does one its codec fails on (an LZW strip that
does not start with a clear code among them; Deflate and LZMA inflated
no further than the strip's bytes, so an error after them goes unseen);
tags and data that do not hold together raise ValueError, as does an
image over Pillow's decompression-bomb limit.

These raise NotImplementedError naming the variant: old-JPEG (6),
RLE-word (32771), ThunderScan, SGILog, JPEG 2000, Zstandard and WebP
compression, signed or floating-point samples, the floating-point
predictor, mask, ICCLab, ITULab and LogLuv images, old-style LZW and
BigTIFF. Five layouts
Pillow misreads are refused rather than copied: planar configuration 2
with an extra sample (Pillow reads the alpha as 0), CIELab in planar
configuration 2 (Pillow's band unpackers leave its LAB pixels' fourth
byte 0, which the conversion takes as alpha), uncompressed planar
configuration 2 at 16 bits (Pillow reads 8 of the 16) and the horizontal
predictor without compression or with PackBits (libtiff and Pillow
ignore it there). A fill order Pillow has no mode for raises ValueError,
as Pillow refuses the file.

The LZW and PackBits decoders are Python loops (LZW a code at a time,
PackBits a run at a time); unpacking, the predictor, tile placement and
the colour conversion run over whole strips, tiles or images at once.
"""

from __future__ import annotations

import re
import struct
import zlib
from fractions import Fraction

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO, jpeg
from rustic_tpu_torch.utils import modes
from rustic_tpu_torch.utils.modes import check_pixels, note_core, to_rgba

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
          11: "f", 12: "d", 13: "I"}  # field type -> struct codes of one value
_COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 5: "LZW",
                 7: "JPEG", 8: "Deflate", 32773: "PackBits", 32946: "Deflate", 34925: "LZMA"}
_REFUSED_COMPRESSIONS = {6: "old-JPEG-compressed (6)", 32771: "RLE-word (32771)", 32809: "ThunderScan (32809)",
                         34676: "SGILog (34676)", 34677: "SGILog24 (34677)",
                         34712: "JPEG 2000-compressed (34712)",
                         50000: "Zstandard-compressed (50000)", 50001: "WebP-compressed (50001)"}
_REFUSED_PHOTOMETRIC = {4: "transparency-mask", 9: "ICCLab", 10: "ITULab", 32844: "LogL",
                        32845: "LogLuv"}


def _refuse(variant: str):
    raise NotImplementedError(f"TIFF {variant} is not decoded ({FORMATS_TODO})")


def _ifd(raw: bytes, order: str, pos: int, kinds: dict = None) -> dict:
    """The IFD at `pos` -> {tag: tuple of its values}, as Pillow's
    ImageFileDirectory_v2.load reads it: an entry of an unknown type or of
    no values is skipped, and the reading stops (the tags so far kept)
    where the count, an entry or a value runs past the file's end. Each
    tag's field type goes into `kinds` where given."""
    tags = {}
    kinds = {} if kinds is None else kinds
    if pos + 2 > len(raw):
        return tags
    (n,) = struct.unpack(order + "H", raw[pos : pos + 2])
    for i in range(n):
        entry = raw[pos + 2 + 12 * i : pos + 14 + 12 * i]
        if len(entry) < 12:
            break
        tag, kind, count, inline = struct.unpack(order + "HHI4s", entry)
        if kind not in _TYPES or count == 0:
            continue
        size = struct.calcsize(order + _TYPES[kind]) * count
        if size <= 4:
            data = inline[:size]
        else:
            (off,) = struct.unpack(order + "I", inline)
            data = raw[off : off + size]
            if len(data) < size:
                break
        tags[tag] = struct.unpack(order + _TYPES[kind] * count, data)
        kinds[tag] = kind
    return tags


def _packbits(data: bytes, size: int) -> bytes:
    out = bytearray()
    pos = 0
    while pos < len(data) and len(out) < size:
        n = data[pos]
        pos += 1
        if n < 128:  # n + 1 literal bytes
            out += data[pos : pos + n + 1]
            pos += n + 1
        elif n > 128:  # the next byte 257 - n times
            out += data[pos : pos + 1] * (257 - n)
            pos += 1
    return bytes(out)


class _StripError(ValueError):
    """A strip or tile libtiff's codec fails on, with the bytes it wrote
    before the failure (`partial`): Pillow refuses the image, except where
    libtiff's RGBA interface puts the strip anyway (YCbCr)."""

    def __init__(self, message: str, partial: bytes):
        super().__init__(message)
        self.partial = partial


def _lzw(data: bytes, size: int) -> bytes:
    """TIFF LZW: codes read most significant bit first, 9 bits wide after
    a clear code (256) and one bit wider as soon as the next free code
    reaches 2^width - 1, up to 12; 257 ends the strip. The first code must
    be a clear code (libtiff: corrupted LZW table)."""
    if len(data) >= 2 and data[0] == 0 and data[1] & 1:
        _refuse("old-style LZW")
    base = [bytes([i]) for i in range(256)] + [b"", b""]
    b = np.frombuffer(data + bytes(4), np.uint8).astype(np.uint32)
    words = (b[:-3] << 24 | b[1:-2] << 16 | b[2:-1] << 8 | b[3:]).tolist()  # 32 bits from byte i
    nbits = 8 * len(data)
    out = bytearray()
    table = list(base)
    width = 9
    prev = None
    p = 0
    while p + width <= nbits and len(out) < size:
        code = (words[p >> 3] >> (32 - (p & 7) - width)) & ((1 << width) - 1)
        if p == 0 and code != 256:
            raise _StripError("TIFF LZW strip does not start with a clear code (libtiff: "
                              "corrupted LZW table)", b"")
        p += width
        if code == 256:
            table = list(base)
            width = 9
            prev = None
            continue
        if code == 257:
            break
        if prev is None:
            if code > 257:
                raise _StripError(f"TIFF LZW code {code} after a clear code (libtiff: corrupted "
                                  "LZW table)", bytes(out))
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise _StripError(f"TIFF LZW code {code} is not defined yet", bytes(out))
            if len(table) < 4096:
                table.append(prev + entry[:1])
        out += entry
        prev = entry
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)


def _inflate(raw: bytes, off: int, count: int, compression: int, size: int) -> bytes:
    """One strip or tile's `size` bytes: uncompressed, read from `off` as
    far as the pixels need (as Pillow reads them, whatever the byte count
    says); else its `count` bytes decompressed."""
    if compression == 1:
        return raw[off : off + size]
    data = raw[off : off + count]
    if compression == 32773:
        return _packbits(data, size)
    if compression == 5:
        return _lzw(data, size)
    if compression == 34925:
        return _unxz(data, size)
    try:  # no further than libtiff's ZIPDecode reads
        return zlib.decompressobj().decompress(data, size)
    except zlib.error as e:
        raise _StripError(f"TIFF Deflate data is corrupt: {e}",
                          _until_error(zlib.decompressobj, data, size)) from e


def _unxz(data: bytes, size: int) -> bytes:
    """libtiff's LZMADecode: one .xz stream decoded as far as the strip's
    `size` bytes through csrc/image_entropy.cpp `xz_strip`, which keeps
    every byte liblzma writes before it stops: an error once they are all
    out (a bad check, junk after) goes unseen, one before leaves the strip
    short."""
    from rustic_tpu_torch.utils import _entropy

    src = np.frombuffer(data, np.uint8)
    out = np.zeros(size, np.uint8)
    got = _entropy.library().xz_strip(_entropy.ptr(src), len(src), _entropy.ptr(out), size)
    return out[:got].tobytes()


def _until_error(new, data: bytes, size: int) -> bytes:
    """The bytes (at most `size`) a zlib decompressor made by `new` gives
    from `data` before its first error, as libtiff's codec, handed all of
    it at once, leaves them in its buffer. Python drops a failing call's
    output: so the input is fed a byte a call to find the byte the error
    comes with, then, from a fresh decompressor, the bytes before it at
    once and that byte's output a byte a call."""
    d, out, bad = new(), bytearray(), len(data)
    for i in range(len(data)):
        try:
            out += d.decompress(data[i : i + 1], size - len(out))
        except zlib.error:
            bad = i
            break
        if len(out) >= size:  # only then can zlib hold input back (unconsumed_tail)
            return bytes(out)
    d = new()
    out = bytearray(d.decompress(data[:bad], size))
    pending = d.unconsumed_tail + data[bad : bad + 1]
    while len(out) < size:
        try:
            chunk = d.decompress(pending, 1)
        except zlib.error:
            break
        if not chunk:
            break
        out += chunk
        pending = d.unconsumed_tail
    return bytes(out)


def _samples(block: bytes, rows: int, width: int, n: int, bps: int, order: str,
             predictor: int) -> np.ndarray:
    """One decoded strip or tile -> [rows, width, n] samples (uint8 or
    uint16), the horizontal predictor undone."""
    stride = (width * n * bps + 7) // 8
    if len(block) < rows * stride:  # libtiff and Pillow refuse a short strip or tile
        raise ValueError("TIFF strip or tile holds fewer bytes than its pixels")
    buf = np.frombuffer(block, np.uint8, count=rows * stride).reshape(rows, stride)
    if bps == 16:
        px = buf.view(order + "u2").astype(np.uint16).reshape(rows, width, n)
    elif bps == 8:
        px = buf.reshape(rows, width, n)
    else:  # several samples a byte, most significant first
        shifts = np.arange(8 - bps, -1, -bps, dtype=np.uint8)
        px = ((buf[:, :, None] >> shifts) & ((1 << bps) - 1)).reshape(rows, -1)
        px = px[:, : width * n].reshape(rows, width, n)
    if predictor == 2:
        px = np.cumsum(px, axis=1, dtype=px.dtype)
    return px


def decode_tiff(raw: bytes) -> np.ndarray:
    """TIFF bytes -> uint8 [H, W, 4] of the first page, as Pillow's
    convert("RGBA"). A file whose tags or data do not hold together raises
    ValueError."""
    try:
        return _decode_tiff(bytes(raw))
    except (IndexError, KeyError, TypeError, struct.error, zlib.error) as e:
        raise ValueError(f"TIFF file is corrupt: {type(e).__name__}: {e}") from e


def _decode_tiff(raw: bytes) -> np.ndarray:
    if raw[:4] in (b"II+\x00", b"MM\x00+"):
        _refuse("BigTIFF")
    if raw[:4] not in (b"II*\x00", b"MM\x00*"):
        raise ValueError("not a TIFF file")
    order = "<" if raw[:2] == b"II" else ">"
    (first,) = struct.unpack(order + "I", raw[4:8])
    kinds = {}
    tags = _ifd(raw, order, first, kinds)
    out = _decode_page(raw, order, tags, _first(tags, kinds, 266, 1))
    turn = _TRANSPOSES.get(_orientation(tags, kinds))
    if turn:
        modes.turn_core(turn)
    return np.ascontiguousarray(turn(out)) if turn else out


def _first(tags: dict, kinds: dict, number: int, default=None):
    """A tag of one value as Pillow's ImageFileDirectory_v2 gives it: the
    first of its values (more are dropped with a warning), a rational as a
    Fraction (None where its denominator is 0: Pillow's NaN); a BYTE,
    ASCII or UNDEFINED field is bytes or text there, which equals no
    number: None."""
    if number not in tags:
        return default
    kind, v = kinds[number], tags[number]
    if kind in (1, 2, 7):
        return None
    if kind in (5, 10):
        return Fraction(v[0], v[1]) if v[1] else None
    return v[0]


# ImageOps.exif_transpose's methods (FLIP_LEFT_RIGHT, ROTATE_180, FLIP_TOP_BOTTOM, TRANSPOSE,
# ROTATE_270, TRANSVERSE, ROTATE_90) by orientation
_TRANSPOSES = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
               5: lambda a: a.transpose(1, 0, 2), 6: lambda a: a[::-1].transpose(1, 0, 2),
               7: lambda a: a[::-1, ::-1].transpose(1, 0, 2),
               8: lambda a: a[:, ::-1].transpose(1, 0, 2)}
_XMP_ORIENTATION = re.compile(rb'tiff:Orientation(="|>)([0-9])')


def _orientation(tags: dict, kinds: dict):
    """The orientation TiffImageFile.load_end transposes the image by
    (ImageOps.exif_transpose, the same on Pillow's own and libtiff's
    paths): tag 274, else the first tiff:Orientation digit of the XMP
    packet (tag 700) as Image.getexif reads it, where a packet that is
    text, or numbers other than one 0, makes Pillow's search raise."""
    if 274 in tags:
        return _first(tags, kinds, 274)
    if 700 not in tags:
        return None
    kind, v = kinds[700], tags[700]
    if kind in (1, 7):  # bytes: searched
        match = _XMP_ORIENTATION.search(bytes(v))
        return int(match[2]) if match else None
    one = len(v) == (2 if kind in (5, 10) else 1)
    if kind == 2 and bytes(v) == b"\0" or kind != 2 and one and _first(tags, kinds, 700) == 0:
        return None  # an empty packet (text of one NUL, a single 0): Pillow does not search it
    raise ValueError("TIFF XMP packet that is not bytes (Pillow: TypeError in getexif)")


_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
# (photometric, bits, samples) of Pillow's OPEN_INFO keys with fill order 2 (none with extra
# samples; 16 bits only little-endian), and those its own reader has no raw mode for
_FILL_ORDER_2 = {(p, b, 1) for p in (0, 1, 3) for b in (1, 2, 4, 8)} | {(1, 16, 1), (2, 8, 3)}
_NO_RAW_MODE = {(3, 1, 1), (3, 2, 1), (3, 4, 1), (0, 8, 1)}  # P;1R, P;2R, P;4R, L;IR


def _decode_page(raw: bytes, order: str, tags: dict, fill) -> np.ndarray:
    """The first page's pixels as stored (before the orientation) -> uint8
    [H, W, 4]."""
    def tag(number, default=None):
        return tags.get(number, default)

    width, height = tag(256)[0], tag(257)[0]
    check_pixels(width, height, "TIFF")  # Image.open's decompression-bomb check
    compression = tag(259, (1,))[0]
    photometric = tag(262, (0,))[0]
    n = tag(277, (1,))[0]
    bps = tag(258, (1,))
    bps = bps * n if len(bps) == 1 else bps[:n]
    extra = tag(338, ())
    planar = tag(284, (1,))[0]
    predictor = tag(317, (1,))[0]
    if compression in _REFUSED_COMPRESSIONS:
        _refuse(_REFUSED_COMPRESSIONS[compression])
    if compression not in _COMPRESSIONS:
        _refuse(f"compression {compression}")
    if photometric in _REFUSED_PHOTOMETRIC:
        _refuse(_REFUSED_PHOTOMETRIC[photometric])
    if photometric not in _PHOTOMETRIC:
        _refuse(f"photometric interpretation {photometric}")
    formats = set(tag(339, (1,)))
    if formats != {1}:
        _refuse({2: "signed samples", 3: "floating-point samples"}.get(max(formats),
                                                                      f"sample format {formats}"))
    if fill not in (1, 2):
        raise ValueError(f"TIFF fill order {fill} (Pillow: unknown pixel mode)")
    if len(set(bps)) != 1 or bps[0] not in (1, 2, 4, 8, 16):
        _refuse(f"{'/'.join(map(str, bps))} bits a sample")
    bps = bps[0]
    if fill == 2 and ((photometric, bps, n) not in _FILL_ORDER_2 or extra
                      or bps == 16 and order == ">"):
        raise ValueError(f"TIFF fill order 2 of photometric {photometric} at {bps} bits, {n} "
                         "samples (Pillow: unknown pixel mode)")
    if fill == 2 and compression == 1 and (photometric, bps, n) in _NO_RAW_MODE:
        raise ValueError("uncompressed TIFF fill order 2 of this mode (Pillow: unknown raw mode)")
    data = raw.translate(_REVERSED) if fill == 2 and compression != 7 else raw  # not JPEG's
    if predictor == 3:
        _refuse("floating-point predictor (3)")
    if predictor == 2 and bps not in (8, 16):
        _refuse(f"horizontal predictor at {bps} bits")
    if predictor not in (1, 2):
        _refuse(f"predictor {predictor}")
    if predictor == 2 and compression in (1, 32773):  # libtiff and Pillow ignore it there
        _refuse("horizontal predictor with " + ("no" if compression == 1 else "PackBits")
                + " compression")
    if planar not in (1, 2):
        raise ValueError(f"TIFF planar configuration {planar}")
    colours = _PHOTOMETRIC[photometric]
    if planar == 2 and n > colours:
        _refuse("planar configuration 2 with extra samples")  # Pillow reads the alpha as 0
    if planar == 2 and photometric == 8:  # Pillow unpacks the planes as L, alpha and B
        _refuse("CIELab in planar configuration 2")
    if planar == 2 and compression == 1 and bps == 16:
        _refuse("uncompressed planar configuration 2 at 16 bits")  # Pillow reads it as 8-bit
    if n != colours + len(extra) and not (photometric == 2 and n == 4 and not extra):
        _refuse(f"{n} samples a pixel with extra samples {extra}")
    if photometric in (5, 6, 8):
        _check_layout(photometric, bps, extra, planar, compression, predictor)
    if compression in _FAX and (bps != 1 or n != 1 or photometric not in (0, 1)):
        _refuse(f"{_COMPRESSIONS[compression]} of {n} samples at {bps} bits")
    if compression == 7 and bps != 8:
        _refuse(f"JPEG-compressed samples of {bps} bits")

    tiled = 324 in tags
    if tiled:
        bw, bh = tag(322)[0], tag(323)[0]  # tiles
        offsets, counts = tag(324), tag(325)
        across, down = -(-width // bw), -(-height // bh)
        segments = [(ty * bh, tx * bw, bh) for ty in range(down) for tx in range(across)]
    else:
        rps = min(tag(278, (height,))[0], height)
        bw, bh = width, rps
        offsets, counts = tag(273), tag(279)
        segments = [(y, 0, min(rps, height - y)) for y in range(0, height, rps)]
    if photometric == 6:
        note_core("RGB")  # Pillow's mode of every YCbCr layout it reads
    if photometric == 6 and compression == 1 and planar == 1:  # Pillow's reader: read as RGBX
        return _ycbcr_raw(raw, offsets, tiled, width, height, bw, bh)
    if photometric == 6 and compression != 7 and planar == 1:  # libtiff's TIFFRGBAImage
        return _ycbcr_rgba(raw, tags, offsets, counts, segments, width, height, bw, compression,
                           predictor, tiled)
    if photometric == 6 and planar == 2 and compression != 1 and tag(530, (2, 2))[:2] != (1, 1):
        raise ValueError("TIFF YCbCr in planar configuration 2 subsampled (libtiff's "
                         "TIFFRGBAImage has no routine: can not handle format)")

    per = n if planar == 1 else 1  # samples in each strip or tile
    planes = 1 if planar == 1 else n
    dtype = np.uint16 if bps == 16 else np.uint8
    px = np.zeros((height, width, n), dtype)
    tables = None
    if compression == 7 and 347 in tags:
        tables = jpeg.tiff_jpeg_tables(bytes(tag(347)))
    ycbcr_jpeg = compression == 7 and photometric == 6 and planar == 1
    jpeg_state = _JpegState(bh, bw, per, photometric == 6 and planar == 2) if compression == 7 \
        else None
    fax = _FaxState(bw, bh, compression, tags) if compression in _FAX else None
    ycbcr_planes = photometric == 6 and compression not in (1, 7)  # chunky YCbCr left above
    whole = True
    for i, (off, count) in enumerate(zip(offsets, counts)):
        plane, k = divmod(i, len(segments))
        if plane >= planes:
            break
        y0, x0, rows = segments[k]
        if not tiled and rows <= 0:
            break
        if compression in _FAX:
            block = _fax(data, off, count, bw, bh if tiled else rows, compression, fax)
        elif compression == 7:
            block = _jpeg_block(raw, off, count, tables, ycbcr_jpeg, bh if tiled else rows,
                                height - y0, plane, jpeg_state)
        elif ycbcr_planes:  # through TIFFRGBAImage, which puts a strip its codec fails on
            size = (bh if tiled else rows) * ((bw * per * bps + 7) // 8)
            block, whole = _rgba_strip(data, off, count, compression, size)
        else:
            size = (bh if tiled else rows) * ((bw * per * bps + 7) // 8)
            block = _inflate(data, off, count, compression, size)
        if compression != 7:
            block = _samples(block, bh if tiled else rows, bw, per, bps, order,
                             predictor if whole else 1)
        h, w = min(bh, height - y0), min(bw, width - x0)
        px[y0 : y0 + h, x0 : x0 + w, plane : plane + per] = block[:h, :w]
    if ycbcr_jpeg or photometric == 6 and compression == 1:
        photometric = 2  # libjpeg gave RGB; Pillow's reader takes the planes as R, G and B
    elif photometric == 6:  # one plane each (a JPEG's one component taken as it is, libtiff's
        # JCS_UNKNOWN), through TIFFRGBAImage's putseparate8bitYCbCr11tile
        out = np.full((height, width, 4), 255, np.uint8)
        out[..., :3] = _ycbcr_to_rgb(_ycbcr_conversion(tags), px[..., 0], px[..., 1], px[..., 2])
        return out
    return _to_rgba(px, photometric, bps, extra, order, tag(320))


_PHOTOMETRIC = {0: 1, 1: 1, 2: 3, 3: 1, 5: 4, 6: 3, 8: 3}  # photometric -> its colour samples
_FAX = (2, 3, 4)


def _check_layout(photometric, bps, extra, planar, compression, predictor):
    """The CMYK, YCbCr and CIELab layouts of Pillow's OPEN_INFO that the
    port reads; the rest raise NotImplementedError naming them."""
    name = {5: "CMYK", 6: "YCbCr", 8: "CIELab"}[photometric]
    ok = {5: bps == 8 and extra in ((), (0,), (0, 0)) or bps == 16 and not extra,
          6: bps == 8 and not extra, 8: bps == 8 and not extra}[photometric]
    if not ok:
        _refuse(f"{name} at {bps} bits with extra samples {extra}")


class _FaxState:
    """What libtiff's fax decoder keeps from one strip or tile to the next
    of an image: Pillow's strip buffer (a row libtiff stops before keeps
    the strip before's, zero in the first: Pillow's own buffer holds
    whatever its memory held, which no decoder can reproduce), the flag
    for T.4 data without EOLs and the run arrays (a pass code past the
    reference row's end reads what an earlier row left there)."""

    def __init__(self, width, rows, compression, tags):
        from rustic_tpu_torch.utils import _entropy

        self.two_d = int(compression == 4 or compression == 3 and tags.get(292, (0,))[0] & 1)
        self.rows = np.zeros(rows * ((width + 7) // 8), np.uint8)
        self.no_eol = np.zeros(1, np.int32)
        self.runs = np.zeros(2 * _entropy.library().ccitt_nruns(width, self.two_d) + 2, np.uint32)
        self.short = False  # a T.6 strip ended early: Pillow's rows below it are its memory's


def _fax(raw, off, count, width, rows, compression, state) -> bytes:
    """One strip or tile of CCITT data -> its packed rows (black 1), through
    csrc/image_entropy.cpp `ccitt_rows`, with the image's `_FaxState`."""
    from rustic_tpu_torch.utils import _entropy

    data = np.frombuffer(raw, np.uint8, count=max(0, min(count, len(raw) - off)), offset=off)
    if count <= 0 or len(data) < count:
        raise ValueError("TIFF fax strip or tile is empty or cut short (libtiff: read error)")
    buf = state.rows
    rowbytes = (width + 7) // 8
    got = _entropy.library().ccitt_rows(_entropy.ptr(data), len(data), width, rows, compression,
                                        state.two_d & (compression == 3), _entropy.ptr(buf),
                                        _entropy.ptr(state.no_eol), _entropy.ptr(state.runs))
    if got < 0:
        raise ValueError(f"TIFF {_COMPRESSIONS[compression]} data is corrupt (libtiff: the "
                         "strip or tile does not decode)")
    state.short |= got < rows
    return buf[: rows * rowbytes].tobytes()


class _JpegState:
    """What libtiff's JPEG codec and Pillow keep from one strip or tile to
    the next: the sampling every strip is held to (the first strip's, as
    JPEGFixupTags reads YCbCrSubsampling from it) and Pillow's buffer,
    whose rows and columns a smaller JPEG does not reach keep what they
    held (zero before the first strip: Pillow's own buffer holds whatever
    its memory held, which no decoder reproduces). Through TIFFRGBAImage
    (YCbCr in planar configuration 2) each plane has a buffer of its own,
    and a strip the codec fails on leaves it as it was (stoponerr 0),
    except the first read: its buffer is allocated only once the strip's
    JPEG header has been read (JPEGPreDecode), so a failure there ends
    TIFFRGBAImageGet."""

    def __init__(self, rows, width, per, rgba=False):
        self.sampling = None
        self.shape = (rows, width, per)
        self.bufs = {}
        self.rgba = rgba
        self.first = True
        self.short = False

    def buf(self, plane):
        return self.bufs.setdefault(plane if self.rgba else 0, np.zeros(self.shape, np.uint8))


def _jpeg_block(raw, off, count, tables, ycbcr, rows, left, plane, state) -> np.ndarray:
    """One JPEG-compressed strip or tile -> uint8 [rows, width, per]."""
    buf = state.buf(plane)
    width, per = buf.shape[1:]
    first, state.first = state.first, False
    try:
        block, got = jpeg.decode_tiff_jpeg(raw[off : off + count], tables, ycbcr)
        if block.shape[2] != per:
            raise ValueError(f"TIFF JPEG strip of {block.shape[2]} components where the image "
                             f"has {per} (libtiff: improper JPEG component count)")
        state.sampling = state.sampling or got
        want = [state.sampling[0]] + [(1, 1)] * (len(got) - 1) if ycbcr else [(1, 1)] * len(got)
        if got != want:
            raise ValueError(f"TIFF JPEG strip sampled {got} (libtiff: improper JPEG sampling "
                             "factors)")
        h, w = block.shape[:2]
        if w > width or h > rows and not (w == width and rows == left):
            raise ValueError(f"TIFF JPEG strip of {w}x{h} exceeds its {width}x{rows} (libtiff)")
    except ValueError:
        if not state.rgba or first:
            raise
        return buf[:rows].copy()
    n = min(h, rows)  # JPEGDecode reads no more rows than the JPEG has
    buf[:n, :w] = block[:n]
    state.short |= n < rows or w < width
    return buf[:rows].copy()


def _ycbcr_raw(raw, offsets, tiled, width, height, bw, bh) -> np.ndarray:
    """Uncompressed YCbCr as Pillow 12.1.0 reads it without libtiff:
    OPEN_INFO maps it to rawmode "RGBX", so each strip or tile's bytes
    from its offset are read 4 a pixel as R, G, B and a padding byte,
    whatever the subsampling, and nothing is converted."""
    out = np.full((height, width, 4), 255, np.uint8)
    if not tiled and bw == width and bh >= height:
        offsets = offsets[-1:]  # Pillow: a strip that covers the image takes the last offset
    x = y = 0
    for off in offsets:
        h, w = min(bh, height - y), min(bw, width - x)
        stride = 4 * bw if x + bw > width else 4 * w
        need = stride * (h - 1) + 4 * w
        if off + need > len(raw):
            raise ValueError("TIFF strip or tile runs past the end of the file (Pillow: image "
                             "file is truncated)")
        rows = np.frombuffer(raw, np.uint8, count=need, offset=off)
        rows = np.concatenate([rows, np.zeros(stride * h - need, np.uint8)]).reshape(h, stride)
        out[y : y + h, x : x + w, :3] = rows[:, : 4 * w].reshape(h, w, 4)[..., :3]
        x += bw
        if x >= width:
            x, y = 0, y + bh
            if y >= height:
                break
    return out


def _ycbcr_tables(luma, refbw):
    """libtiff 4.7.1 tif_color.c TIFFYCbCrToRGBInit in its float and
    16.16 fixed-point arithmetic -> (Y, Cr->R, Cb->B, Cr->G, Cb->G) tables
    of 256 int64 each."""
    f32 = np.float32
    red, green, blue = (f32(v) for v in luma)
    one_half = 1 << 15

    def fix(v):
        return int(np.float64(v) * 65536.0 + 0.5)

    def clamp(v, lo, hi):
        return lo if v < lo else hi if v > hi else v

    f1 = f32(2) - f32(2) * red
    d1 = fix(clamp(f1, f32(0), f32(2)))
    f2 = f32(red * f1 / green)
    d2 = -fix(clamp(f2, f32(0), f32(2)))
    f3 = f32(2) - f32(2) * blue
    d3 = fix(clamp(f3, f32(0), f32(2)))
    f4 = f32(blue * f3 / green)
    d4 = -fix(clamp(f4, f32(0), f32(2)))
    x = np.arange(-128, 128).astype(f32)
    rbw = [f32(v) for v in refbw]

    def code2v(c, rb, rw, cr):
        span = rw - rb if rw - rb != 0 else f32(1)
        return ((c - rb) * f32(cr)) / span

    def clampw(v):  # CLAMPw to +-4096, then (int32_t): toward zero
        v = np.where(v < f32(-4096), f32(-4096), np.where(v > f32(4096), f32(4096), v))
        return np.trunc(v).astype(np.int64)

    with np.errstate(all="ignore"):
        cr = clampw(code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127))
        cb = clampw(code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127))
        y = clampw(code2v(x + f32(128), rbw[0], rbw[1], 255))
    return (y, (d1 * cr + one_half) >> 16, (d3 * cb + one_half) >> 16, d2 * cr,
            d4 * cb + one_half)


# the subsamplings libtiff's TIFFRGBAImage has a put routine for (PickContigCase)
_YCBCR_SUBSAMPLINGS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))


def _rgba_strip(raw, off, count, compression, size):
    """A strip or tile as libtiff's TIFFRGBAImage reads it for Pillow
    (stoponerr 0) -> (its `size` bytes, whether the codec wrote them all):
    where the codec fails or comes up short, what it wrote into a zeroed
    buffer, the predictor not undone (it runs only after a whole decode);
    a strip past the file's end is not read at all."""
    try:
        data = _inflate(raw, off, count, compression, size) if off + count <= len(raw) else b""
        whole = len(data) >= size
    except _StripError as e:
        data, whole = e.partial, False
    return data[:size] + bytes(max(0, size - len(data))), whole


def _ycbcr_conversion(tags):
    """TIFFYCbCrToRGBInit's tables for the image's YCbCrCoefficients and
    ReferenceBlackWhite."""
    luma = tags.get(529, (299, 1000, 587, 1000, 114, 1000))
    luma = [np.float32(np.float32(luma[2 * i]) / np.float32(luma[2 * i + 1])) if luma[2 * i + 1]
            else np.float32(0) for i in range(3)]
    refbw = tags.get(532)
    refbw = ([np.float32(np.float32(refbw[2 * i]) / np.float32(refbw[2 * i + 1]))
              if refbw[2 * i + 1] else np.float32(0) for i in range(6)] if refbw
             else [0, 255, 128, 255, 128, 255])
    if luma[1] == 0:
        raise ValueError("TIFF YCbCrCoefficients with a green of 0 (libtiff refuses them)")
    return _ycbcr_tables(luma, refbw)


def _ycbcr_to_rgb(tables, lum, cb, cr) -> np.ndarray:
    """TIFFYCbCrtoRGB of each pixel's Y, Cb and Cr (uint8 arrays of one
    shape) -> uint8 [..., 3]."""
    y_tab, cr_r, cb_b, cr_g, cb_g = tables
    yv = y_tab[lum.astype(np.int64)]
    cb, cr = cb.astype(np.int64), cr.astype(np.int64)
    rgb = np.stack([yv + cr_r[cr], yv + ((cb_g[cb] + cr_g[cr]) >> 16), yv + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _ycbcr_rgba(raw, tags, offsets, counts, segments, width, height, bw, compression,
                predictor, tiled):
    """Compressed YCbCr through libtiff's RGBA interface (Pillow's
    _decodeAsRGBA): the data units of each strip or tile (h x v luma
    samples, then Cb and Cr), each pixel converted by TIFFYCbCrtoRGB with
    its unit's chroma (tif_getimage.c putcontig8bitYCbCr*tile). The
    horizontal predictor is undone as libtiff's horAcc8 runs, 3 bytes
    apart over rows of TIFFScanlineSize (a row of data units over v; the
    tile width x 3 in a tile), and not at all where that row is not a
    whole number of 3 bytes or the strip or tile of its rows (libtiff's
    error there leaves the bytes as they came)."""
    hs, vs = tags.get(530, (2, 2))[:2]  # libtiff's default subsampling is 2x2
    if (hs, vs) not in _YCBCR_SUBSAMPLINGS:
        raise ValueError(f"TIFF YCbCr subsampling {hs}x{vs} (libtiff: can not handle format)")
    tables = _ycbcr_conversion(tags)
    units_x = -(-bw // hs)
    unit = hs * vs + 2
    out = np.full((height, width, 4), 255, np.uint8)
    for i, (off, count) in enumerate(zip(offsets, counts)):
        if i >= len(segments):
            break
        y0, x0, rows = segments[i]
        units_y = -(-rows // vs)
        size = units_y * units_x * unit
        data, whole = _rgba_strip(raw, off, count, compression, size)
        u = np.frombuffer(data, np.uint8)
        # TIFFReadEncodedStrip decodes ceil(rows / v) x v rows of TIFFScanlineSize (a row of
        # data units over v): where v does not divide that row, a strip's last bytes stay 0
        occ = size if tiled else units_y * vs * (units_x * unit // vs)
        u = np.concatenate([u[:occ], np.zeros(size - occ, np.uint8)])
        if predictor == 2 and whole:
            rowsize = bw * 3 if tiled else units_x * unit // vs
            if rowsize and rowsize % 3 == 0 and occ % rowsize == 0:
                u[:occ] = np.cumsum(u[:occ].reshape(-1, rowsize // 3, 3), axis=1,
                                    dtype=np.uint8).reshape(-1)
        h, w = min(rows, height - y0), min(bw, width - x0)
        # the put routine reads the units that cover the w columns of each row of units, then
        # steps over the rest of the tile's row: (bw - w) // h units, of 10 bytes each in
        # putcontig8bitYCbCr44tile (its skip is the 4x2 routine's)
        used, uy = -(-w // hs), -(-h // vs)
        rowbytes = used * unit + (bw - w) // hs * (10 if (hs, vs) == (4, 4) else unit)
        u = np.concatenate([u, np.zeros(max(0, uy * rowbytes - size), np.uint8)])
        u = u[: uy * rowbytes].reshape(uy, rowbytes)[:, : used * unit].reshape(uy, used, unit)
        lum = u[..., : hs * vs].reshape(uy, used, vs, hs).transpose(0, 2, 1, 3)
        lum = lum.reshape(uy * vs, used * hs)
        cb = np.repeat(np.repeat(u[..., -2], vs, 0), hs, 1)
        cr = np.repeat(np.repeat(u[..., -1], vs, 0), hs, 1)
        out[y0 : y0 + h, x0 : x0 + w, :3] = _ycbcr_to_rgb(tables, lum, cb, cr)[:h, :w]
    return out


def _to_rgba(px, photometric, bps, extra, order, colour_map) -> np.ndarray:
    """Samples [H, W, n] -> uint8 [H, W, 4] as Pillow's mode and its
    convert("RGBA")."""
    height, width, n = px.shape
    out = np.full((height, width, 4), 255, np.uint8)
    if photometric in (5, 8):  # CMYK (16-bit samples cut to their high byte), CIELab
        eight = (px >> 8).astype(np.uint8) if bps == 16 else px
        return to_rgba("CMYK" if photometric == 5 else "LAB",
                       eight[..., : 4 if photometric == 5 else 3])
    if photometric == 3:
        if extra:
            _refuse(f"palette image with extra samples {extra}")
        if colour_map is None:
            raise ValueError("TIFF palette image has no colour map")
        palette = (np.asarray(colour_map, np.int64).reshape(3, -1).T // 256).astype(np.uint8)
        idx = px[..., 0].astype(np.int64)
        if idx.max(initial=0) >= len(palette):
            raise ValueError("TIFF palette index beyond the colour map")
        note_core("P", px[..., 0].astype(np.uint8), palette)
        out[..., :3] = palette[idx]
        return out
    if photometric in (0, 1):
        if extra not in ((), (2,)) or (extra and (bps != 8 or photometric == 0)):
            _refuse(f"grey image at {bps} bits with extra samples {extra}")
        grey = px[..., 0]
        note_core("LA" if extra else "I;16B" if bps == 16 and order == ">" else "I;16"
                  if bps == 16 else "1" if bps == 1 else "L", grey if bps == 16 else None)
        if bps == 16:
            if order == ">" and photometric == 0:
                _refuse("big-endian min-is-white grey at 16 bits")
            grey = np.minimum(grey, 255).astype(np.uint8)  # "I;16", uninverted
        else:
            grey = (grey * (255 // ((1 << bps) - 1))).astype(np.uint8)
            if photometric == 0:
                grey = 255 - grey
        out[..., :3] = grey[..., None]
        if extra:
            out[..., 3] = px[..., 1]
        return out
    eight = (px >> 8).astype(np.uint8) if bps == 16 else px
    if bps not in (8, 16):
        _refuse(f"RGB at {bps} bits")
    out[..., :3] = eight[..., :3]
    kind = extra[0] if extra else 2  # no ExtraSamples tag: the fourth sample is alpha
    note_core("RGB" if n == 3 or kind == 0 else "RGBA")
    if n == 3:
        return out
    if any(extra[1:]):
        _refuse(f"RGB with extra samples {extra}")
    if kind == 0:
        return out
    if kind not in (1, 2, 999):
        _refuse(f"RGB with extra samples {extra}")
    alpha = eight[..., 3]
    out[..., 3] = alpha
    if kind == 1:  # associated: Pillow's "RGBa" divides it out
        a = alpha.astype(np.int64)[..., None]
        rgb = np.minimum(eight[..., :3].astype(np.int64) * 255 // np.maximum(a, 1), 255)
        rgb = np.where(a == 255, eight[..., :3], rgb)
        out[..., :3] = np.where(a == 0, 0, rgb)
        out[..., 3] = alpha
    return out
