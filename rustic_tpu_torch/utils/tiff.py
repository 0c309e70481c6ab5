"""A NumPy TIFF decoder for scene textures and LDR skyboxes.

The JAX package reads TIFFs through Pillow (`Image.open(...).convert("RGBA")`,
libtiff underneath for compressed files); `decode_tiff` gives the same
uint8 [H, W, 4]. It reads classic TIFF, little-endian (II) and big-endian
(MM), its first IFD (page 0): strips or tiles; compression none (1),
PackBits (32773), LZW (5: most significant bit first, codes widened one
code early) and Deflate (8, and the old code 32946); predictor 1, and
horizontal differencing (predictor 2) at 8 and 16 bits; planar
configuration 1 (chunky) and 2 (one plane a sample). Pixels follow
Pillow's table of modes (TiffImagePlugin.OPEN_INFO) and its conversions
to RGBA:

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
  high byte.

An uncompressed strip or tile is read from its offset as far as its
pixels need, whatever its byte count says (as Pillow reads it); a strip
or tile that holds fewer bytes than its pixels raises ValueError, as
Pillow refuses it.

JPEG-compressed (7) and old-JPEG (6) files, other compressions, YCbCr,
CMYK, CIELab and mask images, signed or floating-point samples, the
floating-point predictor, bit-reversed fill order, an orientation other
than 1, old-style LZW and BigTIFF raise NotImplementedError naming the
variant; so do three layouts Pillow misreads, which the port refuses
rather than copy: planar configuration 2 with an extra sample (Pillow
reads the alpha as 0), uncompressed planar configuration 2 at 16 bits
(Pillow reads 8 of the 16) and the horizontal predictor without
compression or with PackBits (libtiff and Pillow ignore it there).

The LZW and PackBits decoders are Python loops (LZW a code at a time,
PackBits a run at a time); unpacking, the predictor, tile placement and
the colour conversion run over whole strips, tiles or images at once.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
          11: "f", 12: "d", 13: "I"}  # field type -> struct codes of one value
_COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32773: "PackBits", 32946: "Deflate"}
_REFUSED_COMPRESSIONS = {2: "CCITT RLE (2)", 3: "CCITT Group 3 (3)", 4: "CCITT Group 4 (4)",
                         6: "old-JPEG-compressed (6)", 7: "JPEG-compressed (7)",
                         32771: "RLE-word (32771)", 32809: "ThunderScan (32809)",
                         34676: "SGILog (34676)", 34677: "SGILog24 (34677)",
                         34712: "JPEG 2000-compressed (34712)", 34925: "LZMA-compressed (34925)",
                         50000: "Zstandard-compressed (50000)", 50001: "WebP-compressed (50001)"}
_REFUSED_PHOTOMETRIC = {4: "transparency-mask", 5: "CMYK", 6: "YCbCr", 8: "CIELab", 9: "ICCLab",
                        10: "ITULab", 32844: "LogL", 32845: "LogLuv"}


def _refuse(variant: str):
    raise NotImplementedError(f"TIFF {variant} is not decoded ({FORMATS_TODO})")


def _ifd(raw: bytes, order: str, pos: int) -> dict:
    """The IFD at `pos` -> {tag: tuple of its values}."""
    (n,) = struct.unpack(order + "H", raw[pos : pos + 2])
    tags = {}
    for i in range(n):
        tag, kind, count, inline = struct.unpack(order + "HHI4s", raw[pos + 2 + 12 * i :
                                                                     pos + 14 + 12 * i])
        if kind not in _TYPES:
            continue
        fmt = _TYPES[kind] * count
        size = struct.calcsize(order + fmt)
        if size <= 4:
            data = inline[:size]
        else:
            (off,) = struct.unpack(order + "I", inline)
            data = raw[off : off + size]
        if len(data) == size:
            tags[tag] = struct.unpack(order + fmt, data)
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


def _lzw(data: bytes, size: int) -> bytes:
    """TIFF LZW: codes read most significant bit first, 9 bits wide after
    a clear code (256) and one bit wider as soon as the next free code
    reaches 2^width - 1, up to 12; 257 ends the strip."""
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
        p += width
        if code == 256:
            table = list(base)
            width = 9
            prev = None
            continue
        if code == 257:
            break
        if prev is None:
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError(f"TIFF LZW code {code} is not defined yet")
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
    return zlib.decompressobj().decompress(data)


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
    convert("RGBA")."""
    raw = bytes(raw)
    if raw[:4] in (b"II+\x00", b"MM\x00+"):
        _refuse("BigTIFF")
    if raw[:4] not in (b"II*\x00", b"MM\x00*"):
        raise ValueError("not a TIFF file")
    order = "<" if raw[:2] == b"II" else ">"
    (first,) = struct.unpack(order + "I", raw[4:8])
    tags = _ifd(raw, order, first)

    def tag(number, default=None):
        return tags.get(number, default)

    width, height = tag(256)[0], tag(257)[0]
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
    if photometric not in (0, 1, 2, 3):
        _refuse(f"photometric interpretation {photometric}")
    formats = set(tag(339, (1,)))
    if formats != {1}:
        _refuse({2: "signed samples", 3: "floating-point samples"}.get(max(formats),
                                                                      f"sample format {formats}"))
    if tag(266, (1,))[0] != 1:
        _refuse("bit-reversed fill order (2)")
    if tag(274, (1,))[0] != 1:
        _refuse(f"orientation {tag(274)[0]}")
    if len(set(bps)) != 1 or bps[0] not in (1, 2, 4, 8, 16):
        _refuse(f"{'/'.join(map(str, bps))} bits a sample")
    bps = bps[0]
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
    colours = 3 if photometric == 2 else 1
    if planar == 2 and n > colours:
        _refuse("planar configuration 2 with extra samples")  # Pillow reads the alpha as 0
    if planar == 2 and compression == 1 and bps == 16:
        _refuse("uncompressed planar configuration 2 at 16 bits")  # Pillow reads it as 8-bit
    if n != colours + len(extra) and not (photometric == 2 and n == 4 and not extra):
        _refuse(f"{n} samples a pixel with extra samples {extra}")

    per = n if planar == 1 else 1  # samples in each strip or tile
    planes = 1 if planar == 1 else n
    dtype = np.uint16 if bps == 16 else np.uint8
    px = np.zeros((height, width, n), dtype)
    if 324 in tags:  # tiles
        tw, tl = tag(322)[0], tag(323)[0]
        offsets, counts = tag(324), tag(325)
        across, down = -(-width // tw), -(-height // tl)
        for i, (off, count) in enumerate(zip(offsets, counts)):
            plane, k = divmod(i, across * down)
            if plane >= planes:
                break
            ty, tx = divmod(k, across)
            size = tl * ((tw * per * bps + 7) // 8)
            block = _samples(_inflate(raw, off, count, compression, size), tl, tw, per, bps,
                             order, predictor)
            y0, x0 = ty * tl, tx * tw
            h, w = min(tl, height - y0), min(tw, width - x0)
            px[y0 : y0 + h, x0 : x0 + w, plane : plane + per] = block[:h, :w]
    else:
        rps = min(tag(278, (height,))[0], height)
        offsets, counts = tag(273), tag(279)
        strips = -(-height // rps)
        for i, (off, count) in enumerate(zip(offsets, counts)):
            plane, k = divmod(i, strips)
            if plane >= planes:
                break
            y0 = k * rps
            rows = min(rps, height - y0)
            size = rows * ((width * per * bps + 7) // 8)
            block = _samples(_inflate(raw, off, count, compression, size), rows, width, per,
                             bps, order, predictor)
            px[y0 : y0 + rows, :, plane : plane + per] = block
    return _to_rgba(px, photometric, bps, extra, order, tag(320))


def _to_rgba(px, photometric, bps, extra, order, colour_map) -> np.ndarray:
    """Samples [H, W, n] -> uint8 [H, W, 4] as Pillow's mode and its
    convert("RGBA")."""
    height, width, n = px.shape
    out = np.full((height, width, 4), 255, np.uint8)
    if photometric == 3:
        if extra:
            _refuse(f"palette image with extra samples {extra}")
        if colour_map is None:
            raise ValueError("TIFF palette image has no colour map")
        palette = (np.asarray(colour_map, np.int64).reshape(3, -1).T // 256).astype(np.uint8)
        idx = px[..., 0].astype(np.int64)
        if idx.max(initial=0) >= len(palette):
            raise ValueError("TIFF palette index beyond the colour map")
        out[..., :3] = palette[idx]
        return out
    if photometric in (0, 1):
        if extra not in ((), (2,)) or (extra and (bps != 8 or photometric == 0)):
            _refuse(f"grey image at {bps} bits with extra samples {extra}")
        grey = px[..., 0]
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
    if n == 3:
        return out
    kind = extra[0] if extra else 2  # no ExtraSamples tag: the fourth sample is alpha
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
