"""A NumPy PNG decoder for scene textures and LDR skyboxes, and the
encoder of image output.

The JAX package decodes images with Pillow (`Image.open(...).convert("RGBA")`,
rustic_tpu/scene/gltf.py `_decode_image`); the port runs where Pillow may
be absent, so it carries this decoder, which reads every PNG the
specification defines: grey (colour type 0) at 1, 2, 4, 8 or 16 bits,
RGB (2), palette (3) at 1-8 bits with its PLTE and tRNS alphas, grey +
alpha (4) and RGBA (6) at 8 or 16 bits, a tRNS key colour, Adam7
interlacing, and the five scanline filters (None, Sub, Up, Average,
Paeth). The result is what Pillow 12's `convert("RGBA")` gives: uint8
[H, W, 4], alpha 255 where the image has none; grey below 8 bits scaled
to 0-255; 16-bit samples cut to their high byte, except 16-bit grey
without alpha, which Pillow reads as a 32-bit integer image and clips to
255; a key colour compared, by its low byte, with the converted 8-bit
pixel (a 1-bit grey key of 1 is white). `decode_image_u8` (and its float
form `decode_image_rgba`) reads a texture or sky of any format the port
decodes: PNG, JPEG and MPO's first frame (utils/jpeg.py), BMP and the
bare DIB (utils/bmp_tga.py), GIF (utils/gif.py), PNM and PFM (utils/pnm.py), ICO
and CUR (utils/ico.py), PCX and DCX (utils/pcx.py), DDS (utils/dds.py),
JPEG 2000, JP2 or a raw codestream (utils/jpeg2000.py), TIFF
(utils/tiff.py), PSD (utils/psd.py), QOI (utils/qoi.py), SGI
(utils/sgi.py), TGA, WebP (utils/webp.py, utils/vp8.py), and IM and IMT
(utils/im.py), IPTC, MCIDAS, PCD, SPIDER, BLP, FITS, FLI/FLC, FTEX, GBR,
ICNS, MSP, PIXAR, SUN, XBM, XPM and XVThumb (a module each, named after
the format).
`image_format` finds the format as Pillow's `Image.open` does: it tries
the plugins in Pillow's order (PILLOW_ORDER), each one whose test of the
first 16 bytes takes the file (IM, IMT, IPTC, PCD and SPIDER have none:
they are tried on every file that reaches them, as in Pillow), and goes
on to the next where the plugin's header reader turns the file away
(NotThisFormat: what Pillow refuses with SyntaxError, IndexError,
TypeError, KeyError, EOFError or struct.error); any other refusal ends
the decode. The plugins the port does not carry are not tried. TGA,
which has no signature, is tried at its place in the order only where
the name given is a TGA's; unknown formats raise NotImplementedError. `encode_png` writes 8-bit RGB or RGBA
with filter 0 (None) on every scanline, which any decoder reads.
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

from rustic_tpu_torch.utils import (FORMATS_TODO, NotThisFormat, avif, blp, fits, fli, ftex, gbr,
                                    icns, ico, im, iptc, mcidas, msp, pcd, pcx, pixar, pnm, qoi,
                                    read_header, sgi, spider, sun, xbm, xpm, xvthumb)
from rustic_tpu_torch.utils.bmp_tga import (DIB_HEADERS, dib_rgba, open_bmp, open_dib,
                                            decode_tga, tga_refusal)
from rustic_tpu_torch.utils.dds import DDS_SIGNATURE, decode_dds, open_dds
from rustic_tpu_torch.utils.gif import decode_gif
from rustic_tpu_torch.utils.jpeg import decode_jpeg, open_jpeg
from rustic_tpu_torch.utils.jpeg2000 import J2K_SIGNATURE, JP2_SIGNATURE, decode_jpeg2000
from rustic_tpu_torch.utils.modes import note_core
from rustic_tpu_torch.utils.psd import PSD_SIGNATURE, decode_psd, open_psd
from rustic_tpu_torch.utils.tiff import decode_tiff
from rustic_tpu_torch.utils.webp import decode_webp

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")  # classic, then BigTIFF
_TGA_NAMES = (".tga", "image/x-tga", "image/x-targa", "image/tga")  # file names, MIME types
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _unfilter_sequential(kind: int, filt: bytes, prev: bytes, bpp: int) -> bytearray:
    """Average (3) or Paeth (4): each byte depends on the one bpp left."""
    out = bytearray(len(filt))
    for i, f in enumerate(filt):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            out[i] = (f + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        out[i] = (f + pred) & 0xFF
    return out


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters of `height` rows of `stride` bytes
    (`bpp`: bytes a pixel, at least 1) -> uint8 [height, stride]."""
    if len(data) < height * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(data, np.uint8, count=height * (stride + 1)).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, filt = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = filt.copy()
        elif kind == 1:  # Sub: a running sum per byte of the pixel, mod 256
            cur = np.cumsum(filt.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = filt + prev
        elif kind in (3, 4):
            cur = np.frombuffer(
                _unfilter_sequential(kind, filt.tobytes(), prev.tobytes(), bpp), np.uint8
            )
        else:
            raise ValueError(f"PNG filter type {kind} is not defined")
        out[y] = cur
        prev = out[y]
    return out


def _samples(data: bytes, height: int, width: int, n: int, depth: int):
    """One image (or one Adam7 pass) -> (samples [height, width, n] as
    uint16 or uint8, the bytes it took)."""
    stride = (width * n * depth + 7) // 8
    raw = _unfilter(data, height, stride, max(1, n * depth // 8))
    if depth == 16:
        px = raw.view(">u2").astype(np.uint16)
    elif depth == 8:
        px = raw
    else:  # several samples a byte, most significant first
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        px = ((raw[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(height, -1)
    return px[:, : width * n].reshape(height, width, n), height * (stride + 1)


def _interlaced(data: bytes, height: int, width: int, n: int, depth: int) -> np.ndarray:
    """The seven Adam7 passes, scattered into the full image."""
    out = np.zeros((height, width, n), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        px, used = _samples(data[pos:], ph, pw, n, depth)
        out[y0::dy, x0::dx] = px
        pos += used
    return out


_CID = re.compile(rb"\w\w\w\w")  # PngImagePlugin.is_cid
_SAFEBLOCK = 1024 * 1024  # ImageFile.SAFEBLOCK: PngImagePlugin.MAX_TEXT_CHUNK
_PIECE = 65536  # ImageFile.load's decodermaxblock: the IDAT data is read this much at a time


class _PngStream:
    """Pillow 12.1.0's PngStream over bytes: each chunk's handler as
    PngImagePlugin runs it, raising where it raises (a chunk's data cut
    short: Truncated File Read; a field too short for its value; the
    checks of IHDR, sRGB, pHYs, acTL, fcTL, iCCP and zTXt), each as
    ValueError naming Pillow's error."""

    def __init__(self, raw: bytes, pos: int):
        self.raw, self.pos = raw, pos
        self.size = self.mode = None
        self.interlace = 0
        self.palette = self.trns = None
        self.seq = None
        self.n_frames = None  # acTL's frame count, None where there is none or it is invalid
        self.bbox = None  # the last fcTL's region (x0, y0, x1, y1)

    def header(self):
        """ChunkStream.read -> (type, length) or None where Pillow's read
        raises struct.error (fewer than 4 bytes left); a type that is not 4
        word characters raises."""
        s = self.raw[self.pos : self.pos + 8]
        self.pos += len(s)
        if len(s) < 4:
            return None
        cid = s[4:]
        if not _CID.match(cid):
            raise ValueError(f"broken PNG file (chunk {cid!r})")
        return cid, struct.unpack(">I", s[:4])[0]

    def read(self, length: int) -> bytes:  # ImageFile._safe_read
        s = self.raw[self.pos : self.pos + length] if length > 0 else b""
        self.pos += len(s)
        if len(s) < length:
            raise ValueError("PNG: Truncated File Read")
        return s

    def call(self, cid: bytes, length: int):
        """The chunk's handler -> its data; None where Pillow's handler raises
        EOFError (IDAT, IEND, and fdAT after its sequence number)."""
        if cid in (b"IDAT", b"IEND"):
            return None
        if cid == b"fdAT":
            if length < 4:
                raise ValueError("APNG contains truncated fDAT chunk")
            self._sequence(self.read(4), True)
            return None
        s = self.read(length)
        try:
            self._handle(cid, s, length)
        except (struct.error, IndexError) as e:
            raise ValueError(f"PNG {cid!r} chunk: {type(e).__name__}: {e}") from e
        return s

    def _sequence(self, s: bytes, data: bool):
        seq = struct.unpack(">I", s[:4])[0]
        if (self.seq != seq - 1) if data else (self.seq is None and seq != 0 or self.seq is not
                                                None and self.seq != seq - 1):
            raise ValueError("APNG contains frame sequence errors")
        self.seq = seq

    def _handle(self, cid: bytes, s: bytes, length: int):
        u32 = lambda at: struct.unpack_from(">I", s, at)[0]  # noqa: E731
        if cid == b"IHDR":
            if length < 13:
                raise ValueError("Truncated IHDR chunk")
            self.size = u32(0), u32(4)
            self.mode = (s[8], s[9]) if (s[8], s[9]) in _PILLOW_MODES else self.mode
            self.interlace |= bool(s[12])
            if s[11]:
                raise ValueError("PNG: unknown filter category")
        elif cid == b"PLTE":
            if self.mode and self.mode[1] == 3:
                self.palette = s
        elif cid == b"tRNS":
            if self.mode and self.mode[1] in (0, 2):  # a key: struct.error where it is cut short
                struct.unpack_from(">" + "H" * (3 if self.mode[1] == 2 else 1), s)
            if self.mode and self.mode[1] in (0, 2, 3):
                self.trns = s
        elif cid == b"gAMA":
            u32(0)
        elif cid == b"cHRM":
            struct.unpack(f">{len(s) // 4}I", s)
        elif cid in (b"sRGB", b"pHYs", b"acTL", b"fcTL") and length < {
                b"sRGB": 1, b"pHYs": 9, b"acTL": 8, b"fcTL": 26}[cid]:
            raise ValueError(f"Truncated {cid.decode()} chunk")
        elif cid == b"acTL":  # a second acTL makes the APNG invalid (a third counts again)
            if self.n_frames is not None:
                self.n_frames = None
            elif 0 < u32(0) <= 0x80000000:
                self.n_frames = u32(0)
        elif cid == b"fcTL":
            self._sequence(s, False)
            width, height = self.size or (0, 0)
            if u32(12) + u32(4) > width or u32(16) + u32(8) > height:
                raise ValueError("APNG contains invalid frames")
            self.bbox = (u32(12), u32(16), u32(12) + u32(4), u32(16) + u32(8))
        elif cid in (b"iCCP", b"zTXt"):
            i = s.find(b"\0")
            if cid == b"iCCP":
                method, text = s[i + 1], s[i + 2 :]
            else:
                method, text = (s[i + 1], s[i + 2 :]) if i >= 0 and i + 1 < len(s) else (0, b"")
            if method != 0:
                raise ValueError(f"Unknown compression method {method} in {cid.decode()} chunk")
            d = zlib.decompressobj()
            try:
                d.decompress(text, _SAFEBLOCK)
            except zlib.error:
                return
            if d.unconsumed_tail:
                raise ValueError("Decompressed data too large for PngImagePlugin.MAX_TEXT_CHUNK")
        elif cid == b"iTXt":
            k, _, r = s.partition(b"\0")
            if _ and len(r) >= 2 and r[0] != 0 and r[1] == 0 and r[2:].count(b"\0") >= 2:
                d = zlib.decompressobj()
                try:
                    d.decompress(r[2:].split(b"\0", 2)[2], _SAFEBLOCK)
                except zlib.error:
                    return
                if d.unconsumed_tail:
                    raise ValueError("Decompressed data too large for "
                                     "PngImagePlugin.MAX_TEXT_CHUNK")


# (depth, colour type) -> the pairs PngImagePlugin._MODES opens
_PILLOW_MODES = {(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2), (1, 3), (2, 3), (4, 3),
                 (8, 3), (8, 4), (16, 4), (8, 6), (16, 6)}


def _png_open(raw: bytes) -> tuple:
    """PngImageFile._open and load, as Pillow 12.1.0 walks the chunks ->
    (the stream, the image's inflated rows): the chunks before the first
    IDAT each checked against its CRC; the image data the IDAT chunks that
    follow one another, read 64 KiB at a time and inflated no further than
    the rows need (what follows them, the checksum too, is not read); then
    load_end's walk of the chunks after, whose handlers still raise. An
    APNG's frame 0: where an fcTL comes before the image data, the data is
    that frame's region (the stream's `region`, x0, y0, width, height) of
    a canvas Pillow leaves zero, and the frame is not blended or disposed
    of; where none does, the image data is the default image, itself a
    frame. Where there are more frames than one (Pillow's is_animated),
    load_end stops at the next fcTL."""
    st = _PngStream(raw, 8)
    while True:
        head = st.header()
        if head is None:
            raise ValueError("PNG: a chunk header is cut short")
        cid, length = head
        s = st.call(cid, length)
        if s is None:  # IDAT, IEND, fdAT
            break
        crc = raw[st.pos : st.pos + 4]
        st.pos += len(crc)
        if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(s, zlib.crc32(cid)):
            raise ValueError(f"broken PNG file (bad header checksum in {cid!r})")
    if st.mode is None or not st.size or 0 in st.size:
        raise ValueError("PNG of no mode Pillow opens, or of an empty size (Pillow: not "
                         "identified)")
    if cid == b"IEND":
        raise ValueError("PNG: cannot load this image (no IDAT chunk)")
    (width, height), (depth, colour) = st.size, st.mode
    if st.bbox is not None:
        x0, y0, x1, y1 = st.bbox
        width, height = x1 - x0, y1 - y0
    st.region = (0, 0) + st.size if st.bbox is None else (x0, y0, width, height)
    animated = (st.n_frames or 1) + (st.n_frames is not None and st.bbox is None) > 1
    n = _CHANNELS[colour]
    passes = _ADAM7 if st.interlace else ((0, 0, 1, 1),)
    need = sum(-(-(height - y0) // dy) * (((width - x0 + dx - 1) // dx * n * depth + 7) // 8 + 1)
               for x0, y0, dx, dy in passes if width > x0 and height > y0)
    left = length - 4 if cid == b"fdAT" else length
    d, parts, got = zlib.decompressobj(), [], 0
    while got < need:
        if left == 0:  # load_read: past the CRC, the next chunk must carry image data too
            st.pos += 4
            head = st.header()
            if head is None or head[0] not in (b"IDAT", b"DDAT", b"fdAT"):
                raise ValueError("PNG image file is truncated")
            left = head[1]
            if head[0] == b"fdAT":
                st._sequence(st.read(4), True)
                left -= 4
            continue
        piece = raw[st.pos : st.pos + min(_PIECE, left)]
        st.pos += len(piece)
        left -= min(_PIECE, left)
        if not piece:
            raise ValueError("PNG image file is truncated")
        try:
            parts.append(d.decompress(d.unconsumed_tail + piece, need - got))
        except zlib.error as e:
            raise ValueError(f"PNG image data is corrupt: {e}") from e
        got += len(parts[-1])
    while True:  # load_end
        st.pos += 4
        try:
            head = st.header()
        except ValueError:
            break
        if head is None or head[0] == b"IEND" or head[0] == b"fcTL" and animated:
            break
        if st.call(*head) is None:  # IDAT or fdAT: skipped
            st.read(head[1] - 4 if head[0] == b"fdAT" else head[1])
    return st, b"".join(parts)


def decode_png(raw: bytes, transparency: bool = True) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA"); without
    `transparency`, a tRNS chunk is dropped (Pillow's image of a PNG
    embedded in another file, whose info it does not keep). The chunks
    are walked as Pillow walks them (`_png_open`); a palette shorter than
    an index, or none, reads black."""
    if raw[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    st, data = _png_open(bytes(raw))
    x0, y0, width, height = st.region
    (depth, colour) = st.mode
    n = _CHANNELS[colour]
    trns = st.trns if transparency else None
    palette = np.zeros((256, 3), np.uint8)
    if st.palette is not None:
        entries = st.palette[: min(len(st.palette), 768) // 3 * 3]
        palette[: len(entries) // 3] = np.frombuffer(entries, np.uint8).reshape(-1, 3)
    if st.interlace:
        px = _interlaced(data, height, width, n, depth)
    else:
        px = _samples(data, height, width, n, depth)[0]
    if (width, height) != st.size:  # an APNG frame's region of a zero canvas
        canvas = np.zeros((st.size[1], st.size[0]) + px.shape[2:], px.dtype)
        canvas[y0 : y0 + height, x0 : x0 + width] = px
        px = canvas
        width, height = st.size

    out = np.full((height, width, 4), 255, np.uint8)
    if colour == 3:
        note_core("P", px[..., 0], palette, trns)
        idx = px[..., 0].astype(np.int64)
        out[..., 0:3] = palette[idx]
        if trns is not None:
            alpha = np.full(256, 255, np.uint8)
            alpha[: len(trns)] = np.frombuffer(trns[:256], np.uint8)
            out[..., 3] = alpha[idx]
        return out
    note_core({0: {1: "1", 16: "I;16"}.get(depth, "L"), 2: "RGB", 4: "LA", 6: "RGBA"}[colour],
              px[..., 0] if colour == 0 else None, None, trns)
    if depth == 16 and colour == 0:
        eight = np.minimum(px, 255).astype(np.uint8)
    elif depth == 16:
        eight = (px >> 8).astype(np.uint8)
    elif depth < 8:
        eight = (px * (255 // ((1 << depth) - 1))).astype(np.uint8)
    else:
        eight = px
    if colour in (0, 4):
        out[..., 0:3] = eight[..., 0:1]
    else:
        out[..., 0:3] = eight[..., 0:3]
    if colour in (4, 6):
        out[..., 3] = eight[..., -1]
    elif trns is not None:  # a key colour: grey (0) or RGB (2), 16 bits a sample
        key = np.frombuffer(trns[: 2 * n], ">u2").astype(np.int64)
        if depth == 1:  # Pillow's "1": 255 for any key but 0
            key = np.where(key != 0, 255, 0)
        out[..., 3] = np.where((eight == (key & 0xFF)).all(axis=-1), 0, 255)
    return out


# the order Pillow 12.1.0's Image.open tries its plugins in: Image.ID after its first call
# (preinit's six, then the rest as init registers them)
PILLOW_ORDER = (
    "BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "AVIF", "BLP", "BUFR", "CUR", "PCX", "DCX", "DDS",
    "EPS", "FITS", "FLI", "FTEX", "GBR", "GRIB", "HDF5", "JPEG2000", "ICNS", "ICO", "IM", "IMT",
    "IPTC", "MCIDAS", "MPEG", "TIFF", "MSP", "PCD", "PIXAR", "PSD", "QOI", "SGI", "SPIDER", "SUN",
    "TGA", "WEBP", "WMF", "XBM", "XPM", "XVTHUMB")


def _opened(header, decode):
    """A plugin whose header reader runs at the open, its errors passing
    the file on or ending the open as in Pillow (`read_header`): the
    decode of what it read."""
    def reader(raw):
        h = read_header(header, raw)
        return lambda: decode(raw, h)
    return reader


def _whole(decode):
    """A plugin taken by its signature alone: its header is read with the rest."""
    return lambda raw: (lambda: decode(raw))


def _loaded(load):
    """A plugin whose open loads the image (ICO)."""
    def reader(raw):
        img = load(raw)
        return lambda: img
    return reader


def _jpeg(raw):
    """JPEG: Pillow's header walk at the open; the format "MPO" where
    Pillow's jpeg_factory adopts a multi-picture file."""
    h = read_header(open_jpeg, raw)
    decode = lambda: decode_jpeg(raw, h)  # noqa: E731
    decode.format = h.format
    return decode


def _xvthumb(raw):
    decode = _opened(xvthumb.open_xvthumb, xvthumb.decode_xvthumb)(raw)
    decode.format = xvthumb.FORMAT
    return decode


def _tga(raw):
    why = tga_refusal(raw)
    if why:
        raise NotThisFormat(why)
    return lambda: decode_tga(raw)


def _always(prefix: bytes, name: str) -> bool:
    """The test of a plugin registered without one (IM, IMT, IPTC, PCD,
    SPIDER): `Image.open` runs its reader on every file that reaches it."""
    return True


# format -> (Pillow's test of the first 16 bytes and the name, its reader): a reader
# returns the decode, or raises NotThisFormat where Pillow tries the next plugin
_PLUGINS = {
    "BMP": (lambda p, n: p[:2] == b"BM", _opened(open_bmp, dib_rgba)),
    "DIB": (lambda p, n: len(p) >= 4 and struct.unpack_from("<I", p)[0] in DIB_HEADERS,
            _opened(open_dib, dib_rgba)),
    "GIF": (lambda p, n: p[:6] in (b"GIF87a", b"GIF89a"), _whole(decode_gif)),
    "JPEG": (lambda p, n: p[:3] == b"\xff\xd8\xff", _jpeg),
    "PPM": (lambda p, n: pnm.accept(p), _opened(pnm.open_pnm, pnm.decode_pnm)),
    "PNG": (lambda p, n: p[:8] == PNG_SIGNATURE, _whole(decode_png)),
    "AVIF": (lambda p, n: avif.accept(p), _opened(avif.open_avif, avif.decode_avif)),
    "BLP": (lambda p, n: blp.accept(p), _opened(blp.open_blp, blp.decode_blp)),
    "CUR": (lambda p, n: p[:4] == ico.CUR_SIGNATURE,
            _opened(ico.open_cur, lambda raw, h: dib_rgba(raw, *h))),
    "PCX": (lambda p, n: pcx.accept_pcx(p), _opened(pcx.read_pcx, pcx.decode_pcx)),
    "DCX": (lambda p, n: pcx.accept_dcx(p), _opened(pcx.open_dcx, pcx.decode_pcx)),
    "DDS": (lambda p, n: p[:4] == DDS_SIGNATURE, _opened(open_dds, lambda r, h: decode_dds(r))),
    "FITS": (lambda p, n: fits.accept(p), _opened(fits.open_fits, fits.decode_fits)),
    "FLI": (lambda p, n: fli.accept(p), _opened(fli.open_fli, fli.decode_fli)),
    "FTEX": (lambda p, n: p.startswith(ftex.MAGIC), _opened(ftex.open_ftex, ftex.decode_ftex)),
    "GBR": (lambda p, n: gbr.accept(p), _opened(gbr.open_gbr, gbr.decode_gbr)),
    "JPEG2000": (lambda p, n: p[:4] == J2K_SIGNATURE or p[:12] == JP2_SIGNATURE,
                 _whole(decode_jpeg2000)),
    "ICNS": (lambda p, n: p.startswith(icns.MAGIC), _opened(icns.open_icns, icns.decode_icns)),
    "ICO": (lambda p, n: p[:4] == ico.ICO_SIGNATURE, _loaded(ico.open_ico)),
    "IM": (_always, _opened(im.open_im, im.decode_im)),
    "IMT": (_always, _opened(im.open_imt, im.decode_imt)),
    "IPTC": (_always, _opened(iptc.open_iptc, iptc.decode_iptc)),
    "MCIDAS": (lambda p, n: p.startswith(mcidas.MAGIC), _opened(mcidas.open_mcidas,
                                                                 mcidas.decode_mcidas)),
    "TIFF": (lambda p, n: p[:4] in _TIFF_SIGNATURES, _whole(decode_tiff)),
    "MSP": (lambda p, n: msp.accept(p), _opened(msp.open_msp, msp.decode_msp)),
    "PCD": (_always, _opened(pcd.open_pcd, pcd.decode_pcd)),
    "PIXAR": (lambda p, n: p.startswith(pixar.MAGIC), _opened(pixar.open_pixar, pixar.decode_pixar)),
    "PSD": (lambda p, n: p[:4] == PSD_SIGNATURE, _opened(open_psd, lambda r, h: decode_psd(r))),
    "QOI": (lambda p, n: p[:4] == qoi.QOI_SIGNATURE, _opened(qoi.open_qoi, qoi.decode_qoi)),
    "SGI": (lambda p, n: sgi.accept(p), _opened(sgi.open_sgi, sgi.decode_sgi)),
    "SPIDER": (_always, _opened(spider.open_spider, spider.decode_spider)),
    "SUN": (lambda p, n: sun.accept(p), _opened(sun.open_sun, sun.decode_sun)),
    "TGA": (lambda p, n: n.lower().endswith(_TGA_NAMES), _tga),
    "WEBP": (lambda p, n: p[:4] == b"RIFF" and p[8:12] == b"WEBP", _whole(decode_webp)),
    "XBM": (lambda p, n: xbm.accept(p), _opened(xbm.open_xbm, xbm.decode_xbm)),
    "XPM": (lambda p, n: p.startswith(xpm.MAGIC), _opened(xpm.open_xpm, xpm.decode_xpm)),
    "XVTHUMB": (lambda p, n: p.startswith(xvthumb.MAGIC), _xvthumb),
}


def _identify(raw: bytes, name: str):
    """-> (Pillow's format name, the decode) of the first plugin in Pillow's
    order that takes the file."""
    prefix, passed = raw[:16], []
    for fmt in PILLOW_ORDER:
        plugin = _PLUGINS.get(fmt)
        if plugin is None or not plugin[0](prefix, name):
            continue
        try:
            decode = plugin[1](raw)
        except NotThisFormat as e:
            passed.append(f"{fmt}: {e}")
            continue
        return getattr(decode, "format", fmt), decode
    seen = f"; passed on by {', '.join(passed)}" if passed else ""
    raise NotImplementedError(f"an image of unknown format (name {name!r}, first bytes "
                              f"{raw[:4].hex()}{seen}) is not decoded ({FORMATS_TODO})")


def image_format(raw: bytes, name: str = "") -> str:
    """The Pillow format name (`Image.open(...).format`) the port decodes
    an image file's bytes as; NotImplementedError where it takes none.
    An ICO is decoded to be found, as Pillow's open loads it."""
    return _identify(bytes(raw), name)[0]


def decode_image_u8(raw: bytes, name: str = "") -> np.ndarray:
    """An image file's bytes -> uint8 [H, W, 4], as Pillow's
    `Image.open(...).convert("RGBA")`. `name` (a file name or a MIME type)
    lets TGA, which has no signature, be tried."""
    return _identify(bytes(raw), name)[1]()


def decode_image_rgba(raw: bytes, name: str = "") -> np.ndarray:
    """An image file's bytes -> float32 [H, W, 4] in [0, 1], as the JAX
    package's `np.asarray(Image.open(...).convert("RGBA"), np.float32) / 255`."""
    return np.asarray(decode_image_u8(raw, name), np.float32) / 255.0


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF
    )


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> PNG bytes: 8 bits a
    sample, not interlaced, every scanline filter 0 (None)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"encode_png takes uint8 [H, W, 3 or 4], not {img.dtype} {img.shape}")
    height, width, n = img.shape
    rows = np.zeros((height, width * n + 1), np.uint8)  # column 0: the filter byte
    rows[:, 1:] = img.reshape(height, width * n)
    header = struct.pack(">IIBBBBB", width, height, 8, 2 if n == 3 else 6, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))
