"""A JPEG decoder for scene textures and LDR skyboxes, as Pillow 12.1.0
reads JPEG with its libjpeg-turbo 3.1.3.

The JAX package decodes JPEGs with Pillow (`Image.open(...).convert("RGBA")`,
rustic_tpu/scene/gltf.py `_decode_image`); `decode_jpeg` gives the same
bytes. `open_jpeg` is Pillow's JpegImageFile._open: it walks the markers
to the first SOS and raises what Pillow raises (SyntaxError and the rest
of utils.PASSED_ON pass the file on; OSError ends the open), and names
the format "MPO" where Pillow's jpeg_factory adopts a multi-picture file.

`decode_jpeg` then runs libjpeg-turbo's decoder over the whole file, fed
64 KiB at a time as Pillow's ImageFile.load feeds it
(utils/_entropy.py's jpeg_scan and jpeg_lossless_scan in
csrc/image_entropy.cpp are its entropy loops). It reads 8-bit frames of
1, 3 or 4 components: Huffman sequential (SOF0, SOF1), progressive
(SOF2) and lossless (SOF3), and arithmetic sequential (SOF9) and
progressive (SOF10) with DAC conditioning; any table ids, restart
intervals, MCU layout and integral sampling; grey, YCbCr or RGB
(libjpeg's guess from JFIF, Adobe's transform or the component ids: any
ids but 'R', 'G', 'B' mean YCbCr in a DCT file and RGB in a lossless
one), CMYK or YCCK (Adobe transform 2, or any but 0) inverted as
Pillow's "CMYK;I" rawmode inverts them. Corrupt data is decoded as
libjpeg decodes it: junk between segments is skipped; a scan that runs
into a marker decodes the MCU in progress on zero bits and leaves the
rest of its restart interval zero; restart markers that are missing,
repeated or out of sequence are resynchronised by libjpeg's rules; a
Huffman code not in its table reads as a zero after 17 bits (libjpeg's
fast and slow paths alike); an arithmetic code that overflows stops its
interval; a sequential scan without its DHT takes libjpeg's standard
tables; a progressive file whose coefficients are incomplete (cut after
some scans, or never sent to the last bit) is smoothed block by block
(jdcoefct.c decompress_smooth_data) before its IDCT.

libjpeg-turbo's arithmetic is reproduced where it rounds or wraps: int16
coefficients, the AVX2 accurate integer IDCT (16-bit dequantisation and
sums where the SIMD code keeps them in 16 bits, 32-bit products,
saturation to 16 bits after each pass, the DC-only first pass),
"fancy" upsampling (plain replication in lossless files), and the
fixed-point YCbCr and YCCK tables of jdcolor.c.

What Pillow refuses raises: hierarchical (SOF5-7, SOF13-15) and
arithmetic-coded lossless (SOF11) files NotImplementedError naming them;
a lossless file in YCbCr or YCCK, which libjpeg will not convert,
ValueError;
a frame whose height a DNL marker sets, or of a precision other than 8
or a component count other than 1, 3 or 4, passes on from `open_jpeg`
(utils/png.py then names it); data libjpeg or Pillow turns away,
ValueError. A file that ends without a marker where libjpeg needs more
raises ValueError where Pillow raises OSError ("image file is truncated").
"""

from __future__ import annotations

import io
import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO
from rustic_tpu_torch.utils.modes import check_pixels, to_rgba

# the k-th coefficient of the zigzag order -> its index in the 8x8 block (row-major)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
_UNZIG = np.argsort(ZIGZAG)  # block index -> zigzag position
FEED = 65536  # Pillow's ImageFile.MAXBLOCK: the bytes each decoder call is given

# frame markers -> (kind, progressive, arithmetic); the rest of 0xC0-0xCF that libjpeg refuses
_FRAMES = {0xC0: ("dct", False, False), 0xC1: ("dct", False, False),
           0xC2: ("dct", True, False), 0xC3: ("lossless", False, False),
           0xC9: ("dct", False, True), 0xCA: ("dct", True, True),
           0xCB: ("lossless", False, True)}
_REFUSED_SOF = {
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical progressive (SOF6)",
    0xC7: "hierarchical lossless (SOF7)", 0xC8: "JPG extension (SOF type 0xc8)",
    0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless (SOF15)",
}
# libjpeg's standard tables (jstdhuff.c), used where a scan names table 0 or 1 and no DHT
# defined it: (counts of lengths 1-16, symbols)
_STD_DC = {0: ("00010501010101010100000000000000", "000102030405060708090a0b"),
           1: ("00030101010101010101010000000000", "000102030405060708090a0b")}
_STD_AC = {
    0: ("0002010303020403050504040000017d",
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a1617"
        "18191a25262728292a3435363738393a434445464748494a535455565758595a636465666768696a73"
        "7475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9"
        "bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    1: ("00020102040403040705040400010277",
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e1"
        "25f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a"
        "737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7"
        "b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}
_TABLE_INTS = 256 + 18 + 18 + 256  # a derived table as csrc/image_entropy.cpp reads it


def _refuse(variant: str):
    raise NotImplementedError(f"JPEG {variant} is not decoded ({FORMATS_TODO})")


class _Truncated(Exception):
    """libjpeg suspended where the file had no more bytes."""


class _Finished(Exception):
    """libjpeg suspended after the last scanline: Pillow's decode is done."""


# ---- Pillow's header reader -------------------------------------------------------------------

class JpegHeader(NamedTuple):
    mode: str  # "L", "RGB" or "CMYK"
    width: int
    height: int
    format: str  # "JPEG", or "MPO" where jpeg_factory adopts the file


_SKIP, _APP, _SOF, _DQT, _COM, _NONE = range(6)
_PIL_MARKERS = {0xC4: _SKIP, 0xC8: _NONE, 0xCC: _SKIP, 0xDA: _SKIP, 0xDB: _DQT, 0xDC: _SKIP,
                0xDD: _SKIP, 0xDE: _SOF, 0xDF: _SKIP, 0xFE: _COM,
                **{m: _SOF for m in (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                                     0xCD, 0xCE, 0xCF)},
                **{m: _NONE for m in range(0xD0, 0xDA)},
                **{m: _APP for m in range(0xE0, 0xF0)},
                **{m: _NONE for m in range(0xF0, 0xFE)}}


def _i16(s: bytes, o: int = 0) -> int:
    return struct.unpack_from(">H", s, o)[0]


def open_jpeg(raw: bytes) -> JpegHeader:
    """Pillow's JpegImageFile._open over `raw` (and ImageFile's test of its
    mode and size, and jpeg_factory's MPO test) -> JpegHeader. Raises what
    Pillow raises: SyntaxError, IndexError or struct.error where the file
    passes on to the next plugin, OSError where the open ends."""
    raw = bytes(raw)
    if raw[:3] != b"\xff\xd8\xff":
        raise SyntaxError("not a JPEG file")
    fp = io.BytesIO(raw)
    fp.seek(3)
    s = b"\xff"
    size, layers, mp, icc, hdr = None, 0, None, [], False

    def safe_read():  # a segment's length and ImageFile._safe_read of its body
        n = _i16(fp.read(2)) - 2
        if n <= 0:
            return b""
        data = fp.read(n)
        if len(data) < n:
            raise OSError("Truncated File Read")
        return data

    while True:
        i = s[0]
        if i != 0xFF:
            s = fp.read(1)  # skip non-0xFF junk
            continue
        s = s + fp.read(1)
        i = _i16(s)
        if (i & 0xFF) in _PIL_MARKERS:
            marker, kind = i & 0xFF, _PIL_MARKERS[i & 0xFF]
            if kind in (_SKIP, _COM):
                safe_read()
            elif kind == _APP:
                body = safe_read()
                if marker == 0xE0 and body.startswith(b"JFIF"):
                    _i16(body, 5)
                elif marker == 0xE2 and body.startswith(b"ICC_PROFILE\0"):
                    icc.append(body)
                elif marker == 0xED and body.startswith(b"Photoshop 3.0\x00"):
                    _photoshop(body)
                elif marker == 0xEE and body.startswith(b"Adobe"):
                    _i16(body, 5)
                elif marker == 0xE2 and body.startswith(b"MPF\0"):
                    mp = body[4:]
                hdr |= marker == 0xE1 and b' hdrgm:Version="' in body
            elif kind == _SOF:
                body = safe_read()
                size = _i16(body, 3), _i16(body, 1)
                if body[0] != 8:
                    raise SyntaxError(f"cannot handle {body[0]}-bit layers")
                layers = body[5]
                if layers not in (1, 3, 4):
                    raise SyntaxError(f"cannot handle {layers}-layer images")
                if icc:
                    icc.sort()
                    icc[0][13]  # Pillow's fix-up of the profile's fragments
                    icc = []
                for k in range(6, len(body), 3):
                    t = body[k : k + 3]
                    t[0], t[1], t[2]
            elif kind == _DQT:
                body = safe_read()
                while len(body):
                    qt_length = 1 + (1 if body[0] // 16 == 0 else 2) * 64
                    if len(body) < qt_length:
                        raise SyntaxError("bad quantization table marker")
                    body = body[qt_length:]
            if marker == 0xDA:
                break
            s = fp.read(1)
        elif i == 0xFFFF:
            s = b"\xff"  # a fill byte
        elif i == 0xFF00:
            s = fp.read(1)
        else:
            raise SyntaxError("no marker found")
    if not layers or size[0] <= 0 or size[1] <= 0:
        why = " (a height set by a DNL marker)" if size and size[1] == 0 else ""
        raise SyntaxError(f"JPEG of size {size} and {layers} layers{why}: not identified")
    check_pixels(size[0], size[1], "JPEG")  # Image.open's decompression-bomb check
    mode = {1: "L", 3: "RGB", 4: "CMYK"}[layers]
    return JpegHeader(mode, size[0], size[1], "MPO" if _is_mpo(mp, hdr) else "JPEG")


def _photoshop(s: bytes):
    """APP13's resource walk, as far as it raises (IndexError on a cut name)."""
    offset = 14
    while s[offset : offset + 4] == b"8BIM":
        try:
            offset += 4
            code = _i16(s, offset)
            offset += 2
            offset += 1 + s[offset]
            offset += offset & 1
            size = struct.unpack_from(">I", s, offset)[0]
            offset += 4
            if code == 0x03ED and len(s[offset : offset + size]) < 14:
                break  # ResolutionInfo cut short: Pillow's struct.error ends the walk
            offset += size
            offset += offset & 1
        except struct.error:
            break


def _is_mpo(mp: bytes, hdr: bool) -> bool:
    """jpeg_factory's test: an MP index (MPF APP2: a TIFF directory) of more
    than one picture, each a JPEG, and no Ultra HDR gain map. A malformed
    index leaves the file a JPEG, as in Pillow."""
    if mp is None or hdr or len(mp) < 8:
        return False
    order = ">" if mp.startswith(b"MM\x00\x2a") else "<"
    try:
        (ifd,) = struct.unpack_from(order + "I", mp, 4)
        (n,) = struct.unpack_from(order + "H", mp, ifd)
        tags = {}
        for k in range(n):
            tag, typ, count, value = struct.unpack_from(order + "HHI4s", mp, ifd + 2 + 12 * k)
            width = {1: 1, 2: 1, 3: 2, 4: 4, 7: 1}.get(typ, 4) * count
            data = value[:width] if width <= 4 else mp[struct.unpack(order + "I", value)[0]:][
                :width]
            tags[tag] = (typ, count, data)
        typ, count, data = tags[0xB001]
        quant = struct.unpack_from(order + ("H" if typ == 3 else "I"), data)[0]
        entries = tags[0xB002][2]
    except (KeyError, IndexError, struct.error):
        return False  # Pillow's "malformed MP Index": read as a JPEG
    for k in range(quant):  # a cut entry list raises struct.error: the file passes on
        attribute = struct.unpack_from(order + "LLLHH", entries, 16 * k)[0]
        if (attribute >> 24) & 7:
            return False  # "unsupported picture format in MPO": read as a JPEG
    return quant > 1


# ---- libjpeg's Huffman tables -----------------------------------------------------------------

def _derived(counts, symbols, dc: bool, lossless: bool = False) -> np.ndarray:
    """jdhuff.c jpeg_make_d_derived_tbl -> int32 [lookup 256, maxcode 18,
    valoffset 18, huffval 256]; ValueError where libjpeg finds it bad."""
    counts = list(counts)
    sizes = [length for length in range(1, 17) for _ in range(counts[length - 1])]
    if len(sizes) > 256:
        raise ValueError("JPEG Huffman table has more than 256 symbols")
    codes, code, p = [], 0, 0
    si = sizes[0] if sizes else 0
    while p < len(sizes):
        while p < len(sizes) and sizes[p] == si:
            codes.append(code)
            code += 1
            p += 1
        if code >= 1 << si:  # no code may be all ones
            raise ValueError("JPEG Huffman table is bad (a code of all ones)")
        code <<= 1
        si += 1
    out = np.zeros(_TABLE_INTS, np.int32)
    lookup, maxcode, valoffset, huffval = (out[:256], out[256:274], out[274:292], out[292:])
    huffval[: len(symbols)] = list(symbols)
    p = 0
    for length in range(1, 17):
        n = counts[length - 1]
        if n:
            valoffset[length] = p - codes[p]
            p += n
            maxcode[length] = codes[p - 1]
        else:
            maxcode[length] = -1
    maxcode[17] = 0xFFFFF
    lookup[:] = 9 << 8
    p = 0
    for length in range(1, 9):
        for _ in range(counts[length - 1]):
            ahead = codes[p] << (8 - length)
            lookup[ahead : ahead + (1 << (8 - length))] = length << 8 | symbols[p]
            p += 1
    if dc and any(v > (16 if lossless else 15) for v in symbols[: len(sizes)]):
        raise ValueError("JPEG DC Huffman table has a symbol past its categories")
    return out


class _Component:
    def __init__(self, index, cid, h, v, tq):
        self.index, self.id, self.h, self.v, self.tq = index, cid, h, v, tq
        self.qt = None  # latched at the component's first scan, as libjpeg does


# ---- libjpeg's decoder, as Pillow drives it -----------------------------------------------------

class _Decoder:
    """One JPEG file's decode: libjpeg's markers (jdmarker.c), scans
    (jdinput.c, the entropy decoders), and output (jdcoefct.c, jidctint,
    jdsample.c, jdcolor.c)."""

    def __init__(self, raw: bytes, cmyk: bool = False, whole: bool = False):
        self.raw = raw
        self.fed = len(raw) if whole else min(len(raw), FEED)
        self.finishing = False  # a one-pass image is output: a suspension ends the decode
        self.cmyk = cmyk  # Pillow's jpegmode "CMYK" (BLP): no YCCK conversion
        self.qt = {}
        self.dc, self.ac = {}, {}  # table id -> (counts, symbols)
        self.dac_l, self.dac_u, self.dac_k = [0] * 16, [1] * 16, [5] * 16  # by table id
        self.restart = 0
        self.frame = None
        self.adobe = None  # APP14's transform flag
        self.jfif = False
        self.comps = []
        self.scans = 0
        self.multiscan = None
        self.last_good = 0  # jdmaster last_good_iMCU_row
        self.output_ends = False  # libtiff: a one-scan image ends with its last row

    # ---- the source ----------------------------------------------------------------------

    def _need(self, end: int):
        """Bytes up to `end` are read: Pillow feeds 64 KiB at a time."""
        while end > self.fed:
            if self.finishing:
                raise _Finished
            if self.fed >= len(self.raw):
                raise _Truncated
            self.fed = min(len(self.raw), self.fed + FEED)

    def _next_marker(self, pos: int):
        """jdmarker.c next_marker from `pos` -> (marker, position after it)."""
        raw = self.raw
        while True:
            ff = raw.find(b"\xff", pos)
            if ff < 0:
                self._need(len(raw) + 1)
            self._need(ff + 1)
            pos = ff + 1
            while pos < len(raw) and raw[pos] == 0xFF:
                pos += 1
            self._need(pos + 1)
            c = raw[pos]
            pos += 1
            if c != 0:
                return c, pos

    def _read(self, pos: int, n: int) -> bytes:
        """n bytes from `pos`, read as libjpeg's INPUT_BYTE reads them: the
        marker handlers below read (and fail) in libjpeg's order, so a
        segment cut at the end of what Pillow has fed suspends where
        libjpeg suspends."""
        self._need(pos + n)
        return self.raw[pos : pos + n]

    def _sos_header(self, pos: int):
        """jdmarker.c get_sos, then consume_markers' test of a one-scan
        image -> (the SOS body, the position after it)."""
        if self.frame is None:
            raise ValueError("JPEG scan before its frame header")
        head = self._read(pos, 3)
        length, n = _i16(head), head[2]
        if length != 2 * n + 6 or not 1 <= n <= 4:
            raise ValueError("JPEG SOS segment of a bad length")
        ids = {c.id for c in self.comps}
        for i in range(n):
            cid = self._read(pos + 3 + 2 * i, 1)[0]
            if cid not in ids:
                raise ValueError(f"JPEG scan names component {cid}, which is not in the frame")
        body = self._read(pos + 2, length - 2)
        if self.multiscan is False:
            raise ValueError("JPEG has a second scan in a one-scan image (libjpeg: EOI expected)")
        return body, pos + length

    def _skip(self, marker: int, pos: int) -> int:
        """APPn, COM and DNL (skip_variable; APP0 and APP14 examined for
        JFIF and Adobe in their first 14 bytes) -> the position after."""
        length = _i16(self._read(pos, 2)) - 2
        if marker in (0xE0, 0xEE):
            body = self._read(pos + 2, min(max(length, 0), 14))
            if marker == 0xE0 and len(body) >= 14 and body[:5] == b"JFIF\x00":
                self.jfif = True
            elif marker == 0xEE and len(body) >= 12 and body[:5] == b"Adobe":
                self.adobe = body[11]
        end = pos + 2 + max(length, 0)
        self._need(end)
        return end

    def _dri(self, pos: int) -> int:
        if _i16(self._read(pos, 2)) != 4:
            raise ValueError("JPEG DRI segment of a bad length")
        self.restart = _i16(self._read(pos + 2, 2))
        return pos + 4

    # ---- markers ---------------------------------------------------------------------------

    def run(self) -> np.ndarray:
        try:
            return self._run()
        except _Truncated:
            raise ValueError("JPEG data runs past the end of the file (Pillow: image file is "
                             "truncated)") from None

    def _run(self) -> np.ndarray:
        self._markers()
        if self.frame is None or not self.scans:
            raise ValueError("JPEG has no image (no frame, or no scan)")
        return self._image()

    def _markers(self, tables_only: bool = False):
        """jdmarker.c read_markers from SOI to EOI (each scan decoded as it
        comes); `tables_only`: an abbreviated stream of tables, which
        may hold no frame and no scan."""
        raw = self.raw
        if raw[:2] != b"\xff\xd8":
            raise ValueError("not a JPEG file (no SOI marker)")
        pos, marker = 2, 0
        try:
            while True:
                if marker == 0:
                    marker, pos = self._next_marker(pos)
                m, marker = marker, 0
                if m == 0xD9:  # EOI
                    break
                if m == 0xD8:
                    raise ValueError("JPEG has a second SOI marker")
                if 0xD0 <= m <= 0xD7 or m == 0x01:  # RSTn, TEM: nothing
                    continue
                if m in _REFUSED_SOF:
                    _refuse(_REFUSED_SOF[m])
                if tables_only and (m == 0xDA or m in _FRAMES):
                    raise ValueError("JPEG tables hold a frame or a scan (libtiff: bogus "
                                     "JPEGTables field)")
                if m == 0xDA:
                    body, pos = self._sos_header(pos)
                    pos, marker = self._scan(body, pos)
                    if self.output_ends and self.finishing:
                        break
                elif m in _FRAMES:
                    pos = self._frame(m, pos)
                elif m == 0xC4:
                    pos = self._dht(pos)
                elif m == 0xCC:
                    pos = self._dac(pos)
                elif m == 0xDB:
                    pos = self._dqt(pos)
                elif m == 0xDD:
                    pos = self._dri(pos)
                elif 0xE0 <= m <= 0xEF or m in (0xFE, 0xDC):  # APPn, COM, DNL
                    pos = self._skip(m, pos)
                else:
                    raise ValueError(f"JPEG marker 0x{m:02x} is unknown to libjpeg")
        except _Finished:
            pass

    def _frame(self, marker, pos):
        """jdmarker.c get_sof from `pos` (after the marker) -> the position
        after the segment: a second frame is refused before anything is
        read, the sizes before the components."""
        if self.frame is not None:
            raise ValueError("JPEG has more than one frame")
        self._need(pos + 8)
        length = _i16(self.raw, pos)
        precision, height, width, n = struct.unpack(">BHHB", self.raw[pos + 2 : pos + 8])
        if height == 0:
            _refuse("height set by a DNL marker")
        if width == 0 or n == 0:
            raise ValueError("JPEG frame is empty")
        if length != 8 + 3 * n:
            raise ValueError("JPEG frame header of a bad length")
        check_pixels(width, height, "JPEG frame")
        body, end = self._read(pos + 2, length - 2), pos + length
        kind, progressive, arith = _FRAMES[marker]
        if precision != 8:
            raise ValueError(f"JPEG {precision}-bit samples")
        if kind == "lossless" and arith:
            _refuse("arithmetic-coded lossless (SOF11)")
        if n not in (1, 3, 4):
            raise ValueError(f"JPEG with {n} components")
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i : 9 + 3 * i]
            if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                raise ValueError(f"JPEG sampling factors {hv >> 4}x{hv & 15}")
            self.comps.append(_Component(i, cid, hv >> 4, hv & 15, tq))
        self.frame = (marker, height, width)
        self.kind, self.progressive, self.arith = kind, progressive, arith
        self.block = 8 if kind == "dct" else 1
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        unit = self.block
        self.mcux = -(-width // (unit * self.hmax))
        self.mcuy = -(-height // (unit * self.vmax))  # also libjpeg's total_iMCU_rows
        base = 0
        for c in self.comps:
            # the component's data units, and the padded grid of interleaved MCUs
            c.bw = -(-width * c.h // (unit * self.hmax))
            c.bh = -(-height * c.v // (unit * self.vmax))
            c.stride = self.mcux * c.h
            c.rows = self.mcuy * c.v
            c.base = base
            base += c.stride * c.rows * (64 if kind == "dct" else 1)
            c.bits = np.full(64, -1, np.int64)  # progression status (coef_bits)
            c.prev_bits = np.zeros(64, np.int64)
        if kind == "dct":
            self.coef = np.zeros(base, np.int16)
        else:
            self.samples = np.zeros(base, np.uint8)
        return end

    def _dht(self, pos: int) -> int:
        length = _i16(self._read(pos, 2)) - 2
        pos += 2
        while length > 16:
            head = self._read(pos, 17)
            index, counts = head[0], head[1:]
            count = sum(counts)
            length -= 17
            if count > 256 or count > length:
                raise ValueError("JPEG Huffman table is bad (its counts)")
            symbols = self._read(pos + 17, count)
            pos += 17 + count
            length -= count
            if index & ~0x10 > 3:
                raise ValueError(f"JPEG Huffman table id {index:#x}")
            (self.ac if index & 0x10 else self.dc)[index & 15] = (bytes(counts), bytes(symbols))
        if length != 0:
            raise ValueError("JPEG DHT segment of a bad length")
        return pos

    def _dac(self, pos: int) -> int:
        length = _i16(self._read(pos, 2)) - 2
        pos += 2
        while length > 0:
            index, val = self._read(pos, 2)
            pos, length = pos + 2, length - 2
            if index >= 32:
                raise ValueError(f"JPEG DAC table index {index}")
            if index >= 16:
                self.dac_k[index - 16] = val
            else:
                self.dac_l[index], self.dac_u[index] = val & 15, val >> 4
                if val & 15 > val >> 4:
                    raise ValueError(f"JPEG DAC value {val:#x}")
        if length != 0:
            raise ValueError("JPEG DAC segment of a bad length")
        return pos

    def _dqt(self, pos: int) -> int:
        """jdmarker.c get_dqt: each table's 64 values read whatever the
        segment's length says, the length checked at the end."""
        length = _i16(self._read(pos, 2)) - 2
        pos += 2
        while length > 0:
            pq_tq = self._read(pos, 1)[0]
            if pq_tq & 15 > 3:
                raise ValueError(f"JPEG quantisation table id {pq_tq & 15}")
            width = 2 if pq_tq >> 4 else 1
            data = self._read(pos + 1, 64 * width)
            self.qt[pq_tq & 15] = np.frombuffer(data, ">u2" if width == 2 else np.uint8).astype(
                np.int64)  # zigzag order
            pos, length = pos + 1 + 64 * width, length - 1 - 64 * width
        if length != 0:
            raise ValueError("JPEG DQT segment of a bad length")
        return pos

    # ---- scans ----------------------------------------------------------------------------

    def _table(self, tables, std, tid, dc):
        """A scan's Huffman table as libjpeg derives it; a sequential DCT
        scan takes the standard table 0 or 1 where no DHT defined it (the
        motion-JPEG default jinit_huff_decoder installs)."""
        if tid > 3:
            raise ValueError(f"JPEG Huffman table {tid} is not defined")
        if tid not in tables:
            if tid not in std or self.progressive or self.kind != "dct":
                raise ValueError(f"JPEG Huffman table {tid} is not defined")
            counts, symbols = (bytes.fromhex(x) for x in std[tid])
        else:
            counts, symbols = tables[tid]
        return _derived(counts, symbols, dc, self.kind == "lossless")

    def _scan(self, body, pos):
        n = body[0] if body else 0
        if len(body) != 2 * n + 4 or not 1 <= n <= 4:
            raise ValueError("JPEG SOS segment of a bad length")
        by_id = {}
        for c in self.comps:
            by_id.setdefault(c.id, c)
        comps, ids = [], []
        for i in range(n):
            cid, t = body[1 + 2 * i : 3 + 2 * i]
            c = by_id.get(cid)
            if c is None or c in comps:
                raise ValueError(f"JPEG scan names component {cid}, which is not in the frame")
            comps.append(c)
            ids.append((t >> 4, t & 15))
        ss, se, ahal = body[1 + 2 * n : 4 + 2 * n]
        ah, al = ahal >> 4, ahal & 15
        self.scans += 1
        if self.multiscan is None:
            self.multiscan = n < len(self.comps) or self.progressive
        if self.kind == "dct":
            for c in comps:
                if c.qt is None:
                    if c.tq not in self.qt:
                        raise ValueError(f"JPEG quantisation table {c.tq} is not defined")
                    c.qt = self.qt[c.tq]
        # the MCUs: each a list of (scan component, data unit index in the component's grid)
        if n == 1:
            c = comps[0]
            r, x = np.mgrid[0 : c.bh, 0 : c.bw]
            units = (r * c.stride + x).reshape(-1, 1)
            block_comp = np.zeros(1, np.int32)
            mcus_per_row = c.bw
        else:
            my, mx = (a.reshape(-1) for a in np.mgrid[0 : self.mcuy, 0 : self.mcux])
            layout = [(i, c, dy, dx) for i, c in enumerate(comps)
                      for dy in range(c.v) for dx in range(c.h)]
            if len(layout) > 10:
                raise ValueError(f"JPEG MCU of {len(layout)} blocks (libjpeg takes 10)")
            units = np.stack([(my * c.v + dy) * c.stride + mx * c.h + dx
                              for _, c, dy, dx in layout], axis=1)
            block_comp = np.array([i for i, *_ in layout], np.int32)
            mcus_per_row = self.mcux
        if self.kind == "lossless":
            return self._lossless_scan(comps, ids, ss, se, ah, al, mcus_per_row, pos)
        base = np.array([comps[i].base for i in block_comp], np.int64)
        if self.progressive:
            self._progression(comps, ss, se, ah, al)
        tables = np.zeros((8, _TABLE_INTS), np.int32)
        if not self.arith:
            for i, (c, (td, ta)) in enumerate(zip(comps, ids)):
                if not self.progressive or (ss == 0 and ah == 0):
                    tables[td] = self._table(self.dc, _STD_DC, td, True)
                if not self.progressive or ss:
                    tables[4 + ta] = self._table(self.ac, _STD_AC, ta, False)
        else:
            for td, ta in ids:
                if (not self.progressive or (ss == 0 and ah == 0)) and td > 15 or (
                        not self.progressive or ss) and ta > 15:
                    raise ValueError("JPEG scan names an arithmetic table past 15")
        offsets = np.ascontiguousarray(base + units * 64, np.int64)
        kind = (2 if self.arith else 0) + (1 if self.progressive else 0)
        p = np.zeros(65, np.int32)
        p[:9] = (kind, self.restart, ss, se, ah, al, len(block_comp), len(units), n)
        for i, (td, ta) in enumerate(ids):
            p[9 + i], p[13 + i] = td, ta
        p[17:33], p[33:49], p[49:65] = self.dac_l, self.dac_u, self.dac_k
        return self._run_scan("jpeg_scan", pos, [p, block_comp, offsets, self.coef, tables],
                              mcus_per_row, comps)

    def _run_scan(self, fn, pos, arrays, units_per_row, comps):
        """One scan through csrc/image_entropy.cpp `fn` -> (the position
        the marker reader goes on from, the marker the decoder read or 0)."""
        from rustic_tpu_torch.utils import _entropy

        io_ = np.array([self.fed, 0, -1], np.int64)
        raw = np.frombuffer(self.raw, np.uint8)
        end = getattr(_entropy.library(), fn)(_entropy.ptr(raw), len(self.raw), pos,
                                              _entropy.ptr(io_),
                                              *(_entropy.ptr(a) for a in arrays))
        self.fed = int(io_[0])
        if end == -1:
            raise _Truncated
        if end == -2:
            raise ValueError("JPEG arithmetic-coded data past what Pillow has fed the decoder "
                             "(libjpeg cannot suspend there: Pillow's broken data stream)")
        if io_[2] >= 0:  # libjpeg's last_good_iMCU_row
            rows = 1 if len(comps) > 1 else comps[0].v
            self.last_good = int(io_[2]) // units_per_row // rows
        if not self.multiscan:
            self.finishing = True
        return int(end), int(io_[1])

    def _progression(self, comps, ss, se, ah, al):
        """jdphuff.c / jdarith.c start_pass: the scan's checks and the
        progression status (coef_bits and the previous scan's)."""
        bad = (se != 0) if ss == 0 else (ss > se or se > 63 or len(comps) != 1)
        if ah != 0 and al != ah - 1 or al > 13 or bad:
            raise ValueError(f"JPEG progressive scan with Ss={ss}, Se={se}, Ah={ah}, Al={al}")
        for c in comps:
            lo, hi = min(ss, 1), max(se, 9)
            c.prev_bits[lo : hi + 1] = c.bits[lo : hi + 1] if self.scans > 1 else 0
            c.bits[ss : se + 1] = al

    def _lossless_scan(self, comps, ids, ss, se, ah, al, mcus_per_row, pos):
        if not 1 <= ss <= 7 or se != 0 or ah != 0 or al >= 8:
            raise ValueError(f"JPEG lossless scan with Ss={ss}, Se={se}, Ah={ah}, Al={al}")
        if self.restart % mcus_per_row:
            raise ValueError(f"JPEG restart interval {self.restart} is not a whole number of "
                             f"MCU rows ({mcus_per_row})")
        tables = np.zeros((8, _TABLE_INTS), np.int32)
        for td, _ in ids:
            tables[td] = self._table(self.dc, _STD_DC, td, True)
        p = np.zeros(13, np.int32)
        p[:9] = (self.restart, ss, se, ah, al, len(comps), mcus_per_row, self.mcuy,
                 len(comps) > 1)
        p[9 : 9 + len(comps)] = [td for td, _ in ids]
        geom = np.array([[c.h, c.v, c.bw, c.bh, c.bh % c.v or c.v, c.base, c.stride]
                         for c in comps], np.int64)
        return self._run_scan("jpeg_lossless_scan", pos, [p, geom, tables, self.samples],
                              mcus_per_row, comps)

    # ---- pixels ---------------------------------------------------------------------------

    def _image(self) -> np.ndarray:
        planes = self._planes()
        if len(planes) == 1:
            return to_rgba("L", planes[0])
        if len(planes) == 4:
            px = np.stack(planes, -1)
            if not self.cmyk and self.adobe is not None and self.adobe != 0:
                px[..., :3] = np.clip(255 - _ycc_sums(*planes[:3]), 0, 255)  # YCCK -> CMYK
            return to_rgba("CMYK", 255 - px)  # Pillow's "CMYK;I" rawmode
        if self._is_rgb():
            return to_rgba("RGB", np.stack(planes, -1))
        return to_rgba("RGB", _ycc_to_rgb(*planes))

    def _planes(self) -> list:
        """Each component's samples at the frame's full size (jdcoefct.c,
        jidctint, jdsample.c), before any colour conversion."""
        _, height, width = self.frame
        lossless = self.kind == "lossless"
        if lossless and (len(self.comps) == 3 and not self._is_rgb() or len(self.comps) == 4 and (
                not self.cmyk and self.adobe not in (None, 0))):
            raise ValueError("lossless JPEG in YCbCr or YCCK: libjpeg converts no colour space "
                             "losslessly (Pillow: broken data stream)")
        smooth = not lossless and self._smoothing_ok()
        planes = []
        for c in self.comps:
            if lossless:
                plane = self.samples[c.base : c.base + c.stride * c.rows].reshape(c.rows, c.stride)
            else:
                zz = self.coef[c.base : c.base + c.stride * c.rows * 64].reshape(-1, 64)
                if smooth:
                    zz = self._smoothed(c, zz)
                q = np.ones(64, np.int64) if c.qt is None else c.qt
                blocks = _idct_islow(zz[:, _UNZIG], q[_UNZIG])
                plane = blocks.reshape(c.rows, c.stride, 8, 8).transpose(0, 2, 1, 3)
                plane = plane.reshape(c.rows * 8, c.stride * 8)
                if c.qt is None:  # a component in no scan: libjpeg's zero multipliers
                    plane = np.full_like(plane, 128)
            # the component's own samples: ceil(size x factor / max factor)
            dw = -(-width * c.h // self.hmax)
            dh = -(-height * c.v // self.vmax)
            planes.append(_upsample(plane[:dh, :dw], self.hmax // c.h, self.vmax // c.v,
                                    c.h, c.v, self.hmax, self.vmax,
                                    fancy=not lossless)[:height, :width])
        return planes

    def _is_rgb(self) -> bool:
        """libjpeg's guess of a 3-component colour space (jdapimin.c
        default_decompress_parms): JFIF means YCbCr, else Adobe's
        transform 0 RGB, else component ids 'R', 'G', 'B' RGB; any other
        ids YCbCr in a DCT file and RGB in a lossless one."""
        if self.jfif:
            return False
        if self.adobe is not None:
            return self.adobe == 0
        return [c.id for c in self.comps] == [82, 71, 66] or self.kind == "lossless"

    # ---- block smoothing (jdcoefct.c decompress_smooth_data) ---------------------------------

    def _smoothing_ok(self) -> bool:
        if not self.progressive:
            return False
        useful = False
        for c in self.comps:
            if c.qt is None or c.bits[0] < 0:
                return False
            q = c.qt[:10]  # zigzag 0-9 are the DC and the nine coefficients smoothed
            if (q == 0).any():
                return False
            useful |= bool((c.bits[1:10] != 0).any())
        return useful

    def _smoothed(self, c, zz: np.ndarray) -> np.ndarray:
        """The component's blocks with the coefficients libjpeg estimates
        from the DC values of the 5x5 blocks around each (those still zero
        and not known to their last bit)."""
        t_rows, v = self.mcuy, c.v
        grid = zz.reshape(c.rows, c.stride, 64)
        dc = grid[..., 0].astype(np.int64)
        # the neighbouring block rows as libjpeg picks them (its count of image block rows
        # uses the current iMCU row's rows, so the last rows clamp early)
        rows = np.arange(c.bh)
        r, br = rows // v, rows % v
        nb = np.where(r == t_rows - 1, c.bh % v or v, v)
        ibr, ibrs = r * nb + br, nb * t_rows
        prev = np.where(ibr > 0, rows - 1, rows)
        prev2 = np.where(ibr > 1, rows - 2, prev)
        nxt = np.where(ibr < ibrs - 1, rows + 1, rows)
        nxt2 = np.where(ibr < ibrs - 2, rows + 2, nxt)
        cols = np.arange(c.bw)
        last = c.bw - 1
        colsets = [np.maximum(cols - 2, 0), np.maximum(cols - 1, 0), cols,
                   np.minimum(cols + 1, last), np.minimum(cols + 2, last)]
        DC = [[dc[rr][:, cc] for cc in colsets] for rr in (prev2, prev, rows, nxt, nxt2)]
        D = {5 * i + j + 1: DC[i][j] for i in range(5) for j in range(5)}
        ws = grid[: c.bh, : c.bw].copy()
        q = c.qt
        q00 = int(q[0])
        # the progression status a row is smoothed by: the last scan's where that scan had
        # data for the row (libjpeg's last_good_iMCU_row), else the one before it
        prior = c.prev_bits[1:10] if self.scans > 1 else np.full(9, -1)
        latched = np.where((r > self.last_good)[:, None], prior[None, :], c.bits[None, 1:10])
        change_dc = (latched == -1).all(axis=1)[:, None]  # [rows, 1]

        def kernel(a, b):
            return np.where(change_dc, a, b)

        d = D
        est = {
            1: kernel(-d[1] - d[2] + d[4] + d[5] - 3 * d[6] + 13 * d[7] - 13 * d[9] + 3 * d[10]
                      - 3 * d[11] + 38 * d[12] - 38 * d[14] + 3 * d[15] - 3 * d[16] + 13 * d[17]
                      - 13 * d[19] + 3 * d[20] - d[21] - d[22] + d[24] + d[25],
                      -7 * d[11] + 50 * d[12] - 50 * d[14] + 7 * d[15]),
            2: kernel(-d[1] - 3 * d[2] - 3 * d[3] - 3 * d[4] - d[5] - d[6] + 13 * d[7]
                      + 38 * d[8] + 13 * d[9] - d[10] + d[16] - 13 * d[17] - 38 * d[18]
                      - 13 * d[19] + d[20] + d[21] + 3 * d[22] + 3 * d[23] + 3 * d[24] + d[25],
                      -7 * d[3] + 50 * d[8] - 50 * d[18] + 7 * d[23]),
            3: kernel(d[3] + 2 * d[7] + 7 * d[8] + 2 * d[9] - 5 * d[12] - 14 * d[13]
                      - 5 * d[14] + 2 * d[17] + 7 * d[18] + 2 * d[19] + d[23],
                      -d[3] + 13 * d[8] - 24 * d[13] + 13 * d[18] - d[23]),
            4: kernel(-d[1] + d[5] + 9 * d[7] - 9 * d[9] - 9 * d[17] + 9 * d[19] + d[21] - d[25],
                      d[10] + d[16] - 10 * d[17] + 10 * d[19] - d[2] - d[20] + d[22] - d[24]
                      + d[4] - d[6] + 10 * d[7] - 10 * d[9]),
            5: kernel(2 * d[7] - 5 * d[8] + 2 * d[9] + d[11] + 7 * d[12] - 14 * d[13]
                      + 7 * d[14] + d[15] + 2 * d[17] - 5 * d[18] + 2 * d[19],
                      -d[11] + 13 * d[12] - 24 * d[13] + 13 * d[14] - d[15]),
            6: d[7] - d[9] + 2 * d[12] - 2 * d[14] + d[17] - d[19],
            7: d[7] - 3 * d[8] + d[9] - d[17] + 3 * d[18] - d[19],
            8: d[7] - d[9] - 3 * d[12] + 3 * d[14] + d[17] - d[19],
            9: d[7] + 2 * d[8] + d[9] - d[17] - 2 * d[18] - d[19],
        }
        # zigzag positions 1-9: AC01 AC10 AC20 AC11 AC02 AC03 AC12 AC21 AC30
        for k in range(1, 10):
            al = latched[:, k - 1][:, None]
            apply = (al != 0) & (ws[..., k] == 0)
            if k >= 6:
                apply &= change_dc
            qk = int(q[k])
            num = q00 * est[k]
            pred = ((qk << 7) + np.abs(num)) // (qk << 8)
            pred = np.where((al > 0) & (pred >= (1 << np.maximum(al, 0))),
                            (1 << np.maximum(al, 0)) - 1, pred)
            pred = np.where(num >= 0, pred, -pred)
            ws[..., k] = np.where(apply, pred.astype(np.int64).astype(np.int16), ws[..., k])
        num = q00 * (-2 * d[1] - 6 * d[2] - 8 * d[3] - 6 * d[4] - 2 * d[5] - 6 * d[6] + 6 * d[7]
                     + 42 * d[8] + 6 * d[9] - 6 * d[10] - 8 * d[11] + 42 * d[12] + 152 * d[13]
                     + 42 * d[14] - 8 * d[15] - 6 * d[16] + 6 * d[17] + 42 * d[18] + 6 * d[19]
                     - 6 * d[20] - 2 * d[21] - 6 * d[22] - 8 * d[23] - 6 * d[24] - 2 * d[25])
        pred = ((q00 << 7) + np.abs(num)) // (q00 << 8)
        pred = np.where(num >= 0, pred, -pred)
        ws[..., 0] = np.where(change_dc, pred.astype(np.int16), ws[..., 0])
        full = grid.copy()
        full[: c.bh, : c.bw] = ws
        return full.reshape(-1, 64)


# ---- the accurate integer IDCT, as libjpeg-turbo's AVX2 routine computes it -------------------

_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _w16(x):
    """int32 -> the int16 it wraps to, as int32."""
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_1d(x, shift):
    """One pass over the last axis of int32 [..., 8] of 16-bit values, as
    jidctint-avx2.asm computes it: the sums in0 +- in4, in7 + in3 and
    in5 + in1 in 16 bits, the products and the rest in 32 bits (wrapping),
    each output descaled by `shift` bits with rounding and saturated to 16
    bits (packssdw)."""
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[..., i] for i in range(8))
    tmp0 = _w16(x0 + x4) << _CONST_BITS
    tmp1 = _w16(x0 - x4) << _CONST_BITS
    tmp3 = x2 * (_F0541 + _F0765) + x6 * _F0541
    tmp2 = x2 * _F0541 + x6 * (_F0541 - _F1847)
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    z3, z4 = _w16(x7 + x3), _w16(x5 + x1)
    z3_ = z3 * (_F1175 - _F1961) + z4 * _F1175
    z4_ = z3 * _F1175 + z4 * (_F1175 - _F0390)
    o0 = x7 * (_F0298 - _F0899) + x1 * -_F0899 + z3_
    o3 = x7 * -_F0899 + x1 * (_F1501 - _F0899) + z4_
    o1 = x5 * (_F2053 - _F2562) + x3 * -_F2562 + z4_
    o2 = x5 * -_F2562 + x3 * (_F3072 - _F2562) + z3_
    half = np.int32(1 << (shift - 1))
    out = np.stack([t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                    t13 - o0, t12 - o1, t11 - o2, t10 - o3], axis=-1)
    return np.clip((out + half) >> shift, -32768, 32767).astype(np.int32)


def _idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """int16 coefficients [N, 64] and the quantisation table [64], both in
    natural order (row = vertical frequency) -> uint8 samples [N, 8, 8],
    as libjpeg-turbo 3.1.3's jsimd_idct_islow_avx2."""
    with np.errstate(over="ignore"):
        c = coef.astype(np.int32)
        q = np.asarray(qt).astype(np.int64).astype(np.int32)
        deq = _w16(c * q).reshape(-1, 8, 8)  # pmullw
        cols = deq.transpose(0, 2, 1)  # [N, column, row]
        ws = _idct_1d(cols, _CONST_BITS - _PASS1_BITS)
        dc_only = ~(c.reshape(-1, 8, 8)[:, 1:, :] != 0).any(axis=(1, 2))
        if dc_only.any():  # rows 1-7 all zero: the column pass is the DC << 2 in 16 bits
            ws[dc_only] = _w16(deq[dc_only, 0, :] << _PASS1_BITS)[:, :, None]
        out = _idct_1d(ws.transpose(0, 2, 1), _CONST_BITS + _PASS1_BITS + 3)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


# ---- upsampling (jdsample.c) and colour (jdcolor.c) ------------------------------------------

def _neighbour(n: int, axis_len: int) -> np.ndarray:
    """For each output sample of a 2x upsampling of `axis_len` samples:
    its nearer input sample and the next nearer, the edge repeated."""
    out = np.arange(2 * axis_len)
    near = out // 2
    far = np.clip(np.where(out % 2, near + 1, near - 1), 0, axis_len - 1)
    return near, far


def _upsample(plane, fx, fy, h, v, hmax, vmax, fancy=True):
    """A component's [dh, dw] samples -> the full grid, as libjpeg-turbo's
    jinit_upsampler picks the method for (h, v) against (hmax, vmax);
    without `fancy` (lossless files) every ratio replicates."""
    p = plane.astype(np.int32)
    dh, dw = p.shape
    odd_x = np.arange(2 * dw) % 2
    odd_y = (np.arange(2 * dh) % 2)[:, None]
    if fx == 1 and fy == 1:
        return plane
    if fancy and fx == 2 and fy == 1 and dw > 2:  # h2v1 fancy: 3/4, 1/4 with biases 1, 2
        near, far = _neighbour(2, dw)
        return ((3 * p[:, near] + p[:, far] + 1 + odd_x) >> 2).astype(np.uint8)
    if fancy and fx == 1 and fy == 2:  # h1v2 fancy, at any width
        near, far = _neighbour(2, dh)
        return ((3 * p[near] + p[far] + 1 + odd_y) >> 2).astype(np.uint8)
    if fancy and fx == 2 and fy == 2 and dw > 2:  # h2v2 fancy: column sums, biases 8, 7
        near, far = _neighbour(2, dh)
        cols = 3 * p[near] + p[far]
        near, far = _neighbour(2, dw)
        return ((3 * cols[:, near] + cols[:, far] + 8 - odd_x) >> 4).astype(np.uint8)
    if hmax % h or vmax % v:
        raise ValueError(f"JPEG sampling {h}x{v} against {hmax}x{vmax} is not integral")
    return np.repeat(np.repeat(plane, fy, axis=0), fx, axis=1)


def _colour_tables():
    x = np.arange(256, dtype=np.int32) - 128
    one_half = 1 << 15

    def fix(f):
        return int(f * 65536 + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _colour_tables()


def _ycc_sums(y, cb, cr) -> np.ndarray:
    """uint8 Y, Cb, Cr planes -> int32 [..., 3], R G B before their range
    limit (jdcolor.c ycc_rgb_convert; ycck_cmyk_convert limits 255 minus them)."""
    y = y.astype(np.int32)
    return np.stack([y + _CR_R[cr], y + ((_CB_G[cb] + _CR_G[cr]) >> 16), y + _CB_B[cb]], axis=-1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """uint8 Y, Cb, Cr planes -> uint8 [..., 3] RGB (jdcolor.c ycc_rgb_convert)."""
    return np.clip(_ycc_sums(y, cb, cr), 0, 255).astype(np.uint8)


def decode_jpeg(raw: bytes, header: JpegHeader = None, cmyk: bool = False) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA"); with
    `cmyk`, a four-component file is read as CMYK whatever its Adobe
    segment says (Pillow's jpegmode "CMYK", which its BLP reader sets).
    Data libjpeg cannot follow raises ValueError."""
    raw = bytes(raw)
    try:
        out = _Decoder(raw, cmyk).run()
    except (IndexError, KeyError, struct.error) as e:
        raise ValueError(f"JPEG data is corrupt: {type(e).__name__}: {e}") from e
    if header is not None and (header.height, header.width) != out.shape[:2]:
        raise ValueError(f"JPEG frame of {out.shape[1]}x{out.shape[0]} where Pillow's header "
                         f"reader saw {header.width}x{header.height}")
    return out


def tiff_jpeg_tables(tables: bytes):
    """A TIFF's JPEGTables (tag 347), an abbreviated stream of DQT and DHT
    segments, as jpeg_read_header(FALSE) loads it -> the quantisation and
    Huffman tables, which persist into each strip's stream."""
    dec = _Decoder(bytes(tables) + _EOI_FILL, whole=True)
    try:
        dec._markers(tables_only=True)
    except _Truncated:
        raise ValueError("TIFF JPEGTables run past their end") from None
    except (IndexError, KeyError, struct.error) as e:
        raise ValueError(f"TIFF JPEGTables are corrupt: {type(e).__name__}: {e}") from e
    return dec.qt, dec.dc, dec.ac


# libtiff's source manager hands libjpeg an EOI marker wherever a strip's data ends early
_EOI_FILL = b"\xff\xd9" * 32768


def decode_tiff_jpeg(stream: bytes, tables, ycbcr_to_rgb: bool):
    """One strip or tile of a JPEG-compressed TIFF (compression 7) as
    libtiff 4.7.1's tif_jpeg.c decodes it under Pillow -> (uint8 [H, W, n]
    at the stream's frame size, each component's (h, v) sampling).
    `tables` come from `tiff_jpeg_tables` (or None). With `ycbcr_to_rgb`
    (photometric YCbCr, chunky: Pillow sets JPEGCOLORMODE_RGB) libjpeg
    upsamples and converts YCbCr to RGB whatever the markers say; any
    other photometric turns libjpeg's colour handling off (JCS_UNKNOWN):
    the components as they are."""
    dec = _Decoder(bytes(stream) + _EOI_FILL, whole=True)
    dec.output_ends = True  # what follows a one-scan image's scan only reaches
    # jpeg_finish_decompress, whose errors libtiff's JPEGDecode ignores
    if tables is not None:
        qt, dc, ac = tables
        dec.qt, dec.dc, dec.ac = dict(qt), dict(dc), dict(ac)
    try:
        dec._markers()
        if dec.frame is None or not dec.scans:
            raise ValueError("TIFF JPEG strip has no image (no frame, or no scan)")
        if dec.kind == "lossless":
            _refuse("lossless JPEG in a TIFF strip")
        planes = dec._planes()
    except _Truncated:
        raise ValueError("TIFF JPEG strip runs past its end") from None
    except (IndexError, KeyError, struct.error) as e:
        raise ValueError(f"TIFF JPEG strip is corrupt: {type(e).__name__}: {e}") from e
    sampling = [(c.h, c.v) for c in dec.comps]
    if ycbcr_to_rgb and len(planes) == 3:
        return _ycc_to_rgb(*planes), sampling
    return np.stack(planes, -1), sampling
