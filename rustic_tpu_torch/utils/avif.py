"""AVIF as Pillow 12.1.0 opens it (PIL/AvifImagePlugin.py over its
bundled libavif 1.3.0 with dav1d 1.5.1): key frames decoded, lossless and
lossy, with the in-loop filters (deblocking, CDEF, loop restoration); the
tools the decoder lacks refused by name.

Identification is Pillow's `_accept`: "ftyp" at bytes 4-8 and a major
brand "avif", "avis", "mif1" or "msf1". The header reader `open_avif`
ports the part of libavif's avifDecoderParse that Pillow's `_open` relies
on (Pillow clears AVIF_STRICT_PIXI_REQUIRED and AVIF_STRICT_CLAP_VALID):

- the top-level boxes read as libavif reads them from memory: ftyp first,
  whose brands must hold "avif" or "avis"; then "meta" where the brands
  hold "avif" and "moov" where they hold "avis", the walk ending once
  those are in (what follows, mdat included, is not read at the open);
- meta: hdlr ("pict") first, pitm, iloc (versions 0-2, construction
  methods 0 and 1, the second from idat), iinf/infe (versions 2 and 3),
  iref (auxl, cdsc, dimg, prem, thmb), iprp with ipco (ispe, pixi, av1C,
  colr nclx and ICC, auxC, irot, imir, clap, pasp, clli, a1op, lsel, a1lx;
  any other box an opaque property) and ipma (essential flags: an item
  with an unknown essential property is ignored);
- moov: trak with tkhd, tref, edts/elst, mdia/mdhd and minf/stbl
  (stsd's av01 sample entry and its properties, stts, stsc, stsz,
  stco/co64, stss), the samples laid out as libavif lays them;
- the source: a major brand "avis" reads the first AV1 track without an
  auxl reference (its sample count is `n_frames`), "avif" the primary
  item, another brand the tracks if there are any; the colour item (pitm,
  "av01" or "grid"; a grid's tiles from its dimg references, their count
  rows x columns) and the alpha auxiliary item (auxC alpha URN, auxl to
  the colour item; alpha premultiplied where the colour item's prem
  reference names it);
- each ispe, pixi, av1C and colr checked where libavif checks them.

libavif's results become what Pillow's `_avif.AvifDecoder` raises: invalid
ftyp, BMFF parse failed, truncated data and no content are SyntaxError,
which passes the file on (`NotThisFormat` through utils.read_header);
every other result is Pillow's RuntimeError, which ends the open
(ValueError here). The header reports what Pillow's `_open` reports: the
size, the mode ("RGBA" where there is alpha, else "RGB"), `n_frames`, and
the EXIF orientation that irot and imir give (convert("RGBA") does not
turn the image).

The decode reads the colour item's (or first sample's) AV1 payload and
the alpha item's: its OBUs (each OBU header, its size), the
sequence_header_obu (av1C's configOBUs, where there are any, held equal to
the payload's), and the key frame's uncompressed_header (frame and render
size, superres, intrabc, tile_info, quantisation with delta-q and
segmentation, loop filter, CDEF, loop restoration, tx_mode,
reduced_tx_set, film grain), checked to end where the tile group's data
begins; `CodedLossless` follows the AV1 specification. The tile data is
decoded by `decode_av1` (csrc/av1_intra.cpp, an AV1 intra tile decoder
held to dav1d 1.5.1's planes; a grid's tiles placed as libavif places
them): CodedLossless frames, and lossy frames (every transform size and
type, intra block copy with its residual, and the loop restoration units
of each superblock), then the in-loop filters of csrc/av1_filters.h in
the specification's order: deblocking at the frame's levels, sharpness
and intra ref delta, CDEF at its strengths per 64x64, and Wiener and
self-guided loop restoration. A frame the decoder does not take raises
NotImplementedError naming what it lacks (`tool_refusal`): superres
("AVIF AV1 tile data (lossy, superres)"), film grain, quantiser
matrices, segmentation in a lossy frame, delta q or lf, and samples of
other than 8 bits (nothing here writes them).

`yuv_to_rgba` is libavif's avifImageYUVToRGB as Pillow calls it (8-bit
RGB, or RGBA where there is alpha, chroma upsampling automatic): where
libavif takes libyuv 1909 (4:4:4, 4:2:2 and 4:2:0 under the BT.601,
BT.709 and BT.2020 matrices, full and limited range) its fixed-point
YuvPixel and its bilinear chroma rows (ScaleRowUp2_Linear and _Bilinear,
their edge columns and rows) are copied; 4:0:0 and the identity matrix go
through libavif's built-in float path; premultiplied alpha is divided
out by libyuv's ARGBUnattenuate table as its SIMD rows apply it.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO
from rustic_tpu_torch.utils.modes import check_pixels

FORMAT = "AVIF"
BRANDS = (b"avif", b"avis", b"mif1", b"msf1")  # AvifImagePlugin._accept's major brands
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")
SIZE_LIMIT = 16384 * 16384  # libavif's default imageSizeLimit and imageDimensionLimit
DIMENSION_LIMIT = 32768
IMAGE_COUNT_LIMIT = 12 * 3600 * 60

# the libavif results Pillow's _avif turns into SyntaxError (exc_type_for_avif_result)
_SYNTAX = ("invalid ftyp", "BMFF parse failed", "truncated data", "no content")


def accept(prefix: bytes) -> bool:
    return prefix[4:8] == b"ftyp" and prefix[8:12] in BRANDS


def _refuse(variant: str):
    raise NotImplementedError(f"AVIF {variant} is not decoded ({FORMATS_TODO})")


class _Result(Exception):
    """A libavif result other than OK, with what it was found on."""

    def __init__(self, result: str, why: str = ""):
        super().__init__(f"{result}: {why}" if why else result)
        self.result = result


def _check(ok, result: str = "BMFF parse failed", why: str = ""):
    if not ok:
        raise _Result(result, why)


class _Short(Exception):
    """A read past the end of an avifROStream: the caller's result."""


class _Stream:
    """libavif's avifROStream over data[start:end]: big-endian reads, bit
    reads most significant first (a byte read needs no bits pending)."""

    def __init__(self, data: bytes, start: int = 0, end: int = None):
        self.data, self.pos = data, start
        self.end = len(data) if end is None else end
        self.bits = 0  # bits of the byte at pos already read

    def left(self) -> int:
        return self.end - self.pos

    def read(self, n: int) -> bytes:
        if n < 0 or n > self.left():
            raise _Short()
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def skip(self, n: int):
        self.read(n)

    def u8(self) -> int:
        return self.read(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self.read(2))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.read(4))[0]

    def u64(self) -> int:
        return struct.unpack(">Q", self.read(8))[0]

    def ux8(self, size: int) -> int:  # avifROStreamReadUX8: 0, 4 or 8 bytes
        return {0: lambda: 0, 4: self.u32, 8: self.u64}[size]()

    def bitsu(self, n: int) -> int:
        v = 0
        for _ in range(n):
            if self.pos >= self.end:
                raise _Short()
            v = v << 1 | (self.data[self.pos] >> (7 - self.bits)) & 1
            self.bits += 1
            if self.bits == 8:
                self.bits, self.pos = 0, self.pos + 1
        return v

    def version_flags(self):
        head = self.u32()
        return head >> 24, head & 0xFFFFFF

    def version(self, want: int) -> int:  # avifROStreamReadAndEnforceVersion
        version, flags = self.version_flags()
        if version != want:
            raise _Short()
        return flags

    def string(self) -> bytes:  # avifROStreamReadString: up to a NUL inside the stream
        end = self.data.find(b"\0", self.pos, self.end)
        if end < 0:
            raise _Short()
        out = self.data[self.pos : end]
        self.pos = end + 1
        return out

    def box(self, top: bool = False):
        """avifROStreamReadBoxHeader(Partial) -> (type, content size or None
        for a size-0 box, which only a top-level box may be)."""
        start = self.pos
        size = self.u32()
        kind = self.read(4)
        if size == 1:
            size = self.u64()
        if kind == b"uuid":
            self.skip(16)
        used = self.pos - start
        if size == 0:
            if not top:
                raise _Short()
            return kind, None
        if size < used:
            raise _Short()
        size -= used
        if not top and size > self.left():
            raise _Short()
        return kind, size


def _parsed(parse):
    """Run one of libavif's AVIF_CHECK parsers: a short read (or a value
    it refuses) is a BMFF parse failure."""
    try:
        return parse()
    except _Short as e:
        raise _Result("BMFF parse failed") from e


class Item:
    """An avifDecoderItem."""

    def __init__(self, item_id: int):
        self.id = item_id
        self.type = b""
        self.content_type = b""
        self.extents = []  # (offset, size)
        self.size = 0
        self.idat = False
        self.props = []  # (type, parsed value) in association order
        self.ipma_seen = False
        self.unsupported_essential = False
        self.thumbnail_for = self.aux_for = self.desc_for = self.dimg_for = self.prem_by = 0
        self.dimg_idx = 0
        self.width = self.height = 0

    def prop(self, kind: bytes):
        return next((v for t, v in self.props if t == kind), None)


class Meta:
    def __init__(self):
        self.items = {}  # id -> Item, in creation order
        self.properties = []  # (type, parsed value or None for an opaque box)
        self.primary = 0
        self.idat = None

    def item(self, item_id: int) -> Item:
        _check(item_id != 0, why="item ID 0")
        if item_id not in self.items:
            self.items[item_id] = Item(item_id)
        return self.items[item_id]


# ---- item properties ---------------------------------------------------------------------

class Av1C(NamedTuple):
    profile: int
    level: int
    tier: int
    high_bitdepth: int
    twelve_bit: int
    monochrome: int
    subsampling_x: int
    subsampling_y: int
    chroma_sample_position: int
    config_obus: bytes

    @property
    def depth(self) -> int:
        return 12 if self.twelve_bit else 10 if self.high_bitdepth else 8


class Colr(NamedTuple):
    icc: tuple  # (offset in the file, size) or None
    nclx: tuple  # (primaries, transfer, matrix, full range) or None


def _av1c(s: _Stream) -> Av1C:
    _check(s.bitsu(1) == 1, why="av1C marker")
    _check(s.bitsu(7) == 1, why="av1C version")
    profile, level = s.bitsu(3), s.bitsu(5)
    tier, high, twelve, mono, ssx, ssy = (s.bitsu(1) for _ in range(6))
    csp = s.bitsu(2)
    s.bitsu(3)
    s.bitsu(1)
    s.bitsu(4)
    return Av1C(profile, level, tier, high, twelve, mono, ssx, ssy, csp, s.read(s.left()))


def _property(kind: bytes, s: _Stream):
    """One ipco box's content -> its parsed value (False where libavif's
    parser fails), or None for a box libavif keeps opaque."""
    def parse():
        if kind == b"ispe":
            s.version(0)
            return s.u32(), s.u32()
        if kind == b"auxC":
            s.version(0)
            return s.string()
        if kind == b"colr":
            colour = s.read(4)
            if colour in (b"rICC", b"prof"):
                return Colr((s.pos, s.left()), None)
            if colour == b"nclx":
                cp, tc, mc = s.u16(), s.u16(), s.u16()
                full = s.bitsu(1)
                _check(s.bitsu(7) == 0, why="colr nclx reserved bits")
                return Colr(None, (cp, tc, mc, full))
            return Colr(None, None)
        if kind == b"av1C":
            return _av1c(s)
        if kind == b"pasp":
            return s.u32(), s.u32()
        if kind == b"clap":
            return tuple(s.u32() for _ in range(8))
        if kind == b"irot":
            angle = s.u8()
            _check(not angle & 0xFC, why="irot reserved bits")
            return angle
        if kind == b"imir":
            axis = s.u8()
            _check(not axis & 0xFE, why="imir reserved bits")
            return axis
        if kind == b"pixi":  # 1-4 planes of one depth, or libavif has no support
            s.version(0)
            count = s.u8()
            if not 1 <= count <= 4:
                raise _Result("not implemented", f"pixi of {count} planes")
            depths = []
            for _ in range(count):
                depths.append(s.u8())
                if depths[-1] != depths[0]:
                    raise _Result("not implemented", "pixi planes of different depths")
            return tuple(depths)
        if kind == b"clli":
            return s.u16(), s.u16()
        if kind == b"a1op":
            index = s.u8()
            _check(index <= 31, why="a1op index")
            return index
        if kind == b"lsel":
            layer = s.u16()
            _check(layer == 0xFFFF or layer < 4, why="lsel layer")
            return layer
        if kind == b"a1lx":
            large = s.u8() & 1
            return tuple((s.u32() if large else s.u16()) for _ in range(3))
        return None

    return _parsed(parse)


# the properties that must be marked essential (AVIF 2.3.2.1.1, HEIF 6.5.11.1, MIAF 7.3.9)
_ESSENTIAL = (b"a1op", b"lsel", b"clap", b"irot", b"imir")
_SUPPORTED = (b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap", b"irot", b"imir", b"pixi",
              b"clli", b"a1op", b"lsel", b"a1lx")


def _ipco(data: bytes, start: int, end: int) -> list:
    """avifParseItemPropertyContainerBox -> [(type, value)] (an ICC
    profile's offset is the file's)."""
    s, out = _Stream(data, start, end), []
    while s.left() >= 1:
        kind, size = _parsed(s.box)
        body = _Stream(data, s.pos, s.pos + size)
        out.append((kind, _property(kind, body) if kind in _SUPPORTED else None))
        _parsed(lambda: s.skip(size))
    return out


def _ipma(meta: Meta, s: _Stream, seen: set):
    version, flags = _parsed(s.version_flags)
    _check((version, flags) not in seen, why="two ipma of one version and flags")
    seen.add((version, flags))
    count = _parsed(s.u32)
    prev = 0
    for _ in range(count):
        item_id = _parsed(s.u16 if version < 1 else s.u32)
        _check(item_id != 0, why="ipma item ID 0")
        _check(item_id > prev, why="ipma item IDs not increasing")
        prev = item_id
        item = meta.item(item_id)
        _check(not item.ipma_seen, why="a second ipma for one item")
        item.ipma_seen = True
        for _ in range(_parsed(s.u8)):
            essential = _parsed(lambda: s.bitsu(1))
            index = _parsed(lambda: s.bitsu(15 if flags & 1 else 7))
            if index == 0:  # no property, which may not be essential
                _check(not essential, why="an essential property index 0")
                continue
            _check(index - 1 < len(meta.properties), why="ipma property index")
            kind, value = meta.properties[index - 1]
            if kind in _SUPPORTED:
                _check(not (essential and kind == b"a1lx"), why="a1lx marked essential")
                _check(essential or kind not in _ESSENTIAL, why=f"{kind} not essential")
                item.props.append((kind, value))
            elif essential:
                item.unsupported_essential = True


def _iloc(meta: Meta, s: _Stream):
    version, _ = _parsed(s.version_flags)
    _check(version <= 2, why="iloc version")
    sizes = [_parsed(lambda: s.bitsu(4)) for _ in range(4)]
    offset_size, length_size, base_size, index_size = sizes
    if version == 0:
        index_size = 0
    for size in (offset_size, length_size, base_size, index_size):
        _check(size in (0, 4, 8), why="iloc field size")
    count = _parsed(s.u16 if version < 2 else s.u32)
    for _ in range(count):
        item = meta.item(_parsed(s.u16 if version < 2 else s.u32))
        _check(not item.extents, why="an item located twice")
        if version in (1, 2):  # 12 reserved bits, zero, then the construction method
            field = _parsed(s.u16)
            _check(field >> 4 == 0, why="iloc reserved bits")
            method = field & 0xF
            if method not in (0, 1):
                raise _Result("not implemented", "iloc construction method 2")
            item.idat = method == 1
        _parsed(s.u16)  # data_reference_index
        base = _parsed(lambda: s.ux8(base_size))
        for _ in range(_parsed(s.u16)):
            if index_size:
                _parsed(lambda: s.ux8(index_size))
            off = _parsed(lambda: s.ux8(offset_size))
            length = _parsed(lambda: s.ux8(length_size))
            _check(off <= 2**64 - 1 - base, why="iloc offset overflows")
            item.extents.append((base + off, length))
            item.size += length


def _iinf(meta: Meta, s: _Stream):
    version, _ = _parsed(s.version_flags)
    _check(version in (0, 1), why="iinf version")
    for _ in range(_parsed(s.u16 if version == 0 else s.u32)):
        kind, size = _parsed(s.box)
        _check(kind == b"infe", why="iinf holds a box other than infe")
        e = _Stream(s.data, s.pos, s.pos + size)
        v, _ = _parsed(e.version_flags)
        _check(v in (2, 3), why="infe version")
        item_id = _parsed(e.u16 if v == 2 else e.u32)
        _check(item_id != 0, why="infe item ID 0")
        _parsed(e.u16)
        item_type = _parsed(lambda: e.read(4))
        _parsed(e.string)  # item_name
        content = _parsed(e.string)[:63] if item_type == b"mime" else b""
        item = meta.item(item_id)
        item.type, item.content_type = item_type, content
        _parsed(lambda: s.skip(size))


def _iref(meta: Meta, s: _Stream):
    version, _ = _parsed(s.version_flags)
    while s.left() >= 1:
        kind, _ = _parsed(s.box)
        if version > 1:
            break
        read = s.u16 if version == 0 else s.u32
        from_id = _parsed(read)
        _check(from_id != 0, why="iref item ID 0")
        for index in range(_parsed(s.u16)):
            to_id = _parsed(read)
            _check(to_id != 0, why="iref item ID 0")
            item = meta.item(from_id)
            if kind == b"thmb":
                item.thumbnail_for = to_id
            elif kind == b"auxl":
                item.aux_for = to_id
            elif kind == b"cdsc":
                item.desc_for = to_id
            elif kind == b"dimg":
                tile = meta.item(to_id)
                _check(tile.dimg_for != from_id, "invalid image grid", "a tile twice in a grid")
                tile.dimg_for, tile.dimg_idx = from_id, index
            elif kind == b"prem":
                item.prem_by = to_id


def _meta(data: bytes, start: int, end: int) -> Meta:
    """avifParseMetaBox over data[start:end] (offsets stay the file's)."""
    meta, s = Meta(), _Stream(data, start, end)
    _parsed(lambda: s.version(0))
    first, seen, ipma_seen = True, set(), set()
    while s.left() >= 1:
        kind, size = _parsed(s.box)
        body = _Stream(data, s.pos, s.pos + size)
        if first:
            _check(kind == b"hdlr", why="meta's first box is not hdlr")
            _parsed(lambda: _hdlr(body))
            first = False
        elif kind in (b"pitm", b"idat", b"iloc", b"iprp", b"iinf", b"iref"):
            _check(kind not in seen, why=f"a second {kind}")
            seen.add(kind)
            if kind == b"pitm":
                v, _ = _parsed(body.version_flags)
                meta.primary = _parsed(body.u16 if v == 0 else body.u32)
            elif kind == b"idat":
                meta.idat = data[body.pos : body.end]
            elif kind == b"iloc":
                _iloc(meta, body)
            elif kind == b"iinf":
                _iinf(meta, body)
            elif kind == b"iref":
                _iref(meta, body)
            else:
                ckind, csize = _parsed(body.box)
                _check(ckind == b"ipco", why="iprp's first box is not ipco")
                meta.properties = _ipco(data, body.pos, body.pos + csize)
                _parsed(lambda: body.skip(csize))
                while body.left() >= 1:
                    akind, asize = _parsed(body.box)
                    _check(akind == b"ipma", why="iprp holds a box other than ipma")
                    _ipma(meta, _Stream(data, body.pos, body.pos + asize), ipma_seen)
                    _parsed(lambda: body.skip(asize))
        _parsed(lambda: s.skip(size))
    _check(not first, why="an empty meta box")
    return meta


def _hdlr(s: _Stream, handler: bytes = b"pict"):
    s.version(0)
    if s.u32() != 0 or s.read(4) != handler and handler is not None:
        raise _Short()
    for _ in range(3):
        s.u32()
    s.string()


# ---- tracks --------------------------------------------------------------------------------

class Track:
    def __init__(self):
        self.id = 0
        self.width = self.height = 0
        self.aux_for = self.prem_by = 0
        self.has_table = False
        self.chunks, self.sizes, self.to_chunk, self.entries = [], [], [], []
        self.all_size = 0
        self.meta = None
        self.duration = None  # tkhd's
        self.repeating = False  # an elst with flag 1


def _moov(data: bytes, start: int, end: int) -> list:
    s, tracks = _Stream(data, start, end), []
    while s.left() >= 1:
        kind, size = _parsed(s.box)
        if kind == b"trak":
            tracks.append(_trak(data, s.pos, s.pos + size))
        _parsed(lambda: s.skip(size))
    _check(tracks, why="moov holds no trak")
    return tracks


def _children(data: bytes, start: int, end: int):
    s = _Stream(data, start, end)
    while s.left() >= 1:
        kind, size = _parsed(s.box)
        yield kind, s.pos, s.pos + size
        _parsed(lambda: s.skip(size))


def _trak(data: bytes, start: int, end: int) -> Track:
    t, tkhd = Track(), False
    for kind, a, b in _children(data, start, end):
        if kind == b"tkhd":
            _parsed(lambda: _tkhd(t, _Stream(data, a, b)))
            tkhd = True
        elif kind == b"meta":
            t.meta = _meta(data, a, b)
        elif kind == b"mdia":
            for k2, a2, b2 in _children(data, a, b):
                if k2 == b"mdhd":
                    _parsed(lambda: _mdhd(_Stream(data, a2, b2)))
                elif k2 == b"hdlr":  # any handler type
                    _parsed(lambda: _hdlr(_Stream(data, a2, b2), None))
                elif k2 == b"minf":
                    for k3, a3, b3 in _children(data, a2, b2):
                        if k3 == b"stbl":
                            _check(not t.has_table, why="a second stbl")
                            t.has_table = True
                            _stbl(t, data, a3, b3)
        elif kind == b"tref":
            _parsed(lambda: _tref(t, _Stream(data, a, b)))
        elif kind == b"edts":
            t.repeating = _parsed(lambda: _edts(_Stream(data, a, b)))
    _check(tkhd, why="trak without tkhd")
    return t


def _tkhd(t: Track, s: _Stream):
    version, _ = s.version_flags()
    if version == 1:
        s.u64(), s.u64()
        track_id = s.u32()
        s.u32()
        t.duration = s.u64()
    elif version == 0:
        s.u32(), s.u32()
        track_id = s.u32()
        s.u32()
        t.duration = s.u32()
    else:
        raise _Result("BMFF parse failed", "tkhd version")
    s.skip(52)
    t.width, t.height = s.u32() >> 16, s.u32() >> 16
    _check(t.width and t.height, why="a track of size 0")
    _check(not _too_large(t.width, t.height), why="a track too large")
    t.id = track_id


def _mdhd(s: _Stream):
    version, _ = s.version_flags()
    if version == 1:
        s.u64(), s.u64(), s.u32(), s.u64()
    elif version == 0:
        s.u32(), s.u32(), s.u32(), s.u32()
    else:
        raise _Short()


def _tref(t: Track, s: _Stream):
    while s.left() >= 1:
        kind, size = s.box()
        if kind in (b"auxl", b"prem"):
            to_id = s.u32()
            s.skip(size - 4)
            if kind == b"auxl":
                t.aux_for = to_id
            else:
                t.prem_by = to_id
        else:
            s.skip(size)


def _edts(s: _Stream) -> bool:
    """avifParseEditBox -> whether the track repeats (elst's flag 1)."""
    seen = repeating = False
    while s.left() >= 1:
        kind, size = s.box()
        if kind == b"elst":
            if seen:
                raise _Short()
            e = _Stream(s.data, s.pos, s.pos + size)
            version, flags = e.version_flags()
            repeating = bool(flags & 1)
            if repeating:  # one entry, of a segment duration other than 0
                if e.u32() != 1 or version not in (0, 1):
                    raise _Short()
                if (e.u64() if version == 1 else e.u32()) == 0:
                    raise _Short()
            seen = True
        s.skip(size)
    if not seen:
        raise _Short()
    return repeating


def _stbl(t: Track, data: bytes, start: int, end: int):
    for kind, a, b in _children(data, start, end):
        s = _Stream(data, a, b)
        if kind in (b"stco", b"co64"):
            def chunks(s=s, big=kind == b"co64"):
                s.version(0)
                return [s.u64() if big else s.u32() for _ in range(s.u32())]
            t.chunks = _parsed(chunks)
        elif kind == b"stsc":
            def to_chunk(s=s):
                s.version(0)
                out = []
                for i in range(s.u32()):
                    first, per, _ = s.u32(), s.u32(), s.u32()
                    if (first != 1) if i == 0 else first <= out[-1][0]:
                        raise _Short()
                    out.append((first, per))
                return out
            t.to_chunk = _parsed(to_chunk)
        elif kind == b"stsz":
            def sizes(s=s):
                s.version(0)
                whole, count = s.u32(), s.u32()
                return whole, ([] if whole else [s.u32() for _ in range(count)])
            t.all_size, t.sizes = _parsed(sizes)
        elif kind in (b"stss", b"stts"):
            def table(s=s, n=1 if kind == b"stss" else 2):
                s.version(0)
                for _ in range(s.u32() * n):
                    s.u32()
            _parsed(table)
        elif kind == b"stsd":
            _parsed(lambda: s.version(0))
            for _ in range(_parsed(s.u32)):
                fmt, size = _parsed(s.box)
                props = []
                if fmt == b"av01":
                    _check(size >= 78, why="av01 sample entry too short")
                    props = _ipco(data, s.pos + 78, s.pos + size)
                t.entries.append((fmt, props))
                _parsed(lambda: s.skip(size))


def _samples(t: Track, file_size: int) -> list:
    """avifCodecDecodeInputFillFromSampleTable -> [(offset, size)]."""
    out, index = [], 0
    for chunk, offset in enumerate(t.chunks):
        count = next((per for first, per in reversed(t.to_chunk) if first <= chunk + 1), 0)
        _check(count, why="a chunk of no samples")
        for _ in range(count):
            size = t.all_size
            if not size:
                _check(index < len(t.sizes), why="a truncated sample table")
                size = t.sizes[index]
            _check(offset + size <= file_size, why="a sample past the end of the file")
            out.append((offset, size))
            offset += size
            index += 1
            if len(out) == IMAGE_COUNT_LIMIT:
                return out
    return out


# ---- the file ------------------------------------------------------------------------------

def _too_large(width: int, height: int) -> bool:
    return width > SIZE_LIMIT // height or width > DIMENSION_LIMIT or height > DIMENSION_LIMIT


def _brands(body: bytes):
    _check(len(body) >= 8 and (len(body) - 8) % 4 == 0, why="ftyp's size")
    brands = {body[:4]} | {body[i : i + 4] for i in range(8, len(body), 4)}
    _check(b"avif" in brands or b"avis" in brands, "invalid ftyp", "no avif or avis brand")
    return body[:4], brands


def _top_level(raw: bytes):
    """avifParse's walk of the top-level boxes -> (major brand, meta or
    None, tracks)."""
    pos, major, meta, tracks = 0, None, None, None
    needs_meta = needs_moov = needs_tmap = False
    while True:
        if pos > len(raw):
            raise _Result("truncated data", "a box past the end of the file")
        head = raw[pos : pos + 32]
        if not head:
            break
        s = _Stream(head)
        kind, size = _parsed(lambda: s.box(top=True))
        pos += s.pos
        wanted = kind in (b"ftyp", b"meta", b"moov")
        if size is None:  # to the end of the file
            size = len(raw) - pos
        elif wanted and pos + size > len(raw):
            raise _Result("truncated data", f"{kind} box cut short")
        start, pos = pos, pos + size
        if kind == b"ftyp":
            _check(major is None, why="a second ftyp")
            major, brands = _brands(raw[start:pos])
            needs_meta, needs_moov = b"avif" in brands, b"avis" in brands
            needs_tmap = b"tmap" in brands
        elif kind == b"meta":
            _check(meta is None, why="a second meta")
            meta = _meta(raw, start, pos)
        elif kind == b"moov":
            _check(tracks is None, why="a second moov")
            tracks = _moov(raw, start, pos)
        tmap = meta is not None and any(i.type == b"tmap" for i in meta.items.values())
        if major is not None and (not needs_meta or meta) and (not needs_moov or tracks) and (
                not needs_tmap or tmap):
            return major, meta, tracks
    _check(major is not None, "invalid ftyp", "no ftyp box")
    raise _Result("truncated data", "meta, moov or a tmap item missing")


def _item_data(raw: bytes, meta: Meta, item: Item) -> bytes:
    return _payload(raw, meta.idat, (item.idat, tuple(item.extents)))


class Avif(NamedTuple):
    width: int
    height: int
    mode: str  # "RGB" or "RGBA"
    n_frames: int
    orientation: int  # the EXIF orientation of irot and imir
    colour: tuple  # the colour payloads, each (from idat, ((offset, size), ...)): one, or a
    alpha: tuple  # grid's tiles; the same for alpha, or ()
    grid: tuple  # (rows, columns, output width, output height) or None
    av1c: Av1C
    alpha_av1c: Av1C
    nclx: tuple  # colr's (primaries, transfer, matrix, full range), or None
    icc: bool
    premultiplied: bool
    depth: int
    idat: bytes  # the meta box's idat, which payloads of construction method 1 read
    exif: bytes  # the Exif libavif hands Pillow, or None


def _orientation(irot, imir) -> int:
    """Pillow's irot_imir_to_exif_orientation: irot's angle (anticlockwise
    quarter turns) and imir's axis, each None where the item has none."""
    if irot in (1, 2, 3):
        if imir is None:
            return {1: 8, 2: 3, 3: 6}[irot]
        return {1: (5, 7), 2: (2, 4), 3: (7, 5)}[irot][imir]
    if imir is not None:
        return 4 if imir == 0 else 2
    return 1


def open_avif(raw: bytes) -> Avif:
    """Pillow's AvifImageFile._open (avifDecoderParse) -> Avif; libavif's
    results raise SyntaxError (the file passes on) or ValueError (the open
    ends) as Pillow's _avif raises SyntaxError or RuntimeError."""
    raw = bytes(raw)
    if not accept(raw[:16]):
        raise SyntaxError("not an AVIF file")
    try:
        h = _open(raw)
    except _Result as e:
        if e.result in _SYNTAX:
            raise SyntaxError(f"AVIF: {e} (libavif)") from e
        raised = "ValueError" if e.result == "invalid Exif payload" else "RuntimeError"
        raise ValueError(f"AVIF: {e} (libavif; Pillow raises {raised})") from e
    _pillow_exif(h.exif)
    check_pixels(h.width, h.height, "AVIF image")
    return h


def _open(raw: bytes) -> Avif:
    major, meta, tracks = _top_level(raw)
    if meta is not None:  # avifDecoderParse: each image item's ispe harvested
        for item in meta.items.values():
            if not item.size or item.unsupported_essential or item.type not in (b"av01", b"grid"):
                continue
            ispe = item.prop(b"ispe")
            if ispe is not None:
                item.width, item.height = ispe
                _check(item.width and item.height, why="an item of size 0")
                _check(not _too_large(item.width, item.height), why="an item too large")
            else:
                aux = item.prop(b"auxC")
                _check(aux is not None and aux in ALPHA_URNS, why="an item without ispe")
                _check(False, why="an alpha item without ispe (strict)")
    if major == b"avis" or major != b"avif" and tracks:
        return _from_tracks(raw, tracks)
    return _from_items(raw, meta or Meta())


def _from_tracks(raw: bytes, tracks) -> Avif:
    tracks = tracks or []

    def usable(t):
        return t.has_table and t.id and t.chunks and any(f == b"av01" for f, _ in t.entries)

    colour = next((t for t in tracks if usable(t) and not t.aux_for), None)
    _check(colour is not None, "no content", "no AV1 colour track")
    props = next(p for f, p in colour.entries if f == b"av01")
    exif = None
    if colour.meta is not None:
        exif = _metadata(raw, colour.meta, None)
    alpha = next((t for t in tracks if usable(t) and t.aux_for == colour.id), None)
    samples = _samples(colour, len(raw))
    _check(not (colour.repeating and colour.duration == 0), why="a repeating track of no duration")
    alpha_samples = _samples(alpha, len(raw)) if alpha else []
    for _, size in samples + alpha_samples:
        _check(size, why="a sample of no data")
    props_alpha = next(p for f, p in alpha.entries if f == b"av01") if alpha else []
    return _finish(raw, None, props, colour.width, colour.height, len(samples),
                   [(False, (samples[0],))] if samples else [],
                   [(False, (alpha_samples[0],))] if alpha_samples else [], None,
                   dict(props_alpha).get(b"av1C"),
                   alpha is not None and colour.prem_by == alpha.id, exif)


def _usable(item: Item) -> bool:
    return bool(item.size) and not item.unsupported_essential and item.type in (b"av01", b"grid")


def _from_items(raw: bytes, meta: Meta) -> Avif:
    colour = next((i for i in meta.items.values() if _usable(i) and not i.thumbnail_for
                   and i.id == meta.primary), None)
    _check(colour is not None, "missing image item", "no primary image item")
    if colour.type == b"grid":
        colour_grid = _grid(raw, meta, colour)
    exif = _metadata(raw, meta, colour)
    alpha = next((i for i in meta.items.values() if _usable(i) and i.prop(b"auxC") in ALPHA_URNS
                  and i.aux_for == colour.id), None)
    alpha_grid = _grid(raw, meta, alpha) if alpha is not None and alpha.type == b"grid" else None
    extents, grid = [], None
    for item, cat in ((colour, "colour"), (alpha, "alpha")):
        if item is None:
            continue
        if item.type == b"grid":
            tiles, g = colour_grid if cat == "colour" else alpha_grid
            payloads = [(t.idat, tuple(t.extents)) for t in tiles]
            _tile_config(item, tiles)
            if cat == "colour":
                grid = g
        else:
            _check(item.size <= len(raw), why="an item larger than the file")
            payloads = [(item.idat, tuple(item.extents))]
        _validate(item)
        extents.append(payloads)
    premultiplied = alpha is not None and colour.prem_by == alpha.id
    return _finish(raw, meta, colour.props, colour.width, colour.height, 1, extents[0],
                   extents[1] if alpha is not None else [], grid,
                   alpha.prop(b"av1C") if alpha is not None else None, premultiplied, exif)


def _grid(raw: bytes, meta: Meta, item: Item):
    """avifDecoderItemReadAndParse and avifDecoderGenerateImageTiles of a
    grid item -> (its tile items in dimg order, (rows, columns, width,
    height))."""
    data = _item_data(raw, meta, item)
    try:
        s = _Stream(data)
        _check(s.u8() == 0, "invalid image grid", "grid version")
        flags, rows, cols = s.u8(), s.u8() + 1, s.u8() + 1
        width, height = (s.u32(), s.u32()) if flags & 1 else (s.u16(), s.u16())
        ok = width and height and not _too_large(width, height) and s.left() == 0
    except _Short:
        ok = False
    _check(ok, "invalid image grid", "grid box")
    tiles = [i for i in meta.items.values() if i.dimg_for == item.id]
    _check(len(tiles) == rows * cols, "invalid image grid", "tile count")
    by_index = {}
    for t in tiles:
        _check(t.dimg_idx < rows * cols, "invalid image grid", "tile index")
        by_index[t.dimg_idx] = t
    ordered = [by_index[i] for i in range(rows * cols) if i in by_index]
    _check(len(ordered) == rows * cols, "invalid image grid", "tile indices")
    for t in ordered:
        _check(t.type == b"av01", "invalid image grid", "a tile that is not AV1")
        _check(t.size <= len(raw), why="a tile larger than the file")
    return ordered, (rows, cols, width, height)


def _tile_config(item: Item, tiles):
    """The grid item takes its first tile's av1C; every tile must have the
    same."""
    first = tiles[0].prop(b"av1C")
    _check(first is not None, "invalid image grid", "a tile without av1C")
    for t in tiles[1:]:
        _check(t.prop(b"av1C") == first, "invalid image grid", "tiles of different av1C")
    if item.prop(b"av1C") is None:
        item.props.append((b"av1C", first))


def _validate(item: Item):
    """avifDecoderItemValidateProperties (pixi not required)."""
    config = item.prop(b"av1C")
    _check(config is not None, why="an item without av1C")
    _check(item.prop(b"ispe") is not None, why="an item without ispe")
    pixi = item.prop(b"pixi")
    if item.type == b"av01" and pixi is not None:
        _check(all(d == config.depth for d in pixi), why="pixi's depth differs from av1C's")


def _metadata(raw: bytes, meta: Meta, colour: Item):
    """avifDecoderFindMetadata: each Exif item describing the colour item
    (any, in a track's meta: `colour` None) must hold a TIFF header where
    its offset field says; XMP is read -> the last Exif item's payload
    after its offset field (the image's Exif, which Pillow loads), or
    None."""
    exif = None
    for item in meta.items.values():
        if not item.size or item.unsupported_essential or (
                colour is not None and item.desc_for != colour.id):
            continue
        if item.type == b"Exif":
            data = _item_data(raw, meta, item)
            _check(len(data) >= 4, "invalid Exif payload", "Exif item")
            (offset,) = struct.unpack(">I", data[:4])
            found = [i for i in (data.find(b"II*\0", 4), data.find(b"MM\0*", 4)) if i >= 0]
            _check(found and min(found) - 4 == offset, "invalid Exif payload", "TIFF header")
            exif = data[4:]
        elif item.type == b"mime" and item.content_type == b"application/rdf+xml":
            _item_data(raw, meta, item)
    return exif


_TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a")


def _pillow_exif(exif: bytes):
    """Image.Exif.load of the Exif libavif hands Pillow's _open: "Exif\\0\\0"
    prefixes dropped, then a TIFF header of 8 bytes (else SyntaxError or
    struct.error, which pass the file on; the directory's own faults only
    warn)."""
    while exif and exif.startswith(b"Exif\x00\x00"):
        exif = exif[6:]
    if exif and (exif[:4] not in _TIFF_PREFIXES or len(exif) < 8):
        raise SyntaxError("AVIF Exif that is not a TIFF file (Pillow's Exif.load)")


def _finish(raw, meta, props, width, height, n_frames, colour, alpha, grid, alpha_av1c,
            premultiplied, exif) -> Avif:
    """avifDecoderReset's common end: every sample has data; the colour
    properties (the first ICC and the first nclx colr; an ICC profile read);
    the transformations; the av1C; the CICP of the sequence header read
    where there is no nclx."""
    _check(colour, why="no colour payload")
    for _, extents in colour + alpha:
        _check(sum(size for _, size in extents), why="a sample of no data")
    colrs = [v for k, v in props if k == b"colr"]
    _check(sum(c.icc is not None for c in colrs) <= 1 and sum(c.nclx is not None for c in colrs)
           <= 1, why="two colr of one kind")
    icc = next((c.icc for c in colrs if c.icc), None)
    nclx = next((c.nclx for c in colrs if c.nclx), None)
    if icc is not None:
        _check(icc[0] + icc[1] <= len(raw), "truncated data", "ICC profile")
    first = dict(reversed(props))  # the first property of each kind
    av1c = first.get(b"av1C")
    _check(av1c is not None, why="no av1C")
    if nclx is None:
        _harvest_cicp(raw, meta, colour[0])
    return Avif(width, height, "RGBA" if alpha else "RGB", n_frames,
                _orientation(first.get(b"irot"), first.get(b"imir")), tuple(colour),
                tuple(alpha), grid, av1c, alpha_av1c, nclx, icc is not None, premultiplied,
                av1c.depth, meta.idat if meta else None, exif)


def _payload(raw: bytes, idat, payload, limit: int = None) -> bytes:
    """avifDecoderItemRead of one payload (from idat, its extents): the
    extents joined, the first `limit` bytes where given; an extent cut
    short by the file's end raises truncated data."""
    in_idat, extents = payload
    out = bytearray()
    want = sum(size for _, size in extents) if limit is None else limit
    for off, size in extents:
        if len(out) >= want:
            break
        size = min(size, want - len(out))
        if in_idat:
            _check(idat is not None and off + size <= len(idat), why="idat too small")
            out += idat[off : off + size]
            continue
        if off > len(raw):
            raise _Result("truncated data", "a payload past the end of the file")
        got = raw[off : off + size]
        _check(len(got) == size, "truncated data", "a payload cut short")
        out += got
    return bytes(out)


def _harvest_cicp(raw: bytes, meta, payload):
    """avifDecoderReset's search of the first sample for a sequence header
    (64 bytes more at a time, up to 4 KiB) where no colr gives the CICP:
    each read of the sample must be whole."""
    total, size = sum(n for _, n in payload[1]), 0
    while True:
        size = min(size + 64, total)
        data = _payload(raw, meta.idat if meta else None, payload, size)
        if sequence_header(data) is not None or size == total or size >= 4096:
            return


# ---- AV1: OBUs, the sequence header, the key frame's uncompressed header ------------------

class _Bits:
    """The AV1 specification's f(n), su(n), ns(n), uvlc() and leb128()."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.bit = data, 8 * pos

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.bit >> 3
            if byte >= len(self.data):
                raise ValueError("AVIF AV1 header runs past its OBU (dav1d refuses it)")
            v = v << 1 | (self.data[byte] >> (7 - (self.bit & 7))) & 1
            self.bit += 1
        return v

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v >> (n - 1) else v

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        return v if v < m else (v << 1) - m + self.f(1)

    def uvlc(self) -> int:
        zeros = 0
        while not self.f(1):
            zeros += 1
            if zeros >= 32:
                return (1 << 32) - 1
        return self.f(zeros) + (1 << zeros) - 1

    def leb128(self) -> int:
        v = 0
        for i in range(8):
            byte = self.f(8)
            v |= (byte & 0x7F) << (7 * i)
            if not byte & 0x80:
                break
        return v


def obus(data: bytes) -> list:
    """An AV1 payload's OBUs -> [(type, temporal id, spatial id, start,
    end)] of each OBU's payload; an OBU header that breaks the rules or a
    size past the data raises ValueError."""
    return list(_obus(data))


def _obus(data: bytes):
    pos = 0
    while pos < len(data):
        b = _Bits(data, pos)
        forbidden, kind, ext, has_size = b.f(1), b.f(4), b.f(1), b.f(1)
        b.f(1)
        tid = sid = 0
        if ext:
            tid, sid = b.f(3), b.f(2)
            b.f(3)
        if forbidden:
            raise ValueError("AVIF AV1 OBU with its forbidden bit set")
        size = b.leb128() if has_size else len(data) - (b.bit >> 3)
        start = b.bit >> 3
        if start + size > len(data):
            raise ValueError("AVIF AV1 OBU runs past its payload")
        yield kind, tid, sid, start, start + size
        pos = start + size


OBU_SEQUENCE_HEADER, OBU_FRAME_HEADER, OBU_TILE_GROUP, OBU_FRAME = 1, 3, 4, 6


def sequence_header(data: bytes):
    """The first sequence_header_obu of an AV1 payload, as a dict, or None
    where there is none or it does not parse (libavif's search)."""
    try:
        for kind, _, _, start, end in _obus(data):  # no further than the sequence header
            if kind == OBU_SEQUENCE_HEADER:
                return _sequence_header(_Bits(data[:end], start))
    except ValueError:
        return None
    return None


def _sequence_header(b: _Bits) -> dict:
    sh = dict(profile=b.f(3), still_picture=b.f(1), reduced=b.f(1))
    sh.update(timing=0, decoder_model=0, equal_interval=0, op_idc=[0], op_decoder_model=[0])
    if sh["reduced"]:
        sh["level"] = [b.f(5)]
    else:
        sh["timing"] = b.f(1)
        if sh["timing"]:
            b.f(32), b.f(32)
            sh["equal_interval"] = b.f(1)
            if sh["equal_interval"]:
                b.uvlc()
            sh["decoder_model"] = b.f(1)
            if sh["decoder_model"]:
                sh["buffer_delay_length"] = b.f(5) + 1
                b.f(32)
                sh["removal_time_length"] = b.f(5) + 1
                sh["presentation_time_length"] = b.f(5) + 1
        display_delay = b.f(1)
        count = b.f(5) + 1
        sh["op_idc"], sh["level"], sh["op_decoder_model"] = [], [], []
        for _ in range(count):
            sh["op_idc"].append(b.f(12))
            sh["level"].append(b.f(5))
            if sh["level"][-1] > 7:
                b.f(1)
            present = b.f(1) if sh["decoder_model"] else 0
            sh["op_decoder_model"].append(present)
            if present:
                b.f(sh["buffer_delay_length"]), b.f(sh["buffer_delay_length"]), b.f(1)
            if display_delay and b.f(1):
                b.f(4)
    wbits, hbits = b.f(4) + 1, b.f(4) + 1
    sh["width_bits"], sh["height_bits"] = wbits, hbits
    sh["max_width"], sh["max_height"] = b.f(wbits) + 1, b.f(hbits) + 1
    sh["frame_ids"] = 0 if sh["reduced"] else b.f(1)
    if sh["frame_ids"]:
        sh["delta_frame_id_length"] = b.f(4) + 2
        sh["frame_id_length"] = b.f(3) + 1 + sh["delta_frame_id_length"]
    sh["sb128"], sh["filter_intra"], sh["intra_edge"] = b.f(1), b.f(1), b.f(1)
    sh.update(order_hint_bits=0, screen_content=2, integer_mv=2)
    if not sh["reduced"]:
        b.f(1), b.f(1), b.f(1), b.f(1)  # interintra, masked compound, warped motion, dual filter
        order_hint = b.f(1)
        if order_hint:
            b.f(1), b.f(1)  # jnt_comp, ref_frame_mvs
        sh["screen_content"] = 2 if b.f(1) else b.f(1)
        sh["integer_mv"] = (2 if b.f(1) else b.f(1)) if sh["screen_content"] > 0 else 2
        sh["order_hint_bits"] = b.f(3) + 1 if order_hint else 0
    sh["superres"], sh["cdef"], sh["restoration"] = b.f(1), b.f(1), b.f(1)
    high = b.f(1)
    depth = (12 if b.f(1) else 10) if sh["profile"] == 2 and high else 10 if high else 8
    mono = 0 if sh["profile"] == 1 else b.f(1)
    cp = tc = mc = 2
    if b.f(1):
        cp, tc, mc = b.f(8), b.f(8), b.f(8)
    sh.update(depth=depth, mono=mono, primaries=cp, transfer=tc, matrix=mc, separate_uv_dq=0)
    if mono:
        sh.update(full_range=b.f(1), ssx=1, ssy=1, csp=0)
    elif cp == 1 and tc == 13 and mc == 0:
        sh.update(full_range=1, ssx=0, ssy=0, csp=0)
    else:
        sh["full_range"] = b.f(1)
        if sh["profile"] == 0:
            ssx = ssy = 1
        elif sh["profile"] == 1:
            ssx = ssy = 0
        elif depth == 12:
            ssx = b.f(1)
            ssy = b.f(1) if ssx else 0
        else:
            ssx, ssy = 1, 0
        sh.update(ssx=ssx, ssy=ssy, csp=b.f(2) if ssx and ssy else 0)
    if not mono:
        sh["separate_uv_dq"] = b.f(1)
    sh["film_grain"] = b.f(1)
    sh["end_bit"] = b.bit
    return sh


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def frame_header(b: _Bits, sh: dict, tid: int = 0, sid: int = 0) -> dict:
    """uncompressed_header() of a key frame (the first frame a decoder
    meets) -> a dict; an inter frame or a shown existing frame raises."""
    fh = {}
    if sh["reduced"]:
        frame_type, show_frame, showable, error_resilient = 0, 1, 0, 1
    else:
        if b.f(1):
            raise ValueError("AVIF AV1 payload shows an existing frame first (dav1d: no frame)")
        frame_type = b.f(2)
        show_frame = b.f(1)
        if show_frame and sh["decoder_model"] and not sh["equal_interval"]:
            b.f(sh["presentation_time_length"])
        showable = frame_type != 0 if show_frame else b.f(1)
        error_resilient = 1 if frame_type == 3 or frame_type == 0 and show_frame else b.f(1)
    if frame_type != 0:
        raise ValueError(f"AVIF AV1 payload whose first frame is of type {frame_type}, not a key "
                         "frame (dav1d refuses it)")
    fh.update(frame_type=frame_type, show_frame=show_frame, showable=showable)
    fh["disable_cdf_update"] = disable_cdf_update = b.f(1)
    screen = b.f(1) if sh["screen_content"] == 2 else sh["screen_content"]
    if screen and sh["integer_mv"] == 2:
        b.f(1)
    fh["screen_content_tools"] = screen
    if sh["frame_ids"]:
        b.f(sh["frame_id_length"])
    size_override = 0 if sh["reduced"] else b.f(1)
    b.f(sh["order_hint_bits"])
    if sh["decoder_model"] and b.f(1):  # buffer_removal_time_present_flag
        for op, idc in enumerate(sh["op_idc"]):
            if sh["op_decoder_model"][op] and (
                    idc == 0 or (idc >> tid) & 1 and (idc >> (sid + 8)) & 1):
                b.f(sh["removal_time_length"])
    if not (frame_type == 0 and show_frame):
        refresh = b.f(8)
        if refresh != 0xFF and error_resilient and sh["order_hint_bits"]:
            for _ in range(8):
                b.f(sh["order_hint_bits"])
    # frame_size, superres_params, render_size
    if size_override:
        width, height = b.f(sh["width_bits"]) + 1, b.f(sh["height_bits"]) + 1
    else:
        width, height = sh["max_width"], sh["max_height"]
    denom = 8
    if sh["superres"] and b.f(1):
        denom = b.f(3) + 9
    upscaled = width
    width = (upscaled * 8 + denom // 2) // denom
    fh.update(upscaled_width=upscaled, frame_width=width, frame_height=height, superres=denom)
    if b.f(1):
        fh["render_width"], fh["render_height"] = b.f(16) + 1, b.f(16) + 1
    else:
        fh["render_width"], fh["render_height"] = upscaled, height
    fh["intrabc"] = b.f(1) if screen and upscaled == width else 0
    if not (sh["reduced"] or disable_cdf_update):
        b.f(1)  # disable_frame_end_update_cdf
    mi_cols, mi_rows = 2 * ((width + 7) >> 3), 2 * ((height + 7) >> 3)
    fh["tiles"], fh["tile_starts"] = _tile_info(b, sh, mi_cols, mi_rows)
    planes = 1 if sh["mono"] else 3
    q = fh["quant"] = dict(base=b.f(8))

    def delta():
        return b.su(7) if b.f(1) else 0

    q["y_dc"] = delta()
    q["u_dc"] = q["u_ac"] = q["v_dc"] = q["v_ac"] = 0
    if planes > 1:
        diff = b.f(1) if sh["separate_uv_dq"] else 0
        q["u_dc"], q["u_ac"] = delta(), delta()
        q["v_dc"], q["v_ac"] = (delta(), delta()) if diff else (q["u_dc"], q["u_ac"])
    q["qmatrix"] = b.f(1)
    if q["qmatrix"]:
        q["qm_y"], q["qm_u"] = b.f(4), b.f(4)
        q["qm_v"] = b.f(4) if sh["separate_uv_dq"] else q["qm_u"]
    seg = fh["segmentation"] = _segmentation(b)
    fh["delta_q"] = b.f(1) if q["base"] > 0 else 0
    fh["delta_q_res"] = b.f(2) if fh["delta_q"] else 0
    fh["delta_lf"] = b.f(1) if fh["delta_q"] and not fh["intrabc"] else 0
    if fh["delta_lf"]:
        fh["delta_lf_res"], fh["delta_lf_multi"] = b.f(2), b.f(1)
    lossless = []
    for sid_ in range(8):
        qindex = q["base"]
        if seg["enabled"] and seg["features"][sid_][0] is not None:
            qindex = min(255, max(0, q["base"] + seg["features"][sid_][0]))
        lossless.append(qindex == 0 and not any(q[k] for k in ("y_dc", "u_ac", "u_dc", "v_ac",
                                                                  "v_dc")))
    fh["coded_lossless"] = coded = all(lossless)
    fh["all_lossless"] = coded and width == upscaled
    fh["loop_filter"] = _loop_filter(b, planes, coded or fh["intrabc"])
    cdef = fh["cdef"] = dict(bits=0, damping=3, strengths=[])
    if not (coded or fh["intrabc"] or not sh["cdef"]):
        cdef["damping"], cdef["bits"] = b.f(2) + 3, b.f(2)
        for _ in range(1 << cdef["bits"]):
            y = (b.f(4), b.f(2))
            uv = (b.f(4), b.f(2)) if planes > 1 else (0, 0)
            cdef["strengths"].append((y, uv))
    fh["restoration"] = _restoration(b, sh, planes, fh["all_lossless"] or fh["intrabc"])
    fh["tx_mode"] = "ONLY_4X4" if coded else "TX_MODE_SELECT" if b.f(1) else "TX_MODE_LARGEST"
    fh["reduced_tx_set"] = b.f(1)
    fh["film_grain"] = _film_grain(b, sh, show_frame or showable)
    return fh


def _tile_info(b: _Bits, sh: dict, mi_cols: int, mi_rows: int):
    """tile_info() -> (the fields of the record, (MiColStarts, MiRowStarts))."""
    shift = 5 if sh["sb128"] else 4
    sb_cols, sb_rows = (mi_cols + (1 << shift) - 1) >> shift, (mi_rows + (1 << shift) - 1) >> shift
    sb_size = shift + 2
    max_width_sb, max_area_sb = 4096 >> sb_size, (4096 * 2304) >> (2 * sb_size)
    min_cols = _tile_log2(max_width_sb, sb_cols)
    max_cols, max_rows = _tile_log2(1, min(sb_cols, 64)), _tile_log2(1, min(sb_rows, 64))
    min_tiles = max(min_cols, _tile_log2(max_area_sb, sb_rows * sb_cols))
    if b.f(1):  # uniform_tile_spacing_flag
        cols_log2 = min_cols
        while cols_log2 < max_cols and b.f(1):
            cols_log2 += 1
        width_sb = (sb_cols + (1 << cols_log2) - 1) >> cols_log2
        col_starts = list(range(0, sb_cols, width_sb))
        rows_log2 = max(min_tiles - cols_log2, 0)
        while rows_log2 < max_rows and b.f(1):
            rows_log2 += 1
        height_sb = (sb_rows + (1 << rows_log2) - 1) >> rows_log2
        row_starts = list(range(0, sb_rows, height_sb))
    else:
        widest = start = 0
        col_starts = []
        while start < sb_cols:
            size = b.ns(min(sb_cols - start, max_width_sb)) + 1
            col_starts.append(start)
            widest, start = max(size, widest), start + size
        cols_log2 = _tile_log2(1, len(col_starts))
        area = (sb_rows * sb_cols) >> (min_tiles + 1) if min_tiles > 0 else sb_rows * sb_cols
        max_height_sb = max(area // widest, 1)
        start = 0
        row_starts = []
        while start < sb_rows:
            row_starts.append(start)
            start += b.ns(min(sb_rows - start, max_height_sb)) + 1
        rows_log2 = _tile_log2(1, len(row_starts))
    cols, rows = len(col_starts), len(row_starts)
    size_bytes = 4
    if cols_log2 or rows_log2:
        b.f(rows_log2 + cols_log2)  # context_update_tile_id
        size_bytes = b.f(2) + 1
    starts = ([min(c << shift, mi_cols) for c in col_starts] + [mi_cols],
              [min(r << shift, mi_rows) for r in row_starts] + [mi_rows])
    return dict(cols=cols, rows=rows, cols_log2=cols_log2, rows_log2=rows_log2,
                size_bytes=size_bytes), starts


_SEG_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
_SEG_MAX = (255, 63, 63, 63, 63, 7, 0, 0)


def _segmentation(b: _Bits) -> dict:
    seg = dict(enabled=b.f(1), features=[[None] * 8 for _ in range(8)])
    if seg["enabled"]:  # a key frame: update_map and update_data without their bits
        for i in range(8):
            for j in range(8):
                if b.f(1):
                    if j < 5:
                        v = max(-_SEG_MAX[j], min(_SEG_MAX[j], b.su(1 + _SEG_BITS[j])))
                    else:
                        v = min(_SEG_MAX[j], b.f(_SEG_BITS[j]))
                    seg["features"][i][j] = v
    return seg


# setup_past_independence's loop_filter_ref_deltas (INTRA_FRAME, LAST_FRAME ... ALTREF_FRAME)
# and loop_filter_mode_deltas, which a key frame's updates start from
_REF_DELTAS = (1, 0, 0, 0, -1, 0, -1, -1)
_MODE_DELTAS = (0, 0)


def _loop_filter(b: _Bits, planes: int, off: bool) -> dict:
    """loop_filter_params(): the four levels, the sharpness, and where
    loop_filter_delta_enabled the ref and mode deltas (the defaults with
    any update applied; None where deltas are off)."""
    lf = dict(levels=[0, 0, 0, 0], sharpness=0, delta_enabled=0, delta_update=0, ref_deltas=None,
              mode_deltas=None)
    if off:
        return lf
    lf["levels"][0], lf["levels"][1] = b.f(6), b.f(6)
    if planes > 1 and (lf["levels"][0] or lf["levels"][1]):
        lf["levels"][2], lf["levels"][3] = b.f(6), b.f(6)
    lf["sharpness"] = b.f(3)
    lf["delta_enabled"] = b.f(1)
    if lf["delta_enabled"]:
        lf["ref_deltas"], lf["mode_deltas"] = list(_REF_DELTAS), list(_MODE_DELTAS)
        lf["delta_update"] = b.f(1)
        if lf["delta_update"]:
            for deltas in (lf["ref_deltas"], lf["mode_deltas"]):
                for i in range(len(deltas)):
                    if b.f(1):  # update_ref_delta, update_mode_delta
                        deltas[i] = b.su(7)
    return lf


def _restoration(b: _Bits, sh: dict, planes: int, off: bool) -> dict:
    lr = dict(types=["NONE"] * planes, unit_shift=0, uv_shift=0)
    if off or not sh["restoration"]:
        return lr
    lr["types"] = [("NONE", "SWITCHABLE", "WIENER", "SGRPROJ")[b.f(2)] for _ in range(planes)]
    if any(t != "NONE" for t in lr["types"]):
        shift = b.f(1)
        if sh["sb128"]:
            shift += 1
        elif shift:
            shift += b.f(1)
        lr["unit_shift"] = shift
        chroma = any(t != "NONE" for t in lr["types"][1:])
        lr["uv_shift"] = b.f(1) if sh["ssx"] and sh["ssy"] and chroma else 0
    return lr


def _film_grain(b: _Bits, sh: dict, shown: bool):
    if not sh["film_grain"] or not shown or not b.f(1):
        return None
    fg = dict(seed=b.f(16))
    y = [(b.f(8), b.f(8)) for _ in range(b.f(4))]
    from_luma = 0 if sh["mono"] else b.f(1)
    cb = cr = []
    if not (sh["mono"] or from_luma or sh["ssx"] and sh["ssy"] and not y):
        cb = [(b.f(8), b.f(8)) for _ in range(b.f(4))]
        cr = [(b.f(8), b.f(8)) for _ in range(b.f(4))]
    fg.update(y=y, cb=cb, cr=cr, from_luma=from_luma, scaling_shift=b.f(2) + 8)
    lag = b.f(2)
    luma = 2 * lag * (lag + 1)
    chroma = luma + 1 if y else luma
    if y:
        [b.f(8) for _ in range(luma)]
    if from_luma or cb:
        [b.f(8) for _ in range(chroma)]
    if from_luma or cr:
        [b.f(8) for _ in range(chroma)]
    fg.update(lag=lag, ar_shift=b.f(2) + 6, grain_scale_shift=b.f(2))
    if cb:
        b.f(8), b.f(8), b.f(9)
    if cr:
        b.f(8), b.f(8), b.f(9)
    fg.update(overlap=b.f(1), clip=b.f(1))
    return fg


def parse_av1(data: bytes, config_obus: bytes = b"") -> dict:
    """An AV1 payload -> {"sequence": its sequence header, "frame": the
    first frame's uncompressed header, "tile_data": (start, end) of the
    tile group that follows, "tile_groups": (start, end) of it and of each
    tile group OBU after it}. The sequence header of av1C's configOBUs,
    where there are any, must equal the payload's; the frame header must
    end (after its trailing or alignment bits) where the tile group
    starts."""
    seq = frame = tile = None
    groups = []
    for kind, tid, sid, start, end in obus(data):
        if kind == OBU_SEQUENCE_HEADER:
            seq = _sequence_header(_Bits(data[:end], start))
            seq_bytes = data[start:end]
        elif kind in (OBU_FRAME_HEADER, OBU_FRAME) and frame is None:
            if seq is None:
                raise ValueError("AVIF AV1 frame before any sequence header (dav1d refuses it)")
            b = _Bits(data[:end], start)
            frame = frame_header(b, seq, tid, sid)
            header_end = (b.bit + 7) >> 3
            if kind == OBU_FRAME:
                if any(b.f(1) for _ in range(-b.bit % 8)):
                    raise ValueError("AVIF AV1 frame header's alignment bits are not zero")
                tile = (header_end, end)
                groups.append(tile)
            else:
                if b.f(1) != 1 or any(b.f(1) for _ in range(8 * end - b.bit)):
                    raise ValueError("AVIF AV1 frame header OBU's trailing bits are wrong")
                tile = None
        elif kind == OBU_TILE_GROUP and frame is not None:
            tile = tile or (start, end)
            groups.append((start, end))
    if frame is None or tile is None:
        raise ValueError("AVIF AV1 payload without a frame (dav1d: no picture)")
    if config_obus:
        config = sequence_header_obu(config_obus)
        if config is not None and config != seq_bytes:
            raise ValueError("AVIF av1C's sequence header differs from the payload's")
    if frame["tiles"]["cols"] * frame["tiles"]["rows"] > 1 and tile[1] <= tile[0]:
        raise ValueError("AVIF AV1 tile group of no data")
    return dict(sequence=seq, frame=frame, tile_data=tile, tile_groups=groups)


def sequence_header_obu(data: bytes):
    """The payload bytes of the first sequence header OBU in `data`."""
    try:
        return next((data[s:e] for k, _, _, s, e in obus(data) if k == OBU_SEQUENCE_HEADER), None)
    except ValueError:
        return None


def headers(raw: bytes, h: Avif = None) -> dict:
    """The AV1 headers of an AVIF's colour payloads and alpha payloads
    (each one's `parse_av1`), read as Pillow's load reads the payloads."""
    raw = bytes(raw)
    h = h or open_avif(raw)
    out = {}
    for name, payloads, config in (("colour", h.colour, h.av1c), ("alpha", h.alpha, h.alpha_av1c)):
        out[name] = [parse_av1(_payload(raw, h.idat, p), config.config_obus if config else b"")
                     for p in payloads]
    return out


def colour_description(raw: bytes, h: Avif = None) -> tuple:
    """(full range, matrix coefficients, colour primaries) the colour stage
    takes: the colr nclx, else the colour payload's sequence header."""
    h = h or open_avif(raw)
    if h.nclx is not None:
        return h.nclx[3], h.nclx[2], h.nclx[0]
    seq = sequence_header(_payload(bytes(raw), h.idat, h.colour[0]))
    return seq["full_range"], seq["matrix"], seq["primaries"]


def _check_grid(h: Avif, tiles: list):
    """avifDecoderDataFillImageGrid's checks of the decoded tiles (dav1d's
    frame size, upscaled): they cover the output and no row or column lies
    wholly outside it; tiles at least 64 square (MIAF), widths (and, at
    4:2:0, heights) even with the output's where the chroma is halved."""
    rows, cols, width, height = h.grid
    seq, fh = tiles[0]["sequence"], tiles[0]["frame"]
    tw, th = fh["upscaled_width"], fh["frame_height"]
    ok = (tw * cols >= width and th * rows >= height and tw * (cols - 1) < width
          and th * (rows - 1) < height and tw >= 64 and th >= 64)
    if not seq["mono"] and seq["ssx"] and (width % 2 or tw % 2):
        ok = False
    if not seq["mono"] and seq["ssy"] and (height % 2 or th % 2):
        ok = False
    for t in tiles[1:]:
        s2, f2 = t["sequence"], t["frame"]
        if (f2["upscaled_width"], f2["frame_height"]) != (tw, th) or any(
                s2[k] != seq[k] for k in ("depth", "mono", "ssx", "ssy")):
            ok = False
    if not ok:
        raise ValueError("AVIF grid whose tiles do not make its image (libavif at Pillow's "
                         "load: invalid image grid)")


def header_record(raw: bytes) -> dict:
    """The parsed AV1 headers' fields a decoder of the tile data needs, of
    the first colour and (where there is one) alpha payload: what the
    fixtures' manifest records, and chip_smoke.py holds each file to."""
    parsed = headers(raw)
    out = {}
    for name in ("colour", "alpha"):
        if not parsed[name]:
            continue
        seq, fh = parsed[name][0]["sequence"], parsed[name][0]["frame"]
        out[name] = dict(
            sequence={k: seq[k] for k in ("profile", "still_picture", "reduced", "max_width",
                                          "max_height", "sb128", "filter_intra", "intra_edge",
                                          "superres", "cdef", "restoration", "depth", "mono",
                                          "primaries", "transfer", "matrix", "full_range",
                                          "ssx", "ssy", "csp", "separate_uv_dq", "film_grain")},
            frame=dict(size=[fh["frame_width"], fh["frame_height"]],
                       render=[fh["render_width"], fh["render_height"]],
                       upscaled_width=fh["upscaled_width"], superres=fh["superres"],
                       intrabc=fh["intrabc"], tiles=fh["tiles"], quant=fh["quant"],
                       segmentation=fh["segmentation"]["enabled"],
                       delta=dict(q=[fh["delta_q"], fh["delta_q_res"]],
                                  lf=[fh["delta_lf"], fh.get("delta_lf_res", 0),
                                      fh.get("delta_lf_multi", 0)]),
                       loop_filter=fh["loop_filter"]["levels"],
                       sharpness=fh["loop_filter"]["sharpness"],
                       cdef=dict(bits=fh["cdef"]["bits"], damping=fh["cdef"]["damping"],
                                 strengths=[[*y, *uv] for y, uv in fh["cdef"]["strengths"]])
                       if fh["cdef"]["strengths"] else None,
                       restoration=fh["restoration"]["types"], tx_mode=fh["tx_mode"],
                       reduced_tx_set=fh["reduced_tx_set"],
                       film_grain=fh["film_grain"] is not None,
                       coded_lossless=fh["coded_lossless"]),
            tile_data=list(parsed[name][0]["tile_data"]), payloads=len(parsed[name]))
    return out


def decode_avif(raw: bytes, h: Avif = None) -> np.ndarray:
    """AVIF bytes (or their `open_avif` header) -> uint8 [H, W, 4], Pillow's
    convert("RGBA"): the payloads read, their AV1 headers parsed, each
    frame's tile data decoded and filtered (`decode_av1`, lossless or lossy,
    deblocked, CDEF'd and restored; a grid's tiles placed as libavif places
    them), then `yuv_to_rgba` with the container's colour description. A
    frame the decoder does not take (`tool_refusal`: superres, film grain,
    quantiser matrices, ...) raises NotImplementedError naming it before
    any tile data is read."""
    raw = bytes(raw)
    h = h or open_avif(raw)
    try:
        parsed = headers(raw, h)
    except _Result as e:
        raise ValueError(f"AVIF: {e} (libavif, at Pillow's load)") from e
    if h.grid is not None:
        _check_grid(h, parsed["colour"])
    frames = parsed["colour"] + parsed["alpha"]
    if h.depth != 8 or any(f["sequence"]["depth"] != 8 for f in frames):
        _refuse(f"{h.depth}-bit samples")
    for f in frames:
        refusal = tool_refusal(f["frame"])
        if refusal:
            _refuse(refusal)
    payloads = {name: [_payload(raw, h.idat, p) for p in getattr(h, name)]
                for name in ("colour", "alpha")}
    colour = _placed(h, [decode_av1(d, p)[0] for d, p in zip(payloads["colour"],
                                                              parsed["colour"])],
                     parsed["colour"][0]["sequence"])
    alpha = None
    if payloads["alpha"]:
        alpha = _placed(h, [decode_av1(d, p)[0] for d, p in zip(payloads["alpha"],
                                                                parsed["alpha"])],
                        parsed["alpha"][0]["sequence"])["y"]
    full, matrix, primaries = colour_description(raw, h)
    return yuv_to_rgba(colour["y"], colour.get("u"), colour.get("v"), alpha,
                       full_range=bool(full), matrix=matrix, primaries=primaries,
                       premultiplied=h.premultiplied)


def _placed(h: Avif, tiles: list, seq: dict) -> dict:
    """The decoded planes of the payload, or a grid's tiles placed row by
    row into the output size and cropped to it (libavif's
    avifDecoderDataFillImageGrid)."""
    if h.grid is None:
        return tiles[0]
    rows, cols, width, height = h.grid
    th, tw = tiles[0]["y"].shape
    out = {}
    for name in tiles[0]:
        sx, sy = (seq["ssx"], seq["ssy"]) if name != "y" else (0, 0)
        canvas = np.zeros(((height + sy) >> sy, (width + sx) >> sx), np.uint8)
        for k, t in enumerate(tiles):
            r, c = divmod(k, cols)
            y0, x0 = (r * th) >> sy, (c * tw) >> sx
            part = t[name][: canvas.shape[0] - y0, : canvas.shape[1] - x0]
            canvas[y0 : y0 + part.shape[0], x0 : x0 + part.shape[1]] = part
        out[name] = canvas
    return out


def tool_refusal(fh: dict):
    """The name a frame header's refusal gives, or None where the tile
    decoder takes the frame: no superres or film grain after the in-loop
    filters (deblocking, CDEF and loop restoration are decoded), and its
    quantisers the frame's own (no quantiser matrix, segmentation of a
    lossy frame, delta q or lf)."""
    lossy = "lossless" if fh["coded_lossless"] else "lossy"
    if fh["frame_width"] != fh["upscaled_width"]:
        return f"AV1 tile data ({lossy}, superres)"
    if fh["film_grain"] is not None:
        return f"AV1 tile data ({lossy}, film grain)"
    if fh["quant"]["qmatrix"]:
        return f"AV1 tile data ({lossy}, quantiser matrices)"
    if fh["segmentation"]["enabled"] and not fh["coded_lossless"]:
        return "AV1 tile data (lossy, segmentation)"
    if fh["delta_q"]:
        return f"AV1 tile data ({lossy}, delta q/lf)"
    return None


# csrc/av1_intra.cpp's counters: name -> slot (the y and uv modes: 13 and 14 slots, the
# transform sizes TX_4X4 ... TX_64X16 and types DCT_DCT ... H_FLIPADST: 19 and 16), then
# csrc/av1_filters.h's: edges of 4 samples deblocked on luma with 4, 8 and 14 taps and on
# chroma with 4 and 6, 8x8 blocks CDEF filtered (luma; chroma, each plane's), 64x64 blocks
# CDEF skips (cdef_idx -1), and restoration units: Wiener, self-guided, and of those the
# ones whose Sgr_Params set has r0 = 0 and r1 = 0
AV1_COUNTERS = {"y modes": slice(0, 13), "angle delta": 13, "upsampled edge": 14,
                "filter intra": 15, "cfl": 16, "palette y": 17, "palette uv": 18, "intrabc": 19,
                "tiles": 20, "edge filter": 21, "blocks": 22, "padding": 23,
                "uv modes": slice(24, 38), "tx sizes": slice(38, 57),
                "tx types": slice(57, 73), "tx depth": 73, "txfm split": 74,
                "intrabc residual": 75, "corner filter": 76, "deblock luma": slice(77, 80),
                "deblock chroma": slice(80, 82), "cdef luma": 82, "cdef chroma": 83,
                "cdef skipped": 84, "lr wiener": 85, "lr sgrproj": 86, "lr sgr r0 0": 87,
                "lr sgr r1 0": 88}
TX_SIZE_NAMES = ["4x4", "8x8", "16x16", "32x32", "64x64", "4x8", "8x4", "8x16", "16x8", "16x32",
                 "32x16", "32x64", "64x32", "4x16", "16x4", "8x32", "32x8", "16x64", "64x16"]
TX_TYPE_NAMES = ["DCT_DCT", "ADST_DCT", "DCT_ADST", "ADST_ADST", "FLIPADST_DCT", "DCT_FLIPADST",
                 "FLIPADST_FLIPADST", "ADST_FLIPADST", "FLIPADST_ADST", "IDTX", "V_DCT", "H_DCT",
                 "V_ADST", "H_ADST", "V_FLIPADST", "H_FLIPADST"]


def _tiles(data: bytes, parsed: dict) -> list:
    """tile_group_obu() of the frame's tile groups -> per tile (offset,
    size, MiRowStart, MiRowEnd, MiColStart, MiColEnd) in `data`."""
    fh = parsed["frame"]
    t = fh["tiles"]
    col_starts, row_starts = fh["tile_starts"]
    n = t["cols"] * t["rows"]
    out = []
    for start, end in parsed["tile_groups"]:
        b = _Bits(data[:end], start)
        first, last = 0, n - 1
        if n > 1 and b.f(1):  # tile_start_and_end_present_flag
            bits = t["cols_log2"] + t["rows_log2"]
            first, last = b.f(bits), b.f(bits)
        if first != len(out) or not first <= last < n:
            raise ValueError("AVIF AV1 tile group out of order (dav1d refuses it)")
        pos = (b.bit + 7) >> 3
        for tile in range(first, last + 1):
            if tile == last:
                size = end - pos
            else:
                k = t["size_bytes"]
                size = int.from_bytes(data[pos : pos + k], "little") + 1
                pos += k
                if pos + size > end:
                    raise ValueError("AVIF AV1 tile larger than its tile group (dav1d refuses "
                                     "it)")
            row, col = divmod(tile, t["cols"])
            out.append((pos, size, row_starts[row], row_starts[row + 1], col_starts[col],
                        col_starts[col + 1]))
            pos += size
        if last == n - 1:
            return out
    raise ValueError("AVIF AV1 frame whose tile groups end before its last tile (dav1d: no "
                     "picture)")


_LR_TYPES = ("NONE", "WIENER", "SGRPROJ", "SWITCHABLE")  # csrc/av1_filters.h's RESTORE_*


def _filter_params(fh: dict) -> list:
    """The in-loop filters' part of decode_av1's params: the four loop
    filter levels, sharpness, delta_enabled and the INTRA_FRAME ref delta
    (a key frame's blocks take no other), CdefDamping and the 8 x 4 CDEF
    strengths (y primary, y secondary, uv primary, uv secondary), the
    three FrameRestorationTypes, lr_unit_shift and lr_uv_shift."""
    lf, cdef, lr = fh["loop_filter"], fh["cdef"], fh["restoration"]
    strengths = [[*y, *uv] for y, uv in cdef["strengths"]]
    strengths += [[0, 0, 0, 0]] * (8 - len(strengths))
    types = [_LR_TYPES.index(t) for t in lr["types"]] + [0] * (3 - len(lr["types"]))
    return [*lf["levels"], lf["sharpness"], lf["delta_enabled"],
            lf["ref_deltas"][0] if lf["delta_enabled"] else 0, cdef["damping"],
            *sum(strengths, []), *types, lr["unit_shift"], lr["uv_shift"]]


def decode_av1(data: bytes, parsed: dict = None) -> tuple:
    """One AV1 payload's first frame -> ({"y", and "u", "v" unless 4:0:0:
    uint8 planes of the frame's size}, {counter: count of the blocks,
    transform blocks, filtered edges and blocks, or restoration units that
    took each tool}) through csrc/av1_intra.cpp: a CodedLossless frame, or
    a lossy one of any tx_mode, its tile data decoded (loop restoration's
    syntax with it) and then deblocked, CDEF'd and restored as its header
    says (`_filter_params`). Another frame raises NotImplementedError by
    name (`tool_refusal`); corrupt tile data raises ValueError."""
    from rustic_tpu_torch.utils._entropy import av1_library, ptr

    parsed = parsed or parse_av1(data)
    seq, fh = parsed["sequence"], parsed["frame"]
    refusal = tool_refusal(fh)
    if refusal:
        _refuse(refusal)
    seg = fh["segmentation"]
    features = seg["features"] if seg["enabled"] else [[None] * 8] * 8
    active = [i for i in range(8) if any(v is not None for v in features[i])]
    q = fh["quant"]
    params = np.array([
        fh["frame_width"], fh["frame_height"], seq["mono"], seq["ssx"], seq["ssy"],
        seq["sb128"], seq["filter_intra"], seq["intra_edge"], fh["screen_content_tools"],
        fh["intrabc"], fh["disable_cdf_update"], q["base"], seg["enabled"],
        any(f[j] is not None for f in features for j in range(5, 8)), max(active, default=0),
        sum(1 << i for i in range(8) if features[i][6] is not None), fh["coded_lossless"],
        ("ONLY_4X4", "TX_MODE_LARGEST", "TX_MODE_SELECT").index(fh["tx_mode"]),
        fh["reduced_tx_set"], seq["cdef"], fh["cdef"]["bits"], q["y_dc"], q["u_dc"], q["u_ac"],
        q["v_dc"], q["v_ac"], *_filter_params(fh)], np.int32)
    tiles = np.array(_tiles(data, parsed), np.int64)
    width, height = fh["frame_width"], fh["frame_height"]
    planes = dict(y=np.zeros((height, width), np.uint8))
    if not seq["mono"]:
        cw, ch = (width + seq["ssx"]) >> seq["ssx"], (height + seq["ssy"]) >> seq["ssy"]
        planes["u"] = np.zeros((ch, cw), np.uint8)
        planes["v"] = np.zeros((ch, cw), np.uint8)
    lib = av1_library()
    counters = np.zeros(lib.av1_counter_count(), np.int64)
    error = ctypes.create_string_buffer(256)
    buf = np.frombuffer(bytes(data), np.uint8)
    rc = lib.av1_decode_tiles(ptr(buf), len(buf), ptr(params), ptr(tiles), len(tiles),
                              ptr(planes["y"]), ptr(planes.get("u")), ptr(planes.get("v")),
                              ptr(counters), error, len(error))
    if rc:
        raise ValueError(f"AVIF {error.value.decode()} (dav1d refuses it)")
    return planes, {k: counters[v].tolist() for k, v in AV1_COUNTERS.items()}


# ---- libavif's YUV -> RGB ------------------------------------------------------------------

# libyuv 1909's YuvConstants (row_common.c): (YG, YB, UB, UG, VG, VR)
_LIBYUV = {"I601": (18997, -1160, 128, 25, 52, 102), "JPEG": (16320, 32, 113, 22, 46, 90),
           "H709": (18997, -1160, 128, 14, 34, 115), "F709": (16320, 32, 119, 12, 30, 101),
           "2020": (19003, -1160, 128, 12, 42, 107), "V2020": (16320, 32, 120, 11, 37, 94)}
_MATRIX = {1: "709", 2: "601", 5: "601", 6: "601", 9: "2020"}  # libavif's choice by matrix
_BY_PRIMARIES = {1: "709", 5: "601", 6: "601", 9: "2020"}  # chroma-derived (12) by primaries
_CONSTANTS = {("601", True): "JPEG", ("601", False): "I601", ("709", True): "F709",
              ("709", False): "H709", ("2020", True): "V2020", ("2020", False): "2020"}
# libyuv's fixed_invtbl8: 8.8 fixed-point 1 / a, 0 for a of 0 and 1.0 for 255
_INVERSE = np.array([0, 0xFFFF] + [0x10000 // a for a in range(2, 255)] + [0x100], np.int64)


def _up_linear(c: np.ndarray, width: int) -> np.ndarray:
    """libyuv's ScaleRowUp2_Linear_Any over rows of chroma [n, ceil(w/2)]
    -> [n, width]: the first and last columns copied, the pairs between
    (3a + b + 2) >> 2 and (a + 3b + 2) >> 2."""
    c = c.astype(np.int64)
    out = np.empty((c.shape[0], width), np.int64)
    out[:, 0] = c[:, 0]
    pairs = ((width - 1) & ~1) // 2
    if pairs:
        a, b = c[:, :pairs], c[:, 1 : pairs + 1]
        out[:, 1 : 2 * pairs : 2] = (3 * a + b + 2) >> 2
        out[:, 2 : 2 * pairs + 1 : 2] = (a + 3 * b + 2) >> 2
    out[:, width - 1] = c[:, (width - 1) // 2]
    return out


def _up_bilinear(s: np.ndarray, t: np.ndarray, width: int):
    """libyuv's ScaleRowUp2_Bilinear_Any of chroma rows s over t (each
    [n, ceil(w/2)]) -> the two luma rows between them, [n, width] each."""
    s, t = s.astype(np.int64), t.astype(np.int64)
    n = s.shape[0]
    da, db = np.empty((n, width), np.int64), np.empty((n, width), np.int64)
    da[:, 0], db[:, 0] = (3 * s[:, 0] + t[:, 0] + 2) >> 2, (s[:, 0] + 3 * t[:, 0] + 2) >> 2
    pairs = ((width - 1) & ~1) // 2
    if pairs:
        s0, s1, t0, t1 = s[:, :pairs], s[:, 1 : pairs + 1], t[:, :pairs], t[:, 1 : pairs + 1]
        da[:, 1 : 2 * pairs : 2] = (9 * s0 + 3 * s1 + 3 * t0 + t1 + 8) >> 4
        da[:, 2 : 2 * pairs + 1 : 2] = (3 * s0 + 9 * s1 + t0 + 3 * t1 + 8) >> 4
        db[:, 1 : 2 * pairs : 2] = (3 * s0 + s1 + 9 * t0 + 3 * t1 + 8) >> 4
        db[:, 2 : 2 * pairs + 1 : 2] = (s0 + 3 * s1 + 3 * t0 + 9 * t1 + 8) >> 4
    k = (width - 1) // 2
    da[:, width - 1] = (3 * s[:, k] + t[:, k] + 2) >> 2
    db[:, width - 1] = (s[:, k] + 3 * t[:, k] + 2) >> 2
    return da, db


def _chroma_420(c: np.ndarray, width: int, height: int) -> np.ndarray:
    """libyuv's I420ToARGBMatrixBilinear chroma: the first luma row from
    chroma row 0 (linear), each pair after from two chroma rows
    (bilinear), the last row of an even height from the last chroma row."""
    out = np.empty((height, width), np.int64)
    out[0] = _up_linear(c[:1], width)[0]
    pairs = (height - 1) // 2
    if pairs:
        da, db = _up_bilinear(c[:pairs], c[1 : pairs + 1], width)
        out[1 : 2 * pairs : 2], out[2 : 2 * pairs + 1 : 2] = da, db
    if not height & 1:
        out[height - 1] = _up_linear(c[pairs : pairs + 1], width)[0]
    return out


def _libyuv_pixels(y, u, v, constants) -> np.ndarray:
    """libyuv's YuvPixel (x86): Y scaled by YG in 16.16 from y * 0x0101,
    biased by YB; U and V less 128 times UB, UG, VG, VR; >> 6, clamped."""
    yg, yb, ub, ug, vg, vr = constants
    y1 = ((y.astype(np.int64) * 0x0101 * yg) >> 16) + yb
    ui, vi = u.astype(np.int64) - 128, v.astype(np.int64) - 128
    rgb = np.stack([(y1 + vi * vr) >> 6, (y1 - (ui * ug + vi * vg)) >> 6, (y1 + ui * ub) >> 6], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _unorm(plane, full_range: bool):
    """libavif's unormFloatTableY: (v - bias) / range in float32."""
    bias, span = (0, 255) if full_range else (16, 219)
    return (plane.astype(np.float32) - np.float32(bias)) / np.float32(span)


def _to_u8(x) -> np.ndarray:  # (uint8_t)(0.5f + clamp(x, 0, 1) * 255.0f)
    clamped = np.clip(x, np.float32(0), np.float32(1)).astype(np.float32)
    return (np.float32(0.5) + clamped * np.float32(255)).astype(np.uint8)


def colour_route(y_shape, u_shape, alpha: bool, matrix: int = 6, primaries: int = 1) -> tuple:
    """Which of libavif 1.3.0's paths (with libyuv 1909) converts 8-bit
    planes: Y of `y_shape`, U and V of `u_shape` (None at 4:0:0), with or
    without alpha, of these matrix coefficients and colour primaries ->
    (the path's name, libyuv's matrix kind or None): "built-in mono",
    "libyuv I400", "built-in identity", "libyuv I444", "libyuv I422
    linear" or "libyuv I420 bilinear". A matrix libavif would take to its
    built-in path, and the identity matrix on subsampled chroma, which
    libavif refuses, are refused by name."""
    kind = _MATRIX.get(matrix) if matrix != 12 else _BY_PRIMARIES.get(primaries)
    if u_shape is None:
        return ("libyuv I400", kind) if alpha and kind else ("built-in mono", None)
    if matrix == 0:
        if tuple(u_shape) != tuple(y_shape):
            _refuse("identity matrix with subsampled chroma (libavif refuses it)")
        return "built-in identity", None
    if kind is None:
        _refuse(f"matrix coefficients {matrix} (libavif's built-in path)")
    if tuple(u_shape) == tuple(y_shape):
        return "libyuv I444", kind
    return ("libyuv I422 linear" if u_shape[0] == y_shape[0] else "libyuv I420 bilinear"), kind


def yuv_to_rgba(y: np.ndarray, u: np.ndarray = None, v: np.ndarray = None,
                alpha: np.ndarray = None, *, full_range: bool, matrix: int = 6,
                primaries: int = 1, premultiplied: bool = False) -> np.ndarray:
    """8-bit planes -> uint8 [H, W, 4], as Pillow's _avif decoder has
    libavif's avifImageYUVToRGB produce it: Y [H, W]; U and V [H, W]
    (4:4:4), [H, ceil(W/2)] (4:2:2), [ceil(H/2), ceil(W/2)] (4:2:0) or
    None (4:0:0); alpha [H, W] or None (alpha 255); the range and the
    matrix and colour primaries (CICP) the image carries; premultiplied
    alpha divided out."""
    height, width = y.shape
    out = np.full((height, width, 4), 255, np.uint8)
    path, kind = colour_route(y.shape, None if u is None else u.shape, alpha is not None,
                              matrix, primaries)
    constants = _LIBYUV[_CONSTANTS[(kind, bool(full_range))]] if kind else None
    if path == "built-in mono":  # R = G = B = Y
        out[..., :3] = _to_u8(_unorm(y, full_range))[..., None]
    elif path == "libyuv I400":  # 4:0:0 to RGBA: libyuv's I400ToARGBMatrix
        grey = np.full_like(y, 128)
        out[..., :3] = _libyuv_pixels(y, grey, grey, constants)
    elif path == "built-in identity":
        if full_range:  # avifImageIdentity8ToRGB8ColorFullRange
            out[..., 0], out[..., 1], out[..., 2] = v, y, u
        else:
            for i, plane in enumerate((v, y, u)):
                out[..., i] = _to_u8(_unorm(plane, False))
    else:
        if path == "libyuv I444":
            cu, cv = u, v
        elif path == "libyuv I422 linear":
            cu, cv = _up_linear(u, width), _up_linear(v, width)
        else:
            cu, cv = _chroma_420(u, width, height), _chroma_420(v, width, height)
        out[..., :3] = _libyuv_pixels(y, cu, cv, constants)
    if alpha is not None:
        out[..., 3] = alpha
        if premultiplied:  # libyuv's ARGBUnattenuate: (c * 0x0101 * (1/a in 8.8)) >> 16
            inverse = _INVERSE[alpha.astype(np.int64)][..., None]
            word = (out[..., :3].astype(np.int64) * 0x0101 * inverse) >> 16
            # packed to bytes with signed saturation: a word of 0x8000 or more (a colour of
            # 128 or more over an alpha of 1, which valid premultiplied data never has) is 0
            out[..., :3] = np.where(word >= 0x8000, 0, np.minimum(word, 255))
    return out
