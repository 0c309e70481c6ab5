"""A JPEG 2000 decoder for scene textures and LDR skyboxes: JP2 files and
raw codestreams (ISO/IEC 15444-1) as Pillow 12.1.0 reads them through
OpenJPEG 2.5.4.

The JAX package opens these files with Pillow, whose plugin picks the
mode from the JP2 `ihdr` box (or the codestream's SIZ): L, or I;16 above
8 bits, LA, RGB or RGBA by the number of components, P or PA where a
`pclr` box gives a palette of at most 8-bit entries (its colours kept in
the order of first appearance, duplicates merged, as `ImagePalette.
getcolor` does). Pillow then decodes tile by tile through OpenJPEG's tile
API, so the `pclr`, `cmap` and `cdef` boxes never reach the samples: a
palette image's samples are its indices and the components keep their
codestream order. Each sample becomes 8 bits as Jpeg2KDecode.c's unpackers
make it: a signed component is offset by half its range, a precision p
below 8 is shifted left by 8 - p, above 8 shifted right with the half of
the last kept bit added first (the sum wraps to 8 bits: 4095 at 12 bits
becomes 0), all in unsigned 32-bit arithmetic on the sample cut to
(p + 7) // 8 bytes (3 read as 4). I;16 is made the same way at 16 bits,
and Pillow's `convert("RGBA")` clips it to 255. `decode_jpeg2000` gives
what `np.asarray(Image.open(f).convert("RGBA"))` gives, uint8 [H, W, 4].

The decoding follows OpenJPEG's:
- boxes `jP  `, `ftyp`, `jp2h` (`ihdr`, `colr`, `pclr`; `cmap` and `cdef`
  skipped), `jp2c`; markers SOC, SIZ, COD, COC, QCD, QCC, COM, TLM, PLM, PLT, SOT,
  SOD, EOC, with SOP and EPH skipped; tile-parts joined per tile; image
  and tile offsets;
- tier-2: packets in LRCP, RLCP, RPCL, PCRL or CPRL order, positions
  stepped as OpenJPEG's pi.c steps them; the inclusion and zero-bit-plane
  tag trees, pass counts, `Lblock` and segment lengths; quality layers
  adding to each code-block's one segment;
- tier-1 (EBCOT, csrc/jpeg2000_t1.cpp, host C++ built by g++ at first
  use): each coefficient with one bit more than its last decoded plane,
  the mid-point of what is left open;
- dequantisation: reversible, the extra bit dropped (C division by 2);
  irreversible, times half of the float32 step (1 + mant / 2048) *
  2 ** (precision - exponent) of a scalar derived or expounded QCD/QCC
  (OpenJPEG leaves out the band gain for the 9/7 and scales the high
  band by its 1.625732422 in place of 2 / K);
- the inverse 5/3 (integer lifting) and 9/7 (float32 lifting: K and
  1.625732422, then -delta, -gamma, -beta, -alpha, each a separate
  multiply and add) wavelets, rows then columns, with symmetric extension
  and the parity of each resolution's origin; a 5/3 resolution one sample
  wide starting on an odd coordinate is halved (C division), a 9/7 one
  left as it is;
- the inverse RCT or the float32 ICT, the DC level shift and the clamp
  (the 9/7 rounded half to even first), per tile.

Variants no writer here produces are refused with NotImplementedError
naming them and FORMATS_TODO, before any packet is read: a code-block
style other than 0, the HT block coder (CAP marker), RGN, POC, PPM and
PPT, component subsampling, more than four components, precisions
Pillow does not read, colour spaces other than sRGB and greyscale.
"""

from __future__ import annotations

import struct

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO, _entropy
from rustic_tpu_torch.utils._entropy import ptr
from rustic_tpu_torch.utils.modes import note_core

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
_CBLK_STYLES = ((0x01, "code-block bypass"), (0x02, "code-block context reset"),
                (0x04, "code-block termination on each pass"),
                (0x08, "code-block vertically causal context"),
                (0x10, "code-block predictable termination"),
                (0x20, "code-block segmentation symbols"), (0x40, "HT block coder"))
_REFUSED_MARKERS = {0xFF50: "HT block coder", 0xFF5E: "RGN", 0xFF5F: "POC", 0xFF60: "PPM",
                    0xFF61: "PPT", 0xFF74: "multiple component transformation",
                    0xFF75: "multiple component transformation",
                    0xFF77: "multiple component transformation"}
# OpenJPEG's JP2 colour spaces: enumerated colour space -> name
_COLOUR_SPACES = {16: "sRGB", 17: "greyscale", 18: "sYCC", 24: "e-sYCC", 12: "CMYK"}
_MAX_PRECISION = 31  # OpenJPEG reads at most 31 bits a sample
# the 9/7 synthesis constants, as OpenJPEG 2.5 keeps them
_K = np.float32(1.230174105)
_TWO_INV_K = np.float32(1.625732422)
_LIFT_97 = (np.float32(-0.443506852), np.float32(-0.882911075), np.float32(0.052980118),
            np.float32(1.586134342))  # -delta, -gamma, -beta, -alpha


def _refuse(variant: str):
    raise NotImplementedError(f"JPEG 2000 {variant} is not decoded ({FORMATS_TODO})")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---- the JP2 boxes ------------------------------------------------------------------------------

def _boxes(raw: bytes, pos: int, end: int):
    """(type, body start, body end) of each box in raw[pos:end]."""
    while pos + 8 <= end:
        length, kind = struct.unpack(">I4s", raw[pos : pos + 8])
        head = 8
        if length == 1:
            (length,) = struct.unpack(">Q", raw[pos + 8 : pos + 16])
            head = 16
        elif length == 0:
            length = end - pos
        if length < head or pos + length > end:
            raise ValueError("JPEG 2000 box length runs past the file")
        yield kind, pos + head, pos + length
        pos += length


def _read_jp2(raw: bytes):
    """A JP2 file -> (codestream, header): Pillow's view of `jp2h` (the
    number of components, the colour space, the palette, the mode)."""
    header = dict(nc=None, colour=None, palette=None)  # cmap and cdef: unread, as by Pillow
    stream = None
    for kind, start, end in _boxes(raw, 0, len(raw)):
        if kind == b"jp2h":
            _read_jp2h(raw, start, end, header)
        elif kind == b"jp2c":
            stream = raw[start:end]
            break
    if header["nc"] is None:
        raise ValueError("JPEG 2000 file has no ihdr box")
    if stream is None:
        raise ValueError("JPEG 2000 file has no codestream box")
    return stream, header


def _read_jp2h(raw: bytes, start: int, end: int, header: dict):
    mode = None
    for kind, s, e in _boxes(raw, start, end):
        body = raw[s:e]
        if kind == b"ihdr":
            _h, _w, nc, bpc = struct.unpack(">IIHB", body[:11])
            header["nc"] = nc
            mode = "I;16" if nc == 1 and (bpc & 0x7F) > 8 else {
                1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc)
        elif kind == b"colr" and header["colour"] is None:  # OpenJPEG keeps the first
            method = body[0]
            if method == 1:
                (enumcs,) = struct.unpack(">I", body[3:7])
                header["colour"] = _COLOUR_SPACES.get(enumcs, f"enumerated {enumcs}")
            else:
                header["colour"] = "ICC profile"
        elif kind == b"pclr" and mode in ("L", "LA"):
            ne, npc = struct.unpack(">HB", body[:3])
            depths = body[3 : 3 + npc]
            if max(depths, default=0) <= 8:  # Pillow reads each entry as npc bytes
                rows = np.frombuffer(body, np.uint8, ne * npc, 3 + npc).reshape(ne, npc)
                header["palette"] = _pillow_palette(rows)
                mode = "P" if mode == "L" else "PA"
    header["mode"] = mode


def _pillow_palette(rows: np.ndarray) -> np.ndarray:
    """A `pclr` table -> the RGBA palette Pillow's `ImagePalette.getcolor`
    builds from it: each colour once, in the order it first appears."""
    if rows.shape[1] not in (3, 4):
        _refuse(f"palette of {rows.shape[1]} columns")
    seen = {}
    for row in map(tuple, rows.tolist()):
        seen.setdefault(row if len(row) == 4 else row + (255,), None)
    if len(seen) > 256:
        raise ValueError("JPEG 2000 palette has more than 256 colours")
    return np.array(list(seen), np.uint8).reshape(-1, 4)


# ---- the codestream's markers -------------------------------------------------------------------

def _coding_style(body: bytes, pos: int, scod: int) -> dict:
    """SPcod / SPcoc from body[pos:] -> its fields."""
    nl, xcb, ycb, style, transform = body[pos : pos + 5]
    for bit, name in _CBLK_STYLES:
        if style & bit:
            _refuse(name)
    if transform > 1:
        raise ValueError(f"JPEG 2000 wavelet transform {transform} is not defined")
    if scod & 1:
        sizes = body[pos + 5 : pos + 6 + nl]
        ppx, ppy = [b & 15 for b in sizes], [b >> 4 for b in sizes]
    else:
        ppx, ppy = [15] * (nl + 1), [15] * (nl + 1)
    return dict(nl=nl, xcb=xcb + 2, ycb=ycb + 2, reversible=transform == 1, ppx=ppx, ppy=ppy)


def _quantisation(body: bytes) -> dict:
    """Sqcd / Sqcc and its step sizes -> guard bits and (exponent,
    mantissa) per band index (derived steps are filled in later)."""
    style, guard = body[0] & 31, body[0] >> 5
    if style == 0:
        steps = [(b >> 3, 0) for b in body[1:]]
    elif style in (1, 2):
        n = (len(body) - 1) // 2
        steps = [(v >> 11, v & 0x7FF) for v in struct.unpack(f">{n}H", body[1 : 1 + 2 * n])]
    else:
        raise ValueError(f"JPEG 2000 quantisation style {style} is not defined")
    return dict(style=style, guard=guard, steps=steps)


class _Codestream:
    """The main header, and each tile's headers and joined data."""

    def __init__(self, cs: bytes):
        if cs[:4] != J2K_SIGNATURE:
            raise ValueError("JPEG 2000 codestream does not start with SOC, SIZ")
        self.cs = cs
        self.main = dict(cod=None, coc={}, qcd=None, qcc={})
        self.tiles = {}  # tile index -> the same, and the data of its tile-parts
        pos = self._header(2, self.main, main=True)
        while pos + 2 <= len(cs):
            (marker,) = struct.unpack(">H", cs[pos : pos + 2])
            if marker == 0xFFD9:  # EOC
                break
            if marker != 0xFF90:
                raise ValueError(f"JPEG 2000 marker {marker:04X} where SOT was expected")
            _lsot, index, psot, part, _parts = struct.unpack(">HHIBB", cs[pos + 2 : pos + 12])
            end = pos + psot if psot else len(cs) - (2 if cs[-2:] == b"\xff\xd9" else 0)
            tile = self.tiles.setdefault(index, dict(coc={}, qcc={}, cod=None, qcd=None,
                                                     data=[]))
            start = self._header(pos + 12, tile, main=False, first_part=part == 0)
            tile["data"].append(cs[start : min(end, len(cs))])
            pos = end

    def _header(self, pos: int, into: dict, main: bool, first_part: bool = True) -> int:
        """Read marker segments from pos up to SOT (the main header) or SOD
        (a tile-part header; its styles count in a tile's first part) into
        `into` -> the position of SOT, or after SOD."""
        cs = self.cs
        while True:
            if pos + 2 > len(cs):
                raise ValueError("JPEG 2000 codestream ends inside a header")
            (marker,) = struct.unpack(">H", cs[pos : pos + 2])
            if main and marker == 0xFF90:
                return pos
            if not main and marker == 0xFF93:  # SOD
                return pos + 2
            (length,) = struct.unpack(">H", cs[pos + 2 : pos + 4])
            body = cs[pos + 4 : pos + 2 + length]
            pos += 2 + length
            if marker in _REFUSED_MARKERS:
                _refuse(_REFUSED_MARKERS[marker])
            if marker == 0xFF51 and main:
                self._siz(body)
            elif marker == 0xFF52 and first_part:  # COD
                scod = body[0]
                prog, layers, mct = struct.unpack(">BHB", body[1:5])
                if prog > 4:
                    raise ValueError(f"JPEG 2000 progression order {prog} is not defined")
                if mct > 1:
                    _refuse(f"multiple component transform {mct}")
                into["cod"] = dict(_coding_style(body, 5, scod), sop=bool(scod & 2),
                                   eph=bool(scod & 4), prog=prog, layers=layers, mct=mct)
            elif marker == 0xFF53 and first_part:  # COC
                wide = self.csiz >= 257
                comp = struct.unpack(">H" if wide else ">B", body[: 1 + wide])[0]
                into["coc"][comp] = _coding_style(body, 2 + wide, body[1 + wide])
            elif marker == 0xFF5C and first_part:  # QCD
                into["qcd"] = _quantisation(body)
            elif marker == 0xFF5D and first_part:  # QCC
                wide = self.csiz >= 257
                comp = struct.unpack(">H" if wide else ">B", body[: 1 + wide])[0]
                into["qcc"][comp] = _quantisation(body[1 + wide :])
            # COM, TLM, PLM, PLT and any other segment: nothing the decode needs

    def _siz(self, body: bytes):
        (_rsiz, self.xsiz, self.ysiz, self.xosiz, self.yosiz, self.xtsiz, self.ytsiz,
         self.xtosiz, self.ytosiz, self.csiz) = struct.unpack(">HIIIIIIIIH", body[:36])
        if self.csiz > 4:
            _refuse(f"image of {self.csiz} components")
        self.precision, self.signed = [], []
        for c in range(self.csiz):
            ssiz, dx, dy = body[36 + 3 * c : 39 + 3 * c]
            if (dx, dy) != (1, 1):
                _refuse(f"component subsampling {dx}x{dy}")
            prec = (ssiz & 0x7F) + 1
            if prec > _MAX_PRECISION:
                _refuse(f"precision {prec}")
            self.precision.append(prec)
            self.signed.append(bool(ssiz & 0x80))
        if (self.xtsiz == 0 or self.ytsiz == 0 or self.xosiz >= self.xsiz
                or self.yosiz >= self.ysiz or self.xtosiz > self.xosiz
                or self.ytosiz > self.yosiz or self.xtosiz + self.xtsiz <= self.xosiz
                or self.ytosiz + self.ytsiz <= self.yosiz):
            raise ValueError("JPEG 2000 SIZ image or tile geometry is not valid")

    def styles(self, index: int):
        """The coding and quantisation styles of each component of tile
        `index`, by the standard's precedence (tile COC, tile COD, main
        COC, main COD; the same for QCC and QCD)."""
        tile, main = self.tiles[index], self.main
        cod, qcd = tile["cod"] or main["cod"], tile["qcd"] or main["qcd"]
        if cod is None or qcd is None:
            raise ValueError("JPEG 2000 codestream has no COD or QCD")
        comps = []
        for c in range(self.csiz):
            coding = tile["coc"].get(c) or (None if tile["cod"] else main["coc"].get(c)) or cod
            quant = tile["qcc"].get(c) or (None if tile["qcd"] else main["qcc"].get(c)) or qcd
            comps.append((coding, quant))
        return cod, comps


# ---- tier-2: packets ----------------------------------------------------------------------------

class _Bits:
    """OpenJPEG's packet-header bit reader: after a 0xFF byte the next
    holds 7 bits."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos, self.buf, self.ct = data, pos, 0, 0

    def _byte(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.pos < len(self.data):
            self.buf |= self.data[self.pos]
            self.pos += 1

    def bit(self) -> int:
        if self.ct == 0:
            self._byte()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> int:
        if (self.buf & 0xFF) == 0xFF:
            self._byte()
        self.ct = 0
        return self.pos


class _TagTree:
    def __init__(self, w: int, h: int):
        self.parent, self.value, self.low = [], [], []
        level, offset = (w, h), 0
        while True:
            lw, lh = level
            n = lw * lh
            up = ((lw + 1) // 2, (lh + 1) // 2)
            for j in range(lh):
                for i in range(lw):
                    self.parent.append(offset + n + (j // 2) * up[0] + i // 2 if n > 1 else -1)
            offset += n
            if n <= 1:
                break
            level = up
        self.value = [999] * offset
        self.low = [0] * offset

    def decode(self, bits: _Bits, leaf: int, threshold: int) -> bool:
        path, node = [], leaf
        while node >= 0:
            path.append(node)
            node = self.parent[node]
        low = 0
        for node in reversed(path):
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bits.bit():
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
        return self.value[leaf] < threshold


class _Block:
    __slots__ = ("band", "x0", "y0", "x1", "y1", "started", "numbps", "lenbits", "passes",
                 "chunks")

    def __init__(self, band, x0, y0, x1, y1):
        self.band, self.x0, self.y0, self.x1, self.y1 = band, x0, y0, x1, y1
        self.started, self.numbps, self.lenbits, self.passes, self.chunks = False, 0, 3, 0, []


class _Band:
    """One sub-band of a tile-component: its rectangle, its step and its
    code-blocks per precinct."""

    def __init__(self, orient, rect, numbps, step):
        self.orient, self.rect, self.numbps, self.step = orient, rect, numbps, step
        x0, y0, x1, y1 = rect
        self.data = None  # filled after tier-1
        self.empty = x0 >= x1 or y0 >= y1
        self.precincts = []  # (incl tree, zero-plane tree, [blocks])


def _resolution(tile, r: int, coding, quant, prec: int, blocks: list):
    """Resolution r of a tile-component -> dict(rect, pdx, pdy, pw, ph,
    bands), its code-blocks appended to `blocks`."""
    tx0, ty0, tx1, ty1 = tile
    nl = coding["nl"]
    rect = tuple(_ceil_div(v, 1 << (nl - r)) for v in tile)
    rx0, ry0, rx1, ry1 = rect
    pdx, pdy = coding["ppx"][r], coding["ppy"][r]
    if r > 0 and (pdx == 0 or pdy == 0):
        raise ValueError("JPEG 2000 precinct of size 1 above resolution 0")
    px0, py0 = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
    pw = 0 if rx0 == rx1 else (_ceil_div(rx1, 1 << pdx) << pdx) - px0 >> pdx
    ph = 0 if ry0 == ry1 else (_ceil_div(ry1, 1 << pdy) << pdy) - py0 >> pdy
    if r == 0:
        origin, gw, gh, orients = (px0, py0), pdx, pdy, (0,)
    else:
        origin, gw, gh = (_ceil_div(px0, 2), _ceil_div(py0, 2)), pdx - 1, pdy - 1
        orients = (1, 2, 3)
    cbw, cbh = min(coding["xcb"], gw), min(coding["ycb"], gh)
    bands = []
    for orient in orients:
        nb = nl if r == 0 else nl - r + 1  # the band's decomposition level
        ox, oy = (orient & 1) << nb >> 1, (orient >> 1) << nb >> 1
        brect = (_ceil_div(tx0 - ox, 1 << nb), _ceil_div(ty0 - oy, 1 << nb),
                 _ceil_div(tx1 - ox, 1 << nb), _ceil_div(ty1 - oy, 1 << nb))
        index = 0 if r == 0 else 3 * (r - 1) + orient
        expn, mant = _step(quant, index)
        step = np.float32((1.0 + mant / 2048.0) * 2.0 ** (prec - expn))
        band = _Band(orient, brect, expn + quant["guard"] - 1, step)
        bx0, by0, bx1, by1 = brect
        for p in range(pw * ph):
            gx0 = origin[0] + (p % pw) * (1 << gw)
            gy0 = origin[1] + (p // pw) * (1 << gh)
            x0, y0 = max(gx0, bx0), max(gy0, by0)
            x1, y1 = min(gx0 + (1 << gw), bx1), min(gy0 + (1 << gh), by1)
            cx0, cy0 = (x0 >> cbw) << cbw, (y0 >> cbh) << cbh
            cw = max(0, (_ceil_div(x1, 1 << cbw) << cbw) - cx0 >> cbw) if x1 > x0 else 0
            ch = max(0, (_ceil_div(y1, 1 << cbh) << cbh) - cy0 >> cbh) if y1 > y0 else 0
            cblks = []
            for j in range(ch):
                for i in range(cw):
                    bx = cx0 + (i << cbw)
                    by = cy0 + (j << cbh)
                    blk = _Block(band, max(bx, x0), max(by, y0), min(bx + (1 << cbw), x1),
                                 min(by + (1 << cbh), y1))
                    cblks.append(blk)
                    blocks.append(blk)
            trees = (_TagTree(cw, ch), _TagTree(cw, ch)) if cblks else (None, None)
            band.precincts.append((*trees, cblks))
        bands.append(band)
    return dict(rect=rect, pdx=pdx, pdy=pdy, pw=pw, ph=ph, bands=bands)


def _step(quant, index: int):
    steps = quant["steps"]
    if quant["style"] == 1:  # scalar derived: the LL step, one exponent less a level
        expn, mant = steps[0]
        return (max(0, expn - (index - 1) // 3) if index else expn), mant
    if index >= len(steps):
        raise ValueError(f"JPEG 2000 QCD has no step for band {index}")
    return steps[index]


def _packet_order(prog: int, layers: int, tile, comps):
    """(layer, resolution, component, precinct) of each packet of a tile in
    the order of OpenJPEG's pi.c; comps[c] is the list of component c's
    resolutions (their pdx, pdy, pw, ph)."""
    tx0, ty0, tx1, ty1 = tile
    seen = set()
    max_res = max(len(c) for c in comps)

    def once(key):
        if key in seen:
            return False
        seen.add(key)
        return True

    if prog in (0, 1):
        outer = ((l, r) for l in range(layers) for r in range(max_res)) if prog == 0 else (
            (l, r) for r in range(max_res) for l in range(layers))
        for l, r in outer:
            for c, res in enumerate(comps):
                if r < len(res):
                    for p in range(res[r]["pw"] * res[r]["ph"]):
                        if once((l, r, c, p)):
                            yield l, r, c, p
        return

    def steps(lo, hi, d):
        v = lo
        while v < hi:
            yield v
            v += d - v % d

    def precinct(x, y, c, r):
        res = comps[c][r]
        level = len(comps[c]) - 1 - r
        trx0, try0 = _ceil_div(tx0, 1 << level), _ceil_div(ty0, 1 << level)
        trx1, try1 = _ceil_div(tx1, 1 << level), _ceil_div(ty1, 1 << level)
        rpx, rpy = res["pdx"] + level, res["pdy"] + level
        if not (y % (1 << rpy) == 0 or (y == ty0 and (try0 << level) % (1 << rpy))):
            return None
        if not (x % (1 << rpx) == 0 or (x == tx0 and (trx0 << level) % (1 << rpx))):
            return None
        if res["pw"] == 0 or res["ph"] == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (_ceil_div(x, 1 << level) >> res["pdx"]) - (trx0 >> res["pdx"])
        prcj = (_ceil_div(y, 1 << level) >> res["pdy"]) - (try0 >> res["pdy"])
        return prci + prcj * res["pw"]

    def grid(cs):
        dx = min(1 << (res["pdx"] + len(comps[c]) - 1 - r) for c in cs
                 for r, res in enumerate(comps[c]))
        dy = min(1 << (res["pdy"] + len(comps[c]) - 1 - r) for c in cs
                 for r, res in enumerate(comps[c]))
        return dx, dy

    def emit(x, y, c, r):
        p = precinct(x, y, c, r)
        if p is not None:
            for l in range(layers):
                if once((l, r, c, p)):
                    yield l, r, c, p

    all_comps = range(len(comps))
    if prog == 2:  # RPCL
        dx, dy = grid(all_comps)
        for r in range(max_res):
            for y in steps(ty0, ty1, dy):
                for x in steps(tx0, tx1, dx):
                    for c in all_comps:
                        if r < len(comps[c]):
                            yield from emit(x, y, c, r)
    elif prog == 3:  # PCRL
        dx, dy = grid(all_comps)
        for y in steps(ty0, ty1, dy):
            for x in steps(tx0, tx1, dx):
                for c in all_comps:
                    for r in range(len(comps[c])):
                        yield from emit(x, y, c, r)
    else:  # CPRL
        for c in all_comps:
            dx, dy = grid((c,))
            for y in steps(ty0, ty1, dy):
                for x in steps(tx0, tx1, dx):
                    for r in range(len(comps[c])):
                        yield from emit(x, y, c, r)


def _passes(bits: _Bits) -> int:
    if not bits.bit():
        return 1
    if not bits.bit():
        return 2
    n = bits.bits(2)
    if n != 3:
        return 3 + n
    n = bits.bits(5)
    if n != 31:
        return 6 + n
    return 37 + bits.bits(7)


def _read_packet(data: bytes, pos: int, layer: int, bands, precinct: int, sop: bool, eph: bool):
    """One packet at data[pos:] -> (where its body starts, where it ends);
    its code-blocks' passes and data added."""
    if sop and data[pos : pos + 2] == b"\xff\x91":
        pos += 6
    bits = _Bits(data, pos)
    included = []
    if bits.bit():
        for band in bands:
            if band.empty:
                continue
            incl, zero, blks = band.precincts[precinct]
            for k, blk in enumerate(blks):
                if not blk.started:
                    if not incl.decode(bits, k, layer + 1):
                        continue
                    i = 0
                    while not zero.decode(bits, k, i):
                        i += 1
                    blk.started, blk.numbps, blk.lenbits = True, band.numbps + 1 - i, 3
                elif not bits.bit():
                    continue
                n = _passes(bits)
                while bits.bit():  # the comma code of Lblock's increase
                    blk.lenbits += 1
                length = bits.bits(blk.lenbits + n.bit_length() - 1)
                blk.passes += n
                included.append((blk, length))
    pos = bits.align()
    if eph and data[pos : pos + 2] == b"\xff\x92":
        pos += 2
    body = pos
    for blk, length in included:
        blk.chunks.append(data[pos : pos + length])
        pos += length
    return body, pos


# ---- tier-1, dequantisation, wavelets -----------------------------------------------------------

def _tier1(blocks: list):
    """Decode every code-block (host C++) and write its coefficients into
    its band's array."""
    work = [b for b in blocks if b.passes > 0]
    meta = np.zeros((len(work), 8), np.int64)
    chunks, offset, out_at = [], 0, 0
    for k, b in enumerate(work):
        data = b"".join(b.chunks)
        w, h = b.x1 - b.x0, b.y1 - b.y0
        meta[k] = (offset, len(data), w, h, b.band.orient, b.numbps, b.passes, out_at)
        chunks.append(data)
        offset += len(data)
        out_at += w * h
    if not work:
        return
    buf = np.frombuffer(b"".join(chunks) + b"\0", np.uint8)
    out = np.empty(out_at, np.int32)
    if _entropy.j2k_library().j2k_codeblocks(ptr(buf), len(work), ptr(meta), ptr(out)) != 0:
        raise ValueError("JPEG 2000 code-block has 31 or more bit planes")
    for k, b in enumerate(work):
        band = b.band
        w, h = b.x1 - b.x0, b.y1 - b.y0
        v = out[meta[k, 7] : meta[k, 7] + w * h].reshape(h, w)
        x0, y0 = band.rect[0], band.rect[1]
        band.data[b.y0 - y0 : b.y1 - y0, b.x0 - x0 : b.x1 - x0] = v


def _dequantise(band: _Band, reversible: bool) -> np.ndarray:
    v = band.data
    if reversible:  # OpenJPEG's C division by 2: toward zero
        half = np.abs(v) >> 1
        return np.where(v < 0, -half, half)
    return v.astype(np.float32) * (np.float32(0.5) * band.step)


def _neighbours(a: np.ndarray, axis: int, shift: int, n: int) -> np.ndarray:
    """a[i + shift] along `axis` for i < n (shift -1, 0 or 1), a position
    before the first or after the last sample reading its mirror: the
    neighbours of a lifting step under whole-sample symmetric extension."""
    def cut(s):
        return a[s] if axis == 0 else a[:, s]
    if shift < 0:
        parts = (cut(slice(0, 1)), a)
    elif shift == 0:
        parts = (a, cut(slice(-1, None)))
    else:
        parts = (cut(slice(1, None)), cut(slice(-1, None)))
    out = np.concatenate(parts, axis)
    return out[:n] if axis == 0 else out[:, :n]


def _synthesise(low: np.ndarray, high: np.ndarray, cas: int, reversible: bool,
                axis: int) -> np.ndarray:
    """One inverse 1-D wavelet along `axis` of 2-D bands: `cas` is the
    parity of the first sample (1: it is high-pass)."""
    sn, dn = low.shape[axis], high.shape[axis]
    n = sn + dn
    shape = list(low.shape)
    shape[axis] = n
    x = np.empty(shape, low.dtype)
    at = [slice(None)] * 2
    if n == 1:
        if reversible and cas:  # OpenJPEG halves a lone odd sample, by C division
            return np.where(high < 0, -(np.abs(high) >> 1), high >> 1)
        return (high if cas else low).copy()
    if n > 0:
        low, high = low.copy(), high.copy()
        # cas 0: low i sits between high i - 1 and high i, high i between low i and low i + 1;
        # cas 1: low i between high i and high i + 1, high i between low i - 1 and low i
        h_at, l_at = ((-1, 0), (0, 1)) if cas == 0 else ((0, 1), (-1, 0))

        def highs():  # the two high-pass neighbours of each low sample, summed
            return _neighbours(high, axis, h_at[0], sn) + _neighbours(high, axis, h_at[1], sn)

        def lows():
            return _neighbours(low, axis, l_at[0], dn) + _neighbours(low, axis, l_at[1], dn)

        if reversible:
            low -= (highs() + 2) >> 2
            high += lows() >> 1
        else:
            low *= _K
            high *= _TWO_INV_K
            for k, c in enumerate(_LIFT_97):
                if k % 2 == 0:
                    low += highs() * c
                else:
                    high += lows() * c
    at[axis] = slice(cas, None, 2)
    x[tuple(at)] = low
    at[axis] = slice(1 - cas, None, 2)
    x[tuple(at)] = high
    return x


def _inverse_dwt(resolutions, reversible: bool) -> np.ndarray:
    """The bands of a tile-component, resolution by resolution -> its
    samples (int32 for the 5/3, float32 for the 9/7): rows, then columns."""
    a = _dequantise(resolutions[0]["bands"][0], reversible)
    for res in resolutions[1:]:
        hl, lh, hh = (_dequantise(b, reversible) for b in res["bands"])
        rx0, ry0 = res["rect"][:2]
        top = _synthesise(a, hl, rx0 & 1, reversible, 1)
        bottom = _synthesise(lh, hh, rx0 & 1, reversible, 1)
        a = _synthesise(top, bottom, ry0 & 1, reversible, 0)
    return a


# ---- the decoder --------------------------------------------------------------------------------

class _Image:
    """A decoded codestream: its components as int64 planes of the image
    area, with their precisions and signs."""

    def __init__(self, stream: _Codestream):
        self.stream = stream
        width, height = stream.xsiz - stream.xosiz, stream.ysiz - stream.yosiz
        self.planes = [np.zeros((height, width), np.int64) for _ in range(stream.csiz)]
        tiles_x = _ceil_div(stream.xsiz - stream.xtosiz, stream.xtsiz)
        tiles_y = _ceil_div(stream.ysiz - stream.ytosiz, stream.ytsiz)
        work = []
        blocks = []
        for index in sorted(stream.tiles):  # every header is read before any packet
            if index >= tiles_x * tiles_y:
                raise ValueError(f"JPEG 2000 tile index {index} is out of range")
            p, q = index % tiles_x, index // tiles_x
            rect = (max(stream.xtosiz + p * stream.xtsiz, stream.xosiz),
                    max(stream.ytosiz + q * stream.ytsiz, stream.yosiz),
                    min(stream.xtosiz + (p + 1) * stream.xtsiz, stream.xsiz),
                    min(stream.ytosiz + (q + 1) * stream.ytsiz, stream.ysiz))
            cod, styles = stream.styles(index)
            if cod["mct"] and len({coding["reversible"] for coding, _q in styles[:3]}) > 1:
                _refuse("component transform over components of different wavelets")
            comps = []
            for c, (coding, quant) in enumerate(styles):
                comps.append([_resolution(rect, r, coding, quant, stream.precision[c], blocks)
                              for r in range(coding["nl"] + 1)])
            work.append((index, rect, cod, styles, comps))
        self.packets = {}  # tile index -> (start, body start, end) of each packet in its data
        for index, rect, cod, styles, comps in work:
            data = b"".join(stream.tiles[index]["data"])
            spans = self.packets[index] = []
            pos = 0
            for l, r, c, p in _packet_order(cod["prog"], cod["layers"], rect, comps):
                if pos >= len(data):
                    break
                body, end = _read_packet(data, pos, l, comps[c][r]["bands"], p, cod["sop"],
                                         cod["eph"])
                spans.append((pos, body, end))
                pos = end
            for res in (res for comp in comps for res in comp):
                for band in res["bands"]:
                    x0, y0, x1, y1 = band.rect
                    band.data = np.zeros((max(0, y1 - y0), max(0, x1 - x0)), np.int32)
        _tier1(blocks)
        for index, rect, cod, styles, comps in work:
            self._tile(rect, cod, styles, comps)

    def _tile(self, rect, cod, styles, comps):
        stream = self.stream
        samples = [_inverse_dwt(res, coding["reversible"])
                   for res, (coding, _q) in zip(comps, styles)]
        if cod["mct"] and stream.csiz >= 3:
            y, u, v = samples[:3]
            if styles[0][0]["reversible"]:  # RCT
                g = y - ((u + v) >> 2)
                samples[:3] = [v + g, g, u + g]
            else:  # ICT, float32 in OpenJPEG's order
                samples[:3] = [y + v * np.float32(1.402),
                               y - u * np.float32(0.34413) - v * np.float32(0.71414),
                               y + u * np.float32(1.772)]
        x0, y0, x1, y1 = rect
        for c, s in enumerate(samples):
            prec, signed = stream.precision[c], stream.signed[c]
            lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if signed else (0, (1 << prec) - 1)
            if s.dtype == np.float32:
                s = np.rint(s).astype(np.int64)  # lrintf: half to even
            s = np.clip(s + (0 if signed else 1 << (prec - 1)), lo, hi)
            self.planes[c][y0 - stream.yosiz : y1 - stream.yosiz,
                           x0 - stream.xosiz : x1 - stream.xosiz] = s


def _pillow_bits(plane: np.ndarray, prec: int, signed: bool, bits: int) -> np.ndarray:
    """Jpeg2KDecode.c's unpack of one component to `bits` (8 or 16) bits."""
    size = (prec + 7) >> 3
    size = 4 if size == 3 else size
    word = plane & ((1 << (8 * size)) - 1)  # the tile buffer's int8/16/32, read unsigned
    shift = bits - prec
    offset = (1 << (prec - 1)) if signed else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    x = (word + offset) & 0xFFFFFFFF
    x = x >> -shift if shift < 0 else (x << shift) & 0xFFFFFFFF
    return x & ((1 << bits) - 1)


def decode_jpeg2000(raw: bytes) -> np.ndarray:
    """A JP2 file or a raw JPEG 2000 codestream -> uint8 [H, W, 4], as
    Pillow 12.1.0's `convert("RGBA")`."""
    raw = bytes(raw)
    if raw[:12] == JP2_SIGNATURE:
        cs, header = _read_jp2(raw)
        mode, colour = header["mode"], header["colour"]
    elif raw[:4] == J2K_SIGNATURE:
        cs, header, colour = raw, None, None
    else:
        raise ValueError("not a JPEG 2000 file")
    stream = _Codestream(cs)  # every header; a refused variant raises here
    if header is None:  # Pillow's mode from SIZ; OpenJPEG leaves the colour space unspecified
        prec0 = stream.precision[0]
        mode = {1: "I;16" if prec0 > 8 else "L", 2: "LA", 3: "RGB", 4: "RGBA"}[stream.csiz]
        colour = "greyscale" if stream.csiz <= 2 else "sRGB"
    elif header["nc"] != stream.csiz:
        raise ValueError(f"JPEG 2000 ihdr says {header['nc']} components, SIZ {stream.csiz}")
    if colour is None:
        raise ValueError("JPEG 2000 file has no colr box")
    if colour not in ("sRGB", "greyscale"):
        _refuse(f"{colour} colour space")
    # Pillow's unpackers by (mode, colour space): the rest it cannot read
    want = {"L": "greyscale", "I;16": "greyscale", "LA": "greyscale", "RGB": "sRGB",
            "RGBA": "sRGB", "P": "sRGB", "PA": "sRGB"}
    if mode is None or want[mode] != colour:
        raise ValueError(f"JPEG 2000 mode {mode} in colour space {colour}: Pillow has no unpacker")
    image = _Image(stream)
    planes = image.planes
    eight = [_pillow_bits(p, stream.precision[c], stream.signed[c], 8)
             for c, p in enumerate(planes)]
    h, w = planes[0].shape
    note_core(mode, _pillow_bits(planes[0], stream.precision[0], stream.signed[0], 16)
              if mode == "I;16" else eight[0] if mode in ("L", "P") else None)
    out = np.full((h, w, 4), 255, np.uint8)
    if mode == "I;16":
        out[..., :3] = np.minimum(_pillow_bits(planes[0], stream.precision[0], stream.signed[0],
                                               16), 255)[..., None]
    elif mode in ("L", "LA"):
        out[..., :3] = eight[0][..., None]
        if mode == "LA":
            out[..., 3] = eight[1]
    elif mode in ("P", "PA"):
        palette = np.zeros((256, 4), np.uint8)
        palette[:, 3] = 255
        palette[: len(header["palette"])] = header["palette"]
        out[...] = palette[eight[0]]
        if mode == "PA":
            out[..., 3] = eight[1]
    else:
        for c in range(3):
            out[..., c] = eight[c]
        if mode == "RGBA":
            out[..., 3] = eight[3]
    return out
