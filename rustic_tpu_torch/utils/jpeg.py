"""A NumPy JPEG decoder for scene textures and LDR skyboxes.

The JAX package decodes JPEGs with Pillow (`Image.open(...).convert("RGBA")`,
rustic_tpu/scene/gltf.py `_decode_image`), that is with libjpeg-turbo's
defaults; `decode_jpeg` gives the same bytes. It reads Huffman-coded
8-bit JPEGs: baseline (SOF0), extended (SOF1) and progressive (SOF2),
with any table ids, restart intervals, one component (grey) or three
(YCbCr, or RGB where an Adobe APP14 segment says transform 0 or the
component ids spell "RGB", as libjpeg guesses), interleaved or not, at
any integral sampling. libjpeg-turbo's arithmetic is reproduced where it
rounds: the accurate integer IDCT (jidctint.c, 13 constant bits, 2 pass-1
bits), "fancy" upsampling (the triangle filters of jdsample.c for 2x1,
1x2 and 2x2; plain replication for a 2x1 or 2x2 plane at most 2 samples
wide and for other ratios; the edge sample repeated as context) and the
fixed-point YCbCr -> RGB tables of jdcolor.c. Arithmetic coding, 12-bit
samples, lossless and hierarchical files and four components (CMYK,
YCCK) raise NotImplementedError naming the variant.

Only the entropy decode is a Python loop: a 16-bit window of the bit
stream, read from a table of 56-bit words (one for each byte), indexes a
lookup table of (code length, symbol), so one symbol costs one lookup.
Dequantisation, the IDCT, upsampling and colour conversion run over all
blocks at once. `decode_image_u8` (utils/png.py) picks this decoder by
the SOI marker, beside PNG, BMP, TGA, GIF, TIFF and WebP.
"""

from __future__ import annotations

import struct

import numpy as np

from rustic_tpu_torch.utils import FORMATS_TODO

# the k-th coefficient of the zigzag order -> its index in the 8x8 block (row-major)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
_UNZIG = np.argsort(ZIGZAG)  # block index -> zigzag position

# start-of-frame markers this decoder refuses, by the variant they name
_REFUSED_SOF = {
    0xC3: "lossless (SOF3)",
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical progressive (SOF6)",
    0xC7: "hierarchical lossless (SOF7)",
    0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)", 0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless (SOF15)",
    0xF7: "JPEG-LS (SOF55)",
}
_WORD_BITS = 56  # the bits of stream each entry of the word table holds


def _refuse(variant: str):
    raise NotImplementedError(f"JPEG {variant} is not decoded ({FORMATS_TODO})")


class _Huffman:
    """One Huffman table as a 2^16 lookup: the next 16 bits of the stream
    -> code length << 8 | symbol (length 0 where no code matches)."""

    def __init__(self, counts, symbols):
        lut = np.zeros(1 << 16, np.int32)
        code = k = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                if code >= 1 << length:
                    raise ValueError("JPEG Huffman table is over-subscribed")
                span = 1 << (16 - length)
                lut[code * span : (code + 1) * span] = length << 8 | symbols[k]
                code += 1
                k += 1
            code <<= 1
        self.lut = lut.tolist()
        self._fast = None

    def fast_ac(self) -> list:
        """For each 16-bit window, an AC symbol decoded with its value where
        the code and the value bits fit in the window: (bits, run, value),
        (code length, -1, 0) for an end of block, None otherwise (ZRL, a
        code too long). Built on first use."""
        if self._fast is None:
            e = np.asarray(self.lut, np.int64)
            ln, s, run = e >> 8, e & 15, (e >> 4) & 15
            total = ln + s
            raw = (np.arange(1 << 16) >> np.clip(16 - total, 0, 16)) & ((1 << s) - 1)
            value = np.where(raw >= (1 << s) >> 1, raw, raw - (1 << s) + 1)
            fast = [None] * (1 << 16)
            for i in np.flatnonzero((ln > 0) & (s > 0) & (total <= 16)).tolist():
                fast[i] = (int(total[i]), int(run[i]), int(value[i]))
            for i in np.flatnonzero((ln > 0) & (e & 0xFF == 0)).tolist():
                fast[i] = (int(ln[i]), -1, 0)
            self._fast = fast
        return self._fast


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None  # latched at the component's first scan, as libjpeg does


def _words(data: bytes) -> list:
    """[the 56 bits of `data` from byte i, zero past the end] for each i."""
    b = np.frombuffer(bytes(data) + bytes(8), np.uint8).astype(np.uint64)
    n = len(data) + 1
    w = np.zeros(n, np.uint64)
    for i in range(_WORD_BITS // 8):
        w = (w << np.uint64(8)) | b[i : i + n]
    return w.tolist()


def _entropy_segments(raw: bytes, pos: int):
    """The entropy-coded data from `pos` -> ([the byte-unstuffed data of
    each restart interval], the position of the marker that ends it)."""
    segments = []
    cur = bytearray()
    while True:
        ff = raw.find(b"\xff", pos)
        if ff < 0 or ff + 1 >= len(raw):  # Pillow refuses such a file as truncated
            raise ValueError("JPEG scan data runs past the end of the file")
        cur += raw[pos:ff]
        nxt = raw[ff + 1]
        if nxt == 0x00:  # a stuffed 0xFF data byte
            cur.append(0xFF)
            pos = ff + 2
        elif nxt == 0xFF:  # fill bytes before a marker
            pos = ff + 1
        elif 0xD0 <= nxt <= 0xD7:  # RSTn ends an interval
            segments.append(bytes(cur))
            cur = bytearray()
            pos = ff + 2
        else:
            segments.append(bytes(cur))
            return segments, ff


class _Decoder:
    """One JPEG file's state while its markers and scans are read."""

    def __init__(self, raw: bytes):
        self.raw = raw
        self.qt = {}
        self.dc = {}
        self.ac = {}
        self.restart = 0
        self.frame = None
        self.adobe = None  # APP14's transform flag
        self.jfif = False
        self.comps = []
        self.coef = {}  # component id -> Python list of zigzag coefficients

    # ---- markers --------------------------------------------------------------------------

    def run(self) -> np.ndarray:
        raw = self.raw
        if raw[:2] != b"\xff\xd8":
            raise ValueError("not a JPEG file (no SOI marker)")
        pos = 2
        while True:
            while pos + 1 < len(raw) and raw[pos] == 0xFF and raw[pos + 1] == 0xFF:
                pos += 1  # fill bytes
            if pos + 2 > len(raw) or raw[pos] != 0xFF:
                raise ValueError(f"JPEG marker expected at byte {pos}")
            marker = raw[pos + 1]
            if marker == 0xD9:  # EOI
                break
            if 0xD0 <= marker <= 0xD8 or marker == 0x01:  # parameterless
                pos += 2
                continue
            (length,) = struct.unpack(">H", raw[pos + 2 : pos + 4])
            body = raw[pos + 4 : pos + 2 + length]
            if len(body) != length - 2:
                raise ValueError("JPEG segment runs past the end of the file")
            pos += 2 + length
            if marker in (0xC0, 0xC1, 0xC2):
                self._frame(marker, body)
            elif marker in _REFUSED_SOF:
                _refuse(_REFUSED_SOF[marker])
            elif marker == 0xCC:
                _refuse("arithmetic-coded (DAC)")
            elif marker == 0xC4:
                self._dht(body)
            elif marker == 0xDB:
                self._dqt(body)
            elif marker == 0xDD:
                (self.restart,) = struct.unpack(">H", body[:2])
            elif marker == 0xDA:
                pos = self._scan(body, pos)
            elif marker == 0xDC:
                _refuse("height set by a DNL marker")
            elif marker == 0xE0 and body[:5] == b"JFIF\x00":
                self.jfif = True
            elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
                self.adobe = body[11]
            # other APPn, COM and unknown segments are skipped
        if self.frame is None:
            raise ValueError("JPEG has no frame header")
        return self._image()

    def _frame(self, marker, body):
        if self.frame is not None:
            raise ValueError("JPEG has more than one frame")
        precision, height, width, n = struct.unpack(">BHHB", body[:6])
        if precision != 8:
            _refuse(f"{precision}-bit")
        if n == 4:
            _refuse("4-component (CMYK or YCCK)")
        if n not in (1, 3):
            raise ValueError(f"JPEG with {n} components")
        if height == 0:
            _refuse("height set by a DNL marker")
        if width == 0:
            raise ValueError("JPEG width is 0")
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i : 9 + 3 * i]
            if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                raise ValueError(f"JPEG sampling factors {hv >> 4}x{hv & 15}")
            self.comps.append(_Component(cid, hv >> 4, hv & 15, tq))
        self.frame = (marker, height, width)
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-width // (8 * self.hmax))
        self.mcuy = -(-height // (8 * self.vmax))
        for c in self.comps:
            # the blocks a non-interleaved scan covers, and the padded MCU grid
            c.bw = -(-width * c.h // (8 * self.hmax))
            c.bh = -(-height * c.v // (8 * self.vmax))
            c.stride = self.mcux * c.h  # blocks a row of the coefficient store
            c.rows = self.mcuy * c.v
            self.coef[c.id] = [0] * (c.stride * c.rows * 64)

    def _dht(self, body):
        pos = 0
        while pos < len(body):
            tc_th = body[pos]
            counts = body[pos + 1 : pos + 17]
            n = sum(counts)
            symbols = body[pos + 17 : pos + 17 + n]
            pos += 17 + n
            if tc_th >> 4 > 1 or tc_th & 15 > 3:
                raise ValueError(f"JPEG Huffman table class/id {tc_th:#x}")
            (self.ac if tc_th >> 4 else self.dc)[tc_th & 15] = _Huffman(counts, symbols)

    def _dqt(self, body):
        pos = 0
        while pos < len(body):
            pq_tq = body[pos]
            if pq_tq >> 4:
                table = np.frombuffer(body[pos + 1 : pos + 129], ">u2").astype(np.int64)
                pos += 129
            else:
                table = np.frombuffer(body[pos + 1 : pos + 65], np.uint8).astype(np.int64)
                pos += 65
            self.qt[pq_tq & 15] = table  # zigzag order

    # ---- scans ----------------------------------------------------------------------------

    def _scan(self, body, pos):
        if self.frame is None:
            raise ValueError("JPEG scan before its frame header")
        n = body[0]
        by_id = {c.id: c for c in self.comps}
        comps, tables = [], []
        for i in range(n):
            cid, t = body[1 + 2 * i : 3 + 2 * i]
            c = by_id[cid]
            if c.qt is None:
                if c.tq not in self.qt:
                    raise ValueError(f"JPEG quantisation table {c.tq} is not defined")
                c.qt = self.qt[c.tq]
            comps.append(c)
            tables.append((t >> 4, t & 15))
        ss, se, ahal = body[1 + 2 * n : 4 + 2 * n]
        ah, al = ahal >> 4, ahal & 15
        progressive = self.frame[0] == 0xC2
        if not progressive and (ss, se, ah, al) != (0, 63, 0, 0):
            raise ValueError("JPEG sequential scan with a spectral selection")
        segments, end = _entropy_segments(self.raw, pos)
        # each MCU's blocks: the scan component and the offset into its coefficients
        if n == 1:
            c = comps[0]
            r, x = np.mgrid[0 : c.bh, 0 : c.bw]
            offs = ((r * c.stride + x) * 64).reshape(-1, 1)
            cis = np.zeros_like(offs)
        else:
            my, mx = (a.reshape(-1) for a in np.mgrid[0 : self.mcuy, 0 : self.mcux])
            layout = [(i, c, dy, dx) for i, c in enumerate(comps)
                      for dy in range(c.v) for dx in range(c.h)]
            offs = np.stack([((my * c.v + dy) * c.stride + mx * c.h + dx) * 64
                             for _, c, dy, dx in layout], axis=1)
            cis = np.broadcast_to(np.array([i for i, *_ in layout]), offs.shape)
        interval = self.restart or len(offs)
        kind = ("dc-first" if ah == 0 else "dc-refine") if ss == 0 else (
            "ac-first" if ah == 0 else "ac-refine")
        if not progressive:
            kind = "sequential"
        elif ss == 0 and se != 0 or ss > se or se > 63 or (ss > 0 and n != 1):
            raise ValueError(f"JPEG progressive scan with Ss={ss}, Se={se}, {n} components")
        for i, start in enumerate(range(0, len(offs), interval)):
            if i >= len(segments):
                break  # the data ended early: libjpeg leaves the rest zero
            part = slice(start, start + interval)
            blocks = zip(cis[part].reshape(-1).tolist(), offs[part].reshape(-1).tolist())
            self._decode(kind, segments[i], blocks, comps, tables, ss, se, al)
        return end

    def _decode(self, kind, data, blocks, comps, tables, ss, se, al):
        """The entropy decode of one restart interval: `blocks` are
        (scan component, offset into its coefficient list)."""
        words = _words(data)
        coefs = [self.coef[c.id] for c in comps]
        dcl = [self.dc.get(t[0]) for t in tables]
        acl = [self.ac.get(t[1]) for t in tables]
        need_dc = kind in ("sequential", "dc-first")
        need_ac = kind in ("sequential", "ac-first", "ac-refine")
        for i in range(len(comps)):
            if need_dc and dcl[i] is None or need_ac and acl[i] is None:
                raise ValueError("JPEG scan names an undefined Huffman table")
        fasts = [t.fast_ac() for t in acl] if kind == "sequential" else None
        dcl = [t and t.lut for t in dcl]
        acl = [t and t.lut for t in acl]
        pred = [0] * len(comps)
        p = 0  # bit position in the interval
        if kind in ("sequential", "dc-first"):
            sequential = kind == "sequential"
            for ci, off in blocks:
                co = coefs[ci]
                w = words[p >> 3]
                e = dcl[ci][(w >> (40 - (p & 7))) & 0xFFFF]
                ln, s = e >> 8, e & 0xFF
                if not ln:
                    raise ValueError("JPEG Huffman code not in its table")
                if s:  # s value bits: the difference's magnitude category (T.81 F.2.2.1)
                    v = (w >> (56 - (p & 7) - ln - s)) & ((1 << s) - 1)
                    pred[ci] += v if v >> (s - 1) else v - (1 << s) + 1
                p += ln + s
                co[off] = pred[ci] << al
                if not sequential:
                    continue
                ac, fast = acl[ci], fasts[ci]
                k = 1
                while k < 64:
                    w = words[p >> 3]
                    look = (w >> (40 - (p & 7))) & 0xFFFF
                    f = fast[look]
                    if f is not None:  # one lookup: the symbol and its value
                        n, r, v = f
                        p += n
                        if r < 0:
                            break
                        k += r
                        if k < 64:
                            co[off + k] = v
                        k += 1
                        continue
                    e = ac[look]
                    ln, rs = e >> 8, e & 0xFF
                    if not ln:
                        raise ValueError("JPEG Huffman code not in its table")
                    s = rs & 15
                    if s:
                        k += rs >> 4
                        v = (w >> (56 - (p & 7) - ln - s)) & ((1 << s) - 1)
                        if k < 64:
                            co[off + k] = v if v >> (s - 1) else v - (1 << s) + 1
                        p += ln + s
                        k += 1
                    else:
                        p += ln
                        if rs != 0xF0:
                            break
                        k += 16  # ZRL: sixteen zeros
            return
        if kind == "dc-refine":
            bit = 1 << al
            for ci, off in blocks:
                if (words[p >> 3] >> (55 - (p & 7))) & 1:
                    coefs[ci][off] |= bit
                p += 1
            return
        co, ac = coefs[0], acl[0]

        def bits(n):  # the next n bits
            nonlocal p
            v = (words[p >> 3] >> (56 - (p & 7) - n)) & ((1 << n) - 1)
            p += n
            return v

        eobrun = 0
        if kind == "ac-first":
            for _, off in blocks:
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    w = words[p >> 3]
                    e = ac[(w >> (40 - (p & 7))) & 0xFFFF]
                    ln, rs = e >> 8, e & 0xFF
                    if not ln:
                        raise ValueError("JPEG Huffman code not in its table")
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        v = (w >> (56 - (p & 7) - ln - s)) & ((1 << s) - 1)
                        if k <= 63:
                            co[off + k] = (v if v >> (s - 1) else v - (1 << s) + 1) << al
                        p += ln + s
                        k += 1
                        continue
                    p += ln
                    if r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) - 1
                        if r:
                            eobrun += bits(r)
                        break
                    k += 1
            return
        # ac-refine (T.81 G.1.2.3, as jdphuff.c decode_mcu_AC_refine)
        p1, m1 = 1 << al, -1 << al
        for _, off in blocks:
            k = ss
            if not eobrun:
                while k <= se:
                    w = words[p >> 3]
                    e = ac[(w >> (40 - (p & 7))) & 0xFFFF]
                    ln, rs = e >> 8, e & 0xFF
                    if not ln:
                        raise ValueError("JPEG Huffman code not in its table")
                    p += ln
                    r, s = rs >> 4, rs & 15
                    if s:
                        s = p1 if bits(1) else m1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += bits(r)
                        break
                    while k <= se:  # correction bits of the nonzero, r zeros skipped
                        c = co[off + k]
                        if c:
                            if (words[p >> 3] >> (55 - (p & 7))) & 1 and not c & p1:
                                co[off + k] = c + p1 if c >= 0 else c + m1
                            p += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s and k <= 63:
                        co[off + k] = s
                    k += 1
            if eobrun:
                while k <= se:
                    c = co[off + k]
                    if c:
                        if (words[p >> 3] >> (55 - (p & 7))) & 1 and not c & p1:
                            co[off + k] = c + p1 if c >= 0 else c + m1
                        p += 1
                    k += 1
                eobrun -= 1

    # ---- pixels ---------------------------------------------------------------------------

    def _image(self) -> np.ndarray:
        _, height, width = self.frame
        planes = []
        for c in self.comps:
            if c.qt is None:
                raise ValueError(f"JPEG component {c.id} is in no scan")
            zz = np.asarray(self.coef[c.id], np.int64).reshape(c.rows, c.stride, 64)
            blocks = _idct_islow((zz * c.qt)[..., _UNZIG].reshape(-1, 8, 8))
            plane = blocks.reshape(c.rows, c.stride, 8, 8).transpose(0, 2, 1, 3)
            plane = plane.reshape(c.rows * 8, c.stride * 8)
            # the component's own samples: ceil(size x factor / max factor)
            dw = -(-width * c.h // self.hmax)
            dh = -(-height * c.v // self.vmax)
            planes.append(_upsample(plane[:dh, :dw], self.hmax // c.h, self.vmax // c.v,
                                    c.h, c.v, self.hmax, self.vmax)[:height, :width])
        out = np.empty((height, width, 4), np.uint8)
        out[..., 3] = 255
        if len(planes) == 1:
            out[..., :3] = planes[0][..., None]
            return out
        if self._is_rgb():
            for i in range(3):
                out[..., i] = planes[i]
            return out
        out[..., :3] = _ycc_to_rgb(*planes)
        return out

    def _is_rgb(self) -> bool:
        """libjpeg's guess of a 3-component colour space (jdapimin.c
        default_decompress_parms): JFIF means YCbCr, else Adobe's
        transform 0 RGB, else component ids 'R', 'G', 'B'."""
        if self.jfif:
            return False
        if self.adobe is not None:
            return self.adobe == 0
        return [c.id for c in self.comps] == [82, 71, 66]


# ---- the accurate integer IDCT (jidctint.c jpeg_idct_islow) ---------------------------------

_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_1d(x, shift):
    """One pass over the last axis of int64 [..., 8]; outputs descaled by
    `shift` bits with rounding (DESCALE). The pass-1 input is x << 0 and
    the DC-only shortcuts of jidctint.c give the same values."""
    z2, z3 = x[..., 2], x[..., 6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (x[..., 0] + x[..., 4]) << _CONST_BITS
    tmp1 = (x[..., 0] - x[..., 4]) << _CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * _F1175
    o0, o1, o2, o3 = o0 * _F0298, o1 * _F2053, o2 * _F3072, o3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    o0 += z1 + z3
    o1 += z2 + z4
    o2 += z2 + z3
    o3 += z1 + z4
    half = 1 << (shift - 1)
    return np.stack([t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                     t13 - o0, t12 - o1, t11 - o2, t10 - o3], axis=-1) + half >> shift


def _idct_islow(blocks: np.ndarray) -> np.ndarray:
    """Dequantised int64 [N, 8, 8] (row = vertical frequency) -> uint8
    samples [N, 8, 8], level-shifted and clamped as libjpeg-turbo's SIMD
    routine clamps."""
    ws = _idct_1d(blocks.transpose(0, 2, 1), _CONST_BITS - _PASS1_BITS)  # columns
    out = _idct_1d(ws.transpose(0, 2, 1), _CONST_BITS + _PASS1_BITS + 3)  # rows
    return np.clip(out + 128, 0, 255).astype(np.uint8)


# ---- upsampling (jdsample.c) and colour (jdcolor.c) ------------------------------------------

def _neighbour(n: int, axis_len: int) -> np.ndarray:
    """For each output sample of a 2x upsampling of `axis_len` samples:
    its nearer input sample and the next nearer, the edge repeated."""
    out = np.arange(2 * axis_len)
    near = out // 2
    far = np.clip(np.where(out % 2, near + 1, near - 1), 0, axis_len - 1)
    return near, far


def _upsample(plane, fx, fy, h, v, hmax, vmax):
    """A component's [dh, dw] samples -> the full grid, as libjpeg-turbo's
    jinit_upsampler picks the method for (h, v) against (hmax, vmax)."""
    p = plane.astype(np.int32)
    dh, dw = p.shape
    odd_x = np.arange(2 * dw) % 2
    odd_y = (np.arange(2 * dh) % 2)[:, None]
    if fx == 1 and fy == 1:
        return plane
    if fx == 2 and fy == 1 and dw > 2:  # h2v1 fancy: 3/4, 1/4 with biases 1, 2
        near, far = _neighbour(2, dw)
        return ((3 * p[:, near] + p[:, far] + 1 + odd_x) >> 2).astype(np.uint8)
    if fx == 1 and fy == 2:  # h1v2 fancy, at any width
        near, far = _neighbour(2, dh)
        return ((3 * p[near] + p[far] + 1 + odd_y) >> 2).astype(np.uint8)
    if fx == 2 and fy == 2 and dw > 2:  # h2v2 fancy: column sums, biases 8, 7
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


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """uint8 Y, Cb, Cr planes -> uint8 [..., 3] RGB (jdcolor.c ycc_rgb_convert)."""
    y = y.astype(np.int32)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(raw: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 4], as Pillow's convert("RGBA"). Data
    the parser cannot follow (a table id or segment past its end) raises
    ValueError."""
    try:
        return _Decoder(bytes(raw)).run()
    except (IndexError, KeyError, struct.error) as e:
        raise ValueError(f"JPEG data is corrupt: {type(e).__name__}: {e}") from e
