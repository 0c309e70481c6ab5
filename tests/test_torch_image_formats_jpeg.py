"""The port's JPEG decoder (rustic_tpu_torch/utils/jpeg.py, its entropy
loops in csrc/image_entropy.cpp) against Pillow 12.1.0 and its
libjpeg-turbo 3.1.3, bit for bit, beyond the files Pillow writes.

- libjpeg's recovery from corrupt data: junk before a marker, scans cut
  and closed by an EOI, bits flipped, restart markers dropped or
  renumbered, progressive files missing their last scans (block
  smoothing), each a row of what the decoder got wrong before, and
  hypothesis over such edits of the committed fixtures: where Pillow
  decodes, the pixels are equal; where it raises, the port refuses.
- Four components: Pillow's CMYK, libjpeg's YCCK, and an Adobe segment
  edited to say YCCK; a BLP1 JPEG of four components and IPTC records
  holding the new kinds.
- Arithmetic coding (SOF9, SOF10) and lossless files (SOF3): written by
  libjpeg-turbo itself (the system's libjpeg for arithmetic coding,
  Pillow's bundled one for lossless, through the small encoder of
  tests/jpeg_encoder.cpp, built by g++ at first use), and by this
  module's own writers: `arith_transcode` re-codes a Huffman file's
  coefficients with T.81's arithmetic coder (sequential or progressive,
  restart intervals, DAC conditioning), `lossless_file` writes Annex H
  files (predictors 1-7, point transforms, restarts, sampling). Each
  writer is held to an oracle: an arithmetic transcoding decodes in
  Pillow to the original's pixels, a lossless file at point transform 0
  to its source samples.
- Refusals by name (hierarchical, arithmetic-coded lossless), what
  Pillow's header reader passes on (12-bit, a DNL height), the
  arithmetic decoder's limit under Pillow's 64 KiB feeding, and "MPO".

The fixtures of tests/data_torch/formats_jpeg (read by chip_smoke.py's
`formats` phase on the card's host, which has no Pillow) are written by
`make_jpeg_fixtures`: `python -m tests.test_torch_image_formats_jpeg`
rewrites them.
"""

import ctypes.util
import functools
import glob
import io
import json
import os
import struct
import subprocess
import tempfile

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import PIL
from rustic_tpu_torch.utils import jpeg
from rustic_tpu_torch.utils.png import decode_image_u8, image_format
from tests.test_torch_image_formats import (SCENES, blp1_jpeg, blp_file, glb_images, iptc_file,
                                            picture, pillow, read_glb, replace_glb_images, save,
                                            segments, sha256_rgba, with_sof)

JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch",
                             "formats_jpeg")
BT_EXT = "BreakTime-JPEG-ext.glb"
BT_EXT_TWIN = "BreakTime-JPEG-ext-twin.glb"
# BreakTime-JPEG-ext's textures, in the GLB's image order
EXT_TEXTURES = ["CMYK", "YCCK", "arithmetic progressive, restarts", "lossless",
                "baseline, junk before a marker and a dropped RST", "arithmetic sequential"]


def outcome(raw: bytes):
    """Pillow's decode of `raw`, or the exception it raises."""
    try:
        return pillow(raw)
    except Exception as e:  # noqa: BLE001 - any refusal is compared as a refusal
        return e


def assert_as_pillow(raw: bytes):
    """The port decodes `raw` to Pillow's pixels, or refuses it where Pillow does."""
    want = outcome(raw)
    if isinstance(want, Exception):
        with pytest.raises((ValueError, NotImplementedError)):
            decode_image_u8(raw)
        return
    np.testing.assert_array_equal(decode_image_u8(raw), want)


def scan_span(raw: bytes):
    """The first scan's entropy-coded bytes: (start, end before EOI)."""
    sos = raw.index(b"\xff\xda")
    return sos + 2 + struct.unpack(">H", raw[sos + 2 : sos + 4])[0], len(raw) - 2


# ---- libjpeg-turbo's own encoders --------------------------------------------------------------

SYSTEM_LIBJPEG = ctypes.util.find_library("jpeg")  # the system's libjpeg-turbo: arithmetic coding
PILLOW_LIBJPEG = (glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs",
                                         "libjpeg-*.so*")) or [None])[0]  # 3.1.3: lossless


@functools.lru_cache(maxsize=None)
def encoder_binary() -> str:
    """tests/jpeg_encoder.cpp, built by g++ into a temporary directory."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg_encoder.cpp")
    out = os.path.join(tempfile.mkdtemp(prefix="jpeg_encoder_"), "jpeg_encoder")
    subprocess.run(["g++", "-O2", "-o", out, src, "-ldl"], check=True, capture_output=True)
    return out


def libjpeg(px: np.ndarray, lib=None, in_space=2, jpeg_space=3, quality=75, arith=True,
            progressive=False, restart=0, psv=0, pt=0, sampling="-") -> bytes:
    """A JPEG of uint8 [H, W] or [H, W, C] written by libjpeg-turbo's
    encoder (`lib`: the system's, or PILLOW_LIBJPEG for lossless files)."""
    h, w = px.shape[:2]
    n = 1 if px.ndim == 2 else px.shape[2]
    args = [encoder_binary(), lib or SYSTEM_LIBJPEG, w, h, n, in_space, jpeg_space, quality,
            int(arith), int(progressive), restart, psv, pt, sampling]
    out = subprocess.run([str(a) for a in args], input=np.ascontiguousarray(px).tobytes(),
                         capture_output=True)
    if out.returncode:
        raise RuntimeError(out.stderr.decode())
    return out.stdout


# ---- the tests' arithmetic coder (T.81 Annex D, F.1.4 and G.1.3) -------------------------------

QE = [(0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
      (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
      (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
      (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
      (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
      (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
      (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
      (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
      (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
      (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
      (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
      (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
      (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
      (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
      (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
      (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
      (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
      (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
      (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
      (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
      (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
      (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
      (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
      (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
      (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
      (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
      (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
      (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
      (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]  # T.81 Table D.2, then the fixed 0.5


class QMCoder:
    """T.81's arithmetic encoder (D.1), its statistics areas by table id."""

    def __init__(self, dac):
        self.dac = dac  # table id -> (L, U, Kx)
        self.out = bytearray()
        self.reset_coder()
        self.dc = [bytearray(64) for _ in range(16)]
        self.ac = [bytearray(256) for _ in range(16)]
        self.fixed = bytearray([113])

    def reset_coder(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, byte):
        self.out.append(byte)
        if byte == 0xFF:
            self.out.append(0)

    def _flush_stack(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self.out += bytes(self.zc)
            self.zc = 0
            self._emit(self.buffer)
        if self.sc:
            self.out += bytes(self.zc)
            self.zc = 0
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def _carry(self):
        if self.buffer >= 0:
            self.out += bytes(self.zc)
            self.zc = 0
            self._emit(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def encode(self, stats, i, val):
        sv = stats[i]
        qe, nl, nm, switch = QE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ (nl | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nm
        while True:  # renormalise, a byte out every 8 shifts
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stack()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        """D.1.8: the shortest tail that ends inside the interval."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._flush_stack()
        if self.c & 0x7FFF800:
            self.out += bytes(self.zc)
            self.zc = 0
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        data, self.out = bytes(self.out), bytearray()
        self.reset_coder()
        return data

    # the coding model
    def value(self, stats, st, v, cat_base, big):
        """F.1.4.4.1.3 / F.1.4.4.2: the magnitude category and bits of a
        nonzero value after its sign (st: the first category bin)."""
        m, v = 0, abs(v) - 1
        if v:
            self.encode(stats, st, 1)
            m, v2 = 1, v
            if big is not None:  # AC: a second bin at S0 + 2 before X2
                v2 >>= 1
                if v2:
                    self.encode(stats, st, 1)
                    m <<= 1
                    st = big
                    while v2 >> 1:
                        v2 >>= 1
                        self.encode(stats, st, 1)
                        m <<= 1
                        st += 1
                else:
                    self.encode(stats, st, 0)
                    return
            else:
                st = cat_base
                while v2 >> 1:
                    v2 >>= 1
                    self.encode(stats, st, 1)
                    m <<= 1
                    st += 1
        self.encode(stats, st, 0)
        st += 14
        while m >> 1:
            m >>= 1
            self.encode(stats, st, 1 if m & v else 0)

    def dc_diff(self, tbl, ctx, diff):
        """A DC difference in context `ctx` -> the next context."""
        stats = self.dc[tbl]
        if diff == 0:
            self.encode(stats, ctx, 0)
            return 0
        self.encode(stats, ctx, 1)
        sign = diff < 0
        self.encode(stats, ctx + 1, int(sign))
        st = ctx + 2 + sign
        m = abs(diff) - 1
        cat = 0 if m == 0 else 1 << (m.bit_length() - 1)
        self.value(stats, st, diff, 20, None)
        low, high = self.dac[tbl][0], self.dac[tbl][1]
        if cat < (1 << low) >> 1:
            return 0
        return (12 if cat > (1 << high) >> 1 else 4) + 4 * sign

    def ac_band(self, tbl, values, ss, se):
        """F.1.4.2 / G.1.3.2: the coefficients ss..se of one block (already
        shifted by the point transform)."""
        stats = self.ac[tbl]
        kx = self.dac[tbl][2]
        end = max([k for k in range(ss, se + 1) if values[k]] or [ss - 1])
        k = ss
        while k <= end:
            st = 3 * (k - 1)
            self.encode(stats, st, 0)  # not the end of the band
            while values[k] == 0:
                self.encode(stats, st + 1, 0)
                st += 3
                k += 1
            self.encode(stats, st + 1, 1)
            v = values[k]
            self.encode(self.fixed, 0, int(v < 0))
            self.value(stats, st + 2, v, None, 189 if k <= kx else 217)
            k += 1
        if k <= se:
            self.encode(stats, 3 * (k - 1), 1)

    def ac_refine(self, tbl, block, ss, se, ah, al):
        """G.1.3.3: bit `al` of the coefficients ss..se of one block."""
        stats = self.ac[tbl]

        def shifted(k, by):
            return abs(int(block[k])) >> by

        end = max([k for k in range(ss, se + 1) if shifted(k, al)] or [0])
        prev_end = max([k for k in range(ss, end + 1) if shifted(k, ah)] or [0])
        k = ss
        while k <= end:
            st = 3 * (k - 1)
            if k > prev_end:
                self.encode(stats, st, 0)
            while True:
                v = shifted(k, al)
                if v:
                    if v >> 1:
                        self.encode(stats, st + 2, v & 1)
                    else:
                        self.encode(stats, st + 1, 1)
                        self.encode(self.fixed, 0, int(block[k] < 0))
                    break
                self.encode(stats, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= se:
            self.encode(stats, 3 * (k - 1), 1)


def simple_progression(n: int):
    """libjpeg's jpeg_simple_progression script: (components, Ss, Se, Ah, Al)."""
    if n == 3:
        return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                ((0,), 1, 63, 1, 0)]
    return ([(tuple(range(n)), 0, 0, 0, 1)]
            + [((c,), 1, 5, 0, 2) for c in range(n)] + [((c,), 6, 63, 0, 2) for c in range(n)]
            + [((c,), 1, 63, 2, 1) for c in range(n)] + [(tuple(range(n)), 0, 0, 1, 0)]
            + [((c,), 1, 63, 1, 0) for c in range(n)])


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def arith_transcode(raw: bytes, progressive=False, restart=0, dac=None, script=None,
                    tables=None) -> bytes:
    """The Huffman JPEG `raw`, its coefficients (as the port decodes them)
    re-coded with the arithmetic coder: `script`'s scans ((components, Ss,
    Se, Ah, Al) each), by default one interleaved sequential scan (SOF9)
    or libjpeg's simple progression (SOF10);
    a restart every `restart` MCUs; `dac` {table id: (L, U, Kx)} written in
    a DAC segment; `tables` the (DC, AC) table id of each component."""
    d = jpeg._Decoder(raw)
    d.run()
    comps = d.comps
    tables = tables or [(min(i, 1), min(i, 1)) for i in range(len(comps))]
    cond = {t: (0, 1, 5) for t in range(16)}
    cond.update(dac or {})
    segs, _ = segments(raw)
    head = b"\xff\xd8"
    for m, body in segs:
        if m == 0xC4:
            continue
        if m in (0xC0, 0xC1, 0xC2):
            m = 0xCA if progressive else 0xC9
        head += _segment(m, body)
    if dac:
        head += _segment(0xCC, b"".join(
            bytes([t, (u << 4) | low, 16 + t, k]) for t, (low, u, k) in sorted(dac.items())))
    if restart:
        head += _segment(0xDD, struct.pack(">H", restart))
    blocks = [d.coef[c.base : c.base + c.stride * c.rows * 64].reshape(c.rows, c.stride, 64)
              .astype(np.int64) for c in comps]
    if script is None:
        script = (simple_progression(len(comps)) if progressive
                  else [(tuple(range(len(comps))), 0, 63, 0, 0)])
    out = head
    for members, ss, se, ah, al in script:
        body = bytes([len(members)]) + b"".join(
            bytes([comps[c].id, tables[c][0] << 4 | tables[c][1]]) for c in members)
        out += _segment(0xDA, body + bytes([ss, se, ah << 4 | al]))
        qm = QMCoder(cond)
        if len(members) == 1:
            c = comps[members[0]]
            mcus = [[(members[0], y, x)] for y in range(c.bh) for x in range(c.bw)]
        else:
            mcus = [[(ci, my * comps[ci].v + dy, mx * comps[ci].h + dx) for ci in members
                     for dy in range(comps[ci].v) for dx in range(comps[ci].h)]
                    for my in range(d.mcuy) for mx in range(d.mcux)]
        last, ctx = {}, {}
        data = b""
        for i, mcu in enumerate(mcus):
            if restart and i and i % restart == 0:
                data += qm.finish() + bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
                qm.dc = [bytearray(64) for _ in range(16)]
                qm.ac = [bytearray(256) for _ in range(16)]
                last, ctx = {}, {}
            for ci, y, x in mcu:
                b = blocks[ci][y, x]
                td, ta = tables[ci]
                if ss == 0 and ah == 0:  # DC first (or sequential)
                    v = int(b[0]) >> al
                    ctx[ci] = qm.dc_diff(td, ctx.get(ci, 0), v - last.get(ci, 0))
                    last[ci] = v
                elif ss == 0:
                    qm.encode(qm.fixed, 0, (int(b[0]) >> al) & 1)
                if se > 0 and ah == 0:
                    lo = max(ss, 1)
                    vals = [0] * 64
                    for k in range(lo, se + 1):
                        v = int(b[k])
                        vals[k] = (abs(v) >> al) * (1 if v >= 0 else -1)
                    qm.ac_band(ta, vals, lo, se)
                elif se > 0:
                    qm.ac_refine(ta, b, ss, se, ah, al)
        out += data + qm.finish()
    return out + b"\xff\xd9"


# ---- the tests' lossless writer (T.81 Annex H) ----------------------------------------------

# one Huffman table for the 17 difference categories: 6 codes of 3 bits, then 2 of each length
# 4-8 and 1 of 9 (no code all ones)
LOSSLESS_COUNTS = bytes([0, 0, 6, 2, 2, 2, 2, 2, 1] + [0] * 7)
LOSSLESS_SYMBOLS = bytes([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16])


def _huffman_codes(counts, symbols):
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, bits):
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.n += bits
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)

    def finish(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)  # pad with ones
        data, self.out, self.acc, self.n = bytes(self.out), bytearray(), 0, 0
        return data


def _predict(psv, ra, rb, rc):
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]


def lossless_file(planes, sampling, psv=1, pt=0, restart_rows=0, ids=None, app=b"") -> bytes:
    """A lossless JPEG (SOF3, one interleaved scan) of uint8 component
    planes, each [ceil(H v / vmax), ceil(W h / hmax)] for its (h, v) in
    `sampling`: predictor `psv`, point transform `pt`, a restart every
    `restart_rows` MCU rows, component ids `ids`, `app` segments before
    the frame."""
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    width = next(p.shape[1] for p, (h, _) in zip(planes, sampling) if h == hmax)
    height = next(p.shape[0] for p, (_, v) in zip(planes, sampling) if v == vmax)
    n = len(planes)
    ids = ids or list(range(1, n + 1))
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    head = b"\xff\xd8" + app + _segment(0xC3, struct.pack(">BHHB", 8, height, width, n) + b"".join(
        bytes([ids[i], h << 4 | v, 0]) for i, (h, v) in enumerate(sampling)))
    head += _segment(0xC4, bytes([0]) + LOSSLESS_COUNTS + LOSSLESS_SYMBOLS)
    restart = restart_rows * mcux
    if restart:
        head += _segment(0xDD, struct.pack(">H", restart))
    head += _segment(0xDA, bytes([n]) + b"".join(bytes([ids[i], 0]) for i in range(n))
                     + bytes([psv, 0, pt]))
    codes = _huffman_codes(LOSSLESS_COUNTS, LOSSLESS_SYMBOLS)
    vals = [p.astype(np.int64) >> pt for p in planes]
    bw = BitWriter()
    data = b""
    first = [True] * n  # the component's next row is the first of its interval
    for my in range(mcuy):
        if restart and my and my % restart_rows == 0:
            data += bw.finish() + bytes([0xFF, 0xD0 + (my // restart_rows - 1) % 8])
            first = [True] * n
        for mx in range(mcux):
            for ci, (h, v) in enumerate(sampling):
                pv = vals[ci]
                for dy in range(v):
                    for dx in range(h):
                        y, x = my * v + dy, mx * h + dx
                        if y >= pv.shape[0] or x >= pv.shape[1]:
                            diff = 0  # a dummy sample, which decoders drop
                        else:
                            row_first = first[ci] and dy == 0  # the interval's first row
                            if row_first and x == 0:
                                pred = 1 << (8 - pt - 1)
                            elif row_first:
                                pred = int(pv[y, x - 1])
                            elif x == 0:
                                pred = int(pv[y - 1, 0])
                            else:
                                pred = _predict(psv, int(pv[y, x - 1]), int(pv[y - 1, x]),
                                                int(pv[y - 1, x - 1]))
                            diff = (int(pv[y, x]) - pred) & 0xFFFF
                            diff -= 0x10000 if diff >= 0x8000 else 0
                        cat = 16 if diff == -32768 else abs(diff).bit_length()
                        code, length = codes[cat]
                        bw.put(code, length)
                        if 0 < cat < 16:
                            bw.put(diff if diff > 0 else diff + (1 << cat) - 1, cat)
            if mx == mcux - 1:
                first = [False] * n
    return head + data + bw.finish() + b"\xff\xd9"


def planes_of(px: np.ndarray, sampling):
    """A [H, W, C] image's component planes, each cut by box-filter-free
    decimation to its sampling (every hmax/h-th sample)."""
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    return [np.ascontiguousarray(px[:: vmax // v, :: hmax // h, i])
            for i, (h, v) in enumerate(sampling)]


def test_lossless_writer_decodes_to_its_samples():
    """The writer's oracle: at point transform 0, Pillow decodes a
    lossless file of each predictor to its source samples (RGB ids, and
    grey)."""
    px = picture(19, 27, 4)
    for psv in range(1, 8):
        raw = lossless_file(planes_of(px, [(1, 1)] * 3), [(1, 1)] * 3, psv, 0, psv % 3,
                            ids=[82, 71, 66])
        np.testing.assert_array_equal(pillow(raw)[..., :3], px)
    raw = lossless_file([px[..., 0]], [(1, 1)], 5, 0, 2)
    np.testing.assert_array_equal(pillow(raw)[..., 0], px[..., 0])


def test_arith_transcode_decodes_to_the_originals_pixels():
    """The arithmetic writer's oracle: Pillow decodes each transcoding of
    a Huffman file to that file's own pixels."""
    for kw in (dict(), dict(subsampling=2), dict(progressive=True, subsampling=1)):
        raw = save(Image.fromarray(picture(29, 43, 5)), "JPEG", quality=85, **kw)
        want = pillow(raw)
        for tk in (dict(), dict(progressive=True), dict(restart=3),
                   dict(progressive=True, restart=2, dac={0: (1, 4, 2), 1: (0, 0, 9)}),
                   dict(script=[((c,), 0, 63, 0, 0) for c in (2, 0, 1)], restart=2)):
            coded = arith_transcode(raw, **tk)
            assert coded.find(b"\xff\xca" if tk.get("progressive") else b"\xff\xc9") > 0
            np.testing.assert_array_equal(pillow(coded), want)


# ---- the rows of what the decoder got wrong before --------------------------------------------

def random_jpeg(seed: int, size=(24, 40), **kw) -> bytes:
    """A Pillow JPEG of random pixels."""
    rng = np.random.default_rng(seed)
    return save(Image.fromarray(rng.integers(0, 256, (*size, 3), np.uint8)), "JPEG", **kw)


def test_junk_bytes_before_sos_are_skipped():
    raw = random_jpeg(1)
    sos = raw.index(b"\xff\xda")
    edited = raw[:sos] + b"\x12\x34" + raw[sos:]
    np.testing.assert_array_equal(decode_image_u8(edited), pillow(edited))


def test_scan_cut_in_its_middle_with_eoi_appended():
    raw = random_jpeg(2)
    a, b = scan_span(raw)
    edited = raw[: (a + b) // 2] + b"\xff\xd9"
    np.testing.assert_array_equal(decode_image_u8(edited), pillow(edited))


# offsets each read otherwise without libjpeg's rules
@pytest.mark.parametrize("offset", [5, 14, 91, 245, 490])
def test_one_bit_flipped_in_the_scan(offset):
    raw = random_jpeg(3)
    a, _ = scan_span(raw)
    edited = bytearray(raw)
    edited[a + offset] ^= 0x10
    edited = bytes(edited)
    np.testing.assert_array_equal(decode_image_u8(edited), pillow(edited))


def test_rst2_dropped_from_a_restart_file():
    raw = random_jpeg(4, (48, 64), restart_marker_blocks=2)
    rst2 = raw.index(b"\xff\xd2")
    edited = raw[:rst2] + raw[rst2 + 2 :]
    np.testing.assert_array_equal(decode_image_u8(edited), pillow(edited))


def test_progressive_file_without_its_last_scan_is_smoothed():
    raw = random_jpeg(5, progressive=True)
    last = raw.rindex(b"\xff\xda")
    edited = raw[:last] + b"\xff\xd9"
    np.testing.assert_array_equal(decode_image_u8(edited), pillow(edited))


def test_pillows_cmyk_jpeg():
    rng = np.random.default_rng(6)
    raw = save(Image.fromarray(rng.integers(0, 256, (24, 40, 4), np.uint8), "CMYK"), "JPEG")
    np.testing.assert_array_equal(decode_image_u8(raw), pillow(raw))


# ---- four components, arithmetic and lossless files of libjpeg-turbo's encoders ---------------

def with_adobe_transform(raw: bytes, transform: int) -> bytes:
    """The file with its APP14 Adobe segment's transform byte set."""
    i = raw.index(b"Adobe")
    return raw[: i + 11] + bytes([transform]) + raw[i + 12 :]


def cmyk_px(h, w, seed):
    return np.concatenate([picture(h, w, seed), picture(h, w, seed + 1)[..., :1]], -1)


FOUR = {
    "Pillow CMYK, progressive": lambda: save(
        Image.fromarray(cmyk_px(21, 33, 1), "CMYK"), "JPEG", progressive=True),
    "Pillow CMYK edited to YCCK": lambda: with_adobe_transform(
        save(Image.fromarray(cmyk_px(21, 33, 2), "CMYK"), "JPEG"), 2),
    "Pillow CMYK edited to transform 1": lambda: with_adobe_transform(
        save(Image.fromarray(cmyk_px(21, 33, 3), "CMYK"), "JPEG"), 1),
    "CMYK without an Adobe segment": lambda: libjpeg(
        cmyk_px(21, 33, 4), in_space=4, jpeg_space=4, arith=False).replace(b"Adobe", b"Adobx"),
    "libjpeg YCCK 4:2:0": lambda: libjpeg(cmyk_px(21, 33, 5), in_space=4, jpeg_space=5,
                                          arith=False, sampling="2,2,1,1,1,1,2,2"),
    "libjpeg YCCK arithmetic progressive": lambda: libjpeg(
        cmyk_px(21, 33, 6), in_space=4, jpeg_space=5, progressive=True),
    "lossless CMYK": lambda: libjpeg(cmyk_px(21, 33, 7), PILLOW_LIBJPEG, 4, 4, arith=False,
                                     psv=3),
}


@pytest.mark.parametrize("case", list(FOUR))
def test_four_components_match_pillow(case):
    raw = FOUR[case]()
    assert decode_image_u8(raw).shape == (21, 33, 4)
    np.testing.assert_array_equal(decode_image_u8(raw), pillow(raw))


LIBJPEG = {
    f"arithmetic {'progressive' if p else 'sequential'} {s} restart {r}": (
        lambda p=p, s=s, r=r: libjpeg(picture(37, 45, 8), progressive=p, restart=r, sampling=s))
    for p in (False, True) for s in ("1,1,1,1,1,1", "2,2,1,1,1,1", "1,2,1,1,1,1") for r in (0, 3)}
LIBJPEG.update({
    "arithmetic grey": lambda: libjpeg(picture(37, 45, 9)[..., 0], in_space=1, jpeg_space=1),
    "arithmetic grey progressive": lambda: libjpeg(picture(37, 45, 10)[..., 1], in_space=1,
                                                   jpeg_space=1, progressive=True, restart=1),
    "arithmetic RGB": lambda: libjpeg(picture(37, 45, 11), jpeg_space=2, quality=95),
    "arithmetic 3x2 4:2:0": lambda: libjpeg(picture(3, 2, 12), sampling="2,2,1,1,1,1"),
    **{f"lossless psv {psv} pt {pt}": (lambda psv=psv, pt=pt: libjpeg(
        picture(23, 31, psv), PILLOW_LIBJPEG, arith=False, psv=psv, pt=pt))
       for psv in range(1, 8) for pt in (0, 3)},
    "lossless RGB": lambda: libjpeg(picture(23, 31, 13), PILLOW_LIBJPEG, jpeg_space=2,
                                    arith=False, psv=1),
    "lossless restarts": lambda: libjpeg(picture(23, 31, 14), PILLOW_LIBJPEG, arith=False,
                                         psv=7, restart=62),
    "lossless grey": lambda: libjpeg(picture(23, 31, 15)[..., 2], PILLOW_LIBJPEG, 1, 1,
                                     arith=False, psv=6, pt=1),
})


@pytest.mark.parametrize("case", list(LIBJPEG))
def test_libjpeg_encoders_files_match_pillow(case):
    raw = LIBJPEG[case]()
    marker = 0xC3 if case.startswith("lossless") else 0xCA if "progressive" in case else 0xC9
    assert raw.find(bytes([0xFF, marker])) > 0
    np.testing.assert_array_equal(decode_image_u8(raw), pillow(raw))


@settings(max_examples=100, deadline=None, derandomize=True)
@given(h=st.integers(1, 30), w=st.integers(1, 30), quality=st.integers(5, 100),
       sampling=st.sampled_from([0, 1, 2]), grey=st.booleans(), progressive=st.booleans(),
       restart=st.integers(0, 4), dac=st.dictionaries(st.integers(0, 1), st.tuples(
           st.integers(0, 3), st.integers(3, 15), st.integers(1, 63)), max_size=2),
       apart=st.booleans(), seed=st.integers(0, 2**16))
def test_arithmetic_transcodings_match_pillow(h, w, quality, sampling, grey, progressive,
                                              restart, dac, apart, seed):
    """Sequential (one interleaved scan, or with `apart` a scan for each
    component) or progressive arithmetic files of Pillow's coefficients."""
    px = picture(h, w, seed)
    img = Image.fromarray(px[..., 0] if grey else px)
    raw = save(img, "JPEG", quality=quality, **({} if grey else dict(subsampling=sampling)))
    script = [((c,), 0, 63, 0, 0) for c in range(1 if grey else 3)] if apart and not (
        progressive) else None
    assert_as_pillow(arith_transcode(raw, progressive, restart, dac, script))


@settings(max_examples=100, deadline=None, derandomize=True)
@given(h=st.integers(1, 24), w=st.integers(1, 24), psv=st.integers(1, 7), pt=st.integers(0, 7),
       sampling=st.sampled_from([[(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)],
                                 [(1, 1)]]), restart=st.integers(0, 3),
       ids=st.sampled_from([None, [82, 71, 66], [7, 8, 9]]), seed=st.integers(0, 2**16))
def test_lossless_writer_files_match_pillow(h, w, psv, pt, sampling, restart, ids, seed):
    px = picture(max(h, 2), max(w, 2), seed)
    raw = lossless_file(planes_of(px, sampling), sampling, psv, pt, restart,
                        ids=ids[: len(sampling)] if ids else None)
    assert_as_pillow(raw)


def test_lossless_colour_guess_is_libjpegs():
    """Component ids other than 'R', 'G', 'B' (1, 2, 3 among them) mean
    RGB in a lossless file, YCbCr in a DCT one; JFIF means YCbCr, which
    libjpeg will not convert in a lossless file: refused as Pillow
    refuses it, as are Adobe's transforms 1 and 2 there."""
    px = picture(9, 11, 16)
    planes = planes_of(px, [(1, 1)] * 3)
    jfif = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for ids in ([7, 8, 9], [1, 2, 3]):
        raw = lossless_file(planes, [(1, 1)] * 3, 1, 0, ids=ids)
        np.testing.assert_array_equal(decode_image_u8(raw)[..., :3], px)
        np.testing.assert_array_equal(decode_image_u8(raw), pillow(raw))
    adobe = libjpeg(px, PILLOW_LIBJPEG, arith=False, psv=3)
    for raw in (lossless_file(planes, [(1, 1)] * 3, 1, 0, ids=[7, 8, 9], app=jfif),
                with_adobe_transform(adobe, 1), with_adobe_transform(adobe, 2),
                with_adobe_transform(FOUR["lossless CMYK"](), 2)):
        with pytest.raises(OSError, match="broken data stream"):
            pillow(raw)
        with pytest.raises(ValueError, match="YCbCr or YCCK"):
            decode_image_u8(raw)
    np.testing.assert_array_equal(decode_image_u8(with_adobe_transform(adobe, 0)), pillow(adobe))


# ---- Pillow's feeding and the refusals ------------------------------------------------------

def test_arithmetic_data_past_pillows_first_block_is_refused_as_pillow_refuses_it():
    """libjpeg's arithmetic decoder cannot suspend: Pillow's 64 KiB blocks
    end a larger arithmetic file's decode ("broken data stream")."""
    rng = np.random.default_rng(17)
    raw = libjpeg(rng.integers(0, 256, (260, 300, 3), np.uint8), quality=95)
    assert len(raw) > jpeg.FEED
    with pytest.raises(OSError, match="broken data stream"):
        pillow(raw)
    with pytest.raises(ValueError, match="arithmetic-coded data past"):
        decode_image_u8(raw)


def test_huffman_files_past_64k_decode_across_pillows_blocks():
    """The fast Huffman path (512 bytes a block buffered) and Pillow's
    64 KiB blocks: bit flips around the first block's end decode as
    Pillow decodes them."""
    raw = save(Image.fromarray(picture(260, 320, 18)), "JPEG", quality=97)
    assert len(raw) > jpeg.FEED + 4096
    for k, offset in enumerate((-700, -3, 0, 9, 1500)):
        edited = bytearray(raw)
        edited[jpeg.FEED + offset] ^= 1 << (k % 8)
        assert_as_pillow(bytes(edited))


def sof_body(raw):
    segs, _ = segments(raw)
    return next(b for m, b in segs if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC))


REFUSALS = {
    "hierarchical (SOF5)": lambda: with_sof(random_jpeg(7), 0xC5),
    "hierarchical progressive (SOF6)": lambda: with_sof(random_jpeg(8, progressive=True), 0xC6),
    "hierarchical lossless (SOF7)": lambda: libjpeg(picture(8, 8, 1), PILLOW_LIBJPEG, arith=False,
                                                    psv=1).replace(b"\xff\xc3", b"\xff\xc7", 1),
    "arithmetic-coded hierarchical (SOF13)": lambda: libjpeg(picture(8, 8, 2)).replace(
        b"\xff\xc9", b"\xff\xcd", 1),
    "arithmetic-coded hierarchical progressive (SOF14)": lambda: libjpeg(
        picture(8, 8, 3), progressive=True).replace(b"\xff\xca", b"\xff\xce", 1),
    "arithmetic-coded hierarchical lossless (SOF15)": lambda: libjpeg(
        picture(8, 8, 4), PILLOW_LIBJPEG, arith=False, psv=1).replace(b"\xff\xc3", b"\xff\xcf", 1),
    "arithmetic-coded lossless (SOF11)": lambda: libjpeg(
        picture(8, 8, 5), PILLOW_LIBJPEG, arith=False, psv=1).replace(b"\xff\xc3", b"\xff\xcb", 1),
}


@pytest.mark.parametrize("variant", list(REFUSALS))
def test_what_libjpeg_refuses_is_refused_by_name(variant):
    raw = REFUSALS[variant]()
    with pytest.raises(OSError):
        pillow(raw)
    with pytest.raises(NotImplementedError, match=f"{variant.split(' (')[0]}.*ROADMAP"):
        decode_image_u8(raw)


def header_edit(raw: bytes, at: int, value: bytes) -> bytes:
    """The file with bytes of its frame header replaced from offset `at`."""
    i = raw.index(sof_body(raw))
    return raw[: i + at] + value + raw[i + at + len(value) :]


PASSED_ON = {
    "12-bit": lambda: header_edit(random_jpeg(9), 0, b"\x0c"),
    "2-layer": lambda: header_edit(random_jpeg(10), 5, b"\x02"),
    "a DNL marker": lambda: header_edit(random_jpeg(11), 1, b"\x00\x00"),
    "no marker found": lambda: random_jpeg(12).replace(b"\xff\xdb", b"\xff\x02\xff\xdb", 1),
}


@pytest.mark.parametrize("variant", list(PASSED_ON))
def test_what_pillows_header_reader_turns_away_passes_on(variant):
    """Pillow's _open raises SyntaxError (or IndexError, struct.error):
    Image.open tries the next plugin, and no other takes the file."""
    raw = PASSED_ON[variant]()
    with pytest.raises(PIL.UnidentifiedImageError):
        Image.open(io.BytesIO(raw))
    with pytest.raises(NotImplementedError, match=f"passed on by JPEG.*{variant}.*ROADMAP"):
        image_format(raw)


def test_truncated_files_raise_as_pillow_refuses_them():
    for raw in (random_jpeg(13)[:-40], libjpeg(picture(20, 20, 3))[:-30],
                libjpeg(picture(20, 20, 4), PILLOW_LIBJPEG, arith=False, psv=2)[:-20]):
        with pytest.raises(OSError):
            pillow(raw)
        with pytest.raises(ValueError):
            decode_image_u8(raw)


def test_markers_read_after_a_one_scan_image_are_libjpegs():
    """A flipped bit that makes FF C3 in a baseline scan: the scan ends
    there, and the marker reader then meets a second frame, which libjpeg
    refuses before it reads the segment (Pillow: broken data stream)."""
    raw = save(Image.fromarray(picture(45, 61, 2)), "JPEG", subsampling=0)
    a, b = scan_span(raw)
    i = next(k for k in range(a, b - 1) if raw[k] == 0x7F and raw[k + 1] == 0xC3)
    edited = raw[:i] + b"\xff" + raw[i + 1 :]
    with pytest.raises(OSError, match="broken data stream"):
        pillow(edited)
    with pytest.raises(ValueError, match="more than one frame"):
        decode_image_u8(edited)


@pytest.mark.parametrize("marker", [0xC0, 0xC4, 0xCC, 0xD8, 0xDA, 0xDB, 0xDC, 0xDD, 0xE0, 0xEE,
                                    0xF0, 0xFE, 0x01, 0x02])
@pytest.mark.parametrize("progressive", [False, True])
def test_a_marker_inside_a_scan_is_read_as_libjpeg_reads_it(marker, progressive):
    """FF and a marker code (and bytes that would be its length) inside
    the first scan's data: the scan ends there, and libjpeg's marker
    reader takes the marker, in a one-scan and in a progressive file."""
    raw = save(Image.fromarray(picture(40, 56, 7)), "JPEG", progressive=progressive)
    i = raw.index(b"\xff", scan_span(raw)[0] + 40)  # a byte boundary of the scan data
    for tail in (b"\x00\x04\x12\x34", b"\x7f\x31\x00\x42"):
        assert_as_pillow(raw[:i] + bytes([0xFF, marker]) + tail + raw[i:])


def test_table_segments_shorter_than_their_length_field_are_refused():
    """A DAC (DHT, DQT) length under 2 is libjpeg's "bogus marker length";
    a COM's is skipped."""
    raw = libjpeg(picture(20, 24, 3), progressive=True)
    dac = raw.index(b"\xff\xcc")
    for m, expect in ((0xCC, ValueError), (0xFE, None)):
        edited = raw[:dac] + bytes([0xFF, m, 0, 0]) + raw[dac:]
        if expect is None:
            np.testing.assert_array_equal(decode_image_u8(edited), pillow(edited))
            continue
        with pytest.raises(OSError):
            pillow(edited)
        with pytest.raises(expect, match="DAC segment of a bad length"):
            decode_image_u8(edited)


def test_a_second_scan_in_a_one_scan_file_is_refused_as_libjpeg_refuses_it():
    raw = random_jpeg(14)
    a, b = scan_span(raw)
    sos = raw.index(b"\xff\xda")
    doubled = raw[:b] + raw[sos:b] + b"\xff\xd9"
    assert_as_pillow(doubled)


def without_dht(raw: bytes) -> bytes:
    """The file with every DHT segment taken out."""
    out, pos = bytearray(raw[:2]), 2
    while pos < len(raw):
        if raw[pos : pos + 2] == b"\xff\xc4":
            pos += 2 + struct.unpack(">H", raw[pos + 2 : pos + 4])[0]
            continue
        out.append(raw[pos])
        pos += 1
    return bytes(out)


def test_missing_huffman_tables_are_libjpegs_standard_ones():
    """A sequential scan naming tables 0 and 1 that no DHT defines takes
    libjpeg's standard tables (motion JPEG); a progressive or lossless
    one is refused, as libjpeg refuses it."""
    raw = random_jpeg(15, optimize=False)
    np.testing.assert_array_equal(decode_image_u8(without_dht(raw)), pillow(raw))
    for raw in (random_jpeg(16, progressive=True, optimize=False),
                libjpeg(picture(20, 24, 1), PILLOW_LIBJPEG, arith=False, psv=2)):
        with pytest.raises(OSError):
            pillow(without_dht(raw))
        with pytest.raises(ValueError, match="Huffman table 0 is not defined"):
            decode_image_u8(without_dht(raw))


def test_mpo_is_named_as_pillow_names_it():
    one, two = (Image.fromarray(picture(17, 23, s)) for s in (1, 2))
    buf = io.BytesIO()
    one.save(buf, "MPO", save_all=True, append_images=[two])
    raw = buf.getvalue()
    assert Image.open(io.BytesIO(raw)).format == "MPO"
    assert image_format(raw) == "MPO"
    np.testing.assert_array_equal(decode_image_u8(raw), pillow(raw))
    assert image_format(save(one, "JPEG")) == "JPEG"


def test_blp1_jpeg_of_four_components_is_read_as_cmyk():
    """Pillow reads a BLP1 JPEG's four components as CMYK whatever its
    Adobe segment says (no YCCK), inverts them as "CMYK;I", converts to
    RGB and reads the bytes as BGR."""
    img = Image.fromarray(cmyk_px(16, 24, 20), "CMYK")
    for transform in (0, 2):
        jpg = with_adobe_transform(save(img, "JPEG", quality=90), transform)
        sos = jpg.index(b"\xff\xda")
        raw = blp_file(1, 24, 16, jpg[sos:], 0, 5, jpeg_header=jpg[:sos])
        np.testing.assert_array_equal(decode_image_u8(raw), pillow(raw))
    np.testing.assert_array_equal(decode_image_u8(blp1_jpeg(img.convert("RGB"))),
                                  pillow(blp1_jpeg(img.convert("RGB"))))


def test_iptc_records_hold_the_new_kinds():
    px = picture(9, 13, 21)
    for jpg in (save(Image.fromarray(cmyk_px(9, 13, 22), "CMYK"), "JPEG"),
                libjpeg(px, progressive=True),
                libjpeg(px, PILLOW_LIBJPEG, arith=False, psv=4)):
        raw = iptc_file(jpg, (13, 9), compression=5)
        assert Image.open(io.BytesIO(raw)).format == image_format(raw) == "IPTC"
        np.testing.assert_array_equal(decode_image_u8(raw), pillow(raw))


# ---- hypothesis over edits of the committed fixtures ----------------------------------------

def mutate(raw: bytes, kind: str, where: float, value: int) -> bytes:
    """One edit of a JPEG: a bit flipped in its data (or anywhere after
    SOI), a cut closed by an EOI, junk before a marker, an RST dropped or
    renumbered."""
    a, b = scan_span(raw) if b"\xff\xda" in raw else (2, len(raw))
    if kind in ("flip", "flip anywhere"):
        i = a + int(where * max(b - a - 1, 1)) if kind == "flip" else 2 + int(
            where * (len(raw) - 3))
        return raw[:i] + bytes([raw[i] ^ (1 << (value % 8))]) + raw[i + 1 :]
    if kind == "cut":
        return raw[: a + int(where * (len(raw) - a - 2))] + b"\xff\xd9"
    if kind == "junk":
        marks = [i for i in range(2, len(raw) - 1)
                 if raw[i] == 0xFF and raw[i + 1] not in (0, 255)]
        i = marks[int(where * (len(marks) - 1))]
        return raw[:i] + bytes([value & 0x7F, value >> 7 & 0xFF])[: 1 + value % 2] + raw[i:]
    rsts = [i for i in range(a, len(raw) - 1) if raw[i] == 0xFF and 0xD0 <= raw[i + 1] <= 0xD7]
    if not rsts:
        return raw
    i = rsts[int(where * (len(rsts) - 1))]
    if kind == "drop":
        return raw[:i] + raw[i + 2 :]
    return raw[: i + 1] + bytes([0xD0 + value % 8]) + raw[i + 2 :]


def jpeg_manifest() -> dict:
    with open(os.path.join(JPEG_FIXTURES, "manifest.json")) as f:
        return json.load(f)


def jpeg_fixture(name: str) -> bytes:
    with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
        return f.read()


SMALL_FIXTURES = [e["file"] for e in jpeg_manifest()["images"]
                  if "expect" in e and os.path.getsize(os.path.join(JPEG_FIXTURES, e["file"]))
                  < 20000] if os.path.exists(os.path.join(JPEG_FIXTURES, "manifest.json")) else []


@settings(max_examples=800, deadline=None, derandomize=True)
@given(name=st.sampled_from(SMALL_FIXTURES),
       kind=st.sampled_from(["flip", "flip anywhere", "cut", "junk", "drop", "renumber"]),
       where=st.floats(0, 1), value=st.integers(0, 2**15))
def test_edited_fixtures_decode_as_pillow_decodes_them(name, kind, where, value):
    assert_as_pillow(mutate(jpeg_fixture(name), kind, where, value))


# ---- the fixtures of tests/data_torch/formats_jpeg -------------------------------------------

def jpeg_small_fixtures() -> dict:
    """name -> (bytes, the kind of decode chip_smoke.py times it under)."""
    px = picture(37, 45, 30)
    cmyk = cmyk_px(37, 45, 31)
    base = save(Image.fromarray(picture(37, 45, 32)), "JPEG", quality=85, subsampling=2,
                restart_marker_blocks=2)
    a, b = scan_span(base)
    prog = save(Image.fromarray(picture(37, 45, 33)), "JPEG", quality=85, progressive=True)
    flipped = bytearray(base)
    flipped[a + 40] ^= 0x08
    rst2 = base.index(b"\xff\xd2")
    sos = base.index(b"\xff\xda")
    return {
        "cmyk.jpg": (save(Image.fromarray(cmyk, "CMYK"), "JPEG"), "jpeg cmyk/ycck"),
        "cmyk-progressive.jpg": (save(Image.fromarray(cmyk, "CMYK"), "JPEG", progressive=True),
                                 "jpeg cmyk/ycck"),
        "ycck-edited.jpg": (with_adobe_transform(save(Image.fromarray(cmyk, "CMYK"), "JPEG"), 2),
                            "jpeg cmyk/ycck"),
        "ycck-libjpeg.jpg": (libjpeg(cmyk, in_space=4, jpeg_space=5, arith=False,
                                     sampling="2,2,1,1,1,1,2,2"), "jpeg cmyk/ycck"),
        "rgb-keep.jpg": (save(Image.fromarray(px), "JPEG", keep_rgb=True), "jpeg"),
        "arith-sequential.jpg": (libjpeg(px), "jpeg arithmetic sequential"),
        "arith-sequential-420-restart.jpg": (libjpeg(px, restart=5, sampling="2,2,1,1,1,1"),
                                             "jpeg arithmetic sequential"),
        "arith-progressive.jpg": (libjpeg(px, progressive=True), "jpeg arithmetic progressive"),
        "arith-progressive-restart.jpg": (libjpeg(px, progressive=True, restart=2),
                                          "jpeg arithmetic progressive"),
        "arith-grey.jpg": (libjpeg(px[..., 1], in_space=1, jpeg_space=1),
                           "jpeg arithmetic sequential"),
        "arith-dac.jpg": (arith_transcode(base, True, 3, {0: (2, 5, 3), 1: (1, 1, 20)}),
                          "jpeg arithmetic progressive"),
        "lossless-psv1.jpg": (libjpeg(px, PILLOW_LIBJPEG, arith=False, psv=1), "jpeg lossless"),
        "lossless-psv4-pt2.jpg": (libjpeg(px, PILLOW_LIBJPEG, arith=False, psv=4, pt=2),
                                  "jpeg lossless"),
        "lossless-psv7-restart.jpg": (libjpeg(px, PILLOW_LIBJPEG, arith=False, psv=7,
                                              restart=90), "jpeg lossless"),
        "lossless-writer-420-restart.jpg": (lossless_file(
            planes_of(px, [(2, 2), (1, 1), (1, 1)]), [(2, 2), (1, 1), (1, 1)], 4, 0, 3),
            "jpeg lossless"),
        "lossless-grey.jpg": (libjpeg(px[..., 0], PILLOW_LIBJPEG, 1, 1, arith=False, psv=5),
                              "jpeg lossless"),
        "lossless-writer-rgb.jpg": (lossless_file(planes_of(px, [(1, 1)] * 3), [(1, 1)] * 3, 6, 1,
                                                  2, ids=[82, 71, 66]), "jpeg lossless"),
        "junk-before-sos.jpg": (base[:sos] + b"\x00\x13\x37" + base[sos:], "jpeg recovery"),
        "cut-eoi.jpg": (base[: (a + b) // 2] + b"\xff\xd9", "jpeg recovery"),
        "bit-flipped.jpg": (bytes(flipped), "jpeg recovery"),
        "rst-dropped.jpg": (base[:rst2] + base[rst2 + 2 :], "jpeg recovery"),
        "rst-renumbered.jpg": (base[: rst2 + 1] + b"\xd6" + base[rst2 + 2 :], "jpeg recovery"),
        "progressive-last-scan-dropped.jpg": (prog[: prog.rindex(b"\xff\xda")] + b"\xff\xd9",
                                              "jpeg recovery"),
        "progressive-cut-eoi.jpg": (prog[: len(prog) // 3] + b"\xff\xd9", "jpeg recovery"),
    }


BIG_ARITH = "photo-1024-arith.jpg"
BIG_LOSSLESS = "photo-512-lossless.jpg"


def big_arith() -> bytes:
    """A 1024x1024 arithmetic-coded photo under Pillow's 64 KiB limit."""
    from tests.test_torch_image_formats import big_picture

    return libjpeg(big_picture(), quality=60, sampling="2,2,1,1,1,1")


def big_lossless() -> bytes:
    from tests.test_torch_image_formats import big_picture

    return libjpeg(big_picture()[::2, ::2], PILLOW_LIBJPEG, arith=False, psv=1)


def ext_textures(raw_glb: bytes):
    """BreakTime's six textures in the kinds EXT_TEXTURES names."""
    out = []
    for i, b in enumerate(glb_images(raw_glb)):
        rgb = np.asarray(Image.open(io.BytesIO(b)).convert("RGB"))
        kind = EXT_TEXTURES[i]
        if kind == "CMYK":
            data = save(Image.fromarray(rgb).convert("CMYK"), "JPEG", quality=90)
        elif kind == "YCCK":
            cmyk = np.asarray(Image.fromarray(rgb).convert("CMYK"))
            data = libjpeg(cmyk, in_space=4, jpeg_space=5, arith=False, quality=90)
        elif kind.startswith("arithmetic progressive"):
            data = libjpeg(rgb, quality=90, progressive=True, restart=4, sampling="2,2,1,1,1,1")
        elif kind == "lossless":
            data = libjpeg(rgb, PILLOW_LIBJPEG, arith=False, psv=1)
        elif kind.startswith("baseline"):
            base = save(Image.fromarray(rgb), "JPEG", quality=90, restart_marker_blocks=4)
            rst = base.index(b"\xff\xd3")
            base = base[:rst] + base[rst + 2 :]
            dqt = base.index(b"\xff\xdb")
            data = base[:dqt] + b"\x42\x42" + base[dqt:]
        else:
            data = libjpeg(rgb, quality=90)
        out.append(data)
    return out


def breaktime_ext_pair():
    """BreakTime-JPEG-ext (each texture one of EXT_TEXTURES' kinds) and its
    twin: each texture a PNG of Pillow's decode of its partner's."""
    with open(os.path.join(SCENES, "BreakTime.glb"), "rb") as f:
        raw = f.read()
    files = ext_textures(raw)
    pngs = [save(Image.open(io.BytesIO(b)).convert("RGB"), "PNG", optimize=True) for b in files]
    return (replace_glb_images(raw, files, "image/jpeg"),
            replace_glb_images(raw, pngs, "image/png"))


def make_jpeg_fixtures(out_dir: str) -> dict:
    """Write the JPEG fixtures and their manifest (each entry its Pillow
    format and the decode kind chip_smoke.py times it under; an
    expectation over 256 KiB as the sha256 of Pillow's RGBA bytes) into
    `out_dir` -> the manifest."""
    os.makedirs(out_dir, exist_ok=True)

    def put(name, data):
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)

    images = []
    fixtures = jpeg_small_fixtures()
    fixtures[BIG_ARITH] = (big_arith(), "jpeg arithmetic sequential")
    fixtures[BIG_LOSSLESS] = (big_lossless(), "jpeg lossless")
    for name, (raw, kind) in fixtures.items():
        put(name, raw)
        want = pillow(raw)
        entry = dict(file=name, format=Image.open(io.BytesIO(raw)).format, kind=kind)
        if want.nbytes > 256 * 1024:
            entry.update(shape=list(want.shape), sha256=sha256_rgba(want))
        else:
            entry["expect"] = name.rsplit(".", 1)[0] + ".rgba.npy"
            np.save(os.path.join(out_dir, entry["expect"]), want)
        images.append(entry)
    glb, twin = breaktime_ext_pair()
    put(BT_EXT, glb)
    put(BT_EXT_TWIN, twin)
    kinds = [fixtures_kind(k) for k in EXT_TEXTURES]
    manifest = dict(images=images, scene=dict(ext=BT_EXT, ext_twin=BT_EXT_TWIN,
                                              ext_kinds=kinds))
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    return manifest


def fixtures_kind(texture: str) -> str:
    """The decode kind of a BreakTime-JPEG-ext texture."""
    return {"CMYK": "jpeg cmyk/ycck", "YCCK": "jpeg cmyk/ycck", "lossless": "jpeg lossless",
            "arithmetic sequential": "jpeg arithmetic sequential"}.get(
        texture, "jpeg arithmetic progressive" if texture.startswith("arithmetic")
        else "jpeg recovery")


def test_jpeg_fixture_writer_makes_the_committed_set(tmp_path):
    """make_jpeg_fixtures runs, and writes the committed files' names,
    expectations and bytes (its own 3 MiB)."""
    made = make_jpeg_fixtures(str(tmp_path))
    assert made == jpeg_manifest()
    for name in os.listdir(tmp_path):
        assert (tmp_path / name).read_bytes() == jpeg_fixture(name), name
    total = sum(os.path.getsize(os.path.join(JPEG_FIXTURES, n)) for n in os.listdir(JPEG_FIXTURES))
    assert total <= 3 * 2**20


@pytest.mark.parametrize("entry", jpeg_manifest()["images"] if SMALL_FIXTURES else [],
                         ids=lambda e: e["file"])
def test_committed_jpeg_fixture_matches_pillow(entry):
    """Each committed expectation (or digest) is Pillow's decode of the
    committed file, its format Pillow's, and the port's decode and format
    equal them."""
    raw = jpeg_fixture(entry["file"])
    want = pillow(raw)
    if "expect" in entry:
        np.testing.assert_array_equal(np.load(os.path.join(JPEG_FIXTURES, entry["expect"])), want)
    else:
        assert list(want.shape) == entry["shape"] and sha256_rgba(want) == entry["sha256"]
    assert Image.open(io.BytesIO(raw)).format == entry["format"] == image_format(raw)
    np.testing.assert_array_equal(decode_image_u8(raw), want)


def frame_of(raw: bytes):
    """(the frame marker, the component count) of a JPEG as the port reads it."""
    d = jpeg._Decoder(raw)
    d.run()
    return d.frame[0], len(d.comps)


def test_jpeg_fixtures_cover_each_new_path():
    frames = {}
    for e in jpeg_manifest()["images"]:
        frames.setdefault(frame_of(jpeg_fixture(e["file"]))[0], []).append(e["file"])
    assert set(frames) == {0xC0, 0xC2, 0xC3, 0xC9, 0xCA}
    kinds = {e["kind"] for e in jpeg_manifest()["images"]}
    assert kinds == {"jpeg", "jpeg cmyk/ycck", "jpeg arithmetic sequential",
                     "jpeg arithmetic progressive", "jpeg lossless", "jpeg recovery"}
    assert len(jpeg_fixture(BIG_ARITH)) < jpeg.FEED


def test_committed_breaktime_ext_pair():
    """BreakTime-JPEG-ext's textures are, in order, the kinds EXT_TEXTURES
    names, and their Pillow decodes are the twin's PNGs."""
    scene = jpeg_manifest()["scene"]
    files = glb_images(jpeg_fixture(scene["ext"]))
    pngs = glb_images(jpeg_fixture(scene["ext_twin"]))
    assert len(files) == len(pngs) == 6
    assert [frame_of(f) for f in files] == [(0xC0, 4), (0xC0, 4), (0xCA, 3), (0xC3, 3),
                                            (0xC0, 3), (0xC9, 3)]
    assert files[1][files[1].index(b"Adobe") + 11] == 2 and files[0][
        files[0].index(b"Adobe") + 11] == 0
    rsts = [files[4][i + 1] - 0xD0 for i in range(len(files[4]) - 1)
            if files[4][i] == 0xFF and 0xD0 <= files[4][i + 1] <= 0xD7]
    assert b"\xff\xdd" in files[2] and rsts[:4] == [0, 1, 2, 4]  # RST3 dropped
    assert files[4][files[4].index(b"\xff\xdb") - 2 :].startswith(b"BB")  # junk before DQT
    for f, png in zip(files, pngs):
        assert png[:4] == b"\x89PNG"
        np.testing.assert_array_equal(pillow(f), pillow(png))
        np.testing.assert_array_equal(decode_image_u8(f), pillow(png))
    doc, _ = read_glb(jpeg_fixture(scene["ext"]))
    assert {img["mimeType"] for img in doc["images"]} == {"image/jpeg"}


def fuzz(n: int, seed: int = 0) -> dict:
    """`n` random edits (each of `mutate`'s kinds) of every small
    committed fixture, each decoded by the port and by Pillow -> counts of
    (kind, outcome); raises AssertionError at the first file on which they
    disagree. A longer run than the suite's hypothesis test, for a change
    to the decoder (libjpeg-turbo's source is not here to read)."""
    rng = np.random.default_rng(seed)
    counts = {}
    for name in SMALL_FIXTURES:
        raw = jpeg_fixture(name)
        for _ in range(n):
            kind = str(rng.choice(["flip", "flip anywhere", "cut", "junk", "drop", "renumber"]))
            edited = mutate(raw, kind, float(rng.random()), int(rng.integers(0, 2**15)))
            want = outcome(edited)
            try:
                got = decode_image_u8(edited)
            except (ValueError, NotImplementedError) as e:
                got = e
            same = (isinstance(want, Exception) and isinstance(got, Exception)) or (
                not isinstance(want, Exception) and not isinstance(got, Exception)
                and np.array_equal(got, want))
            if not same:
                raise AssertionError(f"{name} {kind}: Pillow {type(want).__name__}, port "
                                     f"{type(got).__name__}")
            key = f"{kind}: {'refused' if isinstance(want, Exception) else 'decoded'}"
            counts[key] = counts.get(key, 0) + 1
    return counts


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--fuzz"]:  # --fuzz N [SEED]: edits of each fixture
        print(json.dumps(fuzz(int(sys.argv[2]), int(sys.argv[3]) if sys.argv[3:] else 0)))
    else:
        print(json.dumps(make_jpeg_fixtures(JPEG_FIXTURES), indent=1))
