"""The port's WebP decoder (rustic_tpu_torch/utils/webp.py: the container
and VP8L; utils/vp8.py: VP8 and ALPH; their entropy loops in
csrc/image_entropy.cpp) against Pillow 12.1.0 (libwebp 1.6.0), which the
JAX package decodes WebP with.

Files are written by Pillow (lossy by quality, method, alpha quality and
odd sizes; lossless by quality and method over pictures that reach every
transform, the colour cache and meta Huffman codes), or rebuilt here: an
ALPH chunk raw or VP8L-coded under each of its four filters
(`lossy_with_alpha` of tests/test_torch_image_formats.py), and a lossy
frame whose first partition is decoded and re-encoded with other segment,
loop filter and quantiser headers (`rewrite_header`: the simple filter,
sharpness, the reference and mode deltas, no filter, the quantiser
deltas, segment values relative to the frame's, 2, 4 and 8 token
partitions), which Pillow's writer never emits.
`decode_image_u8` must give Pillow's
`np.asarray(Image.open(...).convert("RGBA"))` bit for bit. Animated
files and inter frames raise NotImplementedError naming the variant and
ROADMAP queue 3.
"""

import io
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from rustic_tpu_torch.utils import vp8, webp
from rustic_tpu_torch.utils.png import decode_image_u8
from tests.test_torch_image_formats import (assert_pillow_equal, lossy_with_alpha, picture,
                                            pillow, pillow_modes, rgba, riff, save, webp_chunks)


def lossy(h, w, seed=0, **kw) -> bytes:
    return save(Image.fromarray(picture(h, w, seed)), "WEBP", **kw)


# ---- lossy (VP8) ----------------------------------------------------------------------------

LOSSY_SIZES = [(1, 1), (3, 5), (23, 37), (37, 23), (16, 64)]
LOSSY_GRID = [(q, m, hw) for q in (1, 50, 90, 100) for m in (0, 4, 6) for hw in LOSSY_SIZES]


@pytest.mark.parametrize("quality, method, size", LOSSY_GRID)
def test_lossy_grid_matches_pillow(quality, method, size):
    raw = lossy(*size, quality=quality, method=method)
    assert [k for k, _ in webp_chunks(raw)] == [b"VP8 "]
    assert_pillow_equal(raw)


ALPHA_GRID = [(aq, m, q, hw) for aq in (0, 50, 100) for m in (0, 6) for q in (20, 90)
              for hw in ((7, 9), (31, 17))]


@pytest.mark.parametrize("alpha_quality, method, quality, size", ALPHA_GRID)
def test_lossy_alpha_grid_matches_pillow(alpha_quality, method, quality, size):
    raw = save(Image.fromarray(rgba(*size)), "WEBP", quality=quality, method=method,
               alpha_quality=alpha_quality)
    assert [k for k, _ in webp_chunks(raw)] == [b"VP8X", b"ALPH", b"VP8 "]
    assert_pillow_equal(raw)


@pytest.mark.parametrize("size", [(5, 7), (19, 33)])
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("kind", [0, 1, 2, 3], ids=["none", "horizontal", "vertical", "gradient"])
def test_alpha_chunk_filters_match_pillow(kind, compressed, size):
    px = rgba(*size, seed=kind)
    raw = lossy_with_alpha(px[..., :3], px[..., 3], 70, compressed, kind)
    alph = dict(webp_chunks(raw))[b"ALPH"]
    assert (alph[0] & 3, alph[0] >> 2 & 3) == (int(compressed), kind)
    assert_pillow_equal(raw)


# ---- lossless (VP8L) ------------------------------------------------------------------------

def lossless_picture(content: str, h: int, w: int) -> Image.Image:
    modes = pillow_modes(h, w)
    y, x = np.mgrid[0:h, 0:w]
    return {
        "noise": lambda: Image.fromarray(picture(h, w)),
        "rgba": lambda: Image.fromarray(rgba(h, w)),
        "palette": lambda: modes["P"].convert("RGB"),
        "grey": lambda: modes["L"].convert("RGB"),
        "2 colours": lambda: Image.fromarray(picture(h, w)).quantize(2).convert("RGB"),
        "4 colours": lambda: Image.fromarray(picture(h, w)).quantize(4).convert("RGBA"),
        "16 colours": lambda: Image.fromarray(picture(h, w)).quantize(16).convert("RGB"),
        "smooth": lambda: Image.fromarray(np.stack([x * 3 % 256, y * 5 % 256, (x + y) % 256],
                                                   -1).astype(np.uint8)),
    }[content]()


LOSSLESS_CONTENTS = ["noise", "rgba", "palette", "grey", "2 colours", "4 colours", "16 colours",
                     "smooth"]
LOSSLESS_GRID = [(c, q, m, hw) for c in LOSSLESS_CONTENTS for q, m in ((0, 0), (50, 3), (100, 6))
                 for hw in ((1, 1), (9, 13), (40, 33))]


@pytest.mark.parametrize("content, quality, method, size", LOSSLESS_GRID)
def test_lossless_grid_matches_pillow(content, quality, method, size):
    raw = save(lossless_picture(content, *size), "WEBP", lossless=True, quality=quality,
               method=method, exact=True)
    assert b"VP8L" in dict(webp_chunks(raw))
    assert_pillow_equal(raw)


def half_flat():
    px = picture(128, 128)
    px[:, 40:] = (30, 140, 220)
    return px


def gradient():
    y, x = np.mgrid[0:48, 0:64]
    return np.stack([x * 3, y * 4, (x + y) * 2], -1).astype(np.uint8)


def quadrants():
    """Noise in two quadrants, a pattern in the others: blocks of other
    statistics, which libwebp codes with an entropy image."""
    y, x = np.mgrid[0:128, 0:128]
    pattern = np.stack([x, y, x ^ y], -1)
    return np.where(((x < 64) ^ (y < 64))[..., None], picture(128, 128), pattern).astype(np.uint8)


def binary_alpha(h, w):
    px = rgba(h, w)
    px[..., 3] = np.where(px[..., 3] > 128, 255, 0)
    return px


WEBP_CASES = {
    "lossy in VP8X with ICC, EXIF and XMP": lambda: lossy(
        19, 23, quality=70, icc_profile=b"\x00" * 200, exif=b"Exif\x00\x00" + bytes(30),
        xmp=b"<x:xmpmeta/>"),
    "lossless in VP8X with ICC": lambda: save(Image.fromarray(picture(19, 23)), "WEBP",
                                              lossless=True, icc_profile=b"\x01" * 100),
    "lossless 300x200": lambda: save(Image.fromarray(picture(200, 300, 3)), "WEBP",
                                     lossless=True, quality=100, method=5),
    "lossless quadrants (meta Huffman codes)": lambda: save(Image.fromarray(quadrants()), "WEBP",
                                                           lossless=True, quality=75, method=4),
    "lossless RGB (no alpha)": lambda: save(Image.fromarray(picture(9, 9)), "WEBP",
                                            lossless=True),
    "lossless alpha 0 or 255, colour kept under 0": lambda: save(
        Image.fromarray(binary_alpha(12, 14)), "WEBP", lossless=True, exact=True),
    "lossy 1x33": lambda: lossy(1, 33, quality=80),
    "lossy 33x1": lambda: lossy(33, 1, quality=80),
    "lossy 200x136 q95": lambda: lossy(136, 200, 5, quality=95, method=6),
    "lossy flat": lambda: save(Image.new("RGB", (40, 24), (30, 140, 220)), "WEBP", quality=75),
    "lossy half flat, skip flags": lambda: save(Image.fromarray(half_flat()), "WEBP", quality=75,
                                                method=1),
    "lossy gradient": lambda: save(Image.fromarray(gradient()), "WEBP", quality=75),
}


@pytest.mark.parametrize("case", list(WEBP_CASES))
def test_webp_case_matches_pillow(case):
    assert_pillow_equal(WEBP_CASES[case]())


def test_webp_grids_reach_their_variants(monkeypatch):
    """The lossy grid and cases reach 4x4 and 16x16 macroblocks, every
    intra mode, segments, the skip flag and the normal filter; the lossless
    grid every transform, the colour cache and meta Huffman codes."""
    seen = dict(i4=set(), bmodes=set(), ymodes=set(), uvmodes=set(), segments=False,
                skip=False, normal=False)
    files = [lossy(*hw, quality=q, method=m) for q, m, hw in LOSSY_GRID]
    for raw in files + [WEBP_CASES["lossy half flat, skip flags"](),
                        WEBP_CASES["lossy gradient"]()]:
        _, _, hdr, mb = vp8._parse(dict(webp_chunks(raw))[b"VP8 "])
        seen["i4"] |= set(mb["is_i4"].tolist())
        seen["bmodes"] |= set(mb["bmodes"][mb["is_i4"]].reshape(-1).tolist())
        seen["ymodes"] |= set(mb["ymode"][~mb["is_i4"]].tolist())
        seen["uvmodes"] |= set(mb["uvmode"].tolist())
        seen["segments"] |= bool(hdr.use_segment and hdr.update_map)
        seen["skip"] |= bool(hdr.use_skip and mb["skip"].any())
        seen["normal"] |= bool(hdr.level and not hdr.simple)
    assert seen == dict(i4={False, True}, bmodes=set(range(10)), ymodes={0, 1, 2, 3},
                        uvmodes={0, 1, 2, 3}, segments=True, skip=True, normal=True)
    kinds, cache, meta = set(), False, False
    real_invert, real_codes = webp._invert, webp._read_codes

    def invert(kind, *a):
        kinds.add(kind)
        return real_invert(kind, *a)

    def codes(*a):
        nonlocal cache, meta
        out = real_codes(*a)
        cache |= out[0] > 0
        meta |= out[3] is not None and len(out[4]) > 1
        return out

    monkeypatch.setattr(webp, "_invert", invert)
    monkeypatch.setattr(webp, "_read_codes", codes)
    for c, q, m, hw in LOSSLESS_GRID:
        decode_image_u8(save(lossless_picture(c, *hw), "WEBP", lossless=True, quality=q,
                             method=m, exact=True))
    decode_image_u8(WEBP_CASES["lossless quadrants (meta Huffman codes)"]())
    assert (kinds, cache, meta) == ({0, 1, 2, 3}, True, True)


@settings(max_examples=30, deadline=None, derandomize=True)
@given(h=st.integers(1, 48), w=st.integers(1, 48), quality=st.integers(0, 100),
       method=st.integers(0, 6), kind=st.sampled_from(["lossy", "alpha", "lossless"]),
       seed=st.integers(0, 2**16))
def test_webp_random_matches_pillow(h, w, quality, method, kind, seed):
    if kind == "lossless":
        raw = save(Image.fromarray(rgba(h, w, seed)), "WEBP", lossless=True, quality=quality,
                   method=method, exact=True)
    elif kind == "alpha":
        raw = save(Image.fromarray(rgba(h, w, seed)), "WEBP", quality=quality, method=method)
    else:
        raw = lossy(h, w, seed, quality=quality, method=method)
    assert_pillow_equal(raw)


# ---- the loop filter header, rewritten --------------------------------------------------------

class RecordingBool:
    """RFC 6386's boolean decoder, logging each (bit, probability)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data + bytes(8), 2
        self.value, self.range, self.count = data[0] << 8 | data[1], 255, 0
        self.log = []

    def bit(self, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        b = int(self.value >= big)
        if b:
            self.range -= split
            self.value -= big
        else:
            self.range = split
        while self.range < 128:
            self.value, self.range = self.value << 1, self.range << 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                self.value |= self.data[self.pos]
                self.pos += 1
        self.log.append((b, prob))
        return b

    def bits(self, n):
        v = 0
        for _ in range(n):
            v = v << 1 | self.bit(128)
        return v


class BoolEncoder:
    """RFC 6386's boolean encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def put(self, b, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if b:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):  # carry into the bytes written
                i = len(self.out) - 1
                while self.out[i] == 255:
                    self.out[i] = 0
                    i -= 1
                self.out[i] += 1
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if self.count == 0:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def flush(self) -> bytes:
        for _ in range(32):
            self.put(0, 128)
        return bytes(self.out)


def first_partition(part0: bytes, mbw: int, mbh: int):
    """Decode a key frame's first partition as libwebp reads it -> (its
    header's fields, the logged decisions, where the segment, filter and
    quantiser headers start and end in the log)."""
    d = RecordingBool(part0)
    flag = lambda: d.bit(128)  # noqa: E731

    def signed(n):
        v = d.bits(n)
        return -v if flag() else v

    def optional(n):
        return signed(n) if flag() else 0

    h = dict(use_segment=0, update_map=0, update_data=0, absolute=1, seg_quant=[0] * 4,
             seg_filter=[0] * 4, seg_probs=[255] * 3, ref=[0] * 4, mode=[0] * 4)
    flag(), flag()
    spans = {}
    start = len(d.log)
    h["use_segment"] = flag()
    if h["use_segment"]:
        h["update_map"], h["update_data"] = flag(), flag()
        if h["update_data"]:
            h["absolute"] = flag()
            h["seg_quant"] = [optional(7) for _ in range(4)]
            h["seg_filter"] = [optional(6) for _ in range(4)]
        if h["update_map"]:
            h["seg_probs"] = [d.bits(8) if flag() else 255 for _ in range(3)]
    spans["segments"] = start, len(d.log)
    start = len(d.log)
    h["simple"], h["level"], h["sharpness"] = flag(), d.bits(6), d.bits(3)
    h["use_delta"] = flag()
    if h["use_delta"] and flag():
        h["ref"] = [optional(6) for _ in range(4)]
        h["mode"] = [optional(6) for _ in range(4)]
    spans["filter"] = start, len(d.log)
    start = len(d.log)
    h["partitions"] = 1 << d.bits(2)
    spans["partitions"] = start, len(d.log)
    start = len(d.log)
    h["base_q"], h["dq"] = d.bits(7), [optional(4) for _ in range(5)]
    spans["quant"] = start, len(d.log)
    flag()
    probs = vp8.COEFF_PROBS.reshape(-1).tolist()
    for i, p in enumerate(vp8.COEFF_UPDATE_PROBS.reshape(-1).tolist()):
        if d.bit(p):
            probs[i] = d.bits(8)
    h["probs"] = np.reshape(probs, (4, 8, 3, 11)).tolist()
    h["macroblocks"] = []  # (is 4x4, skip flag) in raster order
    skip = flag()
    skip_prob = d.bits(8) if skip else 0
    bm = vp8.BMODE_PROBS.tolist()
    sp = h["seg_probs"]
    top = [0] * (4 * mbw)
    for _ in range(mbh):
        left = [0] * 4
        for mx in range(mbw):
            if h["update_map"]:
                d.bit(sp[1]) if not d.bit(sp[0]) else d.bit(sp[2])
            skipped = d.bit(skip_prob) if skip else 0
            h["macroblocks"].append((1 - d.bit(145), skipped))
            if not h["macroblocks"][-1][0]:
                mode = (vp8.TM if d.bit(128) else vp8.HE) if d.bit(156) else (
                    vp8.VE if d.bit(163) else vp8.DC)
                top[4 * mx : 4 * mx + 4], left = [mode] * 4, [mode] * 4
            else:
                tree = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
                for by in range(4):
                    for bx in range(4):
                        prob = bm[top[4 * mx + bx]][left[by]]
                        i = tree[d.bit(prob[0])]
                        while i > 0:
                            i = tree[2 * i + d.bit(prob[i])]
                        top[4 * mx + bx] = left[by] = -i
            d.bit(142) and d.bit(114) and d.bit(183)
    return h, d.log, spans


def _bits(v, n):
    return [(v >> i & 1, 128) for i in range(n - 1, -1, -1)]


def _optional(v, n):
    """A flag, and where it is set the magnitude in n bits and the sign."""
    return [(int(v != 0), 128)] + (_bits(abs(v), n) + [(int(v < 0), 128)] if v else [])


def header_sections(h) -> dict:
    """The decisions of the segment, filter and quantiser headers of the
    fields `h` (first_partition's form)."""
    seg = [(h["use_segment"], 128)]
    if h["use_segment"]:
        seg += [(h["update_map"], 128), (h["update_data"], 128)]
        if h["update_data"]:
            seg += [(h["absolute"], 128)]
            seg += sum((_optional(v, 7) for v in h["seg_quant"]), [])
            seg += sum((_optional(v, 6) for v in h["seg_filter"]), [])
        if h["update_map"]:
            seg += sum(([(0, 128)] if p == 255 else [(1, 128)] + _bits(p, 8)
                        for p in h["seg_probs"]), [])
    filt = [(h["simple"], 128)] + _bits(h["level"], 6) + _bits(h["sharpness"], 3)
    filt += [(h["use_delta"], 128)]
    if h["use_delta"]:
        filt += [(1, 128)] + sum((_optional(v, 6) for v in h["ref"] + h["mode"]), [])
    quant = _bits(h["base_q"], 7) + sum((_optional(v, 4) for v in h["dq"]), [])
    parts = _bits(h["partitions"].bit_length() - 1, 2)
    return dict(segments=seg, filter=filt, partitions=parts, quant=quant)


def rewrite_header(raw: bytes, **fields) -> bytes:
    """A lossy file with fields of its frame header changed (the keys of
    first_partition's dict; the segment map's presence kept) and its first
    partition re-encoded."""
    frame = dict(webp_chunks(raw))[b"VP8 "]
    tag = frame[0] | frame[1] << 8 | frame[2] << 16
    size0 = tag >> 5
    width = struct.unpack("<H", frame[6:8])[0] & 0x3FFF
    height = struct.unpack("<H", frame[8:10])[0] & 0x3FFF
    h, log, spans = first_partition(frame[10 : 10 + size0], (width + 15) >> 4,
                                    (height + 15) >> 4)
    assert fields.get("update_map", h["update_map"]) == h["update_map"]
    h.update(fields)
    if h["ref"] != [0] * 4 or h["mode"] != [0] * 4:
        h["use_delta"] = 1
    new = header_sections(h)
    out, at = [], 0
    for name in ("segments", "filter", "partitions", "quant"):
        a, b = spans[name]
        out += log[at:a] + new[name]
        at = b
    tokens = frame[10 + size0 :]
    if h["partitions"] != 1:  # the one partition's rows dealt out: row y to partition y mod n
        rows = token_rows(tokens, h, (width + 15) >> 4, (height + 15) >> 4)
        parts = [encode(sum(rows[y::h["partitions"]], [])) for y in range(h["partitions"])]
        tokens = b"".join(len(p).to_bytes(3, "little") for p in parts[:-1]) + b"".join(parts)
    part0 = encode(out + log[at:])
    tag = (tag & 0x1F) | len(part0) << 5
    body = bytes([tag & 255, tag >> 8 & 255, tag >> 16]) + frame[3:10] + part0
    return riff([(b"VP8 ", body + tokens)])


def encode(decisions) -> bytes:
    enc = BoolEncoder()
    for b, p in decisions:
        enc.put(b, p)
    return enc.flush()


_CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
              (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)


def _block_tokens(d, bands, ctx: int, n: int) -> int:
    """One block's tokens (libwebp's GetCoeffs, the values dropped) -> the
    position after its last non-zero coefficient."""
    p = bands[n][ctx]
    while n < 16:
        if not d.bit(p[0]):
            return n
        while not d.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = bands[n][0]
        if not d.bit(p[2]):
            p = bands[n + 1][1]
        else:  # libwebp's GetLargeValue
            if not d.bit(p[3]):
                d.bit(p[4]) and d.bit(p[5])
            elif not d.bit(p[6]):
                d.bit(159) if not d.bit(p[7]) else (d.bit(165), d.bit(145))
            else:
                bit1 = d.bit(p[8])
                for prob in _CAT_PROBS[2 * bit1 + d.bit(p[9 + bit1])]:
                    d.bit(prob)
            p = bands[n + 1][2]
        d.bit(128)  # the sign
        n += 1
    return 16


def token_rows(tokens: bytes, h, mbw: int, mbh: int) -> list:
    """The one token partition's decisions, a list for each macroblock row
    (libwebp's ParseResiduals, the coefficients dropped)."""
    d = RecordingBool(tokens)
    bands = [[h["probs"][t][_BANDS[n]] for n in range(17)] for t in range(4)]
    top_nz, top_dc = [0] * mbw, [0] * mbw
    rows = []
    for my in range(mbh):
        start = len(d.log)
        left_nz = left_dc = 0
        for mx in range(mbw):
            i4, skip = h["macroblocks"][my * mbw + mx]
            if skip:
                top_nz[mx] = left_nz = 0
                if not i4:
                    top_dc[mx] = left_dc = 0
                continue
            first, ac = 0, bands[3]
            if not i4:
                nz = _block_tokens(d, bands[1], top_dc[mx] + left_dc, 0)
                top_dc[mx] = left_dc = int(nz > 0)
                first, ac = 1, bands[0]
            tnz, lnz = top_nz[mx] & 15, left_nz & 15
            for _ in range(4):
                l = lnz & 1
                for _ in range(4):
                    l = int(_block_tokens(d, ac, l + (tnz & 1), first) > first)
                    tnz = (tnz >> 1) | (l << 7)
                tnz >>= 4
                lnz = (lnz >> 1) | (l << 7)
            out_t, out_l = tnz, lnz >> 4
            for ch in (0, 2):
                tnz, lnz = top_nz[mx] >> (4 + ch), left_nz >> (4 + ch)
                for _ in range(2):
                    l = lnz & 1
                    for _ in range(2):
                        l = int(_block_tokens(d, bands[2], l + (tnz & 1), 0) > 0)
                        tnz = (tnz >> 1) | (l << 3)
                    tnz >>= 2
                    lnz = (lnz >> 1) | (l << 5)
                out_t |= (tnz << 4) << ch
                out_l |= (lnz & 0xF0) << ch
            top_nz[mx], left_nz = out_t, out_l
        rows.append(d.log[start:])
    return rows


def header_of(raw: bytes):
    frame = dict(webp_chunks(raw))[b"VP8 "]
    size0 = (frame[0] | frame[1] << 8 | frame[2] << 16) >> 5
    w, h = (v & 0x3FFF for v in struct.unpack("<HH", frame[6:10]))
    return first_partition(frame[10 : 10 + size0], (w + 15) >> 4, (h + 15) >> 4)[0]


FILTERS = {
    "simple, level 20": dict(simple=1, level=20),
    "simple, level 63, sharpness 3": dict(simple=1, level=63, sharpness=3),
    **{f"normal, sharpness {s}": dict(sharpness=s) for s in (1, 4, 5, 7)},
    "normal, level 45 (high-variance threshold 2)": dict(level=45),
    "normal, reference and 4x4 mode deltas": dict(ref=[5, 0, 0, 0], mode=[-9, 0, 0, 0]),
    "normal, deltas to level 0": dict(level=10, ref=[-30, 0, 0, 0]),
    "simple, 4x4 mode delta": dict(simple=1, level=12, mode=[20, 0, 0, 0]),
    "no filter (level 0)": dict(level=0),
    "quantiser deltas": dict(dq=[3, -2, 5, -4, 6]),
    "quantiser deltas to the table's ends": dict(base_q=120, dq=[7, -8, 7, 7, -8]),
    **{f"{n} token partitions": dict(partitions=n) for n in (2, 4, 8)},
}


@pytest.mark.parametrize("size", [(23, 37), (48, 64)])
@pytest.mark.parametrize("case", list(FILTERS))
def test_rewritten_header_matches_pillow(case, size):
    """Loop filter and quantiser headers, and token partitions, that
    Pillow's writer never emits."""
    raw = rewrite_header(lossy(*size, seed=7, quality=40, method=4), **FILTERS[case])
    hdr = vp8._parse(dict(webp_chunks(raw))[b"VP8 "])[2]
    want = dict(header_of(raw), **FILTERS[case])
    assert (hdr.simple, hdr.level, hdr.sharpness) == (want["simple"], want["level"],
                                                       want["sharpness"])
    assert (hdr.ref_delta, hdr.mode_delta, hdr.dq) == (want["ref"], want["mode"], want["dq"])
    assert hdr.partitions == want["partitions"]
    assert_pillow_equal(raw)


def test_relative_segment_values_match_pillow():
    """The segment quantisers and filter levels as deltas from the frame's
    (absolute 0): the same image as the absolute values give."""
    base = save(Image.fromarray(quadrants()), "WEBP", quality=40, method=4)
    h = header_of(base)
    assert h["use_segment"] and h["update_data"] and h["absolute"]
    assert len(set(h["seg_quant"])) > 1 and len(set(h["seg_filter"])) > 1
    raw = rewrite_header(base, absolute=0, seg_quant=[q - h["base_q"] for q in h["seg_quant"]],
                         seg_filter=[f - h["level"] for f in h["seg_filter"]])
    assert header_of(raw)["absolute"] == 0
    np.testing.assert_array_equal(pillow(raw), pillow(base))
    assert_pillow_equal(raw)


def test_rewriting_keeps_the_frame():
    """The rewriter's round trip (no field changed) decodes as the
    original does, so its re-encoding changes only what it is asked to."""
    base = lossy(23, 37, seed=7, quality=40, method=4)
    same = rewrite_header(base)
    assert same != base
    np.testing.assert_array_equal(pillow(same), pillow(base))
    np.testing.assert_array_equal(decode_image_u8(same), pillow(base))


# ---- refusals -------------------------------------------------------------------------------

def inter_frame() -> bytes:
    raw = bytearray(lossy(16, 16))
    chunks = dict(webp_chunks(bytes(raw)))
    frame = bytearray(chunks[b"VP8 "])
    frame[0] |= 1
    return riff([(b"VP8 ", bytes(frame))])


def test_webp_animation_once_refused_matches_pillow():
    """An animated file (Pillow's own writer): its first frame, as Pillow shows it."""
    raw = save(pillow_modes(4, 4)["RGB"], "WEBP", save_all=True,
               append_images=[pillow_modes(4, 4, seed=1)["RGB"]])
    assert_pillow_equal(raw)


WEBP_REFUSALS = {
    "without VP8X's animation flag": lambda: riff(
        [(b"VP8X", bytes([0x10, 0, 0, 0, 3, 0, 0, 3, 0, 0])), (b"ANMF", bytes(16))]),
    "inter frame": inter_frame,
}


@pytest.mark.parametrize("variant", list(WEBP_REFUSALS))
def test_webp_refusals(variant):
    with pytest.raises(NotImplementedError, match=f"WebP.*{variant}.*ROADMAP"):
        decode_image_u8(WEBP_REFUSALS[variant]())


@pytest.mark.parametrize("kind", ["lossy", "lossless"])
def test_truncated_webp_is_refused_as_pillow_refuses_it(kind):
    raw = lossy(40, 40, quality=80) if kind == "lossy" else save(
        Image.fromarray(picture(40, 40)), "WEBP", lossless=True)
    raw = raw[: len(raw) * 3 // 4]
    with pytest.raises(OSError):
        pillow(raw)
    with pytest.raises(ValueError, match="ends"):
        decode_image_u8(raw)
