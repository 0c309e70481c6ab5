"""The port's image decoders against Pillow 12.1.0 (libjpeg-turbo 3.1.3)
and the OpenEXR reader against this module's own writer.

JPEG (rustic_tpu_torch/utils/jpeg.py), BMP and TGA (utils/bmp_tga.py)
files are written by Pillow, or by Pillow and then rewritten here (a SOF1
marker, other table ids, a 4:4:0 sampling, RGB without an Adobe segment,
BMP V4/V5 bit fields, TGA colour maps), and `decode_image_u8` must give
Pillow's `np.asarray(Image.open(...).convert("RGBA"))` bit for bit: no
tolerance. OpenEXR files (utils/exr.py) are written by `write_exr` below,
which follows OpenEXR's scanline layout and its RLE and ZIP compressors
(byte split, predictor, zlib; a block that does not shrink stored as it
is): `read_exr` must return the written values exactly (half to float32
is exact). Every refused variant raises NotImplementedError naming it.

The module also holds the writers the GIF, TIFF and WebP tests use
(tests/test_torch_image_formats_tiff_gif.py, _webp.py): `gif_raw`,
`write_tiff` (with `tiff_lzw` and `packbits`), `riff`, `webp_chunks` and
`lossy_with_alpha`.

The fixtures of tests/data_torch/formats/ (read by chip_smoke.py's
`formats` phase on the card's host, which has no Pillow) are written by
`make_fixtures`: `python -m tests.test_torch_image_formats` rewrites
them. Each committed expectation is held here to Pillow's decode of the
committed file, so a stale fixture fails on the CPU. Beside the JPEG,
BMP and TGA files they hold GIF, TIFF, WebP and JPEG 2000 files of each
kind the decoders read, a 1024x1024 lossy WebP, two 1024x1024 JP2s (5/3
lossless, 9/7 at 20:1), BreakTime-mixed (JPEG-in-TIFF, CMYK, CIELab and
Group 4 TIFF, animated WebP and RLE8 BMP textures) and BreakTime-J2K (JPEG 2000 textures), each with its PNG twin. The
JPEG 2000 writers (`j2k`, `j2k_parse`/`j2k_join`/`j2k_with` for
codestream edits, `jp2_wrap`, `palette_jp2`) serve
tests/test_torch_image_formats_jpeg2000.py and the refusals here.
"""

import gzip
import hashlib
import io
import json
import lzma
import os
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from rustic_tpu_torch.utils import bmp_tga, exr, jpeg, jpeg2000
from rustic_tpu_torch.utils.png import decode_image_rgba, decode_image_u8

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch", "formats")
SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                      "scenes")


def pillow(raw: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))


def picture(h: int, w: int, seed: int = 0) -> np.ndarray:
    """uint8 [h, w, 3]: gradients, a ripple and noise, so that every
    frequency and colour channel carries signal."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([(x * 7 + y * 3) % 256, (x * y) % 256,
                     128 + 100 * np.sin(x / 5.0 + y / 7.0)], -1)
    return np.clip(base + rng.normal(0, 30, base.shape), 0, 255).astype(np.uint8)


def save(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def jpeg_file(h, w, mode="RGB", seed=0, **kw) -> bytes:
    px = picture(h, w, seed)
    return save(Image.fromarray(px if mode == "RGB" else px[..., 1], mode), "JPEG", **kw)


def assert_pillow_equal(raw: bytes, name: str = ""):
    want = pillow(raw)
    got = decode_image_u8(raw, name)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---- rewriting JPEG files -------------------------------------------------------------------

def segments(raw: bytes):
    """A JPEG's marker segments up to its first SOS -> [(marker, body)]
    and the rest of the file (the SOS segment onwards)."""
    out, pos = [], 2
    while True:
        marker = raw[pos + 1]
        (length,) = struct.unpack(">H", raw[pos + 2 : pos + 4])
        if marker == 0xDA:
            return out, raw[pos:]
        out.append((marker, raw[pos + 4 : pos + 2 + length]))
        pos += 2 + length


def join(segs, rest: bytes) -> bytes:
    return b"\xff\xd8" + b"".join(
        bytes([0xFF, m]) + struct.pack(">H", len(b) + 2) + b for m, b in segs) + rest


def with_sof(raw: bytes, marker: int) -> bytes:
    """The file with its SOF0/SOF2 marker byte replaced."""
    segs, rest = segments(raw)
    return join([(marker if m in (0xC0, 0xC2) else m, b) for m, b in segs], rest)


def remap_tables(raw: bytes) -> bytes:
    """The file with quantisation tables 0, 1 renamed 3, 2 and Huffman
    tables 0, 1 renamed 2, 3 in every segment that names them (a
    sequential file: one SOS)."""
    segs, rest = segments(raw)
    q, h = {0: 3, 1: 2}, {0: 2, 1: 3}
    out = []
    for m, b in segs:
        b = bytearray(b)
        if m == 0xDB:
            pos = 0
            while pos < len(b):
                b[pos] = (b[pos] & 0xF0) | q[b[pos] & 15]
                pos += 129 if b[pos] >> 4 else 65
        elif m == 0xC4:
            pos = 0
            while pos < len(b):
                b[pos] = (b[pos] & 0xF0) | h[b[pos] & 15]
                pos += 17 + sum(b[pos + 1 : pos + 17])
        elif m in (0xC0, 0xC1, 0xC2):
            for i in range(b[5]):
                b[8 + 3 * i] = q[b[8 + 3 * i]]
        out.append((m, bytes(b)))
    sos = bytearray(rest)
    for i in range(sos[4]):
        t = sos[6 + 2 * i]
        sos[6 + 2 * i] = h[t >> 4] << 4 | h[t & 15]
    return join(out, bytes(sos))


def transpose_sampling(raw: bytes) -> bytes:
    """A 4:2:2 (h2v1) file with width and height and each component's h
    and v swapped: the same entropy data read as a 4:4:0 (h1v2) image of
    as many MCUs."""
    segs, rest = segments(raw)
    out = []
    for m, b in segs:
        if m == 0xC0:
            b = bytearray(b)
            b[1:5] = b[3:5] + b[1:3]
            for i in range(b[5]):
                hv = b[7 + 3 * i]
                b[7 + 3 * i] = (hv & 15) << 4 | hv >> 4
            b = bytes(b)
        out.append((m, b))
    return join(out, rest)


def with_adobe(raw: bytes, transform: int) -> bytes:
    """The file with an Adobe APP14 segment of this colour transform
    first (version 100, no flags)."""
    segs, rest = segments(raw)
    return join([(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform))] + segs, rest)


def strip_app(raw: bytes, marker: int) -> bytes:
    segs, rest = segments(raw)
    return join([(m, b) for m, b in segs if m != marker], rest)


# ---- JPEG against Pillow --------------------------------------------------------------------

SIZES = [(23, 37), (37, 23), (3, 4)]  # odd sizes; 3x4 at 4:2:0 has chroma 2 samples wide
JPEG_GRID = [("RGB", s, p, o, r, hw) for s in (0, 1, 2) for p in (False, True)
             for o in (False, True) for r in (0, 2) for hw in SIZES] + [
    ("L", 0, p, o, r, hw) for p in (False, True) for o in (False, True) for r in (0, 2)
    for hw in SIZES]


@pytest.mark.parametrize("mode, sampling, progressive, optimize, restart, size", JPEG_GRID)
def test_jpeg_grid_matches_pillow(mode, sampling, progressive, optimize, restart, size):
    kw = dict(subsampling=sampling) if mode == "RGB" else {}
    raw = jpeg_file(*size, mode, progressive=progressive, optimize=optimize,
                    restart_marker_blocks=restart, **kw)
    assert (raw.find(b"\xff\xdd") >= 0) == bool(restart)
    assert (raw.find(b"\xff\xc2") >= 0) == progressive
    assert_pillow_equal(raw)


JPEG_CASES = {
    # sizes where edge rules show: one pixel, chroma planes 1 and 2 samples wide
    # (replicated, not filtered), a width of one MCU plus one column
    "1x1 4:2:0": lambda: jpeg_file(1, 1, subsampling=2),
    "2x2 4:2:0": lambda: jpeg_file(2, 2, subsampling=2),
    "5x5 4:2:0": lambda: jpeg_file(5, 5, subsampling=2),
    "9x17 4:2:2": lambda: jpeg_file(9, 17, subsampling=1),
    "4x3 4:2:2": lambda: jpeg_file(4, 3, subsampling=1),
    "64x48 4:2:0 q100": lambda: jpeg_file(64, 48, quality=100, subsampling=2),
    "33x65 q5 progressive": lambda: jpeg_file(33, 65, quality=5, progressive=True),
    "grey 1x9 progressive": lambda: jpeg_file(1, 9, "L", progressive=True),
    "restart rows": lambda: jpeg_file(40, 30, restart_marker_rows=1, subsampling=2),
    "restart every block, progressive": lambda: jpeg_file(
        17, 29, restart_marker_blocks=1, progressive=True, subsampling=1),
    "RGB (Adobe transform 0)": lambda: jpeg_file(19, 21, keep_rgb=True),
    "RGB by component ids": lambda: strip_app(jpeg_file(19, 21, keep_rgb=True), 0xEE),
    "YCbCr under Adobe transform 1, ids R G B": lambda: with_adobe(
        strip_app(jpeg_file(19, 21, keep_rgb=True), 0xEE), 1),
    "YCbCr under Adobe transform 2": lambda: with_adobe(
        strip_app(jpeg_file(19, 21, subsampling=1), 0xE0), 2),
    "extended SOF1": lambda: with_sof(jpeg_file(23, 37, subsampling=2), 0xC1),
    "table ids 2 and 3": lambda: remap_tables(jpeg_file(23, 37, subsampling=1, optimize=True)),
    "4:4:0 (h1v2)": lambda: transpose_sampling(jpeg_file(21, 35, subsampling=1)),
    "4:4:0 (h1v2) 1 wide": lambda: transpose_sampling(jpeg_file(1, 3, subsampling=1)),
    "16-bit quantisation tables": lambda: jpeg_file(
        24, 24, qtables=[[300] * 64, [2] * 64], subsampling=0),
    "bytes after EOI": lambda: jpeg_file(23, 37, progressive=True) + b"\x00trailing",
    "COM and APPn skipped": lambda: jpeg_file(
        20, 20, comment=b"a comment", icc_profile=b"\x00" * 300, exif=b"Exif\x00\x00" + bytes(40)),
}


@pytest.mark.parametrize("case", list(JPEG_CASES))
def test_jpeg_case_matches_pillow(case):
    assert_pillow_equal(JPEG_CASES[case]())


def test_jpeg_cases_reach_their_variant():
    """The rewritten files are what their names say."""
    assert JPEG_CASES["extended SOF1"]().find(b"\xff\xc1") >= 0
    d = jpeg._Decoder(JPEG_CASES["4:4:0 (h1v2)"]())
    d.run()
    assert [(c.h, c.v) for c in d.comps] == [(1, 2), (1, 1), (1, 1)]
    d = jpeg._Decoder(JPEG_CASES["table ids 2 and 3"]())
    d.run()
    assert sorted(d.dc) == sorted(d.ac) == [2, 3] and sorted(d.qt) == [2, 3]
    d = jpeg._Decoder(JPEG_CASES["RGB by component ids"]())
    d.run()
    assert d.adobe is None and not d.jfif and d._is_rgb()
    segs, _ = segments(JPEG_CASES["16-bit quantisation tables"]())
    assert any(m == 0xDB and b[0] >> 4 for m, b in segs)


@settings(max_examples=30, deadline=None, derandomize=True)
@given(h=st.integers(1, 40), w=st.integers(1, 40), quality=st.integers(1, 100),
       sampling=st.sampled_from([0, 1, 2]), progressive=st.booleans(),
       optimize=st.booleans(), grey=st.booleans(), seed=st.integers(0, 2**16))
def test_jpeg_random_matches_pillow(h, w, quality, sampling, progressive, optimize, grey, seed):
    raw = jpeg_file(h, w, "L" if grey else "RGB", seed, quality=quality, subsampling=sampling,
                    progressive=progressive, optimize=optimize)
    assert_pillow_equal(raw)


def test_truncated_jpeg_is_refused_as_pillow_refuses_it():
    raw = jpeg_file(23, 37, subsampling=2)[:-2]  # no EOI
    with pytest.raises(OSError, match="truncated"):
        pillow(raw)
    with pytest.raises(ValueError, match="past the end"):
        decode_image_u8(raw)


def cmyk_jpeg():
    return save(Image.fromarray(picture(8, 8)).convert("CMYK"), "JPEG")


def twelve_bit():
    segs, rest = segments(jpeg_file(8, 8))
    return join([(m, bytes([12]) + b[1:] if m == 0xC0 else b) for m, b in segs], rest)


def dnl_height():
    segs, rest = segments(jpeg_file(8, 8))
    return join([(m, b[:1] + b"\x00\x00" + b[3:] if m == 0xC0 else b) for m, b in segs], rest)


JPEG_REFUSALS = {
    "arithmetic-coded": lambda: with_sof(jpeg_file(8, 8), 0xC9),
    "arithmetic-coded progressive": lambda: with_sof(jpeg_file(8, 8, progressive=True), 0xCA),
    "12-bit": twelve_bit,
    "lossless": lambda: with_sof(jpeg_file(8, 8), 0xC3),
    "hierarchical": lambda: with_sof(jpeg_file(8, 8), 0xC5),
    "4-component": cmyk_jpeg,
    "DNL": dnl_height,
}


# variants the decoder reads since it reads arithmetic-coded, lossless and four-component files
# (tests/test_torch_image_formats_jpeg.py): held to Pillow, which decodes them or refuses them
JPEG_AS_PILLOW = ("arithmetic-coded", "arithmetic-coded progressive", "lossless", "4-component")


@pytest.mark.parametrize("variant", list(JPEG_REFUSALS))
def test_jpeg_refusals(variant):
    raw = JPEG_REFUSALS[variant]()
    if variant in JPEG_AS_PILLOW:
        try:
            want = pillow(raw)
        except OSError:
            with pytest.raises(ValueError):
                decode_image_u8(raw)
            return
        np.testing.assert_array_equal(decode_image_u8(raw), want)
        return
    with pytest.raises(NotImplementedError, match=f"{variant}.*ROADMAP"):
        decode_image_u8(raw)


# ---- BMP and TGA against Pillow -------------------------------------------------------------

def rgba(h, w, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([picture(h, w, seed), rng.integers(0, 256, (h, w, 1), np.uint8)], -1)


def pillow_modes(h, w, seed=0):
    px = rgba(h, w, seed)
    rgb = Image.fromarray(px[..., :3])
    return {"1": rgb.convert("1"), "L": rgb.convert("L"), "P": rgb.quantize(7),
            "RGB": rgb, "RGBA": Image.fromarray(px), "LA": Image.fromarray(px).convert("LA")}


def bmp_bitfields(px, header=124, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), top_down=False,
                  compression=3, bits=32):
    """A 32-bit BMP with an info header of `header` bytes: each channel
    of px [H, W, 4] at its mask (the masks after a 40-byte header, inside
    a longer one)."""
    h, w, _ = px.shape
    stride = ((w * bits + 31) >> 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    val = np.zeros((h, w), np.uint32)
    for ch, m in enumerate(masks):
        if m:
            val |= px[..., ch].astype(np.uint32) << (m.bit_length() - 8)
    rows[:, : w * 4] = val.view(np.uint8).reshape(h, w * 4)
    if not top_down:
        rows = rows[::-1]
    info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, compression,
                       rows.size, 2835, 2835, 0, 0)
    extra = struct.pack("<IIII", *masks)[: header - 40] if header > 40 else b""
    info = info + extra + bytes(header - len(info) - len(extra))
    if header == 40 and compression == 3:
        info += struct.pack("<III", *masks[:3])
    off = 14 + len(info)
    return b"BM" + struct.pack("<IHHI", off + rows.size, 0, 0, off) + info + rows.tobytes()


def tga_mapped(idx, pal, flags=0x20, rle=False, start=2, depth=24):
    """A colour-mapped TGA (type 1, or 9 with one raw packet a pixel)
    whose map of `depth`-bit BGR(A) entries starts at index `start`."""
    h, w = idx.shape
    head = struct.pack("<BBBHHBHHHHBB", 0, 1, 9 if rle else 1, start, len(pal), depth, 0, 0, w,
                       h, 8, flags)
    body = idx.tobytes() if not rle else b"".join(b"\x00" + bytes([v]) for v in idx.reshape(-1))
    order = [2, 1, 0, 3][: depth // 8]
    return head + pal[:, order].tobytes() + body


BMP_MASKS = [(0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
             (0xFF000000, 0xFF0000, 0xFF00, 0xFF), (0xFF0000, 0xFF00, 0xFF, 0),
             (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)]
BMP_CASES = {f"Pillow {mode} {h}x{w}": (lambda mode=mode, h=h, w=w: save(
    pillow_modes(h, w)[mode], "BMP")) for mode in ("1", "L", "P", "RGB", "RGBA")
    for h, w in ((1, 1), (5, 7), (8, 3))}
BMP_CASES.update({
    f"{header}-byte header, masks {i}, {'top-down' if td else 'bottom-up'}": (
        lambda header=header, m=m, td=td: bmp_bitfields(rgba(5, 7), header, m, td))
    for header in (56, 108, 124) for i, m in enumerate(BMP_MASKS) for td in (False, True)})
BMP_CASES.update({
    f"{header}-byte header, three masks": (lambda header=header: bmp_bitfields(
        rgba(6, 3), header, (0xFF0000, 0xFF00, 0xFF, 0)))
    for header in (40, 52)})
BMP_CASES["32-bit BI_RGB, top-down"] = lambda: bmp_bitfields(
    rgba(4, 6), 40, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), True, compression=0)


@pytest.mark.parametrize("case", list(BMP_CASES))
def test_bmp_matches_pillow(case):
    assert_pillow_equal(BMP_CASES[case]())


TGA_CASES = {f"Pillow {mode} {kw} {h}x{w}": (lambda mode=mode, kw=kw, h=h, w=w: save(
    pillow_modes(h, w)[mode], "TGA", **kw)) for mode in ("L", "LA", "P", "RGB", "RGBA")
    for kw in ({}, {"compression": "tga_rle"}, {"orientation": 1})
    for h, w in ((1, 1), (5, 7))}
TGA_CASES.update({
    f"24-bit map, flags {flags:#x}, rle {rle}": (lambda flags=flags, rle=rle: tga_mapped(
        np.random.default_rng(1).integers(2, 8, (4, 5), dtype=np.uint8),
        np.random.default_rng(2).integers(0, 256, (6, 3), dtype=np.uint8), flags, rle))
    for flags in (0x00, 0x10, 0x20, 0x30) for rle in (False, True)})


@pytest.mark.parametrize("case", list(TGA_CASES))
def test_tga_matches_pillow(case):
    raw = TGA_CASES[case]()
    assert_pillow_equal(raw, "texture.TGA")
    assert_pillow_equal(raw, "image/x-tga")


def os2_bmp():
    info = struct.pack("<IHHHH", 12, 2, 2, 1, 24)
    return b"BM" + struct.pack("<IHHI", 26 + 16, 0, 0, 26) + info + bytes(16)


def bmp_header(bits, compression):
    raw = bytearray(save(Image.fromarray(picture(4, 4)), "BMP"))
    raw[28:30] = struct.pack("<H", bits)
    raw[30:34] = struct.pack("<I", compression)
    return bytes(raw)


def rle_bmp_header(bits, compression, stream):
    """A 4x4 BMP whose header says RLE8 (1) or RLE4 (2) at `bits` bits, its
    rows the run-length `stream` after a grey-free palette."""
    raw = bmp_header(bits, compression)
    colours = 1 << bits
    off = 14 + 40 + 4 * colours
    palette = bytes((i * 37) & 255 for i in range(4 * colours))
    return raw[:10] + struct.pack("<I", off) + raw[14:54] + palette + stream


def inter_frame_vp8() -> bytes:
    """A lossy WebP's VP8 frame with its key-frame bit cleared (an inter
    frame, which no still WebP holds and libwebp refuses)."""
    frame = bytearray(dict(webp_chunks(save(pillow_modes(16, 16)["RGB"], "WEBP")))[b"VP8 "])
    frame[0] |= 1
    return bytes(frame)


def tga16(flags=0x20):
    """A 2x2 16-bit true-colour TGA (type 2), some pixels with the top bit set."""
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, 2, 2, 16, flags)
    return head + struct.pack("<4H", 0x7C1F, 0x83E0, 0x0421, 0xFFFF)


# the variants the port refused until it read them: each now decodes as Pillow's
IMAGE_READ_NOW = {
    "RLE8-compressed BMP": (lambda: rle_bmp_header(8, 1, b"\x04\x05\x00\x00\x00\x04\x01\x02"
                                                   b"\x03\x04\x00\x00\x02\x07\x02\x09\x00\x00"
                                                   b"\x01\x03\x00\x00\x00\x01"), ""),
    "RLE4-compressed BMP": (lambda: rle_bmp_header(4, 2, b"\x04\x12\x00\x00\x00\x04\x34\x56"
                                                   b"\x00\x00\x03\x7a\x00\x00\x04\xbc\x00\x01"),
                            ""),
    "16-bit BMP": (lambda: bmp_header(16, 0), ""),
    "12-byte header": (os2_bmp, ""),
    "16-bit TGA": (tga16, "a.tga"),
    "WebP": (lambda: save(pillow_modes(2, 2)["RGB"], "WEBP", save_all=True,
                          append_images=[pillow_modes(2, 2, seed=1)["RGB"]]), ""),
    "TIFF": (lambda: save(pillow_modes(8, 8)["RGB"], "TIFF", compression="jpeg"), ""),
}


@pytest.mark.parametrize("variant", list(IMAGE_READ_NOW))
def test_image_variants_once_refused_match_pillow(variant):
    make, name = IMAGE_READ_NOW[variant]
    assert_pillow_equal(make(), name)


IMAGE_REFUSALS = {
    "BMP bit fields": (lambda: bmp_bitfields(rgba(2, 2), 124, (0xFF00, 0xFF, 0xFF0000, 0)), ""),
    "32-bit colour map": (lambda: tga_mapped(np.zeros((2, 2), np.uint8),
                                             np.zeros((4, 4), np.uint8), depth=32), "a.tga"),
    "TGA image type 32": (lambda: b"\x00\x00\x20" + bytes(9) + b"\x02\x00\x02\x00\x08\x00",
                          "a.tga"),
    "JPEG 2000": (lambda: j2k_with(j2k_small(), [(0xFF50, struct.pack(">IH", 1 << 17, 0))]),
                  ""),
    "JPEG 2000 HT block coder": (lambda: j2k_with(j2k_small(), cod=cod_style(0x40)), ""),
    "JPEG 2000 code-block bypass": (lambda: j2k_with(j2k_small(), cod=cod_style(0x01)), ""),
    "JPEG 2000 code-block context reset": (lambda: j2k_with(j2k_small(), cod=cod_style(0x02)),
                                           ""),
    "JPEG 2000 code-block termination on each pass": (
        lambda: j2k_with(j2k_small(), cod=cod_style(0x04)), ""),
    "JPEG 2000 code-block vertically causal context": (
        lambda: j2k_with(j2k_small(), cod=cod_style(0x08)), ""),
    "JPEG 2000 code-block predictable termination": (
        lambda: j2k_with(j2k_small(), cod=cod_style(0x10)), ""),
    "JPEG 2000 code-block segmentation symbols": (
        lambda: j2k_with(j2k_small(), cod=cod_style(0x20)), ""),
    "JPEG 2000 RGN": (lambda: j2k_with(j2k_small(), [(0xFF5E, bytes([0, 0, 3]))]), ""),
    "JPEG 2000 POC": (lambda: j2k_with(j2k_small(), [(0xFF5F, bytes([0, 0, 0, 1, 3, 3, 0]))]),
                      ""),
    "JPEG 2000 PPM": (lambda: j2k_with(j2k_small(), [(0xFF60, bytes([0, 0, 0, 0, 1, 0]))]), ""),
    "JPEG 2000 PPT": (lambda: j2k_with(j2k_small(), part_extra=[(0xFF61, bytes([0, 0]))]), ""),
    "JPEG 2000 component subsampling": (
        lambda: j2k_with(j2k_small(), siz=siz_component(1, dx=2)), ""),
    "JPEG 2000 image of 5 components": (lambda: j2k_with(j2k_small(), siz=siz_components(5)),
                                        ""),
    "JPEG 2000 precision 32": (lambda: j2k_with(j2k_small(), siz=siz_component(0, ssiz=31)),
                               ""),
    "JPEG 2000 sYCC colour space": (
        lambda: jp2_wrap(j2k_small(), colr=struct.pack(">BBBI", 1, 0, 0, 18)), ""),
    "JPEG 2000 ICC profile colour space": (
        lambda: jp2_wrap(j2k_small(), colr=struct.pack(">BBB", 2, 0, 0) + bytes(128)), ""),
    "DDS": (lambda: b"DDS " + struct.pack("<I", 124) + bytes(120), "texture.dds"),
    "WebP": (lambda: riff([(b"VP8 ", inter_frame_vp8())]), ""),
    "TIFF": (lambda: write_tiff(np.zeros((4, 4, 3), np.uint8), 2, tags={259: (3, [6])}), ""),
    "unknown format": (lambda: save(pillow_modes(2, 2)["RGB"], "TGA"), "no-extension"),
}


@pytest.mark.parametrize("variant", list(IMAGE_REFUSALS))
def test_image_refusals(variant):
    make, name = IMAGE_REFUSALS[variant]
    with pytest.raises(NotImplementedError, match=f"{variant}.*ROADMAP"):
        decode_image_u8(make(), name)


def test_decode_image_rgba_scales_to_unit_floats():
    raw = jpeg_file(5, 6)
    got = decode_image_rgba(raw)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, pillow(raw).astype(np.float32) / 255.0)


# ---- OpenEXR --------------------------------------------------------------------------------

EXR_TYPES = {"uint": (0, np.dtype("<u4")), "half": (1, np.dtype("<f2")),
             "float": (2, np.dtype("<f4"))}
EXR_COMPRESSIONS = {"NONE": 0, "RLE": 1, "ZIPS": 2, "ZIP": 3}


def _attr(name: str, kind: str, value: bytes) -> bytes:
    return name.encode() + b"\x00" + kind.encode() + b"\x00" + struct.pack("<i", len(value)) + value


def _rle(data: bytes) -> bytes:
    """OpenEXR run-length packets: runs of 3 or more equal bytes (at most
    128) as (n - 1, byte), the rest as literal runs of at most 127 (-n, bytes)."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([j - i - 1, data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 127 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([(256 - (j - i)) & 0xFF]) + data[i:j]
        i = j
    return bytes(out)


def _predict(data: bytes) -> bytes:
    """OpenEXR's byte split (even bytes, then odd) and predictor (each
    byte as its difference from the one before, + 128)."""
    b = np.frombuffer(data, np.uint8)
    t = np.concatenate([b[0::2], b[1::2]]).astype(np.int64)
    d = t.copy()
    d[1:] = (t[1:] - t[:-1] + 128) & 0xFF
    return d.astype(np.uint8).tobytes()


def write_exr(channels: dict, compression: str = "ZIP", origin=(0, 0), version_flags=0,
              compression_code=None) -> bytes:
    """A single-part scanline OpenEXR file: {name: [H, W] array of
    uint32, float16 or float32}, its data window at `origin`."""
    names = sorted(channels)
    h, w = channels[names[0]].shape
    types = {n: {"u": "uint", "f": "float"}[channels[n].dtype.kind]
             if channels[n].dtype != np.float16 else "half" for n in names}
    chlist = b"".join(n.encode() + b"\x00" + struct.pack("<iB3xii", EXR_TYPES[types[n]][0], 0, 1, 1)
                      for n in names) + b"\x00"
    x0, y0 = origin
    box = struct.pack("<iiii", x0, y0, x0 + w - 1, y0 + h - 1)
    code = EXR_COMPRESSIONS.get(compression) if compression_code is None else compression_code
    header = (_attr("channels", "chlist", chlist) + _attr("compression", "compression",
              bytes([code])) + _attr("dataWindow", "box2i", box)
              + _attr("displayWindow", "box2i", box) + _attr("lineOrder", "lineOrder", b"\x00")
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)) + b"\x00")
    lines = 16 if compression == "ZIP" else 1
    blocks = []
    for y in range(0, h, lines):
        raw = b"".join(np.ascontiguousarray(channels[n][r], EXR_TYPES[types[n]][1]).tobytes()
                       for r in range(y, min(h, y + lines)) for n in names)
        if compression in ("ZIP", "ZIPS"):
            packed = zlib.compress(_predict(raw), 9)
        elif compression == "RLE":
            packed = _rle(_predict(raw))
        else:
            packed = raw
        data = packed if len(packed) < len(raw) else raw
        blocks.append(struct.pack("<ii", y0 + y, len(data)) + data)
    start = 8 + len(header) + 8 * len(blocks)
    offsets, at = [], start
    for b in blocks:
        offsets.append(at)
        at += len(b)
    return (exr.EXR_MAGIC + struct.pack("<I", 2 | version_flags) + header
            + struct.pack(f"<{len(offsets)}Q", *offsets) + b"".join(blocks))


def exr_values(layout, kind, h=19, w=13, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for i, name in enumerate(layout):
        if kind == "uint":
            v = rng.integers(0, 2**32, (h, w), dtype=np.uint32)
            v.flat[:3] = (0, 1, 2**32 - 1)
        else:
            v = rng.lognormal(0, 3, (h, w)) * rng.choice([-1, 1], (h, w))
            v.flat[:4] = (0.0, 65504.0, 6e-8, 1.0 + i)  # zero, the largest half, a subnormal
            if i == 0:
                v[-1] = 1.0  # a long equal run for RLE
            v = v.astype(np.float16 if kind == "half" else np.float32)
        out[name] = v
    return out


EXR_GRID = [(c, k, layout) for c in EXR_COMPRESSIONS for k in EXR_TYPES
            for layout in ("RGB", "RGBA", "Y")]


@pytest.mark.parametrize("compression, kind, layout", EXR_GRID)
def test_read_exr_returns_the_written_values(compression, kind, layout):
    values = exr_values(layout, kind)
    got = exr.read_exr(write_exr(values, compression))
    want = np.stack([values[c].astype(np.float32) for c in layout], -1)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("compression", list(EXR_COMPRESSIONS))
def test_read_exr_data_window_and_mixed_types(compression):
    """A data window away from the origin (negative x, y = 5), 37 rows
    (a last ZIP block of 5), channels of three types."""
    rng = np.random.default_rng(3)
    values = {"R": rng.normal(0, 10, (37, 6)).astype(np.float32),
              "G": rng.normal(0, 10, (37, 6)).astype(np.float16),
              "B": rng.integers(0, 1000, (37, 6), dtype=np.uint32)}
    got = exr.read_exr(write_exr(values, compression, origin=(-3, 5)))
    np.testing.assert_array_equal(got, np.stack([values[c].astype(np.float32) for c in "RGB"], -1))


def test_read_exr_stores_incompressible_blocks_as_they_are():
    """Random float32 bits do not shrink under ZIP: such blocks are stored
    raw, and a smooth channel beside them is compressed."""
    rng = np.random.default_rng(4)
    noise = rng.integers(0, 2**32, (16, 64), dtype=np.uint32).view(np.float32)
    noise = np.where(np.isfinite(noise), noise, 1.0).astype(np.float32)
    values = {"Y": noise}
    raw = write_exr(values, "ZIP")
    (size,) = struct.unpack("<i", raw[-(16 * 64 * 4) - 4 : -(16 * 64 * 4)])
    assert size == 16 * 64 * 4  # stored as it is
    np.testing.assert_array_equal(exr.read_exr(raw)[..., 0], noise)
    smooth = {"Y": np.ones((16, 64), np.float32)}
    assert len(write_exr(smooth, "ZIP")) < 1000
    np.testing.assert_array_equal(exr.read_exr(write_exr(smooth, "ZIP"))[..., 0], smooth["Y"])


EXR_REFUSALS = {
    **{name: dict(compression="NONE", compression_code=code) for code, name in
       enumerate(("PIZ", "PXR24", "B44", "B44A", "DWAA", "DWAB"), start=4)},
    "tiled": dict(version_flags=0x200),
    "deep": dict(version_flags=0x800),
    "multi-part": dict(version_flags=0x1000),
}


@pytest.mark.parametrize("variant", list(EXR_REFUSALS))
def test_read_exr_refusals(variant):
    raw = write_exr(exr_values("RGB", "half", 2, 2), **EXR_REFUSALS[variant])
    with pytest.raises(NotImplementedError, match=f"{variant}.*ROADMAP"):
        exr.read_exr(raw)


def test_read_exr_refuses_other_channels():
    with pytest.raises(NotImplementedError, match="channel set.*ROADMAP"):
        exr.read_exr(write_exr(exr_values("XYZ", "half", 2, 2)))
    sub = write_exr(exr_values("RGB", "half", 2, 2)).replace(
        struct.pack("<iB3xii", 1, 0, 1, 1), struct.pack("<iB3xii", 1, 0, 2, 2), 1)
    with pytest.raises(NotImplementedError, match="subsampled.*ROADMAP"):
        exr.read_exr(sub)


# ---- writing GIF, TIFF and WebP files -------------------------------------------------------

def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i : i + 255])]) + data[i : i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def gif_raw(idx, palette=None, min_bits=8, transparency=None, interlace=False, screen=None,
            offset=(0, 0), local=False) -> bytes:
    """A GIF89a of one image: indices [h, w] (any values below 2^min_bits,
    also past the colour table), coded as LZW literals with a clear code
    before the table would widen the codes; the colour table `palette`
    ([2^k, 3]) global or local; the image at `offset` on a logical screen
    of `screen` (w, h)."""
    idx = np.asarray(idx, np.uint8)
    h, w = idx.shape
    sw, sh = screen or (w, h)
    flags = 0
    table = b""
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        bits = int(np.log2(len(palette)))
        flags = 0x80 | (bits - 1)
        table = palette.tobytes()
    out = b"GIF89a" + struct.pack("<HHBBB", sw, sh, 0 if local else flags, 0, 0)
    if not local:
        out += table
    if transparency is not None:
        out += b"\x21\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) + b"\x00"
    rows = idx
    if interlace:
        rows = idx[np.concatenate([np.arange(a, h, b) for a, b in ((0, 8), (4, 8), (2, 4),
                                                                   (1, 2))])]
    iflags = (0x40 if interlace else 0) | (flags if local else 0)
    out += b"\x2c" + struct.pack("<HHHHB", offset[0], offset[1], w, h, iflags)
    if local:
        out += table
    clear, width = 1 << min_bits, min_bits + 1
    codes = []
    for k, v in enumerate(rows.reshape(-1).tolist()):
        if k % (clear - 2) == 0:
            codes.append(clear)
        codes.append(v)
    codes.append(clear + 1)
    acc = nbits = 0
    data = bytearray()
    for c in codes:
        acc |= c << nbits
        nbits += width
        while nbits >= 8:
            data.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        data.append(acc & 255)
    return out + bytes([min_bits]) + _sub_blocks(bytes(data)) + b"\x3b"


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW: codes most significant bit first, widened as libtiff's
    encoder widens them (the decoder's early change), a clear code before
    the table fills."""
    def fresh():
        return {bytes([i]): i for i in range(256)}, 258, 9

    table, nxt, width = fresh()
    codes = [(256, 9)]
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        codes.append((table[w], width))
        table[wc] = nxt
        nxt += 1
        if nxt >= 1 << width and width < 12:
            width += 1
        if nxt >= 4093:
            codes.append((256, width))
            table, nxt, width = fresh()
        w = bytes([c])
    if w:
        codes.append((table[w], width))
        nxt += 1
        if nxt >= 1 << width and width < 12:
            width += 1
    codes.append((257, width))
    acc = nbits = 0
    out = bytearray()
    for code, n in codes:
        acc = (acc << n) | code
        nbits += n
        while nbits >= 8:
            out.append((acc >> (nbits - 8)) & 255)
            nbits -= 8
    if nbits:
        out.append((acc << (8 - nbits)) & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _tiff_rows(px: np.ndarray, bps: int, order: str) -> bytes:
    """[rows, w, n] samples -> bytes, each row padded to a byte."""
    rows, w, n = px.shape
    if bps == 16:
        return np.ascontiguousarray(px, order + "u2").tobytes()
    if bps == 8:
        return np.ascontiguousarray(px, np.uint8).tobytes()
    flat = px.reshape(rows, w * n).astype(np.uint8)
    per = 8 // bps
    flat = np.concatenate([flat, np.zeros((rows, -flat.shape[1] % per), np.uint8)], 1)
    shifts = np.arange(8 - bps, -1, -bps, dtype=np.uint8)
    return (flat.reshape(rows, -1, per) << shifts).sum(-1).astype(np.uint8).tobytes()


TIFF_COMPRESSIONS = {"none": 1, "LZW": 5, "Deflate": 8, "PackBits": 32773, "old Deflate": 32946,
                     "LZMA": 34925}
REVERSED_BITS = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def xz(data: bytes) -> bytes:
    """An .xz stream, as libtiff's LZMA codec writes a strip."""
    return lzma.compress(data, format=lzma.FORMAT_XZ)


def write_tiff(px, photometric, bps=8, extra=(), compression="none", predictor=1, planar=1,
               tile=None, rows_per_strip=None, order="<", colour_map=None, tags=None,
               fill_order=1) -> bytes:
    """A classic TIFF of samples px [h, w, n] (uint8 or uint16): strips of
    `rows_per_strip` rows or tiles of `tile` (w, h); planar configuration
    1 or 2; horizontal differencing where predictor is 2; fill order 2
    reverses the bits of every byte written (FillOrder written where it is
    not 1); extra `tags` {tag: (type, values)} override the written ones."""
    px = np.asarray(px)
    px = px[..., None] if px.ndim == 2 else px
    h, w, n = px.shape
    code = TIFF_COMPRESSIONS[compression]

    def encode(block):
        if predictor == 2:
            d = block.astype(np.int64)
            d[:, 1:] -= block[:, :-1].astype(np.int64)
            block = (d & (0xFFFF if bps == 16 else 0xFF)).astype(block.dtype)
        if code == 32773:  # PackBits packs each row apart
            return b"".join(packbits(_tiff_rows(r[None], bps, order)) for r in block)
        data = _tiff_rows(block, bps, order)
        if code == 1:
            return data
        return {5: tiff_lzw, 34925: xz}.get(code, lambda b: zlib.compress(b, 6))(data)

    if fill_order != 1:
        plain = encode
        encode = lambda block: plain(block).translate(REVERSED_BITS)  # noqa: E731
    planes = [px] if planar == 1 else [px[..., i : i + 1] for i in range(n)]
    blocks = []
    for plane in planes:
        if tile:
            tw, tl = tile
            for y in range(0, h, tl):
                for x in range(0, w, tw):
                    t = np.zeros((tl, tw, plane.shape[2]), plane.dtype)
                    part = plane[y : y + tl, x : x + tw]
                    t[: part.shape[0], : part.shape[1]] = part
                    blocks.append(encode(t))
        else:
            rps = rows_per_strip or h
            blocks += [encode(plane[y : y + rps]) for y in range(0, h, rps)]
    offsets, data = [], b""
    for b in blocks:
        offsets.append(8 + len(data))
        data += b + b"\x00" * (len(b) % 2)
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * n), 259: (3, [code]),
               262: (3, [photometric]), 277: (3, [n]), 284: (3, [planar])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if extra:
        entries[338] = (3, list(extra))
    if colour_map is not None:
        entries[320] = (3, list(colour_map))
    if tile:
        entries.update({322: (4, [tile[0]]), 323: (4, [tile[1]]), 324: (4, offsets),
                        325: (4, [len(b) for b in blocks])})
    else:
        entries.update({273: (4, offsets), 278: (4, [rows_per_strip or h]),
                        279: (4, [len(b) for b in blocks])})
    entries.update(tags or {})
    ifd = 8 + len(data)
    at = ifd + 2 + 12 * len(entries) + 4
    body, spill = b"", b""
    for tag, (kind, vals) in sorted(entries.items()):
        value = struct.pack(order + {3: "H", 4: "I", 7: "B"}[kind] * len(vals), *vals)
        if len(value) <= 4:
            body += struct.pack(order + "HHI", tag, kind, len(vals)) + value.ljust(4, b"\x00")
        else:
            body += struct.pack(order + "HHII", tag, kind, len(vals), at + len(spill))
            spill += value + b"\x00" * (len(value) % 2)
    head = (b"II*\x00" if order == "<" else b"MM\x00*") + struct.pack(order + "I", ifd)
    return head + data + struct.pack(order + "H", len(entries)) + body + bytes(4) + spill


def webp_chunks(raw: bytes) -> list:
    out, pos = [], 12
    while pos + 8 <= len(raw):
        (size,) = struct.unpack("<I", raw[pos + 4 : pos + 8])
        out.append((raw[pos : pos + 4], raw[pos + 8 : pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def riff(chunks) -> bytes:
    body = b"WEBP" + b"".join(k + struct.pack("<I", len(d)) + d + b"\x00" * (len(d) & 1)
                              for k, d in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def alpha_filtered(alpha: np.ndarray, kind: int) -> np.ndarray:
    """libwebp's forward alpha filters: 0 none, 1 horizontal, 2 vertical,
    3 gradient (each row's first pixel from the one above; the first row
    from the left)."""
    a = alpha.astype(np.int64)
    d = a.copy()
    d[0, 1:] = a[0, 1:] - a[0, :-1]
    if kind == 0:
        return alpha.copy()
    d[1:, 0] = a[1:, 0] - a[:-1, 0]
    if kind == 1:
        d[1:, 1:] = a[1:, 1:] - a[1:, :-1]
    elif kind == 2:
        d[1:, 1:] = a[1:, 1:] - a[:-1, 1:]
    else:
        d[1:, 1:] = a[1:, 1:] - np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return (d & 255).astype(np.uint8)


def lossy_with_alpha(rgb: np.ndarray, alpha: np.ndarray, quality=80, compressed=True,
                     kind=0) -> bytes:
    """A VP8X file: Pillow's lossy RGB, and an ALPH chunk written here
    with filter `kind`, raw or as a headerless VP8L stream (Pillow's
    lossless encoding of the filtered plane in green)."""
    h, w = alpha.shape
    vp8 = dict(webp_chunks(save(Image.fromarray(rgb), "WEBP", quality=quality)))[b"VP8 "]
    plane = alpha_filtered(alpha, kind)
    if compressed:
        grey = np.repeat(plane[..., None], 3, -1)
        vp8l = dict(webp_chunks(save(Image.fromarray(grey), "WEBP", lossless=True)))[b"VP8L"]
        data = bytes([1 | kind << 2]) + vp8l[5:]  # the stream after its 5-byte header
    else:
        data = bytes([kind << 2]) + plane.tobytes()
    head = struct.pack("<B3x", 0x10) + struct.pack("<I", w - 1)[:3] + struct.pack("<I", h - 1)[:3]
    return riff([(b"VP8X", head), (b"ALPH", data), (b"VP8 ", vp8)])


# ---- writing JPEG 2000 files ----------------------------------------------------------------

def j2k(img: Image.Image, **kw) -> bytes:
    """Pillow's JPEG 2000 file of `img` (JP2, or with no_jp2=True a raw
    codestream)."""
    return save(img, "JPEG2000", **kw)


def j2k_parse(cs: bytes):
    """A raw codestream -> (main-header segments [(marker, body)], tile-parts
    [dict(tile, part, parts, segs, data)])."""
    assert cs[:2] == b"\xff\x4f"
    pos, main = 2, []
    while cs[pos : pos + 2] != b"\xff\x90":
        marker, length = struct.unpack(">HH", cs[pos : pos + 4])
        main.append((marker, cs[pos + 4 : pos + 2 + length]))
        pos += 2 + length
    parts = []
    while cs[pos : pos + 2] == b"\xff\x90":
        _l, tile, psot, part, n = struct.unpack(">HHIBB", cs[pos + 2 : pos + 12])
        end = pos + psot if psot else len(cs) - 2
        q, segs = pos + 12, []
        while cs[q : q + 2] != b"\xff\x93":
            marker, length = struct.unpack(">HH", cs[q : q + 4])
            segs.append((marker, cs[q + 4 : q + 2 + length]))
            q += 2 + length
        parts.append(dict(tile=tile, part=part, parts=n, segs=segs, data=cs[q + 2 : end]))
        pos = end
    return main, parts


def j2k_join(main, parts) -> bytes:
    """The inverse of j2k_parse, each Psot recomputed."""
    out = bytearray(b"\xff\x4f")
    for marker, body in main:
        out += struct.pack(">HH", marker, len(body) + 2) + body
    for tp in parts:
        head = b"".join(struct.pack(">HH", m, len(b) + 2) + b for m, b in tp["segs"])
        out += struct.pack(">HHHIBB", 0xFF90, 10, tp["tile"], 14 + len(head) + len(tp["data"]),
                           tp["part"], tp["parts"]) + head + b"\xff\x93" + tp["data"]
    return bytes(out + b"\xff\xd9")


def j2k_with(cs: bytes, main_extra=(), part_extra=(), cod=None, siz=None) -> bytes:
    """The codestream with marker segments added to the main header and to
    the first tile-part's, the COD body passed through `cod` and the SIZ
    body through `siz`."""
    main, parts = j2k_parse(cs)
    main = [(m, cod(b) if cod and m == 0xFF52 else siz(b) if siz and m == 0xFF51 else b)
            for m, b in main] + list(main_extra)
    parts[0]["segs"] = parts[0]["segs"] + list(part_extra)
    return j2k_join(main, parts)


def cod_style(style: int):
    """A COD editor setting the code-block style byte."""
    return lambda body: body[:8] + bytes([style]) + body[9:]


def siz_component(c: int, ssiz=None, dx=None):
    """A SIZ editor setting component c's Ssiz byte or its XRsiz."""
    def edit(body):
        b = bytearray(body)
        at = 36 + 3 * c
        if ssiz is not None:
            b[at] = ssiz
        if dx is not None:
            b[at + 1] = dx
        return bytes(b)
    return edit


def siz_components(n: int):
    """A SIZ editor declaring n components, the last one repeated."""
    def edit(body):
        comps = body[36:]
        return body[:34] + struct.pack(">H", n) + comps + comps[-3:] * (n - len(comps) // 3)
    return edit


def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(body), kind) + body


def jp2_wrap(cs: bytes, extra: bytes = b"", colr: bytes = None) -> bytes:
    """A JP2 file around a raw codestream, its ihdr from the SIZ: `colr`
    (the colr box's body, default enumerated sRGB) and `extra` boxes after
    it in jp2h."""
    main, _parts = j2k_parse(cs)
    siz = dict(main)[0xFF51]
    xsiz, ysiz, xo, yo = struct.unpack(">IIII", siz[2:18])
    (nc,) = struct.unpack(">H", siz[34:36])
    ihdr = struct.pack(">IIHBBBB", ysiz - yo, xsiz - xo, nc, siz[36], 7, 0, 0)
    colr = struct.pack(">BBBI", 1, 0, 0, 16) if colr is None else colr
    return (box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + box(b"jp2h", box(b"ihdr", ihdr) + box(b"colr", colr) + extra) + box(b"jp2c", cs))


def palette_jp2(idx: np.ndarray, palette: np.ndarray, alpha=None, **kw) -> bytes:
    """A palette JP2: Pillow's raw 5/3 codestream of the uint8 index image
    `idx` (and of `alpha`, an LA image's second component), wrapped with
    a pclr box of `palette` ([n, 3] or [n, 4] uint8) and a cmap box."""
    img = Image.fromarray(idx) if alpha is None else Image.fromarray(
        np.stack([idx, alpha], -1), "LA")
    cs = j2k(img, no_jp2=True, **kw)
    npc = palette.shape[1]
    pclr = struct.pack(">HB", len(palette), npc) + bytes([7] * npc) + palette.astype(
        np.uint8).tobytes()
    cmap = b"".join(struct.pack(">HBB", 0, 1, k) for k in range(npc))
    return jp2_wrap(cs, box(b"pclr", pclr) + box(b"cmap", cmap))


def j2k_small(**kw) -> bytes:
    """A 5x7 RGB raw codestream of Pillow's."""
    return j2k(pillow_modes(5, 7)["RGB"], no_jp2=True, **kw)


# ---- DDS and PSD writers (tests/test_torch_image_formats_dds.py, _psd.py) -------------------

DDPF_ALPHAPIXELS, DDPF_FOURCC, DDPF_PALETTE, DDPF_RGB, DDPF_LUMINANCE = (0x1, 0x4, 0x20, 0x40,
                                                                        0x20000)


def dds_file(w, h, data, fourcc=None, dxgi=None, pfflags=DDPF_FOURCC, bitcount=0,
             masks=(0, 0, 0, 0), extra=b"", header_size=124, mipmaps=0) -> bytes:
    """A DDS file: the 124-byte header (a FourCC, or DX10 with a DXGI
    format and its 20-byte extension), `extra` (a palette), then `data`."""
    code = fourcc or (b"DX10" if dxgi is not None else bytes(4))
    head = struct.pack("<7I", header_size, 0x1007 | (0x20000 if mipmaps else 0), h, w, 0, 0,
                       mipmaps) + bytes(44)
    head += struct.pack("<2I", 32, pfflags) + code + struct.pack("<5I", bitcount, *masks)
    head += struct.pack("<5I", 0x1000 | (0x400008 if mipmaps else 0), 0, 0, 0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return b"DDS " + head + extra + data


def bc7_mode6(px: np.ndarray) -> bytes:
    """uint8 [H, W, 4] (H and W multiples of 4) -> BC7 blocks of mode 6,
    row by row: each block's endpoints the per-channel minimum and maximum
    (7 bits and an endpoint's p-bit, the low bit most of its channels
    have), each pixel's 4-bit index its projection on the segment, swapped
    so that pixel 0's index is below 8 (the anchor drops its top bit)."""
    h, w, _ = px.shape
    blk = px.reshape(h // 4, 4, w // 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 4)
    blk = blk.astype(np.int64)
    ends = np.stack([blk.min(1), blk.max(1)], 1)  # [nb, 2, 4]
    pbit = ((ends & 1).sum(-1) >= 2).astype(np.int64)  # [nb, 2]
    q = np.clip((ends - pbit[..., None] + 1) >> 1, 0, 127)
    e = (q << 1) | pbit[..., None]  # the decoder's 8-bit endpoints
    d = (e[:, 1] - e[:, 0])[:, None, :]
    num = ((blk - e[:, 0][:, None, :]) * d).sum(-1)
    den = np.maximum((d * d).sum(-1), 1)
    idx = np.clip(np.rint(num * 15 / den), 0, 15).astype(np.int64)
    swap = idx[:, 0] >= 8
    q[swap] = q[swap][:, ::-1]
    pbit[swap] = pbit[swap][:, ::-1]
    idx[swap] = 15 - idx[swap]
    # the mode (bit 6), R0 R1 G0 G1 B0 B1 A0 A1, the two p-bits, the indices
    fields = [np.full((len(blk), 1), 1 << 6)] + [q[:, k, c:c + 1] for c in range(4) for k in (0, 1)]
    fields += [pbit[:, 0:1], pbit[:, 1:2]] + [idx[:, i:i + 1] for i in range(16)]
    widths = [7] * 9 + [1, 1, 3] + [4] * 15
    bits = np.concatenate([(f >> np.arange(n)) & 1 for f, n in zip(fields, widths)], 1)
    return np.packbits(bits.astype(np.uint8), axis=1, bitorder="little").tobytes()


def write_psd(planes, colour, depth=8, compression=1, colour_data=b"", resources=(),
              layers=b"", version=1, channels=None, counts=None, width=None) -> bytes:
    """A PSD of uint8 planes [C, H, row bytes] (1-bit rows packed most
    significant bit first, `width` pixels of them): the header (`channels`
    in it, C by default),
    the colour-mode data, image resources ((id, name, data), names and
    data padded to even lengths), the layer and mask section, then the
    planes raw (0) or PackBits (1) row by row with their byte counts
    (`counts` replaces them)."""
    planes = np.asarray(planes, np.uint8)
    c, h, row = planes.shape
    w = width or (row * 8 if depth == 1 else row)
    out = b"8BPS" + struct.pack(">H", version) + bytes(6)
    out += struct.pack(">HIIHH", channels or c, h, w, depth, colour)
    out += struct.pack(">I", len(colour_data)) + colour_data
    res = b""
    for rid, name, data in resources:
        pascal = bytes([len(name)]) + name
        res += b"8BIM" + struct.pack(">H", rid) + pascal + bytes(len(pascal) & 1)
        res += struct.pack(">I", len(data)) + data + bytes(len(data) & 1)
    out += struct.pack(">I", len(res)) + res + struct.pack(">I", len(layers)) + layers
    out += struct.pack(">H", compression)
    if compression != 1:
        return out + planes.tobytes()
    rows = [packbits(planes[i, y].tobytes()) for i in range(c) for y in range(h)]
    counts = [len(r) for r in rows] if counts is None else counts
    return out + b"".join(struct.pack(">H", n) for n in counts) + b"".join(rows)


def psd_of(img: Image.Image, compression=1, **kw) -> bytes:
    """A Pillow image as a PSD (write_psd): 1 as packed bits, L, P (its
    palette as 256 reds, greens, blues), RGB, RGBA, CMYK (stored
    inverted)."""
    a = np.asarray(img)
    if img.mode == "1":
        return write_psd(np.packbits(a, axis=1)[None], 0, 1, compression, width=img.width, **kw)
    if img.mode == "L":
        return write_psd(a[None], 1, 8, compression, **kw)
    if img.mode == "P":
        pal = np.zeros((256, 3), np.uint8)
        got = np.asarray(img.getpalette("RGB"), np.uint8).reshape(-1, 3)
        pal[: len(got)] = got
        return write_psd(a[None], 2, 8, compression, pal.T.tobytes(), **kw)
    planes = a.transpose(2, 0, 1)
    if img.mode == "CMYK":
        return write_psd(255 - planes, 4, 8, compression, **kw)
    return write_psd(planes, 3, 8, compression, **kw)


# ---- the classic formats: PNM, ICO / CUR, PCX / DCX, SGI -----------------------------------

def pnm(px: np.ndarray, magic: bytes, maxval: int = 255, sep: bytes = b"\n",
        comment: bytes = b"") -> bytes:
    """A PNM of `magic`: P1 / P4 of px [H, W] bits (1 black); P2, P3 (plain)
    and P5, P6, P0CMYK, PyP, PyRGBA, PyCMYK (raw) of px [H, W] or [H, W, n]
    samples at `maxval` (two big-endian bytes a raw sample above 255), the
    header's tokens `sep` apart, `comment` ("# ..." and its line end) after
    the magic number and in the plain samples."""
    h, w = px.shape[:2]
    head = magic + sep + comment + b"%d%s%d" % (w, sep, h)
    if magic not in (b"P1", b"P4"):
        head += sep + b"%d" % maxval
    head += b"\n"
    if magic == b"P1":
        return head + b"".join(b"".join(b"%d" % v for v in row) + b"\n" + comment
                               for row in px)
    if magic == b"P4":
        return head + np.packbits(px.astype(np.uint8), axis=1).tobytes()
    if magic in (b"P2", b"P3"):
        rows = px.reshape(h, -1)
        return head + b"".join(b" ".join(b"%d" % v for v in row) + b"\n" + comment
                               for row in rows)
    return head + px.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def pfm(values: np.ndarray, scale: float = -1.0) -> bytes:
    """A grey PFM (Pf): float32 values [H, W], rows bottom-up, little-endian
    where the scale is negative."""
    h, w = values.shape
    order = "<f4" if scale < 0 else ">f4"
    return b"Pf\n%d %d\n%r\n" % (w, h, scale) + values[::-1].astype(order).tobytes()


def dib_of(px: np.ndarray, bits: int, palette: np.ndarray = None, rows: int = None,
           height: int = None, top_down: bool = False) -> bytes:
    """A bare DIB (40-byte header, BI_RGB): px [H, W] palette indices at
    1, 4 or 8 bits with `palette` [n, 3] RGB, or [H, W, 3] (24 bits) or
    [H, W, 4] (32 bits, BGRA) pixels; `height` the header's (an icon's is
    twice its image's), rows bottom-up unless `top_down`."""
    h, w = px.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    if bits <= 8:
        shift = np.arange(8 // bits)[::-1] * bits
        padded = np.zeros((h, -(-w // (8 // bits)) * (8 // bits)), np.uint8)
        padded[:, :w] = px
        packed = (padded.reshape(h, -1, 8 // bits) << shift).sum(-1).astype(np.uint8)
    else:
        packed = px[..., [2, 1, 0, 3][: bits // 8]].reshape(h, -1)
    data = np.zeros((h, stride), np.uint8)
    data[:, : packed.shape[1]] = packed
    if not top_down:
        data = data[::-1]
    n = 0 if palette is None else len(palette)
    hf = height if height is not None else h
    info = struct.pack("<IiiHHIIiiII", 40, w, -hf if top_down else hf, 1, bits, 0, data.size, 0,
                       0, n, 0)
    pal = b"" if palette is None else np.concatenate(
        [np.asarray(palette, np.uint8)[:, ::-1], np.zeros((n, 1), np.uint8)], 1).tobytes()
    return info + pal + data.tobytes()


def and_mask(mask: np.ndarray) -> bytes:
    """An icon's AND mask: mask [H, W] bool (True transparent), 1 bit a
    pixel, rows padded to 32 bits, bottom-up."""
    h, w = mask.shape
    stride = -(-w // 32) * 4
    rows = np.zeros((h, stride), np.uint8)
    packed = np.packbits(mask.astype(np.uint8), axis=1)
    rows[:, : packed.shape[1]] = packed
    return rows[::-1].tobytes()


def icon_dib(px: np.ndarray, bits: int, palette=None, mask=None) -> bytes:
    """An ICO / CUR bitmap: the DIB at twice the height, then the AND mask
    (all opaque where `mask` is None; none at 32 bits unless given)."""
    h, w = px.shape[:2]
    out = dib_of(px, bits, palette, height=2 * h)
    if mask is not None or bits != 32:
        out += and_mask(np.zeros((h, w), bool) if mask is None else mask)
    return out


def icon_file(entries, cursor: bool = False) -> bytes:
    """An ICO (or CUR) of entries (payload, width, height, bit count, colour
    count) -- for a cursor the last two are the hotspot -- payloads in order
    after the directory."""
    out = (b"\0\0\2\0" if cursor else b"\0\0\1\0") + struct.pack("<H", len(entries))
    offset = 6 + 16 * len(entries)
    for payload, w, h, bits, colours in entries:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, 0 if cursor else colours, 0,
                           0 if not cursor else bits, colours if cursor else bits, len(payload),
                           offset)
        offset += len(payload)
    return out + b"".join(e[0] for e in entries)


def pcx_rle(line: bytes) -> bytes:
    """A PCX line coded: runs of up to 63 equal bytes, single bytes below
    0xC0 as they are."""
    out, i = bytearray(), 0
    while i < len(line):
        n = 1
        while i + n < len(line) and line[i + n] == line[i] and n < 63:
            n += 1
        if n > 1 or line[i] >= 0xC0:
            out += bytes([0xC0 | n, line[i]])
        else:
            out.append(line[i])
        i += n
    return bytes(out)


def pcx_header(width: int, height: int, bits: int, planes: int, stride: int, version: int = 5,
               palette16: bytes = bytes(48)) -> bytes:
    """A PCX's 128-byte header."""
    return (bytes([10, version, 1, bits])
            + struct.pack("<HHHHHH", 0, 0, width - 1, height - 1, 72, 72) + palette16 + b"\0"
            + bytes([planes]) + struct.pack("<HHHH", stride, 1, width, height) + bytes(54))


def pcx_file(lines: np.ndarray, width: int, bits: int, planes: int, version: int = 5,
             palette16: bytes = bytes(48), tail: bytes = b"", stride: int = None) -> bytes:
    """A PCX of `lines` [H, planes x stride] decoded bytes (each plane's
    bytes one after the other), RLE coded line by line, the header's stride
    `stride` (default: the line's), then `tail` (a 256-colour palette)."""
    stride = lines.shape[1] // planes if stride is None else stride
    return (pcx_header(width, len(lines), bits, planes, stride, version, palette16)
            + b"".join(pcx_rle(bytes(row)) for row in lines) + tail)


def dcx_file(images) -> bytes:
    """A DCX of the PCX files `images`."""
    offset = 4 + 4 * (len(images) + 1)
    table = []
    for img in images:
        table.append(offset)
        offset += len(img)
    return struct.pack("<I", 0x3ADE68B1) + struct.pack(f"<{len(table) + 1}I", *table, 0) + b"".join(
        images)


def sgi_rle_row(values: np.ndarray, bpc: int) -> bytes:
    """One SGI RLE row: runs of 2 or more equal samples as repeats, the
    rest as copies (at most 127 samples an op), then the end marker."""
    out, i, n = bytearray(), 0, len(values)
    word = (lambda v: struct.pack(">H", int(v))) if bpc == 2 else (lambda v: bytes([int(v)]))
    op = (lambda c: struct.pack(">H", c)) if bpc == 2 else (lambda c: bytes([c]))
    while i < n:
        k = 1
        while i + k < n and values[i + k] == values[i] and k < 127:
            k += 1
        if k > 1:
            out += op(k) + word(values[i])
        else:
            while i + k < n and k < 127 and values[i + k] != values[i + k - 1]:
                k += 1
            out += op(0x80 | k) + b"".join(word(v) for v in values[i : i + k])
        i += k
    return bytes(out + op(0))


def sgi_file(planes: np.ndarray, bpc: int = 1, rle: bool = True, dimension: int = None) -> bytes:
    """An SGI of planes [channels, H, W] (top row first; written
    bottom-up), verbatim or RLE (each row of each channel a stream, the
    streams in row order)."""
    z, h, w = planes.shape
    dimension = dimension or (3 if z > 1 else 2)
    head = struct.pack(">hBBHHHHll", 474, int(rle), bpc, dimension, w, h, z, 0,
                       255 if bpc == 1 else 65535).ljust(512, b"\0")
    rows = planes[:, ::-1]
    if not rle:
        return head + rows.astype(">u2" if bpc == 2 else np.uint8).tobytes()
    streams = {(r, c): sgi_rle_row(rows[c, r], bpc) for r in range(h) for c in range(z)}
    start, pos = {}, 512 + 8 * z * h
    for key in sorted(streams):
        start[key] = pos
        pos += len(streams[key])
    keys = [(r, c) for c in range(z) for r in range(h)]
    return (head + struct.pack(f">{z * h}I", *(start[k] for k in keys))
            + struct.pack(f">{z * h}I", *(len(streams[k]) for k in keys))
            + b"".join(streams[k] for k in sorted(streams)))


# ---- the fixtures of tests/data_torch/formats -----------------------------------------------

BIG = "photo-1024-420.jpg"
BIG_WEBP = "photo-1024-q90.webp"
BT_JPEG = "BreakTime-JPEG.glb"
BT_TWIN = "BreakTime-JPEG-twin.glb"
BT_MIXED = "BreakTime-mixed.glb"
BT_MIXED_TWIN = "BreakTime-mixed-twin.glb"
BT_SKY_EXR = "BreakTimeSky.exr"
BIG_J2K_53 = "photo-1024-53.jp2"
BIG_J2K_97 = "photo-1024-97.jp2"
BT_J2K = "BreakTime-J2K.glb"
BT_J2K_TWIN = "BreakTime-J2K-twin.glb"


def small_fixtures() -> dict:
    """name -> the bytes of each small fixture image."""
    px = pillow_modes(21, 35, seed=5)
    return {
        "baseline-444.jpg": jpeg_file(23, 37, subsampling=0, seed=6),
        "baseline-422-optimized.jpg": jpeg_file(37, 23, subsampling=1, optimize=True, seed=7),
        "baseline-420-restart.jpg": jpeg_file(31, 45, subsampling=2, restart_marker_blocks=3,
                                              seed=8),
        "progressive-420.jpg": jpeg_file(45, 33, subsampling=2, progressive=True, seed=9),
        "progressive-grey-restart.jpg": jpeg_file(17, 29, "L", progressive=True,
                                                  restart_marker_rows=1, seed=10),
        "extended-440.jpg": with_sof(transpose_sampling(jpeg_file(19, 27, subsampling=1,
                                                                  seed=11)), 0xC1),
        "rgb-adobe.jpg": jpeg_file(13, 11, keep_rgb=True, seed=12),
        "palette-8bit.bmp": save(px["P"], "BMP"),
        "rgb-24bit.bmp": save(px["RGB"], "BMP"),
        "bgra-v5-topdown.bmp": bmp_bitfields(rgba(21, 35, 5), 124, top_down=True),
        "rgba-rle-bottomup.tga": save(px["RGBA"], "TGA", compression="tga_rle"),
        "grey-topdown.tga": save(px["L"], "TGA", orientation=1),
        "mapped-rle.tga": tga_mapped(
            np.random.default_rng(13).integers(2, 8, (21, 35), dtype=np.uint8),
            np.random.default_rng(14).integers(0, 256, (6, 3), dtype=np.uint8), 0x10, True),
        **gif_tiff_webp_fixtures(px),
        **jpeg2000_fixtures(px),
    }


def gif_tiff_webp_fixtures(px) -> dict:
    """The GIF, TIFF and WebP fixtures, from Pillow's modes of one 21x35
    picture (`pillow_modes(21, 35, seed=5)`) and this module's writers."""
    rgb, rgba16 = np.asarray(px["RGB"]), rgba(21, 35, 16)
    rng = np.random.default_rng(17)
    return {
        "palette-interlaced.gif": save(px["P"], "GIF", interlace=True),
        "grey-transparent.gif": save(px["L"], "GIF", transparency=40),
        "placed-local-table.gif": gif_raw(rng.integers(0, 9, (13, 17)), rng.integers(
            0, 256, (8, 3)), min_bits=4, transparency=3, screen=(29, 19), offset=(7, 5),
            local=True),
        "rgb-lzw-predictor.tif": save(px["RGB"], "TIFF", compression="tiff_lzw",
                                      tiffinfo={317: 2}),
        "rgba-deflate-tiles-mm.tif": write_tiff(rgba16, 2, extra=(2,), compression="Deflate",
                                                predictor=2, tile=(16, 16), order=">"),
        "rgb16-planar-lzw.tif": write_tiff(rng.integers(0, 65536, (21, 35, 3)).astype(
            np.uint16), 2, 16, compression="LZW", planar=2, rows_per_strip=8),
        "grey16-packbits.tif": write_tiff(rng.integers(0, 700, (21, 35)).astype(np.uint16), 1, 16,
                                          compression="PackBits", rows_per_strip=5),
        "bilevel-miniswhite.tif": write_tiff(rng.integers(0, 2, (21, 35)), 0, 1,
                                             compression="PackBits"),
        "palette4-deflate.tif": write_tiff(rng.integers(0, 16, (21, 35)), 3, 4,
                                           compression="old Deflate",
                                           colour_map=rng.integers(0, 65536, 48).tolist()),
        "rgba-associated.tif": write_tiff(rgba16, 2, extra=(1,), compression="LZW",
                                          rows_per_strip=7),
        "lossy-q75-odd.webp": save(px["RGB"], "WEBP", quality=75),
        "lossy-alpha-m6.webp": save(Image.fromarray(rgba16), "WEBP", quality=60, method=6,
                                    alpha_quality=70),
        "lossy-alpha-raw-gradient.webp": lossy_with_alpha(rgb, rgba16[..., 3], 85, False, 3),
        "lossless-rgba.webp": save(Image.fromarray(rgba16), "WEBP", lossless=True, exact=True),
        "lossless-palette.webp": save(px["P"].convert("RGB"), "WEBP", lossless=True, quality=100,
                                      method=6),
    }


def jpeg2000_fixtures(px) -> dict:
    """The JPEG 2000 fixtures: Pillow's files of one 21x35 picture
    (`pillow_modes(21, 35, seed=5)`), each a distinct path through the
    decoder, and a palette JP2 of this module's writer."""
    rgb, rng = px["RGB"], np.random.default_rng(18)
    deep = Image.fromarray((np.asarray(px["L"]).astype(np.uint16) * 257).astype("<u2"))
    layers = dict(quality_mode="rates", quality_layers=[40, 20, 8], codeblock_size=(16, 16),
                  precinct_size=(16, 16), num_resolutions=3)
    return {
        "j2k-rgb-53.jp2": j2k(rgb),
        "j2k-rgb-53-mct.j2k": j2k(rgb, no_jp2=True, mct=1),
        "j2k-rgb-97.jp2": j2k(rgb, irreversible=True),
        "j2k-rgb-97-mct.jp2": j2k(rgb, irreversible=True, mct=1),
        "j2k-rgba-53.jp2": j2k(px["RGBA"]),
        "j2k-l-53.jp2": j2k(px["L"]),
        "j2k-la-97.jp2": j2k(px["LA"], irreversible=True),
        "j2k-i16-53.jp2": j2k(deep),
        "j2k-rgb-53-signed.jp2": j2k(rgb, signed=True),
        "j2k-rgb-53-comment-plt.j2k": j2k(rgb, no_jp2=True, comment="rustic", plt=True),
        "j2k-rgb-53-odd-tiles.jp2": j2k(rgb, tile_size=(16, 16), tile_offset=(1, 1),
                                         offset=(2, 2)),
        "j2k-rgb-53-cb16-precincts.jp2": j2k(rgb, codeblock_size=(16, 16),
                                              precinct_size=(16, 16), num_resolutions=3),
        **{f"j2k-rgb-53-{p.lower()}-layers.j2k": j2k(rgb, no_jp2=True, progression=p, **layers)
           for p in jpeg2000.PROGRESSIONS},
        "j2k-palette.jp2": palette_jp2(rng.integers(0, 9, (21, 35)).astype(np.uint8),
                                       rng.integers(0, 256, (9, 3)).astype(np.uint8)),
    }


def big_picture() -> np.ndarray:
    """uint8 [1024, 1024, 3], as a texture: smooth shading, edges and fine
    noise."""
    rng = np.random.default_rng(15)
    y, x = np.mgrid[0:1024, 0:1024].astype(np.float64)
    base = np.stack([(x * 0.2 + y * 0.1) % 256, 128 + 100 * np.sin(x / 40.0) * np.cos(y / 30.0),
                     128 + 90 * np.sin((x + y) / 25.0)], -1)
    base[(x // 128 + y // 128) % 2 == 0] *= 0.6
    return np.clip(base + rng.normal(0, 6, base.shape), 0, 255).astype(np.uint8)


def big_photo() -> bytes:
    """big_picture as a 1024x1024 4:2:0 JPEG at quality 90."""
    return save(Image.fromarray(big_picture()), "JPEG", quality=90, subsampling=2)


def big_photo_webp() -> bytes:
    """big_photo's decode as a quality-90 lossy WebP."""
    return save(Image.open(io.BytesIO(big_photo())).convert("RGB"), "WEBP", quality=90)


def big_photo_j2k() -> tuple:
    """big_photo's decode as JP2: 5/3 lossless, and 9/7 at 20:1 (RCT and
    ICT)."""
    img = Image.open(io.BytesIO(big_photo())).convert("RGB")
    return (j2k(img, mct=1),
            j2k(img, irreversible=True, mct=1, quality_mode="rates", quality_layers=[20]))


def read_glb(raw: bytes):
    (json_len,) = struct.unpack("<I", raw[12:16])
    doc = json.loads(raw[20 : 20 + json_len])
    (bin_len,) = struct.unpack("<I", raw[20 + json_len : 24 + json_len])
    return doc, raw[28 + json_len : 28 + json_len + bin_len]


def glb_images(raw: bytes):
    """The bytes of each image of a GLB, in order."""
    doc, blob = read_glb(raw)
    out = []
    for img in doc["images"]:
        bv = doc["bufferViews"][img["bufferView"]]
        start = bv.get("byteOffset", 0)
        out.append(blob[start : start + bv["byteLength"]])
    return out


def replace_glb_images(raw: bytes, images, mime) -> bytes:
    """The GLB with image i's bytes replaced by images[i] (its bufferView
    re-laid at 4-byte alignment, every other view kept) and its mimeType
    set to `mime` (one for all, or a list: one an image)."""
    doc, blob = read_glb(raw)
    new = {doc["images"][i]["bufferView"]: b for i, b in enumerate(images)}
    out = bytearray()
    for k, bv in enumerate(doc["bufferViews"]):
        start = bv.get("byteOffset", 0)
        data = new.get(k, blob[start : start + bv["byteLength"]])
        out += bytes(-len(out) % 4)
        bv["byteOffset"], bv["byteLength"] = len(out), len(data)
        out += data
    out += bytes(-len(out) % 4)
    mimes = [mime] * len(doc["images"]) if isinstance(mime, str) else mime
    for img, m in zip(doc["images"], mimes):
        img["mimeType"] = m
    doc["buffers"][0]["byteLength"] = len(out)
    body = json.dumps(doc, separators=(",", ":")).encode()
    body += b" " * (-len(body) % 4)
    chunks = (struct.pack("<II", len(body), 0x4E4F534A) + body
              + struct.pack("<II", len(out), 0x004E4942) + bytes(out))
    return struct.pack("<III", 0x46546C67, 2, 12 + len(chunks)) + chunks


def breaktime_jpeg_pair():
    """BreakTime with each texture re-encoded by Pillow as JPEG (quality
    90, 4:2:0), and its lossless twin: each texture a PNG of Pillow's
    decode of that JPEG."""
    with open(os.path.join(SCENES, "BreakTime.glb"), "rb") as f:
        raw = f.read()
    jpegs = [save(Image.open(io.BytesIO(b)).convert("RGB"), "JPEG", quality=90, subsampling=2)
             for b in glb_images(raw)]
    pngs = [save(Image.open(io.BytesIO(b)).convert("RGB"), "PNG", optimize=True) for b in jpegs]
    return (replace_glb_images(raw, jpegs, "image/jpeg"),
            replace_glb_images(raw, pngs, "image/png"))


MIXED_FORMATS = ["tiff jpeg ycbcr planar", "tiff lzma kept", "psd lab", "tiff orientation 6",
                 "tiff fill order 2 group 4", "tiff lzma fill order 2"]
MIXED_MIMES = ["image/tiff", "image/tiff", "image/vnd.adobe.photoshop", "image/tiff", "image/tiff",
               "image/tiff"]


def mixed_texture(img: Image.Image, kind: str) -> bytes:
    """One texture of BreakTime-mixed as a file of `kind` (the writers of
    tests/test_torch_image_formats_variants.py where Pillow writes none)."""
    from tests import test_torch_image_formats_variants as V

    rgb = np.asarray(img.convert("RGB"))
    if kind == "tiff lzma kept":  # 4:2:0 strips of 64 rows, differenced, LZMA, the last broken
        return V.lzma_kept_tiff(rgb, 64, predictor=2)
    if kind == "tiff jpeg ycbcr planar":  # one plane each at 1x1, strips of 64 rows, JPEG
        return V.planar_jpeg_tiff(rgb, rows_per_strip=64)
    if kind == "psd lab":  # L from the grey, a and b (128 for 0) from colour differences
        planes = np.stack([rgb.mean(-1), (rgb[..., 0].astype(int) - rgb[..., 1]) // 2 + 128,
                           (rgb[..., 1].astype(int) - rgb[..., 2]) // 2 + 128])
        return write_psd(planes.astype(np.uint8), 9, 8, 1)
    if kind == "tiff orientation 6":  # stored turned a quarter the other way, LZW strips
        return write_tiff(np.ascontiguousarray(np.rot90(rgb)), 2, compression="LZW",
                          rows_per_strip=32, tags={274: (3, [6])})
    if kind == "tiff fill order 2 group 4":  # a 1-bit map, strips of 32 rows, bits reversed
        return save(img.convert("1"), "TIFF", compression="group4", tiffinfo={266: 2, 278: 32})
    # "tiff lzma fill order 2": RGB strips of 64 rows, differenced, LZMA, bits reversed
    return write_tiff(rgb, 2, compression="LZMA", predictor=2, rows_per_strip=64, fill_order=2)


def twin_png(raw: bytes) -> bytes:
    """A texture's lossless twin: a PNG of Pillow's decode, RGB where it is
    opaque (a Lab PSD's alpha is 0)."""
    rgba = pillow(raw)
    return save(Image.fromarray(rgba if (rgba[..., 3] != 255).any() else rgba[..., :3]), "PNG",
                optimize=True)


def breaktime_mixed_pair():
    """BreakTime with its six textures re-encoded (MIXED_FORMATS, in the
    GLB's image order) as a JPEG-compressed YCbCr TIFF in planar
    configuration 2, an LZMA 4:2:0 YCbCr TIFF with the predictor whose last
    strip liblzma stops in, a Lab PSD, an LZW TIFF of orientation 6, a Group 4
    TIFF of fill order 2 (the 1-bit metallic-roughness map) and an LZMA
    RGB TIFF of fill order 2, and its lossless twin (`twin_png`)."""
    with open(os.path.join(SCENES, "BreakTime.glb"), "rb") as f:
        raw = f.read()
    files = [mixed_texture(Image.open(io.BytesIO(b)).convert("RGB"), kind)
             for b, kind in zip(glb_images(raw), MIXED_FORMATS)]
    return (replace_glb_images(raw, files, MIXED_MIMES),
            replace_glb_images(raw, [twin_png(b) for b in files], "image/png"))


J2K_TEXTURES = [dict(mct=1), dict(mct=1),
                dict(irreversible=True, mct=1, quality_layers=[20]),
                dict(irreversible=True, quality_layers=[12]),
                dict(no_jp2=True, tile_size=(64, 64), progression="RPCL", mct=1),
                dict(quality_mode="rates", quality_layers=[40, 20, 8], precinct_size=(32, 32),
                     codeblock_size=(16, 16), progression="LRCP")]


def breaktime_j2k_pair():
    """BreakTime with its six textures re-encoded by Pillow as JPEG 2000
    (J2K_TEXTURES, in the GLB's image order: two 5/3 JP2, two 9/7 at a
    rate, a tiled RPCL raw codestream, three rate layers with precincts),
    all under the MIME type image/jp2, and its lossless twin: each
    texture a PNG of Pillow's decode."""
    with open(os.path.join(SCENES, "BreakTime.glb"), "rb") as f:
        raw = f.read()
    files = [j2k(Image.open(io.BytesIO(b)).convert("RGB"), **kw)
             for b, kw in zip(glb_images(raw), J2K_TEXTURES)]
    pngs = [save(Image.open(io.BytesIO(b)).convert("RGB"), "PNG", optimize=True) for b in files]
    return (replace_glb_images(raw, files, "image/jp2"),
            replace_glb_images(raw, pngs, "image/png"))


def breaktime_sky_half() -> np.ndarray:
    """BreakTimeSky.npy rounded to half floats (the EXR sky's values)."""
    return np.load(os.path.join(SCENES, "BreakTimeSky.npy")).astype(np.float16)


def sha256_rgba(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8).tobytes()).hexdigest()


def make_fixtures(out_dir: str) -> dict:
    """Write every fixture and the manifest that lists them into `out_dir`
    -> the manifest."""
    os.makedirs(out_dir, exist_ok=True)

    def put(name, data):
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)

    images = []
    for name, raw in small_fixtures().items():
        put(name, raw)
        expect = name.rsplit(".", 1)[0] + ".rgba.npy"
        np.save(os.path.join(out_dir, expect), pillow(raw))
        images.append(dict(file=name, expect=expect))
    big = big_photo()
    put(BIG, big)
    images.append(dict(file=BIG, shape=[1024, 1024, 4], sha256=sha256_rgba(pillow(big))))
    big = big_photo_webp()
    put(BIG_WEBP, big)
    images.append(dict(file=BIG_WEBP, shape=[1024, 1024, 4], sha256=sha256_rgba(pillow(big))))
    for name, big in zip((BIG_J2K_53, BIG_J2K_97), big_photo_j2k()):
        put(name, big)
        images.append(dict(file=name, shape=[1024, 1024, 4], sha256=sha256_rgba(pillow(big))))
    jpeg_glb, twin_glb = breaktime_jpeg_pair()
    put(BT_JPEG, jpeg_glb)
    put(BT_TWIN, twin_glb)
    mixed_glb, mixed_twin = breaktime_mixed_pair()
    put(BT_MIXED, mixed_glb)
    put(BT_MIXED_TWIN, mixed_twin)
    j2k_glb, j2k_twin = breaktime_j2k_pair()
    put(BT_J2K, j2k_glb)
    put(BT_J2K_TWIN, j2k_twin)
    sky = breaktime_sky_half()
    put(BT_SKY_EXR, write_exr({c: sky[..., i] for i, c in enumerate("RGB")}, "ZIP"))
    manifest = dict(images=images, scene=dict(jpeg=BT_JPEG, twin=BT_TWIN, mixed=BT_MIXED,
                                              mixed_kinds=MIXED_FORMATS,
                                              mixed_twin=BT_MIXED_TWIN, j2k=BT_J2K,
                                              j2k_twin=BT_J2K_TWIN, sky=BT_SKY_EXR))
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    return manifest


# ---- the fixtures of tests/data_torch/formats_dds_psd ---------------------------------------

DDS_PSD_FIXTURES = os.path.join(os.path.dirname(FIXTURES), "formats_dds_psd")
BIG_BC1 = "photo-1024-bc1.dds"
BIG_BC7 = "photo-1024-bc7.dds"
BT_DDS = "BreakTime-DDS.glb"
BT_DDS_TWIN = "BreakTime-DDS-twin.glb"
DDS_MIME, PSD_MIME = "image/vnd-ms.dds", "image/vnd.adobe.photoshop"
# BreakTime-DDS's textures, in the GLB's image order (0 and 1 the floor's albedo and normal
# maps, 2 and 3 the wood's, 4 the metal's metallic-roughness map, 5 the poster)
DDS_TEXTURES = ["DXT1", "BC5", "DXT5", "BC7", "PSD PackBits RGB", "PSD raw indexed"]


def random_blocks(n: int, size: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n * size, np.uint8).tobytes()


def dds_psd_small_fixtures() -> dict:
    """name -> the bytes of each small DDS and PSD fixture: Pillow's DDS
    files of one 21x35 picture (`pillow_modes(21, 35, seed=5)`), masked,
    palette and DX10 RGBA surfaces, random BC4, BC5 SNORM and BC6H blocks,
    BC7 of `bc7_mode6`, and PSDs of each mode and compression
    (`psd_of`)."""
    px = pillow_modes(21, 35, seed=5)
    rng = np.random.default_rng(19)
    blocks = 6 * 9  # 21x35 in 4x4 blocks
    quad = Image.fromarray(rgba(24, 36, 20))  # BC7 wants whole blocks: cropped by the header
    pal = rng.integers(0, 256, 1024, np.uint8).tobytes()
    res = [(1039, b"", bytes(rng.integers(0, 256, 131, np.uint8))), (1005, b"res", b"\0\1\2")]
    return {
        "dds-dxt1.dds": save(px["RGBA"], "DDS", pixel_format="DXT1"),
        "dds-dxt3.dds": save(px["RGBA"], "DDS", pixel_format="DXT3"),
        "dds-dxt5.dds": save(px["RGBA"], "DDS", pixel_format="DXT5"),
        "dds-bc5-dx10.dds": save(px["RGB"], "DDS", pixel_format="BC5"),
        "dds-bc4-ati1.dds": dds_file(35, 21, random_blocks(blocks, 8, 21), b"ATI1"),
        "dds-bc5s.dds": dds_file(35, 21, random_blocks(blocks, 16, 22), dxgi=84),
        "dds-bc6h-uf16.dds": dds_file(35, 21, random_blocks(blocks, 16, 23), dxgi=95),
        "dds-bc6h-sf16.dds": dds_file(35, 21, random_blocks(blocks, 16, 24), dxgi=96),
        "dds-bc7-srgb.dds": dds_file(35, 21, bc7_mode6(np.asarray(quad)), dxgi=99),
        "dds-rgba8.dds": save(px["RGBA"], "DDS"),
        "dds-l8.dds": save(px["L"], "DDS"),
        "dds-la8.dds": save(px["LA"], "DDS"),
        "dds-rgb565.dds": dds_file(35, 21, random_blocks(35 * 21, 2, 25), pfflags=DDPF_RGB,
                                   bitcount=16, masks=(0xF800, 0x7E0, 0x1F, 0)),
        "dds-a2b10g10r10.dds": dds_file(35, 21, random_blocks(35 * 21, 4, 26),
                                        pfflags=DDPF_RGB | DDPF_ALPHAPIXELS, bitcount=32,
                                        masks=(0x3FF, 0xFFC00, 0x3FF00000, 0xC0000000)),
        "dds-palette.dds": dds_file(35, 21, random_blocks(35 * 21, 1, 27), pfflags=DDPF_PALETTE,
                                    bitcount=8, extra=pal),
        "dds-r8g8b8a8-dx10.dds": dds_file(35, 21, random_blocks(35 * 21, 4, 28), dxgi=28),
        "psd-bitmap-raw.psd": psd_of(px["1"], 0),
        "psd-grey-packbits.psd": psd_of(px["L"], 1, resources=res, layers=bytes(10)),
        "psd-indexed-packbits.psd": psd_of(px["P"], 1),
        "psd-rgb-packbits.psd": psd_of(px["RGB"], 1, resources=res),
        "psd-rgba-raw.psd": psd_of(px["RGBA"], 0, layers=b"\0\0\0\4abcd"),
        "psd-cmyk-packbits.psd": psd_of(px["RGB"].convert("CMYK"), 1),
    }


def big_bcn() -> tuple:
    """big_picture as a 1024x1024 DDS of Pillow's DXT1 and one of BC7
    (`bc7_mode6`, opaque)."""
    img = Image.fromarray(big_picture())
    opaque = np.asarray(img.convert("RGBA"))
    return (save(img, "DDS", pixel_format="DXT1"),
            dds_file(1024, 1024, bc7_mode6(opaque), dxgi=98))


def dds_texture(img: Image.Image, kind: str) -> bytes:
    if kind in ("DXT1", "DXT5", "BC5"):
        return save(img.convert("RGB" if kind == "BC5" else "RGBA"), "DDS", pixel_format=kind)
    if kind == "BC7":
        return dds_file(img.width, img.height, bc7_mode6(np.asarray(img.convert("RGBA"))),
                        dxgi=98)
    if kind == "PSD PackBits RGB":
        return psd_of(img.convert("RGB"), 1)
    return psd_of(img.convert("RGB").quantize(256), 0)


def breaktime_dds_pair():
    """BreakTime with its six textures re-encoded as DDS_TEXTURES names
    them, in the GLB's image order: Pillow's DXT1, BC5 (on the floor's
    normal map) and DXT5, BC7 of `bc7_mode6`, a PackBits RGB PSD and a raw
    indexed PSD (Pillow's 256-colour quantisation), under the MIME types
    image/vnd-ms.dds and image/vnd.adobe.photoshop; and its lossless twin:
    each texture a PNG of Pillow's decode."""
    with open(os.path.join(SCENES, "BreakTime.glb"), "rb") as f:
        raw = f.read()
    files = [dds_texture(Image.open(io.BytesIO(b)), kind)
             for b, kind in zip(glb_images(raw), DDS_TEXTURES)]
    pngs = [save(Image.open(io.BytesIO(b)).convert("RGBA"), "PNG", optimize=True) for b in files]
    mimes = [PSD_MIME if k.startswith("PSD") else DDS_MIME for k in DDS_TEXTURES]
    return replace_glb_images(raw, files, mimes), replace_glb_images(raw, pngs, "image/png")


def make_dds_psd_fixtures(out_dir: str) -> dict:
    """Write the DDS and PSD fixtures and their manifest (the form of
    make_fixtures') into `out_dir` -> the manifest."""
    os.makedirs(out_dir, exist_ok=True)

    def put(name, data):
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)

    images = []
    for name, raw in dds_psd_small_fixtures().items():
        put(name, raw)
        expect = name.rsplit(".", 1)[0] + ".rgba.npy"
        np.save(os.path.join(out_dir, expect), pillow(raw))
        images.append(dict(file=name, expect=expect))
    for name, big in zip((BIG_BC1, BIG_BC7), big_bcn()):
        put(name, big)
        images.append(dict(file=name, shape=[1024, 1024, 4], sha256=sha256_rgba(pillow(big))))
    dds_glb, dds_twin = breaktime_dds_pair()
    put(BT_DDS, dds_glb)
    put(BT_DDS_TWIN, dds_twin)
    manifest = dict(images=images, scene=dict(dds=BT_DDS, dds_twin=BT_DDS_TWIN))
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    return manifest


# ---- the fixtures of tests/data_torch/formats_classic ---------------------------------------

CLASSIC_FIXTURES = os.path.join(os.path.dirname(FIXTURES), "formats_classic")
BT_CLASSIC = "BreakTime-classic.glb"
BT_CLASSIC_TWIN = "BreakTime-classic-twin.glb"
# BreakTime-classic's textures, in the GLB's image order (0 and 1 the floor's albedo and normal
# maps, 2 and 3 the wood's, 4 the metal's metallic-roughness map, 5 the poster), with MIME types
CLASSIC_TEXTURES = ["PPM P6", "QOI RGBA", "SGI RLE", "PCX RLE 24-bit", "ICO 32-bit DIB", "DCX"]
CLASSIC_MIMES = ["image/x-portable-pixmap", "image/qoi", "image/sgi", "image/x-pcx",
                 "image/x-icon", "image/x-dcx"]


def classic_small_fixtures() -> dict:
    """name -> the bytes of each small fixture of the classic formats: of
    one 21x35 picture (`pillow_modes(21, 35, seed=7)`), Pillow's PPM, QOI,
    ICO (PNG and BMP payloads), PCX, SGI (verbatim, 8 and 16 bits) and DIB
    files, and this module's writers' plain and odd-maxval PNMs, PFM,
    CMYK and RGBA PNMs, ICO bitmaps at 1, 4 and 24 bits with AND masks,
    CURs, planar PCXs, a PCX without its palette, a DCX and RLE SGIs."""
    px = pillow_modes(21, 35, seed=7)
    rgba_px = np.asarray(px["RGBA"])
    grey = np.asarray(px["L"])
    rng = np.random.default_rng(31)
    mask = rng.random((21, 35)) < 0.3
    pal16 = rng.integers(0, 256, (16, 3), np.uint8)
    idx16 = rng.integers(0, 16, (21, 35), np.uint8)
    idx4 = idx16 & 3
    quad = Image.fromarray(rgba(32, 32, 8))  # an icon Pillow writes at its own size
    planes3 = rgba_px[..., :3].transpose(2, 0, 1)
    return {
        "pnm-p1-plain-comments.pbm": pnm(np.asarray(px["1"]) == 0, b"P1", comment=b"# 1\n"),
        "pnm-p2-plain-maxval-1000.pgm": pnm(grey.astype(np.int64) * 1000 // 255, b"P2", 1000,
                                            sep=b" \t", comment=b"#c\r"),
        "pnm-p3-plain.ppm": pnm(rgba_px[..., :3], b"P3"),
        "pnm-p4.pbm": save(px["1"], "PPM"),
        "pnm-p5.pgm": save(px["L"], "PPM"),
        "pnm-p5-16bit.pgm": save(Image.fromarray(grey.astype(np.uint16) * 3 + 100), "PPM"),
        "pnm-p6.ppm": save(px["RGB"], "PPM"),
        "pnm-p6-maxval-100.ppm": pnm(rgba_px[..., :3] // 3, b"P6", 100),
        "pnm-p6-maxval-4095.ppm": pnm(rgba_px[..., :3].astype(np.uint16) * 16, b"P6", 4095),
        "pnm-pf.pfm": save(Image.fromarray(grey.astype(np.float32) * 1.3 - 20, "F"), "PPM"),
        "pnm-p0cmyk.pnm": pnm(np.asarray(px["RGB"].convert("CMYK")), b"P0CMYK"),
        "pnm-pyrgba.pnm": pnm(rgba_px, b"PyRGBA"),
        "qoi-rgb.qoi": save(px["RGB"], "QOI"),
        "qoi-rgba.qoi": save(px["RGBA"], "QOI"),
        "ico-png.ico": save(quad, "ICO", sizes=[(16, 16), (32, 32)]),
        "ico-bmp-rgba.ico": save(quad, "ICO", sizes=[(32, 32)], bitmap_format="bmp"),
        "ico-bmp-palette.ico": save(quad.convert("RGB").quantize(50), "ICO", sizes=[(32, 32)],
                                    bitmap_format="bmp"),
        "ico-dib-1bit-mask.ico": icon_file([(icon_dib(idx16 & 1, 1, pal16[:2], mask), 35, 21,
                                             1, 2)]),
        "ico-dib-4bit-mask.ico": icon_file([(icon_dib(idx16, 4, pal16, mask), 35, 21, 4, 16)]),
        "ico-dib-24bit-mask.ico": icon_file([(icon_dib(rgba_px[..., :3], 24, mask=mask), 35,
                                              21, 24, 0)]),
        "ico-two-depths.ico": icon_file([(icon_dib(rgba_px, 32), 35, 21, 32, 0),
                                         (icon_dib(idx16, 8, pal16, mask), 35, 21, 8, 0)]),
        "cur-32bit.cur": icon_file([(icon_dib(rgba_px, 32), 35, 21, 3, 4)], cursor=True),
        "cur-two-4bit.cur": icon_file([(icon_dib(idx16[:5, :6], 4, pal16), 6, 5, 1, 1),
                                       (icon_dib(idx16, 4, pal16, mask), 35, 21, 2, 2)],
                                      cursor=True),
        "pcx-1.pcx": save(px["1"], "PCX"),
        "pcx-l.pcx": save(px["L"], "PCX"),
        "pcx-p.pcx": save(px["P"], "PCX"),
        "pcx-rgb.pcx": save(px["RGB"], "PCX"),
        "pcx-2planes.pcx": pcx_file(np.concatenate([np.packbits((idx4 >> k) & 1, axis=1)
                                                    for k in range(2)], 1), 35, 1, 2,
                                    palette16=pal16.tobytes()),
        "pcx-4planes.pcx": pcx_file(np.concatenate([np.packbits((idx16 >> k) & 1, axis=1)
                                                    for k in range(4)], 1), 35, 1, 4,
                                    palette16=pal16.tobytes()),
        "pcx-l-no-palette.pcx": pcx_file(np.pad(grey, ((0, 0), (0, 1))), 35, 8, 1),
        "dcx-two.dcx": dcx_file([save(px["RGB"], "PCX"), save(px["L"], "PCX")]),
        "sgi-l.bw": save(px["L"], "SGI"),
        "sgi-rgb.rgb": save(px["RGB"], "SGI"),
        "sgi-rgba-16.sgi": save(px["RGBA"], "SGI", bpc=2),
        "sgi-rle-rgb.rgb": sgi_file(planes3 // 16 * 16, 1, True),
        "sgi-rle-rgba.rgba": sgi_file(rgba_px.transpose(2, 0, 1) // 32 * 32, 1, True),
        "sgi-rle-l-16.sgi": sgi_file(grey[None].astype(np.uint16) // 8 * 2056, 2, True),
        "dib-1.dib": save(px["1"], "DIB"),
        "dib-p.dib": save(px["P"], "DIB"),
        "dib-rgb.dib": save(px["RGB"], "DIB"),
        "dib-rgba.dib": save(px["RGBA"], "DIB"),
    }


def classic_texture(img: Image.Image, kind: str) -> bytes:
    rgb = img.convert("RGB")
    if kind == "PPM P6":
        return save(rgb, "PPM")
    if kind == "QOI RGBA":
        return save(rgb.convert("RGBA"), "QOI")
    if kind == "SGI RLE":
        return sgi_file(np.asarray(rgb).transpose(2, 0, 1), 1, True)
    if kind == "PCX RLE 24-bit":
        return save(rgb, "PCX")
    if kind == "ICO 32-bit DIB":
        return save(rgb.convert("RGBA"), "ICO", sizes=[img.size], bitmap_format="bmp")
    return dcx_file([save(rgb, "PCX"), save(rgb.convert("L"), "PCX")])


def breaktime_classic_pair():
    """BreakTime with its six textures re-encoded as CLASSIC_TEXTURES names
    them, in the GLB's image order (a P6 PPM, a QOI with alpha, an RLE SGI,
    Pillow's 24-bit RLE PCX, Pillow's ICO of one 32-bit DIB, a DCX of two
    PCX images), under CLASSIC_MIMES; and its lossless twin: each texture a
    PNG of Pillow's decode."""
    with open(os.path.join(SCENES, "BreakTime.glb"), "rb") as f:
        raw = f.read()
    files = [classic_texture(Image.open(io.BytesIO(b)), kind)
             for b, kind in zip(glb_images(raw), CLASSIC_TEXTURES)]
    pngs = [save(Image.open(io.BytesIO(b)).convert("RGBA"), "PNG", optimize=True) for b in files]
    return replace_glb_images(raw, files, CLASSIC_MIMES), replace_glb_images(raw, pngs, "image/png")


def make_classic_fixtures(out_dir: str) -> dict:
    """Write the classic formats' fixtures and their manifest (the form of
    make_fixtures') into `out_dir` -> the manifest."""
    os.makedirs(out_dir, exist_ok=True)

    def put(name, data):
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)

    images = []
    for name, raw in classic_small_fixtures().items():
        put(name, raw)
        expect = name.rsplit(".", 1)[0] + ".rgba.npy"
        np.save(os.path.join(out_dir, expect), pillow(raw))
        images.append(dict(file=name, expect=expect, format=Image.open(io.BytesIO(raw)).format))
    glb, twin = breaktime_classic_pair()
    put(BT_CLASSIC, glb)
    put(BT_CLASSIC_TWIN, twin)
    manifest = dict(images=images, scene=dict(classic=BT_CLASSIC, classic_twin=BT_CLASSIC_TWIN))
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    return manifest


# ---- the legacy formats' writers and the fixtures of tests/data_torch/formats_legacy ---------

LEGACY_FIXTURES = os.path.join(os.path.dirname(FIXTURES), "formats_legacy")
BT_LEGACY = "BreakTime-legacy.glb"
BT_LEGACY_TWIN = "BreakTime-legacy-twin.glb"
# BreakTime-legacy's textures, in the GLB's image order, with MIME types
LEGACY_TEXTURES = ["IPTC holding a TIFF", "IM RGB", "BLP2 DXT5", "XPM 8-byte keys",
                   "McIdas 16-bit", "APNG frame 0"]
LEGACY_MIMES = ["image/x-iptc", "image/x-im", "image/x-blp", "image/x-xpixmap", "image/x-mcidas",
                "image/apng"]


def im_file(data: bytes, image_type: str, size, lut: bytes = None, extra: bytes = b"",
            eol: bytes = b"\r\n") -> bytes:
    """An IM file: the header lines, NULs to byte 511, ^Z, the palette
    (`lut`, 768 bytes) and the data."""
    head = (b"Image type: %s%s" % (image_type.encode(), eol) + extra
            + b"Image size (x*y): %d*%d%s" % (size[0], size[1], eol))
    if lut is not None:
        head += b"Lut: 1" + eol
    return head + b"\0" * (511 - len(head)) + b"\x1a" + (lut or b"") + data


def imt_file(px: np.ndarray, comment: bytes = b"*made by the suite\n") -> bytes:
    return (comment + b"width %d\nheight %d\npixel n8\n" % (px.shape[1], px.shape[0]) + b"\x0c"
            + px.tobytes())


def iptc_field(record: int, dataset: int, data: bytes, long: bool = False) -> bytes:
    """One IPTC field: 0x1C, the tag, and a 15-bit size, or (`long`, or a
    size of 2**15 and over) 0x80 + 4 and a 32-bit size."""
    if long or len(data) >= 0x8000:
        return bytes([0x1C, record, dataset, 0x84]) + struct.pack(">I", len(data)) + data
    return bytes([0x1C, record, dataset]) + struct.pack(">H", len(data)) + data


def iptc_file(data: bytes, size, layers: int = 1, component: int = 0, band: int = None,
              compression: int = 1, chunk: int = 0x7FFF) -> bytes:
    """An IPTC image: the record 3 fields Pillow reads, then the data in
    image fields (8, 10) of at most `chunk` bytes."""
    head = (iptc_field(2, 5, b"suite") + iptc_field(3, 60, bytes([layers, component]))
            + iptc_field(3, 20, struct.pack(">H", size[0])) + iptc_field(3, 30, struct.pack(
                ">H", size[1])) + iptc_field(3, 120, bytes([compression])))
    if band is not None:
        head += iptc_field(3, 65, bytes([band]))
    body = b"".join(iptc_field(8, 10, data[i : i + chunk]) for i in range(0, len(data), chunk))
    return head + body


def pcd_file(ycc: np.ndarray, orientation: int = 0) -> bytes:
    """A PhotoCD file of its base image: `ycc` uint8 [256, 2304], each row
    a pair of luma rows and their shared Cb and Cr samples."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    return bytes(head) + np.ascontiguousarray(ycc, np.uint8).tobytes()


def spider_file(values: np.ndarray, big: bool = True, stack: int = 0) -> bytes:
    """A SPIDER 2D image of float32 `values`, or (`stack` > 0) a stack of
    that many copies after a stack header."""
    h, w = values.shape
    lenbyt = w * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    dt = ">f4" if big else "<f4"

    def header(istack, imgnum):
        hdr = np.zeros(labbyt // 4, np.float64)
        hdr[[0, 1, 2, 4, 11, 12, 21, 22]] = [1, h, h, 1, w, labrec, labbyt, lenbyt]
        hdr[23], hdr[25], hdr[26] = istack, stack, imgnum
        return hdr.astype(dt).tobytes()

    data = values.astype(dt).tobytes()
    if not stack:
        return header(0, 0) + data
    return header(stack, 0) + b"".join(header(0, k + 1) + data for k in range(stack))


def blp_file(version: int, w: int, h: int, mip0: bytes, compression: int = 1, encoding: int = 1,
             alpha: int = 0, alpha_encoding: int = 0, palette: bytes = b"",
             jpeg_header: bytes = None, gap: int = 0) -> bytes:
    """A BLP1 or BLP2 file of mipmap 0: the header, the 16 offsets and
    lengths, the palette (BLP2, or BLP1's indexed kinds) or the JPEG
    header (BLP1 compression 0, with `gap` bytes before the data)."""
    if version == 1:
        head = b"BLP1" + struct.pack("<iIIIiI", compression, alpha, w, h, encoding, 0)
    else:
        head = b"BLP2" + struct.pack("<ibbbbII", compression, encoding, alpha, alpha_encoding, 0,
                                     w, h)
    start = len(head) + 128
    if jpeg_header is not None:
        body = struct.pack("<I", len(jpeg_header)) + jpeg_header + bytes(gap)
    else:
        body = palette.ljust(1024, b"\0") if palette is not None else b""
    offset = start + len(body)
    tables = struct.pack("<16I", offset, *[0] * 15) + struct.pack("<16I", len(mip0), *[0] * 15)
    return head + tables + body + mip0


def blp1_jpeg(img: Image.Image, quality: int = 90, alpha: int = 0, gap: int = 0) -> bytes:
    """BLP1 compression 0: a Pillow JPEG split at its SOS segment into the
    shared header and mipmap 0's data."""
    jpg = save(img, "JPEG", quality=quality)
    sos = jpg.index(b"\xff\xda")
    return blp_file(1, img.width, img.height, jpg[sos:], 0, 5, alpha, jpeg_header=jpg[:sos],
                    gap=gap)


def dxt_blocks_of(img: Image.Image, kind: str) -> bytes:
    """The DXT1/DXT3/DXT5 blocks Pillow's DDS writer makes of `img`."""
    return save(img, "DDS", pixel_format=kind)[128:]


def fits_card(key: str, value) -> bytes:
    return f"{key:<8}= {value:>20}".ljust(80).encode()


def fits_file(bitpix: int, w: int, h: int, data: bytes, extra=(), naxis: int = 2) -> bytes:
    """A FITS primary image of big-endian samples, its header padded to
    2880 bytes (the data is not padded)."""
    cards = [fits_card("SIMPLE", "T"), fits_card("BITPIX", bitpix), fits_card("NAXIS", naxis)]
    cards += [fits_card("NAXIS1", w)] + ([fits_card("NAXIS2", h)] if naxis > 1 else [])
    head = b"".join(cards) + b"".join(extra) + b"END".ljust(80)
    return head + b" " * (-len(head) % 2880) + data


def fits_gzip_file(bitpix: int, w: int, h: int, samples: np.ndarray) -> bytes:
    """A tile-compressed FITS: an empty primary unit, then a binary table
    with ZIMAGE = T and ZCMPTYPE 'GZIP_1' whose heap is one gzip stream of
    4-byte big-endian words, one a sample."""
    primary = fits_file(8, 0, 0, b"", naxis=0)
    payload = gzip.compress(np.asarray(samples, ">i4").tobytes(), mtime=0)
    cards = [fits_card("XTENSION", "'BINTABLE'"), fits_card("BITPIX", 8), fits_card("NAXIS", 2),
             fits_card("NAXIS1", 8), fits_card("NAXIS2", 1), fits_card("ZIMAGE", "T"),
             fits_card("ZCMPTYPE", "'GZIP_1  '"), fits_card("ZBITPIX", bitpix),
             fits_card("ZNAXIS", 2), fits_card("ZNAXIS1", w), fits_card("ZNAXIS2", h)]
    head = b"".join(cards) + b"END".ljust(80)
    return primary + head + b" " * (-len(head) % 2880) + bytes(8) + payload


def fli_chunk(kind: int, body: bytes) -> bytes:
    body += bytes(len(body) % 2)
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli_colour(entries, shift: int = 0) -> bytes:
    """A COLOR256 (4) chunk, or a COLOR (11) chunk of 6-bit levels where
    `shift` is 2: `entries` a list of (skip, [[r, g, b], ...])."""
    body = struct.pack("<H", len(entries))
    for skip, rgb in entries:
        body += bytes([skip, len(rgb) % 256]) + np.asarray(rgb, np.uint8).tobytes()
    return fli_chunk(11 if shift else 4, body)


def fli_brun(idx: np.ndarray) -> bytes:
    """A BRUN chunk of `idx`: each row a packet count byte and runs of up
    to 127 equal bytes, or literals of differing ones (negative counts)."""
    body = bytearray()
    for row in idx:
        body.append(0)
        x = 0
        while x < len(row):
            n = 1
            while x + n < len(row) and n < 127 and row[x + n] == row[x]:
                n += 1
            if n >= 3 or x + n == len(row):
                body += bytes([n, row[x]])
            else:
                n = min(len(row) - x, 127)
                body += bytes([256 - n]) + bytes(row[x : x + n])
            x += n
    return fli_chunk(15, bytes(body))


def fli_file(w: int, h: int, chunks, magic: int = 0xAF12, prefix: bytes = None) -> bytes:
    """An FLI (0xAF11) or FLC (0xAF12) of one frame of `chunks`, after a
    prefix chunk where given."""
    frame_body = b"".join(chunks)
    frame = struct.pack("<IHH", 16 + len(frame_body), 0xF1FA, len(chunks)) + bytes(8) + frame_body
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(frame), magic, 1, w, h, 8, 0, 5)
    pre = b"" if prefix is None else struct.pack("<IHH", 16 + len(prefix), 0xF100, 0) + bytes(
        8) + prefix
    return bytes(head) + pre + frame


def ftex_file(fmt: int, w: int, h: int, data: bytes) -> bytes:
    return b"FTEX" + struct.pack("<7i", 1, w, h, 1, 1, fmt, 32) + struct.pack("<i", len(
        data)) + data


def gbr_file(px: np.ndarray, version: int = 2, comment: bytes = b"suite brush\0") -> bytes:
    h, w = px.shape[:2]
    depth = 1 if px.ndim == 2 else 4
    if version == 1:
        head = struct.pack(">5I", 20 + len(comment), 1, w, h, depth)
    else:
        head = struct.pack(">5I", 28 + len(comment), 2, w, h, depth) + b"GIMP" + struct.pack(
            ">I", 25)
    return head + comment + px.tobytes()


def icns_rle(plane: bytes) -> bytes:
    """ICNS's run-length form of one channel: runs of 3-130 equal bytes
    (0x80 + n - 3, the byte), literals of up to 128 (n - 1, the bytes)."""
    out, i, n = bytearray(), 0, len(plane)
    while i < n:
        j = i
        while j < n and j - i < 130 and plane[j] == plane[i]:
            j += 1
        if j - i >= 3:
            out += bytes([0x80 + j - i - 3, plane[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and plane[j] == plane[j + 1] == plane[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + plane[i:j]
        i = j
    return bytes(out)


def icns_file(blocks) -> bytes:
    """An icns file of (type, data) blocks."""
    body = b"".join(t + struct.pack(">I", 8 + len(d)) + d for t, d in blocks)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def icns_rgb32(rgb: np.ndarray, rle: bool = True) -> bytes:
    if not rle:
        return rgb.tobytes()
    return b"".join(icns_rle(rgb[..., c].tobytes()) for c in range(3))


def msp_header(w: int, h: int, magic: bytes) -> bytes:
    words = [*struct.unpack("<2H", magic), w, h, 1, 1, 1, 1, w, h, 0, 0, 0, 0, 0, 0]
    check = 0
    for v in words:
        check ^= v
    words[12] = check
    return struct.pack("<16H", *words)


def msp2_file(bits: np.ndarray, rows=None) -> bytes:
    """An MSP version 2 of the 1-bit image `bits` (rows of 0/1): each row
    packed, then run-length coded (a run of 3+ equal bytes 0, n, v; else a
    literal n, bytes), or `rows` given as they are."""
    h, w = bits.shape
    if rows is None:
        rows = []
        for r in np.packbits(bits.astype(np.uint8), axis=1):
            out, i = bytearray(), 0
            r = r.tobytes()
            while i < len(r):
                j = i
                while j < len(r) and j - i < 255 and r[j] == r[i]:
                    j += 1
                if j - i >= 3:
                    out += bytes([0, j - i, r[i]])
                    i = j
                    continue
                j = min(i + 255, len(r))
                k = i
                while k < j and not (k + 2 < len(r) and r[k] == r[k + 1] == r[k + 2]):
                    k += 1
                k = max(k, i + 1)
                out += bytes([k - i]) + r[i:k]
                i = k
            rows.append(bytes(out))
    return (msp_header(w, h, b"LinS") + struct.pack(f"<{h}H", *[len(r) for r in rows])
            + b"".join(rows))


def pixar_file(rgb: np.ndarray, kind=(14, 2)) -> bytes:
    head = bytearray(1024)
    head[0:4] = b"\200\350\000\000"
    struct.pack_into("<HHHHHH", head, 416, rgb.shape[0], rgb.shape[1], 0, 0, *kind)
    return bytes(head) + rgb.tobytes()


def sun_rle(data: bytes) -> bytes:
    """Sun raster RLE: runs of 2-256 equal bytes as 0x80, n - 1, v; a
    single 0x80 as 0x80, 0; any other byte as itself."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 256 and data[j] == data[i]:
            j += 1
        if j - i >= 3 or data[i] == 0x80 and j - i >= 2:
            out += bytes([0x80, j - i - 1, data[i]])
        elif data[i] == 0x80:
            out += b"\x80\x00"
            j = i + 1
        else:
            out.append(data[i])
            j = i + 1
        i = j
    return bytes(out)


def sun_file(rows: np.ndarray, w: int, depth: int, file_type: int = 1, colour_map: bytes = b"",
             rle: bool = False) -> bytes:
    """A Sun raster: `rows` uint8 [H, row bytes] (padded to 16 bits for
    raw data; unpadded for RLE, as Pillow reads it)."""
    h = rows.shape[0]
    data = sun_rle(rows.tobytes()) if rle else rows.tobytes()
    head = struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), 2 if rle else file_type,
                       1 if colour_map else 0, len(colour_map))
    return head + colour_map + data


def sun_rows(px: np.ndarray, depth: int, pad: bool = True) -> np.ndarray:
    """uint8 [H, W, bytes] or [H, W] of values below 2**depth -> the rows."""
    h, w = px.shape[:2]
    if depth < 8:
        rows = np.packbits(np.unpackbits(px[..., None].astype(np.uint8), axis=-1)[..., -depth:]
                           .reshape(h, -1), axis=1)
    else:
        rows = px.reshape(h, -1)
    if pad:
        stride = ((w * depth + 15) // 16) * 2
        rows = np.pad(rows, ((0, 0), (0, stride - rows.shape[1])))
    return rows


def xpm_file(idx: np.ndarray, colours, keys=None, none_key=None, pixel_header: bool = True,
             bpp: int = None) -> bytes:
    """An XPM of indices into `colours` (hex strings, "None" allowed); its
    keys, `bpp` characters each, from a fixed alphabet unless given."""
    alphabet = b".#abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789+@$%&*=-;:>,<1"
    n = len(colours)
    bpp = bpp or (1 if n <= len(alphabet) else 2)
    if keys is None:
        keys = [bytes([alphabet[k % len(alphabet)]]) if bpp == 1 else
                bytes([alphabet[k // len(alphabet)], alphabet[k % len(alphabet)]])
                for k in range(n)]
    h, w = idx.shape
    lines = [b"/* XPM */", b"static char *suite[] = {", b'"%d %d %d %d",' % (w, h, n, bpp)]
    lines += [b'"%s c %s",' % (k, c.encode()) for k, c in zip(keys, colours)]
    if pixel_header:
        lines.append(b"/* pixels */")
    lines += [b'"' + b"".join(keys[i] for i in row) + b'",' for row in idx]
    return b"\n".join(lines) + b"\n};\n"


def mcidas_file(px: np.ndarray, depth: int = 1, prefix: int = 0, gap: int = 0) -> bytes:
    """A McIdas area of [h, w] samples, `depth` bytes each (1, 2 or 4, big
    endian): the 256-byte directory (w[9] lines, w[10] elements, w[11]
    bytes an element, w[14] bands, w[15] the prefix of each line, w[34]
    the data's offset), `gap` bytes before the data, then each line its
    `prefix` bytes and its samples."""
    h, w = px.shape
    words = [0] * 65
    words[2], words[9], words[10], words[11], words[14] = 4, h, w, depth, 1
    words[15], words[34] = prefix, 256 + gap
    rows = np.ascontiguousarray(px, {1: np.uint8, 2: ">u2", 4: ">i4"}[depth]).view(np.uint8)
    pad = np.tile(np.arange(prefix, dtype=np.uint8), (h, 1))
    return (struct.pack(">64i", *words[1:]) + bytes(range(gap))
            + np.concatenate([pad, rows.reshape(h, -1)], 1).tobytes())


def xvthumb_file(idx: np.ndarray, comments=(b"#XVVERSION:Version 2.28 (suite)",
                                            b"#BUILTIN:STIPPLE"), head: bytes = b"\n") -> bytes:
    """An XV thumbnail of [h, w] indices into the 3-3-2 palette: "P7 332",
    the rest of its line `head`, comment lines, the size line, the bytes."""
    h, w = idx.shape
    return (b"P7 332" + head + b"".join(c + b"\n" for c in comments)
            + b"%d %d 255\n" % (w, h) + np.asarray(idx, np.uint8).tobytes())


def rgb332(img: Image.Image) -> np.ndarray:
    """An image's pixels as indices of the 3-3-2 palette (r << 5 | g << 2 | b)."""
    rgb = np.asarray(img.convert("RGB")).astype(np.int64)
    return ((rgb[..., 0] * 7 + 127) // 255 << 5 | (rgb[..., 1] * 7 + 127) // 255 << 2
            | (rgb[..., 2] * 3 + 127) // 255).astype(np.uint8)


def long_key_xpm(img: Image.Image, colours: int = 64, bpp: int = 8) -> bytes:
    """An image as an XPM of `bpp`-byte keys: quantized to `colours` up to
    256 ("P"); above, its own colours and unused ones up to `colours`
    ("RGB": the palette length decides), at least its own."""
    if colours <= 256:
        quant = img.convert("RGB").quantize(colours)
        pal = np.array(quant.getpalette()[: 3 * colours], np.uint8).reshape(-1, 3)
        idx = np.asarray(quant)
    else:
        rgb = np.asarray(img.convert("RGB"))
        pal, idx = np.unique(rgb.reshape(-1, 3), axis=0, return_inverse=True)
        pal = np.concatenate([pal, np.full((max(0, colours - len(pal)), 3), 7, np.uint8)])
        idx = idx.reshape(rgb.shape[:2])
    keys = [b"c%0*d" % (bpp - 1, k) for k in range(len(pal))]
    return xpm_file(idx, ["#%02x%02x%02x" % tuple(c) for c in pal], keys=keys, bpp=bpp)


def legacy_small_fixtures() -> dict:
    """name -> the bytes of each small fixture of the legacy formats: of
    one 21x35 picture (`pillow_modes(21, 35, seed=9)`), Pillow's IM,
    SPIDER, BLP, MSP, XBM and ICNS files, and this module's writers'
    IMT, IPTC (raw and JPEG), PCD, BLP (JPEG and DXT), FITS (raw and
    GZIP_1), FLC, FTEX, GBR, ICNS (it32 RLE with its mask), MSP version 2,
    PIXAR, SUN (RLE and raw) and XPM files."""
    px = pillow_modes(21, 35, seed=9)
    rgb, grey = np.asarray(px["RGB"]), np.asarray(px["L"])
    rgba_px = np.asarray(px["RGBA"])
    rng = np.random.default_rng(41)
    pal = rng.integers(0, 256, 1024, np.uint8).tobytes()
    cols = ["#%06x" % v for v in rng.integers(0, 2**24, 300)]
    rgb128 = np.asarray(Image.fromarray(rgb).resize((128, 128)))
    mask128 = np.asarray(Image.fromarray(grey).resize((128, 128)))
    ycc = rng.integers(0, 256, (256, 2304), np.uint8)
    ycc[:, :1536] = np.repeat(np.asarray(Image.fromarray(grey).resize((768, 512))), 1,
                              axis=0).reshape(256, 1536)
    return {
        "im-rgb.im": save(px["RGB"], "IM"),
        "im-p-lut.im": save(px["P"], "IM"),
        "im-la.im": save(px["LA"], "IM"),
        "im-f.im": save(Image.fromarray(grey.astype(np.float32) * 1.7 - 30), "IM"),
        "im-ycc.im": save(px["RGB"].convert("YCbCr"), "IM"),
        "imt-grey.imt": imt_file(grey),
        "iptc-raw-rgb-band.iim": iptc_file(grey.tobytes(), (35, 21), 3, 1, band=2),
        "iptc-jpeg.iim": iptc_file(save(px["RGB"], "JPEG", quality=85), (35, 21), compression=5),
        "pcd-rotated.pcd": pcd_file(ycc, 3),
        "spider-big.spi": save(Image.fromarray(grey.astype(np.float32) * 0.9 + 5), "SPIDER"),
        "spider-little-stack.spi": spider_file(grey.astype(np.float32) - 20, False, 2),
        "blp1-palette.blp": save(px["P"], "BLP", blp_version="BLP1"),
        "blp2-palette-alpha.blp": save(px["RGBA"].quantize(60), "BLP", blp_version="BLP2"),
        "blp1-jpeg.blp": blp1_jpeg(px["RGB"]),
        "blp2-dxt1.blp": blp_file(2, 35, 21, dxt_blocks_of(px["RGBA"], "DXT1"), 1, 2, 1, 0,
                                  palette=pal),
        "blp2-dxt3.blp": blp_file(2, 36, 20, dxt_blocks_of(px["RGBA"].resize((36, 20)), "DXT3"),
                                  1, 2, 8, 1, palette=pal),
        "blp2-dxt5.blp": blp_file(2, 35, 21, dxt_blocks_of(px["RGBA"], "DXT5"), 1, 2, 8, 7,
                                  palette=pal),
        "fits-16.fits": fits_file(16, 35, 21, (grey.astype(">i2") * 3).tobytes()),
        "fits-float64.fits": fits_file(-64, 35, 21, (grey.astype(">f8") / 3).tobytes()),
        "fits-gzip.fits": fits_gzip_file(8, 35, 21, grey.astype(np.int64)),
        "flc-brun.flc": fli_file(35, 21, [fli_colour([(0, rng.integers(0, 256, (256, 3)))]),
                                          fli_brun(grey // 8)]),
        "ftex-dxt1.ftex": ftex_file(0, 35, 21, dxt_blocks_of(px["RGB"], "DXT1")),
        "ftex-rgb.ftex": ftex_file(1, 35, 21, rgb.tobytes()),
        "gbr-v1-grey.gbr": gbr_file(grey, 1),
        "gbr-v2-rgba.gbr": gbr_file(rgba_px, 2),
        "icns-png.icns": icns_file([(b"icp4", save(Image.fromarray(rgba_px).resize((16, 16)),
                                                   "PNG")),
                                    (b"ic07", save(Image.fromarray(rgb128), "PNG"))]),
        "icns-it32.icns": icns_file([(b"it32", b"\0" * 4 + icns_rgb32(rgb128)),
                                     (b"t8mk", mask128.tobytes())]),
        "msp-v1.msp": save(px["1"], "MSP"),
        "msp-v2.msp": msp2_file(np.asarray(px["1"]).astype(np.uint8)),
        "pixar.pxr": pixar_file(rgb),
        "sun-rle-24.ras": sun_file(sun_rows(rgb[..., ::-1], 24, False), 35, 24, rle=True),
        "sun-8-colour-map.ras": sun_file(sun_rows(grey % 60, 8), 35, 8, 1, pal[:180]),
        "sun-1.ras": sun_file(sun_rows(np.asarray(px["1"]).astype(np.uint8) & 1, 1), 35, 1),
        "xbm.xbm": save(px["1"], "XBM"),
        "xpm-p.xpm": xpm_file(np.asarray(px["P"]) % 40, cols[:40]),
        "xpm-rgb.xpm": xpm_file(grey.astype(np.int64) + 40, cols),
    }


def legacy_texture(img: Image.Image, kind: str) -> bytes:
    rgb = img.convert("RGB")
    if kind == "IPTC holding a TIFF":  # a grey IPTC image: the LZW TIFF's own colours
        return iptc_file(save(rgb, "TIFF", compression="tiff_lzw"), rgb.size, compression=5)
    if kind == "APNG frame 0":  # frame 0 of two, blended over and disposed of to background
        out = io.BytesIO()
        rgb.save(out, "PNG", save_all=True, append_images=[rgb.rotate(90)], disposal=1, blend=1)
        return out.getvalue()
    if kind == "IM RGB":
        return save(rgb, "IM")
    if kind == "BLP2 DXT5":
        return blp_file(2, rgb.width, rgb.height, dxt_blocks_of(rgb.convert("RGBA"), "DXT5"), 1,
                        2, 8, 7, palette=bytes(1024))
    if kind == "XPM 8-byte keys":  # 128x128 in 256 colours
        return long_key_xpm(rgb.resize((128, 128)), 256, 8)
    if kind == "McIdas 16-bit":  # grey words below 256 (Pillow clips the rest), a line prefix
        return mcidas_file(np.asarray(rgb.convert("L")), 2, prefix=4, gap=12)
    raise ValueError(kind)


def breaktime_legacy_pair():
    """BreakTime with its six textures re-encoded as LEGACY_TEXTURES names
    them, in the GLB's image order (an IPTC record holding an LZW TIFF,
    Pillow's IM of the normal map, a BLP2 DXT5, a 128x128 XPM of 8-byte
    keys, a 16-bit McIdas area of the metallic-roughness map, frame 0 of
    an APNG of the poster), under LEGACY_MIMES; and its lossless twin: each texture a
    PNG of Pillow's decode."""
    with open(os.path.join(SCENES, "BreakTime.glb"), "rb") as f:
        raw = f.read()
    files = [legacy_texture(Image.open(io.BytesIO(b)), kind)
             for b, kind in zip(glb_images(raw), LEGACY_TEXTURES)]
    pngs = [save(Image.open(io.BytesIO(b)).convert("RGBA"), "PNG", optimize=True) for b in files]
    return replace_glb_images(raw, files, LEGACY_MIMES), replace_glb_images(raw, pngs, "image/png")


def make_legacy_fixtures(out_dir: str) -> dict:
    """Write the legacy formats' fixtures and their manifest (the form of
    make_classic_fixtures'; an expectation over 256 KiB, PCD's 768x512, as
    the sha256 of Pillow's RGBA bytes) into `out_dir` -> the manifest."""
    os.makedirs(out_dir, exist_ok=True)

    def put(name, data):
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)

    images = []
    for name, raw in legacy_small_fixtures().items():
        put(name, raw)
        want = pillow(raw)
        entry = dict(file=name, format=Image.open(io.BytesIO(raw)).format)
        if want.nbytes > 256 * 1024:
            entry.update(shape=list(want.shape), sha256=sha256_rgba(want))
        else:
            entry["expect"] = name.rsplit(".", 1)[0] + ".rgba.npy"
            np.save(os.path.join(out_dir, entry["expect"]), want)
        images.append(entry)
    glb, twin = breaktime_legacy_pair()
    put(BT_LEGACY, glb)
    put(BT_LEGACY_TWIN, twin)
    manifest = dict(images=images, scene=dict(legacy=BT_LEGACY, legacy_twin=BT_LEGACY_TWIN))
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    return manifest


def committed_manifest() -> dict:
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


def fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def test_fixture_writer_makes_the_committed_set(tmp_path):
    """make_fixtures runs, and writes the committed files' names and
    expectations."""
    made = make_fixtures(str(tmp_path))
    assert made == committed_manifest()
    for entry in made["images"]:
        if "expect" in entry:
            np.testing.assert_array_equal(np.load(tmp_path / entry["expect"]),
                                          np.load(os.path.join(FIXTURES, entry["expect"])))
    total = sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in os.listdir(FIXTURES))
    assert total <= 5 * 2**20


@pytest.mark.parametrize("entry", committed_manifest()["images"], ids=lambda e: e["file"])
def test_committed_fixture_matches_pillow(entry):
    """Each committed expectation is Pillow's decode of the committed file,
    and the port's decode equals it."""
    raw = fixture(entry["file"])
    want = pillow(raw)
    got = decode_image_u8(raw, entry["file"])
    if "expect" in entry:
        np.testing.assert_array_equal(np.load(os.path.join(FIXTURES, entry["expect"])), want)
    else:
        assert list(want.shape) == entry["shape"] and sha256_rgba(want) == entry["sha256"]
    np.testing.assert_array_equal(got, want)


def test_committed_breaktime_mixed_pair():
    """The mixed GLB's textures are, in order, the kinds MIXED_FORMATS
    names, and their Pillow decodes are the twin's PNGs."""
    scene = committed_manifest()["scene"]
    files = glb_images(fixture(scene["mixed"]))
    pngs = glb_images(fixture(scene["mixed_twin"]))
    assert len(files) == len(pngs) == 6
    assert [f[:4] for f in files] == [b"II*\x00"] * 2 + [b"8BPS"] + [b"II*\x00"] * 3
    assert struct.unpack_from(">H", files[2], 24)[0] == 9  # Lab
    tags = [Image.open(io.BytesIO(files[i])).tag_v2 for i in (0, 1, 3, 4, 5)]
    assert [(t[259], t[262]) for t in tags] == [(7, 6), (34925, 6), (5, 2), (4, 1), (34925, 2)]
    assert tags[1][530] == (2, 2) and tags[1][317] == 2 and tags[0][284] == 2
    assert tags[2][274] == 6 and tags[3][266] == 2 and tags[4][266] == 2 and tags[4][317] == 2
    doc, _ = read_glb(fixture(scene["mixed"]))
    assert [img["mimeType"] for img in doc["images"]] == MIXED_MIMES
    for f, png in zip(files, pngs):
        assert png[:4] == b"\x89PNG"
        np.testing.assert_array_equal(pillow(f), pillow(png))


def test_committed_breaktime_j2k_pair():
    """The J2K GLB's textures are JPEG 2000 files of the kinds J2K_TEXTURES
    names (wavelet, component transform, layers, progression, JP2 or raw),
    and their Pillow decodes are the twin's PNGs."""
    scene = committed_manifest()["scene"]
    files = glb_images(fixture(scene["j2k"]))
    pngs = glb_images(fixture(scene["j2k_twin"]))
    assert len(files) == len(pngs) == 6
    for f, png, kw in zip(files, pngs, J2K_TEXTURES):
        raw = kw.get("no_jp2", False)
        assert f[:4] == (b"\xff\x4f\xff\x51" if raw else b"\0\0\0\x0c") and png[:4] == b"\x89PNG"
        cs = f[f.index(b"\xff\x4f\xff\x51"):]
        main, parts = j2k_parse(cs)
        cod = dict(main)[0xFF52]
        assert cod[9] == (0 if kw.get("irreversible") else 1) and cod[4] == kw.get("mct", 0)
        assert cod[1] == jpeg2000.PROGRESSIONS.index(kw.get("progression", "LRCP"))
        assert struct.unpack(">H", cod[2:4])[0] == len(kw.get("quality_layers", [0]))
        assert len(parts) == (16 if "tile_size" in kw else 1)
        np.testing.assert_array_equal(pillow(f), pillow(png))
    doc, _ = read_glb(fixture(scene["j2k"]))
    assert {img["mimeType"] for img in doc["images"]} == {"image/jp2"}


def dds_psd_manifest() -> dict:
    with open(os.path.join(DDS_PSD_FIXTURES, "manifest.json")) as f:
        return json.load(f)


def dds_psd_fixture(name: str) -> bytes:
    with open(os.path.join(DDS_PSD_FIXTURES, name), "rb") as f:
        return f.read()


def test_dds_psd_fixture_writer_makes_the_committed_set(tmp_path):
    """make_dds_psd_fixtures runs, and writes the committed files' names,
    expectations and bytes (its own 3 MiB beside the 5 of formats/)."""
    made = make_dds_psd_fixtures(str(tmp_path))
    assert made == dds_psd_manifest()
    for name in os.listdir(tmp_path):
        assert (tmp_path / name).read_bytes() == dds_psd_fixture(name), name
    total = sum(os.path.getsize(os.path.join(DDS_PSD_FIXTURES, n))
                for n in os.listdir(DDS_PSD_FIXTURES))
    assert total <= 3 * 2**20


@pytest.mark.parametrize("entry", dds_psd_manifest()["images"], ids=lambda e: e["file"])
def test_committed_dds_psd_fixture_matches_pillow(entry):
    """Each committed expectation is Pillow's decode of the committed file,
    and the port's decode equals it."""
    raw = dds_psd_fixture(entry["file"])
    want = pillow(raw)
    if "expect" in entry:
        np.testing.assert_array_equal(np.load(os.path.join(DDS_PSD_FIXTURES, entry["expect"])),
                                      want)
    else:
        assert list(want.shape) == entry["shape"] and sha256_rgba(want) == entry["sha256"]
    np.testing.assert_array_equal(decode_image_u8(raw, entry["file"]), want)


def test_committed_breaktime_dds_pair():
    """The DDS GLB's textures are, in order, the kinds DDS_TEXTURES names
    (FourCC or DXGI format, PSD colour mode and compression) under their
    MIME types, and their Pillow decodes are the twin's PNGs."""
    scene = dds_psd_manifest()["scene"]
    files = glb_images(dds_psd_fixture(scene["dds"]))
    pngs = glb_images(dds_psd_fixture(scene["dds_twin"]))
    assert len(files) == len(pngs) == 6
    dds_kinds = {b"DXT1": "DXT1", b"DXT5": "DXT5"}
    for f, png, kind in zip(files, pngs, DDS_TEXTURES):
        if kind.startswith("PSD"):
            pos = 26
            for _ in range(3):  # colour-mode data, image resources, layers and masks
                pos += 4 + struct.unpack(">I", f[pos : pos + 4])[0]
            colour, compression = struct.unpack(">H", f[24:26])[0], struct.unpack(
                ">H", f[pos : pos + 2])[0]
            assert f[:4] == b"8BPS" and (colour, compression) == (
                (3, 1) if kind == "PSD PackBits RGB" else (2, 0))
        elif f[84:88] == b"DX10":
            assert {82: "BC5", 98: "BC7"}[struct.unpack("<I", f[128:132])[0]] == kind
        else:
            assert dds_kinds[f[84:88]] == kind
        assert png[:4] == b"\x89PNG"
        np.testing.assert_array_equal(pillow(f), pillow(png))
    doc, _ = read_glb(dds_psd_fixture(scene["dds"]))
    assert [img["mimeType"] for img in doc["images"]] == [DDS_MIME] * 4 + [PSD_MIME] * 2


def test_committed_breaktime_pair():
    """The JPEG GLB's textures are JPEGs whose Pillow decodes are the
    twin's PNGs; the EXR sky holds BreakTimeSky.npy in half floats."""
    scene = committed_manifest()["scene"]
    jpegs, pngs = glb_images(fixture(scene["jpeg"])), glb_images(fixture(scene["twin"]))
    assert len(jpegs) == len(pngs) == 6
    for j, p in zip(jpegs, pngs):
        assert j[:2] == b"\xff\xd8" and p[:4] == b"\x89PNG"
        np.testing.assert_array_equal(pillow(j), pillow(p))
    sky = exr.read_exr(fixture(scene["sky"]))
    np.testing.assert_array_equal(sky, breaktime_sky_half().astype(np.float32))


if __name__ == "__main__":
    print(json.dumps(make_fixtures(FIXTURES), indent=1))
    print(json.dumps(make_dds_psd_fixtures(DDS_PSD_FIXTURES), indent=1))
    print(json.dumps(make_classic_fixtures(CLASSIC_FIXTURES), indent=1))
    print(json.dumps(make_legacy_fixtures(LEGACY_FIXTURES), indent=1))
