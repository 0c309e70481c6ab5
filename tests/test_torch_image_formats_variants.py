"""The image variants Pillow 12.1.0 reads that the port's decoders once
refused, held to Pillow's `Image.open(...).convert("RGBA")` bit for bit:

- BMP and the DIB core (rustic_tpu_torch/utils/bmp_tga.py): RLE8 and RLE4
  (Pillow's BmpRleDecoder; Pillow writes none: `rle_stream` here codes
  them, and random op streams test the decoder's quirks), 16-bit pixels
  (BI_RGB, the 555 and 565 bit fields), the 12-byte OS/2 header; in BMP,
  the bare DIB, ICO and CUR. 16-bit TGA of types 2 and 10.
- TIFF (utils/tiff.py): CCITT modified Huffman (2), T.4 one- and
  two-dimensional (3) and T.6 (4) through csrc/image_entropy.cpp
  `ccitt_rows` (Pillow's libtiff writers make the files; hypothesis and
  byte edits test libtiff's repairs); JPEG (7) in L, RGB, RGBA, CMYK and
  YCbCr, strips and tiles, with and without JPEGTables (`jpeg_tiff` wraps
  Pillow's JPEGs where Pillow's writer cannot: YCbCr subsampled); YCbCr
  under LZW, Deflate and none at 1x1, 2x1 and 2x2 with ReferenceBlackWhite
  and YCbCrCoefficients (`ycbcr_tiff`); CMYK; CIELab.
- LAB -> RGB (utils/modes.py `lab_to_rgb`, LittleCMS's transform as
  Pillow's convert runs it) on every L and a against a spread of b.
- WebP (utils/webp.py): an animated file's first frame (`anim_webp` writes
  ANIM and ANMF; Pillow's own animated writer too).
- Then: TIFF of fill order 2 at every compression and layout (refused
  where Pillow's OPEN_INFO or its raw modes lack it), of orientations 0-9
  (by tag of any type and by XMP), YCbCr in planar configuration 2 and
  with the predictor (libtiff's row sizes, its 4x4 put routine's skip),
  LZMA (`write_tiff(..., compression="LZMA")`, `ycbcr_tiff(..., "LZMA")`);
  McIdas areas (`mcidas_file`), XV thumbnails (`xvthumb_file`), Lab PSDs
  (the PSD and CIELab TIFF branches one conversion in Pillow), IPTC
  records holding PNGs and long-key XPMs among the fixtures.

The fixtures of tests/data_torch/formats_variants (read by chip_smoke.py's
`formats` phase on the card's host, which has no Pillow) are written by
`make_variant_fixtures`: `python -m tests.test_torch_image_formats_variants`
rewrites them; `--fuzz N SEED` runs N byte edits of each fax, RLE-BMP and
JPEG-in-TIFF fixture against Pillow (the suite keeps a fixed few hundred);
`--time` prints each fixture kind's ms per megapixel on this host, in turns
with the 1024x1024 Huffman photo as phase 34 times them on the card's.
`edit_fuzz` is the fuzz of tests/test_torch_image_formats_dds.py, _psd.py,
_classic.py and _legacy.py (`--fuzz N SEED` in each).
"""

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

from rustic_tpu_torch.utils import tiff as tiff_mod
from rustic_tpu_torch.utils.modes import lab_to_rgb
from rustic_tpu_torch.utils.png import decode_image_u8, image_format
from tests.test_torch_image_formats import (icon_dib, icon_file, iptc_file, long_key_xpm,
                                            mcidas_file, picture, pillow, rgb332,
                                            riff, save, tiff_lzw, webp_chunks, write_psd,
                                            write_tiff, xvthumb_file, xz)

VARIANT_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch",
                                "formats_variants")


def outcome(raw: bytes, name: str = ""):
    """Pillow's RGBA decode, or the exception its open or load raises."""
    try:
        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))
    except Exception as e:  # noqa: BLE001 - any refusal of Pillow's counts as one
        return e


def port_outcome(raw: bytes, name: str = ""):
    try:
        return decode_image_u8(raw, name)
    except (ValueError, NotImplementedError) as e:
        return e


def same(want, got) -> bool:
    if isinstance(want, Exception) or isinstance(got, Exception):
        return isinstance(want, Exception) and isinstance(got, Exception)
    return want.shape == got.shape and np.array_equal(want, got)


def assert_as_pillow(raw: bytes, name: str = ""):
    """Equal to Pillow's decode, or refused where Pillow refuses."""
    want, got = outcome(raw, name), port_outcome(raw, name)
    assert same(want, got), (f"Pillow {type(want).__name__}: {want}" if isinstance(
        want, Exception) else "Pillow decodes", f"port {type(got).__name__}: {got}" if
        isinstance(got, Exception) else "the port decodes")


def assert_pillow_equal(raw: bytes, name: str = ""):
    want = pillow(raw)
    np.testing.assert_array_equal(decode_image_u8(raw, name), want)


# ---- BMP: RLE8 / RLE4, 16 bits, OS/2 --------------------------------------------------------

def rle_stream(idx: np.ndarray, rle4: bool, top_down: bool = False) -> bytes:
    """Rows of palette indices -> an RLE8 (RLE4) stream as an encoder
    writes it: equal runs as encoded runs, other stretches as absolute
    runs (padded to a 16-bit word), an end of line each row, an end of
    bitmap; rows bottom-up unless `top_down`."""
    out = bytearray()
    for row in (idx if top_down else idx[::-1]):
        row = [int(v) for v in row]
        x, w = 0, len(row)
        while x < w:
            if rle4:  # runs of one index; other stretches absolute, an even count of nibbles
                n = 1
                while x + n < w and n < 255 and row[x + n] == row[x]:
                    n += 1
                if n >= 4 or w - x < 4:
                    n = n if n >= 4 else min(2, w - x)
                    out += bytes([n, row[x] << 4 | (row[x + 1] if n > 1 else 0)])
                    x += n
                    continue
                n = min(w - x, 64) & ~1
                body = bytes(a << 4 | b for a, b in zip(row[x : x + n : 2], row[x + 1 : x + n : 2]))
                out += bytes([0, n]) + body + b"\0" * (len(body) & 1)
                x += n
                continue
            n = 1
            while x + n < w and n < 255 and row[x + n] == row[x]:
                n += 1
            if n >= 2 or w - x < 3:
                out += bytes([n, row[x]])
                x += n
                continue
            e = x + 1
            while e < w and e - x < 255 and not (e + 1 < w and row[e + 1] == row[e]):
                e += 1
            n = e - x
            if n < 3:
                out += bytes([1, row[x]])
                x += 1
                continue
            out += bytes([0, n]) + bytes(row[x:e]) + b"\0" * (n & 1)
            x = e
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp_file(info: bytes, palette: bytes, data: bytes, gap: int = 0) -> bytes:
    """A BMP: the 14-byte file header, the DIB header `info`, the palette,
    `gap` zero bytes, the pixel data at the header's offset."""
    off = 14 + len(info) + len(palette) + gap
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + info + palette
            + bytes(gap) + data)


def quads(palette: np.ndarray) -> bytes:
    """[n, 3] RGB -> 4-byte BGR0 entries."""
    return np.concatenate([palette[:, ::-1], np.zeros((len(palette), 1), np.uint8)], 1
                          ).astype(np.uint8).tobytes()


def rle_bmp(idx: np.ndarray, palette: np.ndarray, rle4: bool = False, top_down: bool = False,
            stream: bytes = None, gap: int = 0) -> bytes:
    """An RLE8 (RLE4) BMP of palette indices `idx` [H, W] (or of the raw
    `stream`) with `palette` [n, 3]."""
    h, w = idx.shape
    data = rle_stream(idx, rle4, top_down) if stream is None else stream
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, 4 if rle4 else 8,
                       2 if rle4 else 1, len(data), 0, 0, len(palette), 0)
    return bmp_file(info, quads(palette), data, gap)


def bmp16(px: np.ndarray, masks=None, header: int = 40, top_down: bool = False) -> bytes:
    """A 16-bit BMP of uint16 pixels [H, W]: BI_RGB, or BI_BITFIELDS with
    `masks` (R, G, B) after a 40-byte header or inside a longer one."""
    h, w = px.shape
    stride = ((w * 16 + 31) >> 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : 2 * w] = np.ascontiguousarray(px, "<u2").view(np.uint8).reshape(h, 2 * w)
    data = (rows if top_down else rows[::-1]).tobytes()
    info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, 16,
                       0 if masks is None else 3, len(data), 0, 0, 0, 0)
    extra = b""
    if masks is not None:
        packed = struct.pack("<III", *masks)
        if header >= 52:
            info += packed + bytes(header - 52)
        else:
            extra = packed
    else:
        info += bytes(header - 40)
    return bmp_file(info + extra, b"", data)


def os2_bmp(px: np.ndarray, bits: int, palette: np.ndarray = None, bmp: bool = True) -> bytes:
    """A BMP (or bare DIB) with the 12-byte OS/2 core header: indices [H, W]
    at 1, 4 or 8 bits with 3-byte BGR entries, or [H, W, 3] at 24 bits."""
    h, w = px.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    if bits <= 8:
        per = 8 // bits
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = px
        packed = (padded.reshape(h, -1, per) << (np.arange(per)[::-1] * bits)).sum(-1)
    else:
        packed = px[..., ::-1].reshape(h, -1)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : packed.shape[1]] = packed
    info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    pal = b"" if palette is None else palette[:, ::-1].astype(np.uint8).tobytes()
    if not bmp:
        return info + pal + rows[::-1].tobytes()
    # Pillow moves a pixel offset that points at the palette by 4 bytes an entry
    data = rows[::-1].tobytes()
    off = 14 + 12 + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + info + pal + data


def tga16(px: np.ndarray, rle: bool = False, flags: int = 0x20) -> bytes:
    """A 16-bit true-colour TGA (type 2, or 10 with one packet a run of
    equal pixels) of uint16 pixels [H, W] in the file's row order."""
    h, w = px.shape
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 10 if rle else 2, 0, 0, 0, 0, 0, w, h, 16, flags)
    flat = np.ascontiguousarray(px, "<u2").reshape(-1)
    if not rle:
        return head + flat.tobytes()
    out, i = bytearray(), 0
    while i < len(flat):
        n = 1
        while i + n < len(flat) and n < 128 and flat[i + n] == flat[i]:
            n += 1
        if n > 1:
            out += bytes([0x80 | (n - 1)]) + flat[i : i + 1].tobytes()
        else:
            n = 1
            while i + n < len(flat) and n < 128 and flat[i + n] != flat[i + n - 1]:
                n += 1
            out += bytes([n - 1]) + flat[i : i + n].tobytes()
        i += n
    return head + bytes(out)


def grey_free_palette(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    pal[:, 0] |= 1  # no entry i = (i, i, i): Pillow keeps mode "P"
    pal[:, 1] &= 0xFE
    return pal


RLE_CASES = {
    "rle8 bottom-up": lambda: rle_bmp(np.random.default_rng(1).integers(0, 9, (13, 21))
                                      .astype(np.uint8), grey_free_palette(256)),
    "rle8 top-down": lambda: rle_bmp(np.repeat(np.arange(20, dtype=np.uint8)[None], 7, 0),
                                     grey_free_palette(256), top_down=True),
    "rle8 odd absolute run at an odd offset": lambda: rle_bmp(
        np.zeros((2, 5), np.uint8), grey_free_palette(256), gap=1,
        stream=b"\x00\x05\x01\x02\x03\x04\x05\x00\x00\x00\x00\x05\x09\x00\x01"),
    "rle8 delta": lambda: rle_bmp(np.zeros((4, 6), np.uint8), grey_free_palette(256),
                                  stream=b"\x02\x07\x00\x02\x00\x00\x01\x02\x03\x04\x00\x00"
                                         b"\x06\x05\x00\x00\x06\x06\x00\x01"),
    "rle8 run past the row's end": lambda: rle_bmp(
        np.zeros((2, 4), np.uint8), grey_free_palette(256),
        stream=b"\x09\x03\x05\x04\x00\x00\x04\x02\x00\x01"),
    "rle4": lambda: rle_bmp(np.random.default_rng(2).integers(0, 16, (9, 14)).astype(np.uint8),
                            grey_free_palette(16), rle4=True),
    "rle4 odd absolute run": lambda: rle_bmp(
        np.zeros((2, 6), np.uint8), grey_free_palette(16), rle4=True,
        stream=b"\x00\x05\x12\x34\x56\x00\x06\x78\x00\x00\x06\xab\x00\x01"),
    "rle8 grey palette": lambda: rle_bmp(np.arange(24, dtype=np.uint8).reshape(4, 6),
                                         np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)),
    "rle8 ends early": lambda: rle_bmp(np.zeros((3, 4), np.uint8), grey_free_palette(256),
                                       stream=b"\x04\x01\x00\x00\x04\x02\x00\x01"),
    "rle8 delta cut short": lambda: rle_bmp(np.zeros((2, 4), np.uint8), grey_free_palette(256),
                                            stream=b"\x04\x01\x00\x02\x00\x00\x01"),
    "rle on a 24-bit bitmap": lambda: bmp_file(struct.pack("<IiiHHIIiiII", 40, 2, 2, 1, 24, 1,
                                                           4, 0, 0, 0, 0), b"", b"\x04\x01" * 2),
}


@pytest.mark.parametrize("case", list(RLE_CASES))
def test_rle_bmp_cases_match_pillow(case):
    assert_as_pillow(RLE_CASES[case]())


def test_rle_cases_reach_their_paths():
    """The cases that should decode do; the broken ones are refused by both."""
    refused = {"rle8 ends early", "rle8 delta cut short", "rle on a 24-bit bitmap"}
    for case, make in RLE_CASES.items():
        assert isinstance(outcome(make()), Exception) == (case in refused), case


@settings(max_examples=150, deadline=None, derandomize=True)
@given(w=st.integers(1, 12), h=st.integers(1, 6), rle4=st.booleans(), top=st.booleans(),
       gap=st.integers(0, 1), ops=st.lists(st.tuples(st.integers(0, 5), st.integers(0, 255),
                                                      st.integers(0, 255)), max_size=14),
       cut=st.integers(0, 3))
def test_random_rle_streams_match_pillow(w, h, rle4, top, gap, ops, cut):
    """Random op streams (encoded runs, end of line, end of bitmap, deltas,
    absolute runs of either parity, a stream cut anywhere) against
    Pillow's BmpRleDecoder: the same pixels or both refuse."""
    stream = bytearray()
    for kind, a, b in ops:
        if kind == 0:
            stream += bytes([1 + a % 12, b])
        elif kind == 1:
            stream += b"\0\0"
        elif kind == 2:
            stream += b"\0\1"
        elif kind == 3:
            stream += b"\0\2" + bytes([a % 4, b % 4, b % 3, a % 2])
        else:
            n = 3 + a % 12
            body = bytes((b + 7 * i) % 256 for i in range((n + 1) // 2 if rle4 else n))
            stream += bytes([0, n]) + body + b"\0" * (len(body) & 1)
    stream = bytes(stream[: len(stream) - cut * (len(stream) // 4)])
    palette = grey_free_palette(16 if rle4 else 256)
    assert_as_pillow(rle_bmp(np.zeros((h, w), np.uint8), palette, rle4, top, stream, gap))


def px16(h, w, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 1 << 16, (h, w)).astype(np.uint16)


BMP16_CASES = {
    "BI_RGB": lambda: bmp16(px16(5, 7)),
    "BI_RGB top-down": lambda: bmp16(px16(5, 7, 1), top_down=True),
    "555 bit fields": lambda: bmp16(px16(6, 3, 2), (0x7C00, 0x3E0, 0x1F)),
    "565 bit fields": lambda: bmp16(px16(6, 3, 3), (0xF800, 0x7E0, 0x1F)),
    "565 bit fields in a 56-byte header": lambda: bmp16(px16(4, 9, 4), (0xF800, 0x7E0, 0x1F),
                                                        56),
    "565 bit fields in a V5 header": lambda: bmp16(px16(4, 9, 5), (0xF800, 0x7E0, 0x1F), 124),
    "444 bit fields (refused by both)": lambda: bmp16(px16(2, 2), (0xF00, 0xF0, 0xF)),
}


@pytest.mark.parametrize("case", list(BMP16_CASES))
def test_16_bit_bmp_matches_pillow(case):
    assert_as_pillow(BMP16_CASES[case]())


def test_16_bit_unpackers_are_pillows_on_every_value():
    """BGR;15 and BGR;16 (BMP) and BGRA;15Z (TGA) on all 65536 pixels."""
    every = np.arange(1 << 16, dtype=np.uint16).reshape(256, 256)
    for masks in (None, (0xF800, 0x7E0, 0x1F)):
        assert_pillow_equal(bmp16(every, masks))
    assert_pillow_equal(tga16(every), "a.tga")


OS2_CASES = {
    "1-bit": (lambda: os2_bmp(np.random.default_rng(0).integers(0, 2, (5, 11)), 1,
                              grey_free_palette(2)), ""),
    "4-bit": (lambda: os2_bmp(np.random.default_rng(1).integers(0, 16, (5, 11)), 4,
                              grey_free_palette(16)), ""),
    "8-bit": (lambda: os2_bmp(np.random.default_rng(2).integers(0, 256, (5, 11)), 8,
                              grey_free_palette(256)), ""),
    "8-bit grey": (lambda: os2_bmp(np.arange(55).reshape(5, 11) % 256, 8,
                                   np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)), ""),
    "24-bit": (lambda: os2_bmp(picture(5, 11), 24), ""),
    "bare DIB 8-bit": (lambda: os2_bmp(np.random.default_rng(3).integers(0, 256, (4, 6)), 8,
                                       grey_free_palette(256), bmp=False), ""),
}


@pytest.mark.parametrize("case", list(OS2_CASES))
def test_os2_bitmaps_match_pillow(case):
    make, name = OS2_CASES[case]
    assert_as_pillow(make(), name)


def icon_kinds():
    px = px16(8, 8, 7)
    rgb = np.zeros((8, 8, 3), np.uint8)
    dib = icon_dib(rgb, 24)
    dib16 = bytearray(dib)
    dib16[14:16] = struct.pack("<H", 16)
    stride16 = 16
    body = np.zeros((8, stride16), np.uint8)
    body[:, :16] = px.view(np.uint8).reshape(8, 16)
    dib16 = bytes(dib16[:40]) + body.tobytes() + bytes(4 * 8)  # the pixels, then the AND mask
    os2 = struct.pack("<IHHHH", 12, 8, 16, 1, 24) + picture(8, 8)[::-1, :, ::-1].tobytes() + \
        bytes(4 * 8)
    return {
        "ICO 16-bit": icon_file([(dib16, 8, 8, 16, 0)]),
        "CUR 16-bit": icon_file([(dib16, 8, 8, 1, 1)], cursor=True),
        "ICO OS/2 header": icon_file([(os2, 8, 8, 24, 0)]),
        "CUR OS/2 header": icon_file([(os2, 8, 8, 1, 1)], cursor=True),
    }


@pytest.mark.parametrize("case", list(icon_kinds()))
def test_icon_bitmaps_of_the_new_kinds_match_pillow(case):
    assert_as_pillow(icon_kinds()[case])


@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("flags", [0x20, 0x00, 0x10, 0x30, 0x2F, 0x08])
def test_16_bit_tga_matches_pillow(rle, flags):
    """Types 2 and 10, every origin, the descriptor's attribute bits set or
    not (Pillow ignores them: alpha comes from the top bit alone)."""
    px = px16(6, 9, flags)
    px[2, :4] = px[2, 0]  # a run for the RLE packets
    assert_as_pillow(tga16(px, rle, flags), "a.tga")


# ---- TIFF: CCITT ---------------------------------------------------------------------------

FAX = {"CCITT RLE": "tiff_ccitt", "Group 3": "group3", "Group 4": "group4"}


def fax_tiff(bits: np.ndarray, kind: str, t4: int = None, photometric: int = None,
             rows_per_strip: int = None) -> bytes:
    info = {}
    if t4 is not None:
        info[292] = t4
    if photometric is not None:
        info[262] = photometric
    if rows_per_strip is not None:
        info[278] = rows_per_strip
    return save(Image.fromarray(bits), "TIFF", compression=FAX[kind], tiffinfo=info)


def fax_bits(h, w, seed=0, p=0.3) -> np.ndarray:
    return np.random.default_rng(seed).random((h, w)) < p


@pytest.mark.parametrize("kind", list(FAX))
@pytest.mark.parametrize("t4", [None, 1, 5])
@pytest.mark.parametrize("photometric", [None, 0])
def test_fax_tiff_matches_pillow(kind, t4, photometric):
    """Pillow's libtiff writers: 1-D and 2-D T.4 (Group3Options bit 0) with
    byte-aligned EOLs (bit 2), both photometrics, strips of 5 rows."""
    raw = fax_tiff(fax_bits(23, 37, 1), kind, t4, photometric, 5)
    assert_pillow_equal(raw)


def test_fax_runs_of_every_length():
    """Rows with runs across the make-up codes (64...1728) and the extended
    ones (1792...2560) and a row wider than 2560, each kind."""
    w = 5300
    bits = np.zeros((6, w), bool)
    edges = [0, 1, 63, 64, 65, 1727, 1728, 1800, 2560, 2561, 4400, w]
    for r in range(6):
        for i, (a, b) in enumerate(zip(edges[r % 3:], edges[r % 3 + 1 :])):
            bits[r, a:b] = bool((i + r) & 1)
    for kind in FAX:
        for t4 in (None, 1):
            assert_pillow_equal(fax_tiff(bits, kind, t4))


@settings(max_examples=60, deadline=None, derandomize=True)
@given(h=st.integers(1, 12), w=st.integers(1, 90), p=st.sampled_from([0.0, 0.05, 0.5, 0.95, 1.0]),
       kind=st.sampled_from(list(FAX)), t4=st.sampled_from([None, 1, 4, 5]),
       photometric=st.sampled_from([None, 0]), rps=st.integers(1, 12), seed=st.integers(0, 99))
def test_random_fax_images_match_pillow(h, w, p, kind, t4, photometric, rps, seed):
    assert_pillow_equal(fax_tiff(fax_bits(h, w, seed, p), kind, t4, photometric, rps))


def strip_span(raw: bytes):
    tags = Image.open(io.BytesIO(raw)).tag_v2
    return tags[273][0], tags[279][0]


def rows_left_unwritten(raw: bytes) -> bool:
    """Whether libtiff leaves rows of this TIFF unwritten (a T.6 strip that
    ends early, a JPEG smaller than its strip or tile): Pillow's decode
    then shows its buffer's old memory, which no decoder reproduces, and
    such an edit is not compared."""
    state = []
    spied = {}
    for name in ("_fax", "_jpeg_block"):
        real = spied[name] = getattr(tiff_mod, name)

        def spy(*a, real=real):
            out = real(*a)
            state.append(a[-1].short)
            return out

        setattr(tiff_mod, name, spy)
    try:
        port_outcome(raw)
    finally:
        for name, real in spied.items():
            setattr(tiff_mod, name, real)
    return any(state)


def edit(raw: bytes, kind: str, where: float, value: int, span=None) -> bytes:
    """One byte edit of a file (within `span` (start, length) where given,
    else after its first 4 bytes): a bit flipped, a byte set, zeros over a
    run, a cut, one or two bytes inserted."""
    start, length = span or (4, len(raw) - 4)
    i = start + int(where * max(length - 1, 0))
    if kind == "flip":
        return raw[:i] + bytes([raw[i] ^ (1 << (value % 8))]) + raw[i + 1 :]
    if kind == "byte":
        return raw[:i] + bytes([value & 255]) + raw[i + 1 :]
    if kind == "zero":
        n = min(1 + value % 16, len(raw) - i)
        return raw[:i] + bytes(n) + raw[i + n :]
    if kind == "cut":
        return raw[:i]
    return raw[:i] + bytes([value & 255, value >> 8 & 255])[: 1 + value % 2] + raw[i:]


EDITS = ["flip", "byte", "zero", "cut", "insert"]


@settings(max_examples=200, deadline=None, derandomize=True)
@given(kind=st.sampled_from(list(FAX)), t4=st.sampled_from([None, 1]),
       edit_kind=st.sampled_from(["flip", "byte", "zero"]), where=st.floats(0, 1),
       value=st.integers(0, 2**16), seed=st.integers(0, 20))
def test_edited_fax_data_decodes_as_libtiff_repairs_it(kind, t4, edit_kind, where, value, seed):
    """Edits inside the strip's data: bad codes, lost EOLs (libtiff then
    reads the strip again from its start without EOL sync), runs past the
    row's end, pass codes beyond the reference row (they read the run
    array an earlier row left), data that ends early."""
    raw = fax_tiff(fax_bits(7, 41, seed), kind, t4, rows_per_strip=3)
    edited = edit(raw, edit_kind, where, value, strip_span(raw))
    if rows_left_unwritten(edited):
        return
    assert_as_pillow(edited)


# ---- TIFF: JPEG ------------------------------------------------------------------------------

def ifd_tiff(width: int, height: int, blocks, tags: dict, tile=None, order: str = "<") -> bytes:
    """A classic TIFF of the strips or tiles `blocks` (bytes) and `tags`
    {tag: (type, values)}: types 3, 4, 5 (rationals as (num, den) pairs)
    and 1, 2 and 7 (bytes)."""
    offsets, data = [], b""
    for b in blocks:
        offsets.append(8 + len(data))
        data += b + b"\x00" * (len(b) & 1)
    entries = {256: (4, [width]), 257: (4, [height])}
    if tile:
        entries.update({322: (4, [tile[0]]), 323: (4, [tile[1]]), 324: (4, offsets),
                        325: (4, [len(b) for b in blocks])})
    else:
        entries.update({273: (4, offsets), 279: (4, [len(b) for b in blocks])})
    entries.update(tags)
    ifd = 8 + len(data)
    at = ifd + 2 + 12 * len(entries) + 4
    body, spill = b"", b""
    for tag, (kind, vals) in sorted(entries.items()):
        if kind in (1, 2, 7):
            value, count = bytes(vals), len(vals)
        elif kind == 5:
            value = b"".join(struct.pack(order + "II", n, d) for n, d in vals)
            count = len(vals)
        else:
            value, count = struct.pack(order + {3: "H", 4: "I"}[kind] * len(vals), *vals), len(vals)
        if len(value) <= 4:
            body += struct.pack(order + "HHI", tag, kind, count) + value.ljust(4, b"\x00")
        else:
            body += struct.pack(order + "HHII", tag, kind, count, at + len(spill))
            spill += value + b"\x00" * (len(value) & 1)
    head = (b"II*\x00" if order == "<" else b"MM\x00*") + struct.pack(order + "I", ifd)
    return head + data + struct.pack(order + "H", len(entries)) + body + bytes(4) + spill


def jpeg_segments(raw: bytes):
    """A JPEG -> its segments before SOS [(marker, whole segment bytes)]
    and the rest from SOS on."""
    pos, out = 2, []
    while raw[pos + 1] != 0xDA:
        n = struct.unpack(">H", raw[pos + 2 : pos + 4])[0]
        out.append((raw[pos + 1], raw[pos : pos + 2 + n]))
        pos += 2 + n
    return out, raw[pos:]


def jpeg_tiff(rgb: np.ndarray, mode: str = "YCbCr", subsampling: int = 2, quality: int = 80,
              rows_per_strip: int = None, tile=None, tables: bool = True,
              progressive: bool = False) -> bytes:
    """A JPEG-compressed TIFF (compression 7) whose strips or tiles are
    Pillow's JPEGs of their pixels, as libtiff lays them out: each strip a
    JPEG of its rows (the last strip its remaining rows), each tile a JPEG
    of the whole tile (edge tiles padded by repeating the edge); with
    `tables`, the DQT and DHT segments move into JPEGTables (tag 347) and
    each stream keeps the rest. `mode` "YCbCr" (photometric 6, Pillow's
    colour-converted JPEG, subsampling 0/1/2 = 4:4:4/4:2:2/4:2:0), "RGB"
    (photometric 2, the JPEG's components taken raw), "L"."""
    h, w = rgb.shape[:2]
    img = Image.fromarray(rgb).convert("L" if mode == "L" else "RGB")
    arr = np.asarray(img)
    if tile:
        tw, tl = tile
        pieces = []
        for y in range(0, h, tl):
            for x in range(0, w, tw):
                part = arr[y : y + tl, x : x + tw]
                part = np.pad(part, [(0, tl - part.shape[0]), (0, tw - part.shape[1])]
                              + [(0, 0)] * (arr.ndim - 2), mode="edge")
                pieces.append(part)
    else:
        rps = rows_per_strip or h
        pieces = [arr[y : y + rps] for y in range(0, h, rps)]
    streams = [save(Image.fromarray(p), "JPEG", quality=quality, progressive=progressive,
                    **({} if mode == "L" else dict(subsampling=0 if mode == "RGB" else
                                                    subsampling)))
               for p in pieces]
    tags = {258: (3, [8] * (1 if mode == "L" else 3)), 259: (3, [7]),
            262: (3, [{"L": 1, "RGB": 2, "YCbCr": 6}[mode]]), 277: (3, [1 if mode == "L" else 3])}
    if mode == "YCbCr":
        tags[530] = (3, [[1, 2, 2][subsampling], [1, 1, 2][subsampling]])
    if not tile:
        tags[278] = (4, [rows_per_strip or h])
    if tables:
        segs, _ = jpeg_segments(streams[0])
        table = b"".join(s for m, s in segs if m in (0xDB, 0xC4))
        tags[347] = (7, list(b"\xff\xd8" + table + b"\xff\xd9"))
        out = []
        for s in streams:
            segs, rest = jpeg_segments(s)
            out.append(b"\xff\xd8" + b"".join(b for m, b in segs if m not in (0xDB, 0xC4, 0xE0))
                       + rest)
        streams = out
    return ifd_tiff(w, h, streams, tags, tile)


JPEG_TIFF_CASES = {
    "Pillow L": lambda: save(Image.fromarray(picture(29, 35, 1)).convert("L"), "TIFF",
                             compression="jpeg"),
    "Pillow RGB": lambda: save(Image.fromarray(picture(29, 35, 2)), "TIFF", compression="jpeg",
                               quality=60),
    "Pillow RGBA": lambda: save(Image.fromarray(picture(29, 35, 3)).convert("RGBA"), "TIFF",
                                compression="jpeg"),
    "Pillow CMYK": lambda: save(Image.fromarray(picture(29, 35, 4)).convert("CMYK"), "TIFF",
                                compression="jpeg"),
    "Pillow YCbCr 1x1 strips": lambda: save(Image.fromarray(picture(37, 35, 5)).convert("YCbCr"),
                                            "TIFF", compression="jpeg", tiffinfo={278: 16}),
    "YCbCr 2x2 strips": lambda: jpeg_tiff(picture(37, 45, 6), rows_per_strip=16),
    "YCbCr 2x2 tiles": lambda: jpeg_tiff(picture(37, 45, 7), tile=(32, 16)),
    "YCbCr 2x1 strips without tables": lambda: jpeg_tiff(picture(21, 30, 8), subsampling=1,
                                                         rows_per_strip=8, tables=False),
    "YCbCr 2x2 progressive": lambda: jpeg_tiff(picture(24, 24, 9), progressive=True),
    "RGB raw components, tiles": lambda: jpeg_tiff(picture(20, 40, 10), "RGB", tile=(16, 16)),
    "L tiles": lambda: jpeg_tiff(picture(20, 40, 11), "L", tile=(16, 16)),
}


@pytest.mark.parametrize("case", list(JPEG_TIFF_CASES))
def test_jpeg_tiff_matches_pillow(case):
    assert_pillow_equal(JPEG_TIFF_CASES[case]())


@settings(max_examples=40, deadline=None, derandomize=True)
@given(h=st.integers(1, 40), w=st.integers(1, 40), quality=st.integers(5, 100),
       subsampling=st.sampled_from([0, 1, 2]), layout=st.sampled_from(["strips", "tiles"]),
       rps=st.sampled_from([8, 16, 24]), tables=st.booleans(), seed=st.integers(0, 99))
def test_random_jpeg_tiffs_match_pillow(h, w, quality, subsampling, layout, rps, tables, seed):
    raw = jpeg_tiff(picture(h, w, seed), subsampling=subsampling, quality=quality,
                    rows_per_strip=rps if layout == "strips" else None,
                    tile=(16, 16) if layout == "tiles" else None, tables=tables)
    assert_pillow_equal(raw)


# ---- TIFF: YCbCr without JPEG, CMYK, CIELab -------------------------------------------------

def ycbcr_units(ycc: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """[H, W, 3] YCbCr -> the data units of a chunky subsampled TIFF [rows of
    units, units a row, hs * vs + 2]: the luma block, then the block's
    first Cb and Cr (the image padded by repeating its edge)."""
    h, w = ycc.shape[:2]
    ph, pw = -(-h // vs) * vs, -(-w // hs) * hs
    p = np.pad(ycc, [(0, ph - h), (0, pw - w), (0, 0)], mode="edge")
    uy, ux = ph // vs, pw // hs
    lum = p[..., 0].reshape(uy, vs, ux, hs).transpose(0, 2, 1, 3).reshape(uy, ux, vs * hs)
    chroma = p[::vs, ::hs, 1:]
    return np.concatenate([lum, chroma], -1)


def ycbcr_tiff(rgb: np.ndarray, sub=(2, 2), compression: str = "LZW", rows_per_strip=None,
               tile=None, refbw=None, coefs=None, tags=None, predictor: int = 1) -> bytes:
    """A YCbCr TIFF (photometric 6) of Pillow's YCbCr of `rgb`, subsampled
    (hs, vs) by taking each block's first chroma; compression "none",
    "LZW", "Deflate" or "LZMA"; ReferenceBlackWhite / YCbCrCoefficients as
    rationals where given; with predictor 2 each row of libtiff's
    predictor (a row of data units over v in a strip, the tile width x 3
    in a tile) differenced 3 bytes apart, where the strip or tile holds
    whole such rows of whole 3 bytes (as libtiff's horAcc8 undoes it)."""
    ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr"))
    h, w = ycc.shape[:2]
    hs, vs = sub
    code = {"none": lambda b: b, "LZW": tiff_lzw, "Deflate": lambda b: zlib.compress(b, 6),
            "LZMA": xz}[compression]

    def pack(data, rowsize):
        if predictor == 2 and rowsize % 3 == 0 and len(data) % rowsize == 0:
            d = np.frombuffer(data, np.uint8).reshape(-1, rowsize).astype(np.int64)
            d[:, 3:] -= d[:, :-3].copy()
            data = (d & 255).astype(np.uint8).tobytes()
        return code(data)

    if tile:
        tw, tl = tile
        blocks = []
        for y in range(0, h, tl):
            for x in range(0, w, tw):
                part = ycc[y : y + tl, x : x + tw]
                part = np.pad(part, [(0, tl - part.shape[0]), (0, tw - part.shape[1]), (0, 0)],
                              mode="edge")
                blocks.append(pack(ycbcr_units(part, hs, vs).tobytes(), tw * 3))
    else:
        rps = rows_per_strip or h
        rowsize = -(-w // hs) * (hs * vs + 2) // vs
        blocks = [pack(ycbcr_units(ycc[y : y + rps], hs, vs).tobytes(), rowsize)
                  for y in range(0, h, rps)]
    entries = {258: (3, [8, 8, 8]), 259: (3, [{"none": 1, "LZW": 5, "Deflate": 8,
                                               "LZMA": 34925}[compression]]),
               262: (3, [6]), 277: (3, [3]), 530: (3, [hs, vs])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if not tile:
        entries[278] = (4, [rows_per_strip or h])
    if refbw is not None:
        entries[532] = (5, refbw)
    if coefs is not None:
        entries[529] = (5, coefs)
    entries.update(tags or {})
    return ifd_tiff(w, h, blocks, entries, tile)


REFBW_STUDIO = [(0, 1), (255, 1), (128, 1), (255, 1), (128, 1), (255, 1)]
REFBW_VIDEO = [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)]
COEFS_709 = [(2126, 10000), (7152, 10000), (722, 10000)]


@pytest.mark.parametrize("compression", ["LZW", "Deflate"])
@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2), (4, 2), (1, 2), (4, 4), (4, 1)])
def test_ycbcr_tiff_matches_pillow(compression, sub):
    """libtiff's RGBA interface (TIFFYCbCrToRGB's float and 16.16 tables)
    at every subsampling it reads, odd sizes, strips of 6 rows."""
    raw = ycbcr_tiff(picture(17, 23, sub[0] + 3 * sub[1]), sub, compression, rows_per_strip=8)
    assert_pillow_equal(raw)


@pytest.mark.parametrize("refbw", [None, REFBW_STUDIO, REFBW_VIDEO])
@pytest.mark.parametrize("coefs", [None, COEFS_709])
def test_ycbcr_reference_black_white_and_coefficients(refbw, coefs):
    assert_pillow_equal(ycbcr_tiff(picture(12, 14, 3), (2, 1), "LZW", tile=(16, 16), refbw=refbw,
                                   coefs=coefs))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(h=st.integers(1, 20), w=st.integers(1, 20), sub=st.sampled_from([(1, 1), (2, 1), (2, 2)]),
       rps=st.integers(1, 8), lo=st.integers(0, 40), hi=st.integers(200, 255),
       c_lo=st.integers(0, 140), c_hi=st.integers(141, 255), seed=st.integers(0, 99))
def test_random_ycbcr_tiffs_match_pillow(h, w, sub, rps, lo, hi, c_lo, c_hi, seed):
    refbw = [(lo, 1), (hi, 1), (c_lo, 1), (c_hi, 1), (c_lo, 1), (c_hi, 1)]
    raw = ycbcr_tiff(picture(h, w, seed), sub, "Deflate", rows_per_strip=rps * sub[1],
                     refbw=refbw)
    assert_pillow_equal(raw)


@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2)])
def test_uncompressed_ycbcr_is_read_as_pillow_misreads_it(sub):
    """Pillow reads uncompressed YCbCr itself, as rawmode "RGBX": 4 bytes a
    pixel from each strip's offset, nothing converted; the port copies
    that, and refuses where Pillow runs out of file."""
    raw = ycbcr_tiff(picture(6, 5, 1), sub, "none")
    assert not isinstance(outcome(raw), Exception)
    assert_pillow_equal(raw)
    assert_as_pillow(ycbcr_tiff(picture(40, 40, 1), sub, "none"))


TIFF_MODE_CASES = {
    "CMYK none": lambda: save(Image.fromarray(picture(13, 21, 1)).convert("CMYK"), "TIFF"),
    "CMYK LZW": lambda: save(Image.fromarray(picture(13, 21, 2)).convert("CMYK"), "TIFF",
                             compression="tiff_lzw"),
    "CMYK Deflate": lambda: save(Image.fromarray(picture(13, 21, 3)).convert("CMYK"), "TIFF",
                                 compression="tiff_adobe_deflate"),
    "CIELab none": lambda: save(Image.frombytes("LAB", (21, 13), picture(13, 21, 4).tobytes()),
                                "TIFF"),
    "CIELab LZW": lambda: save(Image.frombytes("LAB", (21, 13), picture(13, 21, 5).tobytes()),
                               "TIFF", compression="tiff_lzw"),
    "CIELab from RGB": lambda: save(Image.fromarray(picture(13, 21, 6)).convert("LAB"), "TIFF",
                                    compression="tiff_adobe_deflate"),
}


@pytest.mark.parametrize("case", list(TIFF_MODE_CASES))
def test_cmyk_and_cielab_tiff_match_pillow(case):
    assert_pillow_equal(TIFF_MODE_CASES[case]())


def test_lab_to_rgb_is_littlecms_on_every_l_and_a():
    """Every L and a against eight b values, and every b against eight
    (L, a): LittleCMS's transform as Pillow's convert runs it."""
    v = np.arange(256, dtype=np.uint8)
    for b in (0, 1, 64, 127, 128, 129, 200, 255):
        lab = np.stack([*np.meshgrid(v, v, indexing="ij"), np.full((256, 256), b, np.uint8)], -1)
        want = np.asarray(Image.frombytes("LAB", (256, 256), lab.tobytes()).convert("RGB"))
        np.testing.assert_array_equal(lab_to_rgb(lab), want)
    for la in ((0, 0), (255, 128), (107, 25), (50, 200), (200, 90), (1, 255), (254, 0),
               (128, 128)):
        lab = np.stack([np.full(256, la[0]), np.full(256, la[1]), v], -1).astype(np.uint8)[None]
        want = np.asarray(Image.frombytes("LAB", (256, 1), lab.tobytes()).convert("RGB"))
        np.testing.assert_array_equal(lab_to_rgb(lab), want)


@settings(max_examples=30, deadline=None, derandomize=True)
@given(triples=st.lists(st.tuples(st.integers(0, 255), st.integers(0, 255), st.integers(0, 255)),
                        min_size=1, max_size=64))
def test_random_lab_triples_match_pillow(triples):
    lab = np.array(triples, np.uint8)[None]
    want = np.asarray(Image.frombytes("LAB", (len(triples), 1), lab.tobytes()).convert("RGB"))
    np.testing.assert_array_equal(lab_to_rgb(lab), want)


def test_a_known_lab_pixel():
    """Pillow's LAB (107, 25, 175) converts to RGB (16, 90, 236)."""
    lab = np.array([[[107, 25, 175]]], np.uint8)
    np.testing.assert_array_equal(lab_to_rgb(lab), [[[16, 90, 236]]])


# ---- WebP: an animation's first frame -------------------------------------------------------

def u24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def anim_webp(canvas, frames, alpha_flag: bool, background: int = 0xFF102030) -> bytes:
    """An animated WebP: VP8X (animation flag, alpha flag where asked) of
    `canvas` (w, h), ANIM, and one ANMF a frame: (x, y, a still WebP
    whose image chunks it carries, the blending / disposal flags)."""
    cw, ch = canvas
    chunks = [(b"VP8X", bytes([0x02 | (0x10 if alpha_flag else 0), 0, 0, 0]) + u24(cw - 1)
               + u24(ch - 1)), (b"ANIM", struct.pack("<IH", background, 0))]
    for x, y, still, flags in frames:
        w, h = Image.open(io.BytesIO(still)).size
        body = u24(x // 2) + u24(y // 2) + u24(w - 1) + u24(h - 1) + u24(80) + bytes([flags])
        for k, b in webp_chunks(still):
            if k != b"VP8X":
                body += k + struct.pack("<I", len(b)) + b + b"\0" * (len(b) & 1)
        chunks.append((b"ANMF", body))
    return riff(chunks)


def still(kind: str, h: int, w: int, seed: int) -> bytes:
    px = picture(h, w, seed)
    if kind == "lossy":
        return save(Image.fromarray(px), "WEBP", quality=80)
    alpha = np.random.default_rng(seed).integers(0, 256, (h, w)).astype(np.uint8)
    if kind == "lossless":
        return save(Image.fromarray(np.dstack([px, alpha])), "WEBP", lossless=True)
    return save(Image.fromarray(np.dstack([px, alpha])), "WEBP", quality=80)  # lossy + ALPH


@pytest.mark.parametrize("kind", ["lossy", "lossless", "lossy with alpha"])
@pytest.mark.parametrize("alpha_flag", [False, True])
def test_animated_webp_first_frame_matches_pillow(kind, alpha_flag):
    raw = anim_webp((40, 30), [(6, 4, still(kind, 17, 23, 1), 2), (0, 0, still(kind, 8, 8, 2), 0)],
                    alpha_flag)
    assert_pillow_equal(raw)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(fw=st.integers(1, 24), fh=st.integers(1, 24), dx=st.integers(0, 12), dy=st.integers(0, 12),
       kind=st.sampled_from(["lossy", "lossless", "lossy with alpha"]), alpha=st.booleans(),
       flags=st.integers(0, 3), seed=st.integers(0, 99))
def test_random_anmf_offsets_and_sizes_match_pillow(fw, fh, dx, dy, kind, alpha, flags, seed):
    x, y = 2 * (dx // 2), 2 * (dy // 2)
    raw = anim_webp((fw + dx, fh + dy), [(x, y, still(kind, fh, fw, seed), flags)], alpha)
    assert_as_pillow(raw)


def test_pillows_own_animations_match_pillow():
    frames = [Image.fromarray(picture(12, 10, s)) for s in range(3)]
    for kw in ({}, {"lossless": True}):
        raw = save(frames[0], "WEBP", save_all=True, append_images=frames[1:], **kw)
        assert_pillow_equal(raw)
    rgba = [f.convert("RGBA") for f in frames]
    assert_pillow_equal(save(rgba[0], "WEBP", save_all=True, append_images=rgba[1:]))


def test_a_frame_outside_its_canvas_is_refused_as_pillow_refuses_it():
    assert_as_pillow(anim_webp((8, 8), [(4, 0, still("lossy", 8, 8, 1), 0)], False))


# ---- TIFF: fill order 2, orientations, planar and predicted YCbCr, LZMA ----------------------

# (photometric, bits, samples) -> the layouts Pillow's OPEN_INFO has with fill order 2, and some
# it has not (RGBA, CMYK, CIELab, 16-bit RGB, grey + alpha, big-endian 16-bit grey)
FILL_LAYOUTS = [(1, 1, 1), (0, 1, 1), (1, 2, 1), (0, 2, 1), (1, 4, 1), (0, 4, 1), (1, 8, 1),
                (0, 8, 1), (1, 16, 1), (2, 8, 3), (3, 1, 1), (3, 2, 1), (3, 4, 1), (3, 8, 1),
                (2, 8, 4), (5, 8, 4), (8, 8, 3), (2, 16, 3), (1, 8, 2)]


def layout_tiff(photometric, bits, n, seed=0, **kw) -> bytes:
    """A 5 x 11 TIFF (write_tiff) of random samples of the layout."""
    rng = np.random.default_rng(seed)
    top = 300 if bits == 16 else 1 << bits
    px = rng.integers(0, top, (5, 11, n)).astype(np.uint16 if bits == 16 else np.uint8)
    if photometric == 3:
        kw["colour_map"] = list(rng.integers(0, 65536, 3 << bits))
    if n == 2 or photometric == 2 and n == 4:
        kw["extra"] = (2,)
    return write_tiff(px, photometric, bits, rows_per_strip=2, **kw)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("compression", ["none", "LZW", "Deflate", "PackBits", "LZMA"])
@pytest.mark.parametrize("layout", FILL_LAYOUTS, ids=str)
def test_fill_order_2_matches_pillow(layout, compression, order):
    """Fill order 2: every byte of a strip bit-reversed, at every
    compression (libtiff reverses the bits; Pillow's own reader takes the
    ";R" raw modes, of which P;1R, P;2R, P;4R and L;IR do not exist); a
    layout OPEN_INFO has no fill-order-2 key for is refused as Pillow
    refuses it. With the predictor where the bits allow it."""
    predictor = 2 if compression in ("LZW", "Deflate", "LZMA") and layout[1] >= 8 else 1
    assert_as_pillow(layout_tiff(*layout, compression=compression, order=order,
                                 predictor=predictor, fill_order=2))


@pytest.mark.parametrize("kind", ["tiff_ccitt", "group3", "group4"])
@pytest.mark.parametrize("fill_order", [1, 2])
def test_fax_and_jpeg_fill_order_2_match_pillow(kind, fill_order):
    """libtiff's fax decoder reads fill order 2 least significant bit first
    (Pillow's writer stores it so); its JPEG codec does not reverse bits."""
    bits = fax_bits(9, 30, fill_order)
    assert_pillow_equal(save(Image.fromarray(bits), "TIFF", compression=kind,
                             tiffinfo={266: fill_order, 278: 4}))
    for mode in ("RGB", "L"):
        assert_pillow_equal(save(Image.fromarray(picture(12, 9, 3)).convert(mode), "TIFF",
                                 compression="jpeg", tiffinfo={266: fill_order}))


@pytest.mark.parametrize("fill_order", [0, 3, 255])
def test_fill_orders_pillow_has_no_mode_for_are_refused(fill_order):
    assert_as_pillow(write_tiff(picture(4, 5, 1), 2, tags={266: (3, [fill_order])}))


ORIENTED = {
    "none": lambda rgb, o: write_tiff(rgb, 2, tags={274: (3, [o])}),
    "LZW strips": lambda rgb, o: write_tiff(rgb, 2, compression="LZW", rows_per_strip=3,
                                            tags={274: (3, [o])}),
    "Deflate tiles": lambda rgb, o: write_tiff(rgb, 2, compression="Deflate", tile=(16, 16),
                                               tags={274: (3, [o])}),
    "PackBits grey": lambda rgb, o: write_tiff(rgb[..., 0], 1, compression="PackBits",
                                               tags={274: (3, [o])}),
    "LZMA": lambda rgb, o: write_tiff(rgb, 2, compression="LZMA", tags={274: (3, [o])}),
    "JPEG": lambda rgb, o: save(Image.fromarray(rgb), "TIFF", compression="jpeg",
                                tiffinfo={274: o}),
    "Group 4": lambda rgb, o: save(Image.fromarray(rgb[..., 0] > 128), "TIFF",
                                   compression="group4", tiffinfo={274: o}),
    "YCbCr LZW": lambda rgb, o: ycbcr_tiff(rgb, (2, 2), "LZW", tags={274: (3, [o])}),
    "YCbCr none": lambda rgb, o: ycbcr_tiff(rgb, (1, 1), "none", tags={274: (3, [o])}),
}


@pytest.mark.parametrize("kind, orientation", [(k, o) for k in ORIENTED for o in range(10)
                                               if 0 < o < 9 or k not in ("JPEG", "Group 4")])
def test_orientations_match_pillow(kind, orientation):
    """TiffImageFile.load_end transposes the image by its orientation
    (ImageOps.exif_transpose) on Pillow's own reader and on libtiff's
    alike; 5-8 swap the sides. 0 and 9 are no orientation (Pillow's
    libtiff writer takes neither)."""
    raw = ORIENTED[kind](picture(9, 13, orientation), orientation)
    assert_pillow_equal(raw)


@pytest.mark.parametrize("entry", [(3, [6, 1]), (4, [8]), (5, [(6, 1)]), (5, [(6, 0)]),
                                   (7, [6]), (1, [6])], ids=str)
def test_orientation_tag_types_match_pillow(entry):
    """The tag's first value counts, of any numeric type (a rational too);
    a BYTE or UNDEFINED field is bytes to Pillow, which no orientation
    equals."""
    kind, vals = entry
    assert_as_pillow(ifd_tiff(13, 9, [picture(9, 13, 4).tobytes()],
                              {258: (3, [8, 8, 8]), 262: (3, [2]), 277: (3, [3]),
                               274: (kind, vals)}))


@pytest.mark.parametrize("xmp", [b'<x tiff:Orientation="6"/>', b"<tiff:Orientation>3</tiff:",
                                 b'tiff:Orientation="8" tiff:Orientation="2"', b"none here"])
@pytest.mark.parametrize("tag", [False, True])
def test_xmp_orientation_matches_pillow(xmp, tag):
    """Without tag 274, Image.getexif takes the XMP packet's first
    tiff:Orientation digit; with it, the tag."""
    tags = {258: (3, [8, 8, 8]), 262: (3, [2]), 277: (3, [3]), 700: (7, list(xmp))}
    if tag:
        tags[274] = (3, [1])
    assert_pillow_equal(ifd_tiff(13, 9, [picture(9, 13, 5).tobytes()], tags))


@pytest.mark.parametrize("kind, value", [(2, b"tiff:Orientation=\"6\""), (2, b"\0"),
                                         (3, [0]), (3, [6])], ids=str)
def test_xmp_packets_pillow_cannot_search_match_pillow(kind, value):
    """A text or numeric XMP packet makes Pillow's search raise, but an empty
    one or a single 0, which it does not search."""
    tags = {258: (3, [8, 8, 8]), 262: (3, [2]), 277: (3, [3]), 700: (kind, list(value))}
    assert_as_pillow(ifd_tiff(13, 9, [picture(9, 13, 6).tobytes()], tags))


@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("sub", [None, (1, 1), (2, 2), (2, 1)], ids=str)
@pytest.mark.parametrize("layout", [dict(rows_per_strip=4), dict(tile=(16, 16))], ids=str)
@pytest.mark.parametrize("compression", ["none", "LZW", "Deflate", "LZMA"])
def test_planar_ycbcr_matches_pillow(compression, layout, sub, predictor):
    """One plane each: compressed, through TIFFRGBAImage's
    putseparate8bitYCbCr11tile (a subsampling other than 1x1, the default
    2x2 too, has no routine: refused as libtiff refuses it); uncompressed,
    Pillow's reader takes the planes as R, G and B."""
    if predictor == 2 and compression == "none":
        return
    ycc = np.asarray(Image.fromarray(picture(13, 10, 5)).convert("YCbCr"))
    assert_as_pillow(write_tiff(ycc, 6, compression=compression, planar=2, predictor=predictor,
                                tags={530: (3, list(sub))} if sub else None, **layout))


@pytest.mark.parametrize("layout", [dict(), dict(rows_per_strip=4), dict(tile=(16, 16))],
                         ids=str)
@pytest.mark.parametrize("width", [9, 10, 12, 17])
@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2), (1, 2), (4, 2), (4, 1), (4, 4)],
                         ids=str)
@pytest.mark.parametrize("compression", ["LZW", "LZMA"])
def test_predicted_ycbcr_matches_pillow(compression, sub, width, layout):
    """The predictor undone as horAcc8 runs (3 bytes apart over rows of
    TIFFScanlineSize, or of the tile width x 3), or not at all where such a
    row is not whole; also without the predictor, 4x4 strips whose row of
    units does not split in 4 (the strip's last bytes stay 0) and 4x4
    tiles cut at the image's right edge (libtiff's put routine steps 10
    bytes over a unit, not 18)."""
    rgb = picture(11, width, width + sub[0])
    for predictor in (1, 2):
        assert_pillow_equal(ycbcr_tiff(rgb, sub, compression, predictor=predictor, **layout))


@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("layout", [(1, 8, 1), (1, 16, 1), (2, 8, 3), (2, 16, 3), (3, 8, 1),
                                    (1, 1, 1), (5, 8, 4), (8, 8, 3), (2, 8, 4)], ids=str)
def test_lzma_tiff_matches_pillow(layout, predictor, planar):
    """LZMA (34925): each strip one .xz stream (Python's lzma, as libtiff's
    codec reads it), with and without the predictor, chunky and planar."""
    if predictor == 2 and layout[1] < 8:
        return
    raw = layout_tiff(*layout, seed=sum(layout), compression="LZMA", predictor=predictor,
                      planar=planar)
    if planar == 2 and layout in ((2, 8, 4), (8, 8, 3)):  # layouts Pillow misreads: refused
        with pytest.raises(NotImplementedError, match="planar configuration 2"):
            decode_image_u8(raw)
    else:
        assert_as_pillow(raw)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(kind=st.sampled_from(EDITS), where=st.floats(0, 1), value=st.integers(0, 2**16))
def test_edited_lzma_strips_decode_as_libtiff_reads_them(kind, where, value):
    """An error once the strip's bytes are all out (a bad check, junk after
    the stream) goes unseen; one before leaves the strip short: refused."""
    raw = layout_tiff(2, 8, 3, seed=9, compression="LZMA")
    assert_as_pillow(edit(raw, kind, where, value, strip_span(raw)))


def xz_streams() -> dict:
    """.xz streams of Python's lzma (the same liblzma as libtiff's codec)
    that reach every part of csrc/image_entropy.cpp `xz_strip`: literals,
    matches and reps under each lc/lp/pb, several LZMA2 chunks (over 2 MiB
    of output, 64 KiB of input), uncompressed chunks (data that does not
    compress), each check kind, and a dictionary of 4 KiB."""
    rng = np.random.default_rng(7)
    runs = (np.arange(300_000) // 7 % 11).astype(np.uint8).tobytes()
    noise = rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes()
    text = b"".join(b"row %d of the strip; " % (i * i % 97) for i in range(4000))
    out = {}
    for name, data in (("runs", runs), ("noise", noise), ("text", text),
                       ("mixed", text[:20_000] + noise[:70_000] + runs[:90_000]),
                       ("one byte", b"\x07"), ("small", text[:300])):
        out[name] = (data, lzma.compress(data, format=lzma.FORMAT_XZ))
    for lc, lp, pb in ((0, 0, 0), (4, 0, 2), (1, 3, 4), (0, 4, 1)):
        f = [{"id": lzma.FILTER_LZMA2, "preset": 1, "lc": lc, "lp": lp, "pb": pb}]
        out[f"lc{lc} lp{lp} pb{pb}"] = (text, lzma.compress(text, lzma.FORMAT_XZ, filters=f))
    for check in (lzma.CHECK_NONE, lzma.CHECK_CRC32, lzma.CHECK_SHA256):
        out[f"check {check}"] = (text[:5000], lzma.compress(text[:5000], lzma.FORMAT_XZ, check))
    f = [{"id": lzma.FILTER_LZMA2, "dict_size": 4096}]
    out["4 KiB dictionary"] = (text, lzma.compress(text, lzma.FORMAT_XZ, filters=f))
    out["two chunks, empty output"] = (b"", lzma.compress(b"", format=lzma.FORMAT_XZ))
    return out


@pytest.mark.parametrize("name", list(xz_streams()))
def test_xz_strip_decodes_every_clean_stream_as_python_lzma(name):
    """The port's LZMA2 decoder against Python's lzma on whole streams: the
    same bytes, and no more than the strip's (a size cut anywhere in)."""
    data, xz_stream = xz_streams()[name]
    assert tiff_mod._unxz(xz_stream, len(data)) == data
    if len(data) > 2:
        cut = len(data) * 2 // 3
        assert tiff_mod._unxz(xz_stream, cut) == data[:cut]


def lzma_ycbcr() -> bytes:
    rgb = np.random.default_rng(1).integers(0, 256, (16, 20, 3)).astype(np.uint8)
    return ycbcr_tiff(rgb, (1, 1), "LZMA")


# edits of an LZMA strip that liblzma finds corrupt after writing some of the strip's bytes:
# libtiff keeps them and TIFFRGBAImage puts the strip; Python's lzma dropped the bytes of the
# call that failed, so the port read them short (found by a fuzz of lzma_ycbcr)
KEPT_BEFORE_ERROR = [("byte", 0.929205516160431, 29348), ("byte", 0.7774686433301689, 37141),
                     ("zero", 0.8964059679926287, 53666), ("flip", 0.8802131913296977, 65181),
                     ("flip", 0.8861147408234264, 21152), ("zero", 0.9675338545077754, 57794),
                     ("flip", 0.6565250824196842, 22296)]


@pytest.mark.parametrize("kind, where, value", KEPT_BEFORE_ERROR, ids=str)
def test_lzma_strips_keep_what_liblzma_wrote_before_its_error(kind, where, value):
    raw = lzma_ycbcr()
    edited = edit(raw, kind, where, value, strip_span(raw))
    assert not isinstance(outcome(edited), Exception)  # Pillow puts the strip
    assert_as_pillow(edited)


def planar_jpeg_tiff(rgb: np.ndarray, sub=(1, 1), rows_per_strip: int = None,
                     quality: int = 90) -> bytes:
    """A JPEG-compressed YCbCr TIFF in planar configuration 2: each strip
    of each plane (Pillow's YCbCr of `rgb`) a one-component JPEG of
    Pillow's encoder; YCbCrSubsampling `sub` (None: no tag, libtiff's 2x2)."""
    h, w = rgb.shape[:2]
    ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr"))
    rps = rows_per_strip or h
    streams = [save(Image.fromarray(np.ascontiguousarray(ycc[y : y + rps, :, c])), "JPEG",
                    quality=quality) for c in range(3) for y in range(0, h, rps)]
    tags = {258: (3, [8, 8, 8]), 259: (3, [7]), 262: (3, [6]), 277: (3, [3]), 284: (3, [2]),
            278: (4, [rps])}
    if sub is not None:
        tags[530] = (3, list(sub))
    return ifd_tiff(w, h, streams, tags)


@pytest.mark.parametrize("sub", [(1, 1), (2, 2), (2, 1), None], ids=str)
@pytest.mark.parametrize("rps", [4, 9, 64])
def test_planar_jpeg_ycbcr_matches_pillow(sub, rps):
    """libtiff takes each plane's one JPEG component as it is (it converts
    colour only in planar configuration 1) and puts the planes through
    TIFFRGBAImage's putseparate8bitYCbCr11tile: 1x1 only, other
    subsamplings refused as libtiff refuses them."""
    assert_as_pillow(planar_jpeg_tiff(picture(19, 23, 3), sub, rps, quality=75))


@settings(max_examples=60, deadline=None, derandomize=True)
@given(kind=st.sampled_from(EDITS), where=st.floats(0, 1), value=st.integers(0, 2**16),
       rps=st.sampled_from([8, 32]))
def test_edited_planar_jpeg_ycbcr_strips_match_pillow(kind, where, value, rps):
    """A plane's strip the codec fails on leaves that plane's buffer as it
    was (stoponerr 0), except the first read: libtiff allocates its
    buffer only after JPEGPreDecode, so a header it fails on there ends the
    decode."""
    raw = planar_jpeg_tiff(picture(20, 28, 5), rows_per_strip=rps)
    edited = edit(raw, kind, where, value, strip_span(raw))
    if not rows_left_unwritten(edited):
        assert_as_pillow(edited)


@pytest.mark.parametrize("extra", [0, 200])
def test_deflate_strips_are_inflated_no_further_than_their_rows(extra):
    """libtiff's ZIPDecode stops once the strip's bytes are out: a stream
    that runs on past them with a broken check decodes (the fuzz of the
    fill-order-2 fixtures found the port inflating the whole stream and
    refusing it); one whose check comes right after the rows is refused,
    as zlib reads the check in the same call."""
    px = picture(6, 10, 3)
    z = zlib.compress(px.tobytes() + bytes(range(extra)), 6)
    raw = ifd_tiff(10, 6, [z[:-1] + bytes([z[-1] ^ 1])],
                   {258: (3, [8, 8, 8]), 259: (3, [8]), 262: (3, [2]), 277: (3, [3])})
    assert_as_pillow(raw)
    assert isinstance(outcome(raw), np.ndarray) == bool(extra)


@pytest.mark.parametrize("photometric", [2, 6])
def test_an_lzw_strip_must_start_with_a_clear_code(photometric):
    """libtiff's LZWDecode refuses a strip whose first code is not a clear
    code: Pillow refuses the image, except through TIFFRGBAImage (YCbCr),
    which puts the strip as the zeroed buffer it left."""
    px = picture(4, 6, 2)
    bits = "".join(f"{b:08b}" for b in tiff_lzw(px.tobytes()))[9:]  # the clear code dropped
    bits += "0" * (-len(bits) % 8)
    data = bytes(int(bits[i : i + 8], 2) for i in range(0, len(bits), 8))
    raw = ifd_tiff(6, 4, [data], {258: (3, [8, 8, 8]), 259: (3, [5]), 262: (3, [photometric]),
                                  277: (3, [3]), 530: (3, [1, 1])})
    assert_as_pillow(raw)
    assert isinstance(outcome(raw), np.ndarray) == (photometric == 6)


BROKEN_YCBCR = {
    "LZW 2x2 strips": lambda rgb: ycbcr_tiff(rgb, (2, 2), "LZW", rows_per_strip=8),
    "Deflate 2x1 predicted": lambda rgb: ycbcr_tiff(rgb, (2, 1), "Deflate", rows_per_strip=4,
                                                    predictor=2),
    "LZW planar": lambda rgb: write_tiff(np.asarray(Image.fromarray(rgb).convert("YCbCr")), 6,
                                         compression="LZW", planar=2, rows_per_strip=8,
                                         tags={530: (3, [1, 1])}),
    "Deflate planar predicted": lambda rgb: write_tiff(
        np.asarray(Image.fromarray(rgb).convert("YCbCr")), 6, compression="Deflate", planar=2,
        predictor=2, rows_per_strip=8, tags={530: (3, [1, 1])}),
}


@settings(max_examples=120, deadline=None, derandomize=True)
@given(kind=st.sampled_from(list(BROKEN_YCBCR)), edit_kind=st.sampled_from(EDITS),
       where=st.floats(0, 1), value=st.integers(0, 2**16))
def test_broken_ycbcr_strips_are_put_as_libtiff_puts_them(kind, edit_kind, where, value):
    """TIFFRGBAImage (stoponerr 0, Pillow's YCbCr path) puts a strip its
    codec fails on from what the codec wrote into a zeroed buffer, the
    predictor not undone (the fuzz of the YCbCr fixtures found the port
    refusing such files)."""
    raw = BROKEN_YCBCR[kind](picture(16, 20, 7))
    assert_as_pillow(edit(raw, edit_kind, where, value, strip_span(raw)))


def test_a_tiff_of_too_many_pixels_is_refused_before_it_is_allocated():
    """Image.open's decompression-bomb check (the fuzz found an edited
    height of 859,266,369 rows, which the port tried to allocate)."""
    raw = write_tiff(picture(4, 5, 1), 2, tags={257: (4, [859266369])})
    with pytest.raises(ValueError, match="decompression bomb"):
        decode_image_u8(raw)
    assert_as_pillow(raw)


# ---- McIdas areas and XV thumbnails ----------------------------------------------------------

@pytest.mark.parametrize("gap", [0, 7])
@pytest.mark.parametrize("prefix", [0, 5])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_mcidas_matches_pillow(depth, prefix, gap):
    """8 bits ("L"), 16 ("I;16B", clipped to 255) and 32 ("I", signed,
    clipped to 0..255), a prefix on each line (w[15]), data after a gap."""
    rng = np.random.default_rng(depth * 10 + prefix + gap)
    lo, hi = {1: (0, 256), 2: (0, 600), 4: (-300, 600)}[depth]
    raw = mcidas_file(rng.integers(lo, hi, (7, 11)), depth, prefix, gap)
    assert_pillow_equal(raw)
    assert image_format(raw) == Image.open(io.BytesIO(raw)).format == "MCIDAS"


def mcidas_with(raw: bytes, word: int, value: int) -> bytes:
    return raw[: 4 * (word - 1)] + struct.pack(">i", value) + raw[4 * word :]


MCIDAS_EDITS = {  # (word, value) of the directory, each as Pillow reads or refuses it
    "depth 3": (11, 3), "no lines": (9, 0), "negative elements": (10, -4), "stride 0": (14, 0),
    "stride short of a row": (15, -3), "negative offset": (34, -300), "offset past the end":
    (34, 10**6), "more lines than data": (9, 40), "two bands' stride": (14, 2)}


@pytest.mark.parametrize("case", list(MCIDAS_EDITS))
def test_mcidas_directories_match_pillow(case):
    raw = mcidas_file(picture(7, 11, 1)[..., 0], 1, prefix=2)
    assert_as_pillow(mcidas_with(raw, *MCIDAS_EDITS[case]))


def test_short_mcidas_directories_pass_on():
    raw = mcidas_file(picture(7, 11, 1)[..., 0])
    for cut in (8, 100, 255):
        assert_as_pillow(raw[:cut])


XV_CASES = {
    "comments": lambda idx: xvthumb_file(idx),
    "no comments": lambda idx: xvthumb_file(idx, ()),
    "words after the size": lambda idx: xvthumb_file(idx)[:-idx.size].replace(
        b" 255\n", b" 255 junk words\n") + idx.tobytes(),
    "a comment line is the last": lambda idx: b"P7 332\n#only\n",
    "an empty size line": lambda idx: b"P7 332\n#c\n\n" + idx.tobytes(),
    "one number": lambda idx: b"P7 332\n9\n" + idx.tobytes(),
    "not numbers": lambda idx: b"P7 332\nab cd\n" + idx.tobytes(),
    "zero width": lambda idx: b"P7 332\n0 6\n" + idx.tobytes(),
    "cut short": lambda idx: xvthumb_file(idx)[:-5],
    "magic's line runs on": lambda idx: xvthumb_file(idx, head=b" XV thumbnail\n"),
}


@pytest.mark.parametrize("case", list(XV_CASES))
def test_xvthumb_matches_pillow(case):
    """P7 332: comments, the size line's first two words, then the 3-3-2
    palette's indices (every one of the 256)."""
    idx = np.arange(6 * 9 * 5, dtype=np.uint8)[: 6 * 9].reshape(6, 9)
    raw = XV_CASES[case](idx)
    assert_as_pillow(raw)
    if case == "comments":
        assert image_format(raw) == Image.open(io.BytesIO(raw)).format == "XVThumb"
        assert_pillow_equal(xvthumb_file(np.arange(256, dtype=np.uint8).reshape(16, 16)))


@settings(max_examples=80, deadline=None, derandomize=True)
@given(kind=st.sampled_from(EDITS), where=st.floats(0, 1), value=st.integers(0, 2**16),
       fmt=st.sampled_from(["mcidas", "xvthumb"]))
def test_edited_mcidas_and_xvthumb_files_match_pillow(kind, where, value, fmt):
    px = picture(6, 9, 7)[..., 0]
    raw = mcidas_file(px, 2, prefix=3) if fmt == "mcidas" else xvthumb_file(px)
    assert_as_pillow(edit(raw, kind, where, value))


# ---- PSD Lab ---------------------------------------------------------------------------------

def lab_planes(h, w, seed) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (3, h, w), np.uint8)


def test_lab_psd_and_cielab_tiff_are_one_conversion_in_pillow():
    """Pillow reads a Lab PSD's planes as its "LAB" bands (a and b with 128
    for 0) and a CIELab TIFF's signed a and b into the same bands: on the
    same Lab data its convert("RGBA") gives the same RGB bytes both ways,
    the ones utils/modes.py `lab_to_rgb` gives. Alpha differs: the
    transform copies the LAB pixel's fourth byte, which the TIFF's chunky
    unpacker sets to 255 and the PSD's plane-by-plane reading leaves 0."""
    from rustic_tpu_torch.utils.modes import lab_to_rgb

    planes = lab_planes(16, 16, 0)
    signed = planes.transpose(1, 2, 0) ^ np.array([0, 128, 128], np.uint8)
    psd_rgba = pillow(write_psd(planes, 9, 8, 0))
    tif_rgba = pillow(save(Image.frombytes("LAB", (16, 16), signed.tobytes()), "TIFF"))
    np.testing.assert_array_equal(psd_rgba[..., :3], tif_rgba[..., :3])
    np.testing.assert_array_equal(psd_rgba[..., :3], lab_to_rgb(signed))
    assert (psd_rgba[..., 3] == 0).all() and (tif_rgba[..., 3] == 255).all()


@pytest.mark.parametrize("size", [(1, 1), (7, 3), (16, 21)], ids=str)
@pytest.mark.parametrize("channels", [3, 4, 5])
@pytest.mark.parametrize("compression", [0, 1])
def test_lab_psd_matches_pillow(compression, channels, size):
    """Raw and PackBits, with extra channels Pillow skips (for PackBits it
    reads the byte counts of its three channels only, as the port does)."""
    planes = lab_planes(*size, channels * 10 + compression)
    planes = np.concatenate([planes, planes[:1].repeat(channels - 3, 0)])
    assert_as_pillow(write_psd(planes, 9, 8, compression))


# ---- the fixtures of tests/data_torch/formats_variants --------------------------------------

def fixture_files() -> dict:
    """name -> (bytes, the decode kind chip_smoke.py times it under)."""
    rgb = picture(48, 64, 40)
    idx = np.asarray(Image.fromarray(rgb).quantize(200))
    pal = np.array(Image.fromarray(rgb).quantize(200).getpalette()[:600], np.uint8).reshape(-1, 3)
    idx16 = np.asarray(Image.fromarray(rgb).quantize(16))
    pal16 = np.array(Image.fromarray(rgb).quantize(16).getpalette()[:48], np.uint8).reshape(-1, 3)
    bits = np.asarray(Image.fromarray(rgb).convert("1"))
    rgb16 = ((rgb[..., 0].astype(np.uint16) >> 3) << 10 | (rgb[..., 1].astype(np.uint16) >> 3)
             << 5 | rgb[..., 2].astype(np.uint16) >> 3)
    lab = Image.frombytes("LAB", (64, 48), np.dstack([  # L, and a and b as signed bytes
        rgb.mean(-1), (rgb[..., 0].astype(int) - rgb[..., 1]) // 2 & 255,
        (rgb[..., 1].astype(int) - rgb[..., 2]) // 2 & 255]).astype(np.uint8).tobytes())
    return {
        "bmp-rle8.bmp": (rle_bmp(idx, pal), "bmp rle"),
        "bmp-rle8-topdown.bmp": (rle_bmp(idx[:24], pal, top_down=True), "bmp rle"),
        "bmp-rle4.bmp": (rle_bmp(idx16, pal16, rle4=True), "bmp rle"),
        "bmp-16-555.bmp": (bmp16(rgb16), "bmp 16-bit"),
        "bmp-16-565.bmp": (bmp16(rgb16 | (rgb16 & 0x3E0) << 1 & 0xFFC0 | rgb16 & 0x1F,
                                 (0xF800, 0x7E0, 0x1F)), "bmp 16-bit"),
        "bmp-os2.bmp": (os2_bmp(idx, 8, pal), "bmp os/2"),
        "tga-16.tga": (tga16(rgb16 | 0x8000 * (rgb[..., 0] > 128)), "tga 16-bit"),
        "tga-16-rle.tga": (tga16(np.repeat(rgb16[:, ::4], 4, 1), rle=True, flags=0x00),
                           "tga 16-bit"),
        "tiff-ccitt-rle.tif": (fax_tiff(bits, "CCITT RLE"), "tiff fax"),
        "tiff-g3-1d.tif": (fax_tiff(bits, "Group 3", rows_per_strip=16), "tiff fax"),
        "tiff-g3-2d.tif": (fax_tiff(bits, "Group 3", t4=5, photometric=0), "tiff fax"),
        "tiff-g4.tif": (fax_tiff(bits, "Group 4", rows_per_strip=20), "tiff fax"),
        "tiff-jpeg-rgb.tif": (save(Image.fromarray(rgb), "TIFF", compression="jpeg"),
                              "tiff jpeg"),
        "tiff-jpeg-l.tif": (save(Image.fromarray(rgb).convert("L"), "TIFF", compression="jpeg"),
                            "tiff jpeg"),
        "tiff-jpeg-cmyk.tif": (save(Image.fromarray(rgb).convert("CMYK"), "TIFF",
                                    compression="jpeg"), "tiff jpeg"),
        "tiff-jpeg-ycbcr22-strips.tif": (jpeg_tiff(rgb, rows_per_strip=16), "tiff jpeg"),
        "tiff-jpeg-ycbcr22-tiles.tif": (jpeg_tiff(rgb, tile=(32, 32), quality=70), "tiff jpeg"),
        "tiff-ycbcr-lzw-22.tif": (ycbcr_tiff(rgb, (2, 2), "LZW", rows_per_strip=16),
                                  "tiff ycbcr"),
        "tiff-ycbcr-deflate-21.tif": (ycbcr_tiff(rgb, (2, 1), "Deflate", refbw=REFBW_VIDEO),
                                      "tiff ycbcr"),
        "tiff-ycbcr-lzw-11.tif": (ycbcr_tiff(rgb, (1, 1), "LZW", tile=(32, 16),
                                             coefs=COEFS_709), "tiff ycbcr"),
        "tiff-ycbcr-none-11.tif": (ycbcr_tiff(rgb[:8, :8], (1, 1), "none"), "tiff ycbcr"),
        "tiff-cmyk-lzw.tif": (save(Image.fromarray(rgb).convert("CMYK"), "TIFF",
                                   compression="tiff_lzw"), "tiff cmyk"),
        "tiff-lab.tif": (save(lab, "TIFF"), "tiff cielab"),
        "tiff-lab-lzw.tif": (save(lab, "TIFF", compression="tiff_lzw"),
                                 "tiff cielab"),
        "webp-anim-lossy-offset.webp": (anim_webp((64, 48), [(8, 6, still("lossy", 30, 40, 41),
                                                                 0), (0, 0, still("lossy", 8, 8, 42),
                                                                      0)], False),
                                        "webp animated"),
        "webp-anim-lossless-alpha.webp": (anim_webp((64, 48), [(2, 4, still("lossless", 40, 60,
                                                                            43), 2)], True),
                                          "webp animated"),
        **later_fixture_files(rgb),
        **repaired_fixture_files(rgb),
    }


def lzma_kept_tiff(rgb: np.ndarray, rows_per_strip: int = None, predictor: int = 1,
                   at: float = 0.125) -> bytes:
    """An LZMA YCbCr TIFF (4:2:0) whose last strip has one bit flipped at
    `at` of its data: liblzma stops after writing part of the strip, which
    libtiff keeps and TIFFRGBAImage puts."""
    raw = bytearray(ycbcr_tiff(rgb, (2, 2), "LZMA", rows_per_strip=rows_per_strip,
                               predictor=predictor))
    tags = Image.open(io.BytesIO(bytes(raw))).tag_v2
    off, count = tags[273][-1], tags[279][-1]
    raw[off + int(count * at)] ^= 1
    return bytes(raw)


def repaired_fixture_files(rgb: np.ndarray) -> dict:
    """The kinds the port read after: JPEG-compressed YCbCr TIFF in planar
    configuration 2, LZMA strips liblzma stops in, IPTC records holding
    files of the formats once refused inside them, APNG frame 0 (of the
    picture's top-left 24 x 32)."""
    from tests.test_torch_formats import apng_file, apng_region
    from tests.test_torch_image_formats_legacy import iptc_inside_files

    rgb = rgb[:24, :32]
    inside = iptc_inside_files()
    planar, kept = "tiff jpeg ycbcr planar", "tiff lzma kept"
    return {
        "tiff-jpeg-ycbcr-planar.tif": (planar_jpeg_tiff(rgb, rows_per_strip=8), planar),
        "tiff-jpeg-ycbcr-planar-one-strip.tif": (planar_jpeg_tiff(rgb, quality=60), planar),
        "tiff-lzma-kept.tif": (edit(lzma_ycbcr(), *KEPT_BEFORE_ERROR[0], strip_span(lzma_ycbcr())),
                               kept),
        "tiff-lzma-kept-flip.tif": (edit(lzma_ycbcr(), *KEPT_BEFORE_ERROR[3],
                                         strip_span(lzma_ycbcr())), kept),
        "iptc-tiff-p-band.iim": (iptc_file(inside["TIFF P"], (13, 9), 3, 1, band=1, compression=5),
                              "iptc once refused"),
        "iptc-psd-cmyk.iim": (iptc_file(inside["PSD CMYK"], (13, 9), compression=5),
                              "iptc once refused"),
        "iptc-xpm-none.iim": (iptc_file(inside["XPM with an unused None"], (13, 9),
                                        compression=5),
                              "iptc once refused"),
        "iptc-mcidas-16-band.iim": (iptc_file(inside["MCIDAS 16"], (13, 9), 3, 1, band=1,
                                              compression=5), "iptc once refused"),
        "apng-frame0-region.png": (apng_region("P", (2,)), "apng"),
        "apng-default-image.png": (apng_file("RGBA", True, 2, 1), "apng"),
        "apng-dispose-blend.png": (apng_file("RGB", False, 1, 1), "apng"),
    }


def later_fixture_files(rgb: np.ndarray) -> dict:
    """The kinds the port read next (name -> (bytes, kind)): TIFF in fill
    order 2 and orientations 2-8, YCbCr planar and predicted, LZMA;
    McIdas areas at 8, 16 and 32 bits, an XV thumbnail, Lab PSDs, IPTC
    records holding PNGs, XPMs of long keys; of the picture's top-left
    24 x 32 (40 wide for the 4x4 tiles, two across)."""
    wide, rgb = rgb[:24, :40], rgb[:24, :32]
    img = Image.fromarray(rgb)
    grey = np.asarray(img.convert("L"))
    bits = np.asarray(img.convert("1"))
    ycc = np.asarray(img.convert("YCbCr"))
    lab = np.stack([grey, rgb[..., 0] // 2 + 64, rgb[..., 2] // 2 + 64]).astype(np.uint8)
    idx16 = np.asarray(img.quantize(16))
    pal16 = np.array(img.quantize(16).getpalette()[:48], np.uint16).reshape(-1, 3) * 257
    cmap16 = list(pal16.T.reshape(-1)) + [0] * (3 * 16 - pal16.size)
    fill, orient = "tiff fill order 2", "tiff orientation"
    return {
        "tiff-fill2-g4.tif": (save(img.convert("1"), "TIFF", compression="group4",
                                   tiffinfo={266: 2, 278: 8}), fill),
        "tiff-fill2-g3-2d.tif": (save(img.convert("1"), "TIFF", compression="group3",
                                      tiffinfo={266: 2, 292: 5}), fill),
        "tiff-fill2-rgb-lzw-pred.tif": (write_tiff(rgb, 2, compression="LZW", predictor=2,
                                                   rows_per_strip=8, fill_order=2), fill),
        "tiff-fill2-l-none.tif": (write_tiff(grey, 1, fill_order=2, rows_per_strip=10),
                                  fill),
        "tiff-fill2-p4-packbits.tif": (write_tiff(idx16, 3, 4, compression="PackBits",
                                                  colour_map=cmap16, fill_order=2), fill),
        "tiff-fill2-1-none.tif": (write_tiff(bits.astype(np.uint8), 0, 1, fill_order=2,
                                             tile=(16, 16)), fill),
        "tiff-fill2-16-deflate.tif": (write_tiff(grey.astype(np.uint16) * 3 // 2, 1, 16,
                                                 compression="Deflate", fill_order=2),
                                      fill),
        "tiff-orient-2-none.tif": (write_tiff(rgb, 2, tags={274: (3, [2])}), orient),
        "tiff-orient-3-lzw.tif": (write_tiff(rgb, 2, compression="LZW", rows_per_strip=8,
                                             tags={274: (3, [3])}), orient),
        "tiff-orient-4-packbits.tif": (write_tiff(grey, 1, compression="PackBits",
                                                  tags={274: (3, [4])}), orient),
        "tiff-orient-5-deflate-tiles.tif": (write_tiff(rgb, 2, compression="Deflate",
                                                       tile=(16, 16), tags={274: (3, [5])}),
                                            orient),
        "tiff-orient-6-jpeg.tif": (save(img, "TIFF", compression="jpeg", tiffinfo={274: 6}),
                                   orient),
        "tiff-orient-7-g4.tif": (save(img.convert("1"), "TIFF", compression="group4",
                                      tiffinfo={274: 7}), orient),
        "tiff-orient-8-ycbcr-lzw.tif": (ycbcr_tiff(rgb, (2, 2), "LZW", rows_per_strip=8,
                                                   tags={274: (3, [8])}), orient),
        "tiff-orient-xmp-6.tif": (write_tiff(rgb, 2, tags={700: (7, list(
            b'<x:xmpmeta><rdf:Description tiff:Orientation="6"/></x:xmpmeta>'))}), orient),
        "tiff-ycbcr-planar-lzw.tif": (write_tiff(ycc, 6, compression="LZW", planar=2,
                                                 rows_per_strip=8, tags={530: (3, [1, 1])}),
                                      "tiff ycbcr planar"),
        "tiff-ycbcr-planar-deflate-pred.tif": (write_tiff(ycc, 6, compression="Deflate",
                                                          planar=2, predictor=2, tile=(16, 16),
                                                          tags={530: (3, [1, 1])}),
                                               "tiff ycbcr planar"),
        "tiff-ycbcr-planar-none.tif": (write_tiff(ycc, 6, planar=2), "tiff ycbcr planar"),
        "tiff-ycbcr-pred-lzw-22.tif": (ycbcr_tiff(rgb, (2, 2), "LZW", rows_per_strip=8,
                                                  predictor=2), "tiff ycbcr predicted"),
        "tiff-ycbcr-pred-deflate-21.tif": (ycbcr_tiff(rgb, (2, 1), "Deflate", predictor=2),
                                           "tiff ycbcr predicted"),
        "tiff-ycbcr-pred-lzma-44-tiles.tif": (ycbcr_tiff(wide, (4, 4), "LZMA",
                                                         tile=(32, 32), predictor=2),
                                              "tiff ycbcr predicted"),
        "tiff-lzma-rgb.tif": (write_tiff(rgb, 2, compression="LZMA", rows_per_strip=8),
                              "tiff lzma"),
        "tiff-lzma-rgba-pred.tif": (write_tiff(np.dstack([rgb, grey]), 2, compression="LZMA",
                                               predictor=2, extra=(2,), tile=(16, 16)),
                                    "tiff lzma"),
        "tiff-lzma-cmyk-planar.tif": (write_tiff(np.asarray(img.convert("CMYK")), 5,
                                                 compression="LZMA", planar=2),
                                      "tiff lzma"),
        "mcidas-8.area": (mcidas_file(grey, 1), "mcidas"),
        "mcidas-16-prefix.area": (mcidas_file(grey.astype(np.uint16) * 5 // 4, 2, prefix=6,
                                              gap=10), "mcidas"),
        "mcidas-32.area": (mcidas_file(grey.astype(np.int32) * 3 - 200, 4), "mcidas"),
        "xvthumb.xv": (xvthumb_file(rgb332(img)), "xvthumb"),
        "psd-lab.psd": (write_psd(lab, 9, 8, 0), "psd lab"),
        "psd-lab-packbits-alpha.psd": (write_psd(np.concatenate([lab, grey[None]]), 9, 8, 1),
                                       "psd lab"),
        "iptc-png.iim": (iptc_file(save(img, "PNG"), (32, 24), compression=5), "iptc png"),
        "iptc-png-palette-trns.iim": (iptc_file(save(img.quantize(32), "PNG", transparency=5),
                                                (32, 24), compression=5), "iptc png"),
        "iptc-png-grey-band.iim": (iptc_file(save(img.convert("L"), "PNG"), (32, 24), 3, 1,
                                             band=2, compression=5), "iptc png"),
        "xpm-keys-8.xpm": (long_key_xpm(img, 64, 8), "xpm long keys"),
        "xpm-keys-11-rgb.xpm": (long_key_xpm(img.resize((16, 12)), 300, 11), "xpm long keys"),
    }


def make_variant_fixtures(out_dir: str) -> dict:
    """Write the fixtures and their manifest (each entry its Pillow format
    and the decode kind chip_smoke.py times it under) into `out_dir` ->
    the manifest."""
    os.makedirs(out_dir, exist_ok=True)
    images = []
    for name, (raw, kind) in fixture_files().items():
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(raw)
        expect = name.rsplit(".", 1)[0] + ".rgba.npy"
        np.save(os.path.join(out_dir, expect), pillow(raw))
        images.append(dict(file=name, format=Image.open(io.BytesIO(raw)).format, kind=kind,
                           expect=expect))
    manifest = dict(images=images)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    return manifest


def variant_manifest() -> dict:
    with open(os.path.join(VARIANT_FIXTURES, "manifest.json")) as f:
        return json.load(f)


def variant_fixture(name: str) -> bytes:
    with open(os.path.join(VARIANT_FIXTURES, name), "rb") as f:
        return f.read()


def test_variant_fixture_writer_makes_the_committed_set(tmp_path):
    """make_variant_fixtures runs, and writes the committed files' names,
    expectations and bytes (within 1 MiB)."""
    made = make_variant_fixtures(str(tmp_path))
    assert made == variant_manifest()
    for name in os.listdir(tmp_path):
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tmp_path / name),
                                          np.load(os.path.join(VARIANT_FIXTURES, name)))
        else:
            assert (tmp_path / name).read_bytes() == variant_fixture(name), name
    total = sum(os.path.getsize(os.path.join(VARIANT_FIXTURES, n))
                for n in os.listdir(VARIANT_FIXTURES))
    assert total <= 2**20


MANIFEST = variant_manifest()["images"] if os.path.exists(
    os.path.join(VARIANT_FIXTURES, "manifest.json")) else []


@pytest.mark.parametrize("entry", MANIFEST, ids=lambda e: e["file"])
def test_committed_variant_fixture_matches_pillow(entry):
    """Each committed expectation is Pillow's decode of the committed file,
    its format Pillow's, and the port's decode and format equal them."""
    raw = variant_fixture(entry["file"])
    want = pillow(raw)
    np.testing.assert_array_equal(np.load(os.path.join(VARIANT_FIXTURES, entry["expect"])), want)
    assert Image.open(io.BytesIO(raw)).format == entry["format"] == image_format(
        raw, entry["file"])
    np.testing.assert_array_equal(decode_image_u8(raw, entry["file"]), want)
    assert max(want.shape[:2]) <= 64


FUZZED = ("bmp-rle8.bmp", "bmp-rle4.bmp", "tiff-ccitt-rle.tif", "tiff-g3-1d.tif",
          "tiff-g3-2d.tif", "tiff-g4.tif", "tiff-jpeg-ycbcr22-strips.tif",
          "tiff-jpeg-ycbcr22-tiles.tif", "tiff-jpeg-rgb.tif")


def data_span(name: str, raw: bytes):
    """Where a fixture's coded data lies: a BMP's rows, a TIFF's first strip
    or tile (edits elsewhere test the headers the older suites test)."""
    if name.endswith(".bmp"):
        off = struct.unpack_from("<I", raw, 10)[0]
        return off, len(raw) - off
    tags = Image.open(io.BytesIO(raw)).tag_v2
    offs, counts = tags.get(273) or tags.get(324), tags.get(279) or tags.get(325)
    return offs[0], counts[0]


def fuzz_case(name: str, kind: str, where: float, value: int):
    """One edit of a fuzzed fixture -> (Pillow's outcome, the port's), or
    None where libtiff leaves rows unwritten (`rows_left_unwritten`)."""
    raw = variant_fixture(name)
    edited = edit(raw, kind, where, value, data_span(name, raw))
    if name.startswith("tiff-") and rows_left_unwritten(edited):
        return None
    return outcome(edited, name), port_outcome(edited, name)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(name=st.sampled_from(FUZZED), kind=st.sampled_from(EDITS), where=st.floats(0, 1),
       value=st.integers(0, 2**16))
def test_edited_fixtures_decode_as_pillow_decodes_them(name, kind, where, value):
    got = fuzz_case(name, kind, where, value)
    if got is not None:
        assert same(*got), (name, kind, where, value)


def fuzz(n: int, seed: int = 0) -> dict:
    """`n` random edits (each of EDITS' kinds) of every FUZZED fixture,
    each decoded by the port and by Pillow -> counts of (kind, outcome);
    raises AssertionError at the first edit on which they disagree. Edits
    that leave libtiff's rows unwritten are counted apart."""
    rng = np.random.default_rng(seed)
    counts = {}
    for name in FUZZED:
        for _ in range(n):
            kind = str(rng.choice(EDITS))
            where, value = float(rng.random()), int(rng.integers(0, 2**16))
            got = fuzz_case(name, kind, where, value)
            if got is None:
                key = f"{kind}: rows libtiff leaves unwritten"
            else:
                want, port = got
                if not same(want, port):
                    raise AssertionError(f"{name} {kind} at {where} ({value}): Pillow "
                                         f"{type(want).__name__}, port {type(port).__name__}")
                key = f"{kind}: {'refused' if isinstance(want, Exception) else 'decoded'}"
            counts[key] = counts.get(key, 0) + 1
    return counts


def edit_fuzz(fixtures, n: int, seed: int = 0) -> dict:
    """`n` random edits (EDITS' kinds, anywhere after the first 4 bytes) of
    each (name, bytes) in `fixtures`, each decoded by Pillow and by the
    port (given the name, as TGA needs) -> counts of (kind, outcome);
    raises AssertionError at the first edit they disagree on."""
    rng = np.random.default_rng(seed)
    counts = {}
    for name, raw in fixtures:
        for _ in range(n):
            kind = str(rng.choice(EDITS))
            where, value = float(rng.random()), int(rng.integers(0, 2**16))
            edited = edit(raw, kind, where, value)
            want, got = outcome(edited), port_outcome(edited, name)
            if not same(want, got):
                raise AssertionError(f"{name} {kind} at {where} ({value}): Pillow "
                                     f"{type(want).__name__}, port {type(got).__name__}")
            key = f"{kind}: {'refused' if isinstance(want, Exception) else 'decoded'}"
            counts[key] = counts.get(key, 0) + 1
    return counts


def time_kinds(turns: int = 5) -> dict:
    """This host's decode of each formats_variants kind in turns with the
    committed 1024x1024 Huffman photo, as chip_smoke.py's phase 34 times
    it on the card's host: kind -> (ms per megapixel of the kind's files,
    the photo's, their ratio), best of `turns` each."""
    import time

    with open(os.path.join(os.path.dirname(VARIANT_FIXTURES), "formats",
                           "photo-1024-420.jpg"), "rb") as f:
        photo = f.read()
    by_kind = {}
    for entry in variant_manifest()["images"]:
        by_kind.setdefault(entry["kind"], []).append((entry["file"],
                                                      variant_fixture(entry["file"])))
    out = {}
    for kind, files in by_kind.items():
        best_kind = best_photo = float("inf")
        for _ in range(turns):
            t0 = time.perf_counter()
            px = sum(np.prod(decode_image_u8(raw, name).shape[:2]) for name, raw in files)
            best_kind = min(best_kind, time.perf_counter() - t0)
            t0 = time.perf_counter()
            decode_image_u8(photo, "photo-1024-420.jpg")
            best_photo = min(best_photo, time.perf_counter() - t0)
        ms, photo_ms = best_kind * 1e3 / (px / 1e6), best_photo * 1e3 / (1024 * 1024 / 1e6)
        out[kind] = (round(ms, 1), round(photo_ms, 1), round(ms / photo_ms, 2))
    return out


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--fuzz"]:  # --fuzz N [SEED]: edits of each fuzzed fixture
        print(json.dumps(fuzz(int(sys.argv[2]), int(sys.argv[3]) if sys.argv[3:] else 0)))
    elif sys.argv[1:2] == ["--time"]:  # each kind's ms per megapixel on this host
        print(json.dumps(time_kinds(), indent=1))
    else:
        print(json.dumps(make_variant_fixtures(VARIANT_FIXTURES), indent=1))
