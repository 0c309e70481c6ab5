"""The port's decoders of the classic formats against Pillow 12.1.0, and
its identification of a file's format against Pillow's `Image.open`.

PNM / PFM (rustic_tpu_torch/utils/pnm.py), QOI (qoi.py), ICO and CUR
(ico.py), PCX and DCX (pcx.py), SGI (sgi.py) and the bare DIB (the DIB
core of bmp_tga.py): files Pillow writes in every mode it writes, files
this suite's writers (tests/test_torch_image_formats.py: `pnm`, `pfm`,
`dib_of`, `icon_dib`, `icon_file`, `pcx_file`, `dcx_file`, `sgi_file`)
build for what Pillow does not write, and random streams under hypothesis:
`decode_image_u8` must give Pillow's `np.asarray(Image.open(...).convert(
"RGBA"))` bit for bit, and raise (ValueError or NotImplementedError)
exactly where Pillow raises. Every variant Pillow refuses raises
NotImplementedError naming it and FORMATS_TODO; the BMP variants the port
once refused (RLE, 16-bit, OS/2 headers in DIB, ICO and CUR) decode as
Pillow's.

`image_format` must name the format Pillow's `Image.open(...).format`
names, on every committed fixture of tests/data_torch/formats,
formats_dds_psd and formats_classic and on crafted collisions: TGA files
whose first bytes pass CUR's, PCX's or DIB's test, read under their .tga
name (Pillow tries those plugins first), each decoded as Pillow decodes it
or refused where Pillow refuses it. The fixtures of formats_classic are
written by `make_classic_fixtures` (`python -m tests.test_torch_image_formats`).
`python -m tests.test_torch_image_formats_classic --fuzz N SEED` runs N byte
edits of each of them against Pillow (the suite keeps a fixed 4 x 5 each,
and the edits the fuzz found faults with: an ICO's PNG).
"""

import io
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, ImageFile

from rustic_tpu_torch.utils import pnm as pnm_mod
from rustic_tpu_torch.utils.png import PILLOW_ORDER, decode_image_u8, image_format
from tests.test_torch_image_formats import (BT_CLASSIC, BT_CLASSIC_TWIN, CLASSIC_FIXTURES,
                                            CLASSIC_MIMES, CLASSIC_TEXTURES, DDS_PSD_FIXTURES,
                                            FIXTURES, dcx_file, dib_of, glb_images, icon_dib,
                                            icon_file, make_classic_fixtures, pcx_file,
                                            pcx_header, pfm, pillow, pillow_modes, pnm, read_glb,
                                            rgba, save, sgi_file, sgi_rle_row)

FAST = settings(max_examples=60, deadline=None, derandomize=True)


def pillow_open(raw: bytes):
    """-> (Pillow's format name or None where Image.open refuses the file,
    its RGBA decode or the exception that refused it)."""
    try:
        im = Image.open(io.BytesIO(raw))
    except Exception as e:  # noqa: BLE001 - any refusal of Pillow's
        return None, e
    try:
        return im.format, np.asarray(im.convert("RGBA"))
    except Exception as e:  # noqa: BLE001
        return im.format, e


def assert_as_pillow(raw: bytes, name: str = ""):
    """The port names the format Pillow's Image.open names (or raises
    where it refuses the file) and decodes it bit for bit, or raises
    ValueError / NotImplementedError where Pillow's open or load raises."""
    fmt, want = pillow_open(raw)
    if fmt is None:
        with pytest.raises((ValueError, NotImplementedError)):
            image_format(raw, name)
    else:
        assert image_format(raw, name) == fmt
    if not isinstance(want, np.ndarray):
        with pytest.raises((ValueError, NotImplementedError)):
            decode_image_u8(raw, name)
        return
    got = decode_image_u8(raw, name)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def assert_pillow_reads(raw: bytes, fmt: str, name: str = ""):
    """Pillow reads the file as `fmt` (the case reaches its variant), and
    the port equals it."""
    got_fmt, want = pillow_open(raw)
    assert got_fmt == fmt and isinstance(want, np.ndarray)
    assert_as_pillow(raw, name)


def refused_by_pillow(raw: bytes) -> bool:
    return not isinstance(pillow_open(raw)[1], np.ndarray)


# ---- identification --------------------------------------------------------------------------

def test_pillow_order_is_pillows():
    """The order `Image.open` tries in a fresh interpreter: the plugins
    `preinit` registers, then the rest as `init` registers them (Image.ID
    depends on which were imported first: measured in a process of its
    own)."""
    out = subprocess.run([sys.executable, "-c", "from PIL import Image; Image.preinit(); "
                          "Image.init(); print(' '.join(Image.ID))"], capture_output=True,
                         text=True, check=True)
    assert tuple(out.stdout.split()) == PILLOW_ORDER


def fixture_entries():
    for folder in (FIXTURES, DDS_PSD_FIXTURES, CLASSIC_FIXTURES):
        with open(os.path.join(folder, "manifest.json")) as f:
            for entry in json.load(f)["images"]:
                yield folder, entry["file"]


@pytest.mark.parametrize("folder, name", list(fixture_entries()),
                         ids=lambda v: os.path.basename(v))
def test_image_format_of_every_fixture_is_pillows(folder, name):
    with open(os.path.join(folder, name), "rb") as f:
        raw = f.read()
    assert image_format(raw, name) == Image.open(io.BytesIO(raw)).format


TGA_KINDS = [(mode, kw) for mode in ("1", "L", "LA", "P", "RGB", "RGBA")
             for kw in ({}, {"compression": "tga_rle"}, {"orientation": 1},
                        {"id_section": b"0123456789"},
                        {"id_section": b"0123456789", "compression": "tga_rle"})]


@pytest.mark.parametrize("mode, kw", TGA_KINDS, ids=lambda v: str(v))
def test_tga_collisions_are_read_in_pillows_order(mode, kw):
    """Every TGA kind Pillow writes: an uncompressed true-colour or grey
    one starts with CUR's magic (CUR finds no cursors and passes it on);
    one with a 10-byte ID field passes PCX's test, and Pillow's PCX reader
    then refuses it ("unknown PCX mode") or passes it on."""
    px = pillow_modes(5, 7, seed=11)
    raw = save(px[mode], "TGA", **kw)
    assert_as_pillow(raw, "texture.tga")
    if mode in ("L", "RGB", "RGBA") and not kw:
        assert raw[:4] == b"\0\0\2\0" or raw[:4] == b"\0\0\3\0"
    if "id_section" in kw:
        assert raw[0] == 10


def test_tga_whose_first_word_is_40_is_read_as_pillow_reads_it():
    """A TGA with a 40-byte ID field and no map passes DIB's test (the
    word 40, 0, 0, 0): Pillow reads its bytes as a bitmap header (a
    5-bit DIB here: refused by both), or as a DIB where they make one."""
    head = bytes([40, 0, 0, 0]) + bytes(8) + struct.pack("<HHBB", 6, 5, 24, 0x20)
    raw = head + bytes(40) + bytes(90)
    assert_as_pillow(raw, "texture.tga")
    dib = dib_of(rgba(5, 6, 12)[..., :3], 24)
    assert dib[:4] == b"\x28\0\0\0"
    assert_pillow_reads(dib, "DIB", "texture.tga")


def test_unknown_and_passed_on_files_name_what_passed_them_on():
    """A TGA without its name (the one divergence kept: Pillow tries TGA's
    reader on any file, the port only on a TGA's name): the port raises
    naming CUR, which passed it on; a QOI of size zero, which Pillow
    passes on too."""
    raw = save(pillow_modes(2, 2)["RGB"], "TGA")
    with pytest.raises(NotImplementedError, match="unknown format.*CUR: no cursors.*ROADMAP"):
        decode_image_u8(raw, "")
    assert pillow_open(raw)[0] == "TGA"
    assert image_format(raw, "x.tga") == "TGA"
    qoi_zero = b"qoif" + struct.pack(">IIBB", 0, 4, 4, 0)
    with pytest.raises(NotImplementedError, match="QOI of size 0x4"):
        image_format(qoi_zero)
    assert pillow_open(qoi_zero)[0] is None


# ---- what Pillow writes ----------------------------------------------------------------------

SIZES = [(1, 1), (5, 7), (8, 3), (17, 33)]
PILLOW_WRITES = {
    "PPM": ["1", "L", "I;16", "I", "RGB", "RGBA", "F"],
    "QOI": ["RGB", "RGBA"],
    "PCX": ["1", "L", "P", "RGB"],
    "SGI": ["L", "RGB", "RGBA"],
    "DIB": ["1", "L", "P", "RGB", "RGBA"],
}


def pillow_image(mode: str, h: int, w: int, seed: int = 0) -> Image.Image:
    if mode in ("I;16", "I", "F"):
        v = np.random.default_rng(seed).integers(0, 70000, (h, w))
        return Image.fromarray({"I;16": v.astype(np.uint16) // 2, "I": v.astype(np.int32),
                                "F": (v / 200.0 - 20).astype(np.float32)}[mode])
    return pillow_modes(h, w, seed)[mode]


@pytest.mark.parametrize("fmt, mode, size", [(f, m, s) for f, modes in PILLOW_WRITES.items()
                                             for m in modes for s in SIZES],
                         ids=lambda v: str(v))
def test_pillow_written_files_match_pillow(fmt, mode, size):
    raw = save(pillow_image(mode, *size, seed=size[0]), fmt)
    assert_as_pillow(raw)


@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_pillow_sgi_16_bits(mode, bpc):
    assert_pillow_reads(save(pillow_image(mode, 9, 13, 3), "SGI", bpc=bpc), "SGI")


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
@pytest.mark.parametrize("bmp", [False, True])
def test_pillow_ico_each_payload(mode, bmp):
    """Pillow's ICO of several sizes (the largest is read), PNG payloads or
    BMP ones (`bitmap_format="bmp"`: a DIB and its AND mask, 32 bits with
    alpha for RGBA)."""
    img = pillow_image(mode, 40, 40, 5)
    kw = dict(bitmap_format="bmp") if bmp else {}
    assert_pillow_reads(save(img, "ICO", sizes=[(16, 16), (32, 32), (40, 40)], **kw), "ICO")


# ---- what this suite writes ------------------------------------------------------------------

def picture_u16(h, w, maxval, seed=0):
    return (np.random.default_rng(seed).integers(0, maxval + 1, (h, w, 3))).astype(np.int64)


PNM_CASES = {}
for magic in (b"P2", b"P3", b"P5", b"P6"):
    for maxval in (1, 2, 7, 100, 254, 255, 256, 1000, 4095, 65534, 65535):
        PNM_CASES[f"{magic.decode()} maxval {maxval}"] = (
            lambda magic=magic, maxval=maxval: pnm(
                picture_u16(6, 9, maxval, maxval)[..., : 3 if magic in (b"P3", b"P6") else 1]
                .squeeze(-1) if magic in (b"P2", b"P5") else picture_u16(6, 9, maxval, maxval),
                magic, maxval))
for magic, n in ((b"P0CMYK", 4), (b"PyP", 1), (b"PyRGBA", 4), (b"PyCMYK", 4)):
    for maxval in (255, 15, 3000):
        PNM_CASES[f"{magic.decode()} maxval {maxval}"] = (
            lambda magic=magic, n=n, maxval=maxval: pnm(
                np.random.default_rng(n).integers(0, maxval + 1, (5, 6, n)).squeeze(), magic,
                maxval))
PNM_CASES.update({
    "P1 plain, comments and no separators": lambda: b"P1\n# c\n4 2\n1010\n01#x\n01",
    "P1 plain, rows across lines": lambda: pnm(np.eye(5, 7, dtype=bool), b"P1", comment=b"#\r"),
    "P2 plain, comment inside a token": lambda: b"P2 3 1 2#c\n55 0 1 255",
    "P3 plain, tabs and vertical tabs": lambda: pnm(picture_u16(3, 4, 9), b"P3", 9,
                                                    sep=b"\t\x0b\x0c"),
    "P4 odd width": lambda: pnm(np.random.default_rng(2).random((5, 11)) < 0.5, b"P4"),
    "P6 header comments": lambda: pnm(picture_u16(4, 5, 255), b"P6", comment=b"# a # b\r\n"),
    "P5 16-bit, maxval 65535": lambda: pnm(picture_u16(4, 5, 65535)[..., 0], b"P5", 65535),
    "P5 trailing bytes": lambda: pnm(picture_u16(4, 5, 255)[..., 0], b"P5") + b"junk",
    "Pf little-endian": lambda: pfm(np.random.default_rng(3).normal(100, 120, (5, 6))
                                    .astype(np.float32), -1.0),
    "Pf big-endian, scale 2": lambda: pfm(np.random.default_rng(4).normal(100, 120, (5, 6))
                                          .astype(np.float32), 2.0),
    "Pf specials": lambda: pfm(np.array([[np.nan, np.inf, -np.inf, 0.5, 254.99, 255.5, -0.0,
                                           1e30, -1e30, 2**31]], np.float32)),
})


@pytest.mark.parametrize("case", list(PNM_CASES))
def test_pnm_matches_pillow(case):
    assert_pillow_reads(PNM_CASES[case](), "PPM")


def ico_cases():
    rng = np.random.default_rng(21)
    px = rgba(9, 13, 21)
    pal = rng.integers(0, 256, (256, 3), np.uint8)
    mask = rng.random((9, 13)) < 0.4
    idx = rng.integers(0, 256, (9, 13), np.uint8)
    grey2 = np.array([[0, 0, 0], [255, 255, 255]], np.uint8)
    ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    cases = {f"{bits}-bit DIB, AND mask": icon_file([(icon_dib(
        idx & (1 << bits) - 1, bits, pal[: 1 << bits], mask), 13, 9, bits, 0)])
        for bits in (1, 4, 8)}
    cases.update({
        "24-bit DIB, AND mask": icon_file([(icon_dib(px[..., :3], 24, mask=mask), 13, 9, 24, 0)]),
        "32-bit DIB, alpha": icon_file([(icon_dib(px, 32), 13, 9, 32, 0)]),
        "32-bit DIB listed as 24 bits: its AND mask": icon_file([(icon_dib(px, 32, mask=mask),
                                                                   13, 9, 24, 0)]),
        "24-bit DIB listed as 32 bits: alpha from every fourth byte": icon_file(
            [(icon_dib(px[..., :3], 24, mask=mask) + bytes(100), 13, 9, 32, 0)]),
        "1-bit black and white palette (mode 1)": icon_file(
            [(icon_dib(idx & 1, 1, grey2, mask), 13, 9, 1, 2)]),
        "8-bit grey ramp (mode L)": icon_file([(icon_dib(idx, 8, ramp, mask), 13, 9, 8, 0)]),
        "largest first, then fewest bits": icon_file(
            [(icon_dib(px[:4, :5], 32), 5, 4, 32, 0), (icon_dib(px, 32), 13, 9, 32, 0),
             (icon_dib(idx % 16, 4, pal[:16], mask), 13, 9, 4, 16),
             (icon_dib(idx, 8, pal, mask), 13, 9, 8, 0)]),
        "a colour count without a bit count": icon_file(
            [(icon_dib(idx % 16, 4, pal[:16], mask), 13, 9, 0, 16),
             (icon_dib(idx, 8, pal, mask), 13, 9, 0, 0)]),
        "PNG and DIB entries": icon_file(
            [(icon_dib(idx, 8, pal, mask), 13, 9, 8, 0),
             (save(Image.fromarray(rgba(16, 16, 3)), "PNG"), 16, 16, 32, 0)]),
        "256x256 entry (width byte 0)": icon_file([(icon_dib(rgba(256, 256, 4)[:, :, :3], 24),
                                                    256, 256, 24, 0)]),
    })
    return cases


ICO_CASES = ico_cases()


@pytest.mark.parametrize("case", list(ICO_CASES))
def test_ico_matches_pillow(case):
    assert_pillow_reads(ICO_CASES[case], "ICO")


def cur_cases():
    rng = np.random.default_rng(22)
    px = rgba(9, 13, 22)
    pal = rng.integers(0, 256, (16, 3), np.uint8)
    idx = rng.integers(0, 16, (9, 13), np.uint8)
    one = icon_dib(px, 32)
    cases = {
        "32-bit bitmap at byte 22: alpha": icon_file([(one, 13, 9, 1, 1)], cursor=True),
        "32-bit bitmap after two entries: no alpha": icon_file(
            [(one, 13, 9, 1, 1), (icon_dib(px[:4, :5], 32), 5, 4, 0, 0)], cursor=True),
        "4-bit bitmap": icon_file([(icon_dib(idx, 4, pal), 13, 9, 2, 3)], cursor=True),
        "a later entry only where wider and taller": icon_file(
            [(icon_dib(idx[:4, :14 - 1], 4, pal), 13, 4, 0, 0),
             (icon_dib(idx, 4, pal), 13, 9, 0, 0),
             (icon_dib(idx[:, :12], 4, pal), 12, 9, 0, 0)], cursor=True),
    }
    zero = bytearray(icon_file([(one, 13, 9, 1, 1)], cursor=True))
    zero[18:22] = bytes(4)  # a bitmap offset of 0: Pillow reads on from the directory
    cases["bitmap offset 0"] = bytes(zero)
    return cases


CUR_CASES = cur_cases()


@pytest.mark.parametrize("case", list(CUR_CASES))
def test_cur_matches_pillow(case):
    assert_pillow_reads(CUR_CASES[case], "CUR")


def planar(idx: np.ndarray, planes: int, stride: int = None) -> np.ndarray:
    """Palette indices [H, W] -> 1-bit planes one after the other a line."""
    out = [np.packbits((idx >> k) & 1, axis=1) for k in range(planes)]
    stride = stride or out[0].shape[1]
    return np.concatenate([np.pad(p, ((0, 0), (0, stride - p.shape[1]))) for p in out], 1)


def pcx_cases():
    rng = np.random.default_rng(23)
    pal16 = rng.integers(0, 256, 48, np.uint8).tobytes()
    cases = {}
    for w in (1, 2, 3, 5, 8, 9, 16, 17):
        idx = rng.integers(0, 16, (4, w), np.uint8)
        for planes in (1, 2, 4):
            cases[f"1 bit, {planes} planes, width {w}"] = pcx_file(
                planar(idx % (1 << planes), planes), w, 1, planes, palette16=pal16)
            cases[f"1 bit, {planes} planes, width {w}, even stride"] = pcx_file(
                planar(idx % (1 << planes), planes, -(-w // 16) * 2), w, 1, planes,
                palette16=pal16)
        rgb = rng.integers(0, 256, (4, 3 * (w + w % 2)), np.uint8)
        cases[f"RGB, width {w}, even stride"] = pcx_file(rgb, w, 8, 3)
        cases[f"RGB, width {w}, header stride {w}"] = pcx_file(
            rng.integers(0, 256, (4, 3 * w), np.uint8), w, 8, 3, stride=w)
    grey = rng.integers(0, 256, (5, 6), np.uint8)
    ramp = b"\x0c" + bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
    cases.update({
        "8 bits, palette at the end": pcx_file(grey, 6, 8, 1, tail=b"\x0c" + bytes(
            rng.integers(0, 256, 768, np.uint8))),
        "8 bits, grey-ramp palette": pcx_file(grey, 6, 8, 1, tail=ramp),
        "8 bits, no palette": pcx_file(grey, 6, 8, 1),
        "8 bits, palette marker not 12": pcx_file(grey, 6, 8, 1, tail=b"\x0b" + ramp[1:]),
        "version 0, 1 bit": pcx_file(planar(grey & 1, 1), 6, 1, 1, version=0),
        "runs of 63 and trailing bytes": pcx_file(np.full((3, 200), 7, np.uint8), 200, 8, 1,
                                                  tail=b"\x01\x02"),
    })
    return cases


PCX_CASES = pcx_cases()


@pytest.mark.parametrize("case", list(PCX_CASES))
def test_pcx_matches_pillow(case):
    assert_pillow_reads(PCX_CASES[case], "PCX")


def test_dcx_reads_its_first_image():
    px = pillow_modes(6, 9, 24)
    first, second = save(px["RGB"], "PCX"), save(px["P"], "PCX")
    raw = dcx_file([first, second])
    assert_pillow_reads(raw, "DCX")
    np.testing.assert_array_equal(decode_image_u8(raw), pillow(first))
    # an 8-bit first image takes its palette from the end of the file: the last image's
    grey = save(px["L"].convert("L"), "PCX")[:-769]
    assert_pillow_reads(dcx_file([grey, second]), "DCX")


SGI_CASES = {}
for bpc in (1, 2):
    for z in (1, 3, 4):
        SGI_CASES[f"RLE, {bpc} bytes, {z} channels"] = (
            lambda bpc=bpc, z=z: sgi_file((np.random.default_rng(z).integers(0, 4, (z, 7, 11))
                                           * (60 if bpc == 1 else 16000)), bpc, True))
SGI_CASES.update({
    "RLE, dimension 1": lambda: sgi_file(np.arange(12, dtype=np.int64)[None, None], 1, True, 1),
    "verbatim, dimension 1": lambda: sgi_file(np.arange(12, dtype=np.int64)[None, None], 1,
                                              False, 1),
    "RLE, noise in copies": lambda: sgi_file(np.random.default_rng(9).integers(
        0, 256, (3, 9, 300)), 1, True),
})


@pytest.mark.parametrize("case", list(SGI_CASES))
def test_sgi_matches_pillow(case):
    assert_pillow_reads(SGI_CASES[case](), "SGI")


def sgi_one_channel(width: int, rows, lengths=None) -> bytes:
    """An RLE SGI of one channel whose rows (file order) are the streams
    `rows`, with the table's `lengths` (default: each stream's)."""
    h = len(rows)
    lengths = [len(r) for r in rows] if lengths is None else lengths
    head = struct.pack(">hBBHHHHll", 474, 1, 1, 2, width, h, 1, 0, 255).ljust(512, b"\0")
    starts, pos = [], 512 + 8 * h
    for r in rows:
        starts.append(pos)
        pos += len(r)
    return (head + struct.pack(f">{h}I", *starts) + struct.pack(f">{h}I", *lengths)
            + b"".join(rows))


def test_sgi_rle_row_quirks():
    """SgiRleDecode.c's rules: a length counts ops; a row whose last
    allowed op is not the end marker stops the decode (its rows and those
    above stay zero); a row that writes fewer samples keeps the row
    below's in the line buffer; a length of 2**31 or more reads no op."""
    full = sgi_rle_row(np.array([9, 9, 9, 4, 5, 6]), 1)
    short = sgi_rle_row(np.array([1, 2]), 1)
    for lengths in ([len(full), len(short), len(full)], [len(full), 1, len(full)],
                    [2, len(short), len(full)], [len(full), 2**31, 2**32 - 1]):
        assert_pillow_reads(sgi_one_channel(6, [full, short, full], lengths), "SGI")


DIB_CASES = {
    "top-down 24-bit": lambda: dib_of(rgba(5, 7, 1)[..., :3], 24, top_down=True),
    "4-bit palette of 5": lambda: dib_of(np.arange(35).reshape(5, 7) % 5, 4,
                                         np.random.default_rng(1).integers(0, 256, (5, 3))),
    "8-bit grey palette of 16 (mode L: the bytes as grey)": lambda: dib_of(
        np.arange(35).reshape(5, 7) * 7 % 256, 8,
        np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, 1)),
    "4-bit black and white (mode 1: one bit a pixel)": lambda: dib_of(
        np.arange(35).reshape(5, 7) % 16, 4, np.array([[0, 0, 0], [255, 255, 255]])),
    "8-bit black and white (mode 1)": lambda: dib_of(
        np.arange(35).reshape(5, 7) % 256, 8, np.array([[0, 0, 0], [255, 255, 255]])),
    "4-bit grey of 16, 4 wide (mode L within its rows)": lambda: dib_of(
        np.arange(12).reshape(3, 4), 4, np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3,
                                                  1)),
    "no padding after the last row": lambda: dib_of(rgba(3, 5, 2)[..., :3], 24)[:-1],
}


@pytest.mark.parametrize("case", list(DIB_CASES))
def test_dib_matches_pillow(case):
    assert_pillow_reads(DIB_CASES[case](), "DIB")


def test_bmp_grey_palettes_follow_pillow():
    """The BMP file header over the same DIB core reads grey palettes as
    Pillow does."""
    for make in DIB_CASES.values():
        dib = make()
        (n,) = struct.unpack_from("<I", dib, 32)
        off = 14 + 40 + 4 * n
        assert_as_pillow(b"BM" + struct.pack("<IHHI", 14 + len(dib), 0, 0, off) + dib)


# ---- refusals --------------------------------------------------------------------------------

def pcx_kind(bits, planes, version=5):
    return pcx_file(np.zeros((2, 4 * planes), np.uint8), 4, bits, planes, version)


def sgi_kind(bpc, dimension, z, compression=1):
    return struct.pack(">hBBHHHH", 474, compression, bpc, dimension, 2, 2, z).ljust(600, b"\0")


def dib_kind(bits, compression=0, header=40):
    return struct.pack("<IiiHHIIiiII", header, 2, 2, 1, bits, compression, 0, 0, 0, 0,
                       0).ljust(max(header, 40) + 64, b"\0")


# variant -> (file, name): Pillow refuses each too
PILLOW_REFUSES = {
    "PCX of 2-bit samples in 1 planes": (pcx_kind(2, 1), ""),
    "PCX of 4-bit samples in 1 planes": (pcx_kind(4, 1), ""),
    "PCX of 8-bit samples in 1 planes \\(version 3\\)": (pcx_kind(8, 1, 3), ""),
    "PCX of 8-bit samples in 4 planes": (pcx_kind(8, 4), ""),
    "PCX of 1-bit samples in 3 planes": (pcx_kind(1, 3), ""),
    "DCX of 2-bit samples in 1 planes": (dcx_file([pcx_kind(2, 1)]), ""),
    "SGI of 3 bytes a sample": (sgi_kind(3, 2, 1), ""),
    "SGI of 1 bytes a sample, dimension 3 and 2 channels": (sgi_kind(1, 3, 2), ""),
    "SGI of 1 bytes a sample, dimension 2 and 3 channels": (sgi_kind(1, 2, 3), ""),
    "SGI compression 2": (sgi_kind(1, 2, 1, 2), ""),
    "2-bit DIB": (dib_kind(2), ""),
    "BMP with a 44-byte header": (b"BM" + struct.pack("<IHHI", 200, 0, 0, 100)
                                  + b"\x2c" + dib_kind(24)[1:], ""),
    "DIB compression 4": (dib_kind(24, 4), ""),
    "DIB bit fields on a 8-bit palette image": (dib_kind(8, 3, 52), ""),
    "grey-palette DIB of 7 one-byte pixels in rows of 4 bytes": (dib_of(
        np.zeros((5, 7), np.uint8), 4, np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, 1)),
        ""),
}
# the BMP variants the port refused until it read them: each now decodes as Pillow's
PORT_READS_NOW = {
    "16-bit DIB": (dib_kind(16), ""),
    "RLE8-compressed DIB": (struct.pack("<IiiHHIIiiII", 40, 2, 2, 1, 8, 1, 0, 0, 0, 2, 0)
                            + bytes(8) + b"\x02\x05\x00\x00\x02\x07\x00\x01", ""),
    "DIB with a 12-byte header": (struct.pack("<IHHHH", 12, 2, 2, 1, 24) + bytes(16), ""),
    "16-bit CUR bitmap": (icon_file([(dib_kind(16), 2, 1, 0, 0)], cursor=True), ""),
    "ICO bitmap with a 12-byte header": (icon_file([(struct.pack("<IHHHH", 12, 2, 4, 1, 24)
                                                     + bytes(64), 2, 2, 24, 0)]), ""),
}


@pytest.mark.parametrize("variant", list(PILLOW_REFUSES))
def test_variants_pillow_refuses_are_refused_by_name(variant):
    raw, name = PILLOW_REFUSES[variant]
    assert refused_by_pillow(raw)
    with pytest.raises(NotImplementedError, match=f"{variant}.*ROADMAP"):
        decode_image_u8(raw, name)


@pytest.mark.parametrize("variant", list(PORT_READS_NOW))
def test_variants_the_port_once_refused_match_pillow(variant):
    raw, name = PORT_READS_NOW[variant]
    assert not refused_by_pillow(raw)
    assert_as_pillow(raw, name)


MALFORMED = {
    "PNM maxval 0": b"P5 2 2 0\n" + bytes(4),
    "PNM maxval 65536": b"P5 2 2 65536\n" + bytes(8),
    "PNM sample above maxval": b"P2 2 1 10 3 11",
    "PNM negative sample": b"P2 2 1 10 3 -1",
    "PNM token too long": b"P5 12345678901 1 255\n",
    "PNM header ends": b"P6 2 2",
    "PBM bad token": b"P1 2 2 0 1 2 0",
    "PFM scale 0": b"Pf 1 1 0\n" + bytes(4),
    "PFM scale nan": b"Pf 1 1 nan\n" + bytes(4),
    "PNM truncated": b"P6 4 4 255\n" + bytes(40),
    "PNM plain truncated": b"P3 2 2 255 1 2 3",
    "QOI truncated": b"qoif" + struct.pack(">IIBB", 4, 4, 4, 0) + b"\xfe\x01",
    "QOI over Pillow's pixel limit": b"qoif" + struct.pack(">IIBB", 20000, 20000, 4, 0) + bytes(8),
    "PCX run across lines": pcx_header(4, 2, 8, 1, 4) + b"\xc8\x05\x01\x02\x03\x04",
    "PCX truncated": pcx_file(np.zeros((4, 6), np.uint8), 6, 8, 1)[:131],
    "SGI RLE row overruns its width": sgi_one_channel(3, [b"\x05\x07\x00"]),
    "SGI RLE start inside the header": struct.pack(">hBBHHHH", 474, 1, 1, 2, 2, 1, 1).ljust(
        512, b"\0") + struct.pack(">II", 100, 2) + b"\x02\x00\x00",
    "SGI verbatim truncated": sgi_file(np.zeros((3, 4, 4), np.int64), 1, False)[:-1],
    "ICO bitmap truncated": icon_file([(icon_dib(np.zeros((4, 4), np.uint8), 8,
                                                 np.zeros((256, 3), np.uint8))[:40 + 1024 + 10],
                                        4, 4, 8, 0)]),
    "ICO mask before the file's start": icon_file([(icon_dib(rgba(40, 4)[..., :3], 24), 4, 40,
                                                    24, 2)])[:6 + 8] + struct.pack("<II", 1, 22)
                                        + icon_dib(rgba(40, 4)[..., :3], 24),
    "CUR bitmap truncated": icon_file([(icon_dib(rgba(4, 4), 32)[:40 + 60], 4, 4, 0, 0)],
                                      cursor=True),
    "DIB palette longer than 256": dib_of(np.zeros((2, 2), np.uint8), 8,
                                          np.zeros((300, 3), np.uint8)),
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_files_raise_where_pillow_raises(case):
    raw = MALFORMED[case]
    assert refused_by_pillow(raw)
    with pytest.raises(ValueError):
        decode_image_u8(raw)


# ---- random streams --------------------------------------------------------------------------

@FAST
@given(st.integers(1, 9), st.integers(1, 6), st.sampled_from([3, 4, 0, 7]),
       st.lists(st.tuples(st.integers(0, 5), st.binary(min_size=4, max_size=4)), max_size=60),
       st.booleans())
def test_random_qoi_ops_match_pillow(w, h, channels, ops, end):
    """Every op kind, a RUN past the end, an INDEX of an empty slot, files
    that end early."""
    body = bytearray()
    for kind, b in ops:
        body += [bytes([0xFE]) + b[:3], bytes([0xFF]) + b, bytes([b[0] & 63]),
                 bytes([0x40 | b[0] & 63]), bytes([0x80 | b[0] & 63, b[1]]),
                 bytes([0xC0 | b[0] % 62])][kind]
    raw = b"qoif" + struct.pack(">IIBB", w, h, channels, 1) + bytes(body)
    assert_as_pillow(raw + (bytes(7) + b"\x01" if end else b""))


@FAST
@given(st.integers(1, 12), st.integers(1, 4), st.sampled_from([(1, 1), (1, 2), (1, 4), (8, 1),
                                                               (8, 3)]),
       st.sampled_from([0, 2, 3, 5]), st.one_of(st.none(), st.integers(0, 8)),
       st.binary(max_size=120), st.sampled_from(["none", "palette", "ramp"]), st.data())
def test_random_pcx_streams_match_pillow(w, h, layout, version, stride, stream, tail, data):
    """Random run-length bytes, header strides and versions, with and
    without the 769-byte palette at the end."""
    bits, planes = layout
    raw = bytearray(pcx_header(w, h, bits, planes,
                               stride if stride is not None else (w * bits + 7) // 8, version,
                               data.draw(st.binary(min_size=48, max_size=48))))
    raw += stream
    if tail == "palette":
        raw += b"\x0c" + data.draw(st.binary(min_size=768, max_size=768))
    elif tail == "ramp":
        raw += b"\x0c" + bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
    assert_as_pillow(bytes(raw))


@FAST
@given(st.integers(1, 20), st.integers(1, 5), st.sampled_from([(1, 1), (1, 2), (1, 4), (8, 1),
                                                               (8, 3)]),
       st.booleans(), st.integers(0, 3), st.data())
def test_random_pcx_lines_match_pillow(w, h, layout, even, edits, data):
    """Lines of random bytes coded as Pillow's writer codes them, strides
    as written or made even, then a few bytes of the stream changed (runs
    that cross a line, streams that end early)."""
    bits, planes = layout
    stride = (w * bits + 7) // 8
    stride += stride % 2 if even else 0
    lines = np.frombuffer(data.draw(st.binary(min_size=h * planes * stride,
                                              max_size=h * planes * stride)), np.uint8)
    raw = bytearray(pcx_file(lines.reshape(h, planes * stride), w, bits, planes,
                             palette16=data.draw(st.binary(min_size=48, max_size=48))))
    for _ in range(edits):
        if len(raw) > 128:
            raw[data.draw(st.integers(128, len(raw) - 1))] = data.draw(st.integers(0, 255))
    assert_as_pillow(bytes(raw))


@FAST
@given(st.integers(1, 8), st.integers(1, 4), st.sampled_from([1, 3, 4]), st.sampled_from([1, 2]),
       st.data())
def test_random_sgi_rle_matches_pillow(w, h, z, bpc, data):
    """Rows cut short, lengths that bound the ops below or above the row's,
    starts anywhere, files ending at the last row's last byte."""
    rows, lengths = {}, {}
    for c in range(z):
        for r in range(h):
            n = data.draw(st.integers(0, w))
            vals = np.array(data.draw(st.lists(st.integers(0, 3), min_size=n, max_size=n)))
            rows[(r, c)] = sgi_rle_row(vals * (80 if bpc == 1 else 20000), bpc)
            lengths[(r, c)] = data.draw(st.one_of(st.just(len(rows[(r, c)])),
                                                  st.integers(0, 12)))
    keys = [(r, c) for c in range(z) for r in range(h)]
    order = data.draw(st.permutations(keys))
    start, pos = {}, 512 + 8 * z * h
    for k in order:
        start[k] = pos
        pos += len(rows[k])
    if data.draw(st.booleans()):
        k = data.draw(st.sampled_from(keys))
        start[k] = data.draw(st.integers(0, pos + 4))
    head = struct.pack(">hBBHHHH", 474, 1, bpc, 3 if z > 1 else 2, w, h, z).ljust(512, b"\0")
    raw = (head + struct.pack(f">{z * h}I", *(start[k] for k in keys))
           + struct.pack(f">{z * h}I", *(lengths[k] for k in keys))
           + b"".join(rows[k] for k in order) + data.draw(st.binary(max_size=2)))
    assert_as_pillow(raw)


@FAST
@given(st.sampled_from([b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"P0CMYK", b"Pf", b"PyP",
                        b"PyRGBA", b"P7"]),
       st.integers(0, 5), st.integers(1, 4), st.sampled_from([1, 3, 100, 255, 256, 65535]),
       st.lists(st.sampled_from([b" ", b"\n", b"\t", b"\r\n", b" #c\n", b"#\r"]), min_size=4,
                max_size=4),
       st.binary(max_size=80), st.data())
def test_random_pnm_matches_pillow(magic, w, h, maxval, seps, body, data):
    """Headers with comments anywhere, sizes of zero, any maxval, samples
    plain or raw, files short or long."""
    head = magic + seps[0] + b"%d" % w + seps[1] + b"%d" % h
    if magic == b"Pf":
        head += seps[2] + data.draw(st.sampled_from([b"-1.0", b"1", b"0.25", b"0", b"-inf"]))
    elif magic not in (b"P1", b"P4"):
        head += seps[2] + b"%d" % maxval
    head += seps[3][-1:]
    if magic in (b"P1", b"P2", b"P3"):
        count = w * h * (3 if magic == b"P3" else 1) + data.draw(st.integers(-1, 2))
        top = 1 if magic == b"P1" else maxval + data.draw(st.integers(0, 1))
        vals = data.draw(st.lists(st.integers(0, top), min_size=max(count, 0),
                                  max_size=max(count, 0)))
        body = b"".join(b"%d" % v + data.draw(st.sampled_from([b" ", b"\n", b"#x\n", b""]))
                        for v in vals)
    assert_as_pillow(head + body)


@FAST
@given(st.lists(st.tuples(st.integers(1, 12), st.integers(1, 8),
                          st.sampled_from([1, 4, 8, 24, 32]), st.sampled_from([0, 1, 4, 8, 24, 32]),
                          st.integers(0, 17), st.booleans()), min_size=1, max_size=3),
       st.booleans(), st.data())
def test_random_icons_match_pillow(entries, cursor, data):
    """Directories of several entries (listed bit counts that differ from
    the bitmap's, colour counts), grey and random palettes, AND masks,
    payloads cut short."""
    made = []
    for w, h, bits, listed, colours, grey in entries:
        n = 1 << bits if bits <= 8 else 0
        if grey and bits <= 8:
            pal = np.repeat(np.arange(n, dtype=np.uint8)[:, None], 3, 1)
            if data.draw(st.booleans()):
                pal, n = np.array([[0, 0, 0], [255, 255, 255]], np.uint8), 2
        else:
            pal = np.frombuffer(data.draw(st.binary(min_size=3 * n, max_size=3 * n)),
                                np.uint8).reshape(n, 3)
        seed = data.draw(st.integers(0, 2**16))
        rng = np.random.default_rng(seed)
        px = rng.integers(0, max(n, 1), (h, w), np.uint8) if bits <= 8 else rng.integers(
            0, 256, (h, w, bits // 8), np.uint8)
        payload = icon_dib(px, bits, pal if bits <= 8 else None, rng.random((h, w)) < 0.5)
        if data.draw(st.booleans()):
            payload = payload[: data.draw(st.integers(0, len(payload)))]
        made.append((payload, w, h, listed, colours))
    assert_as_pillow(icon_file(made, cursor))


@FAST
@given(st.integers(0, 9), st.integers(-6, 6), st.sampled_from([1, 4, 8, 16, 24, 32]),
       st.sampled_from([40, 52, 56, 108, 124]), st.sampled_from([0, 3]),
       st.sampled_from([(0xFF0000, 0xFF00, 0xFF, 0), (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                        (0, 0, 0, 0), (0xFF00, 0xFF, 0xFF0000, 0)]),
       st.integers(0, 20), st.booleans(), st.data())
def test_random_dibs_match_pillow(w, h, bits, header, compression, masks, colours, bmp, data):
    """Bare DIBs (and BMPs over them): every header length, bit fields and
    their masks, colour counts, top-down heights, data cut short."""
    stride = ((w * bits + 31) >> 3) & ~3
    info = bytearray(struct.pack("<IiiHHIIiiII", header, w, h, 1, bits, compression, 0, 0, 0,
                                 colours, 0).ljust(header, b"\0"))
    if header >= 52:
        struct.pack_into("<III", info, 40, *masks[:3])
    if header >= 56:
        struct.pack_into("<I", info, 52, masks[3])
    extra = struct.pack("<III", *masks[:3]) if header == 40 and compression == 3 else b""
    pal = data.draw(st.binary(min_size=4 * colours, max_size=4 * colours))
    pixels = data.draw(st.binary(min_size=stride * abs(h), max_size=stride * abs(h)))
    dib = bytes(info) + extra + pal + pixels
    dib = dib[: data.draw(st.integers(len(dib) - 2, len(dib)))] if dib else dib
    if bmp:
        off = 14 + header + len(extra) + len(pal)
        dib = b"BM" + struct.pack("<IHHI", 14 + len(dib), 0, 0, off) + dib
    assert_as_pillow(dib)


@FAST
@given(st.binary(min_size=4 * 12, max_size=4 * 12), st.booleans())
def test_random_pfm_floats_match_pillow(data, little):
    """Any float32 bit pattern (NaNs, infinities, subnormals), Pillow's F to
    RGBA: clipped to 0..255, cut toward zero."""
    raw = b"Pf\n4 3\n%s\n" % (b"-1.0" if little else b"1.0") + data
    assert_pillow_reads(raw, "PPM")


# ---- the committed fixtures ------------------------------------------------------------------

def classic_manifest() -> dict:
    with open(os.path.join(CLASSIC_FIXTURES, "manifest.json")) as f:
        return json.load(f)


def classic_fixture(name: str) -> bytes:
    with open(os.path.join(CLASSIC_FIXTURES, name), "rb") as f:
        return f.read()


def test_classic_fixture_writer_makes_the_committed_set(tmp_path):
    """make_classic_fixtures runs, and writes the committed files' names,
    expectations and bytes (its own 3 MiB beside formats/' and
    formats_dds_psd/')."""
    made = make_classic_fixtures(str(tmp_path))
    assert made == classic_manifest()
    for name in os.listdir(tmp_path):
        assert (tmp_path / name).read_bytes() == classic_fixture(name), name
    total = sum(os.path.getsize(os.path.join(CLASSIC_FIXTURES, n))
                for n in os.listdir(CLASSIC_FIXTURES))
    assert total <= 3 * 2**20


@pytest.mark.parametrize("entry", classic_manifest()["images"], ids=lambda e: e["file"])
def test_committed_classic_fixture_matches_pillow(entry):
    """Each committed expectation is Pillow's decode of the committed file,
    its format Pillow's, and the port's decode and format equal them."""
    raw = classic_fixture(entry["file"])
    want = pillow(raw)
    np.testing.assert_array_equal(np.load(os.path.join(CLASSIC_FIXTURES, entry["expect"])), want)
    assert Image.open(io.BytesIO(raw)).format == entry["format"]
    assert image_format(raw, entry["file"]) == entry["format"]
    np.testing.assert_array_equal(decode_image_u8(raw, entry["file"]), want)


def test_classic_fixtures_cover_each_new_decoder():
    formats = {e["format"] for e in classic_manifest()["images"]}
    assert formats == {"PPM", "QOI", "ICO", "CUR", "PCX", "DCX", "SGI", "DIB"}


def test_committed_breaktime_classic_pair():
    """The classic GLB's textures are, in order, the kinds CLASSIC_TEXTURES
    names under CLASSIC_MIMES, and their Pillow decodes are the twin's PNGs."""
    scene = classic_manifest()["scene"]
    files = glb_images(classic_fixture(scene["classic"]))
    pngs = glb_images(classic_fixture(scene["classic_twin"]))
    assert len(files) == len(pngs) == 6
    kinds = []
    for f in files:
        im = Image.open(io.BytesIO(f))
        kinds.append((im.format, im.mode))
    assert kinds == [("PPM", "RGB"), ("QOI", "RGBA"), ("SGI", "RGB"), ("PCX", "RGB"),
                     ("ICO", "RGBA"), ("DCX", "RGB")]
    assert files[0][:2] == b"P6" and files[2][2] == 1  # raw PPM, RLE SGI
    assert files[3][3] == 8 and files[3][65] == 3  # 24-bit PCX: 3 planes of 8 bits
    assert struct.unpack_from("<H", files[4], 6 + 6)[0] == 32 and files[4][22:26] == b"\x28\0\0\0"
    for f, png in zip(files, pngs):
        assert png[:4] == b"\x89PNG"
        np.testing.assert_array_equal(pillow(f), pillow(png))
        np.testing.assert_array_equal(decode_image_u8(f), pillow(png))
    doc, _ = read_glb(classic_fixture(scene["classic"]))
    assert [img["mimeType"] for img in doc["images"]] == CLASSIC_MIMES
    assert CLASSIC_TEXTURES[1].startswith("QOI") and CLASSIC_TEXTURES[3].startswith("PCX")


def test_pnm_module_reads_pillows_magic_numbers():
    from PIL import PpmImagePlugin

    assert pnm_mod.MODES == PpmImagePlugin.MODES and pnm_mod.WHITESPACE == PpmImagePlugin.b_whitespace
    assert pnm_mod.SAFEBLOCK == ImageFile.SAFEBLOCK


# ---- edits of the committed fixtures against Pillow (queue 3's fuzz) --------------------------

def classic_fuzz(n: int, seed: int = 0) -> dict:
    """`n` random edits of every committed fixture of formats_classic
    (tests/test_torch_image_formats_variants.py `edit_fuzz`) -> counts of
    (kind, outcome); raises AssertionError at the first disagreement."""
    from tests.test_torch_image_formats_variants import edit_fuzz

    names = [e["file"] for e in classic_manifest()["images"]]
    return edit_fuzz([(name, classic_fixture(name)) for name in names], n, seed)


@pytest.mark.parametrize("seed", range(4))
def test_edited_classic_fixtures_decode_as_pillow_decodes_them(seed):
    """A fixed 4 x 5 edits of each classic fixture (`--fuzz` runs more)."""
    assert sum(classic_fuzz(5, seed).values()) == 5 * len(classic_manifest()["images"])


CLASSIC_EDITED = {  # what the fuzz found (an ICO's PNG), each now as Pillow reads it
    "PNG zlib check broken: Pillow inflates no further than the rows":
        ("ico-png.ico", "byte", 0.9744756345842079, 12318),
    "PNG stream cut before its check": ("ico-png.ico", "zero", 0.9962633250360021, 30957),
    "PNG chunk before IDAT with a bad CRC: refused": ("ico-png.ico", "zero", 0.21974365098939053,
                                                      23622),
}


@pytest.mark.parametrize("case", list(CLASSIC_EDITED))
def test_classic_edits_the_fuzz_found(case):
    from tests.test_torch_image_formats_variants import assert_as_pillow, edit

    name, kind, where, value = CLASSIC_EDITED[case]
    assert_as_pillow(edit(classic_fixture(name), kind, where, value), name)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fuzz"]:  # --fuzz N [SEED]: edits of each classic fixture
        print(json.dumps(classic_fuzz(int(sys.argv[2]), int(sys.argv[3]) if sys.argv[3:] else 0)))
