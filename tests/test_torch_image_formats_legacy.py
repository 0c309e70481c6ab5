"""The port's decoders of the legacy formats against Pillow 12.1.0.

IM and IMT (rustic_tpu_torch/utils/im.py), IPTC (iptc.py), PCD (pcd.py),
SPIDER (spider.py), BLP (blp.py), FITS (fits.py), FLI and FLC (fli.py),
FTEX (ftex.py), GBR (gbr.py), ICNS (icns.py), MSP (msp.py), PIXAR
(pixar.py), SUN (sun.py), XBM (xbm.py) and XPM (xpm.py): files Pillow
writes in every mode it writes (IM, SPIDER, BLP, ICNS, MSP, XBM), files
the writers of tests/test_torch_image_formats.py build for the rest, and
random streams under hypothesis: `decode_image_u8` must give Pillow's
`np.asarray(Image.open(...).convert("RGBA"))` bit for bit, and raise
(ValueError or NotImplementedError) exactly where Pillow raises. Every
variant Pillow refuses raises NotImplementedError naming it and
FORMATS_TODO, and passes the file on or ends the open as Pillow does.

Five plugins have no test of the first bytes (IM, IMT, IPTC, PCD,
SPIDER): `Image.open` runs their readers on every file that reaches
them, so `image_format` must name what Pillow names on files that any of
them takes, also under a .tga name (the port before them tried TGA on
such a file by its name and refused it), and every TGA must still pass
through them to TGA. The RGBA conversions the new modes need
(utils/modes.py `to_rgba`) are held to Pillow's `convert("RGBA")` on
random arrays, YCbCr on all 2**24 inputs. The fixtures of
tests/data_torch/formats_legacy are written by `make_legacy_fixtures`
(`python -m tests.test_torch_image_formats`); `python -m
tests.test_torch_image_formats_legacy --fuzz N SEED` runs N byte edits of
each of them against Pillow (the suite keeps a fixed 4 x 5 each, and the
edits the fuzz found faults with: an ICNS entry's PNG). An IPTC record
holding a file of another format, and XPM keys of any length, as Pillow
reads them.
"""

import io
import json
import os
import struct
import threading

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import BlpImagePlugin, Image, ImImagePlugin

from rustic_tpu_torch.utils import FORMATS_TODO, modes, pcd
from rustic_tpu_torch.utils.blp import dxt_blocks
from rustic_tpu_torch.utils.png import decode_image_u8, image_format
from tests.derive_ycc_tables import photo_ycc_tables, ycbcr_tables
from tests.test_torch_image_formats import (LEGACY_FIXTURES, LEGACY_MIMES, LEGACY_TEXTURES,
                                            blp1_jpeg, blp_file, dxt_blocks_of, fits_file,
                                            fits_gzip_file, fli_brun, fli_chunk, fli_colour,
                                            fli_file, ftex_file, gbr_file, glb_images, icns_file,
                                            icns_rgb32, im_file, imt_file, iptc_field, iptc_file,
                                            mcidas_file, psd_of, write_psd, write_tiff,
                                            make_legacy_fixtures, msp2_file, pcd_file, pillow,
                                            pillow_modes, pixar_file, read_glb, rgba, save,
                                            sha256_rgba, spider_file, sun_file, sun_rows,
                                            xpm_file)
from tests.test_torch_image_formats_classic import (TGA_KINDS, assert_as_pillow,
                                                    assert_pillow_reads, pillow_open)

FAST = settings(max_examples=60, deadline=None, derandomize=True)
NO_TEST = ("IM", "IMT", "IPTC", "PCD", "SPIDER")


def picture(h, w, seed=0):
    return np.array(pillow_modes(h, w, seed)["RGB"])


def pillow_mode_images(h, w, seed=0) -> dict:
    """Pillow images of every mode IM writes, of one picture."""
    px = pillow_modes(h, w, seed)
    v = np.random.default_rng(seed).integers(0, 70000, (h, w))
    out = dict(px)
    out["I;16"] = Image.fromarray(v.astype(np.uint16) // 2)
    out["I"] = Image.fromarray((v - 20000).astype(np.int32))
    out["F"] = Image.fromarray((v / 200.0 - 20).astype(np.float32))
    out["CMYK"] = px["RGB"].convert("CMYK")
    out["YCbCr"] = px["RGB"].convert("YCbCr")
    out["PA"] = px["P"].convert("PA")
    out["RGBX"] = px["RGB"].convert("RGBX")
    return out


def assert_refused_by_name(raw: bytes, variant: str, name: str = ""):
    with pytest.raises(NotImplementedError, match=variant) as e:
        decode_image_u8(raw, name)
    assert FORMATS_TODO in str(e.value)


# ---- identification: the five plugins without a test -----------------------------------------

def tga_named_files():
    rng = np.random.default_rng(3)
    grey = rng.integers(0, 256, (5, 7), np.uint8)
    ycc = rng.integers(0, 256, (256, 2304), np.uint8)
    return {
        "IM": save(pillow_modes(5, 7)["RGB"], "IM"),
        "IMT": imt_file(grey),
        "SPIDER": save(Image.fromarray(grey.astype(np.float32) * 1.5), "SPIDER"),
        "PCD": pcd_file(ycc, 1),
    }


@pytest.mark.parametrize("fmt", list(tga_named_files()))
def test_files_of_the_plugins_without_a_test_are_read_under_a_tga_name(fmt):
    """An IM, an IMT, a SPIDER and a PCD file named .tga: Pillow opens each
    with its plugin before TGA's; the port did not try them and refused
    the file (TGA's reader turned it away): now it names and decodes them
    as Pillow does."""
    raw = tga_named_files()[fmt]
    assert_pillow_reads(raw, fmt, "texture.tga")
    assert_pillow_reads(raw, fmt, "")


@pytest.mark.parametrize("mode, kw", TGA_KINDS, ids=lambda v: str(v))
def test_every_tga_passes_through_the_plugins_without_a_test(mode, kw):
    """Every TGA kind Pillow writes is turned away by IM, IMT, IPTC, PCD
    and SPIDER, and reaches TGA (or, with a 10-byte ID field, PCX, as
    before); without its name the port names each of the five."""
    raw = save(pillow_modes(6, 5, seed=4)[mode], "TGA", **kw)
    assert_as_pillow(raw, "texture.tga")
    fmt = pillow_open(raw)[0]
    if fmt == "TGA":
        with pytest.raises(NotImplementedError) as e:
            decode_image_u8(raw, "")
        assert all(f"{p}: " in str(e.value) for p in NO_TEST)


def test_gbr_like_header_passes_on_to_tga():
    """A TGA whose first words pass GBR's weak test (512 and 1): Pillow's
    GBR reader finds a width of 0 and passes it on, so do the five."""
    img = np.asarray(pillow_modes(4, 6, seed=2)["RGB"])
    raw = bytearray(save(Image.fromarray(img), "TGA"))
    raw[7] = 1  # the colour map's depth: no map, so TGA ignores it
    assert struct.unpack_from(">II", raw) == (512, 1)
    assert_pillow_reads(bytes(raw), "TGA", "x.tga")


def test_xbm_with_leading_whitespace_passes_the_text_plugins():
    """IM and IMT read text headers: an XBM with leading blank lines passes
    both (and IPTC) to XBM."""
    raw = b"  \n\n" + save(pillow_modes(5, 11, seed=1)["1"], "XBM")
    assert_pillow_reads(raw, "XBM")


def test_text_headers_go_to_the_plugin_pillow_picks():
    """An IM header with an "Image type" Pillow does not know opens as IM
    and fails to load; an IMT without its form feed opens and fails; an
    IM line over 100 bytes, or without a key, passes on."""
    grey = np.arange(12, dtype=np.uint8).reshape(3, 4)
    assert_as_pillow(im_file(grey.tobytes(), "Foo", (4, 3)))
    assert pillow_open(im_file(grey.tobytes(), "Foo", (4, 3)))[0] == "IM"
    no_ff = b"width 4\nheight 3\npixel n8\n" + grey.tobytes()
    assert_as_pillow(no_ff)
    long_line = b"Comment: " + b"x" * 100 + b"\r\n" + im_file(grey.tobytes(), "Greyscale image",
                                                            (4, 3))
    assert_as_pillow(long_line)
    assert_as_pillow(b"no key here\n" + bytes(200))
    bad_number = im_file(grey.tobytes(), "Greyscale image", (4, 3),
                         extra=b"Scale (x,y): a*b\r\n")
    assert_as_pillow(bad_number)
    assert pillow_open(bad_number)[0] is None  # a ValueError ends Pillow's open


# ---- IM and IMT ------------------------------------------------------------------------------

IM_SIZES = [(1, 1), (5, 7), (8, 3), (17, 13)]


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "PA", "I", "I;16", "F", "RGB", "RGBA",
                                  "RGBX", "CMYK", "YCbCr"])
@pytest.mark.parametrize("size", IM_SIZES, ids=str)
def test_pillow_written_im_matches_pillow(mode, size):
    raw = save(pillow_mode_images(*size, seed=size[1])[mode], "IM")
    assert_pillow_reads(raw, "IM")


@pytest.mark.parametrize("image_type", sorted(ImImagePlugin.OPEN))
def test_every_im_image_type_matches_pillow(image_type):
    """Every "Image type" of Pillow's OPEN table, on random bytes: read as
    Pillow reads it (the n-bit samples of its bit decoder included), or
    refused by name where Pillow cannot load it (its RLB and PA types)."""
    raw = im_file(np.random.default_rng(7).integers(0, 256, 64 * 35, np.uint8).tobytes(),
                  image_type, (7, 5))
    fmt, want = pillow_open(raw)
    assert fmt == "IM" and image_format(raw) == "IM"
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(decode_image_u8(raw), want)
    else:
        assert_refused_by_name(raw, "IM ")


@pytest.mark.parametrize("grey_lut", [False, True])
@pytest.mark.parametrize("image_type", ["Greyscale image", "LA image"])
def test_im_luts(image_type, grey_lut):
    """A "Lut" that is not grey turns L into P and LA into PA; a grey one
    (here not linear) is read and dropped."""
    rng = np.random.default_rng(8)
    lut = (np.tile(rng.integers(0, 256, 256, np.uint8), 3) if grey_lut
           else rng.integers(0, 256, 768, np.uint8))
    bands = 1 if image_type == "Greyscale image" else 2
    raw = im_file(rng.integers(0, 256, 6 * 4 * bands, np.uint8).tobytes(), image_type, (6, 4),
                  lut=lut.tobytes())
    assert_pillow_reads(raw, "IM", "lut.tga")


def test_im_old_planar_and_header_forms():
    """RGB3 / RYB3 planes (G, R, B), LF line ends, CR noise, Name and
    Comment lines, a truncated file and a short palette."""
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, 3 * 35, np.uint8).tobytes()
    for t in ("RGB3 image", "RYB3 image"):
        assert_pillow_reads(im_file(data, t, (7, 5)), "IM")
    assert_pillow_reads(im_file(data, "RGB image", (7, 5), eol=b"\n",
                                extra=b"Name: x.im\n\rComment: hi\nComment: again\n"), "IM")
    assert_as_pillow(im_file(data[:50], "RGB image", (7, 5)))
    assert_as_pillow(im_file(data, "Greyscale image", (7, 5), lut=b"\1" * 700)[:600])


def test_imt_matches_pillow():
    rng = np.random.default_rng(10)
    px = rng.integers(0, 256, (6, 9), np.uint8)
    assert_pillow_reads(imt_file(px), "IMT")
    assert_pillow_reads(imt_file(px, comment=b""), "IMT", "x.tga")
    assert_as_pillow(imt_file(px)[:-10])
    assert_as_pillow(b"width x\nheight 3\npixel n8\n\x0c" + bytes(20))


# ---- IPTC ------------------------------------------------------------------------------------

def iptc_cases():
    rng = np.random.default_rng(11)
    grey = rng.integers(0, 256, (9, 13), np.uint8)
    rgb = picture(9, 13, 11)
    jpg = save(Image.fromarray(rgb), "JPEG", quality=85)
    gjpg = save(Image.fromarray(grey), "JPEG", quality=85)
    return {
        "raw grey": iptc_file(grey.tobytes(), (13, 9)),
        "raw grey, short fields": iptc_file(grey.tobytes(), (13, 9), chunk=40),
        "raw rgb band 2": iptc_file(grey.tobytes(), (13, 9), 3, 1, band=2),
        "raw cmyk band 4": iptc_file(grey.tobytes(), (13, 9), 4, 1, band=4),
        "raw rgb no band field": iptc_file(grey.tobytes(), (13, 9), 3, 1),
        "raw rgb band 0 (the last)": iptc_file(grey.tobytes(), (13, 9), 3, 1, band=0),
        "raw rgb band 5 (none)": iptc_file(grey.tobytes(), (13, 9), 3, 1, band=5),
        "raw cut short": iptc_file(grey.tobytes()[:90], (13, 9)),
        "jpeg rgb": iptc_file(jpg, (13, 9), compression=5),
        "jpeg grey band 1": iptc_file(gjpg, (13, 9), 3, 1, band=1, compression=5),
        "jpeg rgb as a band": iptc_file(jpg, (13, 9), 3, 1, band=1, compression=5),
        "jpeg long field": iptc_file(jpg, (13, 9), compression=5, chunk=10**6).replace(
            iptc_field(8, 10, jpg), iptc_field(8, 10, jpg, long=True)),
        "compression 7": iptc_file(grey.tobytes(), (13, 9), compression=7),
        "no image field": iptc_file(b"", (13, 9)),
        "layers 3 without the flag": iptc_file(grey.tobytes(), (13, 9), 3, 0),
        "field length 140": iptc_file(grey.tobytes(), (13, 9))[:3] + b"\x8c" + bytes(20),
    }


@pytest.mark.parametrize("case", list(iptc_cases()))
def test_iptc_matches_pillow(case):
    assert_as_pillow(iptc_cases()[case])
    assert_as_pillow(iptc_cases()[case], "x.tga")


def test_iptc_cases_reach_their_variant():
    cases = iptc_cases()
    for name in ("raw grey", "raw rgb band 2", "raw cmyk band 4", "jpeg rgb", "jpeg grey band 1"):
        assert pillow_open(cases[name])[0] == "IPTC" and isinstance(pillow_open(cases[name])[1],
                                                                     np.ndarray), name
    assert pillow_open(cases["compression 7"])[0] is None  # an OSError ends the open


def test_iptc_holding_another_format_is_refused_by_name():
    """What stays refused by name inside an IPTC colour record: a band of
    a file whose mode no decoder notes (an ICO), and a first band of
    32-bit samples (Pillow's merge of an "I" or "F" band ends its process,
    so Pillow is not run on it)."""
    ico = save(Image.fromarray(picture(4, 5)), "ICO", sizes=[(5, 4)])
    raw = iptc_file(ico, (5, 4), 3, 1, band=2, compression=5)
    assert pillow_open(raw)[0] == "IPTC"
    assert_refused_by_name(raw, "whose band is a ICO file")
    v = np.random.default_rng(1).integers(0, 300, (4, 5)).astype(np.uint32)
    assert_refused_by_name(iptc_file(mcidas_file(v, 4), (5, 4), 3, 1, band=1, compression=5),
                           "whose band is a MCIDAS file of mode I")


def iptc_embedded_cases():
    """IPTC records (compression 5) holding files of other formats, grey
    ("L": the file's image as Pillow's C convert takes it) and as a band
    of an RGB image."""
    rgb = picture(9, 13, 2)
    img = pillow_modes(9, 13, seed=2)
    p = Image.fromarray(rgb).quantize(16)
    files = {
        "PNG": save(Image.fromarray(rgb), "PNG"),
        "PNG RGBA": save(img["RGBA"], "PNG"),
        "PNG palette with tRNS": save(p, "PNG", transparency=3),
        "PNG grey with a key": save(img["L"], "PNG", transparency=7),
        "PNG 16-bit grey": save(Image.fromarray(rgb[..., 0].astype(np.uint16) * 200), "PNG"),
        "PNG 1-bit": save(img["1"], "PNG"),
        "GIF with transparency": save(p, "GIF", transparency=3),
        "BMP": save(Image.fromarray(rgb), "BMP"),
        "WebP": save(img["RGBA"], "WEBP", lossless=True),
        "TGA": save(Image.fromarray(rgb), "TGA"),
        "QOI": save(img["RGBA"], "QOI"),
        "PFM": b"Pf\n13 9\n-1.0\n" + np.linspace(0, 300, 117, dtype="<f4").tobytes(),
    }
    cases = {}
    for name, data in files.items():
        cases[name] = iptc_file(data, (13, 9), compression=5)
        if name != "PFM":  # Pillow's merge of an "F" first band ends the process
            cases[name + " as band 1"] = iptc_file(data, (13, 9), 3, 1, band=1, compression=5)
            cases[name + " as band 2"] = iptc_file(data, (13, 9), 3, 1, band=2, compression=5)
    return cases


@pytest.mark.parametrize("case", list(iptc_embedded_cases()))
def test_iptc_holding_any_format_matches_pillow(case):
    """Pillow's IPTC load opens the record's file with Image.open and takes
    its core image, none of its info: a PNG's or GIF's transparency is
    dropped, 16-bit grey and PFM floats are refused by the C convert; a
    band must be "L" after the first, and one band of any mode first, whose
    raw values Pillow merges (palette indices, 16-bit words)."""
    raw = iptc_embedded_cases()[case]
    assert_as_pillow(raw)
    assert pillow_open(raw)[0] == "IPTC"


def test_core_capture_is_kept_per_thread():
    """Two threads decoding at once each take the core image their own
    decode noted (utils/modes.py `core_of`), whatever the other notes in
    between; a note of another size than the decode (a thumbnail
    converted after the image) is not taken for it."""
    barrier = threading.Barrier(2, timeout=30)

    def decode(mode, n):
        def run():
            modes.note_core(mode, np.full((n, n), n, np.uint8))
            barrier.wait()
            modes.note_core("RGB", np.zeros((1, 2, 3), np.uint8))
            barrier.wait()
            return np.zeros((n, n, 4), np.uint8)
        return run

    out = {}

    def worker(mode, n):
        out[mode] = modes.core_of(decode(mode, n))[1]

    threads = [threading.Thread(target=worker, args=a) for a in (("L", 3), ("P", 5))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert {m: (c[0], c[1].shape, int(c[1][0, 0])) for m, c in out.items()} == {
        "L": ("L", (3, 3), 3), "P": ("P", (5, 5), 5)}
    modes.note_core("L")  # outside a capture: kept nowhere
    assert modes.core_of(lambda: np.zeros((2, 2, 4), np.uint8))[1] is None


def iptc_inside_files() -> dict:
    """Files of the formats once refused inside an IPTC record (TIFF, PSD,
    JPEG 2000, MCIDAS, FITS, IM, SPIDER, XPM) in the modes they take: the
    C convert's ("1", "L", "P", "LA", "RGB", "RGBA", "CMYK", "I") and the
    rest (16-bit grey, "F", LAB), and with a transparency in the info."""
    h, w = 9, 13
    img = pillow_mode_images(h, w, seed=3)
    rng = np.random.default_rng(5)
    v = rng.integers(0, 300, (h, w))
    idx = rng.integers(0, 5, (h, w))
    files = {f"TIFF {m}": save(img[m], "TIFF") for m in ("1", "L", "P", "RGB", "RGBA", "LA",
                                                         "I;16", "CMYK", "F")}
    files["TIFF LAB"] = save(img["RGB"].convert("LAB"), "TIFF")
    files["TIFF orientation 6"] = write_tiff(np.asarray(img["L"]), 1, compression="LZW",
                                             tags={274: (3, [6])})
    files["TIFF I;16B"] = write_tiff(np.asarray(img["I;16"]), 1, bps=16, order=">")
    files.update({f"PSD {m}": psd_of(img[m]) for m in ("1", "L", "P", "RGB", "RGBA", "CMYK")})
    lab = np.asarray(img["RGB"].convert("LAB")).transpose(2, 0, 1) ^ np.array(
        [0, 128, 128], np.uint8)[:, None, None]
    files["PSD LAB"] = write_psd(lab, 9, 8, 0)
    files.update({f"JPEG2000 {m}": save(img[m], "JPEG2000") for m in ("L", "RGB", "RGBA", "LA",
                                                                      "I;16")})
    files["MCIDAS 8"] = mcidas_file(v.astype(np.uint8), 1)
    files["MCIDAS 16"] = mcidas_file(v.astype(np.uint16) * 3, 2)
    files["MCIDAS 32"] = mcidas_file(v.astype(np.uint32) * 5, 4)
    for bits, kind in ((8, np.uint8), (16, ">i2"), (32, ">i4"), (-32, ">f4")):
        files[f"FITS {bits}"] = fits_file(bits, w, h, (v.astype(kind) * 3).tobytes())
    files.update({f"IM {m}": save(img[m], "IM") for m in ("1", "L", "P", "RGB", "RGBA", "LA",
                                                          "I;16", "I", "F", "CMYK", "YCbCr",
                                                          "RGBX")})
    files["SPIDER"] = spider_file((v / 3).astype(np.float32))
    files["XPM"] = xpm_file(idx, ["#ff0000", "#000001", "#00ff00", "#123456", "#abcdef"])
    files["XPM with None"] = xpm_file(idx, ["#ff0000", "None", "#00ff00", "#123456", "#abcdef"])
    files["XPM with an unused None"] = xpm_file(np.where(idx == 1, 0, idx), [
        "#ff0000", "None", "#00ff00", "#123456", "#abcdef"])  # its key's bytes alphas alone
    files["XPM RGB with None"] = xpm_file(rng.integers(0, 300, (h, w)), ["None"] + [
        f"#{i:06x}" for i in range(299)])
    return files


# the 32-bit one-band images, whose merge as a first band ends Pillow's process
THIRTY_TWO_BITS = ("TIFF F", "MCIDAS 32", "FITS 32", "FITS -32", "IM I", "IM F", "SPIDER")


def iptc_inside_cases() -> dict:
    cases = {}
    for name, data in iptc_inside_files().items():
        cases[name] = iptc_file(data, (13, 9), compression=5)
        if name not in THIRTY_TWO_BITS:
            cases[name + " as band 1"] = iptc_file(data, (13, 9), 3, 1, band=1, compression=5)
        cases[name + " as band 2"] = iptc_file(data, (13, 9), 3, 1, band=2, compression=5)
    return cases


@pytest.mark.parametrize("case", list(iptc_inside_cases()))
def test_iptc_holding_once_refused_formats_matches_pillow(case):
    """Pillow's IPTC load of a record holding each format once refused
    inside one: the file's core image (as its decoder notes it) through
    the C convert, a transparency in the info dropped, a mode the C
    convert has no way from refused with ValueError; as a band, Image.merge's
    checks and its raw bytes of the first band ("P" indices, 16-bit words
    in their byte order)."""
    raw = iptc_inside_cases()[case]
    assert pillow_open(raw)[0] == "IPTC"
    assert_as_pillow(raw)


# ---- PCD -------------------------------------------------------------------------------------

@pytest.mark.parametrize("orientation", [0, 1, 2, 3, 0x41, 0xFF])
def test_pcd_every_orientation_matches_pillow(orientation):
    ycc = np.random.default_rng(orientation).integers(0, 256, (256, 2304), np.uint8)
    raw = pcd_file(ycc, orientation)
    assert_pillow_reads(raw, "PCD", "photo.tga")


def every_ycc(lumas):
    """uint8 [len(lumas) * 256, 256, 3]: every (y, cb, cr) for those y."""
    y, cb, cr = np.meshgrid(lumas, np.arange(256), np.arange(256), indexing="ij")
    return np.stack([y, cb, cr], -1).astype(np.uint8).reshape(-1, 256, 3)


def test_pcd_photo_ycc_on_every_input():
    """The PhotoYCC unpacker (L, CR, CB, GB, GR tables) equals Pillow's
    "YCC;P" on all 2**24 (y, cb, cr), 16 values of y at a time."""
    for lumas in np.arange(256).reshape(16, 16):
        ycc = every_ycc(lumas)
        want = np.asarray(Image.frombytes("RGB", ycc.shape[1::-1], ycc.tobytes(), "raw",
                                          "YCC;P"))
        np.testing.assert_array_equal(pcd.photo_ycc_to_rgb(ycc[..., 0], ycc[..., 1], ycc[..., 2]),
                                      want)


def test_pcd_short_files():
    ycc = np.zeros((256, 2304), np.uint8)
    assert_as_pillow(pcd_file(ycc)[:-5])
    assert_as_pillow(pcd_file(ycc)[:2048 + 100])  # no orientation byte: passed on


# ---- SPIDER ----------------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["F", "L", "RGB", "I"])
@pytest.mark.parametrize("size", IM_SIZES, ids=str)
def test_pillow_written_spider_matches_pillow(mode, size):
    img = pillow_mode_images(*size, seed=size[0])[mode]
    assert_pillow_reads(save(img, "SPIDER"), "SPIDER")


@pytest.mark.parametrize("big", [True, False])
@pytest.mark.parametrize("stack", [0, 2])
def test_spider_byte_orders_and_stacks(big, stack):
    v = np.random.default_rng(12).normal(100, 150, (7, 11)).astype(np.float32)
    v[0, :3] = [np.nan, np.inf, -np.inf]
    assert_pillow_reads(spider_file(v, big, stack), "SPIDER", "x.tga")


def test_spider_refusals_follow_pillow():
    v = np.ones((4, 300), np.float32)
    raw = bytearray(spider_file(v))
    assert_as_pillow(bytes(raw[:100]))  # header cut short: passed on
    image_of_stack = bytearray(raw)
    struct.pack_into(">f", image_of_stack, 26 * 4, 1.0)  # an image number, no stack
    assert pillow_open(bytes(image_of_stack))[0] is None
    assert_as_pillow(bytes(image_of_stack))
    assert_as_pillow(bytes(raw[:-8]))


# ---- BLP -------------------------------------------------------------------------------------

@pytest.mark.parametrize("version", ["BLP1", "BLP2"])
@pytest.mark.parametrize("mode", ["P", "RGBA-palette"])
@pytest.mark.parametrize("size", IM_SIZES, ids=str)
def test_pillow_written_blp_matches_pillow(version, mode, size):
    px = pillow_modes(*size, seed=size[1])
    img = px["P"] if mode == "P" else px["RGBA"].quantize(40)
    assert_pillow_reads(save(img, "BLP", blp_version=version), "BLP")


def blp_cases():
    rng = np.random.default_rng(13)
    img = Image.fromarray(rgba(11, 9, 13))
    pal = rng.integers(0, 256, 1024, np.uint8).tobytes()
    idx = rng.integers(0, 256, 99, np.uint8).tobytes()
    cases = {
        "BLP1 JPEG": blp1_jpeg(img.convert("RGB")),
        "BLP1 JPEG alpha": blp1_jpeg(img.convert("RGB"), alpha=8),
        "BLP1 JPEG gap": blp1_jpeg(img.convert("RGB"), gap=7),
        "BLP1 JPEG grey": blp1_jpeg(img.convert("L")),
        "BLP1 JPEG larger than its header": blp_file(1, 5, 4, save(img.convert("RGB"), "JPEG")[2:],
                                                     0, 5, jpeg_header=b"\xff\xd8"),
        "BLP1 palette enc 4": blp_file(1, 11, 9, idx, 1, 4, 0, palette=pal),
        "BLP1 palette enc 5 alpha": blp_file(1, 11, 9, idx, 1, 5, 8, palette=pal),
        "BLP1 palette short": blp_file(1, 11, 9, idx[:50], 1, 4, 0, palette=pal),
    }
    for depth in (0, 1, 4, 8):
        cases[f"BLP2 palette alpha depth {depth}"] = blp_file(2, 11, 9, idx, 1, 1, depth,
                                                              palette=pal)
    for kind, code in (("DXT1", 0), ("DXT3", 1), ("DXT5", 7)):
        for w, h in ((12, 8), (11, 9)):
            blocks = dxt_blocks_of(img.resize((w, h)), kind)
            for alpha in (0, 8):
                cases[f"BLP2 {kind} {w}x{h} alpha {alpha}"] = blp_file(
                    2, w, h, blocks, 1, 2, alpha, code, palette=pal)
    return cases


@pytest.mark.parametrize("case", list(blp_cases()))
def test_blp_matches_pillow(case):
    assert_as_pillow(blp_cases()[case])


def test_blp_cases_reach_their_variant():
    for name, raw in blp_cases().items():
        if "short" not in name and "larger" not in name:
            assert_pillow_reads(raw, "BLP")


@FAST
@given(st.sampled_from([(0, 8), (1, 16), (7, 16)]), st.booleans(), st.data())
def test_random_dxt_blocks_match_blps_own_decoders(kind, alpha, data):
    """The port's vectorised DXT blocks equal BlpImagePlugin's decode_dxt1,
    decode_dxt3 and decode_dxt5 on random blocks (DXT1's three-colour
    blocks and alpha bit included)."""
    code, size = kind
    n = data.draw(st.integers(1, 6))
    raw = data.draw(st.binary(min_size=n * size, max_size=n * size))
    fn = {0: lambda d: BlpImagePlugin.decode_dxt1(d, alpha), 1: BlpImagePlugin.decode_dxt3,
          7: BlpImagePlugin.decode_dxt5}[code]
    rows = fn(raw)
    want = np.stack([np.frombuffer(bytes(r), np.uint8).reshape(n, 4, -1) for r in rows], 1)
    got = dxt_blocks(code, np.frombuffer(raw, np.uint8).reshape(n, size), alpha or code != 0)
    np.testing.assert_array_equal(got.reshape(n, 4, 4, -1), want)


@FAST
@given(st.sampled_from([0, 1, 7]), st.integers(1, 9), st.integers(1, 9), st.booleans(), st.data())
def test_random_blp2_dxt_files_match_pillow(code, w, h, alpha, data):
    size = 8 if code == 0 else 16
    n = ((w + 3) // 4) * ((h + 3) // 4) * size
    blocks = data.draw(st.binary(min_size=n, max_size=n))
    assert_as_pillow(blp_file(2, w, h, blocks, 1, 2, 8 if alpha else 0, code, palette=b""))


BLP_REFUSALS = {
    "BLP1 compression 2": (blp_file(1, 4, 4, bytes(16), 2, 5, palette=bytes(1024)),
                           "BLP1 compression 2"),
    "BLP1 encoding 3": (blp_file(1, 4, 4, bytes(16), 1, 3, palette=bytes(1024)),
                        "BLP1 encoding 3"),
    "BLP2 JPEG": (blp_file(2, 4, 4, bytes(16), 0, 1, palette=bytes(1024)), "BLP2 compression 0"),
    "BLP2 raw BGRA": (blp_file(2, 4, 4, bytes(64), 1, 3, palette=bytes(1024)),
                      r"BLP2 encoding 3 \(raw BGRA\)"),
    "BLP2 alpha encoding 2": (blp_file(2, 4, 4, bytes(16), 1, 2, 8, 2, palette=bytes(1024)),
                              "BLP2 alpha encoding 2"),
}


LEGACY_REFUSALS = {
    "FTEX format 2": (ftex_file(2, 4, 4, bytes(50)), "FTEX texture format 2"),
    "XPM named colour": (xpm_file(np.zeros((2, 3), np.int64), ["red"]), "XPM colour 'red'"),
    "ICNS GIF subimage": (icns_file([(b"icp4", b"GIF89a" + bytes(30))]), "ICNS subimage"),
    "IPTC compression 7": (iptc_file(bytes(12), (4, 3), compression=7),
                           "IPTC image compression"),
}


@pytest.mark.parametrize("variant", list(LEGACY_REFUSALS))
def test_legacy_variants_pillow_refuses_are_refused_by_name(variant):
    """Refusals that end Pillow's open or load: the port names each (the
    FTEX format, an XPM colour name, an ICNS subimage that is neither PNG
    nor JPEG 2000, an IPTC compression other than 1 and 5)."""
    raw, match = LEGACY_REFUSALS[variant]
    assert not isinstance(pillow_open(raw)[1], np.ndarray)
    assert_refused_by_name(raw, match)
    assert_as_pillow(raw)


@pytest.mark.parametrize("variant", list(BLP_REFUSALS))
def test_blp_variants_pillow_refuses_are_refused_by_name(variant):
    """Pillow's BLPFormatError (a NotImplementedError) ends the open at
    load: the port names the variant."""
    raw, match = BLP_REFUSALS[variant]
    fmt, want = pillow_open(raw)
    assert fmt == "BLP" and isinstance(want, NotImplementedError)
    assert image_format(raw) == "BLP"
    assert_refused_by_name(raw, match)


# ---- FITS ------------------------------------------------------------------------------------

def fits_data(bitpix, w, h, seed=0):
    rng = np.random.default_rng(seed)
    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    if bitpix < 0:
        return rng.normal(60, 120, (h, w)).astype(dt).tobytes()
    return rng.integers(-(2**15), 2**15, (h, w)).astype(dt).tobytes()


@pytest.mark.parametrize("bitpix", [8, 16, 32, -32, -64])
@pytest.mark.parametrize("pad", [0, 2880], ids=["bare", "padded"])
def test_fits_every_bitpix_matches_pillow(bitpix, pad):
    raw = fits_file(bitpix, 7, 5, fits_data(bitpix, 7, 5, bitpix % 7) + bytes(pad))
    assert_pillow_reads(raw, "FITS")


def test_fits_byte_order_is_pillows():
    """Pillow reads a 16-bit big-endian sample 0x0001 as little-endian
    256 (clipped to 255): the port keeps the quirk."""
    raw = fits_file(16, 2, 1, struct.pack(">hh", 1, 0x100) + bytes(200))
    np.testing.assert_array_equal(decode_image_u8(raw)[0, :, 0], [255, 1])
    assert_pillow_reads(raw, "FITS")


@pytest.mark.parametrize("case", ["short data unit", "naxis 1", "comment and equals",
                                  "no image", "cut in header", "not T", "bad number",
                                  "naxis 0 then extension"])
def test_fits_headers_match_pillow(case):
    d = fits_data(8, 6, 4, 3)
    raw = {
        "short data unit": fits_file(8, 6, 4, d),  # 24 bytes: the offset lies in the padding
        "naxis 1": fits_file(8, 6, 1, d[:6] + bytes(100), naxis=1),
        "comment and equals": fits_file(8, 6, 4, d + bytes(90),
                                        extra=[b"OBJECT  = 'M31' / a galaxy".ljust(80)]),
        "no image": fits_file(8, 0, 0, bytes(100), naxis=0),
        "cut in header": fits_file(8, 6, 4, d)[:200],
        "not T": fits_file(8, 6, 4, d).replace(b"= " + b"T".rjust(20), b"= " + b"F".rjust(20), 1),
        "bad number": fits_file(8, 6, 4, d + bytes(90)).replace(b"6".rjust(20), b"x".rjust(20), 1),
        "naxis 0 then extension": fits_file(8, 0, 0, b"", naxis=0) + fits_file(
            8, 6, 4, d + bytes(90)).replace(b"SIMPLE  ", b"XTENSION", 1),
    }[case]
    assert_as_pillow(raw)


@pytest.mark.parametrize("bitpix", [8, 16, 32, -32])
def test_fits_gzip_matches_pillow(bitpix):
    v = np.random.default_rng(bitpix + 40).integers(-(2**31), 2**31, (5, 6))
    raw = fits_gzip_file(bitpix, 6, 5, v)
    assert_as_pillow(raw)
    if bitpix > 0:
        assert_pillow_reads(raw, "FITS")


# ---- FLI / FLC -------------------------------------------------------------------------------

def fli_lc(lines, first=0) -> bytes:
    """An LC chunk: `lines` a list of [(skip, bytes or (count, value))]."""
    body = struct.pack("<HH", first, len(lines))
    for packets in lines:
        body += bytes([len(packets)])
        for skip, what in packets:
            if isinstance(what, tuple):
                body += bytes([skip, 256 - what[0], what[1]])
            else:
                body += bytes([skip, len(what)]) + what
    return fli_chunk(12, body)


def fli_ss2(lines) -> bytes:
    """An SS2 chunk: `lines` a list of (flag words, [(skip, words or
    (count, word))])."""
    body = struct.pack("<H", len(lines))
    for flags, packets in lines:
        for f in flags:
            body += struct.pack("<H", f)
        body += struct.pack("<H", len(packets))
        for skip, what in packets:
            if isinstance(what, tuple):
                body += bytes([skip, 256 - what[0]]) + what[1]
            else:
                body += bytes([skip, len(what) // 2]) + what
    return fli_chunk(7, body)


def fli_cases():
    rng = np.random.default_rng(14)
    w, h = 10, 6
    idx = rng.integers(0, 8, (h, w), np.uint8)
    idx[2, 3:8] = 5
    pal = rng.integers(0, 256, (256, 3), np.uint8)
    colour = fli_colour([(0, pal)])
    return {
        "FLC BRUN": fli_file(w, h, [colour, fli_brun(idx)]),
        "FLI BRUN, COLOR 64": fli_file(w, h, [fli_colour([(2, pal[:20] // 4)], 2), fli_brun(idx)],
                                       magic=0xAF11),
        "COPY": fli_file(w, h, [colour, fli_chunk(16, idx.tobytes())]),
        "BLACK after COPY": fli_file(w, h, [fli_chunk(16, idx.tobytes()), fli_chunk(13, bytes(4))]),
        "BLACK of 6 bytes, the frame's last": fli_file(w, h, [fli_chunk(13, b"")]),
        "LC": fli_file(w, h, [colour, fli_lc([[(1, b"\x03\x04"), (2, (3, 9))], [],
                                              [(0, (10, 2))]], first=2)]),
        "SS2": fli_file(w, h, [colour, fli_ss2([((), [(1, b"\x01\x02\x03\x04"), (1, (2, b"\x07\x08"))]),
                                                ((0xFFFE,), [(0, b"\x09\x0a")]),
                                                ((0x8011,), [(2, (1, b"\x05\x06"))])])]),
        "PSTAMP then BRUN": fli_file(w, h, [fli_chunk(18, bytes(20)), colour, fli_brun(idx)]),
        "palette packets skip and 256": fli_file(w, h, [fli_colour([(5, pal[:3]), (1, pal[:4])]),
                                                        fli_brun(idx)]),
        "palette packet of 256": fli_file(w, h, [fli_colour([(0, pal)]), fli_brun(idx)]),
        "palette past 256": fli_file(w, h, [fli_colour([(250, pal[:10])]), fli_brun(idx)]),
        "COLOR level over 63": fli_file(w, h, [fli_colour([(0, pal[:4] | 64)], 2), fli_brun(idx)]),
        "prefix chunk": fli_file(w, h, [colour, fli_brun(idx)], prefix=bytes(8)),
        "unknown chunk": fli_file(w, h, [fli_chunk(99, bytes(4))]),
        "BRUN short": fli_file(w, h, [fli_brun(idx[:, :9])]),
        "LC past the image": fli_file(w, h, [fli_lc([[(9, b"\x01\x02")]])]),
        "frame cut": fli_file(w, h, [colour, fli_brun(idx)])[:-20],
        "bad header": bytes(fli_file(w, h, [fli_brun(idx)])[:20]) + b"\1" + bytes(200),
    }


@pytest.mark.parametrize("case", list(fli_cases()))
def test_fli_matches_pillow(case):
    assert_as_pillow(fli_cases()[case])


def test_fli_cases_reach_their_variant():
    cases = fli_cases()
    for name in ("FLC BRUN", "FLI BRUN, COLOR 64", "COPY", "BLACK after COPY", "LC", "SS2",
                 "PSTAMP then BRUN", "palette packets skip and 256", "palette packet of 256",
                 "COLOR level over 63"):
        assert_pillow_reads(cases[name], "FLI")
    assert pillow_open(cases["palette past 256"])[0] is None  # IndexError: passed on


@FAST
@given(st.integers(1, 12), st.integers(1, 6), st.sampled_from([7, 12, 15, 16, 13]), st.data())
def test_random_fli_chunks_match_pillow(w, h, kind, data):
    """A frame of one random chunk body of each drawn kind (and its size
    as written) against FliDecode.c."""
    body = data.draw(st.binary(min_size=0, max_size=60))
    if kind == 12 and data.draw(st.booleans()):
        body = struct.pack("<HH", data.draw(st.integers(0, h)), data.draw(st.integers(0, h))) + body
    if kind == 7 and data.draw(st.booleans()):
        body = struct.pack("<H", data.draw(st.integers(0, h))) + body
    assert_as_pillow(fli_file(w, h, [fli_colour([(0, np.arange(48).reshape(16, 3))]),
                                     fli_chunk(kind, body)]))


@FAST
@given(st.integers(1, 16), st.integers(1, 5), st.data())
def test_random_brun_rows_match_pillow(w, h, data):
    idx = np.array(data.draw(st.lists(st.integers(0, 3), min_size=w * h, max_size=w * h)),
                   np.uint8).reshape(h, w)
    assert_as_pillow(fli_file(w, h, [fli_brun(idx)]))


# ---- FTEX, GBR, PIXAR ------------------------------------------------------------------------

def test_ftex_matches_pillow():
    img = Image.fromarray(rgba(9, 14, 15))
    for w, h in ((14, 9), (16, 8)):
        im2 = img.resize((w, h))
        assert_pillow_reads(ftex_file(0, w, h, dxt_blocks_of(im2, "DXT1")), "FTEX")
        assert_pillow_reads(ftex_file(1, w, h, np.asarray(im2.convert("RGB")).tobytes()), "FTEX")
    assert_as_pillow(ftex_file(0, 14, 9, bytes(50)))
    assert_as_pillow(ftex_file(2, 4, 4, bytes(50)))
    two_formats = bytearray(ftex_file(1, 2, 2, bytes(12)))
    struct.pack_into("<i", two_formats, 20, 2)
    assert_as_pillow(bytes(two_formats))


@FAST
@given(st.integers(1, 9), st.integers(1, 9), st.data())
def test_random_ftex_dxt1_matches_pillow(w, h, data):
    n = ((w + 3) // 4) * ((h + 3) // 4) * 8
    assert_as_pillow(ftex_file(0, w, h, data.draw(st.binary(min_size=n, max_size=n))))


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("bands", [1, 4])
def test_gbr_matches_pillow(version, bands):
    px = rgba(7, 10, 16 + bands)
    px = px[..., 0] if bands == 1 else px
    assert_pillow_reads(gbr_file(np.ascontiguousarray(px), version), "GBR")
    assert_as_pillow(gbr_file(np.ascontiguousarray(px), version)[:-3])


def test_gbr_headers_pillow_turns_away_pass_on():
    bad_magic = gbr_file(np.zeros((2, 2), np.uint8)).replace(b"GIMP", b"PMIG")
    depth3 = struct.pack(">5I", 21, 1, 2, 2, 3) + b"\0" + bytes(12)
    for raw in (bad_magic, depth3):
        assert pillow_open(raw)[0] is None
        assert_as_pillow(raw)


def test_pixar_matches_pillow():
    rgb = picture(6, 11, 17)
    assert_pillow_reads(pixar_file(rgb), "PIXAR")
    assert_as_pillow(pixar_file(rgb, kind=(14, 3)))
    assert_as_pillow(pixar_file(rgb)[:-7])
    assert_as_pillow(pixar_file(rgb)[:300])


# ---- ICNS ------------------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "LA", "P"])
def test_pillow_written_icns_matches_pillow(mode):
    """Pillow writes PNG entries of every size: the 1024x1024 ic10 is
    the one read."""
    img = pillow_modes(12, 12, seed=18)[mode]
    assert_pillow_reads(save(img, "ICNS"), "ICNS")


def icns_cases():
    rng = np.random.default_rng(19)
    rgb128 = picture(128, 128, 19)
    rgb128[40:60] = 7
    mask = rng.integers(0, 256, (128, 128), np.uint8)
    rgb16, rgb32 = picture(16, 16, 20), picture(32, 32, 21)
    p16 = Image.fromarray(rgb16).quantize(8)
    p16.info["transparency"] = 3
    la = Image.fromarray(rgba(16, 16, 22)[..., :2], "LA")
    return {
        "it32 RLE + t8mk": icns_file([(b"it32", b"\0" * 4 + icns_rgb32(rgb128)),
                                      (b"t8mk", mask.tobytes())]),
        "it32 RLE, no mask": icns_file([(b"it32", b"\0" * 4 + icns_rgb32(rgb128))]),
        "il32 raw + l8mk": icns_file([(b"il32", icns_rgb32(rgb32, rle=False)),
                                      (b"l8mk", mask[:32, :32].tobytes())]),
        "is32 RLE + ih32": icns_file([(b"is32", icns_rgb32(rgb16)),
                                      (b"ih32", icns_rgb32(picture(48, 48, 23)))]),
        "icp4 PNG with tRNS": icns_file([(b"icp4", save(p16, "PNG"))]),
        "icp4 LA PNG": icns_file([(b"icp4", save(la, "PNG"))]),
        "ic07 over it32": icns_file([(b"it32", b"\0" * 4 + icns_rgb32(rgb128)),
                                     (b"ic07", save(Image.fromarray(rgb128[:64, :64]), "PNG"))]),
        "icp4 JPEG 2000": icns_file([(b"icp4", save(Image.fromarray(rgb16), "JPEG2000",
                                                    irreversible=False))]),
        "it32 without its zeros": icns_file([(b"it32", b"\1" * 4 + icns_rgb32(rgb128))]),
        "is32 runs over": icns_file([(b"is32", icns_rgb32(rgb16) + b"\x85\x01")]),
        "is32 cut": icns_file([(b"is32", icns_rgb32(rgb16)[:-30])]),
        "mask only": icns_file([(b"s8mk", mask[:16, :16].tobytes())]),
        "PNG of another size": icns_file([(b"icp4", save(Image.fromarray(rgb16[:5, :7]), "PNG"))]),
        "unknown subimage": icns_file([(b"icp4", b"GIF89a" + bytes(30))]),
        "no known block": icns_file([(b"TOC ", bytes(8))]),
        "block list cut": icns_file([(b"is32", icns_rgb32(rgb16)),
                                     (b"s8mk", mask[:16, :16].tobytes())])[:-260],
    }


@pytest.mark.parametrize("case", list(icns_cases()))
def test_icns_matches_pillow(case):
    assert_as_pillow(icns_cases()[case])


def test_icns_cases_reach_their_variant():
    cases = icns_cases()
    for name in ("it32 RLE + t8mk", "il32 raw + l8mk", "is32 RLE + ih32", "icp4 PNG with tRNS",
                 "icp4 LA PNG", "ic07 over it32", "icp4 JPEG 2000"):
        assert_pillow_reads(cases[name], "ICNS")
    assert pillow_open(cases["block list cut"])[0] is None  # struct.error: passed on


@FAST
@given(st.lists(st.integers(0, 255), min_size=0, max_size=80), st.data())
def test_random_icns_runs_match_pillow(ops, data):
    """Random run/literal bytes for is32's three channels (16x16 each)."""
    body = bytes(ops) + data.draw(st.binary(min_size=0, max_size=800))
    assert_as_pillow(icns_file([(b"is32", body)]))


# ---- MSP, SUN, XBM, XPM ----------------------------------------------------------------------

@pytest.mark.parametrize("size", IM_SIZES + [(9, 30)], ids=str)
def test_msp_matches_pillow(size):
    bits = pillow_modes(*size, seed=size[0] + 30)["1"]
    assert_pillow_reads(save(bits, "MSP"), "MSP")
    b = np.asarray(bits).astype(np.uint8)
    b[: size[0] // 2] = 1
    assert_pillow_reads(msp2_file(b), "MSP")


def test_msp_rows_follow_pillow():
    """A blank row, a row that decodes longer than the stride (the rest
    shifts, as in Pillow), a run cut short, a row cut short."""
    rows = [b"", bytes([0, 3, 0x0F]), bytes([2, 0xAA, 0x55, 0, 2, 1]), bytes([0, 2, 0x80])]
    bits = np.zeros((4, 16), np.uint8)
    assert_pillow_reads(msp2_file(bits, rows), "MSP")
    assert_as_pillow(msp2_file(bits, rows[:3] + [bytes([0, 2])]))
    assert_as_pillow(msp2_file(bits, rows)[:-2])
    bad = bytearray(save(pillow_modes(3, 9)["1"], "MSP"))
    bad[10] ^= 1
    assert pillow_open(bytes(bad))[0] is None
    assert_as_pillow(bytes(bad))


@FAST
@given(st.integers(1, 20), st.integers(1, 4), st.data())
def test_random_msp_rows_match_pillow(w, h, data):
    rows = [data.draw(st.binary(min_size=0, max_size=12)) for _ in range(h)]
    assert_as_pillow(msp2_file(np.zeros((h, w), np.uint8), rows))


def sun_cases():
    rng = np.random.default_rng(24)
    w, h = 7, 5
    rgb = picture(h, w, 24)
    grey = rng.integers(0, 256, (h, w), np.uint8)
    bits = rng.integers(0, 2, (h, w), np.uint8)
    nib = rng.integers(0, 16, (h, w), np.uint8)
    cmap = rng.integers(0, 256, 3 * 40, np.uint8).tobytes()
    bgrx = np.concatenate([rgb[..., ::-1], np.full((h, w, 1), 9, np.uint8)], -1)
    cases = {}
    for rle in (False, True):
        r = " RLE" if rle else ""
        cases[f"depth 1{r}"] = sun_file(sun_rows(bits, 1, not rle), w, 1, rle=rle)
        cases[f"depth 4{r}"] = sun_file(sun_rows(nib, 4, not rle), w, 4, rle=rle)
        cases[f"depth 4 colour map{r}"] = sun_file(sun_rows(nib, 4, not rle), w, 4, 1, cmap, rle)
        cases[f"depth 8{r}"] = sun_file(sun_rows(grey, 8, not rle), w, 8, rle=rle)
        cases[f"depth 8 colour map{r}"] = sun_file(sun_rows(grey % 40, 8, not rle), w, 8, 1, cmap,
                                                   rle)
        cases[f"depth 24 BGR{r}"] = sun_file(sun_rows(rgb[..., ::-1], 24, not rle), w, 24, 1,
                                             rle=rle)
        cases[f"depth 32 BGRX{r}"] = sun_file(sun_rows(bgrx, 32, not rle), w, 32, 1, rle=rle)
    cases["depth 24 RGB type 3"] = sun_file(sun_rows(rgb, 24), w, 24, 3)
    cases["depth 32 RGBX type 3"] = sun_file(sun_rows(bgrx[..., [2, 1, 0, 3]], 32), w, 32, 3)
    cases["depth 8 colour map not a multiple of 3"] = sun_file(sun_rows(grey % 10, 8), w, 8, 1,
                                                               cmap[:31])
    cases["RLE 0x80 bytes"] = sun_file(sun_rows(np.full((h, w), 0x80, np.uint8), 8, False), w, 8,
                                       rle=True)
    cases["RLE cut"] = sun_file(sun_rows(grey, 8, False), w, 8, rle=True)[:-3]
    cases["raw cut"] = sun_file(sun_rows(grey, 8), w, 8)[:-3]
    cases["depth 16"] = sun_file(sun_rows(grey, 8), w, 16)
    cases["file type 6"] = sun_file(sun_rows(grey, 8), w, 8, 6)
    cases["colour map type 2"] = sun_file(sun_rows(grey, 8), w, 8, 1, cmap)[:24] + struct.pack(
        ">I", 2) + sun_file(sun_rows(grey, 8), w, 8, 1, cmap)[28:]
    return cases


@pytest.mark.parametrize("case", list(sun_cases()))
def test_sun_matches_pillow(case):
    assert_as_pillow(sun_cases()[case])


def test_sun_cases_reach_their_variant():
    for name, raw in sun_cases().items():
        if not any(k in name for k in ("cut", "16", "type 6", "type 2")):
            assert_pillow_reads(raw, "SUN")


@FAST
@given(st.sampled_from([1, 8, 24, 32]), st.integers(1, 9), st.integers(1, 4), st.data())
def test_random_sun_rle_matches_pillow(depth, w, h, data):
    """Random RLE streams, runs carried over rows and 0x80 escapes."""
    ops = data.draw(st.lists(st.one_of(st.integers(0, 255).map(lambda b: bytes([b])),
                                       st.tuples(st.integers(0, 255), st.integers(0, 255)).map(
                                           lambda t: bytes([0x80, t[0], t[1]]))),
                             min_size=0, max_size=40))
    body = b"".join(ops)
    head = struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), 2, 0, 0)
    assert_as_pillow(head + body)


@pytest.mark.parametrize("size", IM_SIZES + [(6, 20)], ids=str)
def test_pillow_written_xbm_matches_pillow(size):
    img = pillow_modes(*size, seed=size[1] + 40)["1"]
    assert_pillow_reads(save(img, "XBM"), "XBM")
    assert_pillow_reads(save(img, "XBM", hotspot=(1, 2)), "XBM")


@FAST
@given(st.integers(1, 12), st.integers(1, 4), st.text(alphabet="0x1fFgA, \n", max_size=120))
def test_random_xbm_bytes_match_pillow(w, h, text):
    """Random text after the header: every "x" and its two bytes, hex
    digits or not, as XbmDecode.c reads them."""
    raw = b"#define t_width %d\n#define t_height %d\nstatic char t_bits[] = {" % (w, h)
    assert_as_pillow(raw + text.encode())


def xpm_cases():
    rng = np.random.default_rng(25)
    cols = ["#%06x" % v for v in rng.integers(0, 2**24, 300)]
    idx = rng.integers(0, 12, (5, 7))
    big = rng.integers(0, 300, (9, 40))
    keys3 = [b"%03d" % k for k in range(301)]
    return {
        "P": xpm_file(idx, cols[:12]),
        "P no pixels comment": xpm_file(idx, cols[:12], pixel_header=False),
        "P two-char keys": xpm_file(idx, cols[:12], bpp=2),
        "RGB over 256 colours": xpm_file(big, cols),
        "None unused": xpm_file(idx + 1, ["None"] + cols[:12]),
        "None used": xpm_file(idx, ["None"] + cols[:12]),
        "RGB by the header: 257 one-char keys": xpm_file(rng.integers(0, 257, (5, 7)),
                                                         cols[:257], bpp=1),
        "RGB by the header: 256 colours + None": xpm_file(rng.integers(1, 257, (5, 7)),
                                                          ["None"] + cols[:256]),
        "RGB 300 colours + None, two-char keys": xpm_file(big + 1, ["None"] + cols, bpp=2),
        "RGB 300 colours + None, three-char keys": xpm_file(big + 1, ["None"] + cols,
                                                            keys=keys3, bpp=3),
        "short hex": xpm_file(idx, ["#abc"] + cols[:11]),
        "named colour": xpm_file(idx, ["red"] + cols[:11]),
        "lines of other widths": xpm_file(idx, cols[:12]).replace(
            b"/* pixels */", b'/* pixels */\n"' + b"a" * 3 + b'",\n"' + b"b" * 9 + b'",'),
        "too few pixels": xpm_file(idx[:3], cols[:12]).replace(b'"7 3', b'"7 5', 1),
        "no size line": b"/* XPM */\nstatic char *x[] = {\n};\n",
    }


@pytest.mark.parametrize("case", list(xpm_cases()))
def test_xpm_matches_pillow(case):
    assert_as_pillow(xpm_cases()[case])


def test_xpm_cases_reach_their_variant():
    cases = xpm_cases()
    for name in ("P", "P no pixels comment", "P two-char keys", "RGB over 256 colours",
                 "None unused", "short hex", "lines of other widths"):
        assert_pillow_reads(cases[name], "XPM")
    assert Image.open(io.BytesIO(cases["RGB by the header: 257 one-char keys"])).mode == "RGB"
    assert_pillow_reads(cases["RGB by the header: 257 one-char keys"], "XPM")
    for name in ("None used", "named colour", "too few pixels"):
        assert not isinstance(pillow_open(cases[name])[1], np.ndarray), name


@pytest.mark.parametrize("case", ["RGB by the header: 256 colours + None",
                                  "RGB 300 colours + None, two-char keys",
                                  "RGB 300 colours + None, three-char keys"])
def test_rgb_xpm_with_none_is_refused_by_name(case):
    """A palette length above 256 makes the image RGB even where its
    colours, "None" left out, are 256; Pillow opens it as XPM and its
    convert("RGBA") raises TypeError on the "None" key's bytes, whatever
    their length: the port names the file XPM and refuses it by name."""
    raw = xpm_cases()[case]
    im = Image.open(io.BytesIO(raw))
    assert (im.format, im.mode) == ("XPM", "RGB") and "transparency" in im.info
    with pytest.raises(TypeError):
        im.convert("RGBA")
    assert image_format(raw, "") == "XPM"
    assert_refused_by_name(raw, "with a 'None' colour")


@pytest.mark.parametrize("none", [False, True])
@pytest.mark.parametrize("colours", [12, 300])
@pytest.mark.parametrize("bpp", [7, 8, 9, 12, 16])
def test_xpm_keys_of_any_length_match_pillow(bpp, colours, none):
    """Keys longer than 7 bytes, as Pillow 12.1.0 reads them ("P" up to 256
    palette lines, "RGB" above; an RGB image with "None" stays refused by
    name, as Pillow's convert raises TypeError on it)."""
    rng = np.random.default_rng(bpp * 10 + colours + none)
    cols = ["#%06x" % v for v in rng.integers(0, 1 << 24, colours)]
    keys = [b"%0*d" % (bpp, k) for k in range(colours)]
    if none:
        cols, keys = ["None"] + cols, [b"N" * bpp] + keys
    raw = xpm_file(rng.integers(0, len(cols), (5, 7)), cols, keys=keys, bpp=bpp)
    if none and colours > 256:
        assert_refused_by_name(raw, "with a 'None' colour")
    else:
        assert_as_pillow(raw)
        assert isinstance(pillow_open(raw)[1], np.ndarray) or none  # "None" used: refused


def test_xpm_none_sets_alphas_from_the_key_bytes():
    """Pillow's transparency is the "None" key's bytes, which its convert
    reads as the alphas of palette entries 0, 1, ...: key "." (46) makes
    entry 0's alpha 46."""
    raw = xpm_cases()["None unused"]
    got = decode_image_u8(raw)
    idx0 = np.argwhere(np.asarray(Image.open(io.BytesIO(raw))) == 0)
    assert len(idx0) and got[tuple(idx0[0])][3] == ord(".")


@FAST
@given(st.integers(1, 6), st.integers(1, 3), st.sampled_from([1, 2]), st.booleans(),
       st.sampled_from([0, 252]), st.data())
def test_random_xpm_pixels_match_pillow(w, h, bpp, none, extra, data):
    """Random pixel text, with or without a "None" key ("X"), under a
    palette length of 5 ("P") or, with 252 more lines that repeat key
    "a", of 257 ("RGB")."""
    keys = [bytes([97 + k]) * bpp for k in range(5)] + [b"a" * bpp] * extra
    text = data.draw(st.lists(st.text(alphabet='abcdeX"', max_size=14), min_size=0, max_size=5))
    raw = (b'/* XPM */\n"%d %d %d %d",\n' % (w, h, len(keys) + none, bpp)
           + b"".join(b'"%s c #%06x",\n' % (k, 4099 * i) for i, k in enumerate(keys))
           + (b'"%s c None",\n' % (b"X" * bpp) if none else b"")
           + b"".join(b'"' + t.encode() + b'",\n' for t in text))
    assert_as_pillow(raw)


# ---- the RGBA conversions --------------------------------------------------------------------

@pytest.mark.parametrize("module, derive", [(modes, ycbcr_tables), (pcd, photo_ycc_tables)],
                         ids=["YCbCr", "PhotoYCC"])
def test_ycc_tables_are_read_back_from_pillow(module, derive):
    """The committed YCC tables are what tests/derive_ycc_tables.py reads
    back from Pillow now."""
    np.testing.assert_array_equal(module.YCC_TABLES, derive())


def test_ycbcr_to_rgb_on_every_input():
    """utils/modes.py's YCbCr tables equal Pillow's conversion on all
    2**24 (y, cb, cr), 16 values of y at a time."""
    for lumas in np.arange(256).reshape(16, 16):
        ycc = every_ycc(lumas)
        want = np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB"))
        np.testing.assert_array_equal(modes.ycbcr_to_rgb(ycc), want)


def conversion_cases():
    rng = np.random.default_rng(26)
    h, w = 6, 9
    u8 = lambda *s: rng.integers(0, 256, (h, w, *s), np.uint8)  # noqa: E731
    pal = rng.integers(0, 256, (256, 3), np.uint8)
    bits = u8() > 127
    return {
        "1": (Image.fromarray(bits), ("1", bits * np.uint8(255))),
        "L": (Image.fromarray(u8()), None),
        "LA": (Image.fromarray(u8(2), "LA"), None),
        "I;16": (Image.fromarray(rng.integers(0, 65536, (h, w)).astype(np.uint16)), None),
        "I": (Image.fromarray(rng.integers(-70000, 70000, (h, w)).astype(np.int32)), None),
        "F": (Image.fromarray(rng.normal(100, 300, (h, w)).astype(np.float32)), None),
        "CMYK": (Image.fromarray(u8(4), "CMYK"), None),
        "YCbCr": (Image.fromarray(u8(3), "YCbCr"), None),
        "RGB": (Image.fromarray(u8(3)), None),
        "RGBA": (Image.fromarray(u8(4)), None),
        "P": ("P", pal, None),
        "P transparency index": ("P", pal, 7),
        "P transparency bytes": ("P", pal, bytes(rng.integers(0, 256, 20, np.uint8))),
        "PA": ("PA", pal, None),
    }


@pytest.mark.parametrize("case", list(conversion_cases()))
def test_to_rgba_matches_pillows_convert(case):
    """utils/modes.py `to_rgba` on random arrays (values that clip
    included) equals Pillow's convert("RGBA")."""
    spec = conversion_cases()[case]
    if isinstance(spec[0], str):
        mode, pal, trns = spec
        rng = np.random.default_rng(27)
        idx = rng.integers(0, 256, (6, 9), np.uint8)
        if mode == "PA":
            alpha = rng.integers(0, 256, (6, 9), np.uint8)
            img = Image.fromarray(np.stack([idx, alpha], -1), "LA").convert("L")
            img = Image.frombytes("PA", (9, 6), np.stack([idx, alpha], -1).tobytes())
            img.putpalette(pal.tobytes())
            got = modes.to_rgba("PA", np.stack([idx, alpha], -1), pal)
        else:
            img = Image.fromarray(idx, "P")
            img.putpalette(pal.tobytes())
            if trns is not None:
                img.info["transparency"] = trns
            got = modes.to_rgba("P", idx, pal, trns)
        np.testing.assert_array_equal(got, np.asarray(img.convert("RGBA")))
        return
    img, override = spec
    mode, px = override or (img.mode, np.asarray(img))
    np.testing.assert_array_equal(modes.to_rgba(mode, px), np.asarray(img.convert("RGBA")))


# ---- the committed fixtures ------------------------------------------------------------------

def legacy_manifest() -> dict:
    with open(os.path.join(LEGACY_FIXTURES, "manifest.json")) as f:
        return json.load(f)


def legacy_fixture(name: str) -> bytes:
    with open(os.path.join(LEGACY_FIXTURES, name), "rb") as f:
        return f.read()


def test_legacy_fixture_writer_makes_the_committed_set(tmp_path):
    """make_legacy_fixtures runs, and writes the committed files' names,
    expectations and bytes (its own 3 MiB)."""
    made = make_legacy_fixtures(str(tmp_path))
    assert made == legacy_manifest()
    for name in os.listdir(tmp_path):
        assert (tmp_path / name).read_bytes() == legacy_fixture(name), name
    total = sum(os.path.getsize(os.path.join(LEGACY_FIXTURES, n))
                for n in os.listdir(LEGACY_FIXTURES))
    assert total <= 3 * 2**20


@pytest.mark.parametrize("entry", legacy_manifest()["images"], ids=lambda e: e["file"])
def test_committed_legacy_fixture_matches_pillow(entry):
    """Each committed expectation (or digest, above 256 KiB) is Pillow's
    decode of the committed file, its format Pillow's, and the port's
    decode and format equal them."""
    raw = legacy_fixture(entry["file"])
    want = pillow(raw)
    if "expect" in entry:
        np.testing.assert_array_equal(np.load(os.path.join(LEGACY_FIXTURES, entry["expect"])),
                                      want)
    else:
        assert list(want.shape) == entry["shape"] and sha256_rgba(want) == entry["sha256"]
    assert Image.open(io.BytesIO(raw)).format == entry["format"]
    assert image_format(raw, entry["file"]) == entry["format"]
    np.testing.assert_array_equal(decode_image_u8(raw, entry["file"]), want)


def test_legacy_fixtures_cover_each_new_decoder():
    formats = {e["format"] for e in legacy_manifest()["images"]}
    assert formats == {"IM", "IMT", "IPTC", "PCD", "SPIDER", "BLP", "FITS", "FLI", "FTEX", "GBR",
                       "ICNS", "MSP", "PIXAR", "SUN", "XBM", "XPM"}


def test_committed_breaktime_legacy_pair():
    """The legacy GLB's textures are, in order, the kinds LEGACY_TEXTURES
    names under LEGACY_MIMES, and their Pillow decodes are the twin's PNGs."""
    scene = legacy_manifest()["scene"]
    files = glb_images(legacy_fixture(scene["legacy"]))
    pngs = glb_images(legacy_fixture(scene["legacy_twin"]))
    assert len(files) == len(pngs) == 6
    kinds = [Image.open(io.BytesIO(f)).format for f in files]
    assert kinds == ["IPTC", "IM", "BLP", "XPM", "MCIDAS", "PNG"]
    assert b"II*\x00" in files[0][:64]  # the record holds a TIFF
    assert Image.open(io.BytesIO(files[5])).n_frames == 2  # an APNG
    assert files[2][:4] == b"BLP2" and files[2][8:11] == bytes([2, 8, 7])  # DXT5 with alpha
    assert b'"128 128 256 8"' in files[3]  # 8-byte keys
    assert struct.unpack_from(">i", files[4], 40)[0] == 2  # 16-bit words
    for f, png in zip(files, pngs):
        assert png[:4] == b"\x89PNG"
        np.testing.assert_array_equal(pillow(f), pillow(png))
        np.testing.assert_array_equal(decode_image_u8(f), pillow(png))
    doc, _ = read_glb(legacy_fixture(scene["legacy"]))
    assert [img["mimeType"] for img in doc["images"]] == LEGACY_MIMES
    assert LEGACY_TEXTURES[1] == "IM RGB"


# ---- edits of the committed fixtures against Pillow (queue 3's fuzz) --------------------------

def legacy_fuzz(n: int, seed: int = 0) -> dict:
    """`n` random edits of every committed fixture of formats_legacy
    (tests/test_torch_image_formats_variants.py `edit_fuzz`) -> counts of
    (kind, outcome); raises AssertionError at the first disagreement."""
    from tests.test_torch_image_formats_variants import edit_fuzz

    names = [e["file"] for e in legacy_manifest()["images"]]
    return edit_fuzz([(name, legacy_fixture(name)) for name in names], n, seed)


@pytest.mark.parametrize("seed", range(4))
def test_edited_legacy_fixtures_decode_as_pillow_decodes_them(seed):
    """A fixed 4 x 5 edits of each legacy fixture (`--fuzz` runs more)."""
    assert sum(legacy_fuzz(5, seed).values()) == 5 * len(legacy_manifest()["images"])


LEGACY_EDITED = {  # what the fuzz found (an ICNS entry's PNG), each now as Pillow reads it
    "PNG stream run on past its rows into other bytes":
        ("icns-png.icns", "insert", 0.8814343059906473, 53284),
    "PNG IHDR of fewer than 13 bytes: refused": ("icns-png.icns", "flip", 0.03892571614388596,
                                                 49913),
    "PNG cut inside IHDR: refused": ("icns-png.icns", "cut", 0.03961777792918686, 47969),
}


@pytest.mark.parametrize("case", list(LEGACY_EDITED))
def test_legacy_edits_the_fuzz_found(case):
    from tests.test_torch_image_formats_variants import assert_as_pillow, edit

    name, kind, where, value = LEGACY_EDITED[case]
    assert_as_pillow(edit(legacy_fixture(name), kind, where, value), name)


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--fuzz"]:  # --fuzz N [SEED]: edits of each legacy fixture
        print(json.dumps(legacy_fuzz(int(sys.argv[2]), int(sys.argv[3]) if sys.argv[3:] else 0)))
