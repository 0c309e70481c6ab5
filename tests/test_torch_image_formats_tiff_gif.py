"""The port's GIF (rustic_tpu_torch/utils/gif.py) and TIFF (utils/tiff.py)
decoders against Pillow 12.1.0 (libtiff 4.7.1, zlib 1.2.13), which the JAX
package decodes them with.

Files are written by Pillow, or by the writers of
tests/test_torch_image_formats.py (`gif_raw`: LZW literals, any index,
local tables, frames placed on a larger screen; `write_tiff`: strips or
tiles, planar configuration 1 or 2, none, LZW, Deflate and PackBits, the
horizontal predictor, both byte orders), and `decode_image_u8` must give
Pillow's `np.asarray(Image.open(...).convert("RGBA"))` bit for bit. Every
variant the decoders refuse raises NotImplementedError naming it and
ROADMAP queue 3, among them the layouts where Pillow's own reading is
wrong (noted at each).
"""

import io
import itertools
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from rustic_tpu_torch.utils.png import decode_image_u8
from tests.test_torch_image_formats import (assert_pillow_equal, gif_raw, picture, pillow,
                                            pillow_modes, rgba, save, write_tiff)
from tests.test_torch_image_formats_variants import planar_jpeg_tiff

# ---- GIF ------------------------------------------------------------------------------------

GIF_SIZES = [(1, 1), (5, 7), (20, 33), (37, 16)]
GIF_GRID = [(c, t, i, hw) for c in (2, 4, 16, 256) for t in (False, True) for i in (False, True)
            for hw in GIF_SIZES]


@pytest.mark.parametrize("colours, transparency, interlace, size", GIF_GRID)
def test_gif_grid_matches_pillow(colours, transparency, interlace, size):
    img = Image.fromarray(picture(*size)).quantize(colours)
    kw = dict(interlace=interlace, **(dict(transparency=1) if transparency else {}))
    raw = save(img, "GIF", **kw)
    assert Image.open(io.BytesIO(raw)).mode == "P"
    assert_pillow_equal(raw)


def rng_idx(h, w, top, seed=0):
    return np.random.default_rng(seed).integers(0, top, (h, w))


RAMP = np.repeat(np.arange(16)[:, None], 3, 1)  # a grey ramp: Pillow opens it as "L"
PALETTE = np.random.default_rng(1).integers(0, 256, (16, 3))

GIF_CASES = {
    "grey L": lambda: save(pillow_modes(9, 14)["L"], "GIF"),
    "grey L with transparency": lambda: save(pillow_modes(9, 14)["L"], "GIF", transparency=40),
    "bilevel 1": lambda: save(pillow_modes(9, 14)["1"], "GIF"),
    "no colour table (L)": lambda: gif_raw(rng_idx(6, 9, 256), None),
    "grey-ramp local table (L)": lambda: gif_raw(rng_idx(6, 9, 16), RAMP, local=True),
    "local table": lambda: gif_raw(rng_idx(6, 9, 16), PALETTE, local=True, min_bits=4),
    "placed on a larger screen": lambda: gif_raw(rng_idx(6, 9, 16), PALETTE, min_bits=4,
                                                 screen=(20, 11), offset=(5, 3)),
    "placed, transparency fills the screen": lambda: gif_raw(
        rng_idx(6, 9, 16), PALETTE, min_bits=4, screen=(20, 11), offset=(5, 3), transparency=2),
    "frame past the screen": lambda: gif_raw(rng_idx(6, 9, 16), PALETTE, min_bits=4,
                                             screen=(7, 4), offset=(3, 2)),
    "indices past the table": lambda: gif_raw(rng_idx(8, 8, 256), PALETTE, min_bits=8),
    "code size 2": lambda: gif_raw(rng_idx(9, 5, 4), PALETTE[:4], min_bits=2),
    **{f"interlaced {h} rows": (lambda h=h: gif_raw(rng_idx(h, 3, 16, h), PALETTE, min_bits=4,
                                                    interlace=True)) for h in (1, 2, 3, 5, 9, 17)},
    "two frames: the first": lambda: save(pillow_modes(9, 14)["P"], "GIF", save_all=True,
                                          append_images=[pillow_modes(9, 14, seed=2)["P"]],
                                          duration=50, loop=0),
    "comment and loop extensions": lambda: save(pillow_modes(9, 14)["P"], "GIF",
                                                comment=b"a comment", loop=0, duration=20),
}


@pytest.mark.parametrize("case", list(GIF_CASES))
def test_gif_case_matches_pillow(case):
    assert_pillow_equal(GIF_CASES[case]())


def test_gif_cases_reach_their_variant():
    modes = {c: Image.open(io.BytesIO(GIF_CASES[c]())).mode for c in GIF_CASES}
    assert modes["no colour table (L)"] == modes["grey-ramp local table (L)"] == "L"
    assert modes["local table"] == "P"
    assert Image.open(io.BytesIO(GIF_CASES["frame past the screen"]())).size == (12, 8)
    assert Image.open(io.BytesIO(GIF_CASES["two frames: the first"]())).n_frames == 2
    versions = {save(Image.fromarray(picture(4, 4)).quantize(4), "GIF")[:6],
                save(Image.fromarray(picture(4, 4)).quantize(4), "GIF", transparency=0)[:6]}
    assert versions == {b"GIF87a", b"GIF89a"}


@settings(max_examples=40, deadline=None, derandomize=True)
@given(h=st.integers(1, 40), w=st.integers(1, 40), colours=st.integers(2, 256),
       transparency=st.booleans(), interlace=st.booleans(), seed=st.integers(0, 2**16))
def test_gif_random_matches_pillow(h, w, colours, transparency, interlace, seed):
    img = Image.fromarray(picture(h, w, seed)).quantize(colours)
    kw = dict(transparency=0) if transparency else {}
    assert_pillow_equal(save(img, "GIF", interlace=interlace, **kw))


# ---- TIFF -----------------------------------------------------------------------------------

# name -> (photometric, bits a sample, samples, extra samples)
TIFF_KINDS = {
    "grey 1 min-is-black": (1, 1, 1, ()), "grey 1 min-is-white": (0, 1, 1, ()),
    "grey 2 min-is-white": (0, 2, 1, ()), "grey 4 min-is-black": (1, 4, 1, ()),
    "grey 8 min-is-black": (1, 8, 1, ()), "grey 8 min-is-white": (0, 8, 1, ()),
    "grey 16 min-is-black": (1, 16, 1, ()), "grey 16 min-is-white": (0, 16, 1, ()),
    "grey 8 + alpha": (1, 8, 2, (2,)),
    "RGB 8": (2, 8, 3, ()), "RGB 16": (2, 16, 3, ()),
    "RGBA 8 unassociated": (2, 8, 4, (2,)), "RGBA 8 associated": (2, 8, 4, (1,)),
    "RGBA 8 unnamed": (2, 8, 4, ()), "RGB 8 + unspecified": (2, 8, 4, (0,)),
    "RGBA 16 unassociated": (2, 16, 4, (2,)), "RGBA 16 associated": (2, 16, 4, (1,)),
    "palette 1": (3, 1, 1, ()), "palette 4": (3, 4, 1, ()), "palette 8": (3, 8, 1, ()),
}
TIFF_LAYOUTS = [dict(rows_per_strip=None), dict(rows_per_strip=5), dict(tile=(16, 16))]


def tiff_samples(kind, h=13, w=21, seed=0):
    photometric, bps, n, extra = TIFF_KINDS[kind]
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 1 << bps, (h, w, n)).astype(np.uint16 if bps == 16 else np.uint8)
    if bps == 16 and photometric != 2:
        px[..., 0] = rng.integers(0, 600, (h, w))  # grey "I;16" is clipped at 255
    cmap = rng.integers(0, 65536, 3 << bps).tolist() if photometric == 3 else None
    return px, dict(photometric=photometric, bps=bps, extra=extra, colour_map=cmap)


def tiff_refusal(kind, compression, predictor, planar, order):
    """The variant a decode of this layout is refused as, or None."""
    photometric, bps, n, extra = TIFF_KINDS[kind]
    if predictor == 2 and bps < 8:
        return "horizontal predictor at"
    if predictor == 2 and compression in ("none", "PackBits"):
        return "horizontal predictor with"  # libtiff and Pillow ignore it there
    if planar == 2 and n > (3 if photometric == 2 else 1):
        return "planar configuration 2 with extra samples"  # Pillow reads the alpha as 0
    if planar == 2 and compression == "none" and bps == 16:
        return "uncompressed planar configuration 2 at 16 bits"  # Pillow reads 8 of the 16
    if bps == 16 and photometric == 0 and order == ">":
        return "big-endian min-is-white grey at 16 bits"  # a mode Pillow does not open
    return None


@pytest.mark.parametrize("compression", ["none", "LZW", "Deflate", "PackBits", "old Deflate"])
@pytest.mark.parametrize("kind", list(TIFF_KINDS))
def test_tiff_grid_matches_pillow(kind, compression):
    """Each kind of pixel under each compression, through predictor 1 and
    2, planar configuration 1 and 2, one strip, strips of 5 rows and
    16x16 tiles, and both byte orders."""
    px, kw = tiff_samples(kind)
    n = px.shape[2]
    for predictor, planar, layout, order in itertools.product((1, 2), (1, 2), TIFF_LAYOUTS, "<>"):
        if planar == 2 and n == 1:
            continue
        raw = write_tiff(px, kw["photometric"], kw["bps"], kw["extra"], compression, predictor,
                         planar, order=order, colour_map=kw["colour_map"], **layout)
        refused = tiff_refusal(kind, compression, predictor, planar, order)
        if refused:
            with pytest.raises(NotImplementedError, match=f"TIFF {refused}.*ROADMAP"):
                decode_image_u8(raw)
            continue
        assert_pillow_equal(raw)


PILLOW_TIFF_COMPRESSIONS = [None, "tiff_lzw", "tiff_adobe_deflate", "packbits", "tiff_deflate"]


@pytest.mark.parametrize("compression", PILLOW_TIFF_COMPRESSIONS)
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA", "LA", "I;16"])
def test_pillow_tiff_matches_pillow(mode, compression):
    """Files Pillow writes (libtiff for the compressed ones), and with the
    horizontal predictor where libtiff applies it (LZW and Deflate)."""
    img = pillow_modes(23, 37)[mode] if mode != "I;16" else Image.fromarray(
        np.random.default_rng(3).integers(0, 900, (23, 37)).astype(np.uint16))
    kw = {} if compression is None else dict(compression=compression)
    assert_pillow_equal(save(img, "TIFF", **kw))
    if compression in ("tiff_lzw", "tiff_adobe_deflate", "tiff_deflate") and mode != "1":
        raw = save(img, "TIFF", tiffinfo={317: 2}, **kw)
        assert Image.open(io.BytesIO(raw)).tag_v2[317] == 2
        assert_pillow_equal(raw)


def test_tiff_lzw_widens_to_12_bits():
    """A strip long enough that LZW codes reach 12 bits and the table is
    cleared (libtiff's writer, through Pillow, and this module's)."""
    img = Image.fromarray(picture(96, 128, seed=4))
    raw = save(img, "TIFF", compression="tiff_lzw")
    assert_pillow_equal(raw)
    assert_pillow_equal(write_tiff(np.asarray(img), 2, compression="LZW"))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(h=st.integers(1, 40), w=st.integers(1, 40), kind=st.sampled_from(list(TIFF_KINDS)),
       compression=st.sampled_from(["none", "LZW", "Deflate", "PackBits"]),
       predictor=st.sampled_from([1, 2]), planar=st.sampled_from([1, 2]),
       layout=st.sampled_from(TIFF_LAYOUTS[1:] + [dict(tile=(32, 16))]),
       order=st.sampled_from("<>"), seed=st.integers(0, 2**16))
def test_tiff_random_matches_pillow(h, w, kind, compression, predictor, planar, layout, order,
                                    seed):
    px, kw = tiff_samples(kind, h, w, seed)
    if tiff_refusal(kind, compression, predictor, planar, order) or (planar == 2
                                                                    and px.shape[2] == 1):
        return
    assert_pillow_equal(write_tiff(px, kw["photometric"], kw["bps"], kw["extra"], compression,
                                   predictor, planar, order=order,
                                   colour_map=kw["colour_map"], **layout))


def rgb_tiff(**kw):
    return write_tiff(np.zeros((4, 4, 3), np.uint8), 2, **kw)


def old_style_lzw():
    raw = bytearray(write_tiff(np.zeros((4, 4, 3), np.uint8), 2, compression="LZW"))
    raw[8:10] = b"\x00\x01"  # the first bytes of an old-style (LSB-first) LZW strip
    return bytes(raw)


# the variants the port refused until it read them: each now decodes as Pillow's
TIFF_READ_NOW = {
    "JPEG-compressed": lambda: save(pillow_modes(8, 8)["RGB"], "TIFF", compression="jpeg"),
    "CMYK": lambda: save(Image.new("CMYK", (4, 4)), "TIFF"),
    "YCbCr": lambda: write_tiff(np.zeros((4, 4, 3), np.uint8), 6),
    "CIELab": lambda: save(Image.new("LAB", (4, 4)), "TIFF"),
    "LZMA-compressed": lambda: write_tiff(picture(4, 5, 1), 2, compression="LZMA"),
    "bit-reversed fill order": lambda: write_tiff(picture(4, 5, 2), 2, fill_order=2),
    "orientation 6": lambda: write_tiff(picture(4, 5, 3), 2, tags={274: (3, [6])}),
    "JPEG-compressed YCbCr in planar configuration 2": lambda: planar_jpeg_tiff(
        picture(9, 11, 4), rows_per_strip=4),
}


@pytest.mark.parametrize("variant", list(TIFF_READ_NOW))
def test_tiff_variants_once_refused_match_pillow(variant):
    raw = TIFF_READ_NOW[variant]()
    np.testing.assert_array_equal(decode_image_u8(raw), pillow(raw))


TIFF_REFUSALS = {
    "old-JPEG-compressed": lambda: rgb_tiff(tags={259: (3, [6])}),
    "floating-point samples": lambda: save(Image.new("F", (4, 4)), "TIFF"),
    "signed samples": lambda: rgb_tiff(tags={339: (3, [2, 2, 2])}),
    "BigTIFF": lambda: save(pillow_modes(4, 4)["RGB"], "TIFF", big_tiff=True),
    "CIELab in planar configuration 2": lambda: write_tiff(np.zeros((4, 4, 3), np.uint8), 8,
                                                           compression="LZW", planar=2),
    "old-style LZW": old_style_lzw,
    "floating-point predictor": lambda: rgb_tiff(compression="Deflate", tags={317: (3, [3])}),
    "horizontal predictor with no compression": lambda: rgb_tiff(predictor=2),
    "horizontal predictor with PackBits compression": lambda: rgb_tiff(compression="PackBits",
                                                                       predictor=2),
    "horizontal predictor at 1 bits": lambda: write_tiff(np.zeros((4, 4), np.uint8), 1, 1,
                                                         compression="LZW", predictor=2),
    "planar configuration 2 with extra samples": lambda: write_tiff(
        np.zeros((4, 4, 4), np.uint8), 2, extra=(2,), compression="LZW", planar=2),
    "big-endian min-is-white grey at 16 bits": lambda: write_tiff(
        np.zeros((4, 4), np.uint16), 0, 16, order=">"),
}


@pytest.mark.parametrize("variant", list(TIFF_REFUSALS))
def test_tiff_refusals(variant):
    with pytest.raises(NotImplementedError, match=f"TIFF {variant}.*ROADMAP"):
        decode_image_u8(TIFF_REFUSALS[variant]())


def test_tiff_refusals_are_files_pillow_reads_or_rejects_alike():
    """The refused files Pillow writes are ones it reads back (so the port
    refuses a readable file, not a broken one)."""
    for variant in ("floating-point samples", "BigTIFF"):
        raw = TIFF_REFUSALS[variant]()
        assert pillow(raw).shape[2] == 4
    assert struct.unpack("<H", TIFF_REFUSALS["BigTIFF"]()[2:4])[0] == 43
    big = rgba(4, 4)
    assert pillow(save(Image.fromarray(big), "TIFF")).shape == (4, 4, 4)


def with_tag(raw: bytes, tag: int, value) -> bytes:
    """A little-endian classic TIFF with one LONG or SHORT tag's first value
    replaced (a callable gets the old value)."""
    b = bytearray(raw)
    (ifd,) = struct.unpack("<I", b[4:8])
    (n,) = struct.unpack("<H", b[ifd : ifd + 2])
    for k in range(n):
        e = ifd + 2 + 12 * k
        t, kind = struct.unpack("<HH", b[e : e + 4])
        if t == tag:
            fmt = "<I" if kind == 4 else "<H"
            size = struct.calcsize(fmt)
            (old,) = struct.unpack(fmt, b[e + 8 : e + 8 + size])
            b[e + 8 : e + 8 + size] = struct.pack(fmt, value(old) if callable(value) else value)
    return bytes(b)


def gif_ending_early() -> bytes:
    """A GIF whose image descriptor says 20 rows and whose codes end after 5."""
    raw = bytearray(gif_raw(np.random.default_rng(0).integers(0, 16, (5, 20)), PALETTE,
                            min_bits=4))
    at = raw.index(b"\x2c")
    raw[at + 7 : at + 9] = struct.pack("<H", 20)
    return bytes(raw)


def rgb_strip(compression):
    return write_tiff(np.asarray(pillow_modes(20, 20)["RGB"]), 2, compression=compression)


TRUNCATED = {
    "GIF cut in its image data": lambda: (lambda r: r[: len(r) // 2])(
        save(Image.fromarray(picture(40, 40)).quantize(64), "GIF")),
    "GIF whose codes end early": gif_ending_early,
    **{f"TIFF {c} strip with a short byte count": (lambda c=c: with_tag(
        rgb_strip(c), 279, lambda n: n // 2)) for c in ("LZW", "Deflate", "PackBits")},
    "TIFF uncompressed strip past the end of the file": lambda: with_tag(
        rgb_strip("none"), 273, lambda off: off + 1000),
}


@pytest.mark.parametrize("case", list(TRUNCATED))
def test_truncated_files_are_refused_as_pillow_refuses_them(case):
    raw = TRUNCATED[case]()
    with pytest.raises(OSError):
        pillow(raw)
    with pytest.raises(ValueError, match="ends before|fewer bytes"):
        decode_image_u8(raw)


def test_uncompressed_strip_reads_past_its_byte_count():
    """Pillow reads an uncompressed strip as far as its pixels need,
    whatever StripByteCounts says; so does the port."""
    assert_pillow_equal(with_tag(rgb_strip("none"), 279, lambda n: n // 2))
