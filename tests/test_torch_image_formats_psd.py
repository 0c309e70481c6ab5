"""The port's PSD decoder (rustic_tpu_torch/utils/psd.py, its PackBits
rows in csrc/bcn_decode.cpp) against Pillow 12.1.0, which the JAX
package reads PSD textures with.

Pillow writes no PSD: files are written by tests/test_torch_image_formats.py
`write_psd` and `psd_of` (each mode of Pillow's MODES table, raw and
PackBits, image resources, a layer and mask section, extra channels,
byte counts that lie, random PackBits streams). CMYK pixels come from
Pillow's `convert`, so every file is held as the loaders read it:
`decode_image_u8` must give Pillow's
`np.asarray(Image.open(...).convert("RGBA"))` bit for bit. Each variant
Pillow refuses raises NotImplementedError naming it; Lab is read through
utils/modes.py `lab_to_rgb`, alpha 0 as Pillow gives it.
"""

import io
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from rustic_tpu_torch.utils import psd
from rustic_tpu_torch.utils.png import decode_image_u8
from tests.test_torch_image_formats import (assert_pillow_equal, pillow, pillow_modes, psd_of,
                                            write_psd)

SIZES = [(21, 35), (1, 1), (7, 3), (4, 17)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA", "CMYK"])
def test_modes_match_pillow(mode, compression, size):
    """Bitmap, greyscale, indexed, RGB, RGB + alpha and CMYK (stored
    inverted) from Pillow's images, raw and PackBits."""
    modes = pillow_modes(*size, seed=3)
    img = modes["RGB"].convert("CMYK") if mode == "CMYK" else modes[mode]
    raw = psd_of(img, compression)
    assert_pillow_equal(raw)
    if mode != "CMYK":  # the PSD holds the image Pillow wrote it from
        np.testing.assert_array_equal(decode_image_u8(raw), np.asarray(img.convert("RGBA")))


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("colour, channels", [(0, 1), (1, 1), (1, 2), (7, 1), (7, 4), (8, 1),
                                              (2, 1), (2, 2), (3, 3), (3, 4), (3, 5), (3, 7),
                                              (4, 4), (4, 5)])
def test_channel_counts_match_pillow(colour, channels, compression):
    """Greyscale, multichannel and duotone read as L (the first channel);
    RGB with 4 channels as RGBA and with 5 or more as RGB; CMYK with an
    extra channel; indexed with an alpha channel. With PackBits Pillow
    reads only the byte counts of the channels it uses, then its data
    from there: the port reads the same bytes."""
    rng = np.random.default_rng(colour * 10 + channels)
    planes = rng.integers(0, 256, (channels, 9, 13), np.uint8)
    planes[:, :, 4:9] = planes[:, :, 4:5]  # runs for PackBits
    pal = rng.integers(0, 256, 768, np.uint8).tobytes() if colour == 2 else b""
    assert_pillow_equal(write_psd(planes, colour, 8, compression, pal))


def test_resources_and_layers_are_skipped():
    """Image resources (an ICC profile, names of odd and even length, odd
    data) and a layer and mask section change no pixel."""
    img = pillow_modes(9, 14, seed=4)["RGB"]
    plain = psd_of(img, 1)
    res = [(1039, b"", bytes(range(131))), (1005, b"a", b"xy"), (1006, b"ab", b"xyz"),
           (1060, b"meta", bytes(8))]
    for kw in (dict(resources=res), dict(layers=b"\0\0\0\4abcd\0\0"),
               dict(resources=res, layers=bytes(40))):
        raw = psd_of(img, 1, **kw)
        assert_pillow_equal(raw)
        np.testing.assert_array_equal(decode_image_u8(raw), decode_image_u8(plain))


def test_palette_of_another_length_is_black():
    """Indexed colour data of a length other than 768 leaves Pillow with
    no palette: every index black."""
    idx = np.random.default_rng(5).integers(0, 256, (1, 6, 7), np.uint8)
    for data in (b"", bytes(range(256)) * 3 + b"\0", bytes(767)):
        raw = write_psd(idx, 2, 8, 0, data)
        assert_pillow_equal(raw)
        assert (decode_image_u8(raw) == [0, 0, 0, 255]).all()


def test_every_cmyk_ink_and_black_matches_pillow():
    """Pillow's CMYK -> RGB on every (ink, black) pair, each channel."""
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    planes = 255 - np.stack([c, np.roll(c, 7, 0), np.roll(c, 91, 1), k]).astype(np.uint8)
    assert_pillow_equal(write_psd(planes, 4, 8, 0))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(h=st.integers(1, 5), w=st.integers(1, 11), channels=st.sampled_from([1, 3, 4]),
       ops=st.lists(st.one_of(st.just(b"\x80"),
                              st.binary(min_size=1, max_size=20).map(
                                  lambda b: bytes([len(b) - 1]) + b),
                              st.tuples(st.integers(0x81, 0xFF), st.integers(0, 255)).map(
                                  bytes)), min_size=1, max_size=60),
       counts=st.lists(st.integers(0, 40), min_size=20, max_size=20))
def test_random_packbits_streams_match_pillow(h, w, channels, ops, counts):
    """PackBits as Pillow's PackDecode.c reads it: runs and literals cut
    at the end of a row, 0x80 skipped, each channel from where the byte
    counts (true or not) put it; data that ends early raises in both."""
    colour = 1 if channels == 1 else 3
    head = b"8BPS" + struct.pack(">H", 1) + bytes(6) + struct.pack(">HIIHH", channels, h, w, 8,
                                                                  colour)
    raw = head + bytes(12) + struct.pack(">H", 1)
    raw += b"".join(struct.pack(">H", n) for n in (counts * h)[: channels * h]) + b"".join(ops)
    try:
        want = pillow(raw)
    except OSError:
        with pytest.raises(ValueError, match="truncated"):
            decode_image_u8(raw)
        return
    np.testing.assert_array_equal(decode_image_u8(raw), want)


# variant -> a file Pillow refuses, and the port by name
PSD_REFUSALS = {
    "PSD colour mode 3 at 16 bits": lambda: write_psd(np.zeros((3, 2, 8), np.uint8), 3, 16, 0),
    "PSD colour mode 1 at 32 bits": lambda: write_psd(np.zeros((1, 2, 16), np.uint8), 1, 32, 0),
    "PSD colour mode 1 at 16 bits": lambda: write_psd(np.zeros((1, 2, 8), np.uint8), 1, 16, 0),
    "PSD colour mode 2 at 1 bits": lambda: write_psd(np.zeros((1, 2, 1), np.uint8), 2, 1, 0),
    "PSD large document format": lambda: write_psd(np.zeros((3, 2, 4), np.uint8), 3, 8, 0,
                                                   version=2),
    "PSD ZIP": lambda: write_psd(np.zeros((3, 2, 4), np.uint8), 3, 8, 2),
    "PSD ZIP with prediction": lambda: write_psd(np.zeros((3, 2, 4), np.uint8), 3, 8, 3),
    "PSD RGB with 2 channels": lambda: write_psd(np.zeros((2, 2, 4), np.uint8), 3, 8, 0),
    "PSD CMYK with 3 channels": lambda: write_psd(np.zeros((3, 2, 4), np.uint8), 4, 8, 0),
}

# the variants the port refused until it read them: each now decodes as Pillow's
PSD_READ_NOW = {
    "PSD Lab colour": lambda: write_psd(np.full((3, 2, 4), 128, np.uint8), 9, 8, 1),
}


@pytest.mark.parametrize("variant", list(PSD_READ_NOW))
def test_psd_variants_once_refused_match_pillow(variant):
    raw = PSD_READ_NOW[variant]()
    assert Image.open(io.BytesIO(raw)).mode == "LAB"
    np.testing.assert_array_equal(decode_image_u8(raw, "texture.psd"), pillow(raw))


@pytest.mark.parametrize("variant", list(PSD_REFUSALS))
def test_psd_refusals(variant):
    """Each refused variant raises NotImplementedError naming it and
    FORMATS_TODO; Pillow raises for each."""
    raw = PSD_REFUSALS[variant]()
    with pytest.raises(NotImplementedError, match=f"{variant}.*ROADMAP"):
        decode_image_u8(raw, "texture.psd")
    with pytest.raises((OSError, KeyError)):
        pillow(raw)


@pytest.mark.parametrize("compression", [0, 1])
def test_truncated_files_raise_value_error(compression):
    """Image data shorter than its pixels raises ValueError; Pillow raises
    there too."""
    raw = psd_of(pillow_modes(5, 6, seed=6)["RGB"], compression)
    for cut in (10, len(raw) - 40, len(raw) - 2):
        short = raw[:cut]
        with pytest.raises(ValueError, match="truncated"):
            decode_image_u8(short)
        with pytest.raises(Exception):
            pillow(short)


def test_psd_is_taken_by_its_signature():
    raw = psd_of(pillow_modes(6, 5)["RGBA"], 1)
    want = pillow(raw)
    for name in ("", "image/vnd.adobe.photoshop", "texture.tga"):
        np.testing.assert_array_equal(decode_image_u8(raw, name), want)
    np.testing.assert_array_equal(psd.decode_psd(raw), want)
    with pytest.raises(ValueError, match="not a PSD"):
        psd.decode_psd(b"8BPX" + raw[4:])


# ---- edits of the committed fixtures against Pillow (queue 3's fuzz) --------------------------

@pytest.mark.parametrize("seed", range(4))
def test_edited_psd_fixtures_decode_as_pillow_decodes_them(seed):
    """A fixed 4 x 8 edits of each PSD fixture (`--fuzz` runs more)."""
    from tests.test_torch_image_formats_dds import dds_psd_fuzz, dds_psd_small

    assert sum(dds_psd_fuzz(".psd", 8, seed).values()) == 8 * len(dds_psd_small(".psd"))


def psd_resources_past_their_entries(extra: int) -> bytes:
    """A PSD whose image resource section says `extra` bytes more than its
    one entry holds: Pillow's section ends its length after the length's
    own 4 bytes, so it reads on from the layer section as another entry."""
    raw = bytearray(write_psd(np.arange(15, dtype=np.uint8).reshape(1, 3, 5), 1,
                              compression=0, resources=[(1005, b"res", b"")],
                              layers=bytes(range(40, 60))))
    pos = 26 + 4
    size = struct.unpack(">I", raw[pos : pos + 4])[0]
    raw[pos : pos + 4] = struct.pack(">I", size + extra)
    return bytes(raw)


PSD_EDITED = {  # what the fuzz found, each now as Pillow reads it
    "zero height": lambda: write_psd(np.zeros((1, 0, 4), np.uint8), 1, compression=0),
    "zero width": lambda: write_psd(np.zeros((1, 4, 0), np.uint8), 1, compression=0),
    "resource section 2 bytes past its entries": lambda: psd_resources_past_their_entries(2),
    "resource section 4 bytes past its entries": lambda: psd_resources_past_their_entries(4),
}


@pytest.mark.parametrize("case", list(PSD_EDITED))
def test_psd_edits_the_fuzz_found(case):
    from tests.test_torch_image_formats_variants import assert_as_pillow

    assert_as_pillow(PSD_EDITED[case]())


if __name__ == "__main__":
    import json
    import sys

    from tests.test_torch_image_formats_dds import dds_psd_fuzz

    if sys.argv[1:2] == ["--fuzz"]:  # --fuzz N [SEED]: edits of each PSD fixture
        print(json.dumps(dds_psd_fuzz(".psd", int(sys.argv[2]),
                                      int(sys.argv[3]) if sys.argv[3:] else 0)))
