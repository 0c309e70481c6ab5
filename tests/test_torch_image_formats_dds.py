"""The port's DDS decoder (rustic_tpu_torch/utils/dds.py, its BC6H and
BC7 blocks in csrc/bcn_decode.cpp) against Pillow 12.1.0, which the JAX
package reads DDS textures with.

Files are written by Pillow (DXT1, DXT3, DXT5, BC2, BC3 and BC5 through
its BCn encoder; L, LA, RGB and RGBA surfaces) or by
tests/test_torch_image_formats.py `dds_file` around random block bytes
(every byte pattern is a block Pillow decodes), masked pixels, palettes
and `bc7_mode6` blocks. `decode_image_u8` must give Pillow's
`np.asarray(Image.open(...).convert("RGBA"))` bit for bit: no tolerance.
Each variant Pillow refuses raises NotImplementedError naming it.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rustic_tpu_torch.ops import _build
from rustic_tpu_torch.utils import _entropy, dds
from rustic_tpu_torch.utils.png import decode_image_u8
from tests.test_torch_image_formats import (DDPF_ALPHAPIXELS, DDPF_FOURCC, DDPF_LUMINANCE,
                                            DDPF_PALETTE, DDPF_RGB, assert_pillow_equal,
                                            bc7_mode6, dds_file, pillow, pillow_modes, save)

# block kind -> (FourCC or None, DXGI format or None, bytes a block)
BLOCK_KINDS = {
    "DXT1": (b"DXT1", None, 8), "DXT3": (b"DXT3", None, 16), "DXT5": (b"DXT5", None, 16),
    "ATI1": (b"ATI1", None, 8), "BC4U": (b"BC4U", None, 8), "ATI2": (b"ATI2", None, 16),
    "BC5U": (b"BC5U", None, 16), "BC5S": (b"BC5S", None, 16),
    "BC1_TYPELESS": (None, 70, 8), "BC1_UNORM": (None, 71, 8), "BC2_TYPELESS": (None, 73, 16),
    "BC2_UNORM": (None, 74, 16), "BC3_TYPELESS": (None, 76, 16), "BC3_UNORM": (None, 77, 16),
    "BC4_TYPELESS": (None, 79, 8), "BC4_UNORM": (None, 80, 8), "BC5_TYPELESS": (None, 82, 16),
    "BC5_UNORM": (None, 83, 16), "BC5_SNORM": (None, 84, 16), "BC6H_UF16": (None, 95, 16),
    "BC6H_SF16": (None, 96, 16), "BC7_TYPELESS": (None, 97, 16), "BC7_UNORM": (None, 98, 16),
    "BC7_UNORM_SRGB": (None, 99, 16),
}


def blocks_file(kind: str, w: int, h: int, data: bytes) -> bytes:
    fourcc, dxgi, _ = BLOCK_KINDS[kind]
    return dds_file(w, h, data, fourcc, dxgi)


def n_blocks(w, h):
    return -(-w // 4) * -(-h // 4)


@pytest.mark.parametrize("kind", list(BLOCK_KINDS))
@settings(max_examples=8, deadline=None, derandomize=True)
@given(h=st.integers(1, 13), w=st.integers(1, 13), seed=st.integers(0, 2**32 - 1))
def test_random_blocks_match_pillow(kind, h, w, seed):
    """Random block bytes at odd sizes (edge blocks cropped)."""
    size = BLOCK_KINDS[kind][2]
    data = np.random.default_rng(seed).integers(0, 256, n_blocks(w, h) * size, np.uint8)
    assert_pillow_equal(blocks_file(kind, w, h, data.tobytes()))


@pytest.mark.parametrize("kind", ["DXT1", "DXT3", "DXT5", "ATI1", "ATI2", "BC5S", "BC6H_UF16",
                                  "BC6H_SF16", "BC7_UNORM"])
def test_many_random_blocks_match_pillow(kind):
    """4096 random blocks of each kind in one 64x256 surface: every BC7
    and BC6H mode many times over, BC1's three-colour mode, both
    BC3/BC4/BC5 interpolation modes."""
    size = BLOCK_KINDS[kind][2]
    data = np.random.default_rng(sum(kind.encode())).integers(0, 256, 4096 * size, np.uint8)
    assert_pillow_equal(blocks_file(kind, 64, 256, data.tobytes()))


def bc6_mode_bits(mode: int) -> int:
    """The low bits of a BC6H block's first byte that pick mode index
    `mode` (0-13), or one of the four reserved modes (14-17)."""
    if mode < 2:
        return mode
    if mode < 10:
        return 2 | (mode - 2) << 2
    return 3 | (mode - 10) << 2


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("mode", range(18))
def test_each_bc6h_mode_matches_pillow(mode, signed):
    """256 random blocks of one BC6H mode (the reserved ones black)."""
    rng = np.random.default_rng(mode + 100 * signed)
    data = rng.integers(0, 256, (256, 16), np.uint8)
    bits = 2 if mode < 2 else 5
    data[:, 0] = (data[:, 0] & ((0xFF << bits) & 0xFF)) | bc6_mode_bits(mode)
    assert_pillow_equal(dds_file(64, 64, data.tobytes(), dxgi=96 if signed else 95))


@pytest.mark.parametrize("mode", range(9))
def test_each_bc7_mode_matches_pillow(mode):
    """256 random blocks of one BC7 mode (mode 8: a first byte of 0, the
    reserved mode, opaque black)."""
    data = np.random.default_rng(mode).integers(0, 256, (256, 16), np.uint8)
    data[:, 0] = 0 if mode == 8 else (data[:, 0] & ((0xFF << (mode + 1)) & 0xFF)) | (1 << mode)
    raw = dds_file(64, 64, data.tobytes(), dxgi=98)
    assert_pillow_equal(raw)
    if mode == 8:
        assert (decode_image_u8(raw) == [0, 0, 0, 255]).all()


def test_extreme_blocks_match_pillow():
    """Blocks of all 0x00 and all 0xFF bytes, and BC1 with c0 == c1."""
    for kind in BLOCK_KINDS:
        size = BLOCK_KINDS[kind][2]
        for fill in (0x00, 0xFF):
            assert_pillow_equal(blocks_file(kind, 4, 4, bytes([fill]) * size))
    assert_pillow_equal(blocks_file("DXT1", 4, 4, bytes([0x34, 0x12, 0x34, 0x12]) + b"\xe4" * 4))


@pytest.mark.parametrize("fmt", ["DXT1", "DXT3", "DXT5", "BC2", "BC3", "BC5"])
@pytest.mark.parametrize("size", [(21, 35), (4, 4), (1, 7), (16, 9)])
def test_pillow_bcn_files_match_pillow(fmt, size):
    mode = "RGB" if fmt == "BC5" else "RGBA"
    assert_pillow_equal(save(pillow_modes(*size, seed=7)[mode], "DDS", pixel_format=fmt))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_pillow_raw_files_match_pillow(mode):
    assert_pillow_equal(save(pillow_modes(13, 9, seed=8)[mode], "DDS"))


# DDPF_RGB layouts: (bitcount, R, G, B, A masks)
MASKS = {
    "565": (16, (0xF800, 0x7E0, 0x1F, 0)), "1555": (16, (0x7C00, 0x3E0, 0x1F, 0x8000)),
    "4444": (16, (0xF00, 0xF0, 0xF, 0xF000)), "332": (8, (0xE0, 0x1C, 0x3, 0)),
    "BGR 24": (24, (0xFF0000, 0xFF00, 0xFF, 0)),
    "BGRA 32": (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    "RGBA 32": (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
    "10-10-10-2": (32, (0x3FF, 0xFFC00, 0x3FF00000, 0xC0000000)),
    "2-10-10-10": (32, (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000)),
    "3-bit channels": (16, (0x7, 0x70, 0x700, 0x7000)),
    "masks with holes": (32, (0x0F0F, 0xF0F00000, 0x101, 0)),
    "12 bits in one byte": (12, (0xF, 0xF0, 0, 0)),
    "64-bit pixels": (64, (0xFFFFFFFF, 0x3, 0x5, 0)),
    "zero masks": (16, (0, 0, 0, 0)),
}


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("layout", list(MASKS))
def test_masked_pixels_match_pillow(layout, alpha):
    """DDPF_RGB with 3 masks (RGB) or 4 (DDPF_ALPHAPIXELS): Pillow's
    float64 quotient cut toward zero, on channel maxima that do not
    divide 255 (5, 6, 10 bits, 3 bits, masks with holes)."""
    bits, masks = MASKS[layout]
    w, h = 11, 7
    data = np.random.default_rng(len(layout)).integers(0, 256, w * h * (bits // 8), np.uint8)
    flags = DDPF_RGB | (DDPF_ALPHAPIXELS if alpha else 0)
    assert_pillow_equal(dds_file(w, h, data.tobytes(), pfflags=flags, bitcount=bits,
                                 masks=masks))


def test_every_565_value_matches_pillow():
    """All 65536 565 pixels."""
    data = np.arange(65536, dtype="<u2").tobytes()
    assert_pillow_equal(dds_file(256, 256, data, pfflags=DDPF_RGB, bitcount=16,
                                 masks=(0xF800, 0x7E0, 0x1F, 0)))


def test_luminance_palette_and_dx10_rgba_match_pillow():
    rng = np.random.default_rng(9)
    assert_pillow_equal(dds_file(9, 5, rng.integers(0, 256, 45, np.uint8).tobytes(),
                                 pfflags=DDPF_LUMINANCE, bitcount=8))
    assert_pillow_equal(dds_file(9, 5, rng.integers(0, 256, 90, np.uint8).tobytes(),
                                 pfflags=DDPF_LUMINANCE | DDPF_ALPHAPIXELS, bitcount=16))
    pal = rng.integers(0, 256, 1024, np.uint8).tobytes()
    assert_pillow_equal(dds_file(9, 5, rng.integers(0, 256, 45, np.uint8).tobytes(),
                                 pfflags=DDPF_PALETTE, bitcount=8, extra=pal))
    for dxgi in (27, 28, 29):
        assert_pillow_equal(dds_file(9, 5, rng.integers(0, 256, 180, np.uint8).tobytes(),
                                     dxgi=dxgi))


def test_bc7_mode6_writer_round_trips():
    """The test-side BC7 writer gives mode-6 blocks whose decode is near
    the picture on a smooth image, and the port decodes them as Pillow."""
    y, x = np.mgrid[0:32, 0:48]
    px = np.stack([x * 5, y * 7, (x + y) * 3, 255 - x * 2], -1).astype(np.uint8)
    raw = dds_file(48, 32, bc7_mode6(px), dxgi=98)
    blocks = np.frombuffer(raw[148:], np.uint8).reshape(-1, 16)
    assert (blocks[:, 0] == 0x40).all()
    assert_pillow_equal(raw)
    assert np.abs(pillow(raw).astype(int) - px).max() <= 12


def test_first_surface_only():
    """Mipmaps after the first surface, and a DX10 array size, are
    ignored as Pillow ignores them."""
    rng = np.random.default_rng(10)
    data = rng.integers(0, 256, (16 + 4 + 1) * 16, np.uint8).tobytes()
    assert_pillow_equal(dds_file(16, 16, data, dxgi=98, mipmaps=3))
    raw = dds_file(8, 8, rng.integers(0, 256, 4 * 8 * 2, np.uint8).tobytes(), b"DXT1")
    assert_pillow_equal(raw)


def test_pixel_format_flags_pick_in_pillows_order():
    """DDPF_RGB wins over DDPF_FOURCC, DDPF_LUMINANCE over the palette."""
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, 4 * 4 * 4 + 1024, np.uint8).tobytes()
    assert_pillow_equal(dds_file(4, 4, data, b"DXT1", pfflags=DDPF_RGB | DDPF_FOURCC,
                                 bitcount=32, masks=(0xFF, 0xFF00, 0xFF0000, 0)))
    assert_pillow_equal(dds_file(4, 4, data, pfflags=DDPF_LUMINANCE | DDPF_PALETTE, bitcount=8))


# variant -> a file Pillow refuses, and the port by name
DDS_REFUSALS = {
    "DDS header size 120": lambda: dds_file(4, 4, bytes(8), b"DXT1", header_size=120),
    "DDS luminance at 16 bits": lambda: dds_file(4, 4, bytes(32), pfflags=DDPF_LUMINANCE,
                                                 bitcount=16),
    "DDS luminance at 4 bits": lambda: dds_file(4, 4, bytes(8), pfflags=DDPF_LUMINANCE,
                                                bitcount=4),
    "DDS pixel format b'DXT2'": lambda: dds_file(4, 4, bytes(16), b"DXT2"),
    "DDS pixel format b'BC4S'": lambda: dds_file(4, 4, bytes(8), b"BC4S"),
    "DDS DXGI format 72": lambda: dds_file(4, 4, bytes(8), dxgi=72),  # BC1_UNORM_SRGB
    "DDS DXGI format 81": lambda: dds_file(4, 4, bytes(8), dxgi=81),  # BC4_SNORM
    "DDS DXGI format 94": lambda: dds_file(4, 4, bytes(16), dxgi=94),  # BC6H_TYPELESS
    "DDS DXGI format 30": lambda: dds_file(4, 4, bytes(64), dxgi=30),  # R8G8B8A8_UINT
    "DDS pixel-format flags 0x2": lambda: dds_file(4, 4, bytes(16), pfflags=0x2),
}


@pytest.mark.parametrize("variant", list(DDS_REFUSALS))
def test_dds_refusals(variant):
    """Each variant Pillow does not read raises NotImplementedError
    naming it and FORMATS_TODO; Pillow raises there too."""
    raw = DDS_REFUSALS[variant]()
    with pytest.raises(NotImplementedError, match=f"{variant}.*ROADMAP"):
        decode_image_u8(raw, "texture.dds")
    with pytest.raises((OSError, NotImplementedError)):
        pillow(raw)


@pytest.mark.parametrize("kind", ["DXT1", "BC7_UNORM", "luminance", "RGB masks", "palette"])
def test_truncated_files_raise_value_error(kind):
    """A surface shorter than its pixels raises ValueError where Pillow
    raises; the masked one Pillow reads as if it ended in zeros, and so
    does the port."""
    if kind in BLOCK_KINDS:
        raw = blocks_file(kind, 8, 8, bytes(4 * BLOCK_KINDS[kind][2] - 1))
    elif kind == "luminance":
        raw = dds_file(8, 8, bytes(63), pfflags=DDPF_LUMINANCE, bitcount=8)
    elif kind == "palette":
        raw = dds_file(8, 8, bytes(1024 + 63), pfflags=DDPF_PALETTE, bitcount=8)
    else:
        raw = dds_file(8, 8, bytes(127), pfflags=DDPF_RGB, bitcount=16,
                       masks=(0xF800, 0x7E0, 0x1F, 0))
    if kind == "RGB masks":
        assert (pillow(raw)[-1, -1] == [0, 0, 0, 255]).all()
        np.testing.assert_array_equal(decode_image_u8(raw), pillow(raw))
        return
    with pytest.raises(ValueError, match="truncated"):
        decode_image_u8(raw)
    with pytest.raises(OSError):
        pillow(raw)
    with pytest.raises(ValueError, match="truncated"):
        decode_image_u8(raw[:100])


def test_dds_is_taken_by_its_signature():
    """Whatever name or MIME type comes with it."""
    raw = save(pillow_modes(6, 5)["RGBA"], "DDS", pixel_format="DXT5")
    want = pillow(raw)
    for name in ("", "image/vnd-ms.dds", "texture.tga", "x.png"):
        np.testing.assert_array_equal(decode_image_u8(raw, name), want)
    np.testing.assert_array_equal(dds.decode_dds(raw), want)
    with pytest.raises(ValueError, match="not a DDS"):
        dds.decode_dds(b"PNG " + raw[4:])


def test_bcn_blocks_without_a_compiler_raises(tmp_path, monkeypatch):
    """No Python BC6H/BC7 decoder: without g++ (and no library built yet)
    decoding raises and names the compiler; BC1 needs no library."""
    raw = dds_file(4, 4, bytes(range(16)), dxgi=98)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    _entropy.bcn_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=r"g\+\+ is not on PATH.*bcn_decode.cpp"):
            decode_image_u8(raw)
        assert_pillow_equal(dds_file(4, 4, bytes(range(8)), b"DXT1"))
    finally:
        _entropy.bcn_library.cache_clear()
    monkeypatch.undo()
    assert_pillow_equal(raw)


def test_block_decoders_have_no_block_loop():
    """A 1024x1024 surface of each kind decodes in a bounded number of
    Python-level calls, far fewer than its 65536 blocks (a loop over the
    blocks would make at least one call a block)."""
    import sys

    rng = np.random.default_rng(12)
    for kind in ("DXT1", "DXT3", "DXT5", "ATI1", "BC5S", "BC7_UNORM", "BC6H_SF16"):
        size = BLOCK_KINDS[kind][2]
        raw = blocks_file(kind, 1024, 1024, rng.integers(0, 256, 65536 * size, np.uint8).tobytes())
        decode_image_u8(raw)  # the library built
        calls = [0]

        def count(frame, event, arg):
            calls[0] += 1

        sys.setprofile(count)
        try:
            got = decode_image_u8(raw)
        finally:
            sys.setprofile(None)
        assert got.shape == (1024, 1024, 4) and calls[0] < 2000, (kind, calls[0])


# ---- edits of the committed fixtures against Pillow (queue 3's fuzz) --------------------------

def dds_psd_small(suffix: str) -> list:
    """The small committed fixtures of tests/data_torch/formats_dds_psd
    ending in `suffix`."""
    from tests.test_torch_image_formats import dds_psd_manifest

    return [e["file"] for e in dds_psd_manifest()["images"]
            if "expect" in e and e["file"].endswith(suffix)]


def dds_psd_fuzz(suffix: str, n: int, seed: int = 0) -> dict:
    """`n` random edits (tests/test_torch_image_formats_variants.py EDITS:
    a bit flipped, a byte set, zeros over a run, a cut, bytes inserted,
    anywhere after the signature) of every small fixture ending in
    `suffix`, each decoded by the port and by Pillow -> counts of (kind,
    outcome); raises AssertionError at the first edit they disagree on."""
    from tests.test_torch_image_formats import dds_psd_fixture
    from tests.test_torch_image_formats_variants import edit_fuzz

    return edit_fuzz([(name, dds_psd_fixture(name)) for name in dds_psd_small(suffix)], n, seed)


@pytest.mark.parametrize("seed", range(4))
def test_edited_dds_fixtures_decode_as_pillow_decodes_them(seed):
    """A fixed 4 x 5 edits of each DDS fixture (`--fuzz` runs more)."""
    assert sum(dds_psd_fuzz(".dds", 5, seed).values()) == 5 * len(dds_psd_small(".dds"))


def masked_dds(w, h, data, bitcount=16, masks=(0xF800, 0x7E0, 0x1F, 0)):
    return dds_file(w, h, data, pfflags=DDPF_RGB, bitcount=bitcount, masks=masks)


DDS_EDITED = {  # what the fuzz found, each now as Pillow reads it
    "zero height": lambda: masked_dds(4, 0, bytes(32)),
    "zero width of a block kind": lambda: blocks_file("DXT1", 0, 4, bytes(8)),
    "decompression bomb": lambda: masked_dds(40000, 9000, bytes(64)),
    "masked surface cut mid-pixel": lambda: masked_dds(3, 3, bytes(range(13))),
    "masked pixels of 2^20 bits": lambda: masked_dds(2, 2, bytes(range(200)),
                                                     bitcount=1 << 20),
}


@pytest.mark.parametrize("case", list(DDS_EDITED))
def test_dds_edits_the_fuzz_found(case):
    from tests.test_torch_image_formats_variants import assert_as_pillow

    assert_as_pillow(DDS_EDITED[case]())


if __name__ == "__main__":
    import json
    import sys

    if sys.argv[1:2] == ["--fuzz"]:  # --fuzz N [SEED]: edits of each DDS fixture
        print(json.dumps(dds_psd_fuzz(".dds", int(sys.argv[2]),
                                      int(sys.argv[3]) if sys.argv[3:] else 0)))
