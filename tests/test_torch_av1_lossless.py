"""The AV1 tile decoder of AVIF's lossless key frames
(rustic_tpu_torch/csrc/av1_intra.cpp, through utils/avif.py `decode_av1`)
against dav1d 1.5.1 and Pillow 12.1.0 (its bundled libavif 1.3.0):

- csrc/av1_tables.h is what tests/av1_cdf_tables.py generates from dav1d's
  copy of the default CDFs in Pillow's libavif, and every CDF in it equals
  libaom's copy in the same library too; the specification's other tables
  the decoder uses (the lossy decoder's too: scans, quantiser lookups,
  transform sizes and types, coefficient contexts; and the in-loop
  filters': CDEF's directions and taps, the self-guided filter's
  parameters, the restoration coefficients' ranges) are found in libaom's
  copy, or follow from what it keeps;
- every lossless fixture of tests/data_torch/formats_avif (every layout,
  odd sizes, alpha, 2x2 tiles, BreakTime's textures with palette and intra
  block copy) decodes to dav1d's planes, plane for plane, and through
  decode_image_u8 to Pillow's RGBA;
- summed over the fixtures, the decoder's counters show every tool it
  claims: each y mode, angle deltas, upsampled edges, filter intra, CfL,
  palette (Y and UV), intra block copy and a frame of several tiles;
- lossless grids and 128x128 superblocks, encoded here, decode to
  Pillow's pixels;
- edits inside the tile data (bit flips, bytes, zeros, cuts) decode to
  Pillow's pixels or are refused where Pillow refuses them;
- a payload whose frame header names a tool the decoder lacks is refused
  by name before its tile data is read (tests/test_torch_av1_lossy.py
  holds the lossy decoder and its in-loop filters).

Run on the CPU (the decoder is host C++, built by g++ at first use):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_av1_lossless.py -q -n 6
"""

import numpy as np
import pytest
from PIL import Image

from rustic_tpu_torch.utils import avif
from rustic_tpu_torch.utils.png import decode_image_u8
from tests import av1_cdf_tables as tables
from tests.test_torch_image_formats import picture
from tests.test_torch_image_formats_avif import (MANIFEST, TILE_EDITS, breaktime_textures,
                                                 encode, expected_rgba_matches, filters, fixture,
                                                 grid_file, planes_of, sha256_of, tile_case)
from tests.test_torch_image_formats_variants import outcome, port_outcome, same

LOSSLESS = [e for e in MANIFEST if e["lossless"]]
FILTERED = [e for e in MANIFEST if filters(e)]


@pytest.fixture(scope="module")
def library():
    return tables.library_bytes()


@pytest.fixture(scope="module")
def dav1d_tables(library):
    return tables.read_tables(library)


def test_av1_tables_header_is_generated_from_dav1d(library):
    """The committed header is the generator's output on this host's
    library, byte for byte (dav1d's copy, each table's rows checked to be
    CDFs of its symbol count)."""
    with open(tables.HEADER) as f:
        assert f.read() == tables.header_text(tables.read_tables(library))


@pytest.mark.parametrize("name", list(tables.DAV1D) + list(tables.COEF))
def test_av1_cdf_equals_both_copies(name, library, dav1d_tables):
    """Each CDF table of the header equals dav1d's copy and libaom's copy in
    Pillow's libavif (libaom's laid out as its arrays are)."""
    with open(tables.HEADER) as f:
        header = tables.parse_header(f.read())
    table = dav1d_tables[name]
    assert header[name] == table.reshape(-1).tolist()
    assert (table[..., -1] == 0).all() and (table[..., -2] == 32768).all()
    for block in tables.libaom_bytes(name, table):
        assert library.find(block) >= 0, name


def sgr_scale(r: int, eps: int) -> int:
    """box_filter's s of radius r and eps: ((1 << 20) + n^2 eps / 2) / (n^2
    eps), n = (2r + 1)^2; -1 where r is 0, as libaom keeps it."""
    n2e = (2 * r + 1) ** 4 * eps
    return ((1 << 20) + n2e // 2) // n2e if r else -1


OTHER_IN_LIBAOM = {  # name -> libaom's layout of the same values
    "Sm_Weights": (sum((tables.SM_WEIGHTS[n] for n in (4, 8, 16, 32, 64)), []), np.uint8),
    "Dr_Intra_Derivative": (tables.DR_INTRA_DERIVATIVE, np.uint16),
    "Mode_To_Angle": (tables.MODE_TO_ANGLE, np.uint8),
    "Intra_Filter_Taps": ([[r + [0] for r in m] for m in tables.INTRA_FILTER_TAPS], np.int8),
    "Intra_Edge_Kernel": (tables.INTRA_EDGE_KERNEL, np.int32),
    "Default_Scan_4x4": (tables.DEFAULT_SCAN_4X4, np.int16),
    "Coeff_Base_Ctx_Offset_4x4": ([r[:4] for r in tables.COEFF_BASE_CTX_OFFSET_4X4[:4]],
                                  np.int8),
    "Dc_Qlookup": (tables.DC_QLOOKUP, np.int16),
    "Ac_Qlookup": (tables.AC_QLOOKUP, np.int16),
    "Cos128_Lookup": (tables.COS128_LOOKUP[:64], np.int32),
    "Mode_To_Txfm": (tables.MODE_TO_TXFM[:13], np.uint8),
    "Max_Tx_Size_Rect": (tables.MAX_TX_SIZE_RECT, np.uint8),
    "Max_Tx_Depth": (tables.MAX_TX_DEPTH, np.uint8),
    "Split_Tx_Size": (tables.SPLIT_TX_SIZE, np.uint8),
    "Adjusted_Tx_Size": (tables.ADJUSTED_TX_SIZE, np.uint8),
    "Tx_Type_Intra_Inv_Set1": (tables.TX_TYPE_INTRA_INV_SET1, np.int8),
    "Tx_Type_Intra_Inv_Set2": (tables.TX_TYPE_INTRA_INV_SET2, np.int8),
    "Tx_Type_Inter_Inv_Set1": (tables.TX_TYPE_INTER_INV_SET1, np.int8),
    "Tx_Type_Inter_Inv_Set2": (tables.TX_TYPE_INTER_INV_SET2, np.int8),
    # the in-loop filters' tables, each in the form libaom keeps it: Cdef_Uv_Dir as its two
    # remaps (conv422 at subsampling 1, 0 and conv440 at 0, 1), Cdef_Directions as offsets
    # into its CDEF buffer (row * CDEF_BSTRIDE 144 + column), Cdef_Sec_Taps as its one row
    # (both of the specification's rows are it), Sgr_Params as av1_sgr_params (the radii,
    # then the scales s that box_filter derives from eps, -1 where a radius is 0), the
    # Wiener taps' middle as its default filter (the 7 taps)
    "Cdef_Uv_Dir_422": (tables.CDEF_UV_DIR[1][0], np.int32),
    "Cdef_Uv_Dir_440": (tables.CDEF_UV_DIR[0][1], np.int32),
    "Cdef_Directions": ([[dy * 144 + dx for dy, dx in d] for d in tables.CDEF_DIRECTIONS],
                        np.int32),
    "Cdef_Pri_Taps": (tables.CDEF_PRI_TAPS, np.int32),
    "Cdef_Sec_Taps": (tables.CDEF_SEC_TAPS[0], np.int32),
    "Div_Table": (tables.DIV_TABLE, np.int32),
    "Sgr_Params": ([[r0, r1, sgr_scale(r0, e0), sgr_scale(r1, e1)]
                    for r0, e0, r1, e1 in tables.SGR_PARAMS], np.int32),
    "Sgr_X_By_Xplus1": (tables.SGR_X_BY_XPLUS1, np.int32),
    "Wiener_Taps_Mid": (tables.WIENER_TAPS_MID + [128 - 2 * sum(tables.WIENER_TAPS_MID)]
                        + tables.WIENER_TAPS_MID[::-1], np.int32),
    "Sgrproj_Xqd_Min": (tables.SGRPROJ_XQD_MIN, np.int32),
    "Sgrproj_Xqd_Max": (tables.SGRPROJ_XQD_MAX, np.int32),
}


def transposed(positions: list, w: int, h: int) -> list:
    """Positions row * w + col as libaom numbers them, column by column."""
    return [(p % w) * h + p // w for p in positions]


def column_major(values: list, w: int, h: int) -> list:
    """A value per position, row by row -> the same values column by column."""
    return [values[r * w + c] for c in range(w) for r in range(h)]


# libaom keeps its coefficients column by column: its scans and its per-position context
# offsets are the specification's transposed
for _w, _h in tables.SCAN_SIZES:
    OTHER_IN_LIBAOM[f"Default_Scan_{_w}x{_h}"] = (
        transposed(tables.default_scan(_w, _h), _w, _h), np.int16)
for _w, _h in tables.MROW_SIZES:
    OTHER_IN_LIBAOM[f"Mrow_Scan_{_w}x{_h}"] = (
        transposed(tables.mrow_scan(_w, _h), _w, _h), np.int16)
    OTHER_IN_LIBAOM[f"Mcol_Scan_{_w}x{_h}"] = (
        transposed(tables.mcol_scan(_w, _h), _w, _h), np.int16)
for _t, (_w, _h) in enumerate(tables.TX_SIZES_ALL):
    if max(_w, _h) < 64 and _t:
        _offsets = tables.COEFF_BASE_CTX_OFFSET[_t]
        OTHER_IN_LIBAOM[f"Coeff_Base_Ctx_Offset_{_w}x{_h}"] = (column_major(
            [_offsets[min(r, 4)][min(c, 4)] if r or c else 0 for r in range(_h)
             for c in range(_w)], _w, _h), np.int8)


@pytest.mark.parametrize("name", list(OTHER_IN_LIBAOM))
def test_av1_other_tables_are_libaoms(name, library):
    """The specification's tables the header carries, as libaom keeps them
    in the same library. (Transform_Row_Shift is not among them: libaom
    keeps it as a two-entry array a size, which the linker places apart;
    the transform sizes' planes equal dav1d's.)"""
    values, dtype = OTHER_IN_LIBAOM[name]
    assert library.find(np.array(values, dtype).tobytes()) >= 0


def test_av1_filter_tables_follow_libaoms_definitions():
    """What libaom keeps as definitions, not tables: the Wiener taps'
    ranges are WIENER_FILT_TAPi_MINV = MIDV - (1 << (BITS - 1)) and MAXV =
    MIDV - 1 + (1 << (BITS - 1)) with BITS = Wiener_Taps_K + 3 (4, 5, 6),
    the self-guided weights' middle is set_default_sgrproj's (min + max) / 2
    (C's division), both rows of Cdef_Sec_Taps are libaom's one, and
    Sgr_X_By_Xplus1 is the specification's ((z << 8) + z / 2) / (z + 1)
    with 1 at 0 and 256 at 255."""
    for lo, mid, hi, k in zip(tables.WIENER_TAPS_MIN, tables.WIENER_TAPS_MID,
                              tables.WIENER_TAPS_MAX, tables.WIENER_TAPS_K):
        assert (lo, hi) == (mid - (1 << (k + 2)), mid - 1 + (1 << (k + 2)))
    for lo, mid, hi in zip(tables.SGRPROJ_XQD_MIN, tables.SGRPROJ_XQD_MID,
                           tables.SGRPROJ_XQD_MAX):
        assert mid == int((lo + hi) / 2)
    assert tables.CDEF_SEC_TAPS[0] == tables.CDEF_SEC_TAPS[1] == [2, 1]
    x = tables.SGR_X_BY_XPLUS1
    assert len(x) == 256 and x[0] == 1 and x[255] == 256
    assert all(x[z] == ((z << 8) + z // 2) // (z + 1) for z in range(1, 255))


def decoded_payloads(raw: bytes):
    """(name, decode_av1's planes, its counters) of each payload."""
    h = avif.open_avif(raw)
    parsed = avif.headers(raw, h)
    for name in ("colour", "alpha"):
        for payload, p in zip(getattr(h, name), parsed[name]):
            planes, counts = avif.decode_av1(avif._payload(raw, h.idat, payload), p)
            yield name, planes, counts


@pytest.mark.parametrize("entry", LOSSLESS, ids=lambda e: e["file"])
def test_lossless_planes_equal_dav1d(entry):
    """Each payload's planes equal dav1d's (the committed arrays, or their
    sha256 for the 256^2 files), alpha's Y as libavif's alpha plane."""
    for name, planes, _ in decoded_payloads(fixture(entry["file"])):
        got = dict(planes) if name == "colour" else {"a": planes["y"]}
        if "planes" in entry:
            want = planes_of(entry)
            for k, v in got.items():
                np.testing.assert_array_equal(v, want[k], err_msg=f"{name} {k}")
        else:
            for k, v in got.items():
                assert [list(v.shape), sha256_of(v)] == entry["planes_sha256"][k], (name, k)


@pytest.mark.parametrize("entry", LOSSLESS, ids=lambda e: e["file"])
def test_lossless_rgba_equals_pillow(entry):
    assert expected_rgba_matches(entry, decode_image_u8(fixture(entry["file"]), entry["file"]))


def test_tool_counters_reach_every_tool():
    """Summed over the lossless fixtures, the decoder took every tool it
    claims at least once."""
    total, tiled = {}, 0
    for entry in LOSSLESS:
        for _, _, counts in decoded_payloads(fixture(entry["file"])):
            for k, v in counts.items():
                if isinstance(v, list):
                    total[k] = [a + b for a, b in zip(total.get(k, [0] * len(v)), v)]
                else:
                    total[k] = total.get(k, 0) + v
            tiled = max(tiled, counts["tiles"])
    assert all(n > 0 for n in total["y modes"]), total["y modes"]
    for tool in ("angle delta", "upsampled edge", "edge filter", "filter intra", "cfl",
                 "palette y", "palette uv", "intrabc"):
        assert total[tool] > 0, tool
    assert tiled == 4
    assert total["padding"] == 0


@pytest.mark.parametrize("h, w, rows, cols, sub", [(100, 120, 2, 2, "4:2:0"),
                                                   (130, 70, 3, 2, "4:4:4"),
                                                   (64, 64, 1, 1, "4:2:0")])
def test_lossless_grid_decodes_as_pillow(h, w, rows, cols, sub):
    """A grid of lossless 64x64 tiles (the suite's `grid_file`), each
    decoded and placed as libavif places them, cropped to the grid's size."""
    raw = grid_file(Image.fromarray(picture(h, w, 7)), rows, cols, 64, quality=100,
                    subsampling=sub)
    want, got = outcome(raw), port_outcome(raw, "grid.avif")
    assert not isinstance(want, Exception) and same(want, got)


@pytest.mark.parametrize("texture", [1, 3])
def test_128_superblocks_decode_as_pillow(texture):
    """aom's 128x128 superblocks (`sb-size`) on a screen-content texture
    (palette and intra block copy) and a natural one."""
    raw = encode(breaktime_textures()[1][texture], quality=100, advanced={"sb-size": "128"})
    assert avif.header_record(raw)["colour"]["sequence"]["sb128"] == 1
    want, got = outcome(raw), port_outcome(raw, "sb128.avif")
    assert not isinstance(want, Exception) and same(want, got)


@pytest.mark.parametrize("entry", FILTERED[:8], ids=lambda e: e["file"])
def test_lossy_payload_is_refused_by_name(entry):
    """A colour payload that the loop filter touches decodes (the filters
    are no longer refused); the same payload with its frame header naming
    film grain, which the decoder lacks, is refused by that name before
    its tile data is read."""
    raw = fixture(entry["file"])
    h = avif.open_avif(raw)
    data = avif._payload(raw, h.idat, h.colour[0])
    parsed = avif.parse_av1(data)
    assert "deblocking" in filters(dict(headers={"colour": entry["headers"]["colour"]}))
    counts = avif.decode_av1(data, parsed)[1]
    assert sum(counts["deblock luma"]) > 0
    parsed["frame"]["film_grain"] = dict(seed=1)
    with pytest.raises(NotImplementedError, match=r"AVIF AV1 tile data \(lossy, film grain\)"):
        avif.decode_av1(data, parsed)


EDIT_CASES = [(e["file"], k) for e in LOSSLESS for k in range(3 if "planes" in e else 1)]


@pytest.mark.parametrize("name, k", EDIT_CASES, ids=str)
def test_edited_tile_data_decodes_as_pillow(name, k):
    """A fixed, derandomised edit inside the tile data (seeded by the name
    and k): Pillow's pixels, or a refusal where Pillow refuses."""
    rng = np.random.default_rng([k, 7] + list(name.encode()))
    kind = TILE_EDITS[int(rng.integers(0, len(TILE_EDITS)))]
    where, value = float(rng.random()), int(rng.integers(0, 2**16))
    want, got = tile_case(fixture(name), kind, where, value)
    assert same(want, got), (kind, where, value, want if isinstance(want, Exception) else "",
                             got if isinstance(got, Exception) else "")


def test_block_copy_in_a_tiles_first_superblock_is_refused():
    """The edit the fuzz found: an intra block copy in the tile's first
    superblock, whose source no clamp takes out of it. dav1d refuses the
    frame (Pillow raises), and so does the port."""
    want, got = tile_case(fixture("q100-breaktime-1-420.avif"), "zero", 0.013777585287118144,
                          4123)
    assert isinstance(want, Exception) and isinstance(got, ValueError)
    assert "intra block copy" in str(got)
