"""The AV1 tile decoder of lossy AVIF key frames and its in-loop filters
(rustic_tpu_torch/csrc/av1_intra.cpp with csrc/av1_itx.h and
csrc/av1_filters.h, through utils/avif.py `decode_av1`) against dav1d 1.5.1
and Pillow 12.1.0 (its bundled libavif 1.3.0 and aom 3.12.1):

- every lossy fixture of tests/data_torch/formats_avif whose payloads have
  loop filter levels 0 and no non-zero CDEF strength (quality 90 at every
  layout and range, odd sizes, alpha, premultiplied, the container
  variants, two-frames.avif with CDEF on at zero strengths, the chroma
  delta q, and the 256^2 ones: BreakTime's textures with palette and intra
  block copy (with and without residuals), 2x2 tiles, TX_MODE_LARGEST,
  quality 50 in q context 3, and the photo's centre) decodes, payload for
  payload, to dav1d's planes (the committed arrays, or their sha256), and
  through decode_image_u8 to Pillow's RGBA;
- summed over those fixtures, the decoder's counters show every transform
  size and type, tx_depth, block-copy residual, corner filter and mode the
  fixtures reach (`REACHED`);
- encodes made here with aom's options (loop filter off by
  `loopfilter-control`, the reduced transform set, other speeds) decode
  to Pillow's pixels, and reach the 32x16 and 16x4 transforms;
- every filtered fixture (deblocked at every layout, with alpha, at odd
  sizes' padding, sharpness 3, a level per direction and plane; CDEF with
  one and two strength pairs at every layout, in 128x128 superblocks and
  across tile edges; Wiener and self-guided loop restoration at 4:2:0,
  4:2:2 and 4:4:4, alone and after both other filters) decodes to dav1d's
  planes and Pillow's RGBA, and the filters' counters show every filter
  length, CDEF on luma and chroma and each restoration kind; odd-sized
  encodes, deblocked and CDEF'd, decode to Pillow's pixels;
  `loop_filter_delta_enabled` is read, and its intra ref delta filters
  level 10 as 11;
- each tool the decoder does not take is refused by name (`tool_refusal`,
  on a fixture's frame header with that tool turned on), and so are the
  quantiser matrices, film grain and delta q that aom makes here, which
  Pillow decodes;
- derandomised edits inside the lossy tile data, filtered or not, decode
  to Pillow's pixels or are refused where Pillow refuses them; the edits
  the fuzz found
  stay as named cases, and so do edits whose streams reach what no
  fixture reaches (64-point transforms, a var-tx split, the uv modes D135
  and D157).

Run on the CPU (the decoder is host C++, built by g++ at first use):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_av1_lossy.py -q -n 6
"""

import copy

import numpy as np
import pytest
from PIL import Image

from rustic_tpu_torch.utils import FORMATS_TODO, avif
from rustic_tpu_torch.utils.png import decode_image_u8
from tests.test_torch_image_formats import picture
from tests.test_torch_image_formats_avif import (CDEF_ON, MANIFEST, PHOTO, TILE_EDITS,
                                                 breaktime_textures, edit, encode,
                                                 expected_rgba_matches, filters, fixture,
                                                 photo_crop, planes_of, sha256_of, tile_case,
                                                 tile_span)
from tests.test_torch_image_formats_variants import outcome, port_outcome, same

FILTER_FREE = [e for e in MANIFEST if not e["lossless"] and not filters(e)]
FILTERED = [e for e in MANIFEST if filters(e)]


def placed_payloads(raw: bytes):
    """(name, decode_av1's planes placed as libavif places a grid's tiles,
    each payload's counters) of the colour and the alpha payloads."""
    h = avif.open_avif(raw)
    parsed = avif.headers(raw, h)
    for name in ("colour", "alpha"):
        decoded = [avif.decode_av1(avif._payload(raw, h.idat, payload), p)
                   for payload, p in zip(getattr(h, name), parsed[name])]
        if decoded:
            planes = avif._placed(h, [d[0] for d in decoded], parsed[name][0]["sequence"])
            yield name, planes, [d[1] for d in decoded]


def test_the_fixtures_split_as_the_manifest_says():
    """71 filter-free lossy fixtures were committed before the decoder
    took them, 9 came with it; 20 deblocked ones (two with CDEF too) were
    committed before the filters were decoded, 14 filtered ones came with
    them: 12 deblocked, 9 with CDEF, 5 with loop restoration (two alone)."""
    assert len(FILTER_FREE) == 80 and len(FILTERED) == 34
    by = {name: {e["file"] for e in FILTERED if name in filters(e)}
          for name in ("deblocking", "CDEF", "loop restoration")}
    assert len(by["deblocking"]) == 32
    assert by["CDEF"] == {"q50-420-cdef.avif", "q20-420-cdef.avif", "q40-photo-512-420-cdef.avif",
                          "q30-photo-256-420-speed2-cdef.avif",
                          "q40-photo-256-420-speed0-cdef.avif",
                          "q50-breaktime-2-420-tiles-2x2-cdef.avif",
                          "q50-breaktime-5-420-speed0-cdef.avif"} | {
        f"q50-photo-256-{t}-cdef.avif" for t in ("420", "422", "444", "400")}
    assert by["loop restoration"] == {"q60-photo-256-420-speed0-lr.avif",
                                      "q40-photo-256-420-speed0-cdef.avif",
                                      "q40-photo-128-422-speed1.avif",
                                      "q50-photo-128-444-speed0.avif",
                                      "q50-breaktime-5-420-speed0-cdef.avif"}
    assert by["loop restoration"] - by["deblocking"] == {"q60-photo-256-420-speed0-lr.avif",
                                                          "q50-photo-128-444-speed0.avif"}
    two = next(e for e in FILTER_FREE if e["file"] == "two-frames.avif")
    assert two["headers"]["colour"]["frame"]["cdef"]["strengths"] == [[0, 0, 0, 0]]


def assert_planes_equal_dav1d(entry: dict):
    for name, planes, _ in placed_payloads(fixture(entry["file"])):
        got = dict(planes) if name == "colour" else {"a": planes["y"]}
        if "planes" in entry:
            want = planes_of(entry)
            for k, v in got.items():
                np.testing.assert_array_equal(v, want[k], err_msg=f"{name} {k}")
        else:
            for k, v in got.items():
                assert [list(v.shape), sha256_of(v)] == entry["planes_sha256"][k], (name, k)


@pytest.mark.parametrize("entry", FILTER_FREE, ids=lambda e: e["file"])
def test_lossy_planes_equal_dav1d(entry):
    """Each payload's planes equal dav1d's, alpha's Y as libavif's alpha
    plane."""
    assert_planes_equal_dav1d(entry)


@pytest.mark.parametrize("entry", FILTER_FREE, ids=lambda e: e["file"])
def test_lossy_rgba_equals_pillow(entry):
    assert expected_rgba_matches(entry, decode_image_u8(fixture(entry["file"]), entry["file"]))


# what the filter-free lossy fixtures reach (the sizes and types by their names in
# avif.TX_SIZE_NAMES and TX_TYPE_NAMES)
REACHED = dict(
    sizes=["4x4", "8x8", "16x16", "32x32", "4x8", "8x4", "8x16", "16x8"],
    types=["DCT_DCT", "ADST_DCT", "DCT_ADST", "ADST_ADST", "IDTX", "V_DCT", "H_DCT"],
    tools=["tx depth", "intrabc", "intrabc residual", "corner filter", "palette y",
           "palette uv", "cfl", "filter intra", "angle delta", "upsampled edge", "edge filter"])


def counter_totals(raws) -> dict:
    """The decoder's counters summed over every payload of the files."""
    counts = [c for raw in raws for _, _, cs in placed_payloads(raw) for c in cs]
    return {k: [sum(x) for x in zip(*(c[k] for c in counts))] if isinstance(counts[0][k], list)
            else sum(c[k] for c in counts) for k in counts[0]}


def test_lossy_tool_counters_reach_every_tool():
    """Summed over the filter-free lossy fixtures, the decoder took each
    transform size, transform type and tool of `REACHED` at least once,
    and no other transform size or type (CHANGES.md says why Pillow's
    writer makes none of the others)."""
    total = counter_totals(fixture(e["file"]) for e in FILTER_FREE)
    sizes = {n for n, v in zip(avif.TX_SIZE_NAMES, total["tx sizes"]) if v}
    types = {n for n, v in zip(avif.TX_TYPE_NAMES, total["tx types"]) if v}
    assert sizes == set(REACHED["sizes"])
    assert types == set(REACHED["types"])
    for tool in REACHED["tools"]:
        assert total[tool] > 0, tool
    assert total["tiles"] > len(FILTER_FREE) and total["padding"] == 0


# (label, image, encode options, transform sizes it must reach) of encodes made here
ENCODES = [
    ("photo-q50-loop-filter-off", "photo", dict(quality=50, advanced={"loopfilter-control": "0"}),
     ["16x16", "32x32"]),
    ("photo-q30-reduced-tx-set", "photo",
     dict(quality=30, advanced={"loopfilter-control": "0", "reduced-tx-type-set": "1"}),
     ["32x32"]),
    ("texture-0-q40-444-speed-1", 0, dict(quality=40, subsampling="4:4:4", speed=1),
     ["32x16", "8x16"]),
    ("texture-1-q60-444-speed-3", 1, dict(quality=60, subsampling="4:4:4", speed=3),
     ["16x4", "4x8"]),
    ("texture-3-q90-444", 3, dict(quality=90, subsampling="4:4:4"), ["32x32"]),
]


@pytest.fixture(scope="module")
def sources():
    out = dict(enumerate(breaktime_textures()[1]))
    out["photo"] = photo_crop()
    return out


@pytest.mark.parametrize("label, image, options, sizes", ENCODES, ids=[e[0] for e in ENCODES])
def test_lossy_encode_decodes_as_pillow(label, image, options, sizes, sources):
    raw = encode(sources[image], **options)
    frame = avif.header_record(raw)["colour"]["frame"]
    assert not any(frame["loop_filter"]) and frame["cdef"] is None
    assert frame["reduced_tx_set"] == ("reduced" in label)
    want, got = outcome(raw), port_outcome(raw, f"{label}.avif")
    assert not isinstance(want, Exception) and same(want, got)
    total = counter_totals([raw])
    reached = {n for n, v in zip(avif.TX_SIZE_NAMES, total["tx sizes"]) if v}
    assert set(sizes) <= reached, reached



@pytest.mark.parametrize("entry", FILTERED, ids=lambda e: e["file"])
def test_filtered_planes_equal_dav1d(entry):
    """A deblocked, CDEF'd or restored file: each payload's planes, after
    the filters, equal dav1d's (alpha's as libavif's alpha plane)."""
    assert_planes_equal_dav1d(entry)


@pytest.mark.parametrize("entry", FILTERED, ids=lambda e: e["file"])
def test_filtered_rgba_equals_pillow(entry):
    assert expected_rgba_matches(entry, decode_image_u8(fixture(entry["file"]), entry["file"]))


def test_loop_filter_delta_enabled_is_read():
    """Every lossy fixture's loop_filter_params() has
    loop_filter_delta_enabled 1 and no update: the ref deltas are the key
    frame's defaults, and an intra block's level 10 filters as 11
    (lvl + (loop_filter_ref_deltas[INTRA_FRAME] << (lvl >> 5))). The planes
    of the 1024^2 photo at level 10 equal those of its header rewritten to
    level 11 without deltas, and dav1d's; at level 10 without deltas they
    differ."""
    raw = fixture(PHOTO)
    h = avif.open_avif(raw)
    data, parsed = avif._payload(raw, h.idat, h.colour[0]), avif.headers(raw, h)["colour"][0]
    lf = parsed["frame"]["loop_filter"]
    assert (lf["levels"], lf["delta_enabled"], lf["delta_update"]) == ([10] * 4, 1, 0)
    assert lf["ref_deltas"] == [1, 0, 0, 0, -1, 0, -1, -1] and lf["mode_deltas"] == [0, 0]
    assert avif._filter_params(parsed["frame"])[:7] == [10, 10, 10, 10, 0, 1, 1]
    for e in FILTER_FREE + FILTERED:
        frame = e["headers"]["colour"]["frame"]
        if any(frame["loop_filter"]):
            fh = avif.headers(fixture(e["file"]))["colour"][0]["frame"]
            assert fh["loop_filter"]["delta_enabled"] == 1, e["file"]
    want = planes_of(next(e for e in FILTERED if e["file"] == PHOTO))

    def planes_at(level: int, enabled: int) -> dict:
        p = copy.deepcopy(parsed)
        p["frame"]["loop_filter"].update(levels=[level] * 4, delta_enabled=enabled)
        return avif.decode_av1(data, p)[0]

    for got in (avif.decode_av1(data, parsed)[0], planes_at(11, 0)):
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    assert any((planes_at(10, 0)[k] != want[k]).any() for k in ("y", "u", "v"))


# the in-loop filters' counters the filtered fixtures and their committed edits reach: each
# deblocking filter length (luma 4, 8, 14 taps; chroma 4, 6), CDEF on luma and on chroma,
# each restoration kind
FILTER_PATHS = [("deblock luma", 0), ("deblock luma", 1), ("deblock luma", 2),
                ("deblock chroma", 0), ("deblock chroma", 1), ("cdef luma", None),
                ("cdef chroma", None), ("lr wiener", None), ("lr sgrproj", None),
                ("lr sgr r0 0", None), ("lr sgr r1 0", None)]


def test_filter_counters_reach_every_filter_path():
    """Summed over the filtered fixtures and the edits of FILTER_EDITS,
    the filters took every path of FILTER_PATHS, and CDEF skipped a 64x64
    block whose cdef_idx is -1 (an edit's: aom writes no 64x64 of skipped
    blocks in these files); the filter-free lossy fixtures take none of the
    paths."""
    raws = [fixture(e["file"]) for e in FILTERED]
    raws += [edit(fixture(name), kind, where, value, tile_span(fixture(name)))
             for _, name, kind, where, value, _ in FILTER_EDITS]
    total = counter_totals(raws)
    for key, slot in FILTER_PATHS:
        assert (total[key] if slot is None else total[key][slot]) > 0, (key, slot)
    assert total["cdef skipped"] > 0
    free = counter_totals(fixture(e["file"]) for e in FILTER_FREE)
    for key, slot in FILTER_PATHS:
        assert (free[key] if slot is None else free[key][slot]) == 0, (key, slot)


# edits inside filtered fixtures' tile data whose streams reach what no fixture reaches:
# (label, file, kind, where, value, counter)
FILTER_EDITS = [
    ("cdef-skipped-64x64", "q50-breaktime-2-420-tiles-2x2-cdef.avif", "flip",
     0.33718386474632744, 22576, "cdef skipped"),
]


@pytest.mark.parametrize("label, name, kind, where, value, counter", FILTER_EDITS,
                         ids=[r[0] for r in FILTER_EDITS])
def test_edited_filtered_tile_data_reaches_what_no_fixture_does(label, name, kind, where, value,
                                                                 counter):
    """An edit of a filtered fixture's tile data that reaches a filter path
    no fixture reaches decodes to Pillow's pixels."""
    raw = fixture(name)
    want, got = tile_case(raw, kind, where, value)
    assert not isinstance(want, Exception) and same(want, got)
    assert counter_totals([edit(raw, kind, where, value, tile_span(raw))])[counter] > 0


def edited_header(tool: str) -> dict:
    """The frame header of a filter-free lossy fixture with `tool` on."""
    raw = fixture("q90-420-full.avif")
    fh = copy.deepcopy(avif.headers(raw)["colour"][0]["frame"])
    if tool == "deblocking":
        fh["loop_filter"]["levels"] = [0, 1, 0, 0]
    elif tool == "CDEF":
        fh["cdef"]["strengths"] = [((0, 0), (1, 0))]
    elif tool == "loop restoration":
        fh["restoration"]["types"] = ["NONE", "WIENER", "NONE"]
    elif tool == "superres":
        fh["frame_width"] -= 4
    elif tool == "film grain":
        fh["film_grain"] = dict(seed=1)
    elif tool == "quantiser matrices":
        fh["quant"]["qmatrix"] = 1
    elif tool == "segmentation":
        fh["segmentation"]["enabled"] = 1
    else:
        fh["delta_q"] = 1
    return fh


@pytest.mark.parametrize("tool", ["deblocking", "CDEF", "loop restoration", "superres",
                                  "film grain", "quantiser matrices", "segmentation",
                                  "delta q/lf"])
def test_each_tool_the_decoder_lacks_is_refused_by_name(tool):
    """The in-loop filters are decoded: a header with deblocking, CDEF or
    loop restoration turned on passes `tool_refusal`; each other tool is
    refused by its name."""
    want = None if tool in ("deblocking", "CDEF", "loop restoration") else (
        f"AV1 tile data (lossy, {tool})")
    assert avif.tool_refusal(edited_header(tool)) == want
    fh = avif.headers(fixture("q90-420-full.avif"))["colour"][0]["frame"]
    assert avif.tool_refusal(fh) is None


def test_loop_restoration_is_refused_by_name(sources):
    """aom at speed 0 with the loop filter off turns loop restoration on
    (no longer refused): Pillow decodes the file, and the port decodes it
    to Pillow's pixels through its restoration units."""
    raw = encode(sources["photo"], quality=60, speed=0, advanced={"loopfilter-control": "0"})
    assert any(t != "NONE" for t in avif.header_record(raw)["colour"]["frame"]["restoration"])
    want, got = outcome(raw), port_outcome(raw, "restored.avif")
    assert not isinstance(want, Exception) and same(want, got)
    total = counter_totals([raw])
    assert total["lr wiener"] + total["lr sgrproj"] > 0


@pytest.mark.parametrize("w, h", [(23, 17), (17, 23)])
@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4"])
def test_filtered_odd_sizes_decode_as_pillow(w, h, sub):
    """Odd widths and heights, deblocked (level 26) and CDEF'd: the
    deblocking edges stop at FrameWidth and FrameHeight while their taps
    and CDEF's read the decoded MI area beyond them; Pillow's pixels."""
    raw = encode(Image.fromarray(picture(h, w, 11)), quality=30, subsampling=sub,
                 advanced=CDEF_ON)
    frame = avif.header_record(raw)["colour"]["frame"]
    assert frame["loop_filter"] == [26] * 4 and any(map(any, frame["cdef"]["strengths"]))
    want, got = outcome(raw), port_outcome(raw, "odd.avif")
    assert not isinstance(want, Exception) and same(want, got)


# the tools aom makes here that the decoder lacks: (name, encode options)
UNDECODED = [("quantiser matrices", {"enable-qm": "1"}),
             ("film grain", {"denoise-noise-level": "25"}),
             ("delta q/lf", {"deltaq-mode": "2", "enable-chroma-deltaq": "1"})]


@pytest.mark.parametrize("tool, advanced", UNDECODED, ids=[u[0] for u in UNDECODED])
def test_tools_aom_writes_here_are_refused_by_name(tool, advanced):
    """Pillow's writer makes quantiser matrices, film grain and delta q
    with these aom options; Pillow decodes each file, and the port refuses
    it by name (the decoder's open faults, in ROADMAP.md)."""
    raw = encode(photo_crop(128), advanced=advanced)
    assert not isinstance(outcome(raw), Exception)
    with pytest.raises(NotImplementedError) as e:
        decode_image_u8(raw, "undecoded.avif")
    assert f"AVIF AV1 tile data (lossy, {tool})" in str(e.value)
    assert FORMATS_TODO.split(":")[0] in str(e.value)


EDIT_CASES = [(e["file"], k) for e in FILTER_FREE for k in range(3 if "planes" in e else 2)]
FILTERED_EDIT_CASES = [(e["file"], k) for e in FILTERED for k in range(2)]


@pytest.mark.parametrize("name, k", EDIT_CASES, ids=str)
def test_edited_lossy_tile_data_decodes_as_pillow(name, k):
    """A fixed, derandomised edit inside the lossy tile data (seeded by the
    name and k): Pillow's pixels, or a refusal where Pillow refuses."""
    rng = np.random.default_rng([k, 11] + list(name.encode()))
    kind = TILE_EDITS[int(rng.integers(0, len(TILE_EDITS)))]
    where, value = float(rng.random()), int(rng.integers(0, 2**16))
    want, got = tile_case(fixture(name), kind, where, value)
    assert same(want, got), (kind, where, value, want if isinstance(want, Exception) else "",
                             got if isinstance(got, Exception) else "")


@pytest.mark.parametrize("name, k", FILTERED_EDIT_CASES, ids=str)
def test_edited_filtered_tile_data_decodes_as_pillow(name, k):
    """A fixed, derandomised edit inside a filtered fixture's tile data
    (seeded by the name and k): Pillow's pixels, deblocked, CDEF'd and
    restored as the edited stream says, or a refusal where Pillow refuses."""
    rng = np.random.default_rng([k, 13] + list(name.encode()))
    kind = TILE_EDITS[int(rng.integers(0, len(TILE_EDITS)))]
    where, value = float(rng.random()), int(rng.integers(0, 2**16))
    want, got = tile_case(fixture(name), kind, where, value)
    assert same(want, got), (kind, where, value, want if isinstance(want, Exception) else "",
                             got if isinstance(got, Exception) else "")


def test_64x32_transform_reads_the_wide_contexts():
    """The edit the fuzz found first: a zero run in q50-breaktime-1-420's
    tile data makes a 64x32 block code one TX_64X32 luma transform, whose
    32x32 corner takes the coefficient contexts of a wide transform
    (Coeff_Base_Ctx_Offset by the transform's own shape, as dav1d and
    libaom read it). Pillow refuses the edit (its symbols then read past
    the tile) and so does the port; with the tile's bytes from 951 on
    zeroed too, Pillow decodes it and the port's pixels equal Pillow's,
    the 64-point DCT's among them."""
    raw = fixture("q50-breaktime-1-420.avif")
    where, value = 0.09213215810638176, 41353
    want, got = tile_case(raw, "zero", where, value)
    assert isinstance(want, Exception) and isinstance(got, ValueError)
    start, length = tile_span(raw)
    edited = edit(raw, "zero", where, value, (start, length))
    variant = edited[: start + 951] + bytes(length - 951) + edited[start + length :]
    want, got = outcome(variant), port_outcome(variant, "variant.avif")
    assert not isinstance(want, Exception) and same(want, got)
    sizes = counter_totals([variant])["tx sizes"]
    assert sizes[avif.TX_SIZE_NAMES.index("64x32")] > 0


@pytest.mark.parametrize("name, kind, where, value", [
    ("q90-444-premultiplied-limited.avif", "byte", 0.006542887468258263, 16841),
    ("q90-420-premultiplied.avif", "flip", 0.18451576765811883, 30285)])
def test_unpremultiply_packs_words_as_libyuv_does(name, kind, where, value):
    """The edits the fuzz found next: the decoded planes equal dav1d's, but
    the edit leaves pixels whose colour is 128 or more over an alpha of 1.
    libyuv's ARGBUnattenuate packs its 16-bit words to bytes with signed
    saturation, so such a colour comes out 0 (and one of 1-127 comes out
    255); the colour stage does the same."""
    want, got = tile_case(fixture(name), kind, where, value)
    assert not isinstance(want, Exception) and same(want, got)
    assert ((want[..., 3] == 1) & (want[..., :3] == 0).any(-1)).any()


@pytest.mark.parametrize("name, kind, where, value", [
    ("q90-breaktime-5-420.avif", "byte", 0.8995360565912561, 30053),
    ("q90-photo-256-444.avif", "flip", 0.37423977525427055, 64089)])
def test_transform_saturates_each_rotation_as_dav1d_does(name, kind, where, value):
    """Edits the fuzz found that leave a coefficient at the dequantiser's
    clamp in a 64x16 and a 32x32 DCT, whose stages then leave 16 bits (a
    stream the range rule forbids): dav1d saturates each rotation's output
    to 16 bits, and so do the port's transforms, pixel for pixel."""
    want, got = tile_case(fixture(name), kind, where, value)
    assert not isinstance(want, Exception) and same(want, got)


@pytest.mark.parametrize("name, kind, where, value", [
    ("container-grid-1x1.avif", "zero", 0.43907016071903393, 56276),
    ("container-grid-1x1.avif", "flip", 0.466693108994537, 29820),
    ("container-grid-1x1.avif", "flip", 0.4486286788422281, 37567),
    ("q90-breaktime-5-420.avif", "flip", 0.1733165030000855, 45047),
    ("q90-breaktime-5-420.avif", "zero", 0.5289186458008126, 22395),
    ("q90-420-exif-item.avif", "byte", 0.4946682382064518, 32894),
    ("q90-photo-256-420.avif", "flip", 0.5143027058412049, 13563),
    ("container-grid-1x1.avif", "byte", 0.6470243942387207, 29284),
    ("q90-420-limited-alpha.avif", "byte", 0.06598783649899376, 9020),
    ("two-frames.avif", "flip", 0.08840527769405282, 22830)])
def test_transform_wraps_the_rotations_dav1d_wraps(name, kind, where, value):
    """Edits the fuzz found where a coefficient at the clamp overflows a
    rotation that dav1d's x86 code wraps to 16 bits rather than
    saturating: the rotations of a DCT's odd half between its input
    rotations and its last stage (32x8 DCTs, a 16x16 chroma DCT; the last
    stage, by 32, saturates, as do a 32x32 DCT's; two 16x16 edits hold
    that) and after the first sums of the 8- and 16-point ADSTs (an 8x8
    DCT_ADST, 16x16 ADST_ADSTs in the grid's tile). The port's transforms
    wrap the same rotations, and its pixels are Pillow's."""
    want, got = tile_case(fixture(name), kind, where, value)
    assert not isinstance(want, Exception) and same(want, got)


# edits inside the tile data whose streams reach what no fixture reaches: (label, file, kind,
# where, value, counter and its slot)
REACHED_BY_EDITS = [
    ("uv-D135", "q90-444-full.avif", "flip", 0.19315906424872387, 47892, ("uv modes", 4)),
    ("uv-D157", "q90-444-full.avif", "flip", 0.6582669698339187, 48662, ("uv modes", 6)),
    ("txfm-split-and-H_ADST", "q90-breaktime-1-420.avif", "byte", 0.7656914725952747, 23450,
     ("txfm split", None)),
    ("TX_64X64", "q90-breaktime-5-420.avif", "byte", 0.0004795153185916945, 63458,
     ("tx sizes", 4)),
    ("TX_16X64-and-TX_32X64", "q90-breaktime-5-420.avif", "flip", 0.05602906547480402, 8428,
     ("tx sizes", 17)),
    ("TX_64X16", "q90-breaktime-5-420.avif", "zero", 0.26224075555839255, 43065,
     ("tx sizes", 18)),
]


@pytest.mark.parametrize("label, name, kind, where, value, counter", REACHED_BY_EDITS,
                         ids=[r[0] for r in REACHED_BY_EDITS])
def test_edited_tile_data_reaches_what_no_fixture_does(label, name, kind, where, value,
                                                        counter):
    """Pillow's writer makes no 64-point transform, no var-tx split and no
    D135 or D157 uv mode here; edits of the fixtures' tile data do, and
    decode to Pillow's pixels."""
    raw = fixture(name)
    want, got = tile_case(raw, kind, where, value)
    assert not isinstance(want, Exception) and same(want, got)
    key, slot = counter
    total = counter_totals([edit(raw, kind, where, value, tile_span(raw))])[key]
    assert (total if slot is None else total[slot]) > 0
