"""The port's JPEG 2000 decoder (rustic_tpu_torch/utils/jpeg2000.py, its
tier-1 in csrc/jpeg2000_t1.cpp) against Pillow 12.1.0 (OpenJPEG 2.5.4),
which the JAX package reads JPEG 2000 with.

Files are written by Pillow (every encoder option: the 5/3 and 9/7
wavelets, mct, signed, raw codestreams, tiles with odd tile and image
offsets, code-block and precinct sizes, resolutions, the five progression
orders, quality layers by rate and by distortion, comments, PLT; modes
L, LA, RGB, RGBA and I;16), or rebuilt here from Pillow's codestreams
(tests/test_torch_image_formats.py `j2k_with`, `jp2_wrap`,
`palette_jp2`): other precisions and signs in SIZ, scalar derived
quantisation, QCC and COC in the main and tile-part headers, a tile split
over two tile-parts, SOP and EPH markers around every packet, a TLM
segment, palette JP2s with pclr and cmap boxes, a reordering cdef box.
`decode_image_u8` must give Pillow's
`np.asarray(Image.open(...).convert("RGBA"))` bit for bit. Refused
variants raise NotImplementedError before a packet is read.

Pillow's 9/7 encoder aborts the process (an assertion in OpenJPEG's
dwt.c) on a tile whose resolution above 0 is one sample wide or high;
`safe_97` keeps every 9/7 case here away from that.
"""

import struct

import numpy as np
import pytest
from hypothesis import assume, given, settings
from hypothesis import strategies as st
from PIL import Image

from rustic_tpu_torch.ops import _build
from rustic_tpu_torch.utils import _entropy, jpeg2000
from rustic_tpu_torch.utils.png import decode_image_u8
from tests.test_torch_image_formats import (IMAGE_REFUSALS, assert_pillow_equal, box, cod_style,
                                            j2k, j2k_join, j2k_parse, j2k_with, jp2_wrap,
                                            palette_jp2, pillow, rgba, siz_component)


def modes(h, w, seed=0) -> dict:
    px = rgba(h, w, seed)
    rgb = Image.fromarray(px[..., :3])
    deep = px[..., 0].astype(np.uint16) * 251 + px[..., 1]
    return {"L": rgb.convert("L"), "LA": Image.fromarray(px).convert("LA"), "RGB": rgb,
            "RGBA": Image.fromarray(px), "I;16": Image.fromarray(deep.astype("<u2"))}


def _cdiv(a, b):
    return -(-a // b)


def safe_97(h, w, kw) -> bool:
    """False where Pillow's 9/7 encoder would meet a resolution above 0 one
    sample wide or high in some tile (it aborts there): its resolutions as
    Pillow picks them (6, fewer for a smaller tile)."""
    ox, oy = kw.get("offset", (0, 0))
    tox, toy = kw.get("tile_offset", (0, 0))
    tw, th = kw.get("tile_size", (w + ox, h + oy))
    nr = kw.get("num_resolutions", 0)
    if not nr:
        nr = 6
        while nr > 1 and min(tw, th) < 1 << (nr - 1):
            nr -= 1
    x1, y1 = ox + w, oy + h
    for q in range(_cdiv(y1 - toy, th)):
        for p in range(_cdiv(x1 - tox, tw)):
            tile = (max(tox + p * tw, ox), max(toy + q * th, oy), min(tox + (p + 1) * tw, x1),
                    min(toy + (q + 1) * th, y1))
            for r in range(1, nr):
                k = 1 << (nr - 1 - r)
                if (_cdiv(tile[2], k) - _cdiv(tile[0], k) < 2
                        or _cdiv(tile[3], k) - _cdiv(tile[1], k) < 2):
                    return False
    return True


def cod_fields(raw: bytes):
    """(progression, layers, mct, levels, transform, code-block style) of a
    file's COD."""
    cs = raw[raw.index(b"\xff\x4f\xff\x51"):]
    body = dict(j2k_parse(cs)[0])[0xFF52]
    prog, layers, mct = struct.unpack(">BHB", body[1:5])
    return prog, layers, mct, body[5], body[9], body[8]


# ---- Pillow's encoder options ---------------------------------------------------------------

ROUNDS = dict(codeblock_size=(16, 16), precinct_size=(16, 16), num_resolutions=3)
CASES = {
    "default RGB": ("RGB", {}),
    "RGB mct": ("RGB", dict(mct=1)),
    "raw codestream": ("RGB", dict(no_jp2=True, mct=1)),
    "9/7": ("RGB", dict(irreversible=True)),
    "9/7 mct": ("RGB", dict(irreversible=True, mct=1)),
    "9/7 rates": ("RGB", dict(irreversible=True, mct=1, quality_layers=[30, 10, 4])),
    "9/7 dB": ("RGB", dict(irreversible=True, quality_mode="dB", quality_layers=[25, 35, 45])),
    "L": ("L", {}), "LA": ("LA", {}), "RGBA": ("RGBA", {}), "I;16": ("I;16", {}),
    "L 9/7": ("L", dict(irreversible=True)), "RGBA 9/7": ("RGBA", dict(irreversible=True)),
    "I;16 9/7": ("I;16", dict(irreversible=True, quality_layers=[8])),
    "signed": ("RGB", dict(signed=True)), "signed 9/7": ("RGB", dict(signed=True,
                                                                   irreversible=True)),
    "comment plt": ("RGB", dict(comment="rustic", plt=True, no_jp2=True)),
    "odd tiles": ("RGB", dict(tile_size=(16, 16), tile_offset=(1, 1), offset=(2, 2))),
    "odd tiles 9/7": ("RGB", dict(tile_size=(16, 16), tile_offset=(1, 1), offset=(2, 2),
                                  irreversible=True, mct=1, num_resolutions=3)),
    "small tiles": ("RGBA", dict(tile_size=(8, 8), tile_offset=(3, 2), offset=(5, 7))),
    "one resolution": ("RGB", dict(num_resolutions=1)),
    "blocks 4x64": ("RGB", dict(codeblock_size=(4, 64))),
    "blocks 64x4 9/7": ("RGB", dict(codeblock_size=(64, 4), irreversible=True)),
    "precincts 16": ("RGB", ROUNDS),
    "precincts 2": ("RGB", dict(precinct_size=(2, 4), codeblock_size=(4, 4))),
    **{f"{p} layers": ("RGB", dict(progression=p, quality_mode="rates",
                                   quality_layers=[40, 20, 8], **ROUNDS))
       for p in jpeg2000.PROGRESSIONS},
    **{f"{p} tiles 9/7": ("RGB", dict(progression=p, tile_size=(24, 20), tile_offset=(3, 1),
                                      offset=(5, 4), irreversible=True, quality_layers=[20, 5],
                                      codeblock_size=(8, 8), precinct_size=(8, 16),
                                      num_resolutions=3))
       for p in jpeg2000.PROGRESSIONS},
}
SIZES = [(21, 35), (35, 21)]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_encoder_options_match_pillow(case, size):
    mode, kw = CASES[case]
    assert not kw.get("irreversible") or safe_97(*size, kw)
    raw = j2k(modes(*size, seed=len(case))[mode], **kw)
    assert raw[:4] == (jpeg2000.J2K_SIGNATURE if kw.get("no_jp2") else b"\0\0\0\x0c")
    assert cod_fields(raw)[4] == (0 if kw.get("irreversible") else 1)
    assert_pillow_equal(raw)


def test_cases_reach_their_variant():
    """The grid's files carry what their names say: each progression order,
    three layers, the 9/7, the component transform."""
    for p, name in enumerate(jpeg2000.PROGRESSIONS):
        mode, kw = CASES[f"{name} layers"]
        assert cod_fields(j2k(modes(21, 35)[mode], **kw))[:2] == (p, 3)
    assert cod_fields(j2k(modes(21, 35)["RGB"], **CASES["9/7 mct"][1]))[2:5:2] == (1, 0)
    assert cod_fields(j2k(modes(21, 35)["RGB"]))[2] == 0


@settings(max_examples=25, deadline=None, derandomize=True)
@given(h=st.integers(1, 40), w=st.integers(1, 40), mode=st.sampled_from(list(modes(1, 1))),
       irreversible=st.booleans(), mct=st.integers(0, 1), signed=st.booleans(),
       no_jp2=st.booleans(), progression=st.sampled_from(jpeg2000.PROGRESSIONS),
       resolutions=st.integers(1, 4), block=st.tuples(st.sampled_from([4, 8, 16, 64]),
                                                      st.sampled_from([4, 8, 32])),
       precinct=st.one_of(st.none(), st.tuples(st.sampled_from([4, 8, 32]),
                                               st.sampled_from([4, 16, 64]))),
       layers=st.lists(st.sampled_from([2, 5, 10, 20, 40]), max_size=3),
       tiles=st.one_of(st.none(), st.tuples(st.integers(8, 24), st.integers(8, 24),
                                            st.integers(0, 4), st.integers(0, 4),
                                            st.integers(0, 7), st.integers(0, 7))),
       seed=st.integers(0, 1000))
def test_random_options_match_pillow(h, w, mode, irreversible, mct, signed, no_jp2, progression,
                                     resolutions, block, precinct, layers, tiles, seed):
    kw = dict(irreversible=irreversible, mct=mct, signed=signed, no_jp2=no_jp2,
              progression=progression, num_resolutions=resolutions, codeblock_size=block)
    if precinct:
        kw["precinct_size"] = precinct
    if layers:
        kw["quality_layers"] = sorted(layers, reverse=True)
    if tiles:
        tw, th, tox, toy, dx, dy = tiles
        kw.update(tile_size=(tw, th), tile_offset=(tox, toy),
                  offset=(tox + min(dx, tw - 1), toy + min(dy, th - 1)))
    size_ok = all(min(t) >= 1 << (resolutions - 1) for t in [kw.get("tile_size", (w, h))])
    assume(size_ok and (not irreversible or safe_97(h, w, kw)))
    raw = j2k(modes(h, w, seed)[mode], **kw)
    assert_pillow_equal(raw)


# ---- rebuilt codestreams ----------------------------------------------------------------------

PRECISIONS = [1, 4, 7, 9, 12, 16, 17, 24, 31]


@pytest.mark.parametrize("irreversible", [False, True], ids=["5-3", "9-7"])
@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_precisions_match_pillow(mode, prec, signed, irreversible):
    """SIZ's precision and sign set on each component of a raw codestream:
    the DC shift, the clamp, the 9/7 steps and Pillow's unpackers (mode L
    turns I;16 above 8 bits)."""
    cs = j2k(modes(9, 13, seed=prec)[mode], no_jp2=True, irreversible=irreversible)
    n = 1 if mode == "L" else 3
    for c in range(n):
        cs = j2k_with(cs, siz=siz_component(c, ssiz=(0x80 if signed else 0) | (prec - 1)))
    assert_pillow_equal(cs)


def test_i16_jp2_and_its_unpacker():
    """An I;16 JP2 at 12 bits (ihdr and SIZ edited): Pillow shifts it left
    4 and clips it to 255."""
    cs = j2k(modes(9, 13)["L"], no_jp2=True)
    cs = j2k_with(cs, siz=siz_component(0, ssiz=11))
    raw = jp2_wrap(cs, colr=struct.pack(">BBBI", 1, 0, 0, 17))
    assert_pillow_equal(raw)


def _qcd_derived(body: bytes) -> bytes:
    """An expounded QCD turned scalar derived: the LL step alone."""
    assert body[0] & 31 == 2
    return bytes([(body[0] & ~31) | 1]) + body[1:3]


def test_scalar_derived_quantisation_matches_pillow():
    cs = j2k(modes(33, 29)["RGB"], no_jp2=True, irreversible=True, mct=1)
    main, parts = j2k_parse(cs)
    main = [(m, _qcd_derived(b) if m == 0xFF5C else b) for m, b in main]
    assert_pillow_equal(j2k_join(main, parts))


@pytest.mark.parametrize("where", ["main", "tile-part"])
def test_qcc_and_coc_match_pillow(where):
    """A QCC for component 1 with other step mantissas (the 9/7 steps of
    that component change, and Pillow's decode with them), a COC restating
    COD for component 2, and a QCD restated in the tile-part header."""
    cs = j2k(modes(27, 31)["RGB"], no_jp2=True, irreversible=True)
    main, _parts = j2k_parse(cs)
    qcd, cod = dict(main)[0xFF5C], dict(main)[0xFF52]
    steps = bytes(b ^ 0x15 if k % 2 else b for k, b in enumerate(qcd[1:]))
    segs = [(0xFF5D, bytes([1, qcd[0]]) + steps), (0xFF53, bytes([2, 0]) + cod[5:])]
    if where == "main":
        raw = j2k_with(cs, segs)
    else:
        raw = j2k_with(cs, part_extra=[(0xFF5C, qcd)] + segs)
    assert not np.array_equal(pillow(raw), pillow(cs))
    assert_pillow_equal(raw)


def test_tile_parts_tlm_and_comments_match_pillow():
    """Each tile's data split over two tile-parts (TPsot 0 and 1), a TLM
    segment in the main header, a COM in a tile-part header."""
    cs = j2k(modes(30, 26)["RGB"], no_jp2=True, tile_size=(16, 16), mct=1)
    main, parts = j2k_parse(cs)
    split = []
    for tp in parts:
        half = len(tp["data"]) // 2
        split += [dict(tp, parts=2, data=tp["data"][:half], segs=[(0xFF64, b"\0\1split")]),
                  dict(tp, part=1, parts=2, data=tp["data"][half:], segs=[])]
    tlm = bytes([0, 0x60]) + b"".join(struct.pack(">HI", tp["tile"], 0) for tp in split)
    raw = j2k_join(main + [(0xFF55, tlm)], split)
    np.testing.assert_array_equal(pillow(raw), pillow(cs))
    assert_pillow_equal(raw)


@pytest.mark.parametrize("progression", ["LRCP", "RPCL"])
def test_sop_and_eph_are_skipped(progression):
    """SOP before and EPH after every packet header (COD's Scod says so),
    the packets found by the decoder's own walk of the plain file."""
    cs = j2k(modes(26, 30)["RGB"], no_jp2=True, progression=progression, tile_size=(16, 32),
             quality_layers=[20, 5], precinct_size=(16, 16), codeblock_size=(8, 8))
    image = jpeg2000._Image(jpeg2000._Codestream(cs))
    main, parts = j2k_parse(cs)
    for tp in parts:
        data, out = tp["data"], bytearray()
        for k, (start, body, end) in enumerate(image.packets[tp["tile"]]):
            out += b"\xff\x91\x00\x04" + struct.pack(">H", k) + data[start:body] + b"\xff\x92"
            out += data[body:end]
        tp["data"] = bytes(out)
    main = [(m, bytes([b[0] | 6]) + b[1:] if m == 0xFF52 else b) for m, b in main]
    raw = j2k_join(main, parts)
    np.testing.assert_array_equal(pillow(raw), pillow(cs))
    assert_pillow_equal(raw)


ONE_SAMPLE = {
    "odd tile edge": ((21, 35), dict(tile_size=(16, 16), tile_offset=(1, 1), offset=(2, 2),
                                     num_resolutions=4)),
    "one-row tiles": ((17, 20), dict(tile_size=(16, 16), num_resolutions=3)),
    "one row at an odd offset": ((1, 23), dict(tile_size=(30, 8), tile_offset=(0, 3),
                                               offset=(1, 5), num_resolutions=3)),
}


@pytest.mark.parametrize("case", list(ONE_SAMPLE))
def test_97_on_one_sample_resolutions(case):
    """A 5/3 codestream with resolutions one sample wide or high, read as a
    9/7 one (COD's transform byte set to 0; Pillow's 9/7 encoder cannot
    write such a file): OpenJPEG leaves a lone sample as it is, where the
    5/3 halves an odd one."""
    (h, w), kw = ONE_SAMPLE[case]
    assert not safe_97(h, w, kw)
    cs = j2k(modes(h, w)["RGB"], no_jp2=True, mct=1, **kw)
    assert_pillow_equal(cs)
    assert_pillow_equal(j2k_with(cs, cod=lambda body: body[:9] + b"\0" + body[10:]))


# ---- JP2 boxes --------------------------------------------------------------------------------

PALETTES = {
    "rgb": (12, 3, False, 0), "rgba": (12, 4, False, 0), "repeated colours": (12, 3, True, 0),
    "indices past the palette": (5, 3, False, 0), "with alpha (PA)": (12, 3, False, 1),
    "9/7 indices": (12, 3, False, 2),
}


@pytest.mark.parametrize("case", list(PALETTES))
def test_palette_jp2_matches_pillow(case):
    """pclr and cmap boxes around Pillow's codestream of the indices:
    Pillow's mode P (or PA), its palette built colour by colour (a repeated
    colour kept once, so later indices shift), indices past it black."""
    n, npc, repeat, kind = PALETTES[case]
    rng = np.random.default_rng(n + npc)
    idx = rng.integers(0, 12, (11, 17)).astype(np.uint8)
    pal = rng.integers(0, 256, (n, npc)).astype(np.uint8)
    if repeat:
        pal[4:7] = pal[0:3]
    alpha = rng.integers(0, 256, idx.shape).astype(np.uint8) if kind == 1 else None
    raw = palette_jp2(idx, pal, alpha, irreversible=kind == 2)
    assert Image.open(__import__("io").BytesIO(raw)).mode == ("PA" if kind == 1 else "P")
    assert_pillow_equal(raw)


def test_cdef_does_not_reorder_components():
    """Pillow decodes through OpenJPEG's tile API, which leaves cdef
    unapplied: a cdef box that swaps red and blue changes nothing."""
    raw = j2k(modes(9, 13)["RGBA"])
    at = raw.index(b"cdef") + 6
    swapped = raw[:at] + struct.pack(">" + "HHH" * 4, 0, 0, 3, 1, 0, 2, 2, 0, 1, 3, 1, 0) + raw[
        at + 24:]
    np.testing.assert_array_equal(pillow(swapped), pillow(raw))
    assert_pillow_equal(swapped)


def test_jp2_box_forms():
    """An extended box length (XLBox), a jp2c box of length 0 (to the end
    of the file), boxes Pillow skips (res, xml)."""
    cs = j2k(modes(9, 13)["RGB"], no_jp2=True)
    plain = jp2_wrap(cs)
    at = plain.index(b"jp2c") - 4
    long_form = plain[:at] + struct.pack(">I4sQ", 1, b"jp2c", 16 + len(cs)) + cs
    to_end = plain[:at] + struct.pack(">I4s", 0, b"jp2c") + cs
    extra = jp2_wrap(cs, box(b"res ", box(b"resc", struct.pack(">HHHHbb", 1, 1, 1, 1, 0, 0))))
    xml = plain[:at] + box(b"xml ", b"<x/>") + plain[at:]
    for raw in (long_form, to_end, extra, xml):
        assert_pillow_equal(raw)


# ---- refusals ---------------------------------------------------------------------------------

J2K_REFUSALS = [k for k in IMAGE_REFUSALS if k.startswith("JPEG 2000")]


@pytest.mark.parametrize("variant", J2K_REFUSALS)
def test_refusals_come_before_any_packet(variant):
    """Each refused variant of tests/test_torch_image_formats.py's
    IMAGE_REFUSALS raises NotImplementedError naming it with its packet
    data replaced by bytes that decode to nothing."""
    make, name = IMAGE_REFUSALS[variant]
    raw = make()
    at = raw.index(b"\xff\x93") + 2
    garbage = raw[:at] + b"\xff" * (len(raw) - at - 2) + raw[-2:]  # EOC kept
    with pytest.raises(NotImplementedError, match=f"{variant}.*ROADMAP"):
        decode_image_u8(garbage, name)


def test_refusal_cases_are_pillow_files_edited():
    """The code-block style cases are Pillow's COD with one style bit set;
    Pillow's own files have style 0."""
    raw = IMAGE_REFUSALS["JPEG 2000 code-block bypass"][0]()
    assert cod_fields(raw)[5] == 1
    assert cod_fields(j2k(modes(5, 7)["RGB"], no_jp2=True))[5] == 0
    assert cod_style(0x20)(bytes(10))[8] == 0x20


def test_tier1_without_a_compiler_raises(tmp_path, monkeypatch):
    """No Python tier-1: without g++ (and no library built yet) decoding
    raises and names the compiler."""
    raw = j2k(modes(5, 7)["RGB"])
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    _entropy.j2k_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=r"g\+\+ is not on PATH.*jpeg2000_t1.cpp"):
            decode_image_u8(raw)
    finally:
        _entropy.j2k_library.cache_clear()
    monkeypatch.undo()
    assert_pillow_equal(raw)
