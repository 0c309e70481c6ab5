"""AVIF (rustic_tpu_torch/utils/avif.py) against Pillow 12.1.0 and its
bundled libavif 1.3.0 (dav1d 1.5.1 decoding, aom 3.12.1 encoding):

- identification and the header Pillow's `_open` reports (size, mode,
  n_frames, the EXIF orientation of irot/imir) on every fixture, and on
  byte edits of them (`fuzz_case`: passed on, raised, or opened with equal
  header fields);
- the AV1 headers: the OBUs, the sequence header (av1C's configOBUs held
  equal to the payload's), the key frame's uncompressed header ending where
  the tile data begins, `CodedLossless` exactly on the quality-100 files;
- the colour stage `yuv_to_rgba` on dav1d's own planes, committed beside
  each file (`.yuv.npz`), equal to Pillow's convert("RGBA") (`.rgba.npy`);
- the decode: every fixture, lossless or lossy, deblocked, CDEF'd and
  restored or not (csrc/av1_intra.cpp with csrc/av1_filters.h), to
  Pillow's RGBA.

The fixtures of tests/data_torch/formats_avif are Pillow's writer at
qualities 100, 90 and 50, every subsampling, both ranges, with and without
alpha, premultiplied, with an ICC profile, with EXIF orientations, a
two-frame animation, and container variants the tests' own ISOBMFF writer
(`heif`) builds around Pillow's AV1 payloads (a grid, clap, irot/imir,
iloc in idat, boxes in other orders, other colr matrices, av1C with
configOBUs). `python -m tests.test_torch_image_formats_avif --make`
rewrites them on a host with Pillow's libavif: the planes are dumped
through ctypes from that libavif (`dav1d_planes`); the card's host has
neither. `--fuzz N SEED` runs N edits of each fixture against Pillow and
prints the counts by kind and outcome; `--fuzz-tiles N SEED [lossy|filtered]`
runs N edits inside the tile data of each lossless (or each filter-free
lossy, or each filtered) fixture against Pillow's decode;
`--tables` rewrites rustic_tpu_torch/csrc/av1_tables.h (tests/av1_cdf_tables.py).
The 256^2 fixtures (BreakTime's textures, lossless and lossy) and the
photo's centre crops keep each dav1d plane's sha256 in the manifest, not
a .yuv.npz, and BreakTime-AVIF.glb (three lossy textures, two of them
deblocked, CDEF'd and one restored; three lossless) with its twin sits
beside them (tests/test_torch_image_scenes.py renders the pair).
"""

import hashlib
import io
import json
import os
import struct
import sys

import numpy as np
import pytest
from PIL import Image, UnidentifiedImageError

from rustic_tpu_torch.utils import avif
from rustic_tpu_torch.utils.png import decode_image_u8, image_format
from tests.conftest import scene_path
from tests.test_torch_image_formats import glb_images, picture, replace_glb_images, rgba

AVIF_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch",
                             "formats_avif")


# ---- the tests' ISOBMFF / HEIF writer --------------------------------------------------------

def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def full_box(kind: bytes, version: int, flags: int, body: bytes) -> bytes:
    return box(kind, bytes([version]) + flags.to_bytes(3, "big") + body)


def children(data: bytes, start: int = 0, end: int = None):
    """The boxes of data[start:end] -> [(type, content start, content end)]."""
    end = len(data) if end is None else end
    out, pos = [], start
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos : pos + 8])
        out.append((kind, pos + 8, pos + size))
        pos += size
    return out


def pillow_parts(raw: bytes) -> dict:
    """A still AVIF of Pillow's writer -> its parts: each item's type, data
    and property boxes (whole boxes, in association order, with their
    essential flags), the iref boxes and the ftyp."""
    top = {k: (a, b) for k, a, b in children(raw)}
    meta = {k: (a, b) for k, a, b in children(raw, top[b"meta"][0] + 4, top[b"meta"][1])}
    ipco_at = children(raw, *meta[b"iprp"])[0]
    props = [raw[a - 8 : b] for _, a, b in children(raw, ipco_at[1], ipco_at[2])]
    ipma = children(raw, *meta[b"iprp"])[1]
    s = ipma[1] + 4
    (count,) = struct.unpack(">I", raw[s : s + 4])
    s += 4
    assoc = {}
    for _ in range(count):
        item_id, n = struct.unpack(">HB", raw[s : s + 3])
        s += 3
        assoc[item_id] = [(props[(raw[s + i] & 0x7F) - 1], raw[s + i] >> 7) for i in range(n)]
        s += n
    a, _ = meta[b"iloc"]
    (count,) = struct.unpack(">H", raw[a + 6 : a + 8])
    items, s = {}, a + 8
    for _ in range(count):
        item_id, _, n, off, length = struct.unpack(">HHHII", raw[s : s + 14])
        items[item_id] = dict(data=raw[off : off + length], props=assoc.get(item_id, []))
        s += 14
    for kind, a, b in children(raw, meta[b"iinf"][0] + 6, meta[b"iinf"][1]):
        item_id, _, item_type = struct.unpack(">HH4s", raw[a + 4 : a + 12])
        items[item_id]["type"] = item_type
        items[item_id]["name"] = raw[a + 12 : b]
    refs = [raw[a - 8 : b] for _, a, b in children(raw, meta[b"iref"][0] + 4, meta[b"iref"][1])] \
        if b"iref" in meta else []
    return dict(items=items, refs=refs, ftyp=raw[top[b"ftyp"][0] - 8 : top[b"ftyp"][1]])


def iref(kind: bytes, from_id: int, to_ids) -> bytes:
    return box(kind, struct.pack(">HH", from_id, len(to_ids)) + b"".join(
        struct.pack(">H", t) for t in to_ids))


def heif(items: dict, primary: int = 1, refs=(), brands=(b"avif", b"mif1", b"miaf"),
         major: bytes = b"avif", order=(b"pitm", b"iloc", b"iinf", b"iref", b"iprp"),
         idat=(), prop_order=None) -> bytes:
    """A HEIF file of `items` {id: {"type", "data", "props": [(property box,
    essential)], "name"}}: ftyp, meta (hdlr first, then the boxes of
    `order`), mdat with the data of every item not in `idat` (those go in
    the meta's idat box, iloc version 1 construction method 1). Property
    boxes are listed in ipco once each, in `prop_order` where given."""
    ids = sorted(items)
    boxes_ = []
    for i in ids:
        for p, _ in items[i]["props"]:
            if p not in boxes_:
                boxes_.append(p)
    if prop_order is not None:
        boxes_ = [boxes_[k] for k in prop_order]
    ipco = box(b"ipco", b"".join(boxes_))
    ipma = full_box(b"ipma", 0, 0, struct.pack(">I", len(ids)) + b"".join(
        struct.pack(">HB", i, len(items[i]["props"])) + bytes(
            (e << 7) | (boxes_.index(p) + 1) for p, e in items[i]["props"]) for i in ids))
    iinf = full_box(b"iinf", 0, 0, struct.pack(">H", len(ids)) + b"".join(
        full_box(b"infe", 2, 0, struct.pack(">HH4s", i, 0, items[i]["type"])
                 + items[i].get("name", b"\0")) for i in ids))
    version = 1 if idat else 0

    def iloc(offsets):
        body = bytes([0x44, 0x00]) + struct.pack(">H", len(ids))
        for i in ids:
            body += struct.pack(">H", i) + (struct.pack(">H", 1 if i in idat else 0)
                                            if version else b"")
            body += struct.pack(">HHII", 0, 1, offsets[i], len(items[i]["data"]))
        return full_box(b"iloc", version, 0, body)

    ftyp = box(b"ftyp", major + bytes(4) + b"".join(brands))
    hdlr = full_box(b"hdlr", 0, 0, bytes(4) + b"pict" + bytes(12) + b"\0")
    parts = {b"pitm": full_box(b"pitm", 0, 0, struct.pack(">H", primary)),
             b"iinf": iinf, b"iprp": box(b"iprp", ipco + ipma),
             b"iref": full_box(b"iref", 0, 0, b"".join(refs)) if refs else b""}
    idat_data, offsets, pos = b"", {}, 0
    for i in ids:
        if i in idat:
            offsets[i] = len(idat_data)
            idat_data += items[i]["data"]
    extra = box(b"idat", idat_data) if idat else b""

    def meta(offsets):
        parts[b"iloc"] = iloc(offsets)
        return full_box(b"meta", 0, 0, hdlr + b"".join(parts[k] for k in order) + extra)

    start = len(ftyp) + len(meta({i: 0 for i in ids})) + 8
    mdat = b""
    for i in ids:
        if i not in idat:
            offsets[i] = start + len(mdat)
            mdat += items[i]["data"]
    return ftyp + meta(offsets) + box(b"mdat", mdat)


def encode(img: Image.Image, **kw) -> bytes:
    out = io.BytesIO()
    img.save(out, "AVIF", **kw)
    return out.getvalue()


def prop(kind: bytes, body: bytes) -> bytes:
    return box(kind, body)


def nclx(cp: int, tc: int, mc: int, full: int) -> bytes:
    return box(b"colr", b"nclx" + struct.pack(">HHHB", cp, tc, mc, full << 7))


def rebuilt(raw: bytes, edit_items=None, **kw) -> bytes:
    """A Pillow still rewritten by `heif` (its items and references as they
    are, then `edit_items(items)` applied)."""
    parts = pillow_parts(raw)
    items = parts["items"]
    if edit_items:
        edit_items(items)
    return heif(items, refs=kw.pop("refs", parts["refs"]), **kw)


def with_props(add=(), drop=(), replace=None):
    """An edit of the colour item's properties: boxes of types `drop`
    removed, `replace` {type: box} swapped in, `add` [(box, essential)]
    appended."""
    def edit(items):
        props = [(replace.get(p[4:8], p) if replace else p, e) for p, e in items[1]["props"]
                 if p[4:8] not in drop]
        items[1]["props"] = props + list(add)
    return edit


def grid_file(img: Image.Image, rows: int, cols: int, tile: int, **kw) -> bytes:
    """A grid item of rows x cols tiles, each `tile` square, each tile
    Pillow's AVIF of that part of `img` (edge tiles padded), the output
    size `img`'s."""
    w, h = img.size
    padded = Image.new("RGB", (cols * tile, rows * tile))
    padded.paste(img.convert("RGB"), (0, 0))
    items = {}
    for r in range(rows):
        for c in range(cols):
            part = pillow_parts(encode(padded.crop((c * tile, r * tile, c * tile + tile,
                                                    r * tile + tile)), **kw))["items"][1]
            part["name"] = b"\0"
            items[2 + r * cols + c] = part
    ispe = full_box(b"ispe", 0, 0, struct.pack(">II", w, h))
    colr = next(p for p, _ in items[2]["props"] if p[4:8] == b"colr")
    pixi = next(p for p, _ in items[2]["props"] if p[4:8] == b"pixi")
    items[1] = dict(type=b"grid", data=bytes([0, 0, rows - 1, cols - 1]) + struct.pack(">HH", w, h),
                    props=[(ispe, 0), (pixi, 0), (colr, 0)], name=b"\0")
    return heif(items, refs=[iref(b"dimg", 1, list(range(2, 2 + rows * cols)))])


# ---- the fixtures -----------------------------------------------------------------------------

def avif_sources() -> dict:
    """name -> (bytes, kind) of every fixture."""
    img = Image.fromarray(picture(24, 30, 1))
    alpha = rgba(24, 30, 3)
    alpha[..., 3] = np.random.default_rng(0).integers(0, 256, (24, 30))
    imga = Image.fromarray(alpha)
    out = {}
    for q in (100, 90, 50):
        for sub in ("4:4:4", "4:2:2", "4:2:0", "4:0:0"):
            for rng in ("full", "limited"):
                tag = f"q{q}-{sub.replace(':', '')}-{rng}"
                kind = f"avif {sub.replace(':', '')}"
                out[f"{tag}.avif"] = (encode(img, quality=q, subsampling=sub, range=rng), kind)
                out[f"{tag}-alpha.avif"] = (encode(imga, quality=q, subsampling=sub, range=rng),
                                            kind)
    for w, h in ((23, 17), (17, 23)):  # odd widths and heights: libyuv's edge columns and rows
        odd = Image.fromarray(picture(h, w, 11))
        for sub in ("4:2:0", "4:2:2"):
            for rng in ("full", "limited"):
                out[f"q90-{sub.replace(':', '')}-{w}x{h}-{rng}.avif"] = (
                    encode(odd, quality=90, subsampling=sub, range=rng),
                    f"avif {sub.replace(':', '')}")
    odda = rgba(17, 23, 12)
    odda[..., 3] = np.random.default_rng(13).integers(0, 256, (17, 23))
    out["q90-420-23x17-full-alpha.avif"] = (encode(Image.fromarray(odda), quality=90),
                                            "avif 420")
    out["q90-422-17x23-limited-premultiplied.avif"] = (
        encode(Image.fromarray(odda.transpose(1, 0, 2).copy()), quality=90, subsampling="4:2:2",
               range="limited", alpha_premultiplied=True), "avif 422")
    out["q100-420-23x17-full.avif"] = (encode(Image.fromarray(picture(17, 23, 11)), quality=100),
                                       "avif 420")
    for q in (50, 20):  # aom's CDEF, off in its still-image defaults, and its chroma delta q
        out[f"q{q}-420-cdef.avif"] = (encode(img, quality=q, advanced=CDEF_ON), "avif 420")
    for q in (50, 90):
        out[f"q{q}-420-chroma-deltaq.avif"] = (encode(img, quality=q,
                                                      advanced={"enable-chroma-deltaq": "1"}),
                                               "avif 420")
    out["q90-420-premultiplied.avif"] = (encode(imga, quality=90, alpha_premultiplied=True),
                                         "avif 420")
    out["q90-444-premultiplied-limited.avif"] = (encode(imga, quality=90, subsampling="4:4:4",
                                                        range="limited",
                                                        alpha_premultiplied=True), "avif 444")
    out["q90-420-icc.avif"] = (encode(img, quality=90, icc_profile=bytes(range(256)) * 2),
                               "avif 420")
    for o in range(1, 9):
        exif = Image.Exif()
        exif[274] = o
        out[f"q90-420-exif-orientation-{o}.avif"] = (encode(img, quality=90, exif=exif.tobytes()),
                                                     "avif 420")
    exif = Image.Exif()
    exif[0x010F], exif[274] = "suite", 3  # an Exif item beside the orientation's irot
    out["q90-420-exif-item.avif"] = (encode(img, quality=90, exif=exif.tobytes()), "avif 420")
    frames = [Image.fromarray(picture(20, 16, s)) for s in (4, 5)]
    anim = io.BytesIO()
    frames[0].save(anim, "AVIF", save_all=True, append_images=frames[1:], quality=90,
                   duration=80)
    out["two-frames.avif"] = (anim.getvalue(), "avif 420")
    base = encode(img, quality=90)
    base444 = encode(img, quality=90, subsampling="4:4:4")
    based = encode(imga, quality=90)
    out["container-idat.avif"] = (rebuilt(base, idat=(1,)), "avif 420")
    out["container-order.avif"] = (rebuilt(based, order=(b"iprp", b"iinf", b"iref", b"iloc",
                                                         b"pitm"),
                                           prop_order=[3, 0, 5, 2, 4, 1, 6]), "avif 420")
    out["container-clap.avif"] = (rebuilt(base, with_props(add=[(prop(b"clap", struct.pack(
        ">8I", 20, 1, 16, 1, 0, 1, 0, 1)), 1)])), "avif 420")
    for angle in (None, 0, 1, 2, 3):
        for axis in (None, 0, 1):
            if angle is None and axis is None:
                continue
            add = ([(prop(b"irot", bytes([angle])), 1)] if angle is not None else []) + (
                [(prop(b"imir", bytes([axis])), 1)] if axis is not None else [])
            out[f"container-irot-{angle}-imir-{axis}.avif"] = (rebuilt(base, with_props(add=add)),
                                                               "avif 420")
    for mc, cp, full in ((1, 1, 1), (1, 1, 0), (9, 9, 1), (9, 9, 0), (2, 2, 1), (5, 5, 0),
                         (12, 1, 1), (12, 9, 0)):
        out[f"container-matrix-{mc}-primaries-{cp}-{'full' if full else 'limited'}.avif"] = (
            rebuilt(base, with_props(replace={b"colr": nclx(cp, 13, mc, full)})), "avif 420")
    out["container-identity-444.avif"] = (rebuilt(base444, with_props(
        replace={b"colr": nclx(1, 13, 0, 1)})), "avif 444")
    out["container-colr-range-over-payload.avif"] = (rebuilt(encode(img, quality=90,
                                                                    range="limited"), with_props(
        replace={b"colr": nclx(1, 13, 6, 1)})), "avif 420")
    out["container-no-colr.avif"] = (rebuilt(base, with_props(drop=(b"colr",))), "avif 420")
    out["container-no-pixi.avif"] = (rebuilt(base, with_props(drop=(b"pixi",))), "avif 420")

    def config_obus(items):
        data = items[1]["data"]
        seq = next(data[s - 2 : e] for k, _, _, s, e in avif.obus(data)
                   if k == avif.OBU_SEQUENCE_HEADER)
        items[1]["props"] = [(box(b"av1C", p[8:12] + seq) if p[4:8] == b"av1C" else p, e)
                             for p, e in items[1]["props"]]

    out["container-av1c-config-obus.avif"] = (rebuilt(base, config_obus), "avif 420")
    out["container-mif1-major.avif"] = (rebuilt(base, major=b"mif1"), "avif 420")
    out["container-grid-1x1.avif"] = (grid_file(Image.fromarray(picture(56, 60, 7)), 1, 1, 64,
                                                quality=90), "avif 420")
    for (w, h), rng in (((23, 17), "full"), ((17, 23), "limited")):  # lossless odd 4:2:2
        out[f"q100-422-{w}x{h}-{rng}.avif"] = (
            encode(Image.fromarray(picture(h, w, 11)), quality=100, subsampling="4:2:2",
                   range=rng), "avif 422")
    # aom's slowest search, which also takes SMOOTH_V and SMOOTH_H in lossless blocks
    out["q100-420-64x64-speed0.avif"] = (encode(Image.fromarray(picture(64, 64, 3)),
                                                quality=100, speed=0), "avif 420")
    out.update(breaktime_sources())
    out.update(filtered_sources())
    return out


# BreakTime-AVIF: texture i of BreakTime.glb as the fixture BT_AVIF_TEXTURES[i] names (aom
# finds screen content in textures 0 and 1: palette and intra block copy); three lossy, three
# lossless
BT_AVIF = "BreakTime-AVIF.glb"
BT_AVIF_TWIN = "BreakTime-AVIF-twin.glb"
BT_AVIF_TEXTURES = ["q90-breaktime-0-444.avif", "q100-breaktime-1-420.avif",
                    "q50-breaktime-2-420-tiles-2x2-cdef.avif", "q100-breaktime-3-444.avif",
                    "q100-breaktime-4-420.avif", "q50-breaktime-5-420-speed0-cdef.avif"]


def breaktime_textures():
    """BreakTime.glb's bytes and its six textures (RGB)."""
    with open(scene_path("BreakTime.glb"), "rb") as f:
        raw = f.read()
    return raw, [Image.open(io.BytesIO(b)).convert("RGB") for b in glb_images(raw)]


def breaktime_sources() -> dict:
    """The 256^2 fixtures: BreakTime's six textures at quality 100 at 4:4:4
    and at 4:2:0, texture 2 as 2x2 tiles, and texture 1 with an alpha item
    (a radial ramp); then lossy ones with no in-loop filter: textures 0 and
    1 with intra block copy (which turns the filters off; texture 1 at 4:4:4
    quality 80 with residuals on its copies, at 4:2:0 quality 50 in q
    context 3), texture 2 as 2x2 tiles, texture 5 (TX_MODE_LARGEST), and
    the centre 256^2 of photo-1024-420.jpg at 4:2:0 and 4:4:4 (natural
    content, TX_MODE_SELECT); and filtered ones: texture 3 at Pillow's
    defaults (deblocked), texture 2 as 2x2 tiles with CDEF (both filters
    across tile edges), texture 5 at speed 0 with CDEF (a level per
    direction and plane, CDEF, Wiener on every plane)."""
    _, textures = breaktime_textures()
    out = {}
    for i, tex in enumerate(textures):
        for sub in ("4:4:4", "4:2:0"):
            tag = sub.replace(":", "")
            out[f"q100-breaktime-{i}-{tag}.avif"] = (encode(tex, quality=100, subsampling=sub),
                                                     f"avif {tag}")
    out["q100-breaktime-2-420-tiles-2x2.avif"] = (
        encode(textures[2], quality=100, subsampling="4:2:0", tile_rows=1, tile_cols=1),
        "avif 420")
    y, x = np.mgrid[0:256, 0:256]
    ramp = np.clip(np.hypot(y - 128, x - 100) * 2, 0, 255).astype(np.uint8)
    with_alpha = np.dstack([np.asarray(textures[1]), 255 - ramp])
    out["q100-breaktime-1-444-alpha.avif"] = (encode(Image.fromarray(with_alpha), quality=100,
                                                     subsampling="4:4:4"), "avif 444")
    for i, q, sub in ((0, 90, "4:4:4"), (1, 90, "4:2:0"), (1, 50, "4:2:0"), (1, 80, "4:4:4"),
                      (5, 90, "4:2:0")):
        tag = sub.replace(":", "")
        out[f"q{q}-breaktime-{i}-{tag}.avif"] = (encode(textures[i], quality=q, subsampling=sub),
                                                 f"avif {tag}")
    out["q90-breaktime-2-420-tiles-2x2.avif"] = (
        encode(textures[2], quality=90, subsampling="4:2:0", tile_rows=1, tile_cols=1),
        "avif 420")
    crop = photo_crop()
    for sub in ("4:2:0", "4:4:4"):
        tag = sub.replace(":", "")
        out[f"q90-photo-256-{tag}.avif"] = (encode(crop, quality=90, subsampling=sub),
                                            f"avif {tag}")
    out["q75-breaktime-3-420.avif"] = (encode(textures[3]), "avif 420")
    out["q50-breaktime-2-420-tiles-2x2-cdef.avif"] = (
        encode(textures[2], quality=50, tile_rows=1, tile_cols=1, advanced=CDEF_ON), "avif 420")
    out["q50-breaktime-5-420-speed0-cdef.avif"] = (
        encode(textures[5], quality=50, speed=0, advanced=CDEF_ON), "avif 420")
    return out


CDEF_ON = {"enable-cdef": "1"}  # aom's CDEF, off in its still-image defaults


def filtered_sources() -> dict:
    """The photo's centre (`photo_crop` at 128^2, 256^2 and 512^2) made by
    the options that turn on what the in-loop filters take: CDEF with two
    strength pairs (cdef_bits 1) at every layout, in 128x128 superblocks,
    at speed 2 (a level per direction and plane), the loop filter's
    sharpness 3, and aom's speeds 0 and 1, which turn on loop restoration
    (Wiener and self-guided units; alone, with every filter, at 4:2:2 and
    at 4:4:4)."""
    crop = photo_crop()
    out = {}
    for sub in ("4:2:0", "4:2:2", "4:4:4", "4:0:0"):
        tag = sub.replace(":", "")
        img = crop.convert("L") if sub == "4:0:0" else crop
        kw = dict(subsampling=sub) if sub != "4:0:0" else {}
        out[f"q50-photo-256-{tag}-cdef.avif"] = (
            encode(img, quality=50, advanced=CDEF_ON, **kw), f"avif {tag}")
    out["q40-photo-512-420-cdef.avif"] = (encode(photo_crop(512), quality=40, advanced=CDEF_ON),
                                          "avif 420")
    out["q30-photo-256-420-speed2-cdef.avif"] = (encode(crop, quality=30, speed=2,
                                                        advanced=CDEF_ON), "avif 420")
    out["q50-photo-256-420-sharp3.avif"] = (encode(crop, quality=50,
                                                   advanced={"sharpness": "3"}), "avif 420")
    out["q60-photo-256-420-speed0-lr.avif"] = (
        encode(crop, quality=60, speed=0, advanced={"loopfilter-control": "0"}), "avif 420")
    out["q40-photo-256-420-speed0-cdef.avif"] = (encode(crop, quality=40, speed=0,
                                                        advanced=CDEF_ON), "avif 420")
    out["q40-photo-128-422-speed1.avif"] = (encode(photo_crop(128), quality=40, speed=1,
                                                   subsampling="4:2:2"), "avif 422")
    out["q50-photo-128-444-speed0.avif"] = (encode(photo_crop(128), quality=50, speed=0,
                                                   subsampling="4:4:4"), "avif 444")
    return out


def photo_image() -> Image.Image:
    with open(os.path.join(os.path.dirname(AVIF_FIXTURES), "formats", "photo-1024-420.jpg"),
              "rb") as f:
        return Image.open(io.BytesIO(f.read())).convert("RGB")


def photo_crop(size: int = 256) -> Image.Image:
    """The centre size^2 of tests/data_torch/formats/photo-1024-420.jpg."""
    photo = photo_image()
    w, h = photo.size
    half = size // 2
    return photo.crop((w // 2 - half, h // 2 - half, w // 2 + half, h // 2 + half))


def breaktime_avif_pair(sources: dict = None):
    """BreakTime-AVIF (its textures the BT_AVIF_TEXTURES fixtures) and its
    twin: each texture a PNG of Pillow's decode of its partner's."""
    raw, _ = breaktime_textures()
    sources = sources or breaktime_sources()
    files = [sources[name][0] for name in BT_AVIF_TEXTURES]
    pngs = []
    for b in files:
        png = io.BytesIO()
        Image.open(io.BytesIO(b)).convert("RGB").save(png, "PNG", optimize=True)
        pngs.append(png.getvalue())
    return (replace_glb_images(raw, files, "image/avif"),
            replace_glb_images(raw, pngs, "image/png"))


PHOTO = "photo-1024-q50-420.avif"  # the colour stage's timing (deblocked: its tile data refused)


def photo_source() -> bytes:
    return encode(photo_image(), quality=50, subsampling="4:2:0")


def dav1d_planes(raw: bytes) -> dict:
    """The planes and colour description Pillow's bundled libavif (dav1d)
    decodes an AVIF's first frame to, through ctypes into
    avifDecoderReadMemory (avifImage of libavif 1.3.0: width, height,
    depth, yuvFormat and yuvRange at 0-16, the plane pointers at 24, row
    bytes at 48, alpha at 64/72, alphaPremultiplied at 80, CICP at 104)."""
    import ctypes
    import glob

    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libavif-*.so*"))[0])
    lib.avifDecoderCreate.restype = lib.avifImageCreateEmpty.restype = ctypes.c_void_p
    lib.avifDecoderReadMemory.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_size_t]
    lib.avifDecoderDestroy.argtypes = lib.avifImageDestroy.argtypes = [ctypes.c_void_p]
    decoder, image = lib.avifDecoderCreate(), lib.avifImageCreateEmpty()
    flags = ctypes.c_uint32.from_address(decoder + 40)  # strictFlags, all set by default
    assert flags.value == 7
    flags.value = 4  # Pillow's: AVIF_STRICT_PIXI_REQUIRED and _CLAP_VALID cleared
    try:
        if lib.avifDecoderReadMemory(decoder, image, raw, len(raw)) != 0:
            raise RuntimeError("libavif does not decode the fixture")
        head = (ctypes.c_uint32 * 5).from_address(image)
        width, height, depth, fmt, full = head
        planes = (ctypes.c_void_p * 3).from_address(image + 24)
        strides = (ctypes.c_uint32 * 3).from_address(image + 48)
        alpha = ctypes.c_void_p.from_address(image + 64).value
        alpha_stride = ctypes.c_uint32.from_address(image + 72).value
        cp, tc, mc = (ctypes.c_uint16 * 3).from_address(image + 104)

        def plane(ptr, stride, w, h):
            buf = (ctypes.c_uint8 * (stride * h)).from_address(ptr)
            return np.frombuffer(bytes(buf), np.uint8).reshape(h, stride)[:, :w].copy()

        out = dict(y=plane(planes[0], strides[0], width, height))
        if fmt != 4:
            sx, sy = {1: (0, 0), 2: (1, 0), 3: (1, 1)}[fmt]
            cw, ch = (width + sx) >> sx, (height + sy) >> sy
            out["u"] = plane(planes[1], strides[1], cw, ch)
            out["v"] = plane(planes[2], strides[2], cw, ch)
        if alpha:
            out["a"] = plane(alpha, alpha_stride, width, height)
        out["colour"] = np.array([depth, fmt, full, cp, tc, mc,
                                  ctypes.c_int.from_address(image + 80).value], np.int64)
        return out
    finally:
        lib.avifImageDestroy(image)
        lib.avifDecoderDestroy(decoder)


def pillow_header(raw: bytes) -> dict:
    """What Pillow's open reports."""
    im = Image.open(io.BytesIO(raw))
    return dict(format=im.format, size=list(im.size), mode=im.mode,
                n_frames=getattr(im, "n_frames", 1), orientation=im.getexif().get(274, 1))


def port_header(raw: bytes) -> dict:
    h = avif.open_avif(raw)
    return dict(format=image_format(raw), size=[h.width, h.height], mode=h.mode,
                n_frames=h.n_frames, orientation=h.orientation)


def stage(planes: dict, raw: bytes = None) -> np.ndarray:
    """yuv_to_rgba of committed planes, with the colour description the
    port reads from the file (or libavif's, recorded beside the planes)."""
    if raw is not None:
        full, matrix, primaries = avif.colour_description(raw)
    else:
        full, primaries, matrix = (int(planes["colour"][i]) for i in (2, 3, 5))
    return avif.yuv_to_rgba(planes["y"], planes.get("u"), planes.get("v"), planes.get("a"),
                            full_range=bool(full), matrix=matrix, primaries=primaries,
                            premultiplied=bool(planes["colour"][6]))


def dav1d_records(raw: bytes) -> dict:
    """dav1d's own parse of the first colour and alpha payload (tests/
    dav1d_headers.py): the oracle of `header_record`'s fields. The port's
    container reader finds the payloads' bytes; dav1d's picture of each
    must have the size and layout of libavif's planes of the same file."""
    from tests.dav1d_headers import dav1d_record

    h = avif.open_avif(raw)
    planes = dav1d_planes(raw)
    out = {}
    for name, payloads, plane in (("colour", h.colour, "y"), ("alpha", h.alpha, "a")):
        if payloads:
            out[name] = dav1d_record(avif._payload(raw, h.idat, payloads[0]))
            width, height, layout, bpc = out[name].pop("picture")
            if h.grid is None:
                assert [height, width] == list(planes[plane].shape), name
            if name == "colour":
                assert (bpc, {0: 4, 1: 3, 2: 2, 3: 1}[layout]) == tuple(planes["colour"][:2])
    return out


def make_avif_fixtures(out_dir: str) -> dict:
    """Write every fixture, Pillow's decode (.rgba.npy, or its sha256 over
    64x64), dav1d's planes (.yuv.npz, or each plane's sha256 for the 256^2
    files), the manifest (Pillow's header, the port's AV1
    header record, dav1d's parse of the same headers) and BreakTime-AVIF
    with its twin into `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    images = []
    sources = dict(avif_sources())
    sources[PHOTO] = (photo_source(), "avif photo 420")
    for name, (raw, kind) in sources.items():
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(raw)
        stem = name.rsplit(".", 1)[0]
        want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))
        planes = dav1d_planes(raw)
        entry = dict(file=name, kind=kind, **pillow_header(raw),
                     headers=avif.header_record(raw), dav1d=dav1d_records(raw),
                     lossless=name.startswith("q100"))
        if "-breaktime-" in name or "-photo-" in name:
            entry.update(colour=planes["colour"].tolist(), planes_sha256={
                k: [list(v.shape), sha256_of(v)] for k, v in planes.items() if k != "colour"})
        else:
            entry["planes"] = stem + ".yuv.npz"
            np.savez_compressed(os.path.join(out_dir, entry["planes"]), **planes)
        if want.shape[0] * want.shape[1] > 64 * 64:
            entry.update(shape=list(want.shape), sha256=sha256_of(want))
        else:
            entry["expect"] = stem + ".rgba.npy"
            np.save(os.path.join(out_dir, entry["expect"]), want)
        images.append(entry)
    glb, twin = breaktime_avif_pair({k: sources[k] for k in BT_AVIF_TEXTURES})
    for name, data in ((BT_AVIF, glb), (BT_AVIF_TWIN, twin)):
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
    manifest = dict(images=images, scene=dict(breaktime=BT_AVIF, twin=BT_AVIF_TWIN,
                                              textures=BT_AVIF_TEXTURES))
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    return manifest


def sha256_of(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def timeless(raw: bytes) -> bytes:
    """The bytes with the creation and modification times of mvhd, tkhd
    and mdhd zeroed (an animation's writer stamps them)."""
    out = bytearray(raw)
    for kind in (b"mvhd", b"tkhd", b"mdhd"):
        at = raw.find(kind)
        while at >= 0:
            span = 16 if raw[at + 4] == 1 else 8
            out[at + 8 : at + 8 + span] = bytes(span)
            at = raw.find(kind, at + 4)
    return bytes(out)


def avif_manifest() -> dict:
    with open(os.path.join(AVIF_FIXTURES, "manifest.json")) as f:
        return json.load(f)


def fixture(name: str) -> bytes:
    with open(os.path.join(AVIF_FIXTURES, name), "rb") as f:
        return f.read()


def planes_of(entry: dict) -> dict:
    with np.load(os.path.join(AVIF_FIXTURES, entry["planes"])) as z:
        return {k: z[k] for k in z.files}


def plane_record(entry: dict) -> tuple:
    """dav1d's planes of a fixture as recorded: ({plane: shape}, libavif's
    colour description [depth, yuvFormat, range, CICP, premultiplied])."""
    if "planes" in entry:
        planes = planes_of(entry)
        return ({k: v.shape for k, v in planes.items() if k != "colour"},
                planes["colour"])
    return ({k: tuple(v[0]) for k, v in entry["planes_sha256"].items()},
            np.array(entry["colour"], np.int64))


def expected_rgba_matches(entry: dict, rgba: np.ndarray) -> bool:
    """`rgba` equals Pillow's committed decode of the fixture."""
    if "expect" in entry:
        want = np.load(os.path.join(AVIF_FIXTURES, entry["expect"]))
        return want.shape == rgba.shape and np.array_equal(want, rgba)
    return list(rgba.shape) == entry["shape"] and sha256_of(rgba) == entry["sha256"]


def filters(entry: dict) -> list:
    """The in-loop filters a fixture's payloads turn on: "deblocking" (a
    loop filter level), "CDEF" (a CDEF strength), "loop restoration" (a
    FrameRestorationType)."""
    frames = [f["frame"] for f in entry["headers"].values()]
    out = ["deblocking"] if any(any(f["loop_filter"]) for f in frames) else []
    if any(f["cdef"] and any(any(s) for s in f["cdef"]["strengths"]) for f in frames):
        out.append("CDEF")
    if any(t != "NONE" for f in frames for t in f["restoration"]):
        out.append("loop restoration")
    return out


MANIFEST = avif_manifest()["images"] if os.path.exists(
    os.path.join(AVIF_FIXTURES, "manifest.json")) else []
SMALL = [e for e in MANIFEST if "expect" in e]


# ---- Tier-1 -----------------------------------------------------------------------------------

def test_avif_fixture_writer_makes_the_committed_set():
    """The committed files are what Pillow's writer and `heif` make here,
    byte for byte, BreakTime-AVIF and its twin included; the folder stays
    within 3 MiB."""
    sources = avif_sources()
    assert {e["file"] for e in MANIFEST} == set(sources) | {PHOTO}
    for name, (raw, kind) in sources.items():
        assert timeless(fixture(name)) == timeless(raw), name
        assert next(e["kind"] for e in MANIFEST if e["file"] == name) == kind
    glb, twin = breaktime_avif_pair({k: sources[k] for k in BT_AVIF_TEXTURES})
    assert fixture(BT_AVIF) == glb and fixture(BT_AVIF_TWIN) == twin
    assert avif_manifest()["scene"] == dict(breaktime=BT_AVIF, twin=BT_AVIF_TWIN,
                                            textures=BT_AVIF_TEXTURES)
    total = sum(os.path.getsize(os.path.join(AVIF_FIXTURES, n)) for n in os.listdir(AVIF_FIXTURES))
    assert total <= 3 * 2**20


@pytest.mark.parametrize("entry", MANIFEST, ids=lambda e: e["file"])
def test_avif_header_matches_pillow(entry):
    """image_format says AVIF and the header reader reports Pillow's size,
    mode, n_frames and orientation, as committed and as Pillow opens it."""
    raw = fixture(entry["file"])
    want = {k: entry[k] for k in ("format", "size", "mode", "n_frames", "orientation")}
    assert pillow_header(raw) == want
    assert port_header(raw) == want


@pytest.mark.parametrize("entry", MANIFEST, ids=lambda e: e["file"])
def test_avif_av1_headers_match_their_record(entry):
    """The OBUs, sequence and frame headers parse to the committed record;
    CodedLossless exactly on the quality-100 files (every payload)."""
    raw = fixture(entry["file"])
    record = avif.header_record(raw)
    assert record == entry["headers"]
    frames = [record["colour"]] + ([record["alpha"]] if "alpha" in record else [])
    assert all(f["frame"]["coded_lossless"] for f in frames) == entry["lossless"]
    assert all(f["sequence"]["depth"] == 8 for f in frames)


@pytest.mark.parametrize("entry", MANIFEST, ids=lambda e: e["file"])
def test_avif_av1_headers_match_dav1d(entry):
    """Every field of the record equals dav1d 1.5.1's parse of the same
    payload (`dav1d` in the manifest, read from its Dav1dSequenceHeader and
    Dav1dFrameHeader by tests/dav1d_headers.py): the sequence header, frame
    and render size, superres, intrabc, tile_info, quantisation,
    segmentation, delta q and lf, loop filter, CDEF, loop restoration,
    tx_mode, reduced_tx_set, film grain and CodedLossless (dav1d's
    all_lossless). dav1d reads no tile_size_bytes for one tile and keeps 0."""
    record = avif.header_record(fixture(entry["file"]))
    assert set(record) == set(entry["dav1d"])
    for name, want in entry["dav1d"].items():
        frame = dict(record[name]["frame"])
        if frame["tiles"]["cols"] * frame["tiles"]["rows"] == 1:
            frame["tiles"] = dict(frame["tiles"], size_bytes=0)
        assert record[name]["sequence"] == want["sequence"], name
        assert frame == want["frame"], name


@pytest.mark.parametrize("entry", MANIFEST, ids=lambda e: e["file"])
def test_avif_av1_headers_match_libavif(entry):
    """The record against what libavif reports of its decode (the planes'
    shapes and `colour`, dumped through its C API): the depth, the
    yuvFormat of mono and ssx/ssy, the range and CICP where no colr nclx
    overrides the sequence header's, the frame's size (upscaled) as the
    image's or as a grid's tile that the image covers, and an alpha frame
    of the alpha plane's size exactly where libavif has an alpha plane."""
    raw, (shapes, colour) = fixture(entry["file"]), plane_record(entry)
    h, record = avif.open_avif(raw), avif.header_record(raw)
    depth, fmt, full, cp, tc, mc = (int(x) for x in colour[:6])
    seq, fh = record["colour"]["sequence"], record["colour"]["frame"]
    assert seq["depth"] == depth
    assert (4 if seq["mono"] else {(0, 0): 1, (1, 0): 2, (1, 1): 3}[seq["ssx"], seq["ssy"]]) == fmt
    if h.nclx is None:
        assert (seq["full_range"], seq["primaries"], seq["transfer"], seq["matrix"]) == (
            full, cp, tc, mc)
    height, width = shapes["y"]
    size = [fh["upscaled_width"], fh["size"][1]]
    if h.grid is None:
        assert size == [width, height]
    else:
        rows, cols = h.grid[:2]
        assert size[0] * cols >= width > size[0] * (cols - 1)
        assert size[1] * rows >= height > size[1] * (rows - 1)
    assert ("alpha" in record) == ("a" in shapes)
    if "alpha" in record:
        fa = record["alpha"]["frame"]
        assert [fa["upscaled_width"], fa["size"][1]] == [width, height]
        assert record["alpha"]["sequence"]["depth"] == depth


@pytest.mark.parametrize("entry", MANIFEST, ids=lambda e: e["file"])
def test_avif_decode_refuses_the_tile_data_by_name(entry):
    """No fixture's tile data is refused any more: no payload's frame
    header names a tool the decoder lacks (`tool_refusal`), and every file,
    lossless, lossy, deblocked, CDEF'd or restored, decodes to Pillow's
    RGBA (csrc/av1_intra.cpp with csrc/av1_filters.h, then the colour
    stage)."""
    raw = fixture(entry["file"])
    parsed = avif.headers(raw)
    assert all(avif.tool_refusal(p["frame"]) is None for ps in parsed.values() for p in ps)
    assert expected_rgba_matches(entry, decode_image_u8(raw, entry["file"]))


@pytest.mark.parametrize("entry", SMALL, ids=lambda e: e["file"])
def test_colour_stage_on_dav1d_planes_matches_pillow(entry):
    """yuv_to_rgba of dav1d's committed planes, with the colour description
    the port reads from the file, equals Pillow's convert("RGBA") byte for
    byte; the description equals libavif's."""
    raw, planes = fixture(entry["file"]), planes_of(entry)
    full, primaries, matrix = (int(planes["colour"][i]) for i in (2, 3, 5))
    assert avif.colour_description(raw) == (full, matrix, primaries)
    want = np.load(os.path.join(AVIF_FIXTURES, entry["expect"]))
    np.testing.assert_array_equal(stage(planes, raw), want)


def test_colour_stage_on_the_photo_matches_pillow():
    entry = next(e for e in MANIFEST if e["file"] == PHOTO)
    assert expected_rgba_matches(entry, stage(planes_of(entry), fixture(PHOTO)))


def route(entry: dict) -> str:
    """The path `yuv_to_rgba` takes for a fixture's planes (the port's
    `colour_route`, its one dispatch; not a report of libavif's)."""
    planes = planes_of(entry)
    _, matrix, primaries = avif.colour_description(fixture(entry["file"]))
    u = planes.get("u")
    return avif.colour_route(planes["y"].shape, None if u is None else u.shape, "a" in planes,
                             matrix, primaries)[0]


def test_colour_stage_covers_every_layout():
    """Among the fixtures: each subsampling at both ranges, with straight
    and premultiplied alpha; 4:2:0 and 4:2:2 at odd widths and odd heights
    at both ranges (libyuv's last column and row); each of the paths."""
    seen, odd = set(), set()
    for e in SMALL:
        planes = planes_of(e)
        fmt, full, prem = (int(planes["colour"][i]) for i in (1, 2, 6))
        seen.add((fmt, full, "a" in planes, prem))
        height, width = planes["y"].shape
        odd.add((fmt, full, width % 2, height % 2))
    for fmt in (1, 2, 3, 4):
        for full in (0, 1):
            assert (fmt, full, False, 0) in seen and (fmt, full, True, 0) in seen
    assert any(prem for *_, prem in seen)
    for fmt in (2, 3):
        for full in (0, 1):
            assert (fmt, full, 1, 1) in odd
    assert {route(e) for e in SMALL} == {"libyuv I444", "libyuv I422 linear",
                                         "libyuv I420 bilinear", "built-in mono", "libyuv I400",
                                         "built-in identity"}


def test_convert_does_not_turn_an_oriented_avif():
    """Pillow's convert("RGBA") keeps the stored layout whatever irot and
    imir say: the orientation is reported, not applied (the port does
    not apply it either: the colour stage returns the planes' layout)."""
    for o in (5, 6, 7, 8):
        entry = next(e for e in MANIFEST if e["file"] == f"q90-420-exif-orientation-{o}.avif")
        assert entry["orientation"] == o and entry["size"] == [30, 24]
        want = np.load(os.path.join(AVIF_FIXTURES, entry["expect"]))
        assert want.shape == (24, 30, 4)
        assert stage(planes_of(entry), fixture(entry["file"])).shape == want.shape


# ---- edits of the fixtures against Pillow's open ----------------------------------------------

EDITS = ["flip", "byte", "zero", "cut", "insert"]


def edit(raw: bytes, kind: str, where: float, value: int, span=None) -> bytes:
    from tests.test_torch_image_formats_variants import edit as edit_bytes

    return edit_bytes(raw, kind, where, value, span)


def pillow_open_outcome(raw: bytes):
    """Pillow's open of the bytes: ("passed on",), ("raised",), or the
    format and, for AVIF, the header fields."""
    try:
        im = Image.open(io.BytesIO(raw))
    except UnidentifiedImageError:
        return ("passed on",)
    except Exception:  # noqa: BLE001 - any other error of the open
        return ("raised",)
    if im.format != "AVIF":
        return ("opened as", im.format)
    return ("opened", tuple(im.size), im.mode, im.n_frames, im.getexif().get(274, 1))


def port_open_outcome(raw: bytes):
    try:
        fmt = image_format(raw)
    except NotImplementedError as e:
        return ("passed on",) if "unknown format" in str(e) else ("raised",)
    except ValueError:
        return ("raised",)
    if fmt != "AVIF":
        return ("opened as", fmt)
    h = avif.open_avif(raw)
    return ("opened", (h.width, h.height), h.mode, h.n_frames, h.orientation)


def fuzz_case(name: str, kind: str, where: float, value: int):
    """One edit of a fixture (anywhere after its first 4 bytes) -> (Pillow's
    open outcome, the port's)."""
    edited = edit(fixture(name), kind, where, value)
    return pillow_open_outcome(edited), port_open_outcome(edited)


def fuzz(n: int, seed: int = 0, names=None) -> dict:
    """`n` random edits of each small fixture -> counts of (kind, outcome);
    raises AssertionError at the first edit on which Pillow and the port
    disagree."""
    rng = np.random.default_rng(seed)
    counts = {}
    for name in names or [e["file"] for e in SMALL]:
        for _ in range(n):
            kind = str(rng.choice(EDITS))
            where, value = float(rng.random()), int(rng.integers(0, 2**16))
            want, got = fuzz_case(name, kind, where, value)
            if want != got:
                raise AssertionError(f"{name} {kind} at {where} ({value}): Pillow {want}, "
                                     f"port {got}")
            key = f"{kind}: {want[0]}"
            counts[key] = counts.get(key, 0) + 1
    return counts


FUZZ_CASES = [(e["file"], k) for e in SMALL for k in range(3)]


@pytest.mark.parametrize("name, k", FUZZ_CASES, ids=str)
def test_edited_avif_opens_as_pillow_opens_it(name, k):
    """A fixed, derandomised few edits of each fixture (seeded by its name
    and k): the outcome of the open equal to Pillow's."""
    rng = np.random.default_rng([k] + list(name.encode()))
    kind = EDITS[int(rng.integers(0, len(EDITS)))]
    where, value = float(rng.random()), int(rng.integers(0, 2**16))
    want, got = fuzz_case(name, kind, where, value)
    assert want == got, (kind, where, value)


# ---- edits of the lossless tile data against Pillow's decode ----------------------------------

TILE_EDITS = ["flip", "flip", "byte", "zero", "cut"]


def tile_span(raw: bytes) -> tuple:
    """(file offset, length) of the colour payload's first tile group data
    (an item in the meta's idat box counts its extents from the box's
    data)."""
    h = avif.open_avif(raw)
    in_idat, extents = h.colour[0]
    start, end = avif.headers(raw, h)["colour"][0]["tile_data"]
    return (raw.index(h.idat) if in_idat else 0) + extents[0][0] + start, end - start


def tile_case(raw: bytes, kind: str, where: float, value: int) -> tuple:
    """One edit inside the tile data -> (Pillow's RGBA or its error, the
    port's decode_image_u8 or its error)."""
    from tests.test_torch_image_formats_variants import outcome, port_outcome

    edited = edit(raw, kind, where, value, tile_span(raw))
    return outcome(edited), port_outcome(edited, "edited.avif")


def tile_fuzz_names(which: str = "lossless") -> list:
    """The fixtures of one kind: "lossless", "lossy" (no in-loop filter in
    any payload) or "filtered" (deblocked, CDEF'd or restored)."""
    kinds = {"lossless": lambda e: e["lossless"],
             "lossy": lambda e: not e["lossless"] and not filters(e),
             "filtered": lambda e: bool(filters(e))}
    return [e["file"] for e in MANIFEST if kinds[which](e)]


def fuzz_tiles(n: int, seed: int = 0, names=None) -> dict:
    """`n` edits (bit flips, bytes, zeros, cuts) inside the tile data of
    each fixture of `names` (the lossless ones by default) -> counts of
    (kind, outcome); raises AssertionError at the first edit where the
    pixels differ or only one side refuses."""
    from tests.test_torch_image_formats_variants import same

    counts = {}
    for name in names or tile_fuzz_names():
        raw = fixture(name)
        rng = np.random.default_rng([seed] + list(name.encode()))  # each file's own edits
        for _ in range(n):
            kind = str(rng.choice(TILE_EDITS))
            where, value = float(rng.random()), int(rng.integers(0, 2**16))
            want, got = tile_case(raw, kind, where, value)
            if not same(want, got):
                raise AssertionError(f"{name} {kind} at {where} ({value}): Pillow "
                                     f"{type(want).__name__}, port {type(got).__name__}")
            key = f"{kind}: {'refused' if isinstance(want, Exception) else 'decoded'}"
            counts[key] = counts.get(key, 0) + 1
    return counts


if __name__ == "__main__":
    if sys.argv[1:2] == ["--make"]:
        print(json.dumps(make_avif_fixtures(AVIF_FIXTURES)["images"][-1], indent=1))
    elif sys.argv[1:2] == ["--fuzz-tiles"]:  # --fuzz-tiles N [SEED [lossless|lossy]]
        print(json.dumps(fuzz_tiles(int(sys.argv[2]), int(sys.argv[3]) if sys.argv[3:] else 0,
                                    tile_fuzz_names(sys.argv[4]) if sys.argv[4:] else None),
                         indent=1, sort_keys=True))
    elif sys.argv[1:2] == ["--tables"]:
        from tests.av1_cdf_tables import write_header

        print(write_header())
    elif sys.argv[1:2] == ["--fuzz"]:  # --fuzz N [SEED]
        print(json.dumps(fuzz(int(sys.argv[2]), int(sys.argv[3]) if sys.argv[3:] else 0),
                         indent=1, sort_keys=True))
    else:
        print(__doc__)
