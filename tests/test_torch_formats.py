"""The port's scene formats and image decoder against the JAX package's.

OBJ (with its .mtl and texture maps), STL (ASCII and binary), PLY (ASCII,
binary little- and big-endian) and FBX (binary and ASCII), each written
by the test itself as tests/test_formats.py and tests/test_fbx.py write
theirs, load through both packages' loaders to equal `GltfScene` arrays
and materials, and through both packages' `World.from_path` to equal
scene tensors (both with their C++ BVH builders, the default).
`write_glb` scenes read back equal through both `load_glb`s. PNG files of every colour type, bit depth, key colour, palette alpha and
interlacing decode equal to Pillow's `convert("RGBA")`. All comparisons
are exact: both sides run the same NumPy arithmetic.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from rustic_tpu.scene import fbx as JF
from rustic_tpu.scene import glb_write as JGW
from rustic_tpu.scene import gltf as JG
from rustic_tpu.scene import mesh_formats as JM
from rustic_tpu.scene import obj as JO
from rustic_tpu.scene import world as JW
from rustic_tpu_torch.scene import fbx as TF
from rustic_tpu_torch.scene import glb_write as TGW
from rustic_tpu_torch.scene import gltf as TG
from rustic_tpu_torch.scene import mesh_formats as TM
from rustic_tpu_torch.scene import obj as TO
from rustic_tpu_torch.scene import world as TW
from rustic_tpu_torch.utils import png
from tests.test_fbx import ASCII_FBX, _cube_fbx
from tests.test_formats import MTL_RED, OBJ_QUAD, _stl_binary
from tests.test_torch_bvh_native import require_jax_native

torch.set_num_threads(2)

ATLAS = 64


def _write(tmp_path, name, data):
    path = os.path.join(str(tmp_path), name)
    with open(path, "wb" if isinstance(data, bytes) else "w") as f:
        f.write(data)
    return path


def same_gltf(a, b):
    for name in ("positions", "normals", "tangents", "uv0", "triangles"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert len(a.materials) == len(b.materials)
    for ma, mb in zip(a.materials, b.materials):
        for f in ("base_color", "metallic", "roughness", "emissive", "transmission", "ior"):
            assert getattr(ma, f) == getattr(mb, f), f
        for f in ("albedo_texture", "metallic_texture", "roughness_texture", "normal_texture"):
            x, y = getattr(ma, f), getattr(mb, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f)


JAX_LOADERS = {".obj": JO.load_obj, ".stl": JM.load_stl, ".ply": JM.load_ply,
               ".fbx": JF.load_fbx, ".glb": JG.load_glb}


def same_world(path):
    """The port's World.from_path(path) and the JAX World of the JAX
    loader's scene (both with an ATLAS-texel atlas) -> equal scene tensors."""
    require_jax_native()
    js = JW.World(JAX_LOADERS[os.path.splitext(path)[1]](path), ATLAS).to_device()
    ts = TW.World.from_path(path, ATLAS).to_torch("cpu")
    want_attrs = np.asarray(js.tri_attrs)
    if not ts.has_textures:
        want_attrs = JW.slim_attr_table(want_attrs)
    np.testing.assert_array_equal(ts.tri_attrs.numpy(), want_attrs)
    for name in ("tri_feats16", "tile_aabbs", "entry_rows", "bvh_min", "bvh_max",
                 "bvh_left_first", "bvh_count", "atlas"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    for name in ("n_tris", "n_alias_entries", "has_lights", "has_glass", "has_textures"):
        assert getattr(ts, name) == getattr(js, name), name
    return ts


# ---- PNG: a writer of every kind, with every scanline filter ---------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _scanlines(samples, depth, bpp, rng):
    """[h, w * n] samples -> scanlines, each with a random filter (0-4)."""
    rows = []
    for row in samples:
        if depth == 16:
            rows.append(np.frombuffer(np.asarray(row, ">u2").tobytes(), np.uint8))
        elif depth == 8:
            rows.append(np.asarray(row, np.uint8))
        else:
            per = 8 // depth
            vals = np.concatenate([row, np.zeros((-len(row)) % per, row.dtype)]).reshape(-1, per)
            shifts = np.arange(8 - depth, -1, -depth)
            rows.append((vals << shifts).sum(axis=1).astype(np.uint8))
    out = bytearray()
    prev = np.zeros_like(rows[0], np.int64)
    for cur in rows:
        cur = cur.astype(np.int64)
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        kind = int(rng.integers(0, 5))
        pred = [0, a, prev, (a + prev) // 2, _paeth(a, prev, c)][kind]
        out.append(kind)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    return bytes(out)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def make_png(samples, colour, depth, rng, plte=None, trns=None, interlace=0):
    """samples [h, w, n] ints -> PNG bytes."""
    h, w, n = samples.shape
    bpp = max(1, n * depth // 8)
    if interlace:
        data = b""
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                data += _scanlines(sub.reshape(sub.shape[0], -1), depth, bpp, rng)
    else:
        data = _scanlines(samples.reshape(h, -1), depth, bpp, rng)
    out = png.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0,
                                                          0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
         (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("colour, depth", KINDS)
def test_png_kinds_decode_as_pillow(colour, depth, interlace):
    import io

    from PIL import Image

    rng = np.random.default_rng(colour * 100 + depth * 2 + interlace)
    n = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    for h, w in ((1, 1), (5, 3), (9, 13), (16, 8)):
        for keyed in (False, True):
            plte = trns = None
            if colour == 3:
                k = min(1 << depth, 11)
                s = rng.integers(0, k, (h, w, 1))
                plte = rng.integers(0, 256, (k, 3))
                trns = bytes(rng.integers(0, 256, k - 1).astype(np.uint8)) if keyed else None
            else:
                s = rng.integers(0, 1 << depth, (h, w, n))
                if depth == 16 and colour == 0:  # Pillow clips 16-bit grey: keep some below 256
                    low = s % 3 == 0
                    s[low] = rng.integers(0, 256, int(low.sum()))
                if keyed and colour in (0, 2):  # a key colour that some pixel has
                    trns = struct.pack(">" + "H" * n, *(int(v) for v in s[h // 2, w // 2]))
            raw = make_png(s, colour, depth, rng, plte, trns, interlace)
            want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))
            got = png.decode_png(raw)
            assert got.dtype == np.uint8 and got.shape == (h, w, 4)
            np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w}, tRNS {trns}")


def test_png_refusals():
    """What Pillow refuses (a changed IHDR without its CRC, a depth its
    _MODES lacks) raises; a palette image without PLTE is not refused:
    Pillow reads it black, and so does the port."""
    import io
    import zlib

    from PIL import Image

    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"\xff\xd8\xff\xe0" + bytes(16))  # a JPEG goes to utils/jpeg.py
    rng = np.random.default_rng(0)
    bad_depth = make_png(np.zeros((2, 2, 3), np.int64), 2, 8, rng).replace(
        struct.pack(">IIBB", 2, 2, 8, 2), struct.pack(">IIBB", 2, 2, 4, 2))
    with pytest.raises(ValueError, match="checksum"):
        png.decode_png(bad_depth)
    ihdr = bad_depth[12:29]
    bad_depth = bad_depth[:29] + struct.pack(">I", zlib.crc32(ihdr)) + bad_depth[33:]
    with pytest.raises(ValueError, match="no mode Pillow opens"):
        png.decode_png(bad_depth)
    no_palette = make_png(np.zeros((2, 2, 1), np.int64), 3, 8, rng)
    np.testing.assert_array_equal(png.decode_png(no_palette),
                                  np.asarray(Image.open(io.BytesIO(no_palette)).convert("RGBA")))


# ---- APNG: frame 0 -------------------------------------------------------------------

APNG_MODES = ["RGBA", "RGB", "P", "L", "LA", "1", "I;16"]


def apng_file(mode: str, default_image: bool = False, disposal: int = 0, blend: int = 0,
              **kw) -> bytes:
    """Three frames of one mode through Pillow's APNG writer (save_all),
    frame 0 the default image (inside the animation) or, with
    `default_image`, an IDAT image of its own before the frames."""
    import io

    from PIL import Image

    from tests.test_torch_image_formats import picture

    frames = [Image.fromarray(picture(20, 24, seed)) for seed in (1, 2, 3)]
    frames[1].paste((0, 0, 0), (3, 4, 10, 12))
    if mode == "P":
        first = frames[0].quantize(12)
        frames = [first] + [f.quantize(palette=first) for f in frames[1:]]
    else:
        frames = [f.convert(mode) for f in frames]
    out = io.BytesIO()
    frames[0].save(out, "PNG", save_all=True, append_images=frames[1:], disposal=disposal,
                   blend=blend, default_image=default_image, duration=40, **kw)
    return out.getvalue()


def assert_png_as_pillow(raw: bytes):
    import io

    from PIL import Image

    try:
        want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))
    except Exception:  # noqa: BLE001 - a refusal of Pillow's
        with pytest.raises((ValueError, NotImplementedError)):
            png.decode_image_u8(raw)
        return
    np.testing.assert_array_equal(png.decode_image_u8(raw), want)


# (mode, disposal, blend, default image): Pillow's writer disposes of frames other than by
# none only in RGB and RGBA ("images do not match"), and writes no "1" default image
APNG_CASES = [(m, d, b, i) for m in APNG_MODES for d in (0, 1, 2) for b in (0, 1)
              for i in (False, True) if not (d and m not in ("RGBA", "RGB") or m == "1" and i)]


@pytest.mark.parametrize("mode, disposal, blend, default_image", APNG_CASES, ids=str)
def test_apng_frame_0_matches_pillow(mode, disposal, blend, default_image):
    """Frame 0 of Pillow's own APNGs, the default image inside the
    animation (frame 0) or outside it (its own frame 0): dispose and blend
    ops do not touch frame 0, and load_end stops at frame 1's fcTL."""
    assert_png_as_pillow(apng_file(mode, default_image, disposal, blend))


def png_chunks(raw: bytes) -> list:
    pos, out = 8, []
    while pos < len(raw):
        n = struct.unpack(">I", raw[pos : pos + 4])[0]
        out.append((raw[pos + 4 : pos + 8], raw[pos + 8 : pos + 8 + n]))
        pos += 12 + n
    return out


def apng_region(mode: str, actl, region=(10, 8, 5, 3), size=(20, 16), interlace=0) -> bytes:
    """A PNG whose canvas is `size` and whose image data is frame 0 of
    `region` (w, h, x, y), named by an fcTL before IDAT, after acTL chunks
    of the frame counts `actl` (none: no acTL)."""
    import io

    from PIL import Image

    from tests.test_torch_image_formats import picture

    w, h = region[:2]
    img = Image.fromarray(picture(h, w, 4))
    img = img.quantize(8) if mode == "P" else img.convert(mode)
    out = io.BytesIO()
    img.save(out, "PNG", interlace=interlace, **({"transparency": 2} if mode == "P" else {}))
    chunks = png_chunks(out.getvalue())
    head = [(b"IHDR", struct.pack(">II", *size) + chunks[0][1][8:])]
    head += [(b"acTL", struct.pack(">II", n, 0)) for n in actl]
    head += [c for c in chunks[1:] if c[0] not in (b"IDAT", b"IEND")]
    fctl = struct.pack(">IIIIIHHBB", 0, w, h, region[2], region[3], 1, 10, 0, 0)
    body = head + [(b"fcTL", fctl)] + [c for c in chunks if c[0] == b"IDAT"] + [(b"IEND", b"")]
    return png.PNG_SIGNATURE + b"".join(_chunk(c, d) for c, d in body)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("actl", [(), (1,), (2,), (3, 3), (0,)], ids=str)
@pytest.mark.parametrize("mode", ["RGBA", "RGB", "P", "L", "LA"])
def test_apng_frame_0_region_matches_pillow(mode, actl, interlace):
    """An fcTL before the image data makes frame 0 its region of a zero
    canvas (Pillow reads any region inside the canvas, with or without an
    acTL; two acTLs, or a count of 0, make it no animation)."""
    assert_png_as_pillow(apng_region(mode, actl, interlace=interlace))


@pytest.mark.parametrize("case", range(60))
def test_edited_apngs_match_pillow(case):
    """Byte edits of Pillow's APNGs (the variants suite's `edit`), 60 drawn
    from a fixed seed: chunk checks, sequence numbers, cuts after frame 0."""
    from tests.test_torch_image_formats_variants import EDITS, edit

    rng = np.random.default_rng(case)
    mode = ["RGBA", "RGB", "L", "P"][case % 4]
    raw = apng_file(mode, bool(case % 3 == 0), disposal=int(rng.integers(0, 3)) * (case % 4 < 2))
    kind = EDITS[int(rng.integers(0, len(EDITS)))]
    assert_png_as_pillow(edit(raw, kind, float(rng.random()), int(rng.integers(0, 2**16))))


# ---- OBJ ---------------------------------------------------------------------------


def write_textured_obj(tmp_path):
    """A quad and a lamp; the floor's material has albedo (palette PNG),
    metallic (16-bit grey), roughness (interlaced RGB) and normal maps."""
    rng = np.random.default_rng(3)
    plte = rng.integers(0, 256, (4, 3))
    _write(tmp_path, "albedo.png", make_png(rng.integers(0, 4, (8, 8, 1)), 3, 2, rng, plte,
                                            bytes([255, 128])))
    _write(tmp_path, "metal.png", make_png(rng.integers(0, 256, (4, 4, 1)), 0, 16, rng))
    _write(tmp_path, "rough.png", make_png(rng.integers(0, 256, (6, 5, 3)), 2, 8, rng,
                                           interlace=1))
    _write(tmp_path, "normal.png", make_png(rng.integers(0, 256, (4, 4, 4)), 6, 8, rng))
    _write(tmp_path, "tex.mtl",
           "newmtl floor\nKd 1 1 1\nmap_Kd albedo.png\nmap_Pm metal.png\nmap_Pr rough.png\n"
           "norm normal.png\nNs 30\n"
           "newmtl lamp\nKd 0 0 0\nKe 0.2 0.2 0.2\n")
    lines = ["mtllib tex.mtl"]
    lines += [f"v {x} 0 {z}" for x, z in ((-2, -2), (2, -2), (2, 2), (-2, 2))]
    lines += [f"v {x} 3 {z}" for x, z in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
    lines += ["vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1", "vn 0 1 0"]
    lines += ["usemtl floor", "f 1/1/1 2/2/1 3/3/1 4/4/1", "usemtl lamp", "f 7 6 5", "f -1 7 5"]
    return _write(tmp_path, "tex.obj", "\n".join(lines) + "\n")


def test_obj_with_textures_matches_jax(tmp_path):
    path = write_textured_obj(tmp_path)
    got, want = TO.load_obj(path), JO.load_obj(path)
    same_gltf(got, want)
    floor = got.materials[got.triangles[0, 3]]
    assert floor.albedo_texture is not None and floor.normal_texture is not None
    ts = same_world(path)
    assert ts.has_textures and ts.has_lights


@pytest.mark.parametrize("variant", ["quad", "pbr", "negative", "two_libs"])
def test_obj_matches_jax(tmp_path, variant):
    _write(tmp_path, "quad.mtl", MTL_RED)
    if variant == "quad":
        text = OBJ_QUAD
    elif variant == "pbr":
        text = OBJ_QUAD.replace("usemtl red", "usemtl pbr")
    elif variant == "negative":  # negative indices, faces before any usemtl
        text = "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf -4 -3 -2\nusemtl red\nf 1 2 4\n"
        text = "mtllib quad.mtl\n" + text
    else:
        _write(tmp_path, "b.mtl", "newmtl blue\nKd 0 0 1\nKe 1 1 1\n")
        text = ("mtllib quad.mtl b.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
                "usemtl red\nf 1 2 3\nusemtl blue\nf 1 2 4\n")
    path = _write(tmp_path, f"{variant}.obj", text)
    same_gltf(TO.load_obj(path), JO.load_obj(path))
    same_world(path)


# ---- STL, PLY ------------------------------------------------------------------------

TRIS = np.array([[[0, 0, 0], [1, 0, 0], [0, 2, 0]], [[0, 0, 0], [0, 2, 0], [-1, 0, 0]],
                 [[0, 0, 0], [0, 2, 0], [0, 0, 1.5]]], np.float32)


def test_stl_matches_jax(tmp_path):
    binary = _write(tmp_path, "t.stl", _stl_binary(TRIS))
    lines = ["solid t"]
    for t in TRIS:
        lines += ["facet normal 0 0 0", "outer loop"]
        lines += [f"vertex {v[0]} {v[1]} {v[2]}" for v in t]
        lines += ["endloop", "endfacet"]
    ascii_ = _write(tmp_path, "a.stl", "\n".join(lines + ["endsolid t"]) + "\n")
    for path in (binary, ascii_):
        same_gltf(TM.load_stl(path), JM.load_stl(path))
        same_world(path)


def _ply(fmt, uv):
    """A quad and a triangle, with s/t coordinates if `uv`."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 2, 0], [0, 2, 0], [2, 0, 1]], np.float32)
    coords = np.array([[0, 0], [1, 0], [1, 1], [0, 1], [0.5, 0.5]], np.float32)
    faces = [[0, 1, 2, 3], [1, 4, 2]]
    props = "property float x\nproperty float y\nproperty float z\n"
    if uv:
        props += "property float s\nproperty float t\n"
    header = (f"ply\nformat {fmt} 1.0\nelement vertex {len(verts)}\n{props}"
              f"element face {len(faces)}\nproperty list uchar int vertex_indices\nend_header\n")
    rows = np.hstack([verts, coords]) if uv else verts
    if fmt == "ascii":
        body = "".join(" ".join(str(float(x)) for x in r) + "\n" for r in rows)
        body += "".join(f"{len(f)} " + " ".join(map(str, f)) + "\n" for f in faces)
        return header + body
    e = "<" if fmt == "binary_little_endian" else ">"
    body = b"".join(struct.pack(f"{e}{len(r)}f", *r) for r in rows)
    body += b"".join(struct.pack(f"{e}B{len(f)}i", len(f), *f) for f in faces)
    return header.encode() + body


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian", "binary_big_endian"])
def test_ply_matches_jax(tmp_path, fmt):
    for uv in (False, True):
        path = _write(tmp_path, f"q{int(uv)}.ply", _ply(fmt, uv))
        got = TM.load_ply(path)
        same_gltf(got, JM.load_ply(path))
        assert got.triangles.shape == (3, 4)
        same_world(path)


# ---- FBX ---------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["binary", "binary_moved", "ascii"])
def test_fbx_matches_jax(tmp_path, kind):
    path = str(tmp_path / "s.fbx")
    if kind == "ascii":
        _write(tmp_path, "s.fbx", ASCII_FBX)
    else:
        _cube_fbx(path, *((30.0, (1.0, 2.0, -0.5)) if kind == "binary_moved" else ()))
    got = TF.load_fbx(path)
    same_gltf(got, JF.load_fbx(path))
    assert len(got.triangles) >= 1
    same_world(path)
    with pytest.raises(ValueError):
        TF.load_fbx(_write(tmp_path, "bad.fbx", b"not an fbx at all" * 4))


# ---- write_glb -------------------------------------------------------------------------------


def glb_specs(mod, textured):
    pos, idx, nrm = mod.icosphere(2, 0.7, (0.0, 1.0, 0.0))
    q_pos, q_idx, q_nrm = mod.quad((-3, 0, -3), (6, 0, 0), (0, 0, 6))
    lamp, l_idx, _ = mod.quad((-1, 3, -1), (0, 0, 2), (2, 0, 0))
    uv = np.stack([q_pos[:, 0], q_pos[:, 2]], axis=1) / 6.0 + 0.5
    meshes = [
        mod.MeshSpec(positions=pos, indices=idx, material=1, normals=nrm, name="ball"),
        mod.MeshSpec(positions=q_pos, indices=q_idx, material=0, normals=q_nrm, uv0=uv),
        mod.MeshSpec(positions=lamp, indices=l_idx, material=2),
    ]
    floor = dict(base_color=(0.7, 0.6, 0.5, 1.0), roughness=0.6)
    if textured:
        floor |= dict(base_color_texture=0, metallic_roughness_texture=1, normal_texture=2)
    materials = [
        mod.MaterialSpec(**floor),
        mod.MaterialSpec(base_color=(1, 1, 1, 1), roughness=0.05, transmission=1.0, ior=1.45),
        mod.MaterialSpec(base_color=(0, 0, 0, 1), emissive=(0.3, 0.25, 0.2)),
    ]
    rng = np.random.default_rng(4)
    textures = [rng.integers(0, 256, (8, 8, 3)).astype(np.uint8),
                rng.uniform(0, 1, (4, 4, 4)).astype(np.float32),
                rng.integers(0, 256, (4, 8, 4)).astype(np.uint8)] if textured else None
    return meshes, materials, textures


@pytest.mark.parametrize("textured", [False, True])
def test_write_glb_round_trips(tmp_path, textured):
    path = str(tmp_path / "w.glb")
    TGW.write_glb(path, *glb_specs(TGW, textured))
    got = TG.load_glb(path)
    same_gltf(got, JG.load_glb(path))
    assert got.materials[1].transmission == 1.0 and got.materials[1].ior == pytest.approx(1.45)
    assert (got.materials[0].albedo_texture is not None) == textured
    jpath = str(tmp_path / "j.glb")
    JGW.write_glb(jpath, *glb_specs(JGW, textured))
    if not textured:  # no PNG inside: the two writers write the same bytes
        with open(path, "rb") as a, open(jpath, "rb") as b:
            assert a.read() == b.read()
    same_gltf(got, TG.load_glb(jpath))  # the PNGs of two encoders decode the same
    ts = same_world(path)
    assert ts.has_glass and ts.has_lights


def test_procedural_helpers_match_jax():
    for a, b in zip(TGW.icosphere(2, 1.5, (1, 2, 3)), JGW.icosphere(2, 1.5, (1, 2, 3))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TGW.quad((0, 0, 0), (1, 0, 0), (0, 0, 2)),
                    JGW.quad((0, 0, 0), (1, 0, 0), (0, 0, 2))):
        np.testing.assert_array_equal(a, b)
    assert TG._shininess_to_roughness(30.0) == JG._shininess_to_roughness(30.0)
    assert TG._shininess_to_roughness(-5.0) == JG._shininess_to_roughness(-5.0)
