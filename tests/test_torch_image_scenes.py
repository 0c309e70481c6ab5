"""Scenes and skies in the image formats the port now decodes, through the
port and through the JAX package (which decodes them with Pillow).

- BreakTime with JPEG textures, BreakTime-mixed with a planar YCbCr TIFF,
  an LZMA 4:2:0 YCbCr TIFF with the predictor, a Lab PSD, an
  orientation-6 TIFF, a fill-order-2 Group 4 TIFF and a fill-order-2 LZMA
  RGB TIFF texture, and BreakTime-J2K with JPEG 2000 textures (5/3 and 9/7, JP2 and raw)
  (tests/data_torch/formats, written by tests/test_torch_image_formats.py
  `make_fixtures`): the port's World equals the JAX World bit for bit in
  its atlas, shading rows and every other scene tensor, at a 64-texel
  atlas (`same_world` of tests/test_torch_formats.py), and equals the
  World of its lossless twin (each texture a PNG of Pillow's decode).
- BreakTime-DDS with DXT1, BC5, DXT5 and BC7 DDS textures and two PSD
  textures (tests/data_torch/formats_dds_psd, written by `make_dds_psd_fixtures`),
  the same way; BreakTime-classic with a P6 PPM, a QOI, an RLE SGI, a
  24-bit PCX, an ICO and a DCX texture (tests/data_torch/formats_classic,
  `make_classic_fixtures`), the same way; BreakTime-legacy with an IPTC
  record holding a PNG, an IM, a BLP2 DXT5, an XPM of 8-byte keys, a
  16-bit McIdas area and an XV thumbnail (tests/data_torch/formats_legacy,
  `make_legacy_fixtures`), the same way; BreakTime-JPEG-ext with CMYK,
  YCCK, arithmetic-coded (progressive with restarts, and sequential),
  lossless and repaired (junk before a marker, a dropped RST) JPEG
  textures (tests/data_torch/formats_jpeg, `make_jpeg_fixtures` of
  tests/test_torch_image_formats_jpeg.py), the same way; BreakTime-AVIF
  with six AVIF textures, three lossy (one with no in-loop filter, one of
  2x2 tiles deblocked and CDEF'd, one deblocked, CDEF'd and
  Wiener-restored) and three lossless (4:4:4 and 4:2:0, two with palette
  and intra block copy; tests/data_torch/formats_avif,
  `make_avif_fixtures`), the same way.
- An OBJ whose MTL names JPEG, TGA and BMP maps, one whose MTL names
  TIFF, WebP and GIF maps, one with .jp2 and .j2k maps, one with .dds
  and .psd maps, and two with .ppm, .qoi, .ico, .pcx, .sgi, .pgm, .rgb,
  .dib and .cur maps, two with .blp, .im, .icns, .ras, .xpm and
  .fits maps, and three with the variants the port once refused (RLE8,
  16-bit and OS/2 bitmaps, 16-bit TGA, JPEG, fax, YCbCr, CMYK and CIELab
  TIFF, an animated WebP), and three with the kinds read next (TIFF fill
  order 2, orientations, planar and predicted YCbCr, LZMA; McIdas, XV
  thumbnail, Lab PSD, IPTC holding a PNG, long-key XPM), one with
  lossless .avif maps and one with lossy .avif maps (no in-loop filter),
  against rustic_tpu/scene/obj.py, exactly.
- JPEG, BMP, TGA, WebP, TIFF, GIF, JPEG 2000 (.jp2, .j2k), DDS, PNM,
  PFM, QOI, ICO, PCX, DCX, SGI, DIB, IM, SPIDER, lossless and lossy AVIF skies through
  `load_skybox_image`,
  against the JAX function, exactly. The JAX package reads .exr through
  imageio, which has no backend here: the EXR sky is held to the .npy of
  its half-float values, which the JAX function reads.
- 32x16x2 films of the JPEG, the mixed, the J2K, the DDS, the classic,
  the legacy, the JPEG-ext and the AVIF BreakTime's one-tile cuts
  (rustic_tpu_torch/scene/cuts.py; a 256-texel atlas) under the EXR sky on the port and
  the .npy sky on JAX, both staged pipelines: the film rule of
  tests/test_torch_breaktime.py (rtol 1e-4 / atol 1e-5 on at least 98% of
  the pixels, every pixel within rtol 2e-2 / atol 1e-4).
- The viewer's `load_path` on a .jpg, .exr, .tga and .bmp sky.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

import jax.numpy as jnp

from rustic_tpu.runtime import pipeline as JP
from rustic_tpu.scene import gltf as JG
from rustic_tpu.scene import obj as JO
from rustic_tpu.scene import world as JW
from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic_tpu_torch.runtime.render import pixel_offsets, render_pixels
from rustic_tpu_torch.runtime.viewer import Viewer
from rustic_tpu_torch.scene import cuts
from rustic_tpu_torch.scene import gltf as TG
from rustic_tpu_torch.scene import obj as TO
from rustic_tpu_torch.scene import world as TW
from tests.conftest import scene_path
from tests.test_torch_breaktime import assert_film_close
from tests.test_torch_bvh_native import require_jax_native
from tests.test_torch_formats import ATLAS as SAME_WORLD_ATLAS
from tests.test_torch_formats import same_gltf, same_world
from tests.test_torch_image_formats_avif import AVIF_FIXTURES, BT_AVIF, BT_AVIF_TWIN
from tests.test_torch_image_formats_jpeg import BT_EXT, BT_EXT_TWIN, JPEG_FIXTURES
from tests.test_torch_image_formats import (BT_CLASSIC, BT_CLASSIC_TWIN, BT_DDS, BT_DDS_TWIN,
                                            BT_J2K, BT_J2K_TWIN, BT_JPEG, BT_LEGACY,
                                            BT_LEGACY_TWIN, BT_MIXED, BT_MIXED_TWIN, BT_SKY_EXR,
                                            BT_TWIN, CLASSIC_FIXTURES, DDS_PSD_FIXTURES,
                                            FIXTURES, LEGACY_FIXTURES, bc7_mode6, blp1_jpeg,
                                            blp_file, breaktime_sky_half, dcx_file, dds_file,
                                            dib_of, dxt_blocks_of, fits_file, icns_file,
                                            icns_rgb32, icon_dib, icon_file, j2k, pfm,
                                            pillow_modes, pnm, psd_of, save, sgi_file,
                                            spider_file, sun_file, sun_rows, write_exr,
                                            xpm_file)

torch.set_num_threads(2)

ATLAS = 256
FILM_W, FILM_H, SPP = 32, 16, 2
CAM = dict(cam_position=(0.0, 1.8, -3.2), has_skybox=True)


def fixture_path(name):
    return os.path.join(FIXTURES, name)


@pytest.fixture(scope="module")
def half_sky(tmp_path_factory):
    """The EXR sky's values as a .npy (the JAX function's way in)."""
    path = tmp_path_factory.mktemp("sky") / "sky.npy"
    np.save(path, breaktime_sky_half().astype(np.float32))
    return str(path)


def assert_world_and_twin(path, twin_path):
    ts = same_world(path)
    assert ts.has_textures
    twin = TW.World.from_path(twin_path, SAME_WORLD_ATLAS).to_torch("cpu")
    for name in ("atlas", "tri_attrs"):
        np.testing.assert_array_equal(getattr(twin, name).numpy(), getattr(ts, name).numpy())


def test_breaktime_jpeg_world_matches_jax():
    assert_world_and_twin(fixture_path(BT_JPEG), fixture_path(BT_TWIN))


def test_breaktime_mixed_world_matches_jax():
    assert_world_and_twin(fixture_path(BT_MIXED), fixture_path(BT_MIXED_TWIN))


def test_breaktime_j2k_world_matches_jax():
    assert_world_and_twin(fixture_path(BT_J2K), fixture_path(BT_J2K_TWIN))


def test_breaktime_dds_world_matches_jax():
    dds_path = os.path.join(DDS_PSD_FIXTURES, BT_DDS)
    assert_world_and_twin(dds_path, os.path.join(DDS_PSD_FIXTURES, BT_DDS_TWIN))


def test_breaktime_classic_world_matches_jax():
    assert_world_and_twin(os.path.join(CLASSIC_FIXTURES, BT_CLASSIC),
                          os.path.join(CLASSIC_FIXTURES, BT_CLASSIC_TWIN))


def test_breaktime_legacy_world_matches_jax():
    assert_world_and_twin(os.path.join(LEGACY_FIXTURES, BT_LEGACY),
                          os.path.join(LEGACY_FIXTURES, BT_LEGACY_TWIN))


def test_breaktime_jpeg_ext_world_matches_jax():
    """BreakTime-JPEG-ext (CMYK, YCCK, arithmetic-coded, lossless and
    repaired JPEG textures) as the JAX package builds it, and as its twin."""
    assert_world_and_twin(os.path.join(JPEG_FIXTURES, BT_EXT),
                          os.path.join(JPEG_FIXTURES, BT_EXT_TWIN))


def test_breaktime_avif_world_matches_jax():
    """BreakTime-AVIF (six AVIF textures: three lossy, one with no in-loop
    filter, one of 2x2 tiles deblocked and CDEF'd across the tile edges,
    one deblocked, CDEF'd and Wiener-restored; three lossless, 4:4:4 and
    4:2:0, two with palette and intra block copy) as the JAX package
    builds it, and as its twin."""
    assert_world_and_twin(os.path.join(AVIF_FIXTURES, BT_AVIF),
                          os.path.join(AVIF_FIXTURES, BT_AVIF_TWIN))


def write_obj_with_maps(tmp_path, maps=None):
    """A quad and a lamp; the floor's albedo map a JPEG, its roughness
    map a TGA and its normal map a BMP, or the files `maps` gives
    ({"albedo": (name, bytes), "rough": ..., "normal": ..., and, where
    given, "metal": its metallic map})."""
    modes = pillow_modes(9, 14, seed=3)
    maps = maps or {"albedo": ("albedo.jpg", save(modes["RGB"], "JPEG", quality=85)),
                    "rough": ("rough.tga", save(modes["L"], "TGA", compression="tga_rle")),
                    "normal": ("normal.bmp", save(modes["RGB"], "BMP"))}
    for name, data in maps.values():
        (tmp_path / name).write_bytes(data)
    (tmp_path / "tex.mtl").write_text(
        f"newmtl floor\nKd 1 1 1\nmap_Kd {maps['albedo'][0]}\nmap_Pr {maps['rough'][0]}\n"
        f"norm {maps['normal'][0]}\n"
        + (f"map_Pm {maps['metal'][0]}\n" if "metal" in maps else "")
        + "Ns 30\nnewmtl lamp\nKd 0 0 0\nKe 0.2 0.2 0.2\n")
    lines = ["mtllib tex.mtl"]
    lines += [f"v {x} 0 {z}" for x, z in ((-2, -2), (2, -2), (2, 2), (-2, 2))]
    lines += [f"v {x} 3 {z}" for x, z in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
    lines += ["vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1", "vn 0 1 0"]
    lines += ["usemtl floor", "f 1/1/1 2/2/1 3/3/1 4/4/1", "usemtl lamp", "f 7 6 5", "f -1 7 5"]
    (tmp_path / "tex.obj").write_text("\n".join(lines) + "\n")
    return str(tmp_path / "tex.obj")


def test_obj_with_jpeg_tga_bmp_maps_matches_jax(tmp_path):
    path = write_obj_with_maps(tmp_path)
    got, want = TO.load_obj(path), JO.load_obj(path)
    same_gltf(got, want)
    floor = got.materials[got.triangles[0, 3]]
    assert floor.albedo_texture is not None and floor.roughness_texture is not None
    assert floor.normal_texture is not None
    ts = same_world(path)
    assert ts.has_textures


def test_obj_with_tiff_webp_gif_maps_matches_jax(tmp_path):
    """The albedo map an LZW TIFF, the roughness map a lossy WebP with
    alpha, the normal map a GIF."""
    modes = pillow_modes(9, 14, seed=8)
    path = write_obj_with_maps(tmp_path, {
        "albedo": ("albedo.tif", save(modes["RGB"], "TIFF", compression="tiff_lzw")),
        "rough": ("rough.webp", save(modes["RGBA"], "WEBP", quality=70)),
        "normal": ("normal.gif", save(modes["RGB"], "GIF"))})
    got, want = TO.load_obj(path), JO.load_obj(path)
    same_gltf(got, want)
    floor = got.materials[got.triangles[0, 3]]
    assert floor.albedo_texture is not None and floor.normal_texture is not None
    assert same_world(path).has_textures


def test_obj_with_jpeg2000_maps_matches_jax(tmp_path):
    """The albedo map a 9/7 JP2, the roughness map a 5/3 raw codestream
    with alpha (LA), the normal map a tiled 5/3 JP2."""
    modes = pillow_modes(9, 14, seed=9)
    path = write_obj_with_maps(tmp_path, {
        "albedo": ("albedo.jp2", j2k(modes["RGB"], irreversible=True, mct=1)),
        "rough": ("rough.j2k", j2k(modes["LA"], no_jp2=True)),
        "normal": ("normal.jp2", j2k(modes["RGB"], tile_size=(8, 8), tile_offset=(1, 1),
                                     offset=(3, 2)))})
    got, want = TO.load_obj(path), JO.load_obj(path)
    same_gltf(got, want)
    floor = got.materials[got.triangles[0, 3]]
    assert floor.albedo_texture is not None and floor.normal_texture is not None
    assert same_world(path).has_textures


def test_obj_with_dds_and_psd_maps_matches_jax(tmp_path):
    """The albedo map a BC7 DDS, the roughness map a raw greyscale PSD
    (which Pillow reads by name, through a memory map), the normal map a
    PackBits RGB PSD."""
    modes = pillow_modes(12, 16, seed=10)
    path = write_obj_with_maps(tmp_path, {
        "albedo": ("albedo.dds", dds_file(16, 12, bc7_mode6(np.asarray(modes["RGBA"])),
                                          dxgi=98)),
        "rough": ("rough.psd", psd_of(modes["L"], 0)),
        "normal": ("normal.psd", psd_of(modes["RGB"], 1))})
    got, want = TO.load_obj(path), JO.load_obj(path)
    same_gltf(got, want)
    floor = got.materials[got.triangles[0, 3]]
    assert floor.albedo_texture is not None and floor.normal_texture is not None
    assert same_world(path).has_textures


def classic_maps(seed):
    """Two sets of OBJ maps in the classic formats, of `pillow_modes(9, 14)`."""
    modes = pillow_modes(9, 14, seed=seed)
    rgb, grey = np.asarray(modes["RGB"]), np.asarray(modes["L"])
    pal = np.random.default_rng(seed).integers(0, 256, (16, 3), np.uint8)
    return [
        {"albedo": ("albedo.ppm", save(modes["RGB"], "PPM")),
         "rough": ("rough.qoi", save(modes["RGBA"], "QOI")),
         "normal": ("normal.ico", icon_file([(icon_dib(np.asarray(modes["RGBA"]), 32), 14, 9, 32,
                                               0)])),
         "metal": ("metal.pcx", save(modes["P"], "PCX"))},
        {"albedo": ("albedo.sgi", sgi_file(rgb.transpose(2, 0, 1) // 16 * 16, 1, True)),
         "rough": ("rough.pgm", pnm(grey.astype(np.int64) * 4, b"P2", 1020,
                                    comment=b"# grey\n")),
         "normal": ("normal.rgb", save(modes["RGB"], "SGI", bpc=2)),
         "metal": ("metal.cur", icon_file([(icon_dib(grey % 16, 4, pal), 14, 9, 0, 0)],
                                          cursor=True))},
    ]


@pytest.mark.parametrize("which", [0, 1])
def test_obj_with_classic_maps_matches_jax(tmp_path, which):
    """An OBJ whose MTL names .ppm, .qoi, .ico and .pcx maps, and one with
    .sgi (RLE and 16-bit), plain .pgm and .cur maps: the textures through
    both loaders (the JAX one opens each by its path)."""
    path = write_obj_with_maps(tmp_path, classic_maps(12)[which])
    got, want = TO.load_obj(path), JO.load_obj(path)
    same_gltf(got, want)
    floor = got.materials[got.triangles[0, 3]]
    assert floor.albedo_texture is not None and floor.normal_texture is not None
    assert floor.metallic_texture is not None
    assert same_world(path).has_textures


def legacy_maps(seed):
    """Two sets of OBJ maps in the legacy formats, of `pillow_modes(9, 14)`
    (the ICNS one 16x16, its only size)."""
    modes = pillow_modes(9, 14, seed=seed)
    rgb, grey = np.asarray(modes["RGB"]), np.asarray(modes["L"])
    rng = np.random.default_rng(seed)
    cols = ["#%06x" % v for v in rng.integers(0, 2**24, 30)]
    rgb16 = np.asarray(modes["RGB"].resize((16, 16)))
    return [
        {"albedo": ("albedo.blp", blp1_jpeg(modes["RGB"])),
         "rough": ("rough.im", save(modes["L"], "IM")),
         "normal": ("normal.icns", icns_file([(b"is32", icns_rgb32(rgb16)),
                                              (b"s8mk", bytes(range(0, 256)))])),
         "metal": ("metal.ras", sun_file(sun_rows(rgb[..., ::-1], 24, False), 14, 24, rle=True))},
        {"albedo": ("albedo.xpm", xpm_file(grey.astype(np.int64) % 30, cols)),
         "rough": ("rough.fits", fits_file(8, 14, 9, grey.tobytes() + bytes(200))),
         "normal": ("normal.blp", blp_file(2, 14, 9, dxt_blocks_of(modes["RGBA"], "DXT5"), 1, 2,
                                           8, 7, palette=bytes(1024))),
         "metal": ("metal.im", save(modes["P"], "IM"))},
    ]


@pytest.mark.parametrize("which", [0, 1])
def test_obj_with_legacy_maps_matches_jax(tmp_path, which):
    """An OBJ whose MTL names .blp (BLP1 JPEG), .im, .icns (is32 RLE with a
    mask) and .ras (RLE) maps, and one with .xpm, .fits, .blp (BLP2 DXT5)
    and palette .im maps: the textures through both loaders."""
    path = write_obj_with_maps(tmp_path, legacy_maps(21)[which])
    got, want = TO.load_obj(path), JO.load_obj(path)
    same_gltf(got, want)
    floor = got.materials[got.triangles[0, 3]]
    assert floor.albedo_texture is not None and floor.normal_texture is not None
    assert floor.metallic_texture is not None
    assert same_world(path).has_textures


def variant_maps(seed):
    """Three sets of OBJ maps in the variants Pillow reads that the port
    once refused (tests/test_torch_image_formats_variants.py), of
    `pillow_modes(9, 14)`."""
    from tests import test_torch_image_formats_variants as V

    modes = pillow_modes(9, 14, seed=seed)
    rgb = np.asarray(modes["RGB"])
    rgb16 = (rgb[..., 0].astype(np.uint16) >> 3 << 10 | rgb[..., 1].astype(np.uint16) >> 3 << 5
             | rgb[..., 2].astype(np.uint16) >> 3)
    quant = modes["RGB"].quantize(64)
    pal = np.array(quant.getpalette()[:192], np.uint8).reshape(-1, 3)
    lab = PILImage.frombytes("LAB", (14, 9), rgb.tobytes())  # the same bytes as L, a and b
    return [
        {"albedo": ("albedo.bmp", V.rle_bmp(np.asarray(quant), pal)),
         "rough": ("rough.tga", V.tga16(rgb16 | 0x8000)),
         "normal": ("normal.bmp", V.bmp16(rgb16, (0x7C00, 0x3E0, 0x1F))),
         "metal": ("metal.dib", V.os2_bmp(np.asarray(quant), 8, np.resize(pal, (256, 3)),
                                          bmp=False))},
        {"albedo": ("albedo.tif", V.jpeg_tiff(rgb, rows_per_strip=8)),
         "rough": ("rough.tif", save(modes["1"], "TIFF", compression="group4")),
         "normal": ("normal.tif", V.ycbcr_tiff(rgb, (2, 1), "LZW")),
         "metal": ("metal.tiff", save(modes["1"], "TIFF", compression="group3",
                                      tiffinfo={292: 1}))},
        {"albedo": ("albedo.tif", save(lab, "TIFF", compression="tiff_lzw")),
         "rough": ("rough.tif", save(modes["RGB"].convert("CMYK"), "TIFF")),
         "normal": ("normal.webp", V.anim_webp((16, 12), [(2, 2, save(modes["RGB"], "WEBP"), 0)],
                                               False)),
         "metal": ("metal.tif", save(modes["1"], "TIFF", compression="tiff_ccitt"))},
    ]


def later_maps(seed):
    """Three sets of OBJ maps in the kinds the port read next (TIFF fill
    order 2, orientations, planar and predicted YCbCr, LZMA; McIdas, XV
    thumbnails, Lab PSDs, IPTC records holding PNGs, XPMs of long keys),
    of `pillow_modes(9, 14)`."""
    from tests import test_torch_image_formats as F
    from tests import test_torch_image_formats_variants as V

    modes = pillow_modes(9, 14, seed=seed)
    rgb, grey = np.asarray(modes["RGB"]), np.asarray(modes["L"])
    ycc = np.asarray(modes["RGB"].convert("YCbCr"))
    lab = np.stack([grey, rgb[..., 0] // 2 + 64, rgb[..., 1] // 2 + 64]).astype(np.uint8)
    return [
        {"albedo": ("albedo.tif", F.write_tiff(rgb, 2, compression="LZW", predictor=2,
                                               fill_order=2)),
         "rough": ("rough.tif", F.write_tiff(grey, 1, compression="Deflate",
                                             tags={274: (3, [5])})),
         "normal": ("normal.tif", F.write_tiff(ycc, 6, compression="LZW", planar=2,
                                               tags={530: (3, [1, 1])})),
         "metal": ("metal.tif", V.ycbcr_tiff(rgb, (2, 2), "LZMA", predictor=2))},
        {"albedo": ("albedo.xpm", F.long_key_xpm(modes["RGB"], 40, 9)),
         "rough": ("rough.area", F.mcidas_file(grey, 1, prefix=3)),
         "normal": ("normal.xv", F.xvthumb_file(F.rgb332(modes["RGB"]))),
         "metal": ("metal.iim", F.iptc_file(save(modes["RGB"], "PNG"), (14, 9),
                                            compression=5))},
        {"albedo": ("albedo.psd", F.write_psd(lab, 9, 8, 1)),
         "rough": ("rough.tif", F.write_tiff(grey, 1, compression="LZMA")),
         "normal": ("normal.tif", save(modes["RGB"], "TIFF", compression="jpeg",
                                       tiffinfo={274: 8})),
         "metal": ("metal.tif", save(modes["1"], "TIFF", compression="group4",
                                     tiffinfo={266: 2}))},
    ]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_obj_with_later_maps_matches_jax(tmp_path, which):
    """An OBJ whose MTL names a fill-order-2 LZW TIFF, an orientation-5
    TIFF, a planar YCbCr TIFF and a predicted LZMA YCbCr TIFF; one with a
    long-key XPM, a McIdas area, an XV thumbnail and an IPTC record holding
    a PNG; one with a Lab PSD, an LZMA TIFF, an orientation-8 JPEG TIFF and
    a fill-order-2 Group 4 TIFF: the textures through both loaders."""
    path = write_obj_with_maps(tmp_path, later_maps(41)[which])
    got, want = TO.load_obj(path), JO.load_obj(path)
    same_gltf(got, want)
    floor = got.materials[got.triangles[0, 3]]
    assert floor.albedo_texture is not None and floor.normal_texture is not None
    assert floor.metallic_texture is not None
    assert same_world(path).has_textures


@pytest.mark.parametrize("which", [0, 1, 2])
def test_obj_with_variant_maps_matches_jax(tmp_path, which):
    """An OBJ whose MTL names an RLE8 BMP, a 16-bit TGA, a 16-bit bit-field
    BMP and an OS/2 DIB; one with JPEG-compressed, Group 4, YCbCr (LZW,
    2x1) and 2-D Group 3 TIFF maps; one with CIELab, CMYK and CCITT RLE TIFF
    and an animated WebP map: the textures through both loaders."""
    path = write_obj_with_maps(tmp_path, variant_maps(31)[which])
    got, want = TO.load_obj(path), JO.load_obj(path)
    same_gltf(got, want)
    floor = got.materials[got.triangles[0, 3]]
    assert floor.albedo_texture is not None and floor.normal_texture is not None
    assert floor.metallic_texture is not None
    assert same_world(path).has_textures


def test_obj_with_avif_maps_matches_jax(tmp_path):
    """The albedo map a lossless 4:4:4 AVIF, the roughness map a lossless
    4:2:0 AVIF with alpha, the normal map a lossless 4:2:2 AVIF (9x14)."""
    modes = pillow_modes(9, 14, seed=31)
    path = write_obj_with_maps(tmp_path, {
        "albedo": ("albedo.avif", save(modes["RGB"], "AVIF", quality=100, subsampling="4:4:4")),
        "rough": ("rough.avif", save(modes["RGBA"], "AVIF", quality=100)),
        "normal": ("normal.avif", save(modes["RGB"], "AVIF", quality=100,
                                       subsampling="4:2:2"))})
    got, want = TO.load_obj(path), JO.load_obj(path)
    same_gltf(got, want)
    floor = got.materials[got.triangles[0, 3]]
    assert floor.albedo_texture is not None and floor.normal_texture is not None
    assert same_world(path).has_textures


def filter_free(raw: bytes) -> bool:
    """No payload of the AVIF has a loop filter level or a CDEF strength."""
    from rustic_tpu_torch.utils import avif
    from tests.test_torch_image_formats_avif import filters

    return not filters(dict(headers=avif.header_record(raw)))


def test_obj_with_lossy_avif_maps_matches_jax(tmp_path):
    """The albedo map a lossy 4:4:4 AVIF, the roughness map a lossy 4:2:0
    AVIF with alpha (9x14), the normal map a lossy 4:2:2 AVIF at an odd
    width and height (9x15), each at quality 90, where aom turns no
    in-loop filter on."""
    modes, odd = pillow_modes(9, 14, seed=37), pillow_modes(9, 15, seed=41)
    maps = {"albedo": ("albedo.avif", save(modes["RGB"], "AVIF", quality=90, subsampling="4:4:4")),
            "rough": ("rough.avif", save(modes["RGBA"], "AVIF", quality=90)),
            "normal": ("normal.avif", save(odd["RGB"], "AVIF", quality=90, subsampling="4:2:2"))}
    assert all(filter_free(data) for _, data in maps.values())
    path = write_obj_with_maps(tmp_path, maps)
    got, want = TO.load_obj(path), JO.load_obj(path)
    same_gltf(got, want)
    floor = got.materials[got.triangles[0, 3]]
    assert floor.albedo_texture is not None and floor.normal_texture is not None
    assert same_world(path).has_textures


@pytest.mark.parametrize("mode, sub", [("RGB", "4:4:4"), ("RGBA", "4:2:0"), ("L", "4:0:0"),
                                       ("RGB", "4:2:2")])
def test_lossy_avif_skies_match_jax(tmp_path, mode, sub):
    """A quality-90 AVIF sky (no in-loop filter) through
    load_skybox_image, against rustic_tpu/scene/world.py through Pillow."""
    raw = save(pillow_modes(8, 16, seed=43)[mode], "AVIF", quality=90, subsampling=sub)
    assert filter_free(raw)
    path = str(tmp_path / "sky.avif")
    with open(path, "wb") as f:
        f.write(raw)
    got = TW.load_skybox_image(path)
    assert got.dtype == np.float32 and got.shape == (8, 16, 4)
    np.testing.assert_array_equal(got, JW.load_skybox_image(path))


@pytest.mark.parametrize("mode, sub", [("RGB", "4:4:4"), ("RGBA", "4:2:0"), ("L", "4:0:0")])
def test_lossless_avif_skies_match_jax(tmp_path, mode, sub):
    path = str(tmp_path / "sky.avif")
    with open(path, "wb") as f:
        f.write(save(pillow_modes(8, 16, seed=6)[mode], "AVIF", quality=100, subsampling=sub))
    got = TW.load_skybox_image(path)
    assert got.dtype == np.float32 and got.shape == (8, 16, 4)
    np.testing.assert_array_equal(got, JW.load_skybox_image(path))


def legacy_skies():
    modes = pillow_modes(8, 16, seed=23)
    grey = np.asarray(modes["L"], np.float32)
    return {
        "sky.im": save(modes["RGB"], "IM"),
        "sky-ycc.im": save(modes["RGB"].convert("YCbCr"), "IM"),
        "sky.spi": spider_file(grey * 1.3 - 20),
        "sky-little.spider": spider_file(grey * 0.7 + 3, big=False),
    }


@pytest.mark.parametrize("name", list(legacy_skies()))
def test_legacy_skies_match_jax(tmp_path, name):
    """IM and SPIDER skies (no test of their first bytes: found by their
    readers, as Pillow finds them) through `load_skybox_image`."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(legacy_skies()[name])
    got = TW.load_skybox_image(path)
    assert got.dtype == np.float32 and got.ndim == 3 and got.shape[2] == 4
    np.testing.assert_array_equal(got, JW.load_skybox_image(path))


def classic_skies():
    modes = pillow_modes(8, 16, seed=13)
    rgb = np.asarray(modes["RGB"])
    return {
        "sky.ppm": save(modes["RGB"], "PPM"),
        "sky.pnm": pnm(rgb.astype(np.int64) * 3, b"P3", 765),
        "sky.pfm": pfm(np.asarray(modes["L"], np.float32) * 1.5 - 10),
        "sky.qoi": save(modes["RGBA"], "QOI"),
        "sky.ico": save(modes["RGBA"].resize((16, 16)), "ICO", sizes=[(16, 16)],
                        bitmap_format="bmp"),
        "sky.pcx": save(modes["RGB"], "PCX"),
        "sky.dcx": dcx_file([save(modes["P"], "PCX")]),
        "sky.sgi": sgi_file(rgb.transpose(2, 0, 1), 1, True),
        "sky.dib": dib_of(rgb, 24),
    }


@pytest.mark.parametrize("name", list(classic_skies()))
def test_classic_skies_match_jax(tmp_path, name):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(classic_skies()[name])
    got = TW.load_skybox_image(path)
    assert got.dtype == np.float32 and got.ndim == 3 and got.shape[2] == 4
    np.testing.assert_array_equal(got, JW.load_skybox_image(path))


@pytest.mark.parametrize("ext, kw", [("jpg", dict(quality=80)), ("jpeg", dict(progressive=True)),
                                     ("bmp", {}), ("tga", dict(compression="tga_rle")),
                                     ("webp", dict(quality=80)), ("tiff", dict(
                                         compression="tiff_adobe_deflate", tiffinfo={317: 2})),
                                     ("gif", {}), ("jp2", dict(irreversible=True, mct=1)),
                                     ("j2k", dict(no_jp2=True)),
                                     ("dds", dict(pixel_format="DXT1"))])
def test_ldr_skies_match_jax(tmp_path, ext, kw):
    path = str(tmp_path / f"sky.{ext}")
    fmt = {"jpg": "JPEG", "jpeg": "JPEG", "jp2": "JPEG2000", "j2k": "JPEG2000"}.get(ext,
                                                                                 ext.upper())
    with open(path, "wb") as f:
        f.write(save(pillow_modes(8, 16, seed=4)["RGB"], fmt, **kw))
    got = TW.load_skybox_image(path)
    assert got.dtype == np.float32 and got.shape == (8, 16, 4)
    np.testing.assert_array_equal(got, JW.load_skybox_image(path))


def test_exr_skies_reshape_as_jax(tmp_path, half_sky):
    """The BreakTime EXR (RGB, half) gets an alpha of 1 as the JAX
    function gives its .npy; a grey Y sky is repeated to RGB; an RGBA sky
    keeps its A."""
    np.testing.assert_array_equal(TW.load_skybox_image(fixture_path(BT_SKY_EXR)),
                                  JW.load_skybox_image(half_sky))
    rng = np.random.default_rng(5)
    y = rng.uniform(0, 30, (4, 8)).astype(np.float32)
    (tmp_path / "grey.exr").write_bytes(write_exr({"Y": y}, "ZIPS"))
    got = TW.load_skybox_image(str(tmp_path / "grey.exr"))
    np.testing.assert_array_equal(got, np.stack([y, y, y, np.ones_like(y)], -1))
    rgba = {c: rng.uniform(0, 2, (4, 8)).astype(np.float16) for c in "RGBA"}
    (tmp_path / "rgba.exr").write_bytes(write_exr(rgba, "RLE"))
    got = TW.load_skybox_image(str(tmp_path / "rgba.exr"))
    np.testing.assert_array_equal(got, np.stack([rgba[c].astype(np.float32) for c in "RGBA"], -1))


def test_jpeg_breaktime_film_matches_jax(half_sky):
    """The one-tile cut of the JPEG BreakTime: the port's decoders and EXR
    reader against Pillow and the .npy sky, through both staged pipelines."""
    assert_one_tile_film(fixture_path(BT_JPEG), half_sky)


def test_mixed_breaktime_film_matches_jax(half_sky):
    """The one-tile cut of BreakTime-mixed (LZMA, planar and predicted
    YCbCr, orientation-6 and fill-order-2 TIFF and Lab PSD textures), as
    the JPEG one."""
    assert_one_tile_film(fixture_path(BT_MIXED), half_sky)


def test_j2k_breaktime_film_matches_jax(half_sky):
    """The one-tile cut of BreakTime-J2K (JPEG 2000 textures), as the JPEG
    one."""
    assert_one_tile_film(fixture_path(BT_J2K), half_sky)


def test_dds_breaktime_film_matches_jax(half_sky):
    """The one-tile cut of BreakTime-DDS (DDS and PSD textures), as the
    JPEG one."""
    assert_one_tile_film(os.path.join(DDS_PSD_FIXTURES, BT_DDS), half_sky)


def test_classic_breaktime_film_matches_jax(half_sky):
    """The one-tile cut of BreakTime-classic (PPM, QOI, SGI, PCX, ICO and
    DCX textures), as the JPEG one."""
    assert_one_tile_film(os.path.join(CLASSIC_FIXTURES, BT_CLASSIC), half_sky)


def test_legacy_breaktime_film_matches_jax(half_sky):
    """The one-tile cut of BreakTime-legacy (IPTC holding a PNG, IM, BLP,
    long-key XPM, McIdas and XV thumbnail textures), as the JPEG one."""
    assert_one_tile_film(os.path.join(LEGACY_FIXTURES, BT_LEGACY), half_sky)


def test_jpeg_ext_breaktime_film_matches_jax(half_sky):
    """The one-tile cut of BreakTime-JPEG-ext, as the JPEG one."""
    assert_one_tile_film(os.path.join(JPEG_FIXTURES, BT_EXT), half_sky)


def test_avif_breaktime_film_matches_jax(half_sky):
    """The one-tile cut of BreakTime-AVIF (its AVIF textures through
    csrc/av1_intra.cpp and csrc/av1_filters.h), as the JPEG one."""
    assert_one_tile_film(os.path.join(AVIF_FIXTURES, BT_AVIF), half_sky)


def assert_one_tile_film(path, half_sky):
    from rustic_tpu.config import TracingConfig as JaxTracingConfig

    require_jax_native()
    jcut = cuts.one_tile(JG.load_glb(path), cuts.BREAKTIME_ONE_TILE)
    js = JW.World(jcut, ATLAS).to_device(JW.load_skybox_image(half_sky))
    tcut = cuts.one_tile(TG.load_glb(path), cuts.BREAKTIME_ONE_TILE)
    ts = TW.World(tcut, ATLAS).to_torch("cpu", TW.load_skybox_image(fixture_path(BT_SKY_EXR)))
    assert ts.n_tris == js.n_tris and ts.has_textures
    y, x = np.mgrid[0:FILM_H, 0:FILM_W]
    x, y = x.reshape(-1).astype(np.int32), y.reshape(-1).astype(np.int32)
    config = JaxTracingConfig(width=FILM_W, height=FILM_H, nee=NextEventEstimation.MIS, **CAM)
    want = np.asarray(JP.render_batch_staged(
        js, config.static_part(), config.dynamic_part(), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(pixel_offsets(FILM_W, FILM_H)), 0, SPP))
    got = render_pixels(ts, TracingConfig(width=FILM_W, height=FILM_H,
                                          nee=NextEventEstimation.MIS, **CAM), x, y, SPP,
                        offsets=pixel_offsets(FILM_W, FILM_H), engine=None).numpy()
    assert_film_close(got, want)


@pytest.mark.parametrize("name", ["sky.jpg", "sky.exr", "sky.tga", "sky.bmp"])
def test_viewer_loads_each_sky_format(tmp_path, name):
    world = TW.World.from_path(scene_path("DarkCornell.glb"))
    v = Viewer(world.to_torch("cpu"), TracingConfig(width=8, height=8, max_bounces=2),
               RenderSettings(sync_rate=1), world=world)
    path = tmp_path / name
    ext = name.rsplit(".", 1)[1]
    if ext == "exr":
        path.write_bytes(write_exr({c: np.full((4, 8), 0.5 + i, np.float16)
                                    for i, c in enumerate("RGB")}))
    else:
        path.write_bytes(save(pillow_modes(4, 8, seed=6)["RGB"],
                              "JPEG" if ext == "jpg" else ext.upper()))
    assert v.load_path(str(path))
    assert v.state.config.has_skybox and v.skybox.shape == (4, 8, 4)
    np.testing.assert_array_equal(v.scene.skybox.numpy(), TW.load_skybox_image(str(path)))
    assert np.isfinite(v.step()).all()
