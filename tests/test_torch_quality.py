"""The port's quality gates and image output against the JAX package.

- tonemap operators: rtol 1e-6 against rustic_tpu/ops/tonemap.py;
- `film_to_u8`: equal on >= 99.99% of entries, never more than 1 apart
  (XLA's CPU build contracts a*b + c into FMAs, so a value at a rounding
  boundary can land one code away);
- `encode_png`: decoded exactly by the port's `decode_png` and by Pillow;
- `write_hdr`: the JAX file byte for byte; `save_hdr` writes what the JAX
  package writes when imageio is missing;
- `rmse`, `mae`: the JAX values; `compare_engines`, `reference_compare`
  as tests/test_compare.py holds the JAX ones;
- the furnace pair of tests/test_furnace.py (0.8 +- 0.02 at pixel (65, 75)
  of 128^2; NEE off at 32 spp, MIS at 128) and its DLS-against-MIS test,
  through the port's renderers on the CPU;
- the five committed 256x144 reference films (tests/test_reference_films.py
  bounds) through the port on the CPU: minutes, so marked slow;
  chip_smoke.py holds them on the card.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rustic_tpu_torch.config import (
    NextEventEstimation,
    RenderSettings,
    Tonemapping,
    TracingConfig,
)
from rustic_tpu_torch.ops import tonemap as TM
from rustic_tpu_torch.runtime.render import render_image, render_pixels
from rustic_tpu_torch.scene.world import World, load_skybox_image, scene_from_arrays
from rustic_tpu_torch.utils import compare as C
from rustic_tpu_torch.utils import image_io as IO
from rustic_tpu_torch.utils.hdr import read_hdr, write_hdr
from rustic_tpu_torch.utils.png import decode_png, encode_png
from tests.conftest import scene_path
from tests.test_torch_render_multitile import scene_fields

torch.set_num_threads(2)


def hdr_film(seed=0, h=37, w=53):
    """A linear film with black, dim, bright and very bright pixels."""
    rng = np.random.default_rng(seed)
    film = np.exp(rng.normal(-1.0, 2.0, (h, w, 3))).astype(np.float32)
    film[0, :5] = 0.0
    film[1, :3] = [[1e-6, 2e-6, 3e-6], [1.0, 1.0, 1.0], [50.0, 0.2, 1e3]]
    return film


# ---- tonemapping and image output -------------------------------------------------


def test_tonemapping_enum_matches_jax():
    from rustic_tpu.config import RenderSettings as JaxRenderSettings
    from rustic_tpu.config import Tonemapping as JaxTonemapping

    assert [(t.name, int(t)) for t in Tonemapping] == [(t.name, int(t)) for t in JaxTonemapping]
    assert RenderSettings().tonemap == JaxRenderSettings().tonemap == Tonemapping.NONE


@pytest.mark.parametrize("op", list(Tonemapping))
def test_tonemap_matches_jax(op):
    from rustic_tpu.ops.tonemap import apply_tonemap as jax_tonemap

    film = hdr_film(int(op))
    for gamma in (False, True):
        want = np.asarray(jax_tonemap(jnp.asarray(film), int(op), gamma_encode=gamma))
        got = TM.apply_tonemap(torch.from_numpy(film), op, gamma_encode=gamma)
        assert got.dtype == torch.float32 and got.shape == film.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("op", [Tonemapping.NONE, Tonemapping.ACES_NARKOWICZ,
                                Tonemapping.UNCHARTED2])
def test_film_to_u8_matches_jax(op):
    from rustic_tpu.utils.image_io import film_to_u8 as jax_u8

    film = hdr_film(10 + int(op), 256, 256)
    want = jax_u8(film, op).astype(np.int32)
    got = IO.film_to_u8(film, op)
    assert got.dtype == np.uint8 and got.shape == film.shape
    diff = np.abs(got.astype(np.int32) - want)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.9999


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 13, 3), (64, 48, 4), (5, 300, 4)])
def test_encode_png_round_trips(shape, tmp_path):
    from PIL import Image

    rng = np.random.default_rng(shape[1])
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    raw = encode_png(img)
    rgba = decode_png(raw)
    np.testing.assert_array_equal(rgba[..., :shape[2]], img)
    if shape[2] == 3:
        assert (rgba[..., 3] == 255).all()
    path = tmp_path / "x.png"
    path.write_bytes(raw)
    with Image.open(path) as im:
        assert im.mode == ("RGB" if shape[2] == 3 else "RGBA")
        np.testing.assert_array_equal(np.asarray(im), img)


def test_encode_png_refuses_other_layouts():
    for bad in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4), np.uint8),
                np.zeros((4, 4, 2), np.uint8)):
        with pytest.raises(ValueError, match="encode_png"):
            encode_png(bad)


def test_save_png_matches_jax(tmp_path):
    from PIL import Image

    from rustic_tpu.utils.image_io import save_png as jax_save_png

    film = hdr_film(3, 24, 40)
    IO.save_png(str(tmp_path / "port.png"), film, Tonemapping.REINHARD)
    jax_save_png(str(tmp_path / "jax.png"), film, Tonemapping.REINHARD)
    with Image.open(tmp_path / "port.png") as a, Image.open(tmp_path / "jax.png") as b:
        got, want = np.asarray(a).astype(np.int32), np.asarray(b).astype(np.int32)
    assert np.abs(got - want).max() <= 1
    np.testing.assert_array_equal(got, IO.film_to_u8(film, Tonemapping.REINHARD))


def test_write_hdr_is_byte_equal_to_jax(tmp_path):
    from rustic_tpu.utils.hdr import write_hdr as jax_write_hdr

    film = hdr_film(4)
    write_hdr(str(tmp_path / "port.hdr"), film)
    jax_write_hdr(str(tmp_path / "jax.hdr"), film)
    raw = (tmp_path / "port.hdr").read_bytes()
    assert raw == (tmp_path / "jax.hdr").read_bytes()
    back = read_hdr(str(tmp_path / "port.hdr"))
    # RGBE keeps 8 bits of mantissa, shared by the three channels
    err = np.abs(back - film) / film.max(axis=-1, keepdims=True).clip(1e-30)
    assert err.max() <= 2 ** -8
    with pytest.raises(ValueError, match="write_hdr"):
        write_hdr(str(tmp_path / "bad.hdr"), film[..., 0])


@pytest.mark.parametrize("ext", [".npy", ".hdr", ".exr"])
def test_save_hdr_matches_jax_without_imageio(ext, tmp_path, monkeypatch):
    """The JAX package writes .exr through imageio, and a .npy beside the
    path when that fails; the port always does the latter."""
    from rustic_tpu.utils.image_io import save_hdr as jax_save_hdr

    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    film = hdr_film(5, 9, 11)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    IO.save_hdr(str(tmp_path / "port" / f"film{ext}"), film)
    jax_save_hdr(str(tmp_path / "jax" / f"film{ext}"), film)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == [f"film{ext}.npy" if ext == ".exr" else f"film{ext}"]
    assert (tmp_path / "port" / names[0]).read_bytes() == (tmp_path / "jax" / names[0]).read_bytes()


# ---- comparison ---------------------------------------------------------------------


def test_rmse_and_mae_match_jax():
    from rustic_tpu.utils import compare as JC

    a, b = hdr_film(6), hdr_film(7)
    assert C.rmse(a, b) == JC.rmse(a, b) and C.mae(a, b) == JC.mae(a, b)
    assert C.rmse(a, a) == 0.0 and C.mae(a, a) == 0.0
    assert abs(C.rmse(np.zeros(4), np.full(4, 2.0)) - 2.0) < 1e-12


@pytest.fixture(scope="module")
def cornell():
    return World.from_path(scene_path("DarkCornell.glb")).to_torch("cpu")


def test_engines_rmse_near_zero(cornell):
    """brute and flash agree on the CPU (tests/test_compare.py), and with
    the default engines ("brute", "bvh", "flash", as the JAX package's)
    all three do."""
    config = TracingConfig(width=16, height=16, nee=NextEventEstimation.MIS)
    out = C.compare_engines(cornell, config, 2, engines=("brute", "flash"), device="cpu")
    assert list(out) == ["brute_vs_flash"] and out["brute_vs_flash"] < 1e-3
    out = C.compare_engines(cornell, config, 1, device="cpu")
    assert list(out) == ["brute_vs_bvh", "brute_vs_flash", "bvh_vs_flash"]
    assert max(out.values()) < 1e-3, out


def test_reference_compare_roundtrip(cornell, tmp_path):
    config = TracingConfig(width=16, height=16)
    ref = str(tmp_path / "ref.npy")
    assert C.reference_compare(cornell, config, 2, ref, save_if_missing=False,
                               device="cpu") is None
    out = C.reference_compare(cornell, config, 2, ref, reference_samples=8, device="cpu")
    assert os.path.exists(ref) and np.load(ref).shape == (16, 16, 3)
    assert out["rmse"] >= 0.0 and out["mae"] <= out["rmse"] + 1e-12
    again = C.reference_compare(cornell, config, 2, ref, device="cpu")
    assert again == out  # the same film against the same reference


# ---- the furnace matrix -------------------------------------------------------------

SIZE = 128
COORD = (65, 75)
ALBEDO = 0.8


@pytest.fixture(scope="module")
def furnace():
    """The JAX conftest's FurnaceTest scene, fed to the port."""
    from rustic_tpu.scene.world import World as JaxWorld

    js = JaxWorld.from_path(scene_path("FurnaceTest.glb")).to_device()
    return scene_from_arrays(scene_fields(js), "cpu")


@pytest.mark.parametrize("nee, samples", [(NextEventEstimation.NONE, 32),
                                          (NextEventEstimation.MIS, 128)])
def test_furnace(furnace, nee, samples):
    """tests/test_furnace.py `test_furnace` and `test_furnace_mis`: MIS at
    4x the samples for its single-pixel variance."""
    cfg = TracingConfig(width=SIZE, height=SIZE, nee=nee)
    film = render_pixels(furnace, cfg, np.array([COORD[0]], np.int32),
                         np.array([COORD[1]], np.int32), samples, engine=None).numpy()
    pixel = (film[0] / samples) ** (1.0 / 2.2)
    assert np.all(np.abs(pixel - ALBEDO) < 0.02), pixel


def test_dls_matches_mis_on_black_emitters(tmp_path):
    """tests/test_furnace.py's DLS test: its scene written by the port's
    `write_glb`, loaded and rendered (brute) by the port."""
    from rustic_tpu_torch.scene.glb_write import MaterialSpec, MeshSpec, write_glb

    quad = np.array([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]], np.float32)
    lamp = quad * 0.25 + np.array([0, 3, 0], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    path = str(tmp_path / "dls.glb")
    write_glb(
        path,
        meshes=[
            MeshSpec(positions=quad, indices=tris, material=0),
            MeshSpec(positions=lamp, indices=tris[:, ::-1], material=1),
        ],
        materials=[
            MaterialSpec(base_color=(0.7, 0.7, 0.7, 1.0), metallic=0.0),
            MaterialSpec(base_color=(0, 0, 0, 1), emissive=(0.2, 0.2, 0.2)),
        ],
    )
    scene = World.from_path(path).to_torch("cpu")

    def mean(nee):
        cfg = TracingConfig(width=16, height=16, nee=nee, cam_position=(0.0, 1.5, -5.0),
                            cam_rotation=(0.3, 0.0), max_bounces=3)
        return float(render_image(scene, cfg, RenderSettings(samples=48), device="cpu",
                                  engine="brute").mean())

    m_mis = mean(NextEventEstimation.MIS)
    m_dls = mean(NextEventEstimation.DIRECT)
    assert m_mis > 0.01
    assert abs(m_dls - m_mis) / m_mis < 0.08, (m_dls, m_mis)


# ---- the reference films (slow: the card runs them in chip_smoke.py) ------------------

REF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                       "reference")
MIS = NextEventEstimation.MIS
FILMS = [
    ("DarkCornell", "darkcornell_256x144_2048spp.npy", dict(nee=MIS)),
    ("FurnaceTest", "furnacetest_256x144_1024spp.npy", dict()),
    ("VeachMIS", "veachmis_256x144_1024spp.npy",
     dict(nee=MIS, cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05))),
    ("GlassTest", "glasstest_256x144_1024spp.npy",
     dict(nee=MIS, cam_position=(0.0, 2.2, -6.5), cam_rotation=(0.15, 0.0))),
    ("BreakTime", "breaktime_256x144_1024spp.npy",
     dict(nee=MIS, cam_position=(0.0, 1.8, -3.2), has_skybox=True)),
]


@pytest.mark.slow  # film gates: minutes of CPU renders
@pytest.mark.parametrize("loop", ["kernel-shade", "state-sorted"])
@pytest.mark.parametrize("name, ref_file, cfg_kw", FILMS)
def test_against_reference_film(name, ref_file, cfg_kw, loop):
    """tests/test_reference_films.py through the port's default loop and
    its state-sorted driver (one-tile DarkCornell takes its one-tile loop
    under both names)."""
    ref = np.load(os.path.join(REF_DIR, ref_file))
    world = World.from_path(scene_path(f"{name}.glb"), 256)
    sky = load_skybox_image(scene_path(f"{name}Sky.npy")) if cfg_kw.get("has_skybox") else None
    scene = world.to_torch("cpu", sky)
    cfg = TracingConfig(width=256, height=144, **cfg_kw)
    film = render_image(scene, cfg, RenderSettings(samples=12, multitile_loop=loop),
                        device="cpu")
    rel_energy = abs(film.mean() - ref.mean()) / max(ref.mean(), 1e-9)
    assert rel_energy < 0.03, (name, film.mean(), ref.mean())
    rmse = C.rmse(film, ref)
    assert rmse < 0.35 * max(ref.mean(), 0.05) + 0.05, (name, rmse)
