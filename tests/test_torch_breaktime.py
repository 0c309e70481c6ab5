"""BreakTime (textures, normal maps, HDR sky; 21 triangle tiles) rendered
by the port on the CPU against the JAX package, and the HDR-sky payoff
of the kernel-shade loops.

One JAX scene feeds both packages (scene_from_arrays), BreakTime with a
256-texel atlas and BreakTimeSky.npy, with the same pixel offsets; 512
pixels (the JAX kernel-shade driver's lane block, `supported_mt`), 2 spp.

Tolerance of the BreakTime films: rtol 1e-4, atol 1e-5 on at least 98% of
the pixels, and every pixel within rtol 2e-2, atol 1e-4; film means
within 1e-5 relative. The looser part is the scene's, not the port's: on
this film the JAX package's own kernel-shade and ray-sorted drivers
differ on 3 of 512 pixels by up to 8e-4. XLA contracts a*b + c into FMAs
(tests/test_torch_textures.py), and a normal-mapped glossy bounce turns
an ulp of a uv into a visibly different continuation over four bounces.
The port's textured operations match eager JAX to rtol 1e-5
(tests/test_torch_textures.py).

The single-tile HDR check uses the glass-and-sky scene of
tests/test_torch_scene.py (open to the sky) against the JAX single-tile
kernel-shade driver: rtol 1e-4, atol 1e-5 everywhere."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rustic_tpu.scene.gltf import load_glb as jax_load_glb
from rustic_tpu.scene.world import World as JaxWorld
from rustic_tpu.scene.world import load_skybox_image as jax_sky
from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.ops import shade_kernel as SK
from rustic_tpu_torch.runtime import pipeline as P
from rustic_tpu_torch.runtime.render import pixel_offsets, render_image, render_pixels
from rustic_tpu_torch.scene.world import World, load_skybox_image, scene_from_arrays
from tests.conftest import scene_path
from tests.test_torch_flash_grid import scene_fields
from tests.test_torch_render_multitile import count_calls
from tests.test_torch_sorted import JAX_SETTINGS, spy

torch.set_num_threads(2)

CAM = dict(cam_position=(0.0, 1.8, -3.2), has_skybox=True)
FILM_W, FILM_H = 32, 16
SPP = 2
SKY = scene_path("BreakTimeSky.npy")


@pytest.fixture(scope="module")
def breaktime():
    js = JaxWorld(jax_load_glb(scene_path("BreakTime.glb")), 256).to_device(jax_sky(SKY))
    return js, scene_from_arrays(scene_fields(js), "cpu")


def pixels():
    y, x = np.mgrid[0:FILM_H, 0:FILM_W]
    return x.reshape(-1).astype(np.int32), y.reshape(-1).astype(np.int32)


_JAX_FILMS = {}


def jax_film(js, driver, monkeypatch):
    """The JAX film of `driver` ("kernel-shade" or "ray-sorted"), its
    dispatch spied, computed once per module."""
    if driver not in _JAX_FILMS:
        from rustic_tpu.config import TracingConfig as JaxTracingConfig
        from rustic_tpu.runtime import pipeline as JP

        monkeypatch.setattr(JP, "_SORT_PATHS", True)
        for k, v in JAX_SETTINGS[driver].items():
            monkeypatch.setenv(k, v)
        fn = "_render_batch_raysorted" if driver == "ray-sorted" else "_render_batch_ks_multitile"
        calls = spy(monkeypatch, JP, fn)
        config = JaxTracingConfig(width=FILM_W, height=FILM_H, nee=NextEventEstimation.MIS, **CAM)
        x, y = pixels()
        film = np.asarray(JP.render_batch_staged(
            js, config.static_part(), config.dynamic_part(), jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(pixel_offsets(FILM_W, FILM_H)), 0, SPP,
        ))
        assert calls, "the JAX driver under test was not dispatched"
        _JAX_FILMS[driver] = film
    return _JAX_FILMS[driver]


def port_film(ts, loop, scan):
    config = TracingConfig(width=FILM_W, height=FILM_H, nee=NextEventEstimation.MIS, **CAM)
    x, y = pixels()
    return render_pixels(ts, config, x, y, SPP, offsets=pixel_offsets(FILM_W, FILM_H),
                         loop=loop, scan=scan, engine=None).numpy()


def assert_film_close(got, want):
    assert got.shape == want.shape == (FILM_W * FILM_H, 3)
    assert np.isfinite(got).all() and got.mean() > 0.05
    tight = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=1)
    assert tight.mean() >= 0.98, f"{int((~tight).sum())} pixels outside rtol 1e-4 / atol 1e-5"
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=1e-4)
    assert abs(got.mean() / want.mean() - 1.0) < 1e-5


@pytest.mark.parametrize("loop, scan, driver", [
    ("kernel-shade", "lists", "kernel-shade"),
    ("kernel-shade", "grid", "kernel-shade"),
    ("ray-sorted", "lists", "ray-sorted"),
    ("ray-sorted", "grid", "ray-sorted"),
])
def test_breaktime_film_matches_jax(breaktime, monkeypatch, loop, scan, driver):
    js, ts = breaktime
    want = jax_film(js, driver, monkeypatch)
    fn = "_render_batch_ks_multitile" if loop == "kernel-shade" else "_render_batch_raysorted"
    calls = spy(monkeypatch, P, fn)
    assert_film_close(port_film(ts, loop, scan), want)
    assert calls == [1]


# the fused loop takes no textured scene (tests/test_torch_fused.py)
@pytest.mark.parametrize("loop", [name for name in P.MULTITILE_LOOPS if name != "fused"])
def test_scan_forms_give_one_film(breaktime, monkeypatch, loop):
    """Each loop gives the same film with either scan form, and the grid
    form runs no tile lists and none of K5-K7."""
    _, ts = breaktime
    lists = port_film(ts, loop, "lists")
    calls = {}
    count_calls(monkeypatch, FI, ("block_tile_lists", "nearest_multi", "nearest_shadow_multi",
                                  "occlude_multi", "nearest_grid", "nearest_shadow_grid",
                                  "occlude_grid"), calls)
    grid = port_film(ts, loop, "grid")
    np.testing.assert_array_equal(grid, lists)
    nb = 4  # max_bounces; one group of 2 folded samples
    assert calls == {"block_tile_lists": 0, "nearest_multi": 0, "nearest_shadow_multi": 0,
                     "occlude_multi": 0, "nearest_grid": 1, "nearest_shadow_grid": nb - 1,
                     "occlude_grid": 1}


def test_breaktime_loops_agree(breaktime):
    """The reference loops give one film; the kernel-shade loop (K4 with
    the resolved rows, HDR payoff after the last bounce) the same to
    rtol 1e-4, atol 1e-5."""
    _, ts = breaktime
    unsorted = port_film(ts, "unsorted", "lists")
    np.testing.assert_allclose(port_film(ts, "ray-sorted", "lists"), unsorted, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(port_film(ts, "kernel-shade", "lists"), unsorted, rtol=1e-4,
                               atol=1e-5)


def test_breaktime_shades_with_k4(breaktime, monkeypatch):
    """BreakTime's two alias entries fit K4's table: the kernel-shade loop
    shades every bounce with K4 in HDR mode."""
    _, ts = breaktime
    assert ts.n_alias_entries <= SK.MAX_ALIAS and ts.has_textures
    calls = {}
    count_calls(monkeypatch, SK, ("shade_bounce", "shade_bounce_wide"), calls)
    count_calls(monkeypatch, P, ("hdr_sky_payoff",), calls)
    config = TracingConfig(width=8, height=4, nee=NextEventEstimation.MIS, **CAM)
    film = render_image(ts, config, RenderSettings(samples=1), device="cpu")
    assert np.isfinite(film).all()
    assert calls == {"shade_bounce": config.max_bounces, "shade_bounce_wide": 0,
                     "hdr_sky_payoff": 1}


def test_hdr_payoff_is_the_image_sky(breaktime):
    """The payoff adds throughput x image_sky along the last rays on the
    lanes that escaped, and nothing elsewhere."""
    _, ts = breaktime
    rng = np.random.default_rng(0)
    b = 300
    st = torch.from_numpy(rng.uniform(0, 1, (SK.NST, b)).astype(np.float32))
    st[SK.SK_MISSED] = torch.from_numpy((rng.uniform(0, 1, b) < 0.5).astype(np.float32))
    rd = rng.normal(0, 1, (b, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    feats = P._ray_features16(torch.zeros(b, 3), torch.from_numpy(rd))
    sun = TracingConfig().dynamic_part("cpu").sun_direction
    before = st.clone()
    out = P.hdr_sky_payoff(ts.skybox, sun, st, feats)
    missed = before[SK.SK_MISSED] > 0.5
    sky = P.image_sky(ts.skybox, sun, torch.from_numpy(rd)).T
    want = before[SK.SK_RAD] + torch.where(missed[None], before[SK.SK_THR] * sky, 0.0)
    assert torch.equal(out[SK.SK_RAD], want)
    assert torch.equal(out[SK.SK_RAD][:, ~missed], before[SK.SK_RAD][:, ~missed])
    keep = [r for r in range(SK.NST) if r not in range(3, 6)]
    assert torch.equal(out[keep], before[keep])


def test_single_tile_hdr_sky_matches_jax(tmp_path, monkeypatch):
    """One triangle tile under an HDR sky: the single-tile kernel-shade
    loop (K1/K2, K4 in HDR mode, the payoff) against the JAX single-tile
    kernel-shade driver (`_render_batch_kernelshade`, spied)."""
    from rustic_tpu.config import TracingConfig as JaxTracingConfig
    from rustic_tpu.runtime import pipeline as JP
    from tests.test_torch_scene import write_glass_sky

    path = str(tmp_path / "glass_sky.glb")
    write_glass_sky(path)
    js = JaxWorld.from_path(path).to_device(jax_sky(SKY))
    ts = scene_from_arrays(scene_fields(js), "cpu")
    assert FI.geometry(ts.tri_feats16)[2] == 1
    cam = dict(cam_position=(0.0, 2.5, -6.0), cam_rotation=(0.3, 0.0), has_skybox=True)
    calls = spy(monkeypatch, JP, "_render_batch_kernelshade")
    config = JaxTracingConfig(width=FILM_W, height=FILM_H, nee=NextEventEstimation.MIS, **cam)
    x, y = pixels()
    want = np.asarray(JP.render_batch_staged(
        js, config.static_part(), config.dynamic_part(), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(pixel_offsets(FILM_W, FILM_H)), 0, SPP,
    ))
    assert calls, "the JAX single-tile kernel-shade driver was not dispatched"
    config = TracingConfig(width=FILM_W, height=FILM_H, nee=NextEventEstimation.MIS, **cam)
    got = render_pixels(ts, config, x, y, SPP, offsets=pixel_offsets(FILM_W, FILM_H),
                        engine=None).numpy()
    assert np.isfinite(got).all() and got.max() > 0.5  # the sky is seen
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_port_world_renders_breaktime():
    """The port's own BreakTime World (PNG decoder, Lanczos twin) renders
    the same film as the JAX World's arrays."""
    ts = World.from_path(scene_path("BreakTime.glb"), 256).to_torch("cpu", load_skybox_image(SKY))
    config = TracingConfig(width=8, height=6, nee=NextEventEstimation.MIS, **CAM)
    film = render_image(ts, config, RenderSettings(samples=1, multitile_scan="grid"),
                        device="cpu")
    assert film.shape == (6, 8, 3) and np.isfinite(film).all() and film.mean() > 0.05
