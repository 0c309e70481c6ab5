"""The port's unsorted multi-tile render path against the JAX staged
renderer.

One scene feeds both packages (the JAX SceneArrays passes to the port
through scene_from_arrays), with the same pixel offsets: the port's
film (plain versions on the CPU) must match the JAX film of
`render_batch_staged` with path sorting off (its unsorted multi-tile
stage loop; Pallas interpret mode, "f32" plan) to rtol 1e-4, atol 1e-5.
The port takes that loop when asked for its "unsorted" multi-tile loop,
the JAX package with its RUSTIC_SORT_PATHS flag patched off;
tests/test_torch_sorted.py covers the sorted loops."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.runtime import pipeline as P
from rustic_tpu_torch.runtime.render import pixel_offsets, render_image, render_pixels
from rustic_tpu_torch.scene.world import scene_from_arrays
from tests.conftest import scene_path

torch.set_num_threads(2)

W_, H_ = 16, 12
CASES = {
    "VeachMIS": dict(cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05)),
    "GlassTest": dict(cam_position=(0.0, 2.2, -6.5), cam_rotation=(0.15, 0.0)),
}


UNSORTED = "unsorted"


def scene_fields(scene) -> dict:
    out = {
        k: np.asarray(getattr(scene, k))
        for k in ("tri_feats16", "tri_attrs", "entry_rows", "tile_aabbs")
    }
    for k in ("n_tris", "n_alias_entries", "has_lights", "has_glass", "has_textures"):
        out[k] = getattr(scene, k)
    return out


def jax_scene(name):
    from rustic_tpu.scene.world import World

    return World.from_path(scene_path(f"{name}.glb")).to_device()


@pytest.mark.parametrize("name", sorted(CASES))
def test_multitile_film_matches_jax_unsorted(name, monkeypatch):
    from rustic_tpu.config import TracingConfig as JaxTracingConfig
    from rustic_tpu.runtime import pipeline as JP

    js = jax_scene(name)
    ts = scene_from_arrays(scene_fields(js), "cpu")
    assert FI.geometry(ts.tri_feats16)[2] > 1
    monkeypatch.setattr(JP, "_SORT_PATHS", False)
    spp = 2
    jconfig = JaxTracingConfig(width=W_, height=H_, nee=NextEventEstimation.MIS, **CASES[name])
    y, x = np.mgrid[0:H_, 0:W_]
    px = x.reshape(-1).astype(np.int32)
    py = y.reshape(-1).astype(np.int32)
    off = pixel_offsets(W_, H_)
    want = np.asarray(
        JP.render_batch_staged(
            js, jconfig.static_part(), jconfig.dynamic_part(),
            jnp.asarray(px), jnp.asarray(py), jnp.asarray(off), 0, spp,
        )
    )
    config = TracingConfig(width=W_, height=H_, nee=NextEventEstimation.MIS, **CASES[name])
    got = render_pixels(ts, config, px, py, spp, offsets=off, loop=UNSORTED).numpy()
    assert got.shape == (W_ * H_, 3) and np.isfinite(got).all()
    assert got.mean() > 0.01
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def veach_port():
    return scene_from_arrays(scene_fields(jax_scene("VeachMIS")), "cpu")


def count_calls(monkeypatch, mod, names, calls):
    """Wrap each of `names` in `mod` to count its calls into `calls`."""
    for name in names:
        fn = getattr(mod, name)

        def wrapper(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        calls[name] = 0
        monkeypatch.setattr(mod, name, wrapper)


SCANS = ("nearest_multi", "nearest_shadow_multi", "occlude_multi",
         "nearest_attrs", "nearest_shadow_attrs", "occlude")


@pytest.mark.parametrize(
    "samples, expect",
    [
        # groups 4, 4, 4: one K5 opens the render, every later scan carries
        # shadow rays (the previous bounce's or the held group's), one K7
        # closes it
        (12, (1, 11, 1)),
        # groups 4, 4, 2: the short group has another lane count, so the
        # held group is flushed by K7 and the short group opens with K5
        (10, (2, 10, 2)),
    ],
)
def test_multitile_group_structure(veach_port, monkeypatch, samples, expect):
    """Fold 4; every bounce of every group shades once."""
    calls = {}
    count_calls(monkeypatch, FI, SCANS, calls)
    count_calls(monkeypatch, P, ("stage_pre",), calls)
    monkeypatch.setattr(P, "_FOLD_MAX_LANES", 4 * 64)
    config = TracingConfig(
        width=16, height=4, nee=NextEventEstimation.MIS, **CASES["VeachMIS"]
    )
    settings = RenderSettings(samples=samples, multitile_loop=UNSORTED, multitile_scan="lists")
    film = render_image(veach_port, config, settings, device="cpu")
    assert film.shape == (4, 16, 3) and np.isfinite(film).all()
    assert calls == {
        "nearest_multi": expect[0],
        "nearest_shadow_multi": expect[1],
        "occlude_multi": expect[2],
        "stage_pre": 3 * config.max_bounces,
        "nearest_attrs": 0, "nearest_shadow_attrs": 0, "occlude": 0,
    }


def test_multitile_refuses_hdr_sky(veach_port):
    """HDR skies were refused before BreakTime was ported; now the
    unsorted loop renders one: the lanes that see the sky take the image's
    radiance instead of the procedural sky's, the others are unchanged."""
    import dataclasses

    from rustic_tpu_torch.scene.world import load_skybox_image

    sky = torch.from_numpy(load_skybox_image(scene_path("BreakTimeSky.npy")))
    scene = dataclasses.replace(veach_port, skybox=sky)
    settings = RenderSettings(samples=1, multitile_loop=UNSORTED)
    films = {
        has_sky: render_image(scene, TracingConfig(width=8, height=8, has_skybox=has_sky,
                                                   **CASES["VeachMIS"]), settings, device="cpu")
        for has_sky in (False, True)
    }
    assert np.isfinite(films[True]).all()
    assert not np.array_equal(films[True], films[False])


def test_multitile_without_nee_has_no_shadow_scans(veach_port, monkeypatch):
    """NEE off: one plain nearest scan per bounce, nothing held."""
    calls = {}
    count_calls(monkeypatch, FI, SCANS, calls)
    config = TracingConfig(width=8, height=4, nee=NextEventEstimation.NONE, **CASES["VeachMIS"])
    film = render_image(veach_port, config, RenderSettings(samples=2, multitile_loop=UNSORTED,
                                                           multitile_scan="lists"), device="cpu")
    assert np.isfinite(film).all() and film.mean() > 0.0
    assert calls == dict.fromkeys(SCANS, 0) | {"nearest_multi": config.max_bounces}
