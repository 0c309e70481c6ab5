"""The port's whole slice against the JAX staged renderer.

One scene feeds both packages (the JAX SceneArrays passes to the port
through scene_from_arrays), with the same pixel offsets: the port's
film (plain versions on the CPU) must match the JAX kernel-shade film
(Pallas interpret mode, "f32" plan) to rtol 1e-4, atol 1e-5, the gate
of tests/test_shade_kernel.py."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.ops import shade_kernel as SK
from rustic_tpu_torch.runtime import pipeline as P
from rustic_tpu_torch.runtime.render import pixel_offsets, render_image, render_pixels
from rustic_tpu_torch.scene.world import scene_from_arrays

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W_, H_ = 32, 16  # 512 lanes: the smallest batch the JAX kernel-shade path takes


def scene_fields(scene) -> dict:
    out = {
        k: np.asarray(getattr(scene, k))
        for k in ("tri_feats16", "tri_attrs", "entry_rows", "tile_aabbs")
    }
    for k in ("n_tris", "n_alias_entries", "has_lights", "has_glass", "has_textures"):
        out[k] = getattr(scene, k)
    return out


@pytest.fixture(scope="module")
def port_scene(cornell_scene):
    return scene_from_arrays(scene_fields(cornell_scene), "cpu")


def test_slice_film_matches_jax_kernelshade(cornell_scene, port_scene):
    from rustic_tpu.config import TracingConfig as JaxTracingConfig
    from rustic_tpu.ops import shade_kernel as JSK
    from rustic_tpu.runtime.pipeline import render_batch_staged

    spp = 2
    jconfig = JaxTracingConfig(width=W_, height=H_, nee=NextEventEstimation.MIS)
    assert JSK.supported(cornell_scene, jconfig.static_part(), False, W_ * H_)
    y, x = np.mgrid[0:H_, 0:W_]
    px = x.reshape(-1).astype(np.int32)
    py = y.reshape(-1).astype(np.int32)
    off = pixel_offsets(W_, H_)
    want = np.asarray(
        render_batch_staged(
            cornell_scene, jconfig.static_part(), jconfig.dynamic_part(),
            jnp.asarray(px), jnp.asarray(py), jnp.asarray(off), 0, spp,
        )
    )
    config = TracingConfig(width=W_, height=H_, nee=NextEventEstimation.MIS)
    got = render_pixels(port_scene, config, px, py, spp, offsets=off, engine=None).numpy()
    assert got.shape == (W_ * H_, 3) and np.isfinite(got).all()
    assert got.mean() > 0.01
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "samples, expect",
    [
        # groups 4, 4, 4: one plain scan opens the render, every later scan
        # carries shadow rays (the previous bounce's or the held group's),
        # one occlusion scan closes it
        (12, (1, 11, 1)),
        # groups 4, 4, 2: the short group has another lane count, so the
        # held group is flushed by an occlusion scan and the short group
        # opens with a plain scan
        (10, (2, 10, 2)),
    ],
)
def test_group_structure_launches_each_stage_as_planned(port_scene, monkeypatch, samples, expect):
    """Fold 4; every bounce of every group shades once."""
    calls = {"nearest_attrs": 0, "nearest_shadow_attrs": 0, "occlude": 0, "shade_bounce": 0}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapper)

    for name in ("nearest_attrs", "nearest_shadow_attrs", "occlude"):
        counted(FI, name)
    counted(SK, "shade_bounce")
    monkeypatch.setattr(P, "_FOLD_MAX_LANES", 4 * 64)
    config = TracingConfig(width=16, height=4, nee=NextEventEstimation.MIS)
    film = render_image(port_scene, config, RenderSettings(samples=samples), device="cpu")
    assert film.shape == (4, 16, 3) and np.isfinite(film).all()
    assert calls == {
        "nearest_attrs": expect[0],
        "nearest_shadow_attrs": expect[1],
        "occlude": expect[2],
        "shade_bounce": 3 * config.max_bounces,
    }


def test_default_offsets_hash_the_pixel_id(port_scene):
    """Without offsets, each pixel is seeded with pcg_hash(y * width + x),
    as rustic_tpu.runtime.render.render_pixels seeds it."""
    from rustic_tpu.ops.rng import pcg_hash_np

    config = TracingConfig(width=W_, height=H_, nee=NextEventEstimation.MIS)
    px = np.arange(0, 24, 3, dtype=np.int32)
    py = np.full(8, 5, np.int32)
    seeded = pcg_hash_np((py * W_ + px).astype(np.uint32))
    assert torch.equal(
        render_pixels(port_scene, config, px, py, 1, engine=None),
        render_pixels(port_scene, config, px, py, 1, offsets=seeded, engine=None),
    )


def test_render_image_refuses_missing_cuda(port_scene):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")  # the refusal needs its absence
    config = TracingConfig(width=W_, height=H_, nee=NextEventEstimation.MIS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_image(port_scene, config, RenderSettings(samples=1), device="cuda")


def test_port_runs_without_jax():
    """The port imports and renders with jax, flax, rustic_tpu, tools and
    archive blocked from import."""
    code = textwrap.dedent(
        """
        import sys
        for name in ("jax", "flax", "rustic_tpu", "tools", "archive"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(2)
        import rustic_tpu_torch
        from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
        from rustic_tpu_torch.runtime.render import render_image
        from rustic_tpu_torch.scene.world import World

        scene = World.from_path("assets/scenes/DarkCornell.glb").to_torch("cpu")
        config = TracingConfig(width=32, height=16, nee=NextEventEstimation.MIS)
        film = render_image(scene, config, RenderSettings(samples=1), device="cpu")
        assert film.shape == (16, 32, 3) and film.mean() > 0.0, film.mean()
        # a multi-tile scene (VeachMIS, 6 triangle tiles, 2,880 alias entries)
        # through the default (kernel-shade) loop and the ray-sorted loop
        veach = World.from_path("assets/scenes/VeachMIS.glb").to_torch("cpu")
        config = TracingConfig(width=8, height=6, nee=NextEventEstimation.MIS,
                               cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05))
        for settings in (RenderSettings(samples=1),
                         RenderSettings(samples=1, multitile_loop="ray-sorted")):
            film = render_image(veach, config, settings, device="cpu")
            assert film.shape == (6, 8, 3) and film.mean() > 0.0, film.mean()
        # the fused loop (K17's plain version) on one tile and on many
        fused = RenderSettings(samples=1, single_tile_loop="fused", multitile_loop="fused")
        film = render_image(veach, config, fused, device="cpu")
        assert film.shape == (6, 8, 3) and film.mean() > 0.0, film.mean()
        config = TracingConfig(width=32, height=16, nee=NextEventEstimation.MIS)
        assert render_image(scene, config, fused, device="cpu").mean() > 0.0
        # the dot probes (K18, K19: their plain versions) and their programs
        import rustic_tpu_torch.probe_kernel_builds
        from rustic_tpu_torch import probe_dot_floor
        from rustic_tpu_torch.ops import probe_dot
        f, g = probe_dot_floor.operands("fp32", 16, 64, 32, "cpu")
        out = probe_dot.dot_min_split(f, probe_dot.cat6_g(g), 16, 2)
        assert torch.allclose(out, probe_dot.dot_min(f, g, 16, 2), atol=1e-4)
        assert not any(m == "jax" or m.startswith(("jax.", "flax", "rustic_tpu.", "tools", "archive"))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
