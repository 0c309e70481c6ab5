"""The port's progressive state, checkpoints and profiling against the JAX
package's (runtime/state.py, utils/profiling.py), as tests/test_runtime.py
holds the JAX ones.

Both packages load DarkCornell with the NumPy BVH builder (the JAX World
prefers its C++ builder, which orders triangles otherwise). The renders
run the brute-force engine (`RenderSettings.engine="brute"`) at 16x16, 2
bounces, NEE+MIS: one JAX program for the whole file. Tolerances: a film
against JAX's rtol 1e-4, atol 1e-5 (the film tests' gate); progressive
against one-shot within the port rtol 1e-5, atol 1e-6 (the JAX test's);
a checkpoint's film sum, and a film resumed from it, equal bit for bit.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic_tpu_torch.runtime import state as state_mod
from rustic_tpu_torch.runtime.render import render_pixels
from rustic_tpu_torch.runtime.state import Checkpoint, TracingState
from rustic_tpu_torch.scene.world import World
from rustic_tpu_torch.utils import profiling as P
from tests.conftest import scene_path
from tests.test_torch_bvh_native import require_jax_native

torch.set_num_threads(2)

CFG = dict(width=16, height=16, max_bounces=2, nee=NextEventEstimation.MIS)
FILM_TOL = dict(rtol=1e-4, atol=1e-5)


@functools.lru_cache(maxsize=None)
def jax_world(name):
    """The JAX World of a committed scene, built by default (the native
    BVH order, as the port's)."""
    from rustic_tpu.scene.world import World as JaxWorld

    require_jax_native()
    return JaxWorld.from_path(scene_path(f"{name}.glb"))


@functools.lru_cache(maxsize=None)
def port_scene(name):
    return World.from_path(scene_path(f"{name}.glb")).to_torch("cpu")


def settings(**kw):
    return RenderSettings(**{"sync_rate": 2, "engine": "brute", **kw})


def config(**kw):
    return TracingConfig(**{**CFG, **kw})


def jax_state():
    from rustic_tpu.config import RenderSettings as JS
    from rustic_tpu.config import TracingConfig as JC
    from rustic_tpu.runtime.state import TracingState as JTS

    return JTS(16, 16, JC(**CFG), JS(sync_rate=2, engine="brute"))


@pytest.fixture(scope="module")
def jax_two_steps():
    """A JAX state after two steps of 2 samples."""
    st = jax_state()
    scene = jax_world("DarkCornell").to_device()
    st.step(scene)
    st.step(scene)
    return st, scene


def config_tuple(c):
    return (c.width, c.height, c.min_bounces, c.max_bounces, int(c.nee), bool(c.has_skybox),
            *c.cam_position, *c.cam_rotation, *c.sun_direction, *c.specular_weight_clamp)


# ---- TracingState ---------------------------------------------------------------------


def test_progressive_matches_jax_and_oneshot(jax_two_steps):
    """N steps of sync_rate samples == the JAX state's N steps, and == one
    step of N * sync_rate samples (the sums accumulate on the device)."""
    jst, _ = jax_two_steps
    scene = port_scene("DarkCornell")
    st = TracingState(16, 16, config(), settings())
    st.step(scene)
    frame = st.step(scene)
    assert st.samples == 4 and frame.shape == (16, 16, 3) and frame.dtype == np.float32
    assert frame.mean() > 0.01
    np.testing.assert_allclose(frame, jst.framebuffer, **FILM_TOL)
    np.testing.assert_allclose(st._film_sum.numpy(), np.asarray(jst._film_sum), **FILM_TOL)

    one = TracingState(16, 16, config(), settings()).step(scene, n_samples=4)
    np.testing.assert_allclose(frame, one, rtol=1e-5, atol=1e-6)


def test_dirty_resets_accumulator():
    scene = port_scene("DarkCornell")
    st = TracingState(16, 16, config(), settings(sync_rate=1))
    st.step(scene)
    assert st.samples == 1
    st.set_config(max_bounces=3)
    st.step(scene)
    assert st.samples == 1  # reset before the new sample
    st.interacting = True
    st.step(scene)
    assert st.samples == 1  # and while the user interacts


def test_restore_continues_accumulation():
    """Restoring mean * samples then adding samples equals rendering
    straight through (reference: src/trace.rs:162-164)."""
    scene = port_scene("DarkCornell")
    a = TracingState(16, 16, config(), settings())
    a.step(scene, 2)
    b = TracingState(16, 16, config(), settings())
    b.restore(a.framebuffer, a.samples)
    b.step(scene, 2)
    c = TracingState(16, 16, config(), settings())
    c.step(scene, 4)
    np.testing.assert_allclose(b.framebuffer, c.framebuffer, rtol=1e-4, atol=1e-5)


def test_run_until_target():
    st = TracingState(16, 16, config(), settings(sync_rate=3))
    frames = []
    st.run(port_scene("DarkCornell"), target_samples=7, on_frame=lambda f, s: frames.append(s))
    assert st.samples == 7 and frames == [3, 6, 7] and not st.running


def test_stop_ends_run():
    st = TracingState(8, 8, config(), settings(sync_rate=1))
    seen = []

    def on_frame(frame, samples):
        seen.append(samples)
        if samples == 2:
            st.stop()

    st.run(port_scene("DarkCornell"), on_frame=on_frame)
    assert seen == [1, 2] and st.samples == 2


def test_resize_via_set_config():
    """set_config(width/height) rebuilds the pixel set at the next step."""
    scene = port_scene("DarkCornell")
    st = TracingState(16, 16, config(), settings(sync_rate=1))
    st.step(scene)
    st.set_config(width=8, height=8)
    frame = st.step(scene)
    assert frame.shape == (8, 8, 3) and st.samples == 1
    assert st._film_sum.shape == (64, 3)


def test_settings_engine_reaches_render(monkeypatch):
    seen = {}
    real = state_mod.render_pixels

    def spy(*a, **kw):
        seen.update(engine=kw.get("engine"), backend=kw.get("backend"))
        return real(*a, **kw)

    monkeypatch.setattr(state_mod, "render_pixels", spy)
    st = TracingState(8, 8, config(), settings(sync_rate=1, engine="bvh", backend="cpu"))
    st.step(port_scene("DarkCornell"))
    assert seen == {"engine": "bvh", "backend": "cpu"}


def test_denoise_setting_denoises_the_published_frame():
    from rustic_tpu_torch.runtime.denoise import denoise

    scene = port_scene("DarkCornell")
    raw = TracingState(16, 16, config(), settings()).step(scene)
    den = TracingState(16, 16, config(), settings(denoise=True)).step(scene)
    np.testing.assert_array_equal(den, denoise(raw, device="cpu"))


def test_render_pixels_refuses_a_film_on_another_device():
    """The staged path never moves film_in: a film sum on another device
    than the render's is an error, raised before any kernel runs."""
    scene = port_scene("DarkCornell")
    px = py = np.zeros(4, np.int32)
    other = torch.zeros((4, 3), dtype=torch.float32, device="meta")
    for engine in (None, "brute"):
        with pytest.raises(ValueError, match="film_in is on meta"):
            render_pixels(scene, config(), px, py, 1, film_in=other, engine=engine)
    film = render_pixels(scene, config(), px, py, 1, film_in=torch.zeros(4, 3), engine="brute")
    assert film.device.type == "cpu"


# ---- Checkpoint -----------------------------------------------------------------------


@pytest.mark.parametrize("fname", ["ckpt.npz", "ckpt"])
def test_checkpoint_roundtrip(tmp_path, fname):
    scene = port_scene("DarkCornell")
    st = TracingState(16, 16, config(cam_rotation=(0.1, -0.2)), settings())
    st.step(scene, 2)
    path = os.path.join(tmp_path, fname)
    Checkpoint.from_state(st).save(path)
    assert os.path.exists(path)  # no suffix appended
    with np.load(path) as data:
        assert sorted(data.files) == ["config", "film_sum", "samples"]
        assert data["config"].dtype == np.float64 and data["config"].shape == (17,)

    resumed = Checkpoint.load(path).into_state(settings())
    assert resumed.samples == 2
    assert config_tuple(resumed.config) == config_tuple(st.config)
    np.testing.assert_array_equal(resumed.framebuffer, st.framebuffer)
    resumed.step(scene, 2)
    straight = TracingState(16, 16, config(cam_rotation=(0.1, -0.2)), settings())
    straight.step(scene, 4)
    np.testing.assert_allclose(resumed.framebuffer, straight.framebuffer, rtol=1e-4, atol=1e-5)


def test_checkpoint_resume_is_exact():
    """into_state assigns the stored sum itself: the resumed film sum, and
    the film after further steps, equal the uninterrupted state's bit for
    bit."""
    scene = port_scene("DarkCornell")
    st = TracingState(8, 8, config(), settings(sync_rate=3))
    st.step(scene)
    ck = Checkpoint.from_state(st)
    resumed = ck.into_state(settings(sync_rate=3))
    assert torch.equal(resumed._film_sum, st._film_sum) and resumed.samples == st.samples
    st.step(scene)
    resumed.step(scene)
    assert torch.equal(resumed._film_sum, st._film_sum)
    np.testing.assert_array_equal(resumed.framebuffer, st.framebuffer)
    # the checkpoint is a snapshot: the state's later steps leave it alone
    assert not np.array_equal(ck.film_sum, st._film_sum.numpy())


def test_jax_checkpoint_loads_in_the_port(jax_two_steps, tmp_path):
    from rustic_tpu.runtime.state import Checkpoint as JaxCheckpoint

    jst, jscene = jax_two_steps
    path = os.path.join(tmp_path, "jax.npz")
    JaxCheckpoint.from_state(jst).save(path)
    resumed = Checkpoint.load(path).into_state(settings())
    np.testing.assert_array_equal(resumed._film_sum.numpy(), np.asarray(jst._film_sum))
    np.testing.assert_array_equal(resumed.framebuffer, jst.framebuffer)
    assert resumed.samples == jst.samples == 4
    assert config_tuple(resumed.config) == config_tuple(jst.config)
    # both packages continue from it to the same film
    jres = JaxCheckpoint.load(path).into_state(jst.settings)
    jres.step(jscene)
    resumed.step(port_scene("DarkCornell"))
    assert resumed.samples == jres.samples == 6
    np.testing.assert_allclose(resumed.framebuffer, jres.framebuffer, **FILM_TOL)


def test_port_checkpoint_loads_in_jax(tmp_path):
    from rustic_tpu.runtime.state import Checkpoint as JaxCheckpoint

    st = TracingState(16, 16, config(cam_position=(0.5, 1.0, -4.0)), settings())
    st.step(port_scene("DarkCornell"))
    path = os.path.join(tmp_path, "port")
    Checkpoint.from_state(st).save(path)
    jres = JaxCheckpoint.load(path).into_state()
    np.testing.assert_array_equal(np.asarray(jres._film_sum), st._film_sum.numpy())
    np.testing.assert_array_equal(jres.framebuffer, st.framebuffer)
    assert jres.samples == 2
    assert config_tuple(jres.config) == config_tuple(st.config)


# ---- profiling ------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(width=1280, height=720, samples=160, max_bounces=4, nee=True, wall_s=1.5),
    dict(width=16, height=8, samples=3, max_bounces=2, nee=False, wall_s=0.0),
])
def test_render_stats_match_jax(case):
    from rustic_tpu.utils.profiling import RenderStats as JaxRenderStats

    got, want = P.RenderStats(**case), JaxRenderStats(**case)
    for name in ("camera_paths", "mpaths_per_s", "est_rays", "est_mrays_per_s", "spp_per_s"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.summary() == want.summary()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_stage_timers_match_jax(monkeypatch):
    import rustic_tpu.utils.profiling as JP

    def fake_clock():
        ticks = iter([0.0, 0.25, 1.0, 1.125, 2.0, 2.5])
        return lambda: next(ticks)

    reports = []
    for mod in (P, JP):
        monkeypatch.setattr(mod.time, "perf_counter", fake_clock())
        timers = mod.StageTimers()
        for name in ("trace", "shade", "trace"):
            with timers.time(name):
                pass
        reports.append((timers.report(), timers.totals, timers.counts))
        monkeypatch.undo()
    assert reports[0] == reports[1]
    assert reports[0][0] == "trace: 750.0 ms total / 2 calls\nshade: 125.0 ms total / 1 calls"


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = os.path.join(tmp_path, "trace")
    with P.device_trace(log_dir):
        torch.ones(64).cumsum(0)
    with open(os.path.join(log_dir, "trace.json")) as f:
        trace = json.load(f)
    assert any("cumsum" in e.get("name", "") for e in trace["traceEvents"])
    with P.device_trace(None):  # no-op
        pass
    assert os.listdir(tmp_path) == ["trace"]
