"""The port's viewer core (rustic_tpu_torch/runtime/viewer.py) without a
display, as tests/test_viewer.py drives the JAX one: keys, mouse drag,
sun controls, `load_path` and the 'c' toggle. Key and mouse handling are
held to the JAX Viewer's: the same events give the same config, bit for
bit (both do the same Python float arithmetic). One step's frame is held
to the JAX Viewer's within rtol 1e-4, atol 1e-5 (DarkCornell 16x16, 2
bounces, the brute-force engine, both packages on the NumPy BVH
builder's triangle order). The
displayed frame is the port's `apply_tonemap` of the framebuffer exactly,
and within rtol 1e-6, atol 1e-6 of the JAX Viewer's: ACES Hill's 3x3
matrices are dots that XLA's CPU build contracts into FMAs, which moves a
dark value by a few 1e-7 (tests/test_torch_quality.py holds the operators
themselves).
"""

import os

import numpy as np
import pytest
import torch

from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, Tonemapping, TracingConfig
from rustic_tpu_torch.ops.tonemap import apply_tonemap
from rustic_tpu_torch.runtime.viewer import Viewer
from rustic_tpu_torch.scene.world import World
from tests.conftest import scene_path
from tests.test_torch_runtime import config_tuple, jax_world, port_scene

torch.set_num_threads(2)

CFG = dict(width=16, height=16, max_bounces=2)


def viewer(scene=None, **settings):
    return Viewer(scene if scene is not None else port_scene("DarkCornell"),
                  TracingConfig(**CFG),
                  RenderSettings(**{"sync_rate": 1, "engine": "brute", **settings}))


def jax_viewer(scene=None):
    from rustic_tpu.config import RenderSettings as JS
    from rustic_tpu.config import TracingConfig as JC
    from rustic_tpu.runtime.viewer import Viewer as JaxViewer

    return JaxViewer(scene, JC(**CFG), JS(sync_rate=1, engine="brute"))


def test_step_matches_jax():
    v = viewer()
    frame = v.step()
    assert frame.shape == (16, 16, 3) and np.isfinite(frame).all() and v.state.samples == 1
    jv = jax_viewer(jax_world("DarkCornell").to_device())
    want = jv.step()
    np.testing.assert_allclose(v.state.framebuffer, jv.state.framebuffer, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(frame, want, rtol=1e-4, atol=1e-5)


KEYS = {
    "move": ["w", "a", "s", "d", "q", "e", "d", "w"],
    "speed": ["w", "shift+w", "ctrl+w", "W", "shift+ctrl+a"],
    "look": ["up", "left", "left", "down", "right", "up"],
    "sun": ["l", "l", "i", "j", "k", "=", "-", "-", "i", "i"],
    "modes": ["n", "t", "x", "n", "t", "t", "n", "x", "t"],
}


@pytest.mark.parametrize("name", sorted(KEYS))
def test_keys_match_jax(name):
    v, jv = viewer(), jax_viewer()
    for key in KEYS[name]:
        assert v.handle_key(key) and jv.handle_key(key)
        assert config_tuple(v.state.config) == config_tuple(jv.state.config), key
        assert int(v.tonemap) == int(jv.tonemap) and v.settings.denoise == jv.settings.denoise
    assert v.state._dirty == jv.state._dirty


def test_camera_keys_mark_dirty_and_move():
    v = viewer()
    v.step()
    pos0 = v.state.config.cam_position
    v.handle_key("w")
    assert v.state.config.cam_position != pos0
    v.step()
    assert v.state.samples == 1  # accumulation restarted after the move


def test_mode_toggles():
    v = viewer()
    assert v.state.config.nee == NextEventEstimation.NONE
    v.handle_key("n")
    assert v.state.config.nee == NextEventEstimation.MIS
    t0 = v.tonemap
    v.handle_key("t")
    assert v.tonemap != t0
    v.handle_key("x")
    assert v.settings.denoise


def test_escape_quits():
    v = viewer()
    assert not v.handle_key("escape")
    assert not v._running


def test_speed_modifiers():
    """shift = 10x, ctrl = 0.1x (reference: src/app.rs:439-492)."""
    v = viewer()
    steps = []
    for key in ("w", "shift+w", "ctrl+w", "W"):
        z = v.state.config.cam_position[2]
        v.handle_key(key)
        steps.append(v.state.config.cam_position[2] - z)
    plain, fast, slow, upper = steps
    assert np.isclose(fast, 10 * plain) and np.isclose(slow, 0.1 * plain)
    assert np.isclose(upper, 10 * plain)  # matplotlib's bare uppercase letter


def test_sun_controls():
    v = viewer()
    sun0 = np.asarray(v.state.config.sun_direction)
    v.handle_key("l")
    sun1 = np.asarray(v.state.config.sun_direction)
    assert not np.allclose(sun1[:3], sun0[:3])
    assert np.isclose(np.linalg.norm(sun1[:3]), 1.0, atol=1e-6)
    assert sun1[3] == sun0[3]
    v.handle_key("=")
    assert v.state.config.sun_direction[3] > sun1[3]
    for _ in range(40):
        v.handle_key("-")
    assert v.state.config.sun_direction[3] >= 0.0
    for _ in range(40):  # the elevation stops short of the pole
        v.handle_key("i")
    assert np.isclose(v.state.config.sun_direction[1], np.sin(1.55))


def test_mouse_drag_look_matches_jax():
    v, jv = viewer(), jax_viewer()
    rot0 = v.state.config.cam_rotation
    for view in (v, jv):
        view.on_mouse_press(100.0, 100.0)
        assert view.state.interacting
        view.on_mouse_move(120.0, 90.0)
    pitch, yaw = v.state.config.cam_rotation
    assert yaw > rot0[1] and pitch < rot0[0]
    assert v.state.config.cam_rotation == jv.state.config.cam_rotation
    v.step()
    assert v.state.samples == 1  # interacting: every step restarts
    v.step()
    assert v.state.samples == 1
    v.on_mouse_release()
    assert not v.state.interacting
    rot1 = v.state.config.cam_rotation
    v.on_mouse_move(500.0, 500.0)  # motion without a press is ignored
    assert v.state.config.cam_rotation == rot1


def write_lamp_quad(path):
    """A floor quad under an emissive quad: a two-material scene of 4
    triangles."""
    from rustic_tpu_torch.scene.glb_write import MaterialSpec, MeshSpec, write_glb

    quad = np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    write_glb(path, meshes=[MeshSpec(positions=quad, indices=tris, material=0),
                            MeshSpec(positions=(quad * 0.2 + [0, 2, 0]).astype(np.float32), indices=tris[:, ::-1],
                                     material=1)],
              materials=[MaterialSpec(base_color=(0.7, 0.7, 0.7, 1.0)),
                         MaterialSpec(base_color=(0, 0, 0, 1.0), emissive=(5.0, 5.0, 5.0))])


def test_load_path_switches_scene_and_skybox(tmp_path):
    """Runtime scene/skybox switching (reference: src/app.rs:617-624, image
    detection :44-52); what the loaders refuse leaves the viewer as it was."""
    world = World.from_path(scene_path("DarkCornell.glb"))
    v = Viewer(world.to_torch("cpu"), TracingConfig(width=8, height=8, max_bounces=2),
               RenderSettings(sync_rate=1), world=world)
    v.step()
    old_scene = v.scene
    lamp = os.path.join(tmp_path, "lamp.glb")
    write_lamp_quad(lamp)
    assert v.load_path(lamp)
    assert v.scene is not old_scene and v.scene.device.type == "cpu"
    assert v.world.triangles.shape[0] == 4 and v.scene.n_tris == 4
    frame = v.step()
    assert np.isfinite(frame).all() and v.state.samples == 1

    sky = np.full((4, 8, 3), 0.25, np.float32)
    p = os.path.join(tmp_path, "sky.npy")
    np.save(p, sky)
    scene_before = v.scene
    assert v.load_path(p)
    assert v.state.config.has_skybox and v.scene is not scene_before
    assert v.skybox.shape == (4, 8, 4)
    np.testing.assert_array_equal(v.scene.skybox.numpy()[..., :3], sky)
    assert np.isfinite(v.step()).all()

    loaded = v.scene
    assert not v.load_path(os.path.join(tmp_path, "missing.glb"))
    bad = os.path.join(tmp_path, "bad.glb")
    with open(bad, "wb") as f:
        f.write(b"not a glb file")
    jpg = os.path.join(tmp_path, "sky.jpg")
    with open(jpg, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0" + bytes(16))
    for path in (bad, jpg):
        assert not v.load_path(path)
        assert v.scene is loaded


def test_backend_toggle_preserves_film():
    """'c' flips compute between the scene's device and a CPU copy of the
    scene with sum = mean * samples carried over (reference:
    src/app.rs:324-346, src/trace.rs:162-164)."""
    v = viewer()
    v.step()
    v.step()
    frame = v.state.framebuffer.copy()
    samples = v.state.samples
    v.handle_key("c")
    assert v.settings.backend == "cpu" and v.state.samples == samples
    np.testing.assert_allclose(v.state.framebuffer, frame, rtol=1e-6)
    np.testing.assert_allclose(v.state._film_sum.numpy().reshape(16, 16, 3), frame * samples,
                               rtol=1e-6)
    cpu_scene = v.active_scene()
    assert cpu_scene is not v.scene and cpu_scene.device.type == "cpu"
    f2 = v.step()
    assert v.state.samples == samples + 1 and np.isfinite(f2).all()
    assert v.active_scene() is cpu_scene  # made once
    v.handle_key("c")
    assert v.settings.backend == "auto" and v.active_scene() is v.scene
    v.step()
    assert v.state.samples == samples + 2


@pytest.mark.parametrize("op", list(Tonemapping))
def test_display_frame_matches_jax(op):
    v, jv = viewer(), jax_viewer()
    rng = np.random.default_rng(int(op))
    film = np.exp(rng.normal(-1.0, 1.5, (16, 16, 3))).astype(np.float32)
    v.state.framebuffer = jv.state.framebuffer = film
    v.tonemap = jv.tonemap = op
    got = v.display_frame()
    np.testing.assert_array_equal(got, apply_tonemap(torch.from_numpy(film), op).numpy())
    np.testing.assert_allclose(got, jv.display_frame(), rtol=1e-6, atol=1e-6)


def test_p_key_saves_a_png(tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.chdir(tmp_path)
    v = viewer()
    v.step()
    assert v.handle_key("p")
    assert Image.open(os.path.join(tmp_path, "viewer_capture.png")).size == (16, 16)
