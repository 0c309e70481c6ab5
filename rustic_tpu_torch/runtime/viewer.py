"""Interactive progressive viewer (twin of rustic_tpu/runtime/viewer.py).

The control logic is display-free and driven by `handle_key`, the mouse
callbacks, `load_path` and `step`; `run()` puts it in a matplotlib window
(matplotlib is imported there, and only there):

- progressive accumulation republished every sync_rate samples,
- WASD + QE fly camera (shift = 10x, ctrl = 0.1x speed), arrow-key look
  and mouse-drag look (reference: src/app.rs:439-492),
- sun controls j/l (azimuth), i/k (elevation), =/- (intensity)
  (reference: src/app.rs:365-437),
- keys for NEE mode (n), tonemap cycling (t), denoise (x), save (p),
- runtime scene/skybox switching: `load_path` (drag-drop onto the window
  with TkAgg + tkinterdnd2), 'o' (open scene) and 'u' (load skybox)
  terminal prompts (reference: src/app.rs:617-624, :44-52),
- 'c' toggles compute between the scene's device and a CPU copy of the
  scene, the accumulated film preserved (reference: src/app.rs:324-346,
  src/trace.rs:162-164),
- camera moves mark the state dirty and restart accumulation
  (reference: src/trace.rs:216-222).

Run: python -m rustic_tpu_torch.cli render <scene.glb> --interactive
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional

import numpy as np
import torch

from rustic_tpu_torch.config import (
    NextEventEstimation,
    RenderSettings,
    Tonemapping,
    TracingConfig,
)
from rustic_tpu_torch.ops.tonemap import apply_tonemap
from rustic_tpu_torch.runtime.state import TracingState

_MOVE_SPEED = 0.3  # reference: src/app.rs speed with shift/ctrl modifiers
_TURN_SPEED = 0.05
_MOUSE_SENS = 0.005  # radians per pixel of drag

# the reference detects dropped images by extension (src/app.rs:44-52)
_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".hdr", ".exr", ".tga", ".bmp", ".npy")


class Viewer:
    def __init__(
        self,
        scene,
        config: TracingConfig,
        settings: Optional[RenderSettings] = None,
        world=None,
        skybox: Optional[np.ndarray] = None,
    ):
        self.scene = scene
        self.world = world  # host-side World, kept for runtime switching
        self.skybox = skybox  # loaded skybox image (np array) or None
        self.settings = settings or RenderSettings(sync_rate=4)
        self.state = TracingState(config.width, config.height, config, self.settings)
        self.tonemap = self.settings.tonemap
        self._running = True
        self._drag = None  # (x, y) of the last mouse-drag position
        self._scene_cpu = None  # CPU copy of the scene for the 'c' toggle

    # -- camera (reference: src/app.rs:439-492) -----------------------------

    def _move(self, forward=0.0, right=0.0, up=0.0, speed_scale=1.0):
        cfg = self.state.config
        pitch, yaw = cfg.cam_rotation
        # camera looks along Ry(yaw)Rx(pitch) @ +z
        fwd = (
            math.sin(yaw) * math.cos(pitch),
            -math.sin(pitch),
            math.cos(yaw) * math.cos(pitch),
        )
        rgt = (math.cos(yaw), 0.0, -math.sin(yaw))
        step = _MOVE_SPEED * speed_scale
        pos = tuple(
            p + step * (forward * f + right * r)
            for p, f, r in zip(cfg.cam_position, fwd, rgt)
        )
        pos = (pos[0], pos[1] + step * up, pos[2])
        self.state.set_config(cam_position=pos)

    def _orbit_sun(self, dazimuth=0.0, delevation=0.0, dintensity=0.0):
        """Sun controls (reference: src/app.rs:365-437, the environment
        GUI's intensity slider and sun-position disc)."""
        x, y, z, intensity = self.state.config.sun_direction
        r = max(math.sqrt(x * x + y * y + z * z), 1e-6)
        azimuth = math.atan2(z, x) + dazimuth
        elevation = math.asin(max(-1.0, min(1.0, y / r))) + delevation
        elevation = max(-1.55, min(1.55, elevation))
        intensity = max(0.0, intensity * (1.0 + dintensity))
        self.state.set_config(
            sun_direction=(
                math.cos(elevation) * math.cos(azimuth),
                math.sin(elevation),
                math.cos(elevation) * math.sin(azimuth),
                intensity,
            )
        )

    def _turn(self, dpitch=0.0, dyaw=0.0):
        cfg = self.state.config
        self.state.set_config(
            cam_rotation=(
                cfg.cam_rotation[0] + dpitch * _TURN_SPEED,
                cfg.cam_rotation[1] + dyaw * _TURN_SPEED,
            )
        )

    def handle_key(self, key: str) -> bool:
        """Apply one key action; returns False when the viewer should quit.
        shift+<move> = 10x speed, ctrl+<move> = 0.1x."""
        speed = 1.0
        while "+" in key and key.split("+", 1)[0] in ("shift", "ctrl"):
            mod, key = key.split("+", 1)
            speed *= 10.0 if mod == "shift" else 0.1
        if len(key) == 1 and key.isalpha() and key.isupper():
            # matplotlib delivers shift+letter as the bare uppercase letter
            speed *= 10.0
            key = key.lower()
        actions = {
            "w": lambda: self._move(forward=1, speed_scale=speed),
            "s": lambda: self._move(forward=-1, speed_scale=speed),
            "a": lambda: self._move(right=-1, speed_scale=speed),
            "d": lambda: self._move(right=1, speed_scale=speed),
            "q": lambda: self._move(up=-1, speed_scale=speed),
            "e": lambda: self._move(up=1, speed_scale=speed),
            "up": lambda: self._turn(dpitch=-1),
            "down": lambda: self._turn(dpitch=1),
            "left": lambda: self._turn(dyaw=-1),
            "right": lambda: self._turn(dyaw=1),
            "j": lambda: self._orbit_sun(dazimuth=-0.1),
            "l": lambda: self._orbit_sun(dazimuth=0.1),
            "i": lambda: self._orbit_sun(delevation=0.1),
            "k": lambda: self._orbit_sun(delevation=-0.1),
            "=": lambda: self._orbit_sun(dintensity=0.25),
            "-": lambda: self._orbit_sun(dintensity=-0.2),
        }
        if key in actions:
            actions[key]()
            return True
        if key == "o":  # open scene
            self._prompt_load("scene path (.glb/.gltf/.obj/.fbx/.stl/.ply): ")
        elif key == "u":  # load skybox image
            self._prompt_load("skybox image path (.hdr/.png/.npy): ")
        elif key == "c":  # device <-> CPU switch, film preserved
            self.toggle_backend()
        elif key == "n":  # cycle NEE mode
            cfg = self.state.config
            self.state.set_config(nee=NextEventEstimation((int(cfg.nee) + 1) % 3))
        elif key == "t":  # cycle tonemap operator
            self.tonemap = Tonemapping((int(self.tonemap) + 1) % len(Tonemapping))
        elif key == "x":  # toggle denoise
            self.settings.denoise = not self.settings.denoise
        elif key == "p":  # save PNG
            from rustic_tpu_torch.utils.image_io import save_png

            save_png("viewer_capture.png", self.state.framebuffer, self.tonemap)
        elif key == "escape":
            self._running = False
            return False
        return True

    # -- runtime scene/skybox switching (reference: src/app.rs:617-624) ------

    def _prompt_load(self, prompt: str):
        """Terminal-prompt analog of the reference's file pickers; empty
        input cancels."""
        try:
            path = input(prompt).strip().strip("'\"")
        except (EOFError, OSError):
            return
        if path:
            self.load_path(path)

    def load_path(self, path: str) -> bool:
        """Load a dropped or picked file: an image becomes the skybox, any
        mesh format the new scene, uploaded to the viewer's device.
        Accumulation restarts; camera and settings persist. A file that
        is missing or that the loaders refuse is reported and leaves the
        viewer as it was (returns False)."""
        from rustic_tpu_torch.scene.world import World, load_skybox_image

        path = path.strip().strip("'\"")
        if not os.path.exists(path):
            print(f"[viewer] no such file: {path}")
            return False
        try:
            if path.lower().endswith(_IMAGE_EXTS):
                skybox = load_skybox_image(path)
                if self.world is not None:
                    self.scene = self.world.to_torch(self.scene.device, skybox)
                self.skybox = skybox
                self.state.set_config(has_skybox=True)
            else:
                world = World.from_path(path)
                self.scene = world.to_torch(self.scene.device, self.skybox)
                self.world = world
                self.state.mark_dirty()
        except (OSError, ValueError, NotImplementedError) as e:
            print(f"[viewer] load failed: {e}")
            return False
        self._scene_cpu = None  # the CPU copy is stale
        return True

    # -- device <-> CPU switch (reference: src/app.rs:324-346) ---------------

    def active_scene(self):
        """The scene a step renders: the viewer's, or under
        backend="cpu" its CPU copy (made once, dropped on a load)."""
        if self.settings.backend != "cpu":
            return self.scene
        if self._scene_cpu is None:
            self._scene_cpu = self.scene.to("cpu")
        return self._scene_cpu

    def toggle_backend(self):
        """Flip compute between the scene's device and the host; the
        accumulated film and sample count carry over (the reference's
        continue_previous restore, src/trace.rs:162-164)."""
        self.settings.backend = "auto" if self.settings.backend == "cpu" else "cpu"
        # restore (not reset): sum = mean * samples survives the switch
        self.state.restore(self.state.framebuffer, self.state.samples)

    # -- mouse-drag look (reference: src/app.rs:439-492) ---------------------

    def on_mouse_press(self, x: float, y: float):
        self._drag = (x, y)
        self.state.interacting = True

    def on_mouse_move(self, x: float, y: float):
        if self._drag is None:
            return
        dx, dy = x - self._drag[0], y - self._drag[1]
        self._drag = (x, y)
        cfg = self.state.config
        # matplotlib y grows upward in figure coords; dragging right turns
        # right, dragging up looks up (reference sign convention)
        self.state.set_config(
            cam_rotation=(
                cfg.cam_rotation[0] + dy * _MOUSE_SENS,
                cfg.cam_rotation[1] + dx * _MOUSE_SENS,
            )
        )

    def on_mouse_release(self):
        self._drag = None
        self.state.interacting = False

    def display_frame(self) -> np.ndarray:
        frame = torch.from_numpy(np.ascontiguousarray(self.state.framebuffer, np.float32))
        return apply_tonemap(frame, self.tonemap).numpy()

    def step(self) -> np.ndarray:
        self.state.step(self.active_scene())
        return self.display_frame()

    def _try_enable_dnd(self, fig):
        """Native drag-drop where the backend has it (TkAgg + the tkdnd
        extension); the 'o'/'u' prompts remain the portable path."""
        try:
            from tkinterdnd2 import DND_FILES  # optional dependency

            widget = fig.canvas.get_tk_widget()
        except (ImportError, AttributeError):
            return  # no tkdnd, or a backend without a Tk widget
        widget.drop_target_register(DND_FILES)
        widget.dnd_bind("<<Drop>>", lambda e: self.load_path(e.data.strip("{}")))

    # -- matplotlib event loop ----------------------------------------------

    def run(self):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 6))
        fig.canvas.manager.set_window_title("rustic_tpu_torch")
        im = ax.imshow(self.display_frame())
        ax.axis("off")
        status = ax.set_title("starting...")

        def on_key(event):
            if not self.handle_key(event.key or ""):
                plt.close(fig)

        fig.canvas.mpl_connect("key_press_event", on_key)
        fig.canvas.mpl_connect("button_press_event", lambda e: self.on_mouse_press(e.x, e.y))
        fig.canvas.mpl_connect("motion_notify_event", lambda e: self.on_mouse_move(e.x, e.y))
        fig.canvas.mpl_connect("button_release_event", lambda e: self.on_mouse_release())
        self._try_enable_dnd(fig)
        plt.ion()
        plt.show()
        t0 = time.time()
        while self._running and plt.fignum_exists(fig.number):
            frame = self.step()
            im.set_data(frame)
            status.set_text(
                f"{self.state.samples} spp | "
                f"{self.state.samples / max(time.time() - t0, 1e-9):.1f} spp/s | "
                f"nee={NextEventEstimation(self.state.config.nee).name} "
                f"tonemap={Tonemapping(self.tonemap).name}"
            )
            fig.canvas.draw_idle()
            fig.canvas.flush_events()
        plt.ioff()
