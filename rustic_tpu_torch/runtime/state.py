"""Progressive tracing state (twin of rustic_tpu/runtime/state.py): a mean
framebuffer published after every sync_rate samples, dirty and
interacting flags that restart the accumulation, config edits that take
effect at the next step, and accumulation that survives a device switch
(sum = mean * samples, the reference's continue_previous restore).

The film sum is a float32 tensor on the device of the last render;
`step` moves it to the device it renders on (the scene's, or the host's
under RenderSettings.backend="cpu") before the render, and the published
frame is a numpy array. `Checkpoint` writes the JAX package's `.npz`: a
checkpoint of either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

import numpy as np
import torch

from rustic_tpu_torch.config import RenderSettings, TracingConfig
from rustic_tpu_torch.runtime.render import pixel_offsets, render_pixels


def _pixel_grid(w: int, h: int):
    y, x = np.mgrid[0:h, 0:w]
    return x.reshape(-1).astype(np.int32), y.reshape(-1).astype(np.int32)


class TracingState:
    def __init__(
        self,
        width: int,
        height: int,
        config: Optional[TracingConfig] = None,
        settings: Optional[RenderSettings] = None,
    ):
        self.config = (config or TracingConfig()).replace(width=width, height=height)
        self.settings = settings or RenderSettings()
        self.samples = 0
        self.running = False
        self.interacting = False
        self._dirty = False
        self._lock = threading.Lock()
        self._px, self._py = _pixel_grid(width, height)
        self._offsets = pixel_offsets(width, height, self.settings.use_blue_noise)
        self._film_sum = torch.zeros((width * height, 3), dtype=torch.float32)
        self.framebuffer = np.zeros((height, width, 3), np.float32)  # published mean

    # -- control ------------------------------------------------------------

    def mark_dirty(self):
        """Config changed: reset accumulation at the next step boundary
        (reference: the `dirty` atomic, src/trace.rs:216-222)."""
        self._dirty = True

    def set_config(self, **updates):
        with self._lock:
            self.config = self.config.replace(**updates)
        self.mark_dirty()

    def restore(self, framebuffer: np.ndarray, samples: int):
        """Continue a previous accumulation (device switch / resume):
        sum = mean * samples (reference: src/trace.rs:162-164)."""
        mean = framebuffer.reshape(-1, 3).astype(np.float32)
        self._film_sum = torch.from_numpy(mean * float(samples)).to(self._film_sum.device)
        self.samples = samples
        self.framebuffer = framebuffer.copy()

    def stop(self):
        self.running = False

    def reset(self):
        self.samples = 0
        w, h = self.config.width, self.config.height
        if w * h != len(self._px):
            # resolution changed via set_config: rebuild the pixel set
            self._px, self._py = _pixel_grid(w, h)
            self._film_sum = torch.zeros((w * h, 3), dtype=torch.float32,
                                         device=self._film_sum.device)
            self.framebuffer = np.zeros((h, w, 3), np.float32)
        else:
            self._film_sum = torch.zeros_like(self._film_sum)
        self._offsets = pixel_offsets(w, h, self.settings.use_blue_noise)
        self._dirty = False

    # -- stepping -----------------------------------------------------------

    def step(self, scene, n_samples: Optional[int] = None) -> np.ndarray:
        """Fold n_samples (default sync_rate) into the accumulator and
        publish the mean framebuffer. Returns the published frame."""
        if self._dirty or self.interacting:
            self.reset()
        n = n_samples if n_samples is not None else self.settings.sync_rate
        with self._lock:
            config = self.config
        device = torch.device("cpu") if self.settings.backend == "cpu" else scene.device
        self._film_sum = render_pixels(
            scene,
            config,
            self._px,
            self._py,
            n,
            offsets=self._offsets,
            sample_start=self.samples,
            engine=self.settings.engine,
            film_in=self._film_sum.to(device),
            backend=self.settings.backend,
        )
        self.samples += n
        mean = self._film_sum.cpu().numpy() / max(self.samples, 1)
        frame = mean.reshape(config.height, config.width, 3)
        if self.settings.denoise:
            from rustic_tpu_torch.runtime.denoise import denoise

            frame = denoise(frame, device=self._film_sum.device)
        self.framebuffer = frame
        return frame

    def run(
        self,
        scene,
        target_samples: Optional[int] = None,
        on_frame: Optional[Callable[[np.ndarray, int], None]] = None,
    ) -> np.ndarray:
        """Loop step() until target_samples (or stop()). The synchronous
        analog of the reference's setup_trace watcher
        (src/trace.rs:331-344)."""
        self.running = True
        while self.running:
            if target_samples is not None:
                remaining = target_samples - self.samples
                if remaining <= 0:
                    break
                n = min(self.settings.sync_rate, remaining)
            else:
                n = self.settings.sync_rate
            frame = self.step(scene, n)
            if on_frame is not None:
                on_frame(frame, self.samples)
        self.running = False
        return self.framebuffer


@dataclasses.dataclass
class Checkpoint:
    """On-disk render checkpoint: film sum + sample count + config, as the
    JAX package writes it (`config` a float64 vector in field order)."""

    film_sum: np.ndarray
    samples: int
    config: TracingConfig

    def save(self, path: str):
        # through a file object: np.savez appends '.npz' to a bare string
        # path, which would break the resume-path existence check
        with open(path, "wb") as f:
            np.savez_compressed(
                f,
                film_sum=self.film_sum,
                samples=self.samples,
                config=np.asarray(
                    [
                        self.config.width,
                        self.config.height,
                        self.config.min_bounces,
                        self.config.max_bounces,
                        int(self.config.nee),
                        int(self.config.has_skybox),
                        *self.config.cam_position,
                        *self.config.cam_rotation,
                        *self.config.sun_direction,
                        *self.config.specular_weight_clamp,
                    ],
                    np.float64,
                ),
            )

    @classmethod
    def load(cls, path: str) -> "Checkpoint":
        data = np.load(path)
        c = data["config"]
        config = TracingConfig(
            width=int(c[0]),
            height=int(c[1]),
            min_bounces=int(c[2]),
            max_bounces=int(c[3]),
            nee=int(c[4]),
            has_skybox=bool(c[5]),
            cam_position=tuple(c[6:9]),
            cam_rotation=tuple(c[9:11]),
            sun_direction=tuple(c[11:15]),
            specular_weight_clamp=tuple(c[15:17]),
        )
        return cls(film_sum=data["film_sum"], samples=int(data["samples"]), config=config)

    @classmethod
    def from_state(cls, state: TracingState) -> "Checkpoint":
        return cls(
            film_sum=state._film_sum.cpu().numpy().copy(),  # a snapshot
            samples=state.samples,
            config=state.config,
        )

    def into_state(self, settings: Optional[RenderSettings] = None) -> TracingState:
        state = TracingState(self.config.width, self.config.height, self.config, settings)
        # the stored sum itself: a mean round trip through restore() would
        # add float32 error to the accumulator
        film = np.asarray(self.film_sum, np.float32)
        state._film_sum = torch.from_numpy(film.reshape(-1, 3).copy())
        state.samples = int(self.samples)
        state.framebuffer = (film / max(int(self.samples), 1)).reshape(
            self.config.height, self.config.width, 3
        )
        return state
