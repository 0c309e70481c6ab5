"""Runtime configuration: twins of rustic_tpu/config.py.

`TracingConfig` is the host-side description of a render; its
`static_part` selects the code path and its `dynamic_part` is the
camera and light state as tensors on a device.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

import torch


class NextEventEstimation(enum.IntEnum):
    """Next-event-estimation mode (reference: shared_structs/src/lib.rs:193-236)."""

    NONE = 0
    MIS = 1  # NEE with multiple importance sampling
    DIRECT = 2  # NEE without MIS weighting

    @property
    def uses_nee(self) -> bool:
        return self != NextEventEstimation.NONE

    @property
    def uses_mis(self) -> bool:
        return self == NextEventEstimation.MIS


class Tonemapping(enum.IntEnum):
    """Display tonemap operators (reference: src/app.rs:18-42, render.wgsl:36-117)."""

    NONE = 0
    REINHARD = 1
    ACES_NARKOWICZ = 2  # x0.6 pre-exposure (render.wgsl:136)
    ACES_NARKOWICZ_OVEREXPOSED = 3  # no pre-exposure (render.wgsl:139-140)
    ACES_HILL = 4
    NEUTRAL = 5
    UNCHARTED2 = 6


def _default_sun() -> Tuple[float, float, float, float]:
    # normalize(0.5, 1.3, 1.0) with w = intensity 15
    n = math.sqrt(0.5 * 0.5 + 1.3 * 1.3 + 1.0 * 1.0)
    return (0.5 / n, 1.3 / n, 1.0 / n, 15.0)


@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """The subset of the config that selects the code path."""

    width: int
    height: int
    min_bounces: int
    max_bounces: int
    nee: NextEventEstimation
    has_skybox: bool


@dataclasses.dataclass
class CameraParams:
    """Camera, sun and specular clamp as f32 tensors on one device."""

    cam_position: torch.Tensor  # [3]
    cam_rotation: torch.Tensor  # [2] (pitch, yaw)
    sun_direction: torch.Tensor  # [4] xyz dir, w intensity
    specular_weight_clamp: torch.Tensor  # [2] lo, hi


@dataclasses.dataclass(frozen=True)
class TracingConfig:
    """Full render configuration; defaults match rustic_tpu.config."""

    width: int = 1280
    height: int = 720
    min_bounces: int = 3
    max_bounces: int = 4
    nee: NextEventEstimation = NextEventEstimation.NONE
    has_skybox: bool = False  # True => HDR equirect image, False => procedural sky
    cam_position: Tuple[float, float, float] = (0.0, 1.0, -5.0)
    cam_rotation: Tuple[float, float] = (0.0, 0.0)  # (pitch x, yaw y) radians
    sun_direction: Tuple[float, float, float, float] = dataclasses.field(
        default_factory=_default_sun
    )
    specular_weight_clamp: Tuple[float, float] = (0.1, 0.9)

    def static_part(self) -> StaticConfig:
        return StaticConfig(
            width=self.width,
            height=self.height,
            min_bounces=self.min_bounces,
            max_bounces=self.max_bounces,
            nee=NextEventEstimation(self.nee),
            has_skybox=bool(self.has_skybox),
        )

    def dynamic_part(self, device) -> CameraParams:
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return CameraParams(
            cam_position=f32(self.cam_position),
            cam_rotation=f32(self.cam_rotation),
            sun_direction=f32(self.sun_direction),
            specular_weight_clamp=f32(self.specular_weight_clamp),
        )


@dataclasses.dataclass
class RenderSettings:
    """Knobs of a synchronous render (the subset of
    rustic_tpu.config.RenderSettings that render_image reads)."""

    samples: int = 32
    # Pixel-seed mode: False hashes the pixel id (the default), True
    # tiles the committed blue-noise rank table.
    use_blue_noise: bool = False
    batch_pixels: int = 1 << 20  # wavefront megabatch size (pixels per chunk)
    # the loop a multi-tile scene takes (runtime/pipeline.py MULTITILE_LOOPS):
    # "kernel-shade", the reference loops "ray-sorted" and "unsorted",
    # "fused" (one launch of K17 a bounce, K10's scan and the shading in one
    # kernel; untextured scenes under the procedural sky, ValueError on any
    # other), "state-sorted" (the whole state re-sorted and compacted after
    # each bounce) or "auto" (state-sorted or kernel-shade, by a pilot)
    multitile_loop: str = "kernel-shade"
    # the form of the multi-tile scans (ops/intersect.py MULTITILE_SCANS, whose
    # first is this default): "grid" (K9-K11, culling in the kernel), "lists"
    # (tile lists, then K5-K7) or "resident" (K14-K16, the triangle table held
    # in a thread-block cluster's shared memory; a scene that does not fit
    # there is refused)
    multitile_scan: str = "grid"
    # the loop a one-tile scene takes (runtime/pipeline.py SINGLE_TILE_LOOPS):
    # "kernel-shade" where the shade kernel takes the scene (untextured, an
    # alias table of at most 16 entries) and the torch-shade loop elsewhere,
    # "torch-shade" for every one-tile scene, or "fused" (one launch of K17
    # a bounce in place of a scan and a shade launch; untextured scenes under
    # the procedural sky, ValueError on any other)
    single_tile_loop: str = "kernel-shade"
    # the display operator of image output (ops/tonemap.py, utils/image_io.py)
    tonemap: Tonemapping = Tonemapping.NONE
