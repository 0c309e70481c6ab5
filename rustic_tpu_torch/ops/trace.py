"""Camera rays (twin of rustic_tpu/ops/trace.py:camera_rays)."""

from __future__ import annotations

import torch

from rustic_tpu_torch.config import CameraParams, StaticConfig
from rustic_tpu_torch.ops import sampling as s
from rustic_tpu_torch.ops.rng import lds


def camera_rays(
    cfg: StaticConfig,
    cam: CameraParams,
    px: torch.Tensor,
    py: torch.Tensor,
    sample_idx: torch.Tensor,
    offsets: torch.Tensor,
):
    """Jittered pinhole camera rays (reference: kernels/src/lib.rs:38-51)
    -> (ro [B, 3], rd [B, 3])."""
    jx = lds(sample_idx, 1, offsets)
    jy = lds(sample_idx, 2, offsets)
    sx = px.to(torch.float32) + jx
    sy = py.to(torch.float32) + jy
    u = (sx * s.inv(cfg.width)) * 2.0 - 1.0
    v = ((1.0 - sy * s.inv(cfg.height)) * 2.0 - 1.0) * (cfg.height / cfg.width)

    rd = s.normalize(torch.stack([u, v, torch.ones_like(u)], dim=-1))
    pitch, yaw = cam.cam_rotation[0], cam.cam_rotation[1]
    cx, sx_ = torch.cos(pitch), torch.sin(pitch)
    cy, sy_ = torch.cos(yaw), torch.sin(yaw)
    # Ry(yaw) @ Rx(pitch), applied to rd (reference: kernels/src/lib.rs:50-51)
    x, y, z = rd[..., 0], rd[..., 1], rd[..., 2]
    y, z = cx * y - sx_ * z, sx_ * y + cx * z
    x, z = cy * x + sy_ * z, -sy_ * x + cy * z
    rd = torch.stack([x, y, z], dim=-1)
    ro = cam.cam_position.expand(rd.shape)
    return ro, rd
