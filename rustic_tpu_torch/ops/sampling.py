"""The sampling helpers the camera rays use (twins of rustic_tpu/ops/sampling.py;
the shade stage has its own per-component versions, ops/shade_kernel.py).

Vectors are [..., 3] tensors. The operation order matches the JAX
versions, so both round alike.

A division by a constant is written as a multiply by the constant's f32
reciprocal (`inv`): that is how XLA compiles `x / c`, and it rounds the
same in torch on every device (torch on CUDA turns a division by a
Python scalar into a reciprocal multiply of its own, in opmath).
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-3  # (reference: kernels/src/util.rs:5)
PI = math.pi


def inv(c: float) -> float:
    """The f32 reciprocal of a constant divisor (exact as a Python float)."""
    return float(np.float32(1.0) / np.float32(c))


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # ((a0b0 + a1b1) + a2b2), the association of the JAX version
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    length = torch.sqrt(dot(v, v))
    return v * torch.reciprocal(torch.clamp(length, min=eps))[..., None]

