"""Vectorised sampling and shading math (twins of rustic_tpu/ops/sampling.py;
the kernel-shade stage has its own per-component versions,
ops/shade_kernel.py).

Vectors are [..., 3] tensors. The operation order matches the JAX
versions, so both round alike.

A division by a constant is written as a multiply by the constant's f32
reciprocal (`inv`): that is how XLA compiles `x / c`, and it rounds the
same in torch on every device (torch on CUDA turns a division by a
Python scalar into a reciprocal multiply of its own, in opmath). A
constant divided by a tensor is a true division (`rdiv`).
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


def rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x with a true division."""
    return torch.full_like(x, c) / x


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # ((a0b0 + a1b1) + a2b2), the association of the JAX version
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def dotk(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product, keepdims."""
    return dot(a, b)[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(v, v))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v * torch.reciprocal(torch.clamp(length(v), min=eps))[..., None]


def lerp(a, b, t):
    return a * (1.0 - t) + b * t


def cosine_sample_hemisphere(r1, r2):
    """Cosine-weighted y-up local hemisphere (reference: kernels/src/util.rs:24-32)."""
    cos_theta = torch.sqrt(torch.clamp(r1, min=0.0))
    sin_theta = torch.sqrt(torch.clamp(1.0 - r1, min=0.0))
    phi = 2.0 * PI * r2
    return torch.stack(
        [sin_theta * torch.cos(phi), cos_theta, sin_theta * torch.sin(phi)], dim=-1
    )


def create_cartesian(up):
    """Orthonormal basis about `up` -> (up, right, forward), with the
    reference's fixed arbitrary vector (reference: kernels/src/util.rs:34-40)."""
    ax, ay, az = 0.1, 0.5, 0.9
    ux, uy, uz = up[..., 0], up[..., 1], up[..., 2]
    temp = normalize(
        torch.stack([uy * az - uz * ay, uz * ax - ux * az, ux * ay - uy * ax], dim=-1)
    )
    right = normalize(cross(temp, up))
    forward = normalize(cross(up, right))
    return up, right, forward


def local_to_world(local, up, right, forward):
    """A y-up local sample in the (up, right, forward) frame: x -> forward,
    y -> up, z -> right (reference: kernels/src/bsdf.rs:76-80)."""
    return normalize(
        local[..., 0:1] * forward + local[..., 1:2] * up + local[..., 2:3] * right
    )


def reflect(i, n):
    """Mirror reflection of `i` about `n` (reference: kernels/src/util.rs:42-44)."""
    return i - n * 2.0 * dotk(i, n)


def refract(i, n, in_ior, out_ior):
    """Snell refraction; the zero vector on total internal reflection
    (reference: kernels/src/util.rs:47-56)."""
    eta = in_ior / out_ior
    n_dot_i = dotk(n, i)
    k = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    refr = eta * i - (eta * n_dot_i + torch.sqrt(torch.clamp(k, min=0.0))) * n
    return torch.where(k < 0.0, 0.0, refr)


def ggx_distribution(n, h, roughness):
    """GGX NDF with alpha = roughness^2 (reference: kernels/src/util.rs:58-64)."""
    a2 = roughness * roughness
    n_dot_h = torch.clamp(dot(n, h), min=0.0)
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    denom = torch.clamp(PI * denom * denom, min=EPS)
    return a2 / denom


def sample_ggx(r1, r2, reflection_direction, roughness):
    """Karis GGX sampling about the reflection direction
    (reference: kernels/src/util.rs:67-85)."""
    a = roughness * roughness
    phi = 2.0 * PI * r1
    cos_theta = torch.sqrt(
        torch.clamp((1.0 - r2) / (r2 * (a * a - 1.0) + 1.0), min=0.0)
    )
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    h_local = torch.stack(
        [torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta], dim=-1
    )
    take_z = reflection_direction[..., 2].abs() < 0.999
    zero = torch.zeros_like(r1)
    up = torch.stack(
        [torch.where(take_z, 0.0, 1.0), zero, torch.where(take_z, 1.0, 0.0)], dim=-1
    )
    tangent = normalize(cross(up, reflection_direction))
    bitangent = cross(reflection_direction, tangent)
    return normalize(
        tangent * h_local[..., 0:1]
        + bitangent * h_local[..., 1:2]
        + reflection_direction * h_local[..., 2:3]
    )


def sample_ggx_microsurface_normal(r1, r2, macro_normal, roughness):
    """Walter-style GGX microfacet-normal sampling for dielectrics
    (reference: kernels/src/util.rs:117-139)."""
    a_g = roughness * roughness
    theta_m = torch.atan(
        (a_g * torch.sqrt(r1)) / torch.sqrt(torch.clamp(1.0 - r1, min=1e-20))
    )
    phi_m = 2.0 * PI * r2
    m_local = torch.stack(
        [
            torch.sin(theta_m) * torch.cos(phi_m),
            torch.cos(theta_m),
            torch.sin(theta_m) * torch.sin(phi_m),
        ],
        dim=-1,
    )
    up, right, forward = create_cartesian(macro_normal)
    return local_to_world(m_local, up, right, forward)


def geometry_schlick_ggx(n, v, roughness):
    """Schlick-GGX masking term (reference: kernels/src/util.rs:211-216)."""
    n_dot_v = torch.clamp(dot(n, v), min=0.0)
    r = (roughness * roughness) * inv(8.0)
    return n_dot_v / (n_dot_v * (1.0 - r) + r)


def geometry_smith_schlick_ggx(n, v, l, roughness):
    """Smith geometry via Schlick-GGX (reference: kernels/src/util.rs:219-227)."""
    return geometry_schlick_ggx(n, v, roughness) * geometry_schlick_ggx(n, l, roughness)


def _pow5(x):
    # lax.integer_pow's square-and-multiply order
    x2 = x * x
    return x * (x2 * x2)


def clip(x, lo, hi):
    """jnp.clip: min(max(x, lo), hi), NaN-propagating."""
    return torch.minimum(torch.maximum(x, lo), hi)


def fresnel_schlick(cos_theta, f0):
    """Schlick fresnel, vector f0 (reference: kernels/src/util.rs:229-231)."""
    ct = torch.clamp(torch.clamp(cos_theta, min=0.0), max=1.0)
    return f0 + (1.0 - f0) * _pow5(1.0 - ct[..., None])


def fresnel_schlick_scalar(in_ior, out_ior, cos_theta):
    """Schlick fresnel, scalar ior pair (reference: kernels/src/util.rs:233-236)."""
    q = (in_ior - out_ior) / (in_ior + out_ior)
    f0 = q * q
    ct = torch.clamp(torch.clamp(cos_theta, min=0.0), max=1.0)
    return f0 + (1.0 - f0) * _pow5(1.0 - ct)


def power_heuristic(p1, p2):
    """Power heuristic MIS weight (reference: kernels/src/util.rs:253-256)."""
    p1_2 = p1 * p1
    return p1_2 / torch.clamp(p1_2 + p2 * p2, min=1e-20)


def expand_mask(m: torch.Tensor) -> torch.Tensor:
    """[...] bool -> [..., 1] bool."""
    return m[..., None]


def mask_nan(v: torch.Tensor) -> torch.Tensor:
    """Zero a vector with any non-finite component (reference:
    kernels/src/util.rs:271-277)."""
    f = torch.isfinite(v)
    finite = f[..., 0] & f[..., 1] & f[..., 2]
    return torch.where(expand_mask(finite), v, 0.0)
