"""Sky radiance (twin of rustic_tpu/ops/skybox.py): the single-scattering
procedural atmosphere and the HDR equirect image sky.

Vectors are [..., 3] tensors; the 12-step march is a Python loop over
whole-batch tensor ops.
"""

from __future__ import annotations

import torch

from rustic_tpu_torch.ops.sampling import PI, dot, inv, mask_nan, rdiv
from rustic_tpu_torch.ops.texture import sample_bilinear

# (reference: kernels/src/skybox.rs:8-16)
_RAY_COEFF = (58e-7, 135e-7, 331e-7)
_MIE_SCATTER = 2e-5
_MIE_EFFECTIVE = 2e-5 * 1.1
_EARTH_RADIUS = 6360e3
_ATMOSPHERE_RADIUS = 6380e3
_H_RAY = 8e3
_H_MIE = 12e2
_STEPS = 12  # reference: kernels/src/skybox.rs:80

def _escape(p, d, r):
    """Distance to the sphere of radius r about the earth centre
    (0, -R_earth, 0), -1 if none (reference: kernels/src/skybox.rs:18-32)."""
    vx = p[..., 0]
    vy = p[..., 1] + _EARTH_RADIUS
    vz = p[..., 2]
    b = vx * d[..., 0] + vy * d[..., 1] + vz * d[..., 2]
    det = b * b - (vx * vx + vy * vy + vz * vz) + r * r
    sq = torch.sqrt(torch.clamp(det, min=0.0))
    t1 = -b - sq
    t2 = -b + sq
    t = torch.where(t1 >= 0.0, t1, t2)
    return torch.where(det < 0.0, -1.0, t)


def _densities_rm(p):
    vx = p[..., 0]
    vy = p[..., 1] + _EARTH_RADIUS
    vz = p[..., 2]
    h = torch.clamp(torch.sqrt(vx * vx + vy * vy + vz * vz) - _EARTH_RADIUS, min=0.0)
    return torch.exp(-h * inv(_H_RAY)), torch.exp(-h * inv(_H_MIE))


def _scatter_depth_int(o, d, l, r0, m0):
    """Trapezoid optical depth along the sun ray; (r0, m0) are the
    densities at `o`."""
    r1, m1 = _densities_rm(o + d * l[..., None])
    half = l * 0.5
    return r0 * half + r1 * half, m0 * half + m1 * half


def procedural_sky(sun_direction: torch.Tensor, ro: torch.Tensor, rd: torch.Tensor):
    """Rayleigh+Mie single-scattering sky (reference: kernels/src/skybox.rs:46-94).
    sun_direction: [4], xyz direction and w intensity; ro, rd: [..., 3]."""
    sundir = sun_direction[:3].expand(rd.shape)
    depth = _escape(ro, rd, _ATMOSPHERE_RADIUS) * inv(_STEPS)

    zero = torch.zeros(rd.shape[:-1], dtype=torch.float32, device=rd.device)
    i_r = [zero] * 3
    i_m = [zero] * 3
    total_r = zero
    total_m = zero
    for i in range(_STEPS):
        p = ro + rd * (depth * float(i))[..., None]
        r0, m0 = _densities_rm(p)
        dr = r0 * depth
        dm = m0 * depth
        total_r = total_r + dr
        total_m = total_m + dm
        sr, sm = _scatter_depth_int(p, sundir, _escape(p, sundir, _ATMOSPHERE_RADIUS), r0, m0)
        depth_r = total_r + sr
        depth_m = total_m + sm
        for c in range(3):
            a = torch.exp(-_RAY_COEFF[c] * depth_r - _MIE_EFFECTIVE * depth_m)
            i_r[c] = i_r[c] + a * dr
            i_m[c] = i_m[c] + a * dm

    mu = dot(rd, sundir)
    ph = torch.clamp(1.58 - 1.52 * mu, min=1e-6)
    phase_mie = rdiv(0.0196, ph * torch.sqrt(ph))
    scale = sun_direction[3] * (1.0 + mu * mu)
    res = torch.stack(
        [
            scale * (i_r[c] * _RAY_COEFF[c] * 0.0597 + i_m[c] * _MIE_SCATTER * phase_mie)
            for c in range(3)
        ],
        dim=-1,
    )
    # sqrt, then x^2.2 as exp(2.2 log x) guarded at zero, NaN masked
    # (reference: kernels/src/skybox.rs:93)
    g = mask_nan(torch.sqrt(torch.clamp(res, min=0.0)))
    safe = torch.clamp(g, min=1e-20)
    return torch.where(g > 0.0, torch.exp(2.2 * torch.log(safe)), 0.0)


def image_sky(skybox: torch.Tensor, sun_direction: torch.Tensor, rd: torch.Tensor):
    """Equirect sky image [H, W, 4] seen along rd [..., 3], rotated with the
    sun's azimuth and scaled by its intensity / 15 (reference:
    kernels/src/lib.rs:71-77) -> [..., 3]."""
    rotation = torch.atan2(sun_direction[2], sun_direction[0])
    cosr = torch.cos(rotation)
    sinr = torch.sin(rotation)
    # Mat3::from_rotation_y(rotation) applied to rd
    x = cosr * rd[..., 0] + sinr * rd[..., 2]
    y = rd[..., 1]
    z = -sinr * rd[..., 0] + cosr * rd[..., 2]
    u = 0.5 + torch.atan2(z, x) * inv(2.0 * PI)
    v = 1.0 - (0.5 + torch.asin(torch.clamp(y, -1.0, 1.0)) * inv(PI))
    uv = torch.stack([u, v], dim=-1)
    intensity = sun_direction[3] * inv(15.0)
    return sample_bilinear(skybox, uv, wrap_x=True)[..., :3] * intensity


def sky_radiance(scene, has_skybox: bool, sun_direction, ro, rd):
    """Image vs procedural sky (static has_skybox, kernels/src/lib.rs:66-78)."""
    if has_skybox:
        return image_sky(scene.skybox, sun_direction, rd)
    return procedural_sky(sun_direction, ro, rd)
