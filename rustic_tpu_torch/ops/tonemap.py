"""Display tonemapping operators (twin of rustic_tpu/ops/tonemap.py).

The reference's WGSL display shader (reference:
src/resources/render.wgsl:36-117, selected by the Tonemapping enum of
src/app.rs:18-42), as plain functions on tensors applied to the averaged
film; the final pow(1/2.2) gamma encode matches render.wgsl fs_main.
"""

from __future__ import annotations

import torch

from rustic_tpu_torch.config import Tonemapping


def reinhard(x):
    return x / (x + 1.0)


def _aces_narkowicz_curve(x):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def aces_narkowicz(x):
    """The reference's default ACES applies a 0.6 pre-exposure
    (render.wgsl:136); the 'overexposed' variant omits it (:139-140)."""
    return _aces_narkowicz_curve(x * 0.6)


def aces_narkowicz_overexposed(x):
    return _aces_narkowicz_curve(x)


_ACES_INPUT = (
    (0.59719, 0.35458, 0.04823),
    (0.07600, 0.90834, 0.01566),
    (0.02840, 0.13383, 0.83777),
)
_ACES_OUTPUT = (
    (1.60475, -0.53108, -0.07367),
    (-0.10208, 1.10813, -0.00605),
    (-0.00327, -0.07276, 1.07602),
)


def _mix3(x, m):
    """x @ m.T for a 3x3 m, summed in channel order: nearer XLA's CPU dot
    than a matmul, whose order of accumulation differs."""
    m = torch.tensor(m, dtype=x.dtype, device=x.device)
    return (x[..., 0:1] * m[:, 0] + x[..., 1:2] * m[:, 1]) + x[..., 2:3] * m[:, 2]


def aces_hill(x):
    color = _mix3(x, _ACES_INPUT)
    a = color * (color + 0.0245786) - 0.000090537
    b = color * (0.983729 * color + 0.4329510) + 0.238081
    color = a / b
    color = _mix3(color, _ACES_OUTPUT)
    return torch.clamp(color, 0.0, 1.0)


def _neutral_curve(x, a, b, c, d, e, f):
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def _f32(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def neutral(x):
    a, b, c, d, e, f = 0.2, 0.29, 0.24, 0.272, 0.02, 0.3
    white_level, white_clip = 5.3, 1.0
    white_scale = 1.0 / _neutral_curve(_f32(white_level, x), a, b, c, d, e, f)
    x = _neutral_curve(x * white_scale, a, b, c, d, e, f)
    x = x * white_scale
    return x / white_clip


def _uncharted_partial(x):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def uncharted2(x):
    exposure_bias = 2.0
    curr = _uncharted_partial(x * exposure_bias)
    white_scale = 1.0 / _uncharted_partial(_f32(11.2, x))
    return curr * white_scale


_OPS = {
    Tonemapping.NONE: lambda x: x,
    Tonemapping.REINHARD: reinhard,
    Tonemapping.ACES_NARKOWICZ: aces_narkowicz,
    Tonemapping.ACES_NARKOWICZ_OVEREXPOSED: aces_narkowicz_overexposed,
    Tonemapping.ACES_HILL: aces_hill,
    Tonemapping.NEUTRAL: neutral,
    Tonemapping.UNCHARTED2: uncharted2,
}


def apply_tonemap(hdr: torch.Tensor, op: Tonemapping, gamma_encode: bool = True) -> torch.Tensor:
    """Map linear HDR radiance [..., 3] to display. With gamma_encode,
    the pow(1/2.2) encode the reference display shader performs after
    the operator (render.wgsl:120-155)."""
    out = _OPS[Tonemapping(op)](hdr)
    if gamma_encode:
        out = torch.pow(torch.clamp(out, min=0.0), 1.0 / 2.2)
    return out
