"""Denoiser (twin of rustic_tpu/runtime/denoise.py): a firefly clamp, then
an edge-aware a-trous wavelet filter (Dammertz et al. 2010), as torch ops
on the device `denoise` is given.

The JAX package prefers OpenImageDenoise's python binding when it is
importable and falls back to this filter on any exception; the port runs
this filter alone. The rounding follows XLA's CPU program: the median of
an even count is half the lower middle value plus half the upper.
"""

from __future__ import annotations

import numpy as np
import torch

_B3 = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
_OFFSETS = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)]
_WEIGHTS = np.asarray([_B3[dy + 2] * _B3[dx + 2] for dy, dx in _OFFSETS], np.float32)

_LUM = np.asarray([0.2126, 0.7152, 0.0722], np.float32)


def _clamp_fireflies(img: torch.Tensor, k: float = 2.0) -> torch.Tensor:
    """Scale down pixels whose luminance exceeds k x the median of their 8
    neighbors (the JAX package's docstring gives the measured RMSE and the
    energy this costs)."""
    lum = torch.from_numpy(_LUM).to(img.device)
    lums = [
        torch.roll(img, (dy, dx), dims=(0, 1)) @ lum
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
        if (dy, dx) != (0, 0)
    ]
    srt = torch.sort(torch.stack(lums), dim=0).values
    med = srt[3] * 0.5 + srt[4] * 0.5  # jnp.median: 0.5-weighted middle pair
    self_l = img @ lum
    cap = med * k + 1e-4
    scale = torch.where(self_l > cap, cap / torch.clamp(self_l, min=1e-9), 1.0)
    return img * scale[..., None]


def _atrous(img: torch.Tensor, iterations: int = 3, sigma_color: float = 0.35) -> torch.Tensor:
    # the JAX program takes sigma_color as a traced f32 scalar: square it in f32
    sigma = torch.tensor(sigma_color, dtype=torch.float32, device=img.device)
    sigma2 = sigma * sigma
    out = img
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(out)
        norm = torch.zeros(out.shape[:2] + (1,), dtype=out.dtype, device=out.device)
        for (dy, dx), w in zip(_OFFSETS, _WEIGHTS):
            shifted = torch.roll(out, (dy * step, dx * step), dims=(0, 1))
            d2 = torch.sum((shifted - out) ** 2, dim=-1, keepdim=True)
            wc = float(w) * torch.exp(-d2 / sigma2)
            acc = acc + shifted * wc
            norm = norm + wc
        out = acc / torch.clamp(norm, min=1e-8)
    return out


def denoise(film: np.ndarray, iterations: int = 3, device="cuda") -> np.ndarray:
    """Denoise a linear [H, W, 3] film on `device` (the reference's OIDN
    pass semantics, hdr=True, srgb=False: linear radiance in and out)."""
    from rustic_tpu_torch.runtime.render import resolve_device

    img = torch.from_numpy(np.ascontiguousarray(film, np.float32)).to(resolve_device(device))
    return _atrous(_clamp_fireflies(img), iterations).cpu().numpy()
