"""Bilinear texture sampling as explicit gathers (twin of
rustic_tpu/ops/texture.py): the four neighbouring texels of uv * size,
lerped by its fraction (reference: shared_structs/src/image_polyfill.rs:
38-55), with clamp-to-edge addressing, taps bounded to an atlas cell, or
x wrapped for equirect skies.
"""

from __future__ import annotations

import torch

# float -> int32 conversions saturate like XLA's (NaN -> 0); torch's
# conversion of NaN or out-of-range values is undefined
_I32_RANGE = 2.0**30


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0).clamp(-_I32_RANGE, _I32_RANGE).to(torch.int32)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def sample_bilinear(image, uv, tap_lo=None, tap_hi=None, wrap_x: bool = False):
    """Bilinearly sample image [H, W, C] at uv [..., 2] in [0, 1]: the
    floor/ceil texel pair with frac(uv * size) weights. tap_lo/tap_hi
    ([..., 2] int32, inclusive) bound the taps to a sub-rect; wrap_x wraps
    the x taps (the azimuth seam of an equirect sky)."""
    h, w = image.shape[0], image.shape[1]
    flat = image.reshape(h * w, image.shape[2])
    scaled = uv * torch.tensor([w, h], dtype=torch.float32, device=uv.device)
    fl = torch.floor(scaled)
    frac = scaled - fl
    ce = torch.ceil(scaled)
    x0, y0 = _to_i32(fl[..., 0]), _to_i32(fl[..., 1])
    x1, y1 = _to_i32(ce[..., 0]), _to_i32(ce[..., 1])
    if wrap_x:
        x0 = torch.remainder(x0, w)
        x1 = torch.remainder(x1, w)
    elif tap_lo is not None:
        x0 = _clip(x0, tap_lo[..., 0], tap_hi[..., 0])
        x1 = _clip(x1, tap_lo[..., 0], tap_hi[..., 0])
    else:
        x0 = torch.clamp(x0, 0, w - 1)
        x1 = torch.clamp(x1, 0, w - 1)
    if tap_lo is not None and not wrap_x:
        y0 = _clip(y0, tap_lo[..., 1], tap_hi[..., 1])
        y1 = _clip(y1, tap_lo[..., 1], tap_hi[..., 1])
    else:
        y0 = torch.clamp(y0, 0, h - 1)
        y1 = torch.clamp(y1, 0, h - 1)

    def tap(y, x):
        # XLA clamps a gather index into range; an untextured lane's colour
        # slot taken as a rect lands outside, and its texels are discarded
        return flat[torch.clamp(y.long() * w + x.long(), 0, h * w - 1)]

    c00, c10 = tap(y0, x0), tap(y0, x1)
    c01, c11 = tap(y1, x0), tap(y1, x1)
    tx = frac[..., 0:1]
    ty = frac[..., 1:2]
    top = c00 * (1.0 - tx) + c10 * tx
    bot = c01 * (1.0 - tx) + c11 * tx
    return top * (1.0 - ty) + bot * ty


def sample_atlas(atlas, uvst, uv):
    """Sample an atlas cell: atlas_uv = uvst.xy + uv * uvst.zw (reference:
    kernels/src/bsdf.rs:356-357), taps bounded to the cell so uv near 1
    never blends the neighbouring cell's texels."""
    h, w = atlas.shape[0], atlas.shape[1]
    size = torch.tensor([w, h], dtype=torch.float32, device=uv.device)
    scaled = uvst[..., 0:2] + uv * uvst[..., 2:4]
    # quadtree cells are texel-aligned: round() recovers the integer rect
    lo = _to_i32(torch.round(uvst[..., 0:2] * size))
    hi = _to_i32(torch.round((uvst[..., 0:2] + uvst[..., 2:4]) * size))
    hi = torch.maximum(hi - 1, lo)
    return sample_bilinear(atlas, scaled, tap_lo=lo, tap_hi=hi)
