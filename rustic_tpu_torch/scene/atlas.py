"""The co-located 9-channel material atlas (twin of
rustic_tpu/scene/atlas.py `pack_material_textures`), with a NumPy twin of
the Pillow Lanczos resize the JAX package packs it with.

One cell per textured material; every map of a material lands at the
same quadtree cell (each resized to the cell), so one uvst rect and one
bilinear footprint serve albedo, metallic, roughness and the normal map.
Cells come from a quadtree split of the atlas square until it has at
least as many leaves as textured materials, largest leaves first, in
material order; each map is pasted vertically flipped (reference:
src/atlas.rs:26-90).
"""

from __future__ import annotations

import math
from collections import deque
from typing import List, Tuple

import numpy as np

ATLAS_CHANNELS = 9
CH_ALBEDO = slice(0, 4)  # RGBA, sRGB already decoded at load
CH_METAL = 4  # metallic (the metal-rough map's B channel)
CH_ROUGH = 5  # roughness (its G channel)
CH_NORMAL = slice(6, 9)  # tangent-space normal xyz in [0, 1]


def pack_material_textures(
    mat_maps: List[dict], atlas_width: int = 4096, atlas_height: int = 4096
) -> Tuple[np.ndarray, List]:
    """mat_maps[i]: optional [H, W, 4] float maps 'albedo', 'metallic',
    'roughness', 'normal' of material i -> (atlas [atlas_height,
    atlas_width, 9] float32, per-material uvst [4] float32 or None)."""
    atlas = np.zeros((atlas_height, atlas_width, ATLAS_CHANNELS), np.float32)
    textured = [i for i, maps in enumerate(mat_maps) if any(v is not None for v in maps.values())]
    if not textured:
        return atlas, [None] * len(mat_maps)

    queue = deque([(0, 0, atlas_width, atlas_height)])
    while len(queue) <= len(textured):
        x, y, w, h = queue.popleft()
        hw, hh = w // 2, h // 2
        queue.extend([(x, y, hw, hh), (x + hw, y, hw, hh), (x, y + hh, hw, hh),
                      (x + hw, y + hh, hw, hh)])
    leafs = sorted(queue, key=lambda r: -r[2])[: len(textured)]

    channel = {
        "albedo": CH_ALBEDO,
        "metallic": slice(CH_METAL, CH_METAL + 1),
        "roughness": slice(CH_ROUGH, CH_ROUGH + 1),
        "normal": CH_NORMAL,
    }
    uvsts: List = [None] * len(mat_maps)
    for mi, (x, y, w, h) in zip(textured, leafs):
        for field, tex in mat_maps[mi].items():
            if tex is None:
                continue
            resized = _resize_lanczos(tex, w, h)[::-1]  # vertical flip on paste
            ch = channel[field]
            atlas[y : y + h, x : x + w, ch] = resized[..., : ch.stop - ch.start]
        uvsts[mi] = np.array(
            [x / atlas_width, y / atlas_width,  # the reference's y offset over width
             w / atlas_width, h / atlas_height],
            np.float32,
        )
    return atlas, uvsts


# ---- Pillow's Lanczos resize of an 8-bit RGBA image, in NumPy ---------------
#
# Image.resize(size, LANCZOS) on an RGBA image (Pillow 12.1.0,
# src/PIL/Image.py and src/libImaging/Resample.c): premultiply by alpha
# (RGBA -> RGBa), resample horizontally and then vertically, each pass in
# fixed point with PRECISION_BITS fraction bits, rounded and clipped to
# uint8, and undo the premultiplication (RGBa -> RGBA). The coefficients
# are computed in double precision as Resample.c computes them.

PRECISION_BITS = 32 - 8 - 2
LANCZOS_SUPPORT = 3.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _coeffs(in_size: int, out_size: int):
    """Resample.c precompute_coeffs + normalize_coeffs_8bpc for one axis
    -> (first input index [out], fixed-point weights int32 [out, ksize])."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = LANCZOS_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int32)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            k = v / ww if ww != 0.0 else v
            kk[xx, x] = int(-0.5 + k * (1 << PRECISION_BITS)) if k < 0 else int(
                0.5 + k * (1 << PRECISION_BITS))
        first[xx] = xmin
    return first, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One fixed-point pass along `axis` of a uint8 image."""
    src = np.moveaxis(img, axis, 0)
    first, kk = _coeffs(src.shape[0], out_size)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int32)
    wshape = (out_size,) + (1,) * (src.ndim - 1)
    for k in range(kk.shape[1]):
        rows = np.minimum(first + k, src.shape[0] - 1)  # weights past the support are 0
        acc += src[rows].astype(np.int32) * kk[:, k].reshape(wshape)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a.astype(np.int32) * b.astype(np.int32) + 128
    return (((t >> 8) + t) >> 8).astype(np.uint8)


def _resize_lanczos(tex: np.ndarray, w: int, h: int) -> np.ndarray:
    """[H, W, 4] float texture in [0, 1] -> [h, w, 4] float32, as the JAX
    package's Pillow LANCZOS resize of its uint8 quantisation."""
    u8 = (np.clip(tex, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    alpha = u8[..., 3:4]
    img = np.concatenate([_muldiv255(u8[..., :3], alpha), alpha], axis=-1)  # RGBa
    if w != img.shape[1]:
        img = _resample_axis(img, w, axis=1)
    if h != img.shape[0]:
        img = _resample_axis(img, h, axis=0)
    a = img[..., 3:4].astype(np.int32)
    straight = np.clip((255 * img[..., :3].astype(np.int32)) // np.maximum(a, 1), 0, 255)
    keep = (a == 255) | (a == 0)
    img[..., :3] = np.where(keep, img[..., :3], straight.astype(np.uint8))
    return np.asarray(img, np.float32) / 255.0
