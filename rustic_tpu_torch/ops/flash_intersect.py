"""Single-tile flash intersection: kernels K1-K3 and their plain twins.

Twins of rustic_tpu/ops/flash_intersect.py under its "f32" plan (the
plan the JAX package runs on the CPU): the Möller–Trumbore numerators of
every (ray, triangle) pair are the product of the ray feature rows
F [16, B] = [rd, ro×rd, ro, 1, maxt, 0...] with the triangle table
G [16, 4·TT] = [det | u·det | v·det | t·det] (scene/world.py:
pack_tri_feats16); the epilogue divides exactly and the nearest scan
takes the first index among equal minima.

- `nearest_attrs` (K1): nearest hit (t, idx; a miss gives t = BIG,
  idx = 0) plus the winner's slim shading row, transposed [W, B].
- `nearest_shadow_attrs` (K2): K1 plus an any-hit test of a second ray
  set within (EPS, maxt], maxt in feature row SH_MAXT_COL.
- `occlude` (K3): the any-hit test alone.

Each wrapper runs the plain PyTorch version for CPU tensors and the
CUDA kernel (csrc/flash_intersect.cu) for CUDA tensors; it counts its
kernel launches in LAUNCHES.
"""

from __future__ import annotations

import torch

from rustic_tpu_torch.ops import _build
from rustic_tpu_torch.ops.sampling import EPS

BIG = 1e6
DET_EPS = 1e-6
SH_MAXT_COL = 10
MAX_TT = 512  # the single-tile width the kernels take

# rays per plain-version chunk: keeps the [chunk, 4·TT] f32 product near 1 GB
_PLAIN_CHUNK_BYTES = 1 << 30

LAUNCHES = {"nearest_attrs": 0, "nearest_shadow_attrs": 0, "occlude": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- plain PyTorch versions -------------------------------------------------


def _tile_width(g16: torch.Tensor) -> int:
    tt = g16.shape[1] // 4
    if g16.shape[0] != 16 or g16.shape[1] != 4 * tt:
        raise ValueError(f"triangle table must be [16, 4*TT], got {tuple(g16.shape)}")
    if tt > MAX_TT:
        raise NotImplementedError(
            "multi-tile scenes (more than 512 triangles) are not ported yet "
            "(ROADMAP.md queue 1 item 7, queue 2)"
        )
    return tt


def _chunks(b: int, tt: int):
    step = max(1, _PLAIN_CHUNK_BYTES // (16 * tt))
    for lo in range(0, b, step):
        yield lo, min(lo + step, b)


def _epilogue(f_t: torch.Tensor, g16: torch.Tensor, tt: int):
    """[16, c] ray rows -> (t, valid) [c, TT] (flash_intersect._epilogue)."""
    raw = f_t.T @ g16
    det = raw[:, 0 * tt : 1 * tt]
    good = det.abs() >= DET_EPS
    inv = torch.where(good, torch.reciprocal(torch.where(good, det, 1.0)), 0.0)
    u = raw[:, 1 * tt : 2 * tt] * inv
    v = raw[:, 2 * tt : 3 * tt] * inv
    t = raw[:, 3 * tt : 4 * tt] * inv
    valid = good & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
    return t, valid


def _nearest_chunk(f_t, g16, tt):
    t, valid = _epilogue(f_t, g16, tt)
    tm = torch.where(valid, t, BIG)
    idx = torch.argmin(tm, dim=1)  # first index among equal minima
    return tm.gather(1, idx[:, None])[:, 0], idx.to(torch.int32)


def _anyhit_chunk(sh_t, g16, tt):
    t, valid = _epilogue(sh_t, g16, tt)
    hit = valid & (t <= sh_t[SH_MAXT_COL][:, None])
    return hit.any(dim=1).to(torch.int32)


def nearest_attrs_plain(feats_t, g16, attrs):
    """[16, B] rays -> (t [B] f32, idx [B] i32, attrsT [W, B] f32)."""
    tt = _tile_width(g16)
    b = feats_t.shape[1]
    t = torch.empty(b, dtype=torch.float32, device=feats_t.device)
    idx = torch.empty(b, dtype=torch.int32, device=feats_t.device)
    for lo, hi in _chunks(b, tt):
        t[lo:hi], idx[lo:hi] = _nearest_chunk(feats_t[:, lo:hi], g16, tt)
    return t, idx, attrs[idx.long()].T.contiguous()


def nearest_shadow_attrs_plain(feats_t, sh_t, g16, attrs):
    """K1 on `feats_t` plus any-hit on `sh_t` ->
    (t, idx, occ [B] i32, attrsT)."""
    t, idx, attrs_t = nearest_attrs_plain(feats_t, g16, attrs)
    return t, idx, occlude_plain(sh_t, g16), attrs_t


def occlude_plain(sh_t, g16):
    """[16, B] shadow rows (maxt in row SH_MAXT_COL) -> occ [B] i32."""
    tt = _tile_width(g16)
    b = sh_t.shape[1]
    occ = torch.empty(b, dtype=torch.int32, device=sh_t.device)
    for lo, hi in _chunks(b, tt):
        occ[lo:hi] = _anyhit_chunk(sh_t[:, lo:hi], g16, tt)
    return occ


# ---- CUDA wrappers ------------------------------------------------------------

# entry point of csrc/flash_intersect.cu: (C name, pointer count, int count)
_ENTRY = {
    "nearest_attrs": ("rt_nearest_attrs", 6, 3),
    "nearest_shadow_attrs": ("rt_nearest_shadow_attrs", 8, 3),
    "occlude": ("rt_occlude", 3, 2),
}


def _launch(name: str, device, tensors, ints):
    fn = _build.entry_point("flash_intersect", *_ENTRY[name])
    _build.launch(fn, name, device, tensors, ints)
    LAUNCHES[name] += 1


def _check_scene(feats_t, g16, attrs=None):
    dev = feats_t.device
    tt = _tile_width(g16)
    _build.check(feats_t, "feats_t", torch.float32, (16, feats_t.shape[1]), dev)
    _build.check(g16, "tri_feats16", torch.float32, (16, 4 * tt), dev)
    if attrs is not None:
        _build.check(attrs, "tri_attrs", torch.float32, (tt, attrs.shape[1]), dev)
    return tt


def nearest_attrs(feats_t, g16, attrs):
    """K1 (replaces flash_nearest_attrs_t): -> (t, idx, attrsT)."""
    if _build.uses_plain(feats_t):
        return nearest_attrs_plain(feats_t, g16, attrs)
    tt = _check_scene(feats_t, g16, attrs)
    b, w = feats_t.shape[1], attrs.shape[1]
    dev = feats_t.device
    t = torch.empty(b, dtype=torch.float32, device=dev)
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    attrs_t = torch.empty((w, b), dtype=torch.float32, device=dev)
    if b:
        _launch("nearest_attrs", dev, (feats_t, g16, attrs, t, idx, attrs_t), (b, tt, w))
    return t, idx, attrs_t


def nearest_shadow_attrs(feats_t, sh_t, g16, attrs):
    """K2 (replaces flash_nearest_shadow_attrs_t): -> (t, idx, occ, attrsT)."""
    if _build.uses_plain(feats_t):
        return nearest_shadow_attrs_plain(feats_t, sh_t, g16, attrs)
    tt = _check_scene(feats_t, g16, attrs)
    _build.check(sh_t, "shadow feats_t", torch.float32, feats_t.shape, feats_t.device)
    b, w = feats_t.shape[1], attrs.shape[1]
    dev = feats_t.device
    t = torch.empty(b, dtype=torch.float32, device=dev)
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    occ = torch.empty(b, dtype=torch.int32, device=dev)
    attrs_t = torch.empty((w, b), dtype=torch.float32, device=dev)
    if b:
        _launch(
            "nearest_shadow_attrs", dev,
            (feats_t, sh_t, g16, attrs, t, idx, occ, attrs_t), (b, tt, w),
        )
    return t, idx, occ, attrs_t


def occlude(sh_t, g16):
    """K3 (replaces flash_occlude_packed_t): -> occ [B] i32."""
    if _build.uses_plain(sh_t):
        return occlude_plain(sh_t, g16)
    tt = _check_scene(sh_t, g16)
    b = sh_t.shape[1]
    occ = torch.empty(b, dtype=torch.int32, device=sh_t.device)
    if b:
        _launch("occlude", sh_t.device, (sh_t, g16, occ), (b, tt))
    return occ
