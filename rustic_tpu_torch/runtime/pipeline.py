"""Staged renderer for single-tile scenes (twin of the kernel-shade
path of rustic_tpu/runtime/pipeline.py).

Per group of folded samples: init (camera rays, packed state) ->
K1 nearest for bounce 0 -> K4 shade -> per later bounce: K2 nearest plus
the previous bounce's shadow rays -> K4 shade -> finish (fold the last
shadow result and the radiance into the film). The last bounce's shadow
rays of a group are held and ride the next group's bounce-0 scan (K2);
the last group's are resolved by K3. All work is queued on the tensors'
device; nothing waits for it.
"""

from __future__ import annotations

from typing import Optional

import torch

from rustic_tpu_torch.config import CameraParams, StaticConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.ops import shade_kernel as SK
from rustic_tpu_torch.ops import trace as trace_mod
from rustic_tpu_torch.ops.sampling import cross
from rustic_tpu_torch.scene.world import SceneTensors

# Lane budget for sample folding: fold 4 at megabatch sizes (~1M pixels).
_FOLD_MAX_LANES = 1 << 22


def pick_sample_fold(batch: int, n_samples: int) -> int:
    """How many consecutive samples to fold into one lane set: each
    launch then serves `fold` samples of every pixel."""
    f = max(1, _FOLD_MAX_LANES // max(batch, 1))
    return min(f, 8, max(n_samples, 1))


def _fold_sample_idx(sample_idx: int, lanes: int, fold: int, device) -> torch.Tensor:
    """Per-lane sample indices (int32, u32 bits): lane block k of size
    lanes/fold traces sample sample_idx + k."""
    k = torch.arange(fold, dtype=torch.int64, device=device)
    sidx = (sample_idx + k) & 0xFFFFFFFF
    sidx = torch.where(sidx >= (1 << 31), sidx - (1 << 32), sidx).to(torch.int32)
    return sidx.repeat_interleave(lanes // fold)


def initk(cfg: StaticConfig, cam: CameraParams, px, py, sample_idx: int, offsets, fold: int):
    """Camera rays and the initial state of one group of folded samples
    -> (st [NST, B], feats_t [16, B], sidx [B] i32, params [1, 8])."""
    lanes = px.shape[0]
    dev = px.device
    sidx = _fold_sample_idx(sample_idx, lanes, fold, dev)
    ro, rd = trace_mod.camera_rays(cfg, cam, px, py, sidx, offsets)
    st = SK.init_state_packed(lanes, dev)
    feats_t = torch.cat(
        [
            rd.T, cross(ro, rd).T, ro.T,
            torch.ones((1, lanes), dtype=torch.float32, device=dev),
            torch.zeros((6, lanes), dtype=torch.float32, device=dev),
        ],
        dim=0,
    ).contiguous()
    params = torch.cat(
        [cam.sun_direction, cam.specular_weight_clamp,
         torch.zeros(2, dtype=torch.float32, device=dev)]
    ).reshape(1, 8)
    return st, feats_t, sidx, params


def finishk(st, occ, film, fold: int):
    """Fold a finished group into the film sum [lanes, 3]: its radiance
    plus, where the last shadow ray was unoccluded, its pending NEE term."""
    rad = st[SK.SK_RAD]
    if occ is not None:
        pend = st[SK.SK_PEND_CON]
        finite = torch.isfinite(pend).all(dim=0)
        lit = (st[SK.SK_PEND_ELIG] > 0.5) & (occ == 0) & finite
        rad = rad + torch.where(lit[None, :], pend, 0.0)
    if fold > 1:
        rad = rad.reshape(3, fold, -1).sum(dim=1)
    return film + rad.T


def render_batch_staged(
    scene: SceneTensors,
    cfg: StaticConfig,
    cam: CameraParams,
    px: torch.Tensor,
    py: torch.Tensor,
    offsets: torch.Tensor,
    sample_start: int,
    n_samples: int,
    film_in: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Render n_samples of one pixel batch -> film sum [B, 3] on the
    scene's device. px, py: [B] int32; offsets: [B] int32 (u32 bits).
    What the port does not run yet (a multi-tile scene, an HDR sky, an
    alias table over 16 entries) raises NotImplementedError from the
    kernel wrappers.

    Per bounce exactly two launches: a flash scan and the shade kernel,
    chained through the transposed row operands."""
    film = film_in if film_in is not None else torch.zeros(
        (px.shape[0], 3), dtype=torch.float32, device=px.device
    )
    g16 = scene.tri_feats16
    attrs = scene.tri_attrs
    fold = pick_sample_fold(px.shape[0], n_samples)
    n_alias = scene.n_alias_entries if cfg.nee.uses_nee and scene.has_lights else 0

    def tiled(g):
        return tuple(a.repeat(g) for a in (px, py, offsets))

    def flush_held(held, film):
        st_h, sh_h, g_h = held
        return finishk(st_h, FI.occlude(sh_h, g16), film, g_h)

    held = None  # (st, shadow feats_t, fold) awaiting its occlusion
    for k in range(0, n_samples, fold):
        g = min(fold, n_samples - k)
        pxg, pyg, offg = tiled(g)
        if held is not None and held[1].shape[1] != pxg.shape[0]:
            film = flush_held(held, film)
            held = None
        st, feats_t, sidx, params = initk(cfg, cam, pxg, pyg, sample_start + k, offg, g)
        pending_sh = held[1] if held is not None else None
        for bounce in range(cfg.max_bounces):
            if pending_sh is None:
                t, i, attrs_t = FI.nearest_attrs(feats_t, g16, attrs)
                occ = None
            else:
                t, i, occ, attrs_t = FI.nearest_shadow_attrs(feats_t, pending_sh, g16, attrs)
            if bounce == 0 and held is not None:
                # this occlusion result belongs to the held group
                st_h, _sh, g_h = held
                film = finishk(st_h, occ, film, g_h)
                held = None
                occ = None
            st, nf, pending_sh = SK.shade_bounce(
                cfg, bounce, params, scene.entry_rows, st, feats_t, t, i, attrs_t,
                occ, sidx, offg, has_glass=scene.has_glass, n_alias=n_alias,
            )
            if nf is not None:  # the last bounce keeps its input rows
                feats_t = nf
        if pending_sh is not None:
            held = (st, pending_sh, g)
        else:
            film = finishk(st, None, film, g)
    if held is not None:
        film = flush_held(held, film)
    return film
