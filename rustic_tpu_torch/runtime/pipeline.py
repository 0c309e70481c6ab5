"""Staged renderer (twin of rustic_tpu/runtime/pipeline.py
`render_batch_staged` without path sorting).

Single-tile scenes take the kernel-shade loop. Per group of folded
samples: init (camera rays, packed state) -> K1 nearest for bounce 0 ->
K4 shade -> per later bounce: K2 nearest plus the previous bounce's
shadow rays -> K4 shade -> finish (fold the last shadow result and the
radiance into the film).

Multi-tile scenes take the stage loop of the JAX package's unsorted
multi-tile branch: init -> K5 nearest for bounce 0 -> `pre` (the torch
shading stage, ops/trace.py bounce_pre) -> per later bounce: K6 nearest
plus the previous bounce's shadow rays -> `pre` -> finish.

In both, the last bounce's shadow rays of a group are held and ride the
next group's bounce-0 scan (K2 / K6); the last group's are resolved by
K3 / K7. All work is queued on the tensors' device; nothing waits for it.
"""

from __future__ import annotations

from typing import Optional

import torch

from rustic_tpu_torch.config import CameraParams, StaticConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.ops import sampling as s
from rustic_tpu_torch.ops import shade_kernel as SK
from rustic_tpu_torch.ops import trace as trace_mod
from rustic_tpu_torch.ops.intersect import _ray_features16, classify_flash_hit2, gather_attr_rows
from rustic_tpu_torch.ops.sampling import cross
from rustic_tpu_torch.ops.skybox import IMAGE_SKY_TODO
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


# ---- multi-tile stages (twins of the XLA stages of `_stages`) ---------------


def _shadow_feats16(nee_pack):
    """Shadow rays as [16, B] feature rows, maxt in row SH_MAXT_COL."""
    return _ray_features16(nee_pack.shadow_ro, nee_pack.shadow_rd, nee_pack.shadow_maxt)


def _fold_slim_nee(radiance, prev_nee, prev_occ):
    """Fold the last bounce's slim NEE carry (eligible, contribution)
    into the radiance, where the shadow ray was not occluded."""
    if prev_nee is None:
        return radiance
    eligible, contribution = prev_nee
    lit = eligible & ~prev_occ
    return radiance + torch.where(lit[..., None], s.mask_nan(contribution), 0.0)


def stage_init(cfg: StaticConfig, cam: CameraParams, px, py, sample_idx: int, offsets, fold: int):
    """Camera rays and the initial state of one group of folded samples
    -> (st with ro/rd None, ray rows [16, B], sidx [B] i32). ro and rd
    ride only in the ray rows between stages."""
    sidx = _fold_sample_idx(sample_idx, px.shape[0], fold, px.device)
    st = trace_mod.init_state(cfg, cam, px, py, sidx, offsets)
    feats = _ray_features16(st.ro, st.rd)
    return st._replace(ro=None, rd=None), feats, sidx


def stage_pre(scene, cfg: StaticConfig, cam: CameraParams, bounce: int, st, feats,
              prev_nee, prev_occ, t, idx, sidx, offsets):
    """One bounce of shading after its scan: fold the previous bounce's
    shadow result, re-test the winner exactly, then `bounce_pre`.
    Returns (st, next ray rows, (slim NEE carry, shadow rows) or None);
    on the last bounce st is just the radiance and no rays are made."""
    st = st._replace(ro=feats[6:9].T, rd=feats[0:3].T)
    if prev_nee is not None:
        st = st._replace(radiance=_fold_slim_nee(st.radiance, prev_nee, prev_occ))
    attrs = gather_attr_rows(scene, idx)
    res, attrs = classify_flash_hit2(t, idx, attrs, None, None, None, st.ro, st.rd)
    st2, nee_pack = trace_mod.bounce_pre(
        scene, cfg, cam, bounce, st, res, trace_mod.bounce_draws(bounce, sidx, offsets),
        attrs=attrs,
    )
    nee = None
    if nee_pack is not None:
        nee = ((nee_pack.eligible, nee_pack.contribution), _shadow_feats16(nee_pack))
    if bounce == cfg.max_bounces - 1:
        return st2.radiance, None, nee
    next_feats = _ray_features16(st2.ro, st2.rd)
    return st2._replace(ro=None, rd=None), next_feats, nee


def stage_finish(radiance, prev_nee, prev_occ, film, fold: int):
    """Fold a finished group's radiance (and its last NEE carry) into the
    film sum [B, 3]."""
    radiance = _fold_slim_nee(radiance, prev_nee, prev_occ)
    if fold > 1:
        radiance = radiance.reshape(fold, film.shape[0], 3).sum(dim=0)
    return film + radiance


def _scan(feats, pending_sh, scene):
    """The flash scan of one bounce: K5 alone, or K6 with the pending
    shadow rays -> (t, idx, occ bool or None)."""
    g16, aabbs = scene.tri_feats16, scene.tile_aabbs
    if pending_sh is None:
        lists, counts = FI.block_tile_lists(aabbs, FI.BT_MULTI, (False,), feats)
        t, idx = FI.nearest_multi(feats, g16, lists, counts)
        return t, idx, None
    lists, counts = FI.block_tile_lists(aabbs, FI.BT_MULTI, (False, True), feats, pending_sh)
    t, idx, occ = FI.nearest_shadow_multi(feats, pending_sh, g16, lists, counts)
    return t, idx, occ != 0


def _flush_held(held, film, scene):
    """Resolve a held group's last shadow rays with K7 and fold it."""
    rad, prev_nee, pending_sh, g = held
    lists, counts = FI.block_tile_lists(scene.tile_aabbs, FI.BT_MULTI, (True,), pending_sh)
    occ = FI.occlude_multi(pending_sh, scene.tri_feats16, lists, counts) != 0
    return stage_finish(rad, prev_nee, occ, film, g)


def _render_batch_multitile(scene, cfg, cam, px, py, offsets, sample_start, n_samples, film):
    """The unsorted multi-tile stage loop (rustic_tpu/runtime/pipeline.py:1066-1150)."""
    if cfg.has_skybox:
        raise NotImplementedError(IMAGE_SKY_TODO)
    fold = pick_sample_fold(px.shape[0], n_samples)
    held = None  # (radiance, prev_nee, pending shadow rows, fold) awaiting occlusion
    for k in range(0, n_samples, fold):
        g = min(fold, n_samples - k)
        pxg, pyg, offg = (a.repeat(g) for a in (px, py, offsets))
        if held is not None and held[2].shape[1] != pxg.shape[0]:
            film = _flush_held(held, film, scene)
            held = None
        st, feats, sidx = stage_init(cfg, cam, pxg, pyg, sample_start + k, offg, g)
        prev_nee = None
        pending_sh = held[2] if held is not None else None
        for bounce in range(cfg.max_bounces):
            t, idx, prev_occ = _scan(feats, pending_sh, scene)
            if bounce == 0 and held is not None:
                # this occlusion result belongs to the held group
                rad_h, nee_h, _, g_h = held
                film = stage_finish(rad_h, nee_h, prev_occ, film, g_h)
                held = None
                prev_occ = None
            st, feats, nee = stage_pre(
                scene, cfg, cam, bounce, st, feats, prev_nee, prev_occ, t, idx, sidx, offg
            )
            prev_nee = pending_sh = None
            if nee is not None:
                prev_nee, pending_sh = nee
        if pending_sh is not None:
            held = (st, prev_nee, pending_sh, g)
        else:
            film = stage_finish(st, prev_nee, None, film, g)
    if held is not None:
        film = _flush_held(held, film, scene)
    return film


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
    A scene of one triangle tile takes the kernel-shade loop, one of
    more tiles the stage loop (as rustic_tpu's `render_batch_staged`
    dispatches at pipeline.py:1007, with path sorting off). What the
    port does not run yet (an HDR sky; on one tile, an alias table over
    16 entries) raises NotImplementedError.

    Single tile: per bounce exactly two launches, a flash scan and the
    shade kernel, chained through the transposed row operands."""
    film = film_in if film_in is not None else torch.zeros(
        (px.shape[0], 3), dtype=torch.float32, device=px.device
    )
    if FI.geometry(scene.tri_feats16)[2] > 1:
        return _render_batch_multitile(
            scene, cfg, cam, px, py, offsets, sample_start, n_samples, film
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
