"""Staged renderer (twin of rustic_tpu/runtime/pipeline.py
`render_batch_staged`).

Single-tile scenes take the kernel-shade loop where the shade kernel
takes the scene (`shade_kernel.supported`: untextured, an alias table of
at most 16 entries). Per group of folded samples: init (camera rays,
packed state) -> K1 nearest for bounce 0 -> K4 shade -> per later bounce:
K2 nearest plus the previous bounce's shadow rays -> K4 shade -> finish
(fold the last shadow result and the radiance into the film). The other
single-tile scenes, and any for which the caller names it
(`SINGLE_TILE_LOOPS`), take the torch-shade loop: the unsorted stage loop
below at one tile, whose scans are K12 / K13 / K3 and whose shading stage
gathers the winners' rows itself, at the width of the scene's table.

Multi-tile scenes take the loop the caller's `loop` argument names
(`MULTITILE_LOOPS`):

- kernel-shade (the default): the loop of `_stages_ks_mt`. Per bounce a
  scan, the row resolve of ops/resolve.py and one shade kernel (K8 for
  alias tables over 16 entries, else K4); the packed state stays in
  pixel order, while the next and shadow rays are sorted by origin cell
  (retired lanes as sentinel rays at the back) for K5/K6, whose tile
  lists then cull.
- ray-sorted: the stage loop of `_stages_raysorted`, the same sorting
  around the torch shading stage (`pre`, ops/trace.py bounce_pre).
- unsorted: init -> K5 -> `pre` -> per later bounce K6 plus the previous
  bounce's shadow rays -> `pre` -> finish.
- state-sorted (`_render_batch_sorted`): the torch shading stage, after
  which the whole lane state is sorted, lanes that owe no more work last,
  and compacted to the static keep count a pilot measured (path
  compaction); the film is a scatter-add over each lane's pixel.
- auto: the state-sorted driver where the pilot's schedule leaves at most
  _STATE_SORT_MAX_W of the work, else the kernel-shade loop.
- fused: one launch of K17 a bounce (`_render_batch_fused`).

Each multi-tile scan takes the form the caller's `scan` argument names
(`MULTITILE_SCANS`): "grid" (the default), K9/K10/K11, which cull tiles
per ray in the kernel and need no lists; "lists", `block_tile_lists` in
torch and then K5/K6/K7; or "resident", K14/K15/K16, the same cull as the
grid form with the whole triangle table held in a thread-block cluster's
shared memory (a scene that does not fit there is refused).

They give the same film (the state-sorted driver up to the order of its
scatter-adds); kernel-shade is the fastest on the card. The ray-sorted,
unsorted and state-sorted loops are the ports of the JAX package's
XLA-shade drivers.

In every loop but the state-sorted one the last bounce's shadow rays of a
group are held and ride the next group's bounce-0 scan (K2 / K13 / K6 /
K10 / K15); the last group's are resolved by K3 / K7 / K11 / K16, which
the state-sorted driver runs once a group. With an HDR skybox (`cfg.has_skybox`) the
kernel-shade loops add the image sky to the escaped lanes after a group's
last bounce (`hdr_sky_payoff`), the reference loops in `bounce_pre`. All
work is queued on the tensors' device; the host waits for it only in the
state-sorted driver, for its pilot's keep counts (once per scene, camera
and lane count) and for its overflow flag (once a window of groups).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rustic_tpu_torch.config import CameraParams, StaticConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.ops import fused_bounce as FB
from rustic_tpu_torch.ops import sampling as s
from rustic_tpu_torch.ops import shade_kernel as SK
from rustic_tpu_torch.ops import trace as trace_mod
from rustic_tpu_torch.ops.intersect import (
    MULTITILE_SCANS,
    _ray_features16,
    check_scan as _check_scan,
    classify_flash_hit2,
    flash_occlude_rows as _occlude,
    flash_scan as _scan,
    gather_attr_rows,
)
from rustic_tpu_torch.ops.nee import ENTRY_SELECT_MAX
from rustic_tpu_torch.ops.resolve import resolve_attrs_rowT
from rustic_tpu_torch.ops.sampling import cross
from rustic_tpu_torch.ops.skybox import image_sky
from rustic_tpu_torch.scene.world import SceneTensors

# Lane budgets for sample folding: fold 4 at megabatch sizes (~1M pixels);
# the state-sorted driver, which permutes the whole state, folds less.
_FOLD_MAX_LANES = 1 << 22
_FOLD_MAX_LANES_SORTED = 1 << 19


def pick_sample_fold(batch: int, n_samples: int, sorted_path: bool = False) -> int:
    """How many consecutive samples to fold into one lane set: each
    launch then serves `fold` samples of every pixel. `sorted_path`: the
    state-sorted driver's budget."""
    budget = _FOLD_MAX_LANES_SORTED if sorted_path else _FOLD_MAX_LANES
    f = max(1, budget // max(batch, 1))
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


def hdr_sky_payoff(skybox, sun_direction, st, feats_t):
    """The HDR sky of the kernel-shade loops (`_hdr_sky_payoff`): the shade
    kernel in HDR mode leaves the sky out, so after the last bounce the
    escaped lanes (SK_MISSED) add throughput x image_sky along the rd of
    the last bounce's input rows (a retired lane's rd stays frozen at its
    miss). A masked update in place of the JAX `lax.cond`: no host sync.
    Updates st [NST, B] in place and returns it."""
    missed = st[SK.SK_MISSED] > 0.5
    sky = image_sky(skybox, sun_direction, feats_t[0:3].T)  # [B, 3]
    st[SK.SK_RAD] += torch.where(missed[None, :], st[SK.SK_THR] * sky.T, 0.0)
    return st


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


def _shade(scene, cfg: StaticConfig, cam: CameraParams, bounce: int, st,
           prev_nee, prev_occ, t, idx, sidx, offsets):
    """Fold the previous bounce's shadow result, re-test the winner
    exactly, then `bounce_pre` -> (st, NEEPack or None). st carries the
    rays of this bounce in ro/rd; t, idx and prev_occ are in its order."""
    if prev_nee is not None:
        st = st._replace(radiance=_fold_slim_nee(st.radiance, prev_nee, prev_occ))
    attrs = gather_attr_rows(scene, idx)
    res, attrs = classify_flash_hit2(t, idx, attrs, None, None, None, st.ro, st.rd)
    return trace_mod.bounce_pre(
        scene, cfg, cam, bounce, st, res, trace_mod.bounce_draws(bounce, sidx, offsets),
        attrs=attrs,
    )


def stage_pre(scene, cfg: StaticConfig, cam: CameraParams, bounce: int, st, feats,
              prev_nee, prev_occ, t, idx, sidx, offsets):
    """One bounce of shading after its scan (`_shade`).
    Returns (st, next ray rows, (slim NEE carry, shadow rows) or None);
    on the last bounce st is just the radiance and no rays are made."""
    st = st._replace(ro=feats[6:9].T, rd=feats[0:3].T)
    st2, nee_pack = _shade(scene, cfg, cam, bounce, st, prev_nee, prev_occ, t, idx, sidx, offsets)
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


def _flush_held(held, film, scene, scan):
    """Resolve a held group's last shadow rays (`_occlude`) and fold it."""
    rad, prev_nee, pending_sh, g = held
    return stage_finish(rad, prev_nee, _occlude(pending_sh, scene, scan) != 0, film, g)


def _render_batch_unsorted(scene, cfg, cam, px, py, offsets, sample_start, n_samples, film,
                           scan=MULTITILE_SCANS[0]):
    """The unsorted stage loop (rustic_tpu/runtime/pipeline.py:1066-1150):
    the "unsorted" multi-tile loop and, at one tile, the torch-shade loop."""
    fold = pick_sample_fold(px.shape[0], n_samples)
    held = None  # (radiance, prev_nee, pending shadow rows, fold) awaiting occlusion
    for k in range(0, n_samples, fold):
        g = min(fold, n_samples - k)
        pxg, pyg, offg = (a.repeat(g) for a in (px, py, offsets))
        if held is not None and held[2].shape[1] != pxg.shape[0]:
            film = _flush_held(held, film, scene, scan)
            held = None
        st, feats, sidx = stage_init(cfg, cam, pxg, pyg, sample_start + k, offg, g)
        prev_nee = None
        pending_sh = held[2] if held is not None else None
        for bounce in range(cfg.max_bounces):
            t, idx, prev_occ = _scan(feats, pending_sh, scene, scan)
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
        film = _flush_held(held, film, scene, scan)
    return film


# ---- ray sorting (twins of `_sort_perm_rays`, `_sentinel_feats`) -------------

SORT_CELLS = 16  # origin cells per axis of the Morton key
SENTINEL_RO = 1e7  # a sentinel ray starts here, outside every tile AABB


def _spread4(v):
    """4-bit Morton spread: b3 b2 b1 b0 -> bits 9, 6, 3, 0."""
    return ((v & 8) << 6) | ((v & 4) << 4) | ((v & 2) << 2) | (v & 1)


def sort_keys(scene, ro, rd, dead):
    """The ray-sort key of each lane (int32): retired last (bit 16), then
    the origin's cell over the scene's tile-AABB bounds (4-bit Morton per
    axis), then the direction octant. ro, rd: [B, 3]; dead: [B] bool."""
    aabb = scene.tile_aabbs
    lo = aabb[:, 0:3].amin(dim=0)
    hi = aabb[:, 4:7].amax(dim=0)
    span = torch.clamp(hi - lo, min=1e-6)
    cell = (ro - lo) / span * float(SORT_CELLS)
    # XLA's f32 -> s32 conversion saturates (NaN -> 0); clamping first
    # keeps torch's conversion in range with the same clipped result
    cell = torch.nan_to_num(cell, nan=0.0).clamp(-1.0, float(SORT_CELLS))
    q = torch.clamp(cell.to(torch.int32), 0, SORT_CELLS - 1)
    morton = (_spread4(q[:, 0]) << 2) | (_spread4(q[:, 1]) << 1) | _spread4(q[:, 2])
    octant = (
        ((rd[:, 0] > 0).to(torch.int32) << 2)
        | ((rd[:, 1] > 0).to(torch.int32) << 1)
        | (rd[:, 2] > 0).to(torch.int32)
    )
    return (dead.to(torch.int32) << 16) | (morton << 3) | octant


def sort_perm_rays(scene, ro, rd, dead):
    """The lane order the scans see (`_sort_perm_rays`): a stable sort of
    `sort_keys`, as jnp.argsort is stable. sorted[k] = lane perm[k]."""
    return torch.argsort(sort_keys(scene, ro, rd, dead), stable=True)


def _inverse(perm):
    """inv[perm] = arange: ray order -> state order by `x[inv]`."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


def sentinel_feats(feats, dead):
    """Retired lanes' ray rows [16, B] become a ray far outside every tile
    AABB (ro = 1e7, rd = +x), so a block of them admits no tile; its
    max_t (row SH_MAXT_COL) is -1, so any-hit never fires."""
    dev = feats.device
    row = _ray_features16(
        torch.full((1, 3), SENTINEL_RO, dtype=torch.float32, device=dev),
        torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float32, device=dev),
    )
    row[FI.SH_MAXT_COL] = -1.0
    return torch.where(dead[None, :], row, feats)


def _sort_rows(scene, ro, rd, dead, *rows):
    """Sort ray rows [16, B] (None skipped) by `sort_perm_rays` in one
    gather -> (the sorted rows, inverse permutation)."""
    perm = sort_perm_rays(scene, ro, rd, dead)
    present = [r for r in rows if r is not None]
    both = torch.cat(present, dim=0)[:, perm] if len(present) > 1 else present[0][:, perm]
    parts = iter(both.split(16, dim=0))
    return tuple(None if r is None else next(parts) for r in rows), _inverse(perm)


# ---- the ray-sorted stage loop (twin of `_stages_raysorted`) ----------------


def rs_init(cfg: StaticConfig, cam: CameraParams, px, py, sample_idx: int, offsets, fold: int):
    """Camera rays and the initial state, which keeps its ro/rd: the
    scans' rows are sorted, so they cannot carry the state's rays.
    Bounce 0 runs unsorted -> (st, ray rows [16, B], sidx)."""
    sidx = _fold_sample_idx(sample_idx, px.shape[0], fold, px.device)
    st = trace_mod.init_state(cfg, cam, px, py, sidx, offsets)
    return st, _ray_features16(st.ro, st.rd), sidx


def rs_pre(scene, cfg: StaticConfig, cam: CameraParams, bounce: int, st, prev_nee, prev_occ,
           t, idx, inv, sidx, offsets):
    """One bounce of shading on the ray-sorted loop: unsort the scan's
    results through `inv` (None at bounce 0), `_shade`, then sort the next
    and shadow rays, retired ones as sentinels at the back. Returns (st,
    sorted next rows, (slim NEE carry, sorted shadow rows) or None, the
    new inverse); on the last bounce st is the radiance and only the
    shadow rows are sorted (by the state's continuation rays)."""
    if inv is not None:
        t, idx = t[inv], idx[inv]
        if prev_occ is not None:
            prev_occ = prev_occ[inv]
    st2, nee_pack = _shade(scene, cfg, cam, bounce, st, prev_nee, prev_occ, t, idx, sidx, offsets)
    slim = shadow = None
    dead = ~st2.alive
    if nee_pack is not None:
        slim = (nee_pack.eligible, nee_pack.contribution)
        shadow = sentinel_feats(_shadow_feats16(nee_pack), ~nee_pack.eligible)
    if bounce == cfg.max_bounces - 1:
        if nee_pack is None:
            return st2.radiance, None, None, None
        (shadow,), inv = _sort_rows(scene, st2.ro, st2.rd, ~nee_pack.eligible, shadow)
        return st2.radiance, None, (slim, shadow), inv
    nxt = sentinel_feats(_ray_features16(st2.ro, st2.rd), dead)
    if nee_pack is not None:
        dead = dead & ~nee_pack.eligible
    (nxt, shadow), inv = _sort_rows(scene, st2.ro, st2.rd, dead, nxt, shadow)
    return st2, nxt, None if slim is None else (slim, shadow), inv


def rs_finish(radiance, prev_nee, prev_occ, inv, film, fold: int):
    """`stage_finish` after unsorting the held shadow result."""
    if prev_occ is not None and inv is not None:
        prev_occ = prev_occ[inv]
    return stage_finish(radiance, prev_nee, prev_occ, film, fold)


def _flush_held_rs(held, film, scene, scan):
    """Resolve a held group's sorted shadow rows with K7 / K11 and fold it."""
    rad, prev_nee, shadow, inv, g = held
    return rs_finish(rad, prev_nee, _occlude(shadow, scene, scan) != 0, inv, film, g)


def _render_batch_raysorted(scene, cfg, cam, px, py, offsets, sample_start, n_samples, film,
                            scan=MULTITILE_SCANS[0]):
    """The ray-sorted multi-tile stage loop (rustic_tpu/runtime/pipeline.py:1539-1597)."""
    fold = pick_sample_fold(px.shape[0], n_samples)
    held = None  # (radiance, prev_nee, sorted shadow rows, inverse, fold)
    for k in range(0, n_samples, fold):
        g = min(fold, n_samples - k)
        pxg, pyg, offg = (a.repeat(g) for a in (px, py, offsets))
        if held is not None and held[2].shape[1] != pxg.shape[0]:
            film = _flush_held_rs(held, film, scene, scan)
            held = None
        st, feats, sidx = rs_init(cfg, cam, pxg, pyg, sample_start + k, offg, g)
        prev_nee = pending_sh = inv = None
        for bounce in range(cfg.max_bounces):
            held_here = bounce == 0 and held is not None
            t, idx, prev_occ = _scan(feats, held[2] if held_here else pending_sh, scene, scan)
            if held_here:
                rad_h, nee_h, _, inv_h, g_h = held
                film = rs_finish(rad_h, nee_h, prev_occ, inv_h, film, g_h)
                held = None
                prev_occ = None
            st, feats, nee, inv = rs_pre(
                scene, cfg, cam, bounce, st, prev_nee, prev_occ, t, idx, inv, sidx, offg
            )
            prev_nee = pending_sh = None
            if nee is not None:
                prev_nee, pending_sh = nee
        if pending_sh is not None:
            held = (st, prev_nee, pending_sh, inv, g)
        else:
            film = stage_finish(st, prev_nee, None, film, g)
    if held is not None:
        film = _flush_held_rs(held, film, scene, scan)
    return film


# ---- the kernel-shade multi-tile loop (twin of `_stages_ks_mt`) -------------


def ks_resolve(scene, feats_t, t, idx, occ, inv):
    """Unsort a scan's results through `inv` (None at bounce 0) and
    resolve the winners' slim rows -> (t, idx, occ i32 or None, attrsT)."""
    if inv is not None:
        t, idx = t[inv], idx[inv]
        if occ is not None:
            occ = occ[inv]
    if occ is not None:
        occ = occ.to(torch.int32)
    return t, idx, occ, resolve_attrs_rowT(scene, feats_t, idx)


def ks_sort(scene, st, nf, sf):
    """Sort the shade kernel's next and shadow rows for the next scans:
    sentinels on retired lanes, keys from the next rays (from the shadow
    rays on the last bounce) -> (next rows, shadow rows, inverse)."""
    alive = st[SK.SK_ALIVE] > 0.5
    elig = st[SK.SK_PEND_ELIG] > 0.5 if sf is not None else None
    if nf is not None:
        dead = ~alive if sf is None else ~alive & ~elig
        keyed = nf
        nf = sentinel_feats(nf, ~alive)
    else:
        dead = ~elig
        keyed = sf
    if sf is not None:
        sf = sentinel_feats(sf, ~elig)
    (nf, sf), inv = _sort_rows(scene, keyed[6:9].T, keyed[0:3].T, dead, nf, sf)
    return nf, sf, inv


def _render_batch_ks_multitile(scene, cfg, cam, px, py, offsets, sample_start, n_samples, film,
                               scan=MULTITILE_SCANS[0]):
    """The kernel-shade multi-tile loop (rustic_tpu/runtime/pipeline.py:1416-1527):
    per bounce a scan (K5/K6, or K9/K10 in the grid form), `ks_resolve`,
    one shade kernel (K8 for alias tables over 16 entries, else K4) and
    `ks_sort`; with an HDR sky, `hdr_sky_payoff` after the last bounce.
    The packed state and the shade kernel's ray rows stay in pixel order."""
    fold = pick_sample_fold(px.shape[0], n_samples)
    n_alias = scene.n_alias_entries if cfg.nee.uses_nee and scene.has_lights else 0
    shade = SK.shade_bounce_wide if n_alias > ENTRY_SELECT_MAX else SK.shade_bounce

    def flush_held(held, film):
        st_h, sh_h, inv_h, g_h = held
        return finishk(st_h, _occlude(sh_h, scene, scan)[inv_h], film, g_h)

    held = None  # (st, sorted shadow rows, inverse, fold) awaiting occlusion
    for k in range(0, n_samples, fold):
        g = min(fold, n_samples - k)
        pxg, pyg, offg = (a.repeat(g) for a in (px, py, offsets))
        if held is not None and held[1].shape[1] != pxg.shape[0]:
            film = flush_held(held, film)
            held = None
        st, feats_t, sidx, params = initk(cfg, cam, pxg, pyg, sample_start + k, offg, g)
        pending_sh = held[1] if held is not None else None
        inv = None  # inverse of the scan operands' order
        feats_in = None  # sorted next rays; None: the bounce-0 camera rays
        for bounce in range(cfg.max_bounces):
            t, i, occ = _scan(feats_t if feats_in is None else feats_in, pending_sh, scene, scan)
            if bounce == 0 and held is not None:
                # the occlusion column belongs to the held group, in its order
                st_h, _, inv_h, g_h = held
                film = finishk(st_h, occ[inv_h].to(torch.int32), film, g_h)
                held = None
                occ = None
            t, i, occ, attrs_t = ks_resolve(scene, feats_t, t, i, occ, inv)
            st, nf, sf = shade(
                cfg, bounce, params, scene.entry_rows, st, feats_t, t, i, attrs_t, occ,
                sidx, offg, has_glass=scene.has_glass, n_alias=n_alias,
            )
            if nf is None and sf is None:  # last bounce without NEE
                pending_sh = feats_in = inv = None
                continue
            feats_in, pending_sh, inv = ks_sort(scene, st, nf, sf)
            if nf is not None:
                feats_t = nf
        if cfg.has_skybox:  # feats_t holds the last bounce's input rows
            st = hdr_sky_payoff(scene.skybox, cam.sun_direction, st, feats_t)
        if pending_sh is not None:
            held = (st, pending_sh, inv, g)
        else:
            film = finishk(st, None, film, g)
    if held is not None:
        film = flush_held(held, film)
    return film


# ---- the state-sorted driver with path compaction (twin of `_stages_sorted`) --

# fold groups a compaction window holds; its overflow flag is read once a window
_THROTTLE_GROUPS_SORTED = 4
# "auto" takes the state-sorted driver at or below this work fraction
# (`_pick_sort_mode`); the JAX package's RUSTIC_STATE_SORT_MAX_W is not read
_STATE_SORT_MAX_W = 0.7


def _sort_perm(scene, st, dead):
    """The lane order of the whole state: `sort_perm_rays` of its rays."""
    return sort_perm_rays(scene, st.ro, st.rd, dead)


def _permute_lanes(perm, tree):
    """Index every lane-major tensor [B, ...] of `tree` (nested tuples and
    NamedTuples; None stays None) with the same permutation. Each keeps
    its dtype: the u32 offsets ride as int32 bit patterns, which an index
    gather carries exactly. The JAX package packs every leaf into one f32
    matrix for a single gather, a TPU device (gather cost there is linear
    in the number of gathers)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[perm]
    parts = (_permute_lanes(perm, x) for x in tree)
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)


def ss_init(cfg: StaticConfig, cam: CameraParams, px, py, sample_idx: int, offsets, fold: int):
    """Camera rays and the initial state, which keeps its rays (the state
    itself is sorted) -> (st, ray rows [16, B], sidx, lane2px [B] int64:
    each lane's pixel, where its radiance is scatter-added)."""
    lanes = px.shape[0]
    sidx = _fold_sample_idx(sample_idx, lanes, fold, px.device)
    st = trace_mod.init_state(cfg, cam, px, py, sidx, offsets)
    lane2px = torch.arange(lanes, dtype=torch.int64, device=px.device) % (lanes // fold)
    return st, _ray_features16(st.ro, st.rd), sidx, lane2px


def ss_pre(scene, cfg: StaticConfig, cam: CameraParams, bounce: int, st, prev_nee, prev_occ,
           t, idx, sidx, offsets, lane2px, window=None):
    """One bounce of the state-sorted driver: `_shade`, then (but on the
    last bounce) the whole lane set sorted by `_sort_perm` with the lanes
    that owe no more work (neither alive nor owed a shadow result) last,
    and with `window` = (k_out, film, oflow) the tail past k_out dropped:
    its radiance and owed deferred sky term scatter-added into `film` in
    place, and `oflow` raised if a lane it dropped still owed work.
    Returns (st, next ray rows, (slim NEE carry, shadow rows) or None,
    sidx, offsets, lane2px, n) with n the keep count (a device scalar)
    without a window and the window's overflow flag with one; on the last
    bounce st is the radiance, nothing is sorted and n is None."""
    st2, nee_pack = _shade(scene, cfg, cam, bounce, st, prev_nee, prev_occ, t, idx, sidx, offsets)
    slim = shadow = None
    keep = st2.alive
    if nee_pack is not None:
        slim = (nee_pack.eligible, nee_pack.contribution)
        shadow = sentinel_feats(_shadow_feats16(nee_pack), ~nee_pack.eligible)
        keep = keep | nee_pack.eligible
    if bounce == cfg.max_bounces - 1:
        nee = None if slim is None else (slim, shadow)
        return st2.radiance, None, nee, sidx, offsets, lane2px, None
    nxt = sentinel_feats(_ray_features16(st2.ro, st2.rd), ~st2.alive)
    perm = _sort_perm(scene, st2, ~keep)
    st2, slim, sidx, offsets, lane2px, keep = _permute_lanes(
        perm, (st2, slim, sidx, offsets, lane2px, keep))
    rows = (nxt if shadow is None else torch.cat([nxt, shadow], dim=0))[:, perm]
    if window is None:
        n = keep.sum()
    else:
        k_out, film, n = window
        if k_out < keep.shape[0]:
            tail = slice(k_out, None)
            rad = st2.radiance[tail] + trace_mod.deferred_sky_term(
                scene, cfg, cam, st2.ro[tail], st2.rd[tail], st2.throughput[tail],
                st2.missed[tail])
            film.index_add_(0, lane2px[tail], rad)
            n = n | keep[tail].any()
            st2, slim, sidx, offsets, lane2px = _permute_lanes(  # the head slice
                slice(0, k_out), (st2, slim, sidx, offsets, lane2px))
            rows = rows[:, :k_out].contiguous()  # the scans take contiguous rows
    nxt, shadow = (rows, None) if shadow is None else rows.split(16, dim=0)
    nee = None if slim is None else (slim, shadow)
    return st2, nxt, nee, sidx, offsets, lane2px, n


def ss_finish(radiance, prev_nee, prev_occ, film, lane2px):
    """Scatter-add a finished group's radiance (with its last NEE carry)
    into the film sum [B, 3] over lane2px."""
    return film.index_add(0, lane2px, _fold_slim_nee(radiance, prev_nee, prev_occ))


def _quantize_schedule(counts, lanes: int, bt: int, measured: int = None):
    """Static per-bounce keep-lane counts from measured keep counts
    (measured over `measured` lanes, scaled to `lanes`): a 10% + one-block
    margin, rounded up to a coarse power-of-two grid of bt multiples, never
    growing from one bounce to the next. None when compaction would not
    drop at least half the lanes anywhere."""
    scale = lanes / max(measured or lanes, 1)
    levels = sorted(min(lanes, -(-(lanes // d) // bt) * bt) for d in (1, 2, 4, 8, 16, 32))
    ks = []
    for c in counts:
        need = int(c * scale * 1.10) + bt
        ks.append(next((lv for lv in levels if lv >= need), lanes))
    for i in range(1, len(ks)):  # the keep set only shrinks
        ks[i] = min(ks[i], ks[i - 1])
    if min(ks) > lanes // 2:
        return None
    return tuple(ks)


def _pilot_schedule(scene, cfg, cam, px, py, offsets, sample_start, lanes, bt, scan):
    """Keep counts of bounces 0 .. max_bounces - 2 measured on a strided
    subsample of about 8192 pixels (one sample, uncompacted, one host sync)
    and quantized into the compaction schedule of `lanes` lanes."""
    if cfg.max_bounces < 2:
        return None
    stride = max(1, px.shape[0] // 8192)
    ppx, ppy, poff = px[::stride], py[::stride], offsets[::stride]
    st, feats, sidx, lane2px = ss_init(cfg, cam, ppx, ppy, sample_start, poff, 1)
    prev_nee = pending = None
    counts = []
    for bounce in range(cfg.max_bounces - 1):
        t, idx, prev_occ = _scan(feats, pending, scene, scan)
        st, feats, nee, sidx, poff, lane2px, n_keep = ss_pre(
            scene, cfg, cam, bounce, st, prev_nee, prev_occ, t, idx, sidx, poff, lane2px)
        counts.append(n_keep)
        prev_nee = pending = None
        if nee is not None:
            prev_nee, pending = nee
    host = torch.stack(counts).tolist()
    return _quantize_schedule(host, lanes, bt, measured=ppx.shape[0])


# (schedule, camera signature) per (scene table, cfg, lanes, block, pilot):
# keep counts depend on the camera, so an entry serves only while the camera
# matches. A stale schedule costs speed, never the film (the overflow redo).
_PILOT_CACHE: dict = {}


def _cached_pilot_schedule(scene, cfg, cam, px, py, offsets, sample_start, lanes, bt, scan):
    # keyed on the pilot's identity too, so that a test which replaces
    # _pilot_schedule never reads an entry another pilot made
    key = (id(scene.tri_feats16), cfg, lanes, bt, id(_pilot_schedule))
    sig = np.concatenate([
        getattr(cam, f.name).detach().cpu().double().numpy().ravel()
        for f in dataclasses.fields(cam)
    ])
    hit = _PILOT_CACHE.get(key)
    if hit is not None and hit[1].shape == sig.shape and np.allclose(hit[1], sig, atol=1e-6):
        return hit[0]
    sched = _pilot_schedule(scene, cfg, cam, px, py, offsets, sample_start, lanes, bt, scan)
    if len(_PILOT_CACHE) > 64:
        _PILOT_CACHE.clear()
    _PILOT_CACHE[key] = (sched, sig)
    return sched


def work_fraction(cfg: StaticConfig, lanes: int, schedule) -> Optional[float]:
    """The share of full-width bounces a compacted group runs (bounce 0 at
    `lanes`, then the schedule's), or None without a schedule."""
    if schedule is None:
        return None
    return (lanes + sum(schedule)) / (cfg.max_bounces * lanes)


def sort_mode_pilot(scene, cfg, cam, px, py, offsets, sample_start, n_samples,
                    scan=MULTITILE_SCANS[0]):
    """The state-sorted driver's lane count and (cached) pilot schedule for
    this batch -> (lanes, schedule or None)."""
    fold = pick_sample_fold(px.shape[0], n_samples, sorted_path=True)
    lanes = px.shape[0] * fold
    return lanes, _cached_pilot_schedule(
        scene, cfg, cam, px, py, offsets, sample_start, lanes, FI.BT_MULTI, scan)


def _pick_sort_mode(scene, cfg, cam, px, py, offsets, sample_start, n_samples,
                    scan=MULTITILE_SCANS[0]) -> str:
    """"state" (the state-sorted driver) when the pilot's schedule leaves
    a work fraction of at most _STATE_SORT_MAX_W, else "rays"."""
    lanes, schedule = sort_mode_pilot(scene, cfg, cam, px, py, offsets, sample_start,
                                      n_samples, scan)
    work = work_fraction(cfg, lanes, schedule)
    return "state" if work is not None and work <= _STATE_SORT_MAX_W else "rays"


def _render_batch_sorted(scene, cfg, cam, px, py, offsets, sample_start, n_samples, film,
                         scan=MULTITILE_SCANS[0]):
    """The state-sorted driver (rustic_tpu/runtime/pipeline.py:1746-1866):
    per bounce a scan in the form `scan` names on whole-state-sorted rays,
    the torch shading stage, and the whole state re-sorted and compacted
    by the pilot's schedule. Compacted groups add into a side film with an
    overflow flag, read at the end of each window of
    _THROTTLE_GROUPS_SORTED groups (one host sync): a clean window's side
    film is added in, an overflowed one is rendered again uncompacted and
    compaction stops, so the schedule never biases the film. Each group's
    last shadow rays are resolved by the any-hit scan (K7 / K11 / K16)
    before the next group starts: no shadow rays are held across groups."""
    fold = pick_sample_fold(px.shape[0], n_samples, sorted_path=True)
    lanes = px.shape[0] * fold

    def run_group(k, g, schedule, film_g, oflow):
        pxg, pyg, offg = (a.repeat(g) for a in (px, py, offsets))
        st, feats, sidx, lane2px = ss_init(cfg, cam, pxg, pyg, sample_start + k, offg, g)
        prev_nee = pending = None
        for bounce in range(cfg.max_bounces):
            t, idx, prev_occ = _scan(feats, pending, scene, scan)
            window = None
            if schedule is not None and bounce < cfg.max_bounces - 1:
                window = (schedule[bounce], film_g, oflow)
            st, feats, nee, sidx, offg, lane2px, n = ss_pre(
                scene, cfg, cam, bounce, st, prev_nee, prev_occ, t, idx, sidx, offg, lane2px,
                window)
            if window is not None:
                oflow = n
            prev_nee = pending = None
            if nee is not None:
                prev_nee, pending = nee
        final_occ = None if pending is None else _occlude(pending, scene, scan) != 0
        return ss_finish(st, prev_nee, final_occ, film_g, lane2px), oflow

    schedule = _cached_pilot_schedule(scene, cfg, cam, px, py, offsets, sample_start, lanes,
                                      FI.BT_MULTI, scan)
    window_film = window_oflow = None
    window_ks = []

    def flush_window():
        nonlocal film, schedule, window_film, window_oflow, window_ks
        if not window_ks:
            return
        if bool(window_oflow):  # the schedule under-predicted: redo uncompacted
            schedule = None
            for k2 in window_ks:
                film, _ = run_group(k2, min(fold, n_samples - k2), None, film, None)
        else:
            film = film + window_film
        window_film = window_oflow = None
        window_ks = []

    for k in range(0, n_samples, fold):
        g = min(fold, n_samples - k)
        if g != fold or schedule is None:
            film, _ = run_group(k, g, None, film, None)
            continue
        if window_film is None:
            window_film = torch.zeros_like(film)
            window_oflow = torch.zeros((), dtype=torch.bool, device=film.device)
        window_film, window_oflow = run_group(k, g, schedule, window_film, window_oflow)
        window_ks.append(k)
        if len(window_ks) >= _THROTTLE_GROUPS_SORTED:
            flush_window()
    flush_window()
    return film


def _render_batch_auto(scene, cfg, cam, px, py, offsets, sample_start, n_samples, film,
                       scan=MULTITILE_SCANS[0]):
    """The "auto" pick (rustic_tpu/runtime/pipeline.py:1034-1050):
    `_pick_sort_mode` from the cached pilot; "state" takes the
    state-sorted driver, "rays" the kernel-shade loop, the port's sorted-ray
    loop on the card (where the JAX package takes its ray-sorted driver)."""
    args = (scene, cfg, cam, px, py, offsets, sample_start, n_samples, film)
    if _pick_sort_mode(*args[:-1], scan=scan) == "state":
        return _render_batch_sorted(*args, scan=scan)
    return _render_batch_ks_multitile(*args, scan=scan)


# the names of the multi-tile loops; the first is the default
MULTITILE_LOOPS = ("kernel-shade", "ray-sorted", "unsorted", "fused", "state-sorted", "auto")


def multitile_loop(loop: str):
    """The multi-tile loop named `loop` (one of MULTITILE_LOOPS). Dispatch
    is by argument: no RUSTIC_* setting is read."""
    loops = {
        "kernel-shade": _render_batch_ks_multitile,
        "ray-sorted": _render_batch_raysorted,
        "unsorted": _render_batch_unsorted,
        "fused": _render_batch_fused,
        "state-sorted": _render_batch_sorted,
        "auto": _render_batch_auto,
    }
    if loop not in loops:
        raise ValueError(f"multi-tile loop {loop!r}: expected one of {MULTITILE_LOOPS}")
    return loops[loop]


# the loops of a one-tile scene; the first is the default
SINGLE_TILE_LOOPS = ("kernel-shade", "torch-shade", "fused")


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
    loop: str = MULTITILE_LOOPS[0],
    scan: str = MULTITILE_SCANS[0],
    single_loop: str = SINGLE_TILE_LOOPS[0],
) -> torch.Tensor:
    """Render n_samples of one pixel batch -> film sum [B, 3] on the
    scene's device. px, py: [B] int32; offsets: [B] int32 (u32 bits).

    A scene of more than one triangle tile takes the multi-tile loop named
    `loop` (`multitile_loop`) with the scan form named `scan`
    (`MULTITILE_SCANS`). A scene of one tile takes the kernel-shade loop
    (`_render_batch_kernelshade`) if `single_loop` is "kernel-shade" and
    the shade kernel takes the scene (`shade_kernel.supported`); otherwise,
    or if `single_loop` is "torch-shade", the torch-shade loop
    (`_render_batch_unsorted` at one tile), which takes any scene.
    Textured scenes and HDR skies render on all of them but one: the fused
    loop (`_render_batch_fused`, "fused" as `single_loop` or as `loop`)
    takes untextured scenes under the procedural sky and raises ValueError
    on any other."""
    _check_scan(scan)
    if single_loop not in SINGLE_TILE_LOOPS:
        raise ValueError(f"single-tile loop {single_loop!r}: expected one of {SINGLE_TILE_LOOPS}")
    film = film_in if film_in is not None else torch.zeros(
        (px.shape[0], 3), dtype=torch.float32, device=px.device
    )
    args = (scene, cfg, cam, px, py, offsets, sample_start, n_samples, film)
    if FI.geometry(scene.tri_feats16)[2] > 1:
        return multitile_loop(loop)(*args, scan=scan)
    if single_loop == "fused":
        return _render_batch_fused(*args)
    if single_loop == "kernel-shade" and SK.supported(scene):
        return _render_batch_kernelshade(*args)
    return _render_batch_unsorted(*args)


def _render_batch_kernelshade(scene, cfg, cam, px, py, offsets, sample_start, n_samples, film):
    """The single-tile kernel-shade loop
    (rustic_tpu/runtime/pipeline.py:1209-1294): per bounce exactly two
    launches, a flash scan (K1, K2) and the shade kernel (K4), chained
    through the transposed row operands."""
    g16 = scene.tri_feats16
    attrs = scene.tri_attrs
    fold = pick_sample_fold(px.shape[0], n_samples)
    n_alias = scene.n_alias_entries if cfg.nee.uses_nee and scene.has_lights else 0

    def tiled(g):
        return tuple(a.repeat(g) for a in (px, py, offsets))

    def flush_held(held, film):
        st_h, sh_h, g_h = held
        return finishk(st_h, FI.occlude(sh_h, g16, scene.n_tris), film, g_h)

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
                t, i, attrs_t = FI.nearest_attrs(feats_t, g16, attrs, scene.n_tris)
                occ = None
            else:
                t, i, occ, attrs_t = FI.nearest_shadow_attrs(feats_t, pending_sh, g16, attrs,
                                                             scene.n_tris)
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
        if cfg.has_skybox:
            st = hdr_sky_payoff(scene.skybox, cam.sun_direction, st, feats_t)
        if pending_sh is not None:
            held = (st, pending_sh, g)
        else:
            film = finishk(st, None, film, g)
    if held is not None:
        film = flush_held(held, film)
    return film


def _render_batch_fused(scene, cfg, cam, px, py, offsets, sample_start, n_samples, film,
                        scan=MULTITILE_SCANS[0]):
    """The fused loop (the render loop of archive/fused_bounce): the
    single-tile kernel-shade loop with the two launches of a bounce, scan
    and shade, replaced by one launch of K17, which takes any number of
    tiles (K2's scan on one, K10's on many). The last bounce's shadow rays of a group ride the next group's
    first launch, which hands their occlusion back (`hold_occ`); the last
    group's go through the any-hit scan alone (K3 on one tile, else the
    form `scan` names). A scene outside K17's envelope raises ValueError."""
    if not FB.supported(scene, cfg):
        raise ValueError(
            "the fused loop takes untextured scenes under the procedural sky "
            f"(textures: {scene.has_textures}, HDR sky: {cfg.has_skybox}); name another loop"
        )
    g16 = scene.tri_feats16
    attrs = scene.tri_attrs
    fold = pick_sample_fold(px.shape[0], n_samples)
    n_alias = scene.n_alias_entries if cfg.nee.uses_nee and scene.has_lights else 0

    def flush_held(held, film):
        st_h, sh_h, g_h = held
        return finishk(st_h, _occlude(sh_h, scene, scan), film, g_h)

    held = None  # (st, shadow feats_t, fold) awaiting its occlusion
    for k in range(0, n_samples, fold):
        g = min(fold, n_samples - k)
        pxg, pyg, offg = (a.repeat(g) for a in (px, py, offsets))
        if held is not None and held[1].shape[1] != pxg.shape[0]:
            film = flush_held(held, film)
            held = None
        st, feats_t, sidx, params = initk(cfg, cam, pxg, pyg, sample_start + k, offg, g)
        pending_sh = held[1] if held is not None else None
        for bounce in range(cfg.max_bounces):
            holding = bounce == 0 and held is not None
            st, nf, pending_sh, occ = FB.fused_bounce(
                cfg, bounce, params, scene.entry_rows, st, feats_t, pending_sh, g16, attrs,
                sidx, offg, has_glass=scene.has_glass, n_alias=n_alias, hold_occ=holding,
                n_live=scene.n_tris, tile_aabbs=scene.tile_aabbs,
            )
            if holding:  # this occlusion result belongs to the held group
                st_h, _sh, g_h = held
                film = finishk(st_h, occ, film, g_h)
                held = None
            if nf is not None:  # the last bounce keeps its input rows
                feats_t = nf
        if pending_sh is not None:
            held = (st, pending_sh, g)
        else:
            film = finishk(st, None, film, g)
    if held is not None:
        film = flush_held(held, film)
    return film
