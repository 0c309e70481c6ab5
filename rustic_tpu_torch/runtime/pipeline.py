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

Multi-tile scenes take one of three loops, named by the caller's
`loop` argument (`MULTITILE_LOOPS`):

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

Each multi-tile scan takes the form the caller's `scan` argument names
(`MULTITILE_SCANS`): "lists" (the default), `block_tile_lists` in torch
and then K5/K6/K7; "grid", K9/K10/K11, which cull tiles per ray in the
kernel and need no lists; or "resident", K14/K15/K16, the same cull with
the whole triangle table held in a thread-block cluster's shared memory
(a scene that does not fit there is refused).

The three give the same film; kernel-shade is the fastest on the card.
The other two are the ports of the JAX package's XLA-shade drivers,
kept as the references the tests hold the default to.

In every loop the last bounce's shadow rays of a group are held and ride
the next group's bounce-0 scan (K2 / K13 / K6 / K10 / K15); the last
group's are resolved by K3 / K7 / K11 / K16. With an HDR skybox (`cfg.has_skybox`) the
kernel-shade loops add the image sky to the escaped lanes after a group's
last bounce (`hdr_sky_payoff`), the reference loops in `bounce_pre`. All
work is queued on the tensors' device; nothing waits for it.
"""

from __future__ import annotations

import os
from typing import Optional

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


STATE_SORT_TODO = (
    "RUSTIC_SORT_MODE=state (the state-sorted driver with its compaction "
    "pilot) is not ported yet (ROADMAP.md queue 1 item 7)"
)

# the names of the multi-tile loops; the first is the default
MULTITILE_LOOPS = ("kernel-shade", "ray-sorted", "unsorted", "fused")


def multitile_loop(loop: str):
    """The multi-tile loop named `loop` (one of MULTITILE_LOOPS). The JAX
    package's RUSTIC_SORT_MODE=state asks for its state-sorted driver,
    which the port lacks: that setting is refused rather than ignored."""
    if os.environ.get("RUSTIC_SORT_MODE") == "state":
        raise NotImplementedError(STATE_SORT_TODO)
    if loop == "kernel-shade":
        return _render_batch_ks_multitile
    if loop == "ray-sorted":
        return _render_batch_raysorted
    if loop == "unsorted":
        return _render_batch_unsorted
    if loop == "fused":
        return _render_batch_fused
    raise ValueError(f"multi-tile loop {loop!r}: expected one of {MULTITILE_LOOPS}")


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
    on any other. The state-sorted driver is not ported and raises
    NotImplementedError."""
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
