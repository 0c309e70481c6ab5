"""One bounce in one launch: kernel K17 and its plain twin.

Counterpart of archive/fused_bounce/fused_bounce.py (`fused_bounce`, the
Pallas kernel of `_build_kernel`): per lane, the nearest-hit scan over
every triangle tile, the winner's attribute row, the fold of the previous
bounce's shadow result, and the whole shading stage of
ops/shade_kernel.py (emission and MIS, BSDF sample, NEE alias pick and
shadow ray, roulette, the procedural sky on the last bounce).

`fused_bounce` computes what a flash scan with the row (one tile: K2, or
K1 without shadow rays; many: K10 or K9 and a row gather;
ops/flash_intersect.py) followed by the shade kernel (K4, or K8 for
alias tables over 16 entries) computes, bit for bit, in one kernel
(csrc/fused_bounce.cu): t, idx, occ and the winner's rows never reach
device memory. The layouts are the shade kernel's: state [NST, B], ray
rows [16, B], `sidx` and `offsets` as int32 bits from which the kernel
computes its LDS draws, so `initk` and `finishk` of runtime/pipeline.py
serve this loop too. The archived kernel's `prev_occ` operand has no
place here: the previous bounce's shadow rays are scanned in the same
pass. At the first bounce of a group those rays belong to the group
before it; `hold_occ` then returns their occlusion instead of folding it.

The envelope is the archived kernel's (`supported`): untextured scenes
under the procedural sky. The scan is K2's on one tile (live columns,
`pair_skip` before the exact division) and K10's on many (each ray's
slab test against the tiles' AABBs, both ray sets): the same winners as
a scan of every pair of every tile, and the same occlusion where a
shadow ray's NEE term is eligible (a dead lane's shadow ray may lose a
hit its slab test rules out, and no fold reads it). The plain version
scans every pair.
"""

from __future__ import annotations

from typing import Optional

import torch

from rustic_tpu_torch.config import StaticConfig
from rustic_tpu_torch.ops import _build
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.ops import shade_kernel as SK
from rustic_tpu_torch.scene import world as W

LAUNCHES = {"fused_bounce": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# the rows of a [16, B] ray table a scan reads: rd, ro x rd, ro, 1 (+ max t)
RAY_ROWS, SHADOW_ROWS = 10, 11


def rows_moved(has_shadow: bool, hold_occ: bool, n_next: int, n_shadow: int) -> int:
    """The f32/i32 rows per lane K17 must move (csrc/fused_bounce.cu): in,
    the used rows of the rays and, if scanned, of the shadow rays, state
    rows 0-14 (the pending NEE rows too when the shadow result is folded),
    sidx and offsets; out, the state, the n_next + n_shadow ray rows and
    a held occ. t, idx, a folded occ and the winner's slim row (read from
    the table, which stays in cache) move no row: `shade_kernel.rows_moved`
    less what stays on the SM."""
    fold = has_shadow and not hold_occ
    st_in = SK.SK_MIS_TRI + 1 + (SK.NST - SK.SK_PEND_CON.start if fold else 0)
    rows_in = RAY_ROWS + (SHADOW_ROWS if has_shadow else 0) + st_in + 2
    return rows_in + SK.NST + n_next + n_shadow + int(hold_occ)


def supported(scene, cfg: StaticConfig | None = None) -> bool:
    """Whether the fused loop takes `scene` (and a render of it under
    `cfg`): slim rows (an untextured scene) and the procedural sky."""
    return not scene.has_textures and not (cfg is not None and cfg.has_skybox)


def scan_plain(feats_t, sh_t, g16):
    """The scan of K17's plain version: every (ray, triangle) pair of
    every tile -> (t, idx, occ [B] i32 or None without shadow rays)."""
    nt = FI.geometry(g16)[2]
    if nt == 1:
        t, idx = FI.nearest_plain(feats_t, g16)
        return t, idx, None if sh_t is None else FI.occlude_plain(sh_t, g16)
    nb = -(-feats_t.shape[1] // FI.BT_MULTI)
    admit = torch.ones((nb, nt), dtype=torch.bool, device=feats_t.device)
    t, idx = FI._nearest_tiles(feats_t, g16, admit)
    return t, idx, None if sh_t is None else FI._occlude_tiles(sh_t, g16, admit)


def fused_bounce_plain(
    cfg: StaticConfig, bounce: int, params, entry_rows, st, feats_t, sh_t, g16, attrs,
    sidx, offsets, has_glass: bool = False, n_alias: int = 0, hold_occ: bool = False,
):
    """`fused_bounce` as its three stages: the scan's plain version, a
    row gather, `shade_bounce_plain`."""
    t, idx, occ = scan_plain(feats_t, sh_t, g16)
    attrs_t = attrs[idx.long()].T.contiguous()
    st_out, nf, sf = SK.shade_bounce_plain(
        cfg, bounce, params, entry_rows, st, feats_t, t, idx, attrs_t,
        None if hold_occ else occ, sidx, offsets, has_glass=has_glass, n_alias=n_alias,
    )
    return st_out, nf, sf, occ if hold_occ else None


def scan_operands(g16, n_live, tile_aabbs, device) -> int:
    """Check the scan's operands of a K17 call on `device` -> the live
    triangles it walks: `n_live` in 1..the table's width (None: the whole
    width); on many tiles a CUDA call takes the tiles' AABBs [NT, 8]."""
    t_pad, _, nt = FI.geometry(g16)
    live = FI.live_count(n_live, t_pad)
    if nt > 1 and device.type == "cuda" and tile_aabbs is None:
        raise ValueError("K17 on many tiles takes tile_aabbs on a CUDA device (each ray's "
                         "slab test)")
    if tile_aabbs is not None:
        _build.check(tile_aabbs, "tile_aabbs", torch.float32, (nt, 8), device)
    return live


def fused_bounce(
    cfg: StaticConfig, bounce: int, params, entry_rows, st, feats_t, sh_t, g16, attrs,
    sidx, offsets, has_glass: bool = False, n_alias: int = 0, hold_occ: bool = False,
    n_live: Optional[int] = None, tile_aabbs=None,
):
    """K17 (replaces archive/fused_bounce `fused_bounce`): one bounce of
    scan and shading over B lanes.

    params [1, 8], entry_rows [L_pad, 48], st [NST, B], sidx, offsets [B]
    i32 as `shade_kernel.shade_bounce` takes them; feats_t [16, B], this
    bounce's rays; sh_t [16, B], the previous bounce's shadow rays (max t
    in row SH_MAXT_COL), or None; g16 [16, NT*4*TT], the triangle table;
    attrs [NT*TT, SLIM_WIDTH], the slim shading rows. With `hold_occ` the
    shadow rays' occlusion is returned ([B] i32) and not folded into the
    state. `n_live`: the live triangles (the scene's `n_tris`; None: the
    table's width); `tile_aabbs` [NT, 8]: the tiles' AABBs, required on
    many tiles on a CUDA device (`scan_operands`). The plain version (CPU)
    checks both and scans every pair. Returns (st_out, next rays or None
    on the last bounce, shadow rays or None without NEE, occ or None)."""
    if hold_occ and sh_t is None:
        raise ValueError("hold_occ needs shadow rays")
    if cfg.has_skybox:
        raise ValueError("the fused bounce kernel renders the procedural sky only")
    live = scan_operands(g16, n_live, tile_aabbs, st.device)
    if _build.uses_plain(st):
        return fused_bounce_plain(
            cfg, bounce, params, entry_rows, st, feats_t, sh_t, g16, attrs, sidx, offsets,
            has_glass=has_glass, n_alias=n_alias, hold_occ=hold_occ,
        )
    dev = st.device
    b = st.shape[1]
    t_pad, tt, nt = FI.geometry(g16)
    uses_nee = cfg.nee.uses_nee and n_alias > 0
    last = bounce == cfg.max_bounces - 1
    check = _build.check
    check(params, "params", torch.float32, (1, 8), dev)
    check(entry_rows, "entry_rows", torch.float32, (entry_rows.shape[0], W.ENTRY_WIDTH), dev)
    if uses_nee and entry_rows.shape[0] < n_alias:
        raise ValueError(f"entry_rows has {entry_rows.shape[0]} rows, n_alias={n_alias}")
    check(st, "st", torch.float32, (SK.NST, b), dev)
    check(feats_t, "feats_t", torch.float32, (16, b), dev)
    if sh_t is not None:
        check(sh_t, "shadow feats_t", torch.float32, (16, b), dev)
    check(g16, "tri_feats16", torch.float32, (16, 4 * t_pad), dev)
    check(attrs, "tri_attrs", torch.float32, (t_pad, W.SLIM_WIDTH), dev)
    check(sidx, "sidx", torch.int32, (b,), dev)
    check(offsets, "offsets", torch.int32, (b,), dev)

    st_out = torch.empty((SK.NST, b), dtype=torch.float32, device=dev)
    nf = None if last else torch.empty((16, b), dtype=torch.float32, device=dev)
    sf = torch.empty((16, b), dtype=torch.float32, device=dev) if uses_nee else None
    occ = torch.empty(b, dtype=torch.int32, device=dev) if hold_occ else None
    if b:
        _build.launch(
            _build.entry_point("fused_bounce", "rt_fused_bounce", 15, 14), "fused_bounce", dev,
            (params, entry_rows, st, feats_t, sh_t, FI.packed_table(g16),
             tile_aabbs if nt > 1 else None, attrs, sidx, offsets, SK._lds_primes(dev), st_out,
             nf, sf, occ),
            (b, nt, tt, W.SLIM_WIDTH, live, bounce, cfg.min_bounces, cfg.max_bounces,
             int(cfg.nee), int(uses_nee), int(has_glass), n_alias, entry_rows.shape[0],
             int(n_alias > SK.MAX_ALIAS)),
        )
        LAUNCHES["fused_bounce"] += 1
    return st_out, nf, sf, occ
