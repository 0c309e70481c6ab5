"""Flash intersection: kernels K1-K3 and K12-K13 (one triangle tile),
K5-K7, K9-K11 and K14-K16 (many tiles) and their plain twins.

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
- `nearest` (K12) and `nearest_shadow` (K13): K1 and K2 without the row;
  the caller gathers the winner's row itself (`gather_attr_rows`), at the
  width of the scene's table. The scans of the torch-shade loop at one
  tile and of the single-program integrator.

Scenes of more than 512 triangles are NT tiles of 512. For each block
of BT_MULTI rays, `block_tile_lists` finds the tiles some ray of the
block may hit (an interval slab test against the tile AABBs, the twin of
the JAX package's XLA `_block_tile_lists`); the multi-tile scans walk
only those tiles, in ascending order:

- `nearest_multi` (K5): nearest hit over the admitted tiles; the index
  is global (j·TT + local).
- `nearest_shadow_multi` (K6): K5 on the tiles the first ray set admits
  (list bit 20), plus any-hit of a second ray set on the tiles it admits
  (bit 21).
- `occlude_multi` (K7): the any-hit test alone.

Given `tile_aabbs`, K5 and K6 also run each ray's own slab test (below)
inside the listed tiles for the nearest set.

The grid form (K9-K11: `nearest_grid`, `nearest_shadow_grid`,
`occlude_grid`) computes what K5-K7 compute without lists: each block
walks all NT tiles in ascending order, and each ray runs a tile's pair
tests only where its own slab test against the tile's AABB passes, with
its running best t as the limit for the nearest set and its max t for
the any-hit set (`_tile_possible` of the JAX package's `_nearest_multi`
and its twins). A block stages a tile only when one of its rays needs
it; the wrappers' `visits` argument receives those tiles per block.

The resident form (K14-K16: `nearest_resident`,
`nearest_shadow_resident`, `occlude_resident`) computes the same again
with the whole triangle table staged once into the shared memory of a
thread-block cluster (`use_resident` says whether it fits and how it is
spread); each rank of the cluster tests a block of rays against its own
chunks of the table only (`rank_scan` is that order of work in torch),
and the ranks' winners are merged. A scene that does not fit is
refused.

Each wrapper runs the plain PyTorch version for CPU tensors and the
CUDA kernel (csrc/flash_intersect.cu, csrc/flash_multi.cu,
csrc/flash_resident.cu) for CUDA tensors; it counts its kernel launches
in LAUNCHES. The wrappers take `n_live`, the scene's live triangles
(`SceneTensors.n_tris`; None: the whole table): their kernels walk only
those columns, the one-tile, list and grid forms from a copy of the
table packed once (`packed_table`). The kernels divide only for
the pairs that `pair_skip` cannot prove irrelevant; `skip_scan` is their
scan rebuilt in torch from it, bit for bit the plain versions' result.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from rustic_tpu_torch.ops import _build
from rustic_tpu_torch.ops.sampling import EPS

BIG = 1e6
DET_EPS = 1e-6
SH_MAXT_COL = 10
MAX_TT = 512  # triangles per tile
BT_MULTI = 256  # rays per block of the multi-tile scans (pick_bt)
_LIST_ID_MASK = (1 << 20) - 1
_SET_BIT = (1 << 20, 1 << 21)  # list flag of ray set 0 and 1

# rays per plain-version chunk: keeps the [chunk, 4·TT] f32 product near 1 GB
_PLAIN_CHUNK_BYTES = 1 << 30

LAUNCHES = {
    "nearest_attrs": 0, "nearest_shadow_attrs": 0, "occlude": 0,
    "nearest_multi": 0, "nearest_shadow_multi": 0, "occlude_multi": 0,
    "nearest_grid": 0, "nearest_shadow_grid": 0, "occlude_grid": 0,
    "nearest": 0, "nearest_shadow": 0,
    "nearest_resident": 0, "nearest_shadow_resident": 0, "occlude_resident": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- plain PyTorch versions -------------------------------------------------


def geometry(g16: torch.Tensor):
    """[16, NT*4*TT] triangle table -> (T_pad, TT, NT)."""
    t_pad = g16.shape[1] // 4
    if g16.shape[0] != 16 or g16.shape[1] != 4 * t_pad or t_pad == 0:
        raise ValueError(f"triangle table must be [16, NT*4*TT], got {tuple(g16.shape)}")
    tt = min(t_pad, MAX_TT)
    if t_pad % tt:
        raise ValueError(f"{t_pad} triangles do not fill whole tiles of {tt}")
    return t_pad, tt, t_pad // tt


def _tile_width(g16: torch.Tensor) -> int:
    """The tile width TT of a one-tile table (all K1-K3, K12-K13 take)."""
    _, tt, nt = geometry(g16)
    if nt > 1:
        raise NotImplementedError(
            "K1-K3 and K12-K13 scan one tile; multi-tile scenes (more than 512 triangles) "
            "go through the multi-tile scans (nearest_multi and its twins)"
        )
    return tt


def _chunks(b: int, tt: int):
    step = max(1, _PLAIN_CHUNK_BYTES // (16 * tt))
    for lo in range(0, b, step):
        yield lo, min(lo + step, b)


def _exact(det, u_num, v_num, t_num):
    """The exact epilogue on a pair's numerators -> (t, valid)."""
    good = det.abs() >= DET_EPS
    inv = torch.where(good, torch.reciprocal(torch.where(good, det, 1.0)), 0.0)
    u = u_num * inv
    v = v_num * inv
    t = t_num * inv
    valid = good & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
    return t, valid


def _numerators(raw, tt: int, lo: int = 0, hi: Optional[int] = None):
    """Columns [lo, hi) of the det, u, v and t blocks of a [c, 4·TT]
    product of ray rows with one tile."""
    hi = tt if hi is None else hi
    return tuple(raw[:, q * tt + lo : q * tt + hi] for q in range(4))


def _epilogue(f_t: torch.Tensor, g16: torch.Tensor, tt: int):
    """[16, c] ray rows -> (t, valid) [c, TT] (flash_intersect._epilogue)."""
    return _exact(*_numerators(f_t.T @ g16, tt))


def _nearest_chunk(f_t, g16, tt):
    t, valid = _epilogue(f_t, g16, tt)
    tm = torch.where(valid, t, BIG)
    idx = torch.argmin(tm, dim=1)  # first index among equal minima
    return tm.gather(1, idx[:, None])[:, 0], idx.to(torch.int32)


def _anyhit_chunk(sh_t, g16, tt):
    t, valid = _epilogue(sh_t, g16, tt)
    hit = valid & (t <= sh_t[SH_MAXT_COL][:, None])
    return hit.any(dim=1).to(torch.int32)


def nearest_plain(feats_t, g16):
    """[16, B] rays -> (t [B] f32, idx [B] i32): the nearest hit in the
    one tile, BIG and 0 on a miss."""
    tt = _tile_width(g16)
    b = feats_t.shape[1]
    t = torch.empty(b, dtype=torch.float32, device=feats_t.device)
    idx = torch.empty(b, dtype=torch.int32, device=feats_t.device)
    for lo, hi in _chunks(b, tt):
        t[lo:hi], idx[lo:hi] = _nearest_chunk(feats_t[:, lo:hi], g16, tt)
    return t, idx


def nearest_shadow_plain(feats_t, sh_t, g16):
    """`nearest_plain` on `feats_t` plus any-hit on `sh_t` ->
    (t, idx, occ [B] i32)."""
    t, idx = nearest_plain(feats_t, g16)
    return t, idx, occlude_plain(sh_t, g16)


def nearest_attrs_plain(feats_t, g16, attrs):
    """[16, B] rays -> (t [B] f32, idx [B] i32, attrsT [W, B] f32)."""
    t, idx = nearest_plain(feats_t, g16)
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


# ---- multi-tile: admitted-tile lists and plain versions --------------------


def _interval_mul(a_lo, a_hi, b_lo, b_hi):
    """Interval product bounds: [a]*[b] via the four corner products."""
    p1 = a_lo * b_lo
    p2 = a_lo * b_hi
    p3 = a_hi * b_lo
    p4 = a_hi * b_hi
    return (
        torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
        torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)),
    )


def _pad_rays_t(feats_t, bt: int):
    """[16, B] rows -> [16, B_pad] with zero rays up to a multiple of bt."""
    pad = (-feats_t.shape[1]) % bt
    return torch.nn.functional.pad(feats_t, (0, pad)) if pad else feats_t


def block_admits(feats_t, tile_aabbs, bt: int, use_maxt: bool):
    """Conservative per-(ray block, tile) slab admits [nb, NT] bool by
    interval arithmetic over each block's origin, inverse-direction and
    max-t ranges; `feats_t` is [16, nb*bt]. Any tile a ray of the block
    could hit is admitted (twin of rustic_tpu's `_block_admits`)."""
    nb = feats_t.shape[1] // bt
    f3 = feats_t.reshape(16, nb, bt)
    ro = f3[6:9]
    rd = f3[0:3]
    inv = torch.where(
        rd.abs() < 1e-12, torch.where(rd < 0, -1e12, 1e12), torch.reciprocal(rd)
    )
    o_lo, o_hi = ro.amin(-1), ro.amax(-1)  # [3, nb]
    iv_lo, iv_hi = inv.amin(-1), inv.amax(-1)
    if use_maxt:
        limit_hi = f3[SH_MAXT_COL].amax(-1)  # [nb]
    else:
        limit_hi = torch.full((nb,), BIG, dtype=torch.float32, device=feats_t.device)
    lo_t = tile_aabbs[:, 0:3]  # [nt, 3]
    hi_t = tile_aabbs[:, 4:7]
    tmin_lo = tmax_hi = None
    for a in range(3):
        ivl, ivh = iv_lo[a][:, None], iv_hi[a][:, None]
        t1_lo, t1_hi = _interval_mul(
            lo_t[:, a][None, :] - o_hi[a][:, None], lo_t[:, a][None, :] - o_lo[a][:, None],
            ivl, ivh,
        )
        t2_lo, t2_hi = _interval_mul(
            hi_t[:, a][None, :] - o_hi[a][:, None], hi_t[:, a][None, :] - o_lo[a][:, None],
            ivl, ivh,
        )
        slo_lo = torch.minimum(t1_lo, t2_lo)  # lower bound of min(t1, t2)
        shi_hi = torch.maximum(t1_hi, t2_hi)  # upper bound of max(t1, t2)
        tmin_lo = slo_lo if tmin_lo is None else torch.maximum(tmin_lo, slo_lo)
        tmax_hi = shi_hi if tmax_hi is None else torch.minimum(tmax_hi, shi_hi)
    return (tmax_hi >= tmin_lo) & (tmax_hi > 0.0) & (tmin_lo < limit_hi[:, None])


def block_tile_lists(tile_aabbs, bt: int, maxt_flags, *feats_sets):
    """Admitted-tile lists of the multi-tile scans: for each block of bt
    rays, the ascending ids of the tiles any of the ray sets may hit,
    each with bit 20 + i set where ray set i admits it, then the other
    tiles without flags -> (lists [nb, NT] i32, counts [nb] i32).

    `feats_sets` are [16, B] rows; B is padded with zero rays to a whole
    block as the JAX package pads it, so the lists equal its
    `_block_tile_lists` (which returns them transposed, padded to 128
    blocks)."""
    nt = tile_aabbs.shape[0]
    admits = [
        block_admits(_pad_rays_t(f, bt), tile_aabbs, bt, use_maxt)
        for f, use_maxt in zip(feats_sets, maxt_flags)
    ]
    nb = admits[0].shape[0]
    iota = torch.arange(nt, dtype=torch.int32, device=tile_aabbs.device).expand(nb, nt)
    packed = iota
    any_ok = admits[0]
    for i, m in enumerate(admits):
        packed = packed + torch.where(m, _SET_BIT[i], 0).to(torch.int32)
        any_ok = any_ok | m
    # stable ascending compaction: admitted ids first, in tile order
    order = torch.argsort(torch.where(any_ok, iota, iota + nt), dim=1)
    lists = torch.gather(packed, 1, order).to(torch.int32).contiguous()
    return lists, any_ok.sum(dim=1, dtype=torch.int32)


def _admit_table(lists, counts, nt: int, ray_set: int):
    """[nb, NT] bool: tile j is on block i's list for `ray_set`."""
    listed = torch.arange(nt, device=lists.device)[None, :] < counts[:, None]
    ok = listed & ((lists & _SET_BIT[ray_set]) != 0)
    table = torch.zeros(lists.shape, dtype=torch.bool, device=lists.device)
    return table.scatter_(1, (lists & _LIST_ID_MASK).long(), ok)


def _tiles(g16, tt: int, nt: int):
    """(j, G columns of tile j) for every tile, ascending."""
    for j in range(nt):
        yield j, g16[:, j * 4 * tt : (j + 1) * 4 * tt]


def _nearest_tiles(feats_t, g16, admit):
    """Nearest hit over the admitted tiles: per chunk of rays, each tile's
    (min, first argmin), masked to BIG where the ray's block does not
    admit the tile, folded in ascending tile order with a strict <."""
    b = feats_t.shape[1]
    dev = feats_t.device
    _, tt, nt = geometry(g16)
    t = torch.full((b,), BIG, dtype=torch.float32, device=dev)
    idx = torch.zeros(b, dtype=torch.int32, device=dev)
    block = torch.arange(b, device=dev) // BT_MULTI
    for lo, hi in _chunks(b, tt):
        f, blk = feats_t[:, lo:hi], block[lo:hi]
        t_c, i_c = t[lo:hi], idx[lo:hi]
        for j, gj in _tiles(g16, tt, nt):
            tile_min, tile_arg = _nearest_chunk(f, gj, tt)
            tile_min = torch.where(admit[blk, j], tile_min, BIG)
            better = tile_min < t_c
            t_c = torch.where(better, tile_min, t_c)
            i_c = torch.where(better, tile_arg + j * tt, i_c)
        t[lo:hi], idx[lo:hi] = t_c, i_c
    return t, idx


def _occlude_tiles(sh_t, g16, admit):
    """Any hit within (EPS, maxt] over the admitted tiles -> [B] i32."""
    b = sh_t.shape[1]
    dev = sh_t.device
    _, tt, nt = geometry(g16)
    occ = torch.zeros(b, dtype=torch.int32, device=dev)
    block = torch.arange(b, device=dev) // BT_MULTI
    for lo, hi in _chunks(b, tt):
        f, blk = sh_t[:, lo:hi], block[lo:hi]
        o = occ[lo:hi]
        for j, gj in _tiles(g16, tt, nt):
            o = o | (_anyhit_chunk(f, gj, tt) & admit[blk, j].to(torch.int32))
        occ[lo:hi] = o
    return occ


def nearest_multi_plain(feats_t, g16, lists, counts):
    """[16, B] rays, admitted-tile lists -> (t [B] f32, idx [B] i32)."""
    return _nearest_tiles(feats_t, g16, _admit_table(lists, counts, geometry(g16)[2], 0))


def nearest_shadow_multi_plain(feats_t, sh_t, g16, lists, counts):
    """K5 on `feats_t` (list bit 20) plus any-hit on `sh_t` (bit 21) ->
    (t, idx, occ [B] i32)."""
    nt = geometry(g16)[2]
    t, idx = _nearest_tiles(feats_t, g16, _admit_table(lists, counts, nt, 0))
    return t, idx, _occlude_tiles(sh_t, g16, _admit_table(lists, counts, nt, 1))


def occlude_multi_plain(sh_t, g16, lists, counts):
    """[16, B] shadow rows (maxt in row SH_MAXT_COL) -> occ [B] i32."""
    return _occlude_tiles(sh_t, g16, _admit_table(lists, counts, geometry(g16)[2], 0))


# ---- multi-tile, grid form: the per-ray AABB cull without lists -----------


def _inv_dir(rd):
    """1/rd with |rd| < 1e-12 clamped to +-1e12 (`_tile_possible`)."""
    return torch.where(rd.abs() < 1e-12, torch.where(rd < 0, -1e12, 1e12), torch.reciprocal(rd))


def _slab_spans(rays_t, tile_aabbs):
    """Each ray's slab interval against every tile AABB: rays_t [16, c] ->
    (tmin, tmax) [c, NT], min/max propagating NaN as jnp's do."""
    ro, inv = rays_t[6:9], _inv_dir(rays_t[0:3])
    tmin = tmax = None
    for a in range(3):
        t1 = (tile_aabbs[:, a][None, :] - ro[a][:, None]) * inv[a][:, None]
        t2 = (tile_aabbs[:, 4 + a][None, :] - ro[a][:, None]) * inv[a][:, None]
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = lo if tmin is None else torch.maximum(tmin, lo)
        tmax = hi if tmax is None else torch.minimum(tmax, hi)
    return tmin, tmax


def _slab_ok(tmin, tmax, limit):
    return (tmax >= tmin) & (tmax > 0.0) & (tmin < limit)


def _grid_scan(feats_t, sh_t, g16, tile_aabbs):
    """The grid form over the nearest set `feats_t` and/or the any-hit set
    `sh_t` (either may be None) -> (t, idx, occ, visits [nb] i32,
    tested [2, NT] i64, warp_tiles [2, NT] i64). Per chunk of rays, tiles
    in ascending order: a ray tests tile j where its slab test passes
    (limit: its running best t, or its max t while not yet occluded), the
    nearest fold keeps a strict <, and a block visits tile j when any of
    its rays tests it. tested[s, j]: the rays of set s (0 nearest, 1
    any-hit) that tested tile j; warp_tiles[s, j]: the warps (32
    consecutive rays) in which some ray of set s tested tile j."""
    rays = feats_t if feats_t is not None else sh_t
    b = rays.shape[1]
    dev = rays.device
    _, tt, nt = geometry(g16)
    t = torch.full((b,), BIG, dtype=torch.float32, device=dev)
    idx = torch.zeros(b, dtype=torch.int32, device=dev)
    occ = torch.zeros(b, dtype=torch.int32, device=dev)
    tested = torch.zeros((2, nt, b), dtype=torch.bool, device=dev)  # [set, tile, ray]
    for lo, hi in _chunks(b, tt):
        f = feats_t[:, lo:hi] if feats_t is not None else None
        s = sh_t[:, lo:hi] if sh_t is not None else None
        t_c, i_c, o_c = t[lo:hi], idx[lo:hi], occ[lo:hi]
        if f is not None:
            n_min, n_max = _slab_spans(f, tile_aabbs)
        if s is not None:
            s_min, s_max = _slab_spans(s, tile_aabbs)
            maxt = s[SH_MAXT_COL]
        for j, gj in _tiles(g16, tt, nt):
            near_ok = any_ok = torch.zeros_like(tested[0, j, lo:hi])
            if f is not None:
                near_ok = _slab_ok(n_min[:, j], n_max[:, j], t_c)
                tile_min, tile_arg = _nearest_chunk(f, gj, tt)
                better = near_ok & (tile_min < t_c)
                t_c = torch.where(better, tile_min, t_c)
                i_c = torch.where(better, tile_arg + j * tt, i_c)
            if s is not None:
                any_ok = (o_c == 0) & _slab_ok(s_min[:, j], s_max[:, j], maxt)
                o_c = o_c | (_anyhit_chunk(s, gj, tt) & any_ok.to(torch.int32))
            tested[0, j, lo:hi], tested[1, j, lo:hi] = near_ok, any_ok
        t[lo:hi], idx[lo:hi], occ[lo:hi] = t_c, i_c, o_c
    nb = -(-b // BT_MULTI)
    tested = torch.nn.functional.pad(tested, (0, nb * BT_MULTI - b))
    visits = tested.any(dim=0).reshape(nt, nb, BT_MULTI).any(dim=2).sum(dim=0, dtype=torch.int32)
    per_set = tested.sum(dim=2)
    warp_tiles = tested.reshape(2, nt, -1, 32).any(dim=3).sum(dim=2)
    return t, idx, occ, visits, per_set, warp_tiles


def nearest_grid_plain(feats_t, g16, tile_aabbs):
    """[16, B] rays -> (t [B] f32, idx [B] i32), the grid form."""
    t, idx = _grid_scan(feats_t, None, g16, tile_aabbs)[:2]
    return t, idx


def nearest_shadow_grid_plain(feats_t, sh_t, g16, tile_aabbs):
    """The grid form of the merged scan -> (t, idx, occ [B] i32)."""
    return _grid_scan(feats_t, sh_t, g16, tile_aabbs)[:3]


def occlude_grid_plain(sh_t, g16, tile_aabbs):
    """[16, B] shadow rows -> occ [B] i32, the grid form."""
    return _grid_scan(None, sh_t, g16, tile_aabbs)[2]


# ---- the skip test (twin of csrc/flash_common.cuh pair_skip) --------------

SKIP_DELTA = 2.0**-20
_SIGN = -(2**31)  # the sign bit of an int32 view of a float32
_NO_KEY = torch.iinfo(torch.int64).max


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def skip_limit(limit: torch.Tensor) -> torch.Tensor:
    """rn(limit (1 + 2^-20)), in float32 as the kernels round it."""
    return limit * _f32(1.0 + SKIP_DELTA).to(limit.device)


def pair_skip(det, u_num, v_num, t_num, lim) -> torch.Tensor:
    """True where a pair's numerators prove that the exact epilogue rejects
    it, or that its t is above lim / (1 + 2^-20) (`lim` from
    `skip_limit` of the running best t, or of the max t): the scans then
    skip its division. Float32 with the kernels' roundings; NaN and inf
    never skip."""
    dev = det.device
    sign = det.view(torch.int32) & _SIGN
    d = det.abs()
    a, b, c = ((x.view(torch.int32) ^ sign).view(torch.float32) for x in (u_num, v_num, t_num))
    tiny = -(d * _f32(2.0**-100).to(dev))
    eps_lo = _f32(EPS).to(dev) * _f32(1.0 - SKIP_DELTA).to(dev)
    return ((d < DET_EPS) | (a < tiny) | (b < tiny)
            | (a + b > d * _f32(1.0 + SKIP_DELTA).to(dev))
            | (c <= d * eps_lo) | (c > d * lim))


def win_key(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(t bits << 32) | idx as int64: for t >= 0 the smaller key is the
    smaller t, then the first index (csrc/flash_common.cuh win_key)."""
    return (t.view(torch.int32).to(torch.int64) << 32) | idx.to(torch.int64)


def win_t(key: torch.Tensor) -> torch.Tensor:
    return (key >> 32).to(torch.int32).view(torch.float32)


def win_idx(key: torch.Tensor) -> torch.Tensor:
    return (key & 0xFFFFFFFF).to(torch.int32)


def live_count(n_live: Optional[int], width: int) -> int:
    """The live triangles a scan walks: `n_live`, or the whole table
    `width` for None; anything outside 1..width is refused."""
    if n_live is None:
        return width
    if isinstance(n_live, bool) or not isinstance(n_live, int) or not 1 <= n_live <= width:
        raise ValueError(f"n_live must be an int in 1..{width} (the table's width), got {n_live!r}")
    return n_live


def _warp_any(mask: torch.Tensor) -> torch.Tensor:
    """[c, n] lanes x triangles -> [ceil(c / 32), n]: some lane of the warp."""
    pad = (-mask.shape[0]) % 32
    if pad:
        mask = torch.nn.functional.pad(mask, (0, 0, 0, pad))
    return mask.reshape(-1, 32, mask.shape[1]).any(dim=1)


def skip_scan(feats_t, sh_t, g16, tile_aabbs=None, n_live=None, chunk: int = 32, lists=None):
    """The kernels' scans rebuilt from `pair_skip` and the exact epilogue,
    on the plain versions' numerators: the nearest set `feats_t` and/or
    the any-hit set `sh_t` (either may be None) over the first `n_live`
    triangles, chunk by chunk with the running best t as the limit. One
    tile (`tile_aabbs` and `lists` None): K1-K3's fold from t = inf, no
    skip while the best is above BIG. Many tiles: from (BIG, 0), the tiles
    the per-ray slab test against `tile_aabbs` admits (K9-K11), or with
    `lists` = (lists, counts) of `block_tile_lists` the tiles its block's
    row admits for the ray's set (K5-K7), within those also the nearest
    set's per-ray slab test where `tile_aabbs` is given. -> (t, idx, occ,
    stats); stats [2 sets, 4] i64 = pairs tested, pairs sent to the exact
    epilogue, warp iterations (32 consecutive rays x one triangle) with a
    pair tested, and those with a pair sent to the exact epilogue. Equal
    to the plain versions bit for bit where the skip test is sound."""
    key, occ, stats = _skip_walk(feats_t, sh_t, g16, tile_aabbs, n_live, chunk, lists)
    t = win_t(key) if feats_t is not None else None
    idx = win_idx(key) if feats_t is not None else None
    return t, idx, (occ.to(torch.int32) if sh_t is not None else None), stats


def _skip_walk(feats_t, sh_t, g16, tile_aabbs, n_live, chunk, lists=None, owned=None):
    """`skip_scan`'s walk -> (win_key [B] i64, occ [B] bool, stats); `owned`
    (tile -> [(c0, c1)] column ranges of the tile) limits it to part of
    each tile's columns."""
    rays = feats_t if feats_t is not None else sh_t
    b, dev = rays.shape[1], rays.device
    t_pad, tt, nt = geometry(g16)
    live = live_count(n_live, t_pad)
    many = tile_aabbs is not None or lists is not None
    cull = tile_aabbs is not None
    if not many and nt > 1:
        raise NotImplementedError("a one-tile scan takes a one-tile table")
    start = BIG if many else float("inf")
    key = win_key(torch.full((b,), start, dtype=torch.float32, device=dev),
                  torch.zeros(b, dtype=torch.int32, device=dev))
    occ = torch.zeros(b, dtype=torch.bool, device=dev)
    stats = torch.zeros((2, 4), dtype=torch.int64, device=dev)
    every = torch.ones(b, dtype=torch.bool, device=dev)
    listed = [every[:, None].expand(b, nt)] * 2
    if lists is not None:
        block = torch.arange(b, device=dev) // BT_MULTI
        sets = (0, 1) if feats_t is not None else (None, 0)
        listed = [every[:, None].expand(b, nt) if s is None
                  else _admit_table(*lists, nt, s)[block] for s in sets]
    if cull and feats_t is not None:
        n_min, n_max = _slab_spans(feats_t, tile_aabbs)
    if sh_t is not None:
        maxt = sh_t[SH_MAXT_COL]
        lim_s = skip_limit(maxt)
        if cull:
            s_min, s_max = _slab_spans(sh_t, tile_aabbs)
    for j, gj in _tiles(g16, tt, nt):
        n_j = min(max(live - j * tt, 0), tt)
        near_ok = listed[0][:, j] & (_slab_ok(n_min[:, j], n_max[:, j], win_t(key))
                                     if cull and feats_t is not None else every)
        any_ok = listed[1][:, j] & ~occ & (_slab_ok(s_min[:, j], s_max[:, j], maxt)
                                           if cull and lists is None and sh_t is not None
                                           else every)
        raw_f = feats_t.T @ gj if feats_t is not None else None
        raw_s = sh_t.T @ gj if sh_t is not None else None
        # one tile: the first column alone (the fold from inf takes it exactly)
        first = 0 if many else 1
        spans = [(0, first)] if first else []
        for a, z in (owned(j) if owned is not None else [(first, n_j)]):
            z = min(z, n_j)
            spans += [(c0, min(c0 + chunk, z)) for c0 in range(a, z, chunk)]
        for c0, c1 in spans:
            cols = torch.arange(j * tt + c0, j * tt + c1, dtype=torch.int32, device=dev)
            if raw_f is not None:
                num = _numerators(raw_f, tt, c0, c1)
                best = win_t(key)
                test = near_ok[:, None] & (~pair_skip(*num, skip_limit(best)[:, None])
                                           | ~(best <= BIG)[:, None])
                t, valid = _exact(*num)
                cand = torch.where(test, win_key(torch.where(valid, t, BIG), cols), _NO_KEY)
                key = torch.minimum(key, cand.amin(dim=1))
                _count(stats[0], near_ok[:, None].expand_as(test), test)
            if raw_s is not None:
                num = _numerators(raw_s, tt, c0, c1)
                ok = any_ok & ~occ  # rays still looking at the chunk's start
                test = ok[:, None] & ~pair_skip(*num, lim_s[:, None])
                t, valid = _exact(*num)
                occ = occ | (test & valid & (t <= maxt[:, None])).any(dim=1)
                _count(stats[1], ok[:, None].expand_as(test), test)
    return key, occ, stats


def _count(row, tested, exact) -> None:
    row += torch.stack([tested.sum(), exact.sum(), _warp_any(tested).sum(),
                        _warp_any(exact).sum()])


# ---- multi-tile, resident form: the table in a cluster's shared memory -----

CHUNK = 128  # triangles per staged chunk (csrc/flash_common.cuh)
CHUNK_BYTES = 10 * CHUNK * 16  # ten rows of one float4 per triangle


class ResidentPlan(NamedTuple):
    """How a triangle table is spread over a thread-block cluster: chunk k
    of CHUNK triangles lives on rank k % cluster, in slot k // cluster."""

    cluster: int  # blocks of the cluster
    chunks_per_rank: int  # slots each rank holds

    @property
    def bytes_per_rank(self) -> int:
        return self.chunks_per_rank * CHUNK_BYTES


@functools.lru_cache(maxsize=None)
def _cuda_budget(index: int):
    """(shared-memory bytes a block may give to chunks of the table: what
    it may opt in to, less what a rank keeps besides; largest portable
    cluster) of CUDA device `index`, asked of the device through
    csrc/flash_resident.cu."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(index):
        rc = _build.entry_point("flash_resident", "rt_resident_limits", 1, 0)(
            ctypes.addressof(out), None)
    if rc != 0:
        raise RuntimeError(f"rt_resident_limits failed: cudaError {rc}")
    if out[1] != CHUNK_BYTES:
        raise RuntimeError(f"a staged chunk is {out[1]} bytes in the kernels, {CHUNK_BYTES} here")
    return out[0], out[2]


def resident_budget(device):
    """What `device` offers the resident scans -> (shared-memory bytes of
    one block for the table's chunks, largest cluster), read from the
    device's properties; None for the CPU, whose plain versions hold the
    table in no fast memory."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return _cuda_budget(torch.cuda.current_device() if device.index is None else device.index)


def use_resident(g16) -> Optional[ResidentPlan]:
    """The resident form's plan for triangle table `g16` on its device, or
    None where the form does not apply: a one-tile table (K12-K13 scan
    it), or a padded table that does not fit the shared memory of the
    largest portable cluster. The smallest cluster that holds the table
    is taken, so the fewest reads leave their SM."""
    _, tt, nt = geometry(g16)
    if nt < 2 or tt % CHUNK:
        return None
    n_chunks = nt * (tt // CHUNK)
    budget = resident_budget(g16.device)
    if budget is None:
        return ResidentPlan(1, n_chunks)
    smem_bytes, max_cluster = budget
    per_rank = smem_bytes // CHUNK_BYTES
    if per_rank < 1:
        return None
    cluster = -(-n_chunks // per_rank)
    if cluster > max_cluster:
        return None
    return ResidentPlan(cluster, -(-n_chunks // cluster))


def resident_active_clusters(name: str, plan: ResidentPlan, device) -> int:
    """How many clusters of `plan` the CUDA `device` runs at once for
    resident scan `name`: the persistent grid of its launches."""
    which = ("nearest_resident", "nearest_shadow_resident", "occlude_resident").index(name)
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _build.entry_point("flash_resident", "rt_resident_active_clusters", 1, 3)(
            ctypes.addressof(out), which, plan.cluster, plan.chunks_per_rank, None)
    if rc != 0:
        raise RuntimeError(f"rt_resident_active_clusters failed: cudaError {rc}")
    return out.value


def nearest_resident_plain(feats_t, g16, tile_aabbs):
    """[16, B] rays -> (t [B] f32, idx [B] i32), the resident form: per
    ray the tiles in ascending order, culled against its running best t."""
    t, idx = _grid_scan(feats_t, None, g16, tile_aabbs)[:2]
    return t, idx


def nearest_shadow_resident_plain(feats_t, sh_t, g16, tile_aabbs):
    """The resident form of the merged scan -> (t, idx, occ [B] i32)."""
    return _grid_scan(feats_t, sh_t, g16, tile_aabbs)[:3]


def occlude_resident_plain(sh_t, g16, tile_aabbs):
    """[16, B] shadow rows -> occ [B] i32, the resident form (culled
    against max t, a ray stops at its first hit)."""
    return _grid_scan(None, sh_t, g16, tile_aabbs)[2]


def rank_scan(feats_t, sh_t, g16, tile_aabbs, cluster: int, n_live=None, chunk: int = 32):
    """The resident scans' order of work (K14-K16, csrc/flash_resident.cu)
    in torch: the table's CHUNK-triangle chunks dealt round robin to
    `cluster` ranks (chunk k to rank k % cluster), each rank walking the
    tiles in ascending order over its own live chunks only, with its own
    running winner as its slab and skip limit, then the ranks' 64-bit keys
    merged by their minimum and their any-hit flags by OR -> (t, idx, occ),
    None where the scan has no such output. Equal to the grid form's plain
    version bit for bit where the per-ray cull and the skip test are
    exact."""
    _, tt, nt = geometry(g16)
    per_tile = tt // CHUNK
    if tt % CHUNK or cluster < 1:
        raise ValueError(f"a resident scan takes tiles of whole {CHUNK}-triangle chunks and a "
                         f"cluster of 1 or more ranks, got tiles of {tt} and {cluster} ranks")
    key = occ = None
    for rank in range(cluster):
        def owned(j, rank=rank):
            return [(cc * CHUNK, (cc + 1) * CHUNK) for cc in range(per_tile)
                    if (j * per_tile + cc) % cluster == rank]

        k, o, _ = _skip_walk(feats_t, sh_t, g16, tile_aabbs, n_live, chunk, None, owned)
        key = k if key is None else torch.minimum(key, k)
        occ = o if occ is None else occ | o
    return (win_t(key) if feats_t is not None else None,
            win_idx(key) if feats_t is not None else None,
            occ.to(torch.int32) if sh_t is not None else None)


# ---- CUDA wrappers ------------------------------------------------------------

# entry point of csrc/flash_intersect.cu: (C name, pointer count, int count)
_ENTRY = {
    "nearest_attrs": ("rt_nearest_attrs", 6, 4),
    "nearest_shadow_attrs": ("rt_nearest_shadow_attrs", 8, 4),
    "occlude": ("rt_occlude", 3, 3),
    "nearest": ("rt_nearest", 4, 3),
    "nearest_shadow": ("rt_nearest_shadow", 6, 3),
}


# entry points of csrc/flash_multi.cu
_ENTRY_MULTI = {
    "nearest_multi": ("rt_nearest_multi", 7, 4),
    "nearest_shadow_multi": ("rt_nearest_shadow_multi", 9, 4),
    "occlude_multi": ("rt_occlude_multi", 5, 4),
    "nearest_grid": ("rt_nearest_grid", 6, 4),
    "nearest_shadow_grid": ("rt_nearest_shadow_grid", 8, 4),
    "occlude_grid": ("rt_occlude_grid", 5, 4),
}

# packed copies of triangle tables: (tensor, its version) -> packed table;
# the entry holds the table, so its storage is not reused while cached
_PACKED: dict = {}
_PACKED_MAX = 8


def pack_table(g16: torch.Tensor) -> torch.Tensor:
    """[16, NT·4·TT] -> [NT, 10, TT, 4]: per tile, row and triangle one
    float4 (det, u, v, t), the order in which K1-K3, K12-K13 and K9-K11
    stage it (csrc/flash_common.cuh `stage_packed`): element (j, r, k, q)
    is g16[r, j·4·TT + q·TT + k]."""
    _, tt, nt = geometry(g16)
    return g16[:10].reshape(10, nt, 4, tt).permute(1, 0, 3, 2).contiguous()


def packed_table(g16: torch.Tensor) -> torch.Tensor:
    """`pack_table(g16)`, packed once per table and cached: the wrappers
    keep the JAX layout `tri_feats16` at their signatures and read this
    copy."""
    key = (g16.data_ptr(), g16._version, tuple(g16.shape), g16.device)
    hit = _PACKED.get(key)
    if hit is None:
        if len(_PACKED) >= _PACKED_MAX:
            _PACKED.pop(next(iter(_PACKED)))
        hit = _PACKED[key] = (g16, pack_table(g16))
    return hit[1]


# entry points of csrc/flash_resident.cu
_ENTRY_RESIDENT = {
    "nearest_resident": ("rt_nearest_resident", 5, 6),
    "nearest_shadow_resident": ("rt_nearest_shadow_resident", 7, 6),
    "occlude_resident": ("rt_occlude_resident", 4, 6),
}


def _launch(name: str, device, tensors, ints):
    if name in _ENTRY_MULTI:
        fn = _build.entry_point("flash_multi", *_ENTRY_MULTI[name])
    elif name in _ENTRY_RESIDENT:
        fn = _build.entry_point("flash_resident", *_ENTRY_RESIDENT[name])
    else:
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


def nearest_attrs(feats_t, g16, attrs, n_live: Optional[int] = None):
    """K1 (replaces flash_nearest_attrs_t): -> (t, idx, attrsT). `n_live`:
    the live triangles (the scene's `n_tris`; None: the tile width)."""
    live = live_count(n_live, geometry(g16)[0])
    if _build.uses_plain(feats_t):
        return nearest_attrs_plain(feats_t, g16, attrs)
    tt = _check_scene(feats_t, g16, attrs)
    b, w = feats_t.shape[1], attrs.shape[1]
    dev = feats_t.device
    t = torch.empty(b, dtype=torch.float32, device=dev)
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    attrs_t = torch.empty((w, b), dtype=torch.float32, device=dev)
    if b:
        _launch("nearest_attrs", dev, (feats_t, packed_table(g16), attrs, t, idx, attrs_t),
                (b, tt, w, live))
    return t, idx, attrs_t


def nearest_shadow_attrs(feats_t, sh_t, g16, attrs, n_live: Optional[int] = None):
    """K2 (replaces flash_nearest_shadow_attrs_t): -> (t, idx, occ, attrsT)."""
    live = live_count(n_live, geometry(g16)[0])
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
            (feats_t, sh_t, packed_table(g16), attrs, t, idx, occ, attrs_t), (b, tt, w, live),
        )
    return t, idx, occ, attrs_t


def occlude(sh_t, g16, n_live: Optional[int] = None):
    """K3 (replaces flash_occlude_packed_t): -> occ [B] i32."""
    live = live_count(n_live, geometry(g16)[0])
    if _build.uses_plain(sh_t):
        return occlude_plain(sh_t, g16)
    tt = _check_scene(sh_t, g16)
    b = sh_t.shape[1]
    occ = torch.empty(b, dtype=torch.int32, device=sh_t.device)
    if b:
        _launch("occlude", sh_t.device, (sh_t, packed_table(g16), occ), (b, tt, live))
    return occ


def nearest(feats_t, g16, n_live: Optional[int] = None):
    """K12 (replaces _nearest_single): -> (t [B] f32, idx [B] i32)."""
    live = live_count(n_live, geometry(g16)[0])
    if _build.uses_plain(feats_t):
        return nearest_plain(feats_t, g16)
    tt = _check_scene(feats_t, g16)
    b = feats_t.shape[1]
    dev = feats_t.device
    t = torch.empty(b, dtype=torch.float32, device=dev)
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    if b:
        _launch("nearest", dev, (feats_t, packed_table(g16), t, idx), (b, tt, live))
    return t, idx


def nearest_shadow(feats_t, sh_t, g16, n_live: Optional[int] = None):
    """K13 (replaces _nearest_shadow_single): -> (t, idx, occ [B] i32)."""
    live = live_count(n_live, geometry(g16)[0])
    if _build.uses_plain(feats_t):
        return nearest_shadow_plain(feats_t, sh_t, g16)
    tt = _check_scene(feats_t, g16)
    _build.check(sh_t, "shadow feats_t", torch.float32, feats_t.shape, feats_t.device)
    b = feats_t.shape[1]
    dev = feats_t.device
    t = torch.empty(b, dtype=torch.float32, device=dev)
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    occ = torch.empty(b, dtype=torch.int32, device=dev)
    if b:
        _launch("nearest_shadow", dev, (feats_t, sh_t, packed_table(g16), t, idx, occ),
                (b, tt, live))
    return t, idx, occ


def _check_multi(feats_t, g16, lists, counts, tile_aabbs):
    """Check a list-form scan's operands; `tile_aabbs` None for K7, which
    runs no per-ray slab test."""
    dev = feats_t.device
    b = feats_t.shape[1]
    t_pad, tt, nt = geometry(g16)
    nb = -(-b // BT_MULTI)
    _build.check(feats_t, "feats_t", torch.float32, (16, b), dev)
    _build.check(g16, "tri_feats16", torch.float32, (16, 4 * t_pad), dev)
    _build.check(lists, "lists", torch.int32, (nb, nt), dev)
    _build.check(counts, "counts", torch.int32, (nb,), dev)
    if tile_aabbs is not None:
        _build.check(tile_aabbs, "tile_aabbs", torch.float32, (nt, 8), dev)
    return b, nt, tt


def _need_aabbs(tile_aabbs):
    if tile_aabbs is None:
        raise ValueError("K5 and K6 take tile_aabbs on a CUDA tensor (the nearest set's "
                         "per-ray slab test inside the listed tiles)")


def nearest_multi(feats_t, g16, lists, counts, tile_aabbs=None, n_live: Optional[int] = None):
    """K5 (replaces _nearest_multi_dma): -> (t [B] f32, idx [B] i32).
    On a CUDA tensor `tile_aabbs` is required: each ray's slab test inside
    the listed tiles, for the nearest set only (K5, K6), keeps the list
    form's bits there, while a shadow ray of a dead lane can find a hit in
    a tile its slab test rules out. The plain version (CPU) walks the lists
    alone. `n_live` (None: the whole table): the live triangles."""
    live = live_count(n_live, geometry(g16)[0])
    if _build.uses_plain(feats_t):
        return nearest_multi_plain(feats_t, g16, lists, counts)
    _need_aabbs(tile_aabbs)
    b, nt, tt = _check_multi(feats_t, g16, lists, counts, tile_aabbs)
    dev = feats_t.device
    t = torch.empty(b, dtype=torch.float32, device=dev)
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    if b:
        _launch("nearest_multi", dev,
                (feats_t, packed_table(g16), tile_aabbs, lists, counts, t, idx), (b, nt, tt, live))
    return t, idx


def nearest_shadow_multi(feats_t, sh_t, g16, lists, counts, tile_aabbs=None,
                         n_live: Optional[int] = None):
    """K6 (replaces _nearest_shadow_multi_dma): -> (t, idx, occ [B] i32)."""
    live = live_count(n_live, geometry(g16)[0])
    if _build.uses_plain(feats_t):
        return nearest_shadow_multi_plain(feats_t, sh_t, g16, lists, counts)
    _need_aabbs(tile_aabbs)
    b, nt, tt = _check_multi(feats_t, g16, lists, counts, tile_aabbs)
    _build.check(sh_t, "shadow feats_t", torch.float32, feats_t.shape, feats_t.device)
    dev = feats_t.device
    t = torch.empty(b, dtype=torch.float32, device=dev)
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    occ = torch.empty(b, dtype=torch.int32, device=dev)
    if b:
        _launch("nearest_shadow_multi", dev,
                (feats_t, sh_t, packed_table(g16), tile_aabbs, lists, counts, t, idx, occ),
                (b, nt, tt, live))
    return t, idx, occ


def occlude_multi(sh_t, g16, lists, counts, n_live: Optional[int] = None):
    """K7 (replaces _occlude_multi_dma): -> occ [B] i32. The lists are its
    only cull (no per-ray slab test: see `nearest_multi`)."""
    live = live_count(n_live, geometry(g16)[0])
    if _build.uses_plain(sh_t):
        return occlude_multi_plain(sh_t, g16, lists, counts)
    b, nt, tt = _check_multi(sh_t, g16, lists, counts, None)
    occ = torch.empty(b, dtype=torch.int32, device=sh_t.device)
    if b:
        _launch("occlude_multi", sh_t.device, (sh_t, packed_table(g16), lists, counts, occ),
                (b, nt, tt, live))
    return occ


def _plain_two_sets(feats_t, sh_t, g16, tile_aabbs):
    """`_grid_scan` as the grid and resident wrappers return it ->
    ((t, idx, occ), tiles visited per block), None where the scan has no
    such output."""
    t, idx, occ, vis = _grid_scan(feats_t, sh_t, g16, tile_aabbs)[:4]
    near, anyhit = feats_t is not None, sh_t is not None
    return (t if near else None, idx if near else None, occ if anyhit else None), vis


def _check_two_sets(feats_t, sh_t, g16, tile_aabbs):
    """Check the operands of a grid- or resident-form scan on the nearest
    set `feats_t` and/or the any-hit set `sh_t` and allocate its outputs
    -> (device, b, nt, tt, (t, idx, occ)), None where the scan has no
    such output."""
    rays = feats_t if feats_t is not None else sh_t
    dev = rays.device
    b = rays.shape[1]
    t_pad, tt, nt = geometry(g16)
    for x, what in ((feats_t, "feats_t"), (sh_t, "shadow feats_t")):
        if x is not None:
            _build.check(x, what, torch.float32, (16, b), dev)
    _build.check(g16, "tri_feats16", torch.float32, (16, 4 * t_pad), dev)
    _build.check(tile_aabbs, "tile_aabbs", torch.float32, (nt, 8), dev)
    t = idx = occ = None
    if feats_t is not None:
        t = torch.empty(b, dtype=torch.float32, device=dev)
        idx = torch.empty(b, dtype=torch.int32, device=dev)
    if sh_t is not None:
        occ = torch.empty(b, dtype=torch.int32, device=dev)
    return dev, b, nt, tt, (t, idx, occ)


def _present(*tensors):
    return [x for x in tensors if x is not None]


def _grid(name, feats_t, sh_t, g16, tile_aabbs, visits, n_live):
    """Run grid-form scan `name` (K9-K11) on the nearest set `feats_t`
    and/or the any-hit set `sh_t`: the plain version for CPU tensors, the
    kernel for CUDA tensors -> (t, idx, occ), None where the scan has no
    such output. `visits` (int32 [nb] or None) receives the tiles each
    block visited; `n_live` (None: the whole table) the live triangles."""
    live = live_count(n_live, geometry(g16)[0])
    if _build.uses_plain(feats_t if feats_t is not None else sh_t):
        out, vis = _plain_two_sets(feats_t, sh_t, g16, tile_aabbs)
        if visits is not None:
            visits.copy_(vis)
        return out
    dev, b, nt, tt, out = _check_two_sets(feats_t, sh_t, g16, tile_aabbs)
    if visits is not None:
        _build.check(visits, "visits", torch.int32, (-(-b // BT_MULTI),), dev)
    if b:
        _launch(name, dev, (*_present(feats_t, sh_t), packed_table(g16), tile_aabbs,
                            *_present(*out), visits), (b, nt, tt, live))
    return out


def nearest_grid(feats_t, g16, tile_aabbs, visits=None, n_live: Optional[int] = None):
    """K9 (replaces _nearest_multi): -> (t [B] f32, idx [B] i32). `visits`,
    an int32 [nb] tensor or None, receives the tiles each block visited."""
    return _grid("nearest_grid", feats_t, None, g16, tile_aabbs, visits, n_live)[:2]


def nearest_shadow_grid(feats_t, sh_t, g16, tile_aabbs, visits=None,
                        n_live: Optional[int] = None):
    """K10 (replaces _nearest_shadow_multi): -> (t, idx, occ [B] i32)."""
    return _grid("nearest_shadow_grid", feats_t, sh_t, g16, tile_aabbs, visits, n_live)


def occlude_grid(sh_t, g16, tile_aabbs, visits=None, n_live: Optional[int] = None):
    """K11 (replaces _occlude_multi): -> occ [B] i32."""
    return _grid("occlude_grid", None, sh_t, g16, tile_aabbs, visits, n_live)[2]


def _resident(name, feats_t, sh_t, g16, tile_aabbs, n_live):
    """Run resident-form scan `name` (K14-K16) on the nearest set
    `feats_t` and/or the any-hit set `sh_t` -> (t, idx, occ), None where
    the scan has no such output. A table `use_resident` refuses raises;
    `n_live` (None: the whole table) the live triangles."""
    live = live_count(n_live, geometry(g16)[0])
    plan = use_resident(g16)
    if plan is None:
        t_pad, _, nt = geometry(g16)
        raise ValueError(
            f"the resident scans take a table of 2 or more tiles that fits a thread-block "
            f"cluster's shared memory; this one has {nt} tile(s) and stages "
            f"{t_pad * CHUNK_BYTES // CHUNK} bytes, the device offers (bytes a block, "
            f"blocks a cluster) {resident_budget(g16.device)}"
        )
    if _build.uses_plain(feats_t if feats_t is not None else sh_t):
        return _plain_two_sets(feats_t, sh_t, g16, tile_aabbs)[0]
    dev, b, nt, tt, out = _check_two_sets(feats_t, sh_t, g16, tile_aabbs)
    if b:
        _launch(name, dev, (*_present(feats_t, sh_t), g16, tile_aabbs, *_present(*out)),
                (b, nt, tt, live, plan.cluster, plan.chunks_per_rank))
    return out


def nearest_resident(feats_t, g16, tile_aabbs, n_live: Optional[int] = None):
    """K14 (replaces _nearest_resident): -> (t [B] f32, idx [B] i32)."""
    return _resident("nearest_resident", feats_t, None, g16, tile_aabbs, n_live)[:2]


def nearest_shadow_resident(feats_t, sh_t, g16, tile_aabbs, n_live: Optional[int] = None):
    """K15 (replaces _nearest_shadow_resident): -> (t, idx, occ [B] i32)."""
    return _resident("nearest_shadow_resident", feats_t, sh_t, g16, tile_aabbs, n_live)


def occlude_resident(sh_t, g16, tile_aabbs, n_live: Optional[int] = None):
    """K16 (replaces _occlude_resident): -> occ [B] i32."""
    return _resident("occlude_resident", None, sh_t, g16, tile_aabbs, n_live)[2]
