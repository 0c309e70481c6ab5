"""Ray-triangle intersection engines (twin of rustic_tpu/ops/intersect.py):

- "flash": the scan kernels of ops/flash_intersect.py. A scan returns
  each ray's winning triangle (t, index); the consumer gathers the
  winner's shading row and re-tests that one triangle in exact f32
  (Möller–Trumbore, reference: kernels/src/intersection.rs:9-54) to get
  u, v, the backface flag and the final t. Under the port's "f32" plan a
  scan carries no second candidate. `flash_scan` / `flash_occlude_rows`
  pick the kernel by the scene's tile count and the scan form the caller
  names (`MULTITILE_SCANS`).
- "brute": every (ray, triangle) pair as one matrix product per chunk of
  rays, from the triangles' vertices alone; the oracle the flash engine
  and the staged renderer are held to.
- "bvh" (the JAX package's lockstep traversal) is not ported.

Unlike the JAX package, ray features are [16, B] rows (the layout the
scan kernels read coalesced); everything else is lane-major.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.ops.flash_intersect import BIG, DET_EPS
from rustic_tpu_torch.ops.sampling import EPS, cross

# Triangle count at or below which `auto` takes brute force on the CPU.
BRUTE_FORCE_MAX_TRIS = 64
# f32 elements of one [chunk, 4T] brute-force intermediate (64 MB)
_CHUNK_BUDGET = 1 << 24

BVH_TODO = (
    'the "bvh" engine (the lockstep BVH traversal) is not ported '
    "(ROADMAP.md queue 1 item 8); name \"flash\" or \"brute\""
)
ENGINES = ("auto", "flash", "brute", "bvh")


class TraceResult(NamedTuple):
    t: torch.Tensor  # [B] f32, BIG when missed
    tri_idx: torch.Tensor  # [B] i32
    hit: torch.Tensor  # [B] bool
    backface: torch.Tensor  # [B] bool
    u: torch.Tensor  # [B] f32 barycentric weight of vertex b
    v: torch.Tensor  # [B] f32 barycentric weight of vertex c


def _ray_features16(ro, rd, maxt=None):
    """[B, 3] rays -> [16, B] feature rows [rd, ro×rd, ro, 1, maxt or 0, 0...]."""
    b = ro.shape[0]
    dev = ro.device
    rows = [rd.T, cross(ro, rd).T, ro.T, torch.ones((1, b), dtype=torch.float32, device=dev)]
    if maxt is not None:
        rows.append(maxt[None, :])
    n_used = 10 if maxt is None else 11
    rows.append(torch.zeros((16 - n_used, b), dtype=torch.float32, device=dev))
    return torch.cat(rows, dim=0)


def _sum3(x):
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _mt_single(a, b, c, ro, rd):
    """Möller–Trumbore for one triangle per lane
    (reference: kernels/src/intersection.rs:9-54)."""
    e1 = b - a
    e2 = c - a
    pv = cross(rd, e2)
    det = _sum3(e1 * pv)
    backface = det < 0.0
    good = det.abs() >= DET_EPS
    inv_det = torch.where(good, torch.reciprocal(torch.where(good, det, 1.0)), 0.0)
    tv = ro - a
    u = _sum3(tv * pv) * inv_det
    qv = cross(tv, e1)
    v = _sum3(rd * qv) * inv_det
    t = _sum3(e2 * qv) * inv_det
    valid = good & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
    return t, u, v, backface, valid


def refine_from_attrs(attrs, ro, rd):
    """Exact f32 Möller–Trumbore of each lane's candidate, whose vertices
    are columns 0:9 of its shading row."""
    return _mt_single(attrs[:, 0:3], attrs[:, 3:6], attrs[:, 6:9], ro, rd)


def gather_attr_rows(scene, idx):
    """The winning triangles' shading rows [B, SLIM_WIDTH]: one row gather."""
    n = scene.tri_attrs.shape[0]
    return scene.tri_attrs[torch.clamp(idx, 0, n - 1).long()]


def classify_flash_hit(t_kernel, idx, attrs, ro, rd):
    """A scan's winner -> exact TraceResult: a winner the exact re-test
    rejects is a miss."""
    t2, u, v, backface, valid = refine_from_attrs(attrs, ro, rd)
    hit = (t_kernel < BIG) & valid
    return TraceResult(torch.where(hit, t2, BIG), idx, hit, backface & hit, u, v)


def classify_flash_hit2(t1k, i1, attrs1, t2k, i2, attrs2, ro, rd):
    """The nearer valid of a top-2 candidate pair, or `classify_flash_hit`
    when the scan carried no second candidate (the port's "f32" plan
    never does) -> (TraceResult, the chosen attr rows)."""
    if t2k is None:
        return classify_flash_hit(t1k, i1, attrs1, ro, rd), attrs1
    ta, ua, va, bfa, vala = refine_from_attrs(attrs1, ro, rd)
    tb, ub, vb, bfb, valb = refine_from_attrs(attrs2, ro, rd)
    hita = (t1k < BIG) & vala
    hitb = (t2k < BIG) & valb
    useb = hitb & (~hita | (tb < ta))
    hit = hita | hitb
    res = TraceResult(
        torch.where(hit, torch.where(useb, tb, ta), BIG),
        torch.where(useb, i2, i1),
        hit,
        torch.where(useb, bfb, bfa) & hit,
        torch.where(useb, ub, ua),
        torch.where(useb, vb, va),
    )
    return res, torch.where(useb[:, None], attrs2, attrs1)


# ---- brute force: the oracle ------------------------------------------------


def triangle_features(verts9: torch.Tensor) -> torch.Tensor:
    """[T, 9] vertex rows (a, b, c) -> G [10, T, 4] f32: with ray features
    F = [rd, ro x rd, ro, 1] the Möller–Trumbore numerators (det, u, v, t)
    of every pair are F·G. Computed in float64 from the vertices, as the
    scene build does (`scene/world.py` `_triangle_features`), and not
    scaled per triangle as the flash table is."""
    v = verts9.to(torch.float64)
    a, b, c = v[:, 0:3], v[:, 3:6], v[:, 6:9]
    e1 = b - a
    e2 = c - a
    n = torch.linalg.cross(e1, e2)
    d0 = (a * n).sum(dim=-1)
    g = torch.zeros((10, v.shape[0], 4), dtype=torch.float64, device=v.device)
    g[0:3, :, 0] = -n.T
    g[0:3, :, 1] = torch.linalg.cross(a, e2).T
    g[3:6, :, 1] = e2.T
    g[0:3, :, 2] = torch.linalg.cross(e1, a).T
    g[3:6, :, 2] = -e1.T
    g[6:9, :, 3] = n.T
    g[9, :, 3] = -d0
    return g.to(torch.float32)


def scene_tri_feats(scene) -> torch.Tensor:
    """G [10, T, 4] of the scene's real triangles, from the vertex
    columns of its shading rows."""
    return triangle_features(scene.tri_attrs[: scene.n_tris, 0:9])


def _ray_features(ro, rd):
    return torch.cat([rd, cross(ro, rd), ro, torch.ones_like(ro[:, :1])], dim=-1)


def _brute_chunks(n_tris: int, batch: int):
    step = max(_CHUNK_BUDGET // max(4 * n_tris, 1), 8)
    for lo in range(0, batch, step):
        yield lo, min(lo + step, batch)


def _mt_scalars(feats, tri_feats_flat, n_tris: int):
    """[Bc, 10] x [10, 4T] -> det, u, v, t, valid, each [Bc, T]."""
    raw = (feats @ tri_feats_flat).reshape(feats.shape[0], n_tris, 4)
    det = raw[..., 0]
    good = det.abs() >= DET_EPS
    inv = torch.where(good, torch.reciprocal(torch.where(good, det, 1.0)), 0.0)
    u = raw[..., 1] * inv
    v = raw[..., 2] * inv
    t = raw[..., 3] * inv
    valid = good & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
    return det, u, v, t, valid


def intersect_brute(tri_feats: torch.Tensor, ro, rd) -> TraceResult:
    """Nearest hit over all triangles, a chunk of rays at a time.
    tri_feats: [10, T, 4] (`scene_tri_feats`)."""
    n_tris = tri_feats.shape[1]
    tf = tri_feats.reshape(10, n_tris * 4)
    parts = []
    for lo, hi in _brute_chunks(n_tris, ro.shape[0]):
        det, u, v, t, valid = _mt_scalars(_ray_features(ro[lo:hi], rd[lo:hi]), tf, n_tris)
        tm = torch.where(valid, t, BIG)
        idx = torch.argmin(tm, dim=-1, keepdim=True)  # first index among equal minima
        tb, db, ub, vb = (x.gather(1, idx)[:, 0] for x in (tm, det, u, v))
        parts.append((tb, idx[:, 0].to(torch.int32), tb < BIG, db < 0.0, ub, vb))
    return TraceResult(*(torch.cat(col) for col in zip(*parts)))


def occlude_brute(tri_feats: torch.Tensor, ro, rd, max_t) -> torch.Tensor:
    """Any hit within (EPS, max_t] over all triangles -> [B] bool."""
    n_tris = tri_feats.shape[1]
    tf = tri_feats.reshape(10, n_tris * 4)
    parts = []
    for lo, hi in _brute_chunks(n_tris, ro.shape[0]):
        _, _, _, t, valid = _mt_scalars(_ray_features(ro[lo:hi], rd[lo:hi]), tf, n_tris)
        parts.append((valid & (t <= max_t[lo:hi, None])).any(dim=-1))
    return torch.cat(parts)


# ---- the flash engine ---------------------------------------------------------

# the forms of the multi-tile scans; the first is the default (the fastest on
# the H100 on each multi-tile scene measured, or tied within its spread)
MULTITILE_SCANS = ("grid", "lists", "resident")


def check_scan(scan: str) -> None:
    if scan not in MULTITILE_SCANS:
        raise ValueError(f"multi-tile scan {scan!r}: expected one of {MULTITILE_SCANS}")


def flash_scan(feats, pending_sh, scene, scan: str = MULTITILE_SCANS[0]):
    """The nearest-hit scan of ray rows `feats` [16, B], alone or merged
    with the any-hit test of the shadow rows `pending_sh` -> (t, idx, occ
    bool or None). One tile: K12 or K13. Many tiles, by `scan`: K5 or K6
    after their tile lists, K9 or K10 in the grid form, K14 or K15 in the
    resident form."""
    g16, aabbs, live = scene.tri_feats16, scene.tile_aabbs, scene.n_tris
    if FI.geometry(g16)[2] == 1:
        if pending_sh is None:
            t, idx = FI.nearest(feats, g16, live)
            return t, idx, None
        t, idx, occ = FI.nearest_shadow(feats, pending_sh, g16, live)
        return t, idx, occ != 0
    if scan == "grid":
        if pending_sh is None:
            t, idx = FI.nearest_grid(feats, g16, aabbs, n_live=live)
            return t, idx, None
        t, idx, occ = FI.nearest_shadow_grid(feats, pending_sh, g16, aabbs, n_live=live)
        return t, idx, occ != 0
    if scan == "resident":
        if pending_sh is None:
            t, idx = FI.nearest_resident(feats, g16, aabbs, live)
            return t, idx, None
        t, idx, occ = FI.nearest_shadow_resident(feats, pending_sh, g16, aabbs, live)
        return t, idx, occ != 0
    if pending_sh is None:
        lists, counts = FI.block_tile_lists(aabbs, FI.BT_MULTI, (False,), feats)
        t, idx = FI.nearest_multi(feats, g16, lists, counts, aabbs, live)
        return t, idx, None
    lists, counts = FI.block_tile_lists(aabbs, FI.BT_MULTI, (False, True), feats, pending_sh)
    t, idx, occ = FI.nearest_shadow_multi(feats, pending_sh, g16, lists, counts, aabbs, live)
    return t, idx, occ != 0


def flash_occlude_rows(sh, scene, scan: str = MULTITILE_SCANS[0]):
    """Any-hit of shadow rows [16, B] alone -> occ [B] i32: K3 on one
    tile, else K7 after its tile lists, K11 or K16."""
    g16 = scene.tri_feats16
    if FI.geometry(g16)[2] == 1:
        return FI.occlude(sh, g16, scene.n_tris)
    if scan == "grid":
        return FI.occlude_grid(sh, g16, scene.tile_aabbs, n_live=scene.n_tris)
    if scan == "resident":
        return FI.occlude_resident(sh, g16, scene.tile_aabbs, scene.n_tris)
    lists, counts = FI.block_tile_lists(scene.tile_aabbs, FI.BT_MULTI, (True,), sh)
    return FI.occlude_multi(sh, g16, lists, counts, scene.n_tris)


def intersect_flash_attrs(scene, ro, rd, scan: str = MULTITILE_SCANS[0]):
    """Nearest hit through the flash scans -> (TraceResult, the winners'
    shading rows [B, W]): one scan, one row gather, one exact re-test."""
    t, idx, _ = flash_scan(_ray_features16(ro, rd), None, scene, scan)
    attrs = gather_attr_rows(scene, idx)
    return classify_flash_hit2(t, idx, attrs, None, None, None, ro, rd)


def intersect_flash(scene, ro, rd, scan: str = MULTITILE_SCANS[0]) -> TraceResult:
    return intersect_flash_attrs(scene, ro, rd, scan)[0]


def occlude_flash(scene, ro, rd, max_t, scan: str = MULTITILE_SCANS[0]) -> torch.Tensor:
    return flash_occlude_rows(_ray_features16(ro, rd, max_t), scene, scan) != 0


# ---- dispatch -------------------------------------------------------------------


def _pick_engine(scene, engine: str) -> str:
    """Resolve `engine` for `scene`: "auto" is "flash" on a CUDA device;
    on the CPU it is "brute" up to BRUTE_FORCE_MAX_TRIS triangles and
    "bvh" beyond, which is not ported and raises."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r}: expected one of {ENGINES}")
    if engine == "auto":
        if scene.device.type == "cuda":
            return "flash"
        engine = "brute" if scene.n_tris <= BRUTE_FORCE_MAX_TRIS else "bvh"
    if engine == "bvh":
        raise NotImplementedError(BVH_TODO)
    return engine


def intersect_nearest(scene, ro, rd, engine: str = "auto",
                      scan: str = MULTITILE_SCANS[0]) -> TraceResult:
    """Nearest hit (reference: kernels/src/intersection.rs:169-171)."""
    if _pick_engine(scene, engine) == "flash":
        return intersect_flash(scene, ro, rd, scan)
    return intersect_brute(scene_tri_feats(scene), ro, rd)


def intersect_any(scene, ro, rd, max_t, engine: str = "auto",
                  scan: str = MULTITILE_SCANS[0]) -> torch.Tensor:
    """Occlusion within (EPS, max_t] (reference: kernels/src/intersection.rs:173-175)."""
    if _pick_engine(scene, engine) == "flash":
        return occlude_flash(scene, ro, rd, max_t, scan)
    return occlude_brute(scene_tri_feats(scene), ro, rd, max_t)
