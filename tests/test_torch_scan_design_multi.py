"""The orders of work of the list-form scans (K5-K7) and the resident
scans (K14-K16) on the H100, held on the CPU through their torch twins in
rustic_tpu_torch/ops/flash_intersect.py:

- `skip_scan` with tile lists: K10's loop (packed items, `pair_skip`
  before the exact epilogue, a 64-bit (t, index) key merge) over the
  tiles each block's list row admits, with and without each ray's own
  slab test inside the listed tiles for the nearest set, equal bit for bit
  to the list form's plain versions (`nearest_multi_plain` and its twins,
  which tests/test_torch_flash_multi.py holds to the JAX package's DMA
  kernels); and why the any-hit set keeps the lists alone (shadow rays of
  dead lanes on which the per-ray cull changes the result), and why that
  change never reaches a film (the unsorted loop reads no dead lane's
  occlusion: the grid and resident forms' films equal the list form's);
- `rank_scan`: the table's chunks dealt round robin to the ranks of a
  cluster, each rank scanning a ray block against its own chunks with its
  own running winner as its limits, the ranks' keys merged by their
  minimum and their flags by OR; equal bit for bit to the resident form's
  plain versions for clusters of 1, 2, 3 and 8, also where a triangle
  duplicated into another rank's chunk (or another tile) makes exact ties
  across ranks, for rays with NaN rows and for shadow rays with max t =
  inf;
- near ties (two triangles a few ulps apart along the rays) across two
  tiles for the list form and across ranks for the resident form.

On VeachMIS (6 tiles) and FurnaceTest (20 tiles) at the sizes of
tests/test_torch_scan_design.py. All exact: no tolerance."""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.scene import world as W
from rustic_tpu_torch.scene.gltf import load_glb
from tests.conftest import scene_path
from tests.test_torch_flash_multi import feats_rows, random_feats, shadow_feats
from tests.test_torch_flash_grid import camera_feats as grid_camera_feats

torch.set_num_threads(2)

F32 = np.float32
N = 500  # rays: one ragged 256-ray block after a whole one
FILES = {"veach": "VeachMIS.glb", "furnace": "FurnaceTest.glb"}


@pytest.fixture(scope="module")
def scenes():
    """name -> port scene on the CPU, built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = W.World(load_glb(scene_path(FILES[name])), 16).to_torch("cpu")
        return cache[name]

    return get


def ray_rows(ts, name, seed):
    """(nearest rows, shadow rows) [16, N]: VeachMIS camera rays, or rays
    from random points of FurnaceTest's bounds; shadow rays toward its
    lights."""
    if name == "veach":
        f = grid_camera_feats("veach", seed)[:, :N]
    else:
        f = random_feats(seed, ts.tile_aabbs.numpy())[:, :N]
    s = shadow_feats(ts, seed + 1)[:, :N]
    return torch.from_numpy(np.ascontiguousarray(f)), torch.from_numpy(np.ascontiguousarray(s))


def with_edge_rays(f, s, nan: bool = True):
    """The shadow rays 11-19 with max t = inf; with `nan`, rays 7 and 300
    with NaN rows (a NaN ray empties its block's tile list: the lists'
    interval test fails on NaN bounds)."""
    f, s = f.clone(), s.clone()
    if nan:
        f[6:9, 7] = float("nan")
        f[0, 300] = float("nan")
        s[6, 7] = float("nan")
    s[FI.SH_MAXT_COL, 11:20] = float("inf")
    return f, s


def assert_same(got, want):
    for a, b in zip(got, want):
        if a is None or b is None:
            assert a is None and b is None
            continue
        assert a.dtype == b.dtype and torch.equal(a, b), int((a != b).sum())


# ---- the list form on K10's loop --------------------------------------------------


@pytest.mark.parametrize("cull", [False, True], ids=["lists", "lists+slab"])
@pytest.mark.parametrize("name", ["veach", "furnace"])
def test_list_skip_scan_equals_the_list_plain_versions(scenes, name, cull):
    ts = scenes(name)
    g16, aabbs, live = ts.tri_feats16, ts.tile_aabbs, ts.n_tris
    f, s = with_edge_rays(*ray_rows(ts, name, 5), nan=False)
    boxes = aabbs if cull else None
    lists = FI.block_tile_lists(aabbs, FI.BT_MULTI, (False, True), f, s)
    t, idx, occ, stats = FI.skip_scan(f, s, g16, boxes, live, lists=lists)
    assert_same((t, idx, occ), FI.nearest_shadow_multi_plain(f, s, g16, *lists))
    l5 = FI.block_tile_lists(aabbs, FI.BT_MULTI, (False,), f)
    assert_same(FI.skip_scan(f, None, g16, boxes, live, lists=l5)[:2],
                FI.nearest_multi_plain(f, g16, *l5))
    l7 = FI.block_tile_lists(aabbs, FI.BT_MULTI, (True,), s)
    assert_same(FI.skip_scan(None, s, g16, boxes, live, lists=l7)[2:3],
                (FI.occlude_multi_plain(s, g16, *l7),))
    assert 0 < int(stats[0, 1]) < int(stats[0, 0]) // 10  # few pairs divide
    assert int((t < FI.BIG).sum()) > N // 4 and 0 < int(occ.sum()) < N


@pytest.mark.parametrize("name", ["veach", "furnace"])
def test_the_per_ray_cull_inside_listed_tiles_saves_pairs(scenes, name):
    """Both walks give the plain versions' bits (above); the slab test
    inside the listed tiles leaves fewer pairs to test."""
    ts = scenes(name)
    f, s = ray_rows(ts, name, 9)
    lists = FI.block_tile_lists(ts.tile_aabbs, FI.BT_MULTI, (False, True), f, s)
    listed = FI.skip_scan(f, s, ts.tri_feats16, None, ts.n_tris, lists=lists)
    culled = FI.skip_scan(f, s, ts.tri_feats16, ts.tile_aabbs, ts.n_tris, lists=lists)
    assert_same(listed[:3], culled[:3])
    assert int(culled[3][0, 0]) < int(listed[3][0, 0])
    assert int(culled[3][1, 0]) <= int(listed[3][1, 0])


# three shadow rays of dead lanes (the path left the scene: the shading point
# lies 1e6 away along -rd) from VeachMIS traced through the unsorted loop:
# rows rd, ro x rd, ro, 1, max t
DEAD_LANE_SHADOW_ROWS = [
    [-0.6919804811477661, 0.0077543980441987514, -0.7218745946884155, -4.55517578125,
     -0.21875, 4.3642578125, 691980.375, -7748.08984375, 721874.8125, 1.0, 999999.6875],
    [-0.5126688480377197, -0.44583794474601746, -0.7337568998336792, -2.96875, -1.90625,
     3.234375, 512664.25, 445840.25, 733754.0625, 1.0, 999991.0],
    [-0.12776044011116028, -0.49216559529304504, -0.8610751032829285, -3.5625, -0.4296875,
     0.765625, 127758.8671875, 492165.53125, 861067.8125, 1.0, 999987.1875],
]


def test_the_any_hit_set_keeps_the_lists_alone(scenes):
    """Why the list form runs no per-ray slab test for its any-hit set: at
    a distance of 1e6 the shadow ray's 2 EPS margin is below an ulp, so
    max t rounds to the light's own distance and the pair test finds the
    light at t = max t, while the slab test (tmin < max t, strict) rules
    its tile out. The list form (every tile listed) reports the hit, the
    grid form's per-ray cull does not; `skip_scan` with lists and AABBs
    keeps the list form's bits."""
    ts = scenes("veach")
    g16, aabbs = ts.tri_feats16, ts.tile_aabbs
    s = torch.zeros((16, len(DEAD_LANE_SHADOW_ROWS)), dtype=torch.float32)
    s[:11] = torch.tensor(DEAD_LANE_SHADOW_ROWS, dtype=torch.float32).T
    nt = FI.geometry(g16)[2]
    every = (torch.arange(nt, dtype=torch.int32) | FI._SET_BIT[0])[None, :].contiguous()
    lists = (every, torch.tensor([nt], dtype=torch.int32))
    listed = FI.occlude_multi_plain(s, g16, *lists)
    assert listed.tolist() == [1, 1, 1]
    assert FI.occlude_grid_plain(s, g16, aabbs).tolist() == [0, 0, 0]
    assert_same(FI.skip_scan(None, s, g16, aabbs, lists=lists)[2:3], (listed,))


VEACH_CAM = dict(cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05))


@pytest.mark.parametrize("scan", ["grid", "resident"])
def test_dead_lanes_occlusion_is_never_read(scenes, scan, monkeypatch):
    """The grid and resident forms run each ray's own slab test for the
    any-hit set, where the list form (and the JAX kernels) cull by block:
    on the shadow rays of dead lanes (above) they can report no occlusion
    where the lists report one. The unsorted loop, which hands those rays
    to the scans as they are, reads a shadow ray's occlusion only where its
    NEE term is eligible (`_fold_slim_nee`), and a dead lane's never is: on
    a traced VeachMIS frame the two forms' occlusion differs on some lanes,
    each of them ineligible, and the films are equal bit for bit."""
    from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
    from rustic_tpu_torch.runtime import pipeline as P
    from rustic_tpu_torch.runtime.render import pixel_offsets, render_pixels

    ts = scenes("veach")
    w, h, spp = 64, 48, 2
    config = TracingConfig(width=w, height=h, nee=NextEventEstimation.MIS, **VEACH_CAM)
    y, x = np.mgrid[0:h, 0:w]
    px, py = x.reshape(-1).astype(np.int32), y.reshape(-1).astype(np.int32)
    folds = {}  # scan form -> [(eligible, occluded)] as the loop folds them
    real = P._fold_slim_nee

    def spy(radiance, prev_nee, prev_occ):
        if prev_nee is not None:
            folds[form].append((prev_nee[0].clone(), prev_occ.clone()))
        return real(radiance, prev_nee, prev_occ)

    monkeypatch.setattr(P, "_fold_slim_nee", spy)
    films = {}
    for form in ("lists", scan):
        folds[form] = []
        films[form] = render_pixels(ts, config, px, py, spp, offsets=pixel_offsets(w, h),
                                    loop="unsorted", scan=form, engine=None)
    assert len(folds["lists"]) == len(folds[scan]) > 0
    differ = 0
    for (elig, occ), (elig_c, occ_c) in zip(folds["lists"], folds[scan]):
        assert torch.equal(elig, elig_c)
        assert not bool((elig & (occ != occ_c)).any())
        differ += int((occ != occ_c).sum())
    assert differ > 0  # the forms' occlusion does differ, on dead lanes only
    assert torch.equal(films["lists"], films[scan])
    assert float(films["lists"].mean()) > 0.01


# ---- the resident form: ranks that hold the table ---------------------------------------


@pytest.mark.parametrize("cluster", [1, 2, 3, 8])
@pytest.mark.parametrize("name", ["veach", "furnace"])
def test_rank_scan_equals_the_resident_plain_versions(scenes, name, cluster):
    ts = scenes(name)
    g16, aabbs, live = ts.tri_feats16, ts.tile_aabbs, ts.n_tris
    f, s = with_edge_rays(*ray_rows(ts, name, 3))
    got = FI.rank_scan(f, s, g16, aabbs, cluster, live)
    assert_same(got, FI.nearest_shadow_resident_plain(f, s, g16, aabbs))
    assert_same(FI.rank_scan(None, s, g16, aabbs, cluster, live)[2:],
                (FI.occlude_resident_plain(s, g16, aabbs),))
    assert_same(FI.rank_scan(f, None, g16, aabbs, cluster, live)[:2],
                FI.nearest_resident_plain(f, g16, aabbs))
    t, idx, occ = got
    assert int(t[7]) == int(FI.BIG) and int(idx[7]) == 0 and int(occ[7]) == 0  # NaN ray
    assert int((t < FI.BIG).sum()) > N // 4 and 0 < int(occ.sum()) < N


def duplicated_table(path, src: int, dst: int):
    """(g16, tile_aabbs, n_tris) of a scene with triangle `src` copied over
    triangle `dst`: a ray through it ties exactly between two columns."""
    gltf = load_glb(scene_path(path))
    tri = gltf.triangles[:, :3].copy()
    tri[dst] = tri[src]
    g16 = W.pack_tri_feats16(W._triangle_features(gltf.positions, tri))
    t_pad = g16.shape[1] // 4
    aabbs = W._tile_aabbs(gltf.positions, tri, t_pad, W.tile_size(t_pad))
    return torch.from_numpy(g16), torch.from_numpy(aabbs), len(tri), gltf.positions[tri[src]]


def aimed_rows(corners, aabbs, n: int, seed: int, maxt_scale: float = 1.0):
    """Rays from random points of the scene's bounds through random
    points of the triangle `corners` [3, 3] (max t: the distance to it
    times `maxt_scale`)."""
    rng = np.random.default_rng(seed)
    a = aabbs.numpy()
    lo, hi = a[:, 0:3].min(0), a[:, 4:7].max(0)
    ro = rng.uniform(lo, hi, (n, 3)).astype(F32)
    w = rng.dirichlet([4, 4, 4], n)
    target = (w @ corners.astype(np.float64)).astype(F32)
    d = (target - ro).astype(np.float64)
    dist = np.linalg.norm(d, axis=1)
    rd = (d / dist[:, None]).astype(F32)
    return torch.from_numpy(feats_rows(ro, rd, (dist * maxt_scale).astype(F32)))


# (scene, source triangle, destination): another chunk of the same tile
# (another rank from a cluster of 2 on), or another tile
TIES = [("VeachMIS.glb", 5, 200), ("VeachMIS.glb", 5, 1800), ("FurnaceTest.glb", 30, 9000)]


@pytest.mark.parametrize("cluster", [2, 3, 8])
@pytest.mark.parametrize("path,src,dst", TIES)
def test_exact_ties_across_ranks_go_to_the_first_index(path, src, dst, cluster):
    g16, aabbs, n_tris, corners = duplicated_table(path, src, dst)
    f = torch.cat([aimed_rows(corners, aabbs, 200, dst), aimed_rows(corners, aabbs, 56, 1)], 1)
    s = aimed_rows(corners, aabbs, 256, src, maxt_scale=1.5)
    want = FI.nearest_shadow_resident_plain(f, s, g16, aabbs)
    assert int((want[1][:200] == src).sum()) > 20  # the first of the two equal columns won
    assert_same(FI.rank_scan(f, s, g16, aabbs, cluster, n_tris), want)
    assert_same(FI.skip_scan(f, s, g16, aabbs, n_tris)[:3], want)


# ---- near ties ----------------------------------------------------------------------


def near_tie_table(offset: float, src: int, dst: int, seed: int):
    """1,024 small random triangles in [-4, 4]^3 (two tiles), with triangle
    `dst` a copy of `src` moved by `offset` along its normal."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-4, 4, (1024, 1, 3))
    verts = (centres + rng.normal(0, 0.1, (1024, 3, 3))).astype(F32)
    a, b, c = verts[src].astype(np.float64)
    n = np.cross(b - a, c - a)
    verts[dst] = (verts[src] + offset * n / np.linalg.norm(n)).astype(F32)
    positions = verts.reshape(-1, 3)
    tri = np.arange(3 * 1024).reshape(1024, 3)
    g16 = W.pack_tri_feats16(W._triangle_features(positions, tri))
    aabbs = W._tile_aabbs(positions, tri, 1024, 512)
    return torch.from_numpy(g16), torch.from_numpy(aabbs), verts[src]


@settings(max_examples=25, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(ulps=st.integers(-8, 8), scale=st.sampled_from([0.0, 1e-7, 3e-7, 1e-6]),
       dst=st.sampled_from([130, 600, 1000]), seed=st.integers(0, 3),
       maxt_scale=st.sampled_from([1.0, 1.0 + 2**-23, 1.0 - 2**-23]))
def test_near_ties_across_tiles_and_ranks(ulps, scale, dst, seed, maxt_scale):
    """Two triangles a few ulps apart (or exactly equal: offset 0) along
    the rays, in two chunks of one tile (130) or in two tiles (600, 1000):
    the list form's and the resident form's orders of work give the plain
    versions' winner and occlusion; max t at the nearer one's distance."""
    src = 5
    offset = float(np.float32(scale * ulps))
    g16, aabbs, corners = near_tie_table(offset, src, dst, seed)
    f = aimed_rows(corners, aabbs, 300, seed)
    s = aimed_rows(corners, aabbs, 300, seed + 7, maxt_scale)
    lists = FI.block_tile_lists(aabbs, FI.BT_MULTI, (False, True), f, s)
    want = FI.nearest_shadow_multi_plain(f, s, g16, *lists)
    assert int(((want[1] == src) | (want[1] == dst)).sum()) > 100
    for boxes in (None, aabbs):
        assert_same(FI.skip_scan(f, s, g16, boxes, lists=lists)[:3], want)
    want = FI.nearest_shadow_resident_plain(f, s, g16, aabbs)
    for cluster in (2, 3, 8):
        assert_same(FI.rank_scan(f, s, g16, aabbs, cluster), want)


def test_rank_scan_refuses_tiles_of_part_chunks_and_empty_clusters(scenes):
    ts = scenes("veach")
    f, s = ray_rows(ts, "veach", 1)
    with pytest.raises(ValueError, match="ranks"):
        FI.rank_scan(f, s, ts.tri_feats16, ts.tile_aabbs, 0)
