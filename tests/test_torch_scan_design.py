"""The design of the one-tile scans (K1-K3, K12-K13) and the grid-form
scans (K9-K11) on the H100, held on the CPU through their torch twins in
rustic_tpu_torch/ops/flash_intersect.py:

- `pair_skip`, the test by which the kernels skip a pair's division:
  on adversarial pairs (u, v, u + v and t within a few ulps of 0, 1, EPS,
  the running best t and max t; |det| at DET_EPS; numerators that
  underflow; NaN and inf) it never skips a pair that the exact epilogue
  would take, for the nearest set (valid and strictly closer) or the
  any-hit set (valid and within max t);
- `skip_scan`, the scans rebuilt from it and the exact epilogue, equal
  bit for bit to the plain versions (K2's and K10's), which the other
  test files hold to the JAX package's scans;
- the 64-bit (t, index) key merge of the grid form over triangle ranges
  in any order, equal to the strict-< scan where a duplicated triangle
  makes exact ties;
- the live triangles: columns at or beyond `n_tris` of every committed
  scene's table are zero and those below are not, and a scan of the live
  columns equals the whole scan;
- the packed table the kernels stage, and the wrappers' `n_live`.

All exact: no tolerance."""

import glob
import os

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.scene import world as W
from rustic_tpu_torch.scene.gltf import load_glb
from tests.conftest import scene_path
from tests.test_torch_flash_grid import camera_feats as grid_camera_feats
from tests.test_torch_flash_intersect import camera_feats, random_feats
from tests.test_torch_flash_multi import shadow_feats

torch.set_num_threads(2)

F32 = np.float32


@pytest.fixture(scope="module")
def scenes():
    """name -> port scene on the CPU, built on first use (BreakTime with a
    16-texel atlas: the triangle table does not depend on it)."""
    cache = {}
    files = {"cornell": ("DarkCornell.glb", 16), "veach": ("VeachMIS.glb", 16),
             "breaktime": ("BreakTime.glb", 16)}

    def get(name):
        if name not in cache:
            path, atlas = files[name]
            cache[name] = W.World(load_glb(scene_path(path)), atlas).to_torch("cpu")
        return cache[name]

    return get


# ---- the skip test ------------------------------------------------------------------


def _taken(det, u_num, v_num, t_num, best, maxt):
    """What the exact epilogue takes: (nearest: valid and t < best,
    any-hit: valid and t <= maxt)."""
    t, valid = FI._exact(det, u_num, v_num, t_num)
    return valid & (t < best), valid & (t <= maxt)


def _skips(det, u_num, v_num, t_num, best, maxt):
    return (FI.pair_skip(det, u_num, v_num, t_num, FI.skip_limit(best)),
            FI.pair_skip(det, u_num, v_num, t_num, FI.skip_limit(maxt)))


def _assert_sound(det, u_num, v_num, t_num, best, maxt):
    """No skipped pair is one the exact epilogue takes."""
    args = [torch.as_tensor(np.asarray(x, F32)) for x in (det, u_num, v_num, t_num, best, maxt)]
    for name, skip, taken in zip(("nearest", "any-hit"), _skips(*args), _taken(*args)):
        bad = skip & taken
        assert not bool(bad.any()), (name, [a[bad][:4].tolist() for a in args])


def _nudge(x, ulps):
    """x moved by `ulps` float32 steps (ints, elementwise)."""
    x = np.atleast_1d(np.asarray(x, F32)).copy()
    ulps = np.broadcast_to(np.asarray(ulps), x.shape)
    for k in range(int(np.abs(ulps).max()) if ulps.size else 0):
        step = np.abs(ulps) > k
        x[step] = np.nextafter(x[step], np.where(ulps[step] > 0, F32(np.inf), F32(-np.inf)))
    return x


SPECIAL = [0.0, -0.0, 1e-45, 1e-40, 1e-30, F32(FI.DET_EPS), 1e-3, 0.5, 1.0, 2.0, 1e6, 1e30,
           3.4e38, np.inf, -np.inf, np.nan]
TARGETS = [0.0, 1.0, 0.5, FI.EPS, 1e-3 * (1 + 2**-20), 1e6, 1e-38]


@st.composite
def adversarial_pair(draw):
    """(det, u_num, v_num, t_num, best, maxt): u, v, u + v and t within a
    few ulps of a boundary, det at DET_EPS or anywhere, or special values."""
    ulps = st.integers(-6, 6)

    def nudged(x):
        return F32(_nudge(x, draw(ulps))[0])

    det = F32(draw(st.sampled_from([FI.DET_EPS, 1.0, 0.3, 7.0, 1e-5, 2.0**100, 1e20])
                   | st.floats(1e-8, 1e8)))
    det = nudged(det) * F32(draw(st.sampled_from([1, -1])))
    u = F32(draw(st.sampled_from([0.0, 1.0, 0.5, 1e-38, 2.0**-110]) | st.floats(-0.1, 1.1)))
    v = F32(draw(st.sampled_from([0.0, 1.0 - float(u), 0.5, 1e-38]) | st.floats(-0.1, 1.1)))
    t = F32(draw(st.sampled_from(TARGETS) | st.floats(-1.0, 100.0)))
    nums = [nudged(F32(x) * det) for x in (u, v, t)]
    for k in range(3):
        if draw(st.integers(0, 9)) == 0:
            nums[k] = F32(draw(st.sampled_from(SPECIAL)))
    if draw(st.integers(0, 9)) == 0:
        det = F32(draw(st.sampled_from(SPECIAL)))
    t_exact = FI._exact(*(torch.tensor([x], dtype=torch.float32) for x in (det, *nums)))[0]
    near = float(t_exact[0]) if np.isfinite(float(t_exact[0])) else float(t)
    best = nudged(draw(st.sampled_from([near, FI.BIG, 1.0])))
    maxt = nudged(draw(st.sampled_from([near, 1e30, -1.0, np.inf, np.nan, 0.0])))
    if not np.isfinite(best) or best < 0:
        best = F32(FI.BIG)
    return det, *nums, best, maxt


@settings(max_examples=400, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(adversarial_pair())
def test_pair_skip_never_skips_a_pair_the_exact_epilogue_takes(pair):
    _assert_sound(*(np.array([x], F32) for x in pair))


def test_pair_skip_keeps_infinite_t_against_infinite_max_t():
    """t = inf is a valid hit within max t = inf: the exact epilogue takes
    it for the any-hit set, so the limit test must not skip it."""
    det, u, v, t = (np.array([x], F32) for x in (1.0, 0.25, 0.25, np.inf))
    _assert_sound(det, u, v, t, np.array([FI.BIG], F32), np.array([np.inf], F32))
    args = [torch.from_numpy(x) for x in (det, u, v, t, np.array([FI.BIG], F32),
                                          np.array([np.inf], F32))]
    assert bool(_taken(*args)[1].all())


def test_pair_skip_is_sound_on_a_sweep_of_boundary_pairs():
    """~1e6 pairs: u, v, u + v and t at their boundaries, nudged by up to
    4 ulps each, |det| from DET_EPS up, best and max t at the pair's t."""
    rng = np.random.default_rng(7)
    n = 1 << 20
    det = np.where(rng.random(n) < 0.2, F32(FI.DET_EPS),
                   F32(10.0) ** rng.uniform(-6, 6, n).astype(F32)).astype(F32)
    det = _nudge(det, rng.integers(-3, 4, n)) * rng.choice(F32([-1, 1]), n)
    pick = rng.integers(0, 4, n)
    u = np.choose(pick, [np.zeros(n), np.ones(n), rng.random(n), np.full(n, 2.0**-120)]).astype(F32)
    v = np.choose(rng.integers(0, 3, n), [np.zeros(n), 1.0 - u, rng.random(n)]).astype(F32)
    t = np.choose(rng.integers(0, 3, n), [np.full(n, FI.EPS), rng.uniform(0, 10, n),
                                          np.full(n, FI.BIG)]).astype(F32)
    nums = [_nudge(x * det, rng.integers(-4, 5, n)) for x in (u, v, t)]
    t_pair = FI._exact(*(torch.from_numpy(x) for x in (det, *nums)))[0].numpy()
    t_pair = np.where(np.isfinite(t_pair), t_pair, t)
    best = _nudge(np.where(rng.random(n) < 0.8, t_pair, F32(FI.BIG)), rng.integers(-2, 3, n))
    best = np.where(best > 0, best, F32(FI.BIG)).astype(F32)
    maxt = _nudge(t_pair, rng.integers(-2, 3, n))
    _assert_sound(det, *nums, best, maxt)
    # not vacuous: pairs this close to a boundary still skip, a fifth of them
    args = [torch.from_numpy(np.asarray(x, F32)) for x in (det, *nums, best, maxt)]
    assert float(_skips(*args)[0].float().mean()) > 0.1


# ---- the scans rebuilt from it ----------------------------------------------------------


def _one_tile_rays(ts, kind, seed):
    if kind == "camera":
        f = camera_feats(seed)
    else:
        f = random_feats(seed)
    return torch.from_numpy(f), torch.from_numpy(shadow_feats(ts, seed + 1))


@pytest.mark.parametrize("kind", ["camera", "random"])
def test_one_tile_skip_scan_equals_k2_plain(scenes, kind):
    ts = scenes("cornell")
    f, s = _one_tile_rays(ts, kind, 3)
    t_p, i_p, o_p, _ = FI.nearest_shadow_attrs_plain(f, s, ts.tri_feats16, ts.tri_attrs)
    t, idx, occ, stats = FI.skip_scan(f, s, ts.tri_feats16, n_live=ts.n_tris)
    assert torch.equal(t, t_p) and torch.equal(idx, i_p) and torch.equal(occ, o_p)
    assert 0 < int(stats[0, 1]) < int(stats[0, 0])  # some pairs divide, most do not


@pytest.mark.parametrize("name", ["veach", "breaktime"])
def test_grid_skip_scan_equals_k10_plain(scenes, name):
    ts = scenes(name)
    f = torch.from_numpy(grid_camera_feats(name, 5))[:, :500].contiguous()
    s = torch.from_numpy(shadow_feats(ts, 6))[:, :500].contiguous()
    t_p, i_p, o_p, vis = FI._grid_scan(f, s, ts.tri_feats16, ts.tile_aabbs)[:4]
    t, idx, occ, stats = FI.skip_scan(f, s, ts.tri_feats16, ts.tile_aabbs, ts.n_tris)
    assert torch.equal(t, t_p) and torch.equal(idx, i_p) and torch.equal(occ, o_p)
    o11 = FI.skip_scan(None, s, ts.tri_feats16, ts.tile_aabbs, ts.n_tris)[2]
    assert torch.equal(o11, FI.occlude_grid_plain(s, ts.tri_feats16, ts.tile_aabbs))
    assert int(stats[0, 1]) < int(stats[0, 0]) // 10


def _with_duplicate(g16, src: int, dst: int):
    """A one-tile table with triangle `src` copied into column `dst`."""
    tt = FI.geometry(g16)[1]
    g = g16.clone()
    for q in range(4):
        g[:, q * tt + dst] = g16[:, q * tt + src]
    return g


def _aimed_rays(ts, tri: int, n: int, seed: int):
    """Rays from random points of the box through triangle `tri`'s centroid."""
    rng = np.random.default_rng(seed)
    verts = W.World(load_glb(scene_path("DarkCornell.glb")), 16)
    c = verts.positions[verts.triangles[tri, :3]].mean(axis=0)
    ro = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n, 3)).astype(F32)
    rd = (c - ro).astype(F32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    f = np.zeros((16, n), F32)
    f[0:3], f[3:6], f[6:9], f[9] = rd.T, np.cross(ro, rd).T, ro.T, 1.0
    return torch.from_numpy(f)


@pytest.mark.parametrize("seed", [0, 1])
def test_key_merge_over_shuffled_ranges_equals_the_strict_scan(scenes, seed):
    """Triangle 0 duplicated at the last padding column: every ray through
    it ties exactly; per-range (min, first index) keys merged by min in a
    shuffled order give the strict-< scan's winner, the first index."""
    ts = scenes("cornell")
    tt = FI.geometry(ts.tri_feats16)[1]
    g = _with_duplicate(ts.tri_feats16, 0, tt - 1)
    f = torch.cat([_aimed_rays(ts, 0, 300, seed), torch.from_numpy(random_feats(seed))], dim=1)
    t_ref, i_ref = FI.nearest_plain(f, g)
    t, valid = FI._epilogue(f, g, tt)
    tm = torch.where(valid, t, FI.BIG)
    assert int((tm[:, 0] == tm[:, tt - 1]).logical_and(valid[:, 0]).sum()) > 100  # exact ties
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, tt), 7, replace=False))
    ranges = list(zip([0, *cuts], [*cuts, tt]))
    rng.shuffle(ranges)
    key = FI.win_key(torch.full_like(t_ref, FI.BIG), torch.zeros_like(i_ref))
    for lo, hi in ranges:
        part = tm[:, lo:hi]
        arg = torch.argmin(part, dim=1)
        key = torch.minimum(key, FI.win_key(part.gather(1, arg[:, None])[:, 0], arg + lo))
    assert torch.equal(FI.win_t(key), t_ref) and torch.equal(FI.win_idx(key), i_ref)
    assert bool((i_ref[:300] == 0).any())  # the tie went to the first index


# ---- live triangles -------------------------------------------------------------------


@pytest.mark.parametrize("path", sorted(glob.glob(scene_path("*.glb"))), ids=os.path.basename)
def test_padding_columns_are_zero_and_live_ones_are_not(path):
    gltf = load_glb(path)
    n = len(gltf.triangles)
    g16 = W.pack_tri_feats16(W._triangle_features(gltf.positions, gltf.triangles[:, :3]))
    t_pad = g16.shape[1] // 4
    tt = W.tile_size(t_pad)
    cols = g16.reshape(16, t_pad // tt, 4, tt).transpose(0, 2, 1, 3).reshape(16 * 4, t_pad)
    nonzero = (cols != 0).any(axis=0)
    assert not nonzero[n:].any() and nonzero[:n].all()


def test_live_scan_equals_the_whole_scan(scenes):
    ts = scenes("cornell")
    f, s = _one_tile_rays(ts, "random", 11)
    live = FI.skip_scan(f, s, ts.tri_feats16, n_live=ts.n_tris)
    whole = FI.skip_scan(f, s, ts.tri_feats16)
    for a, b in zip(live[:3], whole[:3]):
        assert torch.equal(a, b)
    assert int(live[3][0, 0]) * FI.geometry(ts.tri_feats16)[1] == int(whole[3][0, 0]) * ts.n_tris


# ---- the packed table and the wrappers ------------------------------------------------------


def test_packed_table_matches_stage_chunks_index_formula(scenes):
    ts = scenes("veach")
    g16 = ts.tri_feats16
    _, tt, nt = FI.geometry(g16)
    pg = FI.pack_table(g16)
    assert pg.shape == (nt, 10, tt, 4)
    # unpacked again, the ten used rows come back
    assert torch.equal(pg.permute(1, 0, 3, 2).reshape(10, nt * 4 * tt), g16[:10])
    flat, gflat = pg.reshape(-1), g16.reshape(-1)
    row_stride = 4 * tt * nt
    rng = np.random.default_rng(0)
    for tile, r, c0, j, q in zip(rng.integers(0, nt, 500), rng.integers(0, 10, 500),
                                 rng.choice([0, 128, 256, 384], 500), rng.integers(0, 128, 500),
                                 rng.integers(0, 4, 500)):
        # stage_chunk: g[r * row_stride + tile * 4 * TT + q * TT + c0 + j]
        want = gflat[r * row_stride + tile * 4 * tt + q * tt + c0 + j]
        # stage_packed: pg[(tile * NROWS + r) * TT + c0 + j], component q
        assert flat[((tile * 10 + r) * tt + c0 + j) * 4 + q] == want


def test_packed_table_is_cached_per_table_version(scenes):
    g16 = scenes("cornell").tri_feats16.clone()
    first = FI.packed_table(g16)
    assert FI.packed_table(g16) is first
    g16.mul_(1.0)  # an in-place edit: a new version
    assert FI.packed_table(g16) is not first
    assert torch.equal(FI.packed_table(g16), first)


def test_wrappers_take_n_live_and_refuse_values_outside_the_table(scenes):
    ts = scenes("cornell")
    f, s = _one_tile_rays(ts, "camera", 2)
    g16, attrs, n = ts.tri_feats16, ts.tri_attrs, ts.n_tris
    width = FI.geometry(g16)[0]
    for a, b in zip(FI.nearest_shadow_attrs(f, s, g16, attrs, n),
                    FI.nearest_shadow_attrs(f, s, g16, attrs)):
        assert torch.equal(a, b)
    calls = [lambda k: FI.nearest_attrs(f, g16, attrs, k),
             lambda k: FI.nearest_shadow_attrs(f, s, g16, attrs, k),
             lambda k: FI.occlude(s, g16, k), lambda k: FI.nearest(f, g16, k),
             lambda k: FI.nearest_shadow(f, s, g16, k)]
    vt = scenes("veach")
    fv = torch.from_numpy(grid_camera_feats("veach", 1))
    calls += [lambda k: FI.nearest_grid(fv, vt.tri_feats16, vt.tile_aabbs, n_live=k),
              lambda k: FI.nearest_shadow_grid(fv, fv, vt.tri_feats16, vt.tile_aabbs, n_live=k),
              lambda k: FI.occlude_grid(fv, vt.tri_feats16, vt.tile_aabbs, n_live=k)]
    for i, call in enumerate(calls):
        top = width if i < 5 else FI.geometry(vt.tri_feats16)[0]
        call(1), call(top)
        for bad in (0, -1, top + 1, 1.5, True):
            with pytest.raises(ValueError, match="n_live"):
                call(bad)
