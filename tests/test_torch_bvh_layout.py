"""The packed tables of the BVH traversal kernel (K20, csrc/bvh_traverse.cu)
and the order in which it walks them.

The upload (scene/world.py `_scene_tensors`) packs each scene's nodes into
32-byte records (scene/bvh.py `node_records`) and its triangles into
{a, e1, e2} records (scene/world.py `triangle_records`); the kernel's
stack entries carry a node's (left_first, count) packed into 32 bits. The
kernel itself runs only on the card, so these tests hold what surrounds
it here: the tables turn back into the struct of arrays and the vertex
columns bit for bit, the entry's width is checked, and `walk`, a per-lane
walker in plain Python over the packed tables in the kernel's order
(while-while: pop until a leaf, then its triangles; the stack carries the
entries), gives the plain version's results bit for bit, full-stack drops
included. All comparisons are exact: the walker and the kernel do the
plain version's float32 operations in its order.
"""

import numpy as np
import pytest
import torch

from rustic_tpu_torch.ops import bvh_traverse as BT
from rustic_tpu_torch.ops import intersect as I
from rustic_tpu_torch.ops.flash_intersect import BIG, DET_EPS
from rustic_tpu_torch.ops.sampling import EPS
from rustic_tpu_torch.runtime.render import pixel_offsets
from rustic_tpu_torch.scene import bvh as TB
from rustic_tpu_torch.scene import world as W
from rustic_tpu_torch.scene.world import World, scene_from_arrays
from tests.conftest import scene_path
from tests.test_torch_bvh import chain_scene, random_rays, soup

torch.set_num_threads(2)

CASES = ("DarkCornell", "VeachMIS", "soup0", "soup1", "chain40")
F32 = np.float32


def upload(bvh, rows, n_tris):
    """The port's upload of `bvh` and shading `rows` [T, W] on the CPU
    (the flash and light tables are stand-ins: only the BVH's are read)."""
    return W._scene_tensors(
        np.zeros((16, 4), np.float32), rows, np.zeros((1, 16), np.float32),
        np.zeros((1, 8), np.float32), W._empty_atlas(), None, bvh, "cpu", n_tris=n_tris,
        n_alias_entries=0, has_lights=False, has_glass=False, has_textures=False)


@pytest.fixture(scope="module")
def scenes():
    """case -> the port's SceneTensors on the CPU, packed tables included."""
    cache = {}

    def get(case):
        if case not in cache:
            if case.startswith("soup"):
                verts, tris = soup(int(case[-1]))
                # soup0 through the C++ builder (the default order), soup1 through NumPy
                bvh, perm = TB.build_bvh(verts, tris, use_native=case == "soup0")
                rows = np.zeros((len(tris), 32), np.float32)
                rows[:, 0:9] = verts[tris[perm, :3]].reshape(-1, 9)
                cache[case] = upload(bvh, rows, len(tris))
            elif case.startswith("chain"):
                _, ts, n = chain_scene(int(case[len("chain"):]))
                bvh = TB.BVH(ts.bvh_min.numpy(), ts.bvh_max.numpy(), ts.bvh_left_first.numpy(),
                             ts.bvh_count.numpy())
                cache[case] = upload(bvh, ts.tri_attrs.numpy(), n)
            else:
                cache[case] = World.from_path(scene_path(f"{case}.glb")).to_torch("cpu")
        return cache[case]

    return get


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


# ---- the tables ----------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_packed_tables_give_back_the_nodes_and_vertices(scenes, case):
    ts = scenes(case)
    n, base = ts.bvh_count.shape[0], ts.bvh_node_base
    rec = ts.bvh_nodes
    assert rec.dtype == torch.float32 and tuple(rec.shape) == (base + n, 8)
    assert base == 1  # both builders put the first child pair at node 1
    assert torch.equal(bits(rec[:base]), torch.zeros((base, 8), dtype=torch.int32))
    assert torch.equal(bits(rec[base:, 0:3]), bits(ts.bvh_min))
    assert torch.equal(bits(rec[base:, 4:7]), bits(ts.bvh_max))
    assert torch.equal(bits(rec[base:, 3]), ts.bvh_left_first)
    assert torch.equal(bits(rec[base:, 7]), ts.bvh_count)
    # every child pair starts at an even record: one 64-byte line
    lefts = ts.bvh_left_first[ts.bvh_count == 0]
    assert len(lefts) and bool(((lefts + base) % 2 == 0).all())
    # the entry's count field holds the largest count
    assert 1 << ts.bvh_count_bits > int(ts.bvh_count.max()) >= 1 << (ts.bvh_count_bits - 1)

    tri = ts.bvh_tris
    assert tri.dtype == torch.float32 and tuple(tri.shape) == (ts.n_tris, 12)
    v = ts.tri_attrs[: ts.n_tris, 0:9]
    a, b, c = v[:, 0:3], v[:, 3:6], v[:, 6:9]
    assert torch.equal(bits(tri[:, 0:3]), bits(a))
    assert torch.equal(bits(tri[:, 4:7]), bits(b - a))
    assert torch.equal(bits(tri[:, 8:11]), bits(c - a))
    assert torch.equal(bits(tri[:, 3::4]), torch.zeros((ts.n_tris, 3), dtype=torch.int32))


def test_scene_from_arrays_packs_the_same_tables(scenes):
    own = scenes("VeachMIS")
    fields = {k: getattr(own, k).numpy() for k in (
        "tri_feats16", "tri_attrs", "entry_rows", "tile_aabbs", "bvh_min", "bvh_max",
        "bvh_left_first", "bvh_count")}
    fields |= dict(n_tris=own.n_tris, n_alias_entries=own.n_alias_entries,
                   has_lights=own.has_lights, has_glass=own.has_glass, has_textures=False)
    ts = scene_from_arrays(fields, "cpu")
    assert torch.equal(bits(ts.bvh_nodes), bits(own.bvh_nodes))
    assert torch.equal(bits(ts.bvh_tris), bits(own.bvh_tris))
    assert (ts.bvh_node_base, ts.bvh_count_bits) == (own.bvh_node_base, own.bvh_count_bits)
    bare = scene_from_arrays({k: v for k, v in fields.items() if not k.startswith("bvh")}, "cpu")
    assert tuple(bare.bvh_nodes.shape) == (0, 8) and tuple(bare.bvh_tris.shape) == (0, 12)


def overflowing(kind):
    """A node table the packing refuses -> (BVH, message)."""
    lo, hi = np.zeros((3, 3), np.float32), np.ones((3, 3), np.float32)
    if kind == "entry":  # a leaf of 2^20 triangles: 21 bits of count leave 11 for left_first
        return TB.BVH(lo, hi, np.array([1, 0, 4096], np.int32),
                      np.array([0, 1 << 20, 1], np.int32)), "overflow"
    if kind == "negative":
        return TB.BVH(lo, hi, np.array([1, 0, -1], np.int32),
                      np.array([0, 1, 1], np.int32)), "negative"
    # kind == "parity": the pairs (1, 2) and (4, 5) start at nodes of both parities
    lo, hi = np.zeros((6, 3), np.float32), np.ones((6, 3), np.float32)
    return TB.BVH(lo, hi, np.array([1, 4, 0, 0, 1, 2], np.int32),
                  np.array([0, 0, 1, 1, 1, 1], np.int32)), "parity"


@pytest.mark.parametrize("kind", ["entry", "negative", "parity"])
def test_nodes_that_do_not_pack_are_refused(scenes, kind):
    bvh, message = overflowing(kind)
    with pytest.raises(ValueError, match=message):
        TB.node_records(bvh)
    own = scenes("DarkCornell")
    fields = {k: getattr(own, k).numpy() for k in (
        "tri_feats16", "tri_attrs", "entry_rows", "tile_aabbs")}
    fields |= dict(bvh_min=bvh.aabb_min, bvh_max=bvh.aabb_max, bvh_left_first=bvh.left_first,
                   bvh_count=bvh.count, n_tris=own.n_tris, n_alias_entries=own.n_alias_entries,
                   has_lights=own.has_lights, has_glass=own.has_glass, has_textures=False)
    with pytest.raises(ValueError, match=message):
        scene_from_arrays(fields, "cpu")


def test_a_scene_without_packed_tables_is_refused():
    _, ts, _ = chain_scene(4)
    ro = torch.zeros((2, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="no packed BVH tables"):
        BT._checked_tables(ts, ro, ro)


# ---- the kernel's order, walked lane by lane --------------------------------------------


def _min2(a, b):
    return F32("nan") if np.isnan(a) or np.isnan(b) else (b if b < a else a)


def _max2(a, b):
    return F32("nan") if np.isnan(a) or np.isnan(b) else (b if b > a else a)


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _inv_dir(x):
    if abs(x) < F32(I.RD_CLAMP):
        x = F32(-I.RD_CLAMP) if x < 0 else F32(I.RD_CLAMP)
    return F32(1.0) / x


def walk(ts, o, d, max_t=None):
    """One ray through the scene's packed tables in the kernel's order ->
    ((t, idx, hit, backface, u, v), pushes dropped). Every stack entry is
    left_first << cbits | count, read from the parent's copy of the child's
    record; a pop loads nothing; a popped leaf's triangles follow at once."""
    with np.errstate(all="ignore"):
        return _walk(ts, o, d, max_t)


def _walk(ts, o, d, max_t):
    rec = ts.bvh_nodes.numpy()
    rec_bits = rec.view(np.uint32)
    tri = ts.bvh_tris.numpy()
    base, cbits, last = ts.bvh_node_base, ts.bvh_count_bits, ts.n_tris - 1
    big, eps, det_eps = F32(BIG), F32(EPS), F32(DET_EPS)
    inv = [_inv_dir(x) for x in d]

    def entry(r):  # a record's stack entry
        return (int(rec_bits[r, 3]) << cbits | int(rec_bits[r, 7])) & 0xFFFFFFFF

    def slab(r, prev_t):
        t1 = [(rec[r, k] - o[k]) * inv[k] for k in range(3)]
        t2 = [(rec[r, 4 + k] - o[k]) * inv[k] for k in range(3)]
        tmin = _max2(_max2(_min2(t1[0], t2[0]), _min2(t1[1], t2[1])), _min2(t1[2], t2[2]))
        tmax = _min2(_min2(_max2(t1[0], t2[0]), _max2(t1[1], t2[1])), _max2(t1[2], t2[2]))
        ok = tmax >= tmin and tmax > 0 and tmin < prev_t
        return tmin if ok else F32("inf")

    best = [big, 0, False, F32(0), F32(0)]
    stack, dropped = [entry(base)], 0
    while stack:
        e = stack.pop()
        cnt, left = e & ((1 << cbits) - 1), e >> cbits
        if cnt > 0:
            for ptr in range(left, left + cnt):
                ti = min(max(ptr, 0), last)
                a, e1, e2 = tri[ti, 0:3], tri[ti, 4:7], tri[ti, 8:11]
                pv = _cross(d, e2)
                det = _dot(e1, pv)
                good = abs(det) >= det_eps
                inv_det = F32(1.0) / det if good else F32(0)
                tv = o - a
                u = _dot(tv, pv) * inv_det
                qv = _cross(tv, e1)
                v = _dot(d, qv) * inv_det
                t = _dot(e2, qv) * inv_det
                valid = good and 0 <= u <= 1 and v >= 0 and u + v <= 1 and t > eps
                if valid and t < best[0] and (max_t is None or t <= max_t):
                    best = [t, ti, bool(det < 0), u, v]
                    if max_t is not None:
                        return (best[0], best[1], True, *best[2:]), dropped
            continue
        r = base + left
        ld, rdist = slab(r, best[0]), slab(r + 1, best[0])
        swap = ld > rdist
        near, far = (entry(r + 1), entry(r)) if swap else (entry(r), entry(r + 1))
        near_d, far_d = (rdist, ld) if swap else (ld, rdist)
        for child, dist in ((far, far_d), (near, near_d)):
            if np.isfinite(dist):
                if len(stack) < I.STACK_DEPTH:
                    stack.append(child)
                else:
                    dropped += 1
    return (best[0], best[1], bool(best[0] < big), *best[2:]), dropped


def walk_all(ts, ro, rd, max_t=None):
    """`walk` on every ray -> (TraceResult, pushes dropped in all)."""
    out, dropped = [], 0
    for i in range(ro.shape[0]):
        res, n = walk(ts, ro[i], rd[i], None if max_t is None else max_t[i])
        out.append(res)
        dropped += n
    t, idx, hit, back, u, v = zip(*out)
    return I.TraceResult(
        torch.from_numpy(np.array(t, np.float32)), torch.tensor(idx, dtype=torch.int32),
        torch.tensor(hit), torch.tensor(back), torch.from_numpy(np.array(u, np.float32)),
        torch.from_numpy(np.array(v, np.float32))), dropped


def chain_rays(n):
    """Rays down and up the chain's axis: the downward ones fill the stack."""
    rng = np.random.default_rng(11)
    ro = np.zeros((n, 3), np.float32)
    rd = np.zeros((n, 3), np.float32)
    ro[:, 0:2] = rng.uniform(0.05, 0.9, (n, 2))
    ro[:, 2] = np.where(np.arange(n) % 2 == 0, -5.0, 60.0)
    rd[:, 2] = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    maxt = rng.uniform(20.0, 100.0, n).astype(np.float32)
    return ro, rd, maxt


@pytest.mark.parametrize("mode", ["nearest", "any"])
@pytest.mark.parametrize("case", ["DarkCornell", "VeachMIS", "chain40"])
def test_the_walk_over_packed_tables_equals_the_plain_version(scenes, case, mode):
    ts = scenes(case)
    ro, rd, maxt = chain_rays(40) if case.startswith("chain") else random_rays(ts, 300, seed=21)
    mt = maxt if mode == "any" else None
    got, dropped = walk_all(ts, ro, rd, mt)
    want = I.bvh_traverse_plain(ts, torch.from_numpy(ro), torch.from_numpy(rd),
                                None if mt is None else torch.from_numpy(mt))
    if mode == "any":
        assert torch.equal(got.hit, want.hit)
    else:
        for name, a, b in zip(got._fields, got, want):
            same = torch.equal(bits(a), bits(b)) if a.is_floating_point() else torch.equal(a, b)
            assert same, f"{case}: {name} differs on {int((a != b).sum())} lanes"
    assert 0 < int(want.hit.sum()) < len(ro) or case.startswith("chain")
    if case.startswith("chain"):
        assert dropped > 0  # the full stack's drops were walked, not avoided


def test_k20_operands_are_the_oracles_first_call(scenes):
    """make_reference_films `k20_operands`: every launch of the oracle's
    first trace_paths call in order, its rays as K20 took them, and the
    wrappers given back afterwards."""
    from rustic_tpu_torch import make_reference_films as MR
    from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
    from rustic_tpu_torch.ops import trace as T

    ts = scenes("VeachMIS")
    config = TracingConfig(width=16, height=12, nee=NextEventEstimation.MIS, **MR.VEACH_CAM)
    real = (BT.bvh_nearest, BT.bvh_occluded)
    ops = MR.k20_operands(ts, config, 150)
    assert (BT.bvh_nearest, BT.bvh_occluded) == real
    assert [k for k, _ in ops] == [f"K20{m} bounce {b}" for b in range(4) for m in "na"]
    for key, rays in ops:
        assert len(rays) == (2 if key.startswith("K20n") else 3)
        assert all(x.shape[0] == 150 and x.dtype == torch.float32 for x in rays)
    # bounce 0's rays are the camera's, in pixel order
    y, x = np.mgrid[0:12, 0:16]
    px = torch.from_numpy(x.reshape(-1)[:150].astype(np.int32))
    py = torch.from_numpy(y.reshape(-1)[:150].astype(np.int32))
    off = torch.from_numpy(pixel_offsets(16, 12, use_blue_noise=False)[:150])
    cfg, cam = config.static_part(), config.dynamic_part("cpu")
    st = T.init_state(cfg, cam, px, py, torch.zeros(150, dtype=torch.int32), off)
    assert torch.equal(ops[0][1][0], st.ro) and torch.equal(ops[0][1][1], st.rd)
