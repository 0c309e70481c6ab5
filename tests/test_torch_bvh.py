"""The "bvh" engine of the port against the JAX package's: the builder's
nodes, the traversal (`intersect_bvh` / `occlude_bvh`, the plain version
of kernel K20), and the renders that take it ("auto" on the CPU above 64
triangles, `backend="cpu"`, `compare_engines`' default engines).

Both packages build their Worlds by default, with their C++ builders
(native/bvh.cpp, and the port's copy csrc/bvh_build.cpp); the builder
tests hold each of the port's two builders to its JAX twin.

Tolerances. Nodes and permutation: equal. Traversal: `hit` and
`backface` equal on every lane; t, u and v within rtol 1e-5 (u and v
also atol 1e-6: barycentrics near an edge are near 0), except on the
lanes whose Moller-Trumbore dots cancel, which are held to rtol 1e-4.
XLA's CPU contracts those products into FMAs and torch does not, and a
dot that cancels magnifies the difference by its condition number. The
rule: a lane cancels when the condition number of the value's numerator
dot plus that of the determinant, sum |x_i y_i| / |sum x_i y_i| in
float64, exceeds CANCEL_COND. `tri_idx` equal except on near-ties, lanes
where the other package's triangle gives the same t within that
tolerance (a ray through a shared edge or vertex), which are counted and
named. Films: rtol 1e-4, atol 1e-5, as the other film tests.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rustic_tpu.ops import intersect as JI
from rustic_tpu.ops import trace as JT
from rustic_tpu.scene import bvh as JB
from rustic_tpu.scene import bvh_native
from rustic_tpu.scene.world import World as JaxWorld
from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
from rustic_tpu_torch.ops import bvh_traverse as BT
from rustic_tpu_torch.ops import intersect as I
from rustic_tpu_torch.ops import trace as T
from rustic_tpu_torch.runtime.render import pixel_offsets, render_pixels
from rustic_tpu_torch.scene import bvh as TB
from rustic_tpu_torch.scene.gltf import load_glb
from rustic_tpu_torch.scene.world import World, scene_from_arrays
from tests.conftest import scene_path
from tests.test_torch_bvh_native import require_jax_native
from tests.test_torch_flash_multi import VEACH_CAM

torch.set_num_threads(2)

SCENES = ("DarkCornell", "VeachMIS")
CAMS = {"DarkCornell": {}, "VeachMIS": VEACH_CAM}
RTOL = 1e-5
CANCEL_COND = 100.0  # an f32 dot then loses about 100 ulp: 1e-5 of its value


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX scene, the port's scene from the same arrays, the port's
    own World's scene)."""
    cache = {}

    def get(name):
        if name not in cache:
            require_jax_native()
            js = JaxWorld.from_path(scene_path(f"{name}.glb")).to_device()
            fields = {k: np.asarray(getattr(js, k)) for k in (
                "tri_feats16", "tri_attrs", "entry_rows", "tile_aabbs", "bvh_min", "bvh_max",
                "bvh_left_first", "bvh_count")}
            for k in ("n_tris", "n_alias_entries", "has_lights", "has_glass", "has_textures"):
                fields[k] = getattr(js, k)
            own = World.from_path(scene_path(f"{name}.glb")).to_torch("cpu")
            cache[name] = (js, scene_from_arrays(fields, "cpu"), own)
        return cache[name]

    return get


def random_rays(ts, n, seed):
    """Origins inside the scene's bounds, directions uniform on the sphere,
    and shadow-ray lengths."""
    rng = np.random.default_rng(seed)
    lo, hi = ts.bvh_min[0].numpy(), ts.bvh_max[0].numpy()
    ro = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    rd = rng.normal(0, 1, (n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[:8] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0],  # axis rays: the clamp of 1/rd
              [0, -0.0, 1], [-0.0, 0, -1], [0.6, 0.8, 0], [0, 0.6, -0.8]]
    maxt = rng.uniform(0.05, float(np.linalg.norm(hi - lo)), n).astype(np.float32)
    return ro, rd, maxt


# ---- the builder ---------------------------------------------------------------------


def soup(seed, n=700):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-5, 5, (n, 3))
    verts = (centres[:, None, :] + rng.normal(0, 0.3, (n, 3, 3))).reshape(-1, 3)
    tris = np.zeros((n, 4), np.int32)
    tris[:, :3] = np.arange(3 * n).reshape(n, 3)
    tris[:, 3] = rng.integers(0, 3, n)
    return verts.astype(np.float32), tris


@pytest.mark.parametrize("case", ["DarkCornell", "VeachMIS", "soup0", "soup1"])
def test_nodes_match_the_jax_numpy_builder(case):
    if case.startswith("soup"):
        verts, tris = soup(int(case[-1]))
    else:
        g = load_glb(scene_path(f"{case}.glb"))
        verts, tris = g.positions, g.triangles
    bvh, perm = TB.build_bvh(verts, tris, use_native=False)
    jbvh, jperm = JB._build_bvh_numpy(verts, tris, 128)
    np.testing.assert_array_equal(perm, jperm)
    for name in ("aabb_min", "aabb_max", "left_first", "count"):
        got, want = getattr(bvh, name), getattr(jbvh, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert bvh.n_nodes == jbvh.n_nodes > 1


@pytest.mark.parametrize("case", ["DarkCornell", "VeachMIS", "soup0", "soup1"])
def test_nodes_match_the_jax_native_builder(case):
    require_jax_native()
    if case.startswith("soup"):
        verts, tris = soup(int(case[-1]))
    else:
        g = load_glb(scene_path(f"{case}.glb"))
        verts, tris = g.positions, g.triangles
    bvh, perm = TB.build_bvh(verts, tris)
    jbvh, jperm = bvh_native.build_bvh(verts, tris, 128)
    np.testing.assert_array_equal(perm, jperm)
    for name in ("aabb_min", "aabb_max", "left_first", "count"):
        got, want = getattr(bvh, name), getattr(jbvh, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert bvh.n_nodes == jbvh.n_nodes > 1


def test_world_uploads_the_nodes(scenes):
    js, from_arrays, own = scenes("VeachMIS")
    for ts in (from_arrays, own):
        assert ts.bvh_left_first.dtype == ts.bvh_count.dtype == torch.int32
        for name in ("bvh_min", "bvh_max", "bvh_left_first", "bvh_count"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    # the leaves index the shading rows, whose vertex columns are the JAX scene's
    pos = np.asarray(js.positions)[np.asarray(js.tri_vidx)].reshape(-1, 9)
    np.testing.assert_array_equal(own.tri_attrs[: own.n_tris, 0:9].numpy(), pos)


def test_validate_bvh():
    verts, tris = soup(2, 300)
    bvh, perm = TB.build_bvh(verts, tris)
    pts = verts[tris[perm, :3]]
    tri_min, tri_max = pts.min(axis=1), pts.max(axis=1)
    TB.validate_bvh(bvh, tri_min, tri_max)
    leaves = np.nonzero(bvh.count > 0)[0]
    small = TB.BVH(bvh.aabb_min.copy(), bvh.aabb_max.copy(), bvh.left_first, bvh.count)
    small.aabb_max[leaves[0]] = small.aabb_min[leaves[0]]
    with pytest.raises(ValueError, match="box"):
        TB.validate_bvh(small, tri_min, tri_max)
    inf = np.full_like(bvh.aabb_min, np.inf)  # every box holds everything: only the ranges fail
    twice = TB.BVH(-inf, inf, bvh.left_first.copy(), bvh.count)
    twice.left_first[leaves[1]] = twice.left_first[leaves[0]]
    with pytest.raises(ValueError, match="overlap"):
        TB.validate_bvh(twice, tri_min, tri_max)
    with pytest.raises(ValueError, match="not referenced"):
        TB.validate_bvh(bvh, np.vstack([tri_min, tri_min[:1]]), np.vstack([tri_max, tri_max[:1]]))


# ---- the traversal -----------------------------------------------------------------


def mt_conditions(ts, ro, rd, idx):
    """The condition numbers of t, u and v of each lane's triangle: that of
    the value's numerator dot plus the determinant's, in float64."""
    v = ts.tri_attrs[:, 0:9].numpy().astype(np.float64)[idx]
    a, ro, rd = v[:, 0:3], ro.astype(np.float64), rd.astype(np.float64)
    e1, e2 = v[:, 3:6] - a, v[:, 6:9] - a
    pv, tv = np.cross(rd, e2), ro - a
    qv = np.cross(tv, e1)

    def cond(x, y):
        return np.abs(x * y).sum(1) / np.maximum(np.abs((x * y).sum(1)), 1e-300)

    det = cond(e1, pv)
    return {"t": cond(e2, qv) + det, "u": cond(tv, pv) + det, "v": cond(rd, qv) + det}


def close_enough(got, want, atol, cond):
    """Within RTOL on every lane whose dots do not cancel (cond <=
    CANCEL_COND), within 10 x RTOL on the lanes whose dots do."""
    calm = cond <= CANCEL_COND
    np.testing.assert_allclose(got[calm], want[calm], rtol=RTOL, atol=atol)
    np.testing.assert_allclose(got[~calm], want[~calm], rtol=10 * RTOL, atol=atol)


def near_ties(ts, ro, rd, got, want):
    """Lanes whose winners differ; each must be a near-tie: the other
    triangle's own t equals this lane's t within RTOL -> their count."""
    differ = np.nonzero(got.tri_idx.numpy() != np.asarray(want.tri_idx))[0]
    if len(differ):
        verts = ts.tri_attrs[:, 0:9]
        other = verts[torch.from_numpy(np.asarray(want.tri_idx)[differ]).long()]
        t, *_ = I._mt_single(other[:, 0:3], other[:, 3:6], other[:, 6:9],
                             ro[differ], rd[differ])
        np.testing.assert_allclose(t.numpy(), got.t.numpy()[differ], rtol=RTOL,
                                   err_msg=f"lanes {differ.tolist()} are not near-ties")
    return len(differ)


@pytest.mark.parametrize("name", SCENES)
def test_traversal_matches_jax(scenes, name):
    js, ts, _ = scenes(name)
    ro, rd, maxt = random_rays(ts, 3000, seed=5)
    want = JI.intersect_bvh(js, jnp.asarray(ro), jnp.asarray(rd))
    ro_t, rd_t = torch.from_numpy(ro), torch.from_numpy(rd)
    got = I.intersect_bvh(ts, ro_t, rd_t)
    assert got.tri_idx.dtype == torch.int32 and got.t.dtype == torch.float32
    assert 0.3 < float(got.hit.float().mean()) <= 1.0
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_array_equal(got.backface.numpy(), np.asarray(want.backface))
    hit = got.hit.numpy()
    cond = mt_conditions(ts, ro[hit], rd[hit], got.tri_idx.numpy()[hit])
    assert (cond["t"] > CANCEL_COND).mean() < 0.01  # the looser limit stays the exception
    for key, atol in (("t", 0.0), ("u", 1e-6), ("v", 1e-6)):
        close_enough(getattr(got, key).numpy()[hit], np.asarray(getattr(want, key))[hit], atol,
                     cond[key])
    assert near_ties(ts, ro_t, rd_t, got, want) <= 3
    occ_j = JI.occlude_bvh(js, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(maxt))
    occ = I.occlude_bvh(ts, ro_t, rd_t, torch.from_numpy(maxt))
    assert occ.dtype == torch.bool and 0.05 < float(occ.float().mean()) < 0.95
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_j))


@pytest.mark.parametrize("name", SCENES)
def test_bvh_matches_brute(scenes, name):
    """Inside the port: the traversal finds brute force's hits."""
    _, ts, _ = scenes(name)
    ro, rd, maxt = (torch.from_numpy(a) for a in random_rays(ts, 2000, seed=6))
    got = I.intersect_nearest(ts, ro, rd, engine="bvh")
    want = I.intersect_nearest(ts, ro, rd, engine="brute")
    assert torch.equal(got.hit, want.hit)
    assert near_ties(ts, ro, rd, got, want) <= 3
    # brute force sums t = (ro.n - a.n) / det from the matrix product
    np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), rtol=1e-4)
    assert torch.equal(I.intersect_any(ts, ro, rd, maxt, engine="bvh"),
                       I.intersect_any(ts, ro, rd, maxt, engine="brute"))


def test_counters_count_the_steps(scenes):
    _, ts, _ = scenes("DarkCornell")
    ro, rd, _ = (torch.from_numpy(a) for a in random_rays(ts, 500, seed=7))
    res, pops, tests = I.bvh_traverse_plain(ts, ro, rd, counters=True)
    assert torch.equal(res.t, I.intersect_bvh(ts, ro, rd).t)
    assert int(pops.min()) >= 1 and int(tests.max()) >= 1
    # every pushed node is popped, and a node's triangles are all tested
    assert int(pops.sum()) > int(tests.gt(0).sum())


def chain_scene(depth):
    """A tree deeper than the stack: internal node I_k has children
    (I_k+1, L_k) with equal boxes, so the near child is always I_k+1 and
    the stack grows by one a level; leaf L_k holds triangle k, a square
    half crossing the z axis at z = 40 - k (the deepest is the nearest).
    -> (JAX-side namespace, port-side namespace, n triangles)."""
    n = depth + 1
    tri = []
    for k in range(n):
        z = 40.0 - k
        tri.append([[-1, -1, z], [3, -1, z], [-1, 3, z]])
    verts = np.asarray(tri, np.float32).reshape(-1, 3)
    vidx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    internal = [0] + [2 * k - 1 for k in range(1, depth)]
    n_nodes = 2 * depth + 1
    left_first = np.zeros(n_nodes, np.int32)
    count = np.zeros(n_nodes, np.int32)
    for k, node in enumerate(internal):
        left_first[node] = 2 * k + 1  # (I_k+1 or the last leaf, L_k)
        leaf = 2 * k + 2
        left_first[leaf], count[leaf] = k, 1
    last = 2 * depth - 1
    left_first[last], count[last] = depth, 1
    lo = np.tile(np.array([-2, -2, 0], np.float32), (n_nodes, 1))
    hi = np.tile(np.array([4, 4, 50], np.float32), (n_nodes, 1))
    jscene = types.SimpleNamespace(
        positions=jnp.asarray(verts), tri_vidx=jnp.asarray(vidx), bvh_min=jnp.asarray(lo),
        bvh_max=jnp.asarray(hi), bvh_left_first=jnp.asarray(left_first),
        bvh_count=jnp.asarray(count))
    rows = np.zeros((n, 32), np.float32)
    rows[:, 0:9] = verts.reshape(n, 9)
    tscene = types.SimpleNamespace(
        tri_attrs=torch.from_numpy(rows), bvh_min=torch.from_numpy(lo),
        bvh_max=torch.from_numpy(hi), bvh_left_first=torch.from_numpy(left_first),
        bvh_count=torch.from_numpy(count), n_tris=n)
    return jscene, tscene, n


def test_a_full_stack_drops_pushes_as_jax_does():
    jscene, tscene, n = chain_scene(40)
    ro = np.array([[0.5, 0.5, -5.0], [0.2, 0.1, 60.0]], np.float32)
    rd = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], np.float32)
    maxt = np.array([100.0, 100.0], np.float32)
    want = JI.intersect_bvh(jscene, jnp.asarray(ro), jnp.asarray(rd))
    got = I.bvh_traverse_plain(tscene, torch.from_numpy(ro), torch.from_numpy(rd))
    np.testing.assert_array_equal(got.tri_idx.numpy(), np.asarray(want.tri_idx))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=RTOL)
    # ray 0's nearest triangle (the deepest leaf) sits below the dropped
    # pushes and is not found; ray 1's (leaf 0, the first push) is
    assert got.hit.all() and got.tri_idx.tolist()[1] == 0
    assert got.tri_idx.tolist()[0] < n - 1 and float(got.t[0]) > 5.0 + 1.0
    occ = I.bvh_traverse_plain(tscene, torch.from_numpy(ro), torch.from_numpy(rd),
                               torch.from_numpy(maxt)).hit
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(JI.occlude_bvh(jscene, jnp.asarray(ro), jnp.asarray(rd),
                                               jnp.asarray(maxt))))


def test_wrappers_take_the_plain_version_on_the_cpu(scenes):
    _, ts, _ = scenes("DarkCornell")
    ro, rd, maxt = (torch.from_numpy(a) for a in random_rays(ts, 200, seed=8))
    BT.reset_launch_counts()
    res = BT.bvh_nearest(ts, ro, rd)
    occ = BT.bvh_occluded(ts, ro, rd, maxt)
    assert BT.LAUNCHES == {"bvh_nearest": 0, "bvh_occluded": 0}  # no kernel on the CPU
    want = I.bvh_traverse_plain(ts, ro, rd)
    for a, b in zip(res, want):
        assert torch.equal(a, b)
    assert torch.equal(occ, I.bvh_traverse_plain(ts, ro, rd, maxt).hit)
    with pytest.raises(ValueError, match="no kernel"):
        BT.bvh_nearest(ts, ro.to("meta"), rd.to("meta"))
    bare = scene_from_arrays({k: getattr(ts, k).numpy() for k in (
        "tri_feats16", "tri_attrs", "entry_rows", "tile_aabbs")} | dict(
        n_tris=ts.n_tris, n_alias_entries=ts.n_alias_entries, has_lights=ts.has_lights,
        has_glass=ts.has_glass, has_textures=False), "cpu")
    with pytest.raises(ValueError, match="no BVH nodes"):
        I.intersect_bvh(bare, ro, rd)


# ---- renders -----------------------------------------------------------------------

FILM_W, FILM_H, SPP = 32, 16, 2


def film_args(name, js, ts):
    from rustic_tpu.config import TracingConfig as JaxTracingConfig

    jcfg = JaxTracingConfig(width=FILM_W, height=FILM_H, nee=NextEventEstimation.MIS,
                            **CAMS[name])
    cfg = TracingConfig(width=FILM_W, height=FILM_H, nee=NextEventEstimation.MIS, **CAMS[name])
    y, x = np.mgrid[0:FILM_H, 0:FILM_W]
    x, y = x.reshape(-1).astype(np.int32), y.reshape(-1).astype(np.int32)
    off = pixel_offsets(FILM_W, FILM_H)
    args_j = (js, jcfg.static_part(), jcfg.dynamic_part(), jnp.asarray(x), jnp.asarray(y),
              jnp.asarray(off), jnp.uint32(3), SPP)
    args_p = (ts, cfg.static_part(), cfg.dynamic_part("cpu"), torch.from_numpy(x),
              torch.from_numpy(y), torch.from_numpy(off.view(np.int32).copy()), 3, SPP)
    return cfg, x, y, off, args_j, args_p


@pytest.mark.parametrize("name", SCENES)
def test_film_matches_jax(scenes, name):
    js, ts, _ = scenes(name)
    *_, args_j, args_p = film_args(name, js, ts)
    want = np.asarray(JT.accumulate_samples(*args_j, engine="bvh"))
    got = T.accumulate_samples(*args_p, engine="bvh").numpy()
    assert got.shape == (FILM_W * FILM_H, 3) and got.mean() > 0.005
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_render_pixels_defaults_and_the_cpu_backend(scenes):
    """With its defaults `render_pixels` takes "auto", which is "bvh" on a
    CPU scene of more than 64 triangles (it raised before the engine was
    ported); `backend="cpu"` renders the same film on a CPU scene; None
    is the staged pipeline."""
    js, ts, _ = scenes("DarkCornell")
    cfg, x, y, off, _, args_p = film_args("DarkCornell", js, ts)
    assert ts.n_tris > I.BRUTE_FORCE_MAX_TRIS
    want = T.accumulate_samples(*args_p[:6], 0, SPP, engine="bvh")
    got = render_pixels(ts, cfg, x, y, SPP, offsets=off)
    assert torch.equal(got, want)
    assert torch.equal(render_pixels(ts, cfg, x, y, SPP, offsets=off, backend="cpu"), want)
    staged = render_pixels(ts, cfg, x, y, SPP, offsets=off, engine=None)
    np.testing.assert_allclose(staged.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    film_in = torch.full_like(want, 0.5)
    assert torch.equal(render_pixels(ts, cfg, x, y, SPP, offsets=off, film_in=film_in,
                                     backend="cpu"),
                       T.accumulate_samples(*args_p[:6], 0, SPP, engine="bvh", film_in=film_in))
    with pytest.raises(ValueError, match="backend"):
        render_pixels(ts, cfg, x, y, 1, backend="gpu")


# ---- the oracle films and the gate that reads them ------------------------------------


def test_oracle_film_folds_its_chunks(scenes, monkeypatch):
    """`render_oracle_chunked` in uneven pixel and sample chunks gives the
    mean film of one `render_pixels(engine="bvh")` call over the frame
    (rtol 1e-6: the chunks' sums fold in another order)."""
    from rustic_tpu_torch import make_reference_films as MRF

    _, _, own = scenes("DarkCornell")
    monkeypatch.setattr(MRF, "SPP_CHUNK", 2)
    monkeypatch.setattr(MRF, "PX_CHUNK", 100)
    w, h, spp = 16, 8, 5
    cfg = TracingConfig(width=w, height=h, nee=NextEventEstimation.MIS)
    got = MRF.render_oracle_chunked(own, cfg, spp)
    y, x = np.mgrid[0:h, 0:w]
    want = render_pixels(own, cfg, x.reshape(-1).astype(np.int32), y.reshape(-1).astype(np.int32),
                         spp, offsets=pixel_offsets(w, h, use_blue_noise=False), engine="bvh")
    assert got.shape == (h, w, 3) and got.mean() > 0.005
    np.testing.assert_allclose(got, want.numpy().reshape(h, w, 3) / spp, rtol=1e-6, atol=1e-7)


def test_quality_gate_finds_the_oracle_film_by_name(scenes, tmp_path):
    """An at-spec case is read from the reference directory under
    `film_name`; a missing film is reported and skipped; the artifact
    holds every row."""
    import json

    from rustic_tpu_torch import make_reference_films as MRF
    from rustic_tpu_torch import quality_gate as QG

    assert QG.FILM_CASES[-len(MRF.CASES):] == MRF.CASES
    _, _, own = scenes("DarkCornell")
    case = ("DarkCornell.glb", None, (16, 8), 2, {})
    name = MRF.film_name("DarkCornell.glb", 16, 8, 2)
    assert name == "darkcornell_16x8_2spp_bvh_torch.npy"
    gate = QG.Gate(str(tmp_path / "gate.json"))
    QG.film_rmse(gate, [case], str(tmp_path), "cpu")
    assert gate.results[-1] == dict(gate="rmse", scene="DarkCornell.glb", film=name,
                                    error="reference film missing")
    cfg = TracingConfig(width=16, height=8, nee=NextEventEstimation.MIS)
    np.save(tmp_path / name, MRF.render_oracle_chunked(own, cfg, 2))
    QG.film_rmse(gate, [case], str(tmp_path), "cpu")
    row = gate.results[-1]
    assert row["film"] == name and row["size"] == "16x8" and row["spp"] == 2
    assert row["ok"] and 0.0 <= row["rmse"] < 1e-3 and row["ref_mean"] > 0.005
    assert json.loads((tmp_path / "gate.json").read_text())["results"] == gate.results
