"""The port's multi-tile flash scans (plain versions on the CPU) against
the JAX package's default multi-tile kernels, the DMA-streamed form
(`_nearest_multi_dma` and its twins) in Pallas interpret mode under the
"f32" plan, and its admitted-tile lists (`_block_tile_lists`).

Tolerances: the lists, winner indices and occlusion are compared
exactly; t to rtol 1e-6 (the two sides may sum the 10-term numerator
dots in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rustic_tpu.ops import flash_intersect as JFI
from rustic_tpu.scene.world import World
from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.runtime.pipeline import stage_init
from rustic_tpu_torch.scene.world import scene_from_arrays
from tests.conftest import scene_path

torch.set_num_threads(2)

B = 1000  # ragged: not a multiple of the 256-ray blocks
VEACH_CAM = dict(cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05))


def scene_fields(scene) -> dict:
    out = {
        k: np.asarray(getattr(scene, k))
        for k in ("tri_feats16", "tri_attrs", "entry_rows", "tile_aabbs")
    }
    for k in ("n_tris", "n_alias_entries", "has_lights", "has_glass", "has_textures"):
        out[k] = getattr(scene, k)
    return out


@pytest.fixture(scope="module")
def veach():
    js = World.from_path(scene_path("VeachMIS.glb")).to_device()
    return js, scene_from_arrays(scene_fields(js), "cpu")


@pytest.fixture(scope="module")
def furnace(furnace_scene):
    return furnace_scene, scene_from_arrays(scene_fields(furnace_scene), "cpu")


def feats_rows(ro, rd, maxt=None) -> np.ndarray:
    f = np.zeros((16, len(ro)), np.float32)
    f[0:3] = rd.T
    f[3:6] = np.cross(ro, rd).T
    f[6:9] = ro.T
    f[9] = 1.0
    if maxt is not None:
        f[FI.SH_MAXT_COL] = maxt
    return f


def camera_feats(seed: int, cam: dict, coherent: bool = False) -> np.ndarray:
    """Camera rays of random pixels, or (coherent) of B consecutive
    pixels in scan order, as the render's ray blocks hold them."""
    rng = np.random.default_rng(seed)
    config = TracingConfig(width=1024, height=1024, nee=NextEventEstimation.MIS, **cam)
    if coherent:
        ids = 400 * config.width + np.arange(B)
        px = torch.from_numpy((ids % config.width).astype(np.int32))
        py = torch.from_numpy((ids // config.width).astype(np.int32))
    else:
        px = torch.from_numpy(rng.integers(0, config.width, B).astype(np.int32))
        py = torch.from_numpy(rng.integers(0, config.height, B).astype(np.int32))
    off = torch.from_numpy(rng.integers(0, 2**32, B, dtype=np.uint32).view(np.int32))
    _st, feats, _sidx = stage_init(
        config.static_part(), config.dynamic_part("cpu"), px, py, 0, off, 1
    )
    return feats.numpy()


def random_feats(seed: int, aabbs: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(seed)
    lo, hi = aabbs[:, 0:3].min(0), aabbs[:, 4:7].max(0)
    ro = rng.uniform(lo, hi, (B, 3)).astype(np.float32)
    rd = rng.normal(0, 1, (B, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return feats_rows(ro, rd)


def shadow_feats(ts, seed: int) -> np.ndarray:
    """Shadow rays from random points in the scene's bounds toward random
    points of its light triangles, maxt = distance - 2 EPS."""
    rng = np.random.default_rng(seed)
    aabbs = ts.tile_aabbs.numpy()
    lo, hi = aabbs[:, 0:3].min(0), aabbs[:, 4:7].max(0)
    ro = rng.uniform(lo, hi, (B, 3)).astype(np.float32)
    e = ts.entry_rows.numpy()[rng.integers(0, ts.n_alias_entries, B)]
    a, b, c = e[:, 8:11], e[:, 11:14], e[:, 14:17]
    r1 = np.sqrt(rng.uniform(0, 1, (B, 1)))
    r2 = rng.uniform(0, 1, (B, 1))
    target = ((1 - r1) * a + r1 * (1 - r2) * b + r1 * r2 * c).astype(np.float32)
    d = target - ro
    dist = np.linalg.norm(d, axis=1)
    rd = (d / dist[:, None]).astype(np.float32)
    return feats_rows(ro, rd, (dist - 2e-3).astype(np.float32))


def ray_sets(ts, kind: str, seed: int):
    aabbs = ts.tile_aabbs.numpy()
    if kind in ("camera", "coherent"):
        return camera_feats(seed, VEACH_CAM, coherent=kind == "coherent")
    if kind == "random":
        return random_feats(seed, aabbs)
    return shadow_feats(ts, seed)


def jax_lists(js, flags, *feats):
    padded = [JFI._pad_rays_t(jnp.asarray(f), FI.BT_MULTI)[0] for f in feats]
    plist, pcount = JFI._block_tile_lists(js.tile_aabbs, FI.BT_MULTI, flags, *padded)
    nb = -(-B // FI.BT_MULTI)
    return np.asarray(plist).T[:nb], np.asarray(pcount)[0, :nb]


@pytest.mark.parametrize("scene_name", ["veach", "furnace"])
@pytest.mark.parametrize(
    "flags, kinds",
    [((False,), ("coherent",)), ((True,), ("shadow",)), ((False, True), ("coherent", "shadow"))],
)
def test_block_tile_lists_match_jax(request, scene_name, flags, kinds):
    js, ts = request.getfixturevalue(scene_name)
    feats = [ray_sets(ts, kind, 10 + i) for i, kind in enumerate(kinds)]
    want_l, want_c = jax_lists(js, flags, *feats)
    lists, counts = FI.block_tile_lists(
        ts.tile_aabbs, FI.BT_MULTI, flags, *(torch.from_numpy(f) for f in feats)
    )
    assert lists.dtype == torch.int32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), want_c)
    np.testing.assert_array_equal(lists.numpy(), want_l)
    nt = ts.tile_aabbs.shape[0]
    assert 0 < counts.numpy().min() and counts.numpy().max() <= nt


def lists_for(ts, flags, *feats):
    return FI.block_tile_lists(ts.tile_aabbs, FI.BT_MULTI, flags, *feats)


def assert_nearest_equal(t_j, i_j, t_p, i_p):
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=1e-6)


KW = dict(bt=FI.BT_MULTI, interpret=True, precision="f32", dma=True)


@pytest.mark.parametrize("rays", ["camera", "random"])
def test_nearest_multi_matches_jax_dma(veach, rays):
    js, ts = veach
    feats = ray_sets(ts, rays, 1)
    t_j, i_j, t2, _ = JFI._flash_nearest(
        jnp.asarray(feats.T), js.tri_feats16, js.tile_aabbs, **KW
    )
    assert t2 is None  # the "f32" plan carries no second candidate
    f = torch.from_numpy(feats)
    t_p, i_p = FI.nearest_multi(f, ts.tri_feats16, *lists_for(ts, (False,), f))
    assert i_p.dtype == torch.int32
    assert 0.3 < float((t_p < FI.BIG).float().mean()) <= 1.0  # rays do hit
    if rays == "camera":
        assert int(i_p.max()) >= 512  # winners beyond the first tile
    assert_nearest_equal(t_j, i_j, t_p, i_p)


def test_nearest_shadow_multi_matches_jax_dma(veach):
    js, ts = veach
    feats = camera_feats(3, VEACH_CAM)
    sh = shadow_feats(ts, 4)
    t_j, i_j, o_j, _, _ = JFI._flash_nearest_shadow(
        jnp.asarray(feats.T), jnp.asarray(sh.T), js.tri_feats16, js.tile_aabbs, **KW
    )
    f, s = torch.from_numpy(feats), torch.from_numpy(sh)
    t_p, i_p, o_p = FI.nearest_shadow_multi(
        f, s, ts.tri_feats16, *lists_for(ts, (False, True), f, s)
    )
    assert_nearest_equal(t_j, i_j, t_p, i_p)
    assert o_p.dtype == torch.int32
    np.testing.assert_array_equal(o_p.numpy() != 0, np.asarray(o_j))


@pytest.mark.parametrize("scene_name, seed", [("veach", 5), ("veach", 6), ("furnace", 7)])
def test_occlude_multi_matches_jax_dma(request, scene_name, seed):
    js, ts = request.getfixturevalue(scene_name)
    sh = shadow_feats(ts, seed)
    o_j = JFI._flash_occlude_packed(jnp.asarray(sh.T), js.tri_feats16, js.tile_aabbs, **KW)
    s = torch.from_numpy(sh)
    occ = FI.occlude_multi(s, ts.tri_feats16, *lists_for(ts, (True,), s)).numpy()
    assert 0.02 < occ.mean() < 0.98  # both outcomes occur
    np.testing.assert_array_equal(occ, np.asarray(o_j))


def test_culled_scan_equals_unculled(veach):
    """Walking only the admitted tiles changes no result: the culled
    plain scans equal scans over every tile of every block."""
    _, ts = veach
    f = torch.from_numpy(camera_feats(8, VEACH_CAM, coherent=True))
    s = torch.from_numpy(shadow_feats(ts, 9))
    g16 = ts.tri_feats16
    nt = ts.tile_aabbs.shape[0]
    nb = -(-B // FI.BT_MULTI)
    every = (torch.arange(nt, dtype=torch.int32) + (3 << 20)).expand(nb, nt).contiguous()
    counts_all = torch.full((nb,), nt, dtype=torch.int32)
    lists, counts = lists_for(ts, (False, True), f, s)
    assert int(((lists & (1 << 20)) != 0).sum()) < nb * nt  # the camera rays' lists cull
    for a, b in zip(
        FI.nearest_shadow_multi(f, s, g16, lists, counts),
        FI.nearest_shadow_multi(f, s, g16, every, counts_all),
    ):
        assert torch.equal(a, b)
    lists, counts = lists_for(ts, (False,), f)
    for a, b in zip(
        FI.nearest_multi(f, g16, lists, counts), FI.nearest_multi(f, g16, every, counts_all)
    ):
        assert torch.equal(a, b)
    lists, counts = lists_for(ts, (True,), s)
    assert torch.equal(
        FI.occlude_multi(s, g16, lists, counts), FI.occlude_multi(s, g16, every, counts_all)
    )


def test_plain_chunks_agree_with_one_pass(veach, monkeypatch):
    _, ts = veach
    f = torch.from_numpy(camera_feats(11, VEACH_CAM))
    lists, counts = lists_for(ts, (False,), f)
    whole = FI.nearest_multi(f, ts.tri_feats16, lists, counts)
    monkeypatch.setattr(FI, "_PLAIN_CHUNK_BYTES", 16 * 512 * 97)  # 97-ray chunks
    chunked = FI.nearest_multi(f, ts.tri_feats16, lists, counts)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_multi_tile_wrappers_check_the_lists(veach):
    _, ts = veach
    f = torch.zeros((16, 300), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        FI.nearest_multi(f, ts.tri_feats16.to("meta"), None, None)
    assert FI.geometry(ts.tri_feats16) == (3072, 512, 6)
    with pytest.raises(ValueError, match="whole tiles"):
        FI.geometry(torch.zeros((16, 4 * 700)))
