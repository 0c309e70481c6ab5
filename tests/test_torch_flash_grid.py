"""The port's grid-form multi-tile scans (K9-K11: plain versions on the
CPU) against the JAX package's grid-form kernels (`_nearest_multi`,
`_nearest_shadow_multi`, `_occlude_multi`: the non-DMA branch of
`_flash_nearest` and its twins) in Pallas interpret mode under the "f32"
plan, on VeachMIS (6 tiles) and BreakTime (21 tiles), and against the
port's list form (K5-K7 plain) on the same rays.

Tolerances, as tests/test_torch_flash_multi.py: winner indices and
occlusion exactly; t to rtol 1e-6 (the two sides may sum the 10-term
numerator dots in another order). Grid plain against list plain: equal
(the same pair arithmetic; each form culls only tiles a ray cannot hit
closer than its limit)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rustic_tpu.ops import flash_intersect as JFI
from rustic_tpu.scene.gltf import load_glb as jax_load_glb
from rustic_tpu.scene.world import World, load_skybox_image
from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.runtime import pipeline as P
from rustic_tpu_torch.scene.world import scene_from_arrays
from tests.conftest import scene_path
from tests.test_torch_flash_multi import B, VEACH_CAM, feats_rows, random_feats, shadow_feats

torch.set_num_threads(2)

BREAKTIME_CAM = dict(cam_position=(0.0, 1.8, -3.2))
CAMS = {"veach": VEACH_CAM, "breaktime": BREAKTIME_CAM}
GRID = dict(bt=FI.BT_MULTI, interpret=True, precision="f32", dma=False)


def scene_fields(scene) -> dict:
    out = {
        k: np.asarray(getattr(scene, k))
        for k in ("tri_feats16", "tri_attrs", "entry_rows", "tile_aabbs", "atlas", "skybox")
    }
    for k in ("n_tris", "n_alias_entries", "has_lights", "has_glass", "has_textures"):
        out[k] = getattr(scene, k)
    return out


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX scene, port scene on the CPU), built on first use;
    BreakTime with a 256-texel atlas and its HDR sky."""
    cache = {}

    def get(name):
        if name not in cache:
            if name == "veach":
                js = World.from_path(scene_path("VeachMIS.glb")).to_device()
            else:
                js = World(jax_load_glb(scene_path("BreakTime.glb")), 256).to_device(
                    load_skybox_image(scene_path("BreakTimeSky.npy")))
            cache[name] = (js, scene_from_arrays(scene_fields(js), "cpu"))
        return cache[name]

    return get


def camera_feats(name, seed: int, coherent: bool = False) -> np.ndarray:
    """Camera rays of random pixels, or of B consecutive pixels."""
    rng = np.random.default_rng(seed)
    config = TracingConfig(width=1024, height=1024, nee=NextEventEstimation.MIS, **CAMS[name])
    if coherent:
        ids = 400 * config.width + np.arange(B)
        px, py = ids % config.width, ids // config.width
    else:
        px, py = rng.integers(0, config.width, B), rng.integers(0, config.height, B)
    off = torch.from_numpy(rng.integers(0, 2**32, B, dtype=np.uint32).view(np.int32))
    _st, feats, _sidx = P.stage_init(
        config.static_part(), config.dynamic_part("cpu"),
        torch.from_numpy(px.astype(np.int32)), torch.from_numpy(py.astype(np.int32)), 0, off, 1,
    )
    return feats.numpy()


def rays(ts, name, kind, seed):
    if kind == "camera":
        return camera_feats(name, seed)
    if kind == "coherent":
        return camera_feats(name, seed, coherent=True)
    if kind == "random":
        return random_feats(seed, ts.tile_aabbs.numpy())
    return shadow_feats(ts, seed)


def lists_for(ts, flags, *feats):
    return FI.block_tile_lists(ts.tile_aabbs, FI.BT_MULTI, flags, *feats)


def assert_nearest_equal(t_j, i_j, t_p, i_p):
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=1e-6)


@pytest.mark.parametrize("name", ["veach", "breaktime"])
@pytest.mark.parametrize("kind", ["camera", "random"])
def test_nearest_grid_matches_jax(scenes, name, kind):
    js, ts = scenes(name)
    feats = rays(ts, name, kind, 1)
    t_j, i_j, t2, _ = JFI._flash_nearest(
        jnp.asarray(feats.T), js.tri_feats16, js.tile_aabbs, **GRID
    )
    assert t2 is None
    f = torch.from_numpy(feats)
    t_p, i_p = FI.nearest_grid(f, ts.tri_feats16, ts.tile_aabbs)
    assert t_p.dtype == torch.float32 and i_p.dtype == torch.int32
    assert 0.3 < float((t_p < FI.BIG).float().mean()) <= 1.0  # rays do hit
    if kind == "camera":
        assert int(i_p.max()) >= 512  # winners beyond the first tile
    assert_nearest_equal(t_j, i_j, t_p, i_p)


@pytest.mark.parametrize("name", ["veach", "breaktime"])
def test_nearest_shadow_grid_matches_jax(scenes, name):
    js, ts = scenes(name)
    feats, sh = camera_feats(name, 3), shadow_feats(ts, 4)
    t_j, i_j, o_j, _, _ = JFI._flash_nearest_shadow(
        jnp.asarray(feats.T), jnp.asarray(sh.T), js.tri_feats16, js.tile_aabbs, **GRID
    )
    f, s = torch.from_numpy(feats), torch.from_numpy(sh)
    t_p, i_p, o_p = FI.nearest_shadow_grid(f, s, ts.tri_feats16, ts.tile_aabbs)
    assert_nearest_equal(t_j, i_j, t_p, i_p)
    assert o_p.dtype == torch.int32
    np.testing.assert_array_equal(o_p.numpy() != 0, np.asarray(o_j))


@pytest.mark.parametrize("name, seed", [("veach", 5), ("breaktime", 6), ("breaktime", 7)])
def test_occlude_grid_matches_jax(scenes, name, seed):
    js, ts = scenes(name)
    sh = shadow_feats(ts, seed)
    o_j = JFI._flash_occlude_packed(jnp.asarray(sh.T), js.tri_feats16, js.tile_aabbs, **GRID)
    occ = FI.occlude_grid(torch.from_numpy(sh), ts.tri_feats16, ts.tile_aabbs).numpy()
    assert 0.02 < occ.mean() < 0.98  # both outcomes occur
    np.testing.assert_array_equal(occ, np.asarray(o_j))


@pytest.mark.parametrize("name", ["veach", "breaktime"])
@pytest.mark.parametrize("kind", ["coherent", "random"])
def test_grid_equals_lists(scenes, name, kind):
    """The grid form gives what the list form gives on the same rays."""
    _, ts = scenes(name)
    g16, aabbs = ts.tri_feats16, ts.tile_aabbs
    f = torch.from_numpy(rays(ts, name, kind, 8))
    s = torch.from_numpy(shadow_feats(ts, 9))
    for a, b in zip(FI.nearest_grid(f, g16, aabbs),
                    FI.nearest_multi(f, g16, *lists_for(ts, (False,), f))):
        assert torch.equal(a, b)
    for a, b in zip(FI.nearest_shadow_grid(f, s, g16, aabbs),
                    FI.nearest_shadow_multi(f, s, g16, *lists_for(ts, (False, True), f, s))):
        assert torch.equal(a, b)
    assert torch.equal(FI.occlude_grid(s, g16, aabbs),
                       FI.occlude_multi(s, g16, *lists_for(ts, (True,), s)))


def visited(f, s, ts):
    """Tiles per block the plain grid scan visits."""
    return FI._grid_scan(f, s, ts.tri_feats16, ts.tile_aabbs)[3]


def test_grid_visits(scenes):
    """Visited tiles per block: the wrappers' `visits` equal the plain
    scan's count, for CPU tensors its own; coherent camera blocks visit fewer tiles than
    their lists admit (the running best t culls); sentinel blocks visit
    none; B is not padded with rays."""
    _, ts = scenes("breaktime")
    g16, aabbs = ts.tri_feats16, ts.tile_aabbs
    nt = aabbs.shape[0]
    nb = -(-B // FI.BT_MULTI)
    f = torch.from_numpy(camera_feats("breaktime", 12, coherent=True))
    s = torch.from_numpy(shadow_feats(ts, 13))
    visits = torch.zeros(nb, dtype=torch.int32)
    t, idx = FI.nearest_grid(f, g16, aabbs, visits=visits)
    want = visited(f, None, ts)
    assert torch.equal(visits, want) and visits.dtype == torch.int32
    lists, counts = lists_for(ts, (False,), f)
    assert bool((visits <= counts).all()) and int(visits.sum()) < int(counts.sum())
    FI.nearest_shadow_grid(f, s, g16, aabbs, visits=visits)
    assert torch.equal(visits, visited(f, s, ts))
    assert bool((visits <= nt).all())
    FI.occlude_grid(s, g16, aabbs, visits=visits)
    assert torch.equal(visits, visited(None, s, ts))

    # sentinel rays (retired lanes) visit nothing and hit nothing
    dead = torch.ones(B, dtype=torch.bool)
    sent = P.sentinel_feats(f, dead)
    assert int(visited(sent, P.sentinel_feats(s, dead), ts).sum()) == 0
    t, idx, occ = FI.nearest_shadow_grid(sent, P.sentinel_feats(s, dead), g16, aabbs)
    assert bool((t == FI.BIG).all() and (idx == 0).all() and (occ == 0).all())


def test_grid_plain_chunks_agree_with_one_pass(scenes, monkeypatch):
    _, ts = scenes("breaktime")
    f = torch.from_numpy(camera_feats("breaktime", 11))
    s = torch.from_numpy(shadow_feats(ts, 14))
    whole = FI._grid_scan(f, s, ts.tri_feats16, ts.tile_aabbs)
    monkeypatch.setattr(FI, "_PLAIN_CHUNK_BYTES", 16 * 512 * 97)  # 97-ray chunks
    chunked = FI._grid_scan(f, s, ts.tri_feats16, ts.tile_aabbs)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_grid_wrappers_check_their_operands(scenes):
    _, ts = scenes("veach")
    f = torch.zeros((16, 300), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        FI.nearest_grid(f, ts.tri_feats16.to("meta"), ts.tile_aabbs.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        FI.occlude_grid(f, ts.tri_feats16.to("meta"), ts.tile_aabbs.to("meta"))


def test_ray_rows_helper_layout():
    """feats_rows (shared with test_torch_flash_multi) puts maxt in row 10."""
    ro = np.zeros((2, 3), np.float32)
    rd = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
    f = feats_rows(ro, rd, np.array([2.0, 3.0], np.float32))
    assert f.shape == (16, 2) and f[FI.SH_MAXT_COL].tolist() == [2.0, 3.0] and f[9].tolist() == [1, 1]
