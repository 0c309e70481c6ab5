"""The port's single-tile scans without the attr row (K12, K13: plain
versions on the CPU) against the JAX Pallas kernels `_nearest_single` and
`_nearest_shadow_single` (reached through `_flash_nearest` and
`_flash_nearest_shadow` on a one-tile scene) in interpret mode under the
"f32" plan, and against the port's K1/K2 plain versions.

Scenes of one tile: DarkCornell, and the one-tile cuts of BreakTime
(textured, 64-wide rows) and VeachMIS (460 alias entries) of
rustic_tpu_torch/scene/cuts.py, each built by the JAX `World` and handed
to the port through scene_from_arrays.

Tolerances: winner index and occlusion exactly; t to rtol 1e-6 against
JAX (the two sides may sum the 10-term numerator dots in another order);
(t, idx, occ) equal to K1/K2's plain versions bit for bit (the same
code)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rustic_tpu.ops import flash_intersect as JFI
from rustic_tpu.scene.gltf import load_glb as jax_load_glb
from rustic_tpu.scene.world import World as JaxWorld
from rustic_tpu.scene.world import load_skybox_image as jax_sky
from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.runtime.pipeline import stage_init
from rustic_tpu_torch.scene import cuts
from rustic_tpu_torch.scene.world import scene_from_arrays
from tests.conftest import scene_path
from tests.test_torch_flash_grid import scene_fields
from tests.test_torch_flash_intersect import feats_rows, shadow_feats

torch.set_num_threads(2)

B = 1000  # ragged: not a multiple of any block size
ONE_TILE = {
    "cornell": dict(glb="DarkCornell.glb", cut=None, cam={}),
    "veach1": dict(glb="VeachMIS.glb", cut=cuts.VEACH_ONE_TILE,
                   cam=dict(cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05))),
    "breaktime1": dict(glb="BreakTime.glb", cut=cuts.BREAKTIME_ONE_TILE,
                       cam=dict(cam_position=(0.0, 1.8, -3.2), has_skybox=True)),
}
F32 = dict(bt=JFI.DEF_BT, interpret=True, precision="f32")


def jax_one_tile(name):
    """The JAX scene of ONE_TILE[name]: the cut glTF through the JAX World
    (256-texel atlas; BreakTime under its HDR sky)."""
    spec = ONE_TILE[name]
    gltf = jax_load_glb(scene_path(spec["glb"]))
    if spec["cut"] is not None:
        gltf = cuts.one_tile(gltf, spec["cut"])
    sky = jax_sky(scene_path("BreakTimeSky.npy")) if spec["cam"].get("has_skybox") else None
    return JaxWorld(gltf, 256).to_device(sky)


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX scene, port scene on the CPU), built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            js = jax_one_tile(name)
            cache[name] = (js, scene_from_arrays(scene_fields(js), "cpu"))
        return cache[name]

    return get


def camera_feats(name, seed: int, n: int = B) -> np.ndarray:
    rng = np.random.default_rng(seed)
    config = TracingConfig(nee=NextEventEstimation.MIS, **ONE_TILE[name]["cam"])
    px = torch.from_numpy(rng.integers(0, config.width, n).astype(np.int32))
    py = torch.from_numpy(rng.integers(0, config.height, n).astype(np.int32))
    off = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32).view(np.int32))
    _st, feats, _sidx = stage_init(config.static_part(), config.dynamic_part("cpu"), px, py, 0,
                                   off, 1)
    return feats.numpy()


def random_feats(ts, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    aabb = ts.tile_aabbs.numpy()[0]
    ro = rng.uniform(aabb[0:3], aabb[4:7], (B, 3)).astype(np.float32)
    rd = rng.normal(0, 1, (B, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return feats_rows(ro, rd)


def shadows(ts, name, seed: int, n: int = B) -> np.ndarray:
    """Shadow rays from the first hits of camera rays toward random points
    of the light triangles, maxt = distance - 2 EPS."""
    if name == "cornell":
        return shadow_feats(ts.entry_rows.numpy(), ts.n_alias_entries, seed)[:, :n]
    rng = np.random.default_rng(seed)
    cam = camera_feats(name, seed + 100, n)
    t = FI.nearest_plain(torch.from_numpy(cam), ts.tri_feats16)[0].numpy()
    ro = (cam[6:9] + cam[0:3] * np.where(t < FI.BIG, t, 1.0) * 0.999).T.astype(np.float32)
    e = ts.entry_rows.numpy()[rng.integers(0, ts.n_alias_entries, n)]
    w = rng.dirichlet(np.ones(3), n).astype(np.float32)
    target = w[:, 0:1] * e[:, 8:11] + w[:, 1:2] * e[:, 11:14] + w[:, 2:3] * e[:, 14:17]
    d = target - ro
    dist = np.linalg.norm(d, axis=1)
    return feats_rows(ro, (d / dist[:, None]).astype(np.float32), (dist - 2e-3).astype(np.float32))


def spy_pallas_kernels(monkeypatch, *names):
    """Count the calls of the JAX kernel functions `names`; the jit caches
    are dropped so that the next call traces and reaches them."""
    from tests.test_torch_sorted import spy

    calls = {name: spy(monkeypatch, JFI, name) for name in names}
    jax.clear_caches()
    return calls


@pytest.mark.parametrize("name", sorted(ONE_TILE))
def test_scenes_are_one_tile(scenes, name):
    js, ts = scenes(name)
    assert FI.geometry(ts.tri_feats16)[2] == 1 and ts.n_tris <= 512
    assert ts.has_lights
    if name == "veach1":
        assert ts.n_alias_entries > 16 and not ts.has_textures
    if name == "breaktime1":
        assert ts.has_textures and ts.tri_attrs.shape[1] == 64
        hastex = ts.tri_attrs[: ts.n_tris, 52:56].numpy()
        assert hastex.any(axis=0).all()  # albedo, metallic, roughness and normal maps


@pytest.mark.parametrize("name", sorted(ONE_TILE))
@pytest.mark.parametrize("kind", ["camera", "random"])
def test_nearest_matches_jax(scenes, name, kind):
    js, ts = scenes(name)
    feats = camera_feats(name, 1) if kind == "camera" else random_feats(ts, 2)
    t_j, i_j, t2, _ = JFI._flash_nearest(jnp.asarray(feats.T), js.tri_feats16, js.tile_aabbs,
                                         **F32)
    assert t2 is None
    t_p, i_p = FI.nearest(torch.from_numpy(feats), ts.tri_feats16)
    assert t_p.dtype == torch.float32 and i_p.dtype == torch.int32
    assert 0.2 < float((t_p < FI.BIG).float().mean()) <= 1.0  # rays do hit
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=1e-6)


@pytest.mark.parametrize("name", sorted(ONE_TILE))
def test_nearest_shadow_matches_jax(scenes, name):
    js, ts = scenes(name)
    feats, sh = camera_feats(name, 3), shadows(ts, name, 4)
    t_j, i_j, o_j, _, _ = JFI._flash_nearest_shadow(
        jnp.asarray(feats.T), jnp.asarray(sh.T), js.tri_feats16, js.tile_aabbs, **F32)
    t_p, i_p, o_p = FI.nearest_shadow(torch.from_numpy(feats), torch.from_numpy(sh),
                                      ts.tri_feats16)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=1e-6)
    assert o_p.dtype == torch.int32 and 0.01 < float(o_p.float().mean()) < 0.99
    np.testing.assert_array_equal(o_p.numpy() != 0, np.asarray(o_j))


def test_jax_side_runs_the_single_tile_kernels(scenes, monkeypatch):
    """On a one-tile scene `_flash_nearest` builds `_nearest_single` and
    `_flash_nearest_shadow` builds `_nearest_shadow_single`: the kernels
    K12 and K13 replace."""
    js, ts = scenes("veach1")
    n = 333
    feats, sh = camera_feats("veach1", 5, n), shadows(ts, "veach1", 6, n)
    calls = spy_pallas_kernels(monkeypatch, "_nearest_single", "_nearest_shadow_single",
                                "_nearest_single_attrs", "_nearest_multi")
    t_j, i_j, _, _ = JFI._flash_nearest(jnp.asarray(feats.T), js.tri_feats16, js.tile_aabbs,
                                        **F32)
    assert calls["_nearest_single"] == [1] and not calls["_nearest_shadow_single"]
    t_s, i_s, o_s, _, _ = JFI._flash_nearest_shadow(
        jnp.asarray(feats.T), jnp.asarray(sh.T), js.tri_feats16, js.tile_aabbs, **F32)
    assert calls["_nearest_shadow_single"] == [1]
    assert not calls["_nearest_single_attrs"] and not calls["_nearest_multi"]
    t_p, i_p, o_p = FI.nearest_shadow(torch.from_numpy(feats), torch.from_numpy(sh),
                                      ts.tri_feats16)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_s))
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(o_p.numpy() != 0, np.asarray(o_s))


@pytest.mark.parametrize("name", sorted(ONE_TILE))
def test_equal_to_the_attr_scans(scenes, name):
    """K12/K13's plain versions return K1/K2's (t, idx, occ) bit for bit,
    and the row K1 copies is the row `gather_attr_rows` gathers."""
    from rustic_tpu_torch.ops.intersect import gather_attr_rows

    _, ts = scenes(name)
    f, s = torch.from_numpy(camera_feats(name, 7)), torch.from_numpy(shadows(ts, name, 8))
    g16, attrs = ts.tri_feats16, ts.tri_attrs
    t1, i1, a1 = FI.nearest_attrs_plain(f, g16, attrs)
    t2, i2, o2, _ = FI.nearest_shadow_attrs_plain(f, s, g16, attrs)
    t12, i12 = FI.nearest_plain(f, g16)
    t13, i13, o13 = FI.nearest_shadow_plain(f, s, g16)
    for a, b in ((t1, t12), (i1, i12), (t2, t13), (i2, i13), (o2, o13)):
        assert torch.equal(a, b)
    assert a1.shape[0] == attrs.shape[1]  # 32 slim, 64 textured
    assert torch.equal(gather_attr_rows(ts, i12).T, a1)


def test_plain_chunks_agree_with_one_pass(scenes, monkeypatch):
    _, ts = scenes("veach1")
    f, s = torch.from_numpy(camera_feats("veach1", 9)), torch.from_numpy(shadows(ts, "veach1", 10))
    whole = FI.nearest_shadow(f, s, ts.tri_feats16)
    monkeypatch.setattr(FI, "_PLAIN_CHUNK_BYTES", 16 * 512 * 97)  # 97-ray chunks
    for a, b in zip(whole, FI.nearest_shadow(f, s, ts.tri_feats16)):
        assert torch.equal(a, b)


def test_wrappers_check_their_operands():
    g_multi = torch.zeros((16, 4 * 1024))
    with pytest.raises(NotImplementedError, match="multi-tile"):
        FI.nearest(torch.zeros((16, 8)), g_multi)
    with pytest.raises(NotImplementedError, match="multi-tile"):
        FI.nearest_shadow(torch.zeros((16, 8)), torch.zeros((16, 8)), g_multi)
    meta = torch.zeros((16, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        FI.nearest(meta, torch.zeros((16, 1024), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        FI.nearest_shadow(meta, meta, torch.zeros((16, 1024), device="meta"))
    assert FI.nearest(torch.zeros((16, 0)), torch.zeros((16, 1024)))[0].shape == (0,)


def test_one_tile_cut_keeps_input_order():
    """`cuts.one_tile` keeps whole materials and the nearest triangles of
    the partial ones, in the input's order, for either package's scene."""
    from rustic_tpu_torch.scene.gltf import load_glb

    for loader in (load_glb, jax_load_glb):
        full = loader(scene_path("VeachMIS.glb"))
        cut = cuts.one_tile(full, cuts.VEACH_ONE_TILE)
        assert len(cut.triangles) == 52 + 460
        mats = cut.triangles[:, 3]
        assert (np.bincount(mats, minlength=6) == [12, 12, 12, 4, 12, 460]).all()
        assert cut.positions is full.positions and type(cut) is type(full)
    with pytest.raises(ValueError, match="over 512"):
        cuts.one_tile(full, cuts.OneTileCut(whole=(5,), partial={}, toward=(0.0, 0.0, 0.0)))
