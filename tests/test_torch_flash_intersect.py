"""The port's single-tile flash scans (plain versions on the CPU) against
the JAX Pallas kernels in interpret mode under the "f32" plan.

Tolerances: winner index and occlusion are compared exactly; t to
rtol 1e-6 (the two sides may sum the 10-term numerator dots in another
order, with or without FMA); the winner's attr row exactly (the same
f32 row of the same table)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rustic_tpu.ops.flash_intersect import (
    flash_nearest_attrs_t,
    flash_nearest_shadow_attrs_t,
    flash_occlude_packed_t,
)
from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.runtime.pipeline import initk
from rustic_tpu_torch.scene.world import scene_from_arrays

torch.set_num_threads(2)

B = 1000  # ragged: not a multiple of the kernels' 1024-ray block


def scene_fields(scene) -> dict:
    """A JAX SceneArrays as the numpy fields scene_from_arrays takes."""
    out = {
        k: np.asarray(getattr(scene, k))
        for k in ("tri_feats16", "tri_attrs", "entry_rows", "tile_aabbs")
    }
    for k in ("n_tris", "n_alias_entries", "has_lights", "has_glass", "has_textures"):
        out[k] = getattr(scene, k)
    return out


def feats_rows(ro: np.ndarray, rd: np.ndarray, maxt=None) -> np.ndarray:
    """[B, 3] rays -> [16, B] feature rows (maxt in row SH_MAXT_COL)."""
    f = np.zeros((16, len(ro)), np.float32)
    f[0:3] = rd.T
    f[3:6] = np.cross(ro, rd).T
    f[6:9] = ro.T
    f[9] = 1.0
    if maxt is not None:
        f[FI.SH_MAXT_COL] = maxt
    return f


@pytest.fixture(scope="module")
def scenes(cornell_scene):
    return cornell_scene, scene_from_arrays(scene_fields(cornell_scene), "cpu")


def camera_feats(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    config = TracingConfig(nee=NextEventEstimation.MIS)
    px = torch.from_numpy(rng.integers(0, config.width, B).astype(np.int32))
    py = torch.from_numpy(rng.integers(0, config.height, B).astype(np.int32))
    off = torch.from_numpy(rng.integers(0, 2**32, B, dtype=np.uint32).view(np.int32))
    _st, feats_t, _sidx, _params = initk(
        config.static_part(), config.dynamic_part("cpu"), px, py, 0, off, 1
    )
    return feats_t.numpy()


def random_feats(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ro = rng.normal(0, 0.8, (B, 3)).astype(np.float32)
    rd = rng.normal(0, 1, (B, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return feats_rows(ro, rd)


def shadow_feats(entry_rows: np.ndarray, n_alias: int, seed: int) -> np.ndarray:
    """Shadow rays from random points in the box toward random points of
    the light triangles, maxt = distance - 2 EPS."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform([-1, 0, -1], [1, 2, 1], (B, 3)).astype(np.float32)
    e = entry_rows[rng.integers(0, n_alias, B)]
    a, b, c = e[:, 8:11], e[:, 11:14], e[:, 14:17]
    r1 = np.sqrt(rng.uniform(0, 1, (B, 1)))
    r2 = rng.uniform(0, 1, (B, 1))
    target = ((1 - r1) * a + r1 * (1 - r2) * b + r1 * r2 * c).astype(np.float32)
    d = target - ro
    dist = np.linalg.norm(d, axis=1)
    rd = (d / dist[:, None]).astype(np.float32)
    return feats_rows(ro, rd, (dist - 2e-3).astype(np.float32))


def assert_nearest_equal(t_j, i_j, a_j, t_p, i_p, a_p):
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=1e-6)
    np.testing.assert_array_equal(a_p.numpy(), np.asarray(a_j))


@pytest.mark.parametrize("rays", ["camera", "random"])
def test_nearest_attrs_matches_jax(scenes, rays):
    js, ts = scenes
    feats = camera_feats(1) if rays == "camera" else random_feats(2)
    t_j, i_j, a_j, _, _, _ = flash_nearest_attrs_t(
        jnp.asarray(feats), js.tri_feats16, js.tile_aabbs, js.tri_attrs_split,
        interpret=True, precision="f32",
    )
    t_p, i_p, a_p = FI.nearest_attrs(torch.from_numpy(feats), ts.tri_feats16, ts.tri_attrs)
    assert a_p.shape == (32, B)
    assert 0.3 < float((t_p < FI.BIG).float().mean()) <= 1.0  # rays do hit
    assert_nearest_equal(t_j, i_j, a_j, t_p, i_p, a_p)


def test_nearest_shadow_attrs_matches_jax(scenes):
    js, ts = scenes
    feats = camera_feats(3)
    sh = shadow_feats(ts.entry_rows.numpy(), ts.n_alias_entries, 4)
    t_j, i_j, o_j, a_j, _, _, _ = flash_nearest_shadow_attrs_t(
        jnp.asarray(feats), jnp.asarray(sh), js.tri_feats16, js.tile_aabbs,
        js.tri_attrs_split, interpret=True, precision="f32",
    )
    t_p, i_p, o_p, a_p = FI.nearest_shadow_attrs(
        torch.from_numpy(feats), torch.from_numpy(sh), ts.tri_feats16, ts.tri_attrs
    )
    assert_nearest_equal(t_j, i_j, a_j, t_p, i_p, a_p)
    assert o_p.dtype == torch.int32
    np.testing.assert_array_equal(o_p.numpy(), np.asarray(o_j))


@pytest.mark.parametrize("seed", [5, 6])
def test_occlude_matches_jax(scenes, seed):
    js, ts = scenes
    sh = shadow_feats(ts.entry_rows.numpy(), ts.n_alias_entries, seed)
    o_j = flash_occlude_packed_t(
        jnp.asarray(sh), js.tri_feats16, js.tile_aabbs, interpret=True, precision="f32"
    )
    o_p = FI.occlude(torch.from_numpy(sh), ts.tri_feats16)
    occ = o_p.numpy()
    assert 0.02 < occ.mean() < 0.98  # both outcomes occur
    np.testing.assert_array_equal(occ, np.asarray(o_j))


def test_plain_chunks_agree_with_one_pass(scenes, monkeypatch):
    """Chunking the rays does not change any result."""
    _, ts = scenes
    feats = torch.from_numpy(camera_feats(7))
    whole = FI.nearest_attrs(feats, ts.tri_feats16, ts.tri_attrs)
    monkeypatch.setattr(FI, "_PLAIN_CHUNK_BYTES", 16 * 256 * 97)  # 97-ray chunks
    chunked = FI.nearest_attrs(feats, ts.tri_feats16, ts.tri_attrs)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_multi_tile_table_is_refused():
    g16 = torch.zeros((16, 4 * 1024))
    with pytest.raises(NotImplementedError, match="multi-tile"):
        FI.occlude(torch.zeros((16, 8)), g16)


def test_wrappers_need_cuda_or_cpu_tensors():
    with pytest.raises(ValueError, match="no kernel"):
        FI.occlude(torch.zeros((16, 8), device="meta"), torch.zeros((16, 1024), device="meta"))
