"""The port's resident-form multi-tile scans (K14-K16: plain versions on
the CPU) against the JAX package's resident-G kernels
(`_nearest_resident`, `_nearest_shadow_resident`, `_occlude_resident`:
`_flash_nearest` and its twins with `resident=True`) in Pallas interpret
mode under the "f32" plan at bt=256, on FurnaceTest (20 tiles) with 700
rays, the inputs of tests/test_flash_precision.py's resident test; and
`use_resident`, which says whether a table fits a thread-block cluster's
shared memory.

Tolerances: winner indices and occlusion exactly; t to rtol 1e-5 (the two
sides may sum the 10-term numerator dots in another order); equal to the
grid form's plain versions bit for bit (per-ray or per-block culling
cannot change a winner)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rustic_tpu.ops import flash_intersect as JFI
from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.runtime.render import render_image
from rustic_tpu_torch.scene.world import scene_from_arrays
from tests.test_torch_flash_multi import feats_rows, scene_fields
from tests.test_torch_flash_single import spy_pallas_kernels
from tests.test_torch_render_multitile import count_calls

torch.set_num_threads(2)

N = 700  # not a block multiple
RESIDENT = dict(bt=256, interpret=True, precision="f32", resident=True)
H100_BUDGET = (232448, 8)  # shared-memory bytes a block may opt in to, portable cluster size


@pytest.fixture(scope="module")
def furnace(furnace_scene):
    return furnace_scene, scene_from_arrays(scene_fields(furnace_scene), "cpu")


def ray_rows():
    """(nearest rows, shadow rows) [16, N]: origins around the furnace's
    centre, random directions; the shadow set reaches 2.0 far."""
    rng = np.random.default_rng(31)
    ro = rng.normal(0, 0.5, (N, 3)).astype(np.float32)
    rd = rng.normal(0, 1, (N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rng = np.random.default_rng(32)
    sro = rng.normal(0, 0.8, (N, 3)).astype(np.float32)
    srd = rng.normal(0, 1, (N, 3)).astype(np.float32)
    srd /= np.linalg.norm(srd, axis=1, keepdims=True)
    return feats_rows(ro, rd), feats_rows(sro, srd, np.full(N, 2.0, np.float32))


def spied(monkeypatch, name):
    return spy_pallas_kernels(monkeypatch, name)[name]


def test_nearest_resident_matches_jax(furnace, monkeypatch):
    js, ts = furnace
    feats, _ = ray_rows()
    calls = spied(monkeypatch, "_nearest_resident")
    t_j, i_j, t2, _ = JFI._flash_nearest(jnp.asarray(feats.T), js.tri_feats16, js.tile_aabbs,
                                         **RESIDENT)
    assert calls == [1] and t2 is None
    f = torch.from_numpy(feats)
    t_p, i_p = FI.nearest_resident(f, ts.tri_feats16, ts.tile_aabbs)
    assert t_p.dtype == torch.float32 and i_p.dtype == torch.int32
    assert 0.3 < float((t_p < FI.BIG).float().mean()) <= 1.0 and int(i_p.max()) >= 512
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=1e-5)
    for a, b in zip((t_p, i_p), FI.nearest_grid_plain(f, ts.tri_feats16, ts.tile_aabbs)):
        assert torch.equal(a, b)
    for a, b in zip((t_p, i_p), FI.nearest_resident_plain(f, ts.tri_feats16, ts.tile_aabbs)):
        assert torch.equal(a, b)


def test_nearest_shadow_resident_matches_jax(furnace, monkeypatch):
    js, ts = furnace
    feats, sh = ray_rows()
    calls = spied(monkeypatch, "_nearest_shadow_resident")
    t_j, i_j, o_j, _, _ = JFI._flash_nearest_shadow(
        jnp.asarray(feats.T), jnp.asarray(sh.T), js.tri_feats16, js.tile_aabbs, **RESIDENT)
    assert calls == [1]
    f, s = torch.from_numpy(feats), torch.from_numpy(sh)
    t_p, i_p, o_p = FI.nearest_shadow_resident(f, s, ts.tri_feats16, ts.tile_aabbs)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), rtol=1e-5)
    assert o_p.dtype == torch.int32
    np.testing.assert_array_equal(o_p.numpy() != 0, np.asarray(o_j))
    for plain in (FI.nearest_shadow_grid_plain, FI.nearest_shadow_resident_plain):
        for a, b in zip((t_p, i_p, o_p), plain(f, s, ts.tri_feats16, ts.tile_aabbs)):
            assert torch.equal(a, b)


def test_occlude_resident_matches_jax(furnace, monkeypatch):
    js, ts = furnace
    _, sh = ray_rows()
    calls = spied(monkeypatch, "_occlude_resident")
    o_j = JFI._flash_occlude_packed(jnp.asarray(sh.T), js.tri_feats16, js.tile_aabbs, **RESIDENT)
    assert calls == [1]
    s = torch.from_numpy(sh)
    occ = FI.occlude_resident(s, ts.tri_feats16, ts.tile_aabbs)
    assert 0.02 < float(occ.float().mean()) < 0.98  # both outcomes occur
    np.testing.assert_array_equal(occ.numpy(), np.asarray(o_j))
    assert torch.equal(occ, FI.occlude_grid_plain(s, ts.tri_feats16, ts.tile_aabbs))
    assert torch.equal(occ, FI.occlude_resident_plain(s, ts.tri_feats16, ts.tile_aabbs))


def table(t_pad: int) -> torch.Tensor:
    return torch.zeros((16, 4 * t_pad))


@pytest.mark.parametrize("scene, t_pad, want", [
    ("one tile", 512, None),
    ("DarkCornell", 256, None),
    ("VeachMIS", 3072, (3, 8)),
    ("GlassTest", 4096, (3, 11)),
    ("FurnaceTest", 10240, (8, 10)),
    ("BreakTime", 10752, (8, 11)),
    ("PBRTest", 24064, None),  # over the budget of a cluster of 8
])
def test_use_resident_gates(monkeypatch, scene, t_pad, want):
    """On a 227 KB / cluster-of-8 budget: the smallest cluster whose ranks
    hold the table in 20 KB chunks of 128 triangles, or None."""
    monkeypatch.setattr(FI, "resident_budget", lambda device: H100_BUDGET)
    plan = FI.use_resident(table(t_pad))
    assert (None if plan is None else tuple(plan)) == want
    if plan is not None:
        assert plan.cluster * plan.chunks_per_rank >= t_pad // FI.CHUNK
        assert plan.bytes_per_rank <= H100_BUDGET[0] and plan.cluster <= H100_BUDGET[1]
        assert (plan.cluster - 1) * (H100_BUDGET[0] // FI.CHUNK_BYTES) < t_pad // FI.CHUNK


def test_use_resident_follows_the_device_budget(monkeypatch):
    """The gate reads the device's numbers: a smaller card refuses what
    the larger takes; the CPU, whose plain versions stage nothing, takes
    any table of two tiles or more."""
    g = table(3072)
    monkeypatch.setattr(FI, "resident_budget", lambda device: (101376, 8))  # 99 KB a block
    assert tuple(FI.use_resident(g)) == (6, 4)
    monkeypatch.setattr(FI, "resident_budget", lambda device: (49152, 8))
    assert FI.use_resident(g) is None  # 2 chunks a rank: a cluster of 12
    monkeypatch.setattr(FI, "resident_budget", lambda device: (232448, 2))
    assert FI.use_resident(g) is None
    monkeypatch.undo()
    assert FI.resident_budget("cpu") is None
    assert tuple(FI.use_resident(table(24064))) == (1, 188)
    assert FI.use_resident(table(512)) is None


def test_resident_refuses_what_does_not_fit(furnace, monkeypatch):
    _, ts = furnace
    feats, sh = (torch.from_numpy(x) for x in ray_rows())
    with pytest.raises(ValueError, match="2 or more tiles"):
        FI.nearest_resident(feats, table(512), ts.tile_aabbs[:1])
    monkeypatch.setattr(FI, "resident_budget", lambda device: (49152, 8))
    for call in (lambda: FI.nearest_resident(feats, ts.tri_feats16, ts.tile_aabbs),
                 lambda: FI.nearest_shadow_resident(feats, sh, ts.tri_feats16, ts.tile_aabbs),
                 lambda: FI.occlude_resident(sh, ts.tri_feats16, ts.tile_aabbs)):
        with pytest.raises(ValueError, match="fits a thread-block cluster"):
            call()
    config = TracingConfig(width=4, height=4, nee=NextEventEstimation.MIS)
    with pytest.raises(ValueError, match="fits a thread-block cluster"):
        render_image(ts, config, RenderSettings(samples=1, multitile_scan="resident"),
                     device="cpu")
    meta = torch.zeros((16, 300), device="meta")
    monkeypatch.setattr(FI, "resident_budget", lambda device: H100_BUDGET)
    with pytest.raises(ValueError, match="no kernel"):
        FI.nearest_resident(meta, ts.tri_feats16.to("meta"), ts.tile_aabbs.to("meta"))


@pytest.mark.parametrize("loop", ["kernel-shade", "ray-sorted", "unsorted"])
def test_resident_render_equals_grid(furnace, monkeypatch, loop):
    """Each multi-tile loop gives the grid form's film with the resident
    scans, and runs only them: K14 once, K15 on every later bounce, K16
    once, no tile lists."""
    _, ts = furnace
    config = TracingConfig(width=16, height=8, nee=NextEventEstimation.MIS)

    def film(scan):
        return render_image(ts, config, RenderSettings(samples=2, multitile_loop=loop,
                                                       multitile_scan=scan), device="cpu")

    grid = film("grid")
    calls = {}
    count_calls(monkeypatch, FI, ("block_tile_lists", "nearest_multi", "nearest_shadow_multi",
                                  "occlude_multi", "nearest_grid", "nearest_shadow_grid",
                                  "occlude_grid", "nearest_resident", "nearest_shadow_resident",
                                  "occlude_resident", "nearest", "nearest_shadow", "occlude"),
                calls)
    resident = film("resident")
    assert np.isfinite(resident).all() and resident.mean() > 0.05
    np.testing.assert_array_equal(resident, grid)
    nb = config.max_bounces  # one group of 2 folded samples
    assert calls == dict.fromkeys(calls, 0) | {
        "nearest_resident": 1, "nearest_shadow_resident": nb - 1, "occlude_resident": 1}
