"""The fused bounce (K17's plain version) and the fused render loop.

`fused_bounce` must compute what a flash scan followed by the shade
kernel computes. On the CPU its plain version is held bit for bit to the
composition of the plain scans (one tile: K12/K13's; VeachMIS: the
list-form multi-tile scans of `flash_scan`), a row gather and
`shade_bounce_plain`, on every bounce of a traced group, folded and with
the occlusion handed back (`hold_occ`). The fused loop's film equals the
kernel-shade loop's, and the JAX staged film (Pallas interpret mode,
"f32" plan) to rtol 1e-4, atol 1e-5, the gate of
tests/test_torch_render.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.ops import fused_bounce as FB
from rustic_tpu_torch.ops import shade_kernel as SK
from rustic_tpu_torch.runtime import pipeline as P
from rustic_tpu_torch.runtime.render import pixel_offsets, render_image, render_pixels
from rustic_tpu_torch.scene.world import World, load_skybox_image, scene_from_arrays
from tests.conftest import scene_path
from tests.test_torch_render import scene_fields
from tests.test_torch_render_multitile import count_calls

torch.set_num_threads(2)

MIS = NextEventEstimation.MIS
# name -> (width, height, samples, camera): DarkCornell's 512 lanes are the
# smallest batch the JAX kernel-shade path takes; VeachMIS as
# tests/test_torch_render_multitile.py renders it
CASES = {
    "DarkCornell": (32, 16, 3, {}),
    "VeachMIS": (16, 12, 2, dict(cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05))),
}
FOLD = 2


@pytest.fixture(scope="module")
def port_scenes(cornell_scene):
    return {
        "DarkCornell": scene_from_arrays(scene_fields(cornell_scene), "cpu"),
        "VeachMIS": World.from_path(scene_path("VeachMIS.glb")).to_torch("cpu"),
    }


def config_of(name, **kw):
    w, h, _, cam = CASES[name]
    return TracingConfig(width=w, height=h, nee=MIS, **cam, **kw)


def scan_then_gather(scene, feats, pending):
    """The scans the other loops run in the list form, in their plain
    versions, and the winners' rows -> (t, idx, occ i32 or None, rows
    [32, B]). The list form's any-hit set culls per block, as K17's plain
    scan (which culls nothing) gives on every lane; the grid form's per-ray
    cull may differ on dead lanes (ROADMAP queue 3, "Culling is per ray")."""
    t, idx, occ = P._scan(feats, pending, scene, "lists")
    rows = scene.tri_attrs[idx.long()].T.contiguous()
    return t, idx, None if occ is None else occ.to(torch.int32), rows


_TRACES = {}


def traced(name, scene):
    """One group of FOLD folded samples through every bounce ->
    (cfg, params, sidx, offsets, [(st, feats, pending shadow rows)])."""
    if name not in _TRACES:
        w, h, _, _ = CASES[name]
        config = config_of(name)
        cfg, cam = config.static_part(), config.dynamic_part("cpu")
        y, x = np.mgrid[0:h, 0:w]
        px = torch.from_numpy(x.reshape(-1).astype(np.int32)).repeat(FOLD)
        py = torch.from_numpy(y.reshape(-1).astype(np.int32)).repeat(FOLD)
        off = torch.from_numpy(pixel_offsets(w, h).view(np.int32).copy()).repeat(FOLD)
        st, feats, sidx, params = P.initk(cfg, cam, px, py, 0, off, FOLD)
        kw = dict(has_glass=scene.has_glass, n_alias=scene.n_alias_entries)
        pending, bounces = None, []
        for b in range(cfg.max_bounces):
            bounces.append((st, feats, pending))
            t, idx, occ, rows = scan_then_gather(scene, feats, pending)
            st, nf, pending = SK.shade_bounce_plain(
                cfg, b, params, scene.entry_rows, st, feats, t, idx, rows, occ, sidx, off, **kw)
            if nf is not None:
                feats = nf
        _TRACES[name] = (cfg, params, sidx, off, bounces)
    return _TRACES[name]


def assert_same(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype
            assert torch.equal(torch.nan_to_num(g.float(), nan=7.0), torch.nan_to_num(w.float(), nan=7.0))


@pytest.mark.parametrize("bounce", range(4))
@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_plain_equals_scan_then_shade(port_scenes, name, bounce):
    """Every bounce's operands: the fold mode against scan -> gather ->
    shade with the occlusion folded, the held mode against the same
    without it, the occlusion handed back."""
    scene = port_scenes[name]
    cfg, params, sidx, off, bounces = traced(name, scene)
    st, feats, pending = bounces[bounce]
    assert (pending is None) == (bounce == 0)
    assert FI.geometry(scene.tri_feats16)[2] == (1 if name == "DarkCornell" else 6)
    kw = dict(has_glass=scene.has_glass, n_alias=scene.n_alias_entries)
    args = (cfg, bounce, params, scene.entry_rows, st, feats, pending, scene.tri_feats16,
            scene.tri_attrs, sidx, off)
    t, idx, occ, rows = scan_then_gather(scene, feats, pending)
    shade_args = (cfg, bounce, params, scene.entry_rows, st, feats, t, idx, rows)
    got = FB.fused_bounce(*args, **kw)  # CPU tensors: the plain version
    assert got[3] is None
    assert_same(got[:3], SK.shade_bounce_plain(*shade_args, occ, sidx, off, **kw))
    assert (got[1] is None) == (bounce == cfg.max_bounces - 1) and got[2] is not None
    if pending is None:
        with pytest.raises(ValueError, match="hold_occ needs shadow rays"):
            FB.fused_bounce(*args, **kw, hold_occ=True)
        return
    held = FB.fused_bounce(*args, **kw, hold_occ=True)
    assert held[3].dtype == torch.int32 and torch.equal(held[3], occ)
    assert 0 < int(occ.sum()) < occ.numel()  # the fold has something to decide
    assert_same(held[:3], SK.shade_bounce_plain(*shade_args, None, sidx, off, **kw))
    assert not torch.equal(held[0][SK.SK_RAD], got[0][SK.SK_RAD])


@pytest.mark.parametrize("name", sorted(CASES))
def test_scan_plain_is_the_every_tile_scan(port_scenes, name):
    """K17 culls nothing: its plain scan equals the other loops' scans,
    whose culls are conservative, and the one-tile plain scans."""
    scene = port_scenes[name]
    _, _, _, _, bounces = traced(name, scene)
    _, feats, pending = bounces[1]
    t, idx, occ = FB.scan_plain(feats, pending, scene.tri_feats16)
    t_w, idx_w, occ_w, _ = scan_then_gather(scene, feats, pending)
    assert torch.equal(t, t_w) and torch.equal(idx, idx_w) and torch.equal(occ, occ_w)
    assert FB.scan_plain(feats, None, scene.tri_feats16)[2] is None


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_film_equals_kernelshade(port_scenes, name):
    _, _, spp, _ = CASES[name]
    config = config_of(name)
    films = [
        render_image(port_scenes[name], config, settings, device="cpu")
        for settings in (RenderSettings(samples=spp, single_tile_loop="fused",
                                        multitile_loop="fused"),
                         RenderSettings(samples=spp))
    ]
    assert np.isfinite(films[0]).all() and films[0].mean() > 0.01
    assert np.array_equal(films[0], films[1])


def test_fused_film_matches_jax_kernelshade(cornell_scene, port_scenes):
    from rustic_tpu.config import TracingConfig as JaxTracingConfig
    from rustic_tpu.runtime.pipeline import render_batch_staged

    w, h, spp, _ = CASES["DarkCornell"]
    jconfig = JaxTracingConfig(width=w, height=h, nee=MIS)
    y, x = np.mgrid[0:h, 0:w]
    px = x.reshape(-1).astype(np.int32)
    py = y.reshape(-1).astype(np.int32)
    off = pixel_offsets(w, h)
    want = np.asarray(
        render_batch_staged(
            cornell_scene, jconfig.static_part(), jconfig.dynamic_part(),
            jnp.asarray(px), jnp.asarray(py), jnp.asarray(off), 0, spp,
        )
    )
    got = render_pixels(port_scenes["DarkCornell"], config_of("DarkCornell"), px, py, spp,
                        offsets=off, single_loop="fused").numpy()
    assert got.shape == (w * h, 3) and np.isfinite(got).all() and got.mean() > 0.01
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "samples, expect",
    [
        # groups 4, 4, 4: the second and the third group's first launch
        # carries the group before's shadow rays and hands their occlusion
        # back; one occlusion scan closes the render
        (12, (12, 2, 1)),
        # groups 4, 4, 2: the short group has another lane count, so the
        # second group is flushed by an occlusion scan, as is the last
        (10, (12, 1, 2)),
    ],
)
def test_fused_group_structure(port_scenes, monkeypatch, samples, expect):
    """Fold 4: one launch of K17 a bounce and no other scan or shade
    launch but the any-hit scans that flush a held group."""
    calls = {}
    count_calls(monkeypatch, FI, ("nearest_attrs", "nearest_shadow_attrs", "occlude", "nearest",
                                  "nearest_shadow"), calls)
    count_calls(monkeypatch, SK, ("shade_bounce", "shade_bounce_wide"), calls)
    held = []
    fused = FB.fused_bounce

    def counted(*a, **k):
        held.append(bool(k.get("hold_occ")))
        return fused(*a, **k)

    monkeypatch.setattr(FB, "fused_bounce", counted)
    monkeypatch.setattr(P, "_FOLD_MAX_LANES", 4 * 64)
    config = TracingConfig(width=16, height=4, nee=MIS)
    film = render_image(port_scenes["DarkCornell"], config,
                        RenderSettings(samples=samples, single_tile_loop="fused"), device="cpu")
    assert film.shape == (4, 16, 3) and np.isfinite(film).all()
    assert (len(held), sum(held)) == expect[:2]
    assert calls == dict.fromkeys(calls, 0) | {"occlude": expect[2]}
    want = render_image(port_scenes["DarkCornell"], config, RenderSettings(samples=samples),
                        device="cpu")
    assert np.array_equal(film, want)


def test_fused_loop_is_opt_in():
    assert RenderSettings().single_tile_loop == P.SINGLE_TILE_LOOPS[0] == "kernel-shade"
    assert RenderSettings().multitile_loop == P.MULTITILE_LOOPS[0] == "kernel-shade"
    assert "fused" in P.SINGLE_TILE_LOOPS and "fused" in P.MULTITILE_LOOPS
    assert P.multitile_loop("fused") is P._render_batch_fused


@pytest.mark.parametrize("case", ["textured", "hdr-sky", "hdr-sky-multitile"])
def test_fused_refuses_scenes_outside_its_envelope(port_scenes, case):
    """A textured scene or an HDR sky raises; no other loop takes over."""
    name = "VeachMIS" if case == "hdr-sky-multitile" else "DarkCornell"
    scene = port_scenes[name]
    if case == "textured":
        scene, config = dataclasses.replace(scene, has_textures=True), config_of(name)
    else:
        sky = torch.from_numpy(load_skybox_image(scene_path("BreakTimeSky.npy")))
        scene, config = dataclasses.replace(scene, skybox=sky), config_of(name, has_skybox=True)
    assert not FB.supported(scene, config.static_part())
    settings = RenderSettings(samples=1, single_tile_loop="fused", multitile_loop="fused")
    with pytest.raises(ValueError, match="fused loop takes untextured scenes"):
        render_image(scene, config, settings, device="cpu")
    for other in ("DarkCornell", "VeachMIS"):
        assert FB.supported(port_scenes[other], config_of(other).static_part())


def test_fused_bounce_refuses_an_hdr_sky(port_scenes):
    scene = port_scenes["DarkCornell"]
    cfg, params, sidx, off, bounces = traced("DarkCornell", scene)
    st, feats, pending = bounces[0]
    with pytest.raises(ValueError, match="procedural sky only"):
        FB.fused_bounce(dataclasses.replace(cfg, has_skybox=True), 0, params, scene.entry_rows, st,
                        feats, pending, scene.tri_feats16, scene.tri_attrs, sidx, off)


def test_rows_moved_counts_what_stays_on_the_sm():
    """A folding bounce moves 70 rows (280 B) a lane less than K2 then K4:
    t, idx, occ and the winner's 32 rows written and read back, rd and ro
    read a second time."""
    k17 = FB.rows_moved(True, False, 16, 16)
    k2 = FB.RAY_ROWS + FB.SHADOW_ROWS + 3 + 32
    k4 = SK.rows_moved(True, True, False, 16, 16)
    assert (k17, k2, k4) == (93, 56, 107)
    assert k2 + k4 - k17 == 70
    # the held mode writes occ and reads no pending rows; the first bounce
    # reads no shadow rays
    assert FB.rows_moved(True, True, 16, 16) == k17 - 4 + 1
    assert FB.rows_moved(False, False, 16, 16) == k17 - 4 - FB.SHADOW_ROWS
