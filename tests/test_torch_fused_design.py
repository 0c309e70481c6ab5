"""K17's orders of work on the H100, held on the CPU through torch twins.

The fused bounce kernel (csrc/fused_bounce.cu) runs K2's scan on one tile
(the live columns only, `pair_skip` before the exact division) and K10's
on many (each ray's slab test against the tiles' AABBs, for the nearest
and the any-hit set), where its plain version, `fused_bounce_plain`,
scans every pair of every tile. Here `fused_bounce_plain` with its scan
replaced by those orders of work (`FI.skip_scan` with `n_live`, and on
many tiles with `tile_aabbs`) equals `fused_bounce_plain` as it stands on
every bounce of traced DarkCornell, VeachMIS and FurnaceTest groups,
folded and held: the state, the next rays and the shadow rays on every
lane, and a held occlusion on every lane whose NEE term is eligible
(st[SK_PEND_ELIG]). That is the one place where the any-hit cull may
change a result: the shadow rays of dead lanes, whose occlusion no fold
reads (tests/test_torch_scan_design_multi.py). Also the wrapper's checks
of `n_live` and `tile_aabbs`, and the fused loop's arguments. All exact:
no tolerance."""

import numpy as np
import pytest
import torch

from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.ops import fused_bounce as FB
from rustic_tpu_torch.ops import shade_kernel as SK
from rustic_tpu_torch.runtime import pipeline as P
from rustic_tpu_torch.runtime.render import pixel_offsets, render_image
from rustic_tpu_torch.scene.world import World
from tests.conftest import scene_path

torch.set_num_threads(2)

MIS = NextEventEstimation.MIS
FOLD = 2
# name -> (film width, height, camera, pixel window x0, x1, y0, y1): the
# sizes of tests/test_torch_fused.py; FurnaceTest's window is where its
# centre object is (tests/test_torch_sorted.py)
CASES = {
    "DarkCornell": (32, 16, {}, (0, 32, 0, 16)),
    "VeachMIS": (16, 12, dict(cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05)),
                 (0, 16, 0, 12)),
    "FurnaceTest": (64, 48, {}, (24, 40, 16, 32)),
}
TILES = {"DarkCornell": 1, "VeachMIS": 6, "FurnaceTest": 20}


@pytest.fixture(scope="module")
def scenes():
    """name -> port scene on the CPU, built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = World.from_path(scene_path(f"{name}.glb")).to_torch("cpu")
        return cache[name]

    return get


def config_of(name):
    w, h, cam, _ = CASES[name]
    return TracingConfig(width=w, height=h, nee=MIS, **cam)


_TRACES = {}


def traced(name, scene):
    """One group of FOLD folded samples of the window's pixels through
    every bounce of the plain scans, a row gather and the shading ->
    (cfg, params, sidx, offsets, [(st, feats, pending shadow rows)])."""
    if name not in _TRACES:
        x0, x1, y0, y1 = CASES[name][3]
        config = config_of(name)
        cfg, cam = config.static_part(), config.dynamic_part("cpu")
        y, x = np.mgrid[y0:y1, x0:x1]
        px = torch.from_numpy(x.reshape(-1).astype(np.int32)).repeat(FOLD)
        py = torch.from_numpy(y.reshape(-1).astype(np.int32)).repeat(FOLD)
        off = pixel_offsets(config.width, config.height).reshape(config.height, config.width)
        off = torch.from_numpy(off[y0:y1, x0:x1].reshape(-1).view(np.int32).copy()).repeat(FOLD)
        st, feats, sidx, params = P.initk(cfg, cam, px, py, 0, off, FOLD)
        kw = dict(has_glass=scene.has_glass, n_alias=scene.n_alias_entries)
        pending, bounces = None, []
        for b in range(cfg.max_bounces):
            bounces.append((st, feats, pending))
            t, idx, occ = FB.scan_plain(feats, pending, scene.tri_feats16)
            rows = scene.tri_attrs[idx.long()].T.contiguous()
            st, nf, pending = SK.shade_bounce_plain(
                cfg, b, params, scene.entry_rows, st, feats, t, idx, rows, occ, sidx, off, **kw)
            if nf is not None:
                feats = nf
        _TRACES[name] = (cfg, params, sidx, off, bounces)
    return _TRACES[name]


def kernel_scan(scene, stats):
    """`scan_plain`'s signature over the kernel's order of work: K2's on
    one tile, K10's on many; each call's skip-test counts go to `stats`."""
    def scan(feats_t, sh_t, g16):
        many = FI.geometry(g16)[2] > 1
        t, idx, occ, st = FI.skip_scan(feats_t, sh_t, g16, scene.tile_aabbs if many else None,
                                       scene.n_tris)
        stats.append(st)
        return t, idx, occ
    return scan


def assert_same(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype
            same = (g == w) | (torch.isnan(g) & torch.isnan(w))
            assert bool(same.all()), int((~same).sum())


@pytest.mark.parametrize("bounce", range(4))
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_scan_keeps_the_fused_outputs(scenes, monkeypatch, name, bounce):
    scene = scenes(name)
    assert FI.geometry(scene.tri_feats16)[2] == TILES[name] and FB.supported(scene)
    cfg, params, sidx, off, bounces = traced(name, scene)
    st, feats, pending = bounces[bounce]
    assert (pending is None) == (bounce == 0)
    kw = dict(has_glass=scene.has_glass, n_alias=scene.n_alias_entries)
    args = (cfg, bounce, params, scene.entry_rows, st, feats, pending, scene.tri_feats16,
            scene.tri_attrs, sidx, off)
    eligible = st[SK.SK_PEND_ELIG] > 0.5
    stats = []
    for hold in (False,) if pending is None else (False, True):
        want = FB.fused_bounce_plain(*args, **kw, hold_occ=hold)
        with monkeypatch.context() as m:
            m.setattr(FB, "scan_plain", kernel_scan(scene, stats))
            got = FB.fused_bounce_plain(*args, **kw, hold_occ=hold)
        assert_same(got[:3], want[:3])
        if hold:
            assert torch.equal(got[3][eligible], want[3][eligible])
    if bounce == 1:  # the fold has lanes to decide
        assert bool(eligible.any())
    # the kernel's order of work tests fewer pairs than every one
    pairs = int(stats[0][0, 0]) + (int(stats[0][1, 0]) if pending is not None else 0)
    every = feats.shape[1] * scene.n_tris * (1 if pending is None else 2)
    assert 0 < pairs <= every
    if TILES[name] > 1:
        assert pairs < every


def test_one_tile_order_walks_the_live_columns_only(scenes):
    """On DarkCornell the skip scan with `n_live` walks the 184 live
    columns of the 256-wide tile and divides for a few of their pairs."""
    scene = scenes("DarkCornell")
    _, _, _, _, bounces = traced("DarkCornell", scene)
    _, feats, pending = bounces[1]
    width = FI.geometry(scene.tri_feats16)[0]
    assert scene.n_tris < width
    t, idx, occ, stats = FI.skip_scan(feats, pending, scene.tri_feats16, None, scene.n_tris)
    want = FB.scan_plain(feats, pending, scene.tri_feats16)
    assert_same((t, idx, occ), want)
    b = feats.shape[1]
    assert int(stats[0, 0]) == b * scene.n_tris  # one tile: every live pair is looked at
    assert 0 < int(stats[0, 1]) < int(stats[0, 0]) // 4  # few pairs divide


@pytest.mark.parametrize("name", ["DarkCornell", "VeachMIS"])
def test_wrapper_takes_n_live_and_refuses_values_outside_the_table(scenes, name):
    scene = scenes(name)
    cfg, params, sidx, off, bounces = traced(name, scene)
    st, feats, pending = bounces[1]
    kw = dict(has_glass=scene.has_glass, n_alias=scene.n_alias_entries)
    args = (cfg, 1, params, scene.entry_rows, st, feats, pending, scene.tri_feats16,
            scene.tri_attrs, sidx, off)
    width = FI.geometry(scene.tri_feats16)[0]
    want = FB.fused_bounce(*args, **kw)
    for n in (1, scene.n_tris, width):
        assert_same(FB.fused_bounce(*args, **kw, n_live=n, tile_aabbs=scene.tile_aabbs), want)
    for bad in (0, -1, width + 1, 1.5, True):
        with pytest.raises(ValueError, match="n_live"):
            FB.fused_bounce(*args, **kw, n_live=bad)


def test_many_tiles_take_aabbs_on_a_cuda_device(scenes):
    """The argument check runs before any launch: on a CUDA device a
    many-tile call without AABBs is refused; on the CPU (the plain version)
    and on one tile they are not needed; AABBs of the wrong shape are
    refused anywhere."""
    veach, cornell = scenes("VeachMIS"), scenes("DarkCornell")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    with pytest.raises(ValueError, match="tile_aabbs"):
        FB.scan_operands(veach.tri_feats16, veach.n_tris, None, cuda)
    assert FB.scan_operands(veach.tri_feats16, veach.n_tris, None, cpu) == veach.n_tris
    assert FB.scan_operands(veach.tri_feats16, None, veach.tile_aabbs, cpu) == \
        FI.geometry(veach.tri_feats16)[0]
    assert FB.scan_operands(cornell.tri_feats16, cornell.n_tris, None, cuda) == cornell.n_tris
    with pytest.raises(ValueError, match="tile_aabbs has shape"):
        FB.scan_operands(veach.tri_feats16, veach.n_tris, veach.tile_aabbs[:5], cpu)


@pytest.mark.parametrize("name", ["DarkCornell", "VeachMIS"])
def test_fused_loop_passes_n_tris_and_aabbs(scenes, monkeypatch, name):
    scene = scenes(name)
    calls = []
    real = FB.fused_bounce

    def spy(*args, **kw):
        calls.append((kw.get("n_live"), kw.get("tile_aabbs")))
        return real(*args, **kw)

    monkeypatch.setattr(FB, "fused_bounce", spy)
    config = TracingConfig(width=8, height=4, nee=MIS, **CASES[name][2])
    film = render_image(scene, config, RenderSettings(samples=2, single_tile_loop="fused",
                                                      multitile_loop="fused"), device="cpu")
    assert np.isfinite(film).all()
    assert len(calls) > 0 and len(calls) % config.max_bounces == 0
    for n_live, aabbs in calls:
        assert n_live == scene.n_tris and aabbs is scene.tile_aabbs
