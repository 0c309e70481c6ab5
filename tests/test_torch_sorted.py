"""The port's ray-sorted and kernel-shade multi-tile loops against the
JAX package.

One scene feeds both packages (scene_from_arrays), with the same pixel
offsets. Tolerances:
- the sort keys and permutation, the sentinel rows and the winner-row
  resolve: exact (integer and copy paths);
- K8's plain version against the JAX Pallas shade kernel in prepicked
  mode (`picked_light_rows_t`, interpret mode): rtol 1e-4, atol 1e-5,
  the shade tolerance of tests/test_torch_shade.py, shadow rows on the
  eligible lanes only (as there);
- films against the JAX ray-sorted (RUSTIC_SORT_MODE=rays there) and
  kernel-shade (RUSTIC_SHADE_KERNEL_MT=1 there) drivers: rtol 1e-4,
  atol 1e-5;
- the port's ray-sorted film against its unsorted film: rtol 1e-6,
  atol 1e-7 (sorting reorders lanes and nothing else).

The JAX kernel-shade driver runs only for pixel batches that are a
multiple of 512 (`supported_mt`) and silently falls back otherwise, so
its film tests use 512 pixels and spy that it ran."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.ops import shade_kernel as SK
from rustic_tpu_torch.ops.resolve import resolve_attrs_rowT
from rustic_tpu_torch.runtime import pipeline as P
from rustic_tpu_torch.runtime.render import pixel_offsets, render_image, render_pixels
from rustic_tpu_torch.scene import world as W
from rustic_tpu_torch.scene.world import scene_from_arrays
from tests.conftest import scene_path
from tests.test_torch_render_multitile import count_calls, jax_scene, scene_fields

torch.set_num_threads(2)

CAMS = {
    "VeachMIS": dict(cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05)),
    "GlassTest": dict(cam_position=(0.0, 2.2, -6.5), cam_rotation=(0.15, 0.0)),
    "FurnaceTest": {},
}
MIS, DIRECT = NextEventEstimation.MIS, NextEventEstimation.DIRECT
SORTED_LOOPS = ("ray-sorted", "kernel-shade")
# the settings that select each of those drivers in the JAX package
JAX_SETTINGS = {
    "ray-sorted": {"RUSTIC_SORT_PATHS": "1", "RUSTIC_SHADE_KERNEL_MT": "0",
                   "RUSTIC_SORT_MODE": "rays"},
    "kernel-shade": {"RUSTIC_SORT_PATHS": "1", "RUSTIC_SHADE_KERNEL_MT": "1"},
}


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX scene, port scene on the CPU), built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            js = jax_scene(name)
            cache[name] = (js, scene_from_arrays(scene_fields(js), "cpu"))
        return cache[name]

    return get


def traced_lanes(ts, name, n, seed):
    """n random lanes of `name` traced by the port through bounce 0 of the
    ray-sorted loop -> (state after it, NEEPack)."""
    rng = np.random.default_rng(seed)
    cfg = TracingConfig(width=64, height=48, nee=MIS, **CAMS[name])
    px = torch.from_numpy(rng.integers(0, 64, n).astype(np.int32))
    py = torch.from_numpy(rng.integers(0, 48, n).astype(np.int32))
    off = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32).view(np.int32))
    st, feats, sidx = P.rs_init(cfg.static_part(), cfg.dynamic_part("cpu"), px, py, 0, off, 1)
    t, idx, _ = P._scan(feats, None, ts)
    return P._shade(ts, cfg.static_part(), cfg.dynamic_part("cpu"), 0, st, None, None,
                    t, idx, sidx, off)


# ---- sorting, sentinels, resolve ------------------------------------------


def test_sort_perm_matches_jax(scenes):
    """Bounce-1 rays of VeachMIS with their retired lanes: the port's
    stable sort of the Morton/octant keys is JAX's `_sort_perm_rays`."""
    from rustic_tpu.runtime import pipeline as JP

    js, ts = scenes("VeachMIS")
    st, nee = traced_lanes(ts, "VeachMIS", 4096, seed=1)
    dead = ~st.alive & ~nee.eligible
    assert 0.1 < float(dead.float().mean()) < 0.9  # some lanes retired
    got = P.sort_perm_rays(ts, st.ro, st.rd, dead).numpy()
    want = np.asarray(JP._sort_perm_rays(
        js, jnp.asarray(st.ro.numpy()), jnp.asarray(st.rd.numpy()), jnp.asarray(dead.numpy())
    ))
    keys = P.sort_keys(ts, st.ro, st.rd, dead).numpy()
    assert len(np.unique(keys)) > 100  # the keys spread the lanes over many cells
    assert (np.diff(keys[got]) >= 0).all() and (keys[got][-int(dead.sum()):] >= 1 << 16).all()
    np.testing.assert_array_equal(got, want)


def test_sentinel_rows_match_jax():
    from rustic_tpu.runtime import pipeline as JP

    rng = np.random.default_rng(2)
    feats = rng.normal(0, 3, (1000, 16)).astype(np.float32)
    dead = rng.uniform(0, 1, 1000) < 0.4
    want = np.asarray(JP._sentinel_feats(jnp.asarray(feats), jnp.asarray(dead)))
    got = P.sentinel_feats(torch.from_numpy(feats.T.copy()), torch.from_numpy(dead))
    np.testing.assert_array_equal(got.numpy().T, want)


def test_sentinel_blocks_admit_no_tile(scenes):
    """A block of sentinel rays admits no tile for either ray set, and the
    scans then return what JAX's return for it: t = BIG, idx 0, occ 0."""
    _, ts = scenes("VeachMIS")
    st, nee = traced_lanes(ts, "VeachMIS", 512, seed=3)
    dead = torch.zeros(512, dtype=torch.bool)
    dead[256:] = True
    rays = P.sentinel_feats(P._ray_features16(st.ro, st.rd), dead)
    shadow = P.sentinel_feats(P._shadow_feats16(nee), dead)
    lists, counts = FI.block_tile_lists(ts.tile_aabbs, FI.BT_MULTI, (False, True), rays, shadow)
    assert counts[0] > 0 and counts[1] == 0
    t, idx, occ = FI.nearest_shadow_multi(rays, shadow, ts.tri_feats16, lists, counts)
    assert bool((t[256:] == FI.BIG).all() and (idx[256:] == 0).all() and (occ[256:] == 0).all())


def test_resolve_matches_jax(scenes):
    from rustic_tpu.ops.resolve import resolve_attrs_rowT as jax_resolve

    js, ts = scenes("VeachMIS")
    rng = np.random.default_rng(4)
    t_pad = ts.tri_attrs.shape[0]
    idx = rng.integers(0, t_pad, 2048).astype(np.int32)  # padding rows included
    feats = rng.normal(0, 1, (16, 2048)).astype(np.float32)
    want = np.asarray(jax_resolve(js, jnp.asarray(feats), jnp.asarray(idx)))
    got = resolve_attrs_rowT(ts, torch.from_numpy(feats), torch.from_numpy(idx))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_resolve_refuses_textures(scenes):
    """Textured scenes were refused before BreakTime was ported; now their
    resolve returns slim rows whose untextured lanes carry the material's
    factors as the slim table does (tests/test_torch_textures.py holds
    the textured lanes to JAX)."""
    from rustic_tpu_torch.scene.world import World

    ts = World.from_path(scene_path("BreakTime.glb"), 64).to_torch("cpu")
    full = ts.tri_attrs
    assert ts.has_textures and full.shape[1] == W.ATTR_WIDTH
    plain = (full[:ts.n_tris, W.ATTR_HASTEX] == 0).all(dim=1).nonzero()[:, 0]
    idx = plain.to(torch.int32)
    assert len(idx) > 4
    feats = torch.zeros((16, len(idx)))
    feats[0] = 1.0  # any ray: the material columns do not depend on it
    got = resolve_attrs_rowT(ts, feats, idx)
    assert got.shape == (W.SLIM_WIDTH, len(idx))
    want = torch.from_numpy(W.slim_attr_table(full[idx.long()].numpy())).T
    for cols in (range(0, 9), range(18, 28)):  # positions, then the material
        assert torch.equal(got[list(cols)], want[list(cols)])


# ---- K8: the wide-alias shade kernel's plain version ------------------------

K8_LANES = 512  # the JAX kernel's lane blocks need a multiple of 128
# pixels drawn for the K8 lanes (x0, x1, y0, y1) of a 64x48 film: FurnaceTest's
# emissive enclosure ends the paths that miss its centre object
WINDOW = {"VeachMIS": (0, 64, 0, 48), "FurnaceTest": (24, 40, 16, 32)}


def trace_ks(ts, name, mode, bounce: int, seed: int):
    """Port plain stages of the kernel-shade loop up to the shade input of
    `bounce` -> (cfg, shade arguments, n_alias)."""
    rng = np.random.default_rng(seed)
    config = TracingConfig(width=64, height=48, nee=mode, **CAMS[name])
    cfg = config.static_part()
    x0, x1, y0, y1 = WINDOW[name]
    px = torch.from_numpy(rng.integers(x0, x1, K8_LANES).astype(np.int32))
    py = torch.from_numpy(rng.integers(y0, y1, K8_LANES).astype(np.int32))
    off = torch.from_numpy(rng.integers(0, 2**32, K8_LANES, dtype=np.uint32).view(np.int32))
    st, feats_t, sidx, params = P.initk(cfg, config.dynamic_part("cpu"), px, py,
                                        int(rng.integers(0, 1 << 20)), off, 1)
    n_alias = ts.n_alias_entries
    pending = inv = feats_in = None
    for b in range(bounce + 1):
        t, i, occ = P._scan(feats_t if feats_in is None else feats_in, pending, ts)
        t, i, occ, attrs_t = P.ks_resolve(ts, feats_t, t, i, occ, inv)
        args = dict(params=params, entry_rows=ts.entry_rows, st=st, feats_t=feats_t, t=t,
                    idx=i, attrs_t=attrs_t, occ=occ, sidx=sidx, offsets=off)
        if b == bounce:
            return cfg, args, n_alias
        st, nf, sf = SK.shade_bounce_wide(cfg, b, **args, has_glass=ts.has_glass,
                                          n_alias=n_alias)
        feats_in, pending, inv = P.ks_sort(ts, st, nf, sf)
        if nf is not None:
            feats_t = nf


@pytest.mark.parametrize("bounce", [0, 1, 2, 3])
@pytest.mark.parametrize("mode", [MIS, DIRECT])
@pytest.mark.parametrize("name", ["VeachMIS", "FurnaceTest"])  # 2,880 and 5,120 entries
def test_wide_shade_matches_jax_prepicked(scenes, name, mode, bounce):
    from rustic_tpu.config import NextEventEstimation as JaxNee
    from rustic_tpu.config import StaticConfig as JaxStaticConfig
    from rustic_tpu.ops import shade_kernel as JSK
    from rustic_tpu.ops.resolve import picked_light_rows_t

    js, ts = scenes(name)
    cfg, args, n_alias = trace_ks(ts, name, mode, bounce, seed=20 + bounce)
    assert n_alias > SK.MAX_ALIAS
    outs_p = SK.shade_bounce_wide(cfg, bounce, **args, has_glass=ts.has_glass, n_alias=n_alias)

    j = {k: (None if v is None else jnp.asarray(v.numpy())) for k, v in args.items()}
    for k in ("sidx", "offsets"):
        j[k] = jnp.asarray(args[k].numpy().view(np.uint32))
    jcfg = JaxStaticConfig(
        width=cfg.width, height=cfg.height, min_bounces=cfg.min_bounces,
        max_bounces=cfg.max_bounces, nee=JaxNee(int(cfg.nee)), has_skybox=False,
    )
    picked = picked_light_rows_t(js, bounce, j["sidx"], j["offsets"])
    outs_j = JSK.shade_bounce(
        jcfg, bounce, j["params"], j["entry_rows"], j["st"], j["feats_t"], j["t"], j["idx"],
        j["attrs_t"], j["occ"], j["sidx"], j["offsets"], has_glass=js.has_glass,
        n_alias=n_alias, interpret=True, pickedT=picked,
    )
    eligible = outs_p[0][SK.SK_PEND_ELIG].numpy() > 0.5
    np.testing.assert_array_equal(eligible, np.asarray(outs_j[0][SK.SK_PEND_ELIG]) > 0.5)
    if bounce == 0 or (name == "VeachMIS" and bounce == 1):
        assert eligible.mean() > 0.02  # NEE candidates exist
    for name_, p, q, sel in zip(("state", "next rays", "shadow rays"), outs_p, outs_j,
                                (slice(None), slice(None), eligible)):
        assert (p is None) == (q is None), name_
        if p is not None:
            np.testing.assert_allclose(
                p.numpy()[:, sel], np.asarray(q)[:, sel], rtol=1e-4, atol=1e-5, err_msg=name_
            )


@pytest.mark.parametrize("bounce", [0, 1])
def test_shade_reads_only_the_rows_it_counts(scenes, bounce):
    """The rows `rows_moved` leaves out (the bound of K4/K8 in
    chip_smoke.py) may hold NaN without changing a bit of the result:
    feats rows other than rd and ro, the slim rows past the metallic row
    (VeachMIS has no glass) and, with no shadow result to fold (bounce
    0), the pending NEE state rows."""
    _, ts = scenes("VeachMIS")
    assert not ts.has_glass
    cfg, args, n_alias = trace_ks(ts, "VeachMIS", MIS, bounce, seed=30)
    assert (args["occ"] is None) == (bounce == 0)
    kw = dict(has_glass=False, n_alias=n_alias)
    want = SK.shade_bounce_wide(cfg, bounce, **args, **kw)
    poisoned = dict(args, feats_t=args["feats_t"].clone(), attrs_t=args["attrs_t"].clone(),
                    st=args["st"].clone())
    poisoned["feats_t"][[3, 4, 5] + list(range(9, 16))] = float("nan")
    poisoned["attrs_t"][W.SLIM_METAL + 1:] = float("nan")
    if args["occ"] is None:
        poisoned["st"][SK.SK_PEND_CON.start:] = float("nan")
    got = SK.shade_bounce_wide(cfg, bounce, **poisoned, **kw)
    for g, w in zip(got, want):
        assert bool(((g == w) | (g.isnan() & w.isnan())).all())
    n_rows = SK.rows_moved(bounce > 0, True, False, 16, 16)
    assert n_rows == (107 if bounce else 102)


# ---- films -----------------------------------------------------------------

FILM_W, FILM_H = 32, 16  # 512 pixels: the JAX kernel-shade driver's lane block


def jax_film(js, name, spp):
    from rustic_tpu.config import TracingConfig as JaxTracingConfig
    from rustic_tpu.runtime import pipeline as JP

    config = JaxTracingConfig(width=FILM_W, height=FILM_H, nee=MIS, **CAMS[name])
    y, x = np.mgrid[0:FILM_H, 0:FILM_W]
    return np.asarray(JP.render_batch_staged(
        js, config.static_part(), config.dynamic_part(),
        jnp.asarray(x.reshape(-1).astype(np.int32)), jnp.asarray(y.reshape(-1).astype(np.int32)),
        jnp.asarray(pixel_offsets(FILM_W, FILM_H)), 0, spp,
    ))


def port_film(ts, name, spp, loop):
    config = TracingConfig(width=FILM_W, height=FILM_H, nee=MIS, **CAMS[name])
    y, x = np.mgrid[0:FILM_H, 0:FILM_W]
    return render_pixels(ts, config, x.reshape(-1), y.reshape(-1), spp,
                         offsets=pixel_offsets(FILM_W, FILM_H), loop=loop).numpy()


def spy(monkeypatch, mod, name):
    """Count the calls of `mod.name`."""
    calls = []
    real = getattr(mod, name)

    def wrapper(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(mod, name, wrapper)
    return calls


@pytest.mark.parametrize("name", sorted(CAMS))
@pytest.mark.parametrize("driver", SORTED_LOOPS)
def test_sorted_film_matches_jax(scenes, monkeypatch, name, driver):
    from rustic_tpu.runtime import pipeline as JP

    js, ts = scenes(name)
    monkeypatch.setattr(JP, "_SORT_PATHS", True)
    for k, v in JAX_SETTINGS[driver].items():
        monkeypatch.setenv(k, v)
    fn = "_render_batch_raysorted" if driver == "ray-sorted" else "_render_batch_ks_multitile"
    calls = (spy(monkeypatch, JP, fn), spy(monkeypatch, P, fn))
    spp = 2
    want = jax_film(js, name, spp)
    got = port_film(ts, name, spp, driver)
    assert calls[0] and calls[1], "the driver under test was not dispatched"
    assert got.shape == (FILM_W * FILM_H, 3) and np.isfinite(got).all()
    assert got.mean() > 0.01
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CAMS))
def test_raysorted_film_equals_unsorted(scenes, name):
    _, ts = scenes(name)
    config = TracingConfig(width=16, height=12, nee=MIS, **CAMS[name])
    films = {
        loop: render_image(ts, config, RenderSettings(samples=6, multitile_loop=loop),
                           device="cpu")
        for loop in ("unsorted", "ray-sorted")
    }
    assert films["ray-sorted"].mean() > 0.01
    np.testing.assert_allclose(films["ray-sorted"], films["unsorted"], rtol=1e-6, atol=1e-7)


# ---- loop structure and dispatch -------------------------------------------

SCANS = ("nearest_multi", "nearest_shadow_multi", "occlude_multi",
         "nearest_attrs", "nearest_shadow_attrs", "occlude")


@pytest.mark.parametrize("samples, expect", [(12, (1, 11, 1)), (10, (2, 10, 2))])
@pytest.mark.parametrize("driver", SORTED_LOOPS)
def test_sorted_group_structure(scenes, monkeypatch, driver, samples, expect):
    """Fold 4: groups 4, 4, 4 (one K5 opens, one K7 closes) or 4, 4, 2
    (the short group's other lane count flushes the held group with K7
    and opens with K5); every bounce of every group shades once and
    sorts once (the last bounce sorts its shadow rays)."""
    _, ts = scenes("VeachMIS")
    calls = {}
    count_calls(monkeypatch, FI, SCANS, calls)
    if driver == "ray-sorted":
        count_calls(monkeypatch, P, ("rs_pre", "_sort_rows"), calls)
        stages = {"rs_pre": 12, "_sort_rows": 12}
    else:
        count_calls(monkeypatch, P, ("ks_resolve", "ks_sort"), calls)
        count_calls(monkeypatch, SK, ("shade_bounce", "shade_bounce_wide"), calls)
        stages = {"ks_resolve": 12, "ks_sort": 12, "shade_bounce_wide": 12, "shade_bounce": 0}
    monkeypatch.setattr(P, "_FOLD_MAX_LANES", 4 * 64)
    config = TracingConfig(width=16, height=4, nee=MIS, **CAMS["VeachMIS"])
    settings = RenderSettings(samples=samples, multitile_loop=driver, multitile_scan="lists")
    film = render_image(ts, config, settings, device="cpu")
    assert film.shape == (4, 16, 3) and np.isfinite(film).all()
    assert calls == {
        "nearest_multi": expect[0], "nearest_shadow_multi": expect[1],
        "occlude_multi": expect[2], "nearest_attrs": 0, "nearest_shadow_attrs": 0, "occlude": 0,
    } | stages


@pytest.mark.parametrize("driver", SORTED_LOOPS)
def test_sorted_without_nee_has_no_shadow_scans(scenes, monkeypatch, driver):
    """NEE off: one nearest scan per bounce, nothing held; the kernel-shade
    loop shades through K4 (no alias pick)."""
    _, ts = scenes("VeachMIS")
    calls = {}
    count_calls(monkeypatch, FI, SCANS, calls)
    count_calls(monkeypatch, SK, ("shade_bounce", "shade_bounce_wide"), calls)
    config = TracingConfig(width=8, height=4, nee=NextEventEstimation.NONE, **CAMS["VeachMIS"])
    film = render_image(ts, config, RenderSettings(samples=2, multitile_loop=driver,
                                                   multitile_scan="lists"), device="cpu")
    assert np.isfinite(film).all() and film.mean() > 0.0
    shades = config.max_bounces if driver == "kernel-shade" else 0
    assert calls == dict.fromkeys(SCANS, 0) | {
        "nearest_multi": config.max_bounces, "shade_bounce": shades, "shade_bounce_wide": 0,
    }


def test_kernel_shade_uses_k4_for_small_tables(scenes, monkeypatch):
    """GlassTest's 2 alias entries fit K4's table (the default loop)."""
    _, ts = scenes("GlassTest")
    assert ts.n_alias_entries <= SK.MAX_ALIAS
    calls = {}
    count_calls(monkeypatch, SK, ("shade_bounce", "shade_bounce_wide"), calls)
    config = TracingConfig(width=8, height=4, nee=MIS, **CAMS["GlassTest"])
    render_image(ts, config, RenderSettings(samples=1), device="cpu")
    assert calls == {"shade_bounce": config.max_bounces, "shade_bounce_wide": 0}


@pytest.mark.parametrize("loop, driver", [
    ("kernel-shade", "_render_batch_ks_multitile"),
    ("ray-sorted", "_render_batch_raysorted"),
    ("unsorted", "_render_batch_unsorted"),
    ("state-sorted", "_render_batch_sorted"),
    ("auto", "_render_batch_auto"),
])
def test_multitile_loop_names(monkeypatch, loop, driver):
    monkeypatch.delenv("RUSTIC_SORT_MODE", raising=False)
    assert P.multitile_loop(loop) is getattr(P, driver)


def test_default_loop_is_kernel_shade(scenes, monkeypatch):
    """RenderSettings and render_batch_staged default to the first of
    MULTITILE_LOOPS, the kernel-shade loop."""
    _, ts = scenes("VeachMIS")
    assert RenderSettings().multitile_loop == P.MULTITILE_LOOPS[0] == "kernel-shade"
    calls = spy(monkeypatch, P, "_render_batch_ks_multitile")
    config = TracingConfig(width=4, height=2, nee=MIS, **CAMS["VeachMIS"])
    y, x = np.mgrid[0:2, 0:4]
    P.render_batch_staged(
        ts, config.static_part(), config.dynamic_part("cpu"),
        torch.from_numpy(x.reshape(-1).astype(np.int32)),
        torch.from_numpy(y.reshape(-1).astype(np.int32)),
        torch.zeros(8, dtype=torch.int32), 0, 1,
    )
    assert calls == [1]


def test_state_sort_mode_is_refused(monkeypatch):
    """The state-sorted driver is ported and named by argument: the JAX
    package's RUSTIC_SORT_MODE is not read (each name gives its own loop
    under any setting), and its values are no loop names."""
    want = {loop: P.multitile_loop(loop) for loop in P.MULTITILE_LOOPS}
    assert want["state-sorted"] is P._render_batch_sorted
    for mode in ("state", "rays", "auto"):
        monkeypatch.setenv("RUSTIC_SORT_MODE", mode)
        assert {loop: P.multitile_loop(loop) for loop in P.MULTITILE_LOOPS} == want
    monkeypatch.delenv("RUSTIC_SORT_MODE")
    for name in ("rays", "state"):
        with pytest.raises(ValueError, match="multi-tile loop"):
            P.multitile_loop(name)


# the fused loop does refuse an HDR sky (tests/test_torch_fused.py)
@pytest.mark.parametrize("loop", [name for name in P.MULTITILE_LOOPS if name != "fused"])
def test_multitile_loops_refuse_hdr_sky(scenes, loop):
    """HDR skies were refused before BreakTime was ported; now each loop
    renders one, and its film equals the unsorted loop's (rtol 1e-4,
    atol 1e-5: the kernel-shade loop pays the sky after its last bounce)."""
    import dataclasses

    from rustic_tpu_torch.scene.world import load_skybox_image

    _, ts = scenes("VeachMIS")
    sky = torch.from_numpy(load_skybox_image(scene_path("BreakTimeSky.npy")))
    scene = dataclasses.replace(ts, skybox=sky)
    config = TracingConfig(width=8, height=8, nee=MIS, has_skybox=True, **CAMS["VeachMIS"])
    films = {
        name: render_image(scene, config, RenderSettings(samples=1, multitile_loop=name),
                           device="cpu")
        for name in (loop, "unsorted")
    }
    assert np.isfinite(films[loop]).all()
    np.testing.assert_allclose(films[loop], films["unsorted"], rtol=1e-4, atol=1e-5)
