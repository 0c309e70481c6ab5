"""The port's state-sorted driver (path compaction, the pilot schedule and
the "auto" pick) against the JAX package's.

One scene feeds both packages (scene_from_arrays), with the same pixel
offsets. The JAX side is its state-sorted driver, selected as
tests/test_compaction.py and tests/test_torch_sorted.py select it
(RUSTIC_SORT_PATHS on, RUSTIC_SORT_MODE=state; Pallas in interpret mode,
the "f32" plan). Tolerances:
- `_permute_lanes`, `_sort_perm`, `_quantize_schedule`, the pilot's keep
  counts and `_pick_sort_mode`: exact;
- films against the JAX state-sorted and "auto" drivers: rtol 1e-4, atol
  1e-5 (XLA contracts FMAs; tests/test_torch_sorted.py);
- the compacted film against the uncompacted one, and the state-sorted
  film against the port's unsorted film: rtol 1e-5, atol 1e-6 (the same
  lanes, their radiance scatter-added in another order).
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.runtime import pipeline as P
from rustic_tpu_torch.runtime.render import pixel_offsets, render_image, render_pixels
from rustic_tpu_torch.scene.world import scene_from_arrays
from tests.test_torch_render_multitile import count_calls, jax_scene, scene_fields
from tests.test_torch_sorted import CAMS, spy, traced_lanes

torch.set_num_threads(2)

MIS = NextEventEstimation.MIS
FILM_W, FILM_H = 32, 16  # 512 pixels
SPP = 2
# the settings that select each JAX driver
JAX_MODES = {
    "state-sorted": {"RUSTIC_SORT_PATHS": "1", "RUSTIC_SHADE_KERNEL_MT": "0",
                     "RUSTIC_SORT_MODE": "state"},
    "auto": {"RUSTIC_SORT_PATHS": "1", "RUSTIC_SHADE_KERNEL_MT": "0", "RUSTIC_SORT_MODE": "auto"},
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


@pytest.fixture(autouse=True)
def fresh_pilots():
    """No schedule outlives a test: both packages' pilot caches emptied."""
    from rustic_tpu.runtime import pipeline as JP

    P._PILOT_CACHE.clear()
    JP._PILOT_CACHE.clear()
    yield
    P._PILOT_CACHE.clear()
    JP._PILOT_CACHE.clear()


def pixels(w=FILM_W, h=FILM_H):
    y, x = np.mgrid[0:h, 0:w]
    return x.reshape(-1).astype(np.int32), y.reshape(-1).astype(np.int32)


def jax_args(name, w=FILM_W, h=FILM_H):
    """The JAX (cfg, cam, px, py, offsets) of `name`'s film."""
    from rustic_tpu.config import TracingConfig as JaxTracingConfig

    config = JaxTracingConfig(width=w, height=h, nee=MIS, **CAMS[name])
    x, y = pixels(w, h)
    return (config.static_part(), config.dynamic_part(), jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(pixel_offsets(w, h)))


def port_args(name, w=FILM_W, h=FILM_H):
    config = TracingConfig(width=w, height=h, nee=MIS, **CAMS[name])
    x, y = pixels(w, h)
    off = torch.from_numpy(pixel_offsets(w, h).view(np.int32))
    return (config.static_part(), config.dynamic_part("cpu"), torch.from_numpy(x),
            torch.from_numpy(y), off)


# ---- the pieces ---------------------------------------------------------------


class Carry(NamedTuple):
    a: torch.Tensor
    b: tuple


@pytest.mark.parametrize("dtype", ["float32", "bool", "int32", "u32-bits", "int64"])
def test_permute_lanes_round_trip_is_exact(dtype):
    """Every dtype survives a permutation and its inverse bit for bit and
    keeps its dtype; the permuted f32, bool and u32 leaves equal JAX's
    single packed gather (exact for those), nested in NamedTuples with None."""
    from rustic_tpu.runtime import pipeline as JP

    rng = np.random.default_rng(5)
    n = 1000
    values = {
        "float32": rng.normal(0, 1e3, (n, 3)).astype(np.float32),
        "bool": rng.uniform(0, 1, n) < 0.3,
        "int32": rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32),
        "u32-bits": rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        "int64": rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64),
    }[dtype]
    leaf = torch.from_numpy(values.view(np.int32) if dtype == "u32-bits" else values)
    tree = Carry(a=leaf, b=(leaf[:, None] if leaf.dim() == 1 else leaf, None))
    perm = torch.from_numpy(rng.permutation(n))
    moved = P._permute_lanes(perm, tree)
    back = P._permute_lanes(P._inverse(perm), moved)
    assert isinstance(back, Carry) and back.b[1] is None
    for got, want in ((back.a, tree.a), (back.b[0], tree.b[0])):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert not torch.equal(moved.a, tree.a)
    if dtype in ("float32", "bool", "u32-bits"):
        want = np.asarray(JP._permute_lanes(jnp.asarray(perm.numpy()), jnp.asarray(values)))
        got = moved.a.numpy().view(np.uint32) if dtype == "u32-bits" else moved.a.numpy()
        np.testing.assert_array_equal(got, want)


def test_sort_perm_puts_dead_lanes_last(scenes):
    """Bounce-1 VeachMIS lanes: the state's permutation puts every lane
    that owes no work behind every lane that does, and is JAX's."""
    from rustic_tpu.runtime import pipeline as JP

    js, ts = scenes("VeachMIS")
    st, nee = traced_lanes(ts, "VeachMIS", 4096, seed=6)
    dead = ~(st.alive | nee.eligible)
    assert 0.05 < float(dead.float().mean()) < 0.95
    perm = P._sort_perm(ts, st, dead)
    n_dead = int(dead.sum())
    assert not bool(dead[perm[:-n_dead]].any()) and bool(dead[perm[-n_dead:]].all())

    class State(NamedTuple):
        ro: object
        rd: object

    want = JP._sort_perm(js, State(jnp.asarray(st.ro.numpy()), jnp.asarray(st.rd.numpy())),
                         jnp.asarray(dead.numpy()))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want))


@pytest.mark.parametrize("counts, lanes, bt, measured", [
    ([6000, 900, 10], 16384, 256, None),
    ([15000, 14000, 13000], 16384, 256, None),  # near-full survival: None
    ([37, 2, 1], 3072, 256, 1024),
    ([708, 280, 124], 3072, 256, 1024),
    ([0, 0, 0], 1000, 256, None),
    ([400, 6000, 3], 65536, 256, 8192),  # a later bounce may not grow
    ([100], 300, 256, 100),
])
def test_quantize_schedule_matches_jax(counts, lanes, bt, measured):
    from rustic_tpu.runtime import pipeline as JP

    want = JP._quantize_schedule(counts, lanes, bt, measured=measured)
    assert P._quantize_schedule(counts, lanes, bt, measured=measured) == want


def capture_quantize(monkeypatch, mod):
    """Record the arguments `mod._quantize_schedule` is called with."""
    seen = []
    real = mod._quantize_schedule

    def wrapper(counts, lanes, bt, measured=None):
        seen.append((list(counts), lanes, bt, measured))
        return real(counts, lanes, bt, measured=measured)

    monkeypatch.setattr(mod, "_quantize_schedule", wrapper)
    return seen


@pytest.mark.parametrize("name", ["FurnaceTest", "VeachMIS"])
def test_pilot_keep_counts_match_jax(scenes, monkeypatch, name):
    """The pilot's keep counts (bounces 0-2 of a strided subsample) and
    its schedule equal the JAX pilot's."""
    from rustic_tpu.ops.flash_intersect import resolve_precision
    from rustic_tpu.runtime import pipeline as JP

    js, ts = scenes(name)
    seen_j, seen_p = capture_quantize(monkeypatch, JP), capture_quantize(monkeypatch, P)
    lanes = 2 * FILM_W * FILM_H
    want = JP._pilot_schedule(js, *jax_args(name), 0, lanes, FI.BT_MULTI, True,
                              resolve_precision("auto", True))
    got = P._pilot_schedule(ts, *port_args(name), 0, lanes, FI.BT_MULTI, "lists")
    assert seen_p == seen_j and len(seen_p) == 1
    assert got == want
    counts = seen_p[0][0]
    assert counts[0] > 0 and counts == sorted(counts, reverse=True)


@pytest.mark.parametrize("name, mode", [("FurnaceTest", "state"), ("VeachMIS", "rays")])
def test_pick_sort_mode_matches_jax(scenes, name, mode):
    from rustic_tpu.ops.flash_intersect import resolve_precision
    from rustic_tpu.runtime import pipeline as JP

    js, ts = scenes(name)
    want = JP._pick_sort_mode(js, *jax_args(name), 0, SPP, FI.BT_MULTI, True,
                              resolve_precision("auto", True))
    assert P._pick_sort_mode(ts, *port_args(name), 0, SPP) == want == mode
    lanes, schedule = P.sort_mode_pilot(ts, *port_args(name), 0, SPP)
    w = P.work_fraction(port_args(name)[0], lanes, schedule)
    assert (w <= P._STATE_SORT_MAX_W) == (mode == "state")


# ---- films against the JAX drivers ------------------------------------------------

_JAX_FILMS = {}


def jax_film(js, name, driver, monkeypatch):
    """The JAX film of `driver` on `name`, its dispatch spied; once a module."""
    from rustic_tpu.runtime import pipeline as JP

    if (name, driver) not in _JAX_FILMS:
        with monkeypatch.context() as m:
            m.setattr(JP, "_SORT_PATHS", True)
            for k, v in JAX_MODES[driver].items():
                m.setenv(k, v)
            calls = {}
            count_calls(m, JP, ("_render_batch_sorted", "_render_batch_raysorted"), calls)
            film = np.asarray(JP.render_batch_staged(js, *jax_args(name), 0, SPP))
        assert sum(calls.values()) == 1
        _JAX_FILMS[name, driver] = film, calls
    return _JAX_FILMS[name, driver]


def port_film(ts, name, loop, scan="lists"):
    config = TracingConfig(width=FILM_W, height=FILM_H, nee=MIS, **CAMS[name])
    x, y = pixels()
    return render_pixels(ts, config, x, y, SPP, offsets=pixel_offsets(FILM_W, FILM_H),
                         loop=loop, scan=scan).numpy()


def assert_film(got, want):
    assert got.shape == (FILM_W * FILM_H, 3) and np.isfinite(got).all()
    assert got.mean() > 0.01
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("scan", ["lists", "grid", "resident"])
@pytest.mark.parametrize("name", ["FurnaceTest", "VeachMIS"])
def test_state_sorted_film_matches_jax(scenes, monkeypatch, name, scan):
    """Each scan form; both scenes compact at this size (a schedule exists:
    FurnaceTest drops lanes from bounce 0 on, VeachMIS at bounce 2)."""
    js, ts = scenes(name)
    want, jcalls = jax_film(js, name, "state-sorted", monkeypatch)
    assert jcalls["_render_batch_sorted"] == 1
    drivers = spy(monkeypatch, P, "_render_batch_sorted")
    seen = capture_quantize(monkeypatch, P)
    assert_film(port_film(ts, name, "state-sorted", scan), want)
    assert drivers == [1] and len(seen) == 1
    assert P._quantize_schedule(*seen[0][:3], measured=seen[0][3]) is not None


@pytest.mark.parametrize("name", ["FurnaceTest", "VeachMIS"])
def test_auto_film_matches_jax(scenes, monkeypatch, name):
    """"auto" takes the state-sorted driver on FurnaceTest in both
    packages; on VeachMIS the JAX package takes its ray-sorted driver and
    the port the kernel-shade loop, whose films agree
    (tests/test_torch_sorted.py)."""
    js, ts = scenes(name)
    want, jcalls = jax_film(js, name, "auto", monkeypatch)
    state = name == "FurnaceTest"
    assert jcalls["_render_batch_sorted"] == int(state)
    calls = {}
    count_calls(monkeypatch, P, ("_render_batch_sorted", "_render_batch_ks_multitile"), calls)
    assert_film(port_film(ts, name, "auto"), want)
    assert calls == {"_render_batch_sorted": int(state), "_render_batch_ks_multitile": 1 - state}


# ---- compaction ------------------------------------------------------------------


def film_of(ts, name, n_px, spp, seed=11, loop="state-sorted", scan="lists"):
    """A random pixel set's film sum through `loop`, as tests/test_compaction.py
    draws it."""
    config = TracingConfig(width=64, height=64, nee=MIS, **CAMS[name])
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 64, n_px).astype(np.int32)
    py = rng.integers(0, 64, n_px).astype(np.int32)
    off = rng.integers(0, 1 << 31, n_px).astype(np.uint32)
    return render_pixels(ts, config, px, py, spp, offsets=off, loop=loop, scan=scan).numpy()


def watch_windows(monkeypatch):
    """Record (k_out, lanes in, overflow after) of every compacting `ss_pre`,
    and check that the ray rows it hands the scans are contiguous (the
    card's scans refuse any other)."""
    seen = []
    real = P.ss_pre

    def wrapper(*a, **k):
        out = real(*a, **k)
        window = a[12] if len(a) > 12 else k.get("window")
        if window is not None:
            seen.append((window[0], a[4].alive.shape[0], bool(out[-1])))
            rows = [out[1]] + ([] if out[2] is None else [out[2][1]])
            assert all(r.is_contiguous() and r.shape[1] == out[3].shape[0] for r in rows)
        return out

    monkeypatch.setattr(P, "ss_pre", wrapper)
    return seen


def test_compacted_film_equals_uncompacted(scenes, monkeypatch):
    """FurnaceTest retires ~94% of its lanes at bounce 0: the pilot's
    schedule compacts hard, and the film equals the uncompacted one."""
    _, ts = scenes("FurnaceTest")
    with monkeypatch.context() as m:
        m.setattr(P, "_pilot_schedule", lambda *a, **k: None)
        ref = film_of(ts, "FurnaceTest", 1024, 3)
    seen = watch_windows(monkeypatch)
    multi = film_of(ts, "FurnaceTest", 1024, 3)
    assert seen, "compaction did not engage"
    assert any(k_out < lanes for k_out, lanes, _ in seen)
    assert not any(oflow for _, _, oflow in seen)
    assert ref.mean() > 0.1
    np.testing.assert_allclose(multi, ref, rtol=1e-5, atol=1e-6)


def test_overflow_redo_is_unbiased(scenes, monkeypatch):
    """A schedule that drops live lanes (VeachMIS keeps ~80% at bounce 0,
    the forced schedule 256 of 1536) trips the overflow flag, and the
    window is rendered again uncompacted: the uncompacted film."""
    _, ts = scenes("VeachMIS")
    with monkeypatch.context() as m:
        m.setattr(P, "_pilot_schedule", lambda *a, **k: None)
        ref = film_of(ts, "VeachMIS", 512, 3)
    monkeypatch.setattr(P, "_quantize_schedule", lambda counts, lanes, bt, **k: (256,) * len(counts))
    seen = watch_windows(monkeypatch)
    finishes = spy(monkeypatch, P, "ss_finish")
    multi = film_of(ts, "VeachMIS", 512, 3)
    assert seen and seen[-1][2], "the overflow did not trip"
    assert len(finishes) == 2  # the compacted group, then its redo
    np.testing.assert_allclose(multi, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CAMS))
def test_state_sorted_film_equals_unsorted(scenes, name):
    _, ts = scenes(name)
    config = TracingConfig(width=16, height=12, nee=MIS, **CAMS[name])
    films = {
        loop: render_image(ts, config, RenderSettings(samples=6, multitile_loop=loop),
                           device="cpu")
        for loop in ("unsorted", "state-sorted")
    }
    assert films["state-sorted"].mean() > 0.01
    np.testing.assert_allclose(films["state-sorted"], films["unsorted"], rtol=1e-5, atol=1e-6)


# ---- loop structure -----------------------------------------------------------------

SCANS = ("nearest_grid", "nearest_shadow_grid", "occlude_grid")  # the default form's


@pytest.mark.parametrize("samples, groups", [(12, 3), (10, 3)])
def test_state_sorted_group_structure(scenes, monkeypatch, samples, groups):
    """Fold 4: the pilot (bounces 0-2 of one sample: K9 1, K10 2), then per
    group K9 once, K10 once a later bounce and K11 once: no shadow rays are
    held across groups; each bounce shades once and all but the last sort."""
    _, ts = scenes("VeachMIS")
    calls = {}
    count_calls(monkeypatch, FI, SCANS, calls)
    count_calls(monkeypatch, P, ("_shade", "_sort_perm"), calls)
    monkeypatch.setattr(P, "_FOLD_MAX_LANES_SORTED", 4 * 64)
    config = TracingConfig(width=16, height=4, nee=MIS, **CAMS["VeachMIS"])
    settings = RenderSettings(samples=samples, multitile_loop="state-sorted")
    film = render_image(ts, config, settings, device="cpu")
    assert film.shape == (4, 16, 3) and np.isfinite(film).all()
    nb = config.max_bounces
    assert calls == {
        "nearest_grid": 1 + groups, "nearest_shadow_grid": nb - 2 + groups * (nb - 1),
        "occlude_grid": groups, "_shade": nb - 1 + groups * nb,
        "_sort_perm": nb - 1 + groups * (nb - 1),
    }


def test_pilot_cache_keys(scenes, monkeypatch):
    """One pilot per scene, config, lane count and camera: a second render
    reuses it; a moved camera measures again in the entry's place; another
    pilot function measures into an entry of its own."""
    _, ts = scenes("FurnaceTest")
    pilots = spy(monkeypatch, P, "_pilot_schedule")
    args = port_args("FurnaceTest")
    for _ in range(2):
        P._cached_pilot_schedule(ts, *args, 0, 1024, FI.BT_MULTI, "lists")
    assert len(pilots) == 1
    cfg, cam, *rest = args
    cam.cam_position = cam.cam_position + 0.5
    P._cached_pilot_schedule(ts, cfg, cam, *rest, 0, 1024, FI.BT_MULTI, "lists")
    assert len(pilots) == 2
    again = spy(monkeypatch, P, "_pilot_schedule")  # a new function: a new key
    P._cached_pilot_schedule(ts, cfg, cam, *rest, 0, 1024, FI.BT_MULTI, "lists")
    assert len(again) == 1 and len(P._PILOT_CACHE) == 2


def test_sort_mode_is_an_argument(monkeypatch):
    """The port reads no RUSTIC_SORT_MODE: "state-sorted" and "auto" are
    loop names."""
    monkeypatch.setenv("RUSTIC_SORT_MODE", "rays")
    assert P.multitile_loop("state-sorted") is P._render_batch_sorted
    assert P.multitile_loop("auto") is P._render_batch_auto
    assert not hasattr(P, "STATE_SORT_TODO")


def test_default_scan_form_is_grid(scenes, monkeypatch):
    """The grid form is the default of RenderSettings, of MULTITILE_SCANS
    and so of every signature that defaults to it: a render that names no
    form runs K9-K11 and no tile lists."""
    from rustic_tpu_torch.ops.intersect import MULTITILE_SCANS

    assert RenderSettings().multitile_scan == MULTITILE_SCANS[0] == "grid"
    assert set(MULTITILE_SCANS) == {"grid", "lists", "resident"}
    _, ts = scenes("VeachMIS")
    calls = {}
    count_calls(monkeypatch, FI, ("block_tile_lists", "nearest_multi", "nearest_grid",
                                  "nearest_shadow_grid", "occlude_grid"), calls)
    config = TracingConfig(width=8, height=4, nee=MIS, **CAMS["VeachMIS"])
    x, y = pixels(8, 4)
    film = render_pixels(ts, config, x, y, 2)
    assert torch.isfinite(film).all()
    nb = config.max_bounces  # one group of 2 folded samples
    assert calls == {"block_tile_lists": 0, "nearest_multi": 0, "nearest_grid": 1,
                     "nearest_shadow_grid": nb - 1, "occlude_grid": 1}
