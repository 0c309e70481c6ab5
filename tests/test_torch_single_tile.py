"""One-tile scenes that the single-tile kernel-shade loop does not take
(textured, or an alias table over 16 entries), the torch-shade loop named
for one it does take, and the single-program integrator, each against the
JAX package.

Scenes: the one-tile cuts of BreakTime (textured, HDR sky, 256-texel
atlas) and VeachMIS (460 alias entries) of rustic_tpu_torch/scene/cuts.py
and DarkCornell; one JAX scene feeds both packages (scene_from_arrays),
with the same pixel offsets, at 32x16 pixels x 3 spp.

The JAX film comes from `render_batch_staged`, which sends such scenes to
its XLA-shade `_stages` loop at one tile: with the scene's bf16 attr
split its scans are the attr kernels, and with
`scene.replace(tri_attrs_split=None)` they are `_nearest_single` /
`_nearest_shadow_single`, the kernels K12/K13 replace (spied).

Tolerances: rtol 1e-4, atol 1e-5 (XLA contracts FMAs, torch does not);
the textured film on at least 98% of its pixels, every pixel within rtol
2e-2 / atol 1e-4 and the mean within 1e-5, the gate of
tests/test_torch_breaktime.py (a normal-mapped glossy bounce turns an ulp
into another path). The integrator's engines among themselves: 1e-4."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rustic_tpu.ops import intersect as JI
from rustic_tpu.ops import trace as JT
from rustic_tpu.runtime import pipeline as JP
from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.ops import intersect as I
from rustic_tpu_torch.ops import shade_kernel as SK
from rustic_tpu_torch.ops import trace as T
from rustic_tpu_torch.runtime import pipeline as P
from rustic_tpu_torch.runtime.render import pixel_offsets, render_image, render_pixels
from rustic_tpu_torch.scene.world import scene_from_arrays
from tests.test_torch_breaktime import assert_film_close
from tests.test_torch_flash_grid import scene_fields
from tests.test_torch_flash_single import ONE_TILE, jax_one_tile, spy_pallas_kernels
from tests.test_torch_render_multitile import count_calls
from tests.test_torch_sorted import spy

torch.set_num_threads(2)

FILM_W, FILM_H, SPP = 32, 16, 3
MIS = NextEventEstimation.MIS


@pytest.fixture(scope="module")
def scenes():
    cache = {}

    def get(name):
        if name not in cache:
            js = jax_one_tile(name)
            cache[name] = (js, scene_from_arrays(scene_fields(js), "cpu"))
        return cache[name]

    return get


def pixels():
    y, x = np.mgrid[0:FILM_H, 0:FILM_W]
    return x.reshape(-1).astype(np.int32), y.reshape(-1).astype(np.int32)


def jax_config(name):
    from rustic_tpu.config import TracingConfig as JaxTracingConfig

    return JaxTracingConfig(width=FILM_W, height=FILM_H, nee=MIS, **ONE_TILE[name]["cam"])


def port_config(name):
    return TracingConfig(width=FILM_W, height=FILM_H, nee=MIS, **ONE_TILE[name]["cam"])


def jax_staged_film(js, name):
    config = jax_config(name)
    x, y = pixels()
    return np.asarray(JP.render_batch_staged(
        js, config.static_part(), config.dynamic_part(), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(pixel_offsets(FILM_W, FILM_H)), 0, SPP,
    ))


def port_film(ts, name, engine=None, **kw):
    """The staged pipeline's film (engine None), or the integrator's."""
    x, y = pixels()
    return render_pixels(ts, port_config(name), x, y, SPP, offsets=pixel_offsets(FILM_W, FILM_H),
                         engine=engine, **kw).numpy()


def assert_close(name, got, want):
    if name == "breaktime1":
        assert_film_close(got, want)
    else:
        assert got.shape == want.shape == (FILM_W * FILM_H, 3)
        assert np.isfinite(got).all() and got.mean() > 0.05
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["breaktime1", "veach1"])
@pytest.mark.parametrize("split", ["split", "no-split"])
def test_one_tile_film_matches_jax(scenes, monkeypatch, name, split):
    """The scenes the port used to refuse render through the torch-shade
    loop (K12, K13, K3) to the JAX film; without the attr split the JAX
    side runs the kernels K12/K13 replace."""
    js, ts = scenes(name)
    assert not SK.supported(ts)
    jax_ks = spy(monkeypatch, JP, "_render_batch_kernelshade")
    single = spy_pallas_kernels(monkeypatch, "_nearest_single", "_nearest_shadow_single",
                                "_nearest_single_attrs", "_nearest_shadow_single_attrs")
    if split == "no-split":
        js = js.replace(tri_attrs_split=None)
    else:
        assert js.tri_attrs_split is not None
    want = jax_staged_film(js, name)
    assert not jax_ks
    rows56 = bool(single["_nearest_single"]) and bool(single["_nearest_shadow_single"])
    attr_kernels = bool(single["_nearest_single_attrs"]) and bool(
        single["_nearest_shadow_single_attrs"])
    assert (rows56, attr_kernels) == ((True, False) if split == "no-split" else (False, True))

    port_ks = spy(monkeypatch, P, "_render_batch_kernelshade")
    calls = {}
    count_calls(monkeypatch, FI, ("nearest", "nearest_shadow", "occlude", "nearest_attrs",
                                  "nearest_shadow_attrs"), calls)
    count_calls(monkeypatch, SK, ("shade_bounce", "shade_bounce_wide"), calls)
    got = port_film(ts, name)
    assert not port_ks
    nb = 4  # max_bounces; one group of 3 folded samples
    assert calls == dict.fromkeys(calls, 0) | {"nearest": 1, "nearest_shadow": nb - 1,
                                               "occlude": 1}
    assert_close(name, got, want)


def test_torch_shade_loop_on_darkcornell(scenes, monkeypatch):
    """The caller can name the torch-shade loop for a scene the
    kernel-shade loop takes: the JAX film under RUSTIC_SHADE_KERNEL=0, and
    the port's own kernel-shade film."""
    js, ts = scenes("cornell")
    assert SK.supported(ts)
    monkeypatch.setenv("RUSTIC_SHADE_KERNEL", "0")
    jax_ks = spy(monkeypatch, JP, "_render_batch_kernelshade")
    want = jax_staged_film(js, "cornell")
    assert not jax_ks
    kernel_shade = port_film(ts, "cornell")
    port_ks = spy(monkeypatch, P, "_render_batch_kernelshade")
    torch_shade = port_film(ts, "cornell", single_loop="torch-shade")
    assert not port_ks
    assert np.isfinite(torch_shade).all() and torch_shade.mean() > 0.01
    np.testing.assert_allclose(torch_shade, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(torch_shade, kernel_shade, rtol=1e-4, atol=1e-5)
    assert port_film(ts, "cornell").tolist() == kernel_shade.tolist() and port_ks == [1]
    with pytest.raises(ValueError, match="single-tile loop"):
        port_film(ts, "cornell", single_loop="xla")


def test_held_group_rides_the_next_scan(scenes, monkeypatch):
    """Three groups of 4: K12 once a chunk, K13 on every later scan (the
    held group's shadow rays ride the next group's bounce 0), K3 once."""
    _, ts = scenes("veach1")
    calls = {}
    count_calls(monkeypatch, FI, ("nearest", "nearest_shadow", "occlude"), calls)
    monkeypatch.setattr(P, "_FOLD_MAX_LANES", 4 * 64)
    config = TracingConfig(width=16, height=4, nee=MIS, **ONE_TILE["veach1"]["cam"])
    film = render_image(ts, config, RenderSettings(samples=12), device="cpu")
    assert np.isfinite(film).all()
    assert calls == {"nearest": 1, "nearest_shadow": 3 * config.max_bounces - 1, "occlude": 1}


@pytest.mark.parametrize("name", ["cornell", "veach1"])
def test_accumulate_samples_matches_jax(scenes, name):
    """The single-program integrator with the brute and the flash engine
    against the JAX functions (flash: Pallas interpret mode), and the two
    engines against each other."""
    js, ts = scenes(name)
    jcfg, cfg = jax_config(name), port_config(name)
    x, y = pixels()
    off = pixel_offsets(FILM_W, FILM_H)
    args_j = (js, jcfg.static_part(), jcfg.dynamic_part(), jnp.asarray(x), jnp.asarray(y),
              jnp.asarray(off), jnp.uint32(5), 2)
    off_t = torch.from_numpy(off.view(np.int32).copy())
    args_p = (ts, cfg.static_part(), cfg.dynamic_part("cpu"), torch.from_numpy(x),
              torch.from_numpy(y), off_t, 5, 2)
    films = {}
    for engine in ("brute", "flash"):
        want = np.asarray(JT.accumulate_samples(*args_j, engine=engine))
        got = T.accumulate_samples(*args_p, engine=engine).numpy()
        assert got.shape == (FILM_W * FILM_H, 3) and got.mean() > 0.01
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        films[engine] = got
    np.testing.assert_allclose(films["flash"], films["brute"], rtol=1e-4, atol=1e-4)
    # one sample of the fold, added to a film passed in
    one = T.trace_paths(*args_p[:5], 6, off_t, engine="brute")
    first = T.accumulate_samples(*args_p[:6], 5, 1, engine="brute")
    np.testing.assert_array_equal(
        T.accumulate_samples(*args_p[:6], 6, 1, engine="brute", film_in=first).numpy(),
        (first + one).numpy())
    np.testing.assert_allclose((first + one).numpy(), films["brute"], rtol=1e-6, atol=1e-7)


def test_trace_paths_matches_jax_on_a_textured_scene(scenes):
    js, ts = scenes("breaktime1")
    jcfg, cfg = jax_config("breaktime1"), port_config("breaktime1")
    x, y = pixels()
    off = pixel_offsets(FILM_W, FILM_H)
    want = np.asarray(JT.trace_paths(
        js, jcfg.static_part(), jcfg.dynamic_part(), jnp.asarray(x), jnp.asarray(y),
        jnp.uint32(1), jnp.asarray(off), engine="brute"))
    got = T.trace_paths(ts, cfg.static_part(), cfg.dynamic_part("cpu"), torch.from_numpy(x),
                        torch.from_numpy(y), 1, torch.from_numpy(off.view(np.int32).copy()),
                        engine="brute").numpy()
    # one sample a pixel: a path that an ulp turns elsewhere moves its pixel
    # by more than the averaged films' bound, so only the share is held
    assert np.isfinite(got).all() and got.mean() > 0.05
    tight = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=1)
    assert tight.mean() >= 0.98, f"{int((~tight).sum())} pixels outside rtol 1e-4 / atol 1e-5"
    assert abs(got.mean() / want.mean() - 1.0) < 1e-4


def test_staged_render_equals_the_integrator(scenes):
    """`render_pixels` with an engine named goes through
    `accumulate_samples` on the CPU; the staged film agrees with the brute
    oracle, and with the flash engine exactly (the same scans and stages)."""
    _, ts = scenes("veach1")
    staged = port_film(ts, "veach1")
    np.testing.assert_array_equal(port_film(ts, "veach1", engine="flash"), staged)
    np.testing.assert_allclose(port_film(ts, "veach1", engine="brute"), staged, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["cornell", "veach1", "breaktime1"])
def test_brute_matches_jax(scenes, name):
    """`intersect_brute` / `occlude_brute` on random rays: the port derives
    its triangle features from the vertices in the shading rows."""
    js, ts = scenes(name)
    tf = I.scene_tri_feats(ts)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(js.tri_feats)[:, : ts.n_tris])
    rng = np.random.default_rng(11)
    aabb = ts.tile_aabbs.numpy()[0]
    n = 1500
    ro = rng.uniform(aabb[0:3], aabb[4:7], (n, 3)).astype(np.float32)
    rd = rng.normal(0, 1, (n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    maxt = rng.uniform(0.1, 6.0, n).astype(np.float32)
    want = JI.intersect_brute(js.tri_feats, jnp.asarray(ro), jnp.asarray(rd))
    got = I.intersect_brute(tf, torch.from_numpy(ro), torch.from_numpy(rd))
    assert 0.3 < float(got.hit.float().mean()) <= 1.0
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_array_equal(got.tri_idx.numpy(), np.asarray(want.tri_idx))
    np.testing.assert_array_equal(got.backface.numpy(), np.asarray(want.backface))
    # the two matrix products sum t = (ro.n - a.n) / det in another order, and it cancels
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-4)
    hit = got.hit.numpy()
    for a, b in ((got.u, want.u), (got.v, want.v)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], rtol=1e-4, atol=1e-5)
    occ_j = JI.occlude_brute(js.tri_feats, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(maxt))
    occ = I.occlude_brute(tf, torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(maxt))
    assert occ.dtype == torch.bool and 0.02 < float(occ.float().mean()) < 0.98
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_j))
    # the flash engine finds the same hits (exact re-test of the scan's winner)
    flash = I.intersect_nearest(ts, torch.from_numpy(ro), torch.from_numpy(rd), engine="flash")
    assert float((flash.tri_idx == got.tri_idx)[got.hit].float().mean()) > 0.999
    assert torch.equal(I.intersect_any(ts, torch.from_numpy(ro), torch.from_numpy(rd),
                                       torch.from_numpy(maxt), engine="flash"), occ)


def test_brute_chunks_agree_with_one_pass(scenes, monkeypatch):
    _, ts = scenes("veach1")
    tf = I.scene_tri_feats(ts)
    rng = np.random.default_rng(12)
    ro = torch.from_numpy(rng.normal(0, 2, (300, 3)).astype(np.float32))
    rd = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(0, 1, (300, 3)).astype(np.float32)), dim=1)
    maxt = torch.full((300,), 5.0)
    whole = (*I.intersect_brute(tf, ro, rd), I.occlude_brute(tf, ro, rd, maxt))
    monkeypatch.setattr(I, "_CHUNK_BUDGET", 4 * 512 * 37)  # 37-ray chunks
    for a, b in zip(whole, (*I.intersect_brute(tf, ro, rd), I.occlude_brute(tf, ro, rd, maxt))):
        assert torch.equal(a, b)


def test_pick_engine(scenes):
    _, ts = scenes("cornell")
    assert I._pick_engine(ts, "flash") == "flash" and I._pick_engine(ts, "brute") == "brute"
    assert I._pick_engine(ts, "bvh") == "bvh"
    assert I._pick_engine(ts, "auto") == "bvh"  # 184 triangles on the CPU, as the JAX package
    with pytest.raises(ValueError, match="expected one of"):
        I._pick_engine(ts, "embree")
    import dataclasses

    small = dataclasses.replace(ts, n_tris=I.BRUTE_FORCE_MAX_TRIS)
    assert I._pick_engine(small, "auto") == "brute"
    import types

    on_card = types.SimpleNamespace(device=torch.device("cuda", 0), n_tris=10**6)
    assert I._pick_engine(on_card, "auto") == "flash"
