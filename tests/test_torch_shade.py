"""The port's plain shade stage against the JAX Pallas shade kernel
(rustic_tpu.ops.shade_kernel.shade_bounce, interpret mode) on identical
inputs.

The inputs are real lanes: pixels, per-pixel offsets and the sample
index drawn from numpy.random.default_rng(seed), traced to the bounce
under test by the port's plain stages. Tolerance rtol 1e-4, atol 1e-5,
the kernel-shade gate of tests/test_shade_kernel.py; the glass scene
2e-3 / 2e-4 as there (its microfacet sample and the sky march
reassociate float operations between the two compilers)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rustic_tpu.config import NextEventEstimation as JaxNee
from rustic_tpu.config import StaticConfig as JaxStaticConfig
from rustic_tpu.ops import shade_kernel as JSK
from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.ops import shade_kernel as SK
from rustic_tpu_torch.runtime.pipeline import initk
from rustic_tpu_torch.scene.world import scene_from_arrays

torch.set_num_threads(2)

B = 512  # the JAX kernel's lane blocks need a multiple of 128
W_, H_ = 64, 36


def scene_fields(scene) -> dict:
    out = {
        k: np.asarray(getattr(scene, k))
        for k in ("tri_feats16", "tri_attrs", "entry_rows", "tile_aabbs")
    }
    for k in ("n_tris", "n_alias_entries", "has_lights", "has_glass", "has_textures"):
        out[k] = getattr(scene, k)
    return out


def glass_sky_scene(tmp_path):
    """The glass panel over a floor, lamp above, open sides of
    tests/test_shade_kernel.py:test_kernelshade_glass_and_sky."""
    from rustic_tpu.scene.glb_write import MaterialSpec, MeshSpec, write_glb
    from rustic_tpu.scene.world import World

    quad = np.array([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]], np.float32)
    glass = quad * 0.3 + np.array([0, 1.0, 0], np.float32)
    lamp = quad * 0.15 + np.array([1.5, 2.0, 0], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    path = str(tmp_path / "glass_sky.glb")
    write_glb(
        path,
        meshes=[
            MeshSpec(positions=quad, indices=tris, material=0),
            MeshSpec(positions=glass, indices=tris, material=1),
            MeshSpec(positions=lamp, indices=tris[:, ::-1], material=2),
        ],
        materials=[
            MaterialSpec(base_color=(0.6, 0.55, 0.5, 1.0), roughness=0.7),
            MaterialSpec(
                base_color=(1.0, 1.0, 1.0, 1.0), roughness=0.05, transmission=1.0, ior=1.5
            ),
            MaterialSpec(base_color=(0.0, 0.0, 0.0, 1.0), emissive=(4.0, 3.5, 3.0)),
        ],
    )
    return World.from_path(path).to_device()


def trace_to(scene, config, bounce: int, seed: int):
    """Port plain stages up to the shade input of `bounce` -> numpy dict."""
    rng = np.random.default_rng(seed)
    cfg = config.static_part()
    px = torch.from_numpy(rng.integers(0, config.width, B).astype(np.int32))
    py = torch.from_numpy(rng.integers(0, config.height, B).astype(np.int32))
    off = torch.from_numpy(rng.integers(0, 2**32, B, dtype=np.uint32).view(np.int32))
    sample = int(rng.integers(0, 1 << 20))
    st, feats, sidx, params = initk(cfg, config.dynamic_part("cpu"), px, py, sample, off, 1)
    n_alias = scene.n_alias_entries if cfg.nee.uses_nee and scene.has_lights else 0
    pending = None
    for b in range(bounce + 1):
        if pending is None:
            t, i, attrs = FI.nearest_attrs(feats, scene.tri_feats16, scene.tri_attrs)
            occ = None
        else:
            t, i, occ, attrs = FI.nearest_shadow_attrs(
                feats, pending, scene.tri_feats16, scene.tri_attrs
            )
        inputs = dict(
            params=params, entry_rows=scene.entry_rows, st=st, feats_t=feats, t=t,
            idx=i, attrs_t=attrs, occ=occ, sidx=sidx, offsets=off,
        )
        if b == bounce:
            return inputs, n_alias
        st, feats, pending = SK.shade_bounce(
            cfg, b, params, scene.entry_rows, st, feats, t, i, attrs, occ, sidx, off,
            has_glass=scene.has_glass, n_alias=n_alias,
        )


def compare(js, ts, config, bounce, seed, rtol, atol):
    cfg = config.static_part()
    inputs, n_alias = trace_to(ts, config, bounce, seed)
    outs_p = SK.shade_bounce_plain(
        cfg, bounce, **inputs, has_glass=ts.has_glass, n_alias=n_alias
    )
    j = {k: (None if v is None else jnp.asarray(v.numpy())) for k, v in inputs.items()}
    for k in ("sidx", "offsets"):
        j[k] = jnp.asarray(inputs[k].numpy().view(np.uint32))
    jcfg = JaxStaticConfig(
        width=cfg.width, height=cfg.height, min_bounces=cfg.min_bounces,
        max_bounces=cfg.max_bounces, nee=JaxNee(int(cfg.nee)), has_skybox=False,
    )
    outs_j = JSK.shade_bounce(
        jcfg, bounce, j["params"], j["entry_rows"], j["st"], j["feats_t"], j["t"],
        j["idx"], j["attrs_t"], j["occ"], j["sidx"], j["offsets"],
        has_glass=js.has_glass, n_alias=n_alias, interpret=True,
    )
    # Shadow rays are compared on the lanes whose NEE candidate is
    # eligible, the only lanes whose shadow result is used: elsewhere the
    # origin may be a miss point ~1e6 away, and ro×rd there is rounding
    # noise of that magnitude (XLA fuses a*b - c*d into an FMA).
    eligible = outs_p[0][SK.SK_PEND_ELIG].numpy() > 0.5
    np.testing.assert_array_equal(eligible, np.asarray(outs_j[0][SK.SK_PEND_ELIG]) > 0.5)
    lanes = (slice(None), slice(None), eligible)
    names = ("state", "next rays", "shadow rays")
    for name, p, q, sel in zip(names, outs_p, outs_j, lanes):
        assert (p is None) == (q is None), name
        if p is not None:
            np.testing.assert_allclose(
                p.numpy()[:, sel], np.asarray(q)[:, sel], rtol=rtol, atol=atol, err_msg=name
            )
    return outs_p


@pytest.fixture(scope="module")
def cornell(cornell_scene):
    return cornell_scene, scene_from_arrays(scene_fields(cornell_scene), "cpu")


MIS, NONE, DIRECT = NextEventEstimation.MIS, NextEventEstimation.NONE, NextEventEstimation.DIRECT


# every mode at the first or a middle bounce and at the last (sky) bounce
@pytest.mark.parametrize(
    "nee, bounce", [(MIS, 0), (MIS, 1), (MIS, 3), (NONE, 0), (NONE, 3), (DIRECT, 1), (DIRECT, 3)]
)
def test_shade_matches_jax(cornell, nee, bounce):
    js, ts = cornell
    config = TracingConfig(width=W_, height=H_, nee=nee)
    st, nf, sf = compare(js, ts, config, bounce, seed=10 + bounce, rtol=1e-4, atol=1e-5)
    assert (nf is None) == (bounce == 3)
    assert (sf is None) == (nee == NextEventEstimation.NONE)
    assert bool(torch.isfinite(st).all())


@pytest.mark.parametrize("bounce", [2])
def test_shade_roulette_matches_jax(cornell, bounce):
    """min_bounces=1: roulette runs from bounce 2 on."""
    js, ts = cornell
    config = TracingConfig(width=W_, height=H_, nee=NextEventEstimation.MIS, min_bounces=1)
    inputs, _ = trace_to(ts, config, bounce, seed=30 + bounce)
    st, _, _ = compare(js, ts, config, bounce, seed=30 + bounce, rtol=1e-4, atol=1e-5)
    alive_in = inputs["st"][SK.SK_ALIVE] > 0.5
    # some lanes that were alive were killed by the roulette or left the scene
    assert bool((alive_in & (st[SK.SK_ALIVE] < 0.5)).any())


@pytest.mark.parametrize("bounce", [0, 3])
def test_shade_glass_and_sky_matches_jax(tmp_path, bounce):
    js = glass_sky_scene(tmp_path)
    ts = scene_from_arrays(scene_fields(js), "cpu")
    assert ts.has_glass
    config = TracingConfig(
        width=W_, height=H_, nee=NextEventEstimation.MIS,
        cam_position=(0.0, 1.5, -6.0), cam_rotation=(0.15, 0.0),
    )
    st, _, _ = compare(js, ts, config, bounce, seed=40 + bounce, rtol=2e-3, atol=2e-4)
    if bounce == 3:
        missed = st[SK.SK_MISSED] > 0.5
        assert bool(missed.any())  # the sky is reached
        assert float(st[SK.SK_RAD][:, missed].sum()) > 0.0


def test_alias_table_over_16_is_refused(cornell):
    _, ts = cornell
    config = TracingConfig(width=W_, height=H_, nee=NextEventEstimation.MIS)
    inputs, _ = trace_to(ts, config, 0, seed=1)
    with pytest.raises(NotImplementedError, match="alias"):
        SK.shade_bounce(config.static_part(), 0, **inputs, n_alias=17)
