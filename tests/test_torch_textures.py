"""The port's textured scene side (PNG decoder, Lanczos atlas twin,
textured World, sky images) and textured shading ops (sample_atlas,
image_sky, the textured material, the textured winner-row resolve and
bounce_pre) against Pillow and the JAX package.

Tolerances:
- images, atlas, shading rows, uvst rects: exact. The Lanczos twin
  equals Pillow's LANCZOS resize bit for bit at BreakTime's cell sizes
  (256 -> 1024 and 2048) and at the 256-texel test atlas's (128, 64);
- shading ops against the jitted JAX functions: rtol 1e-4, atol 1e-5,
  the FMA tolerance of tests/test_torch_trace.py (XLA on the CPU
  contracts a*b + c into FMAs, and its atan2 and asin are its own
  approximations, so a uv may differ by an ulp). A texel lookup turns
  that ulp into a bilinear weight error of ulp x the texture's size,
  which the normal map's steep texel steps carry into the mapped normal:
  the resolved rows are held to atol 1e-4 there;
- the same ops against eager JAX (`jax.disable_jit`, one operation at a
  time, so no contraction): sample_atlas exactly, the textured material
  and the resolved rows to rtol 1e-5, atol 1e-6.

Both Worlds are built by default (the native BVH order), as in
tests/test_torch_scene.py, with a 256-texel atlas."""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rustic_tpu.config import NextEventEstimation as JNEE
from rustic_tpu.config import TracingConfig as JTracingConfig
from rustic_tpu.ops import bsdf as JB
from rustic_tpu.ops import intersect as JI
from rustic_tpu.ops import nee as JN
from rustic_tpu.ops import resolve as JR
from rustic_tpu.ops import skybox as JS
from rustic_tpu.ops import texture as JT
from rustic_tpu.ops import trace as JTR
from rustic_tpu.scene import atlas as JA
from rustic_tpu.scene import gltf as JG
from rustic_tpu.scene import world as JW
from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
from rustic_tpu_torch.ops import bsdf as B_
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.ops import intersect as I_
from rustic_tpu_torch.ops import nee as N_
from rustic_tpu_torch.ops import resolve as R_
from rustic_tpu_torch.ops import skybox as S_
from rustic_tpu_torch.ops import texture as T_
from rustic_tpu_torch.ops import trace as TR_
from rustic_tpu_torch.runtime.pipeline import stage_init
from rustic_tpu_torch.scene import atlas as TA
from rustic_tpu_torch.scene import world as TW
from rustic_tpu_torch.utils import png
from tests.conftest import scene_path
from tests.test_torch_bvh_native import require_jax_native

torch.set_num_threads(2)

ATLAS = 256
BREAKTIME = scene_path("BreakTime.glb")
SKY = scene_path("BreakTimeSky.npy")
CAM = dict(cam_position=(0.0, 1.8, -3.2), has_skybox=True)
B = 2048


def close(got, want, what="", rtol=1e-4, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def breaktime_images():
    gltf, buffers, base = JG._load_gltf_json(BREAKTIME)
    out = []
    for im in gltf["images"]:
        bv = gltf["bufferViews"][im["bufferView"]]
        start = bv.get("byteOffset", 0)
        out.append(buffers[bv["buffer"]][start : start + bv["byteLength"]])
    return out


@pytest.fixture(scope="module")
def worlds():
    """(JAX World, JAX scene, port World, port scene): BreakTime with a
    256-texel atlas and its HDR sky."""
    require_jax_native()
    jworld = JW.World(JG.load_glb(BREAKTIME), ATLAS)
    jscene = jworld.to_device(JW.load_skybox_image(SKY))
    tworld = TW.World.from_path(BREAKTIME, ATLAS)
    return jworld, jscene, tworld, tworld.to_torch("cpu", TW.load_skybox_image(SKY))


# ---- images and the atlas ----------------------------------------------------


@pytest.mark.parametrize("i", range(6))
def test_png_decoder_matches_pillow(i):
    from PIL import Image

    raw = breaktime_images()[i]
    want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))
    got = png.decode_png(raw)
    assert got.dtype == np.uint8 and got.shape == (256, 256, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.decode_image_rgba(raw), want.astype(np.float32) / 255.0)


def test_png_decoder_refuses_other_formats():
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"\xff\xd8\xff\xe0" + bytes(16))  # a JPEG header
    with pytest.raises(NotImplementedError, match="DDS.*ROADMAP"):
        # a DDS header of size 0, which Pillow refuses too
        png.decode_image_rgba(b"DDS " + bytes(124))


def texture_kinds():
    """BreakTime's map kinds as the loader makes them: an albedo map
    (linearised, alpha 1), a normal map, the metallic and roughness maps
    (one channel replicated, alpha included, which Pillow premultiplies)."""
    imgs = [png.decode_image_rgba(r) for r in breaktime_images()]
    albedo = imgs[0].copy()
    albedo[..., :3] = albedo[..., :3] ** 2.2
    return {
        "albedo": albedo,
        "normal": imgs[1],
        "metallic": np.repeat(imgs[4][..., 2:3], 4, axis=-1),
        "roughness": np.repeat(imgs[4][..., 1:2], 4, axis=-1),
    }


@pytest.mark.parametrize("size", [2048, 1024, 128, 64])
@pytest.mark.parametrize("kind", ["albedo", "normal", "metallic", "roughness"])
def test_resize_lanczos_matches_pillow(size, kind):
    tex = texture_kinds()[kind]
    got = TA._resize_lanczos(tex, size, size)
    want = JA._resize_lanczos(tex, size, size)
    assert got.dtype == np.float32 and got.shape == (size, size, 4)
    np.testing.assert_array_equal(got, want)


def test_resize_lanczos_matches_pillow_on_random_rgba():
    tex = np.random.default_rng(0).uniform(0, 1, (37, 53, 4)).astype(np.float32)
    for w, h in ((100, 300), (20, 11), (53, 90)):
        np.testing.assert_array_equal(TA._resize_lanczos(tex, w, h), JA._resize_lanczos(tex, w, h))


def test_breaktime_world_matches_jax(worlds):
    jworld, jscene, tworld, ts = worlds
    np.testing.assert_array_equal(tworld.triangles, jworld.triangles)
    for k in ("mat_has_tex", "mat_albedo", "mat_roughness", "mat_metallic", "mat_normals"):
        np.testing.assert_array_equal(getattr(tworld, k), getattr(jworld, k), err_msg=k)
    assert int(tworld.mat_has_tex.any(axis=1).sum()) == 4  # four textured materials
    np.testing.assert_array_equal(tworld.atlas, jworld.atlas)
    np.testing.assert_array_equal(tworld.uv0, jworld.uv0)
    np.testing.assert_array_equal(tworld.tangents, jworld.tangents)
    assert ts.has_textures and jscene.has_textures
    assert ts.tri_attrs.shape[1] == TW.ATTR_WIDTH
    for k in ("tri_feats16", "tri_attrs", "entry_rows", "tile_aabbs", "atlas", "skybox"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(jscene, k)), err_msg=k)
    for k in ("n_tris", "n_alias_entries", "has_lights", "has_glass", "has_textures"):
        assert getattr(ts, k) == getattr(jscene, k), k
    assert ts.atlas.shape == (ATLAS, ATLAS, TA.ATLAS_CHANNELS)


def test_scene_from_arrays_keeps_textured_rows(worlds):
    _, jscene, _, ts = worlds
    fields = {k: np.asarray(getattr(jscene, k))
              for k in ("tri_feats16", "tri_attrs", "entry_rows", "tile_aabbs", "atlas", "skybox")}
    for k in ("n_tris", "n_alias_entries", "has_lights", "has_glass", "has_textures"):
        fields[k] = getattr(jscene, k)
    got = TW.scene_from_arrays(fields, "cpu")
    for k in ("tri_feats16", "tri_attrs", "entry_rows", "tile_aabbs", "atlas", "skybox"):
        assert torch.equal(getattr(got, k), getattr(ts, k)), k
    # without an image the sky is the magenta fallback, as in the JAX package
    del fields["skybox"]
    np.testing.assert_array_equal(TW.scene_from_arrays(fields, "cpu").skybox.numpy(),
                                  JW._fallback_skybox())


def test_skybox_images_match_jax(tmp_path):
    from PIL import Image

    from rustic_tpu.utils.hdr import write_hdr

    np.testing.assert_array_equal(TW.load_skybox_image(SKY), JW.load_skybox_image(SKY))
    rgb = np.random.default_rng(1).uniform(0, 40, (9, 17, 3)).astype(np.float32)
    write_hdr(str(tmp_path / "sky.hdr"), rgb)
    np.testing.assert_array_equal(TW.load_skybox_image(str(tmp_path / "sky.hdr")),
                                  JW.load_skybox_image(str(tmp_path / "sky.hdr")))
    ldr = np.random.default_rng(2).integers(0, 256, (7, 13, 3), dtype=np.uint8)
    Image.fromarray(ldr, "RGB").save(tmp_path / "sky.png")
    np.testing.assert_array_equal(TW.load_skybox_image(str(tmp_path / "sky.png")),
                                  JW.load_skybox_image(str(tmp_path / "sky.png")))
    from tests.test_torch_image_formats import write_exr

    piz = write_exr({c: np.ones((2, 2), np.float16) for c in "RGB"}, compression_code=4)
    (tmp_path / "sky.exr").write_bytes(piz)
    with pytest.raises(NotImplementedError, match="PIZ.*ROADMAP"):
        TW.load_skybox_image(str(tmp_path / "sky.exr"))


# ---- shading ops ----------------------------------------------------------------


def rects_and_uvs(jworld, rng, n):
    """Every textured material's rect and the untextured colour slots
    (whose fetch the has-texture selects discard), with uvs in [0, 1]."""
    slots = np.concatenate([jworld.mat_albedo, jworld.mat_metallic, jworld.mat_normals])
    uvst = slots[rng.integers(0, len(slots), n)].astype(np.float32)
    uv = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    uv[:16] = [[0, 0], [1, 1], [0, 1], [1, 0]] * 4  # the cell edges
    return uvst, uv


def test_sample_atlas_matches_jax(worlds):
    jworld, _, _, ts = worlds
    uvst, uv = rects_and_uvs(jworld, np.random.default_rng(3), B)
    got = T_.sample_atlas(ts.atlas, torch.from_numpy(uvst), torch.from_numpy(uv))
    eager = JT.sample_atlas(jnp.asarray(jworld.atlas), jnp.asarray(uvst), jnp.asarray(uv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(eager))
    jit = jax.jit(JT.sample_atlas)(jnp.asarray(jworld.atlas), jnp.asarray(uvst), jnp.asarray(uv))
    close(got, jit, "sample_atlas")


@pytest.mark.parametrize("wrap", [False, True])
def test_sample_bilinear_matches_jax(wrap):
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 5, (13, 24, 4)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (B, 2)).astype(np.float32)
    got = T_.sample_bilinear(torch.from_numpy(img), torch.from_numpy(uv), wrap_x=wrap)
    want = jax.jit(lambda i, u: JT.sample_bilinear(i, u, wrap_x=wrap))(jnp.asarray(img), jnp.asarray(uv))
    close(got, want, "sample_bilinear")


def test_image_sky_matches_jax(worlds):
    _, jscene, _, ts = worlds
    rng = np.random.default_rng(5)
    rd = rng.normal(0, 1, (B, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    sun = np.array(TracingConfig().sun_direction, np.float32)
    want = jax.jit(JS.image_sky)(jscene.skybox, jnp.asarray(sun), jnp.asarray(rd))
    got = S_.image_sky(ts.skybox, torch.from_numpy(sun), torch.from_numpy(rd))
    assert float(got.max()) > 1.0  # the HDR range
    close(got, want, "image_sky")
    close(S_.sky_radiance(ts, True, torch.from_numpy(sun), None, torch.from_numpy(rd)), want)


def material_inputs(jworld, rng):
    """Full shading rows of random BreakTime triangles, half of them of
    untextured materials, and uvs."""
    n = len(jworld.triangles)
    textured = jworld.tri_attrs[:n, TW.ATTR_HASTEX].any(axis=1)
    pick = np.where(np.arange(B) % 2 == 0,
                    rng.choice(np.flatnonzero(textured), B), rng.choice(np.flatnonzero(~textured), B))
    attrs = jworld.tri_attrs[pick]
    return attrs, rng.uniform(0, 1, (B, 2)).astype(np.float32)


def test_textured_material_matches_jax(worlds):
    jworld, jscene, _, ts = worlds
    attrs, uv = material_inputs(jworld, np.random.default_rng(6))
    clamp = np.array([0.1, 0.9], np.float32)
    want = jax.jit(lambda a, u, c: JB.material_from_attrs(jscene, a, u, c))(
        jnp.asarray(attrs), jnp.asarray(uv), jnp.asarray(clamp))
    got = B_.material_from_attrs(ts, torch.from_numpy(attrs), torch.from_numpy(uv),
                                 torch.from_numpy(clamp))
    textured = attrs[:, TW.ATTR_HASTEX].any(axis=1)
    assert 0.1 < textured.mean() < 0.95
    with jax.disable_jit():
        eager = JB.material_from_attrs(jscene, jnp.asarray(attrs), jnp.asarray(uv),
                                       jnp.asarray(clamp))
    for name in ("albedo", "roughness", "metallic"):
        close(getattr(got, name), getattr(want, name), name)
        close(getattr(got, name), getattr(eager, name), name, rtol=1e-5, atol=1e-6)


def centroid_rays(tri_attrs, idx):
    """Rays through each chosen triangle's centroid (tests/test_resolve.py)."""
    a, b, c = tri_attrs[idx, 0:3], tri_attrs[idx, 3:6], tri_attrs[idx, 6:9]
    centroid = (a + b + c) / 3.0
    n = np.cross(b - a, c - a)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    ro = centroid + n * 0.7 + np.array([0.013, 0.021, -0.017])
    rd = centroid - ro
    rd /= np.maximum(np.linalg.norm(rd, axis=-1, keepdims=True), 1e-12)
    return ro.astype(np.float32), rd.astype(np.float32)


@pytest.mark.parametrize("rays", ["centroid", "camera"])
def test_textured_rows_match_jax(worlds, rays):
    jworld, jscene, _, ts = worlds
    rng = np.random.default_rng(7)
    if rays == "centroid":
        idx = rng.integers(0, len(jworld.triangles), B).astype(np.int32)
        ro, rd = centroid_rays(jworld.tri_attrs, idx)
        feats = I_._ray_features16(torch.from_numpy(ro), torch.from_numpy(rd))
    else:
        feats = camera_feats(rng)
        idx = FI.nearest_grid(feats, ts.tri_feats16, ts.tile_aabbs)[1].numpy()
    args = (jscene, jnp.asarray(feats.numpy()), jnp.asarray(idx))
    want = JR.resolve_attrs_rowT(*args)
    with jax.disable_jit():
        eager = JR.resolve_attrs_rowT(*args)
    got = R_.resolve_attrs_rowT(ts, feats, torch.from_numpy(idx))
    assert got.shape == (TW.SLIM_WIDTH, B) and got.is_contiguous()
    textured = jworld.tri_attrs[idx][:, TW.ATTR_HASTEX].any(axis=1)
    assert 0.1 < textured.mean()
    close(got, eager, "resolved rows, eager", rtol=1e-5, atol=1e-6)
    close(got, want, "resolved rows", atol=1e-4)


def camera_feats(rng):
    cfg = TracingConfig(width=64, height=64, **CAM)
    px = torch.from_numpy(rng.integers(0, 64, B).astype(np.int32))
    py = torch.from_numpy(rng.integers(0, 64, B).astype(np.int32))
    off = torch.from_numpy(rng.integers(0, 2**32, B, dtype=np.uint32).view(np.int32))
    return stage_init(cfg.static_part(), cfg.dynamic_part("cpu"), px, py, 0, off, 1)[1]


@pytest.mark.parametrize("bounce", [0, 3])
def test_textured_bounce_pre_matches_jax(worlds, bounce):
    """bounce_pre on BreakTime camera-ray hits (normal mapping, textured
    material) and, on the last bounce, the image sky of the lanes that
    escaped."""
    jworld, jscene, _, ts = worlds
    rng = np.random.default_rng(8 + bounce)
    cfg = TracingConfig(width=64, height=64, nee=NextEventEstimation.MIS, **CAM)
    px = torch.from_numpy(rng.integers(0, 64, B).astype(np.int32))
    py = torch.from_numpy(rng.integers(0, 64, B).astype(np.int32))
    off = torch.from_numpy(rng.integers(0, 2**32, B, dtype=np.uint32).view(np.int32))
    _, feats, sidx = stage_init(cfg.static_part(), cfg.dynamic_part("cpu"), px, py, 0, off, 1)
    t, idx = FI.nearest_grid(feats, ts.tri_feats16, ts.tile_aabbs)
    ro, rd = feats[6:9].T.contiguous(), feats[0:3].T.contiguous()
    res = I_.classify_flash_hit(t, idx, I_.gather_attr_rows(ts, idx), ro, rd)
    first = bounce == 0
    alive = np.ones(B, bool) if first else rng.uniform(0, 1, B) < 0.8
    state = dict(
        ro=ro.numpy(), rd=rd.numpy(),
        throughput=np.ones((B, 3), np.float32) if first
        else rng.uniform(0.1, 1.5, (B, 3)).astype(np.float32),
        radiance=np.zeros((B, 3), np.float32),
        alive=alive,
        missed=np.zeros(B, bool) if first else ~alive,
        last_lobe_diffuse=np.zeros(B, bool) if first else rng.uniform(0, 1, B) < 0.5,
    )
    mis = {k: np.zeros(v.shape, np.float32 if v.dtype == torch.float32 else np.int32)
           for k, v in N_.MISCarry.zeros(B, "cpu")._asdict().items()}
    draws = TR_.bounce_draws(bounce, sidx, off)
    rs = {f: getattr(res, f).numpy() for f in res._fields}
    jcfg = JTracingConfig(width=64, height=64, nee=JNEE.MIS, **CAM)
    as_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    as_t = lambda d: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}  # noqa: E731
    want_st, want_nee = jax.jit(
        lambda st, r, d, a: JTR.bounce_pre(
            jscene, jcfg.static_part(), jcfg.dynamic_part(), bounce, st, r, d, attrs=a)
    )(JTR.TraceState(**as_j(state), mis=JN.MISCarry(**as_j(mis))), JI.TraceResult(**as_j(rs)),
      jnp.asarray(draws.numpy()), JI.gather_attr_rows(jscene, jnp.asarray(idx.numpy())))
    got_st, got_nee = TR_.bounce_pre(
        ts, cfg.static_part(), cfg.dynamic_part("cpu"), bounce,
        TR_.TraceState(**as_t(state), mis=N_.MISCarry(**as_t(mis))), I_.TraceResult(**as_t(rs)),
        draws, attrs=I_.gather_attr_rows(ts, idx),
    )
    for name in ("ro", "rd", "throughput", "radiance", "alive", "missed"):
        close(getattr(got_st, name), getattr(want_st, name), name)
    elig = np.asarray(want_nee.eligible)
    assert 0.05 < elig.mean()
    close(got_nee.eligible, elig, "eligible")
    close(got_nee.contribution, want_nee.contribution, "contribution")
    close(got_nee.shadow_rd.numpy()[elig], np.asarray(want_nee.shadow_rd)[elig], "shadow_rd")
    if not first:  # the image sky was paid to the lanes that missed
        assert bool(got_st.missed.any()) and float(got_st.radiance.max()) > 0.0
