"""The port's scene build (NumPy loader, BVH, light table, flash tables,
slim shading rows) against the JAX package's World.

Both Worlds are built by default: the JAX package with its C++ BVH
builder (native/bvh.cpp), the port with its copy (csrc/bvh_build.cpp),
the same triangle order. Every compared table must be equal exactly:
both sides run the same C++ and NumPy arithmetic."""

import numpy as np
import pytest
import torch

from rustic_tpu.scene import bvh as jax_bvh
from rustic_tpu.scene import world as JW
from rustic_tpu_torch.scene import bvh as port_bvh
from rustic_tpu_torch.scene import world as TW
from rustic_tpu_torch.scene.gltf import load_glb
from tests.test_torch_bvh_native import require_jax_native

torch.set_num_threads(2)


def write_glass_sky(path):
    """The glass-and-sky scene of tests/test_shade_kernel.py."""
    from rustic_tpu.scene.glb_write import MaterialSpec, MeshSpec, write_glb

    quad = np.array([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]], np.float32)
    glass = quad * 0.3 + np.array([0, 1.0, 0], np.float32)
    lamp = quad * 0.15 + np.array([1.5, 2.0, 0], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
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


@pytest.fixture(params=["DarkCornell", "glass_sky"])
def worlds(request, tmp_path_factory):
    if request.param == "glass_sky":
        path = str(tmp_path_factory.mktemp("glass") / "glass_sky.glb")
        write_glass_sky(path)
    else:
        from conftest import scene_path

        path = scene_path(f"{request.param}.glb")
    require_jax_native()
    jworld = JW.World.from_path(path)
    return jworld, jworld.to_device(), TW.World.from_path(path)


def test_triangle_order_and_flash_tables_exact(worlds):
    jworld, jscene, tworld = worlds
    np.testing.assert_array_equal(tworld.triangles, jworld.triangles)
    ts = tworld.to_torch("cpu")
    assert ts.tri_feats16.dtype == torch.float32
    np.testing.assert_array_equal(ts.tri_feats16.numpy(), np.asarray(jscene.tri_feats16))
    np.testing.assert_array_equal(ts.tile_aabbs.numpy(), np.asarray(jscene.tile_aabbs))
    assert ts.n_tris == jscene.n_tris


def test_slim_attrs_and_entry_rows_exact(worlds):
    _, jscene, tworld = worlds
    ts = tworld.to_torch("cpu")
    np.testing.assert_array_equal(
        ts.tri_attrs.numpy(), JW.slim_attr_table(np.asarray(jscene.tri_attrs))
    )
    # the JAX kernels' bf16 split of the same slim table sums back to it
    split = np.asarray(jscene.tri_attrs_split).astype(np.float32)
    np.testing.assert_array_equal((split[0] + split[1]) + split[2], ts.tri_attrs.numpy())
    np.testing.assert_array_equal(ts.entry_rows.numpy(), np.asarray(jscene.entry_rows))
    assert ts.n_alias_entries == jscene.n_alias_entries
    assert ts.has_lights == jscene.has_lights
    assert ts.has_glass == jscene.has_glass
    assert ts.has_textures == jscene.has_textures is False


def test_scene_from_arrays_round_trips(worlds):
    _, jscene, tworld = worlds
    fields = {
        k: np.asarray(getattr(jscene, k))
        for k in ("tri_feats16", "tri_attrs", "entry_rows", "tile_aabbs", "bvh_min", "bvh_max",
                  "bvh_left_first", "bvh_count")
    }
    for k in ("n_tris", "n_alias_entries", "has_lights", "has_glass", "has_textures"):
        fields[k] = getattr(jscene, k)
    got = TW.scene_from_arrays(fields, "cpu")
    want = tworld.to_torch("cpu")
    for name in ("tri_feats16", "tri_attrs", "entry_rows", "tile_aabbs", "bvh_min", "bvh_max",
                 "bvh_left_first", "bvh_count"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in ("n_tris", "n_alias_entries", "has_lights", "has_glass", "has_textures"):
        assert getattr(got, name) == getattr(want, name), name
    # a slim table passes through unchanged
    fields["tri_attrs"] = want.tri_attrs.numpy()
    assert torch.equal(TW.scene_from_arrays(fields, "cpu").tri_attrs, want.tri_attrs)


@pytest.mark.parametrize("name", ["DarkCornell", "FurnaceTest"])
def test_bvh_permutation_matches_numpy_builder(name):
    """FurnaceTest (10k triangles, many tiles) covers deep BVH splits."""
    from conftest import scene_path

    g = load_glb(scene_path(f"{name}.glb"))
    _, perm = port_bvh.build_bvh(g.positions, g.triangles, use_native=False)
    _, jperm = jax_bvh._build_bvh_numpy(g.positions, g.triangles, 128)
    np.testing.assert_array_equal(perm, jperm)


def test_loader_matches_jax_loader():
    from conftest import scene_path
    from rustic_tpu.scene.gltf import load_glb as jax_load_glb

    g = load_glb(scene_path("DarkCornell.glb"))
    j = jax_load_glb(scene_path("DarkCornell.glb"))
    np.testing.assert_array_equal(g.positions, j.positions)
    np.testing.assert_array_equal(g.normals, j.normals)
    np.testing.assert_array_equal(g.triangles, j.triangles)
    for m, jm in zip(g.materials, j.materials):
        assert (m.base_color, m.metallic, m.roughness, m.emissive) == (
            jm.base_color, jm.metallic, jm.roughness, jm.emissive
        )


def test_textured_scene_is_refused():
    """A textured scene of a single triangle tile renders through the
    torch-shade loop (K1/K2 emit slim rows, so the kernel-shade loop does
    not take it). What is refused of textured scenes: an image the port
    cannot decode."""
    from rustic_tpu_torch.config import TracingConfig
    from rustic_tpu_torch.ops import shade_kernel as SK
    from rustic_tpu_torch.runtime.render import render_image
    from rustic_tpu_torch.scene import gltf as TG

    g = load_glb(__import__("conftest").scene_path("DarkCornell.glb"))
    g.materials[0].albedo_texture = np.full((4, 4, 4), 0.5, np.float32)
    world = TW.World(g, atlas_size=16)
    assert world.has_textures and world.tri_attrs.shape[1] == TW.ATTR_WIDTH
    scene = world.to_torch("cpu")
    assert not SK.supported(scene)
    film = render_image(scene, TracingConfig(width=4, height=4), device="cpu")
    assert film.shape == (4, 4, 3) and np.isfinite(film).all() and film.mean() > 0.0
    # a hierarchical JPEG (SOF5), a variant the port refuses (as Pillow's libjpeg does)
    sof5 = (b"\xff\xd8\xff\xc5\x00\x0b\x08\x00\x01\x00\x01\x01\x01\x11\x00"
            b"\xff\xda\x00\x08\x01\x01\x00\x00\x3f\x00\xff\xd9")
    jpeg = {"images": [{"bufferView": 0}],
            "bufferViews": [{"buffer": 0, "byteLength": len(sof5)}]}
    with pytest.raises(NotImplementedError, match="hierarchical.*ROADMAP"):
        TG._decode_image(jpeg, [sof5], 0, "")
