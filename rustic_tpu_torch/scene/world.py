"""World assembly: a scene file -> BVH order and nodes, light table,
material atlas, flash features and shading rows, uploaded as a
`SceneTensors` (twin of rustic_tpu/scene/world.py).

The triangle-feature packing of rustic_tpu/ops/flash_intersect.py
(`padded_tri_count`, `tile_size`, `pack_tri_feats16`) lives here too:
it is host-side NumPy and only the scene build uses it.

Shading rows: textured scenes upload the full 64-wide rows (ATTR_*:
tangents, uvs, atlas rects and has-texture flags); untextured scenes the
32-wide slim rows (SLIM_*), which drop those columns. The accessors
below read either layout, by its width.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from rustic_tpu_torch.scene import atlas as atlas_mod
from rustic_tpu_torch.scene import bvh as bvh_mod
from rustic_tpu_torch.scene import light_table as lt_mod
from rustic_tpu_torch.scene.gltf import GltfScene, load_glb
from rustic_tpu_torch.utils.exr import read_exr
from rustic_tpu_torch.utils.hdr import read_hdr
from rustic_tpu_torch.utils.png import decode_image_rgba

DEF_TT = 512  # triangles per flash tile
ATLAS_SIZE = 4096  # reference: src/asset.rs:177

# Full shading-row layout (tri_attrs[:, i]) of the JAX package
ATTR_POS = slice(0, 9)  # vertex positions a, b, c
ATTR_NRM = slice(9, 18)  # vertex normals a, b, c
ATTR_TAN = slice(18, 27)  # vertex tangents a, b, c
ATTR_UV = slice(27, 33)  # vertex uv0 a, b, c
ATTR_EMISSIVE = slice(33, 36)
ATTR_ALBEDO = slice(36, 40)  # colour or atlas uvst
ATTR_ROUGH = slice(40, 44)
ATTR_METAL = slice(44, 48)
ATTR_NORMTEX = slice(48, 52)
ATTR_HASTEX = slice(52, 56)  # albedo, metallic, roughness, normal flags
ATTR_TRANSMISSION = 56
ATTR_IOR = 57
ATTR_WIDTH = 64

# Slim shading-row layout for untextured scenes: positions and vertex
# normals at the same offsets (0:18), then the material scalars.
SLIM_EMISSIVE = slice(18, 21)
SLIM_ALBEDO = slice(21, 24)
SLIM_ROUGH = 24
SLIM_METAL = 25
SLIM_TRANSMISSION = 26
SLIM_IOR = 27
SLIM_WIDTH = 32

# Combined NEE entry rows (entry_rows[:, i]): an alias entry and both of
# its candidate triangles' geometry in one row.
ENTRY_AREA_A, ENTRY_PDF_A = 0, 1
ENTRY_AREA_B, ENTRY_PDF_B = 2, 3
ENTRY_RATIO = 4
ENTRY_A_VERTS = slice(8, 17)
ENTRY_A_NORMAL = slice(17, 20)
ENTRY_A_EMISSION = slice(20, 23)
ENTRY_A_TRI = 23
ENTRY_B_VERTS = slice(24, 33)
ENTRY_B_NORMAL = slice(33, 36)
ENTRY_B_EMISSION = slice(36, 39)
ENTRY_B_TRI = 39
ENTRY_WIDTH = 48


def slim_attr_table(attrs: np.ndarray) -> np.ndarray:
    """[T, 64] full shading rows -> [T, SLIM_WIDTH] (untextured)."""
    out = np.zeros((attrs.shape[0], SLIM_WIDTH), np.float32)
    out[:, 0:18] = attrs[:, 0:18]
    out[:, SLIM_EMISSIVE] = attrs[:, ATTR_EMISSIVE]
    out[:, SLIM_ALBEDO] = attrs[:, ATTR_ALBEDO][:, :3]
    out[:, SLIM_ROUGH] = attrs[:, ATTR_ROUGH][:, 0]
    out[:, SLIM_METAL] = attrs[:, ATTR_METAL][:, 0]
    out[:, SLIM_TRANSMISSION] = attrs[:, ATTR_TRANSMISSION]
    out[:, SLIM_IOR] = attrs[:, ATTR_IOR]
    return out


# Row accessors (rustic_tpu/scene/world.py:72-102): `attrs` is [B, 32]
# (slim) or [B, 64] (full).


def attr_is_slim(attrs) -> bool:
    return attrs.shape[-1] == SLIM_WIDTH


def attr_emissive(attrs):
    return attrs[:, SLIM_EMISSIVE if attr_is_slim(attrs) else ATTR_EMISSIVE]


def attr_albedo3(attrs):
    return attrs[:, SLIM_ALBEDO] if attr_is_slim(attrs) else attrs[:, ATTR_ALBEDO][:, :3]


def attr_rough_scalar(attrs):
    return attrs[:, SLIM_ROUGH if attr_is_slim(attrs) else ATTR_ROUGH.start]


def attr_metal_scalar(attrs):
    return attrs[:, SLIM_METAL if attr_is_slim(attrs) else ATTR_METAL.start]


def attr_transmission(attrs):
    return attrs[:, SLIM_TRANSMISSION if attr_is_slim(attrs) else ATTR_TRANSMISSION]


def attr_ior(attrs):
    return attrs[:, SLIM_IOR if attr_is_slim(attrs) else ATTR_IOR]


def padded_tri_count(t_count: int) -> int:
    """Pad to a multiple of 128; beyond one tile, to a tile multiple."""
    if t_count <= DEF_TT:
        return -(-t_count // 128) * 128
    return -(-t_count // DEF_TT) * DEF_TT


def tile_size(t_pad: int) -> int:
    return min(t_pad, DEF_TT)


def _triangle_features(verts: np.ndarray, tri_vidx: np.ndarray) -> np.ndarray:
    """Per-triangle feature tensor G[10, T, 4]: with ray features
    F = [rd, ro×rd, ro, 1], the Möller–Trumbore numerators of every
    (ray, triangle) pair are F·G (reference: kernels/src/intersection.rs:9-54):

        det   = -rd·n                  (n = e1×e2)
        u_num =  (ro×rd)·e2 + rd·(a×e2)
        v_num = -(ro×rd)·e1 + rd·(e1×a)
        t_num =  ro·n - a·n
    """
    a = verts[tri_vidx[:, 0]].astype(np.float64)
    b = verts[tri_vidx[:, 1]].astype(np.float64)
    c = verts[tri_vidx[:, 2]].astype(np.float64)
    e1 = b - a
    e2 = c - a
    n = np.cross(e1, e2)
    d0 = np.sum(a * n, axis=-1)

    g = np.zeros((10, len(tri_vidx), 4), np.float32)
    g[0:3, :, 0] = -n.T
    g[0:3, :, 1] = np.cross(a, e2).T
    g[3:6, :, 1] = e2.T
    g[0:3, :, 2] = np.cross(e1, a).T
    g[3:6, :, 2] = -e1.T
    g[6:9, :, 3] = n.T
    g[9, :, 3] = -d0
    return g


def pack_tri_feats16(tri_feats: np.ndarray) -> np.ndarray:
    """[10, T, 4] -> [16, NT*4*TT]: per tile j the columns
    [j*4TT : (j+1)*4TT] hold the blocks [det | u | v | t], each TT wide.
    Each triangle's four columns are scaled by 1/|e1×e2|, which leaves
    u, v and t unchanged and makes det = -cosθ. Padding columns are zero
    (det == 0, never valid)."""
    t_count = tri_feats.shape[1]
    t_pad = padded_tri_count(t_count)
    tt = tile_size(t_pad)
    nt = t_pad // tt
    src = np.moveaxis(np.asarray(tri_feats), 2, 0)  # [4, 10, T]
    n_len = np.linalg.norm(src[0, 0:3, :], axis=0)
    src = src * np.where(n_len > 0.0, 1.0 / np.maximum(n_len, 1e-30), 1.0)
    g = np.zeros((16, nt, 4, tt), np.float32)
    for j in range(nt):
        cols = src[:, :, j * tt : (j + 1) * tt]
        g[: cols.shape[1], j, :, : cols.shape[2]] = np.moveaxis(cols, 0, 1)
    return g.reshape(16, nt * 4 * tt)


def _tile_aabbs(verts: np.ndarray, tri_vidx: np.ndarray, t_pad: int, tt: int) -> np.ndarray:
    """Per-tile AABBs [nt, 8] = (min xyz, pad, max xyz, pad); empty tiles
    get inverted boxes."""
    nt = t_pad // tt
    out = np.zeros((nt, 8), np.float32)
    out[:, 0:3] = np.inf
    out[:, 4:7] = -np.inf
    pts = verts[tri_vidx].astype(np.float32)  # [T, 3, 3]
    for j in range(nt):
        lo = j * tt
        hi = min(lo + tt, len(tri_vidx))
        if hi > lo:
            tile = pts[lo:hi].reshape(-1, 3)
            out[j, 0:3] = tile.min(axis=0)
            out[j, 4:7] = tile.max(axis=0)
    return out


@dataclasses.dataclass
class SceneTensors:
    """A scene on one device."""

    tri_feats16: torch.Tensor  # [16, NT*4*TT] f32 flash triangle table
    tri_attrs: torch.Tensor  # [T_pad, SLIM_WIDTH or ATTR_WIDTH] f32 shading rows
    entry_rows: torch.Tensor  # [L_pad, ENTRY_WIDTH] f32 NEE entry rows
    tile_aabbs: torch.Tensor  # [NT, 8] f32
    atlas: torch.Tensor  # [Ha, Wa, 9] f32 co-located material maps (scene/atlas.py CH_*)
    skybox: torch.Tensor  # [Hs, Ws, 4] f32 equirect sky image
    # BVH nodes (scene/bvh.py; leaf iff count > 0, a leaf's left_first
    # indexes the rows of tri_attrs); zero nodes on a scene made without them
    bvh_min: torch.Tensor  # [N, 3] f32
    bvh_max: torch.Tensor  # [N, 3] f32
    bvh_left_first: torch.Tensor  # [N] i32
    bvh_count: torch.Tensor  # [N] i32
    # the same nodes and the triangles packed for the traversal kernel
    # (csrc/bvh_traverse.cu, K20): node n at record bvh_node_base + n of
    # [R, 8] f32 (scene/bvh.py `node_records`), stack entries with
    # bvh_count_bits of count; triangles [n_tris, 12] f32 {a, e1, e2}
    # (`triangle_records`); zero rows on a scene made without nodes
    bvh_nodes: torch.Tensor
    bvh_tris: torch.Tensor
    n_tris: int
    n_alias_entries: int
    has_lights: bool
    has_glass: bool
    has_textures: bool
    bvh_node_base: int
    bvh_count_bits: int

    @property
    def device(self) -> torch.device:
        return self.tri_feats16.device

    def to(self, device) -> "SceneTensors":
        tensors = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **tensors)


def fallback_skybox() -> np.ndarray:
    """2x2 magenta sky for configs without an image (reference:
    src/asset.rs:275-289)."""
    return np.tile(np.array([1.0, 0.0, 1.0, 1.0], np.float32), (2, 2, 1))


def _empty_atlas() -> np.ndarray:
    return np.zeros((4, 4, atlas_mod.ATLAS_CHANNELS), np.float32)


def triangle_records(tri_attrs: torch.Tensor, n_tris: int) -> torch.Tensor:
    """The triangle table of the traversal kernel (csrc/bvh_traverse.cu,
    K20): [n_tris, 12] f32, row i {a, 0, e1, 0, e2, 0} of the vertices a,
    b, c in columns 0:9 of shading row i (the BVH's triangle order), with
    e1 = b - a and e2 = c - a by the IEEE f32 subtraction of the plain
    version's Moller-Trumbore test, on the rows' device."""
    v = tri_attrs[:n_tris, 0:9]
    a = v[:, 0:3]
    rec = torch.zeros((v.shape[0], 12), dtype=torch.float32, device=tri_attrs.device)
    rec[:, 0:3] = a
    rec[:, 4:7] = v[:, 3:6] - a
    rec[:, 8:11] = v[:, 6:9] - a
    return rec


def _scene_tensors(tri_feats16, attrs, entry_rows, tile_aabbs, atlas, skybox, bvh, device,
                   **meta):
    def up(a, dtype=np.float32):
        return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)

    if bvh is None:
        bvh = bvh_mod.BVH(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0), np.zeros(0))
    records, base, cbits = bvh_mod.node_records(bvh)
    tri_attrs = up(attrs)
    return SceneTensors(
        tri_feats16=up(tri_feats16),
        tri_attrs=tri_attrs,
        entry_rows=up(entry_rows),
        tile_aabbs=up(tile_aabbs),
        atlas=up(atlas),
        skybox=up(fallback_skybox() if skybox is None else skybox),
        bvh_min=up(bvh.aabb_min).reshape(-1, 3),
        bvh_max=up(bvh.aabb_max).reshape(-1, 3),
        bvh_left_first=up(bvh.left_first, np.int32),
        bvh_count=up(bvh.count, np.int32),
        bvh_nodes=up(records),
        bvh_tris=triangle_records(tri_attrs, meta["n_tris"] if bvh.n_nodes else 0),
        bvh_node_base=base,
        bvh_count_bits=cbits,
        **meta,
    )


def scene_from_arrays(fields: dict, device) -> SceneTensors:
    """SceneTensors from the JAX package's SceneArrays fields as numpy
    arrays (`tri_feats16`, `tri_attrs` [T_pad, 64], `entry_rows`,
    `tile_aabbs`, for textured scenes or an image sky `atlas` and
    `skybox`, and for the "bvh" engine the nodes `bvh_min`, `bvh_max`,
    `bvh_left_first`, `bvh_count`) plus its static metadata (`n_tris`,
    `n_alias_entries`, `has_lights`, `has_glass`, `has_textures`), so one
    scene can feed both packages. Untextured rows are slimmed; textured
    rows stay full. Without the nodes the scene has none, and the "bvh"
    engine refuses it."""
    attrs = np.asarray(fields["tri_attrs"], np.float32)
    has_textures = bool(fields["has_textures"])
    if not has_textures and attrs.shape[-1] != SLIM_WIDTH:
        attrs = slim_attr_table(attrs)
    atlas = fields.get("atlas")
    bvh = None
    if "bvh_count" in fields:
        bvh = bvh_mod.BVH(*(fields[k] for k in ("bvh_min", "bvh_max", "bvh_left_first",
                                                "bvh_count")))
    return _scene_tensors(
        fields["tri_feats16"], attrs, fields["entry_rows"], fields["tile_aabbs"],
        _empty_atlas() if atlas is None else atlas, fields.get("skybox"), bvh,
        device,
        n_tris=int(fields["n_tris"]),
        n_alias_entries=int(fields["n_alias_entries"]),
        has_lights=bool(fields["has_lights"]),
        has_glass=bool(fields["has_glass"]),
        has_textures=has_textures,
    )


def load_skybox_image(path: str) -> np.ndarray:
    """An equirect sky image -> float32 [H, W, 4] (twin of the JAX
    package's `load_skybox_image`): .npy ([H, W, 3] or [H, W, 4]
    radiance), Radiance .hdr, OpenEXR .exr (radiance; a grey Y image
    repeated to RGB, alpha 1 unless the file has A), or an LDR image
    (PNG, JPEG, BMP, TGA, GIF, TIFF, WebP, JPEG 2000; scaled to [0, 1])."""
    low = path.lower()
    if low.endswith(".npy"):
        img = np.asarray(np.load(path), np.float32)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
        return img
    if low.endswith(".hdr"):
        img = read_hdr(path)
        return np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
    with open(path, "rb") as f:
        raw = f.read()
    if low.endswith(".exr"):
        img = read_exr(raw)
        if img.shape[-1] == 1:
            img = img.repeat(3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
        return img
    return decode_image_rgba(raw, path)


class World:
    """Host-side scene bundle (NumPy) with `.to_torch(device)` upload.
    `atlas_size` is the side of the square material atlas."""

    def __init__(self, gltf: GltfScene, atlas_size: int = ATLAS_SIZE):
        self.positions = gltf.positions
        self.normals = gltf.normals
        self.tangents = gltf.tangents
        self.uv0 = gltf.uv0
        n_mats = len(gltf.materials)
        self.mat_emissive = np.zeros((n_mats, 3), np.float32)
        self.mat_albedo = np.zeros((n_mats, 4), np.float32)
        self.mat_roughness = np.zeros((n_mats, 4), np.float32)
        self.mat_metallic = np.zeros((n_mats, 4), np.float32)
        self.mat_normals = np.zeros((n_mats, 4), np.float32)
        self.mat_has_tex = np.zeros((n_mats, 4), np.int32)
        self.mat_transmission = np.zeros((n_mats, 2), np.float32)  # transmission, ior
        mat_maps: List[dict] = []
        for mi, m in enumerate(gltf.materials):
            self.mat_albedo[mi] = m.base_color
            self.mat_roughness[mi] = m.roughness
            self.mat_metallic[mi] = m.metallic
            self.mat_emissive[mi] = m.emissive
            self.mat_transmission[mi] = (m.transmission, m.ior)
            mat_maps.append({
                "albedo": m.albedo_texture,
                "metallic": m.metallic_texture,
                "roughness": m.roughness_texture,
                "normal": m.normal_texture,
            })

        # the co-located material atlas; each textured slot of a material
        # holds its one uvst rect (reference: src/asset.rs:179-192)
        if any(v is not None for maps in mat_maps for v in maps.values()):
            self.atlas, mat_uvst = atlas_mod.pack_material_textures(
                mat_maps, atlas_size, atlas_size
            )
        else:
            self.atlas, mat_uvst = _empty_atlas(), [None] * n_mats
        slots = {"albedo": (0, self.mat_albedo), "metallic": (1, self.mat_metallic),
                 "roughness": (2, self.mat_roughness), "normal": (3, self.mat_normals)}
        for mi, (maps, uvst) in enumerate(zip(mat_maps, mat_uvst)):
            for field, tex in maps.items():
                if tex is not None:
                    col, table = slots[field]
                    self.mat_has_tex[mi, col] = 1
                    table[mi] = uvst

        # BVH order first, then the light table on the reordered
        # triangles (reference: src/asset.rs:194-203)
        self.bvh, perm = bvh_mod.build_bvh(self.positions, gltf.triangles)
        self.triangles = gltf.triangles[perm]
        mask = lt_mod.compute_emissive_mask(self.triangles, self.mat_emissive)
        self.light_table = lt_mod.build_light_table(
            self.positions, self.triangles, mask, self.mat_emissive
        )

        vi = self.triangles[:, :3]
        self.tri_feats16 = pack_tri_feats16(_triangle_features(self.positions, vi))
        t_pad = self.tri_feats16.shape[-1] // 4
        self.tile_aabbs = _tile_aabbs(self.positions, vi, t_pad, tile_size(t_pad))
        full = self._shading_rows(t_pad)
        self.has_textures = bool(self.mat_has_tex.any())
        self.tri_attrs = full if self.has_textures else slim_attr_table(full)
        self.entry_rows = self._entry_rows()

    def _shading_rows(self, t_pad: int) -> np.ndarray:
        """The full [t_pad, ATTR_WIDTH] rows (`_pack_shading_rows`)."""
        vi = self.triangles[:, :3]
        mi = self.triangles[:, 3]
        n = len(vi)
        attrs = np.zeros((t_pad, ATTR_WIDTH), np.float32)
        attrs[:n, ATTR_POS] = self.positions[vi].reshape(n, 9)
        attrs[:n, ATTR_NRM] = self.normals[vi].reshape(n, 9)
        attrs[:n, ATTR_TAN] = self.tangents[vi].reshape(n, 9)
        attrs[:n, ATTR_UV] = self.uv0[vi].reshape(n, 6)
        attrs[:n, ATTR_EMISSIVE] = self.mat_emissive[mi]
        attrs[:n, ATTR_ALBEDO] = self.mat_albedo[mi]
        attrs[:n, ATTR_ROUGH] = self.mat_roughness[mi]
        attrs[:n, ATTR_METAL] = self.mat_metallic[mi]
        attrs[:n, ATTR_NORMTEX] = self.mat_normals[mi]
        attrs[:n, ATTR_HASTEX] = self.mat_has_tex[mi]
        attrs[:n, ATTR_TRANSMISSION] = self.mat_transmission[mi, 0]
        attrs[:n, ATTR_IOR] = self.mat_transmission[mi, 1]
        return attrs

    def _entry_rows(self) -> np.ndarray:
        lt = self.light_table
        vi = self.triangles[:, :3]
        mi = self.triangles[:, 3]
        n_e = len(lt)
        entries = np.zeros((max(8, -(-n_e // 8) * 8), ENTRY_WIDTH), np.float32)
        entries[:n_e, ENTRY_AREA_A] = lt.area_a
        entries[:n_e, ENTRY_PDF_A] = lt.pdf_a
        entries[:n_e, ENTRY_AREA_B] = lt.area_b
        entries[:n_e, ENTRY_PDF_B] = lt.pdf_b
        entries[:n_e, ENTRY_RATIO] = lt.ratio
        if not lt.is_sentinel:
            sides = (
                (lt.idx_a, ENTRY_A_VERTS, ENTRY_A_NORMAL, ENTRY_A_EMISSION, ENTRY_A_TRI),
                (lt.idx_b, ENTRY_B_VERTS, ENTRY_B_NORMAL, ENTRY_B_EMISSION, ENTRY_B_TRI),
            )
            for idx, verts_c, nrm_c, emis_c, tri_c in sides:
                gi = idx.astype(np.int64)
                svi = vi[gi]
                entries[:n_e, verts_c] = self.positions[svi].reshape(n_e, 9)
                # unnormalized mean of the vertex normals, as the reference
                # (kernels/src/light_pick.rs:129)
                entries[:n_e, nrm_c] = self.normals[svi].mean(axis=1)
                entries[:n_e, emis_c] = self.mat_emissive[mi[gi]]
                entries[:n_e, tri_c] = gi
        return entries

    @classmethod
    def from_path(cls, path: str, atlas_size: int = ATLAS_SIZE) -> "World":
        """Load a scene by its extension, as the JAX package's
        `World.from_path`: .obj (with its .mtl), .stl, .ply, .fbx, and
        glTF (.glb/.gltf) for anything else."""
        low = path.lower()
        if low.endswith(".obj"):
            from rustic_tpu_torch.scene.obj import load_obj

            return cls(load_obj(path), atlas_size)
        if low.endswith(".stl"):
            from rustic_tpu_torch.scene.mesh_formats import load_stl

            return cls(load_stl(path), atlas_size)
        if low.endswith(".ply"):
            from rustic_tpu_torch.scene.mesh_formats import load_ply

            return cls(load_ply(path), atlas_size)
        if low.endswith(".fbx"):
            from rustic_tpu_torch.scene.fbx import load_fbx

            return cls(load_fbx(path), atlas_size)
        return cls(load_glb(path), atlas_size)

    def to_torch(self, device, skybox: Optional[np.ndarray] = None) -> SceneTensors:
        """Upload to `device`; `skybox` is the equirect sky image
        (`load_skybox_image`) that configs with has_skybox read."""
        return _scene_tensors(
            self.tri_feats16, self.tri_attrs, self.entry_rows, self.tile_aabbs,
            self.atlas, skybox, self.bvh, device,
            n_tris=len(self.triangles),
            n_alias_entries=len(self.light_table),
            has_lights=not self.light_table.is_sentinel,
            has_glass=bool((self.mat_transmission[:, 0] > 0.0).any()),
            has_textures=self.has_textures,
        )


def load_scene(scene_path: str, skybox_path: Optional[str] = None, device="cuda") -> SceneTensors:
    """A scene file (+ optional sky image) on `device` (twin of the JAX
    package's `load_scene`)."""
    from rustic_tpu_torch.runtime.render import resolve_device

    device = resolve_device(device)
    world = World.from_path(scene_path)
    skybox = load_skybox_image(skybox_path) if skybox_path else None
    return world.to_torch(device, skybox)
