"""World assembly: GLB -> BVH order, light table, flash features and
shading rows, uploaded as a `SceneTensors` (twin of
rustic_tpu/scene/world.py for untextured scenes).

The triangle-feature packing of rustic_tpu/ops/flash_intersect.py
(`padded_tri_count`, `tile_size`, `pack_tri_feats16`) lives here too:
it is host-side NumPy and only the scene build uses it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rustic_tpu_torch.scene import bvh as bvh_mod
from rustic_tpu_torch.scene import light_table as lt_mod
from rustic_tpu_torch.scene.gltf import GltfScene, load_glb

DEF_TT = 512  # triangles per flash tile

# Full shading-row layout of the JAX package (tri_attrs[:, i]); the port
# reads it only to slim a JAX table (scene_from_arrays).
ATTR_EMISSIVE = slice(33, 36)
ATTR_ALBEDO = slice(36, 40)
ATTR_ROUGH = slice(40, 44)
ATTR_METAL = slice(44, 48)
ATTR_TRANSMISSION = 56
ATTR_IOR = 57

# Slim shading-row layout for untextured scenes: positions a,b,c (0:9),
# vertex normals a,b,c (9:18), then the material scalars.
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

TEXTURES_TODO = (
    "textured scenes are not ported yet (ROADMAP.md queue 1 item 7: "
    "ops/texture.py and the 9-channel atlas)"
)


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


# Slim-row accessors (twins of rustic_tpu/scene/world.py:72-101 for the
# slim layout, the only one the port uploads): `attrs` is [B, SLIM_WIDTH].
# Columns 0:9 hold the vertex positions a, b, c (ops/intersect.py).
ATTR_NRM = slice(9, 18)  # vertex normals a, b, c


def attr_emissive(attrs):
    return attrs[:, SLIM_EMISSIVE]


def attr_albedo3(attrs):
    return attrs[:, SLIM_ALBEDO]


def attr_rough_scalar(attrs):
    return attrs[:, SLIM_ROUGH]


def attr_metal_scalar(attrs):
    return attrs[:, SLIM_METAL]


def attr_transmission(attrs):
    return attrs[:, SLIM_TRANSMISSION]


def attr_ior(attrs):
    return attrs[:, SLIM_IOR]


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
    """A scene on one device: what the single-tile slice reads."""

    tri_feats16: torch.Tensor  # [16, NT*4*TT] f32 flash triangle table
    tri_attrs: torch.Tensor  # [T_pad, SLIM_WIDTH] f32 shading rows
    entry_rows: torch.Tensor  # [L_pad, ENTRY_WIDTH] f32 NEE entry rows
    tile_aabbs: torch.Tensor  # [NT, 8] f32
    n_tris: int
    n_alias_entries: int
    has_lights: bool
    has_glass: bool
    has_textures: bool

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


def _scene_tensors(tri_feats16, slim_attrs, entry_rows, tile_aabbs, device, **meta):
    def f32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(device)

    return SceneTensors(
        tri_feats16=f32(tri_feats16),
        tri_attrs=f32(slim_attrs),
        entry_rows=f32(entry_rows),
        tile_aabbs=f32(tile_aabbs),
        **meta,
    )


def scene_from_arrays(fields: dict, device) -> SceneTensors:
    """SceneTensors from the JAX package's SceneArrays fields as numpy
    arrays (`tri_feats16`, `tri_attrs` [T_pad, 64], `entry_rows`,
    `tile_aabbs`) plus its static metadata (`n_tris`, `n_alias_entries`,
    `has_lights`, `has_glass`, `has_textures`), so one scene can feed
    both packages."""
    if fields["has_textures"]:
        raise NotImplementedError(TEXTURES_TODO)
    attrs = np.asarray(fields["tri_attrs"], np.float32)
    if attrs.shape[-1] != SLIM_WIDTH:
        attrs = slim_attr_table(attrs)
    return _scene_tensors(
        fields["tri_feats16"], attrs, fields["entry_rows"], fields["tile_aabbs"],
        device,
        n_tris=int(fields["n_tris"]),
        n_alias_entries=int(fields["n_alias_entries"]),
        has_lights=bool(fields["has_lights"]),
        has_glass=bool(fields["has_glass"]),
        has_textures=False,
    )


class World:
    """Host-side scene bundle (NumPy) with `.to_torch(device)` upload."""

    def __init__(self, gltf: GltfScene):
        if any(m.has_texture for m in gltf.materials):
            raise NotImplementedError(TEXTURES_TODO)
        self.positions = gltf.positions
        self.normals = gltf.normals
        mats = gltf.materials
        self.mat_emissive = np.array([m.emissive for m in mats], np.float32)
        self.mat_albedo = np.array([m.base_color for m in mats], np.float32)
        self.mat_roughness = np.array([m.roughness for m in mats], np.float32)
        self.mat_metallic = np.array([m.metallic for m in mats], np.float32)
        self.mat_transmission = np.array([m.transmission for m in mats], np.float32)
        self.mat_ior = np.array([m.ior for m in mats], np.float32)

        # BVH order first, then the light table on the reordered
        # triangles (reference: src/asset.rs:194-203)
        perm = bvh_mod.build_bvh(self.positions, gltf.triangles)
        self.triangles = gltf.triangles[perm]
        mask = lt_mod.compute_emissive_mask(self.triangles, self.mat_emissive)
        self.light_table = lt_mod.build_light_table(
            self.positions, self.triangles, mask, self.mat_emissive
        )

        vi = self.triangles[:, :3]
        self.tri_feats16 = pack_tri_feats16(_triangle_features(self.positions, vi))
        t_pad = self.tri_feats16.shape[-1] // 4
        self.tile_aabbs = _tile_aabbs(self.positions, vi, t_pad, tile_size(t_pad))
        self.tri_attrs = self._slim_rows(t_pad)
        self.entry_rows = self._entry_rows()

    def _slim_rows(self, t_pad: int) -> np.ndarray:
        vi = self.triangles[:, :3]
        mi = self.triangles[:, 3]
        t_count = len(vi)
        attrs = np.zeros((t_pad, SLIM_WIDTH), np.float32)
        attrs[:t_count, 0:9] = self.positions[vi].reshape(t_count, 9)
        attrs[:t_count, 9:18] = self.normals[vi].reshape(t_count, 9)
        attrs[:t_count, SLIM_EMISSIVE] = self.mat_emissive[mi]
        attrs[:t_count, SLIM_ALBEDO] = self.mat_albedo[mi, :3]
        attrs[:t_count, SLIM_ROUGH] = self.mat_roughness[mi]
        attrs[:t_count, SLIM_METAL] = self.mat_metallic[mi]
        attrs[:t_count, SLIM_TRANSMISSION] = self.mat_transmission[mi]
        attrs[:t_count, SLIM_IOR] = self.mat_ior[mi]
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
    def from_path(cls, path: str) -> "World":
        if not path.lower().endswith((".glb", ".gltf")):
            raise NotImplementedError(
                f"{path}: only .glb/.gltf scenes are ported (ROADMAP.md queue 1)"
            )
        return cls(load_glb(path))

    def to_torch(self, device) -> SceneTensors:
        return _scene_tensors(
            self.tri_feats16, self.tri_attrs, self.entry_rows, self.tile_aabbs,
            device,
            n_tris=len(self.triangles),
            n_alias_entries=len(self.light_table),
            has_lights=not self.light_table.is_sentinel,
            has_glass=bool((self.mat_transmission > 0.0).any()),
            has_textures=False,
        )
