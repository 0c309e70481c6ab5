"""Minimal FBX (Kaydara 7.x, binary + ASCII) loader.

A NumPy twin of rustic_tpu/scene/fbx.py.

Completes the format trio the reference's README names ("glTF, FBX,
obj", reference: README.md:13, loaded there through assimp). This is a
dependency-free reader for the documented binary container:

- node records: [end_offset][num_props][prop_list_len][name_len][name]
  (u32 fields < v7500, u64 from v7500), nested children, null sentinel,
- property types Y/C/I/F/D/L, S/R, and f/d/l/i/b arrays with optional
  zlib deflate (stdlib zlib),
- geometry: Vertices + PolygonVertexIndex (negative-XOR polygon
  terminators, fan-triangulated), LayerElementNormal / LayerElementUV
  (ByPolygonVertex | ByVertice | ByVertex, Direct | IndexToDirect),
  LayerElementMaterial (ByPolygon | AllSame),
- materials: Properties70 DiffuseColor / EmissiveColor / EmissiveFactor
  / Shininess (emissive x 15 like every other loader, matching the
  reference's assimp-5.2.5 hack, src/asset.rs:167),
- scene graph: Connections (OO geometry->model, material->model,
  model->model hierarchy) with Lcl Translation / Rotation (XYZ euler,
  degrees) / Scaling composed up the model tree.

Deliberately out of scope (documented): axis/unit
GlobalSettings conversion (exporters overwhelmingly write Y-up meters
or bake transforms), embedded textures, skinning/animation. Output is a
`GltfScene` with the same renderer-space conventions as the other
loaders (Y/Z swizzle + winding reorder, reference: src/asset.rs:102-114,
smooth normals/tangents when absent).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from rustic_tpu_torch.scene.gltf import (
    GltfMaterial,
    GltfScene,
    _renderer_space_scene,
    _shininess_to_roughness,
    _smooth_normals,
    _smooth_tangents,
)

_MAGIC = b"Kaydara FBX Binary  \x00"

_ARRAY_TYPES = {
    b"f": np.dtype("<f4"),
    b"d": np.dtype("<f8"),
    b"l": np.dtype("<i8"),
    b"i": np.dtype("<i4"),
    b"b": np.dtype("<u1"),
}
_SCALAR_TYPES = {
    b"Y": ("<h", 2),
    b"C": ("<b", 1),
    b"I": ("<i", 4),
    b"F": ("<f", 4),
    b"D": ("<d", 8),
    b"L": ("<q", 8),
}


class _Node:
    __slots__ = ("name", "props", "children")

    def __init__(self, name: str, props: list, children: list):
        self.name = name
        self.props = props
        self.children = children

    def find(self, name: str) -> Optional["_Node"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name: str) -> List["_Node"]:
        return [c for c in self.children if c.name == name]


def _parse_props(data: bytes, count: int, offset: int) -> Tuple[list, int]:
    props = []
    for _ in range(count):
        t = data[offset : offset + 1]
        offset += 1
        if t in _SCALAR_TYPES:
            fmt, size = _SCALAR_TYPES[t]
            props.append(struct.unpack_from(fmt, data, offset)[0])
            offset += size
        elif t in _ARRAY_TYPES:
            n, enc, comp_len = struct.unpack_from("<III", data, offset)
            offset += 12
            dt = _ARRAY_TYPES[t]
            if enc == 1:
                raw = zlib.decompress(data[offset : offset + comp_len])
                offset += comp_len
                props.append(np.frombuffer(raw, dt, count=n))
            else:
                props.append(np.frombuffer(data, dt, count=n, offset=offset))
                offset += n * dt.itemsize
        elif t in (b"S", b"R"):
            (n,) = struct.unpack_from("<I", data, offset)
            offset += 4
            raw = data[offset : offset + n]
            offset += n
            props.append(raw.decode(errors="replace") if t == b"S" else raw)
        else:
            raise ValueError(f"unknown FBX property type {t!r}")
    return props, offset


def _parse_nodes(data: bytes, offset: int, end: int, wide: bool) -> list:
    """Parse sibling node records until the null sentinel / end."""
    nodes = []
    fmt, fsize = ("<QQQ", 24) if wide else ("<III", 12)
    null_len = 3 * (8 if wide else 4) + 1
    while offset < end:
        end_offset, num_props, _prop_len = struct.unpack_from(fmt, data, offset)
        name_len = data[offset + fsize]
        if end_offset == 0:  # null record: end of this sibling list
            offset += null_len + name_len  # name_len is 0 for sentinels
            break
        hdr = offset + fsize + 1
        name = data[hdr : hdr + name_len].decode(errors="replace")
        props, p_off = _parse_props(data, num_props, hdr + name_len)
        children = []
        if p_off < end_offset:
            children = _parse_nodes(data, p_off, end_offset, wide)
        nodes.append(_Node(name, props, children))
        offset = end_offset
    return nodes


def _props70(node: _Node) -> Dict[str, list]:
    out = {}
    p70 = node.find("Properties70")
    if p70:
        for p in p70.find_all("P"):
            if p.props:
                out[p.props[0]] = p.props[1:]
    return out


def _layer_values(geom: _Node, layer_name: str, value_name: str,
                  index_name: str, n_verts: int, poly_vidx: np.ndarray,
                  width: int) -> Optional[np.ndarray]:
    """Resolve a layer element to per-polygon-vertex values [len(poly), w]."""
    layer = geom.find(layer_name)
    if layer is None:
        return None
    mapping = ""
    reference = "Direct"
    values = index = None
    for c in layer.children:
        if c.name == "MappingInformationType":
            mapping = c.props[0]
        elif c.name == "ReferenceInformationType":
            reference = c.props[0]
        elif c.name == value_name:
            values = np.asarray(c.props[0], np.float64).reshape(-1, width)
        elif c.name == index_name:
            index = np.asarray(c.props[0], np.int64)
    if values is None:
        return None
    if reference == "IndexToDirect" and index is not None:
        values = values[index]
    if mapping == "ByPolygonVertex":
        return values
    if mapping in ("ByVertice", "ByVertex"):
        return values[poly_vidx]
    if mapping == "AllSame":
        return np.broadcast_to(values[:1], (len(poly_vidx), width))
    raise ValueError(f"unsupported FBX mapping {mapping!r} for {layer_name}")


def _euler_xyz_deg(rx, ry, rz) -> np.ndarray:
    cx, sx = np.cos(np.radians(rx)), np.sin(np.radians(rx))
    cy, sy = np.cos(np.radians(ry)), np.sin(np.radians(ry))
    cz, sz = np.cos(np.radians(rz)), np.sin(np.radians(rz))
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


def _parse_ascii(text: str) -> List[_Node]:
    """Parse ASCII FBX: `Name: p1, p2 { children }` records. Array
    nodes (`Verts: *9 { a: 1,2,... }`) surface their payload as the
    node's single ndarray property, matching the binary reader."""
    import re as _re

    token_re = _re.compile(
        r'"(?:[^"\\]|\\.)*"'  # string
        r"|[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?"  # number
        r"|\*[0-9]+"  # array length marker
        r"|[A-Za-z_][A-Za-z0-9_ ]*:"  # key
        r"|[{},]",
    )

    def convert(tok: str):
        if tok.startswith('"'):
            return tok[1:-1]
        if "." in tok or "e" in tok or "E" in tok:
            return float(tok)
        return int(tok)

    lines = [
        ln for ln in text.splitlines() if not ln.lstrip().startswith(";")
    ]
    toks = token_re.findall("\n".join(lines))
    pos = 0

    def parse_siblings(depth) -> List[_Node]:
        nonlocal pos
        nodes: List[_Node] = []
        while pos < len(toks):
            tok = toks[pos]
            if tok == "}":
                pos += 1
                return nodes
            if not tok.endswith(":"):
                pos += 1  # stray separator
                continue
            name = tok[:-1].strip()
            pos += 1
            props: list = []
            children: List[_Node] = []
            array_len = None
            while pos < len(toks):
                t = toks[pos]
                if t == ",":
                    pos += 1
                elif t.startswith("*"):
                    array_len = int(t[1:])
                    pos += 1
                elif t == "{":
                    pos += 1
                    children = parse_siblings(depth + 1)
                    break
                elif t == "}" or t.endswith(":"):
                    break
                else:
                    props.append(convert(t))
                    pos += 1
            if array_len is not None:
                # children hold one 'a:' node with the numbers
                payload: list = []
                for c in children:
                    if c.name == "a":
                        payload = c.props
                arr = np.asarray(payload)
                props = [
                    arr.astype(
                        np.float64 if arr.dtype.kind == "f" else np.int64
                    )
                ]
                children = []
            nodes.append(_Node(name, props, children))
        return nodes

    return parse_siblings(0)


def load_fbx(path: str) -> GltfScene:
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_MAGIC):
        (version,) = struct.unpack_from("<I", data, len(_MAGIC) + 2)
        roots = _parse_nodes(
            data, len(_MAGIC) + 6, len(data), wide=version >= 7500
        )
    else:
        text = data.decode(errors="replace")
        if "FBX" not in text[:512] and "Objects:" not in text:
            raise ValueError(f"not an FBX file: {path}")
        roots = _parse_ascii(text)
    root = _Node("", [], roots)

    objects = root.find("Objects")
    if objects is None:
        raise ValueError(f"FBX without Objects section: {path}")

    geoms: Dict[int, _Node] = {}
    models: Dict[int, _Node] = {}
    mats: Dict[int, GltfMaterial] = {}
    for n in objects.children:
        if not n.props:
            continue
        uid = int(n.props[0])
        if n.name == "Geometry":
            geoms[uid] = n
        elif n.name == "Model":
            models[uid] = n
        elif n.name == "Material":
            p = _props70(n)
            m = GltfMaterial(metallic=0.0, roughness=1.0)
            if "DiffuseColor" in p:
                m.base_color = (*[float(v) for v in p["DiffuseColor"][-3:]], 1.0)
            emis = [float(v) for v in p.get("EmissiveColor", [0, 0, 0])[-3:]]
            factor = float(p.get("EmissiveFactor", [1.0])[-1])
            # x15: the reference's assimp emissive hack applies per-format
            m.emissive = tuple(15.0 * factor * np.asarray(emis))
            if "Shininess" in p:
                m.roughness = _shininess_to_roughness(float(p["Shininess"][-1]))
            mats[uid] = m

    # Connections: child-uid -> parent-uid (OO only)
    geo_of_model: Dict[int, int] = {}
    mats_of_model: Dict[int, List[int]] = {}
    parent_of_model: Dict[int, int] = {}
    conns = root.find("Connections")
    for c in conns.find_all("C") if conns else []:
        if len(c.props) < 3 or c.props[0] != "OO":
            continue
        child, parent = int(c.props[1]), int(c.props[2])
        if child in geoms and parent in models:
            geo_of_model[parent] = child
        elif child in mats and parent in models:
            mats_of_model.setdefault(parent, []).append(child)
        elif child in models and parent in models:
            parent_of_model[child] = parent

    def _local_matrix(model: _Node) -> np.ndarray:
        p = _props70(model)
        m = np.eye(4)
        lin = np.eye(3)
        if "Lcl Scaling" in p:
            lin = lin @ np.diag([float(v) for v in p["Lcl Scaling"][-3:]])
        if "Lcl Rotation" in p:
            lin = _euler_xyz_deg(*[float(v) for v in p["Lcl Rotation"][-3:]]) @ lin
        m[:3, :3] = lin
        if "Lcl Translation" in p:
            m[:3, 3] = [float(v) for v in p["Lcl Translation"][-3:]]
        return m

    _global_cache: Dict[int, np.ndarray] = {}

    def _global_matrix(uid: int) -> np.ndarray:
        """Compose Lcl TRS up the model hierarchy (node graph flatten,
        the reference's walk_node_graph analog, src/asset.rs:78-132)."""
        if uid not in _global_cache:
            local = _local_matrix(models[uid])
            parent = parent_of_model.get(uid)
            _global_cache[uid] = (
                _global_matrix(parent) @ local
                if parent is not None and parent in models
                else local
            )
        return _global_cache[uid]

    materials: List[GltfMaterial] = []
    mat_slot: Dict[int, int] = {}

    def slot(uid: int) -> int:
        if uid not in mat_slot:
            mat_slot[uid] = len(materials)
            materials.append(mats[uid])
        return mat_slot[uid]

    positions_l, normals_l, uv_l, tris_l = [], [], [], []
    vert_base = 0

    for model_uid, geo_uid in sorted(geo_of_model.items()):
        geom = geoms[geo_uid]
        model = models[model_uid]
        verts_node = geom.find("Vertices")
        idx_node = geom.find("PolygonVertexIndex")
        if verts_node is None or idx_node is None:
            continue
        pos = np.asarray(verts_node.props[0], np.float64).reshape(-1, 3)
        raw_idx = np.asarray(idx_node.props[0], np.int64)

        world = _global_matrix(model_uid)
        mat = world[:3, :3]
        world_pos = pos @ mat.T + world[:3, 3]
        has_linear = not np.allclose(mat, np.eye(3))

        # polygons: indices until a negative value (= ~last_index)
        poly_vidx = np.where(raw_idx < 0, ~raw_idx, raw_idx)
        nrm_pv = _layer_values(
            geom, "LayerElementNormal", "Normals", "NormalsIndex",
            len(pos), poly_vidx, 3,
        )
        uv_pv = _layer_values(
            geom, "LayerElementUV", "UV", "UVIndex", len(pos), poly_vidx, 2
        )
        # per-polygon material slot
        mat_uids = mats_of_model.get(model_uid, [])
        mat_layer = geom.find("LayerElementMaterial")
        poly_mat_idx = None
        if mat_layer is not None:
            for c in mat_layer.children:
                if c.name == "Materials":
                    poly_mat_idx = np.asarray(c.props[0], np.int64)

        default_slot = slot(mat_uids[0]) if mat_uids else None
        if default_slot is None:
            mat_slotless = len(materials)
            materials.append(GltfMaterial(metallic=0.0))
            default_slot = mat_slotless

        # Split into polygons, fan-triangulate, expand per-poly-vertex attrs.
        ends = np.nonzero(raw_idx < 0)[0]
        start = 0
        out_tris = []
        tri_poly = []  # polygon id per triangle (for material mapping)
        corner_of = []  # per emitted corner: polygon-vertex position
        for poly_id, e in enumerate(ends):
            k = e - start + 1
            for t in range(1, k - 1):
                out_tris.append(
                    (poly_vidx[start], poly_vidx[start + t], poly_vidx[start + t + 1])
                )
                corner_of.append((start, start + t, start + t + 1))
                tri_poly.append(poly_id)
            start = e + 1
        tris = np.asarray(out_tris, np.int64)
        corners = np.asarray(corner_of, np.int64)
        tri_poly = np.asarray(tri_poly, np.int64)

        # FBX per-polygon-vertex attrs don't map to shared vertices in
        # general; emit unshared vertices per triangle corner (the other
        # loaders dedupe, assimp's JoinIdenticalVertices re-merges — a
        # pure size tradeoff, renderer output is identical).
        flat_pos = world_pos[tris.reshape(-1)]
        n_new = len(flat_pos)
        new_idx = np.arange(n_new, dtype=np.int64).reshape(-1, 3)

        if nrm_pv is not None:
            flat_nrm = nrm_pv[corners.reshape(-1)]
            if has_linear:
                try:
                    nrm_mat = np.linalg.inv(mat).T
                except np.linalg.LinAlgError:
                    nrm_mat = mat
                flat_nrm = flat_nrm @ nrm_mat.T
            flat_nrm /= np.maximum(
                np.linalg.norm(flat_nrm, axis=-1, keepdims=True), 1e-12
            )
        else:
            flat_nrm = _smooth_normals(flat_pos, new_idx)
        flat_uv = (
            uv_pv[corners.reshape(-1)]
            if uv_pv is not None
            else np.zeros((n_new, 2))
        )
        # FBX UV origin is bottom-left (like OBJ): flip V to glTF space.
        if uv_pv is not None:
            flat_uv = np.stack([flat_uv[:, 0], 1.0 - flat_uv[:, 1]], axis=-1)

        if poly_mat_idx is not None and mat_uids:
            # ByPolygon: one entry per polygon; AllSame: a single entry
            # naming the material for every polygon. Clamp both lookups
            # so malformed indices fall back instead of raising.
            n_m = len(mat_uids)

            def poly_slot(pid: int) -> int:
                mi = int(poly_mat_idx[min(pid, len(poly_mat_idx) - 1)])
                return slot(mat_uids[min(max(mi, 0), n_m - 1)])

            tri_mat = np.asarray(
                [poly_slot(int(pid)) for pid in tri_poly], np.int64
            )
        else:
            tri_mat = np.full(len(tris), default_slot, np.int64)

        t4 = np.empty((len(new_idx), 4), np.int64)
        t4[:, :3] = new_idx + vert_base
        t4[:, 3] = tri_mat
        positions_l.append(flat_pos)
        normals_l.append(flat_nrm)
        uv_l.append(flat_uv)
        tris_l.append(t4)
        vert_base += n_new

    if not tris_l:
        raise ValueError(f"no polygon meshes in FBX: {path}")
    if not materials:
        materials.append(GltfMaterial(metallic=0.0))

    pos = np.concatenate(positions_l)
    nrm = np.concatenate(normals_l)
    uv = np.concatenate(uv_l)
    tri_arr = np.concatenate(tris_l)
    tan = _smooth_tangents(pos, uv, nrm, tri_arr[:, :3])
    return _renderer_space_scene(pos, nrm, tan, uv, tri_arr, materials)
