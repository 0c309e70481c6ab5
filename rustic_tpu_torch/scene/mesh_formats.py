"""STL and PLY mesh loaders (single-material triangle soups).

A NumPy twin of rustic_tpu/scene/mesh_formats.py.

Rounds out the multi-format surface the reference gets from assimp
(reference: README.md:13, src/asset.rs:55-69) for the common
material-less mesh formats. Both return a `GltfScene` with one default
matte material and the same renderer-space conventions as the GLB/OBJ
paths: Y/Z swizzle + winding reorder (reference: src/asset.rs:102-114)
and generated smooth normals/tangents (GenerateSmoothNormals /
CalculateTangentSpace analogs).

STL: binary and ASCII, facet normals ignored (recomputed smooth — STL
facet normals are per-face and frequently garbage in the wild).
PLY: ascii / binary_little_endian / binary_big_endian, vertex
x/y/z (+ optional per-vertex u/v or s/t texture coordinates); faces via
`vertex_indices` / `vertex_index` list properties, fan-triangulated.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from rustic_tpu_torch.scene.gltf import (
    GltfMaterial,
    GltfScene,
    _renderer_space_scene,
    _smooth_normals,
    _smooth_tangents,
)


def _finish(pos: np.ndarray, tris: np.ndarray, uv: np.ndarray = None) -> GltfScene:
    """Shared tail: dedupe-free soup -> renderer-space GltfScene.
    (_smooth_normals welds by position, so unshared soups smooth.)"""
    pos = pos.astype(np.float64)
    if uv is None:
        uv = np.zeros((len(pos), 2))
    nrm = _smooth_normals(pos, tris)
    tan = _smooth_tangents(pos, uv, nrm, tris)
    tris4 = np.concatenate(
        [tris, np.zeros((len(tris), 1), np.int64)], axis=1
    )
    return _renderer_space_scene(
        pos, nrm, tan, uv, tris4, [GltfMaterial(metallic=0.0)]
    )


def load_stl(path: str) -> GltfScene:
    with open(path, "rb") as f:
        data = f.read()
    is_ascii = data[:5] == b"solid" and b"facet" in data[:500]
    if is_ascii:
        verts: List[Tuple[float, float, float]] = []
        for line in data.decode(errors="replace").splitlines():
            parts = line.split()
            if parts[:1] == ["vertex"]:
                verts.append(tuple(map(float, parts[1:4])))
        pos = np.asarray(verts, np.float64)
    else:
        (n_tris,) = struct.unpack_from("<I", data, 80)
        rec = np.frombuffer(
            data, dtype=np.uint8, count=n_tris * 50, offset=84
        ).reshape(n_tris, 50)
        # 12 f32 per facet (normal + 3 verts) + u16 attribute count
        f32 = rec[:, :48].copy().view("<f4").reshape(n_tris, 12)
        pos = f32[:, 3:12].reshape(-1, 3).astype(np.float64)
    if len(pos) == 0 or len(pos) % 3:
        raise ValueError(f"malformed STL: {path}")
    tris = np.arange(len(pos), dtype=np.int64).reshape(-1, 3)
    return _finish(pos, tris)


_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> GltfScene:
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    if not data.startswith(b"ply") or end < 0:
        raise ValueError(f"not a PLY file: {path}")
    header = data[:end].decode(errors="replace").splitlines()
    body = data[data.find(b"\n", end) + 1 :]

    fmt = "ascii"
    elements = []  # (name, count, [(kind, dtype(s), prop_name)])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append(("list", (parts[2], parts[3]), parts[4]))
            else:
                elements[-1][2].append(("scalar", parts[1], parts[2]))

    endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
    verts = {}
    faces: List[List[int]] = []
    offset = 0
    ascii_rows = body.decode(errors="replace").split("\n") if endian is None else None
    row_i = 0

    for name, count, props in elements:
        if endian is None:
            rows = []
            while len(rows) < count:
                line = ascii_rows[row_i]
                row_i += 1
                if line.strip():
                    rows.append(line.split())
            if name == "vertex":
                cols = [p[2] for p in props]
                arr = np.asarray(rows, np.float64)
                for j, c in enumerate(cols):
                    verts[c] = arr[:, j]
            elif name == "face":
                for r in rows:
                    n = int(r[0])
                    faces.append([int(v) for v in r[1 : 1 + n]])
        else:
            if all(p[0] == "scalar" for p in props):
                dt = np.dtype(
                    [(p[2], endian + _PLY_DTYPES[p[1]]) for p in props]
                )
                arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
                offset += dt.itemsize * count
                if name == "vertex":
                    for p in props:
                        verts[p[2]] = arr[p[2]].astype(np.float64)
            else:
                # row-by-row (list properties have variable length);
                # scalar values are still collected so a vertex element
                # with an auxiliary list property keeps its x/y/z.
                scalars: Dict[str, list] = {
                    p[2]: [] for p in props if p[0] == "scalar"
                }
                for _ in range(count):
                    for kind, dtype, pname in props:
                        if kind == "scalar":
                            dt = np.dtype(endian + _PLY_DTYPES[dtype])
                            scalars[pname].append(
                                np.frombuffer(
                                    body, dtype=dt, count=1, offset=offset
                                )[0]
                            )
                            offset += dt.itemsize
                        else:
                            cnt_dt = np.dtype(endian + _PLY_DTYPES[dtype[0]])
                            n = np.frombuffer(
                                body, dtype=cnt_dt, count=1, offset=offset
                            )[0]
                            offset += cnt_dt.itemsize
                            item_dt = np.dtype(endian + _PLY_DTYPES[dtype[1]])
                            vals = np.frombuffer(
                                body, dtype=item_dt, count=int(n), offset=offset
                            )
                            offset += item_dt.itemsize * int(n)
                            if name == "face" and pname in (
                                "vertex_indices",
                                "vertex_index",
                            ):
                                faces.append([int(v) for v in vals])
                if name == "vertex":
                    for pname, vals in scalars.items():
                        verts[pname] = np.asarray(vals, np.float64)

    if not {"x", "y", "z"} <= set(verts):
        raise ValueError(f"PLY without x/y/z vertex properties: {path}")
    pos = np.stack([verts["x"], verts["y"], verts["z"]], axis=-1)
    uv = None
    for ukey, vkey in (("u", "v"), ("s", "t")):
        if ukey in verts and vkey in verts:
            uv = np.stack([verts[ukey], 1.0 - verts[vkey]], axis=-1)
            break
    tris: List[Tuple[int, int, int]] = []
    for face in faces:
        for k in range(1, len(face) - 1):
            tris.append((face[0], face[k], face[k + 1]))
    if not tris:
        raise ValueError(f"no faces in PLY: {path}")
    return _finish(pos, np.asarray(tris, np.int64), uv)
