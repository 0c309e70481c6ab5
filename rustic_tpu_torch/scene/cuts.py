"""Cut a loaded glTF scene down to one triangle tile.

The committed assets hold no textured scene, and none with a wide alias
table, of at most 512 triangles (one flash tile). These cuts make such
scenes from BreakTime and VeachMIS: whole materials (the room, the
emitter) plus, of the finely tessellated ones, the triangles nearest a
point. The result is a `GltfScene` like its input (the port's or the JAX
package's: only the dataclass fields are used), to be passed to `World`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

MAX_ONE_TILE = 512


@dataclasses.dataclass(frozen=True)
class OneTileCut:
    """Which triangles of a scene to keep."""

    whole: Tuple[int, ...]  # materials kept with all their triangles
    partial: Dict[int, int]  # material -> how many of its triangles to keep
    toward: Tuple[float, float, float]  # ... those whose centroids lie nearest this point


# BreakTime: the floor (albedo and normal maps), the walls, the table (albedo
# and normal maps) and the ceiling light whole; the front caps, seen from the
# camera of tools/quality_gate.py, of the metallic-roughness-mapped and the
# albedo-mapped sphere.
BREAKTIME_ONE_TILE = OneTileCut(whole=(0, 1, 2, 5), partial={3: 216, 4: 216},
                                toward=(0.0, 1.8, -3.2))
# VeachMIS: the plates and the backdrop whole, and 460 triangles of the
# emissive spheres (each its own alias entry) nearest the camera.
VEACH_ONE_TILE = OneTileCut(whole=(0, 1, 2, 3, 4), partial={5: 460}, toward=(5.0, 3.0, -10.0))


def keep_triangles(gltf, keep: Sequence[int]):
    """`gltf` with only the triangles `keep` (indices, in that order);
    vertices and materials stay."""
    return dataclasses.replace(gltf, triangles=gltf.triangles[np.asarray(keep, np.int64)])


def one_tile(gltf, cut: OneTileCut):
    """Apply `cut` -> a scene of at most MAX_ONE_TILE triangles, in the
    input's triangle order."""
    tri = gltf.triangles
    keep = np.isin(tri[:, 3], cut.whole)
    centroids = gltf.positions[tri[:, :3]].astype(np.float64).mean(axis=1)
    dist = np.linalg.norm(centroids - np.asarray(cut.toward, np.float64), axis=1)
    for material, count in cut.partial.items():
        ids = np.flatnonzero(tri[:, 3] == material)
        keep[ids[np.argsort(dist[ids], kind="stable")[:count]]] = True
    if keep.sum() > MAX_ONE_TILE:
        raise ValueError(f"the cut keeps {int(keep.sum())} triangles, over {MAX_ONE_TILE}")
    return keep_triangles(gltf, np.flatnonzero(keep))
