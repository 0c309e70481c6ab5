"""Alias-method light-pick table: a NumPy port of
rustic_tpu/scene/light_table.py (reference: src/light_pick.rs:24-122).

A single sentinel entry (ratio = -1) marks a scene without lights.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LightTable:
    idx_a: np.ndarray  # [L] int32 triangle index (post-BVH-reorder)
    area_a: np.ndarray  # [L] float32
    pdf_a: np.ndarray  # [L] float32 (probability of picking this triangle)
    idx_b: np.ndarray  # [L] int32
    area_b: np.ndarray  # [L] float32
    pdf_b: np.ndarray  # [L] float32
    ratio: np.ndarray  # [L] float32; < 0 => sentinel (no lights)

    def __len__(self) -> int:
        return len(self.ratio)

    @property
    def is_sentinel(self) -> bool:
        return bool(self.ratio[0] < 0.0)


def triangle_areas(va: np.ndarray, vb: np.ndarray, vc: np.ndarray) -> np.ndarray:
    """Heron's-formula triangle areas (reference: src/light_pick.rs:5-11)."""
    la = np.linalg.norm(vb - va, axis=-1)
    lb = np.linalg.norm(vc - vb, axis=-1)
    lc = np.linalg.norm(va - vc, axis=-1)
    s = (la + lb + lc) / 2.0
    return np.sqrt(np.maximum(s * (s - la) * (s - lb) * (s - lc), 0.0))


def compute_emissive_mask(triangles: np.ndarray, emissive: np.ndarray) -> np.ndarray:
    """Triangles whose material emits (reference: src/light_pick.rs:13-21)."""
    return np.any(emissive[triangles[:, 3], :3] != 0.0, axis=-1)


def _sentinel() -> LightTable:
    zi = np.zeros(1, np.int32)
    zf = np.zeros(1, np.float32)
    return LightTable(
        idx_a=zi, area_a=zf, pdf_a=zf.copy(), idx_b=zi.copy(),
        area_b=zf.copy(), pdf_b=zf.copy(), ratio=np.full(1, -1.0, np.float32),
    )


def build_light_table(
    vertices: np.ndarray,
    triangles: np.ndarray,
    mask: np.ndarray,
    emissive: np.ndarray,
) -> LightTable:
    verts = np.asarray(vertices, np.float64)[:, :3]
    tris = np.asarray(triangles, np.int64)

    areas = np.zeros(len(tris))
    powers = np.zeros(len(tris))
    lit = np.nonzero(mask)[0]
    if len(lit) == 0:
        return _sentinel()

    va = verts[tris[lit, 0]]
    vb = verts[tris[lit, 1]]
    vc = verts[tris[lit, 2]]
    areas[lit] = triangle_areas(va, vb, vc)
    # power = (r+g+b of emission) * area (reference: src/light_pick.rs:49)
    powers[lit] = emissive[tris[lit, 3], :3].sum(axis=-1) * areas[lit]
    total_power = powers.sum()
    if total_power <= 0.0:
        return _sentinel()

    probs = powers / total_power
    # one bin per emitting triangle, ascending by probability; zero-power
    # lights are dropped (reference: src/light_pick.rs:73-88)
    order = lit[np.argsort(probs[lit], kind="stable")]
    order = order[probs[order] > 0.0]
    if len(order) == 0:
        return _sentinel()

    n_bins = len(order)
    index_a = order.copy()
    index_b = index_a.copy()  # self-alias for never-donated bins

    # Full alias construction (Vose), as the JAX package builds it: the
    # effective pick distribution equals the stored pdfs.
    q = probs[order] / probs[order].sum() * n_bins
    ratio = np.ones(n_bins)
    small = [i for i in range(n_bins) if q[i] < 1.0]
    large = [i for i in range(n_bins) if q[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        ratio[s] = q[s]
        index_b[s] = index_a[l]
        q[l] -= 1.0 - q[s]
        (small if q[l] < 1.0 else large).append(l)

    return LightTable(
        idx_a=index_a.astype(np.int32),
        area_a=areas[index_a].astype(np.float32),
        pdf_a=probs[index_a].astype(np.float32),
        idx_b=index_b.astype(np.int32),
        area_b=areas[index_b].astype(np.float32),
        pdf_b=probs[index_b].astype(np.float32),
        ratio=ratio.astype(np.float32),
    )
