"""Binned-SAH BVH builder: the port of rustic_tpu/scene/bvh.py (`BVH`,
`build_bvh`, `_build_bvh_numpy`, `validate_bvh`) and of
rustic_tpu/scene/bvh_native.py.

The triangle permutation fixes the flash tile layout and every winner
index, and the nodes are what the "bvh" engine traverses
(ops/intersect.py `intersect_bvh`, kernel K20). The JAX package builds
them with its C++ builder (native/bvh.cpp) by default and with NumPy
otherwise; the two give different permutations. The port carries both:
`build_bvh` runs csrc/bvh_build.cpp, a copy of native/bvh.cpp built by
g++ at first use with the JAX package's flags (ops/_build.py
`compile_host`), and with `use_native=False` `_build_bvh_numpy`, the
same algorithm step for step as the JAX NumPy builder. One departure:
where JAX falls back to NumPy without a word when the C++ builder cannot
be built, the port raises with the compiler's message (a silent fallback
would change every film).

Nodes are a struct of arrays (aabb_min [N, 3], aabb_max [N, 3],
left_first [N], count [N]), as in the JAX package; `node_records` packs
them into the traversal kernel's records.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import numpy as np

from rustic_tpu_torch.ops import _build

_INF = np.float32(np.inf)


@dataclasses.dataclass
class BVH:
    """Flattened binary BVH. Node 0 is the root; children are (left,
    left + 1). A node is a leaf iff count > 0, and then left_first is the
    index of its first triangle in the reordered triangle buffer."""

    aabb_min: np.ndarray  # [N, 3] float32
    aabb_max: np.ndarray  # [N, 3] float32
    left_first: np.ndarray  # [N] int32: left child (internal) / first triangle (leaf)
    count: np.ndarray  # [N] int32: 0 for internal nodes

    @property
    def n_nodes(self) -> int:
        return len(self.count)


def _node_area(lo: np.ndarray, hi: np.ndarray) -> float:
    e = hi - lo
    if not np.all(np.isfinite(e)):
        return 0.0
    return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])


def build_bvh(
    vertices: np.ndarray, triangles: np.ndarray, sah_samples: int = 128, use_native: bool = True
) -> tuple[BVH, np.ndarray]:
    """Build a binned-SAH BVH over [T, 4] (i0, i1, i2, material) triangles
    -> (the nodes, the permutation mapping the BVH triangle order to the
    old triangle index) (reference: src/bvh.rs:178-324). `use_native`:
    the C++ builder (the JAX package's default order), else NumPy."""
    if len(triangles) == 0:
        raise ValueError("scene has no triangle geometry (cameras/lights only?)")
    if use_native:
        return _build_bvh_native(vertices, triangles, sah_samples)
    return _build_bvh_numpy(vertices, triangles, sah_samples)


@functools.lru_cache(maxsize=None)
def _native_library() -> ctypes.CDLL:
    """csrc/bvh_build.cpp, built if needed, with `bvh_build` declared as
    rustic_tpu/scene/bvh_native.py declares it."""
    lib = ctypes.CDLL(_build.compile_host(os.path.join(_build.CSRC, "bvh_build.cpp")))
    f32, i32 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    lib.bvh_build.restype = ctypes.c_int
    # vertices [V*3], V, triangle vertex indices [T*3], T, sah_samples, out aabb_min
    # [(2T-1)*3], aabb_max, left_first, count, permutation [T]
    lib.bvh_build.argtypes = [f32, ctypes.c_int, i32, ctypes.c_int, ctypes.c_int, f32, f32, i32,
                              i32, i32]
    return lib


def _build_bvh_native(vertices, triangles, sah_samples: int) -> tuple[BVH, np.ndarray]:
    """`build_bvh` through the C++ builder (rustic_tpu/scene/bvh_native.py
    `build_bvh`)."""
    lib = _native_library()
    verts = np.ascontiguousarray(np.asarray(vertices, np.float32)[:, :3])
    tri = np.ascontiguousarray(np.asarray(triangles, np.int32)[:, :3])
    n_tris = len(tri)
    max_nodes = max(2 * n_tris - 1, 1)
    aabb_min = np.empty((max_nodes, 3), np.float32)
    aabb_max = np.empty((max_nodes, 3), np.float32)
    left_first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    perm = np.empty(n_tris, np.int32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(
            ctypes.c_float if a.dtype == np.float32 else ctypes.c_int))

    n_nodes = lib.bvh_build(ptr(verts), len(verts), ptr(tri), n_tris, sah_samples, ptr(aabb_min),
                            ptr(aabb_max), ptr(left_first), ptr(count), ptr(perm))
    if n_nodes <= 0:
        raise RuntimeError(f"the native BVH builder failed ({n_nodes}) on {n_tris} triangles, "
                           f"{sah_samples} SAH bins")
    bvh = BVH(aabb_min=aabb_min[:n_nodes].copy(), aabb_max=aabb_max[:n_nodes].copy(),
              left_first=left_first[:n_nodes].copy(), count=count[:n_nodes].copy())
    return bvh, perm.astype(np.int64)


def _build_bvh_numpy(vertices, triangles, sah_samples: int) -> tuple[BVH, np.ndarray]:
    """`build_bvh` in NumPy (rustic_tpu/scene/bvh.py `_build_bvh_numpy`)."""
    verts = np.asarray(vertices, np.float32)[:, :3]
    tris = np.asarray(triangles, np.int64)
    n_tris = len(tris)

    va = verts[tris[:, 0]]
    vb = verts[tris[:, 1]]
    vc = verts[tris[:, 2]]
    tri_min = np.minimum(np.minimum(va, vb), vc)
    tri_max = np.maximum(np.maximum(va, vb), vc)
    centroids = (va + vb + vc) / 3.0

    perm = np.arange(n_tris)
    max_nodes = max(2 * n_tris - 1, 1)
    aabb_min = np.full((max_nodes, 3), _INF, np.float32)
    aabb_max = np.full((max_nodes, 3), -_INF, np.float32)
    left_first = np.zeros(max_nodes, np.int32)
    count = np.zeros(max_nodes, np.int32)
    count[0] = n_tris
    aabb_min[0] = tri_min.min(axis=0)
    aabb_max[0] = tri_max.max(axis=0)

    def area(lo_, hi_):
        e = np.maximum(hi_ - lo_, 0.0)
        e = np.where(np.isfinite(e), e, 0.0)
        return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]

    node_count = 1
    stack = [0]
    while stack:
        node = stack.pop()
        first = int(left_first[node])
        n = int(count[node])
        sl = slice(first, first + n)
        cen = centroids[sl]
        tmin = tri_min[sl]
        tmax = tri_max[sl]

        best_cost = np.inf
        best_axis = -1
        best_split = 0.0
        for axis in range(3):
            c = cen[:, axis]
            lo = float(c.min())
            hi = float(c.max())
            if lo == hi:
                continue
            # bin triangles (reference: src/bvh.rs:199-218)
            scale = sah_samples / (hi - lo)
            seg = np.minimum(((c - lo) * scale).astype(np.int64), sah_samples - 1)
            bin_min = np.full((sah_samples, 3), _INF, np.float32)
            bin_max = np.full((sah_samples, 3), -_INF, np.float32)
            np.minimum.at(bin_min, seg, tmin)
            np.maximum.at(bin_max, seg, tmax)
            bin_n = np.bincount(seg, minlength=sah_samples)

            # prefix/suffix sweeps (reference: src/bvh.rs:221-240)
            lmin = np.minimum.accumulate(bin_min[:-1], axis=0)
            lmax = np.maximum.accumulate(bin_max[:-1], axis=0)
            rmin = np.minimum.accumulate(bin_min[:0:-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bin_max[:0:-1], axis=0)[::-1]
            lcnt = np.cumsum(bin_n[:-1])
            rcnt = np.cumsum(bin_n[:0:-1])[::-1]

            cost = lcnt * area(lmin, lmax) + rcnt * area(rmin, rmax)
            # empty-side planes must not win (reference: src/bvh.rs:132-137)
            cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
            i = int(np.argmin(cost))
            if cost[i] < best_cost:
                best_cost = float(cost[i])
                best_axis = axis
                best_split = lo + (hi - lo) / sah_samples * (i + 1)

        # leaf if splitting is not cheaper (reference: src/bvh.rs:274-277)
        parent_cost = _node_area(aabb_min[node], aabb_max[node]) * n
        if best_axis < 0 or parent_cost <= best_cost:
            continue

        mask = cen[:, best_axis] < best_split
        n_left = int(mask.sum())
        if n_left == 0 or n_left == n:
            continue

        order = np.concatenate([np.nonzero(mask)[0], np.nonzero(~mask)[0]]) + first
        perm[sl] = perm[order]
        centroids[sl] = centroids[order]
        tri_min[sl] = tri_min[order]
        tri_max[sl] = tri_max[order]

        left = node_count
        right = node_count + 1
        node_count += 2
        left_first[node] = left
        count[node] = 0
        left_first[left] = first
        count[left] = n_left
        left_first[right] = first + n_left
        count[right] = n - n_left
        aabb_min[left] = tri_min[first : first + n_left].min(axis=0)
        aabb_max[left] = tri_max[first : first + n_left].max(axis=0)
        aabb_min[right] = tri_min[first + n_left : first + n].min(axis=0)
        aabb_max[right] = tri_max[first + n_left : first + n].max(axis=0)
        stack.append(right)
        stack.append(left)

    bvh = BVH(
        aabb_min=aabb_min[:node_count].copy(),
        aabb_max=aabb_max[:node_count].copy(),
        left_first=left_first[:node_count].copy(),
        count=count[:node_count].copy(),
    )
    return bvh, perm


def validate_bvh(bvh: BVH, tri_min: np.ndarray, tri_max: np.ndarray) -> None:
    """Check the BVH's invariants: every leaf's box contains its
    triangles, internal boxes contain their children, and the leaves
    partition the triangle array exactly. Raises ValueError."""
    seen = np.zeros(len(tri_min), bool)
    stack = [0]
    while stack:
        node = stack.pop()
        lo, hi = bvh.aabb_min[node], bvh.aabb_max[node]
        if bvh.count[node] > 0:
            sl = slice(int(bvh.left_first[node]), int(bvh.left_first[node] + bvh.count[node]))
            if seen[sl].any():
                raise ValueError(f"node {node}: leaf ranges overlap")
            seen[sl] = True
            if not (np.all(tri_min[sl] >= lo - 1e-4) and np.all(tri_max[sl] <= hi + 1e-4)):
                raise ValueError(f"node {node}: leaf box does not contain its triangles")
        else:
            left = int(bvh.left_first[node])
            for child in (left, left + 1):
                if not (np.all(bvh.aabb_min[child] >= lo - 1e-4)
                        and np.all(bvh.aabb_max[child] <= hi + 1e-4)):
                    raise ValueError(f"node {child}: box not inside its parent's")
                stack.append(child)
    if not seen.all():
        raise ValueError("some triangles are not referenced by any leaf")


def node_records(bvh: BVH) -> tuple[np.ndarray, int, int]:
    """The node table of the traversal kernel (csrc/bvh_traverse.cu, K20)
    -> (records [base + N, 8] float32, base, cbits).

    Node n is record base + n, {lo.xyz, left_first, hi.xyz, count}, a bit
    copy of the struct of arrays (the two ints' bits stored as they are).
    Children come in pairs (left, left + 1), and both builders put the
    first pair at node 1: then base = 1, a pad record of zeros ahead of
    the root, so that every pair starts at an even record and is one
    64-byte line of the (64-byte aligned) table; base = 0 where the pairs
    start at even nodes. A node's stack entry is left_first << cbits |
    count in 32 bits, cbits the width of the largest count. Raises
    ValueError where a count or left_first is negative or the entry does
    not fit, where the pairs are not all of one parity, or where a pair
    lies beyond the nodes."""
    lf = np.asarray(bvh.left_first, np.int32).reshape(-1)
    cnt = np.asarray(bvh.count, np.int32).reshape(-1)
    n = len(cnt)
    if n == 0:
        return np.zeros((0, 8), np.float32), 0, 1
    if (lf < 0).any() or (cnt < 0).any():
        raise ValueError("a BVH node has a negative left_first or count")
    cbits = max(1, int(cnt.max()).bit_length())
    if int(lf.max()) >= 1 << (32 - cbits) or int((lf.astype(np.int64) + cnt).max()) >= 1 << 31:
        raise ValueError(f"the BVH's sizes overflow the traversal's 32-bit stack entry: "
                         f"left_first up to {int(lf.max())} << {cbits} bits of count")
    lefts = lf[cnt == 0].astype(np.int64)
    if (lefts + 1 >= n).any():
        raise ValueError("a BVH child pair lies beyond the nodes")
    base = int(lefts[0] % 2) if len(lefts) else 0
    if ((lefts + base) % 2).any():
        raise ValueError("the BVH's child pairs do not all start at nodes of one parity")
    rec = np.zeros((base + n, 8), np.float32)
    rec[base:, 0:3] = np.asarray(bvh.aabb_min, np.float32).reshape(n, 3)
    rec[base:, 3] = lf.view(np.float32)
    rec[base:, 4:7] = np.asarray(bvh.aabb_max, np.float32).reshape(n, 3)
    rec[base:, 7] = cnt.view(np.float32)
    return rec, base, cbits
