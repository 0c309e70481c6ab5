"""The "bvh" engine's traversal on the card: kernels K20n (nearest hit)
and K20a (any hit), csrc/bvh_traverse.cu, one thread a ray.

Counterpart of the XLA while_loop of rustic_tpu/ops/intersect.py
`_intersect_bvh_impl` (not a Pallas kernel). Its plain version is
ops/intersect.py `bvh_traverse_plain`, the JAX package's lockstep loop
over masks in torch, which the wrappers run on a CPU tensor; the kernel
gives its results bit for bit (each lane's steps depend on that lane
alone).
"""

from __future__ import annotations

import torch

from rustic_tpu_torch.ops import _build
from rustic_tpu_torch.ops import intersect as I

LAUNCHES = {"bvh_nearest": 0, "bvh_occluded": 0}

# entry points of csrc/bvh_traverse.cu: (name, pointers, ints)
_ENTRY = {
    "bvh_nearest": ("rt_bvh_nearest", 13, 3),
    "bvh_occluded": ("rt_bvh_occluded", 9, 3),
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _checked_scene(scene, ro, rd):
    """The node and row tensors the kernel reads, checked against the rays."""
    if not I.has_bvh(scene):
        raise ValueError('the scene carries no BVH nodes: the "bvh" engine cannot trace it')
    dev = ro.device
    b = ro.shape[0]
    n = scene.bvh_count.shape[0]
    _build.check(ro, "ro", torch.float32, (b, 3), dev)
    _build.check(rd, "rd", torch.float32, (b, 3), dev)
    _build.check(scene.bvh_min, "bvh_min", torch.float32, (n, 3), dev)
    _build.check(scene.bvh_max, "bvh_max", torch.float32, (n, 3), dev)
    _build.check(scene.bvh_left_first, "bvh_left_first", torch.int32, (n,), dev)
    _build.check(scene.bvh_count, "bvh_count", torch.int32, (n,), dev)
    rows = scene.tri_attrs
    _build.check(rows, "tri_attrs", torch.float32, tuple(rows.shape), dev)
    if rows.shape[0] < scene.n_tris or rows.shape[1] < 9:
        raise ValueError(f"tri_attrs {tuple(rows.shape)} lacks the vertices of "
                         f"{scene.n_tris} triangles")
    return (scene.bvh_min, scene.bvh_max, scene.bvh_left_first, scene.bvh_count, rows)


def _launch(name, dev, tensors, ints):
    _build.launch(_build.entry_point("bvh_traverse", *_ENTRY[name]), name, dev, tensors, ints)
    LAUNCHES[name] += 1


def bvh_nearest(scene, ro, rd) -> "I.TraceResult":
    """K20n: the nearest hit of rays ro, rd [B, 3] through the scene's BVH
    -> TraceResult (t, tri_idx, hit, backface, u, v)."""
    if _build.uses_plain(ro):
        return I.bvh_traverse_plain(scene, ro, rd)
    nodes = _checked_scene(scene, ro, rd)
    b = ro.shape[0]
    dev = ro.device
    t = torch.empty(b, dtype=torch.float32, device=dev)
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    hit = torch.empty(b, dtype=torch.bool, device=dev)
    back = torch.empty(b, dtype=torch.bool, device=dev)
    u = torch.empty(b, dtype=torch.float32, device=dev)
    v = torch.empty(b, dtype=torch.float32, device=dev)
    if b:
        _launch("bvh_nearest", dev, (ro, rd, *nodes, t, idx, hit, back, u, v),
                (b, nodes[-1].shape[1], scene.n_tris))
    return I.TraceResult(t, idx, hit, back, u, v)


def bvh_occluded(scene, ro, rd, max_t) -> torch.Tensor:
    """K20a: whether each ray hits a triangle within (EPS, max_t] -> [B]
    bool."""
    if _build.uses_plain(ro):
        return I.bvh_traverse_plain(scene, ro, rd, max_t).hit
    nodes = _checked_scene(scene, ro, rd)
    b = ro.shape[0]
    dev = ro.device
    _build.check(max_t, "max_t", torch.float32, (b,), dev)
    hit = torch.empty(b, dtype=torch.bool, device=dev)
    if b:
        _launch("bvh_occluded", dev, (ro, rd, max_t, *nodes, hit),
                (b, nodes[-1].shape[1], scene.n_tris))
    return hit
