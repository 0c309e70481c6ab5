"""The "bvh" engine's traversal on the card: kernels K20n (nearest hit)
and K20a (any hit), csrc/bvh_traverse.cu: persistent warps over the
scene's packed node and triangle records (`SceneTensors.bvh_nodes`,
`bvh_tris`, built at upload by scene/bvh.py `node_records` and
scene/world.py `triangle_records`).

Counterpart of the XLA while_loop of rustic_tpu/ops/intersect.py
`_intersect_bvh_impl` (not a Pallas kernel). Its plain version is
ops/intersect.py `bvh_traverse_plain`, the JAX package's lockstep loop
over masks in torch, which the wrappers run on a CPU tensor; the kernel
gives its results bit for bit (each lane's steps depend on that lane
alone, and the kernel keeps their order).
"""

from __future__ import annotations

import torch

from rustic_tpu_torch.ops import _build
from rustic_tpu_torch.ops import intersect as I

LAUNCHES = {"bvh_nearest": 0, "bvh_occluded": 0}

# entry points of csrc/bvh_traverse.cu: (name, pointers, ints)
_ENTRY = {
    "bvh_nearest": ("rt_bvh_nearest", 11, 4),
    "bvh_occluded": ("rt_bvh_occluded", 7, 4),
}
_ALIGN = 64  # bytes: a child pair of node records is one aligned line


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _checked_tables(scene, ro, rd):
    """(node records, triangle records, ints after the pointers' batch)
    that the kernel reads, checked against the rays."""
    if not I.has_bvh(scene):
        raise ValueError('the scene carries no BVH nodes: the "bvh" engine cannot trace it')
    nodes, tris = getattr(scene, "bvh_nodes", None), getattr(scene, "bvh_tris", None)
    n = scene.bvh_count.shape[0]
    if nodes is None or tris is None or nodes.shape[0] != scene.bvh_node_base + n:
        raise ValueError("the scene carries no packed BVH tables for its nodes "
                         "(SceneTensors.bvh_nodes, bvh_tris: built at upload)")
    dev = ro.device
    b = ro.shape[0]
    _build.check(ro, "ro", torch.float32, (b, 3), dev)
    _build.check(rd, "rd", torch.float32, (b, 3), dev)
    _build.check(nodes, "bvh_nodes", torch.float32, (scene.bvh_node_base + n, 8), dev)
    _build.check(tris, "bvh_tris", torch.float32, (scene.n_tris, 12), dev)
    if nodes.data_ptr() % _ALIGN:
        raise ValueError(f"bvh_nodes must be {_ALIGN}-byte aligned")
    if b >= 1 << 30:
        raise ValueError(f"{b} rays: the kernel's ray counter takes fewer than 2^30")
    return nodes, tris, (scene.bvh_node_base, scene.bvh_count_bits, scene.n_tris)


def _launch(name, dev, tensors, ints):
    _build.launch(_build.entry_point("bvh_traverse", *_ENTRY[name]), name, dev, tensors, ints)
    LAUNCHES[name] += 1


def bvh_nearest(scene, ro, rd) -> "I.TraceResult":
    """K20n: the nearest hit of rays ro, rd [B, 3] through the scene's BVH
    -> TraceResult (t, tri_idx, hit, backface, u, v)."""
    if _build.uses_plain(ro):
        return I.bvh_traverse_plain(scene, ro, rd)
    nodes, tris, ints = _checked_tables(scene, ro, rd)
    b = ro.shape[0]
    dev = ro.device
    t = torch.empty(b, dtype=torch.float32, device=dev)
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    hit = torch.empty(b, dtype=torch.bool, device=dev)
    back = torch.empty(b, dtype=torch.bool, device=dev)
    u = torch.empty(b, dtype=torch.float32, device=dev)
    v = torch.empty(b, dtype=torch.float32, device=dev)
    if b:
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        _launch("bvh_nearest", dev, (ro, rd, nodes, tris, counter, t, idx, hit, back, u, v),
                (b, *ints))
    return I.TraceResult(t, idx, hit, back, u, v)


def bvh_occluded(scene, ro, rd, max_t) -> torch.Tensor:
    """K20a: whether each ray hits a triangle within (EPS, max_t] -> [B]
    bool."""
    if _build.uses_plain(ro):
        return I.bvh_traverse_plain(scene, ro, rd, max_t).hit
    nodes, tris, ints = _checked_tables(scene, ro, rd)
    b = ro.shape[0]
    dev = ro.device
    _build.check(max_t, "max_t", torch.float32, (b,), dev)
    hit = torch.empty(b, dtype=torch.bool, device=dev)
    if b:
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        _launch("bvh_occluded", dev, (ro, rd, max_t, nodes, tris, counter, hit), (b, *ints))
    return hit
