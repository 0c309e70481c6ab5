"""Ray features and the exact winner re-test around the flash scans
(twin of the flash-engine part of rustic_tpu/ops/intersect.py).

A scan returns each ray's winning triangle (t, index); the consumer
gathers the winner's slim shading row and re-tests that one triangle in
exact f32 (Möller–Trumbore, reference: kernels/src/intersection.rs:9-54)
to get u, v, the backface flag and the final t. Under the port's "f32"
plan a scan carries no second candidate.

Unlike the JAX package, ray features are [16, B] rows (the layout the
scan kernels read coalesced); everything else is lane-major.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rustic_tpu_torch.ops.flash_intersect import BIG, DET_EPS
from rustic_tpu_torch.ops.sampling import EPS, cross


class TraceResult(NamedTuple):
    t: torch.Tensor  # [B] f32, BIG when missed
    tri_idx: torch.Tensor  # [B] i32
    hit: torch.Tensor  # [B] bool
    backface: torch.Tensor  # [B] bool
    u: torch.Tensor  # [B] f32 barycentric weight of vertex b
    v: torch.Tensor  # [B] f32 barycentric weight of vertex c


def _ray_features16(ro, rd, maxt=None):
    """[B, 3] rays -> [16, B] feature rows [rd, ro×rd, ro, 1, maxt or 0, 0...]."""
    b = ro.shape[0]
    dev = ro.device
    rows = [rd.T, cross(ro, rd).T, ro.T, torch.ones((1, b), dtype=torch.float32, device=dev)]
    if maxt is not None:
        rows.append(maxt[None, :])
    n_used = 10 if maxt is None else 11
    rows.append(torch.zeros((16 - n_used, b), dtype=torch.float32, device=dev))
    return torch.cat(rows, dim=0)


def _sum3(x):
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _mt_single(a, b, c, ro, rd):
    """Möller–Trumbore for one triangle per lane
    (reference: kernels/src/intersection.rs:9-54)."""
    e1 = b - a
    e2 = c - a
    pv = cross(rd, e2)
    det = _sum3(e1 * pv)
    backface = det < 0.0
    good = det.abs() >= DET_EPS
    inv_det = torch.where(good, torch.reciprocal(torch.where(good, det, 1.0)), 0.0)
    tv = ro - a
    u = _sum3(tv * pv) * inv_det
    qv = cross(tv, e1)
    v = _sum3(rd * qv) * inv_det
    t = _sum3(e2 * qv) * inv_det
    valid = good & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
    return t, u, v, backface, valid


def refine_from_attrs(attrs, ro, rd):
    """Exact f32 Möller–Trumbore of each lane's candidate, whose vertices
    are columns 0:9 of its shading row."""
    return _mt_single(attrs[:, 0:3], attrs[:, 3:6], attrs[:, 6:9], ro, rd)


def gather_attr_rows(scene, idx):
    """The winning triangles' shading rows [B, SLIM_WIDTH]: one row gather."""
    n = scene.tri_attrs.shape[0]
    return scene.tri_attrs[torch.clamp(idx, 0, n - 1).long()]


def classify_flash_hit(t_kernel, idx, attrs, ro, rd):
    """A scan's winner -> exact TraceResult: a winner the exact re-test
    rejects is a miss."""
    t2, u, v, backface, valid = refine_from_attrs(attrs, ro, rd)
    hit = (t_kernel < BIG) & valid
    return TraceResult(torch.where(hit, t2, BIG), idx, hit, backface & hit, u, v)


def classify_flash_hit2(t1k, i1, attrs1, t2k, i2, attrs2, ro, rd):
    """The nearer valid of a top-2 candidate pair, or `classify_flash_hit`
    when the scan carried no second candidate (the port's "f32" plan
    never does) -> (TraceResult, the chosen attr rows)."""
    if t2k is None:
        return classify_flash_hit(t1k, i1, attrs1, ro, rd), attrs1
    ta, ua, va, bfa, vala = refine_from_attrs(attrs1, ro, rd)
    tb, ub, vb, bfb, valb = refine_from_attrs(attrs2, ro, rd)
    hita = (t1k < BIG) & vala
    hitb = (t2k < BIG) & valb
    useb = hitb & (~hita | (tb < ta))
    hit = hita | hitb
    res = TraceResult(
        torch.where(hit, torch.where(useb, tb, ta), BIG),
        torch.where(useb, i2, i1),
        hit,
        torch.where(useb, bfb, bfa) & hit,
        torch.where(useb, ub, ua),
        torch.where(useb, vb, va),
    )
    return res, torch.where(useb[:, None], attrs2, attrs1)
