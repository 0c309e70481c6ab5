"""Winner-row resolution for the shade kernel on multi-tile scenes (twin
of rustic_tpu/ops/resolve.py `resolve_attrs_rowT`).

The multi-tile scans (K5-K7, K9-K11) return only (t, idx); the
kernel-shade multi-tile loop resolves each winner's slim shading row
between the scan and the shade kernel, transposed to the kernel's
[SLIM_WIDTH, B] rows.

For untextured scenes that is one row gather. The JAX package gathers
the slim columns out of its full [T, 64] table (`_slim_cols`); the port
uploads the slim table itself (scene/world.py `slim_attr_table` applies
the same column map once), so the gather reads whole rows. Its
field-wise form (`resolve_attrs_t`, RUSTIC_RESOLVE=field) exists because
a TPU gather costs per gathered row, and is not ported.

Textured scenes gather the full rows, re-test the winner in f32 for its
barycentrics, blend and wrap the uvs, fetch one bilinear footprint of the
material atlas, map the normal (reference: kernels/src/lib.rs:111-141,
kernels/src/bsdf.rs:354-387), and pack the resolved values into a
synthetic slim row: the mapped shading normal fills all three
vertex-normal slots (the kernel's blend of three equal vectors returns
it, since w_a + w_b + w_c == 1) and the texture-resolved material takes
the SLIM_* slots. The kernel's own re-test still decides the hit and its
backface.
"""

from __future__ import annotations

import torch

from rustic_tpu_torch.ops.intersect import gather_attr_rows
from rustic_tpu_torch.ops.texture import sample_atlas
from rustic_tpu_torch.scene import world as W
from rustic_tpu_torch.scene.atlas import CH_ALBEDO, CH_METAL, CH_NORMAL, CH_ROUGH
from rustic_tpu_torch.ops.flash_intersect import DET_EPS


def resolve_attrs_rowT(scene, feats_t, idx):
    """Winner attr rows for the shade kernel: [SLIM_WIDTH, B] f32.
    feats_t [16, B] (the rays; only the textured branch reads them);
    idx [B] i32, the scan's winners."""
    g = gather_attr_rows(scene, idx)
    if not scene.has_textures:
        return g.T.contiguous()
    return textured_rows(g, scene.atlas, feats_t)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def textured_rows(g, atlas, feats_t):
    """The textured resolve (`_textured_rows` over one row gather): full
    winner rows g [B, 64], rays feats_t [16, B] -> [SLIM_WIDTH, B]."""
    b = g.shape[0]
    rd = (feats_t[0], feats_t[1], feats_t[2])
    ro = (feats_t[6], feats_t[7], feats_t[8])
    pos = [g[:, k] for k in range(9)]
    a3, b3, c3 = tuple(pos[0:3]), tuple(pos[3:6]), tuple(pos[6:9])

    # exact winner re-test for the barycentrics (the kernel repeats it
    # for validity and backface)
    e1 = tuple(y - x for x, y in zip(a3, b3))
    e2 = tuple(y - x for x, y in zip(a3, c3))
    pv = _cross(rd, e2)
    det = _dot(e1, pv)
    good = det.abs() >= DET_EPS
    inv_det = torch.where(good, torch.reciprocal(torch.where(good, det, 1.0)), 0.0)
    tv = tuple(o - x for x, o in zip(a3, ro))
    w_b = _dot(tv, pv) * inv_det
    w_c = _dot(rd, _cross(tv, e1)) * inv_det
    w_a = 1.0 - w_b - w_c

    def blend3(c0):  # the three vertices' xyz at columns c0.. -> 3 rows
        return tuple(w_a * g[:, c0 + k] + w_b * g[:, c0 + 3 + k] + w_c * g[:, c0 + 6 + k]
                     for k in range(3))

    normal = blend3(W.ATTR_NRM.start)

    # uv blend and out-of-range wrap (trace.bounce_pre)
    u0 = W.ATTR_UV.start
    uv0 = w_a * g[:, u0] + w_b * g[:, u0 + 2] + w_c * g[:, u0 + 4]
    uv1 = w_a * g[:, u0 + 1] + w_b * g[:, u0 + 3] + w_c * g[:, u0 + 5]
    oor = (uv0 < 0.0) | (uv0 > 1.0) | (uv1 < 0.0) | (uv1 > 1.0)
    uv0 = torch.where(oor, uv0 - torch.floor(uv0), uv0)
    uv1 = torch.where(oor, uv1 - torch.floor(uv1), uv1)
    uv = torch.stack([uv0, uv1], dim=-1)

    has_tex = g[:, W.ATTR_HASTEX]
    rect = torch.where(
        has_tex[:, 0:1] != 0, g[:, W.ATTR_ALBEDO],
        torch.where(
            has_tex[:, 1:2] != 0, g[:, W.ATTR_METAL],
            torch.where(has_tex[:, 2:3] != 0, g[:, W.ATTR_ROUGH], g[:, W.ATTR_NORMTEX]),
        ),
    )
    tex = sample_atlas(atlas, rect, uv)

    # normal mapping (kernels/src/lib.rs:131-141)
    nm = tex[:, CH_NORMAL] * 2.0 - 1.0
    tangent = blend3(W.ATTR_TAN.start)
    bitangent = _cross(tangent, normal)
    mapped = tuple(
        tangent[k] * nm[:, 0] + bitangent[k] * nm[:, 1] + normal[k] * nm[:, 2] for k in range(3)
    )
    # sampling.normalize: the reciprocal of the clamped length
    inv_len = torch.reciprocal(torch.clamp(torch.sqrt(_dot(mapped, mapped)), min=1e-20))
    has_nm = has_tex[:, 3] != 0
    normal = tuple(torch.where(has_nm, m * inv_len, n) for m, n in zip(mapped, normal))

    # the material (bsdf.material_from_attrs; the kernel applies the EPS
    # clamps itself)
    albedo = tuple(
        torch.where(has_tex[:, 0] != 0, tex[:, CH_ALBEDO.start + k], g[:, W.ATTR_ALBEDO.start + k])
        for k in range(3)
    )
    rough = torch.where(has_tex[:, 2] != 0, tex[:, CH_ROUGH], g[:, W.ATTR_ROUGH.start])
    metal = torch.where(has_tex[:, 1] != 0, tex[:, CH_METAL], g[:, W.ATTR_METAL.start])

    zero = torch.zeros(b, dtype=torch.float32, device=g.device)
    rows = (
        pos + [*normal] * 3
        + [g[:, c] for c in range(W.ATTR_EMISSIVE.start, W.ATTR_EMISSIVE.stop)]
        + [*albedo, rough, metal, g[:, W.ATTR_TRANSMISSION], g[:, W.ATTR_IOR]]
    )
    rows += [zero] * (W.SLIM_WIDTH - len(rows))
    return torch.stack(rows)
