"""Winner-row resolution for the shade kernel on multi-tile scenes (twin
of rustic_tpu/ops/resolve.py `resolve_attrs_rowT`).

The multi-tile scans (K5-K7) return only (t, idx); the kernel-shade
multi-tile loop resolves each winner's slim shading row between the scan
and the shade kernel, transposed to the kernel's [SLIM_WIDTH, B] rows.

For untextured scenes that is one row gather. The JAX package gathers
the slim columns out of its full [T, 64] table (`_slim_cols`); the port
uploads the slim table itself (scene/world.py `slim_attr_table` applies
the same column map once), so the gather reads whole rows. Its
field-wise form (`resolve_attrs_t`, RUSTIC_RESOLVE=field) exists because
a TPU gather costs per gathered row, and is not ported. Textured scenes
need the atlas fetch and normal mapping of the textured branch, not
ported yet.
"""

from __future__ import annotations

from rustic_tpu_torch.ops.intersect import gather_attr_rows
from rustic_tpu_torch.scene.world import TEXTURES_TODO


def resolve_attrs_rowT(scene, feats_t, idx):
    """Winner attr rows for the shade kernel: [SLIM_WIDTH, B] f32.
    feats_t [16, B] (the rays; only the textured branch reads them);
    idx [B] i32, the scan's winners."""
    if scene.has_textures:
        raise NotImplementedError(TEXTURES_TODO)
    return gather_attr_rows(scene, idx).T.contiguous()
