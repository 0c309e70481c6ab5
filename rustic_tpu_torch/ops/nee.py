"""Next-event estimation (twin of rustic_tpu/ops/nee.py): alias-table
light picking, direct light sampling with shadow-ray requests, and the
MIS carry across bounces (reference: kernels/src/light_pick.rs).

Every lane picks a light, samples a point on it and builds a shadow ray;
the caller resolves the ray's visibility with a flash scan.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rustic_tpu_torch.config import NextEventEstimation
from rustic_tpu_torch.ops import bsdf as bsdf_mod
from rustic_tpu_torch.ops import sampling as s
from rustic_tpu_torch.scene import world as W


class DirectLightSample(NamedTuple):
    """One bounce's direct-light sample (reference: kernels/src/light_pick.rs:89-98)."""

    light_area: torch.Tensor  # [B]
    light_normal: torch.Tensor  # [B, 3]
    light_pick_pdf: torch.Tensor  # [B]
    light_emission: torch.Tensor  # [B, 3]
    light_triangle_index: torch.Tensor  # [B] i32
    throughput: torch.Tensor  # [B, 3]
    contribution: torch.Tensor  # [B, 3]


class MISCarry(NamedTuple):
    """The BSDF side of MIS carried to the next bounce, pre-reduced when
    the light is sampled (see rustic_tpu/ops/nee.py MISCarry)."""

    vec: torch.Tensor  # [B, 3] throughput*spectrum*emission/(pdf*pick_pdf)
    area_cos: torch.Tensor  # [B] light_area * cos(light_normal, -bounce_dir)
    pdf: torch.Tensor  # [B] BSDF sample pdf
    tri: torch.Tensor  # [B] i32 sampled light's global triangle index

    @classmethod
    def zeros(cls, batch: int, device) -> "MISCarry":
        z = torch.zeros(batch, dtype=torch.float32, device=device)
        return cls(
            vec=torch.zeros((batch, 3), dtype=torch.float32, device=device),
            area_cos=z,
            pdf=z,
            tri=torch.zeros(batch, dtype=torch.int32, device=device),
        )


def resolve_entry(row, r2):
    """Resolve fetched entry rows [B, ENTRY_WIDTH] into the picked
    light's fields: the second half of the alias pick
    (reference: kernels/src/light_pick.rs:11-15)."""
    take = s.expand_mask(r2 < row[:, W.ENTRY_RATIO])

    def sel(a_sl, b_sl):
        return torch.where(take, row[:, a_sl], row[:, b_sl])

    def sca(a, b):
        return sel(slice(a, a + 1), slice(b, b + 1))[:, 0]

    verts = sel(W.ENTRY_A_VERTS, W.ENTRY_B_VERTS)
    return {
        "area": sca(W.ENTRY_AREA_A, W.ENTRY_AREA_B),
        "pdf": sca(W.ENTRY_PDF_A, W.ENTRY_PDF_B),
        "va": verts[:, 0:3],
        "vb": verts[:, 3:6],
        "vc": verts[:, 6:9],
        "normal": sel(W.ENTRY_A_NORMAL, W.ENTRY_B_NORMAL),
        "emission": sel(W.ENTRY_A_EMISSION, W.ENTRY_B_EMISSION),
        "tri_idx": sca(W.ENTRY_A_TRI, W.ENTRY_B_TRI).to(torch.int32),
    }


# Alias tables at or below this many entries are resolved by a select-sum
# over the table rows instead of a row gather (as the JAX package does).
ENTRY_SELECT_MAX = 16


def resolve_entry_fields(scene, entry, r2):
    """The picked light's fields for alias entries `entry` [B] i32: a row
    gather for big tables, a per-entry select-sum for small ones (the
    sum adds exact zeros, so both give the same values)."""
    n = scene.n_alias_entries
    if n > ENTRY_SELECT_MAX:
        return resolve_entry(scene.entry_rows[entry.long()], r2)

    specs = {
        "area": (W.ENTRY_AREA_A, W.ENTRY_AREA_B),
        "pdf": (W.ENTRY_PDF_A, W.ENTRY_PDF_B),
        "verts": (W.ENTRY_A_VERTS, W.ENTRY_B_VERTS),
        "normal": (W.ENTRY_A_NORMAL, W.ENTRY_B_NORMAL),
        "emission": (W.ENTRY_A_EMISSION, W.ENTRY_B_EMISSION),
        "tri": (W.ENTRY_A_TRI, W.ENTRY_B_TRI),
    }

    def zeros_like_row(sl):
        shape = entry.shape + ((sl.stop - sl.start,) if isinstance(sl, slice) else ())
        return torch.zeros(shape, dtype=torch.float32, device=entry.device)

    acc = {name: zeros_like_row(a) for name, (a, _) in specs.items()}
    for k in range(n):
        row = scene.entry_rows[k]  # [ENTRY_WIDTH]: broadcasts, no gather
        use = entry == k
        take = use & (r2 < row[W.ENTRY_RATIO])
        for name, (a_sl, b_sl) in specs.items():
            vec = isinstance(a_sl, slice)
            v = torch.where(take[:, None] if vec else take, row[a_sl], row[b_sl])
            acc[name] = acc[name] + torch.where(use[:, None] if vec else use, v, 0.0)
    verts = acc["verts"]
    return {
        "area": acc["area"],
        "pdf": acc["pdf"],
        "va": verts[:, 0:3],
        "vb": verts[:, 3:6],
        "vc": verts[:, 6:9],
        "normal": acc["normal"],
        "emission": acc["emission"],
        "tri_idx": acc["tri"].to(torch.int32),
    }


def pick_triangle_point(a, b, c, r1, r2):
    """Uniform point on a triangle via the sqrt warp
    (reference: kernels/src/light_pick.rs:19-23)."""
    r1_sqrt = torch.sqrt(r1)[..., None]
    r2e = r2[..., None]
    return (1.0 - r1_sqrt) * a + (r1_sqrt * (1.0 - r2e)) * b + (r1_sqrt * r2e) * c


def light_pdf_area_to_solid_angle(light_area, light_distance, light_normal, light_direction):
    """r^2 / (A cos), 0 when the light faces away
    (reference: kernels/src/light_pick.rs:30-79)."""
    cos_theta = s.dot(light_normal, -light_direction)
    pdf = (light_distance * light_distance) / torch.clamp(light_area * cos_theta, min=1e-20)
    return torch.where(cos_theta > 0.0, pdf, 0.0)


def _mis_weight(nee: NextEventEstimation, p1, p2):
    """(reference: kernels/src/light_pick.rs:81-87)"""
    if nee == NextEventEstimation.MIS:
        return s.power_heuristic(p1, p2)
    return torch.ones_like(p1)


def prepare_direct_lighting(
    scene, nee: NextEventEstimation, mat: bsdf_mod.PBRMaterial, throughput,
    surface_point, surface_normal, ray_direction, r,
):
    """Direct-lighting candidate for every lane before the visibility
    test (reference: kernels/src/light_pick.rs:100-173 without its
    intersect_any). `r` is a tuple of 4 draws, each [B]. Returns
    (DirectLightSample with the unoccluded contribution,
     (shadow_ro, shadow_rd, shadow_maxt, geometric_ok))."""
    r1, r2, r3, r4 = r
    n = scene.n_alias_entries
    entry = torch.clamp((r1 * n).to(torch.int32), 0, n - 1)
    light = resolve_entry_fields(scene, entry, r2)
    light_area = light["area"]
    light_pick_pdf = light["pdf"]
    light_normal = light["normal"]  # flat-shaded (kernels/src/light_pick.rs:129)
    light_emission = light["emission"]

    light_point = pick_triangle_point(light["va"], light["vb"], light["vc"], r3, r4)
    delta = light_point - surface_point
    light_distance = s.length(delta)
    light_dir = delta / torch.clamp(light_distance, min=1e-12)[..., None]

    light_pdf = light_pdf_area_to_solid_angle(light_area, light_distance, light_normal, light_dir)
    view = -ray_direction
    bsdf_attenuation = bsdf_mod.pbr_evaluate_lobe(mat, view, surface_normal, light_dir)
    bsdf_pdf = bsdf_mod.pbr_pdf_lobe(mat, view, surface_normal, light_dir)
    weight = _mis_weight(nee, light_pdf, bsdf_pdf)
    direct = (
        bsdf_attenuation
        * light_emission
        * (
            weight / torch.clamp(light_pdf, min=1e-20) / torch.clamp(light_pick_pdf, min=1e-20)
        )[..., None]
    )
    geom_ok = (light_pdf > 0.0) & (bsdf_pdf > 0.0)
    direct = torch.where(geom_ok[..., None], direct, 0.0)

    dls = DirectLightSample(
        light_area=light_area,
        light_normal=light_normal,
        light_pick_pdf=light_pick_pdf,
        light_emission=light_emission,
        light_triangle_index=light["tri_idx"],
        throughput=throughput,
        contribution=throughput * direct,
    )
    shadow = (
        surface_point + light_dir * s.EPS,
        light_dir,
        light_distance - s.EPS * 2.0,
        geom_ok,
    )
    return dls, shadow


def make_mis_carry(
    throughput, bsdf_pdf, bsdf_spectrum, bounce_direction, light_area, light_normal,
    light_pick_pdf, light_emission, light_tri,
) -> MISCarry:
    """Pre-reduce the BSDF-side MIS carry when the light is sampled;
    `bounce_direction` is the BSDF-sampled continuation direction."""
    vec = (
        throughput
        * bsdf_spectrum
        * light_emission
        / (torch.clamp(bsdf_pdf, min=1e-20) * torch.clamp(light_pick_pdf, min=1e-20))[..., None]
    )
    area_cos = light_area * s.dot(light_normal, -bounce_direction)
    return MISCarry(vec=vec, area_cos=area_cos, pdf=bsdf_pdf, tri=light_tri)


def mis_carry_contribution(hit_tri_idx, hit_t, carry: MISCarry):
    """The BSDF-sampling side of MIS when a diffuse bounce lands on the
    light sampled directly the bounce before
    (reference: kernels/src/light_pick.rs:179-199). -> [B, 3]"""
    same_light = hit_tri_idx == carry.tri
    light_pdf = hit_t * hit_t / torch.clamp(carry.area_cos, min=1e-20)
    weight = s.power_heuristic(carry.pdf, light_pdf)
    ok = same_light & (carry.area_cos > 0.0)
    return torch.where(s.expand_mask(ok), carry.vec * weight[..., None], 0.0)
