"""BSDFs over the wavefront (twin of rustic_tpu/ops/bsdf.py): the
material of a hit (its row's factors, or texels of the co-located
material atlas where the material is textured), metallic/roughness PBR (cosine diffuse + Karis GGX specular
with the specular-weight clamp) and the GGX microfacet dielectric.
Both lobes run for every lane; masks pick the result.

Lobe encoding (reference: kernels/src/bsdf.rs:11-18):
  0 = DiffuseReflection, 1 = SpecularReflection,
  2 = DiffuseTransmission, 3 = SpecularTransmission.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rustic_tpu_torch.ops import sampling as s
from rustic_tpu_torch.ops.texture import sample_atlas
from rustic_tpu_torch.scene import world as W
from rustic_tpu_torch.scene.atlas import CH_ALBEDO, CH_METAL, CH_ROUGH

LOBE_DIFFUSE = 0
LOBE_SPECULAR = 1
LOBE_DIFFUSE_T = 2
LOBE_SPECULAR_T = 3

# Dielectric constants (reference: kernels/src/bsdf.rs:178-183)
DIELECTRIC_IOR = 1.5
_F0_SQRT = (DIELECTRIC_IOR - 1.0) / (DIELECTRIC_IOR + 1.0)
DIELECTRIC_F0 = _F0_SQRT * _F0_SQRT


class PBRMaterial(NamedTuple):
    """Per-lane PBR parameters (reference: kernels/src/bsdf.rs:185-190)."""

    albedo: torch.Tensor  # [B, 3]
    roughness: torch.Tensor  # [B]
    metallic: torch.Tensor  # [B]
    specular_weight_clamp: torch.Tensor  # [2]


class BSDFSample(NamedTuple):
    """(reference: kernels/src/bsdf.rs:20-26)"""

    pdf: torch.Tensor  # [B]
    lobe: torch.Tensor  # [B] i32
    spectrum: torch.Tensor  # [B, 3]
    direction: torch.Tensor  # [B, 3]


def _specular_weight(mat: PBRMaterial, n_dot_v):
    """Fresnel-lerp lobe weight with the firefly clamp
    (reference: kernels/src/bsdf.rs:275-280)."""
    approx_fresnel = s.fresnel_schlick_scalar(
        1.0, DIELECTRIC_IOR, torch.clamp(n_dot_v, min=0.0)
    )
    w = s.lerp(approx_fresnel, 1.0, mat.metallic)
    clamped = s.clip(w, mat.specular_weight_clamp[0], mat.specular_weight_clamp[1])
    return torch.where((w != 0.0) & (w != 1.0), clamped, w)


def _ks(mat: PBRMaterial, h_dot_v):
    f0 = s.lerp(torch.full_like(mat.albedo, DIELECTRIC_F0), mat.albedo, mat.metallic[..., None])
    return s.fresnel_schlick(torch.clamp(h_dot_v, min=0.0), f0)


def _eval_diffuse(mat, cos_theta, specular_weight, ks):
    """(reference: kernels/src/bsdf.rs:193-202)"""
    kd = (1.0 - ks) * (1.0 - mat.metallic[..., None])
    diffuse = kd * mat.albedo * s.inv(s.PI)
    return diffuse * (cos_theta / torch.clamp(1.0 - specular_weight, min=1e-8))[..., None]


def _eval_specular(mat, view, normal, light, cos_theta, d_term, specular_weight, ks):
    """(reference: kernels/src/bsdf.rs:204-219)"""
    g_term = s.geometry_smith_schlick_ggx(normal, view, light, mat.roughness)
    numerator = (d_term * g_term)[..., None] * ks
    denominator = 4.0 * torch.clamp(s.dot(normal, view), min=0.0) * cos_theta
    spec = numerator / torch.clamp(denominator, min=s.EPS)[..., None]
    return spec * (cos_theta / torch.clamp(specular_weight, min=1e-8))[..., None]


def _pdf_diffuse(cos_theta):
    return cos_theta * s.inv(s.PI)


def _pdf_specular(view, normal, halfway, d_term):
    return (d_term * s.dot(normal, halfway)) / (4.0 * s.dot(view, halfway))


def pbr_sample(mat: PBRMaterial, view, normal, r1, r2, r3) -> BSDFSample:
    """Sample the PBR BSDF for every lane (reference:
    kernels/src/bsdf.rs:272-334). `view` points away from the surface."""
    n_dot_v = s.dot(normal, view)
    specular_weight = _specular_weight(mat, n_dot_v)

    up, right, forward = s.create_cartesian(normal)
    diff_dir = s.local_to_world(s.cosine_sample_hemisphere(r1, r2), up, right, forward)
    refl = s.reflect(-view, normal)
    spec_dir = s.sample_ggx(r1, r2, refl, mat.roughness)

    take_spec = r3 < specular_weight
    direction = torch.where(s.expand_mask(take_spec), spec_dir, diff_dir)
    lobe = torch.where(take_spec, LOBE_SPECULAR, LOBE_DIFFUSE).to(torch.int32)

    cos_theta = torch.clamp(s.dot(normal, direction), min=s.EPS)
    halfway = s.normalize(view + direction)
    ks = _ks(mat, s.dot(halfway, view))
    d_term = s.ggx_distribution(normal, halfway, mat.roughness)

    pdf_d = _pdf_diffuse(cos_theta)
    spec_d = _eval_diffuse(mat, cos_theta, specular_weight, ks)
    pdf_s = _pdf_specular(view, normal, halfway, d_term)
    spec_s = _eval_specular(mat, view, normal, direction, cos_theta, d_term, specular_weight, ks)

    pdf = torch.where(take_spec, pdf_s, pdf_d)
    spectrum = torch.where(s.expand_mask(take_spec), spec_s, spec_d)
    return BSDFSample(pdf=pdf, lobe=lobe, spectrum=spectrum, direction=direction)


def pbr_evaluate_lobe(mat: PBRMaterial, view, normal, light, lobe_is_specular=False):
    """The BSDF value toward `light` for one lobe (reference:
    kernels/src/bsdf.rs:237-270); NEE evaluates the diffuse lobe."""
    n_dot_v = s.dot(normal, view)
    specular_weight = _specular_weight(mat, n_dot_v)
    cos_theta = torch.clamp(s.dot(normal, light), min=0.0)
    halfway = s.normalize(view + light)
    ks = _ks(mat, s.dot(halfway, view))
    if not lobe_is_specular:
        return _eval_diffuse(mat, cos_theta, specular_weight, ks)
    d_term = s.ggx_distribution(normal, halfway, mat.roughness)
    return _eval_specular(mat, view, normal, light, cos_theta, d_term, specular_weight, ks)


def pbr_pdf_lobe(mat: PBRMaterial, view, normal, light, lobe_is_specular=False):
    """(reference: kernels/src/bsdf.rs:336-351)"""
    if not lobe_is_specular:
        return _pdf_diffuse(torch.clamp(s.dot(normal, light), min=0.0))
    halfway = s.normalize(view + light)
    d_term = s.ggx_distribution(normal, halfway, mat.roughness)
    return _pdf_specular(view, normal, halfway, d_term)


def material_tex_rect(has_tex, albedo_slot, metal_slot, rough_slot, norm_slot):
    """A material's atlas rect: every textured map of a material lands at
    one cell (scene/atlas.py), so any textured slot holds it; take the
    first. Untextured lanes yield their colour slot, whose fetch the
    has-texture selects then discard."""
    return torch.where(
        has_tex[..., 0:1] != 0, albedo_slot,
        torch.where(
            has_tex[..., 1:2] != 0, metal_slot,
            torch.where(has_tex[..., 2:3] != 0, rough_slot, norm_slot),
        ),
    )


def material_tex_rows(scene, rect, uv):
    """One bilinear footprint over the 9-channel material atlas -> [B, 9]
    rows serving albedo, metallic, roughness and the normal map."""
    return sample_atlas(scene.atlas, rect, uv)


def material_from_attrs(scene, attrs, uv, specular_weight_clamp, tex_rows=None) -> PBRMaterial:
    """PBR parameters from the hit's shading row (reference:
    kernels/src/bsdf.rs:354-387): its factors, or for a textured scene
    the atlas texels where the material has a map. `tex_rows` ([B, 9])
    lets the caller share the footprint it fetched for normal mapping;
    without it a textured scene fetches here."""
    albedo = W.attr_albedo3(attrs)
    roughness = W.attr_rough_scalar(attrs)
    metallic = W.attr_metal_scalar(attrs)
    if scene.has_textures:  # textured scenes carry full-width rows
        has_tex = attrs[:, W.ATTR_HASTEX]
        if tex_rows is None:
            rect = material_tex_rect(
                has_tex, attrs[:, W.ATTR_ALBEDO], attrs[:, W.ATTR_METAL],
                attrs[:, W.ATTR_ROUGH], attrs[:, W.ATTR_NORMTEX],
            )
            tex_rows = material_tex_rows(scene, rect, uv)
        albedo = torch.where(has_tex[:, 0:1] != 0, tex_rows[..., CH_ALBEDO][..., :3], albedo)
        roughness = torch.where(has_tex[:, 2] != 0, tex_rows[..., CH_ROUGH], roughness)
        metallic = torch.where(has_tex[:, 1] != 0, tex_rows[..., CH_METAL], metallic)
    return PBRMaterial(
        albedo=albedo,
        roughness=torch.clamp(roughness, min=s.EPS),
        metallic=torch.clamp(metallic, max=1.0 - s.EPS),
        specular_weight_clamp=specular_weight_clamp,
    )


def glass_sample(albedo, ior, roughness, view, normal, r1, r2, r3) -> BSDFSample:
    """GGX microfacet dielectric (reference: kernels/src/bsdf.rs:107-176)."""
    inside = s.dot(normal, view) < 0.0
    n = torch.where(s.expand_mask(inside), -normal, normal)
    in_ior = torch.where(inside, ior, 1.0)
    out_ior = torch.where(inside, 1.0, ior)

    m = s.sample_ggx_microsurface_normal(r1, r2, n, roughness)
    fresnel = s.fresnel_schlick_scalar(in_ior, out_ior, torch.clamp(s.dot(m, view), min=0.0))
    reflect_dir = s.normalize(2.0 * s.dotk(view, m).abs() * m - view)
    eta = in_ior / out_ior
    c = s.dot(view, m)
    k = 1.0 + eta * eta * (c * c - 1.0)
    vn = s.dot(view, n)
    sign_vn = torch.where(torch.isnan(vn), vn, torch.sign(vn))  # jnp.sign keeps NaN
    refr_scale = eta * c - sign_vn * torch.sqrt(torch.clamp(k, min=0.0))
    refract_dir = s.normalize(refr_scale[..., None] * m - eta[..., None] * view)

    reflecting = r3 <= fresnel
    direction = torch.where(s.expand_mask(reflecting), reflect_dir, refract_dir)
    spectrum = torch.where(s.expand_mask(reflecting), torch.ones_like(albedo), albedo)
    lobe = torch.where(reflecting, LOBE_SPECULAR, LOBE_SPECULAR_T).to(torch.int32)
    pdf = torch.ones_like(r3)  # delta distribution
    return BSDFSample(pdf=pdf, lobe=lobe, spectrum=spectrum, direction=direction)
