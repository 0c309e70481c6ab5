"""The wavefront integrator's stages (twin of rustic_tpu/ops/trace.py):
camera rays, the per-lane path state, and one bounce of shading
(`bounce_pre`) around a flash scan, with the shadow ray's visibility
folded in by `bounce_post`; and the single-program integrator built from
them, `trace_paths` / `accumulate_samples`, which traces one sample at a
time through the intersection engine the caller names (the brute engine
makes it the oracle of the staged renderer).

A flat batch of paths advances bounce by bounce in lockstep; dead lanes
are masked, not branched around. Low-discrepancy dimensions are fixed
per stage: (1, 2) for the AA jitter, then 8 per bounce (3 BSDF, 4 NEE,
1 roulette).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from rustic_tpu_torch.config import CameraParams, StaticConfig
from rustic_tpu_torch.ops import bsdf as bsdf_mod
from rustic_tpu_torch.ops import nee as nee_mod
from rustic_tpu_torch.ops import sampling as s
from rustic_tpu_torch.ops.intersect import (
    MULTITILE_SCANS,
    TraceResult,
    _pick_engine,
    gather_attr_rows,
    intersect_any,
    intersect_flash_attrs,
    intersect_nearest,
)
from rustic_tpu_torch.ops.rng import lds
from rustic_tpu_torch.ops.skybox import sky_radiance
from rustic_tpu_torch.scene import world as W
from rustic_tpu_torch.scene.atlas import CH_NORMAL

_DIMS_PER_BOUNCE = 8
_AA_DIMS = 2


class TraceState(NamedTuple):
    """Per-lane carry between bounces."""

    ro: Optional[torch.Tensor]  # [B, 3]; None between stages (rides in the ray rows)
    rd: Optional[torch.Tensor]  # [B, 3]
    throughput: torch.Tensor  # [B, 3]
    radiance: torch.Tensor  # [B, 3]
    alive: torch.Tensor  # [B] bool
    missed: torch.Tensor  # [B] bool: escaped the scene, sky owed
    last_lobe_diffuse: torch.Tensor  # [B] bool
    mis: nee_mod.MISCarry


class NEEPack(NamedTuple):
    """Shadow-ray request and the unoccluded candidate contribution."""

    shadow_ro: torch.Tensor  # [B, 3]
    shadow_rd: torch.Tensor  # [B, 3]
    shadow_maxt: torch.Tensor  # [B]
    contribution: torch.Tensor  # [B, 3] throughput-weighted, pre-visibility
    eligible: torch.Tensor  # [B] bool


def camera_rays(
    cfg: StaticConfig,
    cam: CameraParams,
    px: torch.Tensor,
    py: torch.Tensor,
    sample_idx: torch.Tensor,
    offsets: torch.Tensor,
):
    """Jittered pinhole camera rays (reference: kernels/src/lib.rs:38-51)
    -> (ro [B, 3], rd [B, 3])."""
    jx = lds(sample_idx, 1, offsets)
    jy = lds(sample_idx, 2, offsets)
    sx = px.to(torch.float32) + jx
    sy = py.to(torch.float32) + jy
    u = (sx * s.inv(cfg.width)) * 2.0 - 1.0
    v = ((1.0 - sy * s.inv(cfg.height)) * 2.0 - 1.0) * (cfg.height / cfg.width)

    rd = s.normalize(torch.stack([u, v, torch.ones_like(u)], dim=-1))
    pitch, yaw = cam.cam_rotation[0], cam.cam_rotation[1]
    cx, sx_ = torch.cos(pitch), torch.sin(pitch)
    cy, sy_ = torch.cos(yaw), torch.sin(yaw)
    # Ry(yaw) @ Rx(pitch), applied to rd (reference: kernels/src/lib.rs:50-51)
    x, y, z = rd[..., 0], rd[..., 1], rd[..., 2]
    y, z = cx * y - sx_ * z, sx_ * y + cx * z
    x, z = cy * x + sy_ * z, -sy_ * x + cy * z
    rd = torch.stack([x, y, z], dim=-1)
    ro = cam.cam_position.expand(rd.shape)
    return ro, rd


def bounce_draws(bounce: int, sidx, offsets) -> torch.Tensor:
    """One bounce's 8 LDS draws [B, 8]."""
    cols = [
        lds(sidx, _AA_DIMS + bounce * _DIMS_PER_BOUNCE + 1 + k, offsets)
        for k in range(_DIMS_PER_BOUNCE)
    ]
    return torch.stack(cols, dim=-1)


def init_state(cfg: StaticConfig, cam: CameraParams, px, py, sample_idx, offsets) -> TraceState:
    batch = px.shape[0]
    dev = px.device
    ro, rd = camera_rays(cfg, cam, px, py, sample_idx, offsets)
    return TraceState(
        ro=ro,
        rd=rd,
        throughput=torch.ones((batch, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((batch, 3), dtype=torch.float32, device=dev),
        alive=torch.ones(batch, dtype=torch.bool, device=dev),
        missed=torch.zeros(batch, dtype=torch.bool, device=dev),
        last_lobe_diffuse=torch.zeros(batch, dtype=torch.bool, device=dev),
        mis=nee_mod.MISCarry.zeros(batch, dev),
    )


def _where_tuple(mask, new, old):
    return type(new)(
        *(torch.where(mask if n.dim() == 1 else mask[..., None], n, o) for n, o in zip(new, old))
    )


def bounce_pre(
    scene,
    cfg: StaticConfig,
    cam: CameraParams,
    bounce: int,
    st: TraceState,
    res: TraceResult,
    draws: torch.Tensor,
    attrs: Optional[torch.Tensor] = None,
) -> Tuple[TraceState, Optional[NEEPack]]:
    """Everything in one bounce except the shadow ray's visibility test:
    sky flag, emission with MIS, normal interpolation, BSDF sample, NEE
    candidate, throughput and ray update, roulette, and on the last
    bounce the deferred sky. Returns the advanced state and, with NEE,
    the shadow-ray request."""
    batch = st.ro.shape[0]
    nee = cfg.nee
    uses_nee = nee.uses_nee and scene.has_lights
    ro, rd = st.ro, st.rd
    throughput = st.throughput
    radiance = st.radiance

    if attrs is None:
        attrs = gather_attr_rows(scene, res.tri_idx)

    hit_pos = ro + rd * res.t[..., None]

    # ---- miss: the sky is deferred to the last bounce (a lane escapes at
    # most once, and a dead lane's ro/rd/throughput stay frozen) ----
    miss = st.alive & ~res.hit
    missed = st.missed | miss

    hit_alive = st.alive & res.hit
    emissive = W.attr_emissive(attrs)
    is_emissive = (emissive != 0.0).any(dim=-1)
    emis_hit = hit_alive & is_emissive
    front_emis = emis_hit & ~res.backface

    # ---- emissive handling (reference: kernels/src/lib.rs:85-109) ----
    if not nee.uses_nee:
        add_direct = front_emis
        die_emis = emis_hit
    else:
        first_or_nondiffuse = (
            torch.full((batch,), bounce == 0, dtype=torch.bool, device=ro.device)
            | ~st.last_lobe_diffuse
        )
        add_direct = front_emis & first_or_nondiffuse
        if nee.uses_mis:
            die_emis = emis_hit
        else:  # DLS: paths continue off non-qualifying emissive hits
            die_emis = emis_hit & (res.backface | first_or_nondiffuse)
    radiance = radiance + torch.where(
        add_direct[..., None], s.mask_nan(throughput * emissive), 0.0
    )
    if nee.uses_mis:
        mis_mask = front_emis & ~add_direct & st.last_lobe_diffuse
        mis_contrib = nee_mod.mis_carry_contribution(res.tri_idx, res.t, st.mis)
        radiance = radiance + torch.where(mis_mask[..., None], s.mask_nan(mis_contrib), 0.0)

    shade = hit_alive & ~die_emis

    # ---- vertex attribute interpolation (kernels/src/lib.rs:111-129); the
    # normal is not renormalised, as the reference ----
    w_b = res.u[..., None]
    w_c = res.v[..., None]
    w_a = 1.0 - w_b - w_c
    nrm = attrs[:, W.ATTR_NRM]
    normal = w_a * nrm[:, 0:3] + w_b * nrm[:, 3:6] + w_c * nrm[:, 6:9]
    if W.attr_is_slim(attrs):  # untextured: no uvs are read
        uv = torch.zeros((batch, 2), dtype=torch.float32, device=ro.device)
    else:
        uvs = attrs[:, W.ATTR_UV]
        uv = w_a * uvs[:, 0:2] + w_b * uvs[:, 2:4] + w_c * uvs[:, 4:6]
        out_of_range = ((uv < 0.0) | (uv > 1.0)).any(dim=-1, keepdim=True)
        uv = torch.where(out_of_range, uv - torch.floor(uv), uv)

    # ---- normal mapping (kernels/src/lib.rs:131-141): one footprint of the
    # material atlas serves the normal map and the material maps ----
    tex_rows = None
    if scene.has_textures:
        has_tex = attrs[:, W.ATTR_HASTEX]
        rect = bsdf_mod.material_tex_rect(
            has_tex, attrs[:, W.ATTR_ALBEDO], attrs[:, W.ATTR_METAL],
            attrs[:, W.ATTR_ROUGH], attrs[:, W.ATTR_NORMTEX],
        )
        tex_rows = bsdf_mod.material_tex_rows(scene, rect, uv)
        nm = tex_rows[..., CH_NORMAL] * 2.0 - 1.0
        tan = attrs[:, W.ATTR_TAN]
        tangent = w_a * tan[:, 0:3] + w_b * tan[:, 3:6] + w_c * tan[:, 6:9]
        bitangent = s.cross(tangent, normal)
        mapped = s.normalize(
            tangent * nm[..., 0:1] + bitangent * nm[..., 1:2] + normal * nm[..., 2:3]
        )
        normal = torch.where((has_tex[:, 3] != 0)[..., None], mapped, normal)

    # ---- BSDF sample (kernels/src/lib.rs:143-146) ----
    mat = bsdf_mod.material_from_attrs(
        scene, attrs, uv, cam.specular_weight_clamp, tex_rows=tex_rows
    )
    r1 = draws[:, 0]
    r2 = draws[:, 1]
    r3 = draws[:, 2]
    bs = bsdf_mod.pbr_sample(mat, -rd, normal, r1, r2, r3)
    if scene.has_glass:
        is_glass = W.attr_transmission(attrs) > 0.0
        gs = bsdf_mod.glass_sample(
            mat.albedo, W.attr_ior(attrs), mat.roughness, -rd, normal, r1, r2, r3
        )
        bs = bsdf_mod.BSDFSample(
            pdf=torch.where(is_glass, gs.pdf, bs.pdf),
            lobe=torch.where(is_glass, gs.lobe, bs.lobe),
            spectrum=torch.where(is_glass[..., None], gs.spectrum, bs.spectrum),
            direction=torch.where(is_glass[..., None], gs.direction, bs.direction),
        )
    sampled_diffuse = bs.lobe == bsdf_mod.LOBE_DIFFUSE

    # ---- NEE candidate on diffuse lobes (kernels/src/lib.rs:148-165) ----
    nee_pack = None
    mis_carry = st.mis
    if uses_nee:
        rn = tuple(draws[:, 3 + k] for k in range(4))
        dls, shadow = nee_mod.prepare_direct_lighting(
            scene, nee, mat, throughput, hit_pos, normal, rd, rn
        )
        eligible = shade & sampled_diffuse
        carry = nee_mod.make_mis_carry(
            throughput, bs.pdf, bs.spectrum, bs.direction,
            dls.light_area, dls.light_normal, dls.light_pick_pdf,
            dls.light_emission, dls.light_triangle_index,
        )
        mis_carry = _where_tuple(eligible, carry, st.mis)
        nee_pack = NEEPack(
            shadow_ro=shadow[0],
            shadow_rd=shadow[1],
            shadow_maxt=shadow[2],
            contribution=dls.contribution,
            eligible=eligible & shadow[3],
        )

    # ---- throughput and ray update (kernels/src/lib.rs:167-172) ----
    pdf_safe = torch.where(bs.pdf.abs() < 1e-20, 1e-20, bs.pdf)
    new_tp = s.mask_nan(throughput * bs.spectrum / pdf_safe[..., None])
    throughput = torch.where(shade[..., None], new_tp, throughput)
    rd_new = bs.direction
    ro_new = hit_pos + rd_new * s.EPS
    ro = torch.where(shade[..., None], ro_new, ro)
    rd = torch.where(shade[..., None], rd_new, rd)
    alive = shade

    # ---- russian roulette (kernels/src/lib.rs:174-181), clamped to 1 ----
    if bounce > cfg.min_bounces:
        prob = torch.clamp(throughput.amax(dim=-1), max=1.0)
        roll = draws[:, 7]
        killed = alive & (roll > prob)
        alive = alive & ~killed
        throughput = torch.where(
            alive[..., None], throughput / torch.clamp(prob, min=1e-20)[..., None], throughput
        )

    # ---- deferred sky payoff (last bounce only) ----
    if bounce == cfg.max_bounces - 1:
        radiance = radiance + deferred_sky_term(scene, cfg, cam, ro, rd, throughput, missed)

    st = TraceState(
        ro=ro,
        rd=rd,
        throughput=throughput,
        radiance=radiance,
        alive=alive,
        missed=missed,
        last_lobe_diffuse=torch.where(shade, sampled_diffuse, st.last_lobe_diffuse),
        mis=mis_carry,
    )
    return st, nee_pack


def deferred_sky_term(scene, cfg, cam, ro, rd, throughput, missed):
    """The sky radiance of the lanes that escaped, [B, 3].

    The sky is the image sky with has_skybox, else the procedural march.
    The JAX package skips the sky when no lane missed (`lax.cond`) and
    marches only the 512-lane segments holding misses; both equal the
    full evaluation up to rounding, because it is elementwise. Here every
    lane is evaluated and the result masked, so the host never waits on
    the device to decide."""
    sky = sky_radiance(scene, cfg.has_skybox, cam.sun_direction, ro, rd)
    return torch.where(missed[:, None], throughput * sky, 0.0)


def bounce_post(st: TraceState, nee_pack: NEEPack, occluded) -> TraceState:
    """Fold the shadow ray's visibility into the NEE contribution."""
    lit = nee_pack.eligible & ~occluded
    radiance = st.radiance + torch.where(lit[..., None], s.mask_nan(nee_pack.contribution), 0.0)
    return st._replace(radiance=radiance)


def trace_paths(
    scene,
    cfg: StaticConfig,
    cam: CameraParams,
    px: torch.Tensor,
    py: torch.Tensor,
    sample_idx: int,
    offsets: torch.Tensor,
    engine: str = "auto",
    scan: str = MULTITILE_SCANS[0],
) -> torch.Tensor:
    """Trace sample `sample_idx` of a batch of pixels, bounce by bounce
    with a nearest-hit query, `bounce_pre`, an any-hit query of the shadow
    rays and `bounce_post` -> radiance [B, 3]. `engine` names the
    intersection engine (ops/intersect.py), `scan` the form of the flash
    engine's multi-tile scans."""
    resolved = _pick_engine(scene, engine)
    bits = int(sample_idx) & 0xFFFFFFFF
    sidx = torch.full((px.shape[0],), bits - (1 << 32) if bits >= (1 << 31) else bits,
                      dtype=torch.int32, device=px.device)
    st = init_state(cfg, cam, px, py, sidx, offsets)
    for bounce in range(cfg.max_bounces):
        if resolved == "flash":
            res, attrs = intersect_flash_attrs(scene, st.ro, st.rd, scan)
        else:
            res = intersect_nearest(scene, st.ro, st.rd, engine=resolved)
            attrs = None
        st, nee_pack = bounce_pre(
            scene, cfg, cam, bounce, st, res, bounce_draws(bounce, sidx, offsets), attrs=attrs
        )
        if nee_pack is not None:
            occluded = intersect_any(
                scene, nee_pack.shadow_ro, nee_pack.shadow_rd, nee_pack.shadow_maxt,
                engine=resolved, scan=scan,
            )
            st = bounce_post(st, nee_pack, occluded)
    return st.radiance


def accumulate_samples(
    scene,
    cfg: StaticConfig,
    cam: CameraParams,
    px: torch.Tensor,
    py: torch.Tensor,
    offsets: torch.Tensor,
    sample_start: int,
    n_samples: int,
    engine: str = "auto",
    film_in: Optional[torch.Tensor] = None,
    scan: str = MULTITILE_SCANS[0],
) -> torch.Tensor:
    """Fold samples sample_start .. sample_start + n_samples - 1 into a
    film sum [B, 3] on the scene's device, one `trace_paths` each."""
    film = film_in if film_in is not None else torch.zeros(
        (px.shape[0], 3), dtype=torch.float32, device=px.device
    )
    for i in range(n_samples):
        film = film + trace_paths(
            scene, cfg, cam, px, py, sample_start + i, offsets, engine=engine, scan=scan
        )
    return film
