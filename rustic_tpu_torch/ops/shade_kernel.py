"""One bounce's shading stage: kernels K4 and K8 and their plain twin.

Twin of rustic_tpu/ops/shade_kernel.py (`shade_bounce`, the Pallas
kernel of `_build_kernel`): fold the previous bounce's shadow result,
re-test the winner triangle exactly, add emission with the MIS weight,
sample the BSDF (Lambert/GGX, or the GGX dielectric), pick a light from
the alias table and build the shadow ray (NEE), update the throughput,
run russian roulette after min_bounces, add the procedural sky to the
lanes that escaped on the last bounce (with an HDR skybox the kernel
leaves the sky to the driver, runtime/pipeline.py `hdr_sky_payoff`), and
emit the next ray rows.

K4 holds an alias table of at most 16 entries in shared memory (the
single-tile path). K8 is the same kernel for wider tables: it reads the
picked entry row from the global table, which replaces the JAX package's
prepicked mode (`picked_light_rows_t` in XLA, then the kernel on the
picked rows). Both share one plain version, which gathers the row.

State crosses bounces as one packed [NST, B] f32 block (SK_* rows);
rays are the [16, B] feature rows of ops/flash_intersect.py; the winner
row arrives transposed, [SLIM_WIDTH, B]. Sample indices and per-pixel
offsets are int32 tensors holding u32 bits (ops/rng.py).

The plain version mirrors the JAX kernel's operation order: vectors are
tuples of [B] tensors, a division by a constant is a multiply by its f32
reciprocal (sampling.inv), and no division has a Python scalar as its
divisor or dividend.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rustic_tpu_torch.config import StaticConfig
from rustic_tpu_torch.ops import _build
from rustic_tpu_torch.ops.flash_intersect import BIG, DET_EPS
from rustic_tpu_torch.ops.rng import _LDS_PRIMES, lds
from rustic_tpu_torch.ops.sampling import EPS, PI, inv
from rustic_tpu_torch.scene import world as W

# ---- packed path-state rows (f32) ------------------------------------------
SK_THR = slice(0, 3)
SK_RAD = slice(3, 6)
SK_ALIVE = 6
SK_MISSED = 7
SK_LASTDIFF = 8
SK_MIS_VEC = slice(9, 12)
SK_MIS_AC = 12
SK_MIS_PDF = 13
SK_MIS_TRI = 14
SK_PEND_CON = slice(15, 18)
SK_PEND_ELIG = 18
NST = 19

_DIMS_PER_BOUNCE = 8
_AA_DIMS = 2
MAX_ALIAS = 16  # alias-table rows K4's shared-memory table holds


def rows_moved(has_occ: bool, mis: bool, has_glass: bool, n_next: int, n_shadow: int) -> int:
    """The f32/i32 rows per lane K4 and K8 must move (csrc/shade.cu
    `shade_kernel`): in, state rows 0-14 (the pending NEE rows too when
    a shadow result is folded), rd and ro of the rays (rows 0-2, 6-8),
    t, the winner index (read for MIS only), the slim rows up to the
    metallic row (transmission and ior too with glass), occ, sidx and
    offsets; out, the state and the n_next + n_shadow ray rows."""
    st_in = SK_MIS_TRI + 1 + (NST - SK_PEND_CON.start if has_occ else 0)
    attrs_in = (W.SLIM_IOR if has_glass else W.SLIM_METAL) + 1
    rows_in = st_in + 6 + 1 + int(mis) + attrs_in + int(has_occ) + 2
    return rows_in + NST + n_next + n_shadow

# BSDF constants (reference: kernels/src/bsdf.rs:178-183)
_DIELECTRIC_IOR = 1.5
_F0S = (_DIELECTRIC_IOR - 1.0) / (_DIELECTRIC_IOR + 1.0)
_DIELECTRIC_F0 = _F0S * _F0S

# atmosphere constants (reference: kernels/src/skybox.rs:8-16)
_RAY_COEFF = (58e-7, 135e-7, 331e-7)
_MIE_SCATTER = 2e-5
_MIE_EFFECTIVE = 2e-5 * 1.1
_EARTH_RADIUS = 6360e3
_ATMOSPHERE_RADIUS = 6380e3
_H_RAY = 8e3
_H_MIE = 12e2
_SKY_STEPS = 12

LAUNCHES = {"shade_bounce": 0, "shade_bounce_wide": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- vec3 as component tuples of [B] tensors --------------------------------


def _dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _scale(v, s):
    return (v[0] * s, v[1] * s, v[2] * s)


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _mul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def _where(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def _max(x, c):
    return torch.clamp(x, min=c)


def _min(x, c):
    return torch.clamp(x, max=c)


def _clip(x, lo, hi):
    return torch.clamp(torch.clamp(x, min=lo), max=hi)


def _pow5(x):
    # lax.integer_pow's square-and-multiply order
    x2 = x * x
    return x * (x2 * x2)


def _rdiv(c: float, x):
    """c / x with a true division."""
    return torch.full_like(x, c) / x


def _normalize(v, eps: float = 1e-20):
    inv = torch.reciprocal(_max(torch.sqrt(_dot(v, v)), eps))
    return _scale(v, inv)


def _mask_nan(v):
    finite = torch.isfinite(v[0]) & torch.isfinite(v[1]) & torch.isfinite(v[2])
    return _where(finite, v, (0.0, 0.0, 0.0))


def _lerp(a, b, t):
    return a * (1.0 - t) + b * t


# ---- sampling / BSDF math ----------------------------------------------------


def _create_cartesian(up):
    ax, ay, az = 0.1, 0.5, 0.9
    temp = _normalize(
        (up[1] * az - up[2] * ay, up[2] * ax - up[0] * az, up[0] * ay - up[1] * ax)
    )
    right = _normalize(_cross(temp, up))
    forward = _normalize(_cross(up, right))
    return up, right, forward


def _local_to_world(local, up, right, forward):
    return _normalize(
        _add(_add(_scale(forward, local[0]), _scale(up, local[1])), _scale(right, local[2]))
    )


def _cosine_sample_hemisphere(r1, r2):
    cos_theta = torch.sqrt(_max(r1, 0.0))
    sin_theta = torch.sqrt(_max(1.0 - r1, 0.0))
    phi = 2.0 * PI * r2
    return (sin_theta * torch.cos(phi), cos_theta, sin_theta * torch.sin(phi))


def _reflect(i, n):
    return _sub(i, _scale(n, 2.0 * _dot(i, n)))


def _ggx_distribution(n, h, roughness):
    a2 = roughness * roughness
    n_dot_h = _max(_dot(n, h), 0.0)
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    denom = _max(PI * denom * denom, EPS)
    return a2 / denom


def _sample_ggx(r1, r2, refl, roughness):
    a = roughness * roughness
    phi = 2.0 * PI * r1
    cos_theta = torch.sqrt(_max((1.0 - r2) / (r2 * (a * a - 1.0) + 1.0), 0.0))
    sin_theta = torch.sqrt(_max(1.0 - cos_theta * cos_theta, 0.0))
    h_local = (torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta)
    take_z = refl[2].abs() < 0.999
    zero = torch.zeros_like(refl[0])
    up = (torch.where(take_z, 0.0, 1.0), zero, torch.where(take_z, 1.0, 0.0))
    tangent = _normalize(_cross(up, refl))
    bitangent = _cross(refl, tangent)
    return _normalize(
        _add(
            _add(_scale(tangent, h_local[0]), _scale(bitangent, h_local[1])),
            _scale(refl, h_local[2]),
        )
    )


def _geometry_schlick_ggx(n, v, roughness):
    n_dot_v = _max(_dot(n, v), 0.0)
    r = (roughness * roughness) * inv(8.0)
    return n_dot_v / (n_dot_v * (1.0 - r) + r)


def _fresnel_schlick_scalar(in_ior, out_ior, cos_theta):
    q = (in_ior - out_ior) / (in_ior + out_ior)
    f0 = q * q
    ct = _clip(cos_theta, 0.0, 1.0)
    return f0 + (1.0 - f0) * _pow5(1.0 - ct)


def _power_heuristic(p1, p2):
    p1_2 = p1 * p1
    return p1_2 / _max(p1_2 + p2 * p2, 1e-20)


def _specular_weight(metallic, clamp_lo, clamp_hi, n_dot_v):
    approx = _fresnel_schlick_scalar(1.0, _DIELECTRIC_IOR, _max(n_dot_v, 0.0))
    w = _lerp(approx, 1.0, metallic)
    clamped = torch.minimum(torch.maximum(w, clamp_lo), clamp_hi)
    return torch.where((w != 0.0) & (w != 1.0), clamped, w)


def _ks(albedo, metallic, h_dot_v):
    ct = _clip(_max(h_dot_v, 0.0), 0.0, 1.0)
    s5 = _pow5(1.0 - ct)
    return tuple(_lerp(_DIELECTRIC_F0, a, metallic) * (1.0 - s5) + s5 for a in albedo)


def _eval_diffuse(albedo, metallic, cos_theta, specular_weight, ks):
    f = cos_theta / _max(1.0 - specular_weight, 1e-8)
    return tuple(
        (1.0 - k) * (1.0 - metallic) * a * inv(PI) * f for k, a in zip(ks, albedo)
    )


def _eval_specular(roughness, view, normal, light, cos_theta, d_term, specular_weight, ks):
    g = _geometry_schlick_ggx(normal, view, roughness) * _geometry_schlick_ggx(
        normal, light, roughness
    )
    denom = _max(4.0 * _max(_dot(normal, view), 0.0) * cos_theta, EPS)
    f = cos_theta / _max(specular_weight, 1e-8)
    return tuple((d_term * g) * k / denom * f for k in ks)


def _pbr_sample(albedo, roughness, metallic, clamp_lo, clamp_hi, view, normal, r1, r2, r3):
    """-> (pdf, sampled-diffuse mask, spectrum, direction)."""
    n_dot_v = _dot(normal, view)
    specular_weight = _specular_weight(metallic, clamp_lo, clamp_hi, n_dot_v)

    up, right, forward = _create_cartesian(normal)
    diff_dir = _local_to_world(_cosine_sample_hemisphere(r1, r2), up, right, forward)
    refl = _reflect(_scale(view, -1.0), normal)
    spec_dir = _sample_ggx(r1, r2, refl, roughness)

    take_spec = r3 < specular_weight
    direction = _where(take_spec, spec_dir, diff_dir)

    cos_theta = _max(_dot(normal, direction), EPS)
    halfway = _normalize(_add(view, direction))
    ks = _ks(albedo, metallic, _dot(halfway, view))
    d_term = _ggx_distribution(normal, halfway, roughness)

    pdf_d = cos_theta * inv(PI)
    spec_d = _eval_diffuse(albedo, metallic, cos_theta, specular_weight, ks)
    pdf_s = (d_term * _dot(normal, halfway)) / (4.0 * _dot(view, halfway))
    spec_s = _eval_specular(
        roughness, view, normal, direction, cos_theta, d_term, specular_weight, ks
    )
    pdf = torch.where(take_spec, pdf_s, pdf_d)
    spectrum = _where(take_spec, spec_s, spec_d)
    return pdf, ~take_spec, spectrum, direction


def _pbr_eval_pdf_diffuse(albedo, roughness, metallic, clamp_lo, clamp_hi, view, normal, light):
    """The diffuse lobe's value and pdf toward `light` (the NEE path)."""
    n_dot_v = _dot(normal, view)
    specular_weight = _specular_weight(metallic, clamp_lo, clamp_hi, n_dot_v)
    cos_theta = _max(_dot(normal, light), 0.0)
    halfway = _normalize(_add(view, light))
    ks = _ks(albedo, metallic, _dot(halfway, view))
    atten = _eval_diffuse(albedo, metallic, cos_theta, specular_weight, ks)
    pdf = _max(_dot(normal, light), 0.0) * inv(PI)
    return atten, pdf


def _glass_sample(albedo, ior, roughness, view, normal, r1, r2, r3):
    """GGX microfacet dielectric; the microsurface normal's angle is
    written trig-free, as in the JAX kernel."""
    inside = _dot(normal, view) < 0.0
    n = _where(inside, _scale(normal, -1.0), normal)
    in_ior = torch.where(inside, ior, 1.0)
    out_ior = torch.where(inside, 1.0, ior)

    a_g = roughness * roughness
    q = (a_g * torch.sqrt(_max(r1, 0.0))) / torch.sqrt(_max(1.0 - r1, 1e-20))
    inv_h = torch.reciprocal(torch.sqrt(1.0 + q * q))
    cos_t = inv_h
    sin_t = q * inv_h
    phi_m = 2.0 * PI * r2
    m_local = (sin_t * torch.cos(phi_m), cos_t, sin_t * torch.sin(phi_m))
    up, right, forward = _create_cartesian(n)
    m = _local_to_world(m_local, up, right, forward)

    fresnel = _fresnel_schlick_scalar(in_ior, out_ior, _max(_dot(m, view), 0.0))
    reflect_dir = _normalize(_sub(_scale(m, 2.0 * _dot(view, m).abs()), view))
    eta = in_ior / out_ior
    c = _dot(view, m)
    k = 1.0 + eta * eta * (c * c - 1.0)
    vn = _dot(view, n)
    sign_vn = torch.where(torch.isnan(vn), vn, torch.sign(vn))  # jnp.sign keeps NaN
    refr_scale = eta * c - sign_vn * torch.sqrt(_max(k, 0.0))
    refract_dir = _normalize(_sub(_scale(m, refr_scale), _scale(view, eta)))

    reflecting = r3 <= fresnel
    direction = _where(reflecting, reflect_dir, refract_dir)
    spectrum = _where(reflecting, (1.0, 1.0, 1.0), albedo)
    return torch.ones_like(r3), spectrum, direction


def _procedural_sky(sun, intensity, ro, rd):
    """Atmosphere march (reference: kernels/src/skybox.rs); `sun` is a
    tuple of three 0-dim tensors, `intensity` a 0-dim tensor."""

    def escape(p, d, r):
        vx, vy, vz = p[0], p[1] + _EARTH_RADIUS, p[2]
        b = vx * d[0] + vy * d[1] + vz * d[2]
        det = b * b - (vx * vx + vy * vy + vz * vz) + r * r
        sq = torch.sqrt(_max(det, 0.0))
        t1 = -b - sq
        t2 = -b + sq
        t = torch.where(t1 >= 0.0, t1, t2)
        return torch.where(det < 0.0, -1.0, t)

    def densities(p):
        vx, vy, vz = p[0], p[1] + _EARTH_RADIUS, p[2]
        h = _max(torch.sqrt(vx * vx + vy * vy + vz * vz) - _EARTH_RADIUS, 0.0)
        return torch.exp(-h * inv(_H_RAY)), torch.exp(-h * inv(_H_MIE))

    one = torch.ones_like(ro[0])
    sundir = (sun[0] * one, sun[1] * one, sun[2] * one)
    depth = escape(ro, rd, _ATMOSPHERE_RADIUS) * inv(_SKY_STEPS)

    zero = torch.zeros_like(ro[0])
    i_r = [zero, zero, zero]
    i_m = [zero, zero, zero]
    total_r = zero
    total_m = zero
    for i in range(_SKY_STEPS):
        p = _add(ro, _scale(rd, depth * float(i)))
        r0, m0 = densities(p)
        dr = r0 * depth
        dm = m0 * depth
        total_r = total_r + dr
        total_m = total_m + dm
        l = escape(p, sundir, _ATMOSPHERE_RADIUS)
        r1_, m1_ = densities(_add(p, _scale(sundir, l)))
        sr = r0 * (l * 0.5) + r1_ * (l * 0.5)
        sm = m0 * (l * 0.5) + m1_ * (l * 0.5)
        depth_r = total_r + sr
        depth_m = total_m + sm
        for ch in range(3):
            a = torch.exp(-_RAY_COEFF[ch] * depth_r - _MIE_EFFECTIVE * depth_m)
            i_r[ch] = i_r[ch] + a * dr
            i_m[ch] = i_m[ch] + a * dm

    mu = _dot(rd, sundir)
    ph = _max(1.58 - 1.52 * mu, 1e-6)
    phase_mie = _rdiv(0.0196, ph * torch.sqrt(ph))
    scale = intensity * (1.0 + mu * mu)
    out = []
    for ch in range(3):
        res = scale * (i_r[ch] * _RAY_COEFF[ch] * 0.0597 + i_m[ch] * _MIE_SCATTER * phase_mie)
        g = torch.sqrt(_max(res, 0.0))
        g = torch.where(torch.isfinite(g), g, 0.0)
        safe = _max(g, 1e-20)
        out.append(torch.where(g > 0.0, torch.exp(2.2 * torch.log(safe)), 0.0))
    return tuple(out)


def _mt_retest(a, b, c, ro, rd):
    """Exact f32 Möller–Trumbore of the winner triangle."""
    e1 = _sub(b, a)
    e2 = _sub(c, a)
    pv = _cross(rd, e2)
    det = _dot(e1, pv)
    backface = det < 0.0
    good = det.abs() >= DET_EPS
    inv_det = torch.where(good, torch.reciprocal(torch.where(good, det, 1.0)), 0.0)
    tv = _sub(ro, a)
    u = _dot(tv, pv) * inv_det
    qv = _cross(tv, e1)
    v = _dot(rd, qv) * inv_det
    t = _dot(e2, qv) * inv_det
    valid = good & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
    return t, u, v, backface, valid


def _alias_select(entry_rows, n_alias, n_u32, dim0, offs):
    """Pick an alias entry and one of its two triangles: the chosen
    entry row is read directly (the JAX kernel's select-sum over the
    rows adds exact zeros to it; `0 + x` keeps its signed-zero rule)."""
    n1 = lds(n_u32, dim0 + 3, offs)
    n2 = lds(n_u32, dim0 + 4, offs)
    entry = torch.clamp((n1 * float(n_alias)).to(torch.int32), 0, n_alias - 1)
    row = entry_rows[entry.long()]  # [B, ENTRY_WIDTH]
    take = n2 < row[:, W.ENTRY_RATIO]
    zero = torch.zeros_like(n1)

    def sca(ca, cb):
        return zero + torch.where(take, row[:, ca], row[:, cb])

    def vec(sa: slice, sb: slice):
        return tuple(sca(sa.start + d, sb.start + d) for d in range(3))

    va, vb = W.ENTRY_A_VERTS.start, W.ENTRY_B_VERTS.start
    return (
        sca(W.ENTRY_AREA_A, W.ENTRY_AREA_B),
        sca(W.ENTRY_PDF_A, W.ENTRY_PDF_B),
        vec(slice(va, va + 3), slice(vb, vb + 3)),
        vec(slice(va + 3, va + 6), slice(vb + 3, vb + 6)),
        vec(slice(va + 6, va + 9), slice(vb + 6, vb + 9)),
        vec(W.ENTRY_A_NORMAL, W.ENTRY_B_NORMAL),
        vec(W.ENTRY_A_EMISSION, W.ENTRY_B_EMISSION),
        sca(W.ENTRY_A_TRI, W.ENTRY_B_TRI),
    )


# ---- the plain version -----------------------------------------------------------


def shade_bounce_plain(
    cfg: StaticConfig, bounce: int, params, entry_rows, st, feats_t, t, idx,
    attrs_t, occ, sidx, offsets, has_glass: bool = False, n_alias: int = 0,
):
    """One bounce of shading, vectorised over the B lanes -> (st_out
    [NST, B], next feats [16, B] or None on the last bounce, shadow
    feats [16, B] or None without NEE). Arguments as `shade_bounce`;
    the alias table may have any number of entries."""
    nee = cfg.nee
    uses_nee = nee.uses_nee and n_alias > 0
    last = bounce == cfg.max_bounces - 1
    A = W.SLIM_ALBEDO.start
    clamp_lo = params[0, 4]
    clamp_hi = params[0, 5]

    rd = (feats_t[0], feats_t[1], feats_t[2])
    ro = (feats_t[6], feats_t[7], feats_t[8])
    throughput = (st[0], st[1], st[2])
    radiance = (st[3], st[4], st[5])
    alive = st[SK_ALIVE] > 0.5
    missed_in = st[SK_MISSED] > 0.5
    last_diffuse = st[SK_LASTDIFF] > 0.5
    mis_vec = (st[9], st[10], st[11])
    mis_ac = st[SK_MIS_AC]
    mis_pdf = st[SK_MIS_PDF]
    mis_tri = st[SK_MIS_TRI]
    zero = torch.zeros_like(t)
    zero3 = (zero, zero, zero)

    # ---- fold the previous bounce's shadow result --------------------------
    if occ is not None:
        pend_con = (st[15], st[16], st[17])
        lit = (st[SK_PEND_ELIG] > 0.5) & (occ == 0)
        radiance = _add(radiance, _where(lit, _mask_nan(pend_con), zero3))

    # ---- exact winner re-test ---------------------------------------------------
    a3 = (attrs_t[0], attrs_t[1], attrs_t[2])
    b3 = (attrs_t[3], attrs_t[4], attrs_t[5])
    c3 = (attrs_t[6], attrs_t[7], attrs_t[8])
    t2, u, v, backface, valid = _mt_retest(a3, b3, c3, ro, rd)
    hit = (t < BIG) & valid
    t_hit = torch.where(hit, t2, BIG)
    backface = backface & hit
    hit_pos = _add(ro, _scale(rd, t_hit))

    miss = alive & ~hit
    missed = missed_in | miss
    hit_alive = alive & hit
    emissive = (attrs_t[18], attrs_t[19], attrs_t[20])
    is_emissive = (emissive[0] != 0.0) | (emissive[1] != 0.0) | (emissive[2] != 0.0)
    emis_hit = hit_alive & is_emissive
    front_emis = emis_hit & ~backface

    # ---- emissive handling (reference: kernels/src/lib.rs:85-109) -------------
    if not nee.uses_nee or bounce == 0:
        add_direct = front_emis
        die_emis = emis_hit
    else:
        first_or_nondiffuse = ~last_diffuse
        add_direct = front_emis & first_or_nondiffuse
        if nee.uses_mis:
            die_emis = emis_hit
        else:
            die_emis = emis_hit & (backface | first_or_nondiffuse)
    radiance = _add(radiance, _where(add_direct, _mask_nan(_mul(throughput, emissive)), zero3))
    if nee.uses_mis:
        mis_mask = front_emis & ~add_direct & last_diffuse
        same_light = idx == mis_tri.to(torch.int32)
        light_pdf = t_hit * t_hit / _max(mis_ac, 1e-20)
        weight = _power_heuristic(mis_pdf, light_pdf)
        ok = same_light & (mis_ac > 0.0)
        contrib = _mask_nan(_scale(mis_vec, weight))
        radiance = _add(radiance, _where(mis_mask & ok, contrib, zero3))

    shade = hit_alive & ~die_emis

    # ---- normal interpolation ---------------------------------------------------
    w_b = u
    w_c = v
    w_a = 1.0 - w_b - w_c
    normal = tuple(
        w_a * attrs_t[9 + d] + w_b * attrs_t[12 + d] + w_c * attrs_t[15 + d] for d in range(3)
    )

    # ---- BSDF sample ---------------------------------------------------------------
    albedo = (attrs_t[A], attrs_t[A + 1], attrs_t[A + 2])
    roughness = _max(attrs_t[W.SLIM_ROUGH], EPS)
    metallic = _min(attrs_t[W.SLIM_METAL], 1.0 - EPS)
    dim0 = _AA_DIMS + bounce * _DIMS_PER_BOUNCE + 1
    r1 = lds(sidx, dim0 + 0, offsets)
    r2 = lds(sidx, dim0 + 1, offsets)
    r3 = lds(sidx, dim0 + 2, offsets)
    view = _scale(rd, -1.0)
    pdf, samp_diff, spectrum, direction = _pbr_sample(
        albedo, roughness, metallic, clamp_lo, clamp_hi, view, normal, r1, r2, r3
    )
    if has_glass:
        is_glass = attrs_t[W.SLIM_TRANSMISSION] > 0.0
        gpdf, gspec, gdir = _glass_sample(
            albedo, attrs_t[W.SLIM_IOR], roughness, view, normal, r1, r2, r3
        )
        pdf = torch.where(is_glass, gpdf, pdf)
        samp_diff = samp_diff & ~is_glass
        spectrum = _where(is_glass, gspec, spectrum)
        direction = _where(is_glass, gdir, direction)

    # ---- NEE candidate ---------------------------------------------------------------
    new_pend_con = zero3
    new_pend_elig = torch.zeros_like(alive)
    shadow_ro = shadow_rd = None
    shadow_maxt = zero
    if uses_nee:
        n3 = lds(sidx, dim0 + 5, offsets)
        n4 = lds(sidx, dim0 + 6, offsets)
        l_area, l_pdf, l_va, l_vb, l_vc, l_nrm, l_emi, l_tri = _alias_select(
            entry_rows, n_alias, sidx, dim0, offsets
        )
        r1s = torch.sqrt(_max(n3, 0.0))
        light_point = tuple(
            (1.0 - r1s) * a_ + (r1s * (1.0 - n4)) * b_ + (r1s * n4) * c_
            for a_, b_, c_ in zip(l_va, l_vb, l_vc)
        )
        delta = _sub(light_point, hit_pos)
        light_distance = torch.sqrt(_dot(delta, delta))
        light_dir = _scale(delta, torch.reciprocal(_max(light_distance, 1e-12)))
        cos_l = _dot(l_nrm, _scale(light_dir, -1.0))
        light_pdf = (light_distance * light_distance) / _max(l_area * cos_l, 1e-20)
        light_pdf = torch.where(cos_l > 0.0, light_pdf, 0.0)
        atten, bsdf_pdf = _pbr_eval_pdf_diffuse(
            albedo, roughness, metallic, clamp_lo, clamp_hi, view, normal, light_dir
        )
        if nee.uses_mis:
            weight = _power_heuristic(light_pdf, bsdf_pdf)
        else:
            weight = torch.ones_like(light_pdf)
        wfac = weight / _max(light_pdf, 1e-20) / _max(l_pdf, 1e-20)
        geom_ok = (light_pdf > 0.0) & (bsdf_pdf > 0.0)
        direct = tuple(torch.where(geom_ok, a_ * e_ * wfac, 0.0) for a_, e_ in zip(atten, l_emi))
        contribution = _mul(throughput, direct)
        eligible = shade & samp_diff

        # MIS carry update under the eligible mask
        c_vec = tuple(
            tp * sp * em / (_max(pdf, 1e-20) * _max(l_pdf, 1e-20))
            for tp, sp, em in zip(throughput, spectrum, l_emi)
        )
        c_ac = l_area * _dot(l_nrm, _scale(direction, -1.0))
        mis_vec = _where(eligible, c_vec, mis_vec)
        mis_ac = torch.where(eligible, c_ac, mis_ac)
        mis_pdf = torch.where(eligible, pdf, mis_pdf)
        mis_tri = torch.where(eligible, l_tri, mis_tri)

        shadow_ro = _add(hit_pos, _scale(light_dir, EPS))
        shadow_rd = light_dir
        shadow_maxt = light_distance - EPS * 2.0
        new_pend_con = contribution
        new_pend_elig = eligible & geom_ok

    # ---- throughput & ray update --------------------------------------------------
    pdf_safe = torch.where(pdf.abs() < 1e-20, 1e-20, pdf)
    new_tp = _mask_nan(tuple(tp * sp / pdf_safe for tp, sp in zip(throughput, spectrum)))
    throughput = _where(shade, new_tp, throughput)
    ro = _where(shade, _add(hit_pos, _scale(direction, EPS)), ro)
    rd = _where(shade, direction, rd)
    alive_out = shade

    # ---- russian roulette ------------------------------------------------------------
    if bounce > cfg.min_bounces:
        prob = _min(torch.maximum(torch.maximum(throughput[0], throughput[1]), throughput[2]), 1.0)
        roll = lds(sidx, dim0 + 7, offsets)
        alive_out = alive_out & ~(alive_out & (roll > prob))
        inv_p = torch.reciprocal(_max(prob, 1e-20))
        throughput = _where(alive_out, _scale(throughput, inv_p), throughput)

    # ---- procedural sky on the lanes that escaped (last bounce); an HDR
    # skybox is paid off by the driver from the last bounce's ray rows ----
    if last and not cfg.has_skybox:
        sun = (params[0, 0], params[0, 1], params[0, 2])
        sky = _procedural_sky(sun, params[0, 3], ro, rd)
        radiance = _add(radiance, _where(missed, _mul(throughput, sky), zero3))

    # ---- outputs ---------------------------------------------------------------------------
    def f32(m):
        return torch.where(m, 1.0, 0.0)

    ld_new = (shade & samp_diff) | (~shade & last_diffuse)
    st_out = torch.stack([
        *throughput, *radiance, f32(alive_out), f32(missed), f32(ld_new), *mis_vec,
        mis_ac, mis_pdf, mis_tri, *new_pend_con, f32(new_pend_elig),
    ])
    one = torch.ones_like(zero)
    nf = None
    if not last:
        nf = torch.stack([*rd, *_cross(ro, rd), *ro, one, *([zero] * 6)])
    sf = None
    if uses_nee:
        sf = torch.stack([
            *shadow_rd, *_cross(shadow_ro, shadow_rd), *shadow_ro, one, shadow_maxt,
            *([zero] * 5),
        ])
    return st_out, nf, sf


# ---- CUDA wrapper ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lds_primes(device: torch.device) -> torch.Tensor:
    """The LDS multiplier table as int32 bits on `device` (read by K4)."""
    return torch.from_numpy(_LDS_PRIMES.view(np.int32).copy()).to(device)


def shade_bounce(
    cfg: StaticConfig, bounce: int, params, entry_rows, st, feats_t, t, idx,
    attrs_t, occ, sidx, offsets, has_glass: bool = False, n_alias: int = 0,
):
    """K4 (replaces rustic_tpu shade_kernel.shade_bounce): one bounce of
    shading over B lanes, for alias tables of at most MAX_ALIAS entries.

    params [1, 8] f32: sun direction and intensity (0:4), specular clamp
    (4:6); entry_rows [L_pad, 48] f32; st [NST, B]; feats_t [16, B];
    t [B] f32; idx [B] i32; attrs_t [SLIM_WIDTH, B]; occ [B] i32 (the
    previous bounce's shadow rays) or None; sidx, offsets [B] i32 (u32
    bits); n_alias: the alias entries NEE may pick (0 = no NEE).
    Returns (st_out, next feats or None, shadow feats or None)."""
    if n_alias > MAX_ALIAS:
        raise NotImplementedError(
            f"K4 holds alias tables of at most {MAX_ALIAS} entries; wider tables "
            "go through K8 (shade_bounce_wide) on many tiles and through the "
            "torch-shade loop on one (`supported`)"
        )
    return _run_shade(
        "rt_shade_bounce", "shade_bounce", cfg, bounce, params, entry_rows, st, feats_t, t,
        idx, attrs_t, occ, sidx, offsets, has_glass, n_alias,
    )


def shade_bounce_wide(
    cfg: StaticConfig, bounce: int, params, entry_rows, st, feats_t, t, idx,
    attrs_t, occ, sidx, offsets, has_glass: bool = False, n_alias: int = 0,
):
    """K8 (replaces the prepicked mode of rustic_tpu shade_kernel
    `_build_kernel`, with `resolve.picked_light_rows_t` folded in): K4
    for alias tables of any size, the picked entry row read from the
    global `entry_rows`. Arguments and results as `shade_bounce`."""
    return _run_shade(
        "rt_shade_bounce_wide", "shade_bounce_wide", cfg, bounce, params, entry_rows, st,
        feats_t, t, idx, attrs_t, occ, sidx, offsets, has_glass, n_alias,
    )


def _run_shade(fn, label, cfg, bounce, params, entry_rows, st, feats_t, t, idx, attrs_t, occ,
               sidx, offsets, has_glass, n_alias):
    """The plain version for CPU tensors, else launch entry point `fn` of
    csrc/shade.cu and count it under `label`."""
    if _build.uses_plain(st):
        return shade_bounce_plain(
            cfg, bounce, params, entry_rows, st, feats_t, t, idx, attrs_t, occ,
            sidx, offsets, has_glass=has_glass, n_alias=n_alias,
        )
    dev = st.device
    b = st.shape[1]
    uses_nee = cfg.nee.uses_nee and n_alias > 0
    last = bounce == cfg.max_bounces - 1
    check = _build.check
    check(params, "params", torch.float32, (1, 8), dev)
    check(entry_rows, "entry_rows", torch.float32, (entry_rows.shape[0], W.ENTRY_WIDTH), dev)
    if uses_nee and entry_rows.shape[0] < n_alias:
        raise ValueError(f"entry_rows has {entry_rows.shape[0]} rows, n_alias={n_alias}")
    check(st, "st", torch.float32, (NST, b), dev)
    check(feats_t, "feats_t", torch.float32, (16, b), dev)
    check(t, "t", torch.float32, (b,), dev)
    check(idx, "idx", torch.int32, (b,), dev)
    check(attrs_t, "attrs_t", torch.float32, (W.SLIM_WIDTH, b), dev)
    if occ is not None:
        check(occ, "occ", torch.int32, (b,), dev)
    check(sidx, "sidx", torch.int32, (b,), dev)
    check(offsets, "offsets", torch.int32, (b,), dev)

    st_out = torch.empty((NST, b), dtype=torch.float32, device=dev)
    nf = None if last else torch.empty((16, b), dtype=torch.float32, device=dev)
    sf = torch.empty((16, b), dtype=torch.float32, device=dev) if uses_nee else None
    if b:
        _build.launch(
            _build.entry_point("shade", fn, 14, 10), label, dev,
            (params, entry_rows, st, feats_t, t, idx, attrs_t, occ, sidx, offsets,
             _lds_primes(dev), st_out, nf, sf),
            (b, bounce, cfg.min_bounces, cfg.max_bounces, int(cfg.nee), int(uses_nee),
             int(has_glass), n_alias, entry_rows.shape[0], int(cfg.has_skybox)),
        )
        LAUNCHES[label] += 1
    return st_out, nf, sf


def supported(scene) -> bool:
    """Whether the single-tile kernel-shade loop takes `scene` (twin of
    rustic_tpu shade_kernel.supported, without its TPU-only gates): K1/K2
    emit slim rows, so the scene is untextured, and that loop has no
    pre-pick stage, so the alias table fits K4's in-kernel select."""
    return not scene.has_textures and scene.n_alias_entries <= MAX_ALIAS


def init_state_packed(batch: int, device) -> torch.Tensor:
    st = torch.zeros((NST, batch), dtype=torch.float32, device=device)
    st[SK_THR] = 1.0
    st[SK_ALIVE] = 1.0
    return st
