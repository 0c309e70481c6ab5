// Device code of one bounce's shading, shared by shade.cu (K4, K8) and
// fused_bounce.cu (K17): the BSDF, sampling and sky helpers and
// `shade_lane`, the shading of one lane.
//
// What `shade_lane` computes: fold the previous bounce's shadow result into
// the radiance, re-test the winner triangle in exact f32 (Moller-Trumbore),
// add emission with the MIS weight, sample the BSDF (Lambert/GGX or the GGX
// dielectric), pick a light from the alias table and build the shadow ray
// (NEE), update throughput, russian roulette after min_bounces, add the
// procedural sky to escaped lanes on the last bounce (in HDR-sky mode,
// has_skybox, the render loop adds the image sky instead), and write the lane's
// column of the packed state [19, B], of the next ray rows [16, B] and of
// the shadow ray rows [16, B].
//
// The lane's scan results reach it through a source object `src`
// (`has_occ()`, `occ()`, `t()`, `idx()`, `attr(c)`: column c of the
// winner's slim row): K4 and K8 read them from the rows a scan wrote to
// device memory, K17 from the registers of the scan it has just run and
// from the winner's row of the table. Every kernel runs this one body.
//
// Numerics: the operation order of the plain PyTorch twin
// (ops/shade_kernel.py), which follows the JAX kernel; a division by a
// constant is a multiply by its f32 reciprocal, as XLA compiles it. A file
// that includes this header is compiled with -fmad=false so that no product
// is fused into an add: the twin runs one operation per torch kernel and
// rounds every product. max/min/clamp propagate NaN as torch and XLA do.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace shade {

constexpr double PI_D = 3.141592653589793;
constexpr float PI_F = (float)PI_D;
constexpr float TWO_PI = (float)(2.0 * PI_D);
constexpr float INV_PI = 1.0f / PI_F;
constexpr float EPS = 1e-3f;
constexpr float BIG = 1e6f;
constexpr float DET_EPS = 1e-6f;

constexpr double F0S = (1.5 - 1.0) / (1.5 + 1.0);
constexpr float DIELECTRIC_F0 = (float)(F0S * F0S);
constexpr double SPEC_Q = (1.0 - 1.5) / (1.0 + 1.5);  // fresnel(1.0, 1.5, .)
constexpr float SPEC_F0 = (float)(SPEC_Q * SPEC_Q);
constexpr float SPEC_1MF0 = (float)(1.0 - SPEC_Q * SPEC_Q);

static __constant__ float RAY_COEFF[3] = {(float)58e-7, (float)135e-7, (float)331e-7};
static __constant__ float NEG_RAY_COEFF[3] = {(float)-58e-7, (float)-135e-7, (float)-331e-7};
constexpr float MIE_SCATTER = (float)2e-5;
constexpr float MIE_EFFECTIVE = (float)(2e-5 * 1.1);
constexpr float EARTH_RADIUS = (float)6360e3;
constexpr float ATMOSPHERE_RADIUS = (float)6380e3;
constexpr float ATMOSPHERE_RADIUS_SQ = (float)(6380e3 * 6380e3);
constexpr float INV_H_RAY = 1.0f / (float)8e3;
constexpr float INV_H_MIE = 1.0f / (float)12e2;
constexpr int SKY_STEPS = 12;
constexpr float INV_SKY_STEPS = 1.0f / 12.0f;

constexpr int DIMS_PER_BOUNCE = 8;
constexpr int AA_DIMS = 2;
constexpr int ENTRY_WIDTH = 48;
constexpr int MAX_ALIAS = 16;

// entry-row columns (scene/world.py ENTRY_*)
constexpr int E_AREA_A = 0, E_PDF_A = 1, E_AREA_B = 2, E_PDF_B = 3, E_RATIO = 4;
constexpr int E_A_VERTS = 8, E_A_NORMAL = 17, E_A_EMISSION = 20, E_A_TRI = 23;
constexpr int E_B_VERTS = 24, E_B_NORMAL = 33, E_B_EMISSION = 36, E_B_TRI = 39;
// slim attr rows (scene/world.py SLIM_*)
constexpr int A_EMISSIVE = 18, A_ALBEDO = 21, A_ROUGH = 24, A_METAL = 25;
constexpr int A_TRANSMISSION = 26, A_IOR = 27;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float a, float b, float c) { return V3{a, b, c}; }

// column c of a picked alias entry row: shared memory (K4) or global (K8)
template <bool WIDE>
__device__ __forceinline__ float entry_at(const float* row, int c) {
  if constexpr (WIDE) {
    return __ldg(row + c);
  } else {
    return row[c];
  }
}
__device__ __forceinline__ float dot(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 scale(V3 v, float s) { return v3(v.x * s, v.y * s, v.z * s); }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }

// torch.maximum / torch.clamp(min=): NaN propagates, ties keep the first operand
__device__ __forceinline__ float maxp(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? b : a));
}
__device__ __forceinline__ float minp(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}
__device__ __forceinline__ float clip(float x, float lo, float hi) { return minp(maxp(x, lo), hi); }
__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}
__device__ __forceinline__ bool finite3(V3 v) {
  return isfinite(v.x) && isfinite(v.y) && isfinite(v.z);
}
__device__ __forceinline__ V3 mask_nan(V3 v) { return finite3(v) ? v : v3(0.f, 0.f, 0.f); }
__device__ __forceinline__ V3 normalize(V3 v) {
  const float inv = 1.0f / maxp(sqrtf(dot(v, v)), 1e-20f);
  return scale(v, inv);
}
__device__ __forceinline__ float lerp(float a, float b, float t) { return a * (1.0f - t) + b * t; }

// rng.lds: the u32 bits convert through exact 16-bit halves
__device__ __forceinline__ float lds(const int* primes, uint32_t n, int dim, uint32_t off) {
  const uint32_t bits = (uint32_t)primes[dim & 127] * (n + off);
  const float hi = (float)(bits >> 16);
  const float lo = (float)(bits & 0xFFFFu);
  return (hi * 65536.0f + lo) * (1.0f / 4294967296.0f);
}

// ---- sampling / BSDF math (ops/shade_kernel.py) ------------------------------

__device__ __forceinline__ void create_cartesian(V3 up, V3& right, V3& forward) {
  const float ax = (float)0.1, ay = (float)0.5, az = (float)0.9;
  const V3 temp = normalize(v3(up.y * az - up.z * ay, up.z * ax - up.x * az, up.x * ay - up.y * ax));
  right = normalize(cross(temp, up));
  forward = normalize(cross(up, right));
}

__device__ __forceinline__ V3 local_to_world(V3 l, V3 up, V3 right, V3 forward) {
  return normalize(add(add(scale(forward, l.x), scale(up, l.y)), scale(right, l.z)));
}

__device__ __forceinline__ float ggx_distribution(V3 n, V3 h, float roughness) {
  const float a2 = roughness * roughness;
  const float n_dot_h = maxp(dot(n, h), 0.0f);
  float denom = n_dot_h * n_dot_h * (a2 - 1.0f) + 1.0f;
  denom = maxp(PI_F * denom * denom, EPS);
  return a2 / denom;
}

__device__ __forceinline__ V3 sample_ggx(float r1, float r2, V3 refl, float roughness) {
  const float a = roughness * roughness;
  const float phi = TWO_PI * r1;
  const float cos_theta = sqrtf(maxp((1.0f - r2) / (r2 * (a * a - 1.0f) + 1.0f), 0.0f));
  const float sin_theta = sqrtf(maxp(1.0f - cos_theta * cos_theta, 0.0f));
  const V3 h = v3(cosf(phi) * sin_theta, sinf(phi) * sin_theta, cos_theta);
  const bool take_z = fabsf(refl.z) < (float)0.999;
  const V3 up = v3(take_z ? 0.0f : 1.0f, 0.0f, take_z ? 1.0f : 0.0f);
  const V3 tangent = normalize(cross(up, refl));
  const V3 bitangent = cross(refl, tangent);
  return normalize(add(add(scale(tangent, h.x), scale(bitangent, h.y)), scale(refl, h.z)));
}

__device__ __forceinline__ float geometry_schlick_ggx(V3 n, V3 v, float roughness) {
  const float n_dot_v = maxp(dot(n, v), 0.0f);
  const float r = (roughness * roughness) * 0.125f;
  return n_dot_v / (n_dot_v * (1.0f - r) + r);
}

__device__ __forceinline__ float fresnel_tensor(float in_ior, float out_ior, float cos_theta) {
  const float q = (in_ior - out_ior) / (in_ior + out_ior);
  const float f0 = q * q;
  return f0 + (1.0f - f0) * pow5(1.0f - clip(cos_theta, 0.0f, 1.0f));
}

__device__ __forceinline__ float power_heuristic(float p1, float p2) {
  const float p1_2 = p1 * p1;
  return p1_2 / maxp(p1_2 + p2 * p2, 1e-20f);
}

__device__ __forceinline__ float specular_weight(float metallic, float lo, float hi, float n_dot_v) {
  // fresnel(1.0, 1.5, .) with Python-float iors: f0 and 1 - f0 are constants
  const float approx = SPEC_F0 + SPEC_1MF0 * pow5(1.0f - clip(maxp(n_dot_v, 0.0f), 0.0f, 1.0f));
  const float w = lerp(approx, 1.0f, metallic);
  const float clamped = minp(maxp(w, lo), hi);
  return (w != 0.0f && w != 1.0f) ? clamped : w;
}

__device__ __forceinline__ V3 ks_of(V3 albedo, float metallic, float h_dot_v) {
  const float ct = clip(maxp(h_dot_v, 0.0f), 0.0f, 1.0f);
  const float s5 = pow5(1.0f - ct);
  return v3(lerp(DIELECTRIC_F0, albedo.x, metallic) * (1.0f - s5) + s5,
            lerp(DIELECTRIC_F0, albedo.y, metallic) * (1.0f - s5) + s5,
            lerp(DIELECTRIC_F0, albedo.z, metallic) * (1.0f - s5) + s5);
}

__device__ __forceinline__ V3 eval_diffuse(V3 albedo, float metallic, float cos_theta, float sw, V3 ks) {
  const float f = cos_theta / maxp(1.0f - sw, 1e-8f);
  return v3((1.0f - ks.x) * (1.0f - metallic) * albedo.x * INV_PI * f,
            (1.0f - ks.y) * (1.0f - metallic) * albedo.y * INV_PI * f,
            (1.0f - ks.z) * (1.0f - metallic) * albedo.z * INV_PI * f);
}

__device__ __forceinline__ V3 eval_specular(float roughness, V3 view, V3 normal, V3 light,
                                            float cos_theta, float d_term, float sw, V3 ks) {
  const float g = geometry_schlick_ggx(normal, view, roughness) *
                  geometry_schlick_ggx(normal, light, roughness);
  const float denom = maxp(4.0f * maxp(dot(normal, view), 0.0f) * cos_theta, EPS);
  const float f = cos_theta / maxp(sw, 1e-8f);
  const float dg = d_term * g;
  return v3(dg * ks.x / denom * f, dg * ks.y / denom * f, dg * ks.z / denom * f);
}

static __device__ void pbr_sample(V3 albedo, float roughness, float metallic, float lo, float hi,
                           V3 view, V3 normal, float r1, float r2, float r3,
                           float& pdf, bool& samp_diff, V3& spectrum, V3& direction) {
  const float sw = specular_weight(metallic, lo, hi, dot(normal, view));
  V3 right, forward;
  create_cartesian(normal, right, forward);
  const float cos_t = sqrtf(maxp(r1, 0.0f));
  const float sin_t = sqrtf(maxp(1.0f - r1, 0.0f));
  const float phi = TWO_PI * r2;
  const V3 diff_dir = local_to_world(v3(sin_t * cosf(phi), cos_t, sin_t * sinf(phi)), normal, right, forward);
  const V3 nview = scale(view, -1.0f);
  const V3 refl = sub(nview, scale(normal, 2.0f * dot(nview, normal)));
  const V3 spec_dir = sample_ggx(r1, r2, refl, roughness);

  const bool take_spec = r3 < sw;
  direction = sel(take_spec, spec_dir, diff_dir);
  const float cos_theta = maxp(dot(normal, direction), EPS);
  const V3 halfway = normalize(add(view, direction));
  const V3 ks = ks_of(albedo, metallic, dot(halfway, view));
  const float d_term = ggx_distribution(normal, halfway, roughness);
  const float pdf_d = cos_theta * INV_PI;
  const V3 spec_d = eval_diffuse(albedo, metallic, cos_theta, sw, ks);
  const float pdf_s = (d_term * dot(normal, halfway)) / (4.0f * dot(view, halfway));
  const V3 spec_s = eval_specular(roughness, view, normal, direction, cos_theta, d_term, sw, ks);
  pdf = take_spec ? pdf_s : pdf_d;
  spectrum = sel(take_spec, spec_s, spec_d);
  samp_diff = !take_spec;
}

static __device__ void glass_sample(V3 albedo, float ior, float roughness, V3 view, V3 normal,
                             float r1, float r2, float r3, V3& spectrum, V3& direction) {
  const bool inside = dot(normal, view) < 0.0f;
  const V3 n = sel(inside, scale(normal, -1.0f), normal);
  const float in_ior = inside ? ior : 1.0f;
  const float out_ior = inside ? 1.0f : ior;

  const float a_g = roughness * roughness;
  const float q = (a_g * sqrtf(maxp(r1, 0.0f))) / sqrtf(maxp(1.0f - r1, 1e-20f));
  const float inv_h = 1.0f / sqrtf(1.0f + q * q);
  const float cos_t = inv_h;
  const float sin_t = q * inv_h;
  const float phi_m = TWO_PI * r2;
  V3 right, forward;
  create_cartesian(n, right, forward);
  const V3 m = local_to_world(v3(sin_t * cosf(phi_m), cos_t, sin_t * sinf(phi_m)), n, right, forward);

  const float fresnel = fresnel_tensor(in_ior, out_ior, maxp(dot(m, view), 0.0f));
  const V3 reflect_dir = normalize(sub(scale(m, 2.0f * fabsf(dot(view, m))), view));
  const float eta = in_ior / out_ior;
  const float c = dot(view, m);
  const float k = 1.0f + eta * eta * (c * c - 1.0f);
  const float vn = dot(view, n);
  const float sign_vn = vn > 0.0f ? 1.0f : (vn < 0.0f ? -1.0f : (vn != vn ? vn : 0.0f));
  const float refr_scale = eta * c - sign_vn * sqrtf(maxp(k, 0.0f));
  const V3 refract_dir = normalize(sub(scale(m, refr_scale), scale(view, eta)));

  const bool reflecting = r3 <= fresnel;
  direction = sel(reflecting, reflect_dir, refract_dir);
  spectrum = sel(reflecting, v3(1.0f, 1.0f, 1.0f), albedo);
}

__device__ __forceinline__ float sky_escape(V3 p, V3 d) {
  const float vx = p.x, vy = p.y + EARTH_RADIUS, vz = p.z;
  const float b = vx * d.x + vy * d.y + vz * d.z;
  const float det = b * b - (vx * vx + vy * vy + vz * vz) + ATMOSPHERE_RADIUS_SQ;
  const float sq = sqrtf(maxp(det, 0.0f));
  const float t1 = -b - sq;
  const float t2 = -b + sq;
  const float t = t1 >= 0.0f ? t1 : t2;
  return det < 0.0f ? -1.0f : t;
}

__device__ __forceinline__ void sky_densities(V3 p, float& dr, float& dm) {
  const float vx = p.x, vy = p.y + EARTH_RADIUS, vz = p.z;
  const float h = maxp(sqrtf(vx * vx + vy * vy + vz * vz) - EARTH_RADIUS, 0.0f);
  dr = expf(-h * INV_H_RAY);
  dm = expf(-h * INV_H_MIE);
}

static __device__ V3 procedural_sky(V3 sun, float intensity, V3 ro, V3 rd) {
  const float depth = sky_escape(ro, rd) * INV_SKY_STEPS;
  float i_r[3] = {0.f, 0.f, 0.f}, i_m[3] = {0.f, 0.f, 0.f};
  float total_r = 0.0f, total_m = 0.0f;
  for (int i = 0; i < SKY_STEPS; ++i) {
    const V3 p = add(ro, scale(rd, depth * (float)i));
    float r0, m0;
    sky_densities(p, r0, m0);
    const float dr = r0 * depth;
    const float dm = m0 * depth;
    total_r = total_r + dr;
    total_m = total_m + dm;
    const float l = sky_escape(p, sun);
    float r1, m1;
    sky_densities(add(p, scale(sun, l)), r1, m1);
    const float sr = r0 * (l * 0.5f) + r1 * (l * 0.5f);
    const float sm = m0 * (l * 0.5f) + m1 * (l * 0.5f);
    const float depth_r = total_r + sr;
    const float depth_m = total_m + sm;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float a = expf(NEG_RAY_COEFF[ch] * depth_r - MIE_EFFECTIVE * depth_m);
      i_r[ch] = i_r[ch] + a * dr;
      i_m[ch] = i_m[ch] + a * dm;
    }
  }
  const float mu = dot(rd, sun);
  const float ph = maxp((float)1.58 - (float)1.52 * mu, (float)1e-6);
  const float phase_mie = (float)0.0196 / (ph * sqrtf(ph));
  const float sc = intensity * (1.0f + mu * mu);
  float out[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float res = sc * (i_r[ch] * RAY_COEFF[ch] * (float)0.0597 + i_m[ch] * MIE_SCATTER * phase_mie);
    float g = sqrtf(maxp(res, 0.0f));
    g = isfinite(g) ? g : 0.0f;
    const float safe = maxp(g, 1e-20f);
    out[ch] = g > 0.0f ? expf((float)2.2 * logf(safe)) : 0.0f;
  }
  return v3(out[0], out[1], out[2]);
}

// What one bounce's launch hands every lane.
struct Bounce {
  const float* params;  // [8]: sun direction and intensity, specular clamp
  const int* sidx;      // [B] sample indices (u32 bits)
  const int* offsets;   // [B] per-pixel LDS offsets (u32 bits)
  const int* primes;    // [128] LDS multipliers
  int B, bounce, min_bounces, max_bounces, nee, uses_nee, has_glass, n_alias, has_skybox;
};

// Shade lane i. `entry_table`: the alias entry rows [n_alias, 48], in shared
// memory (WIDE off) or in device memory (WIDE on); rd, ro: the lane's ray;
// st: the packed state [19, B]; the three outputs as the kernels' (nf_out
// unused on the last bounce, sf_out without NEE).
template <bool WIDE, class Src>
__device__ __forceinline__ void shade_lane(const Bounce& p, const float* entry_table,
                                           const float* __restrict__ st, V3 rd, V3 ro,
                                           const Src& src, float* __restrict__ st_out,
                                           float* __restrict__ nf_out,
                                           float* __restrict__ sf_out, int i) {
  const float* params = p.params;
  const int* primes = p.primes;
  const int B = p.B, bounce = p.bounce, min_bounces = p.min_bounces;
  const int max_bounces = p.max_bounces, nee = p.nee, uses_nee = p.uses_nee;
  const int has_glass = p.has_glass, n_alias = p.n_alias, has_skybox = p.has_skybox;
  const bool last = bounce == max_bounces - 1;
  const bool nee_on = nee != 0;
  const bool mis = nee == 1;
  const float clamp_lo = params[4];
  const float clamp_hi = params[5];
  const V3 zero3 = v3(0.f, 0.f, 0.f);
#define ROW(p, r) (p)[(size_t)(r) * B + i]

  V3 thr = v3(ROW(st, 0), ROW(st, 1), ROW(st, 2));
  V3 rad = v3(ROW(st, 3), ROW(st, 4), ROW(st, 5));
  const bool alive = ROW(st, 6) > 0.5f;
  const bool missed_in = ROW(st, 7) > 0.5f;
  const bool last_diffuse = ROW(st, 8) > 0.5f;
  V3 mis_vec = v3(ROW(st, 9), ROW(st, 10), ROW(st, 11));
  float mis_ac = ROW(st, 12);
  float mis_pdf = ROW(st, 13);
  float mis_tri = ROW(st, 14);

  // ---- fold the previous bounce's shadow result
  if (src.has_occ()) {
    const V3 pend = v3(ROW(st, 15), ROW(st, 16), ROW(st, 17));
    const bool lit = ROW(st, 18) > 0.5f && src.occ() == 0;
    rad = add(rad, sel(lit, mask_nan(pend), zero3));
  }

  // ---- exact winner re-test
  const V3 a3 = v3(src.attr(0), src.attr(1), src.attr(2));
  const V3 b3 = v3(src.attr(3), src.attr(4), src.attr(5));
  const V3 c3 = v3(src.attr(6), src.attr(7), src.attr(8));
  const V3 e1 = sub(b3, a3);
  const V3 e2 = sub(c3, a3);
  const V3 pv = cross(rd, e2);
  const float det = dot(e1, pv);
  bool backface = det < 0.0f;
  const bool good = fabsf(det) >= DET_EPS;
  const float inv_det = good ? 1.0f / det : 0.0f;
  const V3 tv = sub(ro, a3);
  const float u = dot(tv, pv) * inv_det;
  const V3 qv = cross(tv, e1);
  const float v = dot(rd, qv) * inv_det;
  const float t2 = dot(e2, qv) * inv_det;
  const bool valid = good && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t2 > EPS;
  const bool hit = src.t() < BIG && valid;
  const float t_hit = hit ? t2 : BIG;
  backface = backface && hit;
  const V3 hit_pos = add(ro, scale(rd, t_hit));

  const bool missed = missed_in || (alive && !hit);
  const bool hit_alive = alive && hit;
  const V3 emissive = v3(src.attr(A_EMISSIVE), src.attr(A_EMISSIVE + 1), src.attr(A_EMISSIVE + 2));
  const bool is_emissive = emissive.x != 0.0f || emissive.y != 0.0f || emissive.z != 0.0f;
  const bool emis_hit = hit_alive && is_emissive;
  const bool front_emis = emis_hit && !backface;

  // ---- emissive handling (reference: kernels/src/lib.rs:85-109)
  bool add_direct, die_emis;
  if (!nee_on || bounce == 0) {
    add_direct = front_emis;
    die_emis = emis_hit;
  } else {
    const bool first_or_nondiffuse = !last_diffuse;
    add_direct = front_emis && first_or_nondiffuse;
    die_emis = mis ? emis_hit : (emis_hit && (backface || first_or_nondiffuse));
  }
  rad = add(rad, sel(add_direct, mask_nan(mul(thr, emissive)), zero3));
  if (mis) {
    const bool mis_mask = front_emis && !add_direct && last_diffuse;
    const bool same_light = src.idx() == (int)mis_tri;
    const float light_pdf = t_hit * t_hit / maxp(mis_ac, 1e-20f);
    const float weight = power_heuristic(mis_pdf, light_pdf);
    const bool ok = same_light && mis_ac > 0.0f;
    const V3 contrib = mask_nan(scale(mis_vec, weight));
    rad = add(rad, sel(mis_mask && ok, contrib, zero3));
  }
  const bool shade = hit_alive && !die_emis;

  // ---- normal interpolation
  const float w_b = u;
  const float w_c = v;
  const float w_a = 1.0f - w_b - w_c;
  const V3 normal = v3(w_a * src.attr(9) + w_b * src.attr(12) + w_c * src.attr(15),
                       w_a * src.attr(10) + w_b * src.attr(13) + w_c * src.attr(16),
                       w_a * src.attr(11) + w_b * src.attr(14) + w_c * src.attr(17));

  // ---- BSDF sample
  const V3 albedo = v3(src.attr(A_ALBEDO), src.attr(A_ALBEDO + 1), src.attr(A_ALBEDO + 2));
  const float roughness = maxp(src.attr(A_ROUGH), EPS);
  const float metallic = minp(src.attr(A_METAL), (float)(1.0 - 1e-3));
  const uint32_t n_u = (uint32_t)p.sidx[i];
  const uint32_t off = (uint32_t)p.offsets[i];
  const int dim0 = AA_DIMS + bounce * DIMS_PER_BOUNCE + 1;
  const float r1 = lds(primes, n_u, dim0 + 0, off);
  const float r2 = lds(primes, n_u, dim0 + 1, off);
  const float r3 = lds(primes, n_u, dim0 + 2, off);
  const V3 view = scale(rd, -1.0f);
  float pdf;
  bool samp_diff;
  V3 spectrum, direction;
  pbr_sample(albedo, roughness, metallic, clamp_lo, clamp_hi, view, normal, r1, r2, r3,
             pdf, samp_diff, spectrum, direction);
  if (has_glass && src.attr(A_TRANSMISSION) > 0.0f) {
    glass_sample(albedo, src.attr(A_IOR), roughness, view, normal, r1, r2, r3, spectrum, direction);
    pdf = 1.0f;
    samp_diff = false;
  }

  // ---- NEE candidate
  V3 new_pend_con = zero3;
  bool new_pend_elig = false;
  V3 shadow_ro = zero3, shadow_rd = zero3;
  float shadow_maxt = 0.0f;
  if (uses_nee) {
    const float n3 = lds(primes, n_u, dim0 + 5, off);
    const float n4 = lds(primes, n_u, dim0 + 6, off);
    const float n1 = lds(primes, n_u, dim0 + 3, off);
    const float n2 = lds(primes, n_u, dim0 + 4, off);
    // float -> int truncates, as XLA's and torch's conversions do
    const int entry = min(max((int)(n1 * (float)n_alias), 0), n_alias - 1);
    const float* row = entry_table + (size_t)entry * ENTRY_WIDTH;
    const bool take = n2 < entry_at<WIDE>(row, E_RATIO);
#define PICK(ca, cb) (0.0f + (take ? entry_at<WIDE>(row, (ca)) : entry_at<WIDE>(row, (cb))))
#define PICK3(sa, sb) v3(PICK((sa), (sb)), PICK((sa) + 1, (sb) + 1), PICK((sa) + 2, (sb) + 2))
    const float l_area = PICK(E_AREA_A, E_AREA_B);
    const float l_pdf = PICK(E_PDF_A, E_PDF_B);
    const V3 l_va = PICK3(E_A_VERTS, E_B_VERTS);
    const V3 l_vb = PICK3(E_A_VERTS + 3, E_B_VERTS + 3);
    const V3 l_vc = PICK3(E_A_VERTS + 6, E_B_VERTS + 6);
    const V3 l_nrm = PICK3(E_A_NORMAL, E_B_NORMAL);
    const V3 l_emi = PICK3(E_A_EMISSION, E_B_EMISSION);
    const float l_tri = PICK(E_A_TRI, E_B_TRI);
#undef PICK3
#undef PICK

    const float r1s = sqrtf(maxp(n3, 0.0f));
    const float wa = 1.0f - r1s, wb = r1s * (1.0f - n4), wc = r1s * n4;
    const V3 light_point = v3(wa * l_va.x + wb * l_vb.x + wc * l_vc.x,
                              wa * l_va.y + wb * l_vb.y + wc * l_vc.y,
                              wa * l_va.z + wb * l_vb.z + wc * l_vc.z);
    const V3 delta = sub(light_point, hit_pos);
    const float light_distance = sqrtf(dot(delta, delta));
    const V3 light_dir = scale(delta, 1.0f / maxp(light_distance, 1e-12f));
    const float cos_l = dot(l_nrm, scale(light_dir, -1.0f));
    float light_pdf = (light_distance * light_distance) / maxp(l_area * cos_l, 1e-20f);
    light_pdf = cos_l > 0.0f ? light_pdf : 0.0f;

    // the diffuse lobe toward the light
    const float sw = specular_weight(metallic, clamp_lo, clamp_hi, dot(normal, view));
    const float cos_theta = maxp(dot(normal, light_dir), 0.0f);
    const V3 halfway = normalize(add(view, light_dir));
    const V3 ks = ks_of(albedo, metallic, dot(halfway, view));
    const V3 atten = eval_diffuse(albedo, metallic, cos_theta, sw, ks);
    const float bsdf_pdf = maxp(dot(normal, light_dir), 0.0f) * INV_PI;

    const float weight = mis ? power_heuristic(light_pdf, bsdf_pdf) : 1.0f;
    const float wfac = weight / maxp(light_pdf, 1e-20f) / maxp(l_pdf, 1e-20f);
    const bool geom_ok = light_pdf > 0.0f && bsdf_pdf > 0.0f;
    const V3 direct = v3(geom_ok ? atten.x * l_emi.x * wfac : 0.0f,
                         geom_ok ? atten.y * l_emi.y * wfac : 0.0f,
                         geom_ok ? atten.z * l_emi.z * wfac : 0.0f);
    const V3 contribution = mul(thr, direct);
    const bool eligible = shade && samp_diff;

    // MIS carry update under the eligible mask
    const float den = maxp(pdf, 1e-20f) * maxp(l_pdf, 1e-20f);
    const V3 c_vec = v3(thr.x * spectrum.x * l_emi.x / den, thr.y * spectrum.y * l_emi.y / den,
                        thr.z * spectrum.z * l_emi.z / den);
    const float c_ac = l_area * dot(l_nrm, scale(direction, -1.0f));
    mis_vec = sel(eligible, c_vec, mis_vec);
    mis_ac = eligible ? c_ac : mis_ac;
    mis_pdf = eligible ? pdf : mis_pdf;
    mis_tri = eligible ? l_tri : mis_tri;

    shadow_ro = add(hit_pos, scale(light_dir, EPS));
    shadow_rd = light_dir;
    shadow_maxt = light_distance - EPS * 2.0f;
    new_pend_con = contribution;
    new_pend_elig = eligible && geom_ok;
  }

  // ---- throughput & ray update
  const float pdf_safe = fabsf(pdf) < 1e-20f ? 1e-20f : pdf;
  const V3 new_tp = mask_nan(v3(thr.x * spectrum.x / pdf_safe, thr.y * spectrum.y / pdf_safe,
                                thr.z * spectrum.z / pdf_safe));
  thr = sel(shade, new_tp, thr);
  ro = sel(shade, add(hit_pos, scale(direction, EPS)), ro);
  rd = sel(shade, direction, rd);
  bool alive_out = shade;

  // ---- russian roulette
  if (bounce > min_bounces) {
    const float prob = minp(maxp(maxp(thr.x, thr.y), thr.z), 1.0f);
    const float roll = lds(primes, n_u, dim0 + 7, off);
    alive_out = alive_out && !(alive_out && roll > prob);
    const float inv_p = 1.0f / maxp(prob, 1e-20f);
    thr = sel(alive_out, scale(thr, inv_p), thr);
  }

  // ---- procedural sky on the lanes that escaped (last bounce); with an
  // HDR skybox the render loop adds the image sky after this bounce
  // (runtime/pipeline.py hdr_sky_payoff), as the JAX kernel leaves it to XLA
  if (last && !has_skybox) {
    const V3 sun = v3(params[0], params[1], params[2]);
    const V3 term = missed ? mul(thr, procedural_sky(sun, params[3], ro, rd)) : zero3;
    rad = add(rad, term);
  }

  // ---- outputs
  const bool ld_new = (shade && samp_diff) || (!shade && last_diffuse);
  ROW(st_out, 0) = thr.x;
  ROW(st_out, 1) = thr.y;
  ROW(st_out, 2) = thr.z;
  ROW(st_out, 3) = rad.x;
  ROW(st_out, 4) = rad.y;
  ROW(st_out, 5) = rad.z;
  ROW(st_out, 6) = alive_out ? 1.0f : 0.0f;
  ROW(st_out, 7) = missed ? 1.0f : 0.0f;
  ROW(st_out, 8) = ld_new ? 1.0f : 0.0f;
  ROW(st_out, 9) = mis_vec.x;
  ROW(st_out, 10) = mis_vec.y;
  ROW(st_out, 11) = mis_vec.z;
  ROW(st_out, 12) = mis_ac;
  ROW(st_out, 13) = mis_pdf;
  ROW(st_out, 14) = mis_tri;
  ROW(st_out, 15) = new_pend_con.x;
  ROW(st_out, 16) = new_pend_con.y;
  ROW(st_out, 17) = new_pend_con.z;
  ROW(st_out, 18) = new_pend_elig ? 1.0f : 0.0f;
  if (!last) {
    const V3 cr = cross(ro, rd);
    ROW(nf_out, 0) = rd.x;
    ROW(nf_out, 1) = rd.y;
    ROW(nf_out, 2) = rd.z;
    ROW(nf_out, 3) = cr.x;
    ROW(nf_out, 4) = cr.y;
    ROW(nf_out, 5) = cr.z;
    ROW(nf_out, 6) = ro.x;
    ROW(nf_out, 7) = ro.y;
    ROW(nf_out, 8) = ro.z;
    ROW(nf_out, 9) = 1.0f;
    for (int r = 10; r < 16; ++r) ROW(nf_out, r) = 0.0f;
  }
  if (uses_nee) {
    const V3 scr = cross(shadow_ro, shadow_rd);
    ROW(sf_out, 0) = shadow_rd.x;
    ROW(sf_out, 1) = shadow_rd.y;
    ROW(sf_out, 2) = shadow_rd.z;
    ROW(sf_out, 3) = scr.x;
    ROW(sf_out, 4) = scr.y;
    ROW(sf_out, 5) = scr.z;
    ROW(sf_out, 6) = shadow_ro.x;
    ROW(sf_out, 7) = shadow_ro.y;
    ROW(sf_out, 8) = shadow_ro.z;
    ROW(sf_out, 9) = 1.0f;
    ROW(sf_out, 10) = shadow_maxt;
    for (int r = 11; r < 16; ++r) ROW(sf_out, r) = 0.0f;
  }
#undef ROW
}

}  // namespace shade
