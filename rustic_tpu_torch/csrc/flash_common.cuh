// Device code shared by the flash scans of flash_intersect.cu (K1-K3,
// K12-K13: one triangle tile), flash_multi.cu (K5-K7, K9-K11: many tiles)
// and flash_resident.cu (K14-K16: many tiles, the table in shared memory),
// and by the fused bounce kernel of fused_bounce.cu (K17).
//
// A (ray, triangle) pair: the ray's feature rows f[0..9] (rd, ro x rd, ro,
// 1) against the triangle's ten G rows, one float4 (det, u, v, t
// numerators) per row; then the exact division epilogue of the JAX
// package's "f32" plan (_epilogue).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace flash {

constexpr float BIG = 1e6f;
constexpr float DET_EPS = 1e-6f;
constexpr float EPS = 1e-3f;
constexpr int NROWS = 10;     // feature rows that meet nonzero G rows
constexpr int MAXT_ROW = 10;  // shadow rays carry maxt in this row
constexpr int CHUNK = 128;    // triangles staged per shared-memory pass

// Stage triangles [c0, c0 + n) of one tile into shared memory as one
// float4 per (row, triangle): sg[r * CHUNK + j]. `g` is the [16,
// row_stride] table; the tile's four TT-wide blocks (det | u | v | t)
// start at column `base`. Every thread of the block takes part.
__device__ __forceinline__ void stage_chunk(float4* sg, const float* __restrict__ g,
                                            size_t row_stride, size_t base, int TT, int c0,
                                            int n) {
  float* sgf = reinterpret_cast<float*>(sg);
  for (int e = threadIdx.x; e < NROWS * 4 * CHUNK; e += blockDim.x) {
    const int j = e % CHUNK;  // fastest: coalesced reads of G
    const int rq = e / CHUNK;
    const int r = rq >> 2, q = rq & 3;
    sgf[(r * CHUNK + j) * 4 + q] =
        j < n ? g[(size_t)r * row_stride + base + (size_t)q * TT + c0 + j] : 0.0f;
  }
}

// The four numerators of one (ray, triangle) pair: a multiply for row 0,
// then one FMA per row, in row order. Every scan sums them this way, so
// two scans give the same bits on the same pair.
__device__ __forceinline__ void pair_accumulate(float4& acc, float fr, const float4 g,
                                                bool first) {
  if (first) {
    acc.x = fr * g.x;
    acc.y = fr * g.y;
    acc.z = fr * g.z;
    acc.w = fr * g.w;
  } else {
    acc.x = fmaf(fr, g.x, acc.x);
    acc.y = fmaf(fr, g.y, acc.y);
    acc.z = fmaf(fr, g.z, acc.z);
    acc.w = fmaf(fr, g.w, acc.w);
  }
}

// The exact division epilogue on a pair's numerators (det, u, v, t). The
// roundings are written out, so that a translation unit built with
// -fmad=false (fused_bounce.cu) and one built with contraction on give the
// same bits: u + v is a rounded add of two rounded products, never an FMA.
__device__ __forceinline__ void pair_epilogue(const float4 acc, float& t, bool& valid) {
  const bool good = fabsf(acc.x) >= DET_EPS;
  const float inv = good ? 1.0f / acc.x : 0.0f;
  const float u = __fmul_rn(acc.y, inv);
  const float v = __fmul_rn(acc.z, inv);
  t = __fmul_rn(acc.w, inv);
  const float u_plus_v = __fadd_rn(u, v);
  valid = good && u >= 0.0f && u <= 1.0f && v >= 0.0f && u_plus_v <= 1.0f && t > EPS;
}

// ---- the skip test: divide only for a pair that may win -----------------
//
// From a pair's numerators (Nd, Nu, Nv, Nt) take the sign of Nd out: D =
// |Nd|, a, b, c = Nu, Nv, Nt with that sign flipped away (exact). The exact
// epilogue's u, v, t are a/D, b/D, c/D within three roundings (2^-22
// relative, also where 1/D is subnormal), so with a margin of DELTA =
// 2^-20 each test below proves that the exact epilogue would not take the
// pair:
//   D < DET_EPS                      the determinant test fails (exact);
//   a or b < -D 2^-100               u or v is a negative normal number;
//   a + b > D (1 + DELTA)            u + v rounds above 1;
//   c <= D EPS (1 - DELTA)           t rounds to at most EPS;
//   c > D lim                        t is above lim / (1 + DELTA).
// `lim` is rn(limit (1 + DELTA)) (`skip_limit`): for the nearest set the
// ray's running best t, so a skipped pair is not strictly closer; for the
// any-hit set its max t, so a skipped pair is not within it (the strict >
// keeps t = inf against max t = inf). Every test fails on NaN, so a NaN
// anywhere leaves the pair to the exact epilogue, as does anything near a
// boundary. The roundings are written
// out, so -fmad=false changes nothing.
constexpr float SKIP_DELTA = 0x1p-20f;

__device__ __forceinline__ float skip_limit(float limit) {
  return __fmul_rn(limit, 1.0f + SKIP_DELTA);
}

__device__ __forceinline__ bool pair_skip(const float4 acc, float lim) {
  const unsigned s = __float_as_uint(acc.x) & 0x80000000u;
  const float d = fabsf(acc.x);
  const float a = __uint_as_float(__float_as_uint(acc.y) ^ s);
  const float b = __uint_as_float(__float_as_uint(acc.z) ^ s);
  const float c = __uint_as_float(__float_as_uint(acc.w) ^ s);
  const float tiny = -__fmul_rn(d, 0x1p-100f);
  return d < DET_EPS || a < tiny || b < tiny ||
         __fadd_rn(a, b) > __fmul_rn(d, 1.0f + SKIP_DELTA) ||
         c <= __fmul_rn(d, EPS * (1.0f - SKIP_DELTA)) || c > __fmul_rn(d, lim);
}

// The nearest set's winner as one 64-bit key, t's bits above the global
// index: for t >= 0 (every valid t, and the miss BIG) the smaller key is
// the smaller t, then the first index, so a min over keys in any order
// equals the strict-< scan in triangle order.
__device__ __forceinline__ unsigned long long win_key(float t, int idx) {
  return ((unsigned long long)__float_as_uint(t) << 32) | (unsigned)idx;
}
__device__ __forceinline__ float win_t(unsigned long long k) {
  return __uint_as_float((unsigned)(k >> 32));
}

// ---- the packed triangle table ---------------------------------------------
//
// K1-K3, K12-K13 and K9-K11 read the table packed once a scene
// (ops/flash_intersect.py `packed_table`) in shared-memory order:
// pg[(tile * NROWS + row) * TT + triangle] = float4(det, u, v, t). A tile's
// live columns of one row are then contiguous, and a block stages them
// with 16-byte cp.async copies that bypass the registers.

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copy of triangles [c0, c0 + n) of packed tile `tile` into
// sg[row * stride + j] (j < n); every thread of the block takes part.
__device__ __forceinline__ void stage_packed(float4* sg, int stride,
                                             const float4* __restrict__ pg, int TT, int tile,
                                             int c0, int n) {
  for (int e = threadIdx.x; e < NROWS * n; e += blockDim.x) {
    const int r = e / n, j = e - r * n;
    cp_async16(sg + r * stride + j, pg + ((size_t)tile * NROWS + r) * TT + c0 + j);
  }
}

// A ray's feature rows from the [16, B] table (zeros when inactive).
__device__ __forceinline__ void load_rows(const float* __restrict__ rows, int B, int ray,
                                          bool active, float (&f)[NROWS]) {
#pragma unroll
  for (int r = 0; r < NROWS; ++r) f[r] = active ? rows[(size_t)r * B + ray] : 0.0f;
}

// ---- the one-tile loop of K1-K3, K12-K13 (flash_intersect.cu) and K17 ----
//
// RPT rays a thread against the L live columns of one tile, staged at
// sg[row * L + j]: each broadcast float4 of G feeds the FMAs of every ray
// of both sets. The caller sets best_t = inf, best_i = 0 and occ (true:
// nothing to test). The nearest fold skips nothing while its best is above
// BIG (the exact scan's first column always lands); elsewhere a pair goes
// to the exact epilogue only where `pair_skip` cannot prove it rejected or
// not closer (any-hit set: not within max t), so the result is the exact
// scan's over every column, strict <, first index. UNROLL: the columns a
// pass of the loop takes (the loop's code grows with it).
template <bool NEAR, bool ANY, int RPT, int UNROLL>
__device__ __forceinline__ void scan_tile(const float4* sg, int L, const float (&f)[RPT][NROWS],
                                          const float (&s)[RPT][NROWS],
                                          const float (&maxt)[RPT], float (&best_t)[RPT],
                                          int (&best_i)[RPT], bool (&occ)[RPT]) {
  float lim_n[RPT], lim_s[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    lim_n[k] = INFINITY;
    lim_s[k] = skip_limit(maxt[k]);
  }
#pragma unroll UNROLL
  for (int j = 0; j < L; ++j) {
    float4 g[NROWS];
#pragma unroll
    for (int r = 0; r < NROWS; ++r) g[r] = sg[r * L + j];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      if (NEAR) {
        float4 acc;
#pragma unroll
        for (int r = 0; r < NROWS; ++r) pair_accumulate(acc, f[k][r], g[r], r == 0);
        if (!(best_t[k] <= BIG) || !pair_skip(acc, lim_n[k])) {
          float t;
          bool valid;
          pair_epilogue(acc, t, valid);
          const float tm = valid ? t : BIG;
          if (tm < best_t[k]) {
            best_t[k] = tm;
            best_i[k] = j;
            lim_n[k] = skip_limit(tm);
          }
        }
      }
      if (ANY && !occ[k]) {
        float4 acc;
#pragma unroll
        for (int r = 0; r < NROWS; ++r) pair_accumulate(acc, s[k][r], g[r], r == 0);
        if (!pair_skip(acc, lim_s[k])) {
          float t;
          bool valid;
          pair_epilogue(acc, t, valid);
          occ[k] = valid && t <= maxt[k];
        }
      }
    }
  }
}

// ---- the one-tile kernels' frame: K1-K3, K12-K13 and K17 ------------------
//
// A persistent block of THREADS threads stages the L live columns of the
// packed table's one tile into sg (then a barrier, which also publishes
// whatever the caller stored in shared memory before), and walks the blocks
// of THREADS * RPT rays: thread tid takes rays rb THREADS RPT + k THREADS +
// tid of both sets, scans them (`scan_tile`) and hands the results to
// `emit(const TileRays<RPT>&)`.
template <int RPT>
struct TileRays {
  int ray[RPT];
  bool active[RPT];
  float best_t[RPT];
  int best_i[RPT];
  bool occ[RPT];
};

template <bool NEAR, bool ANY, int THREADS, int RPT, int UNROLL, class Emit>
__device__ __forceinline__ void scan_ray_blocks(float4* sg, const float4* __restrict__ pg, int TT,
                                                int L, const float* __restrict__ feats,
                                                const float* __restrict__ sh, int B,
                                                Emit&& emit) {
  stage_packed(sg, L, pg, TT, 0, 0, L);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  constexpr int RAYS = THREADS * RPT;
  const int n_blocks = (B + RAYS - 1) / RAYS;
  for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
    TileRays<RPT> r;
    float f[RPT][NROWS], s[RPT][NROWS], maxt[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      r.ray[k] = rb * RAYS + k * THREADS + threadIdx.x;
      r.active[k] = r.ray[k] < B;
      load_rows(feats, B, r.ray[k], NEAR && r.active[k], f[k]);
      load_rows(sh, B, r.ray[k], ANY && r.active[k], s[k]);
      maxt[k] = (ANY && r.active[k]) ? sh[(size_t)MAXT_ROW * B + r.ray[k]] : 0.0f;
      r.best_t[k] = INFINITY;  // the exact scan's first column always lands
      r.best_i[k] = 0;
      r.occ[k] = !(ANY && r.active[k]);  // nothing to test
    }
    scan_tile<NEAR, ANY, RPT, UNROLL>(sg, L, f, s, maxt, r.best_t, r.best_i, r.occ);
    emit(r);
  }
}

// The dynamic shared-memory opt-in of `kernel` up to `most` bytes and the
// device's SM count, at the first call (`sms`: the caller's static for the
// kernel, 0 until then).
template <class K>
inline cudaError_t opt_in(K kernel, size_t most, int& sms) {
  if (sms != 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)most);
  if (e != cudaSuccess) return e;
  int dev = 0;
  cudaGetDevice(&dev);
  return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
}

// A persistent launch's grid: as many blocks as the device runs at once
// (the occupancy query), at most one per ray block, at least one.
template <class K>
inline cudaError_t persistent_grid(K kernel, int threads, size_t smem, int sms, int n_blocks,
                                   int& grid) {
  int per_sm = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  grid = per_sm * sms < n_blocks ? per_sm * sms : n_blocks;
  if (grid < 1) grid = 1;
  return e;
}

// ---- the per-ray tile cull of the grid and resident forms ---------------

// min / max that return NaN when either operand is NaN, as jnp.minimum,
// jnp.maximum and torch.minimum do (fminf/fmaxf drop a NaN operand)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

struct SlabRay {
  float ro[3], inv[3];
};

__device__ __forceinline__ SlabRay slab_ray(const float (&f)[NROWS]) {
  SlabRay r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float d = f[a];
    r.ro[a] = f[6 + a];
    r.inv[a] = fabsf(d) < 1e-12f ? (d < 0.0f ? -1e12f : 1e12f) : 1.0f / d;
  }
  return r;
}

// _tile_possible for one ray: can it reach the box closer than `limit`?
__device__ __forceinline__ bool slab_ok(const SlabRay& r, const float* __restrict__ box,
                                        float limit) {
  float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t1 = (__ldg(box + a) - r.ro[a]) * r.inv[a];
    const float t2 = (__ldg(box + 4 + a) - r.ro[a]) * r.inv[a];
    const float lo = nan_min(t1, t2), hi = nan_max(t1, t2);
    tmin = a == 0 ? lo : nan_max(tmin, lo);
    tmax = a == 0 ? hi : nan_min(tmax, hi);
  }
  return tmax >= tmin && tmax > 0.0f && tmin < limit;
}

}  // namespace flash
