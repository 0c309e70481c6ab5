// Single-tile flash intersection scans (kernels K1-K3 and K12-K13) for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels of rustic_tpu/ops/flash_intersect.py:
//   rt_nearest_attrs         <- _nearest_single_attrs         (flash_nearest_attrs_t)
//   rt_nearest_shadow_attrs  <- _nearest_shadow_single_attrs  (flash_nearest_shadow_attrs_t)
//   rt_occlude               <- _occlude_single               (flash_occlude_packed_t)
//   rt_nearest               <- _nearest_single               (flash_nearest, one tile)
//   rt_nearest_shadow        <- _nearest_shadow_single        (flash_nearest_shadow, one tile)
// The last two (K12, K13) are K1 and K2 without the copy of the winner's
// shading row: the consumer gathers the row itself, at whatever width the
// scene's table has (textured scenes: 64 floats). They are the same
// template with ATTRS off, so they return K1/K2's (t, idx, occ) bit for bit.
//
// What they compute: for each ray (feature rows F[16, B] = rd, ro x rd, ro,
// 1, maxt) and each triangle of the one tile (G[16, 4*TT] = the det, u*det,
// v*det, t*det columns), the four Moller-Trumbore numerators are 10-term
// dot products; the epilogue divides exactly, tests the window, and either
// keeps the nearest valid t (strict <, in triangle order, so the first
// index wins among equal minima; a miss gives t = BIG, idx = 0) or any hit
// within (EPS, maxt]. The nearest scans then copy row idx of the f32 slim
// shading table into attrsT[:, ray]. These are the numerics of the JAX
// package's "f32" plan (_epilogue, _tile_minarg, _tile_anyhit).
//
// What bounds them: about 55 flops per (ray, triangle) pair (40 FMA for the
// four dots, one IEEE division, three multiplies, the compares). At the
// main path's 3,686,400 lanes and 256 triangles that is ~52 GFLOP per scan,
// so the scans are FP32 issue bound; a ray reads 40-80 B of features and
// writes 8 B plus its 128 B attr row.
//
// Design: one thread per ray, its feature values in registers. The block
// stages the 10 used rows of G into shared memory 128 triangles at a time
// (20 KB) as one float4 (det, u, v, t numerators) per (row, triangle), and
// every thread of the block reads the same float4 (a broadcast, no bank
// conflict), so each pair costs 10 shared loads for 40 FMA. What the TPU
// kernels needed and Hopper does not is not carried over: the MXU dot
// plans and top-2 carry, the [R,128] lane tiling, and the bf16 hi/mid/lo
// attr split read by a one-hot matmul (here a direct row read of the f32
// table, which stays in L1/L2: 32 KB at 256 triangles).

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int THREADS = 128;  // rays per block

template <bool NEAR, bool ANY, bool ATTRS>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const float* __restrict__ feats, const float* __restrict__ sh,
            const float* __restrict__ g, const float* __restrict__ attrs,
            float* __restrict__ t_out, int* __restrict__ idx_out,
            int* __restrict__ occ_out, float* __restrict__ attrs_out,
            int B, int TT, int W) {
  __shared__ float4 sg[NROWS * CHUNK];  // [row][triangle] -> (det, u, v, t)

  const int ray = blockIdx.x * THREADS + threadIdx.x;
  const bool active = ray < B;
  float f[NROWS], s[NROWS];
  load_rows(feats, B, ray, NEAR && active, f);
  load_rows(sh, B, ray, ANY && active, s);
  const float maxt = (ANY && active) ? sh[(size_t)MAXT_ROW * B + ray] : 0.0f;

  float best_t = INFINITY;
  int best_i = 0;
  bool occ = false;
  for (int c0 = 0; c0 < TT; c0 += CHUNK) {
    const int n = min(CHUNK, TT - c0);
    __syncthreads();  // the previous chunk is consumed
    stage_chunk(sg, g, (size_t)4 * TT, 0, TT, c0, n);
    __syncthreads();
    if (!active) continue;
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      if (NEAR) {
        float t;
        bool valid;
        pair_test(f, sg, j, t, valid);
        const float tm = valid ? t : BIG;
        if (tm < best_t) {
          best_t = tm;
          best_i = c0 + j;
        }
      }
      if (ANY && !occ) {
        float t;
        bool valid;
        pair_test(s, sg, j, t, valid);
        occ = valid && t <= maxt;
      }
    }
  }
  if (!active) return;
  if (NEAR) {
    t_out[ray] = best_t;
    idx_out[ray] = best_i;
    if (ATTRS) {
      const float* row = attrs + (size_t)best_i * W;
      for (int w = 0; w < W; ++w) attrs_out[(size_t)w * B + ray] = row[w];
    }
  }
  if (ANY) occ_out[ray] = occ ? 1 : 0;
}

inline dim3 grid_for(int B) { return dim3((B + THREADS - 1) / THREADS); }

}  // namespace

extern "C" int rt_nearest_attrs(const float* feats, const float* g, const float* attrs,
                                float* t, int* idx, float* attrs_t,
                                int B, int TT, int W, void* stream) {
  scan_kernel<true, false, true><<<grid_for(B), THREADS, 0, (cudaStream_t)stream>>>(
      feats, nullptr, g, attrs, t, idx, nullptr, attrs_t, B, TT, W);
  return (int)cudaGetLastError();
}

extern "C" int rt_nearest_shadow_attrs(const float* feats, const float* sh, const float* g,
                                       const float* attrs, float* t, int* idx, int* occ,
                                       float* attrs_t, int B, int TT, int W, void* stream) {
  scan_kernel<true, true, true><<<grid_for(B), THREADS, 0, (cudaStream_t)stream>>>(
      feats, sh, g, attrs, t, idx, occ, attrs_t, B, TT, W);
  return (int)cudaGetLastError();
}

extern "C" int rt_occlude(const float* sh, const float* g, int* occ, int B, int TT,
                          void* stream) {
  scan_kernel<false, true, false><<<grid_for(B), THREADS, 0, (cudaStream_t)stream>>>(
      nullptr, sh, g, nullptr, nullptr, nullptr, occ, nullptr, B, TT, 0);
  return (int)cudaGetLastError();
}

extern "C" int rt_nearest(const float* feats, const float* g, float* t, int* idx, int B, int TT,
                          void* stream) {
  scan_kernel<true, false, false><<<grid_for(B), THREADS, 0, (cudaStream_t)stream>>>(
      feats, nullptr, g, nullptr, t, idx, nullptr, nullptr, B, TT, 0);
  return (int)cudaGetLastError();
}

extern "C" int rt_nearest_shadow(const float* feats, const float* sh, const float* g, float* t,
                                 int* idx, int* occ, int B, int TT, void* stream) {
  scan_kernel<true, true, false><<<grid_for(B), THREADS, 0, (cudaStream_t)stream>>>(
      feats, sh, g, nullptr, t, idx, occ, nullptr, B, TT, 0);
  return (int)cudaGetLastError();
}
