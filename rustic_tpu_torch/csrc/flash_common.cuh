// Device code shared by the flash scans of flash_intersect.cu (K1-K3,
// one triangle tile) and flash_multi.cu (K5-K7, many tiles).
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

// One (ray, triangle) pair: the exact division epilogue.
__device__ __forceinline__ void pair_test(const float (&f)[NROWS], const float4* sg, int j,
                                          float& t, bool& valid) {
  float4 acc;
  {
    const float4 g = sg[j];
    acc.x = f[0] * g.x;
    acc.y = f[0] * g.y;
    acc.z = f[0] * g.z;
    acc.w = f[0] * g.w;
  }
#pragma unroll
  for (int r = 1; r < NROWS; ++r) {
    const float4 g = sg[r * CHUNK + j];
    acc.x = fmaf(f[r], g.x, acc.x);
    acc.y = fmaf(f[r], g.y, acc.y);
    acc.z = fmaf(f[r], g.z, acc.z);
    acc.w = fmaf(f[r], g.w, acc.w);
  }
  const bool good = fabsf(acc.x) >= DET_EPS;
  const float inv = good ? 1.0f / acc.x : 0.0f;
  const float u = acc.y * inv;
  const float v = acc.z * inv;
  t = acc.w * inv;
  valid = good && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > EPS;
}

// A ray's feature rows from the [16, B] table (zeros when inactive).
__device__ __forceinline__ void load_rows(const float* __restrict__ rows, int B, int ray,
                                          bool active, float (&f)[NROWS]) {
#pragma unroll
  for (int r = 0; r < NROWS; ++r) f[r] = active ? rows[(size_t)r * B + ray] : 0.0f;
}

}  // namespace flash
