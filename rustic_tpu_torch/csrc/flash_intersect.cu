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
// What bounds them: about 81 flops per (ray, triangle) pair (40 FMA for the
// four dots and the epilogue). At the main path's 3,686,400 lanes and
// DarkCornell's 184 triangles that is ~55 GFLOP per merged scan, so the
// scans are FP32 issue bound; a ray reads 40-80 B of features and writes
// 8 B plus its 128 B attr row.
//
// Design. The table's padding columns are all zero and never valid, so a
// scan walks the `n_live` live triangles only (the scene's triangle count;
// the whole tile width when the caller does not give it). A block stages
// those columns of the ten used G rows once, from the table packed in
// shared-memory order (`stage_packed`, 16-byte cp.async copies), into
// 10 x n_live float4 (29 KB at 184 triangles), and then walks ray blocks
// as a persistent block, two rays a thread, so each broadcast float4 of G
// feeds the FMAs of both rays (and of both ray sets in the merged scan):
// `scan_ray_blocks` of flash_common.cuh, which K17 runs too.
// Most pairs never divide: `pair_skip` proves from the numerators alone
// that the exact epilogue would reject the pair or that its t is not
// below the ray's running best (or within its max t); only the rest take
// the exact division, so the result is the exact scan's bit for bit. The
// nearest fold starts from t = inf as the first column of the exact scan
// does, and skips nothing while its best is above BIG. What the TPU kernels
// needed and Hopper does not is not carried over: the MXU dot plans and
// top-2 carry, the [R,128] lane tiling, and the bf16 hi/mid/lo attr split
// read by a one-hot matmul (here a direct row read of the f32 table,
// which stays in L1/L2).

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int THREADS = 128;
constexpr int RPT = 2;  // rays a thread
constexpr int RAYS = THREADS * RPT;  // rays a block takes at a time
constexpr int MAX_TT = 512;

template <bool NEAR, bool ANY, bool ATTRS>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const float* __restrict__ feats, const float* __restrict__ sh,
            const float4* __restrict__ pg, const float* __restrict__ attrs,
            float* __restrict__ t_out, int* __restrict__ idx_out,
            int* __restrict__ occ_out, float* __restrict__ attrs_out,
            int B, int TT, int W, int L) {
  extern __shared__ float4 sg[];  // [row][live triangle] -> (det, u, v, t)
  scan_ray_blocks<NEAR, ANY, THREADS, RPT, 4>(sg, pg, TT, L, feats, sh, B,
                                               [&](const TileRays<RPT>& r) {
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      if (!r.active[k]) continue;
      if (NEAR) {
        t_out[r.ray[k]] = r.best_t[k];
        idx_out[r.ray[k]] = r.best_i[k];
        if (ATTRS) {
          const float* row = attrs + (size_t)r.best_i[k] * W;
          for (int w = 0; w < W; ++w) attrs_out[(size_t)w * B + r.ray[k]] = row[w];
        }
      }
      if (ANY) occ_out[r.ray[k]] = r.occ[k] ? 1 : 0;
    }
  });
}

// Launch one scan: a persistent grid of as many blocks as the device runs
// at once (or fewer, one per ray block), each staging the live columns.
template <bool NEAR, bool ANY, bool ATTRS>
int launch_scan(const float* feats, const float* sh, const float* pg, const float* attrs,
                float* t, int* idx, int* occ, float* attrs_t, int B, int TT, int W, int L,
                void* stream) {
  if (L < 1 || L > TT || TT > MAX_TT) return (int)cudaErrorInvalidValue;
  auto kernel = scan_kernel<NEAR, ANY, ATTRS>;
  const size_t smem = (size_t)NROWS * L * sizeof(float4);
  static int sms = 0;  // per template
  cudaError_t e = opt_in(kernel, NROWS * MAX_TT * sizeof(float4), sms);
  if (e != cudaSuccess) return (int)e;
  int grid = 0;
  e = persistent_grid(kernel, THREADS, smem, sms, (B + RAYS - 1) / RAYS, grid);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      feats, sh, reinterpret_cast<const float4*>(pg), attrs, t, idx, occ, attrs_t, B, TT, W, L);
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points' layout (pointers, then ints, then the stream); the
// table argument is the packed table of ops/flash_intersect.py
// `packed_table`, and `n_live` the live triangles of the tile.
extern "C" int rt_scan_abi() { return 2; }

extern "C" int rt_nearest_attrs(const float* feats, const float* pg, const float* attrs,
                                float* t, int* idx, float* attrs_t,
                                int B, int TT, int W, int n_live, void* stream) {
  return launch_scan<true, false, true>(feats, nullptr, pg, attrs, t, idx, nullptr, attrs_t, B,
                                        TT, W, n_live, stream);
}

extern "C" int rt_nearest_shadow_attrs(const float* feats, const float* sh, const float* pg,
                                       const float* attrs, float* t, int* idx, int* occ,
                                       float* attrs_t, int B, int TT, int W, int n_live,
                                       void* stream) {
  return launch_scan<true, true, true>(feats, sh, pg, attrs, t, idx, occ, attrs_t, B, TT, W,
                                       n_live, stream);
}

extern "C" int rt_occlude(const float* sh, const float* pg, int* occ, int B, int TT, int n_live,
                          void* stream) {
  return launch_scan<false, true, false>(nullptr, sh, pg, nullptr, nullptr, nullptr, occ, nullptr,
                                         B, TT, 0, n_live, stream);
}

extern "C" int rt_nearest(const float* feats, const float* pg, float* t, int* idx, int B, int TT,
                          int n_live, void* stream) {
  return launch_scan<true, false, false>(feats, nullptr, pg, nullptr, t, idx, nullptr, nullptr, B,
                                         TT, 0, n_live, stream);
}

extern "C" int rt_nearest_shadow(const float* feats, const float* sh, const float* pg, float* t,
                                 int* idx, int* occ, int B, int TT, int n_live, void* stream) {
  return launch_scan<true, true, false>(feats, sh, pg, nullptr, t, idx, occ, nullptr, B, TT, 0,
                                        n_live, stream);
}
