// Multi-tile flash intersection scans (kernels K5-K7 and K9-K11) for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels of rustic_tpu/ops/flash_intersect.py that
// multi-tile scenes (more than 512 triangles) run:
//   rt_nearest_multi         <- _nearest_multi_dma         (flash_nearest)
//   rt_nearest_shadow_multi  <- _nearest_shadow_multi_dma  (flash_nearest_shadow)
//   rt_occlude_multi         <- _occlude_multi_dma         (flash_occlude_packed)
// and their grid form without lists (the non-DMA branch of the same entry
// points, below):
//   rt_nearest_grid          <- _nearest_multi
//   rt_nearest_shadow_grid   <- _nearest_shadow_multi
//   rt_occlude_grid          <- _occlude_multi
//
// What they compute: the triangle table G[16, NT*4*TT] holds NT tiles of TT
// triangles. Before the launch, block_tile_lists (torch, the twin of the
// JAX package's XLA _block_tile_lists) gives every block of 256 rays the
// ascending list of tiles its rays may hit, by an interval slab test
// against the tiles' AABBs; bit 20 (and for the merged scan bit 21) of a
// list entry says which ray set admits the tile. Each block walks its
// admitted tiles in ascending order and tests every (ray, triangle) pair
// with K1's FMA chain and exact epilogue (flash_common.cuh): the nearest
// scan keeps the nearest valid t with a strict < from BIG, so the first
// global index j*TT + local wins among equal minima and a miss gives
// (BIG, 0), as the JAX tile merge (_merge_near) does; the any-hit scans
// OR hits within (EPS, maxt], maxt in feature row 10.
//
// What bounds them: ~55 flops per admitted (ray, triangle) pair (40 FMA,
// one IEEE division, three multiplies, the compares), so FP32 instruction
// throughput. At VeachMIS's 4,194,304 lanes and 3,072 triangles an
// unculled scan is ~0.7 TFLOP; the tile lists cut that to the admitted
// pairs. A ray reads 40-80 B of features and writes 8-12 B; a tile's 10
// used G rows (80 KB) stay in L2.
//
// Design: one block per 256-ray block of the lists, one thread per ray,
// its feature values in registers. Per admitted tile the block stages
// the tile's 10 used G rows into 20 KB of shared memory, 128 triangles at
// a time, as one float4 per (row, triangle) that every thread reads as a
// broadcast: 10 shared loads per 40 FMA. K7 stops a block once all its
// rays are occluded. Not carried over from the TPU kernels:
// the lists' windowing per 128 ray blocks (an SMEM block-shape rule of
// Mosaic; a block here reads its own list row from global memory) and the
// double-buffered async copies of the admitted G tiles (cp.async or TMA
// are later work).

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int THREADS = 256;  // rays per block: the lists' block size
constexpr int LIST_ID_MASK = (1 << 20) - 1;
constexpr int SET0_BIT = 1 << 20;  // first ray set admits the tile
constexpr int SET1_BIT = 1 << 21;  // second ray set (the merged scan's shadow rays)

template <bool NEAR, bool ANY>
__global__ void __launch_bounds__(THREADS)
multi_kernel(const float* __restrict__ feats, const float* __restrict__ sh,
             const float* __restrict__ g, const int* __restrict__ lists,
             const int* __restrict__ counts, float* __restrict__ t_out,
             int* __restrict__ idx_out, int* __restrict__ occ_out, int B, int NT, int TT) {
  __shared__ float4 sg[NROWS * CHUNK];  // [row][triangle] -> (det, u, v, t)

  const int ray = blockIdx.x * THREADS + threadIdx.x;
  const bool active = ray < B;
  float f[NROWS], s[NROWS];
  load_rows(feats, B, ray, NEAR && active, f);
  load_rows(sh, B, ray, ANY && active, s);
  const float maxt = (ANY && active) ? sh[(size_t)MAXT_ROW * B + ray] : 0.0f;
  const int any_bit = NEAR ? SET1_BIT : SET0_BIT;

  const int count = counts[blockIdx.x];
  const int* list = lists + (size_t)blockIdx.x * NT;
  const size_t row_stride = (size_t)4 * TT * NT;
  float best_t = BIG;
  int best_i = 0;
  bool occ = false;
  for (int k = 0; k < count; ++k) {
    if (!NEAR && __syncthreads_and(occ || !active)) break;  // every ray occluded
    const int packed = list[k];  // the same entry for the whole block
    const int tile = packed & LIST_ID_MASK;
    const bool near_tile = NEAR && (packed & SET0_BIT);
    const bool any_tile = ANY && (packed & any_bit);
    for (int c0 = 0; c0 < TT; c0 += CHUNK) {
      const int n = min(CHUNK, TT - c0);
      __syncthreads();  // the previous chunk is consumed
      stage_chunk(sg, g, row_stride, (size_t)tile * 4 * TT, TT, c0, n);
      __syncthreads();
      if (!active) continue;
      const int base = tile * TT + c0;
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        if (near_tile) {
          float t;
          bool valid;
          pair_test(f, sg, j, t, valid);
          const float tm = valid ? t : BIG;
          if (tm < best_t) {
            best_t = tm;
            best_i = base + j;
          }
        }
        if (any_tile && !occ) {
          float t;
          bool valid;
          pair_test(s, sg, j, t, valid);
          occ = valid && t <= maxt;
        }
      }
    }
  }
  if (!active) return;
  if (NEAR) {
    t_out[ray] = best_t;
    idx_out[ray] = best_i;
  }
  if (ANY) occ_out[ray] = occ ? 1 : 0;
}

// ---- the grid form (K9-K11) ----------------------------------------------
//
// The same scans without tile lists: each block of 256 rays walks all NT
// tiles in ascending order. Per tile, each thread evaluates the JAX
// kernel's _tile_possible slab test for its own ray against the tile's AABB
// (row `tile` of aabbs [NT, 8] = min xyz, pad, max xyz, pad), with its
// running best t as the limit for the nearest set and its max t for the
// any-hit set (false once the ray is occluded). The block stages the tile
// only if __syncthreads_or of either predicate holds, and each thread runs
// a set's pair tests only where that set's predicate holds. The JAX kernel
// tests the slab per block (jnp.any over its rays) and then runs every ray
// of the block; a ray whose own test fails cannot hit the tile closer than
// its limit, so the result is the same, and the per-ray test saves the pair
// work of the rays that miss the box. The tie order is K5's: ascending
// tiles, strict < from (BIG, 0). What bounds it: FP32 throughput on the pairs
// the per-ray tests admit; the slab tests are ~30 flops per (ray, tile).
// `visits` (optional, one int per block) receives the tiles the block
// staged.

template <bool NEAR, bool ANY>
__global__ void __launch_bounds__(THREADS)
grid_kernel(const float* __restrict__ feats, const float* __restrict__ sh,
            const float* __restrict__ g, const float* __restrict__ aabbs,
            float* __restrict__ t_out, int* __restrict__ idx_out, int* __restrict__ occ_out,
            int* __restrict__ visits, int B, int NT, int TT) {
  __shared__ float4 sg[NROWS * CHUNK];  // [row][triangle] -> (det, u, v, t)

  const int ray = blockIdx.x * THREADS + threadIdx.x;
  const bool active = ray < B;
  float f[NROWS], s[NROWS];
  load_rows(feats, B, ray, NEAR && active, f);
  load_rows(sh, B, ray, ANY && active, s);
  const float maxt = (ANY && active) ? sh[(size_t)MAXT_ROW * B + ray] : 0.0f;
  const SlabRay fr = slab_ray(f), sr = slab_ray(s);

  const size_t row_stride = (size_t)4 * TT * NT;
  float best_t = BIG;
  int best_i = 0;
  bool occ = false;
  int n_visits = 0;
  for (int tile = 0; tile < NT; ++tile) {
    if (!NEAR && __syncthreads_and(occ || !active)) break;  // every ray occluded
    const float* box = aabbs + (size_t)tile * 8;
    const bool near_ok = NEAR && active && slab_ok(fr, box, best_t);
    const bool any_ok = ANY && active && !occ && slab_ok(sr, box, maxt);
    if (!__syncthreads_or(near_ok || any_ok)) continue;  // no ray of the block needs it
    ++n_visits;
    for (int c0 = 0; c0 < TT; c0 += CHUNK) {
      const int n = min(CHUNK, TT - c0);
      __syncthreads();  // the previous chunk is consumed
      stage_chunk(sg, g, row_stride, (size_t)tile * 4 * TT, TT, c0, n);
      __syncthreads();
      if (!near_ok && !any_ok) continue;
      const int base = tile * TT + c0;
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        if (near_ok) {
          float t;
          bool valid;
          pair_test(f, sg, j, t, valid);
          const float tm = valid ? t : BIG;
          if (tm < best_t) {
            best_t = tm;
            best_i = base + j;
          }
        }
        if (any_ok && !occ) {
          float t;
          bool valid;
          pair_test(s, sg, j, t, valid);
          occ = valid && t <= maxt;
        }
      }
    }
  }
  if (visits != nullptr && threadIdx.x == 0) visits[blockIdx.x] = n_visits;
  if (!active) return;
  if (NEAR) {
    t_out[ray] = best_t;
    idx_out[ray] = best_i;
  }
  if (ANY) occ_out[ray] = occ ? 1 : 0;
}

inline dim3 grid_for(int B) { return dim3((B + THREADS - 1) / THREADS); }

}  // namespace

extern "C" int rt_nearest_multi(const float* feats, const float* g, const int* lists,
                                const int* counts, float* t, int* idx, int B, int NT, int TT,
                                void* stream) {
  multi_kernel<true, false><<<grid_for(B), THREADS, 0, (cudaStream_t)stream>>>(
      feats, nullptr, g, lists, counts, t, idx, nullptr, B, NT, TT);
  return (int)cudaGetLastError();
}

extern "C" int rt_nearest_shadow_multi(const float* feats, const float* sh, const float* g,
                                       const int* lists, const int* counts, float* t,
                                       int* idx, int* occ, int B, int NT, int TT,
                                       void* stream) {
  multi_kernel<true, true><<<grid_for(B), THREADS, 0, (cudaStream_t)stream>>>(
      feats, sh, g, lists, counts, t, idx, occ, B, NT, TT);
  return (int)cudaGetLastError();
}

extern "C" int rt_occlude_multi(const float* sh, const float* g, const int* lists,
                                const int* counts, int* occ, int B, int NT, int TT,
                                void* stream) {
  multi_kernel<false, true><<<grid_for(B), THREADS, 0, (cudaStream_t)stream>>>(
      nullptr, sh, g, lists, counts, nullptr, nullptr, occ, B, NT, TT);
  return (int)cudaGetLastError();
}

extern "C" int rt_nearest_grid(const float* feats, const float* g, const float* aabbs, float* t,
                               int* idx, int* visits, int B, int NT, int TT, void* stream) {
  grid_kernel<true, false><<<grid_for(B), THREADS, 0, (cudaStream_t)stream>>>(
      feats, nullptr, g, aabbs, t, idx, nullptr, visits, B, NT, TT);
  return (int)cudaGetLastError();
}

extern "C" int rt_nearest_shadow_grid(const float* feats, const float* sh, const float* g,
                                      const float* aabbs, float* t, int* idx, int* occ,
                                      int* visits, int B, int NT, int TT, void* stream) {
  grid_kernel<true, true><<<grid_for(B), THREADS, 0, (cudaStream_t)stream>>>(
      feats, sh, g, aabbs, t, idx, occ, visits, B, NT, TT);
  return (int)cudaGetLastError();
}

extern "C" int rt_occlude_grid(const float* sh, const float* g, const float* aabbs, int* occ,
                               int* visits, int B, int NT, int TT, void* stream) {
  grid_kernel<false, true><<<grid_for(B), THREADS, 0, (cudaStream_t)stream>>>(
      nullptr, sh, g, aabbs, nullptr, nullptr, occ, visits, B, NT, TT);
  return (int)cudaGetLastError();
}
