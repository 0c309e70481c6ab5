// Multi-tile flash intersection scans (kernels K5-K7 and K9-K11) for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels of rustic_tpu/ops/flash_intersect.py that
// multi-tile scenes (more than 512 triangles) run, in their list form:
//   rt_nearest_multi         <- _nearest_multi_dma         (flash_nearest)
//   rt_nearest_shadow_multi  <- _nearest_shadow_multi_dma  (flash_nearest_shadow)
//   rt_occlude_multi         <- _occlude_multi_dma         (flash_occlude_packed)
// and in their grid form without lists (the non-DMA branch of the same
// entry points):
//   rt_nearest_grid          <- _nearest_multi
//   rt_nearest_shadow_grid   <- _nearest_shadow_multi
//   rt_occlude_grid          <- _occlude_multi
//
// What they compute: the triangle table G[16, NT*4*TT] holds NT tiles of TT
// triangles. Each block of 256 rays walks tiles in ascending order and tests
// (ray, triangle) pairs with K1's FMA chain and exact epilogue
// (flash_common.cuh): the nearest scan keeps the nearest valid t with a
// strict < from BIG, so the first global index j*TT + local wins among
// equal minima and a miss gives (BIG, 0), as the JAX tile merge
// (_merge_near) does; the any-hit scans OR hits within (EPS, maxt], maxt in
// feature row 10.
//
// The list form (K5-K7): before the launch, block_tile_lists (torch, the
// twin of the JAX package's XLA _block_tile_lists) gives every block of 256
// rays the ascending list of tiles its rays may hit, by an interval slab
// test against the tiles' AABBs; bit 20 (and for the merged scan bit 21) of
// a list entry says which ray set admits the tile. A block walks its list
// row. The grid form (K9-K11): a block walks all NT tiles. Each ray also
// runs the JAX kernels' _tile_possible slab test against the tile's AABB
// (row `tile` of aabbs [NT, 8] = min xyz, pad, max xyz, pad), with its
// running best t as the limit for the nearest set and its max t for the
// any-hit set (false once the ray is occluded): the grid form for both
// sets, the list form for the nearest set. A ray
// whose own test fails does not reach the tile closer than its limit, and
// the per-ray test saves the pair work of the rays that miss the box. The
// list form leaves the any-hit set to its lists alone: a shadow ray of a
// dead lane (origin 1e6 away along -rd) can find a hit by the pair test's
// float arithmetic in a tile its slab test rules out, and the list form
// keeps the JAX list kernels' bits on every lane.
// `visits` (grid form, optional, one int per block) receives the tiles the
// block visited: those some ray of the block admitted.
//
// What bounds them: ~81 FP32 operations per pair the per-ray tests admit
// (40 FMA, one IEEE division, three multiplies, the compares), so FP32
// instruction throughput; the slab tests are ~30 flops per (ray, tile). A
// ray reads 40-80 B of features and writes 8-12 B; a tile's 10 used G rows
// (80 KB) stay in L2.
//
// Design (the walk is `grid::walk` of flash_grid.cuh, which K17 of
// fused_bounce.cu runs too): the admitted (ray, set) items of a tile are
// packed, so no lane idles on a ray its slab test turned away. The block keeps its rays'
// feature rows, inverse directions, max t, running winners and occlusion
// in shared memory; per tile each thread tests its own ray, a ballot and a
// prefix sum over the warps write the admitted items into a list (the
// nearest set's first), and every lane then tests pairs for whichever item
// it is given. Where few items pass, each is cut into up to 32 triangle
// ranges so that the tile still fills the block. Consecutive lanes take
// consecutive items of one range, so they read the same float4 of G (a
// broadcast). A lane folds its range with `pair_skip` and the exact
// epilogue into a 64-bit (t, index) key (`win_key`) and merges it with a
// shared-memory atomicMin, which gives the strict-<, first-index winner in
// any order; a hit of the any-hit set sets the ray's flag. The tile's live
// columns (clamp(n_live - tile TT, 0, TT)) arrive from the packed table
// by cp.async in 128-triangle chunks through a ring of two, the next chunk
// in flight while the current one is tested. A barrier ends each tile, so
// the next slab test reads the exact running t. The any-hit-only scans
// (K7, K11) stop a block once all its rays are occluded. Not carried over
// from the TPU kernels: the lists' windowing per 128 ray blocks (an SMEM
// block-shape rule of Mosaic; a block here reads its own list row from
// global memory).

#include "flash_grid.cuh"

namespace {

using namespace flash;
using namespace flash::grid;

// LISTS: the block walks row blockIdx.x of `lists` ([nb, NT], `counts`
// [nb] entries), the per-ray test for the nearest set only; else all NT
// tiles, the per-ray test for both sets (`grid::walk`, flash_grid.cuh).
template <bool NEAR, bool ANY, bool LISTS>
__global__ void __launch_bounds__(THREADS)
grid_kernel(const float* __restrict__ feats, const float* __restrict__ sh,
            const float4* __restrict__ pg, const float* __restrict__ aabbs,
            const int* __restrict__ lists, const int* __restrict__ counts,
            float* __restrict__ t_out, int* __restrict__ idx_out, int* __restrict__ occ_out,
            int* __restrict__ visits, int B, int NT, int TT, int n_live) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GridSmem& sm = *reinterpret_cast<GridSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int ray = blockIdx.x * THREADS + tid;
  const bool active = ray < B;
  load_rays<NEAR, ANY>(sm, feats, sh, B, ray, active);
  const int n_walk = LISTS ? counts[blockIdx.x] : NT;
  const int* list = LISTS ? lists + (size_t)blockIdx.x * NT : nullptr;
  const int n_visits = walk<NEAR, ANY, LISTS>(sm, pg, aabbs, list, n_walk, active, TT, n_live);
  if (visits != nullptr && tid == 0) visits[blockIdx.x] = n_visits;
  if (!active) return;
  if (NEAR) {
    const unsigned long long k = sm.best[tid];
    t_out[ray] = win_t(k);
    idx_out[ray] = (int)(unsigned)(k & 0xffffffffull);
  }
  if (ANY) occ_out[ray] = sm.occ[tid];
}

// One block of 256 rays each; the shared-memory opt-in at the first launch.
template <bool NEAR, bool ANY, bool LISTS>
int launch(const float* feats, const float* sh, const float* pg, const float* aabbs,
           const int* lists, const int* counts, float* t, int* idx, int* occ, int* visits, int B,
           int NT, int TT, int n_live, void* stream) {
  if (n_live < 1 || n_live > NT * TT || ((NEAR || !LISTS) && aabbs == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = grid_kernel<NEAR, ANY, LISTS>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(GridSmem));
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  kernel<<<(B + THREADS - 1) / THREADS, THREADS, sizeof(GridSmem), (cudaStream_t)stream>>>(
      feats, sh, reinterpret_cast<const float4*>(pg), aabbs, lists, counts, t, idx, occ, visits,
      B, NT, TT, n_live);
  return (int)cudaGetLastError();
}

}  // namespace

// Every scan reads the packed table of ops/flash_intersect.py
// `packed_table` and takes `n_live`, the scene's live triangles; K5 and
// K6 take the AABBs for the nearest set's per-ray test, K7 none.
extern "C" int rt_scan_abi() { return 3; }

extern "C" int rt_nearest_multi(const float* feats, const float* pg, const float* aabbs,
                                const int* lists, const int* counts, float* t, int* idx, int B,
                                int NT, int TT, int n_live, void* stream) {
  return launch<true, false, true>(feats, nullptr, pg, aabbs, lists, counts, t, idx, nullptr,
                                   nullptr, B, NT, TT, n_live, stream);
}

extern "C" int rt_nearest_shadow_multi(const float* feats, const float* sh, const float* pg,
                                       const float* aabbs, const int* lists, const int* counts,
                                       float* t, int* idx, int* occ, int B, int NT, int TT,
                                       int n_live, void* stream) {
  return launch<true, true, true>(feats, sh, pg, aabbs, lists, counts, t, idx, occ, nullptr, B,
                                  NT, TT, n_live, stream);
}

extern "C" int rt_occlude_multi(const float* sh, const float* pg, const int* lists,
                                const int* counts, int* occ, int B, int NT, int TT, int n_live,
                                void* stream) {
  return launch<false, true, true>(nullptr, sh, pg, nullptr, lists, counts, nullptr, nullptr, occ,
                                   nullptr, B, NT, TT, n_live, stream);
}

extern "C" int rt_nearest_grid(const float* feats, const float* pg, const float* aabbs, float* t,
                               int* idx, int* visits, int B, int NT, int TT, int n_live,
                               void* stream) {
  return launch<true, false, false>(feats, nullptr, pg, aabbs, nullptr, nullptr, t, idx, nullptr,
                                    visits, B, NT, TT, n_live, stream);
}

extern "C" int rt_nearest_shadow_grid(const float* feats, const float* sh, const float* pg,
                                      const float* aabbs, float* t, int* idx, int* occ,
                                      int* visits, int B, int NT, int TT, int n_live,
                                      void* stream) {
  return launch<true, true, false>(feats, sh, pg, aabbs, nullptr, nullptr, t, idx, occ, visits, B,
                                   NT, TT, n_live, stream);
}

extern "C" int rt_occlude_grid(const float* sh, const float* pg, const float* aabbs, int* occ,
                               int* visits, int B, int NT, int TT, int n_live, void* stream) {
  return launch<false, true, false>(nullptr, sh, pg, aabbs, nullptr, nullptr, nullptr, nullptr,
                                    occ, visits, B, NT, TT, n_live, stream);
}
