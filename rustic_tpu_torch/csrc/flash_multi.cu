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
// Design: the admitted (ray, set) items of a tile are packed, so no lane
// idles on a ray its slab test turned away. The block keeps its rays'
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

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int THREADS = 256;  // rays per block: the lists' block size
constexpr int LIST_ID_MASK = (1 << 20) - 1;
constexpr int SET0_BIT = 1 << 20;  // first ray set admits the tile
constexpr int SET1_BIT = 1 << 21;  // second ray set (the merged scan's shadow rays)
constexpr int RING = 2;            // staged chunks in flight
constexpr int MAX_SPLIT = 32;      // triangle ranges an item may be cut into
constexpr int WARPS = THREADS / 32;

struct GridSmem {
  float4 ring[RING][NROWS * CHUNK];
  unsigned long long best[THREADS];  // win_key of each ray's nearest hit
  float rows[2][NROWS][THREADS];     // feature rows: nearest set, any-hit set
  float inv[2][3][THREADS];          // 1/rd of each set, as slab_ray takes it
  float maxt[THREADS];
  int occ[THREADS];
  int items[2 * THREADS];  // ray | set << 8
  int counts[2][WARPS];
};

__device__ __forceinline__ bool slab_from(const GridSmem& sm, int set, int ray,
                                          const float* __restrict__ box, float limit) {
  SlabRay r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.ro[a] = sm.rows[set][6 + a][ray];
    r.inv[a] = sm.inv[set][a][ray];
  }
  return slab_ok(r, box, limit);
}

// LISTS: the block walks row blockIdx.x of `lists` ([nb, NT], `counts`
// [nb] entries), the per-ray test for the nearest set only; else all NT
// tiles, the per-ray test for both sets.
template <bool NEAR, bool ANY, bool LISTS>
__global__ void __launch_bounds__(THREADS)
grid_kernel(const float* __restrict__ feats, const float* __restrict__ sh,
            const float4* __restrict__ pg, const float* __restrict__ aabbs,
            const int* __restrict__ lists, const int* __restrict__ counts,
            float* __restrict__ t_out, int* __restrict__ idx_out, int* __restrict__ occ_out,
            int* __restrict__ visits, int B, int NT, int TT, int n_live) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GridSmem& sm = *reinterpret_cast<GridSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ray = blockIdx.x * THREADS + tid;
  const bool active = ray < B;
  {
    float f[NROWS], s[NROWS];
    load_rows(feats, B, ray, NEAR && active, f);
    load_rows(sh, B, ray, ANY && active, s);
    const SlabRay fr = slab_ray(f), sr = slab_ray(s);
#pragma unroll
    for (int r = 0; r < NROWS; ++r) {
      sm.rows[0][r][tid] = f[r];
      sm.rows[1][r][tid] = s[r];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      sm.inv[0][a][tid] = fr.inv[a];
      sm.inv[1][a][tid] = sr.inv[a];
    }
    sm.maxt[tid] = (ANY && active) ? sh[(size_t)MAXT_ROW * B + ray] : 0.0f;
    sm.best[tid] = win_key(BIG, 0);
    sm.occ[tid] = (ANY && active) ? 0 : 1;  // 1: nothing to test
  }
  __syncthreads();

  const int n_walk = LISTS ? counts[blockIdx.x] : NT;
  const int* list = LISTS ? lists + (size_t)blockIdx.x * NT : nullptr;
  int n_visits = 0;
  for (int k = 0; k < n_walk; ++k) {
    if (!NEAR && __syncthreads_and(sm.occ[tid])) break;  // every ray occluded
    int tile = k;
    bool near_set = true, any_set = true;
    if (LISTS) {  // the same entry for the whole block
      const int entry = list[k];
      tile = entry & LIST_ID_MASK;
      near_set = (entry & SET0_BIT) != 0;
      any_set = (entry & (NEAR ? SET1_BIT : SET0_BIT)) != 0;
    }
    const float* box = aabbs + (size_t)tile * 8;
    const bool near_ok =
        NEAR && active && near_set && slab_from(sm, 0, tid, box, win_t(sm.best[tid]));
    const bool any_ok = ANY && any_set && !sm.occ[tid] &&
                        (LISTS || slab_from(sm, 1, tid, box, sm.maxt[tid]));
    // pack the admitted items: the nearest set's, then the any-hit set's
    const unsigned mn = __ballot_sync(0xffffffffu, near_ok);
    const unsigned ma = __ballot_sync(0xffffffffu, any_ok);
    if (lane == 0) {
      sm.counts[0][warp] = __popc(mn);
      sm.counts[1][warp] = __popc(ma);
    }
    __syncthreads();
    int off_n = 0, off_a = 0, tot_n = 0, n_items = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      off_n += w < warp ? sm.counts[0][w] : 0;
      off_a += w < warp ? sm.counts[1][w] : 0;
      tot_n += sm.counts[0][w];
      n_items += sm.counts[0][w] + sm.counts[1][w];
    }
    const unsigned below = (1u << lane) - 1u;
    if (near_ok) sm.items[off_n + __popc(mn & below)] = tid;
    if (any_ok) sm.items[tot_n + off_a + __popc(ma & below)] = tid | (1 << 8);
    __syncthreads();
    if (n_items == 0) continue;  // no ray of the block needs the tile
    ++n_visits;

    const int live = min(max(n_live - tile * TT, 0), TT);
    const int n_chunks = (live + CHUNK - 1) / CHUNK;
    int split = 1;
    while (split < MAX_SPLIT && n_items * split * 2 <= THREADS) split *= 2;
    const int n_units = n_items * split;
    if (n_chunks > 0) {
      stage_packed(sm.ring[0], CHUNK, pg, TT, tile, 0, min(CHUNK, live));
      cp_async_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) {
        const int c1 = (c + 1) * CHUNK;
        stage_packed(sm.ring[(c + 1) % RING], CHUNK, pg, TT, tile, c1, min(CHUNK, live - c1));
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // chunk c has landed for every thread
      const float4* sg = sm.ring[c % RING];
      const int n_c = min(CHUNK, live - c * CHUNK);
      const int len = (n_c + split - 1) / split;
      const int base = tile * TT + c * CHUNK;
      for (int u = tid; u < n_units; u += THREADS) {
        const int item = sm.items[u % n_items];
        const int j0 = (u / n_items) * len, j1 = min(j0 + len, n_c);
        const int r = item & 0xff, set = item >> 8;
        if (j0 >= j1 || (set && sm.occ[r])) continue;
        float f[NROWS];
#pragma unroll
        for (int q = 0; q < NROWS; ++q) f[q] = sm.rows[set][q][r];
        const float maxt = sm.maxt[r];
        const unsigned long long key0 = set ? 0ull : sm.best[r];
        unsigned long long key = key0;
        float lim = skip_limit(set ? maxt : win_t(key0));
        bool hit = false;
        for (int j = j0; j < j1; ++j) {
          float4 acc;
#pragma unroll
          for (int q = 0; q < NROWS; ++q) pair_accumulate(acc, f[q], sg[q * CHUNK + j], q == 0);
          if (pair_skip(acc, lim)) continue;
          float t;
          bool valid;
          pair_epilogue(acc, t, valid);
          if (set) {
            if (valid && t <= maxt) {
              hit = true;
              break;
            }
          } else {
            const unsigned long long k = win_key(valid ? t : BIG, base + j);
            if (k < key) {
              key = k;
              lim = skip_limit(win_t(k));
            }
          }
        }
        if (set) {
          if (hit) sm.occ[r] = 1;
        } else if (key < key0) {
          atomicMin(&sm.best[r], key);
        }
      }
      __syncthreads();  // the chunk is consumed before its ring slot is refilled
    }
  }
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
