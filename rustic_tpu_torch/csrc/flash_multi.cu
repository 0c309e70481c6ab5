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
// any-hit set (false once the ray is occluded). The JAX kernel tests the
// slab per block (jnp.any over its rays) and then runs every ray of the
// block; a ray whose own test fails cannot hit the tile closer than its
// limit, so the result is the same, and the per-ray test saves the pair
// work of the rays that miss the box. The tie order is K5's: ascending
// tiles, strict < from (BIG, 0). What bounds it: FP32 throughput on the
// pairs the per-ray tests admit (a few percent of all pairs on BreakTime);
// the slab tests are ~30 flops per (ray, tile). `visits` (optional, one
// int per block) receives the tiles the block visited: those some ray of
// the block admitted.
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
// the next slab test reads the exact running t and the same tiles are
// culled.

constexpr int RING = 2;        // staged chunks in flight
constexpr int MAX_SPLIT = 32;  // triangle ranges an item may be cut into
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

template <bool NEAR, bool ANY>
__global__ void __launch_bounds__(THREADS)
grid_kernel(const float* __restrict__ feats, const float* __restrict__ sh,
            const float4* __restrict__ pg, const float* __restrict__ aabbs,
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

  int n_visits = 0;
  for (int tile = 0; tile < NT; ++tile) {
    if (!NEAR && __syncthreads_and(sm.occ[tid])) break;  // every ray occluded
    const float* box = aabbs + (size_t)tile * 8;
    const bool near_ok = NEAR && active && slab_from(sm, 0, tid, box, win_t(sm.best[tid]));
    const bool any_ok = ANY && !sm.occ[tid] && slab_from(sm, 1, tid, box, sm.maxt[tid]);
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
template <bool NEAR, bool ANY>
int launch_grid(const float* feats, const float* sh, const float* pg, const float* aabbs,
                float* t, int* idx, int* occ, int* visits, int B, int NT, int TT, int n_live,
                void* stream) {
  if (n_live < 1 || n_live > NT * TT) return (int)cudaErrorInvalidValue;
  auto kernel = grid_kernel<NEAR, ANY>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(GridSmem));
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  grid_kernel<NEAR, ANY><<<(B + THREADS - 1) / THREADS, THREADS, sizeof(GridSmem),
                           (cudaStream_t)stream>>>(
      feats, sh, reinterpret_cast<const float4*>(pg), aabbs, t, idx, occ, visits, B, NT, TT,
      n_live);
  return (int)cudaGetLastError();
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

// The grid form's table argument is the packed table of
// ops/flash_intersect.py `packed_table`, and `n_live` the scene's live
// triangles.
extern "C" int rt_scan_abi() { return 2; }

extern "C" int rt_nearest_grid(const float* feats, const float* pg, const float* aabbs, float* t,
                               int* idx, int* visits, int B, int NT, int TT, int n_live,
                               void* stream) {
  return launch_grid<true, false>(feats, nullptr, pg, aabbs, t, idx, nullptr, visits, B, NT, TT,
                                  n_live, stream);
}

extern "C" int rt_nearest_shadow_grid(const float* feats, const float* sh, const float* pg,
                                      const float* aabbs, float* t, int* idx, int* occ,
                                      int* visits, int B, int NT, int TT, int n_live,
                                      void* stream) {
  return launch_grid<true, true>(feats, sh, pg, aabbs, t, idx, occ, visits, B, NT, TT, n_live,
                                 stream);
}

extern "C" int rt_occlude_grid(const float* sh, const float* pg, const float* aabbs, int* occ,
                               int* visits, int B, int NT, int TT, int n_live, void* stream) {
  return launch_grid<false, true>(nullptr, sh, pg, aabbs, nullptr, nullptr, occ, visits, B, NT,
                                  TT, n_live, stream);
}
