// The grid form's tile walk, shared by the multi-tile scans of
// flash_multi.cu (K5-K7, K9-K11: `grid_kernel`) and by the fused bounce
// kernel of fused_bounce.cu (K17 on many tiles).
//
// A block of 256 rays walks tiles in ascending order. Per tile each thread
// runs its own ray's slab test (the nearest set against its running best t,
// the any-hit set against its max t while not yet occluded; the list form
// only inside the tiles its block's list row admits), a ballot and a prefix
// sum over the warps pack the admitted (ray, set) items, each item cut into
// up to 32 triangle ranges where few pass, and every lane folds the pairs of
// whichever range it is given with `pair_skip` and the exact epilogue into
// a 64-bit (t, index) key merged by a shared-memory atomicMin (the strict-<,
// first-index winner in any order) or into the ray's occlusion flag. The
// tile's live columns arrive from the packed table by cp.async in
// 128-triangle chunks through a ring of two. flash_multi.cu's header
// comment says what bounds the walk and why it is built so.

#pragma once

#include "flash_common.cuh"

namespace flash {
namespace grid {

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

// Thread tid's ray `ray` of both sets into shared memory: its feature rows
// and inverse directions, max t, the winner (BIG, 0) and the flag (1:
// nothing to test). Ends with a barrier.
template <bool NEAR, bool ANY>
__device__ __forceinline__ void load_rays(GridSmem& sm, const float* __restrict__ feats,
                                          const float* __restrict__ sh, int B, int ray,
                                          bool active) {
  const int tid = threadIdx.x;
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
  sm.occ[tid] = (ANY && active) ? 0 : 1;
  __syncthreads();
}

// Walk `n_walk` tiles: with LISTS the entries of `list` (one list row:
// tile | set bits), the per-ray test for the nearest set only; else tiles
// 0..n_walk-1, the per-ray test for both sets. `aabbs` [NT, 8]: min xyz,
// pad, max xyz, pad. On return sm.best and sm.occ hold every ray's result
// (the last write to them precedes a barrier). -> the tiles the block
// visited (those some ray of the block admitted).
template <bool NEAR, bool ANY, bool LISTS>
__device__ __forceinline__ int walk(GridSmem& sm, const float4* __restrict__ pg,
                                    const float* __restrict__ aabbs,
                                    const int* __restrict__ list, int n_walk, bool active,
                                    int TT, int n_live) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
  return n_visits;
}

}  // namespace grid
}  // namespace flash
