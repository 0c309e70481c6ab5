// Resident-G multi-tile flash intersection scans (kernels K14-K16) for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels of rustic_tpu/ops/flash_intersect.py that
// keep the whole triangle table in fast memory and walk the tiles inside the
// kernel (use_resident, _g_specs_full):
//   rt_nearest_resident         <- _nearest_resident
//   rt_nearest_shadow_resident  <- _nearest_shadow_resident
//   rt_occlude_resident         <- _occlude_resident
//
// What they compute: what the grid form (flash_multi.cu, K9-K11) computes.
// Each ray walks tiles 0..NT-1 in ascending order, tests its own slab
// against the tile's AABB (limit: its running best t for the nearest set,
// its max t for the any-hit set, which stops once occluded), and runs K1's
// FMA chain and exact epilogue (flash_common.cuh) on the tiles it admits:
// strict < from (BIG, 0), so the first global index wins among equal
// minima; any hit within (EPS, maxt], maxt in feature row 10.
//
// What bounds them: FP32 instruction throughput on the pairs the per-ray
// tests admit (~81 operations a pair), as K9-K11. What differs is where G
// comes from: K9-K11 stage every visited tile from global memory (L2) again
// for every 256-ray block; here G is staged once per block lifetime.
//
// Design. The TPU kernel holds G in VMEM (8 MiB). An SM has 227 KB of
// shared memory, 1,408 triangles at 160 B each (ten rows of one float4),
// and every multi-tile scene is larger. So a thread-block cluster of c <= 8
// blocks (ranks) holds the table in its shared memory together: G is cut
// into chunks of CHUNK = 128 triangles (20 KB), chunk k lives on rank
// k % c in slot k / c (round robin). Each rank stages its chunks once.
// Then the rays go to the data: the cluster takes one block of 256 rays at
// a time, and every rank tests that block's rays against the chunks it
// holds and no others, so every read of G is a broadcast from the rank's
// own shared memory. First a mask of the tiles some ray of the block can
// reach at all (one barrier; the walk skips the rest without one). Then,
// per tile that has a live chunk on the rank, K10's loop: each ray's slab
// test against the tile's AABB, a ballot and a prefix sum that pack the
// admitted (ray, set) items, items cut into triangle ranges where few
// pass, `pair_skip` before the exact epilogue, and the nearest winner
// folded into a 64-bit `win_key` merged by a shared-memory atomicMin.
// Each rank copies the ray block's feature rows and max t into its shared
// memory where the chunks leave room (21 KB beside at most 10 chunks);
// beside 11 chunks (7 KB left: the winners, the any-hit flags, the item
// list and the masks) a lane reads its item's rows from global memory.
//
// Merge. A rank keeps its own running winner per ray, from its own tiles
// in ascending order: never closer than the sequential scan's at the same
// tile, so its slab and skip limits are only ever looser (more work, the
// same result: the key's minimum does not depend on order). A limit taken
// from another rank could come from a later tile; a tie at equal t with an
// earlier tile's smaller index then fails the strict slab test, and the
// key of the later tile would win (measured: 4,501 of 4,194,304 VeachMIS
// camera rays). At the end of a ray block one cluster barrier makes every
// rank's keys final; the ray's home rank (ray % c) takes the minimum of
// the c keys and the OR of the c flags (c - 1 reads of another rank's
// shared memory a ray, once) and writes the outputs. The keys and flags
// are double-buffered by ray block, so that barrier is the only one a ray
// block costs the cluster. No rank reads another's shared memory inside
// the pair loop. The grid is persistent, sized from
// cudaOccupancyMaxActiveClusters (a GPC may seat fewer clusters than
// SMs / c). Not carried over: the bf16 dot plans, the unrolled tile loop
// (a compile-time NT), and the per-block slab test.

#include <cooperative_groups.h>

#include "flash_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace flash;

constexpr int THREADS = 512;  // a rank's threads: the slab tests of both ray sets at once
constexpr int RAYS = 256;     // rays of one ray block, the cluster's unit of work
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SPLIT = 32;  // triangle ranges an item may be cut into
constexpr int CHUNK_FLOAT4 = NROWS * CHUNK;  // one staged chunk: [row][triangle]
constexpr int CHUNK_BYTES = CHUNK_FLOAT4 * (int)sizeof(float4);  // 20,480

// What a rank keeps besides its chunks of G.
struct RankSmem {
  unsigned long long best[2][RAYS];  // this rank's win_key of each ray (two ray blocks)
  unsigned short items[2 * RAYS];    // admitted items: ray | set << 8
  int counts[WARPS];
  unsigned reach[WARPS];       // per warp: the tiles (bit t) some ray may reach
  unsigned char occ[2][RAYS];  // any-hit flags (1: occluded or nothing to test)
};

// The ray block's rows, where the chunks leave room for them.
struct RowSmem {
  float rows[2][NROWS][RAYS];  // feature rows: nearest set, any-hit set
  float maxt[RAYS];
};

template <bool NEAR, bool ANY>
__global__ void __launch_bounds__(THREADS, 1)
resident_kernel(const float* __restrict__ feats, const float* __restrict__ sh,
                const float* __restrict__ g, const float* __restrict__ aabbs,
                float* __restrict__ t_out, int* __restrict__ idx_out, int* __restrict__ occ_out,
                int B, int NT, int TT, int n_live, int chunks_per_rank, int stage_rows) {
  extern __shared__ __align__(16) float4 sg[];  // this rank's chunks: [slot][row][triangle]
  RankSmem& sm = *reinterpret_cast<RankSmem*>(sg + (size_t)chunks_per_rank * CHUNK_FLOAT4);
  RowSmem& rs = *reinterpret_cast<RowSmem*>(&sm + 1);  // only where `stage_rows`

  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cpt = TT / CHUNK;  // chunks per tile
  const int n_chunks = NT * cpt;
  const size_t row_stride = (size_t)4 * TT * NT;

  // stage this rank's share of G, once
  for (int k = rank, slot = 0; k < n_chunks; k += c, ++slot) {
    const int tile = k / cpt;
    stage_chunk(sg + (size_t)slot * CHUNK_FLOAT4, g, row_stride, (size_t)tile * 4 * TT, TT,
                (k % cpt) * CHUNK, CHUNK);
  }
  __syncthreads();

  // this thread's slab test: ray `r` of the block, of set `set` (0 nearest, 1 any-hit)
  const int set = tid / RAYS, r = tid % RAYS;
  const bool has_set = set ? ANY : NEAR;
  const float* set_rows = set ? sh : feats;
  const int n_ray_blocks = (B + RAYS - 1) / RAYS;
  const int n_clusters = (int)gridDim.x / c;
  int it = 0;
  for (int rb = (int)blockIdx.x / c; rb < n_ray_blocks; rb += n_clusters, ++it) {
    const int buf = it & 1;
    const int ray0 = rb * RAYS;
    const bool mine = has_set && ray0 + r < B;
    SlabRay slab;
    float maxt = 0.0f;
    {
      float f[NROWS];
      load_rows(set_rows, B, ray0 + r, mine, f);
      slab = slab_ray(f);
      if (mine && set) maxt = sh[(size_t)MAXT_ROW * B + ray0 + r];
      if (stage_rows) {
#pragma unroll
        for (int q = 0; q < NROWS; ++q) rs.rows[set][q][r] = f[q];
        if (set) rs.maxt[r] = maxt;
      }
    }
    if (tid < RAYS) {
      sm.best[buf][tid] = win_key(BIG, 0);
      sm.occ[buf][tid] = (ANY && ray0 + tid < B) ? 0 : 1;
    }
    // the tiles some ray of the block may reach at all (limit BIG or max t):
    // the walk skips the others without a barrier
    unsigned reach = 0;
    if (mine)
      for (int tile = 0; tile < NT && tile < 32; ++tile)
        if (slab_ok(slab, aabbs + (size_t)tile * 8, set ? maxt : BIG)) reach |= 1u << tile;
    reach = __reduce_or_sync(0xffffffffu, reach);
    if (lane == 0) sm.reach[warp] = reach;
    __syncthreads();
    reach = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) reach |= sm.reach[w];

    for (int tile = 0; tile < NT; ++tile) {
      if (tile < 32 && !(reach >> tile & 1u)) continue;
      // this rank's live chunks of the tile: cc0, cc0 + c, ... (the same for the block)
      const int live = min(max(n_live - tile * TT, 0), TT);
      const int live_chunks = (live + CHUNK - 1) / CHUNK;
      const int first = tile * cpt;
      const int cc0 = ((rank - first) % c + c) % c;
      if (cc0 >= live_chunks) continue;
      const int n_local = (live_chunks - 1 - cc0) / c + 1;
      const int last = cc0 + (n_local - 1) * c;
      const int n_tris = (n_local - 1) * CHUNK + min(CHUNK, live - last * CHUNK);
      const float4* tile_sg = sg + (size_t)((first + cc0) / c) * CHUNK_FLOAT4;

      const float* box = aabbs + (size_t)tile * 8;
      const bool ok = mine && (set ? !sm.occ[buf][r] && slab_ok(slab, box, maxt)
                                   : slab_ok(slab, box, win_t(sm.best[buf][r])));
      // pack the admitted items: warps 0-7 hold the nearest set, 8-15 the any-hit set
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) sm.counts[warp] = __popc(m);
      __syncthreads();
      int off = 0, n_items = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        off += w < warp ? sm.counts[w] : 0;
        n_items += sm.counts[w];
      }
      if (ok) sm.items[off + __popc(m & ((1u << lane) - 1u))] = (unsigned short)(r | set << 8);
      __syncthreads();
      if (n_items == 0) continue;  // no ray of the block needs the tile here

      int split = 1;
      while (split < MAX_SPLIT && n_items * split * 2 <= THREADS) split *= 2;
      const int n_units = n_items * split;
      const int len = (n_tris + split - 1) / split;
      for (int u = tid; u < n_units; u += THREADS) {
        const int item = sm.items[u % n_items];
        const int j0 = (u / n_items) * len, j1 = min(j0 + len, n_tris);
        const int ir = item & 0xff, iset = item >> 8;
        if (j0 >= j1 || (iset && sm.occ[buf][ir])) continue;
        // the item's rows: from the staged copy, else from global memory (L2)
        const float* src = stage_rows ? &rs.rows[iset][0][ir] : (iset ? sh : feats) + ray0 + ir;
        const size_t stride = stage_rows ? RAYS : (size_t)B;
        float f[NROWS];
#pragma unroll
        for (int q = 0; q < NROWS; ++q) f[q] = src[q * stride];
        const float imaxt = !iset       ? 0.0f
                            : stage_rows ? rs.maxt[ir]
                                         : sh[(size_t)MAXT_ROW * B + ray0 + ir];
        const unsigned long long key0 = iset ? 0ull : sm.best[buf][ir];
        unsigned long long key = key0;
        float lim = skip_limit(iset ? imaxt : win_t(key0));
        bool hit = false;
        // local triangle l: local chunk q = l / CHUNK (tile chunk cc0 + q c, slot + q)
        for (int l = j0; l < j1 && !hit;) {
          const int q = l / CHUNK;
          const int end = min(j1, (q + 1) * CHUNK);
          const float4* csg = tile_sg + (size_t)q * CHUNK_FLOAT4 - q * CHUNK;
          const int base = tile * TT + (cc0 + q * c) * CHUNK - q * CHUNK;
          for (; l < end; ++l) {
            float4 acc;
#pragma unroll
            for (int row = 0; row < NROWS; ++row)
              pair_accumulate(acc, f[row], csg[row * CHUNK + l], row == 0);
            if (pair_skip(acc, lim)) continue;
            float t;
            bool valid;
            pair_epilogue(acc, t, valid);
            if (iset) {
              if (valid && t <= imaxt) {
                hit = true;
                break;
              }
            } else {
              const unsigned long long k = win_key(valid ? t : BIG, base + l);
              if (k < key) {
                key = k;
                lim = skip_limit(win_t(k));
              }
            }
          }
        }
        if (iset) {
          if (hit) sm.occ[buf][ir] = 1;
        } else if (key < key0) {
          atomicMin(&sm.best[buf][ir], key);
        }
      }
      __syncthreads();  // the tile's items are done before the next slab test
    }

    cluster.sync();  // every rank's keys and flags of this ray block are final
    // the home rank of ray r is r % c: the minimum key and the OR of the flags
    const int hr = rank + c * tid;
    if (hr < RAYS && ray0 + hr < B) {
      unsigned long long key = sm.best[buf][hr];
      int occ = sm.occ[buf][hr];
      for (int q = 1; q < c; ++q) {
        const RankSmem* other = cluster.map_shared_rank(&sm, (rank + q) % c);
        key = min(key, other->best[buf][hr]);
        occ |= other->occ[buf][hr];
      }
      const int ray = ray0 + hr;
      if (NEAR) {
        t_out[ray] = win_t(key);
        idx_out[ray] = (int)(unsigned)(key & 0xffffffffull);
      }
      if (ANY) occ_out[ray] = occ;
    }
  }
  cluster.sync();  // no rank leaves while another may still read its keys
}

constexpr int smem_bytes(int chunks_per_rank, bool stage_rows) {
  return chunks_per_rank * CHUNK_BYTES + (int)sizeof(RankSmem) +
         (stage_rows ? (int)sizeof(RowSmem) : 0);
}

// Whether the ray block's rows fit beside `chunks_per_rank` chunks.
int rows_fit(int chunks_per_rank, int* out) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *out = smem_bytes(chunks_per_rank, true) <= optin;
  return (int)err;
}

template <bool NEAR, bool ANY>
int configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int cluster, int smem) {
  cudaError_t err = cudaFuncSetAttribute(resident_kernel<NEAR, ANY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return 0;
}

// Launch on a persistent grid: as many clusters as the card seats at once,
// at most one per ray block.
template <bool NEAR, bool ANY>
int launch(const float* feats, const float* sh, const float* g, const float* aabbs, float* t,
           int* idx, int* occ, int B, int NT, int TT, int n_live, int cluster,
           int chunks_per_rank, void* stream) {
  if (TT % CHUNK != 0 || cluster < 1 || cluster * chunks_per_rank < NT * (TT / CHUNK) ||
      n_live < 1 || n_live > NT * TT)
    return (int)cudaErrorInvalidValue;
  int stage_rows = 0;
  int rc = rows_fit(chunks_per_rank, &stage_rows);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  rc = configure<NEAR, ANY>(cfg, attr, cluster, smem_bytes(chunks_per_rank, stage_rows));
  if (rc != 0) return rc;
  int active = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&active, resident_kernel<NEAR, ANY>, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  const int n_ray_blocks = (B + RAYS - 1) / RAYS;
  cfg.gridDim = dim3((unsigned)(min(active, max(n_ray_blocks, 1)) * cluster));
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, resident_kernel<NEAR, ANY>, feats, sh, g, aabbs, t, idx, occ, B,
                           NT, TT, n_live, chunks_per_rank, stage_rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points take `n_live`, the scene's live triangles: a rank tests
// only the live columns of its chunks.
extern "C" int rt_scan_abi() { return 3; }

extern "C" int rt_nearest_resident(const float* feats, const float* g, const float* aabbs,
                                   float* t, int* idx, int B, int NT, int TT, int n_live,
                                   int cluster, int chunks_per_rank, void* stream) {
  return launch<true, false>(feats, nullptr, g, aabbs, t, idx, nullptr, B, NT, TT, n_live,
                             cluster, chunks_per_rank, stream);
}

extern "C" int rt_nearest_shadow_resident(const float* feats, const float* sh, const float* g,
                                          const float* aabbs, float* t, int* idx, int* occ,
                                          int B, int NT, int TT, int n_live, int cluster,
                                          int chunks_per_rank, void* stream) {
  return launch<true, true>(feats, sh, g, aabbs, t, idx, occ, B, NT, TT, n_live, cluster,
                            chunks_per_rank, stream);
}

extern "C" int rt_occlude_resident(const float* sh, const float* g, const float* aabbs, int* occ,
                                   int B, int NT, int TT, int n_live, int cluster,
                                   int chunks_per_rank, void* stream) {
  return launch<false, true>(nullptr, sh, g, aabbs, nullptr, nullptr, occ, B, NT, TT, n_live,
                             cluster, chunks_per_rank, stream);
}

// What the current device offers the resident scans, into the host array
// out[3]: the shared memory one block may give to chunks of G (bytes: what
// it may opt in to, less what a rank keeps besides), the bytes of one
// staged chunk, and the largest portable cluster the merged scan (the one
// with the most registers) can be launched with at that size.
extern "C" int rt_resident_limits(int* out, void* stream) {
  (void)stream;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int for_chunks = optin - (int)sizeof(RankSmem);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int rc = configure<true, true>(cfg, attr, 1, smem_bytes(for_chunks / CHUNK_BYTES, false));
  if (rc != 0) return rc;
  cfg.numAttrs = 0;  // the query chooses the cluster size itself
  cfg.gridDim = dim3(840);  // a whole number of clusters of any size up to 8
  int max_cluster = 0;
  err = cudaOccupancyMaxPotentialClusterSize(&max_cluster, resident_kernel<true, true>, &cfg);
  if (err != cudaSuccess) return (int)err;
  out[0] = for_chunks;
  out[1] = CHUNK_BYTES;
  out[2] = max_cluster;
  return 0;
}

// How many clusters of `cluster` blocks with `chunks_per_rank` chunks each
// the device runs at once, for scan `which` (0 nearest, 1 merged, 2
// any-hit), into the host int out[0].
extern "C" int rt_resident_active_clusters(int* out, int which, int cluster, int chunks_per_rank,
                                           void* stream) {
  (void)stream;
  int stage_rows = 0;
  int rc = rows_fit(chunks_per_rank, &stage_rows);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int smem = smem_bytes(chunks_per_rank, stage_rows);
  cudaError_t err;
  if (which == 0) {
    rc = configure<true, false>(cfg, attr, cluster, smem);
    if (rc != 0) return rc;
    err = cudaOccupancyMaxActiveClusters(out, resident_kernel<true, false>, &cfg);
  } else if (which == 1) {
    rc = configure<true, true>(cfg, attr, cluster, smem);
    if (rc != 0) return rc;
    err = cudaOccupancyMaxActiveClusters(out, resident_kernel<true, true>, &cfg);
  } else {
    rc = configure<false, true>(cfg, attr, cluster, smem);
    if (rc != 0) return rc;
    err = cudaOccupancyMaxActiveClusters(out, resident_kernel<false, true>, &cfg);
  }
  return (int)err;
}
