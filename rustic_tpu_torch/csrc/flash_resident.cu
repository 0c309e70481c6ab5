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
// comes from. K9-K11 stage every visited tile from global memory (L2)
// again for every 256-ray block; here G is staged once per block lifetime.
//
// Design. The TPU kernel holds G in VMEM (8 MiB). An SM has 227 KB of
// shared memory, 1,408 triangles at 160 B each (ten rows of one float4),
// and every multi-tile scene is larger. So a thread-block cluster of c <= 8
// blocks holds the table in its distributed shared memory: G is cut into
// chunks of CHUNK = 128 triangles (20 KB), chunk k lives on rank k % c in
// slot k / c (round robin, so rays that walk the same tiles spread their
// reads over the ranks). Each rank stages its chunks once, the cluster
// synchronises, and then its blocks take ray blocks in a persistent loop
// with one ray per thread. A thread reads an admitted tile's float4 rows
// from the owning rank's shared memory (`mapa` gives the chunk's address in
// the cluster's shared window, `ld.shared::cluster` reads it; the generic
// pointer of cluster.map_shared_rank compiles to generic loads, which
// measured slower even with every chunk local); all lanes of a
// warp read the same address, so each read is one broadcast. When both ray
// sets of a warp admit a tile (K15), one read of a row feeds both chains; a
// chain that no lane of the warp needs is skipped. No block synchronises
// inside the ray loop: a warp whose rays all fail a tile's slab test skips
// it, which is a finer cull than the grid form's per-block one. A final cluster.sync() keeps every rank's shared memory
// alive until no block reads it. The grid is sized from
// cudaOccupancyMaxActiveClusters (a GPC may seat fewer clusters than
// SMs / c). Not carried over: the bf16 dot plans, the unrolled tile loop
// (a compile-time NT), and the per-block slab test. TMA multicast staging
// and wgmma are later work.

#include <cooperative_groups.h>

#include "flash_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace flash;

// rays per ray block, one per thread: one block fills an SM's 2,048-thread
// half at 64 registers a thread (no spills); 1,024 measured 5-15% ahead of 512
constexpr int THREADS = 1024;
constexpr int CHUNK_FLOAT4 = NROWS * CHUNK;  // one staged chunk: [row][triangle]
constexpr int CHUNK_BYTES = CHUNK_FLOAT4 * (int)sizeof(float4);  // 20,480

// The address, in the cluster's shared window, that `addr` (a shared-memory
// address of this block) has in the block of rank `rank`.
__device__ __forceinline__ unsigned cluster_address(unsigned addr, unsigned rank) {
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// volatile: not to be moved across the cluster barriers
__device__ __forceinline__ float4 load_cluster(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

template <bool NEAR, bool ANY>
__global__ void __launch_bounds__(THREADS, 1)
resident_kernel(const float* __restrict__ feats, const float* __restrict__ sh,
                const float* __restrict__ g, const float* __restrict__ aabbs,
                float* __restrict__ t_out, int* __restrict__ idx_out, int* __restrict__ occ_out,
                int B, int NT, int TT) {
  extern __shared__ float4 sg[];  // this rank's chunks: [slot][row][triangle]

  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int chunks_per_tile = TT / CHUNK;
  const int n_chunks = NT * chunks_per_tile;
  const size_t row_stride = (size_t)4 * TT * NT;
  const unsigned sg_address = (unsigned)__cvta_generic_to_shared(sg);

  // stage this rank's share of G, once
  for (int k = rank, slot = 0; k < n_chunks; k += c, ++slot) {
    const int tile = k / chunks_per_tile;
    const int c0 = (k % chunks_per_tile) * CHUNK;
    stage_chunk(sg + (size_t)slot * CHUNK_FLOAT4, g, row_stride, (size_t)tile * 4 * TT, TT, c0,
                CHUNK);
  }
  cluster.sync();  // every rank's chunks are in place

  const int n_ray_blocks = (B + THREADS - 1) / THREADS;
  for (int rb = blockIdx.x; rb < n_ray_blocks; rb += gridDim.x) {
    const int ray = rb * THREADS + threadIdx.x;
    if (ray >= B) continue;
    float f[NROWS], s[NROWS];
    load_rows(feats, B, ray, NEAR, f);
    load_rows(sh, B, ray, ANY, s);
    const float maxt = ANY ? sh[(size_t)MAXT_ROW * B + ray] : 0.0f;
    const SlabRay fr = slab_ray(f), sr = slab_ray(s);

    float best_t = BIG;
    int best_i = 0;
    bool occ = false;
    for (int tile = 0; tile < NT; ++tile) {
      const float* box = aabbs + (size_t)tile * 8;
      const bool near_ok = NEAR && slab_ok(fr, box, best_t);
      const bool any_ok = ANY && !occ && slab_ok(sr, box, maxt);
      if (!near_ok && !any_ok) continue;
      const unsigned lanes = __activemask();  // the lanes that admit the tile for a set
      const bool warp_near = NEAR && __any_sync(lanes, near_ok);
      const bool warp_any = ANY && __any_sync(lanes, any_ok);
      for (int cc = 0; cc < chunks_per_tile; ++cc) {
        const int k = tile * chunks_per_tile + cc;
        const unsigned chunk = cluster_address(sg_address, (unsigned)(k % c)) +
                               (unsigned)(k / c) * (unsigned)CHUNK_BYTES;
        const int base = tile * TT + cc * CHUNK;
#pragma unroll 2
        for (int j = 0; j < CHUNK; ++j) {
          float4 an, aa;
#pragma unroll
          for (int r = 0; r < NROWS; ++r) {
            // one read feeds both chains
            const float4 gr = load_cluster(chunk + (unsigned)((r * CHUNK + j) * sizeof(float4)));
            if (warp_near) pair_accumulate(an, f[r], gr, r == 0);
            if (warp_any) pair_accumulate(aa, s[r], gr, r == 0);
          }
          if (near_ok) {
            float t;
            bool valid;
            pair_epilogue(an, t, valid);
            const float tm = valid ? t : BIG;
            if (tm < best_t) {
              best_t = tm;
              best_i = base + j;
            }
          }
          if (any_ok && !occ) {
            float t;
            bool valid;
            pair_epilogue(aa, t, valid);
            occ = valid && t <= maxt;
          }
        }
      }
    }
    if (NEAR) {
      t_out[ray] = best_t;
      idx_out[ray] = best_i;
    }
    if (ANY) occ_out[ray] = occ ? 1 : 0;
  }
  cluster.sync();  // no rank leaves while another may still read its chunks
}

template <bool NEAR, bool ANY>
int configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int cluster, int smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(resident_kernel<NEAR, ANY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return 0;
}

// Launch on a persistent grid: as many clusters as the card seats at once,
// at most one per `cluster` ray blocks.
template <bool NEAR, bool ANY>
int launch(const float* feats, const float* sh, const float* g, const float* aabbs, float* t,
           int* idx, int* occ, int B, int NT, int TT, int cluster, int chunks_per_rank,
           void* stream) {
  if (TT % CHUNK != 0 || cluster < 1 || cluster * chunks_per_rank < NT * (TT / CHUNK))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int rc = configure<NEAR, ANY>(cfg, attr, cluster, chunks_per_rank * CHUNK_BYTES);
  if (rc != 0) return rc;
  int active = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&active, resident_kernel<NEAR, ANY>, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  const int n_ray_blocks = (B + THREADS - 1) / THREADS;
  const int wanted = (n_ray_blocks + cluster - 1) / cluster;
  cfg.gridDim = dim3((unsigned)(min(active, max(wanted, 1)) * cluster));
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, resident_kernel<NEAR, ANY>, feats, sh, g, aabbs, t, idx, occ, B,
                           NT, TT);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_nearest_resident(const float* feats, const float* g, const float* aabbs,
                                   float* t, int* idx, int B, int NT, int TT, int cluster,
                                   int chunks_per_rank, void* stream) {
  return launch<true, false>(feats, nullptr, g, aabbs, t, idx, nullptr, B, NT, TT, cluster,
                             chunks_per_rank, stream);
}

extern "C" int rt_nearest_shadow_resident(const float* feats, const float* sh, const float* g,
                                          const float* aabbs, float* t, int* idx, int* occ,
                                          int B, int NT, int TT, int cluster,
                                          int chunks_per_rank, void* stream) {
  return launch<true, true>(feats, sh, g, aabbs, t, idx, occ, B, NT, TT, cluster,
                            chunks_per_rank, stream);
}

extern "C" int rt_occlude_resident(const float* sh, const float* g, const float* aabbs, int* occ,
                                   int B, int NT, int TT, int cluster, int chunks_per_rank,
                                   void* stream) {
  return launch<false, true>(nullptr, sh, g, aabbs, nullptr, nullptr, occ, B, NT, TT, cluster,
                             chunks_per_rank, stream);
}

// What the current device offers the resident scans, into the host array
// out[3]: the shared memory one block may opt in to (bytes), the bytes of
// one staged chunk, and the largest portable cluster the merged scan (the
// one with the most registers) can be launched with at that size.
extern "C" int rt_resident_limits(int* out, void* stream) {
  (void)stream;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int smem = optin / CHUNK_BYTES * CHUNK_BYTES;
  int rc = configure<true, true>(cfg, attr, 1, smem);
  if (rc != 0) return rc;
  cfg.numAttrs = 0;  // the query chooses the cluster size itself
  cfg.gridDim = dim3(840);  // a whole number of clusters of any size up to 8
  int max_cluster = 0;
  err = cudaOccupancyMaxPotentialClusterSize(&max_cluster, resident_kernel<true, true>, &cfg);
  if (err != cudaSuccess) return (int)err;
  out[0] = optin;
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
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int smem = chunks_per_rank * CHUNK_BYTES;
  int rc;
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
