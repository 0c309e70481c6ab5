// One bounce in one launch (kernel K17) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel of archive/fused_bounce/fused_bounce.py
// (_build_kernel, called through fused_bounce): one program a bounce that
// scans every triangle tile for each ray's nearest hit, fetches the
// winner's attribute row, folds the previous bounce's shadow result, and
// runs the whole shading stage (emission and MIS, BSDF sample, NEE alias
// pick and shadow ray, roulette, sky on the last bounce).
//   rt_fused_bounce  <- fused_bounce
//
// What it computes, per lane: what a scan and then K4 or K8 (csrc/shade.cu)
// compute, from the same device code. The scan is K2's on one tile
// (`scan_tile` of flash_common.cuh: the strict-< nearest fold from t = inf
// over the live columns, the first index winning, and the previous bounce's
// shadow rays tested in the same pass, template flag ANY) and K10's on many
// (`grid::walk` of flash_grid.cuh: from (BIG, 0), tiles ascending, each
// ray's own slab test against the tiles' AABBs for both sets); then
// `shade::shade_lane` of shade_common.cuh on the winner's row of the f32
// slim table. The shadow result is folded into the radiance, or, at the
// first bounce of a group, whose shadow rays belong to the group before it,
// written out as occ [B] for the render loop (occ_out). Outputs: the packed
// state [19, B], the next ray rows [16, B], the shadow ray rows [16, B].
// K17 equals K2 -> K4 (one tile) and K10 -> K8 (many tiles) bit for bit:
// the scans share pair_accumulate, pair_skip and pair_epilogue, whose
// roundings are written out, and this file is built with -fmad=false as
// shade.cu is. Against a scan of every pair of every tile it differs only
// in the occlusion of shadow rays the per-ray cull turns away, where their
// NEE term is not eligible and no fold reads it (dead lanes 1e6 away, on
// many tiles; flash_multi.cu says why).
//
// What bounds it: the scan's operations, 81 a (ray, triangle) pair over the
// real triangles of both ray sets: 1.640 ms at the single-tile path's
// 3,686,400 lanes and 184 triangles (67 TFLOP/s FP32); on many tiles the
// pairs each ray's slab test admits. By bytes it moves what K4 moves
// (shade_kernel.rows_moved) less what stays on the SM: t, idx, occ and the
// winner's [32, B] row are neither written by a scan nor read back by a
// shade launch (about 280 B a lane), and rd, ro are read as the scan's
// feature rows.
//
// Design. One tile: K2's persistent blocks of 128 threads, sized by the
// occupancy query, each staging the live columns of the packed table once
// by cp.async and then walking blocks of 256 rays, two rays a thread (each
// broadcast float4 of G feeds both rays of both sets): `scan_ray_blocks`
// of flash_common.cuh, K1-K3's frame. After the scan a thread shades its
// two rays one after the other, in a loop kept rolled so that the shading
// body is compiled once and the second ray's scan result is all it carries
// across the first ray's shading. The scan loop takes one column a pass
// where K2 takes four: the blocks of an SM scan and shade at once, and the
// smaller loop leaves the shading room in the instruction cache (on an
// H100 80GB HBM3 at 700 W, 3,686,400 DarkCornell lanes of bounce 1, 4.965
// against 5.960 ms; 113 and 110 registers, 4 blocks an SM either way;
// `probe_kernel_builds fused`, PERF.md section 6). Many tiles: K10's block
// of 256 rays in shared memory (`grid::GridSmem`, 72 KB, with the dynamic
// shared-memory opt-in): packed (ray, set) items, a ring of two cp.async
// chunks, the atomicMin key merge; after the walk and one barrier each
// thread shades its own ray from its merged key and flag. Its launch bound
// of 3 blocks an SM (what the shared memory allows) keeps the mode without
// shadow rays at 3 blocks (92 registers would give 2: 7.731 against 8.628
// ms at 4,194,304 VeachMIS lanes of bounce 0 on the same card and probe).
// The alias entries of the narrow mode (at most 16) sit in shared memory
// on one tile; many tiles, and the wide mode, read the picked row from the
// global table (the entries beside GridSmem would cost the third block). A
// thread reads its winner's row directly (the TPU kernel's one-hot matmuls
// stand in for a gather a Mosaic kernel lacks). The TPU kernel's operands not carried
// over: the [B, 32] row-major state and the [B, 8 * max_bounces] draws (the
// state is K4's [19, B] rows and the LDS draws are computed from sidx and
// offsets in the kernel, as K4 does, so the loops share initk and finishk),
// and prev_occ (the shadow rays are scanned here; the TPU loop ran a
// separate occlusion launch).

#include "flash_grid.cuh"
#include "shade_common.cuh"

namespace {

using namespace flash;

constexpr int TILE_THREADS = 128;  // one tile: threads a block
constexpr int RPT = 2;             // one tile: rays a thread
constexpr int TILE_RAYS = TILE_THREADS * RPT;
constexpr int MAX_TT = 512;
constexpr int SCAN_UNROLL = 1;  // columns a pass of the one-tile scan loop (see Design)
constexpr int ENTRY_FLOATS = shade::MAX_ALIAS * shade::ENTRY_WIDTH;
static_assert(RPT == 2, "the shading loop picks between two rays");

// The lane's scan results, held in registers; the winner's slim row is read
// from the table where the body asks for a column.
struct ScanSource {
  const float* row;
  float best_t;
  int best_i;
  bool fold;
  bool occluded;
  __device__ __forceinline__ bool has_occ() const { return fold; }
  __device__ __forceinline__ int occ() const { return occluded ? 1 : 0; }
  __device__ __forceinline__ float t() const { return best_t; }
  __device__ __forceinline__ int idx() const { return best_i; }
  __device__ __forceinline__ float attr(int c) const { return __ldg(row + c); }
};

struct FusedArgs {
  const float* feats;       // [16, B] rays
  const float* sh;          // [16, B] shadow rays of the bounce before (ANY)
  const float4* pg;         // the packed triangle table (ops/flash_intersect.py packed_table)
  const float* aabbs;       // [NT, 8] tile AABBs (many tiles)
  const float* attrs;       // [NT * TT, W] slim rows
  const float* entry_rows;  // [n_alias.., 48] alias entries
  const float* st;          // [19, B] packed state
  float* st_out;
  float* nf_out;
  float* sf_out;
  int* occ_out;  // [B] or null: fold the shadow result into the state
  int NT, TT, W, n_live;
  shade::Bounce p;
};

// The narrow mode's alias entries into shared memory; visible after the
// caller's next barrier.
template <bool WIDE>
__device__ __forceinline__ void stage_entries(const FusedArgs& a, float* s_entry) {
  if constexpr (!WIDE) {
    if (a.p.uses_nee) {
      for (int e = threadIdx.x; e < a.p.n_alias * shade::ENTRY_WIDTH; e += blockDim.x)
        s_entry[e] = a.entry_rows[e];
    }
  }
}

// Lane `ray` from its scan result: hand the occlusion back or fold it,
// then the shading stage on the winner's row.
template <bool ANY, bool WIDE>
__device__ __forceinline__ void shade_ray(const FusedArgs& a, const float* s_entry, int ray,
                                          float t, int idx, bool occ, shade::V3 rd,
                                          shade::V3 ro) {
  const bool hold = ANY && a.occ_out != nullptr;  // the result is another group's
  if (hold) a.occ_out[ray] = occ ? 1 : 0;
  const ScanSource src{a.attrs + (size_t)idx * a.W, t, idx, ANY && !hold, occ};
  shade::shade_lane<WIDE>(a.p, WIDE ? a.entry_rows : s_entry, a.st, rd, ro, src, a.st_out,
                          a.nf_out, a.sf_out, ray);
}

template <bool ANY, bool WIDE>
__global__ void __launch_bounds__(TILE_THREADS) fused_tile_kernel(const FusedArgs a) {
  extern __shared__ float4 sg[];  // [row][live triangle] -> (det, u, v, t)
  __shared__ float s_entry[WIDE ? 1 : ENTRY_FLOATS];
  stage_entries<WIDE>(a, s_entry);  // visible after the staging's barrier
  const int B = a.p.B;
  scan_ray_blocks<true, ANY, TILE_THREADS, RPT, SCAN_UNROLL>(
      sg, a.pg, a.TT, a.n_live, a.feats, a.sh, B, [&](const TileRays<RPT>& r) {
#pragma unroll 1
        for (int k = 0; k < RPT; ++k) {
          const bool second = k != 0;
          if (!(second ? r.active[1] : r.active[0])) continue;
          const int ray = second ? r.ray[1] : r.ray[0];
          const float* fr = a.feats + ray;  // rd, ro again, from the cache
          const shade::V3 rd =
              shade::v3(__ldg(fr), __ldg(fr + (size_t)B), __ldg(fr + 2 * (size_t)B));
          const shade::V3 ro = shade::v3(__ldg(fr + 6 * (size_t)B), __ldg(fr + 7 * (size_t)B),
                                         __ldg(fr + 8 * (size_t)B));
          shade_ray<ANY, WIDE>(a, s_entry, ray, second ? r.best_t[1] : r.best_t[0],
                               second ? r.best_i[1] : r.best_i[0],
                               second ? r.occ[1] : r.occ[0], rd, ro);
        }
      });
}

// Both alias modes read the picked entry from the global table (Design).
template <bool ANY>
__global__ void __launch_bounds__(grid::THREADS, 3) fused_grid_kernel(const FusedArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  grid::GridSmem& sm = *reinterpret_cast<grid::GridSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int ray = blockIdx.x * grid::THREADS + tid;
  const bool active = ray < a.p.B;
  grid::load_rays<true, ANY>(sm, a.feats, a.sh, a.p.B, ray, active);
  grid::walk<true, ANY, false>(sm, a.pg, a.aabbs, nullptr, a.NT, active, a.TT, a.n_live);
  __syncthreads();  // every key and flag of the block merged
  if (!active) return;
  const unsigned long long key = sm.best[tid];
  const shade::V3 rd = shade::v3(sm.rows[0][0][tid], sm.rows[0][1][tid], sm.rows[0][2][tid]);
  const shade::V3 ro = shade::v3(sm.rows[0][6][tid], sm.rows[0][7][tid], sm.rows[0][8][tid]);
  shade_ray<ANY, true>(a, nullptr, ray, win_t(key), (int)(unsigned)(key & 0xffffffffull),
                       sm.occ[tid] != 0, rd, ro);
}

// One mode of the kernel: its threads, its dynamic shared memory, and the
// shared-memory opt-in and SM count at the first call of each mode.
template <bool MANY, bool ANY, bool WIDE>
struct Mode {
  static constexpr int threads = MANY ? grid::THREADS : TILE_THREADS;
  static auto kernel() {
    if constexpr (MANY) return fused_grid_kernel<ANY>;
    else return fused_tile_kernel<ANY, WIDE>;
  }
  static size_t smem(int n_live) {
    return MANY ? sizeof(grid::GridSmem) : (size_t)NROWS * n_live * sizeof(float4);
  }
  static cudaError_t ready(int& sms) {
    static int n_sms = 0;
    const cudaError_t e = opt_in(
        kernel(), MANY ? sizeof(grid::GridSmem) : (size_t)NROWS * MAX_TT * sizeof(float4), n_sms);
    sms = n_sms;
    return e;
  }
  // One tile: a persistent grid (`persistent_grid`); many tiles: one block
  // per 256 rays.
  static int launch(const FusedArgs& a, cudaStream_t stream) {
    int sms = 0;
    cudaError_t e = ready(sms);
    if (e != cudaSuccess) return (int)e;
    const int n_blocks = (a.p.B + TILE_RAYS - 1) / TILE_RAYS;
    int grid = n_blocks > 0 ? n_blocks : 1;
    if (!MANY) {
      e = persistent_grid(kernel(), threads, smem(a.n_live), sms, n_blocks, grid);
      if (e != cudaSuccess) return (int)e;
    }
    kernel()<<<grid, threads, smem(a.n_live), stream>>>(a);
    return (int)cudaGetLastError();
  }
};
static_assert(grid::THREADS == TILE_RAYS, "a ray block is 256 rays in both modes");

// f(Mode<many, any, wide>{}) for the runtime flags.
template <class F>
int with_mode(bool many, bool any, bool wide, F&& f) {
  if (many) {
    if (any) return wide ? f(Mode<true, true, true>{}) : f(Mode<true, true, false>{});
    return wide ? f(Mode<true, false, true>{}) : f(Mode<true, false, false>{});
  }
  if (any) return wide ? f(Mode<false, true, true>{}) : f(Mode<false, true, false>{});
  return wide ? f(Mode<false, false, true>{}) : f(Mode<false, false, false>{});
}

}  // namespace

// The entry points' layout: from 2 the packed table (packed_table of
// ops/flash_intersect.py), the tiles' AABBs and the live triangle count.
extern "C" int rt_fused_abi() { return 2; }

// Blocks of one mode an SM holds (the occupancy query the launch makes),
// or minus the CUDA error.
extern "C" int rt_fused_blocks_per_sm(int many, int any, int wide, int n_live) {
  return with_mode(many != 0, any != 0, wide != 0, [&](auto m) {
    using M = decltype(m);
    int sms = 0, per_sm = 0;
    cudaError_t e = M::ready(sms);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, M::kernel(), M::threads,
                                                        M::smem(n_live));
    return e == cudaSuccess ? per_sm : -(int)e;
  });
}

// sh null: no shadow rays are scanned. occ_out non-null (with sh): their
// result is written there and not folded. wide: the alias entry is read
// from the global table (any n_alias); else the table of at most 16
// entries is staged in shared memory. aabbs: required on many tiles
// (NT > 1). n_live: the live triangles, 1..NT * TT.
extern "C" int rt_fused_bounce(const float* params, const float* entry_rows, const float* st,
                               const float* feats, const float* sh, const float* pg,
                               const float* aabbs, const float* attrs, const int* sidx,
                               const int* offsets, const int* primes, float* st_out,
                               float* nf_out, float* sf_out, int* occ_out, int B, int NT, int TT,
                               int W, int n_live, int bounce, int min_bounces, int max_bounces,
                               int nee, int uses_nee, int has_glass, int n_alias,
                               int n_entry_rows, int wide, void* stream) {
  if (W <= shade::A_IOR || NT < 1 || TT < 1 || n_live < 1 || n_live > NT * TT)
    return (int)cudaErrorInvalidValue;
  if ((NT == 1 && TT > MAX_TT) || (NT > 1 && aabbs == nullptr)) return (int)cudaErrorInvalidValue;
  if (uses_nee && (n_alias < 1 || n_alias > n_entry_rows || (!wide && n_alias > shade::MAX_ALIAS)))
    return (int)cudaErrorInvalidValue;
  if (occ_out != nullptr && sh == nullptr) return (int)cudaErrorInvalidValue;
  const FusedArgs a{feats, sh, reinterpret_cast<const float4*>(pg), aabbs, attrs, entry_rows, st,
                    st_out, nf_out, sf_out, occ_out, NT, TT, W, n_live,
                    shade::Bounce{params, sidx, offsets, primes, B, bounce, min_bounces,
                                  max_bounces, nee, uses_nee, has_glass, n_alias,
                                  /*has_skybox=*/0}};
  return with_mode(NT > 1, sh != nullptr, wide != 0, [&](auto m) {
    return decltype(m)::launch(a, (cudaStream_t)stream);
  });
}
