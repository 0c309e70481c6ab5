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
// What it computes, per lane: what K2 (csrc/flash_intersect.cu; K10's every
// pair on many tiles) and then K4 or K8 (csrc/shade.cu) compute, from the
// same device code: the pair test of flash_common.cuh over all NT tiles,
// ascending, strict < (so the first index wins; a miss gives (BIG, 0)), with
// the previous bounce's shadow rays tested in the same pass (template flag
// ANY); then `shade::shade_lane` of shade_common.cuh on the winner's row of
// the f32 slim table. The shadow result is folded into the radiance, or, at
// the first bounce of a group, whose shadow rays belong to the group before
// it, written out as occ [B] for the render loop (occ_out). Outputs: the packed
// state [19, B], the next ray rows [16, B], the shadow ray rows [16, B].
// K17 equals K2 -> K4 bit for bit: the scans share pair_accumulate and
// pair_epilogue, whose roundings are written out, and this file is built
// with -fmad=false as shade.cu is.
//
// What bounds it: the scan's operations, 81 a (ray, triangle) pair over the
// real triangles of both ray sets: 1.640 ms at the single-tile path's
// 3,686,400 lanes and 184 triangles (67 TFLOP/s FP32). By bytes it moves
// what K4 moves (shade_kernel.rows_moved) less what stays on the SM: t,
// idx, occ and the winner's [32, B] row are neither written by a scan nor
// read back by a shade launch (about 280 B a lane), and rd, ro are read
// once, as the scan's feature rows.
//
// Design: one thread per ray, 128 rays a block, as the scans. A loop over
// tiles and 128-triangle chunks inside the block takes the place of the TPU
// kernel's (ray block, tile) grid and its scratch carry; a thread reads its
// winner's row and its alias entry directly (the TPU kernel's one-hot
// matmuls stand in for a gather a Mosaic kernel lacks). The state rows are
// loaded after the scan, so the scan loop's live registers are the two
// rays' feature values and the running best. The TPU kernel's operands not
// carried over: the [B, 32] row-major state and the [B, 8 * max_bounces]
// draws (the state is K4's [19, B] rows and the LDS draws are computed
// from sidx and offsets in the kernel, as K4 does, so the loops share
// initk and finishk), and prev_occ (the shadow rays are scanned here, as K2
// scans them; the TPU loop ran a separate occlusion launch).

#include "flash_common.cuh"
#include "shade_common.cuh"

namespace {

constexpr int THREADS = 128;  // rays per block

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
  const float* g;           // [16, NT * 4 * TT] triangle table
  const float* attrs;       // [NT * TT, W] slim rows
  const float* entry_rows;  // [n_alias.., 48] alias entries
  const float* st;          // [19, B] packed state
  float* st_out;
  float* nf_out;
  float* sf_out;
  int* occ_out;  // [B] or null: fold the shadow result into the state
  int NT, TT, W;
  shade::Bounce p;
};

template <bool ANY, bool WIDE>
__global__ void __launch_bounds__(THREADS) fused_kernel(const FusedArgs a) {
  using namespace flash;
  __shared__ float4 sg[NROWS * CHUNK];  // [row][triangle] -> (det, u, v, t)
  __shared__ float s_entry[WIDE ? 1 : shade::MAX_ALIAS * shade::ENTRY_WIDTH];
  if constexpr (!WIDE) {  // visible after the scan loop's first barrier
    if (a.p.uses_nee) {
      for (int e = threadIdx.x; e < a.p.n_alias * shade::ENTRY_WIDTH; e += THREADS)
        s_entry[e] = a.entry_rows[e];
    }
  }

  const int B = a.p.B;
  const int ray = blockIdx.x * THREADS + threadIdx.x;
  const bool active = ray < B;
  float f[NROWS], s[NROWS];
  load_rows(a.feats, B, ray, active, f);
  load_rows(a.sh, B, ray, ANY && active, s);
  const float maxt = (ANY && active) ? a.sh[(size_t)MAXT_ROW * B + ray] : 0.0f;

  // ---- the scan: scan_kernel<true, ANY, .> over every tile, ascending
  const size_t row_stride = (size_t)4 * a.TT * a.NT;
  float best_t = a.NT == 1 ? INFINITY : BIG;  // K2's start on one tile, K6/K10's on many
  int best_i = 0;
  bool occ = false;
  for (int tile = 0; tile < a.NT; ++tile) {
    for (int c0 = 0; c0 < a.TT; c0 += CHUNK) {
      const int n = min(CHUNK, a.TT - c0);
      __syncthreads();  // the previous chunk is consumed
      stage_chunk(sg, a.g, row_stride, (size_t)tile * 4 * a.TT, a.TT, c0, n);
      __syncthreads();
      if (!active) continue;
      const int base = tile * a.TT + c0;
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        float t;
        bool valid;
        pair_test(f, sg, j, t, valid);
        const float tm = valid ? t : BIG;
        if (tm < best_t) {
          best_t = tm;
          best_i = base + j;
        }
        if (ANY && !occ) {
          pair_test(s, sg, j, t, valid);
          occ = valid && t <= maxt;
        }
      }
    }
  }
  if (!active) return;
  const bool hold = ANY && a.occ_out != nullptr;  // the result is another group's
  if (hold) a.occ_out[ray] = occ ? 1 : 0;

  // ---- the shading stage on the winner's row
  const ScanSource src{a.attrs + (size_t)best_i * a.W, best_t, best_i, ANY && !hold, occ};
  const shade::V3 rd = shade::v3(f[0], f[1], f[2]);
  const shade::V3 ro = shade::v3(f[6], f[7], f[8]);
  shade::shade_lane<WIDE>(a.p, WIDE ? a.entry_rows : s_entry, a.st, rd, ro, src, a.st_out,
                          a.nf_out, a.sf_out, ray);
}

template <bool ANY, bool WIDE>
int launch(const FusedArgs& a, cudaStream_t stream) {
  const dim3 grid((a.p.B + THREADS - 1) / THREADS);
  fused_kernel<ANY, WIDE><<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// sh null: no shadow rays are scanned. occ_out non-null (with sh): their
// result is written there and not folded. wide: the alias entry is read
// from the global table (any n_alias); else the table of at most 16
// entries is staged in shared memory.
extern "C" int rt_fused_bounce(const float* params, const float* entry_rows, const float* st,
                               const float* feats, const float* sh, const float* g,
                               const float* attrs, const int* sidx, const int* offsets,
                               const int* primes, float* st_out, float* nf_out, float* sf_out,
                               int* occ_out, int B, int NT, int TT, int W, int bounce,
                               int min_bounces, int max_bounces, int nee, int uses_nee,
                               int has_glass, int n_alias, int n_entry_rows, int wide,
                               void* stream) {
  if (W <= shade::A_IOR || NT < 1 || TT < 1) return (int)cudaErrorInvalidValue;
  if (uses_nee && (n_alias < 1 || n_alias > n_entry_rows || (!wide && n_alias > shade::MAX_ALIAS)))
    return (int)cudaErrorInvalidValue;
  if (occ_out != nullptr && sh == nullptr) return (int)cudaErrorInvalidValue;
  const FusedArgs a{feats, sh, g, attrs, entry_rows, st, st_out, nf_out, sf_out, occ_out,
                    NT, TT, W,
                    shade::Bounce{params, sidx, offsets, primes, B, bounce, min_bounces,
                                  max_bounces, nee, uses_nee, has_glass, n_alias,
                                  /*has_skybox=*/0}};
  const cudaStream_t s = (cudaStream_t)stream;
  if (sh != nullptr) return wide ? launch<true, true>(a, s) : launch<true, false>(a, s);
  return wide ? launch<false, true>(a, s) : launch<false, false>(a, s);
}
