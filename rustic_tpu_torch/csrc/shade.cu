// One bounce's shading stage (kernels K4 and K8) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel of rustic_tpu/ops/shade_kernel.py
// (_build_kernel, called through shade_bounce):
//   rt_shade_bounce       (K4) <- the kernel with its in-kernel alias pick
//                                 over a table of at most 16 entries
//   rt_shade_bounce_wide  (K8) <- its prepicked mode (shade_kernel.py:683,
//                                 operands :969-971) together with the XLA
//                                 pick before it (ops/resolve.py
//                                 picked_light_rows_t), for wider tables
//
// What it computes, per lane: fold the previous bounce's shadow result into
// the radiance, re-test the winner triangle in exact f32 (Moller-Trumbore),
// add emission with the MIS weight, sample the BSDF (Lambert/GGX or the GGX
// dielectric), pick a light from the alias table and build the shadow ray
// (NEE), update throughput, russian roulette after min_bounces, add the
// procedural sky to escaped lanes on the last bounce (in HDR-sky mode,
// has_skybox, the driver adds the image sky instead), and write the packed
// state [19, B], the next ray rows [16, B] and the shadow ray rows [16, B].
//
// What bounds them: memory. A lane reads 19 + 16 + 32 + 4 f32/i32 rows and
// writes 19 + 16 + 16: about 0.5 KB per lane, 1.8 GB per call at the
// single-tile path's 3,686,400 lanes, 2.1 GB at the multi-tile path's
// 4,194,304. The arithmetic (a few hundred flops, the sky march only on
// escaped lanes of the last bounce) is small beside it.
//
// Design: one thread per lane, a straight per-lane port of the JAX kernel;
// every row is read and written once, coalesced (lane i of row r at r*B+i).
// K4 keeps the <= 16 x 48 alias entry table in shared memory and the pick
// reads the chosen row directly (the TPU kernel's select-sum over all rows
// adds exact zeros, so `0 + x` gives the same value). K8 (the template flag
// WIDE) reads the picked entry's row straight from the global table through
// the read-only cache: a Mosaic kernel has no per-lane gather, so the TPU
// picks in XLA and streams an [18, B] buffer of picked fields into the
// kernel (302 MB at 4,194,304 lanes); here one thread reads its own row
// (VeachMIS's 2,880 x 192 B table stays in L2). The TPU's [R,128] lane
// tiling and its bool-through-f32 selects are not carried over.
//
// Numerics: the operation order of the plain PyTorch twin
// (ops/shade_kernel.py), which follows the JAX kernel; a division by a
// constant is a multiply by its f32 reciprocal, as XLA compiles it. This
// file is compiled with -fmad=false so that no product is fused into an
// add: the twin runs one operation per torch kernel and rounds every
// product. max/min/clamp propagate NaN as torch and XLA do.

// The helpers and the per-lane body, `shade::shade_lane`, live in
// shade_common.cuh; fused_bounce.cu (K17) runs the same body after its scan.

#include "shade_common.cuh"

namespace {

using namespace shade;

constexpr int THREADS = 256;

// The lane's scan results, read from the rows a scan (and the row resolve)
// wrote to device memory: each is read only where the body asks for it.
struct RowSource {
  const float* t_in;
  const int* idx_in;
  const float* attrs;  // [32, B]
  const int* occ_in;   // [B] or null: no shadow result to fold
  int B, i;
  __device__ __forceinline__ bool has_occ() const { return occ_in != nullptr; }
  __device__ __forceinline__ int occ() const { return __ldg(occ_in + i); }
  __device__ __forceinline__ float t() const { return __ldg(t_in + i); }
  __device__ __forceinline__ int idx() const { return __ldg(idx_in + i); }
  __device__ __forceinline__ float attr(int c) const { return __ldg(attrs + (size_t)c * B + i); }
};

template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
shade_kernel(const float* __restrict__ params, const float* __restrict__ entry_rows,
             const float* __restrict__ st, const float* __restrict__ feats,
             const float* __restrict__ t_in, const int* __restrict__ idx_in,
             const float* __restrict__ attrs, const int* __restrict__ occ_in,
             const int* __restrict__ sidx_in, const int* __restrict__ off_in,
             const int* __restrict__ primes, float* __restrict__ st_out,
             float* __restrict__ nf_out, float* __restrict__ sf_out,
             int B, int bounce, int min_bounces, int max_bounces, int nee,
             int uses_nee, int has_glass, int n_alias, int has_skybox) {
  __shared__ float s_entry[WIDE ? 1 : MAX_ALIAS * ENTRY_WIDTH];
  if constexpr (!WIDE) {
    if (uses_nee) {
      for (int e = threadIdx.x; e < n_alias * ENTRY_WIDTH; e += THREADS) s_entry[e] = entry_rows[e];
    }
    __syncthreads();
  }
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= B) return;

  const Bounce p{params, sidx_in, off_in, primes, B, bounce, min_bounces, max_bounces,
                 nee, uses_nee, has_glass, n_alias, has_skybox};
  const RowSource src{t_in, idx_in, attrs, occ_in, B, i};
#define ROW(p, r) (p)[(size_t)(r) * B + i]
  const V3 rd = v3(ROW(feats, 0), ROW(feats, 1), ROW(feats, 2));
  const V3 ro = v3(ROW(feats, 6), ROW(feats, 7), ROW(feats, 8));
#undef ROW
  shade_lane<WIDE>(p, WIDE ? entry_rows : s_entry, st, rd, ro, src, st_out, nf_out, sf_out, i);
}

}  // namespace

extern "C" int rt_shade_bounce(const float* params, const float* entry_rows, const float* st,
                               const float* feats, const float* t, const int* idx,
                               const float* attrs, const int* occ, const int* sidx,
                               const int* offsets, const int* primes, float* st_out,
                               float* nf_out, float* sf_out, int B, int bounce,
                               int min_bounces, int max_bounces, int nee, int uses_nee,
                               int has_glass, int n_alias, int n_entry_rows, int has_skybox,
                               void* stream) {
  if (uses_nee && (n_alias > MAX_ALIAS || n_alias > n_entry_rows)) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + THREADS - 1) / THREADS);
  shade_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      params, entry_rows, st, feats, t, idx, attrs, occ, sidx, offsets, primes, st_out,
      nf_out, sf_out, B, bounce, min_bounces, max_bounces, nee, uses_nee, has_glass, n_alias,
      has_skybox);
  return (int)cudaGetLastError();
}

extern "C" int rt_shade_bounce_wide(const float* params, const float* entry_rows,
                                    const float* st, const float* feats, const float* t,
                                    const int* idx, const float* attrs, const int* occ,
                                    const int* sidx, const int* offsets, const int* primes,
                                    float* st_out, float* nf_out, float* sf_out, int B,
                                    int bounce, int min_bounces, int max_bounces, int nee,
                                    int uses_nee, int has_glass, int n_alias, int n_entry_rows,
                                    int has_skybox, void* stream) {
  if (uses_nee && (n_alias < 1 || n_alias > n_entry_rows)) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + THREADS - 1) / THREADS);
  shade_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      params, entry_rows, st, feats, t, idx, attrs, occ, sidx, offsets, primes, st_out,
      nf_out, sf_out, B, bounce, min_bounces, max_bounces, nee, uses_nee, has_glass, n_alias,
      has_skybox);
  return (int)cudaGetLastError();
}
