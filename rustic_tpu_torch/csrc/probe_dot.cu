// The dot-rate probes (kernels K18 and K19) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels of tools/mxu_floor.py (_case_kernel, and
// the int8 kernel k8 inside main) and of tools/probe_k96.py (_kernel):
//   rt_dot_min        (K18) <- _case_kernel / k8
//   rt_dot_min_split  (K19) <- probe_k96._kernel with split_in_kernel
// (probe_k96's pre-split K=96 and K=48 cases are rt_dot_min on bf16
// operands of that depth).
//
// What they compute: out[b] = min over r < reps and n < N of the dot
// F[:, b] . G[:, r*N + n], for F [K, B] and G [K, N*reps]; with acc_min off
// only column r*N of each slice enters the min, the dots are done all the
// same. This is the shape of the flash scans' pair test (rays against
// triangle columns, reduced per ray) without its epilogue, so its rate says
// how fast that dot can go on each arithmetic unit of the card:
//   variant 0  FP32 FMAs, a few rays a thread, G staged in shared memory
//              and read as broadcast float4: what kernels K1-K17 do;
//   variant 1  TF32 tensor cores, mma.sync m16n8k8, FP32 accumulate;
//   variant 2  BF16 tensor cores, mma.sync m16n8k16, FP32 accumulate
//              (K = 8 is padded with zeros to 16);
//   variant 3  int8 tensor cores, mma.sync m16n8k32, int32 accumulate
//              (K = 16 is padded with zeros to 32), out int32;
//   variant 4  BF16 tensor cores, wgmma.mma_async m64n128k16 (the warpgroup
//              instruction, Hopper's way to the full tensor-core rate), FP32
//              accumulate, the rays' operand in registers, G's in shared
//              memory fed by bulk copies; acc_min only;
//   variant 5  TF32 tensor cores, wgmma.mma_async m64n128k8, as variant 4;
//   variant 6  int8 tensor cores, wgmma.mma_async m64n128k32.s32.s8.s8, as
//              variant 4 with int32 accumulators (K = 16 padded with zeros
//              to 32, as variant 3 pads it), the fold a tree of the
//              three-input DPX min __vimin3_s32; out int32.
// (Variant 3 pads K = 16 to its K step of 32 just as variant 6 does: the
// zeros do not tell the two instructions apart. Variant 3 stays as
// mma.sync's probe, variant 6 is the way to the full int8 rate.)
// K19 emulates an f32 dot of depth 16 as one BF16 pass of depth 96: each
// f32 value a is split into bf16 hi = bf16(a), mid = bf16(a - hi), lo =
// bf16(a - hi - mid); G arrives split, its blocks [hb mb lb hb mb hb] along
// K; F [16, B] f32 is split in the kernel into [ha ha ha ma ma la], which
// keeps the six largest cross terms, every product exact in the FP32
// accumulator.
//
// What bounds them: operations. At B = 2^20, N = 1024, reps = 8 and K = 16
// there are 2^33 outputs and 137 GMAC: 4.10 ms at 67 TFLOP/s FP32, 0.56 ms
// at 495 TF32, 0.28 ms at 989 BF16 (K = 96: 1.67 ms), 0.14 ms at 1,979
// int8; the bytes (64 MB of F) are negligible. Beside them the fold: one
// min an output, 2^33 of them. A min is one instruction, not two of the
// 67 T operations a second that count an FFMA twice, and it runs on
// another pipe than the FFMAs: FMNMX (fminf), IMNMX (int min) and the DPX
// min of three (__vimin3_s32, one VIMNMX3, two minima an instruction) each
// issue 64 a clock an SM on cc 9.0, half the FFMA lane rate. A tensor-core
// variant's bound is the larger of its MMAs' time and the fold's at that
// peak for the fastest min of its accumulator type (FP32: FMNMX; int32:
// the min of three), at the 1.98 GHz the FP32 figure counts; the FMA
// variant's minima also take issue slots beside its FFMAs. The fold then
// takes 0.51 ms on FP32 accumulators and 0.26 ms on int32, more than the
// MMAs of BF16 and int8 at K = 16. rt_min_rate measures the three rates:
// on an H100 SXM at 700 W about 63 a clock an SM at 1,980 MHz, and ptxas
// also makes one VIMNMX3 of min(min(a, b), c).
//
// Design of the mma.sync variants: a block takes M rays (the TPU kernels'
// ray block) and walks the reps slices of G, each staged into shared memory
// in chunks of at most 256 columns, packed along K as the mma's B fragment
// wants it (rows of 2 bf16, 1 tf32 or 4 int8 values, row stride = chunk + 8
// words so the fragment loads hit 32 banks). A warp owns 64 rays (32 at K >
// 48) whose A fragments stay in registers for the whole launch; per 8
// columns it loads the B fragments once, issues one mma per 16 rays and K
// step, and folds the accumulator fragment into a running min in registers:
// no [B, N] product exists anywhere. The four lanes that share a ray reduce
// at the end. The TPU kernels' M up to 4096 has no counterpart: a block has
// at most 1024 rays here (512 at K > 48), since the rays' fragments live in
// registers. The wgmma and FP32 variants' designs stand above their kernels.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---- bf16 by bits (round to nearest even, as torch and ml_dtypes round) --

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;  // NaN stays NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return u >> 16;
}
__device__ __forceinline__ float bf16_float(uint32_t b) { return __uint_as_float(b << 16); }

// ---- the operand types of the tensor-core variants -----------------------
//
// PACK values along K make one 32-bit fragment register; a K step is
// 8 * PACK deep. `pack` reads elements k .. k + PACK - 1 of column `col` of
// a [K, cols] table (zeros beyond K).

struct Bf16 {
  using elem = uint16_t;
  using acc_t = float;
  static constexpr int PACK = 2;
  __device__ static __forceinline__ acc_t big() { return INFINITY; }
  __device__ static __forceinline__ uint32_t pack(const elem* p, size_t cols, int k, int K,
                                                  size_t col) {
    const uint32_t lo = k < K ? p[(size_t)k * cols + col] : 0u;
    const uint32_t hi = k + 1 < K ? p[(size_t)(k + 1) * cols + col] : 0u;
    return lo | (hi << 16);
  }
  __device__ static __forceinline__ void mma(acc_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static __forceinline__ acc_t lower(acc_t a, acc_t b) { return fminf(a, b); }
};

struct Tf32 {
  using elem = float;
  using acc_t = float;
  static constexpr int PACK = 1;
  __device__ static __forceinline__ acc_t big() { return INFINITY; }
  __device__ static __forceinline__ uint32_t pack(const elem* p, size_t cols, int k, int K,
                                                  size_t col) {
    uint32_t u = 0u;
    if (k < K) asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(p[(size_t)k * cols + col]));
    return u;
  }
  __device__ static __forceinline__ void mma(acc_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static __forceinline__ acc_t lower(acc_t a, acc_t b) { return fminf(a, b); }
};

struct Int8 {
  using elem = uint8_t;  // the bits of an int8
  using acc_t = int;
  static constexpr int PACK = 4;
  __device__ static __forceinline__ acc_t big() { return INT_MAX; }
  __device__ static __forceinline__ uint32_t pack(const elem* p, size_t cols, int k, int K,
                                                  size_t col) {
    uint32_t u = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (k + q < K) u |= (uint32_t)p[(size_t)(k + q) * cols + col] << (8 * q);
    return u;
  }
  __device__ static __forceinline__ void mma(acc_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static __forceinline__ acc_t lower(acc_t a, acc_t b) { return min(a, b); }
};

constexpr int MMA_THREADS = 512;  // most threads of a tensor-core block

// which of the split's parts (hi, mid, lo) K step ks of [ha ha ha ma ma la] is
__device__ __forceinline__ constexpr int split_part(int ks) { return ks < 3 ? 0 : (ks < 5 ? 1 : 2); }

// The A fragments of the 16 rays from r0, in the register layout that
// mma.sync m16n8k{8,16,32} and wgmma's register operand share: register
// h * 2 + w holds ray r0 + gid + 8 * w, K values tig * PACK + h * 4 * PACK
// onward of each K step. SPLIT (Bf16): F is [16, B] f32 and the three
// fragments are its hi, mid and lo parts.
template <class T, int KS, bool SPLIT>
__device__ __forceinline__ void load_a(uint32_t (&a)[SPLIT ? 3 : KS][4], const void* Fv, int B,
                                       int K, int r0, int gid, int tig) {
  constexpr int PACK = T::PACK;
  constexpr int KSTEP = 8 * PACK;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int r = r0 + gid + 8 * w;
      const int reg = h * 2 + w;
      if constexpr (SPLIT) {
        const float* F = static_cast<const float*>(Fv);
        const int k = tig * 2 + h * 8;
        uint32_t part[3] = {0u, 0u, 0u};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float x = r < B ? F[(size_t)(k + q) * B + r] : 0.0f;
          const uint32_t hi = bf16_bits(x);
          const float r1 = x - bf16_float(hi);
          const uint32_t mid = bf16_bits(r1);
          const uint32_t lo = bf16_bits(r1 - bf16_float(mid));
          part[0] |= hi << (16 * q);
          part[1] |= mid << (16 * q);
          part[2] |= lo << (16 * q);
        }
#pragma unroll
        for (int s = 0; s < 3; ++s) a[s][reg] = part[s];
      } else {
        const typename T::elem* F = static_cast<const typename T::elem*>(Fv);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int k = ks * KSTEP + tig * PACK + h * 4 * PACK;
          a[ks][reg] = r < B ? T::pack(F, (size_t)B, k, K, (size_t)r) : 0u;
        }
      }
    }
  }
}

// KS: K steps; MT: 16-ray tiles a warp owns. SPLIT (Bf16, KS = 6 only): F is
// [16, B] f32 and is split here.
template <class T, int KS, int MT, bool SPLIT>
__global__ void __launch_bounds__(MMA_THREADS)
mma_dot_min(const void* __restrict__ Fv, const typename T::elem* __restrict__ G,
            typename T::acc_t* __restrict__ out, int B, int K, int N, int reps, int acc_min) {
  using acc_t = typename T::acc_t;
  constexpr int PACK = T::PACK;
  constexpr int ROWS = KS * 8;                // packed rows of a staged chunk
  constexpr int NCH = ROWS <= 16 ? 256 : 128;  // columns of a staged chunk
  constexpr int S = NCH + 8;                   // row stride, words: 32 banks a fragment load
  __shared__ uint32_t sg[ROWS * S];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rays_block = (blockDim.x >> 5) * 16 * MT;
  const int ray0 = blockIdx.x * rays_block + warp * 16 * MT;

  // ---- this warp's A fragments, once
  uint32_t a[MT][SPLIT ? 3 : KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) load_a<T, KS, SPLIT>(a[mt], Fv, B, K, ray0 + mt * 16, gid, tig);

  acc_t mlo[MT], mhi[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mlo[mt] = mhi[mt] = T::big();

  const size_t cols = (size_t)N * reps;
  for (int rep = 0; rep < reps; ++rep) {
    for (int c0 = 0; c0 < N; c0 += NCH) {
      const int n = min(NCH, N - c0);
      __syncthreads();  // the previous chunk is consumed
      for (int e = threadIdx.x; e < ROWS * NCH; e += blockDim.x) {
        const int col = e % NCH, row = e / NCH;  // col fastest: coalesced reads of G
        if (col < n) sg[row * S + col] = T::pack(G, cols, row * PACK, K, (size_t)rep * N + c0 + col);
      }
      __syncthreads();
      for (int n0 = 0; n0 < n; n0 += 8) {
        uint32_t b[KS][2];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          b[ks][0] = sg[(ks * 8 + tig) * S + n0 + gid];
          b[ks][1] = sg[(ks * 8 + 4 + tig) * S + n0 + gid];
        }
        const bool first_col = c0 == 0 && n0 == 0 && tig == 0;  // column rep * N is d[0], d[2]
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc_t d[4] = {0, 0, 0, 0};
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) T::mma(d, a[mt][SPLIT ? split_part(ks) : ks], b[ks][0], b[ks][1]);
          if (acc_min) {
            mlo[mt] = T::lower(mlo[mt], T::lower(d[0], d[1]));
            mhi[mt] = T::lower(mhi[mt], T::lower(d[2], d[3]));
          } else if (first_col) {
            mlo[mt] = T::lower(mlo[mt], d[0]);
            mhi[mt] = T::lower(mhi[mt], d[2]);
          }
        }
      }
    }
  }

  // ---- the four lanes of a ray reduce; lane tig 0 writes
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    acc_t lo = mlo[mt], hi = mhi[mt];
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      lo = T::lower(lo, __shfl_xor_sync(0xffffffffu, lo, x));
      hi = T::lower(hi, __shfl_xor_sync(0xffffffffu, hi, x));
    }
    const int r = ray0 + mt * 16 + gid;
    if (tig == 0) {
      if (r < B) out[r] = lo;
      if (r + 8 < B) out[r + 8] = hi;
    }
  }
}

// ---- variants 4, 5 and 6: BF16, TF32 and int8 tensor cores through wgmma ---
//
// A warpgroup (four warps) owns 64 * MT rays, their A fragments in registers
// (wgmma's register operand has mma.sync's layout, 16 rays a warp), and
// runs one wgmma.mma_async m64n128k16 (BF16), m64n128k8 (TF32) or
// m64n128k32 (int8) per K step on a 64 x 128 tile of products, 64 FP32 (int8:
// int32) registers a thread (d[4j], d[4j+1]: ray gid; d[4j+2], d[4j+3]: ray
// gid + 8), then folds the tile into the running min.
//
// The first form (PR 6) reached 45% of the bound at K = 96: all threads of
// the block copied each chunk of G between two block barriers, and the
// tensor cores waited for the copy and for each tile's fold (wait_group 0
// after every tile). This form keeps them fed:
//  - a producer warpgroup, one lane of it, keeps a ring of stages of G in
//    flight, one 1-D bulk copy (cp.async.bulk, the TMA's raw-bytes form) a
//    stage of 128 columns (a block), each signalled on an mbarrier
//    ("full"); the consumer warps hand a stage back on another ("empty")
//    once the wgmmas that read it are complete. It gives most of its registers to the
//    consumers (setmaxnreg);
//  - two accumulator sets a consumer warpgroup: it issues the wgmmas of its
//    next tile into one set, waits for the tile before (wait_group 1) and
//    folds that one's min out of the other set, as a tree of FMNMX, while
//    the tensor cores run. Up to three K steps (BF16 K <= 48, TF32 K <= 24)
//    the fold, 2^33 FMNMX at B = 2^20, weighs as much as the MMAs: there
//    four warpgroups of one set each wait for every tile, and a stage is
//    four blocks of 128 columns;
//  - one block an SM, persistent over the ray tiles, so that the ring runs
//    on from one tile to the next;
//  - a first launch (pack_g) writes G as a stage is read: K-major, each
//    column's KS * 32 bytes cut into swizzled regions of 128, 64 and 32
//    bytes from the front (BF16 K = 96: 128 + 64; K = 16: 32; TF32 K = 32:
//    128; int8 K = 16 or 32: 32, the region of BF16 K = 16, so the same
//    descriptors read it), the 16-byte chunks of a region's rows permuted
//    as the descriptor's swizzle mode reads them, so the bulk copy moves
//    the bytes as they are.
// Variant 6 runs this pipeline as BF16 K = 16 does (one K step: one set,
// four warpgroups), its fold a tree of VIMNMX3. At K = 16 it takes about
// twice its bound: without the fold the same launch takes 0.33 ms, with it
// 0.53, so the fold's 0.26 ms hardly overlaps the MMAs. Neither a second
// accumulator set (two warpgroups of two sets: slower) nor half tiles of 64
// columns, one folded while the other runs (ptxas C7514 serializes those
// wgmmas: no faster), changed that.
// The work per output is the first form's: the same K steps in the same
// order on the same fragments, so the outputs are the same bits (int8:
// integer sums, so variant 6 equals variant 3 whatever the order). What
// kept the compiler from serializing the wgmmas (ptxas C7512, C7518): the
// warp index made warp-uniform by a shuffle, the mbarrier wait loop inside
// one asm statement, and every register array indexed by constants.

constexpr int WG_COLS = 128;              // columns of a tile and of a block of G
constexpr int WG_RING_BYTES = 96 * 1024;  // shared memory of the ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The swizzled regions of a column's kb bytes: widths 128, 64, 32 from the front.
__host__ __device__ constexpr int region_width(int kb, int at) {
  return kb - at >= 128 ? 128 : kb - at >= 64 ? 64 : 32;
}
__host__ __device__ constexpr int region_start(int kb, int byte) {
  int at = 0;
  while (at + region_width(kb, at) <= byte) at += region_width(kb, at);
  return at;
}
// Offset in a block of WG_COLS columns of byte `byte` of column c: a region
// of width w holds its WG_COLS rows of w bytes, 16-byte chunk x of row c at
// x ^ (c's row bits), the swizzle of w bytes on a 1024-aligned block.
__host__ __device__ constexpr uint32_t block_offset(int kb, int c, int byte) {
  const int at = region_start(kb, byte), w = region_width(kb, at);
  const uint32_t off = (uint32_t)(WG_COLS * at + c * w + (byte - at));
  return off ^ (((off >> 7) & (uint32_t)(w / 16 - 1)) << 4);
}
__host__ __device__ constexpr int wg_ring(int stage_bytes) {
  return WG_RING_BYTES / stage_bytes > 8 ? 8 : WG_RING_BYTES / stage_bytes < 2 ? 2
                                                : WG_RING_BYTES / stage_bytes;
}

// The descriptor of K step ks (32 bytes of each column) of the block at shared
// address sb: K-major, leading offset unused (1), stride 8 rows of the region.
template <int KB>
__device__ __forceinline__ uint64_t block_desc(uint32_t sb, int ks) {
  const int at = region_start(KB, ks * 32), w = region_width(KB, at);
  const uint32_t addr = sb + WG_COLS * at + (ks * 32 - at);
  const uint64_t mode = w == 128 ? 1 : w == 64 ? 2 : 3;  // swizzle of 128, 64, 32 bytes
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((uint64_t)((8 * w) >> 4) << 32) | (mode << 62);
}

#define WG_D64                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "      \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "     \
  "{%64, %65, %66, %67}, %68, p"
// the 64 accumulators as asm operands of constraint C ("+f" FP32, "+r" int32)
#define WG_OUT64(C)                                                                       \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]), C(d[8]),        \
  C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), C(d[15]), C(d[16]),          \
  C(d[17]), C(d[18]), C(d[19]), C(d[20]), C(d[21]), C(d[22]), C(d[23]), C(d[24]),         \
  C(d[25]), C(d[26]), C(d[27]), C(d[28]), C(d[29]), C(d[30]), C(d[31]), C(d[32]),         \
  C(d[33]), C(d[34]), C(d[35]), C(d[36]), C(d[37]), C(d[38]), C(d[39]), C(d[40]),         \
  C(d[41]), C(d[42]), C(d[43]), C(d[44]), C(d[45]), C(d[46]), C(d[47]), C(d[48]),         \
  C(d[49]), C(d[50]), C(d[51]), C(d[52]), C(d[53]), C(d[54]), C(d[55]), C(d[56]),         \
  C(d[57]), C(d[58]), C(d[59]), C(d[60]), C(d[61]), C(d[62]), C(d[63])

// d (+)= A (registers) x B (shared memory, K-major); scale_d 0 overwrites d.
// One K step: m64n128k16 for BF16, m64n128k8 for TF32, m64n128k32 for int8
// (TF32 and int8 have no transpose argument, and int8 no scale of A or B:
// their operands are K-major only).
template <class T>
__device__ __forceinline__ void wgmma_step(typename T::acc_t (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  if constexpr (T::PACK == 2) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64 ", 1, 1, 0;\n}\n"
                 : WG_OUT64("+f")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
                 : "memory");
  } else if constexpr (T::PACK == 1) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_D64 ", 1, 1;\n}\n"
                 : WG_OUT64("+f")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
                 : "memory");
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WG_D64 ";\n}\n"
                 : WG_OUT64("+r")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
                 : "memory");
  }
}

// Orders a register's reads and writes against the asynchronous wgmmas
// around it (the compiler sees the wgmma write its accumulators at issue).
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(int& r) { asm volatile("" : "+r"(r)::"memory"); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
// Wait for the phase of `parity` to complete: one asm loop, which the
// compiler sees as straight-line code (a loop of its own would put the
// wgmmas after it on a divergent path and serialize them). A ring that
// stays empty for 2^35 clocks (over 15 s) is a fault: trap, so that the
// launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.lt.u64 p, t1, %2;\n"
      "@p bra LAB_WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity), "l"(1ull << 35)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// The tile of 64 * 128 products of one m-tile and the block at sb: every K
// step, committed as one group.
template <class T, int KS, bool SPLIT>
__device__ __forceinline__ void wg_issue(typename T::acc_t (&d)[64],
                                         const uint32_t (&a)[SPLIT ? 3 : KS][4], uint32_t sb) {
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_reg(d[i]);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_step<T>(d, a[SPLIT ? split_part(ks) : ks], block_desc<KS * 32>(sb, ks), ks > 0);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The tile's min into lo (ray gid) and hi (ray gid + 8): a tree of FMNMX, so
// that the 64 of a thread do not wait on each other (a min is exact: any
// order gives the same bits).
__device__ __forceinline__ void wg_fold(float (&d)[64], float& lo, float& hi) {
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_reg(d[i]);
  float x[16], y[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    x[j] = fminf(d[4 * j], d[4 * j + 1]);
    y[j] = fminf(d[4 * j + 2], d[4 * j + 3]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = fminf(x[j], x[j + 8]), y[j] = fminf(y[j], y[j + 8]);
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = fminf(x[j], x[j + 4]), y[j] = fminf(y[j], y[j + 4]);
#pragma unroll
  for (int j = 0; j < 2; ++j) x[j] = fminf(x[j], x[j + 2]), y[j] = fminf(y[j], y[j + 2]);
  lo = fminf(lo, fminf(x[0], x[1]));
  hi = fminf(hi, fminf(y[0], y[1]));
}

// The same for int32 accumulators, as a tree of the DPX min of three
// (__vimin3_s32): a row half's 32 values and its running min, 33 values,
// in 16 instructions where pairs take 32. The fold is exact, so the order
// does not matter.
__device__ __forceinline__ void wg_fold(int (&d)[64], int& lo, int& hi) {
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_reg(d[i]);
  // value q of a row half: d[at(q)] (ray gid), d[at(q) + 2] (ray gid + 8)
  auto at = [](int q) { return 4 * (q / 2) + q % 2; };
  int x[11], y[11];
#pragma unroll
  for (int j = 0; j < 10; ++j) {
    x[j] = __vimin3_s32(d[at(3 * j)], d[at(3 * j + 1)], d[at(3 * j + 2)]);
    y[j] = __vimin3_s32(d[at(3 * j) + 2], d[at(3 * j + 1) + 2], d[at(3 * j + 2) + 2]);
  }
  x[10] = __vimin3_s32(d[60], d[61], lo);  // values 30, 31 and the running min
  y[10] = __vimin3_s32(d[62], d[63], hi);
#pragma unroll
  for (int j = 0; j < 3; ++j) {  // 11 -> 5: x[0..2], x[9], x[10]
    x[j] = __vimin3_s32(x[3 * j], x[3 * j + 1], x[3 * j + 2]);
    y[j] = __vimin3_s32(y[3 * j], y[3 * j + 1], y[3 * j + 2]);
  }
  x[0] = __vimin3_s32(x[0], x[1], x[2]);  // 5 -> 3
  y[0] = __vimin3_s32(y[0], y[1], y[2]);
  lo = __vimin3_s32(x[0], x[9], x[10]);  // 3 -> 1
  hi = __vimin3_s32(y[0], y[9], y[10]);
}

// G [K, cols] -> gp, the blocks of WG_COLS columns in order, each as
// block_offset lays it out (zeros beyond K); one thread a (column, 32-bit
// word of K values).
template <class T, int KS>
__global__ void pack_g(const typename T::elem* __restrict__ G, uint32_t* __restrict__ gp, int K,
                       size_t cols) {
  constexpr int KB = KS * 32;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= cols * (KB / 4)) return;
  const size_t col = e % cols;  // col fastest: coalesced reads of G
  const int w = (int)(e / cols);
  const size_t at = col / WG_COLS * (WG_COLS * KB) + block_offset(KB, (int)(col % WG_COLS), w * 4);
  gp[at >> 2] = T::pack(G, cols, w * T::PACK, K, col);
}

// The registers a producer thread keeps (setmaxnreg's least), and those a
// consumer thread may then take: the block holds what the launch bound gives
// every thread (65536 over the threads, in steps of 8), and an increase
// beyond what the producer hands back would wait forever. Two consumer
// warpgroups: 240; four: 112.
constexpr int WG_PRODUCER_REGS = 24;
__host__ __device__ constexpr int wg_consumer_regs(int wgs) {
  return ((65536 / (wgs * 128 + 128)) / 8 * 8 * (wgs * 128 + 128) - WG_PRODUCER_REGS * 128) /
         (wgs * 128) / 8 * 8;
}

// WGS consumer warpgroups (warps 0 .. 4 WGS - 1) of MT m-tiles each, then the
// producer warpgroup, whose first lane issues the copies. One block an SM,
// persistent: it takes the ray tiles blockIdx.x, + gridDim.x, ... of
// WGS * 64 * MT rays, and the ring runs on from one tile's stages to the
// next's, so a tile's first stages are in flight while the one before ends.
// NACC accumulator sets of 64 registers a thread: with two, a warpgroup
// folds one 64 x 128 tile while the next runs; with one (up to three K
// steps, where the fold weighs as much as the MMAs) it waits for each, four
// warpgroups keep the tensor cores busy between them, and a stage holds
// four blocks of 128 columns, so that the barriers come four times as
// rarely. The producer hands registers to the consumers (setmaxnreg).
template <class T, int KS, int MT, int WGS, int NACC, bool SPLIT>
__global__ void __launch_bounds__(WGS * 128 + 128, 1)
wgmma_dot_min(const void* __restrict__ Fv, const uint8_t* __restrict__ gp,
              typename T::acc_t* __restrict__ out, int B, int K, int n_blocks) {
  using acc_t = typename T::acc_t;
  static_assert(NACC == 1 || MT % 2 == 0, "tiles alternate between the two accumulator sets");
  constexpr int BLOCK = WG_COLS * KS * 32, SB = NACC == 1 ? 4 : 1;  // bytes, blocks of a stage
  constexpr int STAGE = SB * BLOCK, RING = wg_ring(STAGE), M = WGS * 64 * MT;
  const int n_stages = (n_blocks + SB - 1) / SB;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * RING];  // full[s] = bars[s], empty[s] = bars[RING + s]
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  const uint32_t full = smem_u32(bars), empty = full + 8 * RING;
  const int n_tiles = (B + M - 1) / M;
  // the warp index through a shuffle: warp-uniform to the compiler, so that the
  // roles below are no divergent paths to it (wgmma and setmaxnreg need that)
  const int lane = threadIdx.x & 31, warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WGS * 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= WGS * 4) {  // the producer: one lane keeps the ring in flight
    if constexpr (WGS > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(WG_PRODUCER_REGS));
    if (warp == WGS * 4 && lane == 0) {
      int g = 0;  // stages through the ring so far
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int q = 0; q < n_stages; ++q, ++g) {
          const int s = g % RING;
          const uint32_t bytes = (uint32_t)(min(SB, n_blocks - q * SB) * BLOCK);
          if (g >= RING) mbar_wait(empty + 8 * s, (g / RING - 1) & 1);
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(full + 8 * s),
                       "r"(bytes)
                       : "memory");
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
              "[%3];" ::"r"(ring + s * STAGE),
              "l"(gp + (size_t)q * STAGE), "r"(bytes), "r"(full + 8 * s)
              : "memory");
        }
      }
    }
    return;
  }

  static_assert(wg_consumer_regs(2) == 240 && wg_consumer_regs(4) == 112, "");
  if constexpr (WGS > 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(wg_consumer_regs(WGS)));
  const int gid = lane >> 2, tig = lane & 3;
  int g = 0;  // stages through the ring so far
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, g += n_stages) {
    // this warp's 16 rays of its warpgroup's m-tile mt start at ray0 + mt * 64
    const int ray0 = tile * M + (warp >> 2) * 64 * MT + (warp & 3) * 16;
    uint32_t a[MT][SPLIT ? 3 : KS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      load_a<T, KS, SPLIT>(a[mt], Fv, B, K, ray0 + mt * 64, gid, tig);
    acc_t mlo[MT], mhi[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mlo[mt] = mhi[mt] = T::big();
    acc_t acc[NACC][64];

    if constexpr (NACC == 1) {
      for (int q = 0; q < n_stages; ++q) {
        const int s = (g + q) % RING, nb = min(SB, n_blocks - q * SB);
        mbar_wait(full + 8 * s, ((g + q) / RING) & 1);
        for (int b = 0; b < nb; ++b) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            wg_issue<T, KS, SPLIT>(acc[0], a[mt], ring + s * STAGE + b * BLOCK);
            wg_wait<0>();
            if (b == nb - 1 && mt == MT - 1 && lane == 0) mbar_arrive(empty + 8 * s);  // read
            wg_fold(acc[0], mlo[mt], mhi[mt]);
          }
        }
      }
    } else {
      mbar_wait(full + 8 * (g % RING), (g / RING) & 1);
      wg_issue<T, KS, SPLIT>(acc[0], a[0], ring + (g % RING) * STAGE);
      for (int q = 0; q < n_stages; ++q) {
        const int s = (g + q) % RING;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // issue the next tile, then wait for this one (tile mt, set mt & 1)
          if (mt + 1 < MT) {
            wg_issue<T, KS, SPLIT>(acc[(mt + 1) % NACC], a[(mt + 1) % MT], ring + s * STAGE);
            wg_wait<1>();
          } else if (q + 1 < n_stages) {
            const int s1 = (g + q + 1) % RING;
            mbar_wait(full + 8 * s1, ((g + q + 1) / RING) & 1);
            wg_issue<T, KS, SPLIT>(acc[0], a[0], ring + s1 * STAGE);
            wg_wait<1>();
          } else {
            wg_wait<0>();
          }
          if (mt == MT - 1 && lane == 0) mbar_arrive(empty + 8 * s);  // the stage is read
          wg_fold(acc[mt % NACC], mlo[mt], mhi[mt]);
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      acc_t lo = mlo[mt], hi = mhi[mt];
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        lo = T::lower(lo, __shfl_xor_sync(0xffffffffu, lo, x));
        hi = T::lower(hi, __shfl_xor_sync(0xffffffffu, hi, x));
      }
      const int r = ray0 + mt * 64 + gid;
      if (tig == 0) {
        if (r < B) out[r] = lo;
        if (r + 8 < B) out[r + 8] = hi;
      }
    }
  }
}

// ---- variant 0: FP32 FMAs, R rays a thread ---------------------------------
//
// The first form (PR 6) reached 44% of the FP32 bound: a thread owned one
// ray, so each broadcast float4 of G read from shared memory fed 4 FMAs (16
// LDS.128 to 64 FFMA at K = 16), and the block copied each chunk of G, with
// a division per element, between two barriers with nothing to compute
// meanwhile. Here a thread owns R rays (FMA_RAYS, fewer where the block's
// rays do not divide into whole warps of R), so a float4 read once feeds 4 R
// FMAs, and the next chunk is copied with cp.async (16 bytes a copy) into
// the other half of a double buffer while this one is computed. Each ray's
// dot keeps the first form's order (an FMUL of k = 0, then fmaf k = 1 ..
// K - 1) and its min the same columns, so the outputs are the same bits.

constexpr int FMA_RAYS = 4;
constexpr int FMA_CHUNK = 4096;  // floats of a chunk: K rows of 4096 / K columns

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int K, int R>
__global__ void __launch_bounds__(1024 / R)
fma_dot_min(const float* __restrict__ F, const float* __restrict__ G, float* __restrict__ out,
            int B, int N, int reps, int acc_min) {
  constexpr int NCH = FMA_CHUNK / K, NCH4 = NCH / 4;  // columns of a chunk, in float4
  __shared__ __align__(16) float4 sg[2][K * NCH4];     // [buffer][k][column]
  const int nt = blockDim.x;
  const int ray0 = blockIdx.x * nt * R + threadIdx.x;  // ray r: ray0 + r * nt
  float f[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int ray = ray0 + r * nt;
#pragma unroll
    for (int k = 0; k < K; ++k) f[r][k] = ray < B ? F[(size_t)k * B + ray] : 0.0f;
  }
  float best[R];
#pragma unroll
  for (int r = 0; r < R; ++r) best[r] = INFINITY;

  const size_t cols = (size_t)N * reps;
  const int per_rep = (N + NCH - 1) / NCH, n_chunks = reps * per_rep;
  auto copy = [&](int i) {  // chunk i into buffer i & 1
    const int c0 = i % per_rep * NCH, n4 = min(NCH, N - c0) / 4;
    const float* src = G + (size_t)(i / per_rep) * N + c0;
    for (int e = threadIdx.x; e < K * NCH4; e += nt) {
      const int k = e / NCH4, p = e % NCH4;
      if (p < n4) cp_async16(&sg[i & 1][e], src + (size_t)k * cols + 4 * p);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  copy(0);
  for (int i = 0; i < n_chunks; ++i) {
    if (i + 1 < n_chunks) {
      copy(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk i has landed for every thread
    const int c0 = i % per_rep * NCH, n4 = min(NCH, N - c0) / 4;
    const float4* sgi = sg[i & 1];
    for (int q = 0; q < n4; ++q) {
      float4 acc[R];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float4 g = sgi[k * NCH4 + q];  // the same address for the whole warp
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (k == 0) {
            acc[r].x = f[r][0] * g.x, acc[r].y = f[r][0] * g.y;
            acc[r].z = f[r][0] * g.z, acc[r].w = f[r][0] * g.w;
          } else {
            acc[r].x = fmaf(f[r][k], g.x, acc[r].x), acc[r].y = fmaf(f[r][k], g.y, acc[r].y);
            acc[r].z = fmaf(f[r][k], g.z, acc[r].z), acc[r].w = fmaf(f[r][k], g.w, acc[r].w);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (acc_min) {
          best[r] = fminf(best[r], fminf(fminf(acc[r].x, acc[r].y), fminf(acc[r].z, acc[r].w)));
        } else {
          // the dots are done all the same: the compiler may not drop them
          asm volatile("" ::"f"(acc[r].x), "f"(acc[r].y), "f"(acc[r].z), "f"(acc[r].w));
          if (c0 == 0 && q == 0) best[r] = fminf(best[r], acc[r].x);
        }
      }
    }
    __syncthreads();  // chunk i is consumed before chunk i + 2 lands there
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (ray0 + r * nt < B) out[ray0 + r * nt] = best[r];
}

template <class T, int KS, int MT, bool SPLIT>
int launch_mma(const void* F, const void* G, void* out, int B, int K, int N, int reps, int M,
               int acc_min, cudaStream_t stream) {
  const int rays_warp = 16 * MT;
  if (M % rays_warp || M / rays_warp * 32 > MMA_THREADS) return (int)cudaErrorInvalidValue;
  mma_dot_min<T, KS, MT, SPLIT><<<(B + M - 1) / M, M / rays_warp * 32, 0, stream>>>(
      F, static_cast<const typename T::elem*>(G), static_cast<typename T::acc_t*>(out), B, K, N,
      reps, acc_min);
  return (int)cudaGetLastError();
}

template <class T, int KS, int MT, int WGS, int NACC, bool SPLIT>
int launch_wgmma_blocks(const void* F, const void* gp, void* out, int B, int K, size_t cols,
                        cudaStream_t stream) {
  constexpr int STAGE = WG_COLS * KS * 32 * (NACC == 1 ? 4 : 1);  // as the kernel's
  constexpr int SMEM = wg_ring(STAGE) * STAGE + 1024;  // + the swizzle's alignment
  auto kernel = wgmma_dot_min<T, KS, MT, WGS, NACC, SPLIT>;
  const int rc =
      (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaGetLastError();
  const int M = WGS * 64 * MT, tiles = (B + M - 1) / M;
  kernel<<<tiles < sms ? tiles : sms, WGS * 128 + 128, SMEM, stream>>>(
      F, static_cast<const uint8_t*>(gp), static_cast<typename T::acc_t*>(out), B, K,
      (int)(cols / WG_COLS));
  return (int)cudaGetLastError();
}

// scratch: N * reps * KS * 32 bytes for G in the ring's order. M rays a block:
// two warpgroups of MT_MAX m-tiles (the most), or of MT_MAX / 2 (MT_MAX 4) or
// one warpgroup of 2 (MT_MAX 2); up to three K steps four warpgroups of one
// set and of MT_MAX / 2 or MT_MAX / 4 m-tiles.
template <class T, int KS, bool SPLIT>
int launch_wgmma(const void* F, const void* G, void* out, void* scratch, int B, int K, int N,
                 int reps, int M, cudaStream_t stream) {
  constexpr int MT_MAX = (SPLIT || KS <= 3) ? 4 : 2;  // A fragments and two accumulator sets
  if ((M != 128 * MT_MAX && M != 64 * MT_MAX) || N % WG_COLS || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t cols = (size_t)N * reps, words = cols * KS * 8;
  pack_g<T, KS><<<(unsigned)((words + 255) / 256), 256, 0, stream>>>(
      static_cast<const typename T::elem*>(G), static_cast<uint32_t*>(scratch), K, cols);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  if constexpr (KS <= 3) {  // the fold weighs as much as the MMAs: one set, four warpgroups
    if (M == 512)
      return launch_wgmma_blocks<T, KS, 2, 4, 1, SPLIT>(F, scratch, out, B, K, cols, stream);
    return launch_wgmma_blocks<T, KS, 1, 4, 1, SPLIT>(F, scratch, out, B, K, cols, stream);
  } else {
    if (M == 128 * MT_MAX)
      return launch_wgmma_blocks<T, KS, MT_MAX, 2, 2, SPLIT>(F, scratch, out, B, K, cols, stream);
    if constexpr (MT_MAX == 4)
      return launch_wgmma_blocks<T, KS, 2, 2, 2, SPLIT>(F, scratch, out, B, K, cols, stream);
    else
      return launch_wgmma_blocks<T, KS, 2, 1, 2, SPLIT>(F, scratch, out, B, K, cols, stream);
  }
}

template <int K, int R>
int launch_fma_rays(const void* F, const void* G, void* out, int B, int N, int reps, int M,
                    int acc_min, cudaStream_t stream) {
  fma_dot_min<K, R><<<(B + M - 1) / M, M / R, 0, stream>>>(
      static_cast<const float*>(F), static_cast<const float*>(G), static_cast<float*>(out), B, N,
      reps, acc_min);
  return (int)cudaGetLastError();
}

template <int K>
int launch_fma(const void* F, const void* G, void* out, int B, int N, int reps, int M,
               int acc_min, cudaStream_t stream) {
  // cp.async copies 16 aligned bytes: G's rows start on them (N * reps % 8 == 0)
  if (M % 32 || M > 1024 || reinterpret_cast<uintptr_t>(G) % 16) return (int)cudaErrorInvalidValue;
  if constexpr (FMA_RAYS >= 4)
    if (M % 128 == 0) return launch_fma_rays<K, 4>(F, G, out, B, N, reps, M, acc_min, stream);
  if constexpr (FMA_RAYS >= 2)
    if (M % 64 == 0) return launch_fma_rays<K, 2>(F, G, out, B, N, reps, M, acc_min, stream);
  return launch_fma_rays<K, 1>(F, G, out, B, N, reps, M, acc_min, stream);
}

// ---- the fold's instructions: how many minima a second the card takes -------
//
// Each thread keeps MR_CHAINS values in registers and, a step at a time,
// replaces value c by the min of values c and c + 1 (op 0: fminf, FMNMX;
// op 1: int min, IMNMX) or of values c, c + 1 and c + 2 (op 2:
// __vimin3_s32), indices mod MR_CHAINS: MR_CHAINS independent mins a step,
// each step's inputs the step before's outputs, so that the compiler can
// neither drop nor merge one (every value is a new min of distinct ones) and
// enough are in flight to cover the pipe's latency. Block 0's thread 0
// writes the clocks and nanoseconds (%globaltimer) its loop took, from which
// the caller reads the SM clock of the run.
constexpr int MR_CHAINS = 16, MR_UNROLL = 4, MR_THREADS = 1024;

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int OP>
__global__ void __launch_bounds__(MR_THREADS)
min_rate(int* __restrict__ out, long long* __restrict__ clk, int iters) {
  using V = typename std::conditional<OP == 0, float, int>::type;
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  V x[MR_CHAINS];
#pragma unroll
  for (int c = 0; c < MR_CHAINS; ++c)  // distinct values below 2^23 in magnitude
    x[c] = (V)((int)(((t * MR_CHAINS + c) * 2654435761u) >> 9) - (1 << 21));
  const long long c0 = clock64();
  const uint64_t n0 = global_ns();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < MR_UNROLL; ++u) {
      V y[MR_CHAINS];
#pragma unroll
      for (int c = 0; c < MR_CHAINS; ++c) {
        const V a = x[c], b = x[(c + 1) % MR_CHAINS];
        if constexpr (OP == 0) y[c] = fminf(a, b);
        else if constexpr (OP == 1) y[c] = min(a, b);
        else y[c] = __vimin3_s32(a, b, x[(c + 2) % MR_CHAINS]);
      }
#pragma unroll
      for (int c = 0; c < MR_CHAINS; ++c) x[c] = y[c];
    }
  }
  const long long c1 = clock64();
  const uint64_t n1 = global_ns();
  int h = 0;
#pragma unroll
  for (int c = 0; c < MR_CHAINS; ++c) {
    if constexpr (OP == 0) h ^= __float_as_int(x[c]);
    else h ^= x[c];
  }
  out[t] = h;
  if (t == 0) clk[0] = c1 - c0, clk[1] = (long long)(n1 - n0);
}

}  // namespace

// The fold's instruction rate: op 0 fminf (FMNMX), 1 int min (IMNMX), 2
// __vimin3_s32; `blocks` blocks of MR_THREADS threads each run `iters` x
// MR_UNROLL x MR_CHAINS of them; out [blocks * MR_THREADS] int32 (a digest,
// so that nothing is dropped), clk [2] int64: block 0's clocks and
// nanoseconds.
extern "C" int rt_min_rate(void* out, void* clk, int op, int iters, int blocks, void* stream) {
  if (op < 0 || op > 2 || iters < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int* o = static_cast<int*>(out);
  long long* c = static_cast<long long*>(clk);
  if (op == 0) min_rate<0><<<blocks, MR_THREADS, 0, s>>>(o, c, iters);
  if (op == 1) min_rate<1><<<blocks, MR_THREADS, 0, s>>>(o, c, iters);
  if (op == 2) min_rate<2><<<blocks, MR_THREADS, 0, s>>>(o, c, iters);
  return (int)cudaGetLastError();
}

// F [K, B], G [K, N * reps], out [B]; N a multiple of 8; M rays a block;
// variant as above. FP32: K 8, 16 or 32, M a multiple of 32 up to 1024.
// mma.sync: M a multiple of 64 up to 1024 (K <= 48; TF32 K <= 16) or of 32
// up to 512. wgmma (acc_min only): BF16 K 16 to 128, TF32 K 8, 16 or 32,
// int8 K 16 or 32 (one K step); M 256 or 512 up to three K steps (BF16 K <=
// 48, TF32 K <= 16, int8), else 128 or 256; N a multiple of 128; scratch of
// N * reps * 32 bytes a K step (null for the other variants).
extern "C" int rt_dot_min(const void* F, const void* G, void* out, void* scratch, int B, int K,
                          int N, int reps, int M, int acc_min, int variant, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || N < 1 || N % 8 || reps < 1) return (int)cudaErrorInvalidValue;
#define MMA(T, KS, MT) return launch_mma<T, KS, MT, false>(F, G, out, B, K, N, reps, M, acc_min, s)
#define WGMMA(T, KS) return launch_wgmma<T, KS, false>(F, G, out, scratch, B, K, N, reps, M, s)
  if (variant == 0) {
    if (K == 8) return launch_fma<8>(F, G, out, B, N, reps, M, acc_min, s);
    if (K == 16) return launch_fma<16>(F, G, out, B, N, reps, M, acc_min, s);
    if (K == 32) return launch_fma<32>(F, G, out, B, N, reps, M, acc_min, s);
    return (int)cudaErrorInvalidValue;
  }
  if (variant == 1) {
    if (K == 8) MMA(Tf32, 1, 4);
    if (K == 16) MMA(Tf32, 2, 4);
    if (K == 32) MMA(Tf32, 4, 2);
  } else if (variant == 2) {
    if (K == 8 || K == 16) MMA(Bf16, 1, 4);
    if (K == 32) MMA(Bf16, 2, 4);
    if (K == 48) MMA(Bf16, 3, 4);
    if (K == 64) MMA(Bf16, 4, 2);
    if (K == 96) MMA(Bf16, 6, 2);
    if (K == 128) MMA(Bf16, 8, 2);
  } else if (variant == 3) {
    if (K == 16 || K == 32) MMA(Int8, 1, 4);
  } else if (variant == 4 && acc_min) {
    if (K == 16) WGMMA(Bf16, 1);
    if (K == 32) WGMMA(Bf16, 2);
    if (K == 48) WGMMA(Bf16, 3);
    if (K == 64) WGMMA(Bf16, 4);
    if (K == 96) WGMMA(Bf16, 6);
    if (K == 128) WGMMA(Bf16, 8);
  } else if (variant == 5 && acc_min) {
    if (K == 8) WGMMA(Tf32, 1);
    if (K == 16) WGMMA(Tf32, 2);
    if (K == 32) WGMMA(Tf32, 4);
  } else if (variant == 6 && acc_min) {
    if (K == 16 || K == 32) WGMMA(Int8, 1);
  }
#undef WGMMA
#undef MMA
  return (int)cudaErrorInvalidValue;
}

// F [16, B] f32, split in the kernel; G [96, N * reps] bf16, already split
// (cat6_g); out [B] f32. wgmma 0: mma.sync, M a multiple of 64 up to 1024;
// 1: wgmma, M 256 or 512, N a multiple of 128, scratch of N * reps * 192 bytes.
extern "C" int rt_dot_min_split(const void* F, const void* G, void* out, void* scratch, int B,
                                int N, int reps, int M, int wgmma, void* stream) {
  if (B < 1 || N < 1 || reps < 1 || N % 8) return (int)cudaErrorInvalidValue;
  if (wgmma)
    return launch_wgmma<Bf16, 6, true>(F, G, out, scratch, B, 96, N, reps, M,
                                       (cudaStream_t)stream);
  return launch_mma<Bf16, 6, 4, true>(F, G, out, B, 96, N, reps, M, 1, (cudaStream_t)stream);
}
