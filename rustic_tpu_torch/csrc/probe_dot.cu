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
//   variant 0  FP32 FMAs, one thread a ray, G staged in shared memory and
//              read as broadcast float4: what kernels K1-K17 do;
//   variant 1  TF32 tensor cores, mma.sync m16n8k8, FP32 accumulate;
//   variant 2  BF16 tensor cores, mma.sync m16n8k16, FP32 accumulate
//              (K = 8 is padded with zeros to 16);
//   variant 3  int8 tensor cores, mma.sync m16n8k32, int32 accumulate
//              (K = 16 is padded with zeros to 32), out int32;
//   variant 4  BF16 tensor cores, wgmma.mma_async m64n128k16 (the warpgroup
//              instruction, Hopper's way to the full tensor-core rate), FP32
//              accumulate, the rays' operand in registers, G's in shared
//              memory; acc_min only.
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
// int8; the bytes (64 MB of F) are negligible.
//
// Design: a block takes M rays (the TPU kernels' ray block) and walks the
// reps slices of G, each staged into shared memory in chunks of at most 256
// columns, packed along K as the mma's B fragment wants it (rows of 2 bf16,
// 1 tf32 or 4 int8 values, row stride = chunk + 8 words so the fragment
// loads hit 32 banks). A warp owns 64 rays (32 at K > 48) whose A fragments
// stay in registers for the whole launch; per 8 columns it loads the B
// fragments once, issues one mma per 16 rays and K step, and folds the
// accumulator fragment into a running min in registers: no [B, N] product
// exists anywhere. The four lanes that share a ray reduce at the end. The
// TPU kernels' M up to 4096 has no counterpart: a block has at most 1024
// rays here (512 at K > 48), since the rays' fragments live in registers.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

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

// ---- variant 4: BF16 tensor cores through wgmma ---------------------------
//
// A warpgroup (four warps) owns 64 * MT rays, their A fragments in registers
// (wgmma's register operand has mma.sync's layout, 16 rays a warp). G is
// read K-major without swizzle, as wgmma's shared-memory operand wants it:
// core matrices of 8 columns x 8 K values (128 contiguous bytes, a column's
// 8 values together), the two (or more) along K 128 bytes apart (the
// descriptor's leading byte offset), 8-column groups KS * 256 bytes apart
// (its stride byte offset). A first launch (pack_g) writes the whole of G
// in that order to a scratch buffer, so that a block stages a chunk of
// columns as one contiguous copy of 16 bytes a thread instead of packing
// it again for every 64 * MT rays. One wgmma.mma_async m64n128k16 per K
// step accumulates a 64 x 128 block of products in 64 registers a thread;
// after the group is waited for, the min runs over them as in the mma.sync
// kernel (d[4j], d[4j+1]: ray gid; d[4j+2], d[4j+3]: ray gid + 8).

constexpr int WG_THREADS = 256;  // most threads of a wgmma block: two warpgroups

__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32);  // layout type 0: no swizzle
}

// d (+)= A (registers) x B (shared memory, K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// G [K, cols] -> gp: per 8 columns, KB = 2 * KS core matrices of 128 bytes
// (zeros beyond K); one thread a (column, pair of K values)
__global__ void pack_g(const uint16_t* __restrict__ G, uint32_t* __restrict__ gp, int K, int KB,
                       size_t cols) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= cols * KB * 4) return;
  const size_t col = e % cols;  // col fastest: coalesced reads of G
  const int k = (int)(e / cols) * 2;
  gp[(((col >> 3) * KB + (k >> 3)) * 128 + (col & 7) * 16 + (k & 7) * 2) >> 2] =
      Bf16::pack(G, cols, k, K, col);
}

template <int KS, int MT, bool SPLIT>
__global__ void __launch_bounds__(WG_THREADS)
wgmma_dot_min(const void* __restrict__ Fv, const uint4* __restrict__ gp,
              float* __restrict__ out, int B, int K, int N, int reps) {
  constexpr int KB = KS * 2;                // core matrices along K
  constexpr int NCH = KS <= 2 ? 512 : 128;  // columns of a staged chunk
  __shared__ __align__(128) uint4 sg[NCH * KS * 2];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rays_block = (blockDim.x >> 7) * 64 * MT;
  // this warp's 16 rays of its warpgroup's m-tile mt start at ray0 + mt * 64
  const int ray0 = blockIdx.x * rays_block + (warp >> 2) * 64 * MT + (warp & 3) * 16;

  uint32_t a[MT][SPLIT ? 3 : KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    load_a<Bf16, KS, SPLIT>(a[mt], Fv, B, K, ray0 + mt * 64, gid, tig);

  float mlo[MT], mhi[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mlo[mt] = mhi[mt] = INFINITY;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;

  for (int rep = 0; rep < reps; ++rep) {
    for (int c0 = 0; c0 < N; c0 += NCH) {
      const int n = min(NCH, N - c0);
      __syncthreads();  // the previous chunk is consumed
      // 8 columns are KB * 8 uint4; the chunk is contiguous in gp
      const uint4* src = gp + (((size_t)rep * N + c0) >> 3) * KB * 8;
      for (int e = threadIdx.x; e < (n >> 3) * KB * 8; e += blockDim.x) sg[e] = src[e];
      // the stores above are read through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      for (int n0 = 0; n0 < n; n0 += 128) {
        const uint64_t desc = smem_desc(sg + (n0 >> 3) * KB * 8, 128, KB * 128);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            wgmma_m64n128k16(d, a[mt][SPLIT ? split_part(ks) : ks], desc + ks * 16, ks > 0);
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            mlo[mt] = fminf(mlo[mt], fminf(d[4 * j], d[4 * j + 1]));
            mhi[mt] = fminf(mhi[mt], fminf(d[4 * j + 2], d[4 * j + 3]));
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float lo = mlo[mt], hi = mhi[mt];
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, x));
      hi = fminf(hi, __shfl_xor_sync(0xffffffffu, hi, x));
    }
    const int r = ray0 + mt * 64 + gid;
    if (tig == 0) {
      if (r < B) out[r] = lo;
      if (r + 8 < B) out[r + 8] = hi;
    }
  }
}

// ---- variant 0: FP32 FMAs, one thread a ray -----------------------------

constexpr int FMA_NCH = 256;  // columns of a staged chunk

template <int K>
__global__ void __launch_bounds__(1024)
fma_dot_min(const float* __restrict__ F, const float* __restrict__ G, float* __restrict__ out,
            int B, int N, int reps, int acc_min) {
  __shared__ float4 sg[K * FMA_NCH / 4];  // [k][column]
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = ray < B;
  float f[K];
#pragma unroll
  for (int k = 0; k < K; ++k) f[k] = active ? F[(size_t)k * B + ray] : 0.0f;

  float best = INFINITY;
  const size_t cols = (size_t)N * reps;
  float* sgf = reinterpret_cast<float*>(sg);
  for (int rep = 0; rep < reps; ++rep) {
    for (int c0 = 0; c0 < N; c0 += FMA_NCH) {
      const int n = min(FMA_NCH, N - c0);
      __syncthreads();  // the previous chunk is consumed
      for (int e = threadIdx.x; e < K * FMA_NCH; e += blockDim.x) {
        const int col = e % FMA_NCH, k = e / FMA_NCH;
        if (col < n) sgf[e] = G[(size_t)k * cols + (size_t)rep * N + c0 + col];
      }
      __syncthreads();
      if (!active) continue;
      for (int n4 = 0; n4 < n / 4; ++n4) {
        float4 acc;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float4 g = sg[k * (FMA_NCH / 4) + n4];  // the same address for the whole warp
          if (k == 0) {
            acc.x = f[0] * g.x, acc.y = f[0] * g.y, acc.z = f[0] * g.z, acc.w = f[0] * g.w;
          } else {
            acc.x = fmaf(f[k], g.x, acc.x), acc.y = fmaf(f[k], g.y, acc.y);
            acc.z = fmaf(f[k], g.z, acc.z), acc.w = fmaf(f[k], g.w, acc.w);
          }
        }
        if (acc_min) {
          best = fminf(best, fminf(fminf(acc.x, acc.y), fminf(acc.z, acc.w)));
        } else {
          // the dots are done all the same: the compiler may not drop them
          asm volatile("" ::"f"(acc.x), "f"(acc.y), "f"(acc.z), "f"(acc.w));
          if (c0 == 0 && n4 == 0) best = fminf(best, acc.x);
        }
      }
    }
  }
  if (active) out[ray] = best;
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

// scratch: N * reps * KS * 32 bytes for G in wgmma's order
template <int KS, bool SPLIT>
int launch_wgmma(const void* F, const void* G, void* out, void* scratch, int B, int K, int N,
                 int reps, int M, cudaStream_t stream) {
  // 64 * MT rays a warpgroup: their A fragments and 64 accumulators in registers
  constexpr int MT = (SPLIT || KS <= 3) ? 4 : 2;
  const int wgs = M / (64 * MT);
  if (M % (64 * MT) || wgs < 1 || wgs * 128 > WG_THREADS || N % 128 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t cols = (size_t)N * reps, words = cols * KS * 8;
  pack_g<<<(unsigned)((words + 255) / 256), 256, 0, stream>>>(
      static_cast<const uint16_t*>(G), static_cast<uint32_t*>(scratch), K, KS * 2, cols);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  wgmma_dot_min<KS, MT, SPLIT><<<(B + M - 1) / M, wgs * 128, 0, stream>>>(
      F, static_cast<const uint4*>(scratch), static_cast<float*>(out), B, K, N, reps);
  return (int)cudaGetLastError();
}

template <int K>
int launch_fma(const void* F, const void* G, void* out, int B, int N, int reps, int M,
               int acc_min, cudaStream_t stream) {
  if (M % 32 || M > 1024) return (int)cudaErrorInvalidValue;
  fma_dot_min<K><<<(B + M - 1) / M, M, 0, stream>>>(
      static_cast<const float*>(F), static_cast<const float*>(G), static_cast<float*>(out), B, N,
      reps, acc_min);
  return (int)cudaGetLastError();
}

}  // namespace

// F [K, B], G [K, N * reps], out [B]; N a multiple of 8; M rays a block;
// variant as above. FP32: K 8, 16 or 32, M a multiple of 32 up to 1024.
// mma.sync: M a multiple of 64 up to 1024 (K <= 48; TF32 K <= 16) or of 32
// up to 512. wgmma: K 16 to 128, M 256 or 512 (K <= 48) or 128 or 256, N a
// multiple of 128, scratch of N * reps * 2 * (K rounded up to 16) bytes
// (null for the other variants).
extern "C" int rt_dot_min(const void* F, const void* G, void* out, void* scratch, int B, int K,
                          int N, int reps, int M, int acc_min, int variant, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || N < 1 || N % 8 || reps < 1) return (int)cudaErrorInvalidValue;
#define MMA(T, KS, MT) return launch_mma<T, KS, MT, false>(F, G, out, B, K, N, reps, M, acc_min, s)
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
#define WGMMA(KS) return launch_wgmma<KS, false>(F, G, out, scratch, B, K, N, reps, M, s)
    if (K == 16) WGMMA(1);
    if (K == 32) WGMMA(2);
    if (K == 48) WGMMA(3);
    if (K == 64) WGMMA(4);
    if (K == 96) WGMMA(6);
    if (K == 128) WGMMA(8);
#undef WGMMA
  }
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
    return launch_wgmma<6, true>(F, G, out, scratch, B, 96, N, reps, M, (cudaStream_t)stream);
  return launch_mma<Bf16, 6, 4, true>(F, G, out, B, 96, N, reps, M, 1, (cudaStream_t)stream);
}
