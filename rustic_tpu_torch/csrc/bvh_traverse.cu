// BVH traversal (kernels K20n and K20a) for Hopper, sm_90a: persistent
// warps over packed node and triangle records, one memory round trip a
// node.
//
// Replaces the XLA while_loop of rustic_tpu/ops/intersect.py:202
// `_intersect_bvh_impl` (the "bvh" engine: `intersect_bvh`, `occlude_bvh`),
// which is not a Pallas kernel. The JAX loop advances every ray ("lane")
// one step an iteration under masks: a lane inside a leaf tests its next
// triangle, any other lane pops a node from its own 32-entry stack; no lane
// reads another's state. Here each thread runs its own lane's steps in the
// same order, the reference's own method (kernels/src/intersection.rs:
// 177-234), so the result is the lockstep loop's bit for bit:
//   rt_bvh_nearest  (K20n): nearest hit -> t, idx, hit, backface, u, v
//   rt_bvh_occluded (K20a): any hit within (EPS, max_t] -> hit, with the
//                           early out at the first one
// Its plain version is ops/intersect.py `bvh_traverse_plain`.
//
// Numerics, as the plain version's torch operations round: every product
// and sum is written out (__fmul_rn, __fadd_rn, __fsub_rn, and the file is
// built with -fmad=false as well, so nothing rests on FMA contraction),
// the Moller-Trumbore dots sum (x0 + x1) + x2, the reciprocals are
// correctly rounded (__frcp_rn: the bits of an IEEE division), |rd| <
// 1e-12 is clamped to +-1e-12 (the sign of rd; -0.0 takes +) before its
// reciprocal, so the slab products of a finite ray are finite; the min/max
// pass a NaN on, as torch's do (a ray with a NaN component misses every
// box on both sides).
// Each lane keeps the order of the lockstep loop: the same pops, the slab
// tests of both children at the lane's best t of that moment, far then
// near pushes (a push onto a full stack is dropped), a leaf's triangles in
// order, and for K20a the stop at the first hit. A near tie's winner and
// which push drops depend on that order, so nothing here reorders it.
//
// What bounds it on this card (chip_smoke.py's bound for K20, phase 31):
// per ray the internal nodes popped (two slab tests each) and the
// triangles tested (one Moller-Trumbore each) at the FP32 rate, or the
// rays in and the results out at the memory rate; the tables are a few
// hundred KB and stay in L2. Bytes bound it (K20n 0.053 ms, K20a 0.036 ms
// at 4,194,304 sorted VeachMIS bounce-1 lanes), but a ray's steps are a
// chain of dependent loads and its branches diverge from its warp's, so
// latency, divergence and the instructions issued set the pace. A plain
// one-thread-a-ray loop loses time four ways, and the design answers
// each:
//   1. Two or three dependent loads a node (a pop from the stack, then
//      count and left_first, then 12 scalar loads of the children's
//      boxes). Here a node is a 32-byte record {lo.xyz, left_first,
//      hi.xyz, count} (scene/bvh.py `node_records`); the builders put
//      children in pairs (left, left + 1) with the first pair at node 1,
//      so the table starts with one pad record and every pair is one
//      64-byte aligned line, read by four 16-byte loads issued together. A
//      stack entry carries the node's (left_first, count) packed in 32 bits
//      (left_first << cbits | count, checked at upload), which its parent's
//      visit has already loaded, so a pop loads nothing: a leaf's
//      triangles, or its children's pair, follow at once.
//   2. Nine scalar loads and two edge subtractions a triangle. Here a
//      triangle is a 48-byte record {a, e1, e2} (scene/world.py
//      `triangle_records`: e1 = b - a and e2 = c - a by the same IEEE
//      subtraction, on the card at upload), three 16-byte loads.
//   3. No load balancing: a warp runs as long as its longest ray. Here the
//      warps are persistent (as many blocks as the SMs hold) and a warp's
//      finished lanes take new rays as soon as REFILL of them are idle,
//      from a queue of BATCH rays that the warp takes from a global
//      counter (its first batch is its own), so a long shadow ray holds up
//      one lane, not the rays behind it, and the counter sees one atomic
//      a batch.
//   4. Issue slots spent on overhead: a NaN-passing min or max written as
//      compares is six instructions, and a triangle test run to its end
//      computes what a failed window throws away. Here each
//      is one `min.NaN` / `max.NaN`, the reciprocals are __frcp_rn, and a
//      test stops at the first window its values leave.
// The loop is the while-while of Aila and Laine (HPG 2009): a lane pops
// nodes until it holds a leaf, then tests the leaf's triangles; no
// speculation, so each lane's steps are the lockstep loop's. The stack
// stays in local memory (interleaved by lane, so a warp's entry k is one
// line), which timed ahead of a shared-memory [depth][thread] stack on the
// oracle's operands and leaves the L1 to the node records. Build
// (nvcc -Xptxas -v, sm_90a, -fmad=false): 56 registers for each template,
// a 128-byte stack frame (the stack), no spill; 9 blocks of 128 threads
// an SM. probe_kernel_builds `bvh` times it in turns against older
// versions and holds it to them bit for bit.
//
// Operands: rays ro, rd [B, 3] f32 (and max_t [B] for K20a); the node
// records [R, 8] f32 (ints bit-cast) with node n at record base + n, and
// the counts' width `cbits`; the triangle records [n_tris, 12] f32 in the
// BVH's triangle order (the rows of tri_attrs); a zeroed int counter.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
// the persistent warps (timed in turns against 16-512 and 1-32 by
// probe_kernel_builds `bvh` on edited copies): rays a warp takes from the
// counter at once, and the finished lanes a warp gathers before they take
// new rays
constexpr int BATCH = 32;
constexpr int REFILL = 8;
constexpr int STACK_DEPTH = 32;  // reference: kernels/src/intersection.rs:178
constexpr float BIG = 1e6f;
constexpr float EPS = 1e-3f;
constexpr float DET_EPS = 1e-6f;
constexpr float RD_CLAMP = 1e-12f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(REFILL >= 1 && REFILL <= 32, "a warp has 32 lanes");

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 xyz(float4 a) { return {a.x, a.y, a.z}; }

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z)};
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {__fsub_rn(__fmul_rn(a.y, b.z), __fmul_rn(a.z, b.y)),
          __fsub_rn(__fmul_rn(a.z, b.x), __fmul_rn(a.x, b.z)),
          __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x))};
}

// (x0 + x1) + x2 of the elementwise product, as `_sum3(a * b)`
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)), __fmul_rn(a.z, b.z));
}

// 1 / d correctly rounded (the bits of __fdiv_rn(1, d)), |d| < RD_CLAMP clamped first
__device__ __forceinline__ float inv_dir(float d) {
  const float c = fabsf(d) < RD_CLAMP ? (d < 0.f ? -RD_CLAMP : RD_CLAMP) : d;
  return __frcp_rn(c);
}

// torch.minimum / maximum (and amin / amax): a NaN operand gives NaN. One
// instruction each (sm_80+); a zero's sign may differ from torch's, which
// no use below can see: the slab distances are only compared.
__device__ __forceinline__ float min2(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max2(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// slab entry distance of the box (lo, hi), inf where missed or entered at
// or beyond prev_t (reference: kernels/src/intersection.rs:104-122)
__device__ __forceinline__ float slab(float4 lo, float4 hi, V3 o, V3 inv, float prev_t) {
  const float ax = __fmul_rn(__fsub_rn(lo.x, o.x), inv.x);
  const float bx = __fmul_rn(__fsub_rn(hi.x, o.x), inv.x);
  const float ay = __fmul_rn(__fsub_rn(lo.y, o.y), inv.y);
  const float by = __fmul_rn(__fsub_rn(hi.y, o.y), inv.y);
  const float az = __fmul_rn(__fsub_rn(lo.z, o.z), inv.z);
  const float bz = __fmul_rn(__fsub_rn(hi.z, o.z), inv.z);
  const float tmin = max2(max2(min2(ax, bx), min2(ay, by)), min2(az, bz));
  const float tmax = min2(min2(max2(ax, bx), max2(ay, by)), max2(az, bz));
  const bool ok = (tmax >= tmin) && (tmax > 0.f) && (tmin < prev_t);
  return ok ? tmin : __int_as_float(0x7f800000);
}

// a node's stack entry from its record's halves: left_first << cbits | count
__device__ __forceinline__ unsigned entry(float4 first_half, float4 second_half, int cbits) {
  return (__float_as_uint(first_half.w) << cbits) | __float_as_uint(second_half.w);
}

template <bool NEAREST>
__global__ void __launch_bounds__(THREADS)
    bvh_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
               const float* __restrict__ max_t, const float4* __restrict__ nodes,
               const float4* __restrict__ tris, int* __restrict__ counter, float* out_t,
               int* out_idx, bool* out_hit, bool* out_back, float* out_u, float* out_v, int B,
               int base, int cbits, int n_tris) {
  unsigned stack[STACK_DEPTH];  // local memory: interleaved by lane, cached in L1
  const float4* const rec = nodes + 2 * base;  // node n: rec[2n], rec[2n + 1]
  const unsigned root = entry(__ldg(rec), __ldg(rec + 1), cbits);
  const unsigned count_mask = (1u << cbits) - 1u;
  const int lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;

  // warp-uniform: the warp's queue of rays [q_next, q_end), its own batch
  // first, then batches from the counter past every warp's first one
  const int first_rays = gridDim.x * (THREADS / 32) * BATCH;
  int q_next = (blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5)) * BATCH;
  int q_end = min(q_next + BATCH, B);
  bool drained = false;  // the counter has passed B

  int ray = -1;  // the lane's ray, -1 while it has none
  V3 o = {0.f, 0.f, 0.f}, d = o, inv = o;
  float mt = 0.f, best_t = BIG, best_u = 0.f, best_v = 0.f;
  int best_idx = 0, sp = 0, leaf_ptr = 0, leaf_end = 0;
  bool best_back = false;

  while (true) {
    const unsigned idle = __ballot_sync(FULL, ray < 0);
    if (drained && idle == FULL) break;
    if (!drained && __popc(idle) >= REFILL) {
      if (q_next >= q_end) {  // the next batch
        int first = 0;
        if (lane == 0) first = first_rays + atomicAdd(counter, BATCH);
        first = __shfl_sync(FULL, first, 0);
        q_next = first;
        q_end = min(first + BATCH, B);
        drained = first >= B;
      }
      // the idle lanes take the queue's next rays, in lane order
      const int r = q_next + __popc(idle & lanes_below);
      if (ray < 0 && r < q_end) {
        ray = r;
        o = {ro[3 * r], ro[3 * r + 1], ro[3 * r + 2]};
        d = {rd[3 * r], rd[3 * r + 1], rd[3 * r + 2]};
        inv = {inv_dir(d.x), inv_dir(d.y), inv_dir(d.z)};
        mt = NEAREST ? 0.f : max_t[r];
        best_t = BIG;
        best_u = best_v = 0.f;
        best_idx = 0;
        best_back = false;
        stack[0] = root;
        sp = 1;
        leaf_ptr = leaf_end = 0;
      }
      q_next = min(q_next + __popc(idle), q_end);
    }
    if (ray < 0) continue;

    // pop nodes until one is a leaf (reference: kernels/src/intersection.rs:196-230)
    while (leaf_ptr >= leaf_end && sp > 0) {
      const unsigned e = stack[--sp];
      const int cnt = static_cast<int>(e & count_mask);
      const int left = static_cast<int>(e >> cbits);
      if (cnt > 0) {  // a leaf: its triangles next
        leaf_ptr = left;
        leaf_end = left + cnt;
        break;
      }
      // the child pair in one round trip, then the ordered push
      const float4* const pair = rec + 2 * left;
      const float4 l0 = __ldg(pair), l1 = __ldg(pair + 1);
      const float4 r0 = __ldg(pair + 2), r1 = __ldg(pair + 3);
      const float ld = slab(l0, l1, o, inv, best_t);
      const float rdist = slab(r0, r1, o, inv, best_t);
      const bool swap = ld > rdist;
      const unsigned le = entry(l0, l1, cbits), re = entry(r0, r1, cbits);
      const unsigned near_e = swap ? re : le, far_e = swap ? le : re;
      const float near_d = swap ? rdist : ld, far_d = swap ? ld : rdist;
      if (isfinite(far_d) && sp < STACK_DEPTH) stack[sp++] = far_e;
      if (isfinite(near_d) && sp < STACK_DEPTH) stack[sp++] = near_e;
    }

    // the leaf's triangles in order (reference: kernels/src/intersection.rs:9-54)
    bool occluded = false;
    while (leaf_ptr < leaf_end) {
      const int ti = min(max(leaf_ptr, 0), n_tris - 1);
      const float4* const tri = tris + 3 * static_cast<size_t>(ti);
      const float4 a4 = __ldg(tri), e14 = __ldg(tri + 1), e24 = __ldg(tri + 2);
      const V3 a = xyz(a4), e1 = xyz(e14), e2 = xyz(e24);
      const V3 pv = cross(d, e2);
      const float det = dot(e1, pv);
      // the plain version's test, stopped at the first window a value
      // leaves: only a lane that passes them all changes its best
      bool better = false;
      if (fabsf(det) >= DET_EPS) {
        const float inv_det = __frcp_rn(det);  // the bits of __fdiv_rn(1, det)
        const V3 tv = sub(o, a);
        const float u = __fmul_rn(dot(tv, pv), inv_det);
        if (u >= 0.f && u <= 1.f) {
          const V3 qv = cross(tv, e1);
          const float v = __fmul_rn(dot(d, qv), inv_det);
          if (v >= 0.f && __fadd_rn(u, v) <= 1.f) {
            const float t = __fmul_rn(dot(e2, qv), inv_det);
            better = t > EPS && t < best_t && (NEAREST || t <= mt);
            if (better) {
              best_t = t;
              best_idx = ti;
              best_back = det < 0.f;
              best_u = u;
              best_v = v;
            }
          }
        }
      }
      ++leaf_ptr;
      if (!NEAREST && better) {  // the shadow ray is occluded
        occluded = true;
        break;
      }
    }

    if (occluded || (sp == 0 && leaf_ptr >= leaf_end)) {  // the ray is done
      out_hit[ray] = best_t < BIG;
      if (NEAREST) {
        out_t[ray] = best_t;
        out_idx[ray] = best_idx;
        out_back[ray] = best_back;
        out_u[ray] = best_u;
        out_v[ray] = best_v;
      }
      ray = -1;
    }
  }
}

template <bool NEAREST>
int blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bvh_kernel<NEAREST>, THREADS, 0);
  return n;
}

template <bool NEAREST>
int launch(const float* ro, const float* rd, const float* max_t, const float* nodes,
           const float* tris, int* counter, float* t, int* idx, bool* hit, bool* back, float* u,
           float* v, int B, int base, int cbits, int n_tris, void* stream) {
  if (B <= 0) return cudaSuccess;
  static int resident = 0;  // blocks the card holds at once, found at the first launch
  if (resident == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    resident = sms * blocks_per_sm<NEAREST>();
    if (resident <= 0) {
      const cudaError_t err = cudaGetLastError();
      return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
    }
  }
  const int needed = (B + THREADS - 1) / THREADS;
  const int blocks = needed < resident ? needed : resident;
  bvh_kernel<NEAREST><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ro, rd, max_t, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(tris), counter, t, idx, hit, back, u, v, B, base, cbits,
      n_tris);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the operand layout of these entry points (the parent's: 1, no export)
extern "C" int rt_bvh_abi() { return 2; }

// blocks of K20n (nearest != 0) or K20a an SM holds at once
extern "C" int rt_bvh_blocks_per_sm(int nearest) {
  return nearest ? blocks_per_sm<true>() : blocks_per_sm<false>();
}

extern "C" int rt_bvh_nearest(const float* ro, const float* rd, const float* nodes,
                              const float* tris, int* counter, float* t, int* idx, bool* hit,
                              bool* back, float* u, float* v, int B, int base, int cbits,
                              int n_tris, void* stream) {
  return launch<true>(ro, rd, nullptr, nodes, tris, counter, t, idx, hit, back, u, v, B, base,
                      cbits, n_tris, stream);
}

extern "C" int rt_bvh_occluded(const float* ro, const float* rd, const float* max_t,
                               const float* nodes, const float* tris, int* counter, bool* hit,
                               int B, int base, int cbits, int n_tris, void* stream) {
  return launch<false>(ro, rd, max_t, nodes, tris, counter, nullptr, nullptr, hit, nullptr,
                       nullptr, nullptr, B, base, cbits, n_tris, stream);
}
