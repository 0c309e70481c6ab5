// BVH traversal, one thread a ray (kernels K20n and K20a) for Hopper,
// sm_90a.
//
// Replaces the XLA while_loop of rustic_tpu/ops/intersect.py
// `_intersect_bvh_impl` (the "bvh" engine: `intersect_bvh`, `occlude_bvh`),
// which is not a Pallas kernel. The JAX loop advances every ray ("lane")
// one step an iteration under masks: a lane inside a leaf tests its next
// triangle, any other lane pops a node from its own 32-entry stack; no lane
// reads another's state. Here each thread runs its own lane's steps to the
// end, the reference's own method (kernels/src/intersection.rs:177-234), so
// the result is the lockstep loop's bit for bit:
//   rt_bvh_nearest  (K20n): nearest hit -> t, idx, hit, backface, u, v
//   rt_bvh_occluded (K20a): any hit within (EPS, max_t] -> hit, with the
//                           early out at the first one
// Its plain version is ops/intersect.py `bvh_traverse_plain`.
//
// Numerics, as the plain version's torch operations round: every product
// and sum is written out (__fmul_rn, __fadd_rn, __fsub_rn, and the file is
// built with -fmad=false as well), the Moller-Trumbore dots sum
// (x0 + x1) + x2, the reciprocals are IEEE divisions, |rd| < 1e-12 is
// clamped to +-1e-12 (the sign of rd; -0.0 takes +) before its
// reciprocal, so the slab products of a finite ray are finite; the
// min/max are written as compares that pass a NaN on, as torch's do (a
// ray with a NaN component misses every box on both sides). A push onto
// a full stack is dropped, as in the JAX loop. Children are pushed far
// then near after a slab test at the lane's best t; a popped node is not
// tested again.
//
// Operands: rays ro, rd [B, 3] f32 (and max_t [B] for K20a); the nodes as
// a struct of arrays (aabb min/max [N, 3] f32, left_first [N] i32, count
// [N] i32; a leaf's left_first indexes the triangle rows); the triangles'
// vertices a, b, c in columns 0:9 of the shading rows [T_pad, W] f32,
// which are in the BVH's triangle order.
//
// What bounds it: per ray, the nodes popped (two slab tests each for an
// internal node) and the triangles tested (one Moller-Trumbore each); the
// nodes and rows are a few hundred KB and stay in L2, so the bytes are the
// rays in and the results out. The design is the simple one: no ray sort,
// no re-test of a popped node against a newer best t, the stack in local
// memory, nodes and rows read through the read-only path.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int STACK_DEPTH = 32;  // reference: kernels/src/intersection.rs:178
constexpr float BIG = 1e6f;
constexpr float EPS = 1e-3f;
constexpr float DET_EPS = 1e-6f;
constexpr float RD_CLAMP = 1e-12f;

struct V3 {
  float x, y, z;
};

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

__device__ __forceinline__ V3 load3(const float* __restrict__ p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

__device__ __forceinline__ float inv_dir(float d) {
  const float c = fabsf(d) < RD_CLAMP ? (d < 0.f ? -RD_CLAMP : RD_CLAMP) : d;
  return __fdiv_rn(1.f, c);
}

// torch.minimum / maximum (and amin / amax): a NaN operand gives NaN
__device__ __forceinline__ float min2(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : (b < a ? b : a);
}
__device__ __forceinline__ float max2(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : (b > a ? b : a);
}

// slab entry distance of box `node`, inf where missed or entered at or
// beyond prev_t (reference: kernels/src/intersection.rs:104-122)
__device__ __forceinline__ float slab(const float* __restrict__ bmin,
                                      const float* __restrict__ bmax, int node, V3 o, V3 inv,
                                      float prev_t) {
  const V3 lo = load3(bmin + 3 * node), hi = load3(bmax + 3 * node);
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

template <bool NEAREST>
__global__ void __launch_bounds__(THREADS)
    bvh_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
               const float* __restrict__ max_t, const float* __restrict__ bmin,
               const float* __restrict__ bmax, const int* __restrict__ left_first,
               const int* __restrict__ count, const float* __restrict__ rows, float* out_t,
               int* out_idx, bool* out_hit, bool* out_back, float* out_u, float* out_v, int B,
               int W, int n_tris) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= B) return;
  const V3 o = {ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]};
  const V3 d = {rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]};
  const V3 inv = {inv_dir(d.x), inv_dir(d.y), inv_dir(d.z)};
  const float mt = NEAREST ? 0.f : max_t[i];

  int stack[STACK_DEPTH];
  stack[0] = 0;  // the root
  int sp = 1, leaf_ptr = 0, leaf_end = 0;
  float best_t = BIG, best_u = 0.f, best_v = 0.f;
  int best_idx = 0;
  bool best_back = false;

  while (sp > 0 || leaf_ptr < leaf_end) {
    if (leaf_ptr < leaf_end) {
      // test one triangle (reference: kernels/src/intersection.rs:9-54)
      const int ti = min(max(leaf_ptr, 0), n_tris - 1);
      const float* r = rows + static_cast<size_t>(ti) * W;
      const V3 a = load3(r), b = load3(r + 3), c = load3(r + 6);
      const V3 e1 = sub(b, a), e2 = sub(c, a);
      const V3 pv = cross(d, e2);
      const float det = dot(e1, pv);
      const bool good = fabsf(det) >= DET_EPS;
      const float inv_det = good ? __fdiv_rn(1.f, det) : 0.f;
      const V3 tv = sub(o, a);
      const float u = __fmul_rn(dot(tv, pv), inv_det);
      const V3 qv = cross(tv, e1);
      const float v = __fmul_rn(dot(d, qv), inv_det);
      const float t = __fmul_rn(dot(e2, qv), inv_det);
      const bool valid = good && u >= 0.f && u <= 1.f && v >= 0.f && __fadd_rn(u, v) <= 1.f &&
                         t > EPS;
      const bool better = valid && t < best_t && (NEAREST || t <= mt);
      if (better) {
        best_t = t;
        best_idx = ti;
        best_back = det < 0.f;
        best_u = u;
        best_v = v;
      }
      ++leaf_ptr;
      if (!NEAREST && better) break;  // the shadow ray is occluded
      continue;
    }
    const int node = stack[--sp];
    const int cnt = __ldg(count + node);
    const int left = __ldg(left_first + node);
    if (cnt > 0) {  // a leaf: its triangles next
      leaf_ptr = left;
      leaf_end = left + cnt;
      continue;
    }
    // ordered push of both children (reference: kernels/src/intersection.rs:206-230)
    const float ld = slab(bmin, bmax, left, o, inv, best_t);
    const float rdist = slab(bmin, bmax, left + 1, o, inv, best_t);
    const bool swap = ld > rdist;
    const int near_i = swap ? left + 1 : left, far_i = swap ? left : left + 1;
    const float near_d = swap ? rdist : ld, far_d = swap ? ld : rdist;
    if (isfinite(far_d) && sp < STACK_DEPTH) stack[sp++] = far_i;
    if (isfinite(near_d) && sp < STACK_DEPTH) stack[sp++] = near_i;
  }

  out_hit[i] = best_t < BIG;
  if (NEAREST) {
    out_t[i] = best_t;
    out_idx[i] = best_idx;
    out_back[i] = best_back;
    out_u[i] = best_u;
    out_v[i] = best_v;
  }
}

template <bool NEAREST>
int launch(const float* ro, const float* rd, const float* max_t, const float* bmin,
           const float* bmax, const int* left_first, const int* count, const float* rows,
           float* t, int* idx, bool* hit, bool* back, float* u, float* v, int B, int W,
           int n_tris, void* stream) {
  if (B <= 0) return cudaSuccess;
  const int blocks = (B + THREADS - 1) / THREADS;
  bvh_kernel<NEAREST><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ro, rd, max_t, bmin, bmax, left_first, count, rows, t, idx, hit, back, u, v, B, W, n_tris);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_bvh_nearest(const float* ro, const float* rd, const float* bmin,
                              const float* bmax, const int* left_first, const int* count,
                              const float* rows, float* t, int* idx, bool* hit, bool* back,
                              float* u, float* v, int B, int W, int n_tris, void* stream) {
  return launch<true>(ro, rd, nullptr, bmin, bmax, left_first, count, rows, t, idx, hit, back, u,
                      v, B, W, n_tris, stream);
}

extern "C" int rt_bvh_occluded(const float* ro, const float* rd, const float* max_t,
                               const float* bmin, const float* bmax, const int* left_first,
                               const int* count, const float* rows, bool* hit, int B, int W,
                               int n_tris, void* stream) {
  return launch<false>(ro, rd, max_t, bmin, bmax, left_first, count, rows, nullptr, nullptr, hit,
                       nullptr, nullptr, nullptr, B, W, n_tris, stream);
}
