// Binned-SAH BVH builder: host C++, the port's copy of native/bvh.cpp.
//
// The JAX package builds its BVH with native/bvh.cpp whenever g++ can
// build it (rustic_tpu/scene/bvh.py build_bvh, scene/bvh_native.py). The
// triangle order it gives decides which triangles share a flash tile,
// every winner index and the nodes the "bvh" engine walks, so the port
// carries the same code, its algorithm and arithmetic unchanged below this
// note, and builds it with the same command (g++ -O3 -march=native -shared
// -fPIC; ops/_build.py `compile_host`): on the same host the two libraries
// give the same bits. Loaded with ctypes (scene/bvh.py `_native_library`).
//
// Output: SoA nodes (aabb_min/aabb_max[N][3], left_first[N], count[N]),
// leaf iff count > 0, children at (left, left+1), and the permutation that
// maps the new triangle order to the old index.
//

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

struct V3 {
  float x, y, z;
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

inline double box_area(const V3& lo, const V3& hi) {
  if (lo.x > hi.x) return 0.0;  // empty box
  double ex = hi.x - lo.x, ey = hi.y - lo.y, ez = hi.z - lo.z;
  return ex * ey + ey * ez + ez * ex;
}

struct Bin {
  V3 lo{kInf, kInf, kInf};
  V3 hi{-kInf, -kInf, -kInf};
  int32_t n = 0;
};

}  // namespace

extern "C" int bvh_build(
    const float* vertices, int n_verts, const int32_t* tris, int n_tris,
    int sah_samples, float* out_min, float* out_max, int32_t* out_left_first,
    int32_t* out_count, int32_t* out_perm) {
  if (n_tris <= 0 || sah_samples < 2) return -1;
  (void)n_verts;

  std::vector<V3> tri_min(n_tris), tri_max(n_tris), cen(n_tris);
  for (int i = 0; i < n_tris; ++i) {
    const float* a = vertices + 3 * tris[3 * i + 0];
    const float* b = vertices + 3 * tris[3 * i + 1];
    const float* c = vertices + 3 * tris[3 * i + 2];
    V3 va{a[0], a[1], a[2]}, vb{b[0], b[1], b[2]}, vc{c[0], c[1], c[2]};
    tri_min[i] = vmin(va, vmin(vb, vc));
    tri_max[i] = vmax(va, vmax(vb, vc));
    cen[i] = {(va.x + vb.x + vc.x) / 3.0f, (va.y + vb.y + vc.y) / 3.0f,
              (va.z + vb.z + vc.z) / 3.0f};
    out_perm[i] = i;
  }

  const int max_nodes = 2 * n_tris - 1 > 0 ? 2 * n_tris - 1 : 1;
  auto set_node_box = [&](int node, const V3& lo, const V3& hi) {
    out_min[3 * node + 0] = lo.x;
    out_min[3 * node + 1] = lo.y;
    out_min[3 * node + 2] = lo.z;
    out_max[3 * node + 0] = hi.x;
    out_max[3 * node + 1] = hi.y;
    out_max[3 * node + 2] = hi.z;
  };

  auto range_box = [&](int first, int n, V3* lo_out, V3* hi_out) {
    V3 lo{kInf, kInf, kInf}, hi{-kInf, -kInf, -kInf};
    for (int i = first; i < first + n; ++i) {
      lo = vmin(lo, tri_min[i]);
      hi = vmax(hi, tri_max[i]);
    }
    *lo_out = lo;
    *hi_out = hi;
  };

  out_left_first[0] = 0;
  out_count[0] = n_tris;
  {
    V3 lo, hi;
    range_box(0, n_tris, &lo, &hi);
    set_node_box(0, lo, hi);
  }

  std::vector<Bin> bins(sah_samples);
  std::vector<double> left_area(sah_samples), right_area(sah_samples);
  std::vector<int64_t> left_cnt(sah_samples), right_cnt(sah_samples);
  std::vector<int32_t> stack;
  stack.push_back(0);
  int node_count = 1;

  while (!stack.empty()) {
    const int node = stack.back();
    stack.pop_back();
    const int first = out_left_first[node];
    const int n = out_count[node];

    int best_axis = -1;
    double best_cost = kInf;
    float best_split = 0.0f;

    for (int axis = 0; axis < 3; ++axis) {
      float lo = kInf, hi = -kInf;
      for (int i = first; i < first + n; ++i) {
        const float c = cen[i][axis];
        lo = std::min(lo, c);
        hi = std::max(hi, c);
      }
      if (lo == hi) continue;

      for (auto& b : bins) b = Bin{};
      const float scale = sah_samples / (hi - lo);
      for (int i = first; i < first + n; ++i) {
        int seg = static_cast<int>((cen[i][axis] - lo) * scale);
        seg = std::min(seg, sah_samples - 1);
        bins[seg].lo = vmin(bins[seg].lo, tri_min[i]);
        bins[seg].hi = vmax(bins[seg].hi, tri_max[i]);
        bins[seg].n += 1;
      }

      // prefix/suffix sweeps over the candidate planes
      V3 blo{kInf, kInf, kInf}, bhi{-kInf, -kInf, -kInf};
      int64_t cnt = 0;
      for (int i = 0; i < sah_samples - 1; ++i) {
        blo = vmin(blo, bins[i].lo);
        bhi = vmax(bhi, bins[i].hi);
        cnt += bins[i].n;
        left_area[i] = box_area(blo, bhi);
        left_cnt[i] = cnt;
      }
      blo = {kInf, kInf, kInf};
      bhi = {-kInf, -kInf, -kInf};
      cnt = 0;
      for (int i = sah_samples - 2; i >= 0; --i) {
        blo = vmin(blo, bins[i + 1].lo);
        bhi = vmax(bhi, bins[i + 1].hi);
        cnt += bins[i + 1].n;
        right_area[i] = box_area(blo, bhi);
        right_cnt[i] = cnt;
      }
      for (int i = 0; i < sah_samples - 1; ++i) {
        if (left_cnt[i] == 0 || right_cnt[i] == 0) continue;
        const double cost =
            left_cnt[i] * left_area[i] + right_cnt[i] * right_area[i];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_split = lo + (hi - lo) / sah_samples * (i + 1);
        }
      }
    }

    const V3 node_lo{out_min[3 * node], out_min[3 * node + 1],
                     out_min[3 * node + 2]};
    const V3 node_hi{out_max[3 * node], out_max[3 * node + 1],
                     out_max[3 * node + 2]};
    const double parent_cost = box_area(node_lo, node_hi) * n;
    if (best_axis < 0 || parent_cost <= best_cost) continue;  // stay a leaf

    // in-place partition by centroid < split
    int a = first, b = first + n - 1;
    while (a <= b) {
      if (cen[a][best_axis] < best_split) {
        ++a;
      } else {
        std::swap(out_perm[a], out_perm[b]);
        std::swap(cen[a], cen[b]);
        std::swap(tri_min[a], tri_min[b]);
        std::swap(tri_max[a], tri_max[b]);
        --b;
      }
    }
    const int n_left = a - first;
    if (n_left == 0 || n_left == n) continue;

    const int left = node_count;
    const int right = node_count + 1;
    if (right >= max_nodes) continue;  // cannot happen, but stay safe
    node_count += 2;
    out_left_first[node] = left;
    out_count[node] = 0;
    out_left_first[left] = first;
    out_count[left] = n_left;
    out_left_first[right] = first + n_left;
    out_count[right] = n - n_left;
    V3 lo, hi;
    range_box(first, n_left, &lo, &hi);
    set_node_box(left, lo, hi);
    range_box(first + n_left, n - n_left, &lo, &hi);
    set_node_box(right, lo, hi);
    stack.push_back(right);
    stack.push_back(left);
  }

  return node_count;
}
