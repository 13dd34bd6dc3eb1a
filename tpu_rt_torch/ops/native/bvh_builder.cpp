// Native binned-SAH BVH builder, host side.
//
// A copy of tpu_rt/ops/native/bvh_builder.cpp, unchanged below this
// comment: the mesh cluster tables are cut from the tree, so the port must
// build the very tree tpu_rt builds.  Same node layout, leaf size and bin
// count as the numpy builder in tpu_rt_torch/geometry/bvh.py.
//
// C ABI (built with g++ at first use and loaded via ctypes by
// tpu_rt_torch/geometry/bvh.py):
//   int tpu_rt_build_bvh(const float* bb_min, const float* bb_max,
//                        int n_prims,
//                        float* node_min, float* node_max,
//                        int* node_a, int* node_b, int* node_count,
//                        int* prim_order, int max_nodes);
// Returns the number of nodes written, or -1 if max_nodes is too small.
// Caller allocates node arrays of size max_nodes (2 * n_prims suffices).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kLeafSize = 4;
constexpr int kBins = 16;

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Builder {
  const Vec3 *bb_min;
  const Vec3 *bb_max;
  std::vector<Vec3> centroid;
  int32_t *order;

  float *node_min;
  float *node_max;
  int32_t *node_a;
  int32_t *node_b;
  int32_t *node_count;
  int max_nodes;
  int n_nodes = 0;

  int alloc() {
    if (n_nodes >= max_nodes) return -1;
    return n_nodes++;
  }

  // Builds the subtree over order[s, e); returns node id or -1 on overflow.
  int build(int s, int e) {
    int ni = alloc();
    if (ni < 0) return -1;

    Vec3 nmin = {std::numeric_limits<float>::infinity(),
                 std::numeric_limits<float>::infinity(),
                 std::numeric_limits<float>::infinity()};
    Vec3 nmax = {-std::numeric_limits<float>::infinity(),
                 -std::numeric_limits<float>::infinity(),
                 -std::numeric_limits<float>::infinity()};
    Vec3 cmin = nmin, cmax = nmax;
    for (int i = s; i < e; ++i) {
      int p = order[i];
      nmin = vmin(nmin, bb_min[p]);
      nmax = vmax(nmax, bb_max[p]);
      cmin = vmin(cmin, centroid[p]);
      cmax = vmax(cmax, centroid[p]);
    }
    node_min[3 * ni + 0] = nmin.x;
    node_min[3 * ni + 1] = nmin.y;
    node_min[3 * ni + 2] = nmin.z;
    node_max[3 * ni + 0] = nmax.x;
    node_max[3 * ni + 1] = nmax.y;
    node_max[3 * ni + 2] = nmax.z;

    int n = e - s;
    if (n <= kLeafSize) {
      node_a[ni] = s;
      node_b[ni] = 0;
      node_count[ni] = n;
      return ni;
    }

    float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    if (ext[axis] < 1e-12f) {  // degenerate: all centroids coincide
      node_a[ni] = s;
      node_b[ni] = 0;
      node_count[ni] = n;
      return ni;
    }

    const float lo = (axis == 0 ? cmin.x : axis == 1 ? cmin.y : cmin.z);
    const float inv = kBins / ext[axis];
    auto bin_of = [&](int p) {
      const Vec3 &c = centroid[p];
      float v = (axis == 0 ? c.x : axis == 1 ? c.y : c.z);
      int b = static_cast<int>((v - lo) * inv);
      return std::min(std::max(b, 0), kBins - 1);
    };

    int counts[kBins] = {0};
    Vec3 bmin[kBins], bmax[kBins];
    for (int b = 0; b < kBins; ++b) {
      bmin[b] = {std::numeric_limits<float>::infinity(),
                 std::numeric_limits<float>::infinity(),
                 std::numeric_limits<float>::infinity()};
      bmax[b] = {-std::numeric_limits<float>::infinity(),
                 -std::numeric_limits<float>::infinity(),
                 -std::numeric_limits<float>::infinity()};
    }
    for (int i = s; i < e; ++i) {
      int p = order[i];
      int b = bin_of(p);
      counts[b]++;
      bmin[b] = vmin(bmin[b], bb_min[p]);
      bmax[b] = vmax(bmax[b], bb_max[p]);
    }

    auto area = [](const Vec3 &mn, const Vec3 &mx) {
      float dx = std::max(mx.x - mn.x, 0.f);
      float dy = std::max(mx.y - mn.y, 0.f);
      float dz = std::max(mx.z - mn.z, 0.f);
      return dx * dy + dy * dz + dz * dx;
    };

    float area_l[kBins], area_r[kBins];
    int cnt_l[kBins], cnt_r[kBins];
    {
      Vec3 mn = bmin[0], mx = bmax[0];
      int c = 0;
      for (int b = 0; b < kBins; ++b) {
        mn = vmin(mn, bmin[b]);
        mx = vmax(mx, bmax[b]);
        c += counts[b];
        area_l[b] = area(mn, mx);
        cnt_l[b] = c;
      }
      mn = bmin[kBins - 1];
      mx = bmax[kBins - 1];
      c = 0;
      for (int b = kBins - 1; b >= 0; --b) {
        mn = vmin(mn, bmin[b]);
        mx = vmax(mx, bmax[b]);
        c += counts[b];
        area_r[b] = area(mn, mx);
        cnt_r[b] = c;
      }
    }

    int best_k = -1;
    float best_cost = std::numeric_limits<float>::infinity();
    for (int k = 0; k < kBins - 1; ++k) {
      if (cnt_l[k] == 0 || cnt_r[k + 1] == 0) continue;
      float cost = area_l[k] * cnt_l[k] + area_r[k + 1] * cnt_r[k + 1];
      if (cost < best_cost) {
        best_cost = cost;
        best_k = k;
      }
    }

    int mid;
    if (best_k < 0) {
      mid = s + n / 2;
      std::nth_element(order + s, order + mid, order + e,
                       [&](int32_t a, int32_t b) {
                         const Vec3 &ca = centroid[a];
                         const Vec3 &cb = centroid[b];
                         float va = (axis == 0 ? ca.x : axis == 1 ? ca.y : ca.z);
                         float vb = (axis == 0 ? cb.x : axis == 1 ? cb.y : cb.z);
                         return va < vb;
                       });
    } else {
      auto it = std::stable_partition(order + s, order + e, [&](int32_t p) {
        return bin_of(p) <= best_k;
      });
      mid = static_cast<int>(it - order);
      if (mid == s || mid == e) mid = s + n / 2;
    }

    int li = build(s, mid);
    if (li < 0) return -1;
    int ri = build(mid, e);
    if (ri < 0) return -1;
    node_a[ni] = li;
    node_b[ni] = ri;
    node_count[ni] = 0;
    return ni;
  }
};

}  // namespace

extern "C" int tpu_rt_build_bvh(const float *bb_min, const float *bb_max,
                                int n_prims, float *node_min, float *node_max,
                                int32_t *node_a, int32_t *node_b,
                                int32_t *node_count, int32_t *prim_order,
                                int max_nodes) {
  if (n_prims <= 0) return 0;
  Builder b;
  b.bb_min = reinterpret_cast<const Vec3 *>(bb_min);
  b.bb_max = reinterpret_cast<const Vec3 *>(bb_max);
  b.centroid.resize(n_prims);
  for (int i = 0; i < n_prims; ++i) {
    b.centroid[i] = {0.5f * (b.bb_min[i].x + b.bb_max[i].x),
                     0.5f * (b.bb_min[i].y + b.bb_max[i].y),
                     0.5f * (b.bb_min[i].z + b.bb_max[i].z)};
    prim_order[i] = i;
  }
  b.order = prim_order;
  b.node_min = node_min;
  b.node_max = node_max;
  b.node_a = node_a;
  b.node_b = node_b;
  b.node_count = node_count;
  b.max_nodes = max_nodes;
  int root = b.build(0, n_prims);
  if (root < 0) return -1;
  return b.n_nodes;
}
