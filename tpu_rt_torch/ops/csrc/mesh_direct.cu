// Direct-lighting mesh kernel (K9) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_rt/ops/pallas_mesh.py::_build_direct_kernel,
// launched by _direct_render_setup: per camera ray, the Moller-Trumbore
// closest hit over the mesh's triangle clusters, with the shading normal
// interpolated from the vertex normals and the albedo picked at the hit,
// then one shadow ray per point light, every light summed with the Lambert
// term.  Outputs the radiance (r, g, b) and the rays cast (the primary plus
// one shadow ray per light where one is cast).
//
// Design.  The TPU kernel swept (tm, 128) ray tiles against
// host-compacted live-cluster lists, with tile-wide "any lane live"
// culls; none of that is carried over.  A group of kGroup lanes takes a
// ray and walks the clusters as the mesh-intersect kernel (mesh_isect.cu)
// does: left to right in table order through the cull hierarchy over
// contiguous cluster ranges (common.cuh::wide_walk, mesh_kernel.py::
// build_cluster_tree), each cluster's four quarter boxes giving its span
// (ops/mesh_kernel.py::cluster_candidates is the same cull in PyTorch),
// the span split among the group and reduced to the lexicographic minimum
// of (t, k), the triangle a sequential strict-< sweep keeps.  The winner's
// shading attributes are read once, after the walk.  Each shadow ray
// takes the same walk as an any-hit test (a vote of the group).  The
// bounds table (at most 64 x 32 floats), the tree and the lights sit in
// shared memory; the 9-row triangle table and the 12-row shading table
// (up to 295 KB and 393 KB at 64 clusters, more than an SM's shared
// memory) are read from global memory through the read-only path and stay
// in L2.
//
// What bounds it.  FP32 work (about 54 operations a triangle test, 25 a
// box) over the boxes and triangles the walk tests (chip_smoke.py counts
// the plain walk's), and divergence: neighbouring rays walk different
// spans and their shadow rays different clusters.  Its 4.2 M primaries a
// launch fill the card already, so the group is narrower than K7's (the
// A/B ran 4 lanes a ray 3% faster than 2, 1 and 16 lanes slower).
//
// Arithmetic follows the plain PyTorch version (mesh_kernel.py::
// direct_trace_plain) operation by operation; build with -fmad=false.

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 4;  // lanes a ray
static_assert(kGroup > 1 && kGroup <= 32 && (kGroup & (kGroup - 1)) == 0, "a warp's lanes");
constexpr int kMaxClusters = 64;
// a cluster tree over at most 64 clusters (branching >= 2): its header
// and at most 63 nodes
constexpr int kMaxTreeRows = 2 + kMaxClusters;
constexpr int kMaxLights = 32;
constexpr float kMiss = (float)(0.99 * 1e8);
constexpr float kHitLimit = (float)(0.9 * 1e8);
constexpr float kShadowShrink = (float)(1.0 - 1e-3);
constexpr float kInvPi = (float)(1.0 / kPi);

// Moller-Trumbore against lane k of a cluster's 9-row p0/e1/e2 table; a
// hit lies in (1e-4, bt).
__device__ __forceinline__ bool mt(const float* __restrict__ tc, int k, V3 o, V3 d, float bt,
                                   float& t, float& u, float& v) {
  V3 p0 = {row(tc, 0, k), row(tc, 1, k), row(tc, 2, k)};
  V3 e1 = {row(tc, 3, k), row(tc, 4, k), row(tc, 5, k)};
  V3 e2 = {row(tc, 6, k), row(tc, 7, k), row(tc, 8, k)};
  float pvx = d.y * e2.z - d.z * e2.y;
  float pvy = d.z * e2.x - d.x * e2.z;
  float pvz = d.x * e2.y - d.y * e2.x;
  float det = e1.x * pvx + e1.y * pvy + e1.z * pvz;
  float invdet = 1.0f / clamp_abs(det, 1e-12f);
  float tvx = o.x - p0.x, tvy = o.y - p0.y, tvz = o.z - p0.z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * invdet;
  float qvx = tvy * e1.z - tvz * e1.y;
  float qvy = tvz * e1.x - tvx * e1.z;
  float qvz = tvx * e1.y - tvy * e1.x;
  v = (d.x * qvx + d.y * qvy + d.z * qvz) * invdet;
  t = (e2.x * qvx + e2.y * qvy + e2.z * qvz) * invdet;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kMeshTmin && t < bt;
}

__global__ void __launch_bounds__(kThreads)
mesh_direct_kernel(const float* __restrict__ rays, int n, const float* __restrict__ bounds_g,
                   const float* __restrict__ tris, const float* __restrict__ shade,
                   const float* __restrict__ tree_g, int n_tree, int n_clusters,
                   const float* __restrict__ lights_g, int n_lights, float* __restrict__ out) {
  __shared__ float bounds[kMaxClusters * 32];
  __shared__ float lights[kMaxLights * 6];
  __shared__ float tree[kMaxTreeRows * 8];
  __shared__ ClusterTree h;
  for (int i = threadIdx.x; i < n_clusters * 32; i += blockDim.x) bounds[i] = bounds_g[i];
  for (int i = threadIdx.x; i < n_lights * 6; i += blockDim.x) lights[i] = lights_g[i];
  for (int i = threadIdx.x; i < n_tree * 8; i += blockDim.x) tree[i] = tree_g[i];
  if (threadIdx.x == 0) load_tree_header(tree_g, h);
  __syncthreads();
  int i = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;  // a group's lanes share a ray
  if (i >= n) return;
  const int lane = threadIdx.x & 31, sub = lane & (kGroup - 1);
  const unsigned gmask = group_mask<kGroup>(lane);
  const int cend = h.real;  // pads (count 0) hold no triangle

  V3 o = {rays[i], rays[(size_t)n + i], rays[2 * (size_t)n + i]};
  V3 d = {rays[3 * (size_t)n + i], rays[4 * (size_t)n + i], rays[5 * (size_t)n + i]};
  V3 invd = {inv_safe(d.x), inv_safe(d.y), inv_safe(d.z)};

  // ---- closest hit: the winner's cluster, lane and barycentrics ----
  float best_t = kMiss, best_u = 0.0f, best_v = 0.0f;
  int best_c = -1, best_k = 0;
  auto closest = [&](int cc, int s, int e) -> bool {
    // this lane's share of the span, swept in order against a running best
    const float* tc = tris + (size_t)cc * 9 * kCluster;
    float lt = best_t, lu = 0.0f, lv = 0.0f;
    int lk = INT_MAX;
    for (int k = s + sub; k < e; k += kGroup) {
      float t, u, v;
      if (!mt(tc, k, o, d, lt, t, u, v)) continue;
      lt = t;
      lu = u;
      lv = v;
      lk = k;
    }
    float gt = lk == INT_MAX ? INFINITY : lt;
    int gk = lk;
    group_min_tk<kGroup>(gmask, gt, gk);
    if (gk == INT_MAX) return false;  // the same in the whole group
    int src = (gk - s) & (kGroup - 1);  // the lane that tested the winner
    best_t = gt;
    best_u = __shfl_sync(gmask, lu, src, kGroup);
    best_v = __shfl_sync(gmask, lv, src, kGroup);
    best_c = cc;
    best_k = gk;
    return false;
  };
  wide_walk<kGroup>(bounds, tree, h, 0, cend, o, invd, best_t, kMeshTmin, sub, gmask, closest);
  // the shading attributes of the winner, as the sequential sweep took
  // them at its last improvement
  V3 ns = {0.0f, 0.0f, 0.0f}, g = {0.0f, 0.0f, 0.0f}, alb = {0.0f, 0.0f, 0.0f};
  if (best_c >= 0) {
    const float* tc = tris + (size_t)best_c * 9 * kCluster;
    const float* sc = shade + (size_t)best_c * 12 * kCluster;
    int k = best_k;
    float u = best_u, v = best_v;
    float w0 = 1.0f - u - v;
    ns = {w0 * row(sc, 0, k) + u * row(sc, 3, k) + v * row(sc, 6, k),
          w0 * row(sc, 1, k) + u * row(sc, 4, k) + v * row(sc, 7, k),
          w0 * row(sc, 2, k) + u * row(sc, 5, k) + v * row(sc, 8, k)};
    V3 e1 = {row(tc, 3, k), row(tc, 4, k), row(tc, 5, k)};
    V3 e2 = {row(tc, 6, k), row(tc, 7, k), row(tc, 8, k)};
    g = cross(e1, e2);
    alb = {row(sc, 9, k), row(sc, 10, k), row(sc, 11, k)};
  }
  bool hit = best_t < kHitLimit;
  ns = normalize(ns);
  g = normalize(g);
  float tt = hit ? best_t : 0.0f;
  V3 p = {o.x + d.x * tt, o.y + d.y * tt, o.z + d.z * tt};
  float cos_i = -dot(ns, d);
  float pscale = fmaxf(fmaxf(fabsf(p.x), fmaxf(fabsf(p.y), fabsf(p.z))), 1.0f);

  // ---- one shadow ray per point light (any hit), all summed ----
  V3 L = {0.0f, 0.0f, 0.0f};
  float ray_n = 1.0f;
  for (int li = 0; li < n_lights; ++li) {
    const float* lt = lights + li * 6;
    V3 to_l = {lt[0] - p.x, lt[1] - p.y, lt[2] - p.z};
    float dist2 = fmaxf(dot(to_l, to_l), 1e-20f);
    float dist = sqrtf(dist2);
    V3 wl = scale(to_l, 1.0f / dist);
    float cos_o = dot(ns, wl);
    bool valid = hit && cos_i > 0.0f && cos_o > 0.0f;
    if (!valid) continue;  // the same in the whole group
    ray_n += 1.0f;
    float off = 1e-4f * pscale * (dot(g, wl) >= 0.0f ? 1.0f : -1.0f);
    V3 so = {p.x + g.x * off, p.y + g.y * off, p.z + g.z * off};
    V3 invwl = {inv_safe(wl.x), inv_safe(wl.y), inv_safe(wl.z)};
    const float tmax_s = dist * kShadowShrink;
    bool occ = false;
    auto any = [&](int cc, int s, int e) -> bool {
      const float* tc = tris + (size_t)cc * 9 * kCluster;
      for (int k = s + sub; k < e && !occ; k += kGroup) {
        float t, u, v;
        occ = mt(tc, k, so, wl, tmax_s, t, u, v);
      }
      occ = __any_sync(gmask, occ);
      return occ;
    };
    wide_walk<kGroup>(bounds, tree, h, 0, cend, so, invwl, tmax_s, kMeshTmin, sub, gmask, any);
    if (occ) continue;
    float lit = cos_o / dist2 * kInvPi;
    L.x = L.x + alb.x * lt[3] * lit;
    L.y = L.y + alb.y * lt[4] * lit;
    L.z = L.z + alb.z * lt[5] * lit;
  }
  if (sub != 0) return;
  out[i] = L.x;
  out[(size_t)n + i] = L.y;
  out[2 * (size_t)n + i] = L.z;
  out[3 * (size_t)n + i] = ray_n;
}

}  // namespace

extern "C" int mesh_direct_launch(const void* rays, int n, const void* bounds,
                                  const void* tris, const void* shade, const void* tree,
                                  int n_tree, int n_clusters, const void* lights, int n_lights,
                                  void* out, void* stream) {
  if (n <= 0 || n_clusters <= 0 || n_clusters > kMaxClusters || n_lights <= 0 ||
      n_lights > kMaxLights || tree == nullptr || n_tree <= 0 || n_tree > kMaxTreeRows)
    return (int)cudaErrorInvalidValue;
  long long threads = (long long)n * kGroup;
  if (threads >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  mesh_direct_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rays, n, (const float*)bounds, (const float*)tris, (const float*)shade,
      (const float*)tree, n_tree, n_clusters, (const float*)lights, n_lights, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* mesh_direct_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
