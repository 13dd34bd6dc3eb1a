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
// Design.  One thread per ray.  The TPU kernel swept (tm, 128) ray tiles
// against host-compacted live-cluster lists, with tile-wide "any lane
// live" culls; none of that is carried over.  Each thread walks every
// cluster in order: a slab test of the cluster box against its own running
// best distance, then the four quarter boxes, then a sweep of the
// contiguous live quarter span (ops/mesh_kernel.py::cluster_candidates is
// the same cull in PyTorch).  The TPU culls were conservative, so the hits
// are the same, up to which of two triangles at exactly the same distance
// wins.  The bounds table (at most 64 x 32 floats) and the lights sit in
// shared memory; the 9-row triangle table and the 12-row shading table (up
// to 295 KB and 393 KB at 64 clusters, more than an SM's shared memory)
// are read from global memory through the read-only path and stay in L2.
//
// What bounds it.  The sweep is FP32 ALU work (about 30 operations a
// triangle) and divergence: neighbouring rays walk different spans and
// their shadow rays different clusters.  Nothing here addresses that yet.
//
// Arithmetic follows the plain PyTorch version (mesh_kernel.py::
// direct_trace_plain) operation by operation; build with -fmad=false.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxClusters = 64;
constexpr int kMaxLights = 32;
constexpr float kMiss = (float)(0.99 * 1e8);
constexpr float kHitLimit = (float)(0.9 * 1e8);
constexpr float kShadowShrink = (float)(1.0 - 1e-3);
constexpr float kInvPi = (float)(1.0 / kPi);

// Moller-Trumbore against lane k of a cluster's 9-row p0/e1/e2 table.
__device__ __forceinline__ bool mt(const float* __restrict__ tc, int k, V3 o, V3 d,
                                   float bt, float& t, float& u, float& v, V3& e1, V3& e2) {
  V3 p0 = {row(tc, 0, k), row(tc, 1, k), row(tc, 2, k)};
  e1 = {row(tc, 3, k), row(tc, 4, k), row(tc, 5, k)};
  e2 = {row(tc, 6, k), row(tc, 7, k), row(tc, 8, k)};
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
                   int n_clusters, const float* __restrict__ lights_g, int n_lights,
                   float* __restrict__ out) {
  __shared__ float bounds[kMaxClusters * 32];
  __shared__ float lights[kMaxLights * 6];
  for (int i = threadIdx.x; i < n_clusters * 32; i += blockDim.x) bounds[i] = bounds_g[i];
  for (int i = threadIdx.x; i < n_lights * 6; i += blockDim.x) lights[i] = lights_g[i];
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  V3 o = {rays[i], rays[(size_t)n + i], rays[2 * (size_t)n + i]};
  V3 d = {rays[3 * (size_t)n + i], rays[4 * (size_t)n + i], rays[5 * (size_t)n + i]};
  V3 invd = {inv_safe(d.x), inv_safe(d.y), inv_safe(d.z)};

  // ---- closest hit, with the shading attributes of the winner ----
  float best_t = kMiss;
  V3 ns = {0.0f, 0.0f, 0.0f}, g = {0.0f, 0.0f, 0.0f}, alb = {0.0f, 0.0f, 0.0f};
  for (int c = 0; c < n_clusters; ++c) {
    int s, e;
    if (!cluster_span(bounds + c * 32, o, invd, best_t, s, e)) continue;
    const float* tc = tris + (size_t)c * 9 * kCluster;
    const float* sc = shade + (size_t)c * 12 * kCluster;
    for (int k = s; k < e; ++k) {
      float t, u, v;
      V3 e1, e2;
      if (!mt(tc, k, o, d, best_t, t, u, v, e1, e2)) continue;
      best_t = t;
      float w0 = 1.0f - u - v;
      ns = {w0 * row(sc, 0, k) + u * row(sc, 3, k) + v * row(sc, 6, k),
            w0 * row(sc, 1, k) + u * row(sc, 4, k) + v * row(sc, 7, k),
            w0 * row(sc, 2, k) + u * row(sc, 5, k) + v * row(sc, 8, k)};
      g = cross(e1, e2);
      alb = {row(sc, 9, k), row(sc, 10, k), row(sc, 11, k)};
    }
  }
  bool hit = best_t < kHitLimit;
  ns = normalize(ns);
  g = normalize(g);
  float tt = hit ? best_t : 0.0f;
  V3 p = {o.x + d.x * tt, o.y + d.y * tt, o.z + d.z * tt};
  float cos_i = -dot(ns, d);
  float pscale = fmaxf(fmaxf(fabsf(p.x), fmaxf(fabsf(p.y), fabsf(p.z))), 1.0f);

  // ---- one shadow ray per point light, all summed ----
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
    if (!valid) continue;
    ray_n += 1.0f;
    float off = 1e-4f * pscale * (dot(g, wl) >= 0.0f ? 1.0f : -1.0f);
    V3 so = {p.x + g.x * off, p.y + g.y * off, p.z + g.z * off};
    V3 invwl = {inv_safe(wl.x), inv_safe(wl.y), inv_safe(wl.z)};
    float tmax_s = dist * kShadowShrink;
    bool occ = false;
    for (int c = 0; c < n_clusters && !occ; ++c) {
      int s, e;
      if (!cluster_span(bounds + c * 32, so, invwl, tmax_s, s, e)) continue;
      const float* tc = tris + (size_t)c * 9 * kCluster;
      for (int k = s; k < e; ++k) {
        float t, u, v;
        V3 e1, e2;
        if (mt(tc, k, so, wl, tmax_s, t, u, v, e1, e2)) {
          occ = true;
          break;
        }
      }
    }
    if (occ) continue;
    float lit = cos_o / dist2 * kInvPi;
    L.x = L.x + alb.x * lt[3] * lit;
    L.y = L.y + alb.y * lt[4] * lit;
    L.z = L.z + alb.z * lt[5] * lit;
  }
  out[i] = L.x;
  out[(size_t)n + i] = L.y;
  out[2 * (size_t)n + i] = L.z;
  out[3 * (size_t)n + i] = ray_n;
}

}  // namespace

extern "C" int mesh_direct_launch(const void* rays, int n, const void* bounds,
                                  const void* tris, const void* shade, int n_clusters,
                                  const void* lights, int n_lights, void* out, void* stream) {
  if (n <= 0 || n_clusters <= 0 || n_clusters > kMaxClusters || n_lights <= 0 ||
      n_lights > kMaxLights)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n + kThreads - 1) / kThreads);
  mesh_direct_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rays, n, (const float*)bounds, (const float*)tris, (const float*)shade,
      n_clusters, (const float*)lights, n_lights, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* mesh_direct_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
