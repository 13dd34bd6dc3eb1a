// Clustered mesh-intersect kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels tpu_rt/ops/pallas_mesh.py::_mesh_sweep (K7,
// one SMEM-resident table segment per call, chained through tmax) and
// _mesh_sweep_fused (K8, every segment in one call, the same output): the
// closest hit of N rays over the mesh cluster tables, which the wavefront
// path tracer (geometry/trace.py) asks for at every bounce and for every
// shadow ray of a mesh scene.
//
// Inputs: origins and directions (N, 3) float32, the incoming best
// distance tmax (N), the scalar tmin, the cluster range [c0, c1) of the
// bounds (C, 32: root box, triangle count, four quarter boxes), the
// 12-row Baldwin-Weber table (C, 12, 128) and the cull hierarchy over the
// cluster boxes (mesh_kernel.py::build_cluster_tree).  Outputs (N each):
// t, the table lane c * 128 + k of the hit (-1 on a miss, where t stays
// tmax), u, v.  The segments of the TPU form were an SMEM limit; here a
// segment is a cluster range, so a call over [0, C) and the chain of calls
// over consecutive ranges (each taking the last t as its tmax) give the
// same bits.
//
// What bounds it.  Per ray the kernel reads a few hundred bytes of its own
// and streams the tables out of L2 (4.9 MB at 800 clusters); it writes 16
// bytes.  The work a ray needs is small: at mesh_big_gi's 800 clusters a
// primary passes about 1.2 cluster boxes and tests about 55 triangles.  A
// wave of 65 536 rays is 2 048 warps, some 16 on each of the 132 SMs, too
// few to hide the latency of a walk in which each step waits on the last:
// one thread a ray testing all 800 root boxes in turn ran at a few percent
// of its bound (PERF.md).
//
// Design.  A group of kGroup consecutive lanes takes one ray, so a wave
// fills the SMs kGroup times over, and the group walks the clusters in
// table order, as the plain version (mesh_kernel.py::
// mesh_intersect_plain) does, through a cull hierarchy over contiguous
// cluster ranges (common.cuh::wide_walk): the children of a node are
// tested at once, one a lane, and a node that fails skips its clusters.
// At a cluster the four quarter boxes give the span [s, e), as in the
// plain version; the group splits it (lane j takes triangles s + j,
// s + j + kGroup, ..., each keeping a strictly smaller t, the loads of one
// row coalesced) and the lexicographic minimum of (t, k) over the group
// (common.cuh::group_min_tk) is the triangle the sequential strict-<
// sweep keeps.  The tables stay in global memory, read through the
// read-only path, and stay in L2.  kGroup is 16: tools/ab_isect.py's
// runs kept it over 2, 4, 8 and 32 lanes a ray (PERF.md).
//
// Arithmetic follows the plain PyTorch version operation by operation;
// build with -fmad=false to keep multiplies and adds separately rounded.

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 16;  // lanes a ray
static_assert(kGroup > 1 && kGroup <= 32 && (kGroup & (kGroup - 1)) == 0, "a warp's lanes");

__global__ void __launch_bounds__(kThreads)
mesh_isect_kernel(const float* __restrict__ bounds, const float* __restrict__ trisw,
                  const float* __restrict__ tree, int c0, int c1,
                  const float* __restrict__ orig, const float* __restrict__ dir,
                  const float* __restrict__ tmax, float tmin, int n,
                  float* __restrict__ t_out, int* __restrict__ lid_out,
                  float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ ClusterTree h;
  if (threadIdx.x == 0) load_tree_header(tree, h);
  __syncthreads();
  int i = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;  // a group's lanes share a ray
  if (i >= n) return;
  const int lane = threadIdx.x & 31, sub = lane & (kGroup - 1);
  const unsigned gmask = group_mask<kGroup>(lane);
  V3 o = {orig[3 * i], orig[3 * i + 1], orig[3 * i + 2]};
  V3 d = {dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]};
  V3 invd = {inv_safe(d.x), inv_safe(d.y), inv_safe(d.z)};
  float best_t = tmax[i], best_u = 0.0f, best_v = 0.0f;
  int best_lid = -1;

  // the span [s, e) of cluster cc: this lane's share swept in order
  // against a running best, then the group's lexicographic minimum of (t, k)
  auto sweep = [&](int cc, int s, int e) -> bool {
    const float* tw = trisw + (size_t)cc * 12 * kCluster;
    float lt = best_t, lu = 0.0f, lv = 0.0f;
    int lk = INT_MAX;
    for (int k = s + sub; k < e; k += kGroup) {
      float t, u, v;
      if (!bw(tw, k, o, d, lt, tmin, t, u, v)) continue;
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
    best_lid = cc * kCluster + gk;
    return false;
  };
  // pads (count 0) hold no triangle: the walk ends at the real clusters
  wide_walk<kGroup>(bounds, tree, h, c0, min(c1, h.real), o, invd, best_t, tmin, sub, gmask,
                    sweep);
  if (sub != 0) return;
  t_out[i] = best_t;
  lid_out[i] = best_lid;
  u_out[i] = best_u;
  v_out[i] = best_v;
}

}  // namespace

extern "C" int mesh_isect_launch(const void* bounds, const void* trisw, const void* tree,
                                 int c0, int c1, const void* orig, const void* dir,
                                 const void* tmax, float tmin, int n, void* t_out,
                                 void* lid_out, void* u_out, void* v_out, void* stream) {
  if (n <= 0 || c0 < 0 || c1 < c0 || bounds == nullptr || trisw == nullptr || tree == nullptr)
    return (int)cudaErrorInvalidValue;
  long long threads = (long long)n * kGroup;
  if (threads >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  mesh_isect_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)bounds, (const float*)trisw, (const float*)tree, c0, c1,
      (const float*)orig, (const float*)dir, (const float*)tmax, tmin, n, (float*)t_out,
      (int*)lid_out, (float*)u_out, (float*)v_out);
  return (int)cudaGetLastError();
}

extern "C" const char* mesh_isect_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
