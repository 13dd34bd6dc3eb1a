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
// distance tmax (N), the scalar tmin, and the cluster range [c0, c1) of the
// bounds (C, 32: root box, triangle count, four quarter boxes) and the
// 12-row Baldwin-Weber table (C, 12, 128).  Outputs (N each): t, the table
// lane c * 128 + k of the hit (-1 on a miss, where t stays tmax), u, v.
// The segments of the TPU form were an SMEM limit; here a segment is a
// cluster range, so a call over [0, C) and the chain of calls over
// consecutive ranges (each taking the last t as its tmax) give the same
// bits.
//
// Design.  One thread per ray walks the clusters in table order.  Each ray
// culls its own work (common.cuh::cluster_span: the root box, then the
// contiguous span of live quarter boxes, against its running best), where
// the TPU culled whole ray tiles with host live lists; it tests that
// span's triangles with the Baldwin-Weber form (common.cuh::bw, shared
// with the film kernel's mesh mode) and keeps a strictly smaller t, so of
// two triangles at the same distance the lower lane wins, as in the plain
// version (mesh_kernel.py::mesh_intersect_plain).  The tables stay in
// global memory, read through __ldg: 4.9 MB at 800 clusters, far beyond
// shared memory and resident in the 50 MB L2.
//
// What bounds it.  Per ray the kernel reads a few hundred bytes of its own
// and streams the tables out of L2; it writes 16 bytes.  It is bound by
// FP32 work (the box tests of every cluster, about 150 operations per
// cluster with its quarter boxes, and about 30 per triangle test) and by
// divergence in the triangle loop: neighbouring rays sweep spans of other
// lengths in other clusters.  This first form does nothing about either;
// a BVH over the cluster boxes, a warp-wide cull and an any-hit mode for
// shadow rays are later work.
//
// Arithmetic follows the plain PyTorch version operation by operation;
// build with -fmad=false to keep multiplies and adds separately rounded.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
mesh_isect_kernel(const float* __restrict__ bounds, const float* __restrict__ trisw,
                  int c0, int c1, const float* __restrict__ orig,
                  const float* __restrict__ dir, const float* __restrict__ tmax,
                  float tmin, int n, float* __restrict__ t_out,
                  int* __restrict__ lid_out, float* __restrict__ u_out,
                  float* __restrict__ v_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  V3 o = {orig[3 * i], orig[3 * i + 1], orig[3 * i + 2]};
  V3 d = {dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]};
  V3 invd = {inv_safe(d.x), inv_safe(d.y), inv_safe(d.z)};
  float best_t = tmax[i], best_u = 0.0f, best_v = 0.0f;
  int best_lid = -1;
  for (int c = c0; c < c1; ++c) {
    int s, e;
    if (!cluster_span(bounds + c * 32, o, invd, best_t, s, e, tmin)) continue;
    const float* tw = trisw + (size_t)c * 12 * kCluster;
    for (int k = s; k < e; ++k) {
      float t, u, v;
      if (!bw(tw, k, o, d, best_t, tmin, t, u, v)) continue;
      best_t = t;
      best_u = u;
      best_v = v;
      best_lid = c * kCluster + k;
    }
  }
  t_out[i] = best_t;
  lid_out[i] = best_lid;
  u_out[i] = best_u;
  v_out[i] = best_v;
}

}  // namespace

extern "C" int mesh_isect_launch(const void* bounds, const void* trisw, int c0, int c1,
                                 const void* orig, const void* dir, const void* tmax,
                                 float tmin, int n, void* t_out, void* lid_out, void* u_out,
                                 void* v_out, void* stream) {
  if (n <= 0 || c0 < 0 || c1 < c0 || bounds == nullptr || trisw == nullptr)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n + kThreads - 1) / kThreads);
  mesh_isect_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)bounds, (const float*)trisw, c0, c1, (const float*)orig,
      (const float*)dir, (const float*)tmax, tmin, n, (float*)t_out, (int*)lid_out,
      (float*)u_out, (float*)v_out);
  return (int)cudaGetLastError();
}

extern "C" const char* mesh_isect_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
