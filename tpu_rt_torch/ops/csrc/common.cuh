// Device helpers shared by the film kernel (path_film.cu), the ultrasound
// acquisition kernel (us_acq.cu), the direct mesh kernel (mesh_direct.cu)
// and the mesh-intersect kernel (mesh_isect.cu): float3 arithmetic, the
// SplitMix32 random streams of tpu_rt's Pallas kernels, the shading frame,
// the GGX half vector drawn from the visible normals, the closest-hit /
// any-hit sweep over the packed prim records (triangles, spheres,
// rectangles, cones), the per-ray cull and Baldwin-Weber test of the mesh
// cluster tables, and the walk of K7 and K9 through the clusters' cull
// hierarchy with a group of lanes a ray.
//
// The prim record layout (PRIM_STRIDE floats: kind, bsdf, emitter, pad,
// then the shape's data) is written by path_kernel.py::pack_prims.
// Arithmetic follows the plain PyTorch versions operation by operation;
// build with -fmad=false to keep multiplies and adds separately rounded.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum { PRIM_STRIDE = 20 };
enum { KIND_TRI = 0, KIND_SPHERE = 1, KIND_RECT = 2, KIND_CONE = 3 };
constexpr double kPi = 3.14159265358979323846;
constexpr float kBig = 1e8f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 normalize(V3 a) {
  return scale(a, 1.0f / sqrtf(fmaxf(dot(a, a), 1e-24f)));
}
__device__ __forceinline__ float safe_sqrt(float x) {
  return sqrtf(fmaxf(x, 1e-20f));
}
__device__ __forceinline__ float clamp_abs(float x, float eps) {
  return fabsf(x) < eps ? (x < 0.0f ? -eps : eps) : x;
}

// Duff et al. branchless orthonormal basis (s, t) around the unit normal n.
__device__ __forceinline__ void frame(V3 n, V3& s, V3& t) {
  float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  float a = -(1.0f / (sign + n.z));
  float b = n.x * n.y * a;
  s = {1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x};
  t = {b, sign + n.y * n.y * a, -n.y};
}
// Local (s, t, n) coordinates to world.
__device__ __forceinline__ V3 to_world(V3 n, V3 s, V3 t, V3 v) {
  return {s.x * v.x + t.x * v.y + n.x * v.z, s.y * v.x + t.y * v.y + n.y * v.z,
          s.z * v.x + t.z * v.y + n.z * v.z};
}

// SplitMix32 (tpu_rt/ops/pallas_path.py::_rng_init / _rng_next)
__device__ __forceinline__ uint32_t rng_init(uint32_t seed, uint32_t tile,
                                             uint32_t lane) {
  uint32_t s = seed * 0x9E3779B9u + tile * 0x85EBCA6Bu + lane * 0xC2B2AE35u +
               0x165667B1u;
  s = (s ^ (s >> 16)) * 0x7FEB352Du;
  s = (s ^ (s >> 15)) * 0x846CA68Bu;
  s = s ^ (s >> 16);
  return s | 1u;
}
__device__ __forceinline__ float rng_next(uint32_t& state) {
  state += 0x9E3779B9u;
  uint32_t z = state;
  z = (z ^ (z >> 16)) * 0x21F0AAADu;
  z = (z ^ (z >> 15)) * 0x735A2D97u;
  z = z ^ (z >> 15);
  return __uint_as_float((z >> 9) | 0x3F800000u) - 1.0f;
}

// A GGX half vector drawn from the distribution of visible normals (Heitz's
// spherical cap) in the local frame, two-sided: wi is flipped into the
// upper hemisphere (flip = +-1) and the half vector flipped back.  The
// rough conductor of path_film.cu and the acoustic BSDF of us_acq.cu draw
// it the same way (path_kernel.py::_vndf_half).  vndf_half_disk takes the
// disk sample (p1h, p2h) = sqrt(u_a) (cos, sin)(2 pi u_b) drawn already:
// the film kernel draws it where it draws the diffuse lobe's.
__device__ __forceinline__ V3 vndf_half_disk(V3 wi_l, float alpha, float p1h, float p2h,
                                             float& flip) {
  flip = wi_l.z >= 0.0f ? 1.0f : -1.0f;
  V3 wif = scale(wi_l, flip);
  V3 vh = normalize({alpha * wif.x, alpha * wif.y, wif.z});
  float lensq = vh.x * vh.x + vh.y * vh.y;
  float inv_len = 1.0f / sqrtf(fmaxf(lensq, 1e-20f));
  bool big = lensq > 1e-20f;
  V3 t1v = {big ? -vh.y * inv_len : 1.0f, big ? vh.x * inv_len : 0.0f, 0.0f};
  V3 t2v = cross(vh, t1v);
  float s_h = 0.5f * (1.0f + vh.z);
  p2h = (1.0f - s_h) * safe_sqrt(1.0f - p1h * p1h) + s_h * p2h;
  V3 nh = add(add(scale(t1v, p1h), scale(t2v, p2h)),
              scale(vh, safe_sqrt(1.0f - p1h * p1h - p2h * p2h)));
  return scale(normalize({alpha * nh.x, alpha * nh.y, fmaxf(nh.z, 1e-6f)}), flip);
}
__device__ __forceinline__ V3 vndf_half(V3 wi_l, float alpha, float u_a, float u_b,
                                        float& flip) {
  float r_h = sqrtf(fmaxf(u_a, 0.0f));
  float phi_h = (float)(2.0 * kPi) * u_b;
  return vndf_half_disk(wi_l, alpha, r_h * cosf(phi_h), r_h * sinf(phi_h), flip);
}

// A ray in the object space of a cone record, whose q[0..11] are the rows
// m0, m1, m2 of to_object.
struct ObjRay {
  float ox, oy, oz, dx, dy, dz;
};
__device__ __forceinline__ ObjRay to_object(const float* q, V3 o, V3 d) {
  const float* m0 = q;
  const float* m1 = q + 4;
  const float* m2 = q + 8;
  return {m0[0] * o.x + m0[1] * o.y + m0[2] * o.z + m0[3],
          m1[0] * o.x + m1[1] * o.y + m1[2] * o.z + m1[3],
          m2[0] * o.x + m2[1] * o.y + m2[2] * o.z + m2[3],
          m0[0] * d.x + m0[1] * d.y + m0[2] * d.z,
          m1[0] * d.x + m1[1] * d.y + m1[2] * d.z,
          m2[0] * d.x + m2[1] * d.y + m2[2] * d.z};
}

// One prim's intersection test: hit or not, and the hit distance t.  kCone
// compiles the cone test in; the film kernel leaves it out for scenes
// without one, since the extra branch in its sweep loop slowed K1 on the
// cbox by 18% (PERF.md).
template <bool kCone = true>
__device__ __forceinline__ bool intersect(const float* rec, V3 o, V3 d,
                                          float tmin, float tmax, float& t) {
  const float* q = rec + 4;
  int kind = (int)rec[0];
  if (kind == KIND_TRI) {
    V3 p0 = {q[0], q[1], q[2]}, e1 = {q[3], q[4], q[5]}, e2 = {q[6], q[7], q[8]};
    V3 pv = cross(d, e2);
    float det = e1.x * pv.x + e1.y * pv.y + e1.z * pv.z;
    float inv = 1.0f / clamp_abs(det, 1e-9f);
    V3 tv = {o.x - p0.x, o.y - p0.y, o.z - p0.z};
    float u = (tv.x * pv.x + tv.y * pv.y + tv.z * pv.z) * inv;
    V3 qv = cross(tv, e1);
    float v = dot(d, qv) * inv;
    t = (e2.x * qv.x + e2.y * qv.y + e2.z * qv.z) * inv;
    return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin && t < tmax;
  }
  if (kind == KIND_SPHERE) {
    V3 oc = {o.x - q[0], o.y - q[1], o.z - q[2]};
    float b2 = dot(oc, d);
    float cc = dot(oc, oc) - q[3];
    float dd = dot(d, d);
    float disc = b2 * b2 - cc * dd;
    float sq = safe_sqrt(disc);
    float t0 = (-b2 - sq) / dd;
    float t1 = (-b2 + sq) / dd;
    t = (t0 > tmin && t0 < tmax) ? t0 : t1;
    return disc >= 0.0f && t > tmin && t < tmax;
  }
  if (kCone && kind == KIND_CONE) {
    // the unit cone x^2 + y^2 = (1 - z)^2, z in [0, 1]: the nearer root on
    // the cone's height inside (tmin, tmax), else the farther; |a| >= 1e-12
    ObjRay r = to_object(q, o, d);
    float kk = 1.0f - r.oz;
    float a = r.dx * r.dx + r.dy * r.dy - r.dz * r.dz;
    float b = 2.0f * (r.ox * r.dx + r.oy * r.dy + kk * r.dz);
    float c = r.ox * r.ox + r.oy * r.oy - kk * kk;
    float disc = b * b - 4.0f * a * c;
    float sq = safe_sqrt(disc);
    float a2 = 2.0f * clamp_abs(a, 1e-12f);
    float r0 = (-b - sq) / a2;
    float r1 = (-b + sq) / a2;
    float tn = fminf(r0, r1);
    float tf = fmaxf(r0, r1);
    float zn = r.oz + tn * r.dz;
    float zf = r.oz + tf * r.dz;
    bool vn = disc >= 0.0f && tn > tmin && tn < tmax && zn >= 0.0f && zn <= 1.0f;
    bool vf = disc >= 0.0f && tf > tmin && tf < tmax && zf >= 0.0f && zf <= 1.0f;
    t = vn ? tn : tf;
    return vn || vf;
  }
  // rectangle: rows m0, m1, m2 of to_object
  const float* m0 = q;
  const float* m1 = q + 4;
  const float* m2 = q + 8;
  float ozp = m2[0] * o.x + m2[1] * o.y + m2[2] * o.z + m2[3];
  float dzp = m2[0] * d.x + m2[1] * d.y + m2[2] * d.z;
  t = -ozp / clamp_abs(dzp, 1e-9f);
  float oxp = m0[0] * o.x + m0[1] * o.y + m0[2] * o.z + m0[3];
  float dxp = m0[0] * d.x + m0[1] * d.y + m0[2] * d.z;
  float oyp = m1[0] * o.x + m1[1] * o.y + m1[2] * o.z + m1[3];
  float dyp = m1[0] * d.x + m1[1] * d.y + m1[2] * d.z;
  float xh = oxp + t * dxp;
  float yh = oyp + t * dyp;
  return fabsf(dzp) > 1e-12f && t > tmin && t < tmax && fabsf(xh) <= 1.0f &&
         fabsf(yh) <= 1.0f;
}

template <bool kCone = true>
__device__ __forceinline__ V3 prim_normal(const float* rec, V3 o, V3 d, float t) {
  const float* q = rec + 4;
  int kind = (int)rec[0];
  if (kind == KIND_TRI) return {q[9], q[10], q[11]};
  if (kind == KIND_SPHERE)
    return {(o.x + t * d.x - q[0]) * q[4], (o.y + t * d.y - q[1]) * q[4],
            (o.z + t * d.z - q[2]) * q[4]};
  if (kCone && kind == KIND_CONE) {  // the object normal (x, y, 1 - z) through M_obj^T
    ObjRay r = to_object(q, o, d);
    float xh = r.ox + t * r.dx;
    float yh = r.oy + t * r.dy;
    float zh = 1.0f - (r.oz + t * r.dz);
    return normalize({q[0] * xh + q[4] * yh + q[8] * zh, q[1] * xh + q[5] * yh + q[9] * zh,
                      q[2] * xh + q[6] * yh + q[10] * zh});
  }
  return {q[12], q[13], q[14]};
}

// Closest hit: returns the prim index or -1; t and the normal by reference.
template <bool kCone = true>
__device__ int closest_hit(const float* prims, int n_prims, V3 o, V3 d,
                           float& best_t, V3& n) {
  best_t = kBig;
  int best = -1;
  for (int pi = 0; pi < n_prims; ++pi) {
    float t;
    if (intersect<kCone>(prims + pi * PRIM_STRIDE, o, d, 1e-4f, kBig, t) && t < best_t) {
      best_t = t;
      best = pi;
    }
  }
  if (best >= 0) n = prim_normal<kCone>(prims + best * PRIM_STRIDE, o, d, best_t);
  return best;
}

template <bool kCone = true>
__device__ bool any_hit(const float* prims, int n_prims, V3 o, V3 d, float tmax) {
  for (int pi = 0; pi < n_prims; ++pi) {
    float t;
    if (intersect<kCone>(prims + pi * PRIM_STRIDE, o, d, 1e-4f, tmax, t) && t < kBig)
      return true;
  }
  return false;
}

// ---- mesh cluster tables (ops/mesh_kernel.py::build_clusters) ----
// A cluster is up to kCluster triangles stored in rows of kCluster floats;
// its bounds row (32 floats) holds the cluster box (cols 0-5), the
// triangle count (col 6) and four quarter boxes (cols 8-31).

constexpr int kCluster = 128;
constexpr float kMeshTmin = 1e-4f;

// 1 / x with |x| kept >= 1e-12: the slab test's safe reciprocal.
__device__ __forceinline__ float inv_safe(float x) { return 1.0f / clamp_abs(x, 1e-12f); }

__device__ __forceinline__ float row(const float* __restrict__ base, int r, int k) {
  return __ldg(base + r * kCluster + k);
}

// Slab test of the box b[0..5] (min xyz, max xyz) against [tmin, best_t].
__device__ __forceinline__ bool slab(const float* b, V3 o, V3 invd, float best_t,
                                     float tmin = kMeshTmin) {
  float t0x = (b[0] - o.x) * invd.x;
  float t1x = (b[3] - o.x) * invd.x;
  float t0y = (b[1] - o.y) * invd.y;
  float t1y = (b[4] - o.y) * invd.y;
  float t0z = (b[2] - o.z) * invd.z;
  float t1z = (b[5] - o.z) * invd.z;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), tmin));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fminf(fmaxf(t0z, t1z), best_t));
  return tn <= tf;
}

// The triangles of one cluster a ray sweeps: none unless the cluster box
// passes, else the contiguous span [s, e) of the live quarter boxes
// (quarter q holds triangles [q*k/4, (q+1)*k/4)); mesh_kernel.py::
// cluster_candidates is the same cull in PyTorch.
__device__ __forceinline__ bool cluster_span(const float* b, V3 o, V3 invd, float best_t,
                                             int& s, int& e, float tmin = kMeshTmin) {
  if (!slab(b, o, invd, best_t, tmin)) return false;
  bool l0 = slab(b + 8, o, invd, best_t, tmin), l1 = slab(b + 14, o, invd, best_t, tmin);
  bool l2 = slab(b + 20, o, invd, best_t, tmin), l3 = slab(b + 26, o, invd, best_t, tmin);
  int k = (int)b[6];
  int q1 = k / 4, q2 = k / 2, q3 = (3 * k) / 4;
  s = l0 ? 0 : (l1 ? q1 : (l2 ? q2 : q3));
  e = l3 ? k : (l2 ? q3 : (l1 ? q2 : q1));
  return l0 || l1 || l2 || l3;
}

// Baldwin-Weber test (pallas_mesh.py intersect_one_bw, pallas_path.py
// _mesh_bw_one) against lane k of a cluster's 12-row table: n = e1 x e2,
// p0, then the barycentric rows r1, r2.  A hit lies in (tmin, bt).
// mesh_kernel.py::bw_test is the same test in PyTorch.
__device__ __forceinline__ bool bw(const float* __restrict__ tw, int k, V3 o, V3 d,
                                   float bt, float tmin, float& t, float& u, float& v) {
  float nx = row(tw, 0, k), ny = row(tw, 1, k), nz = row(tw, 2, k);
  float tvx = o.x - row(tw, 3, k);
  float tvy = o.y - row(tw, 4, k);
  float tvz = o.z - row(tw, 5, k);
  float den = nx * d.x + ny * d.y + nz * d.z;
  t = -(nx * tvx + ny * tvy + nz * tvz) / clamp_abs(den, 1e-12f);
  float qx = tvx + t * d.x;
  float qy = tvy + t * d.y;
  float qz = tvz + t * d.z;
  u = row(tw, 6, k) * qx + row(tw, 7, k) * qy + row(tw, 8, k) * qz;
  v = row(tw, 9, k) * qx + row(tw, 10, k) * qy + row(tw, 11, k) * qz;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin && t < bt;
}

// ---- the cull hierarchy over contiguous cluster ranges (K7, K9) ----
// mesh_kernel.py::build_cluster_tree: an implicit tree of branching
// 8 = 2^kTreeLog2 over the R real clusters in table order; node j of
// level l covers the clusters [j 8^l, (j + 1) 8^l) with the exact float32
// min / max of their root boxes.  Header rows 0-1 (16 floats): R, the
// level count L (at most 8), kTreeLog2 (the wrappers check it), 0, then
// the row offset of each level 1 .. L; node rows of 8 floats (min xyz,
// max xyz, 0, 0).  K1's mesh mode does not use it.

constexpr int kTreeLog2 = 3;
constexpr int kTreeMaxLevels = 8;

struct ClusterTree {
  int real, levels;
  int off[kTreeMaxLevels + 1];
};

// The header of a cluster tree, staged in shared memory by one thread.
__device__ __forceinline__ void load_tree_header(const float* __restrict__ tree,
                                                 ClusterTree& h) {
  h.real = (int)tree[0];
  h.levels = (int)tree[1];
  for (int l = 1; l <= kTreeMaxLevels; ++l) h.off[l] = l <= h.levels ? (int)tree[3 + l] : 0;
}

// The mask of the children of the level-lvl node starting at cluster base
// whose boxes the ray passes against [tmin, bt] (at level 1 the children
// are clusters: their root boxes), those outside [c0, cend) left out.  A
// group of kGroup lanes splits the tests and ORs the bits.
template <int kGroup>
__device__ __forceinline__ unsigned children_mask(const float* __restrict__ bounds,
                                                  const float* __restrict__ tree,
                                                  const ClusterTree& h, int lvl, int base,
                                                  int c0, int cend, V3 o, V3 invd, float bt,
                                                  float tmin, int sub, unsigned gmask) {
  const int width = 1 << ((lvl - 1) * kTreeLog2);
  unsigned mine = 0;
  for (int j = sub; j < (1 << kTreeLog2); j += kGroup) {
    int cs = base + j * width;
    if (cs >= cend || cs + width <= c0) continue;
    const float* box =
        lvl == 1 ? bounds + cs * 32
                 : tree + (size_t)(h.off[lvl - 1] + (cs >> ((lvl - 1) * kTreeLog2))) * 8;
    if (slab(box, o, invd, bt, tmin)) mine |= 1u << j;
  }
#pragma unroll
  for (int m = kGroup / 2; m > 0; m >>= 1) mine |= __shfl_xor_sync(gmask, mine, m, kGroup);
  return mine;
}

// The walk of K7 and K9 over the clusters [c0, cend), which a ray's group
// of lanes makes together: depth first, left to right in table order, a
// node's 8 children tested at once when the walk enters it.  They are
// tested against the best distance at the parent's entry, which is no
// smaller than the one the walk holds when it reaches each child; the
// tests are monotone in best_t and a node's box holds its clusters' boxes,
// so a child that fails here covers only clusters whose root boxes fail at
// their turn, and one that passes here but would fail at its turn covers
// only clusters whose quarter boxes all fail at their turn.  At each
// cluster the quarter boxes are tested against the running best, giving
// the span of common.cuh::cluster_span (an empty span where the root box
// fails), and span(c, s, e) tests its triangles, returning true to end
// the walk (an any-hit query).  So the triangles tested, their order and
// every best_t are the plain walk's (mesh_kernel.py::
// mesh_intersect_plain).  Each level keeps a mask of its untested
// children, 8 bits a level of a 64-bit word.
template <int kGroup, typename Span>
__device__ __forceinline__ void wide_walk(const float* __restrict__ bounds,
                                          const float* __restrict__ tree, const ClusterTree& h,
                                          int c0, int cend, V3 o, V3 invd, const float& best_t,
                                          float tmin, int sub, unsigned gmask, Span&& span) {
  const int top = h.levels > 0 ? h.levels : 1;
  if (h.levels > 0 && !slab(tree + (size_t)h.off[top] * 8, o, invd, best_t, tmin)) return;
  unsigned long long masks = (unsigned long long)children_mask<kGroup>(
      bounds, tree, h, top, 0, c0, cend, o, invd, best_t, tmin, sub, gmask) << (8 * (top - 1));
  int lvl = top, base = 0;
  for (;;) {
    unsigned m = (unsigned)(masks >> (8 * (lvl - 1))) & 0xffu;
    if (m == 0) {
      if (++lvl > top) return;
      base &= ~((1 << (lvl * kTreeLog2)) - 1);
      continue;
    }
    int j = __ffs(m) - 1;
    masks &= ~(1ull << (8 * (lvl - 1) + j));
    int cs = base + (j << ((lvl - 1) * kTreeLog2));
    if (lvl > 1) {  // enter the child node
      --lvl;
      base = cs;
      masks |= (unsigned long long)children_mask<kGroup>(bounds, tree, h, lvl, base, c0, cend,
                                                         o, invd, best_t, tmin, sub, gmask)
               << (8 * (lvl - 1));
      continue;
    }
    // cluster cs: its quarter boxes against the running best
    const float* b = bounds + cs * 32;
    unsigned q = 0;
    for (int qi = sub; qi < 4; qi += kGroup)
      if (slab(b + 8 + 6 * qi, o, invd, best_t, tmin)) q |= 1u << qi;
#pragma unroll
    for (int mm = kGroup / 2; mm > 0; mm >>= 1) q |= __shfl_xor_sync(gmask, q, mm, kGroup);
    if (q == 0) continue;
    int k = (int)b[6];
    int q1 = k / 4, q2 = k / 2, q3 = (3 * k) / 4;
    int s = (q & 1) ? 0 : ((q & 2) ? q1 : ((q & 4) ? q2 : q3));
    int e = (q & 8) ? k : ((q & 4) ? q3 : ((q & 2) ? q2 : q1));
    if (span(cs, s, e)) return;
  }
}

// ---- span tests shared by a group of lanes (K7, K9) ----
// A ray's kGroup lanes (a power of two, consecutive lanes of one warp)
// walk the same clusters with the same best distance and split each span
// among themselves, lane j taking triangles s + j, s + j + kGroup, ...

// The mask of this lane's group.
template <int kGroup>
__device__ __forceinline__ unsigned group_mask(int lane) {
  return kGroup == 32 ? 0xffffffffu : ((1u << kGroup) - 1u) << (lane & ~(kGroup - 1));
}

// The lexicographic minimum of (t, k) over the group; lanes without a hit
// hold (inf, INT_MAX).  Ties in t go to the lowest k: the triangle a
// sequential sweep with a strict t < best keeps (mesh_kernel.first_min).
template <int kGroup>
__device__ __forceinline__ void group_min_tk(unsigned mask, float& t, int& k) {
#pragma unroll
  for (int m = kGroup / 2; m > 0; m >>= 1) {
    float ot = __shfl_xor_sync(mask, t, m, kGroup);
    int ok = __shfl_xor_sync(mask, k, m, kGroup);
    if (ot < t || (ot == t && ok < k)) {
      t = ot;
      k = ok;
    }
  }
}

}  // namespace
