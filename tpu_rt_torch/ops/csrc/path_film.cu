// Film path-tracing kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_rt/ops/pallas_path.py::pallas_film_trace,
// whose body is _build_kernel(film=...) in its unrolled form: per pixel,
// for k samples, SplitMix32 jitter, a camera ray from the near plane, then
// up to max_depth bounces (closest-hit sweep over every prim, emitter hit
// with MIS, one NEE light sample with an any-hit shadow ray, BSDF
// sampling, Russian roulette), accumulated into reconstruction-filter
// planes (r, g, b, w per filter offset) plus a ray count.
//
// Design.  One thread per pixel index.  Each thread loops over its
// samples and runs a per-thread depth loop that breaks once the path is
// dead; that equals the TPU's unrolled form, where dead lanes add exact
// zeros and their later random draws are never read.  The filter
// accumulators (4, 36 or 100 floats + the ray count) live in registers
// (the filter radius is a template parameter) and each thread writes its
// column of the (n_acc + 1, H*W) output once at the end.  The scene is not
// compiled into the code as the TPU's Python-float constants were: the
// host packs prims, BSDFs, emitters, point lights, environment and camera
// into one float table plus an int header (layout in path_kernel.py), and
// each block stages the table in shared memory.  The random streams are
// the JAX kernel's SplitMix32 streams bit for bit, keyed on
// (seed + sample, pixel // tile_lanes, pixel % tile_lanes).  The RNG, the
// shading frame and the prim sweep live in common.cuh, shared with the
// ultrasound kernel us_acq.cu.
//
// Clustered-mesh mode (pallas_path.py::_mesh_closest / _mesh_anyhit),
// selected by the header's mesh cluster count, not by another build: a
// scene's non-emissive mesh triangles ride separate tables in global
// memory (bounds, the 12-row Baldwin-Weber rows, the 9-row vertex
// normals; up to 64 clusters, 688 KB), read through the read-only path.
// Each ray's closest hit over the unrolled prims is merged with the mesh's
// (root box, quarter boxes and the live span per ray, as in mesh_direct.cu,
// where the TPU culled whole tiles), giving the interpolated shading normal
// and the geometric one, which the spawn offsets follow; the shadow ray
// also sweeps the mesh.  A dead path never reaches the sweeps, so the TPU's
// collapsed bounds for dead lanes have no counterpart.
//
// What bounds it.  Per ray the kernel reads a few KB of tables from shared
// memory and writes nothing until the end, so it is bound by FP32 ALU work
// (the prim sweep, shading, the special functions) and by warp divergence:
// neighbouring pixels take different BSDF branches and die at different
// depths.  This first form does nothing about divergence beyond keeping
// the state in registers; the wavefront-vs-megakernel question and
// occupancy tuning are left to later work.
//
// Arithmetic follows the plain PyTorch version operation by operation
// (same association order, IEEE division and square root, no fast math);
// build with -fmad=false to keep multiplies and adds separately rounded.

#include "common.cuh"

namespace {

// int32 header
enum {
  HDR_N_PRIMS = 0, HDR_N_AREA = 1, HDR_N_LIGHTS = 2, HDR_MAX_DEPTH = 3,
  HDR_RR_DEPTH = 4, HDR_HIDE_EMITTERS = 5, HDR_HAS_ENV = 6, HDR_HAS_FAR = 7,
  HDR_W = 8, HDR_H = 9, HDR_TILE_LANES = 10, HDR_OFF_PRIM = 11,
  HDR_OFF_BSDF = 12, HDR_OFF_EM = 13, HDR_OFF_PT = 14, HDR_MESH_C = 15, HDR_LEN = 16
};
// float table: global block
enum {
  G_ENV = 0, G_INV_NL = 3, G_NL = 5, G_NL_M1 = 6, G_R = 8,
  G_ORG = 17, G_TFX = 20, G_TFY = 21, G_INVW = 22, G_INVH = 23, G_NEAR = 24,
  G_FAR_NEAR = 25, G_GAUSS_TAIL = 26, G_MESH_BSDF = 27
};
enum { BSDF_STRIDE = 16, EM_STRIDE = 32, PT_STRIDE = 8 };
enum { BSDF_DIFFUSE = 0, BSDF_DIELECTRIC = 1, BSDF_CONDUCTOR = 2 };
constexpr int kMaxTableFloats = 12 * 1024;
constexpr int kThreads = 128;

constexpr float kInvPi = (float)(1.0 / kPi);
constexpr float kPi4 = (float)(kPi / 4.0);
constexpr float kPi2 = (float)(kPi / 2.0);
constexpr float kShadowShrink = (float)(1.0 - 1e-3);

__device__ __forceinline__ float mis(float pdf_a, float pdf_b) {
  float a2 = pdf_a * pdf_a;
  float w = a2 / fmaxf(a2 + pdf_b * pdf_b, 1e-20f);
  return pdf_a > 0.0f ? w : 0.0f;
}

struct Scene {
  const float* g;
  const float* prims;
  const float* bsdfs;
  const float* ems;
  const float* pts;
  // mesh tables: bounds (C, 32), Baldwin-Weber rows (C, 12, 128), vertex
  // normals (C, 9, 128); mesh_c == 0 without a mesh
  const float* mesh_bounds;
  const float* mesh_trisw;
  const float* mesh_nrm;
  int n_prims, n_area, n_lights, max_depth, rr_depth, W, tile_lanes, mesh_c, mesh_bsdf;
  bool hide_emitters, has_env, has_far;
};

// Merge the mesh's closest hit into (best_t, prim, n): on a mesh hit prim
// becomes n_prims, n the normalised interpolated vertex normal (the
// geometric one where that is ~0) and ng the normalised geometric normal.
__device__ void mesh_closest(const Scene& sc, V3 o, V3 d, float& best_t, int& prim,
                             V3& n, V3& ng) {
  V3 invd = {inv_safe(d.x), inv_safe(d.y), inv_safe(d.z)};
  bool got = false;
  V3 ns_raw, g_raw;
  for (int c = 0; c < sc.mesh_c; ++c) {
    int s, e;
    if (!cluster_span(sc.mesh_bounds + c * 32, o, invd, best_t, s, e)) continue;
    const float* tw = sc.mesh_trisw + (size_t)c * 12 * kCluster;
    const float* nr = sc.mesh_nrm + (size_t)c * 9 * kCluster;
    for (int k = s; k < e; ++k) {
      float t, u, v;
      if (!bw(tw, k, o, d, best_t, kMeshTmin, t, u, v)) continue;
      best_t = t;
      got = true;
      float w0 = 1.0f - u - v;
      ns_raw = {w0 * row(nr, 0, k) + u * row(nr, 3, k) + v * row(nr, 6, k),
                w0 * row(nr, 1, k) + u * row(nr, 4, k) + v * row(nr, 7, k),
                w0 * row(nr, 2, k) + u * row(nr, 5, k) + v * row(nr, 8, k)};
      g_raw = {row(tw, 0, k), row(tw, 1, k), row(tw, 2, k)};
    }
  }
  if (!got) return;
  prim = sc.n_prims;
  ng = normalize(g_raw);
  n = dot(ns_raw, ns_raw) > 1e-12f ? normalize(ns_raw) : ng;
}

// True where the segment (1e-4, tmax) hits a mesh triangle.
__device__ bool mesh_any_hit(const Scene& sc, V3 o, V3 d, float tmax) {
  V3 invd = {inv_safe(d.x), inv_safe(d.y), inv_safe(d.z)};
  for (int c = 0; c < sc.mesh_c; ++c) {
    int s, e;
    if (!cluster_span(sc.mesh_bounds + c * 32, o, invd, tmax, s, e)) continue;
    const float* tw = sc.mesh_trisw + (size_t)c * 12 * kCluster;
    for (int k = s; k < e; ++k) {
      float t, u, v;
      if (bw(tw, k, o, d, tmax, kMeshTmin, t, u, v)) return true;
    }
  }
  return false;
}

// Conductor Fresnel at |cos_f| for one channel (mirror -> 1).
__device__ __forceinline__ float fres_cond(float cos_f, float eta, float k,
                                           bool mirror) {
  float c2 = cos_f * cos_f;
  float s2 = 1.0f - c2;
  float e2 = eta * eta;
  float k2 = k * k;
  float t0 = e2 - k2 - s2;
  float a2b2 = safe_sqrt(t0 * t0 + 4.0f * e2 * k2);
  float t1 = a2b2 + c2;
  float a = safe_sqrt(fmaxf(0.5f * (a2b2 + t0), 0.0f));
  float t2 = 2.0f * a * cos_f;
  float rs = (t1 - t2) / fmaxf(t1 + t2, 1e-12f);
  float t3 = c2 * a2b2 + s2 * s2;
  float t4 = t2 * s2;
  float rp = rs * (t3 - t4) / fmaxf(t3 + t4, 1e-12f);
  return mirror ? 1.0f : 0.5f * (rs + rp);
}

// One path sample of pixel idx: radiance L and the rays it traced.
__device__ void trace_path(const Scene& sc, int idx, float jx, float jy,
                           uint32_t& rng, V3& L, float& ray_count) {
  const float* g = sc.g;
  const float* R = g + G_R;  // rows of to_world[:3, :3]
  int py_i = idx / sc.W;
  float px = (float)(idx - py_i * sc.W);
  float py = (float)py_i;
  float u_img = (px + jx) * g[G_INVW];
  float v_img = (py + jy) * g[G_INVH];
  float cx = (2.0f * u_img - 1.0f) * g[G_TFX];
  float cy = (1.0f - 2.0f * v_img) * g[G_TFY];
  V3 d = normalize({R[0] * cx + R[1] * cy + R[2], R[3] * cx + R[4] * cy + R[5],
                    R[6] * cx + R[7] * cy + R[8]});
  float t_near = g[G_NEAR] * sqrtf(cx * cx + cy * cy + 1.0f);
  V3 o = {g[G_ORG] + t_near * d.x, g[G_ORG + 1] + t_near * d.y,
          g[G_ORG + 2] + t_near * d.z};

  V3 thr = {1.0f, 1.0f, 1.0f};
  L = {0.0f, 0.0f, 0.0f};
  ray_count = 0.0f;
  float prev_pdf = 1.0f, eta_scale = 1.0f;
  bool prev_delta = true;

  for (int depth = 0; depth < sc.max_depth; ++depth) {
    float t;
    V3 n = {0.0f, 0.0f, 0.0f};
    int prim = closest_hit(sc.prims, sc.n_prims, o, d, t, n);
    V3 ng = n;  // the geometric normal, which the spawn offsets follow
    if (sc.mesh_c > 0) mesh_closest(sc, o, d, t, prim, n, ng);
    bool hit = prim >= 0;
    if (sc.has_far && depth == 0) {
      // the origin sits at the near plane: the clip length left is
      // (far - near) * |d_cam|, |d_cam| = 1 / (d . forward)
      float dz = d.x * R[2] + d.y * R[5] + d.z * R[8];
      hit = hit && t <= g[G_FAR_NEAR] / fmaxf(dz, 1e-9f);
    }
    ray_count += 1.0f;
    bool show_em = !(depth == 0 && sc.hide_emitters);
    if (!hit) {
      if (sc.has_env && show_em) {  // BSDF-sampled constant environment
        L.x = L.x + thr.x * g[G_ENV];
        L.y = L.y + thr.y * g[G_ENV + 1];
        L.z = L.z + thr.z * g[G_ENV + 2];
      }
      break;
    }
    bool on_mesh = prim == sc.n_prims;
    const float* prec = sc.prims + prim * PRIM_STRIDE;
    V3 p = {o.x + d.x * t, o.y + d.y * t, o.z + d.z * t};
    V3 wi = {-d.x, -d.y, -d.z};
    float cos_l = dot(n, wi);

    // ---- emitter hit + MIS ----
    int em = on_mesh ? -1 : (int)prec[2];
    if (show_em && em >= 0 && cos_l > 0.0f) {
      const float* er = sc.ems + em * EM_STRIDE;
      float pdf_light = er[3] * t * t / fmaxf(cos_l, 1e-6f) * g[G_INV_NL];
      float w_b = prev_delta ? 1.0f : mis(prev_pdf, pdf_light);
      L.x = L.x + thr.x * er[0] * w_b;
      L.y = L.y + thr.y * er[1] * w_b;
      L.z = L.z + thr.z * er[2] * w_b;
    }

    const float* b = sc.bsdfs + (on_mesh ? sc.mesh_bsdf : (int)prec[1]) * BSDF_STRIDE;
    int btype = (int)b[0];
    V3 s_fr, t_fr;
    frame(n, s_fr, t_fr);
    V3 wi_l = {dot(wi, s_fr), dot(wi, t_fr), dot(wi, n)};
    float cos_i = wi_l.z;
    float u[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) u[k] = rng_next(rng);
    bool is_diffuse = btype == BSDF_DIFFUSE;
    V3 refl = {b[1], b[2], b[3]};

    // ---- NEE: one light sample on diffuse lanes (not on the last bounce) ----
    if (sc.n_lights > 0 && depth + 2 <= sc.max_depth && is_diffuse &&
        cos_i > 0.0f) {
      int li = (int)fminf(floorf(u[0] * g[G_NL]), g[G_NL_M1]);
      V3 lp = {0.0f, 0.0f, 0.0f}, ln = {0.0f, 0.0f, 0.0f}, l_rad;
      float pdf_a;  // area pdf 1/area; 0 marks a delta light
      if (li < sc.n_area) {
        const float* er = sc.ems + li * EM_STRIDE;
        int nt = (int)er[4];
        for (int j = 0; j < nt; ++j) {
          const float* tr = er + 5 + 3 * j;
          if (u[1] >= tr[1] && u[1] < tr[2]) {  // later triangles win ties
            const float* q = sc.prims + (int)tr[0] * PRIM_STRIDE + 4;
            float st = safe_sqrt(1.0f - u[2]);
            float ub = 1.0f - st;
            float vb = st * u[3];
            lp = {q[0] + ub * q[3] + vb * q[6], q[1] + ub * q[4] + vb * q[7],
                  q[2] + ub * q[5] + vb * q[8]};
            ln = {q[9], q[10], q[11]};
          }
        }
        l_rad = {er[0], er[1], er[2]};
        pdf_a = er[3];
      } else {
        const float* pt = sc.pts + (li - sc.n_area) * PT_STRIDE;
        lp = {pt[0], pt[1], pt[2]};
        l_rad = {pt[3], pt[4], pt[5]};
        pdf_a = 0.0f;
      }
      V3 to_l = {lp.x - p.x, lp.y - p.y, lp.z - p.z};
      float dist2 = fmaxf(dot(to_l, to_l), 1e-20f);
      float dist = sqrtf(dist2);
      V3 wl = scale(to_l, 1.0f / dist);
      float cos_sl = dot(n, wl);
      float cos_ll = -dot(wl, ln);
      bool is_delta = pdf_a == 0.0f;
      if (cos_sl > 0.0f && (is_delta || cos_ll > 1e-6f)) {
        ray_count += 1.0f;
        float off = 1e-4f * (dot(ng, wl) >= 0.0f ? 1.0f : -1.0f);
        V3 so = {p.x + ng.x * off, p.y + ng.y * off, p.z + ng.z * off};
        float tmax = dist * kShadowShrink;
        if (!any_hit(sc.prims, sc.n_prims, so, wl, tmax) &&
            !(sc.mesh_c > 0 && mesh_any_hit(sc, so, wl, tmax))) {
          float pdf_nee = is_delta ? g[G_INV_NL]
                                   : pdf_a * dist2 / fmaxf(cos_ll, 1e-6f) * g[G_INV_NL];
          float fs = kInvPi * fmaxf(cos_sl, 0.0f);
          float pdf_bsdf = fmaxf(cos_sl, 0.0f) * kInvPi;
          float sc_w = is_delta ? g[G_NL] / dist2
                                : mis(pdf_nee, pdf_bsdf) / fmaxf(pdf_nee, 1e-20f);
          L.x = L.x + thr.x * (refl.x * fs) * l_rad.x * sc_w;
          L.y = L.y + thr.y * (refl.y * fs) * l_rad.y * sc_w;
          L.z = L.z + thr.z * (refl.z * fs) * l_rad.z * sc_w;
        }
      }
    }

    // ---- BSDF sampling ----
    V3 wo_l, w_s;
    float pdf_s, eta_s = 1.0f;
    bool valid, delta;
    if (is_diffuse) {  // cosine hemisphere via the concentric disk
      float sx = 2.0f * u[4] - 1.0f;
      float sy = 2.0f * u[5] - 1.0f;
      bool quad_x = fabsf(sx) > fabsf(sy);
      float r_d = quad_x ? sx : sy;
      float safe_sx = sx == 0.0f ? 1.0f : sx;
      float safe_sy = sy == 0.0f ? 1.0f : sy;
      float phi = quad_x ? kPi4 * (sy / safe_sx) : kPi2 - kPi4 * (sx / safe_sy);
      if (sx == 0.0f && sy == 0.0f) phi = 0.0f;
      float dx = r_d * cosf(phi);
      float dy = r_d * sinf(phi);
      float dz = safe_sqrt(1.0f - dx * dx - dy * dy);
      float sign_i = cos_i == 0.0f ? 1.0f : (cos_i > 0.0f ? 1.0f : -1.0f);
      wo_l = {dx * sign_i, dy * sign_i, dz * sign_i};
      pdf_s = fabsf(dz) * kInvPi;
      w_s = refl;
      valid = cos_i > 0.0f;
      delta = false;
    } else if (btype == BSDF_DIELECTRIC) {  // Fresnel pick: reflect or refract
      float eta_rel = b[4];
      float eta_it = cos_i >= 0.0f ? eta_rel : 1.0f / eta_rel;
      float eta_ti = 1.0f / eta_it;
      float c2t = 1.0f - eta_ti * eta_ti * (1.0f - cos_i * cos_i);
      float abs_ci = fabsf(cos_i);
      float ct = safe_sqrt(c2t);
      float rs = (abs_ci - eta_it * ct) / fmaxf(abs_ci + eta_it * ct, 1e-9f);
      float rp = (eta_it * abs_ci - ct) / fmaxf(eta_it * abs_ci + ct, 1e-9f);
      float F = c2t <= 0.0f ? 1.0f : 0.5f * (rs * rs + rp * rp);
      bool pick_refl = u[6] <= F;
      float ct_signed = cos_i >= 0.0f ? -ct : ct;
      if (pick_refl) {
        wo_l = {-wi_l.x, -wi_l.y, wi_l.z};
        w_s = {1.0f, 1.0f, 1.0f};
        pdf_s = F;
      } else {
        wo_l = {-eta_ti * wi_l.x, -eta_ti * wi_l.y, ct_signed};
        float w = eta_ti * eta_ti;
        w_s = {w, w, w};
        pdf_s = 1.0f - F;
        eta_s = eta_it;
      }
      valid = true;
      delta = true;
    } else {  // smooth conductor: mirror reflection
      float cf = fabsf(cos_i);
      bool mirror = b[11] != 0.0f;
      wo_l = {-wi_l.x, -wi_l.y, wi_l.z};
      w_s = {fres_cond(cf, b[5], b[8], mirror) * b[12],
             fres_cond(cf, b[6], b[9], mirror) * b[13],
             fres_cond(cf, b[7], b[10], mirror) * b[14]};
      pdf_s = 1.0f;
      valid = cos_i > 0.0f;
      delta = true;
    }

    V3 d_new = normalize(to_world(n, s_fr, t_fr, wo_l));
    float off = 1e-4f * (dot(ng, d_new) >= 0.0f ? 1.0f : -1.0f);
    V3 o_new = {p.x + ng.x * off, p.y + ng.y * off, p.z + ng.z * off};
    V3 thr_new = {thr.x * w_s.x, thr.y * w_s.y, thr.z * w_s.z};
    eta_scale = eta_scale * eta_s;
    float thr_max = fmaxf(thr_new.x, fmaxf(thr_new.y, thr_new.z));
    bool alive = valid && pdf_s > 0.0f && thr_max > 0.0f;
    if (depth >= sc.rr_depth) {
      float u_rr = rng_next(rng);
      float inv_e2 = 1.0f / fmaxf(eta_scale * eta_scale, 1e-12f);
      float q = fminf(thr_max * inv_e2, 0.95f);
      float inv_q = 1.0f / fmaxf(q, 1e-12f);
      thr_new = scale(thr_new, inv_q);
      alive = alive && u_rr < q;
    }
    if (!alive) break;
    o = o_new;
    d = d_new;
    thr = thr_new;
    prev_pdf = pdf_s;
    prev_delta = delta;
  }
}

// 1-D filter weight at pixel offset dd for in-pixel jitter j.
template <int R>
__device__ __forceinline__ float film_w1d(int dd, float j, float gauss_tail) {
  float x = ((float)dd + 0.5f) - j;
  if constexpr (R == 1) return fmaxf(0.0f, 1.0f - fabsf(x));
  float gw = expf(-2.0f * x * x) - gauss_tail;
  return fabsf(x) <= 2.0f ? fmaxf(0.0f, gw) : 0.0f;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
path_film_kernel(const int* __restrict__ hdr_g, const float* __restrict__ tab_g,
                 int n_tab, const float* __restrict__ mesh, float* __restrict__ out,
                 int n_pix, int seed, int n_samples) {
  extern __shared__ float tab[];
  __shared__ int hdr[HDR_LEN];
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) tab[i] = tab_g[i];
  for (int i = threadIdx.x; i < HDR_LEN; i += blockDim.x) hdr[i] = hdr_g[i];
  __syncthreads();
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_pix) return;

  Scene sc;
  sc.g = tab;
  sc.prims = tab + hdr[HDR_OFF_PRIM];
  sc.bsdfs = tab + hdr[HDR_OFF_BSDF];
  sc.ems = tab + hdr[HDR_OFF_EM];
  sc.pts = tab + hdr[HDR_OFF_PT];
  sc.n_prims = hdr[HDR_N_PRIMS];
  sc.n_area = hdr[HDR_N_AREA];
  sc.n_lights = hdr[HDR_N_LIGHTS];
  sc.max_depth = hdr[HDR_MAX_DEPTH];
  sc.rr_depth = hdr[HDR_RR_DEPTH];
  sc.W = hdr[HDR_W];
  sc.tile_lanes = hdr[HDR_TILE_LANES];
  sc.hide_emitters = hdr[HDR_HIDE_EMITTERS] != 0;
  sc.has_env = hdr[HDR_HAS_ENV] != 0;
  sc.has_far = hdr[HDR_HAS_FAR] != 0;
  sc.mesh_c = hdr[HDR_MESH_C];
  sc.mesh_bsdf = (int)tab[G_MESH_BSDF];
  sc.mesh_bounds = mesh;
  sc.mesh_trisw = mesh + (size_t)sc.mesh_c * 32;
  sc.mesh_nrm = sc.mesh_trisw + (size_t)sc.mesh_c * 12 * kCluster;

  constexpr int kFoot = 2 * R + 1;
  constexpr int kAcc = kFoot * kFoot * 4;
  float acc[kAcc + 1];
#pragma unroll
  for (int i = 0; i <= kAcc; ++i) acc[i] = 0.0f;
  uint32_t tile = (uint32_t)(idx / sc.tile_lanes);
  uint32_t lane = (uint32_t)(idx % sc.tile_lanes);
  float gauss_tail = tab[G_GAUSS_TAIL];

  for (int i = 0; i < n_samples; ++i) {
    // sample i of a launch seeded s draws the stream of seed s + i
    uint32_t rng = rng_init((uint32_t)seed + (uint32_t)i, tile, lane);
    float jx = rng_next(rng);
    float jy = rng_next(rng);
    V3 L;
    float rc;
    trace_path(sc, idx, jx, jy, rng, L, rc);
    // non-finite samples are left out of value and weight
    bool ok = isfinite(L.x) && isfinite(L.y) && isfinite(L.z);
    float okf = ok ? 1.0f : 0.0f;
    float vr = ok ? L.x : 0.0f, vg = ok ? L.y : 0.0f, vb = ok ? L.z : 0.0f;
    if constexpr (R == 0) {
      acc[0] += vr;
      acc[1] += vg;
      acc[2] += vb;
      acc[3] += okf;
    } else {
      float wx[kFoot], wy[kFoot];
#pragma unroll
      for (int k = 0; k < kFoot; ++k) {
        wx[k] = film_w1d<R>(k - R, jx, gauss_tail);
        wy[k] = film_w1d<R>(k - R, jy, gauss_tail);
      }
#pragma unroll
      for (int a = 0; a < kFoot; ++a) {
#pragma unroll
        for (int c = 0; c < kFoot; ++c) {
          float w = wy[a] * wx[c] * okf;
          float* slot = acc + (a * kFoot + c) * 4;
          slot[0] += w * vr;
          slot[1] += w * vg;
          slot[2] += w * vb;
          slot[3] += w;
        }
      }
    }
    acc[kAcc] += rc;
  }
#pragma unroll
  for (int i = 0; i <= kAcc; ++i) out[(size_t)i * n_pix + idx] = acc[i];
}

}  // namespace

extern "C" int path_film_launch(const void* hdr, int n_hdr, const void* tab,
                                int n_tab, const void* mesh, int n_mesh, void* out,
                                int n_pix, int seed, int n_samples, int radius,
                                void* stream) {
  if (n_hdr < HDR_LEN || n_tab <= 0 || n_tab > kMaxTableFloats || n_pix <= 0 ||
      n_samples < 1 || n_mesh < 0 || (n_mesh > 0 && mesh == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 grid((n_pix + kThreads - 1) / kThreads);
  size_t smem = (size_t)n_tab * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  const int* h = (const int*)hdr;
  const float* t = (const float*)tab;
  const float* m = (const float*)mesh;
  float* o = (float*)out;
  switch (radius) {
    case 0:
      path_film_kernel<0><<<grid, kThreads, smem, s>>>(h, t, n_tab, m, o, n_pix, seed,
                                                         n_samples);
      break;
    case 1:
      path_film_kernel<1><<<grid, kThreads, smem, s>>>(h, t, n_tab, m, o, n_pix, seed,
                                                         n_samples);
      break;
    case 2:
      path_film_kernel<2><<<grid, kThreads, smem, s>>>(h, t, n_tab, m, o, n_pix, seed,
                                                         n_samples);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* path_film_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
