// Film path-tracing kernels for NVIDIA Hopper (sm_90a).
//
// Replaces these TPU kernels of tpu_rt/ops/pallas_path.py, all bodies of
// _build_kernel:
//   K1  pallas_film_trace, film mode, unrolled form: per pixel, for k
//       samples, SplitMix32 jitter, a camera ray from the near plane, then
//       up to max_depth bounces (closest-hit sweep over every prim,
//       emitter hit with MIS, one NEE light sample with an any-hit shadow
//       ray, BSDF sampling, Russian roulette), accumulated into
//       reconstruction-filter planes (r, g, b, w per filter offset) plus a
//       ray count;
//   K3  the same call with stokes=...: full Mueller transport, 13 planes
//       per offset (12 Stokes values and the weight); here K6's kernel
//       traces its samples and film_splat adds the first 13 of K6's 15
//       planes a sample, which are K3's records;
//   K2  the same call with regen=True (_regen_loop): K1 (or K3) with the
//       sample and depth loops flattened into one loop, a lane restarting
//       on its next sample as soon as its path ends; here K1's alone (K3
//       traces a thread a sample, below);
//   K6  pallas_stokes_trace: one polarized sample a pixel, its 12 Stokes
//       values, ray count and jitter; here a chunk of such samples a launch;
//   K5  pallas_raygen_trace: one scalar camera sample a pixel, its
//       radiance, ray count and jitter, and on a textured environment the
//       path's escape record (direction and throughput where it left the
//       scene; the lat-long lookup runs after the kernel); here a chunk of
//       samples a launch;
//   K4  pallas_path_trace: K5's bounce loop on rays passed in, one sample a
//       lane, no jitter and no far-plane clip; here a chunk of samples of
//       each ray a launch, one seed each.
// One file, one bounce: bounce<Stokes, Esc, RoughCone> below serves all six,
// selected by template flags, so no second copy of the transport exists.
// The bounce has every lane of the JAX kernel's: diffuse, smooth
// dielectric, smooth conductor, the GGX rough conductor, and the
// pass-through lane (a polarizer, its intensity fallback of weight 0.5 x
// transmittance, or a null BSDF sends the ray straight on as a delta lobe,
// and in the Stokes form acts as a neutral attenuator); the sweep
// (common.cuh) takes triangles, spheres, rectangles and cones.
//
// The rough conductor (pallas_path.py:1263-1313, 1387-1477, 1524-1602,
// 1635).  Its BSDF sample draws a half vector from the visible normals
// (common.cuh::vndf_half_disk, from the bounce's u7, u8), mirrors wi about it
// and weighs F(cos_im) G2 / G1 with a real pdf, so the lobe is not delta and
// emitter hits after it are weighed by MIS; its NEE evaluates
// spec F(cos_ih) D G2 / (4 cos_i) toward the light with the VNDF pdf on
// the BSDF side of MIS, and in the Stokes form chains the specular Mueller
// matrix through the NEE scattering plane (only T's first column is
// read).  As tpu_rt compiles that code only for a scene that has a rough
// conductor (its static has_rough), the kRoughCone template flag carries
// it, together with the cone test of the prim sweep (on the TPU a sweep
// unrolls only the prims a scene has; here the cone branch in the sweep
// loop alone slowed K1 on the cbox by 18%).  The header's rough-cone flag
// picks the instantiation at launch, so a scene with neither runs the code
// it ran before the two lanes existed.
//
// Design.  K1 runs one thread per pixel index over the launch's samples;
// K3 one thread per (pixel, sample), the sample in blockIdx.y: K6's kernel.
// Each sample runs a depth loop that breaks once the path is dead; that
// equals the TPU's unrolled form, where dead lanes add exact zeros and
// their later random draws are never read.  K2's form of K1 steps one
// bounce an iteration at the lane's own depth and, when the path ends
// (dead, roulette, depth cap), finishes the sample, re-keys the RNG to
// seed + (sample index) and starts the next one: a warp then waits for its
// longest per-lane total instead of, at every sample, its longest path.
// K3 ran so too, a thread a pixel in K2's loop, and starved the H100: at
// cbox_pol's 256^2 a launch was 512 blocks of 128 threads, 4 blocks a
// multiprocessor at its 128 registers, so less than one wave on 132
// multiprocessors and at most 16 warps on each, every lane a serial chain
// of 64 samples of up to 16 bounces with the Mueller chain: 14.7 ms a
// 64-sample launch, where K6, the same bounce with a thread a sample, took
// 9.9 ms.  K6's planes are a sample's S row-major, its ray count and its
// jitter, laid out [plane][sample][pixel] as the film records are, keyed on
// the same streams (seed + sample, tile, lane): their first 13 are K3's
// records bit for bit, so K3 launches K6 and film_splat reads those 13
// (two more floats a sample written, about 0.01 ms a 64-sample launch).
//
// Two launches.  The TPU kernel splats each sample into filter planes it
// holds in VMEM.  A thread here would hold them in registers, 4, 36 or 100
// floats for K1 and 13, 117 or 325 for K3, and K3's gaussian footprint
// spilled to local memory at 255 registers, two blocks a multiprocessor.
// So the trace kernel holds no accumulator: it writes each finished
// sample's record (its values and ray count, [value][sample][pixel]) to
// global memory, and film_splat, a second kernel, adds a chunk of records
// onto the planes with one thread per (pixel, filter offset row).  film_splat
// adds each accumulator's samples in sample order with the plain version's
// arithmetic, so the planes are bit-equal to the plain version's and K2's
// to the per-sample form's; the wrapper streams a launch in chunks of at
// most 64 samples, each continuing the stored sums exactly.  Without the
// accumulators each trace kernel takes the register cap that ran fastest
// (kFilmMinBlocks, kStokesSampleMinBlocks); the Stokes state stays in
// registers, which ran as fast as a shared-memory slab on cbox_pol and
// faster on cbox_pol_rough.
//
// The scene is not compiled into the code as the TPU's Python-float
// constants were: the host packs prims, BSDFs, emitters, point lights,
// environment and camera into one float table plus an int header (layout
// in path_kernel.py), and each block stages the table in shared memory.
// The random streams are the JAX kernel's SplitMix32 streams bit for bit,
// keyed on (seed + sample, pixel // tile_lanes, pixel % tile_lanes).  The
// RNG, the shading frame and the prim sweep live in common.cuh, shared with
// the ultrasound kernel us_acq.cu.
//
// Polarized transport (pallas_path.py:1024-1039, 1194-1233, 1439-1477,
// 1616-1709).  A Stokes lane carries T (3, 4, 4), the camera-side Mueller
// matrix per RGB channel, the Stokes basis and S (4, 3).  Every emission it
// meets adds Le * T[:, :, 0] (emitters are unpolarized); diffuse NEE is
// depolarizing, so its contribution is T[:, 0] * w, and rough-conductor NEE
// adds the first column of T R(phi) M through the light's scattering plane.
// Each bounce chains T <- T R(phi) M with M the interaction's sparse
// Mueller matrix per channel (m00, m01, m10, m11, mc, ms), M00-normalized
// to the scalar sampling weight; cos 2 phi and sin 2 phi come from dot and
// cross products, with no trig.  The scalar throughput keeps running: it
// drives roulette.  Fresnel amplitudes of conductors (and of dielectric
// reflection, which covers total internal reflection) are complex,
// spelled out in (re, im) pairs.
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
// What bounds them.  Per ray the trace kernels read a few KB of tables
// from shared memory and write a record of 4 (K1) or 15 (K3 / K6) floats a
// sample, so they are bound by FP32 ALU work (the prim sweep, shading, the
// special functions), by warp divergence (neighbouring pixels take
// different BSDF branches and die at different depths) and by how many
// warps their registers let a multiprocessor hold to hide the latency.
// K3 / K6 add the Mueller chain (about 266 operations a bounce) and its
// 63-float Stokes state.  K2 removes K1's per-sample wait at the depth
// loop; a thread a sample (K3 / K6, K5, K4) has no such wait, and fills
// the card with independent samples.  Neither does anything about
// divergence inside a bounce.  film_splat is bound by the records' bytes.
// K6 writes 15 planes a sample.  K6, K5 and K4 trace a chunk of samples a
// launch (at the kernels, below).  K1 with a thread a sample, and a
// wavefront or persistent-thread design across pixels, are left to later
// work.
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
  HDR_OFF_BSDF = 12, HDR_OFF_EM = 13, HDR_OFF_PT = 14, HDR_MESH_C = 15,
  HDR_STOKES = 16, HDR_REGEN = 17, HDR_ENV_TEXTURED = 18, HDR_ROUGH_CONE = 19, HDR_LEN = 20
};  // HDR_STOKES, HDR_REGEN and HDR_ROUGH_CONE are the host's: mode, regen and
    // rough_cone are launch arguments
// float table: global block
enum {
  G_ENV = 0, G_INV_NL = 3, G_NL = 5, G_NL_M1 = 6, G_R = 8,
  G_ORG = 17, G_TFX = 20, G_TFY = 21, G_INVW = 22, G_INVH = 23, G_NEAR = 24,
  G_FAR_NEAR = 25, G_GAUSS_TAIL = 26, G_MESH_BSDF = 27, G_CAM_X = 28
};
enum { BSDF_STRIDE = 16, EM_STRIDE = 32, PT_STRIDE = 8 };
enum { BSDF_DIFFUSE = 0, BSDF_DIELECTRIC = 1, BSDF_CONDUCTOR = 2, BSDF_ROUGH_CONDUCTOR = 3,
       BSDF_POLARIZER = 4, BSDF_NULL = 6 };
enum { B_ALPHA = 15 };  // a rough conductor's GGX alpha in its BSDF record
// launch modes (path_kernel.py _MODE_*); K3's trace is a MODE_STOKES_SAMPLE
// launch
enum { MODE_FILM = 0, MODE_STOKES_SAMPLE = 1, MODE_RAYGEN_SAMPLE = 2, MODE_RAYS_SAMPLE = 3 };
constexpr int kMaxTableFloats = 12 * 1024;
constexpr int kThreads = 128;
constexpr int kMaxChunk = 65535;  // a launch's samples in the grid: gridDim.y

constexpr float kInvPi = (float)(1.0 / kPi);
constexpr float kPiF = (float)kPi;
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
  bool hide_emitters, has_env, has_far, env_textured;
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

// GGX D of an upper-hemisphere half vector, the cancellation-free form.
__device__ __forceinline__ float ggx_d_up(float cz, float alpha) {
  float c2 = cz * cz;
  float s2 = fmaxf(1.0f - c2, 0.0f);
  float a2 = alpha * alpha;
  float den = a2 * c2 + s2;
  float dd = a2 / fmaxf(kPiF * den * den, 1e-18f);
  return cz > 0.0f ? dd : 0.0f;
}

// Smith G1 of isotropic GGX at the local cosine cz: zero below the surface,
// or with two_sided only at cz == 0 (the sampled lobe, cz after the flip).
__device__ __forceinline__ float ggx_g1(float cz, float alpha, bool two_sided = false) {
  float tan2 = fmaxf(1.0f - cz * cz, 0.0f) / fmaxf(cz * cz, 1e-12f);
  float lam = 0.5f * (safe_sqrt(1.0f + alpha * alpha * tan2) - 1.0f);
  return (two_sided ? cz != 0.0f : cz > 0.0f) ? 1.0f / (1.0f + lam) : 0.0f;
}

// ---- polarized transport (path_kernel.py _perp_basis ... _mueller_chain) ----

// ref projected perpendicular to the unit w and normalized; the
// deterministic horizontal basis where that is degenerate.
__device__ V3 perp_basis(V3 w, V3 ref) {
  float dp = dot(w, ref);
  V3 proj = {ref.x - w.x * dp, ref.y - w.y * dp, ref.z - w.z * dp};
  float ln2 = dot(proj, proj);
  if (ln2 > 1e-12f) return scale(proj, 1.0f / sqrtf(fmaxf(ln2, 1e-24f)));
  float ax = fabsf(w.x) > 0.9f ? 0.0f : 1.0f;
  return normalize(cross({ax, 1.0f - ax, 0.0f}, w));
}

// (ar + i ai) / (br + i bi)
__device__ __forceinline__ void cdiv(float ar, float ai, float br, float bi, float& re,
                                     float& im) {
  float den = fmaxf(br * br + bi * bi, 1e-30f);
  re = (ar * br + ai * bi) / den;
  im = (ai * br - ar * bi) / den;
}

// Fresnel reflection's polarization terms for the complex relative IOR
// e_re + i e_im at |cos_f|: a = (|rs|^2 + |rp|^2) / 2, b = (|rs|^2 -
// |rp|^2) / 2, c + i s = rs conj(rp).
__device__ void fres_pol(float cos_f, float e_re, float e_im, float& a, float& b, float& c,
                         float& s) {
  float cf = fabsf(cos_f);
  float sin2 = fmaxf(1.0f - cf * cf, 0.0f);
  float zr = e_re * e_re - e_im * e_im - sin2;
  float zi = 2.0f * e_re * e_im;
  float mag = sqrtf(fmaxf(zr * zr + zi * zi, 0.0f));
  float u = sqrtf(fmaxf(0.5f * (mag + zr), 0.0f));
  float v = sqrtf(fmaxf(0.5f * (mag - zr), 0.0f));
  float rs_r, rs_i, rp_r, rp_i;
  cdiv(cf - u, -v, cf + u, v, rs_r, rs_i);
  float e2r = (zr + sin2) * cf;
  float e2i = zi * cf;
  cdiv(e2r - u, e2i - v, e2r + u, e2i + v, rp_r, rp_i);
  float Rs = rs_r * rs_r + rs_i * rs_i;
  float Rp = rp_r * rp_r + rp_i * rp_i;
  a = 0.5f * (Rs + Rp);
  b = 0.5f * (Rs - Rp);
  c = rs_r * rp_r + rs_i * rp_i;
  s = rs_i * rp_r - rs_r * rp_i;
}

// The Stokes state of a lane.
struct Pol {
  float T[3][4][4];  // camera-side Mueller matrix per channel
  float S[4][3];     // Stokes radiance, (I, Q, U, V) x rgb
  V3 basis;          // carried Stokes basis
};

// S += Le * T[:, :, 0] for unpolarized emission of weight w[ch].
__device__ __forceinline__ void add_emission(Pol& q, const float w[3]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) q.S[i][ch] = q.S[i][ch] + q.T[ch][i][0] * w[ch];
  }
}

// The rotation R(phi) that turns the carried basis onto the scattering
// plane's s axis around pB: cos 2 phi and sin 2 phi, the s axis and whether
// the plane is degenerate.
__device__ __forceinline__ void chain_rotation(V3 basis, V3 pB, V3 pA, float& C2, float& S2,
                                               V3& s_axis, bool& degen) {
  V3 s_raw = cross(pA, pB);
  float ln2 = dot(s_raw, s_raw);
  degen = ln2 < 1e-12f;
  s_axis = degen ? perp_basis(pB, basis) : scale(s_raw, 1.0f / sqrtf(fmaxf(ln2, 1e-24f)));
  float cs = dot(s_axis, basis);
  float sn = dot(cross(s_axis, basis), pB);
  float n2 = fmaxf(cs * cs + sn * sn, 1e-20f);
  C2 = (cs * cs - sn * sn) / n2;
  S2 = 2.0f * cs * sn / n2;
}

// T <- T R(phi) M, M per channel (m00, m01, m10, m11, mc, ms); phi turns
// the carried basis onto the scattering plane's s axis around pB.
__device__ void mueller_chain(Pol& q, V3 pB, V3 pA, float M6[3][6]) {
  float C2, S2;
  V3 s_axis;
  bool degen;
  chain_rotation(q.basis, pB, pA, C2, S2, s_axis, degen);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float* m = &M6[ch][0];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* t = q.T[ch][i];
      float t0 = t[0], t1 = t[1], t2 = t[2], t3 = t[3];
      float rot_a = t1 * C2 - t2 * S2;
      float rot_b = t1 * S2 + t2 * C2;
      t[0] = t0 * m[0] + rot_a * m[2];
      t[1] = t0 * m[1] + rot_a * m[3];
      t[2] = rot_b * m[4] - t3 * m[5];
      t[3] = rot_b * m[5] + t3 * m[4];
    }
  }
  q.basis = degen ? perp_basis(pA, s_axis) : s_axis;
}

// The scalar state of one path sample; esc_d and esc_thr, the escape
// record, are K4's and K5's only.
struct Path {
  V3 o, d, thr, L;
  float prev_pdf, eta_scale, ray_count;
  bool prev_delta;
  V3 esc_d, esc_thr;
};

// A fresh sample of pixel idx with in-pixel jitter (jx, jy): the camera
// ray from the near plane, and for a Stokes lane T = I, S = 0 and the
// camera's x axis projected perpendicular to the ray as the basis.
template <bool kStokes>
__device__ void start_sample(const Scene& sc, int idx, float jx, float jy, Path& p, Pol& q) {
  const float* g = sc.g;
  const float* R = g + G_R;  // rows of to_world[:3, :3]
  int py_i = idx / sc.W;
  float px = (float)(idx - py_i * sc.W);
  float py = (float)py_i;
  float u_img = (px + jx) * g[G_INVW];
  float v_img = (py + jy) * g[G_INVH];
  float cx = (2.0f * u_img - 1.0f) * g[G_TFX];
  float cy = (1.0f - 2.0f * v_img) * g[G_TFY];
  p.d = normalize({R[0] * cx + R[1] * cy + R[2], R[3] * cx + R[4] * cy + R[5],
                   R[6] * cx + R[7] * cy + R[8]});
  float t_near = g[G_NEAR] * sqrtf(cx * cx + cy * cy + 1.0f);
  p.o = {g[G_ORG] + t_near * p.d.x, g[G_ORG + 1] + t_near * p.d.y,
         g[G_ORG + 2] + t_near * p.d.z};
  p.thr = {1.0f, 1.0f, 1.0f};
  p.L = {0.0f, 0.0f, 0.0f};
  p.ray_count = 0.0f;
  p.prev_pdf = 1.0f;
  p.eta_scale = 1.0f;
  p.prev_delta = true;
  if constexpr (kStokes) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) q.T[ch][i][j] = i == j ? 1.0f : 0.0f;
        q.S[i][ch] = 0.0f;
      }
    }
    q.basis = perp_basis(scale(p.d, -1.0f), {g[G_CAM_X], g[G_CAM_X + 1], g[G_CAM_X + 2]});
  }
}

// One bounce of the sample at depth `depth` (sweep, emitter hit + MIS, one
// NEE sample with a shadow ray, BSDF sampling, Russian roulette).  Returns
// whether the path goes on.  K1 accumulates L; a Stokes lane accumulates S
// instead and chains its Mueller matrix.  With kEsc (K4, K5) an escaping
// path records its direction and throughput: a path escapes once, on the
// bounce where it dies, so the record is written before the return.
// With kRoughCone the rough conductor's lane (NEE and sampling) and the
// sweep's cone test are compiled in.
template <bool kStokes, bool kEsc = false, bool kRoughCone = false>
__device__ bool bounce(const Scene& sc, int depth, uint32_t& rng, Path& p, Pol& q) {
  const float* g = sc.g;
  const float* R = g + G_R;
  V3 o = p.o, d = p.d, thr = p.thr;
  float t;
  V3 n = {0.0f, 0.0f, 0.0f};
  int prim = closest_hit<kRoughCone>(sc.prims, sc.n_prims, o, d, t, n);
  V3 ng = n;  // the geometric normal, which the spawn offsets follow
  if (sc.mesh_c > 0) mesh_closest(sc, o, d, t, prim, n, ng);
  bool hit = prim >= 0;
  if (sc.has_far && depth == 0) {
    // the origin sits at the near plane: the clip length left is
    // (far - near) * |d_cam|, |d_cam| = 1 / (d . forward)
    float dz = d.x * R[2] + d.y * R[5] + d.z * R[8];
    hit = hit && t <= g[G_FAR_NEAR] / fmaxf(dz, 1e-9f);
  }
  p.ray_count += 1.0f;
  bool show_em = !(depth == 0 && sc.hide_emitters);
  if (!hit) {
    if (sc.has_env && show_em) {  // BSDF-sampled constant environment
      if constexpr (kStokes) {
        add_emission(q, g + G_ENV);
      } else {
        p.L.x = p.L.x + thr.x * g[G_ENV];
        p.L.y = p.L.y + thr.y * g[G_ENV + 1];
        p.L.z = p.L.z + thr.z * g[G_ENV + 2];
      }
    }
    if constexpr (kEsc) {
      if (show_em) {
        p.esc_d = d;
        p.esc_thr = thr;
      }
    }
    return false;
  }
  bool on_mesh = prim == sc.n_prims;
  const float* prec = sc.prims + prim * PRIM_STRIDE;
  V3 ph = {o.x + d.x * t, o.y + d.y * t, o.z + d.z * t};
  V3 wi = {-d.x, -d.y, -d.z};
  float cos_l = dot(n, wi);

  // ---- emitter hit + MIS ----
  int em = on_mesh ? -1 : (int)prec[2];
  if (show_em && em >= 0 && cos_l > 0.0f) {
    const float* er = sc.ems + em * EM_STRIDE;
    float pdf_light = er[3] * t * t / fmaxf(cos_l, 1e-6f) * g[G_INV_NL];
    float w_b = p.prev_delta ? 1.0f : mis(p.prev_pdf, pdf_light);
    if constexpr (kStokes) {
      float w[3] = {er[0], er[1], er[2]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          q.S[i][ch] = q.S[i][ch] + q.T[ch][i][0] * w[ch] * w_b;
      }
    } else {
      p.L.x = p.L.x + thr.x * er[0] * w_b;
      p.L.y = p.L.y + thr.y * er[1] * w_b;
      p.L.z = p.L.z + thr.z * er[2] * w_b;
    }
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
  bool is_rough = kRoughCone && btype == BSDF_ROUGH_CONDUCTOR;
  V3 refl = {b[1], b[2], b[3]};

  // ---- NEE: one light sample on diffuse and rough-conductor lanes (not on
  // the last bounce) ----
  if (sc.n_lights > 0 && depth + 2 <= sc.max_depth && (is_diffuse || is_rough) &&
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
          const float* qv = sc.prims + (int)tr[0] * PRIM_STRIDE + 4;
          float st = safe_sqrt(1.0f - u[2]);
          float ub = 1.0f - st;
          float vb = st * u[3];
          lp = {qv[0] + ub * qv[3] + vb * qv[6], qv[1] + ub * qv[4] + vb * qv[7],
                qv[2] + ub * qv[5] + vb * qv[8]};
          ln = {qv[9], qv[10], qv[11]};
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
    V3 to_l = {lp.x - ph.x, lp.y - ph.y, lp.z - ph.z};
    float dist2 = fmaxf(dot(to_l, to_l), 1e-20f);
    float dist = sqrtf(dist2);
    V3 wl = scale(to_l, 1.0f / dist);
    float cos_sl = dot(n, wl);
    float cos_ll = -dot(wl, ln);
    bool is_delta = pdf_a == 0.0f;
    if (cos_sl > 0.0f && (is_delta || cos_ll > 1e-6f)) {
      p.ray_count += 1.0f;
      float off = 1e-4f * (dot(ng, wl) >= 0.0f ? 1.0f : -1.0f);
      V3 so = {ph.x + ng.x * off, ph.y + ng.y * off, ph.z + ng.z * off};
      float tmax = dist * kShadowShrink;
      if (!any_hit<kRoughCone>(sc.prims, sc.n_prims, so, wl, tmax) &&
          !(sc.mesh_c > 0 && mesh_any_hit(sc, so, wl, tmax))) {
        float pdf_nee = is_delta ? g[G_INV_NL]
                                 : pdf_a * dist2 / fmaxf(cos_ll, 1e-6f) * g[G_INV_NL];
        float fs = kInvPi * fmaxf(cos_sl, 0.0f);
        float pdf_bsdf = fmaxf(cos_sl, 0.0f) * kInvPi;
        V3 nee_f = {refl.x * fs, refl.y * fs, refl.z * fs};
        float cos_ih = 0.0f;  // the rough lane's |cos| at the half vector
        if (is_rough) {
          // f cos = spec F(cos_ih) D G2 / (4 cos_i), pdf G1(wi) D / (4 cos_i)
          float alpha = b[B_ALPHA];
          bool mirror = b[11] != 0.0f;
          V3 wl_l = {dot(wl, s_fr), dot(wl, t_fr), dot(wl, n)};
          V3 hn = normalize(add(wi_l, wl_l));
          float D = ggx_d_up(hn.z, alpha);
          float g1_i = ggx_g1(cos_i, alpha);
          float base = D * (g1_i * ggx_g1(wl_l.z, alpha)) / fmaxf(4.0f * cos_i, 1e-12f);
          cos_ih = fabsf(dot(wi_l, hn));
          nee_f = {b[12] * fres_cond(cos_ih, b[5], b[8], mirror) * base,
                   b[13] * fres_cond(cos_ih, b[6], b[9], mirror) * base,
                   b[14] * fres_cond(cos_ih, b[7], b[10], mirror) * base};
          pdf_bsdf = g1_i * D / fmaxf(4.0f * cos_i, 1e-12f);
        }
        float sc_w = is_delta ? g[G_NL] / dist2
                              : mis(pdf_nee, pdf_bsdf) / fmaxf(pdf_nee, 1e-20f);
        if constexpr (kStokes) {
          float w[3] = {nee_f.x * l_rad.x * sc_w, nee_f.y * l_rad.y * sc_w,
                        nee_f.z * l_rad.z * sc_w};
          if (is_rough) {
            // T R(phi) M through the light's scattering plane; only the
            // first column reaches S: t0 m00 + (t1 C2 - t2 S2) m10
            float C2, S2;
            V3 s_axis;
            bool degen;
            chain_rotation(q.basis, scale(d, -1.0f), scale(wl, -1.0f), C2, S2, s_axis, degen);
            bool mirror = b[11] != 0.0f;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
              float a, bb, c, s;
              fres_pol(cos_ih, mirror ? 1e6f : b[5 + ch], mirror ? 1e8f : b[8 + ch], a, bb, c, s);
              float m10 = w[ch] * bb * (1.0f / fmaxf(a, 1e-12f));
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float* ti = q.T[ch][i];
                q.S[i][ch] = q.S[i][ch] + (ti[0] * w[ch] + (ti[1] * C2 - ti[2] * S2) * m10);
              }
            }
          } else {
            add_emission(q, w);  // diffuse NEE depolarizes: T[:, 0] w
          }
        } else {
          p.L.x = p.L.x + thr.x * nee_f.x * l_rad.x * sc_w;
          p.L.y = p.L.y + thr.y * nee_f.y * l_rad.y * sc_w;
          p.L.z = p.L.z + thr.z * nee_f.z * l_rad.z * sc_w;
        }
      }
    }
  }

  // ---- BSDF sampling; a Stokes lane also builds its Mueller matrix ----
  V3 wo_l, w_s;
  float pdf_s, eta_s = 1.0f;
  bool valid, delta;
  float M6[3][6];
  // The disk sample a sampled lobe turns into a direction: the diffuse
  // lobe's concentric map of (u4, u5), the rough lobe's VNDF disk (sqrt
  // u7, 2 pi u8).  Its cos and sin run here, once, ahead of the lobes'
  // branches, so that a warp holding both lobes runs them once.
  float r_disk, phi_disk;
  if (is_rough) {
    r_disk = sqrtf(fmaxf(u[7], 0.0f));
    phi_disk = (float)(2.0 * kPi) * u[8];
  } else {
    float sx = 2.0f * u[4] - 1.0f;
    float sy = 2.0f * u[5] - 1.0f;
    bool quad_x = fabsf(sx) > fabsf(sy);
    r_disk = quad_x ? sx : sy;
    float safe_sx = sx == 0.0f ? 1.0f : sx;
    float safe_sy = sy == 0.0f ? 1.0f : sy;
    phi_disk = quad_x ? kPi4 * (sy / safe_sx) : kPi2 - kPi4 * (sx / safe_sy);
    if (sx == 0.0f && sy == 0.0f) phi_disk = 0.0f;
  }
  float disk_x = r_disk * cosf(phi_disk);
  float disk_y = r_disk * sinf(phi_disk);
  if (is_diffuse) {  // cosine hemisphere via the concentric disk
    float dx = disk_x;
    float dy = disk_y;
    float dz = safe_sqrt(1.0f - dx * dx - dy * dy);
    float sign_i = cos_i == 0.0f ? 1.0f : (cos_i > 0.0f ? 1.0f : -1.0f);
    wo_l = {dx * sign_i, dy * sign_i, dz * sign_i};
    pdf_s = fabsf(dz) * kInvPi;
    w_s = refl;
    valid = cos_i > 0.0f;
    delta = false;
    if constexpr (kStokes) {  // depolarizer
      const float wv[3] = {w_s.x, w_s.y, w_s.z};
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        M6[ch][0] = wv[ch];
#pragma unroll
        for (int k = 1; k < 6; ++k) M6[ch][k] = 0.0f;
      }
    }
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
    if constexpr (kStokes) {
      // reflection: the complex form; transmission: real and achromatic
      float rb, rc, rsv;
      if (pick_refl) {
        float a, bb, c, s;
        fres_pol(cos_i, eta_it, 0.0f, a, bb, c, s);
        float inv_a = 1.0f / fmaxf(a, 1e-12f);
        rb = bb * inv_a;
        rc = c * inv_a;
        rsv = s * inv_a;
      } else {
        float ts = 2.0f * abs_ci / fmaxf(abs_ci + eta_it * ct, 1e-9f);
        float tp = 2.0f * abs_ci / fmaxf(eta_it * abs_ci + ct, 1e-9f);
        float Ts = ts * ts, Tp = tp * tp;
        float inv_a = 1.0f / fmaxf(0.5f * (Ts + Tp), 1e-12f);
        rb = 0.5f * (Ts - Tp) * inv_a;
        rc = ts * tp * inv_a;
        rsv = 0.0f;
      }
      const float wv[3] = {w_s.x, w_s.y, w_s.z};
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float w = wv[ch];
        M6[ch][0] = w;
        M6[ch][1] = w * rb;
        M6[ch][2] = w * rb;
        M6[ch][3] = w;
        M6[ch][4] = w * rc;
        M6[ch][5] = w * rsv;
      }
    }
  } else if (btype == BSDF_POLARIZER || btype == BSDF_NULL) {
    // pass-through: straight on with the table's tint (0.5 x transmittance
    // for the polarizer, 1 for null), a delta lobe of eta 1
    wo_l = {-wi_l.x, -wi_l.y, -wi_l.z};
    w_s = {b[1], b[2], b[3]};
    pdf_s = 1.0f;
    valid = true;
    delta = true;
    if constexpr (kStokes) {  // a neutral attenuator
      const float wv[3] = {w_s.x, w_s.y, w_s.z};
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        M6[ch][0] = wv[ch];
        M6[ch][1] = 0.0f;
        M6[ch][2] = 0.0f;
        M6[ch][3] = wv[ch];
        M6[ch][4] = wv[ch];
        M6[ch][5] = 0.0f;
      }
    }
  } else {  // conductor: smooth (mirror reflection) or rough (GGX)
    float cf = fabsf(cos_i);
    bool mirror = b[11] != 0.0f;
    float w_g = 1.0f;  // the rough lobe's G2 / G1
    if (is_rough) {
      // wi mirrored about a VNDF half vector drawn from u7, u8; Fresnel at
      // the half vector; the lobe's pdf G1(wi) D / (4 cos_i), not a delta
      float alpha = b[B_ALPHA];
      float flip;
      V3 mh = vndf_half_disk(wi_l, alpha, disk_x, disk_y, flip);
      float cos_im = dot(wi_l, mh);
      V3 mh2 = scale(mh, 2.0f * cos_im);
      wo_l = {mh2.x - wi_l.x, mh2.y - wi_l.y, mh2.z - wi_l.z};
      float g1_i = ggx_g1(wi_l.z * flip, alpha, true);
      w_g = g1_i * ggx_g1(wo_l.z * flip, alpha, true) / fmaxf(g1_i, 1e-12f);
      cf = fabsf(cos_im);
      pdf_s = ggx_g1(cos_i, alpha) * ggx_d_up(mh.z, alpha) / fmaxf(4.0f * cos_i, 1e-12f);
      valid = cos_i > 0.0f && wo_l.z > 0.0f;
      delta = false;
    } else {
      wo_l = {-wi_l.x, -wi_l.y, wi_l.z};
      pdf_s = 1.0f;
      valid = cos_i > 0.0f;
      delta = true;
    }
    w_s = {fres_cond(cf, b[5], b[8], mirror) * b[12],
           fres_cond(cf, b[6], b[9], mirror) * b[13],
           fres_cond(cf, b[7], b[10], mirror) * b[14]};
    if (is_rough) w_s = scale(w_s, w_g);
    if constexpr (kStokes) {  // complex Fresnel per channel (mirror: 1e6 + 1e8 i)
      const float wv[3] = {w_s.x, w_s.y, w_s.z};
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float a, bb, c, s;
        fres_pol(cf, mirror ? 1e6f : b[5 + ch], mirror ? 1e8f : b[8 + ch], a, bb, c, s);
        float inv_a = 1.0f / fmaxf(a, 1e-12f);
        float w = wv[ch];
        M6[ch][0] = w;
        M6[ch][1] = w * (bb * inv_a);
        M6[ch][2] = w * (bb * inv_a);
        M6[ch][3] = w;
        M6[ch][4] = w * (c * inv_a);
        M6[ch][5] = w * (s * inv_a);
      }
    }
  }

  V3 d_new = normalize(to_world(n, s_fr, t_fr, wo_l));
  float off = 1e-4f * (dot(ng, d_new) >= 0.0f ? 1.0f : -1.0f);
  V3 o_new = {ph.x + ng.x * off, ph.y + ng.y * off, ph.z + ng.z * off};
  V3 thr_new = {thr.x * w_s.x, thr.y * w_s.y, thr.z * w_s.z};
  p.eta_scale = p.eta_scale * eta_s;
  float thr_max = fmaxf(thr_new.x, fmaxf(thr_new.y, thr_new.z));
  bool alive = valid && pdf_s > 0.0f && thr_max > 0.0f;
  if constexpr (kStokes) {
    if (alive) mueller_chain(q, scale(d, -1.0f), scale(d_new, -1.0f), M6);
  }
  if (depth >= sc.rr_depth) {
    float u_rr = rng_next(rng);
    float inv_e2 = 1.0f / fmaxf(p.eta_scale * p.eta_scale, 1e-12f);
    float qr = fminf(thr_max * inv_e2, 0.95f);
    float inv_q = 1.0f / fmaxf(qr, 1e-12f);
    thr_new = scale(thr_new, inv_q);
    alive = alive && u_rr < qr;
    if constexpr (kStokes) {
      if (alive) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) q.T[ch][i][j] = q.T[ch][i][j] * inv_q;
          }
        }
      }
    }
  }
  if (!alive) return false;
  p.o = o_new;
  p.d = d_new;
  p.thr = thr_new;
  p.prev_pdf = pdf_s;
  p.prev_delta = delta;
  return true;
}

// 1-D filter weight at pixel offset dd for in-pixel jitter j.
template <int R>
__device__ __forceinline__ float film_w1d(int dd, float j, float gauss_tail) {
  float x = ((float)dd + 0.5f) - j;
  if constexpr (R == 1) return fmaxf(0.0f, 1.0f - fabsf(x));
  float gw = expf(-2.0f * x * x) - gauss_tail;
  return fabsf(x) <= 2.0f ? fmaxf(0.0f, gw) : 0.0f;
}

// A finished K1 sample's record: its radiance and its ray count, stride
// floats apart.
__device__ __forceinline__ void record(float* r, size_t stride, const Path& p) {
  r[0] = p.L.x;
  r[stride] = p.L.y;
  r[2 * stride] = p.L.z;
  r[3 * stride] = p.ray_count;
}

__device__ __forceinline__ Scene load_scene(const int* hdr, const float* tab,
                                            const float* mesh) {
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
  sc.env_textured = hdr[HDR_ENV_TEXTURED] != 0;
  sc.mesh_c = hdr[HDR_MESH_C];
  sc.mesh_bsdf = (int)tab[G_MESH_BSDF];
  sc.mesh_bounds = mesh;
  sc.mesh_trisw = mesh + (size_t)sc.mesh_c * 32;
  sc.mesh_nrm = sc.mesh_trisw + (size_t)sc.mesh_c * 12 * kCluster;
  return sc;
}

// Each block stages the header and the scene table in shared memory.
#define STAGE_TABLES()                                                          \
  extern __shared__ float tab[];                                                \
  __shared__ int hdr[HDR_LEN];                                                  \
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) tab[i] = tab_g[i];      \
  for (int i = threadIdx.x; i < HDR_LEN; i += blockDim.x) hdr[i] = hdr_g[i];    \
  __syncthreads();                                                              \
  int idx = blockIdx.x * blockDim.x + threadIdx.x;                              \
  if (idx >= n_pix) return;                                                     \
  Scene sc = load_scene(hdr, tab, mesh);                                        \
  uint32_t tile = (uint32_t)(idx / sc.tile_lanes);                              \
  uint32_t lane = (uint32_t)(idx % sc.tile_lanes);

// The blocks of kThreads a multiprocessor must hold for K1, so at most
// 65536 / (kThreads kFilmMinBlocks) registers a thread, from the A/B on the
// H100 in PERF.md §6: without the accumulators K1 runs best at 8 (64
// registers) with a tent or gaussian film and at 4 with a box (kBox); more
// warps to hide the sweep's latency outweigh the spills the caps bring.
template <bool kBox>
constexpr int kFilmMinBlocks = kBox ? 4 : 8;

// K1, in K2's loop when kRegen: the n_samples samples of pixel idx, each
// recorded when it finishes: sample si's radiance and its ray count go to
// rec[(k * n_samples + si) * n_pix + idx] (k = 0 .. 3), laid out
// [value][sample][pixel] so that a warp's stores and film_splat's loads are
// coalesced.  Every lane below n_pix finishes each of its n_samples samples
// once, so every record is written.  The jitter is not recorded:
// film_splat draws it again from the sample's keys.  kRoughCone compiles
// the rough conductor's lane and cones in.
template <bool kBox, bool kRegen, bool kRoughCone>
__global__ void __launch_bounds__(kThreads, kFilmMinBlocks<kBox>)
path_film_kernel(const int* __restrict__ hdr_g, const float* __restrict__ tab_g,
                 int n_tab, const float* __restrict__ mesh, float* __restrict__ rec,
                 int n_pix, int seed, int n_samples) {
  STAGE_TABLES()
  const size_t stride = (size_t)n_samples * n_pix;  // between a record's values
  Path p;
  Pol q;
  // sample i of a launch seeded s draws the stream of seed s + i
  if constexpr (kRegen) {
    // one bounce an iteration at the lane's own depth; a finished sample
    // is recorded and the lane starts its next one at once
    uint32_t rng = rng_init((uint32_t)seed, tile, lane);
    float jx = rng_next(rng);
    float jy = rng_next(rng);
    start_sample<false>(sc, idx, jx, jy, p, q);
    int si = 0, depth = 0;
    while (true) {
      bool alive = bounce<false, false, kRoughCone>(sc, depth, rng, p, q);
      ++depth;
      if (alive && depth < sc.max_depth) continue;
      record(rec + (size_t)si * n_pix + idx, stride, p);
      if (++si >= n_samples) break;
      rng = rng_init((uint32_t)seed + (uint32_t)si, tile, lane);
      jx = rng_next(rng);
      jy = rng_next(rng);
      start_sample<false>(sc, idx, jx, jy, p, q);
      depth = 0;
    }
  } else {
    for (int i = 0; i < n_samples; ++i) {
      uint32_t rng = rng_init((uint32_t)seed + (uint32_t)i, tile, lane);
      float jx = rng_next(rng);
      float jy = rng_next(rng);
      start_sample<false>(sc, idx, jx, jy, p, q);
      for (int depth = 0; depth < sc.max_depth; ++depth)
        if (!bounce<false, false, kRoughCone>(sc, depth, rng, p, q)) break;
      record(rec + (size_t)i * n_pix + idx, stride, p);
    }
  }
}

// film_splat: the records (NV + 1, n_samples, n_pix) of a film launch
// added, in sample order, onto the planes (kFoot^2 (NV + 1) + 1, n_pix),
// with the plain version's arithmetic (path_kernel.py::splat_upd: the
// finiteness mask, film_w1d, w = wy[a] wx[c] okf, slot[k] += w v[k], then
// the ray count), so the planes are bit-equal to its; a launch onto planes
// that hold an earlier chunk's sums continues them exactly.  One thread per
// (pixel, offset row): a block holds kSplatPix pixels (threadIdx.x) by
// kFoot rows (threadIdx.y), so a warp reads one 128-byte line per value
// and sample, which the block's other rows then find in L1, and each
// thread keeps kFoot (NV + 1) accumulators, 65 for K3's gaussian (the
// row-0 thread also the ray count).  Each thread draws the jitter again
// from the sample's keys, rng_init(seed + s, tile, lane), as the trace
// kernel drew it, once for its row (a thread per offset, drawing it and
// reading the record once per offset, took twice as long).  Bound by the
// records' bytes: each is read once from HBM.
template <int R>
constexpr int kSplatPix = R == 0 ? 128 : 32;

template <int R, int NV>
__global__ void __launch_bounds__(kSplatPix<R>*(2 * R + 1))
film_splat_kernel(const float* __restrict__ rec, const float* __restrict__ tab,
                  float* __restrict__ planes, int n_pix, int n_samples, int seed,
                  int tile_lanes) {
  constexpr int kFoot = 2 * R + 1;
  int idx = blockIdx.x * kSplatPix<R> + threadIdx.x;
  if (idx >= n_pix) return;
  const int a = threadIdx.y;  // the offset row: offsets (a - R, c - R), c = 0 .. 2R
  const bool has_rc = a == 0;
  const float gauss_tail = tab[G_GAUSS_TAIL];
  const uint32_t tile = (uint32_t)(idx / tile_lanes), lane = (uint32_t)(idx % tile_lanes);
  const size_t rec_stride = (size_t)n_samples * n_pix;
  float* slot = planes + (size_t)a * kFoot * (NV + 1) * n_pix + idx;
  float* rc_slot = planes + (size_t)kFoot * kFoot * (NV + 1) * n_pix + idx;
  float acc[kFoot][NV + 1];
#pragma unroll
  for (int c = 0; c < kFoot; ++c) {
#pragma unroll
    for (int k = 0; k <= NV; ++k) acc[c][k] = slot[(size_t)(c * (NV + 1) + k) * n_pix];
  }
  float acc_rc = has_rc ? *rc_slot : 0.0f;
  for (int s = 0; s < n_samples; ++s) {
    const float* r = rec + (size_t)s * n_pix + idx;
    float v[NV];
    bool ok = true;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      v[k] = r[k * rec_stride];
      ok = ok && isfinite(v[k]);
    }
    float okf = ok ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = ok ? v[k] : 0.0f;
    if constexpr (R == 0) {
#pragma unroll
      for (int k = 0; k < NV; ++k) acc[0][k] += v[k];
      acc[0][NV] += okf;
    } else {
      uint32_t rng = rng_init((uint32_t)seed + (uint32_t)s, tile, lane);
      float jx = rng_next(rng);
      float jy = rng_next(rng);
      float wy = film_w1d<R>(a - R, jy, gauss_tail);
#pragma unroll
      for (int c = 0; c < kFoot; ++c) {
        float w = wy * film_w1d<R>(c - R, jx, gauss_tail) * okf;
#pragma unroll
        for (int k = 0; k < NV; ++k) acc[c][k] += w * v[k];
        acc[c][NV] += w;
      }
    }
    if (has_rc) acc_rc += r[NV * rec_stride];
  }
#pragma unroll
  for (int c = 0; c < kFoot; ++c) {
#pragma unroll
    for (int k = 0; k <= NV; ++k) slot[(size_t)(c * (NV + 1) + k) * n_pix] = acc[c][k];
  }
  if (has_rc) *rc_slot = acc_rc;
}

// The per-sample kernels K6 (K3's too), K5 and K4 trace a chunk of
// n_samples samples in one launch: a block holds kThreads consecutive
// pixels (or rays) of one sample, blockIdx.y, so a warp's primary rays stay coherent, and sample s
// of a launch seeded seed draws the stream of seed + s, as the film
// kernel's per-sample loop does.  Plane k of sample s goes to
// out[(k * n_samples + s) * n_pix + idx], the film records' [value][sample]
// [pixel] layout, so a warp's stores are coalesced; one sample gives the
// (planes, n_pix) output of a one-sample launch.  The TPU kernels trace one
// sample a pixel a call, and so did their first port: K6 at 256^2 was 512
// blocks, two waves at its 168 registers, and K5 at 128^2 128 blocks on 132
// multiprocessors, one block of 4 warps each, every path one serial chain.
// A chunk fills the card with independent samples, and the route runs
// its glue once a chunk.
//
// The blocks of kThreads a multiprocessor must hold for K6 and for K5 / K4,
// so at most 65536 / (kThreads blocks) registers a thread, from the A/B on
// the H100 in PERF.md §6 (tools/ab_film.py, the routes' chunks).  K6 at the
// compiler's choice takes 184 registers (2 blocks), at 3 blocks 168, at 4
// 128, at 5 96 and at 6 80 with 784 B of spill: a 64-sample cbox_pol chunk
// ran 0.220, 0.174, 0.163, 0.156 and 0.153 ms a sample, the Stokes state in
// a shared slab (122 registers) 0.174; at 8 blocks (64 registers, 1 000 B
// of spill) 0.174.  K5 / K4 at 6 blocks (80 registers, about 130 B of
// spill) ran the 64-sample chunks of a render 2-10% faster than at 4 (125
// registers) and 18-26% faster than at 8; the 10-sample chunks are within
// their noise.  K6 with the rough lane and cones takes 8 blocks (64
// registers, 1 072 B of spill): the same body in K3's form (without
// the jitter's two stores) traced a cbox_pol_rough 256^2 x 64 gaussian
// chunk at 4, 5, 6 and 8 blocks in 16.259, 15.570, 15.363 and 14.646 ms,
// and a cbox_pol one in 10.661, 10.129, 9.899 and 11.236 ms.  As for K1
// (kFilmMinBlocks), more warps to hide the bounce's latency outweigh the
// spills.
constexpr int kStokesSampleMinBlocks = 6;
constexpr int kStokesRoughSampleMinBlocks = 8;
constexpr int kSampleMinBlocks = 6;

// K6 and K3: polarized samples, as 15 planes a sample: S row-major, the
// ray count, the jitter jx, jy.  The first 13 are K3's film records.
template <bool kRoughCone>
__global__ void __launch_bounds__(kThreads, kRoughCone ? kStokesRoughSampleMinBlocks
                                                       : kStokesSampleMinBlocks)
stokes_sample_kernel(const int* __restrict__ hdr_g, const float* __restrict__ tab_g,
                     int n_tab, const float* __restrict__ mesh, float* __restrict__ out,
                     int n_pix, int seed, int n_samples) {
  STAGE_TABLES()
  const size_t stride = (size_t)n_samples * n_pix;  // between a sample's planes
  float* o = out + (size_t)blockIdx.y * n_pix + idx;
  Path p;
  Pol q;
  uint32_t rng = rng_init((uint32_t)seed + blockIdx.y, tile, lane);
  float jx = rng_next(rng);
  float jy = rng_next(rng);
  start_sample<true>(sc, idx, jx, jy, p, q);
  for (int depth = 0; depth < sc.max_depth; ++depth)
    if (!bounce<true, false, kRoughCone>(sc, depth, rng, p, q)) break;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) o[(i * 3 + ch) * stride] = q.S[i][ch];
  }
  o[12 * stride] = p.ray_count;
  o[13 * stride] = jx;
  o[14 * stride] = jy;
}

// K5 (kRays false): camera samples of pixel idx, as planes L (3), the ray
// count, the jitter jx, jy.  K4 (kRays true): samples on the ray idx of the
// (6, n_pix) rays (o, d as planes), sample s drawing the stream of seed + s
// on the same ray, every lane active with prev_delta set, no jitter drawn
// and no far-plane clip (_sample_state_init with raygen=None), as planes L
// (3) and the ray count.  On a textured environment both add the escape
// record: esc_d (3), esc_thr (3), zero where the path never escaped.  The
// RNG keys are the film kernel's, (seed + s, idx / tile_lanes, idx %
// tile_lanes).
template <bool kRays, bool kRoughCone>
__global__ void __launch_bounds__(kThreads, kSampleMinBlocks)
path_sample_kernel(const int* __restrict__ hdr_g, const float* __restrict__ tab_g, int n_tab,
                   const float* __restrict__ mesh, const float* __restrict__ rays,
                   float* __restrict__ out, int n_pix, int seed, int n_samples) {
  STAGE_TABLES()
  const size_t stride = (size_t)n_samples * n_pix;  // between a sample's planes
  float* o = out + (size_t)blockIdx.y * n_pix + idx;
  Path p;
  Pol q;
  uint32_t rng = rng_init((uint32_t)seed + blockIdx.y, tile, lane);
  float jx = 0.0f, jy = 0.0f;
  if constexpr (kRays) {
    sc.has_far = false;
    p.o = {rays[idx], rays[(size_t)n_pix + idx], rays[(size_t)2 * n_pix + idx]};
    p.d = {rays[(size_t)3 * n_pix + idx], rays[(size_t)4 * n_pix + idx],
           rays[(size_t)5 * n_pix + idx]};
    p.thr = {1.0f, 1.0f, 1.0f};
    p.L = {0.0f, 0.0f, 0.0f};
    p.ray_count = 0.0f;
    p.prev_pdf = 1.0f;
    p.eta_scale = 1.0f;
    p.prev_delta = true;
  } else {
    jx = rng_next(rng);
    jy = rng_next(rng);
    start_sample<false>(sc, idx, jx, jy, p, q);
  }
  p.esc_d = {0.0f, 0.0f, 0.0f};
  p.esc_thr = {0.0f, 0.0f, 0.0f};
  for (int depth = 0; depth < sc.max_depth; ++depth)
    if (!bounce<false, true, kRoughCone>(sc, depth, rng, p, q)) break;
  constexpr int kVals = kRays ? 4 : 6;  // K4 writes no jitter
  const float vals[12] = {p.L.x, p.L.y, p.L.z, p.ray_count, jx, jy,
                          p.esc_d.x, p.esc_d.y, p.esc_d.z,
                          p.esc_thr.x, p.esc_thr.y, p.esc_thr.z};
#pragma unroll
  for (int k = 0; k < kVals; ++k) o[k * stride] = vals[k];
  if (sc.env_textured) {
#pragma unroll
    for (int e = 0; e < 6; ++e) o[(kVals + e) * stride] = vals[6 + e];
  }
}

template <bool kBox, bool kRegen, bool kRoughCone>
void launch_film(dim3 grid, size_t smem, cudaStream_t s, const int* h, const float* t,
                 int n_tab, const float* m, float* o, int n_pix, int seed, int n_samples) {
  path_film_kernel<kBox, kRegen, kRoughCone><<<grid, kThreads, smem, s>>>(
      h, t, n_tab, m, o, n_pix, seed, n_samples);
}

// K1's trace kernel: the filter's radius (0, 1 or 2) picks only its
// register cap, since the film is splatted by film_splat.
template <bool kRegen, bool kRoughCone>
int launch_k1(int radius, dim3 grid, size_t smem, cudaStream_t s, const int* h, const float* t,
              int n_tab, const float* m, float* o, int n_pix, int seed, int n_samples) {
  if (radius < 0 || radius > 2) return (int)cudaErrorInvalidValue;
  if (radius == 0)
    launch_film<true, kRegen, kRoughCone>(grid, smem, s, h, t, n_tab, m, o, n_pix, seed,
                                          n_samples);
  else
    launch_film<false, kRegen, kRoughCone>(grid, smem, s, h, t, n_tab, m, o, n_pix, seed,
                                           n_samples);
  return 0;
}

// The launch of one mode, with or without the rough conductor's lane and
// cones.  K3 and K6 are one kernel; regen is K1's alone.
template <bool kRC>
int launch_mode(int mode, int regen, int radius, dim3 grid, size_t smem, cudaStream_t s,
                const int* h, const float* t, int n_tab, const float* m, const float* r,
                float* o, int n_pix, int seed, int n_samples) {
  if (mode == MODE_STOKES_SAMPLE) {
    stokes_sample_kernel<kRC><<<grid, kThreads, smem, s>>>(h, t, n_tab, m, o, n_pix, seed,
                                                           n_samples);
  } else if (mode == MODE_RAYGEN_SAMPLE) {
    path_sample_kernel<false, kRC><<<grid, kThreads, smem, s>>>(h, t, n_tab, m, r, o, n_pix,
                                                                seed, n_samples);
  } else if (mode == MODE_RAYS_SAMPLE) {
    path_sample_kernel<true, kRC><<<grid, kThreads, smem, s>>>(h, t, n_tab, m, r, o, n_pix,
                                                               seed, n_samples);
  } else {
    return regen ? launch_k1<true, kRC>(radius, grid, smem, s, h, t, n_tab, m, o, n_pix, seed,
                                        n_samples)
                 : launch_k1<false, kRC>(radius, grid, smem, s, h, t, n_tab, m, o, n_pix, seed,
                                         n_samples);
  }
  return 0;
}

template <int R, int NV>
void launch_splat(const float* rec, const float* tab, float* planes, int n_pix, int n_samples,
                  int seed, int tile_lanes, cudaStream_t s) {
  dim3 grid((n_pix + kSplatPix<R> - 1) / kSplatPix<R>);
  dim3 block(kSplatPix<R>, 2 * R + 1);
  film_splat_kernel<R, NV><<<grid, block, 0, s>>>(rec, tab, planes, n_pix, n_samples, seed,
                                                  tile_lanes);
}

}  // namespace

// mode: MODE_FILM (K1), MODE_STOKES_SAMPLE (K6, and K3's trace),
// MODE_RAYGEN_SAMPLE (K5), MODE_RAYS_SAMPLE (K4, on the (6, n_pix) rays;
// NULL for every other mode); regen: K2's loop for K1, no effect on any
// other mode; rough_cone: the header's rough-cone flag, the kernels with
// the rough conductor's lane and cones.  K1 writes its sample records, (4,
// n_samples, n_pix), to out; every other mode its planes (15 for K6, the
// first 13 K3's records; 6 for K5 and 4 for K4, each 6 more on a textured
// environment), (planes, n_samples, n_pix), and ignores radius.  Every
// mode but K1 takes the sample in the grid, at most kMaxChunk samples a
// launch.
extern "C" int path_film_launch(const void* hdr, int n_hdr, const void* tab,
                                int n_tab, const void* mesh, int n_mesh, const void* rays,
                                void* out, int n_pix, int seed, int n_samples, int radius,
                                int mode, int regen, int rough_cone, void* stream) {
  const bool sample_grid = mode != MODE_FILM;  // a thread a (pixel, sample)
  if (n_hdr < HDR_LEN || n_tab <= 0 || n_tab > kMaxTableFloats || n_pix <= 0 ||
      n_samples < 1 || (sample_grid && n_samples > kMaxChunk) || n_mesh < 0 ||
      (n_mesh > 0 && mesh == nullptr) || mode < 0 || mode > MODE_RAYS_SAMPLE ||
      ((mode == MODE_RAYS_SAMPLE) != (rays != nullptr)))
    return (int)cudaErrorInvalidValue;
  dim3 grid((n_pix + kThreads - 1) / kThreads, sample_grid ? n_samples : 1);
  size_t smem = (size_t)n_tab * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  const int* h = (const int*)hdr;
  const float* t = (const float*)tab;
  const float* m = (const float*)mesh;
  const float* r = (const float*)rays;
  float* o = (float*)out;
  int err = rough_cone ? launch_mode<true>(mode, regen, radius, grid, smem, s, h, t, n_tab, m, r,
                                           o, n_pix, seed, n_samples)
                       : launch_mode<false>(mode, regen, radius, grid, smem, s, h, t, n_tab, m, r,
                                            o, n_pix, seed, n_samples);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// film_splat: the records (nv + 1, n_samples, n_pix) of a launch seeded
// seed added onto the planes ((2 radius + 1)^2 (nv + 1) + 1, n_pix) in
// place; nv 3 (K1) or 12 (K3); tab is the launch's scene table (its
// gaussian tail), tile_lanes the header's.
extern "C" int film_splat_launch(const void* rec, const void* tab, int n_tab, void* planes,
                                 int n_pix, int n_samples, int nv, int radius, int seed,
                                 int tile_lanes, void* stream) {
  if (rec == nullptr || planes == nullptr || tab == nullptr || n_tab <= G_GAUSS_TAIL ||
      n_pix <= 0 || n_samples < 1 || tile_lanes < 1 || (nv != 3 && nv != 12) || radius < 0 ||
      radius > 2)
    return (int)cudaErrorInvalidValue;
  const float* rc = (const float*)rec;
  const float* t = (const float*)tab;
  float* pl = (float*)planes;
  cudaStream_t s = (cudaStream_t)stream;
  if (nv == 3) {
    if (radius == 0) launch_splat<0, 3>(rc, t, pl, n_pix, n_samples, seed, tile_lanes, s);
    if (radius == 1) launch_splat<1, 3>(rc, t, pl, n_pix, n_samples, seed, tile_lanes, s);
    if (radius == 2) launch_splat<2, 3>(rc, t, pl, n_pix, n_samples, seed, tile_lanes, s);
  } else {
    if (radius == 0) launch_splat<0, 12>(rc, t, pl, n_pix, n_samples, seed, tile_lanes, s);
    if (radius == 1) launch_splat<1, 12>(rc, t, pl, n_pix, n_samples, seed, tile_lanes, s);
    if (radius == 2) launch_splat<2, 12>(rc, t, pl, n_pix, n_samples, seed, tile_lanes, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* path_film_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
