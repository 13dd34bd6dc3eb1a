// Ultrasound acquisition kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_rt/ops/pallas_us.py::simulate_acquisition_pallas
// (body _build_us_kernel): per ray lane of the plane-wave acquisition
// (angle x element x rays_per_pair lanes), max_depth bounces of a
// closest-hit sweep, an echo towards a random receive element with an
// any-hit occlusion test, attenuation / time of flight / phase, the
// receive directivity ramp, an acoustic GGX VNDF reflect-or-refract
// bounce and Russian roulette.  Two modes:
//   records  per bounce three records (pressure, fractional time-sample
//            index, receive element) into [3 * max_depth, N], as the TPU
//            kernel writes them (the card gates hold them to the plain
//            version, us_kernel.py::us_trace_plain);
//   deposit  each bounce's two linear-interpolation taps added straight
//            into the RF buffer [A, E, T] with atomicAdd, with the weights,
//            clamps and bounds of us_kernel.py::deposit_rf (which the TPU
//            package leaves to XLA); the acquisition's main path.
//
// The sweep (common.cuh) takes triangles, spheres, rectangles and cones, so
// the reference's Cone_Box / Cone_FLoating scenes run here.
//
// Design.  A group of kGroup threads a lane (lanes are pair-major: the
// rays_per_pair lanes of an (angle, element) pair are consecutive, and
// the kernel reads its pair's ray from [7, A * E] itself).  The group
// splits the closest-hit sweep and the any-hit echo test over its threads,
// prim kGroup * j + sub on thread sub; the closest hits combine with
// shuffles to the least (t, prim), ties to the lowest prim, which is what
// the sequential sweep's strict t < best_t in prim order keeps, and the
// any-hit results with an OR.  The rest of the bounce runs on every thread
// of the group alike (the same draws, the same arithmetic), and thread 0
// writes the records or the taps.  A depth loop breaks once the lane
// misses or dies; the wrapper zeroes the output, so a dead lane's
// remaining bounces keep zero pressure and deposit nothing.  The kernel
// allocates nothing.  Scene prims, acoustic BSDF params and the
// acquisition constants live in one float table plus an int header
// (layout in us_kernel.py), staged in shared memory, so no scene is
// compiled into the code.  The random streams are the JAX kernel's
// SplitMix32 streams bit for bit (common.cuh), keyed on
// (seed, lane // tile_lanes, lane % tile_lanes), five draws per bounce in
// the order u_recv, s1, s2a, s2b, u_rr.
//
// What bounds it.  Each lane does a few hundred FP32 operations a bounce
// and a sweep over the scene's prims for its closest hit and its echo;
// device memory sees the pair rays and the records or the RF taps.  The
// USMain acquisition has 20 480 lanes: one thread a lane gave 160 blocks
// on 132 SMs, one thin wave of dependent arithmetic (sinf's range
// reduction at phases of 1e3 - 1e4 rad, the sweeps).  A group a lane
// gives kGroup times the threads, and the sweeps a kGroup-th of the
// latency: that pays where a scene has tens of prims, and costs the
// group's repeated bounce arithmetic where it has a few (the A/B at
// kGroup).  The RF taps are atomics into a 12.8 MB buffer that stays in L2.
//
// Arithmetic follows the plain PyTorch version (us_kernel.py::
// us_trace_plain, deposit_rf) operation by operation: IEEE division and
// square root, no fast math, built with -fmad=false.  The records are
// bit-equal to the plain version's; the deposit adds in a run-dependent
// order, as index_add_ does on the card.

#include "common.cuh"

namespace {

// int32 header
enum {
  UH_N_PRIMS = 0, UH_N_BSDFS = 1, UH_MAX_DEPTH = 2, UH_N_ELEM = 3,
  UH_LAYOUT = 4, UH_TILE_LANES = 5, UH_OFF_PRIM = 6, UH_OFF_BSDF = 7,
  UH_LEN = 8
};
// float table: acquisition constants
enum {
  UG_ROWS = 0, UG_TN = 9, UG_PITCH = 12, UG_RADIUS = 13, UG_C_LIN = 14,
  UG_THETA0 = 15, UG_DTHETA = 16, UG_E_HALF = 17, UG_P_OVER_R = 18, UG_E = 19,
  UG_E_M1 = 20, UG_ATT = 21, UG_DB = 22, UG_INV_C = 23, UG_TWO_PI_F = 24,
  UG_COS_CUT = 25, UG_INV_RAMP = 26, UG_MAIN = 27, UG_CUT = 28,
  UG_NUM_RAYS = 29, UG_FS = 30, UG_MAX_PATH = 31
};
enum { LAYOUT_LINEAR = 0, LAYOUT_CONVEX_OPEN = 1, LAYOUT_CONVEX_PITCH = 2 };
enum { US_BSDF_STRIDE = 4 };
enum { MODE_RECORDS = 0, MODE_DEPOSIT = 1 };
constexpr int kMaxTableFloats = 12 * 1024;
constexpr int kThreads = 128;
// Threads a lane.  tools/ab_us.py, the kernel's device time a records
// launch of 20 480 lanes on an H100 80GB HBM3 at 700 W, with 1, 2, 4 and 8
// threads a lane: USMain (2 prims) 0.00766, 0.00717, 0.00781, 0.01162 ms;
// the cone box (6 prims) 0.01495, 0.01437, 0.01466, 0.01849; USMain with 62
// scatterers (64 prims, the most the kernel takes) 0.21685, 0.13433,
// 0.08683, 0.07082.  One thread a lane with common.cuh's sweeps: 0.00664,
// 0.01387, 0.21612.  A group of 4 costs about a microsecond on a scene of
// a few prims and takes 0.40x the time at 64; 8 is faster than 4 only
// there (0.82x) and 1.5x slower at 2 prims.
constexpr int kGroup = 4;
static_assert(kGroup >= 1 && kGroup <= 16 && (kGroup & (kGroup - 1)) == 0,
              "a lane's group is a power of two within half a warp");

constexpr float kPiF = (float)kPi;
constexpr float kShadowShrink = (float)(1.0 - 1e-3);

// Abramowitz-Stegun 4.4.45 arccos (the TPU kernel's), x in [-1, 1].
__device__ __forceinline__ float acos_as(float x) {
  float xa = fabsf(x);
  float p = 1.5707288f + xa * (-0.2121144f + xa * (0.0742610f + xa * (-0.0187293f)));
  float r = safe_sqrt(1.0f - xa) * p;
  return x >= 0.0f ? r : kPiF - r;
}

// World position of receive element index r, closed form per layout.
__device__ __forceinline__ V3 elem_world(const float* g, int layout, float r) {
  float x, z;
  if (layout == LAYOUT_LINEAR) {
    x = g[UG_PITCH] * (r - g[UG_C_LIN]);
    z = 0.0f;
  } else {
    float theta = layout == LAYOUT_CONVEX_OPEN ? g[UG_THETA0] + r * g[UG_DTHETA]
                                               : (r - g[UG_E_HALF]) * g[UG_P_OVER_R];
    x = g[UG_RADIUS] * sinf(theta);
    z = g[UG_RADIUS] * (1.0f - cosf(theta));
  }
  const float* m = g + UG_ROWS;
  return {m[0] * x + m[1] * z + m[2], m[3] * x + m[4] * z + m[5],
          m[6] * x + m[7] * z + m[8]};
}

// The group's closest hit: thread sub sweeps prims sub, sub + kGroup, ...
// with the sequential sweep's strict t < best_t, then the group keeps the
// least (t, prim) by shuffles; every thread returns the same prim (or -1),
// t and normal.
__device__ __forceinline__ int group_closest_hit(const float* prims, int n_prims, V3 o, V3 d,
                                                 int sub, unsigned mask, float& best_t, V3& n) {
  best_t = kBig;
  int best = -1;
  for (int pi = sub; pi < n_prims; pi += kGroup) {
    float t;
    if (intersect(prims + pi * PRIM_STRIDE, o, d, 1e-4f, kBig, t) && t < best_t) {
      best_t = t;
      best = pi;
    }
  }
  // a miss holds (kBig, -1) and every hit has t < kBig, so the order on
  // (t, prim) alone gives the sequential sweep's answer
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    float ot = __shfl_xor_sync(mask, best_t, off);
    int ob = __shfl_xor_sync(mask, best, off);
    if (ot < best_t || (ot == best_t && ob < best)) {
      best_t = ot;
      best = ob;
    }
  }
  if (best >= 0) n = prim_normal(prims + best * PRIM_STRIDE, o, d, best_t);
  return best;
}

// The group's any-hit test: an OR over the threads' strided sweeps.
__device__ __forceinline__ bool group_any_hit(const float* prims, int n_prims, V3 o, V3 d,
                                              float tmax, int sub, unsigned mask) {
  bool hit = false;
  for (int pi = sub; pi < n_prims && !hit; pi += kGroup) {
    float t;
    hit = intersect(prims + pi * PRIM_STRIDE, o, d, 1e-4f, tmax, t) && t < kBig;
  }
  return __any_sync(mask, hit) != 0;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
us_acq_kernel(const int* __restrict__ hdr_g, const float* __restrict__ tab_g,
              int n_tab, const float* __restrict__ rays, int n_pairs, int rays_per_pair,
              float* __restrict__ out, int seed, int time_samples) {
  extern __shared__ float tab[];
  __shared__ int hdr[UH_LEN];
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) tab[i] = tab_g[i];
  for (int i = threadIdx.x; i < UH_LEN; i += blockDim.x) hdr[i] = hdr_g[i];
  __syncthreads();
  const int n_lanes = n_pairs * rays_per_pair;
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  if (p >= n_lanes) return;  // the whole group: its threads share p
  const int sub = threadIdx.x % kGroup;
  const unsigned mask = ((1u << kGroup) - 1u) << ((threadIdx.x & 31) & ~(kGroup - 1));

  const float* g = tab;
  const float* prims = tab + hdr[UH_OFF_PRIM];
  const float* bsdfs = tab + hdr[UH_OFF_BSDF];
  const int n_prims = hdr[UH_N_PRIMS];
  const int max_depth = hdr[UH_MAX_DEPTH];
  const int layout = hdr[UH_LAYOUT];
  const int tile_lanes = hdr[UH_TILE_LANES];
  const int n_elem = hdr[UH_N_ELEM];
  const size_t N = (size_t)n_lanes;
  const int pair = p / rays_per_pair;
  const size_t P = (size_t)n_pairs;

  uint32_t rng = rng_init((uint32_t)seed, (uint32_t)(p / tile_lanes),
                          (uint32_t)(p % tile_lanes));
  V3 o = {rays[pair], rays[P + pair], rays[2 * P + pair]};
  V3 d = {rays[3 * P + pair], rays[4 * P + pair], rays[5 * P + pair]};
  const float tx_delay = rays[6 * P + pair];
  const V3 tn = {g[UG_TN], g[UG_TN + 1], g[UG_TN + 2]};
  float amp = 1.0f, atten = 1.0f, tof = 0.0f, geo_len = 0.0f;

  for (int depth = 0; depth < max_depth; ++depth) {
    float dist;
    V3 n = {0.0f, 0.0f, 0.0f};
    int prim = group_closest_hit(prims, n_prims, o, d, sub, mask, dist, n);
    if (prim < 0) break;  // a miss ends the lane
    V3 p_hit = add(o, scale(d, dist));
    V3 wi = {-d.x, -d.y, -d.z};
    float u_recv = rng_next(rng);
    float s1 = rng_next(rng);
    float s2a = rng_next(rng);
    float s2b = rng_next(rng);
    float u_rr = rng_next(rng);

    // ---- echo towards a random receive element, occlusion any-hit ----
    float recv_f = fminf(floorf(u_recv * g[UG_E]), g[UG_E_M1]);
    V3 target = elem_world(g, layout, recv_f);
    V3 to_recv = {target.x - p_hit.x, target.y - p_hit.y, target.z - p_hit.z};
    float dist_recv = safe_sqrt(dot(to_recv, to_recv));
    V3 sec_dir = scale(to_recv, 1.0f / dist_recv);
    float off = 1e-4f * (dot(n, sec_dir) >= 0.0f ? 1.0f : -1.0f);
    bool visible = !group_any_hit(prims, n_prims, add(p_hit, scale(n, off)), sec_dir,
                                  dist_recv * kShadowShrink, sub, mask);

    atten = atten * expf((g[UG_ATT] * dist) / g[UG_DB]);
    tof = tof + dist * g[UG_INV_C];
    float total_time = tx_delay + tof + dist_recv * g[UG_INV_C];
    float phase = g[UG_TWO_PI_F] * total_time;

    // ---- acoustic GGX BSDF of the hit prim ----
    const float* b = bsdfs + (int)prims[prim * PRIM_STRIDE + 1] * US_BSDF_STRIDE;
    float z_int = b[0], alpha = b[1], z_ext = b[2];
    V3 s_fr, t_fr;
    frame(n, s_fr, t_fr);
    V3 wi_l = {dot(wi, s_fr), dot(wi, t_fr), dot(wi, n)};
    float cos_wi = wi_l.z;

    // VNDF sample (Heitz spherical cap; two-sided via flip; common.cuh)
    float flip;
    V3 mh = vndf_half(wi_l, alpha, s2a, s2b, flip);

    // impedance Fresnel: reflect or refract
    float cos_im = dot(wi_l, mh);
    bool entering = cos_wi > 0.0f;
    float Z1 = entering ? z_ext : z_int;
    float Z2 = entering ? z_int : z_ext;
    float ratio = Z1 / fmaxf(Z2, 1e-6f);
    float cos_i = fabsf(cos_im);
    float sin_t_sqr = ratio * ratio * (1.0f - cos_i * cos_i);
    bool tir = sin_t_sqr > 1.0f;
    float cos_t = safe_sqrt(1.0f - sin_t_sqr);
    float denom = Z2 * cos_i + Z1 * cos_t;
    float R = (Z2 * cos_i - Z1 * cos_t) / fmaxf(denom, 1e-9f);
    float T = 1.0f + R;
    float prob_r = tir ? 1.0f : fminf(fmaxf(R * R, 0.05f), 0.95f);
    bool pick_r = s1 < prob_r || tir;
    V3 wo_l;
    if (pick_r) {
      V3 mh2 = scale(mh, 2.0f * cos_im);
      wo_l = {mh2.x - wi_l.x, mh2.y - wi_l.y, mh2.z - wi_l.z};
    } else {
      wo_l = add(scale(wi_l, -ratio), scale(mh, ratio * cos_i - cos_t));
    }
    wo_l = normalize(wo_l);
    float bs_amp = pick_r ? fabsf(R) / prob_r : fabsf(T) / fmaxf(1.0f - prob_r, 1e-6f);
    float cos_theta = fabsf(cos_wi);
    amp = amp * (bs_amp * cos_theta);

    // ---- receive directivity ramp, then the records ----
    float cos_a = -(sec_dir.x * tn.x + sec_dir.y * tn.y + sec_dir.z * tn.z);
    float a_ang = fabsf(acos_as(fminf(fmaxf(cos_a, -0.999999f), 0.999999f)));
    float ramp = (g[UG_CUT] - a_ang) * g[UG_INV_RAMP];
    float fd_dir = a_ang <= g[UG_MAIN] ? 1.0f : (a_ang <= g[UG_CUT] ? ramp : 0.0f);
    float fd = (fd_dir * cos_theta) / g[UG_NUM_RAYS];
    float pressure = atten * amp * fd * sinf(phase);
    if (sub == 0) {
      float t_f = total_time * g[UG_FS];
      if (kMode == MODE_RECORDS) {
        float* rec = out + (size_t)(3 * depth) * N + p;
        rec[0] = visible ? pressure : 0.0f;
        rec[N] = t_f;
        rec[2 * N] = recv_f;
      } else if (visible) {
        // deposit_rf's two taps: the index clamped to [-2, T + 2], the
        // element index clamped, taps outside [0, T) dropped (they add 0)
        const int n_t = time_samples;
        float tc = fminf(fmaxf(t_f, -2.0f), (float)n_t + 2.0f);
        int recv = min(max((int)recv_f, 0), n_elem - 1);
        float t0 = floorf(tc);
        float w1 = tc - t0;
        int t0i = (int)t0;
        float* trace = out + ((size_t)(pair / n_elem) * n_elem + recv) * n_t;
        if (t0i >= 0 && t0i < n_t) atomicAdd(trace + t0i, pressure * (1.0f - w1));
        if (t0i + 1 >= 0 && t0i + 1 < n_t) atomicAdd(trace + t0i + 1, pressure * w1);
      }
    }

    // ---- bounce + Russian roulette ----
    V3 d_new = normalize(to_world(n, s_fr, t_fr, wo_l));
    float off2 = 1e-4f * (dot(n, d_new) >= 0.0f ? 1.0f : -1.0f);
    geo_len = geo_len + dist;
    float rr_prob = fminf(fmaxf(fabsf(atten * amp), 0.05f), 1.0f);
    bool survive = u_rr < rr_prob;
    atten = survive ? atten / rr_prob : 0.0f;
    bool within = (d_new.x * tn.x + d_new.y * tn.y + d_new.z * tn.z) >= g[UG_COS_CUT];
    if (!(survive && within && geo_len < g[UG_MAX_PATH])) break;
    o = add(p_hit, scale(n, off2));
    d = d_new;
  }
}

}  // namespace

// rays [7, n_pairs] (origin, direction, transmit delay of each pair),
// rays_per_pair consecutive lanes a pair.  mode MODE_RECORDS: out is
// [3 * max_depth, n_pairs * rays_per_pair]; MODE_DEPOSIT: out is the RF
// [n_pairs / E, E, time_samples], the pairs angle-major.  Both zeroed.
extern "C" int us_acq_launch(const void* hdr, int n_hdr, const void* tab, int n_tab,
                             const void* rays, int n_pairs, int rays_per_pair, void* out,
                             int seed, int mode, int time_samples, void* stream) {
  if (n_hdr < UH_LEN || n_tab <= 0 || n_tab > kMaxTableFloats || n_pairs <= 0 ||
      rays_per_pair <= 0 || (long long)n_pairs * rays_per_pair * kGroup > 0x7fffffffLL ||
      (mode != MODE_RECORDS && mode != MODE_DEPOSIT) ||
      (mode == MODE_DEPOSIT && time_samples <= 0))
    return (int)cudaErrorInvalidValue;
  const int n_threads = n_pairs * rays_per_pair * kGroup;
  dim3 grid((n_threads + kThreads - 1) / kThreads);
  size_t smem = (size_t)n_tab * sizeof(float);
  auto kernel = mode == MODE_RECORDS ? us_acq_kernel<MODE_RECORDS> : us_acq_kernel<MODE_DEPOSIT>;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)hdr, (const float*)tab, n_tab, (const float*)rays, n_pairs, rays_per_pair,
      (float*)out, seed, time_samples);
  return (int)cudaGetLastError();
}

extern "C" const char* us_acq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
