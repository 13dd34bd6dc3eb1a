// Plane-wave delay-and-sum beamformer for NVIDIA Hopper (sm_90a), and its
// adjoint (further down: the backward of das_beamform under autograd).
//
// Computes the function of tpu_rt/us/beamform.py::das_beamform (which
// tpu_rt leaves to XLA: no Pallas kernel), the plain version being
// tpu_rt_torch/us/beamform.py::das_beamform_plain:
//
//   out[x, z] = sum_a sum_e lerp(RF[a, e], (t_tx(a, x, z) + t_rx(e, x, z) - t_offset) * fs)
//   t_tx = (x sin a + z cos a) / c,  t_rx = sqrt((x - x_e)^2 + (z - z_e)^2) / c
//
// with the plain version's two-tap masks: a tap outside [0, T) adds 0.
// The wrapper passes sin a, cos a (tensor code, so the kernel calls no
// sinf) and 1 / c as the plain version computes them.
//
// Design.  One thread a pixel, the threads along z, so that neighbouring
// threads write neighbouring outputs of the [Nx, Nz] image and read
// neighbouring samples of each trace (the delay grows by about five
// samples a lambda / 4 step in z at USMain's 50 MHz).  Each thread loops
// over the angles, then the elements, and sums in registers: no atomics,
// one write a pixel.  The RF ([A, E, T], 12.8 MB at USMain) stays in the
// 50 MB L2 and is read through the read-only path (__ldg).  Staging each
// (angle, element) trace's window of the block's 128 pixels in shared
// memory first (two barriers a pair) was measured slower on the H100
// (tools/ab_us.py: 1.45 against 0.55 ms a USMain frame): the taps of
// neighbouring pixels already share L1 lines.
//
// What bounds it.  212 M two-tap interpolations a USMain frame (663 520
// pixels x 320 pairs), about 17 FP32 operations each (the delay, its IEEE
// square root, the taps' weights and the sums): some 3.6 GFLOP, 0.05 ms at
// 67 TFLOP/s; the bytes (the RF in once, the image out) are under 0.01 ms.
// So it is bound by operations and by the L1 / L2 traffic of the taps.
//
// Arithmetic follows the plain version operation by operation (IEEE
// square root, no fast math, built with -fmad=false), so each tap is
// bit-equal to the plain version's; only the order of the sums differs
// (the plain version adds 16-element chunks with torch's sum).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;  // elements a step of the loop (tools/ab_us.py: 8 against 1 and 4)

__global__ void __launch_bounds__(kThreads)
us_das_kernel(const float* __restrict__ rf, int n_a, int n_e, int n_t,
              const float* __restrict__ xg, int nx, const float* __restrict__ zg, int nz,
              const float* __restrict__ ex, const float* __restrict__ ez,
              const float* __restrict__ sin_a, const float* __restrict__ cos_a, float inv_c,
              float t_off, float fs, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= nx * nz) return;
  const float px = __ldg(xg + i / nz), pz = __ldg(zg + i % nz);
  const float t_max = (float)n_t;
  float sum = 0.0f;
  for (int a = 0; a < n_a; ++a) {
    const float t_tx = (px * __ldg(sin_a + a) + pz * __ldg(cos_a + a)) * inv_c;
    float acc = 0.0f;
    // unrolled, the elements' delays and loads overlap; the sum still
    // adds them in order
#pragma unroll kUnroll
    for (int e = 0; e < n_e; ++e) {
      const float* row = rf + ((size_t)a * n_e + e) * n_t;
      const float dx = px - __ldg(ex + e), dz = pz - __ldg(ez + e);
      const float t_rx = __fsqrt_rn(dx * dx + dz * dz) * inv_c;
      const float t_f = (t_tx + t_rx - t_off) * fs;
      const float i0f = floorf(t_f);
      const float w = t_f - i0f;
      // the index clamped to [-2, T] decides the masks as the plain
      // version's int64 index does (a pixel past the grid reads nothing)
      const int i0 = (int)fminf(fmaxf(i0f, -2.0f), t_max);
      const bool in0 = i0 >= 0 && i0 < n_t, in1 = i0 + 1 >= 0 && i0 + 1 < n_t;
      float v0 = 0.0f, v1 = 0.0f;
      if (in0) v0 = __ldg(row + i0);
      if (in1) v1 = __ldg(row + i0 + 1);
      acc = acc + (v0 * (1.0f - w) + v1 * w);
    }
    sum = sum + acc;
  }
  out[i] = sum;
}

// The adjoint: the cotangent g [Nx, Nz] of out taken back to the RF and,
// with kGeom, to the delays' inputs.  With t_f as above, w = t_f - floor(t_f)
// and the masked taps v0, v1 (floor and the masks constants, as autograd and
// jax.grad take them):
//
//   dRF[a, e, i0] += g (1 - w),  dRF[a, e, i0 + 1] += g w   (taps in [0, T))
//   d out / d t_f = v1 - v0,  tau = t_tx + t_rx - t_off,  t_f = tau fs
//   d fs += g (v1 - v0) tau;  G = g (v1 - v0) fs reaches t_tx and t_rx
//   d sin a += G x / c,  d cos a += G z / c,  d (1 / c) += G (x sin a + z cos a) + G r
//   d x_e += -G (x - x_e) / (c r),  d z_e += -G (z - z_e) / (c r)  (r > 0)
//
// Design.  The forward's: one thread a pixel along z, the delay and the
// taps recomputed in the forward's order of operations (so t_f, i0 and w
// are the forward's bits), two atomics a tap into dRF (zeroed by the
// wrapper).  Neighbouring threads hit samples about five apart, so the
// atomics rarely collide but are many: 2 x 212 M a USMain frame.  The
// geometric terms are summed over the warp (shuffles), then by one lane
// into the block's shared slots, then by the block into device memory:
// one shared atomic a warp and pair, 2E + 2A + 2 device atomics a block.
// Threads past the image take part in the shuffles with g = 0.
//
// What bounds it.  About 30 FP32 operations a tap (the forward's 17, the
// weights' products and the geometric terms): some 6.4 GFLOP a USMain
// frame, 0.095 ms at 67 TFLOP/s; the bytes (RF and g in, dRF out) about
// 0.008 ms.  The 424 M atomics, not the arithmetic, are the likely limit.

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) v += __shfl_xor_sync(0xffffffffu, v, k);
  return v;
}

template <bool kGeom>
__global__ void __launch_bounds__(kThreads)
us_das_adjoint_kernel(const float* __restrict__ rf, int n_a, int n_e, int n_t,
                      const float* __restrict__ xg, int nx, const float* __restrict__ zg, int nz,
                      const float* __restrict__ ex, const float* __restrict__ ez,
                      const float* __restrict__ sin_a, const float* __restrict__ cos_a,
                      float inv_c, float t_off, float fs, const float* __restrict__ g,
                      float* __restrict__ drf, float* __restrict__ dgeo) {
  extern __shared__ float s_geo[];  // d x_e [E], d z_e [E], d sin [A], d cos [A], d 1/c, d fs
  const int n_geo = 2 * n_e + 2 * n_a + 2;
  const bool lead = (threadIdx.x & 31) == 0;
  if (kGeom) {
    for (int k = threadIdx.x; k < n_geo; k += kThreads) s_geo[k] = 0.0f;
    __syncthreads();
  }
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < nx * nz;
  const int ic = valid ? i : 0;
  const float px = __ldg(xg + ic / nz), pz = __ldg(zg + ic % nz);
  const float gi = valid ? __ldg(g + ic) : 0.0f;
  if (!kGeom && gi == 0.0f) return;  // no shuffles below: nothing to add
  const float t_max = (float)n_t;
  float d_inv_c = 0.0f, d_fs = 0.0f;
  for (int a = 0; a < n_a; ++a) {
    const float sa = __ldg(sin_a + a), ca = __ldg(cos_a + a);
    const float tx_num = px * sa + pz * ca;
    const float t_tx = tx_num * inv_c;
    float s_tx = 0.0f;  // sum over the elements of G: d loss / d t_tx
    for (int e = 0; e < n_e; ++e) {
      const float* row = rf + ((size_t)a * n_e + e) * n_t;
      float* drow = drf + ((size_t)a * n_e + e) * n_t;
      const float dx = px - __ldg(ex + e), dz = pz - __ldg(ez + e);
      const float r = __fsqrt_rn(dx * dx + dz * dz);
      const float t_rx = r * inv_c;
      const float tau = t_tx + t_rx - t_off;
      const float t_f = tau * fs;
      const float i0f = floorf(t_f);
      const float w = t_f - i0f;
      const int i0 = (int)fminf(fmaxf(i0f, -2.0f), t_max);
      const bool in0 = i0 >= 0 && i0 < n_t, in1 = i0 + 1 >= 0 && i0 + 1 < n_t;
      if (gi != 0.0f) {
        if (in0) atomicAdd(drow + i0, gi * (1.0f - w));
        if (in1) atomicAdd(drow + i0 + 1, gi * w);
      }
      if (kGeom) {
        float v0 = 0.0f, v1 = 0.0f;
        if (in0) v0 = __ldg(row + i0);
        if (in1) v1 = __ldg(row + i0 + 1);
        const float dtf = gi * (v1 - v0);
        d_fs += dtf * tau;
        const float G = dtf * fs;
        s_tx += G;
        d_inv_c += G * r;
        const float q = r > 0.0f ? G * inv_c / r : 0.0f;
        const float cx = warp_sum(-q * dx), cz = warp_sum(-q * dz);
        if (lead) {
          atomicAdd(s_geo + e, cx);
          atomicAdd(s_geo + n_e + e, cz);
        }
      }
    }
    if (kGeom) {
      d_inv_c += s_tx * tx_num;
      const float cs = warp_sum(s_tx * px * inv_c), cc = warp_sum(s_tx * pz * inv_c);
      if (lead) {
        atomicAdd(s_geo + 2 * n_e + a, cs);
        atomicAdd(s_geo + 2 * n_e + n_a + a, cc);
      }
    }
  }
  if (kGeom) {
    d_inv_c = warp_sum(d_inv_c);
    d_fs = warp_sum(d_fs);
    if (lead) {
      atomicAdd(s_geo + 2 * n_e + 2 * n_a, d_inv_c);
      atomicAdd(s_geo + 2 * n_e + 2 * n_a + 1, d_fs);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < n_geo; k += kThreads)
      if (s_geo[k] != 0.0f) atomicAdd(dgeo + k, s_geo[k]);
  }
}

}  // namespace

// rf [A, E, T]; x grid [Nx], z grid [Nz]; element positions [E] (x, z);
// sin and cos of the angles [A]; out [Nx, Nz].
extern "C" int us_das_launch(const void* rf, int n_a, int n_e, int n_t, const void* xg, int nx,
                             const void* zg, int nz, const void* ex, const void* ez,
                             const void* sin_a, const void* cos_a, float inv_c, float t_off,
                             float fs, void* out, void* stream) {
  if (n_a <= 0 || n_e <= 0 || n_t <= 0 || nx <= 0 || nz <= 0 ||
      (long long)nx * nz > 0x7fffffffLL - kThreads)
    return (int)cudaErrorInvalidValue;
  dim3 grid((nx * nz + kThreads - 1) / kThreads);
  us_das_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rf, n_a, n_e, n_t, (const float*)xg, nx, (const float*)zg, nz,
      (const float*)ex, (const float*)ez, (const float*)sin_a, (const float*)cos_a, inv_c,
      t_off, fs, (float*)out);
  return (int)cudaGetLastError();
}

// The adjoint: rf, grids, positions, sin / cos and the scalars as for
// us_das_launch; g [Nx, Nz]; drf [A, E, T] zeroed by the caller; dgeo
// [2E + 2A + 2] zeroed by the caller (d x_e, d z_e, d sin a, d cos a,
// d (1 / c), d fs), or NULL for the RF's cotangent alone.
extern "C" int us_das_adjoint_launch(const void* rf, int n_a, int n_e, int n_t, const void* xg,
                                     int nx, const void* zg, int nz, const void* ex,
                                     const void* ez, const void* sin_a, const void* cos_a,
                                     float inv_c, float t_off, float fs, const void* g, void* drf,
                                     void* dgeo, void* stream) {
  const int n_geo = 2 * n_e + 2 * n_a + 2;
  if (n_a <= 0 || n_e <= 0 || n_t <= 0 || nx <= 0 || nz <= 0 ||
      (long long)nx * nz > 0x7fffffffLL - kThreads || n_geo * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  dim3 grid((nx * nz + kThreads - 1) / kThreads);
  if (dgeo != nullptr)
    us_das_adjoint_kernel<true><<<grid, kThreads, n_geo * sizeof(float), (cudaStream_t)stream>>>(
        (const float*)rf, n_a, n_e, n_t, (const float*)xg, nx, (const float*)zg, nz,
        (const float*)ex, (const float*)ez, (const float*)sin_a, (const float*)cos_a, inv_c,
        t_off, fs, (const float*)g, (float*)drf, (float*)dgeo);
  else
    us_das_adjoint_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)rf, n_a, n_e, n_t, (const float*)xg, nx, (const float*)zg, nz,
        (const float*)ex, (const float*)ez, (const float*)sin_a, (const float*)cos_a, inv_c,
        t_off, fs, (const float*)g, (float*)drf, nullptr);
  return (int)cudaGetLastError();
}

extern "C" const char* us_das_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
