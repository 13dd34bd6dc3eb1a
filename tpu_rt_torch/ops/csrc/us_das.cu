// Plane-wave delay-and-sum beamformer for NVIDIA Hopper (sm_90a).
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

extern "C" const char* us_das_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
