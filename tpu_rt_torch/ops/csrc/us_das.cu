// Plane-wave delay-and-sum beamformer for NVIDIA Hopper (sm_90a), its
// packing pass, and its adjoint (further down: the backward of
// das_beamform under autograd).
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
// The packing pass (us_das_pack_kernel; plain version
// us/beamform.py::das_pack_plain) writes each trace as rf2[a, e, j] =
// (pad[j], pad[j + 1]), j in [0, T + 3), where pad is the trace with two
// zero samples before it and two after: the two taps of an index i0
// clamped to [-2, T] are the one aligned 8-byte entry rf2[i0 + 2], zeros
// where the plain version's masks give 0.  It moves bytes only: the RF in
// once (12.8 MB at USMain), twice that out.
//
// The forward's design.  One thread a pixel, one write a pixel, no
// atomics.  The elements are the outer loop and the angles the inner one,
// kMaxAngles at most a pass with one register accumulator each: t_rx, its
// IEEE square root included, is computed once a (pixel, element), and
// each tap is one load of rf2 with no predicate.  Each angle's
// accumulator adds its elements in order and the pass adds the
// accumulators in angle order, so every sum is taken in the first form's
// order (angles outer) and the image is bit-equal to it.  A warp covers
// kTileZ pixels along z by 32 / kTileZ along x, so that its taps fall on
// few L1 lines (the delay grows by about five samples a lambda / 4 step in
// z at USMain's 50 MHz, by up to about three a step in x).  The RF
// stays in the 50 MB L2 (rf2 is 25.6 MB at USMain).  tools/ab_us.py at
// USMain: 4 x 8 pixels a warp 0.249 ms, 8 x 4 0.251, 2 x 16 0.250, a
// column of 32 0.403; two pixels a thread 0.283; the elements unrolled by
// 2 0.257; blocks of 128 to 512 pixels in other shapes 0.247 to 0.252.
// Staging each (angle, element) trace's window in shared memory behind two
// barriers a pair was slower (1.45 against 0.55 ms a frame).
//
// What bounds it.  212 M two-tap interpolations a USMain frame (663 520
// pixels x 320 pairs), about 17 FP32 operations each as the first form
// counted them (the delay, its IEEE square root, the taps' weights and
// the sums; chip_smoke.py's bound keeps that count): some 3.6 GFLOP,
// 0.05 ms at 67 TFLOP/s.  Computing t_rx once a (pixel, element) leaves
// about 10 a tap and 7 a (pixel, element).  The bytes (the RF in once,
// the image out) are under 0.01 ms.  It issues about 16 instructions a
// tap, 0.11 ms at the card's issue rate; the rest of its 0.25 ms is
// latency (halving the L2 bytes a pixel, with larger blocks, moved
// nothing).
//
// Arithmetic follows the plain version operation by operation (IEEE
// square root, no fast math, built with -fmad=false), so each tap is
// bit-equal to the plain version's; only the order of the sums differs
// (the plain version adds 16-element chunks with torch's sum).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // the forward's block
constexpr int kTileZ = 4;      // a warp's pixels along z (32 / kTileZ columns of x)
constexpr int kUnroll = 1;     // elements a step of the forward's loop
constexpr int kMaxAngles = 8;  // angles a pass: a register accumulator each
constexpr int kPackThreads = 256;

__global__ void __launch_bounds__(kPackThreads)
us_das_pack_kernel(const float* __restrict__ rf, int n_rows, int n_t, float2* __restrict__ rf2) {
  const int n2 = n_t + 3;
  const int j = blockIdx.x * kPackThreads + threadIdx.x;
  if (j >= n2) return;
  const int i = j - 2;
  for (int row = blockIdx.y; row < n_rows; row += gridDim.y) {
    const float* r = rf + (size_t)row * n_t;
    const float v0 = i >= 0 && i < n_t ? __ldg(r + i) : 0.0f;
    const float v1 = i + 1 >= 0 && i + 1 < n_t ? __ldg(r + i + 1) : 0.0f;
    rf2[(size_t)row * n2 + j] = make_float2(v0, v1);
  }
}

// One pass over the elements for the angles [a0, a0 + kA) (the first na
// of them when kTail): sum plus each angle's sum, added in angle order.
template <int kA, bool kTail>
__device__ __forceinline__ float das_pass(const float2* __restrict__ rf2, int a0, int na, int n_e,
                                          int n2, float px, float pz,
                                          const float* __restrict__ ex,
                                          const float* __restrict__ ez,
                                          const float* __restrict__ sin_a,
                                          const float* __restrict__ cos_a, float inv_c,
                                          float t_off, float fs, float t_max, float sum) {
  float t_tx[kA], acc[kA];
#pragma unroll
  for (int a = 0; a < kA; ++a) {
    const bool live = !kTail || a < na;
    const float sa = live ? __ldg(sin_a + a0 + a) : 0.0f;
    const float ca = live ? __ldg(cos_a + a0 + a) : 0.0f;
    t_tx[a] = (px * sa + pz * ca) * inv_c;
    acc[a] = 0.0f;
  }
  const size_t stride_a = (size_t)n_e * n2;
  // + 2: entry i0 + 2 of a packed trace holds the taps i0 and i0 + 1
  const float2* base = rf2 + (size_t)a0 * stride_a + 2;
#pragma unroll kUnroll
  for (int e = 0; e < n_e; ++e) {
    const float dx = px - __ldg(ex + e), dz = pz - __ldg(ez + e);
    const float t_rx = __fsqrt_rn(dx * dx + dz * dz) * inv_c;
    const float2* row_e = base + (size_t)e * n2;
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      if (kTail && a >= na) continue;
      const float t_f = (t_tx[a] + t_rx - t_off) * fs;
      const float i0f = floorf(t_f);
      const float w = t_f - i0f;
      // the index clamped to [-2, T] decides the masks as the plain
      // version's int64 index does (a delay off the trace reads zeros)
      const int i0 = (int)fminf(fmaxf(i0f, -2.0f), t_max);
      const float2 v = __ldg(row_e + a * stride_a + i0);
      acc[a] = acc[a] + (v.x * (1.0f - w) + v.y * w);
    }
  }
#pragma unroll
  for (int a = 0; a < kA; ++a)
    if (!kTail || a < na) sum = sum + acc[a];
  return sum;
}

// kA = min(A, kMaxAngles) angles a pass; the last pass may hold fewer.
template <int kA>
__global__ void __launch_bounds__(kThreads)
us_das_kernel(const float2* __restrict__ rf2, int n_a, int n_e, int n_t,
              const float* __restrict__ xg, int nx, const float* __restrict__ zg, int nz,
              const float* __restrict__ ex, const float* __restrict__ ez,
              const float* __restrict__ sin_a, const float* __restrict__ cos_a, float inv_c,
              float t_off, float fs, float* __restrict__ out) {
  constexpr int kWarpX = 32 / kTileZ;
  constexpr int kBlockZ = kTileZ * (kThreads / 32);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = blockIdx.x * kWarpX + lane / kTileZ;
  const int z = blockIdx.y * kBlockZ + warp * kTileZ + lane % kTileZ;
  if (x >= nx || z >= nz) return;
  const float px = __ldg(xg + x), pz = __ldg(zg + z);
  const int n2 = n_t + 3;
  const float t_max = (float)n_t;
  float sum = 0.0f;
  for (int a0 = 0; a0 < n_a; a0 += kA) {
    if (n_a - a0 >= kA)
      sum = das_pass<kA, false>(rf2, a0, kA, n_e, n2, px, pz, ex, ez, sin_a, cos_a, inv_c, t_off,
                                fs, t_max, sum);
    else
      sum = das_pass<kA, true>(rf2, a0, n_a - a0, n_e, n2, px, pz, ex, ez, sin_a, cos_a, inv_c,
                               t_off, fs, t_max, sum);
  }
  out[(size_t)x * nz + z] = sum;
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
// Design.  A block owns one element and a tile of kAdjTileZ x kAdjTileX
// pixels, for every angle: t_rx is computed once a (pixel, element), and
// the delay, floor and weight in the forward's order of operations, so
// t_f, i0 and w are the forward's bits.  The taps of the tile's pixels
// fall in one window of samples a trace, bounded exactly (below): the
// block adds their weights into its windows in shared memory and then
// adds each window's samples into d RF (zeroed by the wrapper) with one
// global atomic a sample, skipping zeros: tiles overlap in samples, so no
// sample has one owner.  Shared-memory float atomics (a compare-and-swap
// loop each) are what bounds the kernel on the H100, so a tap's two
// weights go in with one 64-bit compare-and-swap: the window is
// kept twice, the second copy one float later, so that the pair (s, s + 1)
// is 8-byte aligned in one of them, and the flush adds the copies
// (tools/ab_us.py, d RF alone at USMain: 0.68 ms against 0.94 with two
// float atomics a tap; 0.44 with no atomics at all, which is wrong).
// Threads along z hit samples about five apart, so lanes rarely collide.
// Registers are capped for 6 blocks an SM (kAdjMinBlocks: 0.62 ms
// against 0.68 at 4 and 0.76 at 3).  Where a tile's windows exceed
// kWindow samples (a long trace, a coarse grid) the block makes several
// passes over its pixels, each adding the taps that fall in the next
// kWindow samples of its windows (the split mode).  With kGeom,
// d x_e and d z_e are sums over the block (one device atomic each a
// block), d sin a and d cos a sums over the block a pass of angles, d 1/c
// and d fs likewise; threads sum in registers, warps by shuffles, the
// block in shared memory.
//
// The window bound.  The numerator x sin a + z cos a of t_tx is a sum of
// two products, each monotone in x or z in float32 too (rounding is
// monotone), so over the tile's box [x0, x1] x [z0, z1] its extremes lie
// at the corners.  r = sqrt(dx^2 + dz^2) is monotone in |dx| and |dz|:
// its maximum lies at the far corner, its minimum at the element's
// position clamped into the box.  t_f is monotone in both (the direction
// set by the signs of 1 / c and fs), so its extremes over the tile are
// among the four combinations, computed with the kernel's own operations;
// the taps then lie in [floor(t_f min), floor(t_f max) + 1], clipped to
// [0, T).  tests/test_torch_cuda.py holds it on tiles clipping at 0 and
// at T, in both modes.
//
// What bounds it.  The forward's taps, about 16 FP32 operations each
// for d RF alone as the first form counted them (30-odd with the
// geometry): some 3.4 GFLOP a USMain frame, 0.05 ms at 67 TFLOP/s; the
// bytes (RF and g in, d RF out) about 0.008 ms.  The first form added two
// global atomics a tap (424 M a USMain frame); this one makes a shared
// compare-and-swap a tap (212 M) and one global atomic a (block, sample)
// of its windows (some 19 M).

constexpr int kAdjThreads = 256;
constexpr int kAdjTileZ = 128;  // a block's pixels along z
constexpr int kAdjTileX = 64;   // and along x
constexpr int kAdjMinBlocks = 6;  // blocks an SM the register budget leaves room for
constexpr int kWindow = 4096;   // samples a pass adds into
constexpr int kCopy = kWindow + 4;  // the second window copy's offset (even: 8-byte pairs)

// Adds (a, b) to the two floats at p (8-byte aligned, shared memory) with
// one 64-bit compare-and-swap loop.
__device__ __forceinline__ void add_pair(float* p, float a, float b) {
  unsigned long long* q = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *q, seen;
  do {
    seen = old;
    const float x = __uint_as_float((unsigned)seen) + a;
    const float y = __uint_as_float((unsigned)(seen >> 32)) + b;
    old = atomicCAS(q, seen,
                    (unsigned long long)__float_as_uint(y) << 32 | __float_as_uint(x));
  } while (old != seen);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) v += __shfl_xor_sync(0xffffffffu, v, k);
  return v;
}

// Sums each v[k] over the block and adds it into dst[idx[k]] with one
// device atomic (none where idx[k] < 0); every thread of the block calls it.
template <int kN>
__device__ __forceinline__ void block_add(const float (&v)[kN], const int (&idx)[kN],
                                          float* __restrict__ dst,
                                          float (*s_red)[2 * kMaxAngles]) {
  static_assert(kN <= 2 * kMaxAngles, "s_red holds 2 kMaxAngles sums a warp");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // s_red free
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const float s = warp_sum(v[k]);
    if (lane == 0) s_red[warp][k] = s;
  }
  __syncthreads();
  if ((int)threadIdx.x < kN) {
    float s = 0.0f;
    for (int w = 0; w < kAdjThreads / 32; ++w) s += s_red[w][threadIdx.x];
    int at = -1;
#pragma unroll
    for (int k = 0; k < kN; ++k)
      if (k == (int)threadIdx.x) at = idx[k];
    if (at >= 0 && s != 0.0f) atomicAdd(dst + at, s);
  }
}

template <bool kGeom>
__global__ void __launch_bounds__(kAdjThreads, kAdjMinBlocks)
us_das_adjoint_kernel(const float* __restrict__ rf, int n_a, int n_e, int n_t,
                      const float* __restrict__ xg, int nx, const float* __restrict__ zg, int nz,
                      const float* __restrict__ ex, const float* __restrict__ ez,
                      const float* __restrict__ sin_a, const float* __restrict__ cos_a,
                      float inv_c, float t_off, float fs, const float* __restrict__ g,
                      float* __restrict__ drf, float* __restrict__ dgeo) {
  // the pass's window: sample s is s_win[s] + s_win[kCopy + s + 1] (the
  // second copy one float later, so that either tap pair (s, s + 1) is
  // 8-byte aligned in one copy)
  __shared__ __align__(8) float s_win[2 * kCopy];
  __shared__ float s_box[4];  // the tile's x min, x max, z min, z max
  __shared__ int s_lo[kMaxAngles], s_len[kMaxAngles], s_off[kMaxAngles + 1];
  __shared__ float s_red[kAdjThreads / 32][2 * kMaxAngles];

  const int e = blockIdx.y;
  const int n_tx = (nx + kAdjTileX - 1) / kAdjTileX;
  const int x0 = (blockIdx.x % n_tx) * kAdjTileX, z0 = (blockIdx.x / n_tx) * kAdjTileZ;
  const int cx = min(kAdjTileX, nx - x0), cz = min(kAdjTileZ, nz - z0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < 2) {  // warp 0 the tile's x extent, warp 1 its z extent
    const float* grid = warp == 0 ? xg + x0 : zg + z0;
    const int cnt = warp == 0 ? cx : cz;
    float lo = INFINITY, hi = -INFINITY;
    for (int k = lane; k < cnt; k += 32) {
      const float v = __ldg(grid + k);
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, k));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, k));
    }
    if (lane == 0) {
      s_box[2 * warp] = lo;
      s_box[2 * warp + 1] = hi;
    }
  }
  __syncthreads();
  const float exe = __ldg(ex + e), eze = __ldg(ez + e);
  const float t_max = (float)n_t;
  float d_xe = 0.0f, d_ze = 0.0f, d_inv_c = 0.0f, d_fs = 0.0f;

  for (int a0 = 0; a0 < n_a; a0 += kMaxAngles) {
    const int na = min(kMaxAngles, n_a - a0);
    __syncthreads();  // the last pass of angles has read s_lo, s_len, s_off
    if ((int)threadIdx.x < na) {  // the window bound, an angle a thread
      const int a = a0 + threadIdx.x;
      const float sa = __ldg(sin_a + a), ca = __ldg(cos_a + a);
      const float bx0 = s_box[0], bx1 = s_box[1], bz0 = s_box[2], bz1 = s_box[3];
      const float q00 = bx0 * sa + bz0 * ca, q01 = bx0 * sa + bz1 * ca;
      const float q10 = bx1 * sa + bz0 * ca, q11 = bx1 * sa + bz1 * ca;
      const float q_lo = fminf(fminf(q00, q01), fminf(q10, q11));
      const float q_hi = fmaxf(fmaxf(q00, q01), fmaxf(q10, q11));
      const float dx0 = bx0 - exe, dx1 = bx1 - exe, dz0 = bz0 - eze, dz1 = bz1 - eze;
      const float dx2_hi = fmaxf(dx0 * dx0, dx1 * dx1), dz2_hi = fmaxf(dz0 * dz0, dz1 * dz1);
      const float dx2_lo = bx0 <= exe && exe <= bx1 ? 0.0f : fminf(dx0 * dx0, dx1 * dx1);
      const float dz2_lo = bz0 <= eze && eze <= bz1 ? 0.0f : fminf(dz0 * dz0, dz1 * dz1);
      const float r_lo = __fsqrt_rn(dx2_lo + dz2_lo), r_hi = __fsqrt_rn(dx2_hi + dz2_hi);
      float f_lo = INFINITY, f_hi = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float q = c & 1 ? q_hi : q_lo, r = c & 2 ? r_hi : r_lo;
        const float t_f = (q * inv_c + r * inv_c - t_off) * fs;
        f_lo = fminf(f_lo, t_f);
        f_hi = fmaxf(f_hi, t_f);
      }
      const float lo = fminf(fmaxf(floorf(f_lo), 0.0f), t_max);
      const float hi = fminf(floorf(f_hi) + 1.0f, t_max - 1.0f);
      s_lo[threadIdx.x] = (int)lo;
      s_len[threadIdx.x] = hi >= lo ? (int)(hi - lo) + 1 : 0;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int o = 0;
      for (int a = 0; a < na; ++a) {
        s_off[a] = o;
        o += s_len[a];
      }
      s_off[na] = o;
    }
    __syncthreads();
    const int total = s_off[na];
    float sa[kMaxAngles], ca[kMaxAngles], dsin[kMaxAngles], dcos[kMaxAngles];
    int lo[kMaxAngles], len[kMaxAngles], off[kMaxAngles];
#pragma unroll
    for (int a = 0; a < kMaxAngles; ++a) {
      const bool live = a < na;
      sa[a] = live ? __ldg(sin_a + a0 + a) : 0.0f;
      ca[a] = live ? __ldg(cos_a + a0 + a) : 0.0f;
      lo[a] = live ? s_lo[a] : 0;
      len[a] = live ? s_len[a] : 0;
      off[a] = live ? s_off[a] : 0;
      dsin[a] = dcos[a] = 0.0f;
    }
    for (int base = 0; base < total; base += kWindow) {
      const int n_win = min(kWindow, total - base);
      for (int k = threadIdx.x; k < n_win + 2; k += kAdjThreads) s_win[k] = s_win[kCopy + k] = 0.0f;
      __syncthreads();
      for (int p = threadIdx.x; p < kAdjTileZ * kAdjTileX; p += kAdjThreads) {
        const int lz = p % kAdjTileZ, lx = p / kAdjTileZ;
        if (lz >= cz || lx >= cx) continue;
        const int x = x0 + lx, z = z0 + lz;
        const float gi = __ldg(g + (size_t)x * nz + z);
        if (gi == 0.0f) continue;  // adds nothing, in either form
        const float px = __ldg(xg + x), pz = __ldg(zg + z);
        const float dx = px - exe, dz = pz - eze;
        const float r = __fsqrt_rn(dx * dx + dz * dz);
        const float t_rx = r * inv_c;
#pragma unroll
        for (int a = 0; a < kMaxAngles; ++a) {
          if (a >= na) break;
          const float tx_num = px * sa[a] + pz * ca[a];
          const float t_tx = tx_num * inv_c;
          const float tau = t_tx + t_rx - t_off;
          const float t_f = tau * fs;
          const float i0f = floorf(t_f);
          const float w = t_f - i0f;
          const int i0 = (int)fminf(fmaxf(i0f, -2.0f), t_max);
          // the taps' places in the angle's window, then in this pass's
          // shared window (unsigned: below either start wraps past its end)
          const unsigned q = (unsigned)(i0 - lo[a]);
          const unsigned s = q + (unsigned)(off[a] - base);
          const bool in_w0 = q < (unsigned)len[a] && s < (unsigned)n_win;
          const bool in_w1 = q + 1u < (unsigned)len[a] && s + 1u < (unsigned)n_win;
          // s is in [-1, n_win - 1] when either tap is in: the pair at s
          // (even) of the first copy, or at s + 1 of the second (odd)
          if (in_w0 || in_w1)
            add_pair(s_win + (s & 1u ? kCopy + 1 : 0) + (int)s, in_w0 ? gi * (1.0f - w) : 0.0f,
                     in_w1 ? gi * w : 0.0f);
          if (kGeom && base == 0) {
            const float* row = rf + ((size_t)(a0 + a) * n_e + e) * n_t;
            const bool in0 = i0 >= 0 && i0 < n_t, in1 = i0 + 1 >= 0 && i0 + 1 < n_t;
            float v0 = 0.0f, v1 = 0.0f;
            if (in0) v0 = __ldg(row + i0);
            if (in1) v1 = __ldg(row + i0 + 1);
            const float dtf = gi * (v1 - v0);
            d_fs += dtf * tau;
            const float G = dtf * fs;
            d_inv_c += G * r + G * tx_num;
            dsin[a] += G * px * inv_c;
            dcos[a] += G * pz * inv_c;
            const float qr = r > 0.0f ? G * inv_c / r : 0.0f;
            d_xe += -qr * dx;
            d_ze += -qr * dz;
          }
        }
      }
      __syncthreads();
      // the flush: this pass's part of each angle's window into d RF
      for (int a = 0; a < na; ++a) {
        const int w0 = max(s_off[a], base), w1 = min(s_off[a] + s_len[a], base + n_win);
        if (w0 >= w1) continue;
        const size_t g0 = ((size_t)(a0 + a) * n_e + e) * n_t + s_lo[a] + (w0 - s_off[a]);
        for (int k = threadIdx.x; k < w1 - w0; k += kAdjThreads) {
          const int at = w0 - base + k;
          const float v = s_win[at] + s_win[kCopy + at + 1];
          if (v != 0.0f) atomicAdd(drf + g0 + k, v);
        }
      }
      __syncthreads();  // s_win free for the next pass
    }
    if (kGeom) {  // d sin a and d cos a of this pass of angles
      float v[2 * kMaxAngles];
      int idx[2 * kMaxAngles];
#pragma unroll
      for (int a = 0; a < kMaxAngles; ++a) {
        v[a] = dsin[a];
        v[kMaxAngles + a] = dcos[a];
        idx[a] = a < na ? 2 * n_e + a0 + a : -1;
        idx[kMaxAngles + a] = a < na ? 2 * n_e + n_a + a0 + a : -1;
      }
      block_add(v, idx, dgeo, s_red);
    }
  }
  if (kGeom) {
    const float v[4] = {d_xe, d_ze, d_inv_c, d_fs};
    const int idx[4] = {e, n_e + e, 2 * n_e + 2 * n_a, 2 * n_e + 2 * n_a + 1};
    block_add(v, idx, dgeo, s_red);
  }
}

}  // namespace

// rf [A, E, T] -> rf2 [A, E, T + 3] float2 (see above).
extern "C" int us_das_pack_launch(const void* rf, int n_rows, int n_t, void* rf2, void* stream) {
  if (n_rows <= 0 || n_t <= 0 || n_t > 0x7fffffff - 3 - kPackThreads)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n_t + 3 + kPackThreads - 1) / kPackThreads, n_rows < 65535 ? n_rows : 65535);
  us_das_pack_kernel<<<grid, kPackThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rf, n_rows, n_t, (float2*)rf2);
  return (int)cudaGetLastError();
}

// rf2 [A, E, T + 3] float2 (us_das_pack_launch's); x grid [Nx], z grid
// [Nz]; element positions [E] (x, z); sin and cos of the angles [A]; out
// [Nx, Nz].
extern "C" int us_das_launch(const void* rf2, int n_a, int n_e, int n_t, const void* xg, int nx,
                             const void* zg, int nz, const void* ex, const void* ez,
                             const void* sin_a, const void* cos_a, float inv_c, float t_off,
                             float fs, void* out, void* stream) {
  constexpr int kWarpX = 32 / kTileZ, kBlockZ = kTileZ * (kThreads / 32);
  if (n_a <= 0 || n_e <= 0 || n_t <= 0 || n_t > 0x7fffffff - 3 || nx <= 0 || nz <= 0 ||
      (long long)nx * nz > 0x7fffffffLL - kThreads || (nz + kBlockZ - 1) / kBlockZ > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((nx + kWarpX - 1) / kWarpX, (nz + kBlockZ - 1) / kBlockZ);
  cudaStream_t s = (cudaStream_t)stream;
#define US_DAS_ARGS                                                                         \
  (const float2*)rf2, n_a, n_e, n_t, (const float*)xg, nx, (const float*)zg, nz,           \
      (const float*)ex, (const float*)ez, (const float*)sin_a, (const float*)cos_a, inv_c, \
      t_off, fs, (float*)out
  switch (n_a < kMaxAngles ? n_a : kMaxAngles) {
    case 1: us_das_kernel<1><<<grid, kThreads, 0, s>>>(US_DAS_ARGS); break;
    case 2: us_das_kernel<2><<<grid, kThreads, 0, s>>>(US_DAS_ARGS); break;
    case 3: us_das_kernel<3><<<grid, kThreads, 0, s>>>(US_DAS_ARGS); break;
    case 4: us_das_kernel<4><<<grid, kThreads, 0, s>>>(US_DAS_ARGS); break;
    case 5: us_das_kernel<5><<<grid, kThreads, 0, s>>>(US_DAS_ARGS); break;
    case 6: us_das_kernel<6><<<grid, kThreads, 0, s>>>(US_DAS_ARGS); break;
    case 7: us_das_kernel<7><<<grid, kThreads, 0, s>>>(US_DAS_ARGS); break;
    default: us_das_kernel<kMaxAngles><<<grid, kThreads, 0, s>>>(US_DAS_ARGS); break;
  }
#undef US_DAS_ARGS
  return (int)cudaGetLastError();
}

// The adjoint: rf, grids, positions, sin / cos and the scalars as for
// das_beamform (rf [A, E, T], not packed); g [Nx, Nz]; drf [A, E, T] zeroed
// by the caller; dgeo [2E + 2A + 2] zeroed by the caller (d x_e, d z_e,
// d sin a, d cos a, d (1 / c), d fs), or NULL for the RF's cotangent alone.
extern "C" int us_das_adjoint_launch(const void* rf, int n_a, int n_e, int n_t, const void* xg,
                                     int nx, const void* zg, int nz, const void* ex,
                                     const void* ez, const void* sin_a, const void* cos_a,
                                     float inv_c, float t_off, float fs, const void* g, void* drf,
                                     void* dgeo, void* stream) {
  const long long n_tiles = (long long)((nx + kAdjTileX - 1) / kAdjTileX) *
                            ((nz + kAdjTileZ - 1) / kAdjTileZ);
  if (n_a <= 0 || n_e <= 0 || n_e > 65535 || n_t <= 0 || nx <= 0 || nz <= 0 ||
      (long long)nx * nz > 0x7fffffffLL - kAdjThreads || n_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)n_tiles, n_e);
  if (dgeo != nullptr)
    us_das_adjoint_kernel<true><<<grid, kAdjThreads, 0, (cudaStream_t)stream>>>(
        (const float*)rf, n_a, n_e, n_t, (const float*)xg, nx, (const float*)zg, nz,
        (const float*)ex, (const float*)ez, (const float*)sin_a, (const float*)cos_a, inv_c,
        t_off, fs, (const float*)g, (float*)drf, (float*)dgeo);
  else
    us_das_adjoint_kernel<false><<<grid, kAdjThreads, 0, (cudaStream_t)stream>>>(
        (const float*)rf, n_a, n_e, n_t, (const float*)xg, nx, (const float*)zg, nz,
        (const float*)ex, (const float*)ez, (const float*)sin_a, (const float*)cos_a, inv_c,
        t_off, fs, (const float*)g, (float*)drf, nullptr);
  return (int)cudaGetLastError();
}

extern "C" const char* us_das_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
