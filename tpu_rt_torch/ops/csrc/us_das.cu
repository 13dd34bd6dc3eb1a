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
// The forward's design.  Each tap reads shared memory, not L1TEX.  A
// block owns a tile of kWarps kPix warp tiles of kWarpZ x 32 / kWarpZ
// pixels (z by x; 512 pixels), a consumer thread kPix of them; a ninth,
// producer warp stages rf2 into a ring of shared-memory slots.  A stage
// is stage_elems elements of a pass of kMaxAngles angles (elements outer,
// angles inner, as before): for each, the window of rf2 that the tile's
// taps can reach, bounded by delay_bounds over the tile's box (the
// adjoint's bound) on the index clamped to [-2, T], widened to 16 bytes
// and brought by one cp.async.bulk into the slot, completing on the
// slot's full mbarrier; consumers wait on it, take their taps, and each
// warp arrives on the slot's empty mbarrier; no __syncthreads in the
// loop.  A tap is one ld.shared.v2 at base + 8 bits: the floor comes from
// a round-down add (kRoundDown) whose bits are the index, exact below
// 2^22, and the producer publishes each window's base with the bias of
// those bits folded in, so a tap has no conversion and one address
// operation; where no window of a stage is clipped at -2 or T (all of
// PICMUS and USMain) the clamp is left out, its result being the same.
// t_rx is computed once a (pixel, element, pass), after the stage's wait
// (the producer stages the element's position), so that the stage's
// delays are not held in registers across it.  Each angle's accumulator
// adds its elements in order and each pass adds the accumulators in angle
// order, so the image is bit-equal to the first form's order of sums.
// The host (us/beamform.py::das_plan) picks the tile shape, the elements
// a stage (2 where two slots of them fit kRingBytes, else 1) and a slot's
// capacity from the angles, the grids' steps, fs and c; where one
// element's windows exceed half the ring the producer splits each stage
// into pieces of a slot, whose taps are masked to the piece (the split
// mode, das_beamform.split_launches; none at PICMUS or USMain).
//
// A / B (tools/ab_us.py, NVIDIA H100 80GB HBM3 at 700 W; the DAS kernel's
// device time at PICMUS, 75 x 128 x 4 167 on the 1 084 x 664 grid, then at
// USMain and on the cone box).  The first form took 7.83-7.96 ms at
// PICMUS, 4.65 ms with its loads replaced by a value of the index: the
// loads paced it.  Staged, 4 pixels a thread at 2 blocks an SM (96
// registers, 324 B of spill) took 9.55 ms; 2 pixels at 3 blocks 7.75, at
// 4 blocks 7.92, 1 pixel 8.42.  The producer bounding 4 elements at once
// (a lane an element and angle) 7.47; the round-down floor 6.98; the
// window bases from the producer (4 address operations a tap down to 1)
// 6.08; the clamp left out 5.43, and no faster with its loads taken out
// (5.52): its instruction rate paces it.  Tiles of 8 x 64, 16 x 32 and
// 32 x 16 pixels 5.43-5.44, 64 x 8 5.91.  Two elements a stage 4.75-4.88
// (one: 5.76), USMain 0.196-0.203 ms against 0.247-0.249, the cone box
// 0.161 against 0.191 with two slots; PICMUS with 2, 4 or 6 slots
// 4.84-4.86.
//
// What bounds it.  6.9e9 two-tap interpolations a PICMUS frame (719 776
// pixels x 9 600 pairs), 10 FP32 operations each at least, with t_rx once
// a (pixel, element) (7) and a (pixel, angle) (5): 7.0e10 operations, 1.0
// ms at 67 TFLOP/s; the bytes, rf2 in once (320 MB) and the image out,
// 0.1 ms.  It runs 12.8 instructions a tap (SASS) and about 4.7 a tap
// of t_rx and the ring's waits, 4.1 ms at the card's instruction rate
// (1.755 GHz under load): the 4.85 ms it takes is 84% of it.  1 428 tiles fill
// 3.6 waves of 396 resident blocks (3 an SM); no tile of 512 pixels
// changes the count.
//
// Arithmetic follows the plain version operation by operation (IEEE
// square root, no fast math, built with -fmad=false), so each tap is
// bit-equal to the plain version's; only the order of the sums differs
// (the plain version adds 16-element chunks with torch's sum).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;    // the forward's consumer warps a block
constexpr int kThreads = (kWarps + 1) * 32;  // and its producer warp
constexpr int kMinBlocks = 3;  // blocks an SM the register budget leaves room for
constexpr int kPix = 2;      // pixels a consumer thread
constexpr int kWarpZ = 4;    // a warp's pixels along z (32 / kWarpZ along x)
constexpr int kMaxAngles = 8;  // angles a pass: a register accumulator each
constexpr int kMaxStageElems = 2;  // elements a stage, at most
constexpr int kStages = 4;   // the ring's stages, at most
constexpr int kRingBytes = 64 * 1024;  // the ring's shared memory, at most
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

// The least and the greatest delay in samples, t_f = (t_tx + t_rx - t_off)
// fs, over the pixel box [bx0, bx1] x [bz0, bz1] for one angle (sin a, cos
// a) and one element (exe, eze).  The numerator x sin a + z cos a of t_tx
// is a sum of two products, each monotone in x or z in float32 too
// (rounding is monotone), so over the box its extremes lie at the corners.
// r = sqrt(dx^2 + dz^2) is monotone in |dx| and |dz|: its maximum lies at
// the far corner, its minimum at the element's position clamped into the
// box.  t_f is monotone in both (the direction set by the signs of 1 / c
// and fs), so its extremes over the box are among the four combinations,
// computed with the taps' own operations: every pixel's t_f lies in
// [f_lo, f_hi], bit for bit.  Both kernels bound their windows of samples
// with it.
__device__ __forceinline__ void delay_bounds(float sa, float ca, float bx0, float bx1, float bz0,
                                             float bz1, float exe, float eze, float inv_c,
                                             float t_off, float fs, float& f_lo, float& f_hi) {
  const float q00 = bx0 * sa + bz0 * ca, q01 = bx0 * sa + bz1 * ca;
  const float q10 = bx1 * sa + bz0 * ca, q11 = bx1 * sa + bz1 * ca;
  const float q_lo = fminf(fminf(q00, q01), fminf(q10, q11));
  const float q_hi = fmaxf(fmaxf(q00, q01), fmaxf(q10, q11));
  const float dx0 = bx0 - exe, dx1 = bx1 - exe, dz0 = bz0 - eze, dz1 = bz1 - eze;
  const float dx2_hi = fmaxf(dx0 * dx0, dx1 * dx1), dz2_hi = fmaxf(dz0 * dz0, dz1 * dz1);
  const float dx2_lo = bx0 <= exe && exe <= bx1 ? 0.0f : fminf(dx0 * dx0, dx1 * dx1);
  const float dz2_lo = bz0 <= eze && eze <= bz1 ? 0.0f : fminf(dz0 * dz0, dz1 * dz1);
  const float r_lo = __fsqrt_rn(dx2_lo + dz2_lo), r_hi = __fsqrt_rn(dx2_hi + dz2_hi);
  f_lo = INFINITY;
  f_hi = -INFINITY;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float q = c & 1 ? q_hi : q_lo, r = c & 2 ? r_hi : r_lo;
    const float t_f = (q * inv_c + r * inv_c - t_off) * fs;
    f_lo = fminf(f_lo, t_f);
    f_hi = fmaxf(f_hi, t_f);
  }
}

// The forward's ring: mbarriers in shared memory, bulk copies that
// complete on them.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrives and adds the bytes that the stage's copies will bring
__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// waits for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from global src to shared dst (both 16-byte
// aligned), completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The shared state of a forward block: the ring's full and empty barriers,
// each slot's piece (its entries; bit 0: the stage's only piece, bit 1:
// its last, bit 2: a window of the stage clipped at -2 or T), the stage's
// element positions and, for each element and angle, the base of its
// window (a tap whose round-down add has the bits 0x4B400000 + i0, below,
// reads the entry at shared address base + 8 bits, modulo 2^32); the
// tile's box (x min, x max, z min, z max; NaN where the tile holds a grid
// value that is not finite).
struct DasRing {
  unsigned long long full[kStages], empty[kStages];
  unsigned base[kStages][kMaxStageElems][kMaxAngles];
  float2 pos[kStages][kMaxStageElems];
  int2 piece[kStages];
  float box[4];
};

// The floor of t in [-2, 2^22) as the round-down add t + 1.5 2^23 (exact:
// the sum's unit in the last place is 1), whose bits are 0x4B400000 +
// floor(t): the index and its float without a conversion.
constexpr float kRoundDown = 12582912.0f;
constexpr unsigned kRoundDownBits = 0x4B400000u;

__device__ __forceinline__ float2 lds2(unsigned addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// The producer warp: for each stage (stage_elems elements of a pass of
// angles), lane a bounds the window of rf2[a0 + a, e] that the tile's taps
// read (their indices clamped to [-2, T] as the taps clamp them, entries
// i0 + 2), widened to 16-byte bounds of rf2; the windows lie one after the
// other in a slot of cap entries, or in several slots (pieces) where they
// exceed it.  The warp bounds kGroup elements at once, lane j kMaxAngles +
// a element e0 + j, so that its chain of loads, square roots and shuffles
// is paid once a group and not once a stage.
template <int kA>
__device__ __forceinline__ void das_produce(DasRing& ring, float2* s_ring,
                                            const float2* __restrict__ rf2, int n_a, int n_e,
                                            int n_t, const float* __restrict__ ex,
                                            const float* __restrict__ ez,
                                            const float* __restrict__ sin_a,
                                            const float* __restrict__ cos_a, float inv_c,
                                            float t_off, float fs, int stage_elems, int cap,
                                            int n_stages) {
  constexpr int kGroup = 32 / kMaxAngles;  // a multiple of stage_elems
  const int lane = threadIdx.x & 31, j = lane / kMaxAngles, a = lane % kMaxAngles;
  const long long n2 = n_t + 3;
  const float t_max = (float)n_t;
  const float bx0 = ring.box[0], bx1 = ring.box[1], bz0 = ring.box[2], bz1 = ring.box[3];
  int slot = 0;
  unsigned phase = 0;  // the parity of the ring's round
  for (int a0 = 0; a0 < n_a; a0 += kA) {
    const bool angle = a < min(kA, n_a - a0);
    const float sa = angle ? __ldg(sin_a + a0 + a) : 0.0f;
    const float ca = angle ? __ldg(cos_a + a0 + a) : 0.0f;
    for (int e0 = 0; e0 < n_e; e0 += kGroup) {
      const int e = e0 + j;
      const bool live = angle && e < n_e;
      const float exe = e < n_e ? __ldg(ex + e) : 0.0f, eze = e < n_e ? __ldg(ez + e) : 0.0f;
      long long g0 = 0;  // the window's first entry in rf2 (even)
      int len = 0, bias = 0;
      bool clipped = false;
      if (live) {
        float f_lo, f_hi;
        delay_bounds(sa, ca, bx0, bx1, bz0, bz1, exe, eze, inv_c, t_off, fs, f_lo, f_hi);
        // a bound that is not finite and ordered (NaN in the geometry) takes
        // the whole trace
        const bool sound = f_lo <= f_hi;
        clipped = !(sound && floorf(f_lo) >= -2.0f && floorf(f_hi) <= t_max);
        const int i_lo = sound ? (int)fminf(fmaxf(floorf(f_lo), -2.0f), t_max) : -2;
        const int i_hi = sound ? (int)fminf(fmaxf(floorf(f_hi), -2.0f), t_max) : n_t;
        const long long row = ((long long)(a0 + a) * n_e + e) * n2;
        g0 = (row + i_lo + 2) & ~1LL;
        len = (int)(((row + i_hi + 4) & ~1LL) - g0);
        bias = (int)(row + 2 - g0);
      }
      // the windows' places in their element's run of windows: a prefix sum
      int off = len;
#pragma unroll
      for (int k = 1; k < kA; k <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, off, k, kMaxAngles);
        if (a >= k) off += v;
      }
      const int run = __shfl_sync(0xffffffffu, off, j * kMaxAngles + kA - 1);
      off -= len;
      const unsigned clips = __ballot_sync(0xffffffffu, clipped);
      for (int jj = 0; jj < kGroup && e0 + jj < n_e; jj += stage_elems) {
        // the stage: elements e0 + jj, ..., their runs one after the other
        const bool mine = live && j >= jj && j < jj + stage_elems;
        int total = 0, before = 0;
        for (int k = 0; k < stage_elems; ++k) {
          const int r = __shfl_sync(0xffffffffu, run, (jj + k) * kMaxAngles);
          before += jj + k < j ? r : 0;
          total += r;
        }
        const int at = off + before;  // this lane's window in the stage
        const int clip =
            (clips >> (jj * kMaxAngles)) & ((1ull << (stage_elems * kMaxAngles)) - 1) ? 4 : 0;
        for (int p0 = 0; p0 < total; p0 += cap) {  // the stage's pieces, a slot each
          const int plen = min(cap, total - p0);
          if (lane == 0) mbar_wait(&ring.empty[slot], phase ^ 1u);
          __syncwarp();
          if (mine)
            ring.base[slot][j - jj][a] = smem_u32(s_ring + (size_t)slot * cap) +
                                         (unsigned)(bias + at - p0) * 8u - kRoundDownBits * 8u;
          if (a == 0 && j >= jj && j < jj + stage_elems)
            ring.pos[slot][j - jj] = make_float2(exe, eze);
          if (lane == 0)
            ring.piece[slot] =
                make_int2(plen, (total <= cap ? 1 : 0) | (p0 + cap >= total ? 2 : 0) | clip);
          __syncwarp();
          if (lane == 0) mbar_arrive_tx(&ring.full[slot], (unsigned)plen * 8u);
          __syncwarp();
          const int c0 = max(at, p0), c1 = min(at + len, p0 + plen);
          if (mine && c1 > c0)
            bulk_load(s_ring + (size_t)slot * cap + (c0 - p0), rf2 + g0 + (c0 - at),
                      (unsigned)(c1 - c0) * 8u, &ring.full[slot]);
          if (++slot == n_stages) {
            slot = 0;
            phase ^= 1u;
          }
        }
      }
    }
  }
}

// The consumer's taps on a slot: kWhole, a stage in one slot whose windows
// lie in the trace; kClipped, one whose windows are clipped at -2 or T;
// kPiece, a piece of a stage split over slots.
enum TapMode { kWhole, kClipped, kPiece };

// A consumer thread's taps on one slot: for each of its pixels and angles,
// one load from shared memory (kPiece: only where the tap's entry lies in
// this piece, the slot's plen entries from shared address win).  The
// index clamped to [-2, T] decides the masks as the plain version's int64
// index does (a delay off the trace reads a pair of zeros); the delay is
// clamped before its floor, which moves only the weights of such taps, and
// the pair of zeros makes each +0 all the same (a delay that is not finite
// makes NaN in both).  Where no window of the stage is clipped, every
// delay lies in the trace (delay_bounds) and the clamp is left out.
template <int kA, bool kTail, TapMode kMode>
__device__ __forceinline__ void das_taps(unsigned win, const unsigned (&base)[kA], int plen,
                                         int na, const float (&t_tx)[kPix][kA],
                                         const float (&t_rx)[kPix], float t_off, float fs,
                                         float t_max, float (&acc)[kPix][kA]) {
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      if (kTail && a >= na) continue;
      const float t_f = (t_tx[p][a] + t_rx[p] - t_off) * fs;
      const float t_c = kMode == kWhole ? t_f : fminf(fmaxf(t_f, -2.0f), t_max);
      const float r = __fadd_rd(t_c, kRoundDown);
      const float w = t_f - (r - kRoundDown);
      const unsigned at = base[a] + ((unsigned)__float_as_int(r) << 3);
      if (kMode == kPiece && at - win >= (unsigned)plen * 8u) continue;
      const float2 v = lds2(at);
      acc[p][a] = acc[p][a] + (v.x * (1.0f - w) + v.y * w);
    }
  }
}

// One pass over the elements for the angles [a0, a0 + kA) (the first na
// of them when kTail): each pixel's sum plus each angle's sum, added in
// angle order.
template <int kA, bool kTail>
__device__ __forceinline__ void das_consume(DasRing& ring, const float2* s_ring, int a0, int na,
                                            int n_e, const float (&px)[kPix],
                                            const float (&pz)[kPix],
                                            const float* __restrict__ sin_a,
                                            const float* __restrict__ cos_a, float inv_c,
                                            float t_off, float fs, float t_max,
                                            int stage_elems, int cap, int n_stages, int& slot,
                                            unsigned& phase, float (&sum)[kPix]) {
  float t_tx[kPix][kA], acc[kPix][kA];
#pragma unroll
  for (int a = 0; a < kA; ++a) {
    const bool live = !kTail || a < na;
    const float sa = live ? __ldg(sin_a + a0 + a) : 0.0f;
    const float ca = live ? __ldg(cos_a + a0 + a) : 0.0f;
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      t_tx[p][a] = (px[p] * sa + pz[p] * ca) * inv_c;
      acc[p][a] = 0.0f;
    }
  }
  for (int e0 = 0; e0 < n_e; e0 += stage_elems) {
    for (;;) {  // the stage's pieces
      mbar_wait(&ring.full[slot], phase);
      const int2 piece = ring.piece[slot];
      const unsigned win = smem_u32(s_ring + (size_t)slot * cap);
#pragma unroll
      for (int k = 0; k < kMaxStageElems; ++k) {
        if (k > 0 && (k >= stage_elems || e0 + k >= n_e)) break;
        const float2 pos = ring.pos[slot][k];
        float t_rx[kPix];
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          const float dx = px[p] - pos.x, dz = pz[p] - pos.y;
          t_rx[p] = __fsqrt_rn(dx * dx + dz * dz) * inv_c;
        }
        unsigned base[kA];
#pragma unroll
        for (int a = 0; a < kA; ++a) base[a] = ring.base[slot][k][a];
        if ((piece.y & 5) == 1)
          das_taps<kA, kTail, kWhole>(win, base, piece.x, na, t_tx, t_rx, t_off, fs, t_max, acc);
        else if (piece.y & 1)
          das_taps<kA, kTail, kClipped>(win, base, piece.x, na, t_tx, t_rx, t_off, fs, t_max,
                                        acc);
        else
          das_taps<kA, kTail, kPiece>(win, base, piece.x, na, t_tx, t_rx, t_off, fs, t_max, acc);
      }
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(&ring.empty[slot]);
      if (++slot == n_stages) {
        slot = 0;
        phase ^= 1u;
      }
      if (piece.y & 2) break;
    }
  }
#pragma unroll
  for (int p = 0; p < kPix; ++p)
#pragma unroll
    for (int a = 0; a < kA; ++a)
      if (!kTail || a < na) sum[p] = sum[p] + acc[p][a];
}

// kA = min(A, kMaxAngles) angles a pass; the last pass may hold fewer.  A
// block owns a tile of tile_wz x (kWarps kPix / tile_wz) warp tiles of
// kWarpZ x 32 / kWarpZ pixels (z by x); consumer thread (warp w, lane l)
// takes pixel l of warp tiles w, w + kWarps, ...; the ring holds n_stages
// slots of cap entries.
template <int kA>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
us_das_kernel(const float2* __restrict__ rf2, int n_a, int n_e, int n_t,
              const float* __restrict__ xg, int nx, const float* __restrict__ zg, int nz,
              const float* __restrict__ ex, const float* __restrict__ ez,
              const float* __restrict__ sin_a, const float* __restrict__ cos_a, float inv_c,
              float t_off, float fs, int tile_wz, int stage_elems, int cap, int n_stages,
              float* __restrict__ out) {
  __shared__ DasRing ring;
  extern __shared__ __align__(128) float2 s_ring[];
  constexpr int kWarpX = 32 / kWarpZ;
  const int tile_wx = kWarps * kPix / tile_wz;
  const int tz = kWarpZ * tile_wz, tx = kWarpX * tile_wx;
  const int n_tx = (nx + tx - 1) / tx;
  const int x0 = (blockIdx.x % n_tx) * tx, z0 = (blockIdx.x / n_tx) * tz;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < 2) {  // warp 0 the tile's x extent, warp 1 its z extent
    const float* grid = warp == 0 ? xg + x0 : zg + z0;
    const int cnt = warp == 0 ? min(tx, nx - x0) : min(tz, nz - z0);
    float lo = INFINITY, hi = -INFINITY;
    bool finite = true;
    for (int k = lane; k < cnt; k += 32) {
      const float v = __ldg(grid + k);
      finite = finite && isfinite(v);
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, k));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, k));
    }
    finite = __all_sync(0xffffffffu, finite);
    if (lane == 0) {
      ring.box[2 * warp] = finite ? lo : NAN;
      ring.box[2 * warp + 1] = finite ? hi : NAN;
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kWarps) {
    das_produce<kA>(ring, s_ring, rf2, n_a, n_e, n_t, ex, ez, sin_a, cos_a, inv_c, t_off, fs,
                    stage_elems, cap, n_stages);
    return;
  }
  float px[kPix], pz[kPix], sum[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {  // a ragged tile's pixels past the grid repeat its last
    const int wt = warp + kWarps * p;
    const int x = x0 + (wt / tile_wz) * kWarpX + lane / kWarpZ;
    const int z = z0 + (wt % tile_wz) * kWarpZ + lane % kWarpZ;
    px[p] = __ldg(xg + min(x, nx - 1));
    pz[p] = __ldg(zg + min(z, nz - 1));
    sum[p] = 0.0f;
  }
  const float t_max = (float)n_t;
  int slot = 0;
  unsigned phase = 0;
  for (int a0 = 0; a0 < n_a; a0 += kA) {
    if (n_a - a0 >= kA)
      das_consume<kA, false>(ring, s_ring, a0, kA, n_e, px, pz, sin_a, cos_a, inv_c, t_off, fs,
                             t_max, stage_elems, cap, n_stages, slot, phase, sum);
    else
      das_consume<kA, true>(ring, s_ring, a0, n_a - a0, n_e, px, pz, sin_a, cos_a, inv_c, t_off,
                            fs, t_max, stage_elems, cap, n_stages, slot, phase, sum);
  }
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int wt = warp + kWarps * p;
    const int x = x0 + (wt / tile_wz) * kWarpX + lane / kWarpZ;
    const int z = z0 + (wt % tile_wz) * kWarpZ + lane % kWarpZ;
    if (x < nx && z < nz) out[(size_t)x * nz + z] = sum[p];
  }
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
// The window bound.  delay_bounds over the tile's box: the taps lie in
// [floor(t_f min), floor(t_f max) + 1], clipped to [0, T).
// tests/test_torch_cuda.py holds it on tiles clipping at 0 and at T, in
// both modes.
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
      float f_lo, f_hi;
      delay_bounds(__ldg(sin_a + a), __ldg(cos_a + a), s_box[0], s_box[1], s_box[2], s_box[3],
                   exe, eze, inv_c, t_off, fs, f_lo, f_hi);
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

// rf2 [A, E, T + 3] float2 (us_das_pack_launch's), 16 bytes readable past
// its end (a window's copy is widened to 16-byte bounds), T below 2^22 (the
// round-down add's range); x grid [Nx], z grid [Nz]; element positions [E]
// (x, z); sin and cos of the angles [A]; out [Nx, Nz].  The planner's
// launch (us/beamform.py::das_plan): the pixel tile (tile_wz warp tiles
// along z, a divisor of kWarps kPix), the elements a stage (stage_elems)
// and the entries a slot of the ring holds (cap, even; at least 2 slots
// in kRingBytes).
extern "C" int us_das_launch(const void* rf2, int n_a, int n_e, int n_t, const void* xg, int nx,
                             const void* zg, int nz, const void* ex, const void* ez,
                             const void* sin_a, const void* cos_a, float inv_c, float t_off,
                             float fs, int tile_wz, int stage_elems, int cap, void* out,
                             void* stream) {
  if (n_a <= 0 || n_e <= 0 || n_t <= 0 || n_t >= (1 << 22) || nx <= 0 || nz <= 0 ||
      (long long)nx * nz > 0x7fffffffLL || tile_wz <= 0 || (kWarps * kPix) % tile_wz != 0 ||
      stage_elems < 1 || stage_elems > kMaxStageElems || (32 / kMaxAngles) % stage_elems != 0 ||
      cap < 2 || cap % 2 != 0 || cap > kRingBytes / 16)
    return (int)cudaErrorInvalidValue;
  const int tz = kWarpZ * tile_wz, tx = (32 / kWarpZ) * (kWarps * kPix / tile_wz);
  const long long n_tiles = (long long)((nx + tx - 1) / tx) * ((nz + tz - 1) / tz);
  const int n_stages = min(kStages, kRingBytes / (8 * cap));
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = n_stages * cap * (int)sizeof(float2);
  const dim3 grid((unsigned)n_tiles);
  cudaStream_t s = (cudaStream_t)stream;
#define US_DAS_LAUNCH(KA)                                                                     \
  do {                                                                                        \
    const cudaError_t err = cudaFuncSetAttribute(                                             \
        us_das_kernel<KA>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);                \
    if (err != cudaSuccess) return (int)err;                                                  \
    us_das_kernel<KA><<<grid, kThreads, smem, s>>>(                                           \
        (const float2*)rf2, n_a, n_e, n_t, (const float*)xg, nx, (const float*)zg, nz,        \
        (const float*)ex, (const float*)ez, (const float*)sin_a, (const float*)cos_a, inv_c,  \
        t_off, fs, tile_wz, stage_elems, cap, n_stages, (float*)out);                         \
  } while (0)
  switch (n_a < kMaxAngles ? n_a : kMaxAngles) {
    case 1: US_DAS_LAUNCH(1); break;
    case 2: US_DAS_LAUNCH(2); break;
    case 3: US_DAS_LAUNCH(3); break;
    case 4: US_DAS_LAUNCH(4); break;
    case 5: US_DAS_LAUNCH(5); break;
    case 6: US_DAS_LAUNCH(6); break;
    case 7: US_DAS_LAUNCH(7); break;
    default: US_DAS_LAUNCH(kMaxAngles); break;
  }
#undef US_DAS_LAUNCH
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
