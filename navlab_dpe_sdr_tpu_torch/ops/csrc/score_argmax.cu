// Manifold scoring for Hopper (sm_90a): the streaming argmax over a whole
// grid (K1), per block or of the scores summed over all blocks, and the
// full score surface of a block (K2), one kernel.
//
// K1 replaces the TPU kernel navlab_dpe_sdr_tpu/ops/pallas_score.py
// _chunk_kernel / score_chunk_pallas, and the XLA scorer the JAX product
// path runs in its place (ops/dpe_real.py _score_chunk under
// _local_argmax_scan). K2 replaces _score_kernel / score_manifold_pallas of
// the same file: the per-block step's [G] scores (ops/dpe_real.py
// score_manifolds_mag), which the score-weighted mean and the score dumps
// need whole. The block-summed modes replace what the JAX package leaves to
// XLA around the same scorer (ops/dpe_real.py _score_axis_accumulate ->
// _local_argmax_scan(block_sum=True): integrated DPE and the multi-epoch
// survey solve). For block n and grid point g (offsets o3 [G, 3], o1 [G]):
//
//   u_c   = los[n, c] . o3[g]
//   idx_c = center[n, c] + coef[n, c] * (-u_c + (|o3|^2 - u_c^2) * h[n, c]
//                                        + o1[g])     (h = 1 / (2 r0[n, c]);
//                                                      position manifold only)
//   s     = sum_c interp(win[n, c, :], idx_c) ^ l_power
//
// with interp the 3-tap Lagrange value about k = clip(rint(idx), 1, W-2),
// evaluated as a_k + d (b_k + d c_k), d = idx - k, a_k = win[k],
// b_k = (win[k+1] - win[k-1]) / 2, c_k = (win[k+1] + win[k-1]) / 2 - win[k]
// ("quadratic"), or hat weights on floor(idx), floor(idx)+1 inside
// [0, W-1] ("linear"), or sum_k win[k] sinc(idx - k) over the whole window,
// no clamp ("sinc": sin(pi x) / (pi x), 1 at x = 0). Out: best[n] = max_g s,
// arg[n] = the first g at that max; when weighted the sums of s*[o3, o1]
// (wsum4[n, 4]) and of s (wtot[n]); in surface mode also every s
// (surface[n, g]). In the block-summed modes S(g) = sum_n s(n, g), added in
// f32 in ascending n, takes the place of s, and the outputs are one slot:
// best[0], arg[0], wsum4[0, 4], wtot[0].
//
// What bounds it on the card: f32 instruction rate and, beside it, the
// shared-memory reads, not device memory. The main path's 390 625-point
// manifolds hold 6.25 MB of offsets, which stay in the 50 MB L2, and each
// point-channel costs 22 f32 operations of the plain form (18 without the
// curvature term). An earlier form of this kernel spent most of its time on
// six broadcast shared-memory loads of the per-channel parameters and a
// division per point-channel; both are gone (see Design). The kernel is
// built without FMA contraction (ops/_build.py) so that every score has
// the bits of the plain PyTorch version (ops/score.py score_points); an
// operations bound that counts a fused multiply-add as two can therefore
// be reached by half at most. At N = 1 (the per-block step) the 1.56 MB
// surface store and one wave of thread blocks are what is left: the
// kernel's time there is a few launches' worth.
//
// The factored kernel (score_kernel_factored, the argmax modes 0 and 3,
// quadratic and linear): every grid style the receiver builds is a
// Cartesian product whose clock axis varies fastest, g = s * L + j, offsets
// (o3u[s], o1u[j]), so u_c and the range term -u_c (+ curvature) depend on
// the spatial point s alone. The caller finds the factors once per grid
// (ops/score.py grid_factors) and passes them in; a thread then owns one
// spatial point and kT consecutive clock values of it, forms the range
// term once per (block, channel) and runs only idx, the clip and the
// interpolation per point: 9 of the position manifold's 22 operations a
// point-channel (5 of the velocity's 18) are paid once per kT points. Each
// score is the same f32 operations on the same operands in the same order
// as in the per-point form, so its bits are the same, and the reduction
// keeps the first index at the maximum in any order. The weighted modes
// (1 and 4) run the per-point kernel: a factored form had to restage its
// scores into the per-point mapping to keep the f64 partials' order, and
// was slower on an H100 in 5 of 6 cases measured (PERF.md). What is left a
// point bounds it: idx 3, the clip and the tap index 5, the tap read, the
// interpolation 4 and the sum 1, issued at the f32 rate (a variant that
// read a tap once for neighbouring clock values that round to it saved
// shared-memory reads and was slower: PERF.md). kT = 5 divides both of the
// receiver's clock axes (25 and 75) and fills the card on the spread grid;
// where the tiles at kT = 25 still fill the card alone (the dense grid)
// they take 25, with the tap index rounded by the 1.5 * 2^23 shift
// (window_value), which with rintf and its conversion was slower there: on
// an H100 the dense grid's N = 50 launch took 8.55 and 7.92 ms (position,
// velocity) against 8.89 and 8.73 at kT = 5 and 12.26 and 10.58 per point.
//
// Design.
// - A thread owns kP consecutive grid points (16-byte loads of their
//   offsets, started before the first barrier) with |o3|^2, in registers,
//   across a loop over its share of the N blocks: offsets are read once per
//   share, not once per block, and each (n, c) parameter load (two
//   broadcast 16-byte loads) serves kP points. Channel loop outside, point
//   loop inside: kP independent interpolation chains.
// - Windows and parameters of a batch of blocks are staged in shared memory
//   at once (one barrier pair per batch, not per block). What depends on
//   (n, c) alone is formed there once: 1 / (2 r0), and per tap the
//   coefficients (a, b, c) as one float4, so a point-channel reads one
//   16-byte tap entry and evaluates 4 operations instead of three loads and
//   11. Above 48 KB the batch is one block in opt-in dynamic shared memory.
// - The launch grid is (tiles of kThreads*kP points, shares of N). Shares
//   are sized so the card holds several waves of thread blocks at N = 50
//   and 10; at N = 1 the tiles alone are one wave. Offsets that are not
//   16-byte aligned take kP = 1 and scalar loads.
// - l_power (1, 2, general), the mode (argmax, weighted, surface) and kP are
//   template parameters: the argmax-only main path carries no doubles.
// - Reduction: a thread keeps the first maximum of its kP points, a warp
//   takes __reduce_max_sync on an order-preserving integer key of the score
//   and __reduce_min_sync on the indices at that key, lane 0 parks the pair
//   in shared memory, and after the batch's barrier one lane of warp 0 per
//   block n folds the warps and makes a single 64-bit atomicMax on
//   (key << 32 | ~index): (max, smallest index) in any order of arrival.
//   A ticket per block n tells the tile that arrives last: its lane decodes
//   best/arg, warp 0 sums the weighted partials of every tile in tile order
//   (f64, no floating atomics: the same bits run to run), and both scratch
//   words go back to zero for the next launch. No second kernel, no memset,
//   and no barrier beyond the two of a batch (staged; scored).
// - Block-summed modes: one share holds all of N (gridDim.y = 1), a thread's
//   kP sums stay in registers across every batch, and the reduction above
//   runs once, after the last batch, into slot 0. N is not split over
//   thread blocks: floating atomics would lose the order of the sum, and
//   with it bit-equality with the plain version and repeatability. With no
//   second grid axis the tiles alone must fill the card; four points a
//   thread still won over two and one at every shape read, down to the 382
//   tiles of a 390 625-point grid, so kP stays 4 (make_plan). Splitting N
//   over a thread-block cluster of R = 2, 4 or 8 a tile, each rank scoring
//   a contiguous share of n and the owners adding the partials in ascending
//   n through distributed shared memory (the same bits for every R), was
//   slower on an H100 at N = 8, 25 and 50 on that grid: at 2.9 blocks an SM
//   a block n already costs what it costs in the per-block modes, and a
//   split adds its staging, barriers and tails (PERF.md).
// - sinc: sin(pi (idx - k)) = (-1)^k sin(pi idx), so a point-channel takes
//   one sinpif(idx) for all W taps, and sum_k win[k] sinc(idx - k) =
//   sin(pi idx) / pi * sum_k (-1)^k win[k] / (idx - k). The window is staged
//   with its signs, (-1)^k win[k] (W floats a channel), and two taps share
//   one approximate reciprocal: a / da + b / db = (a db + b da) / (da db).
//   An integer idx (sinpif exactly 0) takes win[idx] inside the window and
//   0 outside. The tap loop runs outside the thread's kP points, so a pair
//   of taps is read from shared memory once for all of them. The form
//   differs from torch.sinc's rounding, not its function: scores agree to
//   rtol 1e-5 (the earlier form, a sinpif and a division per tap and point,
//   was ~25 instructions a tap; this one is ~4). l_power is a run-time
//   argument.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kParF = 8;          // floats per (n, c): los e, n, u, h | center, coef, 0, 0
constexpr int kMaxBatch = 32;     // blocks n staged at once, at most
constexpr int kBatchBytes = 48 * 1024;        // staging budget: no opt-in, >= 4 blocks per SM
constexpr int kMaxDynShared = 200 * 1024;     // the widest single block n accepted
constexpr unsigned kFull = 0xffffffffu;
constexpr int kClockStep = 5;         // factored: clock values a thread, kT
constexpr int kWideStep = 25;         // factored, on a grid whose tiles at 25 fill the card

enum Mode { kArgmax = 0, kWeighted = 1, kSurface = 2, kSumArgmax = 3, kSumWeighted = 4 };
enum Interp { kQuadratic = 0, kLinear = 1, kSinc = 2 };

__host__ __device__ constexpr bool sums_blocks(int mode) { return mode == kSumArgmax || mode == kSumWeighted; }
__host__ __device__ constexpr bool is_weighted(int mode) { return mode == kWeighted || mode == kSumWeighted; }
constexpr float kPi = 3.14159265358979323846f;

struct Args {
  const float* win;      // [N, C, W] contiguous
  const float* los;      // [N, C, 3] by strides
  const float* centers;  // [N, C] by strides
  const float* coefs;    // [N, C] by strides
  const float* r0;       // [N, C] by strides, or null (velocity manifold)
  const float* off3;     // [G, 3] contiguous
  const float* off1;     // [G]
  const float* o3u;      // [G / run, 3] (factored: a product grid's spatial points)
  const float* o1u;      // [run]        (factored: its clock values)
  int run;               // factored: the clock axis's length, L
  int los_sn, los_sc, los_sj, cen_sn, cen_sc, coef_sn, coef_sc, r0_sn, r0_sc;
  int n_blocks, n_chan, width, n_grid, l_power;
  int n_per_share, n_batch;
  float* surface;                // [N, G] (surface mode)
  // below, N is 1 in the block-summed modes
  unsigned long long* packed;    // [N] scratch, zero between launches
  unsigned int* ticket;          // [N] scratch, zero between launches
  double* part_w;                // [N, tiles, 5] scratch (weighted modes)
  float* best;                   // [N]
  int* arg;                      // [N]
  float* wsum4;                  // [N, 4] (weighted modes)
  float* wtot;                   // [N]    (weighted modes)
};

// Order-preserving map of a float onto an unsigned integer, and back.
__device__ __forceinline__ unsigned ordered_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// A spatial point's range term for one channel: -u, with the curvature
// term on the position manifold. It does not depend on the clock offset.
template <bool kQuad>
__device__ __forceinline__ float point_range(const float4 pa, float x, float y, float z,
                                             float d2) {
  const float u = pa.x * x + pa.y * y + pa.z * z;
  return kQuad ? -u + (d2 - u * u) * pa.w : -u;
}

// A grid point's fractional window index for one channel.
template <bool kQuad>
__device__ __forceinline__ float point_index(const float4 pa, const float4 pb, float x,
                                             float y, float z, float t, float d2) {
  return pb.x + pb.y * (point_range<kQuad>(pa, x, y, z, d2) + t);
}

template <int kLP>
__device__ __forceinline__ float to_power(float v, int l_power) {
  if (kLP == 1) return v;
  if (kLP == 2) return v * v;
  float vp = v;
  for (int i = 1; i < l_power; ++i) vp *= v;
  return vp;
}

// One channel's interpolated window value at a fractional index, to
// l_power: the f32 operations of ops/score.py score_points, in their order
// (quadratic and linear). kShift: the quadratic tap's index by the
// 1.5 * 2^23 shift (below) in place of rintf and a conversion.
template <int kInterp, int kLP, bool kShift = false>
__device__ __forceinline__ float window_value(const float* __restrict__ taps, int width,
                                              int l_power, float idx) {
  float v;
  if (kInterp == kLinear) {
    const float wmax = (float)(width - 1);
    const float k0 = floorf(idx);
    const float k1 = k0 + 1.0f;
    v = 0.0f;
    if (k0 >= 0.0f && k0 <= wmax) v += fmaxf(0.0f, 1.0f - fabsf(idx - k0)) * taps[(int)k0];
    if (k1 >= 0.0f && k1 <= wmax) v += fmaxf(0.0f, 1.0f - fabsf(idx - k1)) * taps[(int)k1];
  } else if (kShift) {
    // clip(rint(idx), 1, W-2) == rint(clip(idx, 1, W-2)) for integer bounds
    // (NaN clips to 1 in both), and on [1, W-2] adding 1.5 * 2^23 rounds to
    // the nearest integer, half to even, as rintf does: the same k0, and
    // its integer is in the sum's low mantissa bits
    const float r = fminf(fmaxf(idx, 1.0f), (float)(width - 2)) + 12582912.0f;
    const float k0 = r - 12582912.0f;
    const float d = idx - k0;
    const float4 q = reinterpret_cast<const float4*>(taps)[__float_as_int(r) - 0x4B400000];
    v = q.x + d * (q.y + d * q.z);
  } else {
    const float k0 = fminf(fmaxf(rintf(idx), 1.0f), (float)(width - 2));
    const float d = idx - k0;
    const float4 q = reinterpret_cast<const float4*>(taps)[(int)k0];
    v = q.x + d * (q.y + d * q.z);
  }
  return to_power<kLP>(v, l_power);
}

// One channel's interpolated window value at one grid point, to l_power.
template <bool kQuad, int kInterp, int kLP>
__device__ __forceinline__ float channel_score(const float4 pa, const float4 pb,
                                               const float* __restrict__ taps,
                                               int width, int l_power, float x,
                                               float y, float z, float t, float d2) {
  return window_value<kInterp, kLP>(taps, width, l_power,
                                    point_index<kQuad>(pa, pb, x, y, z, t, d2));
}

// One channel's sinc values at a thread's kP grid points, to l_power (taps:
// (-1)^k win[k], stage_batch): one sinpif a point, then the taps in pairs,
// each pair read once for all kP points.
template <bool kQuad, int kP>
__device__ __forceinline__ void sinc_values(const float4 pa, const float4 pb,
                                            const float* __restrict__ taps, int width,
                                            int l_power, const float (&x)[kP],
                                            const float (&y)[kP], const float (&z)[kP],
                                            const float (&t)[kP], const float (&d2)[kP],
                                            float (&v)[kP]) {
  float idx[kP], acc[kP];
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    idx[j] = point_index<kQuad>(pa, pb, x[j], y[j], z[j], t[j], d2[j]);
    acc[j] = 0.0f;
  }
  int k = 0;
  float kf = 0.0f;
  for (; k + 1 < width; k += 2, kf += 2.0f) {
    const float ta = taps[k], tb = taps[k + 1];
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const float da = idx[j] - kf, db = idx[j] - (kf + 1.0f);
      const float num = __fmaf_rn(ta, db, tb * da);
      acc[j] = __fmaf_rn(num, __fdividef(1.0f, da * db), acc[j]);
    }
  }
  if (k < width) {
    const float ta = taps[k];
#pragma unroll
    for (int j = 0; j < kP; ++j) acc[j] = __fmaf_rn(ta, __fdividef(1.0f, idx[j] - kf), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const float sp = sinpif(idx[j]);
    float vj = acc[j] * (sp * (1.0f / kPi));
    if (sp == 0.0f) {                      // an integer idx: its own tap alone
      vj = 0.0f;
      if (idx[j] >= 0.0f && idx[j] <= (float)(width - 1)) {
        const int kk = (int)idx[j];
        vj = (kk & 1) ? -taps[kk] : taps[kk];
      }
    }
    v[j] = to_power<0>(vj, l_power);
  }
}

// Parameters and windows of blocks n0 .. n0+nb-1 into shared memory.
template <bool kQuad, int kInterp>
__device__ __forceinline__ void stage_batch(const Args& a, int n0, int nb,
                                            float* s_par, float* s_tap) {
  const int C = a.n_chan, W = a.width;
  float4* par4 = reinterpret_cast<float4*>(s_par);
  for (int i = threadIdx.x; i < nb * C; i += kThreads) {
    const int n = n0 + i / C, c = i % C;
    const float* l = a.los + (size_t)n * a.los_sn + (size_t)c * a.los_sc;
    float h = 0.0f;
    if (kQuad) h = 1.0f / (2.0f * a.r0[(size_t)n * a.r0_sn + (size_t)c * a.r0_sc]);
    par4[2 * i] = make_float4(l[0], l[a.los_sj], l[2 * (size_t)a.los_sj], h);
    par4[2 * i + 1] = make_float4(a.centers[(size_t)n * a.cen_sn + (size_t)c * a.cen_sc],
                                  a.coefs[(size_t)n * a.coef_sn + (size_t)c * a.coef_sc],
                                  0.0f, 0.0f);
  }
  const float* w = a.win + (size_t)n0 * C * W;
  if (kInterp == kSinc) {                    // (-1)^k win[k]
    for (int i = threadIdx.x; i < nb * C * W; i += kThreads)
      s_tap[i] = (i % W) & 1 ? -w[i] : w[i];
  } else if (kInterp == kLinear) {
    for (int i = threadIdx.x; i < nb * C * W; i += kThreads) s_tap[i] = w[i];
  } else {
    // two rounds of loads in flight before the first store
    float4* tap4 = reinterpret_cast<float4*>(s_tap);
    const int total = nb * C * W;
    for (int i0 = threadIdx.x; i0 < total; i0 += 2 * kThreads) {
      float w0[2], wm[2], wp[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + r * kThreads, k = i % W;
        const bool mid = i < total && k >= 1 && k <= W - 2;
        w0[r] = i < total ? w[i] : 0.0f;
        wm[r] = mid ? w[i - 1] : 0.0f;
        wp[r] = mid ? w[i + 1] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + r * kThreads;
        if (i < total)     // (b, c of the edge taps k = 0, W-1 are never read)
          tap4[i] = make_float4(w0[r], 0.5f * (wp[r] - wm[r]),
                                0.5f * (wp[r] + wm[r]) - w0[r], 0.0f);
      }
    }
  }
}

// The kP points of a thread: 16-byte loads when all four lie inside the grid
// (the caller sends kP = 4 only with 16-byte-aligned offsets), scalar loads
// otherwise, and zeros past the ragged end.
template <int kP>
__device__ __forceinline__ void load_points(const float* __restrict__ off3,
                                            const float* __restrict__ off1,
                                            int g0, int n_grid, float (&x)[kP],
                                            float (&y)[kP], float (&z)[kP],
                                            float (&t)[kP]) {
  if (kP == 4 && g0 + 3 < n_grid) {
    const float4* q = reinterpret_cast<const float4*>(off3 + 3 * (size_t)g0);
    const float4 a = q[0], b = q[1], c = q[2];
    const float4 tt = *reinterpret_cast<const float4*>(off1 + g0);
    x[0] = a.x; y[0] = a.y; z[0] = a.z;
    x[1 % kP] = a.w; y[1 % kP] = b.x; z[1 % kP] = b.y;
    x[2 % kP] = b.z; y[2 % kP] = b.w; z[2 % kP] = c.x;
    x[3 % kP] = c.y; y[3 % kP] = c.z; z[3 % kP] = c.w;
    t[0] = tt.x; t[1 % kP] = tt.y; t[2 % kP] = tt.z; t[3 % kP] = tt.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const bool in = g0 + j < n_grid;
    x[j] = in ? off3[3 * (size_t)(g0 + j) + 0] : 0.0f;
    y[j] = in ? off3[3 * (size_t)(g0 + j) + 1] : 0.0f;
    z[j] = in ? off3[3 * (size_t)(g0 + j) + 2] : 0.0f;
    t[j] = in ? off1[g0 + j] : 0.0f;
  }
}

// The first maximum of a thread's kP values and of its warp, parked in slot
// `slot` of s_red; in the weighted modes also the warp's f64 sums of
// value * [x, y, z, t] and of the values, in s_w.
template <int kP, int kMode>
__device__ __forceinline__ void park_slot(const float (&acc)[kP], const float (&x)[kP],
                                          const float (&y)[kP], const float (&z)[kP],
                                          const float (&t)[kP], int g0, int G, int slot,
                                          unsigned long long* s_red, double* s_w) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  unsigned key = 0u, idx = kFull;
  if (g0 < G) {
    float b = acc[0];
    int bj = 0;
#pragma unroll
    for (int j = 1; j < kP; ++j)
      if (g0 + j < G && acc[j] > b) {
        b = acc[j];
        bj = j;
      }
    key = ordered_key(b + 0.0f);      // -0 scores as +0, as in a comparison
    idx = (unsigned)(g0 + bj);
  }
  const unsigned kmax = __reduce_max_sync(kFull, key);
  const unsigned imin = __reduce_min_sync(kFull, key == kmax ? idx : kFull);
  if (lane == 0) s_red[slot * kWarps + warp] = ((unsigned long long)kmax << 32) | (~imin);

  if (is_weighted(kMode)) {
    double w[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int j = 0; j < kP; ++j)
      if (g0 + j < G) {
        w[0] += (double)acc[j] * x[j];
        w[1] += (double)acc[j] * y[j];
        w[2] += (double)acc[j] * z[j];
        w[3] += (double)acc[j] * t[j];
        w[4] += (double)acc[j];
      }
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      for (int off = 16; off > 0; off >>= 1) w[q] += __shfl_down_sync(kFull, w[q], off);
      if (lane == 0) s_w[(slot * kWarps + warp) * 5 + q] = w[q];
    }
  }
}

// The first maximum of a thread's kT consecutive points gs.. that lie in
// [lo, hi), and of its warp, parked in slot `slot` of s_red (the factored
// kernel's argmax modes).
template <int kT>
__device__ __forceinline__ void park_piece(const float (&acc)[kT], int gs, int lo, int hi,
                                           int slot, unsigned long long* s_red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  unsigned key = 0u, idx = kFull;
  int bj = -1;
  float b = 0.0f;
#pragma unroll
  for (int j = 0; j < kT; ++j)
    if (gs + j >= lo && gs + j < hi && (bj < 0 || acc[j] > b)) {
      b = acc[j];
      bj = j;
    }
  if (bj >= 0) {
    key = ordered_key(b + 0.0f);
    idx = (unsigned)(gs + bj);
  }
  const unsigned kmax = __reduce_max_sync(kFull, key);
  const unsigned imin = __reduce_min_sync(kFull, key == kmax ? idx : kFull);
  if (lane == 0) s_red[slot * kWarps + warp] = ((unsigned long long)kmax << 32) | (~imin);
}

// Warp 0, after the barrier that follows park_slot: lane i < nb folds the
// warps' pairs of slot i into output slot n0 + i (one atomicMax, the
// weighted partials of this tile, a ticket), and the tile that arrives last
// writes the slot's outputs and zeroes its scratch.
template <int kMode>
__device__ __forceinline__ void publish_slots(const Args& a, int n0, int nb,
                                              const unsigned long long* s_red,
                                              const double* s_w) {
  const int lane = threadIdx.x % 32;
  const int n = n0 + lane;
  bool last = false;
  if (lane < nb) {
    unsigned long long m = s_red[lane * kWarps];
    for (int wv = 1; wv < kWarps; ++wv) m = max(m, s_red[lane * kWarps + wv]);
    atomicMax(a.packed + n, m);
    if (is_weighted(kMode)) {
      double* pw = a.part_w + ((size_t)n * gridDim.x + blockIdx.x) * 5;
      for (int q = 0; q < 5; ++q) {
        double s = s_w[lane * kWarps * 5 + q];
        for (int wv = 1; wv < kWarps; ++wv) s += s_w[(lane * kWarps + wv) * 5 + q];
        pw[q] = s;
      }
    }
    __threadfence();
    last = atomicAdd(a.ticket + n, 1u) == gridDim.x - 1u;
    if (last) {                          // every tile of slot n has arrived
      __threadfence();
      const unsigned long long best = atomicExch(a.packed + n, 0ull);
      a.ticket[n] = 0u;
      a.best[n] = key_value((unsigned)(best >> 32));
      a.arg[n] = (int)(~(unsigned)(best & 0xffffffffull));
    }
  }
  if (is_weighted(kMode)) {
    // the weighted sums of each finished slot: lane q sums component q
    unsigned done = __ballot_sync(kFull, last);
    __syncwarp();
    while (done) {
      const int i = __ffs(done) - 1;
      done &= done - 1;
      if (lane < 5) {
        const double* pw = a.part_w + (size_t)(n0 + i) * gridDim.x * 5 + lane;
        double s = 0.0;
        for (unsigned tile = 0; tile < gridDim.x; ++tile) s += __ldcg(pw + (size_t)tile * 5);
        if (lane < 4) a.wsum4[(n0 + i) * 4 + lane] = (float)s;
        else a.wtot[n0 + i] = (float)s;
      }
    }
  }
}

template <bool kQuad, int kInterp, int kP, int kLP, int kMode>
__global__ void __launch_bounds__(kThreads) score_kernel(const Args a) {
  // dynamic shared memory: [red: n_batch * kWarps u64]
  // [wsum: n_batch * kWarps * 5 f64, weighted only] [par] [taps]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.n_chan, W = a.width, G = a.n_grid;
  const int tapf = kInterp == kQuadratic ? 4 * W : W;
  unsigned long long* s_red = reinterpret_cast<unsigned long long*>(smem_raw);
  double* s_w = reinterpret_cast<double*>(s_red + a.n_batch * kWarps);
  float* s_par = reinterpret_cast<float*>(
      s_w + (is_weighted(kMode) ? a.n_batch * kWarps * 5 : 0));
  float* s_tap = s_par + a.n_batch * C * kParF;

  const int g0 = (blockIdx.x * kThreads + threadIdx.x) * kP;
  float x[kP], y[kP], z[kP], t[kP], d2[kP];
  load_points<kP>(a.off3, a.off1, g0, G, x, y, z, t);
#pragma unroll
  for (int j = 0; j < kP; ++j) d2[j] = x[j] * x[j] + y[j] * y[j] + z[j] * z[j];

  float total[kP];                           // block-summed modes: S(g)
#pragma unroll
  for (int j = 0; j < kP; ++j) total[j] = 0.0f;

  const int n_begin = blockIdx.y * a.n_per_share;
  const int n_end = min(a.n_blocks, n_begin + a.n_per_share);
  for (int n0 = n_begin; n0 < n_end; n0 += a.n_batch) {
    const int nb = min(a.n_batch, n_end - n0);
    // no barrier before restaging: every thread read the last batch's
    // windows for the last time before the barrier that ended its scoring
    stage_batch<kQuad, kInterp>(a, n0, nb, s_par, s_tap);
    __syncthreads();

    for (int i = 0; i < nb; ++i) {
      const float4* par4 = reinterpret_cast<const float4*>(s_par) + 2 * i * C;
      const float* taps = s_tap + (size_t)i * C * tapf;
      float acc[kP];
#pragma unroll
      for (int j = 0; j < kP; ++j) acc[j] = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float4 pa = par4[2 * c], pb = par4[2 * c + 1];
        const float* tc = taps + c * tapf;
        if constexpr (kInterp == kSinc) {
          float v[kP];
          sinc_values<kQuad, kP>(pa, pb, tc, W, a.l_power, x, y, z, t, d2, v);
#pragma unroll
          for (int j = 0; j < kP; ++j) acc[j] += v[j];
        } else {
#pragma unroll
          for (int j = 0; j < kP; ++j)
            acc[j] += channel_score<kQuad, kInterp, kLP>(pa, pb, tc, W, a.l_power, x[j],
                                                         y[j], z[j], t[j], d2[j]);
        }
      }

      if (sums_blocks(kMode)) {              // one f32 add per block, ascending n
#pragma unroll
        for (int j = 0; j < kP; ++j) total[j] += acc[j];
        continue;
      }

      if (kMode == kSurface) {
        float* out = a.surface + (size_t)(n0 + i) * G + g0;
        if (kP == 4 && g0 + 3 < G && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
          *reinterpret_cast<float4*>(out) =
              make_float4(acc[0], acc[1 % kP], acc[2 % kP], acc[3 % kP]);
        } else {
#pragma unroll
          for (int j = 0; j < kP; ++j)
            if (g0 + j < G) out[j] = acc[j];
        }
      }
      park_slot<kP, kMode>(acc, x, y, z, t, g0, G, i, s_red, s_w);
    }

    __syncthreads();                         // every warp's pairs are parked
    if (!sums_blocks(kMode) && threadIdx.x < 32)
      publish_slots<kMode>(a, n0, nb, s_red, s_w);   // lane i owns block n0 + i
  }

  if (sums_blocks(kMode)) {
    park_slot<kP, kMode>(total, x, y, z, t, g0, G, 0, s_red, s_w);
    __syncthreads();
    if (threadIdx.x < 32) publish_slots<kMode>(a, 0, 1, s_red, s_w);
  }
}

// The factored kernel: a product grid, g = s * L + j with offsets
// (o3u[s], o1u[j]), argmax modes only. A thread owns kT consecutive clock
// values j of one spatial point s (x, y, z, |o3|^2 in registers) and forms
// the range term once per (block, channel) for all of them; a tile is
// kThreads such pieces.
template <bool kQuad, int kInterp, int kT, int kLP, int kMode>
__global__ void __launch_bounds__(kThreads) score_kernel_factored(const Args a) {
  // dynamic shared memory: [red: n_batch * kWarps u64] [par] [taps]
  static_assert(!is_weighted(kMode), "the weighted modes run the per-point kernel");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.n_chan, W = a.width, G = a.n_grid, L = a.run;
  const int tapf = kInterp == kQuadratic ? 4 * W : W;
  unsigned long long* s_red = reinterpret_cast<unsigned long long*>(smem_raw);
  float* s_par = reinterpret_cast<float*>(s_red + a.n_batch * kWarps);
  float* s_tap = s_par + a.n_batch * C * kParF;

  // this thread's piece: grid points gs .. gs + kT - 1 of spatial point s
  const int t0 = blockIdx.x * kThreads * kT;
  const int t1 = min(t0 + kThreads * kT, G);
  const int gs = t0 + (int)threadIdx.x * kT;
  const bool active = gs < t1;
  float x = 0.0f, y = 0.0f, z = 0.0f, t[kT];
#pragma unroll
  for (int k = 0; k < kT; ++k) t[k] = 0.0f;
  if (active) {
    const int s = gs / L, j0 = gs - s * L;
    x = a.o3u[3 * (size_t)s + 0];
    y = a.o3u[3 * (size_t)s + 1];
    z = a.o3u[3 * (size_t)s + 2];
#pragma unroll
    for (int k = 0; k < kT; ++k) t[k] = a.o1u[j0 + k];
  }
  const float d2 = x * x + y * y + z * z;

  float total[kT];                           // block-summed mode: S(g)
#pragma unroll
  for (int k = 0; k < kT; ++k) total[k] = 0.0f;

  const int n_begin = blockIdx.y * a.n_per_share;
  const int n_end = min(a.n_blocks, n_begin + a.n_per_share);
  for (int n0 = n_begin; n0 < n_end; n0 += a.n_batch) {
    const int nb = min(a.n_batch, n_end - n0);
    stage_batch<kQuad, kInterp>(a, n0, nb, s_par, s_tap);
    __syncthreads();

    for (int i = 0; i < nb; ++i) {
      const float4* par4 = reinterpret_cast<const float4*>(s_par) + 2 * i * C;
      const float* taps = s_tap + (size_t)i * C * tapf;
      float acc[kT];
#pragma unroll
      for (int k = 0; k < kT; ++k) acc[k] = 0.0f;
      if (active) {
        for (int c = 0; c < C; ++c) {
          const float4 pa = par4[2 * c], pb = par4[2 * c + 1];
          const float* tc = taps + c * tapf;
          const float rng = point_range<kQuad>(pa, x, y, z, d2);
#pragma unroll
          for (int k = 0; k < kT; ++k)
            acc[k] += window_value<kInterp, kLP, (kT > kClockStep)>(
                tc, W, a.l_power, pb.x + pb.y * (rng + t[k]));
        }
      }

      if (sums_blocks(kMode)) {              // one f32 add per block, ascending n
#pragma unroll
        for (int k = 0; k < kT; ++k) total[k] += acc[k];
        continue;
      }
      park_piece<kT>(acc, gs, t0, t1, i, s_red);
    }

    __syncthreads();                         // every warp's pairs are parked
    if (!sums_blocks(kMode) && threadIdx.x < 32)
      publish_slots<kMode>(a, n0, nb, s_red, nullptr);   // lane i owns block n0 + i
  }

  if (sums_blocks(kMode)) {
    park_piece<kT>(total, gs, t0, t1, 0, s_red);
    __syncthreads();
    if (threadIdx.x < 32) publish_slots<kMode>(a, 0, 1, s_red, nullptr);
  }
}

// Launch geometry of one call, computed on the host.
struct Plan {
  int step;          // kT of the factored kernel, 0 for the per-point kernel
  int points;        // kP, or kT (factored argmax modes)
  int tiles;         // gridDim.x
  int shares;        // gridDim.y
  int n_per_share;
  int n_batch;
  size_t smem;
};

size_t batch_bytes(int n_batch, int n_chan, int width, int interp, bool weighted) {
  const size_t tapf = interp == kQuadratic ? 4 * (size_t)width : width;
  return (size_t)n_batch * (kWarps * 8 * (weighted ? 6 : 1) +
                            (size_t)n_chan * (tapf + kParF) * sizeof(float));
}

// The clock values a thread of the factored kernel takes on this grid (0:
// the per-point kernel): kT = 5, and 25 where its run allows and the tiles
// alone still fill the card (`fill` thread blocks).
int factored_step(bool factored, int run, int n_grid, long fill) {
  if (!factored) return 0;
  if (run % kWideStep == 0 &&
      ((long)n_grid + (long)kThreads * kWideStep - 1) / ((long)kThreads * kWideStep) >= fill)
    return kWideStep;
  return kClockStep;
}

Plan make_plan(int n_blocks, int n_chan, int width, int n_grid, int interp,
               int mode, bool aligned, int step, int sm_count) {
  Plan p;
  const bool sum = sums_blocks(mode), weighted = is_weighted(mode);
  const long fill = 16L * sm_count;     // thread blocks for ~4 waves at 4 per SM
  // four points a thread wherever their 16-byte loads are aligned; the
  // factored kernel (step > 0) takes kT a thread
  p.step = step;
  p.points = step ? step : aligned ? 4 : 1;
  p.tiles = (int)(((long)n_grid + (long)p.points * kThreads - 1) / ((long)p.points * kThreads));
  long shares = sum ? 1 : (fill + p.tiles - 1) / p.tiles;
  if (shares > n_blocks) shares = n_blocks;
  if (shares < 1) shares = 1;
  p.n_per_share = (int)((n_blocks + shares - 1) / shares);
  p.shares = (n_blocks + p.n_per_share - 1) / p.n_per_share;
  const size_t one = batch_bytes(1, n_chan, width, interp, weighted);
  long cap = (long)(kBatchBytes / one);
  if (cap > kMaxBatch) cap = kMaxBatch;
  if (cap < 1) cap = 1;
  const long rounds = (p.n_per_share + cap - 1) / cap;      // batches per share, evened out
  p.n_batch = (int)((p.n_per_share + rounds - 1) / rounds);
  p.smem = batch_bytes(p.n_batch, n_chan, width, interp, weighted);
  return p;
}

// `allowed`: the dynamic shared memory granted the kernel so far.
template <typename Kernel>
cudaError_t launch_with(Kernel kernel, size_t& allowed, const Args& a, const Plan& p,
                        cudaStream_t s) {
  if (p.smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return e;
    allowed = p.smem;
  }
  kernel<<<dim3(p.tiles, p.shares), kThreads, p.smem, s>>>(a);
  return cudaGetLastError();
}

template <bool kQuad, int kInterp, int kP, int kLP, int kMode>
cudaError_t launch_one(const Args& a, const Plan& p, cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  return launch_with(score_kernel<kQuad, kInterp, kP, kLP, kMode>, allowed, a, p, s);
}

template <bool kQuad, int kInterp, int kT, int kLP, int kMode>
cudaError_t launch_factored_one(const Args& a, const Plan& p, cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  return launch_with(score_kernel_factored<kQuad, kInterp, kT, kLP, kMode>, allowed, a, p,
                     s);
}

// The factored kernel's modes: argmax per block and block-summed.
template <bool kQuad, int kInterp, int kLP>
cudaError_t launch_factored_mode(int mode, const Args& a, const Plan& p, cudaStream_t s) {
  constexpr int k5 = kClockStep, k25 = kWideStep;
  if (mode == kArgmax)
    return p.step == k25 ? launch_factored_one<kQuad, kInterp, k25, kLP, kArgmax>(a, p, s)
                         : launch_factored_one<kQuad, kInterp, k5, kLP, kArgmax>(a, p, s);
  return p.step == k25 ? launch_factored_one<kQuad, kInterp, k25, kLP, kSumArgmax>(a, p, s)
                       : launch_factored_one<kQuad, kInterp, k5, kLP, kSumArgmax>(a, p, s);
}

template <bool kQuad>
cudaError_t launch_factored(int interp, int mode, const Args& a, const Plan& p,
                            cudaStream_t s) {
  if (interp == kLinear) {
    if (a.l_power == 1) return launch_factored_mode<kQuad, kLinear, 1>(mode, a, p, s);
    if (a.l_power == 2) return launch_factored_mode<kQuad, kLinear, 2>(mode, a, p, s);
    return launch_factored_mode<kQuad, kLinear, 0>(mode, a, p, s);
  }
  if (a.l_power == 1) return launch_factored_mode<kQuad, kQuadratic, 1>(mode, a, p, s);
  if (a.l_power == 2) return launch_factored_mode<kQuad, kQuadratic, 2>(mode, a, p, s);
  return launch_factored_mode<kQuad, kQuadratic, 0>(mode, a, p, s);
}

template <bool kQuad, int kInterp, int kP, int kLP>
cudaError_t launch_mode(int mode, const Args& a, const Plan& p, cudaStream_t s) {
  switch (mode) {
    case kArgmax: return launch_one<kQuad, kInterp, kP, kLP, kArgmax>(a, p, s);
    case kWeighted: return launch_one<kQuad, kInterp, kP, kLP, kWeighted>(a, p, s);
    case kSurface: return launch_one<kQuad, kInterp, kP, kLP, kSurface>(a, p, s);
    case kSumArgmax: return launch_one<kQuad, kInterp, kP, kLP, kSumArgmax>(a, p, s);
    default: return launch_one<kQuad, kInterp, kP, kLP, kSumWeighted>(a, p, s);
  }
}

template <bool kQuad, int kInterp, int kLP>
cudaError_t launch_points(int mode, const Args& a, const Plan& p, cudaStream_t s) {
  if (p.points == 4) return launch_mode<kQuad, kInterp, 4, kLP>(mode, a, p, s);
  return launch_mode<kQuad, kInterp, 1, kLP>(mode, a, p, s);
}

// l_power 1 and 2 are compiled in for the 3-tap and hat interpolations;
// sinc, whose W taps a point-channel dwarf the power, reads it at run time.
template <bool kQuad>
cudaError_t launch_interp(int interp, int mode, const Args& a, const Plan& p, cudaStream_t s) {
  if (interp == kSinc) return launch_points<kQuad, kSinc, 0>(mode, a, p, s);
  if (interp == kLinear) {
    if (a.l_power == 1) return launch_points<kQuad, kLinear, 1>(mode, a, p, s);
    if (a.l_power == 2) return launch_points<kQuad, kLinear, 2>(mode, a, p, s);
    return launch_points<kQuad, kLinear, 0>(mode, a, p, s);
  }
  if (a.l_power == 1) return launch_points<kQuad, kQuadratic, 1>(mode, a, p, s);
  if (a.l_power == 2) return launch_points<kQuad, kQuadratic, 2>(mode, a, p, s);
  return launch_points<kQuad, kQuadratic, 0>(mode, a, p, s);
}

}  // namespace

extern "C" {

// The most shared memory one block n may need (windows as staged, with the
// parameters and the reduction's slots): the caller's limit check.
int score_max_shared() { return kMaxDynShared; }

// Bytes of shared memory one block n needs at this shape (interp: 0
// quadratic, 1 linear, 2 sinc).
long long score_shared_bytes(int n_chan, int width, int interp, int weighted) {
  return (long long)batch_bytes(1, n_chan, width, interp, weighted != 0);
}

// Tiles (thread blocks along the grid) of a launch at this shape: the
// caller sizes the weighted partials [slots, tiles, 5] with it.
int score_tiles(int n_blocks, int n_chan, int width, int n_grid, int interp,
                int mode, int aligned, int sm_count) {
  return make_plan(n_blocks, n_chan, width, n_grid, interp, mode, aligned != 0,
                   0, sm_count).tiles;
}

// Enqueues one kernel on `stream`; allocates nothing and does not
// synchronize. mode: 0 argmax (best, arg), 1 weighted (+ wsum4, wtot; needs
// part_w), 2 surface (+ surface [N, G]), 3 and 4 as 0 and 1 of the scores
// summed over the N blocks (one output slot). interp: 0 quadratic, 1 linear,
// 2 sinc. r0 == NULL selects the velocity manifold (no curvature term).
// los/centers/coefs/r0 are read by element strides (los n, c, j; centers n, c; coefs n, c; r0 n, c); win, off3 and
// off1 are contiguous. packed and ticket (one entry per output slot) are
// scratch that must be zero at the first launch and is left zero by every
// launch that runs to its end; launches sharing it must be ordered on one
// stream. o3u [G / run, 3] and o1u [run], contiguous, or NULL: the factors
// of a product grid (off3[g] = o3u[g / run], off1[g] = o1u[g % run]), which
// select the factored kernel in modes 0 and 3 with the quadratic or linear
// interpolation where kClockStep (5) divides run; elsewhere they are
// refused. Returns cudaGetLastError() after the launch (0 on success).
int score_launch(const float* win, const float* los, const float* centers,
                 const float* coefs, const float* r0, const float* off3,
                 const float* off1, const float* o3u, const float* o1u, int run,
                 int los_sn, int los_sc, int los_sj,
                 int cen_sn, int cen_sc, int coef_sn, int coef_sc, int r0_sn,
                 int r0_sc, int n_blocks, int n_chan, int width, int n_grid,
                 int interp, int l_power, int mode, int sm_count,
                 float* surface, unsigned long long* packed,
                 unsigned int* ticket, double* part_w, float* best, int* arg,
                 float* wsum4, float* wtot, void* stream) {
  if (n_blocks <= 0 || n_blocks > 65535 || n_chan <= 0 || n_grid <= 0 ||
      l_power < 1 || interp < 0 || interp > kSinc ||
      width < (interp == kQuadratic ? 3 : 1) || mode < 0 || mode > kSumWeighted ||
      sm_count <= 0)
    return (int)cudaErrorInvalidValue;
  if (batch_bytes(1, n_chan, width, interp, is_weighted(mode)) > (size_t)kMaxDynShared)
    return (int)cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<uintptr_t>(off3) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(off1) & 15) == 0;
  const bool factored = o3u != nullptr;
  if (factored && (o1u == nullptr || interp == kSinc ||
                   (mode != kArgmax && mode != kSumArgmax) || run < kClockStep ||
                   run % kClockStep != 0 || n_grid % run != 0))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(n_blocks, n_chan, width, n_grid, interp, mode, aligned,
                           factored_step(factored, run, n_grid, 16L * sm_count),
                           sm_count);
  Args a;
  a.win = win; a.los = los; a.centers = centers; a.coefs = coefs; a.r0 = r0;
  a.off3 = off3; a.off1 = off1; a.o3u = o3u; a.o1u = o1u; a.run = run;
  a.los_sn = los_sn; a.los_sc = los_sc; a.los_sj = los_sj;
  a.cen_sn = cen_sn; a.cen_sc = cen_sc;
  a.coef_sn = coef_sn; a.coef_sc = coef_sc;
  a.r0_sn = r0_sn; a.r0_sc = r0_sc;
  a.n_blocks = n_blocks; a.n_chan = n_chan; a.width = width; a.n_grid = n_grid;
  a.l_power = l_power; a.n_per_share = p.n_per_share; a.n_batch = p.n_batch;
  a.surface = surface; a.packed = packed; a.ticket = ticket; a.part_w = part_w;
  a.best = best; a.arg = arg; a.wsum4 = wsum4; a.wtot = wtot;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      factored ? (r0 != nullptr ? launch_factored<true>(interp, mode, a, p, s)
                                : launch_factored<false>(interp, mode, a, p, s))
               : (r0 != nullptr ? launch_interp<true>(interp, mode, a, p, s)
                                : launch_interp<false>(interp, mode, a, p, s));
  return (int)e;
}

const char* score_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
