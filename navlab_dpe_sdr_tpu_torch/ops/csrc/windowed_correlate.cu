// The windowed correlator of the real DPE engine for Hopper (sm_90a): K5.
//
// K5 replaces what the JAX package leaves to XLA on the TPU,
// navlab_dpe_sdr_tpu/ops/dpe_real.py windowed_correlate (matmuls there; in
// the port's plain PyTorch version, ops/correlate.py
// windowed_correlate_plain, batched cuBLAS products and ~230 small
// launches). For block n and channel c of raw I/Q samples s = p P0 + tau
// (P periods of P0 samples):
//
//   replica   r(tau)   = chips[c, chip(tau, rc_mid)]             (gathered)
//   carrier   ang(s)   = A(p) + B(tau), A = 2 pi fi t_p, B = 2 pi (fi t_tau + ri)
//   folds     F(tau)   = e^{-iB} sum_p e^{-iA_p} raw(p, tau)     (whole)
//             T(tau)   = the same over the nav-bit tail, p > p_b, plus the
//                        boundary period's samples tau >= r_off
//   lags      nf[w]    = sum_tau r(tau - m_w) F(tau),  t[w] the same of T,
//                        m_w = pos_start - S/2 + w
//   arc       corr_t[w] = t[w] + the +/-64-sample boundary-arc correction
//   flip      use_flip = |c0 - 2 c0t|^2 > |c0|^2 at lag 0 (c0 = sum r F)
//   code      win[w]   = use_flip ? nf - 2 corr_t : nf
//   carrier   X[w]     = sum_s (raw(s) - mean) r_flip(s) e^{-i(2 pi k_w s / F_total
//                        + 2 pi (fi t_s + ri))}, through the 256-way mixed
//                        split of the plain version: z = A @ yb over the
//                        s1 = s / 256 rows, then the s0 = s % 256 twiddles.
// Out: magnitudes (or re/im) code [N, C, code_win], carr [N, C, carr_win],
// flip [N, C] (uint8).
//
// Two kernels, enqueued by one call of windowed_correlate_launch:
// - windowed_code_kernel, one thread block per (c, n): the replica and A
//   in shared memory, the folds too where they fit (a thread owns every
//   256th tau and walks the P periods of its samples), the flip decision,
//   the lags (a thread its taus again, eight lags at a time), the arc, the
//   code windows, the flip, and the block's mean (integer sums of int16
//   samples: exact). A thread reads back only the fold values it wrote, so
//   above ~10 000 samples a period (a 10 MHz front end) the folds go to a
//   scratch in device memory (fold_scratch) at no change of order or
//   result: shared memory then holds the replica alone, and the carrier
//   kernel's twiddle table sets the limit, ~20 000 samples a period at 20
//   periods a block (windowed_shared_bytes).
// - windowed_carrier_kernel, one thread block per (c, n, chunk of 12
//   carrier bins): A's twiddles in shared memory, thread t = s0 walks the
//   s1 rows of its column forming the wiped, mean-removed sample and
//   adding it into its 12 bins, then the s0 twiddles and one block sum.
// Blocks of one n are adjacent in launch order, so the C channels' reads
// of the same 200 KB of samples meet in L2.
//
// Batch invariance (the point of K5 beside its speed). Every sum of a
// (n, c) window runs inside one thread block in an order fixed by the
// thread count alone: per thread in sample order, a warp-shuffle tree,
// then the warps in turn. Nothing depends on N, on which blocks or
// channels share the launch, or on their positions in it: a block
// correlated alone, in a share of a batch or in the whole batch, over any
// channel subset, gets the same bits. The carrier chunks split bins, never
// a bin's sum.
//
// What bounds it on the card: f32 operations. At the main path's shapes
// (N = 50, C = 8, S = 50 000, P0 = 2500, windows 12 / 36) the carrier DFT
// is ~8 carr_win S operations a (n, c), 5.8 GFLOP a dispatch, beside 0.3
// for the folds and 0.1 for the lags; the 10 MB int16 slice is read from
// device memory once and from L2 by the other channels and chunks.
//
// Arithmetic. The angles, the replica index and the sample wipe are
// formed op for op as the plain version forms them (the repo builds with
// -fmad=false, so none is contracted), and cosf/sinf/sincosf are the
// library's accurate functions, as torch.cos/torch.sin are on the card:
// the twiddles equal the plain version's. dt = (t[S-1] - t[0]) * f32(1 /
// (S - 1)), as PyTorch divides a CUDA tensor by a Python scalar. The long
// sums (folds, lags, DFT) use explicit fused multiply-adds (__fmaf_rn):
// K5 is held to plain by a tolerance (windows within 1e-5 of each
// channel's window maximum, flips and code argmaxes equal), not by bits,
// and the fused form is one instruction where the split one is two.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The arguments, by value in the kernels; outside the anonymous namespace,
// since the C entry point takes a CorrArgs*.
struct FParam {          // f32 [N, C] by element strides
  const float* p;
  long long sn, sc;
};

struct CorrArgs {
  const void* raw_re;    // int16 I/Q pairs (raw_im == raw_re + 1 element) or f32
  const void* raw_im;
  long long raw_sn, raw_ss;   // element strides of block n and of sample s
  int raw_i16;           // 1: int16 pairs, 0: f32
  int n_blocks, n_chan, n_samples, period, n_periods, code_win, carr_win;
  int complex_out;
  long long carr_fftpts;
  const float* chips;    // [C, 1023], row stride chips_sc
  long long chips_sc;
  const float* time_idc; // [S]
  FParam rc, fi, ri;
  FParam idx_next, pos_start, vel_start;   // integers held exactly in f32
  float* code0;          // [N, C, code_win]: magnitude, or re
  float* code1;          //                   im (complex_out)
  float* carr0;          // [N, C, carr_win]
  float* carr1;
  unsigned char* flip;   // [N, C]
  float* mean;           // [N, C, 2] scratch: the block's mean I, Q
  float* fold;           // [N, C, 4, P0] scratch when the folds leave shared memory
};

namespace {

constexpr int kThreads = 256;            // = the mixed split's s0 (256)
constexpr int kWarps = kThreads / 32;
constexpr int kLagChunk = 8;             // code lags a pass of the lag loop
constexpr int kBinChunk = 12;            // carrier bins a thread block
constexpr int kSliver = 128;             // the boundary arc's samples
constexpr int kMaxPeriods = 64;
constexpr int kMaxWin = 256;
constexpr int kMaxShared = 227 * 1024;
constexpr float kTwoPi = 6.28318548202514648438f;   // f32(2 pi)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLca = 1023;

__device__ __forceinline__ float ld(const FParam& f, int n, int c) {
  return f.p[n * f.sn + c * f.sc];
}

// An integer parameter (the packed rows carry integers below 2^24 as f32).
__device__ __forceinline__ long long ldi(const FParam& f, int n, int c) {
  return (long long)ld(f, n, c);
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ long long pmod(long long a, long long b) {
  const long long r = a % b;
  return r < 0 ? r + b : r;
}

// One I/Q sample of block n (base = n * raw_sn).
template <bool kI16>
__device__ __forceinline__ void load_iq(const CorrArgs& a, long long base, long long s,
                                        float& re, float& im) {
  if (kI16) {
    const short2 v = *reinterpret_cast<const short2*>(
        reinterpret_cast<const short*>(a.raw_re) + base + 2 * s);
    re = (float)v.x;
    im = (float)v.y;
  } else {
    const long long off = base + s * a.raw_ss;
    re = reinterpret_cast<const float*>(a.raw_re)[off];
    im = reinterpret_cast<const float*>(a.raw_im)[off];
  }
}

// The period replica r(tau) of channel c at code phase rc: the chip index
// floor_base + floor(rc) + carry, carry = [frac_base + frac(rc) >= 1], with
// base0 = f32(tau * 1023 / P0) formed in float64 (ops/correlate.py
// _chip_index_consts and period_replicas).
__device__ __forceinline__ float replica(const CorrArgs& a, int c, float rc, int tau) {
  const float base0 = (float)(((double)tau * (double)kLca) / (double)a.period);
  const float fb = floorf(base0);
  const float frac_base = base0 - fb;
  const float fl = floorf(rc);
  const float frac_rc = rc - fl;
  const long long carry = (frac_base + frac_rc) >= 1.0f ? 1 : 0;
  const long long chip = pmod((long long)fb + (long long)fl + carry, kLca);
  return a.chips[c * a.chips_sc + chip];
}

__device__ __forceinline__ float sample_dt(const CorrArgs& a) {
  const float inv = 1.0f / (float)(a.n_samples - 1);
  return (a.time_idc[a.n_samples - 1] - a.time_idc[0]) * inv;
}

// Sums of K values over the thread block in a fixed order: a warp's
// shuffle tree into lane 0, then the warps in turn. out[k] (shared
// memory) holds sum k after the call; s_red holds kWarps * K floats.
template <int K>
__device__ __forceinline__ void block_sums(float (&v)[K], float* s_red, float* out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(kFull, v[k], off);
    if (lane == 0) s_red[warp * K + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = s_red[threadIdx.x];
    for (int wv = 1; wv < kWarps; ++wv) s += s_red[wv * K + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ long long block_isum(long long v, long long* s_red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  long long s = 0;
  for (int wv = 0; wv < kWarps; ++wv) s += s_red[wv];
  __syncthreads();
  return s;
}

// The code kernel's fixed shared memory, in floats (an even count, so the
// period-sized arrays after it leave s_red 8-byte aligned at any period).
constexpr int kCodeFixed = kWarps * 4 * kLagChunk + 4 * kMaxWin + 8 + 4 * kLagChunk +
                           2 * kMaxPeriods + 2 * kSliver;
static_assert(kCodeFixed % 2 == 0, "s_red must stay 8-byte aligned");

// Shared memory of the code kernel, in floats: the replica, and the folds
// when they are kept there.
__host__ __device__ constexpr long long code_smem_floats(int period, bool shared_folds) {
  return kCodeFixed + (shared_folds ? 5LL : 1LL) * period;
}

template <bool kI16, bool kSharedFolds>
__global__ void __launch_bounds__(kThreads) windowed_code_kernel(const CorrArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int P0 = a.period, P = a.n_periods, S = a.n_samples, W = a.code_win;
  const int c = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const size_t nc = (size_t)n * a.n_chan + c;
  float* s_red = sm;                         // [kWarps][4 kLagChunk] (long long: block_isum)
  float* s_win = s_red + kWarps * 4 * kLagChunk;   // [4][W]: nf re, im, t re, im
  float* s_c0 = s_win + 4 * kMaxWin;         // [8] lag-0 sums, means; [4 kLagChunk] lags
  float* s_ca = s_c0 + 8 + 4 * kLagChunk;    // [P]
  float* s_sa = s_ca + kMaxPeriods;          // [P]
  float* s_sl = s_sa + kMaxPeriods;          // [2][kSliver]: wiped arc re, im
  float* s_repl = s_sl + 2 * kSliver;        // [P0]
  // [4][P0]: F re, F im, T re, T im
  float* s_fold = kSharedFolds ? s_repl + P0 : a.fold + nc * 4 * P0;

  const float rc = ld(a.rc, n, c), fi = ld(a.fi, n, c), ri = ld(a.ri, n, c);
  const long long idx_next = ldi(a.idx_next, n, c);
  const long long pos_start = ldi(a.pos_start, n, c);
  const float t0 = a.time_idc[0];
  const long long base = (long long)n * a.raw_sn;

  for (int tau = tid; tau < P0; tau += kThreads) s_repl[tau] = replica(a, c, rc, tau);
  for (int p = tid; p < P; p += kThreads) {
    const float t_p = a.time_idc[(long long)p * P0] - t0;
    const float ang = (kTwoPi * fi) * t_p;
    s_ca[p] = cosf(ang);
    s_sa[p] = sinf(ang);
  }
  __syncthreads();

  const long long p_b = floor_div(idx_next, P0);
  const long long r_off = idx_next - p_b * P0;
  const bool valid = p_b >= 0 && p_b < P;
  const int p_bc = (int)(p_b < 0 ? 0 : (p_b > P - 1 ? P - 1 : p_b));
  const float ca_b = s_ca[p_bc], sa_b = s_sa[p_bc];

  // folds, the boundary period, the rotation by e^{-iB}; lag-0 partials
  float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  long long isum_re = 0, isum_im = 0;      // int16 samples: exact sums
  float fsum_re = 0.0f, fsum_im = 0.0f;
  for (int tau = tid; tau < P0; tau += kThreads) {
    float rr_c = 0.0f, rr_s = 0.0f, qq_c = 0.0f, qq_s = 0.0f;
    float tr_c = 0.0f, tr_s = 0.0f, tq_c = 0.0f, tq_s = 0.0f;
    for (int p = 0; p < P; ++p) {
      float re, im;
      load_iq<kI16>(a, base, (long long)p * P0 + tau, re, im);
      if (kI16) {
        isum_re += (long long)re;
        isum_im += (long long)im;
      } else {
        fsum_re += re;
        fsum_im += im;
      }
      const float ca = s_ca[p], sa = s_sa[p];
      rr_c = __fmaf_rn(ca, re, rr_c);
      rr_s = __fmaf_rn(sa, re, rr_s);
      qq_c = __fmaf_rn(ca, im, qq_c);
      qq_s = __fmaf_rn(sa, im, qq_s);
      if (p > p_b) {
        tr_c = __fmaf_rn(ca, re, tr_c);
        tr_s = __fmaf_rn(sa, re, tr_s);
        tq_c = __fmaf_rn(ca, im, tq_c);
        tq_s = __fmaf_rn(sa, im, tq_s);
      }
    }
    const float rs_re = rr_c + qq_s, rs_im = qq_c - rr_s;
    float ts_re = tr_c + tq_s, ts_im = tq_c - tr_s;
    if (valid && tau >= r_off) {
      float re, im;
      load_iq<kI16>(a, base, (long long)p_bc * P0 + tau, re, im);
      ts_re = ts_re + (ca_b * re + sa_b * im);
      ts_im = ts_im + (ca_b * im - sa_b * re);
    }
    const float ang_b = kTwoPi * (fi * a.time_idc[tau] + ri);
    float sb, cb;
    sincosf(ang_b, &sb, &cb);
    const float f_re = rs_re * cb + rs_im * sb, f_im = rs_im * cb - rs_re * sb;
    const float g_re = ts_re * cb + ts_im * sb, g_im = ts_im * cb - ts_re * sb;
    s_fold[tau] = f_re;
    s_fold[P0 + tau] = f_im;
    s_fold[2 * P0 + tau] = g_re;
    s_fold[3 * P0 + tau] = g_im;
    const float r = s_repl[tau];
    c0[0] = __fmaf_rn(r, f_re, c0[0]);
    c0[1] = __fmaf_rn(r, f_im, c0[1]);
    c0[2] = __fmaf_rn(r, g_re, c0[2]);
    c0[3] = __fmaf_rn(r, g_im, c0[3]);
  }
  // the block's mean (every channel's block computes the same bits)
  float mean_re, mean_im;
  const float inv_s = 1.0f / (float)S;
  if (kI16) {
    long long* s_ired = reinterpret_cast<long long*>(s_red);
    mean_re = (float)block_isum(isum_re, s_ired) * inv_s;
    mean_im = (float)block_isum(isum_im, s_ired) * inv_s;
  } else {
    float m[2] = {fsum_re, fsum_im};
    block_sums<2>(m, s_red, s_c0);
    mean_re = s_c0[0] * inv_s;
    mean_im = s_c0[1] * inv_s;
  }
  block_sums<4>(c0, s_red, s_c0);            // (also orders the fold stores)
  const float c0nf_re = s_c0[0], c0nf_im = s_c0[1];
  const float c0fl_re = c0nf_re - 2.0f * s_c0[2], c0fl_im = c0nf_im - 2.0f * s_c0[3];
  const bool use_flip =
      (c0fl_re * c0fl_re + c0fl_im * c0fl_im) > (c0nf_re * c0nf_re + c0nf_im * c0nf_im);
  if (tid == 0) {
    a.flip[nc] = use_flip ? 1 : 0;
    a.mean[2 * nc] = mean_re;
    a.mean[2 * nc + 1] = mean_im;
  }

  // lags m_w = m0 + w: sum_tau r(tau - m_w) F(tau) and T(tau)
  const long long m0 = pos_start - S / 2;
  for (int w0 = 0; w0 < W; w0 += kLagChunk) {
    float acc[4 * kLagChunk];
#pragma unroll
    for (int k = 0; k < 4 * kLagChunk; ++k) acc[k] = 0.0f;
    for (int j = tid; j < P0; j += kThreads) {
      const float f_re = s_fold[j], f_im = s_fold[P0 + j];
      const float g_re = s_fold[2 * P0 + j], g_im = s_fold[3 * P0 + j];
      int b = (int)pmod((long long)j - m0 - w0, P0);
#pragma unroll
      for (int u = 0; u < kLagChunk; ++u) {
        const float r = s_repl[b];
        acc[4 * u] = __fmaf_rn(r, f_re, acc[4 * u]);
        acc[4 * u + 1] = __fmaf_rn(r, f_im, acc[4 * u + 1]);
        acc[4 * u + 2] = __fmaf_rn(r, g_re, acc[4 * u + 2]);
        acc[4 * u + 3] = __fmaf_rn(r, g_im, acc[4 * u + 3]);
        b = b == 0 ? P0 - 1 : b - 1;
      }
    }
    float* out = s_c0 + 8;           // scratch past the means
    block_sums<4 * kLagChunk>(acc, s_red, out);
    if (tid < 4 * kLagChunk) {
      const int u = tid / 4, q = tid % 4;
      if (w0 + u < W) s_win[q * kMaxWin + w0 + u] = out[tid];
    }
    __syncthreads();
  }

  // the boundary arc: +/- kSliver/2 samples about idx_next, wiped exactly
  long long sl_start = idx_next - kSliver / 2;
  if (sl_start > S - kSliver) sl_start = S - kSliver;
  if (sl_start < 0) sl_start = 0;
  const float dt_s = sample_dt(a);
  if (tid < kSliver) {
    const long long pos = sl_start + tid;
    float re, im;
    load_iq<kI16>(a, base, pos, re, im);
    const float t_sl = t0 + (float)pos * dt_s;
    const float ang = kTwoPi * (fi * t_sl + ri);
    const float wc = cosf(ang), ws = sinf(ang);
    s_sl[tid] = re * wc + im * ws;
    s_sl[kSliver + tid] = im * wc - re * ws;
  }
  __syncthreads();
  for (int w = warp; w < W; w += kWarps) {
    const long long m_w = m0 + w;
    float sr = 0.0f, si = 0.0f;
#pragma unroll
    for (int i = 0; i < kSliver / 32; ++i) {
      const int k = lane + 32 * i;
      const long long pos = sl_start + k;
      const float delta = (float)(pos >= idx_next + m_w) - (float)(pos >= idx_next);
      const float r = s_repl[pmod(sl_start + k - m_w, P0)];
      sr += delta * s_sl[k] * r;
      si += delta * s_sl[kSliver + k] * r;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sr += __shfl_down_sync(kFull, sr, off);
      si += __shfl_down_sync(kFull, si, off);
    }
    if (lane == 0) {
      const float nf_re = s_win[w], nf_im = s_win[kMaxWin + w];
      const float ct_re = s_win[2 * kMaxWin + w] + sr;
      const float ct_im = s_win[3 * kMaxWin + w] + si;
      float w_re = nf_re, w_im = nf_im;
      if (use_flip) {
        w_re = nf_re - 2.0f * ct_re;
        w_im = nf_im - 2.0f * ct_im;
      }
      const size_t o = nc * W + w;
      if (a.complex_out) {
        a.code0[o] = w_re;
        a.code1[o] = w_im;
      } else {
        a.code0[o] = sqrtf(w_re * w_re + w_im * w_im);
      }
    }
  }
}

__host__ __device__ constexpr long long carrier_smem_floats(int period, int s1_n) {
  return (long long)period + 2LL * kBinChunk * s1_n + kWarps * 2 * kBinChunk + 2 * kBinChunk;
}

template <bool kI16>
__global__ void __launch_bounds__(kThreads) windowed_carrier_kernel(const CorrArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int P0 = a.period, S = a.n_samples, W = a.carr_win;
  const int s1_n = (S + kThreads - 1) / kThreads;
  const int c = blockIdx.x, n = blockIdx.y, w0 = blockIdx.z * kBinChunk;
  const int wn = min(kBinChunk, W - w0);
  const int tid = threadIdx.x;
  float* s_a = sm;                                  // [s1_n][kBinChunk][2]: cos, sin
  float* s_repl = s_a + 2 * kBinChunk * s1_n;       // [P0]
  float* s_red = s_repl + P0;                       // [kWarps][2 kBinChunk]
  float* s_x = s_red + kWarps * 2 * kBinChunk;      // [2 kBinChunk]

  const float rc = ld(a.rc, n, c), fi = ld(a.fi, n, c), ri = ld(a.ri, n, c);
  const long long idx_next = ldi(a.idx_next, n, c);
  const long long vel_start = ldi(a.vel_start, n, c);
  const size_t nc = (size_t)n * a.n_chan + c;
  const bool use_flip = a.flip[nc] != 0;
  const float mean_re = a.mean[2 * nc], mean_im = a.mean[2 * nc + 1];
  const float t0 = a.time_idc[0];
  const float dt_s = sample_dt(a);
  const long long F = a.carr_fftpts;
  const float scale = (float)(2.0 * 3.14159265358979323846 / (double)F);
  const float two_pi_fi = kTwoPi * fi;

  for (int tau = tid; tau < P0; tau += kThreads) s_repl[tau] = replica(a, c, rc, tau);
  // A(w, s1): the s1 rows' twiddles, wipeoff folded in
  for (int i = tid; i < kBinChunk * s1_n; i += kThreads) {
    const int u = i % kBinChunk, s1 = i / kBinChunk;
    float cs = 0.0f, sn = 0.0f;
    if (u < wn) {
      const long long k = pmod(vel_start + w0 + u - F / 2, F);
      const long long k256 = pmod(k * kThreads, F);
      const float ph = (float)pmod(k256 * s1, F);
      const float t_a = ((float)s1 * (float)kThreads) * dt_s;
      const float ang = ph * scale + two_pi_fi * t_a;
      sincosf(ang, &sn, &cs);
    }
    s_a[2 * i] = cs;
    s_a[2 * i + 1] = sn;
  }
  __syncthreads();

  // z(w, s0) = sum_s1 A(w, s1) yb(s1, s0), thread tid = s0
  float z_re[kBinChunk], z_im[kBinChunk];
#pragma unroll
  for (int u = 0; u < kBinChunk; ++u) z_re[u] = z_im[u] = 0.0f;
  const long long base = (long long)n * a.raw_sn;
  int smod = tid % P0;
  const int step = kThreads % P0;
  for (int s1 = 0; s1 < s1_n; ++s1) {
    const long long s = (long long)s1 * kThreads + tid;
    float yr = 0.0f, yi = 0.0f;
    if (s < S) {
      float re, im;
      load_iq<kI16>(a, base, s, re, im);
      float r = s_repl[smod];
      if (use_flip && s >= idx_next) r = -r;
      yr = (re - mean_re) * r;
      yi = (im - mean_im) * r;
    }
    smod += step;
    if (smod >= P0) smod -= P0;
    const float4* ap = reinterpret_cast<const float4*>(s_a + 2 * kBinChunk * s1);
#pragma unroll
    for (int q = 0; q < kBinChunk / 2; ++q) {
      const float4 t = ap[q];            // (cos, sin) of bins 2q, 2q + 1
      z_re[2 * q] = __fmaf_rn(t.x, yr, __fmaf_rn(t.y, yi, z_re[2 * q]));
      z_im[2 * q] = __fmaf_rn(t.x, yi, __fmaf_rn(-t.y, yr, z_im[2 * q]));
      z_re[2 * q + 1] = __fmaf_rn(t.z, yr, __fmaf_rn(t.w, yi, z_re[2 * q + 1]));
      z_im[2 * q + 1] = __fmaf_rn(t.z, yi, __fmaf_rn(-t.w, yr, z_im[2 * q + 1]));
    }
  }

  // the s0 twiddles B(w, s0) and the sum over s0
  float x[2 * kBinChunk];
  const float t_b = t0 + (float)tid * dt_s;
  const float phase_b = kTwoPi * (fi * t_b + ri);
#pragma unroll
  for (int u = 0; u < kBinChunk; ++u) {
    float bs = 0.0f, bc = 0.0f;
    if (u < wn) {
      const long long k = pmod(vel_start + w0 + u - F / 2, F);
      const float ph = (float)pmod(k * tid, F);
      sincosf(ph * scale + phase_b, &bs, &bc);
    }
    x[2 * u] = z_re[u] * bc + z_im[u] * bs;
    x[2 * u + 1] = z_im[u] * bc - z_re[u] * bs;
  }
  block_sums<2 * kBinChunk>(x, s_red, s_x);
  if (tid < wn) {
    const float x_re = s_x[2 * tid], x_im = s_x[2 * tid + 1];
    const size_t o = nc * W + w0 + tid;
    if (a.complex_out) {
      a.carr0[o] = x_re;
      a.carr1[o] = x_im;
    } else {
      a.carr0[o] = sqrtf(x_re * x_re + x_im * x_im);
    }
  }
}

template <typename K>
cudaError_t allow_shared(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

// Whether the code kernel keeps the folds in shared memory at this period.
bool shared_folds(int period) {
  return sizeof(float) * code_smem_floats(period, true) <= (size_t)kMaxShared;
}

template <bool kI16, bool kSharedFolds>
cudaError_t launch_code(const CorrArgs& a, cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  const size_t bytes = sizeof(float) * code_smem_floats(a.period, kSharedFolds);
  const cudaError_t e =
      allow_shared(windowed_code_kernel<kI16, kSharedFolds>, bytes, allowed);
  if (e != cudaSuccess) return e;
  windowed_code_kernel<kI16, kSharedFolds>
      <<<dim3(a.n_chan, a.n_blocks), kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <bool kI16>
cudaError_t launch_both(const CorrArgs& a, cudaStream_t s) {
  static size_t carr_allowed = 48 * 1024;
  const int s1_n = (a.n_samples + kThreads - 1) / kThreads;
  const size_t carr_bytes = sizeof(float) * carrier_smem_floats(a.period, s1_n);
  cudaError_t e = allow_shared(windowed_carrier_kernel<kI16>, carr_bytes, carr_allowed);
  if (e != cudaSuccess) return e;
  e = shared_folds(a.period) ? launch_code<kI16, true>(a, s) : launch_code<kI16, false>(a, s);
  if (e != cudaSuccess) return e;
  const int chunks = (a.carr_win + kBinChunk - 1) / kBinChunk;
  windowed_carrier_kernel<kI16>
      <<<dim3(a.n_chan, a.n_blocks, chunks), kThreads, carr_bytes, s>>>(a);
  return cudaGetLastError();
}

// The larger of the two kernels' shared memory at this shape, in bytes.
long long shared_bytes(int period, int n_samples) {
  const long long a = sizeof(float) * code_smem_floats(period, shared_folds(period));
  const long long b =
      sizeof(float) * carrier_smem_floats(period, (n_samples + kThreads - 1) / kThreads);
  return a > b ? a : b;
}

}  // namespace

extern "C" {

// The mixed split's s0 (the threads of a block): ops/correlate.py checks it.
int windowed_split() { return kThreads; }

// Shared memory a thread block takes at this shape, in bytes, and the most
// it may take (ops/correlate.py refuses a larger shape before the launch).
long long windowed_shared_bytes(int period, int n_samples) {
  return shared_bytes(period, n_samples);
}
long long windowed_shared_limit() { return kMaxShared; }

// Floats of fold scratch (CorrArgs.fold) a (block, channel) needs at this
// period: 0 while the folds fit in shared memory.
long long windowed_fold_scratch(int period) {
  return shared_folds(period) ? 0 : 4LL * period;
}

// Enqueues K5 (the code kernel, then the carrier kernel) on `stream`;
// allocates nothing, does not synchronize. Returns cudaGetLastError()
// after the launches (0 on success), or cudaErrorInvalidValue for a shape
// the kernels do not take: N or C outside 1..65535, more than kMaxPeriods
// periods, S other than period x n_periods or below kSliver, code_win
// outside 1..kMaxWin, carr_win < 1, a shape whose shared memory exceeds
// kMaxShared, or no fold scratch where the period needs one.
int windowed_correlate_launch(const CorrArgs* args, void* stream) {
  const CorrArgs& a = *args;
  if (a.n_blocks <= 0 || a.n_blocks > 65535 || a.n_chan <= 0 || a.n_chan > 65535 ||
      a.period <= 0 || a.n_periods <= 0 || a.n_periods > kMaxPeriods ||
      (long long)a.period * a.n_periods != a.n_samples || a.n_samples < kSliver ||
      a.code_win <= 0 || a.code_win > kMaxWin || a.carr_win <= 0 || a.carr_fftpts <= 0 ||
      shared_bytes(a.period, a.n_samples) > kMaxShared ||
      (!shared_folds(a.period) && a.fold == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(a.raw_i16 ? launch_both<true>(a, s) : launch_both<false>(a, s));
}

const char* windowed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
