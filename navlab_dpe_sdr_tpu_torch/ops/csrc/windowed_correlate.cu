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
//                        s1 = s / 256 rows, then the s0 = s % 256 twiddles B.
// Out: magnitudes (or re/im) code [N, C, code_win], carr [N, C, carr_win],
// flip [N, C] (uint8).
//
// One kernel, one launch a call (windowed_correlate_launch): a cluster of
// kCluster = R thread blocks of 256 threads per (channel, block), grid
// (C R, N) with the cluster along x, so a block's rank is blockIdx.x % R
// whatever N. Rank r of the cluster:
// - code phase: owns the contiguous taus [r P0 / R, (r + 1) P0 / R) and
//   folds them over the P periods itself (a thread a tau, periods in turn),
//   so no fold crosses ranks; from its folds it forms its partial lag sums
//   (the code_win lags and lag 0; a warp a lag, a lane every 32nd tau) and
//   its part of the block mean (an exact integer sum of int16 samples; of
//   float32 samples a float sum in a fixed order). Every rank forms the
//   whole period's replica (the carrier reads all of it) from the plain
//   version's own table of nominal chip indices (CorrArgs.base0).
// - cluster barrier 1; every rank adds the ranks' lag-0 sums and mean parts
//   in rank order through distributed shared memory (the same bits in
//   every rank: each knows the flip and the mean), and the lag sums of its
//   own code windows w = r, r + R, ...; it applies the boundary arc to them
//   and writes them.
// - carrier phase, in the same launch: owns the contiguous rows [r s1_n /
//   R, (r + 1) s1_n / R) of the 256-way split and builds only those rows'
//   A twiddles (in chunks of 256 rows); a pass covers up to 36 bins over
//   the rank's samples (a wider window takes more passes), a thread one s0
//   column and all the pass's bins (36 accumulator pairs), and leaves the
//   partials z(w, s0) in shared memory.
// - cluster barrier 2; rank r takes the pass's bins [r wn / R, (r + 1) wn /
//   R): z(w, s0) = the ranks' partials added in rank order (distributed
//   shared memory), the s0 twiddles B, the sum over s0 (a warp halves its
//   values five times, then the warps in turn), and writes those bins.
//   Each B twiddle is formed once in the cluster, not once in each rank.
// - cluster barrier 3: no block leaves, or overwrites its partials, while
//   another rank may read them.
// Nothing is allocated; the folds, a chunk of the A twiddles and the z
// partials share one region of shared memory (the partials take 72 KB).
// The period limit is the replica and the folds (P0 floats each) beside
// the fixed part: 27 508 samples a period at any number of periods up to
// 64 (front ends to 27.5 MHz); the wrapper refuses a longer period.
//
// R = 4 (kCluster) was chosen on the card among 4, 8 and 16: a larger
// cluster spreads one (n, c) over more SMs, which N = 1 wants, but every
// rank repeats the replica, the A_p twiddles and the barriers, which N =
// 50, where the card is full, pays for (PERF.md, section 6).
//
// Batch invariance (the point of K5 beside its speed). Every sum of a
// (n, c) window runs over the R ranks of its own cluster, in an order
// fixed by R and the thread count alone: per thread in sample order, a
// warp's shuffle pattern, the warps in turn, the ranks in turn. Nothing
// depends on N, gridDim, blockIdx.y, on which blocks or channels share the
// launch or on scheduling: a block correlated alone, in a share of a batch
// or in the whole batch, over any channel subset, gets the same bits.
//
// What bounds it on the card: at N = 50 (C = 8, S = 50 000, P0 = 2500,
// windows 12 / 36) f32 operations, the carrier DFT's ~8 carr_win S a (n, c)
// (5.8 GFLOP a dispatch, beside 0.3 for the folds and 0.1 for the lags);
// the 10 MB int16 slice is read from device memory once and from L2 by the
// other channels. There the clock64() split (CorrArgs.clk) shows a
// thread block's 1.8 M DFT multiply-adds taking ~37 000 SM clocks, ~75 %
// of the SM's f32 issue rate if the SM's two blocks overlap in it, and the
// rest of its time in the latency-bound folds, lag sums and barriers.
// At N = 1 and 8 operations do not fill the card, latency does: one block
// per (n, c) would leave 8 of 132 SMs busy at N = 1, so a cluster spreads
// each (n, c) over R SMs, and one launch runs both phases.
//
// Arithmetic. The angles, the replica index and the sample wipe are
// formed op for op as the plain version forms them (the repo builds with
// -fmad=false, so none is contracted), and cosf/sinf/sincosf are the
// library's accurate functions, as torch.cos/torch.sin are on the card:
// the twiddles equal the plain version's. The DFT length F is a power of
// two, so the integer phases mod F are masks (the same integers as the
// plain version's remainders). dt = (t[S-1] - t[0]) * f32(1 / (S - 1)), as
// PyTorch divides a CUDA tensor by a Python scalar. The long sums (folds,
// lags, DFT) use explicit fused multiply-adds (__fmaf_rn): K5 is held to
// plain by a tolerance (windows within 1e-5 of each channel's window
// maximum, flips and code argmaxes equal), not by bits, and the fused form
// is one instruction where the split one is two.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// The arguments, by value in the kernel; outside the anonymous namespace,
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
  long long carr_fftpts; // a power of two
  const float* chips;    // [C, 1023], row stride chips_sc
  long long chips_sc;
  const float* time_idc; // [S]
  const float* base0;    // [P0] f32(tau * 1023 / P0), formed in float64
  FParam rc, fi, ri;
  FParam idx_next, pos_start, vel_start;   // integers held exactly in f32
  float* code0;          // [N, C, code_win]: magnitude, or re
  float* code1;          //                   im (complex_out)
  float* carr0;          // [N, C, carr_win]
  float* carr1;
  unsigned char* flip;   // [N, C]
  long long* clk;        // [N, C, R, kClocks] clock64() split, or null
};

namespace {

constexpr int kCluster = 4;              // thread blocks per (channel, block)
constexpr int kThreads = 256;            // = the mixed split's s0 (256)
constexpr int kWarps = kThreads / 32;
constexpr int kBinPass = 36;             // carrier bins a pass, at most
constexpr int kRowChunk = kThreads;      // rows of twiddles A in shared memory at once
constexpr int kRankBins = (kBinPass + kCluster - 1) / kCluster;   // a pass's bins a rank
constexpr int kSliver = 128;             // the boundary arc's samples
constexpr int kMaxPeriods = 64;
constexpr int kMaxWin = 256;
constexpr int kMaxShared = 227 * 1024;
constexpr float kTwoPi = 6.28318548202514648438f;   // f32(2 pi)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLca = 1023;
static_assert(kBinPass % 12 == 0, "passes of 12, 24 or 36 bins");
static_assert(kCluster <= 8, "cluster size: portable");

// The clock split (CorrArgs.clk, thread 0 of each block, between block
// barriers): setup (replica, A_p), folds and the mean part, lag sums,
// twiddles A, barrier 1, the ranks' sums, the arc, the DFT, barrier 2, z
// over the ranks with twiddles B, the sum over s0 with the bins out,
// barrier 3; then the whole.
constexpr int kClocks = 13;

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

// The first of rank r's share of n items: rank r owns [split(r), split(r + 1)).
__host__ __device__ __forceinline__ int split(int r, int n) {
  return (int)((long long)r * n / kCluster);
}

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

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
// floor_base + floor(rc) + carry, carry = [frac_base + frac(rc) >= 1], from
// base0 = f32(tau * 1023 / P0) (ops/correlate.py _chip_index_consts and
// period_replicas).
__device__ __forceinline__ float replica(const CorrArgs& a, int c, float rc, int tau) {
  const float base0 = a.base0[tau];
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

// Adds the clocks since the last lap to phase k (thread 0, when timed).
__device__ __forceinline__ void lap(const CorrArgs& a, long long* s_clk, int k) {
  if (a.clk != nullptr && threadIdx.x == 0) {
    const long long now = clock64();
    s_clk[k] += now - s_clk[kClocks];
    s_clk[kClocks] = now;
  }
}

// One level of a warp's halving sum: the lane keeps the upper half of its
// K values where its `mask` bit is set, the lower half where not, and adds
// the partner lane's copy of them (padded with a zero at odd K).
template <int K>
__device__ __forceinline__ void halve(const float (&v)[K], float (&h)[(K + 1) / 2],
                                      int mask, bool upper) {
  constexpr int H = (K + 1) / 2;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float lo = v[j];
    const float hi = j + H < K ? v[j + H] : 0.0f;
    h[j] = (upper ? hi : lo) + __shfl_xor_sync(kFull, upper ? lo : hi, mask);
  }
}

// Sums of K values over the thread block: each warp halves its values five
// times (~K shuffles a lane where the shuffle tree takes 5 K), the warps'
// sums go to s_red [kWarps][K], and thread k < n_out adds value k over the
// warps in turn into out[k]. The order is fixed by the lane and warp
// positions alone.
template <int K>
__device__ __forceinline__ void block_sums_halving(const float (&v)[K], float* s_red,
                                                   float* out, int n_out) {
  constexpr int K1 = (K + 1) / 2, K2 = (K1 + 1) / 2, K3 = (K2 + 1) / 2;
  constexpr int K4 = (K3 + 1) / 2, K5 = (K4 + 1) / 2;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float h1[K1], h2[K2], h3[K3], h4[K4], h5[K5];
  halve<K>(v, h1, 16, lane & 16);
  halve<K1>(h1, h2, 8, lane & 8);
  halve<K2>(h2, h3, 4, lane & 4);
  halve<K3>(h3, h4, 2, lane & 2);
  halve<K4>(h4, h5, 1, lane & 1);
  // slot j of this lane holds the warp sum of value t0; a slot that meets a
  // pad at any level holds none
#pragma unroll
  for (int j = 0; j < K5; ++j) {
    const int t4 = j + ((lane & 1) ? K5 : 0);
    const int t3 = t4 + ((lane & 2) ? K4 : 0);
    const int t2 = t3 + ((lane & 4) ? K3 : 0);
    const int t1 = t2 + ((lane & 8) ? K2 : 0);
    const int t0 = t1 + ((lane & 16) ? K1 : 0);
    if (t4 < K4 && t3 < K3 && t2 < K2 && t1 < K1 && t0 < K) s_red[warp * K + t0] = h5[j];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_out; k += kThreads) {
    float s = s_red[k];
    for (int wv = 1; wv < kWarps; ++wv) s += s_red[wv * K + k];
    out[k] = s;
  }
  __syncthreads();
}

// The fixed shared memory, in floats, in this order: the block's integer
// sums and the clock words (long long, first: 8-byte aligned at any
// period), the rank's mean part [2] (long long or float) and lag partials
// [kMaxWin + 1][4] (read by the other ranks), the reduction scratch, the
// lag-0 sums and mean, the rank's code windows' lag sums [4 kMaxWin], the
// rank's carrier sums [2 kRankBins], the period twiddles A_p, the arc's
// wiped samples. A multiple of 4, so what follows stays 16-byte aligned.
constexpr int kFixed = 2 * kWarps + 2 * 16 + 4 + 4 * (kMaxWin + 1) + kWarps * 2 * kBinPass +
                       8 + 4 * kMaxWin + 4 * ceil_div(2 * kRankBins, 4) + 2 * kMaxPeriods +
                       2 * kSliver;
static_assert(kFixed % 4 == 0, "the float4 twiddle rows stay 16-byte aligned");
static_assert(kClocks + 2 <= 16, "the clock words");

// The runtime part: the replica [P0] (rounded up to 4 floats), and one
// region that holds the rank's folds [4][taus], then a chunk of a pass's
// twiddles A [kRowChunk][kBinPass][2], then the pass's partials z
// [kBinPass][2][kThreads] (the chunk and z take the same room).
static_assert(kRowChunk <= kThreads, "a twiddle chunk fits the z partials' region");
__host__ __device__ inline long long smem_floats(int period) {
  const long long folds = 4LL * (ceil_div(period, kCluster) + 1);
  const long long z = 2LL * kBinPass * kThreads;
  return (long long)kFixed + (period + 3) / 4 * 4 + (folds > z ? folds : z);
}

// A pass's twiddles A(w, s1) for the rank's rows [row_lo, row_lo + rows),
// bins w0 .. w0 + wn - 1 (NB columns a row; columns past wn are zero), the
// wipeoff folded in: s_a[(row NB + u) 2 + {0, 1}] = cos, sin. M = F - 1.
template <int NB>
__device__ __forceinline__ void pass_twiddles(float* s_a, int row_lo, int rows, int w0,
                                              int wn, long long vel_start, long long F,
                                              float scale, float two_pi_fi, float dt_s) {
  const long long M = F - 1;
  for (int i = threadIdx.x; i < rows * NB; i += kThreads) {
    const int u = i % NB, s1 = row_lo + i / NB;
    float cs = 0.0f, sn = 0.0f;
    if (u < wn) {
      const long long k = (vel_start + w0 + u - F / 2) & M;
      const long long k256 = (k * kThreads) & M;
      const float ph = (float)((k256 * s1) & M);
      const float t_a = ((float)s1 * (float)kThreads) * dt_s;
      const float ang = ph * scale + two_pi_fi * t_a;
      sincosf(ang, &sn, &cs);
    }
    s_a[2 * i] = cs;
    s_a[2 * i + 1] = sn;
  }
}

// Pass twiddles at the pass's width: 12, 24 or 36 columns.
__device__ __forceinline__ int pass_width(int wn) { return wn > 24 ? 36 : (wn > 12 ? 24 : 12); }

__device__ __forceinline__ void twiddles_at_width(float* s_a, int row_lo, int rows, int w0,
                                                  int wn, long long vel_start, long long F,
                                                  float scale, float two_pi_fi, float dt_s) {
  switch (pass_width(wn)) {
    case 36:
      pass_twiddles<36>(s_a, row_lo, rows, w0, wn, vel_start, F, scale, two_pi_fi, dt_s);
      break;
    case 24:
      pass_twiddles<24>(s_a, row_lo, rows, w0, wn, vel_start, F, scale, two_pi_fi, dt_s);
      break;
    default:
      pass_twiddles<12>(s_a, row_lo, rows, w0, wn, vel_start, F, scale, two_pi_fi, dt_s);
  }
}

// What a carrier pass reads besides the samples.
struct PassIn {
  const float* s_repl;   // [P0]
  int row_lo, rows, w0, wn;
  long long idx_next, vel_start, F;
  bool use_flip;
  float mean_re, mean_im, scale, two_pi_fi, dt_s;
};

// The DFT of one pass of NB bins over the rank's rows: z(w, s0) = sum_s1
// A(w, s1) yb(s1, s0), left in s_u [w][re, im][s0] for w < wn. Thread tid
// is the column s0 = tid and sums all NB bins of it (NB accumulator
// pairs), its rows in turn; a row's twiddles are one broadcast read of
// NB / 2 float4s. The rows go in chunks of kRowChunk, each chunk's
// twiddles built in s_u before it (the first chunk's by the caller), so
// the table never outgrows the z partials' region. The samples of the
// next two rows wait in registers.
template <bool kI16, int NB>
__device__ __forceinline__ void carrier_dft(const CorrArgs& a, const PassIn& q, long long base,
                                            float* s_u, long long* s_clk) {
  const int tid = threadIdx.x, P0 = a.period, S = a.n_samples;
  float z_re[NB], z_im[NB];
#pragma unroll
  for (int u = 0; u < NB; ++u) z_re[u] = z_im[u] = 0.0f;
  int s = q.row_lo * kThreads + tid;
  int smod = s % P0;
  const int step = kThreads % P0;
  float n1_re = 0.0f, n1_im = 0.0f, n2_re = 0.0f, n2_im = 0.0f;
  if (q.rows > 0 && s < S) load_iq<kI16>(a, base, s, n1_re, n1_im);
  if (q.rows > 1 && s + kThreads < S) load_iq<kI16>(a, base, s + kThreads, n2_re, n2_im);
  for (int r0 = 0; r0 < q.rows; r0 += kRowChunk) {
    const int r1 = min(r0 + kRowChunk, q.rows);
    if (r0 > 0) {                            // the next chunk's twiddles
      __syncthreads();
      pass_twiddles<NB>(s_u, q.row_lo + r0, r1 - r0, q.w0, q.wn, q.vel_start, q.F, q.scale,
                        q.two_pi_fi, q.dt_s);
      __syncthreads();
    }
    const float4* ap = reinterpret_cast<const float4*>(s_u);
    for (int row = r0; row < r1; ++row, s += kThreads, ap += NB / 2) {
      const float re = n1_re, im = n1_im;
      n1_re = n2_re;
      n1_im = n2_im;
      if (row + 2 < q.rows && s + 2 * kThreads < S)
        load_iq<kI16>(a, base, s + 2 * kThreads, n2_re, n2_im);
      float yr = 0.0f, yi = 0.0f;
      if (s < S) {
        float r = q.s_repl[smod];
        if (q.use_flip && s >= q.idx_next) r = -r;
        yr = (re - q.mean_re) * r;
        yi = (im - q.mean_im) * r;
      }
      smod += step;
      if (smod >= P0) smod -= P0;
#pragma unroll
      for (int k = 0; k < NB / 2; ++k) {
        const float4 t = ap[k];              // (cos, sin) of bins 2k, 2k + 1
        z_re[2 * k] = __fmaf_rn(t.x, yr, __fmaf_rn(t.y, yi, z_re[2 * k]));
        z_im[2 * k] = __fmaf_rn(t.x, yi, __fmaf_rn(-t.y, yr, z_im[2 * k]));
        z_re[2 * k + 1] = __fmaf_rn(t.z, yr, __fmaf_rn(t.w, yi, z_re[2 * k + 1]));
        z_im[2 * k + 1] = __fmaf_rn(t.z, yi, __fmaf_rn(-t.w, yr, z_im[2 * k + 1]));
      }
    }
  }
  __syncthreads();                           // the twiddles are read
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    if (u < q.wn) {
      s_u[(2 * u) * kThreads + tid] = z_re[u];
      s_u[(2 * u + 1) * kThreads + tid] = z_im[u];
    }
  }
  lap(a, s_clk, 7);
}

template <bool kI16>
__global__ void __launch_bounds__(kThreads, 2) windowed_correlate_kernel(const CorrArgs a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int P0 = a.period, P = a.n_periods, S = a.n_samples, W = a.code_win;
  const int WC = a.carr_win;
  const int c = blockIdx.x / kCluster, n = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const size_t nc = (size_t)n * a.n_chan + c;
  long long* s_ired = reinterpret_cast<long long*>(sm);   // [kWarps]
  long long* s_clk = s_ired + kWarps;        // [16]: the phases, the last lap, the start
  float* s_mpart = sm + 2 * kWarps + 2 * 16; // [2] the rank's mean part (long long or f32)
  float* s_lag = s_mpart + 4;                // [W + 1][4] the rank's lag partials (lag W: lag 0)
  float* s_red = s_lag + 4 * (kMaxWin + 1);  // [kWarps][2 kBinPass]
  float* s_c0 = s_red + kWarps * 2 * kBinPass;   // [8] lag-0 sums, mean
  float* s_win = s_c0 + 8;                   // [4 kMaxWin] the rank's windows' lag sums
  float* s_x = s_win + 4 * kMaxWin;          // [2 kRankBins] the rank's carrier bins
  float* s_ca = s_x + 4 * ceil_div(2 * kRankBins, 4);   // [P]
  float* s_sa = s_ca + kMaxPeriods;          // [P]
  float* s_sl = s_sa + kMaxPeriods;          // [2][kSliver]: wiped arc re, im
  float* s_repl = s_sl + 2 * kSliver;        // [P0]
  float* s_u = s_repl + (P0 + 3) / 4 * 4;    // folds, then twiddles A, then z

  const float rc = ld(a.rc, n, c), fi = ld(a.fi, n, c), ri = ld(a.ri, n, c);
  const long long idx_next = ldi(a.idx_next, n, c);
  const long long pos_start = ldi(a.pos_start, n, c);
  const long long vel_start = ldi(a.vel_start, n, c);
  const float t0 = a.time_idc[0];
  const float dt_s = sample_dt(a);
  const long long base = (long long)n * a.raw_sn;
  const bool timed = a.clk != nullptr;
  if (timed && tid == 0) {
    for (int k = 0; k < kClocks; ++k) s_clk[k] = 0;
    s_clk[kClocks] = s_clk[kClocks + 1] = clock64();
  }

#pragma unroll 4
  for (int tau = tid; tau < P0; tau += kThreads) s_repl[tau] = replica(a, c, rc, tau);
  for (int p = tid; p < P; p += kThreads) {
    const float t_p = a.time_idc[(long long)p * P0] - t0;
    const float ang = (kTwoPi * fi) * t_p;
    s_ca[p] = cosf(ang);
    s_sa[p] = sinf(ang);
  }
  __syncthreads();
  lap(a, s_clk, 0);

  // ---- code phase: the rank's taus, folded over the periods --------------
  const int t_lo = split(rank, P0), t_n = split(rank + 1, P0) - t_lo;
  const long long p_b = floor_div(idx_next, P0);
  const long long r_off = idx_next - p_b * P0;
  const bool valid = p_b >= 0 && p_b < P;
  const int p_bc = (int)(p_b < 0 ? 0 : (p_b > P - 1 ? P - 1 : p_b));
  const float ca_b = s_ca[p_bc], sa_b = s_sa[p_bc];
  float* s_fold = s_u;                       // [4][t_n]: F re, F im, T re, T im
  long long isum_re = 0, isum_im = 0;        // int16 samples: exact sums
  float fsum_re = 0.0f, fsum_im = 0.0f;
  for (int j = tid; j < t_n; j += kThreads) {
    const int tau = t_lo + j;
    float rr_c = 0.0f, rr_s = 0.0f, qq_c = 0.0f, qq_s = 0.0f;
    float tr_c = 0.0f, tr_s = 0.0f, tq_c = 0.0f, tq_s = 0.0f;
    float b_re = 0.0f, b_im = 0.0f;
#pragma unroll 10
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
      if (p == p_bc) {
        b_re = re;
        b_im = im;
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
      ts_re = ts_re + (ca_b * b_re + sa_b * b_im);
      ts_im = ts_im + (ca_b * b_im - sa_b * b_re);
    }
    const float ang_b = kTwoPi * (fi * a.time_idc[tau] + ri);
    float sb, cb;
    sincosf(ang_b, &sb, &cb);
    s_fold[j] = rs_re * cb + rs_im * sb;
    s_fold[t_n + j] = rs_im * cb - rs_re * sb;
    s_fold[2 * t_n + j] = ts_re * cb + ts_im * sb;
    s_fold[3 * t_n + j] = ts_im * cb - ts_re * sb;
  }
  // the rank's part of the block mean (these also order the fold stores)
  if (kI16) {
    const long long sre = block_isum(isum_re, s_ired);
    const long long sim = block_isum(isum_im, s_ired);
    if (tid == 0) {
      reinterpret_cast<long long*>(s_mpart)[0] = sre;
      reinterpret_cast<long long*>(s_mpart)[1] = sim;
    }
  } else {
    float m[2] = {fsum_re, fsum_im};
    block_sums<2>(m, s_red, s_mpart);
  }
  lap(a, s_clk, 1);

  // the rank's lag partials: lag u < W at m0 + u, lag W at 0; a warp a lag,
  // lane l the taus l, l + 32, ...
  const long long m0 = pos_start - S / 2;
  for (int u = warp; u <= W; u += kWarps) {
    const int shift = u < W ? (int)pmod(m0 + u, P0) : 0;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = lane; j < t_n; j += 32) {
      int b = t_lo + j - shift;
      if (b < 0) b += P0;
      const float r = s_repl[b];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = __fmaf_rn(r, s_fold[k * t_n + j], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_down_sync(kFull, acc[k], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) s_lag[4 * u + k] = acc[k];
    }
  }
  __syncthreads();                           // the folds' region is free
  lap(a, s_clk, 2);

  // the first carrier pass's twiddles, while the other ranks catch up
  const int s1_n = ceil_div(S, kThreads);
  const int row_lo = split(rank, s1_n), rows = split(rank + 1, s1_n) - row_lo;
  const long long F = a.carr_fftpts, M = F - 1;
  const float scale = (float)(2.0 * 3.14159265358979323846 / (double)F);
  const float two_pi_fi = kTwoPi * fi;
  twiddles_at_width(s_u, row_lo, min(rows, kRowChunk), 0, min(kBinPass, WC), vel_start, F,
                    scale, two_pi_fi, dt_s);
  if (timed) __syncthreads();
  lap(a, s_clk, 3);
  cluster.sync();                            // 1: every rank's partials are in
  lap(a, s_clk, 4);

  // ---- the ranks' sums, in rank order -----------------------------------
  const int w_n = rank < W ? (W - 1 - rank) / kCluster + 1 : 0;   // the rank's windows
  if (tid < 4) {
    float v = cluster.map_shared_rank(s_lag, 0)[4 * W + tid];
    for (int r = 1; r < kCluster; ++r) v += cluster.map_shared_rank(s_lag, r)[4 * W + tid];
    s_c0[tid] = v;
  } else if (tid < 6) {
    const float inv_s = 1.0f / (float)S;
    if (kI16) {
      long long v = 0;
      for (int r = 0; r < kCluster; ++r)
        v += reinterpret_cast<const long long*>(cluster.map_shared_rank(s_mpart, r))[tid - 4];
      s_c0[tid] = (float)v * inv_s;
    } else {
      float v = cluster.map_shared_rank(s_mpart, 0)[tid - 4];
      for (int r = 1; r < kCluster; ++r) v += cluster.map_shared_rank(s_mpart, r)[tid - 4];
      s_c0[tid] = v * inv_s;
    }
  }
  for (int i = tid; i < 4 * w_n; i += kThreads) {
    const int w = rank + (i / 4) * kCluster, k = i % 4;
    float v = cluster.map_shared_rank(s_lag, 0)[4 * w + k];
    for (int r = 1; r < kCluster; ++r) v += cluster.map_shared_rank(s_lag, r)[4 * w + k];
    s_win[i] = v;
  }
  __syncthreads();
  const float c0nf_re = s_c0[0], c0nf_im = s_c0[1];
  const float c0fl_re = c0nf_re - 2.0f * s_c0[2], c0fl_im = c0nf_im - 2.0f * s_c0[3];
  const bool use_flip =
      (c0fl_re * c0fl_re + c0fl_im * c0fl_im) > (c0nf_re * c0nf_re + c0nf_im * c0nf_im);
  const float mean_re = s_c0[4], mean_im = s_c0[5];
  if (rank == 0 && tid == 0) a.flip[nc] = use_flip ? 1 : 0;
  lap(a, s_clk, 5);

  // the rank's code windows: the boundary arc (+/- kSliver/2 samples about
  // idx_next, wiped exactly), then the flip
  if (w_n > 0) {
    long long sl_start = idx_next - kSliver / 2;
    if (sl_start > S - kSliver) sl_start = S - kSliver;
    if (sl_start < 0) sl_start = 0;
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
    for (int i = warp; i < w_n; i += kWarps) {
      const int w = rank + i * kCluster;
      const long long m_w = m0 + w;
      float sr = 0.0f, si = 0.0f;
#pragma unroll
      for (int k4 = 0; k4 < kSliver / 32; ++k4) {
        const int k = lane + 32 * k4;
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
        const float nf_re = s_win[4 * i], nf_im = s_win[4 * i + 1];
        const float ct_re = s_win[4 * i + 2] + sr;
        const float ct_im = s_win[4 * i + 3] + si;
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
  if (timed) __syncthreads();
  lap(a, s_clk, 6);

  // ---- carrier phase: the rank's rows, up to kBinPass bins a pass --------
  PassIn q;
  q.s_repl = s_repl;
  q.row_lo = row_lo;
  q.rows = rows;
  q.idx_next = idx_next;
  q.vel_start = vel_start;
  q.F = F;
  q.use_flip = use_flip;
  q.mean_re = mean_re;
  q.mean_im = mean_im;
  q.scale = scale;
  q.two_pi_fi = two_pi_fi;
  q.dt_s = dt_s;
  const float phase_b = kTwoPi * (fi * (t0 + (float)tid * dt_s) + ri);
  for (int w0 = 0; w0 < WC; w0 += kBinPass) {
    q.w0 = w0;
    q.wn = min(kBinPass, WC - w0);
    if (w0 > 0) {                            // the last pass's partials are read
      twiddles_at_width(s_u, row_lo, min(rows, kRowChunk), w0, q.wn, vel_start, F, scale,
                        two_pi_fi, dt_s);
      __syncthreads();
      lap(a, s_clk, 3);
    }
    switch (pass_width(q.wn)) {
      case 36:
        carrier_dft<kI16, 36>(a, q, base, s_u, s_clk);
        break;
      case 24:
        carrier_dft<kI16, 24>(a, q, base, s_u, s_clk);
        break;
      default:
        carrier_dft<kI16, 12>(a, q, base, s_u, s_clk);
    }
    cluster.sync();                          // 2: every rank's partials z are in
    lap(a, s_clk, 8);

    // the rank's bins of the pass: z over the ranks in rank order, the s0
    // twiddles B (the bin phase (k_w s0) mod F steps by s0 from bin to bin),
    // the sum over s0
    const int b_lo = split(rank, q.wn), b_n = split(rank + 1, q.wn) - b_lo;
    long long ph = (((vel_start + w0 + b_lo - F / 2) & M) * tid) & M;
    float x[2 * kRankBins];
#pragma unroll
    for (int i = 0; i < kRankBins; ++i) {
      float x_re = 0.0f, x_im = 0.0f;
      if (i < b_n) {
        const int u = b_lo + i;
        const float* z0 = cluster.map_shared_rank(s_u, 0) + 2 * u * kThreads + tid;
        float z_re = z0[0], z_im = z0[kThreads];
#pragma unroll
        for (int r = 1; r < kCluster; ++r) {
          const float* zr = cluster.map_shared_rank(s_u, r) + 2 * u * kThreads + tid;
          z_re += zr[0];
          z_im += zr[kThreads];
        }
        float bs, bc;
        sincosf((float)ph * scale + phase_b, &bs, &bc);
        x_re = z_re * bc + z_im * bs;
        x_im = z_im * bc - z_re * bs;
      }
      x[2 * i] = x_re;
      x[2 * i + 1] = x_im;
      ph = (ph + tid) & M;
    }
    if (timed) __syncthreads();
    lap(a, s_clk, 9);
    block_sums_halving<2 * kRankBins>(x, s_red, s_x, 2 * b_n);
    if (tid < b_n) {
      const float x_re = s_x[2 * tid], x_im = s_x[2 * tid + 1];
      const size_t o = nc * WC + w0 + b_lo + tid;
      if (a.complex_out) {
        a.carr0[o] = x_re;
        a.carr1[o] = x_im;
      } else {
        a.carr0[o] = sqrtf(x_re * x_re + x_im * x_im);
      }
    }
    lap(a, s_clk, 10);
    cluster.sync();                          // 3: no rank reads these partials any more
    lap(a, s_clk, 11);
  }
  if (timed && tid == 0) {
    long long* out = a.clk + (nc * kCluster + rank) * kClocks;
    for (int k = 0; k < kClocks - 1; ++k) out[k] = s_clk[k];
    out[kClocks - 1] = s_clk[kClocks] - s_clk[kClocks + 1];
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

long long shared_bytes(int period) {
  return (long long)sizeof(float) * smem_floats(period);
}

template <bool kI16>
cudaError_t launch(const CorrArgs& a, cudaStream_t s) {
  auto kernel = windowed_correlate_kernel<kI16>;
  static size_t allowed = 48 * 1024;         // per instantiation
  const size_t bytes = (size_t)shared_bytes(a.period);
  cudaError_t e = allow_shared(kernel, bytes, allowed);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.n_chan * kCluster), (unsigned)a.n_blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The mixed split's s0 (the threads of a block): ops/correlate.py checks it.
int windowed_split() { return kThreads; }

// Thread blocks per (channel, block): the cluster size R.
int windowed_cluster() { return kCluster; }

// Words of the clock split a thread block writes (CorrArgs.clk).
int windowed_clock_words() { return kClocks; }

// Shared memory a thread block takes at this shape, in bytes, and the most
// it may take (ops/correlate.py refuses a larger shape before the launch).
long long windowed_shared_bytes(int period) {
  return shared_bytes(period);
}
long long windowed_shared_limit() { return kMaxShared; }

// Enqueues K5 (one cluster launch) on `stream`; allocates nothing, does
// not synchronize. Returns the launch's error, else cudaGetLastError()
// after it (0 on success), or cudaErrorInvalidValue for a shape the kernel
// does not take: N outside 1..65535, C outside 1..65535, more than
// kMaxPeriods periods, S other than period x n_periods or below kSliver,
// code_win outside 1..kMaxWin, carr_win < 1, a DFT length that is not a
// power of two below 2^32, or a shape whose shared memory exceeds
// kMaxShared.
int windowed_correlate_launch(const CorrArgs* args, void* stream) {
  const CorrArgs& a = *args;
  const long long F = a.carr_fftpts;
  if (a.n_blocks <= 0 || a.n_blocks > 65535 || a.n_chan <= 0 || a.n_chan > 65535 ||
      a.period <= 0 || a.n_periods <= 0 || a.n_periods > kMaxPeriods ||
      (long long)a.period * a.n_periods != a.n_samples || a.n_samples < kSliver ||
      a.code_win <= 0 || a.code_win > kMaxWin || a.carr_win <= 0 || F <= 1 ||
      F >= (1LL << 32) || (F & (F - 1)) != 0 ||
      shared_bytes(a.period) > kMaxShared)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(a.raw_i16 ? launch<true>(a, s) : launch<false>(a, s));
}

const char* windowed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
