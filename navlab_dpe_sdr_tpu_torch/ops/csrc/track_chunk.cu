// Scalar tracking for Hopper (sm_90a): the 1 ms E/P/L correlator (K3) and
// the closed-loop DLL/PLL tracker over a whole chunk (K4).
//
// Replaces the TPU kernels navlab_dpe_sdr_tpu/ops/pallas_track.py
// _kernel / correlate_window_pallas (K3) and track_chunk_pallas (K4), and
// the XLA scan of ops/tracking.py track_chunk (m = 1) they stand in for.
//
// K3, one 1 ms window of S samples, channel c:
//   bb[s]    = raw[s] * exp(-2 pi i (fi t_s + ri))              (wipeoff)
//   tap_x[s] = code[c, floor(t_s F_CA + rc_mid + x) mod 1023],  x = +1/2, 0, -1/2
//   seg[s]   = [s >= b1] + [s >= b2],  b_k = (k L_CA - rc) fs / fc
//   out[c, tap, seg, re/im] = sum_s tap[s] bb[s] [seg[s] == seg]
// with rc_mid = rc + dfc / 2 ms, fc = F_CA + dfc: the 18 segment sums of
// ops/tracking._correlate_step with direct code-table reads (the TPU's
// one-hot and constant-table lookups have no counterpart here).
//
// K4 loops K3 over the steps of a chunk and runs, after each window, the
// closed-loop tail of the scan body (ops/tracking.py:698-724): nav-bit
// polarity resolution and the prompt carry, the lock detector and the C/N0
// meter (two 20-sample rings), the phase time update, the DLL/PLL
// discriminators with optional FLL assist, and the loop filters. It logs
// one row per step: 16 floats [iE qE iP qP iL qL rc ri fc fi lockval snr dpc
// dpi sign0 sign1] and 3 ints [cp ncp lock], rc/ri/fc/fi/cp taken before
// the update as the JAX scan logs them.
//
// What bounds it on the card: latency, not bytes or FLOP/s. A chunk is a
// chain of dependent 1 ms steps (step k+1 correlates at the phases step k's
// loop filters produce), 10 KB of int16 samples and ~1.5e5 f32 operations
// per channel each, so the roofline time of a chunk is tens of microseconds
// and out of reach; what a step costs is one pass over the window (~130
// instructions per sample: a 2500-sample window fills one SM's instruction
// slots for ~1.5 us, so a channel is spread over a cluster), the exchange
// of the partial sums, and the dependent arithmetic from the sums to the
// next phases. The design keeps everything else off that chain:
//
// - One launch per chunk; a channel is a cluster of 4 thread blocks on
//   neighbouring SMs, persistent over all steps; the carry lives in
//   registers.
// - A ring of sample windows in each block's shared memory, filled ahead of
//   use by the block's last warp (the service warp): one cp.async.bulk (the
//   TMA 1-D bulk copy) per window completing on the slot's mbarrier, or,
//   where a window's base or byte length is not a multiple of 16, 4-byte
//   cp.async copies completing on the same mbarrier. The correlating warps
//   wait on the slot, never on global memory; samples stay int16 in shared
//   memory.
// - The channel's 1280 correlating threads (320 per block) take every
//   1280th sample each (two of them evaluated side by side), reduce the 18
//   sums over each warp with 20 shuffles (`halve`: a lane drops half of its
//   values at every level) and leave the warp's partials in the shared
//   memory of every block of the cluster (distributed shared memory).
// - Barrier 1 (the cluster's) ends the window. Then three warps of each
//   block share what the next window needs, by function: warp 0 the carrier
//   loop (polarity combine, PLL/FLL discriminators, filter), warp 1 the code
//   loop, warp 2 the time update; each first adds the per-warp partials in
//   warp order (18 lanes, one sum each). They publish to shared memory;
//   barrier 2 (the block's own) releases the next window, and every thread
//   forms the new phases from the published values. Every block of a
//   cluster computes the same bits, so nothing crosses SMs but the partials.
// - The service warp refills the slot barrier 1 freed and, after barrier 2,
//   runs on its lane 0 what no later window waits for: the lock detector,
//   the C/N0 meter (two 20-sample rings), the prompt carry, the signs and
//   the log row, while the others already correlate the next window. It
//   owns that part of the carry.
//
// Built with -fmad=false (see ops/_build.py) so every step is the same f32
// arithmetic, in the same order, as the plain PyTorch version
// (ops/track.py correlate_window_plain, ops/tracking.py), sample sums
// included: thread g of a channel's kLanes adds samples g, g + kLanes, ...
// in turn, a warp is reduced in the shfl_down tree's pairing, the warps are
// added in order (ops/track.py _kernel_order_sum follows track_threads()).
// Modulo is the floor-mod of jnp.mod / torch.remainder, and sign(0) is 0.
// The chip index floor(x) mod 1023 is taken in integers (the same value as
// the float floor-mod for |x| < 2^24). sincosf gives cosf's and sinf's bits
// (and torch.cos's/torch.sin's: K3 is held bit-equal on the card).
//
// An optional clock buffer (track_chunk_launch's `clk`) receives clock64()
// sums per channel: waiting for samples, correlate + warp reduce, barrier 1,
// the on-path tail (with barrier 2), the service warp's staging and tail,
// and the whole loop.
//
// K3's windows mode (correlate_windows_launch) is the open-loop correlation
// of vector tracking (ops/tracking.py track_open_loop, which the JAX package
// runs as an XLA scan): the window's phases from the f32 recurrence
// rc' = mod(rc + dfc T_MS, L_CA), ri' = mod(ri + fi T_MS, 1) iterated from
// the first window as the plain version iterates it, the 18 sums combined
// over the nav-bit hypotheses with a zero prompt carry in the kernel:
// [W, C, 3, 2] out of one launch. Its own kernel (correlate_windows_kernel):
// one thread block of kWinsLanes = 256 threads per (window, channel), no
// cluster. A block copies its code row, the time table and its window
// into shared memory with 4-byte cp.async copies, all in flight at once,
// while it iterates the phase recurrence (floor_mod_near: fmodf's bits
// without its iterative reduction, which cost 2.8 us of a 40-window
// launch on an H100 80GB HBM3 at 700 W), then correlates ~10 samples a
// thread and reduces; one barrier, no ring. An earlier form ran the 1 ms
// K3 cluster per (window, channel), which copied the whole window, the
// time table and the code row into each of its 4 blocks' shared memory
// (~15 MB from L2 for 0.2 MB of samples at 20 windows x 8 channels) behind
// a ring barrier and two cluster barriers, for ~8 samples a thread. 256
// lanes beat 128 and 512 at 20 and 40 windows (more blocks an SM; 512 won
// at one window by 5 %); reading the three in place instead of staging
// them was 4 % slower at 20 windows, 36 % at one and 5 % faster at 40
// (H100 80GB HBM3, 700 W). Its sum order is its own (ops/track.py
// _kernel_order_sum with WINDOWS_LANES).
//
// The second K4 kernel (track_window_kernel) runs the two schedules the JAX
// package computes in XLA (ops/tracking.py _track_chunk_jit at coh_ms > 1,
// track_chunk_batched):
// - coherent windows of m = 2..10 code periods: m + 2 segments, so 6m + 12
//   sums, the m-scaled tail (the single-flip hypothesis test over m + 2
//   segments, m + 1 signs, lock thresholds and C/N0 denominator from
//   TrackParams); a window's log row also carries its m + 2 prompt
//   segment sums (in-phase, quadrature), the soft values a weak channel's
//   nav bits are decided from;
// - batch_k at m = 1: window w of a batch correlates at the phases
//   predicted from the batch-start rates, rc_w = mod(rc + (dfc T_MS) w,
//   L_CA), while the updates run per window as at m = 1; the batch closes
//   with the frozen-rate carry mod(rc_{k-1} + dfc T_MS, L_CA).
// Its design (redesigned from a first one that walked a window once per
// group of three segments, with the time table in global memory): one
// correlation pass per coherent window, and per batch (up to four 1 ms
// windows, correlated together behind one cluster barrier, their updates
// then run back to back by the tail warps). A warp takes a contiguous
// chunk of a window's samples, so it meets at most two segments (12 sums,
// one warp reduction); after barrier 1 each sum adds only the warps whose
// chunks meet its segment, one thread a sum. A block stages, by one bulk
// copy a pass, only the samples its own warps take, and keeps their sample
// times in shared memory beside them. A channel is a cluster of kWinCluster
// = 8 blocks (64 of the 132 SMs for 8 channels; 4 and 16 were slower). Lane
// w of warps 0 and 1 combines window w over the nav-bit hypotheses; the two
// warps then run the pass's loop updates in turn. After barrier 2 the
// service warp of the first block logs the pass, the C/N0 rings across its
// lanes and lane w taking window w's ring sums. What bounds it is latency,
// as for the 1 ms kernel: an update is a correlation pass, a cluster
// barrier and the dependent tail of one warp. The m = 1 schedule stays in
// track_chunk_kernel, untouched.
//
// Later: the partial sums handed over with remote mbarrier arrivals instead
// of the cluster barrier.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 1280;      // correlating threads per channel: the sum order
constexpr int kCluster = 4;       // thread blocks per channel: one cluster
constexpr int kBlockCorr = kLanes / kCluster;     // correlating threads per block
constexpr int kBlockWarps = kBlockCorr / 32;
constexpr int kBlockThreads = kBlockCorr + 32;    // + the service warp
constexpr int kWarps = kLanes / 32;               // partial sums per channel
constexpr int kRingMax = 6;       // sample windows in flight, at most
constexpr int kUnroll = 2;        // samples a thread evaluates side by side
constexpr int kSums = 18;      // tap(E, P, L) x seg(3) x re/im
constexpr int kCode = 1023;
constexpr int kSnrN = 20;
constexpr int kStateF = 16;
constexpr int kStateI = 5;
constexpr int kLogF = 16;
constexpr int kLogI = 3;
constexpr int kClocks = 6;     // wait, correlate, barrier, on-path, tail, loop
// K3's windows mode: its own thread count, so its own sum order
// (ops/track.py WINDOWS_LANES, track_windows_lanes()).
constexpr int kWinsLanes = 256;   // threads (lanes) per (window, channel)
constexpr int kWinsWarps = kWinsLanes / 32;
constexpr int kMaxM = 10;      // code periods a coherent window holds, at most
constexpr int kMaxSeg = kMaxM + 2;
// The second K4 kernel (coherent windows, batch_k): its own cluster size,
// so its own sum order (ops/track.py WINDOW_LANES, track_window_lanes()).
constexpr int kWinCluster = 8;    // thread blocks per channel
constexpr int kWinBlockCorr = 320;   // correlating threads per block
constexpr int kWinUnroll = 2;     // samples a thread evaluates side by side
constexpr int kWinBlockWarps = kWinBlockCorr / 32;
constexpr int kWinBlockThreads = kWinBlockCorr + 32;   // + the service warp
constexpr int kWinLanes = kWinCluster * kWinBlockCorr;
constexpr int kWinWarps = kWinLanes / 32;
constexpr int kMaxPass = 4;       // 1 ms windows of a batch correlated together
constexpr int kMaxPassSeg = 12;   // segments of a pass: m + 2, or 3 per window
constexpr int kPassSums = kMaxPassSeg * 6;
constexpr float kFca = 1.023e6f;
constexpr float kLca = 1023.0f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kLockK = 1.5f;
// Dynamic shared memory a block may ask for: the card's 227 KB less the
// static part (the partial sums by parity, barriers, rings, Pub).
constexpr size_t kSmemMax = 232448 - (2 * (kLanes / 32) * 18 * 4 + 1024);

static_assert(kLanes % (32 * kCluster) == 0, "whole warps per block");
static_assert(kBlockThreads <= 1024, "block too large");
static_assert(kCluster == 4, "__cluster_dims__ of the kernels");
static_assert(kRingMax >= 2, "the ring needs two slots");
static_assert(kBlockWarps >= 3, "three warps share the on-path tail");
static_assert(kMaxSeg <= kMaxPassSeg && 3 * kMaxPass <= kMaxPassSeg, "pass segments");
static_assert(kPassSums <= 96, "a pass's sums: one thread each of warps 0-2");
static_assert(kWinCluster <= 8 && kWinWarps >= kMaxPass, "window kernel cluster: portable");
static_assert(kWinBlockCorr % 32 == 0 && kWinBlockWarps >= 3 && kWinBlockThreads <= 1024,
              "window kernel block");
// The second K4 kernel's dynamic shared memory: the card's 227 KB less its
// static part (barriers, rings, Pubs).
constexpr size_t kSmemMaxW = 232448 - 1024;

}  // namespace

// Scalars of one tracker configuration, all cast to f32 on the host from
// the same float64 expressions the JAX scan folds into its constants.
struct TrackParams {
  float fs;          // f32(fs)
  float win_s;       // f32(S / fs)
  float inv_lca;     // f32(1 / L_CA)
  float t_up;        // f32(T_MS)
  float fcaid;       // f32(fcaid)
  float lpf;         // lock-detector LPF coefficient
  float one_m_lpf;   // f32(1 - lpf)
  float snr_den;     // f32(2 * SNR_N * T_MS)
  float fll_norm;    // f32(2 pi T_MS)
  float carr[5];     // kap, kvp, kpp, kaf, kvf of the carrier loop
  float code[5];     // the same for the code loop
  int boxcar;
  int fll;           // FLL assist on (bn_carr_freq > 0)
  int carr_h2;       // carrier loop has an acceleration integrator
  int code_h2;
  int loss_th;
  int lock_th;
  float half_win;    // f32(m * 0.5e-3): rc_mid = rc + dfc half_win
  int m;             // code periods a window holds
  int batch_k;       // windows a batch (1: no batching)
};

namespace {

// ---- shared-memory barriers and asynchronous copies (PTX) ----------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        "  .reg .pred p;\n"
        "  mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "  selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One sample window, global -> the ring slot `dst`, by the 32 lanes of the
// service warp; the slot's mbarrier (count 32) completes when the bytes
// have landed. `bulk`: one TMA bulk copy (dst, src, bytes multiples of 16);
// else 4-byte cp.async copies.
__device__ __forceinline__ void stage_window(unsigned char* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar, bool bulk,
                                             int lane) {
  if (bulk) {
    if (lane == 0) {
      mbar_arrive_expect_tx(bar, bytes);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
          "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_u32(bar))
          : "memory");
    } else {
      mbar_arrive(bar);
    }
  } else {
    const unsigned char* s = (const unsigned char*)src;
    for (uint32_t off = 4u * lane; off < bytes; off += 128u)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst + off)),
                   "l"(__cvta_generic_to_global(s + off))
                   : "memory");
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                     smem_u32(bar))
                 : "memory");
  }
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

// The step barrier: every thread of the channel's cluster. The aligned
// forms need each warp converged, which __syncwarp makes explicit after
// code that only some lanes ran.
__device__ __forceinline__ void channel_sync() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::
                   : "memory");
}

// The block's own barrier, from converged warps likewise.
__device__ __forceinline__ void block_sync() {
  __syncwarp();
  __syncthreads();
}

// v -> the same shared-memory word of cluster block `rank`.
__device__ __forceinline__ void store_to_rank(float* local, int rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote), "f"(v) : "memory");
}

// ---- arithmetic shared with the plain version ------------------------------

__device__ __forceinline__ float floor_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

// floor_mod(a, b), b > 0, without fmodf's iterative reduction where |a| < 2 b
// (b = 1: |a| < 2^23). fmodf's result is exact, and so is each shortcut:
// a - b for b <= a < 2 b (Sterbenz), a - trunc(a) with a's sign (fmodf(a, 1)
// keeps the dividend's sign, a zero's too); so the bits are floor_mod's.
// Used by the windows mode's phase recurrence, a chain of W steps.
__device__ __forceinline__ float floor_mod_near(float a, float b) {
  float m;
  if (b == 1.0f && fabsf(a) < 8388608.0f) m = copysignf(a - truncf(a), a);
  else if (a > -b && a < b) m = a;
  else if (a >= b && a < 2.0f * b) m = a - b;
  else m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

// Float log rows per update of an m-period window (ops/track.py n_log_f):
// 14, the m + 1 nav-bit signs, and at m > 1 the m + 2 prompt segment sums.
__host__ __device__ __forceinline__ int log_f_rows(int m) {
  return 15 + m + (m > 1 ? 2 * (m + 2) : 0);
}

__device__ __forceinline__ float sign_of(float x) {
  return (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : 0.0f);
}

// floor(x) mod 1023 in integers: the value of floor_mod(floorf(x), 1023).
__device__ __forceinline__ int chip_index(float x) {
  int i = __float2int_rd(x) % kCode;
  return i < 0 ? i + kCode : i;
}

__device__ __forceinline__ void load_iq(const int16_t* w, int s, float& re, float& im) {
  const short2 v = reinterpret_cast<const short2*>(w)[s];
  re = (float)v.x;
  im = (float)v.y;
}
__device__ __forceinline__ void load_iq(const float* w, int s, float& re, float& im) {
  const float2 v = reinterpret_cast<const float2*>(w)[s];
  re = v.x;
  im = v.y;
}

// One level of the warp reduction of W values per lane: the lanes whose bit
// `off` is clear keep values [0, H), the others [H, W), H = ceil(W / 2);
// each hands the half it drops to its partner lane ^ off and adds what it
// receives to what it keeps. Every value still meets the partners
// shfl_down(off) would give it, in the same tree (a + b = b + a), for H
// shuffles instead of W.
template <int W>
__device__ __forceinline__ void halve(float v[], int off, int lane) {
  constexpr int H = (W + 1) / 2;
  const bool up = (lane & off) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = v[i];
    const float hi = (i + H < W) ? v[i + H] : 0.0f;
    const float recv = __shfl_xor_sync(0xffffffffu, up ? lo : hi, off);
    v[i] = (up ? hi : lo) + recv;
  }
}

// After the halve levels from W values (offsets 16 .. 1; for W = 18: <18>,
// <9>, <5>, <3>, <2>) a lane holds in v[0] the warp's total of one of the W
// sums: which one (or -1: none).
template <int W>
__device__ __forceinline__ int reduce_owner(int lane) {
  int n = W, width = W, base = 0;
  for (int off = 16; off > 0; off >>= 1) {
    const int h = (width + 1) / 2;
    if (lane & off) {
      base += h;
      n = n > h ? n - h : 0;
    } else {
      n = n < h ? n : h;
    }
    width = h;
  }
  return n > 0 ? base : -1;
}

// K3 body, first half: this thread's share of the 18 sums of the window in
// the ring slot `win` (samples g, g + kL, ...), reduced over its warp; the
// lane that ends up owning sum `own` leaves the warp's partial in
// `red[gwarp][own]` of every block of the channel (kToCluster; else of its
// own block). `g` is the thread's index among the channel's kL, `own` its
// reduce_owner.
template <typename T, int kL = kLanes, bool kToCluster = true>
__device__ __forceinline__ void correlate_partial(
    const T* win, const float* s_time, const float* s_code, int n_samp, float fs,
    float rc, float dfc, float ri, float fi, int g, int own, float (*red)[kSums]) {
  float acc[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;
  const float rc_mid = rc + dfc * 0.5e-3f;
  const float ph_e = rc_mid + 0.5f;
  const float ph_l = rc_mid - 0.5f;
  const float ratio = fs / (kFca + dfc);
  const float b1 = (kLca - rc) * ratio;
  const float b2 = (2.0f * kLca - rc) * ratio;
  // kUnroll samples of this thread are evaluated side by side (they do not
  // depend on one another) and then added in their order.
  for (int s0 = g; s0 < n_samp; s0 += kUnroll * kL) {
    float bre[kUnroll], bim[kUnroll], e[kUnroll], p[kUnroll], l[kUnroll];
    int seg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = min(s0 + u * kL, n_samp - 1);
      const float t = s_time[s];
      float re, im;
      load_iq(win, s, re, im);
      const float ang = kTwoPi * (fi * t + ri);
      float wc, ws;
      sincosf(ang, &ws, &wc);
      bre[u] = re * wc + im * ws;
      bim[u] = im * wc - re * ws;
      const float base = t * kFca;
      e[u] = s_code[chip_index(base + ph_e)];
      p[u] = s_code[chip_index(base + rc_mid)];
      l[u] = s_code[chip_index(base + ph_l)];
      const float k = (float)s;
      seg[u] = (int)(k >= b1) + (int)(k >= b2);
    }
#define NAVLAB_ACC(SEG)                                   \
  {                                                       \
    acc[0 * 6 + (SEG) * 2 + 0] += e[u] * bre[u];          \
    acc[0 * 6 + (SEG) * 2 + 1] += e[u] * bim[u];          \
    acc[1 * 6 + (SEG) * 2 + 0] += p[u] * bre[u];          \
    acc[1 * 6 + (SEG) * 2 + 1] += p[u] * bim[u];          \
    acc[2 * 6 + (SEG) * 2 + 0] += l[u] * bre[u];          \
    acc[2 * 6 + (SEG) * 2 + 1] += l[u] * bim[u];          \
  }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s0 + u * kL >= n_samp) break;
      if (seg[u] == 0) NAVLAB_ACC(0)
      else if (seg[u] == 1) NAVLAB_ACC(1)
      else NAVLAB_ACC(2)
    }
#undef NAVLAB_ACC
  }
  const int lane = g & 31;
  halve<18>(acc, 16, lane);
  halve<9>(acc, 8, lane);
  halve<5>(acc, 4, lane);
  halve<3>(acc, 2, lane);
  halve<2>(acc, 1, lane);
  if (own >= 0) {
    float* mine = &red[g >> 5][own];
    if (kToCluster) {
      for (int r = 0; r < kCluster; ++r) store_to_rank(mine, r, acc[0]);
    } else {
      *mine = acc[0];
    }
  }
}

// K3 body, second half, after the step barrier: lane i < 18 of the calling
// warp adds sum i's per-warp partials in warp order and returns it.
__device__ __forceinline__ float finish_sum(float (*red)[kSums], int lane) {
  const int i = lane < kSums ? lane : kSums - 1;
  float v = red[0][i];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v += red[w][i];
  return v;
}

// ... and every lane of the warp gets all 18.
__device__ __forceinline__ void all_sums(float (*red)[kSums], int lane,
                                         float sums[kSums]) {
  const float v = finish_sum(red, lane);
#pragma unroll
  for (int i = 0; i < kSums; ++i) sums[i] = __shfl_sync(0xffffffffu, v, i);
}

// One loop-filter update (ops/tracking.py _lf_step); h/h2 in place.
__device__ __forceinline__ float lf_step(float& h, float& h2, float xp, float xf,
                                         const float k[5], bool use_h2,
                                         bool boxcar, float t) {
  float acc_out = 0.0f;
  if (use_h2) {
    const float hn = h2 + t * (k[0] * xp + k[3] * xf);
    acc_out = boxcar ? hn : (hn + h2) * 0.5f;
    h2 = hn;
  }
  const float hn = h + t * (acc_out + k[1] * xp + k[4] * xf);
  const float vel = boxcar ? hn : (hn + h) * 0.5f;
  h = hn;
  return vel + k[2] * xp;
}

// ---- the on-path half of a step's tail ------------------------------------
// From the window's 18 sums to the phases of the next window. Three warps
// share it by function (the carrier loop, the code loop, the time update),
// each on the state it owns, and publish to shared memory (Pub); the
// service warp's lane 0 reads the same values for the log.

// Nav-bit polarity resolution (m = 1 decision tree): comb = e_r, p_r, l_r
// as (re, im).
__device__ __forceinline__ void polarity_combine(const float sums[kSums], float comb[6]) {
  const float* es = sums;
  const float* ps = sums + 6;
  const float* ls = sums + 12;
  float tr[3], ti[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    tr[j] = es[2 * j] + ps[2 * j] + ls[2 * j];
    ti[j] = es[2 * j + 1] + ps[2 * j + 1] + ls[2 * j + 1];
  }
  float ar = tr[0] + tr[1], ai = ti[0] + ti[1], br = tr[0] - tr[1], bi = ti[0] - ti[1];
  const bool flip01 = (ar * ar + ai * ai) < (br * br + bi * bi);
  ar = tr[1] + tr[2]; ai = ti[1] + ti[2]; br = tr[1] - tr[2]; bi = ti[1] - ti[2];
  const bool flip12 = (ar * ar + ai * ai) < (br * br + bi * bi);
  const float g1 = flip01 ? -1.0f : 1.0f;
  const float g2 = flip01 ? -1.0f : (flip12 ? -1.0f : 1.0f);
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float* x = sums + tap * 6 + q;
      float a = x[0];
      a = a + g1 * x[2];
      a = a + g2 * x[4];
      comb[tap * 2 + q] = a;
    }
}

// The carrier loop's own carry: its filter and the previous prompt.
struct CarrierLoop {
  float h, h2, prev_re, prev_im;
};

// PLL discriminator (dpi), optional FLL assist, carrier loop filter -> di.
__device__ __forceinline__ float carrier_step(CarrierLoop& c, const float comb[6],
                                              const TrackParams& p, float& dpi) {
  const float ip = comb[2], qp = comb[3];
  dpi = (ip != 0.0f) ? atanf(qp / ip) / kTwoPi : 0.0f;
  float xf = 0.0f;
  if (p.fll) {
    const float cross = c.prev_re * qp - ip * c.prev_im;
    const float dot = c.prev_re * ip + c.prev_im * qp;
    const float sgn = dot < 0.0f ? -1.0f : 1.0f;
    xf = atan2f(sgn * cross, sgn * dot) / p.fll_norm;
  }
  c.prev_re = ip;
  c.prev_im = qp;
  return lf_step(c.h, c.h2, dpi, xf, p.carr, p.carr_h2 != 0, p.boxcar != 0, p.t_up);
}

struct CodeLoop {
  float h, h2;
};

// DLL discriminator (dpc), code loop filter -> dc.
__device__ __forceinline__ float code_step(CodeLoop& c, const float comb[6],
                                           const TrackParams& p, float& dpc) {
  const float e_env = sqrtf(comb[0] * comb[0] + comb[1] * comb[1]);
  const float l_env = sqrtf(comb[4] * comb[4] + comb[5] * comb[5]);
  const float denom = e_env + l_env;
  dpc = (denom != 0.0f) ? (e_env - l_env) / (2.0f * fmaxf(denom, 1e-30f)) : 0.0f;
  return lf_step(c.h, c.h2, dpc, 0.0f, p.code, p.code_h2 != 0, p.boxcar != 0, p.t_up);
}

// What a step's on-path tail publishes (shared memory, one per block).
struct Pub {
  float comb[6];          // carrier warp
  float dpi, di;          // carrier warp
  float dpc, dc;          // code warp
  float rc_new, ri_new;   // time warp
};

// The phases every thread carries from window to window.
struct Phases {
  float rc, dfc, ri, fi, dfc_bias, fi_bias;
};

// The last step of the tail, in every thread alike, from the published
// values: the new phases.
__device__ __forceinline__ void advance(Phases& ph, const Pub& pub, const TrackParams& p) {
  ph.fi = ph.fi_bias + pub.di;
  ph.dfc = ph.dfc_bias + pub.dc + p.fcaid * (ph.fi_bias + pub.di);
  ph.rc = pub.rc_new;
  ph.ri = pub.ri_new;
}

// ---- the off-path half: owned by lane 0 of the service warp ---------------
struct Monitor {
  float p_a_re, p_a_im, lock_i, lock_q;
  int cp, losscount, lockcount, lock, snr_fill, head;
};

// Oldest-first mean of a 20-sample ring whose oldest sample is at `head`.
__device__ __forceinline__ float ring_mean(const float* r, int head) {
  float s = 0.0f;
  int j = head;
  for (int i = 0; i < kSnrN; ++i) {
    s += r[j];
    j = (j + 1 == kSnrN) ? 0 : j + 1;
  }
  return s / (float)kSnrN;
}

// The lock detector and the C/N0 meter on the combined prompt (ip, qp):
// updates the monitor's detector state and its two 20-sample rings (the
// oldest at mo.head) and returns the lock flag, its margin and the C/N0.
struct LockOut {
  int lock;
  float lockval, snr;
};

__device__ __forceinline__ LockOut lock_and_cn0(Monitor& mo, float ip, float qp,
                                                const TrackParams& p, float* s_rz,
                                                float* s_rv) {
  const float li = p.lpf * fabsf(ip) + p.one_m_lpf * mo.lock_i;
  const float lq = p.lpf * fabsf(qp) + p.one_m_lpf * mo.lock_q;
  const bool in_lock = (li / kLockK) > lq;
  const int lock = (in_lock && mo.lockcount > p.lock_th)
                       ? 1
                       : ((!in_lock && mo.losscount > p.loss_th) ? 0 : mo.lock);
  const float lockval = li / kLockK - lq;
  const float z = ip * ip + qp * qp;
  const int next = (mo.head + 1 == kSnrN) ? 0 : mo.head + 1;
  s_rz[mo.head] = z;                   // drop the oldest, append z
  const float z_mean = ring_mean(s_rz, next);
  float v = z - z_mean;
  v = v * v;
  s_rv[mo.head] = v;
  const float z_var = ring_mean(s_rv, next);
  const float carrier = sqrtf(fmaxf(z_mean * z_mean - z_var, 0.0f));
  const float noise_var = fmaxf((z_mean - carrier) / 2.0f, 1e-12f);
  const float logarg = fmaxf(carrier / (p.snr_den * noise_var), 1.0f);
  mo.losscount = in_lock ? 0 : mo.losscount + 1;
  mo.lockcount = in_lock ? mo.lockcount + 1 : 0;
  mo.lock_i = li;
  mo.lock_q = lq;
  mo.lock = lock;
  mo.snr_fill += 1;
  mo.head = next;
  return {lock, lockval, 10.0f * log10f(logarg)};
}

// What no later window waits for: prompt carry and signs, lock detector,
// C/N0 meter and the log row (the phases `ph` before the update, the
// published discriminators). Runs while the next window correlates.
__device__ __forceinline__ void monitor_and_log(const Phases& ph, Monitor& mo,
                                                const float sums[kSums], const Pub& pub,
                                                const TrackParams& p, float* s_rz,
                                                float* s_rv, float* logf, int* logi,
                                                int log_stride) {
  const float* ps = sums + 6;
  const float fc = kFca + ph.dfc;
  const int ncp = (int)floorf((p.win_s * fc + ph.rc) * p.inv_lca);

  const float sign0 = -sign_of(mo.p_a_re + ps[0]);
  const float sign1 = -sign_of(ps[2]);
  float pa[2];
  for (int q = 0; q < 2; ++q) {
    const float carry = q == 0 ? mo.p_a_re : mo.p_a_im;
    float a = (ncp == 0) ? carry + ps[q] : 0.0f;
    a = a + ((ncp == 1) ? ps[2 + q] : 0.0f);
    a = a + ((ncp == 2) ? ps[4 + q] : 0.0f);
    pa[q] = a;
  }

  const LockOut lk = lock_and_cn0(mo, pub.comb[2], pub.comb[3], p, s_rz, s_rv);
  const float row[kLogF] = {pub.comb[0], pub.comb[1], pub.comb[2], pub.comb[3],
                            pub.comb[4], pub.comb[5], ph.rc, ph.ri, fc, ph.fi,
                            lk.lockval, lk.snr, pub.dpc, pub.dpi, sign0, sign1};
#pragma unroll
  for (int f = 0; f < kLogF; ++f) logf[f * log_stride] = row[f];
  logi[0] = mo.cp;
  logi[log_stride] = ncp;
  logi[2 * log_stride] = lk.lock;

  mo.cp += ncp;
  mo.p_a_re = pa[0];
  mo.p_a_im = pa[1];
}

// A channel's carry from the packed state (ops/tracking.pack_state): the
// phases and both loops in every thread, the monitor and the C/N0 rings (in
// shared memory, oldest first) in the logger only.
__device__ __forceinline__ void load_carry(int c, bool logger, const float* stf_in,
                                           const int* sti_in, const float* ring_in,
                                           Phases& ph, CarrierLoop& carr, CodeLoop& code,
                                           Monitor& mo, float* s_rz, float* s_rv) {
  const float* f_in = stf_in + (size_t)c * kStateF;
  ph = {f_in[0], f_in[1], f_in[2], f_in[3], f_in[4], f_in[5]};
  carr = {f_in[9], f_in[11], f_in[14], f_in[15]};   // warp 0's
  code = {f_in[8], f_in[10]};                        // warp 1's
  mo = {};
  if (logger) {
    const int* q = sti_in + (size_t)c * kStateI;
    mo.p_a_re = f_in[6]; mo.p_a_im = f_in[7]; mo.lock_i = f_in[12]; mo.lock_q = f_in[13];
    mo.cp = q[0]; mo.losscount = q[1]; mo.lockcount = q[2]; mo.lock = q[3];
    mo.snr_fill = q[4];
    for (int i = 0; i < kSnrN; ++i) {
      s_rz[i] = ring_in[((size_t)c * 2 + 0) * kSnrN + i];
      s_rv[i] = ring_in[((size_t)c * 2 + 1) * kSnrN + i];
    }
  }
}

// The final carry, each field from the thread that owns it.
__device__ __forceinline__ void store_carry(int c, int rank, int warp, int lane, bool logger,
                                            const Phases& ph, const CarrierLoop& carr,
                                            const CodeLoop& code, const Monitor& mo,
                                            const float* s_rz, const float* s_rv,
                                            float* stf_out, int* sti_out, float* ring_out) {
  float* f = stf_out + (size_t)c * kStateF;
  if (rank == 0 && lane == 0 && warp == 0) {
    f[9] = carr.h; f[11] = carr.h2; f[14] = carr.prev_re; f[15] = carr.prev_im;
  }
  if (rank == 0 && lane == 0 && warp == 1) {
    f[8] = code.h; f[10] = code.h2;
  }
  if (logger) {
    int* q = sti_out + (size_t)c * kStateI;
    f[0] = ph.rc; f[1] = ph.dfc; f[2] = ph.ri; f[3] = ph.fi;
    f[4] = ph.dfc_bias; f[5] = ph.fi_bias; f[6] = mo.p_a_re; f[7] = mo.p_a_im;
    f[12] = mo.lock_i; f[13] = mo.lock_q;
    q[0] = mo.cp; q[1] = mo.losscount; q[2] = mo.lockcount; q[3] = mo.lock;
    q[4] = mo.snr_fill;
    int j = mo.head;
    for (int i = 0; i < kSnrN; ++i) {  // back to oldest-first order
      ring_out[((size_t)c * 2 + 0) * kSnrN + i] = s_rz[j];
      ring_out[((size_t)c * 2 + 1) * kSnrN + i] = s_rv[j];
      j = (j + 1 == kSnrN) ? 0 : j + 1;
    }
  }
}

// Dynamic shared memory of a block: the ring, the time table, one code row.
struct Smem {
  unsigned char* ring;
  float* time;
  float* code;
  uint32_t win_bytes, slot_bytes;
};

template <typename T>
__device__ __forceinline__ Smem carve(unsigned char* base, int n_samp, int depth) {
  Smem m;
  m.win_bytes = (uint32_t)n_samp * 2u * (uint32_t)sizeof(T);
  m.slot_bytes = (m.win_bytes + 15u) & ~15u;
  m.ring = base;
  m.time = reinterpret_cast<float*>(base + (size_t)depth * m.slot_bytes);
  m.code = m.time + n_samp;
  return m;
}

// Tables into shared memory, the ring's barriers armed; ends in a barrier.
__device__ __forceinline__ void block_setup(const Smem& m, const float* time_idc,
                                            const float* code_row, int n_samp,
                                            uint64_t* s_full, int depth) {
  for (int i = threadIdx.x; i < n_samp; i += blockDim.x) m.time[i] = time_idc[i];
  for (int i = threadIdx.x; i < kCode; i += blockDim.x) m.code[i] = code_row[i];
  if (threadIdx.x == 0) {
    for (int d = 0; d < depth; ++d) mbar_init(&s_full[d], 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  block_sync();
  channel_sync();   // peers' shared memory is live
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads) __cluster_dims__(4, 1, 1)
correlate_window_kernel(const T* __restrict__ raw, const float* __restrict__ time_idc,
                        const float* __restrict__ table, const float* __restrict__ phases,
                        int n_samp, float fs, int bulk, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_red[kWarps][kSums];
  __shared__ __align__(8) uint64_t s_full[1];
  const int c = blockIdx.x / kCluster;
  const int rank = cluster_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Smem m = carve<T>(smem, n_samp, 1);           // a ring of one slot
  block_setup(m, time_idc, table + (size_t)c * kCode, n_samp, s_full, 1);
  if (warp == kBlockWarps) {
    stage_window(m.ring, raw, m.win_bytes, &s_full[0], bulk != 0, lane);
  } else {
    const float* ph = phases + 4 * c;  // rc, dfc, ri, fi
    mbar_wait(&s_full[0], 0);
    correlate_partial(reinterpret_cast<const T*>(m.ring), m.time, m.code, n_samp, fs,
                      ph[0], ph[1], ph[2], ph[3], rank * kBlockCorr + (int)threadIdx.x,
                      reduce_owner<kSums>(lane), s_red);
  }
  channel_sync();
  if (rank == 0 && warp == 0) {
    const float v = finish_sum(s_red, lane);
    if (lane < kSums) out[c * kSums + lane] = v;
  }
}

// 4-byte asynchronous copies global -> shared of `words` words, by the
// block's threads; the caller waits with cp_async_wait_all().
__device__ __forceinline__ void copy_words_async(void* dst, const void* src, int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     smem_u32(reinterpret_cast<uint32_t*>(dst) + i)),
                 "l"(__cvta_generic_to_global(reinterpret_cast<const uint32_t*>(src) + i))
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Dynamic shared memory of a windows-mode block: the code row (1024
// floats), the time table (S floats, rounded up to an even count) and the
// window's S sample pairs.
size_t windows_smem(int n_samp, int raw_i16) {
  return ((size_t)kCode + 1 + ((size_t)n_samp + 1) / 2 * 2) * sizeof(float) +
         (size_t)n_samp * 2 * (raw_i16 ? sizeof(int16_t) : sizeof(float));
}

// K3's windows mode: one thread block of kWinsLanes threads per (window,
// channel), no cluster (see the note at the top). The blocks of the last
// windows, whose phase recurrence is longest, start first. A block first
// puts its code row, the time table and its window into shared memory
// with asynchronous copies, all in flight at once, and iterates the phase
// recurrence up to its window meanwhile (a warp issues it once for its 32
// lanes); each thread then correlates samples g, g + kWinsLanes, ... and
// reduces over its warp; warp 0 adds the warps' partials in warp order and
// combines the nav-bit hypotheses with a zero prompt carry.
template <typename T>
__global__ void __launch_bounds__(kWinsLanes)
correlate_windows_kernel(const T* __restrict__ raw, const float* __restrict__ time_idc,
                         const float* __restrict__ table, const float* __restrict__ rc0,
                         const float* __restrict__ dfc0, const float* __restrict__ ri0,
                         const float* __restrict__ fi0, int ph_stride, int n_samp,
                         int n_chan, int n_win, float fs, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_red[kWinsWarps][kSums];
  const int c = blockIdx.x % n_chan;
  const int w = n_win - 1 - (int)(blockIdx.x / n_chan);
  const int lane = threadIdx.x & 31;
  float* s_code = reinterpret_cast<float*>(smem);
  float* s_time = s_code + kCode + 1;
  T* s_win = reinterpret_cast<T*>(s_time + (n_samp + 1) / 2 * 2);
  copy_words_async(s_code, table + (size_t)c * kCode, kCode);
  copy_words_async(s_time, time_idc, n_samp);
  copy_words_async(s_win, raw + (size_t)w * 2 * n_samp, n_samp * (int)(2 * sizeof(T) / 4));
  const float dfc = dfc0[(size_t)c * ph_stride], fi = fi0[(size_t)c * ph_stride];
  float rc = rc0[(size_t)c * ph_stride], ri = ri0[(size_t)c * ph_stride];
  for (int i = 0; i < w; ++i) {        // the recurrence of the windows before
    rc = floor_mod_near(rc + dfc * 1e-3f, kLca);
    ri = floor_mod_near(ri + fi * 1e-3f, 1.0f);
  }
  cp_async_wait_all();
  __syncthreads();
  correlate_partial<T, kWinsLanes, false>(s_win, s_time, s_code, n_samp, fs, rc, dfc, ri,
                                          fi, (int)threadIdx.x, reduce_owner<kSums>(lane),
                                          s_red);
  __syncthreads();
  if (threadIdx.x < 32) {
    const int i = lane < kSums ? lane : kSums - 1;
    float v = s_red[0][i];
#pragma unroll
    for (int wp = 1; wp < kWinsWarps; ++wp) v += s_red[wp][i];
    float sums[kSums], comb[6];
#pragma unroll
    for (int k = 0; k < kSums; ++k) sums[k] = __shfl_sync(0xffffffffu, v, k);
    polarity_combine(sums, comb);
    const size_t q = (size_t)w * n_chan + c;
#pragma unroll
    for (int k = 0; k < 6; ++k)
      if (lane == k) out[q * 6 + k] = comb[k];
  }
}

template <typename T, bool kClock>
__global__ void __launch_bounds__(kBlockThreads) __cluster_dims__(4, 1, 1)
track_chunk_kernel(const T* __restrict__ raw, const float* __restrict__ time_idc,
                   const float* __restrict__ table, const float* __restrict__ stf_in,
                   const int* __restrict__ sti_in, const float* __restrict__ ring_in,
                   float* __restrict__ stf_out, int* __restrict__ sti_out,
                   float* __restrict__ ring_out, float* __restrict__ logf,
                   int* __restrict__ logi, int n_samp, int n_steps, int depth, int bulk,
                   TrackParams p, long long* __restrict__ clk) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_red[2][kWarps][kSums];    // per-warp partials, by step parity
  __shared__ __align__(8) uint64_t s_full[kRingMax];
  __shared__ float s_rz[kSnrN], s_rv[kSnrN];
  __shared__ Pub s_pub;
  const int c = blockIdx.x / kCluster;
  const int n_chan = gridDim.x / kCluster;
  const int rank = cluster_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool service = warp == kBlockWarps;
  const bool logger = service && rank == 0 && lane == 0;
  const int own = reduce_owner<kSums>(lane);
  const Smem m = carve<T>(smem, n_samp, depth);
  block_setup(m, time_idc, table + (size_t)c * kCode, n_samp, s_full, depth);

  Phases ph;
  CarrierLoop carr;
  CodeLoop code;
  Monitor mo;
  load_carry(c, logger, stf_in, sti_in, ring_in, ph, carr, code, mo, s_rz, s_rv);

  const size_t step_len = (size_t)2 * n_samp;          // elements of T
  const size_t log_f_step = (size_t)kLogF * n_chan;
  const size_t log_i_step = (size_t)kLogI * n_chan;
  if (service)
    for (int k = 0; k < depth && k < n_steps; ++k)
      stage_window(m.ring + (size_t)k * m.slot_bytes, raw + (size_t)k * step_len,
                   m.win_bytes, &s_full[k], bulk != 0, lane);

  long long c_wait = 0, c_corr = 0, c_bar = 0, c_on = 0, c_tail = 0, t_begin = 0;
  if (kClock) t_begin = clock64();
  int slot = 0;
  uint32_t parity = 0;
  for (int k = 0; k < n_steps; ++k) {
    float (*red)[kSums] = s_red[k & 1];
    long long t0 = 0, t1 = 0, t2 = 0, t3 = 0;
    float sums[kSums];
    if (!service) {
      if (kClock) t0 = clock64();
      mbar_wait(&s_full[slot], parity);
      if (kClock) t1 = clock64();
      correlate_partial(reinterpret_cast<const T*>(m.ring + (size_t)slot * m.slot_bytes),
                        m.time, m.code, n_samp, p.fs, ph.rc, ph.dfc, ph.ri, ph.fi,
                        rank * kBlockCorr + (int)threadIdx.x, own, red);
      if (kClock) t2 = clock64();
    }
    // Barrier 1: the partials are complete and the slot is free.
    channel_sync();
    if (kClock) t3 = clock64();
    if (warp == 0) {            // the carrier loop
      float comb[6], dpi;
      all_sums(red, lane, sums);
      polarity_combine(sums, comb);
      const float di = carrier_step(carr, comb, p, dpi);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < 6; ++i) s_pub.comb[i] = comb[i];
        s_pub.dpi = dpi;
        s_pub.di = di;
      }
    } else if (warp == 1) {     // the code loop
      float comb[6], dpc;
      all_sums(red, lane, sums);
      polarity_combine(sums, comb);
      const float dc = code_step(code, comb, p, dpc);
      if (lane == 0) {
        s_pub.dpc = dpc;
        s_pub.dc = dc;
      }
    } else if (warp == 2) {     // the time update, with the pre-update rates
      if (lane == 0) {
        s_pub.rc_new = floor_mod(ph.rc + ph.dfc * p.t_up, kLca);
        s_pub.ri_new = floor_mod(ph.ri + ph.fi * p.t_up, 1.0f);
      }
    } else if (service) {       // refill the freed slot; keep the sums
      if (k + depth < n_steps)
        stage_window(m.ring + (size_t)slot * m.slot_bytes,
                     raw + (size_t)(k + depth) * step_len, m.win_bytes, &s_full[slot],
                     bulk != 0, lane);
      if (rank == 0) all_sums(red, lane, sums);
    }
    if (kClock && service) c_tail += clock64() - t3;
    // Barrier 2 (the block's own): the new phases are published. The
    // correlating warps go on to the next window at once.
    block_sync();
    if (logger) {
      // Meanwhile: lock detector, C/N0 meter, prompt carry, signs, log row.
      if (kClock) t0 = clock64();
      const Pub pub = s_pub;
      monitor_and_log(ph, mo, sums, pub, p, s_rz, s_rv, logf + k * log_f_step + c,
                      logi + k * log_i_step + c, n_chan);
      advance(ph, pub, p);
      if (kClock) c_tail += clock64() - t0;
    } else {
      advance(ph, s_pub, p);
    }
    if (kClock && !service) {
      c_wait += t1 - t0; c_corr += t2 - t1; c_bar += t3 - t2;
      c_on += clock64() - t3;
    }
    if (++slot == depth) {
      slot = 0;
      parity ^= 1u;
    }
  }

  store_carry(c, rank, warp, lane, logger, ph, carr, code, mo, s_rz, s_rv, stf_out,
              sti_out, ring_out);
  if (kClock && logger) clk[(size_t)c * kClocks + 4] = c_tail;
  if (kClock && rank == 0 && threadIdx.x == 0) {
    long long* o = clk + (size_t)c * kClocks;
    o[0] = c_wait; o[1] = c_corr; o[2] = c_bar; o[3] = c_on;
    o[5] = clock64() - t_begin;
  }
  channel_sync();   // no block leaves while a peer may write to it
}

// ---- the second K4 kernel: coherent windows and the batch_k schedule -------
//
// One correlation pass covers kbp windows of n samples (kbp = 1 for a
// coherent window; for batch_k, up to kMaxPass 1 ms windows of a batch
// together: WinLayout). Each window has m + 2 segments (m code periods and
// the partial ones at both ends) of 6 sums (tap E, P, L x re/im); the
// pass's segments are numbered window by window. A window is taken by wpw
// warps of the channel's kWinWarps; warp c of a window takes the contiguous
// chunk of 32 R samples [c 32 R, (c + 1) 32 R), lane i its samples
// c 32 R + i + 32 r, r = 0 .. R - 1, in order, kWinUnroll side by side. A
// segment is about one code period (~n / m samples) and a chunk at most
// n / wpw + 32 (wpw >= 20), so a warp meets at most two segments: it holds
// 12 sums, reduces them over the warp once, and leaves its partials for
// segments sb and sb + 1 in red[segment][warp] of every block of the
// cluster. (A warp whose samples
// reach a third segment, which no window of the tracker's shapes gives,
// takes them in a second round over its samples, two segments more.) After
// barrier 1 one thread of warps 0-2 a sum adds the partials of the warps
// whose chunks meet its segment, in warp order, into shared memory, where
// the tail warps and the logger read them. The plain version sums in this
// order (ops/track.py _window_order_sum with window_warps()).

// Boundary k of a window (between segments k - 1 and k): the sample index
// from which the code phase has passed k L_CA, b_k = (k L_CA - rc) fs / fc;
// +inf past the window's last boundary (k > m + 1), -inf before the first.
__device__ __forceinline__ float seg_bound(int k, int m, float rc, float ratio) {
  if (k <= 0) return -INFINITY;
  if (k > m + 1) return INFINITY;
  return ((float)k * kLca - rc) * ratio;
}

// The first sample index of segment k in a window of n samples: the least s
// with (float)s >= b_k (0 for k = 0, n past the last boundary).
__device__ __forceinline__ int seg_first(int k, int m, float rc, float ratio, int n) {
  const float b = seg_bound(k, m, rc, ratio);
  if (b <= 0.0f) return 0;
  if (b >= (float)n) return n;
  return (int)ceilf(b);
}

// What a launch of the window kernel correlates, from the host.
struct WinLayout {
  int n;          // samples a window (m code periods)
  int kbp;        // windows a pass
  int wpw;        // warps a window
  int r;          // samples a lane of a window's warp
  int share;      // samples a block stages per pass, at most (kWinBlockWarps 32 r)
  int depth;      // passes in the ring
  int bulk;       // one bulk copy a pass (else 4-byte copies)
};

// Index of sum (tap, segment, re/im) among a window's 6 (m + 2).
__device__ __forceinline__ constexpr int sum_index(int tap, int seg, int q) {
  return seg * 6 + tap * 2 + q;
}

// One warp's chunk: `win`/`time` point at the chunk's first sample in the
// block's ring slot and time table, n_loc samples of which lie in the window,
// the first at window index s_first. The 12 sums of segments sb, sb + 1 are
// reduced over the warp; the owning lanes leave them in
// red[(seg0 + segment) kWinWarps + gw][6] of every block of the cluster.
template <typename T>
__device__ __forceinline__ void correlate_chunk(
    const T* win, const float* time, int n_loc, int s_first, int r_lane,
    const float* s_code, float fs, float rc, float dfc, float ri, float fi,
    float half_win, int m, int lane, int seg0, int gw, float* red) {
  const float rc_mid = rc + dfc * half_win;
  const float ph_e = rc_mid + 0.5f;
  const float ph_l = rc_mid - 0.5f;
  const float ratio = fs / (kFca + dfc);
  const int own = reduce_owner<12>(lane);
  int sb = 0;                       // segment of the chunk's first sample
  for (int k = 1; k <= m + 1; ++k) sb += (int)((float)s_first >= seg_bound(k, m, rc, ratio));
  for (;;) {
    const float b_lo = seg_bound(sb, m, rc, ratio);
    const float b_1 = seg_bound(sb + 1, m, rc, ratio);
    const float b_hi = seg_bound(sb + 2, m, rc, ratio);
    float acc[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) acc[i] = 0.0f;
    bool more = false;
    for (int r0 = 0; r0 < r_lane; r0 += kWinUnroll) {
      float bre[kWinUnroll], bim[kWinUnroll], e[kWinUnroll], p[kWinUnroll], l[kWinUnroll];
      int j[kWinUnroll];
#pragma unroll
      for (int u = 0; u < kWinUnroll; ++u) {
        j[u] = lane + 32 * (r0 + u);
        const int jj = min(j[u], n_loc - 1);
        const float t = time[jj];
        float re, im;
        load_iq(win, jj, re, im);
        const float ang = kTwoPi * (fi * t + ri);
        float wc, ws;
        sincosf(ang, &ws, &wc);
        bre[u] = re * wc + im * ws;
        bim[u] = im * wc - re * ws;
        const float base = t * kFca;
        e[u] = s_code[chip_index(base + ph_e)];
        p[u] = s_code[chip_index(base + rc_mid)];
        l[u] = s_code[chip_index(base + ph_l)];
      }
#define NAVLAB_ACC(SLOT)                                    \
  {                                                         \
    acc[(SLOT) * 6 + 0] += e[u] * bre[u];                   \
    acc[(SLOT) * 6 + 1] += e[u] * bim[u];                   \
    acc[(SLOT) * 6 + 2] += p[u] * bre[u];                   \
    acc[(SLOT) * 6 + 3] += p[u] * bim[u];                   \
    acc[(SLOT) * 6 + 4] += l[u] * bre[u];                   \
    acc[(SLOT) * 6 + 5] += l[u] * bim[u];                   \
  }
#pragma unroll
      for (int u = 0; u < kWinUnroll; ++u) {
        if (r0 + u >= r_lane || j[u] >= n_loc) break;
        const float k = (float)(s_first + j[u]);
        if (k < b_lo) continue;     // taken in an earlier round
        if (k >= b_hi) {            // for the next round
          more = true;
          continue;
        }
        if (k >= b_1) NAVLAB_ACC(1)
        else NAVLAB_ACC(0)
      }
#undef NAVLAB_ACC
    }
    halve<12>(acc, 16, lane);
    halve<6>(acc, 8, lane);
    halve<3>(acc, 4, lane);
    halve<2>(acc, 2, lane);
    halve<1>(acc, 1, lane);
    if (own >= 0) {
      const int seg = sb + own / 6;
      if (seg <= m + 1) {
        float* mine = red + ((size_t)(seg0 + seg) * kWinWarps + gw) * 6 + own % 6;
        for (int rk = 0; rk < kWinCluster; ++rk) store_to_rank(mine, rk, acc[0]);
      }
    }
    if (!__any_sync(0xffffffffu, more)) break;
    sb += 2;
  }
}

// The window's correlation phases: a batch's window wb correlates at the
// phases predicted from the batch start (rc0, ri0) and its frozen rates.
struct WinPhase {
  float rc, ri;
};

__device__ __forceinline__ WinPhase window_phase(int kb, int wb, float rc0, float ri0,
                                                 float dfc_c, float fi_c, float t_up) {
  if (kb == 1) return {rc0, ri0};
  return {floor_mod(rc0 + (dfc_c * t_up) * (float)wb, kLca),
          floor_mod(ri0 + (fi_c * t_up) * (float)wb, 1.0f)};
}

// After barrier 1, one thread a sum: pass sum i (segment i / 6) added over
// the warps whose chunks meet its segment, in warp order (0 where none); the
// partials are loaded eight at a time ahead of their adds.
__device__ __forceinline__ float finish_sum_w(const float* red, const WinLayout& L, int m,
                                              int kb, int b0, float rc0, float ri0,
                                              float dfc_c, float fi_c, const TrackParams& p,
                                              int i) {
  const int n_seg = m + 2;
  const int chunk = 32 * L.r;
  const int j = i / 6, wi = j / n_seg, jj = j - wi * n_seg;
  const float ratio = p.fs / (kFca + dfc_c);
  const WinPhase w = window_phase(kb, b0 + wi, rc0, ri0, dfc_c, fi_c, p.t_up);
  const int s_lo = seg_first(jj, m, w.rc, ratio, L.n);
  const int s_hi = seg_first(jj + 1, m, w.rc, ratio, L.n);
  if (s_lo >= s_hi) return 0.0f;
  const float* col = red + ((size_t)j * kWinWarps + wi * L.wpw) * 6 + (i - 6 * j);
  const int c_lo = s_lo / chunk, c_n = (s_hi - 1) / chunk - c_lo + 1;
  float acc = col[c_lo * 6];
  for (int c0 = 1; c0 < c_n; c0 += 8) {
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {   // loads past the segment's warps stay in shared memory
      const float y = col[(c_lo + c0 + u) * 6];
      x[u] = c0 + u < c_n ? y : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (c0 + u < c_n) acc += x[u];
  }
  return acc;
}

// Nav-bit polarity of a window of M code periods from its 6 (M + 2) sums
// `ws` (shared memory): M = 1 the decision tree, M > 1 the flip-location
// hypothesis test (ops/tracking.py _polarity_combine): hypothesis j flips
// segments k >= j; the combined sum under j >= 1 is 2 cum_{j-1} - tot; the
// first of the largest |.|^2 wins. comb = e_r, p_r, l_r as (re, im).
template <int M>
__device__ __forceinline__ void combine_window(const float* ws, float comb[6]) {
  constexpr int N = M + 2;
  float x[6 * N];
#pragma unroll
  for (int i = 0; i < 6 * N; ++i) x[i] = ws[i];
  float tr[N], ti[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    tr[j] = x[sum_index(0, j, 0)] + x[sum_index(1, j, 0)] + x[sum_index(2, j, 0)];
    ti[j] = x[sum_index(0, j, 1)] + x[sum_index(1, j, 1)] + x[sum_index(2, j, 1)];
  }
  if constexpr (M == 1) {
    float ar = tr[0] + tr[1], ai = ti[0] + ti[1], br = tr[0] - tr[1], bi = ti[0] - ti[1];
    const bool flip01 = (ar * ar + ai * ai) < (br * br + bi * bi);
    ar = tr[1] + tr[2]; ai = ti[1] + ti[2]; br = tr[1] - tr[2]; bi = ti[1] - ti[2];
    const bool flip12 = (ar * ar + ai * ai) < (br * br + bi * bi);
    const float g1 = flip01 ? -1.0f : 1.0f;
    const float g2 = flip01 ? -1.0f : (flip12 ? -1.0f : 1.0f);
#pragma unroll
    for (int tap = 0; tap < 3; ++tap)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float a = x[sum_index(tap, 0, q)];
        a = a + g1 * x[sum_index(tap, 1, q)];
        a = a + g2 * x[sum_index(tap, 2, q)];
        comb[tap * 2 + q] = a;
      }
  } else {
    float tot_r = tr[0], tot_i = ti[0];
#pragma unroll
    for (int j = 1; j < N; ++j) {
      tot_r = tot_r + tr[j];
      tot_i = tot_i + ti[j];
    }
    float best = tot_r * tot_r + tot_i * tot_i;
    int jstar = 0;
    float cum_r = tr[0], cum_i = ti[0];
#pragma unroll
    for (int j = 1; j < N; ++j) {
      const float cr = 2.0f * cum_r - tot_r;
      const float ci = 2.0f * cum_i - tot_i;
      const float cand = cr * cr + ci * ci;
      if (cand > best) {
        best = cand;
        jstar = j;
      }
      cum_r = cum_r + tr[j];
      cum_i = cum_i + ti[j];
    }
#pragma unroll
    for (int tap = 0; tap < 3; ++tap)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float a = x[sum_index(tap, 0, q)];
#pragma unroll
        for (int k = 1; k < N; ++k) {
          const float g = (jstar == 0 || k < jstar) ? 1.0f : -1.0f;
          a = a + g * x[sum_index(tap, k, q)];
        }
        comb[tap * 2 + q] = a;
      }
  }
}

__device__ __forceinline__ void combine_window(const float* ws, int m, float comb[6]) {
  switch (m) {
    case 1: combine_window<1>(ws, comb); break;
    case 2: combine_window<2>(ws, comb); break;
    case 3: combine_window<3>(ws, comb); break;
    case 4: combine_window<4>(ws, comb); break;
    case 5: combine_window<5>(ws, comb); break;
    case 6: combine_window<6>(ws, comb); break;
    case 7: combine_window<7>(ws, comb); break;
    case 8: combine_window<8>(ws, comb); break;
    case 9: combine_window<9>(ws, comb); break;
    default: combine_window<kMaxM>(ws, comb); break;
  }
}

// The C/N0 meter's two 20-sample rings, oldest first, across the lanes of
// the logging warp: lane i < 20 holds entry i of each.
struct Rings {
  float z, v;
};

// The mean of a ring as it stands after window w's value (lane w computes
// window w's): its entries w + 1 .. 19 from the lanes that hold them, then
// the pass's values x[0 .. w], added oldest first as ring_mean adds them.
__device__ __forceinline__ float ring_mean_after(float r, const float x[kMaxPass], int w) {
  float s = 0.0f;
#pragma unroll
  for (int i = 1; i < kSnrN; ++i) {
    const float old = __shfl_sync(0xffffffffu, r, min(w + i, kSnrN - 1));
    s = w + i < kSnrN ? s + old : s;
  }
#pragma unroll
  for (int k = 0; k < kMaxPass; ++k) s = k <= w ? s + x[k] : s;
  return s / (float)kSnrN;
}

// A ring after the pass's kbp values x: lane i < 20 takes entry i + kbp of
// the old ring, or x[i + kbp - 20].
__device__ __forceinline__ float ring_after(float r, const float x[kMaxPass], int kbp,
                                            int lane) {
  const int i = lane + kbp;
  const float old = __shfl_sync(0xffffffffu, r, min(i, kSnrN - 1));
  float y = old;
#pragma unroll
  for (int k = 0; k < kMaxPass; ++k) y = i - kSnrN == k ? x[k] : y;
  return y;
}

// The off-path tail of a pass, on the service warp of the cluster's first
// block: each window's prompt carry and m + 1 signs, lock detector, C/N0
// meter (monitor_and_log's arithmetic) and log row of log_f_rows(m)
// floats (15 + m, and at m > 1 the 2 (m + 2) prompt segment sums). The
// chained state (lock detector and its counters, prompt carry, cp, the
// rates before each update) runs through the pass's windows in every lane
// alike; lane w < kbp keeps window w's values, takes window w's two C/N0
// ring sums (the rings across the warp's lanes, Rings) and writes its row.
// Window w was correlated at its predicted rc / ri with the rate dfc_c (ncp
// from them); its row logs those and the state's fc/fi before its update.
// `logf`/`logi` point at the pass's first row.
__device__ __forceinline__ void monitor_pass(
    const Phases& ph, int kb, int b0, float rc0, float ri0, float dfc_c, float fi_c,
    int kbp, int m, Monitor& mo, Rings& rg, const float* s_sums, const Pub* s_pub,
    const TrackParams& p, float* logf, int* logi, size_t log_f_step, size_t log_i_step,
    int n_chan, int lane) {
  const int n_seg = m + 2;
  const WinPhase wp = window_phase(kb, b0 + (lane < kbp ? lane : 0), rc0, ri0, dfc_c,
                                   fi_c, p.t_up);
  const int ncp_me = (int)floorf((p.win_s * (kFca + dfc_c) + wp.rc) * p.inv_lca);
  float dfc = ph.dfc, fi = ph.fi;          // the rates before each update
  float z[kMaxPass];
  float my_fc = 0.0f, my_fi = 0.0f, my_lockval = 0.0f, my_sign0 = 0.0f;
  int my_cp = 0, my_lock = 0;
#pragma unroll
  for (int k = 0; k < kMaxPass; ++k) {
    const int ncp = __shfl_sync(0xffffffffu, ncp_me, k);
    z[k] = 0.0f;
    if (k >= kbp) continue;
    const Pub& pub = s_pub[k];
    const float* ws = s_sums + k * n_seg * 6;
    const float ip = pub.comb[2], qp = pub.comb[3];
    const float li = p.lpf * fabsf(ip) + p.one_m_lpf * mo.lock_i;
    const float lq = p.lpf * fabsf(qp) + p.one_m_lpf * mo.lock_q;
    const bool in_lock = (li / kLockK) > lq;
    const int lock = (in_lock && mo.lockcount > p.lock_th)
                         ? 1
                         : ((!in_lock && mo.losscount > p.loss_th) ? 0 : mo.lock);
    // the prompt carry: the sum over segments j of [ncp == j] P_j (with the
    // carry at j = 0) in segment order is the one nonzero term plus zeros,
    // that is the term + 0 (which turns -0 into +0, as the zeros do)
    float pa[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float carry = q == 0 ? mo.p_a_re : mo.p_a_im;
      const float term = ncp == 0 ? carry + ws[sum_index(1, 0, q)]
                         : (ncp > 0 && ncp < n_seg ? ws[sum_index(1, ncp, q)] : 0.0f);
      pa[q] = term + 0.0f;
    }
    z[k] = ip * ip + qp * qp;
    if (k == lane) {
      my_fc = kFca + dfc;
      my_fi = fi;
      my_lockval = li / kLockK - lq;
      my_sign0 = -sign_of(mo.p_a_re + ws[sum_index(1, 0, 0)]);
      my_cp = mo.cp;
      my_lock = lock;
    }
    mo.losscount = in_lock ? 0 : mo.losscount + 1;
    mo.lockcount = in_lock ? mo.lockcount + 1 : 0;
    mo.lock_i = li;
    mo.lock_q = lq;
    mo.lock = lock;
    mo.snr_fill += 1;
    mo.cp += ncp;
    mo.p_a_re = pa[0];
    mo.p_a_im = pa[1];
    fi = ph.fi_bias + pub.di;
    dfc = ph.dfc_bias + pub.dc + p.fcaid * (ph.fi_bias + pub.di);
  }
  // the C/N0 meter, window w in lane w
  const int w = lane < kbp ? lane : 0;
  float my_z = z[0];
#pragma unroll
  for (int k = 1; k < kMaxPass; ++k)
    if (k == w) my_z = z[k];
  const float z_mean = ring_mean_after(rg.z, z, w);
  float v = my_z - z_mean;
  v = v * v;
  float vs[kMaxPass];
#pragma unroll
  for (int k = 0; k < kMaxPass; ++k) vs[k] = __shfl_sync(0xffffffffu, v, k);
  const float z_var = ring_mean_after(rg.v, vs, w);
  if (lane < kbp) {
    const float carrier = sqrtf(fmaxf(z_mean * z_mean - z_var, 0.0f));
    const float noise_var = fmaxf((z_mean - carrier) / 2.0f, 1e-12f);
    const float logarg = fmaxf(carrier / (p.snr_den * noise_var), 1.0f);
    const Pub& pub = s_pub[lane];
    const float* ws = s_sums + lane * n_seg * 6;
    float* lf = logf + (size_t)lane * log_f_step;
    int* lo = logi + (size_t)lane * log_i_step;
    const float row[14] = {pub.comb[0], pub.comb[1], pub.comb[2], pub.comb[3],
                           pub.comb[4], pub.comb[5], wp.rc, wp.ri, my_fc, my_fi,
                           my_lockval, 10.0f * log10f(logarg), pub.dpc, pub.dpi};
#pragma unroll
    for (int f = 0; f < 14; ++f) lf[f * n_chan] = row[f];
    lf[14 * n_chan] = my_sign0;
#pragma unroll
    for (int j = 1; j < kMaxSeg - 1; ++j)
      if (j < n_seg - 1) lf[(14 + j) * n_chan] = -sign_of(ws[sum_index(1, j, 0)]);
    if (m > 1) {
#pragma unroll
      for (int j = 0; j < kMaxSeg; ++j)
        if (j < n_seg) {
          lf[(15 + m + 2 * j) * n_chan] = ws[sum_index(1, j, 0)];
          lf[(16 + m + 2 * j) * n_chan] = ws[sum_index(1, j, 1)];
        }
    }
    lo[0] = my_cp;
    lo[n_chan] = ncp_me;
    lo[2 * n_chan] = my_lock;
  }
  // the rings after the pass: entries kbp .. 19, then the pass's values
  const float nz = ring_after(rg.z, z, kbp, lane);
  const float nv = ring_after(rg.v, vs, kbp, lane);
  rg = {nz, nv};
}

// K4 over windows of p.m code periods (p.batch_k == 1), or over 1 ms windows
// in batches of p.batch_k (p.m == 1), L.kbp windows a correlation pass. The
// structure is track_chunk_kernel's (a cluster per channel, a ring filled
// by the service warp, barrier 1, the on-path tail shared by warps 0-2,
// barrier 2, the off-path tail on the service warp), with a cluster of
// kWinCluster blocks; a block stages and times only the samples its warps
// take (at most L.share a pass). After barrier 1 warps 0 and 1 run the
// pass's windows' loop updates back to back; the service warp logs them
// after barrier 2.
template <typename T, bool kClock>
__global__ void __launch_bounds__(kWinBlockThreads)
track_window_kernel(const T* __restrict__ raw, const float* __restrict__ time_idc,
                    const float* __restrict__ table, const float* __restrict__ stf_in,
                    const int* __restrict__ sti_in, const float* __restrict__ ring_in,
                    float* __restrict__ stf_out, int* __restrict__ sti_out,
                    float* __restrict__ ring_out, float* __restrict__ logf,
                    int* __restrict__ logi, int n_steps, WinLayout L, TrackParams p,
                    long long* __restrict__ clk) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t s_full[kRingMax];
  __shared__ float s_rz[kSnrN], s_rv[kSnrN];
  __shared__ Pub s_pub[kMaxPass];
  const int c = blockIdx.x / kWinCluster;
  const int n_chan = gridDim.x / kWinCluster;
  const int rank = cluster_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool service = warp == kWinBlockWarps;
  const bool logger = service && rank == 0 && lane == 0;
  const int m = p.m, kb = p.batch_k, n = L.n;
  const int n_seg = m + 2;
  const int chunk = 32 * L.r;
  const uint32_t slot_b = ((uint32_t)L.share * 2u * (uint32_t)sizeof(T) + 15u) & ~15u;
  unsigned char* ring = smem;
  float* s_red = reinterpret_cast<float*>(smem + (size_t)L.depth * slot_b);
  float* s_time = s_red + 2 * kMaxPassSeg * kWinWarps * 6;
  float* s_code = s_time + L.share;
  float* s_sums = s_code + kCode + 1;        // the pass's sums, after barrier 1

  // This warp's chunk (window wi of a pass, chunk ci of it) and this block's
  // share of a pass: samples [sh_lo, sh_hi) of the pass's windows laid end
  // to end, contiguous in raw.
  const int gw = rank * kWinBlockWarps + warp;
  const int wi = gw / L.wpw, ci = gw % L.wpw;
  const bool active = !service && wi < L.kbp && ci * chunk < n;
  const int n_loc = active ? min(chunk, n - ci * chunk) : 0;
  int sh_lo = 0, sh_hi = 0;
  for (int w = kWinBlockWarps - 1; w >= 0; --w) {   // the block's first active warp
    const int g = rank * kWinBlockWarps + w;
    if (g / L.wpw < L.kbp && (g % L.wpw) * chunk < n) sh_lo = (g / L.wpw) * n + (g % L.wpw) * chunk;
  }
  for (int w = 0; w < kWinBlockWarps; ++w) {         // ... and its last
    const int g = rank * kWinBlockWarps + w;
    if (g / L.wpw < L.kbp && (g % L.wpw) * chunk < n)
      sh_hi = (g / L.wpw) * n + min((g % L.wpw + 1) * chunk, n);
  }
  const int j_chunk = wi * n + ci * chunk - sh_lo;   // the chunk's first sample in the share

  for (int i = threadIdx.x; i < sh_hi - sh_lo; i += blockDim.x)
    s_time[i] = time_idc[(sh_lo + i) % n];
  for (int i = threadIdx.x; i < kCode; i += blockDim.x) s_code[i] = table[(size_t)c * kCode + i];
  if (threadIdx.x == 0) {
    for (int d = 0; d < L.depth; ++d) mbar_init(&s_full[d], 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  block_sync();
  channel_sync();

  Phases ph;
  CarrierLoop carr;
  CodeLoop code;
  Monitor mo;
  // the monitor in every lane of the logging warp (monitor_pass runs in
  // each); the C/N0 rings, loaded into shared memory alike by all of them,
  // then one entry a lane (Rings)
  const bool logging = service && rank == 0;
  load_carry(c, logging, stf_in, sti_in, ring_in, ph, carr, code, mo, s_rz, s_rv);
  Rings rg = {0.0f, 0.0f};
  if (logging) {
    __syncwarp();
    if (lane < kSnrN) rg = {s_rz[lane], s_rv[lane]};
  }

  const int n_pass = n_steps / L.kbp;
  const size_t pass_len = (size_t)2 * L.kbp * n;     // elements of T
  const uint32_t share_bytes = (uint32_t)(sh_hi - sh_lo) * 2u * (uint32_t)sizeof(T);
  const int n_log_f = log_f_rows(m);
  const size_t log_f_step = (size_t)n_log_f * n_chan;
  const size_t log_i_step = (size_t)kLogI * n_chan;
  if (service && share_bytes > 0)
    for (int q = 0; q < L.depth && q < n_pass; ++q)
      stage_window(ring + (size_t)q * slot_b, raw + (size_t)q * pass_len + 2 * (size_t)sh_lo,
                   share_bytes, &s_full[q], L.bulk != 0, lane);

  // the batch start: the phases and frozen rates its windows correlate at
  float rc0 = ph.rc, ri0 = ph.ri, dfc_c = ph.dfc, fi_c = ph.fi;
  long long c_wait = 0, c_corr = 0, c_bar = 0, c_on = 0, c_tail = 0, t_begin = 0;
  if (kClock) t_begin = clock64();
  int slot = 0;
  uint32_t parity = 0;
  for (int q = 0; q < n_pass; ++q) {
    float* red = s_red + (size_t)(q & 1) * kMaxPassSeg * kWinWarps * 6;
    const int b0 = (q * L.kbp) % kb;        // the pass's first window in its batch
    if (b0 == 0) {
      rc0 = ph.rc; ri0 = ph.ri; dfc_c = ph.dfc; fi_c = ph.fi;
    }
    long long t0 = 0, t1 = 0, t2 = 0, t3 = 0;
    if (active) {
      const WinPhase w = window_phase(kb, b0 + wi, rc0, ri0, dfc_c, fi_c, p.t_up);
      if (kClock) t0 = clock64();
      mbar_wait(&s_full[slot], parity);
      if (kClock) t1 = clock64();
      const T* win = reinterpret_cast<const T*>(ring + (size_t)slot * slot_b) + 2 * j_chunk;
      correlate_chunk<T>(win, s_time + j_chunk, n_loc, ci * chunk, L.r, s_code, p.fs, w.rc,
                         dfc_c, w.ri, fi_c, p.half_win, m, lane, wi * n_seg, gw, red);
      if (kClock) t2 = clock64();
    } else if (kClock && !service) {
      t0 = t1 = t2 = clock64();
    }
    // Barrier 1: the partials are complete and the pass's slot is free.
    channel_sync();
    if (kClock) t3 = clock64();
    if (warp < 3) {                   // the pass's sums, a thread each
      if ((int)threadIdx.x < L.kbp * n_seg * 6)
        s_sums[threadIdx.x] = finish_sum_w(red, L, m, kb, b0, rc0, ri0, dfc_c, fi_c, p,
                                           threadIdx.x);
      asm volatile("bar.sync 1, 96;" ::: "memory");   // warps 0-2
    }
    if (warp == 0 || warp == 1) {     // the carrier loop, the code loop
      // lane w < kbp: window w's polarity combine (the windows' are
      // independent); then the loop updates, window after window
      float own[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (lane < L.kbp) combine_window(s_sums + lane * n_seg * 6, m, own);
      for (int w = 0; w < L.kbp; ++w) {
        float comb[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) comb[i] = __shfl_sync(0xffffffffu, own[i], w);
        if (warp == 0) {
          float dpi;
          const float di = carrier_step(carr, comb, p, dpi);
          if (lane == 0) {
#pragma unroll
            for (int i = 0; i < 6; ++i) s_pub[w].comb[i] = comb[i];
            s_pub[w].dpi = dpi;
            s_pub[w].di = di;
          }
        } else {
          float dpc;
          const float dc = code_step(code, comb, p, dpc);
          if (lane == 0) {
            s_pub[w].dpc = dpc;
            s_pub[w].dc = dc;
          }
        }
      }
    } else if (warp == 2) {           // the time update, after the pass's last window
      if (lane == 0) {
        Pub& last = s_pub[L.kbp - 1];
        if (kb == 1) {                // with the pre-update rates
          last.rc_new = floor_mod(ph.rc + ph.dfc * p.t_up, kLca);
          last.ri_new = floor_mod(ph.ri + ph.fi * p.t_up, 1.0f);
        } else if (b0 + L.kbp == kb) {   // the batch's frozen-rate carry
          const WinPhase w = window_phase(kb, kb - 1, rc0, ri0, dfc_c, fi_c, p.t_up);
          last.rc_new = floor_mod(w.rc + dfc_c * p.t_up, kLca);
          last.ri_new = floor_mod(w.ri + fi_c * p.t_up, 1.0f);
        } else {
          last.rc_new = ph.rc;
          last.ri_new = ph.ri;
        }
      }
    } else if (service && share_bytes > 0 && q + L.depth < n_pass) {   // refill the slot
      stage_window(ring + (size_t)slot * slot_b,
                   raw + (size_t)(q + L.depth) * pass_len + 2 * (size_t)sh_lo, share_bytes,
                   &s_full[slot], L.bulk != 0, lane);
    }
    if (kClock && service) c_tail += clock64() - t3;
    // Barrier 2 (the block's own): the new phases are published. The
    // correlating warps go on to the next pass at once.
    block_sync();
    if (logging) {
      // Meanwhile: lock detector, C/N0 meter, prompt carry, signs, log rows.
      if (kClock) t0 = clock64();
      const size_t k0 = (size_t)q * L.kbp;
      monitor_pass(ph, kb, b0, rc0, ri0, dfc_c, fi_c, L.kbp, m, mo, rg, s_sums, s_pub, p,
                   logf + k0 * log_f_step + c, logi + k0 * log_i_step + c, log_f_step,
                   log_i_step, n_chan, lane);
      advance(ph, s_pub[L.kbp - 1], p);
      if (kClock) c_tail += clock64() - t0;
    } else {
      advance(ph, s_pub[L.kbp - 1], p);
    }
    if (kClock && !service) {
      c_wait += t1 - t0; c_corr += t2 - t1; c_bar += t3 - t2;
      c_on += clock64() - t3;
    }
    if (++slot == L.depth) {
      slot = 0;
      parity ^= 1u;
    }
  }

  if (logging) {                    // the rings back, oldest first at 0
    if (lane < kSnrN) {
      s_rz[lane] = rg.z;
      s_rv[lane] = rg.v;
    }
    __syncwarp();
    mo.head = 0;
  }
  store_carry(c, rank, warp, lane, logger, ph, carr, code, mo, s_rz, s_rv, stf_out,
              sti_out, ring_out);
  if (kClock && logger) clk[(size_t)c * kClocks + 4] = c_tail;
  if (kClock && rank == 0 && threadIdx.x == 0) {
    long long* o = clk + (size_t)c * kClocks;
    o[0] = c_wait; o[1] = c_corr; o[2] = c_bar; o[3] = c_on;
    o[5] = clock64() - t_begin;
  }
  channel_sync();   // no block leaves while a peer may write to it
}

size_t slot_bytes(int n_samp, int raw_i16) {
  const size_t win = (size_t)n_samp * 2 * (raw_i16 ? sizeof(int16_t) : sizeof(float));
  return (win + 15) & ~(size_t)15;
}

size_t table_bytes(int n_samp) { return ((size_t)n_samp + kCode + 1) * sizeof(float); }

// Ring slots that fit beside the tables (at most kRingMax; K4 needs two).
int ring_depth(int n_samp, int raw_i16) {
  if (n_samp <= 0 || table_bytes(n_samp) >= kSmemMax) return 0;
  const size_t fit = (kSmemMax - table_bytes(n_samp)) / slot_bytes(n_samp, raw_i16);
  return (int)(fit < (size_t)kRingMax ? fit : (size_t)kRingMax);
}

bool bulk_ok(const void* raw, int n_samp, int raw_i16) {
  const size_t win = (size_t)n_samp * 2 * (raw_i16 ? sizeof(int16_t) : sizeof(float));
  return win % 16 == 0 && (uintptr_t)raw % 16 == 0;
}

// More than 48 KB of shared memory (static and dynamic together) has to be
// asked for: once per kernel, and again only for a larger size. `allowed`
// is the kernel's own record of the most it was granted.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

template <typename T>
int launch_correlate(const void* raw, const float* time_idc, const float* table,
                     const float* phases, int n_chan, int n_samp, float fs, int bulk,
                     float* out, cudaStream_t s) {
  const size_t smem = slot_bytes(n_samp, sizeof(T) == 2) + table_bytes(n_samp);
  static size_t allowed = 0;       // per instantiation
  cudaError_t e = allow_smem(correlate_window_kernel<T>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  correlate_window_kernel<T><<<n_chan * kCluster, kBlockThreads, smem, s>>>(
      (const T*)raw, time_idc, table, phases, n_samp, fs, bulk, out);
  return (int)cudaGetLastError();
}

// Windows of a batch_k batch correlated together: the largest divisor of kb
// that fits a pass (ops/track.py window_pass).
int window_pass(int m, int kb) {
  for (int d = kMaxPass; d > 1; --d)
    if (kb % d == 0 && d * (m + 2) <= kMaxPassSeg) return d;
  return 1;
}

size_t window_fixed_bytes(const WinLayout& L) {
  return ((size_t)2 * kMaxPassSeg * kWinWarps * 6 + L.share + kCode + 1 + kPassSums) *
         sizeof(float);
}

// The window kernel's layout for windows of n samples (m code periods),
// batches of kb; depth 0 when not even one pass fits in shared memory.
WinLayout window_layout(int n, int m, int kb, int raw_i16) {
  WinLayout L{};
  L.n = n;
  L.kbp = window_pass(m, kb);
  L.wpw = kWinWarps / L.kbp;
  L.r = (n + 32 * L.wpw - 1) / (32 * L.wpw);
  L.share = kWinBlockWarps * 32 * L.r;
  const size_t slot = slot_bytes(L.share, raw_i16);
  const size_t fixed = window_fixed_bytes(L);
  const size_t fit = fixed < kSmemMaxW ? (kSmemMaxW - fixed) / slot : 0;
  L.depth = (int)(fit < (size_t)kRingMax ? fit : (size_t)kRingMax);
  return L;
}

template <typename T, bool kClock>
int launch_window(const void* raw, const float* time_idc, const float* table,
                  const float* stf_in, const int* sti_in, const float* ring_in,
                  float* stf_out, int* sti_out, float* ring_out, float* logf, int* logi,
                  int n_chan, int n_steps, const WinLayout& L, const TrackParams& p,
                  long long* clk, cudaStream_t s) {
  auto kernel = track_window_kernel<T, kClock>;
  const size_t smem = (size_t)L.depth * slot_bytes(L.share, sizeof(T) == 2) +
                      window_fixed_bytes(L);
  static size_t allowed = 0;       // per instantiation
  cudaError_t e = allow_smem(kernel, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_chan * kWinCluster));
  cfg.blockDim = dim3(kWinBlockThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kWinCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, (const T*)raw, time_idc, table, stf_in, sti_in,
                         ring_in, stf_out, sti_out, ring_out, logf, logi, n_steps, L, p, clk);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, bool kClock>
int launch_track(const void* raw, const float* time_idc, const float* table,
                 const float* stf_in, const int* sti_in, const float* ring_in,
                 float* stf_out, int* sti_out, float* ring_out, float* logf, int* logi,
                 int n_chan, int n_samp, int n_steps, int depth, int bulk,
                 const TrackParams& p, long long* clk, cudaStream_t s) {
  const size_t smem = (size_t)depth * slot_bytes(n_samp, sizeof(T) == 2) + table_bytes(n_samp);
  static size_t allowed = 0;       // per instantiation
  cudaError_t e = allow_smem(track_chunk_kernel<T, kClock>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  track_chunk_kernel<T, kClock><<<n_chan * kCluster, kBlockThreads, smem, s>>>(
      (const T*)raw, time_idc, table, stf_in, sti_in, ring_in, stf_out, sti_out,
      ring_out, logf, logi, n_samp, n_steps, depth, bulk, p, clk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest window (samples) the kernels take: two ring slots, the time table
// and one code row share the block's dynamic shared memory.
int track_max_samples(int raw_i16) {
  const size_t per = 2 * 2 * (raw_i16 ? sizeof(int16_t) : sizeof(float)) + sizeof(float);
  return (int)((kSmemMax - (kCode + 1) * sizeof(float) - 32) / per);
}

int track_params_size() { return (int)sizeof(TrackParams); }

// Correlating threads per channel: the plain sums follow this order
// (ops/track.py KERNEL_THREADS).
int track_threads() { return kLanes; }

// Thread blocks per channel (one cluster).
int track_cluster() { return kCluster; }

// Sample windows K4 keeps in flight for this window size.
int track_ring_depth(int n_samp, int raw_i16) { return ring_depth(n_samp, raw_i16); }

// Correlating threads per channel of the coherent/batched K4: its plain sums
// follow this order (ops/track.py WINDOW_LANES).
int track_window_lanes() { return kWinLanes; }

// Thread blocks per channel of the coherent/batched K4 (one cluster).
int track_window_cluster() { return kWinCluster; }

// Windows a correlation pass of the coherent/batched K4 holds (m > 1: one).
int track_window_pass(int m, int kb) { return window_pass(m, kb); }

// Passes in flight in the coherent/batched K4's ring for windows of n_samp
// samples of m code periods, batch_k kb (0: the window does not fit).
int track_window_depth(int n_samp, int m, int kb, int raw_i16) {
  if (n_samp <= 0 || m < 1 || kb < 1) return 0;
  return window_layout(n_samp, m, kb, raw_i16).depth;
}

// int64 words per channel that track_chunk_launch's `clk` receives: clock64()
// sums over the chunk for waiting on samples, correlate + warp reduce, the
// step barrier, the on-path update (thread 0), the service warp's staging
// and tail (its lane 0), and the whole step loop (thread 0).
int track_clock_words() { return kClocks; }

// K3: out [C, 18] (tap, seg, re/im) for one window raw [S, 2] (int16 when
// raw_i16, else f32; 4-byte aligned); phases [C, 4] = rc, dfc, ri, fi;
// table [C, 1023]. Enqueues on `stream`, allocates nothing; returns a
// cudaError.
int correlate_window_launch(const void* raw, int raw_i16, const float* time_idc,
                            const float* table, const float* phases, int n_chan,
                            int n_samp, float fs, float* out, void* stream) {
  if (n_chan <= 0 || n_chan > 2147483647 / kCluster || ring_depth(n_samp, raw_i16) < 1 ||
      (uintptr_t)raw % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int bulk = bulk_ok(raw, n_samp, raw_i16);
  return raw_i16 ? launch_correlate<int16_t>(raw, time_idc, table, phases, n_chan, n_samp,
                                             fs, bulk, out, s)
                 : launch_correlate<float>(raw, time_idc, table, phases, n_chan, n_samp,
                                           fs, bulk, out, s);
}

// Correlating threads per (window, channel) of K3's windows mode: its plain
// sums follow this order (ops/track.py WINDOWS_LANES).
int track_windows_lanes() { return kWinsLanes; }

// Largest window (samples) K3's windows mode takes on the current device:
// its code row, time table and window share the shared memory a block may
// opt in to. 0 if the device cannot be asked.
int track_windows_max_samples(int raw_i16) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  const size_t fixed = sizeof(float) * kWinsWarps * kSums + 1024 + (kCode + 2) * sizeof(float);
  if ((size_t)optin <= fixed) return 0;
  const size_t per = sizeof(float) + 2 * (raw_i16 ? sizeof(int16_t) : sizeof(float));
  return (int)(((size_t)optin - fixed) / per);
}

// K3's windows mode: out [n_win, C, 3, 2] (E, P, L combined over the nav-bit
// hypotheses) of raw [n_win, S, 2] (int16 when raw_i16, else f32; 4-byte
// aligned), one block per (window, channel). rc, dfc, ri, fi: the first
// window's phases, [C] each at element stride ph_stride (columns of one
// [C, 4] tensor, or four vectors). Enqueues on `stream`, allocates nothing;
// returns a cudaError.
int correlate_windows_launch(const void* raw, int raw_i16, const float* time_idc,
                             const float* table, const float* rc, const float* dfc,
                             const float* ri, const float* fi, int ph_stride, int n_chan,
                             int n_samp, int n_win, float fs, float* out, void* stream) {
  if (n_chan <= 0 || n_win <= 0 || n_samp <= 0 || ph_stride <= 0 ||
      n_samp > track_windows_max_samples(raw_i16) ||
      (long long)n_win * n_chan > 2147483647LL || (uintptr_t)raw % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)(n_win * n_chan);
  const size_t smem = windows_smem(n_samp, raw_i16);
  if (raw_i16) {
    static size_t allowed = 48 * 1024;
    cudaError_t e = allow_smem(correlate_windows_kernel<int16_t>, smem, allowed);
    if (e != cudaSuccess) return (int)e;
    correlate_windows_kernel<int16_t><<<blocks, kWinsLanes, smem, s>>>(
        (const int16_t*)raw, time_idc, table, rc, dfc, ri, fi, ph_stride, n_samp, n_chan,
        n_win, fs, out);
  } else {
    static size_t allowed = 48 * 1024;
    cudaError_t e = allow_smem(correlate_windows_kernel<float>, smem, allowed);
    if (e != cudaSuccess) return (int)e;
    correlate_windows_kernel<float><<<blocks, kWinsLanes, smem, s>>>(
        (const float*)raw, time_idc, table, rc, dfc, ri, fi, ph_stride, n_samp, n_chan,
        n_win, fs, out);
  }
  return (int)cudaGetLastError();
}

// K4: n_steps windows raw [steps, S, 2] of p.m code periods each; state
// in/out [C, 16] f32, [C, 5] int32, rings [C, 2, 20]; logs logf
// [steps, log_f_rows(p.m), C], logi [steps, 3, C]. p.m > 1 (coherent windows) or
// p.batch_k > 1 (the batch schedule, n_steps a multiple of it) run the
// second kernel. `clk`: null, or [C, track_clock_words()] int64 on the
// device (either kernel).
int track_chunk_launch(const void* raw, int raw_i16, const float* time_idc,
                       const float* table, const float* stf_in, const int* sti_in,
                       const float* ring_in, float* stf_out, int* sti_out,
                       float* ring_out, float* logf, int* logi, int n_chan,
                       int n_samp, int n_steps, TrackParams p, long long* clk,
                       void* stream) {
  if (p.m > 1 || p.batch_k > 1) {
    if (p.m < 1 || p.m > kMaxM || n_samp <= 0 || n_samp >= (1 << 24) ||
        n_samp % p.m != 0 || p.batch_k < 1 || (p.m > 1 && p.batch_k > 1) ||
        n_steps <= 0 || n_steps % p.batch_k != 0 || n_chan <= 0 ||
        n_chan > 65535 / kWinCluster || (uintptr_t)raw % 4 != 0)
      return (int)cudaErrorInvalidValue;
    WinLayout L = window_layout(n_samp, p.m, p.batch_k, raw_i16);
    if (L.depth < 1) return (int)cudaErrorInvalidValue;
    L.bulk = bulk_ok(raw, n_samp, raw_i16);
    cudaStream_t s = (cudaStream_t)stream;
#define NAVLAB_WINDOW_ARGS                                                         \
  raw, time_idc, table, stf_in, sti_in, ring_in, stf_out, sti_out, ring_out, logf, \
      logi, n_chan, n_steps, L, p, clk, s
    if (raw_i16)
      return clk ? launch_window<int16_t, true>(NAVLAB_WINDOW_ARGS)
                 : launch_window<int16_t, false>(NAVLAB_WINDOW_ARGS);
    return clk ? launch_window<float, true>(NAVLAB_WINDOW_ARGS)
               : launch_window<float, false>(NAVLAB_WINDOW_ARGS);
#undef NAVLAB_WINDOW_ARGS
  }
  const int depth = ring_depth(n_samp, raw_i16);
  if (n_chan <= 0 || n_chan > 65535 / kCluster || depth < 2 || n_steps <= 0 ||
      (uintptr_t)raw % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int bulk = bulk_ok(raw, n_samp, raw_i16);
#define NAVLAB_TRACK_ARGS                                                          \
  raw, time_idc, table, stf_in, sti_in, ring_in, stf_out, sti_out, ring_out, logf, \
      logi, n_chan, n_samp, n_steps, depth, bulk, p, clk, s
  if (raw_i16)
    return clk ? launch_track<int16_t, true>(NAVLAB_TRACK_ARGS)
               : launch_track<int16_t, false>(NAVLAB_TRACK_ARGS);
  return clk ? launch_track<float, true>(NAVLAB_TRACK_ARGS)
             : launch_track<float, false>(NAVLAB_TRACK_ARGS);
#undef NAVLAB_TRACK_ARGS
}

const char* track_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
