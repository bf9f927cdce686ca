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
// K3's windows mode (correlate_window_launch with n_win > 0) is the open-loop
// correlation of vector tracking (ops/tracking.py track_open_loop, which the
// JAX package runs as an XLA scan): one cluster per (window, channel), the
// window's phases from the f32 recurrence rc' = mod(rc + dfc T_MS, L_CA),
// ri' = mod(ri + fi T_MS, 1) iterated from the first window as the plain
// version iterates it, the 18 sums combined over the nav-bit hypotheses with
// a zero prompt carry in the kernel: [W, C, 3, 2] out of one launch.
//
// The second K4 kernel (track_window_kernel) runs the two schedules the JAX
// package computes in XLA (ops/tracking.py _track_chunk_jit at coh_ms > 1,
// track_chunk_batched):
// - coherent windows of m = 2..10 code periods: m + 2 segments, so 6m + 12
//   sums, taken as up to four groups of 18 (three segments each). A group's
//   samples are a contiguous range of the window, so each thread walks its
//   samples once per group, adds only those of the group, and the group's
//   18 sums go through the same warp reduction as K3's. The ring holds one
//   code period a slot (a window is m consecutive slots: at m = 10 a window
//   of int16 is 100 KB), refilled period by period after barrier 1; the
//   time table is read from global memory (100 KB at m = 10). The tail is
//   the m-scaled one: the single-flip hypothesis test over m + 2 segments,
//   m + 1 signs, lock thresholds and C/N0 denominator from TrackParams.
// - batch_k at m = 1: window w of a batch correlates at the phases
//   predicted from the batch-start rates, rc_w = mod(rc + (dfc T_MS) w,
//   L_CA), while the updates run per window as at m = 1; the batch closes
//   with the frozen-rate carry mod(rc_{k-1} + dfc T_MS, L_CA).
// The m = 1 schedule stays in track_chunk_kernel, untouched.
//
// Later: the partial sums handed over with remote mbarrier arrivals instead
// of the cluster barrier (~0.45 us of a ~2 us step); the batch_k windows
// correlated together rather than one step each.

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
constexpr int kMaxM = 10;      // code periods a coherent window holds, at most
constexpr int kMaxSeg = kMaxM + 2;
constexpr int kGroups = (kMaxSeg + 2) / 3;        // groups of three segments
constexpr int kMaxSums = kGroups * kSums;
constexpr int kSlotMax = 32;   // code periods the second K4 kernel's ring holds
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
// The second K4 kernel's dynamic shared memory: the static part is its
// partial sums by parity and group, barriers, rings, Pub.
constexpr size_t kSmemMaxW =
    232448 - (2 * kGroups * (kLanes / 32) * kSums * 4 + 8 * kSlotMax + 1024);

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

// After halve<18>, <9>, <5>, <3>, <2> (offsets 16 .. 1) a lane holds in v[0]
// the warp's total of one of the 18 sums: which one (or -1: none).
__device__ __forceinline__ int reduce_owner(int lane) {
  int n = kSums, width = kSums, base = 0;
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
// the ring slot `win` (samples g, g + kLanes, ...), reduced over its warp;
// the lane that ends up owning sum `own` leaves the warp's partial in
// `red[gwarp][own]` of every block of the channel. `g` is the thread's index
// among the channel's kLanes, `own` its reduce_owner.
template <typename T>
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
  for (int s0 = g; s0 < n_samp; s0 += kUnroll * kLanes) {
    float bre[kUnroll], bim[kUnroll], e[kUnroll], p[kUnroll], l[kUnroll];
    int seg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = min(s0 + u * kLanes, n_samp - 1);
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
      if (s0 + u * kLanes >= n_samp) break;
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
    for (int r = 0; r < kCluster; ++r) store_to_rank(mine, r, acc[0]);
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

template <typename T, bool kWin>
__global__ void __launch_bounds__(kBlockThreads) __cluster_dims__(4, 1, 1)
correlate_window_kernel(const T* __restrict__ raw, const float* __restrict__ time_idc,
                        const float* __restrict__ table, const float* __restrict__ phases,
                        int n_samp, int n_chan, float fs, int bulk, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_red[kWarps][kSums];
  __shared__ __align__(8) uint64_t s_full[1];
  const int q = blockIdx.x / kCluster;           // window * n_chan + channel
  const int c = kWin ? q % n_chan : q;
  const int w = kWin ? q / n_chan : 0;
  const int rank = cluster_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Smem m = carve<T>(smem, n_samp, 1);           // a ring of one slot
  block_setup(m, time_idc, table + (size_t)c * kCode, n_samp, s_full, 1);
  if (warp == kBlockWarps) {
    stage_window(m.ring, raw + (size_t)w * 2 * n_samp, m.win_bytes, &s_full[0], bulk != 0,
                 lane);
  } else {
    const float* ph = phases + 4 * c;  // rc, dfc, ri, fi
    float rc = ph[0], ri = ph[2];
    for (int i = 0; i < w; ++i) {      // the recurrence of the windows before
      rc = floor_mod(rc + ph[1] * 1e-3f, kLca);
      ri = floor_mod(ri + ph[3] * 1e-3f, 1.0f);
    }
    mbar_wait(&s_full[0], 0);
    correlate_partial(reinterpret_cast<const T*>(m.ring), m.time, m.code, n_samp, fs,
                      rc, ph[1], ri, ph[3], rank * kBlockCorr + (int)threadIdx.x,
                      reduce_owner(lane), s_red);
  }
  channel_sync();
  if (rank == 0 && warp == 0) {
    if (kWin) {
      float sums[kSums], comb[6];
      all_sums(s_red, lane, sums);
      polarity_combine(sums, comb);
#pragma unroll
      for (int i = 0; i < 6; ++i)
        if (lane == i) out[(size_t)q * 6 + i] = comb[i];
    } else {
      const float v = finish_sum(s_red, lane);
      if (lane < kSums) out[c * kSums + lane] = v;
    }
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
  const int own = reduce_owner(lane);
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

// Boundary k of a window (between segments k - 1 and k): the sample index
// from which the code phase has passed k L_CA, b_k = (k L_CA - rc) fs / fc;
// +inf past the window's last boundary (k > m + 1), -inf before the first.
__device__ __forceinline__ float seg_bound(int k, int m, float rc, float ratio) {
  if (k <= 0) return -INFINITY;
  if (k > m + 1) return INFINITY;
  return ((float)k * kLca - rc) * ratio;
}

// K3 body for one group of three segments [3 grp, 3 grp + 3) of an m-period
// window held in the ring's slots slot0, slot0 + 1, ... (mod depth), each
// one code period of n_per samples: this thread's share of the group's 18
// sums (its samples g, g + kLanes, ... that fall in the group, in order),
// reduced over its warp into red[gwarp][own] of every block of the channel.
// Sums are indexed tap * 6 + (segment - 3 grp) * 2 + re/im, as K3's.
template <typename T>
__device__ __forceinline__ void correlate_group(
    const unsigned char* ring, uint32_t slot_bytes, int slot0, int depth, int n_per,
    int m, const float* __restrict__ g_time, const float* s_code, float fs, float rc,
    float dfc, float ri, float fi, float half_win, int grp, int g, int own,
    float (*red)[kSums]) {
  float acc[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;
  const int n_samp = m * n_per;
  const float rc_mid = rc + dfc * half_win;
  const float ph_e = rc_mid + 0.5f;
  const float ph_l = rc_mid - 0.5f;
  const float ratio = fs / (kFca + dfc);
  const float b_lo = seg_bound(3 * grp, m, rc, ratio);
  const float b_1 = seg_bound(3 * grp + 1, m, rc, ratio);
  const float b_2 = seg_bound(3 * grp + 2, m, rc, ratio);
  const float b_hi = seg_bound(3 * grp + 3, m, rc, ratio);
  int per = g / n_per;              // the sample's code period in the window
  int off = g - per * n_per;        // and its index in that period
  for (int s = g; s < n_samp; s += kLanes) {
    const float k = (float)s;
    if (k >= b_hi) break;           // segments rise with the sample index
    if (k >= b_lo) {
      const int slot = (slot0 + per) % depth;
      const T* win = reinterpret_cast<const T*>(ring + (size_t)slot * slot_bytes);
      const float t = __ldg(g_time + s);
      float re, im;
      load_iq(win, off, re, im);
      const float ang = kTwoPi * (fi * t + ri);
      float wc, ws;
      sincosf(ang, &ws, &wc);
      const float bre = re * wc + im * ws;
      const float bim = im * wc - re * ws;
      const float base = t * kFca;
      const float e = s_code[chip_index(base + ph_e)];
      const float p = s_code[chip_index(base + rc_mid)];
      const float l = s_code[chip_index(base + ph_l)];
      const int seg = (int)(k >= b_1) + (int)(k >= b_2);
#define NAVLAB_ACC(SEG)                         \
  {                                             \
    acc[0 * 6 + (SEG) * 2 + 0] += e * bre;      \
    acc[0 * 6 + (SEG) * 2 + 1] += e * bim;      \
    acc[1 * 6 + (SEG) * 2 + 0] += p * bre;      \
    acc[1 * 6 + (SEG) * 2 + 1] += p * bim;      \
    acc[2 * 6 + (SEG) * 2 + 0] += l * bre;      \
    acc[2 * 6 + (SEG) * 2 + 1] += l * bim;      \
  }
      if (seg == 0) NAVLAB_ACC(0)
      else if (seg == 1) NAVLAB_ACC(1)
      else NAVLAB_ACC(2)
#undef NAVLAB_ACC
    }
    off += kLanes;
    while (off >= n_per) {
      off -= n_per;
      ++per;
    }
  }
  const int lane = g & 31;
  halve<18>(acc, 16, lane);
  halve<9>(acc, 8, lane);
  halve<5>(acc, 4, lane);
  halve<3>(acc, 2, lane);
  halve<2>(acc, 1, lane);
  if (own >= 0) {
    float* mine = &red[g >> 5][own];
    for (int r = 0; r < kCluster; ++r) store_to_rank(mine, r, acc[0]);
  }
}

// Index of sum (tap, segment, re/im) in the grouped layout.
__device__ __forceinline__ constexpr int sum_index(int tap, int seg, int q) {
  return (seg / 3) * kSums + tap * 6 + (seg % 3) * 2 + q;
}

// Every lane of the calling warp gets the window's n_groups * 18 sums.
__device__ __forceinline__ void all_group_sums(float (*red)[kWarps][kSums], int n_groups,
                                               int lane, float sums[kMaxSums]) {
#pragma unroll
  for (int grp = 0; grp < kGroups; ++grp) {
    const float v = grp < n_groups ? finish_sum(red[grp], lane) : 0.0f;
#pragma unroll
    for (int i = 0; i < kSums; ++i) sums[grp * kSums + i] = __shfl_sync(0xffffffffu, v, i);
  }
}

// Nav-bit polarity of an m-period window: m = 1 the decision tree, m > 1
// the flip-location hypothesis test (ops/tracking.py _polarity_combine):
// hypothesis j flips segments k >= j; the combined sum under j >= 1 is
// 2 cum_{j-1} - tot; the first of the largest |.|^2 wins.
__device__ __forceinline__ void polarity_combine_m(const float sums[kMaxSums], int m,
                                                   float comb[6]) {
  if (m == 1) {          // group 0 is the 18 sums of a 1 ms window
    polarity_combine(sums, comb);
    return;
  }
  const int n_seg = m + 2;
  float tr[kMaxSeg], ti[kMaxSeg];
#pragma unroll
  for (int j = 0; j < kMaxSeg; ++j) {
    tr[j] = sums[sum_index(0, j, 0)] + sums[sum_index(1, j, 0)] + sums[sum_index(2, j, 0)];
    ti[j] = sums[sum_index(0, j, 1)] + sums[sum_index(1, j, 1)] + sums[sum_index(2, j, 1)];
  }
  float tot_r = tr[0], tot_i = ti[0];
#pragma unroll
  for (int j = 1; j < kMaxSeg; ++j)
    if (j < n_seg) {
      tot_r = tot_r + tr[j];
      tot_i = tot_i + ti[j];
    }
  float best = tot_r * tot_r + tot_i * tot_i;
  int jstar = 0;
  float cum_r = tr[0], cum_i = ti[0];
#pragma unroll
  for (int j = 1; j < kMaxSeg; ++j)
    if (j < n_seg) {
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
      float a = sums[sum_index(tap, 0, q)];
#pragma unroll
      for (int k = 1; k < kMaxSeg; ++k)
        if (k < n_seg) {
          const float g = (jstar == 0 || k < jstar) ? 1.0f : -1.0f;
          a = a + g * sums[sum_index(tap, k, q)];
        }
      comb[tap * 2 + q] = a;
    }
}

// The off-path tail of an m-period window: prompt carry and m + 1 signs,
// lock detector, C/N0 meter, the log row of 15 + m floats. The window was
// correlated at rc_c / ri_c with the rate dfc_c (ncp from them); the row
// logs rc_c, ri_c and the state's fc/fi before the update.
__device__ __forceinline__ void monitor_and_log_m(
    const Phases& ph, float rc_c, float ri_c, float dfc_c, Monitor& mo,
    const float sums[kMaxSums], const Pub& pub, const TrackParams& p, float* s_rz,
    float* s_rv, float* logf, int* logi, int log_stride) {
  const int m = p.m;
  const int n_seg = m + 2;
  const int ncp = (int)floorf((p.win_s * (kFca + dfc_c) + rc_c) * p.inv_lca);

  float pa[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float carry = q == 0 ? mo.p_a_re : mo.p_a_im;
    float a = (ncp == 0) ? carry + sums[sum_index(1, 0, q)] : 0.0f;
#pragma unroll
    for (int k = 1; k < kMaxSeg; ++k)
      if (k < n_seg) a = a + ((ncp == k) ? sums[sum_index(1, k, q)] : 0.0f);
    pa[q] = a;
  }

  const LockOut lk = lock_and_cn0(mo, pub.comb[2], pub.comb[3], p, s_rz, s_rv);
  const float row[14] = {pub.comb[0], pub.comb[1], pub.comb[2], pub.comb[3],
                         pub.comb[4], pub.comb[5], rc_c, ri_c, kFca + ph.dfc, ph.fi,
                         lk.lockval, lk.snr, pub.dpc, pub.dpi};
#pragma unroll
  for (int f = 0; f < 14; ++f) logf[f * log_stride] = row[f];
  logf[14 * log_stride] = -sign_of(mo.p_a_re + sums[sum_index(1, 0, 0)]);
#pragma unroll
  for (int k = 1; k < kMaxSeg - 1; ++k)
    if (k < n_seg - 1) logf[(14 + k) * log_stride] = -sign_of(sums[sum_index(1, k, 0)]);
  logi[0] = mo.cp;
  logi[log_stride] = ncp;
  logi[2 * log_stride] = lk.lock;

  mo.cp += ncp;
  mo.p_a_re = pa[0];
  mo.p_a_im = pa[1];
}

// K4 over windows of p.m code periods (p.batch_k == 1), or over 1 ms windows
// in batches of p.batch_k (p.m == 1). The structure is track_chunk_kernel's
// (a cluster per channel, the ring filled by the service warp, barrier 1,
// the on-path tail shared by warps 0-2, barrier 2, the off-path tail on the
// service warp's lane 0); the ring holds `depth` code periods of n_per
// samples, window k being periods k m .. k m + m - 1.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads) __cluster_dims__(4, 1, 1)
track_window_kernel(const T* __restrict__ raw, const float* __restrict__ time_idc,
                    const float* __restrict__ table, const float* __restrict__ stf_in,
                    const int* __restrict__ sti_in, const float* __restrict__ ring_in,
                    float* __restrict__ stf_out, int* __restrict__ sti_out,
                    float* __restrict__ ring_out, float* __restrict__ logf,
                    int* __restrict__ logi, int n_per, int n_steps, int depth, int bulk,
                    TrackParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_red[2][kGroups][kWarps][kSums];   // by step parity and group
  __shared__ __align__(8) uint64_t s_full[kSlotMax];
  __shared__ float s_rz[kSnrN], s_rv[kSnrN];
  __shared__ Pub s_pub;
  const int c = blockIdx.x / kCluster;
  const int n_chan = gridDim.x / kCluster;
  const int rank = cluster_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool service = warp == kBlockWarps;
  const bool logger = service && rank == 0 && lane == 0;
  const int own = reduce_owner(lane);
  const int m = p.m, kb = p.batch_k;
  const int n_groups = (m + 2 + 2) / 3;
  const uint32_t per_bytes = (uint32_t)n_per * 2u * (uint32_t)sizeof(T);
  const uint32_t slot_b = (per_bytes + 15u) & ~15u;
  unsigned char* ring = smem;
  float* s_code = reinterpret_cast<float*>(smem + (size_t)depth * slot_b);
  for (int i = threadIdx.x; i < kCode; i += blockDim.x)
    s_code[i] = table[(size_t)c * kCode + i];
  if (threadIdx.x == 0) {
    for (int d = 0; d < depth; ++d) mbar_init(&s_full[d], 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  block_sync();
  channel_sync();

  Phases ph;
  CarrierLoop carr;
  CodeLoop code;
  Monitor mo;
  load_carry(c, logger, stf_in, sti_in, ring_in, ph, carr, code, mo, s_rz, s_rv);

  const size_t per_len = (size_t)2 * n_per;            // elements of T
  const int n_per_total = n_steps * m;
  const int n_log_f = 15 + m;
  const size_t log_f_step = (size_t)n_log_f * n_chan;
  const size_t log_i_step = (size_t)kLogI * n_chan;
  if (service)
    for (int q = 0; q < depth && q < n_per_total; ++q)
      stage_window(ring + (size_t)q * slot_b, raw + (size_t)q * per_len, per_bytes,
                   &s_full[q], bulk != 0, lane);

  float dfc_c = ph.dfc, fi_c = ph.fi;      // the rates the window correlates at
  for (int k = 0; k < n_steps; ++k) {
    float (*red)[kWarps][kSums] = s_red[k & 1];
    const int w = k % kb;                  // window in the batch
    if (w == 0) {
      dfc_c = ph.dfc;
      fi_c = ph.fi;
    }
    float rc_c = ph.rc, ri_c = ph.ri;
    if (kb > 1) {
      rc_c = floor_mod(ph.rc + (dfc_c * p.t_up) * (float)w, kLca);
      ri_c = floor_mod(ph.ri + (fi_c * p.t_up) * (float)w, 1.0f);
    }
    const int q0 = k * m;
    float sums[kMaxSums];
    if (!service) {
      for (int j = 0; j < m; ++j) {
        const int q = q0 + j;
        mbar_wait(&s_full[q % depth], (uint32_t)((q / depth) & 1));
      }
      for (int grp = 0; grp < n_groups; ++grp)
        correlate_group<T>(ring, slot_b, q0 % depth, depth, n_per, m, time_idc, s_code,
                           p.fs, rc_c, dfc_c, ri_c, fi_c, p.half_win, grp,
                           rank * kBlockCorr + (int)threadIdx.x, own, red[grp]);
    }
    // Barrier 1: the partials are complete and the window's slots are free.
    channel_sync();
    if (warp == 0) {            // the carrier loop
      float comb[6], dpi;
      all_group_sums(red, n_groups, lane, sums);
      polarity_combine_m(sums, m, comb);
      const float di = carrier_step(carr, comb, p, dpi);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < 6; ++i) s_pub.comb[i] = comb[i];
        s_pub.dpi = dpi;
        s_pub.di = di;
      }
    } else if (warp == 1) {     // the code loop
      float comb[6], dpc;
      all_group_sums(red, n_groups, lane, sums);
      polarity_combine_m(sums, m, comb);
      const float dc = code_step(code, comb, p, dpc);
      if (lane == 0) {
        s_pub.dpc = dpc;
        s_pub.dc = dc;
      }
    } else if (warp == 2) {     // the time update
      if (lane == 0) {
        if (kb == 1) {          // with the pre-update rates
          s_pub.rc_new = floor_mod(ph.rc + ph.dfc * p.t_up, kLca);
          s_pub.ri_new = floor_mod(ph.ri + ph.fi * p.t_up, 1.0f);
        } else if (w == kb - 1) {   // the batch's frozen-rate carry
          s_pub.rc_new = floor_mod(rc_c + dfc_c * p.t_up, kLca);
          s_pub.ri_new = floor_mod(ri_c + fi_c * p.t_up, 1.0f);
        } else {
          s_pub.rc_new = ph.rc;
          s_pub.ri_new = ph.ri;
        }
      }
    } else if (service) {       // refill the window's slots; keep the sums
      for (int j = 0; j < m; ++j) {
        const int q = q0 + j;
        if (q + depth < n_per_total)
          stage_window(ring + (size_t)(q % depth) * slot_b,
                       raw + (size_t)(q + depth) * per_len, per_bytes,
                       &s_full[q % depth], bulk != 0, lane);
      }
      if (rank == 0) all_group_sums(red, n_groups, lane, sums);
    }
    // Barrier 2 (the block's own): the new phases are published.
    block_sync();
    if (logger) {
      const Pub pub = s_pub;
      monitor_and_log_m(ph, rc_c, ri_c, dfc_c, mo, sums, pub, p, s_rz, s_rv,
                        logf + k * log_f_step + c, logi + k * log_i_step + c, n_chan);
      advance(ph, pub, p);
    } else {
      advance(ph, s_pub, p);
    }
  }

  store_carry(c, rank, warp, lane, logger, ph, carr, code, mo, s_rz, s_rv, stf_out,
              sti_out, ring_out);
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

template <typename T, bool kWin>
int launch_correlate(const void* raw, const float* time_idc, const float* table,
                     const float* phases, int n_chan, int n_samp, int n_win, float fs,
                     int bulk, float* out, cudaStream_t s) {
  const size_t smem = slot_bytes(n_samp, sizeof(T) == 2) + table_bytes(n_samp);
  static size_t allowed = 0;       // per instantiation
  cudaError_t e = allow_smem(correlate_window_kernel<T, kWin>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  correlate_window_kernel<T, kWin><<<n_win * n_chan * kCluster, kBlockThreads, smem, s>>>(
      (const T*)raw, time_idc, table, phases, n_samp, n_chan, fs, bulk, out);
  return (int)cudaGetLastError();
}

// Code periods the second K4 kernel's ring holds beside one code row.
int window_depth(int n_per, int raw_i16) {
  if (n_per <= 0) return 0;
  const size_t code = (size_t)(kCode + 1) * sizeof(float);
  const size_t fit = (kSmemMaxW - code) / slot_bytes(n_per, raw_i16);
  return (int)(fit < (size_t)kSlotMax ? fit : (size_t)kSlotMax);
}

template <typename T>
int launch_window(const void* raw, const float* time_idc, const float* table,
                  const float* stf_in, const int* sti_in, const float* ring_in,
                  float* stf_out, int* sti_out, float* ring_out, float* logf, int* logi,
                  int n_chan, int n_per, int n_steps, int depth, int bulk,
                  const TrackParams& p, cudaStream_t s) {
  const size_t smem = (size_t)depth * slot_bytes(n_per, sizeof(T) == 2) +
                      (size_t)(kCode + 1) * sizeof(float);
  static size_t allowed = 0;       // per instantiation
  cudaError_t e = allow_smem(track_window_kernel<T>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  track_window_kernel<T><<<n_chan * kCluster, kBlockThreads, smem, s>>>(
      (const T*)raw, time_idc, table, stf_in, sti_in, ring_in, stf_out, sti_out, ring_out,
      logf, logi, n_per, n_steps, depth, bulk, p);
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

// Code periods of n_per samples the coherent/batched K4 keeps in its ring (a
// window of m periods needs m).
int track_window_depth(int n_per, int raw_i16) { return window_depth(n_per, raw_i16); }

// int64 words per channel that track_chunk_launch's `clk` receives: clock64()
// sums over the chunk for waiting on samples, correlate + warp reduce, the
// step barrier, the on-path update (thread 0), the service warp's staging
// and tail (its lane 0), and the whole step loop (thread 0).
int track_clock_words() { return kClocks; }

// K3: n_win == 0: out [C, 18] (tap, seg, re/im) for one window raw [S, 2]
// (int16 when raw_i16, else f32; 4-byte aligned); phases [C, 4] = rc, dfc,
// ri, fi; table [C, 1023]. n_win > 0, the windows mode: raw [n_win, S, 2],
// phases those of the first window, out [n_win, C, 3, 2] (E, P, L combined).
// Enqueues on `stream`, allocates nothing; returns a cudaError.
int correlate_window_launch(const void* raw, int raw_i16, const float* time_idc,
                            const float* table, const float* phases, int n_chan,
                            int n_samp, int n_win, float fs, float* out, void* stream) {
  if (n_chan <= 0 || n_win < 0 || (long long)(n_win > 0 ? n_win : 1) * n_chan >
      2147483647LL / kCluster || ring_depth(n_samp, raw_i16) < 1 ||
      (uintptr_t)raw % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int bulk = bulk_ok(raw, n_samp, raw_i16);
  if (n_win > 0)
    return raw_i16 ? launch_correlate<int16_t, true>(raw, time_idc, table, phases, n_chan,
                                                     n_samp, n_win, fs, bulk, out, s)
                   : launch_correlate<float, true>(raw, time_idc, table, phases, n_chan,
                                                   n_samp, n_win, fs, bulk, out, s);
  return raw_i16 ? launch_correlate<int16_t, false>(raw, time_idc, table, phases, n_chan,
                                                    n_samp, 1, fs, bulk, out, s)
                 : launch_correlate<float, false>(raw, time_idc, table, phases, n_chan,
                                                  n_samp, 1, fs, bulk, out, s);
}

// K4: n_steps windows raw [steps, S, 2] of p.m code periods each; state
// in/out [C, 16] f32, [C, 5] int32, rings [C, 2, 20]; logs logf
// [steps, 15 + p.m, C], logi [steps, 3, C]. p.m > 1 (coherent windows) or
// p.batch_k > 1 (the batch schedule, n_steps a multiple of it) run the
// second kernel. `clk`: null, or [C, track_clock_words()] int64 on the
// device (the m = 1 kernel's).
int track_chunk_launch(const void* raw, int raw_i16, const float* time_idc,
                       const float* table, const float* stf_in, const int* sti_in,
                       const float* ring_in, float* stf_out, int* sti_out,
                       float* ring_out, float* logf, int* logi, int n_chan,
                       int n_samp, int n_steps, TrackParams p, long long* clk,
                       void* stream) {
  if (p.m > 1 || p.batch_k > 1) {
    if (p.m < 1 || p.m > kMaxM || n_samp % p.m != 0 || p.batch_k < 1 ||
        (p.m > 1 && p.batch_k > 1) || n_steps <= 0 || n_steps % p.batch_k != 0 ||
        clk != nullptr || n_chan <= 0 || n_chan > 65535 / kCluster ||
        (uintptr_t)raw % 4 != 0)
      return (int)cudaErrorInvalidValue;
    const int n_per = n_samp / p.m;
    const int wdepth = window_depth(n_per, raw_i16);
    if (wdepth < p.m) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int bulk = bulk_ok(raw, n_per, raw_i16);
#define NAVLAB_WINDOW_ARGS                                                         \
  raw, time_idc, table, stf_in, sti_in, ring_in, stf_out, sti_out, ring_out, logf, \
      logi, n_chan, n_per, n_steps, wdepth, bulk, p, s
    return raw_i16 ? launch_window<int16_t>(NAVLAB_WINDOW_ARGS)
                   : launch_window<float>(NAVLAB_WINDOW_ARGS);
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
