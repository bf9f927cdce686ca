// Scalar tracking for Hopper (sm_90a): the 1 ms E/P/L correlator (K3) and
// the closed-loop DLL/PLL tracker over a whole chunk (K4).
//
// Replaces the TPU kernels navlab_dpe_sdr_tpu/ops/pallas_track.py
// _kernel / correlate_window_pallas (K3) and track_chunk_pallas (K4), and
// the XLA scan of ops/tracking.py track_chunk (m = 1) they stand in for.
//
// K3, one 1 ms window of S samples, channel c (one thread block):
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
// What bounds it on the card: a strictly sequential loop. Each step reads
// 10 KB of raw samples (int16, shared by every channel and resident in L2)
// and does ~60 f32 operations per sample per channel, then a serial tail of
// a few hundred scalar operations on one thread. At 8 channels one thread
// block per channel occupies 8 of the 132 SMs; a step costs a block
// reduction plus the tail, so latency, not bandwidth or FLOP/s, bounds it.
// The design's answer is to keep the whole chunk in ONE launch (a
// persistent block per channel carrying the state in registers and shared
// memory), instead of the ~100 small launches per step of the eager
// PyTorch form.
//
// Built with -fmad=false (see ops/_build.py) so every step is the same f32
// arithmetic, in the same order, as the plain PyTorch version
// (ops/track.py correlate_window_plain, ops/tracking.py); only the order of
// the sample sums and the cosf/sinf/atanf ulps differ. Modulo is the
// floor-mod of jnp.mod / torch.remainder (fmodf, then + divisor when the
// signs differ), and sign(0) is 0.
//
// Later: several channels per block or a cluster per channel to fill more
// SMs; warp-parallel tail; overlapping the next step's loads with the tail.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 18;      // tap(E, P, L) x seg(3) x re/im
constexpr int kCode = 1023;
constexpr int kSnrN = 20;
constexpr int kStateF = 16;
constexpr int kStateI = 5;
constexpr int kLogF = 16;
constexpr int kLogI = 3;
constexpr float kFca = 1.023e6f;
constexpr float kLca = 1023.0f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kLockK = 1.5f;

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
};

namespace {

__device__ __forceinline__ float floor_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

__device__ __forceinline__ float sign_of(float x) {
  return (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : 0.0f);
}

__device__ __forceinline__ int chip_index(float x) {
  return (int)floor_mod(floorf(x), kLca);
}

__device__ __forceinline__ float to_f32(int16_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(float v) { return v; }

// K3 body: the 18 sums of one window for the block's channel, reduced over
// the thread block. The result is valid in thread 0. s_red is [kWarps][18].
template <typename T>
__device__ void correlate_block(const T* __restrict__ raw, const float* s_time,
                                const float* s_code, int n_samp, float fs,
                                float rc, float dfc, float ri, float fi,
                                float (*s_red)[kSums], float out[kSums]) {
  float acc[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;
  const float rc_mid = rc + dfc * 0.5e-3f;
  const float ph_e = rc_mid + 0.5f;
  const float ph_l = rc_mid - 0.5f;
  const float ratio = fs / (kFca + dfc);
  const float b1 = (kLca - rc) * ratio;
  const float b2 = (2.0f * kLca - rc) * ratio;
  for (int s = threadIdx.x; s < n_samp; s += blockDim.x) {
    const float t = s_time[s];
    const float re = to_f32(raw[2 * s]);
    const float im = to_f32(raw[2 * s + 1]);
    const float ang = kTwoPi * (fi * t + ri);
    const float wc = cosf(ang);
    const float ws = sinf(ang);
    const float bre = re * wc + im * ws;
    const float bim = im * wc - re * ws;
    const float base = t * kFca;
    const float e = s_code[chip_index(base + ph_e)];
    const float p = s_code[chip_index(base + rc_mid)];
    const float l = s_code[chip_index(base + ph_l)];
    const float k = (float)s;
    const int seg = (int)(k >= b1) + (int)(k >= b2);
#define NAVLAB_ACC(SEG)                                   \
  {                                                       \
    acc[0 * 6 + (SEG) * 2 + 0] += e * bre;                \
    acc[0 * 6 + (SEG) * 2 + 1] += e * bim;                \
    acc[1 * 6 + (SEG) * 2 + 0] += p * bre;                \
    acc[1 * 6 + (SEG) * 2 + 1] += p * bim;                \
    acc[2 * 6 + (SEG) * 2 + 0] += l * bre;                \
    acc[2 * 6 + (SEG) * 2 + 1] += l * bim;                \
  }
    if (seg == 0) NAVLAB_ACC(0)
    else if (seg == 1) NAVLAB_ACC(1)
    else NAVLAB_ACC(2)
#undef NAVLAB_ACC
  }
#pragma unroll
  for (int i = 0; i < kSums; ++i)
    for (int off = 16; off > 0; off >>= 1)
      acc[i] += __shfl_down_sync(0xffffffffu, acc[i], off);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0)
    for (int i = 0; i < kSums; ++i) s_red[warp][i] = acc[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSums; ++i) {
      float v = s_red[0][i];
      for (int w = 1; w < kWarps; ++w) v += s_red[w][i];
      out[i] = v;
    }
  }
}

struct State {
  float rc, dfc, ri, fi, dfc_bias, fi_bias, p_a_re, p_a_im;
  float lf_code_h, lf_carr_h, lf_code_h2, lf_carr_h2, lock_i, lock_q;
  float prev_p_re, prev_p_im;
  int cp, losscount, lockcount, lock, snr_fill;
};

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

__device__ __forceinline__ float ring_mean(const float* r, int head) {
  float s = 0.0f;
  for (int i = 0; i < kSnrN; ++i) s += r[(head + i) % kSnrN];
  return s / (float)kSnrN;
}

// The closed-loop tail of one step (thread 0): consumes the window's sums,
// writes the log row, advances the state. Rings are circular with the
// oldest sample at *head.
__device__ void track_tail(State& st, const float sums[kSums], const TrackParams& p,
                           float* s_rz, float* s_rv, int& head,
                           float* logf, int* logi, int log_stride) {
  // segment sums (tap, seg, re/im)
  const float* es = sums;
  const float* ps = sums + 6;
  const float* ls = sums + 12;
  const float fc = kFca + st.dfc;
  const int ncp = (int)floorf((p.win_s * fc + st.rc) * p.inv_lca);

  // polarity resolution (m = 1 decision tree)
  float tr[3], ti[3];
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
  float comb[6];  // e_r, p_r, l_r as (re, im)
  for (int tap = 0; tap < 3; ++tap)
    for (int q = 0; q < 2; ++q) {
      const float* x = sums + tap * 6 + q;
      float a = x[0];
      a = a + g1 * x[2];
      a = a + g2 * x[4];
      comb[tap * 2 + q] = a;
    }
  const float sign0 = -sign_of(st.p_a_re + ps[0]);
  const float sign1 = -sign_of(ps[2]);
  float pa[2];
  for (int q = 0; q < 2; ++q) {
    const float carry = q == 0 ? st.p_a_re : st.p_a_im;
    float a = (ncp == 0) ? carry + ps[q] : 0.0f;
    a = a + ((ncp == 1) ? ps[2 + q] : 0.0f);
    a = a + ((ncp == 2) ? ps[4 + q] : 0.0f);
    pa[q] = a;
  }

  // lock detector + C/N0 meter
  const float ip = comb[2], qp = comb[3];
  const float li = p.lpf * fabsf(ip) + p.one_m_lpf * st.lock_i;
  const float lq = p.lpf * fabsf(qp) + p.one_m_lpf * st.lock_q;
  const bool in_lock = (li / kLockK) > lq;
  const int lock = (in_lock && st.lockcount > p.lock_th)
                       ? 1
                       : ((!in_lock && st.losscount > p.loss_th) ? 0 : st.lock);
  const int losscount = in_lock ? 0 : st.losscount + 1;
  const int lockcount = in_lock ? st.lockcount + 1 : 0;
  const float lockval = li / kLockK - lq;
  const float z = ip * ip + qp * qp;
  s_rz[head] = z;                      // drop the oldest, append z
  const float z_mean = ring_mean(s_rz, (head + 1) % kSnrN);
  float v = z - z_mean;
  v = v * v;
  s_rv[head] = v;
  const float z_var = ring_mean(s_rv, (head + 1) % kSnrN);
  head = (head + 1) % kSnrN;
  const float carrier = sqrtf(fmaxf(z_mean * z_mean - z_var, 0.0f));
  const float noise_var = fmaxf((z_mean - carrier) / 2.0f, 1e-12f);
  const float logarg = fmaxf(carrier / (p.snr_den * noise_var), 1.0f);
  const float snr = 10.0f * log10f(logarg);

  // log row (state before the update)
  const float row[kLogF] = {comb[0], comb[1], comb[2], comb[3], comb[4], comb[5],
                            st.rc, st.ri, fc, st.fi, lockval, snr, 0.0f, 0.0f,
                            sign0, sign1};

  // time update with the pre-update rates
  const float rc_new = floor_mod(st.rc + st.dfc * p.t_up, kLca);
  const float ri_new = floor_mod(st.ri + st.fi * p.t_up, 1.0f);
  const int cp_old = st.cp;

  // discriminators and loop filters
  const float dpi = (ip != 0.0f) ? atanf(qp / ip) / kTwoPi : 0.0f;
  const float e_env = sqrtf(comb[0] * comb[0] + comb[1] * comb[1]);
  const float l_env = sqrtf(comb[4] * comb[4] + comb[5] * comb[5]);
  const float denom = e_env + l_env;
  const float dpc = (denom != 0.0f) ? (e_env - l_env) / (2.0f * fmaxf(denom, 1e-30f)) : 0.0f;
  float xf = 0.0f;
  if (p.fll) {
    const float cross = st.prev_p_re * qp - ip * st.prev_p_im;
    const float dot = st.prev_p_re * ip + st.prev_p_im * qp;
    const float sgn = dot < 0.0f ? -1.0f : 1.0f;
    xf = atan2f(sgn * cross, sgn * dot) / p.fll_norm;
  }
  const float di = lf_step(st.lf_carr_h, st.lf_carr_h2, dpi, xf, p.carr,
                           p.carr_h2 != 0, p.boxcar != 0, p.t_up);
  const float dc = lf_step(st.lf_code_h, st.lf_code_h2, dpc, 0.0f, p.code,
                           p.code_h2 != 0, p.boxcar != 0, p.t_up);

  st.fi = st.fi_bias + di;
  st.dfc = st.dfc_bias + dc + p.fcaid * (st.fi_bias + di);
  st.rc = rc_new;
  st.ri = ri_new;
  st.cp = cp_old + ncp;
  st.p_a_re = pa[0];
  st.p_a_im = pa[1];
  st.lock_i = li;
  st.lock_q = lq;
  st.losscount = losscount;
  st.lockcount = lockcount;
  st.lock = lock;
  st.snr_fill += 1;
  st.prev_p_re = ip;
  st.prev_p_im = qp;

  for (int f = 0; f < kLogF; ++f) logf[f * log_stride] = row[f];
  logf[12 * log_stride] = dpc;
  logf[13 * log_stride] = dpi;
  logi[0] = cp_old;
  logi[log_stride] = ncp;
  logi[2 * log_stride] = lock;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
correlate_window_kernel(const T* __restrict__ raw, const float* __restrict__ time_idc,
                        const float* __restrict__ table, const float* __restrict__ phases,
                        int n_samp, float fs, float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float s_red[kWarps][kSums];
  float* s_time = smem;
  float* s_code = smem + n_samp;
  const int c = blockIdx.x;
  for (int i = threadIdx.x; i < n_samp; i += blockDim.x) s_time[i] = time_idc[i];
  for (int i = threadIdx.x; i < kCode; i += blockDim.x) s_code[i] = table[(size_t)c * kCode + i];
  __syncthreads();
  const float* ph = phases + 4 * c;  // rc, dfc, ri, fi
  float sums[kSums];
  correlate_block(raw, s_time, s_code, n_samp, fs, ph[0], ph[1], ph[2], ph[3], s_red, sums);
  if (threadIdx.x == 0)
    for (int i = 0; i < kSums; ++i) out[c * kSums + i] = sums[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
track_chunk_kernel(const T* __restrict__ raw, const float* __restrict__ time_idc,
                   const float* __restrict__ table, const float* __restrict__ stf_in,
                   const int* __restrict__ sti_in, const float* __restrict__ ring_in,
                   float* __restrict__ stf_out, int* __restrict__ sti_out,
                   float* __restrict__ ring_out, float* __restrict__ logf,
                   int* __restrict__ logi, int n_samp, int n_steps, TrackParams p) {
  extern __shared__ float smem[];
  __shared__ float s_red[kWarps][kSums];
  __shared__ float s_bc[4];
  __shared__ float s_rz[kSnrN], s_rv[kSnrN];
  float* s_time = smem;
  float* s_code = smem + n_samp;
  const int c = blockIdx.x;
  const int n_chan = gridDim.x;
  for (int i = threadIdx.x; i < n_samp; i += blockDim.x) s_time[i] = time_idc[i];
  for (int i = threadIdx.x; i < kCode; i += blockDim.x) s_code[i] = table[(size_t)c * kCode + i];

  State st;
  int head = 0;
  if (threadIdx.x == 0) {
    const float* f = stf_in + (size_t)c * kStateF;
    const int* q = sti_in + (size_t)c * kStateI;
    st.rc = f[0]; st.dfc = f[1]; st.ri = f[2]; st.fi = f[3];
    st.dfc_bias = f[4]; st.fi_bias = f[5]; st.p_a_re = f[6]; st.p_a_im = f[7];
    st.lf_code_h = f[8]; st.lf_carr_h = f[9]; st.lf_code_h2 = f[10]; st.lf_carr_h2 = f[11];
    st.lock_i = f[12]; st.lock_q = f[13]; st.prev_p_re = f[14]; st.prev_p_im = f[15];
    st.cp = q[0]; st.losscount = q[1]; st.lockcount = q[2]; st.lock = q[3]; st.snr_fill = q[4];
    for (int i = 0; i < kSnrN; ++i) {
      s_rz[i] = ring_in[((size_t)c * 2 + 0) * kSnrN + i];
      s_rv[i] = ring_in[((size_t)c * 2 + 1) * kSnrN + i];
    }
    s_bc[0] = st.rc; s_bc[1] = st.dfc; s_bc[2] = st.ri; s_bc[3] = st.fi;
  }
  __syncthreads();

  const size_t step_len = (size_t)2 * n_samp;
  const size_t log_f_step = (size_t)kLogF * n_chan;
  const size_t log_i_step = (size_t)kLogI * n_chan;
  for (int k = 0; k < n_steps; ++k) {
    float sums[kSums];
    correlate_block(raw + (size_t)k * step_len, s_time, s_code, n_samp, p.fs,
                    s_bc[0], s_bc[1], s_bc[2], s_bc[3], s_red, sums);
    if (threadIdx.x == 0) {
      track_tail(st, sums, p, s_rz, s_rv, head, logf + k * log_f_step + c,
                 logi + k * log_i_step + c, n_chan);
      s_bc[0] = st.rc; s_bc[1] = st.dfc; s_bc[2] = st.ri; s_bc[3] = st.fi;
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    float* f = stf_out + (size_t)c * kStateF;
    int* q = sti_out + (size_t)c * kStateI;
    f[0] = st.rc; f[1] = st.dfc; f[2] = st.ri; f[3] = st.fi;
    f[4] = st.dfc_bias; f[5] = st.fi_bias; f[6] = st.p_a_re; f[7] = st.p_a_im;
    f[8] = st.lf_code_h; f[9] = st.lf_carr_h; f[10] = st.lf_code_h2; f[11] = st.lf_carr_h2;
    f[12] = st.lock_i; f[13] = st.lock_q; f[14] = st.prev_p_re; f[15] = st.prev_p_im;
    q[0] = st.cp; q[1] = st.losscount; q[2] = st.lockcount; q[3] = st.lock; q[4] = st.snr_fill;
    for (int i = 0; i < kSnrN; ++i) {  // back to oldest-first order
      ring_out[((size_t)c * 2 + 0) * kSnrN + i] = s_rz[(head + i) % kSnrN];
      ring_out[((size_t)c * 2 + 1) * kSnrN + i] = s_rv[(head + i) % kSnrN];
    }
  }
}

size_t smem_bytes(int n_samp) { return (size_t)(n_samp + kCode) * sizeof(float); }

bool bad_shape(int n_chan, int n_samp) {
  return n_chan <= 0 || n_chan > 65535 || n_samp <= 0 || smem_bytes(n_samp) > 40 * 1024;
}

}  // namespace

extern "C" {

// Largest window (samples) the kernels take: its time table and one code
// row share the block's dynamic shared memory.
int track_max_samples() { return (int)(40 * 1024 / sizeof(float)) - kCode; }

int track_params_size() { return (int)sizeof(TrackParams); }

// Threads per channel block: the plain sums follow this order
// (ops/track.py KERNEL_THREADS).
int track_threads() { return kThreads; }

// K3: out [C, 18] (tap, seg, re/im) for one window raw [S, 2] (int16 when
// raw_i16, else f32); phases [C, 4] = rc, dfc, ri, fi; table [C, 1023].
// Enqueues on `stream`, allocates nothing; returns cudaGetLastError().
int correlate_window_launch(const void* raw, int raw_i16, const float* time_idc,
                            const float* table, const float* phases, int n_chan,
                            int n_samp, float fs, float* out, void* stream) {
  if (bad_shape(n_chan, n_samp)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = smem_bytes(n_samp);
  if (raw_i16)
    correlate_window_kernel<int16_t><<<n_chan, kThreads, smem, s>>>(
        (const int16_t*)raw, time_idc, table, phases, n_samp, fs, out);
  else
    correlate_window_kernel<float><<<n_chan, kThreads, smem, s>>>(
        (const float*)raw, time_idc, table, phases, n_samp, fs, out);
  return (int)cudaGetLastError();
}

// K4: n_steps windows raw [steps, S, 2]; state in/out [C, 16] f32, [C, 5]
// int32, rings [C, 2, 20]; logs logf [steps, 16, C], logi [steps, 3, C].
int track_chunk_launch(const void* raw, int raw_i16, const float* time_idc,
                       const float* table, const float* stf_in, const int* sti_in,
                       const float* ring_in, float* stf_out, int* sti_out,
                       float* ring_out, float* logf, int* logi, int n_chan,
                       int n_samp, int n_steps, TrackParams p, void* stream) {
  if (bad_shape(n_chan, n_samp) || n_steps <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = smem_bytes(n_samp);
  if (raw_i16)
    track_chunk_kernel<int16_t><<<n_chan, kThreads, smem, s>>>(
        (const int16_t*)raw, time_idc, table, stf_in, sti_in, ring_in, stf_out,
        sti_out, ring_out, logf, logi, n_samp, n_steps, p);
  else
    track_chunk_kernel<float><<<n_chan, kThreads, smem, s>>>(
        (const float*)raw, time_idc, table, stf_in, sti_in, ring_in, stf_out,
        sti_out, ring_out, logf, logi, n_samp, n_steps, p);
  return (int)cudaGetLastError();
}

const char* track_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
