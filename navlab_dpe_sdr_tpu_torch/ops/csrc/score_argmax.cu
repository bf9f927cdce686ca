// Manifold scoring with a fused streaming argmax (K1), and the full score
// surface of one block (K2), for Hopper (sm_90a).
//
// K1 replaces the TPU kernel navlab_dpe_sdr_tpu/ops/pallas_score.py
// _chunk_kernel / score_chunk_pallas, and the XLA scorer the JAX product
// path runs in its place (ops/dpe_real.py _score_chunk under
// _local_argmax_scan). K2 (score_surface_launch) replaces _score_kernel /
// score_manifold_pallas of the same file: the per-block step's [G] scores
// (ops/dpe_real.py score_manifolds_mag), which the score-weighted mean and
// the score dumps need whole. Both evaluate each point with the same
// __device__ function (point_score). For block n and grid point g (offsets
// o3 [G, 3], o1 [G]):
//
//   u_c   = los[n, c] . o3[g]
//   idx_c = center[n, c] + coef[n, c] * (-u_c + (|o3|^2 - u_c^2) / (2 r0[n, c])
//                                        + o1[g])      (r0 term: position only)
//   s     = sum_c interp(win[n, c, :], idx_c) ^ l_power
//
// with interp the 3-tap Lagrange ("quadratic": k0 = clip(rint(idx), 1, W-2))
// or hat weights on floor(idx), floor(idx)+1 inside [0, W-1] ("linear").
// Out: best[n] = max_g s, arg[n] = the first g at that max, and when
// weighted the sums of s*[o3, o1] (wsum4[n, 4]) and of s (wtot[n]).
//
// What bounds it on the card: ~30 f32 operations per point-channel (LOS
// projection, curvature term, index, rint/clamp, three shared-memory taps,
// Lagrange weights) against 16 bytes of offsets per point. The main path's
// 390 625-point manifolds hold 6.25 MB of offsets, which stay in the 50 MB
// L2 across the N blocks of a dispatch, so the kernel is bound by f32
// instruction throughput, not by HBM. The [N, G] score surface never
// reaches device memory: each thread block reduces its tile to (max, first
// index, weighted partial sums), and a second small kernel reduces the
// tiles of each block n. K2 does the same arithmetic and writes the
// surface (1.56 MB per manifold and block at N = 1), one 4-byte store per
// point: still bound by instructions, not by the store stream.
//
// Design (first, simple form): launch grid (tiles of 256 points, N); one
// thread per grid point looping over the C channels; block n's windows and
// per-channel parameters in shared memory. Built with -fmad=false (see
// ops/_build.py) so each point's score is the same f32 arithmetic, in the
// same order, as the plain PyTorch version (ops/score.py score_points). The
// weighted sums accumulate in f64: over the symmetric grid they cancel to a
// small mean, which f32 sums of 4e5 terms would blur.
//
// Later: loop over N inside a block so each grid point is read and its
// |o3|^2 formed once per dispatch; several points per thread; FMA
// contraction once the comparison tolerates it.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPar = 6;  // los_e, los_n, los_u, 2*r0 (or 1), center, coef

struct Acc {
  float best;
  int arg;
  double w[5];  // sum s*x, s*y, s*z, s*t, sum s
};

__device__ __forceinline__ Acc acc_empty() {
  Acc a;
  a.best = -INFINITY;
  a.arg = INT_MAX;
  for (int i = 0; i < 5; ++i) a.w[i] = 0.0;
  return a;
}

// (max, smallest index at the max): the first-occurrence rule of
// jnp.argmax over the whole grid, independent of the reduction order.
__device__ __forceinline__ void combine(Acc& a, const Acc& b, bool weighted) {
  if (b.best > a.best || (b.best == a.best && b.arg < a.arg)) {
    a.best = b.best;
    a.arg = b.arg;
  }
  if (weighted)
    for (int i = 0; i < 5; ++i) a.w[i] += b.w[i];
}

__device__ __forceinline__ Acc shfl_down(const Acc& a, int off, bool weighted) {
  Acc b;
  b.best = __shfl_down_sync(0xffffffffu, a.best, off);
  b.arg = __shfl_down_sync(0xffffffffu, a.arg, off);
  for (int i = 0; i < 5; ++i)
    b.w[i] = weighted ? __shfl_down_sync(0xffffffffu, a.w[i], off) : 0.0;
  return b;
}

// Reduce over the thread block; the result is valid in thread 0.
__device__ Acc block_reduce(Acc a, bool weighted) {
  __shared__ float s_best[kWarps];
  __shared__ int s_arg[kWarps];
  __shared__ double s_w[kWarps][5];
  for (int off = 16; off > 0; off >>= 1) combine(a, shfl_down(a, off, weighted), weighted);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    s_best[warp] = a.best;
    s_arg[warp] = a.arg;
    for (int i = 0; i < 5; ++i) s_w[warp][i] = a.w[i];
  }
  __syncthreads();
  if (warp == 0) {
    Acc b = acc_empty();
    if (lane < kWarps) {
      b.best = s_best[lane];
      b.arg = s_arg[lane];
      for (int i = 0; i < 5; ++i) b.w[i] = s_w[lane][i];
    }
    for (int off = 16; off > 0; off >>= 1) combine(b, shfl_down(b, off, weighted), weighted);
    a = b;
  }
  return a;
}

// Block n's windows [C * W] and per-channel parameters [C * kPar] into
// shared memory.
__device__ __forceinline__ void stage_block(const float* __restrict__ win,
                                            const float* __restrict__ los,
                                            const float* __restrict__ centers,
                                            const float* __restrict__ coefs,
                                            const float* __restrict__ r0, int n,
                                            int n_chan, int width, float* s_win,
                                            float* s_par) {
  const int cw = n_chan * width;
  for (int i = threadIdx.x; i < cw; i += blockDim.x) s_win[i] = win[(size_t)n * cw + i];
  for (int c = threadIdx.x; c < n_chan; c += blockDim.x) {
    const size_t nc = (size_t)n * n_chan + c;
    s_par[c * kPar + 0] = los[nc * 3 + 0];
    s_par[c * kPar + 1] = los[nc * 3 + 1];
    s_par[c * kPar + 2] = los[nc * 3 + 2];
    s_par[c * kPar + 3] = r0 != nullptr ? 2.0f * r0[nc] : 1.0f;
    s_par[c * kPar + 4] = centers[nc];
    s_par[c * kPar + 5] = coefs[nc];
  }
}

// The score of one grid point (offsets x, y, z, t) summed over channels:
// the f32 arithmetic of ops/score.py score_points, operation for operation.
template <bool kQuadRange, bool kLinear>
__device__ __forceinline__ float point_score(const float* s_win, const float* s_par,
                                             int n_chan, int width, int l_power,
                                             float x, float y, float z, float t) {
  const float d2 = x * x + y * y + z * z;
  const float wmax = (float)(width - 1);
  float acc = 0.0f;
  for (int c = 0; c < n_chan; ++c) {
    const float* p = s_par + c * kPar;
    const float u = p[0] * x + p[1] * y + p[2] * z;
    const float rng = kQuadRange ? -u + (d2 - u * u) / p[3] : -u;
    const float idx = p[4] + p[5] * (rng + t);
    const float* wr = s_win + c * width;
    float v;
    if (kLinear) {
      const float k0 = floorf(idx);
      const float k1 = k0 + 1.0f;
      v = 0.0f;
      if (k0 >= 0.0f && k0 <= wmax) v += fmaxf(0.0f, 1.0f - fabsf(idx - k0)) * wr[(int)k0];
      if (k1 >= 0.0f && k1 <= wmax) v += fmaxf(0.0f, 1.0f - fabsf(idx - k1)) * wr[(int)k1];
    } else {
      const float k0 = fminf(fmaxf(rintf(idx), 1.0f), (float)(width - 2));
      const float d = idx - k0;
      const float dd = d * d;
      const int k = (int)k0;
      v = 0.5f * (dd - d) * wr[k - 1] + (1.0f - dd) * wr[k] + 0.5f * (dd + d) * wr[k + 1];
    }
    float vp = v;
    for (int q = 1; q < l_power; ++q) vp *= v;
    acc += vp;
  }
  return acc;
}

template <bool kQuadRange, bool kLinear>
__global__ void __launch_bounds__(kThreads)
score_tiles(const float* __restrict__ win, const float* __restrict__ los,
            const float* __restrict__ centers, const float* __restrict__ coefs,
            const float* __restrict__ r0, const float* __restrict__ off3,
            const float* __restrict__ off1, int n_chan, int width, int n_grid,
            int l_power, int weighted, float* __restrict__ part_best,
            int* __restrict__ part_arg, double* __restrict__ part_w) {
  extern __shared__ float smem[];
  float* s_win = smem;                   // [C * W]
  float* s_par = smem + n_chan * width;  // [C * kPar]
  const int n = blockIdx.y;
  stage_block(win, los, centers, coefs, kQuadRange ? r0 : nullptr, n, n_chan, width,
              s_win, s_par);
  __syncthreads();

  Acc a = acc_empty();
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < n_grid) {
    const float x = off3[3 * (size_t)g + 0];
    const float y = off3[3 * (size_t)g + 1];
    const float z = off3[3 * (size_t)g + 2];
    const float t = off1[g];
    const float acc = point_score<kQuadRange, kLinear>(s_win, s_par, n_chan, width,
                                                      l_power, x, y, z, t);
    a.best = acc;
    a.arg = g;
    if (weighted) {
      a.w[0] = (double)acc * x;
      a.w[1] = (double)acc * y;
      a.w[2] = (double)acc * z;
      a.w[3] = (double)acc * t;
      a.w[4] = (double)acc;
    }
  }
  a = block_reduce(a, weighted != 0);
  if (threadIdx.x == 0) {
    const size_t o = (size_t)n * gridDim.x + blockIdx.x;
    part_best[o] = a.best;
    part_arg[o] = a.arg;
    if (weighted)
      for (int i = 0; i < 5; ++i) part_w[o * 5 + i] = a.w[i];
  }
}

__global__ void __launch_bounds__(kThreads)
reduce_tiles(const float* __restrict__ part_best, const int* __restrict__ part_arg,
             const double* __restrict__ part_w, int n_tiles, int weighted,
             float* __restrict__ best, int* __restrict__ arg,
             float* __restrict__ wsum4, float* __restrict__ wtot) {
  const int n = blockIdx.x;
  Acc a = acc_empty();
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    const size_t o = (size_t)n * n_tiles + t;
    Acc b = acc_empty();
    b.best = part_best[o];
    b.arg = part_arg[o];
    if (weighted)
      for (int i = 0; i < 5; ++i) b.w[i] = part_w[o * 5 + i];
    combine(a, b, weighted != 0);
  }
  a = block_reduce(a, weighted != 0);
  if (threadIdx.x == 0) {
    best[n] = a.best;
    arg[n] = a.arg;
    if (weighted) {
      for (int i = 0; i < 4; ++i) wsum4[n * 4 + i] = (float)a.w[i];
      wtot[n] = (float)a.w[4];
    }
  }
}

// K2: the whole score surface out[n, g] of block n (no reduction), for the
// per-block step, its score-weighted mean and its score dumps.
template <bool kQuadRange, bool kLinear>
__global__ void __launch_bounds__(kThreads)
score_surface_kernel(const float* __restrict__ win, const float* __restrict__ los,
                     const float* __restrict__ centers, const float* __restrict__ coefs,
                     const float* __restrict__ r0, const float* __restrict__ off3,
                     const float* __restrict__ off1, int n_chan, int width, int n_grid,
                     int l_power, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_win = smem;
  float* s_par = smem + n_chan * width;
  const int n = blockIdx.y;
  stage_block(win, los, centers, coefs, kQuadRange ? r0 : nullptr, n, n_chan, width,
              s_win, s_par);
  __syncthreads();
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < n_grid)
    out[(size_t)n * n_grid + g] = point_score<kQuadRange, kLinear>(
        s_win, s_par, n_chan, width, l_power, off3[3 * (size_t)g + 0],
        off3[3 * (size_t)g + 1], off3[3 * (size_t)g + 2], off1[g]);
}

template <bool kQuadRange, bool kLinear>
void launch_tiles(dim3 grid, size_t smem, cudaStream_t s, const float* win,
                  const float* los, const float* centers, const float* coefs,
                  const float* r0, const float* off3, const float* off1,
                  int n_chan, int width, int n_grid, int l_power, int weighted,
                  float* part_best, int* part_arg, double* part_w) {
  score_tiles<kQuadRange, kLinear><<<grid, kThreads, smem, s>>>(
      win, los, centers, coefs, r0, off3, off1, n_chan, width, n_grid, l_power,
      weighted, part_best, part_arg, part_w);
}

}  // namespace

extern "C" {

// Threads per tile: the caller sizes the [N, tiles] scratch with it.
int score_argmax_tile() { return kThreads; }

// Enqueues both kernels on `stream`; allocates nothing and does not
// synchronize. r0 == NULL selects the velocity manifold (no curvature
// term). part_w, wsum4 and wtot are read/written only when weighted.
// Scratch: part_best/part_arg [N * tiles], part_w [N * tiles * 5].
// Returns cudaGetLastError() after the launches (0 on success).
int score_argmax_launch(const float* win, const float* los, const float* centers,
                        const float* coefs, const float* r0, const float* off3,
                        const float* off1, int n_blocks, int n_chan, int width,
                        int n_grid, int linear, int l_power, int weighted,
                        float* part_best, int* part_arg, double* part_w,
                        float* best, int* arg, float* wsum4, float* wtot,
                        void* stream) {
  if (n_blocks <= 0 || n_blocks > 65535 || n_chan <= 0 || n_grid <= 0 ||
      l_power < 1 || width < (linear ? 1 : 3))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_chan * (width + kPar) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int tiles = (n_grid + kThreads - 1) / kThreads;
  const dim3 grid(tiles, n_blocks);
  cudaStream_t s = (cudaStream_t)stream;
  const bool quad = r0 != nullptr;
  if (quad && linear)
    launch_tiles<true, true>(grid, smem, s, win, los, centers, coefs, r0, off3, off1,
                             n_chan, width, n_grid, l_power, weighted, part_best, part_arg, part_w);
  else if (quad)
    launch_tiles<true, false>(grid, smem, s, win, los, centers, coefs, r0, off3, off1,
                              n_chan, width, n_grid, l_power, weighted, part_best, part_arg, part_w);
  else if (linear)
    launch_tiles<false, true>(grid, smem, s, win, los, centers, coefs, r0, off3, off1,
                              n_chan, width, n_grid, l_power, weighted, part_best, part_arg, part_w);
  else
    launch_tiles<false, false>(grid, smem, s, win, los, centers, coefs, r0, off3, off1,
                               n_chan, width, n_grid, l_power, weighted, part_best, part_arg, part_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_tiles<<<n_blocks, kThreads, 0, s>>>(part_best, part_arg, part_w, tiles, weighted,
                                             best, arg, wsum4, wtot);
  return (int)cudaGetLastError();
}

// K2: scores out [N, G] of every grid point for every block; the same
// operands and limits as score_argmax_launch. Returns cudaGetLastError().
int score_surface_launch(const float* win, const float* los, const float* centers,
                         const float* coefs, const float* r0, const float* off3,
                         const float* off1, int n_blocks, int n_chan, int width,
                         int n_grid, int linear, int l_power, float* out,
                         void* stream) {
  if (n_blocks <= 0 || n_blocks > 65535 || n_chan <= 0 || n_grid <= 0 ||
      l_power < 1 || width < (linear ? 1 : 3))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_chan * (width + kPar) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_grid + kThreads - 1) / kThreads, n_blocks);
  cudaStream_t s = (cudaStream_t)stream;
  const bool quad = r0 != nullptr;
#define NAVLAB_SURFACE(Q, L)                                                    \
  score_surface_kernel<Q, L><<<grid, kThreads, smem, s>>>(                      \
      win, los, centers, coefs, r0, off3, off1, n_chan, width, n_grid, l_power, out)
  if (quad && linear) NAVLAB_SURFACE(true, true);
  else if (quad) NAVLAB_SURFACE(true, false);
  else if (linear) NAVLAB_SURFACE(false, true);
  else NAVLAB_SURFACE(false, false);
#undef NAVLAB_SURFACE
  return (int)cudaGetLastError();
}

const char* score_argmax_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
