// The soft LNAV decode's bit loop: each channel's decision-directed phase
// loop over its bit sums, forward then backward, in float64
// (models/navbits.py `_loop` and `coherent_bits`; ops/navbits_loop.py binds
// it).
//
// It replaces no TPU kernel: the JAX package has no soft decode, and the
// port's weak cold start decodes from the soft prompt values K4 logs. The
// loop is a chain of dependent steps (a sine, a cosine and an arctangent
// each, ~1 800 bits a pass, two passes), so the card cannot approach its
// bound: the channels run side by side, one thread block each, and one
// thread of the block runs the chain while the block stages the next bit
// sums into shared memory, so that no step waits on device memory. Built
// with -fmad=false (ops/_build.py), each step rounds as the plain loop's
// Python arithmetic does; the library's sincos and atan2 may differ from
// the host's in the last bit.

#include <cuda_runtime.h>

struct LoopArgs {
  const double2* sums;      // channel c's bit sums (re, im) at sums + c * sums_stride
  long long sums_stride;
  const int* nb;            // [C] bits of each channel, taken as at most nb_max
  const double* start;      // [C, 2] phase [rad], rate [rad a bit]
  signed char* bits;        // channel c's +/-1 decisions at bits + c * bits_stride
  long long bits_stride;
  double* ends;             // [C, 4] (phase, rate) after the forward, the backward pass
  int n_chan, nb_max;       // nb_max <= both strides
  double k1, k2;            // the loop's gains (navbits.loop_gains)
};

namespace {

constexpr int kThreads = 128;   // threads staging a block's bit sums
constexpr int kTile = 1024;     // bit sums staged at a time (16 KB)

// One bit of the loop (navbits._loop's body): the sum turned by -phase, its
// sign the decision, the decided sum's angle the phase error.
__device__ __forceinline__ double step(double2 z, double& phase, double& rate,
                                       double k1, double k2) {
  double s, c;
  sincos(phase, &s, &c);
  const double zr = z.x * c + z.y * s;
  const double zi = z.y * c - z.x * s;
  const double d = zr >= 0.0 ? 1.0 : -1.0;
  const double err = atan2(zi * d, zr * d);
  rate += k2 * err;
  phase += rate + k1 * err;
  return d;
}

__global__ void __launch_bounds__(kThreads) navbits_loop_kernel(LoopArgs a) {
  __shared__ double2 tile[kTile];
  const int c = blockIdx.x;
  const int nb = max(0, min(a.nb[c], a.nb_max));
  const double2* z = a.sums + c * a.sums_stride;
  signed char* out = a.bits + c * a.bits_stride;
  double phase = a.start[2 * c], rate = a.start[2 * c + 1];
  for (int b0 = 0; b0 < nb; b0 += kTile) {
    const int len = min(kTile, nb - b0);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kThreads) tile[i] = z[b0 + i];
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = 0; i < len; ++i) step(tile[i], phase, rate, a.k1, a.k2);
  }
  // _loop returns the phase of its last bit; the backward pass starts there
  phase -= rate;
  if (threadIdx.x == 0) {
    a.ends[4 * c] = phase;
    a.ends[4 * c + 1] = rate;
  }
  rate = -rate;
  for (int b1 = nb; b1 > 0; b1 -= kTile) {
    const int b0 = max(0, b1 - kTile), len = b1 - b0;
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kThreads) tile[i] = z[b0 + i];
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = len - 1; i >= 0; --i)
        out[b0 + i] = (signed char)step(tile[i], phase, rate, a.k1, a.k2);
  }
  if (threadIdx.x == 0) {
    a.ends[4 * c + 2] = phase - rate;
    a.ends[4 * c + 3] = rate;
  }
}

}  // namespace

extern "C" {

// Enqueues the loop (one launch, a thread block a channel) on `stream`;
// allocates nothing, does not synchronize. Returns cudaErrorInvalidValue
// for C outside 1..65535, nb_max below 0 or a stride below nb_max, else
// cudaGetLastError() after the launch (0 on success).
int navbits_loop_launch(const LoopArgs* args, void* stream) {
  const LoopArgs& a = *args;
  if (a.n_chan <= 0 || a.n_chan > 65535 || a.nb_max < 0 ||
      a.sums_stride < a.nb_max || a.bits_stride < a.nb_max)
    return (int)cudaErrorInvalidValue;
  navbits_loop_kernel<<<a.n_chan, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* navbits_loop_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
