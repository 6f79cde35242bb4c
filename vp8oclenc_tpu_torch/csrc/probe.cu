// A measurement probe, not part of the encoder: how many 32-bit integer
// instructions a second the card executes, which is what the integer kernels
// of csrc/ are bounded by (an SM of compute capability 9.0 has 64 INT32
// lanes, so the reckoned peak is SMs x 64 x the SM clock).
//
// Every thread keeps 8 independent chains and advances each `iters` times;
// a step is one multiply-add (`mode` 0: a = a * m + b, one IMAD), an add
// and an exclusive-or (`mode` 1: a = (a + b) ^ m, two instructions), or
// both kinds side by side (`mode` 2: the even chains multiply-add, the odd
// ones add and exclusive-or, 12 instructions for the 8 chains), which shows
// whether the two kinds share one pipe.  The multiplier and the addend come
// from the caller, so nothing folds; the chains are summed into `out` so
// nothing is dropped.  The caller fills every SM with CTAs of 256 threads.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;

template <int MODE>
__global__ void __launch_bounds__(256)
    int_rate_kernel(int* out, int iters, int m, int b) {
  int a[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) a[k] = threadIdx.x + k;
#pragma unroll 16
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k)
      a[k] = (MODE == 0 || (MODE == 2 && k % 2 == 0)) ? a[k] * m + b
                                                      : (a[k] + b) ^ m;
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) s += a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// out: ctas * 256 int32.  Runs ctas * 256 threads, 8 chains each, `iters`
// steps a chain.
extern "C" int vp8_int_rate(void* out, int ctas, int iters, int mode, int m,
                            int b, void* stream) {
  if (mode == 0)
    int_rate_kernel<0><<<ctas, 256, 0, (cudaStream_t)stream>>>((int*)out,
                                                                iters, m, b);
  else if (mode == 1)
    int_rate_kernel<1><<<ctas, 256, 0, (cudaStream_t)stream>>>((int*)out,
                                                                iters, m, b);
  else
    int_rate_kernel<2><<<ctas, 256, 0, (cudaStream_t)stream>>>((int*)out,
                                                                iters, m, b);
  return (int)cudaGetLastError();
}
