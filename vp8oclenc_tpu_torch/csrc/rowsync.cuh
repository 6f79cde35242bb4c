// Progress counters for kernels that give each row of a frame to one CTA
// and pipeline the rows (csrc/loopfilter.cu, csrc/intra.cu).
//
// A counter only grows.  Its writer first stores the data it vouches for,
// then the new count; a reader first sees a count, then loads the data.
// Across CTAs the counter lives in device memory: st.release / ld.acquire
// at device scope, the data read with __ldcg (L2; L1 is not coherent).
// Inside a CTA it lives in shared memory.  One lane polls; the rest of the
// warp follows through __syncwarp(), which also orders the other lanes'
// stores before lane 0's release and their loads behind its acquire.
#pragma once
#include <cuda_runtime.h>

namespace rowsync {

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Wait until the counter exceeds `have`; returns its value to every lane.
// GLOBAL: a counter in device memory, else one in shared memory.
template <bool GLOBAL>
__device__ __forceinline__ int wait_above(const int* counter, int have,
                                          int lane) {
  int seen = 0;
  if (lane == 0) {
    do {
      seen = GLOBAL ? ld_acquire(counter) : *(const volatile int*)counter;
    } while (seen <= have);
  }
  seen = __shfl_sync(0xffffffffu, seen, 0);
  __syncwarp();
  return seen;
}

// Publish `v` behind every lane's stores.
template <bool GLOBAL>
__device__ __forceinline__ void post(int* counter, int v, int lane) {
  __syncwarp();
  if (lane == 0) {
    if (GLOBAL) {
      st_release(counter, v);
    } else {
      __threadfence_block();
      *(volatile int*)counter = v;
    }
  }
}

}  // namespace rowsync
