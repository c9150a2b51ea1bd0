// Hopper's bulk copy (the Tensor Memory Accelerator's non-tensor form) and
// the shared-memory mbarrier it reports to: the few PTX operations with
// which cell_pair_ladder.cu's K3c and K3d stage their whole columns and
// column windows, each in a small named function so that nothing else
// holds PTX.  A copy moves a
// contiguous run of bytes from global to shared memory without the threads
// (both addresses and the size multiples of 16 bytes) and, when its bytes
// have landed, takes them off the barrier's expected count; the barrier's
// phase completes when its arrivals are in and no byte is outstanding.
//
// Protocol (one phase a launch): one thread initialises the barrier with
// one arrival and fences the init; a __syncthreads(); one thread arrives
// with the total bytes expected, then the copies are issued; every thread
// that reads the stage waits on the phase's parity (0).

#pragma once

#include <cuda_runtime.h>

namespace bulk {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

// makes the init visible to the async proxy (the copy engine) and to the
// other threads, before any of them uses the barrier
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival, with `bytes` more expected from the copies
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// `bytes` from global `src` to shared `dst`, reported to `bar`
__device__ __forceinline__ void copy(void* dst, const void* src,
                                     unsigned bytes,
                                     unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

}  // namespace bulk
