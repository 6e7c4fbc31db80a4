// Hopper (sm_90a) shared-memory barriers, shared by the kernels of csrc/.
//
// An mbarrier counts thread arrivals and, for TMA and bulk copies, the
// bytes still in flight (expect_tx / complete_tx); a phase completes when
// both reach zero. Waits take the parity of the phase they wait for: the
// first completion of a barrier is parity 0, the second parity 1, and so on.

#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises; the fence makes the barrier visible to the
// asynchronous proxy (TMA), as the kernels here run no clusters. Other
// threads see it after a __syncthreads().
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(arrivals) : "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Arrive once and add `bytes` to the transfers this phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
