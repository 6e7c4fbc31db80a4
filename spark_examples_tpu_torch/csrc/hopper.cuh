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
// asynchronous proxy (TMA) of its own block. Other threads see it after a
// __syncthreads(); a kernel whose barriers other blocks of its cluster
// reach also runs mbar_init_cluster_fence() and a cluster barrier.
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

// ---------------------------------------------------------------- clusters
// For kernels launched in thread block clusters whose blocks reach each
// other's barriers and shared memory.

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  return rank;
}

// After the barriers' mbar_init: makes them visible to the cluster (its
// TMA multicasts and remote arrivals), before a cluster barrier.
__device__ __forceinline__ void mbar_init_cluster_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Every thread of every block of the cluster (warp-aligned): release this
// thread's writes, acquire the others'.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The shared::cluster address of the local shared address `addr` in the
// block of rank `rank`.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Arrive on a barrier of any block of the cluster (a cluster_map address),
// releasing this thread's earlier writes at cluster scope.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Arrive on a barrier of another block of the cluster (a cluster_map
// address) with the default, CTA-scope release: a hand-back of a buffer
// that the arriving thread only read, which orders nothing across the
// cluster and does not wait on the thread's memory operations at cluster
// scope.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(bar) : "memory");
}

// mbar_wait, acquiring at cluster scope what another block released.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A 32-bit store into any block's shared memory (a cluster_map address).
__device__ __forceinline__ void st_cluster_u32(uint32_t addr, uint32_t value) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(addr), "r"(value) : "memory");
}

// A TMA load of one 2-D box at (x, y) of the tensor map at `map` into the
// same shared address `dst` of every block in `mask` (bit r: rank r), each
// block's barrier at the same address `bar` counting its bytes.
__device__ __forceinline__ void tma_load_box_multicast(uint32_t dst, const void* map, uint32_t bar,
                                                       int x, int y, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "h"(mask)
      : "memory");
}
