// Hopper's asynchronous copies from device memory into shared memory, as
// the probe tools use them (dma_bench.cu, stream_sum.cu, copy_probe.cu):
// the bulk copy engine (cp.async.bulk, one thread asks for a contiguous run
// of bytes) completing on an mbarrier that counts the bytes it expects
// (expect_tx), and the per-thread 4-byte cp.async for what the bulk engine
// does not take (a source, destination or size that is not a multiple of
// 16 bytes).
//
// These are the TPU's `make_async_copy` and its byte-counted DMA semaphore:
// `bulk_copy(.., bar)` is `.start()` and `wait_parity(bar, phase)` is
// `.wait()` once the copies' bytes were announced with `expect_bytes`.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace guava_copy {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One arrival completes a phase, once the expected bytes have landed.
// Call from one thread; then fence_barrier_init and __syncthreads.
__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival of this phase, announcing the bytes the phase's copies bring.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Copy `bytes` (a multiple of 16; src and dst 16-byte aligned) from device
// memory into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `phase` of `bar` has completed.
__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(phase) : "memory");
  }
}

// Per-thread asynchronous 4-byte copy (4-byte aligned source and destination).
__device__ __forceinline__ void async_copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// Wait for this thread's cp.async copies (then __syncthreads to see everyone's).
__device__ __forceinline__ void async_copy_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

}  // namespace guava_copy
