// T1: the copy probes. Each copies a few segments of a device array into
// shared memory, at offsets given at run time, and writes a window of what
// landed back out.
//
// Replaces the seven kernels of tools/mosaic_probe.py (idx32 :44, idx1024
// :86, row1 :124, row1_loop :167, row8 :206, idx2d :248, row64 :286). On the
// TPU each isolates one DMA pattern the fused row gather needs (an index
// slice into SMEM, a table row into VMEM at a dynamic offset) and is only
// compiled, to learn which shapes and offsets Mosaic accepts. Here each is
// compiled and run, to show which copies Hopper's bulk copy engine takes:
// it copies a run of bytes whose source, destination and size are
// multiples of 16; anything else goes through per-thread 4-byte cp.async.
//
// Bound on the H100: bytes, and at these sizes (4 B to 16 KB) the launch.
//
// Design: one CTA. Segment i of n_seg starts at element (idx[i] if idx
// else 0) + base of elem_bytes each and is seg_bytes long; it lands at
// shared offset i * seg_bytes. Route 0 (bulk): thread i < n_seg issues
// segment i's bulk copy onto one mbarrier that expects all the bytes.
// Route 1 (async4): the threads copy 4-byte words with cp.async. Then the
// threads write out[0 : out_bytes] = shared[out_off : out_off + out_bytes].
// The host picks the route (kernels/copy_probe.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

using namespace guava_copy;

constexpr int kThreads = 128;
constexpr int kMaxBytes = 16384;   // row1_loop: 32 rows of 512 B

__global__ void __launch_bounds__(kThreads) copy_probe_kernel(
    const unsigned char* __restrict__ src, const int* __restrict__ idx, int n_seg, int64_t base,
    int elem_bytes, int seg_bytes, int out_off, int out_bytes, unsigned char* __restrict__ out,
    int route) {
  __shared__ __align__(128) unsigned char buf[kMaxBytes];
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x;
  auto seg_src = [&](int i) {
    const int64_t elem = (idx != nullptr ? static_cast<int64_t>(idx[i]) : 0) + base;
    return src + elem * elem_bytes;
  };
  if (route == 0) {
    if (tid == 0) {
      barrier_init(&bar);
      fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0) expect_bytes(&bar, static_cast<uint32_t>(n_seg * seg_bytes));
    __syncthreads();
    for (int i = tid; i < n_seg; i += kThreads) {
      bulk_copy(buf + i * seg_bytes, seg_src(i), seg_bytes, &bar);
    }
    wait_parity(&bar, 0);
  } else {
    const int words = seg_bytes / 4;
    for (int w = tid; w < n_seg * words; w += kThreads) {
      const int i = w / words;
      async_copy4(buf + 4 * w, seg_src(i) + 4 * (w - i * words));
    }
    async_copy_wait_all();
    __syncthreads();
  }
  for (int b = tid; b < out_bytes / 4; b += kThreads) {
    reinterpret_cast<uint32_t*>(out)[b] = *reinterpret_cast<const uint32_t*>(buf + out_off + 4 * b);
  }
}

}  // namespace

// src: a device array; idx: n_seg i32 element ids, or null for one segment at
// `base`; elem_bytes, seg_bytes, out_off and out_bytes multiples of 4,
// n_seg * seg_bytes <= 16384 and out_off + out_bytes within it; route 0 needs
// the source offsets, seg_bytes and elem_bytes (with idx) to be multiples of
// 16 -> out (out_bytes bytes).
extern "C" int guava_copy_probe(const void* src, const int* idx, int n_seg, long long base,
                                int elem_bytes, int seg_bytes, int out_off, int out_bytes,
                                void* out, int route, void* stream) {
  const bool fits = n_seg >= 1 && seg_bytes > 0 && n_seg * seg_bytes <= kMaxBytes &&
                    out_off >= 0 && out_bytes > 0 && out_off + out_bytes <= n_seg * seg_bytes;
  const bool words = elem_bytes % 4 == 0 && seg_bytes % 4 == 0 && out_off % 4 == 0 &&
                     out_bytes % 4 == 0;
  const bool bulk = seg_bytes % 16 == 0 && (base * elem_bytes) % 16 == 0 &&
                    (idx == nullptr || elem_bytes % 16 == 0);
  if (!fits || !words || (route != 0 && route != 1) || (route == 0 && !bulk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  copy_probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), idx, n_seg, base, elem_bytes, seg_bytes, out_off,
      out_bytes, static_cast<unsigned char*>(out), route);
  return static_cast<int>(cudaGetLastError());
}
