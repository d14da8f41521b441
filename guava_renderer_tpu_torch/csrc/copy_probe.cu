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
// Bound on the H100: bytes, and at these sizes (4 B to 16 KB) the launch
// and one trip to memory and back: the time is a launch's plus the copy's
// latency, which is what the design cuts.
//
// Design. One CTA a segment, its dynamic shared memory the segment rounded
// up to 128 bytes (kernels/copy_probe.py:launch_shape says the same).
// Segment i of n_seg starts at element (idx[i] if idx else 0) + base of
// elem_bytes each and is seg_bytes long; CTA i lands it and writes the part
// of the probe's window out[0 : out_bytes] = landed[out_off : out_off +
// out_bytes] that lies in it.
//  - Bulk route (every offset and size a multiple of 16): thread 0
//    initialises the mbarrier, announces the segment's bytes (the phase's
//    one arrival) and issues the copy, with no barrier in between: the
//    phase cannot complete before that arrival, and a copy that lands
//    before it is counted against the announced bytes all the same. One
//    __syncthreads publishes the initialised barrier; then every thread
//    waits on its parity.
//  - async4 route: each thread copies 4-byte words by cp.async and waits
//    for its own copies.
// Both then write back by one loop of 4-byte stores, thread t the window's
// words w with w % kThreads == t; on the async4 route these are words it
// landed itself, so no barrier stands before the stores. (On the H100 a
// CTA of one thread writing back by a bulk shared-to-global store lost to
// this on every probe, and one thread storing a row by 4-byte stores lost
// more.)
// row1_loop's 32 rows go to 32 CTAs: one CTA that stages them all waits on
// one barrier and writes 16 KB back alone.

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

using namespace guava_copy;

constexpr int kThreads = 128;
constexpr int kMaxBytes = 16384;   // a segment; idx1024's 4 KB and row8's 8 rows of 512 B fit

__global__ void __launch_bounds__(kThreads) copy_probe_kernel(
    const unsigned char* __restrict__ src, const int* __restrict__ idx, int64_t base,
    int elem_bytes, int seg_bytes, int out_off, int out_bytes, unsigned char* __restrict__ out,
    int route) {
  extern __shared__ __align__(128) unsigned char buf[];
  __shared__ __align__(8) uint64_t bar;
  const int seg = blockIdx.x;
  const unsigned char* from =
      src + ((idx != nullptr ? static_cast<int64_t>(idx[seg]) : 0) + base) * elem_bytes;
  if (route == 0) {
    if (threadIdx.x == 0) {
      barrier_init(&bar);
      fence_barrier_init();
      expect_bytes(&bar, static_cast<uint32_t>(seg_bytes));
      bulk_copy(buf, from, seg_bytes, &bar);
    }
    __syncthreads();
    wait_parity(&bar, 0);
  } else {
    for (int w = threadIdx.x; w < seg_bytes / 4; w += kThreads) {
      async_copy4(buf + 4 * w, from + 4 * w);
    }
    async_copy_wait_all();
  }
  // this segment is bytes [lo, lo + seg_bytes) of what the probe lands; its words w0 .. w1 - 1
  // lie in the window
  const int lo = seg * seg_bytes;
  const int w0 = (max(out_off, lo) - lo) / 4;
  const int w1 = (min(out_off + out_bytes, lo + seg_bytes) - lo) / 4;
  const int t = threadIdx.x;
  for (int w = w0 + ((t - w0) % kThreads + kThreads) % kThreads; w < w1; w += kThreads) {
    *reinterpret_cast<uint32_t*>(out + (lo + 4 * w - out_off)) =
        *reinterpret_cast<const uint32_t*>(buf + 4 * w);
  }
}

}  // namespace

// src: a device array; idx: n_seg i32 element ids, or null for one segment at
// `base`; elem_bytes, seg_bytes, out_off and out_bytes multiples of 4;
// seg_bytes at most 16384; out_off + out_bytes within n_seg * seg_bytes;
// route 0 needs the source offsets, seg_bytes and elem_bytes (with idx) to
// be multiples of 16 -> out (out_bytes bytes).
extern "C" int guava_copy_probe(const void* src, const int* idx, int n_seg, long long base,
                                int elem_bytes, int seg_bytes, int out_off, int out_bytes,
                                void* out, int route, void* stream) {
  const bool fits = n_seg >= 1 && seg_bytes > 0 && seg_bytes <= kMaxBytes && out_off >= 0 &&
                    out_bytes > 0 &&
                    static_cast<long long>(out_off) + out_bytes <=
                        static_cast<long long>(n_seg) * seg_bytes;
  const bool words = elem_bytes % 4 == 0 && seg_bytes % 4 == 0 && out_off % 4 == 0 &&
                     out_bytes % 4 == 0;
  const bool bulk = seg_bytes % 16 == 0 && (base * elem_bytes) % 16 == 0 &&
                    (idx == nullptr || elem_bytes % 16 == 0);
  if (!fits || !words || (route != 0 && route != 1) || (route == 0 && !bulk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem_bytes = (seg_bytes + 127) / 128 * 128;
  copy_probe_kernel<<<n_seg, kThreads, smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), idx, base, elem_bytes, seg_bytes, out_off,
      out_bytes, static_cast<unsigned char*>(out), route);
  return static_cast<int>(cudaGetLastError());
}
