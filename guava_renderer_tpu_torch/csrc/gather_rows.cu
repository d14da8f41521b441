// Row gather out[l] = rows[ids[l]] of (P, 44) f32 blend rows: builds the
// resident table of the size-classed blend (blend_resident.cu).
//
// Replaces guava_renderer_tpu/ops/gsplat.py:_gather_rows_kernel (reached
// through gather_rows). On the TPU an XLA row gather was slow enough that
// the JAX package issues one row DMA a row from a kernel; on Hopper a gather
// is plain loads.
//
// Bound on the H100: bytes. It reads L rows of 176 B and L ids and writes
// L rows: at the ubody ladder's two resident classes (L = 1,065) ~0.4 MB,
// a fraction of a microsecond at 3.35 TB/s. Alone the kernel is the launch
// floor and half a microsecond (PERF.md §6); where it runs, behind the
// ranking that picks the resident rows, its launch and the two elementwise
// kernels that decoded the ranking's keys were its cost.
//
// Design: one thread per (row, 16-byte quad): consecutive threads copy
// consecutive quads of a row, so the stores are coalesced and a row's reads
// are one contiguous 176-byte run. The copy is exact. Each thread loads its
// row's id itself (one lane a row and a shuffle timed the same). The
// frame's entry takes the ranking's int64 keys (score << id_bits | id) as
// they come out of topk, decodes the ids and writes them beside the table,
// so the frame launches no kernel between the ranking and the gather. The
// launch is a plain one: a programmatic dependent launch read 0.001 ms
// less in sequence, a gap no spread was measured for (PERF.md §6).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRow4 = 11;            // float4 a 44-float row
constexpr int kThreads = 256;

// kKeys: ids are int64 keys whose low bits (id_mask) are the id, and the
// decoded ids go to lids; else ids are int32 and lids is unused
template <bool kKeys>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const float4* __restrict__ rows, const void* __restrict__ ids, int64_t id_mask,
    float4* __restrict__ out, int* __restrict__ lids, int n_quads) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_quads) return;
  const int l = i / kRow4;
  const int q = i - l * kRow4;
  const int id = kKeys ? static_cast<int>(static_cast<const int64_t*>(ids)[l] & id_mask)
                       : static_cast<const int*>(ids)[l];
  out[i] = rows[static_cast<int64_t>(id) * kRow4 + q];
  if (kKeys && q == 0) lids[l] = id;
}

template <bool kKeys>
int launch(const float* rows, const void* ids, int64_t id_mask, float* out, int* lids, int n,
           void* stream) {
  const int n_quads = n * kRow4;
  if (n_quads <= 0) return static_cast<int>(cudaSuccess);
  gather_rows_kernel<kKeys><<<(n_quads + kThreads - 1) / kThreads, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(rows), ids, id_mask, reinterpret_cast<float4*>(out),
      lids, n_quads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows (P, 44) f32, ids (L,) i32 in [0, P) -> out (L, 44) f32.
extern "C" int guava_gather_rows(const float* rows, const int* ids, float* out, int n,
                                 void* stream) {
  return launch<false>(rows, ids, 0, out, nullptr, n, stream);
}

// rows (P, 44) f32, keys (L,) int64 whose low id_bits bits are ids in [0, P)
// -> out (L, 44) f32 the rows of those ids, lids (L,) i32 the ids.
extern "C" int guava_gather_resident(const float* rows, const int64_t* keys, int id_bits,
                                     float* out, int* lids, int n, void* stream) {
  if (id_bits < 1 || id_bits > 31) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(rows, keys, (int64_t{1} << id_bits) - 1, out, lids, n, stream);
}

// Resident CTAs an SM of the frame's entry, and its shared memory a CTA.
extern "C" int guava_gather_rows_occupancy(int* ctas, int* smem_bytes) {
  *smem_bytes = 0;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, gather_rows_kernel<true>, kThreads, 0));
}
