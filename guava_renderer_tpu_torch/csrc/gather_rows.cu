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
// a fraction of a microsecond at 3.35 TB/s, so the launch is the time.
//
// Design: one thread per (row, 16-byte quad): consecutive threads copy
// consecutive quads of a row, so the stores are coalesced and a row's reads
// are one contiguous 176-byte run. The copy is exact.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRow4 = 11;            // float4 a 44-float row
constexpr int kThreads = 256;

__global__ void gather_rows_kernel(const float4* __restrict__ rows, const int* __restrict__ ids,
                                   float4* __restrict__ out, int n_quads) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_quads) return;
  const int l = i / kRow4;
  out[i] = rows[static_cast<int64_t>(ids[l]) * kRow4 + (i - l * kRow4)];
}

}  // namespace

// rows (P, 44) f32, ids (L,) i32 in [0, P) -> out (L, 44) f32.
extern "C" int guava_gather_rows(const float* rows, const int* ids, float* out, int n,
                                 void* stream) {
  const int n_quads = n * kRow4;
  if (n_quads > 0) {
    gather_rows_kernel<<<(n_quads + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(rows), ids, reinterpret_cast<float4*>(out), n_quads);
  }
  return static_cast<int>(cudaGetLastError());
}
