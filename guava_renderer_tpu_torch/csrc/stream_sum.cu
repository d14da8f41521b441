// T3: the contiguous block stream of the payload-sort probe. It sums an
// (M, 128) f32 table over its rows into (1, 128), reading it in 512-row
// blocks.
//
// Replaces the kernel `stream` of tools/sort_payload_bench.py (:133), which
// prices the contiguous read a payload-carrying sort would let the blend do
// instead of a row gather: (512, 128) blocks double-buffered by DMA and
// summed into a (1, 128) accumulator.
//
// Bound on the H100: bytes. Every row is read once: 809,984 rows of 512 B
// are 414.7 MB, 0.124 ms at 3.35 TB/s; the 128 sums a row are far below the
// card's FP32 rate.
//
// Design: a 512-row block is 256 KB, more than a CTA's shared memory, so
// each block is read as four 128-row pieces of 64 KB by the bulk copy
// engine into two shared-memory slots (piece p + 1 in flight while piece p
// is summed), each slot with its mbarrier expecting the piece's bytes. The
// blocks are split into runs, one a CTA; thread j of a CTA sums column j of
// its run's rows in order into a partial; a second pass adds the CTAs'
// partials in CTA order, so the sum is the same at every run.

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

using namespace guava_copy;

constexpr int kCols = 128;
constexpr int kBlockRows = 512;
constexpr int kPieceRows = 128;                        // a slot: 64 KB
constexpr int kPieces = kBlockRows / kPieceRows;
constexpr uint32_t kPieceBytes = kPieceRows * kCols * 4;
constexpr int kSmemBytes = 2 * kPieceBytes + 64;       // two slots and their barriers

__global__ void __launch_bounds__(kCols) stream_sum_kernel(const float* __restrict__ table,
                                                           int64_t n_blocks,
                                                           float* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* slots = reinterpret_cast<float*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * kPieceBytes);
  const int j = threadIdx.x;
  const int64_t first = n_blocks * blockIdx.x / gridDim.x * kPieces;
  const int64_t last = n_blocks * (blockIdx.x + 1) / gridDim.x * kPieces;   // pieces [first, last)
  if (j == 0) {
    barrier_init(&bars[0]);
    barrier_init(&bars[1]);
    fence_barrier_init();
  }
  __syncthreads();

  auto issue = [&](int64_t piece, int s) {
    if (j == 0) {
      expect_bytes(&bars[s], kPieceBytes);
      bulk_copy(slots + s * kPieceRows * kCols, table + piece * kPieceRows * kCols, kPieceBytes,
                &bars[s]);
    }
  };

  float acc = 0.0f;
  uint32_t phase[2] = {0, 0};
  if (first < last) issue(first, 0);
  for (int64_t p = first; p < last; ++p) {
    const int s = static_cast<int>((p - first) & 1);
    if (p + 1 < last) issue(p + 1, s ^ 1);   // that slot was freed by the last barrier
    wait_parity(&bars[s], phase[s]);
    phase[s] ^= 1;
    const float* rows = slots + s * kPieceRows * kCols;
    for (int r = 0; r < kPieceRows; ++r) acc = __fadd_rn(acc, rows[r * kCols + j]);
    __syncthreads();                         // slot s is read: the next piece may land in it
  }
  partials[static_cast<int64_t>(blockIdx.x) * kCols + j] = acc;
}

// out[j] = sum over CTAs b, in order, of partials[b, j].
__global__ void add_partials_kernel(const float* __restrict__ partials, int n_ctas,
                                    float* __restrict__ out) {
  const int j = threadIdx.x;
  float acc = 0.0f;
  for (int b = 0; b < n_ctas; ++b) acc = __fadd_rn(acc, partials[b * kCols + j]);
  out[j] = acc;
}

}  // namespace

// table (n_rows, 128) f32 with n_rows a multiple of 512; partials (n_ctas,
// 128) f32 scratch -> out (1, 128) f32, the sum over the rows.
extern "C" int guava_stream_sum(const float* table, float* partials, float* out, int n_rows,
                                int n_ctas, void* stream) {
  if (n_rows < 0 || n_rows % kBlockRows != 0 || n_ctas < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(stream_sum_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  stream_sum_kernel<<<n_ctas, kCols, kSmemBytes, s>>>(table, n_rows / kBlockRows, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  add_partials_kernel<<<1, kCols, 0, s>>>(partials, n_ctas, out);
  return static_cast<int>(cudaGetLastError());
}
