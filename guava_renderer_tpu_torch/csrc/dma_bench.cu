// T2: the row-gather bench. Per chunk of G = 32 instances it copies table
// rows into shared memory and reads the first value of the chunk's first
// row; the result is the sum of those values over the chunks.
//
// Replaces the kernels of tools/dma_bench.py (make_variant, :210, and
// make_pipelined, :128), which time the TPU's row DMAs. Each variant keeps
// its copy pattern, with the TPU's byte-counted DMA semaphores as mbarriers
// that expect the chunk's bytes (async_copy.cuh):
//   contig        one bulk copy of G contiguous rows from row (c*7 mod 1024)*G
//   rows          one bulk copy a row, rows idx[c*G + g], on `banks`
//                 mbarriers (row g on barrier g % banks, each expecting
//                 G/banks rows): the TPU's rows and rowsB<k>
//   pairs         one bulk copy of rows (idx, idx + 1) for every even g:
//                 the TPU's rows_pipe_2rows
// each either one chunk at a time or pipelined (_pipe): two slots, chunk
// c + 1 in flight while chunk c is read. Rows are 512 bytes (f32) or 256
// (bf16, the TPU's rows_pipe_bf16).
//
// Bound on the H100: bytes, G rows a chunk read once (the staged rows
// written once more in check mode): 262,144 rows of 512 B are 134 MB, 40 us
// at 3.35 TB/s. What the bench measures is how near each copy pattern gets.
//
// Design: the chunks are split into runs, one a CTA, and each CTA walks its
// run in order, so many CTAs keep copies in flight (the TPU walks them on
// one core). Warp 0 issues the copies, one lane a row; all threads wait on
// the barrier parity and, in check mode, copy the staged rows out with
// 16-byte stores. Each chunk's value goes to vals[c], and a second pass adds
// them in chunk order in f32, the adds the TPU's sequential grid makes, so
// the sum equals the plain version's (kernels/rowcopy.py) bit for bit. That
// chain of 8,192 dependent adds costs ~20 us at the defaults, half the
// copies' bound: the price of an exact, deterministic result. A caller that
// times the copies passes no `out`, and the second pass is not launched.

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

using namespace guava_copy;

constexpr int G = 32;              // rows a chunk
constexpr int kMaxRowBytes = 512;  // f32 rows of 128 lanes
constexpr int kThreads = 128;

enum Source { kContig = 0, kRows = 1, kPairs = 2 };

__device__ __forceinline__ float first_value(const unsigned char* row, int row_bytes) {
  if (row_bytes == kMaxRowBytes) return *reinterpret_cast<const float*>(row);
  // bf16 row: widen the first value (bf16 is the high half of an f32)
  const uint32_t bits = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(row)) << 16;
  return __uint_as_float(bits);
}

__global__ void __launch_bounds__(kThreads) row_copy_kernel(
    const unsigned char* __restrict__ table, const int* __restrict__ idx, int row_bytes,
    int source, int pipelined, int banks, int64_t n_chunks, float* __restrict__ vals,
    unsigned char* __restrict__ staged) {
  __shared__ __align__(128) unsigned char buf[2][G * kMaxRowBytes];
  __shared__ __align__(8) uint64_t bars[2][G];

  const int tid = threadIdx.x;
  const int64_t c_begin = n_chunks * blockIdx.x / gridDim.x;
  const int64_t c_end = n_chunks * (blockIdx.x + 1) / gridDim.x;
  const uint32_t chunk_bytes = static_cast<uint32_t>(G * row_bytes);
  if (tid == 0) {
    for (int s = 0; s < 2; ++s)
      for (int b = 0; b < banks; ++b) barrier_init(&bars[s][b]);
    fence_barrier_init();
  }
  __syncthreads();

  // warp 0 starts chunk c's copies into slot s
  auto issue = [&](int64_t c, int s) {
    if (tid >= 32) return;
    if (tid == 0) {
      for (int b = 0; b < banks; ++b) expect_bytes(&bars[s][b], chunk_bytes / banks);
    }
    __syncwarp();
    unsigned char* dst = buf[s];
    if (source == kContig) {
      if (tid == 0) {
        const int64_t row0 = static_cast<int64_t>((c * 7) % 1024) * G;
        bulk_copy(dst, table + row0 * row_bytes, chunk_bytes, &bars[s][0]);
      }
    } else if (source == kRows) {
      const int64_t row = idx[c * G + tid];
      bulk_copy(dst + tid * row_bytes, table + row * row_bytes, row_bytes, &bars[s][tid % banks]);
    } else if (tid % 2 == 0) {
      const int64_t row = idx[c * G + tid];
      bulk_copy(dst + tid * row_bytes, table + row * row_bytes, 2 * row_bytes, &bars[s][0]);
    }
  };

  uint32_t phase[2] = {0, 0};
  if (pipelined && c_begin < c_end) issue(c_begin, 0);
  for (int64_t c = c_begin; c < c_end; ++c) {
    const int s = pipelined ? static_cast<int>((c - c_begin) & 1) : 0;
    if (pipelined) {
      if (c + 1 < c_end) issue(c + 1, s ^ 1);  // that slot was freed by the last barrier
    } else {
      issue(c, 0);
    }
    for (int b = 0; b < banks; ++b) wait_parity(&bars[s][b], phase[s]);
    phase[s] ^= 1;
    if (tid == 0) vals[c] = first_value(buf[s], row_bytes);
    if (staged != nullptr) {
      const uint4* src = reinterpret_cast<const uint4*>(buf[s]);
      uint4* out = reinterpret_cast<uint4*>(staged + c * chunk_bytes);
      for (uint32_t i = tid; i < chunk_bytes / 16; i += kThreads) out[i] = src[i];
    }
    __syncthreads();  // slot s is read: the next chunk may copy into it
  }
}

constexpr int kSumThreads = 1024;
constexpr int kSumTile = 8192;     // values staged in shared memory at a time (32 KB)

// out[0] = vals[0] + vals[1] + ... in chunk order, one f32 add at a time: the
// CTA stages the values in shared memory with coalesced loads and thread 0
// adds them there, so the chain of adds, not the loads' latency, is the time.
__global__ void __launch_bounds__(kSumThreads) sum_in_order_kernel(
    const float* __restrict__ vals, int64_t n, float* __restrict__ out) {
  __shared__ float tile[kSumTile];
  float acc = 0.0f;
  for (int64_t base = 0; base < n; base += kSumTile) {
    const int m = static_cast<int>(n - base < kSumTile ? n - base : kSumTile);
    for (int i = threadIdx.x; i < m; i += kSumThreads) tile[i] = vals[base + i];
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll 16
      for (int i = 0; i < m; ++i) acc = __fadd_rn(acc, tile[i]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = acc;
}

}  // namespace

// table (p_rows, row_bytes) f32 or bf16 rows (row_bytes 512 or 256); idx:
// G * n_chunks row ids (in [0, p_rows), [0, p_rows - 1) for pairs; unread by
// contig, whose rows (c*7 mod 1024)*G + G must lie in the table); source
// 0 contig, 1 rows, 2 pairs; banks divides G (1 unless rows); n_ctas >= 1
// -> vals (n_chunks,) f32, out (1,) f32 unless out is null (then only the
// copies run) and, unless staged is null, staged (n_chunks * G, row_bytes)
// the rows as copied.
extern "C" int guava_row_copy(const void* table, const int* idx, int row_bytes, int source,
                              int pipelined, int banks, int n_chunks, int n_ctas, float* vals,
                              void* staged, float* out, void* stream) {
  if ((row_bytes != 512 && row_bytes != 256) || source < 0 || source > 2 || banks < 1 ||
      banks > G || G % banks != 0 || (source != kRows && banks != 1) || n_chunks < 0 ||
      n_ctas < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0) {
    row_copy_kernel<<<n_ctas, kThreads, 0, s>>>(
        static_cast<const unsigned char*>(table), idx, row_bytes, source, pipelined, banks,
        n_chunks, vals, static_cast<unsigned char*>(staged));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (out == nullptr) return static_cast<int>(cudaSuccess);
  sum_in_order_kernel<<<1, kSumThreads, 0, s>>>(vals, n_chunks, out);
  return static_cast<int>(cudaGetLastError());
}
