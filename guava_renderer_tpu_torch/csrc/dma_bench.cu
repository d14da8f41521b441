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
// each either one chunk at a time or pipelined (_pipe): kSlots chunks in
// flight. Rows are 512 bytes (f32) or 256 (bf16, the TPU's rows_pipe_bf16).
//
// Bound on the H100: bytes, the distinct rows read once (the staged rows
// written once more in check mode): the random ids read 165,585 distinct
// rows of 512 B, 85 MB, 25 us at 3.35 TB/s. What the bench measures is how
// near each copy pattern gets.
//
// Design: a persistent grid of as many CTAs as fit on the card (chip_smoke
// phase 12 prints them); the chunks are split into runs, one a CTA, walked
// in order. In each CTA warp 0 produces and warps 1-3 read. The producer
// copies a chunk into a slot of a ring in dynamic shared memory, one lane a
// row, each slot with a "full" mbarrier that counts the chunk's bytes
// (`banks` of them for rows) and an "empty" mbarrier on which each reader
// warp arrives once it has read the slot; a slot is reused as soon as its
// empty barrier completes, with no __syncthreads a chunk. Each lane keeps
// its row ids of the next kSlots chunks in registers, loaded kSlots chunks
// ahead, so no id load stands between a freed slot and its copies. The
// variants without _pipe use one slot: one chunk in flight a CTA.
//
// Ring depth and grid (PERF.md §6): one producer warp issues a
// chunk's 32 row copies in ~1.5 us however many slots it may fill, so the
// copies in flight scale with producer warps, not with slots: at one or two
// CTAs an SM the pipelined gathers took up to 3.6x as long as on the old
// grid of 6 CTAs an SM, at 4 or 8 slots as at 2; four producer warps a CTA
// lifted them, and two slots at 6 CTAs an SM were fastest. In check
// mode the reader warps copy the staged rows out with 16-byte stores. Each
// chunk's value goes to vals[c], and a second pass adds them in chunk order
// in f32, the adds the TPU's sequential grid makes, so the sum equals the
// plain version's (kernels/rowcopy.py) bit for bit. That chain of 8,192
// dependent adds costs ~20 us at the defaults, the price of an exact,
// deterministic result. A caller that times the copies passes no `out`, and
// the second pass is not launched.

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

using namespace guava_copy;

constexpr int G = 32;              // rows a chunk
constexpr int kMaxRowBytes = 512;  // f32 rows of 128 lanes
constexpr int kSlotBytes = G * kMaxRowBytes;
constexpr int kSlots = 2;          // ring depth of the _pipe variants
constexpr int kThreads = 128;      // warp 0 copies, warps 1-3 read
constexpr int kReaders = kThreads / 32 - 1;

enum Source { kContig = 0, kRows = 1, kPairs = 2 };

// An mbarrier whose phase completes after `count` arrivals.
__device__ __forceinline__ void barrier_init_count(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void barrier_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ float first_value(const unsigned char* row, int row_bytes) {
  if (row_bytes == kMaxRowBytes) return *reinterpret_cast<const float*>(row);
  // bf16 row: widen the first value (bf16 is the high half of an f32)
  const uint32_t bits = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(row)) << 16;
  return __uint_as_float(bits);
}

// Dynamic shared memory of a CTA with `slots` slots: the slots, then G full
// barriers a slot, then one empty barrier a slot.
constexpr size_t smem_bytes(int slots) {
  return static_cast<size_t>(slots) * (kSlotBytes + (G + 1) * sizeof(uint64_t));
}
static_assert(smem_bytes(kSlots) <= 48 * 1024, "a deeper ring needs cudaFuncSetAttribute");

__global__ void __launch_bounds__(kThreads) row_copy_kernel(
    const unsigned char* __restrict__ table, const int* __restrict__ idx, int row_bytes,
    int source, int slots, int banks, int64_t n_chunks, float* __restrict__ vals,
    unsigned char* __restrict__ staged) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + slots * kSlotBytes);
  uint64_t* empty = full + slots * G;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int64_t c_begin = n_chunks * blockIdx.x / gridDim.x;
  const int64_t n = n_chunks * (blockIdx.x + 1) / gridDim.x - c_begin;
  const uint32_t chunk_bytes = static_cast<uint32_t>(G * row_bytes);
  if (tid == 0) {
    for (int s = 0; s < slots; ++s) {
      for (int b = 0; b < banks; ++b) barrier_init_count(&full[s * G + b], 1);
      barrier_init_count(&empty[s], kReaders);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 32) {
    // lane g's row ids of the next kSlots chunks
    int ahead[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      ahead[j] = (source != kContig && j < n) ? idx[(c_begin + j) * G + lane] : 0;
    }
    for (int64_t k0 = 0; k0 < n; k0 += kSlots) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int64_t k = k0 + j;
        if (k >= n) break;
        const int64_t c = c_begin + k;
        const int row_id = ahead[j];
        if (source != kContig && k + kSlots < n) ahead[j] = idx[(c + kSlots) * G + lane];
        const int s = slots == 1 ? 0 : j;
        // the slot's last chunk, k - slots, has been read
        if (k >= slots) wait_parity(&empty[s], static_cast<uint32_t>((k / slots - 1) & 1));
        uint64_t* bar = &full[s * G];
        unsigned char* dst = smem + s * kSlotBytes;
        if (lane == 0) {
          for (int b = 0; b < banks; ++b) expect_bytes(&bar[b], chunk_bytes / banks);
        }
        __syncwarp();
        if (source == kContig) {
          if (lane == 0) {
            const int64_t row0 = static_cast<int64_t>((c * 7) % 1024) * G;
            bulk_copy(dst, table + row0 * row_bytes, chunk_bytes, &bar[0]);
          }
        } else if (source == kRows) {
          bulk_copy(dst + lane * row_bytes, table + static_cast<int64_t>(row_id) * row_bytes,
                    row_bytes, &bar[lane % banks]);
        } else if (lane % 2 == 0) {
          bulk_copy(dst + lane * row_bytes, table + static_cast<int64_t>(row_id) * row_bytes,
                    2 * row_bytes, &bar[0]);
        }
      }
    }
  } else {
    for (int64_t k = 0; k < n; ++k) {
      const int s = static_cast<int>(k % slots);
      const uint32_t phase = static_cast<uint32_t>((k / slots) & 1);
      for (int b = 0; b < banks; ++b) wait_parity(&full[s * G + b], phase);
      const unsigned char* src = smem + s * kSlotBytes;
      const int64_t c = c_begin + k;
      if (tid == 32) vals[c] = first_value(src, row_bytes);
      if (staged != nullptr) {
        const uint4* from = reinterpret_cast<const uint4*>(src);
        uint4* to = reinterpret_cast<uint4*>(staged + c * chunk_bytes);
        for (uint32_t i = tid - 32; i < chunk_bytes / 16; i += kThreads - 32) to[i] = from[i];
      }
      __syncwarp();
      if (lane == 0) barrier_arrive(&empty[s]);
    }
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

// Resident CTAs an SM of the pipelined variants (pipelined != 0) or of the
// others, and their dynamic shared memory a CTA; the wrapper sizes the grid
// by it.
extern "C" int guava_row_copy_occupancy(int pipelined, int* ctas, int* smem) {
  *smem = static_cast<int>(smem_bytes(pipelined ? kSlots : 1));
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, row_copy_kernel, kThreads, *smem));
}

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
    const int slots = pipelined ? kSlots : 1;
    row_copy_kernel<<<n_ctas, kThreads, smem_bytes(slots), s>>>(
        static_cast<const unsigned char*>(table), idx, row_bytes, source, slots, banks,
        n_chunks, vals, static_cast<unsigned char*>(staged));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (out == nullptr) return static_cast<int>(cudaSuccess);
  sum_in_order_kernel<<<1, kSumThreads, 0, s>>>(vals, n_chunks, out);
  return static_cast<int>(cudaGetLastError());
}
