// Face-table gather for the planned UV deformer: rows[c, t] = table[ids[t], c].
//
// Replaces guava_renderer_tpu/ops/facegather.py:_fwd_kernel (the forward of
// face_window_gather). On the TPU that kernel turns the gather into one-hot
// MXU matmuls over a 384-face window, because a TPU row gather costs ~20 ns
// a row. A Hopper SM gathers natively, so there is no one-hot and no window.
//
// Bound on the H100: bytes. At the bench avatar (N = 176,128 texels,
// Fc ~ 20k faces) the kernel must write 16 x N f32 = 11.3 MB, read N ids
// (0.7 MB) and at most the whole 64-byte-a-row table (<= 1.3 MB): ~13 MB,
// ~4 us at 3.35 TB/s. There is no arithmetic.
//
// Design: a thread owns a run of kRun = 4 consecutive texels and all 16
// channels. It reads the run's ids as one 16-byte load, then the four
// 64-byte table rows as sixteen 16-byte loads, all in flight at once: the
// plan sorts the ids by face, so neighbours mostly share a row and the
// repeats hit L1 (on an H100 that beat branching to reuse the registers of
// the texel before, which serialised the loads). Each id is read once (the
// thread-a-(texel, quad) design this replaces read each four times). It
// writes each channel's four texels as one 16-byte store, so a warp writes
// 512 contiguous bytes of every channel row of the channel-major (16, N)
// output, with streaming stores (`__stcs`: nothing here reads the output
// again; plain stores took 1.2x as long on an H100). A grid sized to the
// SMs walks the runs in a grid-stride loop. Where N % 4 != 0 or the ids do
// not start on 16 bytes, the same loop reads and writes one float at a
// time (the last run then holds fewer texels).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kChannels = 16;
constexpr int kQuads = kChannels / 4;
constexpr int kRun = 4;          // texels a thread
constexpr int kThreads = 128;
constexpr int kCtasPerSm = 16;

template <bool kVector>
__global__ void __launch_bounds__(kThreads) face_gather_kernel(
    const float4* __restrict__ table, const int* __restrict__ ids, float* __restrict__ out,
    int n) {
  const int64_t runs = (static_cast<int64_t>(n) + kRun - 1) / kRun;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; r < runs;
       r += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t t0 = r * kRun;
    const int m = static_cast<int>(min(static_cast<long long>(kRun), static_cast<long long>(n - t0)));
    int id[kRun];
    if (kVector) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(ids) + r);
      id[0] = v.x; id[1] = v.y; id[2] = v.z; id[3] = v.w;
    } else {
      id[0] = __ldg(ids + t0);
#pragma unroll
      for (int k = 1; k < kRun; ++k) id[k] = k < m ? __ldg(ids + t0 + k) : id[k - 1];
    }
    float4 row[kRun][kQuads];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const float4* src = table + static_cast<int64_t>(id[k]) * kQuads;
#pragma unroll
      for (int q = 0; q < kQuads; ++q) row[k][q] = __ldg(src + q);
    }
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * q + j;
        float v[kRun];
#pragma unroll
        for (int k = 0; k < kRun; ++k) {
          const float4 x = row[k][q];
          v[k] = j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
        }
        float* o = out + static_cast<int64_t>(c) * n + t0;
        if (kVector) {
          __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
        } else {
#pragma unroll
          for (int k = 0; k < kRun; ++k) {
            if (k < m) __stcs(o + k, v[k]);
          }
        }
      }
    }
  }
}

// CTAs for `runs` runs: one a run's thread, at most kCtasPerSm an SM
int grid_for(int64_t runs) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t needed = (runs + kThreads - 1) / kThreads;
  return static_cast<int>(std::min(needed, static_cast<int64_t>(std::max(sms, 1)) * kCtasPerSm));
}

}  // namespace

// table (Fc, 16) f32, ids (n,) i32 in [0, Fc), out (16, n) f32 on 16 bytes.
// One launch when n > 0.
extern "C" int guava_face_gather(const float* table, const int* ids, float* out, int n,
                                 void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t runs = (static_cast<int64_t>(n) + kRun - 1) / kRun;
    const int grid = grid_for(runs);
    const auto* t4 = reinterpret_cast<const float4*>(table);
    if (n % kRun == 0 && reinterpret_cast<uintptr_t>(ids) % 16 == 0) {
      face_gather_kernel<true><<<grid, kThreads, 0, s>>>(t4, ids, out, n);
    } else {
      face_gather_kernel<false><<<grid, kThreads, 0, s>>>(t4, ids, out, n);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs an SM of the 16-byte-store kernel
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); it uses no shared memory.
extern "C" int guava_face_gather_occupancy(int* ctas, int* smem_bytes) {
  *smem_bytes = 0;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, face_gather_kernel<true>, kThreads, 0));
}
