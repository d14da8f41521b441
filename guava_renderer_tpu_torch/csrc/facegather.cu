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
// Design: one thread per (texel, 4-channel quad). blockIdx.y picks the quad,
// so a warp covers 32 consecutive texels of one quad: its float4 loads hit
// the same or neighbouring table rows (the ids are sorted by face, so
// consecutive texels share rows and the table stays in L2), and each of its
// four channel stores writes 128 contiguous bytes of the channel-major
// (16, N) output.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 16;
constexpr int kQuads = kChannels / 4;
constexpr int kThreads = 256;

__global__ void face_gather_kernel(const float4* __restrict__ table,
                                   const int* __restrict__ ids,
                                   float* __restrict__ out, int n) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const int q = blockIdx.y;
  const float4 v = __ldg(&table[static_cast<int64_t>(ids[t]) * kQuads + q]);
  float* o = out + static_cast<int64_t>(4 * q) * n + t;
  o[0] = v.x;
  o[static_cast<int64_t>(n)] = v.y;
  o[2 * static_cast<int64_t>(n)] = v.z;
  o[3 * static_cast<int64_t>(n)] = v.w;
}

}  // namespace

// table (Fc, 16) f32, ids (n,) i32 in [0, Fc), out (16, n) f32.
extern "C" int guava_face_gather(const float* table, const int* ids, float* out,
                                 int n, void* stream) {
  if (n > 0) {
    const dim3 grid((n + kThreads - 1) / kThreads, kQuads);
    face_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(table), ids, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}
