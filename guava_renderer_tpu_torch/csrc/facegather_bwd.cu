// Backward of the planned deformer's face-table gather:
// d_table[f, c] = sum over the texels t with ids[t] == f of drows[c, t].
//
// Replaces guava_renderer_tpu/ops/facegather.py:_bwd_kernel (the custom_vjp
// of face_window_gather). On the TPU that kernel multiplies each 256-texel
// chunk of drows with a transposed one-hot over a 384-face window and adds
// the product into a resident accumulator; it is race-free only because the
// TPU grid runs in sequence.
//
// Bound on the H100: bytes. At the bench avatar (N = 176,128 texels,
// Fc ~ 20k faces) it must read 16 x N f32 = 11.3 MB of drows and the Fc + 1
// segment starts, and write the 64-byte-a-row table (1.3 MB): ~13 MB, ~4 us
// at 3.35 TB/s. One addition a value read.
//
// Design: the ids are static and sorted by face, so a face's texels are one
// contiguous segment [seg[f], seg[f + 1]) that the plan computes once. The
// kernel is a segmented sum with no atomics, no one-hot and no accumulator
// that outlives a thread: one thread per (face, channel) walks its segment
// in ascending texel order and writes d_table[f, c] once. blockIdx.y picks
// the channel, so a warp covers 32 consecutive faces of one channel: their
// segments lie end to end in one row of drows (about 9 texels a face at the
// bench avatar, ~1.1 KB a warp), so every line the warp touches is used in
// full out of L1. The order of additions is fixed (ascending t, the order
// of a sequential index_add_), so two runs give the same bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 16;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) face_gather_bwd_kernel(
    const float* __restrict__ drows, const int* __restrict__ seg,
    float* __restrict__ d_table, int n, int n_faces) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= n_faces) return;
  const int c = blockIdx.y;
  const int end = seg[f + 1];
  const float* src = drows + static_cast<int64_t>(c) * n;
  float sum = 0.0f;
  for (int t = seg[f]; t < end; ++t) sum += src[t];
  d_table[static_cast<int64_t>(f) * kChannels + c] = sum;
}

}  // namespace

// drows (16, n) f32, seg (n_faces + 1,) i32 ascending segment starts with
// seg[0] = 0 and seg[n_faces] = n, d_table (n_faces, 16) f32 (every entry is
// written; an empty segment gives zeros).
extern "C" int guava_face_gather_bwd(const float* drows, const int* seg, float* d_table,
                                     int n, int n_faces, void* stream) {
  if (n_faces > 0) {
    const dim3 grid((n_faces + kThreads - 1) / kThreads, kChannels);
    face_gather_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        drows, seg, d_table, n, n_faces);
  }
  return static_cast<int>(cudaGetLastError());
}
