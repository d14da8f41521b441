// Forward tile blend of the 32-channel Gaussian rasterizer.
//
// Replaces guava_renderer_tpu/ops/gsplat.py:_fwd_kernel (reached through
// blend_tiles <- rasterize_blend). Per image tile it composites the tile's
// depth-sorted instances front to back with the renderCUDA<32> semantics:
// alpha = min(0.99, a * exp(power)), skipped when power > 0 or
// alpha < 1/255; a pixel stops for good once T would fall below 1e-4;
// out = sum(w * color) + bg * T, expected inverse depth as channel 32.
//
// Bound on the H100: operations. Every (instance, pixel) pair the tiles
// visit costs an exp and ~15 FP32 operations for the conic and the test,
// and every pair that contributes ~35 FMAs into the 33 accumulators. The
// bytes are small beside that: each instance's 176-byte row is read once
// (~94 MB at the 512^2 bench frame's 533k instances) and the image written
// once (~36 MB).
//
// Design (not the TPU kernel block by block): one CTA per tile, one thread
// per pixel, as in renderCUDA. The TPU kernel's chunked cumulative product
// and MXU matmul exist to use its vector and matrix units; here each thread
// walks the instances sequentially, keeping T and its 33 accumulators in
// registers. The CTA stages the next kBatch instances' rows in shared
// memory cooperatively (a gather through `order`, 16-byte loads; the staging
// and the contribution test live in blend_common.cuh, shared with the
// backward, which must replay the same decisions) and every
// thread then reads them as broadcasts. A round starts with
// __syncthreads_count, which both frees the staging buffer and ends the
// tile once every pixel is done. Rows are 44 floats (8 geometry + 32 colors
// + invdepth + 3 pad), not the TPU's 128-lane row, which existed only for
// DMA alignment. The image is written directly in (H, W, 32) layout.

#include <cuda_runtime.h>

#include <cstdint>

#include "blend_common.cuh"

namespace {

using namespace guava_blend;

__global__ void __launch_bounds__(1024) blend_fwd_kernel(
    const float4* __restrict__ rows, const int* __restrict__ order,
    const int* __restrict__ ranges, const float* __restrict__ bg,
    float* __restrict__ color, float* __restrict__ invdepth,
    float* __restrict__ final_t, int width, int tile, int grid_x) {
  __shared__ float4 stage[kBatch * kRow4];

  const int tid = threadIdx.x;
  const int tile_id = blockIdx.x;
  const int px = (tile_id % grid_x) * tile + tid % tile;
  const int py = (tile_id / grid_x) * tile + tid / tile;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = ranges[tile_id];
  const int end = ranges[tile_id + 1];

  float acc[kChannels + 1];
#pragma unroll
  for (int c = 0; c <= kChannels; ++c) acc[c] = 0.0f;
  float T = 1.0f;
  bool done = false;

  for (int base = start; base < end; base += kBatch) {
    // Also the barrier that frees the previous round's staging buffer.
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(kBatch, end - base);
    stage_rows(stage, nullptr, rows, order, base, n);
    __syncthreads();
    if (done) continue;
    const float* s = reinterpret_cast<const float*>(stage);
    for (int j = 0; j < n; ++j, s += kRow) {
      // the decisions below are replayed by blend_bwd.cu: keep them as they are
      float d0, d1;
      const float power = gauss_power(s, fx, fy, d0, d1);
      if (power > 0.0f) continue;
      const float ag = __fmul_rn(s[5], expf(power));
      if (ag < kAlphaMin) continue;
      const float alpha = fminf(kAlphaMax, ag);
      const float test_t = next_t(T, alpha);
      if (test_t < kTMin) {
        done = true;
        break;
      }
      const float w = __fmul_rn(alpha, T);
#pragma unroll
      for (int c = 0; c <= kChannels; ++c) acc[c] += w * s[kGeom + c];
      T = test_t;
    }
  }

  const int64_t pix = static_cast<int64_t>(py) * width + px;
  float4* out4 = reinterpret_cast<float4*>(color + pix * kChannels);
#pragma unroll
  for (int c = 0; c < kChannels; c += 4) {
    out4[c / 4] = make_float4(acc[c] + T * bg[c], acc[c + 1] + T * bg[c + 1],
                              acc[c + 2] + T * bg[c + 2], acc[c + 3] + T * bg[c + 3]);
  }
  invdepth[pix] = acc[kChannels];
  final_t[pix] = T;
}

}  // namespace

// rows (P, 44) f32, order (N,) i32, ranges (gy*gx + 1,) i32 (tiles row-major),
// bg (32,) f32 -> color (H, W, 32), invdepth (H, W), final_t (H, W) f32.
// H and W are multiples of tile, and tile * tile <= 1024.
extern "C" int guava_blend_fwd(const float* rows, const int* order, const int* ranges,
                               const float* bg, float* color, float* invdepth,
                               float* final_t, int height, int width, int tile,
                               void* stream) {
  const int grid_x = width / tile;
  const int n_tiles = grid_x * (height / tile);
  if (n_tiles > 0) {
    blend_fwd_kernel<<<n_tiles, tile * tile, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(rows), order, ranges, bg, color, invdepth,
        final_t, width, tile, grid_x);
  }
  return static_cast<int>(cudaGetLastError());
}
