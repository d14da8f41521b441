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
// thread then reads them as broadcasts. The walk itself is blend_fwd.cuh's
// blend_tile, which K6, K7 and K8 share. Rows are 44 floats (8 geometry +
// 32 colors + invdepth + 3 pad), not the TPU's 128-lane row, which existed
// only for DMA alignment. The image is written directly in (H, W, 32)
// layout.

#include <cuda_runtime.h>

#include "blend_fwd.cuh"

namespace {

using namespace guava_blend;

// A round's rows: order[base : base + n] gathered from the (P, 44) table.
struct GatherRows {
  const float4* rows;
  const int* order;
  __device__ void operator()(float4* stage, int base, int n) const {
    stage_rows(stage, nullptr, rows, order, base, n);
  }
};

__global__ void __launch_bounds__(1024) blend_fwd_kernel(
    const float4* __restrict__ rows, const int* __restrict__ order,
    const int* __restrict__ ranges, const float* __restrict__ bg,
    float* __restrict__ color, float* __restrict__ invdepth,
    float* __restrict__ final_t, int width, int tile, int grid_x) {
  blend_tile(GatherRows{rows, order}, ranges, bg, color, invdepth, final_t, width, tile, grid_x);
}

}  // namespace

// rows (P, 44) f32, order (N,) i32, ranges (gy*gx + 1,) i32 (tiles row-major),
// bg (32,) f32 -> color (H, W, 32), invdepth (H, W), final_t (H, W) f32.
// H and W are multiples of tile, and tile * tile <= 1024.
extern "C" int guava_blend_fwd(const float* rows, const int* order, const int* ranges,
                               const float* bg, float* color, float* invdepth,
                               float* final_t, int height, int width, int tile,
                               void* stream) {
  const int n_tiles = blend_tiles_of(height, width, tile);
  if (n_tiles > 0) {
    blend_fwd_kernel<<<n_tiles, tile * tile, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(rows), order, ranges, bg, color, invdepth,
        final_t, width, tile, width / tile);
  }
  return static_cast<int>(cudaGetLastError());
}
