// Forward tile blend reading a per-instance stream (the rasterizer's
// streaming setting).
//
// Replaces guava_renderer_tpu/ops/gsplat.py:_fwd_stream_kernel (reached
// through blend_tiles_stream). The stream holds one (44,) f32 row per
// (Gaussian, tile) instance in the sorted order, so tile t's rows are
// stream[ranges[t] : ranges[t + 1]], contiguous: the blend reads no `order`
// and gathers nothing. Geometry is exact f32; colors and the inverse depth
// are bf16-rounded, the values the JAX package carries through its sort.
//
// Bound on the H100: operations, as K1's (blend.cu). The stream turns K1's
// gather of N rows from a P-row table (~33 MB at the 512^2 bench frame,
// gathered ~3 times over) into contiguous reads of N rows (~94 MB), and
// the blend's time is its arithmetic either way.
//
// Design: the whole-tile walk (blend_fwd.cuh) with a staging of contiguous,
// coalesced 16-byte loads: stage[i] = stream4[base * 11 + i]. Copying
// with cp.async or TMA bulk copies, and overlapping a round's copy with
// the walk of the last, is later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "blend_fwd.cuh"

namespace {

using namespace guava_blend;

// A round's rows: stream rows base .. base + n - 1, contiguous.
struct ReadStream {
  const float4* stream;
  __device__ void operator()(float4* stage, int base, int n) const {
    const float4* src = stream + static_cast<int64_t>(base) * kRow4;
    for (int i = threadIdx.x; i < n * kRow4; i += blockDim.x) stage[i] = src[i];
  }
};

__global__ void __launch_bounds__(1024) blend_stream_kernel(
    const float4* __restrict__ stream, const int* __restrict__ ranges,
    const float* __restrict__ bg, float* __restrict__ color, float* __restrict__ invdepth,
    float* __restrict__ final_t, int width, int tile, int grid_x) {
  blend_tile(ReadStream{stream}, ranges, bg, color, invdepth, final_t, width, tile, grid_x);
}

}  // namespace

// stream (N, 44) f32, ranges (gy*gx + 1,) i32 indexing it, bg (32,) f32
// -> color (H, W, 32), invdepth (H, W), final_t (H, W) f32.
// H and W are multiples of tile, and tile * tile <= 1024.
extern "C" int guava_blend_stream_fwd(const float* stream, const int* ranges, const float* bg,
                                      float* color, float* invdepth, float* final_t,
                                      int height, int width, int tile, void* stream_) {
  const int n_tiles = blend_tiles_of(height, width, tile);
  if (n_tiles > 0) {
    blend_stream_kernel<<<n_tiles, tile * tile, 0, static_cast<cudaStream_t>(stream_)>>>(
        reinterpret_cast<const float4*>(stream), ranges, bg, color, invdepth, final_t, width,
        tile, width / tile);
  }
  return static_cast<int>(cudaGetLastError());
}
