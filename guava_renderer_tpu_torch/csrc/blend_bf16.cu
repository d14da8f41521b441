// Forward tile blend on bf16-packed rows (the rasterizer's bf16_rows
// setting).
//
// Replaces guava_renderer_tpu/ops/gsplat.py:_fwd_kernel in its
// bf16_rows=True branch (reached through blend_tiles_bf16). A packed row is
// 56 bf16 (112 bytes, a multiple of 16): the 8 geometry values as bf16 hi
// and lo halves (value = hi + lo), then the 32 colors and the inverse depth
// as plain bf16, then zeros (kernels/blend.py:pack_rows_bf16).
//
// Bound on the H100: operations, as K1's (blend.cu). The packing halves the
// bytes of the row gather (112 B a row against 176 B), but at the 512^2
// bench frame those bytes are ~60 MB against ~2.5 GFLOP of blending, so the
// halving is not expected to show in the time.
//
// Design: the whole-tile walk (blend_fwd.cuh) with another staging. A thread of the
// CTA reads 8 bytes of a packed row (for the geometry 8 bytes of hi and 8
// of lo) and writes one float4 of the f32 row into shared memory:
// geometry = __fadd_rn(hi, lo), colors widened exactly (a bf16 is the top
// half of a float). The walk then runs on exactly the f32 values that
// kernels/blend.py:unpack_rows_bf16 gives, so K1 on the unpacked rows
// renders the same image bit for bit, and K3 replays it from them.

#include <cuda_runtime.h>

#include <cstdint>

#include "blend_fwd.cuh"

namespace {

using namespace guava_blend;

constexpr int kPacked = 56;                 // bf16 a packed row
constexpr int kPacked2 = kPacked / 4;       // 14 uint2 (four bf16 each) a row

__device__ __forceinline__ float bf16_lo(unsigned int v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(unsigned int v) {
  return __uint_as_float(v & 0xffff0000u);
}

// A round's rows: order[base : base + n] gathered from the packed (P, 56)
// table and widened to f32 rows in shared memory, one float4 a thread.
struct GatherPacked {
  const uint2* packed;
  const int* order;
  __device__ void operator()(float4* stage, int base, int n) const {
    for (int i = threadIdx.x; i < n * kRow4; i += blockDim.x) {
      const int r = i / kRow4;
      const int k = i - r * kRow4;          // float4 k of the f32 row: floats 4k .. 4k + 3
      const uint2* row = packed + static_cast<int64_t>(order[base + r]) * kPacked2;
      float4 out;
      if (k < 2) {                          // geometry: hi at bf16 4k, lo at bf16 8 + 4k
        const uint2 hi = row[k];
        const uint2 lo = row[2 + k];
        out = make_float4(__fadd_rn(bf16_lo(hi.x), bf16_lo(lo.x)),
                          __fadd_rn(bf16_hi(hi.x), bf16_hi(lo.x)),
                          __fadd_rn(bf16_lo(hi.y), bf16_lo(lo.y)),
                          __fadd_rn(bf16_hi(hi.y), bf16_hi(lo.y)));
      } else {                              // colors, invdepth, pad: bf16 4k + 8
        const uint2 v = row[k + 2];
        out = make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y));
      }
      stage[i] = out;
    }
  }
};

__global__ void __launch_bounds__(1024) blend_bf16_kernel(
    const uint2* __restrict__ packed, const int* __restrict__ order,
    const int* __restrict__ ranges, const float* __restrict__ bg,
    float* __restrict__ color, float* __restrict__ invdepth,
    float* __restrict__ final_t, int width, int tile, int grid_x) {
  blend_tile(GatherPacked{packed, order}, ranges, bg, color, invdepth, final_t, width, tile,
             grid_x);
}

}  // namespace

// packed (P, 56) bf16 as raw 16-bit words, order (N,) i32, ranges (gy*gx + 1,)
// i32, bg (32,) f32 -> color (H, W, 32), invdepth (H, W), final_t (H, W) f32.
// H and W are multiples of tile, and tile * tile <= 1024.
extern "C" int guava_blend_bf16_fwd(const void* packed, const int* order, const int* ranges,
                                    const float* bg, float* color, float* invdepth,
                                    float* final_t, int height, int width, int tile,
                                    void* stream) {
  const int n_tiles = blend_tiles_of(height, width, tile);
  if (n_tiles > 0) {
    blend_bf16_kernel<<<n_tiles, tile * tile, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint2*>(packed), order, ranges, bg, color, invdepth, final_t, width,
        tile, width / tile);
  }
  return static_cast<int>(cudaGetLastError());
}
