// Forward tile blend with a resident table for the largest Gaussians (the
// rasterizer's size_classes + vmem_classes setting).
//
// Replaces guava_renderer_tpu/ops/gsplat.py:_fwd_kernel_vmem (reached
// through blend_tiles_vmem). Binning ranks the Gaussians by tile-rect area
// and gives an instance of one of the L largest the id P + rank; its row
// comes from the (L, 44) resident table `ltable` (built by gather_rows.cu)
// and every other row from the (P, 44) table, as K1 reads them.
//
// Bound on the H100: operations, as K1's (blend.cu). On the TPU the
// resident table saves one row DMA a large-Gaussian instance; here both
// tables are read through L2 and the walk is K1's, so the time should be
// K1's.
//
// Design: the whole-tile walk (blend_fwd.cuh) with a staging that picks the row's
// source by id: id >= P reads ltable[id - P] (clipped to [0, L - 1], as the
// TPU kernel clips it), any other id rows[id]. The resident table is read
// through global memory; holding it in shared memory is later work (at
// vmem_classes = 2 of the ubody ladder it is 1,065 rows = 187 KB, inside a
// CTA's 227 KB, but not at every L the setting admits). With
// ltable = rows[lids] the staged rows are K1's, so the image equals K1's on
// the original ids bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "blend_fwd.cuh"

namespace {

using namespace guava_blend;

// A round's rows: order[base : base + n], each from ltable or rows by its id.
struct GatherResident {
  const float4* rows;
  const float4* ltable;
  const int* order;
  int n_rows;      // P: ids from P on index ltable
  int n_resident;  // L
  __device__ void operator()(float4* stage, int base, int n) const {
    for (int i = threadIdx.x; i < n * kRow4; i += blockDim.x) {
      const int r = i / kRow4;
      const int id = order[base + r];
      const float4* src = id >= n_rows
          ? ltable + static_cast<int64_t>(min(id - n_rows, n_resident - 1)) * kRow4
          : rows + static_cast<int64_t>(id) * kRow4;
      stage[i] = src[i - r * kRow4];
    }
  }
};

__global__ void __launch_bounds__(1024) blend_resident_kernel(
    const float4* __restrict__ rows, const float4* __restrict__ ltable,
    const int* __restrict__ order, const int* __restrict__ ranges,
    const float* __restrict__ bg, float* __restrict__ color, float* __restrict__ invdepth,
    float* __restrict__ final_t, int n_rows, int n_resident, int width, int tile, int grid_x) {
  blend_tile(GatherResident{rows, ltable, order, n_rows, n_resident}, ranges, bg, color,
             invdepth, final_t, width, tile, grid_x);
}

}  // namespace

// rows (P, 44) f32, ltable (L, 44) f32, order (N,) i32 with ids in [0, P + L)
// (ids >= P only when L >= 1), ranges (gy*gx + 1,) i32, bg (32,) f32
// -> color (H, W, 32), invdepth (H, W), final_t (H, W) f32.
// H and W are multiples of tile, and tile * tile <= 1024.
extern "C" int guava_blend_resident_fwd(const float* rows, const float* ltable, int n_rows,
                                        int n_resident, const int* order, const int* ranges,
                                        const float* bg, float* color, float* invdepth,
                                        float* final_t, int height, int width, int tile,
                                        void* stream) {
  const int n_tiles = blend_tiles_of(height, width, tile);
  if (n_tiles > 0) {
    blend_resident_kernel<<<n_tiles, tile * tile, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(rows), reinterpret_cast<const float4*>(ltable), order,
        ranges, bg, color, invdepth, final_t, n_rows, n_resident, width, tile, width / tile);
  }
  return static_cast<int>(cudaGetLastError());
}
