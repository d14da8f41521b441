// Forward tile blend with a resident table for the largest Gaussians (the
// rasterizer's size_classes + vmem_classes setting), K7.
//
// Replaces guava_renderer_tpu/ops/gsplat.py:1227 _fwd_kernel_vmem (reached
// through blend_tiles_vmem). Binning ranks the Gaussians by tile-rect area
// and gives an instance of one of the L largest the id P + rank; its row
// comes from the (L, 44) resident table `ltable` (built by gather_rows.cu)
// and every other row from the (P, 44) table, as K1 reads them.
//
// Bound on the H100: operations, as K1's (blend.cu). On the TPU the
// resident table saves one row DMA a large-Gaussian instance; here both
// tables are read through L2, so the time should be K1's.
//
// Design: K1's walk (blend_subtile_fwd.cuh: sub-tile CTAs, rows staged two
// rounds deep by 176-byte bulk copies, the per-warp exact cull) with the
// row source ResidentRows: id >= P copies ltable[min(id - P, L - 1)], as
// the TPU kernel clips it, any other id rows[id]. The resident table is
// read through global memory; holding it in shared memory is later work (at
// vmem_classes = 2 of the ubody ladder it is 1,065 rows = 187 KB, inside a
// CTA's 227 KB, but not at every L the setting admits). With
// ltable = rows[lids] the staged rows are K1's, so the image equals K1's on
// the original ids bit for bit.

#include <cuda_runtime.h>

#include "blend_subtile_fwd.cuh"

using guava_blend::ResidentRows;

// rows (P, 44) f32, ltable (L, 44) f32, both 16-byte aligned, order (N,) i32
// with ids in [0, P + L) (ids >= P only when L >= 1), ranges (gy*gx + 1,)
// i32, bg (32,) f32 -> color (H, W, 32), invdepth (H, W), final_t (H, W) f32.
// H and W are multiples of tile, and tile * tile <= 1024.
extern "C" int guava_blend_resident_fwd(const float* rows, const float* ltable, int n_rows,
                                        int n_resident, const int* order, const int* ranges,
                                        const float* bg, float* color, float* invdepth,
                                        float* final_t, int height, int width, int tile,
                                        void* stream) {
  const ResidentRows src{reinterpret_cast<const float4*>(rows),
                         reinterpret_cast<const float4*>(ltable), n_rows, n_resident};
  return static_cast<int>(guava_blend::launch_blend_fwd(src, order, ranges, bg, color, invdepth,
                                                        final_t, height, width, tile,
                                                        static_cast<cudaStream_t>(stream)));
}

// CTAs of K7 resident on one SM at once for a tile -> *ctas; its dynamic
// shared memory a CTA -> *smem_bytes.
extern "C" int guava_blend_resident_occupancy(int tile, int* ctas, int* smem_bytes) {
  return guava_blend::blend_fwd_occupancy<ResidentRows>(tile, ctas, smem_bytes);
}
