// Forward tile blend reading a per-instance stream (the rasterizer's
// streaming setting), K8.
//
// Replaces guava_renderer_tpu/ops/gsplat.py:1350 _fwd_stream_kernel
// (reached through blend_tiles_stream). The stream holds one (44,) f32 row
// per (Gaussian, tile) instance in the sorted order, so tile t's rows are
// stream[ranges[t] : ranges[t + 1]], contiguous: the blend reads no `order`
// and gathers nothing. Geometry is exact f32; colors and the inverse depth
// are bf16-rounded, the values the JAX package carries through its sort.
//
// Bound on the H100: operations, as K1's (blend.cu). The stream turns K1's
// gather of N rows from a P-row table (~33 MB at the 512^2 bench frame,
// gathered ~3 times over) into contiguous reads of N rows (~94 MB), and
// the blend's time is its arithmetic either way.
//
// Design: K1's kernel (blend_subtile_fwd.cuh: sub-tile CTAs, rows staged
// two rounds deep by bulk copies, the per-warp exact cull) with the row
// source StreamRows: instance i's row is stream row i, so the pipe takes
// the instance index as the row id and loads no `order`, and a round's
// rows, being contiguous, land by one bulk copy of n x 176 bytes from
// thread 0, where K1 issues a 176-byte copy a row from n threads. On the
// rows with bf16-rounded colors the image is K1's bit for bit, and K3
// replays it from the f32 rows and `order`.

#include <cuda_runtime.h>

#include "blend_subtile_fwd.cuh"

using guava_blend::StreamRows;

// stream (N, 44) f32 (16-byte aligned), ranges (gy*gx + 1,) i32 indexing
// it, bg (32,) f32 -> color (H, W, 32), invdepth (H, W), final_t (H, W)
// f32. H and W are multiples of tile, and tile * tile <= 1024.
extern "C" int guava_blend_stream_fwd(const float* stream, const int* ranges, const float* bg,
                                      float* color, float* invdepth, float* final_t,
                                      int height, int width, int tile, void* stream_) {
  return static_cast<int>(guava_blend::launch_blend_fwd(
      StreamRows{reinterpret_cast<const float4*>(stream)}, nullptr, ranges, bg, color, invdepth,
      final_t, height, width, tile, static_cast<cudaStream_t>(stream_)));
}

// CTAs of K8 resident on one SM at once for a tile -> *ctas; its dynamic
// shared memory a CTA -> *smem_bytes.
extern "C" int guava_blend_stream_occupancy(int tile, int* ctas, int* smem_bytes) {
  return guava_blend::blend_fwd_occupancy<StreamRows>(tile, ctas, smem_bytes);
}
