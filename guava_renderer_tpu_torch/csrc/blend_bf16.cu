// Forward tile blend on bf16-packed rows (the rasterizer's bf16_rows
// setting), K6.
//
// Replaces guava_renderer_tpu/ops/gsplat.py:_fwd_kernel in its
// bf16_rows=True branch (:1093, reached through blend_tiles_bf16). A packed
// row is 56 bf16 (112 bytes, a multiple of 16): the 8 geometry values as
// bf16 hi and lo halves (value = hi + lo), then the 32 colors and the
// inverse depth as plain bf16, then zeros (kernels/blend.py:pack_rows_bf16,
// blend_bf16_rows.cuh).
//
// Bound on the H100: operations, as K1's (blend.cu). The packing cuts the
// bytes of the row gather (112 B a row against 176 B), but at the 512^2
// bench frame those bytes are ~60 MB against ~2.5 GFLOP of blending, so the
// cut is not expected to show in the time.
//
// Design: K1's walk (blend_subtile_fwd.cuh: sub-tile CTAs, rows staged two
// rounds deep by bulk copies, the per-warp exact cull) with the row source
// PackedBf16Rows: each row lands packed, by one 112-byte bulk copy, in a
// PackedStage. Once a round has landed, the CTA widens it into one f32
// buffer (geometry = __fadd_rn(hi, lo), colors and inverse depth exactly,
// the pad 0: the values of kernels/blend.py:unpack_rows_bf16) and passes a
// barrier; the cull and the walk then run, as K1's code, on those f32
// values. So the cull's exactness argument holds as it stands, the image
// is K1's on the unpacked rows bit for bit, and K3 replays it from them.
// The cost against K1 is the widening and one barrier a round; the shared
// memory (two packed buffers and one f32 buffer, 51 KB) still lets three
// CTAs share an SM.

#include <cuda_runtime.h>

#include "blend_subtile_fwd.cuh"

using guava_blend::PackedBf16Rows;

// packed (P, 56) bf16 as raw 16-bit words (16-byte aligned), order (N,) i32,
// ranges (gy*gx + 1,) i32, bg (32,) f32 -> color (H, W, 32), invdepth
// (H, W), final_t (H, W) f32. H and W are multiples of tile, and
// tile * tile <= 1024.
extern "C" int guava_blend_bf16_fwd(const void* packed, const int* order, const int* ranges,
                                    const float* bg, float* color, float* invdepth,
                                    float* final_t, int height, int width, int tile,
                                    void* stream) {
  return static_cast<int>(guava_blend::launch_blend_fwd(
      PackedBf16Rows{static_cast<const uint4*>(packed)}, order, ranges, bg, color, invdepth,
      final_t, height, width, tile, static_cast<cudaStream_t>(stream)));
}

// CTAs of K6 resident on one SM at once for a tile -> *ctas; its dynamic
// shared memory a CTA -> *smem_bytes.
extern "C" int guava_blend_bf16_occupancy(int tile, int* ctas, int* smem_bytes) {
  return guava_blend::blend_fwd_occupancy<PackedBf16Rows>(tile, ctas, smem_bytes);
}
