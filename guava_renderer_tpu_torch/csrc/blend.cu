// Forward tile blend of the 32-channel Gaussian rasterizer (K1).
//
// Replaces guava_renderer_tpu/ops/gsplat.py:1018 _fwd_kernel (reached
// through blend_tiles <- rasterize_blend). Per image tile it composites the
// tile's depth-sorted instances front to back with the renderCUDA<32>
// semantics: alpha = min(0.99, a * exp(power)), skipped when power > 0 or
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
// Design (not the TPU kernel block by block: its chunked cumulative
// product and MXU matmul exist for its vector and matrix units). One
// thread a pixel walks its tile's rows in order, keeping T and its 33
// accumulators in registers, as in renderCUDA. What the walk runs on
// (blend_subtile.cuh):
//  1. Sub-tile CTAs. A CTA covers a 16 x 16 block (256 threads, 8 warps of
//     8 x 4 pixels), so a 32^2 bin tile is four CTAs that read the same
//     instance range from neighbouring blockIdx values. The bench frame runs
//     1,024 CTAs, three resident an SM (__launch_bounds__(256, 3): up to 80
//     registers, so the 33 accumulators do not spill; 45 KB of shared
//     memory each), where one 1,024-thread CTA a tile filled an SM and left
//     the busiest tile's 22k instances to one SM while the rest idled.
//  2. Pipelined staging. Two buffers of 128 rows; each row is one bulk copy
//     completing on the buffer's mbarrier, and round r + 1 is in flight
//     while round r is culled and walked, where the whole CTA used to stop
//     to gather each round.
//  3. The exact row cull. Each warp tests the landed rows' conics against
//     the box of its own 8 x 4 pixel centres (the JAX package's _slot_qmin
//     and _cull_qcut, four rows a lane); the survivors' bits form a mask in
//     registers that the walk iterates, so rows that no pixel of the warp
//     can take are not walked, and no barrier waits for the cull.
//  4. The per-pixel arithmetic of the reference's renderCUDA, written once
//     for every forward blend: gauss_power, next_t, the thresholds and the
//     explicit fused multiply-adds (blend_common.cuh), on the rows in order
//     minus rows the pixel would have skipped; so every row source gives
//     the same image bit for bit on the same f32 rows, and K3 replays it.
//     A round starts with __syncthreads_count, which frees the other buffer
//     and ends the sub-tile once its own pixels are all done.
// Rows are 44 floats (8 geometry + 32 colors + invdepth + 3 pad), not the
// TPU's 128-lane row, which existed only for DMA alignment. The image is
// written directly in (H, W, 32) layout. Every forward blend is this one
// kernel, blend_subtile_fwd.cuh:blend_fwd_kernel, with one of four row
// sources: here PlainRows, in blend_probe.cu (K1p) PlainRows with a count of
// the rounds, in blend_resident.cu (K7) ResidentRows, in blend_bf16.cu (K6)
// PackedBf16Rows and in blend_stream.cu (K8) StreamRows.

#include <cuda_runtime.h>

#include "blend_subtile_fwd.cuh"

using guava_blend::PlainRows;

// rows (P, 44) f32 (16-byte aligned), order (N,) i32, ranges (gy*gx + 1,)
// i32 (tiles row-major), bg (32,) f32 -> color (H, W, 32), invdepth (H, W),
// final_t (H, W) f32. H and W are multiples of tile, and tile * tile <= 1024.
extern "C" int guava_blend_fwd(const float* rows, const int* order, const int* ranges,
                               const float* bg, float* color, float* invdepth,
                               float* final_t, int height, int width, int tile,
                               void* stream) {
  return static_cast<int>(guava_blend::launch_blend_fwd(
      PlainRows{reinterpret_cast<const float4*>(rows)}, order, ranges, bg, color, invdepth,
      final_t, height, width, tile, static_cast<cudaStream_t>(stream)));
}

// CTAs of K1 resident on one SM at once for a tile (from the compiled
// kernel's registers and shared memory) -> *ctas; its dynamic shared
// memory a CTA -> *smem_bytes.
extern "C" int guava_blend_fwd_occupancy(int tile, int* ctas, int* smem_bytes) {
  return guava_blend::blend_fwd_occupancy<PlainRows>(tile, ctas, smem_bytes);
}
