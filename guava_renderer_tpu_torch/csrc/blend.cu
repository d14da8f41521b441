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
//  4. The same per-pixel arithmetic as the walk of K6, K7, K8 and K1p
//     (blend_fwd.cuh): gauss_power, next_t, the thresholds and the explicit
//     fused multiply-adds, on the same rows in the same order minus rows the
//     pixel would have skipped. The image is that walk's bit for bit. A
//     round starts with __syncthreads_count, which frees the other buffer
//     and ends the sub-tile once its own pixels are all done.
// Rows are 44 floats (8 geometry + 32 colors + invdepth + 3 pad), not the
// TPU's 128-lane row, which existed only for DMA alignment. The image is
// written directly in (H, W, 32) layout.

#include <cuda_runtime.h>

#include <cstdint>

#include "blend_subtile.cuh"

namespace {

using namespace guava_blend;

// 128 rows a round, two buffers (45 KB): one round in flight while one is walked
using FwdStage = RowStage<128, 2>;

__global__ void __launch_bounds__(kMaxSubThreads, 3) blend_fwd_kernel(
    const float4* __restrict__ rows, const int* __restrict__ order,
    const int* __restrict__ ranges, const float* __restrict__ bg,
    float* __restrict__ color, float* __restrict__ invdepth,
    float* __restrict__ final_t, int width, int tile, int grid_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  FwdStage& st = *reinterpret_cast<FwdStage*>(smem);

  const SubTile sub = subtile_of(tile, grid_x);
  const float fx = static_cast<float>(sub.px);
  const float fy = static_cast<float>(sub.py);

  float acc[kChannels + 1];
#pragma unroll
  for (int c = 0; c <= kChannels; ++c) acc[c] = 0.0f;
  float T = 1.0f;
  bool done = !sub.active;
  const WarpBox box = warp_box(sub);

  RowPipe<FwdStage> pipe(st, rows, order, ranges[sub.tile_id], ranges[sub.tile_id + 1], false);
  if (threadIdx.x == 0) stage_init(st);
  __syncthreads();
  pipe.prologue();

  for (int r = 0; r < pipe.n_rounds; ++r) {
    // Frees the buffer of round r - 1 and ends the sub-tile once every pixel
    // is done; the copies in flight must land before the CTA may leave.
    if (__syncthreads_count(!done) == 0) {
      pipe.drain(r);
      break;
    }
    if (pipe.next < pipe.n_rounds) pipe.issue_next();
    pipe.wait(r);
    if (__ballot_sync(0xffffffffu, !done) == 0u) continue;   // the whole warp has stopped
    const float4* rows_b = st.rows[r % FwdStage::depth];
    uint32_t keep[FwdStage::words];
    cull_warp(rows_b, pipe.rows_in(r), box, keep);
    if (done) continue;
    for (int kw = 0; kw < FwdStage::words && !done; ++kw) {
      uint32_t m = keep[kw];
      while (m != 0u) {
        const int j = kw * 32 + __ffs(m) - 1;
        m &= m - 1u;
        const float* s = reinterpret_cast<const float*>(rows_b + j * kRow4);
        // the decisions of blend_fwd.cuh:blend_tile, which blend_bwd.cu replays: keep them as
        // they are
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
        for (int c = 0; c <= kChannels; ++c) acc[c] = __fmaf_rn(w, s[kGeom + c], acc[c]);
        T = test_t;
      }
    }
  }

  if (!sub.active) return;
  const int64_t pix = static_cast<int64_t>(sub.py) * width + sub.px;
  float4* out4 = reinterpret_cast<float4*>(color + pix * kChannels);
#pragma unroll
  for (int c = 0; c < kChannels; c += 4) {
    out4[c / 4] = make_float4(__fmaf_rn(T, bg[c], acc[c]), __fmaf_rn(T, bg[c + 1], acc[c + 1]),
                              __fmaf_rn(T, bg[c + 2], acc[c + 2]),
                              __fmaf_rn(T, bg[c + 3], acc[c + 3]));
  }
  invdepth[pix] = acc[kChannels];
  final_t[pix] = T;
}

}  // namespace

// rows (P, 44) f32 (16-byte aligned), order (N,) i32, ranges (gy*gx + 1,)
// i32 (tiles row-major), bg (32,) f32 -> color (H, W, 32), invdepth (H, W),
// final_t (H, W) f32. H and W are multiples of tile, and tile * tile <= 1024.
extern "C" int guava_blend_fwd(const float* rows, const int* order, const int* ranges,
                               const float* bg, float* color, float* invdepth,
                               float* final_t, int height, int width, int tile,
                               void* stream) {
  const int n_ctas = subtile_ctas(height, width, tile);
  if (n_ctas > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        blend_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(FwdStage));
    if (err != cudaSuccess) return static_cast<int>(err);
    blend_fwd_kernel<<<n_ctas, subtile_threads(tile), sizeof(FwdStage),
                       static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(rows), order, ranges, bg, color, invdepth, final_t,
        width, tile, width / tile);
  }
  return static_cast<int>(cudaGetLastError());
}

// CTAs of K1 resident on one SM at once for a tile (from the compiled
// kernel's registers and shared memory) -> *ctas; its dynamic shared
// memory a CTA -> *smem_bytes.
extern "C" int guava_blend_fwd_occupancy(int tile, int* ctas, int* smem_bytes) {
  *smem_bytes = static_cast<int>(sizeof(FwdStage));
  const cudaError_t err = cudaFuncSetAttribute(
      blend_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(FwdStage));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, blend_fwd_kernel, subtile_threads(tile), sizeof(FwdStage)));
}
