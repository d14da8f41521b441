// The forward walk on sub-tile CTAs, shared by the tile blend K1 (blend.cu,
// rows from the (P, 44) table: PlainRows), the resident-table blend K7
// (blend_resident.cu, rows from the table or the resident table by id:
// ResidentRows) and the bf16-row blend K6 (blend_bf16.cu, 112-byte packed
// rows: PackedBf16Rows). The three are instantiations of one kernel that
// differ only in where a staged row is copied from and, for K6, in a
// widening of the landed round to f32 rows before the cull; so on the same
// f32 rows they give the same image bit for bit. A row source names the
// stage its rows land in (Src::FwdStage), and the stage's `landed` gives a
// landed round's f32 rows. The walk itself (sub-tiles, staging, the cull)
// is described in blend_subtile.cuh and blend.cu.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "blend_subtile.cuh"

namespace guava_blend {

// One CTA a sub-tile, one thread a pixel: the tile's rows in order, culled per
// warp, with the decisions and sums of blend_fwd.cuh:blend_tile.
template <class Src>
__global__ void __launch_bounds__(kMaxSubThreads, 3) blend_fwd_kernel(
    const Src src, const int* __restrict__ order, const int* __restrict__ ranges,
    const float* __restrict__ bg, float* __restrict__ color, float* __restrict__ invdepth,
    float* __restrict__ final_t, int width, int tile, int grid_x) {
  using Stage = typename Src::FwdStage;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage& st = *reinterpret_cast<Stage*>(smem);

  const SubTile sub = subtile_of(tile, grid_x);
  const float fx = static_cast<float>(sub.px);
  const float fy = static_cast<float>(sub.py);

  float acc[kChannels + 1];
#pragma unroll
  for (int c = 0; c <= kChannels; ++c) acc[c] = 0.0f;
  float T = 1.0f;
  bool done = !sub.active;
  const WarpBox box = warp_box(sub);

  RowPipe<Stage, Src> pipe(st, src, order, ranges[sub.tile_id], ranges[sub.tile_id + 1],
                           false);
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
    const float4* rows_b = st.landed(r % Stage::depth, pipe.rows_in(r));
    if (__ballot_sync(0xffffffffu, !done) == 0u) continue;   // the whole warp has stopped
    uint32_t keep[Stage::words];
    cull_warp(rows_b, pipe.rows_in(r), box, keep);
    if (done) continue;
    for (int kw = 0; kw < Stage::words && !done; ++kw) {
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

// Dynamic shared memory of a CTA of the walk with row source Src.
template <class Src>
constexpr size_t fwd_smem_bytes = sizeof(typename Src::FwdStage);

// Launch the walk over an H x W image tiled by `tile` (H, W multiples of it,
// tile * tile <= 1024) on `stream`; the launch's cudaError_t.
template <class Src>
inline cudaError_t launch_blend_fwd(const Src& src, const int* order, const int* ranges,
                                    const float* bg, float* color, float* invdepth,
                                    float* final_t, int height, int width, int tile,
                                    cudaStream_t stream) {
  const int n_ctas = subtile_ctas(height, width, tile);
  const size_t smem = fwd_smem_bytes<Src>;
  if (n_ctas > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        blend_fwd_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    blend_fwd_kernel<Src><<<n_ctas, subtile_threads(tile), smem, stream>>>(
        src, order, ranges, bg, color, invdepth, final_t, width, tile, width / tile);
  }
  return cudaGetLastError();
}

// CTAs of the walk resident on one SM at once for a tile (from the compiled
// kernel's registers and shared memory) -> *ctas; its dynamic shared memory
// a CTA -> *smem_bytes.
template <class Src>
inline int blend_fwd_occupancy(int tile, int* ctas, int* smem_bytes) {
  *smem_bytes = static_cast<int>(fwd_smem_bytes<Src>);
  const cudaError_t err = cudaFuncSetAttribute(
      blend_fwd_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem_bytes<Src>);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, blend_fwd_kernel<Src>, subtile_threads(tile), fwd_smem_bytes<Src>));
}

}  // namespace guava_blend
