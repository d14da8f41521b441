// Every forward blend: one kernel on sub-tile CTAs with four row sources
// (blend_subtile.cuh). The tile blend K1 (blend.cu) and the probe K1p
// (blend_probe.cu) read the (P, 44) table (PlainRows), the resident-table
// blend K7 (blend_resident.cu) that table or its resident table by id
// (ResidentRows), the bf16-row blend K6 (blend_bf16.cu) 112-byte packed
// rows (PackedBf16Rows), and the stream blend K8 (blend_stream.cu) the
// per-instance stream, instance i at row i (StreamRows). They differ only
// in where a staged row is copied from and, for K6, in a widening of the
// landed round to f32 rows before the cull; so on the same f32 rows they
// give the same image bit for bit, and K3 (blend_bwd.cu) replays any of
// them. A row source names the stage its rows land in (Src::FwdStage), and
// the stage's `landed` gives a landed round's f32 rows. The walk itself
// (sub-tiles, staging, the cull) is described in blend_subtile.cuh and
// blend.cu.
//
// `Rounds` sets the rounds: how many rows each stages, before which rounds
// the sub-tile tests whether all its pixels are done (the other rounds open
// with a plain barrier, which frees the other buffer all the same), and what
// it does with the rounds it ran. K1, K6, K7 and K8 take EveryRound (the
// stage's rows, the test before every round, no count); K1p takes its
// probe's rounds (blend_probe.cu). A pixel's decisions do not depend on the
// rounds, so every Rounds gives the same image.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "blend_subtile.cuh"

namespace guava_blend {

// The rounds of K1, K6, K7 and K8: the stage's rows, the exit test before
// every round, no count.
struct EveryRound {
  static constexpr bool wide = false;   // R = min(rows, threads) (RowPipe)
  __device__ int rows(int max_rows) const { return max_rows; }
  __device__ bool exit_test_before(int) const { return true; }
  __device__ void ran(int, int) const {}
};

// One CTA a sub-tile, one thread a pixel: the tile's rows in order, culled per
// warp, each pixel taking the decisions and sums that blend_bwd.cu replays.
template <class Src, class Rounds = EveryRound>
__global__ void __launch_bounds__(kMaxSubThreads, 3) blend_fwd_kernel(
    const Src src, const int* __restrict__ order, const int* __restrict__ ranges,
    const float* __restrict__ bg, float* __restrict__ color, float* __restrict__ invdepth,
    float* __restrict__ final_t, int width, int tile, int grid_x, const Rounds rounds) {
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

  RowPipe<Stage, Src, Rounds::wide> pipe(st, src, order, ranges[sub.tile_id],
                                         ranges[sub.tile_id + 1],
                                         rounds.rows(Stage::rows_a_round), false);
  if (threadIdx.x == 0) stage_init(st);
  __syncthreads();
  pipe.prologue();

  int r = 0;
  for (; r < pipe.n_rounds; ++r) {
    // Frees the buffer of round r - 1 and, before the rounds that test it,
    // ends the sub-tile once every pixel is done; the copies in flight must
    // land before the CTA may leave.
    if (rounds.exit_test_before(r)) {
      if (__syncthreads_count(!done) == 0) {
        pipe.drain(r);
        break;
      }
    } else {
      __syncthreads();
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
        // the decisions that blend_bwd.cu replays: keep them as they are
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
  rounds.ran(sub.tile_id, r);

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
template <class Src, class Rounds = EveryRound>
inline cudaError_t launch_blend_fwd(const Src& src, const int* order, const int* ranges,
                                    const float* bg, float* color, float* invdepth,
                                    float* final_t, int height, int width, int tile,
                                    cudaStream_t stream, const Rounds& rounds = Rounds{}) {
  const int n_ctas = subtile_ctas(height, width, tile);
  const size_t smem = fwd_smem_bytes<Src>;
  if (n_ctas > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        blend_fwd_kernel<Src, Rounds>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    blend_fwd_kernel<Src, Rounds><<<n_ctas, subtile_threads(tile), smem, stream>>>(
        src, order, ranges, bg, color, invdepth, final_t, width, tile, width / tile, rounds);
  }
  return cudaGetLastError();
}

// CTAs of the walk resident on one SM at once for a tile (from the compiled
// kernel's registers and shared memory) -> *ctas; its dynamic shared memory
// a CTA -> *smem_bytes.
template <class Src, class Rounds = EveryRound>
inline int blend_fwd_occupancy(int tile, int* ctas, int* smem_bytes) {
  *smem_bytes = static_cast<int>(fwd_smem_bytes<Src>);
  const cudaError_t err = cudaFuncSetAttribute(blend_fwd_kernel<Src, Rounds>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               fwd_smem_bytes<Src>);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, blend_fwd_kernel<Src, Rounds>, subtile_threads(tile), fwd_smem_bytes<Src>));
}

}  // namespace guava_blend
