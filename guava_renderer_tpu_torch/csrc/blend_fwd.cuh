// The whole-tile walk of the stream blend K8 (blend_stream.cu) and the
// probe K1p (blend_probe.cu): the walk K1, K7 and K6 ran before they moved
// to sub-tile CTAs (blend_subtile_fwd.cuh), which takes the same decisions
// on the same rows and gives the same image bit for bit. The two differ
// only in where a round's rows come from; `Stage` fills the shared buffer
// with the f32 rows of instances base .. base + n - 1 of the tile's run,
// and everything after it (the walk, the decisions, the sums, the output)
// is this one function. So two kernels given the same f32 rows give the
// same image bit for bit, and K3 (blend_bwd.cu) replays either from those
// rows.
//
// One CTA per tile, one thread per pixel, as in the reference's renderCUDA:
// each thread walks its tile's instances front to back, keeping T and its
// 33 accumulators in registers, and reads the staged rows as broadcasts. A
// round starts with __syncthreads_count, which both frees the staging buffer
// and ends the tile once every pixel is done. The sums use explicit
// fused multiply-adds, so no instantiation can differ from another in
// whether the compiler contracted them.
//
// `Walk` sets the rounds: how many rows each stages, before which rounds the
// tile tests whether every pixel is done, and what it does with the count
// of rounds it ran. K8 takes `FullRounds` (kBatch rows, the test before
// every round, no count); the probe K1p (blend_probe.cu) stages fewer rows a
// round, tests more rarely and writes the count. A pixel's decisions do not
// depend on the rounds, so every Walk gives the same image.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "blend_common.cuh"

namespace guava_blend {

// The rounds of K8: kBatch rows each, the exit test before each.
struct FullRounds {
  __device__ int rows_a_round() const { return kBatch; }
  __device__ bool exit_test_before(int) const { return true; }
  __device__ void ran(int) const {}
};

template <class Stage, class Walk = FullRounds>
__device__ __forceinline__ void blend_tile(const Stage& stage_rows_of, const int* __restrict__ ranges,
                                           const float* __restrict__ bg, float* __restrict__ color,
                                           float* __restrict__ invdepth,
                                           float* __restrict__ final_t, int width, int tile,
                                           int grid_x, const Walk& walk = Walk{}) {
  __shared__ float4 stage[kBatch * kRow4];

  const int tid = threadIdx.x;
  const int tile_id = blockIdx.x;
  const int px = (tile_id % grid_x) * tile + tid % tile;
  const int py = (tile_id / grid_x) * tile + tid / tile;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = ranges[tile_id];
  const int end = ranges[tile_id + 1];

  float acc[kChannels + 1];
#pragma unroll
  for (int c = 0; c <= kChannels; ++c) acc[c] = 0.0f;
  float T = 1.0f;
  bool done = false;

  const int batch = walk.rows_a_round();
  int round = 0;
  for (int base = start; base < end; base += batch, ++round) {
    // Also the barrier that frees the previous round's staging buffer.
    if (walk.exit_test_before(round)) {
      if (__syncthreads_count(!done) == 0) break;
    } else {
      __syncthreads();
    }
    const int n = min(batch, end - base);
    stage_rows_of(stage, base, n);
    __syncthreads();
    if (done) continue;
    const float* s = reinterpret_cast<const float*>(stage);
    for (int j = 0; j < n; ++j, s += kRow) {
      // the decisions below are replayed by blend_bwd.cu: keep them as they are
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

  const int64_t pix = static_cast<int64_t>(py) * width + px;
  float4* out4 = reinterpret_cast<float4*>(color + pix * kChannels);
#pragma unroll
  for (int c = 0; c < kChannels; c += 4) {
    out4[c / 4] = make_float4(__fmaf_rn(T, bg[c], acc[c]), __fmaf_rn(T, bg[c + 1], acc[c + 1]),
                              __fmaf_rn(T, bg[c + 2], acc[c + 2]),
                              __fmaf_rn(T, bg[c + 3], acc[c + 3]));
  }
  invdepth[pix] = acc[kChannels];
  final_t[pix] = T;
  walk.ran(round);
}

// Launch geometry of every forward blend: a CTA of tile^2 threads per tile.
inline int blend_tiles_of(int height, int width, int tile) {
  return (width / tile) * (height / tile);
}

}  // namespace guava_blend
