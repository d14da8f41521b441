// Backward of the 32-channel tile blend: the gradient of every Gaussian's
// packed row (mean x/y, conic a/b/c, opacity, 32 colors, inverse depth).
//
// Replaces guava_renderer_tpu/ops/gsplat.py:_bwd_kernel (the custom_vjp of
// blend_tiles). Per tile it replays the forward's front-to-back walk from
// the same rows in the same order, taking the same decisions (the shared
// expression in blend_common.cuh), and for every contributing (instance,
// pixel) pair evaluates, with gc = sum_c color_c * g_out_c over the 33
// channels, w = alpha * T and a running prefix = sum w * gc,
//   d alpha = T * gc - (u - prefix) / (1 - alpha) - T_final * gbg / (1 - alpha)
// where u = sum_c g_out_c * (out_c - bg_c * T_final) and gbg = sum_c g_out_c *
// bg_c per pixel (after backward.cu:585-618 of the CUDA reference). The
// gradient flows through the 0.99 clamp as identity, as there.
//
// Bound on the H100: operations. A visited pair costs what the forward's
// does (~16 FP32 operations and an exp); a contributing pair adds the
// 33-term dot product, the 33 colour gradients, the geometry chain (~160
// operations) and its share of the warp reductions. The bytes are small
// beside that: each row read once, five images read once, the gradient
// table written once.
//
// Design (not the TPU kernel block by block; its (G, PIX) cumulative
// products, its two MXU products and its read-modify-write row DMAs exist
// for the TPU's units): one CTA per tile, one thread per pixel. A thread
// keeps its pixel's 33 output gradients, T, the prefix and the per-pixel
// constants in registers and walks the staged rows as the forward does. The
// per-instance sums over the tile's pixels are taken per warp, skipped when
// __ballot_sync shows that no lane of the warp contributes. The 39 values
// are summed eight at a time by a butterfly that halves the values a lane
// holds at each exchange (4 + 2 + 1 shuffles, then 2 on the one value
// left: 9 shuffles for 8 sums where a tree for each would take 40), after
// which eight lanes each add one of the sums into the gradient table with
// atomicAdd. Atomics are needed because a Gaussian lies in several tiles
// and CTAs run at the same time (the TPU kernel is free of them only
// because its grid runs in sequence); the order of those float additions
// changes from run to run, so results agree with the plain version to
// rounding, not bit for bit. The tile stops once every pixel has stopped: a
// stopped pixel contributes to no later instance.

#include <cuda_runtime.h>

#include <cstdint>

#include "blend_common.cuh"

namespace {

using namespace guava_blend;

constexpr unsigned kFullMask = 0xffffffffu;

// Warp sums of eight values a lane. On return lane L holds the sum over the
// warp of v[k] with k = sum_slot(L); the four lanes that share a k hold the
// same sum. v is used as scratch.
__device__ __forceinline__ float warp_sum8(float (&v)[8], int lane) {
  const bool hi16 = lane & 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = hi16 ? v[i] : v[i + 4];
    const float keep = hi16 ? v[i + 4] : v[i];
    v[i] = keep + __shfl_xor_sync(kFullMask, send, 16);
  }
  const bool hi8 = lane & 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = hi8 ? v[i] : v[i + 2];
    const float keep = hi8 ? v[i + 2] : v[i];
    v[i] = keep + __shfl_xor_sync(kFullMask, send, 8);
  }
  const bool hi4 = lane & 4;
  float r = (hi4 ? v[1] : v[0]) + __shfl_xor_sync(kFullMask, hi4 ? v[0] : v[1], 4);
  r += __shfl_xor_sync(kFullMask, r, 2);
  r += __shfl_xor_sync(kFullMask, r, 1);
  return r;
}

// Which of the eight values lane L holds the sum of after warp_sum8.
__device__ __forceinline__ int sum_slot(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

template <int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) blend_bwd_kernel(
    const float4* __restrict__ rows, const int* __restrict__ order,
    const int* __restrict__ ranges, const float* __restrict__ bg,
    const float* __restrict__ color, const float* __restrict__ invdepth,
    const float* __restrict__ final_t, const float* __restrict__ g_color,
    const float* __restrict__ g_invdepth, float* __restrict__ d_rows,
    int width, int tile, int grid_x) {
  __shared__ float4 stage[kBatch * kRow4];
  __shared__ int gids[kBatch];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int slot = sum_slot(lane);         // the sum this lane holds after warp_sum8
  const bool adds = (lane & 3) == 0;       // one of the four lanes that share a slot adds it
  const int tile_id = blockIdx.x;
  const int px = (tile_id % grid_x) * tile + tid % tile;
  const int py = (tile_id / grid_x) * tile + tid / tile;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = ranges[tile_id];
  const int end = ranges[tile_id + 1];
  const int64_t pix = static_cast<int64_t>(py) * width + px;

  // this pixel's output gradients and the constants of d alpha
  float g[kChannels + 1];
  const float t_final = final_t[pix];
  float u = 0.0f;      // sum_c g_c * (out_c - bg_c * T_final)
  float gbg = 0.0f;    // sum_c g_c * bg_c
  {
    const float4* g4 = reinterpret_cast<const float4*>(g_color + pix * kChannels);
    const float4* o4 = reinterpret_cast<const float4*>(color + pix * kChannels);
#pragma unroll
    for (int c = 0; c < kChannels; c += 4) {
      const float4 gv = g4[c / 4];
      const float4 ov = o4[c / 4];
      g[c] = gv.x; g[c + 1] = gv.y; g[c + 2] = gv.z; g[c + 3] = gv.w;
      u += gv.x * (ov.x - bg[c] * t_final) + gv.y * (ov.y - bg[c + 1] * t_final)
         + gv.z * (ov.z - bg[c + 2] * t_final) + gv.w * (ov.w - bg[c + 3] * t_final);
      gbg += gv.x * bg[c] + gv.y * bg[c + 1] + gv.z * bg[c + 2] + gv.w * bg[c + 3];
    }
    g[kChannels] = g_invdepth[pix];
    u += g[kChannels] * invdepth[pix];
  }
  const float tfg = t_final * gbg;

  float T = 1.0f;
  float prefix = 0.0f;
  bool done = false;

  for (int base = start; base < end; base += kBatch) {
    // Also the barrier that frees the previous round's staging buffer.
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(kBatch, end - base);
    stage_rows(stage, gids, rows, order, base, n);
    __syncthreads();
    if (__ballot_sync(kFullMask, !done) == 0) continue;   // the whole warp has stopped
    const float* s = reinterpret_cast<const float*>(stage);
    for (int j = 0; j < n; ++j, s += kRow) {
      // the forward's decisions, replayed: see blend.cu
      float d0, d1;
      const float power = gauss_power(s, fx, fy, d0, d1);
      const float gexp = expf(power);
      const float ag = __fmul_rn(s[5], gexp);
      const float alpha = fminf(kAlphaMax, ag);
      const float test_t = next_t(T, alpha);
      bool use = !done && !(power > 0.0f) && !(ag < kAlphaMin);
      if (use && test_t < kTMin) {
        done = true;
        use = false;
      }
      if (__ballot_sync(kFullMask, use) == 0) continue;

      // a lane that does not contribute adds zeros (and must not touch
      // gexp, which is inf for a large positive power)
      float w = 0.0f;
      float geo[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (use) {
        float gc = 0.0f;
#pragma unroll
        for (int c = 0; c <= kChannels; ++c) gc += s[kGeom + c] * g[c];
        w = __fmul_rn(alpha, T);
        prefix += w * gc;
        const float inv1ma = 1.0f / (1.0f - alpha);
        const float dalpha = T * gc - (u - prefix) * inv1ma - tfg * inv1ma;
        T = test_t;
        // d(a_op * gexp): identity through the 0.99 clamp
        const float dG = s[5] * dalpha;
        const float gdx = gexp * d0;
        const float gdy = gexp * d1;
        geo[0] = dG * (-gdx * s[2] - gdy * s[3]);    // d mean x
        geo[1] = dG * (-gdy * s[4] - gdx * s[3]);    // d mean y
        geo[2] = dG * (-0.5f * gdx * d0);            // d conic a
        geo[3] = dG * (-gdx * d1);                   // d conic b
        geo[4] = dG * (-0.5f * gdy * d1);            // d conic c
        geo[5] = gexp * dalpha;                      // d opacity
        geo[6] = w * g[kChannels];                   // d inverse depth
      }
      float* d = d_rows + static_cast<int64_t>(gids[j]) * kRow;
      {
        const float r = warp_sum8(geo, lane);
        // slots 0..5 are row columns 0..5, slot 6 the inverse depth's column
        if (adds && slot < 7) atomicAdd(d + (slot < 6 ? slot : kGeom + kChannels), r);
      }
#pragma unroll
      for (int c0 = 0; c0 < kChannels; c0 += 8) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = w * g[c0 + i];
        const float r = warp_sum8(v, lane);
        if (adds) atomicAdd(d + kGeom + c0 + slot, r);
      }
    }
  }
}

}  // namespace

// rows (P, 44) f32, order (N,) i32, ranges (gy*gx + 1,) i32 (tiles row-major),
// bg (32,) f32, the forward's color (H, W, 32), invdepth (H, W), final_t
// (H, W), the output gradients g_color (H, W, 32), g_invdepth (H, W)
// -> d_rows (P, 44) f32, which must be zero on entry (sums are added to it).
// H and W are multiples of tile, and tile * tile is a multiple of 32, <= 1024.
extern "C" int guava_blend_bwd(const float* rows, const int* order, const int* ranges,
                               const float* bg, const float* color, const float* invdepth,
                               const float* final_t, const float* g_color,
                               const float* g_invdepth, float* d_rows, int height, int width,
                               int tile, void* stream) {
  const int grid_x = width / tile;
  const int n_tiles = grid_x * (height / tile);
  const int threads = tile * tile;
  if (n_tiles > 0) {
    const float4* rows4 = reinterpret_cast<const float4*>(rows);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (threads <= 256) {
      blend_bwd_kernel<256><<<n_tiles, threads, 0, st>>>(
          rows4, order, ranges, bg, color, invdepth, final_t, g_color, g_invdepth, d_rows,
          width, tile, grid_x);
    } else {
      blend_bwd_kernel<1024><<<n_tiles, threads, 0, st>>>(
          rows4, order, ranges, bg, color, invdepth, final_t, g_color, g_invdepth, d_rows,
          width, tile, grid_x);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
