// Backward of the 32-channel tile blend (K3): the gradient of every
// Gaussian's packed row (mean x/y, conic a/b/c, opacity, 32 colors, inverse
// depth).
//
// Replaces guava_renderer_tpu/ops/gsplat.py:1457 _bwd_kernel (the
// custom_vjp of blend_tiles). Per tile it replays the forward's
// front-to-back walk from the same rows in the same order, taking the same
// decisions (the shared expression in blend_common.cuh), and for every
// contributing (instance, pixel) pair evaluates, with gc = sum_c color_c *
// g_out_c over the 33 channels, w = alpha * T and a running prefix =
// sum w * gc,
//   d alpha = T * gc - (u - prefix) / (1 - alpha) - T_final * gbg / (1 - alpha)
// where u = sum_c g_out_c * (out_c - bg_c * T_final) and gbg = sum_c g_out_c *
// bg_c per pixel (after backward.cu:585-618 of the CUDA reference). The
// gradient flows through the 0.99 clamp as identity, as there.
//
// Bound on the H100: operations. A visited pair costs what the forward's
// does (~16 FP32 operations and an exp); a contributing pair adds the
// 33-term dot product, the 33 colour gradients, the geometry chain (~160
// operations) and its share of the reductions. The bytes are small beside
// that: each row read once, five images read once, the gradient table
// written once.
//
// Design (not the TPU kernel block by block; its (G, PIX) cumulative
// products, its two MXU products and its read-modify-write row DMAs exist
// for the TPU's units): one thread a pixel keeps its 33 output gradients,
// T, the prefix and the per-pixel constants in registers and walks the
// rows as K1 (blend.cu) does, on the same footing (blend_subtile.cuh):
//  1. Sub-tile CTAs of 16 x 16 pixels (8 x 4 a warp), four to a 32^2 bin
//     tile, two resident an SM (__launch_bounds__(256, 2): 103 KB of shared
//     memory each), where one 1,024-thread CTA a tile left the busiest tile
//     to one SM.
//  2. Two buffers of 64 rows, each row a bulk copy on the buffer's
//     mbarrier, round r + 1 in flight while round r is walked. Two barriers
//     a round: one frees the other buffer (and ends the sub-tile once its
//     pixels are done), one closes the round's sums before they are added
//     to the gradient table.
//  3. K1's exact row cull, per warp: a row no pixel of the warp can take
//     would get only zeros from it, so dropping it is exact; the other rows
//     keep their order, and each pixel replays K1's decisions on them.
//  4. The per-Gaussian sums over the sub-tile's pixels. Per warp, skipped
//     when __ballot_sync shows that no lane contributes; the 39 values are
//     summed eight at a time by a butterfly that halves the values a lane
//     holds at each exchange (4 + 2 + 1 shuffles, then 2 on the one value
//     left: 9 shuffles for 8 sums where a tree for each would take 40).
//     Eight lanes then store the warp's sums in the warp's own slots of the
//     round's table in shared memory (a warp meets a row once a round), and
//     after the round's barrier the CTA adds each row's sums over the warps
//     that wrote them and the nonzero totals to the gradient table with one
//     global atomicAdd: at most one a (row, column) a round, where each of
//     the tile's 32 warps used to add its own, and none for rows no warp
//     touched. Stores, not shared atomics: on sm_90 a float atomicAdd on
//     shared memory compiles to a compare-and-swap loop, and the warps of a
//     CTA meet on the same rows. The butterfly stays: a lane-by-lane sum of
//     the colors over the contributing lanes, reading their output
//     gradients, is slower at any count of contributing lanes.
// Atomics are needed because a Gaussian lies in several tiles and CTAs run
// at the same time (the TPU kernel is free of them only because its grid
// runs in sequence); the order of those float additions changes from run
// to run, so results agree with the plain version to rounding, not bit for
// bit. A sub-tile stops once its pixels have all stopped: a stopped pixel
// contributes to no later instance.

#include <cuda_runtime.h>

#include <cstdint>

#include "blend_subtile.cuh"

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

// 64 rows a round, two buffers (22.5 KB); the warps' sums of a round take 80 KB
using BwdStage = RowStage<64, 2>;
constexpr int kRows = BwdStage::rows_a_round;
constexpr int kWarps = kMaxSubThreads / 32;
constexpr int kSums = 39;   // per-Gaussian sums: 6 geometry, inverse depth, 32 colors

// Where sum k of a row goes in the (P, 44) gradient table.
__device__ __forceinline__ int sum_column(int k) {
  return k < 6 ? k : (k == 6 ? kGeom + kChannels : kGeom + k - 7);
}

// Shared memory of a K3 CTA: the stage; each warp's sums of the round's
// rows, (kWarps, kRows, kSums); and a mask a warp of the rows it wrote.
struct BwdShared {
  BwdStage st;
  float sums[kWarps][kRows][kSums];
  uint32_t wrote[kWarps][kRows / 32];
};

__global__ void __launch_bounds__(kMaxSubThreads, 2) blend_bwd_kernel(
    const float4* __restrict__ rows, const int* __restrict__ order,
    const int* __restrict__ ranges, const float* __restrict__ bg,
    const float* __restrict__ color, const float* __restrict__ invdepth,
    const float* __restrict__ final_t, const float* __restrict__ g_color,
    const float* __restrict__ g_invdepth, float* __restrict__ d_rows,
    int width, int tile, int grid_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  BwdShared& sh = *reinterpret_cast<BwdShared*>(smem);
  BwdStage& st = sh.st;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int slot = sum_slot(lane);         // the sum this lane holds after warp_sum8
  const bool adds = (lane & 3) == 0;       // one of the four lanes that share a slot adds it
  const SubTile sub = subtile_of(tile, grid_x);   // every thread holds a pixel (sub^2 % 32 == 0)
  const float fx = static_cast<float>(sub.px);
  const float fy = static_cast<float>(sub.py);
  const int64_t pix = static_cast<int64_t>(sub.py) * width + sub.px;

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
  const WarpBox box = warp_box(sub);

  const int warp = tid >> 5;
  RowPipe<BwdStage, PlainRows> pipe(st, PlainRows{rows}, order, ranges[sub.tile_id],
                                    ranges[sub.tile_id + 1], kRows, true);
  if (tid == 0) stage_init(st);
  __syncthreads();
  pipe.prologue();

  for (int r = 0; r < pipe.n_rounds; ++r) {
    // Frees the buffer of round r - 1 (walked and flushed) and ends the
    // sub-tile once every pixel is done; the copies in flight must land first.
    if (__syncthreads_count(!done) == 0) {
      pipe.drain(r);
      break;
    }
    if (pipe.next < pipe.n_rounds) pipe.issue_next();
    pipe.wait(r);
    const int b = r % BwdStage::depth;
    const int n = pipe.rows_in(r);
    const float4* rows_b = st.rows[b];
    uint32_t wrote[BwdStage::words] = {};
    if (__ballot_sync(kFullMask, !done) != 0u) {   // else the whole warp has stopped
      uint32_t keep[BwdStage::words];
      cull_warp(rows_b, n, box, keep);
#pragma unroll
      for (int kw = 0; kw < BwdStage::words; ++kw) {
        uint32_t m = keep[kw];
        while (m != 0u) {
          const int bit = __ffs(m) - 1;
          const int j = kw * 32 + bit;
          m &= m - 1u;
          // a row's 44 floats as 11 float4 (16-byte aligned): geometry, then colors
          const float4* s4 = rows_b + j * kRow4;
          const float4 g0 = s4[0], g1 = s4[1];
          const float s[6] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y};
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
          if (__ballot_sync(kFullMask, use) == 0u) continue;

          // a lane that does not contribute adds zeros (and must not touch
          // gexp, which is inf for a large positive power)
          float w = 0.0f;
          float geo[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          if (use) {
            float gc = 0.0f;
#pragma unroll
            for (int c = 0; c < kChannels; c += 4) {
              const float4 v = s4[2 + c / 4];
              gc += v.x * g[c];
              gc += v.y * g[c + 1];
              gc += v.z * g[c + 2];
              gc += v.w * g[c + 3];
            }
            gc += s4[2 + kChannels / 4].x * g[kChannels];
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
          // the warp's sums of this row: sums 0..5 the geometry, 6 the
          // inverse depth, 7.. the colors; stored, not added (a warp meets a
          // row once a round)
          float* d = sh.sums[warp][j];
          {
            const float v = warp_sum8(geo, lane);
            if (adds && slot < 7) d[slot] = v;
          }
#pragma unroll
          for (int c0 = 0; c0 < kChannels; c0 += 8) {
            float v8[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) v8[i] = w * g[c0 + i];
            const float v = warp_sum8(v8, lane);
            if (adds) d[7 + c0 + slot] = v;
          }
          wrote[kw] |= 1u << bit;
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int kw = 0; kw < BwdStage::words; ++kw) sh.wrote[warp][kw] = wrote[kw];
    }
    // the round's sums are complete: each (row, sum) is added over the warps
    // that wrote it, in warp order, and to the gradient table with one
    // global add if it is not zero
    __syncthreads();
    for (int i = tid; i < n * kSums; i += blockDim.x) {
      const int j = i / kSums;
      const int k = i - j * kSums;
      float v = 0.0f;
#pragma unroll
      for (int ow = 0; ow < kWarps; ++ow) {
        if (ow < static_cast<int>(blockDim.x >> 5) && ((sh.wrote[ow][j >> 5] >> (j & 31)) & 1u)) {
          v += sh.sums[ow][j][k];
        }
      }
      if (v != 0.0f) {
        atomicAdd(d_rows + static_cast<int64_t>(st.gids[b][j]) * kRow + sum_column(k), v);
      }
    }
  }
}

}  // namespace

// rows (P, 44) f32 (16-byte aligned), order (N,) i32, ranges (gy*gx + 1,)
// i32 (tiles row-major), bg (32,) f32, the forward's color (H, W, 32),
// invdepth (H, W), final_t (H, W), the output gradients g_color (H, W, 32),
// g_invdepth (H, W) -> d_rows (P, 44) f32, which must be zero on entry
// (sums are added to it). H and W are multiples of tile, and tile is a
// multiple of 8, at most 32 (so a sub-tile is whole warps).
extern "C" int guava_blend_bwd(const float* rows, const int* order, const int* ranges,
                               const float* bg, const float* color, const float* invdepth,
                               const float* final_t, const float* g_color,
                               const float* g_invdepth, float* d_rows, int height, int width,
                               int tile, void* stream) {
  if (tile % 8 != 0 || tile > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int n_ctas = subtile_ctas(height, width, tile);
  if (n_ctas > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        blend_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(BwdShared));
    if (err != cudaSuccess) return static_cast<int>(err);
    blend_bwd_kernel<<<n_ctas, subtile_threads(tile), sizeof(BwdShared),
                       static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(rows), order, ranges, bg, color, invdepth, final_t,
        g_color, g_invdepth, d_rows, width, tile, width / tile);
  }
  return static_cast<int>(cudaGetLastError());
}

// CTAs of K3 resident on one SM at once for a tile -> *ctas; its dynamic
// shared memory a CTA -> *smem_bytes.
extern "C" int guava_blend_bwd_occupancy(int tile, int* ctas, int* smem_bytes) {
  *smem_bytes = static_cast<int>(sizeof(BwdShared));
  cudaError_t err = cudaFuncSetAttribute(
      blend_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(BwdShared));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, blend_bwd_kernel, subtile_threads(tile), sizeof(BwdShared)));
}
