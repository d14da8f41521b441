// What the forward tile blend (blend.cu) and its backward (blend_bwd.cu)
// must agree on bit for bit: the row layout, the thresholds, and the float
// expression that decides whether an (instance, pixel) pair contributes.
//
// The backward replays the forward's walk and has to take the same
// decisions (skip, contribute, stop). A compiler is free to contract
// a * b + c into one fused multiply-add in one kernel and not in the other,
// which moves `power` by an ulp and can flip a `< 1/255` or `< 1e-4` test on
// a borderline pixel. So the shared expression is written with the
// explicit-rounding intrinsics, which the compiler never re-associates or
// contracts, and both kernels call it.

#pragma once

#include <cuda_runtime.h>

namespace guava_blend {

constexpr int kGeom = 8;                 // x, y, conic a/b/c, alpha, 0, 0
constexpr int kChannels = 32;
constexpr int kRow = 44;                 // kGeom + 32 colors + invdepth + 3 pad
constexpr int kRow4 = kRow / 4;          // 11 float4 a row
constexpr int kBatch = 256;              // rows a round: 45,056 B of shared memory
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTMin = 1e-4f;

// s: one staged row; (fx, fy): the pixel. Writes the offsets d0, d1 and
// power = -(a d0^2 + c d1^2)/2 - b d0 d1.
__device__ __forceinline__ float gauss_power(const float* __restrict__ s, float fx, float fy,
                                             float& d0, float& d1) {
  d0 = __fsub_rn(s[0], fx);
  d1 = __fsub_rn(s[1], fy);
  const float q = __fmaf_rn(__fmul_rn(s[2], d0), d0, __fmul_rn(__fmul_rn(s[4], d1), d1));
  return __fmaf_rn(-0.5f, q, -__fmul_rn(__fmul_rn(s[3], d0), d1));
}

// Transmittance after a contribution of opacity alpha.
__device__ __forceinline__ float next_t(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

// Stage rows order[base : base + n] of the (P, 44) table into shared memory
// (16-byte loads); with gids, also their Gaussian ids.
__device__ __forceinline__ void stage_rows(float4* stage, int* gids,
                                           const float4* __restrict__ rows,
                                           const int* __restrict__ order, int base, int n) {
  for (int i = threadIdx.x; i < n * kRow4; i += blockDim.x) {
    const int r = i / kRow4;
    const int gid = order[base + r];
    stage[i] = rows[static_cast<long long>(gid) * kRow4 + (i - r * kRow4)];
    if (gids != nullptr && i == r * kRow4) gids[r] = gid;
  }
}

}  // namespace guava_blend
