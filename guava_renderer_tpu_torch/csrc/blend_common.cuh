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
// contracts, and every kernel calls it. It rounds each product and sum in
// the order of the plain PyTorch versions (kernels/blend.py), which run
// one operation at a time, so the kernels take the plain versions'
// decisions as well.

#pragma once

#include <cuda_runtime.h>

namespace guava_blend {

constexpr int kGeom = 8;                 // x, y, conic a/b/c, alpha, 0, 0
constexpr int kChannels = 32;
constexpr int kRow = 44;                 // kGeom + 32 colors + invdepth + 3 pad
constexpr int kRow4 = kRow / 4;          // 11 float4 a row
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTMin = 1e-4f;

// s: one staged row; (fx, fy): the pixel. Writes the offsets d0, d1 and
// power = -0.5 * (a d0 d0 + c d1 d1) - b d0 d1, rounded step by step from
// the left as the plain versions round it.
__device__ __forceinline__ float gauss_power(const float* __restrict__ s, float fx, float fy,
                                             float& d0, float& d1) {
  d0 = __fsub_rn(s[0], fx);
  d1 = __fsub_rn(s[1], fy);
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(s[2], d0), d0),
                            __fmul_rn(__fmul_rn(s[4], d1), d1));
  return __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(s[3], d0), d1));
}

// Transmittance after a contribution of opacity alpha.
__device__ __forceinline__ float next_t(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

}  // namespace guava_blend
