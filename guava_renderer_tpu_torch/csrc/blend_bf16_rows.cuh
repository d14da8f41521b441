// K6's packed rows (kernels/blend.py:pack_rows_bf16) and their widening to
// the f32 rows the blend walks. A packed row is 56 bf16 (112 bytes, seven
// 16-byte pieces, one bulk copy): the 8 geometry values as bf16 hi and lo
// halves (value = hi + lo), then the 32 colors and the inverse depth as
// plain bf16, then zeros. In memory bf16 2i is the low half of 32-bit word
// i, and a bf16 is the top half of the float it stands for, so widening is
// exact.
//
// The widening rounds as kernels/blend.py:unpack_rows_bf16 does (one f32
// addition for the geometry, exact elsewhere, the pad 0), so K6 walks the
// same f32 values as K1 on the unpacked rows. It uses nothing but
// __uint_as_float, __fadd_rn and make_float4, so a host compiler given
// those three can hold it against unpack_rows_bf16
// (tests/test_torch_blend_bf16.py).

#pragma once

#include <cstdint>

namespace guava_blend {

constexpr int kPackedWords = 28;                        // 56 bf16, two a word
constexpr uint32_t kPackedBytes = 4 * kPackedWords;     // 112

__device__ __forceinline__ float bf16_low(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_high(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Floats 4k .. 4k + 3 (0 <= k < 11) of the f32 row that the packed row of
// words p stands for: geometry (k < 2) hi + lo, hi at bf16 4k and lo at
// bf16 8 + 4k; float j of the colors and inverse depth (8 <= j <= 40) is
// bf16 j + 8; floats 41 .. 43 (the pad) are 0.
__device__ __forceinline__ float4 widen_packed4(const uint32_t* p, int k) {
  if (k < 2) {
    const uint32_t h0 = p[2 * k], h1 = p[2 * k + 1], l0 = p[2 * k + 4], l1 = p[2 * k + 5];
    return make_float4(__fadd_rn(bf16_low(h0), bf16_low(l0)),
                       __fadd_rn(bf16_high(h0), bf16_high(l0)),
                       __fadd_rn(bf16_low(h1), bf16_low(l1)),
                       __fadd_rn(bf16_high(h1), bf16_high(l1)));
  }
  const uint32_t a = p[2 * k + 4];
  if (k == 10) return make_float4(bf16_low(a), 0.0f, 0.0f, 0.0f);   // inverse depth, pad
  const uint32_t b = p[2 * k + 5];
  return make_float4(bf16_low(a), bf16_high(a), bf16_low(b), bf16_high(b));
}

}  // namespace guava_blend
