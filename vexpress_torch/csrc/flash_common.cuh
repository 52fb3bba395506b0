// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// and the forward and backward templates): bf16 packing, K2's roundings
// and the shape check every launch makes.
//
// The A fragment of a 16-deep k-step that an RS wgmma reads from registers
// (hopper.cuh) is mma.sync m16n8k16's (g = lane / 4, t = lane % 4):
//   A (16x16, row): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1],
//                   a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
// and its accumulator C (16x8): c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1],
// so the accumulators of two neighbouring 8-column groups are, packed to
// bf16, the A fragment of one 16-wide k-step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vx {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// exp of x rounded to bf16, the result rounded to bf16 (K2's probability)
__device__ __forceinline__ float exp_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(__expf(__bfloat162float(__float2bfloat16_rn(x)))));
}

// bf16 pair times s, rounded to bf16 (K2's q pre-scale)
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * s, f.y * s);
}

// what every flash launch takes: Lq and Lk positive multiples of 64, at most
// 65535 (batch, head) pairs (the grid's y)
inline bool flash_shape_ok(int B, int H, int Lq, int Lk) {
  return Lq % 64 == 0 && Lk % 64 == 0 && Lq > 0 && Lk > 0 && B * H <= 65535;
}

}  // namespace vx
