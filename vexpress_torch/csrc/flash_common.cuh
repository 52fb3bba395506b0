// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// and the forward templates): dtype conversions, bf16 packing, K2's
// roundings, element strides and the mma.sync m16n8k16 bf16 product.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1],
//                   a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16x8, col):  b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16x8):       c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// so the accumulators of two neighbouring n-tiles are, packed to bf16, the A
// fragment of one 16-wide k-step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vx {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// element strides of the forward kernels: batch, head, row (the head dim is contiguous)
struct Strides {
  long long q_b, q_h, q_l, k_b, k_h, k_l, v_b, v_h, v_l, o_b, o_h, o_l;
};

// D(16x8, fp32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of 16 rows (row0 = first row + g) of a (rows, D) bf16 matrix
// with row stride `ld`, zero-padded past column D to KD*16 columns.
template <int D, int KD>
__device__ __forceinline__ void load_a_rows(uint32_t f[KD][4], const __nv_bfloat16* base,
                                            long long row0, long long ld, int t) {
  const __nv_bfloat16* p0 = base + row0 * ld;
  const __nv_bfloat16* p1 = base + (row0 + 8) * ld;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int c = kd * 16 + 2 * t;
    f[kd][0] = c < D ? *reinterpret_cast<const uint32_t*>(p0 + c) : 0u;
    f[kd][1] = c < D ? *reinterpret_cast<const uint32_t*>(p1 + c) : 0u;
    f[kd][2] = c + 8 < D ? *reinterpret_cast<const uint32_t*>(p0 + c + 8) : 0u;
    f[kd][3] = c + 8 < D ? *reinterpret_cast<const uint32_t*>(p1 + c + 8) : 0u;
  }
}

// Copy `rows` rows of D bf16 values (16-byte vectors) from global memory into
// shared memory with row stride SS; columns D..SS-1 are left as they are.
template <int D, int SS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long ld, int rows, int tid, int nthreads) {
  constexpr int VPR = D / 8;
  for (int i = tid; i < rows * VPR; i += nthreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    *reinterpret_cast<uint4*>(dst + r * SS + c) =
        *reinterpret_cast<const uint4*>(src + (long long)r * ld + c);
  }
}

// Zero columns D..SS-1 of `rows` shared-memory rows.
template <int D, int SS>
__device__ __forceinline__ void zero_pad_cols(__nv_bfloat16* s, int rows, int tid, int nthreads) {
  for (int i = tid; i < rows * (SS - D); i += nthreads) {
    const int r = i / (SS - D), c = D + i % (SS - D);
    s[r * SS + c] = __float2bfloat16(0.f);
  }
}

// B fragment (b0, b1) of k-step rows 16kk..16kk+15 and column n0 + g of a
// shared-memory matrix whose rows are the k index: two bf16 from two rows.
__device__ __forceinline__ void load_b_krows(uint32_t& b0, uint32_t& b1, const uint16_t* s,
                                             int SS) {
  b0 = (uint32_t)s[0] | ((uint32_t)s[SS] << 16);
  b1 = (uint32_t)s[8 * SS] | ((uint32_t)s[9 * SS] << 16);
}

}  // namespace vx
