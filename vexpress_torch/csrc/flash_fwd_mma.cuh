// The bf16 mma.sync forward kernel of T1 (flash_variants.cu) and T2
// (splash_fwd.cu): K1's design before its redesign for Hopper
// (flash_fwd_wgmma.cuh); each of those sources states what it replaces and its
// bound. Every source that includes this header gets its own copies of the
// instantiations it launches (anonymous namespace).
//
// One block of BQ/16 warps per (BQ query rows, HB (batch, head) pairs). Each
// warp owns 16 rows; its Q fragments stay in registers for the whole key loop.
// K/V tiles of BK keys are staged in shared memory with 16-byte loads, their
// head dim zero-padded to DP (a multiple of the mma depth 16) there and in the
// Q fragments; padded output columns are never stored. S = Q K^T and O += P V
// run on the tensor cores through mma.sync m16n8k16 (bf16 in, fp32
// accumulate); P goes from the S accumulators straight into A fragments, so
// the probabilities never touch shared memory. The running max and sum and the
// accumulator are fp32; the output is divided by the sum once, at the end.
//
// The HB pairs of a block are walked in turn, reusing the block's registers and
// shared memory: HB changes only how many blocks the grid has and how much work
// each does (the GPU counterpart of the TPU kernel's block_b, which amortised a
// fixed per-grid-step cost that a GPU block does not pay). Giving each pair its
// own warps instead would multiply the block's shared memory by HB for the same
// work per warp.
//
// Template flag P_SPLIT (T2's: p enters P V as the bf16 pair p_hi + p_lo, see
// splash_fwd.cu).

#pragma once

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace vx;

// (lo, hi) rounded to bf16 (`hi_bits`) and what that rounding left, rounded
// to bf16 (`lo_bits`): hi + lo holds each value to about 16 significant bits
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& hi_bits,
                                           uint32_t& lo_bits) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  const float2 rf = __bfloat1622float2(r);
  hi_bits = *reinterpret_cast<const uint32_t*>(&r);
  lo_bits = pack_bf16(lo - rf.x, hi - rf.y);
}

// `scale`: the softmax scale times log2(e), applied to the logits (T2's q is
// pre-scaled, so its scale is log2(e) alone).
template <int D, int BQ = 64, int BK = 64, int DP = (D + 15) / 16 * 16, int HB = 1,
          bool P_SPLIT = false>
__global__ void __launch_bounds__(BQ * 2)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H, int Lk,
              Strides st, float scale) {
  static_assert(BQ == 64 || BQ == 128, "4 or 8 warps of 16 rows");
  static_assert(BK % 16 == 0 && DP % 16 == 0 && DP >= D && D % 8 == 0, "mma tiling");
  constexpr int KD = DP / 16;   // k-steps of S = Q K^T
  constexpr int NT = DP / 8;    // n-tiles of O
  constexpr int SS = DP + 8;    // smem row stride: conflict-free fragment reads
  constexpr int VPR = D / 8;    // 16-byte vectors per staged row
  static_assert(2 * BK * SS * sizeof(__nv_bfloat16) <= 48 * 1024, "static shared memory");
  __shared__ __align__(16) __nv_bfloat16 ks[BK * SS];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * SS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // zero the padded columns once; staging never writes them
  for (int i = tid; i < BK * (SS - D); i += blockDim.x) {
    const int r = i / (SS - D), c = D + i % (SS - D);
    ks[r * SS + c] = __float2bfloat16(0.f);
    vs[r * SS + c] = __float2bfloat16(0.f);
  }

  const uint16_t* vsu = reinterpret_cast<const uint16_t*>(vs);
  const long long r0 = (long long)blockIdx.x * BQ + warp * 16 + g;

#pragma unroll 1
  for (int pair = 0; pair < HB; ++pair) {
    const int bh = blockIdx.y * HB + pair;
    const int b = bh / H, h = bh % H;
    const __nv_bfloat16* qb = q + b * st.q_b + h * st.q_h;
    const __nv_bfloat16* kb = k + b * st.k_b + h * st.k_h;
    const __nv_bfloat16* vb = v + b * st.v_b + h * st.v_h;
    __nv_bfloat16* ob = o + b * st.o_b + h * st.o_h;

    // Q fragments of this warp's 16 rows (A operand, row-major), kept in registers
    uint32_t qf[KD][4];
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c = kd * 16 + 2 * t;
      const __nv_bfloat16* p0 = qb + r0 * st.q_l;
      const __nv_bfloat16* p1 = qb + (r0 + 8) * st.q_l;
      qf[kd][0] = c < D ? *reinterpret_cast<const uint32_t*>(p0 + c) : 0u;
      qf[kd][1] = c < D ? *reinterpret_cast<const uint32_t*>(p1 + c) : 0u;
      qf[kd][2] = c + 8 < D ? *reinterpret_cast<const uint32_t*>(p0 + c + 8) : 0u;
      qf[kd][3] = c + 8 < D ? *reinterpret_cast<const uint32_t*>(p1 + c + 8) : 0u;
    }

    // running max of rows g and g+8, log2 units
    float m0 = -INFINITY, m1 = -INFINITY;
    float l0 = 0.f, l1 = 0.f;  // this thread's share of the running sums
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    for (int kt = 0; kt < Lk; kt += BK) {
      __syncthreads();  // the previous tile (of this pair or the last) is consumed
      for (int i = tid; i < BK * VPR; i += blockDim.x) {
        const int r = i / VPR, c = (i % VPR) * 8;
        *reinterpret_cast<uint4*>(ks + r * SS + c) =
            *reinterpret_cast<const uint4*>(kb + (long long)(kt + r) * st.k_l + c);
        *reinterpret_cast<uint4*>(vs + r * SS + c) =
            *reinterpret_cast<const uint4*>(vb + (long long)(kt + r) * st.v_l + c);
      }
      __syncthreads();

      // S (16 x BK) = Q K^T; n-tile j covers keys 8j..8j+7
      float s[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        const __nv_bfloat16* kr = ks + (8 * j + g) * SS + 2 * t;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kd * 16);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kd * 16 + 8);
          mma_bf16_16816(s[j], qf[kd], b0, b1);
        }
      }

      // online softmax: rows g (c0, c1) and g+8 (c2, c3); a row's BK values
      // are spread over the 4 lanes of a quad
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[j][0] *= scale;
        s[j][1] *= scale;
        s[j][2] *= scale;
        s[j][3] *= scale;
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // 0 on the first tile
      const float a0 = exp2f(m0 - mx0);
      const float a1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[j][0] = exp2f(s[j][0] - m0);
        s[j][1] = exp2f(s[j][1] - m0);
        s[j][2] = exp2f(s[j][2] - m1);
        s[j][3] = exp2f(s[j][3] - m1);
        rs0 += s[j][0] + s[j][1];
        rs1 += s[j][2] + s[j][3];
      }
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= a0;
        acc[n][1] *= a0;
        acc[n][2] *= a1;
        acc[n][3] *= a1;
      }

      // O += P V; the S accumulators of n-tiles 2kk and 2kk+1 are the A
      // fragment of keys 16kk..16kk+15
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4], pl[4];
        if constexpr (P_SPLIT) {
          split_bf16(s[2 * kk][0], s[2 * kk][1], pa[0], pl[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], pa[1], pl[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2], pl[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3], pl[3]);
        } else {
          pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        }
        const uint16_t* vr = vsu + (kk * 16 + 2 * t) * SS + g;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint16_t* vp = vr + n * 8;
          const uint32_t b0 = (uint32_t)vp[0] | ((uint32_t)vp[SS] << 16);
          const uint32_t b1 = (uint32_t)vp[8 * SS] | ((uint32_t)vp[9 * SS] << 16);
          mma_bf16_16816(acc[n], pa, b0, b1);
          if constexpr (P_SPLIT) mma_bf16_16816(acc[n], pl, b0, b1);
        }
      }
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    __nv_bfloat16* o0 = ob + r0 * st.o_l;
    __nv_bfloat16* o1 = ob + (r0 + 8) * st.o_l;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < D) {
        *reinterpret_cast<uint32_t*>(o0 + c) = pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
        *reinterpret_cast<uint32_t*>(o1 + c) = pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
      }
    }
  }
}

// One launch of a bf16 instantiation on stream `s`: grid (Lq/BQ, B*H/HB),
// BQ/16 warps a block. The caller checks that BQ divides Lq, BK divides Lk
// and HB divides B*H.
template <int D, int BQ, int BK, int DP, int HB, bool P_SPLIT>
void launch_mma(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq,
                int Lk, const Strides& st, float scale, cudaStream_t s) {
  const dim3 grid(Lq / BQ, B * H / HB);
  flash_fwd_mma<D, BQ, BK, DP, HB, P_SPLIT><<<grid, BQ * 2, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, Lk, st, scale);
}

// Strides from 12 element strides: (batch, head, row) of q, k, v, o in turn.
inline Strides strides_from(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
}

}  // namespace
