// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: the backward of the JAX library's Pallas TPU flash_attention that
// vexpress_tpu/ops/flash.py::flash_sdpa reaches under jax.value_and_grad
// (jax/experimental/pallas/ops/tpu/flash_attention.py: _flash_attention_bwd_dkv,
// pallas_call :1121, and _flash_attention_bwd_dq, pallas_call :1456). Same
// functions, non-causal, per (batch, head):
//   P  = exp(scale * q k^T - lse)          (lse from the forward, fp32)
//   dv = P^T do                            dP = do v^T
//   dS = P * (dP - di), di = rowsum(do * o) (computed by the caller, fp32)
//   dk = scale * dS^T q                    dq = scale * dS k
// Two kernels, as the TPU library has, each deterministic (no atomics).
// Nothing of size Lq x Lk reaches device memory.
//
// Bound on an H100 SXM: 8*B*H*Lq*Lk*D tensor-core operations for dk/dv (S,
// dP, dv, dk) and 6*B*H*Lq*Lk*D for dq (S, dP, dq), over about 2*(2*Lq +
// 2*Lk)*B*H*D bytes each: far above the ~295 op/byte ridge at every
// training shape, so operations bound both. Each kernel also recomputes P,
// one exp per (query, key) pair on the SFUs.
//
// What runs where:
// * bf16 at D=40 and D=80 (every training shape): flash_bwd_dkv_wgmma and
//   flash_bwd_dq_wgmma (flash_bwd_wgmma.cuh): TMA loads of 64-row boxes of
//   the 4-D (D, H, L, B) tensor maps into an mbarrier ring (3 stages for
//   dk/dv, 4 for dq), a
//   producer warpgroup and two wgmma consumer warpgroups per 128 keys (dk/dv)
//   or 128 queries (dq). The host geometry (maps, grid, shared memory, query
//   parts) comes from ops/flash_tma.py (`bwd_geometry`), the maps are encoded
//   here (hopper.cuh's `encode`). Where B*H*ceil(Lk/128) blocks would not
//   fill the card (attn1_5 and the reference net's B=1 rows), the dk/dv
//   kernel splits the query axis into parts (ops/flash_tma.py::dkv_splits);
//   each part writes fp32 partial sums into a workspace the wrapper
//   allocates, and flash_bwd_dkv_sum adds them in part order and writes bf16.
// * bf16 at D=160 (off every path: its levels are below sdpa's Lk >= 512):
//   the first design's mma.sync m16n8k16 kernels, one block of 4 warps per
//   64 keys or 64 queries, synchronous staging through padded shared memory.
// * fp32 (the parity phases): the same two loops with scalar FMAs (4 threads
//   per row, each owning D/4 columns).
// Not done yet: the D=160 kernels on wgmma; one kernel for the pair (dq
// summed across key blocks with fp32 atomics, no longer deterministic).
//
// Layout: q, o, do, dq (B, Lq, H*D); k, v, dk, dv (B, Lk, H*D). The wgmma
// kernels take them contiguous; the others read and write through the batch
// and row strides given (elements; the last dim contiguous). lse and di are
// contiguous (B, H, Lq) fp32. Lq and Lk multiples of 64, D one of 40, 80, 160
// (the wrapper checks). Launches go on the caller's stream, allocate nothing
// and do not synchronise; each function returns cudaGetLastError(), or a
// failed encode's code (vx_error_string names it).

#include <math.h>

#include "flash_bwd_wgmma.cuh"
#include "flash_common.cuh"

namespace {

using namespace vx;
using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;  // keys (dk/dv) or queries (dq) per block of the mma and scalar kernels

struct BwdStrides {
  long long q_b, q_l, k_b, k_l, v_b, v_l, do_b, do_l, dq_b, dq_l, dk_b, dk_l, dv_b, dv_l;
};

// ------------------------------------------------- dk/dv, bf16 mma (D=160)
template <int D, int QT>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Lq, BwdStrides st,
                  float scale, float scale_log2) {
  constexpr int DP = (D + 15) / 16 * 16;  // head dim padded to the mma depth
  constexpr int KD = DP / 16;
  constexpr int NT = DP / 8;
  constexpr int SS = DP + 8;  // smem row stride
  __shared__ __align__(16) bf16 qs[QT * SS];
  __shared__ __align__(16) bf16 dos[QT * SS];
  __shared__ float lse_s[QT];  // log2 units
  __shared__ float di_s[QT];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const bf16* qb = q + b * st.q_b + h * D;
  const bf16* dob = dout + b * st.do_b + h * D;
  const float* lseb = lse + (long long)bh * Lq;
  const float* dib = di + (long long)bh * Lq;

  zero_pad_cols<D, SS>(qs, QT, tid, blockDim.x);
  zero_pad_cols<D, SS>(dos, QT, tid, blockDim.x);

  // K and V fragments of this warp's 16 keys (A operands: keys x d)
  const long long k0 = (long long)blockIdx.x * ROWS + warp * 16 + g;
  uint32_t kf[KD][4], vf[KD][4];
  load_a_rows<D, KD>(kf, k + b * st.k_b + h * D, k0, st.k_l, t);
  load_a_rows<D, KD>(vf, v + b * st.v_b + h * D, k0, st.v_l, t);

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;
  }

  const uint16_t* qsu = reinterpret_cast<const uint16_t*>(qs);
  const uint16_t* dosu = reinterpret_cast<const uint16_t*>(dos);

  for (int qt = 0; qt < Lq; qt += QT) {
    __syncthreads();  // the previous tile is consumed
    stage_rows<D, SS>(qs, qb + (long long)qt * st.q_l, st.q_l, QT, tid, blockDim.x);
    stage_rows<D, SS>(dos, dob + (long long)qt * st.do_l, st.do_l, QT, tid, blockDim.x);
    for (int i = tid; i < QT; i += blockDim.x) {
      lse_s[i] = lseb[qt + i] * LOG2E;
      di_s[i] = dib[qt + i];
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T (16 keys x QT queries); n-tile j covers
    // queries 8j..8j+7
    float s[QT / 8][4], dp[QT / 8][4];
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
      const bf16* qr = qs + (8 * j + g) * SS + 2 * t;
      const bf16* dr = dos + (8 * j + g) * SS + 2 * t;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        mma_bf16_16816(s[j], kf[kd], *reinterpret_cast<const uint32_t*>(qr + kd * 16),
                       *reinterpret_cast<const uint32_t*>(qr + kd * 16 + 8));
        mma_bf16_16816(dp[j], vf[kd], *reinterpret_cast<const uint32_t*>(dr + kd * 16),
                       *reinterpret_cast<const uint32_t*>(dr + kd * 16 + 8));
      }
    }

    // P^T and dS^T in place; accumulator columns 8j+2t, 8j+2t+1 are queries
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float l0 = lse_s[c], l1 = lse_s[c + 1];
      const float d0 = di_s[c], d1 = di_s[c + 1];
      s[j][0] = exp2f(s[j][0] * scale_log2 - l0);
      s[j][1] = exp2f(s[j][1] * scale_log2 - l1);
      s[j][2] = exp2f(s[j][2] * scale_log2 - l0);
      s[j][3] = exp2f(s[j][3] * scale_log2 - l1);
      dp[j][0] = s[j][0] * (dp[j][0] - d0);
      dp[j][1] = s[j][1] * (dp[j][1] - d1);
      dp[j][2] = s[j][2] * (dp[j][2] - d0);
      dp[j][3] = s[j][3] * (dp[j][3] - d1);
    }

    // dv += P^T dO and dk += dS^T Q; k-step kk covers queries 16kk..16kk+15
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
      const int r = (kk * 16 + 2 * t) * SS + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        load_b_krows(b0, b1, dosu + r + n * 8, SS);
        mma_bf16_16816(dva[n], pa, b0, b1);
        load_b_krows(b0, b1, qsu + r + n * 8, SS);
        mma_bf16_16816(dka[n], da, b0, b1);
      }
    }
  }

  bf16* dk0 = dk + b * st.dk_b + h * D + k0 * st.dk_l;
  bf16* dk1 = dk0 + 8 * st.dk_l;
  bf16* dv0 = dv + b * st.dv_b + h * D + k0 * st.dv_l;
  bf16* dv1 = dv0 + 8 * st.dv_l;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    if (c < D) {
      *reinterpret_cast<uint32_t*>(dk0 + c) = pack_bf16(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dk1 + c) = pack_bf16(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dv0 + c) = pack_bf16(dva[n][0], dva[n][1]);
      *reinterpret_cast<uint32_t*>(dv1 + c) = pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

// ---------------------------------------------------- dq, bf16 mma (D=160)
template <int D, int KT>
__global__ void __launch_bounds__(128)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 bf16* __restrict__ dq, int H, int Lq, int Lk, BwdStrides st, float scale,
                 float scale_log2) {
  constexpr int DP = (D + 15) / 16 * 16;
  constexpr int KD = DP / 16;
  constexpr int NT = DP / 8;
  constexpr int SS = DP + 8;
  __shared__ __align__(16) bf16 ks[KT * SS];
  __shared__ __align__(16) bf16 vs[KT * SS];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const bf16* kb = k + b * st.k_b + h * D;
  const bf16* vb = v + b * st.v_b + h * D;

  zero_pad_cols<D, SS>(ks, KT, tid, blockDim.x);
  zero_pad_cols<D, SS>(vs, KT, tid, blockDim.x);

  // Q and dO fragments of this warp's 16 query rows (A operands)
  const long long r0 = (long long)blockIdx.x * ROWS + warp * 16 + g;
  uint32_t qf[KD][4], dof[KD][4];
  load_a_rows<D, KD>(qf, q + b * st.q_b + h * D, r0, st.q_l, t);
  load_a_rows<D, KD>(dof, dout + b * st.do_b + h * D, r0, st.do_l, t);
  const float lse0 = lse[(long long)bh * Lq + r0] * LOG2E;
  const float lse1 = lse[(long long)bh * Lq + r0 + 8] * LOG2E;
  const float di0 = di[(long long)bh * Lq + r0];
  const float di1 = di[(long long)bh * Lq + r0 + 8];

  float dqa[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  const uint16_t* ksu = reinterpret_cast<const uint16_t*>(ks);

  for (int kt = 0; kt < Lk; kt += KT) {
    __syncthreads();
    stage_rows<D, SS>(ks, kb + (long long)kt * st.k_l, st.k_l, KT, tid, blockDim.x);
    stage_rows<D, SS>(vs, vb + (long long)kt * st.v_l, st.v_l, KT, tid, blockDim.x);
    __syncthreads();

    // S = Q K^T and dP = dO V^T (16 queries x KT keys)
    float s[KT / 8][4], dp[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
      const bf16* kr = ks + (8 * j + g) * SS + 2 * t;
      const bf16* vr = vs + (8 * j + g) * SS + 2 * t;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        mma_bf16_16816(s[j], qf[kd], *reinterpret_cast<const uint32_t*>(kr + kd * 16),
                       *reinterpret_cast<const uint32_t*>(kr + kd * 16 + 8));
        mma_bf16_16816(dp[j], dof[kd], *reinterpret_cast<const uint32_t*>(vr + kd * 16),
                       *reinterpret_cast<const uint32_t*>(vr + kd * 16 + 8));
      }
    }

    // P and dS in place; rows g (c0, c1) and g+8 (c2, c3)
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      s[j][0] = exp2f(s[j][0] * scale_log2 - lse0);
      s[j][1] = exp2f(s[j][1] * scale_log2 - lse0);
      s[j][2] = exp2f(s[j][2] * scale_log2 - lse1);
      s[j][3] = exp2f(s[j][3] * scale_log2 - lse1);
      dp[j][0] = s[j][0] * (dp[j][0] - di0);
      dp[j][1] = s[j][1] * (dp[j][1] - di0);
      dp[j][2] = s[j][2] * (dp[j][2] - di1);
      dp[j][3] = s[j][3] * (dp[j][3] - di1);
    }

    // dq += dS K; k-step kk covers keys 16kk..16kk+15
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t da[4];
      da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
      const uint16_t* kr = ksu + (kk * 16 + 2 * t) * SS + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        load_b_krows(b0, b1, kr + n * 8, SS);
        mma_bf16_16816(dqa[n], da, b0, b1);
      }
    }
  }

  bf16* o0 = dq + b * st.dq_b + h * D + r0 * st.dq_l;
  bf16* o1 = o0 + 8 * st.dq_l;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    if (c < D) {
      *reinterpret_cast<uint32_t*>(o0 + c) = pack_bf16(dqa[n][0] * scale, dqa[n][1] * scale);
      *reinterpret_cast<uint32_t*>(o1 + c) = pack_bf16(dqa[n][2] * scale, dqa[n][3] * scale);
    }
  }
}

// ------------------------------------------------------------- scalar (SIMT)
constexpr int TT = 32;  // rows of the walked axis per shared-memory tile

// dk/dv: 4 threads per key, each owning D/4 columns
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dkv_simt(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ di,
                   float* __restrict__ dk, float* __restrict__ dv, int H, int Lq, BwdStrides st,
                   float scale, float scale_log2) {
  constexpr int DQ = D / 4;
  __shared__ float qs[TT][D];
  __shared__ float dos[TT][D];
  __shared__ float lse_s[TT];
  __shared__ float di_s[TT];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, row = tid >> 2, part = tid & 3;
  const long long ki = (long long)blockIdx.x * ROWS + row;

  const float* qb = q + b * st.q_b + h * D;
  const float* dob = dout + b * st.do_b + h * D;
  const float* kp = k + b * st.k_b + ki * st.k_l + h * D + part * DQ;
  const float* vp = v + b * st.v_b + ki * st.v_l + h * D + part * DQ;

  float kr[DQ], vr[DQ], dka[DQ], dva[DQ];
#pragma unroll
  for (int d = 0; d < DQ; ++d) {
    kr[d] = kp[d] * scale_log2;
    vr[d] = vp[d];
    dka[d] = dva[d] = 0.f;
  }

  for (int qt = 0; qt < Lq; qt += TT) {
    __syncthreads();
    for (int i = tid; i < TT * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      qs[r][c] = qb[(long long)(qt + r) * st.q_l + c];
      dos[r][c] = dob[(long long)(qt + r) * st.do_l + c];
    }
    for (int i = tid; i < TT; i += blockDim.x) {
      lse_s[i] = lse[(long long)bh * Lq + qt + i] * LOG2E;
      di_s[i] = di[(long long)bh * Lq + qt + i];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TT; ++j) {
      float a = 0.f, e = 0.f;
#pragma unroll
      for (int d = 0; d < DQ; ++d) {
        a = fmaf(kr[d], qs[j][part * DQ + d], a);
        e = fmaf(vr[d], dos[j][part * DQ + d], e);
      }
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      e += __shfl_xor_sync(0xffffffffu, e, 1);
      e += __shfl_xor_sync(0xffffffffu, e, 2);
      const float p = exp2f(a - lse_s[j]);
      const float ds = p * (e - di_s[j]);
#pragma unroll
      for (int d = 0; d < DQ; ++d) {
        dva[d] = fmaf(p, dos[j][part * DQ + d], dva[d]);
        dka[d] = fmaf(ds, qs[j][part * DQ + d], dka[d]);
      }
    }
  }

  float* dkp = dk + b * st.dk_b + ki * st.dk_l + h * D + part * DQ;
  float* dvp = dv + b * st.dv_b + ki * st.dv_l + h * D + part * DQ;
#pragma unroll
  for (int d = 0; d < DQ; ++d) {
    dkp[d] = dka[d] * scale;
    dvp[d] = dva[d];
  }
}

// dq: 4 threads per query row, each owning D/4 columns
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dq_simt(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  float* __restrict__ dq, int H, int Lq, int Lk, BwdStrides st, float scale,
                  float scale_log2) {
  constexpr int DQ = D / 4;
  __shared__ float ks[TT][D];
  __shared__ float vs[TT][D];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, row = tid >> 2, part = tid & 3;
  const long long qi = (long long)blockIdx.x * ROWS + row;

  const float* kb = k + b * st.k_b + h * D;
  const float* vb = v + b * st.v_b + h * D;
  const float* qp = q + b * st.q_b + qi * st.q_l + h * D + part * DQ;
  const float* dop = dout + b * st.do_b + qi * st.do_l + h * D + part * DQ;
  const float lse2 = lse[(long long)bh * Lq + qi] * LOG2E;
  const float dii = di[(long long)bh * Lq + qi];

  float qr[DQ], dor[DQ], dqa[DQ];
#pragma unroll
  for (int d = 0; d < DQ; ++d) {
    qr[d] = qp[d] * scale_log2;
    dor[d] = dop[d];
    dqa[d] = 0.f;
  }

  for (int kt = 0; kt < Lk; kt += TT) {
    __syncthreads();
    for (int i = tid; i < TT * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      ks[r][c] = kb[(long long)(kt + r) * st.k_l + c];
      vs[r][c] = vb[(long long)(kt + r) * st.v_l + c];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TT; ++j) {
      float a = 0.f, e = 0.f;
#pragma unroll
      for (int d = 0; d < DQ; ++d) {
        a = fmaf(qr[d], ks[j][part * DQ + d], a);
        e = fmaf(dor[d], vs[j][part * DQ + d], e);
      }
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      e += __shfl_xor_sync(0xffffffffu, e, 1);
      e += __shfl_xor_sync(0xffffffffu, e, 2);
      const float ds = exp2f(a - lse2) * (e - dii);
#pragma unroll
      for (int d = 0; d < DQ; ++d) dqa[d] = fmaf(ds, ks[j][part * DQ + d], dqa[d]);
    }
  }

  float* dqp = dq + b * st.dq_b + qi * st.dq_l + h * D + part * DQ;
#pragma unroll
  for (int d = 0; d < DQ; ++d) dqp[d] = dqa[d] * scale;
}

// query-tile (dk/dv) and key-tile (dq) width of the D=160 mma kernels
constexpr int MMA_WALK = 32;

// bf16 at D=160 (mma.sync) or fp32 (scalar), at any D the wrapper takes
template <int D>
void launch_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* di, void* dk, void* dv, int B, int H, int Lq,
                int Lk, const BwdStrides& st, float scale, cudaStream_t s) {
  const dim3 grid(Lk / ROWS, B * H);
  const float sl = scale * LOG2E;
  if constexpr (D == 160) {
    if (dtype == 1) {
      flash_bwd_dkv_mma<D, MMA_WALK><<<grid, 128, 0, s>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const bf16*>(dout), lse, di, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
          H, Lq, st, scale, sl);
      return;
    }
  }
  flash_bwd_dkv_simt<D><<<grid, 256, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, di, static_cast<float*>(dk), static_cast<float*>(dv),
      H, Lq, st, scale, sl);
}

template <int D>
void launch_dq(int dtype, const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* di, void* dq, int B, int H, int Lq, int Lk,
               const BwdStrides& st, float scale, cudaStream_t s) {
  const dim3 grid(Lq / ROWS, B * H);
  const float sl = scale * LOG2E;
  if constexpr (D == 160) {
    if (dtype == 1) {
      flash_bwd_dq_mma<D, MMA_WALK><<<grid, 128, 0, s>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<const bf16*>(dout), lse, di, static_cast<bf16*>(dq), H, Lq, Lk, st, scale,
          sl);
      return;
    }
  }
  flash_bwd_dq_simt<D><<<grid, 256, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, di, static_cast<float*>(dq), H, Lq, Lk, st, scale,
      sl);
}

BwdStrides strides_from(const long long* s) {
  return BwdStrides{s[0], s[1], s[2],  s[3],  s[4],  s[5],  s[6],
                    s[7], s[8], s[9], s[10], s[11], s[12], s[13]};
}

// The mma/scalar entries take fp32 at D=40, 80, 160 and bf16 at D=160 only:
// bf16 at D=40 and 80 is the wgmma kernels' (vx_flash_bwd_*_tma).
bool bad_args(int dtype, int B, int H, int Lq, int Lk, int D) {
  return (dtype != 0 && dtype != 1) || (dtype == 1 && D != 160) || !flash_shape_ok(B, H, Lq, Lk);
}

// ------------------------------------------------------- bf16 wgmma (TMA)
// dk, dv (bf16) = the sum of the dk/dv kernel's `parts` fp32 partial sums
// (ws: part p's dk at p*n, its dv at (parts+p)*n), added in part order, so
// the result does not depend on the schedule; n a multiple of 4
__global__ void __launch_bounds__(256)
flash_bwd_dkv_sum(const float* __restrict__ ws, int parts, long long n, bf16* __restrict__ dk,
                  bf16* __restrict__ dv) {
  const long long n4 = n / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < 2 * n4;
       i += (long long)gridDim.x * blockDim.x) {
    const bool is_v = i >= n4;
    const long long e = is_v ? i - n4 : i;
    const float4* src = reinterpret_cast<const float4*>(ws + (is_v ? parts * n : 0)) + e;
    float4 acc = src[0];
    for (int p = 1; p < parts; ++p) {
      const float4 x = src[p * n4];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    *reinterpret_cast<uint2*>((is_v ? dv : dk) + 4 * e) =
        make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
  }
}

// `geom` (ops/flash_tma.py::bwd_geometry_arg): swizzle bytes, box columns,
// box rows, grid x, y and z (the dk/dv kernel's query parts; 1 for dq),
// dynamic shared memory bytes, then q's dims (D, H, Lq, B) and byte strides
// (dO's are q's), then k's (v's are k's). The maps' boxes are (CW, 1, 64, 1).
template <typename T, int SW>
int bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v, const void* dout,
             const long long* geom, int grid_x) {
  if (geom[0] != SW || geom[1] != T::CW || geom[2] != T::ROWS || geom[3] != grid_x ||
      geom[4] <= 0 || geom[4] > 65535 || geom[6] != T::SMEM)
    return (int)cudaErrorInvalidValue;
  int rc = encode(&m[0], q, geom + 7, geom + 11, T::CW, T::ROWS, SW);
  if (rc == 0) rc = encode(&m[1], dout, geom + 7, geom + 11, T::CW, T::ROWS, SW);
  if (rc == 0) rc = encode(&m[2], k, geom + 14, geom + 18, T::CW, T::ROWS, SW);
  if (rc == 0) rc = encode(&m[3], v, geom + 14, geom + 18, T::CW, T::ROWS, SW);
  return rc;
}

template <int D, int SW>
int launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* di, void* dk, void* dv, float* ws, int H,
                     int Lq, int Lk, const long long* geom, float scale, cudaStream_t s) {
  using T = DkvTile<D, SW>;
  const long long parts = geom[5];
  if (parts < 1 || parts > Lq / T::ROWS || (parts > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  int rc = bwd_maps<T, SW>(m, q, k, v, dout, geom, (Lk + T::BLOCK - 1) / T::BLOCK);
  if (rc != 0) return rc;
  const auto kernel = flash_bwd_dkv_wgmma<D, SW>;
  static std::atomic<unsigned long long> smem_set{0};
  rc = set_smem_once(kernel, T::SMEM, smem_set);
  if (rc != 0) return rc;
  kernel<<<dim3((unsigned)geom[3], (unsigned)geom[4], (unsigned)parts), BWD_THREADS, T::SMEM,
           s>>>(m[0], m[1], m[2], m[3], lse, di, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                parts > 1 ? ws : nullptr, H, Lq, Lk, scale, scale * LOG2E);
  rc = (int)cudaGetLastError();
  if (rc != 0 || parts == 1) return rc;
  const long long n = geom[4] * Lk * D;  // B*H*Lk*D elements of dk (and of dv)
  const long long blocks = (2 * (n / 4) + 255) / 256;
  flash_bwd_dkv_sum<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      ws, (int)parts, n, static_cast<bf16*>(dk), static_cast<bf16*>(dv));
  return (int)cudaGetLastError();
}

template <int D, int SW>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* di, void* dq, int H, int Lq, int Lk,
                    const long long* geom, float scale, cudaStream_t s) {
  using T = DqTile<D, SW>;
  if (geom[5] != 1) return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  int rc = bwd_maps<T, SW>(m, q, k, v, dout, geom, (Lq + T::BLOCK - 1) / T::BLOCK);
  if (rc != 0) return rc;
  const auto kernel = flash_bwd_dq_wgmma<D, SW>;
  static std::atomic<unsigned long long> smem_set{0};
  rc = set_smem_once(kernel, T::SMEM, smem_set);
  if (rc != 0) return rc;
  kernel<<<dim3((unsigned)geom[3], (unsigned)geom[4]), BWD_THREADS, T::SMEM, s>>>(
      m[0], m[1], m[2], m[3], lse, di, static_cast<bf16*>(dq), H, Lq, Lk, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

// the (D, swizzle bytes) instantiations of the wgmma backward: the forward's
// layout (128-byte swizzle) at D=40 and 80. The wrapper's table is
// ops/flash_tma.py::BWD_SWIZZLE; `vx_flash_bwd_tile` lets it check the two agree.
#define VX_BWD_WGMMA(X) X(40, 128) X(80, 128)

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (D=160 only). `strides` holds 14 element
// strides: (batch, row) of q, k, v, do, dq, dk, dv in that order. lse, di:
// (B, H, Lq) fp32, contiguous.
int vx_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* di, void* dk, void* dv, int dtype, int B, int H,
                     int Lq, int Lk, int D, const long long* strides, float scale,
                     void* stream) {
  if (bad_args(dtype, B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  const BwdStrides st = strides_from(strides);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: launch_dkv<40>(dtype, q, k, v, dout, l, d, dk, dv, B, H, Lq, Lk, st, scale, s); break;
    case 80: launch_dkv<80>(dtype, q, k, v, dout, l, d, dk, dv, B, H, Lq, Lk, st, scale, s); break;
    case 160:
      launch_dkv<160>(dtype, q, k, v, dout, l, d, dk, dv, B, H, Lq, Lk, st, scale, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int vx_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* di, void* dq, int dtype, int B, int H, int Lq,
                    int Lk, int D, const long long* strides, float scale, void* stream) {
  if (bad_args(dtype, B, H, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  const BwdStrides st = strides_from(strides);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: launch_dq<40>(dtype, q, k, v, dout, l, d, dq, B, H, Lq, Lk, st, scale, s); break;
    case 80: launch_dq<80>(dtype, q, k, v, dout, l, d, dq, B, H, Lq, Lk, st, scale, s); break;
    case 160: launch_dq<160>(dtype, q, k, v, dout, l, d, dq, B, H, Lq, Lk, st, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// bf16 at D=40 or 80, contiguous q, k, v, do, dk, dv; lse, di as above. `ws`:
// null, or with geom's z > 1 parts an fp32 workspace of 2 * parts * B*Lk*H*D
// elements, 16-byte aligned.
int vx_flash_bwd_dkv_tma(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* di, void* dk, void* dv, void* ws, int B,
                         int H, int Lq, int Lk, int D, const long long* geom, float scale,
                         void* stream) {
  if (!vx::flash_shape_ok(B, H, Lq, Lk)) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VX_CASE(D_, SW_)                                                                     \
  if (D == D_)                                                                               \
    return launch_dkv_wgmma<D_, SW_>(q, k, v, dout, l, d, dk, dv, static_cast<float*>(ws), H, \
                                     Lq, Lk, geom, scale, s);
  VX_BWD_WGMMA(VX_CASE)
#undef VX_CASE
  return (int)cudaErrorInvalidValue;
}

// bf16 at D=40 or 80, contiguous q, k, v, do, dq; lse, di as above.
int vx_flash_bwd_dq_tma(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* di, void* dq, int B, int H, int Lq, int Lk,
                        int D, const long long* geom, float scale, void* stream) {
  if (!vx::flash_shape_ok(B, H, Lq, Lk)) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VX_CASE(D_, SW_) \
  if (D == D_) return launch_dq_wgmma<D_, SW_>(q, k, v, dout, l, d, dq, H, Lq, Lk, geom, scale, s);
  VX_BWD_WGMMA(VX_CASE)
#undef VX_CASE
  return (int)cudaErrorInvalidValue;
}

// The tiling of the wgmma backward at head dim D, in the order of
// ops/flash_tma.py::BWD_TILE_FIELDS: swizzle bytes, box columns, box rows
// (= a ring tile's and a consumer warpgroup's rows), rows of a block, ring
// stages of dk/dv and of dq, their dynamic shared memory bytes, threads.
// Returns cudaErrorInvalidValue for a D with no instantiation.
int vx_flash_bwd_tile(int D, long long* out) {
#define VX_TILE(D_, SW_)                                                                  \
  if (D == D_) {                                                                          \
    using K = DkvTile<D_, SW_>;                                                           \
    using Q = DqTile<D_, SW_>;                                                            \
    const long long t[9] = {SW_,       K::CW,     K::ROWS,   K::BLOCK,   K::STAGES,       \
                            Q::STAGES, K::SMEM,   Q::SMEM,   BWD_THREADS};                \
    for (int i = 0; i < 9; ++i) out[i] = t[i];                                            \
    return 0;                                                                             \
  }
  VX_BWD_WGMMA(VX_TILE)
#undef VX_TILE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
