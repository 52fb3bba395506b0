// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: vexpress_tpu/ops/flash.py::flash_sdpa, which calls the JAX
// library's Pallas TPU flash_attention forward. Same function: non-causal
// softmax(q k^T * scale) v per (batch, head), online softmax with fp32 running
// max, sum and accumulator, no Lq x Lk logits in device memory, output in the
// input dtype. Under a gradient the same launch also writes each query row's
// log-sum-exp (fp32), which the backward kernels (flash_bwd.cu) read in place
// of the TPU kernel's separate l and m statistics.
//
// Bound on an H100 SXM: 4*B*H*Lq*Lk*D operations over 2*(2*Lq + 2*Lk)*B*H*D
// bytes (bf16, each tensor read or written once) is about Lk operations per
// byte when Lq = Lk: 1024 at a 32x32 latent, 4096 at 64x64, far above the
// card's ~295 op/byte ridge. So the kernel is bound by tensor-core operations,
// 4*B*H*Lq*Lk*D / 989e12 s (attn1 at a 64x64 latent, B=48, H=8, D=40:
// 1.04 ms). The exp per logit (B*H*Lq*Lk of them, 6.4e9 there) runs on the
// SFUs at 16/clk/SM, about 1.7 ms at 1.8 GHz: at D=40 the exps, not the
// matrix products, set the real floor, and at D=80 the two are about equal.
//
// Design against that bound (a first, simple version):
// * bf16: one block of 4 warps per (batch*head, 64 query rows). Each warp owns
//   16 rows; Q fragments stay in registers for the whole key loop. K/V tiles of
//   64 keys are staged in shared memory with 16-byte loads; S = Q K^T and
//   O += P V run on the tensor cores through mma.sync m16n8k16 (bf16 in, fp32
//   accumulate). P goes from the S accumulators straight into A fragments, so
//   the probabilities never touch shared memory. The head dim is zero-padded
//   to a multiple of 16 in shared memory and in the Q fragments (40 -> 48);
//   padded output columns are never stored.
// * fp32: the same tiling with scalar FMAs (4 threads per query row, each
//   owning D/4 columns), exact fp32 arithmetic; used by the parity checks.
// Not done yet (later work): cp.async/TMA double buffering, wgmma, ldmatrix.
//
// K2, the LITE variant (template flag LITE, entry point vx_flash_lite_fwd).
// Replaces: vexpress_tpu/ops/flash_lite.py::flash_lite_fwd (Pallas body
// _fwd_kernel), which the JAX package runs in place of the library kernel
// under VEXPRESS_FLASH_LITE=1. Its softmax differs from K1's on purpose:
// q is multiplied by the scale cast to q's dtype and rounded to that dtype
// when its tile is loaded (no fp32 scale*log2e fold); the running max is in
// natural-log units; each probability is p = exp(bf16(s - m)) rounded to
// bf16, and the running sum adds those bf16 values in fp32; P V takes the
// bf16 p directly as its A fragments; the correction exp(m_old - m_new), the
// sum and the accumulator stay fp32. Bound: the same operations as K1 and
// one exp per logit. This first version takes each exp as __expf and rounds
// it, so it spends as many SFU operations as K1; the packed bf16x2 ex2 that
// would halve them is later work. Its key tile (64, 32 in fp32) is not the
// TPU kernel's 512, so the running max, and with it what is rounded, differs
// from the plain version's: they agree to bf16 rounding, not bitwise.
//
// Layout: q (B, Lq, H*D), k/v (B, Lk, H*D), o like q, read through the batch
// and row strides given (elements); the last dim is contiguous. Lq and Lk must
// be multiples of 64 and D one of 40, 80, 160 (the wrapper checks).
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the function returns cudaGetLastError().

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace vx;

constexpr int BQ = 64;  // query rows per block

struct Strides {
  long long q_b, q_l, k_b, k_l, v_b, v_l, o_b, o_l;
};

// ---------------------------------------------------------------- bf16, mma
// exp of x rounded to bf16, the result rounded to bf16 (K2's probability)
__device__ __forceinline__ float exp_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(__expf(__bfloat162float(__float2bfloat16_rn(x)))));
}

// bf16 pair times s, rounded to bf16 (K2's q pre-scale)
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * s, f.y * s);
}

// `scale`: K1 passes scale*log2(e), applied to the logits; K2 (LITE) passes
// the scale rounded to q's dtype, applied to q as its tile is loaded.
template <int D, bool LITE>
__global__ void __launch_bounds__(128)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
              float* __restrict__ lse, int H, int Lk, Strides st, float scale) {
  constexpr int BK = 64;                 // keys per shared-memory tile
  constexpr int DP = (D + 15) / 16 * 16;  // head dim padded to the mma depth
  constexpr int KD = DP / 16;            // k-steps of S = Q K^T
  constexpr int NT = DP / 8;             // n-tiles of O
  constexpr int SS = DP + 8;             // smem row stride: conflict-free fragment reads
  constexpr int VPR = D / 8;             // 16-byte vectors per staged row
  __shared__ __align__(16) __nv_bfloat16 ks[BK * SS];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * SS];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* qb = q + b * st.q_b + h * D;
  const __nv_bfloat16* kb = k + b * st.k_b + h * D;
  const __nv_bfloat16* vb = v + b * st.v_b + h * D;
  __nv_bfloat16* ob = o + b * st.o_b + h * D;

  // zero the padded columns once; staging never writes them
  for (int i = tid; i < BK * (SS - D); i += blockDim.x) {
    const int r = i / (SS - D), c = D + i % (SS - D);
    ks[r * SS + c] = __float2bfloat16(0.f);
    vs[r * SS + c] = __float2bfloat16(0.f);
  }

  // Q fragments of this warp's 16 rows (A operand, row-major), kept in registers
  const long long r0 = (long long)blockIdx.x * BQ + warp * 16 + g;
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
    if constexpr (LITE) {
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[kd][i] = scale_bf16x2(qf[kd][i], scale);
    }
  }

  // running max of rows g and g+8: log2 units (K1), natural-log units (K2)
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sums
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const uint16_t* vsu = reinterpret_cast<const uint16_t*>(vs);

  for (int kt = 0; kt < Lk; kt += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * VPR; i += blockDim.x) {
      const int r = i / VPR, c = (i % VPR) * 8;
      *reinterpret_cast<uint4*>(ks + r * SS + c) =
          *reinterpret_cast<const uint4*>(kb + (long long)(kt + r) * st.k_l + c);
      *reinterpret_cast<uint4*>(vs + r * SS + c) =
          *reinterpret_cast<const uint4*>(vb + (long long)(kt + r) * st.v_l + c);
    }
    __syncthreads();

    // S (16 x 64) = Q K^T; n-tile j covers keys 8j..8j+7
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

    // online softmax: rows g (c0, c1) and g+8 (c2, c3); a row's 64 values
    // are spread over the 4 lanes of a quad
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      if constexpr (!LITE) {
        s[j][0] *= scale;
        s[j][1] *= scale;
        s[j][2] *= scale;
        s[j][3] *= scale;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // 0 on the first tile
    const float a0 = LITE ? __expf(m0 - mx0) : exp2f(m0 - mx0);
    const float a1 = LITE ? __expf(m1 - mx1) : exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      if constexpr (LITE) {  // bf16 values, so the packing below is exact
        s[j][0] = exp_bf16(s[j][0] - m0);
        s[j][1] = exp_bf16(s[j][1] - m0);
        s[j][2] = exp_bf16(s[j][2] - m1);
        s[j][3] = exp_bf16(s[j][3] - m1);
      } else {
        s[j][0] = exp2f(s[j][0] - m0);
        s[j][1] = exp2f(s[j][1] - m0);
        s[j][2] = exp2f(s[j][2] - m1);
        s[j][3] = exp2f(s[j][3] - m1);
      }
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

    // O += P V; the S accumulators of n-tiles 2kk and 2kk+1 are the A fragment
    // of keys 16kk..16kk+15
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const uint16_t* vr = vsu + (kk * 16 + 2 * t) * SS + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint16_t* vp = vr + n * 8;
        const uint32_t b0 = (uint32_t)vp[0] | ((uint32_t)vp[SS] << 16);
        const uint32_t b1 = (uint32_t)vp[8 * SS] | ((uint32_t)vp[9 * SS] << 16);
        mma_bf16_16816(acc[n], pa, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if constexpr (!LITE) {
    if (lse != nullptr && t == 0) {  // natural-log LSE of the scaled logits
      float* lp = lse + (long long)bh * gridDim.x * BQ;
      lp[r0] = (m0 + log2f(l0)) * LN2;
      lp[r0 + 8] = (m1 + log2f(l1)) * LN2;
    }
  }
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

// ------------------------------------------------------------- scalar (SIMT)
// `scale` as in flash_fwd_mma
template <typename T, int D, bool LITE>
__global__ void __launch_bounds__(256)
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, float* __restrict__ lse, int H, int Lk, Strides st,
               float scale) {
  constexpr int TK = 32;     // keys per shared-memory tile
  constexpr int DQ = D / 4;  // columns owned by each of a row's 4 threads
  __shared__ float ks[TK][D];
  __shared__ float vs[TK][D];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, row = tid >> 2, part = tid & 3;
  const long long qi = (long long)blockIdx.x * BQ + row;

  const T* qp = q + b * st.q_b + qi * st.q_l + h * D + part * DQ;
  const T* kb = k + b * st.k_b + h * D;
  const T* vb = v + b * st.v_b + h * D;

  float qr[DQ], acc[DQ];
#pragma unroll
  for (int d = 0; d < DQ; ++d) {
    qr[d] = LITE ? to_f32(from_f32<T>(to_f32(qp[d]) * scale)) : to_f32(qp[d]) * scale;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int kt = 0; kt < Lk; kt += TK) {
    __syncthreads();
    for (int i = tid; i < TK * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      ks[r][c] = to_f32(kb[(long long)(kt + r) * st.k_l + c]);
      vs[r][c] = to_f32(vb[(long long)(kt + r) * st.v_l + c]);
    }
    __syncthreads();

    float s[TK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < DQ; ++d) a = fmaf(qr[d], ks[j][part * DQ + d], a);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      s[j] = a;
      mx = fmaxf(mx, a);
    }
    const float alpha = LITE ? __expf(m - mx) : exp2f(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DQ; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      const float p = LITE ? exp_bf16(s[j] - m) : exp2f(s[j] - m);
      l += p;
#pragma unroll
      for (int d = 0; d < DQ; ++d) acc[d] = fmaf(p, vs[j][part * DQ + d], acc[d]);
    }
  }

  if (!LITE && lse != nullptr && part == 0)
    lse[(long long)bh * gridDim.x * BQ + qi] = (m + log2f(l)) * LN2;
  T* op = o + b * st.o_b + qi * st.o_l + h * D + part * DQ;
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < DQ; ++d) op[d] = from_f32<T>(acc[d] * inv);
}

template <int D, bool LITE>
void launch(int dtype, const void* q, const void* k, const void* v, void* o, float* lse, int B,
            int H, int Lq, int Lk, const Strides& st, float scale, cudaStream_t s) {
  const dim3 grid(Lq / BQ, B * H);
  if (dtype == 1) {
    flash_fwd_mma<D, LITE><<<grid, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, H, Lk, st,
        scale);
  } else {
    flash_fwd_simt<float, D, LITE><<<grid, 256, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse, H, Lk, st, scale);
  }
}

template <bool LITE>
int forward(const void* q, const void* k, const void* v, void* o, float* lse, int dtype, int B,
            int H, int Lq, int Lk, int D, const Strides& st, float scale, cudaStream_t s) {
  if ((dtype != 0 && dtype != 1) || Lq % BQ != 0 || Lk % 64 != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 40: launch<40, LITE>(dtype, q, k, v, o, lse, B, H, Lq, Lk, st, scale, s); break;
    case 80: launch<80, LITE>(dtype, q, k, v, o, lse, B, H, Lq, Lk, st, scale, s); break;
    case 160: launch<160, LITE>(dtype, q, k, v, o, lse, B, H, Lq, Lk, st, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. `lse` is null or
// a contiguous (B, H, Lq) float32 buffer that receives each row's natural-log
// log-sum-exp of the scaled logits (what the backward kernels read).
int vx_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
                 int B, int H, int Lq, int Lk, int D, long long q_sb, long long q_sl,
                 long long k_sb, long long k_sl, long long v_sb, long long v_sl, long long o_sb,
                 long long o_sl, float scale, void* stream) {
  const Strides st{q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb, o_sl};
  return forward<false>(q, k, v, o, static_cast<float*>(lse), dtype, B, H, Lq, Lk, D, st,
                        scale * LOG2E, static_cast<cudaStream_t>(stream));
}

// K2: the same layout and arguments without `lse`; `scale` is the softmax
// scale already rounded to q's dtype (bf16(scale) for bf16 inputs).
int vx_flash_lite_fwd(const void* q, const void* k, const void* v, void* o, int dtype, int B,
                      int H, int Lq, int Lk, int D, long long q_sb, long long q_sl,
                      long long k_sb, long long k_sl, long long v_sb, long long v_sl,
                      long long o_sb, long long o_sl, float scale, void* stream) {
  const Strides st{q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb, o_sl};
  return forward<true>(q, k, v, o, nullptr, dtype, B, H, Lq, Lk, D, st, scale,
                       static_cast<cudaStream_t>(stream));
}

const char* vx_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
