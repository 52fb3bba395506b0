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
// * bf16: flash_fwd_mma (flash_fwd_mma.cuh) at its default tiling, one block
//   of 4 warps per (batch*head, 64 query rows), K/V tiles of 64 keys, the head
//   dim zero-padded to a multiple of 16 in shared memory and in the Q
//   fragments (40 -> 48); mma.sync m16n8k16 for S = Q K^T and O += P V, P kept
//   in registers.
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

#include "flash_fwd_mma.cuh"

namespace {

using namespace vx;

constexpr int BQ = 64;  // query rows per block (both variants)

// ------------------------------------------------------------- scalar (SIMT)
// `scale` as in flash_fwd_mma; the packed layout only (head stride D)
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
  if (dtype == 1) {
    // K1's tiling: 64 query rows and 64 keys a block, D padded to 16, one (b, h)
    launch_mma<D, LITE, BQ, 64, (D + 15) / 16 * 16, 1, false>(q, k, v, o, lse, B, H, Lq, Lk, st,
                                                             scale, s);
  } else {
    flash_fwd_simt<float, D, LITE><<<dim3(Lq / BQ, B * H), 256, 0, s>>>(
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
  const Strides st{q_sb, D, q_sl, k_sb, D, k_sl, v_sb, D, v_sl, o_sb, D, o_sl};
  return forward<false>(q, k, v, o, static_cast<float*>(lse), dtype, B, H, Lq, Lk, D, st,
                        scale * LOG2E, static_cast<cudaStream_t>(stream));
}

// K2: the same layout and arguments without `lse`; `scale` is the softmax
// scale already rounded to q's dtype (bf16(scale) for bf16 inputs).
int vx_flash_lite_fwd(const void* q, const void* k, const void* v, void* o, int dtype, int B,
                      int H, int Lq, int Lk, int D, long long q_sb, long long q_sl,
                      long long k_sb, long long k_sl, long long v_sb, long long v_sl,
                      long long o_sb, long long o_sl, float scale, void* stream) {
  const Strides st{q_sb, D, q_sl, k_sb, D, k_sl, v_sb, D, v_sl, o_sb, D, o_sl};
  return forward<true>(q, k, v, o, nullptr, dtype, B, H, Lq, Lk, D, st, scale,
                       static_cast<cudaStream_t>(stream));
}

const char* vx_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
