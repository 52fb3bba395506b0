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
// Design against that bound:
// * bf16: flash_fwd_wgmma (flash_fwd_wgmma.cuh, the template that T1 and T2
//   share at other tilings), one block of a TMA producer
//   warpgroup and two wgmma consumer warpgroups per (128 query rows, batch,
//   head), K/V tiles of 64 keys (128 at D=80) in a 3-stage mbarrier ring,
//   two blocks an SM at D=40; in each warpgroup the softmax of one key tile
//   runs while P V of the tile before does. The tensor maps
//   are encoded here from the geometry that ops/flash_tma.py computes (dims,
//   byte strides, box, swizzle, grid, shared memory), through the driver's
//   cuTensorMapEncodeTiled (hopper.cuh's `encode`, shared with the backward;
//   found with cudaGetDriverEntryPoint, so the library needs no -lcuda), and
//   passed as __grid_constant__ parameters.
//   K1's exps are ex2.approx.ftz.f32 with scale*log2(e) folded into one FMA.
// * fp32: flash_fwd_simt, scalar FMAs (4 threads per query row, each owning
//   D/4 columns), 64 query rows and 32-key tiles a block, exact fp32
//   arithmetic; used by the parity checks.
// Later work: the row sums on the tensor cores, part of the exps on the FMA
// units (at D=40 the SFUs bound the kernel), ordering the two warpgroups'
// softmax and products against each other.
//
// K2, the LITE variant (template flag LITE, `lite` argument).
// Replaces: vexpress_tpu/ops/flash_lite.py::flash_lite_fwd (Pallas body
// _fwd_kernel), which the JAX package runs in place of the library kernel
// under VEXPRESS_FLASH_LITE=1. Its softmax differs from K1's on purpose:
// q is multiplied by the scale cast to q's dtype and rounded to that dtype
// (bf16: in shared memory, before the first product; no fp32 scale*log2e
// fold); the running max is in natural-log units; the correction exp(m_old -
// m_new), the sum and the accumulator stay fp32; the sum adds the bf16
// probabilities in fp32 and P V takes them as they are. Each probability is
// bf16(exp(bf16(s - m))) in the plain version (ops/flash_lite.py) and the TPU
// kernel; the bf16 kernel takes it as ex2.approx.ftz.bf16x2 of
// bf16(bf16(s - m) * log2(e)) on packed pairs (the product by two bf16x2
// FMAs with log2(e) split in two bf16), one SFU operation for two exps, which
// moves p by about a bf16 ulp (flash_lite.lite_packed_exp emulates it); the fp32 kernel as __expf of bf16(s - m), rounded. Its key
// tile (128 in bf16, 32 in fp32) is not the TPU kernel's 512, so the running
// max, and with it what is rounded, differs from the plain version's: they
// agree to bf16 rounding, not bitwise.
//
// Layout: q (B, Lq, H*D), k/v (B, Lk, H*D), o like q; bf16 tensors
// contiguous, fp32 read through the batch and row strides given (elements;
// the last dim contiguous). Lq and Lk must be multiples of 64 and D one of
// 40, 80, 160 (the wrapper checks). A launch goes on the caller's stream,
// allocates nothing and does not synchronise; each function returns
// cudaGetLastError(), or a failed encode's code (vx_error_string names it).

#include <stdio.h>

#include "flash_fwd_wgmma.cuh"

namespace {

using namespace vx;

constexpr int BQ = 64;  // query rows per block of the scalar kernel

// ------------------------------------------------------------- scalar (SIMT)
// `scale` as in flash_fwd_wgmma; the packed layout only (head stride D)
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

// ------------------------------------------------------------- bf16 (TMA)
// `geom` (ops/flash_tma.py::geometry_arg): swizzle bytes, box columns, box
// rows of q and of k/v, grid x and y, dynamic shared memory bytes, then q's
// dims (D, H, Lq, B) and byte strides, then k's (v's are k's).
template <int D, bool LITE, int SW>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int H, int Lq,
                 int Lk, const long long* geom, float scale, cudaStream_t s) {
  using T = K1Tile<D, SW>;
  static std::atomic<unsigned long long> smem_set{0};
  const FwdArgs a{H, Lq, Lk, 0, scale, (long long)Lq * H * D, D, (long long)H * D};
  constexpr PMode P = LITE ? PMode::LITE : PMode::ROUND;
  return launch_fwd<T>(flash_fwd_wgmma<T, P>, smem_set, q, k, v, o, lse, geom, a, s);
}

// the (D, swizzle bytes) instantiations, K1's and K2's: 128-byte swizzle at
// D=40 and D=80 (faster than 32-byte, PERF.md), 64-byte at D=160. The
// wrapper's table is ops/flash_tma.py::SWIZZLE; `vx_flash_fwd_tile` lets it
// check that the two agree.
#define VX_WGMMA(X) X(40, 128) X(80, 128) X(160, 64)

template <bool LITE>
int forward_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int H, int Lq,
                 int Lk, int D, const long long* geom, float scale, cudaStream_t s) {
#define VX_CASE(D_, SW_) \
  if (D == D_) return launch_wgmma<D_, LITE, SW_>(q, k, v, o, lse, H, Lq, Lk, geom, scale, s);
  VX_WGMMA(VX_CASE)
#undef VX_CASE
  return (int)cudaErrorInvalidValue;
}

template <int D, bool LITE>
void launch_simt(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                 int Lq, int Lk, const Strides& st, float scale, cudaStream_t s) {
  flash_fwd_simt<float, D, LITE><<<dim3(Lq / BQ, B * H), 256, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, Lk, st, scale);
}

}  // namespace

extern "C" {

// bf16, contiguous q, k, v, o. `lse` is null or a contiguous (B, H, Lq)
// float32 buffer that receives each row's natural-log log-sum-exp of the
// scaled logits (what the backward kernels read); K2 (`lite`) takes none.
// `scale`: K1 the softmax scale, K2 the scale already rounded to bf16.
int vx_flash_fwd_tma(const void* q, const void* k, const void* v, void* o, void* lse, int lite,
                     int B, int H, int Lq, int Lk, int D, const long long* geom, float scale,
                     void* stream) {
  if (!vx::flash_shape_ok(B, H, Lq, Lk) || (lite && lse != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lite ? forward_bf16<true>(q, k, v, o, nullptr, H, Lq, Lk, D, geom, scale, s)
              : forward_bf16<false>(q, k, v, o, static_cast<float*>(lse), H, Lq, Lk, D, geom,
                                    scale * LOG2E, s);
}

// fp32, read through the strides given (elements); `lse`, `lite` and
// `scale` as above (K2's scale rounded to fp32 is the scale).
int vx_flash_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int lite,
                     int B, int H, int Lq, int Lk, int D, long long q_sb, long long q_sl,
                     long long k_sb, long long k_sl, long long v_sb, long long v_sl,
                     long long o_sb, long long o_sl, float scale, void* stream) {
  if (!vx::flash_shape_ok(B, H, Lq, Lk) || (lite && lse != nullptr))
    return (int)cudaErrorInvalidValue;
  const Strides st{q_sb, D, q_sl, k_sb, D, k_sl, v_sb, D, v_sl, o_sb, D, o_sl};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VX_SIMT(D_)                                                                      \
  if (D == D_) {                                                                         \
    if (lite)                                                                            \
      launch_simt<D_, true>(q, k, v, o, nullptr, B, H, Lq, Lk, st, scale, s);            \
    else                                                                                 \
      launch_simt<D_, false>(q, k, v, o, l, B, H, Lq, Lk, st, scale * LOG2E, s);         \
    return (int)cudaGetLastError();                                                      \
  }
  VX_SIMT(40)
  VX_SIMT(80)
  VX_SIMT(160)
#undef VX_SIMT
  return (int)cudaErrorInvalidValue;
}

// The tiling of the bf16 kernel at head dim D, in the order of
// ops/flash_tma.py::TILE_FIELDS: swizzle bytes, box columns, query rows and
// keys per tile, blocks per SM, dynamic shared memory bytes, threads, K/V
// stages. Returns cudaErrorInvalidValue for a D with no instantiation.
int vx_flash_fwd_tile(int D, long long* out) {
#define VX_TILE(D_, SW_)                                                                     \
  if (D == D_) {                                                                             \
    using T = K1Tile<D_, SW_>;                                                               \
    const long long t[8] = {SW_, T::CW, T::BQ, T::BK, T::MINB, T::SMEM, T::THREADS,          \
                            T::STAGES};                                                      \
    for (int i = 0; i < 8; ++i) out[i] = t[i];                                               \
    return 0;                                                                                \
  }
  VX_WGMMA(VX_TILE)
#undef VX_TILE
  return (int)cudaErrorInvalidValue;
}

const char* vx_error_string(int code) {
  static thread_local char buf[96];
  if (code == vx::ERR_NO_ENCODE) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code >= vx::ERR_ENCODE) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)", code - vx::ERR_ENCODE);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
