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
// In fp32 the products run as three TF32 products each (3xTF32, K2's P V as
// two) at 495e12 TF32 FLOP/s: 3*4*B*H*Lq*Lk*D / 495e12 s (attn1 at 64x64:
// 6.25 ms), against 15.4 ms at the 67e12 of the fp32 FMA units.
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
// * fp32: flash_fwd_tf32 (flash_fwd_tf32.cuh), the same design on tf32
//   wgmma with each operand split into tf32 hi and lo parts: a split pass
//   (tf32_split, tf32_split_vt in tf32_split.cuh) writes q's, k's and v's parts, v's
//   transposed, into a scratch buffer (6 tensors of q's or k's size), then
//   the kernel reads them by TMA. Tilings (VX_F32): 128 query rows and
//   64-key stages at D=40, 32-key at D=80; 64 rows and 16-key stages at
//   D=160; 3 stages.
// Later work: the row sums on the tensor cores, part of the exps on the FMA
// units (at D=40 the SFUs bound the kernel), ordering the two warpgroups'
// softmax and products against each other.
//
// K2, the LITE variant (template flag LITE, `lite` argument).
// Replaces: vexpress_tpu/ops/flash_lite.py::flash_lite_fwd (Pallas body
// _fwd_kernel), which the JAX package runs in place of the library kernel
// under VEXPRESS_FLASH_LITE=1. Its softmax differs from K1's on purpose:
// q is multiplied by the scale cast to q's dtype and rounded to that dtype
// (bf16: in shared memory, before the first product; fp32: by the split
// pass; no fp32 scale*log2e fold); the running max is in natural-log units; the correction exp(m_old -
// m_new), the sum and the accumulator stay fp32; the sum adds the bf16
// probabilities in fp32 and P V takes them as they are. Each probability is
// bf16(exp(bf16(s - m))) in the plain version (ops/flash_lite.py) and the TPU
// kernel; the bf16 kernel takes it as ex2.approx.ftz.bf16x2 of
// bf16(bf16(s - m) * log2(e)) on packed pairs (the product by two bf16x2
// FMAs with log2(e) split in two bf16), one SFU operation for two exps, which
// moves p by about a bf16 ulp (flash_lite.lite_packed_exp emulates it); the fp32 kernel as __expf of bf16(s - m), rounded. Its key
// tile (128 in bf16; 64, 32, 16 in fp32) is not the TPU kernel's 512, so the running
// max, and with it what is rounded, differs from the plain version's: they
// agree to bf16 rounding, not bitwise.
//
// Layout: q (B, Lq, H*D), k/v (B, Lk, H*D), o like q, all contiguous. Lq
// and Lk must be multiples of 64 and D one of
// 40, 80, 160 (the wrapper checks). A launch goes on the caller's stream,
// allocates nothing and does not synchronise; each function returns
// cudaGetLastError(), or a failed encode's code (vx_error_string names it).

#include <stdio.h>

#include <algorithm>

#include "flash_fwd_tf32.cuh"
#include "flash_fwd_wgmma.cuh"

namespace {

using namespace vx;

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

// ------------------------------------------------------------- fp32 (TMA, tf32)
// (the split pass's kernels: tf32_split.cuh)

// the parts in the scratch buffer, in this order: q hi, q lo, k hi, k lo,
// v^T hi, v^T lo (q's size twice, then k's four times)
struct Tf32Parts {
  float *qh, *ql, *kh, *kl, *vh, *vl;
  Tf32Parts(void* parts, long long nq, long long nk) {
    qh = static_cast<float*>(parts);
    ql = qh + nq;
    kh = ql + nq;
    kl = kh + nk;
    vh = kl + nk;
    vl = vh + nk;
  }
};

// `geom` (ops/flash_tma.py::f32_geometry_arg): swizzle bytes and box columns
// of Q and K, of V^T, query rows and keys a tile, grid x and y, dynamic
// shared memory bytes, then the dims and byte strides of the maps of Q's
// parts (D, H, Lq, B), K's (D, H, Lk, B) and V^T's (Lk, D, H, B)
template <int D, bool LITE, int SW, int BQ, int BK>
int launch_tf32(const Tf32Parts& p, float* o, float* lse, int H, int Lq, int Lk,
                const long long* geom, float scale, cudaStream_t s) {
  using T = K1Tf32Tile<D, SW, BQ, BK>;
  static std::atomic<unsigned long long> smem_set{0};
  if (geom[0] != T::SW || geom[1] != T::CW || geom[2] != T::SWV || geom[3] != T::CWV ||
      geom[4] != T::BQ || geom[5] != T::BK || geom[6] != (Lq + T::BQ - 1) / T::BQ ||
      geom[7] <= 0 || geom[7] > 65535 || geom[8] != T::SMEM)
    return (int)cudaErrorInvalidValue;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap m[6];
  const float* bases[6] = {p.qh, p.ql, p.kh, p.kl, p.vh, p.vl};
  for (int i = 0; i < 6; ++i) {
    const long long* g = geom + 9 + 7 * (i / 2);  // dims, then byte strides
    const int rc = i < 4 ? encode(&m[i], bases[i], g, g + 4, T::CW, i < 2 ? T::BQ : T::BK, T::SW,
                                  2, F32)
                         : encode(&m[i], bases[i], g, g + 4, T::CWV, D, T::SWV, 1, F32);
    if (rc != 0) return rc;
  }
  const int rc = set_smem_once(flash_fwd_tf32<T, LITE>, T::SMEM, smem_set);
  if (rc != 0) return rc;
  const FwdArgs a{H, Lq, Lk, 0, scale, (long long)Lq * H * D, D, (long long)H * D};
  flash_fwd_tf32<T, LITE><<<dim3((unsigned)geom[6], (unsigned)geom[7]), T::THREADS, T::SMEM, s>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], o, lse, a);
  return (int)cudaGetLastError();
}

// the (D, swizzle bytes of Q and K, query rows, keys a tile) instantiations,
// K1's and K2's. The wrapper's table is ops/flash_tma.py::F32_TILES;
// `vx_flash_fwd_f32_tile` lets it check that the two agree.
#define VX_F32(X) X(40, 64, 128, 64) X(80, 64, 128, 32) X(160, 128, 64, 16)

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

// fp32, first of two calls: the split pass. Writes the tf32 parts of q
// (times `qmul`: K2's scale, else 1), k and v into `parts` (Tf32Parts' order;
// 2*B*Lq*H*D + 4*B*Lk*H*D floats, 16-byte aligned). Contiguous q, k, v.
int vx_flash_fwd_f32_split(const void* q, const void* k, const void* v, void* parts, int B, int H,
                           int Lq, int Lk, int D, float qmul, void* stream) {
  if (!vx::flash_shape_ok(B, H, Lq, Lk) || (D != 40 && D != 80 && D != 160))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nq = (long long)B * Lq * H * D, nk = (long long)B * Lk * H * D;
  const Tf32Parts p(parts, nq, nk);
  tf32_split<<<tf32_split_blocks(nq / 4), 256, 0, s>>>(static_cast<const float4*>(q),
                                                        reinterpret_cast<float4*>(p.qh),
                                                        reinterpret_cast<float4*>(p.ql), nq / 4,
                                                        qmul);
  tf32_split<<<tf32_split_blocks(nk / 4), 256, 0, s>>>(static_cast<const float4*>(k),
                                                        reinterpret_cast<float4*>(p.kh),
                                                        reinterpret_cast<float4*>(p.kl), nk / 4,
                                                        1.f);
  launch_split_vt(static_cast<const float*>(v), p.vh, p.vl, B, H, Lk, D, s);
  return (int)cudaGetLastError();
}

// fp32, second call: the kernel on the parts that the split pass wrote.
// `o` contiguous (B, Lq, H*D) fp32; `lse`, `lite` and `scale` as
// vx_flash_fwd_tma's (K2's scale is already in q's parts).
int vx_flash_fwd_f32(const void* parts, void* o, void* lse, int lite, int B, int H, int Lq,
                     int Lk, int D, const long long* geom, float scale, void* stream) {
  if (!vx::flash_shape_ok(B, H, Lq, Lk) || (lite && lse != nullptr))
    return (int)cudaErrorInvalidValue;
  const Tf32Parts p(const_cast<void*>(parts), (long long)B * Lq * H * D,
                    (long long)B * Lk * H * D);
  float* out = static_cast<float*>(o);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VX_CASE(D_, SW_, BQ_, BK_)                                                          \
  if (D == D_)                                                                              \
    return lite ? launch_tf32<D_, true, SW_, BQ_, BK_>(p, out, nullptr, H, Lq, Lk, geom,    \
                                                       scale, s)                            \
                : launch_tf32<D_, false, SW_, BQ_, BK_>(p, out, l, H, Lq, Lk, geom,         \
                                                        scale * LOG2E, s);
  VX_F32(VX_CASE)
#undef VX_CASE
  return (int)cudaErrorInvalidValue;
}

// The tiling of the fp32 kernel at head dim D, in the order of
// ops/flash_tma.py::F32_TILE_FIELDS: swizzle bytes and box columns of Q and
// K, of V^T, query rows and keys per tile, blocks per SM, dynamic shared
// memory bytes, threads, stages. cudaErrorInvalidValue for a D with no
// instantiation.
int vx_flash_fwd_f32_tile(int D, long long* out) {
#define VX_TILE(D_, SW_, BQ_, BK_)                                                            \
  if (D == D_) {                                                                             \
    using T = K1Tf32Tile<D_, SW_, BQ_, BK_>;                                                 \
    const long long t[10] = {T::SW, T::CW, T::SWV, T::CWV, T::BQ, T::BK, T::MINB, T::SMEM,   \
                             T::THREADS, T::STAGES};                                         \
    for (int i = 0; i < 10; ++i) out[i] = t[i];                                              \
    return 0;                                                                                \
  }
  VX_F32(VX_TILE)
#undef VX_TILE
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
