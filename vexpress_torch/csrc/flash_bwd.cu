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
// * bf16 (every head dim, D=40, 80 and 160): flash_bwd_dkv_wgmma and
//   flash_bwd_dq_wgmma (flash_bwd_wgmma.cuh): TMA loads of the 4-D (D, H, L,
//   B) tensor maps into an mbarrier ring, a producer warpgroup and two wgmma
//   consumer warpgroups per 128 keys (dk/dv) or 128 queries (dq). Ring tiles
//   of 64 rows in 3 stages for dk/dv and 4 for dq at D=40 and 80; at D=160
//   (the forward's 64-byte swizzle, five 32-column chunks) dk/dv walks
//   32-query tiles in 4 stages, so that a consumer's dK and dV (160 fp32
//   registers) leave room for S^T and dP^T, and dq 64-key tiles in 3. The
//   host geometry (maps, grid, shared memory, query parts) comes from
//   ops/flash_tma.py (`bwd_geometry`), the maps are encoded here (hopper.cuh's
//   `encode`). Where B*H*ceil(Lk/128) blocks would not fill the card
//   (attn1_5 and the reference net's B=1 rows), the dk/dv kernel splits the
//   query axis into parts (ops/flash_tma.py::dkv_splits); each part writes
//   fp32 partial sums into a workspace the wrapper allocates, and
//   flash_bwd_dkv_sum adds them in part order and writes bf16.
// * fp32 (the parity phases and the CLI's --dtype fp32): the same two loops
//   with scalar FMAs (4 threads per row, each owning D/4 columns).
// Not done yet: one kernel for the pair (dq summed across key blocks with
// fp32 atomics, no longer deterministic).
//
// Layout: q, o, do, dq (B, Lq, H*D); k, v, dk, dv (B, Lk, H*D). The wgmma
// kernels take them contiguous; the scalar ones read and write through the
// batch and row strides given (elements; the last dim contiguous). lse and di
// are contiguous (B, H, Lq) fp32. Lq and Lk multiples of 64, D one of 40, 80,
// 160 (the wrapper checks). Launches go on the caller's stream, allocate
// nothing and do not synchronise; each function returns cudaGetLastError(),
// or a failed encode's code (vx_error_string names it).

#include <math.h>

#include "flash_bwd_wgmma.cuh"
#include "flash_common.cuh"

namespace {

using namespace vx;
using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;  // keys (dk/dv) or queries (dq) per block of the scalar kernels

struct BwdStrides {
  long long q_b, q_l, k_b, k_l, v_b, v_l, do_b, do_l, dq_b, dq_l, dk_b, dk_l, dv_b, dv_l;
};

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

// fp32, at any D the wrapper takes
template <int D>
void launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* di, void* dk, void* dv, int B, int H, int Lq, int Lk,
                const BwdStrides& st, float scale, cudaStream_t s) {
  flash_bwd_dkv_simt<D><<<dim3(Lk / ROWS, B * H), 256, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, di, static_cast<float*>(dk), static_cast<float*>(dv),
      H, Lq, st, scale, scale * LOG2E);
}

template <int D>
void launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* di, void* dq, int B, int H, int Lq, int Lk, const BwdStrides& st,
               float scale, cudaStream_t s) {
  flash_bwd_dq_simt<D><<<dim3(Lq / ROWS, B * H), 256, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, di, static_cast<float*>(dq), H, Lq, Lk, st, scale,
      scale * LOG2E);
}

BwdStrides strides_from(const long long* s) {
  return BwdStrides{s[0], s[1], s[2],  s[3],  s[4],  s[5],  s[6],
                    s[7], s[8], s[9], s[10], s[11], s[12], s[13]};
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
// (dO's are q's), then k's (v's are k's). The maps' boxes are (CW, 1, T::ROWS, 1).
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
// layout, 128-byte swizzle at D=40 and 80, 64-byte at D=160. The wrapper's
// table is ops/flash_tma.py::BWD_SWIZZLE; `vx_flash_bwd_tile` lets it check
// the two agree.
#define VX_BWD_WGMMA(X) X(40, 128) X(80, 128) X(160, 64)

}  // namespace

extern "C" {

// fp32. `strides` holds 14 element strides: (batch, row) of q, k, v, do, dq,
// dk, dv in that order. lse, di: (B, H, Lq) fp32, contiguous.
int vx_flash_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* di, void* dk, void* dv, int B, int H,
                         int Lq, int Lk, int D, const long long* strides, float scale,
                         void* stream) {
  if (!vx::flash_shape_ok(B, H, Lq, Lk)) return (int)cudaErrorInvalidValue;
  const BwdStrides st = strides_from(strides);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: launch_dkv<40>(q, k, v, dout, l, d, dk, dv, B, H, Lq, Lk, st, scale, s); break;
    case 80: launch_dkv<80>(q, k, v, dout, l, d, dk, dv, B, H, Lq, Lk, st, scale, s); break;
    case 160: launch_dkv<160>(q, k, v, dout, l, d, dk, dv, B, H, Lq, Lk, st, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int vx_flash_bwd_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* di, void* dq, int B, int H, int Lq, int Lk,
                        int D, const long long* strides, float scale, void* stream) {
  if (!vx::flash_shape_ok(B, H, Lq, Lk)) return (int)cudaErrorInvalidValue;
  const BwdStrides st = strides_from(strides);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: launch_dq<40>(q, k, v, dout, l, d, dq, B, H, Lq, Lk, st, scale, s); break;
    case 80: launch_dq<80>(q, k, v, dout, l, d, dq, B, H, Lq, Lk, st, scale, s); break;
    case 160: launch_dq<160>(q, k, v, dout, l, d, dq, B, H, Lq, Lk, st, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// bf16 at D=40, 80 or 160, contiguous q, k, v, do, dk, dv; lse, di as above. `ws`:
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

// bf16 at D=40, 80 or 160, contiguous q, k, v, do, dq; lse, di as above.
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
// ops/flash_tma.py::BWD_TILE_FIELDS: swizzle bytes, box columns, ring-tile
// (and box) rows of dk/dv and of dq, rows of a block, ring stages of dk/dv
// and of dq, their dynamic shared memory bytes, threads. Returns
// cudaErrorInvalidValue for a D with no instantiation.
int vx_flash_bwd_tile(int D, long long* out) {
#define VX_TILE(D_, SW_)                                                                  \
  if (D == D_) {                                                                          \
    using K = DkvTile<D_, SW_>;                                                           \
    using Q = DqTile<D_, SW_>;                                                            \
    const long long t[10] = {SW_,       K::CW,   K::ROWS, Q::ROWS, K::BLOCK,              \
                             K::STAGES, Q::STAGES, K::SMEM, Q::SMEM, BWD_THREADS};        \
    for (int i = 0; i < 10; ++i) out[i] = t[i];                                           \
    return 0;                                                                             \
  }
  VX_BWD_WGMMA(VX_TILE)
#undef VX_TILE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
