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
// training shape, so operations bound both (in fp32 at 495e12 / 3 FLOP/s,
// each product taken as three TF32 products). Each kernel also recomputes
// P, one exp per (query, key) pair on the SFUs.
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
// * fp32 (the parity phases and the CLIs' --dtype fp32, every head dim):
//   flash_bwd_dkv_tf32 and flash_bwd_dq_tf32 (flash_bwd_tf32.cuh), 3xTF32 on
//   the same ring with a producer warpgroup and one consumer warpgroup per
//   64 keys or 64 queries, after a split pass (vx_flash_bwd_f32_split) that
//   writes the operands' tf32 parts, q, do and k also transposed; dq runs
//   first and hands dk/dv the log-sum-exp of its own logits. Tilings
//   (VX_BWD_F32): 32-row ring tiles at D=40, 16-row at D=80 and 160; at
//   D=160 two CTAs of a cluster on 80 columns each. The geometry comes from
//   ops/flash_tma.py (`f32_bwd_geometry`); the query axis is split as the
//   bf16 dk/dv's (`f32_dkv_splits`), the parts summed by flash_bwd_dkv_sum
//   in fp32.
// Not done yet: one kernel for the pair (dq summed across key blocks with
// fp32 atomics, no longer deterministic).
//
// Layout: q, o, do, dq (B, Lq, H*D); k, v, dk, dv (B, Lk, H*D), all
// contiguous. lse and di are contiguous (B, H, Lq) fp32. Lq and Lk multiples
// of 64, D one of 40, 80, 160 (the wrapper checks). Launches go on the
// caller's stream, allocate nothing and do not synchronise; each function
// returns cudaGetLastError(), or a failed encode's code (vx_error_string
// names it).

#include <math.h>

#include "flash_bwd_tf32.cuh"
#include "flash_bwd_wgmma.cuh"
#include "flash_common.cuh"

namespace {

using namespace vx;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------- bf16 wgmma (TMA)
// four fp32 sums into dst (bf16 or fp32)
__device__ __forceinline__ void store4(bf16* dst, float4 x) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}
__device__ __forceinline__ void store4(float* dst, float4 x) { *reinterpret_cast<float4*>(dst) = x; }

// dk, dv (bf16 or fp32) = the sum of the dk/dv kernel's `parts` fp32
// partial sums (ws: part p's dk at p*n, its dv at (parts+p)*n), added in
// part order, so the result does not depend on the schedule; n a multiple of 4
template <typename O>
__global__ void __launch_bounds__(256)
flash_bwd_dkv_sum(const float* __restrict__ ws, int parts, long long n, O* __restrict__ dk,
                  O* __restrict__ dv) {
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
    store4((is_v ? dv : dk) + 4 * e, acc);
  }
}

// flash_bwd_dkv_sum over n elements of dk and of dv on stream s
template <typename O>
int launch_dkv_sum(const float* ws, int parts, long long n, O* dk, O* dv, cudaStream_t s) {
  const long long blocks = (2 * (n / 4) + 255) / 256;
  flash_bwd_dkv_sum<O><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(ws, parts, n, dk,
                                                                                 dv);
  return (int)cudaGetLastError();
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
  // B*H*Lk*D elements of dk (and of dv)
  return launch_dkv_sum(ws, (int)parts, geom[4] * Lk * D, static_cast<bf16*>(dk),
                        static_cast<bf16*>(dv), s);
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

// ------------------------------------------------------- fp32 (TMA, tf32)
// the fp32 backward's parts in the scratch buffer (ops/flash.py::
// tf32_bwd_parts' order): of q's size q hi, q lo, do hi, do lo, then q^T
// hi, q^T lo, do^T hi, do^T lo (transposed, 8-row groups in perm_key's
// order); of k's size k hi, k lo, v hi, v lo, then k^T hi, k^T lo
enum { QH, QL, DOH, DOL, QTH, QTL, DOTH, DOTL, KH, KL, VH, VL, KTH, KTL, N_PARTS };

struct Tf32BwdParts {
  float* p[N_PARTS];
  Tf32BwdParts(void* parts, long long nq, long long nk) {
    float* x = static_cast<float*>(parts);
    for (int i = 0; i < KH; ++i) p[i] = x + i * nq;
    for (int i = KH; i < N_PARTS; ++i) p[i] = x + KH * nq + (i - KH) * nk;
  }
};

// `geom` (ops/flash_tma.py::f32_bwd_geometry_arg): D, CTAs a cluster, ring
// rows, stages, grid x, y and z (dk/dv's query parts; 1 for dq), dynamic
// shared memory bytes, then the dims and byte strides of the maps of the
// row-major parts of q's size (D, H, Lq, B) and of k's size (D, H, Lk, B),
// and of the transposed parts of q's size (Lq, D, H, B) and of k's (Lk, D,
// H, B). Encodes `maps`: the fixed operands' parts (`fixed`, 64-row boxes),
// the streamed ones' (`ring`, R rows) and the transposed ones' (`tr`, R
// columns by DH rows), dims and strides from geom at the offsets given.
template <class T>
int tf32_bwd_maps(BwdMaps& maps, const float* const (&fixed)[4], const float* const (&ring)[4],
                  const float* const* tr, int n_tr, const long long* g_fixed,
                  const long long* g_ring, const long long* g_tr) {
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int rc = 0;
  for (int i = 0; i < 4 && rc == 0; ++i)
    rc = encode(&maps.m[i], fixed[i], g_fixed, g_fixed + 4, T::CW, T::ROWS, T::SW, 2, F32);
  for (int i = 0; i < 4 && rc == 0; ++i)
    rc = encode(&maps.m[4 + i], ring[i], g_ring, g_ring + 4, T::CW, T::R, T::SW, 2, F32);
  for (int i = 0; i < n_tr && rc == 0; ++i)
    rc = encode(&maps.m[8 + i], tr[i], g_tr, g_tr + 4, T::R, T::DH, T::SWT, 1, F32);
  return rc;
}

// whether geom's header is T's at grid x `grid_x`
template <class T>
bool tf32_geom_ok(const long long* geom, long long grid_x) {
  return geom[0] == T::D && geom[1] == T::CL && geom[2] == T::R && geom[3] == T::STAGES &&
         geom[4] == grid_x && geom[5] > 0 && geom[5] <= 65535 && geom[7] == T::SMEM;
}

// `kernel` on `grid`, in clusters of T::CL CTAs along x
template <class T, typename K>
int launch_tf32_bwd(K kernel, dim3 grid, const BwdMaps& maps, const Tf32BwdArgs& a,
                    std::atomic<unsigned long long>& smem_set, cudaStream_t s) {
  int rc = set_smem_once(kernel, T::SMEM, smem_set);
  if (rc != 0) return rc;
  if constexpr (T::CL == 1) {
    kernel<<<grid, TF32_BWD_THREADS, T::SMEM, s>>>(maps, a);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(TF32_BWD_THREADS);
    cfg.dynamicSmemBytes = T::SMEM;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = T::CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    rc = (int)cudaLaunchKernelEx(&cfg, kernel, maps, a);
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}

template <int D, int CL, int R, int NS>
int launch_dkv_tf32(const Tf32BwdParts& p, const float* lse, const float* di, float* dk,
                    float* dv, float* ws, int H, int Lq, int Lk, const long long* geom,
                    float scale, cudaStream_t s) {
  using T = Tf32BwdTile<D, CL, R, NS, 2>;
  const long long parts = geom[6];
  if (!tf32_geom_ok<T>(geom, (long long)Lk / T::ROWS * CL) || parts < 1 || parts > Lq / R ||
      (parts > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdMaps maps;
  const float* const fixed[4] = {p.p[KH], p.p[KL], p.p[VH], p.p[VL]};
  const float* const ring[4] = {p.p[QH], p.p[QL], p.p[DOH], p.p[DOL]};
  const float* const tr[4] = {p.p[QTH], p.p[QTL], p.p[DOTH], p.p[DOTL]};
  int rc = tf32_bwd_maps<T>(maps, fixed, ring, tr, 4, geom + 15, geom + 8, geom + 22);
  if (rc != 0) return rc;
  static std::atomic<unsigned long long> smem_set{0};
  const Tf32BwdArgs a{lse, di, dk, dv, parts > 1 ? ws : nullptr, H, Lq, Lk, scale,
                      scale * LOG2E};
  rc = launch_tf32_bwd<T>(flash_bwd_dkv_tf32<T>,
                          dim3((unsigned)geom[4], (unsigned)geom[5], (unsigned)parts), maps, a,
                          smem_set, s);
  if (rc != 0 || parts == 1) return rc;
  return launch_dkv_sum(ws, (int)parts, geom[5] * Lk * D, dk, dv, s);
}

template <int D, int CL, int R, int NS>
int launch_dq_tf32(const Tf32BwdParts& p, const float* lse, const float* di, float* dq,
                   float* lse_out, int H, int Lq, int Lk, const long long* geom, float scale,
                   cudaStream_t s) {
  using T = Tf32BwdTile<D, CL, R, NS, 1>;
  if (!tf32_geom_ok<T>(geom, (long long)Lq / T::ROWS * CL) || geom[6] != 1)
    return (int)cudaErrorInvalidValue;
  BwdMaps maps;
  const float* const fixed[4] = {p.p[QH], p.p[QL], p.p[DOH], p.p[DOL]};
  const float* const ring[4] = {p.p[KH], p.p[KL], p.p[VH], p.p[VL]};
  const float* const tr[2] = {p.p[KTH], p.p[KTL]};
  int rc = tf32_bwd_maps<T>(maps, fixed, ring, tr, 2, geom + 8, geom + 15, geom + 29);
  if (rc != 0) return rc;
  static std::atomic<unsigned long long> smem_set{0};
  const Tf32BwdArgs a{lse, di, dq, lse_out, nullptr, H, Lq, Lk, scale, scale * LOG2E};
  return launch_tf32_bwd<T>(flash_bwd_dq_tf32<T>, dim3((unsigned)geom[4], (unsigned)geom[5]),
                            maps, a, smem_set, s);
}

// the fp32 instantiations: (D, CTAs a cluster, dk/dv ring rows and stages,
// dq ring rows and stages). The wrapper's table is ops/flash_tma.py::
// F32_BWD_TILES; `vx_flash_bwd_f32_tile` lets it check the two agree.
#define VX_BWD_F32(X) X(40, 1, 32, 3, 32, 4) X(80, 1, 16, 3, 16, 4) X(160, 2, 16, 3, 16, 4)

}  // namespace

extern "C" {

// fp32, first call: the split pass. Writes the tf32 parts of q, do (B, Lq,
// H*D) and k, v (B, Lk, H*D), all contiguous, into `parts` (Tf32BwdParts'
// order; 8*B*Lq*H*D + 6*B*Lk*H*D floats, 16-byte aligned): the row-major
// parts and k^T's (the dq kernel, which always runs, reads them), q^T's and
// do^T's with `need_dkv`.
int vx_flash_bwd_f32_split(const void* q, const void* k, const void* v, const void* dout,
                           void* parts, int B, int H, int Lq, int Lk, int D, int need_dkv,
                           void* stream) {
  if (!vx::flash_shape_ok(B, H, Lq, Lk) || (D != 40 && D != 80 && D != 160))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nq = (long long)B * Lq * H * D, nk = (long long)B * Lk * H * D;
  const Tf32BwdParts p(parts, nq, nk);
  const void* rows[4] = {q, dout, k, v};
  const int hi[4] = {QH, DOH, KH, VH};
  for (int i = 0; i < 4; ++i) {
    const long long n4 = (i < 2 ? nq : nk) / 4;
    tf32_split<<<tf32_split_blocks(n4), 256, 0, s>>>(static_cast<const float4*>(rows[i]),
                                                     reinterpret_cast<float4*>(p.p[hi[i]]),
                                                     reinterpret_cast<float4*>(p.p[hi[i] + 1]),
                                                     n4, 1.f);
  }
  if (need_dkv) {
    launch_split_vt(static_cast<const float*>(q), p.p[QTH], p.p[QTL], B, H, Lq, D, s);
    launch_split_vt(static_cast<const float*>(dout), p.p[DOTH], p.p[DOTL], B, H, Lq, D, s);
  }
  launch_split_vt(static_cast<const float*>(k), p.p[KTH], p.p[KTL], B, H, Lk, D, s);
  return (int)cudaGetLastError();
}

// fp32, third call: the dk/dv kernel on the parts. dk, dv contiguous (B,
// Lk, H*D) fp32; lse the dq kernel's corrected one, di as above; `ws` null,
// or with geom's z > 1 parts an fp32 workspace of 2 * parts * B*Lk*H*D
// elements, 16-byte aligned.
int vx_flash_bwd_dkv_f32(const void* parts, const void* lse, const void* di, void* dk, void* dv,
                         void* ws, int B, int H, int Lq, int Lk, int D, const long long* geom,
                         float scale, void* stream) {
  if (!vx::flash_shape_ok(B, H, Lq, Lk)) return (int)cudaErrorInvalidValue;
  const Tf32BwdParts p(const_cast<void*>(parts), (long long)B * Lq * H * D,
                       (long long)B * Lk * H * D);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VX_CASE(D_, CL_, RK_, SK_, RQ_, SQ_)                                                 \
  if (D == D_)                                                                               \
    return launch_dkv_tf32<D_, CL_, RK_, SK_>(p, l, d, static_cast<float*>(dk),              \
                                              static_cast<float*>(dv), static_cast<float*>(ws), \
                                              H, Lq, Lk, geom, scale, s);
  VX_BWD_F32(VX_CASE)
#undef VX_CASE
  return (int)cudaErrorInvalidValue;
}

// fp32, second call: the dq kernel on the parts. dq contiguous (B, Lq, H*D)
// fp32; lse, di as above; `lse_out` null, or a contiguous (B, H, Lq) fp32
// buffer that receives the log-sum-exp of the kernel's own logits, which
// the dk/dv kernel then reads (flash_bwd_tf32.cuh: P's normalisation).
int vx_flash_bwd_dq_f32(const void* parts, const void* lse, const void* di, void* dq,
                        void* lse_out, int B, int H, int Lq, int Lk, int D, const long long* geom,
                        float scale, void* stream) {
  if (!vx::flash_shape_ok(B, H, Lq, Lk)) return (int)cudaErrorInvalidValue;
  const Tf32BwdParts p(const_cast<void*>(parts), (long long)B * Lq * H * D,
                       (long long)B * Lk * H * D);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VX_CASE(D_, CL_, RK_, SK_, RQ_, SQ_) \
  if (D == D_)                               \
    return launch_dq_tf32<D_, CL_, RQ_, SQ_>(p, l, d, static_cast<float*>(dq),          \
                                             static_cast<float*>(lse_out), H, Lq, Lk, geom, \
                                             scale, s);
  VX_BWD_F32(VX_CASE)
#undef VX_CASE
  return (int)cudaErrorInvalidValue;
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

// The tiling of the fp32 backward at head dim D, in the order of
// ops/flash_tma.py::F32_BWD_TILE_FIELDS: swizzle bytes and box columns of
// the row-major parts, CTAs a cluster, ring rows, stages and dynamic shared
// memory bytes of dk/dv and of dq, threads. cudaErrorInvalidValue for a D
// with no instantiation.
int vx_flash_bwd_f32_tile(int D, long long* out) {
#define VX_TILE(D_, CL_, RK_, SK_, RQ_, SQ_)                                              \
  if (D == D_) {                                                                          \
    using K = Tf32BwdTile<D_, CL_, RK_, SK_, 2>;                                          \
    using Q = Tf32BwdTile<D_, CL_, RQ_, SQ_, 1>;                                          \
    const long long t[10] = {K::SW,      K::CW,  CL_,       K::R,     K::STAGES,            \
                             K::SMEM,    Q::R,   Q::STAGES, Q::SMEM,  TF32_BWD_THREADS};    \
    for (int i = 0; i < 10; ++i) out[i] = t[i];                                           \
    return 0;                                                                             \
  }
  VX_BWD_F32(VX_TILE)
#undef VX_TILE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
