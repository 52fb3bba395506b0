// T2: the splash-attention MHA forward for Hopper (sm_90a), plain C interface.
//
// Replaces: tools/bench_attn_variants.py:106-137 (`splash_at`), which runs the
// JAX library's Pallas TPU splash attention (`make_splash_mha` over a
// MultiHeadMask of FullMask per head; pallas_call at
// splash_attention_kernel.py:1137, body flash_attention_kernel :696-843),
// vmapped over the batch. What it computes, per (batch, head), differs from
// K1's on purpose:
//   q' arrives scaled by the caller (in its dtype); the kernel applies no scale;
//   s = q' k^T in fp32; fp32 running max m and sum l; p = exp(s - m) in fp32;
//   o += p v with v widened to fp32 and p NOT rounded (K1 rounds p to bf16);
//   out = o / l once, at the end.
// The mask is full: splash's block-sparse mask machinery (MaskInfo, the
// data_next / block_mask tables) has nothing to skip and is not ported.
//
// Bound on an H100 SXM: 4*B*H*Lq*Lk*D operations at the nominal D (40) over
// 989e12 FLOP/s (B=48, H=8, L=4096: 1.042 ms), as K1; the exps set a floor
// of about 1.7 ms there, and the split below doubles P V's tensor work.
//
// Design: K1's bf16 forward (flash_fwd_wgmma.cuh) in P mode SPLIT, with the
// scale log2(e) (so the exps are K1's ex2.approx with the same fold). v is
// bf16, so widening it is exact and only p's rounding matters: p = p_hi +
// p_lo, p_hi = bf16(p), p_lo = bf16(p - p_hi), both A fragments built in
// registers before the warpgroup arrives, and P V is two RS wgmma a 16-key
// k-step into the same fp32 accumulator. That keeps about 16 significant bits
// of p (relative error at most 2^-17 per p, against 2^-9 for K1's single bf16
// p) at twice K1's P V tensor work, and no fp32 FMA loop. Against fp32 P V
// the output then differs by about 2^-17 of its magnitude before its own bf16
// rounding (2^-9), which dominates. Tiles, as the bench's three rows need
// them (D=40, bf16, 128-byte swizzle, one (batch, head) a block):
//   BQ  BK  NV  MINB STAGES
//   64  64  48  2    6   t2_native  (the tool's splash_native40)
//   64  64  64  2    6   t2_pad64   (splash_pad64: TMA's zero fill past D)
//  128 128  48  1    3   t2_bigtile (splash_bq4096: one larger tile)
// The 64-row tiles as T1's (flash_variants.cu); t2_bigtile's consumers hold
// S, P's two fragments and O in 240 registers, so one block an SM.
//
// Layout, maps and launch as flash_variants.cu: (B, H, L, D) tensors read
// through maps in their memory order, o through its strides.

#include "flash_fwd_wgmma.cuh"

namespace {

using namespace vx;

template <int BQ, int BK, int NV, int MINB, int STAGES>
using T2Tile = WgmmaTile<40, 128, BQ, BK, NV, 1, MINB, STAGES>;

// T2's kernel: the forward with p kept as a bf16 pair (no log-sum-exp)
template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
splash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, const FwdArgs a) {
  fwd_wgmma<T, PMode::SPLIT>(tq, tk, tv, o, lse, a);
}

// (BQ, BK, NV, MINB, STAGES) of each instantiation; ops/flash_tma.py's
// T2_TILES holds the same, and `vx_splash_mha_tile` lets the wrapper check
// that the two agree
#define VX_T2_ROWS(X) \
  X(64, 64, 48, 2, 6) \
  X(64, 64, 64, 2, 6) \
  X(128, 128, 48, 1, 3)

}  // namespace

extern "C" {

// bf16 only, D = 40; q already scaled. `geom` and `o_strides` as for
// vx_flash_fwd_variant. (block_q, block_kv, d_pad) must be a row of the table
// above, block_q divide Lq and block_kv divide Lk.
int vx_splash_mha_fwd(const void* q, const void* k, const void* v, void* o, int B, int H,
                      int Lq, int Lk, int D, const long long* geom, const long long* o_strides,
                      int block_q, int block_kv, int d_pad, void* stream) {
  if (D != 40 || block_q <= 0 || block_kv <= 0 || Lq % block_q != 0 || Lk % block_kv != 0 ||
      geom[5] != (long long)B * H)
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{H, Lq, Lk, (int)geom[21], LOG2E, o_strides[0], o_strides[1], o_strides[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VX_T2_LAUNCH(BQ_, BK_, NV_, MINB_, NS_)                                           \
  if (block_q == BQ_ && block_kv == BK_ && d_pad == NV_) {                                \
    using T = T2Tile<BQ_, BK_, NV_, MINB_, NS_>;                                          \
    static std::atomic<unsigned long long> smem_set{0};                                   \
    return launch_fwd<T>(splash_fwd_wgmma<T>, smem_set, q, k, v, o, nullptr, geom, a, s); \
  }
  VX_T2_ROWS(VX_T2_LAUNCH)
#undef VX_T2_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The instantiation at (block_q, block_kv, d_pad), in the order of
// ops/flash_tma.py::VARIANT_TILE_FIELDS (pairs per block 1). Returns
// cudaErrorInvalidValue for a tiling with no instantiation.
int vx_splash_mha_tile(int block_q, int block_kv, int d_pad, long long* out) {
#define VX_T2_TILE(BQ_, BK_, NV_, MINB_, NS_)                                              \
  if (block_q == BQ_ && block_kv == BK_ && d_pad == NV_) {                                 \
    using T = T2Tile<BQ_, BK_, NV_, MINB_, NS_>;                                           \
    const long long t[10] = {T::BQ, T::BK, T::NV, T::HB, T::SW, T::CW, T::MINB, T::STAGES, \
                             T::SMEM, T::THREADS};                                         \
    for (int i = 0; i < 10; ++i) out[i] = t[i];                                            \
    return 0;                                                                              \
  }
  VX_T2_ROWS(VX_T2_TILE)
#undef VX_T2_TILE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
