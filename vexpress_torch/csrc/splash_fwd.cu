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
// 989e12 FLOP/s (B=48, H=8, L=4096: 1.042 ms), as K1.
//
// Design: flash_fwd_mma (flash_fwd_mma.cuh) with P_SPLIT and the scale
// log2(e) (so the exps are K1's exp2f). v is bf16, so widening it is exact
// and only p's rounding matters: p = p_hi + p_lo, p_hi = bf16(p), p_lo =
// bf16(p - p_hi), and P V is two mma.sync m16n8k16 products into the same
// fp32 accumulator. That keeps about 16 significant bits of p (relative error
// at most 2^-17 per p, against 2^-9 for K1's single bf16 p) at twice K1's P V
// tensor work, and no fp32 FMA loop. Against fp32 P V the output then differs
// by about 2^-17 of its magnitude before its own bf16 rounding (2^-9), which
// dominates. Tiles, as the bench's three rows need them (D=40, bf16):
//   BQ  BK  DP
//   64  64  48   t2_native  (the tool's splash_native40)
//   64  64  64   t2_pad64   (splash_pad64; zero columns in shared memory)
//  128 128  48   t2_bigtile (splash_bq4096: one larger tile)
//
// Layout, strides and launch as flash_variants.cu: (batch, head, row) element
// strides, (B, H, L, D) for the bench.

#include "flash_fwd_mma.cuh"

namespace {

using namespace vx;

#define VX_T2_ROWS(X) \
  X(64, 64, 48)       \
  X(64, 64, 64)       \
  X(128, 128, 48)

}  // namespace

extern "C" {

// bf16 only, D = 40; q already scaled. `strides` holds 12 element strides:
// (batch, head, row) of q, k, v, o in turn. (block_q, block_kv, d_pad) must be
// a row of the table above, block_q divide Lq and block_kv divide Lk.
int vx_splash_mha_fwd(const void* q, const void* k, const void* v, void* o, int B, int H,
                      int Lq, int Lk, int D, const long long* strides, int block_q, int block_kv,
                      int d_pad, void* stream) {
  if (D != 40 || block_q <= 0 || block_kv <= 0 || Lq % block_q != 0 || Lk % block_kv != 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides st = strides_from(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VX_T2_LAUNCH(BQ_, BK_, DP_)                                                          \
  if (block_q == BQ_ && block_kv == BK_ && d_pad == DP_) {                                  \
    launch_mma<40, BQ_, BK_, DP_, 1, true>(q, k, v, o, B, H, Lq, Lk, st, LOG2E, s);        \
    return (int)cudaGetLastError();                                                          \
  }
  VX_T2_ROWS(VX_T2_LAUNCH)
#undef VX_T2_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
