// T1: K1's mma.sync forward at other tilings, for Hopper (sm_90a), plain C interface.
//
// Replaces: tools/bench_attn_variants.py:77-95 (`flash_at`) and :156-172
// (`flash_bb`), which run the JAX library's Pallas TPU flash_attention
// (pallas_call at flash_attention.py:758 of the library) at
// BlockSizes(block_b in {1, 2, 4}, block_q/block_k in {512, 1024, 2048}), the
// head dim zero-padded to 64 or 128 in device memory. Same function as K1:
// non-causal softmax(q k^T * scale) v per (batch, head), the scale applied to
// the fp32 logits in the kernel, fp32 running max and sum, p rounded to bf16
// for P V, bf16 output.
//
// Bound on an H100 SXM: the function is K1's, so 4*B*H*Lq*Lk*D operations at
// the nominal D (40) over 989e12 FLOP/s (B=48, H=8, L=4096: 1.042 ms); zero
// padding adds tensor-core work (k-steps of S = Q K^T and n-tiles of P V) but
// no work the function needs.
//
// Design: flash_fwd_mma (flash_fwd_mma.cuh), K1's first kernel, with its tiling as
// template parameters: query rows per block BQ (64 or 128: 4 or 8 warps), keys
// per shared-memory tile BK, the padded head dim DP (48, the natural padding
// of D=40 to the mma depth, or 64, or 128: zero columns in shared memory and
// in the Q fragments, never stored, so the padding costs no device-memory
// bytes), and (batch, head) pairs per block HB (1, 2, 4), walked in turn by
// the block. Only the bench's rows are instantiated, at D=40, bf16:
//   BQ  BK  DP  HB
//   64  64  48  1   t1_native (K1's tiling before flash_fwd_wgmma.cuh)
//   64  64  64  1   t1_pad64
//   64  64 128  1   t1_pad128
//   64  64  48  2,4 t1_hb*_q64k64   (the tool's block_q = block_k)
//  128  64  48  2,4 t1_hb*_q128k64  (q-larger)
//   64 128  48  2,4 t1_hb*_q64k128  (k-larger)
//
// Layout: q, k, v, o read through (batch, head, row) element strides, the head
// dim contiguous: (B, H, L, D) for the bench, (B, L, H*D) works as well. The
// launch goes on the caller's stream, allocates nothing and does not
// synchronise; the function returns cudaGetLastError().

#include "flash_fwd_mma.cuh"

namespace {

using namespace vx;

#define VX_T1_ROWS(X) \
  X(64, 64, 48, 1)    \
  X(64, 64, 64, 1)    \
  X(64, 64, 128, 1)   \
  X(64, 64, 48, 2)    \
  X(128, 64, 48, 2)   \
  X(64, 128, 48, 2)   \
  X(64, 64, 48, 4)    \
  X(128, 64, 48, 4)   \
  X(64, 128, 48, 4)

}  // namespace

extern "C" {

// bf16 only, D = 40. `strides` holds 12 element strides: (batch, head, row)
// of q, k, v, o in turn. (block_q, block_k, d_pad, heads_per_block) must be a
// row of the table above, block_q divide Lq, block_k divide Lk and
// heads_per_block divide B*H.
int vx_flash_fwd_variant(const void* q, const void* k, const void* v, void* o, int B, int H,
                         int Lq, int Lk, int D, const long long* strides, float scale,
                         int block_q, int block_k, int d_pad, int heads_per_block,
                         void* stream) {
  if (D != 40 || block_q <= 0 || block_k <= 0 || heads_per_block <= 0 || Lq % block_q != 0 ||
      Lk % block_k != 0 || (B * H) % heads_per_block != 0 || B * H / heads_per_block > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides st = strides_from(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VX_T1_LAUNCH(BQ_, BK_, DP_, HB_)                                                    \
  if (block_q == BQ_ && block_k == BK_ && d_pad == DP_ && heads_per_block == HB_) {        \
    launch_mma<40, BQ_, BK_, DP_, HB_, false>(q, k, v, o, B, H, Lq, Lk, st, scale * LOG2E, \
                                              s);                                           \
    return (int)cudaGetLastError();                                                         \
  }
  VX_T1_ROWS(VX_T1_LAUNCH)
#undef VX_T1_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
