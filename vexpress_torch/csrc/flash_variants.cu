// T1: K1's forward at other tilings, for Hopper (sm_90a), plain C interface.
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
// padding adds tensor-core work (k-steps of S = Q K^T and n-columns of P V)
// but no work the function needs. The exps (B*H*Lq*Lk on the SFUs) set the
// real floor, about 1.7 ms there, as for K1.
//
// Design: K1's bf16 forward (flash_fwd_wgmma.cuh, P mode ROUND: TMA producer
// warpgroup, 64-row wgmma consumer warpgroups, mbarrier ring) with its tiling
// as template parameters: query rows per block BQ (64 or 128: one or two
// consumer warpgroups), keys per stage BK, the product head dim NV (48, the
// natural padding of D=40 to the wgmma depth, or 64, or 128: TMA's zero fill
// past D, and zeroed chunks past column 64, so the padding costs no
// device-memory bytes), and (batch, head) pairs per block HB (1, 2, 4): one
// ring runs over the HB pairs' key tiles, and the next pair's Q lands in a
// second buffer while the consumers finish this pair. Two blocks share an
// SM (128 registers a thread at launch at 64 rows, 232 for the consumers
// after setmaxnreg; K1's 80 and 104 at 128 rows), each with the deepest ring
// that fits. A 64-row block gets half the work of K1's 128-row block out of
// each K/V tile, and the SM takes tiles at one rate whatever the blocks
// (PERF.md §6), so the 64-row rows run at about half K1's rate. Only the
// bench's rows are instantiated, at D=40, bf16:
//   BQ  BK  NV  HB  MINB STAGES
//   64  64  48  1   2    6   t1_native (K1's tiling before flash_fwd_wgmma.cuh)
//   64  64  64  1   2    6   t1_pad64
//   64  64 128  1   2    2   t1_pad128
//   64  64  48  2,4 2    5   t1_hb*_q64k64   (the tool's block_q = block_k)
//  128  64  48  2,4 2    3   t1_hb*_q128k64  (q-larger: K1's tile)
//   64 128  48  2,4 2    2   t1_hb*_q64k128  (k-larger)
//
// Layout: q, k, v (B, H, L, D), the head dim contiguous, each read through a
// tensor map in its memory order (ops/flash_tma.py::variant_geometry): (D, L,
// H, B) for contiguous tensors, (D, H, L, B) for head-major views of packed
// (B, L, H*D) ones; o stored through its (batch, head, row) element strides.
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the function returns cudaGetLastError(), or a failed encode's
// code (vx_error_string names it).

#include "flash_fwd_wgmma.cuh"

namespace {

using namespace vx;

template <int BQ, int BK, int NV, int HB, int MINB, int STAGES>
using T1Tile = WgmmaTile<40, 128, BQ, BK, NV, HB, MINB, STAGES>;

// T1's kernel: the forward with p rounded to bf16 (no log-sum-exp)
template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
flash_fwd_variant_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, const FwdArgs a) {
  fwd_wgmma<T, PMode::ROUND>(tq, tk, tv, o, lse, a);
}

// (BQ, BK, NV, HB, MINB, STAGES) of each instantiation; ops/flash_tma.py's
// T1_TILES holds the same, and `vx_flash_fwd_variant_tile` lets the wrapper
// check that the two agree
#define VX_T1_ROWS(X)     \
  X(64, 64, 48, 1, 2, 6)  \
  X(64, 64, 64, 1, 2, 6)  \
  X(64, 64, 128, 1, 2, 2) \
  X(64, 64, 48, 2, 2, 5)  \
  X(128, 64, 48, 2, 2, 3) \
  X(64, 128, 48, 2, 2, 2) \
  X(64, 64, 48, 4, 2, 5)  \
  X(128, 64, 48, 4, 2, 3) \
  X(64, 128, 48, 4, 2, 2)

}  // namespace

extern "C" {

// bf16 only, D = 40. `geom` (ops/flash_tma.py::variant_geometry_arg): the
// forward's 21 values, then the maps' order bits (FwdArgs::order); `o_strides`
// o's (batch, head, row) element strides. (block_q, block_k, d_pad,
// heads_per_block) must be a row of the table above, block_q divide Lq,
// block_k divide Lk and heads_per_block divide B*H.
int vx_flash_fwd_variant(const void* q, const void* k, const void* v, void* o, int B, int H,
                         int Lq, int Lk, int D, const long long* geom, const long long* o_strides,
                         float scale, int block_q, int block_k, int d_pad, int heads_per_block,
                         void* stream) {
  if (D != 40 || block_q <= 0 || block_k <= 0 || heads_per_block <= 0 || Lq % block_q != 0 ||
      Lk % block_k != 0 || (B * H) % heads_per_block != 0 ||
      geom[5] * heads_per_block != (long long)B * H)
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{H, Lq, Lk, (int)geom[21], scale * LOG2E, o_strides[0], o_strides[1],
                  o_strides[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VX_T1_LAUNCH(BQ_, BK_, NV_, HB_, MINB_, NS_)                                         \
  if (block_q == BQ_ && block_k == BK_ && d_pad == NV_ && heads_per_block == HB_) {          \
    using T = T1Tile<BQ_, BK_, NV_, HB_, MINB_, NS_>;                                        \
    static std::atomic<unsigned long long> smem_set{0};                                      \
    return launch_fwd<T>(flash_fwd_variant_wgmma<T>, smem_set, q, k, v, o, nullptr, geom, a, \
                         s);                                                                 \
  }
  VX_T1_ROWS(VX_T1_LAUNCH)
#undef VX_T1_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The instantiation at (block_q, block_k, d_pad, heads_per_block), in the
// order of ops/flash_tma.py::VARIANT_TILE_FIELDS: query rows and keys per
// tile, product head dim, pairs per block, swizzle bytes, box columns, blocks
// per SM, stages, dynamic shared memory bytes, threads. Returns
// cudaErrorInvalidValue for a tiling with no instantiation.
int vx_flash_fwd_variant_tile(int block_q, int block_k, int d_pad, int heads_per_block,
                              long long* out) {
#define VX_T1_TILE(BQ_, BK_, NV_, HB_, MINB_, NS_)                                         \
  if (block_q == BQ_ && block_k == BK_ && d_pad == NV_ && heads_per_block == HB_) {        \
    using T = T1Tile<BQ_, BK_, NV_, HB_, MINB_, NS_>;                                      \
    const long long t[10] = {T::BQ, T::BK, T::NV, T::HB, T::SW, T::CW, T::MINB, T::STAGES, \
                             T::SMEM, T::THREADS};                                         \
    for (int i = 0; i < 10; ++i) out[i] = t[i];                                            \
    return 0;                                                                              \
  }
  VX_T1_ROWS(VX_T1_TILE)
#undef VX_T1_TILE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
