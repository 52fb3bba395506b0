// K1's fp32 backward for Hopper (sm_90a) at D=40, 80 and 160: the dk/dv and
// dq kernels on the TF32 tensor cores at fp32's accuracy by the "3xTF32"
// split of the fp32 forward (flash_fwd_tf32.cuh), on TMA loads into an
// mbarrier ring, a producer warpgroup and a wgmma consumer warpgroup: the
// bf16 backward's shape (flash_bwd_wgmma.cuh) with tf32 operands.
// flash_bwd.cu states what they replace and the bound, and launches them.
//
// The split pass (flash_bwd.cu's vx_flash_bwd_f32_split, the kernels of
// tf32_split.cuh) writes each operand as tf32 hi and lo parts into a scratch
// buffer: q, k, v and do in their own (B, L, H*D) layout, and, since wgmma
// takes a tf32 B operand K-major only, the operands whose contraction runs
// along the sequence transposed to (B, H, D, L), each 8 rows in perm_key's
// order (tf32_split.cuh): q and do for dk/dv (dV += P^T dO, dK += dS^T Q),
// k for dq (dQ += dS K). A product is hi hi + hi lo + lo hi into fp32
// accumulators (lo lo, about 2^-22 of it, is left out).
//
// dk/dv, one CTA per (64 keys, batch, head, part of the query axis): K's and
// V's parts are fixed; a stage of the ring holds R queries of Q's and dO's
// parts (4-D TMA boxes), of Q^T's and dO^T's ((R queries, D rows) boxes) and
// their R lse and di values (1-D bulk copies). Per query tile:
//   S^T = K Q^T, dP^T = V dO^T      3 SS wgmma a k-step each, 8 deep over D
//   P^T = 2^(S^T scale log2 e - lse log2 e), dS^T = P^T (dP^T - di), fp32
//   dV += P^T dO, dK += dS^T Q      3 RS wgmma a k-step each (8 queries):
//                                   P^T and dS^T split in registers, B the
//                                   transposed parts
// dq, one CTA per (64 queries, batch, head): Q's, dO's parts and their lse
// and di are fixed; a stage holds R keys of K's and V's parts and of K^T's.
//   S = Q K^T, dP = dO V^T; P, dS in registers; dQ += dS K (K^T's parts).
// Each tile's SS products run while the element-wise work of the tile
// before does, and its RS products right behind them, as in the bf16
// kernels: each wait on a fixed count of wgmma groups, the last tile peeled.
//
// P's normalisation. P = exp(S scale - lse) sums to 1 over the keys only
// if this kernel's S is the forward's, and the tensor cores' rounding (below)
// makes the forward's log-sum-exp differ from the one of the backward's S by
// up to ~1e-5 at Lk = 4096, a common factor on every P of a row that took
// dQ and dK to 1.5-1.9x the fp32 max bar at attn1 @64². The dq kernel sees
// every key of its rows: it sums its P (tile sums added in fp64), divides dQ
// by the sum r and writes lse + ln r, which the dk/dv kernel, launched after
// it, reads in place of the forward's.
//
// The tensor cores round their fp32 sums toward zero, and dK, dV (over Lq)
// and dQ (over Lk) sum thousands of products: carried in the accumulator the
// bias adds up (the forward's O missed the fp32 mean bar by 2.3x over 1,536).
// So each tile's dV, dK (dQ) products start afresh and are added into the
// sums on the CUDA cores, rounded to nearest: the truncated chain is one
// tile long (3 KK products). In every chain the cross products go first and
// hi hi last, as in the forward, and S's in the forward's order.
//
// Registers: the sums and the tile's products take 2 D of a thread's 255
// at D=40 and 80 (dk/dv; D at dq), S and dP R, the A fragments (hi and lo) 2R
// (dk/dv; R at dq): at D=80, 16-row ring tiles. At D=160 neither the
// registers nor shared memory hold one CTA's share (K's and V's four parts
// alone are 160 KiB at 64 keys), so two CTAs of a cluster share the block's
// rows, each on 80 columns of the head dim: each computes S and dP over its
// columns, sends its partial sums to the other's shared memory
// (st.shared::cluster, then an mbarrier arrive with release at cluster scope)
// and adds the other's (fp32 addition commutes, so both hold the same sums),
// then computes dK, dV (dQ) on its 80 columns.
//
// Shared memory (Tf32BwdTile): the row-major parts are cut along the head
// dim into chunks of CW = 16 columns (64-byte swizzle; TMA reads zeros past
// D), the transposed parts are DH rows of R columns (R * 4 bytes, their
// swizzle span). Lq and Lk are multiples of 64 and R divides 64, so no tile
// is partial and nothing is masked.

#pragma once

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "tf32_split.cuh"

namespace {

using namespace vx;

constexpr int TF32_BWD_THREADS = 256;  // the consumer warpgroup, then the producer's

// the tiling and shared-memory layout of one fp32 backward kernel: head dim
// D, CL CTAs a cluster, ring tiles of R rows in NS stages, NT transposed
// operands (2 for dk/dv, 1 for dq); bytes
template <int D_, int CL_, int R_, int NS_, int NT_>
struct Tf32BwdTile {
  static constexpr int D = D_, CL = CL_, R = R_, STAGES = NS_, NT = NT_;
  static constexpr int DH = D / CL;              // head-dim columns of one CTA
  static constexpr int SW = 64, CW = SW / 4;     // row-major parts: swizzle, columns a chunk
  static constexpr int NC = (DH + CW - 1) / CW;  // chunks of a row-major part
  static constexpr int KS = DH / 8;              // k-steps of the SS products
  static constexpr int KK = R / 8;               // k-steps of the RS products
  static constexpr int SWT = R * 4;              // transposed parts: one row of R columns
  static constexpr int ROWS = 64;                // the block's fixed rows: keys or queries
  static constexpr uint32_t FIX_CHUNK = ROWS * SW;
  static constexpr uint32_t FIX_PART = NC * FIX_CHUNK;   // 4: hi, lo of the two fixed operands
  static constexpr uint32_t RING_CHUNK = R * SW;
  static constexpr uint32_t RING_PART = NC * RING_CHUNK;  // 4 a stage: hi, lo of two operands
  static constexpr uint32_t T_PART = DH * SWT;            // 2 NT a stage: the transposed
  static constexpr uint32_t T_OFF = 4 * RING_PART;        // the transposed parts in a stage
  static constexpr uint32_t STAGE_BYTES = T_OFF + 2 * NT * T_PART;
  static constexpr uint32_t RING_OFF = 4 * FIX_PART;
  static constexpr uint32_t STATS_OFF = RING_OFF + STAGES * STAGE_BYTES;
  // lse and di: dk/dv R of each a stage, dq the block's 64 of each once
  static constexpr uint32_t STATS = (NT == 2 ? STAGES * 2 * R : 2 * ROWS) * 4;
  static constexpr uint32_t XCH_OFF = STATS_OFF + STATS;
  static constexpr uint32_t XCH_BUF = 2 * ROWS * R * 4;  // the other CTA's partial S and dP
  static constexpr uint32_t BAR_OFF = XCH_OFF + (CL > 1 ? 2 * XCH_BUF : 0);
  // full[NS], empty[NS], fixed, exchange[2]; + slack to align the base
  static constexpr uint32_t SMEM = BAR_OFF + 8 * (2 * STAGES + 3) + 1024;
  static_assert(CL == 1 || CL == 2, "one CTA, or two on halves of the head dim");
  static_assert(DH % 8 == 0 && 64 % R == 0 && (R == 16 || R == 32), "whole k-steps and tiles");
  static_assert(RING_CHUNK % 1024 == 0 && T_PART % 1024 == 0 && STAGE_BYTES % 1024 == 0,
                "every box keeps the swizzle's period");
  static_assert(XCH_OFF % 16 == 0, "16-byte exchange stores");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// The tensor maps of one launch (4-D, fp32). dk/dv: m[0..3] K hi, K lo, V hi,
// V lo ((D, H, Lk, B), 64-row boxes); m[4..7] Q hi, Q lo, dO hi, dO lo ((D,
// H, Lq, B), R-row boxes); m[8..11] Q^T hi, Q^T lo, dO^T hi, dO^T lo ((Lq, D,
// H, B), boxes of R queries by DH rows). dq: m[0..3] Q hi, Q lo, dO hi, dO lo
// (64-row boxes); m[4..7] K hi, K lo, V hi, V lo (R rows); m[8..9] K^T hi, lo.
struct BwdMaps {
  CUtensorMap m[12];
};

// lse, di: (B, H, Lq) fp32. out0, out1: dk and dv (dk/dv) or dq, (B, L, H*D)
// fp32; ws: dk/dv's partial sums when its query axis is split. `scale` the
// softmax scale, `scale_log2` scale * log2(e).
struct Tf32BwdArgs {
  const float* lse;
  const float* di;
  float* out0;
  float* out1;
  float* ws;
  int H, Lq, Lk;
  float scale, scale_log2;
};

__device__ __forceinline__ uint8_t* tf32_bwd_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// d (64 x R) = A B^T over the CTA's DH columns, 3xTF32: A the fixed
// operand's hi and lo (ah, al: 64 rows, K-major), B a ring tile's (bh, bl:
// R rows, K-major); k-step kd 8 columns, in chunk kd*8 / CW, 32 bytes a step
// within it (descriptor addresses count 16 bytes)
template <class T, bool A_IS_K>
__device__ __forceinline__ void ss3(float (&d)[T::R / 2], uint64_t ah, uint64_t al, uint64_t bh,
                                    uint64_t bl) {
  // the small cross products first, hi hi last (see the header: each
  // wgmma's sum is truncated relative to the accumulator it adds to), in
  // the fp32 forward's order: q hi k lo, q lo k hi, q hi k hi
  constexpr int A_LO = A_IS_K ? 0 : 1;  // the product that takes A's lo part
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int kd = 0; kd < T::KS; ++kd) {
      const uint64_t ao = (kd * 8 / T::CW) * (T::FIX_CHUNK / 16) + (kd * 8 % T::CW) / 4;
      const uint64_t bo = (kd * 8 / T::CW) * (T::RING_CHUNK / 16) + (kd * 8 % T::CW) / 4;
      wgmma_ss_tf32<T::R>(d, (i == A_LO ? al : ah) + ao, (i == 1 - A_LO ? bl : bh) + bo, i + kd);
    }
  }
}

// d (64 x DH) = A B over a ring tile's R rows, afresh, 3xTF32: A from
// registers (hi fragments ah, lo al; one 8-deep k-step each), B a transposed
// part's hi and lo (bh, bl: DH rows of R columns, K-major; k-step kk 32
// bytes on)
template <class T>
__device__ __forceinline__ void rs3(float (&d)[T::DH / 2], const uint32_t (&ah)[T::KK][4],
                                    const uint32_t (&al)[T::KK][4], uint64_t bh, uint64_t bl) {
#pragma unroll
  for (int kk = 0; kk < T::KK; ++kk) wgmma_rs_tf32<T::DH>(d, ah[kk], bl + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < T::KK; ++kk) wgmma_rs_tf32<T::DH>(d, al[kk], bh + 2 * kk, 1);
#pragma unroll
  for (int kk = 0; kk < T::KK; ++kk) wgmma_rs_tf32<T::DH>(d, ah[kk], bh + 2 * kk, 1);
}

// the tf32 A fragments (hi in h, lo in l) of a 64 x 8KK accumulator taken as
// (64 rows, 8KK k): k-step kk's (g, t), (g+8, t), (g, t+4), (g+8, t+4) are
// the accumulator's columns 8kk+2t and 8kk+2t+1 of rows g and g+8, which
// the transposed parts' perm_key order puts at k-indices t and t+4
template <int KK>
__device__ __forceinline__ void split_a(uint32_t (&h)[KK][4], uint32_t (&l)[KK][4],
                                        const float (&s)[4 * KK]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const float f[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1], s[4 * kk + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[kk][i] = tf32_rna(f[i]);
      l[kk][i] = tf32_rna(f[i] - __uint_as_float(h[kk][i]));
    }
  }
}

// CL = 2: the partial S and dP of tile `it` go to the other CTA of the
// cluster, and the other's are added: both CTAs then hold the same sums.
// Buffer it % 2 of a CTA takes the other's partial of tile it; a thread
// stores its values at its own 16-byte slots, so it reads back its own. A
// CTA writes a buffer again two tiles later, after it has seen the other's
// arrive of the tile between, which the other made after reading it.
template <class T>
struct Tf32Exchange {
  const float4* own;          // this CTA's buffers
  uint32_t peer, bar, peer_bar;  // the other's buffers; this CTA's barriers, the other's
  int tid;

  __device__ __forceinline__ void operator()(float (&s)[T::R / 2], float (&dp)[T::R / 2],
                                             int it) const {
    constexpr int N4 = T::R / 8;  // float4s of s, and of dp, a thread
    const int buf = it & 1;
    const uint32_t dst = peer + buf * T::XCH_BUF;
#pragma unroll
    for (int i = 0; i < N4; ++i) {
      st_cluster_v4(dst + (i * 128 + tid) * 16, s[4 * i], s[4 * i + 1], s[4 * i + 2],
                    s[4 * i + 3]);
      st_cluster_v4(dst + ((N4 + i) * 128 + tid) * 16, dp[4 * i], dp[4 * i + 1], dp[4 * i + 2],
                    dp[4 * i + 3]);
    }
    mbar_arrive_cluster(peer_bar + 8 * buf);
    mbar_wait_cluster(bar + 8 * buf, (it >> 1) & 1);
    const float4* src = own + buf * (T::XCH_BUF / 16);
#pragma unroll
    for (int i = 0; i < N4; ++i) {
      const float4 x = src[i * 128 + tid], y = src[(N4 + i) * 128 + tid];
      s[4 * i] += x.x;
      s[4 * i + 1] += x.y;
      s[4 * i + 2] += x.z;
      s[4 * i + 3] += x.w;
      dp[4 * i] += y.x;
      dp[4 * i + 1] += y.y;
      dp[4 * i + 2] += y.z;
      dp[4 * i + 3] += y.w;
    }
  }
};

// One dk/dv consumer warpgroup over the query tiles: 64 keys, each warp's
// keys g and g+8 in the accumulator layout. A stage goes back to the
// producer once the dV/dK products of its tile have completed.
template <class T>
struct DkvTf32Consumer {
  static constexpr int NS = T::STAGES, R = T::R, KK = T::KK, DH = T::DH;
  static constexpr int SN = R / 2;  // registers of S^T and of dP^T (64 keys x R queries)

  uint32_t fix, ring, bar;  // K hi (K lo, V hi, V lo a FIX_PART apart), the ring, the barriers
  const float* stats;       // lse and di of the stages
  int t, lane;
  float scale_log2;
  float dka[DH / 2], dva[DH / 2];  // dK and dV so far, summed on the CUDA cores
  float fk[DH / 2], fv[DH / 2];    // the latest tile's dK and dV, on the tensor cores
  uint32_t ph[KK][4], pl[KK][4], dh[KK][4], dl[KK][4];  // A fragments of P^T and dS^T
  Tf32Exchange<T> x;

  // S^T = K Q^T and dP^T = V dO^T of tile `it`, once its stage has landed
  __device__ __forceinline__ void issue_sdp(float (&s)[SN], float (&dp)[SN], int it) {
    const int st = it % NS;
    mbar_wait(bar + 8 * st, (it / NS) & 1);
    const uint32_t q = ring + st * T::STAGE_BYTES;
    uint64_t dsc[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dsc[i] = wgmma_desc<T::SW>(fix + i * T::FIX_PART, 16, 8 * T::SW);
      dsc[4 + i] = wgmma_desc<T::SW>(q + i * T::RING_PART, 16, 8 * T::SW);
    }
    wgmma_fence_operands(dsc);
    wgmma_fence_operands(s);
    wgmma_fence_operands(dp);
    wgmma_fence();
    ss3<T, true>(s, dsc[0], dsc[1], dsc[4], dsc[5]);
    ss3<T, true>(dp, dsc[2], dsc[3], dsc[6], dsc[7]);
    wgmma_commit();
  }

  // P^T and dS^T of tile `it` in place; columns 8j+2t, 8j+2t+1 are its queries
  __device__ __forceinline__ void p_ds(float (&s)[SN], float (&dp)[SN], int it) const {
    const float* lse_t = stats + (it % NS) * 2 * R;
    const float* di_t = lse_t + R;
#pragma unroll
    for (int j = 0; j < R / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * t);
      const float2 e = *reinterpret_cast<const float2*>(di_t + 8 * j + 2 * t);
      const float l0 = l.x * LOG2E, l1 = l.y * LOG2E;
      s[4 * j] = ex2_approx(fmaf(s[4 * j], scale_log2, -l0));
      s[4 * j + 1] = ex2_approx(fmaf(s[4 * j + 1], scale_log2, -l1));
      s[4 * j + 2] = ex2_approx(fmaf(s[4 * j + 2], scale_log2, -l0));
      s[4 * j + 3] = ex2_approx(fmaf(s[4 * j + 3], scale_log2, -l1));
      dp[4 * j] = s[4 * j] * (dp[4 * j] - e.x);
      dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - e.y);
      dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - e.x);
      dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - e.y);
    }
  }

  // the latest tile's products into the sums, rounded to nearest
  __device__ __forceinline__ void fold() {
    wgmma_fence_operands(fk);
    wgmma_fence_operands(fv);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) {
      dka[i] += fk[i];
      dva[i] += fv[i];
    }
  }

  // after the previous tile's dV/dK products have completed: its stage goes
  // back to the producer, its products into the sums, and P^T, dS^T of this
  // tile split into the A fragments
  __device__ __forceinline__ void take(const float (&s)[SN], const float (&dp)[SN], int it) {
    wgmma_fence_operands(ph);
    wgmma_fence_operands(pl);
    wgmma_fence_operands(dh);
    wgmma_fence_operands(dl);
    __syncwarp();
    if (lane == 0 && it > 0) mbar_arrive(bar + 8 * (NS + (it - 1) % NS));
    fold();
    split_a<KK>(ph, pl, s);
    split_a<KK>(dh, dl, dp);
  }

  // dV = P^T dO and dK = dS^T Q of tile `it`, afresh, from the transposed parts
  __device__ __forceinline__ void issue_rs(int it) {
    const uint32_t tp = ring + (it % NS) * T::STAGE_BYTES + T::T_OFF;  // Q^T hi, lo, dO^T hi, lo
    uint64_t dsc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) dsc[i] = wgmma_desc<T::SWT>(tp + i * T::T_PART, 16, 8 * T::SWT);
    wgmma_fence_operands(dsc);
    wgmma_fence_operands(fk);
    wgmma_fence_operands(fv);
    wgmma_fence_operands(ph);
    wgmma_fence_operands(pl);
    wgmma_fence_operands(dh);
    wgmma_fence_operands(dl);
    wgmma_fence();
    rs3<T>(fv, ph, pl, dsc[2], dsc[3]);
    rs3<T>(fk, dh, dl, dsc[0], dsc[1]);
    wgmma_commit();
  }

  // Tile `it`, whose S^T and dP^T are complete in s, dp: P^T and dS^T run
  // while the tile before's dV/dK do; then, with MORE (a tile follows), S^T
  // and dP^T of the next tile and dV/dK of this one run back to back.
  template <bool MORE>
  __device__ __forceinline__ void step(float (&s)[SN], float (&dp)[SN], int it) {
    p_ds(s, dp, it);
    wgmma_wait<0>();
    take(s, dp, it);
    if constexpr (MORE) issue_sdp(s, dp, it + 1);
    issue_rs(it);
    if constexpr (MORE) {  // S^T, dP^T of the next tile (the older group) have completed
      wgmma_wait<1>();
      wgmma_fence_operands(s);
      wgmma_fence_operands(dp);
      if constexpr (T::CL > 1) x(s, dp, it + 1);
    }
  }
};

// One dq consumer warpgroup over the key tiles: 64 queries, each warp's rows
// g and g+8. A stage goes back to the producer once the dQ product of its
// tile has completed.
template <class T>
struct DqTf32Consumer {
  static constexpr int NS = T::STAGES, R = T::R, KK = T::KK, DH = T::DH;
  static constexpr int SN = R / 2;  // registers of S and of dP (64 queries x R keys)

  uint32_t fix, ring, bar;  // Q hi (Q lo, dO hi, dO lo a FIX_PART apart), the ring, the barriers
  int lane;
  float scale_log2, l0, l1, d0, d1;  // lse (log2 units) and di of rows g and g+8
  double r0, r1;                     // this thread's share of rows g's and g+8's sums of P
  float dqa[DH / 2];                 // dQ so far, summed on the CUDA cores
  float fq[DH / 2];                  // the latest tile's dQ, on the tensor cores
  uint32_t dh[KK][4], dl[KK][4];     // A fragments of dS
  Tf32Exchange<T> x;

  // S = Q K^T and dP = dO V^T of tile `it`, once its stage has landed
  __device__ __forceinline__ void issue_sdp(float (&s)[SN], float (&dp)[SN], int it) {
    const int st = it % NS;
    mbar_wait(bar + 8 * st, (it / NS) & 1);
    const uint32_t k = ring + st * T::STAGE_BYTES;
    uint64_t dsc[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dsc[i] = wgmma_desc<T::SW>(fix + i * T::FIX_PART, 16, 8 * T::SW);
      dsc[4 + i] = wgmma_desc<T::SW>(k + i * T::RING_PART, 16, 8 * T::SW);
    }
    wgmma_fence_operands(dsc);
    wgmma_fence_operands(s);
    wgmma_fence_operands(dp);
    wgmma_fence();
    ss3<T, false>(s, dsc[0], dsc[1], dsc[4], dsc[5]);
    ss3<T, false>(dp, dsc[2], dsc[3], dsc[6], dsc[7]);
    wgmma_commit();
  }

  // dS in place of dP; rows g (s[4j], s[4j+1]) and g+8 (s[4j+2], s[4j+3]);
  // the tile's P summed into r0, r1
  __device__ __forceinline__ void p_ds(float (&s)[SN], float (&dp)[SN], int) {
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < R / 8; ++j) {
      const float p0 = ex2_approx(fmaf(s[4 * j], scale_log2, -l0));
      const float p1 = ex2_approx(fmaf(s[4 * j + 1], scale_log2, -l0));
      const float p2 = ex2_approx(fmaf(s[4 * j + 2], scale_log2, -l1));
      const float p3 = ex2_approx(fmaf(s[4 * j + 3], scale_log2, -l1));
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      dp[4 * j] = p0 * (dp[4 * j] - d0);
      dp[4 * j + 1] = p1 * (dp[4 * j + 1] - d0);
      dp[4 * j + 2] = p2 * (dp[4 * j + 2] - d1);
      dp[4 * j + 3] = p3 * (dp[4 * j + 3] - d1);
    }
    r0 += ps0;
    r1 += ps1;
  }

  __device__ __forceinline__ void fold() {
    wgmma_fence_operands(fq);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dqa[i] += fq[i];
  }

  // after the previous tile's dQ product has completed: its stage goes back
  // to the producer, its product into the sum, and dS of this tile split
  __device__ __forceinline__ void take(const float (&)[SN], const float (&dp)[SN], int it) {
    wgmma_fence_operands(dh);
    wgmma_fence_operands(dl);
    __syncwarp();
    if (lane == 0 && it > 0) mbar_arrive(bar + 8 * (NS + (it - 1) % NS));
    fold();
    split_a<KK>(dh, dl, dp);
  }

  // dQ = dS K of tile `it`, afresh, from K^T's parts
  __device__ __forceinline__ void issue_rs(int it) {
    const uint32_t tp = ring + (it % NS) * T::STAGE_BYTES + T::T_OFF;  // K^T hi, lo
    uint64_t dsc[2] = {wgmma_desc<T::SWT>(tp, 16, 8 * T::SWT),
                       wgmma_desc<T::SWT>(tp + T::T_PART, 16, 8 * T::SWT)};
    wgmma_fence_operands(dsc);
    wgmma_fence_operands(fq);
    wgmma_fence_operands(dh);
    wgmma_fence_operands(dl);
    wgmma_fence();
    rs3<T>(fq, dh, dl, dsc[0], dsc[1]);
    wgmma_commit();
  }

  // as DkvTf32Consumer::step
  template <bool MORE>
  __device__ __forceinline__ void step(float (&s)[SN], float (&dp)[SN], int it) {
    p_ds(s, dp, it);
    wgmma_wait<0>();
    take(s, dp, it);
    if constexpr (MORE) issue_sdp(s, dp, it + 1);
    issue_rs(it);
    if constexpr (MORE) {
      wgmma_wait<1>();
      wgmma_fence_operands(s);
      wgmma_fence_operands(dp);
      if constexpr (T::CL > 1) x(s, dp, it + 1);
    }
  }
};

// The consumer loop of either kernel over n_tiles (>= 1) tiles, the last
// one peeled so that every wait count is fixed; returns with every product
// folded into the sums.
template <class T, class C>
__device__ __forceinline__ void consume_tf32(C& c, int n_tiles) {
  float s[T::R / 2], dp[T::R / 2];
  c.issue_sdp(s, dp, 0);
  wgmma_wait<0>();
  wgmma_fence_operands(s);
  wgmma_fence_operands(dp);
  if constexpr (T::CL > 1) c.x(s, dp, 0);
  for (int it = 0; it + 1 < n_tiles; ++it) c.template step<true>(s, dp, it);
  c.template step<false>(s, dp, n_tiles - 1);
  wgmma_wait<0>();
  c.fold();
}

// the block's barriers, initialised by thread 0 (full[NS]: the producer's
// expect_tx; empty[NS]: one arrive per consumer warp; fixed; with CL = 2 the
// two exchange buffers': one arrive per thread of the other CTA's consumer),
// then every thread of the cluster waits for them
template <class T>
__device__ __forceinline__ void init_tf32_barriers(uint32_t bar) {
  constexpr int NS = T::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar + 8 * s, 1);
      mbar_init(bar + 8 * (NS + s), 4);
    }
    mbar_init(bar + 16 * NS, 1);
    mbar_init(bar + 16 * NS + 8, 128);
    mbar_init(bar + 16 * NS + 16, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (T::CL > 1)
    cluster_sync();
  else
    __syncthreads();
}

// the exchange of a CTA of rank `rank` in its cluster (unused with CL = 1)
template <class T>
__device__ __forceinline__ Tf32Exchange<T> tf32_exchange(uint8_t* smem, uint32_t bar, int rank,
                                                         int tid) {
  Tf32Exchange<T> x;
  x.own = reinterpret_cast<const float4*>(smem + T::XCH_OFF);
  x.bar = bar + 16 * T::STAGES + 8;
  x.tid = tid;
  if constexpr (T::CL > 1) {
    x.peer = cluster_addr(smem_u32(smem + T::XCH_OFF), rank ^ 1);
    x.peer_bar = cluster_addr(x.bar, rank ^ 1);
  } else {
    x.peer = x.peer_bar = 0;
  }
  return x;
}

// dk, dv (or with gridDim.z > 1 parts their partial sums into ws: part p's
// dk at p*n, its dv at (parts+p)*n, n = B*Lk*H*D). Grid: (Lk/64 * CL, B*H,
// parts); CTA rank = blockIdx.x % CL in its cluster takes head-dim columns
// [rank*DH, (rank+1)*DH).
template <class T>
__global__ void __launch_bounds__(TF32_BWD_THREADS, 1)
flash_bwd_dkv_tf32(const __grid_constant__ BwdMaps maps, const Tf32BwdArgs a) {
  constexpr int NS = T::STAGES, R = T::R, DH = T::DH, CW = T::CW, NC = T::NC, D = T::D;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = tf32_bwd_smem(smem_raw);
  const uint32_t fix = smem_u32(smem), ring = fix + T::RING_OFF, stats = fix + T::STATS_OFF;
  const uint32_t bar = fix + T::BAR_OFF, fix_bar = bar + 16 * NS;

  const int rank = blockIdx.x % T::CL, h0 = rank * DH;
  const int k0 = blockIdx.x / T::CL * T::ROWS;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int parts = gridDim.z, part = blockIdx.z, q_tiles = a.Lq / R;
  const int t0 = (int)((long long)part * q_tiles / parts);
  const int n_tiles = (int)((long long)(part + 1) * q_tiles / parts) - t0;

  init_tf32_barriers<T>(bar);

  if (threadIdx.x >= 128) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == 128) {
      mbar_expect_tx(fix_bar, 4 * T::FIX_PART);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int p = 0; p < 4; ++p)
          tma_load_4d(fix + p * T::FIX_PART + c * T::FIX_CHUNK, &maps.m[p], fix_bar, h0 + c * CW,
                      h, k0, b);
      const float* lse_bh = a.lse + (long long)bh * a.Lq;
      const float* di_bh = a.di + (long long)bh * a.Lq;
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % NS, row = (t0 + it) * R;
        mbar_wait(bar + 8 * (NS + st), ((it / NS) & 1) ^ 1);
        const uint32_t full = bar + 8 * st, stage = ring + st * T::STAGE_BYTES;
        const uint32_t st_stats = stats + st * 2 * R * 4;
        mbar_expect_tx(full, T::STAGE_BYTES + 2 * R * 4);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int p = 0; p < 4; ++p)
            tma_load_4d(stage + p * T::RING_PART + c * T::RING_CHUNK, &maps.m[4 + p], full,
                        h0 + c * CW, h, row, b);
#pragma unroll
        for (int p = 0; p < 4; ++p)
          tma_load_4d(stage + T::T_OFF + p * T::T_PART, &maps.m[8 + p], full, row, h0, h, b);
        bulk_load(st_stats, lse_bh + row, R * 4, full);
        bulk_load(st_stats + R * 4, di_bh + row, R * 4, full);
      }
    }
  } else {
    // ------------------------------------------------------------ consumer
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    DkvTf32Consumer<T> c;
    c.fix = fix;
    c.ring = ring;
    c.bar = bar;
    c.stats = reinterpret_cast<const float*>(smem + T::STATS_OFF);
    c.t = t;
    c.lane = lane;
    c.scale_log2 = a.scale_log2;
    c.x = tf32_exchange<T>(smem, bar, rank, tid);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) c.dka[i] = c.dva[i] = c.fk[i] = c.fv[i] = 0.f;
    mbar_wait(fix_bar, 0);
    consume_tf32<T>(c, n_tiles);

    // keys r0 and r0 + 8 of this thread; this CTA's columns
    const int r0 = k0 + warp * 16 + g;
    const long long ld = (long long)a.H * D;
    const long long o0 = ((long long)b * a.Lk + r0) * ld + h * D + h0, o1 = o0 + 8 * ld;
    float* dk = a.out0;
    float* dv = a.out1;
    if (parts > 1) {
      const long long n_el = (long long)gridDim.y * a.Lk * D;  // B*Lk*H*D
      dk = a.ws + part * n_el;
      dv = a.ws + (parts + part) * n_el;
    }
    const float sc = a.scale;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int col = n * 8 + 2 * t;
      *reinterpret_cast<float2*>(dk + o0 + col) = make_float2(c.dka[4 * n] * sc, c.dka[4 * n + 1] * sc);
      *reinterpret_cast<float2*>(dk + o1 + col) =
          make_float2(c.dka[4 * n + 2] * sc, c.dka[4 * n + 3] * sc);
      *reinterpret_cast<float2*>(dv + o0 + col) = make_float2(c.dva[4 * n], c.dva[4 * n + 1]);
      *reinterpret_cast<float2*>(dv + o1 + col) = make_float2(c.dva[4 * n + 2], c.dva[4 * n + 3]);
    }
  }
  // neither CTA of a cluster leaves while the other may still write to it
  if constexpr (T::CL > 1) cluster_sync();
}

// dq (B, Lq, H*D) fp32 into out0; with out1, the corrected log-sum-exp
// (B, H, Lq) that the dk/dv kernel then reads. Grid: (Lq/64 * CL, B*H); CTA
// rank as for dk/dv.
template <class T>
__global__ void __launch_bounds__(TF32_BWD_THREADS, 1)
flash_bwd_dq_tf32(const __grid_constant__ BwdMaps maps, const Tf32BwdArgs a) {
  constexpr int NS = T::STAGES, R = T::R, DH = T::DH, CW = T::CW, NC = T::NC, D = T::D;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = tf32_bwd_smem(smem_raw);
  const uint32_t fix = smem_u32(smem), ring = fix + T::RING_OFF, stats = fix + T::STATS_OFF;
  const uint32_t bar = fix + T::BAR_OFF, fix_bar = bar + 16 * NS;

  const int rank = blockIdx.x % T::CL, h0 = rank * DH;
  const int q0 = blockIdx.x / T::CL * T::ROWS;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int n_tiles = a.Lk / R;

  init_tf32_barriers<T>(bar);

  if (threadIdx.x >= 128) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == 128) {
      mbar_expect_tx(fix_bar, 4 * T::FIX_PART + 2 * T::ROWS * 4);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int p = 0; p < 4; ++p)
          tma_load_4d(fix + p * T::FIX_PART + c * T::FIX_CHUNK, &maps.m[p], fix_bar, h0 + c * CW,
                      h, q0, b);
      bulk_load(stats, a.lse + (long long)bh * a.Lq + q0, T::ROWS * 4, fix_bar);
      bulk_load(stats + T::ROWS * 4, a.di + (long long)bh * a.Lq + q0, T::ROWS * 4, fix_bar);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % NS, row = it * R;
        mbar_wait(bar + 8 * (NS + st), ((it / NS) & 1) ^ 1);
        const uint32_t full = bar + 8 * st, stage = ring + st * T::STAGE_BYTES;
        mbar_expect_tx(full, T::STAGE_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int p = 0; p < 4; ++p)
            tma_load_4d(stage + p * T::RING_PART + c * T::RING_CHUNK, &maps.m[4 + p], full,
                        h0 + c * CW, h, row, b);
#pragma unroll
        for (int p = 0; p < 2; ++p)
          tma_load_4d(stage + T::T_OFF + p * T::T_PART, &maps.m[8 + p], full, row, h0, h, b);
      }
    }
  } else {
    // ------------------------------------------------------------ consumer
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    DqTf32Consumer<T> c;
    c.fix = fix;
    c.ring = ring;
    c.bar = bar;
    c.lane = lane;
    c.scale_log2 = a.scale_log2;
    c.x = tf32_exchange<T>(smem, bar, rank, tid);
    c.r0 = c.r1 = 0.0;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) c.dqa[i] = c.fq[i] = 0.f;
    mbar_wait(fix_bar, 0);
    const int row = warp * 16 + g;
    const float* stats_f = reinterpret_cast<const float*>(smem + T::STATS_OFF);
    c.l0 = stats_f[row] * LOG2E;
    c.l1 = stats_f[row + 8] * LOG2E;
    c.d0 = stats_f[T::ROWS + row];
    c.d1 = stats_f[T::ROWS + row + 8];
    consume_tf32<T>(c, n_tiles);

    // the rows' sums of P over every key: r = exp(lse' - lse), lse' the
    // log-sum-exp of this kernel's own S. dQ is divided by r and lse' is
    // written for the dk/dv kernel, so that both normalise P to their own S
    // and not the forward's (whose rounding differs)
    double r0 = c.r0, r1 = c.r1;
    r0 += __shfl_xor_sync(0xffffffffu, r0, 1);
    r0 += __shfl_xor_sync(0xffffffffu, r0, 2);
    r1 += __shfl_xor_sync(0xffffffffu, r1, 1);
    r1 += __shfl_xor_sync(0xffffffffu, r1, 2);
    if (a.out1 != nullptr && rank == 0 && t == 0) {
      float* lo = a.out1 + (long long)bh * a.Lq + q0;
      lo[row] = (float)((double)stats_f[row] + log(r0));
      lo[row + 8] = (float)((double)stats_f[row + 8] + log(r1));
    }

    // rows q0 + row and q0 + row + 8; this CTA's columns
    const long long ld = (long long)a.H * D;
    float* o0 = a.out0 + ((long long)b * a.Lq + q0 + row) * ld + h * D + h0;
    float* o1 = o0 + 8 * ld;
    const float sc0 = (float)(a.scale / r0), sc1 = (float)(a.scale / r1);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int col = n * 8 + 2 * t;
      *reinterpret_cast<float2*>(o0 + col) =
          make_float2(c.dqa[4 * n] * sc0, c.dqa[4 * n + 1] * sc0);
      *reinterpret_cast<float2*>(o1 + col) =
          make_float2(c.dqa[4 * n + 2] * sc1, c.dqa[4 * n + 3] * sc1);
    }
  }
  if constexpr (T::CL > 1) cluster_sync();
}

}  // namespace
