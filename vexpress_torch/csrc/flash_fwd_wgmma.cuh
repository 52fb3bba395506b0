// The bf16 flash forward for Hopper (sm_90a): TMA loads into an mbarrier
// ring, wgmma, warp specialisation. One template serves four kernels: K1 and
// K2 (flash_fwd.cu), T1 (flash_variants.cu) and T2 (splash_fwd.cu); each of
// those sources states what it replaces and the bound, and launches its
// instantiations through `launch_fwd`.
//
// One block of NWG + 1 warpgroups per (BQ = 64 NWG query rows, HB (batch,
// head) pairs); WgmmaTile sets the tiling and how many blocks share an SM:
// * Warpgroup NWG is the producer. It gives up its registers (setmaxnreg.dec);
//   its first thread loads the Q tile of the block's first pair, then each
//   tile of BK keys of K and V, pair after pair, by TMA, into one ring of
//   STAGES stages in shared memory: the ring runs over HB * n_tiles tiles and
//   its parity counts on across pairs. Each stage has a `full` mbarrier,
//   completed by the TMA's byte count (complete_tx), and an `empty` one,
//   completed when each consumer warp has arrived. With HB > 1, Q has two
//   buffers: the next pair's Q lands while the consumers finish this one.
// * Warpgroups 0..NWG-1 are the consumers, 64 query rows each
//   (setmaxnreg.inc). Per key tile: S = Q K^T by wgmma with both operands
//   K-major in shared memory; the online softmax in fp32 registers; O += P V
//   by wgmma with P from registers and V as an MN-major B operand. The
//   accumulators of two neighbouring 8-key groups of S are, packed to bf16,
//   the A fragment of one 16-key k-step of P V, so P never touches shared
//   memory. The softmax of one tile runs while P V of the tile before does,
//   and S of the next tile follows P V on the tensor cores at once. O is
//   divided by the row sum once, at the end of a pair, and stored from
//   registers through O's (batch, head, row) strides; m, l and acc start
//   again for the next pair; rows past Lq (a trailing 64-row tile) are not
//   stored.
//
// Shared memory: each operand's tile is cut along the head dim into NC
// chunks of CW = SW / 2 columns, SW the swizzle span in bytes (32, 64 or
// 128). Chunk c is one TMA box of the tensor viewed in its memory order as a
// 4-D tensor: (D, H, L, B) for K1's packed (B, L, H*D) tensors (element
// strides 1, D, H*D, L*H*D) and for head-major views of them, (D, L, H, B)
// for (B, H, L, D) tensors (FwdArgs::order, per map; the box is (CW, 1, rows,
// 1) or (CW, rows, 1, 1)), so one (batch, head)'s tile is fetched by the
// hardware however far apart its rows lie. The box reads zeros past D (and
// past L); those zeros pad the head dim to NV, a multiple of the wgmma depth
// 16 (40 -> 48, or 64, 128 for T1's and T2's padded rows). Chunks wholly past
// D are not loaded: they are zeroed once, and no box overwrites them. The
// chunk lands as rows of SW bytes in the SW-byte swizzle that the wgmma
// descriptors name. Keys past Lk (a trailing 64-key tile at D=80) are masked.
//
// P modes: ROUND (K1, T1) rounds p to bf16 for P V; LITE (K2's probabilities,
// see flash_fwd.cu); SPLIT (T2) keeps p as the bf16 pair hi + lo, hi =
// bf16(p), lo = bf16(p - hi), and runs two RS products a k-step into the same
// accumulator.

#pragma once

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"  // mbarriers, TMA, wgmma

namespace {

using namespace vx;

enum class PMode { ROUND, LITE, SPLIT };

// the tiling and shared-memory layout of one instantiation, in bytes
template <int D_, int SW_, int BQ_, int BK_, int NV_, int HB_, int MINB_, int STAGES_>
struct WgmmaTile {
  static constexpr int D = D_, SW = SW_, BQ = BQ_, BK = BK_, NV = NV_, HB = HB_;
  static constexpr int MINB = MINB_;      // blocks an SM
  static constexpr int STAGES = STAGES_;  // K/V stages in the ring
  static constexpr int NWG = BQ / 64;     // consumer warpgroups
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int CW = SW / 2;              // bf16 columns per chunk
  static constexpr int NC = (NV + CW - 1) / CW;  // chunks per tile
  static constexpr int NL = (D + CW - 1) / CW;   // chunks that hold columns below D: loaded
  static constexpr int KS = NV / 16;             // k-steps of S = Q K^T
  static constexpr int QBUF = HB > 1 ? 2 : 1;    // Q buffers
  // registers a thread at launch, and the consumers' after setmaxnreg:
  // registers move only inside a block, from the producer warpgroup (down to
  // 24) to the consumer warpgroups
  static constexpr int REGS = 65536 / (THREADS * MINB) / 8 * 8;
  static constexpr int GROWN = REGS + (REGS - 24) / NWG / 8 * 8;
  static constexpr int CONSUMER_REGS = GROWN > 240 ? 240 : GROWN;
  static constexpr uint32_t Q_CHUNK = BQ * SW;
  static constexpr uint32_t KV_CHUNK = BK * SW;
  static constexpr uint32_t Q_BYTES = NC * Q_CHUNK;    // one Q buffer
  static constexpr uint32_t KV_BYTES = NC * KV_CHUNK;  // one of K or V, one stage
  static constexpr uint32_t BAR_OFF = QBUF * Q_BYTES + 2 * STAGES * KV_BYTES;
  // + the barriers, + slack to align the base to 1024 bytes (the 128-byte swizzle's period)
  static constexpr uint32_t SMEM = BAR_OFF + 8 * (2 * STAGES + QBUF) + 1024;
  static_assert(SW == 32 || SW == 64 || SW == 128, "swizzle span");
  static_assert(BQ == 64 || BQ == 128, "one or two consumer warpgroups");
  static_assert(BK == 64 || BK == 128, "key tiles of 64 or 128");
  static_assert(NV % 16 == 0 && NV >= D && D % 8 == 0, "whole wgmma k-steps over D");
  static_assert(HB >= 1 && STAGES >= 2, "pairs and stages");
  static_assert(REGS <= 255 && 128 * 24 + NWG * 128 * CONSUMER_REGS <= THREADS * REGS,
                "the consumers' registers come from the producer's");
  static_assert(SMEM * MINB <= 232448, "shared memory of the blocks on one SM");
};

// K1's and K2's tiling at head dim D: 128 query rows; keys per stage and
// blocks per SM: at D=40 two blocks of 64-key tiles, so that one block's
// waits and loads overlap the other's softmax; at D=80 one block of 128-key
// tiles (two blocks' registers would serialise its wgmma); at D=160 64-key
// tiles, for O's 80 accumulators (measured, PERF.md); 3 stages
template <int D, int SW>
using K1Tile =
    WgmmaTile<D, SW, 128, D == 80 ? 128 : 64, (D + 15) / 16 * 16, 1, D == 40 ? 2 : 1, 3>;

// what a launch passes beside the maps
struct FwdArgs {
  int H, Lq, Lk;
  int order;    // bit 0: q's map is (D, L, H, B); bit 1: k's and v's; else (D, H, L, B)
  float scale;  // see fwd_wgmma
  long long o_b, o_h, o_l;  // element strides of o: batch, head, row
};

// 2^x of a bf16 pair, each result rounded to bf16
__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
}

// log2(e) as the bf16 pair sum LOG2E_HI + LOG2E_LO, each packed twice
constexpr uint32_t LOG2E_HI2 = 0x3FB93FB9u;  // 1.4453125
constexpr uint32_t LOG2E_LO2 = 0xBB2CBB2Cu;  // -0.00262451171875
constexpr uint32_t NEG_ZERO2 = 0x80008000u;

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// K2's probabilities of the pair (s0, s1) of a row with running max m
// (natural-log units): y = bf16(s - m); x = bf16(y log2(e)), formed on the
// packed pair as bf16(y LOG2E_HI + bf16(y LOG2E_LO)) by two bf16x2 FMAs; then
// 2^x on the pair (one ex2 for two exps). Adds the fp32 sum of the two bf16
// results to `sum`.
__device__ __forceinline__ uint32_t lite_p(float s0, float s1, float m, float& sum) {
  const uint32_t y = pack_bf16(s0 - m, s1 - m);
  const uint32_t x = fma_bf16x2(y, LOG2E_HI2, fma_bf16x2(y, LOG2E_LO2, NEG_ZERO2));
  const uint32_t p = ex2_bf16x2(x);
  const float2 pf = unpack_bf16(p);
  sum += pf.x + pf.y;
  return p;
}

// (lo, hi) rounded to bf16 (`hi_bits`) and what that rounding left, rounded
// to bf16 (`lo_bits`): hi + lo holds each value to about 16 significant bits
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& hi_bits,
                                           uint32_t& lo_bits) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  const float2 rf = __bfloat1622float2(r);
  hi_bits = *reinterpret_cast<const uint32_t*>(&r);
  lo_bits = pack_bf16(lo - rf.x, hi - rf.y);
}

// box (column `col`, rows from `row` of pair (b, h)) of a map in (D, H, L, B)
// order, or in (D, L, H, B) order with `lh`
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int col, int h, int row, int b, bool lh) {
  tma_load_4d(dst, map, bar, col, lh ? row : h, lh ? h : row, b);
}

// One consumer warpgroup's state over the key loop: 64 query rows, each
// warp's 16 rows g and g+8 in the accumulator layout. Tiles are numbered
// across the block's pairs (the ring's order); a stage goes back to the
// producer once its P V has completed. Each path through a step waits on a
// fixed count of running wgmma groups, so that ptxas keeps them asynchronous.
template <class T, PMode P>
struct WgConsumer {
  static constexpr int BK = T::BK, NS = T::STAGES, NV = T::NV, NKK = BK / 16;
  static constexpr int NP = P == PMode::SPLIT ? 2 : 1;  // A fragments of P a k-step

  uint32_t q_wg, k_s, bar;  // this warpgroup's Q rows, the first stage, the barriers
  int t, lane, Lk;
  int g0;  // the ring index of this pair's first tile
  float scale;
  // running max of rows g and g+8: raw logits (K1, T1, T2), natural-log units
  // of the pre-scaled q's logits (K2); this thread's share of the running sums
  float m0, m1, l0, l1;
  float acc[NV / 2];
  uint32_t pa[NP * NKK][4];  // A fragments of P, one per 16-key k-step (SPLIT: hi, then lo)
  uint32_t zero;             // 0, known only at run time (see take_p)

  // S of tile g into s, once its stage has landed (not waited for)
  __device__ __forceinline__ void issue_s(float (&s)[BK / 2], int g) {
    const int st = g % NS;
    mbar_wait(bar + 8 * st, (g / NS) & 1);
    const uint32_t kt = k_s + 2 * st * T::KV_BYTES;
    uint64_t qd[T::KS], kd_[T::KS];
#pragma unroll
    for (int kd = 0; kd < T::KS; ++kd) {
      const uint32_t c = kd * 16 / T::CW, off = (kd * 16 % T::CW) * 2;
      qd[kd] = wgmma_desc<T::SW>(q_wg + c * T::Q_CHUNK + off, 16, 8 * T::SW);
      kd_[kd] = wgmma_desc<T::SW>(kt + c * T::KV_CHUNK + off, 16, 8 * T::SW);
    }
    // every register the products read is defined before the warpgroup arrives
    wgmma_fence_operands(qd);
    wgmma_fence_operands(kd_);
    wgmma_fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < T::KS; ++kd) wgmma_ss<BK>(s, qd[kd], kd_[kd], kd);
    wgmma_commit();
  }

  // the online softmax of tile g (S complete in s): p in place of s, fp32
  // (ROUND, SPLIT) or packed bf16 pairs in s[8kk..8kk+3] (LITE); the running
  // max and sum move on, and (a0, a1) is what acc must be scaled by
  __device__ __forceinline__ void softmax(float (&s)[BK / 2], int g, float& a0, float& a1) {
    const int it = g - g0;
    if ((it + 1) * BK > Lk) {  // a trailing 64-key tile: keys past Lk do not count
      // (finite: K2's y LOG2E_LO + ... would make -inf + inf of an infinite logit)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        if (it * BK + 8 * j + 2 * t >= Lk)
          s[4 * j] = s[4 * j + 1] = s[4 * j + 2] = s[4 * j + 3] = -1e30f;
      }
    }
    // rows g (s[4j], s[4j+1]) and g+8 (s[4j+2], s[4j+3]); a row's BK values
    // are spread over the 4 lanes of a quad
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float rs0 = 0.f, rs1 = 0.f;
    if constexpr (P == PMode::LITE) {
      a0 = __expf(m0 - mx0);  // 0 on the first tile
      a1 = __expf(m1 - mx1);
#pragma unroll
      for (int kk = 0; kk < NKK; ++kk) {
        float* sk = s + 8 * kk;  // 8-key groups 2kk and 2kk+1
        const uint32_t p0 = lite_p(sk[0], sk[1], mx0, rs0), p1 = lite_p(sk[2], sk[3], mx1, rs1);
        const uint32_t p2 = lite_p(sk[4], sk[5], mx0, rs0), p3 = lite_p(sk[6], sk[7], mx1, rs1);
        sk[0] = __uint_as_float(p0);
        sk[1] = __uint_as_float(p1);
        sk[2] = __uint_as_float(p2);
        sk[3] = __uint_as_float(p3);
      }
    } else {
      const float ms0 = mx0 * scale, ms1 = mx1 * scale;  // log2 units
      a0 = ex2_approx(m0 * scale - ms0);  // 0 on the first tile
      a1 = ex2_approx(m1 * scale - ms1);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        s[e] = ex2_approx(fmaf(s[e], scale, (e & 2) ? -ms1 : -ms0));
        if (e & 2)
          rs1 += s[e];
        else
          rs0 += s[e];
      }
    }
    m0 = mx0;
    m1 = mx1;
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
  }

  // after the previous tile's P V has completed: its stage goes back to the
  // producer, acc is scaled by (a0, a1), and P of tile g fills pa
  __device__ __forceinline__ void take_p(const float (&s)[BK / 2], int g, float a0, float a1) {
    wgmma_fence_operands(acc);
    wgmma_fence_operands(pa);
    __syncwarp();
    if (lane == 0 && g > 0) mbar_arrive(bar + 8 * (NS + (g - 1) % NS));
#pragma unroll
    for (int n = 0; n < NV / 8; ++n) {
      acc[4 * n] *= a0;
      acc[4 * n + 1] *= a0;
      acc[4 * n + 2] *= a1;
      acc[4 * n + 3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk) {
      const float* sk = s + 8 * kk;
      if constexpr (P == PMode::LITE) {
        // P V must not read its A fragments straight from the registers the
        // packed ex2 wrote: so read, a relaunch now and then differed in one
        // warp's rows (PERF.md §6). OR-ing a zero that only the run
        // time knows makes each fragment an ALU result, as K1's packing does.
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kk][i] = __float_as_uint(sk[i]) | zero;
      } else if constexpr (P == PMode::SPLIT) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_bf16(sk[2 * i], sk[2 * i + 1], pa[kk][i], pa[NKK + kk][i]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sk[2 * i], sk[2 * i + 1]);
      }
    }
  }

  // O += P V of tile g; V's 16-key k-step kk starts 16 rows of SW bytes in,
  // its chunks (MN atoms of CW columns) KV_CHUNK apart
  __device__ __forceinline__ void issue_pv(int g) {
    const uint32_t vt = k_s + (2 * (g % NS) + 1) * T::KV_BYTES;
    uint64_t vd[NKK];
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk)
      vd[kk] = wgmma_desc<T::SW>(vt + kk * 16 * T::SW, T::KV_CHUNK, 8 * T::SW);
    wgmma_fence_operands(vd);
    wgmma_fence_operands(acc);
    wgmma_fence_operands(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk) {
      wgmma_rs<NV>(acc, pa[kk], vd[kk]);
      if constexpr (P == PMode::SPLIT) wgmma_rs<NV>(acc, pa[NKK + kk], vd[kk]);
    }
    wgmma_commit();
  }

  // Tile g, whose S is complete in s: its softmax runs while P V of the tile
  // before runs; then, with MORE (a tile of this pair follows), S of the next
  // tile and P V of this one run back to back.
  template <bool MORE>
  __device__ __forceinline__ void step(float (&s)[BK / 2], int g) {
    float a0, a1;
    softmax(s, g, a0, a1);
    wgmma_wait<0>();
    take_p(s, g, a0, a1);
    if constexpr (MORE) issue_s(s, g + 1);
    issue_pv(g);
    if constexpr (MORE) {  // S of the next tile (the older group) has completed
      wgmma_wait<1>();
      wgmma_fence_operands(s);
    }
  }
};

// The block's work, for a __global__ kernel of the tiling T (each source
// names its own, so that the SASS of each family can be read apart).
// `a.scale`: K1 and T1 pass the softmax scale times log2(e), applied to the
// logits in the exponent; T2 log2(e) alone (its q arrives scaled); K2 (LITE)
// the scale rounded to bf16, applied to Q in shared memory before the first
// product. `lse`: null, or (B, H, Lq) fp32 for K1's natural-log log-sum-exp.
template <class T, PMode P>
__device__ __forceinline__ void fwd_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                                          const CUtensorMap& tv, __nv_bfloat16* __restrict__ o,
                                          float* __restrict__ lse, const FwdArgs a) {
  constexpr int CW = T::CW, NV = T::NV, NC = T::NC, NL = T::NL, BK = T::BK, NS = T::STAGES;
  constexpr int NWG = T::NWG, HB = T::HB, QBUF = T::QBUF, SW = T::SW;
  constexpr bool LITE = P == PMode::LITE;
  static_assert(!LITE || HB == 1, "K2 scales its one Q tile in place");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t q_s = smem_u32(smem);  // Q buffer qb at q_s + qb Q_BYTES
  const uint32_t k_s = q_s + QBUF * T::Q_BYTES;  // stage st: K at k_s + 2 st KV_BYTES, V after it
  const uint32_t bar = q_s + T::BAR_OFF;  // full[NS], empty[NS], q[QBUF]
  const uint32_t q_bar = bar + 16 * NS;

  const int q0 = blockIdx.x * T::BQ;
  const int n_tiles = (a.Lk + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar + 8 * s, 1);                // full: the producer's expect_tx
      mbar_init(bar + 8 * (NS + s), 4 * NWG);  // empty: one arrive per consumer warp
    }
    for (int qb = 0; qb < QBUF; ++qb) mbar_init(q_bar + 8 * qb, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (NL < NC) {
    // chunks wholly past D, in every Q buffer and stage: zeros that no box
    // overwrites, written before the first product reads them (async proxy)
    constexpr uint32_t Q_PAD = (NC - NL) * T::Q_CHUNK / 16, KV_PAD = (NC - NL) * T::KV_CHUNK / 16;
    for (uint32_t i = threadIdx.x; i < QBUF * Q_PAD + 2 * NS * KV_PAD; i += T::THREADS) {
      const uint32_t off = i < QBUF * Q_PAD
          ? (i / Q_PAD) * T::Q_BYTES + NL * T::Q_CHUNK + 16 * (i % Q_PAD)
          : QBUF * T::Q_BYTES + ((i - QBUF * Q_PAD) / KV_PAD) * T::KV_BYTES + NL * T::KV_CHUNK +
                16 * ((i - QBUF * Q_PAD) % KV_PAD);
      *reinterpret_cast<uint4*>(smem + off) = make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == NWG * 128) {
      const bool q_lh = a.order & 1, kv_lh = a.order & 2;
      const auto load_q = [&](int pair) {
        const int bh = blockIdx.y * HB + pair, qb = pair % QBUF;
        mbar_expect_tx(q_bar + 8 * qb, NL * T::Q_CHUNK);
#pragma unroll
        for (int c = 0; c < NL; ++c)
          tma_load_rows(q_s + qb * T::Q_BYTES + c * T::Q_CHUNK, &tq, q_bar + 8 * qb, c * CW,
                      bh % a.H, q0, bh / a.H, q_lh);
      };
      load_q(0);
#pragma unroll 1
      for (int pair = 0; pair < HB; ++pair) {
        const int bh = blockIdx.y * HB + pair, b = bh / a.H, h = bh % a.H;
        for (int it = 0; it < n_tiles; ++it) {
          const int g = pair * n_tiles + it, st = g % NS;
          mbar_wait(bar + 8 * (NS + st), ((g / NS) & 1) ^ 1);
          const uint32_t full = bar + 8 * st, kd = k_s + 2 * st * T::KV_BYTES;
          mbar_expect_tx(full, 2 * NL * T::KV_CHUNK);
#pragma unroll
          for (int c = 0; c < NL; ++c) {
            tma_load_rows(kd + c * T::KV_CHUNK, &tk, full, c * CW, h, it * BK, b, kv_lh);
            tma_load_rows(kd + T::KV_BYTES + c * T::KV_CHUNK, &tv, full, c * CW, h, it * BK, b,
                          kv_lh);
          }
          if constexpr (HB > 1) {
            // the next pair's Q, into the buffer of the pair before this one,
            // once that pair's last tile is released: at this pair's tile NS-1
            // the wait above was for it
            if (pair + 1 < HB && it == min(NS, n_tiles) - 1) {
              if (pair > 0 && n_tiles < NS) {
                const int last = pair * n_tiles - 1;
                mbar_wait(bar + 8 * (NS + last % NS), (last / NS) & 1);
              }
              load_q(pair + 1);
            }
          }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS));
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    WgConsumer<T, P> c;
    c.k_s = k_s;
    c.bar = bar;
    c.t = t;
    c.lane = lane;
    c.Lk = a.Lk;
    c.scale = a.scale;
    c.zero = blockIdx.z;  // the grid is 2-D
#pragma unroll 1
    for (int pair = 0; pair < HB; ++pair) {
      const int qb = pair % QBUF;
      c.q_wg = q_s + qb * T::Q_BYTES + wg * 64 * SW;  // this warpgroup's 64 rows of each chunk
      c.g0 = pair * n_tiles;
      c.m0 = c.m1 = -INFINITY;
      c.l0 = c.l1 = 0.f;
#pragma unroll
      for (int i = 0; i < NV / 2; ++i) c.acc[i] = 0.f;

      mbar_wait(q_bar + 8 * qb, (pair / QBUF) & 1);
      if constexpr (LITE) {
        // q * bf16(scale), rounded to bf16, in place (the zero padding stays zero)
#pragma unroll 1
        for (int ch = 0; ch < NC; ++ch) {
          uint4* p = reinterpret_cast<uint4*>(smem + ch * T::Q_CHUNK + wg * 64 * SW);
          for (int i = tid; i < 64 * SW / 16; i += 128) {
            uint4 x = p[i];
            x.x = scale_bf16x2(x.x, a.scale);
            x.y = scale_bf16x2(x.y, a.scale);
            x.z = scale_bf16x2(x.z, a.scale);
            x.w = scale_bf16x2(x.w, a.scale);
            p[i] = x;
          }
        }
        // generic-proxy writes, read next by wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      }

      float sa[BK / 2];
      c.issue_s(sa, c.g0);
      wgmma_wait<0>();
      wgmma_fence_operands(sa);
      for (int it = 0; it + 1 < n_tiles; ++it) c.template step<true>(sa, c.g0 + it);
      c.template step<false>(sa, c.g0 + n_tiles - 1);
      wgmma_wait<0>();
      wgmma_fence_operands(c.acc);

      float l0 = c.l0, l1 = c.l1;
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
      const int bh = blockIdx.y * HB + pair, b = bh / a.H, h = bh % a.H;
      if constexpr (!LITE) {
        if (lse != nullptr && t == 0) {  // natural-log LSE of the scaled logits
          float* lp = lse + (long long)bh * a.Lq;
          if (r0 < a.Lq) lp[r0] = (c.m0 * a.scale + log2f(l0)) * LN2;
          if (r1 < a.Lq) lp[r1] = (c.m1 * a.scale + log2f(l1)) * LN2;
        }
      }
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      __nv_bfloat16* o0 = o + b * a.o_b + h * a.o_h + r0 * a.o_l;
      __nv_bfloat16* o1 = o0 + 8 * a.o_l;
#pragma unroll
      for (int n = 0; n < NV / 8; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < T::D) {
          if (r0 < a.Lq)
            *reinterpret_cast<uint32_t*>(o0 + col) =
                pack_bf16(c.acc[4 * n] * inv0, c.acc[4 * n + 1] * inv0);
          if (r1 < a.Lq)
            *reinterpret_cast<uint32_t*>(o1 + col) =
                pack_bf16(c.acc[4 * n + 2] * inv1, c.acc[4 * n + 3] * inv1);
        }
      }
    }
  }
}

// K1's and K2's kernel
template <class T, PMode P>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, const FwdArgs a) {
  fwd_wgmma<T, P>(tq, tk, tv, o, lse, a);
}

// One launch of `kernel` (an instantiation at the tiling T) on stream `s`:
// the maps encoded from `geom` (ops/flash_tma.py's geometry_arg and
// variant_geometry_arg: swizzle bytes, box columns, box rows of q and of k/v,
// grid x and y, dynamic shared memory bytes, then q's dims and byte strides,
// then k's, v's being k's; the dims in the order that `a.order` names), the
// kernel's dynamic shared memory set once per device (`smem_set`, one for
// each instantiation). Returns cudaGetLastError(), or a failed encode's code.
template <class T, class Kernel>
int launch_fwd(Kernel kernel, std::atomic<unsigned long long>& smem_set, const void* q,
               const void* k, const void* v, void* o, float* lse, const long long* geom,
               const FwdArgs& a, cudaStream_t s) {
  if (geom[0] != T::SW || geom[1] != T::CW || geom[2] != T::BQ || geom[3] != T::BK ||
      geom[6] != T::SMEM || geom[4] != (a.Lq + T::BQ - 1) / T::BQ || geom[5] <= 0 ||
      geom[5] > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const int q_row = a.order & 1 ? 1 : 2, kv_row = a.order & 2 ? 1 : 2;
  int rc = encode(&tq, q, geom + 7, geom + 11, T::CW, T::BQ, T::SW, q_row);
  if (rc == 0) rc = encode(&tk, k, geom + 14, geom + 18, T::CW, T::BK, T::SW, kv_row);
  if (rc == 0) rc = encode(&tv, v, geom + 14, geom + 18, T::CW, T::BK, T::SW, kv_row);
  if (rc != 0) return rc;
  rc = set_smem_once(kernel, T::SMEM, smem_set);
  if (rc != 0) return rc;
  kernel<<<dim3((unsigned)geom[4], (unsigned)geom[5]), T::THREADS, T::SMEM, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, a);
  return (int)cudaGetLastError();
}

}  // namespace
