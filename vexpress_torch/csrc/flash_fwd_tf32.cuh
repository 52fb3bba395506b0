// The fp32 flash forward for Hopper (sm_90a): K1's and K2's fp32 variants
// (flash_fwd.cu launches them and states what they replace) on the TF32
// tensor cores, at fp32's accuracy by the "3xTF32" split. TMA loads into an
// mbarrier ring, wgmma in .tf32 with fp32 accumulators, warp specialisation:
// the bf16 template's shape (flash_fwd_wgmma.cuh) with tf32 operands.
//
// The split. Each fp32 operand x is hi = tf32(x), lo = tf32(x - hi) (tf32:
// rounded to nearest, ties away, to 10 mantissa bits; the low 13 bits zero),
// so hi + lo holds x to about 2^-22 of itself, and a product is taken as
// hi hi + hi lo + lo hi into one fp32 accumulator (lo lo, about 2^-22 of the
// product, is left out). S = Q K^T is three SS products a k-step; P V with
// K1's fp32 p three RS products (p split in registers); with K2's p, which is
// bf16-valued and so exact in tf32, two: P V_hi + P V_lo.
//
// The split pass (tf32_split.cuh: tf32_split, tf32_split_vt), three launches
// before the kernel on the same stream, writes the parts once into a scratch
// buffer the wrapper allocates: q's and k's in their own (B, L, H*D) layout,
// v's transposed to (B, H, D, Lk), because wgmma takes a tf32 B operand
// K-major only, and P V's B is V^T (keys contiguous). Within each group of 8
// keys V^T's columns are permuted (column 8j + i holds key 8j + PERM[i],
// PERM = 0 2 4 6 1 3 5 7): the S accumulator gives a thread keys 2t and 2t+1
// of each 8-key group, and the tf32 A fragment wants k-indices t and t+4, so
// the thread's two probabilities go to k-indices t and t+4 as they are and V^T
// holds the keys in that order. No shuffle of p.
//
// One block of NWG + 1 warpgroups per (BQ = 64 NWG query rows, batch, head):
// * Warpgroup NWG is the producer: it loads Q's two parts once, then per tile
//   of BK keys K's two parts and V^T's two parts by TMA into a ring of
//   STAGES stages (`full` and `empty` mbarriers, as the bf16 template's).
// * Warpgroups 0..NWG-1 are the consumers, 64 query rows each. Per key tile:
//   S by 3 KS SS wgmma (KS = D / 8 k-steps); the online softmax in fp32
//   registers; p split and the tile's P V by RS wgmma with P from registers.
//   The softmax of one tile runs while P V of the tile before does, and S of
//   the next tile follows P V on the tensor cores at once. O is divided by
//   the row sum at the end and stored in fp32; rows past Lq are not stored.
//
// The tensor cores' fp32 accumulation rounds toward zero, so a sum carried
// through thousands of wgmma loses about half an ulp a step, all of the same
// sign: O summed over Lk = 4096 keys in 1,536 products missed the fp32 mean
// bar by 2.3x on the H100. So each tile's P V starts afresh (scale_d 0), and
// O takes it on the CUDA cores, O = (O + PV) alpha, rounded to nearest: the
// truncated chain is one tile long (24 products at D=40). Within a chain the
// small cross products (hi lo, lo hi) go first and hi hi last: a wgmma's
// products are aligned to the larger of them and the accumulator and cut
// below its last bit, so the small terms lose less while the sum is small
// (hi hi first, K1's output at attn1 @64², batch 20, missed the fp32
// gradient bar's max, 1e-4 std(ref), by 1.7x on the H100).
//
// Shared memory: Q's and K's parts are cut along the head dim into chunks of
// CW = SW / 4 columns (SW the swizzle span in bytes); the TMA box reads zeros
// past D, and no k-step reads past D (D = 40, 80, 160 are whole 8-deep
// k-steps). V^T's parts are cut along the keys into chunks of CWV = SWV / 4
// keys, D rows each. Lk is a multiple of 64 and BK divides 64, so no key tile
// is partial.

#pragma once

#include <math.h>

#include "flash_common.cuh"
#include "flash_fwd_wgmma.cuh"  // FwdArgs
#include "hopper.cuh"
#include "tf32_split.cuh"  // perm_key

namespace {

using namespace vx;

// the tiling and shared-memory layout of one fp32 instantiation, in bytes
template <int D_, int SW_, int BQ_, int BK_, int STAGES_>
struct Tf32Tile {
  static constexpr int D = D_, SW = SW_, BQ = BQ_, BK = BK_, STAGES = STAGES_;
  static constexpr int MINB = 1;       // blocks an SM
  static constexpr int NWG = BQ / 64;  // consumer warpgroups
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int CW = SW / 4;               // fp32 columns of Q and K per chunk
  static constexpr int NC = (D + CW - 1) / CW;    // chunks of a Q or K part
  static constexpr int SWV = BK * 4 < 128 ? BK * 4 : 128;  // V^T's rows are BK keys
  static constexpr int CWV = SWV / 4;             // keys per chunk of V^T
  static constexpr int NCV = BK / CWV;            // chunks of a V^T part
  static constexpr int KS = D / 8;                // k-steps of S = Q K^T
  static constexpr int NKK = BK / 8;              // k-steps of P V
  // with two consumer warpgroups the producer's registers move to them
  // (setmaxnreg); with one, ptxas gives every thread what the consumer needs
  static constexpr bool MOVE_REGS = NWG > 1;
  static constexpr int REGS = 65536 / THREADS / 8 * 8;
  static constexpr int GROWN = REGS + (REGS - 24) / NWG / 8 * 8;
  static constexpr int CONSUMER_REGS = GROWN > 240 ? 240 : GROWN;
  static constexpr uint32_t Q_CHUNK = BQ * SW;
  static constexpr uint32_t Q_PART = NC * Q_CHUNK;  // hi, then lo
  static constexpr uint32_t K_CHUNK = BK * SW;
  static constexpr uint32_t K_PART = NC * K_CHUNK;
  static constexpr uint32_t V_CHUNK = D * SWV;
  static constexpr uint32_t V_PART = NCV * V_CHUNK;
  // a stage: K hi, K lo, V^T hi, V^T lo
  static constexpr uint32_t STAGE_BYTES = 2 * K_PART + 2 * V_PART;
  static constexpr uint32_t BAR_OFF = 2 * Q_PART + STAGES * STAGE_BYTES;
  // + the barriers (full[STAGES], empty[STAGES], q), + slack to align the base
  static constexpr uint32_t SMEM = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
  static_assert(SW == 32 || SW == 64 || SW == 128, "swizzle span");
  static_assert(SWV == 64 || SWV == 128, "V^T's swizzle span");
  static_assert(BQ == 64 || BQ == 128, "one or two consumer warpgroups");
  static_assert(BK == 16 || BK == 32 || BK == 64, "key tiles that divide 64");
  static_assert(D % 8 == 0 && BK % CWV == 0, "whole k-steps");
  static_assert(!MOVE_REGS || 128 * 24 + NWG * 128 * CONSUMER_REGS <= THREADS * REGS,
                "the consumers' registers come from the producer's");
  static_assert(SMEM * MINB <= 232448, "shared memory of the blocks on one SM");
};

// K1's and K2's fp32 tiling at head dim D (csrc/flash_fwd.cu's VX_F32 names
// the swizzle and tiles; ops/flash_tma.py's F32_TILES is the same table):
// 128 query rows but at D=160, whose Q parts alone would take 160 KiB; keys a
// stage as fit 3 stages beside Q
template <int D, int SW, int BQ, int BK>
using K1Tf32Tile = Tf32Tile<D, SW, BQ, BK, 3>;

// One consumer warpgroup's state over the key loop (the bf16 WgConsumer's,
// with tf32 products): 64 query rows, each warp's rows g and g+8.
template <class T, bool LITE>
struct Tf32Consumer {
  static constexpr int BK = T::BK, NS = T::STAGES, D = T::D, NKK = T::NKK, KS = T::KS;

  uint32_t q_wg, k_s, bar;  // this warpgroup's Q rows (hi part), the first stage, the barriers
  int lane;
  float scale;
  // running max of rows g and g+8: raw logits (K1), natural-log units of the
  // pre-scaled q's logits (K2); this thread's share of the running sums
  float m0, m1, l0, l1;
  float acc[D / 2];                  // O so far, summed on the CUDA cores
  float pv[D / 2];                   // P V of the latest tile, on the tensor cores
  uint32_t ph[NKK][4];               // A fragments of P: hi (K2: p itself)
  uint32_t pl[LITE ? 1 : NKK][4];    // and lo (K1)
  uint32_t zero;                     // 0, known only at run time (see take_p)

  // S of tile g into s, once its stage has landed (not waited for)
  __device__ __forceinline__ void issue_s(float (&s)[BK / 2], int g) {
    const int st = g % NS;
    mbar_wait(bar + 8 * st, (g / NS) & 1);
    const uint32_t kt = k_s + st * T::STAGE_BYTES;
    const uint64_t qh = wgmma_desc<T::SW>(q_wg, 16, 8 * T::SW);
    const uint64_t ql = wgmma_desc<T::SW>(q_wg + T::Q_PART, 16, 8 * T::SW);
    const uint64_t kh = wgmma_desc<T::SW>(kt, 16, 8 * T::SW);
    const uint64_t kl = wgmma_desc<T::SW>(kt + T::K_PART, 16, 8 * T::SW);
    wgmma_fence_operands(s);
    wgmma_fence();
    // the small cross products first, hi hi last: each wgmma's sum is
    // truncated relative to the accumulator it adds to
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int kd = 0; kd < KS; ++kd) {
        // k-step kd: chunk kd*8 / CW, 32 bytes a step within it (descriptor
        // addresses count 16 bytes)
        constexpr int CW = T::CW;
        const uint64_t qo = (kd * 8 / CW) * (T::Q_CHUNK / 16) + (kd * 8 % CW) / 4;
        const uint64_t ko = (kd * 8 / CW) * (T::K_CHUNK / 16) + (kd * 8 % CW) / 4;
        wgmma_ss_tf32<BK>(s, (i == 1 ? ql : qh) + qo, (i == 0 ? kl : kh) + ko, i + kd);
      }
    }
    wgmma_commit();
  }

  // the online softmax of a tile (S complete in s): p in place of s, fp32
  // (K2: bf16-valued); the running max and sum move on, and (a0, a1) is what
  // acc must be scaled by
  __device__ __forceinline__ void softmax(float (&s)[BK / 2], float& a0, float& a1) {
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
    if constexpr (LITE) {
      a0 = __expf(m0 - mx0);  // 0 on the first tile
      a1 = __expf(m1 - mx1);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        s[e] = exp_bf16(s[e] - ((e & 2) ? mx1 : mx0));
        if (e & 2)
          rs1 += s[e];
        else
          rs0 += s[e];
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
  // producer, acc takes pv and is scaled by (a0, a1), and P of tile g fills
  // ph (and pl)
  __device__ __forceinline__ void take_p(const float (&s)[BK / 2], int g, float a0, float a1) {
    wgmma_fence_operands(pv);
    wgmma_fence_operands(ph);
    if constexpr (!LITE) wgmma_fence_operands(pl);
    __syncwarp();
    if (lane == 0 && g > 0) mbar_arrive(bar + 8 * (NS + (g - 1) % NS));
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n] = (acc[4 * n] + pv[4 * n]) * a0;
      acc[4 * n + 1] = (acc[4 * n + 1] + pv[4 * n + 1]) * a0;
      acc[4 * n + 2] = (acc[4 * n + 2] + pv[4 * n + 2]) * a1;
      acc[4 * n + 3] = (acc[4 * n + 3] + pv[4 * n + 3]) * a1;
    }
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk) {
      // 8-key group kk: (row g, key 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) in
      // s; the fragment's (g, t), (g+8, t), (g, t+4), (g+8, t+4)
      const float f[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1], s[4 * kk + 3]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (LITE) {
          // as the bf16 K2's: each fragment an ALU result (flash_fwd_wgmma.cuh)
          ph[kk][i] = __float_as_uint(f[i]) | zero;
        } else {
          const uint32_t hi = tf32_rna(f[i]);
          ph[kk][i] = hi;
          pl[kk][i] = tf32_rna(f[i] - __uint_as_float(hi));
        }
      }
    }
  }

  // pv = P V of tile g: V^T's k-step kk is in chunk kk*8 / CWV, 32 bytes a
  // step within it
  __device__ __forceinline__ void issue_pv(int g) {
    const uint32_t vt = k_s + (g % NS) * T::STAGE_BYTES + 2 * T::K_PART;
    const uint64_t vh = wgmma_desc<T::SWV>(vt, 16, 8 * T::SWV);
    const uint64_t vl = wgmma_desc<T::SWV>(vt + T::V_PART, 16, 8 * T::SWV);
    wgmma_fence_operands(pv);
    wgmma_fence_operands(ph);
    if constexpr (!LITE) wgmma_fence_operands(pl);
    wgmma_fence();
    // the cross products first, hi hi last, as in issue_s
    constexpr int CWV = T::CWV;
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk)
      wgmma_rs_tf32<D>(pv, ph[kk], vl + (kk * 8 / CWV) * (T::V_CHUNK / 16) + (kk * 8 % CWV) / 4,
                       kk);
    if constexpr (!LITE) {
#pragma unroll
      for (int kk = 0; kk < NKK; ++kk)
        wgmma_rs_tf32<D>(pv, pl[kk], vh + (kk * 8 / CWV) * (T::V_CHUNK / 16) + (kk * 8 % CWV) / 4,
                         1);
    }
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk)
      wgmma_rs_tf32<D>(pv, ph[kk], vh + (kk * 8 / CWV) * (T::V_CHUNK / 16) + (kk * 8 % CWV) / 4, 1);
    wgmma_commit();
  }

  // Tile g, whose S is complete in s: its softmax runs while P V of the tile
  // before runs; then, with MORE (a tile follows), S of the next tile and
  // P V of this one run back to back.
  template <bool MORE>
  __device__ __forceinline__ void step(float (&s)[BK / 2], int g) {
    float a0, a1;
    softmax(s, a0, a1);
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

// K1's (LITE false) and K2's (LITE true) fp32 kernel. The maps: Q's, K's
// parts (D, H, L, B), V^T's (Lk, D, H, B), each hi then lo. `a.scale`: K1 the
// softmax scale times log2(e), applied to the logits in the exponent; K2 the
// scale, already applied to q by the split pass (a.scale unused). `lse`:
// null, or (B, H, Lq) fp32 for K1's natural-log log-sum-exp.
template <class T, bool LITE>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
flash_fwd_tf32(const __grid_constant__ CUtensorMap tqh, const __grid_constant__ CUtensorMap tql,
               const __grid_constant__ CUtensorMap tkh, const __grid_constant__ CUtensorMap tkl,
               const __grid_constant__ CUtensorMap tvh, const __grid_constant__ CUtensorMap tvl,
               float* __restrict__ o, float* __restrict__ lse, const FwdArgs a) {
  constexpr int CW = T::CW, CWV = T::CWV, NC = T::NC, NCV = T::NCV, BK = T::BK;
  constexpr int NS = T::STAGES, NWG = T::NWG, SW = T::SW, D = T::D;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t q_s = smem_u32(smem);  // Q hi, then Q lo at q_s + Q_PART
  const uint32_t k_s = q_s + 2 * T::Q_PART;  // stage st at k_s + st STAGE_BYTES
  const uint32_t bar = q_s + T::BAR_OFF;     // full[NS], empty[NS], q
  const uint32_t q_bar = bar + 16 * NS;

  const int q0 = blockIdx.x * T::BQ;
  const int n_tiles = a.Lk / BK;
  const int wg = threadIdx.x >> 7;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar + 8 * s, 1);               // full: the producer's expect_tx
      mbar_init(bar + 8 * (NS + s), 4 * NWG);  // empty: one arrive per consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ------------------------------------------------------------ producer
    if constexpr (T::MOVE_REGS) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(q_bar, 2 * T::Q_PART);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load_4d(q_s + c * T::Q_CHUNK, &tqh, q_bar, c * CW, h, q0, b);
        tma_load_4d(q_s + T::Q_PART + c * T::Q_CHUNK, &tql, q_bar, c * CW, h, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % NS;
        mbar_wait(bar + 8 * (NS + st), ((it / NS) & 1) ^ 1);
        const uint32_t full = bar + 8 * st, base = k_s + st * T::STAGE_BYTES;
        mbar_expect_tx(full, T::STAGE_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(base + c * T::K_CHUNK, &tkh, full, c * CW, h, it * BK, b);
          tma_load_4d(base + T::K_PART + c * T::K_CHUNK, &tkl, full, c * CW, h, it * BK, b);
        }
        const uint32_t vt = base + 2 * T::K_PART;
#pragma unroll
        for (int c = 0; c < NCV; ++c) {
          tma_load_4d(vt + c * T::V_CHUNK, &tvh, full, it * BK + c * CWV, 0, h, b);
          tma_load_4d(vt + T::V_PART + c * T::V_CHUNK, &tvl, full, it * BK + c * CWV, 0, h, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    if constexpr (T::MOVE_REGS)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS));
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    Tf32Consumer<T, LITE> c;
    c.q_wg = q_s + wg * 64 * SW;  // this warpgroup's 64 rows of each chunk
    c.k_s = k_s;
    c.bar = bar;
    c.lane = lane;
    c.scale = a.scale;
    c.zero = blockIdx.z;  // the grid is 2-D
    c.m0 = c.m1 = -INFINITY;
    c.l0 = c.l1 = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) c.acc[i] = c.pv[i] = 0.f;

    mbar_wait(q_bar, 0);
    float sa[BK / 2];
    c.issue_s(sa, 0);
    wgmma_wait<0>();
    wgmma_fence_operands(sa);
    for (int it = 0; it + 1 < n_tiles; ++it) c.template step<true>(sa, it);
    c.template step<false>(sa, n_tiles - 1);
    wgmma_wait<0>();
    wgmma_fence_operands(c.pv);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) c.acc[i] += c.pv[i];

    float l0 = c.l0, l1 = c.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
    if constexpr (!LITE) {
      if (lse != nullptr && t == 0) {  // natural-log LSE of the scaled logits
        float* lp = lse + (long long)bh * a.Lq;
        if (r0 < a.Lq) lp[r0] = (c.m0 * a.scale + log2f(l0)) * LN2;
        if (r1 < a.Lq) lp[r1] = (c.m1 * a.scale + log2f(l1)) * LN2;
      }
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    float* o0 = o + b * a.o_b + h * a.o_h + r0 * a.o_l;
    float* o1 = o0 + 8 * a.o_l;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (r0 < a.Lq)
        *reinterpret_cast<float2*>(o0 + col) =
            make_float2(c.acc[4 * n] * inv0, c.acc[4 * n + 1] * inv0);
      if (r1 < a.Lq)
        *reinterpret_cast<float2*>(o1 + col) =
            make_float2(c.acc[4 * n + 2] * inv1, c.acc[4 * n + 3] * inv1);
    }
  }
}

}  // namespace
