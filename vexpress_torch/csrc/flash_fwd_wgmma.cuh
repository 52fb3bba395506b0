// K1's and K2's bf16 forward for Hopper (sm_90a): TMA loads into an mbarrier
// ring, wgmma, warp specialisation. flash_fwd.cu states what each replaces,
// the bound, and launches it (`launch_wgmma`).
//
// One block of 3 warpgroups (384 threads) per (BQ = 128 query rows, batch,
// head); WgmmaTile sets the key tile BK and how many blocks share an SM:
// * Warpgroup 2 is the producer. It gives up its registers (setmaxnreg.dec);
//   its first thread loads the block's Q tile once, then each tile of BK keys
//   of K and V, by TMA, into a ring of 3 stages in shared memory. Each stage
//   has a `full` mbarrier, completed by the TMA's byte count (complete_tx),
//   and an `empty` one, completed when each of the 8 consumer warps has
//   arrived.
// * Warpgroups 0 and 1 are the consumers, 64 query rows each
//   (setmaxnreg.inc). Per key tile: S = Q K^T by wgmma with both operands
//   K-major in shared memory; the online softmax in fp32 registers; O += P V
//   by wgmma with P from registers and V as an MN-major B operand. The
//   accumulators of two neighbouring 8-key groups of S are, packed to bf16,
//   the A fragment of one 16-key k-step of P V, so P never touches shared
//   memory. The softmax of one tile runs while P V of the tile before does,
//   and S of the next tile follows P V on the tensor cores at once. O is
//   divided by the row sum once, at the end, and stored from registers; rows
//   past Lq (a trailing 64-row tile) are not stored.
//
// Shared memory: each operand's tile is cut along the head dim into NC
// chunks of CW = SW / 2 columns, SW the swizzle span in bytes (32, 64 or
// 128). Chunk c is one TMA box (CW, 1, rows, 1) of the tensor viewed as
// (D, H, L, B) (element strides 1, D, H*D, L*H*D), so one (batch, head)'s tile
// is fetched by the hardware however far apart its rows lie. The box reads
// zeros past D (and past L); those zeros pad the head dim to NV, a multiple
// of the wgmma depth 16 (40 -> 48). The chunk lands as rows of SW bytes in
// the SW-byte swizzle that the wgmma descriptors name. Keys past Lk (a
// trailing 64-key tile at D=80) are masked.
//
// Template flags: LITE (K2's probabilities, see flash_fwd.cu) and SW.

#pragma once

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"  // mbarriers, TMA, wgmma

namespace {

using namespace vx;

constexpr int WG_BQ = 128;  // query rows per block: 2 consumer warpgroups of 64
constexpr int WG_THREADS = 384;

// the tiling and shared-memory layout of one instantiation, in bytes
template <int D, int SW>
struct WgmmaTile {
  static constexpr int CW = SW / 2;              // bf16 columns per chunk
  static constexpr int NV = (D + 15) / 16 * 16;  // head dim of the products
  static constexpr int NC = (NV + CW - 1) / CW;  // chunks per tile
  static constexpr int KS = NV / 16;             // k-steps of S = Q K^T
  // keys per stage and blocks per SM: at D=40 two blocks of 64-key tiles, so
  // that one block's waits and loads overlap the other's softmax; at D=80 one
  // block of 128-key tiles (two blocks' registers would serialise its wgmma);
  // at D=160 64-key tiles, for O's 80 accumulators (measured, PERF.md)
  static constexpr int BK = D == 80 ? 128 : 64;
  static constexpr int MINB = D == 40 ? 2 : 1;
  static constexpr int STAGES = 3;  // K/V stages in the ring
  // consumers' registers after setmaxnreg: a block starts with 65536 /
  // (384 MINB) a thread (168 or 80) and registers move only inside it, from
  // the producer warpgroup (down to 24) to the two consumer warpgroups
  static constexpr int CONSUMER_REGS = MINB == 1 ? 240 : 104;
  static constexpr uint32_t Q_CHUNK = WG_BQ * SW;
  static constexpr uint32_t KV_CHUNK = BK * SW;
  static constexpr uint32_t Q_BYTES = NC * Q_CHUNK;
  static constexpr uint32_t KV_BYTES = NC * KV_CHUNK;  // one of K or V, one stage
  static constexpr uint32_t BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // + the barriers, + slack to align the base to 1024 bytes (the 128-byte swizzle's period)
  static constexpr uint32_t SMEM = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
  static_assert(SW == 32 || SW == 64 || SW == 128, "swizzle span");
  static_assert(SMEM * MINB <= 232448, "shared memory of the blocks on one SM");
};

// S = Q K^T over one 16-deep k-step, BK keys
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&d)[BK / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BK == 128) {
    wgmma_ss_n128(d, a, b, scale_d);
  } else {
    static_assert(BK == 64, "key tiles of 64 or 128");
    wgmma_ss_n64(d, a, b, scale_d);
  }
}

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

// One consumer warpgroup's state over the key loop: 64 query rows, each
// warp's 16 rows g and g+8 in the accumulator layout. A stage goes back to
// the producer once its P V has completed. Each path through a step waits on
// a fixed count of running wgmma groups, so that ptxas keeps them
// asynchronous.
template <int D, bool LITE, int SW>
struct WgConsumer {
  using T = WgmmaTile<D, SW>;
  static constexpr int BK = T::BK, NS = T::STAGES, NV = T::NV, NKK = BK / 16;

  uint32_t q_wg, k_s, bar;  // this warpgroup's Q rows, the first stage, the barriers
  int t, lane, Lk;
  float scale;
  // running max of rows g and g+8: raw logits (K1), natural-log units of the
  // pre-scaled q's logits (K2); this thread's share of the running sums
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[NV / 2];
  uint32_t pa[NKK][4];  // A fragments of P, one per 16-key k-step

  // S of tile `it` into s, once its stage has landed (not waited for)
  __device__ __forceinline__ void issue_s(float (&s)[BK / 2], int it) {
    const int st = it % NS;
    mbar_wait(bar + 8 * st, (it / NS) & 1);
    const uint32_t kt = k_s + 2 * st * T::KV_BYTES;
    uint64_t qd[T::KS], kd_[T::KS];
#pragma unroll
    for (int kd = 0; kd < T::KS; ++kd) {
      const uint32_t c = kd * 16 / T::CW, off = (kd * 16 % T::CW) * 2;
      qd[kd] = wgmma_desc<SW>(q_wg + c * T::Q_CHUNK + off, 16, 8 * SW);
      kd_[kd] = wgmma_desc<SW>(kt + c * T::KV_CHUNK + off, 16, 8 * SW);
    }
    // every register the products read is defined before the warpgroup arrives
    wgmma_fence_operands(qd);
    wgmma_fence_operands(kd_);
    wgmma_fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < T::KS; ++kd) wgmma_qk<BK>(s, qd[kd], kd_[kd], kd);
    wgmma_commit();
  }

  // the online softmax of tile `it` (S complete in s): p in place of s, fp32
  // (K1) or packed bf16 pairs in s[8kk..8kk+3] (K2); the running max and sum
  // move on, and (a0, a1) is what acc must be scaled by
  __device__ __forceinline__ void softmax(float (&s)[BK / 2], int it, float& a0, float& a1) {
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
    if constexpr (LITE) {
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
  // producer, acc is scaled by (a0, a1), and P of this tile fills pa
  __device__ __forceinline__ void take_p(const float (&s)[BK / 2], int it, float a0, float a1) {
    wgmma_fence_operands(acc);
    wgmma_fence_operands(pa);
    __syncwarp();
    if (lane == 0 && it > 0) mbar_arrive(bar + 8 * (NS + (it - 1) % NS));
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
      if constexpr (LITE) {
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kk][i] = __float_as_uint(sk[i]);
      } else {
        pa[kk][0] = pack_bf16(sk[0], sk[1]);
        pa[kk][1] = pack_bf16(sk[2], sk[3]);
        pa[kk][2] = pack_bf16(sk[4], sk[5]);
        pa[kk][3] = pack_bf16(sk[6], sk[7]);
      }
    }
  }

  // O += P V of tile `it`; V's 16-key k-step kk starts 16 rows of SW bytes
  // in, its chunks (MN atoms of CW columns) KV_CHUNK apart
  __device__ __forceinline__ void issue_pv(int it) {
    const uint32_t vt = k_s + (2 * (it % NS) + 1) * T::KV_BYTES;
    uint64_t vd[NKK];
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk)
      vd[kk] = wgmma_desc<SW>(vt + kk * 16 * SW, T::KV_CHUNK, 8 * SW);
    wgmma_fence_operands(vd);
    wgmma_fence_operands(acc);
    wgmma_fence_operands(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk) wgmma_rs<NV>(acc, pa[kk], vd[kk]);
    wgmma_commit();
  }

  // Tile `it`, whose S is complete in s: its softmax runs while P V of the
  // tile before runs; then, with MORE (a tile follows), S of the next tile
  // and P V of this one run back to back.
  template <bool MORE>
  __device__ __forceinline__ void step(float (&s)[BK / 2], int it) {
    float a0, a1;
    softmax(s, it, a0, a1);
    wgmma_wait<0>();
    take_p(s, it, a0, a1);
    if constexpr (MORE) issue_s(s, it + 1);
    issue_pv(it);
    if constexpr (MORE) {  // S of the next tile (the older group) has completed
      wgmma_wait<1>();
      wgmma_fence_operands(s);
    }
  }
};

// `scale`: K1 passes the softmax scale times log2(e), applied to the logits
// in the exponent; K2 (LITE) the scale rounded to bf16, applied to Q in
// shared memory before the first product. `lse`: null, or (B, H, Lq) fp32
// for K1's natural-log log-sum-exp. o is (B, Lq, H*D), contiguous.
template <int D, bool LITE, int SW>
__global__ void __launch_bounds__(WG_THREADS, (WgmmaTile<D, SW>::MINB))
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int H, int Lq, int Lk, float scale) {
  using T = WgmmaTile<D, SW>;
  constexpr int CW = T::CW, NV = T::NV, NC = T::NC, BK = T::BK, NS = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t q_s = smem_u32(smem);
  const uint32_t k_s = q_s + T::Q_BYTES;  // stage st: K at k_s + 2 st KV_BYTES, V after it
  const uint32_t bar = q_s + T::BAR_OFF;  // full[NS], empty[NS], q
  const uint32_t q_bar = bar + 16 * NS;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * WG_BQ;
  const int n_tiles = (Lk + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar + 8 * s, 1);         // full: the producer's expect_tx
      mbar_init(bar + 8 * (NS + s), 8);  // empty: one arrive per consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_bar, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load_4d(q_s + c * T::Q_CHUNK, &tq, q_bar, c * CW, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % NS;
        mbar_wait(bar + 8 * (NS + st), ((it / NS) & 1) ^ 1);
        const uint32_t full = bar + 8 * st, kd = k_s + 2 * st * T::KV_BYTES;
        mbar_expect_tx(full, 2 * T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(kd + c * T::KV_CHUNK, &tk, full, c * CW, h, it * BK, b);
          tma_load_4d(kd + T::KV_BYTES + c * T::KV_CHUNK, &tv, full, c * CW, h, it * BK, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS));
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    WgConsumer<D, LITE, SW> c;
    c.q_wg = q_s + wg * 64 * SW;  // this warpgroup's 64 rows of each chunk
    c.k_s = k_s;
    c.bar = bar;
    c.t = t;
    c.lane = lane;
    c.Lk = Lk;
    c.scale = scale;
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) c.acc[i] = 0.f;

    mbar_wait(q_bar, 0);
    if constexpr (LITE) {
      // q * bf16(scale), rounded to bf16, in place (the zero padding stays zero)
#pragma unroll 1
      for (int ch = 0; ch < NC; ++ch) {
        uint4* p = reinterpret_cast<uint4*>(smem + ch * T::Q_CHUNK + wg * 64 * SW);
        for (int i = tid; i < 64 * SW / 16; i += 128) {
          uint4 x = p[i];
          x.x = scale_bf16x2(x.x, scale);
          x.y = scale_bf16x2(x.y, scale);
          x.z = scale_bf16x2(x.z, scale);
          x.w = scale_bf16x2(x.w, scale);
          p[i] = x;
        }
      }
      // generic-proxy writes, read next by wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }

    float sa[BK / 2];
    c.issue_s(sa, 0);
    wgmma_wait<0>();
    wgmma_fence_operands(sa);
    for (int it = 0; it + 1 < n_tiles; ++it) c.template step<true>(sa, it);
    c.template step<false>(sa, n_tiles - 1);
    wgmma_wait<0>();
    wgmma_fence_operands(c.acc);

    float l0 = c.l0, l1 = c.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
    if constexpr (!LITE) {
      if (lse != nullptr && t == 0) {  // natural-log LSE of the scaled logits
        float* lp = lse + (long long)bh * Lq;
        if (r0 < Lq) lp[r0] = (c.m0 * scale + log2f(l0)) * LN2;
        if (r1 < Lq) lp[r1] = (c.m1 * scale + log2f(l1)) * LN2;
      }
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const long long ld = (long long)H * D;
    __nv_bfloat16* o0 = o + ((long long)b * Lq + r0) * ld + h * D;
    __nv_bfloat16* o1 = o0 + 8 * ld;
#pragma unroll
    for (int n = 0; n < NV / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < D) {
        if (r0 < Lq)
          *reinterpret_cast<uint32_t*>(o0 + col) =
              pack_bf16(c.acc[4 * n] * inv0, c.acc[4 * n + 1] * inv0);
        if (r1 < Lq)
          *reinterpret_cast<uint32_t*>(o1 + col) =
              pack_bf16(c.acc[4 * n + 2] * inv1, c.acc[4 * n + 3] * inv1);
      }
    }
  }
}

}  // namespace
