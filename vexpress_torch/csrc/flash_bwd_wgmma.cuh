// K1's bf16 backward for Hopper (sm_90a) at D=40, 80 and 160: the dk/dv and
// dq kernels on TMA loads into an mbarrier ring, wgmma and warp specialisation.
// flash_bwd.cu states what they replace and the bound, and launches them
// (`launch_dkv_wgmma`, `launch_dq_wgmma`).
//
// Both kernels run one block of 3 warpgroups (384 threads) an SM:
// * Warpgroup 2 is the producer (setmaxnreg.dec). Its first thread loads the
//   block's fixed tiles once, then walks the other axis in ring tiles of
//   ROWS rows (DkvTile, DqTile) into a ring of stages, by TMA, with a `full`
//   mbarrier (the TMA's byte count) and an `empty` one (one arrive per
//   consuming warp) a stage, as the forward does.
// * Warpgroups 0 and 1 are the consumers (setmaxnreg.inc), 64 rows of the
//   block's 128 each. A consumer warpgroup whose 64 rows lie past the end of
//   its axis (a trailing 64-row tile: L = 64 mod 128) exits at once, its
//   boxes are not loaded and the empty barriers count only the warps that
//   consume. Every ring tile is whole (L is a multiple of 64), so no logit
//   is masked, no lse or di past Lq is read and no row past L is stored.
// * Ring tiles are 64 rows, but 32 queries in dk/dv at D=160: there a
//   consumer's dK and dV hold 160 fp32 registers of the 240 it has, and a
//   32-query tile makes S^T and dP^T 16 registers each (wgmma N=32) and the
//   dV, dK products two k-steps (K=32). Each box is one ring tile's rows; a
//   fixed tile is loaded as 64 / ROWS boxes a consumer.
//
// dk/dv, one block per (128 keys, batch, head, part of the query axis): K
// and V of the block's keys are fixed; a stage holds ROWS queries of Q and
// dO (4-D TMA boxes) and their ROWS lse and di values (1-D bulk copies on
// the same barrier). Per query tile, each consumer warpgroup (64 keys):
//   S^T = K Q^T, dP^T = V dO^T      wgmma SS, both operands K-major (the
//                                   forward's S with K as A)
//   P^T = 2^(S^T scale log2 e - lse log2 e), dS^T = P^T (dP^T - di), fp32
//                                   in registers; lse and di index the
//                                   accumulator's columns (queries 8j+2t, +1)
//   dV += P^T dO, dK += dS^T Q      wgmma RS: A packed to bf16 from the
//                                   accumulators as the forward packs P; B
//                                   the same dO and Q tiles read MN-major,
//                                   as the forward reads V
// At the end dK is scaled. With one part, dK and dV are stored as bf16;
// with several, as fp32 partial sums into the workspace (part p's dK at
// p*n, its dV at (parts+p)*n, n = B*Lk*H*D), which flash_bwd.cu's
// `flash_bwd_dkv_sum` adds in part order. Part p walks query tiles
// [p*T/parts, (p+1)*T/parts) of the T = Lq/ROWS (ops/flash_tma.py::dkv_parts).
//
// dq, one block per (128 queries, batch, head): Q, dO, lse and di of the
// block's queries are fixed; a stage holds 64 keys of K and V. Per key tile,
// each consumer warpgroup (64 queries):
//   S = Q K^T, dP = dO V^T          SS, the forward's S
//   P, dS in registers              lse and di index the rows (g, g+8)
//   dQ += dS K                      RS, K read MN-major
// At the end dQ is scaled and stored as bf16.
//
// In each consumer warpgroup, as in the forward, the element-wise work of
// one tile (P, dS) runs while the RS products of the tile before do, and the
// SS products of the next tile follow those at once. Each path through a
// step waits on a fixed count of wgmma groups (the last tile is peeled), and
// every register a product reads is fenced before the warpgroup's arrive,
// so that ptxas keeps the wgmma asynchronous (it serialises a wgmma whose
// operand is computed after the arrive, or whose wait count is chosen at
// run time).
//
// Shared memory, as in the forward: a tile is cut along the head dim into
// NC chunks of CW = SW / 2 columns; a chunk of R rows is R rows of SW bytes
// in the SW-byte swizzle (TMA's zero fill past D pads the head dim to NV):
// 128-byte swizzle at D=40 and 80, the forward's 64-byte swizzle and five
// 32-column chunks at D=160 (ops/flash_tma.py::BWD_SWIZZLE). A K-major
// operand's k-step kd lies in chunk kd*16/CW, (kd*16 % CW)*2 bytes in; an
// MN-major operand's k-step kk (16 rows) starts kk*16*SW bytes in, its
// chunks (MN atoms) R*SW apart (LBO). One tile is read under both
// descriptors: Q and dO in dk/dv, K in dq.

#pragma once

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"  // mbarriers, TMA, wgmma

namespace {

using namespace vx;

constexpr int BWD_THREADS = 384;

// the tiling and shared-memory layout of one instantiation with ring tiles
// of RT rows and NS ring stages, in bytes
template <int D, int SW, int RT, int NS>
struct BwdTile {
  static constexpr int CW = SW / 2;              // bf16 columns per chunk
  static constexpr int NV = (D + 15) / 16 * 16;  // head dim of the products
  static constexpr int NC = (NV + CW - 1) / CW;  // chunks per tile
  static constexpr int KS = NV / 16;             // k-steps over the head dim (S, dP)
  static constexpr int ROWS = RT;        // rows of a box and of a ring tile
  static constexpr int KK = RT / 16;     // k-steps of the RS products over a ring tile
  static constexpr int WG_ROWS = 64;     // keys (dk/dv) or queries (dq) of a consumer warpgroup
  static constexpr int BLOCK = 128;      // keys (dk/dv) or queries (dq) of a block
  static constexpr int STAGES = NS;
  // one block an SM: a block starts with 168 registers a thread, the
  // producer gives up its share (down to 24) and each consumer takes 240
  static constexpr int CONSUMER_REGS = 240;
  static constexpr uint32_t BOX = ROWS * SW;          // one box: ROWS rows of one chunk
  static constexpr uint32_t WG_FIX = WG_ROWS * SW;    // a consumer's rows of a fixed chunk
  static constexpr uint32_t FIX_CHUNK = BLOCK * SW;   // one chunk of a fixed tile
  static constexpr uint32_t FIX = NC * FIX_CHUNK;     // one fixed tile (K, V or Q, dO)
  static constexpr uint32_t RING = NC * BOX;          // one of a stage's two tiles
  static constexpr uint32_t RING_OFF = 2 * FIX;
  static constexpr uint32_t STATS_OFF = RING_OFF + 2 * STAGES * RING;
  // lse and di: dk/dv ROWS of each a stage, dq 128 of each once
  static constexpr uint32_t DKV_STATS = STAGES * 2 * ROWS * 4;
  static constexpr uint32_t DQ_STATS = 2 * BLOCK * 4;
  static constexpr uint32_t BAR_OFF =
      STATS_OFF + (DKV_STATS > DQ_STATS ? DKV_STATS : DQ_STATS);
  // full[STAGES], empty[STAGES], fixed; + slack to align the base to 1024
  // bytes (the 128-byte swizzle's period)
  static constexpr uint32_t SMEM = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
  static_assert(SW == 32 || SW == 64 || SW == 128, "swizzle span");
  static_assert(RT == 32 || RT == 64, "ring tiles of 32 or 64 rows");
  static_assert(BOX % 1024 == 0, "boxes keep the swizzle's period");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// ring tiles and stages of each kernel (ops/flash_tma.py::BWD_RING): 64-row
// tiles, 3 stages for dk/dv and 4 for dq (a fourth speeds dq up and not
// dk/dv, measured on an H100, PERF.md §6; two are slower for both); at D=160
// dk/dv walks 32-query tiles in 4 stages and dq has 3 (a fourth of 40 KiB
// does not fit beside its fixed Q and dO)
template <int D, int SW>
using DkvTile = BwdTile<D, SW, D == 160 ? 32 : 64, D == 160 ? 4 : 3>;
template <int D, int SW>
using DqTile = BwdTile<D, SW, 64, D == 160 ? 3 : 4>;

// 64 x N accumulator = A (64 rows at a_base, K-major) B^T (N rows at b_base,
// K-major) over the head dim; a_chunk and b_chunk are the two tiles' chunk
// strides. Issued and committed as one group, not waited for.
template <int D, int SW, int N>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], uint32_t a_base, uint32_t a_chunk,
                                         uint32_t b_base, uint32_t b_chunk) {
  constexpr int CW = SW / 2, KS = (D + 15) / 16;  // BwdTile's
  uint64_t ad[KS], bd[KS];
#pragma unroll
  for (int kd = 0; kd < KS; ++kd) {
    const uint32_t c = kd * 16 / CW, off = (kd * 16 % CW) * 2;
    ad[kd] = wgmma_desc<SW>(a_base + c * a_chunk + off, 16, 8 * SW);
    bd[kd] = wgmma_desc<SW>(b_base + c * b_chunk + off, 16, 8 * SW);
  }
  // every register the products read is defined before the warpgroup arrives
  wgmma_fence_operands(ad);
  wgmma_fence_operands(bd);
  wgmma_fence_operands(d);
  wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < KS; ++kd) wgmma_ss<N>(d, ad[kd], bd[kd], kd);
  wgmma_commit();
}

// the A fragments of a 64 x 16KK accumulator taken as (64 rows, 16KK k),
// bf16: k-step kk is the accumulator's 8-column groups 2kk and 2kk+1
template <int KK>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KK][4], const float (&s)[8 * KK]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// the descriptors of a 16KK-row tile at `base` read MN-major, one per 16-row
// k-step; its chunks (MN atoms) lie 16KK*SW bytes apart
template <int SW, int KK>
__device__ __forceinline__ void mn_descs(uint64_t (&d)[KK], uint32_t base) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
    d[kk] = wgmma_desc<SW>(base + kk * 16 * SW, KK * 16 * SW, 8 * SW);
}

// the block's barriers, initialised by thread 0: full[NS] (the producer's
// expect_tx), empty[NS] (one arrive per consuming warp), fixed
__device__ __forceinline__ void init_barriers(uint32_t bar, int ns, int consumers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(bar + 8 * s, 1);
      mbar_init(bar + 8 * (ns + s), 4 * consumers);
    }
    mbar_init(bar + 16 * ns, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// One dk/dv consumer warpgroup's state over the query tiles: 64 keys, each
// warp's 16 keys g and g+8 in the accumulator layout. A stage goes back to
// the producer once the dV/dK products of its tile have completed.
template <int D, int SW>
struct DkvConsumer {
  using T = DkvTile<D, SW>;
  static constexpr int NS = T::STAGES, NV = T::NV, ROWS = T::ROWS, KK = T::KK;
  static constexpr int SN = ROWS / 2;  // registers of S^T and of dP^T (64 keys x ROWS queries)

  uint32_t k_wg, v_wg, ring, bar;  // this warpgroup's K and V rows, the ring, the barriers
  const float* stats;              // lse and di of the stages
  int t, lane;
  float scale_log2;
  float dka[NV / 2], dva[NV / 2];
  uint32_t pa[KK][4], da[KK][4];  // A fragments of P^T and dS^T, one per 16-query k-step

  // S^T = K Q^T and dP^T = V dO^T of tile `it`, once its stage has landed
  __device__ __forceinline__ void issue_sdp(float (&s)[SN], float (&dp)[SN], int it) {
    const int st = it % NS;
    mbar_wait(bar + 8 * st, (it / NS) & 1);
    const uint32_t qt = ring + 2 * st * T::RING;
    issue_ss<D, SW, ROWS>(s, k_wg, T::FIX_CHUNK, qt, T::BOX);
    issue_ss<D, SW, ROWS>(dp, v_wg, T::FIX_CHUNK, qt + T::RING, T::BOX);
  }

  // P^T and dS^T of tile `it` in place; columns 8j+2t, 8j+2t+1 are its queries
  __device__ __forceinline__ void p_ds(float (&s)[SN], float (&dp)[SN], int it) {
    const float* lse_t = stats + (it % NS) * 2 * ROWS;
    const float* di_t = lse_t + ROWS;
#pragma unroll
    for (int j = 0; j < ROWS / 8; ++j) {
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

  // after the previous tile's dV/dK have completed: its stage goes back to
  // the producer, and P^T, dS^T of this tile fill pa, da
  __device__ __forceinline__ void take(const float (&s)[SN], const float (&dp)[SN], int it) {
    wgmma_fence_operands(dka);
    wgmma_fence_operands(dva);
    wgmma_fence_operands(pa);
    wgmma_fence_operands(da);
    __syncwarp();
    if (lane == 0 && it > 0) mbar_arrive(bar + 8 * (NS + (it - 1) % NS));
    pack_a(pa, s);
    pack_a(da, dp);
  }

  // dV += P^T dO and dK += dS^T Q of tile `it`, dO and Q read MN-major
  __device__ __forceinline__ void issue_rs(int it) {
    const uint32_t qt = ring + 2 * (it % NS) * T::RING;
    uint64_t od[KK], qd[KK];
    mn_descs<SW, KK>(od, qt + T::RING);
    mn_descs<SW, KK>(qd, qt);
    wgmma_fence_operands(od);
    wgmma_fence_operands(qd);
    wgmma_fence_operands(dva);
    wgmma_fence_operands(dka);
    wgmma_fence_operands(pa);
    wgmma_fence_operands(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) wgmma_rs<NV>(dva, pa[kk], od[kk]);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) wgmma_rs<NV>(dka, da[kk], qd[kk]);
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
    if constexpr (MORE) {  // S^T, dP^T of the next tile (the older groups) have completed
      wgmma_wait<1>();
      wgmma_fence_operands(s);
      wgmma_fence_operands(dp);
    }
  }
};

// One dq consumer warpgroup's state over the key tiles: 64 queries, each
// warp's rows g and g+8. A stage goes back to the producer once the dQ
// product of its tile has completed.
template <int D, int SW>
struct DqConsumer {
  using T = DqTile<D, SW>;
  static constexpr int NS = T::STAGES, NV = T::NV, KK = T::KK;
  static constexpr int SN = T::ROWS / 2;  // registers of S and of dP (64 queries x 64 keys)

  uint32_t q_wg, do_wg, ring, bar;  // this warpgroup's Q and dO rows, the ring, the barriers
  int lane;
  float scale_log2, l0, l1, d0, d1;  // lse (log2 units) and di of rows g and g+8
  float dqa[NV / 2];
  uint32_t da[KK][4];  // A fragments of dS, one per 16-key k-step

  // S = Q K^T and dP = dO V^T of tile `it`, once its stage has landed
  __device__ __forceinline__ void issue_sdp(float (&s)[SN], float (&dp)[SN], int it) {
    const int st = it % NS;
    mbar_wait(bar + 8 * st, (it / NS) & 1);
    const uint32_t kt = ring + 2 * st * T::RING;
    issue_ss<D, SW, T::ROWS>(s, q_wg, T::FIX_CHUNK, kt, T::BOX);
    issue_ss<D, SW, T::ROWS>(dp, do_wg, T::FIX_CHUNK, kt + T::RING, T::BOX);
  }

  // dS in place of dP; rows g (s[4j], s[4j+1]) and g+8 (s[4j+2], s[4j+3])
  __device__ __forceinline__ void p_ds(const float (&s)[SN], float (&dp)[SN]) {
#pragma unroll
    for (int j = 0; j < T::ROWS / 8; ++j) {
      dp[4 * j] = ex2_approx(fmaf(s[4 * j], scale_log2, -l0)) * (dp[4 * j] - d0);
      dp[4 * j + 1] = ex2_approx(fmaf(s[4 * j + 1], scale_log2, -l0)) * (dp[4 * j + 1] - d0);
      dp[4 * j + 2] = ex2_approx(fmaf(s[4 * j + 2], scale_log2, -l1)) * (dp[4 * j + 2] - d1);
      dp[4 * j + 3] = ex2_approx(fmaf(s[4 * j + 3], scale_log2, -l1)) * (dp[4 * j + 3] - d1);
    }
  }

  // after the previous tile's dQ product has completed: its stage goes back
  // to the producer, and dS of this tile fills da
  __device__ __forceinline__ void take(const float (&dp)[SN], int it) {
    wgmma_fence_operands(dqa);
    wgmma_fence_operands(da);
    __syncwarp();
    if (lane == 0 && it > 0) mbar_arrive(bar + 8 * (NS + (it - 1) % NS));
    pack_a(da, dp);
  }

  // dQ += dS K of tile `it`, K read MN-major
  __device__ __forceinline__ void issue_rs(int it) {
    uint64_t kd[KK];
    mn_descs<SW, KK>(kd, ring + 2 * (it % NS) * T::RING);
    wgmma_fence_operands(kd);
    wgmma_fence_operands(dqa);
    wgmma_fence_operands(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) wgmma_rs<NV>(dqa, da[kk], kd[kk]);
    wgmma_commit();
  }

  // as DkvConsumer::step
  template <bool MORE>
  __device__ __forceinline__ void step(float (&s)[SN], float (&dp)[SN], int it) {
    p_ds(s, dp);
    wgmma_wait<0>();
    take(dp, it);
    if constexpr (MORE) issue_sdp(s, dp, it + 1);
    issue_rs(it);
    if constexpr (MORE) {
      wgmma_wait<1>();
      wgmma_fence_operands(s);
      wgmma_fence_operands(dp);
    }
  }
};

// The consumer loop of either kernel over n_tiles (>= 1) tiles, the last
// one peeled so that every wait count is fixed; returns with every product done.
template <typename C>
__device__ __forceinline__ void consume(C& c, int n_tiles) {
  float s[C::SN], dp[C::SN];
  c.issue_sdp(s, dp, 0);
  wgmma_wait<0>();
  wgmma_fence_operands(s);
  wgmma_fence_operands(dp);
  for (int it = 0; it + 1 < n_tiles; ++it) c.template step<true>(s, dp, it);
  c.template step<false>(s, dp, n_tiles - 1);
  wgmma_wait<0>();
}

// `scale` the softmax scale, `scale_log2` scale * log2(e). lse, di: (B, H,
// Lq) fp32. dk, dv: (B, Lk, H*D) bf16, written when gridDim.z == 1; ws:
// the fp32 workspace, written when gridDim.z > 1.
template <int D, int SW>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                    float* __restrict__ ws, int H, int Lq, int Lk, float scale, float scale_log2) {
  using T = DkvTile<D, SW>;
  constexpr int CW = T::CW, NV = T::NV, NC = T::NC, NS = T::STAGES, ROWS = T::ROWS;
  constexpr int WG_ROWS = T::WG_ROWS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t k_s = smem_u32(smem), v_s = k_s + T::FIX, ring = k_s + T::RING_OFF;
  const uint32_t stats = k_s + T::STATS_OFF, bar = k_s + T::BAR_OFF, fix_bar = bar + 16 * NS;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * T::BLOCK;
  const int parts = gridDim.z, part = blockIdx.z, q_tiles = Lq / ROWS;
  const int t0 = (int)((long long)part * q_tiles / parts);
  const int n_tiles = (int)((long long)(part + 1) * q_tiles / parts) - t0;
  const int consumers = min(2, (Lk - k0) / WG_ROWS);  // warpgroups whose keys lie below Lk
  const int wg = threadIdx.x >> 7;

  init_barriers(bar, NS, consumers);

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(fix_bar, 2 * consumers * NC * T::WG_FIX);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        for (int r = 0; r < consumers * (WG_ROWS / ROWS); ++r) {  // boxes below Lk
          const uint32_t off = c * T::FIX_CHUNK + r * T::BOX;
          tma_load_4d(k_s + off, &tk, fix_bar, c * CW, h, k0 + r * ROWS, b);
          tma_load_4d(v_s + off, &tv, fix_bar, c * CW, h, k0 + r * ROWS, b);
        }
      }
      const float* lse_bh = lse + (long long)bh * Lq;
      const float* di_bh = di + (long long)bh * Lq;
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % NS, row = (t0 + it) * ROWS;
        mbar_wait(bar + 8 * (NS + st), ((it / NS) & 1) ^ 1);
        const uint32_t full = bar + 8 * st, qt = ring + 2 * st * T::RING;
        const uint32_t st_stats = stats + st * 2 * ROWS * 4;
        mbar_expect_tx(full, 2 * T::RING + 2 * ROWS * 4);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(qt + c * T::BOX, &tq, full, c * CW, h, row, b);
          tma_load_4d(qt + T::RING + c * T::BOX, &tdo, full, c * CW, h, row, b);
        }
        bulk_load(st_stats, lse_bh + row, ROWS * 4, full);
        bulk_load(st_stats + ROWS * 4, di_bh + row, ROWS * 4, full);
      }
    }
  } else if (wg < consumers) {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS));
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    DkvConsumer<D, SW> c;
    c.k_wg = k_s + wg * T::WG_FIX;  // this warpgroup's 64 keys of each chunk
    c.v_wg = v_s + wg * T::WG_FIX;
    c.ring = ring;
    c.bar = bar;
    c.stats = reinterpret_cast<const float*>(smem + T::STATS_OFF);
    c.t = t;
    c.lane = lane;
    c.scale_log2 = scale_log2;
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) c.dka[i] = c.dva[i] = 0.f;
    mbar_wait(fix_bar, 0);
    consume(c, n_tiles);
    wgmma_fence_operands(c.dka);
    wgmma_fence_operands(c.dva);
    const float(&dka)[NV / 2] = c.dka, (&dva)[NV / 2] = c.dva;

    // keys r0 and r0 + 8 of this thread, both below Lk; columns < D only
    const int r0 = k0 + wg * WG_ROWS + warp * 16 + g;
    const long long ld = (long long)H * D;
    const long long o0 = ((long long)b * Lk + r0) * ld + h * D, o1 = o0 + 8 * ld;
    if (parts == 1) {
#pragma unroll
      for (int n = 0; n < NV / 8; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < D) {
          *reinterpret_cast<uint32_t*>(dk + o0 + col) =
              pack_bf16(dka[4 * n] * scale, dka[4 * n + 1] * scale);
          *reinterpret_cast<uint32_t*>(dk + o1 + col) =
              pack_bf16(dka[4 * n + 2] * scale, dka[4 * n + 3] * scale);
          *reinterpret_cast<uint32_t*>(dv + o0 + col) = pack_bf16(dva[4 * n], dva[4 * n + 1]);
          *reinterpret_cast<uint32_t*>(dv + o1 + col) = pack_bf16(dva[4 * n + 2], dva[4 * n + 3]);
        }
      }
    } else {
      const long long n_el = (long long)gridDim.y * Lk * D;  // B*Lk*H*D
      float* wk = ws + part * n_el;
      float* wv = ws + (parts + part) * n_el;
#pragma unroll
      for (int n = 0; n < NV / 8; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < D) {
          *reinterpret_cast<float2*>(wk + o0 + col) =
              make_float2(dka[4 * n] * scale, dka[4 * n + 1] * scale);
          *reinterpret_cast<float2*>(wk + o1 + col) =
              make_float2(dka[4 * n + 2] * scale, dka[4 * n + 3] * scale);
          *reinterpret_cast<float2*>(wv + o0 + col) = make_float2(dva[4 * n], dva[4 * n + 1]);
          *reinterpret_cast<float2*>(wv + o1 + col) = make_float2(dva[4 * n + 2], dva[4 * n + 3]);
        }
      }
    }
  }
}

// `scale`, `scale_log2`, lse, di as for flash_bwd_dkv_wgmma; dq (B, Lq, H*D) bf16.
template <int D, int SW>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ lse, const float* __restrict__ di,
                   __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk, float scale,
                   float scale_log2) {
  using T = DqTile<D, SW>;
  constexpr int CW = T::CW, NV = T::NV, NC = T::NC, NS = T::STAGES, ROWS = T::ROWS;
  constexpr int WG_ROWS = T::WG_ROWS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t q_s = smem_u32(smem), do_s = q_s + T::FIX, ring = q_s + T::RING_OFF;
  const uint32_t stats = q_s + T::STATS_OFF, bar = q_s + T::BAR_OFF, fix_bar = bar + 16 * NS;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * T::BLOCK;
  const int n_tiles = Lk / ROWS;
  const int consumers = min(2, (Lq - q0) / WG_ROWS);  // warpgroups whose queries lie below Lq
  const int wg = threadIdx.x >> 7;

  init_barriers(bar, NS, consumers);

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      const uint32_t stat_bytes = consumers * WG_ROWS * 4;
      mbar_expect_tx(fix_bar, 2 * consumers * NC * T::WG_FIX + 2 * stat_bytes);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        for (int r = 0; r < consumers * (WG_ROWS / ROWS); ++r) {  // boxes below Lq
          const uint32_t off = c * T::FIX_CHUNK + r * T::BOX;
          tma_load_4d(q_s + off, &tq, fix_bar, c * CW, h, q0 + r * ROWS, b);
          tma_load_4d(do_s + off, &tdo, fix_bar, c * CW, h, q0 + r * ROWS, b);
        }
      }
      bulk_load(stats, lse + (long long)bh * Lq + q0, stat_bytes, fix_bar);
      bulk_load(stats + T::BLOCK * 4, di + (long long)bh * Lq + q0, stat_bytes, fix_bar);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % NS;
        mbar_wait(bar + 8 * (NS + st), ((it / NS) & 1) ^ 1);
        const uint32_t full = bar + 8 * st, kt = ring + 2 * st * T::RING;
        mbar_expect_tx(full, 2 * T::RING);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(kt + c * T::BOX, &tk, full, c * CW, h, it * ROWS, b);
          tma_load_4d(kt + T::RING + c * T::BOX, &tv, full, c * CW, h, it * ROWS, b);
        }
      }
    }
  } else if (wg < consumers) {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS));
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    DqConsumer<D, SW> c;
    c.q_wg = q_s + wg * T::WG_FIX;  // this warpgroup's 64 queries of each chunk
    c.do_wg = do_s + wg * T::WG_FIX;
    c.ring = ring;
    c.bar = bar;
    c.lane = lane;
    c.scale_log2 = scale_log2;
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) c.dqa[i] = 0.f;
    mbar_wait(fix_bar, 0);
    const int row = wg * WG_ROWS + warp * 16 + g;
    const float* stats_f = reinterpret_cast<const float*>(smem + T::STATS_OFF);
    c.l0 = stats_f[row] * LOG2E;
    c.l1 = stats_f[row + 8] * LOG2E;
    c.d0 = stats_f[T::BLOCK + row];
    c.d1 = stats_f[T::BLOCK + row + 8];
    consume(c, n_tiles);
    wgmma_fence_operands(c.dqa);
    const float(&dqa)[NV / 2] = c.dqa;

    // rows q0 + row and q0 + row + 8, both below Lq; columns < D only
    const long long ld = (long long)H * D;
    __nv_bfloat16* o0 = dq + ((long long)b * Lq + q0 + row) * ld + h * D;
    __nv_bfloat16* o1 = o0 + 8 * ld;
#pragma unroll
    for (int n = 0; n < NV / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < D) {
        *reinterpret_cast<uint32_t*>(o0 + col) =
            pack_bf16(dqa[4 * n] * scale, dqa[4 * n + 1] * scale);
        *reinterpret_cast<uint32_t*>(o1 + col) =
            pack_bf16(dqa[4 * n + 2] * scale, dqa[4 * n + 3] * scale);
      }
    }
  }
}

}  // namespace
