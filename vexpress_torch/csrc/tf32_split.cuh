// The tf32 split passes of the fp32 kernels (K1's and K2's forward,
// flash_fwd_tf32.cuh, launched from flash_fwd.cu; K1's backward,
// flash_bwd_tf32.cuh, launched from flash_bwd.cu): each fp32 operand x as
// hi = tf32(x), lo = tf32(x - hi), written once into a scratch buffer that
// the kernels read by TMA. ops/flash.py::split_tf32 and its callers are the
// plain versions.
//
// wgmma takes a tf32 B operand K-major only, so an operand whose contraction
// runs along the sequence (V in the forward's P V; dO and Q in the backward's
// dV and dK, K in its dQ) is written transposed, (B, H, D, L), and within
// each group of 8 rows of the sequence its columns are permuted: column
// 8j + i holds row 8j + perm_key(i), PERM = 0 2 4 6 1 3 5 7. An accumulator
// gives a thread columns 2t and 2t+1 of each 8-column group, and the tf32 A
// fragment wants k-indices t and t+4, so the thread's two values go to
// k-indices t and t+4 as they are. No shuffle.

#pragma once

#include "hopper.cuh"  // tf32_rna

namespace {

using namespace vx;

// the (g, t) accumulator pair of columns 2t, 2t+1 of an 8-column group is
// the A fragment's k-indices t, t+4: the transposed parts hold the rows in
// this order
__host__ __device__ constexpr int perm_key(int i) { return i < 4 ? 2 * i : 2 * (i - 4) + 1; }

// x rounded to tf32 (hi) and what that left, rounded to tf32 (lo)
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = __uint_as_float(tf32_rna(x));
  lo = __uint_as_float(tf32_rna(x - hi));
}

// hi and lo parts of x * mul (`n4` float4s; the product rounded to fp32
// first, as K2's plain version rounds q * scale)
__global__ void __launch_bounds__(256)
tf32_split(const float4* __restrict__ x, float4* __restrict__ hi, float4* __restrict__ lo,
           long long n4, float mul) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4; i += gridDim.x * 256ll) {
    const float4 v = x[i];
    float4 h, l;
    split_tf32(__fmul_rn(v.x, mul), h.x, l.x);
    split_tf32(__fmul_rn(v.y, mul), h.y, l.y);
    split_tf32(__fmul_rn(v.z, mul), h.z, l.z);
    split_tf32(__fmul_rn(v.w, mul), h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// x (B, L, H*D) -> its hi and lo parts transposed, (B, H, D, L), each group
// of 8 rows in perm_key's order; one block per 32 rows of one (batch, head)
template <int D>
__global__ void __launch_bounds__(256)
tf32_split_vt(const float* __restrict__ v, float* __restrict__ hi, float* __restrict__ lo, int H,
              int Lk) {
  constexpr int TK = 32;
  __shared__ float tile[TK][D + 1];
  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * TK;
  const float* src = v + ((long long)b * Lk + k0) * H * D + h * D;
  for (int i = threadIdx.x; i < TK * D; i += 256) tile[i / D][i % D] = src[(long long)(i / D) * H * D + i % D];
  __syncthreads();
  const long long base = (long long)bh * D * Lk + k0;
  for (int i = threadIdx.x; i < TK * D; i += 256) {
    const int d = i / TK, col = i % TK;
    float hv, lv;
    split_tf32(tile[(col & ~7) + perm_key(col & 7)][d], hv, lv);
    hi[base + (long long)d * Lk + col] = hv;
    lo[base + (long long)d * Lk + col] = lv;
  }
}

// grid of tf32_split over n4 float4s
inline unsigned tf32_split_blocks(long long n4) {
  const long long b = n4 / 256 + 1;
  return (unsigned)(b < 132ll * 16 ? b : 132ll * 16);
}

// tf32_split_vt<D> of x (B, L, H*D) into hi, lo on stream s (L a multiple of 32)
inline void launch_split_vt(const float* x, float* hi, float* lo, int B, int H, int L, int D,
                            cudaStream_t s) {
  const dim3 grid(L / 32, B * H);
  if (D == 40) tf32_split_vt<40><<<grid, 256, 0, s>>>(x, hi, lo, H, L);
  if (D == 80) tf32_split_vt<80><<<grid, 256, 0, s>>>(x, hi, lo, H, L);
  if (D == 160) tf32_split_vt<160><<<grid, 256, 0, s>>>(x, hi, lo, H, L);
}

}  // namespace
