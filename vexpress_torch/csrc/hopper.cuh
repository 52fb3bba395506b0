// Hopper (sm_90a) building blocks of the flash kernels: mbarriers, TMA loads
// (tiled 4-D boxes and 1-D bulk copies), wgmma descriptors, fences and
// products (bf16, and tf32 for the fp32 kernels), the cluster's shared
// memory and barriers, and, on the host, the encoding of the 4-D tensor
// maps. The bf16 forward (flash_fwd_wgmma.cuh), the fp32 forward
// (flash_fwd_tf32.cuh), both launched from flash_fwd.cu, and the bf16 and
// fp32 backward (flash_bwd_wgmma.cuh, flash_bwd_tf32.cuh, launched from
// flash_bwd.cu) include this header.

#pragma once

#include <cuda.h>  // CUtensorMap, cuTensorMapEncodeTiled's types
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace vx {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ clusters
// (the fp32 backward at D=160, flash_bwd_tf32.cuh: two CTAs share a block's
// rows, each on half the head dim, and send each other partial sums)

// the shared::cluster address of `addr` (this CTA's shared memory) in CTA `rank`
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// 16 bytes into another CTA's shared memory (a shared::cluster address)
__device__ __forceinline__ void st_cluster_v4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
}
// an arrive on another CTA's mbarrier (a shared::cluster address), ordered
// after this thread's earlier stores at cluster scope
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// until the phase of parity `parity` has completed, seeing what the other
// CTA's arrivers stored before they arrived
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// every thread of every CTA of the cluster (not .aligned: a warp's threads
// may come to it apart)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

// ----------------------------------------------------------------------- TMA
// box of `map` at (c0, c1, c2, c3) into shared memory `dst`, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` into shared `dst`, both 16-byte
// aligned, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// --------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (given in bytes, held in 16-byte units), swizzle (1: 128 B, 2: 64 B,
// 3: 32 B).
template <int SW>
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t layout = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving uses of `d` across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void wgmma_fence_operands(uint64_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+l"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void wgmma_fence_operands(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" : "+r"(d[i][0]), "+r"(d[i][1]), "+r"(d[i][2]), "+r"(d[i][3])::"memory");
}

#define VX_F8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// Accumulator layout of m64nNk16 (warp w of the warpgroup, g = lane / 4,
// t = lane % 4): d[4j], d[4j+1] = row 16w+g, columns 8j+2t, 8j+2t+1; d[4j+2],
// d[4j+3] = row 16w+g+8, the same columns. The A fragment in registers is
// mma.sync m16n8k16's (flash_common.cuh) for rows 16w..16w+15.

// d (64 x 32) = (scale_d ? d : 0) + A (64 x 16) B^T (B 32 x 16), A and B K-major in smem
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : VX_F8(0), VX_F8(8)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64) = (scale_d ? d : 0) + A (64 x 16) B^T (B 64 x 16), A and B K-major in smem
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : VX_F8(0), VX_F8(8), VX_F8(16), VX_F8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128) = (scale_d ? d : 0) + A (64 x 16) B^T (B 128 x 16), A and B K-major in smem
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : VX_F8(0), VX_F8(8), VX_F8(16), VX_F8(24), VX_F8(32), VX_F8(40), VX_F8(48), VX_F8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 48) += A (64 x 16, bf16 fragments in registers) B (16 x 48, MN-major in smem)
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : VX_F8(0), VX_F8(8), VX_F8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64) += A (64 x 16, bf16 fragments in registers) B (16 x 64, MN-major in smem)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : VX_F8(0), VX_F8(8), VX_F8(16), VX_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 80) += A (64 x 16, bf16 fragments in registers) B (16 x 80, MN-major in smem)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : VX_F8(0), VX_F8(8), VX_F8(16), VX_F8(24), VX_F8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128) += A (64 x 16, bf16 fragments in registers) B (16 x 128, MN-major in smem)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : VX_F8(0), VX_F8(8), VX_F8(16), VX_F8(24), VX_F8(32), VX_F8(40), VX_F8(48), VX_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 160) += A (64 x 16, bf16 fragments in registers) B (16 x 160, MN-major in smem)
__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : VX_F8(0), VX_F8(8), VX_F8(16), VX_F8(24), VX_F8(32), VX_F8(40), VX_F8(48), VX_F8(56), VX_F8(64), VX_F8(72)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// tf32 (the fp32 forward, flash_fwd_tf32.cuh): a k-step is 8 deep (32 bytes,
// as bf16's 16), both operands K-major; an RS product's A fragment of rows
// 16w..16w+15 is mma.sync m16n8k8's for tf32 (g = lane / 4, t = lane % 4):
// a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4].
#define VX_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// d (64 x 16) = (scale_d ? d : 0) + A (64 x 8) B^T (B 16 x 8), tf32, both K-major in smem
__device__ __forceinline__ void wgmma_ss_tf32_n16(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : VX_F8(0)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 32) = (scale_d ? d : 0) + A (64 x 8) B^T (B 32 x 8), tf32, both K-major in smem
__device__ __forceinline__ void wgmma_ss_tf32_n32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : VX_F8(0), VX_F8(8)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64) = (scale_d ? d : 0) + A (64 x 8) B^T (B 64 x 8), tf32, both K-major in smem
__device__ __forceinline__ void wgmma_ss_tf32_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : VX_F8(0), VX_F8(8), VX_F8(16), VX_F8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 40) = (scale_d ? d : 0) + A (64 x 8, tf32 fragments in registers) B^T
// (B 40 x 8, K-major in smem)
__device__ __forceinline__ void wgmma_rs_tf32_n40(float (&d)[20], const uint32_t (&a)[4], uint64_t b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : VX_F8(0), VX_F8(8), VX_F4(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 80) = (scale_d ? d : 0) + A (64 x 8, tf32 fragments in registers) B^T
// (B 80 x 8, K-major in smem)
__device__ __forceinline__ void wgmma_rs_tf32_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : VX_F8(0), VX_F8(8), VX_F8(16), VX_F8(24), VX_F8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 160) = (scale_d ? d : 0) + A (64 x 8, tf32 fragments in registers) B^T
// (B 160 x 8, K-major in smem)
__device__ __forceinline__ void wgmma_rs_tf32_n160(float (&d)[80], const uint32_t (&a)[4], uint64_t b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
      : VX_F8(0), VX_F8(8), VX_F8(16), VX_F8(24), VX_F8(32), VX_F8(40), VX_F8(48), VX_F8(56), VX_F8(64), VX_F8(72)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
#undef VX_F4
#undef VX_F8

// d (64 x N) = (scale_d ? d : 0) + A (64 x 16) B^T (B N x 16) over one
// 16-deep k-step, both K-major in smem
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 32) {
    wgmma_ss_n32(d, a, b, scale_d);
  } else if constexpr (N == 64) {
    wgmma_ss_n64(d, a, b, scale_d);
  } else {
    static_assert(N == 128, "SS product widths 32, 64, 128");
    wgmma_ss_n128(d, a, b, scale_d);
  }
}

// acc (64 x NV) += A (64 x 16 from registers) B (16 x NV, MN-major in smem)
// over one 16-deep k-step, at the head dim NV of the products
template <int NV>
__device__ __forceinline__ void wgmma_rs(float (&d)[NV / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (NV == 48) {
    wgmma_rs_n48(d, a, b);
  } else if constexpr (NV == 64) {
    wgmma_rs_n64(d, a, b);
  } else if constexpr (NV == 80) {
    wgmma_rs_n80(d, a, b);
  } else if constexpr (NV == 128) {
    wgmma_rs_n128(d, a, b);
  } else {
    static_assert(NV == 160, "product head dims 48, 64, 80, 128, 160");
    wgmma_rs_n160(d, a, b);
  }
}

// tf32: d (64 x N) = (scale_d ? d : 0) + A (64 x 8) B^T (B N x 8), both
// K-major in smem
template <int N>
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[N / 2], uint64_t a, uint64_t b,
                                              int scale_d) {
  if constexpr (N == 16) {
    wgmma_ss_tf32_n16(d, a, b, scale_d);
  } else if constexpr (N == 32) {
    wgmma_ss_tf32_n32(d, a, b, scale_d);
  } else {
    static_assert(N == 64, "tf32 SS product widths 16, 32, 64");
    wgmma_ss_tf32_n64(d, a, b, scale_d);
  }
}

// tf32: d (64 x N) = (scale_d ? d : 0) + A (64 x 8 from registers) B^T (B N x 8,
// K-major in smem)
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  if constexpr (N == 40) {
    wgmma_rs_tf32_n40(d, a, b, scale_d);
  } else if constexpr (N == 80) {
    wgmma_rs_tf32_n80(d, a, b, scale_d);
  } else {
    static_assert(N == 160, "tf32 RS product widths 40, 80, 160");
    wgmma_rs_tf32_n160(d, a, b, scale_d);
  }
}

// x rounded to tf32 (nearest, ties away from zero): the fp32 bits with the
// low 13 cleared (ops/flash.py::split_tf32 mirrors it)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ----------------------------------------------------- tensor maps (host)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int ERR_ENCODE = 10000;    // + the CUresult of a failed encode
constexpr int ERR_NO_ENCODE = 20000; // the driver has no cuTensorMapEncodeTiled

// the driver's cuTensorMapEncodeTiled, found once (so the library needs no -lcuda)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 4-D map of bf16 (or `dtype`) elements: dims (D, H, L, B), or (D, L, H, B)
// with `row_dim` 1, byte strides of dims 1..3, box (cols, 1, rows, 1), or
// (cols, rows, 1, 1) with `row_dim` 1, zeros past the tensor's bounds.
inline int encode(CUtensorMap* map, const void* base, const long long* dims,
                  const long long* strides, int cols, int rows, int sw, int row_dim = 2,
                  CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t gdim[4] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1], (cuuint64_t)dims[2],
                              (cuuint64_t)dims[3]};
  const cuuint64_t gstride[3] = {(cuuint64_t)strides[0], (cuuint64_t)strides[1],
                                 (cuuint64_t)strides[2]};
  const cuuint32_t box[4] = {(cuuint32_t)cols, row_dim == 1 ? (cuuint32_t)rows : 1,
                             row_dim == 1 ? 1 : (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = sw == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, dtype, 4, const_cast<void*>(base), gdim,
                        gstride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// `kernel`'s dynamic shared-memory limit set to `bytes`, once per device:
// `done` (one for each kernel instantiation) holds bit `dev` once it is set
template <typename F>
inline int set_smem_once(F* kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(done.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    done.fetch_or(bit, std::memory_order_relaxed);
  }
  return 0;
}

}  // namespace vx
