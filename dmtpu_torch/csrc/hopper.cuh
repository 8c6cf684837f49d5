// Hopper-only building blocks of the K1 attention forward: mbarriers, TMA tile
// loads, shared-memory matrix descriptors and the asynchronous warpgroup
// product (wgmma) with f32 accumulators, as inline PTX for sm_90a.
//
// Accumulator layout of wgmma.m64nNk16 (warp w of the warpgroup owns rows
// 16w..16w+15; g = lane / 4, t = lane % 4): d[4j + 0..1] is (row g, columns
// 8j + 2t..2t+1) and d[4j + 2..3] is (row g + 8, same columns): the mma.sync
// m16n8 C fragment repeated along N.  The register A operand of one k16 step
// is the mma.sync m16n8k16 A fragment, so two adjacent 8-column blocks of an
// accumulator, rounded to bf16, are the next product's A operand.
//
// Shared-memory operands are tiles of [rows][64 bf16] (128-byte rows) in the
// 128-byte swizzle that a TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes:
// eight rows form a 1024-byte atom, so tiles are 1024-byte aligned.
//   K-major (the product runs along the 64 columns): stride between 8-row
//     groups (SBO) 1024; a k16 step advances the start address by 32 bytes.
//   MN-major (the product runs along the rows, B given as [k][n]): SBO 1024
//     between 8-row groups of k, LBO the stride between 64-column blocks of
//     n; a k16 step advances the start address by 16 rows, 2048 bytes.
#pragma once

#include <cuda.h>

#include "mma_common.cuh"  // smem_addr, pack_bf16, Strides

namespace dmtpu {

// ---- mbarriers -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// One arrival, and the barrier's phase also waits for `bytes` of TMA data.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Spins until the phase of the given parity has completed (a fresh barrier
// has completed the phase of parity 1 and not that of parity 0).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ---------------------------------------------------------------------
// One box of a rank-4 tensor map into shared memory; completion (the box's
// full byte count, zero-filled parts included) is reported to `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma -------------------------------------------------------------------
// Descriptor of a 128-byte-swizzled operand tile (see the header comment).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = (smem_addr(p) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>(lbo_bytes >> 4) << 16;
  d |= static_cast<uint64_t>(sbo_bytes >> 4) << 32;
  d |= 1ull << 62;  // 128-byte swizzle
  return d;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

#define DMTPU_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define DMTPU_F16(d, i) DMTPU_F4(d, i), DMTPU_F4(d, i + 4), DMTPU_F4(d, i + 8), DMTPU_F4(d, i + 12)

// d[64 x 128] (+)= a[64 x 16] (shared, K-major) * b[128 x 16]^T (shared, K-major).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : DMTPU_F16(d, 0), DMTPU_F16(d, 16), DMTPU_F16(d, 32), DMTPU_F16(d, 48)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x 40] (+)= a[64 x 16] (registers) * b[16 x 40] (shared, MN-major: transposed).
__device__ __forceinline__ void wgmma_rs_n40(float (&d)[20], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : DMTPU_F16(d, 0), DMTPU_F4(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d[64 x 80] (+)= a[64 x 16] (registers) * b[16 x 80] (shared, MN-major: transposed).
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : DMTPU_F16(d, 0), DMTPU_F16(d, 16), DMTPU_F4(d, 32), DMTPU_F4(d, 36)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

#undef DMTPU_F4
#undef DMTPU_F16

}  // namespace dmtpu
