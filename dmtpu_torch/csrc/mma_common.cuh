// Helpers shared by the attention kernels (K1 forward, K2 backward): cp.async
// tile loads into padded shared memory, ldmatrix and the bf16 mma.sync
// m16n8k16 tensor-core product with f32 accumulators.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: {a0,a1} (g, 2t..2t+1), {a2,a3} (g+8, 2t..), {a4,a5}
//     (g, 2t+8..), {a6,a7} (g+8, 2t+8..);
//   B 16x8 "col": {b0,b1} (k 2t..2t+1, n g), {b2,b3} (k 2t+8.., n g);
//   C 16x8: {c0,c1} (g, 2t..2t+1), {c2,c3} (g+8, 2t..).
// ldmatrix.x4: lane i gives the address of row i % 8 of matrix i / 8, and
// register j receives matrix j's (g, 2t..2t+1), or with .trans its
// (2t..2t+1, g).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dmtpu {

struct Strides {
  long long b, s, h;  // element strides of [B, S, H, D]; D is contiguous
};

// Raises a kernel's dynamic shared-memory limit once per device, not once per
// call: the attribute belongs to the device's context, so `done` (one static
// array per kernel instance) remembers which devices have it.
constexpr int kMaxDevices = 64;
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel* kernel, int bytes, bool (&done)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device < kMaxDevices) done[device] = true;
  return err;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills when !valid (no bytes read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a 16x16 block whose two 16x8 halves are the C
// fragments c0 (columns 0-7) and c1 (columns 8-15), rounded to bf16: a
// product's output re-used as the next product's left operand in registers.
__device__ __forceinline__ void pack_a(uint32_t* a, const float* c0, const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Starts async copies of rows [r0, r0 + ROWS) of one (b, h) slice into a
// [ROWS][LD] bf16 tile, spread over THREADS threads.  Rows past n_rows and
// columns past the real head dim (nvec 16-byte chunks) are zero-filled.
template <int ROWS, int DP, int LD, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int r0, int n_rows, int nvec) {
  constexpr int kVec = DP / 8;
  for (int i = threadIdx.x; i < ROWS * kVec; i += THREADS) {
    const int r = i / kVec, c = i % kVec;
    const bool valid = r0 + r < n_rows && c < nvec;
    const __nv_bfloat16* from = valid ? src + (long long)(r0 + r) * row_stride + c * 8 : src;
    cp_async16(dst + r * LD + c * 8, from, valid);
  }
}

}  // namespace dmtpu
