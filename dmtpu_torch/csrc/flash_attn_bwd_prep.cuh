// What K2's mma.sync kernels (flash_attn_bwd_mma.cu, flash_attn_bwd_mma_d512.cu)
// launch around their main kernel, generic in the head dim: delta =
// rowsum(dO o O) with the f32 dQ sums zeroed before it, and dq = bf16(the
// sums) after it.
#pragma once

#include "mma_common.cuh"

// in the including file's anonymous namespace: nvcc's generated stubs name a
// kernel by its namespace, and a second anonymous namespace inside dmtpu
// would make that name ambiguous
namespace {

using namespace dmtpu;

// delta[b, h, s] = sum_d dO * O in f32, and zeroes the matching row of the
// f32 dQ buffer ([B, Sq, H, D], contiguous).  One thread per (b, s, h) row.
__global__ void flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                                      const __nv_bfloat16* __restrict__ dO,
                                      float* __restrict__ delta, float* __restrict__ dq_acc,
                                      int B, int H, int Sq, int D, Strides os, Strides dos) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (long long)B * Sq * H) return;
  const int h = row % H;
  const int s = (row / H) % Sq;
  const int b = row / ((long long)H * Sq);
  const __nv_bfloat16* orow = o + b * os.b + (long long)s * os.s + h * os.h;
  const __nv_bfloat16* drow = dO + b * dos.b + (long long)s * dos.s + h * dos.h;
  float acc = 0.f;
  for (int c = 0; c < D; c += 8) {
    const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
    const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]), e = __bfloat1622float2(d2[i]);
      acc += a.x * e.x + a.y * e.y;
    }
  }
  delta[((long long)b * H + h) * Sq + s] = acc;
  float4* zero = reinterpret_cast<float4*>(dq_acc + row * D);
  for (int c = 0; c < D / 4; ++c) zero[c] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// dq = bf16(dq_acc), 8 values a thread; both contiguous, n8 = elements / 8.
__global__ void flash_bwd_cast_kernel(const float* __restrict__ src,
                                      __nv_bfloat16* __restrict__ dst, long long n8) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const float4 a = reinterpret_cast<const float4*>(src)[2 * i];
  const float4 c = reinterpret_cast<const float4*>(src)[2 * i + 1];
  const uint4 out{pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(c.x, c.y),
                  pack_bf16(c.z, c.w)};
  reinterpret_cast<uint4*>(dst)[i] = out;
}

// prep, then ``body()`` (the instance's launch, returning its cudaError_t),
// then the cast, in order on ``st``; returns the first CUDA error code.
template <typename Body>
int run_flash_bwd_mma(const void* o, const void* dO, void* delta, void* dq_acc, void* dq, int B,
                      int H, int Sq, int D, Strides os, Strides dos, cudaStream_t st,
                      Body&& body) {
  const long long rows = (long long)B * Sq * H;
  flash_bwd_prep_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dO),
      static_cast<float*>(delta), static_cast<float*>(dq_acc), B, H, Sq, D, os, dos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = body();
  if (err != cudaSuccess) return (int)err;
  const long long n8 = rows * D / 8;
  flash_bwd_cast_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(dq_acc), static_cast<__nv_bfloat16*>(dq), n8);
  return (int)cudaGetLastError();
}

}  // namespace
