// K1, the mma.sync kernel: non-causal attention forward, bf16 in and out, up
// to head dim 256.  Since the wgmma kernel (flash_attn_fwd.cu) gained its
// instances at head dims 160 and 256, its short-key tile and its persistent
// CTAs, the gate (dmtpu_torch/ops/flash_attention.py::select_kernel) sends no
// call of the repository's paths here: it serves what the wgmma kernel does
// not take, a non-positive scale and a q, k or v broadcast over batch, rows or
// heads (a zero stride has no tensor map), and runs when forced
// (``kernel="mma"``).  Until then it carried head dims 160 and 256, the
// cross-attention to 77 tokens and the short sequences.
//
// Replaces dmtpu/ops/flash_small_d.py::_fwd_kernel / _fwd (the Pallas TPU
// flash kernel for small head dims) and the forward role of the stock Pallas
// TPU flash kernel that dmtpu/ops/attention.py::flash_mha calls.
//
// What it computes, per (batch, head): O = softmax(Q K^T * scale) V by online
// softmax (running max m, running sum l and the O accumulator all in f32; P
// rounded to bf16 for the PV product, as the TPU kernel casts P to V's dtype),
// plus the row logsumexp m + log(l) in f32 for the backward kernel.
//
// What bounds it on this card: at the shapes it served (S_k=77, or S <= 256)
// it reads Q and writes O once and is bound by bytes, or by the time the
// host takes to launch it; it reached neither (CIFAR's b500 S=256 d=256 at
// 3.2x its bytes bound, NVIDIA H100 80GB HBM3, 700 W): an Ampere design,
// four warps a CTA and one CTA per SM at d=256, with nothing in flight while
// a CTA starts and ends.  The TPU kernel kept a whole K/V row in VMEM; here
// tiles of 64 keys go through shared memory:
//   - one CTA of 4 warps per (b*h, 64-row Q tile); each warp owns 16 rows;
//   - a loop over 64-key K/V tiles in shared memory, double-buffered: the
//     next tile's cp.async copies run while the current tile is computed;
//   - QK^T and PV on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//     accumulate); operands come from shared memory through ldmatrix (V
//     transposed on the fly); the logits, P and the O accumulator stay in
//     registers, and P is re-packed from the QK^T accumulator layout into
//     the PV A-operand layout without touching shared memory;
//   - shared-memory rows are padded by 16 bytes so ldmatrix reads are free
//     of bank conflicts;
//   - one instance per padded head dim of SD1.5 (48, 80, 160) and one at
//     256 for the pixel-space UNets, whose single attention head is as wide
//     as the channels; a head dim below its instance's is zero-padded in
//     shared memory (d=40 -> 48);
//   - at 256 a warp's O accumulator alone is 128 registers a thread, so the
//     Q fragments (64 more) are not kept in registers across the key loop:
//     each k-step of QK^T re-reads its fragment from the Q tile in shared
//     memory with one ldmatrix; the five 64 x 264 tiles take 165 KiB of
//     shared memory, one CTA per SM;
//   - a ragged last K/V tile is masked (cross-attention to 77 tokens), ragged
//     Q rows are zero-filled and not written;
//   - q, k, v and o are addressed through [B, S, H, D] strides, so the
//     projection outputs [B, S, H*D] need no transpose copy.
#include <math.h>

#include "mma_common.cuh"

namespace {

using namespace dmtpu;

constexpr int kRows = 64;   // Q rows per CTA and keys per K/V tile
constexpr int kWarps = 4;   // each warp owns 16 Q rows
constexpr float kLn2 = 0.6931471805599453f;

template <int DP, int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int r0, int n_rows, int nvec) {
  load_tile<kRows, DP, LD, kWarps * 32>(dst, src, row_stride, r0, n_rows, nvec);
}

template <int DP>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk, int D, Strides qs,
                 Strides ks, Strides vs, Strides os, float scale_log2) {
  constexpr int LD = DP + 8;  // padded row: 8 consecutive rows hit distinct banks
  constexpr int KSTEPS = DP / 16;
  constexpr int NT = DP / 8;  // 8-wide column tiles of O
  // Q fragments stay in registers across the key loop, but at 256 (see the top)
  constexpr bool kQInRegs = DP <= 160;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRows][LD]
  __nv_bfloat16* sK = sQ + kRows * LD;                           // 2 x [kRows][LD]
  __nv_bfloat16* sV = sK + 2 * kRows * LD;                       // 2 x [kRows][LD]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;       // mma fragment row group / thread in group
  const int mi = lane / 8, mr = lane % 8;     // ldmatrix: which 8x8 matrix, which row
  const int nvec = D / 8;
  const __nv_bfloat16* kbase = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vbase = v + b * vs.b + h * vs.h;

  load_rows<DP, LD>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq, nvec);
  load_rows<DP, LD>(sK, kbase, ks.s, 0, Sk, nvec);
  load_rows<DP, LD>(sV, vbase, vs.s, 0, Sk, nvec);
  cp_async_commit();

  float acc[NT][4];
  #pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // log2-domain running max of rows g, g + 8
  float l[2] = {0.f, 0.f};              // this thread's share of the running sums
  uint32_t qf[kQInRegs ? KSTEPS : 1][4];

  const int ntiles = (Sk + kRows - 1) / kRows;
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      const int nb = buf ^ 1;
      load_rows<DP, LD>(sK + nb * kRows * LD, kbase, ks.s, (it + 1) * kRows, Sk, nvec);
      load_rows<DP, LD>(sV + nb * kRows * LD, vbase, vs.s, (it + 1) * kRows, Sk, nvec);
      cp_async_commit();
      cp_async_wait<1>();  // everything but the tile just started has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qrow = sQ + (warp * 16 + (mi % 2) * 8 + mr) * LD + (mi / 2) * 8;
    if constexpr (kQInRegs) {
      if (it == 0) {
        #pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(qf[kk], qrow + kk * 16);
      }
    }
    const __nv_bfloat16* tK = sK + buf * kRows * LD;
    const __nv_bfloat16* tV = sV + buf * kRows * LD;

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 column tiles of 8 keys
    float s[8][4];
    #pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    #pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4];
      if constexpr (kQInRegs) {
        qa[0] = qf[kk][0], qa[1] = qf[kk][1], qa[2] = qf[kk][2], qa[3] = qf[kk][3];
      } else {
        ldmatrix_x4(qa, qrow + kk * 16);
      }
      #pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bk[4];
        ldmatrix_x4(bk, tK + (jp * 16 + (mi / 2) * 8 + mr) * LD + kk * 16 + (mi % 2) * 8);
        mma_bf16(s[2 * jp], qa, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qa, bk[2], bk[3]);
      }
    }

    // online softmax; this thread holds rows g (s[.][0..1]) and g + 8 (s[.][2..3])
    const int k0 = it * kRows;
    float mx[2] = {-INFINITY, -INFINITY};
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + j * 8 + 2 * t + (c & 1);
        s[j][c] = key < Sk ? s[j][c] * scale_log2 : -INFINITY;
        mx[c / 2] = fmaxf(mx[c / 2], s[j][c]);
      }
    }
    float alpha[2];
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = exp2f(s[j][c] - m[c / 2]);
        l[c / 2] += s[j][c];
      }
    }
    #pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V, 16 keys per step; P's A fragment is two adjacent S tiles
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
      #pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, tV + (kk * 16 + (mi % 2) * 8 + mr) * LD + np * 16 + (mi / 2) * 8);
        mma_bf16(acc[2 * np], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // the four threads of a row group hold disjoint columns: sum their shares
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= Sq) continue;
    const float inv_l = 1.f / l[r];
    __nv_bfloat16* orow = o + b * os.b + (long long)row * os.s + h * os.h;
    #pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < D)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(acc[n][2 * r] * inv_l, acc[n][2 * r + 1] * inv_l);
    }
    if (t == 0) lse[(long long)bh * Sq + row] = (m[r] + log2f(l[r])) * kLn2;
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int H, int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs,
                   Strides os, float scale_log2, cudaStream_t stream) {
  constexpr size_t smem = (size_t)5 * kRows * (DP + 8) * sizeof(__nv_bfloat16);
  static bool allowed[kMaxDevices] = {};
  const cudaError_t attr = allow_dynamic_smem(flash_fwd_kernel<DP>, (int)smem, allowed);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  flash_fwd_kernel<DP><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Sq, Sk, D, qs, ks, vs, os, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: bf16 [B, S, H, D] with the given element strides (D contiguous,
// D % 8 == 0, D <= 256, every stride % 8 == 0, 16-byte aligned pointers).
// lse: f32 [B, H, Sq], contiguous.  scale_log2 = softmax scale * log2(e).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int dmtpu_flash_attn_fwd_mma(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int B, int H, int Sq, int Sk, int D,
                                        long long qsb, long long qss, long long qsh,
                                        long long ksb, long long kss, long long ksh,
                                        long long vsb, long long vss, long long vsh,
                                        long long osb, long long oss, long long osh,
                                        float scale_log2, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DMTPU_FLASH_CASE(DP)                                                          \
  if (D <= DP)                                                                        \
    return (int)launch<DP>(q, k, v, o, lse, B, H, Sq, Sk, D, qs, ks, vs, os, scale_log2, st);
  DMTPU_FLASH_CASE(48)
  DMTPU_FLASH_CASE(80)
  DMTPU_FLASH_CASE(160)
  DMTPU_FLASH_CASE(256)
#undef DMTPU_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dmtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
