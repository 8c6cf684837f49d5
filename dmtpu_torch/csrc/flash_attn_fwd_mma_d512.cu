// K1 at head dims 264-512, the mma.sync kernel's widest instance: non-causal
// attention forward, bf16 in and out.  It serves CelebA-HQ's UNet
// (configs/ddpm_celebahq.yaml), whose single attention head is as wide as its
// 512 channels.  The gate is in dmtpu_torch/ops/flash_attention.py: every
// head dim above 256 comes here, every other one to flash_attn_fwd_mma.cu or
// flash_attn_fwd.cu.
//
// Replaces dmtpu/ops/flash_small_d.py::_fwd_kernel / _fwd (the Pallas TPU
// flash kernel) and the forward role of the stock Pallas TPU flash kernel
// that dmtpu/ops/attention.py::flash_mha calls, at these head dims.
//
// What it computes, per (batch, head): O = softmax(Q K^T * scale) V by online
// softmax (running max m, running sum l and the O accumulator in f32; P
// rounded to bf16 for the PV product), plus the row logsumexp m + log(l) in
// f32, exactly as the d <= 256 instances do.
//
// Why the d <= 256 layout does not stretch to 512 (flash_attn_fwd_mma.cu):
// a warp there owns 16 Q rows with the whole O row in registers, NT = D / 8
// tiles of 4 f32, which is 256 registers a thread at 512, past the 255 cap;
// and its five 64-row tiles of Q, K and V would take 332,800 bytes of shared
// memory, past the 232,448 a block may have.  So:
//   - O's columns are split over two CTAs (blockIdx.z): each computes
//     S = Q K^T over the whole head, the online softmax, and P V for its 256
//     columns of V and O.  The 128 accumulator registers a thread are those
//     of the d=256 instance; the price is Q K^T computed twice (1.5x the
//     operations of the plain product), on a path that moves few bytes and is
//     bound by them or by the launch (S = 256 and 64 in CelebA-HQ's UNet);
//   - both halves do the same arithmetic on the same rows, so their m and l
//     agree bit for bit; the first half writes the lse;
//   - one CTA of 4 warps per (b*h, 64-row Q tile, column half); each warp
//     owns 16 rows; the Q tile stays in shared memory and each k-step of
//     Q K^T re-reads its fragment with one ldmatrix, as at d=256;
//   - K/V tiles of 32 keys, double-buffered by cp.async: Q [64][520], K
//     2 x [32][520] and the half of V 2 x [32][264] take 166,912 bytes of
//     shared memory, one CTA per SM;
//   - shared-memory rows are padded by 16 bytes so ldmatrix reads are free of
//     bank conflicts; a head dim below 512 is zero-padded (d=504 -> 512);
//   - a ragged last K/V tile is masked, ragged Q rows are zero-filled and not
//     written;
//   - q, k, v and o are addressed through [B, S, H, D] strides.
#include <math.h>

#include "mma_common.cuh"

namespace {

using namespace dmtpu;

constexpr int kRows = 64;   // Q rows per CTA
constexpr int kKeys = 32;   // keys per K/V tile
constexpr int kWarps = 4;   // each warp owns 16 Q rows
constexpr int kDK = 512;    // the Q K^T depth: the whole padded head
constexpr int kDV = 256;    // the V / O columns of one CTA: half the head
constexpr int kLDK = kDK + 8;
constexpr int kLDV = kDV + 8;
constexpr int kThreads = kWarps * 32;
constexpr size_t kSmem =
    (size_t)(kRows * kLDK + 2 * kKeys * kLDK + 2 * kKeys * kLDV) * sizeof(__nv_bfloat16);
constexpr float kLn2 = 0.6931471805599453f;

__global__ void __launch_bounds__(kThreads)
flash_fwd_d512_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int H, int Sq, int Sk, int D, Strides qs,
                      Strides ks, Strides vs, Strides os, float scale_log2) {
  constexpr int KSTEPS = kDK / 16;  // k-steps of Q K^T
  constexpr int NT = kDV / 8;       // 8-wide column tiles of this CTA's O
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRows][kLDK]
  __nv_bfloat16* sK = sQ + kRows * kLDK;                         // 2 x [kKeys][kLDK]
  __nv_bfloat16* sV = sK + 2 * kKeys * kLDK;                     // 2 x [kKeys][kLDV]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int c0 = blockIdx.z * kDV;            // this CTA's first column of V and O
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;       // mma fragment row group / thread in group
  const int mi = lane / 8, mr = lane % 8;     // ldmatrix: which 8x8 matrix, which row
  const int nvec = D / 8;                     // 16-byte chunks of a q or k row
  const int nvec_v = max(0, min(kDV, D - c0)) / 8;  // of this CTA's part of a v row
  const __nv_bfloat16* kbase = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vbase = v + b * vs.b + h * vs.h + c0;

  load_tile<kRows, kDK, kLDK, kThreads>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq, nvec);
  load_tile<kKeys, kDK, kLDK, kThreads>(sK, kbase, ks.s, 0, Sk, nvec);
  load_tile<kKeys, kDV, kLDV, kThreads>(sV, vbase, vs.s, 0, Sk, nvec_v);
  cp_async_commit();

  float acc[NT][4];
  #pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // log2-domain running max of rows g, g + 8
  float l[2] = {0.f, 0.f};              // this thread's share of the running sums
  const __nv_bfloat16* qrow = sQ + (warp * 16 + (mi % 2) * 8 + mr) * kLDK + (mi / 2) * 8;

  const int ntiles = (Sk + kKeys - 1) / kKeys;
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      const int nb = buf ^ 1;
      load_tile<kKeys, kDK, kLDK, kThreads>(sK + nb * kKeys * kLDK, kbase, ks.s,
                                            (it + 1) * kKeys, Sk, nvec);
      load_tile<kKeys, kDV, kLDV, kThreads>(sV + nb * kKeys * kLDV, vbase, vs.s,
                                            (it + 1) * kKeys, Sk, nvec_v);
      cp_async_commit();
      cp_async_wait<1>();  // everything but the tile just started has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tK = sK + buf * kKeys * kLDK;
    const __nv_bfloat16* tV = sV + buf * kKeys * kLDV;

    // S = Q K^T: 16 rows x 32 keys per warp, as 4 column tiles of 8 keys
    float s[4][4];
    #pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    #pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, qrow + kk * 16);
      #pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t bk[4];
        ldmatrix_x4(bk, tK + (jp * 16 + (mi / 2) * 8 + mr) * kLDK + kk * 16 + (mi % 2) * 8);
        mma_bf16(s[2 * jp], qa, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qa, bk[2], bk[3]);
      }
    }

    // online softmax; this thread holds rows g (s[.][0..1]) and g + 8 (s[.][2..3])
    const int k0 = it * kKeys;
    float mx[2] = {-INFINITY, -INFINITY};
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
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
    for (int j = 0; j < 4; ++j) {
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

    // O += P V over this CTA's 256 columns, 16 keys per step; P's A fragment
    // is two adjacent S tiles
    #pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
      #pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, tV + (kk * 16 + (mi % 2) * 8 + mr) * kLDV + np * 16 + (mi / 2) * 8);
        mma_bf16(acc[2 * np], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // the four threads of a row group hold disjoint keys: sum their shares
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
    __nv_bfloat16* orow = o + b * os.b + (long long)row * os.s + h * os.h + c0;
    #pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t;
      if (c0 + col < D)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(acc[n][2 * r] * inv_l, acc[n][2 * r + 1] * inv_l);
    }
    if (t == 0 && blockIdx.z == 0) lse[(long long)bh * Sq + row] = (m[r] + log2f(l[r])) * kLn2;
  }
}

}  // namespace

// q, k, v, o: bf16 [B, S, H, D] with the given element strides (D contiguous,
// D % 8 == 0, 256 < D <= 512, every stride % 8 == 0, 16-byte aligned
// pointers).  lse: f32 [B, H, Sq], contiguous.  scale_log2 = softmax scale *
// log2(e).  Returns the CUDA error code of the launch (0 on success).
extern "C" int dmtpu_flash_attn_fwd_mma_d512(const void* q, const void* k, const void* v,
                                             void* o, void* lse, int B, int H, int Sq, int Sk,
                                             int D, long long qsb, long long qss, long long qsh,
                                             long long ksb, long long kss, long long ksh,
                                             long long vsb, long long vss, long long vsh,
                                             long long osb, long long oss, long long osh,
                                             float scale_log2, void* stream) {
  if (D <= kDV || D > kDK || D % 8) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  static bool allowed[kMaxDevices] = {};
  const cudaError_t attr = allow_dynamic_smem(flash_fwd_d512_kernel, (int)kSmem, allowed);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + kRows - 1) / kRows, B * H, kDK / kDV);
  flash_fwd_d512_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Sq, Sk, D, qs, ks, vs, os, scale_log2);
  return (int)cudaGetLastError();
}
