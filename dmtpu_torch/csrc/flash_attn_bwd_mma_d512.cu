// K2 at head dims 264-512, the mma.sync kernel's widest instance: fused
// non-causal attention backward, bf16 in and out.  It served CelebA-HQ's UNet
// (configs/ddpm_celebahq.yaml), whose single attention head is as wide as its
// 512 channels, in training, until flash_attn_bwd.cu's CTA-pair instance took
// those head dims over; the gate in dmtpu_torch/ops/flash_attention.py now
// sends here only a broadcast (zero-stride) q, k, v or dO and kernel="mma".
//
// Replaces dmtpu/ops/flash_small_d.py::_bwd_kernel / _bwd (the Pallas TPU
// fused backward) and the backward role of the stock Pallas TPU flash kernel
// that dmtpu/ops/attention.py::flash_mha calls, at these head dims.
//
// What it computes, per (batch, head), from K1's saved f32 row logsumexp,
// exactly as the d <= 256 instances do:
//   delta = rowsum(dO o O)                      (f32)
//   P     = exp(S * scale - lse),  S = Q K^T    (f32; 0 for masked keys)
//   dV    = P^T dO                              (P rounded to bf16)
//   dP    = dO V^T
//   dS    = P o (dP - delta) * scale            (rounded to bf16)
//   dK    = dS^T Q,   dQ = dS K
// with f32 accumulators, each output rounded to bf16 once.
//
// What bounds it on this card: CelebA-HQ's calls (b16 h1, S = 256 and 64)
// move 34 MB and 2 MB and do 5.4 and 0.34 GFLOP, so the bound is bytes, a few
// microseconds, below the time the host takes to launch the call's three
// kernels; the kernel itself is bound by its shared-memory reads (every warp
// re-reads the K and V fragments of its 16 keys for each sub-step of rows).
//
// Why the d <= 256 layout does not stretch to 512 (flash_attn_bwd_mma.cu): a
// warp there owns 16 keys and accumulates dK and dV for half of the columns,
// which at 512 would be 256 f32 registers a thread, past the 255 cap; and its
// six 64-row tiles of (D + 8) columns would take 399,360 bytes of shared
// memory, past the 232,448 a block may have.  So, as K1's d=512 instance
// (flash_attn_fwd_mma_d512.cu) splits O:
//   - dK, dV and dQ are split by column halves over two CTAs (blockIdx.z):
//     each computes S^T = K Q^T and dP^T = V dO^T over the whole 512-deep
//     head, and accumulates only its 256 columns: dV[:, c] = P^T dO[:, c],
//     dK[:, c] = dS^T Q[:, c] and dQ[:, c] = dS K[:, c].  A warp's
//     accumulators are then those of the d=256 instance (16 keys x 128
//     columns of dK and of dV: 128 registers); the price is S^T and dP^T
//     computed twice, on a path bound by bytes and launches;
//   - one CTA of 4 warps per (b*h, 32-key tile of K/V, column half): two key
//     groups of 16 keys, each with two warps that own 128 columns apiece;
//     K and V stay in shared memory while the CTA walks every 32-row step of
//     Q / dO / lse / delta, double-buffered by cp.async, each step in two
//     sub-steps of 16 rows (the S^T and dP^T fragments of 16 rows beside the
//     accumulators, as at d=256);
//   - tiles: K and V [32][520], Q and dO 2 x [32][520], dS^T [32][40] and the
//     rows' lse and delta: 202,752 bytes of shared memory, one CTA per SM;
//     rows padded by 16 bytes so ldmatrix reads are free of bank conflicts;
//   - dQ: each CTA adds its [32 x 256] partial sums into a zeroed f32 buffer
//     with atomicAdd (dS^T goes through shared memory, where ldmatrix.trans
//     reads it back as dS); a last pass rounds the buffer to bf16.  The adds
//     arrive in an order that varies from run to run, so dQ may differ
//     between runs by a few f32 ulps of its partial sums before the rounding;
//   - a head dim below 512 is zero-padded (d=504 -> 512); a ragged last K/V
//     tile gets P = 0 for its missing keys and writes no dK/dV rows for them;
//     ragged Q rows get lse = +inf, so P = 0, and write no dQ;
//   - q, k, v, o, dO, dK and dV are addressed through [B, S, H, D] strides.
#include <math.h>

#include "flash_attn_bwd_prep.cuh"
#include "mma_common.cuh"

namespace {

using namespace dmtpu;

constexpr int kKeys = 32;    // keys per CTA
constexpr int kRows = 32;    // Q rows per step of its loop
constexpr int kRS = 16;      // rows of a sub-step
constexpr int kDK = 512;     // the depth of S^T and dP^T: the whole padded head
constexpr int kDC = 256;     // the dQ / dK / dV columns of one CTA: half the head
constexpr int kWarps = 4;    // 2 key groups x 2 column halves of the CTA's columns
constexpr int kThreads = kWarps * 32;
constexpr int kDPS = kDC / 2;  // the columns a warp owns
constexpr int kNTS = kDPS / 8; // their 8-wide column tiles
constexpr int kLD = kDK + 8;   // padded row: 8 consecutive rows hit distinct banks
constexpr int kLDS = kRows + 8;  // row of the dS^T tile
constexpr size_t kSmem = (size_t)(2 * kKeys * kLD + 4 * kRows * kLD + kKeys * kLDS) *
                             sizeof(__nv_bfloat16) +
                         (size_t)4 * kRows * sizeof(float);
constexpr float kLog2e = 1.4426950408889634f;

__global__ void __launch_bounds__(kThreads)
flash_bwd_d512_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int H, int Sq, int Sk, int D, Strides qs,
                      Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs, float scale,
                      float scale_log2) {
  constexpr int KSTEPS = kDK / 16;  // k-steps of S^T and dP^T
  constexpr int NJ = kRS / 8;       // 8-row tiles of S^T and dP^T a sub-step holds
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // [kKeys][kLD]
  __nv_bfloat16* sV = sK + kKeys * kLD;                          // [kKeys][kLD]
  __nv_bfloat16* sQ = sV + kKeys * kLD;                          // 2 x [kRows][kLD]
  __nv_bfloat16* sdO = sQ + 2 * kRows * kLD;                     // 2 x [kRows][kLD]
  __nv_bfloat16* sdS = sdO + 2 * kRows * kLD;                    // [kKeys][kLDS]
  float* sL = reinterpret_cast<float*>(sdS + kKeys * kLDS);      // 2 x [kRows] lse*log2(e)
  float* sD = sL + 2 * kRows;                                    // 2 x [kRows] delta

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kKeys;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;    // mma fragment row group / thread in group
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: which 8x8 matrix, which row
  const int grp = warp % 2;                // key group (and, for dQ, row group)
  const int c0 = blockIdx.z * kDC + (warp / 2) * kDPS;  // first dK/dV/dQ column of this warp
  const int nvec = D / 8;
  const __nv_bfloat16* qbase = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* dobase = dO + b * dos.b + h * dos.h;
  const float* lrow = lse + (long long)bh * Sq;
  const float* drow = delta + (long long)bh * Sq;

  // the rows of one Q step: Q and dO by cp.async, lse and delta by plain
  // loads (visible after the __syncthreads that precedes their use)
  auto load_rows = [&](int buf, int r0) {
    load_tile<kRows, kDK, kLD, kThreads>(sQ + buf * kRows * kLD, qbase, qs.s, r0, Sq, nvec);
    load_tile<kRows, kDK, kLD, kThreads>(sdO + buf * kRows * kLD, dobase, dos.s, r0, Sq, nvec);
    for (int i = threadIdx.x; i < kRows; i += kThreads) {
      const int row = r0 + i;
      sL[buf * kRows + i] = row < Sq ? lrow[row] * kLog2e : INFINITY;
      sD[buf * kRows + i] = row < Sq ? drow[row] : 0.f;
    }
  };

  load_tile<kKeys, kDK, kLD, kThreads>(sK, k + b * ks.b + h * ks.h, ks.s, k0, Sk, nvec);
  load_tile<kKeys, kDK, kLD, kThreads>(sV, v + b * vs.b + h * vs.h, vs.s, k0, Sk, nvec);
  load_rows(0, 0);
  cp_async_commit();

  float dk_acc[kNTS][4], dv_acc[kNTS][4];
  #pragma unroll
  for (int n = 0; n < kNTS; ++n) {
    #pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[n][c] = dv_acc[n][c] = 0.f;
  }
  const __nv_bfloat16* kA = sK + (grp * 16 + (mi % 2) * 8 + mr) * kLD + (mi / 2) * 8;
  const __nv_bfloat16* vA = sV + (grp * 16 + (mi % 2) * 8 + mr) * kLD + (mi / 2) * 8;

  const int nsteps = (Sq + kRows - 1) / kRows;
  for (int it = 0; it < nsteps; ++it) {
    const int buf = it & 1;
    if (it + 1 < nsteps) {
      load_rows(buf ^ 1, (it + 1) * kRows);
      cp_async_commit();
      cp_async_wait<1>();  // everything but the step just started has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tQ = sQ + buf * kRows * kLD;
    const __nv_bfloat16* tdO = sdO + buf * kRows * kLD;
    const float* tL = sL + buf * kRows;
    const float* tD = sD + buf * kRows;

    // The step's rows in sub-steps of kRS: each computes its P^T and dS^T,
    // adds its rows' share of dV and dK over this warp's columns and leaves
    // its dS^T columns in shared memory for the dQ product below (not
    // unrolled: one sub-step's fragments are dead before the next one's are
    // live)
    #pragma unroll 1
    for (int r0 = 0; r0 < kRows; r0 += kRS) {
      // S^T = K Q^T and dP^T = V dO^T over the whole head: 16 keys x kRS
      // rows, as NJ tiles of 8 rows
      float s[NJ][4], dp[NJ][4];
      #pragma unroll
      for (int j = 0; j < NJ; ++j) {
        #pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
      }
      #pragma unroll 8
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, kA + kk * 16);
        ldmatrix_x4(va, vA + kk * 16);
        #pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          const int off = (r0 + jp * 16 + (mi / 2) * 8 + mr) * kLD + kk * 16 + (mi % 2) * 8;
          uint32_t bq[4], bo[4];
          ldmatrix_x4(bq, tQ + off);
          mma_bf16(s[2 * jp], ka, bq[0], bq[1]);
          mma_bf16(s[2 * jp + 1], ka, bq[2], bq[3]);
          ldmatrix_x4(bo, tdO + off);
          mma_bf16(dp[2 * jp], va, bo[0], bo[1]);
          mma_bf16(dp[2 * jp + 1], va, bo[2], bo[3]);
        }
      }

      // P^T and dS^T in place; element c of tile j is key grp*16 + g + 8*(c/2)
      // of this CTA's tile and row r0 + 8j + 2t + (c&1) of this step
      #pragma unroll
      for (int j = 0; j < NJ; ++j) {
        #pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool key_ok = k0 + grp * 16 + g + 8 * (c / 2) < Sk;
          const int r = r0 + j * 8 + 2 * t + (c & 1);
          const float p = key_ok ? exp2f(s[j][c] * scale_log2 - tL[r]) : 0.f;
          s[j][c] = p;
          dp[j][c] = p * (dp[j][c] - tD[r]) * scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q over this warp's columns, 16 rows a step
      #pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        uint32_t pa[4], da[4];
        pack_a(pa, s[2 * kk], s[2 * kk + 1]);
        pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
        #pragma unroll
        for (int np = 0; np < kNTS / 2; ++np) {
          const int off =
              (r0 + kk * 16 + (mi % 2) * 8 + mr) * kLD + c0 + np * 16 + (mi / 2) * 8;
          uint32_t bo[4], bq[4];
          ldmatrix_x4_trans(bo, tdO + off);
          mma_bf16(dv_acc[2 * np], pa, bo[0], bo[1]);
          mma_bf16(dv_acc[2 * np + 1], pa, bo[2], bo[3]);
          ldmatrix_x4_trans(bq, tQ + off);
          mma_bf16(dk_acc[2 * np], da, bq[0], bq[1]);
          mma_bf16(dk_acc[2 * np + 1], da, bq[2], bq[3]);
        }
      }

      // dS^T (bf16) to shared memory; both warps of a key group hold the
      // same values and the first writes them
      if (warp < 2) {
        #pragma unroll
        for (int j = 0; j < NJ; ++j) {
          #pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<uint32_t*>(sdS + (grp * 16 + g + 8 * r) * kLDS + r0 + j * 8 +
                                         2 * t) = pack_bf16(dp[j][2 * r], dp[j][2 * r + 1]);
        }
      }
    }
    __syncthreads();

    // dQ[rows grp*16 .. +16, columns c0 .. c0 + kDPS) += dS K over the 32
    // keys; dS is read from dS^T with ldmatrix.trans
    uint32_t sa[kKeys / 16][4];
    #pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      ldmatrix_x4_trans(sa[kk], sdS + (kk * 16 + (mi / 2) * 8 + mr) * kLDS + grp * 16 +
                                    (mi % 2) * 8);
    const int q0 = it * kRows + grp * 16;
    #pragma unroll
    for (int np = 0; np < kNTS / 2; ++np) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      #pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, sK + (kk * 16 + (mi % 2) * 8 + mr) * kLD + c0 + np * 16 +
                                  (mi / 2) * 8);
        mma_bf16(acc[0], sa[kk], bk[0], bk[1]);
        mma_bf16(acc[1], sa[kk], bk[2], bk[3]);
      }
      #pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = c0 + np * 16 + n * 8 + 2 * t;
        #pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + g + 8 * r;
          if (row < Sq && col < D) {
            float* dst = dq_acc + (((long long)b * Sq + row) * H + h) * D + col;
            atomicAdd(dst, acc[n][2 * r]);
            atomicAdd(dst + 1, acc[n][2 * r + 1]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this step's buffers before they are refilled
  }

  #pragma unroll
  for (int n = 0; n < kNTS; ++n) {
    const int col = c0 + n * 8 + 2 * t;
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + grp * 16 + g + 8 * r;
      if (key >= Sk || col >= D) continue;
      *reinterpret_cast<uint32_t*>(dk + b * dks.b + (long long)key * dks.s + h * dks.h + col) =
          pack_bf16(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + b * dvs.b + (long long)key * dvs.s + h * dvs.h + col) =
          pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

}  // namespace

// The arguments of dmtpu_flash_attn_bwd_mma (flash_attn_bwd_mma.cu), for
// 256 < D <= 512: q, k, v, o, dO, dk, dv bf16 [B, S, H, D] with the given
// element strides (D contiguous, D % 8 == 0, every stride % 8 == 0, 16-byte
// aligned pointers); lse f32 [B, H, Sq] from K1; delta f32 scratch [B, H, Sq],
// dq_acc f32 scratch [B, Sq, H, D], dq bf16 [B, Sq, H, D], all four
// contiguous.  Launches three kernels in order on the stream; returns the
// first CUDA error code (0 on success).
extern "C" int dmtpu_flash_attn_bwd_mma_d512(
    const void* q, const void* k, const void* v, const void* o, const void* dO, const void* lse,
    void* delta, void* dq_acc, void* dq, void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb, long long oss, long long osh,
    long long dosb, long long doss, long long dosh, long long dksb, long long dkss, long long dksh,
    long long dvsb, long long dvss, long long dvsh, float scale, void* stream) {
  if (D <= kDC || D > kDK || D % 8) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh},
      dos{dosb, doss, dosh}, dks{dksb, dkss, dksh}, dvs{dvsb, dvss, dvsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return run_flash_bwd_mma(o, dO, delta, dq_acc, dq, B, H, Sq, D, os, dos, st, [&] {
    static bool allowed[kMaxDevices] = {};
    const cudaError_t attr = allow_dynamic_smem(flash_bwd_d512_kernel, (int)kSmem, allowed);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((Sk + kKeys - 1) / kKeys, B * H, kDK / kDC);
    flash_bwd_d512_kernel<<<grid, kThreads, kSmem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dO),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq_acc), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), H, Sq, Sk, D, qs, ks, vs, dos, dks, dvs, scale,
        scale * kLog2e);
    return cudaGetLastError();
  });
}
