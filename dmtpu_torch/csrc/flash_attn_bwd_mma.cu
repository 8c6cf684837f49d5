// K2: fused non-causal attention backward for Hopper (sm_90a), bf16 in and out:
// the general kernel, on mma.sync.
//
// Replaces dmtpu/ops/flash_small_d.py::_bwd_kernel / _bwd (the Pallas TPU
// fused backward for small head dims), the backward role of the stock Pallas
// TPU flash kernel that dmtpu/ops/attention.py::flash_mha calls, and the probe
// variant benchmarks/_smalld_variants.py::_bwd_sem (the same function).  It
// takes every head dim that is a multiple of 8 up to 256 and any strides (the
// wider heads, up to 512, have their own instance in
// flash_attn_bwd_mma_d512.cu).  Every head dim with a wgmma instance (40, 64,
// 72, 80, and every multiple of 8 in (80, 256] on the column-split instances
// of 160 and 256) goes to the wgmma kernel in flash_attn_bwd.cu (the gate is
// in dmtpu_torch/ops/flash_attention.py), so no path of the repository runs
// this one: it takes head dims below 40, 48 and 56, a broadcast q, k, v or
// dO, and kernel="mma"; chip_smoke.py still checks and times it beside the
// wgmma kernel at SD1.5's d=160 and the pixel UNets' d=256.
//
// What it computes, per (batch, head), from K1's saved f32 row logsumexp:
//   delta = rowsum(dO o O)                      (f32)
//   P     = exp(S * scale - lse),  S = Q K^T    (f32; 0 for masked keys)
//   dV    = P^T dO                              (P rounded to bf16, V's dtype)
//   dP    = dO V^T
//   dS    = P o (dP - delta) * scale            (rounded to bf16, Q's dtype)
//   dK    = dS^T Q,   dQ = dS K
// with f32 accumulators, each output rounded to bf16 once.
//
// What bounds it on this card: at the long self-attention shapes its own
// shared-memory reads (every warp re-reads the whole Q and dO tile for its 16
// keys; compiling the dQ atomics out saves 17% at S=4096, d=40 and 38% at
// S=1024, d=80, replacing the exponentials by a multiply nothing: NVIDIA H100
// 80GB HBM3, 700 W), which is why those shapes left it.  So did SD1.5's
// d = 160 calls and the pixel UNets' d = 256 calls (S = 256 and 16), where
// the wgmma kernel's column-split instances took 0.11 against 0.22 ms (b16
// h8 S=256 d=160) and 0.17 against 0.35 ms (b128 h1 S=256 d=256) of device
// time (dmtpu_torch/dev/k2_probe.py fresh).
//
// Design:
//   - one CTA per (b*h, 64-key tile of K/V); K and V stay in shared memory
//     while the CTA walks every 64-row tile of Q / dO / lse / delta, which
//     are double-buffered (the next tile's cp.async copies run while the
//     current one is computed);
//   - four key groups of 16 keys; each warp computes S^T = K Q^T and
//     dP^T = V dO^T for its 16 keys x 64 rows, so P^T and dS^T come out in
//     the mma accumulator layout and feed dV += P^T dO and dK += dS^T Q as
//     A operands straight from registers;
//   - dQ: on the TPU it lived in one VMEM block revisited across the whole
//     sequential k sweep.  Here the k tiles run on different SMs, so each CTA
//     adds its [64 x D] partial dQ into a zeroed f32 buffer with atomicAdd
//     (dS^T goes through shared memory, where ldmatrix.trans reads it back as
//     dS), and a last pass rounds the buffer to bf16.  This keeps the five
//     products per block pair; the alternative, a second kernel over Q tiles,
//     recomputes S and dP (seven).  The atomics' order varies from run to
//     run, so dQ is not bitwise reproducible: it may differ between runs by
//     a few f32 ulps of its partial sums before the bf16 rounding;
//   - head dims are zero-padded in shared memory to the instance's 48, 80,
//     160 or 256 (d = 40 -> 48, the 16-deep MMA step); a ragged last K/V tile
//     (S_k = 77) gets P = 0 for its missing keys and writes no dK/dV rows
//     for them; ragged Q rows get lse = +inf, so P = 0, and write no dQ;
//   - at d = 160 the dK and dV accumulators of 16 keys x 160 columns would
//     take 160 registers a thread, so that instance runs 8 warps: two per
//     key group, each accumulating dK and dV for half of the columns (both
//     recompute the group's S^T and dP^T, which costs two extra products of
//     the five at the two smallest shapes of the path);
//   - at d = 256 the same split leaves 128 accumulator registers a thread
//     for dK and dV, and the S^T and dP^T fragments of 64 rows would take 64
//     more: that instance walks each 64-row step in four sub-steps of 16
//     rows (16 fragment registers), re-reading its K and V fragments from
//     shared memory for each (227 registers, no spills; sub-steps of 32 rows
//     spill, see dmtpu_torch/dev/k2_probe.py's d256 phase); its tiles take
//     208 KiB of shared memory (one CTA per SM);
//   - q, k, v, o, dO, dK and dV are addressed through [B, S, H, D] strides.
#include <math.h>

#include "flash_attn_bwd_prep.cuh"
#include "mma_common.cuh"

namespace {

using namespace dmtpu;

constexpr int kRows = 64;  // keys per CTA, and Q rows per step of its loop
constexpr float kLog2e = 1.4426950408889634f;

template <int DP, int DSPLIT, int RS>
__global__ void __launch_bounds__(4 * DSPLIT * 32)
flash_bwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int H, int Sq, int Sk, int D, Strides qs,
                 Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs, float scale,
                 float scale_log2) {
  constexpr int kThreads = 4 * DSPLIT * 32;
  constexpr int LD = DP + 8;      // padded row: 8 consecutive rows hit distinct banks
  constexpr int LDS = kRows + 8;  // row of the dS^T tile
  constexpr int KSTEPS = DP / 16;
  constexpr int DPS = DP / DSPLIT;  // dK/dV columns a warp owns
  constexpr int NTS = DPS / 8;      // their 8-wide column tiles
  constexpr int NJ = RS / 8;        // 8-row tiles of S^T and dP^T a sub-step holds
  static_assert(NTS % 2 == 0, "column tiles are taken in pairs");
  static_assert(kRows % RS == 0 && RS % 16 == 0, "sub-steps of whole 16-row blocks");
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRows][LD]
  __nv_bfloat16* sV = sK + kRows * LD;                           // [kRows][LD]
  __nv_bfloat16* sQ = sV + kRows * LD;                           // 2 x [kRows][LD]
  __nv_bfloat16* sdO = sQ + 2 * kRows * LD;                      // 2 x [kRows][LD]
  __nv_bfloat16* sdS = sdO + 2 * kRows * LD;                     // [kRows keys][LDS]
  float* sL = reinterpret_cast<float*>(sdS + kRows * LDS);       // 2 x [kRows] lse*log2(e)
  float* sD = sL + 2 * kRows;                                    // 2 x [kRows] delta

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;    // mma fragment row group / thread in group
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: which 8x8 matrix, which row
  const int grp = warp % 4;                // key group (and, for dQ, row group)
  const int c0 = (warp / 4) * DPS;         // first dK/dV/dQ column of this warp
  const int nvec = D / 8;
  const __nv_bfloat16* qbase = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* dobase = dO + b * dos.b + h * dos.h;
  const float* lrow = lse + (long long)bh * Sq;
  const float* drow = delta + (long long)bh * Sq;

  // the rows of one Q step: Q and dO by cp.async, lse and delta by plain
  // loads (visible after the __syncthreads that precedes their use)
  auto load_rows = [&](int buf, int r0) {
    load_tile<kRows, DP, LD, kThreads>(sQ + buf * kRows * LD, qbase, qs.s, r0, Sq, nvec);
    load_tile<kRows, DP, LD, kThreads>(sdO + buf * kRows * LD, dobase, dos.s, r0, Sq, nvec);
    for (int i = threadIdx.x; i < kRows; i += kThreads) {
      const int row = r0 + i;
      sL[buf * kRows + i] = row < Sq ? lrow[row] * kLog2e : INFINITY;
      sD[buf * kRows + i] = row < Sq ? drow[row] : 0.f;
    }
  };

  load_tile<kRows, DP, LD, kThreads>(sK, k + b * ks.b + h * ks.h, ks.s, k0, Sk, nvec);
  load_tile<kRows, DP, LD, kThreads>(sV, v + b * vs.b + h * vs.h, vs.s, k0, Sk, nvec);
  load_rows(0, 0);
  cp_async_commit();

  float dk_acc[NTS][4], dv_acc[NTS][4];
  #pragma unroll
  for (int n = 0; n < NTS; ++n) {
    #pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[n][c] = dv_acc[n][c] = 0.f;
  }
  const __nv_bfloat16* kA = sK + (grp * 16 + (mi % 2) * 8 + mr) * LD + (mi / 2) * 8;
  const __nv_bfloat16* vA = sV + (grp * 16 + (mi % 2) * 8 + mr) * LD + (mi / 2) * 8;

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
    const __nv_bfloat16* tQ = sQ + buf * kRows * LD;
    const __nv_bfloat16* tdO = sdO + buf * kRows * LD;
    const float* tL = sL + buf * kRows;
    const float* tD = sD + buf * kRows;

    // The step's 64 rows in sub-steps of RS rows (64, or 16 at d = 256,
    // where the S^T and dP^T fragments of 64 rows would not fit beside the
    // dK and dV accumulators): each sub-step computes its P^T and dS^T, adds
    // its rows' share of dV and dK and leaves its dS^T columns in shared
    // memory for the dQ product below (not unrolled: one sub-step's
    // fragments are dead before the next one's are live)
    #pragma unroll 1
    for (int r0 = 0; r0 < kRows; r0 += RS) {
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x RS rows, as NJ tiles of 8 rows
      float s[NJ][4], dp[NJ][4];
      #pragma unroll
      for (int j = 0; j < NJ; ++j) {
        #pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
      }
      #pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, kA + kk * 16);
        ldmatrix_x4(va, vA + kk * 16);
        #pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          const int off = (r0 + jp * 16 + (mi / 2) * 8 + mr) * LD + kk * 16 + (mi % 2) * 8;
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
        for (int np = 0; np < NTS / 2; ++np) {
          const int off =
              (r0 + kk * 16 + (mi % 2) * 8 + mr) * LD + c0 + np * 16 + (mi / 2) * 8;
          uint32_t bo[4], bq[4];
          ldmatrix_x4_trans(bo, tdO + off);
          mma_bf16(dv_acc[2 * np], pa, bo[0], bo[1]);
          mma_bf16(dv_acc[2 * np + 1], pa, bo[2], bo[3]);
          ldmatrix_x4_trans(bq, tQ + off);
          mma_bf16(dk_acc[2 * np], da, bq[0], bq[1]);
          mma_bf16(dk_acc[2 * np + 1], da, bq[2], bq[3]);
        }
      }

      // dS^T (bf16) to shared memory; with DSPLIT = 2 both warps of a key
      // group hold the same values and the first writes them
      if (warp < 4) {
        #pragma unroll
        for (int j = 0; j < NJ; ++j) {
          #pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<uint32_t*>(sdS + (grp * 16 + g + 8 * r) * LDS + r0 + j * 8 +
                                         2 * t) = pack_bf16(dp[j][2 * r], dp[j][2 * r + 1]);
        }
      }
    }
    __syncthreads();

    // dQ[rows grp*16 .. +16, columns c0 .. c0 + DPS) += dS K over the 64 keys;
    // dS is read from dS^T with ldmatrix.trans
    uint32_t sa[4][4];
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4_trans(sa[kk], sdS + (kk * 16 + (mi / 2) * 8 + mr) * LDS + grp * 16 +
                                    (mi % 2) * 8);
    const int q0 = it * kRows + grp * 16;
    #pragma unroll
    for (int np = 0; np < NTS / 2; ++np) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      #pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, sK + (kk * 16 + (mi % 2) * 8 + mr) * LD + c0 + np * 16 +
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
  for (int n = 0; n < NTS; ++n) {
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

template <int DP, int DSPLIT, int RS = kRows>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dO,
                   const void* lse, const void* delta, void* dq_acc, void* dk, void* dv,
                   int B, int H, int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs,
                   Strides dos, Strides dks, Strides dvs, float scale, cudaStream_t stream) {
  constexpr size_t smem = (size_t)6 * kRows * (DP + 8) * sizeof(__nv_bfloat16) +
                          (size_t)kRows * (kRows + 8) * sizeof(__nv_bfloat16) +
                          (size_t)4 * kRows * sizeof(float);
  static bool allowed[kMaxDevices] = {};
  const cudaError_t attr =
      allow_dynamic_smem(flash_bwd_kernel<DP, DSPLIT, RS>, (int)smem, allowed);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Sk + kRows - 1) / kRows, B * H);
  flash_bwd_kernel<DP, DSPLIT, RS><<<grid, 4 * DSPLIT * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_acc), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Sq, Sk, D, qs, ks, vs, dos, dks, dvs, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o, dO, dk, dv: bf16 [B, S, H, D] with the given element strides
// (D contiguous, D % 8 == 0, D <= 256, every stride % 8 == 0, 16-byte aligned
// pointers).  lse: f32 [B, H, Sq] from K1, contiguous.  delta: f32 scratch
// [B, H, Sq]; dq_acc: f32 scratch [B, Sq, H, D]; dq: bf16 [B, Sq, H, D]; all
// three contiguous.  Launches three kernels in order on the stream; returns
// the first CUDA error code (0 on success).
extern "C" int dmtpu_flash_attn_bwd_mma(
    const void* q, const void* k, const void* v, const void* o, const void* dO, const void* lse,
    void* delta, void* dq_acc, void* dq, void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb, long long oss, long long osh,
    long long dosb, long long doss, long long dosh, long long dksb, long long dkss, long long dksh,
    long long dvsb, long long dvss, long long dvsh, float scale, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh},
      dos{dosb, doss, dosh}, dks{dksb, dkss, dksh}, dvs{dvsb, dvss, dvsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 8 || D > 256) return (int)cudaErrorInvalidValue;
  return run_flash_bwd_mma(o, dO, delta, dq_acc, dq, B, H, Sq, D, os, dos, st, [&] {
    if (D <= 48)
      return launch<48, 1>(q, k, v, dO, lse, delta, dq_acc, dk, dv, B, H, Sq, Sk, D, qs, ks, vs,
                           dos, dks, dvs, scale, st);
    if (D <= 80)
      return launch<80, 1>(q, k, v, dO, lse, delta, dq_acc, dk, dv, B, H, Sq, Sk, D, qs, ks, vs,
                           dos, dks, dvs, scale, st);
    if (D <= 160)
      return launch<160, 2>(q, k, v, dO, lse, delta, dq_acc, dk, dv, B, H, Sq, Sk, D, qs, ks,
                            vs, dos, dks, dvs, scale, st);
    return launch<256, 2, 16>(q, k, v, dO, lse, delta, dq_acc, dk, dv, B, H, Sq, Sk, D, qs, ks,
                              vs, dos, dks, dvs, scale, st);
  });
}
