// K2: fused non-causal attention backward for Hopper (sm_90a), bf16 in and out:
// the kernel of the large self-attention shapes (head dims 40 and 80).
//
// Replaces dmtpu/ops/flash_small_d.py::_bwd_kernel / _bwd (the Pallas TPU
// fused backward for small head dims), the backward role of the stock Pallas
// TPU flash kernel that dmtpu/ops/attention.py::flash_mha calls, and the probe
// variant benchmarks/_smalld_variants.py::_bwd_sem (the same function).  Shapes
// it does not take (head dim 160 and every head dim other than 40 and 80, a
// broadcast q, k, v or dO) go to the mma.sync kernel in
// flash_attn_bwd_mma.cu; the gate is in dmtpu_torch/ops/flash_attention.py.
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
// What bounds it on this card: operations.  Five products per pair of a key
// tile and a row tile on the tensor cores, one exponential per logit on the
// special-function units (16 a clock on each SM: at d=40 they take two thirds
// of the products' time), and dQ, whose sum runs over key tiles that live on
// different SMs.  The design:
//   - a CTA per (b*h, 128-key tile): K and V arrive once by TMA (boxes of 64
//     columns in the 128-byte swizzle; columns past D are out of bounds and
//     zero-filled without being read) and stay in shared memory.  One producer
//     thread keeps two stages in flight, each the Q and dO tiles of one step
//     (128 rows at d=40, 64 at d=80: what the registers hold) plus those
//     rows' lse * log2(e) and delta, through full / empty mbarriers;
//     setmaxnreg gives the producer's registers to the consumers (24 / 240);
//   - two consumer warpgroups of 64 keys each.  S^T = K Q^T and dP^T = V dO^T
//     are wgmma m64n128k16 (m64n64k16 at d=80) with both operands in shared
//     memory, so P^T and dS^T come out in the accumulator layout and feed
//     dV += P^T dO and dK += dS^T Q as register-A wgmma of width D (n40, n80:
//     no padded columns), with dO and Q read through the transposing
//     descriptor.  The two warpgroups run unsynchronised, so one's
//     exponentials fall under the other's products, and each issues the next
//     step's S^T and dP^T before it moves this step's dQ out;
//   - dQ = dS K: dS^T goes to shared memory once (bf16, in the swizzle a TMA
//     load would have written, two buffers in turn) and is read back as the A
//     operand through the transposing descriptor, 64 rows a product, K as B
//     through its own;
//   - dQ leaves the CTA as whole tiles, not scalars: on the TPU dQ lived in one
//     VMEM block across a sequential sweep of the key tiles, which no grid of
//     CTAs has.  Here warpgroup 1 hands its f32 half of a step's dQ to
//     warpgroup 0 through shared memory (its thread of the same place holds
//     the same elements; two named barriers), which halves what leaves the
//     CTA: the adds below run at the rate the L2 cache takes them (while each
//     warpgroup added its own half they were 17% of the d=80 kernel's time
//     at S=1024, b16 h8, on an NVIDIA H100 80GB HBM3 at 700 W; now 2%).
//     Warpgroup 0 puts the sum into
//     shared memory as [rows][D] f32 and each of its warps adds its 16 rows
//     into a zeroed f32 buffer [B*H, S_q, D] with one cp.reduce.async.bulk
//     (16 rows are contiguous there); the last pass rounds the buffer to bf16
//     into [B, S_q, H, D].  The adds of different CTAs arrive in an order
//     that varies from run to run, so dQ is not bitwise reproducible: it may
//     differ between runs by a few f32 ulps of its partial sums before the
//     bf16 rounding;
//   - one key tile (S_k <= 128, cross-attention to 77 tokens): the CTA holds
//     every contribution to its dQ rows, so warpgroup 0 writes the sum in
//     bf16 itself: no zeroing, no f32 buffer, no cast pass, and dQ is the
//     same bit for bit in every run;
//   - ragged lengths: the first pass pads lse and delta to whole steps with
//     +inf and 0, so rows past S_q (zero-filled by TMA) give P = 0 and add
//     zeros; keys past S_k give P = 0 and write no dK / dV rows.
// Not yet: with one key tile a CTA per (b, h) still walks every Q row alone,
// its second warpgroup on 13 of its 64 keys.
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace dmtpu;

constexpr int kKeys = 128;                 // keys per CTA: two consumer warpgroups x 64
constexpr int kThreads = 384;              // producer warpgroup + two consumer warpgroups
constexpr int kAtomBytes = 1024;           // 8 rows x 128 bytes: the swizzle's period
constexpr int kKvTileBytes = kKeys * 128;  // [128 keys][64 bf16], swizzled
constexpr int kDsBlockBytes = 64 * 128;    // dS^T of 64 keys x 64 rows, bf16, swizzled
constexpr float kLog2e = 1.4426950408889634f;

// Q rows per step of a CTA's loop: as many as the registers hold.  Per thread
// S^T and dP^T take ROWS / 2 f32 registers each, dK, dV and a 64-row part of
// dQ D / 2 each.
constexpr int rows_per_step(int D) { return D == 40 ? 128 : 64; }

template <int D>
struct Config {
  static constexpr int kRows = rows_per_step(D);
  static constexpr int kColTiles = (D + 63) / 64;   // 64-column tiles per row
  static constexpr int kSteps = (D + 15) / 16;      // k16 steps of S^T and dP^T
  static constexpr int kStages = 2;
  static constexpr int kAcc = D / 2;                // f32 registers of a [64 x D] accumulator
  static constexpr int kRowTileBytes = kRows * 128;  // [rows][64 bf16], swizzled
  static constexpr int kKvBytes = kColTiles * kKvTileBytes;     // K, or V
  static constexpr int kTileBytes = kColTiles * kRowTileBytes;  // Q, or dO, of one stage
  static constexpr int kDsBytes = kRows / 64 * kDsBlockBytes;   // one warpgroup's dS^T
  static constexpr int kDqBytes = kRows * D * 4;    // one warpgroup's f32 dQ partial
  static constexpr int kStatBytes = 2 * kRows * 4;  // lse * log2(e) and delta of a stage's rows
  static constexpr int kBarriers = 1 + 2 * kStages;
  // 1024 spare bytes to align the tiles; dS^T is double-buffered
  static constexpr int kSmem = kAtomBytes + 2 * kKvBytes + 2 * kStages * kTileBytes +
                               4 * kDsBytes + 2 * kDqBytes + kStages * kStatBytes + 8 * kBarriers;
};

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (D == 40) wgmma_rs_n40(d, a, desc, 1);
  if constexpr (D == 80) wgmma_rs_n80(d, a, desc, 1);
}

template <int D>
__device__ __forceinline__ void wgmma_tt(float (&d)[D / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  if constexpr (D == 40) wgmma_ss_tt_n40(d, desc_a, desc_b, scale_d);
  if constexpr (D == 80) wgmma_ss_tt_n80(d, desc_a, desc_b, scale_d);
}

// acc[64 keys x rows] = a_rows (K or V, this warpgroup's 64 keys) * b_tile^T
// (Q or dO, one stage) over the head dim (not committed).
template <int D>
__device__ __forceinline__ void issue_transposed(float (&acc)[Config<D>::kRows / 2],
                                                 const unsigned char* a_rows,
                                                 const unsigned char* b_tile) {
#pragma unroll
  for (int kk = 0; kk < Config<D>::kSteps; ++kk) {
    const uint64_t a =
        wgmma_desc(a_rows + (kk / 4) * kKvTileBytes + (kk % 4) * 32, 16, kAtomBytes);
    const uint64_t b = wgmma_desc(b_tile + (kk / 4) * Config<D>::kRowTileBytes + (kk % 4) * 32, 16,
                                  kAtomBytes);
    if constexpr (Config<D>::kRows == 64) {
      if (kk == 0) wgmma_ss_n64_first(acc, a, b);
      else wgmma_ss_n64(acc, a, b, 1);
    } else {
      if (kk == 0) wgmma_ss_n128_first(acc, a, b);
      else wgmma_ss_n128(acc, a, b, 1);
    }
  }
}

// The A operands of the next product from a [64 x 16 NK] accumulator: k16
// step kk is its 8-column blocks 2kk and 2kk + 1.
template <int NK>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NK][4], const float (&c)[8 * NK]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// ONE_TILE: the grid has a single key tile per (b, h) (S_k <= 128), so the CTA
// holds every contribution to its dQ rows and writes them in bf16 itself, to
// dq [B, Sq, H, D]; otherwise it adds f32 partial sums into dq_acc [B*H, Sp, D].
template <int D, bool ONE_TILE>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ stat, float* __restrict__ dq_acc,
                       __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int H, int Sq, int Sp, int Sk,
                       long long stat_rows, Strides dks, Strides dvs, float scale,
                       float scale_log2) {
  using Cfg = Config<D>;
  constexpr int kStages = Cfg::kStages;
  constexpr int kRows = Cfg::kRows;
  constexpr int kBlocks = kRows / 8;   // 8-row blocks of a step: accumulator column blocks
  constexpr int kParts = kRows / 64;   // 64-row parts of a step: the M of a dQ product
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kAtomBytes - smem_addr(smem_raw) % kAtomBytes) % kAtomBytes);
  unsigned char* sK = smem;                             // [col tile][128 keys][128 B]
  unsigned char* sV = sK + Cfg::kKvBytes;               // the same
  unsigned char* sQ = sV + Cfg::kKvBytes;               // [stage][col tile][rows][128 B]
  unsigned char* sdO = sQ + kStages * Cfg::kTileBytes;   // the same
  unsigned char* sdS = sdO + kStages * Cfg::kTileBytes;  // [warpgroup][2][part][64 keys][128 B]
  float* sdQ = reinterpret_cast<float*>(sdS + 4 * Cfg::kDsBytes);  // [warpgroup][rows][D] f32
  float* sStat = sdQ + 2 * kRows * D;                   // [stage][lse * log2(e), delta][rows]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sStat + kStages * 2 * kRows);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kKeys;
  const int nsteps = Sp / kRows;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * Cfg::kKvBytes);
      for (int c = 0; c < Cfg::kColTiles; ++c) {
        tma_load_4d(sK + c * kKvTileBytes, &map_k, kv_full, c * 64, h, k0, b);
        tma_load_4d(sV + c * kKvTileBytes, &map_v, kv_full, c * 64, h, k0, b);
      }
      const float* lrow = stat + (long long)bh * Sp;
      const float* drow = lrow + stat_rows;
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < nsteps; ++it) {
        mbar_wait(empty + stage, phase ^ 1);  // passes at once the first time round
        mbar_arrive_expect_tx(full + stage, 2 * Cfg::kTileBytes + Cfg::kStatBytes);
        for (int c = 0; c < Cfg::kColTiles; ++c) {
          tma_load_4d(sQ + stage * Cfg::kTileBytes + c * Cfg::kRowTileBytes, &map_q, full + stage,
                      c * 64, h, it * kRows, b);
          tma_load_4d(sdO + stage * Cfg::kTileBytes + c * Cfg::kRowTileBytes, &map_do,
                      full + stage, c * 64, h, it * kRows, b);
        }
        bulk_load(sStat + stage * 2 * kRows, lrow + it * kRows, kRows * 4, full + stage);
        bulk_load(sStat + stage * 2 * kRows + kRows, drow + it * kRows, kRows * 4, full + stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 keys each ----
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const unsigned char* k_rows = sK + wg * 64 * 128;  // keys 64 wg.. of each column tile
    const unsigned char* v_rows = sV + wg * 64 * 128;
    unsigned char* ds = sdS + wg * 2 * Cfg::kDsBytes;
    float* dq_stage = sdQ + wg * kRows * D;
    float* dq_out = dq_acc + ((long long)bh * Sp) * D;
    __nv_bfloat16* dq_rows = dq + ((long long)b * Sq * H + h) * D + 2 * t;
    // this thread's accumulator rows: keys key0 and key0 + 8 of the sequence,
    // rows 16 warp + g (+ 8) of the warpgroup's tiles
    const int key0 = k0 + wg * 64 + warp * 16 + g;
    const bool key_ok[2] = {key0 < Sk, key0 + 8 < Sk};
    const bool ragged_keys = k0 + kKeys > Sk;
    const int ds_row = (warp * 16 + g) * 128 + 4 * t;
    float* dq_row = dq_stage + (warp * 16 + g) * D + 2 * t;

    float dk_acc[Cfg::kAcc], dv_acc[Cfg::kAcc];
#pragma unroll
    for (int i = 0; i < Cfg::kAcc; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    float s[kRows / 2], dp[kRows / 2];
    uint32_t pa[kRows / 16][4], da[kRows / 16][4];

    // the two warpgroups' halves of a step's dQ meet in shared memory: named
    // barrier 3 says warpgroup 1 has written its half to its staging rows, 4
    // that warpgroup 0 has read it
    if (wg == 0) named_arrive(4, 256);

    // S^T = K Q^T and dP^T = V dO^T of the first step: 64 keys x rows each
    mbar_wait(kv_full, 0);
    mbar_wait(full, 0);
    wgmma_fence();
    issue_transposed<D>(s, k_rows, sQ);
    issue_transposed<D>(dp, v_rows, sdO);
    wgmma_commit();
    wgmma_wait<0>();

    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < nsteps; ++it) {
      const unsigned char* q_tile = sQ + stage * Cfg::kTileBytes;
      const unsigned char* do_tile = sdO + stage * Cfg::kTileBytes;
      const float2* lse2 = reinterpret_cast<const float2*>(sStat + stage * 2 * kRows);
      const float2* delta2 = lse2 + kRows / 2;
      unsigned char* ds_now = ds + (it & 1) * Cfg::kDsBytes;

      // P^T and dS^T in place; element 4j + 2r + c is key key0 + 8r, row
      // 8j + 2t + c of the step
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < kBlocks; ++j) {
        const float2 l = lse2[4 * j + t];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          s[4 * j + 2 * r] = ex2(fmaf(s[4 * j + 2 * r], scale_log2, -l.x));
          s[4 * j + 2 * r + 1] = ex2(fmaf(s[4 * j + 2 * r + 1], scale_log2, -l.y));
        }
      }
      if (ragged_keys) {  // the last key tile: P = 0 for the keys past S_k
#pragma unroll
        for (int i = 0; i < kRows / 2; ++i)
          if (!key_ok[(i / 2) & 1]) s[i] = 0.f;
      }
      pack_a(pa, s);
#pragma unroll
      for (int j = 0; j < kBlocks; ++j) {
        const float2 dl = delta2[4 * j + t];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dp[4 * j + 2 * r] = s[4 * j + 2 * r] * (dp[4 * j + 2 * r] - dl.x) * scale;
          dp[4 * j + 2 * r + 1] = s[4 * j + 2 * r + 1] * (dp[4 * j + 2 * r + 1] - dl.y) * scale;
        }
      }
      pack_a(da, dp);

      // dV += P^T dO and dK += dS^T Q: A from registers, 16 rows a step
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_rs<D>(dv_acc, pa[kk],
                    wgmma_desc(do_tile + kk * 2048, Cfg::kRowTileBytes, kAtomBytes));
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_rs<D>(dk_acc, da[kk], wgmma_desc(q_tile + kk * 2048, Cfg::kRowTileBytes, kAtomBytes));
      wgmma_commit();

      // dS^T (bf16) to shared memory as 64-row parts of [key][row], the
      // 16-byte chunk c of key row k at chunk c ^ (k % 8): the 128-byte
      // swizzle.  Two buffers take turns: the product that read this one
      // two steps ago was waited for by every warp before the last barrier.
#pragma unroll
      for (int j = 0; j < kBlocks; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(ds_now + (j / 8) * kDsBlockBytes + ds_row + r * 8 * 128 +
                                       (((j % 8) ^ g) << 4)) = da[j / 2][(j % 2) * 2 + r];
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);

      // dQ partial = dS K over this warpgroup's 64 keys, 16 keys a step, 64
      // rows a part
      float dq[kParts][Cfg::kAcc];
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_tt<D>(dq[part],
                      wgmma_desc(ds_now + part * kDsBlockBytes + kk * 2048, kDsBlockBytes,
                                 kAtomBytes),
                      wgmma_desc(k_rows + kk * 2048, kKvTileBytes, kAtomBytes), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int part = 0; part < kParts; ++part) fence_regs(dq[part]);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      if (lane == 0) mbar_arrive(empty + stage);  // this warp is done with the stage
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }

      // the next step's S^T and dP^T run under this step's dQ traffic.  They
      // are issued after the last step too, on a stale stage and for nothing:
      // issued under a condition, ptxas serialises them for want of registers
      if (it + 1 < nsteps) mbar_wait(full + stage, phase);
      wgmma_fence();
      issue_transposed<D>(s, k_rows, sQ + stage * Cfg::kTileBytes);
      issue_transposed<D>(dp, v_rows, sdO + stage * Cfg::kTileBytes);
      wgmma_commit();

      // this thread's part of dQ as [rows][D] f32 in the staging rows
      auto stage_dq = [&] {
#pragma unroll
        for (int part = 0; part < kParts; ++part) {
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
#pragma unroll
            for (int r = 0; r < 2; ++r)
              *reinterpret_cast<float2*>(dq_row + (part * 64 + r * 8) * D + 8 * j) =
                  make_float2(dq[part][4 * j + 2 * r], dq[part][4 * j + 2 * r + 1]);
          }
        }
      };
      if (wg == 1) {
        named_sync(4, 256);
        stage_dq();
        named_arrive(3, 256);
      } else {
        // the other warpgroup's thread of the same place holds the same
        // elements over its 64 keys: add them
        named_sync(3, 256);
#pragma unroll
        for (int part = 0; part < kParts; ++part) {
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float2 other = *reinterpret_cast<const float2*>(
                  dq_row + kRows * D + (part * 64 + r * 8) * D + 8 * j);
              dq[part][4 * j + 2 * r] += other.x;
              dq[part][4 * j + 2 * r + 1] += other.y;
            }
          }
        }
        named_arrive(4, 256);
        if constexpr (ONE_TILE) {
          // every contribution to these rows is here: write them in bf16
#pragma unroll
          for (int part = 0; part < kParts; ++part) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = it * kRows + part * 64 + warp * 16 + g + 8 * r;
              if (row >= Sq) continue;
#pragma unroll
              for (int j = 0; j < D / 8; ++j)
                *reinterpret_cast<uint32_t*>(dq_rows + (long long)row * H * D + 8 * j) =
                    pack_bf16(dq[part][4 * j + 2 * r], dq[part][4 * j + 2 * r + 1]);
            }
          }
        } else {
          // each warp adds its 16 rows of every part into the dQ buffer with
          // one bulk operation, once the last step's have read the staging rows
          if (lane == 0) bulk_wait_read();
          __syncwarp();
          stage_dq();
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) {
#pragma unroll
            for (int part = 0; part < kParts; ++part) {
              const int row = part * 64 + warp * 16;
              bulk_reduce_add_f32(dq_out + ((long long)it * kRows + row) * D,
                                  dq_stage + row * D, 16 * D * 4);
            }
            bulk_commit();
          }
        }
      }
      wgmma_wait<0>();  // the next step's S^T and dP^T
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= Sk) continue;
      __nv_bfloat16* krow = dk + b * dks.b + (long long)key * dks.s + h * dks.h + 2 * t;
      __nv_bfloat16* vrow = dv + b * dvs.b + (long long)key * dvs.s + h * dvs.h + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(krow + 8 * n) =
            pack_bf16(dk_acc[4 * n + 2 * r], dk_acc[4 * n + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(vrow + 8 * n) =
            pack_bf16(dv_acc[4 * n + 2 * r], dv_acc[4 * n + 2 * r + 1]);
      }
    }
    // the last adds have left shared memory before the CTA ends
    if (!ONE_TILE && wg == 0 && lane == 0) bulk_wait();
  }
}

// First pass, one thread per (b, s, h) row of the padded length Sp (a
// multiple of the rows of a step): stat[0][b, h, s] = lse * log2(e) and stat[1][b, h, s] =
// delta = sum_d dO * O in f32, or +inf and 0 for the rows past Sq; and every
// block zeroes its share of the f32 dQ buffer (acc_vec4 float4 values; none
// when the main kernel writes dQ itself).
template <int D>
__global__ void flash_bwd_wgmma_prep_kernel(const __nv_bfloat16* __restrict__ o,
                                            const __nv_bfloat16* __restrict__ dO,
                                            const float* __restrict__ lse,
                                            float* __restrict__ stat, float4* __restrict__ dq_acc,
                                            long long acc_vec4, int B, int H, int Sq, int Sp,
                                            Strides os, Strides dos) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stat_rows = (long long)B * H * Sp;
  if (row < stat_rows) {
    const int h = row % H;
    const int s = (row / H) % Sp;
    const int b = row / ((long long)H * Sp);
    float l = INFINITY, acc = 0.f;
    if (s < Sq) {
      const __nv_bfloat16* orow = o + b * os.b + (long long)s * os.s + h * os.h;
      const __nv_bfloat16* drow = dO + b * dos.b + (long long)s * dos.s + h * dos.h;
      // the row's loads are all in flight at once: D is known, the loop unrolls
      uint4 ov[D / 8], dv[D / 8];
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        ov[c] = reinterpret_cast<const uint4*>(orow)[c];
        dv[c] = reinterpret_cast<const uint4*>(drow)[c];
      }
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov[c]);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv[c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 a = __bfloat1622float2(o2[i]), e = __bfloat1622float2(d2[i]);
          acc += a.x * e.x + a.y * e.y;
        }
      }
      l = lse[((long long)b * H + h) * Sq + s] * kLog2e;
    }
    const long long at = ((long long)b * H + h) * Sp + s;
    stat[at] = l;
    stat[stat_rows + at] = acc;
  }
  const long long share = (acc_vec4 + gridDim.x - 1) / gridDim.x;
  const long long begin = blockIdx.x * share;
  const long long end = begin + share < acc_vec4 ? begin + share : acc_vec4;
  for (long long i = begin + threadIdx.x; i < end; i += blockDim.x)
    dq_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Last pass: dq[b, s, h, :] = bf16(dq_acc[b, h, s, :]), 8 values a thread; dq
// is contiguous [B, Sq, H, D], dq_acc [B, H, Sp, D].
__global__ void flash_bwd_wgmma_cast_kernel(const float* __restrict__ dq_acc,
                                            __nv_bfloat16* __restrict__ dq, int B, int H, int Sq,
                                            int Sp, int D) {
  const int nvec = D / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * Sq * H * nvec) return;
  const int c = i % nvec;
  const int h = (i / nvec) % H;
  const int s = (i / ((long long)nvec * H)) % Sq;
  const int b = i / ((long long)nvec * H * Sq);
  const float4* src =
      reinterpret_cast<const float4*>(dq_acc + (((long long)b * H + h) * Sp + s) * D + c * 8);
  const float4 lo = src[0], hi = src[1];
  const uint4 out{pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                  pack_bf16(hi.z, hi.w)};
  reinterpret_cast<uint4*>(dq)[i] = out;
}

template <int D, bool ONE_TILE>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dO, const float* stat,
                   float* dq_acc, void* dq, void* dk, void* dv, int B, int H, int Sq, int Sp,
                   int Sk, Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
                   Strides dvs, float scale, cudaStream_t stream) {
  static bool allowed[kMaxDevices] = {};
  const cudaError_t attr =
      allow_dynamic_smem(flash_bwd_wgmma_kernel<D, ONE_TILE>, Config<D>::kSmem, allowed);
  if (attr != cudaSuccess) return attr;
  alignas(64) CUtensorMap mq, mk, mv, mdo;
  if (!make_bshd_map(&mq, q, B, H, Sq, D, qs, Config<D>::kRows) ||
      !make_bshd_map(&mk, k, B, H, Sk, D, ks, kKeys) ||
      !make_bshd_map(&mv, v, B, H, Sk, D, vs, kKeys) ||
      !make_bshd_map(&mdo, dO, B, H, Sq, D, dos, Config<D>::kRows))
    return cudaErrorInvalidValue;
  const dim3 grid((Sk + kKeys - 1) / kKeys, B * H);
  flash_bwd_wgmma_kernel<D, ONE_TILE><<<grid, kThreads, Config<D>::kSmem, stream>>>(
      mq, mk, mv, mdo, stat, dq_acc, static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Sq, Sp, Sk,
      (long long)B * H * Sp, dks, dvs, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o, dO, dk, dv: bf16 [B, S, H, D] with the given element strides
// (D contiguous, D 40 or 80, every stride a positive multiple of 8, 16-byte
// aligned pointers).  lse: f32 [B, H, Sq] from K1, contiguous.  With Sp = Sq
// rounded up to a multiple of 128 (D 40) or 64 (D 80): stat: f32 scratch
// [2, B, H, Sp]; dq_acc: f32 scratch [B, H, Sp, D], 16-byte aligned, not
// touched when Sk <= 128; dq: bf16 [B, Sq, H, D], contiguous.  Launches three
// kernels in order on the stream (two when Sk <= 128); returns the first CUDA
// error code (0 on success; cudaErrorInvalidValue for a head dim or strides
// it does not take).
extern "C" int dmtpu_flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dO, const void* lse,
    void* stat, void* dq_acc, void* dq, void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb, long long oss, long long osh,
    long long dosb, long long doss, long long dosh, long long dksb, long long dkss, long long dksh,
    long long dvsb, long long dvss, long long dvsh, float scale, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh},
      dos{dosb, doss, dosh}, dks{dksb, dkss, dksh}, dvs{dvsb, dvss, dvsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 40 && D != 80) return (int)cudaErrorInvalidValue;
  const bool one_tile = Sk <= kKeys;
  const int Sp = (Sq + rows_per_step(D) - 1) / rows_per_step(D) * rows_per_step(D);
  const long long rows = (long long)B * H * Sp;
  const auto prep = D == 40 ? flash_bwd_wgmma_prep_kernel<40> : flash_bwd_wgmma_prep_kernel<80>;
  prep<<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dO),
      static_cast<const float*>(lse), static_cast<float*>(stat), static_cast<float4*>(dq_acc),
      one_tile ? 0 : rows * D / 4, B, H, Sq, Sp, os, dos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* st_in = static_cast<const float*>(stat);
  float* acc = static_cast<float*>(dq_acc);
  if (D == 40 && one_tile)
    err = launch<40, true>(q, k, v, dO, st_in, acc, dq, dk, dv, B, H, Sq, Sp, Sk, qs, ks, vs, dos,
                           dks, dvs, scale, st);
  else if (D == 40)
    err = launch<40, false>(q, k, v, dO, st_in, acc, dq, dk, dv, B, H, Sq, Sp, Sk, qs, ks, vs,
                            dos, dks, dvs, scale, st);
  else if (one_tile)
    err = launch<80, true>(q, k, v, dO, st_in, acc, dq, dk, dv, B, H, Sq, Sp, Sk, qs, ks, vs, dos,
                           dks, dvs, scale, st);
  else
    err = launch<80, false>(q, k, v, dO, st_in, acc, dq, dk, dv, B, H, Sq, Sp, Sk, qs, ks, vs,
                            dos, dks, dvs, scale, st);
  if (err != cudaSuccess || one_tile) return (int)err;
  const long long n8 = (long long)B * Sq * H * D / 8;
  flash_bwd_wgmma_cast_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>(
      acc, static_cast<__nv_bfloat16*>(dq), B, H, Sq, Sp, D);
  return (int)cudaGetLastError();
}
