// K2: fused non-causal attention backward for Hopper (sm_90a), bf16 in and out:
// the kernel of every K2 call of the repository's paths (SD1.5's 40, 80 and
// 160, DiT's 72, MMDiT's 64, the pixel UNets' 256, CelebA-HQ's 512).
//
// Replaces dmtpu/ops/flash_small_d.py::_bwd_kernel / _bwd (the Pallas TPU
// fused backward for small head dims), the backward role of the stock Pallas
// TPU flash kernel that dmtpu/ops/attention.py::flash_mha calls, and the probe
// variant benchmarks/_smalld_variants.py::_bwd_sem (the same function).  Shapes
// it does not take (head dims below 40, 48 and 56, a broadcast q, k, v or
// dO) go to the mma.sync kernels in flash_attn_bwd_mma.cu and
// flash_attn_bwd_mma_d512.cu; the gate is in dmtpu_torch/ops/flash_attention.py.
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
//     (128 rows at d=40, 64 at d=64, d=72 and d=80: what the registers hold) plus those
//     rows' lse * log2(e) and delta, through full / empty mbarriers;
//     setmaxnreg gives the producer's registers to the consumers (24 / 240);
//   - two consumer warpgroups of 64 keys each.  S^T = K Q^T and dP^T = V dO^T
//     are wgmma m64n128k16 (m64n64k16 at d=64, d=72 and d=80) with both operands
//     in shared memory, so P^T and dS^T come out in the accumulator layout
//     and feed dV += P^T dO and dK += dS^T Q as register-A wgmma of width D
//     (n40, n64, n72, n80: no padded columns), with dO and Q read through the
//     transposing descriptor.  At d=64 a row is one 64-column tile, four k16
//     steps with no zero-filled column.  At d=72 a row spans two 64-column tiles: the
//     k16 steps of S^T and dP^T run over 80 columns, the last 8 zero-filled
//     by TMA (its box of 64 columns counts all its bytes toward the barrier),
//     and the N=72 products take their B operand from all of tile 0 and 8
//     columns of tile 1 through the descriptor's stride between tiles.  The two warpgroups run unsynchronised, so one's
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
//
// Head dims 88 to 256 (SD1.5's 160, the pixel UNets' 256) run on a second
// kernel, flash_bwd_split_kernel, instantiated at 160 and 256 (a head dim
// between runs on the wider one, its columns past the head dim zero-filled
// by TMA and not written).  The layout above does not stretch there: a
// warpgroup of 64 keys would hold dK and dV over the whole head (160 or 256
// registers a thread) beside S^T, dP^T and a dQ part, past the 240 that
// setmaxnreg gives.  So:
//   - a CTA per (b*h, 64-key tile); both consumer warpgroups take all 64
//     keys, and each holds dK and dV for its share of the head's columns,
//     cut on 64-column tiles so that its B operands start on one: 64 and 96
//     at d=160, 128 and 128 at d=256 (dK + dV 64 to 128 registers a thread);
//   - of each 64-row step, warpgroup w computes S^T = K Q^T and dP^T = V dO^T
//     for rows 32w..32w+31 (m64n32k16 over the padded head), P^T and dS^T
//     from them, and writes both (bf16) into two shared [key][row] tiles in
//     the 128-byte swizzle; once both halves are there (named barrier 3),
//     each runs dV += P^T dO and dK += dS^T Q over all 64 rows and its
//     columns with A read from the tiles, and dQ = dS K over its columns and
//     the CTA's 64 keys with dS read back through the transposing descriptor
//     (in 64-column chunks at d=256: a 128-column accumulator beside dK's and
//     dV's spilled).  Named barrier 5 keeps the next step's tile writes
//     behind this step's products.  Computing S^T and dP^T for all 64 rows in
//     both warpgroups instead (7 products of the 5 a pass needs) measured 3
//     to 5% slower;
//   - dQ: a warpgroup's part is already the CTA's whole contribution to
//     those rows and columns, so nothing is summed between the warpgroups.
//     Once both are done with a step's Q and dO (named barrier 4), each
//     stages its part in f32 over those buffers ([rows][columns], each row
//     padded by 16 bytes: rows 256 to 512 bytes apart fell on the same banks)
//     and each of a warp's first 16 lanes adds one row into the f32 buffer
//     with cp.reduce.async.bulk; the stage goes back to the producer when
//     the adds have read it.  Q and dO take two stages of 64 rows (48 KB at
//     160, 64 KB at 256, the d=256 stage 66 KB to hold the padded rows), K
//     and V 64 keys: 165,928 and 219,176 bytes of shared memory;
//   - one key tile (S_k <= 64; CIFAR's S=16, SD1.5's S=64) writes dq in bf16
//     itself, as above.  SD1.5's 77-key cross-attentions at d=160 span two
//     tiles and add f32 sums;
//   - the first pass runs a warp per row (the row's 320 or 512 bytes in one
//     coalesced load) instead of a thread per row.
// What holds it back (NVIDIA H100 80GB HBM3, 700 W; k2_probe at the CIFAR
// UNet's b128 h1 S=256, about 0.17 ms of device time against a bound of
// 0.040): the f32 dQ traffic (its adds about 0.035 ms) and the first and
// last passes (0.024 and 0.018 ms: zeroing, delta, the cast).  Issuing the
// next step's S^T and dP^T under this step's dQ spilled 300 bytes at d=256
// and measured slower.
//
// Head dims 264 to 512 (CelebA-HQ's one head of 512) run on a third kernel,
// flash_bwd_pair_kernel, instantiated at 512.  One CTA cannot hold them: dK
// and dV of 64 keys over 512 columns are 256 registers a thread in each of
// two warpgroups, and full-depth 64-row tiles of K, V, Q and dO are 256 KB.
// So a cluster of two CTAs takes each 64-key tile, each CTA the split
// instance's layout over its half of the columns (K, V, Q and dO tiles of
// 256 columns; its two warpgroups on 128 columns each of dK, dV and dQ):
//   - S^T = K Q^T and dP^T = V dO^T run over 512 columns, so each CTA
//     computes the partial products over its 256: warpgroup 0 those of the
//     32 rows of the step that its CTA finishes (rows 32 rank..), warpgroup
//     1 those of the other CTA's 32, which it writes into that CTA's 16 KB
//     exchange buffer through distributed shared memory (st.shared::cluster,
//     the same register layout on both sides, f32);
//   - warpgroup 0 adds the other CTA's partials to its own (the same two
//     f32 values in the same order: both CTAs would compute the same bits),
//     forms P^T and dS^T (bf16) for its 32 rows and writes them into both
//     CTAs' [key][row] tiles; so each row's P^T and dS^T are computed once
//     in the cluster and both CTAs run dV, dK and dQ on the same bits;
//   - mbarriers in the CTA that waits, arrived on from the other one
//     (release / acquire at cluster scope): xfull / xempty for the exchange
//     buffer, tfull (both halves of a step's tiles are in) and tempty (both
//     CTAs' warps are done with the last step's tiles); the generic writes
//     into the other CTA's tiles are fenced for the asynchronous proxy
//     before wgmma reads them;
//   - dQ's f32 partial sums leave by cp.reduce.async.bulk as at 256, staged
//     over the step's Q and dO in two 64-column chunks a warpgroup (17 KB,
//     not the split instance's 66 KB stage), so that the exchange buffer
//     fits: 231,496 bytes of shared memory a CTA; with one key tile (S_k <=
//     64: CelebA-HQ's 8x8 level) each CTA writes its columns of dq in bf16,
//     the same bits in every run;
//   - a cluster barrier after the barriers' initialisation and one before
//     either CTA leaves, since each writes the other's shared memory.
// Measured (k2_probe d512, device time, NVIDIA H100 80GB HBM3 at 700 W):
// b16 h1 S=256 0.037 ms against mma.sync's 0.196 (bound 0.010); b128 0.43
// against 1.21 (bound 0.080): the exchange and its waits on top of the split
// instance's per-CTA time.
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
// dQ D / 2 each: at D=64 and 128 rows they would need 256 of the 240.  At
// D=64 shared memory holds 133,160 bytes, at D=72 202,792 (D=80: 206,888).
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
  if constexpr (D == 64) wgmma_rs_n64(d, a, desc, 1);
  if constexpr (D == 72) wgmma_rs_n72(d, a, desc, 1);
  if constexpr (D == 80) wgmma_rs_n80(d, a, desc, 1);
}

template <int D>
__device__ __forceinline__ void wgmma_tt(float (&d)[D / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  if constexpr (D == 40) wgmma_ss_tt_n40(d, desc_a, desc_b, scale_d);
  if constexpr (D == 64) wgmma_ss_tt_n64(d, desc_a, desc_b, scale_d);
  if constexpr (D == 72) wgmma_ss_tt_n72(d, desc_a, desc_b, scale_d);
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

// ---- head dims 88-256: both consumer warpgroups on the same 64 keys -------

// Instance W (160 or 256) of the column-split kernel (see the top).
template <int W>
struct SplitConfig {
  static constexpr int kKeys = 64;                   // keys per CTA
  static constexpr int kRows = 64;                   // Q rows per step
  static constexpr int kColTiles = (W + 63) / 64;    // 64-column tiles per row: 3 or 4
  static constexpr int kSteps = W / 16;              // k16 steps of S^T and dP^T
  static constexpr int kStages = 2;
  // warpgroup 0 takes columns [0, kCols0), warpgroup 1 [kCols0, W): each half
  // starts on a 64-column tile, the start its B operands need
  static constexpr int kCols0 = W == 160 ? 64 : W / 2;
  static constexpr int kCols1 = W - kCols0;
  static constexpr int kTile = 64 * 128;             // [64 keys or rows][64 bf16], swizzled
  static constexpr int kKvBytes = kColTiles * kTile;       // K, or V
  static constexpr int kStageBytes = 2 * kColTiles * kTile;  // Q, then dO, of one step
  static constexpr int kStatBytes = 2 * kRows * 4;   // lse * log2(e) and delta of a step's rows
  static constexpr int kBarriers = 1 + 2 * kStages;
  // A step's f32 dQ partial sums are staged over that step's own Q and dO
  // buffers, [64 rows][kCols0] then [64 rows][kCols1], each row 16 bytes
  // longer than its values: rows 256 to 512 bytes apart would put every row
  // on the same banks (8-way conflicts on the staging stores)
  static constexpr int kStagedRow0 = kCols0 * 4 + 16, kStagedRow1 = kCols1 * 4 + 16;
  static constexpr int kStaged = kRows * (kStagedRow0 + kStagedRow1);
  // one stage's buffers: Q and dO, or the staged sums, 1024-byte aligned
  static constexpr int kStageStride =
      ((kStaged > kStageBytes ? kStaged : kStageBytes) + kAtomBytes - 1) / kAtomBytes * kAtomBytes;
  // 1024 spare bytes to align the tiles; a dS^T tile [64 keys][64 rows] each
  static constexpr int kSmem = kAtomBytes + 2 * kKvBytes + kStages * kStageStride + 2 * kTile +
                               kStages * kStatBytes + 8 * kBarriers;
  static_assert(kSmem <= 232448, "K2 split: shared memory");
};

// d[64 x NC] += a[64 x 16] (a K-major shared tile) * b[16 x NC] (MN-major).
template <int NC>
__device__ __forceinline__ void wgmma_nt_cols(float (&d)[NC / 2], uint64_t desc_a,
                                              uint64_t desc_b) {
  if constexpr (NC == 64) wgmma_ss_nt_n64(d, desc_a, desc_b);
  if constexpr (NC == 96) wgmma_ss_nt_n96(d, desc_a, desc_b);
  if constexpr (NC == 128) wgmma_ss_nt_n128(d, desc_a, desc_b);
}

template <int NC>
__device__ __forceinline__ void wgmma_tt_cols(float (&d)[NC / 2], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  if constexpr (NC == 64) wgmma_ss_tt_n64(d, desc_a, desc_b, scale_d);
  if constexpr (NC == 96) wgmma_ss_tt_n96(d, desc_a, desc_b, scale_d);
}

// acc[64 keys x 32 rows] = a (K or V, the CTA's 64 keys) * b^T (32 rows of Q
// or dO) over the whole padded head (not committed).
template <int W>
__device__ __forceinline__ void issue_transposed_half(float (&acc)[16], const unsigned char* a,
                                                      const unsigned char* b) {
  constexpr int kTile = SplitConfig<W>::kTile;
#pragma unroll
  for (int kk = 0; kk < SplitConfig<W>::kSteps; ++kk)
    wgmma_ss_n32(acc, wgmma_desc(a + (kk / 4) * kTile + (kk % 4) * 32, 16, kAtomBytes),
                 wgmma_desc(b + (kk / 4) * kTile + (kk % 4) * 32, 16, kAtomBytes), kk > 0);
}

// One consumer warpgroup of the column-split kernel.  Of each step's 64 rows
// it takes 32 (rows 32 kWg..) for S^T and dP^T over the CTA's 64 keys and
// writes their P^T and dS^T (bf16) into the CTA's two shared tiles (pt, ds);
// once both halves are there it runs dV += P^T dO, dK += dS^T Q and dQ = dS K
// over all 64 rows and its columns [C0, C0 + NC).  Named barriers over both
// warpgroups: 5 before the tiles are written (the last step's products are
// done with them), 3 after, 4 before dQ is staged over the step's Q and dO.
template <int W, bool ONE_TILE, int C0, int NC>
__device__ __forceinline__ void split_consumer(
    const unsigned char* sK, const unsigned char* sV, unsigned char* sQ, unsigned char* pt,
    unsigned char* ds, const float* sStat, uint64_t* kv_full, uint64_t* full, uint64_t* empty,
    float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int b, int h, int bh, int H, int Sq, int Sp, int Sk, int d,
    int k0, Strides dks, Strides dvs, float scale, float scale_log2) {
  using Cfg = SplitConfig<W>;
  constexpr int kRows = Cfg::kRows;
  constexpr int kAcc = NC / 2;       // f32 registers of a [64 x NC] accumulator
  constexpr int kWg = C0 == 0 ? 0 : 1;
  constexpr int kTile0 = C0 / 64;    // this warpgroup's first 64-column tile
  constexpr int kRow0 = kWg * kRows / 2;  // its first row of a step for S^T and dP^T
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // this thread's accumulator rows of dK and dV: keys key0 and key0 + 8; of
  // S^T and dP^T the same keys; of dQ rows 16 warp + g (+ 8) of the step
  const int key0 = k0 + warp * 16 + g;
  const int tile_row = (warp * 16 + g) * 128 + 4 * t;
  float* dq_out = dq_acc + (long long)bh * Sp * W + C0;

  float dk_acc[kAcc], dv_acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float s[16], dp[16];

  mbar_wait(kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < Sp / kRows; ++it) {
    unsigned char* q_tile = sQ + stage * Cfg::kStageStride;
    const unsigned char* do_tile = q_tile + Cfg::kColTiles * Cfg::kTile;
    const float2* lse2 = reinterpret_cast<const float2*>(sStat + stage * 2 * kRows);
    const float2* delta2 = lse2 + kRows / 2;

    // S^T = K Q^T and dP^T = V dO^T, 64 keys x this warpgroup's 32 rows
    mbar_wait(full + stage, phase);
    wgmma_fence();
    issue_transposed_half<W>(s, sK, q_tile + kRow0 * 128);
    issue_transposed_half<W>(dp, sV, do_tile + kRow0 * 128);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T in place; element 4j + 2r + c is key key0 + 8r, row
    // kRow0 + 8j + 2t + c of the step
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 l = lse2[kRow0 / 2 + 4 * j + t];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        s[4 * j + 2 * r] = ex2(fmaf(s[4 * j + 2 * r], scale_log2, -l.x));
        s[4 * j + 2 * r + 1] = ex2(fmaf(s[4 * j + 2 * r + 1], scale_log2, -l.y));
      }
    }
    if (k0 + Cfg::kKeys > Sk) {  // the last key tile: P = 0 for the keys past S_k
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (key0 + 8 * ((i / 2) & 1) >= Sk) s[i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 dl = delta2[kRow0 / 2 + 4 * j + t];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dp[4 * j + 2 * r] = s[4 * j + 2 * r] * (dp[4 * j + 2 * r] - dl.x) * scale;
        dp[4 * j + 2 * r + 1] = s[4 * j + 2 * r + 1] * (dp[4 * j + 2 * r + 1] - dl.y) * scale;
      }
    }

    // P^T and dS^T (bf16) into the shared tiles as [key][row], the 16-byte
    // chunk c of key row k at chunk c ^ (k % 8): the 128-byte swizzle
    named_sync(5, 256);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = tile_row + r * 8 * 128 + (((kRow0 / 8 + j) ^ g) << 4);
        *reinterpret_cast<uint32_t*>(pt + at) = pack_bf16(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(ds + at) =
            pack_bf16(dp[4 * j + 2 * r], dp[4 * j + 2 * r + 1]);
      }
    }
    fence_proxy_async();
    named_sync(3, 256);

    // dV += P^T dO and dK += dS^T Q over all 64 rows and this warpgroup's
    // columns: A from the tiles, 16 rows a step, B through the transposing
    // descriptor
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_nt_cols<NC>(dv_acc, wgmma_desc(pt + kk * 32, 16, kAtomBytes),
                        wgmma_desc(do_tile + kTile0 * Cfg::kTile + kk * 2048, Cfg::kTile,
                                   kAtomBytes));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_nt_cols<NC>(dk_acc, wgmma_desc(ds + kk * 32, 16, kAtomBytes),
                        wgmma_desc(q_tile + kTile0 * Cfg::kTile + kk * 2048, Cfg::kTile,
                                   kAtomBytes));
    wgmma_commit();

    // dQ = dS K over this warpgroup's columns and the CTA's 64 keys, 16 keys
    // a step: all of the CTA's contribution to these rows and columns.  It
    // runs in chunks of 64 columns where NC is a multiple of 64: a [64 x 128]
    // accumulator beside dK's and dV's spilled
    constexpr int kChunk = NC % 64 == 0 ? 64 : NC;
    constexpr int kStagedRow = kWg ? Cfg::kStagedRow1 : Cfg::kStagedRow0;
    unsigned char* staged = q_tile + kWg * kRows * Cfg::kStagedRow0;
#pragma unroll
    for (int c = 0; c < NC / kChunk; ++c) {
      float dq_part[kChunk / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tt_cols<kChunk>(
            dq_part, wgmma_desc(ds + kk * 2048, Cfg::kTile, kAtomBytes),
            wgmma_desc(sK + (kTile0 + c) * Cfg::kTile + kk * 2048, Cfg::kTile, kAtomBytes),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();  // with the first chunk, dV and dK too
      fence_regs(dq_part);
      const int col = C0 + c * kChunk;  // the chunk's first column
      if constexpr (ONE_TILE) {
        // the CTA holds every key: write the rows in bf16
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = it * kRows + warp * 16 + g + 8 * r;
          if (row >= Sq) continue;
          __nv_bfloat16* dq_row = dq + (((long long)b * Sq + row) * H + h) * d + col + 2 * t;
#pragma unroll
          for (int j = 0; j < kChunk / 8; ++j)
            if (col + 8 * j < d)
              *reinterpret_cast<uint32_t*>(dq_row + 8 * j) =
                  pack_bf16(dq_part[4 * j + 2 * r], dq_part[4 * j + 2 * r + 1]);
        }
      } else {
        // once both warpgroups are done with the step's Q and dO, the f32
        // sums are staged over them, this warpgroup's as [rows][NC] (padded
        // rows), and each of a warp's first 16 lanes adds one row into the
        // dQ buffer
        if (c == 0) named_sync(4, 256);
        float* my_row = reinterpret_cast<float*>(staged + (warp * 16 + g) * kStagedRow) +
                        c * kChunk + 2 * t;
#pragma unroll
        for (int j = 0; j < kChunk / 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(my_row + r * 8 * (kStagedRow / 4) + 8 * j) =
                make_float2(dq_part[4 * j + 2 * r], dq_part[4 * j + 2 * r + 1]);
        }
      }
    }
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    if constexpr (!ONE_TILE) {
      fence_proxy_async();
      __syncwarp();
      if (lane < 16) {
        const int row = warp * 16 + lane;
        bulk_reduce_add_f32(dq_out + ((long long)it * kRows + row) * W,
                            staged + row * kStagedRow, NC * 4);
        bulk_commit();
        bulk_wait_read();  // the buffers go back to the producer below
      }
      __syncwarp();
    }
    if (lane == 0) mbar_arrive(empty + stage);  // this warp is done with the stage
    if (++stage == Cfg::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Sk) continue;
    __nv_bfloat16* krow = dk + b * dks.b + (long long)key * dks.s + h * dks.h + C0 + 2 * t;
    __nv_bfloat16* vrow = dv + b * dvs.b + (long long)key * dvs.s + h * dvs.h + C0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NC / 8; ++n) {
      if (C0 + 8 * n >= d) continue;
      *reinterpret_cast<uint32_t*>(krow + 8 * n) =
          pack_bf16(dk_acc[4 * n + 2 * r], dk_acc[4 * n + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(vrow + 8 * n) =
          pack_bf16(dv_acc[4 * n + 2 * r], dv_acc[4 * n + 2 * r + 1]);
    }
  }
  // the last adds are complete before the CTA ends
  if (!ONE_TILE && lane < 16) bulk_wait();
}

// ONE_TILE: S_k <= 64, the CTA holds every key and writes dq in bf16 itself;
// otherwise it adds f32 partial sums into dq_acc [B*H, Sp, W].
template <int W, bool ONE_TILE>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_split_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ stat, float* __restrict__ dq_acc,
                       __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int H, int Sq, int Sp, int Sk, int d,
                       long long stat_rows, Strides dks, Strides dvs, float scale,
                       float scale_log2) {
  using Cfg = SplitConfig<W>;
  constexpr int kStages = Cfg::kStages;
  constexpr int kRows = Cfg::kRows;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kAtomBytes - smem_addr(smem_raw) % kAtomBytes) % kAtomBytes);
  unsigned char* sK = smem;                             // [col tile][64 keys][128 B]
  unsigned char* sV = sK + Cfg::kKvBytes;               // the same
  // [stage][Q col tiles, dO col tiles][64 rows][128 B], kStageStride bytes a stage
  unsigned char* sQ = sV + Cfg::kKvBytes;
  unsigned char* sdS = sQ + kStages * Cfg::kStageStride;  // P^T, then dS^T: [64 keys][128 B]
  // [stage][lse * log2(e), delta][rows]
  float* sStat = reinterpret_cast<float*>(sdS + 2 * Cfg::kTile);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sStat + kStages * 2 * kRows);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * Cfg::kKeys;

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
        tma_load_4d(sK + c * Cfg::kTile, &map_k, kv_full, c * 64, h, k0, b);
        tma_load_4d(sV + c * Cfg::kTile, &map_v, kv_full, c * 64, h, k0, b);
      }
      const float* lrow = stat + (long long)bh * Sp;
      const float* drow = lrow + stat_rows;
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < Sp / kRows; ++it) {
        mbar_wait(empty + stage, phase ^ 1);  // passes at once the first time round
        unsigned char* q_tile = sQ + stage * Cfg::kStageStride;
        mbar_arrive_expect_tx(full + stage, Cfg::kStageBytes + Cfg::kStatBytes);
        for (int c = 0; c < Cfg::kColTiles; ++c) {
          tma_load_4d(q_tile + c * Cfg::kTile, &map_q, full + stage, c * 64, h, it * kRows, b);
          tma_load_4d(q_tile + (Cfg::kColTiles + c) * Cfg::kTile, &map_do, full + stage, c * 64,
                      h, it * kRows, b);
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
    // ---- two consumer warpgroups: the same 64 keys, a half of the columns each ----
    setmaxnreg_inc<240>();
    if (threadIdx.x < 256)
      split_consumer<W, ONE_TILE, 0, Cfg::kCols0>(sK, sV, sQ, sdS, sdS + Cfg::kTile, sStat,
                                                  kv_full, full, empty, dq_acc, dq, dk, dv, b, h,
                                                  bh, H, Sq, Sp, Sk, d, k0, dks, dvs, scale,
                                                  scale_log2);
    else
      split_consumer<W, ONE_TILE, Cfg::kCols0, Cfg::kCols1>(
          sK, sV, sQ, sdS, sdS + Cfg::kTile, sStat, kv_full, full, empty, dq_acc, dq, dk, dv, b,
          h, bh, H, Sq, Sp, Sk, d, k0, dks, dvs, scale, scale_log2);
  }
}

// ---- head dims 264-512: a cluster of two CTAs on the column halves ---------

// The pair instance (W = 512): each CTA of a cluster of two holds its half of
// the head's columns (256) of the CTA pair's 64 keys and of each 64-row step,
// and is laid out as the split instance at 256 is, with the f32 dQ rows
// staged in 64-column chunks (17,408 bytes a warpgroup, over the step's Q and
// dO) so that the partial sums exchanged between the two CTAs fit beside.
struct PairConfig {
  static constexpr int kKeys = 64;                     // keys per cluster (and per CTA)
  static constexpr int kRows = 64;                     // Q rows per step
  static constexpr int kHalf = 256;                    // columns of one CTA
  static constexpr int kColTiles = kHalf / 64;         // 64-column tiles of a half
  static constexpr int kStages = 2;
  static constexpr int kTile = 64 * 128;               // [64 keys or rows][64 bf16], swizzled
  static constexpr int kKvBytes = kColTiles * kTile;   // K, or V: the CTA's half
  static constexpr int kStageBytes = 2 * kColTiles * kTile;  // Q, then dO, of one step
  static constexpr int kStatBytes = 2 * kRows * 4;     // lse * log2(e) and delta of a step
  static constexpr int kChunk = 64;                    // dQ columns staged at a time
  static constexpr int kStagedRow = kChunk * 4 + 16;   // bytes a staged row, padded
  static constexpr int kStaged = kRows * kStagedRow;   // one warpgroup's staged chunk
  // a warpgroup's partial S^T and dP^T of 64 keys x 32 rows, f32, as
  // [16 pairs][128 threads] float2
  static constexpr int kXBytes = 2 * 64 * 32 * 4;
  // kv_full, full and empty a stage, xfull, xempty, tfull, tempty
  static constexpr int kBarriers = 1 + 2 * kStages + 4;
  static constexpr int kSmem = kAtomBytes + 2 * kKvBytes + kStages * kStageBytes + 2 * kTile +
                               kXBytes + kStages * kStatBytes + 8 * kBarriers;
  static_assert(2 * kStaged <= kStageBytes, "K2 pair: staged dQ chunks over a stage");
  static_assert(kSmem <= 232448, "K2 pair: shared memory");
};

// One consumer warpgroup of the pair kernel.  Of each step it computes the
// partial S^T = K Q^T and dP^T = V dO^T of 32 rows over its CTA's 256
// columns: warpgroup 0 those of the rows its CTA finishes (32 rank..), 1
// those of the rows the other CTA finishes, which it writes into that CTA's
// exchange buffer.  Warpgroup 0 adds the other CTA's partials of its rows,
// computes P^T and dS^T (bf16) and writes them into both CTAs' [key][row]
// tiles.  Then each warpgroup runs dV += P^T dO, dK += dS^T Q and dQ = dS K
// over all 64 rows and its 128 columns of the CTA's half, as the split
// instance does.  The barriers, each in the CTA that waits on it: xfull (the
// other CTA's warpgroup 1 has written this CTA's exchange buffer), xempty
// (the other CTA's warpgroup 0 has read what this CTA's warpgroup 1 wrote
// it), tfull (both halves of this step's tiles are in), tempty (both CTAs'
// warps are done with the last step's tiles).
template <bool ONE_TILE, int kWg>
__device__ __forceinline__ void pair_consumer(
    const unsigned char* sK, const unsigned char* sV, unsigned char* sQ, unsigned char* pt,
    unsigned char* ds, const float2* xbuf, const float* sStat, uint64_t* kv_full,
    uint64_t* full, uint64_t* empty, uint64_t* xfull, uint64_t* xempty, uint64_t* tfull,
    uint64_t* tempty, uint32_t rank, float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int b, int h, int bh, int H,
    int Sq, int Sp, int Sk, int d, int k0, Strides dks, Strides dvs, float scale,
    float scale_log2) {
  using Cfg = PairConfig;
  constexpr int kRows = Cfg::kRows;
  constexpr int NC = Cfg::kHalf / 2;  // this warpgroup's columns of the half
  constexpr int kAcc = NC / 2;
  constexpr int kTile0 = kWg * NC / 64;
  const int C0 = (int)rank * Cfg::kHalf + kWg * NC;  // its first column of the head
  const uint32_t peer = rank ^ 1;
  const int kRow0 = 32 * (int)(kWg == 0 ? rank : peer);  // its rows of a step for S^T, dP^T
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int key0 = k0 + warp * 16 + g;
  const int tile_row = (warp * 16 + g) * 128 + 4 * t;
  float* dq_out = dq_acc + (long long)bh * Sp * 512 + C0;
  const uint32_t x_peer = map_to_rank(xbuf, peer) + tid * 8;
  const uint32_t pt_peer = map_to_rank(pt, peer), ds_peer = map_to_rank(ds, peer);
  const uint32_t xfull_peer = map_to_rank(xfull, peer), xempty_peer = map_to_rank(xempty, peer);
  const uint32_t tfull_peer = map_to_rank(tfull, peer), tempty_peer = map_to_rank(tempty, peer);

  float dk_acc[kAcc], dv_acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float s[16], dp[16];

  mbar_wait(kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < Sp / kRows; ++it) {
    unsigned char* q_tile = sQ + stage * Cfg::kStageBytes;
    const unsigned char* do_tile = q_tile + Cfg::kColTiles * Cfg::kTile;
    const float2* lse2 = reinterpret_cast<const float2*>(sStat + stage * 2 * kRows);
    const float2* delta2 = lse2 + kRows / 2;
    const uint32_t par = it & 1;

    // partial S^T and dP^T, 64 keys x this warpgroup's 32 rows, over the half
    mbar_wait(full + stage, phase);
    wgmma_fence();
    issue_transposed_half<Cfg::kHalf>(s, sK, q_tile + kRow0 * 128);
    issue_transposed_half<Cfg::kHalf>(dp, sV, do_tile + kRow0 * 128);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    if constexpr (kWg == 1) {
      // to the other CTA, whose warpgroup 0 holds these rows in the same places
      mbar_wait_cluster(xempty, par ^ 1);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        st_cluster_f32x2(x_peer + m * 128 * 8, s[2 * m], s[2 * m + 1]);
        st_cluster_f32x2(x_peer + (8 + m) * 128 * 8, dp[2 * m], dp[2 * m + 1]);
      }
      mbar_arrive_cluster(xfull_peer);
    } else {
      // the whole head's S^T and dP^T of this CTA's rows
      mbar_wait_cluster(xfull, par);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float2 xs = xbuf[m * 128 + tid], xd = xbuf[(8 + m) * 128 + tid];
        s[2 * m] += xs.x;
        s[2 * m + 1] += xs.y;
        dp[2 * m] += xd.x;
        dp[2 * m + 1] += xd.y;
      }
      mbar_arrive_cluster(xempty_peer);
      // P^T and dS^T in place; element 4j + 2r + c is key key0 + 8r, row
      // kRow0 + 8j + 2t + c of the step
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 l = lse2[kRow0 / 2 + 4 * j + t];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          s[4 * j + 2 * r] = ex2(fmaf(s[4 * j + 2 * r], scale_log2, -l.x));
          s[4 * j + 2 * r + 1] = ex2(fmaf(s[4 * j + 2 * r + 1], scale_log2, -l.y));
        }
      }
      if (k0 + Cfg::kKeys > Sk) {  // the last key tile: P = 0 for the keys past S_k
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (key0 + 8 * ((i / 2) & 1) >= Sk) s[i] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 dl = delta2[kRow0 / 2 + 4 * j + t];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dp[4 * j + 2 * r] = s[4 * j + 2 * r] * (dp[4 * j + 2 * r] - dl.x) * scale;
          dp[4 * j + 2 * r + 1] = s[4 * j + 2 * r + 1] * (dp[4 * j + 2 * r + 1] - dl.y) * scale;
        }
      }
      // into both CTAs' tiles as [key][row], the 16-byte chunk c of key row
      // k at chunk c ^ (k % 8): the 128-byte swizzle
      mbar_wait_cluster(tempty, par ^ 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int at = tile_row + r * 8 * 128 + (((kRow0 / 8 + j) ^ g) << 4);
          const uint32_t p2 = pack_bf16(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
          const uint32_t d2 = pack_bf16(dp[4 * j + 2 * r], dp[4 * j + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(pt + at) = p2;
          *reinterpret_cast<uint32_t*>(ds + at) = d2;
          st_cluster_u32(pt_peer + at, p2);
          st_cluster_u32(ds_peer + at, d2);
        }
      }
      fence_proxy_async();
      fence_proxy_async_cluster();
      mbar_arrive(tfull);
      mbar_arrive_cluster(tfull_peer);
    }
    mbar_wait_cluster(tfull, par);
    fence_proxy_async();

    // dV += P^T dO and dK += dS^T Q over all 64 rows and this warpgroup's columns
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_nt_cols<NC>(dv_acc, wgmma_desc(pt + kk * 32, 16, kAtomBytes),
                        wgmma_desc(do_tile + kTile0 * Cfg::kTile + kk * 2048, Cfg::kTile,
                                   kAtomBytes));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_nt_cols<NC>(dk_acc, wgmma_desc(ds + kk * 32, 16, kAtomBytes),
                        wgmma_desc(q_tile + kTile0 * Cfg::kTile + kk * 2048, Cfg::kTile,
                                   kAtomBytes));
    wgmma_commit();

    // dQ = dS K over this warpgroup's columns and the cluster's 64 keys, in
    // chunks of 64 columns; once both warpgroups are done with the step's Q
    // and dO, each chunk's f32 sums are staged over them and each of a
    // warp's first 16 lanes adds one row into the dQ buffer
    unsigned char* staged = q_tile + kWg * Cfg::kStaged;
#pragma unroll
    for (int c = 0; c < NC / Cfg::kChunk; ++c) {
      float dq_part[Cfg::kChunk / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tt_cols<Cfg::kChunk>(
            dq_part, wgmma_desc(ds + kk * 2048, Cfg::kTile, kAtomBytes),
            wgmma_desc(sK + (kTile0 + c) * Cfg::kTile + kk * 2048, Cfg::kTile, kAtomBytes),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();  // with the first chunk, dV and dK too
      fence_regs(dq_part);
      if (c == NC / Cfg::kChunk - 1 && lane == 0) {  // this warp is done with the tiles
        mbar_arrive(tempty);
        mbar_arrive_cluster(tempty_peer);
      }
      const int col = C0 + c * Cfg::kChunk;
      if constexpr (ONE_TILE) {
        // the cluster holds every key: write the rows in bf16
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = it * kRows + warp * 16 + g + 8 * r;
          if (row >= Sq) continue;
          __nv_bfloat16* dq_row = dq + (((long long)b * Sq + row) * H + h) * d + col + 2 * t;
#pragma unroll
          for (int j = 0; j < Cfg::kChunk / 8; ++j)
            if (col + 8 * j < d)
              *reinterpret_cast<uint32_t*>(dq_row + 8 * j) =
                  pack_bf16(dq_part[4 * j + 2 * r], dq_part[4 * j + 2 * r + 1]);
        }
      } else {
        if (c == 0) named_sync(4, 256);
        if (c > 0) {  // the last chunk's adds have read the staged rows
          if (lane < 16) bulk_wait_read();
          __syncwarp();
        }
        float* my_row = reinterpret_cast<float*>(staged + (warp * 16 + g) * Cfg::kStagedRow) + 2 * t;
#pragma unroll
        for (int j = 0; j < Cfg::kChunk / 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(my_row + r * 8 * (Cfg::kStagedRow / 4) + 8 * j) =
                make_float2(dq_part[4 * j + 2 * r], dq_part[4 * j + 2 * r + 1]);
        }
        fence_proxy_async();
        __syncwarp();
        if (lane < 16) {
          const int row = warp * 16 + lane;
          bulk_reduce_add_f32(dq_out + ((long long)it * kRows + row) * 512 + c * Cfg::kChunk,
                              staged + row * Cfg::kStagedRow, Cfg::kChunk * 4);
          bulk_commit();
        }
      }
    }
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    if constexpr (!ONE_TILE) {
      if (lane < 16) bulk_wait_read();  // the buffers go back to the producer below
      __syncwarp();
    }
    if (lane == 0) mbar_arrive(empty + stage);  // this warp is done with the stage
    if (++stage == Cfg::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Sk) continue;
    __nv_bfloat16* krow = dk + b * dks.b + (long long)key * dks.s + h * dks.h + C0 + 2 * t;
    __nv_bfloat16* vrow = dv + b * dvs.b + (long long)key * dvs.s + h * dvs.h + C0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NC / 8; ++n) {
      if (C0 + 8 * n >= d) continue;
      *reinterpret_cast<uint32_t*>(krow + 8 * n) =
          pack_bf16(dk_acc[4 * n + 2 * r], dk_acc[4 * n + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(vrow + 8 * n) =
          pack_bf16(dv_acc[4 * n + 2 * r], dv_acc[4 * n + 2 * r + 1]);
    }
  }
  // the last adds are complete before the CTA ends
  if (!ONE_TILE && lane < 16) bulk_wait();
}

// A cluster of two CTAs (ranks 0 and 1 along x) per (b*h, 64-key tile); W =
// 512, the f32 dQ rows [B*H, Sp, 512].  ONE_TILE: S_k <= 64, the cluster
// holds every key and writes dq in bf16 itself.
template <int W, bool ONE_TILE>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_pair_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const float* __restrict__ stat, float* __restrict__ dq_acc,
                      __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int H, int Sq, int Sp, int Sk, int d,
                      long long stat_rows, Strides dks, Strides dvs, float scale,
                      float scale_log2) {
  static_assert(W == 2 * PairConfig::kHalf, "K2 pair: the head's width");
  using Cfg = PairConfig;
  constexpr int kStages = Cfg::kStages;
  constexpr int kRows = Cfg::kRows;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kAtomBytes - smem_addr(smem_raw) % kAtomBytes) % kAtomBytes);
  unsigned char* sK = smem;                  // [col tile][64 keys][128 B], this CTA's half
  unsigned char* sV = sK + Cfg::kKvBytes;    // the same
  unsigned char* sQ = sV + Cfg::kKvBytes;    // [stage][Q col tiles, dO col tiles][64 rows][128 B]
  unsigned char* pt = sQ + kStages * Cfg::kStageBytes;  // P^T: [64 keys][128 B]
  unsigned char* ds = pt + Cfg::kTile;                  // dS^T: the same
  float2* xbuf = reinterpret_cast<float2*>(ds + Cfg::kTile);
  float* sStat = reinterpret_cast<float*>(ds + Cfg::kTile + Cfg::kXBytes);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sStat + kStages * 2 * kRows);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  uint64_t* xfull = empty + kStages;
  uint64_t* xempty = xfull + 1;
  uint64_t* tfull = xempty + 1;
  uint64_t* tempty = tfull + 1;

  const uint32_t rank = cluster_ctarank();
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = (blockIdx.x / 2) * Cfg::kKeys;
  const int col0 = (int)rank * Cfg::kHalf;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);  // one arrival per consumer warp
    }
    mbar_init(xfull, 128);   // the other CTA's warpgroup 1, a thread each
    mbar_init(xempty, 128);  // the other CTA's warpgroup 0, a thread each
    mbar_init(tfull, 256);   // both CTAs' warpgroup 0, a thread each
    mbar_init(tempty, 16);   // both CTAs' consumer warps
    mbar_fence_init();
  }
  cluster_sync_all();  // both CTAs' barriers exist before any arrival from the other

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load of this CTA's half ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * Cfg::kKvBytes);
      for (int c = 0; c < Cfg::kColTiles; ++c) {
        tma_load_4d(sK + c * Cfg::kTile, &map_k, kv_full, col0 + c * 64, h, k0, b);
        tma_load_4d(sV + c * Cfg::kTile, &map_v, kv_full, col0 + c * 64, h, k0, b);
      }
      const float* lrow = stat + (long long)bh * Sp;
      const float* drow = lrow + stat_rows;
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < Sp / kRows; ++it) {
        mbar_wait(empty + stage, phase ^ 1);  // passes at once the first time round
        unsigned char* q_tile = sQ + stage * Cfg::kStageBytes;
        mbar_arrive_expect_tx(full + stage, Cfg::kStageBytes + Cfg::kStatBytes);
        for (int c = 0; c < Cfg::kColTiles; ++c) {
          tma_load_4d(q_tile + c * Cfg::kTile, &map_q, full + stage, col0 + c * 64, h,
                      it * kRows, b);
          tma_load_4d(q_tile + (Cfg::kColTiles + c) * Cfg::kTile, &map_do, full + stage,
                      col0 + c * 64, h, it * kRows, b);
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
    // ---- two consumer warpgroups: the same 64 keys, a quarter of the head's columns each ----
    setmaxnreg_inc<240>();
    if (threadIdx.x < 256)
      pair_consumer<ONE_TILE, 0>(sK, sV, sQ, pt, ds, xbuf, sStat, kv_full, full, empty, xfull,
                                 xempty, tfull, tempty, rank, dq_acc, dq, dk, dv, b, h, bh, H, Sq,
                                 Sp, Sk, d, k0, dks, dvs, scale, scale_log2);
    else
      pair_consumer<ONE_TILE, 1>(sK, sV, sQ, pt, ds, xbuf, sStat, kv_full, full, empty, xfull,
                                 xempty, tfull, tempty, rank, dq_acc, dq, dk, dv, b, h, bh, H, Sq,
                                 Sp, Sk, d, k0, dks, dvs, scale, scale_log2);
  }
  cluster_sync_all();  // neither CTA leaves while the other may still write its shared memory
}

// First pass, one thread per (b, s, h) row of the padded length Sp (a
// multiple of the rows of a step): stat[0][b, h, s] = lse * log2(e) and stat[1][b, h, s] =
// delta = sum_d dO * O in f32, or +inf and 0 for the rows past Sq; and every
// block zeroes its share of the f32 dQ buffer (acc_vec4 float4 values; none
// when the main kernel writes dQ itself).  For the instances up to head dim
// 80, whose width W is the head dim d itself (d is not read: it stands in
// the signature that flash_bwd_split_prep_kernel shares).
template <int W>
__global__ void flash_bwd_wgmma_prep_kernel(const __nv_bfloat16* __restrict__ o,
                                            const __nv_bfloat16* __restrict__ dO,
                                            const float* __restrict__ lse,
                                            float* __restrict__ stat, float4* __restrict__ dq_acc,
                                            long long acc_vec4, int B, int H, int Sq, int Sp,
                                            int d, Strides os, Strides dos) {
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
      // the row's loads are all in flight at once: W is known, the loop unrolls
      uint4 ov[W / 8], dv[W / 8];
#pragma unroll
      for (int c = 0; c < W / 8; ++c) {
        ov[c] = reinterpret_cast<const uint4*>(orow)[c];
        dv[c] = reinterpret_cast<const uint4*>(drow)[c];
      }
#pragma unroll
      for (int c = 0; c < W / 8; ++c) {
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

// The same first pass for the column-split and pair instances, one warp per
// row: the row's 16-byte loads of O and dO spread over the lanes (a row of
// 320 or 512 bytes in one coalesced load, 1024 in two) and summed by shuffles.
template <int W>
__global__ void flash_bwd_split_prep_kernel(const __nv_bfloat16* __restrict__ o,
                                            const __nv_bfloat16* __restrict__ dO,
                                            const float* __restrict__ lse,
                                            float* __restrict__ stat, float4* __restrict__ dq_acc,
                                            long long acc_vec4, int B, int H, int Sq, int Sp,
                                            int d, Strides os, Strides dos) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  const long long stat_rows = (long long)B * H * Sp;
  if (row < stat_rows) {  // the same in every lane of the warp
    const int h = row % H;
    const int s = (row / H) % Sp;
    const int b = row / ((long long)H * Sp);
    float l = INFINITY, acc = 0.f;
    if (s < Sq) {
#pragma unroll
      for (int c = lane; c < W / 8; c += 32) {
        if (c * 8 >= d) break;
        const uint4 ov = reinterpret_cast<const uint4*>(o + b * os.b + (long long)s * os.s +
                                                        h * os.h)[c];
        const uint4 dv = reinterpret_cast<const uint4*>(dO + b * dos.b + (long long)s * dos.s +
                                                        h * dos.h)[c];
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 a = __bfloat1622float2(o2[i]), e = __bfloat1622float2(d2[i]);
          acc += a.x * e.x + a.y * e.y;
        }
      }
#pragma unroll
      for (int m = 16; m > 0; m /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
      l = lse[((long long)b * H + h) * Sq + s] * kLog2e;
    }
    if (lane == 0) {
      const long long at = ((long long)b * H + h) * Sp + s;
      stat[at] = l;
      stat[stat_rows + at] = acc;
    }
  }
  const long long share = (acc_vec4 + gridDim.x - 1) / gridDim.x;
  const long long begin = blockIdx.x * share;
  const long long end = begin + share < acc_vec4 ? begin + share : acc_vec4;
  for (long long i = begin + threadIdx.x; i < end; i += blockDim.x)
    dq_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Last pass: dq[b, s, h, :] = bf16(dq_acc[b, h, s, :D]), 8 values a thread; dq
// is contiguous [B, Sq, H, D], dq_acc [B, H, Sp, W] (W >= D: the instance's width).
__global__ void flash_bwd_wgmma_cast_kernel(const float* __restrict__ dq_acc,
                                            __nv_bfloat16* __restrict__ dq, int B, int H, int Sq,
                                            int Sp, int D, int W) {
  const int nvec = D / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * Sq * H * nvec) return;
  const int c = i % nvec;
  const int h = (i / nvec) % H;
  const int s = (i / ((long long)nvec * H)) % Sq;
  const int b = i / ((long long)nvec * H * Sq);
  const float4* src =
      reinterpret_cast<const float4*>(dq_acc + (((long long)b * H + h) * Sp + s) * W + c * 8);
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

template <int W, bool ONE_TILE>
cudaError_t launch_split(const void* q, const void* k, const void* v, const void* dO,
                         const float* stat, float* dq_acc, void* dq, void* dk, void* dv, int B,
                         int H, int Sq, int Sp, int Sk, int D, Strides qs, Strides ks, Strides vs,
                         Strides dos, Strides dks, Strides dvs, float scale, cudaStream_t stream) {
  using Cfg = SplitConfig<W>;
  static bool allowed[kMaxDevices] = {};
  const cudaError_t attr =
      allow_dynamic_smem(flash_bwd_split_kernel<W, ONE_TILE>, Cfg::kSmem, allowed);
  if (attr != cudaSuccess) return attr;
  alignas(64) CUtensorMap mq, mk, mv, mdo;
  if (!make_bshd_map(&mq, q, B, H, Sq, D, qs, Cfg::kRows) ||
      !make_bshd_map(&mk, k, B, H, Sk, D, ks, Cfg::kKeys) ||
      !make_bshd_map(&mv, v, B, H, Sk, D, vs, Cfg::kKeys) ||
      !make_bshd_map(&mdo, dO, B, H, Sq, D, dos, Cfg::kRows))
    return cudaErrorInvalidValue;
  const dim3 grid((Sk + Cfg::kKeys - 1) / Cfg::kKeys, B * H);
  flash_bwd_split_kernel<W, ONE_TILE><<<grid, kThreads, Cfg::kSmem, stream>>>(
      mq, mk, mv, mdo, stat, dq_acc, static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Sq, Sp, Sk, D,
      (long long)B * H * Sp, dks, dvs, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <bool ONE_TILE>
cudaError_t launch_pair(const void* q, const void* k, const void* v, const void* dO,
                        const float* stat, float* dq_acc, void* dq, void* dk, void* dv, int B,
                        int H, int Sq, int Sp, int Sk, int D, Strides qs, Strides ks, Strides vs,
                        Strides dos, Strides dks, Strides dvs, float scale, cudaStream_t stream) {
  using Cfg = PairConfig;
  static bool allowed[kMaxDevices] = {};
  const cudaError_t attr =
      allow_dynamic_smem(flash_bwd_pair_kernel<512, ONE_TILE>, Cfg::kSmem, allowed);
  if (attr != cudaSuccess) return attr;
  alignas(64) CUtensorMap mq, mk, mv, mdo;
  if (!make_bshd_map(&mq, q, B, H, Sq, D, qs, Cfg::kRows) ||
      !make_bshd_map(&mk, k, B, H, Sk, D, ks, Cfg::kKeys) ||
      !make_bshd_map(&mv, v, B, H, Sk, D, vs, Cfg::kKeys) ||
      !make_bshd_map(&mdo, dO, B, H, Sq, D, dos, Cfg::kRows))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(2 * ((Sk + Cfg::kKeys - 1) / Cfg::kKeys), B * H);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = Cfg::kSmem;
  config.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 2;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  config.attrs = attrs;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, flash_bwd_pair_kernel<512, ONE_TILE>, mq, mk, mv, mdo, stat,
                            dq_acc, static_cast<__nv_bfloat16*>(dq),
                            static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H,
                            Sq, Sp, Sk, D, (long long)B * H * Sp, dks, dvs, scale,
                            scale * kLog2e);
}

// The instance that takes head dim D (0 for none): 40, 64, 72 and 80 their
// own; every other multiple of 8 in (80, 512] the narrowest of 160, 256 and
// 512 that is at least as wide.
int bwd_instance(int D) {
  if (D == 40 || D == 64 || D == 72 || D == 80) return D;
  if (D > 80 && D <= 512 && D % 8 == 0) return D <= 160 ? 160 : D <= 256 ? 256 : 512;
  return 0;
}

}  // namespace

// q, k, v, o, dO, dk, dv: bf16 [B, S, H, D] with the given element strides
// (D contiguous, D 40, 64, 72, 80 or a multiple of 8 in (80, 512], every
// stride a positive multiple of 8, 16-byte aligned pointers).  lse: f32
// [B, H, Sq] from K1, contiguous.  W is the instance's width (bwd_instance:
// D itself up to 80, else 160, 256 or 512), its key tile 128 keys up to 80
// and 64 above.  With Sp = Sq rounded up to a multiple of 128 (D 40) or 64 (every
// other): stat: f32 scratch [2, B, H, Sp]; dq_acc: f32 scratch [B, H, Sp, W],
// 16-byte aligned, not touched when Sk fits one key tile; dq: bf16
// [B, Sq, H, D], contiguous.  Launches three kernels in order on the stream
// (two with one key tile); returns the first CUDA error code (0 on success;
// cudaErrorInvalidValue for a head dim or strides it does not take).
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
  const int W = bwd_instance(D);
  if (!W) return (int)cudaErrorInvalidValue;
  const bool split = W > 80;  // the column-split and pair instances: 64 keys, 64 rows a step
  const bool one_tile = Sk <= (split ? SplitConfig<160>::kKeys : kKeys);
  const int step = split ? SplitConfig<160>::kRows : rows_per_step(W);
  const int Sp = (Sq + step - 1) / step * step;
  const long long rows = (long long)B * H * Sp;
  const auto prep = W == 40    ? flash_bwd_wgmma_prep_kernel<40>
                    : W == 64  ? flash_bwd_wgmma_prep_kernel<64>
                    : W == 72  ? flash_bwd_wgmma_prep_kernel<72>
                    : W == 80  ? flash_bwd_wgmma_prep_kernel<80>
                    : W == 160 ? flash_bwd_split_prep_kernel<160>
                    : W == 256 ? flash_bwd_split_prep_kernel<256>
                               : flash_bwd_split_prep_kernel<512>;
  const long long prep_threads = split ? 32 * rows : rows;  // a warp a row for the split ones
  prep<<<(unsigned)((prep_threads + 255) / 256), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dO),
      static_cast<const float*>(lse), static_cast<float*>(stat), static_cast<float4*>(dq_acc),
      one_tile ? 0 : rows * W / 4, B, H, Sq, Sp, D, os, dos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* st_in = static_cast<const float*>(stat);
  float* acc = static_cast<float*>(dq_acc);
  if (W == 512) {
    err = (one_tile ? launch_pair<true> : launch_pair<false>)(
        q, k, v, dO, st_in, acc, dq, dk, dv, B, H, Sq, Sp, Sk, D, qs, ks, vs, dos, dks, dvs, scale,
        st);
  } else if (split) {
    const auto main_kernel =
        W == 160 ? (one_tile ? launch_split<160, true> : launch_split<160, false>)
                 : (one_tile ? launch_split<256, true> : launch_split<256, false>);
    err = main_kernel(q, k, v, dO, st_in, acc, dq, dk, dv, B, H, Sq, Sp, Sk, D, qs, ks, vs, dos,
                      dks, dvs, scale, st);
  } else {
    const auto main_kernel = W == 40   ? (one_tile ? launch<40, true> : launch<40, false>)
                             : W == 64 ? (one_tile ? launch<64, true> : launch<64, false>)
                             : W == 72 ? (one_tile ? launch<72, true> : launch<72, false>)
                                       : (one_tile ? launch<80, true> : launch<80, false>);
    err = main_kernel(q, k, v, dO, st_in, acc, dq, dk, dv, B, H, Sq, Sp, Sk, qs, ks, vs, dos,
                      dks, dvs, scale, st);
  }
  if (err != cudaSuccess || one_tile) return (int)err;
  const long long n8 = (long long)B * Sq * H * D / 8;
  flash_bwd_wgmma_cast_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>(
      acc, static_cast<__nv_bfloat16*>(dq), B, H, Sq, Sp, D, W);
  return (int)cudaGetLastError();
}

// The dynamic shared memory, in bytes, of the main kernel that a call with
// head dim D launches (0 for a head dim it does not take).
extern "C" int dmtpu_flash_attn_bwd_smem(int D) {
  switch (bwd_instance(D)) {
    case 40: return Config<40>::kSmem;
    case 64: return Config<64>::kSmem;
    case 72: return Config<72>::kSmem;
    case 80: return Config<80>::kSmem;
    case 160: return SplitConfig<160>::kSmem;
    case 256: return SplitConfig<256>::kSmem;
    case 512: return PairConfig::kSmem;
    default: return 0;
  }
}
