// K1: non-causal attention forward for Hopper (sm_90a), bf16 in and out: the
// kernel of every K1 call with a head dim up to 256 (SD1.5's 40, 80 and 160,
// DiT's 72, MMDiT's, SDXL's and ADM's 64, the CIFAR UNets' 256), self- and
// cross-attention alike.
//
// Replaces dmtpu/ops/flash_small_d.py::_fwd_kernel / _fwd (the Pallas TPU
// flash kernel for small head dims) and the forward role of the stock Pallas
// TPU flash kernel that dmtpu/ops/attention.py::flash_mha calls.  What it does
// not take (a non-positive scale, a broadcast q, k or v: no tensor map, head
// dims above 256) goes to the mma.sync kernels in flash_attn_fwd_mma.cu and
// flash_attn_fwd_mma_d512.cu; the gate is in dmtpu_torch/ops/flash_attention.py.
//
// What it computes, per (batch, head): O = softmax(Q K^T * scale) V by online
// softmax (running max, running sum and the O accumulator in f32; P rounded
// to bf16 for the PV product), plus the row logsumexp in f32 for the backward.
//
// What bounds it on this card (NVIDIA H100 80GB HBM3, 700 W): at SD1.5's
// S=4096 d=40 the operations (344 GFLOP of products and 2.1e9 exponentials
// on special-function units that retire 16 a clock on each SM: the two must
// overlap); at head dim 256 and S=256 (the CIFAR UNet) the bytes (Q, K, V
// read once and O written, 262 MB at b500: 0.078 ms; the kernel takes 0.12,
// SDPA 0.096); at SD1.5's d=160 rows and the 77-key cross-attention rows the
// host's time to launch a call (0.05 ms; the kernel's device time is 0.007
// to 0.09 ms there).  The design:
//   - wgmma for both products.  A CTA is three warpgroups: one producer and
//     two consumers of 64 Q rows each, so a K/V tile is read once for 128
//     rows.  S = Q K^T is m64nNk16 with Q and K read from shared memory
//     (both K-major); O += P V takes P from registers (the S accumulator
//     re-packed to bf16 in place) and V from shared memory through the
//     transposing descriptor (V is [keys][d]: MN-major for this product);
//   - TMA: one producer thread fills a ring of K/V stages with
//     cp.async.bulk.tensor boxes of N rows x 64 columns in the 128-byte
//     swizzle; "full" mbarriers carry the byte counts, consumer warps arrive
//     on "empty" ones.  The [B, S, H, D] strides become a rank-4 tensor map
//     (D, H, S, B), so projection outputs are read in place.  setmaxnreg moves
//     the producer's registers to the consumers (24 / 240);
//   - one instance per head dim of the paths: 40, 64, 72, 80, 160 and 256; a
//     head dim between two runs on the wider one.  Columns past D cost
//     nothing in device memory: the box is 64 columns wide and columns past D
//     are out of bounds, which TMA zero-fills without reading, and they are
//     not written.  Q K^T runs over ceil(D / 16) k16 steps, P V is a single
//     wgmma of the instance's width (n40 ... n160, n256);
//   - the key tile N follows the head dim, so that Q (128 rows) and at least
//     two K/V stages fit the 227 KB a block may use: 128 keys up to d=80,
//     64 keys at d=160 (Q 48 KB, three 48 KB stages) and d=256 (Q 64 KB, two
//     64 KB stages).  At d=256 a consumer thread holds O (128 f32), S (32)
//     and P (16 registers);
//   - a short-key tile of 80 keys for calls of at most 80 keys where N's
//     tiles would give them more slots (d = 40, 64 and 80 with their 128-key
//     tile, d=160 with 65 to 80 keys): the cross-attention to 77 CLIP tokens
//     then runs one tile with 3 masked keys instead of 51 (m64n80k16 for S,
//     five k16 steps for P V);
//   - persistent: one CTA per SM (kPersistent) walks the work items (a Q
//     tile of one (b, h)) blockIdx.x, + gridDim.x, ...; the ring's stages and
//     phases run on across items, and the producer loads the next item's Q as
//     soon as both consumers have seen their last Q K^T of the current one
//     complete (a "q_empty" mbarrier), so one item's last P V and its O
//     stores overlap the next item's loads.  At 77 keys (one tile an item)
//     that saves a quarter of the time, at S=256 d=256 a tenth;
//   - O leaves a consumer from registers.  From head dim 160, in calls that
//     fill the 128-row tiles, the four threads of a row trade words so that
//     each stores a whole 16-byte block (store_words): 4-byte stores wrote
//     each 32-byte sector in two halves, and took 38% of the time at d=256
//     S=256 (k1_probe variants, no O stores: 0.084 against 0.134 ms).  Below
//     d=160, and at S_q=16 or 64, the 4-byte stores measured as fast or
//     faster;
//   - overlap inside an item: each consumer issues the next tile's Q K^T and
//     the current tile's P V together, and computes the softmax of the next
//     tile while P V runs; the two consumer warpgroups take turns issuing
//     their products (two named barriers), so one's exponentials run under
//     the other's tensor-core time.  The scale is folded into one fused
//     multiply-add before ex2.approx;
//   - keys past S_k (zero-filled by TMA) are masked to -inf in the last tile;
//     rows past S_q are computed on zeros and not written.
//
// Budgets (ptxas -v, and the dynamic shared memory of Config<D, N>::kSmem, as
// chip_smoke.py phase 1 prints them): every instance 168 registers at launch
// (24 / 240 after setmaxnreg), no spills; shared memory, bytes: d=40 and
// d=64 148,592 (80-key tile 99,440), d=72 230,488, d=80 230,488 (80-key tile
// 197,744), d=160 197,720 (80-key tile 173,120), d=256 197,696; one CTA per
// SM in every case (the registers).
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace dmtpu;

constexpr int kBlockM = 128;        // Q rows per CTA: two consumer warpgroups x 64
constexpr int kThreads = 384;       // producer warpgroup + two consumer warpgroups
constexpr int kRowBytes = 128;      // one row of a 64-column tile: 64 bf16
constexpr int kAtomBytes = 1024;    // 8 rows x 128 bytes: the swizzle's period
constexpr int kSmemLimit = 232448;  // the dynamic shared memory a block may use
constexpr int kShortKeys = 80;      // the short-key tile (see the top)
constexpr bool kPersistent = true;  // one CTA per SM walks the work items (see the top)
constexpr int kWholeBlockMinD = 160;  // from this head dim O goes by 16-byte stores (store_words)
constexpr float kLn2 = 0.6931471805599453f;

// Head-dim instance D with N keys a K/V tile.
template <int D, int N>
struct Config {
  static constexpr int kColTiles = (D + 63) / 64;  // 64-column tiles per row
  static constexpr int kSteps = (D + 15) / 16;     // k16 steps of Q K^T
  static constexpr int kKeySteps = N / 16;         // k16 steps of P V
  static constexpr int kS = N / 2;                 // f32 logits of one tile per thread
  static constexpr int kAcc = D / 2;               // f32 registers of O per thread
  static constexpr int kQTile = kBlockM * kRowBytes;  // one 64-column tile of Q
  static constexpr int kKVTile = N * kRowBytes;       // one 64-column tile of K or V
  static constexpr int kQBytes = kColTiles * kQTile;
  static constexpr int kStageBytes = kColTiles * kKVTile;  // one K or one V stage
  // as many K/V stages as fit beside Q and the barriers, at most 4; 1024
  // spare bytes align the tiles
  static constexpr int kFit = (kSmemLimit - kAtomBytes - kQBytes - 8 * 14) / (2 * kStageBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kBarriers = 2 + 3 * kStages;
  static constexpr int kSmem = kAtomBytes + kQBytes + 2 * kStages * kStageBytes + 8 * kBarriers;
  static constexpr bool kWholeBlockStores = D >= kWholeBlockMinD;
  static_assert(kStages >= 2 && kSmem <= kSmemLimit, "K1 wgmma: shared memory");
};

// The current device's SM count, looked up once per device.
inline int sm_count() {
  static int counts[kMaxDevices] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= kMaxDevices) return 0;
  if (!counts[device] &&
      cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return counts[device];
}

template <int N>
__device__ __forceinline__ void wgmma_qk(float (&s)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(s, desc_a, desc_b, scale_d);
  if constexpr (N == 80) wgmma_ss_n80(s, desc_a, desc_b, scale_d);
  if constexpr (N == 128) wgmma_ss_n128(s, desc_a, desc_b, scale_d);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  if constexpr (D == 40) wgmma_rs_n40(o, a, desc, scale_d);
  if constexpr (D == 64) wgmma_rs_n64(o, a, desc, scale_d);
  if constexpr (D == 72) wgmma_rs_n72(o, a, desc, scale_d);
  if constexpr (D == 80) wgmma_rs_n80(o, a, desc, scale_d);
  if constexpr (D == 160) wgmma_rs_n160(o, a, desc, scale_d);
  if constexpr (D == 256) wgmma_rs_n256(o, a, desc, scale_d);
}

// S = Q K^T for this warpgroup's 64 rows and one N-key tile (not committed).
template <int D, int N>
__device__ __forceinline__ void issue_qk(float (&s)[N / 2], const unsigned char* q_rows,
                                         const unsigned char* k_tile) {
  using Cfg = Config<D, N>;
#pragma unroll
  for (int kk = 0; kk < Cfg::kSteps; ++kk)
    wgmma_qk<N>(s, wgmma_desc(q_rows + (kk / 4) * Cfg::kQTile + (kk % 4) * 32, 16, kAtomBytes),
                wgmma_desc(k_tile + (kk / 4) * Cfg::kKVTile + (kk % 4) * 32, 16, kAtomBytes),
                kk > 0);
}

// O (+)= P V for one N-key tile (not committed).
template <int D, int N>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[N / 16][4],
                                         const unsigned char* v_tile, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_pv<D>(o, p[kk],
                wgmma_desc(v_tile + kk * 16 * kRowBytes, Config<D, N>::kKVTile, kAtomBytes),
                accumulate || kk > 0);
}

// Online softmax of one tile of raw logits, in place: s becomes
// exp2((s - m) * scale_log2) for the updated running max m; l is this
// thread's share of the running sum.  alpha is the factor the old O and l
// shrink by.  Thread (g, t) holds rows g (s[4j], s[4j+1]) and g + 8
// (s[4j+2], s[4j+3]) at columns 8j + 2t, 8j + 2t + 1.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int valid_keys, int t,
                                             float scale_log2) {
  if (valid_keys < N) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      if ((i / 4) * 8 + 2 * t + (i & 1) >= valid_keys) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s[i]);
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2((m[r] - m_new) * scale_log2);
    m[r] = m_new;
    mc[r] = m_new * scale_log2;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    s[i] = ex2(fmaf(s[i], scale_log2, -mc[(i / 2) & 1]));
    l[(i / 2) & 1] += s[i];
  }
}

// The A operands of P V from the S accumulator: k16 step kk is the 8-column
// blocks 2kk and 2kk + 1.
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&p)[N / 16][4], const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// The output row's 16 bytes that thread t stores for four 8-column blocks
// n0..n0+3: thread t holds the bf16 pair at columns 8j + 2t, 8j + 2t + 1 of
// block n0 + j in v[j], and the four threads of a row (one quad of lanes)
// transpose their 4 x 4 words, so that thread t gets block n0 + t whole.  A
// warp's store then writes 8 rows x 64 bytes, two whole 32-byte sectors a
// row; with 4-byte stores every sector came in two halves, and the O stores
// took 38% of the time at d=256 S=256.  Below head dim kWholeBlockMinD, and
// for calls of fewer Q rows than a CTA's 128 (d=256 S_q=16: 0.017 against
// 0.026 ms), the 4-byte stores measured as fast or faster.  Every lane of
// the warp must call it.
__device__ __forceinline__ uint4 store_words(const uint32_t (&v)[4], int t) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // send the word of block n0 + (t ^ k); receive lane t ^ k's word of block n0 + t
    const int j = t ^ k;
    const uint32_t send = j == 0 ? v[0] : j == 1 ? v[1] : j == 2 ? v[2] : v[3];
    const uint32_t got = k == 0 ? send : __shfl_xor_sync(0xffffffffu, send, k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i == j) w[i] = got;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Named barriers 1 and 2: consumer warpgroup w issues its products after a
// sync on barrier 1 + w and then arrives on the other's, so the two take
// turns on the tensor cores and one's softmax runs under the other's products.
__device__ __forceinline__ void turn_wait(int wg) { named_sync(1 + wg, 256); }
__device__ __forceinline__ void turn_pass(int wg) { named_arrive(2 - wg, 256); }

template <int D, int N>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int H, int Sq, int Sk, int d, int q_tiles,
                       int items, long long o_sb, long long o_ss, long long o_sh,
                       float scale_log2) {
  using Cfg = Config<D, N>;
  constexpr int kStages = Cfg::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kAtomBytes - smem_addr(smem_raw) % kAtomBytes) % kAtomBytes);
  unsigned char* sQ = smem;                             // [col tile][128 rows][128 B]
  unsigned char* sK = sQ + Cfg::kQBytes;                // [stage][col tile][N keys][128 B]
  unsigned char* sV = sK + kStages * Cfg::kStageBytes;  // the same
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * Cfg::kStageBytes);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_full + 2;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;
  const int ntiles = (Sk + N - 1) / N;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one arrival per consumer warp
    for (int i = 0; i < kStages; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(v_full + i, 1);
      mbar_init(empty + i, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // A CTA walks the work items blockIdx.x, blockIdx.x + gridDim.x, ...: item
  // i is Q tile i % q_tiles of (batch, head) i / q_tiles, so a (b, h)'s tiles
  // run side by side on neighbouring CTAs and share its K/V through L2.
  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int stage = 0, local = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++local) {
        const int bh = item / q_tiles, q0 = (item % q_tiles) * kBlockM;
        const int b = bh / H, h = bh % H;
        // the next Q tile overwrites the last only once both consumer
        // warpgroups have issued their last Q K^T of it and seen it complete
        if (local > 0) mbar_wait(q_empty, (local - 1) & 1);
        mbar_arrive_expect_tx(q_full, Cfg::kQBytes);
        for (int c = 0; c < Cfg::kColTiles; ++c)
          tma_load_4d(sQ + c * Cfg::kQTile, &map_q, q_full, c * 64, h, q0, b);
        for (int it = 0; it < ntiles; ++it) {
          mbar_wait(empty + stage, phase ^ 1);  // passes at once the first time round
          mbar_arrive_expect_tx(k_full + stage, Cfg::kStageBytes);
          for (int c = 0; c < Cfg::kColTiles; ++c)
            tma_load_4d(sK + stage * Cfg::kStageBytes + c * Cfg::kKVTile, &map_k,
                        k_full + stage, c * 64, h, it * N, b);
          mbar_arrive_expect_tx(v_full + stage, Cfg::kStageBytes);
          for (int c = 0; c < Cfg::kColTiles; ++c)
            tma_load_4d(sV + stage * Cfg::kStageBytes + c * Cfg::kKVTile, &map_v,
                        v_full + stage, c * 64, h, it * N, b);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 Q rows each ----
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const unsigned char* q_rows = sQ + wg * 64 * kRowBytes;  // rows 64 wg.. of each col tile

    float s[Cfg::kS];
    float acc[Cfg::kAcc] = {};  // each item's first P V overwrites it (scale_d 0)
    uint32_t p[Cfg::kKeySteps][4];
    float alpha[2];
    int stage = 0, local = 0;
    uint32_t phase = 0;
    if (wg == 1) turn_pass(1);  // warpgroup 0 goes first
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++local) {
      const int bh = item / q_tiles, q0 = (item % q_tiles) * kBlockM;
      float m[2] = {-INFINITY, -INFINITY};  // running max of the raw logits, rows g and g + 8
      float l[2] = {0.f, 0.f};

      mbar_wait(q_full, local & 1);
      mbar_wait(k_full + stage, phase);
      wgmma_fence();
      issue_qk<D, N>(s, q_rows, sK + stage * Cfg::kStageBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if (ntiles == 1 && lane == 0) mbar_arrive(q_empty);  // this warp is done with Q
      softmax_tile<N>(s, m, l, alpha, Sk, t, scale_log2);
      pack_p<N>(p, s);

      for (int it = 1; it < ntiles; ++it) {
        const int next = stage + 1 == kStages ? 0 : stage + 1;
        const uint32_t next_phase = next == 0 ? phase ^ 1 : phase;
        mbar_wait(k_full + next, next_phase);
        mbar_wait(v_full + stage, phase);
        turn_wait(wg);
        fence_regs(s);
        fence_regs(acc);
        wgmma_fence();
        issue_qk<D, N>(s, q_rows, sK + next * Cfg::kStageBytes);
        wgmma_commit();
        issue_pv<D, N>(acc, p, sV + stage * Cfg::kStageBytes, it > 1);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<1>();  // the logits of tile `it`; P V of tile it - 1 still runs
        fence_regs(s);
        if (it == ntiles - 1 && lane == 0) mbar_arrive(q_empty);
        softmax_tile<N>(s, m, l, alpha, Sk - it * N, t, scale_log2);
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty + stage);  // this warp is done with K and V of it - 1
#pragma unroll
        for (int i = 0; i < Cfg::kAcc; ++i) acc[i] *= alpha[(i / 2) & 1];
        pack_p<N>(p, s);
        stage = next;
        phase = next_phase;
      }
      mbar_wait(v_full + stage, phase);
      turn_wait(wg);
      fence_regs(acc);
      wgmma_fence();
      issue_pv<D, N>(acc, p, sV + stage * Cfg::kStageBytes, ntiles > 1);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + stage);  // the last K/V stage is free for the next item
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }

      // the four threads of a row hold disjoint columns: sum their shares
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const int b = bh / H, h = bh % H;
      if (q0 + wg * 64 + warp * 16 >= Sq) continue;  // this warp's 16 rows are all past S_q
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + wg * 64 + warp * 16 + g + 8 * r;
        const float inv_l = 1.f / l[r];
        __nv_bfloat16* orow = o + b * o_sb + (long long)row * o_ss + h * o_sh;
        if (Cfg::kWholeBlockStores && Sq >= kBlockM) {  // the same in every lane
          // four 8-column blocks at a time, each thread stores one whole
          // block (see store_words); the shuffles run in every lane, rows
          // past S_q and columns past the head dim are not written
#pragma unroll
          for (int n0 = 0; n0 < D / 8; n0 += 4) {
            uint32_t v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v[j] = n0 + j < D / 8 ? pack_bf16(acc[4 * (n0 + j) + 2 * r] * inv_l,
                                                acc[4 * (n0 + j) + 2 * r + 1] * inv_l)
                                    : 0u;
            const uint4 w = store_words(v, t);
            if (row < Sq && (n0 + t) * 8 < d)
              *reinterpret_cast<uint4*>(orow + (n0 + t) * 8) = w;
          }
        } else {
#pragma unroll
          for (int n = 0; n < D / 8; ++n)
            if (row < Sq && n * 8 < d)
              *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
                  pack_bf16(acc[4 * n + 2 * r] * inv_l, acc[4 * n + 2 * r + 1] * inv_l);
        }
        if (t == 0 && row < Sq)
          lse[(long long)bh * Sq + row] = (m[r] * scale_log2 + log2f(l[r])) * kLn2;
      }
    }
  }
}

template <int D, int N>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                   int Sq, int Sk, int d, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale_log2, cudaStream_t stream) {
  static bool allowed[kMaxDevices] = {};
  const cudaError_t attr =
      allow_dynamic_smem(flash_fwd_wgmma_kernel<D, N>, Config<D, N>::kSmem, allowed);
  if (attr != cudaSuccess) return attr;
  alignas(64) CUtensorMap mq, mk, mv;
  if (!make_bshd_map(&mq, q, B, H, Sq, d, qs, kBlockM) ||
      !make_bshd_map(&mk, k, B, H, Sk, d, ks, N) || !make_bshd_map(&mv, v, B, H, Sk, d, vs, N))
    return cudaErrorInvalidValue;
  const int q_tiles = (Sq + kBlockM - 1) / kBlockM;
  const long long items = (long long)q_tiles * B * H;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  int ctas = (int)items;
  if (kPersistent) {
    const int sms = sm_count();
    if (sms <= 0) return cudaErrorInvalidDevice;
    ctas = ctas < sms ? ctas : sms;
  }
  flash_fwd_wgmma_kernel<D, N><<<ctas, kThreads, Config<D, N>::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Sq, Sk, d,
      q_tiles, (int)items, os.b, os.s, os.h, scale_log2);
  return cudaGetLastError();
}

// Whether instance D (key tile N) takes S_k keys on the short-key tile
// instead: where it has one (kShort) and that covers the keys in fewer key
// slots than N's tiles do.
template <int N, bool kShort>
bool short_tile(int Sk) {
  return kShort && Sk <= kShortKeys && (Sk + N - 1) / N * N > kShortKeys;
}

template <int D, int N, bool kShort>
cudaError_t launch_instance(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int H, int Sq, int Sk, int d, Strides qs, Strides ks,
                            Strides vs, Strides os, float scale_log2, cudaStream_t stream) {
  if constexpr (kShort) {
    if (short_tile<N, kShort>(Sk))
      return launch<D, kShortKeys>(q, k, v, o, lse, B, H, Sq, Sk, d, qs, ks, vs, os, scale_log2,
                                   stream);
  }
  return launch<D, N>(q, k, v, o, lse, B, H, Sq, Sk, d, qs, ks, vs, os, scale_log2, stream);
}

template <int D, int N, bool kShort>
int smem_instance(int Sk) {
  if constexpr (kShort) {
    if (short_tile<N, kShort>(Sk)) return Config<D, kShortKeys>::kSmem;
  }
  return Config<D, N>::kSmem;
}

// The instances: head dim, key tile, whether a short-key tile stands beside
// it (the head dims of the paths' cross-attention to 77 tokens and of
// ADM-256's 64-token level).
#define DMTPU_WGMMA_INSTANCES(X) \
  X(40, 128, true) X(64, 128, true) X(72, 128, false) X(80, 128, true) X(160, 64, true) \
  X(256, 64, false)

}  // namespace

// q, k, v, o: bf16 [B, S, H, D] with the given element strides (D contiguous,
// D a multiple of 8 up to 256, every stride a positive multiple of 8, 16-byte
// aligned pointers).  A head dim runs on the narrowest instance at least as
// wide: 40, 64, 72, 80, 160 or 256.  lse: f32 [B, H, Sq], contiguous.
// scale_log2 = softmax scale * log2(e), positive.  Returns the CUDA error code
// of the launch (0 on success; cudaErrorInvalidValue for a head dim, scale or
// strides it does not take).
extern "C" int dmtpu_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int H, int Sq, int Sk, int D,
                                    long long qsb, long long qss, long long qsh,
                                    long long ksb, long long kss, long long ksh,
                                    long long vsb, long long vss, long long vsh,
                                    long long osb, long long oss, long long osh,
                                    float scale_log2, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 || D > 256 || !(scale_log2 > 0.f)) return (int)cudaErrorInvalidValue;
#define DMTPU_LAUNCH(WIDTH, N, SHORT)                                                       \
  if (D <= WIDTH)                                                                           \
    return (int)launch_instance<WIDTH, N, SHORT>(q, k, v, o, lse, B, H, Sq, Sk, D, qs, ks, \
                                                 vs, os, scale_log2, st);
  DMTPU_WGMMA_INSTANCES(DMTPU_LAUNCH)
#undef DMTPU_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory, in bytes, of the instance that a call with head
// dim D and Sk keys launches (0 for a head dim it does not take).
extern "C" int dmtpu_flash_attn_fwd_smem(int D, int Sk) {
  if (D <= 0 || D % 8) return 0;
#define DMTPU_SMEM(WIDTH, N, SHORT) \
  if (D <= WIDTH) return smem_instance<WIDTH, N, SHORT>(Sk);
  DMTPU_WGMMA_INSTANCES(DMTPU_SMEM)
#undef DMTPU_SMEM
  return 0;
}
#undef DMTPU_WGMMA_INSTANCES
