// K1: non-causal attention forward for Hopper (sm_90a), bf16 in and out:
// the kernel of the large self-attention shapes (head dims 40 and 80).
//
// Replaces dmtpu/ops/flash_small_d.py::_fwd_kernel / _fwd (the Pallas TPU
// flash kernel for small head dims) and the forward role of the stock Pallas
// TPU flash kernel that dmtpu/ops/attention.py::flash_mha calls.  Shapes it
// does not take (head dim 160, and the small or cross-attention shapes where
// it is no faster) go to the mma.sync kernel in flash_attn_fwd_mma.cu; the
// gate is in dmtpu_torch/ops/flash_attention.py.
//
// What it computes, per (batch, head): O = softmax(Q K^T * scale) V by online
// softmax (running max, running sum and the O accumulator in f32; P rounded
// to bf16 for the PV product), plus the row logsumexp in f32 for the backward.
//
// What bounds it on this card: operations.  At S=4096, d=40 the S x S logits
// cost 344 GFLOP on the tensor cores, and their softmax one exponential per
// logit: 2.1e9 a call, on special-function units that retire 16 a clock on
// each SM.  The exponentials take longer than the products, so the two must
// run at the same time.  The design:
//   - wgmma for both products.  A CTA is three warpgroups: one producer and
//     two consumers of 64 Q rows each, so a K/V tile is read once for 128
//     rows.  S = Q K^T is m64n128k16 with Q and K read from shared memory
//     (both K-major); O += P V takes P from registers (the S accumulator
//     re-packed to bf16 in place) and V from shared memory through the
//     transposing descriptor (V is [keys][d]: MN-major for this product);
//   - TMA: one producer thread fills a ring of K/V stages with
//     cp.async.bulk.tensor boxes of 128 rows x 64 columns in the 128-byte
//     swizzle; "full" mbarriers carry the byte counts, consumer warps arrive
//     on "empty" ones.  The [B, S, H, D] strides become a rank-4 tensor map
//     (D, H, S, B), so projection outputs are read in place.  setmaxnreg moves
//     the producer's registers to the consumers (24 / 240);
//   - head dims that are no multiple of 64 cost nothing in device memory:
//     the box is 64 columns wide and columns past D are out of bounds, which
//     TMA zero-fills without reading.  Q K^T runs over ceil(D / 16) steps
//     (48 columns for d=40, 80 for d=80, the second 64-column tile holding
//     columns 64..79); P V is a single wgmma of width D (n40, n80);
//   - overlap: each consumer issues the next tile's Q K^T and the current
//     tile's P V together, and computes the softmax of the next tile while
//     P V runs; the two consumer warpgroups take turns issuing their
//     products (two named barriers), so one's exponentials run under the
//     other's tensor-core time.  The scale is folded into one fused
//     multiply-add before ex2.approx;
//   - keys past S_k (zero-filled by TMA) are masked to -inf in the last tile;
//     rows past S_q are computed on zeros and not written.
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace dmtpu;

constexpr int kBlockM = 128;              // Q rows per CTA: two consumer warpgroups x 64
constexpr int kBlockN = 128;              // keys per K/V tile
constexpr int kThreads = 384;             // producer warpgroup + two consumer warpgroups
constexpr int kTileBytes = 128 * 64 * 2;  // one [128 rows][64 bf16] swizzled tile
constexpr int kAtomBytes = 1024;          // 8 rows x 128 bytes: the swizzle's period
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Config {
  static constexpr int kColTiles = (D + 63) / 64;  // 64-column tiles per row
  static constexpr int kSteps = (D + 15) / 16;     // k16 steps of Q K^T
  static constexpr int kStages = kColTiles == 1 ? 4 : 3;
  static constexpr int kAcc = D / 2;               // f32 registers of O per thread
  static constexpr int kRowBytes = kColTiles * kTileBytes;  // Q, or one K or V stage
  static constexpr int kBarriers = 1 + 3 * kStages;
  // 1024 spare bytes to align the tiles
  static constexpr int kSmem = kAtomBytes + kRowBytes * (1 + 2 * kStages) + 8 * kBarriers;
};

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  if constexpr (D == 40) wgmma_rs_n40(o, a, desc, scale_d);
  if constexpr (D == 80) wgmma_rs_n80(o, a, desc, scale_d);
}

// S = Q K^T for this warpgroup's 64 rows and one 128-key tile (not committed).
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], const unsigned char* q_rows,
                                         const unsigned char* k_tile) {
#pragma unroll
  for (int kk = 0; kk < Config<D>::kSteps; ++kk) {
    const int off = (kk / 4) * kTileBytes + (kk % 4) * 32;
    wgmma_ss_n128(s, wgmma_desc(q_rows + off, 16, kAtomBytes),
                  wgmma_desc(k_tile + off, 16, kAtomBytes), kk > 0);
  }
}

// O (+)= P V for one 128-key tile (not committed).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[8][4],
                                         const unsigned char* v_tile, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
    wgmma_pv<D>(o, p[kk], wgmma_desc(v_tile + kk * 16 * 128, kTileBytes, kAtomBytes),
                accumulate || kk > 0);
}

// Online softmax of one tile of raw logits, in place: s becomes
// exp2((s - m) * scale_log2) for the updated running max m; l is this
// thread's share of the running sum.  alpha is the factor the old O and l
// shrink by.  Thread (g, t) holds rows g (s[4j], s[4j+1]) and g + 8
// (s[4j+2], s[4j+3]) at columns 8j + 2t, 8j + 2t + 1.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int valid_keys, int t,
                                             float scale_log2) {
  if (valid_keys < kBlockN) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if ((i / 4) * 8 + 2 * t + (i & 1) >= valid_keys) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s[i]);
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
  for (int i = 0; i < 64; ++i) {
    s[i] = ex2(fmaf(s[i], scale_log2, -mc[(i / 2) & 1]));
    l[(i / 2) & 1] += s[i];
  }
}

// The A operands of P V from the S accumulator: k16 step kk is the 8-column
// blocks 2kk and 2kk + 1.
__device__ __forceinline__ void pack_p(uint32_t (&p)[8][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Named barriers 1 and 2: consumer warpgroup w issues its products after a
// sync on barrier 1 + w and then arrives on the other's, so the two take
// turns on the tensor cores and one's softmax runs under the other's products.
__device__ __forceinline__ void turn_wait(int wg) { named_sync(1 + wg, 256); }
__device__ __forceinline__ void turn_pass(int wg) { named_arrive(2 - wg, 256); }

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int H, int Sq, int Sk, long long o_sb,
                       long long o_ss, long long o_sh, float scale_log2) {
  using Cfg = Config<D>;
  constexpr int kStages = Cfg::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kAtomBytes - smem_addr(smem_raw) % kAtomBytes) % kAtomBytes);
  unsigned char* sQ = smem;                             // [col tile][128 rows][128 B]
  unsigned char* sK = sQ + Cfg::kRowBytes;              // [stage][col tile][128 keys][128 B]
  unsigned char* sV = sK + kStages * Cfg::kRowBytes;    // the same
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * Cfg::kRowBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBlockM;
  const int ntiles = (Sk + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(v_full + i, 1);
      mbar_init(empty + i, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, Cfg::kRowBytes);
      for (int c = 0; c < Cfg::kColTiles; ++c)
        tma_load_4d(sQ + c * kTileBytes, &map_q, q_full, c * 64, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < ntiles; ++it) {
        mbar_wait(empty + stage, phase ^ 1);  // passes at once the first time round
        mbar_arrive_expect_tx(k_full + stage, Cfg::kRowBytes);
        for (int c = 0; c < Cfg::kColTiles; ++c)
          tma_load_4d(sK + stage * Cfg::kRowBytes + c * kTileBytes, &map_k, k_full + stage,
                      c * 64, h, it * kBlockN, b);
        mbar_arrive_expect_tx(v_full + stage, Cfg::kRowBytes);
        for (int c = 0; c < Cfg::kColTiles; ++c)
          tma_load_4d(sV + stage * Cfg::kRowBytes + c * kTileBytes, &map_v, v_full + stage,
                      c * 64, h, it * kBlockN, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 Q rows each ----
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const unsigned char* q_rows = sQ + wg * 64 * 128;  // rows 64 wg.. of each column tile

    float s[64];
    float acc[Cfg::kAcc] = {};
    uint32_t p[8][4];
    float m[2] = {-INFINITY, -INFINITY};  // running max of the raw logits, rows g and g + 8
    float l[2] = {0.f, 0.f};
    float alpha[2];

    if (wg == 1) turn_pass(1);  // warpgroup 0 goes first
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    wgmma_fence();
    issue_qk<D>(s, q_rows, sK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, m, l, alpha, Sk, t, scale_log2);
    pack_p(p, s);

    int stage = 0;
    uint32_t phase = 0;
    for (int it = 1; it < ntiles; ++it) {
      const int next = stage + 1 == kStages ? 0 : stage + 1;
      const uint32_t next_phase = next == 0 ? phase ^ 1 : phase;
      mbar_wait(k_full + next, next_phase);
      mbar_wait(v_full + stage, phase);
      turn_wait(wg);
      fence_regs(s);
      fence_regs(acc);
      wgmma_fence();
      issue_qk<D>(s, q_rows, sK + next * Cfg::kRowBytes);
      wgmma_commit();
      issue_pv<D>(acc, p, sV + stage * Cfg::kRowBytes, it > 1);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();  // the logits of tile `it`; P V of tile it - 1 still runs
      fence_regs(s);
      softmax_tile(s, m, l, alpha, Sk - it * kBlockN, t, scale_log2);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + stage);  // this warp is done with K and V of it - 1
#pragma unroll
      for (int i = 0; i < Cfg::kAcc; ++i) acc[i] *= alpha[(i / 2) & 1];
      pack_p(p, s);
      stage = next;
      phase = next_phase;
    }
    mbar_wait(v_full + stage, phase);
    turn_wait(wg);
    fence_regs(acc);
    wgmma_fence();
    issue_pv<D>(acc, p, sV + stage * Cfg::kRowBytes, ntiles > 1);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(acc);

    // the four threads of a row hold disjoint columns: sum their shares
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wg * 64 + warp * 16 + g + 8 * r;
      if (row >= Sq) continue;
      const float inv_l = 1.f / l[r];
      __nv_bfloat16* orow = o + b * o_sb + (long long)row * o_ss + h * o_sh;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
            pack_bf16(acc[4 * n + 2 * r] * inv_l, acc[4 * n + 2 * r + 1] * inv_l);
      if (t == 0) lse[(long long)bh * Sq + row] = (m[r] * scale_log2 + log2f(l[r])) * kLn2;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                   int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale_log2, cudaStream_t stream) {
  static bool allowed[kMaxDevices] = {};
  const cudaError_t attr =
      allow_dynamic_smem(flash_fwd_wgmma_kernel<D>, Config<D>::kSmem, allowed);
  if (attr != cudaSuccess) return attr;
  alignas(64) CUtensorMap mq, mk, mv;
  if (!make_bshd_map(&mq, q, B, H, Sq, D, qs, kBlockM) ||
      !make_bshd_map(&mk, k, B, H, Sk, D, ks, kBlockN) ||
      !make_bshd_map(&mv, v, B, H, Sk, D, vs, kBlockN))
    return cudaErrorInvalidValue;
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, Config<D>::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Sq, Sk, os.b, os.s,
      os.h, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: bf16 [B, S, H, D] with the given element strides (D contiguous,
// D 40 or 80, every stride a positive multiple of 8, 16-byte aligned
// pointers).  lse: f32 [B, H, Sq], contiguous.  scale_log2 = softmax scale *
// log2(e), positive.  Returns the CUDA error code of the launch (0 on
// success; cudaErrorInvalidValue for a head dim or strides it does not take).
extern "C" int dmtpu_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int H, int Sq, int Sk, int D,
                                    long long qsb, long long qss, long long qsh,
                                    long long ksb, long long kss, long long ksh,
                                    long long vsb, long long vss, long long vsh,
                                    long long osb, long long oss, long long osh,
                                    float scale_log2, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 40)
    return (int)launch<40>(q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, os, scale_log2, st);
  if (D == 80)
    return (int)launch<80>(q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, os, scale_log2, st);
  return (int)cudaErrorInvalidValue;
}
