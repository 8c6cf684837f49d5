// K3: GroupNorm (+ optional SiLU) forward for Hopper (sm_90a).
//
// Replaces dmtpu/ops/groupnorm.py::_kernel / _pallas_forward (the Pallas TPU
// fused GroupNorm+SiLU kernel).
//
// What it computes: for each sample and group, the mean and (biased) variance
// of the group's (C/G) x H x W values in f32, then y = (x - mean) * rstd *
// weight[c] + bias[c], optionally y * sigmoid(y), written in the input dtype.
//
// What bounds it on this card: bytes.  It does a handful of operations per
// element, far below the ~295 operations per byte at which the tensor cores
// would become the limit; the least it can move is x once in and y once out.
// The TPU kernel held a whole [H*W, C] sample in VMEM and read it once; here
// a sample is up to 268 MB (SDXL's 1024x1024 decode in f32), far beyond one
// SM's shared memory, so the kernels below read x for the statistics and
// then normalise it from registers or shared memory where it fits, or read
// it again, the second read coming partly out of the 50 MB L2 cache.  Five
// kernels, chosen by dmtpu_torch/ops/groupnorm.py::plan:
//   - "rows", for channels-last (N, H, W, C in memory; cuDNN returns the
//     UNet's bf16 convolutions so): a group is only C/G contiguous values at
//     each pixel (20 bytes at a 640-byte stride for C=320), so a CTA takes
//     whole pixel rows instead, 16 bytes a thread along C, and the CTAs of a
//     sample form a thread block cluster that merges the per-group
//     statistics through distributed shared memory, in a fixed order and
//     without atomics.  See the comment at group_norm_rows_kernel;
//   - "team", for contiguous NCHW (every VAE decode, the pixel UNets): the
//     (sample, group) slab is contiguous, so it is spread over a team of
//     CTAs, held by one CTA, or held by one warp, by its size; see the
//     comment at group_norm_held_kernel;
//   - one CTA per (sample, group) over contiguous NCHW (the group is one
//     slab, read 16 bytes at a time): the first port, which "team" replaced
//     on every path; kept for comparison (kernel="nchw");
//   - "chunks", for the channels-last shapes "rows" does not take (C no
//     multiple of 8, fewer than 8 channels a group): 16-byte chunks of a
//     fixed channel set a thread, a cluster per sample that holds it in
//     shared memory where it fits; see the comment at group_norm_chunks_kernel;
//   - one CTA per (sample, group) over channels-last, two values at a time:
//     the first port's kernel for the shapes "rows" does not take, which
//     "chunks" replaced on every path; kept for comparison (kernel="groups").
// The statistics are (count, mean, M2) states merged with Chan's formula
// across threads, warps and CTAs; a thread's own state comes from exact
// two-pass moments of 8-value chunks (the per-group kernels) or from sums of
// x - shift and (x - shift)^2 with the shift at its first pixel's group mean
// (the rows kernel); "chunks" sums x - shift and its square around one shift
// per group for the whole sample.  The TPU kernel's E[x^2] - E[x]^2, which
// cancels badly in f32, is not copied.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers and bulk copies ("stream")

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  __align__(16) __nv_bfloat16 e[8];
  for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(e);
}

// Chan et al.'s merge of two (count, mean, M2) states into the first.
__device__ __forceinline__ void merge(float& n, float& mean, float& m2, float nb, float meanb,
                                      float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float delta = meanb - mean;
  const float wb = nb / nn;
  mean += delta * wb;
  m2 += m2b + delta * delta * n * wb;
  n = nn;
}

// Two values at a time, for the channels-last layout (C/G is even).
__device__ __forceinline__ void load2(const float* p, float* v) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  v[0] = a.x; v[1] = a.y;
}

__device__ __forceinline__ void load2(const __nv_bfloat16* p, float* v) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
  v[0] = __low2float(a); v[1] = __high2float(a);
}

__device__ __forceinline__ void store2(float* p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

// Exact two-pass moments of n (<= 8) values, folded into (cnt, mean, m2).
__device__ __forceinline__ void fold(float& cnt, float& mean, float& m2, const float* v, int n) {
  if (n == 0) return;
  float s = 0.f;
  for (int j = 0; j < n; ++j) s += v[j];
  const float mb = s / n;
  float m2b = 0.f;
  for (int j = 0; j < n; ++j) m2b += (v[j] - mb) * (v[j] - mb);
  merge(cnt, mean, m2, (float)n, mb, m2b);
}

// One CTA per (sample, group).  kNhwc = false: x is contiguous NCHW and the
// group is one contiguous slab of (C/G)*HW values, read 8 at a time.
// kNhwc = true: x is channels-last (N, H, W, C in memory) and the group is
// C/G contiguous values at each of the HW pixels, read 2 at a time.
template <typename T, bool kSilu, bool kNhwc>
__global__ void __launch_bounds__(kThreads)
group_norm_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                  const float* __restrict__ bias, T* __restrict__ y, int C, int HW, int G,
                  float eps) {
  const int ng = blockIdx.x;  // n * G + g
  const int n = ng / G, g = ng % G;
  const int cg = C / G;
  const long long slab = (long long)cg * HW;
  constexpr int kVec = kNhwc ? 2 : 8;
  const long long nvec = slab / kVec;
  // NCHW: group g of sample n starts at (n * C + g * cg) * HW = ng * slab.
  // NHWC: vector i is pixel i / (cg / 2), channels g * cg + 2 * (i % (cg / 2)) + {0, 1}.
  const long long base = kNhwc ? (long long)n * HW * C + g * cg : (long long)ng * slab;
  auto offset = [&](long long i) -> long long {
    if constexpr (kNhwc) return base + (i / (cg / 2)) * C + 2 * (i % (cg / 2));
    return base + i * 8;
  };
  auto channel = [&](long long i) -> int {
    if constexpr (kNhwc) return g * cg + 2 * (int)(i % (cg / 2));
    return g * cg + (int)((i * 8) / HW);  // HW % 8 == 0: an 8-chunk is one channel
  };

  float cnt = 0.f, mean = 0.f, m2 = 0.f;
  if constexpr (kNhwc) {
    // four pairs per step, so the two-pass fold sees 8 values
    for (long long i = threadIdx.x; i < nvec; i += 4 * kThreads) {
      float v[8];
      int nv = 0;
      for (int u = 0; u < 4; ++u) {
        const long long k = i + (long long)u * kThreads;
        if (k < nvec) {
          load2(x + offset(k), v + nv);
          nv += 2;
        }
      }
      fold(cnt, mean, m2, v, nv);
    }
  } else {
    for (long long i = threadIdx.x; i < nvec; i += kThreads) {
      float v[8];
      load8(x + offset(i), v);
      fold(cnt, mean, m2, v, 8);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, cnt, off);
    const float mb = __shfl_xor_sync(0xffffffffu, mean, off);
    const float m2b = __shfl_xor_sync(0xffffffffu, m2, off);
    merge(cnt, mean, m2, nb, mb, m2b);
  }
  __shared__ float s_n[kThreads / 32], s_mean[kThreads / 32], s_m2[kThreads / 32];
  __shared__ float s_stats[2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_n[warp] = cnt;
    s_mean[warp] = mean;
    s_m2[warp] = m2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tn = 0.f, tmean = 0.f, tm2 = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) merge(tn, tmean, tm2, s_n[w], s_mean[w], s_m2[w]);
    s_stats[0] = tmean;
    s_stats[1] = rsqrtf(tm2 / tn + eps);
  }
  __syncthreads();
  const float gmean = s_stats[0], rstd = s_stats[1];

  for (long long i = threadIdx.x; i < nvec; i += kThreads) {
    const int c = channel(i);
    float v[8];
    if (kNhwc) load2(x + offset(i), v); else load8(x + offset(i), v);
    for (int j = 0; j < kVec; ++j) {
      const int cj = kNhwc ? c + j : c;
      const float sc = weight[cj] * rstd;
      float t = v[j] * sc + (bias[cj] - gmean * sc);
      if (kSilu) t = t / (1.f + expf(-t));
      v[j] = t;
    }
    if (kNhwc) store2(y + offset(i), v); else store8(y + offset(i), v);
  }
}

// ---- channels-last, a block of pixels per CTA ("rows") ----------------------
// x is [N][HW][C] in memory.  The CTAs of one thread block cluster share a
// sample; its pixel rows go round them in turn, `rows` at a time.  A thread
// owns one 8-channel chunk of the pixel row (chunk cc = tid % (C / 8)) at
// every (cluster size * rows)-th pixel, so a warp reads whole rows, 16 bytes a
// thread at neighbouring addresses, and a thread's channels, groups, weights
// and biases never change.  With C / G >= 8 a chunk lies in at most two groups: A holds
// its first `na` channels and B the rest.  Both passes keep two batches of
// loads in registers: the next batch is in flight while this one is used.
constexpr int kMaxRowThreads = 512;
constexpr int kMaxGroups = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDepth = 4;  // pixel rows of one batch of loads; two batches are live

// The 8 values of one thread at one pixel, as loaded.
template <typename T>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void unpack(float* v) const {
    // a bf16 is the upper half of its f32
    v[0] = __uint_as_float(raw.x << 16); v[1] = __uint_as_float(raw.x & 0xffff0000u);
    v[2] = __uint_as_float(raw.y << 16); v[3] = __uint_as_float(raw.y & 0xffff0000u);
    v[4] = __uint_as_float(raw.z << 16); v[5] = __uint_as_float(raw.z & 0xffff0000u);
    v[6] = __uint_as_float(raw.w << 16); v[7] = __uint_as_float(raw.w & 0xffff0000u);
  }
};
template <>
struct Chunk<float> {
  uint4 lo, hi;
  __device__ __forceinline__ void load(const float* p) {
    lo = reinterpret_cast<const uint4*>(p)[0];
    hi = reinterpret_cast<const uint4*>(p)[1];
  }
  __device__ __forceinline__ void unpack(float* v) const {
    v[0] = __uint_as_float(lo.x); v[1] = __uint_as_float(lo.y);
    v[2] = __uint_as_float(lo.z); v[3] = __uint_as_float(lo.w);
    v[4] = __uint_as_float(hi.x); v[5] = __uint_as_float(hi.y);
    v[6] = __uint_as_float(hi.z); v[7] = __uint_as_float(hi.w);
  }
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, bool kSilu>
__global__ void __launch_bounds__(kMaxRowThreads)
group_norm_rows_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                       const float* __restrict__ bias, T* __restrict__ y, int C, int HW, int G,
                       float eps, int rows) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float t_n[2][kMaxRowThreads], t_mean[2][kMaxRowThreads], t_m2[2][kMaxRowThreads];
  __shared__ float part[3][kMaxGroups];  // this CTA's (count, mean, M2) per group
  __shared__ float fin[2][kMaxGroups];   // the sample's mean and rstd per group

  const int rank = blockIdx.x, csize = gridDim.x;  // the cluster spans the grid's x
  const int tid = threadIdx.x, threads = blockDim.x;
  const int cpr = C / 8, cpg = C / G;               // chunks per pixel row, channels per group
  const bool active = tid < rows * cpr;
  const int r = tid / cpr, cc = tid % cpr;
  const int c0 = cc * 8;
  const int ga = c0 / cpg;
  const int na = min(8, (ga + 1) * cpg - c0);      // channels of the chunk in group ga
  // pixel rows go round the cluster in turn, `rows` at a time: at any moment
  // the CTAs of a sample read neighbouring ranges of memory
  const int stride = csize * rows;                  // between a thread's pixels
  const int p_first = rank * rows + r;
  const int p_end = active ? HW : 0;
  const int step = kDepth * stride;
  const T* src = x + (long long)blockIdx.y * HW * C + c0;
  T* dst = y + (long long)blockIdx.y * HW * C + c0;

  auto load_batch = [&](Chunk<T>(&batch)[kDepth], int p) {
#pragma unroll
    for (int u = 0; u < kDepth; ++u)
      if (p + u * stride < p_end) batch[u].load(src + (long long)(p + u * stride) * C);
  };

  // pass 1: sums of d = x - shift and of d * d over all 8 channels and over
  // A's alone (B is the difference), the shifts being the group means of the
  // thread's first pixel: close to the mean, so the squares do not cancel
  float in_a[8], shift[8];
  float s_all = 0.f, q_all = 0.f, s_a = 0.f, q_a = 0.f, shift_a = 0.f, shift_b = 0.f;
  int folds = 0;
  Chunk<T> cur[kDepth], nxt[kDepth];
#pragma unroll
  for (int j = 0; j < 8; ++j) in_a[j] = j < na ? 1.f : 0.f;
  load_batch(cur, p_first);
  if (p_first < p_end) {
    float v[8];
    cur[0].unpack(v);
    float sum_all = 0.f, sum_a = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sum_all += v[j];
      sum_a = fmaf(v[j], in_a[j], sum_a);
    }
    shift_a = sum_a / na;
    shift_b = na < 8 ? (sum_all - sum_a) / (8 - na) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) shift[j] = j < na ? shift_a : shift_b;
  for (int p = p_first; p < p_end; p += step) {
    load_batch(nxt, p + step);
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      if (p + u * stride >= p_end) break;
      float v[8];
      cur[u].unpack(v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[j] - shift[j];
        const float dd = d * d;
        s_all += d;
        q_all += dd;
        s_a = fmaf(d, in_a[j], s_a);
        q_a = fmaf(dd, in_a[j], q_a);
      }
      ++folds;
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u) cur[u] = nxt[u];
  }
  // (count, mean, M2) of the thread's share of A and of B
  {
    const float n_a = (float)(folds * na), n_b = (float)(folds * (8 - na));
    const float s_b = s_all - s_a, q_b = q_all - q_a;
    t_n[0][tid] = n_a;
    t_mean[0][tid] = n_a > 0.f ? shift_a + s_a / n_a : 0.f;
    t_m2[0][tid] = n_a > 0.f ? fmaxf(q_a - s_a * s_a / n_a, 0.f) : 0.f;
    t_n[1][tid] = n_b;
    t_mean[1][tid] = n_b > 0.f ? shift_b + s_b / n_b : 0.f;
    t_m2[1][tid] = n_b > 0.f ? fmaxf(q_b - s_b * s_b / n_b, 0.f) : 0.f;
  }
  __syncthreads();

  // the CTA's state of each group: one warp per group, lanes over the
  // (pixel row, chunk) threads that hold a share of it, then a fixed tree
  const int warp = tid / 32, lane = tid % 32, nwarps = threads / 32;
  for (int g = warp; g < G; g += nwarps) {
    const int cc_lo = (g * cpg) / 8, ncc = ((g + 1) * cpg - 1) / 8 - cc_lo + 1;
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int e = lane; e < rows * ncc; e += 32) {
      const int ecc = cc_lo + e % ncc;
      const int owner = (e / ncc) * cpr + ecc;
      const int slot = (ecc * 8) / cpg == g ? 0 : 1;
      merge(n, mean, m2, t_n[slot][owner], t_mean[slot][owner], t_m2[slot][owner]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float nb = __shfl_xor_sync(0xffffffffu, n, off);
      const float mb = __shfl_xor_sync(0xffffffffu, mean, off);
      const float m2b = __shfl_xor_sync(0xffffffffu, m2, off);
      merge(n, mean, m2, nb, mb, m2b);
    }
    if (lane == 0) {
      part[0][g] = n;
      part[1][g] = mean;
      part[2][g] = m2;
    }
  }
  // pass 2 runs from the last batch to the first: what pass 1 read last is the
  // likeliest to be in the L2 cache still.  Its first loads fly during the merge
  const int nbatch = p_first < p_end ? (p_end - p_first + step - 1) / step : 0;
  int p = p_first + (nbatch - 1) * step;
  if (nbatch > 0) load_batch(cur, p);
  // the sample's state: every CTA reads the partial states of all CTAs of the
  // cluster through distributed shared memory and merges them in rank order,
  // so all of them hold the same statistics, bit for bit, with no atomics
  cluster.sync();
  if (tid < G) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int other = 0; other < csize; ++other) {
      const float* remote = cluster.map_shared_rank(&part[0][0], other);
      merge(n, mean, m2, remote[tid], remote[kMaxGroups + tid], remote[2 * kMaxGroups + tid]);
    }
    fin[0][tid] = mean;
    fin[1][tid] = rsqrtf(m2 / n + eps);
  }
  cluster.sync();  // no CTA leaves, or overwrites `part`, while another reads it
  if (!active) return;

  // pass 2: y = x * sc + sh with the thread's 8 scales and shifts; for the
  // SiLU, y / (1 + 2^(x * ec + eh)) with ec, eh = -log2(e) * (sc, sh)
  float sc[8], sh[8], ec[8], eh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int g = min(j < na ? ga : ga + 1, G - 1);
    sc[j] = weight[c0 + j] * fin[1][g];
    sh[j] = bias[c0 + j] - fin[0][g] * sc[j];
    ec[j] = -kLog2e * sc[j];
    eh[j] = -kLog2e * sh[j];
  }
  for (int i = 0; i < nbatch; ++i, p -= step) {
    if (i + 1 < nbatch) load_batch(nxt, p - step);
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      if (p + u * stride >= p_end) break;
      float v[8];
      cur[u].unpack(v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float t = fmaf(v[j], sc[j], sh[j]);
        v[j] = kSilu ? t * rcp_approx(1.f + ex2_approx(fmaf(v[j], ec[j], eh[j]))) : t;
      }
      store8(dst + (long long)(p + u * stride) * C, v);
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u) cur[u] = nxt[u];
  }
}

// ---- channels-last, 16-byte chunks of fixed channels ("chunks") ------------
// For every channels-last call that "rows" does not take: fewer than 8
// channels a group (the CIFAR-10, CelebA-HQ and MNIST UNets' groups of 2, 4
// and 6 channels at C = 64, 128 and 192), C no multiple of 8, more than 4096
// channels or 128 groups.  The one-CTA-a-(sample, group) kernel above reads
// such a group C/G values at a time at a stride of C: at 4 channels a group
// a warp uses a quarter of each 32-byte sector it brings in, and the three
// neighbouring groups' CTAs fetch the same sector again.  Here a sample is a
// flat array of HW * C values with a period of L = lcm(C, 8) values: the P =
// L / 8 chunks of 8 values of a period hold the same channels in every
// period, so a thread that owns chunk ci (of a column block of Pb = min(P,
// 512) chunks; one block unless P > 512) owns a fixed set of channels in
// every period it reads, and a warp reads 32 chunks at neighbouring
// addresses, 16 bytes a thread: every sector a CTA brings in is its own.  A
// CTA of Pb * R threads reads R periods at a time; the CTAs of a sample form
// a thread block cluster.  Two forms (kHeld):
//   - held: the sample fits the cluster's shared memory (the CIFAR-10 and
//     MNIST UNets' samples, 256 KB at 128 x 32 x 32 in bf16): each CTA copies
//     its share of whole periods into shared memory by cp.async.bulk, in
//     pieces, takes the statistics from each piece as it lands, and
//     normalises from shared memory, so x is read once, as the TPU kernel
//     read a sample held in VMEM;
//   - streamed: larger samples (CelebA-HQ's 16 MB), read twice as "rows"
//     reads them: the periods go round the cluster's CTAs in turn with two
//     batches of loads in flight, and the second read runs backwards, so
//     that what the first read last comes out of the L2 cache.  Where H*W*C
//     is no multiple of 8 (C odd, say) a sample's start is not 16-byte
//     aligned and its last period is cut: value by value (kVec = false).
// The statistics: each value's difference from its group's shift (the mean
// of the group's values at the sample's first pixel, which every CTA
// computes alike) is summed, with its square, for each of the 8 values of the
// thread's chunk; the CTA adds up each group's sums in a fixed order, and
// the cluster's CTAs add up the CTAs' sums in rank order through distributed
// shared memory: plain sums around one shift per group, so every CTA holds
// the same statistics and two runs give the same bits, with no atomics.  The
// normalisation uses each thread's 8 scales and shifts, and the SiLU
// ex2.approx / rcp.approx, as "rows" does.
constexpr int kChunkCols = 512;  // chunks of a period a CTA covers at once (Pb), its most threads
constexpr int kChunkMaxGroups = 8192;
constexpr int kChunkPieces = 4;  // bulk copies of a held share
constexpr int kSmemLimit = 232448;  // the dynamic shared memory a block may use

// lcm(C, 8): the values of a period
__host__ __device__ __forceinline__ int chunk_period(int C) {
  const int g = (C & 7) == 0 ? 8 : (C & 3) == 0 ? 4 : (C & 1) == 0 ? 2 : 1;
  return C / g * 8;
}

// A launch's dynamic shared memory: the held share of periods (128-byte
// aligned), the pieces' barriers, each thread's 8 sums and 8 sums of squares,
// and five arrays of G floats (the shifts, the CTA's two sums, the sample's
// mean and rstd).
inline long long chunks_smem(int C, int HW, int G, int esize, bool held, int cluster,
                             int threads) {
  const int L = chunk_period(C);
  const long long nper = ((long long)HW * C + L - 1) / L;
  const long long share =
      held ? ((nper + cluster - 1) / cluster * L * esize + 127) / 128 * 128 : 0;
  return share + kChunkPieces * 8 + 2LL * 8 * threads * 4 + 5LL * G * 4;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float& d, float v) { d = v; }
__device__ __forceinline__ void from_float(__nv_bfloat16& d, float v) { d = __float2bfloat16(v); }

// The 8 channels of chunk ci of a period and their groups, without a
// division per value: ch[j] = (8 ci + j) % C, grp[j] = ch[j] / cpg.
__device__ __forceinline__ void chunk_channels(int ci, int C, int cpg, int (&ch)[8],
                                               int (&grp)[8]) {
  int c = (ci * 8) % C;
  int g = c / cpg, u = c - g * cpg;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ch[j] = c;
    grp[j] = g;
    if (++c == C) {
      c = g = u = 0;
    } else if (++u == cpg) {
      u = 0;
      ++g;
    }
  }
}

template <typename T, bool kSilu, bool kHeld, bool kVec>
__global__ void __launch_bounds__(kChunkCols)
group_norm_chunks_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                         const float* __restrict__ bias, T* __restrict__ y, int C, int HW, int G,
                         float eps, int R) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kBatch = 64 / (8 * sizeof(T));  // chunks of a batch of loads: 64 bytes a thread
  const int rank = blockIdx.x, csize = gridDim.x;  // the cluster spans the grid's x
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int cpg = C / G, L = chunk_period(C), P = L / 8;
  const int Pb = min(P, kChunkCols), nblocks = (P + Pb - 1) / Pb;
  const bool active = tid < Pb * R;
  const int lc = tid % Pb, r = tid / Pb;  // the thread's chunk in the block, its period of R
  const long long total = (long long)HW * C;  // values of a sample
  const int nper = (int)((total + L - 1) / L);
  const T* xs = x + (long long)blockIdx.y * total;
  T* ys = y + (long long)blockIdx.y * total;
  // held: this CTA's periods [q0, q1), copied in npieces pieces of `span`
  // periods, a multiple of R, so that a thread's periods in a piece are its
  // first one plus multiples of R
  int q0 = 0, q1 = nper, span = 1, npieces = 0;
  if constexpr (kHeld) {
    q0 = (int)((long long)rank * nper / csize);
    q1 = (int)((long long)(rank + 1) * nper / csize);
    const int rounds = (q1 - q0 + R - 1) / R;
    span = max(1, (rounds + kChunkPieces - 1) / kChunkPieces) * R;
    npieces = (q1 - q0 + span - 1) / span;
  }
  const long long held_bytes =
      kHeld ? ((long long)((nper + csize - 1) / csize) * L * sizeof(T) + 127) / 128 * 128 : 0;
  T* share = reinterpret_cast<T*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + held_bytes);
  float* ps = reinterpret_cast<float*>(full + kChunkPieces);  // [8][nthreads] sums
  float* pq = ps + 8 * nthreads;                              // and sums of squares
  float* shift = pq + 8 * nthreads;                           // [G] each
  float* gs = shift + G;
  float* gq = gs + G;
  float* fmean = gq + G;
  float* frstd = fmean + G;

  if constexpr (kHeld) {
    if (tid == 0) {
      for (int k = 0; k < npieces; ++k) dmtpu::mbar_init(full + k, 1);
      dmtpu::mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0)
      for (int k = 0; k < npieces; ++k) {
        const int a = q0 + k * span, b = min(q1, a + span);
        const uint32_t bytes = (uint32_t)((long long)(b - a) * L * sizeof(T));
        dmtpu::mbar_arrive_expect_tx(full + k, bytes);
        dmtpu::bulk_load(share + (long long)(a - q0) * L, xs + (long long)a * L, bytes, full + k);
      }
  }
  // each group's shift: the mean of its values at the sample's first pixel
  for (int g = tid; g < G; g += nthreads) {
    float s = 0.f;
    for (int u = 0; u < cpg; ++u) s += to_float(xs[g * cpg + u]);
    shift[g] = s / cpg;
  }
  __syncthreads();

  const int stride = csize * R;  // streamed: between a thread's periods
  const int p_first = rank * R + r;
  const int step = kBatch * stride;
  // pass 1, a column block at a time: the thread's sums, then each group's over the CTA
  for (int kb = 0; kb < nblocks; ++kb) {
    const int ci = kb * Pb + lc;
    const bool mine = active && ci < P;
    float sh[8], s[8], q[8];
    {
      int ch[8], grp[8];
      chunk_channels(mine ? ci : 0, C, cpg, ch, grp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] = q[j] = 0.f;
        sh[j] = shift[grp[j]];
      }
    }
    auto add = [&](const float* v) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[j] - sh[j];
        s[j] += d;
        q[j] = fmaf(d, d, q[j]);
      }
    };
    if constexpr (kHeld) {
      for (int k = 0; k < npieces; ++k) {
        dmtpu::mbar_wait(full + k, 0);  // every thread: no CTA leaves with a copy in flight
        const int b = min(q1, q0 + (k + 1) * span);
        for (int p = q0 + k * span + r; mine && p < b; p += R) {
          Chunk<T> c;
          c.load(share + (long long)(p - q0) * L + ci * 8);
          float v[8];
          c.unpack(v);
          add(v);
        }
      }
    } else if constexpr (kVec) {
      const int p_end = mine ? nper : 0;
      const T* src = xs + ci * 8;
      auto load_batch = [&](Chunk<T>(&batch)[kBatch], int p) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (p + u * stride < p_end) batch[u].load(src + (long long)(p + u * stride) * L);
      };
      Chunk<T> cur[kBatch], nxt[kBatch];
      load_batch(cur, p_first);
      for (int p = p_first; p < p_end; p += step) {
        load_batch(nxt, p + step);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (p + u * stride >= p_end) break;
          float v[8];
          cur[u].unpack(v);
          add(v);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) cur[u] = nxt[u];
      }
    } else {
      for (int p = p_first; mine && p < nper; p += stride) {
        const long long e0 = (long long)p * L + ci * 8;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = e0 + j < total ? to_float(xs[e0 + j]) : sh[j];
        add(v);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ps[j * nthreads + tid] = s[j];
      pq[j * nthreads + tid] = q[j];
    }
    __syncthreads();
    // each place of the block's period (chunk column, value) summed over the
    // R periods, into the slot of the thread of the first; then each group
    // over its places: fixed orders, no atomics
    for (int e = tid; e < 8 * Pb; e += nthreads) {
      const int j = e / Pb, col = e - j * Pb;
      float a = 0.f, b = 0.f;
      for (int rr = 0; rr < R; ++rr) {
        a += ps[j * nthreads + col + Pb * rr];
        b += pq[j * nthreads + col + Pb * rr];
      }
      ps[j * nthreads + col] = a;
      pq[j * nthreads + col] = b;
    }
    __syncthreads();
    const int first = kb * Pb * 8, ppp = L / C;  // the block's first place; pixels a period
    for (int g = tid; g < G; g += nthreads) {
      float a = kb ? gs[g] : 0.f, b = kb ? gq[g] : 0.f;
      for (int pix = 0; pix < ppp; ++pix)
        for (int u = 0; u < cpg; ++u) {
          const int e = pix * C + g * cpg + u - first;
          if (e >= 0 && e < 8 * Pb) {
            a += ps[(e & 7) * nthreads + (e >> 3)];
            b += pq[(e & 7) * nthreads + (e >> 3)];
          }
        }
      gs[g] = a;
      gq[g] = b;
    }
    __syncthreads();
  }

  // the sample's statistics: every CTA adds the cluster's CTAs' sums in rank order
  cluster.sync();
  for (int g = tid; g < G; g += nthreads) {
    float a = 0.f, b = 0.f;
    for (int other = 0; other < csize; ++other) {
      a += cluster.map_shared_rank(gs, other)[g];
      b += cluster.map_shared_rank(gq, other)[g];
    }
    const float n = (float)((long long)HW * cpg);
    const float m = a / n;
    fmean[g] = shift[g] + m;
    frstd[g] = rsqrtf(fmaxf(b / n - m * m, 0.f) + eps);
  }
  cluster.sync();  // no CTA leaves, or lets its sums go, while another reads them
  if (!active) return;

  // pass 2: y = x * sc + sf with the thread's 8 scales and shifts; for the
  // SiLU, y / (1 + 2^(x * ec + eh)) with ec, eh = -log2(e) * (sc, sf)
  for (int kb = nblocks - 1; kb >= 0; --kb) {
    const int ci = kb * Pb + lc;
    if (ci >= P) continue;
    float sc[8], sf[8], ec[8], eh[8];
    {
      int ch[8], grp[8];
      chunk_channels(ci, C, cpg, ch, grp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[j] = weight[ch[j]] * frstd[grp[j]];
        sf[j] = bias[ch[j]] - fmean[grp[j]] * sc[j];
        ec[j] = -kLog2e * sc[j];
        eh[j] = -kLog2e * sf[j];
      }
    }
    auto normalise8 = [&](float* v) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float t = fmaf(v[j], sc[j], sf[j]);
        v[j] = kSilu ? t * rcp_approx(1.f + ex2_approx(fmaf(v[j], ec[j], eh[j]))) : t;
      }
    };
    if constexpr (kHeld) {
      for (int p = q0 + r; p < q1; p += R) {
        Chunk<T> c;
        c.load(share + (long long)(p - q0) * L + ci * 8);
        float v[8];
        c.unpack(v);
        normalise8(v);
        store8(ys + (long long)p * L + ci * 8, v);
      }
    } else if constexpr (kVec) {
      const T* src = xs + ci * 8;
      T* dst = ys + ci * 8;
      auto load_batch = [&](Chunk<T>(&batch)[kBatch], int p) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (p + u * stride < nper) batch[u].load(src + (long long)(p + u * stride) * L);
      };
      const int nbatch = p_first < nper ? (nper - p_first + step - 1) / step : 0;
      int p = p_first + (nbatch - 1) * step;
      Chunk<T> cur[kBatch], nxt[kBatch];
      if (nbatch > 0) load_batch(cur, p);
      for (int i = 0; i < nbatch; ++i, p -= step) {
        if (i + 1 < nbatch) load_batch(nxt, p - step);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (p + u * stride >= nper) break;
          float v[8];
          cur[u].unpack(v);
          normalise8(v);
          store8(dst + (long long)(p + u * stride) * L, v);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) cur[u] = nxt[u];
      }
    } else {
      if (p_first >= nper) continue;
      for (int p = p_first + (nper - 1 - p_first) / stride * stride; p >= p_first; p -= stride) {
        const long long e0 = (long long)p * L + ci * 8;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = e0 + j < total ? to_float(xs[e0 + j]) : 0.f;
        normalise8(v);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (e0 + j < total) from_float(ys[e0 + j], v[j]);
      }
    }
  }
}

// ---- contiguous NCHW, a slab spread over a team of CTAs ("team") ----------
// The (sample, group) slab is (C/G) * HW contiguous values: from 64 bytes
// (the CIFAR UNet's 4x4 maps) to 32 MB (SDXL's 1024x1024 decode in f32).  A
// "worker" takes one slab at a time and walks its slabs in order (slab w, w
// + workers, ...), in one of three forms, by the slab's size:
//   - "warp": a warp a slab, eight at once in a CTA, for slabs of at most 32
//     lanes' batches (4 KB);
//   - "cta": a CTA a slab, of at most 256 threads' batches (32 KB);
//   - "stream": a team of `team` CTAs a slab, each CTA on one contiguous
//     share of it, larger slabs (the VAE decodes, the pixel UNets' large maps).
// In the first two a thread holds its batch (kDepth vectors, 128 bytes: 32
// registers) from the statistics to the normalisation, so x is read once.  In
// "stream" one producer warp copies each share of x into a ring of kSlots
// shared-memory slots of 64 KB by cp.async.bulk, running up to kSlots slabs
// ahead, and copies y out of them once the CTA has written it there, so that
// the next slabs' bytes arrive while the team merges this slab's statistics;
// a share of one slot is normalised in shared memory (x read once), a larger
// one streams its pieces again for the normalisation, while few slabs are in
// flight, so that the second read comes out of the L2 cache.  The statistics: a thread's (count, mean, M2) from sums of x -
// shift and (x - shift)^2 with the shift at its first vector's mean, merged
// with Chan's formula across the warp (a fixed butterfly), the CTA's warps
// (in order) and the team's CTAs: a CTA publishes its state in global memory
// (slot j % 2 of the worker's j-th slab) and then a flag (epoch + j + 1, a
// release store); every CTA of the team watches the team's flags (each
// thread a few, the loads in flight together, then one fence) and merges all
// the states in a fixed order, so every CTA of a team holds the same
// statistics, bit for bit, and two runs give the same bits: no atomics.  The
// waits need every CTA of the grid resident at once: a team of more than one
// CTA launches cooperatively, one CTA an SM.  The epoch, a count of launches
// kept by the caller, makes the flags of earlier launches read as not yet set.
constexpr int kTeamThreads = 256;  // the threads that normalise ("stream": + a producer warp)
constexpr int kTeamWarps = kTeamThreads / 32;
constexpr int kRegBlocks = 3;      // "warp" and "cta" CTAs an SM holds at once
constexpr int kSlots = 3;          // "stream": shared-memory slots of a share of x
constexpr int kSlotBytes = 64 * 1024;
constexpr int kStreamSmem = kSlots * kSlotBytes + 2 * kSlots * 8;
constexpr int kMaxTeamCtas = 4096;  // flags, then two slots of states, in the scratch

template <typename T>
struct TeamDepth {  // 8-value vectors a thread holds: 128 bytes, 32 registers
  static constexpr int value = 128 / (8 * sizeof(T));
};

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}
// Named barrier 1 over the 256 threads that normalise; with `pred`: true
// when it is true in every one of them.
__device__ __forceinline__ void team_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ bool team_sync_and(bool pred) {
  uint32_t all;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\nbar.red.and.pred q, 1, 256, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(all)
      : "r"((uint32_t)pred)
      : "memory");
  return all != 0;
}

__device__ __forceinline__ void warp_merge(float& n, float& mean, float& m2) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, off);
    const float mb = __shfl_xor_sync(0xffffffffu, mean, off);
    const float m2b = __shfl_xor_sync(0xffffffffu, m2, off);
    merge(n, mean, m2, nb, mb, m2b);
  }
}

// The thread's shifted sums of 8 values into (shift, sum, sq); the first
// vector of the slab sets the shift.
__device__ __forceinline__ void accumulate(const float* v, bool first, float& shift, float& sum,
                                           float& sq) {
  if (first) shift = (v[0] + v[1] + v[2] + v[3] + v[4] + v[5] + v[6] + v[7]) * 0.125f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float d = v[e] - shift;
    sum += d;
    sq = fmaf(d, d, sq);
  }
}

// y of one vector of channel c's values
__device__ __forceinline__ void normalise(float* v, float sc, float sh, bool silu) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float yv = fmaf(v[e], sc, sh);
    v[e] = silu ? yv * rcp_approx(1.f + ex2_approx(-kLog2e * yv)) : yv;
  }
}

// The CTA's statistics from its threads' shifted sums over `count` values
// (threads 0..255; named barrier 1), merged with the team's when team > 1:
// (mean, rstd) in s_stats.
__device__ __forceinline__ void cta_statistics(float count, float shift, float sum, float sq,
                                               int team, int rank, int j, float eps,
                                               unsigned long long* flags, float4* parts,
                                               unsigned long long epoch, float* s_n,
                                               float* s_mean, float* s_m2, float* s_stats) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float n = count, mean = 0.f, m2 = 0.f;
  if (count > 0.f) {
    mean = shift + sum / count;
    m2 = fmaxf(sq - sum * sum / count, 0.f);
  }
  warp_merge(n, mean, m2);
  if (lane == 0) {
    s_n[warp] = n;
    s_mean[warp] = mean;
    s_m2[warp] = m2;
  }
  team_sync();
  float tn = 0.f, tmean = 0.f, tm2 = 0.f;
  if (tid == 0)
    for (int w = 0; w < kTeamWarps; ++w) merge(tn, tmean, tm2, s_n[w], s_mean[w], s_m2[w]);
  if (team > 1) {
    // publish this CTA's state; each thread watches the flags of the ranks
    // it merges; then the team's states in a fixed tree: a thread's ranks in
    // order, the warp's butterfly, the warps in order
    const int slot = (j & 1) * kMaxTeamCtas;
    const int first = blockIdx.x - rank;
    const unsigned long long want = epoch + (unsigned long long)j + 1;
    if (tid == 0) {
      parts[slot + blockIdx.x] = make_float4(tn, tmean, tm2, 0.f);
      st_release(flags + blockIdx.x, want);
    }
    bool ready;
    do {
      ready = true;
      for (int r = tid; r < team; r += kTeamThreads) ready &= ld_relaxed(flags + first + r) >= want;
    } while (!team_sync_and(ready));
    __threadfence();
    tn = tmean = tm2 = 0.f;
    for (int r = tid; r < team; r += kTeamThreads) {
      const float4 p = parts[slot + first + r];
      merge(tn, tmean, tm2, p.x, p.y, p.z);
    }
    warp_merge(tn, tmean, tm2);
    if (lane == 0) {
      s_n[warp] = tn;
      s_mean[warp] = tmean;
      s_m2[warp] = tm2;
    }
    team_sync();
    tn = tmean = tm2 = 0.f;
    if (tid == 0)
      for (int w = 0; w < kTeamWarps; ++w) merge(tn, tmean, tm2, s_n[w], s_mean[w], s_m2[w]);
  }
  if (tid == 0) {
    s_stats[0] = tmean;
    s_stats[1] = rsqrtf(tm2 / tn + eps);
  }
  team_sync();
}

// "warp" (kWarp) and "cta": a slab in the registers of a warp, or of a CTA.
template <typename T, bool kSilu, bool kWarp>
__global__ void __launch_bounds__(kTeamThreads, kRegBlocks)
group_norm_held_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                       const float* __restrict__ bias, T* __restrict__ y, int C, int HW, int G,
                       int slabs, float eps) {
  constexpr int kDepth = TeamDepth<T>::value;
  constexpr int nthr = kWarp ? 32 : kTeamThreads;  // threads of a worker
  __shared__ float s_n[kTeamWarps], s_mean[kTeamWarps], s_m2[kTeamWarps], s_stats[2];
  const int warp = threadIdx.x / 32;
  const int t = kWarp ? threadIdx.x % 32 : threadIdx.x;
  const int worker = kWarp ? blockIdx.x * kTeamWarps + warp : blockIdx.x;
  const int workers = kWarp ? gridDim.x * kTeamWarps : gridDim.x;
  const int cg = C / G;
  const int nvec = cg * HW / 8;  // 8-value vectors of a slab (HW % 8 == 0: each in one channel)
  const int mine = nvec > t ? (nvec - t + nthr - 1) / nthr : 0;  // at most kDepth

  for (int s = worker; s < slabs; s += workers) {
    const long long base = (long long)s * nvec * 8;
    Chunk<T> buf[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u)
      if (u < mine) buf[u].load(x + base + (long long)(t + u * nthr) * 8);
    float shift = 0.f, sum = 0.f, sq = 0.f;
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      if (u >= mine) break;
      float v[8];
      buf[u].unpack(v);
      accumulate(v, u == 0, shift, sum, sq);
    }
    float gmean, rstd;
    if constexpr (kWarp) {
      float n = (float)(mine * 8), mean = 0.f, m2 = 0.f;
      if (mine > 0) {
        mean = shift + sum / n;
        m2 = fmaxf(sq - sum * sum / n, 0.f);
      }
      warp_merge(n, mean, m2);
      gmean = __shfl_sync(0xffffffffu, mean, 0);
      rstd = rsqrtf(__shfl_sync(0xffffffffu, m2, 0) / __shfl_sync(0xffffffffu, n, 0) + eps);
    } else {
      cta_statistics((float)(mine * 8), shift, sum, sq, 1, 0, 0, eps, nullptr, nullptr, 0, s_n,
                     s_mean, s_m2, s_stats);
      gmean = s_stats[0];
      rstd = s_stats[1];
    }
    const int c_first = (s % G) * cg;
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      if (u >= mine) break;
      const int vec = t + u * nthr;
      const int c = c_first + vec * 8 / HW;
      const float sc = weight[c] * rstd;
      float v[8];
      buf[u].unpack(v);
      normalise(v, sc, bias[c] - gmean * sc, kSilu);
      store8(y + base + (long long)vec * 8, v);
    }
  }
}

// "stream": teams of CTAs, a ring of shares of x in shared memory.  The
// producer warp's one thread runs every copy: a share (or a piece of one)
// into its slot, and, once the CTA has normalised it there in place, back out
// to y; so the threads that normalise touch no device memory but their
// CTA's published state, and the memory system has the next slots' loads and
// the last slots' stores in flight while the team merges its statistics.
template <typename T, bool kSilu>
__global__ void __launch_bounds__(kTeamThreads + 32, 1)
group_norm_stream_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                         const float* __restrict__ bias, T* __restrict__ y, int C, int HW, int G,
                         int slabs, int team, float eps, unsigned long long* __restrict__ flags,
                         float4* __restrict__ parts, unsigned long long epoch) {
  constexpr int kVecBytes = 8 * sizeof(T);
  constexpr int kSlotVecs = kSlotBytes / kVecBytes;
  extern __shared__ __align__(128) unsigned char ring[];  // [kSlots][kSlotBytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kSlots * kSlotBytes);
  uint64_t* done = full + kSlots;  // the CTA is done with the slot (and has written y there)
  __shared__ float s_n[kTeamWarps], s_mean[kTeamWarps], s_m2[kTeamWarps], s_stats[2];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int worker = blockIdx.x / team, workers = gridDim.x / team, rank = blockIdx.x % team;
  const int cg = C / G;
  const int nvec = cg * HW / 8;
  const int v0 = (int)((long long)rank * nvec / team);
  const int v1 = (int)((long long)(rank + 1) * nvec / team);
  const int pieces = (v1 - v0 + kSlotVecs - 1) / kSlotVecs;
  const bool resident = pieces == 1;  // the share is normalised in its slot
  const int loads = resident ? 1 : 2 * pieces;  // copies a slab: pass 1's, then pass 2's

  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) {
      dmtpu::mbar_init(full + i, 1);
      dmtpu::mbar_init(done + i, kTeamWarps);  // one arrival per normalising warp
    }
    dmtpu::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kTeamWarps) {
    // ---- producer warp: one thread runs the copies in the order they are used ----
    if (lane != 0 || pieces == 0) return;
    // the last kSlots uses: where y goes (nullptr for a pass-1 piece) and its bytes
    T* out[kSlots] = {};
    int out_bytes[kSlots] = {};
    int k = 0;
    auto retire = [&](int use) {  // wait for the CTA to be done with the use's slot, store y
      const int slot = use % kSlots;
      dmtpu::mbar_wait(done + slot, (use / kSlots) & 1);
      if (out[slot]) {
        dmtpu::bulk_store(out[slot], ring + slot * kSlotBytes, out_bytes[slot]);
        dmtpu::bulk_commit();
        dmtpu::bulk_wait_read();  // the slot may be written again
      }
    };
    for (int s = worker; s < slabs; s += workers) {
      const long long base = (long long)s * nvec * 8;
      for (int q = 0; q < loads; ++q, ++k) {
        const int slot = k % kSlots;
        if (k >= kSlots) retire(k - kSlots);
        const int p0 = v0 + (q % pieces) * kSlotVecs;
        const int bytes = (min(v1, p0 + kSlotVecs) - p0) * kVecBytes;
        dmtpu::mbar_arrive_expect_tx(full + slot, bytes);
        dmtpu::bulk_load(ring + slot * kSlotBytes, x + base + (long long)p0 * 8, bytes,
                         full + slot);
        out[slot] = resident || q >= pieces ? y + base + (long long)p0 * 8 : nullptr;
        out_bytes[slot] = bytes;
      }
    }
    for (int use = k > kSlots ? k - kSlots : 0; use < k; ++use) retire(use);
    dmtpu::bulk_wait();  // y is written before the CTA ends
    return;
  }

  int k = 0;  // the copies used so far, in the producer's order
  for (int s = worker, j = 0; s < slabs; s += workers, ++j) {
    // pass 1: the thread's shifted sums over the pieces of the share
    float shift = 0.f, sum = 0.f, sq = 0.f;
    int count = 0, held = 0;
    for (int p = 0; p < pieces; ++p, ++k) {
      const int slot = k % kSlots;
      dmtpu::mbar_wait(full + slot, (k / kSlots) & 1);
      const T* piece = reinterpret_cast<const T*>(ring + slot * kSlotBytes);
      const int nv = min(v1 - v0 - p * kSlotVecs, kSlotVecs);
#pragma unroll 4
      for (int i = tid; i < nv; i += kTeamThreads) {
        Chunk<T> c;
        c.load(piece + i * 8);
        float v[8];
        c.unpack(v);
        accumulate(v, count == 0, shift, sum, sq);
        count += 8;
      }
      if (resident) {
        held = slot;
      } else {
        __syncwarp();
        if (lane == 0) dmtpu::mbar_arrive(done + slot);
      }
    }
    cta_statistics((float)count, shift, sum, sq, team, rank, j, eps, flags, parts, epoch, s_n,
                   s_mean, s_m2, s_stats);
    const float gmean = s_stats[0], rstd = s_stats[1];
    // pass 2: y in place of x, in the share's slot or in its pieces copied anew
    const int c_first = (s % G) * cg;
    for (int p = 0; p < pieces; ++p) {
      int slot = held;
      if (!resident) {
        slot = k % kSlots;
        dmtpu::mbar_wait(full + slot, (k / kSlots) & 1);
        ++k;
      }
      T* piece = reinterpret_cast<T*>(ring + slot * kSlotBytes);
      const int pv0 = v0 + p * kSlotVecs;
      const int nv = min(v1 - pv0, kSlotVecs);
#pragma unroll 4
      for (int i = tid; i < nv; i += kTeamThreads) {
        const int c = c_first + (pv0 + i) * 8 / HW;
        const float sc = weight[c] * rstd;
        Chunk<T> ch;
        ch.load(piece + i * 8);
        float v[8];
        ch.unpack(v);
        normalise(v, sc, bias[c] - gmean * sc, kSilu);
        store8(piece + i * 8, v);
      }
      dmtpu::fence_proxy_async();  // the bulk store reads these writes
      __syncwarp();
      if (lane == 0) dmtpu::mbar_arrive(done + slot);
    }
  }
}

template <typename T, bool kSilu>
cudaError_t launch_team_instance(const T* x, const float* w, const float* b, T* y, int C, int HW,
                                 int G, int slabs, int form, int team, int ctas, float eps,
                                 unsigned long long* flags, float4* parts,
                                 unsigned long long epoch, cudaStream_t stream) {
  if (form == 0)
    group_norm_held_kernel<T, kSilu, true><<<ctas, kTeamThreads, 0, stream>>>(x, w, b, y, C, HW,
                                                                             G, slabs, eps);
  else if (form == 1)
    group_norm_held_kernel<T, kSilu, false><<<ctas, kTeamThreads, 0, stream>>>(x, w, b, y, C, HW,
                                                                              G, slabs, eps);
  if (form < 2) return cudaGetLastError();
  static bool allowed[dmtpu::kMaxDevices] = {};
  const cudaError_t attr =
      dmtpu::allow_dynamic_smem(group_norm_stream_kernel<T, kSilu>, kStreamSmem, allowed);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(kTeamThreads + 32);
  config.dynamicSmemBytes = kStreamSmem;
  config.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  config.attrs = attrs;
  config.numAttrs = team > 1 ? 1 : 0;  // the flag waits need every CTA resident
  return cudaLaunchKernelEx(&config, group_norm_stream_kernel<T, kSilu>, x, w, b, y, C, HW, G,
                            slabs, team, eps, flags, parts, epoch);
}

template <typename T, bool kNhwc>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int N, int C, int HW,
                   int G, float eps, bool silu, cudaStream_t stream) {
  const dim3 grid(N * G);
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  const float* bt = static_cast<const float*>(b);
  T* yt = static_cast<T*>(y);
  if (silu)
    group_norm_kernel<T, true, kNhwc><<<grid, kThreads, 0, stream>>>(xt, wt, bt, yt, C, HW, G,
                                                                     eps);
  else
    group_norm_kernel<T, false, kNhwc><<<grid, kThreads, 0, stream>>>(xt, wt, bt, yt, C, HW,
                                                                      G, eps);
  return cudaGetLastError();
}

template <typename T, bool kSilu>
cudaError_t launch_rows_instance(const T* x, const float* w, const float* b, T* y, int N, int C,
                                 int HW, int G, float eps, int cluster, int rows, int threads,
                                 cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster, N);
  config.blockDim = dim3(threads);
  config.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  config.attrs = attrs;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, group_norm_rows_kernel<T, kSilu>, x, w, b, y, C, HW, G, eps,
                            rows);
}

template <typename T>
cudaError_t launch_rows(const void* x, const void* w, const void* b, void* y, int N, int C, int HW,
                        int G, float eps, bool silu, int cluster, int rows, int threads,
                        cudaStream_t stream) {
  if (C % 8 || C / G < 8 || G > kMaxGroups || threads > kMaxRowThreads || threads % 32 ||
      rows < 1 || rows * (C / 8) > threads || cluster < 1 || cluster > 8)
    return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  const float* bt = static_cast<const float*>(b);
  T* yt = static_cast<T*>(y);
  if (silu)
    return launch_rows_instance<T, true>(xt, wt, bt, yt, N, C, HW, G, eps, cluster, rows, threads,
                                         stream);
  return launch_rows_instance<T, false>(xt, wt, bt, yt, N, C, HW, G, eps, cluster, rows, threads,
                                        stream);
}

template <typename T, bool kSilu, bool kHeld, bool kVec>
cudaError_t launch_chunks_instance(const T* x, const float* w, const float* b, T* y, int N, int C,
                                   int HW, int G, float eps, int cluster, int periods,
                                   int threads, int smem, cudaStream_t stream) {
  static bool allowed[dmtpu::kMaxDevices] = {};
  const cudaError_t attr = dmtpu::allow_dynamic_smem(
      group_norm_chunks_kernel<T, kSilu, kHeld, kVec>, kSmemLimit, allowed);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster, N);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  config.attrs = attrs;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, group_norm_chunks_kernel<T, kSilu, kHeld, kVec>, x, w, b, y,
                            C, HW, G, eps, periods);
}

template <typename T, bool kSilu>
cudaError_t launch_chunks_form(const void* x, const void* w, const void* b, void* y, int N, int C,
                               int HW, int G, float eps, bool held, bool vec, int cluster,
                               int periods, int threads, int smem, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  const float* bt = static_cast<const float*>(b);
  T* yt = static_cast<T*>(y);
  if (held)
    return launch_chunks_instance<T, kSilu, true, true>(xt, wt, bt, yt, N, C, HW, G, eps, cluster,
                                                        periods, threads, smem, stream);
  if (vec)
    return launch_chunks_instance<T, kSilu, false, true>(xt, wt, bt, yt, N, C, HW, G, eps,
                                                         cluster, periods, threads, smem, stream);
  return launch_chunks_instance<T, kSilu, false, false>(xt, wt, bt, yt, N, C, HW, G, eps, cluster,
                                                        periods, threads, smem, stream);
}

}  // namespace

// x, y: f32 (is_bf16 = 0) or bf16 (is_bf16 = 1), 16-byte aligned; y has x's
// layout.  weight, bias: f32 [C].  Needs C % G == 0.  kernel:
//   0  contiguous NCHW, one CTA per (sample, group); needs HW % 8 == 0;
//   1  channels-last, one CTA per (sample, group); needs (C / G) % 2 == 0;
//   2  channels-last, a cluster of `cluster` CTAs (at most 8) per sample,
//      `rows` pixel rows a pass in a CTA of `threads` threads (a multiple of
//      32, at least rows * C / 8, at most 512); needs C % 8 == 0, C / G >= 8,
//      G <= 128.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int dmtpu_group_norm_silu(const void* x, const void* weight, const void* bias,
                                     void* y, int N, int C, int HW, int G, float eps,
                                     int silu, int is_bf16, int kernel, int cluster, int rows,
                                     int threads, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool s = silu != 0;
  if (kernel == 2) {
    if (is_bf16)
      return (int)launch_rows<__nv_bfloat16>(x, weight, bias, y, N, C, HW, G, eps, s, cluster,
                                             rows, threads, st);
    return (int)launch_rows<float>(x, weight, bias, y, N, C, HW, G, eps, s, cluster, rows,
                                   threads, st);
  }
  const bool channels_last = kernel == 1;
  if (is_bf16 && channels_last)
    return (int)launch<__nv_bfloat16, true>(x, weight, bias, y, N, C, HW, G, eps, s, st);
  if (is_bf16)
    return (int)launch<__nv_bfloat16, false>(x, weight, bias, y, N, C, HW, G, eps, s, st);
  if (channels_last)
    return (int)launch<float, true>(x, weight, bias, y, N, C, HW, G, eps, s, st);
  return (int)launch<float, false>(x, weight, bias, y, N, C, HW, G, eps, s, st);
}

// The "team" kernels over contiguous NCHW (see the comment above
// group_norm_held_kernel): x, y f32 (is_bf16 = 0) or bf16, 16-byte aligned;
// weight, bias f32 [C]; needs C % G == 0, HW % 8 == 0 and (C / G) * HW <
// 2^31.  form 0 ("warp"): a warp a slab of at most 32 * kDepth 8-value
// vectors (kDepth = 4 in f32, 8 in bf16), `ctas` CTAs; form 1 ("cta"): a CTA
// a slab of at most 256 * kDepth vectors; form 2 ("stream"): `ctas` CTAs (a
// multiple of team, at most one an SM when team > 1, at most 4096) in teams
// of `team`.  scratch ("stream" with team > 1): 4096 u64 flags (zeroed once,
// never reset) then 2 x 4096 float4 states, 160 KiB; epoch: above every flag
// an earlier launch on this scratch wrote (the caller's launch count times
// 2^32).  Returns the CUDA error code of the launch (0 on success).
extern "C" int dmtpu_group_norm_team(const void* x, const void* weight, const void* bias, void* y,
                                     int N, int C, int HW, int G, float eps, int silu,
                                     int is_bf16, int form, int team, int ctas, void* scratch,
                                     long long epoch, void* stream) {
  const long long slab = C % G ? 0 : (long long)(C / G) * HW;
  const int depth = is_bf16 ? TeamDepth<__nv_bfloat16>::value : TeamDepth<float>::value;
  const long long held = (form == 0 ? 32 : kTeamThreads) * depth * 8;  // values a form holds
  if (!slab || HW % 8 || slab >= (1ll << 31) || ctas < 1 || ctas > kMaxTeamCtas || form < 0 ||
      form > 2 || (form < 2 && slab > held) ||
      (form == 2 && (team < 1 || ctas % team || (team > 1 && !scratch))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* flags = static_cast<unsigned long long*>(scratch);
  float4* parts = reinterpret_cast<float4*>(flags + kMaxTeamCtas);
  const unsigned long long ep = (unsigned long long)epoch;
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  const int slabs = N * G;
  if (is_bf16) {
    const auto* xt = static_cast<const __nv_bfloat16*>(x);
    auto* yt = static_cast<__nv_bfloat16*>(y);
    return silu ? (int)launch_team_instance<__nv_bfloat16, true>(
                      xt, w, b, yt, C, HW, G, slabs, form, team, ctas, eps, flags, parts, ep, st)
                : (int)launch_team_instance<__nv_bfloat16, false>(
                      xt, w, b, yt, C, HW, G, slabs, form, team, ctas, eps, flags, parts, ep, st);
  }
  const auto* xt = static_cast<const float*>(x);
  auto* yt = static_cast<float*>(y);
  return silu ? (int)launch_team_instance<float, true>(xt, w, b, yt, C, HW, G, slabs, form, team,
                                                       ctas, eps, flags, parts, ep, st)
              : (int)launch_team_instance<float, false>(xt, w, b, yt, C, HW, G, slabs, form,
                                                        team, ctas, eps, flags, parts, ep, st);
}

// The "chunks" kernel over channels-last (see the comment above
// group_norm_chunks_kernel): x, y f32 (is_bf16 = 0) or bf16, 16-byte
// aligned; weight, bias f32 [C]; needs C % G == 0, G <= 8192, N <= 65535.
// held = 1: each CTA of a cluster of `cluster` (at most 8) holds its share of
// the sample in shared memory (needs H*W*C % 8 == 0); held = 0: the sample
// is streamed, twice.  A CTA of `threads` threads (a multiple of 32, at most
// 512, at least min(P, 512) * periods with P = lcm(C, 8) / 8) reads `periods`
// periods at a time.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int dmtpu_group_norm_chunks(const void* x, const void* weight, const void* bias,
                                       void* y, int N, int C, int HW, int G, float eps, int silu,
                                       int is_bf16, int held, int cluster, int periods,
                                       int threads, void* stream) {
  if (N < 1 || N > 65535 || C < 1 || HW < 1 || G < 1 || C % G || G > kChunkMaxGroups ||
      cluster < 1 || cluster > 8 || periods < 1)
    return (int)cudaErrorInvalidValue;
  const int pb = chunk_period(C) / 8 < kChunkCols ? chunk_period(C) / 8 : kChunkCols;
  const bool vec = (long long)HW * C % 8 == 0;
  const long long smem = chunks_smem(C, HW, G, is_bf16 ? 2 : 4, held != 0, cluster, threads);
  if (threads % 32 || threads > kChunkCols || (long long)pb * periods > threads ||
      (held && !vec) || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool h = held != 0;
  if (is_bf16)
    return silu ? (int)launch_chunks_form<__nv_bfloat16, true>(x, weight, bias, y, N, C, HW, G,
                                                               eps, h, vec, cluster, periods,
                                                               threads, (int)smem, st)
                : (int)launch_chunks_form<__nv_bfloat16, false>(x, weight, bias, y, N, C, HW, G,
                                                                eps, h, vec, cluster, periods,
                                                                threads, (int)smem, st);
  return silu ? (int)launch_chunks_form<float, true>(x, weight, bias, y, N, C, HW, G, eps, h, vec,
                                                     cluster, periods, threads, (int)smem, st)
              : (int)launch_chunks_form<float, false>(x, weight, bias, y, N, C, HW, G, eps, h, vec,
                                                      cluster, periods, threads, (int)smem, st);
}

// The dynamic shared memory, in bytes, that dmtpu_group_norm_chunks asks for
// a launch of these arguments (more than 232448: a launch it refuses).
extern "C" int dmtpu_group_norm_chunks_smem(int C, int HW, int G, int is_bf16, int held,
                                            int cluster, int threads) {
  if (C < 1 || HW < 1 || G < 1 || cluster < 1 || threads < 1) return -1;
  const long long smem = chunks_smem(C, HW, G, is_bf16 ? 2 : 4, held != 0, cluster, threads);
  return smem > kSmemLimit ? kSmemLimit + 1 : (int)smem;
}
