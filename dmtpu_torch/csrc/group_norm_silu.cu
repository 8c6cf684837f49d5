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
// a sample is up to 7.9 MB, far beyond one SM's shared memory, so every
// kernel below makes two passes over x, statistics first, and the second
// pass's reads come partly out of the 50 MB L2 cache.  Three kernels, chosen
// by dmtpu_torch/ops/groupnorm.py::plan:
//   - "rows", for channels-last (N, H, W, C in memory; cuDNN returns the
//     UNet's bf16 convolutions so): a group is only C/G contiguous values at
//     each pixel (20 bytes at a 640-byte stride for C=320), so a CTA takes
//     whole pixel rows instead, 16 bytes a thread along C, and the CTAs of a
//     sample form a thread block cluster that merges the per-group
//     statistics through distributed shared memory, in a fixed order and
//     without atomics.  See the comment at group_norm_rows_kernel;
//   - one CTA per (sample, group) over contiguous NCHW (the group is one
//     slab, read 16 bytes at a time);
//   - one CTA per (sample, group) over channels-last, two values at a time:
//     for the shapes "rows" does not take (C no multiple of 8, fewer than 8
//     channels a group).
// The statistics are (count, mean, M2) states merged with Chan's formula
// across threads, warps and CTAs; a thread's own state comes from exact
// two-pass moments of 8-value chunks (the per-group kernels) or from sums of
// x - shift and (x - shift)^2 with the shift at its first pixel's group mean
// (the rows kernel).  The TPU kernel's E[x^2] - E[x]^2, which cancels badly
// in f32, is not copied.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
