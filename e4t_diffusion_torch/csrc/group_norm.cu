// GroupNorm (+ optional SiLU) for Hopper (sm_90a), x in bf16 or f32, NCHW or
// channels-last (NHWC in memory), statistics in f32, output in x's dtype and
// layout.
//
// Replaces the TPU kernel _fused_group_norm_impl of
// e4t_diffusion_tpu/ops/groupnorm.py. Same function: per (sample, group) the
// f32 sum and sum of squares, the fast variance E[x^2] - E[x]^2 (not
// Welford), inv = 1 / sqrt(var + eps), the affine folded per channel to
// y = x * a + b with a = inv * weight and b = bias - mean * a, then
// y * sigmoid(y) when asked. The TPU kernel reduces the channels of one NHWC
// sample to its groups with a one-hot (C, G) matrix on the MXU; here the
// sums are plain f32 reductions, in a fixed order.
//
// What bounds it on the H100: memory. The function reads x once and writes
// y once (2 * numel * itemsize bytes over 3.35 TB/s) and does ~10 flops an
// element.
//
// Layouts. The port's UNet and VAE hand both layouts to their GroupNorm
// sites: the spatial transformers' output is a channels-last view and a
// conv of a channels-last input stays channels-last, so from batch 2 on most
// sites after the first transformer see NHWC memory, and so do the VAE
// decoder's from its mid-block attention on.
//
// NCHW: group_norm_sync_kernel, one block of 512 threads per (n, g). The
// group is one contiguous span of (C/G) * H * W elements, read in 16-byte
// vectors when H * W is a multiple of the vector width (no vector straddles
// two channels). Pass 1 loads the group, keeps a copy in shared memory and
// sums; pass 2 normalises from that copy and writes, so x is read from
// device memory once where the group fits in shared memory (every SD-v1 UNet
// group at 512px but one); larger groups are read again in pass 2.
//
// Channels-last: group_norm_nhwc_kernel (the notes above it). The first
// design ran group_norm_sync_kernel here too: in NHWC a group is H * W runs
// of C/G channels, C apart, so at the VAE's C/G = 4 each block read 8 bytes
// of every 256 and x came from device memory several times over (16x the
// bound at 128 channels, 512x512). From 12 MB of x the whole pixel is now
// read at once, by resident blocks of one cooperative launch that meet at
// two grid barriers; below it, where the launch and its barriers cost more
// than the strided reads (~8 µs, measured), group_norm_sync_kernel still
// takes channels-last x.
//
// The first design on both layouts stays as the yardstick
// (e4t_group_norm_sync).

#include <cooperative_groups.h>
#include <math.h>

#include <algorithm>

#include "flash_common.cuh"

namespace {

using e4t::bf16;

constexpr int kBlock = 512;
constexpr int kBlockWarps = kBlock / 32;
// dynamic shared memory a block may take for its group (227 KB less room
// for the static reduction scratch)
constexpr size_t kMaxCacheBytes = 232448 - 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

// W consecutive elements, loaded and stored as one access
template <typename T, int W>
struct alignas(sizeof(T) * W) Pack {
  T e[W];
};

// weight or bias element i, stored in bf16 (the modules' compute dtype) or
// f32
__device__ __forceinline__ float param(const void* p, int i, bool is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kNHWC: the layout; W: elements per access; cache: keep the group in
// dynamic shared memory between the passes. Access i of the group covers
// elements [i * W, i * W + W) in the order NCHW stores them (channel-major)
// or NHWC stores them (pixel-major).
template <typename T, int W, bool kNHWC>
__global__ void __launch_bounds__(kBlock)
group_norm_sync_kernel(const T* __restrict__ x, const void* __restrict__ weight,
                  const void* __restrict__ bias, T* __restrict__ y, int groups,
                  int cpg, int hw, float eps, bool params_bf16, bool cache,
                  bool silu) {
  using V = Pack<T, W>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* cache_s = reinterpret_cast<V*>(smem_raw);
  __shared__ float red[2][kBlockWarps];
  __shared__ float stats[2];

  const int n = blockIdx.x / groups, g = blockIdx.x % groups;
  const int channels = groups * cpg;
  const int count = cpg * hw / W;        // accesses in the group
  const int per_pixel = cpg / W;         // NHWC: accesses per pixel
  const size_t base = kNHWC ? (size_t)n * hw * channels + (size_t)g * cpg
                            : (size_t)blockIdx.x * cpg * hw;
  const int c0 = g * cpg;
  const int tid = threadIdx.x;

  // offset of access i from base, and the group channel of its element 0
  auto locate = [&](int i, size_t& off, int& ch) {
    if constexpr (kNHWC) {
      const int p = i / per_pixel, q = i - p * per_pixel;
      off = (size_t)p * channels + q * W;
      ch = q * W;
    } else {
      off = (size_t)i * W;
      ch = i * W / hw;
    }
  };

  // pass 1: f32 sum and sum of squares (and the shared-memory copy)
  float s = 0.f, ss = 0.f;
  for (int i = tid; i < count; i += kBlock) {
    size_t off;
    int ch;
    locate(i, off, ch);
    const V v = *reinterpret_cast<const V*>(x + base + off);
    if (cache) cache_s[i] = v;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float f = to_f32(v.e[e]);
      s += f;
      ss += f * f;
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = ss;
  }
  __syncthreads();
  if (warp == 0) {
    s = warp_sum(lane < kBlockWarps ? red[0][lane] : 0.f);
    ss = warp_sum(lane < kBlockWarps ? red[1][lane] : 0.f);
    if (lane == 0) {
      const float n_elems = (float)cpg * (float)hw;
      const float mean = s / n_elems;
      const float var = ss / n_elems - mean * mean;  // the fast variance
      stats[0] = mean;
      stats[1] = 1.f / sqrtf(var + eps);
    }
  }
  __syncthreads();  // also orders the shared-memory copy before pass 2
  const float mean = stats[0], inv = stats[1];

  // pass 2: y = x * a + b per channel (+ SiLU), in x's dtype and layout
  for (int i = tid; i < count; i += kBlock) {
    size_t off;
    int ch;
    locate(i, off, ch);
    const V v = cache ? cache_s[i] : *reinterpret_cast<const V*>(x + base + off);
    V o;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const int c = kNHWC ? ch + e : ch;  // NCHW: one channel an access
      const float a = inv * param(weight, c0 + c, params_bf16);
      const float b = param(bias, c0 + c, params_bf16) - mean * a;
      float t = to_f32(v.e[e]) * a + b;
      if (silu) t = t / (1.f + expf(-t));
      o.e[e] = from_f32<T>(t);
    }
    *reinterpret_cast<V*>(y + base + off) = o;
  }
}

// elements per access: the widest vector (up to 16 bytes) that `run`
// elements divide and that x and y are aligned to
template <typename T>
int vector_width(long long run, const void* x, const void* y) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  int vw = 16 / (int)sizeof(T);
  while (vw > 1 && (run % vw != 0 || addr % (vw * sizeof(T)) != 0)) vw /= 2;
  return vw;
}

template <typename T, int W, bool kNHWC>
int launch_w(const T* x, const void* w, const void* b, T* y, int n, int groups,
             int cpg, int hw, float eps, bool params_bf16, bool silu,
             cudaStream_t stream) {
  const size_t bytes = (size_t)cpg * hw * sizeof(T);
  const bool cache = bytes <= kMaxCacheBytes;
  const size_t smem = cache ? bytes : 0;
  const cudaError_t err = e4t::allow_smem(group_norm_sync_kernel<T, W, kNHWC>, smem);
  if (err != cudaSuccess) return (int)err;
  group_norm_sync_kernel<T, W, kNHWC><<<n * groups, kBlock, smem, stream>>>(
      x, w, b, y, groups, cpg, hw, eps, params_bf16, cache, silu);
  return (int)cudaGetLastError();
}

template <typename T, bool kNHWC>
int launch(const void* x, const void* w, const void* b, void* y, int n,
           int channels, int groups, int hw, float eps, bool params_bf16,
           bool silu, cudaStream_t stream) {
  const int cpg = channels / groups;
  // the run W elements an access must divide: NCHW a channel's hw
  // elements, NHWC a pixel's cpg channels
  const int vw = vector_width<T>(kNHWC ? cpg : hw, x, y);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const bool pb = params_bf16;
  switch (vw) {
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_w<T, 8, kNHWC>(xt, w, b, yt, n, groups, cpg, hw, eps, pb, silu, stream);
      return (int)cudaErrorInvalidValue;
    case 4: return launch_w<T, 4, kNHWC>(xt, w, b, yt, n, groups, cpg, hw, eps, pb, silu, stream);
    case 2: return launch_w<T, 2, kNHWC>(xt, w, b, yt, n, groups, cpg, hw, eps, pb, silu, stream);
    default: return launch_w<T, 1, kNHWC>(xt, w, b, yt, n, groups, cpg, hw, eps, pb, silu, stream);
  }
}

// ---------------------------------------------------------------------------
// The channels-last path (group_norm_nhwc_kernel): one cooperative launch of
// resident blocks over tasks of (sample, pixel range, channel chunk).
//
// In NHWC memory a task's pixels are one contiguous span of P * C elements
// (C up to kNhwcMaxCols vectors; wider pixels are cut into channel chunks),
// read in 16-byte vectors: a block is `rows` pixel rows of `chunk_cols`
// threads, thread (r, col) reading vector column col of every rows-th pixel,
// so a warp reads consecutive vectors and a thread always sees the same W
// channels. It sums them per channel in registers; the block then adds its
// rows per channel and the channels per group through shared memory, in a
// fixed order, into the task's slot of a workspace (tasks x groups x (sum,
// sum of squares)). After a grid-wide barrier a warp per (sample, group)
// adds that sample's task partials in a fixed order (a butterfly over its
// lanes) and writes (mean, 1 / sqrt(var + eps)); after a second barrier each
// block normalises its own tasks again, last pixel first, so that what pass
// 1 read last is still in L2. There are no float atomics: two calls give the
// same bits. x is read from device memory once where it fits in L2 (the
// UNet's sites), twice at the VAE's 512x512 sites; y is stored with the
// evict-first hint so that it does not push x out of L2.
//
// The number of pixel ranges a sample is cut into follows from the card:
// as many tasks as blocks stay resident (occupancy x SMs), but no fewer
// than kNhwcMinRows pixel rows a thread.
//
// The launch and its two barriers cost ~8 µs (the H100, batch-8 UNet
// sites: 1280 channels at 8x8 took 0.0126 ms here, 0.0037 on the one block
// per (n, g) kernel), so x below kNhwcMinBytes stays on that kernel: every
// UNet site from 32x32 at 640 channels down.

constexpr int kNhwcThreads = 256;  // the most threads a block takes
constexpr int kNhwcMaxCols = 256;  // vector columns a task covers, at most
constexpr int kNhwcUnroll = 4;     // loads a thread keeps in flight
constexpr int kNhwcMinRows = 8;    // pixel rows a thread reads a task, at least
constexpr long long kNhwcMinBytes = 12LL << 20;  // x below it: one block per (n, g)

struct NhwcArgs {
  const void* x;
  const void* weight;
  const void* bias;
  void* y;
  float* ws;  // tasks x groups x 2 partials, then n x groups x (mean, inv)
  long long hw;
  int n, channels, groups, cpg;
  int cols;        // vectors a pixel holds: channels / W
  int chunk_cols;  // vectors a task covers
  int chunks;      // channel chunks a pixel is cut into
  int rows;        // pixel rows a block reads at once
  int splits;      // pixel ranges a sample is cut into
  int tasks;       // n x splits x chunks
  float eps;
  int params_bf16, silu;
};

// v stored with the evict-first (streaming) hint
template <typename V>
__device__ __forceinline__ void store_streaming(V* p, const V& v) {
  if constexpr (sizeof(V) == 16)
    __stcs(reinterpret_cast<int4*>(p), *reinterpret_cast<const int4*>(&v));
  else if constexpr (sizeof(V) == 8)
    __stcs(reinterpret_cast<int2*>(p), *reinterpret_cast<const int2*>(&v));
  else if constexpr (sizeof(V) == 4)
    __stcs(reinterpret_cast<int*>(p), *reinterpret_cast<const int*>(&v));
  else
    __stcs(reinterpret_cast<short*>(p), *reinterpret_cast<const short*>(&v));
}

template <typename T, int W>
__global__ void __launch_bounds__(kNhwcThreads)
group_norm_nhwc_kernel(const NhwcArgs a) {
  using V = Pack<T, W>;
  constexpr int kU = kNhwcUnroll;
  __shared__ float red[2][kNhwcThreads * W];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  const int tid = threadIdx.x;
  const int col = tid % a.chunk_cols, r = tid / a.chunk_cols;  // r >= rows: idle
  const int span = a.chunk_cols * W;  // channels a chunk covers
  const size_t C = a.channels;
  const long long hw = a.hw, rows = a.rows;
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);

  // task t: sample nn, pixels [p0, p1), this thread's vector column vcol
  auto locate = [&](int t, int& nn, long long& p0, long long& p1, int& vcol) {
    const int chunk = t % a.chunks, rest = t / a.chunks;
    const int split = rest % a.splits;
    nn = rest / a.splits;
    p0 = hw * split / a.splits;
    p1 = hw * (split + 1) / a.splits;
    vcol = chunk * a.chunk_cols + col;
  };

  // pass 1: each task's (sum, sum of squares) per group
  for (int t = blockIdx.x; t < a.tasks; t += gridDim.x) {
    int nn, vcol;
    long long p0, p1;
    locate(t, nn, p0, p1, vcol);
    float s[W], q[W];
#pragma unroll
    for (int e = 0; e < W; ++e) s[e] = q[e] = 0.f;
    if (r < a.rows && vcol < a.cols) {
      const T* src = x + (size_t)nn * hw * C + (size_t)vcol * W;
      long long p = p0 + r;
      for (; p + (kU - 1) * rows < p1; p += kU * rows) {
        V v[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u)
          v[u] = *reinterpret_cast<const V*>(src + (size_t)(p + u * rows) * C);
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int e = 0; e < W; ++e) {
            const float f = to_f32(v[u].e[e]);
            s[e] += f;
            q[e] = fmaf(f, f, q[e]);
          }
      }
      for (; p < p1; p += rows) {
        const V v = *reinterpret_cast<const V*>(src + (size_t)p * C);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const float f = to_f32(v.e[e]);
          s[e] += f;
          q[e] = fmaf(f, f, q[e]);
        }
      }
    }
    __syncthreads();  // the previous task is done with red
#pragma unroll
    for (int e = 0; e < W; ++e) {
      red[0][tid * W + e] = s[e];  // row r, chunk channel col * W + e
      red[1][tid * W + e] = q[e];
    }
    __syncthreads();
    for (int lc = tid; lc < span; lc += blockDim.x) {  // rows, per channel
      float cs = 0.f, cq = 0.f;
      for (int rr = 0; rr < a.rows; ++rr) {
        cs += red[0][rr * span + lc];
        cq += red[1][rr * span + lc];
      }
      red[0][lc] = cs;
      red[1][lc] = cq;
    }
    __syncthreads();
    const int c_lo = (t % a.chunks) * span;
    const int c_hi = min(c_lo + span, a.channels);
    for (int g = tid; g < a.groups; g += blockDim.x) {  // channels, per group
      const int lo = max(g * a.cpg, c_lo), hi = min((g + 1) * a.cpg, c_hi);
      float gs = 0.f, gq = 0.f;
      for (int c = lo; c < hi; ++c) {
        gs += red[0][c - c_lo];
        gq += red[1][c - c_lo];
      }
      float* slot = a.ws + ((size_t)t * a.groups + g) * 2;
      slot[0] = gs;
      slot[1] = gq;
    }
  }
  grid.sync();

  // each (sample, group)'s statistics from its tasks' partials, a warp each
  float* stats = a.ws + (size_t)a.tasks * a.groups * 2;
  const int lane = tid & 31, warps = blockDim.x >> 5;
  const int per_sample = a.splits * a.chunks;
  for (int i = blockIdx.x * warps + (tid >> 5); i < a.n * a.groups;
       i += gridDim.x * warps) {
    const int nn = i / a.groups, g = i - nn * a.groups;
    float s = 0.f, q = 0.f;
    for (int j = lane; j < per_sample; j += 32) {
      const float* slot = a.ws + (((size_t)nn * per_sample + j) * a.groups + g) * 2;
      s += slot[0];
      q += slot[1];
    }
    s = warp_sum(s);
    q = warp_sum(q);
    if (lane == 0) {
      const float n_elems = (float)a.cpg * (float)hw;
      const float mean = s / n_elems;
      const float var = q / n_elems - mean * mean;  // the fast variance
      stats[2 * i] = mean;
      stats[2 * i + 1] = 1.f / sqrtf(var + a.eps);
    }
  }
  grid.sync();

  // pass 2: y = x * a + b per channel (+ SiLU), the block's tasks and each
  // task's pixels in reverse order
  const bool pb = a.params_bf16 != 0;
  for (int t = blockIdx.x + (a.tasks - 1 - blockIdx.x) / gridDim.x * gridDim.x; t >= 0;
       t -= gridDim.x) {
    int nn, vcol;
    long long p0, p1;
    locate(t, nn, p0, p1, vcol);
    if (r >= a.rows || vcol >= a.cols || p0 + r >= p1) continue;
    float ca[W], cb[W];
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const int ch = vcol * W + e;
      const float* st = stats + 2 * ((size_t)nn * a.groups + ch / a.cpg);
      ca[e] = st[1] * param(a.weight, ch, pb);
      cb[e] = param(a.bias, ch, pb) - st[0] * ca[e];
    }
    auto apply = [&](const V& v) {
      V o;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        float f = to_f32(v.e[e]) * ca[e] + cb[e];
        if (a.silu) f = f / (1.f + expf(-f));
        o.e[e] = from_f32<T>(f);
      }
      return o;
    };
    const size_t base = (size_t)nn * hw * C + (size_t)vcol * W;
    const T* src = x + base;
    T* dst = y + base;
    long long k = (p1 - 1 - p0 - r) / rows;  // this thread's last row: p0 + r + k * rows
    for (; k >= kU - 1; k -= kU) {
      V v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        v[u] = *reinterpret_cast<const V*>(src + (size_t)(p0 + r + (k - u) * rows) * C);
#pragma unroll
      for (int u = 0; u < kU; ++u)
        store_streaming(reinterpret_cast<V*>(dst + (size_t)(p0 + r + (k - u) * rows) * C),
                        apply(v[u]));
    }
    for (; k >= 0; --k) {
      const size_t off = (size_t)(p0 + r + k * rows) * C;
      store_streaming(reinterpret_cast<V*>(dst + off),
                      apply(*reinterpret_cast<const V*>(src + off)));
    }
  }
}

// The workspace floats a channels-last launch needs at most, for
// ``resident`` resident blocks at most: the partials of max(n x chunks,
// resident) tasks and the n x groups statistics.
long long nhwc_workspace_floats(int n, int groups, int chunks, long long resident) {
  const long long tasks = std::max((long long)n * chunks, resident);
  return 2LL * groups * tasks + 2LL * n * groups;
}

template <typename T, int W>
int launch_nhwc(const void* x, const void* w, const void* b, void* y, float* ws,
                long long ws_floats, int n, int channels, int groups, long long hw,
                float eps, bool params_bf16, bool silu, cudaStream_t stream) {
  auto kernel = group_norm_nhwc_kernel<T, W>;
  NhwcArgs a;
  a.x = x;
  a.weight = w;
  a.bias = b;
  a.y = y;
  a.ws = ws;
  a.hw = hw;
  a.n = n;
  a.channels = channels;
  a.groups = groups;
  a.cpg = channels / groups;
  a.cols = channels / W;
  a.chunks = (a.cols + kNhwcMaxCols - 1) / kNhwcMaxCols;
  a.chunk_cols = (a.cols + a.chunks - 1) / a.chunks;
  a.rows = std::max(1, kNhwcThreads / a.chunk_cols);
  a.eps = eps;
  a.params_bf16 = params_bf16;
  a.silu = silu;
  const int threads = (a.rows * a.chunk_cols + 31) / 32 * 32;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)per_sm * sms;
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  const long long per_split = (long long)n * a.chunks;  // tasks a pixel range gives
  const long long by_card = std::max(1LL, resident / per_split);
  const long long by_size = std::max(1LL, hw / ((long long)a.rows * kNhwcMinRows));
  a.splits = (int)std::min(by_card, by_size);
  a.tasks = (int)(per_split * a.splits);
  if (nhwc_workspace_floats(n, groups, a.chunks, resident) > ws_floats)
    return (int)cudaErrorInvalidValue;
  const int grid = (int)std::min((long long)a.tasks, resident);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(threads), args, 0, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises on the returned code
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_nhwc_t(const void* x, const void* w, const void* b, void* y, float* ws,
                  long long ws_floats, int n, int channels, int groups, long long hw,
                  float eps, bool pb, bool silu, cudaStream_t stream) {
  switch (vector_width<T>(channels, x, y)) {  // W: a pixel's channels divide it
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_nhwc<T, 8>(x, w, b, y, ws, ws_floats, n, channels, groups, hw, eps, pb,
                                 silu, stream);
      return (int)cudaErrorInvalidValue;
    case 4:
      return launch_nhwc<T, 4>(x, w, b, y, ws, ws_floats, n, channels, groups, hw, eps, pb,
                               silu, stream);
    case 2:
      return launch_nhwc<T, 2>(x, w, b, y, ws, ws_floats, n, channels, groups, hw, eps, pb,
                               silu, stream);
    default:
      return launch_nhwc<T, 1>(x, w, b, y, ws, ws_floats, n, channels, groups, hw, eps, pb,
                               silu, stream);
  }
}

bool bad_shape(int n, int channels, int groups, long long hw) {
  return n <= 0 || channels <= 0 || groups <= 0 || channels % groups != 0 || hw <= 0 ||
         (long long)channels * hw > 0x7fffffffLL || (long long)n * groups > 0x7fffffffLL;
}

// The synchronous design on either layout: one block per (n, g).
int run_sync(const void* x, const void* weight, const void* bias, void* y, int n,
             int channels, int groups, long long hw, int is_bf16, int params_bf16,
             int channels_last, float eps, int silu, cudaStream_t s) {
  if (bad_shape(n, channels, groups, hw)) return (int)cudaErrorInvalidValue;
  const bool act = silu != 0, pb = params_bf16 != 0;
  const int h = (int)hw;
  if (is_bf16)
    return channels_last
               ? launch<bf16, true>(x, weight, bias, y, n, channels, groups, h, eps, pb, act, s)
               : launch<bf16, false>(x, weight, bias, y, n, channels, groups, h, eps, pb, act, s);
  return channels_last
             ? launch<float, true>(x, weight, bias, y, n, channels, groups, h, eps, pb, act, s)
             : launch<float, false>(x, weight, bias, y, n, channels, groups, h, eps, pb, act, s);
}

}  // namespace

// Plain C entry point for ctypes. x and y are (N, C, H, W) in one memory
// layout, NCHW-contiguous (channels_last = 0) or channels-last (1), bf16
// (is_bf16 = 1) or f32; hw = H * W; weight and bias are contiguous (C,), bf16
// (params_bf16 = 1) or f32. Channels-last x from kNhwcMinBytes goes to the
// cooperative kernel, which needs an f32 workspace ws of ws_floats
// elements: the partials of max(n * ceil(C / 256), 32 * SMs) tasks (32
// blocks an SM is the most that stay resident), 2 * groups each, and the
// 2 * n * groups statistics. NCHW x and smaller channels-last x go to the
// one block per (n, g) kernel, which leaves ws unused. Runs on ``stream``, allocates nothing
// and does not synchronise. Returns the launch's CUDA error.
extern "C" int e4t_group_norm(const void* x, const void* weight, const void* bias,
                              void* y, int n, int channels, int groups, long long hw,
                              int is_bf16, int params_bf16, int channels_last,
                              float eps, int silu, void* ws, long long ws_floats,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!channels_last)
    return run_sync(x, weight, bias, y, n, channels, groups, hw, is_bf16, params_bf16, 0,
                    eps, silu, s);
  if (bad_shape(n, channels, groups, hw) || ws == nullptr) return (int)cudaErrorInvalidValue;
  if ((long long)n * channels * hw * (is_bf16 ? 2 : 4) < kNhwcMinBytes)
    return run_sync(x, weight, bias, y, n, channels, groups, hw, is_bf16, params_bf16, 1,
                    eps, silu, s);
  float* w = static_cast<float*>(ws);
  const bool act = silu != 0, pb = params_bf16 != 0;
  return is_bf16 ? launch_nhwc_t<bf16>(x, weight, bias, y, w, ws_floats, n, channels, groups,
                                       hw, eps, pb, act, s)
                 : launch_nhwc_t<float>(x, weight, bias, y, w, ws_floats, n, channels,
                                        groups, hw, eps, pb, act, s);
}

// The synchronous design (group_norm_sync_kernel, one block per (n, g)) kept
// as the yardstick: the same arguments as e4t_group_norm.
extern "C" int e4t_group_norm_sync(const void* x, const void* weight, const void* bias,
                                   void* y, int n, int channels, int groups, long long hw,
                                   int is_bf16, int params_bf16, int channels_last,
                                   float eps, int silu, void* stream) {
  return run_sync(x, weight, bias, y, n, channels, groups, hw, is_bf16, params_bf16,
                  channels_last, eps, silu, static_cast<cudaStream_t>(stream));
}
