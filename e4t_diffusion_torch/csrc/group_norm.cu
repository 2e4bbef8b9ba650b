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
// sample to its groups with a one-hot (C, G) matrix on the MXU; here one
// block reduces one (sample, group) with a plain block reduction.
//
// Layouts. The port's UNet and VAE hand both layouts to their GroupNorm
// sites: the spatial transformers' output is a channels-last view and a
// conv of a channels-last input stays channels-last, so from batch 2 on most
// sites after the first transformer see NHWC memory. In NCHW the group is one contiguous
// span of (C/G) * H * W elements, read in 16-byte vectors when H * W is a
// multiple of the vector width (no vector straddles two channels). In NHWC
// the group is H * W runs of C/G consecutive channels, C apart, read in
// vectors of the largest power of two (up to 16 bytes) that divides C/G:
// 4 bytes at SD v1's C/G = 10, 16 bytes at C/G = 40. The blocks of one
// sample's other groups read the rest of each 32-byte sector, so device
// memory sees each byte about once and L2 the rest.
//
// What bounds it on the H100: memory. The function reads x once and writes
// y once (2 * numel * itemsize bytes over 3.35 TB/s) and does ~10 flops an
// element. Pass 1 loads the group, keeps a copy in shared memory and sums;
// pass 2 normalises from that copy and writes, so x is read from device
// memory once where the group fits in shared memory. The group is one
// sample's, so its size does not depend on the batch: every SD-v1 UNet
// group at 512px fits but one (960 channels at 64x64 over 32 groups, 240 KB
// in bf16); it and the VAE's groups from 128x128 up re-read x in pass 2,
// from L2 where it still holds it. The TPU kernel's 6 MB VMEM gate has no
// counterpart: one kernel takes every site.
//
// Layout of the work: one block of 512 threads per (n, g).

#include <math.h>

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
group_norm_kernel(const T* __restrict__ x, const void* __restrict__ weight,
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

template <typename T, int W, bool kNHWC>
int launch_w(const T* x, const void* w, const void* b, T* y, int n, int groups,
             int cpg, int hw, float eps, bool params_bf16, bool silu,
             cudaStream_t stream) {
  const size_t bytes = (size_t)cpg * hw * sizeof(T);
  const bool cache = bytes <= kMaxCacheBytes;
  const size_t smem = cache ? bytes : 0;
  const cudaError_t err = e4t::allow_smem(group_norm_kernel<T, W, kNHWC>, smem);
  if (err != cudaSuccess) return (int)err;
  group_norm_kernel<T, W, kNHWC><<<n * groups, kBlock, smem, stream>>>(
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
  const int run = kNHWC ? cpg : hw;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  int vw = 16 / (int)sizeof(T);
  while (vw > 1 && (run % vw != 0 || addr % (vw * sizeof(T)) != 0)) vw /= 2;
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

}  // namespace

// Plain C entry point for ctypes. x and y are (N, C, H, W) in one memory
// layout, NCHW-contiguous (channels_last = 0) or channels-last (1), bf16
// (is_bf16 = 1) or f32; hw = H * W; weight and bias are contiguous (C,), bf16
// (params_bf16 = 1) or f32. Runs on ``stream``, allocates nothing and does
// not synchronise. Returns cudaGetLastError() after the launch.
extern "C" int e4t_group_norm(const void* x, const void* weight, const void* bias,
                              void* y, int n, int channels, int groups, long long hw,
                              int is_bf16, int params_bf16, int channels_last,
                              float eps, int silu, void* stream) {
  if (n <= 0 || channels <= 0 || groups <= 0 || channels % groups != 0 || hw <= 0 ||
      (long long)channels * hw > 0x7fffffffLL || (long long)n * groups > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
