// int8 activation quantization for Hopper (sm_90a): one elementwise pass.
//
// Replaces the XLA elementwise ops of e4t_diffusion_tpu/ops/quant.py:251-265
// (_quantize_activation) at the UNet's linear sites, which the port ran as
// five PyTorch passes over an f32 copy of x (cast, divide, round, clamp,
// cast). Contract: x (..., K) contiguous bf16 or f32; s f32, one value (the
// static "sa" or the dynamic max(|x|) / 127, computed on the card by the
// caller) or K values along the last axis (the per-channel "sac"); q the
// same shape, int8:
//   q = clamp(round_half_even(x / s), -127, 127),
// with the IEEE quotient (__fdiv_rn, never a multiply by a reciprocal) and
// __float2int_rn, as torch.round and jnp.round do, so q equals the plain
// version's bit for bit.
//
// What bounds it on the H100: bytes. Each element is read once (2 or 4
// bytes) and written once (1 byte), ~0.9 ms a UNet pass at 3.35 TB/s for
// the 1.03 G elements of a batch-8 512px pass, against ~35 bytes an element
// in the five passes. The design: each thread takes 8 consecutive elements
// (one 16-byte load of bf16, two of f32; one 8-byte store), consecutive
// threads consecutive elements, so every access is coalesced; the divide
// is ~10 instructions an element, far under the memory time. Where K or
// the element count is not a multiple of 8, or a pointer is not aligned,
// one element a thread.

#include <algorithm>

#include "flash_common.cuh"

namespace {

using e4t::bf16;

constexpr int kThreadsQ = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t quantize(float x, float s) {
  const int q = __float2int_rn(__fdiv_rn(x, s));
  return (uint32_t)(max(-127, min(127, q)) & 0xFF);
}

template <typename XT, int VEC>
__global__ void __launch_bounds__(kThreadsQ)
quantize_kernel(const XT* __restrict__ x, int8_t* __restrict__ q, const float* __restrict__ s,
                int per_channel, int n, int k) {
  const float s0 = per_channel ? 0.f : s[0];
  const int stride = gridDim.x * kThreadsQ * VEC;
  for (int i = (blockIdx.x * kThreadsQ + threadIdx.x) * VEC; i < n; i += stride) {
    if constexpr (VEC == 8) {
      constexpr int kLoads = (int)sizeof(XT) / 2;  // 16-byte loads of 8 elements
      uint4 raw[kLoads];
#pragma unroll
      for (int l = 0; l < kLoads; ++l) raw[l] = reinterpret_cast<const uint4*>(x + i)[l];
      const XT* v = reinterpret_cast<const XT*>(raw);
      const int c0 = per_channel ? i % k : 0;  // K % 8 == 0: one row
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        w[e / 4] |= quantize(to_float(v[e]), per_channel ? s[c0 + e] : s0) << (8 * (e % 4));
      *reinterpret_cast<uint2*>(q + i) = make_uint2(w[0], w[1]);
    } else {
      q[i] = (int8_t)quantize(to_float(x[i]), per_channel ? s[i % k] : s0);
    }
  }
}

template <typename XT, int VEC>
int launch(const void* x, void* q, const void* s, int per_channel, int n, int k,
           cudaStream_t stream) {
  const long long threads = ((long long)n + VEC - 1) / VEC;
  const int blocks = (int)std::min<long long>((threads + kThreadsQ - 1) / kThreadsQ, 132 * 64);
  quantize_kernel<XT, VEC><<<blocks, kThreadsQ, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<int8_t*>(q), static_cast<const float*>(s),
      per_channel, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. x (n <= 2^30 elements, rows of k) contiguous bf16
// (x_f32 == 0) or f32; q n int8; s f32, k values where per_channel != 0,
// else one. Runs on ``stream``, allocates nothing and does not synchronise.
// Returns cudaGetLastError() after the launch.
extern "C" int e4t_quantize(const void* x, int x_f32, void* q, const void* s, int per_channel,
                            long long n, int k, void* stream) {
  if (n <= 0 || n > (1LL << 30) || k <= 0 || n % k != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 8 == 0 && (!per_channel || k % 8 == 0) &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 8 == 0;
  const int ni = (int)n;
  if (x_f32)
    return vec ? launch<float, 8>(x, q, s, per_channel, ni, k, st)
               : launch<float, 1>(x, q, s, per_channel, ni, k, st);
  return vec ? launch<bf16, 8>(x, q, s, per_channel, ni, k, st)
             : launch<bf16, 1>(x, q, s, per_channel, ni, k, st);
}
