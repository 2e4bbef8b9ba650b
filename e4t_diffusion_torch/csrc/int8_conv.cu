// int8 convolution for Hopper (sm_90a): an implicit GEMM on s8 tensor cores.
//
// Replaces the XLA convolution of e4t_diffusion_tpu/ops/quant.py:276-283
// (int8_conv: NHWC x HWIO int8 -> int32 -> rescale), which the JAX package
// leaves to XLA on the TPU; PyTorch has no int8 conv2d for CUDA. Contract:
// x (N, H, W, C) int8, w (O, kh, kw, C) int8 (the port's (O, C, kh, kw)
// weight permuted once per run), scale (O,) f32 = activation scale x
// per-output-channel weight scale, optional bias (O,) in the output type;
//   y = cast(float(acc) * scale[o]) (+ bias in the output type),
// the order of quant.py:283, 374; out (N, O, Ho, Wo), bf16 or f32, the
// layout the UNet's next op reads. Any kernel size, stride and symmetric
// zero padding; the UNet uses 3x3 at stride 1 and 2 with padding 1 and 1x1
// at stride 1. C must be a multiple of 16 (the caller pads it).
//
// What bounds it on the H100: the GEMM view is M = N*Ho*Wo output pixels,
// N = O output channels, K = kh*kw*C. At the UNet's 3x3 sites (e.g. 320 ->
// 320 at 64x64, batch 8: 60 G int8 ops, ~24 MB moved) the tensor cores bound
// it: ~0.03 ms at 1,979 TOP/s against ~0.007 ms of memory. The design keeps
// the im2col matrix out of device memory: each 64x64 A tile is gathered
// from x in 16-byte chunks (one (r, s) tap and 16 channels each), the padding
// halo read as zeros, next to a 64x64 tile of w; 4 warps each own a 32x32
// block of the 64x64 output tile and run s8 mma.sync m16n8k32 into s32
// accumulators. The next k tile is loaded into registers while the current
// one is multiplied. The epilogue rescales in f32 and writes NCHW directly.
// This is a first, simple kernel: no cp.async / TMA pipeline, no wgmma.

#include "flash_common.cuh"

namespace {

using e4t::bf16;
using e4t::kThreads;

constexpr int kBM = 64;           // output pixels per block
constexpr int kBN = 64;           // output channels per block
constexpr int kBK = 64;           // reduction bytes per k tile
constexpr int kPitch = kBK + 16;  // = 16 mod 32 bytes: conflict-free fragment loads
constexpr int kRowsPerPass = kThreads / (kBK / 16);  // 32 tile rows per pass of 128 threads

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

struct Geometry {
  int n, h, w, c, o, kh, kw, stride, pad, ho, wo;
  int k;    // kh * kw * c
  int m;    // n * ho * wo
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                 const float* __restrict__ scale, const T* __restrict__ bias,
                 T* __restrict__ out, Geometry geo) {
  __shared__ __align__(16) int8_t a_s[kBM * kPitch];
  __shared__ __align__(16) int8_t b_s[kBN * kPitch];

  const int m0 = blockIdx.x * kBM;
  const int o0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wm = (warp & 1) * 32;   // the warp's rows in the tile
  const int wn = (warp >> 1) * 32;  // the warp's columns in the tile

  // this thread loads 16-byte chunk `chunk` of tile rows `row` and
  // `row + 32`, in both the A (pixels) and the B (channels) tile
  const int chunk = tid & 3;
  const int row = tid >> 2;
  const int hw_out = geo.ho * geo.wo;
  int img[2], hi0[2], wi0[2];
  bool pix_ok[2], ch_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + row + i * kRowsPerPass;
    pix_ok[i] = m < geo.m;
    const int mm = pix_ok[i] ? m : 0;
    img[i] = mm / hw_out;
    const int pix = mm - img[i] * hw_out;
    const int oh = pix / geo.wo;
    hi0[i] = oh * geo.stride - geo.pad;
    wi0[i] = (pix - oh * geo.wo) * geo.stride - geo.pad;
    ch_ok[i] = o0 + row + i * kRowsPerPass < geo.o;
  }

  uint4 ra[2], rb[2];
  auto load = [&](int kt) {
    const int kk = kt * kBK + chunk * 16;
    const bool k_ok = kk < geo.k;
    int r = 0, s = 0, c = 0;
    if (k_ok) {
      const int rs = kk / geo.c;
      c = kk - rs * geo.c;
      r = rs / geo.kw;
      s = rs - r * geo.kw;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int hi = hi0[i] + r, wi = wi0[i] + s;
      ra[i] = make_uint4(0u, 0u, 0u, 0u);
      if (k_ok && pix_ok[i] && hi >= 0 && hi < geo.h && wi >= 0 && wi < geo.w)
        ra[i] = *reinterpret_cast<const uint4*>(
            x + (((size_t)img[i] * geo.h + hi) * geo.w + wi) * geo.c + c);
      rb[i] = make_uint4(0u, 0u, 0u, 0u);
      if (k_ok && ch_ok[i])
        rb[i] = *reinterpret_cast<const uint4*>(
            wt + (size_t)(o0 + row + i * kRowsPerPass) * geo.k + kk);
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

  const int nk = (geo.k + kBK - 1) / kBK;
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // every warp is done with the previous tile
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + i * kRowsPerPass;
      *reinterpret_cast<uint4*>(&a_s[r * kPitch + chunk * 16]) = ra[i];
      *reinterpret_cast<uint4*>(&b_s[r * kPitch + chunk * 16]) = rb[i];
    }
    __syncthreads();
    if (kt + 1 < nk) load(kt + 1);  // in flight while this tile multiplies

#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* p = a_s + (wm + mt * 16 + g) * kPitch + ks * 32 + t4 * 4;
        a[mt][0] = e4t::ld32(p);
        a[mt][1] = e4t::ld32(p + 8 * kPitch);
        a[mt][2] = e4t::ld32(p + 16);
        a[mt][3] = e4t::ld32(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* p = b_s + (wn + nt * 8 + g) * kPitch + ks * 32 + t4 * 4;
        const uint32_t b0 = e4t::ld32(p), b1 = e4t::ld32(p + 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) e4t::mma_s8_16832(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }

  // epilogue: rows g and g + 8 of each m16 tile, columns 2*t4 and 2*t4 + 1
  // of each n8 tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mt * 16 + g + half * 8;
      if (m >= geo.m) continue;
      const int n_img = m / hw_out;
      T* ob = out + (size_t)n_img * geo.o * hw_out + (m - n_img * hw_out);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int oc = o0 + wn + nt * 8 + t4 * 2 + e;
          if (oc >= geo.o) continue;
          // _rn intrinsics: no fused multiply-add, so each step rounds as
          // the plain version's separate multiply and add do
          T y = from_float<T>(__fmul_rn((float)acc[mt][nt][half * 2 + e], scale[oc]));
          if (bias != nullptr) y = from_float<T>(__fadd_rn(to_float(y), to_float(bias[oc])));
          ob[(size_t)oc * hw_out] = y;
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, const void* bias, void* out,
           const Geometry& geo, cudaStream_t stream) {
  const dim3 grid((geo.m + kBM - 1) / kBM, (geo.o + kBN - 1) / kBN);
  int8_conv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const T*>(bias), static_cast<T*>(out),
      geo);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. x (n, h, w, c) and wt (o, kh, kw, c) are
// contiguous int8, 16-byte aligned, c a multiple of 16; scale f32 (o,);
// bias (o,) in the output type or null; out (n, o, ho, wo) bf16
// (out_bf16 != 0) or f32. Runs on ``stream``, allocates nothing and does not
// synchronise. Returns cudaGetLastError() after the launch.
extern "C" int e4t_int8_conv(const void* x, const void* wt, const void* scale,
                             const void* bias, void* out, int n, int h, int w, int c,
                             int o, int kh, int kw, int stride, int pad, int ho, int wo,
                             int out_bf16, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c % 16 != 0 || o <= 0 || kh <= 0 ||
      kw <= 0 || stride <= 0 || pad < 0 || ho <= 0 || wo <= 0 ||
      (long long)n * ho * wo > 0x7fffffffLL || (long long)kh * kw * c > 0x7fffffffLL ||
      (o + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  const Geometry geo{n, h, w, c, o, kh, kw, stride, pad, ho, wo, kh * kw * c, n * ho * wo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<bf16>(x, wt, scale, bias, out, geo, s)
                  : launch<float>(x, wt, scale, bias, out, geo, s);
}
