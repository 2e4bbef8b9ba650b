// int8 convolution for Hopper (sm_90a): an implicit GEMM on s8 tensor cores,
// with the activation's quantization in its loads.
//
// Replaces the XLA convolution of e4t_diffusion_tpu/ops/quant.py:276-283
// (int8_conv: NHWC x HWIO int8 -> int32 -> rescale), which the JAX package
// leaves to XLA on the TPU; PyTorch has no int8 conv2d for CUDA. Contract:
// w (O, kh, kw, C) int8 (the port's (O, C, kh, kw) weight permuted once per
// run); x either (N, H, W, C) int8 (e4t_int8_conv) or the UNet's own bf16 /
// f32 activation, NCHW or channels-last, quantized as it is loaded with the
// static per-tensor or per-channel scale or the dynamic one
// (e4t_int8_conv_act: q = clamp(round_half_even(x / s), -127, 127), the IEEE
// quotient, as quant.quantize_activation); the rescale f32 (O,) = activation
// scale x per-output-channel weight scale, optional bias (O,) in the output
// type;
//   y = cast(float(acc) * scale[o]) (+ bias in the output type),
// the order of quant.py:283, 374; out (N, O, Ho, Wo), bf16 or f32, the
// layout the UNet's next op reads. Any kernel size, stride and symmetric
// zero padding; the UNet uses 3x3 at stride 1 and 2 with padding 1 and 1x1
// at stride 1.
//
// What bounds it on the H100: the GEMM view is M = N*Ho*Wo output pixels,
// N = O output channels, K = kh*kw*C. At the UNet's 3x3 sites (e.g. 320 ->
// 320 at 64x64, batch 8: 60 G int8 ops, ~24 MB moved) the tensor cores bound
// it: ~0.03 ms at 1,979 TOP/s against ~0.007 ms of memory. The wgmma design
// (int8_conv_wgmma_kernel, below) keeps the im2col matrix out of device
// memory and reads each x byte once a block: a block owns 128 output pixels
// laid out as a spatial tile (whole rows of one or two images at the UNet's
// widths) by 160 output channels (160 divides every UNet width), two
// warpgroups of 64 x 160 on s8 wgmma m64n160k32, two blocks an SM. Per chunk
// of 64 input channels it holds the tile's input halo in shared memory as
// int8, and reads every kh*kw tap's A fragments from it with ldmatrix (one
// 16-byte row a pixel, so strides and tile shapes need no other code); the
// weight tiles of (chunk, tap) and the int8 halo come through a cp.async
// ring, three steps ahead. Where x is bf16 or f32, a chunk's halo is staged
// in x's own type by cp.async a chunk ahead and quantized into the int8
// halo over the previous chunk's later taps, each element once a block
// (where the staging does not fit, x is loaded through registers and
// quantized on the way). Where the tiles are too few for the 132 SMs (the
// 8x8 and 16x16 sites), the channel chunks are split among up to 8 blocks
// that add exact int32 partial sums into a workspace, and a second kernel
// rescales once, after the last part. The epilogue stages the tile through
// shared memory so NCHW stores go out 16 bytes at a time. What holds it
// back (time_int8_conv.py --ablate, PERF.md): the loads, then the
// quantization, which a block repeats for every 160-channel tile and for
// its halo's overlap.
//
// The synchronous design it replaced (int8_conv_sync_kernel: 64x64 tiles,
// mma.sync m16n8k32, register-staged loads re-gathered for every tap, NCHW
// stores element by element) stays as the yardstick: the same integer sums
// and the same epilogue, so the two agree bit for bit.

#include <algorithm>

#include "wgmma_common.cuh"

// ---- the synchronous design (the yardstick) ----

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
int8_conv_sync_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
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
int launch_sync(const void* x, const void* w, const void* scale, const void* bias, void* out,
           const Geometry& geo, cudaStream_t stream) {
  const dim3 grid((geo.m + kBM - 1) / kBM, (geo.o + kBN - 1) / kBN);
  int8_conv_sync_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const T*>(bias), static_cast<T*>(out),
      geo);
  return (int)cudaGetLastError();
}

}  // namespace


// ---- the wgmma design ----

namespace {

using e4t::core_offset;

constexpr int kWN = 160;             // output channels a block: m64n160k32
constexpr int kWM = 128;             // output pixels a block: two warpgroups of 64
constexpr int kWThreads = 256;
constexpr int kKC = 64;              // channels (bytes) a k-step: two k32 products
constexpr int kPlanes = kKC / 16;    // 16-channel planes of a halo chunk
constexpr int kStages = 4;           // weight ring: steps j + 1 .. j + 3 in flight
constexpr int kBTile = kWN * kKC;    // bytes of one weight tile
constexpr int kMaxSplits = 8;

// d (64 x 160, s32) += a (64 x 32 s8: each warp of the warpgroup holds the
// mma.m16n8k32 A fragment of its 16 rows) b (32 x 160); b a K-major s8 tile
// in shared memory, given by a descriptor
__device__ __forceinline__ void wgmma_s8_rs160(int (&d)[80], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
      " %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      " %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const unsigned char* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

// Everything a launch needs: the geometry, the pointers, and the tiling the
// host chose. x has c channels; the weight's rows hold kh * kw * cw bytes
// (cw >= c, a multiple of 16, the channels past c zero).
struct ConvArgs {
  const void* x;
  const int8_t* wt;
  const float* wscale;   // (o,): the weight's scale, or the whole rescale
  const float* act;      // the activation scale: (1,) or (c,) per channel; null for int8 x
  const float* act_mul;  // (1,) multiplied into wscale per channel, or null
  const void* bias;      // (o,) in the output type, or null
  void* out;             // (n, o, ho, wo)
  int* ws;               // (n * ho * wo, o) int32 partial sums when split, else null
  int n, h, w, c, cw, o, kh, kw, stride, pad, ho, wo;
  int tw, th, tn;        // the output tile: tn images x th rows x tw columns (= 128)
  int hh, hw, hpix;      // its input halo: rows, columns, pixels (tn * hh * hw)
  int tiles_w, tiles_h, tiles_n;
  int n_chunks, chunks_per_split;
  int halo_bufs;         // int8 halo buffers in the ring
  int lead, rowlen;      // staged NCHW x: elements before the halo's first column
                         // in a row, and the row's length (both aligned to 16 bytes)
  int raw_bytes;         // staged x: bytes of one chunk's halo in x's type
  int vec_store;         // the tile's rows go out 16 bytes at a time
};

// q = clamp(round_half_even(x / s), -127, 127): the IEEE quotient (no
// reciprocal), as quantize_activation's
__device__ __forceinline__ uint32_t quantize(float x, float s) {
  const int q = __float2int_rn(__fdiv_rn(x, s));
  return (uint32_t)(max(-127, min(127, q)) & 0xFF);
}

// The same value, faster: t = x * r (r = 1 / s, rounded) is within
// 3 x 2^-24 |t| of the IEEE quotient fl(x / s), so where t lies farther
// than 1.2e-6 |t| from a half-way point k + 0.5 both round to the same
// integer; nearer, and for |t| >= 2^22, inf or NaN, the IEEE quotient is
// taken.
__device__ __forceinline__ uint32_t quantize_fast(float x, float s, float r) {
  const float t = x * r;
  const float away = fabsf(t - floorf(t) - 0.5f);
  if (!(fabsf(t) < 4194304.f) || away <= fabsf(t) * 1.2e-6f) return quantize(x, s);
  const int q = __float2int_rn(t);
  return (uint32_t)(max(-127, min(127, q)) & 0xFF);
}

// How a kernel fills its int8 halo:
// - kS8: x is int8 NHWC; the halo comes by cp.async with the ring.
// - kStaged: x (bf16 / f32) comes by cp.async into a staging buffer in its
//   own type and layout, a chunk ahead, and is quantized smem -> smem.
// - kDirect: x is loaded through registers and quantized on the way (where
//   the staging does not fit or x's rows are not 16-byte aligned).
enum class Fill { kS8, kStaged, kDirect };

struct LoadS8 {
  static constexpr Fill kFill = Fill::kS8;
  static constexpr bool kNhwc = true;
  using XT = int8_t;
};

template <typename XT_, bool kNhwc_, Fill kFill_>
struct LoadQuant {
  static constexpr Fill kFill = kFill_;
  static constexpr bool kNhwc = kNhwc_;
  using XT = XT_;
};

// 16 quantized channels from 16 values of x's type, each `step` elements
// apart in `src`, into the 16 bytes at `dst`, a 4-byte word at a time (few
// values live at once): channel k scaled by s[k] (per channel; past n_valid
// channels, where the values are zero, by s[n_valid - 1]) or s0
template <typename XT>
__device__ __forceinline__ void quantize16(unsigned char* dst, const XT* src, int step,
                                           const float* s, int n_valid, float s0, float r0) {
#pragma unroll 1
  for (int w = 0; w < 4; ++w) {
    uint32_t word = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * w + e;
      const float sk = s != nullptr ? s[min(k, n_valid - 1)] : s0;
      const float rk = s != nullptr ? __frcp_rn(sk) : r0;
      word |= quantize_fast(to_float(src[k * step]), sk, rk) << (8 * e);
    }
    reinterpret_cast<uint32_t*>(dst)[w] = word;
  }
}

// One block: a tile of 128 output pixels (tn images x th rows x tw columns)
// by 160 output channels, two warpgroups of 64 pixels each, over the
// channel chunks [cc0, cc0 + chunks_per_split) of its split. The k-steps
// walk chunk by chunk and, within a chunk, tap by tap: step j multiplies the
// chunk's halo, read at tap (r, s), by the weight tile of (chunk, tap).
// The weight tiles come through a cp.async ring, one group a step; the int8
// halo of a chunk (16-channel planes of 16 bytes a pixel) arrives with the
// group of its first step. Each warp loads its A fragments from the halo
// with ldmatrix (one 16-byte row a pixel, so any stride and tile shape) and
// the warpgroup issues s8 wgmma m64n160k32 with B from the ring. One block
// barrier a step.
template <typename T, class Loader>
__global__ void __launch_bounds__(kWThreads, 2)
    int8_conv_wgmma_kernel(const __grid_constant__ ConvArgs a) {
  using XT = typename Loader::XT;
  constexpr Fill kFill = Loader::kFill;
  constexpr int kV = 16 / (int)sizeof(XT);  // x elements a 16-byte copy
  extern __shared__ __align__(128) unsigned char smem[];
  const int plane_bytes = a.hpix * 16;
  const int halo_bytes = kPlanes * plane_bytes;
  unsigned char* b_s = smem;
  unsigned char* halo_s = smem + kStages * kBTile;
  XT* raw_s = reinterpret_cast<XT*>(halo_s + a.halo_bufs * halo_bytes);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wi = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int o0 = blockIdx.y * kWN;
  int t_idx = blockIdx.x;
  const int tile_w = t_idx % a.tiles_w;
  t_idx /= a.tiles_w;
  const int tile_h = t_idx % a.tiles_h;
  const int tile_n = t_idx / a.tiles_h;
  const int n0 = tile_n * a.tn, ho0 = tile_h * a.th, wo0 = tile_w * a.tw;
  const int hi0 = ho0 * a.stride - a.pad, wi0 = wo0 * a.stride - a.pad;

  const int cc0 = blockIdx.z * a.chunks_per_split;
  const int n_cc = min(a.chunks_per_split, a.n_chunks - cc0);
  if (n_cc <= 0) return;  // an empty split adds nothing
  const int taps = a.kh * a.kw;
  const int n_steps = n_cc * taps;
  const int krow = taps * a.cw;  // the host keeps o * krow and x's size under 2^31
  const int hhw = a.hh * a.hw;
  const XT* x = static_cast<const XT*>(a.x);
  const bool per_channel = a.act_mul == nullptr;
  const float s0 = per_channel || a.act == nullptr ? 1.f : a.act[0];
  const float r0 = __frcp_rn(s0);

  // a halo pixel -> its element offset in NHWC x (-1 outside the image)
  auto nhwc_at = [&](int pix) {
    const int tn = pix / hhw, rem = pix - tn * hhw;
    const int hr = rem / a.hw;
    const int n = n0 + tn, hi = hi0 + hr, wi = wi0 + rem - hr * a.hw;
    const bool in = n < a.n && hi >= 0 && hi < a.h && wi >= 0 && wi < a.w;
    return in ? ((n * a.h + hi) * a.w + wi) * a.c : -1;
  };

  // the weight tile of step j, and (int8 x) the halo of its chunk where j is
  // the chunk's first step
  auto load_step = [&](int j) {
    const int ci = j / taps, t = j - ci * taps;
    const int ch0 = (cc0 + ci) * kKC;
    unsigned char* dst = b_s + (j % kStages) * kBTile;
    for (int i = tid; i < kWN * kPlanes; i += kWThreads) {
      const int r = i >> 2, p = i & 3;
      const int oc = o0 + r, ch = ch0 + 16 * p;
      const bool in = oc < a.o && ch < a.cw;
      e4t::cp_async_16(dst + core_offset(r, p, kPlanes),
                       a.wt + (in ? oc * krow + t * a.cw + ch : 0), in ? 16 : 0);
    }
    if constexpr (kFill == Fill::kS8) {
      if (t != 0) return;
      unsigned char* hb = halo_s + (ci % a.halo_bufs) * halo_bytes;
      for (int i = tid; i < a.hpix * kPlanes; i += kWThreads) {
        const int pix = i >> 2, p = i & 3;
        const int at = nhwc_at(pix);
        const bool in = at >= 0 && ch0 + 16 * p < a.c;
        e4t::cp_async_16(hb + p * plane_bytes + pix * 16, x + (in ? at + ch0 + 16 * p : 0),
                         in ? 16 : 0);
      }
    }
  };

  // staged x: chunk cc's halo in x's type by cp.async, zeros outside the
  // image and past c. NHWC: [pixel][64 channels]; NCHW: [channel][image]
  // [row][rowlen], each row from the 16-byte-aligned column wi0 - lead.
  auto stage_raw = [&](int cc) {
    const int ch0 = cc * kKC;
    if constexpr (Loader::kNhwc) {
      constexpr int kPer = kKC / kV;  // 16-byte copies a pixel
      for (int i = tid; i < a.hpix * kPer; i += kWThreads) {
        const int pix = i / kPer, v = i % kPer;
        const int at = nhwc_at(pix);
        const bool in = at >= 0 && ch0 + v * kV < a.c;
        e4t::cp_async_16(raw_s + pix * kKC + v * kV, x + (in ? at + ch0 + v * kV : 0),
                         in ? 16 : 0);
      }
    } else {
      const int per_row = a.rowlen / kV, rows = a.tn * a.hh;
      for (int i = tid; i < kKC * rows * per_row; i += kWThreads) {
        const int v = i % per_row, row = (i / per_row) % rows, k = i / (per_row * rows);
        const int tn = row / a.hh, n = n0 + tn, hi = hi0 + row - tn * a.hh;
        const int col = wi0 - a.lead + v * kV, ch = ch0 + k;
        const bool in = n < a.n && ch < a.c && hi >= 0 && hi < a.h && col >= 0 && col < a.w;
        e4t::cp_async_16(raw_s + (k * rows + row) * a.rowlen + v * kV,
                         x + (in ? ((n * a.c + ch) * a.h + hi) * a.w + col : 0), in ? 16 : 0);
      }
    }
  };

  // part `part` of `parts` of chunk cc's int8 halo into buffer buf: from
  // the staging (kStaged) or from x through registers (kDirect)
  auto quantize_part = [&](int cc, int buf, int part, int parts) {
    unsigned char* dst = halo_s + buf * halo_bytes;
    const int items = a.hpix * kPlanes;
    const int end = (int)((long long)items * (part + 1) / parts);
    const int ch0 = cc * kKC;
    for (int i = (int)((long long)items * part / parts) + tid; i < end; i += kWThreads) {
      int pix, p;
      if (Loader::kNhwc) {  // consecutive threads: a pixel's planes
        pix = i >> 2;
        p = i & 3;
      } else {  // consecutive threads: a plane's pixels
        p = i / a.hpix;
        pix = i - p * a.hpix;
      }
      const int ch = ch0 + 16 * p;
      const float* sc = per_channel ? a.act + ch : nullptr;
      const int n_valid = min(16, a.c - ch);
      unsigned char* slot = dst + p * plane_bytes + pix * 16;
      if constexpr (kFill == Fill::kStaged) {
        if (ch >= a.c) {
          *reinterpret_cast<uint4*>(slot) = make_uint4(0u, 0u, 0u, 0u);
        } else if (Loader::kNhwc) {
          quantize16(slot, raw_s + pix * kKC + 16 * p, 1, sc, n_valid, s0, r0);
        } else {
          const int tn = pix / hhw, rem = pix - tn * hhw, hr = rem / a.hw;
          const int rows = a.tn * a.hh;
          quantize16(slot,
                     raw_s + (16 * p * rows + tn * a.hh + hr) * a.rowlen + a.lead + rem -
                         hr * a.hw,
                     rows * a.rowlen, sc, n_valid, s0, r0);
        }
      } else if constexpr (kFill == Fill::kDirect) {
        const int tn = pix / hhw, rem = pix - tn * hhw, hr = rem / a.hw;
        const int n = n0 + tn, hi = hi0 + hr, wi = wi0 + rem - hr * a.hw;
        uint32_t word[4] = {0u, 0u, 0u, 0u};
        if (n < a.n && hi >= 0 && hi < a.h && wi >= 0 && wi < a.w && ch < a.c) {
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            if (k >= n_valid) break;
            const int at = Loader::kNhwc ? ((n * a.h + hi) * a.w + wi) * a.c + ch + k
                                         : ((n * a.c + ch + k) * a.h + hi) * a.w + wi;
            word[k >> 2] |= quantize(to_float(x[at]), per_channel ? a.act[ch + k] : s0)
                            << (8 * (k & 3));
          }
        }
        *reinterpret_cast<uint4*>(slot) = make_uint4(word[0], word[1], word[2], word[3]);
      }
    }
  };

  // this lane's ldmatrix row: pixel m of the tile, k half kh2 of a k32 step
  const int mi = lane >> 3;
  const int m = wg * 64 + wi * 16 + (mi & 1) * 8 + (lane & 7);
  const int kh2 = mi >> 1;
  const int tpix = a.th * a.tw;
  const int a_tn = m / tpix, a_th = (m - a_tn * tpix) / a.tw, a_tw = m % a.tw;
  const int a_pix = (a_tn * a.hh + a_th * a.stride) * a.hw + a_tw * a.stride;

  // prologue: the first chunk's int8 halo (staged x: staged, landed and
  // quantized here), then steps 0 .. kStages - 2, one group each
  if constexpr (kFill == Fill::kStaged) {
    stage_raw(cc0);
    e4t::cp_async_commit();
    e4t::cp_async_wait<0>();
    __syncthreads();
    quantize_part(cc0, 0, 0, 1);
  } else if constexpr (kFill == Fill::kDirect) {
    quantize_part(cc0, 0, 0, 1);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load_step(s);
    e4t::cp_async_commit();
  }

  int acc[80];
  uint32_t af[kKC / 32][4];
#pragma unroll
  for (int i = 0; i < 80; ++i) acc[i] = 0;

  for (int j = 0; j < n_steps; ++j) {
    const int ci = j / taps, t = j - ci * taps;
    e4t::cp_async_wait<kStages - 2>();  // step j's tiles have landed
    e4t::wgmma_wait<0>();               // step j - 1's products are done
    e4t::fence_regs(acc);               // the wgmmas read and write these
    e4t::fence_regs(af);                // registers until they are done
    e4t::fence_proxy_async();
    __syncthreads();
    if (j + kStages - 1 < n_steps) load_step(j + kStages - 1);
    // staged x: the next chunk's halo in x's type, in this step's group
    if (kFill == Fill::kStaged && t == 0 && ci + 1 < n_cc) stage_raw(cc0 + ci + 1);
    e4t::cp_async_commit();  // possibly empty: the group count stays uniform

    const int r = t / a.kw, s = t - r * a.kw;
    const int buf = kFill == Fill::kS8 ? ci % a.halo_bufs : ci & 1;
    const unsigned char* hb =
        halo_s + buf * halo_bytes + kh2 * plane_bytes + (a_pix + r * a.hw + s) * 16;
#pragma unroll
    for (int ks = 0; ks < kKC / 32; ++ks) ldmatrix_x4(af[ks], hb + 2 * ks * plane_bytes);
    const unsigned char* bt = b_s + (j % kStages) * kBTile;
    e4t::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKC / 32; ++ks)
      wgmma_s8_rs160(acc, af[ks], e4t::smem_desc(bt + ks * 256, 128, kPlanes * 128));
    e4t::wgmma_commit();

    // quantize the next chunk while the tensor cores run: staged x over
    // the taps from kStages - 1 on (its copies landed with this step's
    // wait), or all at the last tap where the taps are fewer; direct x
    // over every tap
    if (kFill != Fill::kS8 && ci + 1 < n_cc) {
      if (kFill == Fill::kDirect) {
        quantize_part(cc0 + ci + 1, (ci + 1) & 1, t, taps);
      } else if (taps >= kStages) {
        if (t >= kStages - 1)
          quantize_part(cc0 + ci + 1, (ci + 1) & 1, t - (kStages - 1), taps - (kStages - 1));
      } else if (t == taps - 1) {
        e4t::cp_async_wait<0>();
        __syncthreads();
        quantize_part(cc0 + ci + 1, (ci + 1) & 1, 0, 1);
      }
    }
  }
  e4t::wgmma_wait<0>();
  e4t::fence_regs(acc);
  e4t::fence_regs(af);

  // accumulator i of n8 block jb: row 16 wi + g (+ 8 for i & 2) of the
  // warpgroup's 64, column 8 jb + 2 t4 (+ 1 for i & 1)
  const int g = lane >> 2, t4 = lane & 3;
  if (a.ws != nullptr) {
    // split: exact int32 partial sums into the workspace; the epilogue
    // kernel rescales after the last part
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pm = wg * 64 + wi * 16 + g + 8 * half;
      const int tn = pm / tpix, th = (pm - tn * tpix) / a.tw, tw = pm % a.tw;
      const int n = n0 + tn, ho = ho0 + th, wo = wo0 + tw;
      if (n >= a.n || ho >= a.ho || wo >= a.wo) continue;
      int* row = a.ws + (((size_t)n * a.ho + ho) * a.wo + wo) * a.o;
#pragma unroll
      for (int jb = 0; jb < kWN / 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int oc = o0 + 8 * jb + 2 * t4 + e;
          if (oc < a.o) atomicAdd(row + oc, acc[4 * jb + 2 * half + e]);
        }
    }
    return;
  }

  // rescale into a shared [channel][pixel] tile, then NCHW stores
  __syncthreads();  // every warp is done with the ring and the halo
  constexpr int kPitch = kWM + 16 / (int)sizeof(T);
  T* stage = reinterpret_cast<T*>(smem);
  const T* bias = static_cast<const T*>(a.bias);
#pragma unroll
  for (int jb = 0; jb < kWN / 8; ++jb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * jb + 2 * t4 + e, oc = o0 + col;
      if (oc >= a.o) continue;
      const float f = a.act_mul ? __fmul_rn(a.act_mul[0], a.wscale[oc]) : a.wscale[oc];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // _rn intrinsics: no fused multiply-add, so each step rounds as the
        // plain version's separate multiply and add do
        T y = from_float<T>(__fmul_rn((float)acc[4 * jb + 2 * half + e], f));
        if (bias != nullptr) y = from_float<T>(__fadd_rn(to_float(y), to_float(bias[oc])));
        stage[col * kPitch + wg * 64 + wi * 16 + g + 8 * half] = y;
      }
    }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  const size_t hw_out = (size_t)a.ho * a.wo;
  if (a.vec_store) {
    constexpr int kVec = 16 / (int)sizeof(T);
    for (int i = tid; i < kWN * kWM / kVec; i += kWThreads) {
      const int col = i / (kWM / kVec), pm = (i - col * (kWM / kVec)) * kVec;
      const int tn = pm / tpix, th = (pm - tn * tpix) / a.tw, tw = pm % a.tw;
      const int oc = o0 + col, n = n0 + tn, ho = ho0 + th, wo = wo0 + tw;
      if (oc < a.o && n < a.n && ho < a.ho)
        *reinterpret_cast<uint4*>(out + ((size_t)n * a.o + oc) * hw_out + (size_t)ho * a.wo +
                                  wo) = *reinterpret_cast<const uint4*>(&stage[col * kPitch + pm]);
    }
  } else {
    for (int i = tid; i < kWN * kWM; i += kWThreads) {
      const int col = i / kWM, pm = i - col * kWM;
      const int tn = pm / tpix, th = (pm - tn * tpix) / a.tw, tw = pm % a.tw;
      const int oc = o0 + col, n = n0 + tn, ho = ho0 + th, wo = wo0 + tw;
      if (oc < a.o && n < a.n && ho < a.ho && wo < a.wo)
        out[((size_t)n * a.o + oc) * hw_out + (size_t)ho * a.wo + wo] = stage[col * kPitch + pm];
    }
  }
}

// After a split: the exact int32 sums (n * ho * wo, o) rescaled into NCHW,
// through a 32 x 32 shared tile (reads along o, writes along the pixels).
template <typename T>
__global__ void __launch_bounds__(256) int8_conv_split_epilogue_kernel(const ConvArgs a) {
  __shared__ int tile[32][33];
  const int m_all = a.n * a.ho * a.wo;
  const int m0 = blockIdx.x * 32, oc0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8) {
    const int mm = m0 + r, oc = oc0 + tx;
    tile[r][tx] = mm < m_all && oc < a.o ? a.ws[(size_t)mm * a.o + oc] : 0;
  }
  __syncthreads();
  const T* bias = static_cast<const T*>(a.bias);
  T* out = static_cast<T*>(a.out);
  const int hw_out = a.ho * a.wo;
  for (int r = ty; r < 32; r += 8) {
    const int oc = oc0 + r, mm = m0 + tx;
    if (oc >= a.o || mm >= m_all) continue;
    const float f = a.act_mul ? __fmul_rn(a.act_mul[0], a.wscale[oc]) : a.wscale[oc];
    T y = from_float<T>(__fmul_rn((float)tile[tx][r], f));
    if (bias != nullptr) y = from_float<T>(__fadd_rn(to_float(y), to_float(bias[oc])));
    const int n = mm / hw_out;
    out[((size_t)n * a.o + oc) * hw_out + (mm - n * hw_out)] = y;
  }
}

int next_pow2(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

// The tiling of a launch: output tiles of tw columns (a power of two from 8
// to 64), th rows and tn images, 128 pixels in all; the halo they read;
// channel chunks of 64 shared among `splits` parts; the halo buffers of the
// ring (a chunk's halo lands with its first step, kStages - 1 steps ahead,
// so 1x1 convs need more than two); staged x's row alignment.
void plan(ConvArgs& a, int splits, int x_bytes, bool nhwc) {
  a.tw = std::min(64, next_pow2(std::max(a.wo, 8)));
  a.th = std::min(kWM / a.tw, next_pow2(a.ho));
  a.tn = kWM / (a.tw * a.th);
  a.hh = (a.th - 1) * a.stride + a.kh;
  a.hw = (a.tw - 1) * a.stride + a.kw;
  a.hpix = a.tn * a.hh * a.hw;
  a.tiles_w = (a.wo + a.tw - 1) / a.tw;
  a.tiles_h = (a.ho + a.th - 1) / a.th;
  a.tiles_n = (a.n + a.tn - 1) / a.tn;
  a.n_chunks = (a.c + kKC - 1) / kKC;
  a.chunks_per_split = (a.n_chunks + splits - 1) / splits;
  const int taps = a.kh * a.kw;
  a.halo_bufs = x_bytes == 1 ? 1 + (kStages - 2 + taps) / taps : 2;
  const int v = 16 / x_bytes;
  // every tile's first input column is -pad modulo 16 bytes (tw >= 8)
  a.lead = ((-a.pad) % v + v) % v;
  a.rowlen = (a.lead + a.hw + v - 1) / v * v;
  a.raw_bytes = x_bytes == 1 ? 0
                : nhwc   ? a.hpix * kKC * x_bytes
                         : kKC * a.tn * a.hh * a.rowlen * x_bytes;
}

template <class Loader>
size_t wgmma_smem_bytes(const ConvArgs& a, int out_bytes) {
  const size_t pipe = (size_t)kStages * kBTile + (size_t)a.halo_bufs * kPlanes * a.hpix * 16 +
                      (Loader::kFill == Fill::kStaged ? (size_t)a.raw_bytes : 0);
  const size_t stage = (size_t)kWN * (kWM + 16 / out_bytes) * out_bytes;
  return std::max(pipe, stage);
}

template <typename T, class Loader>
int launch_wgmma(ConvArgs a, size_t smem, cudaStream_t stream) {
  a.vec_store = a.wo % a.tw == 0 && (a.tw * (int)sizeof(T)) % 16 == 0;
  const long long tiles = (long long)a.tiles_w * a.tiles_h * a.tiles_n;
  const int parts = (a.n_chunks + a.chunks_per_split - 1) / a.chunks_per_split;
  if (smem > e4t::kMaxSmem || tiles > 0x7fffffffLL || (a.o + kWN - 1) / kWN > 65535)
    return (int)cudaErrorInvalidValue;
  auto kernel = int8_conv_wgmma_kernel<T, Loader>;
  cudaError_t err = e4t::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)tiles, (a.o + kWN - 1) / kWN, parts), kWThreads, smem, stream>>>(a);
  if (a.ws != nullptr) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int m_all = a.n * a.ho * a.wo;
    int8_conv_split_epilogue_kernel<T>
        <<<dim3((m_all + 31) / 32, (a.o + 31) / 32), 256, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// x of type XT quantized in the loads: staged where x's rows are 16-byte
// aligned and the staging fits in shared memory, else direct
template <typename XT, bool kNhwc>
int launch_act(ConvArgs& a, int splits, cudaStream_t stream) {
  using Staged = LoadQuant<XT, kNhwc, Fill::kStaged>;
  using Direct = LoadQuant<XT, kNhwc, Fill::kDirect>;
  plan(a, splits, sizeof(XT), kNhwc);
  const int v = 16 / (int)sizeof(XT);
  const size_t smem = wgmma_smem_bytes<Staged>(a, sizeof(XT));
  if ((kNhwc ? a.c % v == 0 : a.w % v == 0) && smem <= e4t::kMaxSmem)
    return launch_wgmma<XT, Staged>(a, smem, stream);
  return launch_wgmma<XT, Direct>(a, wgmma_smem_bytes<Direct>(a, sizeof(XT)), stream);
}

}  // namespace

namespace {

bool bad_geometry(int n, int h, int w, int c, int o, int kh, int kw, int stride, int pad,
                  int ho, int wo) {
  return n <= 0 || h <= 0 || w <= 0 || c <= 0 || o <= 0 || kh <= 0 || kw <= 0 ||
         stride <= 0 || pad < 0 || ho <= 0 || wo <= 0 ||
         (long long)n * ho * wo > 0x7fffffffLL || (long long)kh * kw * c > 0x7fffffffLL ||
         (long long)n * h * w * c > 0x7fffffffLL || (long long)n * ho * wo * o > 0x7fffffffLL;
}

}  // namespace

// Plain C entry points for ctypes. wt (o, kh, kw, cw) is contiguous int8,
// 16-byte aligned, cw a multiple of 16; bias (o,) in the output type or
// null; out (n, o, ho, wo) contiguous; ws a zeroed int32 (n * ho * wo, o)
// workspace where splits > 1 (the number of parts the channel chunks are
// split into, at most 8), else null. Each runs on ``stream``, allocates
// nothing and does not synchronise, and returns cudaGetLastError() after
// its launches.

// x (n, h, w, c) contiguous int8, 16-byte aligned, c a multiple of 16;
// scale f32 (o,) the whole rescale; out bf16 (out_bf16 != 0) or f32.
extern "C" int e4t_int8_conv(const void* x, const void* wt, const void* scale,
                             const void* bias, void* out, int n, int h, int w, int c,
                             int o, int kh, int kw, int stride, int pad, int ho, int wo,
                             int out_bf16, void* ws, int splits, void* stream) {
  if (bad_geometry(n, h, w, c, o, kh, kw, stride, pad, ho, wo) || c % 16 != 0 ||
      (long long)o * kh * kw * c > 0x7fffffffLL || splits < 1 || splits > kMaxSplits ||
      (splits > 1) != (ws != nullptr))
    return (int)cudaErrorInvalidValue;
  ConvArgs a{};
  a.x = x;
  a.wt = static_cast<const int8_t*>(wt);
  a.wscale = static_cast<const float*>(scale);
  a.bias = bias;
  a.out = out;
  a.ws = static_cast<int*>(ws);
  a.n = n, a.h = h, a.w = w, a.c = c, a.cw = c, a.o = o, a.kh = kh, a.kw = kw;
  a.stride = stride, a.pad = pad, a.ho = ho, a.wo = wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  plan(a, splits, 1, true);
  const size_t smem = wgmma_smem_bytes<LoadS8>(a, out_bf16 ? 2 : 4);
  return out_bf16 ? launch_wgmma<bf16, LoadS8>(a, smem, s)
                  : launch_wgmma<float, LoadS8>(a, smem, s);
}

// x (n, c, h, w) bf16 (x_f32 == 0) or f32, NCHW-contiguous (nhwc == 0) or
// channels-last (nhwc != 0), 16-byte aligned; act f32: the activation scale,
// (c,) where act_per_channel != 0 (its magnitude folded into the weight, so
// the rescale is wscale alone), else (1,) (the rescale is act x wscale);
// wscale f32 (o,); out in x's type; cw >= c (channels c.. of wt zero).
extern "C" int e4t_int8_conv_act(const void* x, int x_f32, int nhwc, const void* wt, int cw,
                                 const void* wscale, const void* act, int act_per_channel,
                                 const void* bias, void* out, int n, int h, int w, int c,
                                 int o, int kh, int kw, int stride, int pad, int ho, int wo,
                                 void* ws, int splits, void* stream) {
  if (bad_geometry(n, h, w, c, o, kh, kw, stride, pad, ho, wo) || cw % 16 != 0 || cw < c ||
      (long long)o * kh * kw * cw > 0x7fffffffLL || splits < 1 || splits > kMaxSplits ||
      (splits > 1) != (ws != nullptr))
    return (int)cudaErrorInvalidValue;
  ConvArgs a{};
  a.x = x;
  a.wt = static_cast<const int8_t*>(wt);
  a.wscale = static_cast<const float*>(wscale);
  a.act = static_cast<const float*>(act);
  a.act_mul = act_per_channel ? nullptr : a.act;
  a.bias = bias;
  a.out = out;
  a.ws = static_cast<int*>(ws);
  a.n = n, a.h = h, a.w = w, a.c = c, a.cw = cw, a.o = o, a.kh = kh, a.kw = kw;
  a.stride = stride, a.pad = pad, a.ho = ho, a.wo = wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return nhwc ? launch_act<float, true>(a, splits, s) : launch_act<float, false>(a, splits, s);
  return nhwc ? launch_act<bf16, true>(a, splits, s) : launch_act<bf16, false>(a, splits, s);
}

// The synchronous mma.sync design (int8 x as e4t_int8_conv; no split),
// kept as the yardstick of the wgmma kernel: bit for bit the same output.
// No path calls it.
extern "C" int e4t_int8_conv_sync(const void* x, const void* wt, const void* scale,
                                  const void* bias, void* out, int n, int h, int w, int c,
                                  int o, int kh, int kw, int stride, int pad, int ho, int wo,
                                  int out_bf16, void* stream) {
  if (bad_geometry(n, h, w, c, o, kh, kw, stride, pad, ho, wo) || c % 16 != 0 ||
      (o + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  const Geometry geo{n, h, w, c, o, kh, kw, stride, pad, ho, wo, kh * kw * c, n * ho * wo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch_sync<bf16>(x, wt, scale, bias, out, geo, s)
                  : launch_sync<float>(x, wt, scale, bias, out, geo, s);
}
