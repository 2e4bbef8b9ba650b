// Building blocks shared by the port's kernels (sm_90a): bf16 mma.sync
// m16n8k16 with f32 accumulators and s8 mma.sync m16n8k16 / m16n8k32 with s32
// accumulators, fragment loads from padded shared tiles, and tile staging
// with zero padding of ragged rows and of the head dim. Included by every
// source in this directory; each of them compiles to its own shared library.
//
// In bytes, an s8 fragment has the bf16 fragment's geometry: thread (g, t4)
// of a warp holds the 4 bytes at byte column 4 * t4 of row g (and g + 8), so
// the same padded shared tiles and 32-bit loads serve both types.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace e4t {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

// d += a (16x16 bf16, row-major) * b (16x8 bf16, column-major), f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x16 s8, row-major) * b (16x8 s8, column-major), s32 accumulate.
__device__ __forceinline__ void mma_s8_16816(int (&d)[4], const uint32_t (&a)[2],
                                             uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// d += a (16x32 s8, row-major) * b (32x8 s8, column-major), s32 accumulate.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 values (each in [-128, 127]) into one register, the first in the
// lowest byte: the element order of an s8 fragment register.
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of the 16x16 block at (row0, col0) of a row-major shared
// tile with `pitch` halves per row; g = lane / 4, t4 = lane % 4.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int pitch,
                                       int row0, int col0, int g, int t4) {
  const bf16* p = s + (row0 + g) * pitch + col0 + t4 * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * pitch);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * pitch + 8);
}

// The B fragment of the 16x8 block whose 8 columns start at n0 and whose 16
// contraction rows start at k0, from a shared tile that holds B transposed
// (one row per column of B, contraction index contiguous).
__device__ __forceinline__ void mma_bt(float (&d)[4], const uint32_t (&a)[4],
                                       const bf16* s, int pitch, int n0, int k0,
                                       int g, int t4) {
  const bf16* p = s + (n0 + g) * pitch + k0 + t4 * 2;
  mma_16816(d, a, ld32(p), ld32(p + 8));
}

// Stage rows [r0, r0 + ROWS) of a contiguous (n, d) bf16 tensor into shared
// memory, zero past row n and column d: all DK columns row-major into `rm`
// (pitch `pitch`, skipped when null), and columns [c0, c1) transposed into
// `tr` (tr[(col - c0) * tpitch + row], skipped when null). d and c0 are
// multiples of 8, so each 16-byte chunk is wholly inside or outside.
template <int ROWS, int DK>
__device__ __forceinline__ void stage_tile(bf16* rm, int pitch, bf16* tr, int tpitch,
                                           int c0, int c1, const bf16* src, int r0,
                                           int n, int d, int tid) {
  constexpr int kChunks = DK / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, col = (i % kChunks) * 8;
    uint4 val = zero;
    if (r0 + r < n && col < d)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + col);
    if (rm != nullptr) *reinterpret_cast<uint4*>(&rm[r * pitch + col]) = val;
    if (tr != nullptr && col >= c0 && col < c1) {
      const bf16* h = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[(col - c0 + j) * tpitch + r] = h[j];
    }
  }
}

// 16-byte asynchronous copy global -> shared (cp.async.cg, through L2 only);
// src_bytes = 0 reads nothing and fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

// 8-byte asynchronous copy global -> shared (cp.async.ca: 8 bytes need only
// 8-byte alignment, as int8 rows of a head dim that is a multiple of 8
// have); src_bytes = 0 reads nothing and writes zeros.
__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

// 4-byte asynchronous copy global -> shared (cp.async.ca: 4 bytes need
// only 4-byte alignment); src_bytes = 0 reads nothing and writes a zero.
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Dynamic shared memory a block may take on sm_90 (of the SM's 228 KB).
constexpr size_t kMaxSmem = 227 * 1024;

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The mma k-depth granularity of the head dim: 16 up to 128, then 32 (the
// kernels are instantiated for 16..128 step 16 and 160..256 step 32).
__host__ __forceinline__ int padded_head_dim(int d) {
  return d <= 128 ? (d + 15) / 16 * 16 : (d + 31) / 32 * 32;
}

}  // namespace e4t

// Plain C error text for the ctypes wrappers; each kernel library carries
// its own copy.
extern "C" const char* e4t_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
