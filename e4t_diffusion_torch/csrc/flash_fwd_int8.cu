// int8 flash-attention forward for Hopper (sm_90a), serving only.
//
// Replaces the TPU kernel _flash_fwd_lowdim_int8 of
// e4t_diffusion_tpu/ops/flash_kernels.py (pallas_call at :822). Same
// contract: q (BH, Sq, D) and k (BH, Sk, D) are int8, quantized per head
// outside the kernel (k mean-centred first); sc (BH, 2) f32 holds per head
// qk_c = q_scale * k_scale * softmax_scale and v_c. Scores are the int32
// product q k^T times qk_c; the softmax is online in f32. P@V runs
//   - "qk" mode: in bf16 on a bf16 v (BH, Sk, D), p rounded to bf16, v_c = 1;
//   - "qkpv" mode: in int8 on an int8 v, with p quantized to round(p * 127)
//     against the running max of the kv tiles seen so far, the s32 product
//     added to the f32 accumulator per tile, and v_c = v_scale / 127.
// The row sum l adds the unquantized f32 p in both modes, as on the TPU. The
// quantized p, and so the result in "qkpv" mode, depends on the kv tile: the
// kernel takes the reference's tile (block_k, the route's
// min(E4T_FLASH_BLOCK_K, round_up(Sk, 128)), a multiple of 64) and runs each
// such quant tile in two passes over its 64-row sub-tiles: (a) the s8
// products and the row max alone, no exponentials; (b) p against that max,
// quantized, P@V into an int32 accumulator that is added to the f32 one
// once per quant tile, as the reference adds its tile's product. "qk" keeps
// 64-row online tiles: its p is not quantized, so the tile moves its result
// by f32 and bf16 rounding only. Returns out (BH, Sq, D) = acc / l * v_c, in bf16
// (in f32 too in "qkpv" mode, for an f32 compute type) and lse = m + log(l)
// (BH, Sq) f32.
//
// What bounds it on the H100: at the UNet's 4096-token d=40 sites (BH=64)
// the Sq*Sk exponentials per head take ~0.257 ms at 16 exp2/clk/SM, against
// ~0.07 ms of int8 QK^T on the tensor cores and ~0.09 ms of bf16 P@V ("qk");
// memory is ~0.02 ms. So int8 products leave the bound where the bf16 kernel
// has it: the special-function unit, which also runs the I2F and F2I
// conversions; so the kernel converts none a score (i2f_exact, round_u8).
//
// The design (flash_fwd_int8_wgmma_kernel) is that of the bf16 wgmma
// forward in flash_fwd_lowdim.cu: q resident; a cp.async ring of k (and v)
// tiles, 8-byte copies for the int8 rows; 4 warpgroups of 64 q rows a block
// (2 from DK 64 in "qkpv", 96 in "qk") sharing each tile; S by s8 wgmma
// m64n64k32 with both operands in shared memory, K-major as 8-bit wgmma
// requires, D padded to 32 there (40 -> 64); the scores exact in int32 in
// registers, the max taken on them; p = 2^(s qk_c log2 e - m) by one fma
// and ex2.approx. "qk": P V by bf16 wgmma with p from registers and v read
// MN-major. "qkpv": one walk step per k sub-tile in pass a, one per k/v
// sub-tile in pass b; P V by s8 wgmma m64nDk32 with p quantized in
// registers and v^T, which the block builds from the staged row-major tile
// while the step's S runs. Measured (time_attn_small.py, PERF.md):
// 4096²/d40 "qk" 0.99-1.04 ms, "qkpv" 1.68-1.69, against the synchronous
// design's 1.85 / 2.21; without the k/v loads after the first ones "qk"
// runs 21% faster and "qkpv" 28%, without exponentials 19% and 10%,
// with S or P V cut to one k-step 3-10%: the loads, not the
// special-function unit, come first, and "qkpv" loads each k tile twice.
// Outputs are within rel-L2 1e-4 of the synchronous design's, not bit for
// bit: ex2.approx and the fused scale-and-subtract round p apart from its
// exp2f, which moves a few round(p * 127) by one.
//
// The synchronous design (flash_fwd_int8_kernel, which served before): one
// block of 4 warps per 64-row q tile, mma.sync (s8 m16n8k16 for QK^T, bf16
// m16n8k16 or s8 m16n8k32 for P@V), k and v staged through registers. P@V
// in int8 needs p as the A operand of m16n8k32 (and of wgmma's s8 k32),
// whose thread t4 holds kv columns 4*t4..4*t4+3 of each 16; the score
// accumulator gives the thread columns {2*t4, 2*t4+1, 8+2*t4, 9+2*t4}. The
// contraction order is free, so v is staged transposed with its kv index
// permuted within each 16 to match (kv_slot below); p never leaves
// registers. No path launches it: it is exported as e4t_flash_fwd_int8_sync,
// the yardstick chip_smoke.py times the kernel against.

#include <limits.h>
#include <math.h>

#include "flash_common.cuh"
#include "wgmma_common.cuh"

namespace {

using e4t::bf16;
using e4t::core_offset;
using e4t::exp2_approx;
using e4t::fence_proxy_async;
using e4t::fence_regs;
using e4t::kThreads;
using e4t::smem_desc;
using e4t::wgmma_commit;
using e4t::wgmma_fence;
using e4t::wgmma_wait;

constexpr int kBlockM = 64;  // q rows per block: 4 warps x 16
constexpr int kBlockN = 64;  // kv rows per tile

// int8 row pitch in bytes: = 16 mod 32, so the 8 row groups of a fragment
// load fall in distinct banks
template <int DK>
__host__ __device__ constexpr int pitch8() { return (DK + 31) / 32 * 32 + 16; }

constexpr int kVt8Pitch = kBlockN + 16;  // transposed int8 v tile
constexpr int kVtPitch = kBlockN + 8;    // transposed bf16 v tile, in halves

template <int DK, bool kPvInt8>
constexpr size_t smem_bytes() {
  return (size_t)kBlockN * pitch8<DK>() +
         (kPvInt8 ? (size_t)DK * kVt8Pitch : sizeof(bf16) * DK * kVtPitch);
}

// The slot of kv row j (within a tile) in the transposed int8 v tile: within
// each 16, column c of the score accumulator's layout goes to the byte the
// s8 A fragment expects there.
__device__ __forceinline__ int kv_slot(int j) {
  const int w = j & 15;
  return (j & ~15) + 4 * ((w & 7) >> 1) + 2 * (w >> 3) + (w & 1);
}

// Stage rows [r0, r0 + ROWS) of a contiguous (n, d) int8 tensor, d a
// multiple of 8, into a row-major shared tile of DK columns, zero past row n
// and column d.
template <int ROWS, int DK>
__device__ __forceinline__ void stage_s8(int8_t* dst, const int8_t* src, int r0, int n,
                                         int d, int tid) {
  constexpr int kChunks = DK / 8;
  for (int i = tid; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, col = (i % kChunks) * 8;
    uint2 val = make_uint2(0u, 0u);
    if (r0 + r < n && col < d)
      val = *reinterpret_cast<const uint2*>(src + (size_t)(r0 + r) * d + col);
    *reinterpret_cast<uint2*>(&dst[r * pitch8<DK>() + col]) = val;
  }
}

// Stage kv rows [r0, r0 + kBlockN) of an int8 (n, d) v transposed:
// dst[col * kVt8Pitch + kv_slot(row)], zero past row n and column d.
template <int DK>
__device__ __forceinline__ void stage_vt_s8(int8_t* dst, const int8_t* src, int r0, int n,
                                            int d, int tid) {
  constexpr int kChunks = DK / 8;
  for (int i = tid; i < kBlockN * kChunks; i += kThreads) {
    const int r = i / kChunks, col = (i % kChunks) * 8;
    uint2 val = make_uint2(0u, 0u);
    if (r0 + r < n && col < d)
      val = *reinterpret_cast<const uint2*>(src + (size_t)(r0 + r) * d + col);
    const int8_t* b = reinterpret_cast<const int8_t*>(&val);
    const int slot = kv_slot(r);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(col + j) * kVt8Pitch + slot] = b[j];
  }
}

// two output columns of a row: bf16 pairs, or f32 pairs (OutT = float)
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = e4t::pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The warp's 16 x 64 score tile at kv row kv0 (int32 q k^T of q fragments
// in registers and a staged k tile, times qk_c log2 e; columns >= sk -inf).
template <int DK>
__device__ __forceinline__ void tile_scores(float (&s)[kBlockN / 8][4],
                                            const uint32_t (&qf)[DK / 16][2],
                                            const int8_t* k_s, int kv0, int sk,
                                            float qk_log2, int g, int t4) {
  constexpr int kP = pitch8<DK>();
  int si[kBlockN / 8][4];
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) si[n][0] = si[n][1] = si[n][2] = si[n][3] = 0;
#pragma unroll
  for (int st = 0; st < DK / 16; ++st) {
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
      e4t::mma_s8_16816(si[n], qf[st], e4t::ld32(k_s + (n * 8 + g) * kP + st * 16 + t4 * 4));
  }
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool valid = kv0 + n * 8 + t4 * 2 + e < sk;
      s[n][e] = valid ? (float)si[n][e] * qk_log2 : -INFINITY;
      s[n][2 + e] = valid ? (float)si[n][2 + e] * qk_log2 : -INFINITY;
    }
  }
}

// mx0 / mx1: the running maxima of the thread's rows g and g + 8, taken over
// s (reduced across the row's four threads in rescale)
__device__ __forceinline__ void row_max(const float (&s)[kBlockN / 8][4], float& mx0,
                                        float& mx1) {
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
    mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
  }
}

// The rows' new max from the threads' maxima mx0 / mx1 (each tile holds at
// least one valid column, so it is finite and the first tile's alpha is
// exp2(-inf) = 0), and l and o rescaled to it.
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N][4], float& m0, float& m1, float& l0,
                                        float& l1, float mx0, float mx1) {
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  l0 *= alpha0;
  l1 *= alpha1;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    o[n][0] *= alpha0;
    o[n][1] *= alpha0;
    o[n][2] *= alpha1;
    o[n][3] *= alpha1;
  }
}

template <int DK, bool kPvInt8, typename OutT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                      const void* __restrict__ v, const float* __restrict__ sc,
                      OutT* __restrict__ out, float* __restrict__ lse, int sq, int sk,
                      int d, int block_k) {
  constexpr int kP = pitch8<DK>();
  constexpr int kSteps = DK / 16;  // s8 m16n8k16 steps over the head dim
  constexpr int kScoreTiles = kBlockN / 8;
  constexpr int kOutTiles = DK / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* k_s = reinterpret_cast<int8_t*>(smem_raw);  // kBlockN x kP; q first
  unsigned char* v_raw = smem_raw + (size_t)kBlockN * kP;
  int8_t* vt8_s = reinterpret_cast<int8_t*>(v_raw);  // DK x kVt8Pitch (qkpv)
  bf16* vt_s = reinterpret_cast<bf16*>(v_raw);        // DK x kVtPitch (qk)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int qr = warp * 16;

  const float qk_log2 = sc[2 * bh] * e4t::kLog2e;
  const float v_c = sc[2 * bh + 1];
  const int8_t* kb = k + (size_t)bh * sk * d;

  // the q tile goes through the k buffer into registers
  stage_s8<kBlockM, DK>(k_s, q + (size_t)bh * sq * d, q0, sq, d, tid);
  __syncthreads();
  uint32_t qf[kSteps][2];
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const int8_t* p = k_s + (qr + g) * kP + st * 16 + t4 * 4;
    qf[st][0] = e4t::ld32(p);
    qf[st][1] = e4t::ld32(p + 8 * kP);
  }

  float o[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // "qkpv": quant tiles of block_k kv rows (a multiple of kBlockN), each
  // in two passes over its sub-tiles: (a) the s8 products and the row max
  // only, (b) p against that max, quantized, and P@V into an int32
  // accumulator added once per quant tile. "qk": online 64-row tiles.
  const int quant = kPvInt8 ? block_k : kBlockN;
  for (int t0 = 0; t0 < sk; t0 += quant) {
    const int t1 = min(t0 + quant, sk);
    float mx0 = m0, mx1 = m1;
    if constexpr (kPvInt8) {
      for (int kv0 = t0; kv0 < t1; kv0 += kBlockN) {
        __syncthreads();  // every warp is done with the previous tile (or q)
        stage_s8<kBlockN, DK>(k_s, kb, kv0, sk, d, tid);
        __syncthreads();
        float s[kScoreTiles][4];
        tile_scores<DK>(s, qf, k_s, kv0, sk, qk_log2, g, t4);
        row_max(s, mx0, mx1);
      }
      rescale(o, m0, m1, l0, l1, mx0, mx1);
    }
    int ci[kPvInt8 ? kOutTiles : 1][4];
#pragma unroll
    for (int n = 0; n < (kPvInt8 ? kOutTiles : 1); ++n)
      ci[n][0] = ci[n][1] = ci[n][2] = ci[n][3] = 0;
    for (int kv0 = t0; kv0 < t1; kv0 += kBlockN) {
      __syncthreads();  // every warp is done with the previous tile (or q)
      stage_s8<kBlockN, DK>(k_s, kb, kv0, sk, d, tid);
      if constexpr (kPvInt8) {
        stage_vt_s8<DK>(vt8_s, static_cast<const int8_t*>(v) + (size_t)bh * sk * d, kv0,
                        sk, d, tid);
      } else {
        e4t::stage_tile<kBlockN, DK>(nullptr, 0, vt_s, kVtPitch, 0, DK,
                                     static_cast<const bf16*>(v) + (size_t)bh * sk * d,
                                     kv0, sk, d, tid);
      }
      __syncthreads();

      float s[kScoreTiles][4];
      tile_scores<DK>(s, qf, k_s, kv0, sk, qk_log2, g, t4);
      if constexpr (!kPvInt8) {
        row_max(s, mx0, mx1);
        rescale(o, m0, m1, l0, l1, mx0, mx1);
      }

      if constexpr (kPvInt8) {
        // p quantized to round(p * 127) in [0, 127]; pq[n] pairs as in s
        int pq[kScoreTiles][4];
#pragma unroll
        for (int n = 0; n < kScoreTiles; ++n) {
          const float p00 = exp2f(s[n][0] - m0), p01 = exp2f(s[n][1] - m0);
          const float p10 = exp2f(s[n][2] - m1), p11 = exp2f(s[n][3] - m1);
          l0 += p00 + p01;
          l1 += p10 + p11;
          pq[n][0] = __float2int_rn(p00 * 127.f);
          pq[n][1] = __float2int_rn(p01 * 127.f);
          pq[n][2] = __float2int_rn(p10 * 127.f);
          pq[n][3] = __float2int_rn(p11 * 127.f);
        }
#pragma unroll
        for (int h = 0; h < kBlockN / 32; ++h) {
          // k32 step h covers score tiles 4h..4h+3: 16-column chunks 2h, 2h+1
          uint32_t a[4];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int n = 4 * h + 2 * c;
            a[2 * c] = e4t::pack_s8(pq[n][0], pq[n][1], pq[n + 1][0], pq[n + 1][1]);
            a[2 * c + 1] = e4t::pack_s8(pq[n][2], pq[n][3], pq[n + 1][2], pq[n + 1][3]);
          }
#pragma unroll
          for (int n = 0; n < kOutTiles; ++n) {
            const int8_t* p = vt8_s + (n * 8 + g) * kVt8Pitch + h * 32 + t4 * 4;
            e4t::mma_s8_16832(ci[n], a, e4t::ld32(p), e4t::ld32(p + 16));
          }
        }
      } else {
        // p in the accumulator layout is already the A-fragment layout of the
        // bf16 P@V product: score tiles 2j and 2j+1 form k-step j
        uint32_t pa[kScoreTiles / 2][4];
#pragma unroll
        for (int n = 0; n < kScoreTiles; ++n) {
          const float p00 = exp2f(s[n][0] - m0), p01 = exp2f(s[n][1] - m0);
          const float p10 = exp2f(s[n][2] - m1), p11 = exp2f(s[n][3] - m1);
          l0 += p00 + p01;
          l1 += p10 + p11;
          pa[n >> 1][(n & 1) * 2 + 0] = e4t::pack_bf16(p00, p01);
          pa[n >> 1][(n & 1) * 2 + 1] = e4t::pack_bf16(p10, p11);
        }
#pragma unroll
        for (int j = 0; j < kScoreTiles / 2; ++j) {
#pragma unroll
          for (int n = 0; n < kOutTiles; ++n)
            e4t::mma_bt(o[n], pa[j], vt_s, kVtPitch, n * 8, j * 16, g, t4);
        }
      }
    }
    if constexpr (kPvInt8) {
      // the quant tile's exact int32 sums, added once as the reference adds
      // its tile's product: acc = acc * alpha + contrib
#pragma unroll
      for (int n = 0; n < kOutTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] += (float)ci[n][e];
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float f0 = (l0 > 0.f ? 1.f / l0 : 0.f) * v_c;
  const float f1 = (l1 > 0.f ? 1.f / l1 : 0.f) * v_c;
  const int row0 = q0 + qr + g, row1 = row0 + 8;
  OutT* ob = out + (size_t)bh * sq * d;
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) {
    const int col = n * 8 + t4 * 2;
    if (col < d) {
      if (row0 < sq) store2(&ob[(size_t)row0 * d + col], o[n][0] * f0, o[n][1] * f0);
      if (row1 < sq) store2(&ob[(size_t)row1 * d + col], o[n][2] * f1, o[n][3] * f1);
    }
  }
  if (t4 == 0) {
    const float ln2 = 0.693147180559945309f;
    if (row0 < sq) lse[(size_t)bh * sq + row0] = (m0 + log2f(fmaxf(l0, 1e-37f))) * ln2;
    if (row1 < sq) lse[(size_t)bh * sq + row1] = (m1 + log2f(fmaxf(l1, 1e-37f))) * ln2;
  }
}

// ---- warpgroup MMA (wgmma) fed by a cp.async ring ----

// d (64 x 64, s32) = a (64 x 32) b (32 x 64), plus d where accumulate != 0;
// a and b K-major s8 tiles in shared memory, given by descriptors
__device__ __forceinline__ void wgmma_s8_ss_n64(int (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x N, s32) += a (64 x 32 s8: each warp of the warpgroup holds the
// mma.m16n8k32 A fragment of its 16 rows) b (32 x N); b a K-major s8 tile in
// shared memory (8-bit operands have no transposed form), given by a
// descriptor
template <int N>
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_s8_rs<16>(int (&d)[8], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<32>(int (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<48>(int (&d)[24], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<64>(int (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<80>(int (&d)[40], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<96>(int (&d)[48], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<112>(int (&d)[56], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<128>(int (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
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
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Exact int32 -> f32 for |x| < 2^22 by one integer and one f32 add (a
// score's |q k^T| <= 127^2 x 128 is far below), where I2F would run at the
// conversion units' 16 a clock an SM, the rate of the exponentials that
// bound the kernel.
__device__ __forceinline__ float i2f_exact(int x) {
  return __int_as_float(x + 0x4B400000) - 12582912.f;
}

// round(x) (to nearest even, as __float2int_rn) in the low byte for x in
// [0, 255], by one f32 add: 1.5 x 2^23 + x has a unit ulp
__device__ __forceinline__ int round_u8(float x) { return __float_as_int(x + 12582912.f); }

// warpgroups per block, 64 q rows each, sharing each k/v tile: 4 where 128
// registers a thread hold the accumulators (to DK 80 in "qk"; to DK 48 in
// "qkpv", which keeps an int32 P V accumulator beside the f32 one), else 2
template <int DK, bool kPvInt8>
__host__ __device__ constexpr int wgmma_groups() { return DK <= (kPvInt8 ? 48 : 80) ? 4 : 2; }

constexpr int kStages = 4;  // k/v ring: tiles j + 1 .. j + 3 in flight

// q/k bytes a row in shared memory: the head dim padded to the s8 k-depth
template <int DK>
__host__ __device__ constexpr int qk_bytes() { return (DK + 31) / 32 * 32; }

// "qkpv" stages v row-major (pitch DK + 16 bytes) for the transpose
template <int DK>
__host__ __device__ constexpr int v8_pitch() { return DK + 16; }

template <int DK, bool kPvInt8>
__host__ __device__ constexpr int v_tile_bytes() {
  return kPvInt8 ? kBlockN * v8_pitch<DK>() : kBlockN * DK * 2;
}

template <int DK, bool kPvInt8>
__host__ __device__ constexpr size_t wgmma_smem_bytes() {
  return (size_t)64 * wgmma_groups<DK, kPvInt8>() * qk_bytes<DK>() +
         (size_t)kStages * (kBlockN * qk_bytes<DK>() + v_tile_bytes<DK, kPvInt8>()) +
         (kPvInt8 ? (size_t)DK * kBlockN : 0);
}

// Rows [r0, r0 + ROWS) of a contiguous (n, d) int8 tensor by 8-byte
// cp.async, shared by THREADS threads, into a core-matrix tile of KB bytes
// a row (core) or a row-major tile of pitch KB (!core); pieces past row n or
// column d read nothing and are filled with zeros.
template <int ROWS, int KB, int THREADS, bool kCore>
__device__ __forceinline__ void load_s8_async(unsigned char* dst, const int8_t* src, int r0,
                                              int n, int d, int tid) {
  constexpr int kP = KB / 8;
  for (int i = tid; i < ROWS * kP; i += THREADS) {
    const int r = i / kP, p = i - r * kP;
    const bool in = r0 + r < n && 8 * p < d;
    unsigned char* to = kCore ? dst + core_offset(r, p >> 1, KB / 16) + 8 * (p & 1)
                              : dst + r * KB + 8 * p;
    e4t::cp_async_8(to, in ? src + (size_t)(r0 + r) * d + 8 * p : src, in ? 8 : 0);
  }
}

// The row-major int8 v tile (64 kv rows, pitch v8_pitch) into v^T in the
// core-matrix layout of a K-major s8 B operand (DK rows of d, 64 kv bytes:
// 4 chunks of 16), kv permuted within each 16 by kv_slot: slots 4w..4w+3 of
// chunk c hold kv rows 16c + {2w, 2w+1, 2w+8, 2w+9}.
template <int DK, int THREADS>
__device__ __forceinline__ void transpose_v8(unsigned char* vt, const unsigned char* vst,
                                             int tid) {
  constexpr int kP = v8_pitch<DK>();
  for (int i = tid; i < DK * 16; i += THREADS) {
    const int dr = i % DK, c = (i / DK) >> 2, w = (i / DK) & 3;
    const unsigned char* col = vst + (16 * c + 2 * w) * kP + dr;
    const uint32_t word = (uint32_t)col[0] | ((uint32_t)col[kP] << 8) |
                          ((uint32_t)col[8 * kP] << 16) | ((uint32_t)col[9 * kP] << 24);
    *reinterpret_cast<uint32_t*>(vt + core_offset(dr, c, 4) + 4 * w) = word;
  }
}

// One step of the kv walk: the 64 kv rows at kv0, in pass a ("qkpv": the
// row max only) or pass b (p and P V); first / last: the step's place among
// its quant tile's sub-tiles in its pass.
struct Step {
  int kv0;
  bool pass_a, first, last;
};

// Step j of the walk: "qkpv" runs each quant tile of `quant` rows (the last
// one ragged, n_last sub-tiles) as pass a over its sub-tiles, then pass b;
// "qk" (passes = 1, quant = 64) one online step a tile.
__device__ __forceinline__ Step step_at(int j, int quant, int n_full, int n_last,
                                        int passes) {
  const int n_sub = quant / kBlockN, per_full = passes * n_sub;
  int qt = n_full, rem = j - n_full * per_full, n = n_last;
  if (j < n_full * per_full) {
    qt = j / per_full;
    rem = j - qt * per_full;
    n = n_sub;
  }
  const bool pass_a = passes == 2 && rem < n;
  const int sub = pass_a || passes == 1 ? rem : rem - n;
  return {qt * quant + sub * kBlockN, pass_a, sub == 0, sub == n - 1};
}

// Per step each warpgroup issues S = Q K^T (s8 SS, exact int32), takes the
// max or the softmax in registers and issues P V: bf16 RS on a row-major v
// read MN-major ("qk"), or s8 RS on v^T ("qkpv"), which the block builds
// from the staged tile before the products wait; one block barrier a step
// frees the stage of step j - 1 for step j - 1 + kStages.
template <int DK, bool kPvInt8, typename OutT>
__global__ void __launch_bounds__(128 * wgmma_groups<DK, kPvInt8>())
flash_fwd_int8_wgmma_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                            const void* __restrict__ v, const float* __restrict__ sc,
                            OutT* __restrict__ out, float* __restrict__ lse, int sq,
                            int sk, int d, int block_k) {
  constexpr int kThreadsW = 128 * wgmma_groups<DK, kPvInt8>();
  constexpr int kBM = 64 * wgmma_groups<DK, kPvInt8>();
  constexpr int kQB = qk_bytes<DK>();
  constexpr int kGroupQ = kQB / 16 * 128;     // bytes of 8 q/k rows
  constexpr int kGroupV = DK / 8 * 128;       // bytes of 8 bf16 v rows ("qk")
  constexpr int kKTile = kBlockN * kQB;
  constexpr int kVTile = v_tile_bytes<DK, kPvInt8>();
  constexpr int kOut = DK / 2;                // accumulators a thread

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_s = smem_raw;
  unsigned char* k_s = q_s + kBM * kQB;
  unsigned char* v_s = k_s + kStages * kKTile;
  unsigned char* vt_s = v_s + kStages * kVTile;  // "qkpv": v^T of the step

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wi = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const float qk_log2 = sc[2 * bh] * e4t::kLog2e;
  const float v_c = sc[2 * bh + 1];
  const int8_t* kb = k + (size_t)bh * sk * d;
  const int8_t* vb8 = static_cast<const int8_t*>(v) + (size_t)bh * sk * d;
  const bf16* vb16 = static_cast<const bf16*>(v) + (size_t)bh * sk * d;

  const int quant = kPvInt8 ? block_k : kBlockN;
  const int passes = kPvInt8 ? 2 : 1;
  const int n_full = sk / quant;
  const int n_last = (sk - n_full * quant + kBlockN - 1) / kBlockN;
  const int n_steps = passes * (n_full * (quant / kBlockN) + n_last);

  auto load_step = [&](int j) {
    const Step st = step_at(j, quant, n_full, n_last, passes);
    const int stage = j % kStages;
    load_s8_async<kBlockN, kQB, kThreadsW, true>(k_s + stage * kKTile, kb, st.kv0, sk, d,
                                                 tid);
    if (!st.pass_a) {
      if constexpr (kPvInt8)
        load_s8_async<kBlockN, v8_pitch<DK>(), kThreadsW, false>(v_s + stage * kVTile, vb8,
                                                                 st.kv0, sk, d, tid);
      else
        e4t::load_core_async<kBlockN, DK, kThreadsW>(v_s + stage * kVTile, vb16, st.kv0,
                                                     sk, d, tid);
    }
  };

  // prologue: q, then steps 0 .. kStages - 2, one group each
  load_s8_async<kBM, kQB, kThreadsW, true>(q_s, q + (size_t)bh * sq * d, q0, sq, d, tid);
  e4t::cp_async_commit();
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_steps) load_step(t);
    e4t::cp_async_commit();
  }
  e4t::cp_async_wait<kStages - 2>();  // q and step 0 have landed
  fence_proxy_async();
  __syncthreads();

  const unsigned char* q_wg = q_s + wg * 8 * kGroupQ;  // the warpgroup's 64 rows
  float o[kOut];
  int ci[kPvInt8 ? kOut : 1];
#pragma unroll
  for (int i = 0; i < kOut; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kPvInt8 ? kOut : 1); ++i) ci[i] = 0;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float mx0 = -INFINITY, mx1 = -INFINITY;

  for (int j = 0; j < n_steps; ++j) {
    if (j + kStages - 1 < n_steps) load_step(j + kStages - 1);
    e4t::cp_async_commit();  // possibly empty: the group count stays uniform
    const Step st = step_at(j, quant, n_full, n_last, passes);
    const unsigned char* ks = k_s + (j % kStages) * kKTile;
    const unsigned char* vs = v_s + (j % kStages) * kVTile;

    // S = Q K^T, exact in int32; si[4n + e]: rows g (e < 2) and g + 8 of
    // the warp's 16, column 8n + 2 t4 + (e & 1)
    int si[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) si[i] = 0;
    fence_regs(si);
    wgmma_fence();
#pragma unroll
    for (int kst = 0; kst < kQB / 32; ++kst)
      wgmma_s8_ss_n64(si, smem_desc(q_wg + kst * 256, 128, kGroupQ),
                      smem_desc(ks + kst * 256, 128, kGroupQ), kst);
    wgmma_commit();
    if constexpr (kPvInt8) {
      if (!st.pass_a) {  // v^T of this step, while the products run
        transpose_v8<DK, kThreadsW>(vt_s, vs, tid);
        fence_proxy_async();
        __syncthreads();
      }
    }
    wgmma_wait<0>();
    fence_regs(si);

    // columns at and beyond sk are masked (only the last tile is ragged)
    const bool ragged = st.kv0 + kBlockN > sk;
    auto valid = [&](int i) { return !ragged || st.kv0 + (i >> 2) * 8 + t4 * 2 + (i & 1) < sk; };
    if (st.pass_a || !kPvInt8) {
      // the rows' max in int32: the scale is positive, so the max of the
      // scaled scores is the scaled max, one conversion a row
      int im0 = INT_MIN, im1 = INT_MIN;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (!valid(i)) continue;
        if (i & 2) im1 = max(im1, si[i]);
        else im0 = max(im0, si[i]);
      }
      if (st.first) {
        mx0 = m0;
        mx1 = m1;
      }
      if (im0 != INT_MIN) mx0 = fmaxf(mx0, i2f_exact(im0) * qk_log2);
      if (im1 != INT_MIN) mx1 = fmaxf(mx1, i2f_exact(im1) * qk_log2);
      if (st.last) {  // the rows' max over the quant tile: rescale to it
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float alpha0 = exp2_approx(m0 - mx0), alpha1 = exp2_approx(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        l0 *= alpha0;
        l1 *= alpha1;
#pragma unroll
        for (int n = 0; n < kOut / 4; ++n) {
          o[4 * n + 0] *= alpha0;
          o[4 * n + 1] *= alpha0;
          o[4 * n + 2] *= alpha1;
          o[4 * n + 3] *= alpha1;
        }
      }
    }
    if (!st.pass_a) {
      // p = 2^(s qk_c log2 e - m) by one fma and ex2.approx, 0 where masked
      float p[32];
#pragma unroll
      for (int i = 0; i < 32; ++i)
        p[i] = valid(i) ? exp2_approx(fmaf(i2f_exact(si[i]), qk_log2, (i & 2) ? -m1 : -m0))
                        : 0.f;
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
        l0 += p[4 * n + 0] + p[4 * n + 1];
        l1 += p[4 * n + 2] + p[4 * n + 3];
      }
      if constexpr (kPvInt8) {
        // p quantized to round(p * 127); k32 step h covers score columns
        // 32h..32h+31, each A register 4 of the thread's columns in kv_slot
        // order (v^T is permuted to match)
        uint32_t a[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int n = 4 * h + 2 * c;
            a[h][2 * c] = e4t::pack_s8(round_u8(p[4 * n] * 127.f), round_u8(p[4 * n + 1] * 127.f),
                                       round_u8(p[4 * n + 4] * 127.f),
                                       round_u8(p[4 * n + 5] * 127.f));
            a[h][2 * c + 1] = e4t::pack_s8(
                round_u8(p[4 * n + 2] * 127.f), round_u8(p[4 * n + 3] * 127.f),
                round_u8(p[4 * n + 6] * 127.f), round_u8(p[4 * n + 7] * 127.f));
          }
        }
        if (st.first) {
#pragma unroll
          for (int i = 0; i < kOut; ++i) ci[i] = 0;
        }
        fence_regs(ci);
        fence_regs(a);
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_s8_rs<DK>(ci, a[h], smem_desc(vt_s + h * 256, 128, 4 * 128));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(ci);
        if (st.last) {  // the quant tile's exact int32 sums, added once
#pragma unroll
          for (int i = 0; i < kOut; ++i) o[i] += (float)ci[i];
        }
      } else {
        // p in the accumulator layout is the A-fragment layout of P V:
        // score tiles 2kk and 2kk + 1 form k-step kk
        uint32_t pa[kBlockN / 16][4];
#pragma unroll
        for (int n = 0; n < kBlockN / 8; ++n) {
          pa[n >> 1][(n & 1) * 2 + 0] = e4t::pack_bf16(p[4 * n + 0], p[4 * n + 1]);
          pa[n >> 1][(n & 1) * 2 + 1] = e4t::pack_bf16(p[4 * n + 2], p[4 * n + 3]);
        }
        fence_regs(o);
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk)
          e4t::wgmma_rs_tile<DK>(o, pa[kk], vs + kk * 2 * kGroupV, kGroupV);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
    }

    e4t::cp_async_wait<kStages - 2>();  // step j + 1 has landed (this thread's part)
    fence_proxy_async();
    __syncthreads();                     // ... everyone's, and step j is free
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float f0 = (l0 > 0.f ? 1.f / l0 : 0.f) * v_c;
  const float f1 = (l1 > 0.f ? 1.f / l1 : 0.f) * v_c;
  const int row0 = q0 + wg * 64 + wi * 16 + g, row1 = row0 + 8;
  OutT* ob = out + (size_t)bh * sq * d;
#pragma unroll
  for (int n = 0; n < kOut / 4; ++n) {
    const int col = n * 8 + t4 * 2;
    if (col < d) {
      if (row0 < sq) store2(&ob[(size_t)row0 * d + col], o[4 * n] * f0, o[4 * n + 1] * f0);
      if (row1 < sq)
        store2(&ob[(size_t)row1 * d + col], o[4 * n + 2] * f1, o[4 * n + 3] * f1);
    }
  }
  if (t4 == 0) {
    const float ln2 = 0.693147180559945309f;
    if (row0 < sq) lse[(size_t)bh * sq + row0] = (m0 + log2f(fmaxf(l0, 1e-37f))) * ln2;
    if (row1 < sq) lse[(size_t)bh * sq + row1] = (m1 + log2f(fmaxf(l1, 1e-37f))) * ln2;
  }
}

template <int DK, bool kPvInt8, typename OutT>
int launch_wgmma(const void* q, const void* k, const void* v, const void* sc, void* out,
                 void* lse, int bh, int sq, int sk, int d, int block_k,
                 cudaStream_t stream) {
  constexpr size_t smem = wgmma_smem_bytes<DK, kPvInt8>();
  static_assert(smem <= e4t::kMaxSmem, "the ring does not fit a block");
  const cudaError_t err =
      e4t::allow_smem(flash_fwd_int8_wgmma_kernel<DK, kPvInt8, OutT>, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kBM = 64 * wgmma_groups<DK, kPvInt8>();
  const dim3 grid((sq + kBM - 1) / kBM, bh);
  flash_fwd_int8_wgmma_kernel<DK, kPvInt8, OutT><<<grid, kBM * 2, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), v,
      static_cast<const float*>(sc), static_cast<OutT*>(out), static_cast<float*>(lse),
      sq, sk, d, block_k);
  return (int)cudaGetLastError();
}

// ---- the synchronous design, kept as the yardstick ----

template <int DK, bool kPvInt8, typename OutT>
int launch(const void* q, const void* k, const void* v, const void* sc, void* out,
           void* lse, int bh, int sq, int sk, int d, int block_k, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DK, kPvInt8>();
  const cudaError_t err =
      e4t::allow_smem(flash_fwd_int8_kernel<DK, kPvInt8, OutT>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  flash_fwd_int8_kernel<DK, kPvInt8, OutT><<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), v,
      static_cast<const float*>(sc), static_cast<OutT*>(out), static_cast<float*>(lse),
      sq, sk, d, block_k);
  return (int)cudaGetLastError();
}

// The launch for a padded head dim, by the wgmma kernel or (kWgmma false)
// the synchronous design.
template <bool kWgmma, bool kPvInt8, typename OutT, int DK>
int launch_by(const void* q, const void* k, const void* v, const void* sc, void* out,
              void* lse, int bh, int sq, int sk, int d, int bk, cudaStream_t s) {
  if constexpr (kWgmma)
    return launch_wgmma<DK, kPvInt8, OutT>(q, k, v, sc, out, lse, bh, sq, sk, d, bk, s);
  else
    return launch<DK, kPvInt8, OutT>(q, k, v, sc, out, lse, bh, sq, sk, d, bk, s);
}

// the launch for D padded to the s8 / bf16 k-depth granularity (16 here)
template <bool kWgmma, bool kPvInt8, typename OutT, typename... Args>
int dispatch(int d, Args... a) {
  switch ((d + 15) / 16 * 16) {
    case 16: return launch_by<kWgmma, kPvInt8, OutT, 16>(a...);
    case 32: return launch_by<kWgmma, kPvInt8, OutT, 32>(a...);
    case 48: return launch_by<kWgmma, kPvInt8, OutT, 48>(a...);
    case 64: return launch_by<kWgmma, kPvInt8, OutT, 64>(a...);
    case 80: return launch_by<kWgmma, kPvInt8, OutT, 80>(a...);
    case 96: return launch_by<kWgmma, kPvInt8, OutT, 96>(a...);
    case 112: return launch_by<kWgmma, kPvInt8, OutT, 112>(a...);
    case 128: return launch_by<kWgmma, kPvInt8, OutT, 128>(a...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kWgmma>
int dispatch_all(const void* q, const void* k, const void* v, const void* sc, void* out,
                 void* lse, int bh, int sq, int sk, int d, int pv_int8, int out_f32, int bk,
                 cudaStream_t s) {
  if (out_f32)
    return dispatch<kWgmma, true, float>(d, q, k, v, sc, out, lse, bh, sq, sk, d, bk, s);
  return pv_int8 ? dispatch<kWgmma, true, bf16>(d, q, k, v, sc, out, lse, bh, sq, sk, d, bk, s)
                 : dispatch<kWgmma, false, bf16>(d, q, k, v, sc, out, lse, bh, sq, sk, d, bk, s);
}

bool bad_shape(int bh, int sq, int sk, int d, int pv_int8, int out_f32, int block_k) {
  return bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0 || d <= 0 || d % 8 != 0 || d >= 128 ||
         (out_f32 && !pv_int8) || block_k <= 0 || block_k % kBlockN != 0;
}

}  // namespace

// Plain C entry point for ctypes. q/k are contiguous int8 (BH, Sq|Sk, D), v
// contiguous int8 (pv_int8 != 0) or bf16 (BH, Sk, D), all 16-byte aligned,
// D a multiple of 8 below 128; sc contiguous f32 (BH, 2); out (BH, Sq, D) in
// bf16, or in f32 where out_f32 != 0 ("qkpv" only: the only change is the
// epilogue's store; "qk" in f32 takes an f32 v, attention_f32.cu); lse f32
// (BH, Sq); block_k the "qkpv" quant tile, a positive multiple of 64. Runs
// on ``stream``, allocates nothing and does not synchronise. Returns
// cudaGetLastError() after the launch.
extern "C" int e4t_flash_fwd_int8(const void* q, const void* k, const void* v,
                                  const void* sc, void* out, void* lse, int bh, int sq,
                                  int sk, int d, int pv_int8, int out_f32, int block_k,
                                  void* stream) {
  if (bad_shape(bh, sq, sk, d, pv_int8, out_f32, block_k)) return (int)cudaErrorInvalidValue;
  return dispatch_all<true>(q, k, v, sc, out, lse, bh, sq, sk, d, pv_int8, out_f32, block_k,
                            static_cast<cudaStream_t>(stream));
}

// The same function by the synchronous design: the yardstick chip_smoke.py
// times the kernel against. No path calls it.
extern "C" int e4t_flash_fwd_int8_sync(const void* q, const void* k, const void* v,
                                       const void* sc, void* out, void* lse, int bh,
                                       int sq, int sk, int d, int pv_int8, int out_f32,
                                       int block_k, void* stream) {
  if (bad_shape(bh, sq, sk, d, pv_int8, out_f32, block_k)) return (int)cudaErrorInvalidValue;
  return dispatch_all<false>(q, k, v, sc, out, lse, bh, sq, sk, d, pv_int8, out_f32, block_k,
                             static_cast<cudaStream_t>(stream));
}
