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
// quantized p, and so the result in "qkpv" mode, depends on the kv tile
// (kBlockN = 64 here, ``flash_int8.KERNEL_BLOCK_K``; the plain version takes
// the tile as an argument). Returns out (BH, Sq, D) = acc / l * v_c, in bf16
// (in f32 too in "qkpv" mode, for an f32 compute type) and lse = m + log(l)
// (BH, Sq) f32.
//
// What bounds it on the H100: at the UNet's 4096-token d=40 sites (BH=64)
// the Sq*Sk exponentials per head take ~0.257 ms at 16 exp2/clk/SM, against
// ~0.07 ms of int8 QK^T on the tensor cores and ~0.09 ms of bf16 P@V ("qk");
// memory is ~0.02 ms. So int8 products leave the bound where the bf16 kernel
// has it: the special-function unit. The design is that of
// flash_fwd_lowdim.cu: scores stay in registers, the scale (times log2 e) is
// one multiply per score so each score costs one ex2, both products run on
// mma.sync tensor cores (s8 m16n8k16 for QK^T, bf16 m16n8k16 or s8 m16n8k32
// for P@V), D is padded in shared memory only (40 -> 48), ragged Sq and Sk
// are masked here.
//
// P@V in int8 needs p as the A operand of m16n8k32, whose thread t4 holds kv
// columns 4*t4..4*t4+3 of each 16; the score accumulator gives the thread
// columns {2*t4, 2*t4+1, 8+2*t4, 9+2*t4}. The contraction order is free, so v
// is staged transposed with its kv index permuted within each 16 to match
// (kv_slot below); p never leaves registers.

#include <math.h>

#include "flash_common.cuh"

namespace {

using e4t::bf16;
using e4t::kThreads;

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

template <int DK, bool kPvInt8, typename OutT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                      const void* __restrict__ v, const float* __restrict__ sc,
                      OutT* __restrict__ out, float* __restrict__ lse, int sq, int sk,
                      int d) {
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

  for (int kv0 = 0; kv0 < sk; kv0 += kBlockN) {
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

    int si[kScoreTiles][4];
#pragma unroll
    for (int n = 0; n < kScoreTiles; ++n) si[n][0] = si[n][1] = si[n][2] = si[n][3] = 0;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
#pragma unroll
      for (int n = 0; n < kScoreTiles; ++n)
        e4t::mma_s8_16816(si[n], qf[st],
                          e4t::ld32(k_s + (n * 8 + g) * kP + st * 16 + t4 * 4));
    }

    float s[kScoreTiles][4];
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kScoreTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = kv0 + n * 8 + t4 * 2 + e < sk;
        s[n][e] = valid ? (float)si[n][e] * qk_log2 : -INFINITY;
        s[n][2 + e] = valid ? (float)si[n][2 + e] * qk_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds at least one valid column, so mx is finite here and
    // the first tile's alpha is exp2(-inf) = 0
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
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
      int ci[kOutTiles][4];
#pragma unroll
      for (int n = 0; n < kOutTiles; ++n) ci[n][0] = ci[n][1] = ci[n][2] = ci[n][3] = 0;
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
#pragma unroll
      for (int n = 0; n < kOutTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] += (float)ci[n][e];
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

template <int DK, bool kPvInt8, typename OutT>
int launch(const void* q, const void* k, const void* v, const void* sc, void* out,
           void* lse, int bh, int sq, int sk, int d, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DK, kPvInt8>();
  const cudaError_t err =
      e4t::allow_smem(flash_fwd_int8_kernel<DK, kPvInt8, OutT>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  flash_fwd_int8_kernel<DK, kPvInt8, OutT><<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), v,
      static_cast<const float*>(sc), static_cast<OutT*>(out), static_cast<float*>(lse),
      sq, sk, d);
  return (int)cudaGetLastError();
}

template <bool kPvInt8, typename OutT>
int dispatch(const void* q, const void* k, const void* v, const void* sc, void* out,
             void* lse, int bh, int sq, int sk, int d, cudaStream_t s) {
  switch ((d + 15) / 16 * 16) {
    case 16: return launch<16, kPvInt8, OutT>(q, k, v, sc, out, lse, bh, sq, sk, d, s);
    case 32: return launch<32, kPvInt8, OutT>(q, k, v, sc, out, lse, bh, sq, sk, d, s);
    case 48: return launch<48, kPvInt8, OutT>(q, k, v, sc, out, lse, bh, sq, sk, d, s);
    case 64: return launch<64, kPvInt8, OutT>(q, k, v, sc, out, lse, bh, sq, sk, d, s);
    case 80: return launch<80, kPvInt8, OutT>(q, k, v, sc, out, lse, bh, sq, sk, d, s);
    case 96: return launch<96, kPvInt8, OutT>(q, k, v, sc, out, lse, bh, sq, sk, d, s);
    case 112: return launch<112, kPvInt8, OutT>(q, k, v, sc, out, lse, bh, sq, sk, d, s);
    case 128: return launch<128, kPvInt8, OutT>(q, k, v, sc, out, lse, bh, sq, sk, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. q/k are contiguous int8 (BH, Sq|Sk, D), v
// contiguous int8 (pv_int8 != 0) or bf16 (BH, Sk, D), all 16-byte aligned,
// D a multiple of 8 below 128; sc contiguous f32 (BH, 2); out (BH, Sq, D) in
// bf16, or in f32 where out_f32 != 0 ("qkpv" only: the only change is the
// epilogue's store; "qk" in f32 takes an f32 v, attention_f32.cu); lse f32
// (BH, Sq). Runs on ``stream``, allocates nothing and does not synchronise.
// Returns cudaGetLastError() after the launch.
extern "C" int e4t_flash_fwd_int8(const void* q, const void* k, const void* v,
                                  const void* sc, void* out, void* lse, int bh, int sq,
                                  int sk, int d, int pv_int8, int out_f32, void* stream) {
  if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0 || d <= 0 || d % 8 != 0 || d >= 128 ||
      (out_f32 && !pv_int8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32) return dispatch<true, float>(q, k, v, sc, out, lse, bh, sq, sk, d, s);
  return pv_int8 ? dispatch<true, bf16>(q, k, v, sc, out, lse, bh, sq, sk, d, s)
                 : dispatch<false, bf16>(q, k, v, sc, out, lse, bh, sq, sk, d, s);
}
