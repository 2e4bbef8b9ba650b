// f32 attention for Hopper (sm_90a): the flash forward, the flash backward,
// the short-sequence forward and the int8 attention in "qk" mode, each in
// full f32 on the CUDA cores (FFMA; no TF32, whose 10-bit mantissa the plain
// versions and the CPU do not have).
//
// Replaces, for f32 operands, the TPU kernels of
// e4t_diffusion_tpu/ops/flash_kernels.py that write in q's dtype:
//   - _flash_fwd_lowdim (:286), _flash_fwd_kvres (:196) and _flash_fwd
//     (:95): attn_f32_fwd_kernel<DK, false>, out and lse = m + log(l);
//   - _flash_bwd_resident (:503) and _flash_bwd (:582): attn_f32_bwd_dq_kernel
//     and attn_f32_bwd_dkv_kernel, p = exp(s - lse), ds = p (dP - delta) scale;
//   - _flash_fwd_shortseq_mh (:896): attn_f32_shortseq_kernel up to 320
//     tokens, attn_f32_fwd_kernel<DK, true> above; the single-pass softmax
//     (the row max over the whole kv row first, no rescaling) and the
//     division by l after P@V;
//   - _flash_fwd_lowdim_int8 (:813) in "qk" mode with an f32 v:
//     attn_f32_fwd_int8_kernel<DK>, the int8 scores exact in int32
//     (__dp4a) times the head's qk_c, P@V in f32, out = acc / l * v_c.
// With f32 p nothing is rounded before P@V, so these compute the plain
// versions' function with f32 sums in another order; exponentials are
// ex2.approx of an FMA that folds the scale in (2 ulp; results below 2^-126
// flush to 0).
//
// What bounds them on the H100: f32 outside the tensor cores peaks at 67
// TFLOP/s, so at the UNet's 4096-token d=40 sites (BH=64) the 4*Sq*Sk*D flops
// of the forward alone take 2.6 ms at peak, the exponentials 0.26 ms and the
// bytes 0.06 ms: FFMA bounds every one of them, and the kernels are
// register-blocked so that FFMA, not shared-memory loads, fills the issue
// slots (the design notes below: attn_f32_*).
//
// The synchronous designs they replaced stay as their yardsticks (entry
// points e4t_attn_*_f32_sync, e4t_attn_fwd_int8_qk_f32_sync): one block of 256
// threads per tile of 64 rows (32 from DK = 160), every operand staged in
// shared memory between two block barriers with an odd row pitch, each
// thread a 4 x 4 block of scores from scalar shared loads (rows 4 ty..,
// columns tx + 16 j) and 4 rows x DK/16 columns of the output; D padded to
// 16 up to 128, to 32 above.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "wgmma_common.cuh"

// Built in parts that compile side by side (ops/_build.py: a library
// "attention_f32@<n>" is this file with E4T_PART=n): each part keeps only
// its entry points below, and so instantiates only their kernels. 1: the
// flash forward, 2: the backward, 3: the short-sequence forward, 4: the
// synchronous designs, 5: the int8 "qk" forward.
#ifndef E4T_PART
#error "attention_f32.cu is built in parts: define E4T_PART (1 to 5)"
#endif
#define E4T_IN_PART(n) (E4T_PART == (n))

namespace {

constexpr int kT = 256;  // threads per block: a 16 x 16 grid
constexpr float kLn2 = 0.693147180559945309f;

// rows per tile (q and kv alike): 64 up to DK = 128, 32 above
template <int DK>
__host__ __device__ constexpr int tile_rows() { return DK <= 128 ? 64 : 32; }

// A q/k operand tile in shared memory: f32 values, or int8 values four to a
// 32-bit word (D is a multiple of 8, so a word never straddles column d).
template <typename T, int DK>
struct Operand;

template <int DK>
struct Operand<float, DK> {
  using Word = float;
  static constexpr int kWords = DK;
  static constexpr int kPitch = DK + 1;
};

template <int DK>
struct Operand<int8_t, DK> {
  using Word = int;
  static constexpr int kWords = DK / 4;
  static constexpr int kPitch = DK / 4 + 1;
};

__device__ __forceinline__ void fma_word(float& acc, float a, float b) {
  acc = fmaf(a, b, acc);
}

__device__ __forceinline__ void fma_word(int& acc, int a, int b) {
  acc = __dp4a(a, b, acc);  // exact: |sum| <= 127^2 * 128 < 2^24
}

// Rows [r0, r0 + ROWS) of a contiguous (n, d) f32 tensor into dst (pitch P),
// zero past row n and column d.
template <int ROWS, int DK, int P>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int r0, int n,
                                           int d, int tid) {
  for (int i = tid; i < ROWS * DK; i += kT) {
    const int r = i / DK, c = i - r * DK;
    dst[r * P + c] = (r0 + r < n && c < d) ? src[(size_t)(r0 + r) * d + c] : 0.f;
  }
}

// The same for an int8 tensor, four values to a word.
template <int ROWS, int DK, int P>
__device__ __forceinline__ void stage_rows(int* dst, const int8_t* src, int r0, int n,
                                           int d, int tid) {
  constexpr int kW = DK / 4;
  for (int i = tid; i < ROWS * kW; i += kT) {
    const int r = i / kW, w = i - r * kW;
    dst[r * P + w] = (r0 + r < n && 4 * w < d)
                         ? *reinterpret_cast<const int*>(src + (size_t)(r0 + r) * d + 4 * w)
                         : 0;
  }
}

// acc[i][j] = sum_w a[(ra + i) * P + w] * b[(cb + 16 j) * P + w], w < WORDS:
// a block of A B^T with both operands row-major.
template <typename W, int RM, int CN, int WORDS, int P>
__device__ __forceinline__ void tile_nt(W (&acc)[RM][CN], const W* a, int ra, const W* b,
                                        int cb) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = W(0);
#pragma unroll 4
  for (int w = 0; w < WORDS; ++w) {
    W av[RM], bv[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) av[i] = a[(ra + i) * P + w];
#pragma unroll
    for (int j = 0; j < CN; ++j) bv[j] = b[(cb + 16 * j) * P + w];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) fma_word(acc[i][j], av[i], bv[j]);
  }
}

// acc[i][c] += sum_n a[(ra + i) * PA + n] * b[n * PB + cb + 16 c], n < N: a
// block of A B with A row-major over n and B row-major over the output column.
template <int RM, int CO, int N, int PA, int PB>
__device__ __forceinline__ void tile_nn(float (&acc)[RM][CO], const float* a, int ra,
                                        const float* b, int cb) {
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float av[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) av[i] = a[(ra + i) * PA + n];
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      const float bv = b[n * PB + cb + 16 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(av[i], bv, acc[i][c]);
    }
  }
}

// max and sum over the 16 threads of a half-warp (one row's columns); the
// mask names that half only, so a block may end on a half-populated warp
__device__ __forceinline__ float half_warp_max(float x) {
  const unsigned mask = 0xffffu << (threadIdx.x & 16);
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(mask, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  const unsigned mask = 0xffffu << (threadIdx.x & 16);
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(mask, x, o);
  return x;
}

template <typename QK, int DK>
constexpr size_t fwd_smem_bytes() {
  using Op = Operand<QK, DK>;
  constexpr int kB = tile_rows<DK>();
  return sizeof(typename Op::Word) * 2 * kB * Op::kPitch +
         sizeof(float) * (kB * (DK + 1) + kB * (kB + 1));
}

// Forward: out (BH, Sq, D) f32 and, where lse is not null, lse (BH, Sq) f32.
// QK = float: f32 q/k, the softmax scale `scale`, sc null. QK = int8_t: int8
// q/k, sc (BH, 2) = (qk_c, v_c) per head. kSinglePass: the row max over every
// kv tile first, then p against that max with no rescaling (the
// short-sequence kernel's softmax); else the online softmax of flash.
template <typename QK, int DK, bool kSinglePass>
__global__ void __launch_bounds__(kT, 1)
attn_fwd_f32_sync_kernel(const QK* __restrict__ q, const QK* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ sc, float scale,
                    float* __restrict__ out, float* __restrict__ lse, int sq, int sk,
                    int d) {
  using Op = Operand<QK, DK>;
  using W = typename Op::Word;
  constexpr int kB = tile_rows<DK>();
  constexpr int kRM = kB / 16, kCN = kB / 16, kCO = DK / 16;
  constexpr int kP = Op::kPitch, kPV = DK + 1, kPP = kB + 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* q_s = reinterpret_cast<W*>(smem_raw);  // kB x kP
  W* k_s = q_s + kB * kP;                    // kB x kP
  float* v_s = reinterpret_cast<float*>(k_s + kB * kP);  // kB x kPV
  float* p_s = v_s + kB * kPV;                            // kB x kPP

  const int bh = blockIdx.y, q0 = blockIdx.x * kB, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15, r0 = ty * kRM;
  const float s_log2 = (sc != nullptr ? sc[2 * bh] : scale) * e4t::kLog2e;
  const float v_c = sc != nullptr ? sc[2 * bh + 1] : 1.f;
  const QK* kb = k + (size_t)bh * sk * d;
  const float* vb = v + (size_t)bh * sk * d;

  stage_rows<kB, DK, kP>(q_s, q + (size_t)bh * sq * d, q0, sq, d, tid);

  float m[kRM], l[kRM], o[kRM][kCO];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCO; ++c) o[i][c] = 0.f;
  }

  // the scores of this thread's block of the tile at kv0, log2 domain,
  // -inf past Sk
  auto scores = [&](float (&s)[kRM][kCN], int kv0) {
    W acc[kRM][kCN];
    tile_nt<W, kRM, kCN, Op::kWords, kP>(acc, q_s, r0, k_s, tx);
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kCN; ++j)
        s[i][j] = kv0 + tx + 16 * j < sk ? (float)acc[i][j] * s_log2 : -INFINITY;
  };

  if constexpr (kSinglePass) {
    for (int kv0 = 0; kv0 < sk; kv0 += kB) {
      __syncthreads();
      stage_rows<kB, DK, kP>(k_s, kb, kv0, sk, d, tid);
      __syncthreads();
      float s[kRM][kCN];
      scores(s, kv0);
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kCN; ++j) m[i] = fmaxf(m[i], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i) m[i] = half_warp_max(m[i]);
  }

  for (int kv0 = 0; kv0 < sk; kv0 += kB) {
    __syncthreads();  // every thread is done with the previous tile
    stage_rows<kB, DK, kP>(k_s, kb, kv0, sk, d, tid);
    stage_rows<kB, DK, kPV>(v_s, vb, kv0, sk, d, tid);
    __syncthreads();
    float s[kRM][kCN];
    scores(s, kv0);
    if constexpr (!kSinglePass) {
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < kCN; ++j) mx = fmaxf(mx, s[i][j]);
        // every tile holds a valid column, so mx is finite and the first
        // tile's alpha is exp2(-inf) = 0
        mx = half_warp_max(mx);
        const float alpha = exp2f(m[i] - mx);
        m[i] = mx;
        l[i] *= alpha;
#pragma unroll
        for (int c = 0; c < kCO; ++c) o[i][c] *= alpha;
      }
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        const float p = exp2f(s[i][j] - m[i]);
        l[i] += p;
        p_s[(r0 + i) * kPP + tx + 16 * j] = p;
      }
    __syncthreads();
    tile_nn<kRM, kCO, kB, kPP, kPV>(o, p_s, r0, v_s, tx);
  }

  float* ob = out + (size_t)bh * sq * d;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const float li = half_warp_sum(l[i]);
    const float f = (li > 0.f ? 1.f / li : 0.f) * v_c;
    const int row = q0 + r0 + i;
    if (row < sq) {
#pragma unroll
      for (int c = 0; c < kCO; ++c)
        if (tx + 16 * c < d) ob[(size_t)row * d + tx + 16 * c] = o[i][c] * f;
      if (tx == 0 && lse != nullptr)
        lse[(size_t)bh * sq + row] = (m[i] + log2f(fmaxf(li, 1e-37f))) * kLn2;
    }
  }
}

template <int DK>
constexpr size_t bwd_dq_smem_bytes() {
  constexpr int kB = tile_rows<DK>();
  return sizeof(float) * (4 * kB * (DK + 1) + kB * (kB + 1));
}

// dq over one q tile: recompute S and P = exp(S - lse) against each kv tile,
// dP = dO V^T, dS = P (dP - delta) scale, dq += dS K.
template <int DK>
__global__ void __launch_bounds__(kT, 1)
attn_bwd_dq_sync_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dq, int sq, int sk, int d, float scale) {
  constexpr int kB = tile_rows<DK>();
  constexpr int kR = kB / 16, kCO = DK / 16, kP = DK + 1, kPS = kB + 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* do_s = q_s + kB * kP;
  float* k_s = do_s + kB * kP;
  float* v_s = k_s + kB * kP;
  float* ds_s = v_s + kB * kP;  // kB x kPS

  const int bh = blockIdx.y, q0 = blockIdx.x * kB, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15, r0 = ty * kR;
  const float s_log2 = scale * e4t::kLog2e;
  const size_t qoff = (size_t)bh * sq * d, koff = (size_t)bh * sk * d;

  stage_rows<kB, DK, kP>(q_s, q + qoff, q0, sq, d, tid);
  stage_rows<kB, DK, kP>(do_s, dout + qoff, q0, sq, d, tid);
  float lse2[kR], dl[kR], acc[kR][kCO];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + r0 + i;
    lse2[i] = row < sq ? lse[(size_t)bh * sq + row] * e4t::kLog2e : 0.f;
    dl[i] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kCO; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < sk; kv0 += kB) {
    __syncthreads();
    stage_rows<kB, DK, kP>(k_s, k + koff, kv0, sk, d, tid);
    stage_rows<kB, DK, kP>(v_s, v + koff, kv0, sk, d, tid);
    __syncthreads();
    float s[kR][kR], dp[kR][kR];
    tile_nt<float, kR, kR, DK, kP>(s, q_s, r0, k_s, tx);
    tile_nt<float, kR, kR, DK, kP>(dp, do_s, r0, v_s, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const float p =
            kv0 + tx + 16 * j < sk ? exp2f(s[i][j] * s_log2 - lse2[i]) : 0.f;
        ds_s[(r0 + i) * kPS + tx + 16 * j] = p * (dp[i][j] - dl[i]) * scale;
      }
    __syncthreads();
    tile_nn<kR, kCO, kB, kPS, kP>(acc, ds_s, r0, k_s, tx);
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + r0 + i;
    if (row < sq)
#pragma unroll
      for (int c = 0; c < kCO; ++c)
        if (tx + 16 * c < d) dq[qoff + (size_t)row * d + tx + 16 * c] = acc[i][c];
  }
}

template <int DK>
constexpr size_t bwd_dkdv_smem_bytes() {
  constexpr int kB = tile_rows<DK>();
  return sizeof(float) * (4 * kB * (DK + 1) + 2 * kB * (kB + 1) + 2 * kB);
}

// dk and dv over one kv tile: against each q tile, P^T = exp(K Q^T scale -
// lse), dP^T = V dO^T, dS^T = P^T (dP^T - delta) scale; dv += P^T dO,
// dk += dS^T Q.
template <int DK>
__global__ void __launch_bounds__(kT, 1)
attn_bwd_dkv_sync_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int sq, int sk, int d,
                     float scale) {
  constexpr int kB = tile_rows<DK>();
  constexpr int kR = kB / 16, kCO = DK / 16, kP = DK + 1, kPS = kB + 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);
  float* v_s = k_s + kB * kP;
  float* q_s = v_s + kB * kP;
  float* do_s = q_s + kB * kP;
  float* pt_s = do_s + kB * kP;  // kB x kPS, kv rows by q columns
  float* dst_s = pt_s + kB * kPS;
  float* lse_s = dst_s + kB * kPS;  // kB, log2 domain
  float* dl_s = lse_s + kB;

  const int bh = blockIdx.y, kv0 = blockIdx.x * kB, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15, r0 = ty * kR;
  const float s_log2 = scale * e4t::kLog2e;
  const size_t qoff = (size_t)bh * sq * d, koff = (size_t)bh * sk * d;

  stage_rows<kB, DK, kP>(k_s, k + koff, kv0, sk, d, tid);
  stage_rows<kB, DK, kP>(v_s, v + koff, kv0, sk, d, tid);
  float gk[kR][kCO], gv[kR][kCO];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kCO; ++c) gk[i][c] = gv[i][c] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += kB) {
    __syncthreads();
    stage_rows<kB, DK, kP>(q_s, q + qoff, q0, sq, d, tid);
    stage_rows<kB, DK, kP>(do_s, dout + qoff, q0, sq, d, tid);
    for (int i = tid; i < kB; i += kT) {
      const bool valid = q0 + i < sq;
      lse_s[i] = valid ? lse[(size_t)bh * sq + q0 + i] * e4t::kLog2e : 0.f;
      dl_s[i] = valid ? delta[(size_t)bh * sq + q0 + i] : 0.f;
    }
    __syncthreads();
    float st[kR][kR], dpt[kR][kR];
    tile_nt<float, kR, kR, DK, kP>(st, k_s, r0, q_s, tx);
    tile_nt<float, kR, kR, DK, kP>(dpt, v_s, r0, do_s, tx);
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int qc = tx + 16 * j;
      const bool valid = q0 + qc < sq;
      const float l2 = lse_s[qc], dl = dl_s[qc];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const float p = valid ? exp2f(st[i][j] * s_log2 - l2) : 0.f;
        pt_s[(r0 + i) * kPS + qc] = p;
        dst_s[(r0 + i) * kPS + qc] = p * (dpt[i][j] - dl) * scale;
      }
    }
    __syncthreads();
    tile_nn<kR, kCO, kB, kPS, kP>(gv, pt_s, r0, do_s, tx);
    tile_nn<kR, kCO, kB, kPS, kP>(gk, dst_s, r0, q_s, tx);
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = kv0 + r0 + i;
    if (row < sk)
#pragma unroll
      for (int c = 0; c < kCO; ++c)
        if (tx + 16 * c < d) {
          dk[koff + (size_t)row * d + tx + 16 * c] = gk[i][c];
          dv[koff + (size_t)row * d + tx + 16 * c] = gv[i][c];
        }
  }
}

// ---------------------------------------------------------------------------
// The redesigned f32 kernels (attn_f32_*): register-blocked FFMA. The
// flash forward (attn_f32_fwd_kernel) takes one block of 128 threads (256
// above DK 128) per 64 q rows at every DK, k/v tiles of 64 rows. q, k and v
// sit row-major in shared memory with a pitch of DK + 4 floats (16-byte rows
// whose 16-byte chunks fall in distinct bank groups for consecutive rows),
// loaded by 16-byte cp.async (each tile's k during the previous tile's P V,
// its v during its own S). The two products:
//   - S = Q K^T: a kNR x 16 thread grid, each thread kRM (8, or 4 at 256
//     threads) rows ty + kNR i by 4 columns tx + 16 j, 4 head dims a step:
//     kRM + 4 16-byte loads for 16 kRM FMAs, every word feeding at least 4.
//     The 16 threads of a row are 16 consecutive lanes, so row maxima and
//     sums reduce by half-warp shuffles.
//   - O += P V: P goes through shared memory row-major (pitch 68), so the
//     output's thread grid is free of the score grid's: kNRo x kNCo threads
//     each own kRO rows oy + kNRo i by kCO = DK / kNCo columns ox + kNCo c,
//     4 kv rows a step: kRO 16-byte loads of p and 4 kCO 4-byte loads of v
//     for 4 kRO kCO FMAs (each p word feeds kCO FMAs, each v word kRO). The
//     row rescales (alpha) and sums (l) reach it through shared memory.
// D is padded to a multiple of 8 up to 128 (d itself: the wrappers take
// multiples of 8) and of 32 above, so d = 40 computes 40 columns.

// A block's thread grids and shared-memory pitches: BM rows of the operand
// the block keeps (q in the forward and dq, k/v in dk/dv) by BN rows of the
// streamed tile, NT threads. Scores: a NT / 16 x 16 grid, kRM rows by kCN
// columns a thread. Outputs: kNRo x kNCo, kRO rows by kCO columns, with
// kNCo picked so that kRO >= 4 where DK allows.
template <int DK, int BM, int NT, int BN = 64>
struct F32Tile {
  static constexpr int kThreads = NT, kBM = BM, kBN = BN;
  static constexpr int kNC = 16, kNR = NT / kNC;
  static constexpr int kRM = BM / kNR, kCN = BN / kNC;
  static constexpr int kNCo = NT == 256 && DK % 32 == 0 ? 32 : DK % 16 == 0 ? 16 : 8;
  static constexpr int kNRo = NT / kNCo;
  static constexpr int kRO = BM / kNRo, kCO = DK / kNCo;
  static constexpr int kP = DK + 4, kPP = BN + 4;
  static_assert(kCO * kNCo == DK && kRO * kNRo == BM && kRM * kNR == BM &&
                    kCN * kNC == BN,
                "grids");
};

// The forward's: BM q rows a block, 64 (the flash kernel) or 88 (the
// short-sequence one at some lengths): 8 rows a thread to DK 128 (BM / 8 x
// 16 threads), 4 rows above (256 threads); k/v tiles of 64 rows.
template <int DK, int BM = 64>
using F32Fwd = F32Tile<DK, BM, DK <= 128 ? 2 * BM : 256>;

// the flash forward's shared memory: q, k, v, p, the row rescales and sums
template <int DK>
constexpr size_t f32_fwd_smem() {
  using C = F32Fwd<DK>;
  return sizeof(float) * (size_t)(3 * 64 * C::kP + 64 * C::kPP + 2 * 64);
}

// the head dim the redesigned kernels compute for d (a multiple of 8)
__host__ __forceinline__ int f32_head_dim(int d) {
  return d <= 128 ? d : (d + 31) / 32 * 32;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [r0, r0 + ROWS) of a contiguous (n, d) f32 tensor into dst (pitch
// DK + 4) by 16-byte cp.async copies, zero-filled past row n and column d;
// the caller commits them.
template <int ROWS, int DK, int NT>
__device__ __forceinline__ void load_f4_async(float* dst, const float* src, int r0, int n,
                                              int d, int tid) {
  constexpr int kC = DK / 4, kP = DK + 4;
  for (int i = tid; i < ROWS * kC; i += NT) {
    const int r = i / kC, c = 4 * (i - r * kC);
    const bool ok = r0 + r < n && c < d;
    e4t::cp_async_16(dst + r * kP + c, ok ? src + (size_t)(r0 + r) * d + c : src,
                     ok ? 16 : 0);
  }
}

// acc[i][j] = q row (ty + kNR i) . k row (tx + 16 j) over DK, from the
// pitched row-major tiles (C: an F32Fwd)
template <class C>
__device__ __forceinline__ void f32_scores(float (&acc)[C::kRM][C::kCN], const float* q_s,
                                           const float* k_s, int ty, int tx) {
  constexpr int DK = C::kCO * C::kNCo;
#pragma unroll
  for (int i = 0; i < C::kRM; ++i)
#pragma unroll
    for (int j = 0; j < C::kCN; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int w = 0; w < DK; w += 4) {
    float4 b[C::kCN];
#pragma unroll
    for (int j = 0; j < C::kCN; ++j) b[j] = lds4(k_s + (tx + C::kNC * j) * C::kP + w);
#pragma unroll
    for (int i = 0; i < C::kRM; ++i) {
      const float4 a = lds4(q_s + (ty + C::kNR * i) * C::kP + w);
#pragma unroll
      for (int j = 0; j < C::kCN; ++j) {
        acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
      }
    }
  }
}

// o[i][c] += sum over kv rows n0 <= n < n_end of p_s[(oy + NRo i) * PP + n]
// v_s[n * P + ox + NCo c]: a thread's RO rows by CO columns of the output;
// n0 and n_end multiples of 4 (p is 0 and v is 0 past Sk)
template <int RO, int CO, int NRo, int NCo, int P, int PP>
__device__ __forceinline__ void pv_block(float (&o)[RO][CO], const float* p_s,
                                         const float* v_s, int oy, int ox, int n0,
                                         int n_end) {
#pragma unroll 2
  for (int n = n0; n < n_end; n += 4) {
    float4 pa[RO];
#pragma unroll
    for (int i = 0; i < RO; ++i) pa[i] = lds4(p_s + (oy + NRo * i) * PP + n);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float vb[CO];
#pragma unroll
      for (int c = 0; c < CO; ++c) vb[c] = v_s[(n + t) * P + ox + NCo * c];
#pragma unroll
      for (int i = 0; i < RO; ++i) {
        const float pv = t == 0 ? pa[i].x : t == 1 ? pa[i].y : t == 2 ? pa[i].z : pa[i].w;
#pragma unroll
        for (int c = 0; c < CO; ++c) o[i][c] = fmaf(pv, vb[c], o[i][c]);
      }
    }
  }
}

// pv_block on the output grid of C (an F32Fwd) over kv rows n < n_end
template <class C, int PP>
__device__ __forceinline__ void f32_pv(float (&o)[C::kRO][C::kCO], const float* p_s,
                                       const float* v_s, int oy, int ox, int n_end) {
  pv_block<C::kRO, C::kCO, C::kNRo, C::kNCo, C::kP, PP>(o, p_s, v_s, oy, ox, 0, n_end);
}

// Forward over one 64-row q tile: out (BH, Sq, D) f32 and, where lse is not
// null, lse (BH, Sq). kSinglePass: the row max over every kv tile first,
// then p against it with no rescaling (the short-sequence kernel's
// softmax); else the online softmax of flash.
template <int DK, bool kSinglePass>
__global__ void __launch_bounds__(F32Fwd<DK>::kThreads, 1)
attn_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float scale, float* __restrict__ out,
                    float* __restrict__ lse, int sq, int sk, int d) {
  using C = F32Fwd<DK>;
  constexpr int kT = C::kThreads, kRM = C::kRM, kCN = C::kCN, kRO = C::kRO,
                kCO = C::kCO, kP = C::kP, kPP = C::kPP, kBN = C::kBN;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // kBM x kP
  float* k_s = q_s + C::kBM * kP;                    // kBN x kP
  float* v_s = k_s + kBN * kP;                       // kBN x kP
  float* p_s = v_s + kBN * kP;                       // kBM x kPP
  float* alpha_s = p_s + C::kBM * kPP;               // kBM
  float* l_s = alpha_s + C::kBM;                     // kBM

  const int bh = blockIdx.y, q0 = blockIdx.x * C::kBM, tid = threadIdx.x;
  const int ty = tid / C::kNC, tx = tid % C::kNC;    // score grid
  const int oy = tid / C::kNCo, ox = tid % C::kNCo;  // output grid
  const float s_log2 = scale * e4t::kLog2e;
  const float* kb = k + (size_t)bh * sk * d;
  const float* vb = v + (size_t)bh * sk * d;

  const int n_tiles = (sk + kBN - 1) / kBN;
  load_f4_async<C::kBM, DK, kT>(q_s, q + (size_t)bh * sq * d, q0, sq, d, tid);
  load_f4_async<kBN, DK, kT>(k_s, kb, 0, sk, d, tid);
  e4t::cp_async_commit();

  float m[kRM], l[kRM], o[kRO][kCO];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kRO; ++i)
#pragma unroll
    for (int c = 0; c < kCO; ++c) o[i][c] = 0.f;

  // this thread's scores of the tile at kv0, unscaled (the scale goes
  // into each exponent's FMA), -inf past Sk (only the last tile has any)
  auto scores = [&](float (&s)[kRM][kCN], int kv0) {
    f32_scores<C>(s, q_s, k_s, ty, tx);
    if (kv0 + kBN > sk)
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kCN; ++j)
          if (kv0 + tx + C::kNC * j >= sk) s[i][j] = -INFINITY;
  };

  if constexpr (kSinglePass) {
    // the max pass; its last tile reloads k tile 0 for the second pass
    for (int t = 0; t < n_tiles; ++t) {
      e4t::cp_async_wait<0>();
      __syncthreads();
      float s[kRM][kCN];
      scores(s, t * kBN);
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kCN; ++j) m[i] = fmaxf(m[i], s[i][j]);
      const int nxt = t + 1 < n_tiles ? t + 1 : 0;
      if (nxt != t) {
        __syncthreads();  // every thread is done with k_s
        load_f4_async<kBN, DK, kT>(k_s, kb, nxt * kBN, sk, d, tid);
        e4t::cp_async_commit();
      }
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i) m[i] = half_warp_max(m[i]);
  }

  // Each tile's k lands during the previous tile's P V, its v during its
  // own S: two block barriers a tile.
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBN;
    e4t::cp_async_wait<0>();
    __syncthreads();  // k (and q) landed; every thread is done with v_s, p_s
    load_f4_async<kBN, DK, kT>(v_s, vb, kv0, sk, d, tid);
    e4t::cp_async_commit();
    float s[kRM][kCN];
    scores(s, kv0);
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      if constexpr (!kSinglePass) {
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < kCN; ++j) mx = fmaxf(mx, s[i][j]);
        // every tile holds a valid column, so mx is finite and the first
        // tile's alpha is exp2(-inf) = 0
        mx = half_warp_max(mx);
        const float alpha = e4t::exp2_approx((m[i] - mx) * s_log2);
        m[i] = mx;
        l[i] *= alpha;
        if (tx == 0) alpha_s[ty + C::kNR * i] = alpha;
      }
      const float ms = -m[i] * s_log2;
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        const float p = e4t::exp2_approx(fmaf(s[i][j], s_log2, ms));
        l[i] += p;
        p_s[(ty + C::kNR * i) * kPP + tx + C::kNC * j] = p;
      }
    }
    e4t::cp_async_wait<0>();
    __syncthreads();  // v and p landed; every thread is done with k_s
    if (t + 1 < n_tiles) {
      load_f4_async<kBN, DK, kT>(k_s, kb, kv0 + kBN, sk, d, tid);
      e4t::cp_async_commit();
    }
    if constexpr (!kSinglePass) {
#pragma unroll
      for (int i = 0; i < kRO; ++i) {
        const float a = alpha_s[oy + C::kNRo * i];
#pragma unroll
        for (int c = 0; c < kCO; ++c) o[i][c] *= a;
      }
    }
    f32_pv<C, kPP>(o, p_s, v_s, oy, ox, min(kBN, (sk - kv0 + 3) & ~3));
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const float li = half_warp_sum(l[i]);
    const int r = ty + C::kNR * i, row = q0 + r;
    if (tx == 0) {
      l_s[r] = li;
      if (lse != nullptr && row < sq)
        lse[(size_t)bh * sq + row] = (m[i] * s_log2 + log2f(fmaxf(li, 1e-37f))) * kLn2;
    }
  }
  __syncthreads();
  float* ob = out + (size_t)bh * sq * d;
#pragma unroll
  for (int i = 0; i < kRO; ++i) {
    const int r = oy + C::kNRo * i, row = q0 + r;
    const float li = l_s[r];
    const float f = li > 0.f ? 1.f / li : 0.f;
    if (row < sq)
#pragma unroll
      for (int c = 0; c < kCO; ++c) {
        const int col = ox + C::kNCo * c;
        if (col < d) ob[(size_t)row * d + col] = o[i][c] * f;
      }
  }
}

template <int DK, bool kSinglePass>
int launch_f32_fwd(const void* q, const void* k, const void* v, float scale, void* out,
                   void* lse, int bh, int sq, int sk, int d, cudaStream_t stream) {
  using C = F32Fwd<DK>;
  constexpr size_t smem = f32_fwd_smem<DK>();
  static_assert(smem <= e4t::kMaxSmem, "shared memory");
  auto kernel = attn_f32_fwd_kernel<DK, kSinglePass>;
  const cudaError_t err = e4t::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + C::kBM - 1) / C::kBM, bh);
  kernel<<<grid, C::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), scale, static_cast<float*>(out),
      static_cast<float*>(lse), sq, sk, d);
  return (int)cudaGetLastError();
}

// The int8 "qk" forward (attn_f32_fwd_int8_kernel): attn_f32_fwd_kernel's
// blocking with int8 q and k. S = Q K^T is exact in int32 by __dp4a, four
// int8 values a 32-bit word: each thread keeps kRM = 8 rows ty + 8 i by
// kCN = 4 columns tx + 16 j, two words a step from 8-byte shared loads
// (8 q words, broadcast to the half-warp, and 4 k words for 64 __dp4a).
// The q and k tiles are int8 rows of DK bytes at a pitch of
// i8_pitch<DK>() words (DK / 4 rounded up to 2 mod 4, so the 16 rows a
// half-warp reads with 8-byte loads fall on 16 distinct bank pairs: d40
// keeps its 10 words, d80 pads 20 to 22), copied by 8-byte cp.async (an
// int8 row of a head dim that is a multiple of 8 is 8-byte aligned, not
// always 16). A score is int32 -> f32 exactly (i2f_exact; |q k| <= 127^2 *
// 120 < 2^22) and goes into the exponent's FMA with qk_c * log2(e); the
// rest is the f32 kernel's: v f32 through 16-byte cp.async (each tile's k
// during the previous tile's P V, its v during its own S), p through
// shared memory, P V in f32 FFMA, out = acc / l * v_c.
//
// P V, not S, bounds it (ablations at 4096²/d40: P V 56%, S 14%), and it is
// bound by its shared loads: on F32Fwd's grid at d40 a thread's 4 rows x 5
// columns take 24 loads (4 of p, 20 of v) a 4-row kv step for 80 FMAs. Up
// to DK 48 (I8Pv) the block's two halves each take half of a tile's kv
// rows on a grid of 8 rows x DK / 8 columns a thread: 28 loads for 160
// FMAs; half 1's sums go through shared memory once, at the end, and half
// 0 adds them (a fixed order).

// the int8 kernel's P V grid: at DK <= 48 two halves of 64 threads, each
// over half of a tile's kv rows, 8 rows x DK / 8 columns a thread; above,
// F32Fwd's grid over the whole tile
template <int DK>
struct I8Pv {
  static constexpr bool kSplit = DK <= 48;
  static constexpr int kHalves = kSplit ? 2 : 1;
  static constexpr int kNCo = kSplit ? 8 : F32Fwd<DK>::kNCo;
  static constexpr int kNRo = kSplit ? 8 : F32Fwd<DK>::kNRo;
  static constexpr int kRO = 64 / kNRo, kCO = DK / kNCo;
  static_assert(kHalves * kNRo * kNCo == 128 && kCO * kNCo == DK, "grid");
};

// the pitch, in 32-bit words, of an int8 q/k tile row of DK bytes
template <int DK>
__host__ __device__ constexpr int i8_pitch() {
  return (DK / 4) % 4 == 2 ? DK / 4 : (DK / 4 + 2) / 4 * 4 + 2;
}

// the int8 "qk" forward's shared memory: v, p, the row rescales and sums,
// then the int8 q and k tiles
template <int DK>
constexpr size_t f32_int8_fwd_smem() {
  using C = F32Fwd<DK>;
  return sizeof(float) * (size_t)(64 * C::kP + 64 * C::kPP + 2 * 64) +
         sizeof(int) * (size_t)(2 * 64 * i8_pitch<DK>());
}

// x exactly as f32 for |x| < 2^22: 1.5 x 2^23 + x has a unit ulp
__device__ __forceinline__ float i2f_exact(int x) {
  return __int_as_float(x + 0x4B400000) - 12582912.f;
}

// Rows [r0, r0 + ROWS) of a contiguous (n, DK) int8 tensor into dst (pitch
// i8_pitch<DK>() words) by 8-byte cp.async copies, zero-filled past row n;
// the caller commits them.
template <int ROWS, int DK, int NT>
__device__ __forceinline__ void load_i8_async(int* dst, const int8_t* src, int r0, int n,
                                              int tid) {
  constexpr int kC = DK / 8, kP = i8_pitch<DK>();
  for (int i = tid; i < ROWS * kC; i += NT) {
    const int r = i / kC, c = i - r * kC;
    const bool ok = r0 + r < n;
    e4t::cp_async_8(dst + r * kP + 2 * c, ok ? src + (size_t)(r0 + r) * DK + 8 * c : src,
                    ok ? 8 : 0);
  }
}

// acc[i][j] = q row (ty + kNR i) . k row (tx + 16 j) in int32, from the
// int8 tiles (C: an F32Fwd)
template <class C, int DK>
__device__ __forceinline__ void i8_scores(int (&acc)[C::kRM][C::kCN], const int* q_s,
                                          const int* k_s, int ty, int tx) {
  constexpr int kP = i8_pitch<DK>();
#pragma unroll
  for (int i = 0; i < C::kRM; ++i)
#pragma unroll
    for (int j = 0; j < C::kCN; ++j) acc[i][j] = 0;
#pragma unroll
  for (int w = 0; w < DK / 4; w += 2) {
    int2 b[C::kCN];
#pragma unroll
    for (int j = 0; j < C::kCN; ++j)
      b[j] = *reinterpret_cast<const int2*>(k_s + (tx + C::kNC * j) * kP + w);
#pragma unroll
    for (int i = 0; i < C::kRM; ++i) {
      const int2 a = *reinterpret_cast<const int2*>(q_s + (ty + C::kNR * i) * kP + w);
#pragma unroll
      for (int j = 0; j < C::kCN; ++j) {
        acc[i][j] = __dp4a(a.x, b[j].x, acc[i][j]);
        acc[i][j] = __dp4a(a.y, b[j].y, acc[i][j]);
      }
    }
  }
}

// Forward over one 64-row q tile: int8 q (BH, Sq, DK), k (BH, Sk, DK), f32
// v (BH, Sk, DK), sc (BH, 2) = (qk_c, v_c) -> out (BH, Sq, DK) f32 and lse
// (BH, Sq) f32: the online softmax of flash.
template <int DK>
__global__ void __launch_bounds__(F32Fwd<DK>::kThreads, 1)
attn_f32_fwd_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ sc,
                         float* __restrict__ out, float* __restrict__ lse, int sq, int sk) {
  using C = F32Fwd<DK>;
  using G = I8Pv<DK>;
  constexpr int kT = C::kThreads, kRM = C::kRM, kCN = C::kCN, kRO = G::kRO,
                kCO = G::kCO, kP = C::kP, kPP = C::kPP, kBN = C::kBN, kQP = i8_pitch<DK>();
  static_assert(C::kBM == 64 && kBN == 64 && kT == 128, "the int8 tiles");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* v_s = reinterpret_cast<float*>(smem_raw);  // kBN x kP
  float* p_s = v_s + kBN * kP;                       // kBM x kPP
  float* alpha_s = p_s + C::kBM * kPP;               // kBM
  float* l_s = alpha_s + C::kBM;                     // kBM
  int* q_s = reinterpret_cast<int*>(l_s + C::kBM);   // kBM x kQP
  int* k_s = q_s + C::kBM * kQP;                     // kBN x kQP

  const int bh = blockIdx.y, q0 = blockIdx.x * C::kBM, tid = threadIdx.x;
  const int ty = tid / C::kNC, tx = tid % C::kNC;  // score grid
  constexpr int kTo = kT / G::kHalves;  // threads of a half
  const int half = G::kSplit ? tid / kTo : 0, to = G::kSplit ? tid % kTo : tid;
  const int oy = to / G::kNCo, ox = to % G::kNCo;  // output grid (of this half)
  const float s_log2 = sc[2 * bh] * e4t::kLog2e, v_c = sc[2 * bh + 1];
  const int8_t* kb = k + (size_t)bh * sk * DK;
  const float* vb = v + (size_t)bh * sk * DK;

  const int n_tiles = (sk + kBN - 1) / kBN;
  load_i8_async<C::kBM, DK, kT>(q_s, q + (size_t)bh * sq * DK, q0, sq, tid);
  load_i8_async<kBN, DK, kT>(k_s, kb, 0, sk, tid);
  e4t::cp_async_commit();

  float m[kRM], l[kRM], o[kRO][kCO];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kRO; ++i)
#pragma unroll
    for (int c = 0; c < kCO; ++c) o[i][c] = 0.f;

  // Each tile's k lands during the previous tile's P V, its v during its
  // own S: two block barriers a tile.
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBN;
    e4t::cp_async_wait<0>();
    __syncthreads();  // k (and q) landed; every thread is done with v_s, p_s
    load_f4_async<kBN, DK, kT>(v_s, vb, kv0, sk, DK, tid);
    e4t::cp_async_commit();
    float s[kRM][kCN];
    {
      int acc[kRM][kCN];
      i8_scores<C, DK>(acc, q_s, k_s, ty, tx);
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kCN; ++j)
          s[i][j] = kv0 + tx + C::kNC * j < sk ? i2f_exact(acc[i][j]) : -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kCN; ++j) mx = fmaxf(mx, s[i][j]);
      // every tile holds a valid column, so mx is finite and the first
      // tile's alpha is exp2(-inf) = 0
      mx = half_warp_max(mx);
      const float alpha = e4t::exp2_approx((m[i] - mx) * s_log2);
      m[i] = mx;
      l[i] *= alpha;
      if (tx == 0) alpha_s[ty + C::kNR * i] = alpha;
      const float ms = -mx * s_log2;
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        const float p = e4t::exp2_approx(fmaf(s[i][j], s_log2, ms));
        l[i] += p;
        p_s[(ty + C::kNR * i) * kPP + tx + C::kNC * j] = p;
      }
    }
    e4t::cp_async_wait<0>();
    __syncthreads();  // v and p landed; every thread is done with k_s
    if (t + 1 < n_tiles) {
      load_i8_async<kBN, DK, kT>(k_s, kb, kv0 + kBN, sk, tid);
      e4t::cp_async_commit();
    }
#pragma unroll
    for (int i = 0; i < kRO; ++i) {
      const float a = alpha_s[oy + G::kNRo * i];
#pragma unroll
      for (int c = 0; c < kCO; ++c) o[i][c] *= a;
    }
    // this half's kv rows of the tile; p and v are 0 past Sk
    constexpr int kHalfN = kBN / G::kHalves;
    const int n0 = half * kHalfN, n1 = min(n0 + kHalfN, (sk - kv0 + 3) & ~3);
    pv_block<kRO, kCO, G::kNRo, G::kNCo, kP, kPP>(o, p_s, v_s, oy, ox, n0, n1);
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const float li = half_warp_sum(l[i]);
    const int r = ty + C::kNR * i, row = q0 + r;
    if (tx == 0) {
      l_s[r] = li;
      if (row < sq)
        lse[(size_t)bh * sq + row] = (m[i] * s_log2 + log2f(fmaxf(li, 1e-37f))) * kLn2;
    }
  }
  __syncthreads();  // also: every thread is done with p_s
  if constexpr (G::kSplit) {  // half 1's sums into half 0's, through p_s
    if (half == 1)
#pragma unroll
      for (int i = 0; i < kRO; ++i)
#pragma unroll
        for (int c = 0; c < kCO; ++c) p_s[(oy + G::kNRo * i) * kPP + ox + G::kNCo * c] = o[i][c];
    __syncthreads();
    if (half == 1) return;
#pragma unroll
    for (int i = 0; i < kRO; ++i)
#pragma unroll
      for (int c = 0; c < kCO; ++c) o[i][c] += p_s[(oy + G::kNRo * i) * kPP + ox + G::kNCo * c];
  }
  float* ob = out + (size_t)bh * sq * DK;
#pragma unroll
  for (int i = 0; i < kRO; ++i) {
    const int r = oy + G::kNRo * i, row = q0 + r;
    const float li = l_s[r];
    const float f = (li > 0.f ? 1.f / li : 0.f) * v_c;
    if (row < sq)
#pragma unroll
      for (int c = 0; c < kCO; ++c) ob[(size_t)row * DK + ox + G::kNCo * c] = o[i][c] * f;
  }
}

template <int DK>
int launch_f32_fwd_int8(const void* q, const void* k, const void* v, const void* sc,
                        void* out, void* lse, int bh, int sq, int sk, cudaStream_t stream) {
  using C = F32Fwd<DK>;
  constexpr size_t smem = f32_int8_fwd_smem<DK>();
  static_assert(smem <= e4t::kMaxSmem, "shared memory");
  auto kernel = attn_f32_fwd_int8_kernel<DK>;
  const cudaError_t err = e4t::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + C::kBM - 1) / C::kBM, bh);
  kernel<<<grid, C::kThreads, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(v), static_cast<const float*>(sc), static_cast<float*>(out),
      static_cast<float*>(lse), sq, sk);
  return (int)cudaGetLastError();
}

// The short-sequence forward up to kShortMaxS tokens (attn_f32_shortseq_kernel):
// the single-pass softmax with a q tile's whole score row in shared memory.
// S = Q K^T runs once over the head's k tiles into s_s (scaled, -inf past
// S), each thread keeping the max of its own scores; the row max reduces
// across the row's 16 lanes, each thread turns its own scores into p =
// exp2(s - m) in place and sums them, and O += P V runs over the v tiles.
// So k is read once and S computed once: two tile products a kv tile, where
// the flash-shaped kernel with its max pass takes three. k and then v tiles
// pass through one two-stage cp.async ring. The q tile is 64 or 88 rows
// (kBM), whichever pads S less (257 tokens: 3 tiles of 88 rows, not 5 of
// 64 whose last holds one row).
constexpr int kShortMaxS = 320;  // 5 kv tiles of 64

template <int DK, int BM>
struct F32Short {
  using C = F32Fwd<DK, BM>;
  static constexpr int kPS = kShortMaxS + 4;  // s_s pitch: (kPS / 4) odd
  static constexpr size_t kSmem =
      sizeof(float) * (size_t)(BM * C::kP + 2 * C::kBN * C::kP + BM * kPS + BM);
  static_assert(kSmem <= e4t::kMaxSmem, "shared memory");
};

template <int DK, int BM>
__global__ void __launch_bounds__(F32Fwd<DK, BM>::kThreads, 1)
attn_f32_shortseq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float scale, float* __restrict__ out,
                         int s_len, int d) {
  using C = F32Fwd<DK, BM>;
  constexpr int kT = C::kThreads, kRM = C::kRM, kCN = C::kCN, kRO = C::kRO,
                kCO = C::kCO, kP = C::kP, kBN = C::kBN, kPS = F32Short<DK, BM>::kPS;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // BM x kP
  float* ring = q_s + BM * kP;                       // 2 x kBN x kP
  float* s_s = ring + 2 * kBN * kP;                  // BM x kPS
  float* l_s = s_s + BM * kPS;                       // BM

  const int bh = blockIdx.y, q0 = blockIdx.x * BM, tid = threadIdx.x;
  const int ty = tid / C::kNC, tx = tid % C::kNC;
  const int oy = tid / C::kNCo, ox = tid % C::kNCo;
  const float s_log2 = scale * e4t::kLog2e;
  const size_t head = (size_t)bh * s_len * d;
  const int n_tiles = (s_len + kBN - 1) / kBN;

  // step i < n_tiles loads k tile i, step n_tiles + t v tile t; a group is
  // committed for every step, empty past the last
  auto load = [&](int i) {
    if (i < 2 * n_tiles)
      load_f4_async<kBN, DK, kT>(ring + (i & 1) * kBN * kP, (i < n_tiles ? k : v) + head,
                                 (i < n_tiles ? i : i - n_tiles) * kBN, s_len, d, tid);
    e4t::cp_async_commit();
  };
  load_f4_async<BM, DK, kT>(q_s, q + head, q0, s_len, d, tid);
  load(0);
  load(1);

  float m[kRM], o[kRO][kCO];
#pragma unroll
  for (int i = 0; i < kRM; ++i) m[i] = -INFINITY;
#pragma unroll
  for (int i = 0; i < kRO; ++i)
#pragma unroll
    for (int c = 0; c < kCO; ++c) o[i][c] = 0.f;

  for (int i = 0; i < 2 * n_tiles; ++i) {
    const float* tile = ring + (i & 1) * kBN * kP;
    e4t::cp_async_wait<1>();
    __syncthreads();  // step i's tile landed
    if (i < n_tiles) {
      const int kv0 = i * kBN;
      float acc[kRM][kCN];
      f32_scores<C>(acc, q_s, tile, ty, tx);
#pragma unroll
      for (int r = 0; r < kRM; ++r)
#pragma unroll
        for (int j = 0; j < kCN; ++j) {
          const float sv = kv0 + tx + C::kNC * j < s_len ? acc[r][j] : -INFINITY;
          m[r] = fmaxf(m[r], sv);
          s_s[(ty + C::kNR * r) * kPS + kv0 + tx + C::kNC * j] = sv;
        }
      if (i == n_tiles - 1) {
        // p in place, each thread over the scores it wrote; the barrier
        // below hands them to the P V steps
        float l[kRM];
#pragma unroll
        for (int r = 0; r < kRM; ++r) {
          m[r] = half_warp_max(m[r]);
          l[r] = 0.f;
          const float ms = -m[r] * s_log2;
          float* row = s_s + (ty + C::kNR * r) * kPS + tx;
          for (int t = 0; t < n_tiles; ++t)
#pragma unroll
            for (int j = 0; j < kCN; ++j) {
              const float p = e4t::exp2_approx(fmaf(row[t * kBN + C::kNC * j], s_log2, ms));
              l[r] += p;
              row[t * kBN + C::kNC * j] = p;
            }
          l[r] = half_warp_sum(l[r]);
          if (tx == 0) l_s[ty + C::kNR * r] = l[r];
        }
      }
    } else {
      const int kv0 = (i - n_tiles) * kBN;
      f32_pv<C, kPS>(o, s_s + kv0, tile, oy, ox, min(kBN, (s_len - kv0 + 3) & ~3));
    }
    __syncthreads();  // every thread is done with the tile
    load(i + 2);
  }

  float* ob = out + head;
#pragma unroll
  for (int i = 0; i < kRO; ++i) {
    const int r = oy + C::kNRo * i, row = q0 + r;
    const float li = l_s[r];
    const float f = li > 0.f ? 1.f / li : 0.f;
    if (row < s_len)
#pragma unroll
      for (int c = 0; c < kCO; ++c) {
        const int col = ox + C::kNCo * c;
        if (col < d) ob[(size_t)row * d + col] = o[i][c] * f;
      }
  }
}

template <int DK, int BM>
int launch_f32_shortseq(const void* q, const void* k, const void* v, float scale, void* out,
                        int bh, int s_len, int d, cudaStream_t stream) {
  using C = F32Fwd<DK, BM>;
  constexpr size_t smem = F32Short<DK, BM>::kSmem;
  auto kernel = attn_f32_shortseq_kernel<DK, BM>;
  const cudaError_t err = e4t::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((s_len + BM - 1) / BM, bh), C::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), scale, static_cast<float*>(out), s_len, d);
  return (int)cudaGetLastError();
}

// The short-sequence forward of DK: up to kShortMaxS tokens the whole-row
// kernel at the q tile height that pads S less, above it the flash-shaped
// kernel with its max pass.
template <int DK>
int launch_f32_short(const void* q, const void* k, const void* v, float scale, void* out,
                     int bh, int s_len, int d, cudaStream_t stream) {
  if (s_len > kShortMaxS)
    return launch_f32_fwd<DK, true>(q, k, v, scale, out, nullptr, bh, s_len, s_len, d,
                                    stream);
  const int pad64 = (s_len + 63) / 64 * 64, pad88 = (s_len + 87) / 88 * 88;
  return pad88 < pad64
             ? launch_f32_shortseq<DK, 88>(q, k, v, scale, out, bh, s_len, d, stream)
             : launch_f32_shortseq<DK, 64>(q, k, v, scale, out, bh, s_len, d, stream);
}

// ---------------------------------------------------------------------------
// The redesigned f32 backward: attn_f32_bwd_dq_kernel over 64-row q tiles
// and attn_f32_bwd_dkv_kernel over 64-row kv tiles, no atomics, on the
// forward's register blocking (f32_scores for S and dP or their transposes,
// f32_pv for each gradient product through shared memory):
//   - dq: q and dO resident; per k/v tile S = Q K^T and dP = dO V^T (8 x 4
//     blocks of each), p = exp2(S scale log2e - lse log2e), dS = p (dP -
//     delta) scale into shared memory, dq += dS K;
//   - dk/dv: k and v resident; per q/dO tile (with its lse and delta) S^T =
//     K Q^T and dP^T = V dO^T, P^T and dS^T into shared memory, dv += P^T
//     dO and dk += dS^T Q.
// The streamed tiles come by 16-byte cp.async (lse and delta by 4-byte
// copies). With two stages a tile's successor is issued as the tile starts,
// and each tile takes two block barriers; where a second stage would cost a
// block an SM, one stage: dq issues the next v after dS is written and the
// next k after dq's product, dk/dv the next q/dO after both products.
// From DK 192 the streamed tiles are 32 rows, so every block fits.
template <int DK>
struct F32Bwd {
  static constexpr int kBN = DK <= 160 ? 64 : 32;
  using Dq = F32Tile<DK, 64, DK <= 128 ? 128 : 256, kBN>;
  using Dkv = F32Tile<DK, 64, DK <= 64 ? 128 : 256, kBN>;
  // shared memory with one and with two stages of the streamed tiles; two
  // where they fit and keep as many blocks an SM as one
  static constexpr size_t kDq1 =
      sizeof(float) * (size_t)(2 * 64 * Dq::kP + 2 * kBN * Dq::kP + 64 * Dq::kPP);
  static constexpr size_t kDq2 = kDq1 + sizeof(float) * (size_t)(2 * kBN * Dq::kP);
  static constexpr size_t kDkv1 =
      sizeof(float) * (size_t)(2 * 64 * Dkv::kP + 2 * kBN * Dkv::kP + 2 * kBN +
                               2 * 64 * Dkv::kPP);
  static constexpr size_t kDkv2 =
      kDkv1 + sizeof(float) * (size_t)(2 * kBN * Dkv::kP + 2 * kBN);
  static constexpr size_t kMax = e4t::kMaxSmem;
  static constexpr int kDqStages = kDq2 <= kMax && kMax / kDq2 >= kMax / kDq1 ? 2 : 1;
  static constexpr int kDkvStages = kDkv2 <= kMax && kMax / kDkv2 >= kMax / kDkv1 ? 2 : 1;
  static constexpr size_t kDqSmem = kDqStages == 2 ? kDq2 : kDq1;
  static constexpr size_t kDkvSmem = kDkvStages == 2 ? kDkv2 : kDkv1;
  static_assert(kDqSmem <= kMax && kDkvSmem <= kMax, "shared memory");
  // At d40 (the UNet's 4096-token sites) the dq kernel's shared memory
  // holds 3 blocks an SM and ptxas fits the 170 registers that leaves
  // without a spill (it would take 238 for 2); elsewhere the registers
  // ptxas picks, which at some head dims spill under a tighter bound.
  static constexpr int kDqMinBlocks = DK == 40 ? 3 : 1;
};

template <int DK>
__global__ void __launch_bounds__(F32Bwd<DK>::Dq::kThreads, F32Bwd<DK>::kDqMinBlocks)
attn_f32_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, int sq, int sk, int d, float scale) {
  using C = typename F32Bwd<DK>::Dq;
  constexpr int kT = C::kThreads, kRM = C::kRM, kCN = C::kCN, kRO = C::kRO,
                kCO = C::kCO, kP = C::kP, kPP = C::kPP, kBN = C::kBN,
                kStages = F32Bwd<DK>::kDqStages;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // 64 x kP
  float* do_s = q_s + 64 * kP;                       // 64 x kP
  float* kv_s = do_s + 64 * kP;                      // stages x (k, v) kBN x kP
  float* ds_s = kv_s + kStages * 2 * kBN * kP;       // 64 x kPP

  const int bh = blockIdx.y, q0 = blockIdx.x * 64, tid = threadIdx.x;
  const int ty = tid / C::kNC, tx = tid % C::kNC;
  const int oy = tid / C::kNCo, ox = tid % C::kNCo;
  const float s_log2 = scale * e4t::kLog2e;
  const size_t qoff = (size_t)bh * sq * d, koff = (size_t)bh * sk * d;
  const int n_tiles = (sk + kBN - 1) / kBN;

  auto k_of = [&](int st) { return kv_s + st * 2 * kBN * kP; };
  auto v_of = [&](int st) { return kv_s + st * 2 * kBN * kP + kBN * kP; };
  load_f4_async<64, DK, kT>(q_s, q + qoff, q0, sq, d, tid);
  load_f4_async<64, DK, kT>(do_s, dout + qoff, q0, sq, d, tid);
  load_f4_async<kBN, DK, kT>(k_of(0), k + koff, 0, sk, d, tid);
  load_f4_async<kBN, DK, kT>(v_of(0), v + koff, 0, sk, d, tid);
  e4t::cp_async_commit();

  float lse2[kRM], dl[kRM], acc[kRO][kCO];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = q0 + ty + C::kNR * i;
    lse2[i] = row < sq ? lse[(size_t)bh * sq + row] * e4t::kLog2e : 0.f;
    dl[i] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kRO; ++i)
#pragma unroll
    for (int c = 0; c < kCO; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBN, st = kStages == 2 ? t & 1 : 0;
    e4t::cp_async_wait<0>();
    __syncthreads();  // tile t landed; every thread is done with tile t - 1
    if (kStages == 2 && t + 1 < n_tiles) {
      load_f4_async<kBN, DK, kT>(k_of(st ^ 1), k + koff, kv0 + kBN, sk, d, tid);
      load_f4_async<kBN, DK, kT>(v_of(st ^ 1), v + koff, kv0 + kBN, sk, d, tid);
      e4t::cp_async_commit();
    }
    float s[kRM][kCN], dp[kRM][kCN];
    f32_scores<C>(s, q_s, k_of(st), ty, tx);
    f32_scores<C>(dp, do_s, v_of(st), ty, tx);
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        const float p =
            kv0 + tx + C::kNC * j < sk ? e4t::exp2_approx(fmaf(s[i][j], s_log2, -lse2[i]))
                                       : 0.f;
        ds_s[(ty + C::kNR * i) * kPP + tx + C::kNC * j] = p * (dp[i][j] - dl[i]) * scale;
      }
    __syncthreads();  // dS landed; every thread is done with v
    if (kStages == 1 && t + 1 < n_tiles) {
      load_f4_async<kBN, DK, kT>(v_of(0), v + koff, kv0 + kBN, sk, d, tid);
      e4t::cp_async_commit();
    }
    f32_pv<C, kPP>(acc, ds_s, k_of(st), oy, ox, min(kBN, (sk - kv0 + 3) & ~3));
    if (kStages == 1 && t + 1 < n_tiles) {
      __syncthreads();  // every thread is done with k
      load_f4_async<kBN, DK, kT>(k_of(0), k + koff, kv0 + kBN, sk, d, tid);
      e4t::cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < kRO; ++i) {
    const int row = q0 + oy + C::kNRo * i;
    if (row < sq)
#pragma unroll
      for (int c = 0; c < kCO; ++c) {
        const int col = ox + C::kNCo * c;
        if (col < d) dq[qoff + (size_t)row * d + col] = acc[i][c];
      }
  }
}

template <int DK>
__global__ void __launch_bounds__(F32Bwd<DK>::Dkv::kThreads, 1)
attn_f32_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
                        int d, float scale) {
  using C = typename F32Bwd<DK>::Dkv;
  constexpr int kT = C::kThreads, kRM = C::kRM, kCN = C::kCN, kRO = C::kRO,
                kCO = C::kCO, kP = C::kP, kPP = C::kPP, kBN = C::kBN,
                kStages = F32Bwd<DK>::kDkvStages;
  constexpr int kStage = 2 * kBN * kP + 2 * kBN;  // q, dO, lse, delta

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);  // 64 x kP
  float* v_s = k_s + 64 * kP;                        // 64 x kP
  float* pt_s = v_s + 64 * kP;                       // 64 x kPP: kv rows by q columns
  float* dst_s = pt_s + 64 * kPP;                    // 64 x kPP
  float* stages = dst_s + 64 * kPP;                  // kStages x kStage

  const int bh = blockIdx.y, kv0 = blockIdx.x * 64, tid = threadIdx.x;
  const int ty = tid / C::kNC, tx = tid % C::kNC;
  const int oy = tid / C::kNCo, ox = tid % C::kNCo;
  const float s_log2 = scale * e4t::kLog2e;
  const size_t qoff = (size_t)bh * sq * d, koff = (size_t)bh * sk * d;
  const float* lse_h = lse + (size_t)bh * sq;
  const float* dl_h = delta + (size_t)bh * sq;
  const int n_tiles = (sq + kBN - 1) / kBN;

  // q tile t (q, dO, lse, delta) into stage st
  auto load_tile = [&](int t, int st) {
    float* base = stages + st * kStage;
    const int r0 = t * kBN;
    load_f4_async<kBN, DK, kT>(base, q + qoff, r0, sq, d, tid);
    load_f4_async<kBN, DK, kT>(base + kBN * kP, dout + qoff, r0, sq, d, tid);
    for (int i = tid; i < kBN; i += kT) {
      const bool ok = r0 + i < sq;
      e4t::cp_async_4(base + 2 * kBN * kP + i, ok ? lse_h + r0 + i : lse_h, ok ? 4 : 0);
      e4t::cp_async_4(base + 2 * kBN * kP + kBN + i, ok ? dl_h + r0 + i : dl_h,
                      ok ? 4 : 0);
    }
    e4t::cp_async_commit();
  };
  load_f4_async<64, DK, kT>(k_s, k + koff, kv0, sk, d, tid);
  load_f4_async<64, DK, kT>(v_s, v + koff, kv0, sk, d, tid);
  load_tile(0, 0);

  float gk[kRO][kCO], gv[kRO][kCO];
#pragma unroll
  for (int i = 0; i < kRO; ++i)
#pragma unroll
    for (int c = 0; c < kCO; ++c) gk[i][c] = gv[i][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kBN, st = kStages == 2 ? t & 1 : 0;
    const float* q_t = stages + st * kStage;
    const float* do_t = q_t + kBN * kP;
    const float* lse_t = do_t + kBN * kP;
    const float* dl_t = lse_t + kBN;
    e4t::cp_async_wait<0>();
    __syncthreads();  // tile t landed; every thread is done with tile t - 1
    if (kStages == 2 && t + 1 < n_tiles) load_tile(t + 1, st ^ 1);
    float s[kRM][kCN], dp[kRM][kCN];
    f32_scores<C>(s, k_s, q_t, ty, tx);
    f32_scores<C>(dp, v_s, do_t, ty, tx);
#pragma unroll
    for (int j = 0; j < kCN; ++j) {
      const int qc = tx + C::kNC * j;
      const bool valid = q0 + qc < sq;
      const float l2 = lse_t[qc] * e4t::kLog2e, dlt = dl_t[qc];
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const float p = valid ? e4t::exp2_approx(fmaf(s[i][j], s_log2, -l2)) : 0.f;
        pt_s[(ty + C::kNR * i) * kPP + qc] = p;
        dst_s[(ty + C::kNR * i) * kPP + qc] = p * (dp[i][j] - dlt) * scale;
      }
    }
    __syncthreads();  // P^T and dS^T landed
    const int n_end = min(kBN, (sq - q0 + 3) & ~3);
    f32_pv<C, kPP>(gv, pt_s, do_t, oy, ox, n_end);
    f32_pv<C, kPP>(gk, dst_s, q_t, oy, ox, n_end);
    if (kStages == 1 && t + 1 < n_tiles) {
      __syncthreads();  // every thread is done with the tile
      load_tile(t + 1, 0);
    }
  }

#pragma unroll
  for (int i = 0; i < kRO; ++i) {
    const int row = kv0 + oy + C::kNRo * i;
    if (row < sk)
#pragma unroll
      for (int c = 0; c < kCO; ++c) {
        const int col = ox + C::kNCo * c;
        if (col < d) {
          dk[koff + (size_t)row * d + col] = gk[i][c];
          dv[koff + (size_t)row * d + col] = gv[i][c];
        }
      }
  }
}

template <int DK>
int launch_f32_bwd(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, void* dk, void* dv, int bh,
                   int sq, int sk, int d, float scale, cudaStream_t stream) {
  using B = F32Bwd<DK>;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  constexpr size_t smem_dq = B::kDqSmem;
  cudaError_t err = e4t::allow_smem(attn_f32_bwd_dq_kernel<DK>, smem_dq);
  if (err != cudaSuccess) return (int)err;
  attn_f32_bwd_dq_kernel<DK><<<dim3((sq + 63) / 64, bh), B::Dq::kThreads, smem_dq, stream>>>(
      qf, kf, vf, df, lf, dl, static_cast<float*>(dq), sq, sk, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr size_t smem_kv = B::kDkvSmem;
  err = e4t::allow_smem(attn_f32_bwd_dkv_kernel<DK>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  attn_f32_bwd_dkv_kernel<DK><<<dim3((sk + 63) / 64, bh), B::Dkv::kThreads, smem_kv,
                                stream>>>(qf, kf, vf, df, lf, dl, static_cast<float*>(dk),
                                          static_cast<float*>(dv), sq, sk, d, scale);
  return (int)cudaGetLastError();
}

template <typename QK, int DK, bool kSinglePass>
int launch_fwd(const void* q, const void* k, const void* v, const void* sc, float scale,
               void* out, void* lse, int bh, int sq, int sk, int d, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<QK, DK>();
  auto kernel = attn_fwd_f32_sync_kernel<QK, DK, kSinglePass>;
  const cudaError_t err = e4t::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + tile_rows<DK>() - 1) / tile_rows<DK>(), bh);
  kernel<<<grid, kT, smem, stream>>>(
      static_cast<const QK*>(q), static_cast<const QK*>(k), static_cast<const float*>(v),
      static_cast<const float*>(sc), scale, static_cast<float*>(out),
      static_cast<float*>(lse), sq, sk, d);
  return (int)cudaGetLastError();
}

template <int DK>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk, void* dv, int bh,
               int sq, int sk, int d, float scale, cudaStream_t stream) {
  constexpr int kB = tile_rows<DK>();
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  constexpr size_t smem_dq = bwd_dq_smem_bytes<DK>();
  cudaError_t err = e4t::allow_smem(attn_bwd_dq_sync_kernel<DK>, smem_dq);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_sync_kernel<DK><<<dim3((sq + kB - 1) / kB, bh), kT, smem_dq, stream>>>(
      qf, kf, vf, df, lf, dl, static_cast<float*>(dq), sq, sk, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr size_t smem_kv = bwd_dkdv_smem_bytes<DK>();
  err = e4t::allow_smem(attn_bwd_dkv_sync_kernel<DK>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_sync_kernel<DK><<<dim3((sk + kB - 1) / kB, bh), kT, smem_kv, stream>>>(
      qf, kf, vf, df, lf, dl, static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, d,
      scale);
  return (int)cudaGetLastError();
}

template <int N>
using Dk = std::integral_constant<int, N>;

// f(Dk<DK>{}) for the padded head dim of d up to 128
template <typename F>
int with_dk_low(int d, F&& f) {
  switch (e4t::padded_head_dim(d)) {
    case 16: return f(Dk<16>{});
    case 32: return f(Dk<32>{});
    case 48: return f(Dk<48>{});
    case 64: return f(Dk<64>{});
    case 80: return f(Dk<80>{});
    case 96: return f(Dk<96>{});
    case 112: return f(Dk<112>{});
    case 128: return f(Dk<128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// the same up to 256
template <typename F>
int with_dk(int d, F&& f) {
  switch (e4t::padded_head_dim(d)) {
    case 160: return f(Dk<160>{});
    case 192: return f(Dk<192>{});
    case 224: return f(Dk<224>{});
    case 256: return f(Dk<256>{});
    default: return with_dk_low(d, f);
  }
}

// f(Dk<DK>{}) for the redesigned kernels' head dim of d (f32_head_dim) up
// to 128
template <typename F>
int with_dk8_low(int d, F&& f) {
  switch (f32_head_dim(d)) {
    case 8: return f(Dk<8>{});
    case 16: return f(Dk<16>{});
    case 24: return f(Dk<24>{});
    case 32: return f(Dk<32>{});
    case 40: return f(Dk<40>{});
    case 48: return f(Dk<48>{});
    case 56: return f(Dk<56>{});
    case 64: return f(Dk<64>{});
    case 72: return f(Dk<72>{});
    case 80: return f(Dk<80>{});
    case 88: return f(Dk<88>{});
    case 96: return f(Dk<96>{});
    case 104: return f(Dk<104>{});
    case 112: return f(Dk<112>{});
    case 120: return f(Dk<120>{});
    case 128: return f(Dk<128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// the same up to 256
template <typename F>
int with_dk8(int d, F&& f) {
  switch (f32_head_dim(d)) {
    case 160: return f(Dk<160>{});
    case 192: return f(Dk<192>{});
    case 224: return f(Dk<224>{});
    case 256: return f(Dk<256>{});
    default: return with_dk8_low(d, f);
  }
}

bool bad_shape(int bh, int sq, int sk, int d, int max_d) {
  return bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0 || d <= 0 || d % 8 != 0 || d > max_d;
}

}  // namespace

// Plain C entry points for ctypes. Every tensor is contiguous and 16-byte
// aligned: f32 q/out (BH, Sq, D), k/v (BH, Sk, D), lse and delta (BH, Sq);
// int8 q/k in e4t_attn_fwd_int8_qk_f32, with sc (BH, 2) f32. D is a multiple
// of 8, up to 256 (flash forward and backward), 128 (short-sequence) or 120
// (int8). Each runs on ``stream``, allocates nothing, does not synchronise
// and returns cudaGetLastError() after its launches.
#if E4T_IN_PART(1)
extern "C" int e4t_attn_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                void* lse, int bh, int sq, int sk, int d, float scale,
                                void* stream) {
  if (bad_shape(bh, sq, sk, d, 256)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dk8(d, [&](auto dk) {
    return launch_f32_fwd<decltype(dk)::value, false>(q, k, v, scale, out, lse, bh, sq, sk,
                                                      d, s);
  });
}
#endif

#if E4T_IN_PART(3)
extern "C" int e4t_attn_fwd_shortseq_f32(const void* q, const void* k, const void* v,
                                         void* out, int bh, int s_len, int d, float scale,
                                         void* stream) {
  if (bad_shape(bh, s_len, s_len, d, 128)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dk8_low(d, [&](auto dk) {
    return launch_f32_short<decltype(dk)::value>(q, k, v, scale, out, bh, s_len, d, s);
  });
}
#endif

#if E4T_IN_PART(5)
extern "C" int e4t_attn_fwd_int8_qk_f32(const void* q, const void* k, const void* v,
                                        const void* sc, void* out, void* lse, int bh,
                                        int sq, int sk, int d, void* stream) {
  if (bad_shape(bh, sq, sk, d, 120)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dk8_low(d, [&](auto dk) {
    return launch_f32_fwd_int8<decltype(dk)::value>(q, k, v, sc, out, lse, bh, sq, sk, s);
  });
}
#endif

// The synchronous design of the int8 "qk" attention
// (attn_fwd_f32_sync_kernel<int8_t, DK, false>), kept as its yardstick: the
// same arguments as e4t_attn_fwd_int8_qk_f32.
#if E4T_IN_PART(4)
extern "C" int e4t_attn_fwd_int8_qk_f32_sync(const void* q, const void* k, const void* v,
                                             const void* sc, void* out, void* lse, int bh,
                                             int sq, int sk, int d, void* stream) {
  if (bad_shape(bh, sq, sk, d, 120)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dk_low(d, [&](auto dk) {
    return launch_fwd<int8_t, decltype(dk)::value, false>(q, k, v, sc, 0.f, out, lse, bh,
                                                          sq, sk, d, s);
  });
}
#endif

#if E4T_IN_PART(2)
extern "C" int e4t_attn_bwd_f32(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, void* dk, void* dv, int bh, int sq, int sk, int d,
                                float scale, void* stream) {
  if (bad_shape(bh, sq, sk, d, 256)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dk8(d, [&](auto dkc) {
    return launch_f32_bwd<decltype(dkc)::value>(q, k, v, dout, lse, delta, dq, dk, dv, bh,
                                                sq, sk, d, scale, s);
  });
}
#endif

// The synchronous designs the redesigned kernels replaced (4 x 4 score
// blocks of scalar shared loads, tiles staged between two block barriers,
// D padded to 16 / 32), kept as their yardsticks: the same arguments as
// the entry points above.
#if E4T_IN_PART(4)
extern "C" int e4t_attn_fwd_f32_sync(const void* q, const void* k, const void* v,
                                     void* out, void* lse, int bh, int sq, int sk, int d,
                                     float scale, void* stream) {
  if (bad_shape(bh, sq, sk, d, 256)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dk(d, [&](auto dk) {
    return launch_fwd<float, decltype(dk)::value, false>(q, k, v, nullptr, scale, out, lse,
                                                         bh, sq, sk, d, s);
  });
}

extern "C" int e4t_attn_fwd_shortseq_f32_sync(const void* q, const void* k, const void* v,
                                              void* out, int bh, int s_len, int d,
                                              float scale, void* stream) {
  if (bad_shape(bh, s_len, s_len, d, 128)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dk_low(d, [&](auto dk) {
    return launch_fwd<float, decltype(dk)::value, true>(q, k, v, nullptr, scale, out,
                                                        nullptr, bh, s_len, s_len, d, s);
  });
}

extern "C" int e4t_attn_bwd_f32_sync(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, void* dk, void* dv, int bh, int sq, int sk,
                                     int d, float scale, void* stream) {
  if (bad_shape(bh, sq, sk, d, 256)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dk(d, [&](auto dkc) {
    return launch_bwd<decltype(dkc)::value>(q, k, v, dout, lse, delta, dq, dk, dv, bh, sq,
                                            sk, d, scale, s);
  });
}
#endif
