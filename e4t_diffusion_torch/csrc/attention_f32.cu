// f32 attention for Hopper (sm_90a): the flash forward, the flash backward,
// the short-sequence forward and the int8 attention in "qk" mode, each in
// full f32 on the CUDA cores (FFMA; no TF32, whose 10-bit mantissa the plain
// versions and the CPU do not have).
//
// Replaces, for f32 operands, the TPU kernels of
// e4t_diffusion_tpu/ops/flash_kernels.py that write in q's dtype:
//   - _flash_fwd_lowdim (:286), _flash_fwd_kvres (:196) and _flash_fwd
//     (:95): attn_fwd_f32_kernel<float, DK, false>, out and lse = m + log(l);
//   - _flash_bwd_resident (:503) and _flash_bwd (:582): attn_bwd_dq_kernel and
//     attn_bwd_dkdv_kernel, p = exp(s - lse), ds = p (dP - delta) scale;
//   - _flash_fwd_shortseq_mh (:896): attn_fwd_f32_kernel<float, DK, true>, the
//     single-pass softmax (the row max over the whole kv row first, no
//     rescaling) and the division by l after P@V;
//   - _flash_fwd_lowdim_int8 (:813) in "qk" mode with an f32 v:
//     attn_fwd_f32_kernel<int8_t, DK, false>, the int8 scores exact in int32
//     (__dp4a) times the head's qk_c, P@V in f32, out = acc / l * v_c.
// With f32 p nothing is rounded before P@V, so these compute the plain
// versions' function with f32 sums in another order.
//
// What bounds them on the H100: f32 outside the tensor cores peaks at 67
// TFLOP/s, so at the UNet's 4096-token d=40 sites (BH=64) the 4*Sq*Sk*D flops
// of the forward alone take 2.6 ms at peak, the exponentials 0.26 ms and the
// bytes 0.06 ms: FFMA bounds every one of them. The design is simple and
// right first, not fast: one block of 256 threads (a 16 x 16 grid) per tile of
// 64 rows (32 from DK = 160 up, for shared memory), every operand tile staged
// in shared memory with an odd row pitch (so the 16 rows a half-warp reads in
// a score product fall in distinct banks), each thread holding a 4 x 4 block
// of scores (rows 4 ty.., columns tx + 16 j) and 4 rows x DK/16 columns of
// the output; row maxima and sums reduce across the 16 threads of a half-warp
// by shuffles. D is zero-padded in shared memory to DK (the next multiple of
// 16 up to 128, of 32 above) and ragged Sq and Sk are masked here, so the
// host passes unpadded tensors. Softmaxes run in the log2 domain (the scale
// times log2 e folded into one multiply, then exp2).

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

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

// max and sum over the 16 threads of a half-warp (one row's columns)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
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
attn_fwd_f32_kernel(const QK* __restrict__ q, const QK* __restrict__ k,
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
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
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
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
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

template <typename QK, int DK, bool kSinglePass>
int launch_fwd(const void* q, const void* k, const void* v, const void* sc, float scale,
               void* out, void* lse, int bh, int sq, int sk, int d, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<QK, DK>();
  auto kernel = attn_fwd_f32_kernel<QK, DK, kSinglePass>;
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
  cudaError_t err = e4t::allow_smem(attn_bwd_dq_kernel<DK>, smem_dq);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_kernel<DK><<<dim3((sq + kB - 1) / kB, bh), kT, smem_dq, stream>>>(
      qf, kf, vf, df, lf, dl, static_cast<float*>(dq), sq, sk, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr size_t smem_kv = bwd_dkdv_smem_bytes<DK>();
  err = e4t::allow_smem(attn_bwd_dkdv_kernel<DK>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_kernel<DK><<<dim3((sk + kB - 1) / kB, bh), kT, smem_kv, stream>>>(
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
extern "C" int e4t_attn_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                void* lse, int bh, int sq, int sk, int d, float scale,
                                void* stream) {
  if (bad_shape(bh, sq, sk, d, 256)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dk(d, [&](auto dk) {
    return launch_fwd<float, decltype(dk)::value, false>(q, k, v, nullptr, scale, out, lse,
                                                         bh, sq, sk, d, s);
  });
}

extern "C" int e4t_attn_fwd_shortseq_f32(const void* q, const void* k, const void* v,
                                         void* out, int bh, int s_len, int d, float scale,
                                         void* stream) {
  if (bad_shape(bh, s_len, s_len, d, 128)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dk_low(d, [&](auto dk) {
    return launch_fwd<float, decltype(dk)::value, true>(q, k, v, nullptr, scale, out,
                                                        nullptr, bh, s_len, s_len, d, s);
  });
}

extern "C" int e4t_attn_fwd_int8_qk_f32(const void* q, const void* k, const void* v,
                                        const void* sc, void* out, void* lse, int bh,
                                        int sq, int sk, int d, void* stream) {
  if (bad_shape(bh, sq, sk, d, 120)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dk_low(d, [&](auto dk) {
    return launch_fwd<int8_t, decltype(dk)::value, false>(q, k, v, sc, 0.f, out, lse, bh,
                                                          sq, sk, d, s);
  });
}

extern "C" int e4t_attn_bwd_f32(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, void* dk, void* dv, int bh, int sq, int sk, int d,
                                float scale, void* stream) {
  if (bad_shape(bh, sq, sk, d, 256)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dk(d, [&](auto dkc) {
    return launch_bwd<decltype(dkc)::value>(q, k, v, dout, lse, delta, dq, dk, dv, bh, sq,
                                            sk, d, scale, s);
  });
}
