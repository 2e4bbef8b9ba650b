// Flash-attention backward for Hopper (sm_90a): (dq, dk, dv) of non-causal
// softmax attention, bf16 in and out, f32 accumulation.
//
// Replaces the TPU kernels of e4t_diffusion_tpu/ops/flash_kernels.py:
// _flash_bwd_resident (dq with k/v resident, dk/dv with q/dO/lse/delta
// resident; bodies _flash_bwd_dq_kvres_kernel and _flash_bwd_dkv_qres_kernel)
// and _flash_bwd's blocked (bh, nq, nk) grids (_flash_bwd_dq_kernel,
// _flash_bwd_dkv_kernel). The residency split is a VMEM fact: here the inner
// operands always stream through shared memory, which computes what both
// variants compute, at any length. Formulas, per (q row i, kv row j):
//   p = exp(s - lse_i), s = q_i . k_j * scale
//   dP = dO_i . v_j,  ds = p * (dP - delta_i) * scale
//   dv_j += p dO_i,  dk_j += ds q_i,  dq_i += ds k_j
// with delta = rowsum(out * dO) computed by the caller (plain PyTorch, as the
// TPU path leaves it to XLA). p and ds are rounded to bf16 before their
// products, as in the TPU kernels.
//
// Design: two kernels, as the TPU's resident design has two, so no atomics
// are needed and the result is deterministic.
// - dq: one block of 4 warps per (bh, 64-row q tile); each warp owns 16 q
//   rows and loops over kv tiles, recomputing S and dP.
// - dk/dv: one block per (bh, 64-row kv tile); each warp owns 16 kv rows and
//   loops over q tiles, computing the transposed S^T = k q^T and
//   dP^T = v dO^T, so p^T and ds^T land in registers in the A-fragment
//   layout of the dv and dk products.
// Every product runs on mma.sync m16n8k16. q/dO (dq) and k/v (dk/dv) stay in
// shared memory and their A fragments are reloaded per k-step, which keeps
// the f32 accumulators (DK/8 x 4 per output) in registers. Operands used as
// the B side of the dq, dk and dv products (k, q, dO) are also staged
// transposed, so every B fragment is one 32-bit load. D is zero-padded to the
// mma granularity in shared memory only (40 -> 48, 80 and 160 stay); ragged
// Sq and Sk are masked in the kernels (p = 0 past Sk; lse = +inf past Sq).
// For D > 128 the dk/dv accumulators are split over gridDim.z column halves
// (S^T and dP^T recomputed per half), and the inner tile is 32 rows for
// D > 64, both to stay inside 255 registers without spills.
//
// What bounds it on the H100: the function needs five products (S, dP, dq,
// dk, dv), 10*BH*Sq*Sk*D tensor-core flops, and BH*Sq*Sk exponentials; at
// the UNet's 4096-token d=40 sites at BH=128 that is ~0.87 ms of bf16 peak
// and ~0.51 ms of the special-function units, far above the ~0.2 ms of
// traffic. This design does more: S and dP are recomputed in both kernels,
// 14*BH*Sq*Sk*D flops and 2*BH*Sq*Sk exponentials, one cause of its distance
// from that bound.

#include <math.h>

#include "flash_common.cuh"

namespace {

using e4t::bf16;
using e4t::kThreads;

constexpr int kBlockM = 64;  // q rows (dq) or kv rows (dk/dv) per block

template <int DK>
struct Tiles {
  static constexpr int kInner = DK <= 64 ? 64 : 32;       // rows per inner tile
  static constexpr int kChunk = DK <= 128 ? DK : DK / 2;  // dk/dv columns per block
  static constexpr int kPitch = DK + 8;
  static constexpr int kTPitch = kInner + 8;
  static constexpr size_t dq_smem =
      sizeof(bf16) * (2 * kBlockM * kPitch + 2 * kInner * kPitch + DK * kTPitch);
  static constexpr size_t dkv_smem =
      sizeof(bf16) * (2 * kBlockM * kPitch + 2 * kInner * kPitch + 2 * kChunk * kTPitch) +
      sizeof(float) * 2 * kInner;
};

template <int DK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int sq, int sk, int d, float scale,
                    float scale_log2) {
  using T = Tiles<DK>;
  constexpr int BN = T::kInner;
  constexpr int kPitch = T::kPitch;
  constexpr int kTPitch = T::kTPitch;
  constexpr int kSteps = DK / 16;
  constexpr int kScoreTiles = BN / 8;
  constexpr int kOutTiles = DK / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // kBlockM x kPitch
  bf16* do_s = q_s + kBlockM * kPitch;             // kBlockM x kPitch
  bf16* k_s = do_s + kBlockM * kPitch;             // BN x kPitch
  bf16* v_s = k_s + BN * kPitch;                   // BN x kPitch
  bf16* kt_s = v_s + BN * kPitch;                  // DK x kTPitch (k transposed)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int qr = warp * 16;

  const size_t qoff = (size_t)bh * sq * d;
  const bf16* kb = k + (size_t)bh * sk * d;
  const bf16* vb = v + (size_t)bh * sk * d;
  e4t::stage_tile<kBlockM, DK>(q_s, kPitch, nullptr, 0, 0, 0, q + qoff, q0, sq, d, tid);
  e4t::stage_tile<kBlockM, DK>(do_s, kPitch, nullptr, 0, 0, 0, dout + qoff, q0, sq, d, tid);

  // rows g and g + 8 of the warp: lse in the log2 domain (+inf past Sq, so
  // p = 0 there) and delta
  const int row0 = q0 + qr + g, row1 = row0 + 8;
  const float lse0 = row0 < sq ? lse[(size_t)bh * sq + row0] * e4t::kLog2e : INFINITY;
  const float lse1 = row1 < sq ? lse[(size_t)bh * sq + row1] * e4t::kLog2e : INFINITY;
  const float dl0 = row0 < sq ? delta[(size_t)bh * sq + row0] : 0.f;
  const float dl1 = row1 < sq ? delta[(size_t)bh * sq + row1] : 0.f;

  float acc[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kv0 = 0; kv0 < sk; kv0 += BN) {
    __syncthreads();  // every warp is done with the previous tile
    e4t::stage_tile<BN, DK>(k_s, kPitch, kt_s, kTPitch, 0, DK, kb, kv0, sk, d, tid);
    e4t::stage_tile<BN, DK>(v_s, kPitch, nullptr, 0, 0, 0, vb, kv0, sk, d, tid);
    __syncthreads();

    float s[kScoreTiles][4], dp[kScoreTiles][4];
#pragma unroll
    for (int n = 0; n < kScoreTiles; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      uint32_t a[4], b[4];
      e4t::load_a(a, q_s, kPitch, qr, st * 16, g, t4);
      e4t::load_a(b, do_s, kPitch, qr, st * 16, g, t4);
#pragma unroll
      for (int n = 0; n < kScoreTiles; ++n) {
        e4t::mma_bt(s[n], a, k_s, kPitch, n * 8, st * 16, g, t4);   // S = q k^T
        e4t::mma_bt(dp[n], b, v_s, kPitch, n * 8, st * 16, g, t4);  // dP = dO v^T
      }
    }

    // ds in the accumulator layout is the A-fragment layout of ds @ k
    uint32_t dsa[kScoreTiles / 2][4];
#pragma unroll
    for (int n = 0; n < kScoreTiles; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = kv0 + n * 8 + t4 * 2 + e < sk;
        const float p0 = valid ? exp2f(s[n][e] * scale_log2 - lse0) : 0.f;
        const float p1 = valid ? exp2f(s[n][2 + e] * scale_log2 - lse1) : 0.f;
        ds[e] = p0 * (dp[n][e] - dl0) * scale;
        ds[2 + e] = p1 * (dp[n][2 + e] - dl1) * scale;
      }
      dsa[n >> 1][(n & 1) * 2 + 0] = e4t::pack_bf16(ds[0], ds[1]);
      dsa[n >> 1][(n & 1) * 2 + 1] = e4t::pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int j = 0; j < kScoreTiles / 2; ++j)
#pragma unroll
      for (int n = 0; n < kOutTiles; ++n)
        e4t::mma_bt(acc[n], dsa[j], kt_s, kTPitch, n * 8, j * 16, g, t4);  // dq += ds k
  }

  bf16* dqb = dq + qoff;
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) {
    const int col = n * 8 + t4 * 2;
    if (col < d) {
      if (row0 < sq)
        *reinterpret_cast<uint32_t*>(&dqb[(size_t)row0 * d + col]) =
            e4t::pack_bf16(acc[n][0], acc[n][1]);
      if (row1 < sq)
        *reinterpret_cast<uint32_t*>(&dqb[(size_t)row1 * d + col]) =
            e4t::pack_bf16(acc[n][2], acc[n][3]);
    }
  }
}

template <int DK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                     int d, float scale, float scale_log2) {
  using T = Tiles<DK>;
  constexpr int BQ = T::kInner;
  constexpr int DC = T::kChunk;
  constexpr int kPitch = T::kPitch;
  constexpr int kTPitch = T::kTPitch;
  constexpr int kSteps = DK / 16;
  constexpr int kScoreTiles = BQ / 8;
  constexpr int kOutTiles = DC / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // kBlockM x kPitch
  bf16* v_s = k_s + kBlockM * kPitch;              // kBlockM x kPitch
  bf16* q_s = v_s + kBlockM * kPitch;              // BQ x kPitch
  bf16* do_s = q_s + BQ * kPitch;                  // BQ x kPitch
  bf16* qt_s = do_s + BQ * kPitch;                 // DC x kTPitch (q^T, this chunk)
  bf16* dot_s = qt_s + DC * kTPitch;               // DC x kTPitch (dO^T, this chunk)
  float* lse_s = reinterpret_cast<float*>(dot_s + DC * kTPitch);  // BQ
  float* dl_s = lse_s + BQ;                                        // BQ

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockM;
  const int c0 = blockIdx.z * DC;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int kr = warp * 16;

  const size_t koff = (size_t)bh * sk * d;
  const bf16* qb = q + (size_t)bh * sq * d;
  const bf16* dob = dout + (size_t)bh * sq * d;
  const float* lseb = lse + (size_t)bh * sq;
  const float* dlb = delta + (size_t)bh * sq;
  e4t::stage_tile<kBlockM, DK>(k_s, kPitch, nullptr, 0, 0, 0, k + koff, k0, sk, d, tid);
  e4t::stage_tile<kBlockM, DK>(v_s, kPitch, nullptr, 0, 0, 0, v + koff, k0, sk, d, tid);

  float adk[kOutTiles][4], adv[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) adk[n][i] = adv[n][i] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous tile
    e4t::stage_tile<BQ, DK>(q_s, kPitch, qt_s, kTPitch, c0, c0 + DC, qb, q0, sq, d, tid);
    e4t::stage_tile<BQ, DK>(do_s, kPitch, dot_s, kTPitch, c0, c0 + DC, dob, q0, sq, d, tid);
    for (int i = tid; i < BQ; i += kThreads) {
      const bool valid = q0 + i < sq;
      lse_s[i] = valid ? lseb[q0 + i] * e4t::kLog2e : INFINITY;
      dl_s[i] = valid ? dlb[q0 + i] : 0.f;
    }
    __syncthreads();

    float st[kScoreTiles][4], dpt[kScoreTiles][4];
#pragma unroll
    for (int n = 0; n < kScoreTiles; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t a[4], b[4];
      e4t::load_a(a, k_s, kPitch, kr, s * 16, g, t4);
      e4t::load_a(b, v_s, kPitch, kr, s * 16, g, t4);
#pragma unroll
      for (int n = 0; n < kScoreTiles; ++n) {
        e4t::mma_bt(st[n], a, q_s, kPitch, n * 8, s * 16, g, t4);    // S^T = k q^T
        e4t::mma_bt(dpt[n], b, do_s, kPitch, n * 8, s * 16, g, t4);  // dP^T = v dO^T
      }
    }

    // columns are q rows: each column carries its own lse and delta
    uint32_t pa[kScoreTiles / 2][4], dsa[kScoreTiles / 2][4];
#pragma unroll
    for (int n = 0; n < kScoreTiles; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + t4 * 2 + e;
        const float l = lse_s[c], dl = dl_s[c];
        p[e] = exp2f(st[n][e] * scale_log2 - l);
        p[2 + e] = exp2f(st[n][2 + e] * scale_log2 - l);
        ds[e] = p[e] * (dpt[n][e] - dl) * scale;
        ds[2 + e] = p[2 + e] * (dpt[n][2 + e] - dl) * scale;
      }
      pa[n >> 1][(n & 1) * 2 + 0] = e4t::pack_bf16(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = e4t::pack_bf16(p[2], p[3]);
      dsa[n >> 1][(n & 1) * 2 + 0] = e4t::pack_bf16(ds[0], ds[1]);
      dsa[n >> 1][(n & 1) * 2 + 1] = e4t::pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int j = 0; j < kScoreTiles / 2; ++j) {
#pragma unroll
      for (int n = 0; n < kOutTiles; ++n) {
        e4t::mma_bt(adv[n], pa[j], dot_s, kTPitch, n * 8, j * 16, g, t4);  // dv += p^T dO
        e4t::mma_bt(adk[n], dsa[j], qt_s, kTPitch, n * 8, j * 16, g, t4);  // dk += ds^T q
      }
    }
  }

  const int row0 = k0 + kr + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) {
    const int col = c0 + n * 8 + t4 * 2;
    if (col < d) {
      if (row0 < sk) {
        const size_t o = koff + (size_t)row0 * d + col;
        *reinterpret_cast<uint32_t*>(&dk[o]) = e4t::pack_bf16(adk[n][0], adk[n][1]);
        *reinterpret_cast<uint32_t*>(&dv[o]) = e4t::pack_bf16(adv[n][0], adv[n][1]);
      }
      if (row1 < sk) {
        const size_t o = koff + (size_t)row1 * d + col;
        *reinterpret_cast<uint32_t*>(&dk[o]) = e4t::pack_bf16(adk[n][2], adk[n][3]);
        *reinterpret_cast<uint32_t*>(&dv[o]) = e4t::pack_bf16(adv[n][2], adv[n][3]);
      }
    }
  }
}

template <int DK>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int bh, int sq, int sk, int d, float scale, cudaStream_t stream) {
  using T = Tiles<DK>;
  cudaError_t err = e4t::allow_smem(flash_bwd_dq_kernel<DK>, T::dq_smem);
  if (err == cudaSuccess) err = e4t::allow_smem(flash_bwd_dkv_kernel<DK>, T::dkv_smem);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = scale * e4t::kLog2e;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dlp = static_cast<const float*>(delta);
  flash_bwd_dq_kernel<DK><<<dim3((sq + kBlockM - 1) / kBlockM, bh), kThreads,
                            T::dq_smem, stream>>>(
      qp, kp, vp, dop, lp, dlp, static_cast<bf16*>(dq), sq, sk, d, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<DK><<<dim3((sk + kBlockM - 1) / kBlockM, bh, DK / T::kChunk),
                             kThreads, T::dkv_smem, stream>>>(
      qp, kp, vp, dop, lp, dlp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk,
      d, scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. q/dout/dq are (BH, Sq, D), k/v/dk/dv
// (BH, Sk, D), contiguous bf16, 16-byte aligned, D a multiple of 8 up to 256;
// lse and delta are contiguous (BH, Sq) f32. Launches the dq kernel, then the
// dk/dv kernel, on ``stream``; allocates nothing and does not synchronise.
// Returns cudaGetLastError() after the launches.
extern "C" int e4t_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             void* dq, void* dk, void* dv, int bh, int sq, int sk,
                             int d, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0 || d <= 0 || d % 8 != 0 || d > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define E4T_BWD_CASE(DK) \
  case DK: return launch<DK>(q, k, v, dout, lse, delta, dq, dk, dv, bh, sq, sk, d, scale, s);
  switch (e4t::padded_head_dim(d)) {
    E4T_BWD_CASE(16)
    E4T_BWD_CASE(32)
    E4T_BWD_CASE(48)
    E4T_BWD_CASE(64)
    E4T_BWD_CASE(80)
    E4T_BWD_CASE(96)
    E4T_BWD_CASE(112)
    E4T_BWD_CASE(128)
    E4T_BWD_CASE(160)
    E4T_BWD_CASE(192)
    E4T_BWD_CASE(224)
    E4T_BWD_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef E4T_BWD_CASE
}
