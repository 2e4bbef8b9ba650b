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
// are needed and the result is deterministic: every output element is one
// thread's f32 sum, taken in a fixed order, so two calls on the same inputs
// agree bit for bit. Both kernels recompute S and dP.
// - dq: one block per (bh, q tile); loops over kv tiles.
// - dk/dv: one block per (bh, kv tile); loops over q tiles, computing the
//   transposed S^T = k q^T and dP^T = v dO^T, so p^T and ds^T land in
//   registers in the A-fragment layout of the dv and dk products.
// D is zero-padded to the mma granularity in shared memory only (40 -> 48,
// 80 and 160 stay); ragged Sq and Sk are masked in the kernels (p = 0 past
// Sq, and past Sk where kv rows are the contraction; dk/dv rows past Sk are
// not stored), so the host passes unpadded tensors.
//
// Every DK runs on warpgroup MMA, on the building blocks of
// wgmma_common.cuh, each warpgroup owning 64 rows. Every tile sits in
// shared memory in the descriptors' core-matrix layout, filled by 16-byte
// cp.async, so no operand is ever transposed by a thread: one layout serves
// K-major (S, dP and their transposes: m64n64k16, both operands from shared
// memory) and MN-major (the B side of dq += ds k, dk += ds^T q, dv += p^T
// dO: m64nDKk16, two m64n(DK/2)k16 halves above DK 128, the A side from
// registers, where the score accumulator already lies in its fragment
// layout). The resident operands (q and dO for dq, k and v for dk/dv) are
// loaded once; the streamed ones pass through a cp.async ring that every
// warpgroup of the block reads, tiles j + 1 and j + 2 landing while tile j
// is computed, with one block barrier a tile; the more warpgroups share a
// tile, the faster (PERF.md), so registers and shared memory set their
// number.
// - dq (flash_bwd_dq_wgmma_kernel, every DK): dq_groups<DK>() warpgroups of
//   q rows a block (4 up to DK 64, 3 up to 112, 2 up to 224, 1 at 256), lse
//   and delta per row in registers, a k/v ring of dq_stages<DK>() stages (4,
//   3 at DK 160, 2 from 192).
// - dk/dv up to DK 112 (flash_bwd_dkv_wgmma_kernel): dkv_groups<DK>()
//   warpgroups of kv rows a block (3 up to DK 64, 2 above), or 1 where that
//   would leave fewer than two blocks an SM (Sk = 77 at the cross-attention
//   sites); a 3-stage ring of q, dO and each tile's lse and delta (4-byte
//   cp.async: a head's lse row need not be 16-byte aligned).
// - dk/dv from DK 128 (flash_bwd_dkv_pair_wgmma_kernel): dk and dv together
//   (DK f32 a thread) beside S^T and dP^T do not fit 255 registers, so a
//   pair of warpgroups shares each block's 64 kv rows: warpgroup 0 computes
//   S^T, p^T and dv, warpgroup 1 dP^T, ds^T and dk, with p^T handed over in
//   shared memory under a named barrier. Each product is computed once and
//   each q/dO tile feeds both halves; the ring holds 3 stages, 2 at DK 224
//   and 256.
// All take p by one fma and one ex2 and add the 16-row k-steps in the
// synchronous design's order, so at every shape measured they return its
// results bit for bit.
//
// The synchronous design (flash_bwd_dq_kernel, flash_bwd_dkv_kernel, which
// served every DK before the wgmma kernels): 4 warps of 16 rows a block of
// 64, mma.sync m16n8k16; the streamed tile staged through registers into
// shared memory between two barriers, B operands (k, q, dO) also stored
// transposed by 2-byte stores so every B fragment is one 32-bit load. For D
// > 128 the dk/dv accumulators are split over gridDim.z column halves (S^T
// and dP^T recomputed per half), and the inner tile is 32 rows for D > 64,
// both to stay inside 255 registers without spills. No path launches it:
// it is exported at every DK as e4t_flash_bwd_sync, the yardstick the
// wgmma kernels are timed and checked against.
//
// What bounds it on the H100: the function needs five products (S, dP, dq,
// dk, dv), 10*BH*Sq*Sk*D tensor-core flops, and BH*Sq*Sk exponentials; at
// the UNet's 4096-token d=40 sites at BH=128 that is ~0.87 ms of bf16 peak
// and ~0.51 ms of the special-function units, far above the ~0.2 ms of
// traffic. Both designs do more: S and dP are recomputed in both kernels,
// 14*BH*Sq*Sk*D flops and 2*BH*Sq*Sk exponentials, and D is padded to DK.
// The wgmma design takes 5.1 ms there (the dk/dv kernel 2.8, the dq kernel
// 1.8; the synchronous one 10.8; PERF.md, on an H100 80GB HBM3 at 700 W).
// At d=160 (BH 2, 8192 tokens) it takes 1.3 ms (dk/dv 0.82, dq 0.41; the
// synchronous one 5.2) against 0.22 ms of bf16 peak: the dk/dv kernel's
// streamed q/dO loads bound it (46% faster without them), not the
// exponentials (5%), as at d=40 (28% and 10%).

#include <math.h>

#include "flash_common.cuh"
#include "wgmma_common.cuh"

namespace {

using e4t::bf16;
using e4t::exp2_approx;
using e4t::fence_proxy_async;
using e4t::fence_regs;
using e4t::kThreads;
using e4t::smem_desc;
using e4t::wgmma_commit;
using e4t::wgmma_fence;
using e4t::wgmma_rs_tile;
using e4t::wgmma_ss_n64;
using e4t::wgmma_wait;

constexpr int kSMs = 132;  // streaming multiprocessors of an H100 SXM

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

// ---- warpgroup MMA (wgmma) fed by cp.async rings ----

constexpr int kTileQ = 64;      // q rows of a streamed tile in the dk/dv kernel
constexpr int kDkvStages = 3;   // q/dO ring depth: tiles j + 1 and j + 2 in flight

// bytes of one dk/dv ring stage: q and dO tiles in the core-matrix layout,
// then the tile's 64 lse and 64 delta values
template <int DK>
__host__ __device__ constexpr int dkv_stage_bytes() {
  return 2 * kTileQ * DK * 2 + 2 * kTileQ * 4;
}

// kv warpgroups a dk/dv block where Sk fills the card: they share each q
// tile; S^T, dP^T and the dk and dv accumulators take 147-163 registers a
// thread up to DK = 64, so 3 warpgroups (168 a thread), 2 above
template <int DK>
constexpr int dkv_groups() { return DK <= 64 ? 3 : 2; }

template <int DK, int NWG>
constexpr size_t dkv_wgmma_smem() {
  return (size_t)2 * (64 * NWG) * DK * 2 + (size_t)kDkvStages * dkv_stage_bytes<DK>();
}

// q tile t (and its dO tile, lse and delta) into a ring stage; lse and delta
// rows past Sq read nothing and hold 0 (the kernel masks those columns)
template <int DK, int THREADS>
__device__ __forceinline__ void load_dkv_stage(unsigned char* st, const bf16* qb,
                                               const bf16* dob, const float* lseb,
                                               const float* dlb, int t, int sq, int d,
                                               int tid) {
  constexpr int kTile = kTileQ * DK * 2;
  e4t::load_core_async<kTileQ, DK, THREADS>(st, qb, t * kTileQ, sq, d, tid);
  e4t::load_core_async<kTileQ, DK, THREADS>(st + kTile, dob, t * kTileQ, sq, d, tid);
  float* rows = reinterpret_cast<float*>(st + 2 * kTile);  // lse[64], then delta[64]
  for (int i = tid; i < 2 * kTileQ; i += THREADS) {
    const int r = t * kTileQ + (i & (kTileQ - 1));
    const bool in = r < sq;
    e4t::cp_async_4(rows + i, (i < kTileQ ? lseb : dlb) + (in ? r : 0), in ? 4 : 0);
  }
}

// dk and dv of NWG * 64 kv rows a block, one warpgroup per 64 rows; k and v
// stay in shared memory, q, dO, lse and delta stream through a ring of
// kDkvStages tiles of 64 q rows that every warpgroup of the block reads.
// Per tile each warpgroup issues S^T = K Q^T and dP^T = V dO^T (m64n64k16,
// both operands K-major in shared memory), waits, forms p^T and ds^T in
// registers (their accumulator layout is the A-fragment layout of the next
// products), issues dv += p^T dO and dk += ds^T q (m64nDKk16, dO and q read
// MN-major by the descriptor) and waits; one block barrier a tile frees the
// stage of tile j - 1 for tile j - 1 + kDkvStages.
template <int DK, int NWG>
__global__ void __launch_bounds__(128 * NWG)
flash_bwd_dkv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
                           int d, float scale, float scale_log2) {
  constexpr int kT = 128 * NWG;
  constexpr int kC = DK / 8;        // 16-byte chunks per row
  constexpr int kGroup = kC * 128;  // bytes of 8 rows
  constexpr int kBM = 64 * NWG;     // kv rows a block
  constexpr int kTile = kTileQ * DK * 2;
  constexpr int kStage = dkv_stage_bytes<DK>();
  constexpr int kSteps = DK / 16;
  constexpr int kOut = DK / 2;  // f32 accumulators a thread, per output

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* k_s = smem_raw;             // kBM rows
  unsigned char* v_s = k_s + kBM * DK * 2;   // kBM rows
  unsigned char* ring = v_s + kBM * DK * 2;  // kDkvStages stages

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wi = (tid >> 5) & 3;  // warp of the warpgroup: its 16 rows
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const size_t koff = (size_t)bh * sk * d;
  const bf16* qb = q + (size_t)bh * sq * d;
  const bf16* dob = dout + (size_t)bh * sq * d;
  const float* lseb = lse + (size_t)bh * sq;
  const float* dlb = delta + (size_t)bh * sq;
  const int n_tiles = (sq + kTileQ - 1) / kTileQ;

  // prologue: k and v, then tiles 0 .. kDkvStages - 2, one group each
  e4t::load_core_async<kBM, DK, kT>(k_s, k + koff, k0, sk, d, tid);
  e4t::load_core_async<kBM, DK, kT>(v_s, v + koff, k0, sk, d, tid);
  e4t::cp_async_commit();
#pragma unroll
  for (int t = 0; t < kDkvStages - 1; ++t) {
    if (t < n_tiles)
      load_dkv_stage<DK, kT>(ring + t * kStage, qb, dob, lseb, dlb, t, sq, d, tid);
    e4t::cp_async_commit();
  }
  e4t::cp_async_wait<kDkvStages - 2>();  // k, v and tile 0 have landed
  fence_proxy_async();
  __syncthreads();

  const unsigned char* k_wg = k_s + wg * 8 * kGroup;  // the warpgroup's 64 rows
  const unsigned char* v_wg = v_s + wg * 8 * kGroup;
  float adk[kOut], adv[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) adk[i] = adv[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    // refill the stage tile j - 1 used: every warpgroup left it at the
    // barrier that ended the last iteration
    const int nxt = j + kDkvStages - 1;
    if (nxt < n_tiles)
      load_dkv_stage<DK, kT>(ring + (nxt % kDkvStages) * kStage, qb, dob, lseb, dlb, nxt,
                             sq, d, tid);
    e4t::cp_async_commit();  // possibly empty: the group count stays uniform
    const unsigned char* qs = ring + (j % kDkvStages) * kStage;
    const unsigned char* dos = qs + kTile;
    const float* lse_s = reinterpret_cast<const float*>(qs + 2 * kTile);
    const float* dl_s = lse_s + kTileQ;

    // S^T and dP^T, the warpgroup's 64 kv rows x the tile's 64 q rows;
    // s[4n + e]: kv rows g (e < 2) and g + 8 of the warp's 16, q column
    // 8n + 2 t4 + (e & 1)
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < kSteps; ++st)
      wgmma_ss_n64(s, smem_desc(k_wg + st * 256, 128, kGroup),
                   smem_desc(qs + st * 256, 128, kGroup), st);
#pragma unroll
    for (int st = 0; st < kSteps; ++st)
      wgmma_ss_n64(dp, smem_desc(v_wg + st * 256, 128, kGroup),
                   smem_desc(dos + st * 256, 128, kGroup), st);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // p^T = exp2(s scale log2e - lse log2e) and ds^T = p^T (dP^T - delta)
    // scale, each column with its q row's lse and delta; 0 past Sq
    const bool ragged = (j + 1) * kTileQ > sq;
    uint32_t pa[kTileQ / 16][4], dsa[kTileQ / 16][4];
#pragma unroll
    for (int n = 0; n < kTileQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + t4 * 2 + e;
        const float nl = -lse_s[c] * e4t::kLog2e, dl = dl_s[c];
        const bool valid = !ragged || j * kTileQ + c < sq;
        const float p0 = valid ? exp2_approx(fmaf(s[4 * n + e], scale_log2, nl)) : 0.f;
        const float p1 = valid ? exp2_approx(fmaf(s[4 * n + 2 + e], scale_log2, nl)) : 0.f;
        s[4 * n + e] = p0;
        s[4 * n + 2 + e] = p1;
        dp[4 * n + e] = p0 * (dp[4 * n + e] - dl) * scale;
        dp[4 * n + 2 + e] = p1 * (dp[4 * n + 2 + e] - dl) * scale;
      }
      pa[n >> 1][(n & 1) * 2 + 0] = e4t::pack_bf16(s[4 * n + 0], s[4 * n + 1]);
      pa[n >> 1][(n & 1) * 2 + 1] = e4t::pack_bf16(s[4 * n + 2], s[4 * n + 3]);
      dsa[n >> 1][(n & 1) * 2 + 0] = e4t::pack_bf16(dp[4 * n + 0], dp[4 * n + 1]);
      dsa[n >> 1][(n & 1) * 2 + 1] = e4t::pack_bf16(dp[4 * n + 2], dp[4 * n + 3]);
    }

    // dv += p^T dO and dk += ds^T q, 16 q rows a step
    fence_regs(adv);
    fence_regs(adk);
    fence_regs(pa);
    fence_regs(dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileQ / 16; ++kk)
      wgmma_rs_tile<DK>(adv, pa[kk], dos + kk * 2 * kGroup, kGroup);
#pragma unroll
    for (int kk = 0; kk < kTileQ / 16; ++kk)
      wgmma_rs_tile<DK>(adk, dsa[kk], qs + kk * 2 * kGroup, kGroup);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(adv);
    fence_regs(adk);

    e4t::cp_async_wait<kDkvStages - 2>();  // tile j + 1 has landed (this thread's part)
    fence_proxy_async();
    __syncthreads();                         // ... everyone's, and tile j is free
  }

  const int row0 = k0 + wg * 64 + wi * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < kOut / 4; ++n) {
    const int col = n * 8 + t4 * 2;
    if (col < d) {
      if (row0 < sk) {
        const size_t o = koff + (size_t)row0 * d + col;
        *reinterpret_cast<uint32_t*>(&dk[o]) = e4t::pack_bf16(adk[4 * n], adk[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(&dv[o]) = e4t::pack_bf16(adv[4 * n], adv[4 * n + 1]);
      }
      if (row1 < sk) {
        const size_t o = koff + (size_t)row1 * d + col;
        *reinterpret_cast<uint32_t*>(&dk[o]) =
            e4t::pack_bf16(adk[4 * n + 2], adk[4 * n + 3]);
        *reinterpret_cast<uint32_t*>(&dv[o]) =
            e4t::pack_bf16(adv[4 * n + 2], adv[4 * n + 3]);
      }
    }
  }
}

// q warpgroups a dq block, 64 q rows each: they share each k/v tile the
// block loads; 4 up to DK = 64 leave 128 registers a thread for S, dP, the
// dq accumulators and the ds fragments, 3 up to 112 leave 168, 2 from 128
// leave 255 (the accumulators alone are 80 f32 at DK 160), and 1 at 256,
// where q and dO of 2 warpgroups and two ring stages would not fit a block
template <int DK>
__host__ __device__ constexpr int dq_groups() {
  return DK <= 64 ? 4 : DK <= 112 ? 3 : DK <= 224 ? 2 : 1;
}
constexpr int kTileK = 64;  // kv rows of a streamed tile in the dq kernel

template <int DK>
__host__ __device__ constexpr size_t dq_wgmma_smem(int stages) {
  return (size_t)2 * DK * 2 * (64 * dq_groups<DK>() + stages * kTileK);
}

// the dq kernel's k/v ring depth: 4 stages, as the forward's, fewer where
// they would not fit beside q and dO (3 at DK 160, 2 from 192)
template <int DK>
__host__ __device__ constexpr int dq_stages() {
  int s = 4;
  while (s > 2 && dq_wgmma_smem<DK>(s) > e4t::kMaxSmem) --s;
  return s;
}

// dq of dq_groups<DK>() * 64 q rows a block, one warpgroup per 64 rows; q
// and dO stay in shared memory, each row's lse and delta in registers, and k
// and v stream through a ring of kDqStages 64-row tiles that every
// warpgroup reads. Per tile each warpgroup issues S = Q K^T and dP = dO V^T
// (m64n64k16, both operands K-major), waits, forms ds in registers and
// issues dq += ds K (m64nDKk16, K read MN-major by the descriptor), as the
// forward's O += P V.
template <int DK>
__global__ void __launch_bounds__(128 * dq_groups<DK>())
flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dq, int sq, int sk, int d, float scale,
                          float scale_log2) {
  constexpr int kDqStages = dq_stages<DK>();
  constexpr int kT = 128 * dq_groups<DK>();
  constexpr int kC = DK / 8;
  constexpr int kGroup = kC * 128;
  constexpr int kBM = 64 * dq_groups<DK>();
  constexpr int kTile = kTileK * DK * 2;
  constexpr int kSteps = DK / 16;
  constexpr int kOut = DK / 2;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* q_s = smem_raw;                // kBM rows
  unsigned char* do_s = q_s + kBM * DK * 2;     // kBM rows
  unsigned char* k_s = do_s + kBM * DK * 2;     // kDqStages tiles
  unsigned char* v_s = k_s + kDqStages * kTile;  // kDqStages tiles

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wi = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const size_t qoff = (size_t)bh * sq * d;
  const bf16* kb = k + (size_t)bh * sk * d;
  const bf16* vb = v + (size_t)bh * sk * d;
  const int n_tiles = (sk + kTileK - 1) / kTileK;

  // prologue: q and dO, then tiles 0 .. kDqStages - 2, one group each
  e4t::load_core_async<kBM, DK, kT>(q_s, q + qoff, q0, sq, d, tid);
  e4t::load_core_async<kBM, DK, kT>(do_s, dout + qoff, q0, sq, d, tid);
  e4t::cp_async_commit();
#pragma unroll
  for (int t = 0; t < kDqStages - 1; ++t) {
    if (t < n_tiles) {
      e4t::load_core_async<kTileK, DK, kT>(k_s + t * kTile, kb, t * kTileK, sk, d, tid);
      e4t::load_core_async<kTileK, DK, kT>(v_s + t * kTile, vb, t * kTileK, sk, d, tid);
    }
    e4t::cp_async_commit();
  }

  // rows g and g + 8 of the warp: -lse in the log2 domain (-inf past Sq, so
  // p = 0 there) and delta
  const int row0 = q0 + wg * 64 + wi * 16 + g, row1 = row0 + 8;
  const float nl0 = row0 < sq ? -lse[(size_t)bh * sq + row0] * e4t::kLog2e : -INFINITY;
  const float nl1 = row1 < sq ? -lse[(size_t)bh * sq + row1] * e4t::kLog2e : -INFINITY;
  const float dl0 = row0 < sq ? delta[(size_t)bh * sq + row0] : 0.f;
  const float dl1 = row1 < sq ? delta[(size_t)bh * sq + row1] : 0.f;

  e4t::cp_async_wait<kDqStages - 2>();  // q, dO and tile 0 have landed
  fence_proxy_async();
  __syncthreads();

  const unsigned char* q_wg = q_s + wg * 8 * kGroup;
  const unsigned char* do_wg = do_s + wg * 8 * kGroup;
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int nxt = j + kDqStages - 1;
    if (nxt < n_tiles) {
      const int st = nxt % kDqStages;
      e4t::load_core_async<kTileK, DK, kT>(k_s + st * kTile, kb, nxt * kTileK, sk, d, tid);
      e4t::load_core_async<kTileK, DK, kT>(v_s + st * kTile, vb, nxt * kTileK, sk, d, tid);
    }
    e4t::cp_async_commit();  // possibly empty: the group count stays uniform
    const unsigned char* ks = k_s + (j % kDqStages) * kTile;
    const unsigned char* vs = v_s + (j % kDqStages) * kTile;

    // S and dP, the warpgroup's 64 q rows x the tile's 64 kv rows
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < kSteps; ++st)
      wgmma_ss_n64(s, smem_desc(q_wg + st * 256, 128, kGroup),
                   smem_desc(ks + st * 256, 128, kGroup), st);
#pragma unroll
    for (int st = 0; st < kSteps; ++st)
      wgmma_ss_n64(dp, smem_desc(do_wg + st * 256, 128, kGroup),
                   smem_desc(vs + st * 256, 128, kGroup), st);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // ds = p (dP - delta) scale, p = 0 past Sk; in the A-fragment layout
    const bool ragged = (j + 1) * kTileK > sk;
    uint32_t dsa[kTileK / 16][4];
#pragma unroll
    for (int n = 0; n < kTileK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = !ragged || j * kTileK + n * 8 + t4 * 2 + e < sk;
        const float p0 = valid ? exp2_approx(fmaf(s[4 * n + e], scale_log2, nl0)) : 0.f;
        const float p1 = valid ? exp2_approx(fmaf(s[4 * n + 2 + e], scale_log2, nl1)) : 0.f;
        dp[4 * n + e] = p0 * (dp[4 * n + e] - dl0) * scale;
        dp[4 * n + 2 + e] = p1 * (dp[4 * n + 2 + e] - dl1) * scale;
      }
      dsa[n >> 1][(n & 1) * 2 + 0] = e4t::pack_bf16(dp[4 * n + 0], dp[4 * n + 1]);
      dsa[n >> 1][(n & 1) * 2 + 1] = e4t::pack_bf16(dp[4 * n + 2], dp[4 * n + 3]);
    }

    // dq += ds K, 16 kv rows a step
    fence_regs(acc);
    fence_regs(dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk)
      wgmma_rs_tile<DK>(acc, dsa[kk], ks + kk * 2 * kGroup, kGroup);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    e4t::cp_async_wait<kDqStages - 2>();  // tile j + 1 has landed (this thread's part)
    fence_proxy_async();
    __syncthreads();                        // ... everyone's, and tile j is free
  }

  bf16* dqb = dq + qoff;
#pragma unroll
  for (int n = 0; n < kOut / 4; ++n) {
    const int col = n * 8 + t4 * 2;
    if (col < d) {
      if (row0 < sq)
        *reinterpret_cast<uint32_t*>(&dqb[(size_t)row0 * d + col]) =
            e4t::pack_bf16(acc[4 * n], acc[4 * n + 1]);
      if (row1 < sq)
        *reinterpret_cast<uint32_t*>(&dqb[(size_t)row1 * d + col]) =
            e4t::pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
    }
  }
}

template <int DK, int NWG>
int launch_dkv_wgmma(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                     const float* lse, const float* delta, bf16* dk, bf16* dv, int bh,
                     int sq, int sk, int d, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_wgmma_smem<DK, NWG>();
  const cudaError_t err = e4t::allow_smem(flash_bwd_dkv_wgmma_kernel<DK, NWG>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sk + 64 * NWG - 1) / (64 * NWG), bh);
  flash_bwd_dkv_wgmma_kernel<DK, NWG><<<grid, 128 * NWG, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, sq, sk, d, scale, scale * e4t::kLog2e);
  return (int)cudaGetLastError();
}

// the wgmma dq kernel with dq_groups<DK>() warpgroups a block
template <int DK>
int launch_dq_wgmma(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                    const float* lse, const float* delta, bf16* dq, int bh, int sq, int sk,
                    int d, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_wgmma_smem<DK>(dq_stages<DK>());
  static_assert(smem <= e4t::kMaxSmem, "the dq kernel's ring does not fit a block");
  const cudaError_t err = e4t::allow_smem(flash_bwd_dq_wgmma_kernel<DK>, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kBM = 64 * dq_groups<DK>();
  flash_bwd_dq_wgmma_kernel<DK><<<dim3((sq + kBM - 1) / kBM, bh), kBM * 2, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, sq, sk, d, scale, scale * e4t::kLog2e);
  return (int)cudaGetLastError();
}

// The d < 128 backward: the wgmma dq kernel, then the wgmma dk/dv kernel
// with dkv_groups<DK>() warpgroups a block, or 1 where that would leave fewer
// than two blocks an SM (the cross-attention sites: Sk = 77 would otherwise
// give one block a head and idle most of its rows).
template <int DK>
int launch_wgmma(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, void* dk, void* dv,
                 int bh, int sq, int sk, int d, float scale, cudaStream_t stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dlp = static_cast<const float*>(delta);
  const int err = launch_dq_wgmma<DK>(qp, kp, vp, dop, lp, dlp, static_cast<bf16*>(dq), bh,
                                      sq, sk, d, scale, stream);
  if (err != (int)cudaSuccess) return err;
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  constexpr int kGroups = dkv_groups<DK>();
  if ((long)bh * ((sk + 64 * kGroups - 1) / (64 * kGroups)) < 2L * kSMs)
    return launch_dkv_wgmma<DK, 1>(qp, kp, vp, dop, lp, dlp, dkp, dvp, bh, sq, sk, d, scale,
                                   stream);
  return launch_dkv_wgmma<DK, kGroups>(qp, kp, vp, dop, lp, dlp, dkp, dvp, bh, sq, sk, d,
                                       scale, stream);
}

// ---- DK >= 128: the dk/dv kernel as a pair of warpgroups ----

constexpr int kPairX = 64 * 64 * 4;  // bytes of the p^T exchange: 64 x 64 f32

template <int DK>
__host__ __device__ constexpr size_t dkv_pair_smem(int stages) {
  return (size_t)2 * 64 * DK * 2 + kPairX + (size_t)stages * dkv_stage_bytes<DK>();
}

// the pair kernel's q/dO ring: kDkvStages where they fit beside k, v and the
// exchange, else 2 (DK 224 and 256)
template <int DK>
__host__ __device__ constexpr int dkv_pair_stages() {
  return dkv_pair_smem<DK>(kDkvStages) <= e4t::kMaxSmem ? kDkvStages : 2;
}

// named barrier 1 of the block's two warpgroups: warpgroup 0 arrives once
// p^T is in shared memory, warpgroup 1 waits for it
__device__ __forceinline__ void pair_arrive() {
  asm volatile("bar.arrive 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// dk and dv of 64 kv rows a block by a pair of warpgroups, for DK >= 128,
// where one warpgroup cannot hold both accumulators (DK f32 a thread) beside
// S^T and dP^T in 255 registers. k and v stay in shared memory; q, dO, lse
// and delta stream through a ring of dkv_pair_stages<DK>() tiles of 64 q rows
// (load_dkv_stage). Per tile warpgroup 0 issues S^T = K Q^T, forms p^T and
// hands it to warpgroup 1 through shared memory in f32 (each thread's values
// to the thread at its place in warpgroup 1, whose dP^T accumulator has the
// same layout), then issues dv += p^T dO; warpgroup 1 issues dP^T = V dO^T
// meanwhile, waits for p^T on a named barrier, forms ds^T = p^T (dP^T -
// delta) scale and issues dk += ds^T q. So S^T and dP^T are computed once
// (the synchronous design splits dk's and dv's columns over two blocks and
// computes both twice), each q/dO tile feeds both products, and each thread
// holds one accumulator (DK / 2 f32). One block barrier a tile frees the
// stage and the exchange. p^T, ds^T and the 16-row order of the sums are
// those of the DK < 128 kernel.
template <int DK>
__global__ void __launch_bounds__(256)
flash_bwd_dkv_pair_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta, bf16* __restrict__ dk,
                                bf16* __restrict__ dv, int sq, int sk, int d, float scale,
                                float scale_log2) {
  constexpr int kStages = dkv_pair_stages<DK>();
  constexpr int kC = DK / 8;        // 16-byte chunks per row
  constexpr int kGroup = kC * 128;  // bytes of 8 rows
  constexpr int kTile = kTileQ * DK * 2;
  constexpr int kStage = dkv_stage_bytes<DK>();
  constexpr int kSteps = DK / 16;
  constexpr int kOut = DK / 2;  // f32 accumulators a thread: dv or dk

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* k_s = smem_raw;                                   // 64 rows
  unsigned char* v_s = k_s + 64 * DK * 2;                          // 64 rows
  float4* x_s = reinterpret_cast<float4*>(v_s + 64 * DK * 2);      // 8 x 128 float4
  unsigned char* ring = reinterpret_cast<unsigned char*>(x_s) + kPairX;  // kStages stages

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * 64;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // 0: S^T, p^T and dv; 1: dP^T, ds^T and dk
  const int t = tid & 127;
  const int wi = t >> 5;    // warp of the warpgroup: its 16 kv rows
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const size_t koff = (size_t)bh * sk * d;
  const bf16* qb = q + (size_t)bh * sq * d;
  const bf16* dob = dout + (size_t)bh * sq * d;
  const float* lseb = lse + (size_t)bh * sq;
  const float* dlb = delta + (size_t)bh * sq;
  const int n_tiles = (sq + kTileQ - 1) / kTileQ;

  // prologue: k and v, then tiles 0 .. kStages - 2, one group each
  e4t::load_core_async<64, DK, 256>(k_s, k + koff, k0, sk, d, tid);
  e4t::load_core_async<64, DK, 256>(v_s, v + koff, k0, sk, d, tid);
  e4t::cp_async_commit();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles)
      load_dkv_stage<DK, 256>(ring + i * kStage, qb, dob, lseb, dlb, i, sq, d, tid);
    e4t::cp_async_commit();
  }
  e4t::cp_async_wait<kStages - 2>();  // k, v and tile 0 have landed
  fence_proxy_async();
  __syncthreads();

  const unsigned char* a_s = wg == 0 ? k_s : v_s;  // S^T = K Q^T, dP^T = V dO^T
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    // refill the stage tile j - 1 used: both warpgroups left it at the
    // barrier that ended the last iteration
    const int nxt = j + kStages - 1;
    if (nxt < n_tiles)
      load_dkv_stage<DK, 256>(ring + (nxt % kStages) * kStage, qb, dob, lseb, dlb, nxt, sq,
                              d, tid);
    e4t::cp_async_commit();  // possibly empty: the group count stays uniform
    const unsigned char* qs = ring + (j % kStages) * kStage;
    const unsigned char* dos = qs + kTile;
    const float* lse_s = reinterpret_cast<const float*>(qs + 2 * kTile);
    const float* dl_s = lse_s + kTileQ;

    // S^T (warpgroup 0) or dP^T (warpgroup 1): the 64 kv rows x the tile's
    // 64 q rows; s[4n + e]: kv rows g (e < 2) and g + 8 of the warp's 16, q
    // column 8n + 2 t4 + (e & 1)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const unsigned char* b_s = wg == 0 ? qs : dos;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < kSteps; ++st)
      wgmma_ss_n64(s, smem_desc(a_s + st * 256, 128, kGroup),
                   smem_desc(b_s + st * 256, 128, kGroup), st);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const bool ragged = (j + 1) * kTileQ > sq;
    if (wg == 0) {
      // p^T = exp2(s scale log2e - lse log2e), each column with its q row's
      // lse; 0 past Sq
#pragma unroll
      for (int n = 0; n < kTileQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + t4 * 2 + e;
          const float nl = -lse_s[c] * e4t::kLog2e;
          const bool valid = !ragged || j * kTileQ + c < sq;
          s[4 * n + e] = valid ? exp2_approx(fmaf(s[4 * n + e], scale_log2, nl)) : 0.f;
          s[4 * n + 2 + e] = valid ? exp2_approx(fmaf(s[4 * n + 2 + e], scale_log2, nl)) : 0.f;
        }
        x_s[n * 128 + t] = make_float4(s[4 * n], s[4 * n + 1], s[4 * n + 2], s[4 * n + 3]);
      }
      __threadfence_block();
      pair_arrive();
    } else {
      // ds^T = p^T (dP^T - delta) scale, each column with its q row's delta
      pair_sync();
#pragma unroll
      for (int n = 0; n < kTileQ / 8; ++n) {
        const float4 p = x_s[n * 128 + t];
        const float dl0 = dl_s[n * 8 + t4 * 2], dl1 = dl_s[n * 8 + t4 * 2 + 1];
        s[4 * n + 0] = p.x * (s[4 * n + 0] - dl0) * scale;
        s[4 * n + 1] = p.y * (s[4 * n + 1] - dl1) * scale;
        s[4 * n + 2] = p.z * (s[4 * n + 2] - dl0) * scale;
        s[4 * n + 3] = p.w * (s[4 * n + 3] - dl1) * scale;
      }
    }
    // p^T or ds^T in the A-fragment layout of dv += p^T dO or dk += ds^T q
    uint32_t fa[kTileQ / 16][4];
#pragma unroll
    for (int n = 0; n < kTileQ / 8; ++n) {
      fa[n >> 1][(n & 1) * 2 + 0] = e4t::pack_bf16(s[4 * n + 0], s[4 * n + 1]);
      fa[n >> 1][(n & 1) * 2 + 1] = e4t::pack_bf16(s[4 * n + 2], s[4 * n + 3]);
    }

    // 16 q rows a step
    const unsigned char* mn = wg == 0 ? dos : qs;
    fence_regs(acc);
    fence_regs(fa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileQ / 16; ++kk)
      wgmma_rs_tile<DK>(acc, fa[kk], mn + kk * 2 * kGroup, kGroup);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    e4t::cp_async_wait<kStages - 2>();  // tile j + 1 has landed (this thread's part)
    fence_proxy_async();
    __syncthreads();                      // ... everyone's; tile j and the exchange are free
  }

  bf16* dst = wg == 0 ? dv : dk;
  const int row0 = k0 + wi * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < kOut / 4; ++n) {
    const int col = n * 8 + t4 * 2;
    if (col < d) {
      if (row0 < sk)
        *reinterpret_cast<uint32_t*>(&dst[koff + (size_t)row0 * d + col]) =
            e4t::pack_bf16(acc[4 * n], acc[4 * n + 1]);
      if (row1 < sk)
        *reinterpret_cast<uint32_t*>(&dst[koff + (size_t)row1 * d + col]) =
            e4t::pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
    }
  }
}

// The DK >= 128 backward: the wgmma dq kernel, then the pair dk/dv kernel.
template <int DK>
int launch_wide(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, void* dk, void* dv, int bh,
                int sq, int sk, int d, float scale, cudaStream_t stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dlp = static_cast<const float*>(delta);
  int err = launch_dq_wgmma<DK>(qp, kp, vp, dop, lp, dlp, static_cast<bf16*>(dq), bh, sq, sk,
                                d, scale, stream);
  if (err != (int)cudaSuccess) return err;
  constexpr size_t smem = dkv_pair_smem<DK>(dkv_pair_stages<DK>());
  static_assert(smem <= e4t::kMaxSmem, "the pair kernel's ring does not fit a block");
  err = (int)e4t::allow_smem(flash_bwd_dkv_pair_wgmma_kernel<DK>, smem);
  if (err != (int)cudaSuccess) return err;
  flash_bwd_dkv_pair_wgmma_kernel<DK><<<dim3((sk + 63) / 64, bh), 256, smem, stream>>>(
      qp, kp, vp, dop, lp, dlp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, d,
      scale, scale * e4t::kLog2e);
  return (int)cudaGetLastError();
}

// The launch for a padded head dim, by the synchronous design.
int dispatch_sync(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, void* dk, void* dv,
                  int bh, int sq, int sk, int d, float scale, cudaStream_t s) {
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

bool bad_shape(int bh, int sq, int sk, int d) {
  return bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0 || d <= 0 || d % 8 != 0 || d > 256;
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
  if (bad_shape(bh, sq, sk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define E4T_BWD_WGMMA(DK) \
  case DK: return launch_wgmma<DK>(q, k, v, dout, lse, delta, dq, dk, dv, bh, sq, sk, d, scale, s);
  switch (e4t::padded_head_dim(d)) {
    E4T_BWD_WGMMA(16)
    E4T_BWD_WGMMA(32)
    E4T_BWD_WGMMA(48)
    E4T_BWD_WGMMA(64)
    E4T_BWD_WGMMA(80)
    E4T_BWD_WGMMA(96)
    E4T_BWD_WGMMA(112)
#undef E4T_BWD_WGMMA
#define E4T_BWD_WIDE(DK) \
  case DK: return launch_wide<DK>(q, k, v, dout, lse, delta, dq, dk, dv, bh, sq, sk, d, scale, s);
    E4T_BWD_WIDE(128)
    E4T_BWD_WIDE(160)
    E4T_BWD_WIDE(192)
    E4T_BWD_WIDE(224)
    E4T_BWD_WIDE(256)
#undef E4T_BWD_WIDE
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same function by the synchronous design at every head dim: the
// yardstick the wgmma kernels are timed and checked against. No path calls
// it.
extern "C" int e4t_flash_bwd_sync(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dq, void* dk, void* dv, int bh, int sq, int sk,
                                  int d, float scale, void* stream) {
  if (bad_shape(bh, sq, sk, d)) return (int)cudaErrorInvalidValue;
  return dispatch_sync(q, k, v, dout, lse, delta, dq, dk, dv, bh, sq, sk, d, scale,
                       static_cast<cudaStream_t>(stream));
}
