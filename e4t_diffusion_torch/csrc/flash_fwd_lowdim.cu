// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax, for
// every head dim the port routes to flash (D a multiple of 8 up to 256).
//
// Replaces three TPU kernels of e4t_diffusion_tpu/ops/flash_kernels.py:
// _flash_fwd_lowdim (D < 128, the transposed-accumulator variant), and for
// D >= 128 _flash_fwd_kvres (k/v resident in VMEM) and _flash_fwd (the
// (bh, nq, nk) grid). Same contract: non-causal softmax attention over
// (BH, Sq, D) q and (BH, Sk, D) k/v; returns out (BH, Sq, D) in bf16 and
// lse = m + log(l) (BH, Sq) in f32. p is rounded to bf16 before the P@V
// product, as in the TPU kernels; the row sum l adds the unrounded f32 p.
// The TPU's residency split is a VMEM fact: here k/v always stream through
// shared memory, which computes what both the resident and the grid
// variants compute, at any Sk.
//
// What bounds it on the H100: at the UNet's 4096-token d=40 sites the work is
// 4*Sq*Sk*D tensor-core flops (0.17 ms of bf16 peak at BH=64) and Sq*Sk
// exponentials per head (~0.26 ms at 16 exp2/clk/SM), against ~0.03 ms of
// q/k/v/out traffic: the special-function unit, not memory, is the floor.
// At the d=160 sites (256 tokens) the work is small and memory bounds it.
// Both kernels keep the score tile in registers (never in shared or device
// memory), fold the softmax scale into one multiply by scale*log2(e) so each
// score costs a single ex2, and reuse the score accumulator, rounded to bf16,
// as P@V's A operand in registers. Each warp owns 16 q rows. D is padded
// with zeros in shared memory only, to DK, the mma k-depth granularity (40 ->
// 48, 80 stays 80, 160 stays 160); ragged Sq and Sk are masked here, so the
// host passes unpadded tensors. The TPU kernels' 128-lane padding of D has
// no counterpart here.
//
// Every DK (flash_fwd_wgmma_kernel): warpgroup MMA. A block holds
// wgmma_groups<DK>() warpgroups of 64 q rows (4 up to DK = 80, 2 above, for
// registers: at DK 256 the output accumulator alone is 128 f32 a thread).
// S = Q K^T is one m64n64k16 wgmma per 16 head dims, Q and K read from
// shared memory by descriptor (both K-major); O += P V is one m64nDKk16
// wgmma per 16 kv rows up to DK 128 and two m64n(DK/2)k16 halves above
// (wgmma_rs_tile: the same tensor-core time, no new instruction shapes), P
// from registers and V read row-major, transposed by the descriptor
// (MN-major B), so no thread transposes v. Every tile sits in shared memory
// as 8x8 core matrices (8 rows of 16 bytes, 128 contiguous bytes), the
// descriptors' layout without swizzle, which 16-byte cp.async fills chunk by
// chunk (zero-filled past Sk and past d through the copy's source size). k
// and v stream through a ring of wgmma_stages<DK>() 64-row stages, 4 up to
// DK 160 (tiles j + 1 and j + 2 landing while tile j is computed), 3 at DK
// 192 and 224 and 2 at 256, where a deeper ring would not fit the 227 KB a
// block may take; one barrier a tile. What bounds it at the UNet's d=40
// sites, measured on the card by taking parts of the work out
// (time_flash_fwd.py --ablate in the package, PERF.md): the k/v traffic from
// L2, which every block reads whole for its q rows, far more than the
// exponentials; so the warpgroups of a block share each tile, and more of
// them a block cut that traffic. At DK 160 (BH 2, 8192 tokens) the streamed
// k/v tiles bound it too: without their loads it runs 47% faster, while
// cutting either product or the exponentials moves it by under 5%; copies
// that write shared memory free of bank conflicts did not help, so the
// cost lies on the global side of the copies (PERF.md). At the 256-token
// d=160 sites the blocks' prologue loads and two waves of 256 blocks
// bound it, and one warpgroup a block (two blocks an SM) was slower.
//
// The synchronous design (flash_fwd_kernel, which served every DK before
// the wgmma kernel): one block of 4 warps per 64-row q tile, mma.sync
// m16n8k16, q kept in shared memory and its fragments reloaded per kv tile
// above DK 128 (the DK/8 x 4 f32 output accumulator takes the registers), k
// and v staged synchronously through registers into shared memory between
// two barriers, v stored transposed so its B fragments are 32-bit loads.
// No path launches it: it is exported at every DK as e4t_flash_fwd_sync,
// the yardstick chip_smoke.py times the wgmma kernel against.

#include <math.h>

#include "flash_common.cuh"
#include "wgmma_common.cuh"

namespace {

using e4t::bf16;
using e4t::exp2_approx;
using e4t::fence_proxy_async;
using e4t::fence_regs;
using e4t::kMaxSmem;
using e4t::kThreads;
using e4t::smem_desc;
using e4t::wgmma_commit;
using e4t::wgmma_fence;
using e4t::wgmma_rs_tile;
using e4t::wgmma_ss_n64;
using e4t::wgmma_wait;

constexpr int kBlockM = 64;  // q rows per block of flash_fwd_kernel: 4 warps x 16
constexpr int kBlockN = 64;  // kv rows per tile, in both kernels

// flash_fwd_kernel keeps q fragments in registers up to DK = 128
template <int DK>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (kBlockN * (DK + 8) + DK * (kBlockN + 8) +
                         (DK <= 128 ? 0 : kBlockM * (DK + 8)));
}

template <int DK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int d, float scale_log2) {
  constexpr int kPitch = DK + 8;        // q/k tile row pitch, in halves
  constexpr int kVtPitch = kBlockN + 8;  // transposed v tile row pitch
  constexpr int kSteps = DK / 16;        // mma k-steps over the head dim
  constexpr int kScoreTiles = kBlockN / 8;
  constexpr int kOutTiles = DK / 8;
  constexpr bool kQInRegs = DK <= 128;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // kBlockN x kPitch
  bf16* vt_s = k_s + kBlockN * kPitch;             // DK x kVtPitch
  // with q in registers the q tile is staged in the k buffer first
  bf16* q_s = kQInRegs ? k_s : vt_s + DK * kVtPitch;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma row group
  const int t4 = lane & 3;   // thread within the group
  const int qr = warp * 16;  // the warp's first row in the tile

  const bf16* kb = k + (size_t)bh * sk * d;
  const bf16* vb = v + (size_t)bh * sk * d;

  e4t::stage_tile<kBlockM, DK>(q_s, kPitch, nullptr, 0, 0, 0,
                               q + (size_t)bh * sq * d, q0, sq, d, tid);
  __syncthreads();

  uint32_t qf[kQInRegs ? kSteps : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) e4t::load_a(qf[s], q_s, kPitch, qr, s * 16, g, t4);
  }

  float o[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // running max (log2 domain) and this thread's share of the row sums, for
  // rows g and g + 8 of the warp's 16
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int kv0 = 0; kv0 < sk; kv0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile (or q)
    e4t::stage_tile<kBlockN, DK>(k_s, kPitch, nullptr, 0, 0, 0, kb, kv0, sk, d, tid);
    e4t::stage_tile<kBlockN, DK>(nullptr, 0, vt_s, kVtPitch, 0, DK, vb, kv0, sk, d, tid);
    __syncthreads();

    float s[kScoreTiles][4];
#pragma unroll
    for (int n = 0; n < kScoreTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[st][i];
      } else {
        e4t::load_a(a, q_s, kPitch, qr, st * 16, g, t4);
      }
#pragma unroll
      for (int n = 0; n < kScoreTiles; ++n)
        e4t::mma_bt(s[n], a, k_s, kPitch, n * 8, st * 16, g, t4);
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kScoreTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = kv0 + n * 8 + t4 * 2 + e < sk;
        s[n][e] = valid ? s[n][e] * scale_log2 : -INFINITY;
        s[n][2 + e] = valid ? s[n][2 + e] * scale_log2 : -INFINITY;
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

    // p in the accumulator layout is already the A-fragment layout of the
    // P@V product: score tiles 2j and 2j+1 form k-step j
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

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int row0 = q0 + qr + g, row1 = row0 + 8;
  bf16* ob = out + (size_t)bh * sq * d;
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) {
    const int col = n * 8 + t4 * 2;
    if (col < d) {
      if (row0 < sq)
        *reinterpret_cast<uint32_t*>(&ob[(size_t)row0 * d + col]) =
            e4t::pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
      if (row1 < sq)
        *reinterpret_cast<uint32_t*>(&ob[(size_t)row1 * d + col]) =
            e4t::pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
    }
  }
  if (t4 == 0) {
    const float ln2 = 0.693147180559945309f;
    if (row0 < sq) lse[(size_t)bh * sq + row0] = (m0 + log2f(fmaxf(l0, 1e-37f))) * ln2;
    if (row1 < sq) lse[(size_t)bh * sq + row1] = (m1 + log2f(fmaxf(l1, 1e-37f))) * ln2;
  }
}

// ---- d < 128: warpgroup MMA (wgmma) fed by a cp.async k/v ring ----

// warpgroups per block, 64 q rows each: the warpgroups of a block share each
// k/v tile it loads, and the L2 -> shared traffic of those loads bounds the
// kernel, so more of them a block is faster; 4 warpgroups (512 threads)
// leave 128 registers a thread, enough up to DK = 80
template <int DK>
__host__ __device__ constexpr int wgmma_groups() { return DK <= 80 ? 4 : 2; }

template <int DK>
__host__ __device__ constexpr size_t wgmma_smem_bytes(int stages) {
  return (size_t)2 * DK * (64 * wgmma_groups<DK>() + 2 * stages * kBlockN);
}

// k/v ring depth: 4 stages (tiles j + 1 and j + 2 in flight while tile j is
// computed), fewer from DK 192 on, where 4 would not fit a block: 3 at DK
// 192 and 224, 2 at 256 (tile j + 1 in flight)
template <int DK>
__host__ __device__ constexpr int wgmma_stages() {
  int s = 4;
  while (s > 2 && wgmma_smem_bytes<DK>(s) > kMaxSmem) --s;
  return s;
}

// the softmax of one 64-column score tile in place: s (log2 domain after the
// scale) becomes p = exp2(s - m), m and l the running max and sum of the
// thread's rows g and g + 8, alpha their rescale factors
__device__ __forceinline__ void softmax_tile(float (&s)[32], int kv0, int sk, int t4,
                                             float scale_log2, float& m0, float& m1,
                                             float& l0, float& l1, float& alpha0,
                                             float& alpha1) {
  const bool ragged = kv0 + kBlockN > sk;
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool valid = !ragged || kv0 + n * 8 + t4 * 2 + e < sk;
      s[4 * n + e] = valid ? s[4 * n + e] * scale_log2 : -INFINITY;
      s[4 * n + 2 + e] = valid ? s[4 * n + 2 + e] * scale_log2 : -INFINITY;
      mx0 = fmaxf(mx0, s[4 * n + e]);
      mx1 = fmaxf(mx1, s[4 * n + 2 + e]);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // every tile holds at least one valid column, so mx is finite here and
  // the first tile's alpha is exp2(-inf) = 0
  alpha0 = exp2_approx(m0 - mx0);
  alpha1 = exp2_approx(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  l0 *= alpha0;
  l1 *= alpha1;
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
    s[4 * n + 0] = exp2_approx(s[4 * n + 0] - m0);
    s[4 * n + 1] = exp2_approx(s[4 * n + 1] - m0);
    s[4 * n + 2] = exp2_approx(s[4 * n + 2] - m1);
    s[4 * n + 3] = exp2_approx(s[4 * n + 3] - m1);
    l0 += s[4 * n + 0] + s[4 * n + 1];
    l1 += s[4 * n + 2] + s[4 * n + 3];
  }
}

// Per kv tile each warpgroup issues S = Q K^T, waits, takes the softmax in
// registers, rescales O, issues O += P V and waits; a block barrier a tile
// frees the stage of tile j - 1 for tile j - 1 + kWgStages.
template <int DK>
__global__ void __launch_bounds__(128 * wgmma_groups<DK>())
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       float* __restrict__ lse, int sq, int sk, int d, float scale_log2) {
  constexpr int kWgStages = wgmma_stages<DK>();
  constexpr int kC = DK / 8;               // 16-byte chunks per row
  constexpr int kGroup = kC * 128;         // bytes of 8 rows
  constexpr int kBM = 64 * wgmma_groups<DK>();
  constexpr int kTile = kBlockN * DK * 2;  // bytes of one k (or v) stage
  constexpr int kSteps = DK / 16;
  constexpr int kOut = DK / 2;             // f32 output accumulators a thread

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_s = smem_raw;                 // kBM rows
  unsigned char* k_s = q_s + kBM * DK * 2;       // kWgStages tiles
  unsigned char* v_s = k_s + kWgStages * kTile;  // kWgStages tiles

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wi = (tid >> 5) & 3;  // warp of the warpgroup: its 16 rows
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  const bf16* kb = k + (size_t)bh * sk * d;
  const bf16* vb = v + (size_t)bh * sk * d;
  const int n_tiles = (sk + kBlockN - 1) / kBlockN;

  // prologue: q, then tiles 0 .. kWgStages - 2, one group each
  e4t::load_core_async<kBM, DK, kBM * 2>(q_s, q + (size_t)bh * sq * d, q0, sq, d, tid);
  e4t::cp_async_commit();
#pragma unroll
  for (int t = 0; t < kWgStages - 1; ++t) {
    if (t < n_tiles) {
      e4t::load_core_async<kBlockN, DK, kBM * 2>(k_s + t * kTile, kb, t * kBlockN, sk, d, tid);
      e4t::load_core_async<kBlockN, DK, kBM * 2>(v_s + t * kTile, vb, t * kBlockN, sk, d, tid);
    }
    e4t::cp_async_commit();
  }
  e4t::cp_async_wait<kWgStages - 2>();  // q and tile 0 have landed
  fence_proxy_async();
  __syncthreads();

  const unsigned char* q_wg = q_s + wg * 8 * kGroup;  // the warpgroup's 64 rows
  float o[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    // refill the stage tile j - 1 used: every warpgroup left it at the
    // barrier that ended the last iteration
    const int nxt = j + kWgStages - 1;
    if (nxt < n_tiles) {
      const int st = nxt % kWgStages;
      e4t::load_core_async<kBlockN, DK, kBM * 2>(k_s + st * kTile, kb, nxt * kBlockN, sk, d, tid);
      e4t::load_core_async<kBlockN, DK, kBM * 2>(v_s + st * kTile, vb, nxt * kBlockN, sk, d, tid);
    }
    e4t::cp_async_commit();  // possibly empty: the group count stays uniform
    const unsigned char* ks = k_s + (j % kWgStages) * kTile;
    const unsigned char* vs = v_s + (j % kWgStages) * kTile;

    // S = Q K^T, the warpgroup's 64 rows x the tile's 64 kv rows; s[4n + e]:
    // rows g (e < 2) and g + 8 of the warp's 16, column 8n + 2 t4 + (e & 1),
    // the layout of mma.sync's accumulator
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < kSteps; ++st)
      wgmma_ss_n64(s, smem_desc(q_wg + st * 256, 128, kGroup),
                   smem_desc(ks + st * 256, 128, kGroup), st);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    float alpha0, alpha1;
    softmax_tile(s, j * kBlockN, sk, t4, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
#pragma unroll
    for (int n = 0; n < kOut / 4; ++n) {
      o[4 * n + 0] *= alpha0;
      o[4 * n + 1] *= alpha0;
      o[4 * n + 2] *= alpha1;
      o[4 * n + 3] *= alpha1;
    }
    // p in the accumulator layout is the A-fragment layout of P V: score
    // tiles 2kk and 2kk + 1 form k-step kk
    uint32_t pa[kBlockN / 16][4];
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
      pa[n >> 1][(n & 1) * 2 + 0] = e4t::pack_bf16(s[4 * n + 0], s[4 * n + 1]);
      pa[n >> 1][(n & 1) * 2 + 1] = e4t::pack_bf16(s[4 * n + 2], s[4 * n + 3]);
    }

    // O += P V, 16 kv rows a step
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      wgmma_rs_tile<DK>(o, pa[kk], vs + kk * 2 * kGroup, kGroup);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

    e4t::cp_async_wait<kWgStages - 2>();  // tile j + 1 has landed (this thread's part)
    fence_proxy_async();
    __syncthreads();                        // ... everyone's, and tile j is free
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int row0 = q0 + wg * 64 + wi * 16 + g, row1 = row0 + 8;
  bf16* ob = out + (size_t)bh * sq * d;
#pragma unroll
  for (int n = 0; n < kOut / 4; ++n) {
    const int col = n * 8 + t4 * 2;
    if (col < d) {
      if (row0 < sq)
        *reinterpret_cast<uint32_t*>(&ob[(size_t)row0 * d + col]) =
            e4t::pack_bf16(o[4 * n + 0] * inv0, o[4 * n + 1] * inv0);
      if (row1 < sq)
        *reinterpret_cast<uint32_t*>(&ob[(size_t)row1 * d + col]) =
            e4t::pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
  }
  if (t4 == 0) {
    const float ln2 = 0.693147180559945309f;
    if (row0 < sq) lse[(size_t)bh * sq + row0] = (m0 + log2f(fmaxf(l0, 1e-37f))) * ln2;
    if (row1 < sq) lse[(size_t)bh * sq + row1] = (m1 + log2f(fmaxf(l1, 1e-37f))) * ln2;
  }
}

template <int DK>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, void* lse,
                 int bh, int sq, int sk, int d, float scale_log2, cudaStream_t stream) {
  constexpr size_t smem = wgmma_smem_bytes<DK>(wgmma_stages<DK>());
  static_assert(smem <= kMaxSmem, "the k/v ring does not fit a block");
  const cudaError_t err = e4t::allow_smem(flash_fwd_wgmma_kernel<DK>, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kBM = 64 * wgmma_groups<DK>();
  const dim3 grid((sq + kBM - 1) / kBM, bh);
  flash_fwd_wgmma_kernel<DK><<<grid, kBM * 2, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), sq, sk, d, scale_log2);
  return (int)cudaGetLastError();
}

// ---- the synchronous design, kept as the yardstick ----

template <int DK>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int bh, int sq, int sk, int d, float scale_log2, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DK>();
  const cudaError_t err = e4t::allow_smem(flash_fwd_kernel<DK>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  flash_fwd_kernel<DK><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), sq, sk, d, scale_log2);
  return (int)cudaGetLastError();
}

// The launch for a padded head dim, by the synchronous design.
int dispatch_sync(const void* q, const void* k, const void* v, void* out, void* lse,
                  int bh, int sq, int sk, int d, float scale_log2, cudaStream_t s) {
  switch (e4t::padded_head_dim(d)) {
    case 16: return launch<16>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s);
    case 32: return launch<32>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s);
    case 48: return launch<48>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s);
    case 64: return launch<64>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s);
    case 80: return launch<80>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s);
    case 96: return launch<96>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s);
    case 112: return launch<112>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s);
    case 128: return launch<128>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s);
    case 160: return launch<160>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s);
    case 192: return launch<192>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s);
    case 224: return launch<224>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s);
    case 256: return launch<256>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int bh, int sq, int sk, int d) {
  return bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0 || d <= 0 || d % 8 != 0 || d > 256;
}

}  // namespace

// Plain C entry point for ctypes. q/k/v/out are contiguous bf16, 16-byte
// aligned, D a multiple of 8 up to 256; lse is contiguous f32. Runs on
// ``stream``, allocates nothing and does not synchronise. Returns
// cudaGetLastError() after the launch.
extern "C" int e4t_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int bh, int sq, int sk,
                             int d, float scale, void* stream) {
  if (bad_shape(bh, sq, sk, d)) return (int)cudaErrorInvalidValue;
  const float sl = scale * e4t::kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (e4t::padded_head_dim(d)) {
    case 16: return launch_wgmma<16>(q, k, v, out, lse, bh, sq, sk, d, sl, s);
    case 32: return launch_wgmma<32>(q, k, v, out, lse, bh, sq, sk, d, sl, s);
    case 48: return launch_wgmma<48>(q, k, v, out, lse, bh, sq, sk, d, sl, s);
    case 64: return launch_wgmma<64>(q, k, v, out, lse, bh, sq, sk, d, sl, s);
    case 80: return launch_wgmma<80>(q, k, v, out, lse, bh, sq, sk, d, sl, s);
    case 96: return launch_wgmma<96>(q, k, v, out, lse, bh, sq, sk, d, sl, s);
    case 112: return launch_wgmma<112>(q, k, v, out, lse, bh, sq, sk, d, sl, s);
    case 128: return launch_wgmma<128>(q, k, v, out, lse, bh, sq, sk, d, sl, s);
    case 160: return launch_wgmma<160>(q, k, v, out, lse, bh, sq, sk, d, sl, s);
    case 192: return launch_wgmma<192>(q, k, v, out, lse, bh, sq, sk, d, sl, s);
    case 224: return launch_wgmma<224>(q, k, v, out, lse, bh, sq, sk, d, sl, s);
    case 256: return launch_wgmma<256>(q, k, v, out, lse, bh, sq, sk, d, sl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same function by the synchronous design at every head dim: the yardstick
// chip_smoke.py times the wgmma kernel against. No path calls it.
extern "C" int e4t_flash_fwd_sync(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int bh, int sq, int sk,
                                  int d, float scale, void* stream) {
  if (bad_shape(bh, sq, sk, d)) return (int)cudaErrorInvalidValue;
  return dispatch_sync(q, k, v, out, lse, bh, sq, sk, d, scale * e4t::kLog2e,
                       static_cast<cudaStream_t>(stream));
}
