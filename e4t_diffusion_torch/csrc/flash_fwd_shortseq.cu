// Short-sequence self-attention forward for Hopper (sm_90a): the whole
// score row's max first, then a single softmax pass, bf16 in and out.
//
// Replaces the TPU kernel _flash_fwd_shortseq_mh of
// e4t_diffusion_tpu/ops/flash_kernels.py (the ViT-H's 257-token d=80
// self-attention; the route takes 128 < S <= 512 and D up to 120). Same
// function: f32 scores s = q k^T * scale, columns at and beyond S masked, the
// row max m over the whole row, p = exp(s - m), l = sum of the f32 p,
// acc = p (rounded to bf16) @ v in f32, out = acc * (1 / l) in bf16. No
// online rescaling: p is taken against the final max, as the TPU kernel does
// with the whole row in registers.
//
// The TPU kernel packs g heads into one grid cell of a sequential grid to
// amortise its per-cell overhead. Blocks run in parallel here, so the
// kernels ignore g: one block per head (per (head, split) where fewer heads
// than SMs would leave SMs idle: BH 128 runs 2 splits, each loading the
// head's k and v), whose warpgroups of 64 q rows walk the head's q tiles.
//
// Warpgroup MMA (wgmma), two designs, dispatched by S (explicitly, below):
//   - 128 < S <= 272, the ViT's 257 tokens (shortseq_row_kernel): one
//     warpgroup a block, two blocks an SM. The head's k and v land once by
//     cp.async in the core-matrix layout. For each q tile the whole score
//     row is issued at once (64-column m64n64k16 tiles and, where S mod 64
//     <= 16, one m64n16k16 tail: 4 x 32 + 8 = 136 f32 a thread at 257) and
//     lands in registers; one wait, the max, p = 2^(s scale log2 e - m) by
//     one fma and ex2.approx a score, rounded to bf16 in place as P V's A
//     fragments, all of P V issued at once (RS, v read MN-major), one wait.
//     Each score is computed once, in two round trips to the tensor pipe.
//   - other S up to 512 (shortseq_wgmma_kernel): two warpgroups a block, k
//     resident, v streamed through each warpgroup's own two-stage ring;
//     pass 1 computes S tile by tile for the max alone, pass 2 computes S
//     again, p and P V. 224 KB of shared memory at S 512, D 128.
// Outputs are not bit for bit the synchronous design's: ex2.approx and the
// fused scale-and-subtract round p apart from its exp2f (rel-L2 3e-5 at
// the ViT's shape, measured).
//
// What bounds it on the H100: at BH = 256, S = 257, d = 80 the function
// moves 42 MB of q/k/v/out (12.6 us at 3.35 TB/s) and does 5.4 GFLOP of
// products (5.5 us) and 17 M exponentials (4.0 us): memory. Measured
// (time_attn_small.py, PERF.md): 0.039-0.041 ms, against SDPA's 0.044;
// with k and v loaded for 64 rows only it runs 14% faster (20% at BH 128),
// while cutting S to one k-step, P V to one, or the exponentials moves it
// by 4% or less: no part of the work bounds it, the per-q-tile sequence
// (load, two round trips, the softmax between them) and the 5th q tile's
// one valid row at 257 tokens do.
//
// The synchronous design (shortseq_kernel, which served every S before):
// one block of 4 warps per (head, 64-row q tile), mma.sync m16n8k16, the
// head's k resident and v staged transposed through registers, the scores
// computed twice. No path launches it: it is exported as
// e4t_flash_fwd_shortseq_sync, the yardstick chip_smoke.py times the
// kernels against.

#include <math.h>

#include <algorithm>

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

constexpr int kBlockM = 64;  // q rows per block: 4 warps x 16
constexpr int kBlockN = 64;  // kv columns per score tile
constexpr int kMaxSeq = 512;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <int DK>
__host__ size_t smem_bytes(int s) {
  const size_t k_rows = (size_t)round_up(s, kBlockN) * (DK + 8);
  // the q tile is staged in the v-tile buffer before pass 1
  const size_t tile = (size_t)DK * (kBlockN + 8) > (size_t)kBlockM * (DK + 8)
                          ? (size_t)DK * (kBlockN + 8)
                          : (size_t)kBlockM * (DK + 8);
  return sizeof(bf16) * (k_rows + tile);
}

// The warp's 16 x 64 score tile at kv column kv0 (f32, scaled to the log2
// domain, columns >= s set to -inf), from q fragments in registers and the
// resident k.
template <int DK>
__device__ __forceinline__ void score_tile(float (&st)[kBlockN / 8][4],
                                           const uint32_t (&qf)[DK / 16][4],
                                           const bf16* k_s, int kv0, int s,
                                           float scale_log2, int g, int t4) {
  constexpr int kPitch = DK + 8;
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
#pragma unroll
  for (int k = 0; k < DK / 16; ++k) {
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
      e4t::mma_bt(st[n], qf[k], k_s, kPitch, kv0 + n * 8, k * 16, g, t4);
  }
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool valid = kv0 + n * 8 + t4 * 2 + e < s;
      st[n][e] = valid ? st[n][e] * scale_log2 : -INFINITY;
      st[n][2 + e] = valid ? st[n][2 + e] * scale_log2 : -INFINITY;
    }
  }
}

template <int DK>
__global__ void __launch_bounds__(kThreads)
shortseq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int s, int d,
                float scale_log2) {
  constexpr int kPitch = DK + 8;         // q/k row pitch, in halves
  constexpr int kVtPitch = kBlockN + 8;  // transposed v tile row pitch
  constexpr int kSteps = DK / 16;
  constexpr int kScoreTiles = kBlockN / 8;
  constexpr int kOutTiles = DK / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s_pad = round_up(s, kBlockN);
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // s_pad x kPitch, resident
  bf16* tile_s = k_s + (size_t)s_pad * kPitch;     // q tile, then v tiles
  bf16* q_s = tile_s;
  bf16* vt_s = tile_s;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int qr = warp * 16;
  const size_t head = (size_t)bh * s * d;

  e4t::stage_tile<kBlockM, DK>(q_s, kPitch, nullptr, 0, 0, 0, q + head, q0, s, d, tid);
  for (int r0 = 0; r0 < s_pad; r0 += kBlockN)
    e4t::stage_tile<kBlockN, DK>(k_s + (size_t)r0 * kPitch, kPitch, nullptr, 0, 0, 0,
                                 k + head, r0, s, d, tid);
  __syncthreads();

  uint32_t qf[kSteps][4];
#pragma unroll
  for (int st = 0; st < kSteps; ++st) e4t::load_a(qf[st], q_s, kPitch, qr, st * 16, g, t4);

  // pass 1: the row max over the whole row (rows g and g + 8 of the warp)
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int kv0 = 0; kv0 < s_pad; kv0 += kBlockN) {
    float st[kScoreTiles][4];
    score_tile<DK>(st, qf, k_s, kv0, s, scale_log2, g, t4);
#pragma unroll
    for (int n = 0; n < kScoreTiles; ++n) {
      m0 = fmaxf(m0, fmaxf(st[n][0], st[n][1]));
      m1 = fmaxf(m1, fmaxf(st[n][2], st[n][3]));
    }
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));

  // pass 2: p = exp2(s - m) against the final max, l, and P@V
  float o[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int kv0 = 0; kv0 < s_pad; kv0 += kBlockN) {
    __syncthreads();  // every warp is done with the q tile or the last v tile
    e4t::stage_tile<kBlockN, DK>(nullptr, 0, vt_s, kVtPitch, 0, DK, v + head, kv0, s, d,
                                 tid);
    __syncthreads();
    float st[kScoreTiles][4];
    score_tile<DK>(st, qf, k_s, kv0, s, scale_log2, g, t4);
    // p in the accumulator layout is the A-fragment layout of P@V: score
    // tiles 2j and 2j+1 form k-step j
    uint32_t pa[kScoreTiles / 2][4];
#pragma unroll
    for (int n = 0; n < kScoreTiles; ++n) {
      const float p00 = exp2f(st[n][0] - m0), p01 = exp2f(st[n][1] - m0);
      const float p10 = exp2f(st[n][2] - m1), p11 = exp2f(st[n][3] - m1);
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
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;  // l >= 1: the max's own p
  const int row0 = q0 + qr + g, row1 = row0 + 8;
  bf16* ob = out + head;
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) {
    const int col = n * 8 + t4 * 2;
    if (col < d) {
      if (row0 < s)
        *reinterpret_cast<uint32_t*>(&ob[(size_t)row0 * d + col]) =
            e4t::pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
      if (row1 < s)
        *reinterpret_cast<uint32_t*>(&ob[(size_t)row1 * d + col]) =
            e4t::pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
    }
  }
}

template <int DK>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int s,
           int d, float scale_log2, cudaStream_t stream) {
  const size_t smem = smem_bytes<DK>(s);
  const cudaError_t err = e4t::allow_smem(shortseq_kernel<DK>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + kBlockM - 1) / kBlockM, bh);
  shortseq_kernel<DK><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), s, d, scale_log2);
  return (int)cudaGetLastError();
}

// ---- warpgroup MMA (wgmma): one block per head, k and v resident ----

// warpgroups per block, each owning one 64-row q tile at a time
constexpr int kWgGroups = 2;
constexpr int kWgThreads = 128 * kWgGroups;

// blocks an SM should hold (the register budget __launch_bounds__ asks
// for): two up to DK 64, where 128 registers a thread hold s, o and p (at
// DK 80 ptxas spills under that budget)
template <int DK>
constexpr int wgmma_min_blocks() { return DK <= 64 ? 2 : 1; }

// the head's k (S rounded up to 8 rows; the last 64-row score tile reads on
// into the warpgroups' buffers, whose columns it masks), then each
// warpgroup's q tile and its two-stage v ring (64 rows each), all in the
// core-matrix layout: 224 KB at S = 512, D = 128
__host__ __device__ constexpr size_t wgmma_smem_bytes(int dk, int s) {
  return (size_t)2 * dk * (round_up(s, 8) + 3 * 64 * kWgGroups);
}
static_assert(wgmma_smem_bytes(128, kMaxSeq) <= kMaxSmem, "the widest head does not fit");

// Rows [0, rows) of a contiguous (n, d) bf16 tensor into a core-matrix tile
// by 16-byte cp.async, shared by THREADS threads; chunks past row n or
// column d read nothing and are filled with zeros.
template <int DK, int THREADS = kWgThreads>
__device__ __forceinline__ void load_rows_async(unsigned char* dst, const bf16* src,
                                                int rows, int n, int d, int tid) {
  constexpr int kC = DK / 8;
  for (int i = tid; i < rows * kC; i += THREADS) {
    const int r = i / kC, c = i - r * kC;
    const bool in = r < n && 8 * c < d;
    e4t::cp_async_16(dst + e4t::core_offset(r, c, kC), in ? src + (size_t)r * d + 8 * c : src,
                     in ? 16 : 0);
  }
}

// The landed scores of the 64-column tile at kv0, unscaled, with columns at
// and beyond s set to -inf.
__device__ __forceinline__ void mask_scores(float (&sc)[32], int kv0, int s, int t4) {
  fence_regs(sc);
  if (kv0 + kBlockN <= s) return;
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (kv0 + n * 8 + t4 * 2 + e >= s) sc[4 * n + e] = sc[4 * n + 2 + e] = -INFINITY;
  }
}

// the running maxima of the thread's rows g (m0) and g + 8 (m1) over sc
template <int N>
__device__ __forceinline__ void row_max(const float (&sc)[N], float& m0, float& m1) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    m0 = fmaxf(m0, fmaxf(sc[4 * n], sc[4 * n + 1]));
    m1 = fmaxf(m1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
}

// S = Q K^T for the warpgroup's 64 q rows and the 64 kv rows of k tile kv0,
// unscaled, columns at and beyond s set to -inf. s[4n + e]: rows g (e < 2)
// and g + 8 of the warp's 16, column 8n + 2 t4 + (e & 1).
template <int DK>
__device__ __forceinline__ void wgmma_scores(float (&sc)[32], const unsigned char* q_wg,
                                             const unsigned char* k_s, int kv0, int s,
                                             int t4) {
  constexpr int kGroup = DK / 8 * 128;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  fence_regs(sc);
  wgmma_fence();
  const unsigned char* kt = k_s + (kv0 / 8) * kGroup;
#pragma unroll
  for (int st = 0; st < DK / 16; ++st)
    wgmma_ss_n64(sc, smem_desc(q_wg + st * 256, 128, kGroup),
                 smem_desc(kt + st * 256, 128, kGroup), st);
  wgmma_commit();
  wgmma_wait<0>();
  mask_scores(sc, kv0, s, t4);
}

// the warpgroup's named barrier (1 + wg; 0 is __syncthreads)
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// One block per (head, split): the head's whole k lands in shared memory
// once, by cp.async, and the block's warpgroups walk its q tiles on their
// own (tiles split, split + n_splits, ...; warpgroup w takes every
// kWgGroups-th of them from the w-th). For each q tile a warpgroup runs
// pass 1 (S tile by tile by wgmma, the row max only) and pass 2 (S again,
// p = 2^(s scale log2 e - m) against the final max, l, and O += P V by wgmma
// with p from registers and v read MN-major from its own two-stage ring,
// tile j + 1 landing while tile j is used), then writes out = O / l. The
// only block barrier is k's; a warpgroup meets its own warps once a tile.
template <int DK>
__global__ void __launch_bounds__(kWgThreads, wgmma_min_blocks<DK>())
shortseq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out, int s, int d,
                      float scale_log2, int n_splits) {
  constexpr int kC = DK / 8;
  constexpr int kGroup = kC * 128;  // bytes of 8 rows
  constexpr int kTile = 8 * kGroup;  // bytes of 64 rows
  constexpr int kOut = DK / 2;      // f32 output accumulators a thread

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.y;
  const int split = blockIdx.x;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int wi = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const size_t head = (size_t)bh * s * d;
  const int n_kv = (s + kBlockN - 1) / kBlockN;
  // the block's q tiles: split, split + n_splits, ... below n_kv
  const int n_mine = (n_kv - split + n_splits - 1) / n_splits;

  unsigned char* k_s = smem_raw;
  unsigned char* q_wg = k_s + (size_t)round_up(s, 8) * kC * 16 + wg * 3 * kTile;
  unsigned char* v_wg = q_wg + kTile;  // two stages

  // prologue: the warpgroups' first q tiles and k
  if (wg < n_mine)
    e4t::load_core_async<64, DK, 128>(q_wg, q + head, (split + wg * n_splits) * 64, s, d, wt);
  load_rows_async<DK>(k_s, k + head, round_up(s, 8), s, d, tid);
  e4t::cp_async_commit();
  e4t::cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  for (int i = wg; i < n_mine; i += kWgGroups) {
    const int q0 = (split + i * n_splits) * 64;
    if (i != wg) {  // this warpgroup's products on its last q tile are complete
      wg_barrier(wg);
      e4t::load_core_async<64, DK, 128>(q_wg, q + head, q0, s, d, wt);
      e4t::cp_async_commit();
      e4t::cp_async_wait<0>();
      fence_proxy_async();
      wg_barrier(wg);
    }
    // v tile 0 lands during pass 1
    e4t::load_core_async<64, DK, 128>(v_wg, v + head, 0, s, d, wt);
    e4t::cp_async_commit();

    // pass 1: the row max over the whole row
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int kv0 = 0; kv0 < s; kv0 += kBlockN) {
      float sc[32];
      wgmma_scores<DK>(sc, q_wg, k_s, kv0, s, t4);
      row_max(sc, m0, m1);
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    // the scale is positive: the max of the scaled scores is the scaled max
    m0 *= scale_log2;
    m1 *= scale_log2;

    // pass 2: p = 2^(s scale log2 e - m) against the final max (one fma and
    // ex2.approx a score), l, and O += P V
    float o[kOut];
#pragma unroll
    for (int n = 0; n < kOut; ++n) o[n] = 0.f;
    float l0 = 0.f, l1 = 0.f;
    for (int kv0 = 0, j = 0; kv0 < s; kv0 += kBlockN, ++j) {
      float sc[32];
      wgmma_scores<DK>(sc, q_wg, k_s, kv0, s, t4);
      // p in the accumulator layout is the A-fragment layout of P V: score
      // columns 16kk..16kk+15 form k-step kk; an 8-column group wholly past
      // s is p = 0 without an exponential
      uint32_t pa[kBlockN / 16][4];
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
        float p00 = 0.f, p01 = 0.f, p10 = 0.f, p11 = 0.f;
        if (kv0 + n * 8 < s) {
          p00 = exp2_approx(fmaf(sc[4 * n + 0], scale_log2, -m0));
          p01 = exp2_approx(fmaf(sc[4 * n + 1], scale_log2, -m0));
          p10 = exp2_approx(fmaf(sc[4 * n + 2], scale_log2, -m1));
          p11 = exp2_approx(fmaf(sc[4 * n + 3], scale_log2, -m1));
          l0 += p00 + p01;
          l1 += p10 + p11;
        }
        pa[n >> 1][(n & 1) * 2 + 0] = e4t::pack_bf16(p00, p01);
        pa[n >> 1][(n & 1) * 2 + 1] = e4t::pack_bf16(p10, p11);
      }
      // v tile j has landed, and every warp of the warpgroup is done with
      // tile j - 1, whose stage tile j + 1 now refills
      e4t::cp_async_wait<0>();
      fence_proxy_async();
      wg_barrier(wg);
      if (kv0 + kBlockN < s) {
        e4t::load_core_async<64, DK, 128>(v_wg + ((j + 1) & 1) * kTile, v + head,
                                          kv0 + kBlockN, s, d, wt);
        e4t::cp_async_commit();
      }
      const unsigned char* vs = v_wg + (j & 1) * kTile;
      const int steps = min(kBlockN / 16, (s - kv0 + 15) / 16);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        if (kk < steps) wgmma_rs_tile<DK>(o, pa[kk], vs + 2 * kk * kGroup, kGroup);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;  // l >= 1: the max's own p
    const int row0 = q0 + wi * 16 + g, row1 = row0 + 8;
    bf16* ob = out + head;
#pragma unroll
    for (int n = 0; n < kOut / 4; ++n) {
      const int col = n * 8 + t4 * 2;
      if (col < d) {
        if (row0 < s)
          *reinterpret_cast<uint32_t*>(&ob[(size_t)row0 * d + col]) =
              e4t::pack_bf16(o[4 * n + 0] * inv0, o[4 * n + 1] * inv0);
        if (row1 < s)
          *reinterpret_cast<uint32_t*>(&ob[(size_t)row1 * d + col]) =
              e4t::pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
      }
    }
  }
}

// ---- up to S = 272: the whole score row in registers, one pass ----

// the shared memory of shortseq_row_kernel: k, v and one q tile
__host__ __device__ constexpr size_t row_smem_bytes(int dk, int s) {
  return (size_t)2 * dk * (round_up(s, 8) + round_up(s, 16) + 64);
}

// One warpgroup a block, walking the block's q tiles (tiles split,
// split + n_splits, ...). The head's k and v land once, as above. For each q
// tile all of S = Q K^T is issued at once, NF 64-column tiles and, where
// S mod 64 is at most 16, one 16-column tail (kTail), into registers (at
// S = 257: 4 x 32 + 8 = 136 f32 a thread); one wait; the row max over the
// whole row; p = 2^(s scale log2 e - m) rounded to bf16 in place as P V's A
// fragments; all of O += P V issued at once; one wait. Two round trips to
// the tensor pipe a q tile, and each score is computed once.
template <int DK, int NF, bool kTail>
__global__ void __launch_bounds__(128, 2)
shortseq_row_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out, int s, int d,
                    float scale_log2, int n_splits) {
  constexpr int kC = DK / 8;
  constexpr int kGroup = kC * 128;  // bytes of 8 rows
  constexpr int kOut = DK / 2;      // f32 output accumulators a thread

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* k_s = smem_raw;
  unsigned char* v_s = k_s + (size_t)round_up(s, 8) * kC * 16;
  unsigned char* q_s = v_s + (size_t)round_up(s, 16) * kC * 16;

  const int bh = blockIdx.y;
  const int split = blockIdx.x;
  const int tid = threadIdx.x;
  const int wi = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const size_t head = (size_t)bh * s * d;
  const int n_q = (s + 63) / 64;
  const int n_mine = (n_q - split + n_splits - 1) / n_splits;

  // prologue: the first q tile and k (group 0), then v (1)
  e4t::load_core_async<64, DK, 128>(q_s, q + head, split * 64, s, d, tid);
  load_rows_async<DK, 128>(k_s, k + head, round_up(s, 8), s, d, tid);
  e4t::cp_async_commit();
  load_rows_async<DK, 128>(v_s, v + head, round_up(s, 16), s, d, tid);
  e4t::cp_async_commit();
  e4t::cp_async_wait<1>();
  fence_proxy_async();
  __syncthreads();

  for (int i = 0; i < n_mine; ++i) {
    const int q0 = (split + i * n_splits) * 64;
    if (i > 0) {  // the last q tile's products are complete
      e4t::load_core_async<64, DK, 128>(q_s, q + head, q0, s, d, tid);
      e4t::cp_async_commit();
      e4t::cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
    }
    // S for the whole row: sc[t][4n + e], rows g (e < 2) and g + 8 of the
    // warp's 16, column 64t + 8n + 2 t4 + (e & 1); the tail likewise from
    // column 64 NF
    float sc[NF][32];
    float tl[8];
#pragma unroll
    for (int t = 0; t < NF; ++t) {
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[t][j] = 0.f;
      fence_regs(sc[t]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) tl[j] = 0.f;
    fence_regs(tl);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < NF; ++t) {
#pragma unroll
      for (int st = 0; st < DK / 16; ++st)
        wgmma_ss_n64(sc[t], smem_desc(q_s + st * 256, 128, kGroup),
                     smem_desc(k_s + 8 * t * kGroup + st * 256, 128, kGroup), st);
    }
    if constexpr (kTail) {
#pragma unroll
      for (int st = 0; st < DK / 16; ++st)
        e4t::wgmma_ss_n16(tl, smem_desc(q_s + st * 256, 128, kGroup),
                          smem_desc(k_s + 8 * NF * kGroup + st * 256, 128, kGroup), st);
    }
    wgmma_commit();
    if (i == 0) {  // v has landed
      e4t::cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
    }
    wgmma_wait<0>();
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int t = 0; t < NF; ++t) {
      mask_scores(sc[t], 64 * t, s, t4);
      row_max(sc[t], m0, m1);
    }
    fence_regs(tl);
    if constexpr (kTail) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (64 * NF + n * 8 + t4 * 2 + e >= s) tl[4 * n + e] = tl[4 * n + 2 + e] = -INFINITY;
      }
      row_max(tl, m0, m1);
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    m0 *= scale_log2;  // the scale is positive: the scaled max
    m1 *= scale_log2;

    // p against the final max, l, and P V's A fragments; an 8-column group
    // wholly past s is p = 0 without an exponential
    float l0 = 0.f, l1 = 0.f;
    uint32_t pa[NF][kBlockN / 16][4];
    uint32_t pt[4];
    auto softmax8 = [&](float s00, float s01, float s10, float s11, int col, uint32_t& lo,
                        uint32_t& hi) {
      float p00 = 0.f, p01 = 0.f, p10 = 0.f, p11 = 0.f;
      if (col < s) {
        p00 = exp2_approx(fmaf(s00, scale_log2, -m0));
        p01 = exp2_approx(fmaf(s01, scale_log2, -m0));
        p10 = exp2_approx(fmaf(s10, scale_log2, -m1));
        p11 = exp2_approx(fmaf(s11, scale_log2, -m1));
        l0 += p00 + p01;
        l1 += p10 + p11;
      }
      lo = e4t::pack_bf16(p00, p01);
      hi = e4t::pack_bf16(p10, p11);
    };
#pragma unroll
    for (int t = 0; t < NF; ++t) {
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n)
        softmax8(sc[t][4 * n], sc[t][4 * n + 1], sc[t][4 * n + 2], sc[t][4 * n + 3],
                 64 * t + n * 8, pa[t][n >> 1][(n & 1) * 2], pa[t][n >> 1][(n & 1) * 2 + 1]);
    }
    if constexpr (kTail) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
        softmax8(tl[4 * n], tl[4 * n + 1], tl[4 * n + 2], tl[4 * n + 3], 64 * NF + n * 8,
                 pt[2 * n], pt[2 * n + 1]);
    }

    float o[kOut];
#pragma unroll
    for (int n = 0; n < kOut; ++n) o[n] = 0.f;
    fence_regs(o);
#pragma unroll
    for (int t = 0; t < NF; ++t) fence_regs(pa[t]);
    fence_regs(pt);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < NF; ++t) {
      const int steps = min(kBlockN / 16, (s - 64 * t + 15) / 16);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        if (kk < steps)
          wgmma_rs_tile<DK>(o, pa[t][kk], v_s + (8 * t + 2 * kk) * kGroup, kGroup);
    }
    if constexpr (kTail) wgmma_rs_tile<DK>(o, pt, v_s + 8 * NF * kGroup, kGroup);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;  // l >= 1: the max's own p
    const int row0 = q0 + wi * 16 + g, row1 = row0 + 8;
    bf16* ob = out + head;
#pragma unroll
    for (int n = 0; n < kOut / 4; ++n) {
      const int col = n * 8 + t4 * 2;
      if (col < d) {
        if (row0 < s)
          *reinterpret_cast<uint32_t*>(&ob[(size_t)row0 * d + col]) =
              e4t::pack_bf16(o[4 * n + 0] * inv0, o[4 * n + 1] * inv0);
        if (row1 < s)
          *reinterpret_cast<uint32_t*>(&ob[(size_t)row1 * d + col]) =
              e4t::pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
      }
    }
  }
}

// The SMs of the current device, read once.
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <int DK>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int bh, int s,
                 int d, float scale_log2, cudaStream_t stream) {
  const size_t smem = wgmma_smem_bytes(DK, s);
  const cudaError_t err = e4t::allow_smem(shortseq_wgmma_kernel<DK>, smem);
  if (err != cudaSuccess) return (int)err;
  // below one head an SM, the q tiles of a head split over blocks (each
  // loading the head's k and v) so that the grid still fills the card
  const int n_kv = (s + kBlockN - 1) / kBlockN;
  const int n_splits = std::min(n_kv, (sm_count() + bh - 1) / bh);
  const dim3 grid(n_splits, bh);
  shortseq_wgmma_kernel<DK><<<grid, kWgThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), s, d, scale_log2, n_splits);
  return (int)cudaGetLastError();
}

template <int DK, int NF, bool kTail>
int launch_row(const void* q, const void* k, const void* v, void* out, int bh, int s, int d,
               float scale_log2, cudaStream_t stream) {
  const size_t smem = row_smem_bytes(DK, s);
  const cudaError_t err = e4t::allow_smem(shortseq_row_kernel<DK, NF, kTail>, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_q = (s + 63) / 64;
  const int n_splits = std::min(n_q, (sm_count() + bh - 1) / bh);
  const dim3 grid(n_splits, bh);
  shortseq_row_kernel<DK, NF, kTail><<<grid, 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), s, d, scale_log2, n_splits);
  return (int)cudaGetLastError();
}

// 128 < s <= 272: NF full 64-column tiles, and a 16-column tail where s mod
// 64 is 1..16 (else the last full tile is masked)
template <int DK>
int dispatch_row(const void* q, const void* k, const void* v, void* out, int bh, int s, int d,
                 float sl, cudaStream_t st) {
  const int nf = s / 64, rem = s % 64;
  switch (rem == 0 ? 2 * nf : rem <= 16 ? 2 * nf + 1 : 2 * nf + 2) {
    case 5: return launch_row<DK, 2, true>(q, k, v, out, bh, s, d, sl, st);
    case 6: return launch_row<DK, 3, false>(q, k, v, out, bh, s, d, sl, st);
    case 7: return launch_row<DK, 3, true>(q, k, v, out, bh, s, d, sl, st);
    case 8: return launch_row<DK, 4, false>(q, k, v, out, bh, s, d, sl, st);
    case 9: return launch_row<DK, 4, true>(q, k, v, out, bh, s, d, sl, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- the synchronous design, kept as the yardstick ----

// The launch for a padded head dim, by the synchronous design.
// The launch for a padded head dim: the synchronous design (kSync), else
// by S, the whole-row kernel for 128 < S <= 272 and the two-pass one for
// the rest.
template <bool kSync, int DK>
int launch_by(const void* q, const void* k, const void* v, void* out, int bh, int s, int d,
              float sl, cudaStream_t st) {
  if constexpr (kSync) {
    return launch<DK>(q, k, v, out, bh, s, d, sl, st);
  } else {
    if (s > 128 && s <= 272) return dispatch_row<DK>(q, k, v, out, bh, s, d, sl, st);
    return launch_wgmma<DK>(q, k, v, out, bh, s, d, sl, st);
  }
}

template <bool kSync, typename... Args>
int dispatch(int d, Args... a) {
  switch (e4t::padded_head_dim(d)) {
    case 16: return launch_by<kSync, 16>(a...);
    case 32: return launch_by<kSync, 32>(a...);
    case 48: return launch_by<kSync, 48>(a...);
    case 64: return launch_by<kSync, 64>(a...);
    case 80: return launch_by<kSync, 80>(a...);
    case 96: return launch_by<kSync, 96>(a...);
    case 112: return launch_by<kSync, 112>(a...);
    case 128: return launch_by<kSync, 128>(a...);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int bh, int s, int d) {
  return bh <= 0 || bh > 65535 || s <= 0 || s > kMaxSeq || d <= 0 || d % 8 != 0 || d > 128;
}

}  // namespace

// Plain C entry point for ctypes. q/k/v/out are contiguous (BH, S, D) bf16,
// 16-byte aligned, S up to 512, D a multiple of 8 up to 128. Runs on
// ``stream``, allocates nothing and does not synchronise. Returns
// cudaGetLastError() after the launch.
extern "C" int e4t_flash_fwd_shortseq(const void* q, const void* k, const void* v,
                                      void* out, int bh, int s, int d, float scale,
                                      void* stream) {
  if (bad_shape(bh, s, d)) return (int)cudaErrorInvalidValue;
  return dispatch<false>(d, q, k, v, out, bh, s, d, scale * e4t::kLog2e,
                         static_cast<cudaStream_t>(stream));
}

// The same function by the synchronous design: the yardstick chip_smoke.py
// times the kernels against. No path calls it.
extern "C" int e4t_flash_fwd_shortseq_sync(const void* q, const void* k, const void* v,
                                           void* out, int bh, int s, int d, float scale,
                                           void* stream) {
  if (bad_shape(bh, s, d)) return (int)cudaErrorInvalidValue;
  return dispatch<true>(d, q, k, v, out, bh, s, d, scale * e4t::kLog2e,
                        static_cast<cudaStream_t>(stream));
}
