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
// amortise its per-cell overhead. Blocks run in parallel here, and one
// block per g heads would give 16 blocks for 132 SMs at BH = 128, g = 8, so
// the kernel ignores g: one block of 4 warps per (head, 64-row q tile),
// 640 blocks at the sampling ViT's BH = 128 and S = 257.
//
// What bounds it on the H100: at BH = 128, S = 257, d = 80 the function
// moves 21 MB of q/k/v/out (6.3 us at 3.35 TB/s) and does 2.7 GFLOP of
// products (2.7 us) and 8.5 M exponentials (2.0 us): memory. The design
// reads q, k and v from device memory once per block and keeps the scores
// off it. The head's whole k (S rounded up to 64 rows, zero-padded) stays
// in shared memory for the block; v streams through one 64-row tile
// (transposed, so its B-fragments are 32-bit loads). Each warp owns 16 q
// rows, their mma A-fragments in registers. Pass 1 computes the warp's
// scores 64 columns at a time and keeps only the row max; pass 2 recomputes
// each 64-column score tile from the resident k (bit for bit the same f32
// sums), takes p = exp2(s * scale * log2 e - m) and multiplies it into v.
// A full score row would not fit in registers (16 x 512 f32 a warp is 256
// registers a thread at S = 512), and in shared memory beside k it would
// not fit at S = 512, d = 120; the recompute costs tensor-core time, which
// is not the bound. At S = 512 and d = 120 (padded to 128) the resident k is
// 139 KB and the block takes 157 KB of shared memory; at the ViT's shape
// 68 KB, three blocks an SM.

#include <math.h>

#include "flash_common.cuh"

namespace {

using e4t::bf16;
using e4t::kThreads;

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

}  // namespace

// Plain C entry point for ctypes. q/k/v/out are contiguous (BH, S, D) bf16,
// 16-byte aligned, S up to 512, D a multiple of 8 up to 128. Runs on
// ``stream``, allocates nothing and does not synchronise. Returns
// cudaGetLastError() after the launch.
extern "C" int e4t_flash_fwd_shortseq(const void* q, const void* k, const void* v,
                                      void* out, int bh, int s, int d, float scale,
                                      void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || s > kMaxSeq || d <= 0 || d % 8 != 0 || d > 128)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * e4t::kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (e4t::padded_head_dim(d)) {
    case 16: return launch<16>(q, k, v, out, bh, s, d, scale_log2, st);
    case 32: return launch<32>(q, k, v, out, bh, s, d, scale_log2, st);
    case 48: return launch<48>(q, k, v, out, bh, s, d, scale_log2, st);
    case 64: return launch<64>(q, k, v, out, bh, s, d, scale_log2, st);
    case 80: return launch<80>(q, k, v, out, bh, s, d, scale_log2, st);
    case 96: return launch<96>(q, k, v, out, bh, s, d, scale_log2, st);
    case 112: return launch<112>(q, k, v, out, bh, s, d, scale_log2, st);
    case 128: return launch<128>(q, k, v, out, bh, s, d, scale_log2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
