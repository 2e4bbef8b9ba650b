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
// The design keeps the score tile in registers (never in shared or device
// memory), folds the softmax scale into one multiply by scale*log2(e) so each
// score costs a single ex2, and runs both products on mma.sync tensor cores.
//
// Layout: one block of 4 warps per (bh, 64-row q tile); each warp owns 16 q
// rows. Up to DK = 128 the q tile is staged through shared memory once and
// kept as mma A-fragments in registers; wider heads keep q in shared memory
// and reload its fragments per kv tile, which leaves registers for the
// DK/8 x 4 f32 output accumulator (80 at d=160). k and v stream through
// shared memory in 64-row tiles (v stored transposed so its B-fragments are
// 32-bit loads). D is padded with zeros in shared memory to DK, the mma
// k-depth granularity (40 -> 48, 80 stays 80, 160 stays 160). Ragged Sq and
// Sk edges are masked here, so the host passes unpadded tensors. Row pitches
// carry 8 extra halves so the fragment loads of the 8 row groups of a warp
// fall in distinct banks. The TPU kernels' 128-lane padding of D has no
// counterpart here.

#include <math.h>

#include "flash_common.cuh"

namespace {

using e4t::bf16;
using e4t::kThreads;

constexpr int kBlockM = 64;  // q rows per block: 4 warps x 16
constexpr int kBlockN = 64;  // kv rows per tile

// q fragments stay in registers up to DK = 128 (see the layout note)
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

}  // namespace

// Plain C entry point for ctypes. q/k/v/out are contiguous bf16, 16-byte
// aligned, D a multiple of 8 up to 256; lse is contiguous f32. Runs on
// ``stream``, allocates nothing and does not synchronise. Returns
// cudaGetLastError() after the launch.
extern "C" int e4t_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int bh, int sq, int sk,
                             int d, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0 || d <= 0 || d % 8 != 0 || d > 256)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * e4t::kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
