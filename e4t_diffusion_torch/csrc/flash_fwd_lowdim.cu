// Low-head-dim flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces the TPU kernel e4t_diffusion_tpu/ops/flash_kernels.py:_flash_fwd_lowdim
// (body _flash_fwd_lowdim_kernel). Same contract: non-causal softmax attention
// over (BH, Sq, D) q and (BH, Sk, D) k/v, D a multiple of 8 below 128; returns
// out (BH, Sq, D) in bf16 and lse = m + log(l) (BH, Sq) in f32. p is rounded to
// bf16 before the P@V product, as in the TPU kernel; the row sum l adds the
// unrounded f32 p.
//
// What bounds it on the H100: at the UNet's 4096-token d=40 sites the work is
// 4*Sq*Sk*D tensor-core flops (0.17 ms of bf16 peak at BH=64) and Sq*Sk
// exponentials per head (~0.26 ms at 16 exp2/clk/SM), against ~0.03 ms of
// q/k/v/out traffic: the special-function unit, not memory, is the floor.
// The design keeps the score tile in registers (never in shared or device
// memory), folds the softmax scale into one multiply by scale*log2(e) so each
// score costs a single ex2, and runs both products on mma.sync tensor cores.
//
// Layout: one block of 4 warps per (bh, 64-row q tile); each warp owns 16 q
// rows. The q tile is staged through shared memory once and kept as mma
// A-fragments in registers. k and v stream through shared memory in 64-row
// tiles (v stored transposed so its B-fragments are 32-bit loads). D is padded
// with zeros in shared memory to DK = round_up(D, 16), the mma k-depth
// (40 -> 48, 80 stays 80). Ragged Sq and Sk edges are masked here, so the
// host passes unpadded tensors. Row pitches carry 8 extra halves so the
// fragment loads of the 8 row groups of a warp fall in distinct banks.
// The TPU kernel's transposed accumulator answered the TPU's 128-lane
// padding and has no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // q rows per block: 4 warps x 16
constexpr int kBlockN = 64;  // kv rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_lowdim_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse,
                        int sq, int sk, int d, float scale_log2) {
  constexpr int kPitch = DK + 8;        // q/k tile row pitch, in halves
  constexpr int kVtPitch = kBlockN + 8;  // transposed v tile row pitch
  constexpr int kSteps = DK / 16;        // mma k-steps over the head dim
  constexpr int kScoreTiles = kBlockN / 8;
  constexpr int kOutTiles = DK / 8;
  constexpr int kChunksDK = DK / 8;      // 16-byte chunks per padded row

  // the q tile is staged here first, then the buffer is reused for k tiles
  __shared__ __align__(16) __nv_bfloat16 qk_s[kBlockM * kPitch];
  __shared__ __align__(16) __nv_bfloat16 vt_s[DK * kVtPitch];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma row group
  const int t4 = lane & 3;   // thread within the group
  const int chunks = d >> 3;

  const __nv_bfloat16* qb = q + (size_t)bh * sq * d;
  const __nv_bfloat16* kb = k + (size_t)bh * sk * d;
  const __nv_bfloat16* vb = v + (size_t)bh * sk * d;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < kBlockM * kChunksDK; i += kThreads) {
    const int r = i / kChunksDK, c = i % kChunksDK;
    uint4 val = zero;
    if (q0 + r < sq && c < chunks)
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * d + c * 8);
    *reinterpret_cast<uint4*>(&qk_s[r * kPitch + c * 8]) = val;
  }
  __syncthreads();

  uint32_t qf[kSteps][4];
  const int qr = warp * 16 + g;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    qf[s][0] = ld32(&qk_s[qr * kPitch + s * 16 + t4 * 2]);
    qf[s][1] = ld32(&qk_s[(qr + 8) * kPitch + s * 16 + t4 * 2]);
    qf[s][2] = ld32(&qk_s[qr * kPitch + s * 16 + 8 + t4 * 2]);
    qf[s][3] = ld32(&qk_s[(qr + 8) * kPitch + s * 16 + 8 + t4 * 2]);
  }

  float o[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // running max (log2 domain) and this thread's share of the row sums, for
  // rows g and g + 8 of the warp's 16
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int kv0 = 0; kv0 < sk; kv0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile (or q)
    for (int i = tid; i < kBlockN * kChunksDK; i += kThreads) {
      const int r = i / kChunksDK, c = i % kChunksDK;
      uint4 kval = zero, vval = zero;
      if (kv0 + r < sk && c < chunks) {
        const size_t off = (size_t)(kv0 + r) * d + c * 8;
        kval = *reinterpret_cast<const uint4*>(kb + off);
        vval = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(&qk_s[r * kPitch + c * 8]) = kval;
      const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(&vval);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt_s[(c * 8 + j) * kVtPitch + r] = vh[j];
    }
    __syncthreads();

    float s[kScoreTiles][4];
#pragma unroll
    for (int n = 0; n < kScoreTiles; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kp = &qk_s[(n * 8 + g) * kPitch + t4 * 2];
#pragma unroll
      for (int st = 0; st < kSteps; ++st)
        mma_16816(s[n], qf[st], ld32(kp + st * 16), ld32(kp + st * 16 + 8));
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
      pa[n >> 1][(n & 1) * 2 + 0] = pack_bf16(p00, p01);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p10, p11);
    }
#pragma unroll
    for (int j = 0; j < kScoreTiles / 2; ++j) {
#pragma unroll
      for (int n = 0; n < kOutTiles; ++n) {
        const __nv_bfloat16* vp = &vt_s[(n * 8 + g) * kVtPitch + j * 16 + t4 * 2];
        mma_16816(o[n], pa[j], ld32(vp), ld32(vp + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int row0 = q0 + qr, row1 = row0 + 8;
  __nv_bfloat16* ob = out + (size_t)bh * sq * d;
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n) {
    const int col = n * 8 + t4 * 2;
    if (col < d) {
      if (row0 < sq)
        *reinterpret_cast<uint32_t*>(&ob[(size_t)row0 * d + col]) =
            pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
      if (row1 < sq)
        *reinterpret_cast<uint32_t*>(&ob[(size_t)row1 * d + col]) =
            pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
    }
  }
  if (t4 == 0) {
    const float ln2 = 0.693147180559945309f;
    if (row0 < sq) lse[(size_t)bh * sq + row0] = (m0 + log2f(fmaxf(l0, 1e-37f))) * ln2;
    if (row1 < sq) lse[(size_t)bh * sq + row1] = (m1 + log2f(fmaxf(l1, 1e-37f))) * ln2;
  }
}

template <int DK>
void launch(const void* q, const void* k, const void* v, void* out, void* lse,
            int bh, int sq, int sk, int d, float scale_log2, cudaStream_t stream) {
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  flash_fwd_lowdim_kernel<DK><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), sq, sk, d, scale_log2);
}

}  // namespace

// Plain C entry point for ctypes. q/k/v/out are contiguous bf16, 16-byte
// aligned; lse is contiguous f32. Runs on ``stream``, allocates nothing and
// does not synchronise. Returns cudaGetLastError() after the launch.
extern "C" int e4t_flash_fwd_lowdim(const void* q, const void* k, const void* v,
                                    void* out, void* lse, int bh, int sq, int sk,
                                    int d, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0 || d <= 0 || d % 8 != 0 || d >= 128)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16 * 16) {
    case 16: launch<16>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s); break;
    case 32: launch<32>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s); break;
    case 48: launch<48>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s); break;
    case 64: launch<64>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s); break;
    case 80: launch<80>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s); break;
    case 96: launch<96>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s); break;
    case 112: launch<112>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s); break;
    case 128: launch<128>(q, k, v, out, lse, bh, sq, sk, d, scale_log2, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* e4t_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
