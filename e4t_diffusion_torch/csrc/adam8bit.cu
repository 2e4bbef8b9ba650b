// 8-bit AdamW for Hopper (sm_90a): one fused pass over every tensor of a
// parameter group.
//
// Replaces no Pallas kernel: the JAX package leaves its 8-bit AdamW to XLA
// (e4t_diffusion_tpu/training/optim8bit.py, adam_core :109-117 with
// _q_blocks :43 and _dq_blocks :60), which fuses it into a few loops. Eager
// PyTorch runs the same update as ~50 elementwise passes a chunk; this
// kernel is one. Per 256-element block of a tensor it loads g and p (f32),
// dequantizes both Adam moments from their log-codebook int8 codes and
// per-block absmax scales, updates the moments, the step and p (AdamW with
// decoupled decay in optax's order, p + (-lr) * (step + wd * p)), takes each
// new moment's block absmax and requantizes:
//   scale = absmax > 0 ? absmax : 1
//   logm  = log10(max(|x| / scale, 1e-30)) / 7
//   mu: c = rint(clamp(127 + 126 logm, 0, 127)), c = |x| > 0 ? max(c, 1) : 0,
//       code = sign(x) c
//   nu: c = rint(clamp(255 + 254 logm, 0, 255)), the same floor, code c - 128
// Every operation is the plain version's, one IEEE rounding each: __f*_rn
// intrinsics (never contracted into an fma, never a multiply by a
// reciprocal), rintf (half to even, as torch.round and jnp.round; roundf
// would move codes at ties), full-precision log10f (no fast math). The two
// codebooks (a code's value before the scale) come in as a table the
// wrapper builds with the plain version's formula, so the dequantized
// moments are its values exactly.
//
// What bounds it on the H100: bytes. Per element it reads g and p and
// writes p (12 bytes) and reads and writes two int8 codes (4), plus two f32
// scales a block: 16.06 bytes, 19.8 GB an update of tuning's 1.23 G f32
// trainables, 5.9 ms at 3.35 TB/s. The arithmetic (two log10f, five IEEE
// divisions and a square root an element) is of the same order on the CUDA
// cores. The design: one warp per block, eight consecutive elements a lane
// (two 16-byte loads each of g and p, one 8-byte load per code array),
// warp-shuffle maxima for the two absmax; each warp walks a contiguous run
// of blocks over all the group's tensors (a table of their pointers), so an
// update is one launch. A block's padded tail past the tensor's end counts
// as g = 0 and leaves p alone, as the JAX package pads with zeros.

#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kBlock = 256;                // elements a quantization block
constexpr int kPerLane = kBlock / 32;      // 8
constexpr int kWarpsPerCta = 8;
constexpr int kThreadsA = kWarpsPerCta * 32;

// One row of the wrapper's int64 table: the tensor's pointers, its element
// count and the index of its first block among the group's blocks.
struct TensorRow {
  long long p, g, mu_q, mu_s, nu_q, nu_s, n, block0;
};

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, b1c, b2c, weight_decay, neg_lr;
  int step_bf16;
};

// The code of x in the log codebook of its block's scale.
__device__ __forceinline__ int quantize(float x, float scale, bool is_signed) {
  const float mag = __fdiv_rn(fabsf(x), scale);
  const float logm = __fdiv_rn(log10f(fmaxf(mag, 1e-30f)), 7.0f);
  if (is_signed) {
    float c = rintf(fminf(fmaxf(__fadd_rn(__fmul_rn(logm, 126.0f), 127.0f), 0.0f), 127.0f));
    c = mag > 0.0f ? fmaxf(c, 1.0f) : 0.0f;
    return x < 0.0f ? -(int)c : (int)c;
  }
  float c = rintf(fminf(fmaxf(__fadd_rn(__fmul_rn(logm, 254.0f), 255.0f), 0.0f), 255.0f));
  c = mag > 0.0f ? fmaxf(c, 1.0f) : 0.0f;
  return (int)c - 128;
}

__device__ __forceinline__ int code_at(uint2 w, int e) {
  const uint32_t word = e < 4 ? w.x : w.y;
  return (int)(int8_t)((word >> (8 * (e & 3))) & 0xff);
}

__device__ __forceinline__ void update_block(const TensorRow& row, long long j, int lane,
                                             const float* book_s, const float* book_u,
                                             const Hyper& h) {
  float* p = reinterpret_cast<float*>(row.p);
  const float* g = reinterpret_cast<const float*>(row.g);
  int8_t* mu_q = reinterpret_cast<int8_t*>(row.mu_q);
  float* mu_s = reinterpret_cast<float*>(row.mu_s);
  int8_t* nu_q = reinterpret_cast<int8_t*>(row.nu_q);
  float* nu_s = reinterpret_cast<float*>(row.nu_s);
  const long long e0 = j * kBlock + lane * kPerLane;
  const bool vec = e0 + kPerLane <= row.n && ((row.p | row.g) & 15) == 0;

  float gv[kPerLane], pv[kPerLane];
  if (vec) {
    const float4* g4 = reinterpret_cast<const float4*>(g + e0);
    const float4* p4 = reinterpret_cast<const float4*>(p + e0);
    const float4 ga = g4[0], gb = g4[1], pa = p4[0], pb = p4[1];
    gv[0] = ga.x; gv[1] = ga.y; gv[2] = ga.z; gv[3] = ga.w;
    gv[4] = gb.x; gv[5] = gb.y; gv[6] = gb.z; gv[7] = gb.w;
    pv[0] = pa.x; pv[1] = pa.y; pv[2] = pa.z; pv[3] = pa.w;
    pv[4] = pb.x; pv[5] = pb.y; pv[6] = pb.z; pv[7] = pb.w;
  } else {
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const bool in = e0 + e < row.n;
      gv[e] = in ? g[e0 + e] : 0.0f;
      pv[e] = in ? p[e0 + e] : 0.0f;
    }
  }
  const long long c0 = j * kBlock + lane * kPerLane;
  const uint2 mq = *reinterpret_cast<const uint2*>(mu_q + c0);
  const uint2 nq = *reinterpret_cast<const uint2*>(nu_q + c0);
  const float ms = mu_s[j], ns = nu_s[j];

  float m[kPerLane], v[kPerLane];
  float m_max = 0.0f, v_max = 0.0f;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    float mu = __fmul_rn(book_s[code_at(mq, e) + 128], ms);
    float nu = __fmul_rn(book_u[code_at(nq, e) + 128], ns);
    mu = __fadd_rn(__fmul_rn(mu, h.b1), __fmul_rn(gv[e], h.one_minus_b1));
    nu = __fadd_rn(__fmul_rn(nu, h.b2), __fmul_rn(__fmul_rn(gv[e], h.one_minus_b2), gv[e]));
    float step = __fdiv_rn(__fdiv_rn(mu, h.b1c),
                           __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, h.b2c)), h.eps));
    if (h.step_bf16) step = __bfloat162float(__float2bfloat16_rn(step));
    pv[e] = __fadd_rn(pv[e], __fmul_rn(__fadd_rn(step, __fmul_rn(pv[e], h.weight_decay)),
                                       h.neg_lr));
    m[e] = mu;
    v[e] = nu;
    m_max = fmaxf(m_max, fabsf(mu));
    v_max = fmaxf(v_max, fabsf(nu));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m_max = fmaxf(m_max, __shfl_xor_sync(0xffffffffu, m_max, off));
    v_max = fmaxf(v_max, __shfl_xor_sync(0xffffffffu, v_max, off));
  }
  const float m_scale = m_max > 0.0f ? m_max : 1.0f;
  const float v_scale = v_max > 0.0f ? v_max : 1.0f;
  uint32_t mw[2] = {0u, 0u}, vw[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    mw[e / 4] |= (uint32_t)(quantize(m[e], m_scale, true) & 0xff) << (8 * (e % 4));
    vw[e / 4] |= (uint32_t)(quantize(v[e], v_scale, false) & 0xff) << (8 * (e % 4));
  }
  *reinterpret_cast<uint2*>(mu_q + c0) = make_uint2(mw[0], mw[1]);
  *reinterpret_cast<uint2*>(nu_q + c0) = make_uint2(vw[0], vw[1]);
  if (lane == 0) {
    mu_s[j] = m_scale;
    nu_s[j] = v_scale;
  }
  if (vec) {
    float4* p4 = reinterpret_cast<float4*>(p + e0);
    p4[0] = make_float4(pv[0], pv[1], pv[2], pv[3]);
    p4[1] = make_float4(pv[4], pv[5], pv[6], pv[7]);
  } else {
#pragma unroll
    for (int e = 0; e < kPerLane; ++e)
      if (e0 + e < row.n) p[e0 + e] = pv[e];
  }
}

__global__ void __launch_bounds__(kThreadsA)
adam8bit_kernel(const TensorRow* __restrict__ rows, int n_tensors, long long total_blocks,
                const float* __restrict__ codebooks, Hyper h) {
  __shared__ float book_s[256], book_u[256];
  book_s[threadIdx.x] = codebooks[threadIdx.x];
  book_u[threadIdx.x] = codebooks[256 + threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  const long long warps = (long long)gridDim.x * kWarpsPerCta;
  const long long first = total_blocks * warp / warps;
  const long long last = total_blocks * (warp + 1) / warps;
  if (first >= last) return;
  // the tensor of block `first`: the last row whose first block is <= it
  int lo = 0, hi = n_tensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (rows[mid].block0 <= first) lo = mid; else hi = mid - 1;
  }
  int t = lo;
  long long t_end = t + 1 < n_tensors ? rows[t + 1].block0 : total_blocks;
  for (long long b = first; b < last; ++b) {
    while (b >= t_end) {
      ++t;
      t_end = t + 1 < n_tensors ? rows[t + 1].block0 : total_blocks;
    }
    update_block(rows[t], b - rows[t].block0, lane, book_s, book_u, h);
  }
}

}  // namespace

// Plain C entry point for ctypes. rows: n_tensors x 8 int64 on the device (p,
// g, mu_q, mu_scale, nu_q, nu_scale pointers, element count, first block),
// total_blocks their blocks; p and g contiguous f32, the codes (blocks, 256)
// int8 8-byte aligned, the scales (blocks,) f32; codebooks 512 f32 on the
// device (the signed codebook, then the unsigned one, indexed by code + 128).
// Runs ``grid`` blocks of 256 threads on ``stream``, allocates nothing and
// does not synchronise. Returns cudaGetLastError() after the launch.
extern "C" int e4t_adam8bit(const void* rows, int n_tensors, long long total_blocks,
                            const void* codebooks, float b1, float one_minus_b1, float b2,
                            float one_minus_b2, float eps, float b1c, float b2c,
                            float weight_decay, float neg_lr, int step_bf16, int grid,
                            void* stream) {
  if (n_tensors <= 0 || total_blocks <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  const Hyper h{b1, one_minus_b1, b2, one_minus_b2, eps, b1c, b2c, weight_decay, neg_lr,
                step_bf16};
  adam8bit_kernel<<<grid, kThreadsA, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TensorRow*>(rows), n_tensors, total_blocks,
      static_cast<const float*>(codebooks), h);
  return (int)cudaGetLastError();
}
