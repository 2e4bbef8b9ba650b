#!/usr/bin/env python3
"""Time the PyTorch port's bf16 flash backward (``flash_bwd``) on one NVIDIA
GPU at the tuning step's attention sites, beside the synchronous design,
SDPA's backward and the work's bound.

    python3 e4t_diffusion_torch/time_flash_bwd.py [--repo DIR]
                                                  [--ablate PART] [--label TEXT]

``--repo`` names the checkout whose ``e4t_diffusion_torch`` is timed (this
one by default), so one call can time two commits on one card, in turns:
unpack the other with ``git archive`` into a git-ignored directory and run
the script on each. ``--ablate`` times a copy of the wgmma kernels with
one part of their work changed, to see what bounds them: ``loads`` (the
dk/dv kernels load no q/dO tile after the first ones), ``exp`` (2^x
becomes x in the three kernels) or ``ordered_add`` (the d < 128 dk/dv
kernel also adds a
64 x DK f32 share of dq a q tile to a workspace, block after block in kv
order: a counter per (bh, q tile), an acquire spin and a release, the cost
of a one-pass backward's deterministic dq; nothing reads the workspace);
the copy goes to ``build/ablate-bwd-<part>/`` and is not checked. Otherwise
each shape: the kernels against the plain version
(``flash_bwd_reference``, rel-L2 <= 2e-2) and against the synchronous design
(``flash_bwd_sync``, where the checkout has it); two calls compared bit for
bit; CUDA events around one call (median of 20 after a warm-up, as
``time_flash_fwd.median_ms``); the device time of the dq kernel, the dk/dv
kernel and the rest (the PyTorch reduction delta = rowsum(out * dO)) apart,
under ``torch.profiler``. The bound counts the work the function needs: 10
flops per score and head dim (five products), one exponential per score,
each operand read once and each gradient written once. Prints the card's
``nvidia-smi`` line, then one JSON line. Needs a GPU; imports no JAX.
"""
import argparse
import json
import math
import os
import shutil
import subprocess
import sys

# (BH, Sq, Sk, d): the UNet's attention sites of a tuning step at batch 16
# (BH = 16 x 8 heads), 512px: self- and cross-attention (77 text tokens) at
# the 64², 32² and 16² latent levels; and a shape the JAX package sends to
# its blocked backward grids
SHAPES = ((128, 4096, 4096, 40), (128, 4096, 77, 40), (128, 1024, 1024, 80),
          (128, 1024, 77, 80), (128, 256, 256, 160), (128, 256, 77, 160),
          (2, 8192, 8192, 160))
GRAD_REL_L2 = 2e-2  # bf16 rounding of p, ds and the outputs (chip_smoke.py)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
EXP_PER_S = 16 * 132 * 1.98e9  # exp2 on the SFUs, 1.98 GHz boost
KERNEL = os.path.join("e4t_diffusion_torch", "csrc", "flash_bwd.cu")
# the ordered add: a workspace and counters for up to BH 128 x 64 q tiles of
# 64 rows x DK 48, the acquire and release, ...
_ORDERED_DECL = """
constexpr size_t kAccFloats = (size_t)128 * 4096 * 48;
__device__ float g_acc[kAccFloats];
__device__ int g_cnt[128 * 64];
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
"""
# ... the add after each tile's dk and dv products (the share's values are
# the dk accumulators: the cost, not the sum, is measured) ...
_ORDERED_ADD = """
    {
      int* cnt = g_cnt + bh * n_tiles + j;
      if (tid == 0) {
        long it = 0;
        while (ld_acquire(cnt) != (int)blockIdx.x)
          if (++it > (1L << 28)) __trap();
      }
      __syncthreads();
      constexpr int kN = DK / NWG;
      float* acc = g_acc + (((size_t)bh * n_tiles + j) * kTileQ) * DK;
      if ((((size_t)bh * n_tiles + j + 1) * kTileQ) * DK <= kAccFloats) {
#pragma unroll
        for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2* pp = reinterpret_cast<float2*>(
                acc + (wi * 16 + g + 8 * h) * DK + wg * kN + 8 * n + 2 * t4);
            float2 val = make_float2(adk[4 * n + 2 * h], adk[4 * n + 2 * h + 1]);
            if (blockIdx.x) {
              const float2 o = __ldcg(pp);
              val.x += o.x;
              val.y += o.y;
            }
            __stcg(pp, val);
          }
        }
      }
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        st_release(cnt, blockIdx.x + 1);
      }
    }
"""
# ... and the counters set to 0 before each call
_ORDERED_RESET = """  void* cnt = nullptr;
  err = cudaGetSymbolAddress(&cnt, g_cnt);
  if (err == cudaSuccess) err = cudaMemsetAsync(cnt, 0, sizeof(int) * 128 * 64, stream);
  if (err != cudaSuccess) return (int)err;
"""
_DKV_TILE_END = """    fence_regs(adk);

    e4t::cp_async_wait<kDkvStages - 2>();"""
_GROUPS = "  constexpr int kGroups = dkv_groups<DK>();\n"
_SMS = "constexpr int kSMs = 132;  // streaming multiprocessors of an H100 SXM\n"
# --ablate: [(text of flash_bwd.cu, its replacement, occurrences)]
ABLATIONS = {
    "loads": [("    if (nxt < n_tiles)\n      load_dkv_stage<",
               "    if (nxt < 2)\n      load_dkv_stage<", 2)],
    "exp": [("exp2_approx(fmaf(", "(fmaf(", 6)],
    "ordered_add": [(_SMS, _SMS + _ORDERED_DECL, 1),
                    (_DKV_TILE_END, "    fence_regs(adk);\n" + _ORDERED_ADD
                     + "\n    e4t::cp_async_wait<kDkvStages - 2>();", 1),
                    (_GROUPS, _ORDERED_RESET + _GROUPS, 1)],
}


def ablated_copy(repo, part):
    """A copy of ``repo``'s package under build/ablate-bwd-<part>/ with the
    kernels changed as ``ABLATIONS[part]`` says; returns its root."""
    root = os.path.join(repo, "build", f"ablate-bwd-{part}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(repo, "e4t_diffusion_torch"),
                    os.path.join(root, "e4t_diffusion_torch"))
    path = os.path.join(root, KERNEL)
    with open(path) as f:
        src = f.read()
    for old, new, count in ABLATIONS[part]:
        if src.count(old) != count:
            sys.exit(f"time_flash_bwd: --ablate {part}: the kernel has changed")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return root


def split_ms(fn, reps=10):
    """Device ms of one call by part: the kernels whose name holds "dkv",
    those whose name holds "dq_" and the rest (the delta reduction), summed
    under ``torch.profiler`` over ``reps`` calls after a warm-up. A session
    that records no kernel time is measured again, up to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        parts = {"dq": 0.0, "dkv": 0.0, "delta": 0.0}
        for evt in prof.key_averages():
            if (evt.device_type != DeviceType.CUDA
                    or getattr(evt, "is_user_annotation", False)):
                continue
            part = ("dkv" if "dkv" in evt.key else "dq" if "dq_" in evt.key
                    else "delta")
            parts[part] += evt.self_device_time_total / reps / 1e3
        if parts["dq"] > 0 and parts["dkv"] > 0:
            return parts
    sys.exit("time_flash_bwd: torch.profiler recorded no kernel time")


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repo", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--ablate", choices=sorted(ABLATIONS))
    parser.add_argument("--label", default="")
    args = parser.parse_args(argv)
    repo = os.path.abspath(args.repo)
    if args.ablate:
        repo = ablated_copy(repo, args.ablate)
    # time_flash_fwd.py is a sibling file, imported as a plain module so the
    # package that is timed comes from --repo alone
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from time_flash_fwd import median_ms

    sys.path.insert(0, repo)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("time_flash_bwd: needs an NVIDIA GPU")
    from e4t_diffusion_torch.ops import flash_bwd as fb
    from e4t_diffusion_torch.ops.flash_lowdim import flash_fwd

    sync = getattr(fb, "flash_bwd_sync", None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    for bh, sq, sk, d in SHAPES:
        q, k, v, dout = (torch.randn(bh, s, d, device="cuda", generator=gen)
                         .bfloat16() for s in (sq, sk, sk, sq))
        scale = 1.0 / math.sqrt(d)
        out, lse = flash_fwd(q, k, v, scale)

        def kernel():
            return fb.flash_bwd(q, k, v, out, lse, dout, scale)

        grads = kernel()
        refs = fb.flash_bwd_reference(q.float(), k.float(), v.float(),
                                      out.float(), lse, dout.float(), scale)
        rel = max(_rel(g, r) for g, r in zip(grads, refs))
        del refs
        if not args.ablate and not rel <= GRAD_REL_L2:
            sys.exit(f"time_flash_bwd: BH={bh} {sq}x{sk} d={d}: rel-L2 {rel}")
        row = {"bh": bh, "sq": sq, "sk": sk, "d": d, "grad_rel_l2": rel,
               "repeat_identical": all(torch.equal(a, b) for a, b in
                                       zip(grads, kernel()))}
        row["ms"] = median_ms(kernel)
        row["split_ms"] = split_ms(kernel)
        if sync is not None:
            def parent():
                return sync(q, k, v, out, lse, dout, scale)

            row["vs_sync_rel_l2"] = max(_rel(g, p) for g, p in
                                        zip(grads, parent()))
            row["sync_ms"] = median_ms(parent)
            row["sync_split_ms"] = split_ms(parent)
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qr[None], kr[None],
                                                 vr[None], scale=scale)
        row["sdpa_ms"] = median_ms(lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), dout[None], retain_graph=True))
        t_bytes = (2 * (4 * bh * sq * d + 4 * bh * sk * d) + 4 * bh * sq) \
            / HBM_BYTES_PER_S * 1e3
        t_ops = max(10 * bh * sq * sk * d / BF16_FLOP_PER_S,
                    bh * sq * sk / EXP_PER_S) * 1e3
        row.update(bound_ms=max(t_bytes, t_ops),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        rows.append(row)
        del q, k, v, dout, out, lse, grads, qr, kr, vr, lib_out
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "repo": args.repo,
                      "ablate": args.ablate, "card": smi, "rows": rows}))


if __name__ == "__main__":
    main()
