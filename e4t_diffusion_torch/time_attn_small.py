#!/usr/bin/env python3
"""Time the PyTorch port's short-sequence and int8 attention kernels on one
NVIDIA GPU at the shapes of their routes, beside their synchronous designs,
SDPA and the work's bound.

    python3 e4t_diffusion_torch/time_attn_small.py [--repo DIR] [--dtype bf16|f32]
                                                   [--ablate PART] [--label TEXT]

``--dtype f32`` times the f32 kernels of ``csrc/attention_f32.cu``: the
short-sequence kernel at ``SHORTSEQ_SHAPES`` and the int8 attention in
mode "qk" (int8 q/k, f32 v and output) at ``INT8_SHAPES``, each beside its
synchronous design (``flash_fwd_shortseq_f32_sync``,
``flash_fwd_int8_sync``, where the checkout has them), f32 SDPA with TF32
off and the FFMA bound (67 TFLOP/s), held to rel-L2 1e-5 against the plain
version and the synchronous design; bf16 (the default) is described
below.

``--repo`` names the checkout whose ``e4t_diffusion_torch`` is timed (this
one by default), so one call can time two commits on one card, in turns:
unpack the other with ``git archive`` into a git-ignored directory and run
the script on each. ``--ablate`` times a copy of the kernels with one part
of their work taken out, to see what bounds them: ``loads`` (k and v are
loaded once, for the first tiles, and reused), ``exp`` (p = 2^x becomes x),
``s`` (S = Q K^T over the first k-step of the head dim only) or ``pv`` (P V
over the first k-step of each kv tile only); with ``--dtype f32`` the same
parts of the int8 "qk" f32 kernel (``F32_ABLATIONS``: ``s`` over the first
two words of the head dim, ``pv`` over the first 4 kv rows of a
tile). The
copy goes to ``build/ablate-<part>/`` and is not checked (an ablated output
is wrong).
Otherwise each shape: the kernel against its plain version (bf16 rounding,
rel-L2 <= 1e-2) and against the synchronous design (``*_sync``, where the
checkout has it), then the kernel, the synchronous design and SDPA's
forward on the same q/k/v: the device time under ``torch.profiler``
(``timing.device_ms``) where it is under 0.1 ms, since a CUDA-event
time there is the host's launch time, else CUDA events around one call,
median of 20 after a warm-up. The int8 kernels run at the route's kv tile
(``flash_int8.quant_tile``), where the checkout has it. Prints the card's
``nvidia-smi`` line, then one JSON line. Needs a GPU; imports no JAX.
"""
import argparse
import importlib.util
import json
import math
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (BH, S, d): the ViT-H's 257-token sites when sampling at batch 8 (BH 128)
# and tuning at batch 16 (BH 256), and the ends of the route's range
SHORTSEQ_SHAPES = ((128, 257, 80), (256, 257, 80), (256, 129, 80),
                   (256, 512, 120))
# the f32 FFMA rate (timing.F32_FLOP_PER_S) and the f32 kernel's tolerance
# against its plain version (timing.KERNEL_F32_REL_L2)
F32_FLOP_PER_S = 67e12
F32_REL_L2 = 1e-5
# (BH, S, d): the UNet's two low-dim flash sites when sampling at batch 8
INT8_SHAPES = ((64, 4096, 40), (64, 1024, 80))
KERNELS = {"shortseq": os.path.join("e4t_diffusion_torch", "csrc",
                                    "flash_fwd_shortseq.cu"),
           "int8": os.path.join("e4t_diffusion_torch", "csrc",
                                "flash_fwd_int8.cu"),
           "int8_f32": os.path.join("e4t_diffusion_torch", "csrc",
                                    "attention_f32.cu")}
# --ablate: {kernel: [(text of its source, its replacement, occurrences)]}
ABLATIONS = {
    "loads": {
        "shortseq": [
            ("load_rows_async<DK, 128>(k_s, k + head, round_up(s, 8), s, d, tid);",
             "load_rows_async<DK, 128>(k_s, k + head, 64, s, d, tid);", 1),
            ("load_rows_async<DK, 128>(v_s, v + head, round_up(s, 16), s, d, tid);",
             "load_rows_async<DK, 128>(v_s, v + head, 64, s, d, tid);", 1)],
        "int8": [("    if (j + kStages - 1 < n_steps) load_step(",
                  "    if (j + kStages - 1 < kStages - 1) load_step(", 1)]},
    "exp": {"shortseq": [("= exp2_approx(fmaf(s0", "= (fmaf(s0", 2),
                         ("= exp2_approx(fmaf(s1", "= (fmaf(s1", 2)],
            "int8": [("? exp2_approx(fmaf(i2f_exact(", "? (fmaf(i2f_exact(", 1)]},
    "s": {"shortseq": [("for (int st = 0; st < DK / 16; ++st)\n        wgmma_ss_n64(sc[t]",
                        "for (int st = 0; st < 1; ++st)\n        wgmma_ss_n64(sc[t]", 1)],
          "int8": [("for (int kst = 0; kst < kQB / 32; ++kst)\n",
                    "for (int kst = 0; kst < 1; ++kst)\n", 1)]},
    "pv": {"shortseq": [("        if (kk < steps)\n          wgmma_rs_tile<DK>(o, pa[t][kk]",
                         "        if (kk < 1)\n          wgmma_rs_tile<DK>(o, pa[t][kk]", 1)],
           "int8": [("for (int h = 0; h < 2; ++h)\n          wgmma_s8_rs",
                     "for (int h = 0; h < 1; ++h)\n          wgmma_s8_rs", 1),
                    ("for (int kk = 0; kk < kBlockN / 16; ++kk)\n          e4t::wgmma_rs_tile",
                     "for (int kk = 0; kk < 1; ++kk)\n          e4t::wgmma_rs_tile", 1)]},
}

# --ablate with --dtype f32: the int8 "qk" f32 kernel (attn_f32_fwd_int8_kernel)
F32_ABLATIONS = {
    "loads": {"int8_f32": [
        ("    if (t + 1 < n_tiles) {\n      load_i8_async<kBN, DK, kT>(k_s, kb, kv0 + kBN",
         "    if (false) {\n      load_i8_async<kBN, DK, kT>(k_s, kb, kv0 + kBN", 1),
        ("    load_f4_async<kBN, DK, kT>(v_s, vb, kv0, sk, DK, tid);",
         "    if (t == 0) load_f4_async<kBN, DK, kT>(v_s, vb, kv0, sk, DK, tid);",
         1)]},
    "exp": {"int8_f32": [
        ("const float ms = -mx * s_log2;\n#pragma unroll\n      for (int j = 0; "
         "j < kCN; ++j) {\n        const float p = e4t::exp2_approx(fmaf(s[i][j], "
         "s_log2, ms));",
         "const float ms = -mx * s_log2;\n#pragma unroll\n      for (int j = 0; "
         "j < kCN; ++j) {\n        const float p = (fmaf(s[i][j], s_log2, ms));",
         1)]},
    "s": {"int8_f32": [("  for (int w = 0; w < DK / 4; w += 2) {\n    int2 b",
                        "  for (int w = 0; w < 2; w += 2) {\n    int2 b", 1)]},
    # (a bound computed at run time, min(n1, n0 + 4), stalled the build)
    "pv": {"int8_f32": [("(o, p_s, v_s, oy, ox, n0, n1);",
                         "(o, p_s, v_s, oy, ox, 0, 4);", 1)]},
}


def ablated_copy(repo, part, ablations=ABLATIONS):
    """A copy of ``repo``'s package under build/ablate-<part>/ with the kernels changed as ``ablations[part]``
    says; returns the copy's root."""
    root = os.path.join(repo, "build", f"ablate-{part}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(repo, "e4t_diffusion_torch"),
                    os.path.join(root, "e4t_diffusion_torch"))
    for kernel, edits in ablations[part].items():
        path = os.path.join(root, KERNELS[kernel])
        with open(path) as f:
            src = f.read()
        for old, new, count in edits:
            if src.count(old) != count:
                sys.exit(f"time_attn_small: --ablate {part}: the {kernel} "
                         f"kernel has changed")
            src = src.replace(old, new)
        with open(path, "w") as f:
            f.write(src)
    return root


def shortseq_bound_args(bh, s, d, f32=False):
    """The arguments of ``timing.bound`` for the short-sequence forward's
    work: q, k, v read and out written once, 4 S^2 D flops at the bf16 or
    the f32 rate, one exponential per score."""
    return ((4 if f32 else 2) * 4 * bh * s * d, 4 * bh * s * s * d,
            bh * s * s), ({"flop_rate": F32_FLOP_PER_S} if f32 else {})


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repo", default=HERE)
    parser.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    parser.add_argument("--ablate", choices=sorted(ABLATIONS))
    parser.add_argument("--label", default="")
    args = parser.parse_args(argv)
    repo = os.path.abspath(args.repo)
    f32 = args.dtype == "f32"
    if args.ablate:
        repo = ablated_copy(repo, args.ablate,
                            F32_ABLATIONS if f32 else ABLATIONS)
    sys.path.insert(0, repo)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("time_attn_small: needs an NVIDIA GPU")
    # this checkout's helpers beside the timed checkout's package
    spec = importlib.util.spec_from_file_location(
        "e4t_timing", os.path.join(HERE, "e4t_diffusion_torch", "timing.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    _bound, cuda_time_ms = timing.bound, timing.cuda_time_ms
    device_ms, nvidia_smi_line = timing.device_ms, timing.nvidia_smi_line
    from e4t_diffusion_torch.ops import attention
    from e4t_diffusion_torch.ops import flash_int8 as fi
    from e4t_diffusion_torch.ops import shortseq as ss

    def timed(fn):
        """(ms, how): the device time where it is under 0.1 ms, else CUDA
        events (``timing.small_aware_ms``)."""
        ms = device_ms(fn)
        return (ms, "device") if ms < 0.1 else (cuda_time_ms(fn), "events")

    smi = nvidia_smi_line()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)
    check = not args.ablate
    rows = []
    ss_sync = getattr(ss, "flash_fwd_shortseq_f32_sync" if f32
                      else "flash_fwd_shortseq_sync", None)
    dtype = torch.float32 if f32 else torch.bfloat16
    for bh, s, d in SHORTSEQ_SHAPES:
        q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen)
                   .to(dtype) for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        out = ss.flash_fwd_shortseq(q, k, v, scale, 8)
        ref = ss.flash_fwd_shortseq_reference(q.float(), k.float(),
                                              v.float(), scale)
        row = {"kernel": "flash_fwd_shortseq" + ("_f32" if f32 else ""),
               "bh": bh, "sq": s, "sk": s,
               "d": d, "out_rel_l2": _rel(out, ref)}
        del ref
        if check and not row["out_rel_l2"] <= (F32_REL_L2 if f32 else 1e-2):
            sys.exit(f"time_attn_small: {row}")
        row["ms"], row["ms_by"] = timed(
            lambda: ss.flash_fwd_shortseq(q, k, v, scale, 8))
        if ss_sync is not None:
            sync = ss_sync(q, k, v, scale, 8)
            row["sync_vs_kernel_rel_l2"] = _rel(out, sync)
            row["sync_identical"] = torch.equal(out, sync)
            row["sync_ms"], row["sync_ms_by"] = timed(
                lambda: ss_sync(q, k, v, scale, 8))
        row["sdpa_ms"], row["sdpa_ms_by"] = timed(
            lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                   scale=scale))
        args_, kwargs = shortseq_bound_args(bh, s, d, f32)
        row.update(_bound(*args_, **kwargs))
        rows.append(row)
        del q, k, v, out
        torch.cuda.empty_cache()
    i8_sync = getattr(fi, "flash_fwd_int8_sync", None)
    tiled = hasattr(fi, "quant_tile")
    for mode in ("qk",) if f32 else ("qk", "qkpv"):
        for bh, s, d in INT8_SHAPES:
            q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen)
                       .to(dtype) for _ in range(3))
            k = k + 0.5
            scale = 1.0 / math.sqrt(d)
            ops = attention.int8_attention_operands(q, k, v, scale, mode)
            tile = (fi.quant_tile(s),) if tiled else ()
            out, _ = fi.flash_fwd_int8(*ops, mode, dtype, *tile)
            ref, _ = fi.flash_fwd_int8_reference(*ops, mode, torch.float32,
                                                 *tile)
            row = {"kernel": "flash_fwd_int8" + ("_qk_f32" if f32 else ""),
                   "mode": mode, "bh": bh,
                   "sq": s, "sk": s, "d": d, "tile": tile[0] if tile else 64,
                   "out_rel_l2": _rel(out, ref)}
            del ref
            tol = F32_REL_L2 if f32 else 1e-2
            if check and not row["out_rel_l2"] <= tol:
                sys.exit(f"time_attn_small: {row}")
            row["ms"], row["ms_by"] = timed(
                lambda: fi.flash_fwd_int8(*ops, mode, dtype, *tile))
            sync_fn = i8_sync
            if sync_fn is not None:
                try:
                    sync, _ = sync_fn(*ops, mode, dtype, *tile)
                except TypeError:  # an older checkout: no f32 "qk" design
                    sync_fn = None
            if sync_fn is not None:
                row["sync_vs_kernel_rel_l2"] = _rel(out, sync)
                row["sync_identical"] = torch.equal(out, sync)
                if check and not row["sync_vs_kernel_rel_l2"] <= tol:
                    sys.exit(f"time_attn_small: {row}")
                row["sync_ms"], row["sync_ms_by"] = timed(
                    lambda: sync_fn(*ops, mode, dtype, *tile))
            row["route_ms"], _ = timed(lambda: attention._int8_lowdim_path(
                q, k, v, scale, mode))
            row["sdpa_ms"], row["sdpa_ms_by"] = timed(
                lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], scale=scale))
            # q and k int8, v int8 ("qkpv") or in the output's type,
            # written out and lse, the per-head scales
            pv, e = mode == "qkpv", q.element_size()
            row.update(_bound(
                bh * s * d * (3 if pv else 2 + e) + 8 * bh + e * bh * s * d
                + 4 * bh * s, 0 if pv else 2 * bh * s * s * d, bh * s * s,
                int8_ops=(4 if pv else 2) * bh * s * s * d,
                **({"flop_rate": F32_FLOP_PER_S} if f32 else {})))
            rows.append(row)
            del q, k, v, ops, out
            torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "repo": args.repo,
                      "dtype": args.dtype, "ablate": args.ablate,
                      "card": smi, "rows": rows}))


if __name__ == "__main__":
    main()
