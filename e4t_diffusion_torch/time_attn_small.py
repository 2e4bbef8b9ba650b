#!/usr/bin/env python3
"""Time the PyTorch port's short-sequence and int8 attention kernels on one
NVIDIA GPU at the shapes of their routes, beside their synchronous designs,
SDPA and the work's bound.

    python3 e4t_diffusion_torch/time_attn_small.py [--repo DIR]
                                                   [--ablate PART] [--label TEXT]

``--repo`` names the checkout whose ``e4t_diffusion_torch`` is timed (this
one by default), so one call can time two commits on one card, in turns:
unpack the other with ``git archive`` into a git-ignored directory and run
the script on each. ``--ablate`` times a copy of the kernels with one part
of their work taken out, to see what bounds them: ``loads`` (k and v are
loaded once, for the first tiles, and reused), ``exp`` (p = 2^x becomes x),
``s`` (S = Q K^T over the first k-step of the head dim only) or ``pv`` (P V
over the first k-step of each kv tile only). The copy goes to
``build/ablate-<part>/`` and is not checked (an ablated output is wrong).
Otherwise each shape: the kernel against its plain version (bf16 rounding,
rel-L2 <= 1e-2) and against the synchronous design (``*_sync``, where the
checkout has it), then the kernel, the synchronous design and SDPA's
forward on the same q/k/v: the device time under ``torch.profiler``
(``chip_smoke.device_ms``) where it is under 0.1 ms, since a CUDA-event
time there is the host's launch time, else CUDA events around one call,
median of 20 after a warm-up. The int8 kernels run at the route's kv tile
(``flash_int8.quant_tile``), where the checkout has it. Prints the card's
``nvidia-smi`` line, then one JSON line. Needs a GPU; imports no JAX.
"""
import argparse
import json
import math
import os
import shutil
import sys

# (BH, S, d): the ViT-H's 257-token sites when sampling at batch 8 (BH 128)
# and tuning at batch 16 (BH 256), and the ends of the route's range
SHORTSEQ_SHAPES = ((128, 257, 80), (256, 257, 80), (256, 129, 80),
                   (256, 512, 120))
# (BH, S, d): the UNet's two low-dim flash sites when sampling at batch 8
INT8_SHAPES = ((64, 4096, 40), (64, 1024, 80))
KERNELS = {"shortseq": os.path.join("e4t_diffusion_torch", "csrc",
                                    "flash_fwd_shortseq.cu"),
           "int8": os.path.join("e4t_diffusion_torch", "csrc",
                                "flash_fwd_int8.cu")}
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


def ablated_copy(repo, part):
    """A copy of ``repo``'s package and chip_smoke.py under
    build/ablate-<part>/ with the kernels changed as ``ABLATIONS[part]``
    says; returns the copy's root."""
    root = os.path.join(repo, "build", f"ablate-{part}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(repo, "e4t_diffusion_torch"),
                    os.path.join(root, "e4t_diffusion_torch"))
    shutil.copy(os.path.join(repo, "chip_smoke.py"), root)
    for kernel, edits in ABLATIONS[part].items():
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
    sys.path.insert(0, repo)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("time_attn_small: needs an NVIDIA GPU")
    # the timed checkout's own helpers (older checkouts have these too)
    from chip_smoke import _bound, cuda_time_ms, device_ms, nvidia_smi_line
    from e4t_diffusion_torch.ops import attention
    from e4t_diffusion_torch.ops import flash_int8 as fi
    from e4t_diffusion_torch.ops import shortseq as ss

    def timed(fn):
        """(ms, how): the device time where it is under 0.1 ms, else CUDA
        events (``chip_smoke.small_aware_ms``)."""
        ms = device_ms(fn)
        return (ms, "device") if ms < 0.1 else (cuda_time_ms(fn), "events")

    smi = nvidia_smi_line()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)
    check = not args.ablate
    rows = []
    ss_sync = getattr(ss, "flash_fwd_shortseq_sync", None)
    for bh, s, d in SHORTSEQ_SHAPES:
        q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen)
                   .bfloat16() for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        out = ss.flash_fwd_shortseq(q, k, v, scale, 8)
        ref = ss.flash_fwd_shortseq_reference(q.float(), k.float(),
                                              v.float(), scale)
        row = {"kernel": "flash_fwd_shortseq", "bh": bh, "sq": s, "sk": s,
               "d": d, "out_rel_l2": _rel(out, ref)}
        del ref
        if check and not row["out_rel_l2"] <= 1e-2:
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
        row.update(_bound(2 * 4 * bh * s * d, 4 * bh * s * s * d, bh * s * s))
        rows.append(row)
        del q, k, v, out
        torch.cuda.empty_cache()
    i8_sync = getattr(fi, "flash_fwd_int8_sync", None)
    tiled = hasattr(fi, "quant_tile")
    for mode in ("qk", "qkpv"):
        for bh, s, d in INT8_SHAPES:
            q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen)
                       .bfloat16() for _ in range(3))
            k = k + 0.5
            scale = 1.0 / math.sqrt(d)
            ops = attention.int8_attention_operands(q, k, v, scale, mode)
            tile = (fi.quant_tile(s),) if tiled else ()
            out, _ = fi.flash_fwd_int8(*ops, mode, torch.bfloat16, *tile)
            ref, _ = fi.flash_fwd_int8_reference(*ops, mode, torch.float32,
                                                 *tile)
            row = {"kernel": "flash_fwd_int8", "mode": mode, "bh": bh,
                   "sq": s, "sk": s, "d": d, "tile": tile[0] if tile else 64,
                   "out_rel_l2": _rel(out, ref)}
            del ref
            if check and not row["out_rel_l2"] <= 1e-2:
                sys.exit(f"time_attn_small: {row}")
            row["ms"], row["ms_by"] = timed(
                lambda: fi.flash_fwd_int8(*ops, mode, torch.bfloat16, *tile))
            if i8_sync is not None:
                sync, _ = i8_sync(*ops, mode, torch.bfloat16, *tile)
                row["sync_vs_kernel_rel_l2"] = _rel(out, sync)
                row["sync_identical"] = torch.equal(out, sync)
                row["sync_ms"], row["sync_ms_by"] = timed(
                    lambda: i8_sync(*ops, mode, torch.bfloat16, *tile))
            row["route_ms"], _ = timed(lambda: attention._int8_lowdim_path(
                q, k, v, scale, mode))
            row["sdpa_ms"], row["sdpa_ms_by"] = timed(
                lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], scale=scale))
            pv = mode == "qkpv"
            row.update(_bound(
                bh * s * d * (2 if pv else 3) + 8 * bh + 2 * bh * s * d
                + 4 * bh * s, 0 if pv else 2 * bh * s * s * d, bh * s * s,
                int8_ops=(4 if pv else 2) * bh * s * s * d))
            rows.append(row)
            del q, k, v, ops, out
            torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "repo": args.repo,
                      "ablate": args.ablate, "card": smi, "rows": rows}))


if __name__ == "__main__":
    main()
