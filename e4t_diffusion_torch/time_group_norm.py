#!/usr/bin/env python3
"""Time the PyTorch port's GroupNorm kernel on one NVIDIA GPU at every
GroupNorm site of a batch-8 512px SD-v1 UNet pass and VAE decode, beside
its first design, ATen's ``F.group_norm`` (+ ``F.silu``) and the work's
bound, each summed over a UNet pass and a decode.

    python3 e4t_diffusion_torch/time_group_norm.py [--repo DIR] [--label TEXT]

``--repo`` names the checkout whose ``e4t_diffusion_torch`` is timed (this
one by default), so one call can time two commits on one card, in turns:
unpack the other with ``git archive`` into a git-ignored directory and run
the script on each.

The sites are this checkout's ``chip_smoke._group_norm_sites(…, "cuda")``:
(C, H, W, groups, eps, act, layout) with their counts, in the memory layout
the card gives each site's input (NCHW, or channels-last). At each, on a
seeded bf16 input with bf16 weight and bias: the kernel
(``groupnorm.fused_group_norm``) held against its plain version in f32
(rel-L2 <= 1e-2, ``chip_smoke.GN_BF16_REL_L2``) and against the first
design (``group_norm_sync``, where the checkout has it), then timed beside
it, ``F.group_norm`` then ``F.silu`` and the bound (x read once, y written
once, weight and bias read once, at 3.35 TB/s). Times are the device time
under ``torch.profiler`` where it is under 0.1 ms, else CUDA events around
one call, median of 20 after a warm-up (``chip_smoke.small_aware_ms``, with
its fallback to CUDA events around 20 calls when the profiler records no
device time). Prints the card's ``nvidia-smi`` line, then one JSON line:
the sums per UNet pass and per decode, the decode's sums by (H, layout),
and every site. Needs a GPU; imports no JAX.
"""
import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8
RESOLUTION = 512


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repo", default=HERE)
    parser.add_argument("--label", default="")
    args = parser.parse_args(argv)
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("time_group_norm: needs an NVIDIA GPU")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from e4t_diffusion_torch.models.unet import UNetConfig
    from e4t_diffusion_torch.models.vae import VAEConfig
    from e4t_diffusion_torch.ops import groupnorm as gn

    smi = smoke.nvidia_smi_line()
    print(smi)
    sync = getattr(gn, "group_norm_sync", None)
    sites = smoke._group_norm_sites(UNetConfig(), VAEConfig(), BATCH,
                                    RESOLUTION, "cuda")
    torch.cuda.empty_cache()
    gen = torch.Generator("cuda").manual_seed(0)
    parts = {}
    for part in ("unet", "vae_decode"):
        rows = parts[part] = []
        for (c, h, w, groups, eps, act, layout), count in sorted(
                sites[part].items(), key=str):
            x = (torch.randn(BATCH, c, h, w, device="cuda", generator=gen)
                 * 2 + 0.5).bfloat16()
            if layout == "nhwc":
                x = x.contiguous(memory_format=torch.channels_last)
            weight = (torch.rand(c, device="cuda", generator=gen)
                      + 0.5).bfloat16()
            bias = (torch.randn(c, device="cuda", generator=gen)
                    * 0.5).bfloat16()

            def kernel():
                return gn.fused_group_norm(x, weight, bias, groups, eps, act)

            def library():
                y = F.group_norm(x, groups, weight, bias, eps)
                return F.silu(y) if act == "silu" else y

            out = kernel()
            ref = gn.group_norm_reference(x.float(), weight, bias, groups,
                                          eps, act)
            row = {"c": c, "h": h, "w": w, "groups": groups, "act": act,
                   "layout": layout, "sites": count,
                   "out_rel_l2": smoke._rel(out, ref)}
            del ref
            if not row["out_rel_l2"] <= smoke.GN_BF16_REL_L2:
                sys.exit(f"time_group_norm: the kernel disagrees with its "
                         f"plain version: {row}")
            row["ms"], row["ms_by"] = smoke.small_aware_ms(kernel)
            if sync is not None:
                row["sync_vs_kernel_rel_l2"] = smoke._rel(
                    out, sync(x, weight, bias, groups, eps, act).float())
                if not row["sync_vs_kernel_rel_l2"] <= smoke.GN_BF16_REL_L2:
                    sys.exit(f"time_group_norm: the kernel disagrees with "
                             f"group_norm_sync: {row}")
                row["sync_ms"], row["sync_ms_by"] = smoke.small_aware_ms(
                    lambda: sync(x, weight, bias, groups, eps, act))
            row["library_ms"], row["library_ms_by"] = smoke.small_aware_ms(
                library)
            row["bound_ms"] = smoke._bound(
                2 * x.numel() * x.element_size()
                + 2 * c * weight.element_size(), 0, 0)["bound_ms"]
            rows.append(row)
            del x, out, weight, bias
            torch.cuda.empty_cache()
    keys = [k for k in parts["unet"][0] if k == "ms" or k.endswith("_ms")]
    sums = {part: {k: sum(r["sites"] * r[k] for r in rows) for k in keys}
            for part, rows in parts.items()}
    by_size = {}
    for r in parts["vae_decode"]:
        key = f"{r['h']}x{r['w']} {r['layout']}"
        entry = by_size.setdefault(key, {"sites": 0, **{k: 0.0 for k in keys}})
        entry["sites"] += r["sites"]
        for k in keys:
            entry[k] += r["sites"] * r[k]
    print(json.dumps({"label": args.label, "repo": args.repo, "card": smi,
                      "batch": BATCH, "resolution": RESOLUTION,
                      "per_unet_pass": sums["unet"],
                      "per_vae_decode": sums["vae_decode"],
                      "vae_decode_by_size": by_size, "rows": parts}))


if __name__ == "__main__":
    main()
