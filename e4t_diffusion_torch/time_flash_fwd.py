#!/usr/bin/env python3
"""Time the PyTorch port's bf16 flash forward (``flash_fwd``) on one NVIDIA
GPU at the shapes of its paths, beside SDPA and the work's bound.

    python3 e4t_diffusion_torch/time_flash_fwd.py [--repo DIR]
                                                  [--ablate PART] [--label TEXT]

``--repo`` names the checkout whose ``e4t_diffusion_torch`` is timed (this
one by default), so one call can time two commits on one card, in turns:
unpack the other with ``git archive`` into a git-ignored directory and run
the script on each. ``--ablate`` times a copy of
the d < 128 kernel with one part of its work taken out, to see what bounds
it: ``loads`` (no k/v tile is loaded after the first ones), ``exp`` (2^x
becomes x), ``s`` (S = Q K^T over the first 16 head dims only) or ``pv``
(P V over the first 16 kv rows only); the copy goes to
``build/ablate-<part>/`` and its output is wrong, so it is not checked.
Otherwise each shape: the kernel against its plain version (bf16 rounding,
rel-L2 <= 1e-2), then CUDA events around one call, median of 20 after a
warm-up. Prints the card's ``nvidia-smi`` line, then one JSON line. Needs
a GPU; imports no JAX.
"""
import argparse
import json
import math
import os
import shutil
import subprocess
import sys

# (BH, Sq, Sk, d): the UNet's two low-dim flash sites when sampling at batch
# 8 (BH 64) and tuning at batch 16 (BH 128), 512px, and the ViT-H's sites
# when tuning (BH 256)
SHAPES = ((64, 4096, 4096, 40), (64, 1024, 1024, 80), (128, 4096, 4096, 40),
          (128, 1024, 1024, 80), (256, 257, 257, 80))
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
EXP_PER_S = 16 * 132 * 1.98e9  # exp2 on the SFUs, 1.98 GHz boost
KERNEL = os.path.join("e4t_diffusion_torch", "csrc", "flash_fwd_lowdim.cu")
# --ablate: (text of the d < 128 kernel, its replacement)
ABLATIONS = {
    "loads": ("    if (nxt < n_tiles) {", "    if (nxt < kWgStages - 1) {"),
    "exp": ('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
            "  y = x;"),
    "s": ("for (int st = 0; st < kSteps; ++st)\n      wgmma_ss_n64(",
          "for (int st = 0; st < 1; ++st)\n      wgmma_ss_n64("),
    "pv": ("for (int kk = 0; kk < kBlockN / 16; ++kk)\n      wgmma_rs<DK>(",
           "for (int kk = 0; kk < 1; ++kk)\n      wgmma_rs<DK>("),
}


def ablated_copy(repo, part):
    """A copy of ``repo``'s package under build/ablate-<part>/ with one part
    of the d < 128 kernel's work taken out; returns the copy's root."""
    root = os.path.join(repo, "build", f"ablate-{part}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(repo, "e4t_diffusion_torch"),
                    os.path.join(root, "e4t_diffusion_torch"))
    path = os.path.join(root, KERNEL)
    with open(path) as f:
        src = f.read()
    old, new = ABLATIONS[part]
    if src.count(old) != 1:
        sys.exit(f"time_flash_fwd: --ablate {part}: the kernel has changed")
    with open(path, "w") as f:
        f.write(src.replace(old, new))
    return root


def median_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


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
        sys.exit("time_flash_fwd: needs an NVIDIA GPU")
    from e4t_diffusion_torch.ops.flash_lowdim import (flash_fwd,
                                                       flash_fwd_reference)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    for bh, sq, sk, d in SHAPES:
        q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen)
                   .bfloat16() for s in (sq, sk, sk))
        scale = 1.0 / math.sqrt(d)
        out, _ = flash_fwd(q, k, v, scale)
        ref, _ = flash_fwd_reference(q.float(), k.float(), v.float(), scale)
        rel = ((out.float() - ref).norm() / ref.norm()).item()
        del ref
        if not args.ablate and not rel <= 1e-2:
            sys.exit(f"time_flash_fwd: BH={bh} {sq}x{sk} d={d}: rel-L2 {rel}")
        t_bytes = 2 * 2 * bh * (sq + sk) * d / HBM_BYTES_PER_S * 1e3
        t_ops = max(4 * bh * sq * sk * d / BF16_FLOP_PER_S,
                    bh * sq * sk / EXP_PER_S) * 1e3
        rows.append({
            "bh": bh, "sq": sq, "sk": sk, "d": d, "out_rel_l2": rel,
            "ms": median_ms(lambda: flash_fwd(q, k, v, scale)),
            "sdpa_ms": median_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"})
        del q, k, v, out
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "repo": args.repo,
                      "ablate": args.ablate,
                      "card": smi, "rows": rows}))


if __name__ == "__main__":
    main()
