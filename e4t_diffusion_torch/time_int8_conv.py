#!/usr/bin/env python3
"""Time the PyTorch port's int8 convolution on one NVIDIA GPU at every
quantized conv shape of a batch-8 512px SD-v1 UNet pass, beside its
synchronous design, the routes from a bf16 NCHW activation, cuDNN's bf16
convolution and the work's bound, each summed over a UNet pass.

    python3 e4t_diffusion_torch/time_int8_conv.py [--repo DIR] [--ablate PART]
                                                  [--label TEXT]

``--repo`` names the checkout whose ``e4t_diffusion_torch`` is timed (this
one by default), so one call can time two commits on one card, in turns:
unpack the other with ``git archive`` into a git-ignored directory and run
the script on each. ``--ablate`` times a copy of the conv kernel with one
part of its work taken out, to see what bounds it (``ABLATIONS``); the copy
goes to ``build/ablate-conv-<part>/`` and is not checked (an ablated output
is wrong).

The shapes are this checkout's ``timing.unet_conv_shapes(8, 512)``. At
each, on seeded operands: the kernel (``int8_conv``: int8 NHWC x and OHWI w,
bf16 NCHW out with the rescale and bias) held bit for bit against the
synchronous design (``int8_conv_sync``, where the checkout has it) or else
the plain version, then timed beside it; the old route (``quant.
quantize_activation`` in PyTorch, the NHWC permute, the kernel) and the
checkout's route (``quant.int8_conv2d``) from a bf16 NCHW activation, with
a static scale ("sa") and a dynamic one, held bit for bit against each
other; cuDNN's bf16 ``F.conv2d`` of the same shapes; and two bounds: the
kernel's (int8 x and w read once, the output written once, the int8
operations at 1,979 TOP/s) and the route's (x read once in bf16). Times are
the device time under ``torch.profiler`` where it is under 0.1 ms
(``timing.device_ms``), else CUDA events around one call, median of 20
after a warm-up. Prints the card's ``nvidia-smi`` line, then one JSON line.
Needs a GPU; imports no JAX.
"""
import argparse
import importlib.util
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = os.path.join("e4t_diffusion_torch", "csrc", "int8_conv.cu")
# --ablate: [(text of the kernel's source, its replacement, occurrences)]
ABLATIONS = {
    # the weight tiles and the halo (int8, or x staged) are loaded for the
    # first k-steps only
    "loads": [("    if (j + kStages - 1 < n_steps) load_step(",
               "    if (j + kStages - 1 < kStages - 1) load_step(", 1),
              ("    if (kFill == Fill::kStaged && t == 0 && ci + 1 < n_cc) stage_raw(",
               "    if (false) stage_raw(", 1)],
    # x quantized for the first chunk only
    "quant": [("    if (kFill != Fill::kS8 && ci + 1 < n_cc) {",
               "    if (false) {", 1)],
    # one k32 product a k-step instead of kKC / 32
    "mma": [("for (int ks = 0; ks < kKC / 32; ++ks)\n      wgmma_s8_rs160",
             "for (int ks = 0; ks < 1; ++ks)\n      wgmma_s8_rs160", 1)],
    # no block barrier a step (the ring then races: timing only)
    "barrier": [("    e4t::fence_proxy_async();\n    __syncthreads();\n    if (j + kStages",
                 "    e4t::fence_proxy_async();\n    if (j + kStages", 1)],
    # no proxy fence a step
    "fence": [("    e4t::fence_proxy_async();\n    __syncthreads();\n    if (j + kStages",
               "    __syncthreads();\n    if (j + kStages", 1)],
    # the epilogue stores nothing
    "store": [("  __syncthreads();\n  T* out = static_cast<T*>(a.out);",
               "  __syncthreads();\n  if (a.vec_store >= 0) return;\n"
               "  T* out = static_cast<T*>(a.out);", 1)],
}


def ablated_copy(repo, part):
    """A copy of ``repo``'s package under build/ablate-conv-<part>/ with the
    conv kernel changed as ``ABLATIONS[part]`` says; returns its root."""
    root = os.path.join(repo, "build", f"ablate-conv-{part}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(repo, "e4t_diffusion_torch"),
                    os.path.join(root, "e4t_diffusion_torch"))
    path = os.path.join(root, KERNEL)
    with open(path) as f:
        src = f.read()
    for old, new, count in ABLATIONS[part]:
        if src.count(old) != count:
            sys.exit(f"time_int8_conv: --ablate {part}: the kernel has "
                     f"changed")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return root


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repo", default=HERE)
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
        sys.exit("time_int8_conv: needs an NVIDIA GPU")
    # this checkout's helpers beside the timed checkout's package
    spec = importlib.util.spec_from_file_location(
        "e4t_timing", os.path.join(HERE, "e4t_diffusion_torch", "timing.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    from e4t_diffusion_torch.ops import int8_conv as ic
    from e4t_diffusion_torch.ops import quant

    def timed(fn):
        ms = timing.device_ms(fn)
        return ms if ms < 0.1 else timing.cuda_time_ms(fn)

    # the old route: PyTorch quantization, the NHWC permute, the kernel
    quantize = getattr(quant, "quantize_activation_reference",
                       quant.quantize_activation)

    def old_route(x, site, bias, stride, pad):
        xq, sx = quantize(x, site, 1)
        return ic.int8_conv(xq.permute(0, 2, 3, 1).contiguous(), site["q"],
                            (sx * site["s"]).float(), bias, x.dtype, stride,
                            pad)

    smi = timing.nvidia_smi_line()
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    sync = getattr(ic, "int8_conv_sync", None)
    gen = torch.Generator("cuda").manual_seed(0)
    check = not args.ablate
    n = len(timing.PROMPTS) * timing.IMAGES_PER_PROMPT
    rows = []
    for (c, o, h, w, k, stride, pad), sites in sorted(
            timing.unet_conv_shapes(n, timing.RESOLUTION).items()):
        x = torch.randint(-127, 128, (n, h, w, c), device="cuda",
                          generator=gen, dtype=torch.int8)
        wt = torch.randint(-127, 128, (o, k, k, c), device="cuda",
                           generator=gen, dtype=torch.int8)
        scale = torch.rand(o, device="cuda", generator=gen) * 1e-4
        bias = torch.randn(o, device="cuda", generator=gen).bfloat16()
        out = ic.int8_conv(x, wt, scale, bias, torch.bfloat16, stride, pad)
        row = {"c": c, "o": o, "h": h, "w": w, "k": k, "stride": stride,
               "pad": pad, "sites": sites}
        if check:
            want = (sync(x, wt, scale, bias, torch.bfloat16, stride, pad)
                    if sync else ic.int8_conv_reference(
                        x, wt, scale, bias, torch.bfloat16, stride, pad))
            if not torch.equal(out, want):
                sys.exit(f"time_int8_conv: the kernel differs from "
                         f"{'int8_conv_sync' if sync else 'its plain version'}"
                         f": {row}")
            del want
        row["ms"] = timed(lambda: ic.int8_conv(x, wt, scale, bias,
                                               torch.bfloat16, stride, pad))
        if sync:
            row["sync_ms"] = timed(lambda: sync(x, wt, scale, bias,
                                                torch.bfloat16, stride, pad))
        xb = torch.randn(n, c, h, w, device="cuda", generator=gen,
                         dtype=torch.bfloat16)
        wb = torch.randn(o, c, k, k, device="cuda", generator=gen,
                         dtype=torch.bfloat16)
        site = quant.quantize_kernel(wb)
        site["q"] = site["q"].permute(0, 2, 3, 1).contiguous()
        static = dict(site, sa=xb.float().abs().amax() * 0.8 / 127.0)
        for mode, s_ in (("sa", static), ("dynamic", site)):
            old = old_route(xb, s_, bias, stride, pad)
            new = quant.int8_conv2d(xb, s_, bias, stride, pad)
            if check and not torch.equal(old, new):
                sys.exit(f"time_int8_conv: the routes differ ({mode}): {row}")
            del old, new
            row[f"old_route_{mode}_ms"] = timed(
                lambda: old_route(xb, s_, bias, stride, pad))
            row[f"route_{mode}_ms"] = timed(
                lambda: quant.int8_conv2d(xb, s_, bias, stride, pad))
        row["cudnn_bf16_ms"] = timed(lambda: F.conv2d(
            xb, wb, bias, stride=stride, padding=pad))
        ho, wo = out.shape[2:]
        ops = 2 * n * ho * wo * o * k * k * c
        out_bytes = 2 * n * o * ho * wo
        row["bound_ms"] = timing.bound(n * h * w * c + o * k * k * c + 6 * o
                                       + out_bytes, 0, 0,
                                       int8_ops=ops)["bound_ms"]
        row["route_bound_ms"] = timing.bound(2 * n * h * w * c + o * k * k * c
                                             + 6 * o + out_bytes, 0, 0,
                                             int8_ops=ops)["bound_ms"]
        rows.append(row)
        del x, wt, scale, bias, out, xb, wb, site, static
        torch.cuda.empty_cache()
    keys = [k for k in rows[0] if k == "ms" or k.endswith("_ms")]
    per_pass = {k: sum(r["sites"] * r[k] for r in rows) for k in keys}
    print(json.dumps({"label": args.label, "repo": args.repo,
                      "ablate": args.ablate, "card": smi,
                      "per_unet_pass": per_pass, "rows": rows}))


if __name__ == "__main__":
    main()
