#!/usr/bin/env python3
"""Profile the PyTorch port's int8 serving on one NVIDIA GPU: one warm
full-width DDIM-4 run with static activation scales (the serving flavor of
``inference.py --int8_static_act``; the first call calibrates) and one with
dynamic scales, batch 8, 512px, CFG 7.5, random weights made from a seed,
each under ``torch.profiler``.

    python3 e4t_diffusion_torch/profile_int8.py [--repo DIR] [--label TEXT]

``--repo`` names the checkout whose ``e4t_diffusion_torch`` is profiled (this
one by default), so one call can profile two commits on one card. The runs
are that checkout's pipeline through this checkout's ``chip_smoke.py``
helpers (``_full_width_pipeline``, ``_int8_profile``). For each run: the
wall time, the device's busy time and share, and the busy time split into
the int8 sites' parts, read off profiler ranges around the timed checkout's
``ops/quant`` functions (``torch.profiler.record_function``; a range's
device time is that of the PyTorch kernels launched inside it):

- the conv sites (``quant.int8_conv2d``): ``int8_conv_kernel``, the
  kernels named ``int8_conv*``, and ``conv_quant``, the PyTorch kernels
  inside the range (activation quantization, layout and padding passes,
  the dynamic scale; the conv kernel is launched through ctypes, tied to
  no PyTorch op, so the range does not hold it);
- the linear sites (``quant.int8_linear``): ``linear_quant``, its
  ``quantize_activation`` calls, ``int_mm``, its ``torch._int_mm`` calls,
  and ``linear_rest``, the rescale, cast and bias;
- ``rest``: everything else.

Prints the card's ``nvidia-smi`` line, then one JSON line. Needs a GPU;
imports no JAX.
"""
import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repo", default=HERE)
    parser.add_argument("--label", default="")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_int8: needs an NVIDIA GPU")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from e4t_diffusion_torch.diffusion.pipeline import (
        StableDiffusionE4TPipeline)

    smi = smoke.phase_environment()
    with tempfile.TemporaryDirectory() as tok_dir:
        pipe, _, _ = smoke._full_width_pipeline(tok_dir)
    image = np.random.default_rng(0).integers(
        0, 256, (smoke.RESOLUTION, smoke.RESOLUTION, 3), dtype=np.uint8)
    kwargs = dict(num_inference_steps=smoke.STEPS, guidance_scale=7.5,
                  num_images_per_prompt=smoke.IMAGES_PER_PROMPT,
                  height=smoke.RESOLUTION, width=smoke.RESOLUTION, seed=0)
    report = {"label": args.label, "repo": args.repo, "card": smi}
    for name, int8 in (("static", "static"), ("dynamic", True)):
        serving = StableDiffusionE4TPipeline(
            pipe.modules, pipe.offsets, pipe.tokenizer, pipe.e4t_config,
            already_added_placeholder_token=True, int8=int8)
        walls = []
        for _ in range(3):  # the first calibrates (static) and builds
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serving(smoke.PROMPTS, image, **kwargs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        report[f"{name}_ddim4"] = {
            "first_s": walls[0], "warm_s": walls[1:],
            "profile": smoke._int8_profile(
                lambda: serving(smoke.PROMPTS, image, **kwargs))}
        del serving
        torch.cuda.empty_cache()
    print(json.dumps(report))


if __name__ == "__main__":
    main()
