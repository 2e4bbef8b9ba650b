#!/usr/bin/env python3
"""Profile the PyTorch port's f32 paths on one NVIDIA GPU: one full-width
DDIM-4 sampling run in f32 (``--dtype fp32``; batch 8, 512px, CFG 7.5) and
one full-width f32 tuning step (``--mixed_precision no``, batch 16), each
under ``torch.profiler``, with random weights made from a seed.

    python3 e4t_diffusion_torch/profile_f32.py [--repo DIR] [--label TEXT]

``--repo`` names the checkout whose ``e4t_diffusion_torch`` is profiled (this
one by default), so one call can profile two commits on one card. The runs
and the profile are this checkout's ``chip_smoke.py`` helpers
(``_full_width_pipeline``, ``_sample``, ``phase_tuning``, ``_profile``), with
their checks: for each run the wall time, the device's busy time and share,
the f32 attention kernels' time (``csrc/attention_f32.cu``, kernels named
attn_*) and share of the busy time, and the kernels that take the most.
Prints the card's ``nvidia-smi`` line, then one JSON line. Needs a GPU;
imports no JAX.
"""
import argparse
import contextlib
import importlib.util
import io
import json
import os
import sys
import tempfile

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
        sys.exit("profile_f32: needs an NVIDIA GPU")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    smi = smoke.phase_environment()  # TF32 off, as the reference
    with tempfile.TemporaryDirectory() as tok_dir:
        pipe, _, _ = smoke._full_width_pipeline(tok_dir)
    for m in pipe.modules.all():
        m.to(torch.float32)
    image = np.random.default_rng(0).integers(
        0, 256, (smoke.RESOLUTION, smoke.RESOLUTION, 3), dtype=np.uint8)
    want = smoke._want(flash_fwd_lowdim_f32=smoke.LOWDIM_SITES_PER_STEP
                       * smoke.STEPS)
    _, warm_s, _ = smoke._sample(pipe, image, "ddim", want)  # builds, warms
    _, ddim_s, _ = smoke._sample(pipe, image, "ddim", want)
    sampling = smoke._profile(lambda: pipe(
        smoke.PROMPTS, image, num_inference_steps=smoke.STEPS,
        guidance_scale=7.5, num_images_per_prompt=smoke.IMAGES_PER_PROMPT,
        height=smoke.RESOLUTION, width=smoke.RESOLUTION, seed=0))
    del pipe
    torch.cuda.empty_cache()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        smoke.phase_tuning(smi, steps=1, dtype=torch.float32, batch=16)
    tuning = json.loads(out.getvalue().strip().splitlines()[-1])
    print(json.dumps({
        "label": args.label, "repo": args.repo, "card": smi,
        "f32_ddim4": {"first_s": warm_s, "warm_s": ddim_s, "profile": sampling},
        "f32_tuning_step": {
            "batch": tuning["batch"], "s_per_step": tuning["s_per_step"],
            "max_memory_allocated_gb": tuning["max_memory_allocated_gb"],
            "profile": tuning["profile"]}}))


if __name__ == "__main__":
    main()
