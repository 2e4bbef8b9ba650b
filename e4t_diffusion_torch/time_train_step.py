#!/usr/bin/env python3
"""Time the port's full-width tuning step on one NVIDIA GPU with the
training extras against the defaults, in turns.

    python3 e4t_diffusion_torch/time_train_step.py [--steps N] [--rounds R]

Each run is ``tuning_e4t.tune`` at the CLI's defaults in bf16 (batch 16,
512px, clip 1.0) from ``chip_smoke._tuning_world``'s seeded weights, made
anew for every run, under one configuration: ``default`` (f32 AdamW, remat
"nothing"), ``8bit`` (``--use_8bit_adam``) and ``dots`` (``--remat_policy
dots``). The runs go in turns, ``--rounds`` rounds of default, 8bit, dots,
dots, 8bit, default (the second half of a round reversed), so that a drift
on the card or its host falls on every configuration alike. A run reports
its steps' synchronised wall times, the median of those after the first
two (the warm steps; the second still allocates), peak memory
(``max_memory_allocated``), its 8-bit AdamW launches and the pointer
tables the 8-bit wrapper built (one while the tensors stay). Prints the
card's ``nvidia-smi`` line, then one JSON line: every run, and per
configuration the median over its runs' warm steps. Needs a GPU; imports no
JAX.
"""
import argparse
import gc
import importlib.util
import json
import os
import statistics
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"default": (), "8bit": ("--use_8bit_adam",),
           "dots": ("--remat_policy", "dots")}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_train_step: needs an NVIDIA GPU")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from e4t_diffusion_torch import tuning_e4t
    from e4t_diffusion_torch.diffusion.schedulers import NoiseScheduleConfig
    from e4t_diffusion_torch.ops.adam8bit import adam8bit_update
    from e4t_diffusion_torch.templates import resolve_templates

    print(smoke.nvidia_smi_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    order = list(CONFIGS) + list(CONFIGS)[::-1]
    runs = []
    for _ in range(args.rounds):
        for name in order:
            modules, offsets, tokenizer, class_id, image = (
                smoke._tuning_world(smoke.RESOLUTION))
            with tempfile.TemporaryDirectory() as out:
                run_args = tuning_e4t.parse_args([
                    "--pretrained_model_name_or_path", "-",
                    "--train_image_path", "-", "--max_train_steps",
                    str(args.steps), "--mixed_precision", "bf16",
                    "--output_dir", out, *CONFIGS[name]])
                adam8bit_update.launches = adam8bit_update.tables = 0
                torch.cuda.reset_peak_memory_stats()
                result = tuning_e4t.tune(
                    run_args, modules, offsets, tokenizer, "*s",
                    resolve_templates("normal"), class_id, image,
                    NoiseScheduleConfig(), torch.bfloat16)
            seconds = result["step_seconds"]
            runs.append({"config": name, "step_seconds": seconds,
                         "warm_median_s": statistics.median(seconds[2:]),
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "adam8bit_launches": adam8bit_update.launches,
                         "adam8bit_tables": adam8bit_update.tables})
            del modules, offsets, result
            gc.collect()
            torch.cuda.empty_cache()
    summary = {name: statistics.median(
        s for r in runs if r["config"] == name for s in r["step_seconds"][2:])
        for name in CONFIGS}
    print(json.dumps({"warm_step_median_s": summary, "runs": runs}))


if __name__ == "__main__":
    main()
