#!/usr/bin/env python3
"""Time the port's full-width tuning or pretraining step on one NVIDIA
GPU with the training extras against the defaults, in turns.

    python3 e4t_diffusion_torch/time_train_step.py [--phase tune|pretrain]
        [--steps N] [--rounds R]

The counterpart of the JAX package's ``scripts/bench_tuning.py``
(``--phase tune``, the default) and ``scripts/bench_pretrain.py``
(``--phase pretrain``). A tuning run is ``tuning_e4t.tune`` at the CLI's
defaults in bf16 (batch 16, 512px, clip 1.0) from ``seeded.tuning_world``'s
weights, made anew for every run, under one configuration: ``default``
(f32 AdamW, remat "nothing"),
``8bit`` (``--use_8bit_adam``) and ``dots`` (``--remat_policy dots``). A
pretraining run is ``pretrain_e4t.pretrain`` in bf16 at batch 16, 512px
(the frozen UNet, VAE, text encoder and ViT-H; the encoder head and the
offset bank trained) from ``seeded.pretraining_world``'s weights and 40
written images of mixed sizes through the loader, under ``default`` and
``8bit``. The runs go in turns, ``--rounds`` rounds of the
configurations and then the same reversed (default, 8bit, dots, dots, 8bit,
default), so that a drift on the card or its host falls on every
configuration alike. A run reports
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
import json
import os
import statistics
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"default": (), "8bit": ("--use_8bit_adam",),
           "dots": ("--remat_policy", "dots")}
PRETRAIN_CONFIGS = {"default": (), "8bit": ("--use_8bit_adam",)}


def _tune_run(name, steps):
    """One tuning run under configuration ``name``: (the step seconds, the
    run's result)."""
    import torch

    from e4t_diffusion_torch import seeded, tuning_e4t
    from e4t_diffusion_torch.diffusion.schedulers import NoiseScheduleConfig
    from e4t_diffusion_torch.templates import resolve_templates

    modules, offsets, tokenizer, class_id, image = seeded.tuning_world()
    with tempfile.TemporaryDirectory() as out:
        run_args = tuning_e4t.parse_args([
            "--pretrained_model_name_or_path", "-",
            "--train_image_path", "-", "--max_train_steps",
            str(steps), "--mixed_precision", "bf16",
            "--output_dir", out, *CONFIGS[name]])
        return tuning_e4t.tune(
            run_args, modules, offsets, tokenizer, "*s",
            resolve_templates("normal"), class_id, image,
            NoiseScheduleConfig(), torch.bfloat16)


def _pretrain_run(name, steps, data_dir):
    """One pretraining run under configuration ``name`` (no samples, no
    checkpoint before its end)."""
    from e4t_diffusion_torch import pretrain_e4t, seeded

    world = seeded.pretraining_world()
    with tempfile.TemporaryDirectory() as out:
        run_args = seeded.pretrain_args(
            data_dir, out, "--mixed_precision", "bf16", "--max_train_steps",
            str(steps), "--n_save_sample", "0", "--checkpointing_steps",
            str(steps + 1), *PRETRAIN_CONFIGS[name])
        return seeded.pretrain(run_args, world,
                               pretrain_e4t.make_loader(run_args)[0])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phase", choices=("tune", "pretrain"),
                        default="tune")
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_train_step: needs an NVIDIA GPU")
    from e4t_diffusion_torch import seeded
    from e4t_diffusion_torch.ops.adam8bit import adam8bit_update
    from e4t_diffusion_torch.time_components import card_line

    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    configs = CONFIGS if args.phase == "tune" else PRETRAIN_CONFIGS
    order = list(configs) + list(configs)[::-1]
    runs = []
    with tempfile.TemporaryDirectory() as data_dir:
        if args.phase == "pretrain":
            seeded.write_pretraining_images(data_dir)
        for _ in range(args.rounds):
            for name in order:
                adam8bit_update.launches = adam8bit_update.tables = 0
                torch.cuda.reset_peak_memory_stats()
                result = (_tune_run(name, args.steps)
                          if args.phase == "tune" else
                          _pretrain_run(name, args.steps, data_dir))
                seconds = result["step_seconds"]
                runs.append({
                    "config": name, "step_seconds": seconds,
                    "warm_median_s": statistics.median(seconds[2:]),
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "adam8bit_launches": adam8bit_update.launches,
                    "adam8bit_tables": adam8bit_update.tables})
                del result
                gc.collect()
                torch.cuda.empty_cache()
    summary = {name: statistics.median(
        s for r in runs if r["config"] == name for s in r["step_seconds"][2:])
        for name in configs}
    batch = seeded.PRETRAIN_BATCH if args.phase == "pretrain" else 16
    print(json.dumps({"phase": args.phase, "batch": batch,
                      "warm_step_median_s": summary,
                      "samples_per_s": {k: batch / v
                                        for k, v in summary.items()},
                      "runs": runs}))


if __name__ == "__main__":
    main()
