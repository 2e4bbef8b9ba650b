"""E4T phase-2 domain tuning CLI: ``python -m e4t_diffusion_torch.tuning_e4t``.

Loads a phase-1 artifact directory (weight offsets + encoder) and its SD
base, fine-tunes the E4T encoder and the full UNet (and the text encoder
with ``--train_text_encoder``) on ONE image for a few steps, and saves
``unet.pt`` / ``encoder.pt`` / ``text_encoder.pt`` / ``domain.png`` /
``config.json`` with the pretraining config nested under
``pretrained_args``. Flags are the reference's (root ``tuning_e4t.py``),
with ``--device`` added; flags that CLI ignores are accepted and ignored.
Runs on the GPU unless ``--device cpu`` is given; ``--mixed_precision``
``bf16`` or ``fp16`` (both bf16 compute) is required there.

As in the reference, the image is transformed once and VAE-encoded once
outside the loop (the latent posterior is drawn a single time); each step
draws fresh noise, timesteps (from a ``torch.Generator`` seeded with
``--seed``) and templates.

Options of the JAX CLI's training extras: ``--use_8bit_adam`` (AdamW with
block-quantized int8 moments, ``training/optim8bit.py``, one kernel launch
an update on the card), ``--remat_policy dots`` (the UNet calls keep their
matrix products' and convolutions' outputs for the backward),
``--profile_steps N`` (a ``torch.profiler`` trace of steps [2, 2+N) into
``--profile_dir``, by default ``<output_dir>/profile``) and ``--report_to``
(the losses and learning rate each update to TensorBoard or wandb under
``<output_dir>/<logging_dir>``; none by default).

Several cards: ``torchrun --nproc_per_node N -m
e4t_diffusion_torch.tuning_e4t ... [--tensor_parallel T]`` runs one process
a card. ``--train_batch_size`` is per dp rank (N / T ranks), each drawing
its own posterior, noise, timesteps and templates (seeded ``--seed`` plus
its dp rank); ``--tensor_parallel`` splits the trained UNet's attention and
feed-forward sites (and so their AdamW moments) over T ranks. Rank 0 writes
the artifacts, the UNet gathered to its unsplit layout.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from e4t_diffusion_torch.config import load_config
from e4t_diffusion_torch.data.dataset import load_image_rgb, make_transform
from e4t_diffusion_torch.diffusion.pipeline import E4TModules, resolve_device
from e4t_diffusion_torch.diffusion.schedulers import (DDPMScheduler,
                                                      NoiseScheduleConfig)
from e4t_diffusion_torch.parallel import mesh as pmesh
from e4t_diffusion_torch.templates import resolve_templates
from e4t_diffusion_torch.training.setup import (
    TemplateSampler, build_modules, default_resolution, make_lr_schedule,
    prepare_tokenizer, resolve_class_token, scale_learning_rate)
from e4t_diffusion_torch.training.train_step import (
    REMAT_POLICIES, E4TTrainConfig, encode_latents, make_optimizer,
    make_train_step, split_trainable)
from e4t_diffusion_torch.utils import artifacts
from e4t_diffusion_torch.utils.hub import resolve_model_dir
from e4t_diffusion_torch.utils.profiling import trace
from e4t_diffusion_torch.utils.trackers import make_tracker


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--pretrained_model_name_or_path", type=str,
                        required=True,
                        help="Path to the phase-1 artifact directory.")
    parser.add_argument("--domain_embed_scale", type=float, default=0.1,
                        help="scale of e4t encoder's embedding")
    parser.add_argument("--reg_lambda", type=float, default=1e-4,
                        help="l2 regularization lambda")
    parser.add_argument("--train_image_path", type=str, required=True,
                        help="an image path (local)")
    parser.add_argument("--prompt_template", type=str, default=None,
                        help="If None, take the template from pretrained args.")
    parser.add_argument("--unfreeze_clip_vision", action="store_true",
                        default=False)
    parser.add_argument("--resolution", type=int, default=None,
                        help="image side (default: the base UNet's "
                             "sample_size x 8, 512 for SD v1, 768 for "
                             "SD 2.1; the JAX CLI's default is 512 on "
                             "every base)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--gradient_accumulation_steps", type=int, default=1)
    parser.add_argument("--micro_batches", type=int, default=1,
                        help="split each step's batch into N sequential "
                             "micro-batches (in-step gradient accumulation; "
                             "the effective batch stays train_batch_size)")
    parser.add_argument("--max_grad_norm", default=1.0, type=float)
    parser.add_argument("--learning_rate", type=float, default=1.6e-5)
    parser.add_argument("--scale_lr", action="store_true", default=False)
    parser.add_argument("--train_batch_size", type=int, default=16)
    parser.add_argument("--max_train_steps", type=int, default=15)
    parser.add_argument("--dataloader_num_workers", type=int, default=0,
                        help="accepted and ignored (one image, no loader)")
    parser.add_argument("--checkpointing_steps", type=int, default=10000)
    parser.add_argument("--enable_xformers_memory_efficient_attention",
                        action="store_true",
                        help="accepted and ignored; flash attention is "
                             "always used")
    parser.add_argument("--train_text_encoder", action="store_true")
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="write a torch.profiler trace of steps "
                             "[2, 2+N) (0: none)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="trace output dir (default <output>/profile)")
    parser.add_argument("--remat_policy", type=str, default="nothing",
                        choices=list(REMAT_POLICIES),
                        help="UNet rematerialisation: 'nothing' recomputes "
                             "the whole UNet call in the backward (least "
                             "memory); 'dots' keeps the matrix products' "
                             "and convolutions' outputs (less recompute, "
                             "more activation memory)")
    parser.add_argument("--grads_bf16", action="store_true",
                        help="round gradients to bf16 before the update, "
                             "as the JAX package does; here they stay f32 "
                             "tensors, so it saves no memory")
    parser.add_argument("--report_to", type=str, default=None,
                        choices=["tensorboard", "wandb"],
                        help="log the losses and learning rate each update "
                             "(none by default)")
    parser.add_argument("--revision", type=str, default=None,
                        help="accepted and ignored")
    parser.add_argument("--output_dir", type=str, default="e4t-model")
    parser.add_argument("--logging_dir", type=str, default="logs",
                        help="the tracker's directory, under --output_dir")
    parser.add_argument("--mixed_precision", type=str, default="no",
                        choices=["no", "fp16", "bf16"],
                        help="compute dtype: 'no' is f32 (on the GPU "
                             "through the f32 attention kernels); fp16 and "
                             "bf16 both mean bf16")
    parser.add_argument("--use_8bit_adam", action="store_true",
                        help="AdamW with block-quantized int8 moments "
                             "(2.03 bytes a parameter for both, against 8)")
    parser.add_argument("--lr_scheduler", type=str, default="constant")
    parser.add_argument("--lr_warmup_steps", type=int, default=0)
    parser.add_argument("--local_rank", type=int, default=-1,
                        help="accepted and ignored")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; runs on the GPU unless 'cpu' "
                             "is given")
    parser.add_argument("--tensor_parallel", type=int, default=1,
                        help="split the trained UNet's attention and "
                             "feed-forward sites over this many ranks of a "
                             "torchrun launch (a (dp, tp) grid)")
    return parser.parse_args(argv)


def resolve_train_dtype(mixed_precision: str,
                        device: torch.device) -> torch.dtype:
    """The compute dtype: ``no`` is f32 (the reference's default, on the
    GPU through the f32 attention kernels), fp16 and bf16 both mean bf16
    (the JAX package maps fp16 to bf16). ``device`` changes nothing."""
    del device
    return torch.float32 if mixed_precision == "no" else torch.bfloat16


def tune(args: argparse.Namespace, modules: E4TModules,
         offsets: Dict[str, torch.Tensor], tokenizer, placeholder_token: str,
         templates: List[str], class_token_id: int, image: np.ndarray,
         schedule_config: NoiseScheduleConfig, dtype: torch.dtype,
         save: Optional[Callable[[int, Dict, Image.Image], None]] = None,
         mesh: Optional[pmesh.Mesh] = None) -> Dict:
    """Phase-2 tuning on one image (HWC uint8), from loaded modules (f32)
    and the offset bank: the function ``main`` calls after loading.
    ``save(global_step, trainable, domain_image)`` runs every
    ``checkpointing_steps`` updates. Returns {"trainable", "optimizer",
    "domain_image", "global_step", "metrics" (per call, floats),
    "step_seconds" (per call, synchronised wall time), "profile_dir" (where
    a trace was written, else None)}. ``mesh``: the (dp, tp) grid of a
    torchrun launch, the UNet split over tp beforehand. The tracker of
    ``--report_to`` (``utils/trackers``, on the main rank) logs each
    update's losses and learning rate under
    ``<output_dir>/<logging_dir>``."""
    device = modules.unet.conv_in.weight.device
    mesh = mesh or pmesh.Mesh()
    gas = args.gradient_accumulation_steps
    resolution = args.resolution or default_resolution(
        modules.unet.config, modules.vae.config)
    chw = make_transform(resolution, random_crop_flag=True,
                         seed=args.seed)(image)
    domain_image = Image.fromarray(
        ((chw.transpose(1, 2, 0) + 1.0) * 127.5).round().astype(np.uint8))
    pixel_values = torch.from_numpy(chw).to(device)[None].expand(
        args.train_batch_size, -1, -1, -1)

    cfg = E4TTrainConfig(
        domain_embed_scale=args.domain_embed_scale,
        reg_lambda=args.reg_lambda,
        train_unet=True,
        train_text_encoder=args.train_text_encoder,
        train_clip_vision=args.unfreeze_clip_vision,
        max_grad_norm=args.max_grad_norm,
        grads_bf16=args.grads_bf16,
        micro_batches=args.micro_batches,
        remat_policy=args.remat_policy,
    )
    trainable, _ = split_trainable(modules, offsets, cfg, dtype)
    params = [t for group in trainable.values() for t in group.values()]
    print(f"Number of Trainable Parameters: "
          f"{sum(p.numel() for p in params) * 1e-6:.2f} M")
    schedule = make_lr_schedule(args.lr_scheduler, scale_learning_rate(args),
                                args.lr_warmup_steps * gas,
                                args.max_train_steps * gas)
    optimizer = make_optimizer(params, schedule(0),
                               use_8bit=args.use_8bit_adam)
    tracker = make_tracker(args.report_to,
                           os.path.join(args.output_dir, args.logging_dir),
                           config=vars(args), is_main=mesh.is_main)
    step_fn = make_train_step(modules, DDPMScheduler(schedule_config), cfg,
                              trainable, optimizer, schedule,
                              accumulate_steps=gas, mesh=mesh)
    seed = args.seed + mesh.dp_rank  # each dp rank draws its own
    sampler = TemplateSampler(templates, tokenizer, placeholder_token,
                              tokenizer.convert_tokens_to_ids(
                                  placeholder_token), seed=seed)
    generator = torch.Generator(device).manual_seed(seed)
    # the replicated image is VAE-encoded once: one posterior draw
    latents = encode_latents(modules, pixel_values, generator)
    static = {
        "latents": latents, "pixel_values": pixel_values,
        "uncond_ids": torch.as_tensor(sampler.uncond_ids, device=device),
        "class_token_id": torch.tensor(class_token_id, device=device)}

    print("***** Running training *****")
    print(f"  Instantaneous batch size per device = {args.train_batch_size}")
    print(f"  Total train batch size (w. parallel, distributed & "
          f"accumulation) = {args.train_batch_size * mesh.dp * gas}")
    print(f"  Gradient Accumulation steps = {gas}")
    print(f"  Total optimization steps = {args.max_train_steps}")
    history, seconds, global_step = [], [], 0
    # the profile window: calls [2, 2 + profile_steps), after the warm-up
    profile_dir = args.profile_dir or os.path.join(args.output_dir,
                                                   "profile")
    window = contextlib.ExitStack()
    traced = None

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with window:
        for step in range(args.max_train_steps * gas):
            if args.profile_steps and step == 2:
                sync()
                window.enter_context(trace(profile_dir))
                traced = profile_dir
            elif args.profile_steps and step == 2 + args.profile_steps:
                sync()
                window.close()
                print(f"[profiler] trace written to {profile_dir}")
            input_ids, ph_idx = sampler.sample(args.train_batch_size)
            batch = dict(static,
                         input_ids=torch.as_tensor(input_ids, device=device),
                         placeholder_idx=torch.as_tensor(ph_idx,
                                                         device=device))
            t0 = time.perf_counter()
            metrics = step_fn(batch, generator)
            metrics = {k: float(v) for k, v in metrics.items()}
            sync()
            seconds.append(time.perf_counter() - t0)
            history.append(metrics)
            if (step + 1) % gas == 0:
                global_step += 1
                lr = schedule(global_step - 1)
                if mesh.is_main:
                    print(f"step {global_step}: " + ", ".join(
                        f"{k} {v:.6g}" for k, v in metrics.items())
                        + f", lr {lr:.3g}, {seconds[-1]:.3f} s")
                tracker.log({"loss": metrics["loss"],
                             "loss_diff": metrics["loss_diff"],
                             "loss_reg": metrics["loss_reg"], "lr": lr},
                            global_step)
                if (save is not None
                        and global_step % args.checkpointing_steps == 0):
                    save(global_step, trainable, domain_image)
        if traced and 2 + args.profile_steps > args.max_train_steps * gas:
            sync()  # the window reached past the loop's end
            window.close()
            print(f"[profiler] trace written to {profile_dir} (window "
                  f"clamped to the loop's end)")
    tracker.finish()
    return {"trainable": trainable, "optimizer": optimizer,
            "domain_image": domain_image, "global_step": global_step,
            "metrics": history, "step_seconds": seconds,
            "profile_dir": traced}


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    dtype = resolve_train_dtype(args.mixed_precision, torch.device(args.device))
    device = pmesh.maybe_initialize_distributed(resolve_device(args.device))
    mesh = pmesh.get_mesh(tp=args.tensor_parallel)
    if mesh.distributed:
        print(f"mesh: {mesh.describe()}")
    args.pretrained_model_name_or_path = resolve_model_dir(
        args.pretrained_model_name_or_path)
    pretrained_args = load_config(args.pretrained_model_name_or_path)
    base = artifacts.load_sd_base(
        pretrained_args.pretrained_model_name_or_path)
    if args.resolution is None:
        args.resolution = default_resolution(base["unet_config"],
                                             base["vae_config"])
    enc_cfg = artifacts.e4t_encoder_config_from_args(
        pretrained_args, word_embedding_dim=base["text_config"].hidden_size,
        unet_config=base["unet_config"])
    loaded = artifacts.load_e4t_weights(args.pretrained_model_name_or_path,
                                        base)
    modules = build_modules(base, enc_cfg, device=device)
    modules.text_encoder.resize_token_embeddings(
        loaded["text"][
            "text_model.embeddings.token_embedding.weight"].shape[0])
    modules.load_state_dicts({k: loaded[k]
                              for k in ("unet", "vae", "text", "e4t")})
    print(f"Loaded the pre-trained model from "
          f"{args.pretrained_model_name_or_path}")
    if pmesh.apply_tensor_parallel(modules.unet, mesh):
        print(f"tensor parallelism: UNet kernels sharded over "
              f"tp={mesh.tp}")
    tokenizer, _ = prepare_tokenizer(base, pretrained_args.placeholder_token,
                                     modules.text_encoder, seed=args.seed)
    class_token_id = resolve_class_token(tokenizer,
                                         pretrained_args.domain_class_token)
    templates = resolve_templates(args.prompt_template
                                  or pretrained_args.prompt_template)
    image = load_image_rgb(args.train_image_path)

    # tuning holds a frozen ViT tower in the compute dtype; it is saved as
    # loaded, in f32, as the reference saves its frozen parameters
    frozen_vit = {} if args.unfreeze_clip_vision else {
        k: v for k, v in loaded["e4t"].items() if k.startswith("clip_vision.")}

    def save_weights(step: int, trainable: Dict,
                     domain_image: Image.Image) -> None:
        # every rank takes part in gathering the split UNet; rank 0 writes
        unet_state = (pmesh.full_state_dict(modules.unet, mesh)
                      if mesh.tp > 1 else modules.unet.state_dict())
        if not mesh.is_main:
            mesh.barrier()
            return
        config = dict(vars(args))
        config["pretrained_args"] = pretrained_args.to_dict()
        out = artifacts.save_e4t_weights(
            args.output_dir, step, config,
            {**modules.e4t_encoder.state_dict(), **frozen_vit},
            unet_state, trainable["offsets"],
            text_state=(modules.text_encoder.state_dict()
                        if args.train_text_encoder else None),
            domain_image=domain_image)
        print(f"[*] Weights saved at {out}")
        mesh.barrier()

    t0 = time.perf_counter()
    result = tune(args, modules, loaded["offsets"], tokenizer,
                  pretrained_args.placeholder_token, templates,
                  class_token_id, image, base["schedule_config"], dtype,
                  save=save_weights, mesh=mesh)
    print(f"Training wall-clock: {time.perf_counter() - t0:.2f}s "
          f"({args.max_train_steps} steps)")
    save_weights(result["global_step"], result["trainable"],
                 result["domain_image"])


if __name__ == "__main__":
    main()
