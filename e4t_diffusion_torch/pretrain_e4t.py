"""E4T phase-1 pretraining CLI: ``python -m e4t_diffusion_torch.pretrain_e4t``.

Trains the E4T encoder head and the 96 weight-offset hypernetworks on a
domain dataset; the UNet, the VAE, the text encoder and (unless
``--unfreeze_clip_vision``) the encoder's ViT tower stay frozen. Flags are
the JAX CLI's (root ``pretrain_e4t.py``), with ``--device`` added; runs on
the GPU unless ``--device cpu`` is given. ``--mixed_precision`` ``no`` (the
default) computes in f32, ``fp16`` and ``bf16`` in bf16; the trainables and
AdamW stay f32 either way.

Each step reads a batch of images (``data/dataset.E4TDataLoader``: image
folders, ``--webdataset`` tar shards or an HF dataset), copies it to the
device ahead of the step (``data/prefetch.device_prefetch``), VAE-encodes
it inside the step and draws the noise, timesteps and the posterior from a
``torch.Generator`` seeded with ``--seed``. Every ``--checkpointing_steps``
updates it writes the reference's artifacts (``<step>/weight_offsets.pt``,
``encoder.pt``, ``config.json``) and a resumable train state
(``checkpoint-<step>/``; ``--resume_from_checkpoint latest`` continues from
the newest, the learning-rate schedule at its update count). At update 1
and every ``--log_steps`` it renders ``--n_save_sample`` inputs with each
``--save_sample_prompt`` through DDIM on the current weights (0 renders
nothing). SIGTERM saves the train state at the next update and exits.
``--use_8bit_adam`` keeps AdamW's moments in block-quantized int8
(``training/optim8bit.py``, one kernel launch an update on the card; the
checkpoints carry its codes and scales); ``--profile_steps N`` writes a
``torch.profiler`` trace of updates [10, 10+N) on the main rank into
``--profile_dir`` (by default ``<output_dir>/profile``).

Several cards: ``torchrun --nproc_per_node N -m
e4t_diffusion_torch.pretrain_e4t ...`` runs one process a card (NCCL).
``--train_batch_size`` is per rank: the global batch is it times dp (the
ranks left after ``--tensor_parallel``), each dp rank reading its own
images and drawing its own templates, noise and timesteps (seeded
``--seed`` plus its dp rank). ``--zero1`` shards AdamW's state over dp;
``--tensor_parallel T`` splits the frozen UNet's attention and
feed-forward sites over T ranks. A SIGTERM seen by any rank stops every
rank at the same update. Rank 0 alone writes weights, checkpoints (every
rank's generator state and the unsharded optimizer state), samples and
tracker logs.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from e4t_diffusion_torch.config import AttributeDict
from e4t_diffusion_torch.data.dataset import E4TDataLoader
from e4t_diffusion_torch.data.prefetch import device_prefetch, to_device
from e4t_diffusion_torch.diffusion.pipeline import (
    E4TModules, StableDiffusionE4TPipeline, resolve_device)
from e4t_diffusion_torch.diffusion.schedulers import (
    DDIMScheduler, DDPMScheduler, NoiseScheduleConfig)
from e4t_diffusion_torch.models import weight_offsets as wo
from e4t_diffusion_torch.parallel import mesh as pmesh
from e4t_diffusion_torch.templates import resolve_templates
from e4t_diffusion_torch.training.setup import (
    TemplateSampler, build_modules, default_resolution,
    init_e4t_encoder_params, make_lr_schedule, prepare_tokenizer,
    resolve_class_token, scale_learning_rate)
from e4t_diffusion_torch.training.train_step import (
    E4TTrainConfig, make_optimizer, make_train_step, split_trainable)
from e4t_diffusion_torch.tuning_e4t import resolve_train_dtype
from e4t_diffusion_torch.utils import artifacts, convert
from e4t_diffusion_torch.utils.image import image_grid, to_pil
from e4t_diffusion_torch.utils.profiling import StepTimer, trace
from e4t_diffusion_torch.utils.runtime import GracefulShutdown
from e4t_diffusion_torch.utils.trackers import NullTracker, make_tracker


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--pretrained_model_name_or_path", type=str,
                        default="runwayml/stable-diffusion-v1-5",
                        help="a local diffusers-format SD checkpoint "
                             "directory; an encoder.pt / weight_offsets.pt "
                             "in it is resumed from")
    parser.add_argument("--clip_model_name_or_path", type=str,
                        default="ViT-H-14::laion2b_s32b_b79k",
                        help="'arch::version'; the tower's weights come from "
                             "--clip_vision_weights, else a seeded init")
    parser.add_argument("--clip_vision_weights", type=str, default=None,
                        help="an open_clip visual tower state dict (.pt, "
                             ".bin or .safetensors; 'visual.' prefix "
                             "optional, 'proj' ignored)")
    parser.add_argument("--placeholder_token", type=str, default="*s")
    parser.add_argument("--domain_class_token", type=str, required=True)
    parser.add_argument("--domain_embed_scale", type=float, default=0.1)
    parser.add_argument("--reg_lambda", type=float, default=0.01)
    parser.add_argument("--prompt_template", type=str,
                        default="a photo of {placeholder_token}")
    parser.add_argument("--train_image_dataset", type=str, required=True)
    parser.add_argument("--unfreeze_clip_vision", action="store_true",
                        default=False)
    parser.add_argument("--webdataset", action="store_true", default=False)
    parser.add_argument("--iterable_dataset", action="store_true",
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
    parser.add_argument("--max_grad_norm", default=1.0, type=float,
                        help="accepted and ignored: pretraining does not "
                             "clip, as in the reference")
    parser.add_argument("--learning_rate", type=float, default=1.6e-5)
    parser.add_argument("--scale_lr", action="store_true", default=False)
    parser.add_argument("--train_batch_size", type=int, default=16)
    parser.add_argument("--num_train_epochs", type=int, default=1,
                        help="accepted and ignored; --max_train_steps ends "
                             "the run")
    parser.add_argument("--max_train_steps", type=int, default=30000)
    parser.add_argument("--dataloader_num_workers", type=int, default=0,
                        help="decode threads; 0 or 1: one background thread "
                             "(a deterministic sample order)")
    parser.add_argument("--checkpointing_steps", type=int, default=10000)
    parser.add_argument("--async_checkpointing", action="store_true",
                        help="write each train-state checkpoint on a "
                             "background thread from a host copy taken at "
                             "the update")
    parser.add_argument("--resume_from_checkpoint", type=str, default=None,
                        help="a checkpoint-<step> directory, or 'latest'")
    parser.add_argument("--log_steps", type=int, default=1000)
    parser.add_argument("--enable_xformers_memory_efficient_attention",
                        action="store_true",
                        help="accepted and ignored; flash attention is "
                             "always used")
    parser.add_argument("--save_sample_prompt", type=str,
                        default="a photo of *s,a photo of *s in the style "
                                "of monet")
    parser.add_argument("--n_save_sample", type=int, default=4,
                        help="inputs rendered per prompt at update 1 and "
                             "every --log_steps; 0 renders nothing")
    parser.add_argument("--save_guidance_scale", type=float, default=7.5)
    parser.add_argument("--save_inference_steps", type=int, default=50)
    parser.add_argument("--report_to", type=str, default="wandb",
                        choices=["tensorboard", "wandb"])
    parser.add_argument("--revision", type=str, default=None,
                        help="accepted and ignored")
    parser.add_argument("--output_dir", type=str, default="e4t-model")
    parser.add_argument("--logging_dir", type=str, default="logs")
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
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="write a torch.profiler trace of updates "
                             "[10, 10+N) on the main rank (0: none)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="trace output dir (default <output>/profile)")
    parser.add_argument("--vit_config", type=str, default=None,
                        choices=[None, "tiny"],
                        help="test geometry of the vision tower")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; runs on the GPU unless 'cpu' "
                             "is given")
    parser.add_argument("--zero1", action="store_true", default=False,
                        help="shard the optimizer state over the dp ranks "
                             "of a torchrun launch (ZeRO-1); checkpoints "
                             "keep the unsharded layout")
    parser.add_argument("--tensor_parallel", type=int, default=1,
                        help="split the frozen UNet's attention and "
                             "feed-forward sites over this many ranks of a "
                             "torchrun launch (a (dp, tp) grid)")
    return parser.parse_args(argv)


def _sample_grid(args, pipe: StableDiffusionE4TPipeline,
                 pixel_values: np.ndarray, seeds: np.random.Generator):
    """The in-loop samples: the first ``n_save_sample`` inputs of the batch,
    each under every prompt of ``save_sample_prompt`` (DDIM, a seed drawn
    from ``seeds``). Returns (input grid, sample grid, the samples as
    (rows * cols, 3, H, W) floats in [0, 1])."""
    inputs = to_pil(np.clip((pixel_values + 1.0) / 2.0, 0.0, 1.0))
    chosen = inputs[: args.n_save_sample]
    prompts = args.save_sample_prompt.split(",")
    samples = []
    for prompt in prompts:
        for img in chosen:
            samples.append(pipe(
                prompt, img, num_inference_steps=args.save_inference_steps,
                guidance_scale=args.save_guidance_scale,
                height=args.resolution, width=args.resolution,
                seed=int(seeds.integers(0, 2 ** 31)), output_type="np"))
    samples = np.concatenate(samples)
    return (image_grid(chosen, 1, len(chosen)),
            image_grid(to_pil(samples), len(prompts), len(chosen)), samples)


def pretrain(args: argparse.Namespace, modules: E4TModules,
             offsets: Dict[str, torch.Tensor], tokenizer,
             placeholder_id: int, class_token_id: int, templates: List[str],
             schedule_config: NoiseScheduleConfig, dtype: torch.dtype,
             loader: Iterable, tracker=None,
             mesh: Optional[pmesh.Mesh] = None) -> Dict:
    """Phase-1 pretraining from loaded modules (f32) and the offset bank:
    the function ``main`` calls after loading. ``loader`` yields
    ``{"pixel_values": (B, 3, S, S)}`` numpy batches. Writes artifacts,
    checkpoints and samples under ``args.output_dir`` as the module
    docstring says; resumes from ``args.resume_from_checkpoint``. Returns
    {"trainable", "optimizer", "global_step", "resumed_from",
    "metrics" (per update, floats, with "lr"), "step_seconds" (per call,
    synchronised), "wait_seconds" (per call, the host's wait for the
    batch), "sampled" (the updates that wrote a sample grid under
    ``samples/``), "last_samples" (the last grid's float images, or None:
    only the last is held, the grids are on disk), "saved" (artifact
    dirs), "profile_dir" (where a trace was written, else None)}. ``mesh``: the (dp, tp) grid of a torchrun launch (its UNet split
    over tp beforehand); ``loader`` then yields this dp rank's batches."""
    device = modules.unet.conv_in.weight.device
    tracker = tracker or NullTracker()
    mesh = mesh or pmesh.Mesh()
    is_main = mesh.is_main
    gas = args.gradient_accumulation_steps
    cfg = E4TTrainConfig(
        domain_embed_scale=args.domain_embed_scale,
        reg_lambda=args.reg_lambda, train_unet=False,
        train_text_encoder=False,
        train_clip_vision=args.unfreeze_clip_vision,
        max_grad_norm=None,  # pretraining does not clip (the reference's)
        micro_batches=args.micro_batches)
    # a frozen tower is held in the compute dtype; artifacts carry it as
    # given, in f32, as the reference saves its frozen parameters
    frozen_vit = {} if args.unfreeze_clip_vision else {
        k: v.detach().to("cpu", torch.float32, copy=True)
        for k, v in modules.e4t_encoder.state_dict().items()
        if k.startswith("clip_vision.")}
    trainable, _ = split_trainable(modules, offsets, cfg, dtype)
    params = [t for group in trainable.values() for t in group.values()]
    print(f"Number of Trainable Parameters: "
          f"{sum(p.numel() for p in params) * 1e-6:.2f} M")
    schedule = make_lr_schedule(args.lr_scheduler, scale_learning_rate(args),
                                args.lr_warmup_steps * gas,
                                args.max_train_steps * gas)
    optimizer = make_optimizer(
        params, schedule(0), use_8bit=args.use_8bit_adam,
        zero1_group=mesh.dp_group if args.zero1 and mesh.distributed
        else None)
    if args.zero1:
        print(f"ZeRO-1: optimizer state sharded over dp={mesh.dp}")
    step_fn = make_train_step(modules, DDPMScheduler(schedule_config), cfg,
                              trainable, optimizer, schedule,
                              accumulate_steps=gas, mesh=mesh)
    # each dp rank draws its own noise, timesteps and posteriors
    generator = torch.Generator(device).manual_seed(args.seed + mesh.dp_rank)

    global_step = 0
    resumed_from = artifacts.resolve_checkpoint(args.output_dir,
                                                args.resume_from_checkpoint)
    if args.resume_from_checkpoint and resumed_from is None:
        print(f"Checkpoint '{args.resume_from_checkpoint}' does not exist. "
              f"Starting a new training run.")
    if resumed_from is not None:
        restored = artifacts.restore_train_state(resumed_from, trainable,
                                                 optimizer, generator,
                                                 rank=mesh.rank)
        step_fn.resume(restored["updates"])
        global_step = restored["step"]
        print(f"Resuming from checkpoint {resumed_from} (step "
              f"{global_step}, {restored['updates']} updates)")

    sampler = TemplateSampler(templates, tokenizer, args.placeholder_token,
                              placeholder_id, seed=args.seed + mesh.dp_rank)
    static = {"uncond_ids": torch.as_tensor(sampler.uncond_ids,
                                            device=device),
              "class_token_id": torch.tensor(class_token_id, device=device)}

    def place(batch_np):
        input_ids, ph_idx = sampler.sample(args.train_batch_size)
        batch = dict(static,
                     pixel_values=to_device(batch_np["pixel_values"], device),
                     input_ids=to_device(input_ids, device),
                     placeholder_idx=to_device(ph_idx, device))
        return batch, batch_np["pixel_values"]

    sample_pipe = None
    sample_seeds = np.random.default_rng(args.seed)
    sampled: List[int] = []
    last_samples: Optional[np.ndarray] = None

    def sample(pixel_values: np.ndarray, step: int) -> None:
        # built once, on the training modules and the trainable offsets
        # (read in place: each run sees the current values); its own
        # generators, so no training draw is taken
        nonlocal sample_pipe, last_samples
        if sample_pipe is None:
            sample_pipe = StableDiffusionE4TPipeline(
                modules, trainable["offsets"], tokenizer,
                AttributeDict(vars(args)),
                scheduler=DDIMScheduler(schedule_config),
                already_added_placeholder_token=True)
        inputs, grid, images = _sample_grid(args, sample_pipe, pixel_values,
                                            sample_seeds)
        if not is_main:  # a tp rank of rank 0's group: its share is done
            return
        sampled.append(step)
        last_samples = images
        sample_dir = os.path.join(args.output_dir, "samples")
        os.makedirs(sample_dir, exist_ok=True)
        inputs.save(os.path.join(sample_dir, f"input-{step}.png"))
        grid.save(os.path.join(sample_dir, f"sample-{step}.png"))
        tracker.log_images({"train/inputs": inputs, "train/samples": grid},
                           step)

    saved: List[str] = []

    def save_weights(step: int) -> None:
        if not is_main:
            return
        e4t_state = {**modules.e4t_encoder.state_dict(), **frozen_vit}
        out = artifacts.save_e4t_weights(args.output_dir, step, vars(args),
                                         e4t_state, None,
                                         trainable["offsets"])
        saved.append(out)
        print(f"[*] Weights saved at {out}")

    def save_state(step: int, async_save: bool) -> None:
        # every rank takes part (generator states, ZeRO-1's shards)
        path = artifacts.save_train_state(
            args.output_dir, step, trainable, optimizer,
            step_fn.counts["updates"], generator, async_save=async_save,
            mesh=mesh)
        if is_main:
            print(f"Saved state to {path}" + (" (async)" if async_save
                                              else ""))

    print("***** Running training *****")
    print(f"  Instantaneous batch size per device = {args.train_batch_size}")
    print(f"  Total train batch size (w. parallel, distributed & "
          f"accumulation) = {args.train_batch_size * mesh.dp * gas}")
    print(f"  Gradient Accumulation steps = {gas}")
    print(f"  Total optimization steps = {args.max_train_steps}")
    timer = StepTimer(warmup_steps=2,
                      batch_size=args.train_batch_size * mesh.dp)
    history, seconds, waits = [], [], []
    shutdown = GracefulShutdown()
    batches = iter(device_prefetch(loader, place, depth=2, device=device))
    # the profile window: updates [10, 10 + profile_steps), main rank
    profile_dir = args.profile_dir or os.path.join(args.output_dir,
                                                   "profile")
    window = contextlib.ExitStack()
    traced = None
    try:
        while global_step < args.max_train_steps:
            t0 = time.perf_counter()
            batch, pixel_values = next(batches)
            t1 = time.perf_counter()
            metrics = {k: float(v) for k, v in
                       step_fn(batch, generator).items()}
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds.append(time.perf_counter() - t1)
            waits.append(t1 - t0)
            if step_fn.counts["calls"] % gas:
                continue
            global_step += 1
            if args.profile_steps and is_main:
                # the step is synchronised: the window holds whole updates
                if global_step == 10 and traced is None:
                    window.enter_context(trace(profile_dir))
                    traced = profile_dir
                elif traced and global_step == 10 + args.profile_steps:
                    window.close()
                    print(f"[profiler] trace written to {profile_dir}")
            timer.step()
            metrics["lr"] = optimizer.param_groups[0]["lr"]
            history.append(metrics)
            if is_main:
                print(f"step {global_step}: " + ", ".join(
                    f"{k} {v:.6g}" for k, v in metrics.items())
                    + f", {seconds[-1]:.3f} s")
            tracker.log({**{f"train/{k}": v for k, v in metrics.items()
                            if k != "grad_norm"}, **timer.metrics()},
                        global_step)
            if global_step % args.checkpointing_steps == 0:
                save_weights(global_step)
                save_state(global_step, args.async_checkpointing)
            # rank 0's tp group renders (its UNet shards take part)
            if mesh.dp_rank == 0 and args.n_save_sample > 0 and (
                    global_step == 1 or global_step % args.log_steps == 0):
                sample(pixel_values, global_step)
            # a signal to any rank stops every rank at this update
            if mesh.any_rank(shutdown.requested, device):
                why = (shutdown.describe() if shutdown.requested
                       else "a signal to another rank")
                print(f"Preemption ({why}): checkpointing at step "
                      f"{global_step}")
                # written now: it must land inside the grace window
                save_state(global_step, async_save=False)
                break
    except KeyboardInterrupt:
        print("Summoning checkpoint...")
    finally:
        window.close()  # a window past the loop's end closes with it
        shutdown.restore()
        batches.close()
    if timer.metrics():
        print(", ".join(f"{k}: {v:.4f}" for k, v in timer.metrics().items()))
    # the last update's artifact, unless its checkpointing step wrote it
    if not saved or saved[-1] != os.path.join(args.output_dir,
                                              str(global_step)):
        save_weights(global_step)
    artifacts.wait_for_checkpoints()
    mesh.barrier()
    tracker.finish()
    return {"trainable": trainable, "optimizer": optimizer,
            "global_step": global_step, "resumed_from": resumed_from,
            "metrics": history, "step_seconds": seconds,
            "wait_seconds": waits, "sampled": sampled,
            "last_samples": last_samples, "saved": saved,
            "profile_dir": traced}


def load_e4t_start(args: argparse.Namespace, modules: E4TModules,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """The encoder and the offset bank a run starts from, as the reference
    picks them: ``encoder.pt`` / ``weight_offsets.pt`` in the base
    directory when present (a resumed phase-1 artifact), else the encoder
    initialised from ``--seed`` (its tower from ``--clip_vision_weights``
    when given) and a bank drawn from ``--seed``. Loads the encoder into
    ``modules`` strictly and returns the bank."""
    base_dir = args.pretrained_model_name_or_path
    prior_enc = os.path.join(base_dir, "encoder.pt")
    prior_wo = os.path.join(base_dir, "weight_offsets.pt")
    enc = modules.e4t_encoder
    if os.path.exists(prior_enc):
        enc.load_state_dict(artifacts.encoder_state_from_artifact(prior_enc),
                            strict=True)
        print(f"Resuming encoder from {prior_enc}")
    else:
        init_e4t_encoder_params(modules, seed=args.seed)
        if args.clip_vision_weights:
            enc.clip_vision.load_state_dict(convert.vit_from_open_clip(
                convert.load_state_dict_file(args.clip_vision_weights)),
                strict=True)
            print(f"Loaded CLIP vision tower from {args.clip_vision_weights}")
    ucfg = modules.unet.config
    if os.path.exists(prior_wo):
        offsets = {k: v.to(device) for k, v in
                   convert.load_state_dict_file(prior_wo).items()}
        wo.check_bank(offsets, ucfg)
        print(f"Resuming offsets from {prior_wo}")
    else:
        offsets = wo.init_offset_bank(
            ucfg, torch.Generator(device).manual_seed(args.seed),
            device=device)
    return offsets


def make_loader(args: argparse.Namespace,
                mesh: Optional[pmesh.Mesh] = None):
    """(the run's ``E4TDataLoader``, the step it starts at): the loader's
    seed is ``--seed`` plus the step of the checkpoint a resumed run starts
    from, as in the JAX CLI; under ``mesh`` it reads this dp rank's share
    (the ranks of one tp group read the same images)."""
    mesh = mesh or pmesh.Mesh()
    resume = artifacts.resolve_checkpoint(args.output_dir,
                                          args.resume_from_checkpoint)
    start = int(os.path.basename(resume).split("-")[1]) if resume else 0
    loader = E4TDataLoader(
        args.train_image_dataset, batch_size=args.train_batch_size,
        resolution=args.resolution, random_crop=True, seed=args.seed + start,
        use_tar=args.webdataset, streaming=args.iterable_dataset,
        num_workers=args.dataloader_num_workers,
        process_index=mesh.dp_rank, process_count=mesh.dp)
    return loader, start


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    device = pmesh.maybe_initialize_distributed(resolve_device(args.device))
    mesh = pmesh.get_mesh(tp=args.tensor_parallel)
    if mesh.distributed:
        print(f"mesh: {mesh.describe()}")
    dtype = resolve_train_dtype(args.mixed_precision, device)
    base = artifacts.load_sd_base(args.pretrained_model_name_or_path)
    if args.resolution is None:
        args.resolution = default_resolution(base["unet_config"],
                                             base["vae_config"])
    enc_cfg = artifacts.e4t_encoder_config_from_args(
        AttributeDict(vars(args)),
        word_embedding_dim=base["text_config"].hidden_size,
        unet_config=base["unet_config"])
    modules = build_modules(base, enc_cfg, device=device)
    modules.load_state_dicts({k: base[k] for k in ("unet", "vae", "text")})
    offsets = load_e4t_start(args, modules, device)
    if pmesh.apply_tensor_parallel(modules.unet, mesh):
        print(f"tensor parallelism: UNet kernels sharded over "
              f"tp={mesh.tp}")
    tokenizer, placeholder_id = prepare_tokenizer(
        base, args.placeholder_token, modules.text_encoder, seed=args.seed)
    class_token_id = resolve_class_token(tokenizer, args.domain_class_token)
    templates = resolve_templates(args.prompt_template)
    if args.prompt_template in ("normal", "face", "art"):
        print(f"Using the default {len(templates)} templates!")

    loader, start = make_loader(args, mesh)
    if loader.num_samples:
        print(f"dataset size: {loader.num_samples}")
    tracker = make_tracker(args.report_to,
                           os.path.join(args.output_dir, args.logging_dir),
                           config=vars(args), is_main=mesh.is_main)
    t0 = time.perf_counter()
    result = pretrain(args, modules, offsets, tokenizer, placeholder_id,
                      class_token_id, templates, base["schedule_config"],
                      dtype, loader, tracker, mesh)
    wall = time.perf_counter() - t0
    done = result["global_step"] - start
    if done > 0 and mesh.is_main:
        print(f"Training wall-clock: {wall:.2f}s ({done} steps, "
              f"{done / wall:.3f} steps/s)")
    return result


if __name__ == "__main__":
    main()
