"""The E4T train step on PyTorch.

Counterpart of ``e4t_diffusion_tpu/training/train_step.py``. The loss is
the reference's, in both phases:

    mse(unet(noisy, t, cond_states), target) + reg_lambda * ||word||^2

where word = class_embed + domain_embed_scale * e4t(image, tap) is written
into the placeholder slot of the prompt embeddings, tap is the UNet's
down/mid features on the uncond pass, and target is epsilon or v.

Precision: the trainable groups are f32 tensors that require grad (flax's
f32 ``param_dtype``); each step casts them to the compute dtype inside the
differentiated region, so gradients arrive in f32 and AdamW keeps f32
weights and moments. The frozen modules are cast to the compute dtype once
(``split_trainable``). The weight-offset fold W * (1 + O) is computed in f32
inside the differentiated region, so phase 2 trains both factors.

Memory: each UNet call is rematerialised (``torch.utils.checkpoint``,
non-reentrant) under ``remat_policy``: "nothing", the counterpart of
``jax.checkpoint(..., nothing_saveable)``, recomputes the whole call in the
backward; "dots", the counterpart of ``dots_saveable``, keeps the outputs of
the matrix products and convolutions (``aten.mm``, ``addmm``, ``bmm``,
``baddbmm``, ``convolution``; selective checkpointing) and recomputes the
rest, the flash kernels' forward among it (the JAX package recomputes its
Pallas calls too). The step runs all-flash (``flash_threshold(0)``, as the
JAX step traces): flash keeps no score tensor for the backward. The
threshold in force is re-entered inside the rematerialised call, because
its recomputation runs during the backward, outside the step's context.

Optimizer: AdamW in f32, or with ``use_8bit`` the block-quantized 8-bit
AdamW of ``training/optim8bit.py`` (the kernel of ``csrc/adam8bit.cu`` on
the card), also as ZeRO-1's inner optimizer.

Several ranks (``parallel/mesh.py``): each rank runs the step on its own
batch (``train_batch_size`` is per rank); on update calls the gradients are
averaged over dp in f32 before the bf16 rounding, the clip and AdamW, and
the logged losses are averaged over dp. Under tensor parallelism the UNet's
split parameters hold this rank's shard, the gradient of a split site's
offsets is summed over tp (each rank folds its shard of the offset; a site
left whole is replicated) and the clip's global norm counts every shard
once. One path clips every grid, the one-process mesh's included.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from e4t_diffusion_torch.diffusion.pipeline import E4TModules
from e4t_diffusion_torch.diffusion.schedulers import DDPMScheduler
from e4t_diffusion_torch.models import weight_offsets as wo
from e4t_diffusion_torch.models.unet import pool_encoder_features
from e4t_diffusion_torch.models.vae import sample_latent
from e4t_diffusion_torch.ops.attention import (batch_shards,
                                               batch_shards_in_force,
                                               flash_threshold,
                                               flash_threshold_bytes)
from e4t_diffusion_torch.parallel.mesh import Mesh
from e4t_diffusion_torch.training.optim8bit import AdamW8bit

ParamGroups = Dict[str, Dict[str, torch.Tensor]]
TOKEN_TABLE = "text_model.embeddings.token_embedding.weight"
_CLIP_VISION = "clip_vision."
# batch entries with one row per sample, split across micro-batches
_PER_SAMPLE = ("latents", "pixel_values", "input_ids", "placeholder_idx",
               "noise", "timesteps", "posterior_noise")
REMAT_POLICIES = ("nothing", "dots")
# the ops whose outputs "dots" keeps: jax.checkpoint_policies.dots_saveable
# keeps dot_general and conv_general_dilated
_aten = torch.ops.aten
DOT_OPS = frozenset((_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                     _aten.baddbmm.default, _aten.convolution.default))


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, *args, policy: str = "nothing"):
    """``fn(*args)`` rematerialised in the backward under ``policy``
    (``REMAT_POLICIES``): "nothing" keeps only the inputs, "dots" also the
    outputs of the matrix products and convolutions."""
    if policy == "nothing":
        return checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_saveable))
    raise ValueError(f"remat_policy {policy!r}: one of {REMAT_POLICIES}")


@dataclasses.dataclass(frozen=True)
class E4TTrainConfig:
    domain_embed_scale: float = 0.1
    reg_lambda: float = 0.01
    train_unet: bool = False          # phase 2
    train_text_encoder: bool = False  # phase 2, optional
    train_clip_vision: bool = False   # --unfreeze_clip_vision
    max_grad_norm: Optional[float] = None  # 1.0 in phase 2
    # round gradients to bf16 before the update, the JAX step's numerics;
    # the JAX step casts to halve gradient memory, but here the gradients
    # stay f32 tensors (autograd gives f32 leaves f32 grads): no memory saved
    grads_bf16: bool = False
    # >1: split the step's batch into this many sequential chunks, one
    # backward each, gradients averaged (the activation peak is one chunk)
    micro_batches: int = 1
    # what the UNet calls keep for the backward (REMAT_POLICIES)
    remat_policy: str = "nothing"


def split_trainable(modules: E4TModules, offsets: Dict[str, torch.Tensor],
                    cfg: E4TTrainConfig, dtype: torch.dtype
                    ) -> Tuple[ParamGroups, ParamGroups]:
    """(trainable, frozen) parameter groups, {group: {name: tensor}}, by
    the reference's optimizer selection: the E4T encoder head and the
    offset bank always; the UNet and the text encoder when ``cfg`` says
    so; the encoder's ViT tower only with ``train_clip_vision``.

    Trainable tensors are f32 and require grad: the modules' own
    parameters, and f32 contiguous copies of the bank's tensors on the
    UNet's device (a bank loaded from an artifact arrives on the CPU; the
    8-bit AdamW kernel takes contiguous tensors). Frozen modules (and
    a frozen ViT tower) are cast to ``dtype``, the compute dtype, and
    require no grad."""
    for m in modules.all():
        m.requires_grad_(False)
    groups = {"unet": (modules.unet, cfg.train_unet),
              "text": (modules.text_encoder, cfg.train_text_encoder),
              "vae": (modules.vae, False)}
    device = modules.unet.conv_in.weight.device
    trainable: ParamGroups = {"offsets": {
        k: v.detach().to(device, torch.float32).clone(
            memory_format=torch.contiguous_format).requires_grad_(True)
        for k, v in offsets.items()}}
    frozen: ParamGroups = {}
    for name, (module, train) in groups.items():
        module.to(torch.float32 if train else dtype)
        (trainable if train else frozen)[name] = dict(
            module.named_parameters())
    e4t = modules.e4t_encoder
    e4t.to(torch.float32)
    if not cfg.train_clip_vision:
        e4t.clip_vision.to(dtype)
    head = dict(e4t.named_parameters())
    if not cfg.train_clip_vision:
        frozen["e4t_frozen"] = {k: head.pop(k) for k in list(head)
                                if k.startswith(_CLIP_VISION)}
    trainable["e4t"] = head
    for group in trainable.values():
        for t in group.values():
            t.requires_grad_(True)
    return trainable, frozen


def merge_params(trainable: ParamGroups, dtype: torch.dtype
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The trainable module groups cast to the compute dtype, per module,
    for ``torch.func.functional_call`` (frozen tensors are the modules'
    own). Differentiable: the gradients reach the f32 tensors."""
    return {name: {k: v.to(dtype) for k, v in group.items()}
            for name, group in trainable.items() if name != "offsets"}


def encode_latents(modules: E4TModules, pixel_values: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """VAE-encode, draw from the posterior and scale, as the train loops do,
    without gradients. The posterior's standard normal draw is ``noise``
    when given, else drawn from ``generator``."""
    vae = modules.vae
    with torch.no_grad():
        mean, logvar = vae.encode(pixel_values)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device, dtype=mean.dtype)
        return sample_latent(mean, logvar, noise) * vae.config.scaling_factor


def e4t_loss_fn(modules: E4TModules, ddpm: DDPMScheduler,
                cfg: E4TTrainConfig, trainable: ParamGroups,
                batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                reg_scale: float = 1.0
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The shared E4T loss -> (loss, {"loss", "loss_diff", "loss_reg"}).

    batch: ``pixel_values`` (B, 3, H, W) in [-1, 1], ``input_ids`` (B, L)
    templated prompts, ``placeholder_idx`` (B,), ``uncond_ids`` (1, L),
    ``class_token_id`` (); ``latents`` (B, 4, h, w) already VAE-encoded and
    scaled (tuning: ``encode_latents`` once a run), or absent or None
    (pretraining: ``pixel_values`` are encoded here, every step, the
    posterior drawn from ``posterior_noise`` when given, else from
    ``generator``); optionally ``noise`` (like latents) and ``timesteps``
    (B,), which are otherwise drawn from ``generator``, after the
    posterior. The compute dtype is the frozen VAE's. ``reg_scale``
    multiplies the regulariser, a sum over the batch's rows: a dp rank
    passes dp, so that the mean over the ranks is the sum over the global
    batch, as one card computes it."""
    dtype = modules.vae.quant_conv.weight.dtype
    latents = batch.get("latents")
    if latents is None:
        latents = encode_latents(modules, batch["pixel_values"], generator,
                                 batch.get("posterior_noise"))
    bsz, dev = latents.shape[0], latents.device
    noise = batch.get("noise")
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=dev,
                            dtype=latents.dtype)
    timesteps = batch.get("timesteps")
    if timesteps is None:
        timesteps = torch.randint(0, ddpm.config.num_train_timesteps,
                                  (bsz,), generator=generator, device=dev)
    noisy = ddpm.add_noise(latents, noise, timesteps)

    params = merge_params(trainable, dtype)
    text, unet = modules.text_encoder, modules.unet
    text_params = params.get("text", {})
    # raw token embeddings come from the uncast table, as embed_tokens
    # reads the f32 parameters in the JAX package
    table = (trainable["text"][TOKEN_TABLE] if "text" in trainable
             else text.text_model.embeddings.token_embedding.weight)
    # the "" states and the class embedding are not trained through
    with torch.no_grad():
        uncond_states, _ = functional_call(text, text_params,
                                           (batch["uncond_ids"],))
        uncond_states = uncond_states.expand(bsz, -1, -1)
        class_embed = F.embedding(batch["class_token_id"].reshape(1),
                                  table)[0]

    unet_params = params.get("unet", {})
    unet_params.update(wo.fold_offset_bank(
        unet, trainable["offsets"], weights=trainable.get("unet"),
        dtype=dtype))
    threshold = flash_threshold_bytes()
    shards = batch_shards_in_force()

    def unet_call(x, t, context, tap):
        with flash_threshold(threshold), batch_shards(shards):
            return functional_call(unet, unet_params, (x, t, context),
                                   {"return_encoder_outputs": tap})

    def unet_apply(x, t, context, tap):
        return remat(unet_call, x, t, context, tap, policy=cfg.remat_policy)

    tap = unet_apply(noisy, timesteps, uncond_states, True)
    domain_embed = functional_call(
        modules.e4t_encoder, params["e4t"],
        (batch["pixel_values"], pool_encoder_features(tap)))
    word = class_embed[None] + cfg.domain_embed_scale * domain_embed

    inputs_embeds = F.embedding(batch["input_ids"], table)
    rows = torch.arange(bsz, device=dev)
    inputs_embeds = inputs_embeds.index_put(
        (rows, batch["placeholder_idx"]), word.to(inputs_embeds.dtype))
    cond_states, _ = functional_call(text, text_params, (),
                                     {"inputs_embeds": inputs_embeds})

    pred = unet_apply(noisy, timesteps, cond_states, False)
    target = ddpm.target(latents, noise, timesteps)
    loss_diff = torch.mean((pred.float() - target.float()) ** 2)
    loss_reg = cfg.reg_lambda * reg_scale * torch.sum(word.float() ** 2)
    loss = loss_diff + loss_reg
    return loss, {"loss": loss.detach(), "loss_diff": loss_diff.detach(),
                  "loss_reg": loss_reg.detach()}


def make_optimizer(params: List[torch.Tensor], learning_rate: float,
                   weight_decay: float = 1e-2,
                   use_8bit: bool = False,
                   zero1_group=None) -> torch.optim.Optimizer:
    """AdamW at torch's defaults (the reference's optimizer) over every
    trainable; ``make_train_step`` clips the global gradient norm first
    when ``max_grad_norm`` is set. ``use_8bit``: the 8-bit AdamW
    (``optim8bit.AdamW8bit``, the same hyper-parameters; the train step
    sets its ``step_bf16`` from ``E4TTrainConfig.grads_bf16``).
    ``zero1_group`` (a dp
    process group): ZeRO-1, each rank keeping the optimizer state of its
    share of the tensors and broadcasting them after its update
    (``ZeroRedundancyOptimizer``);
    ``parallel/mesh.consolidated_state_dict`` gives the unsharded layout."""
    kwargs = dict(lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                  weight_decay=weight_decay)
    cls = torch.optim.AdamW
    if use_8bit:
        cls = AdamW8bit
    if zero1_group is not None:
        from torch.distributed.optim import ZeroRedundancyOptimizer

        return ZeroRedundancyOptimizer(params, cls,
                                       process_group=zero1_group, **kwargs)
    return cls(params, **kwargs)


def make_train_step(modules: E4TModules, ddpm: DDPMScheduler,
                    cfg: E4TTrainConfig, trainable: ParamGroups,
                    optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float],
                    accumulate_steps: int = 1,
                    mesh: Optional[Mesh] = None) -> Callable:
    """``step(batch, generator=None) -> metrics``: the loss and its
    gradients all-flash (``flash_threshold(0)``), over ``micro_batches``
    sequential chunks; every ``accumulate_steps``-th call, the gradient
    (the mean over those calls, as optax.MultiSteps applies it), optionally
    rounded to bf16, clipped to ``max_grad_norm`` and applied by
    ``optimizer`` at the learning rate ``schedule(update count)``.
    metrics: loss, loss_diff, loss_reg (0-dim tensors) and, on update
    calls, grad_norm (the norm before clipping).

    ``step.counts`` holds {"calls", "updates"}, both 0 for a new run;
    ``step.resume(updates)`` sets them for a run restored after
    ``updates`` optimizer updates, so the schedule goes on from there.

    ``mesh``: the (dp, tp) grid (``parallel/mesh.get_mesh``); the losses
    come back averaged over dp, the gradients are reduced as the module
    docstring says."""
    params = [t for group in trainable.values() for t in group.values()]
    counts = {"calls": 0, "updates": 0}
    mesh = mesh or Mesh()
    specs = getattr(modules.unet, "tp_specs", {})
    sharded = [t for name, t in trainable.get("unet", {}).items()
               if name in specs]
    # the offsets of the split sites: each tp rank folds its shard of them,
    # so its gradient is its shard's share; a site left whole is replicated
    split_sites = {name[:-len(".to_q.weight")] for name in specs
                   if name.endswith(".to_q.weight")}
    tp_partial = [t for key, t in trainable.get("offsets", {}).items()
                  if key.rsplit(".wo_", 1)[0] in split_sites]

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        mb = cfg.micro_batches
        bsz = batch["input_ids"].shape[0]
        if bsz % mb:
            raise ValueError(f"batch {bsz} does not split into {mb} "
                             f"micro-batches")
        metrics: Dict[str, torch.Tensor] = {}
        with flash_threshold(0), batch_shards(mesh.dp):
            for i in range(mb):
                chunk = {k: (v.chunk(mb)[i] if k in _PER_SAMPLE
                             and v is not None else v)
                         for k, v in batch.items()}
                loss, m = e4t_loss_fn(modules, ddpm, cfg, trainable, chunk,
                                      generator, reg_scale=mesh.dp)
                (loss / (mb * accumulate_steps)).backward()
                for k, v in m.items():
                    metrics[k] = metrics.get(k, 0.0) + v / mb
        metrics = mesh.dp_mean(metrics)
        counts["calls"] += 1
        if counts["calls"] % accumulate_steps:
            return metrics
        mesh.reduce_gradients(params, tp_partial)
        if cfg.grads_bf16:
            for p in params:
                p.grad.copy_(p.grad.to(torch.bfloat16))
        norm = mesh.global_grad_norm(params, sharded)
        if cfg.max_grad_norm is not None:
            coef = torch.clamp(cfg.max_grad_norm / (norm + 1e-6), max=1.0)
            torch._foreach_mul_([p.grad for p in params], coef)
        metrics["grad_norm"] = norm
        for group in optimizer.param_groups:
            group["lr"] = schedule(counts["updates"])
            if "step_bf16" in group:
                # the 8-bit step in the gradients' dtype, as JAX's takes it
                group["step_bf16"] = cfg.grads_bf16
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        counts["updates"] += 1
        return metrics

    def resume(updates: int) -> None:
        counts.update(calls=updates * accumulate_steps, updates=updates)

    step.counts = counts
    step.resume = resume
    return step
