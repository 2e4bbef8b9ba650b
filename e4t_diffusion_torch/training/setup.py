"""Shared bootstrap of the training CLI: modules, tokenizer and placeholder
registration, template sampling, learning-rate schedules.

Counterpart of ``e4t_diffusion_tpu/training/setup.py``. The schedules are
plain functions of the update count, equal to the optax schedules the JAX
package builds (diffusers ``get_scheduler`` names).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from e4t_diffusion_torch.diffusion.pipeline import E4TModules
from e4t_diffusion_torch.models.clip_text import CLIPTextModel
from e4t_diffusion_torch.models.e4t_encoder import (E4TEncoder,
                                                    E4TEncoderConfig)
from e4t_diffusion_torch.utils.tokenizer import CLIPTokenizer

Schedule = Callable[[int], float]


def build_modules(base: Dict, e4t_cfg: E4TEncoderConfig,
                  device: Union[str, torch.device, None] = None
                  ) -> E4TModules:
    """The four networks at the SD base's configs, in f32 (the trainer
    keeps its trainables in f32 and casts the frozen modules to the
    compute dtype, ``train_step.split_trainable``)."""
    return E4TModules.create(base["unet_config"], base["vae_config"],
                             base["text_config"], e4t_cfg,
                             dtype=torch.float32, device=device)


def default_resolution(unet_config, vae_config) -> int:
    """The image side the UNet was trained at: its latent ``sample_size``
    times the VAE's downsampling (512 for SD v1, 768 for SD 2.1), the
    training CLIs' ``--resolution`` when none is given."""
    return unet_config.sample_size * 2 ** (
        len(vae_config.block_out_channels) - 1)


def init_e4t_encoder_params(modules: E4TModules, seed: int = 0) -> None:
    """Re-initialise the E4T encoder (head and ViT tower) in place from
    ``seed``, on its device: a fresh encoder is built there with the
    default generators seeded ``seed`` (their states restored after), and
    its tensors copied in. The same seed gives the same tensors on one
    device; the numbers differ from the JAX package's."""
    enc = modules.e4t_encoder
    device = enc.final_linear.weight.device
    devices = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        with torch.device(device):
            fresh = E4TEncoder(enc.config)
    with torch.no_grad():
        for p, q in zip(enc.parameters(), fresh.parameters()):
            p.copy_(q)


def prepare_tokenizer(base: Dict, placeholder_token: str,
                      text_encoder: CLIPTextModel, seed: int = 0,
                      require_new: bool = True
                      ) -> Tuple[CLIPTokenizer, int]:
    """Tokenizer + placeholder registration + embedding resize, in place
    on ``text_encoder``. The added rows are drawn from a
    ``torch.Generator`` seeded with ``seed`` (other numbers than the JAX
    package's; the placeholder slot is overwritten before encoding).
    Returns (tokenizer, placeholder id)."""
    tokenizer = CLIPTokenizer.from_pretrained(
        base["tokenizer_dir"],
        model_max_length=base["text_config"].max_position_embeddings)
    if tokenizer.add_tokens(placeholder_token) == 0 and require_new:
        raise ValueError(
            f"The tokenizer already contains the token {placeholder_token}. "
            f"Please pass a different `placeholder_token` that is not "
            f"already in the tokenizer.")
    device = text_encoder.text_model.embeddings.token_embedding.weight.device
    text_encoder.resize_token_embeddings(
        len(tokenizer), torch.Generator(device).manual_seed(seed))
    return tokenizer, tokenizer.convert_tokens_to_ids(placeholder_token)


def resolve_class_token(tokenizer, domain_class_token: str) -> int:
    ids = tokenizer(domain_class_token, add_special_tokens=False,
                    padding=None)["input_ids"][0]
    if len(ids) != 1:
        raise ValueError(f"domain_class_token {domain_class_token!r} must be "
                         f"a single token (got {len(ids)})")
    return ids[0]


class TemplateSampler:
    """Pre-tokenized template prompts; each step draws template indices
    from numpy's ``default_rng(seed)``, as the JAX package does."""

    def __init__(self, templates: Sequence[str], tokenizer,
                 placeholder_token: str, placeholder_id: int, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        input_ids: List[List[int]] = []
        placeholder_idx: List[int] = []
        for t in templates:
            prompt = t.format(placeholder_token=placeholder_token)
            ids = tokenizer(prompt, padding="max_length", truncation=True,
                            max_length=tokenizer.model_max_length
                            )["input_ids"][0]
            if placeholder_id not in ids:
                raise ValueError(f"the template {prompt!r} lost the "
                                 f"placeholder token to truncation")
            input_ids.append(ids)
            placeholder_idx.append(ids.index(placeholder_id))
        self.input_ids = np.asarray(input_ids, np.int64)
        self.placeholder_idx = np.asarray(placeholder_idx, np.int64)
        self.uncond_ids = np.asarray(
            tokenizer("", padding="max_length", truncation=True,
                      max_length=tokenizer.model_max_length)["input_ids"],
            np.int64)

    def sample(self, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        idx = self.rng.integers(0, len(self.input_ids), size=batch_size)
        return self.input_ids[idx], self.placeholder_idx[idx]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule (polynomial of power 1)."""
    return lambda count: (init - end) * (1.0 - min(max(count, 0), steps)
                                         / steps) + end


def _cosine(init: float, steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0."""
    return lambda count: init * 0.5 * (
        1.0 + math.cos(math.pi * min(count, steps) / steps))


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]
          ) -> Schedule:
    """optax.join_schedules: schedule i runs from boundary i - 1, counting
    from 0 there."""
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = s(count - boundary)
        return out
    return schedule


def make_lr_schedule(name: str, learning_rate: float, warmup_steps: int,
                     total_steps: int) -> Schedule:
    """The learning rate at update count n, for diffusers' scheduler names:
    constant, constant_with_warmup, linear, cosine, cosine_with_restarts
    (three cycles), polynomial (power 1)."""
    warmup = _linear(0.0, learning_rate, max(warmup_steps, 1))
    rest = max(total_steps - warmup_steps, 1)
    if name == "constant":
        return lambda count: learning_rate
    if name == "constant_with_warmup":
        body = lambda count: learning_rate  # noqa: E731
    elif name in ("linear", "polynomial"):
        body = _linear(learning_rate, 0.0, rest)
    elif name == "cosine":
        body = _cosine(learning_rate, rest)
    elif name == "cosine_with_restarts":
        cycle = max(rest // 3, 1)
        body = _join([_cosine(learning_rate, cycle)] * 3,
                     [cycle, 2 * cycle])
    else:
        raise ValueError(f"unknown lr_scheduler {name}")
    if warmup_steps > 0:
        return _join([warmup, body], [warmup_steps])
    return body


def scale_learning_rate(args) -> float:
    """--scale_lr semantics: lr x accumulation x batch x world, world = 1
    until data parallelism is ported."""
    lr = args.learning_rate
    if getattr(args, "scale_lr", False):
        world = 1
        lr = (args.learning_rate * args.gradient_accumulation_steps
              * args.train_batch_size * world)
        print(f"Setting learning rate to {lr:.2e} = "
              f"{args.gradient_accumulation_steps} (accumulate_grad_batches)"
              f" * {world} (num_devices) * {args.train_batch_size} "
              f"(batchsize) * {args.learning_rate:.2e} (base_lr)")
    return lr
