"""Stable-unCLIP image conditioning: the image encoder with its projection,
the learned normalizer of the embedding space, and the noise augmentation.

Counterpart of ``e4t_diffusion_tpu/models/unclip.py``, with the parameter
names of transformers' ``CLIPVisionModelWithProjection`` (``vision_model.*``,
``visual_projection.weight``) and diffusers' ``StableUnCLIPImageNormalizer``
(``mean`` and ``std``, each (1, D)), so the ``image_encoder/`` and
``image_normalizer/`` folders of a stable-diffusion-2-1-unclip directory
load strictly.

``noise_image_embeddings`` is diffusers' ``noise_image_embeddings`` of
``StableUnCLIPImg2ImgPipeline``: scale by the normalizer, DDPM-forward to
``noise_level`` with the noise the caller passes in, unscale, then append
``get_timestep_embedding(noise_level, D, flip_sin_to_cos=True, shift 0)``:
the (B, 2 D) ``class_labels`` the SD2-unCLIP UNet's projection class
embedding takes. It computes in f32.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from e4t_diffusion_torch.diffusion.schedulers import (
    NoiseScheduleConfig, alphas_cumprod)
from e4t_diffusion_torch.models.e4t_encoder_legacy import (
    CLIPVisionConfig, CLIPVisionTransformer)
from e4t_diffusion_torch.models.unet import get_timestep_embedding


@dataclasses.dataclass(frozen=True)
class CLIPVisionProjectionConfig:
    vision: CLIPVisionConfig = dataclasses.field(
        default_factory=CLIPVisionConfig.vit_h)
    projection_dim: int = 1024

    @classmethod
    def tiny(cls) -> "CLIPVisionProjectionConfig":
        return cls(vision=CLIPVisionConfig.tiny(), projection_dim=16)


class CLIPVisionModelWithProjection(nn.Module):
    """forward(CLIP-preprocessed NCHW pixels) -> image_embeds: the
    post-layernormed CLS token through a bias-free projection (1024-dim for
    ViT-H)."""

    def __init__(self, config: CLIPVisionProjectionConfig):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config.vision)
        self.visual_projection = nn.Linear(config.vision.hidden_size,
                                           config.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        pooled, _ = self.vision_model(pixel_values)
        return self.visual_projection(pooled)


class StableUnCLIPImageNormalizer(nn.Module):
    """The learned mean and std of the CLIP embedding space, each (1, D);
    the noise augmentation runs in the normalized space."""

    def __init__(self, embedding_dim: int = 1024):
        super().__init__()
        self.mean = nn.Parameter(torch.zeros(1, embedding_dim))
        self.std = nn.Parameter(torch.ones(1, embedding_dim))

    def scale(self, embeds: torch.Tensor) -> torch.Tensor:
        return (embeds - self.mean.float()) / self.std.float()

    def unscale(self, embeds: torch.Tensor) -> torch.Tensor:
        return embeds * self.std.float() + self.mean.float()


# stabilityai/stable-diffusion-2-1-unclip image_noising_scheduler config
UNCLIP_NOISE_AUG_SCHEDULE = NoiseScheduleConfig(
    num_train_timesteps=1000, beta_schedule="squaredcos_cap_v2",
    beta_start=0.0001, beta_end=0.02)


def noise_image_embeddings(
        image_embeds: torch.Tensor, noise_level: torch.Tensor,
        noise: torch.Tensor, normalizer: StableUnCLIPImageNormalizer,
        schedule: NoiseScheduleConfig = UNCLIP_NOISE_AUG_SCHEDULE
) -> torch.Tensor:
    """image_embeds (B, D), noise_level (B,) integer, noise (B, D) ->
    (B, 2 D) f32: the noised embedding, then the noise level's sinusoidal
    embedding."""
    x = normalizer.scale(image_embeds.float())
    acp = torch.as_tensor(alphas_cumprod(schedule), dtype=torch.float32,
                          device=x.device)
    a = acp[noise_level.long()][:, None]
    x = a ** 0.5 * x + (1.0 - a) ** 0.5 * noise.float()
    x = normalizer.unscale(x)
    level = get_timestep_embedding(noise_level, x.shape[-1],
                                   flip_sin_to_cos=True,
                                   downscale_freq_shift=0.0)
    return torch.cat([x, level], dim=-1)
