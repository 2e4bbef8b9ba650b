"""The Hugging Face CLIP vision tower, and E4TEncoderLegacy, the reference's
first-generation encoder built on it.

Counterpart of ``e4t_diffusion_tpu/models/e4t_encoder_legacy.py``, with
Hugging Face ``CLIPVisionModel`` parameter names
(``vision_model.embeddings.patch_embedding.weight``, ``pre_layrnorm`` (sic),
``encoder.layers.{i}...``, ``post_layernorm``), so a transformers state dict
loads strictly once its ``position_ids`` buffer is dropped. Its layers are
the CLIP text encoder's, non-causal, on einsum attention, as in the JAX
package: no kernel route reaches this tower.

``E4TEncoderLegacy`` takes every 2nd layer's hidden state (after the
embedding output), the CLS token of each through the backbone's own
``post_layernorm``, a shared linear, the mean over those layers, then
concatenates it with the LeakyReLU'd spatially pooled UNet features (one
per tensor given) and projects to the word-embedding dim. Kept for
checkpoint compatibility with early E4T runs; the CLIs use ``E4TEncoder``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from e4t_diffusion_torch.models.clip_text import CLIPEncoder, CLIPTextConfig
from e4t_diffusion_torch.ops.resize import clip_preprocess


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """HF CLIPVisionModel geometry (defaults: openai ViT-L/14)."""
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"  # openai towers; laion ViT-H uses "gelu"

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    @classmethod
    def vit_h(cls) -> "CLIPVisionConfig":
        """laion/CLIP-ViT-H-14 in HF layout (the Stable-unCLIP
        image_encoder backbone)."""
        return cls(hidden_size=1280, num_layers=32, num_heads=16,
                   intermediate_size=5120, hidden_act="gelu")

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(hidden_size=32, num_layers=4, num_heads=4,
                   intermediate_size=64, image_size=28, patch_size=14)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(
            0.02 * torch.randn(cfg.hidden_size))
        self.position_embedding = nn.Embedding(cfg.num_positions,
                                               cfg.hidden_size)
        nn.init.normal_(self.position_embedding.weight, std=0.02)


class CLIPVisionTransformer(nn.Module):
    """forward(NCHW pixels, CLIP-preprocessed) -> (pooled, hidden_states):
    pooled = post_layernorm(CLS of the last layer), hidden_states = the
    embedding output (after ``pre_layrnorm``) and every layer's output."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size,
                                         eps=cfg.layer_norm_eps)
        layer_cfg = CLIPTextConfig(
            hidden_size=cfg.hidden_size, num_layers=cfg.num_layers,
            num_heads=cfg.num_heads, intermediate_size=cfg.intermediate_size,
            layer_norm_eps=cfg.layer_norm_eps, hidden_act=cfg.hidden_act)
        self.encoder = CLIPEncoder(layer_cfg, causal=False)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size,
                                           eps=cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        emb = self.embeddings
        x = emb.patch_embedding(pixel_values.to(emb.patch_embedding.weight.dtype))
        x = x.flatten(2).transpose(1, 2)                 # (B, grid², D)
        cls = emb.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight[None]
        x = self.pre_layrnorm(x)
        hidden_states = [x]
        for layer in self.encoder.layers:
            x = layer(x)
            hidden_states.append(x)
        return self.post_layernorm(x[:, 0]), hidden_states


class CLIPVisionModel(nn.Module):
    """HF ``CLIPVisionModel``: the tower under ``vision_model``."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)

    def forward(self, pixel_values: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        return self.vision_model(pixel_values)


@dataclasses.dataclass(frozen=True)
class E4TEncoderLegacyConfig:
    word_embedding_dim: int = 768
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    vision: CLIPVisionConfig = dataclasses.field(
        default_factory=CLIPVisionConfig)

    @classmethod
    def tiny(cls) -> "E4TEncoderLegacyConfig":
        return cls(word_embedding_dim=32, block_out_channels=(32, 64),
                   vision=CLIPVisionConfig.tiny())


class E4TEncoderLegacy(nn.Module):
    """forward(pixels NCHW in [-1, 1], NCHW UNet features) -> (B,
    word_embedding_dim). Parameter names: ``clip_vision.vision_model.*``,
    ``linear``, ``final_linear`` (the reference's, without its CLIP
    normalization buffers ``mean`` / ``std``)."""

    def __init__(self, config: E4TEncoderLegacyConfig):
        super().__init__()
        self.config = config
        d = config.vision.hidden_size
        self.clip_vision = CLIPVisionModel(config.vision)
        self.linear = nn.Linear(d, d)
        self.final_linear = nn.Linear(d + sum(config.block_out_channels),
                                      config.word_embedding_dim)

    def forward(self, x: torch.Tensor,
                unet_down_block_samples: Sequence[torch.Tensor]
                ) -> torch.Tensor:
        vm = self.clip_vision.vision_model
        _, hidden_states = vm(clip_preprocess(x, self.config.vision.image_size))
        # every 2nd layer after the embedding output, CLS through the
        # backbone's own post_layernorm
        feats = [self.linear(vm.post_layernorm(h[:, 0]))
                 for h in hidden_states[1:][1::2]]
        clip_h = torch.stack(feats).mean(dim=0)
        pooled = [F.leaky_relu(clip_h)] + [
            F.leaky_relu(s.mean(dim=(2, 3))) for s in unet_down_block_samples]
        return self.final_linear(torch.cat(pooled, dim=1))
