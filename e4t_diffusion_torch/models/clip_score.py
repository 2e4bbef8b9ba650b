"""Full open_clip ViT-H-14 (vision and text towers, both projections) for
CLIP-I / CLIP-T scoring.

Counterpart of ``e4t_diffusion_tpu/models/clip_score.py``:

- vision: the E4T encoder's ``VisionTransformer`` plus the final projection
  ``visual_proj`` (open_clip's ``visual.proj``, which the E4T path drops);
  its 257-token self-attention takes the short-sequence kernel under
  ``E4T_SHORTSEQ_MH_ATTN`` on the card, as the E4T encoder's does;
- text: open_clip's causal text transformer (einsum attention), pooled at
  the position of the largest token id (the end-of-text token), then
  ``text_projection``;
- CLIP-I = cosine(image features of a generated image, of the source
  image); CLIP-T = cosine(image features, text features of the prompt).

State-dict names: ``visual.*`` (open_clip's, without ``proj``),
``visual_proj``, and ``text.*`` (open_clip's top-level text keys under
``text.``). ``scorer_from_open_clip`` maps a whole open_clip checkpoint
onto them and is strict: a missing or extra key raises, except
``logit_scale`` and ``attn_mask``, which the scorer does not use.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from e4t_diffusion_torch.models.vit import Transformer, VisionTransformer, ViTConfig
from e4t_diffusion_torch.ops.resize import clip_preprocess

IGNORED_OPEN_CLIP_KEYS = ("logit_scale", "attn_mask")


@dataclasses.dataclass(frozen=True)
class OpenCLIPTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 1024      # ViT-H-14 text tower
    num_layers: int = 24
    num_heads: int = 16
    embed_dim: int = 1024  # shared projection space

    @property
    def mlp_dim(self) -> int:
        return self.width * 4

    @classmethod
    def tiny(cls) -> "OpenCLIPTextConfig":
        return cls(vocab_size=600, context_length=16, width=32, num_layers=2,
                   num_heads=4, embed_dim=24)


@dataclasses.dataclass(frozen=True)
class CLIPScoreConfig:
    vit: ViTConfig = dataclasses.field(default_factory=ViTConfig.vit_h_14)
    text: OpenCLIPTextConfig = dataclasses.field(
        default_factory=OpenCLIPTextConfig)
    embed_dim: int = 1024

    @classmethod
    def tiny(cls) -> "CLIPScoreConfig":
        return cls(vit=ViTConfig.tiny(), text=OpenCLIPTextConfig.tiny(),
                   embed_dim=24)


class OpenCLIPTextTower(nn.Module):
    """forward(input_ids (B, L)) -> (B, embed_dim), un-normalized."""

    def __init__(self, config: OpenCLIPTextConfig):
        super().__init__()
        cfg = self.config = config
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(cfg.context_length, cfg.width))
        self.transformer = Transformer(
            ViTConfig(width=cfg.width, num_layers=cfg.num_layers,
                      num_heads=cfg.num_heads, mlp_dim=cfg.mlp_dim),
            causal=True)
        self.ln_final = nn.LayerNorm(cfg.width, eps=1e-5)
        self.text_projection = nn.Parameter(
            cfg.width ** -0.5 * torch.randn(cfg.width, cfg.embed_dim))
        nn.init.normal_(self.token_embedding.weight, std=0.02)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(input_ids)
        x = x + self.positional_embedding[None, :x.shape[1]]
        for block in self.transformer.resblocks:
            x = block(x)
        x = self.ln_final(x)
        eot = input_ids.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection


class CLIPScorer(nn.Module):
    def __init__(self, config: CLIPScoreConfig):
        super().__init__()
        self.config = config
        self.visual = VisionTransformer(config.vit)
        self.text = OpenCLIPTextTower(config.text)
        self.visual_proj = nn.Parameter(
            config.vit.width ** -0.5
            * torch.randn(config.vit.width, config.embed_dim))

    def image_features(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels: NCHW in [-1, 1] at any resolution (resized here) ->
        L2-normalized features."""
        x = clip_preprocess(pixels.float(), self.config.vit.image_size)
        pooled, _ = self.visual(x)
        feats = pooled @ self.visual_proj
        return feats / feats.norm(dim=-1, keepdim=True)

    def text_features(self, input_ids: torch.Tensor) -> torch.Tensor:
        feats = self.text(input_ids)
        return feats / feats.norm(dim=-1, keepdim=True)

    def forward(self, pixels, input_ids):
        return self.image_features(pixels), self.text_features(input_ids)


def clip_i(image_feats_a: torch.Tensor,
           image_feats_b: torch.Tensor) -> torch.Tensor:
    """Mean pairwise cosine similarity (features pre-normalized)."""
    return (image_feats_a * image_feats_b).sum(dim=-1).mean()


def clip_t(image_feats: torch.Tensor, text_feats: torch.Tensor
           ) -> torch.Tensor:
    return (image_feats * text_feats).sum(dim=-1).mean()


def scorer_from_open_clip(sd: Dict[str, torch.Tensor],
                          config: CLIPScoreConfig) -> Dict[str, torch.Tensor]:
    """A whole open_clip checkpoint's state dict (``visual.*`` and the text
    tower at top level) -> the ``CLIPScorer`` state dict. Strict: raises a
    KeyError naming the missing and unexpected keys (``logit_scale`` and
    ``attn_mask`` are dropped)."""
    out = {}
    for k, v in sd.items():
        if k in IGNORED_OPEN_CLIP_KEYS:
            continue
        if k == "visual.proj":
            out["visual_proj"] = v
        elif k.startswith("visual."):
            out[k] = v
        else:
            out["text." + k] = v
    with torch.device("meta"):
        want = set(CLIPScorer(config).state_dict())
    missing, unexpected = sorted(want - set(out)), sorted(set(out) - want)
    if missing or unexpected:
        raise KeyError(f"open_clip checkpoint does not match the scorer: "
                       f"missing {missing}, unexpected {unexpected}")
    return out
