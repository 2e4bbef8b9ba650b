"""CLIP text encoder (SD v1's openai ViT-L-14 text tower; SD v2's
OpenCLIP-H tower through ``CLIPTextConfig.sd2``).

Counterpart of ``e4t_diffusion_tpu/models/clip_text.py``, with Hugging Face
``CLIPTextModel`` parameter names (``text_model.embeddings...``,
``text_model.encoder.layers.{i}...``), so a diffusers ``text_encoder``
state dict and the reference's ``text_encoder.pt`` load strictly once the
non-parameter ``position_ids`` buffer is dropped. The forward accepts
pre-computed ``inputs_embeds`` so the E4T domain embedding can be written
into the placeholder slot (training differentiates through it, and
through the token table when the text encoder is trained), and the pooled
output is hidden_state[:, 0] (the reference fork's quirk), not the
eot-token pooling of stock CLIP. ``CLIPEncoder(causal=False)`` holds the
non-causal layers of the Hugging Face CLIP vision tower
(``models/e4t_encoder_legacy.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from e4t_diffusion_torch.ops.attention import einsum_attention


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"  # SD v1 / openai CLIP; SD v2 uses "gelu"

    @classmethod
    def sd2(cls) -> "CLIPTextConfig":
        """SD v2.x text encoder: the OpenCLIP ViT-H text tower in HF layout,
        cut to the penultimate layer (23 layers), GELU."""
        return cls(hidden_size=1024, num_layers=23, num_heads=16,
                   intermediate_size=4096, hidden_act="gelu")

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        return cls(vocab_size=1000, hidden_size=32, num_layers=2,
                   num_heads=4, intermediate_size=64,
                   max_position_embeddings=16)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, causal: bool = True):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.causal = causal
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h = self.num_heads
        hd = d // h

        def heads(t):
            return t.reshape(b, s, h, hd).transpose(1, 2)

        o = einsum_attention(heads(self.q_proj(x)), heads(self.k_proj(x)),
                             heads(self.v_proj(x)), scale=1.0 / math.sqrt(hd),
                             causal=self.causal)
        return self.out_proj(o.transpose(1, 2).reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return self.fc2(h)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, causal: bool = True):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg, causal)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, causal: bool = True):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, causal)
                                    for _ in range(cfg.num_layers))


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)
        nn.init.normal_(self.token_embedding.weight, std=0.02)
        nn.init.normal_(self.position_embedding.weight, std=0.02)


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """forward(input_ids=None, inputs_embeds=None) -> (last_hidden_state,
    pooled)."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if input_ids is None and inputs_embeds is None:
            raise ValueError("You have to specify input_ids or inputs_embeds")
        tm = self.text_model
        if inputs_embeds is None:
            inputs_embeds = tm.embeddings.token_embedding(input_ids)
        seq = inputs_embeds.shape[1]
        pos = tm.embeddings.position_embedding.weight[:seq]
        x = (inputs_embeds + pos[None]).to(pos.dtype)
        for layer in tm.encoder.layers:
            x = layer(x)
        x = tm.final_layer_norm(x)
        return x, x[:, 0]  # reference quirk: token-0 pooling

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Raw (pre-position) token embeddings."""
        return self.text_model.embeddings.token_embedding(input_ids)

    @torch.no_grad()
    def resize_token_embeddings(self, new_size: int,
                                generator: Optional[torch.Generator] = None
                                ) -> None:
        """Grow the vocab (placeholder-token registration). New rows are
        N(0, 0.02); the placeholder slot is overwritten by the predicted
        domain embedding before encoding, so their values never matter.
        The grown table keeps the old one's dtype and requires_grad."""
        emb = self.text_model.embeddings.token_embedding
        old, dim = emb.weight.shape
        if new_size <= old:
            return
        rows = 0.02 * torch.randn((new_size - old, dim), generator=generator,
                                  device=emb.weight.device)
        grown = nn.Embedding(new_size, dim, device=emb.weight.device,
                             dtype=emb.weight.dtype)
        grown.weight.copy_(torch.cat([emb.weight, rows.to(emb.weight.dtype)]))
        grown.weight.requires_grad_(emb.weight.requires_grad)
        self.text_model.embeddings.token_embedding = grown
