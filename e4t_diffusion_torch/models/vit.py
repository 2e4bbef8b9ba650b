"""OpenCLIP vision transformer (ViT-H-14 tower).

Counterpart of ``e4t_diffusion_tpu/models/vit.py``, with open_clip's
``VisionTransformer`` parameter names (``conv1``, ``class_embedding``,
``transformer.resblocks.{i}.attn.in_proj_weight`` ...), so the vision half
of the reference's ``encoder.pt`` loads strictly. Output contract of
open_clip with ``output_tokens=True`` and ``proj=None``: ``(pooled,
tokens)``, pooled = ln_post(cls token), tokens = the un-normalized patch
tokens. GELU is exact (erf), as in open_clip, unless the config's
``gelu_approximate`` or ``E4T_VIT_GELU=tanh`` (read per call), the
reference's serving knob (``e4t_diffusion_tpu/models/vit.py:
_gelu_tanh_env``), asks for the tanh approximation: either one set gives
tanh, so the config field cannot turn the knob off, nor the knob the field
(the reference's ``cfg.gelu_approximate or _gelu_tanh_env()``). The
config's ``ablate_attn`` (the attention output is v: the projections stay,
the score and PV products go) and ``ablate_ln`` (no ``ln_1`` / ``ln_2``
in any block, nor their parameters) are the reference's timing ablations
(``time_vit.py``), never used in serving. The linear
sites, the packed ``in_proj`` and ``conv1`` are ``ops/quant`` drop-ins with
unchanged keys, so int8 serving (``--int8_aux``) quantizes them.
``Transformer(cfg, causal=True)`` is open_clip's causal text transformer
(the CLIP scorer's text tower); a causal site stays on einsum attention.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from e4t_diffusion_torch.ops import quant
from e4t_diffusion_torch.ops.attention import dot_product_attention

VIT_GELU_KNOB = "E4T_VIT_GELU"


def gelu_approximate(config_tanh: bool = False) -> str:
    """``F.gelu``'s ``approximate`` for the MLP: "tanh" when the config asks
    for it (``config_tanh``) or while ``E4T_VIT_GELU=tanh``, else "none"
    (exact erf)."""
    return ("tanh" if config_tanh
            or os.environ.get(VIT_GELU_KNOB, "") == "tanh" else "none")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    mlp_dim: int = 5120
    layer_norm_eps: float = 1e-5
    # tanh-approximate GELU (see the module docstring for the knob)
    gelu_approximate: bool = False
    # timing ablations (time_vit.py), never used in serving
    ablate_attn: bool = False
    ablate_ln: bool = False

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_tokens(self) -> int:
        return self.grid * self.grid + 1

    @classmethod
    def vit_h_14(cls) -> "ViTConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ViTConfig":
        return cls(image_size=28, patch_size=14, width=32, num_layers=2,
                   num_heads=4, mlp_dim=64)


class MultiheadSelfAttention(quant.InProjSite):
    """torch.nn.MultiheadAttention's parameter layout (packed in_proj, the
    int8 site ``<module>.in_proj``), computed through the port's attention
    dispatcher."""

    def __init__(self, width: int, heads: int, causal: bool = False,
                 ablate_attn: bool = False):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.ablate_attn = ablate_attn
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = quant.Linear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h = self.heads
        hd = d // h
        qkv = self.in_proj(x)
        if self.ablate_attn:  # projections kept, attention products skipped
            return self.out_proj(qkv.chunk(3, dim=-1)[2])
        q, k, v = (t.reshape(b, s, h, hd).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        o = dot_product_attention(q, k, v, scale=1.0 / math.sqrt(hd),
                                  causal=self.causal)
        return self.out_proj(o.transpose(1, 2).reshape(b, s, d))


class MLP(nn.Module):
    def __init__(self, width: int, mlp_dim: int, gelu_tanh: bool = False):
        super().__init__()
        self.c_fc = quant.Linear(width, mlp_dim)
        self.c_proj = quant.Linear(mlp_dim, width)
        self.gelu_tanh = gelu_tanh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(
            self.c_fc(x), approximate=gelu_approximate(self.gelu_tanh)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, causal: bool = False):
        super().__init__()
        norm = (nn.Identity if cfg.ablate_ln else
                lambda: nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps))
        self.ln_1 = norm()
        self.attn = MultiheadSelfAttention(cfg.width, cfg.num_heads, causal,
                                           cfg.ablate_attn)
        self.ln_2 = norm()
        self.mlp = MLP(cfg.width, cfg.mlp_dim, cfg.gelu_approximate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, cfg: ViTConfig, causal: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(cfg, causal)
                                       for _ in range(cfg.num_layers))


class VisionTransformer(nn.Module):
    """forward(preprocessed NCHW pixels) -> (pooled, tokens)."""

    def __init__(self, config: ViTConfig):
        super().__init__()
        cfg = self.config = config
        self.conv1 = quant.Conv2d(3, cfg.width, cfg.patch_size,
                                  stride=cfg.patch_size, bias=False)
        scale = cfg.width ** -0.5
        self.class_embedding = nn.Parameter(scale * torch.randn(cfg.width))
        self.positional_embedding = nn.Parameter(
            scale * torch.randn(cfg.num_tokens, cfg.width))
        self.ln_pre = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.transformer = Transformer(cfg)
        self.ln_post = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.conv1(x.to(self.conv1.weight.dtype))
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)                 # (B, grid², width)
        cls = self.class_embedding.expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding[None]
        x = self.ln_pre(x)
        for block in self.transformer.resblocks:
            x = block(x)
        return self.ln_post(x[:, 0]), x[:, 1:]
