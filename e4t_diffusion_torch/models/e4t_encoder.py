"""E4T encoder: predicts the domain word embedding from (image, UNet feats).

Counterpart of ``e4t_diffusion_tpu/models/e4t_encoder.py``, with the
reference ``encoder.pt`` parameter names (``clip_vision.*``,
``unet_feature_embedder.{0,2}``, ``feature_linear``, ``first_linears.{i}``,
``final_linear``):

- ``encode_image``: CLIP preprocess, the ViT-H tower, then [pooled,
  tokens[:, 1::2]] -> 129 feature vectors (the reference slices the token
  axis of the last layer; kept deliberately);
- ``fuse``: each vector, concatenated with the embedded 10,880-dim UNet
  feature, goes through a shared linear and its own per-index linear, is
  mean-pooled, LeakyReLU'd and projected to the word-embedding dim: the
  text tower's width, 768 for SD v1's CLIP-L and 1024 for SD 2.x's
  OpenCLIP-H (``word_embedding_dim``; the UNet tap is 10,880 wide in both).

The 129 per-index linears are held stacked, (n, out, in), and applied as
one batched product; state-dict hooks keep the reference's
``first_linears.{i}.weight`` / ``.bias`` keys on save and load.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from e4t_diffusion_torch.models.vit import VisionTransformer, ViTConfig
from e4t_diffusion_torch.ops.resize import clip_preprocess


@dataclasses.dataclass(frozen=True)
class E4TEncoderConfig:
    word_embedding_dim: int = 768
    unet_feature_dim: int = 10880
    vit: ViTConfig = dataclasses.field(default_factory=ViTConfig.vit_h_14)

    @property
    def hidden(self) -> int:
        return self.vit.width

    @property
    def n_fused(self) -> int:
        """pooled + every-2nd patch token (129 for ViT-H-14)."""
        return (self.vit.grid * self.vit.grid) // 2 + 1

    @classmethod
    def tiny(cls, word_embedding_dim: int = 32,
             unet_feature_dim: int = 224) -> "E4TEncoderConfig":
        return cls(word_embedding_dim=word_embedding_dim,
                   unet_feature_dim=unet_feature_dim, vit=ViTConfig.tiny())


class E4TEncoder(nn.Module):
    def __init__(self, config: E4TEncoderConfig):
        super().__init__()
        cfg = self.config = config
        d, n = cfg.hidden, cfg.n_fused
        self.clip_vision = VisionTransformer(cfg.vit)
        self.unet_feature_embedder = nn.Sequential(
            nn.Linear(cfg.unet_feature_dim, d), nn.LeakyReLU(),
            nn.Linear(d, d))
        self.feature_linear = nn.Linear(2 * d, d)
        # the per-index linears, stacked; torch.nn.Linear's default init
        bound = d ** -0.5
        self.first_linears_weight = nn.Parameter(
            (torch.rand(n, d, d) * 2.0 - 1.0) * bound)
        self.first_linears_bias = nn.Parameter(
            (torch.rand(n, d) * 2.0 - 1.0) * bound)
        self.final_linear = nn.Linear(d, cfg.word_embedding_dim)
        self._register_state_dict_hook(_split_first_linears)
        self.register_load_state_dict_pre_hook(_stack_first_linears)

    def encode_image(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """NCHW pixels in [-1, 1] -> (B, n_fused, hidden):
        [pooled, tokens[:, 1::2]]. Constant across denoise steps."""
        x = clip_preprocess(pixel_values, self.config.vit.image_size)
        pooled, tokens = self.clip_vision(x)
        return torch.cat([pooled[:, None, :], tokens[:, 1::2, :]], dim=1)

    def fuse(self, clip_feats: torch.Tensor,
             unet_pooled_features: torch.Tensor) -> torch.Tensor:
        """(B, n, hidden) x (B, unet_feature_dim) -> (B, word_dim)."""
        dtype = self.feature_linear.weight.dtype
        u = self.unet_feature_embedder(unet_pooled_features.to(dtype))
        u_b = u[:, None, :].expand(*clip_feats.shape[:2], u.shape[-1])
        h = self.feature_linear(torch.cat([clip_feats.to(dtype), u_b], dim=-1))
        h = torch.einsum("bnd,nod->bno", h, self.first_linears_weight)
        h = h + self.first_linears_bias[None]
        h = F.leaky_relu(h.mean(dim=1), negative_slope=0.01)
        return self.final_linear(h)

    def forward(self, pixel_values: torch.Tensor,
                unet_pooled_features: torch.Tensor) -> torch.Tensor:
        return self.fuse(self.encode_image(pixel_values), unet_pooled_features)


def _split_first_linears(module, state_dict, prefix, local_metadata):
    w = state_dict.pop(prefix + "first_linears_weight")
    b = state_dict.pop(prefix + "first_linears_bias")
    for i in range(w.shape[0]):
        state_dict[f"{prefix}first_linears.{i}.weight"] = w[i]
        state_dict[f"{prefix}first_linears.{i}.bias"] = b[i]
    return state_dict


def _stack_first_linears(module, state_dict, prefix, local_metadata, strict,
                         missing_keys, unexpected_keys, error_msgs):
    n = module.config.n_fused
    keys = [f"{prefix}first_linears.{i}.{leaf}" for i in range(n)
            for leaf in ("weight", "bias")]
    if not all(k in state_dict for k in keys):
        return  # leave the stacked keys missing: strict loading reports it
    state_dict[prefix + "first_linears_weight"] = torch.stack(
        [state_dict.pop(f"{prefix}first_linears.{i}.weight") for i in range(n)])
    state_dict[prefix + "first_linears_bias"] = torch.stack(
        [state_dict.pop(f"{prefix}first_linears.{i}.bias") for i in range(n)])
