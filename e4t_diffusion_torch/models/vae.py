"""AutoencoderKL (SD v1 VAE).

Counterpart of ``e4t_diffusion_tpu/models/vae.py``, with diffusers v0.14
parameter names (the mid-block attention's ``query``/``key``/``value``/
``proj_attn``), so a diffusers ``vae`` state dict loads strictly; the
loader renames the later ``to_q``/``to_k``/``to_v``/``to_out.0`` naming.
``encode`` gives the posterior's (mean, logvar) for training, ``decode``
the image for sampling; ``sample_latent`` draws from the posterior with
noise the caller passes in. The mid-block attention is single-head einsum
math. Every conv and linear site is an ``ops/quant`` drop-in with unchanged
keys, so int8 serving (``--int8_aux``) quantizes the decoder's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from e4t_diffusion_torch.models.norm import group_norm_act
from e4t_diffusion_torch.ops.quant import Conv2d, Linear


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    sample_size: int = 512
    scaling_factor: float = 0.18215

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out_channels=(16, 32), layers_per_block=1,
                   norm_num_groups=4, sample_size=32)


class VAEResnetBlock(nn.Module):
    """ResnetBlock2D without time embedding (eps 1e-6)."""

    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=1e-6)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=1e-6)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_ch, out_ch, 1)
                              if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(group_norm_act(x, self.norm1, "silu"))
        h = self.conv2(group_norm_act(h, self.norm2, "silu"))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttentionBlock(nn.Module):
    """Single-head self-attention over spatial positions."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.query = Linear(channels, channels)
        self.key = Linear(channels, channels)
        self.value = Linear(channels, channels)
        self.proj_attn = Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = group_norm_act(x, self.group_norm).flatten(2).transpose(1, 2)
        q, k, v = self.query(y), self.key(y), self.value(y)
        s = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(c)
        p = torch.softmax(s, dim=-1).to(y.dtype)
        y = self.proj_attn(torch.matmul(p, v))
        return y.transpose(1, 2).reshape(b, c, h, w) + x


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.attentions = nn.ModuleList([VAEAttentionBlock(channels, groups)])
        self.resnets = nn.ModuleList([
            VAEResnetBlock(channels, channels, groups),
            VAEResnetBlock(channels, channels, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class VAEDownsample(nn.Module):
    """Stride-2 conv; diffusers pads (0, 1) on the bottom/right first."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class VAEUpsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _DownBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, layers: int, groups: int,
                 add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            VAEResnetBlock(in_ch if i == 0 else out_ch, out_ch, groups)
            for i in range(layers))
        self.downsamplers = (nn.ModuleList([VAEDownsample(out_ch)])
                             if add_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class _UpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, layers: int, groups: int,
                 add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            VAEResnetBlock(in_ch if i == 0 else out_ch, out_ch, groups)
            for i in range(layers))
        self.upsamplers = (nn.ModuleList([VAEUpsample(out_ch)])
                           if add_upsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Encoder(nn.Module):
    """Image -> the posterior's 2 x latent_channels moments."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        blocks, out_ch = [], ch[0]
        for bi, c in enumerate(ch):
            in_ch, out_ch = out_ch, c
            blocks.append(_DownBlock(in_ch, out_ch, cfg.layers_per_block, g,
                                     add_downsample=bi != len(ch) - 1))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = VAEMidBlock(ch[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = Conv2d(ch[-1], 2 * cfg.latent_channels, 3,
                               padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(group_norm_act(x, self.conv_norm_out, "silu"))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = VAEMidBlock(rev[0], g)
        blocks, out_ch = [], rev[0]
        for bi, c in enumerate(rev):
            in_ch, out_ch = out_ch, c
            blocks.append(_UpBlock(in_ch, out_ch, cfg.layers_per_block + 1, g,
                                   add_upsample=bi != len(rev) - 1))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(group_norm_act(x, self.conv_norm_out, "silu"))


class AutoencoderKL(nn.Module):
    """encode(x NCHW RGB in [-1, 1]) -> (mean, logvar) of the latent
    posterior; decode(z NCHW latents) -> NCHW RGB in [-1, 1] (unclipped)."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = Conv2d(2 * config.latent_channels,
                                 2 * config.latent_channels, 1)
        self.post_quant_conv = Conv2d(config.latent_channels,
                                      config.latent_channels, 1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        moments = self.quant_conv(
            self.encoder(x.to(self.quant_conv.weight.dtype)))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        z = z.to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z))


def sample_latent(mean: torch.Tensor, logvar: torch.Tensor,
                  noise: torch.Tensor) -> torch.Tensor:
    """Reparameterised draw from the diagonal Gaussian posterior; ``noise``
    is a standard normal draw of ``mean``'s shape (from the caller's
    ``torch.Generator``)."""
    return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
