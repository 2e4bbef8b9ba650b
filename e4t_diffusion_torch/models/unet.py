"""Stable Diffusion UNet (UNet2DConditionModel) with the E4T feature tap.

Counterpart of ``e4t_diffusion_tpu/models/unet.py``, with diffusers'
parameter names, so a diffusers ``unet`` state dict (and the UNet half of
the reference's ``unet.pt``) loads strictly. NCHW throughout. The SD v2
family is covered too: per-block head counts (``attention_head_dim`` a
tuple, read through ``heads_for_block``), ``use_linear_projection``
(``proj_in`` / ``proj_out`` are linear layers over the flattened tokens)
and ``class_embed_type="projection"`` (Stable-unCLIP: an MLP over
``class_labels`` added to the time embedding).

``return_encoder_outputs``: ``True`` exits after the mid block and returns
the E4T tap (conv_in output, every down-block residual and downsampler
output, the mid output); ``"with_eps"`` runs the full forward and returns
``(eps, tap)``. ``pool_encoder_features`` mean-pools the tap to the
10,880-dim feature of SD v1 and of the SD v2 family alike (the same
``block_out_channels``). The E4T weight offsets are folded into the
attention projections from outside (``models/weight_offsets.py``).

Every linear and conv site is a ``quant.Linear`` / ``quant.Conv2d``
(``nn.Linear`` / ``nn.Conv2d`` with the same parameters): it runs int8 while
``quant.int8_sites`` holds its quantized weights, and records its
activation range under ``quant.calibration``; otherwise it is the plain
layer.

``E4T_FUSED_QKV`` (read per call, the reference's parse: anything but
unset, "", "0" or "false" is on) computes q/k/v as one product against the
concatenated ``to_q`` / ``to_k`` / ``to_v`` weights (k/v only for
cross-attention). The parameters stay separate, so a checkpoint loads
either way. As in the reference, the fused product is a plain matmul: the
three projections are not int8 sites while it is on.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from e4t_diffusion_torch.models.norm import group_norm_act
from e4t_diffusion_torch.ops import quant
from e4t_diffusion_torch.ops.attention import dot_product_attention
from e4t_diffusion_torch.parallel import mesh as pmesh

FUSED_QKV_KNOB = "E4T_FUSED_QKV"


def fused_qkv_enabled() -> bool:
    """True while ``E4T_FUSED_QKV`` is on by the reference's parse."""
    return os.environ.get(FUSED_QKV_KNOB, "0") not in ("0", "false", "")


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD UNet hyperparameters (defaults = SD v1-4/v1-5)."""
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    center_input_sample: bool = False
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    mid_block_type: str = "UNetMidBlock2DCrossAttn"
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # number of heads (diffusers v0.14 naming quirk): an int for every
    # block (SD v1), or one per block (SD v2: (5, 10, 20, 20), 64-dim heads)
    attention_head_dim: Union[int, Tuple[int, ...]] = 8
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    # SD v2 family: linear proj_in / proj_out, and the Stable-unCLIP
    # projection class embedding over a
    # projection_class_embeddings_input_dim-wide class_labels
    use_linear_projection: bool = False
    class_embed_type: Optional[str] = None
    projection_class_embeddings_input_dim: Optional[int] = None

    def heads_for_block(self, block_index: int) -> int:
        if isinstance(self.attention_head_dim, int):
            return self.attention_head_dim
        return self.attention_head_dim[block_index]

    @classmethod
    def sd2(cls, sample_size: int = 96) -> "UNetConfig":
        """Stable Diffusion v2.x (768px family): 64-dim heads, linear
        transformer projections, 1024-wide OpenCLIP-H text context."""
        return cls(sample_size=sample_size, attention_head_dim=(5, 10, 20, 20),
                   cross_attention_dim=1024, use_linear_projection=True)

    @classmethod
    def sd2_unclip(cls) -> "UNetConfig":
        """stabilityai/stable-diffusion-2-1-unclip: SD v2 plus the
        projection class embedding over the noise-augmented image embedding
        concatenated with its noise-level embedding (1024 + 1024)."""
        return dataclasses.replace(
            cls.sd2(sample_size=96), class_embed_type="projection",
            projection_class_embeddings_input_dim=2048)

    @classmethod
    def tiny(cls, cross_attention_dim: int = 32) -> "UNetConfig":
        return cls(
            sample_size=8,
            block_out_channels=(32, 64),
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            layers_per_block=1,
            attention_head_dim=4,
            cross_attention_dim=cross_attention_dim,
            norm_num_groups=8,
        )


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = True,
                           downscale_freq_shift: float = 0.0,
                           max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embeddings (diffusers' formulation), in f32."""
    half = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = quant.Linear(in_dim, dim)
        self.linear_2 = quant.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: int, groups: int,
                 eps: float):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = quant.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = quant.Linear(temb_ch, out_ch)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = quant.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (quant.Conv2d(in_ch, out_ch, 1)
                              if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(group_norm_act(x, self.norm1, "silu"))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(group_norm_act(h, self.norm2, "silu"))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Multi-head attention with bias-free q/k/v projections. Split over tp
    (``parallel/mesh.apply_tensor_parallel``: ``tp`` set, ``heads`` the
    local count) it computes its local heads and sums ``to_out`` over tp."""

    def __init__(self, query_dim: int, context_dim: int, heads: int,
                 dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.tp: Optional[pmesh.TPGroup] = None
        self.to_q = quant.Linear(query_dim, inner, bias=False)
        self.to_k = quant.Linear(context_dim, inner, bias=False)
        self.to_v = quant.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([quant.Linear(inner, query_dim)])

    def _qkv(self, x: torch.Tensor, context: Optional[torch.Tensor]):
        if not fused_qkv_enabled():
            ctx = x if context is None else context
            return self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        wq, wk, wv = self.to_q.weight, self.to_k.weight, self.to_v.weight
        if context is None:
            return F.linear(x, torch.cat([wq, wk, wv])).chunk(3, dim=-1)
        k, v = F.linear(context, torch.cat([wk, wv])).chunk(2, dim=-1)
        return F.linear(x, wq), k, v

    def forward(self, x: torch.Tensor, context: torch.Tensor = None
                ) -> torch.Tensor:
        b, sq, _ = x.shape
        sk = sq if context is None else context.shape[1]
        h, hd = self.heads, self.dim_head
        tp = self.tp
        if tp is not None:
            x = pmesh.copy_to_tp(x, tp)
            if context is not None:
                context = pmesh.copy_to_tp(context, tp)
        q, k, v = self._qkv(x, context)
        q = q.reshape(b, sq, h, hd).transpose(1, 2)
        k = k.reshape(b, sk, h, hd).transpose(1, 2)
        v = v.reshape(b, sk, h, hd).transpose(1, 2)
        o = dot_product_attention(q, k, v, scale=1.0 / math.sqrt(hd),
                                  head_shards=1 if tp is None else tp.size)
        o = o.transpose(1, 2).reshape(b, sq, h * hd)
        if tp is None:
            return self.to_out[0](o)
        return pmesh.row_parallel(self.to_out[0], o, tp)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = quant.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hidden, gate = self.proj(x).chunk(2, dim=-1)
        return hidden * F.gelu(gate)


class FeedForward(nn.Module):
    """diffusers FeedForward with GEGLU: net = [GEGLU, Dropout, Linear].
    Split over tp (``tp`` set), the GEGLU projection holds this rank's rows
    of the hidden half and of the gate half, and ``net.2`` is summed over
    tp."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                  quant.Linear(dim * mult, dim)])
        self.tp: Optional[pmesh.TPGroup] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.net[2](self.net[0](x))
        h = self.net[0](pmesh.copy_to_tp(x, self.tp))
        return pmesh.row_parallel(self.net[2], h, self.tp)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, context_dim, heads, dim_head)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class Transformer2DModel(nn.Module):
    """Spatial transformer: GN -> proj_in -> block -> proj_out, plus the
    residual. The projections are 1x1 convs, or (``linear``, SD v2's
    use_linear_projection) linear layers applied after the flatten."""

    def __init__(self, channels: int, context_dim: int, heads: int,
                 groups: int, linear: bool = False):
        super().__init__()
        self.linear = linear
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        proj = ((lambda: quant.Linear(channels, channels)) if linear
                else (lambda: quant.Conv2d(channels, channels, 1)))
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            channels, context_dim, heads, channels // heads)])
        self.proj_out = proj()

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = group_norm_act(x, self.norm)
        if self.linear:                                  # (B, HW, C)
            y = self.proj_in(y.flatten(2).transpose(1, 2))
        else:
            y = self.proj_in(y).flatten(2).transpose(1, 2)
        for block in self.transformer_blocks:
            y = block(y, context)
        if self.linear:
            y = self.proj_out(y).transpose(1, 2).reshape(b, c, h, w)
        else:
            y = self.proj_out(y.transpose(1, 2).reshape(b, c, h, w))
        return y + x


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = quant.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = quant.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class DownBlock2D(nn.Module):
    """Resnets (+ spatial transformers when ``cross_attn``), then an
    optional downsampler. Returns (x, residuals)."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: int, num_layers: int,
                 cross_attn: bool, add_downsample: bool, heads: int,
                 context_dim: int, groups: int, eps: float,
                 linear: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, temb_ch,
                          groups, eps) for i in range(num_layers))
        self.attentions = (nn.ModuleList(
            Transformer2DModel(out_ch, context_dim, heads, groups, linear)
            for _ in range(num_layers)) if cross_attn else None)
        self.downsamplers = (nn.ModuleList([Downsample2D(out_ch)])
                             if add_downsample else None)

    def forward(self, x, temb, context):
        res = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            res.append(x)
        return x, res


class UpBlock2D(nn.Module):
    """Resnets over (x ++ skip) (+ spatial transformers when
    ``cross_attn``), then an optional upsampler."""

    def __init__(self, in_ch: int, prev_ch: int, out_ch: int, temb_ch: int,
                 num_layers: int, cross_attn: bool, add_upsample: bool,
                 heads: int, context_dim: int, groups: int, eps: float,
                 linear: bool = False):
        super().__init__()
        resnets = []
        for i in range(num_layers):
            skip_ch = in_ch if i == num_layers - 1 else out_ch
            res_in = prev_ch if i == 0 else out_ch
            resnets.append(ResnetBlock2D(res_in + skip_ch, out_ch, temb_ch,
                                         groups, eps))
        self.resnets = nn.ModuleList(resnets)
        self.attentions = (nn.ModuleList(
            Transformer2DModel(out_ch, context_dim, heads, groups, linear)
            for _ in range(num_layers)) if cross_attn else None)
        self.upsamplers = (nn.ModuleList([Upsample2D(out_ch)])
                           if add_upsample else None)

    def forward(self, x, res_samples: List[torch.Tensor], temb, context):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, res_samples.pop()], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNetMidBlock2DCrossAttn(nn.Module):
    def __init__(self, ch: int, temb_ch: int, heads: int, context_dim: int,
                 groups: int, eps: float, linear: bool = False):
        super().__init__()
        self.attentions = nn.ModuleList([
            Transformer2DModel(ch, context_dim, heads, groups, linear)])
        self.resnets = nn.ModuleList([
            ResnetBlock2D(ch, ch, temb_ch, groups, eps),
            ResnetBlock2D(ch, ch, temb_ch, groups, eps)])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


class UNet2DConditionModel(nn.Module):
    """forward(sample NCHW, timesteps, encoder_hidden_states,
    return_encoder_outputs=False, class_labels=None) -> eps (NCHW); the E4T
    tap list with ``True``; ``(eps, tap)`` with ``"with_eps"``.
    ``class_labels`` (B, projection_class_embeddings_input_dim) is required
    with ``class_embed_type="projection"``."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        for btype in (*cfg.down_block_types, *cfg.up_block_types):
            if btype not in ("CrossAttnDownBlock2D", "DownBlock2D",
                             "CrossAttnUpBlock2D", "UpBlock2D"):
                raise ValueError(f"Unsupported block {btype}")
        if cfg.mid_block_type != "UNetMidBlock2DCrossAttn":
            raise ValueError(f"Unsupported mid block {cfg.mid_block_type}")
        if cfg.class_embed_type not in (None, "projection"):
            raise ValueError(f"Unsupported class_embed_type "
                             f"{cfg.class_embed_type}")
        ch = cfg.block_out_channels
        temb_ch = ch[0] * 4
        cad = cfg.cross_attention_dim
        groups, eps = cfg.norm_num_groups, cfg.norm_eps
        linear = cfg.use_linear_projection
        self.conv_in = quant.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb_ch)
        self.class_embedding = (
            TimestepEmbedding(cfg.projection_class_embeddings_input_dim,
                              temb_ch)
            if cfg.class_embed_type == "projection" else None)

        down = []
        out_ch = ch[0]
        for bi, btype in enumerate(cfg.down_block_types):
            in_ch, out_ch = out_ch, ch[bi]
            down.append(DownBlock2D(
                in_ch, out_ch, temb_ch, cfg.layers_per_block,
                cross_attn=btype == "CrossAttnDownBlock2D",
                add_downsample=bi != len(ch) - 1,
                heads=cfg.heads_for_block(bi), context_dim=cad,
                groups=groups, eps=eps, linear=linear))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = UNetMidBlock2DCrossAttn(
            ch[-1], temb_ch, cfg.heads_for_block(len(ch) - 1), cad, groups,
            eps, linear)
        up = []
        rev = list(reversed(ch))
        prev_ch = ch[-1]
        for bi, btype in enumerate(cfg.up_block_types):
            out_ch = rev[bi]
            in_ch = rev[min(bi + 1, len(ch) - 1)]
            up.append(UpBlock2D(
                in_ch, prev_ch, out_ch, temb_ch, cfg.layers_per_block + 1,
                cross_attn=btype == "CrossAttnUpBlock2D",
                add_upsample=bi != len(ch) - 1,
                heads=cfg.heads_for_block(len(ch) - 1 - bi), context_dim=cad,
                groups=groups, eps=eps, linear=linear))
            prev_ch = out_ch
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(groups, ch[0], eps=eps)
        self.conv_out = quant.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                return_encoder_outputs: Union[bool, str] = False,
                class_labels: Optional[torch.Tensor] = None):
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        x = sample.to(dtype)
        context = encoder_hidden_states.to(dtype)
        if cfg.center_input_sample:
            x = 2.0 * x - 1.0
        t_emb = get_timestep_embedding(timesteps, cfg.block_out_channels[0],
                                       cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(t_emb.to(dtype))
        if self.class_embedding is not None:
            if class_labels is None:
                raise ValueError("class_labels required when "
                                 "class_embed_type='projection'")
            temb = temb + self.class_embedding(class_labels.to(dtype))

        x = self.conv_in(x)
        down_res = [x]
        for block in self.down_blocks:
            x, res = block(x, temb, context)
            down_res.extend(res)
        x = self.mid_block(x, temb, context)

        if return_encoder_outputs is True:
            return down_res + [x]
        tap = (down_res + [x] if return_encoder_outputs == "with_eps"
               else None)
        n_layers = cfg.layers_per_block + 1
        for block in self.up_blocks:
            res = down_res[-n_layers:]
            down_res = down_res[:-n_layers]
            x = block(x, res, temb, context)
        x = self.conv_out(group_norm_act(x, self.conv_norm_out, "silu"))
        return (x, tap) if tap is not None else x


def tap_feature_dim(config: UNetConfig) -> int:
    """Channel count of the pooled E4T tap: conv_in + every down-block
    residual (+downsampler) + mid output. 10,880 for SD v1 and SD 2.x,
    whose ``block_out_channels`` are the same."""
    total = config.block_out_channels[0]
    for bi, _ in enumerate(config.down_block_types):
        ch = config.block_out_channels[bi]
        total += config.layers_per_block * ch
        if bi != len(config.down_block_types) - 1:
            total += ch
    return total + config.block_out_channels[-1]


def pool_encoder_features(down_block_samples: Sequence[torch.Tensor]
                          ) -> torch.Tensor:
    """Spatial mean-pool + concat of the NCHW tap -> (B, tap_feature_dim):
    (B, 10880) for SD v1 and SD 2.x."""
    return torch.cat([s.mean(dim=(2, 3)) for s in down_block_samples], dim=-1)
