"""GroupNorm(+SiLU) for the UNet and VAE towers.

Counterpart of ``e4t_diffusion_tpu/models/norm.py``. By default a site runs
``F.group_norm`` then ``F.silu`` (the reference's flax path). With
``E4T_FUSED_GN`` on (read per call) every site whose activation is bf16 or
f32 runs ``ops/groupnorm.FusedGroupNorm``: the GroupNorm kernel on the card,
its plain version on the CPU. The modules keep their ``nn.GroupNorm``
parameters either way, so state dicts do not depend on the knob.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from e4t_diffusion_torch.ops import groupnorm as gnops


def fused_gn_route(x: torch.Tensor, groups: int) -> bool:
    """True where ``group_norm_act`` sends a site to the fused GroupNorm:
    the knob is on, x is bf16 or f32 and its channels split into
    ``groups``."""
    return (gnops.fused_gn_enabled() and x.dtype in gnops.DTYPES
            and x.shape[1] % groups == 0)


def group_norm_act(x: torch.Tensor, norm: nn.GroupNorm,
                   act: Optional[str] = None) -> torch.Tensor:
    """Apply ``norm`` (statistics in f32), then SiLU if ``act ==
    "silu"``."""
    if fused_gn_route(x, norm.num_groups):
        return gnops.FusedGroupNorm.apply(x, norm.weight, norm.bias,
                                          norm.num_groups, norm.eps, act)
    h = F.group_norm(x, norm.num_groups, norm.weight, norm.bias, norm.eps)
    return F.silu(h) if act == "silu" else h
