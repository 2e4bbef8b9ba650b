"""GroupNorm(+SiLU) for the UNet and VAE towers.

Counterpart of ``e4t_diffusion_tpu/models/norm.py`` on its default path
(plain GroupNorm then SiLU). The reference's fused Pallas GroupNorm is off
by default and is ported in a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def group_norm_act(x: torch.Tensor, norm: nn.GroupNorm,
                   act: Optional[str] = None) -> torch.Tensor:
    """Apply ``norm`` (statistics in f32 inside the op), then SiLU if
    ``act == "silu"``."""
    h = F.group_norm(x, norm.num_groups, norm.weight, norm.bias, norm.eps)
    return F.silu(h) if act == "silu" else h
