"""Name-aware structured random parameter fill.

Counterpart of ``e4t_diffusion_tpu/utils/structured_init.py``: parameters
with the magnitude structure that default inits and trained nets share,
where weight values matter but trained weights are not at hand (the int8
quality study, ``int8_quality.py``): weights of two or more dimensions are
normals scaled by 1/sqrt(fan_in), norm weights ones, biases zeros,
embeddings N(0, 0.02^2).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


@torch.no_grad()
def structured_fill_(module: nn.Module,
                     generator: Optional[torch.Generator] = None) -> None:
    """Fill every parameter of ``module`` in place, by name and shape:
    "embedding" in the name -> N(0, 0.02^2); "bias" -> 0; other 1-D or
    0-D weights (norm scales) -> 1; torch linear (out, in) and conv (out,
    in, kh, kw) weights -> N(0, 1) / sqrt(in * kh * kw); other weights of
    three or more dimensions (stacked linears, (n, out, in)) ->
    N(0, 1) / sqrt(in). Draws come from ``generator`` on the parameter's
    device, in f32, then cast."""
    for name, p in module.named_parameters():
        leaf = name.lower()
        if "embedding" in leaf:
            value = 0.02 * _normal(p, generator)
        elif leaf.endswith("bias"):
            value = torch.zeros_like(p, dtype=torch.float32)
        elif p.dim() < 2:
            value = torch.ones_like(p, dtype=torch.float32)
        else:
            fan_in = (math.prod(p.shape[1:]) if p.dim() in (2, 4)
                      else p.shape[-1])
            value = _normal(p, generator) / math.sqrt(fan_in)
        p.copy_(value.to(p.dtype))


def _normal(p: torch.Tensor, generator) -> torch.Tensor:
    return torch.randn(p.shape, generator=generator, device=p.device)
