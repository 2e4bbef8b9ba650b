"""LoRA attention adapters, folded into the UNet's projection weights.

Counterpart of ``e4t_diffusion_tpu/models/lora.py``. Per attention site,
rank-r adapters on the q/k/v/out projections are applied additively after
the multiplicative weight offset:

    y = x (W (1 + O))^T + scale * (x down^T) up^T          [+ bias]

``down`` (r, in) starts at N(0, 1/r) and ``up`` (out, r) at 0, so a fresh
bank changes nothing. The adapters do not depend on the input, so a
sampling run folds them once into the effective weights, after the offsets:

    W_eff = W (1 + O) + scale * up @ down

and int8 serving quantizes the fully folded weights.

The bank is ``{attention path: {"to_q_lora" | "to_k_lora" | "to_v_lora" |
"to_out_lora": {"down": (r, in), "up": (out, r)}}}`` over the sites of
``weight_offsets.attention_sites``, in torch (out, in) layout. Files use the
diffusers-0.14 ``save_attn_procs`` layout:
``<attention path>.processor.to_{q,k,v,out}_lora.{down,up}.weight``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from e4t_diffusion_torch.models.weight_offsets import attention_sites
from e4t_diffusion_torch.parallel.mesh import local_shard
from e4t_diffusion_torch.utils.convert import load_state_dict_file

# adapter name -> the projection it adapts, under the attention module
LORA_TO_PROJ = {
    "to_q_lora": "to_q",
    "to_k_lora": "to_k",
    "to_v_lora": "to_v",
    "to_out_lora": "to_out.0",
}

Bank = Dict[str, Dict[str, Dict[str, torch.Tensor]]]


def init_lora_layer(in_features: int, out_features: int, rank: int,
                    generator: Optional[torch.Generator] = None,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """One adapter: down ~ N(0, 1/rank) (rank, in), up = 0 (out, rank)."""
    if rank > min(in_features, out_features):
        raise ValueError(
            f"LoRA rank {rank} must be <= {min(in_features, out_features)}")
    return {
        "down": torch.randn((rank, in_features), generator=generator,
                            device=device) / rank,
        "up": torch.zeros((out_features, rank), device=device),
    }


def init_lora_bank(unet_config, rank: int = 4,
                   generator: Optional[torch.Generator] = None,
                   device="cpu") -> Bank:
    """A fresh bank for every attention site of the weight-offset bank: q
    (hidden -> hidden), k and v (context -> hidden), out (hidden ->
    hidden)."""
    bank = {}
    for path, qdim, kvdim in attention_sites(unet_config):
        bank[path] = {
            "to_q_lora": init_lora_layer(qdim, qdim, rank, generator, device),
            "to_k_lora": init_lora_layer(kvdim, qdim, rank, generator,
                                         device),
            "to_v_lora": init_lora_layer(kvdim, qdim, rank, generator,
                                         device),
            "to_out_lora": init_lora_layer(qdim, qdim, rank, generator,
                                           device),
        }
    return bank


def fold_lora_bank(weights: Dict[str, torch.Tensor], bank: Bank,
                   scale: float = 1.0, unet=None) -> Dict[str, torch.Tensor]:
    """``{parameter name: W + scale * up @ down}`` for every adapted
    projection; ``weights`` maps the UNet's parameter names to the weights
    to fold into (the offset-folded ones where the offsets apply). Computed
    in f32 and cast to the weight's type. Call after
    ``weight_offsets.fold_offset_bank``. On a ``unet`` split over tp each
    delta is cut as its weight is."""
    out = {}
    for site, layers in bank.items():
        for lora_key, proj in LORA_TO_PROJ.items():
            name = f"{site}.{proj}.weight"
            w = weights[name]
            layer = layers[lora_key]
            delta = (layer["up"].float().to(w.device)
                     @ layer["down"].float().to(w.device))
            if unet is not None:
                delta = local_shard(unet, name, delta)
            out[name] = (w.float() + float(scale) * delta).to(w.dtype)
    return out


def lora_to_torch(bank: Bank) -> Dict[str, torch.Tensor]:
    """Bank -> the diffusers-0.14 ``save_attn_procs`` state dict."""
    return {f"{site}.processor.{lora_key}.{leaf}.weight": t
            for site, layers in bank.items()
            for lora_key, layer in layers.items()
            for leaf, t in layer.items()}


def lora_from_torch(state_dict: Dict[str, torch.Tensor], unet_config
                    ) -> Bank:
    """Strict inverse of ``lora_to_torch``: exactly the keys of this UNet's
    attention sites (a missing or extra key raises)."""
    sites = [path for path, _, _ in attention_sites(unet_config)]
    expected = {f"{s}.processor.{k}.{leaf}.weight" for s in sites
                for k in LORA_TO_PROJ for leaf in ("down", "up")}
    got = set(state_dict)
    if got != expected:
        raise ValueError(
            f"LoRA state dict key mismatch: missing "
            f"{sorted(expected - got)[:5]} extra {sorted(got - expected)[:5]}"
            f" (counts: {len(expected)} expected, {len(got)} got)")
    return {s: {k: {leaf: state_dict[f"{s}.processor.{k}.{leaf}.weight"]
                    for leaf in ("down", "up")}
                for k in LORA_TO_PROJ}
            for s in sites}


def load_lora_weights(path: str, unet_config, device="cpu") -> Bank:
    """A ``pytorch_lora_weights.bin`` (or ``.safetensors``) file -> the
    bank, f32 on ``device``."""
    bank = lora_from_torch(load_state_dict_file(path), unet_config)
    return {s: {k: {leaf: t.to(device, torch.float32)
                    for leaf, t in layer.items()}
                for k, layer in layers.items()}
            for s, layers in bank.items()}
