"""E4T weight-offset hypernetworks, folded into the UNet's attention kernels.

Counterpart of ``e4t_diffusion_tpu/models/weight_offsets.py``. Each
attention projection (to_q/to_k/to_v of attn1 and attn2 in every
transformer block: 96 sites in SD v1 and in SD 2.x) owns a no-input
hypernetwork

    v -> linear1: 1->row, linear2: 1->col  (rank-1 seed vx vy^T)
      -> linear_column: row->row, column-wise -> linear_row: col->col, row-wise

whose output O multiplies the projection weight: W_eff = W * (1 + O).
The offsets depend only on their own parameters, so they are folded once
per sampling run, not per attention call; training folds once per step,
inside the differentiated region.

The bank is a flat state dict in the reference's ``weight_offsets.pt``
layout (``<site>.wo_q.v``, ``<site>.wo_q.linear1.weight``, ...). Torch
weights are (out, in): the offset here is the transpose of the JAX
package's (in, out) offset.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from e4t_diffusion_torch.parallel.mesh import local_shard

WO_KEYS = ("wo_q", "wo_k", "wo_v")
_WO_TO_PROJ = {"wo_q": "to_q", "wo_k": "to_k", "wo_v": "to_v"}
_LINEARS = ("linear1", "linear2", "linear_column", "linear_row")


def attention_sites(unet_config) -> List[Tuple[str, int, int]]:
    """(attention-module path, query_dim, context_dim) for attn1 and attn2
    of every transformer block, in diffusers dotted naming."""
    sites = []
    cad = unet_config.cross_attention_dim
    block_out = tuple(unet_config.block_out_channels)
    layers = unet_config.layers_per_block

    def add(path, dim):
        sites.append((f"{path}.attn1", dim, dim))
        sites.append((f"{path}.attn2", dim, cad))

    for bi, btype in enumerate(unet_config.down_block_types):
        if "CrossAttn" in btype:
            for li in range(layers):
                add(f"down_blocks.{bi}.attentions.{li}.transformer_blocks.0",
                    block_out[bi])
    add("mid_block.attentions.0.transformer_blocks.0", block_out[-1])
    rev = list(reversed(block_out))
    for bi, btype in enumerate(unet_config.up_block_types):
        if "CrossAttn" in btype:
            for li in range(layers + 1):
                add(f"up_blocks.{bi}.attentions.{li}.transformer_blocks.0",
                    rev[bi])
    return sites


def _linear_init(fan_in: int, fan_out: int, generator, device):
    """torch.nn.Linear's default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for weight and bias. At fan_in=1 the seed vectors start at O(1), so the
    initial offsets perturb W by ~20%, as in the reference."""
    bound = fan_in ** -0.5

    def u(*shape):
        return (torch.rand(shape, generator=generator, device=device)
                * 2.0 - 1.0) * bound
    return u(fan_out, fan_in), u(fan_out)


def init_offset_bank(unet_config, generator: Optional[torch.Generator] = None,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """A freshly initialised bank (f32) for every attention site."""
    bank = {}
    for path, qdim, kvdim in attention_sites(unet_config):
        # heads * dim_head == query_dim: SD v1's 8 heads of qdim / 8 and
        # SD 2.x's per-block heads of 64 (5, 10, 20 x 64) alike
        inner = qdim
        for wo, row in (("wo_q", qdim), ("wo_k", kvdim), ("wo_v", kvdim)):
            p = f"{path}.{wo}"
            bank[f"{p}.v"] = torch.ones(1, device=device)
            for lin, (i, o) in zip(_LINEARS, ((1, row), (1, inner),
                                              (row, row), (inner, inner))):
                w, b = _linear_init(i, o, generator, device)
                bank[f"{p}.{lin}.weight"] = w
                bank[f"{p}.{lin}.bias"] = b
    return bank


def expected_keys(unet_config) -> List[str]:
    """Every key of a complete bank for ``unet_config``."""
    return [f"{path}.{wo}.{leaf}"
            for path, _, _ in attention_sites(unet_config)
            for wo in WO_KEYS
            for leaf in ("v", *(f"{lin}.{t}" for lin in _LINEARS
                                for t in ("weight", "bias")))]


def check_bank(bank: Dict[str, torch.Tensor], unet_config) -> None:
    """Strict key check: the bank holds exactly the sites of the UNet."""
    want = set(expected_keys(unet_config))
    missing = sorted(want - bank.keys())
    unexpected = sorted(bank.keys() - want)
    if missing or unexpected:
        raise KeyError(f"offset bank mismatch: missing {missing[:4]} "
                       f"({len(missing)}), unexpected {unexpected[:4]} "
                       f"({len(unexpected)})")


def compute_offsets(bank: Dict[str, torch.Tensor],
                    prefixes: List[str]) -> torch.Tensor:
    """Evaluate the hypernetworks at ``prefixes`` (sites sharing one
    (row, col) shape) as one batched chain of products -> (n, col, row)
    offsets in torch (out, in) layout."""

    def stack(leaf):
        return torch.stack([bank[f"{p}.{leaf}"].float() for p in prefixes])

    v = stack("v")[:, None, :]                               # (n, 1, 1)
    vx = (v @ stack("linear1.weight").transpose(1, 2))[:, 0] + stack(
        "linear1.bias")                                      # (n, row)
    vy = (v @ stack("linear2.weight").transpose(1, 2))[:, 0] + stack(
        "linear2.bias")                                      # (n, col)
    a = vx[:, :, None] * vy[:, None, :]                      # (n, row, col)
    # column-wise map over A^T rows, then the row-wise map
    b = (a.transpose(1, 2) @ stack("linear_column.weight").transpose(1, 2)
         + stack("linear_column.bias")[:, None, :])          # (n, col, row)
    c = (b.transpose(1, 2) @ stack("linear_row.weight").transpose(1, 2)
         + stack("linear_row.bias")[:, None, :])             # (n, row, col)
    return c.transpose(1, 2)                                 # (n, col, row)


def fold_offset_bank(unet: torch.nn.Module, bank: Dict[str, torch.Tensor],
                     weights: Optional[Dict[str, torch.Tensor]] = None,
                     dtype: Optional[torch.dtype] = None
                     ) -> Dict[str, torch.Tensor]:
    """Effective projection weights W * (1 + O) for every site, as
    {parameter name: tensor} for ``torch.func.functional_call``. The 96
    hypernetworks are evaluated batched by offset shape (6 groups in SD v1,
    the same in SD 2.x, whose cross sites are 1024 wide);
    the fold is computed in f32 and cast to ``dtype`` (default: the
    weight's). ``weights`` supplies W (default: the UNet's own parameters);
    training passes its f32 trainables, and the fold is differentiable in
    both W and the bank. On a UNet split over tp each offset is cut as its
    weight is (``parallel/mesh.local_shard``): every rank evaluates the
    whole bank, so the bank's gradient on a rank is its shard's share."""
    groups: Dict[Tuple[int, int], List[str]] = {}
    for key, t in bank.items():
        if key.endswith(".linear1.weight"):
            prefix = key[: -len(".linear1.weight")]
            shape = (t.shape[0], bank[f"{prefix}.linear2.weight"].shape[0])
            groups.setdefault(shape, []).append(prefix)
    params = dict(unet.named_parameters()) if weights is None else weights
    folded = {}
    for members in groups.values():
        offs = compute_offsets(bank, members)
        for prefix, o in zip(members, offs):
            site, wo = prefix.rsplit(".", 1)
            name = f"{site}.{_WO_TO_PROJ[wo]}.weight"
            w = params[name]
            o = local_shard(unet, name, o)
            folded[name] = (w.float() * (1.0 + o.to(w.device))).to(
                dtype or w.dtype)
    return folded


def offset_linear_apply(bank: Dict[str, torch.Tensor], prefix: str,
                        weight: torch.Tensor, x: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x W_eff^T (+ bias) with W_eff = W * (1 + O), O the offset of the
    hypernetwork at ``prefix`` of ``bank`` (e.g. ``"<site>.wo_q"``) and
    ``weight`` W in torch (out, in) layout; differentiable in x, W, the
    bias and the hypernetwork, by the product rule. Counterpart of the JAX
    package's ``offset_linear_apply``: one layer of the fold that
    ``fold_offset_bank`` applies to every site."""
    o = compute_offsets(bank, [prefix])[0]
    w_eff = weight * (1.0 + o.to(weight.dtype))
    return torch.nn.functional.linear(x, w_eff, bias)
