"""Attention ops: einsum softmax attention and the low-dim flash kernel,
routed by one rule.

Counterpart of ``e4t_diffusion_tpu/ops/attention.py``. Tensors are
(batch, heads, seq, head_dim) ["BHSD"].

- ``einsum_attention``: f32 scores and softmax, p cast to q's dtype before
  P@V; the only masked / causal path.
- ``flash_attention``: the hand-written CUDA low-dim forward
  (``ops/flash_lowdim.py``) for head_dim rounded up to 8 below 128. The
  d >= 128 flash route of the reference is not ported yet and raises.
- ``dot_product_attention``: picks between them with ``flash_route``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from e4t_diffusion_torch.ops.flash_lowdim import flash_fwd_lowdim

# Score-tensor size above which self-attention goes to flash, and the
# shortest sequence that may. Both are the TPU reference's constants
# (attention.py:247,419), carried until they are measured on the H100.
FLASH_SCORE_BYTES = 128 * 1024 ** 2
FLASH_MIN_SEQ = 128
_NEG_INF = -1e30


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: Optional[float] = None,
                     bias: Optional[torch.Tensor] = None,
                     causal: bool = False) -> torch.Tensor:
    """Plain softmax attention: f32 scores and softmax, output in q's
    dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        qlen, klen = s.shape[-2], s.shape[-1]
        mask = torch.ones((qlen, klen), dtype=torch.bool,
                          device=s.device).tril(klen - qlen)
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(q.dtype), v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention on BHSD tensors (no mask). head_dim is zero-padded
    to a multiple of 8; heads at or above 128 wide are not ported yet."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    d_sub = _round_up(d, 8)
    if d_sub >= 128:
        raise NotImplementedError(
            f"flash attention for head_dim {d} (the d >= 128 route) is not "
            f"ported yet")
    qf = q.reshape(b * h, sq, d)
    kf = k.reshape(b * h, sk, d)
    vf = v.reshape(b * h, sk, d)
    if d_sub != d:
        pad = (0, d_sub - d)
        qf, kf, vf = (torch.nn.functional.pad(t, pad) for t in (qf, kf, vf))
    out, _ = flash_fwd_lowdim(qf.contiguous(), kf.contiguous(),
                              vf.contiguous(), scale)
    return out[..., :d].reshape(b, h, sq, d)


def flash_route(q_shape: Sequence[int], k_shape: Sequence[int],
                device: torch.device, has_bias: bool = False,
                causal: bool = False) -> bool:
    """True where ``dot_product_attention`` sends a site to flash: a CUDA
    device, no bias, not causal, seq >= 128 and an f32 score tensor above
    128 MiB. The reference's rule with ``device.type == "cuda"`` in place
    of ``default_backend() == "tpu"``."""
    b, h, sq = q_shape[0], q_shape[1], q_shape[2]
    score_bytes = b * h * sq * k_shape[2] * 4
    return (torch.device(device).type == "cuda" and not has_bias
            and not causal and sq >= FLASH_MIN_SEQ
            and score_bytes > FLASH_SCORE_BYTES)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          bias: Optional[torch.Tensor] = None,
                          causal: bool = False) -> torch.Tensor:
    """Einsum attention for small score tensors, flash for large ones."""
    if flash_route(q.shape, k.shape, q.device, has_bias=bias is not None,
                   causal=causal):
        return flash_attention(q, k, v, scale=scale)
    return einsum_attention(q, k, v, scale=scale, bias=bias, causal=causal)
