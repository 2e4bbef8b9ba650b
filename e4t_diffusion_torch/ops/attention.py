"""Attention ops: einsum softmax attention and the flash kernels, routed by
one rule.

Counterpart of ``e4t_diffusion_tpu/ops/attention.py``. Tensors are
(batch, heads, seq, head_dim) ["BHSD"].

- ``einsum_attention``: f32 scores and softmax, p cast to q's dtype before
  P@V; the only masked / causal path.
- ``flash_attention``: ``FlashAttention``, an autograd Function over the
  hand-written CUDA kernels: the forward of ``ops/flash_lowdim.py`` and
  the backward of ``ops/flash_bwd.py``, both for head_dim up to 256, in
  bf16 or f32 (each wrapper picks its kernel by the operands' type; the
  routes below look at shapes only, as the reference's do).
  head_dim is zero-padded to a multiple of 8.
- ``shortseq_mh_attention``: ``ShortSeqAttention``, an autograd Function
  over the short-sequence kernel of ``ops/shortseq.py`` (forward) and
  einsum attention (backward), for self-attention with 128 < seq <= 512
  and a head dim below 128 (the ViT-H's 257-token d=80 sites), taken when
  ``E4T_SHORTSEQ_MH_ATTN`` is a positive integer (read per call).
- ``dot_product_attention``: checks ``shortseq_route`` first, then picks
  between einsum and flash with ``flash_route``, in the reference's order;
  ``flash_threshold`` overrides the score-size threshold (training runs
  all-flash under ``flash_threshold(0)``, as the JAX train step traces).
- ``int8_flash_attention(mode)``: while active, flash sites with a head dim
  below 128 quantize q/k (and v in "qkpv" mode) per head and run the int8
  kernel of ``ops/flash_int8.py`` (serving only; forward only).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import os
from typing import Iterator, Optional, Sequence

import torch

from e4t_diffusion_torch.ops import flash_int8, shortseq
from e4t_diffusion_torch.ops.flash_bwd import flash_bwd
from e4t_diffusion_torch.ops.flash_lowdim import MAX_D, WIDE_MIN_D, flash_fwd

# Score-tensor size above which self-attention goes to flash, and the
# shortest sequence that may. Both are the TPU reference's constants
# (attention.py:247,419), carried until they are measured on the H100;
# E4T_FLASH_THRESHOLD_BYTES, read per call, sets the first, as it sets the
# reference's.
FLASH_SCORE_BYTES = 128 * 1024 ** 2
FLASH_THRESHOLD_KNOB = "E4T_FLASH_THRESHOLD_BYTES"
FLASH_MIN_SEQ = 128
# the short-sequence route takes seq above this (and up to the kernel's
# shortseq.MAX_SEQ) and round_up(head_dim, 8) below shortseq.MAX_D, the
# reference's bounds (attention.py:379-389)
SHORTSEQ_MIN_SEQ = 128
_NEG_INF = -1e30

# the threshold flash_threshold() put in force in this context, if any
_THRESHOLD_OVERRIDE: contextvars.ContextVar = contextvars.ContextVar(
    "flash_threshold", default=None)
# the mode int8_flash_attention() put in force in this context, if any
_INT8_MODE: contextvars.ContextVar = contextvars.ContextVar(
    "int8_flash_attention", default=None)


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


class FlashAttention(torch.autograd.Function):
    """Flash attention over (BH, S, D) tensors, D a multiple of 8 up to
    256: the flash forward and backward kernels. Saves (q, k, v, out,
    lse), as the reference's custom VJPs do (flash_kernels.py:698-742). On
    the CPU both directions run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        out, lse = flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(),
                               ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention on BHSD tensors (no mask), differentiable. head_dim
    is zero-padded to a multiple of 8 (the padding changes nothing); heads
    wider than 256 are not taken."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    d_sub = _round_up(d, 8)
    if d_sub > MAX_D:
        raise NotImplementedError(
            f"flash attention for head_dim {d}: the kernels take up to "
            f"{MAX_D}")
    qf = q.reshape(b * h, sq, d)
    kf = k.reshape(b * h, sk, d)
    vf = v.reshape(b * h, sk, d)
    if d_sub != d:
        pad = (0, d_sub - d)
        qf, kf, vf = (torch.nn.functional.pad(t, pad) for t in (qf, kf, vf))
    mode = _INT8_MODE.get()
    if mode is not None and d_sub < WIDE_MIN_D:
        if q.requires_grad or k.requires_grad or v.requires_grad:
            raise RuntimeError("int8 flash attention is forward-only: leave "
                               "int8_flash_attention() to differentiate")
        out = _int8_lowdim_path(qf, kf, vf, scale, mode)
    else:
        out = FlashAttention.apply(qf.contiguous(), kf.contiguous(),
                                   vf.contiguous(), scale)
    return out[..., :d].reshape(b, h, sq, d)


def _quantize_per_head(x32: torch.Tensor):
    """Symmetric int8 per head (dim 0) of an f32 (BH, S, D) tensor -> (int8
    values, (BH,) f32 scales)."""
    s = torch.clamp(x32.abs().amax(dim=(1, 2)), min=1e-8) / 127.0
    xi = torch.clamp(torch.round(x32 / s[:, None, None]), -127, 127)
    return xi.to(torch.int8), s


def int8_attention_operands(qf, kf, vf, scale: float, mode: str):
    """The quantization in front of the int8 kernel (attention.py:130-160 of
    the JAX package): q, k and (mode "qkpv") v per head, k centred on its
    mean over the Sk tokens first (a per-head constant key shift moves each
    score row by a constant, so the softmax is exactly invariant). qf (BH,
    Sq, D), kf/vf (BH, Sk, D) -> (qi, ki, v operand, sc (BH, 2) f32)."""
    q32 = qf.float()
    k32 = kf.float()
    k32 = k32 - k32.mean(dim=1, keepdim=True)
    qi, qs = _quantize_per_head(q32)
    ki, ks = _quantize_per_head(k32)
    if mode == "qkpv":
        v_op, vs = _quantize_per_head(vf.float())
        v_c = vs / 127.0
    else:
        v_op = vf.contiguous()
        v_c = torch.ones_like(qs)
    sc = torch.stack([qs * ks * scale, v_c], dim=1)
    return qi, ki, v_op, sc


def _int8_lowdim_path(qf, kf, vf, scale: float, mode: str) -> torch.Tensor:
    """Quantize per head and call the int8 kernel at the reference's kv tile
    (``flash_int8.quant_tile``: ``E4T_FLASH_BLOCK_K``, read per call, capped
    at round_up(Sk, 128)); qf (BH, Sq, D_sub), kf/vf (BH, Sk, D_sub) -> out
    (BH, Sq, D_sub) in qf's dtype."""
    qi, ki, v_op, sc = int8_attention_operands(qf, kf, vf, scale, mode)
    out, _ = flash_int8.flash_fwd_int8(qi, ki, v_op, sc, mode, qf.dtype,
                                       flash_int8.quant_tile(kf.shape[1]))
    return out


@contextlib.contextmanager
def int8_flash_attention(mode: str = "qk") -> Iterator[None]:
    """While active, the flash sites with ``round_up(head_dim, 8) < 128``
    (the UNet's 4096-token d=40 and 1024-token d=80 self-attention at
    512px) run the int8 kernel: "qk" quantizes q and k (P@V stays bf16),
    "qkpv" v too. Einsum sites and wider heads are unchanged. Forward only:
    a q/k/v that requires grad raises."""
    if mode not in flash_int8.MODES:
        raise ValueError(f"int8 attention mode {mode!r}: one of "
                         f"{flash_int8.MODES}")
    token = _INT8_MODE.set(mode)
    try:
        yield
    finally:
        _INT8_MODE.reset(token)


@contextlib.contextmanager
def flash_threshold(score_bytes: Optional[int]) -> Iterator[None]:
    """While active, ``flash_route`` compares score tensors with
    ``score_bytes`` instead of ``FLASH_SCORE_BYTES`` (``None``: no change).
    The tuning step runs under ``flash_threshold(0)``: every site that is
    not causal, has no bias and has seq >= 128 goes to flash, whose
    backward keeps no score tensor."""
    if score_bytes is None:
        yield
        return
    token = _THRESHOLD_OVERRIDE.set(score_bytes)
    try:
        yield
    finally:
        _THRESHOLD_OVERRIDE.reset(token)


def flash_threshold_bytes() -> int:
    """The score-size threshold ``flash_route`` applies in this context: a
    ``flash_threshold`` in force wins (the reference's
    ``_THRESHOLD_OVERRIDE``), else ``E4T_FLASH_THRESHOLD_BYTES`` (an
    integer, read per call), else ``FLASH_SCORE_BYTES``."""
    override = _THRESHOLD_OVERRIDE.get()
    if override is not None:
        return override
    return int(os.environ.get(FLASH_THRESHOLD_KNOB, FLASH_SCORE_BYTES))


def flash_route(q_shape: Sequence[int], k_shape: Sequence[int],
                device: torch.device, has_bias: bool = False,
                causal: bool = False) -> bool:
    """True where ``dot_product_attention`` sends a site to flash: a CUDA
    device, no bias, not causal, seq >= 128 and an f32 score tensor above
    ``flash_threshold_bytes()`` (128 MiB unless ``flash_threshold`` or
    ``E4T_FLASH_THRESHOLD_BYTES`` says otherwise). The reference's rule with ``device.type == "cuda"`` in
    place of ``default_backend() == "tpu"``."""
    b, h, sq = q_shape[0], q_shape[1], q_shape[2]
    score_bytes = b * h * sq * k_shape[2] * 4
    return (torch.device(device).type == "cuda" and not has_bias
            and not causal and sq >= FLASH_MIN_SEQ
            and score_bytes > flash_threshold_bytes())


class ShortSeqAttention(torch.autograd.Function):
    """Short-sequence self-attention over BHSD tensors, ``g`` heads per
    cell: the forward is the short-sequence kernel (head_dim zero-padded to
    a multiple of 8), the backward differentiates ``einsum_attention`` on a
    recompute from the saved (q, k, v), the reference's
    ``_shortseq_mh_bwd``. On the CPU the forward runs the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, g: int):
        b, h, s, d = q.shape
        d_sub = _round_up(d, 8)
        qf, kf, vf = (t.reshape(b * h, s, d) for t in (q, k, v))
        if d_sub != d:
            qf, kf, vf = (torch.nn.functional.pad(t, (0, d_sub - d))
                          for t in (qf, kf, vf))
        out = shortseq.flash_fwd_shortseq(qf.contiguous(), kf.contiguous(),
                                          vf.contiguous(), scale, g)
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return out[..., :d].reshape(b, h, s, d)

    @staticmethod
    def backward(ctx, dout):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = einsum_attention(*inputs, scale=ctx.scale)
            grads = torch.autograd.grad(out, inputs, dout)
        return (*grads, None, None)


def shortseq_mh_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention on BHSD tensors through ``ShortSeqAttention``, with g
    heads per cell picked from ``E4T_SHORTSEQ_MH_ATTN`` as the reference
    picks it; with the knob off (or <= 0) a ValueError names it."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    g = shortseq.heads_per_cell(q.shape[0] * q.shape[1],
                                shortseq.heads_knob())
    return ShortSeqAttention.apply(q, k, v, scale, g)


def shortseq_route(q_shape: Sequence[int], k_shape: Sequence[int],
                   device: torch.device, has_bias: bool = False,
                   causal: bool = False) -> bool:
    """True where ``dot_product_attention`` sends a site to the
    short-sequence kernel: ``E4T_SHORTSEQ_MH_ATTN`` > 0, a CUDA device, no
    bias, not causal, self-attention (seq of q equal to that of k), 128 <
    seq <= 512, ``round_up(head_dim, 8) < 128`` and an even batch x heads.
    The reference's ``_use_shortseq_mh`` with ``device.type == "cuda"`` in
    place of ``default_backend() == "tpu"``."""
    b, h, sq, d = q_shape
    return (shortseq.heads_knob() > 0
            and torch.device(device).type == "cuda" and not has_bias
            and not causal and sq == k_shape[2]
            and SHORTSEQ_MIN_SEQ < sq <= shortseq.MAX_SEQ
            and _round_up(d, 8) < shortseq.MAX_D and (b * h) % 2 == 0)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          bias: Optional[torch.Tensor] = None,
                          causal: bool = False) -> torch.Tensor:
    """The short-sequence kernel where ``shortseq_route`` says so, else
    einsum attention for small score tensors and flash for large ones."""
    if shortseq_route(q.shape, k.shape, q.device, has_bias=bias is not None,
                      causal=causal):
        return shortseq_mh_attention(q, k, v, scale=scale)
    if flash_route(q.shape, k.shape, q.device, has_bias=bias is not None,
                   causal=causal):
        return flash_attention(q, k, v, scale=scale)
    return einsum_attention(q, k, v, scale=scale, bias=bias, causal=causal)
