"""GroupNorm (+SiLU): the CUDA kernel, its wrapper, its plain version and
its autograd Function.

Counterpart of ``e4t_diffusion_tpu/ops/groupnorm.py``.
``csrc/group_norm.cu`` (nvcc for sm_90a, called through ctypes) replaces
the TPU kernel ``_fused_group_norm_impl``: per (sample, group) f32 sum and
sum of squares, the fast variance E[x^2] - E[x]^2, the affine folded to
``x * a + b``, optional SiLU, output in x's dtype and memory layout. It
takes NCHW-contiguous and channels-last x: the UNet and VAE pass both
(a conv of a channels-last input stays channels-last, and the spatial
transformers return a channels-last view).

``fused_group_norm`` launches the kernel for CUDA tensors, raises on
anything the kernel does not take, and counts its launches
(``fused_group_norm.launches``). For CPU tensors it runs
``group_norm_reference``, the plain PyTorch version the tests hold against
JAX and ``chip_smoke.py`` holds the kernel against. ``FusedGroupNorm``
pairs it with a backward through autograd of the plain version on a
recompute, as the reference's custom VJP does (``_fused_gn_bwd``): there is
no backward kernel.

The knob ``E4T_FUSED_GN`` (off by default) is read per call, by
``models/norm.group_norm_act``. The reference also routes only the slices
that fit its VMEM (``fused_gn_fits``); the kernel here takes every span,
so the port has no such gate.
"""
from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import torch

from e4t_diffusion_torch.ops import _build

SOURCE = "group_norm"
KNOB = "E4T_FUSED_GN"
ACTS = (None, "silu")
DTYPES = (torch.bfloat16, torch.float32)


def fused_gn_enabled() -> bool:
    """``E4T_FUSED_GN`` parsed as the reference does: anything but unset,
    "", "0" and "false" (any case) is on."""
    return os.environ.get(KNOB, "0").lower() not in ("0", "false", "")


def group_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int, eps: float,
                         act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm(+SiLU) of NCHW ``x`` step by step as the kernel computes
    it, in f32: mean and E[x^2] per (sample, group), var = E[x^2] - mean^2,
    a = weight / sqrt(var + eps), b = bias - mean * a, y = x * a + b, then
    y * sigmoid(y) for act "silu"; the result in x's dtype."""
    n, c = x.shape[:2]
    xf = x.float().reshape(n, groups, -1)
    mean = xf.mean(dim=-1)
    var = (xf * xf).mean(dim=-1) - mean * mean
    inv = torch.rsqrt(var + eps)
    w = weight.float().reshape(groups, c // groups)
    a = inv[:, :, None] * w                            # (n, groups, c/g)
    b = bias.float().reshape(groups, c // groups) - mean[:, :, None] * a
    y = xf.reshape(n, groups, c // groups, -1) * a[..., None] + b[..., None]
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


def _check(x, weight, bias, groups, act) -> None:
    if act not in ACTS:
        raise ValueError(f"act {act!r}: one of {ACTS}")
    if x.dim() < 2:
        raise ValueError(f"x must be (N, C, ...), got {tuple(x.shape)}")
    c = x.shape[1]
    if groups <= 0 or c % groups != 0:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"weight {tuple(weight.shape)} and bias "
                         f"{tuple(bias.shape)} must be ({c},)")
    if not (x.device == weight.device == bias.device):
        raise ValueError("x, weight and bias must be on one device")


def fused_group_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, groups: int, eps: float,
                     act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm(+SiLU) over (N, C, ...) ``x``.

    CUDA tensors: bf16 or f32 ``x``, contiguous or (4-D) channels-last, the
    output in the same layout; contiguous weight and bias (C,) of one dtype,
    bf16 or f32, read in f32. Launches the kernel on the current stream and
    counts it on ``fused_group_norm.launches``. CPU tensors: the plain
    version. Records no gradient (``FusedGroupNorm`` does)."""
    _check(x, weight, bias, groups, act)
    if x.device.type == "cpu":
        return group_norm_reference(x, weight, bias, groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in DTYPES or weight.dtype not in DTYPES or \
            bias.dtype != weight.dtype:
        raise TypeError(f"x {x.dtype}, weight {weight.dtype}, bias "
                        f"{bias.dtype}: the kernel takes {DTYPES}, weight "
                        f"and bias in one of them")
    if not (weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("weight and bias must be contiguous")
    channels_last = not x.is_contiguous()
    if channels_last and not (
            x.dim() == 4
            and x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("x must be contiguous, NCHW or channels-last")
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    n, c = x.shape[:2]
    y = torch.empty_like(x)  # x's layout
    _build.launch(SOURCE, "e4t_group_norm",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                  + [ctypes.c_longlong] + [ctypes.c_int] * 3
                  + [ctypes.c_float, ctypes.c_int], x.device,
                  x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                  y.data_ptr(), n, c, groups, math.prod(x.shape[2:]),
                  int(x.dtype == torch.bfloat16),
                  int(weight.dtype == torch.bfloat16), int(channels_last),
                  float(eps), int(act == "silu"))
    fused_group_norm.launches += 1
    return y


fused_group_norm.launches = 0


class FusedGroupNorm(torch.autograd.Function):
    """``fused_group_norm`` forward; the backward differentiates
    ``group_norm_reference`` on a recompute from the saved (x, weight,
    bias), the reference's ``_fused_gn_bwd`` (jax.vjp of ``_gn_reference``).
    Gradients come back in each input's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups: int, eps: float,
                act: Optional[str]):
        ctx.save_for_backward(x, weight, bias)
        ctx.config = (groups, eps, act)
        return fused_group_norm(x, weight, bias, groups, eps, act)

    @staticmethod
    def backward(ctx, grad_out):
        x, weight, bias = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((x, weight, bias),
                                     ctx.needs_input_grad[:3])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y = group_norm_reference(*inputs, *ctx.config)
            grads = iter(torch.autograd.grad(y, wanted, grad_out))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None, None, None)
