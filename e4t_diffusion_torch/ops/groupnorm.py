"""GroupNorm (+SiLU): the CUDA kernel, its wrapper, its plain version and
its autograd Function.

Counterpart of ``e4t_diffusion_tpu/ops/groupnorm.py``.
``csrc/group_norm.cu`` (nvcc for sm_90a, called through ctypes) replaces
the TPU kernel ``_fused_group_norm_impl``: per (sample, group) f32 sum and
sum of squares, the fast variance E[x^2] - E[x]^2, the affine folded to
``x * a + b``, optional SiLU, output in x's dtype and memory layout. It
takes NCHW-contiguous and channels-last x: the UNet and VAE pass both
(a conv of a channels-last input stays channels-last, and the spatial
transformers return a channels-last view). Channels-last x from 12 MB
runs one cooperative launch of resident blocks that read whole pixels and
meet at grid barriers, with a workspace this wrapper allocates
(``nhwc_workspace_floats``); NCHW x and smaller channels-last x one block
per (sample, group). The first design, one block per (sample, group) at
every size and layout, stays as the yardstick ``group_norm_sync``, which no
path calls.

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
# the channels-last kernel's task covers at most this many vectors of a
# pixel (csrc/group_norm.cu, kNhwcMaxCols), and a card holds at most this
# many resident blocks an SM
NHWC_MAX_COLS = 256
MAX_BLOCKS_PER_SM = 32


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


def _check_kernel_inputs(x, weight, bias) -> bool:
    """What the kernels take, checked on CUDA tensors before a launch;
    returns whether x is channels-last."""
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
    return channels_last


def nhwc_workspace_floats(n: int, channels: int, groups: int,
                          sms: int) -> int:
    """The f32 workspace the channels-last kernel takes on a card of ``sms``
    SMs: (sum, sum of squares) per group for max(n * chunks, 32 * sms)
    tasks, a task being a pixel range of one sample and one chunk of at most
    ``NHWC_MAX_COLS`` channels (32 blocks an SM is the most that stay
    resident, one task each), then (mean, inv) per (sample, group)."""
    chunks = -(-channels // NHWC_MAX_COLS)
    return (2 * groups * max(n * chunks, MAX_BLOCKS_PER_SM * sms)
            + 2 * n * groups)


def _launch(symbol, x, weight, bias, groups, eps, act,
            workspace=False) -> torch.Tensor:
    """One GroupNorm entry point of the source on checked CUDA operands;
    ``workspace``: the entry point takes the channels-last kernel's
    workspace (allocated here for channels-last x, null for NCHW)."""
    channels_last = _check_kernel_inputs(x, weight, bias)
    n, c = x.shape[:2]
    y = torch.empty_like(x)  # x's layout
    types = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
             + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int])
    extra = ()
    if workspace:
        types += [ctypes.c_void_p, ctypes.c_longlong]
        extra = (None, 0)
        if channels_last:
            sms = torch.cuda.get_device_properties(
                x.device).multi_processor_count
            ws = torch.empty(nhwc_workspace_floats(n, c, groups, sms),
                             dtype=torch.float32, device=x.device)
            extra = (ws.data_ptr(), ws.numel())
    _build.launch(SOURCE, symbol, types, x.device,
                  x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                  y.data_ptr(), n, c, groups, math.prod(x.shape[2:]),
                  int(x.dtype == torch.bfloat16),
                  int(weight.dtype == torch.bfloat16), int(channels_last),
                  float(eps), int(act == "silu"), *extra)
    return y


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
    y = _launch("e4t_group_norm", x, weight, bias, groups, eps, act,
                workspace=True)
    fused_group_norm.launches += 1
    return y


fused_group_norm.launches = 0


def group_norm_sync(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, groups: int, eps: float,
                    act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm(+SiLU) by the kernel's first design, one block per (sample,
    group) (``e4t_group_norm_sync``): the yardstick the kernel is timed and
    checked against. No path calls it, and it counts no launch. CUDA tensors
    only, with the checks ``fused_group_norm`` runs."""
    _check(x, weight, bias, groups, act)
    if x.device.type != "cuda":
        raise ValueError("group_norm_sync runs on CUDA tensors only")
    return _launch("e4t_group_norm_sync", x, weight, bias, groups, eps, act)


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
