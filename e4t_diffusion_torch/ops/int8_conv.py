"""int8 convolution: the CUDA kernel, its wrapper and its plain version.

``csrc/int8_conv.cu`` (nvcc for sm_90a, called through ctypes) is an
implicit-GEMM int8 convolution on s8 tensor cores. It stands for the XLA
convolution of ``e4t_diffusion_tpu/ops/quant.py:276-283`` (``int8_conv``),
which has no PyTorch counterpart on CUDA. Every quantized UNet convolution
goes to it, the 1x1 ones included (one route for every conv site).

``int8_conv`` launches the kernel for CUDA tensors, raises on anything the
kernel does not take, and counts its launches (``int8_conv.launches``). For
CPU tensors it runs ``int8_conv_reference``, the plain PyTorch version the
tests hold against JAX and ``chip_smoke.py`` holds the kernel against. The
source note gives the bound on the H100 and how the design meets it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from e4t_diffusion_torch.ops import _build

SOURCE = "int8_conv"
# the kernel reads 16 channels (bytes) per load
CHANNEL_ALIGN = 16


def int8_conv_reference(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                        bias: Optional[torch.Tensor], out_dtype: torch.dtype,
                        stride: int, padding: int) -> torch.Tensor:
    """x (N, H, W, C) int8, w (O, kh, kw, C) int8, scale (O,) f32, bias (O,)
    or None -> (N, O, Ho, Wo) in ``out_dtype``:
    ``cast(float(acc) * scale) + cast(bias)``. The int32 sums are exact: a
    float64 convolution of int8 values is exact up to 2**53, far above the
    |sum| <= 127**2 * K of any UNet site."""
    acc = F.conv2d(x.permute(0, 3, 1, 2).double(),
                   w.permute(0, 3, 1, 2).double(), stride=stride,
                   padding=padding)
    y = (acc.float() * scale.float()[None, :, None, None]).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)[None, :, None, None]
    return y


def _check(x, w, scale, bias) -> None:
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError("x must be (N, H, W, C) and w (O, kh, kw, C)")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"x is {x.dtype} and w {w.dtype}; the kernel takes "
                        f"int8")
    if x.shape[3] != w.shape[3]:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if scale.shape != (w.shape[0],):
        raise ValueError(f"scale must be ({w.shape[0]},), got "
                         f"{tuple(scale.shape)}")
    if bias is not None and bias.shape != (w.shape[0],):
        raise ValueError(f"bias must be ({w.shape[0]},), got "
                         f"{tuple(bias.shape)}")
    tensors = [x, w, scale] + ([bias] if bias is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, w, scale and bias must be on one device")


def _check_kernel_inputs(x, w, scale, bias, out_dtype) -> None:
    """What the kernel takes, checked on CUDA tensors before a launch."""
    if x.shape[3] % CHANNEL_ALIGN != 0:
        raise ValueError(f"{x.shape[3]} channels: the kernel takes multiples "
                         f"of {CHANNEL_ALIGN}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"output {out_dtype}: the kernel writes bfloat16 or "
                        f"float32")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale is {scale.dtype}; the kernel takes float32")
    if bias is not None and bias.dtype != out_dtype:
        raise TypeError(f"bias is {bias.dtype}; the kernel takes the output "
                        f"type {out_dtype}")
    for name, t in (("x", x), ("w", w), ("scale", scale), ("bias", bias)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("x", x), ("w", w)):  # read in 16-byte chunks
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must be 16-byte aligned")


def int8_conv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor], out_dtype: torch.dtype,
              stride: int = 1, padding: int = 0) -> torch.Tensor:
    """int8 NHWC x OHWI convolution, rescaled -> NCHW ``out_dtype``
    (``int8_conv_reference`` gives the arithmetic).

    CUDA tensors: contiguous, 16-byte aligned, C a multiple of 16, bf16 or
    f32 out (bias in that type); launches the kernel on the current stream
    and counts it on ``int8_conv.launches``. CPU tensors: the plain
    version."""
    _check(x, w, scale, bias)
    if x.device.type == "cpu":
        return int8_conv_reference(x, w, scale, bias, out_dtype, stride,
                                   padding)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_kernel_inputs(x, w, scale, bias, out_dtype)
    n, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (wd + 2 * padding - kw) // stride + 1
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output for a {h}x{wd} input")
    out = torch.empty((n, o, ho, wo), dtype=out_dtype, device=x.device)
    _build.launch(SOURCE, "e4t_int8_conv",
                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12, x.device,
                  x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                  bias.data_ptr() if bias is not None else None,
                  out.data_ptr(), n, h, wd, c, o, kh, kw, stride, padding, ho,
                  wo, int(out_dtype == torch.bfloat16))
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
