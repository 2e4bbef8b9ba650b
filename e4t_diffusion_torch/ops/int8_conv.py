"""int8 convolution: the CUDA kernel, its wrappers and their plain versions.

``csrc/int8_conv.cu`` (nvcc for sm_90a, called through ctypes) is an
implicit-GEMM int8 convolution on s8 wgmma. It stands for the XLA
convolution of ``e4t_diffusion_tpu/ops/quant.py:276-283`` (``int8_conv``),
which has no PyTorch counterpart on CUDA. Every quantized UNet convolution
goes to it, the 1x1 ones included (one route for every conv site), through
``int8_conv_act``: the UNet's bf16 / f32 NCHW activation goes in and is
quantized in the kernel's loads, so no int8 copy, permute or padding pass of
it is made. ``int8_conv`` takes an int8 NHWC activation instead.

Each wrapper launches the kernel for CUDA tensors, raises on anything the
kernel does not take, and counts its launches (``int8_conv.launches``,
``int8_conv_act.launches``). For CPU tensors it runs its plain version
(``int8_conv_reference``, ``int8_conv_act_reference``), which the tests hold
against JAX and ``chip_smoke.py`` holds the kernel against. ``int8_conv_sync``
is the synchronous design the kernel replaced, kept as its yardstick. The
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
# the kernel's tile: 128 output pixels by 160 output channels, over chunks
# of 64 input channels, which up to 8 blocks share where the tiles are too
# few for the card (exact int32 partial sums in a workspace)
TILE_M, TILE_N, CHUNK, MAX_SPLITS = 128, 160, 64, 8


def quantize_values(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 of ``x`` by the scale ``s`` (broadcast against x):
    ``clamp(round(float(x) / s), -127, 127)``, rounding half to even. The
    plain arithmetic of the activation quantization, which the kernels
    repeat (the IEEE quotient, no reciprocal)."""
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


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


def _out_size(h, w, kh, kw, stride, padding):
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output for a {h}x{w} input")
    return ho, wo


def splits_for(n: int, ho: int, wo: int, o: int, c: int,
               device: torch.device) -> int:
    """Into how many parts the kernel splits the channel chunks: 1 where its
    128 x 160 output tiles fill the card's SMs, else about two blocks an SM
    (the kernel holds two) in all, at most 8 parts and one a chunk."""
    blocks = -(-n * ho * wo // TILE_M) * -(-o // TILE_N)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if blocks >= sms:
        return 1
    return max(1, min(MAX_SPLITS, -(-c // CHUNK), round(2 * sms / blocks)))


def _split_args(n, ho, wo, o, c, device):
    """(workspace pointer, splits, workspace): a zeroed int32
    (n * ho * wo, o) workspace where the kernel splits, else none."""
    splits = splits_for(n, ho, wo, o, c, device)
    if splits == 1:
        return None, 1, None
    ws = torch.zeros((n * ho * wo, o), dtype=torch.int32, device=device)
    return ws.data_ptr(), splits, ws


def _launch(symbol: str, x, w, scale, bias, out_dtype, stride, padding,
            split: bool) -> torch.Tensor:
    """Check the CUDA operands, allocate the NCHW output and launch the
    entry point ``symbol`` of ``csrc/int8_conv.cu`` on it (with a split
    workspace where ``split``)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_kernel_inputs(x, w, scale, bias, out_dtype)
    n, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    ho, wo = _out_size(h, wd, kh, kw, stride, padding)
    out = torch.empty((n, o, ho, wo), dtype=out_dtype, device=x.device)
    args = [x.data_ptr(), w.data_ptr(), scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(), n,
            h, wd, c, o, kh, kw, stride, padding, ho, wo,
            int(out_dtype == torch.bfloat16)]
    types = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
    if split:
        ws_ptr, splits, ws = _split_args(n, ho, wo, o, c, x.device)
        args += [ws_ptr, splits]
        types += [ctypes.c_void_p, ctypes.c_int]
    _build.launch(SOURCE, symbol, types, x.device, *args)
    return out


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
    out = _launch("e4t_int8_conv", x, w, scale, bias, out_dtype, stride,
                  padding, split=True)
    int8_conv.launches += 1
    return out


int8_conv.launches = 0


def int8_conv_sync(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor], out_dtype: torch.dtype,
                   stride: int = 1, padding: int = 0) -> torch.Tensor:
    """The synchronous mma.sync design the kernel replaced
    (``int8_conv_sync_kernel``), with ``int8_conv``'s contract and output,
    on CUDA tensors only: the yardstick ``chip_smoke.py`` holds the kernel
    against, bit for bit, and times beside it. No path calls it and it
    counts no launch."""
    _check(x, w, scale, bias)
    return _launch("e4t_int8_conv_sync", x, w, scale, bias, out_dtype, stride,
                   padding, split=False)


def int8_conv_act_reference(x: torch.Tensor, w: torch.Tensor,
                            act_scale: torch.Tensor, per_channel: bool,
                            scale: torch.Tensor, bias: Optional[torch.Tensor],
                            stride: int, padding: int) -> torch.Tensor:
    """The plain version of ``int8_conv_act``: x quantized by
    ``quantize_values`` (per input channel by ``act_scale`` (C,) where
    ``per_channel``, else by the one value of ``act_scale``), permuted to
    NHWC, its channels zero-padded to w's, then ``int8_conv_reference`` with
    the rescale ``scale`` (per channel) or ``act_scale * scale`` (per
    tensor), out in x's type."""
    s = act_scale.reshape(1, -1, 1, 1) if per_channel else act_scale.reshape(())
    xq = quantize_values(x, s).permute(0, 2, 3, 1)
    pad = w.shape[3] - xq.shape[3]
    if pad:
        xq = F.pad(xq, (0, pad))
    sx = torch.ones((), device=x.device) if per_channel else act_scale.reshape(())
    return int8_conv_reference(xq, w, (sx * scale).float(), bias, x.dtype,
                               stride, padding)


def int8_conv_act(x: torch.Tensor, w: torch.Tensor, act_scale: torch.Tensor,
                  per_channel: bool, scale: torch.Tensor,
                  bias: Optional[torch.Tensor], stride: int = 1,
                  padding: int = 0) -> torch.Tensor:
    """int8 convolution of a bf16 / f32 (N, C, H, W) activation, quantized in
    the kernel's loads -> (N, O, Ho, Wo) in x's type
    (``int8_conv_act_reference`` gives the arithmetic).

    w (O, kh, kw, Cw) int8 with Cw >= C (channels C.. zero); ``act_scale``
    f32: (C,) where ``per_channel`` (its magnitude folded into w, so the
    rescale is ``scale``), else one value (static or dynamic; the rescale
    is ``act_scale * scale``); ``scale`` (O,) f32, the weight's; bias (O,)
    in x's type or None. CUDA tensors: x NCHW-contiguous or channels-last
    (anything else is made contiguous), Cw a multiple of 16 and w
    contiguous; launches the kernel on the current stream and counts it on
    ``int8_conv_act.launches``. CPU tensors: the plain version."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError("x must be (N, C, H, W) and w (O, kh, kw, C)")
    if w.dtype != torch.int8:
        raise TypeError(f"w is {w.dtype}; the kernel takes int8")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x is {x.dtype}; the kernel takes bfloat16 or "
                        f"float32")
    if w.shape[3] < x.shape[1]:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    want = (x.shape[1],) if per_channel else (1,)
    if act_scale.numel() != want[0] or (per_channel
                                        and act_scale.shape != want):
        raise ValueError(f"act_scale must hold {want[0]} value(s), got "
                         f"{tuple(act_scale.shape)}")
    if scale.shape != (w.shape[0],):
        raise ValueError(f"scale must be ({w.shape[0]},), got "
                         f"{tuple(scale.shape)}")
    if bias is not None and bias.shape != (w.shape[0],):
        raise ValueError(f"bias must be ({w.shape[0]},), got "
                         f"{tuple(bias.shape)}")
    tensors = [x, w, act_scale, scale] + ([bias] if bias is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, w, act_scale, scale and bias must be on one "
                         "device")
    if x.device.type == "cpu":
        return int8_conv_act_reference(x, w, act_scale, per_channel, scale,
                                       bias, stride, padding)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if w.shape[3] % CHANNEL_ALIGN != 0:
        raise ValueError(f"w has {w.shape[3]} channels: the kernel takes "
                         f"multiples of {CHANNEL_ALIGN}")
    for name, t in (("act_scale", act_scale), ("scale", scale)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
    if bias is not None and bias.dtype != x.dtype:
        raise TypeError(f"bias is {bias.dtype}; the kernel takes x's type "
                        f"{x.dtype}")
    for name, t in (("w", w), ("act_scale", act_scale), ("scale", scale),
                    ("bias", bias)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nhwc = (not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))
    if not (nhwc or x.is_contiguous()) or x.data_ptr() % 16:
        x = x.contiguous()
    if w.data_ptr() % 16 != 0:
        raise ValueError("w must be 16-byte aligned")
    n, c, h, wd = x.shape
    o, kh, kw, cw = w.shape
    ho, wo = _out_size(h, wd, kh, kw, stride, padding)
    out = torch.empty((n, o, ho, wo), dtype=x.dtype, device=x.device)
    ws_ptr, splits, ws = _split_args(n, ho, wo, o, c, x.device)
    _build.launch(SOURCE, "e4t_int8_conv_act",
                  [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p] + [ctypes.c_int] * 11
                  + [ctypes.c_void_p, ctypes.c_int], x.device,
                  x.data_ptr(), int(x.dtype == torch.float32), int(nhwc),
                  w.data_ptr(), cw, scale.data_ptr(), act_scale.data_ptr(),
                  int(per_channel),
                  bias.data_ptr() if bias is not None else None,
                  out.data_ptr(), n, h, wd, c, o, kh, kw, stride, padding, ho,
                  wo, ws_ptr, splits)
    int8_conv_act.launches += 1
    return out


int8_conv_act.launches = 0
