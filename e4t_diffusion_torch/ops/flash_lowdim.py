"""Low-head-dim flash-attention forward: the CUDA kernel and its plain version.

Replaces the TPU kernel ``e4t_diffusion_tpu/ops/flash_kernels.py:
_flash_fwd_lowdim`` (the UNet's 4096-token d=40 and 1024-token d=80
self-attention sites). The kernel is ``csrc/flash_fwd_lowdim.cu``, built
by nvcc for sm_90a and called through ctypes; its source note gives the
bound on the H100 (the exp2 rate of the special-function units, not memory)
and how the design meets it.

``flash_fwd_lowdim`` launches the kernel for CUDA tensors and raises on
anything it does not take. For CPU tensors it runs
``flash_fwd_lowdim_reference``, the plain PyTorch version the tests hold
against JAX and ``chip_smoke.py`` holds the kernel against.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from e4t_diffusion_torch.ops import _build

SOURCE = "flash_fwd_lowdim"


def flash_fwd_lowdim_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, scale: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, Sq, D) q, (BH, Sk, D) k/v -> (out (BH, Sq, D) in q's dtype,
    lse (BH, Sq) f32). f32 scores and softmax; p rounded to v's dtype
    before P@V (normalised here, before the division by l in the
    kernel)."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def _check(q, k, v) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (BH, S, D)")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")


def _check_kernel_inputs(q, k, v) -> None:
    bh, _, d = q.shape
    if d % 8 != 0 or d >= 128:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 "
                         f"below 128")
    if bh > 65535:
        raise ValueError(f"BH={bh} exceeds the kernel's grid (65535)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must be 16-byte aligned")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                "the low-dim flash kernel is forward-only; its backward "
                "comes with the training port")


def _kernel():
    lib = _build.load_library(SOURCE)
    fn = lib.e4t_flash_fwd_lowdim
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.e4t_cuda_error_string.argtypes = [ctypes.c_int]
        lib.e4t_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def flash_fwd_lowdim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-causal attention forward -> (out (BH, Sq, D), lse (BH, Sq) f32).

    CUDA tensors: contiguous bf16, D a multiple of 8 below 128; launches
    the kernel on the current stream (``flash_fwd_lowdim.launches`` counts
    the launches). CPU tensors: the plain version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_lowdim_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_kernel_inputs(q, k, v)
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    lib, fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), bh, sq, k.shape[1], d, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd_lowdim launch failed: "
                           f"{lib.e4t_cuda_error_string(rc).decode()}")
    flash_fwd_lowdim.launches += 1
    return out, lse


flash_fwd_lowdim.launches = 0
