"""Flash-attention backward: the CUDA kernel and its plain version.

Replaces the TPU kernels ``e4t_diffusion_tpu/ops/flash_kernels.py:
_flash_bwd_resident`` (dq with k/v resident, dk/dv with q/dO/lse/delta
resident) and ``_flash_bwd``'s blocked grids: the backward of every flash
site, which training runs (all-flash, ``ops/attention.flash_threshold(0)``).
The kernel is ``csrc/flash_bwd.cu``, built by nvcc for sm_90a and called
through ctypes: a dq kernel over q tiles and a dk/dv kernel over kv tiles,
no atomics, deterministic. Its source note gives the bound on the H100.

f32 operands go to the f32 backward of ``csrc/attention_f32.cu`` (a dq
kernel and a dk/dv kernel in full f32 on the CUDA cores).

``flash_bwd`` launches the kernels of the operands' type for CUDA tensors,
counts them apart (``flash_bwd.launches["bf16"]`` and ``["f32"]``) and
raises on anything they do not take; delta = rowsum(out * dO) is a plain
PyTorch reduction before the launch, as the TPU path leaves it to XLA. For
CPU tensors it runs ``flash_bwd_reference``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from e4t_diffusion_torch.ops import _build
from e4t_diffusion_torch.ops.flash_lowdim import (
    F32_SOURCE, _check, _check_kernel_inputs)

SOURCE = "flash_bwd"


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of non-causal attention, from the forward's (out, lse):
    p = exp(s - lse), delta = rowsum(out * dO), ds = p (dP - delta) scale;
    f32 arithmetic, p and ds rounded to the inputs' dtype before their
    products, as in the kernels."""
    f32 = torch.float32
    qf, kf, vf, dof = (t.to(f32) for t in (q, k, v, dout))
    s = torch.matmul(qf, kf.transpose(1, 2)) * scale
    p = torch.exp(s - lse.to(f32)[..., None])
    delta = (out.to(f32) * dof).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(1, 2)) - delta) * scale
    p, ds = p.to(v.dtype).to(f32), ds.to(q.dtype).to(f32)
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(1, 2), qf)
    dv = torch.matmul(p.transpose(1, 2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) for q/out/dout (BH, Sq, D), k/v (BH, Sk, D) and lse
    (BH, Sq) f32, the forward's log-sum-exp.

    CUDA tensors: contiguous bf16 or f32 (one type), D a multiple of 8 up
    to 256; launches the two kernels of that type on the current stream
    (``flash_bwd.launches["bf16"]`` or ``["f32"]`` counts the calls). CPU
    tensors: the plain version."""
    _check(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must match q {tuple(q.shape)}")
    if lse.shape != q.shape[:2]:
        raise ValueError(f"lse {tuple(lse.shape)} must be (BH, Sq) = "
                         f"{tuple(q.shape[:2])}")
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, out, lse, dout, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    dtype = _check_kernel_inputs(q, k, v, out=out, dout=dout)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("lse must be contiguous float32")
    delta = (out.float() * dout.float()).sum(-1)
    bh, sq, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    f32 = dtype == torch.float32
    _build.launch(F32_SOURCE if f32 else SOURCE,
                  "e4t_attn_bwd_f32" if f32 else "e4t_flash_bwd",
                  [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                  + [ctypes.c_float],
                  q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq,
                  k.shape[1], d, float(scale))
    flash_bwd.launches["f32" if f32 else "bf16"] += 1
    return dq, dk, dv


flash_bwd.launches = {"bf16": 0, "f32": 0}
