"""Flash-attention backward: the CUDA kernel and its plain version.

Replaces the TPU kernels ``e4t_diffusion_tpu/ops/flash_kernels.py:
_flash_bwd_resident`` (dq with k/v resident, dk/dv with q/dO/lse/delta
resident) and ``_flash_bwd``'s blocked grids: the backward of every flash
site, which training runs (all-flash, ``ops/attention.flash_threshold(0)``).
The kernel is ``csrc/flash_bwd.cu``, built by nvcc for sm_90a and called
through ctypes: a dq kernel over q tiles and a dk/dv kernel over kv tiles,
no atomics, so two calls on the same inputs agree bit for bit. Both run
on warpgroup MMA (wgmma) fed by cp.async rings at every d (from d = 128 the
dk/dv kernel gives each of a pair of warpgroups one of dk and dv). The
synchronous mma.sync design they replaced stays as the yardstick:
``flash_bwd_sync`` runs it at every d, and ``chip_smoke.py`` and
``time_flash_bwd.py`` time and check the kernels against it (the forward's
is ``ops/flash_lowdim.flash_fwd_sync``). The source note gives the design
and the bound on the H100: the function needs 10 flops per score and head
dim and one exponential per score; the dq and dk/dv kernels each compute S
and dP (14 flops, two exponentials).

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
    _check_shapes(q, k, v, out, lse, dout)
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, out, lse, dout, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    f32 = _check_kernel_operands(q, k, v, out, lse, dout) == torch.float32
    grads = _launch(F32_SOURCE if f32 else SOURCE,
                    "e4t_attn_bwd_f32" if f32 else "e4t_flash_bwd",
                    q, k, v, out, lse, dout, scale)
    flash_bwd.launches["f32" if f32 else "bf16"] += 1
    return grads


flash_bwd.launches = {"bf16": 0, "f32": 0}


def flash_bwd_sync(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 backward by the synchronous mma.sync design at every head
    dim (``e4t_flash_bwd_sync``): the yardstick the wgmma kernels are timed
    and checked against. No path calls it, and it counts no launch. CUDA
    bf16 tensors only, as ``flash_bwd`` takes them."""
    _check_shapes(q, k, v, out, lse, dout)
    if q.device.type != "cuda":
        raise ValueError("flash_bwd_sync runs on CUDA tensors only")
    if _check_kernel_operands(q, k, v, out, lse, dout) != torch.bfloat16:
        raise TypeError("flash_bwd_sync takes bf16 operands")
    return _launch(SOURCE, "e4t_flash_bwd_sync", q, k, v, out, lse, dout,
                   scale)


def _check_shapes(q, k, v, out, lse, dout) -> None:
    _check(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must match q {tuple(q.shape)}")
    if lse.shape != q.shape[:2]:
        raise ValueError(f"lse {tuple(lse.shape)} must be (BH, Sq) = "
                         f"{tuple(q.shape[:2])}")


def _check_kernel_operands(q, k, v, out, lse, dout) -> torch.dtype:
    """The checks before a launch on CUDA tensors; returns the operands'
    one type."""
    dtype = _check_kernel_inputs(q, k, v, out=out, dout=dout)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("lse must be contiguous float32")
    return dtype


def _launch(source, symbol, q, k, v, out, lse, dout, scale):
    """delta = rowsum(out * dO) in PyTorch, then one entry point of
    ``source``: (dq, dk, dv) in the operands' type."""
    delta = (out.float() * dout.float()).sum(-1)
    bh, sq, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _build.launch(source, symbol,
                  [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                  + [ctypes.c_float],
                  q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq,
                  k.shape[1], d, float(scale))
    return dq, dk, dv
