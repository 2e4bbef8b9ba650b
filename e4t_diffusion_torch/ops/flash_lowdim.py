"""Flash-attention forward: the CUDA kernel, its wrapper and its plain
version.

One kernel source, ``csrc/flash_fwd_lowdim.cu`` (nvcc for sm_90a, called
through ctypes), replaces three TPU kernels of
``e4t_diffusion_tpu/ops/flash_kernels.py``, one wrapper ``flash_fwd`` for
head dims a multiple of 8 up to 256:

- below 128 it stands for ``_flash_fwd_lowdim``: the UNet's 4096-token
  d=40 and 1024-token d=80 sites and the ViT-H's 257-token d=80 sites;
- from 128 it stands for ``_flash_fwd_kvres`` and ``_flash_fwd``: the
  UNet's 256-token d=160 sites, which training sends to flash. The TPU's
  split between k/v resident in VMEM and a blocked grid has no
  counterpart: k/v stream through shared memory at any length.

In bf16 every head dim runs on one design, warpgroup MMA (wgmma) fed by a
cp.async k/v ring. The synchronous mma.sync design it replaced stays in the
source as the yardstick: ``flash_fwd_sync`` runs it at every head dim, and
``chip_smoke.py`` and ``time_flash_fwd.py`` time and check the kernel
against it; no path calls it.

f32 operands go to the f32 kernel of ``csrc/attention_f32.cu`` (SIMT FFMA
in full f32, register-blocked, any head dim the bf16 kernel takes), as the
TPU kernels write in q's dtype. The synchronous f32 design it replaced is
its yardstick, ``flash_fwd_f32_sync``, which no path calls either.

The wrapper launches the kernel for CUDA tensors, raises on anything the
kernels do not take, and counts its launches per TPU kernel it stands for
and per kernel it took (``flash_fwd.launches["lowdim"]``, ``["wide"]``,
``["lowdim_f32"]`` and ``["wide_f32"]``). For CPU tensors it runs
``flash_fwd_reference``, the plain PyTorch version the tests hold against
JAX and ``chip_smoke.py`` holds the kernels against. It records no
gradient: ``ops/attention.FlashAttention`` pairs it with the backward
kernel (``ops/flash_bwd.py``). The source notes give the bound on the H100
and how each design meets it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from e4t_diffusion_torch.ops import _build

SOURCE = "flash_fwd_lowdim"
# the f32 kernels of every attention wrapper, built in five parts that
# compile side by side: the flash forward, the backward, the short-sequence
# forward, the synchronous designs kept as yardsticks and the int8 "qk"
# forward
F32_SOURCE = "attention_f32"
F32_PARTS = F32_FWD, F32_BWD, F32_SHORT, F32_SYNC, F32_INT8 = tuple(
    f"{F32_SOURCE}@{part}" for part in range(1, 6))
# the floating types of the kernels' operands: the bf16 kernels and the f32
# ones of F32_PARTS
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# head dims (multiples of 8) the kernels take; from WIDE_MIN_D the forward
# stands for the TPU's d >= 128 kernels and counts apart
MAX_D = 256
WIDE_MIN_D = 128


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
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


def operand_dtype(**dtypes: torch.dtype) -> torch.dtype:
    """The one floating type of a kernel's operands (named by keyword):
    bfloat16 (the bf16 kernels) or float32 (``csrc/attention_f32.cu``).
    Raises TypeError on any other type and on mixed types, naming both
    types the kernels take."""
    kinds = set(dtypes.values())
    if len(kinds) > 1:
        raise TypeError(f"mixed operand types {dtypes}: the kernels take "
                        f"all bfloat16 or all float32")
    (dtype,) = kinds
    if dtype not in KERNEL_DTYPES:
        names = ", ".join(f"{k} {v}" for k, v in dtypes.items())
        raise TypeError(f"{names}: the kernels take bfloat16 or float32")
    return dtype


def check_operands(**tensors: torch.Tensor) -> torch.dtype:
    """What the port's attention kernels take: contiguous, 16-byte aligned
    tensors of one type, bfloat16 or float32 (``operand_dtype``), which it
    returns."""
    dtype = operand_dtype(**{k: t.dtype for k, t in tensors.items()})
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must be 16-byte aligned")
    return dtype


def _check_kernel_inputs(q, k, v, **more) -> torch.dtype:
    """The checks the forward and the backward kernels' wrappers run on
    CUDA tensors before a launch; returns the operands' one type."""
    bh, _, d = q.shape
    if d % 8 != 0 or not 8 <= d <= MAX_D:
        raise ValueError(f"head dim {d}: the kernels take multiples of 8 "
                         f"up to {MAX_D}")
    if bh > 65535:
        raise ValueError(f"BH={bh} exceeds the kernel's grid (65535)")
    return check_operands(q=q, k=k, v=v, **more)


def launch_route(d: int, dtype: torch.dtype = torch.bfloat16) -> str:
    """The key of ``flash_fwd.launches`` a head dim and operand type count
    on: "lowdim" (``_flash_fwd_lowdim``) or "wide" (``_flash_fwd_kvres``/
    ``_flash_fwd``), with "_f32" for the f32 kernel."""
    route = "lowdim" if d < WIDE_MIN_D else "wide"
    return route + "_f32" if dtype == torch.float32 else route


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-causal attention forward -> (out (BH, Sq, D), lse (BH, Sq) f32).

    CUDA tensors: contiguous bf16 or f32 (one type), D a multiple of 8 up
    to 256; launches the kernel of that type on the current stream and
    counts it on ``flash_fwd.launches[launch_route(D, dtype)]``. CPU
    tensors: the plain version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    dtype = _check_kernel_inputs(q, k, v)
    out, lse = _launch(*((F32_FWD, "e4t_attn_fwd_f32")
                         if dtype == torch.float32
                         else (SOURCE, "e4t_flash_fwd")), q, k, v, scale)
    flash_fwd.launches[launch_route(q.shape[2], dtype)] += 1
    return out, lse


flash_fwd.launches = {"lowdim": 0, "wide": 0, "lowdim_f32": 0, "wide_f32": 0}


def flash_fwd_sync(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 forward by the synchronous mma.sync design at every head
    dim (``e4t_flash_fwd_sync``): the yardstick the wgmma kernel is timed
    and checked against. No path calls it, and it counts no launch. CUDA
    bf16 tensors only, with the checks ``flash_fwd`` runs."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError("flash_fwd_sync runs on CUDA tensors only")
    if _check_kernel_inputs(q, k, v) != torch.bfloat16:
        raise TypeError("flash_fwd_sync takes bf16 operands")
    return _launch(SOURCE, "e4t_flash_fwd_sync", q, k, v, scale)


def flash_fwd_f32_sync(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 forward by the synchronous design the register-blocked
    kernel replaced (``e4t_attn_fwd_f32_sync``): its yardstick. No path
    calls it, and it counts no launch. CUDA f32 tensors only, with the
    checks ``flash_fwd`` runs."""
    _check(q, k, v)
    _require_f32_cuda("flash_fwd_f32_sync", q, k, v)
    _check_kernel_inputs(q, k, v)
    return _launch(F32_SYNC, "e4t_attn_fwd_f32_sync", q, k, v, scale)


def _require_f32_cuda(name: str, *tensors: torch.Tensor) -> None:
    """What an f32 yardstick takes before any other check: f32 operands
    (TypeError) on a CUDA device (ValueError); it has no plain version to
    run on the CPU."""
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} takes float32 operands")
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors only")


def _launch(source, symbol, q, k, v, scale):
    """One forward entry point of ``source`` on checked CUDA operands:
    (out in q's type, lse f32)."""
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _build.launch(source, symbol,
                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                  + [ctypes.c_float],
                  q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), lse.data_ptr(), bh, sq, k.shape[1], d,
                  float(scale))
    return out, lse
