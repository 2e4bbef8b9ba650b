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

The wrapper launches the kernel for CUDA tensors, raises on anything the
kernel does not take, and counts its launches per TPU kernel it stands for
(``flash_fwd.launches["lowdim"]`` and ``["wide"]``). For CPU tensors it
runs ``flash_fwd_reference``, the plain PyTorch version the tests hold
against JAX and ``chip_smoke.py`` holds the kernel against. It records no
gradient: ``ops/attention.FlashAttention`` pairs it with the backward
kernel (``ops/flash_bwd.py``). The source note gives the bound on the H100
and how the design meets it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from e4t_diffusion_torch.ops import _build

SOURCE = "flash_fwd_lowdim"
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


def check_bf16_operands(**tensors: torch.Tensor) -> None:
    """What the port's flash kernels take: contiguous, 16-byte aligned
    bf16 tensors."""
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_kernel_inputs(q, k, v) -> None:
    """The checks the forward and the backward kernels' wrappers run on
    CUDA tensors before a launch."""
    bh, _, d = q.shape
    if d % 8 != 0 or not 8 <= d <= MAX_D:
        raise ValueError(f"head dim {d}: the kernels take multiples of 8 "
                         f"up to {MAX_D}")
    if bh > 65535:
        raise ValueError(f"BH={bh} exceeds the kernel's grid (65535)")
    check_bf16_operands(q=q, k=k, v=v)


def launch_route(d: int) -> str:
    """The key of ``flash_fwd.launches`` a head dim counts on: "lowdim"
    (``_flash_fwd_lowdim``) or "wide" (``_flash_fwd_kvres``/``_flash_fwd``)."""
    return "lowdim" if d < WIDE_MIN_D else "wide"


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-causal attention forward -> (out (BH, Sq, D), lse (BH, Sq) f32).

    CUDA tensors: contiguous bf16, D a multiple of 8 up to 256; launches
    the kernel on the current stream and counts it on
    ``flash_fwd.launches[launch_route(D)]``. CPU tensors: the plain
    version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_kernel_inputs(q, k, v)
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _build.launch(SOURCE, "e4t_flash_fwd",
                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                  + [ctypes.c_float],
                  q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), lse.data_ptr(), bh, sq, k.shape[1], d,
                  float(scale))
    flash_fwd.launches[launch_route(d)] += 1
    return out, lse


flash_fwd.launches = {"lowdim": 0, "wide": 0}
