"""Short-sequence self-attention forward: the CUDA kernel, its wrapper, its
plain version and the knob that routes to it.

``csrc/flash_fwd_shortseq.cu`` (nvcc for sm_90a, called through ctypes)
replaces the TPU kernel ``_flash_fwd_shortseq_mh`` of
``e4t_diffusion_tpu/ops/flash_kernels.py``: softmax attention over the
whole kv row in one pass (the row max first, no online rescaling), p
rounded to v's dtype before P@V, the division by the row sum after it.
``ops/attention.dot_product_attention`` sends the ViT-H's 257-token d=80
sites to it when ``E4T_SHORTSEQ_MH_ATTN`` is a positive integer (off by
default). The reference reads that knob once, at import; the port reads it
per call, so a phase or a test can set it.

The knob's value G is the TPU kernel's heads per grid cell; ``heads_per_cell``
picks g from it as the reference does. The CUDA kernels run one block per
head whatever g is (a grid of g-head cells would leave most of the card's
SMs idle), so g is checked and otherwise unused.

In bf16 the kernel is warpgroup MMA (wgmma) with the head's k in shared
memory: up to 272 tokens (the ViT-H's 257) the whole score row in
registers, above that two passes with v streamed. The synchronous mma.sync
design it replaced stays in the source as the yardstick:
``flash_fwd_shortseq_sync`` runs it, and ``chip_smoke.py`` and
``time_attn_small.py`` time and check the kernel against it; no path calls
it. f32 operands go to the single-pass f32 kernel of
``csrc/attention_f32.cu``.

``flash_fwd_shortseq`` launches the kernel of the operands' type for CUDA
tensors, raises on anything the kernels do not take, and counts its
launches apart (``flash_fwd_shortseq.launches["bf16"]`` and ``["f32"]``).
For CPU tensors it runs ``flash_fwd_shortseq_reference``, the plain PyTorch
version the tests hold against JAX and ``chip_smoke.py`` holds the kernels
against. Forward only:
``ops/attention.ShortSeqAttention`` differentiates through einsum
attention, as the reference's ``_shortseq_mh_bwd`` does.
"""
from __future__ import annotations

import ctypes
import os

import torch

from e4t_diffusion_torch.ops import _build
from e4t_diffusion_torch.ops.flash_lowdim import F32_SOURCE, check_operands

SOURCE = "flash_fwd_shortseq"
KNOB = "E4T_SHORTSEQ_MH_ATTN"
# what the kernel takes: the whole k of a head in shared memory
MAX_SEQ = 512
MAX_D = 128


def heads_knob() -> int:
    """``E4T_SHORTSEQ_MH_ATTN`` as an integer (0, the default, is off)."""
    return int(os.environ.get(KNOB, "0"))


def heads_per_cell(bh: int, heads: int) -> int:
    """The reference's heads per grid cell: the largest of (heads, 8, 4, 2,
    1) that is at most ``heads`` and divides ``bh``. ``heads <= 0`` (the
    knob off) raises."""
    if heads <= 0:
        raise ValueError(f"{KNOB}={heads}: short-sequence attention needs a "
                         f"positive number of heads per cell")
    return max(g for g in (heads, 8, 4, 2, 1) if g <= heads and bh % g == 0)


def flash_fwd_shortseq_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, scale: float
                                 ) -> torch.Tensor:
    """(BH, S, D) q/k/v -> out (BH, S, D) in q's dtype, as the kernel
    computes it: f32 scores, m the row max, p = exp(s - m), l the sum of
    the f32 p, acc = p rounded to v's dtype @ v in f32, out = acc *
    (1 / l)."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc * (1.0 / l)).to(q.dtype)


def _check(q, k, v, g) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be one (BH, S, D) shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    bh, s, _ = q.shape
    if s == 0 or bh == 0:
        raise ValueError(f"empty input {tuple(q.shape)}")
    if g <= 0 or bh % g:
        raise ValueError(f"{g} heads per cell do not divide BH={bh}")


def _check_kernel_inputs(q, k, v) -> torch.dtype:
    """What the kernels take, checked on CUDA tensors before a launch;
    returns the operands' one type."""
    bh, s, d = q.shape
    if not 0 < s <= MAX_SEQ:
        raise ValueError(f"sequence {s}: the kernel takes up to {MAX_SEQ}")
    if d % 8 != 0 or not 8 <= d <= MAX_D:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 up "
                         f"to {MAX_D}")
    if bh > 65535:
        raise ValueError(f"BH={bh} exceeds the kernel's grid (65535)")
    return check_operands(q=q, k=k, v=v)


def _launch(source, symbol, q, k, v, scale) -> torch.Tensor:
    bh, s, d = q.shape
    out = torch.empty_like(q)
    _build.launch(source, symbol,
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                  + [ctypes.c_float],
                  q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), bh, s, d, float(scale))
    return out


def flash_fwd_shortseq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, g: int) -> torch.Tensor:
    """Self-attention forward over (BH, S, D) q/k/v, ``g`` heads per cell
    (a divisor of BH) -> out (BH, S, D).

    CUDA tensors: contiguous bf16 or f32 (one type), S up to 512, D a
    multiple of 8 up to 128; launches the kernel of that type on the current
    stream and counts it on ``flash_fwd_shortseq.launches["bf16"]`` or
    ``["f32"]``. CPU tensors: the plain version."""
    _check(q, k, v, g)
    if q.device.type == "cpu":
        return flash_fwd_shortseq_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    f32 = _check_kernel_inputs(q, k, v) == torch.float32
    out = _launch(*((F32_SOURCE, "e4t_attn_fwd_shortseq_f32") if f32
                    else (SOURCE, "e4t_flash_fwd_shortseq")), q, k, v, scale)
    flash_fwd_shortseq.launches["f32" if f32 else "bf16"] += 1
    return out


flash_fwd_shortseq.launches = {"bf16": 0, "f32": 0}


def flash_fwd_shortseq_sync(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float, g: int
                            ) -> torch.Tensor:
    """The bf16 kernel by the synchronous mma.sync design
    (``e4t_flash_fwd_shortseq_sync``): the yardstick the kernel is timed and
    checked against. No path calls it, and it counts no launch. CUDA bf16
    tensors only, with the checks ``flash_fwd_shortseq`` runs."""
    _check(q, k, v, g)
    if q.device.type != "cuda":
        raise ValueError("flash_fwd_shortseq_sync runs on CUDA tensors only")
    if _check_kernel_inputs(q, k, v) != torch.bfloat16:
        raise TypeError("flash_fwd_shortseq_sync takes bf16 operands")
    return _launch(SOURCE, "e4t_flash_fwd_shortseq_sync", q, k, v, scale)
