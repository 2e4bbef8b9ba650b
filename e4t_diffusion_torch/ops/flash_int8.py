"""int8 flash-attention forward: the CUDA kernel, its wrapper and its plain
version.

``csrc/flash_fwd_int8.cu`` (nvcc for sm_90a, called through ctypes)
replaces the TPU kernel ``_flash_fwd_lowdim_int8`` of
``e4t_diffusion_tpu/ops/flash_kernels.py``: int8 QK^T with per-head scales,
an online f32 softmax, and P@V in bf16 (mode "qk") or in int8 with p scaled
by 127 (mode "qkpv"), the output in bf16. For an f32 compute type, as the
reference writes in q's dtype and keeps v in it: "qk" with an f32 v runs
the f32 kernel of ``csrc/attention_f32.cu`` (exact int32 scores, P@V in
f32), "qkpv" the same int8 kernel with an f32 epilogue. The quantization of
q, k and v stays in plain PyTorch (``ops/attention._int8_lowdim_path``), as
the JAX package leaves it to XLA. Forward only: serving runs it under
``attention.int8_flash_attention``.

In "qkpv" mode p is quantized against the running max of the kv tiles seen
so far, so the result depends on the tile: the route passes the
reference's, ``quant_tile(Sk)`` = min(``E4T_FLASH_BLOCK_K`` (read per call,
512 by default), round_up(Sk, 128)). The kernel is warpgroup MMA (wgmma)
with s8 products; the synchronous mma.sync design it replaced stays in the
source as the yardstick: ``flash_fwd_int8_sync`` runs it (both modes, and
"qkpv" with an f32 output), and ``chip_smoke.py`` and
``time_attn_small.py`` time and check the kernel against it; no path calls
it.

``flash_fwd_int8`` launches the kernel for CUDA tensors, raises on anything
the kernels do not take, and counts its launches by the kernel it took
(``flash_fwd_int8.launches["bf16"]``, ``["qk_f32"]`` and ``["qkpv_f32"]``).
For CPU tensors it runs ``flash_fwd_int8_reference`` at the same kv
tile, the plain PyTorch version the tests hold against JAX and
``chip_smoke.py`` holds the kernels against. The source notes give the
bound on the H100 and how each design meets it.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from e4t_diffusion_torch.ops import _build
from e4t_diffusion_torch.ops.flash_lowdim import F32_SOURCE, KERNEL_DTYPES

SOURCE = "flash_fwd_int8"
MODES = ("qk", "qkpv")
# kv rows per sub-tile in the kernels; the quant tile is a multiple of it
KERNEL_BLOCK_K = 64
# The kv tile of the int8 route: in "qkpv" mode p is quantized against the
# running max of the tiles seen so far, so the result depends on it. The
# reference's tile is min(E4T_FLASH_BLOCK_K, round_up(Sk, 128))
# (e4t_diffusion_tpu/ops/attention.py:93,181-188), the knob 512 by default;
# the port reads the knob per call.
BLOCK_K_KNOB = "E4T_FLASH_BLOCK_K"
DEFAULT_BLOCK_K = 512
# head dims (multiples of 8) the kernel takes: the low-dim route
MAX_D = 120
_NEG_INF = -1e30


def block_k_knob() -> int:
    """``E4T_FLASH_BLOCK_K``, read per call (512 when unset): a positive
    multiple of ``KERNEL_BLOCK_K``, else a ValueError naming the knob."""
    raw = os.environ.get(BLOCK_K_KNOB, str(DEFAULT_BLOCK_K))
    try:
        value = int(raw)
    except ValueError:
        value = 0
    if value <= 0 or value % KERNEL_BLOCK_K:
        raise ValueError(f"{BLOCK_K_KNOB}={raw!r}: the int8 attention's kv "
                         f"tile must be a positive multiple of "
                         f"{KERNEL_BLOCK_K}")
    return value


def quant_tile(sk: int) -> int:
    """The route's kv tile for Sk kv rows, the reference's rule:
    min(E4T_FLASH_BLOCK_K, round_up(Sk, 128))."""
    return min(block_k_knob(), (sk + 127) // 128 * 128)


def flash_fwd_int8_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, sc: torch.Tensor, mode: str,
                             out_dtype: torch.dtype,
                             block_k: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's loop (flash_kernels.py:760-810) over kv tiles of
    ``block_k`` rows (``quant_tile(Sk)`` by default): q (BH, Sq, D) and k
    (BH, Sk, D) int8, v int8 ("qkpv") or the compute type ("qk"), sc (BH,
    2) f32 -> (out (BH, Sq, D) in
    ``out_dtype``, lse (BH, Sq) f32). Scores are the exact int32 q k^T times
    ``sc[:, 0]``; p = exp(s - running max); l sums the f32 p; P@V adds
    ``round(p * 127) @ v`` in int32 ("qkpv") or p rounded to v's type times
    v ("qk"); out = acc / l * ``sc[:, 1]``."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    bh, sq, _ = q.shape
    sk = k.shape[1]
    if block_k is None:
        block_k = quant_tile(sk)
    qk_c = sc[:, 0].float()[:, None, None]
    v_c = sc[:, 1].float()[:, None, None]
    # int8 products in float64 are exact (|sum| <= 127**2 * D)
    q64 = q.double()
    m = torch.full((bh, sq, 1), _NEG_INF, device=q.device)
    l = torch.zeros((bh, sq, 1), device=q.device)
    acc = torch.zeros((bh, sq, v.shape[2]), device=q.device)
    for off in range(0, sk, block_k):
        kb = k[:, off:off + block_k]
        vb = v[:, off:off + block_k]
        s = torch.matmul(q64, kb.double().transpose(1, 2)).float() * qk_c
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        if mode == "qkpv":
            contrib = torch.matmul(torch.round(p * 127.0).double(),
                                   vb.double()).float()
        else:
            contrib = torch.matmul(p.to(vb.dtype).float(), vb.float())
        acc = acc * alpha + contrib
        m = m_next
    inv = torch.where(l > 0.0, 1.0 / l, torch.zeros_like(l))
    out = (acc * (inv * v_c)).to(out_dtype)
    lse = (m + torch.log(torch.clamp(l, min=1e-37)))[..., 0]
    return out, lse


def _check(q, k, v, sc, mode) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (BH, S, D)")
    if (k.shape != v.shape or q.shape[0] != k.shape[0]
            or q.shape[2] != k.shape[2]):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if sc.shape != (q.shape[0], 2):
        raise ValueError(f"sc must be ({q.shape[0]}, 2), got "
                         f"{tuple(sc.shape)}")
    if not (q.device == k.device == v.device == sc.device):
        raise ValueError("q, k, v, sc must be on one device")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")


def launch_key(mode: str, out_dtype: torch.dtype) -> str:
    """The key of ``flash_fwd_int8.launches`` a call counts on: "bf16" for
    the bf16 output (``csrc/flash_fwd_int8.cu``, both modes), "qk_f32"
    (``csrc/attention_f32.cu``) and "qkpv_f32" (``flash_fwd_int8.cu``'s f32
    epilogue) for an f32 output."""
    return "bf16" if out_dtype == torch.bfloat16 else f"{mode}_f32"


def _check_kernel_inputs(q, k, v, sc, mode, out_dtype) -> None:
    """What the kernels take, checked on CUDA tensors before a launch: the
    output in bf16 or f32 and, in "qk" mode, v in the output's type."""
    bh, _, d = q.shape
    if d % 8 != 0 or not 8 <= d <= MAX_D:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 up "
                         f"to {MAX_D}")
    if bh > 65535:
        raise ValueError(f"BH={bh} exceeds the kernel's grid (65535)")
    if out_dtype not in KERNEL_DTYPES:
        raise TypeError(f"output {out_dtype}: the kernels write bfloat16 or "
                        f"float32")
    v_dtype = torch.int8 if mode == "qkpv" else out_dtype
    for name, t, want in (("q", q, torch.int8), ("k", k, torch.int8),
                          ("v", v, v_dtype), ("sc", sc, torch.float32)):
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes {want} "
                            f"in mode {mode!r}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_fwd_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sc: torch.Tensor, mode: str, out_dtype: torch.dtype,
                   block_k: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-causal int8 attention forward over kv tiles of ``block_k`` rows
    (``quant_tile(Sk)`` by default, a multiple of ``KERNEL_BLOCK_K``) ->
    (out (BH, Sq, D) in ``out_dtype``, lse (BH, Sq) f32);
    ``flash_fwd_int8_reference`` gives the arithmetic.

    CUDA tensors: contiguous, 16-byte aligned int8 q/k, v int8 ("qkpv") or
    in ``out_dtype`` ("qk"), f32 sc, D a multiple of 8 up to 120, out in
    bf16 or f32; launches the kernel on the current stream and counts it on
    ``flash_fwd_int8.launches[launch_key(mode, out_dtype)]``. CPU tensors:
    the plain version at the same tile."""
    _check(q, k, v, sc, mode)
    block_k = _tile(k, block_k)
    if q.device.type == "cpu":
        return flash_fwd_int8_reference(q, k, v, sc, mode, out_dtype,
                                        block_k)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_kernel_inputs(q, k, v, sc, mode, out_dtype)
    key = launch_key(mode, out_dtype)
    if key == "qk_f32":
        out, lse = _launch(F32_SOURCE, "e4t_attn_fwd_int8_qk_f32", q, k, v, sc,
                           out_dtype)
    else:
        out, lse = _launch(SOURCE, "e4t_flash_fwd_int8", q, k, v, sc,
                           out_dtype, int(mode == "qkpv"),
                           int(key == "qkpv_f32"), block_k)
    flash_fwd_int8.launches[key] += 1
    return out, lse


flash_fwd_int8.launches = {"bf16": 0, "qk_f32": 0, "qkpv_f32": 0}


def flash_fwd_int8_sync(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sc: torch.Tensor, mode: str, out_dtype: torch.dtype,
                        block_k: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 kernels by their synchronous designs, the yardsticks they
    are timed and checked against: the mma.sync design
    (``e4t_flash_fwd_int8_sync``) for the bf16 output in both modes and the
    f32 output in "qkpv"; for "qk" with an f32 output, the first f32 design
    (``e4t_attn_fwd_int8_qk_f32_sync``: a 4 x 4 score block a thread from
    scalar shared loads). No path calls it, and it counts no launch. CUDA
    tensors only, with the checks ``flash_fwd_int8`` runs."""
    _check(q, k, v, sc, mode)
    block_k = _tile(k, block_k)
    if q.device.type != "cuda":
        raise ValueError("flash_fwd_int8_sync runs on CUDA tensors only")
    _check_kernel_inputs(q, k, v, sc, mode, out_dtype)
    key = launch_key(mode, out_dtype)
    if key == "qk_f32":
        return _launch(F32_SOURCE, "e4t_attn_fwd_int8_qk_f32_sync", q, k, v,
                       sc, out_dtype)
    return _launch(SOURCE, "e4t_flash_fwd_int8_sync", q, k, v, sc, out_dtype,
                   int(mode == "qkpv"), int(key == "qkpv_f32"), block_k)


def _tile(k, block_k):
    """``block_k``, or the route's tile for k's Sk; a tile that is not a
    positive multiple of ``KERNEL_BLOCK_K`` raises."""
    if block_k is None:
        return quant_tile(k.shape[1])
    if block_k <= 0 or block_k % KERNEL_BLOCK_K:
        raise ValueError(f"kv tile {block_k}: a positive multiple of "
                         f"{KERNEL_BLOCK_K}")
    return block_k


def _launch(source, symbol, q, k, v, sc, out_dtype, *flags):
    """One int8 forward entry point of ``source`` on checked CUDA operands:
    (out in ``out_dtype``, lse f32)."""
    bh, sq, d = q.shape
    out = torch.empty((bh, sq, d), dtype=out_dtype, device=q.device)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    _build.launch(source, symbol,
                  [ctypes.c_void_p] * 6 + [ctypes.c_int] * (4 + len(flags)),
                  q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  sc.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, sq,
                  k.shape[1], d, *flags)
    return out, lse
