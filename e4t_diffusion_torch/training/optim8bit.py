"""Block-quantized 8-bit AdamW (``--use_8bit_adam``).

Counterpart of ``e4t_diffusion_tpu/training/optim8bit.py``, the stand-in
for bitsandbytes' AdamW8bit that the reference offers to fit training in
less memory: both Adam moments are stored as int8 codes with one f32 absmax
scale per 256-element block (2.03 bytes a parameter for the two, against 8
in f32), dequantized and requantized inside every update. The codebooks are
logarithmic, spanning ``_DECADES`` decades below the block's absmax: mu's
codes are signed (1..127 with the sign; 0 is zero), nu's unsigned (1..255,
stored as c - 128; -128 is zero).

``AdamW8bit`` is a ``torch.optim.Optimizer`` with the JAX chain's defaults
and order: the moments' update, the bias corrections ``1 - b ** count``
computed in f32, then decoupled decay as optax applies it,
p <- p + (-lr) * (step + wd * p). For CUDA tensors every update of a
parameter group is one launch of the hand-written kernel of
``csrc/adam8bit.cu`` (``ops/adam8bit.py``); the plain version here serves
the CPU, the tests and the kernel's checks. It runs in chunks of
``_CHUNK_BLOCKS`` blocks, as the JAX update does, so its f32 temporaries
stay bounded.

Numerics of the plain version: each step is one f32 operation with one
rounding, divisions by tensors (a 0-dim tensor on the data's device where
the divisor is a constant, which PyTorch's CUDA division would otherwise
turn into a multiply by the reciprocal), so the CPU and the card compute
the same function, and the kernel repeats it operation by operation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

import torch
import torch.nn.functional as F

DEFAULT_BLOCK = 256
# blocks per chunk of the plain update: 4096 * 256 elements, 4 MB of f32
# temporaries an operation
_CHUNK_BLOCKS = 4096
_DECADES = 7.0
STATE_KEYS = ("mu_q", "mu_scale", "nu_q", "nu_scale")
_CODE_KEYS = ("mu_q", "nu_q")


@dataclasses.dataclass(frozen=True)
class Adam8bitHyper:
    """One update's scalars: the learning rate, betas, eps, the decay, the
    f32 bias corrections 1 - b ** count, and whether the step is rounded
    to bf16 before the decay (the JAX step casts it to the gradient's
    dtype, bf16 under ``grads_bf16``)."""
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    b1c: float
    b2c: float
    step_bf16: bool = False


def bias_correction(beta: float, count: int) -> float:
    """1 - beta ** count in f32, as the JAX update computes it."""
    b = torch.tensor(beta, dtype=torch.float32)
    return float(1 - b ** torch.tensor(float(count), dtype=torch.float32))


def codebook(signed: bool, device) -> torch.Tensor:
    """The value of each code before the scale, indexed by code + 128 (256
    f32, on ``device``): signed, sign(q) 10^(7 (|q| - 127) / 126);
    unsigned, with c = q + 128, 10^(7 (c - 255) / 254); code value 0 is 0.
    The JAX package's ``_dq_blocks`` formula, computed in f32 on the CPU,
    so every device dequantizes to the same values."""
    q = torch.arange(-128, 128, dtype=torch.float32)
    if signed:
        c = torch.abs(q)
        val = torch.sign(q) * torch.pow(10.0, _DECADES * (c - 127.0) / 126.0)
    else:
        c = q + 128.0
        val = torch.pow(10.0, _DECADES * (c - 255.0) / 254.0)
    return torch.where(c > 0, val, torch.zeros_like(val)).to(device)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim f32 tensor on ``like``'s device: a divisor
    PyTorch divides by on every device (a Python number is turned into a
    multiply by its reciprocal on CUDA)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _pad_len(n: int, block: int) -> int:
    return (n + block - 1) // block * block


def _q_blocks(flat2d: torch.Tensor, signed: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, block) f32 -> (int8 codes (m, block), f32 scales (m,))."""
    a = flat2d.abs()
    absmax = a.amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    mag = a / scale
    logm = torch.log10(torch.clamp(mag, min=1e-30)) / _scalar(_DECADES,
                                                               flat2d)
    if signed:
        c = torch.round(torch.clamp(logm * 126.0 + 127.0, 0.0, 127.0))
        c = torch.where(mag > 0, torch.clamp(c, min=1.0),
                        torch.zeros_like(c))
        q = torch.where(flat2d < 0, -c, c)
    else:
        c = torch.round(torch.clamp(logm * 254.0 + 255.0, 0.0, 255.0))
        c = torch.where(mag > 0, torch.clamp(c, min=1.0),
                        torch.zeros_like(c))
        q = c - 128.0
    return q.to(torch.int8), scale.squeeze(1)


def _dq_blocks(q: torch.Tensor, scale: torch.Tensor,
               signed: bool) -> torch.Tensor:
    """int8 codes (m, block) and scales (m,) -> (m, block) f32."""
    return codebook(signed, q.device)[q.to(torch.int64) + 128] * scale[:, None]


def _quantize(x: torch.Tensor, block: int, signed: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1).to(torch.float32)
    pad = _pad_len(flat.shape[0], block) - flat.shape[0]
    return _q_blocks(F.pad(flat, (0, pad)).reshape(-1, block), signed)


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
                signed: bool) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return _dq_blocks(q, scale, signed).reshape(-1)[:n].reshape(shape)


def init_state(p: torch.Tensor) -> Dict[str, object]:
    """The state of a new tensor: both moments 0 (scale 1; mu's code 0,
    nu's -128) in blocks of ``DEFAULT_BLOCK``, the JAX ``init_fn``'s
    values."""
    block = DEFAULT_BLOCK
    nb = _pad_len(p.numel(), block) // block
    dev = p.device
    return {"step": 0,
            "mu_q": torch.zeros((nb, block), dtype=torch.int8, device=dev),
            "mu_scale": torch.ones((nb,), dtype=torch.float32, device=dev),
            "nu_q": torch.full((nb, block), -128, dtype=torch.int8,
                               device=dev),
            "nu_scale": torch.ones((nb,), dtype=torch.float32, device=dev)}


def check_state(p: torch.Tensor, st: Dict[str, object]) -> None:
    """Raises unless ``st`` has the layout ``init_state(p)`` makes: (blocks,
    256) int8 codes, 8-byte aligned (the kernel's loads), and (blocks,) f32
    scales, contiguous on ``p``'s device."""
    nb = _pad_len(p.numel(), DEFAULT_BLOCK) // DEFAULT_BLOCK
    for key in STATE_KEYS:
        t = st[key]
        code = key in _CODE_KEYS
        dtype = torch.int8 if code else torch.float32
        shape = (nb, DEFAULT_BLOCK) if code else (nb,)
        if (t.dtype != dtype or tuple(t.shape) != shape
                or t.device != p.device or not t.is_contiguous()):
            raise ValueError(f"{key} must be {dtype} {shape}, contiguous "
                             f"on {p.device}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if code and t.data_ptr() % 8:
            raise ValueError(f"{key} is not 8-byte aligned")


def adam8bit_reference(p: torch.Tensor, g: torch.Tensor,
                       state: Dict[str, torch.Tensor],
                       h: Adam8bitHyper) -> None:
    """One 8-bit AdamW update of ``p`` (f32) with gradient ``g``, in place,
    with ``state``'s codes and scales (blocks in ``p``'s row-major order),
    in chunks of ``_CHUNK_BLOCKS`` blocks: the plain version of the
    kernel."""
    if not p.is_contiguous():
        flat = p.contiguous()
        adam8bit_reference(flat, g, state, h)
        p.copy_(flat)
        return
    mu_q, mu_s = state["mu_q"], state["mu_scale"]
    nu_q, nu_s = state["nu_q"], state["nu_scale"]
    nb, block = mu_q.shape
    n = p.numel()
    pf, gf = p.view(-1), g.reshape(-1)
    b1c, b2c = _scalar(h.b1c, p), _scalar(h.b2c, p)
    for b0 in range(0, nb, _CHUNK_BLOCKS):
        b1_ = min(nb, b0 + _CHUNK_BLOCKS)
        lo, hi = b0 * block, min(n, b1_ * block)
        g2d = gf[lo:hi].to(torch.float32)
        pad = (b1_ - b0) * block - (hi - lo)
        if pad:
            g2d = F.pad(g2d, (0, pad))
        g2d = g2d.reshape(-1, block)
        mu = _dq_blocks(mu_q[b0:b1_], mu_s[b0:b1_], True)
        nu = _dq_blocks(nu_q[b0:b1_], nu_s[b0:b1_], False)
        mu = mu * h.b1 + g2d * (1 - h.b1)
        nu = nu * h.b2 + (g2d * (1 - h.b2)) * g2d
        step = (mu / b1c) / (torch.sqrt(nu / b2c) + h.eps)
        mu_q[b0:b1_], mu_s[b0:b1_] = _q_blocks(mu, True)
        nu_q[b0:b1_], nu_s[b0:b1_] = _q_blocks(nu, False)
        step = step.reshape(-1)[:hi - lo]
        if h.step_bf16:
            step = step.to(torch.bfloat16).to(torch.float32)
        part = pf[lo:hi]
        part.copy_(part + (step + part * h.weight_decay) * (-h.lr))


class AdamW8bit(torch.optim.Optimizer):
    """AdamW with both moments in block-quantized int8 (the JAX
    ``adamw_8bit``). State per tensor: ``step`` (updates made), ``mu_q`` /
    ``mu_scale`` and ``nu_q`` / ``nu_scale`` ((blocks, 256) int8 codes
    and (blocks,) f32 scales), made at the tensor's first update. For CUDA
    tensors a group's update is one kernel launch (``ops/adam8bit``, f32
    parameters and gradients); CPU tensors take the plain version.
    ``step_bf16``: round the step to bf16 before the decay, as the JAX
    step does with bf16 gradients (the train step sets it from
    ``grads_bf16``)."""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-2,
                 step_bf16: bool = False):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      step_bf16=step_bf16))

    @torch.no_grad()
    def step(self, closure=None):
        from e4t_diffusion_torch.ops.adam8bit import adam8bit_update

        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            by_count: Dict[int, List] = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                if p.grad.is_sparse:
                    raise RuntimeError("AdamW8bit takes no sparse gradients")
                state = self.state[p]
                if not state:
                    state.update(init_state(p))
                state["step"] += 1
                by_count.setdefault(state["step"], []).append(
                    (p, p.grad, state))
            b1, b2 = group["betas"]
            for count, items in by_count.items():
                hyper = Adam8bitHyper(
                    lr=group["lr"], b1=b1, b2=b2, eps=group["eps"],
                    weight_decay=group["weight_decay"],
                    b1c=bias_correction(b1, count),
                    b2c=bias_correction(b2, count),
                    step_bf16=group["step_bf16"])
                adam8bit_update(*map(list, zip(*items)), hyper)
        return loss

    def load_state_dict(self, state_dict: dict) -> None:
        """``Optimizer.load_state_dict``, which casts every saved tensor of
        a float parameter to its dtype, with the int8 codes kept int8 (and
        moved to the parameter's device): a restore is bit for bit. Each
        restored state must have the layout ``init_state`` makes."""
        codes, state = {}, {}
        for idx, st in state_dict["state"].items():
            st = dict(st)
            codes[idx] = {k: st.pop(k) for k in _CODE_KEYS if k in st}
            state[idx] = st
        super().load_state_dict({**state_dict, "state": state})
        ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        params = [p for g in self.param_groups for p in g["params"]]
        for idx, p in zip(ids, params):
            for k, v in codes.get(idx, {}).items():
                self.state[p][k] = v.to(device=p.device, dtype=torch.int8)
            if self.state.get(p):
                check_state(p, self.state[p])


def state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of the tensors in an optimizer's state (this rank's share)."""
    inner = getattr(optimizer, "optim", optimizer)  # ZeRO-1's local one
    return sum(v.numel() * v.element_size()
               for st in inner.state.values() for v in st.values()
               if isinstance(v, torch.Tensor))
