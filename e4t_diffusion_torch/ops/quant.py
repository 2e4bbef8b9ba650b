"""int8 serving quantization for the linear and conv sites of the UNet and
of the auxiliary towers (the ViT-H image encoder and the VAE decoder).

Counterpart of ``e4t_diffusion_tpu/ops/quant.py``, with the same scheme
(standard symmetric post-training quantization):

- weights: static per-output-channel int8, ``s = max(|w|, 1e-8) / 127``,
  quantized once per sampling run on the offset-folded weights;
- activations: dynamic per-tensor int8 (scale from the live abs-max), or a
  calibrated static per-tensor scale (``"sa"``), or calibrated static
  per-input-channel scales (``"sac"``) folded into the weight's input axis
  before it is quantized (``x @ W = (x / s_c) @ (W * s_c)``), with the
  SmoothQuant-style exponent ``E4T_INT8_PC_ALPHA`` (default 0.75);
- norms, SiLU, softmax and attention stay in the compute type.

The mechanism is weight-driven, as in the JAX package: ``quantize_params``
turns a UNet state dict into ``{module name: {"q", "s", ["sa" | "sac"]}}``
for the sites it quantizes, and the ``Linear`` / ``Conv2d`` drop-ins below
(used by ``models/unet.py``, ``models/vit.py`` and ``models/vae.py`` in
place of ``nn.Linear`` / ``nn.Conv2d``, same parameters and state-dict keys)
run the int8 path while ``int8_sites`` holds a quantized entry for them;
``InProjSite`` does the same for the ViT's packed ``in_proj_weight``.
``calibration`` records each site's activation abs-max (``"amax"``) and
per-input-channel abs-max (``"amax_c"``) instead.

Names: the port keys sites by torch module name ("down_blocks.0.resnets.0
.conv1"); the exclusion lists and the act-scales file use the JAX package's
module paths ("down_blocks_0/resnets_0/conv1"; ``jax_path`` for the UNet,
``vae_path`` and ``vit_path`` for the towers), so a list or a file means
the same sites in both packages.

int8 products: ``torch._int_mm`` for every linear site (a plain large
product, as XLA's dot is on the TPU), its activation quantized in one pass
by the kernel of ``csrc/quantize.cu`` (``quantize_activation``), and the
hand-written kernel of ``ops/int8_conv.py`` for every conv site, which
quantizes the activation in its own loads; a patch conv (kernel = stride >
1, no padding: the ViT's ``conv1``) is a product over non-overlapping
patches, and goes the linear sites' way (``int8_patch_conv``).
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import json
import os
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from e4t_diffusion_torch.ops import _build
from e4t_diffusion_torch.ops import int8_conv as _conv
from e4t_diffusion_torch.utils.convert import unet_component

_EPS = 1e-8
QUANTIZE_SOURCE = "quantize"
ACT_SCALES_FORMAT = "e4t-act-amax-v1"

# Module subtrees kept in full precision by default: the first and last convs
# and the timestep-embedding MLP (standard diffusion PTQ). E4T_INT8_EXCLUDE
# (comma list of JAX module names; empty = quantize all) overrides.
DEFAULT_EXCLUDE = ("conv_in", "conv_out", "time_embedding")

# UNet sites kept on dynamic activation scales under static-act serving (the
# weights still int8): the residual-carrying convs, whose live ranges
# outgrow a short calibration (the JAX package's measured attribution).
# E4T_INT8_STATIC_EXCLUDE (set, possibly empty) overrides.
UNET_STATIC_EXCLUDE = ("conv_shortcut", "downsamplers", "upsamplers")

QSite = Dict[str, torch.Tensor]

# {module: its quantized entry} while int8_sites() is active
_SITES: contextvars.ContextVar = contextvars.ContextVar("int8_sites",
                                                        default=None)
# (modules -> name, the amax dict being filled) while calibration() is active
_CALIB: contextvars.ContextVar = contextvars.ContextVar("calibration",
                                                        default=None)
# the all-reduce a live activation abs-max goes through while
# amax_reduction() is active (parallel serving: the MAX over every rank)
_AMAX_REDUCE: contextvars.ContextVar = contextvars.ContextVar(
    "amax_reduction", default=None)


def env_truthy(name: str, default: str = "0") -> bool:
    """The int8 env knobs' truthiness: anything but 0/false/empty."""
    return os.environ.get(name, default).lower() not in ("0", "false", "")


def jax_path(module_name: str) -> str:
    """A UNet module name in the JAX package's path form:
    "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj" ->
    "down_blocks_0/attentions_0/transformer_blocks_0/ff/net_0_proj"."""
    parts = []
    for p in module_name.split("."):
        if p.isdigit() or (p == "proj" and parts and parts[-1] == "net_0"):
            parts[-1] = f"{parts[-1]}_{p}"
        else:
            parts.append(p)
    return "/".join(parts)


def vae_path(module_name: str) -> str:
    """A VAE module name in the JAX package's path form:
    "decoder.up_blocks.0.resnets.1.conv1" -> "decoder/up_blocks_0_resnets_1
    /conv1", "decoder.mid_block.attentions.0.query" ->
    "decoder/mid_block/attentions_0/query"."""
    parts = []
    for p in module_name.split("."):
        if p.isdigit():
            parts[-1] = f"{parts[-1]}_{p}"
            # the JAX encoder and decoder name a block's layers flat
            if (len(parts) > 1 and parts[-2].startswith(("up_blocks_",
                                                         "down_blocks_"))
                    and not parts[-1].startswith(("up_blocks_",
                                                  "down_blocks_"))):
                parts[-2:] = [f"{parts[-2]}_{parts[-1]}"]
        else:
            parts.append(p)
    return "/".join(parts)


def vit_path(module_name: str) -> str:
    """A ViT-tower site name in the JAX package's path form:
    "transformer.resblocks.3.attn.in_proj" -> "resblocks_3/attn_in_proj",
    "transformer.resblocks.3.mlp.c_fc" -> "resblocks_3/mlp_c_fc", "conv1"
    -> "conv1"."""
    parts = []
    for p in module_name.split("."):
        if p == "transformer":
            continue
        if p.isdigit():
            parts[-1] = f"{parts[-1]}_{p}"
        elif parts and parts[-1] in ("attn", "mlp"):
            parts[-1] = f"{parts[-1]}_{p}"
        else:
            parts.append(p)
    return "/".join(parts)


def module_name(path: Sequence[str]) -> str:
    """Inverse of ``jax_path``: JAX path components -> the torch module name,
    through ``utils/convert``'s component mapping."""
    return ".".join(unet_component(c) for c in path)


def quantize_kernel(w: torch.Tensor,
                    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]]
                    = None) -> QSite:
    """Symmetric per-output-channel int8 of a torch weight ((O, I) or (O, I,
    kh, kw)): the output channel is dim 0, the scale reduces over the rest
    (and, for a shard of a row-parallel kernel, over the other shards:
    ``reduce`` maps the local per-channel abs-max to the whole kernel's)."""
    w32 = w.float()
    amax = w32.abs().amax(dim=tuple(range(1, w.dim())))
    if reduce is not None:
        amax = reduce(amax)
    s = torch.clamp(amax, min=_EPS)
    s = s / 127.0
    shape = (-1,) + (1,) * (w.dim() - 1)
    q = torch.clamp(torch.round(w32 / s.reshape(shape)), -127, 127)
    return {"q": q.to(torch.int8), "s": s}


def _env_list(name: str, default):
    env = os.environ.get(name)
    if env is None:
        return default
    return tuple(x for x in env.split(",") if x)


# the packed input projection of torch.nn.MultiheadAttention's layout
_IN_PROJ = "in_proj_weight"


def quantize_params(state_dict: Dict[str, torch.Tensor],
                    act_amax: Optional[Dict[str, QSite]] = None,
                    act_headroom: Optional[float] = None,
                    exclude: Optional[Sequence[str]] = None,
                    static_exclude: Optional[Sequence[str]] = None,
                    act_pc: Optional[bool] = None,
                    path_of: Callable[[str], str] = jax_path,
                    kernel_reduce: Optional[
                        Callable[[str, torch.Tensor], torch.Tensor]] = None,
                    act_shard: Optional[
                        Callable[[str, torch.Tensor], torch.Tensor]] = None
                    ) -> Dict[str, QSite]:
    """The int8 form of every linear / conv weight (ndim 2 or 4) of a state
    dict (the UNet's, or a tower's with ``path_of`` its ``vae_path`` /
    ``vit_path``) whose module is not excluded -> ``{site name: {"q": int8,
    "s": (O,) f32, ["sa": () f32 | "sac": (I,) f32]}}``. Linear "q" is
    (O, I); conv "q" is (O, kh, kw, I), the layout of the int8 conv kernel.
    A packed ``<module>.in_proj_weight`` is the site ``<module>.in_proj``.

    The rules of the JAX package's ``quantize_params``:
    ``exclude`` (default ``E4T_INT8_EXCLUDE``, else ``DEFAULT_EXCLUDE``)
    names whole JAX module-path components; ``act_amax`` (``{module name:
    {"amax", "amax_c"}}`` from ``calibration``) gives each site a static
    scale ``"sa" = max(amax * headroom, 1e-8) / 127`` unless a substring of
    ``static_exclude`` (default ``E4T_INT8_STATIC_EXCLUDE``, else none) is
    in its JAX path (``path_of`` of the site name); ``act_pc`` (default
    ``E4T_INT8_ACT_PC``) folds the per-channel ``"sac" = a_c ** alpha *
    max(a_c ** (1 - alpha)) / 127`` into the weight's input axis (dim 1)
    before quantizing, where the site's calibration has ``"amax_c"``.
    ``act_headroom`` defaults to ``E4T_INT8_CALIB_HEADROOM`` (1.0).
    ``kernel_reduce(site name, per-channel abs-max)`` (tensor parallelism:
    ``parallel/mesh.kernel_scale_reducer``) makes a shard's weight scales
    those of the whole kernel; ``act_shard(site name, sac)``
    (``parallel/mesh.channel_scale_shard``) cuts the ``"sac"`` computed on
    the whole calibrated ``"amax_c"`` to the input channels the site's
    weight shard holds, before it is folded and stored."""
    if act_headroom is None:
        act_headroom = float(os.environ.get("E4T_INT8_CALIB_HEADROOM", "1.0"))
    if act_pc is None:
        act_pc = env_truthy("E4T_INT8_ACT_PC")
    pc_alpha = float(os.environ.get("E4T_INT8_PC_ALPHA", "0.75"))
    if exclude is None:
        exclude = _env_list("E4T_INT8_EXCLUDE", DEFAULT_EXCLUDE)
    if static_exclude is None:
        static_exclude = _env_list("E4T_INT8_STATIC_EXCLUDE", ())
    act_amax = act_amax or {}

    out: Dict[str, QSite] = {}
    for key, w in state_dict.items():
        reduce = None
        if key.endswith(".weight"):
            name = key[: -len(".weight")]
        elif key.endswith(_IN_PROJ):
            name = key[: -len(_IN_PROJ)] + "in_proj"
        else:
            continue
        if w.dim() not in (2, 4):
            continue
        path = path_of(name)
        if any(c in exclude for c in path.split("/") + ["kernel"]):
            continue
        if kernel_reduce is not None:
            reduce = lambda amax, name=name: kernel_reduce(name, amax)
        calib = act_amax.get(name, {})
        static_here = ("amax" in calib and not any(
            p in f"{path}/kernel" for p in static_exclude))
        if static_here and act_pc and "amax_c" in calib:
            amax_c = torch.clamp(calib["amax_c"].float().to(w.device)
                                 * act_headroom, min=_EPS)
            sac = (amax_c ** pc_alpha
                   * torch.max(amax_c ** (1.0 - pc_alpha)) / 127.0)
            if act_shard is not None:
                sac = act_shard(name, sac)
            shape = (1, -1) + (1,) * (w.dim() - 2)
            site = quantize_kernel(w.float() * sac.reshape(shape), reduce)
            site["sac"] = sac
        else:
            site = quantize_kernel(w, reduce)
            if static_here:
                amax = calib["amax"].float().to(w.device)
                site["sa"] = torch.clamp(amax * act_headroom, min=_EPS) / 127.0
        if w.dim() == 4:
            site["q"] = site["q"].permute(0, 2, 3, 1).contiguous()
        out[name] = site
    return out


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """The live per-tensor scale ``max(max|x|, 1e-8) / 127`` in f32. The
    abs-max is exact in x's own type, so it is one reduction of x, with no
    f32 copy."""
    amax = torch.linalg.vector_norm(x, float("inf"), dtype=torch.float32)
    return torch.clamp(_reduced(amax), min=_EPS) / 127.0


def _reduced(amax: torch.Tensor) -> torch.Tensor:
    reduce = _AMAX_REDUCE.get()
    return amax if reduce is None else reduce(amax)


@contextlib.contextmanager
def amax_reduction(reduce: Callable[[torch.Tensor], torch.Tensor]
                   ) -> Iterator[None]:
    """While active, every live (dynamic) activation abs-max passes
    ``reduce`` before it becomes a scale: parallel serving makes it the MAX
    over every rank, so each rank quantizes a site as one card quantizes
    the whole batch."""
    token = _AMAX_REDUCE.set(reduce)
    try:
        yield
    finally:
        _AMAX_REDUCE.reset(token)


def quantize_activation_reference(x: torch.Tensor, site: QSite,
                                  channel_dim: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 activation (quant.py:251-265 of the JAX package) ->
    (int8 values, f32 dequantization factor): the per-channel ``"sac"``
    along ``channel_dim`` (whose magnitude is folded into the weight, so the
    factor is 1), the static ``"sa"``, or the live abs-max. The plain
    version of ``quantize_activation``."""
    x32 = x.float()
    sac = site.get("sac")
    if sac is not None:
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        q = torch.clamp(torch.round(x32 / sac.reshape(shape)), -127, 127)
        return q.to(torch.int8), torch.ones((), device=x.device)
    s = site.get("sa")
    if s is None:
        s = torch.clamp(_reduced(x32.abs().amax()), min=_EPS) / 127.0
    q = torch.clamp(torch.round(x32 / s), -127, 127)
    return q.to(torch.int8), s


def quantize_activation(x: torch.Tensor, site: QSite, channel_dim: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_activation_reference``'s values in one pass: for CUDA
    tensors, the kernel of ``csrc/quantize.cu`` (bf16 / f32 x in, int8
    out; the per-channel ``"sac"`` only along the last axis, the linear
    sites' layout), counted on ``quantize_activation.launches``; the
    dynamic scale is ``dynamic_scale``, one reduction. CPU tensors: the
    plain version."""
    if x.device.type == "cpu":
        return quantize_activation_reference(x, site, channel_dim)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x is {x.dtype}; the kernel takes bfloat16 or "
                        f"float32")
    sac = site.get("sac")
    if sac is not None:
        if channel_dim % x.dim() != x.dim() - 1:
            raise ValueError("the kernel takes per-channel scales along the "
                             "last axis")
        if sac.shape != (x.shape[-1],):
            raise ValueError(f"sac must be ({x.shape[-1]},), got "
                             f"{tuple(sac.shape)}")
        s, sx = sac, torch.ones((), device=x.device)
    else:
        s = site.get("sa")
        if s is None:
            s = dynamic_scale(x)
        sx = s
    if s.dtype != torch.float32 or s.device != x.device:
        raise TypeError(f"the scale must be float32 on {x.device}")
    if x.numel() > 1 << 30:
        raise ValueError(f"{x.numel()} elements: the kernel takes at most "
                         f"2**30")
    x = x.contiguous()
    s = s.contiguous()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel():
        _build.launch(QUANTIZE_SOURCE, "e4t_quantize",
                      [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int], x.device,
                      x.data_ptr(), int(x.dtype == torch.float32),
                      q.data_ptr(), s.data_ptr(), int(sac is not None),
                      x.numel(), x.shape[-1] if x.dim() else 1)
        quantize_activation.launches += 1
    return q, sx


quantize_activation.launches = 0


# torch._int_mm on CUDA takes more than 16 rows (and K, N multiples of 8,
# which every UNet width is); fewer rows are zero-padded up to this
_INT_MM_MIN_ROWS = 32


def _int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) exact int32."""
    m = a.shape[0]
    if m < _INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    return torch._int_mm(a, w.t())[:m]


def int8_linear(x: torch.Tensor, site: QSite,
                bias: Optional[torch.Tensor],
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``int8_dense`` of the JAX package: int8 x @ q^T in int32, times
    ``sx * s`` in f32, cast to ``out_dtype`` (default x's dtype), then the
    bias in that dtype."""
    xq, sx = quantize_activation(x, site, -1)
    q = site["q"]
    acc = _int_mm(xq.reshape(-1, q.shape[1]), q)
    y = (acc.float() * (sx * site["s"])).to(out_dtype or x.dtype)
    y = y.reshape(*x.shape[:-1], q.shape[0])
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


class _F32Linear(torch.autograd.Function):
    """x @ w^T with an f32 output from operands of a narrower type: on the
    card one cuBLAS product that keeps its f32 accumulator
    (``torch.mm(out_dtype=)``), on the CPU the product of f32 copies. The
    backward is ``F.linear``'s, in the operands' type."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda:
            y = torch.mm(x2, w.t(), out_dtype=torch.float32)
        else:
            y = torch.mm(x2.float(), w.float().t())
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        grad = grad.to(x.dtype)
        dx = grad @ w if ctx.needs_input_grad[0] else None
        dw = (grad.reshape(-1, grad.shape[-1]).t()
              @ x.reshape(-1, x.shape[-1])) if ctx.needs_input_grad[1] \
            else None
        return dx, dw


def linear_partial(module: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel linear site's partial product on this rank's input
    columns, in f32 and without the bias (``parallel/mesh.row_parallel``
    sums it over tp): int8 while ``int8_sites`` holds the site, else the
    plain product with an f32 output, its activation range recorded under
    ``calibration``. A live int8 scale must be the MAX over the tp ranks'
    columns, so it needs ``amax_reduction`` (which parallel sampling
    enters)."""
    site = _site(module)
    if site is None:
        _observe(module, x, -1)
        if x.dtype == torch.float32:
            return F.linear(x, module.weight)
        return _F32Linear.apply(x, module.weight)
    if "sa" not in site and _AMAX_REDUCE.get() is None:
        raise RuntimeError(
            "a live int8 scale at a row-parallel site needs "
            "quant.amax_reduction (the MAX over the tp ranks)")
    return int8_linear(x, site, None, out_dtype=torch.float32)


def int8_patch_conv(x: torch.Tensor, site: QSite,
                    bias: Optional[torch.Tensor], patch: int) -> torch.Tensor:
    """``int8_conv`` of the JAX package for a patch conv (kernel = stride =
    ``patch``, no padding) on NCHW: its patches do not overlap, so it is
    the product of the (N * gh * gw, patch * patch * C) patch matrix by the
    (O, patch * patch * C) weight. x goes NHWC and is quantized by
    ``quantize_activation`` (the kernel of ``csrc/quantize.cu`` on CUDA,
    per-channel "sac" along C), the int8 patches are gathered, K is
    zero-padded to ``torch._int_mm``'s multiple of 8, and the exact int32
    sums are rescaled as ``float(acc) * (sx * s)`` in x's type, then the
    bias: ``int8_conv_act_reference``'s values."""
    q = site["q"]
    o, kh, kw, c = q.shape
    n, _, h, w = x.shape
    gh, gw = h // patch, w // patch
    xq, sx = quantize_activation(
        x[:, :, :gh * patch, :gw * patch].permute(0, 2, 3, 1), site, -1)
    cols = xq.reshape(n, gh, patch, gw, patch, c).permute(
        0, 1, 3, 2, 4, 5).reshape(n * gh * gw, kh * kw * c)
    qw = q.reshape(o, kh * kw * c)
    pad = -cols.shape[1] % 8
    if pad:
        cols, qw = F.pad(cols, (0, pad)), F.pad(qw, (0, pad))
    acc = _int_mm(cols, qw)
    y = (acc.float() * (sx * site["s"])).to(x.dtype)
    y = y.reshape(n, gh, gw, o).permute(0, 3, 1, 2)
    if bias is not None:
        y = y + bias.to(x.dtype)[None, :, None, None]
    return y


def int8_conv2d(x: torch.Tensor, site: QSite, bias: Optional[torch.Tensor],
                stride: int, padding: int) -> torch.Tensor:
    """``int8_conv`` of the JAX package on NCHW: the int8 conv kernel
    (``ops/int8_conv.int8_conv_act``) quantizes x in its loads by the
    site's per-channel ``"sac"``, its static ``"sa"`` or the live abs-max
    scale (``dynamic_scale``), then fuses the rescale and bias; the weight's
    channels are zero-padded to the kernel's multiple of 16 where needed
    (conv_in's 4, when it is not excluded). A patch conv (square kernel =
    stride > 1, no padding) goes to ``int8_patch_conv``."""
    q = site["q"]
    if q.shape[1] == q.shape[2] == stride > 1 and padding == 0:
        return int8_patch_conv(x, site, bias, stride)
    pad = -q.shape[3] % _conv.CHANNEL_ALIGN
    if pad:
        q = F.pad(q, (0, pad))
    act = site.get("sac")
    per_channel = act is not None
    if not per_channel:
        act = site.get("sa")
        if act is None:
            act = dynamic_scale(x)
    b = bias.to(x.dtype) if bias is not None else None
    return _conv.int8_conv_act(x, q, act.float().reshape(-1), per_channel,
                               site["s"].float(), b, stride, padding)


def _site(module: nn.Module) -> Optional[QSite]:
    sites = _SITES.get()
    return None if sites is None else sites.get(module)


def _observe(module: nn.Module, x: torch.Tensor, channel_dim: int) -> None:
    """Under ``calibration``: fold this call's abs-max and per-input-channel
    abs-max into the site's running max."""
    calib = _CALIB.get()
    if calib is None:
        return
    names, amax = calib
    name = names.get(module)
    if name is None:
        return
    ax = x.detach().float().abs()
    dims = tuple(i for i in range(x.dim()) if i != channel_dim % x.dim())
    cur = {"amax": ax.amax(), "amax_c": ax.amax(dim=dims)}
    prev = amax.get(name)
    amax[name] = cur if prev is None else {
        k: torch.maximum(prev[k], v) for k, v in cur.items()}


class Linear(nn.Linear):
    """``nn.Linear`` (same parameters) that runs ``int8_linear`` while
    ``int8_sites`` holds an entry for it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        site = _site(self)
        if site is not None:
            return int8_linear(x, site, self.bias)
        _observe(self, x, -1)
        return super().forward(x)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (same parameters; square kernels, one int stride and
    padding, as the UNet's) that runs ``int8_conv2d`` while ``int8_sites``
    holds an entry for it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        site = _site(self)
        if site is not None:
            return int8_conv2d(x, site, self.bias, self.stride[0],
                               self.padding[0])
        _observe(self, x, 1)
        return super().forward(x)


class InProjSite(nn.Module):
    """A module holding torch.nn.MultiheadAttention's packed
    ``in_proj_weight`` (3 D, D) and ``in_proj_bias``: its ``in_proj`` runs
    ``int8_linear`` while ``int8_sites`` holds an entry for the site
    ``<module>.in_proj``, and the packed parameters keep their keys."""

    def in_proj(self, x: torch.Tensor) -> torch.Tensor:
        site = _site(self)
        if site is not None:
            return int8_linear(x, site, self.in_proj_bias)
        _observe(self, x, -1)
        return F.linear(x, self.in_proj_weight, self.in_proj_bias)


def site_modules(model: nn.Module) -> Dict[str, nn.Module]:
    """{site name: module} of ``model``'s int8-capable sites."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, (Linear, Conv2d)):
            out[name] = m
        elif isinstance(m, InProjSite):
            out[f"{name}.in_proj" if name else "in_proj"] = m
    return out


@contextlib.contextmanager
def int8_sites(model: nn.Module, sites: Dict[str, QSite]) -> Iterator[None]:
    """While active, the sites of ``model`` named in ``sites`` (from
    ``quantize_params``) run int8, besides those of enclosing contexts
    (the UNet's and each tower's); every other site is unchanged."""
    modules = site_modules(model)
    unknown = sorted(set(sites) - set(modules))
    if unknown:
        raise KeyError(f"no int8-capable site named {unknown[:4]}")
    token = _SITES.set({**(_SITES.get() or {}),
                        **{modules[name]: site
                           for name, site in sites.items()}})
    try:
        yield
    finally:
        _SITES.reset(token)


@contextlib.contextmanager
def calibration(model: nn.Module) -> Iterator[Dict[str, QSite]]:
    """Record activation ranges: yields ``{module name: {"amax": () f32,
    "amax_c": (C_in,) f32}}``, the running max over every call of each
    site of ``model`` while the context is active (the JAX package's
    "calib" collection, max-reduced over passes and steps)."""
    amax: Dict[str, QSite] = {}
    names = {m: name for name, m in site_modules(model).items()}
    token = _CALIB.set((names, amax))
    try:
        yield amax
    finally:
        _CALIB.reset(token)


# ---- calibration-scale files --------------------------------------------

def save_act_scales(act_amax: Dict[str, QSite], path: str) -> None:
    """Write calibrated ranges in the JAX package's ``e4t-act-amax-v1`` JSON:
    ``{"format", "scales": {"<JAX module path>/amax": float,
    ".../amax_c": [floats]}}``, readable by either package."""
    flat = {}
    for name, site in act_amax.items():
        for key, v in site.items():
            arr = v.detach().float().cpu()
            flat[f"{jax_path(name)}/{key}"] = (arr.tolist() if arr.dim()
                                               else float(arr))
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"format": ACT_SCALES_FORMAT, "scales": flat}, f,
                  indent=0, sort_keys=True)


def load_act_scales(path: str, device=None) -> Dict[str, QSite]:
    """Inverse of ``save_act_scales`` (and of the JAX package's) ->
    ``{module name: {"amax", "amax_c"}}`` of f32 tensors."""
    with open(path, encoding="utf-8") as f:
        payload = json.load(f)
    if payload.get("format") != ACT_SCALES_FORMAT:
        raise ValueError(f"{path}: not an {ACT_SCALES_FORMAT} file")
    out: Dict[str, QSite] = {}
    for key, v in payload["scales"].items():
        *path_parts, leaf = key.split("/")
        out.setdefault(module_name(path_parts), {})[leaf] = torch.tensor(
            v, dtype=torch.float32, device=device)
    return out
