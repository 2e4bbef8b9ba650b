"""8-bit AdamW update on the card: the kernel of ``csrc/adam8bit.cu``.

``adam8bit_update`` updates a list of parameters in place from their
gradients and 8-bit AdamW states (``training/optim8bit.init_state``). For
CUDA tensors it launches the kernel once for the whole list (a table of
the tensors' pointers on the device; each warp of the kernel walks a run of
256-element blocks across the tensors), raises on anything the kernel does
not take, and counts the launch on ``adam8bit_update.launches``. For CPU
tensors it runs the plain version, ``optim8bit.adam8bit_reference``, tensor
by tensor.

The JAX package computes the same update in XLA (no Pallas kernel:
``e4t_diffusion_tpu/training/optim8bit.py:109-117``); the kernel replaces
the ~50 elementwise PyTorch passes a chunk that the plain version runs.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from e4t_diffusion_torch.ops import _build
from e4t_diffusion_torch.training import optim8bit

SOURCE = "adam8bit"
BLOCK = optim8bit.DEFAULT_BLOCK
# CTAs of 8 warps the kernel runs per SM (each warp takes a contiguous run
# of blocks)
_CTAS_PER_SM = 4
# numbers a tensor in a pointer table's key: p, g, mu_q, mu_scale, nu_q,
# nu_scale, numel (the kernel's row adds the first block's index)
_FIELDS = 7
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_void_p, *[ctypes.c_float] * 9, ctypes.c_int,
             ctypes.c_int]


# per device: the codebooks; the last pointer table (its key, the
# stream it was copied on, the table and the blocks it covers)
_BOOKS: Dict[torch.device, torch.Tensor] = {}
_TABLES: Dict[torch.device, Tuple] = {}


def _codebooks(device: torch.device) -> torch.Tensor:
    """The signed and the unsigned codebook, one (512,) f32 tensor on
    ``device``, made once: the plain version's values, so the kernel's
    dequantized moments are its values bit for bit. Copied from pinned
    memory without waiting: a copy from pageable memory would wait for the
    stream (the whole backward)."""
    books = _BOOKS.get(device)
    if books is None:
        books = torch.cat([optim8bit.codebook(True, "cpu"),
                           optim8bit.codebook(False, "cpu")])
        books = _BOOKS[device] = books.pin_memory().to(device,
                                                       non_blocking=True)
    return books


def _check(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           states: Sequence[Dict]) -> None:
    """Raises unless every tensor lies on one device, the parameters and
    gradients are f32, contiguous and of one shape, and each state is the
    layout ``optim8bit.init_state`` makes."""
    device = params[0].device
    for p, g, st in zip(params, grads, states):
        if p.device != device or g.device != device:
            raise ValueError("the kernel takes tensors of one device")
        if p.dtype != torch.float32 or g.dtype != torch.float32:
            raise TypeError(f"p is {p.dtype}, g {g.dtype}; the kernel takes "
                            f"float32 parameters and gradients")
        if g.shape != p.shape:
            raise ValueError(f"gradient {tuple(g.shape)} for a parameter "
                             f"{tuple(p.shape)}")
        if not (p.is_contiguous() and g.is_contiguous()):
            raise ValueError("the kernel takes contiguous parameters and "
                             "gradients")
        optim8bit.check_state(p, st)


def _key(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
         states: Sequence[Dict]) -> Optional[Tuple[int, ...]]:
    """The pointer table's content, ``_FIELDS`` numbers a tensor: its
    parameter's, gradient's, codes' and scales' pointers and its size;
    None where a parameter or gradient is not f32 and contiguous or the
    sizes differ (``_check`` says which)."""
    key: List[int] = []
    add = key.extend
    f32 = torch.float32
    for p, g, st in zip(params, grads, states):
        n = p.numel()
        if (p.dtype is not f32 or g.dtype is not f32 or g.numel() != n
                or not p.is_contiguous() or not g.is_contiguous()):
            return None
        add((p.data_ptr(), g.data_ptr(), st["mu_q"].data_ptr(),
             st["mu_scale"].data_ptr(), st["nu_q"].data_ptr(),
             st["nu_scale"].data_ptr(), n))
    return tuple(key)


def _held(key: Tuple[int, ...]) -> Tuple[int, ...]:
    """The part of a ``_key`` that is not the gradients' pointers: what the
    optimizer holds from one update to the next."""
    return sum((key[i::_FIELDS] for i in range(_FIELDS) if i != 1), ())


def _table(key: Tuple[int, ...], device: torch.device
           ) -> Tuple[torch.Tensor, int]:
    """(the kernel's table on ``device``, the blocks it covers): a ``_key``'s
    rows of the non-empty tensors, each with its first block's index."""
    rows = np.fromiter(key, np.int64, len(key)).reshape(-1, _FIELDS)
    rows = rows[rows[:, -1] > 0]
    blocks = (rows[:, -1] + (BLOCK - 1)) // BLOCK
    first = np.cumsum(blocks) - blocks
    table = torch.from_numpy(np.concatenate([rows, first[:, None]], 1))
    # pinned: the copy runs on the stream, and PyTorch's pinned-memory
    # allocator keeps the block until it has
    return (table.pin_memory().to(device, non_blocking=True),
            int(blocks.sum()))


def adam8bit_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                    states: List[Dict], hyper: optim8bit.Adam8bitHyper
                    ) -> None:
    """One 8-bit AdamW update of ``params`` in place (``states``: each
    tensor's codes and scales, updated in place). CUDA tensors: f32
    contiguous parameters and gradients, blocks of 256, one launch counted
    on ``adam8bit_update.launches``. CPU tensors: the plain version.

    The host's share is one pass over the tensors' pointers. The pointer
    table on the card is kept while they are unchanged; it is rebuilt
    (counted on ``adam8bit_update.tables``) when one changes, which the
    gradients' do at most updates, and every tensor and state is checked
    when a pointer other than a gradient's changes."""
    if not params:
        return
    device = params[0].device
    if device.type == "cpu":
        for p, g, st in zip(params, grads, states):
            optim8bit.adam8bit_reference(p, g, st, hyper)
        return
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    key = _key(params, grads, states)
    stream = torch.cuda.current_stream(device).cuda_stream
    cached = _TABLES.get(device)
    if key is None or cached is None or cached[:2] != (key, stream):
        held = None if key is None else _held(key)
        index = device.index
        if (held is None or cached is None or cached[2] != held
                or any(g.get_device() != index for g in grads)):
            _check(params, grads, states)
        _TABLES.pop(device, None)
        table, blocks = _table(key, device)
        _TABLES[device] = cached = (key, stream, held, table, blocks)
        adam8bit_update.tables += 1
    table, blocks = cached[3:]
    if blocks:
        launch_table(table, blocks, hyper)
        adam8bit_update.launches += 1


def pointer_table(params: Sequence[torch.Tensor],
                  grads: Sequence[torch.Tensor], states: Sequence[Dict]):
    """(the kernel's table of the tensors' pointers on their device, the
    blocks it covers), the tensors checked: one int64 row per non-empty
    tensor."""
    _check(params, grads, states)
    return _table(_key(params, grads, states), params[0].device)


def launch_table(table: torch.Tensor, blocks: int,
                 hyper: optim8bit.Adam8bitHyper) -> None:
    """The kernel over a ``pointer_table`` (``blocks`` > 0), on the current
    stream; counts nothing (``adam8bit_update`` does)."""
    device = table.device
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = max(1, min(-(-blocks // 8), sms * _CTAS_PER_SM))
    books = _codebooks(device)
    _build.launch(SOURCE, "e4t_adam8bit", _ARGTYPES, device,
                  table.data_ptr(), table.shape[0], blocks,
                  books.data_ptr(), hyper.b1, 1 - hyper.b1,
                  hyper.b2, 1 - hyper.b2, hyper.eps, hyper.b1c, hyper.b2c,
                  hyper.weight_decay, -hyper.lr, int(hyper.step_bf16), grid)


adam8bit_update.launches = 0
adam8bit_update.tables = 0
