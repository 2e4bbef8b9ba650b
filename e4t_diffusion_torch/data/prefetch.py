"""Device-side input prefetch for the training loop.

Counterpart of ``e4t_diffusion_tpu/data/prefetch.py``. The data loader
already decodes on a background thread; this takes the host-to-device copy
off the step's critical path too. ``place`` runs up to ``depth`` items
ahead of the consumer. On a CUDA device it runs on a side stream, where
``to_device`` copies from pinned host memory with ``non_blocking=True``;
an event recorded after ``place`` orders the copies before whatever the
consumer launches next on its stream, and every CUDA tensor of the placed
item is marked used on that stream (``record_stream``), so the caching
allocator does not hand its memory to another tensor while the consuming
step may still read it.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional, TypeVar

import numpy as np
import torch

T = TypeVar("T")
U = TypeVar("U")


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array on ``device``: on CUDA through pinned host memory,
    copied without blocking the host (on the current stream)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _cuda_tensors(obj: Any):
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _cuda_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _cuda_tensors(v)


def device_prefetch(iterator: Iterable[T], place: Callable[[T], U],
                    depth: int = 2,
                    device: Optional[torch.device] = None) -> Iterator[U]:
    """Yield ``place(item)`` for each item of ``iterator``, keeping up to
    ``depth`` placed items ahead of the consumer.

    ``place`` runs on the host in iteration order (safe for stateful
    placement such as template draws). With a CUDA ``device`` it runs on a
    side stream of that device, and each placed item is handed over as
    the module docstring says. A ``StopIteration`` raised by ``place``
    propagates as an error; it does not end the iteration."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    stream = (torch.cuda.Stream(device) if device is not None
              and torch.device(device).type == "cuda" else None)
    buf = deque()
    it = iter(iterator)
    exhausted = False
    try:
        while True:
            while not exhausted and len(buf) < depth:
                try:
                    item = next(it)
                except StopIteration:
                    exhausted = True
                    continue
                # place() runs outside the except scope: a StopIteration
                # from placement code must propagate, not end the epoch
                if stream is None:
                    buf.append((place(item), None))
                    continue
                with torch.cuda.stream(stream):
                    placed = place(item)
                    ready = torch.cuda.Event()
                    ready.record(stream)
                buf.append((placed, ready))
            if not buf:
                return
            placed, ready = buf.popleft()
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for t in _cuda_tensors(placed):
                    t.record_stream(consumer)
            yield placed
    finally:
        # closing the prefetch closes the source (a loader's threads stop)
        close = getattr(it, "close", None)
        if close is not None:
            close()
