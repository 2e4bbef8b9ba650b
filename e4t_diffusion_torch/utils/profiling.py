"""Profiler traces and step timing for the training loops.

Counterpart of ``e4t_diffusion_tpu/utils/profiling.py``:

- ``trace(logdir)``: ``torch.profiler`` over the block (host ops, and the
  card's kernels where CUDA is available), written into ``logdir`` as a
  Chrome / TensorBoard trace (``<host>_<pid>.<ns>.pt.trace.json``); the
  CLIs' ``--profile_steps N --profile_dir DIR``;
- ``StepTimer``: wall time between the loop's step boundaries, after a few
  warm-up steps, as steps/s and samples/s. The caller marks a boundary
  once a step's results are on the host (a synchronised point), so the
  times cover the device's work.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block and write its trace into ``logdir`` (made if
    missing) when it ends; yields the profiler. The caller synchronises
    the card at both ends, so the window holds whole steps."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


class StepTimer:
    """Post-warm-up step times; reports steps/s and samples/s."""

    def __init__(self, warmup_steps: int = 2, batch_size: int = 1):
        self.warmup_steps = warmup_steps
        self.batch_size = batch_size
        self._count = 0
        self._t_last: Optional[float] = None
        self._total = 0.0
        self._timed_steps = 0
        self._min = float("inf")

    def step(self) -> None:
        now = time.perf_counter()
        self._count += 1
        if self._count > self.warmup_steps and self._t_last is not None:
            dt = now - self._t_last
            self._total += dt
            self._timed_steps += 1
            self._min = min(self._min, dt)
        self._t_last = now

    def metrics(self) -> Dict[str, float]:
        if self._timed_steps == 0:
            return {}
        mean = self._total / self._timed_steps
        return {
            "perf/step_time_mean_s": mean,
            "perf/step_time_min_s": self._min,
            "perf/steps_per_sec": 1.0 / mean,
            "perf/samples_per_sec": self.batch_size / mean,
        }
