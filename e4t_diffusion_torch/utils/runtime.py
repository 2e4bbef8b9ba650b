"""Process runtime: shutdown on SIGTERM at a step boundary.

The ``GracefulShutdown`` of ``e4t_diffusion_tpu/utils/runtime.py``.
Schedulers that preempt a job send SIGTERM and allow a grace window; the
handler only sets a flag, which the training loop reads after each
optimizer update, then saves the train state and leaves through its normal
exit path, so a checkpoint always holds a whole step.
"""
from __future__ import annotations

import signal


class GracefulShutdown:
    """Catches ``signals`` (SIGTERM by default) until ``restore``."""

    def __init__(self, signals=None):
        self.requested = False
        self._received = None
        self._prev = {}
        for s in signals or (signal.SIGTERM,):
            self._prev[s] = signal.signal(s, self._handle)

    def _handle(self, signum, frame):
        self.requested = True
        self._received = signum

    def restore(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}

    def describe(self) -> str:
        try:
            name = signal.Signals(self._received).name
        except ValueError:
            name = str(self._received)
        return f"received {name}"
