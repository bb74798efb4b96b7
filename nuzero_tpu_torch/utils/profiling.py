"""Per-phase wall-clock timers (counterpart of
``nuzero_tpu/utils/profiling.py:PhaseTimers``).

On the card a phase synchronizes the current stream before it reads the
clock at its start and end, so that the time of a phase is the device work
it queued, not the host's enqueue.  Work that another thread queues on its
own stream (the asynchronous in-loop tests) is not waited for."""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


class PhaseTimers:
    """>>> timers = PhaseTimers(device)
    >>> with timers.phase("selfplay"): ...
    >>> timers.metrics()  # {"time/selfplay": ...}"""

    def __init__(self, device):
        """``device``: where the timed work runs; on a CUDA device each
        phase boundary synchronizes its current stream."""
        self.device = torch.device(device)
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._last: Dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self._last[name] = dt

    def metrics(self, last: bool = True) -> Dict[str, float]:
        """``time/<phase>`` values: the most recent interval by default, or
        cumulative totals with ``last=False``."""
        src = self._last if last else self.totals
        return {f"time/{k}": round(v, 6) for k, v in src.items()}
