"""Spans at the port's layer boundaries and per-phase wall-clock timers
(``PhaseTimers``, counterpart of ``nuzero_tpu/utils/profiling.py``).

``span(name, tag=None)`` times a block on the host clock.  A span opened
with no ``torch.profiler`` session running adds to per-name sums that
``snapshot()`` returns: ``calls``, ``total_s`` and ``self_s`` (the total
less the time of the spans opened inside it on the same thread).  A span
opened while a profiler runs is left out of the sums, since the profiler
slows the host work it records, and is instead an event of that name in
the profiler's trace (``tag`` its argument ``tag`` where the profiler
records shapes), on the device kernels' clock, nested as the spans were
opened.  The event is a plain host operation, not a ``record_function``
range: the profiler copies such a range (a user annotation) onto the
card's timeline as a device event, which would count as device work.  A
torch build without that operation (``_RecordFunctionFast``, private)
gives no event, and the span still times its block.  The sums are shared
by every thread of the process; ``reset()`` clears them.

The port opens its spans (``nuzero.*``) around host work only, never
inside code that runs under CUDA-graph capture: there a span would time
the capture, not the replay.

On the card a phase synchronizes the current stream before it reads the
clock at its start and end, so that the time of a phase is the device work
it queued, not the host's enqueue.  Work that another thread queues on its
own stream (the asynchronous in-loop tests) is not waited for."""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
_trace_event = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_clock = time.perf_counter_ns
_lock = threading.Lock()
_all_sums: list = []  # every thread's sums, each {name: [calls, total ns, self ns]}


class _Thread(threading.local):
    """A thread's open spans (innermost last) and its own sums, which only
    it writes, so no update is lost between threads."""

    def __init__(self):
        self.spans = []
        self.sums = {}
        with _lock:
            _all_sums.append(self.sums)


_here = _Thread()


class span:
    """>>> with span("nuzero.selfplay.launch", tag=7) as s: ...
    >>> s.seconds  # this span's own duration"""

    __slots__ = ("name", "tag", "start", "stop", "child_ns", "_profiled", "_event", "_spans")

    def __init__(self, name: str, tag=None):
        self.name = name
        self.tag = tag
        self.start = self.stop = 0

    def __enter__(self):
        self._profiled = _profiler_enabled()
        if self._profiled and _trace_event is not None:
            self._event = (_trace_event(self.name) if self.tag is None
                           else _trace_event(self.name, [], {"tag": self.tag}))
            self._event.__enter__()
        else:
            self._event = None
        self.child_ns = 0
        self._spans = spans = _here.spans
        spans.append(self)
        self.start = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stop = stop = _clock()
        total = stop - self.start
        spans = self._spans
        spans.pop()
        if spans:
            spans[-1].child_ns += total
        if not self._profiled:
            sums = _here.sums.get(self.name)
            if sums is None:
                sums = _here.sums[self.name] = [0, 0, 0]
            sums[0] += 1
            sums[1] += total
            sums[2] += total - self.child_ns
        if self._event is not None:
            self._event.__exit__(exc_type, exc, tb)
        return False

    @property
    def seconds(self) -> float:
        return (self.stop - self.start) / 1e9


def snapshot() -> Dict[str, dict]:
    """``{name: {"calls", "total_s", "self_s"}}`` of every span opened with
    no profiler running and closed since the process started or
    ``reset()``, summed over the threads."""
    merged: Dict[str, list] = {}
    with _lock:
        for sums in _all_sums:
            for name, (c, t, s) in list(sums.items()):
                m = merged.setdefault(name, [0, 0, 0])
                m[0] += c
                m[1] += t
                m[2] += s
    return {name: {"calls": c, "total_s": t / 1e9, "self_s": s / 1e9}
            for name, (c, t, s) in merged.items()}


def reset() -> None:
    """Clear every thread's sums."""
    with _lock:
        for sums in _all_sums:
            sums.clear()


class PhaseTimers:
    """>>> timers = PhaseTimers(device)
    >>> with timers.phase("selfplay"): ...  # also the span nuzero.phase.selfplay
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
        timed = span("nuzero.phase." + name)
        try:
            with timed:
                try:
                    yield
                finally:
                    self._sync()
        finally:
            dt = timed.seconds
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self._last[name] = dt

    def metrics(self, last: bool = True) -> Dict[str, float]:
        """``time/<phase>`` values: the most recent interval by default, or
        cumulative totals with ``last=False``."""
        src = self._last if last else self.totals
        return {f"time/{k}": round(v, 6) for k, v in src.items()}
