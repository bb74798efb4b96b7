"""Data-dependent loops that a CUDA graph can hold.

A self-play move is captured once as a ``torch.cuda.CUDAGraph`` and then
replayed (``training/selfplay.py:capture_selfplay_step``).  A replay
cannot stop to read a device flag on the host, so the move's loops whose
trip count depends on the data are written with two helpers:

- ``run_while(cond, body, max_trips)`` runs ``body`` while the 0-d bool
  tensor ``cond()`` holds, at most ``max_trips`` times.  Outside a
  capture it reads ``cond()`` on the host before each trip.  Under
  ``capture`` it records the loop as one CUDA conditional while-node,
  which the device runs at every replay.  A body must therefore (1) write
  its results into tensors allocated before the loop, in place (``copy_``,
  ``logical_and_``, ``scatter_``): the loop leaves no other outputs, and a
  tensor the body creates holds garbage after a replay that skips it; and
  (2) be a no-op once ``cond()`` is false, so that taking every trip gives
  the same bits as stopping early.
- ``overflowed(cond, what)`` ends a loop whose bound is not part of what
  it computes, with ``cond`` true where the unbounded loop would go on.
  Inside ``overflow_into(flag)`` (which ``capture`` enters) it ORs
  ``cond`` into the device flag, for the caller to read after the replay;
  elsewhere it reads ``cond`` and raises.  A bound never truncates.

The while-nodes come from ``csrc/graph_loop.cu`` (the card's PyTorch has
no conditional-node API).  A body is captured on a second stream, with
the thread's allocations routed to a memory pool that the graph keeps;
loops do not nest.  One while-node per loop, rather than one if-node per
trip, keeps the host's cost of launching the graph small: it grows with
the conditional nodes the graph holds.

A kernel that bounds its own loop sets a flag itself:
``open_overflow_flag(what)`` hands it the flag that ``overflowed`` would OR
into, and ``DeferredOverflow`` carries the flag of an eager call on the card
past the call without a host read, to the caller's next call (the SCS env's
step kernel).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Callable, Optional

import torch


class _ThreadState(threading.local):
    """Per thread, as the current CUDA stream is: a capture on one thread
    never sees another thread's loops (the pipeline's asynchronous in-loop
    tests run eager searches on a worker thread)."""

    def __init__(self):
        # Captures underway that ``run_while`` records into: [the bodies'
        # MemPool, the bodies' stream, whether a body is being recorded].
        self.captures: list = []
        # (device flag, the bounds recorded into it) that ``overflowed``
        # records into, innermost last.
        self.flags: list = []


_state = _ThreadState()
# One capture at a time in the process: a capture's start synchronizes the
# whole device, which would break another thread's capture underway, and a
# graph's memory pool may not be freed while any capture is underway.
_capture_lock = threading.Lock()


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph, pool=None,
            overflow: Optional[torch.Tensor] = None):
    """``torch.cuda.graph(graph, pool=pool)`` in which ``run_while`` records
    while-nodes and ``overflowed`` records into ``overflow`` (a 0-d bool
    tensor on the device, allocated before the capture).  The bodies'
    tensors live in a ``torch.cuda.MemPool`` that ``graph.body_pool`` keeps
    for the graph's lifetime.  Captures through here run one at a time."""
    main, bodies = torch.cuda.Stream(), torch.cuda.Stream()
    if main.cuda_stream == bodies.cuda_stream:
        raise RuntimeError("could not get two streams for a capture")
    flags = overflow_into(overflow) if overflow is not None else contextlib.nullcontext()
    with _capture_lock:
        graph.body_pool = torch.cuda.MemPool()
        with torch.cuda.graph(graph, pool=pool, stream=main), flags:
            _state.captures.append([graph.body_pool, bodies, False])
            try:
                yield graph
            finally:
                _state.captures.pop()


def run_while(cond: Callable[[], torch.Tensor], body: Callable[[], None],
              max_trips: int) -> bool:
    """Run ``body()`` while ``cond()`` (a 0-d bool tensor) holds, at most
    ``max_trips`` times; see the module docstring for what a body must do.
    Returns whether the loop may have stopped at its bound rather than on
    ``cond()``: always under capture, where the device decides."""
    if max_trips < 1:
        return True
    if not capturing():
        for _ in range(max_trips):
            if not bool(cond()):
                return False
            body()
        return True
    if not _state.captures:
        raise RuntimeError("run_while under a capture that graphs.capture did not start")
    record = _state.captures[-1]
    pool, child, in_body = record
    if in_body:
        raise RuntimeError("run_while loops do not nest")
    from nuzero_tpu_torch.ops.cuda.build import graph_loop_library

    lib = graph_loop_library()
    first = cond()
    dev = first.device
    if first.dtype != torch.bool or first.dim() != 0 or dev.type != "cuda":
        raise ValueError(f"run_while needs a 0-d bool CUDA tensor, got {first.dtype} "
                         f"{tuple(first.shape)} on {dev}")
    pred = first.clone()  # the loop's own flag, rewritten by each trip
    trips = torch.zeros((), dtype=torch.int64, device=dev)
    handle = ctypes.c_ulonglong()
    err = lib.graph_while_begin(torch.cuda.current_stream(dev).cuda_stream, pred.data_ptr(),
                                child.cuda_stream, ctypes.byref(handle))
    if err != 0:
        raise RuntimeError(f"graph_while_begin failed: CUDA error {err}")
    record[2] = True
    try:
        with torch.cuda.use_mem_pool(pool, dev), torch.cuda.stream(child):
            body()
            trips.add_(1)
            pred.copy_(cond() & (trips < max_trips))
    finally:
        record[2] = False
        end_err = lib.graph_while_end(child.cuda_stream, handle, pred.data_ptr())
    if end_err != 0:
        raise RuntimeError(f"graph_while_end failed: CUDA error {end_err}")
    return True


@contextlib.contextmanager
def overflow_into(flag: torch.Tensor):
    """Inside the block, ``overflowed`` ORs into ``flag`` instead of
    reading on the host; yields the list of the bounds (``what``) that
    were recorded into it."""
    whats: list = []
    _state.flags.append((flag, whats))
    try:
        yield whats
    finally:
        _state.flags.pop()


def overflowed(cond: torch.Tensor, what: str) -> None:
    """Called after a loop bounded for capture; ``cond`` (0-d bool tensor)
    is true where the unbounded loop would go on."""
    if _state.flags:
        flag, whats = _state.flags[-1]
        flag.logical_or_(cond)
        whats.append(what)
    elif capturing():
        raise RuntimeError(f"{what}: captured without an overflow flag")
    elif bool(cond):
        raise OverflowError(f"{what} ran past its bound")


def open_overflow_flag(what: str) -> Optional[torch.Tensor]:
    """The flag that ``overflowed`` would OR into here, for a kernel that
    sets it itself (and never clears it), with ``what`` recorded against it;
    None outside ``overflow_into``, where the caller reports its own flag.
    Under a capture without a flag it raises, as ``overflowed`` does."""
    if _state.flags:
        flag, whats = _state.flags[-1]
        whats.append(what)
        return flag
    if capturing():
        raise RuntimeError(f"{what}: captured without an overflow flag")
    return None


class DeferredOverflow:
    """The overflow flags of a caller's eager calls on the card, each read at
    the caller's next call on the same thread instead of at once.

    ``report(flag, what)`` after an eager call (outside ``overflow_into``)
    copies the 0-d bool device ``flag`` to pinned host memory behind an
    event.  ``check()``, which the caller makes before its next call, waits
    for that event (the call's work, not work queued after it) and raises
    ``overflowed``'s ``OverflowError`` if the flag was set, once."""

    def __init__(self):
        self._local = threading.local()

    def check(self) -> None:
        local = self._local
        pending = getattr(local, "pending", None)
        if pending is None or capturing():
            return
        local.pending = None
        pending[0].synchronize()
        if bool(local.host):
            raise OverflowError(f"{pending[1]} ran past its bound")

    def report(self, flag: torch.Tensor, what: str) -> None:
        local = self._local
        if getattr(local, "host", None) is None:
            local.host = torch.zeros((), dtype=torch.bool, pin_memory=True)
            local.done = torch.cuda.Event()
        local.host.copy_(flag, non_blocking=True)
        local.done.record(torch.cuda.current_stream(flag.device))
        local.pending = (local.done, what)
