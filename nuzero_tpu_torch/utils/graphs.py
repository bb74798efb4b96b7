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
        # Device flags that ``overflowed`` records into, innermost last.
        self.flags: list = []


_state = _ThreadState()


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
    for the graph's lifetime."""
    main, bodies = torch.cuda.Stream(), torch.cuda.Stream()
    if main.cuda_stream == bodies.cuda_stream:
        raise RuntimeError("could not get two streams for a capture")
    graph.body_pool = torch.cuda.MemPool()
    flags = overflow_into(overflow) if overflow is not None else contextlib.nullcontext()
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
    reading on the host."""
    _state.flags.append(flag)
    try:
        yield flag
    finally:
        _state.flags.pop()


def overflowed(cond: torch.Tensor, what: str) -> None:
    """Called after a loop bounded for capture; ``cond`` (0-d bool tensor)
    is true where the unbounded loop would go on."""
    if _state.flags:
        _state.flags[-1].logical_or_(cond)
    elif capturing():
        raise RuntimeError(f"{what}: captured without an overflow flag")
    elif bool(cond):
        raise OverflowError(f"{what} ran past its bound")
