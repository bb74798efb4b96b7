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

``ReplayCache`` replays a pure function of tensors (the SCS env's step) as
a CUDA graph where it is called eagerly on the card: captured on first use
at each input shape, per thread, with its bounded loops recording into the
graph's own flag, which the next call reads.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import threading
from typing import Callable, Optional, Sequence

import torch

from nuzero_tpu_torch.utils.profiling import count


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
            overflow: Optional[torch.Tensor] = None, capture_error_mode: str = "global"):
    """``torch.cuda.graph(graph, pool=pool)`` in which ``run_while`` records
    while-nodes and ``overflowed`` records into ``overflow`` (a 0-d bool
    tensor on the device, allocated before the capture).  The bodies'
    tensors live in a ``torch.cuda.MemPool`` that ``graph.body_pool`` keeps
    for the graph's lifetime.  ``capture_error_mode="thread_local"`` lets
    other threads use the card meanwhile, short of synchronizing the whole
    device.  Captures through here run one at a time."""
    main, bodies = torch.cuda.Stream(), torch.cuda.Stream()
    if main.cuda_stream == bodies.cuda_stream:
        raise RuntimeError("could not get two streams for a capture")
    flags = overflow_into(overflow) if overflow is not None else contextlib.nullcontext()
    with _capture_lock:
        graph.body_pool = torch.cuda.MemPool()
        with torch.cuda.graph(graph, pool=pool, stream=main,
                              capture_error_mode=capture_error_mode), flags:
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


def _on_card(inputs: Sequence[torch.Tensor]) -> bool:
    """Whether every input lies on one CUDA device."""
    dev = inputs[0].device
    return dev.type == "cuda" and all(t.device == dev for t in inputs)


class _Replayed:
    """One captured graph of ``ReplayCache``: its static inputs and outputs,
    its overflow flag with a pinned host copy, and the event after which
    that copy holds the last replay's flag."""

    __slots__ = ("graph", "inputs", "outputs", "flag", "host_flag", "done", "whats", "pending")


class ReplayCache:
    """``fn(*inputs) -> sequence of tensors``, a pure function of its tensor
    inputs (it reads no other state that changes, draws no random numbers,
    returns tensors of its own), called as ``cache(fn, *inputs)``.

    Eager, ``fn(*inputs)``, where the inputs are not all on one CUDA device,
    where a capture is underway on the current stream (``capturing()``), or
    inside ``overflow_into`` (the eager warm-up of a capture): a caller
    being captured records ``fn``'s own work into its graph.  Otherwise the
    call replays a CUDA graph of ``fn``, captured on the first call at the
    inputs' shapes and dtypes: the inputs are copied into the graph's static
    buffers, the graph replays, and the call returns fresh copies of its
    outputs, so nothing returned aliases the graph or the inputs.  The
    graphs are per thread (two threads never share a graph's buffers), at
    most ``SIZE`` of them; the least recently used is released first.
    ``counter`` + ``.capture`` / ``.replay`` count the calls of each kind
    (``profiling.count``: calls, no time).

    A bound that ``fn`` reaches (``overflowed``) sets the graph's device
    flag.  The flag is copied to pinned host memory after each replay, and
    ``check()``, which each call makes first, raises the eager step's
    ``OverflowError`` from it: it waits for the replay, not for work queued
    after it."""

    SIZE = 4

    def __init__(self, counter: str):
        self.counter = counter
        self._local = threading.local()

    def _graphs(self) -> collections.OrderedDict:
        graphs = getattr(self._local, "graphs", None)
        if graphs is None:
            graphs = self._local.graphs = collections.OrderedDict()
        return graphs

    def check(self) -> None:
        """Raise if a replay on this thread ran a loop past its bound (each
        overflow once; nothing to check inside a capture)."""
        graphs = getattr(self._local, "graphs", None)
        if not graphs or capturing():
            return
        for g in graphs.values():
            if g.pending:
                g.pending = False
                g.done.synchronize()
                if bool(g.host_flag):
                    raise OverflowError(f"{' and '.join(g.whats)} ran past its bound")

    def __call__(self, fn: Callable, *inputs: torch.Tensor) -> list:
        self.check()
        if not _on_card(inputs) or capturing() or _state.flags:
            return list(fn(*inputs))
        dev = inputs[0].device
        key = (dev, *((t.shape, t.dtype) for t in inputs))
        graphs = self._graphs()
        g = graphs.get(key)
        if g is None:
            g = graphs[key] = self._capture(fn, inputs)
            if len(graphs) > self.SIZE:
                old = graphs.popitem(last=False)[1]
                with _capture_lock:
                    old.inputs = old.outputs = None
                    old.graph.reset()
                    del old
            count(self.counter + ".capture")
        else:
            graphs.move_to_end(key)
            torch._foreach_copy_(g.inputs, inputs)
            count(self.counter + ".replay")
        with torch.cuda.device(dev):
            g.graph.replay()
            g.host_flag.copy_(g.flag, non_blocking=True)
            g.done.record()
            g.pending = True
            return [t.clone() for t in g.outputs]

    @staticmethod
    def _capture(fn: Callable, inputs) -> _Replayed:
        """The graph of ``fn`` on copies of ``inputs``, after one eager call on
        a side stream (as ``torch.cuda.graphs`` asks; its overflow is the
        replay's to report)."""
        dev = inputs[0].device
        g = _Replayed()
        g.inputs = [t.clone(memory_format=torch.contiguous_format) for t in inputs]
        g.flag = torch.zeros((), dtype=torch.bool, device=dev)
        g.host_flag = torch.zeros((), dtype=torch.bool, pin_memory=True)
        g.done = torch.cuda.Event()
        g.pending = False
        with torch.cuda.device(dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), overflow_into(torch.zeros_like(g.flag)):
                fn(*g.inputs)
            torch.cuda.current_stream().wait_stream(side)
            g.graph = torch.cuda.CUDAGraph()
            with capture(g.graph, capture_error_mode="thread_local"), \
                    overflow_into(g.flag) as whats:
                g.flag.zero_()
                g.outputs = list(fn(*g.inputs))
        g.whats = list(dict.fromkeys(whats))
        return g
