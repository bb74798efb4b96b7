"""Python wrapper of the PUCT descent kernel (``csrc/search_descend.cu``).

``mcts._descend`` launches it for a tree on the card; its plain version is
the eager body ``mcts._descend_plain``, which the CPU takes.  No TPU kernel
stands behind it (the JAX descent is a plain ``lax.while_loop``; see the
source's note).  The wrapper validates the tree's tensors, allocates fresh
outputs, launches on the current stream and counts its launches; it never
falls back to another implementation.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from nuzero_tpu_torch.ops.cuda.build import search_descend_library

KERNEL = "search_descend_kernel"
#: Launches of the kernel since the last ``reset_launch_count()``.
launch_count = {KERNEL: 0}
_count_lock = threading.Lock()

#: The most nodes a tree may hold: one game's visit and value-sum rows
#: (8 bytes a node) in the card's 227 KB of shared memory a block.
MAX_NODES = 232448 // 8

_I32, _F32, _BOOL = torch.int32, torch.float32, torch.bool


def reset_launch_count() -> None:
    with _count_lock:
        launch_count[KERNEL] = 0


def search_descend_cuda(root, visit, value_sum, to_play, expanded, is_terminal, prior, legal,
                        child, depth_cap: int, pb_c_base: float, pb_c_init: float,
                        value_factor: float) -> tuple:
    """Every game's PUCT walk from ``root`` to the node where its simulation
    stops, on the card: ``mcts._descend_plain`` bit for bit.

    The tree's tensors as ``search.tree.Tree`` holds them, each contiguous:
    ``root`` int32 [B]; ``visit``, ``to_play`` int32, ``value_sum`` f32,
    ``expanded``, ``is_terminal`` bool, each [B, N]; ``prior`` f32,
    ``legal`` bool, ``child`` int32, each [B, N, A].  The PUCT constants are
    rounded to f32 here, as the eager body's scalars are.  Returns fresh
    tensors (stop_node int32 [B], sel_action int32 [B], needs_alloc bool
    [B], path int32 [B, depth_cap] with N in unused slots, capped bool [B])."""
    B, N, A = (t.shape[-1] if t.dim() else 0 for t in (root, visit, prior))
    specs = (("root", root, _I32, (B,)), ("visit", visit, _I32, (B, N)),
             ("value_sum", value_sum, _F32, (B, N)), ("to_play", to_play, _I32, (B, N)),
             ("expanded", expanded, _BOOL, (B, N)), ("is_terminal", is_terminal, _BOOL, (B, N)),
             ("prior", prior, _F32, (B, N, A)), ("legal", legal, _BOOL, (B, N, A)),
             ("child", child, _I32, (B, N, A)))
    for name, t, dtype, shape in specs:
        if t.dtype != dtype:
            raise TypeError(f"search_descend_cuda: {name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"search_descend_cuda: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"search_descend_cuda: {name} is not contiguous "
                             f"(strides {t.stride()})")
    if min(B, N, A) < 1:
        raise ValueError(f"search_descend_cuda: an empty tree (B, N, A) = {(B, N, A)}")
    if N > MAX_NODES:
        raise ValueError(f"search_descend_cuda: a tree of {N} nodes passes the {MAX_NODES} "
                         f"whose statistics fit one block's shared memory")
    if depth_cap < 1:
        raise ValueError(f"search_descend_cuda: depth_cap must be >= 1, got {depth_cap}")
    dev = root.device
    if dev.type != "cuda" or any(t.device != dev for _, t, _, _ in specs):
        raise ValueError(f"search_descend_cuda needs the tree on one CUDA device, got its "
                         f"root on {dev}")
    lib = search_descend_library()
    stop_node = torch.empty(B, dtype=_I32, device=dev)
    sel_action = torch.empty(B, dtype=_I32, device=dev)
    needs_alloc = torch.empty(B, dtype=_BOOL, device=dev)
    path = torch.empty((B, depth_cap), dtype=_I32, device=dev)
    capped = torch.empty(B, dtype=_BOOL, device=dev)
    f32 = np.float32
    err = lib.search_descend(
        root.data_ptr(), visit.data_ptr(), value_sum.data_ptr(), to_play.data_ptr(),
        expanded.data_ptr(), is_terminal.data_ptr(), prior.data_ptr(), legal.data_ptr(),
        child.data_ptr(), stop_node.data_ptr(), sel_action.data_ptr(), needs_alloc.data_ptr(),
        path.data_ptr(), capped.data_ptr(), B, N, A, depth_cap,
        float(f32(pb_c_base)), float(f32(1.0) / f32(pb_c_base)), float(f32(pb_c_init)),
        float(f32(value_factor)), torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"search_descend launch failed: CUDA error {err}")
    with _count_lock:
        launch_count[KERNEL] += 1
    return stop_node, sel_action, needs_alloc, path, capped
