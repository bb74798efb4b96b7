"""Python wrapper of the SCS env's step kernel (``csrc/scs_step.cu``).

``SCSGame.step`` launches it for a state on the card; its plain version is
the eager body ``SCSGame._step``, which the CPU takes.  No TPU kernel stands
behind it (the JAX engine's step is plain JAX; see the source's note).  The
wrapper validates the state, allocates fresh outputs (and the overflow flag,
unless the caller hands in one to set), launches on the current stream and
counts its launches; it never falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import torch

from nuzero_tpu_torch.ops.cuda.build import scs_step_library

KERNEL = "scs_step_kernel"
#: Launches of the kernel since the last ``reset_launch_count()``.
launch_count = {KERNEL: 0}
_count_lock = threading.Lock()

_I32, _F32, _BOOL = torch.int32, torch.float32, torch.bool
#: (name, dtype) of each ``SCSState`` field, in declaration order.
FIELDS = (
    ("board", _I32), ("alive", _BOOL), ("placed", _BOOL), ("row", _I32), ("col", _I32),
    ("mov", _F32), ("status", _I32), ("reinf_next", _I32), ("turn", _I32), ("stage", _I32),
    ("length", _I32), ("terminal", _BOOL), ("terminal_value", _F32), ("has_target", _BOOL),
    ("target_row", _I32), ("target_col", _I32), ("is_attacker", _BOOL),
    ("attacker_seq", _I32), ("n_attackers", _I32), ("vp", _BOOL),
)
_Pointers = ctypes.c_void_p * len(FIELDS)
_Strides = ctypes.c_longlong * len(FIELDS)


def reset_launch_count() -> None:
    with _count_lock:
        launch_count[KERNEL] = 0


def _inner_shapes(R: int, C: int, K: int, S: int) -> tuple:
    U = 2 * S
    return ((R, C, K), (U,), (U,), (U,), (U,), (U,), (U,), (2,), (), (), (), (), (), (), (),
            (), (U,), (U,), (), (2, R, C))


def _rows_contiguous(t: torch.Tensor) -> bool:
    """Whether each game's part of ``t`` (all dims after the first) is
    contiguous; the batch stride may be anything."""
    expected = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != expected:
            return False
        expected *= size
    return True


def scs_step_cuda(fields: Sequence[torch.Tensor], action: torch.Tensor, ftab: torch.Tensor,
                  itab: torch.Tensor, shape: tuple, turns: int, stage_passes: int,
                  recip_vp: tuple, overflow: Optional[torch.Tensor] = None
                  ) -> tuple[list, torch.Tensor]:
    """One step of B games on the card.

    ``fields``: the ``SCSState`` tensors in declaration order (``FIELDS``),
    each [B, ...] with each game's part contiguous (any batch stride);
    ``action`` int32 [B]; ``ftab`` (f32: terrain attack, defense, cost and
    cheapest neighbour cost per tile, then unit attack, defense, allowance) and
    ``itab`` (i32: neighbour tiles and validity per direction and tile, the
    reinforcement turns, the reinforcement counts) the env's tables;
    ``shape`` = (R, C, K, S); ``recip_vp`` the f32 reciprocals of each
    player's victory-point count.  Returns the next state's fields (fresh
    tensors) and a 0-d bool tensor set where a game's stage machine was
    still advancing after ``stage_passes`` passes beyond its first: the
    ``overflow`` handed in (the kernel only sets it, never clears it), or a
    fresh one."""
    R, C, K, S = shape
    if len(fields) != len(FIELDS):
        raise ValueError(f"scs_step_cuda takes {len(FIELDS)} state fields, got {len(fields)}")
    B = fields[0].shape[0] if fields[0].dim() else 0
    inner = _inner_shapes(R, C, K, S)
    for (name, dtype), t, shp in zip(FIELDS, fields, inner):
        if t.dtype != dtype:
            raise TypeError(f"scs_step_cuda: field {name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != (B, *shp):
            raise ValueError(f"scs_step_cuda: field {name} has shape {tuple(t.shape)}, "
                             f"expected {(B, *shp)}")
        if not _rows_contiguous(t):
            raise ValueError(f"scs_step_cuda: field {name} is not contiguous within a game "
                             f"(strides {t.stride()})")
    if action.dtype != _I32 or tuple(action.shape) != (B,):
        raise TypeError(f"scs_step_cuda: action must be int32 of shape {(B,)}, got "
                        f"{action.dtype} {tuple(action.shape)}")
    if ftab.dtype != _F32 or itab.dtype != _I32 or not (ftab.is_contiguous()
                                                         and itab.is_contiguous()):
        raise TypeError("scs_step_cuda: the tables must be contiguous f32 and i32")
    dev = fields[0].device
    if overflow is not None and (overflow.dtype != _BOOL or overflow.dim() != 0):
        raise TypeError(f"scs_step_cuda: the overflow flag must be a 0-d bool tensor, got "
                        f"{overflow.dtype} {tuple(overflow.shape)}")
    tensors = (*fields, action, ftab, itab) + (() if overflow is None else (overflow,))
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"scs_step_cuda needs the state, action and tables on one CUDA "
                         f"device, got the board on {dev}")
    lib = scs_step_library()
    outs = [torch.empty((B, *shp), dtype=dtype, device=dev)
            for (_, dtype), shp in zip(FIELDS, inner)]
    if overflow is None:
        overflow = torch.zeros((), dtype=_BOOL, device=dev)
    err = lib.scs_step(
        _Pointers(*(t.data_ptr() for t in fields)), _Strides(*(t.stride(0) for t in fields)),
        _Pointers(*(t.data_ptr() for t in outs)), action.data_ptr(), action.stride(0),
        ftab.data_ptr(), itab.data_ptr(), overflow.data_ptr(),
        B, R, C, K, S, turns, stage_passes, recip_vp[0], recip_vp[1],
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"scs_step launch failed: CUDA error {err}")
    with _count_lock:
        launch_count[KERNEL] += 1
    return outs, overflow
