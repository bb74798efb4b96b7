"""Checkpoints in torch's own format (counterpart of
``nuzero_tpu/utils/checkpoint.py``; ref ``Utils/Functions/loading_utlis.py``).

A checkpoint is one ``torch.save`` of the training tree (nested dicts of
tensors and numbers: params, optimizer state, update count and, optionally,
the replay buffer) at ``<root>/step_<step>.pt``, with ``'auto'`` discovery
of the latest step.  A ``FORMAT`` file beside them carries the tree-layout
version; a restore of another version, or of a tree whose leaf shapes
differ from the caller's target, fails with a message naming the leaves.

A data-parallel run (``parallel/mesh.py``) writes a step's checkpoint once:
every rank writes its own replay ring to ``step_<step>.ring<r>-of-<N>.pt``,
then rank 0 alone writes the params, the optimizer state and the update
count, with ``world_size`` N, to ``step_<step>.pt``, after every ring.  A
resume at the same world size reads each rank's ring back
(``restore_ring``); the params and optimizer state restore in one process
as any checkpoint's do.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

# Tree-layout version of the port's checkpoints; bumped when the saved tree
# changes incompatibly.
FORMAT_VERSION = 1


def _ckpt_path(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), f"step_{step:08d}.pt")


def _format_path(root: str) -> str:
    return os.path.join(os.path.abspath(root), "FORMAT")


def ring_path(root: str, step: int, rank: int, world_size: int) -> str:
    """Where rank ``rank`` of ``world_size`` keeps its replay ring of ``step``."""
    return os.path.join(os.path.abspath(root),
                        f"step_{step:08d}.ring{rank}-of-{world_size}.pt")


def _write(path: str, tree: Any) -> None:
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def save_checkpoint(root: str, step: int, tree: Any, mesh=None, ring: Any = None) -> str:
    """Write ``tree`` as the checkpoint of ``step`` -> its path.  With a
    ``mesh``, every rank calls this with its own replay ``ring`` (or None):
    each writes its ring, and after every rank has, rank 0 alone writes
    ``tree`` with ``world_size``; every rank returns once it is written."""
    os.makedirs(root, exist_ok=True)
    path = _ckpt_path(root, step)
    if mesh is not None:
        if ring is not None:
            _write(ring_path(root, step, mesh.rank, mesh.size), ring)
        mesh.barrier()
        tree = {**tree, "world_size": mesh.size}
    if mesh is None or mesh.rank == 0:
        _write(path, tree)
        with open(_format_path(root), "w") as f:
            f.write(f"{FORMAT_VERSION}\n")
    if mesh is not None:
        mesh.barrier()
    return path


def latest_step(root: str) -> Optional[int]:
    """'auto' discovery (ref ``loading_utlis.py:21-24``)."""
    if not os.path.isdir(root):
        return None
    steps = [int(m.group(1)) for name in os.listdir(root)
             if (m := re.fullmatch(r"step_(\d+)\.pt", name))]
    return max(steps) if steps else None


def _shapes(tree, prefix=()):
    """{path: shape} of the leaves of a tree of dicts; numbers are ()."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, prefix + (str(k),)))
        return out
    return {prefix: tuple(getattr(tree, "shape", ()))}


def restore_checkpoint(root: str, step: int | str = "auto", target: Any = None,
                       device="cuda"):
    """Restore the tree saved at ``step`` ('auto' = latest) onto ``device``
    -> (tree, step).  With ``target``, every leaf both trees hold must have
    the target's shape."""
    if step == "auto":
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    path = _ckpt_path(root, int(step))
    fmt_file = _format_path(root)
    if os.path.exists(fmt_file):
        with open(fmt_file) as f:
            saved_fmt = int(f.read().strip() or 0)
        if saved_fmt != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint at {path} was saved with tree-layout version "
                f"{saved_fmt}; this build reads version {FORMAT_VERSION}. "
                "Re-train or convert the run."
            )
    return _load(path, target, device), int(step)


def restore_ring(root: str, step: int, mesh, target: Any = None, device="cuda"):
    """Rank ``mesh.rank``'s replay ring of ``step``, written by a run of
    ``mesh.size`` ranks, onto ``device``; held to ``target``'s shapes as
    ``restore_checkpoint`` holds a tree.  A ring of another world size is
    refused."""
    path = ring_path(root, int(step), mesh.rank, mesh.size)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no replay ring of rank {mesh.rank} of {mesh.size} at step {step} under {root} "
            "(a data-parallel run resumes its buffer at the world size that wrote it)")
    return _load(path, target, device)


def _load(path: str, target, device):
    tree = torch.load(path, map_location="cpu", weights_only=True)
    if target is not None:
        saved, want = _shapes(tree), _shapes(target)
        mismatches = [
            f"{'/'.join(p)}: checkpoint {saved[p]} vs this build {want[p]}"
            for p in sorted(set(saved) & set(want)) if saved[p] != want[p]
        ]
        if mismatches:
            raise ValueError(
                f"checkpoint at {path} does not match this build's array layout: "
                + "; ".join(mismatches[:8])
                + (f" (+{len(mismatches) - 8} more)" if len(mismatches) > 8 else "")
            )
    return _to(tree, device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
