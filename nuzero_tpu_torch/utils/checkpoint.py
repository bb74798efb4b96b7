"""Checkpoints in torch's own format (counterpart of
``nuzero_tpu/utils/checkpoint.py``; ref ``Utils/Functions/loading_utlis.py``).

A checkpoint is one ``torch.save`` of the training tree (nested dicts of
tensors and numbers: params, optimizer state, update count and, optionally,
the replay buffer) at ``<root>/step_<step>.pt``, with ``'auto'`` discovery
of the latest step.  A ``FORMAT`` file beside them carries the tree-layout
version; a restore of another version, or of a tree whose leaf shapes
differ from the caller's target, fails with a message naming the leaves.
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


def save_checkpoint(root: str, step: int, tree: Any) -> str:
    os.makedirs(root, exist_ok=True)
    path = _ckpt_path(root, step)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    with open(_format_path(root), "w") as f:
        f.write(f"{FORMAT_VERSION}\n")
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
    return _to(tree, device), int(step)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
