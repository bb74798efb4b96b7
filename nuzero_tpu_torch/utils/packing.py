"""Pack batch-first env-state dataclasses into flat f32 rows.

Counterpart of ``nuzero_tpu/utils/packing.py``.  MCTS stores one env state
per tree node as a row of a ``[B, N, D]`` f32 table.  Fields are packed in
dataclass declaration order (the JAX packer's ``jax.tree.leaves`` order),
each flattened C-order, so packed vectors compare exactly with the JAX
package's.  int/bool fields are value-cast to f32, exact for magnitudes
below 2^24 (the largest value stored is the 10^6 sentinel).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch

_OK_DTYPES = {torch.float32, torch.int32, torch.int8, torch.bool}


def make_packer(
    template: Any,
) -> Tuple[Callable[[Any], torch.Tensor], Callable[[torch.Tensor], Any], int]:
    """Build (pack, unpack, dim) for batches shaped like ``template``
    (any batch size; the template's own batch size is ignored)."""
    specs = []
    offset = 0
    for f in dataclasses.fields(template):
        leaf = getattr(template, f.name)
        if leaf.dtype not in _OK_DTYPES:
            raise TypeError(f"unpackable field {f.name} of dtype {leaf.dtype}")
        shape = tuple(leaf.shape[1:])
        size = math.prod(shape)
        specs.append((f.name, shape, leaf.dtype, offset, size))
        offset += size
    dim = offset
    cls = type(template)

    def pack(state) -> torch.Tensor:
        parts = []
        for name, _, _, _, _ in specs:
            leaf = getattr(state, name)
            parts.append(leaf.reshape(leaf.shape[0], -1).to(torch.float32))
        return torch.cat(parts, dim=1)

    def unpack(vec: torch.Tensor):
        B = vec.shape[0]
        out = {}
        for name, shape, dtype, off, size in specs:
            part = vec[:, off : off + size].reshape((B,) + shape)
            out[name] = part != 0 if dtype == torch.bool else part.to(dtype)
        return cls(**out)

    return pack, unpack, dim
