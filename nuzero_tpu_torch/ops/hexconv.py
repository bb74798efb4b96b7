"""Hexagonal convolution on offset-coordinate hex grids (HexagDLy semantics).

Counterpart of ``nuzero_tpu/ops/hexconv.py``.  Boards are rectangular
tensors in offset coordinates: columns are vertical, and the vertical
placement of a column's neighbors depends on the column's parity:

    n  = (r-1, c)            s  = (r+1, c)
    even column c:  ne=(r-1,c+1)  se=(r,c+1)   sw=(r,c-1)   nw=(r-1,c-1)
    odd  column c:  ne=(r,c+1)    se=(r+1,c+1) sw=(r+1,c-1) nw=(r,c-1)

A hex conv has one weight matrix per tap, taps ordered
[center, n, ne, se, s, sw, nw], zero padding at the board edge and no bias.
Activations are NHWC and weights ``[7, Cin, Cout]``, as in the JAX package.

``hex_conv`` sends a CPU tensor to the plain PyTorch version below and a
CUDA tensor to the hand-written kernel (``ops/cuda``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nuzero_tpu_torch.ops.cuda.hexconv_kernel import hex_conv_cuda

#: tap -> (row_offset, col_offset) per column parity
HEX_DIRECTIONS = ("c", "n", "ne", "se", "s", "sw", "nw")

_OFFSETS_EVEN = {
    "c": (0, 0),
    "n": (-1, 0),
    "ne": (-1, 1),
    "se": (0, 1),
    "s": (1, 0),
    "sw": (0, -1),
    "nw": (-1, -1),
}
_OFFSETS_ODD = {
    "c": (0, 0),
    "n": (-1, 0),
    "ne": (0, 1),
    "se": (1, 1),
    "s": (1, 0),
    "sw": (1, -1),
    "nw": (0, -1),
}


def hex_neighbor_offsets(parity: int) -> np.ndarray:
    """(7, 2) int array of (dr, dc) offsets for a column of given parity."""
    table = _OFFSETS_ODD if parity % 2 else _OFFSETS_EVEN
    return np.array([table[d] for d in HEX_DIRECTIONS], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _tap_index(rows: int, cols: int) -> tuple[np.ndarray, np.ndarray]:
    """Row/col indices [7, rows, cols] of each tap into the board padded by
    one cell on every side (padding cells are zero)."""
    r = np.arange(rows)[:, None]
    c = np.arange(cols)[None, :]
    offs = np.stack([hex_neighbor_offsets(0), hex_neighbor_offsets(1)])
    par = np.broadcast_to(c % 2, (rows, cols))
    dr = offs[par, :, 0].transpose(2, 0, 1)  # [7, rows, cols]
    dc = offs[par, :, 1].transpose(2, 0, 1)
    return (r + dr + 1).astype(np.int64), (c + dc + 1).astype(np.int64)


def hex_conv_plain(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch hex conv: gather the 7 parity-correct taps into a
    ``[B*H*W, 7*Cin]`` matrix and do one matmul with ``[7*Cin, Cout]``.

    bf16 inputs are computed in f32 and cast back (f32 accumulation, like
    the JAX package off the TPU, ``nuzero_tpu/ops/hexconv.py:128-132``)."""
    B, H, W, Cin = x.shape
    Cout = weights.shape[-1]
    out_dtype = x.dtype
    if x.dtype != torch.float32:
        x = x.float()
        weights = weights.float()
    rows, cols = _tap_index(H, W)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))  # [B, H+2, W+2, Cin]
    taps = xp[:, torch.from_numpy(rows).to(x.device),
              torch.from_numpy(cols).to(x.device)]  # [B, 7, H, W, Cin]
    taps = taps.permute(0, 2, 3, 1, 4).reshape(B * H * W, 7 * Cin)
    y = taps @ weights.reshape(7 * Cin, Cout)
    return y.reshape(B, H, W, Cout).to(out_dtype)


def hex_conv(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """NHWC hex conv: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (which raises rather than fall back)."""
    if x.device.type == "cpu":
        return hex_conv_plain(x, weights)
    return hex_conv_cuda(x, weights)

