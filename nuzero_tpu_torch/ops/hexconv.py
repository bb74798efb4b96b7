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

``hex_conv`` applies ``HexConvFunction``: a CPU tensor goes to the plain
PyTorch versions below, a CUDA tensor to the hand-written kernels
(``ops/cuda``), forward and backward alike.  A tensor on the ``meta``
device, which holds shapes and no data, takes the plain versions too: the
training pipeline counts a forward's FLOPs that way (``NUZERO_MFU``),
launching nothing.  The backward is the JAX
package's VJP of the same function (``nuzero_tpu/ops/hexconv.py:188-211``):

* dX is a hex conv of dY with the mirrored taps (``mirror_taps``): the hex
  neighbour relation is symmetric, q = nbr_t(p) exactly when
  p = nbr_opp(t)(q) with opp swapping n/s, ne/sw and se/nw, so
  dX[q] = sum_s dY[nbr_s(q)] W[opp(s)]^T, off-board taps reading zero;
* dW[t] = A_t^T dY with A_t[m] = x[nbr_t(m)], a reduction over all pixels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nuzero_tpu_torch.ops.cuda.hexconv_kernel import hex_conv_cuda, hex_conv_dw_cuda

#: The devices whose tensors take the plain versions; every other device's
#: tensors take the kernels.
PLAIN_DEVICES = ("cpu", "meta")

#: tap -> (row_offset, col_offset) per column parity
HEX_DIRECTIONS = ("c", "n", "ne", "se", "s", "sw", "nw")
#: The opposite of each tap, in tap order: c<->c, n<->s, ne<->sw, se<->nw.
OPPOSITE_TAP = (0, 4, 5, 6, 1, 2, 3)

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


def _gather_taps(x: torch.Tensor) -> torch.Tensor:
    """The tap matrix ``[B*H*W, 7*Cin]`` of NHWC ``x``: row m holds the 7
    parity-correct neighbours of pixel m, zero off the board."""
    B, H, W, Cin = x.shape
    rows, cols = _tap_index(H, W)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))  # [B, H+2, W+2, Cin]
    taps = xp[:, torch.from_numpy(rows).to(x.device),
              torch.from_numpy(cols).to(x.device)]  # [B, 7, H, W, Cin]
    return taps.permute(0, 2, 3, 1, 4).reshape(B * H * W, 7 * Cin)


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
    y = _gather_taps(x) @ weights.reshape(7 * Cin, Cout)
    return y.reshape(B, H, W, Cout).to(out_dtype)


def hex_conv_depthwise(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Per-channel (depthwise) hex conv of NHWC ``x`` [B, H, W, C] with
    ``weights`` [7, C]: y[..., c] = sum_t x[nbr_t(p), c] * W[t, c], the hex
    conv's tap order, column parity and zero off the board (counterpart of
    ``nuzero_tpu/ops/hexconv.py:hex_conv_depthwise``, plain XLA there: no
    hand-written kernel exists for it on either side).

    A sum over the 7 taps of shifted slices of the zero-padded board, each
    column taking its parity's shift: elementwise f32 arithmetic, so no
    library conv (and no TF32) is involved on any device, and its backward
    (slices, ``where``, sums) is deterministic.  bf16 inputs are computed
    in f32 and rounded once to bf16, as the JAX function does off the TPU;
    f64 inputs stay f64."""
    B, H, W, C = x.shape
    if tuple(weights.shape) != (7, C):
        raise ValueError(f"weights {tuple(weights.shape)} != (7, {C})")
    out_dtype = x.dtype
    compute = torch.promote_types(x.dtype, torch.float32)
    x, weights = x.to(compute), weights.to(compute)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))  # [B, H+2, W+2, C]
    odd = (torch.arange(W, device=x.device) % 2 == 1).view(1, 1, W, 1)
    even_offs, odd_offs = hex_neighbor_offsets(0), hex_neighbor_offsets(1)
    y = None
    for t in range(7):
        shifted = [xp[:, 1 + dr:1 + dr + H, 1 + dc:1 + dc + W]
                   for dr, dc in (even_offs[t], odd_offs[t])]
        if tuple(even_offs[t]) != tuple(odd_offs[t]):
            shifted[0] = torch.where(odd, shifted[1], shifted[0])
        term = shifted[0] * weights[t]
        y = term if y is None else y + term
    return y.to(out_dtype)


def mirror_taps(weights: torch.Tensor) -> torch.Tensor:
    """``W'[s] = W[opp(s)]^T``, ``[7, Cout, Cin]``: the weights whose hex
    conv of dY is dX."""
    return weights[list(OPPOSITE_TAP)].transpose(1, 2).contiguous()


def hex_conv_dx_plain(dy: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Plain dX of the hex conv: the plain hex conv of dY with the mirrored
    taps, in dY's dtype."""
    return hex_conv_plain(dy, mirror_taps(weights))


def hex_conv_dw_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain dW of the hex conv, ``[7, Cin, Cout]``: the gathered tap matrix
    transposed times dY, ``[M, 7*Cin]^T @ [M, Cout]`` in f32, cast once to
    the operands' dtype."""
    Cin, Cout = x.shape[-1], dy.shape[-1]
    dw = _gather_taps(x.float()).t() @ dy.float().reshape(-1, Cout)
    return dw.reshape(7, Cin, Cout).to(x.dtype)


class HexConvFunction(torch.autograd.Function):
    """The hex conv with its backward on the same device path as its
    forward: the plain versions for CPU (and meta) tensors, the CUDA
    kernels for CUDA tensors (dX on the forward kernel with ``mirror_taps``, dW on the dW
    kernel), which raise rather than fall back.  dX and dW come out in the
    operands' dtype, as the JAX VJP through the bf16 casts gives them.
    dX is computed only where the input needs it (a network's stem reads
    the observation, which does not)."""

    @staticmethod
    def forward(ctx, x, weights):
        ctx.save_for_backward(x, weights)
        if x.device.type in PLAIN_DEVICES:
            return hex_conv_plain(x, weights)
        return hex_conv_cuda(x, weights)

    @staticmethod
    def backward(ctx, dy):
        x, weights = ctx.saved_tensors
        dy = dy.contiguous()
        cpu = x.device.type in PLAIN_DEVICES
        dx = dw = None
        # dW before dX: on the card, every forward-kernel launch after an
        # update's first dW launch is then a dX (chip_smoke.py's profile
        # splits the forward kernel's time that way).
        if ctx.needs_input_grad[1]:
            dw = hex_conv_dw_plain(x, dy) if cpu else hex_conv_dw_cuda(x, dy)
        if ctx.needs_input_grad[0]:
            dx = hex_conv_dx_plain(dy, weights) if cpu else hex_conv_cuda(dy, mirror_taps(weights))
        return dx, dw


def hex_conv(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """NHWC hex conv, differentiable: the plain version for CPU tensors,
    the CUDA kernels for CUDA tensors (which raise rather than fall back)."""
    return HexConvFunction.apply(x, weights)
