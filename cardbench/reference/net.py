"""Plain reference of the hex RecurrentNet (DeepThinking with recall), f32.

The forward is the port's ``networks/recurrent.py`` written out on a dict of
parameters under the port's names: the stem, the recurrent cell (recall
conv on the thought concatenated with the observation, then 2 BasicBlocks)
applied ``iterations`` times with shared weights, the reduce policy head
(filter ramp to the action planes, relu between) and the reduce value head
(ramp to 1 channel, tanh between, tanh of the global mean).  The hex conv
is a frozen copy of the port's ``ops/hexconv.py:hex_conv_plain``: the 7
parity-correct taps gathered into one matrix and one product.

``quant`` selects the precision of every product's inputs: None computes
in f32 (TF32 off); ``"tf32"`` rounds both inputs to TF32's 10-bit mantissa
(the tensor cores' TF32 path) and ``"fp8"`` to float8 e4m3 with one scale
per tensor; the products then accumulate in f32.  Those two are the
controls: the precision one step below each configuration's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# tap -> (row_offset, col_offset) for even and odd columns, taps ordered
# [center, n, ne, se, s, sw, nw] (HexagDLy's offset coordinates).
_OFFSETS = {
    0: ((0, 0), (-1, 0), (-1, 1), (0, 1), (1, 0), (0, -1), (-1, -1)),
    1: ((0, 0), (-1, 0), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1)),
}


@functools.lru_cache(maxsize=None)
def _tap_index(rows: int, cols: int):
    r = np.arange(rows)[:, None]
    c = np.arange(cols)[None, :]
    offs = np.array([_OFFSETS[0], _OFFSETS[1]])  # [2, 7, 2]
    par = np.broadcast_to(c % 2, (rows, cols))
    dr = offs[par, :, 0].transpose(2, 0, 1)
    dc = offs[par, :, 1].transpose(2, 0, 1)
    return (r + dr + 1).astype(np.int64), (c + dc + 1).astype(np.int64)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to nearest-even at TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """f32 through float8 e4m3 with one scale per tensor (its largest
    magnitude onto e4m3's largest finite, 448)."""
    amax = x.abs().max().clamp(min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


QUANT = {None: lambda x: x, "tf32": _round_tf32, "fp8": _round_fp8}


def _rounded(x: torch.Tensor, quant) -> torch.Tensor:
    """``x`` rounded to ``quant``; its gradient passes straight through."""
    if quant is None:
        return x
    return x + (QUANT[quant](x.detach()) - x).detach()


def hex_conv(x: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    """NHWC ``x`` [B, H, W, Cin] by hex weights ``w`` [7, Cin, Cout], f32."""
    B, H, W, Cin = x.shape
    rows, cols = _tap_index(H, W)
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    taps = xp[:, torch.from_numpy(rows).to(x.device), torch.from_numpy(cols).to(x.device)]
    a = taps.permute(0, 2, 3, 1, 4).reshape(B * H * W, 7 * Cin)
    y = _rounded(a, quant) @ _rounded(w.float().reshape(7 * Cin, -1), quant)
    return y.reshape(B, H, W, -1)


def recurrent_forward(params, obs: torch.Tensor, iterations: int, quant=None,
                      detach_at=None, limit=None):
    """(policy logits [B, A], value [B]) of observations ``obs`` [B, C, H, W]
    at ``iterations``, f32.  ``detach_at`` / ``limit`` are the progressive
    loss's: the thought is detached at iteration ``detach_at`` and the loop
    stops at ``limit`` iterations."""
    def conv(name, x):
        return hex_conv(x, params[name], quant)

    x = obs.permute(0, 2, 3, 1).float()
    thought = torch.relu(conv("stem.conv.weight", x))
    blocks = sorted({k.split(".")[2] for k in params if k.startswith("cell.blocks.")})
    limit = iterations if limit is None else limit
    for i in range(min(int(iterations), int(limit))):
        if i == detach_at:
            thought = thought.detach()
        h = conv("cell.recall.conv.weight", torch.cat([thought, x], dim=-1))
        for b in blocks:
            out = torch.relu(conv(f"cell.blocks.{b}.conv1.conv.weight", h))
            out = conv(f"cell.blocks.{b}.conv2.conv.weight", out)
            h = torch.relu(out + h)
        thought = h
    p = thought
    n_pol = len([k for k in params if k.startswith("policy_head.convs.")])
    for i in range(n_pol):
        p = conv(f"policy_head.convs.{i}.conv.weight", p)
        if i != n_pol - 1:
            p = torch.relu(p)
    v = thought
    n_val = len([k for k in params if k.startswith("value_head.convs.")])
    for i in range(n_val):
        v = conv(f"value_head.convs.{i}.conv.weight", v)
        if i != n_val - 1:
            v = torch.tanh(v)
    logits = p.permute(0, 3, 1, 2).reshape(p.shape[0], -1)
    value = torch.tanh(v.mean(dim=(1, 2, 3)))
    return logits, value


def masked_log_priors(logits: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """log of the search's priors: softmax over the legal actions (the
    port's mask-and-renormalize), -inf off them; float64."""
    z = torch.where(legal, logits.double(), float("-inf"))
    return z - torch.logsumexp(z, dim=-1, keepdim=True)


def evaluate(params, obs, iterations, quant=None, block: int = 2048):
    """``recurrent_forward`` in blocks of ``block`` rows, without autograd."""
    logits, values = [], []
    with torch.no_grad():
        for s in range(0, obs.shape[0], block):
            lg, v = recurrent_forward(params, obs[s:s + block], iterations, quant)
            logits.append(lg)
            values.append(v)
    return torch.cat(logits), torch.cat(values)
