"""Network building blocks (counterpart of ``nuzero_tpu/networks/blocks.py``).

Activations are NHWC, as in the JAX package.  All convolutions are
bias-free.  ``hex=True`` selects the hexagonal convolution (one hex ring,
``ops.hexconv.hex_conv``); ``hex=False`` a 3x3 'same' ortho conv.
Parameters are f32; ``dtype`` is the compute dtype (bf16 runs the convs in
bf16 with f32 accumulation).  Filter ramps reproduce the reference's
``int(width + k*step)`` arithmetic so parameter shapes line up.

Only the ``"reduce"`` value head is ported so far.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
from torch import nn

from nuzero_tpu_torch.ops.hexconv import hex_conv


def _ramp(start: int, end: int, num_layers: int) -> Sequence[int]:
    """Reference filter-ramp arithmetic (ref ``blocks.py:56-61``)."""
    step = (end - start) / num_layers
    sizes = []
    prev = float(start)
    for _ in range(num_layers):
        prev = prev + step
        sizes.append(int(prev))
    return sizes


def init_conv_weight_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """The JAX package's conv initializer, variance_scaling(1/3, fan_in,
    uniform), in place.  Hex weights are [7, Cin, Cout] (fan_in 7*Cin),
    ortho weights OIHW (fan_in Cin*k*k)."""
    fan_in = w.shape[0] * w.shape[1] if w.dim() == 3 else w[0].numel()
    bound = (1.0 / fan_in) ** 0.5
    with torch.no_grad():
        return w.uniform_(-bound, bound, generator=generator)


class HexConv(nn.Module):
    """Hexagonal convolution layer, NHWC, weight ``[7, Cin, Cout]``."""

    def __init__(self, in_features: int, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(7, in_features, features))
        init_conv_weight_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hex_conv(x.to(self.dtype), self.weight.to(self.dtype))


@contextlib.contextmanager
def _cudnn_without_tf32():
    """cuDNN computes f32 convolutions in TF32 unless told otherwise
    (torch's default is ``torch.backends.cudnn.allow_tf32 = True``), which
    keeps about three digits; the JAX package and the hex path compute in
    full f32.  Turns TF32 off for the block and restores the caller's flag."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = prev


class OrthoConv(nn.Module):
    """k x k 'same' conv on NHWC activations, weight OIHW.  In f32 on the
    card it computes in full f32 whatever the process-wide TF32 flags say."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel_size, kernel_size)
        )
        init_conv_weight_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        full_f32 = x.is_cuda and self.dtype == torch.float32
        with _cudnn_without_tf32() if full_f32 else contextlib.nullcontext():
            y = nn.functional.conv2d(x, self.weight.to(self.dtype), padding="same")
        return y.permute(0, 2, 3, 1).contiguous()


class Conv(nn.Module):
    """Hex-or-ortho conv selector used by every stack."""

    def __init__(self, in_features: int, features: int, hex: bool = True,
                 kernel_size: int = 3, dtype=torch.float32):
        super().__init__()
        if hex:
            self.conv = HexConv(in_features, features, dtype=dtype)
        else:
            self.conv = OrthoConv(in_features, features, kernel_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class BasicBlock(nn.Module):
    """Residual block: conv -> relu -> conv, + identity, relu
    (ref ``blocks.py:12-41``)."""

    def __init__(self, channels: int, hex: bool = True, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(channels, channels, hex=hex, dtype=dtype)
        self.conv2 = Conv(channels, channels, hex=hex, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.conv1(x))
        out = self.conv2(out)
        return torch.relu(out + x)


class ReduceValueHead(nn.Module):
    """Conv filter-ramp down to 1 channel, global mean over (H, W, C),
    tanh (ref ``blocks.py:46-92``).  Returns [B]."""

    def __init__(self, width: int, num_reduce_layers: int = 4,
                 activation: str = "tanh", hex: bool = True, dtype=torch.float32):
        super().__init__()
        self.act = {"tanh": torch.tanh, "relu": torch.relu}[activation]
        sizes = _ramp(width, 1, num_reduce_layers)
        ins = [width] + list(sizes[:-1])
        self.convs = nn.ModuleList(
            Conv(i, o, hex=hex, dtype=dtype) for i, o in zip(ins, sizes)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i != len(self.convs) - 1:
                x = self.act(x)
        return torch.tanh(x.mean(dim=(1, 2, 3)))


class ReducePolicyHead(nn.Module):
    """Conv filter-ramp from trunk width down to the action-plane count
    (ref ``blocks.py:130-170``).  Returns flat logits [B, planes*H*W] in
    (plane, row, col) order."""

    def __init__(self, width: int, policy_channels: int,
                 num_reduce_layers: int = 2, hex: bool = True, dtype=torch.float32):
        super().__init__()
        sizes = _ramp(width, policy_channels, num_reduce_layers)
        ins = [width] + list(sizes[:-1])
        self.convs = nn.ModuleList(
            Conv(i, o, hex=hex, dtype=dtype) for i, o in zip(ins, sizes)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i != len(self.convs) - 1:
                x = torch.relu(x)
        # NHWC -> NCHW -> flat, so logits ravel as (plane, row, col).
        return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


def make_value_head(name: str, width: int, *, activation: str = "tanh",
                    hex: bool = True, dtype=torch.float32) -> nn.Module:
    """Value head by selector string (ref RecurrentNet.py:58-76)."""
    if name != "reduce":
        raise ValueError(f"value head {name!r} is not ported; options: ['reduce']")
    return ReduceValueHead(width, activation=activation, hex=hex, dtype=dtype)
