"""Network building blocks (counterpart of ``nuzero_tpu/networks/blocks.py``).

Activations are NHWC, as in the JAX package.  All convolutions are
bias-free.  ``hex=True`` selects the hexagonal convolution (one hex ring,
``ops.hexconv.hex_conv``); ``hex=False`` a 3x3 'same' ortho conv.
Parameters are f32; ``dtype`` is the compute dtype (bf16 runs the convs in
bf16 with f32 accumulation).  Filter ramps reproduce the reference's
``int(width + k*step)`` arithmetic so parameter shapes line up.

``BatchNorm`` is Flax's ``nn.BatchNorm`` as the JAX nets apply it outside
training: the running mean and variance (buffers) normalize, epsilon 1e-5.
The value heads ported are ``"reduce"`` and ``"dense"``.
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


def init_dense_weight_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """Flax's Dense initializer, lecun_normal (variance_scaling(1, fan_in,
    truncated_normal)), in place on a weight ``[out, in]``: a normal
    truncated at two standard deviations, rescaled to variance 1/fan_in."""
    std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


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


class Dense(nn.Module):
    """Flax's ``nn.Dense``: ``x @ kernel + bias`` with the weight stored as
    torch's ``[out, in]``; f32 parameters, computed in ``dtype``."""

    def __init__(self, in_features: int, features: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None
        init_dense_weight_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The bias is added after the product is rounded to ``dtype``, as
        # Flax does (a fused addmm would round once, off by a bf16 step).
        y = nn.functional.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm(use_running_average=True)`` over the channels of
    NHWC activations: ``(x - mean) * (rsqrt(var + 1e-5) * scale) + bias`` in
    f32, returned in ``dtype``.  The running mean and variance are buffers;
    nothing here updates them (the JAX learner cannot train a BatchNorm net
    either, see ``training/learner.py``)."""

    eps = 1e-5

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean) * mul + self.bias).to(self.dtype)


def _norm(batch_norm: bool, features: int, dtype):
    return BatchNorm(features, dtype) if batch_norm else nn.Identity()


class BasicBlock(nn.Module):
    """Residual block: conv -> (BN) -> relu -> conv, + identity, relu
    (ref ``blocks.py:12-41``)."""

    def __init__(self, channels: int, batch_norm: bool = False, hex: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(channels, channels, hex=hex, dtype=dtype)
        self.norm = _norm(batch_norm, channels, dtype)
        self.conv2 = Conv(channels, channels, hex=hex, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.norm(self.conv1(x)))
        out = self.conv2(out)
        return torch.relu(out + x)


class ReduceValueHead(nn.Module):
    """Conv filter-ramp down to 1 channel, global mean over (H, W, C),
    tanh (ref ``blocks.py:46-92``).  Returns [B]."""

    def __init__(self, width: int, num_reduce_layers: int = 4,
                 activation: str = "tanh", batch_norm: bool = False, hex: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.act = {"tanh": torch.tanh, "relu": torch.relu}[activation]
        sizes = _ramp(width, 1, num_reduce_layers)
        ins = [width] + list(sizes[:-1])
        self.convs = nn.ModuleList(
            Conv(i, o, hex=hex, dtype=dtype) for i, o in zip(ins, sizes)
        )
        # One BatchNorm after each conv but the last (Flax BatchNorm_{i}).
        self.norms = nn.ModuleList(_norm(batch_norm, o, dtype) for o in sizes[:-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i != len(self.convs) - 1:
                x = self.act(self.norms[i](x))
        return torch.tanh(x.mean(dim=(1, 2, 3)))


class DenseValueHead(nn.Module):
    """conv -> (BN) -> flatten -> relu -> dense -> relu -> dense(1) -> tanh
    (ref ``blocks.py:97-125``; all layers bias-free).  The flatten is over
    NHWC, so the first dense layer's width needs the board's
    ``board_shape`` (H, W) up front."""

    def __init__(self, width: int, board_shape, dense_layer_neurons: int = 256,
                 conv_layer_channels: int = 32, batch_norm: bool = False,
                 hex: bool = True, dtype=torch.float32):
        super().__init__()
        rows, cols = board_shape
        self.conv = Conv(width, conv_layer_channels, hex=hex, dtype=dtype)
        self.norm = _norm(batch_norm, conv_layer_channels, dtype)
        self.dense1 = Dense(rows * cols * conv_layer_channels, dense_layer_neurons,
                            bias=False, dtype=dtype)
        self.dense2 = Dense(dense_layer_neurons, 1, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.conv(x))
        x = torch.relu(x.reshape(x.shape[0], -1))
        x = torch.relu(self.dense1(x))
        return torch.tanh(self.dense2(x))[:, 0]


class ReducePolicyHead(nn.Module):
    """Conv filter-ramp from trunk width down to the action-plane count
    (ref ``blocks.py:130-170``).  Returns flat logits [B, planes*H*W] in
    (plane, row, col) order."""

    def __init__(self, width: int, policy_channels: int,
                 num_reduce_layers: int = 2, batch_norm: bool = False, hex: bool = True,
                 dtype=torch.float32):
        super().__init__()
        sizes = _ramp(width, policy_channels, num_reduce_layers)
        ins = [width] + list(sizes[:-1])
        self.convs = nn.ModuleList(
            Conv(i, o, hex=hex, dtype=dtype) for i, o in zip(ins, sizes)
        )
        self.norms = nn.ModuleList(_norm(batch_norm, o, dtype) for o in sizes[:-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i != len(self.convs) - 1:
                x = torch.relu(self.norms[i](x))
        # NHWC -> NCHW -> flat, so logits ravel as (plane, row, col).
        return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


def make_value_head(name: str, width: int, *, activation: str = "tanh",
                    batch_norm: bool = False, hex: bool = True, dtype=torch.float32,
                    board_shape=None) -> nn.Module:
    """Value head by selector string (ref RecurrentNet.py:58-76,
    ResNet.py:51-58).  ``board_shape`` (H, W) is needed by ``"dense"``."""
    if name == "reduce":
        return ReduceValueHead(width, activation=activation, batch_norm=batch_norm,
                               hex=hex, dtype=dtype)
    if name == "dense":
        if board_shape is None:
            raise ValueError("the dense value head needs the board_shape (H, W)")
        return DenseValueHead(width, board_shape, batch_norm=batch_norm, hex=hex, dtype=dtype)
    # The JAX registry's other heads (nuzero_tpu/networks/blocks.py:VALUE_HEADS)
    # are not ported yet.
    raise ValueError(f"value head {name!r} is not ported; options: ['dense', 'reduce']")
