"""Network building blocks (counterpart of ``nuzero_tpu/networks/blocks.py``).

Activations are NHWC, as in the JAX package.  All convolutions are
bias-free.  ``hex=True`` selects the hexagonal convolution (one hex ring,
``ops.hexconv.hex_conv``); ``hex=False`` a 3x3 'same' ortho conv.
Parameters are f32; ``dtype`` is the compute dtype (bf16 runs the convs in
bf16 with f32 accumulation).  Filter ramps reproduce the reference's
``int(width + k*step)`` arithmetic so parameter shapes line up.

``BatchNorm`` is Flax's ``nn.BatchNorm`` as the JAX nets apply it outside
training: the running mean and variance (buffers) normalize, epsilon 1e-5.
Inside ``batch_statistics(module)`` it is torch's ``nn.BatchNorm2d`` in
training mode instead (the learner's forward; ``update_running_stats``
moves the buffers after the update).
Every value head of the JAX registry (``VALUE_HEADS``) is here, the
reference's discontinued ones (``depth``, ``combined``, ``separable``,
``reverse``, ``rawsep``, ``strange``) included, with their per-channel
convs: the hex depthwise conv (``ops.hexconv.hex_conv_depthwise``, plain
PyTorch, as the JAX function is plain XLA) and grouped or 1x1 ortho convs.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
from torch import nn

from nuzero_tpu_torch.ops.hexconv import hex_conv, hex_conv_depthwise


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
    hex depthwise weights [7, C] (fan_in 7), ortho weights OIHW (fan_in
    Cin/groups*k*k)."""
    fan_in = {2: w.shape[0], 3: w.shape[0] * w.shape[1]}.get(w.dim(), w[0].numel())
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
    """k x k 'same' conv on NHWC activations, weight OIHW, ``groups`` as in
    Flax's ``feature_group_count`` (a grouped 3x3 is the ortho depthwise
    conv, a grouped 1x1 a per-channel scale).  In f32 on the card it
    computes in full f32 whatever the process-wide TF32 flags say."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 dtype=torch.float32, groups: int = 1):
        super().__init__()
        self.dtype = dtype
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(features, in_features // groups, kernel_size, kernel_size)
        )
        init_conv_weight_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        full_f32 = x.is_cuda and self.dtype == torch.float32
        with _cudnn_without_tf32() if full_f32 else contextlib.nullcontext():
            y = nn.functional.conv2d(x, self.weight.to(self.dtype), padding="same",
                                     groups=self.groups)
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
    """Batch normalization over the channels of NHWC activations, in f32,
    returned in ``dtype``.  The caller picks the statistics:

    - by default Flax's ``nn.BatchNorm(use_running_average=True)``: the
      running mean and variance (buffers) normalize,
      ``(x - mean) * (rsqrt(var + 1e-5) * scale) + bias``;
    - inside ``batch_statistics(module)``, torch's ``nn.BatchNorm2d`` in
      training mode: the batch's own mean and biased variance over
      (B, H, W) normalize, and the batch's mean and unbiased variance are
      appended to the block's record.  The forward writes no buffer; the
      caller moves them with ``update_running_stats``.
    """

    eps = 1e-5
    momentum = 0.1

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.record = None  # a list while ``batch_statistics`` is open

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.record is None:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x.float() - self.running_mean) * mul + self.bias).to(self.dtype)
        x = x.float()
        n = x.numel() // x.shape[-1]
        if n < 2:
            raise ValueError("BatchNorm: batch statistics need more than one value per channel")
        var, mean = torch.var_mean(x, dim=tuple(range(x.dim() - 1)), unbiased=False)
        self.record.append((mean.detach(), var.detach() * (n / (n - 1))))
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * mul + self.bias).to(self.dtype)


@contextlib.contextmanager
def batch_statistics(module: nn.Module):
    """Every ``BatchNorm`` of ``module`` normalizes by its batch's statistics
    inside the block, which yields their record: {the norm's module name:
    [(batch mean, unbiased batch variance), one per call]}.  Nothing is
    recorded for a module without one."""
    norms = {name: m for name, m in module.named_modules() if isinstance(m, BatchNorm)}
    records = {name: [] for name in norms}
    for name, m in norms.items():
        m.record = records[name]
    try:
        yield records
    finally:
        for m in norms.values():
            m.record = None


def update_running_stats(variables, records) -> dict:
    """The running means and variances of ``variables`` moved by a
    ``batch_statistics`` record, as torch's ``nn.BatchNorm2d`` moves them at
    each training call: ``(1 - 0.1) * running + 0.1 * batch``, the variance
    unbiased -> {buffer name: new tensor}."""
    out = {}
    m = BatchNorm.momentum
    for name, calls in records.items():
        prefix = f"{name}." if name else ""
        mean, var = variables[prefix + "running_mean"], variables[prefix + "running_var"]
        for batch_mean, batch_var in calls:
            mean = (1 - m) * mean + m * batch_mean
            var = (1 - m) * var + m * batch_var
        out[prefix + "running_mean"], out[prefix + "running_var"] = mean, var
    return out


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


class HexDepthwiseConv(nn.Module):
    """Per-channel hexagonal conv, NHWC, weight ``[7, C]`` (ref
    ``depthwise_conv.py:10-38``, a loop of C ``hexagdly.Conv2d(1, 1)``)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(7, channels))
        init_conv_weight_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hex_conv_depthwise(x.to(self.dtype), self.weight.to(self.dtype))


class DepthwiseConv(nn.Module):
    """Hex-or-ortho depthwise conv selector.  Ortho mode is a grouped 3x3
    with SAME padding: the JAX package's stated deviation from the
    reference's VALID padding, which shrinks the board (blocks.py:187-197)."""

    def __init__(self, channels: int, hex: bool = True, dtype=torch.float32):
        super().__init__()
        if hex:
            self.conv = HexDepthwiseConv(channels, dtype=dtype)
        else:
            self.conv = OrthoConv(channels, channels, 3, dtype=dtype, groups=channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def _act(name: str):
    return {"tanh": torch.tanh, "relu": torch.relu}[name]


def _global_tanh(x: torch.Tensor) -> torch.Tensor:
    """The discontinued heads' tail (ref ``AdaptiveAvgPool3d(1) -> Flatten
    -> Tanh``): the mean over (H, W, C) of a 1-channel map, then tanh."""
    return torch.tanh(x.mean(dim=(1, 2, 3)))


#: The filter ramp of the discontinued heads other than depth, whatever the
#: trunk's width (ref blocks.py:231,288,332,373,419).
_DISCONTINUED_RAMP = (256, 64, 8, 1)


class _DiscontinuedHead(nn.Module):
    """What the discontinued heads share: their activation, their
    BatchNorms in the JAX heads' call order (Flax ``BatchNorm_{i}`` ->
    ``norms.{i}``) and the global tanh.  ``_norm_act`` applies the next
    BatchNorm (where there is one), then the activation."""

    def __init__(self, activation: str, batch_norm: bool, dtype):
        super().__init__()
        self.act = _act(activation)
        self.batch_norm = batch_norm
        self.dtype = dtype
        self.norms = nn.ModuleList()

    def _add_norm(self, features: int) -> None:
        if self.batch_norm:
            self.norms.append(BatchNorm(features, self.dtype))

    def _norm_act(self, x: torch.Tensor, i: int):
        if self.batch_norm:
            x = self.norms[i](x)
            i += 1
        return self.act(x), i


class DepthValueHead(_DiscontinuedHead):
    """4 x [depthwise -> (BN) -> act], a full conv to 1 channel, global tanh
    (ref ``Depth_ValueHead``, blocks.py:180-221)."""

    def __init__(self, width: int, activation: str = "relu", batch_norm: bool = False,
                 hex: bool = True, dtype=torch.float32):
        super().__init__(activation, batch_norm, dtype)
        self.depthwise = nn.ModuleList(DepthwiseConv(width, hex, dtype) for _ in range(4))
        for _ in range(4):
            self._add_norm(width)
        self.convs = nn.ModuleList([Conv(width, 1, hex=hex, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = 0
        for dw in self.depthwise:
            x, n = self._norm_act(dw(x), n)
        return _global_tanh(self.convs[0](x))


class CombinedValueHead(_DiscontinuedHead):
    """Per ramp step: depthwise -> (BN) -> act -> full conv down, then (BN)
    -> act but after the last (ref ``Combined_ValueHead``, blocks.py:226-280)."""

    def __init__(self, width: int, activation: str = "relu", batch_norm: bool = False,
                 hex: bool = True, dtype=torch.float32):
        super().__init__(activation, batch_norm, dtype)
        ins = (width,) + _DISCONTINUED_RAMP[:-1]
        self.depthwise = nn.ModuleList(DepthwiseConv(c, hex, dtype) for c in ins)
        self.convs = nn.ModuleList(
            Conv(c, f, hex=hex, dtype=dtype) for c, f in zip(ins, _DISCONTINUED_RAMP))
        for c, f in zip(ins, _DISCONTINUED_RAMP):
            self._add_norm(c)
            if f != 1:
                self._add_norm(f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = 0
        for dw, conv, f in zip(self.depthwise, self.convs, _DISCONTINUED_RAMP):
            x, n = self._norm_act(dw(x), n)
            x = conv(x)
            if f != 1:
                x, n = self._norm_act(x, n)
        return _global_tanh(x)


class _SeparableRamp(_DiscontinuedHead):
    """The ramp of the separable heads: per step a per-channel conv and a
    pointwise one in the subclass's ``order``, then (BN) -> act but after
    the last.  ``pointwise.{i}`` are Flax's 1x1 ``nn.Conv``s."""

    #: True: depthwise, then pointwise (separable, rawsep); False: the
    #: reverse order (reverse)
    depthwise_first = True
    #: the depthwise convs' hex flag; None follows the head's ``hex``
    depthwise_hex = None

    def __init__(self, width: int, activation: str = "relu", batch_norm: bool = False,
                 hex: bool = True, dtype=torch.float32):
        super().__init__(activation, batch_norm, dtype)
        ins = (width,) + _DISCONTINUED_RAMP[:-1]
        dw_hex = hex if self.depthwise_hex is None else self.depthwise_hex
        dw_widths = ins if self.depthwise_first else _DISCONTINUED_RAMP
        self.depthwise = nn.ModuleList(DepthwiseConv(c, dw_hex, dtype) for c in dw_widths)
        self.pointwise = nn.ModuleList(
            OrthoConv(c, f, 1, dtype=dtype) for c, f in zip(ins, _DISCONTINUED_RAMP))
        for f in _DISCONTINUED_RAMP[:-1]:
            self._add_norm(f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = 0
        for dw, pw, f in zip(self.depthwise, self.pointwise, _DISCONTINUED_RAMP):
            x = pw(dw(x)) if self.depthwise_first else dw(pw(x))
            if f != 1:
                x, n = self._norm_act(x, n)
        return _global_tanh(x)


class SeparableValueHead(_SeparableRamp):
    """Depthwise-separable ramp: depthwise -> 1x1 pointwise per step (ref
    ``Separable_ValueHead``, blocks.py:284-324)."""


class ReverseValueHead(_SeparableRamp):
    """Reversed separable: 1x1 pointwise down, then depthwise (ref
    ``Reverse_ValueHead``, blocks.py:328-367)."""

    depthwise_first = False


class RawSeparableValueHead(_SeparableRamp):
    """The separable ramp with an ORTHO 3x3 depthwise whatever ``hex`` says:
    the reference ignores its hex flag here (ref ``RawSeparable_ValueHead``,
    blocks.py:371-407)."""

    depthwise_hex = False


class StrangeValueHead(_DiscontinuedHead):
    """Per ramp step a per-channel 1x1 scale (a grouped 1x1 conv,
    ``pointwise.{i}``) then a full conv down, then (BN) -> act but after the
    last (ref ``Strange_ValueHead``, blocks.py:411-448)."""

    def __init__(self, width: int, activation: str = "relu", batch_norm: bool = False,
                 hex: bool = True, dtype=torch.float32):
        super().__init__(activation, batch_norm, dtype)
        ins = (width,) + _DISCONTINUED_RAMP[:-1]
        self.pointwise = nn.ModuleList(OrthoConv(c, c, 1, dtype=dtype, groups=c) for c in ins)
        self.convs = nn.ModuleList(
            Conv(c, f, hex=hex, dtype=dtype) for c, f in zip(ins, _DISCONTINUED_RAMP))
        for f in _DISCONTINUED_RAMP[:-1]:
            self._add_norm(f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = 0
        for scale, conv, f in zip(self.pointwise, self.convs, _DISCONTINUED_RAMP):
            x = conv(scale(x))
            if f != 1:
                x, n = self._norm_act(x, n)
        return _global_tanh(x)


#: The value-head registry; keys are the reference's selector strings
#: (ref RecurrentNet.py:58-76), as in the JAX package's ``VALUE_HEADS``.
VALUE_HEADS = {
    "reduce": ReduceValueHead,
    "dense": DenseValueHead,
    "depth": DepthValueHead,
    "combined": CombinedValueHead,
    "separable": SeparableValueHead,
    "reverse": ReverseValueHead,
    "rawsep": RawSeparableValueHead,
    "strange": StrangeValueHead,
}


def make_value_head(name: str, width: int, *, activation: str = "tanh",
                    batch_norm: bool = False, hex: bool = True, dtype=torch.float32,
                    board_shape=None) -> nn.Module:
    """Value head by selector string (ref RecurrentNet.py:58-76,
    ResNet.py:51-58).  ``board_shape`` (H, W) is needed by ``"dense"``.  The
    nets pass ``activation`` to every head but the dense one, so the
    discontinued heads see "tanh" by default, as in the JAX package."""
    try:
        cls = VALUE_HEADS[name]
    except KeyError:
        raise ValueError(f"unknown value head {name!r}; options: {sorted(VALUE_HEADS)}") from None
    if cls is DenseValueHead:
        if board_shape is None:
            raise ValueError("the dense value head needs the board_shape (H, W)")
        return cls(width, board_shape, batch_norm=batch_norm, hex=hex, dtype=dtype)
    return cls(width, activation=activation, batch_norm=batch_norm, hex=hex, dtype=dtype)
