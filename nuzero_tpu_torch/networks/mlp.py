"""MLP policy/value network (counterpart of ``nuzero_tpu/networks/mlp.py``,
ref ``Architectures/MLP_Network.py``).

Flatten -> Dense(neurons) -> SiLU, then ``hidden_layers`` x (Dense -> SiLU).
Policy head: 3 dense layers interpolating widths toward ``out_features``,
ReLU after *every* layer, the last included (the reference does so,
``MLP_Network.py:36-39``, so the "logits" are non-negative; search
softmaxes them regardless).  Value head: 3 dense layers interpolating
toward 1, tanh after every layer.  Every dense layer carries a bias, as
Flax's ``nn.Dense`` does.  The outputs are in ``dtype``, as in the JAX net.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from nuzero_tpu_torch.networks.blocks import Dense, _ramp


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` as two ops, as ``jax.nn.silu`` is: in bf16 the
    sigmoid is rounded before the product (a fused silu rounds once)."""
    return x * torch.sigmoid(x)


def _chain(width: int, sizes, dtype) -> nn.ModuleList:
    ins = [width] + list(sizes[:-1])
    return nn.ModuleList(Dense(i, o, dtype=dtype) for i, o in zip(ins, sizes))


class MLPNetwork(nn.Module):
    """``forward(x [B, C, H, W]) -> (policy [B, out_features], value [B])``."""

    recurrent = False

    def __init__(self, observation_shape, out_features: int, hidden_layers: int = 4,
                 neurons_per_layer: int = 64, dtype=torch.float32):
        super().__init__()
        n = neurons_per_layer
        self.trunk = nn.ModuleList(
            Dense(math.prod(observation_shape) if i == 0 else n, n, dtype=dtype)
            for i in range(hidden_layers + 1)
        )
        self.policy = _chain(n, _ramp(n, out_features, 3), dtype)
        self.value = _chain(n, _ramp(n, 1, 3), dtype)

    def forward(self, x: torch.Tensor):
        x = x.reshape(x.shape[0], -1)
        for layer in self.trunk:
            x = _silu(layer(x))
        p = x
        for layer in self.policy:
            p = torch.relu(layer(p))
        v = x
        for layer in self.value:
            v = torch.tanh(layer(v))
        return p, v[:, 0]
