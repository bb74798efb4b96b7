"""Residual tower (counterpart of ``nuzero_tpu/networks/resnet.py``, ref
``Architectures/ResNet.py``): stem conv -> (BN) -> relu, ``num_blocks``
BasicBlocks, the reduce policy head and any value head of
``blocks.VALUE_HEADS``.  NCHW in, NHWC inside; the heads return f32.  The dense value
head needs the board's ``board_shape`` (H, W)."""

from __future__ import annotations

import torch
from torch import nn

from nuzero_tpu_torch.networks.blocks import (
    BasicBlock,
    Conv,
    ReducePolicyHead,
    _norm,
    make_value_head,
)


class ResNet(nn.Module):
    """``forward(x [B, C, H, W]) -> (policy_logits [B, A], value [B])``."""

    recurrent = False

    def __init__(self, in_channels: int, policy_channels: int, num_filters: int = 256,
                 num_blocks: int = 4, batch_norm: bool = False, policy_head: str = "conv",
                 value_head: str = "reduce", value_activation: str = "tanh",
                 hex: bool = True, dtype=torch.float32, board_shape=None):
        super().__init__()
        if policy_head != "conv":
            raise ValueError(f"ResNet policy head {policy_head!r} unavailable")
        self.dtype = dtype
        self.stem = Conv(in_channels, num_filters, hex=hex, dtype=dtype)
        self.stem_norm = _norm(batch_norm, num_filters, dtype)
        self.blocks = nn.ModuleList(
            BasicBlock(num_filters, batch_norm=batch_norm, hex=hex, dtype=dtype)
            for _ in range(num_blocks)
        )
        self.policy_head = ReducePolicyHead(num_filters, policy_channels,
                                            batch_norm=batch_norm, hex=hex, dtype=dtype)
        self.value_head = make_value_head(
            value_head, num_filters, activation=value_activation, batch_norm=batch_norm,
            hex=hex, dtype=dtype, board_shape=board_shape,
        )

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 2, 3, 1).to(self.dtype).contiguous()
        x = torch.relu(self.stem_norm(self.stem(x)))
        for block in self.blocks:
            x = block(x)
        return self.policy_head(x).float(), self.value_head(x).float()
