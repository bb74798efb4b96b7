"""Plain conv stack with ELU (counterpart of ``nuzero_tpu/networks/convnet.py``,
ref ``Architectures/ConvNet.py``): a stem conv and ``num_layers`` more, ELU
after each, then the reduce policy and value heads.  NCHW in, NHWC inside;
the heads return f32."""

from __future__ import annotations

import torch
from torch import nn

from nuzero_tpu_torch.networks.blocks import Conv, ReducePolicyHead, ReduceValueHead


class ConvNet(nn.Module):
    """``forward(x [B, C, H, W]) -> (policy_logits [B, A], value [B])``."""

    recurrent = False

    def __init__(self, in_channels: int, policy_channels: int, num_filters: int = 256,
                 num_layers: int = 6, hex: bool = True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList(
            Conv(in_channels if i == 0 else num_filters, num_filters, hex=hex, dtype=dtype)
            for i in range(num_layers + 1)
        )
        self.policy_head = ReducePolicyHead(num_filters, policy_channels, hex=hex, dtype=dtype)
        self.value_head = ReduceValueHead(num_filters, hex=hex, dtype=dtype)

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 2, 3, 1).to(self.dtype).contiguous()
        for conv in self.convs:
            x = nn.functional.elu(conv(x))
        return self.policy_head(x).float(), self.value_head(x).float()
