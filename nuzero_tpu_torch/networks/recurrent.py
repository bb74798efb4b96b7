"""DeepThinking-style recurrent network (counterpart of
``nuzero_tpu/networks/recurrent.py``, ref ``Architectures/RecurrentNet.py``).

The recurrent cell is applied ``iters_to_do`` times with shared weights, as
a Python loop; with ``recall=True`` the raw input is concatenated onto the
thought before every iteration.  The interim thought goes in and out.
``detach_at`` and ``limit`` keep the JAX net's progressive-loss semantics:
iteration ``i`` detaches the thought when ``i == detach_at`` and becomes
the identity once ``i >= limit``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nuzero_tpu_torch.networks.blocks import (
    BasicBlock,
    Conv,
    ReducePolicyHead,
    make_value_head,
)


class RecurCell(nn.Module):
    def __init__(self, in_channels: int, num_filters: int, num_blocks: int,
                 recall: bool, hex: bool, dtype):
        super().__init__()
        self.recall = (
            Conv(num_filters + in_channels, num_filters, hex=hex, dtype=dtype)
            if recall else None
        )
        self.blocks = nn.ModuleList(
            BasicBlock(num_filters, hex=hex, dtype=dtype) for _ in range(num_blocks)
        )

    def forward(self, thought: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h = thought
        if self.recall is not None:
            h = self.recall(torch.cat([h, x], dim=-1))  # NHWC channel concat
        for block in self.blocks:
            h = block(h)
        return h


class RecurrentNet(nn.Module):
    """``forward(x [B, C, H, W]) -> ((policy_logits [B, A], value [B]),
    interim_thought [B, H, W, F])``; heads return f32."""

    recurrent = True

    def __init__(self, in_channels: int, policy_channels: int,
                 num_filters: int = 256, num_blocks: int = 2, recall: bool = True,
                 policy_head: str = "conv", value_head: str = "reduce",
                 value_activation: str = "tanh", hex: bool = True,
                 dtype=torch.float32):
        super().__init__()
        if policy_head != "conv":
            raise ValueError(f"policy head {policy_head!r} unavailable")
        self.dtype = dtype
        self.stem = Conv(in_channels, num_filters, hex=hex, dtype=dtype)
        self.cell = RecurCell(in_channels, num_filters, num_blocks, recall, hex, dtype)
        self.policy_head = ReducePolicyHead(
            num_filters, policy_channels, hex=hex, dtype=dtype
        )
        self.value_head = make_value_head(
            value_head, num_filters, activation=value_activation, hex=hex, dtype=dtype
        )

    def forward(
        self,
        x: torch.Tensor,
        iters_to_do: int = 2,
        interim_thought: Optional[torch.Tensor] = None,
        detach_at: Optional[int] = None,
        limit: Optional[int] = None,
    ):
        # (B, C, H, W) -> NHWC.
        x = x.permute(0, 2, 3, 1).to(self.dtype).contiguous()
        if interim_thought is None:
            thought = torch.relu(self.stem(x))
        else:
            thought = interim_thought
        limit = iters_to_do if limit is None else limit
        for i in range(min(int(iters_to_do), int(limit))):
            if i == detach_at:
                thought = thought.detach()
            thought = self.cell(thought, x)
        p = self.policy_head(thought)
        v = self.value_head(thought)
        return (p.float(), v.float()), thought
