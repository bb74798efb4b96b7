"""Unified network front-end (counterpart of ``nuzero_tpu/networks/manager.py``,
ref ``Neural_Networks/Network_Manager.py``).

As in the JAX package, parameters are explicit: ``variables`` is a
``state_dict``-style mapping of names to tensors, applied to the bound
module with ``torch.func.functional_call``.  It holds the module's
buffers too (BatchNorm's running statistics, Flax's ``batch_stats``), so
that a checkpoint of ``variables`` holds them.  ``apply`` has one
signature:

    (variables, obs, iters_to_do, interim_thought)
        -> (policy_logits, value, interim_thought | None)

and ``inference`` mirrors the reference's return conventions.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from nuzero_tpu_torch.networks.blocks import (
    BatchNorm, Dense, HexConv, HexDepthwiseConv, OrthoConv, init_conv_weight_,
    init_dense_weight_,
)


def _init_parameter(module: nn.Module, name: str, p: torch.Tensor, generator):
    """A fresh value of ``module``'s parameter ``name`` by the module's kind,
    as Flax initializes it: conv kernels variance_scaling(1/3, fan_in,
    uniform), Dense kernels lecun_normal, biases zero, BatchNorm scales one."""
    out = torch.empty_like(p, requires_grad=False)
    if isinstance(module, (HexConv, HexDepthwiseConv, OrthoConv)):
        return init_conv_weight_(out, generator)
    if isinstance(module, Dense) and name == "weight":
        return init_dense_weight_(out, generator)
    if isinstance(module, BatchNorm) and name == "weight":
        return out.fill_(1.0)
    if name == "bias":
        return out.zero_()
    raise TypeError(f"no initializer for {type(module).__name__}.{name}")


class NetworkManager:
    def __init__(self, module: nn.Module, observation_shape: Tuple[int, ...]):
        self.module = module
        self.observation_shape = tuple(observation_shape)
        if not isinstance(getattr(module, "recurrent", None), bool):
            # ref Network_Manager.py:20-24 — the attr is mandatory.
            raise TypeError(
                "network modules must define a boolean `recurrent` attribute"
            )

    @property
    def is_recurrent(self) -> bool:
        return self.module.recurrent

    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Fresh parameters drawn from ``generator`` (on the module's device),
        in ``named_parameters`` order, and the buffers' initial values."""
        out = {}
        for prefix, module in self.module.named_modules():
            for name, p in module.named_parameters(recurse=False):
                key = f"{prefix}.{name}" if prefix else name
                out[key] = _init_parameter(module, name, p, generator)
        out.update({k: b.detach().clone() for k, b in self.module.named_buffers()})
        return out

    @property
    def has_batch_norm(self) -> bool:
        return any(isinstance(m, BatchNorm) for m in self.module.modules())

    def apply(
        self,
        variables: Dict[str, torch.Tensor],
        obs: torch.Tensor,
        iters_to_do: int = 2,
        interim_thought: Optional[torch.Tensor] = None,
    ):
        """Uniform forward: -> (policy_logits [B, A], value [B], interim)."""
        if self.is_recurrent:
            (p, v), interim = functional_call(
                self.module, variables, (obs, iters_to_do, interim_thought)
            )
            return p, v, interim
        p, v = functional_call(self.module, variables, (obs,))
        return p, v, None

    def inference(
        self,
        variables: Dict[str, torch.Tensor],
        obs: torch.Tensor,
        training: bool = False,
        iters_to_do: int = 2,
        interim_thought: Optional[torch.Tensor] = None,
    ):
        """``(p, v)`` normally; ``((p, v), interim)`` for recurrent training
        (ref ``Network_Manager.py:46-64``)."""
        p, v, interim = self.apply(variables, obs, iters_to_do, interim_thought)
        if self.is_recurrent and training:
            return (p, v), interim
        return p, v
