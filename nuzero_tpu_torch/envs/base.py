"""Environment contract for batch-first PyTorch game engines.

Counterpart of ``nuzero_tpu/envs/base.py``.  The environment object holds
only static scenario data, as tensors on its device; all dynamic state
lives in a dataclass of tensors whose fields share a leading batch
dimension B.  Where the JAX contract maps one game and lets ``vmap`` batch
it, every method here takes and returns a batch:

- ``init(batch_size) -> state``;
- ``step(state, action i64/i32[B]) -> state``, total: defined for illegal
  actions and terminal states alike (legality is masked by the caller);
- ``legal_mask(state) -> bool[B, num_actions]``;
- ``observe(state) -> f32[B, C, H, W]``;
- ``terminal(state) -> bool[B]``, ``terminal_value(state) -> f32[B]``
  (+1 = player 0 wins), ``current_player(state) -> i32[B]`` in {0, 1}.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Tuple

import torch

EnvState = Any  # a dataclass of batch-first tensors specific to each Env


def select_state(cond: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Per game: ``a`` where ``cond`` (bool[B]) else ``b``."""
    out = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        out[f.name] = torch.where(cond.view((-1,) + (1,) * (x.dim() - 1)), x, y)
    return type(a)(**out)


class Env(abc.ABC):
    """Static environment description + batched transition functions."""

    #: flat action count == prod(action_space_shape)
    num_actions: int
    #: (planes, rows, cols) layout of the flat action index (C-order ravel)
    action_space_shape: Tuple[int, int, int]
    #: (channels, rows, cols) observation shape
    observation_shape: Tuple[int, int, int]
    #: hard upper bound on game length in decisions (for buffers)
    max_game_length: int
    device: torch.device

    @abc.abstractmethod
    def init(self, batch_size: int) -> EnvState:
        """Fresh game states (player 0 to move)."""

    @abc.abstractmethod
    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """Apply one flat action index per game."""

    @abc.abstractmethod
    def legal_mask(self, state: EnvState) -> torch.Tensor:
        """bool[B, num_actions]; True = legal in the current sub-phase."""

    @abc.abstractmethod
    def observe(self, state: EnvState) -> torch.Tensor:
        """f32[B, channels, rows, cols] network input."""

    @abc.abstractmethod
    def terminal(self, state: EnvState) -> torch.Tensor:
        """bool[B]."""

    @abc.abstractmethod
    def terminal_value(self, state: EnvState) -> torch.Tensor:
        """f32[B] in [-1, 1]; +1 = player 0 won.  0 until terminal."""

    @abc.abstractmethod
    def current_player(self, state: EnvState) -> torch.Tensor:
        """i32[B] in {0, 1}."""
