"""Finished-game records emitted by self-play (counterpart of the
``FinishedGames`` record in ``nuzero_tpu/training/replay.py``; the replay
ring itself is not ported yet)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class FinishedGames:
    """A batch of completed games emitted by one self-play step."""

    states: torch.Tensor  # f32[B, L, D] packed env states (utils.packing)
    policy: torch.Tensor  # f32[B, L, A]
    final_value: torch.Tensor  # f32[B] static terminal value
    length: torch.Tensor  # i32[B] positions recorded
    game_type: torch.Tensor  # i32[B]
    mask: torch.Tensor  # bool[B] True where the row is a real finished game
