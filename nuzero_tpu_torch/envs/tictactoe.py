"""Tic-Tac-Toe as a batch-first PyTorch state machine.

Counterpart of ``nuzero_tpu/envs/tictactoe.py`` (behavioral target:
``Games/Tic_Tac_Toe/tic_tac_toe.py`` of the reference), with the same
conventions:

- 3x3 board, marks {0 empty, 1 player 0, 2 player 1};
- player to move = length % 2;
- observation = 2 planes: player 0's marks, player 1's marks;
- terminal: a 3-line for the mover, or length == 9;
- terminal value +1 player 0 won / -1 player 1 won / 0 draw.

The win check reduces the mover's marks against the 8x9 line mask in one
matmul.  ``step`` is total, like the JAX one: on an occupied cell it
overwrites the mark, on a terminal game it plays on, and an action of 9
or more writes no mark, as the JAX scatter drops it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nuzero_tpu_torch.envs.base import Env

# (8 lines, 9 cells): rows, cols, two diagonals.
_LINES = np.zeros((8, 9), dtype=np.float32)
for _i in range(3):
    _LINES[_i, 3 * _i : 3 * _i + 3] = 1.0  # rows
    _LINES[3 + _i, _i::3] = 1.0  # cols
_LINES[6, [0, 4, 8]] = 1.0  # main diagonal
_LINES[7, [2, 4, 6]] = 1.0  # anti-diagonal


@dataclasses.dataclass
class TTTState:
    """Batch of B games; fields in the JAX ``TTTState`` declaration order."""

    board: torch.Tensor  # i8[B, 3, 3]; 0 empty, 1 = player 0's mark, 2 = player 1's
    current_player: torch.Tensor  # i32[B] in {0, 1}
    length: torch.Tensor  # i32[B] moves played
    terminal: torch.Tensor  # bool[B]
    terminal_value: torch.Tensor  # f32[B]; +1 = player 0 won


class TicTacToe(Env):
    num_actions = 9
    action_space_shape = (1, 3, 3)
    observation_shape = (2, 3, 3)
    max_game_length = 9

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.lines = torch.from_numpy(_LINES).to(self.device)
        self._cells = torch.arange(9, device=self.device)

    def init(self, batch_size: int, generator=None) -> TTTState:
        B, dev = batch_size, self.device
        return TTTState(
            board=torch.zeros((B, 3, 3), dtype=torch.int8, device=dev),
            current_player=torch.zeros(B, dtype=torch.int32, device=dev),
            length=torch.zeros(B, dtype=torch.int32, device=dev),
            terminal=torch.zeros(B, dtype=torch.bool, device=dev),
            terminal_value=torch.zeros(B, dtype=torch.float32, device=dev),
        )

    def step(self, state: TTTState, action: torch.Tensor) -> TTTState:
        B = action.shape[0]
        mark = (state.current_player + 1).to(torch.int8)
        flat = state.board.reshape(B, 9)
        hit = self._cells == action.long()[:, None]
        flat = torch.where(hit, mark[:, None], flat)
        length = state.length + 1
        # Only the mover can complete a line on their own move.
        mover_line = ((flat == mark[:, None]).to(torch.float32) @ self.lines.T).amax(-1) >= 3.0
        won_value = torch.where(state.current_player == 0, 1.0, -1.0)
        return TTTState(
            board=flat.reshape(B, 3, 3),
            current_player=(length % 2).to(torch.int32),
            length=length,
            terminal=mover_line | (length >= 9),
            terminal_value=torch.where(mover_line, won_value, 0.0),
        )

    def legal_mask(self, state: TTTState) -> torch.Tensor:
        B = state.board.shape[0]
        return (state.board.reshape(B, 9) == 0) & ~state.terminal[:, None]

    def observe(self, state: TTTState) -> torch.Tensor:
        p0 = (state.board == 1).to(torch.float32)
        p1 = (state.board == 2).to(torch.float32)
        return torch.stack([p0, p1], dim=1)

    def terminal(self, state: TTTState) -> torch.Tensor:
        return state.terminal

    def terminal_value(self, state: TTTState) -> torch.Tensor:
        return state.terminal_value

    def current_player(self, state: TTTState) -> torch.Tensor:
        return state.current_player

    @staticmethod
    def render(state: TTTState, game: int = 0) -> str:
        """ASCII board of one game of the batch (ref ``tic_tac_toe.py:275-297``,
        sans colors)."""
        chars = {0: "   ", 1: " O ", 2: " X "}
        board = state.board[game].cpu().numpy()
        rows = ["|".join(chars[int(v)] for v in r) for r in board]
        return ("\n---|---|---\n").join(rows) + "\n"
