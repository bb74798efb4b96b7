"""Batched agent-vs-agent match runner (counterpart of
``nuzero_tpu/evaluation/arena.py``; ref ``Testing/Tester.py``).

B games run in lockstep on the env's device: per move the mover's seat
policy chooses an action in every game, finished games freeze, and the
host loops until all games are terminal or ``max_moves`` is reached.  A
seat's policy runs only when some live game has that seat on move (the
JAX arena's ``lax.cond``); the two seat flags and ``done.all()`` come to
the host in one read per move, at its end, for the move after it.  Games
cut by ``max_moves`` count as draws and are reported as truncated.

Each move is the span ``nuzero.arena.move`` (``utils/profiling.py``; its
duration is ``Arena.seconds_per_move``), with the children
``nuzero.arena.policy`` (each seat's policy call, tagged with the seat),
``nuzero.arena.env`` (the env's step, the frozen games' select, the
lengths and the terminal flags) and ``nuzero.arena.read`` (the host read).

The initial states come from ``env.init`` with the match's generator, so
an env with per-game victory points (SCS ``randomize_vp``) draws each
game's layout from it; tests hand the JAX arena's layouts in as ``vp``.

Seat mapping is by player id: ``p0_policy`` plays player 0 (the
reference's seat swap for {0,1}-labelled games, ``Tester.py:74-79``, is
not reproduced, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from nuzero_tpu_torch.envs.base import select_state
from nuzero_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class MatchStats:
    num_games: int
    p0_wins: int
    p1_wins: int
    draws: int
    avg_length: float
    # Games that hit max_moves without terminating; counted as draws.
    truncated: int = 0

    @property
    def p0_win_rate(self) -> float:
        return self.p0_wins / max(self.num_games, 1)

    @property
    def p1_win_rate(self) -> float:
        return self.p1_wins / max(self.num_games, 1)

    @property
    def draw_rate(self) -> float:
        return self.draws / max(self.num_games, 1)


def _same_rng(rng, move):
    return rng, rng


class Arena:
    """Two-seat match engine; build once, play many.

    ``draws(rng, move) -> (rng0, rng1)`` gives each seat its randomness for
    a move: by default both seats draw from the one generator ``rng``;
    tests hand in the JAX arena's per-move draws."""

    def __init__(self, env, p0_policy: Callable, p1_policy: Callable,
                 draws: Callable = _same_rng):
        self.env = env
        self.p0_policy = p0_policy
        self.p1_policy = p1_policy
        self.draws = draws
        self.seconds_per_move: list = []  # each move's span of the last play, in seconds
        # f32[B] of the last play: each game's terminal value (+1 = player 0
        # won), 0 where it was cut by max_moves.
        self.outcomes: Optional[torch.Tensor] = None

    def play(self, num_games: int, p0_variables, p1_variables, rng,
             max_moves: Optional[int] = None, vp=None) -> MatchStats:
        """``rng``: a ``torch.Generator`` on the env's device (or None where
        the draws are handed in); ``vp``: the games' victory-point layouts,
        bool[B, 2, R, C], for an SCS env (tests)."""
        env = self.env
        max_moves = max_moves or env.max_game_length
        if vp is None:
            states = env.init(num_games, generator=rng)
        else:
            states = env.init(num_games, vp=vp)
        lengths = torch.zeros(num_games, dtype=torch.int32, device=env.device)
        done = env.terminal(states)
        zeros = torch.zeros(num_games, dtype=torch.int32, device=env.device)

        def read():
            """(player, whether seat 0 / seat 1 has a live game on move,
            whether every game is over): one host read."""
            with span("nuzero.arena.read"):
                player = env.current_player(states)
                return player, *torch.stack(
                    [((player == 0) & ~done).any(), ((player == 1) & ~done).any(), done.all()]
                ).tolist()

        self.seconds_per_move = []
        player, live0, live1, all_done = read()
        for move in range(max_moves):
            if all_done:
                break
            with span("nuzero.arena.move", move) as timed:
                r0, r1 = self.draws(rng, move)
                a0 = a1 = zeros
                if live0:
                    with span("nuzero.arena.policy", 0):
                        a0 = self.p0_policy(p0_variables, states, lengths, r0).to(torch.int32)
                if live1:
                    with span("nuzero.arena.policy", 1):
                        a1 = self.p1_policy(p1_variables, states, lengths, r1).to(torch.int32)
                with span("nuzero.arena.env"):
                    action = torch.where(player == 0, a0, a1)
                    states = select_state(done, states, env.step(states, action))
                    lengths = torch.where(done, lengths, lengths + 1)
                    done = env.terminal(states)
                if move + 1 < max_moves:
                    player, live0, live1, all_done = read()
            self.seconds_per_move.append(timed.seconds)

        values = env.terminal_value(states)
        self.outcomes = torch.where(done, values, torch.zeros_like(values))
        counts = torch.stack([
            ((values > 0) & done).sum(), ((values < 0) & done).sum(),
            ((values == 0) & done).sum(), (~done).sum(), lengths.sum(),
        ]).tolist()
        p0_wins, p1_wins, finished_draws, truncated, total_length = counts
        return MatchStats(
            num_games=num_games,
            p0_wins=p0_wins,
            p1_wins=p1_wins,
            draws=finished_draws + truncated,
            avg_length=total_length / num_games,
            truncated=truncated,
        )


def play_matches(env, p0_policy: Callable, p0_variables, p1_policy: Callable, p1_variables,
                 num_games: int, rng, max_moves: Optional[int] = None) -> MatchStats:
    return Arena(env, p0_policy, p1_policy).play(
        num_games, p0_variables, p1_variables, rng, max_moves)
