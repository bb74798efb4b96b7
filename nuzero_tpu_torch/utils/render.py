"""Host-side ASCII rendering of SCS states (counterpart of
``nuzero_tpu/utils/render.py``; ref ``SCS_Game.string_representation``,
``SCS_Game.py:1836-1932``)."""

from __future__ import annotations

import numpy as np
import torch


def render_scs_ascii(env, state, game: int = 0) -> str:
    """Game ``game`` of the batch as offset-column ASCII.  Each cell shows
    ``<owner><attack><defense>`` of the top unit (``....`` empty), ``*`` for
    victory-point tiles, and the terrain cost as a trailing digit."""
    board = state.board[game].cpu().numpy()  # [R, C, K]
    cost = env.t_cost.cpu().numpy()
    vp = env.vp.cpu().numpy()
    S = env.S
    attack = env.u_attack.cpu().numpy()
    defense = env.u_defense.cpu().numpy()

    lines = ["    " + "".join(f"{c:^8}" for c in range(env.C))]
    for r in range(env.R):
        row_hi = [" " * 8] * env.C  # even columns on one text row
        row_lo = [" " * 8] * env.C  # odd columns on a half-shifted row
        for c in range(env.C):
            top = next((board[r, c, k] for k in range(env.K - 1, -1, -1)
                        if board[r, c, k] >= 0), -1)
            if top >= 0:
                cell = f"P{top // S}{int(attack[top])}{int(defense[top])}"
            else:
                cell = "...."
            mark = "*" if vp[0, r, c] or vp[1, r, c] else " "
            cell = f"{mark}{cell}t{int(cost[r, c])}"
            (row_hi if c % 2 == 0 else row_lo)[c] = f"{cell:^8}"
        lines.append(f"{r:>3} " + "".join(row_hi))
        lines.append("    " + "".join(row_lo))
    lines.append(
        f"turn {int(state.turn[game])}  stage {int(state.stage[game])}  "
        f"player {int(env.current_player(state)[game])}  "
        f"terminal {bool(state.terminal[game])}"
    )
    return "\n".join(lines)


def replay_actions(env, actions) -> list:
    """Replay an action history from a fresh game (the analysis mode's core,
    ref ``SCS_Renderer.analyse``, ``SCS_Renderer.py:105-219``) -> the list
    of states, each a batch of one."""
    state = env.init(1)
    states = [state]
    for a in actions:
        state = env.step(state, torch.tensor([int(a)], dtype=torch.int32, device=env.device))
        states.append(state)
    return states


def legal_actions(env, state) -> np.ndarray:
    """The legal flat actions of a batch-of-one ``state``, ascending."""
    return np.flatnonzero(env.legal_mask(state)[0].cpu().numpy())
