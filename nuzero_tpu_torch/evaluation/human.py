"""Human-vs-agent terminal play (counterpart of
``nuzero_tpu/evaluation/human.py``; ref ``Tester.ttt_vs_agent``,
``Testing/Tester.py:123-156``).

Any env: the human types an action index (or ``row col`` / ``plane row
col`` coordinates), an illegal input re-prompts with the legal list, and
the opponent is any evaluation ``Agent``, deciding through its
``choose_host`` (and so its cache, where it has one).  ``input_fn`` and
``print_fn`` can be injected.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from nuzero_tpu_torch.evaluation.agents import Agent
from nuzero_tpu_torch.utils.render import legal_actions, render_scs_ascii


def _render(env, state, print_fn):
    if hasattr(env, "render"):
        print_fn(env.render(state))
    else:
        print_fn(render_scs_ascii(env, state))


def _parse_action(env, text: str) -> Optional[int]:
    try:
        nums = [int(x) for x in text.split()]
    except ValueError:
        return None
    if len(nums) == 1:
        return nums[0]
    shape = env.action_space_shape
    if len(nums) == len(shape):
        return int(np.ravel_multi_index(tuple(nums), shape))
    if len(nums) == len(shape) - 1:
        # "row col" for single-plane games such as Tic-Tac-Toe
        return int(np.ravel_multi_index((0, *nums), shape))
    return None


def play_vs_agent(env, agent: Agent, human_player: int = 0, seed: int = 0,
                  input_fn: Callable[[str], str] = input,
                  print_fn: Callable[[str], None] = print) -> float:
    """Play one game in the terminal -> the terminal value (+1 = player 0
    wins, -1 = player 1, 0 = draw).  The agent draws from a generator on
    the env's device seeded with ``seed``."""
    variables = getattr(agent, "variables", None)
    rng = torch.Generator(device=env.device).manual_seed(seed)
    state = env.init(1)
    moves = 0

    while not bool(env.terminal(state)[0]):
        player = int(env.current_player(state)[0])
        _render(env, state, print_fn)
        legal = legal_actions(env, state)
        if player == human_player:
            while True:
                text = input_fn(f"[P{player}] action index or coords (legal: {legal.tolist()}): ")
                a = _parse_action(env, text.strip())
                if a is not None and a in legal:
                    break
                print_fn(f"illegal move {text!r} — try again")
        else:
            a = agent.choose_host(env, state, variables, rng, moves)
            print_fn(f"[{agent.name}] plays {a}")
        state = env.step(state, torch.tensor([a], dtype=torch.int32, device=env.device))
        moves += 1

    _render(env, state, print_fn)
    value = float(env.terminal_value(state)[0])
    outcome = {1.0: "player 0 wins", -1.0: "player 1 wins"}.get(value, "draw")
    print_fn(f"game over: {outcome} (value {value:+.1f})")
    return value
