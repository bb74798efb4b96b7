"""Probe state sets for value-head tracking (counterpart of
``nuzero_tpu/evaluation/state_sets.py``).

The reference hand-builds small sets of artificial SCS positions and plots
the value head's output on each of them every plot step, giving a direct
view of whether the network has learned the value of canonical positions
(ref ``Run.py:427-579`` builders; probe tracking
``Training/AlphaZero.py:1175-1179``).

Each builder reproduces the reference's probe positions for its scenario
family (coordinates and turns taken from the reference's builders;
player labels converted from the reference's 1-based {1,2} to this
framework's canonical {0,1}).  A probe spec is ``(turn, [(player, row,
col), ...])``; ``build_state_set`` turns specs into a stacked observation
batch ready for batched inference.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

Spec = Tuple[int, List[Tuple[int, int, int]]]

# (ref create_mirrored_state_set, Run.py:427-463)
MIRRORED_SPECS: Sequence[Spec] = (
    (9, [(1, 0, 1)]),
    (9, [(1, 0, 1), (1, 1, 1), (0, 0, 0)]),
    (9, [(1, 4, 4)]),
    (9, [(1, 0, 1), (1, 0, 1), (0, 0, 0), (0, 0, 0)]),
    (9, [(0, 4, 3), (0, 3, 3), (1, 4, 4)]),
    (9, [(0, 4, 4)]),
)

# (ref create_unbalanced_state_set, Run.py:465-501)
UNBALANCED_SPECS: Sequence[Spec] = (
    (7, [(1, 0, 1)]),
    (7, [(1, 0, 1), (1, 1, 1), (0, 0, 0)]),
    (7, [(1, 4, 4)]),
    (7, [(1, 2, 2), (0, 2, 1)]),
    (7, [(0, 3, 0)]),
    (7, [(0, 4, 4)]),
)

# (ref create_r_unbalanced_state_set, Run.py:503-539)
R_UNBALANCED_SPECS: Sequence[Spec] = (
    (7, [(1, 1, 2)]),
    (7, [(1, 0, 1), (0, 4, 3)]),
    (7, [(0, 2, 3), (1, 3, 3)]),
    (7, [(0, 1, 4), (0, 2, 2), (1, 2, 3)]),
    (7, [(0, 1, 4)]),
    (7, [(0, 4, 3), (0, 4, 3)]),
)

# (ref create_solo_state_set, Run.py:541-579)
SOLO_SPECS: Sequence[Spec] = (
    (7, [(1, 0, 0)]),
    (7, [(1, 0, 3)]),
    (7, [(1, 1, 2)]),
    (7, [(1, 2, 3)]),
    (7, [(1, 2, 4)]),
    (7, [(1, 4, 4)]),
)


def build_state_set(game, specs: Sequence[Spec]) -> torch.Tensor:
    """Stack probe observations: f32 [num_probes, *observation_shape] on
    the env's device."""
    return torch.cat([game.observe(game.simple_state(turn, pl)) for turn, pl in specs])


def mirrored_state_set(game) -> torch.Tensor:
    return build_state_set(game, MIRRORED_SPECS)


def unbalanced_state_set(game) -> torch.Tensor:
    return build_state_set(game, UNBALANCED_SPECS)


def r_unbalanced_state_set(game) -> torch.Tensor:
    return build_state_set(game, R_UNBALANCED_SPECS)


def solo_state_set(game) -> torch.Tensor:
    return build_state_set(game, SOLO_SPECS)


STATE_SET_BUILDERS = {
    "mirrored": mirrored_state_set,
    "unbalanced": unbalanced_state_set,
    "r_unbalanced": r_unbalanced_state_set,
    "solo": solo_state_set,
}
