# Frozen copy of nuzero_tpu_torch/envs/scs/scenario.py for the benchmark's plain reference;
# only its imports were rewritten.  It is never edited to follow the port.
"""SCS scenario loading: YAML -> packed static arrays.

Duplicate of ``nuzero_tpu/envs/scs/scenario.py`` (pure NumPy), kept in the
port so that it imports without JAX.

Behavioral target: ``SCS_Game.load_game_from_config``
(ref ``Games/SCS/SCS_Game.py:1570-1777``).  Accepts the reference's scenario
YAML schema unchanged (``Games/SCS/Game_configs/*.yml``): board dims, turns,
stacking limit, unit types, per-turn reinforcement schedules with Default
(own board half) or Detailed arrival locations, terrain types with
attack/defense modifiers and movement cost, Randomized-by-distribution or
Detailed maps, Randomized-per-side or Detailed victory points.

Randomized maps/VPs reproduce the reference's exact RNG call sequence
(``np.random.seed(seed)`` then row-major ``np.random.choice`` draws,
ref ``:1575-1576,1680-1744``) so a given (config, seed) pair yields the
bit-identical board — the foundation of the trajectory-parity tests.

The object model (Unit/Tile/Terrain instances) becomes flat arrays: the
full set of units that can ever exist IS the reinforcement schedule, so
each player's units live in one table indexed by schedule order; terrain
is three f32 boards; arrival locations are per-unit boolean masks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

import yaml


def load_yaml(path):
    with open(path) as f:
        return yaml.safe_load(f)


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    rows: int
    cols: int
    turns: int
    stacking_limit: int
    # terrain boards
    terrain_attack: np.ndarray  # f32[R, C]
    terrain_defense: np.ndarray  # f32[R, C]
    terrain_cost: np.ndarray  # f32[R, C]
    # victory points: vp[p] True where player p OWNS a VP location
    vp: np.ndarray  # bool[2, R, C]
    n_vp: Tuple[int, int]
    # flat reinforcement schedule per player, sorted by arrival turn
    reinf_stats: np.ndarray  # f32[2, S, 3] attack/defense/movement
    reinf_turn: np.ndarray  # i32[2, S] (padded entries = turns + 1)
    reinf_arrival: np.ndarray  # bool[2, S, R, C]
    reinf_count: np.ndarray  # i32[2]

    @property
    def units_per_player(self) -> int:
        return self.reinf_stats.shape[1]

    @property
    def max_game_length(self) -> int:
        """Hard bound on decision count.

        Per unit per turn: <= floor(allowance / min_cost) moves + 1
        no-move/no-fight + 1 attacker selection; per player per turn up to
        S targets + S confirms.  Generously padded.
        """
        min_cost = max(float(self.terrain_cost.min()), 1e-6)
        max_allow = float(self.reinf_stats[:, :, 2].max()) if self.reinf_stats.size else 1.0
        moves_per_unit = int(math.ceil(max_allow / min_cost)) + 3
        s = int(self.reinf_count.max())
        per_turn = 2 * s * (moves_per_unit + 3)
        return (self.turns + 1) * per_turn + 2 * s + 16

    def board_sides(self) -> Tuple[int, int]:
        return board_sides(self.cols)


def board_sides(cols: int) -> Tuple[int, int]:
    """(p1_last_index, p2_first_index) (ref ``define_board_sides``,
    ``SCS_Game.py:1140-1158``)."""
    if cols % 2 != 0:
        middle = cols // 2
        return middle - 1, middle + 1
    mid = cols // 2
    left_index = mid - 1
    right_index = mid  # (mid + 1) - 1
    return max(0, left_index - 1), min(cols - 1, right_index + 1)


def load_scenario(path: str, seed=None, board_size=None, turns=None) -> Scenario:
    """``board_size``/``turns`` override the YAML's Board_dimensions/Turns
    — the board-size-transfer experiment (nets trained on small maps
    evaluated on larger ones, ref ``Plots/sizes/*.png`` +
    ``Plots/PlotMaker.py:20-35``) resizes one scenario family instead of
    shipping a YAML per size the way the reference did."""
    data = load_yaml(path)
    if board_size is not None:
        data = dict(data)
        data["Board_dimensions"] = {
            "rows": int(board_size), "columns": int(board_size)
        }
    if turns is not None:
        data = dict(data)
        data["Turns"] = int(turns)
        # The reinforcement schedule carries turns + 1 entries (turn 0 =
        # initial placement): pad with empty turns / trim to match.
        reinf = data.get("Reinforcements")
        if reinf and "schedule" in reinf:
            schedule = {
                p: (list(lists) + [[]] * (int(turns) + 1))[: int(turns) + 1]
                for p, lists in reinf["schedule"].items()
            }
            data["Reinforcements"] = dict(reinf, schedule=schedule)
    return scenario_from_dict(data, seed)


def scenario_from_dict(data, seed=None) -> Scenario:
    """Build a Scenario from an in-memory config mapping (same schema as the
    YAML files; used by :mod:`scenario_gen` to skip the disk round-trip)."""
    if seed:
        np.random.seed(seed)

    name = data.get("Name", "Default_Game")
    rows = int(data["Board_dimensions"]["rows"])
    cols = int(data["Board_dimensions"]["columns"])
    turns = int(data["Turns"])
    stacking = int(data["Stacking_limit"])
    p1_last, p2_first = board_sides(cols)

    # ---- unit & terrain catalogs ------------------------------------------
    units_by_id = {}
    for unit_name, props in data["Units"].items():
        units_by_id[props["id"]] = {
            "name": unit_name,
            "attack": float(props["attack"]),
            "defense": float(props["defense"]),
            "movement": float(props["movement"]),
        }
    terrain_by_id = {}
    terrain_order = []  # insertion order = reference's terrain_types order
    for terrain_name, props in data["Terrain"].items():
        terrain_by_id[props["id"]] = {
            "name": terrain_name,
            "attack_modifier": float(props["attack_modifier"]),
            "defense_modifier": float(props["defense_modifier"]),
            "cost": float(props["cost"]),
        }
        terrain_order.append(props["id"])

    # ---- reinforcements ----------------------------------------------------
    reinf = data["Reinforcements"]
    schedule = reinf["schedule"]
    arrival = reinf["arrival"]
    arrival_method = arrival["method"]

    default_arrival = np.zeros((2, rows, cols), bool)
    default_arrival[0, :, : p1_last + 1] = True
    default_arrival[1, :, p2_first:] = True

    per_player = {0: [], 1: []}  # list of (turn, stats, arrival_mask)
    detailed_idx = [0, 0]
    for p_key, turn_lists in schedule.items():
        player = int(p_key[-1]) - 1
        if len(turn_lists) != turns + 1:
            raise ValueError(
                "Reinforcement schedule should have 'turns + 1' entries "
                "(turn 0 = initial placement; ref SCS_Game.py:1629-1632)"
            )
        for turn_idx, turn_units in enumerate(turn_lists):
            for uid in turn_units or []:
                u = units_by_id[uid]
                if arrival_method == "Default":
                    mask = default_arrival[player]
                elif arrival_method == "Detailed":
                    locs = arrival["locations"][f"p{player + 1}"][
                        detailed_idx[player]
                    ]
                    detailed_idx[player] += 1
                    mask = np.zeros((rows, cols), bool)
                    for (r, c) in [tuple(pt) for pt in locs]:
                        mask[r, c] = True
                else:
                    raise ValueError(f"bad arrival method {arrival_method!r}")
                per_player[player].append(
                    (
                        turn_idx,
                        (u["attack"], u["defense"], u["movement"]),
                        mask.copy(),
                    )
                )

    S = max(len(per_player[0]), len(per_player[1]), 1)
    reinf_stats = np.zeros((2, S, 3), np.float32)
    reinf_turn = np.full((2, S), turns + 1, np.int32)
    reinf_arrival = np.zeros((2, S, rows, cols), bool)
    reinf_count = np.zeros(2, np.int32)
    for p in (0, 1):
        for i, (t, stats, mask) in enumerate(per_player[p]):
            reinf_stats[p, i] = stats
            reinf_turn[p, i] = t
            reinf_arrival[p, i] = mask
        reinf_count[p] = len(per_player[p])

    # ---- map ---------------------------------------------------------------
    map_cfg = data["Map"]
    t_attack = np.ones((rows, cols), np.float32)
    t_defense = np.ones((rows, cols), np.float32)
    t_cost = np.ones((rows, cols), np.float32)
    method = map_cfg["creation_method"]
    if method == "Randomized":
        distribution = map_cfg.get("distribution")
        if not distribution:
            n = len(terrain_by_id)
            distribution = [1.0 / n] * n
        # Same draw sequence as the reference (row-major np.random.choice
        # with p; ref SCS_Game.py:1687-1691).
        for i in range(rows):
            for j in range(cols):
                k = np.random.choice(len(terrain_order), p=distribution)
                t = terrain_by_id[terrain_order[int(k)]]
                t_attack[i, j] = t["attack_modifier"]
                t_defense[i, j] = t["defense_modifier"]
                t_cost[i, j] = t["cost"]
    elif method == "Detailed":
        grid = map_cfg["map_configuration"]
        if np.shape(grid) != (rows, cols):
            raise ValueError("Wrong shape for map configuration")
        for i in range(rows):
            for j in range(cols):
                t = terrain_by_id[grid[i][j]]
                t_attack[i, j] = t["attack_modifier"]
                t_defense[i, j] = t["defense_modifier"]
                t_cost[i, j] = t["cost"]
    else:
        raise ValueError(f"bad map creation method {method!r}")

    # ---- victory points ----------------------------------------------------
    vp_cfg = data["Victory_points"]
    vp = np.zeros((2, rows, cols), bool)
    method = vp_cfg["creation_method"]
    if method == "Randomized":
        counts = (vp_cfg["number_vp"]["p1"], vp_cfg["number_vp"]["p2"])
        col_ranges = (
            list(range(p1_last + 1)),
            list(range(p2_first, cols)),
        )
        for p in (0, 1):
            avail = rows * len(col_ranges[p])
            if counts[p] > avail:
                raise ValueError(f"too many victory points for p{p + 1}")
            chosen = []
            for _ in range(counts[p]):
                # Rejection sampling in the reference's exact draw order
                # (ref SCS_Game.py:1724-1744).
                row = int(np.random.choice(range(rows)))
                col = int(np.random.choice(col_ranges[p]))
                while (row, col) in chosen:
                    row = int(np.random.choice(range(rows)))
                    col = int(np.random.choice(col_ranges[p]))
                chosen.append((row, col))
                vp[p, row, col] = True
    elif method == "Detailed":
        for p, key in ((0, "p1"), (1, "p2")):
            seen = []
            for point in vp_cfg["vp_locations"][key]:
                if len(point) != 2:
                    raise ValueError(f"{point} -> points must have 2 coords")
                pt = (int(point[0]), int(point[1]))
                if pt in seen:
                    raise ValueError(f"{pt} -> repeated point")
                seen.append(pt)
                vp[p, pt[0], pt[1]] = True
    else:
        raise ValueError(f"bad victory-point creation method {method!r}")

    return Scenario(
        name=name,
        rows=rows,
        cols=cols,
        turns=turns,
        stacking_limit=stacking,
        terrain_attack=t_attack,
        terrain_defense=t_defense,
        terrain_cost=t_cost,
        vp=vp,
        n_vp=(int(vp[0].sum()), int(vp[1].sum())),
        reinf_stats=reinf_stats,
        reinf_turn=reinf_turn,
        reinf_arrival=reinf_arrival,
        reinf_count=reinf_count,
    )
