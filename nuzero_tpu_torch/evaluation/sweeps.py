"""The DeepThinking transfer sweeps of ``run.py``'s testing presets 2 and 3,
as library functions of the port.

    python -m nuzero_tpu_torch.evaluation.sweeps --preset 2|3 --name RUN --out DIR
        [--games N] [--game-dir DIR] [--device cuda]

A trained run (its ``run_meta.yaml`` and port checkpoints under
``game_dir/RUN``; by default the committed runs in
``nuzero_tpu_torch/assets/runs``) plays seat 1 ("p2") as a ``PolicyAgent``
against a random agent in seat 0 on ``solo_scout_5.yml`` (seed 42), where
only player 1 owns a unit, so a point's win rate is the scout's rate of
reaching its goal.  The agents are built inside
``TestManager.test_from_config`` from a Testing YAML dict, the checkpoint
loaded by ``cp_number: auto``:

- preset 2, ``iteration_sweep``: the test-time recurrent iterations swept
  over ``iterations`` on the 5x5 map, the scenario's fixed victory points;
  writes ``iteration_sweep.json`` (``checkpoint_step``, ``results``);
- preset 3, ``size_sweep``: the board swept over ``sizes`` at each count of
  ``iterations``, turns ``ceil(7 * size / 5)``, each game's victory points
  drawn per game (``randomize_vp``); writes ``size_sweep.json``
  (``checkpoint_step``, ``train_size``, ``turn_rule``, ``curves``).

The JSON has ``run.py``'s schema.  It goes into ``out_dir``, never into the
run's directory, beside the sweep's plot (``iteration_sweep.png``,
``size_sweep.png``; ``utils/plots.py``, which draws nothing where
matplotlib is not installed).
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Iterable, Optional

from nuzero_tpu_torch.config.run_meta import build_from_meta, load_run_meta
from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.evaluation.manager import TestManager
from nuzero_tpu_torch.utils.checkpoint import latest_step
from nuzero_tpu_torch.utils.plots import plot_iteration_sweep, plot_size_sweep

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GAME_DIR = os.path.join(REPO, "nuzero_tpu_torch", "assets", "runs")
SCENARIO = os.path.join(REPO, "configs", "scenarios", "solo_scout_5.yml")
BASE_SIZE, BASE_TURNS = 5, 7
TURN_RULE = "ceil(7 * size / 5)"


def size_env(size: int, device="cuda") -> SCSGame:
    """``solo_scout_5.yml`` (seed 42) resized to ``size`` x ``size`` with
    ``ceil(7 * size / 5)`` turns and per-game victory points (``run.py``
    preset 3's ``env_factory``)."""
    scenario = load_scenario(SCENARIO, seed=42, board_size=size,
                             turns=math.ceil(BASE_TURNS * size / BASE_SIZE))
    return SCSGame(scenario, randomize_vp=True, device=device)


def policy_test(run_name: str, parameter: str, first: int, last: int, step: int,
                games: int, iterations: int = 2) -> dict:
    """The Testing YAML dict of both presets: a random agent as p1, the
    run's latest checkpoint as a ``PolicyAgent`` p2 at ``iterations``, and
    ``parameter`` of p2 (or the board) swept over ``range(first, last + 1,
    step)``."""
    return {
        "Test": {
            "test_type": "data",
            "Data": {
                "Variable": {
                    "changing_agent": 2,
                    "changing_parameter": {
                        "name": parameter,
                        "Range": {"first": first, "last": last, "step": step},
                    },
                },
                "Runs": {"num_runs": 1, "num_games_per_run": games},
            },
        },
        "Agents": {
            "p1_agent": {"agent_type": "random"},
            "p2_agent": {
                "agent_type": "policy",
                "Network": {
                    "recurrent_iterations": iterations,
                    "load_checkpoint": True,
                    "Checkpoint": {"cp_network_name": run_name, "cp_number": "auto"},
                },
            },
        },
    }


def _evenly(values: Iterable[int]):
    """(first, last, step) of an evenly spaced, increasing sequence."""
    values = list(values)
    step = values[1] - values[0] if len(values) > 1 else 1
    if values != list(range(values[0], values[-1] + 1, step)):
        raise ValueError(f"{values} is not an evenly spaced increasing range")
    return values[0], values[-1], step


def _run(run_name: str, game_dir: str, device):
    """(NetworkManager, checkpoint step) of a run."""
    meta = load_run_meta(os.path.join(game_dir, run_name))
    if meta is None:
        raise FileNotFoundError(f"no run_meta.yaml in {os.path.join(game_dir, run_name)}")
    _, manager = build_from_meta(meta, REPO, device=device)
    return manager, latest_step(os.path.join(game_dir, run_name, "checkpoints"))


def _write(record: dict, out_dir: Optional[str], name: str) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(record, f, indent=1)


def iteration_sweep(run_name: str, game_dir: str = GAME_DIR, out_dir: Optional[str] = None,
                    iterations: Iterable[int] = range(2, 21, 2), games: int = 64,
                    seed: int = 0, device="cuda"):
    """Preset 2 -> the ``iteration_sweep.json`` record."""
    manager, step = _run(run_name, game_dir, device)
    env = SCSGame(load_scenario(SCENARIO, seed=42), device=device)
    tm = TestManager(env)
    results = tm.test_from_config(
        policy_test(run_name, "iterations", *_evenly(iterations), games),
        manager=manager, game_dir=game_dir, seed=seed)
    record = {
        "checkpoint_step": step,
        "results": [{"iterations": v, "p0_wr": wr[0], "p1_wr": wr[1], "draw_rate": wr[2]}
                    for v, wr in results],
    }
    _write(record, out_dir, "iteration_sweep.json")
    if out_dir:
        plot_iteration_sweep(
            results, os.path.join(out_dir, "iteration_sweep.png"),
            title=f"{run_name} step {step}: win rate vs recurrent iterations", seat=1)
    return record


def size_sweep(run_name: str, game_dir: str = GAME_DIR, out_dir: Optional[str] = None,
               sizes: Iterable[int] = range(5, 16, 2), iterations: Iterable[int] = (2, 6, 24),
               games: int = 64, seed: int = 0, device="cuda"):
    """Preset 3 -> the ``size_sweep.json`` record."""
    manager, step = _run(run_name, game_dir, device)
    curves, raw = {}, {}
    for iters in iterations:
        tm = TestManager(size_env(BASE_SIZE, device))
        results = tm.test_from_config(
            policy_test(run_name, "board_size", *_evenly(sizes), games, iterations=iters),
            manager=manager, game_dir=game_dir, seed=seed,
            env_factory=lambda size: size_env(size, device))
        raw[f"{iters} iterations"] = results
        curves[f"{iters} iterations"] = [
            {"board_size": v, "p0_wr": wr[0], "p1_wr": wr[1], "draw_rate": wr[2]}
            for v, wr in results]
    record = {"checkpoint_step": step, "train_size": BASE_SIZE, "turn_rule": TURN_RULE,
              "curves": curves}
    _write(record, out_dir, "size_sweep.json")
    if out_dir:
        plot_size_sweep(
            raw, os.path.join(out_dir, "size_sweep.png"),
            title=f"{run_name} step {step}: 5x5-trained scout vs board size", seat=1,
            train_size=BASE_SIZE)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="run.py's testing presets 2 and 3 on the port")
    ap.add_argument("--preset", type=int, choices=(2, 3), required=True)
    ap.add_argument("--name", required=True, help="the run's directory under --game-dir")
    ap.add_argument("--out", required=True, help="directory for the sweep's JSON and plot")
    ap.add_argument("--games", type=int, default=64, help="games per point")
    ap.add_argument("--game-dir", default=GAME_DIR)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sweep = iteration_sweep if args.preset == 2 else size_sweep
    record = sweep(args.name, args.game_dir, args.out, games=args.games, device=args.device)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
