"""Test orchestration (counterpart of ``nuzero_tpu/evaluation/manager.py``;
ref ``Testing/TestManager.py``).

- ``run_test_batch``: play a batch of games between two agents and report
  per-seat win rates (the reference's Ray pool becomes the arena's
  lockstep batch).
- ``test_from_config``: the reference's data tests, a sweep of one
  parameter of one agent (``iterations``, ``checkpoints``) or of the board
  (``board_size``) with ``num_runs`` x ``num_games`` each.
- ``create_agent_from_config``: random, goal_rush, policy and mcts agents,
  restoring the port's own checkpoints (``utils/checkpoint.py``).
- ``run_visual_test``: one game, returning its action history.

Accepts the reference's Testing YAML schema, an agent's ``Cache`` section
included (a host cache for its batch-of-one decisions, ``Agent.set_cache``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from nuzero_tpu_torch.config.schemas import load_search_config
from nuzero_tpu_torch.config.yaml_io import load_yaml
from nuzero_tpu_torch.evaluation.agents import (
    Agent, GoalRushAgent, MctsAgent, PolicyAgent, RandomAgent,
)
from nuzero_tpu_torch.evaluation.arena import Arena, MatchStats
from nuzero_tpu_torch.search.mcts import SearchParams
from nuzero_tpu_torch.utils.caches import create_cache
from nuzero_tpu_torch.utils.checkpoint import restore_checkpoint


class TestManager:
    """Plays every game of a batch at once in one arena, so the reference's
    tester-process count (``Testing.testing_actors``) has no counterpart."""

    __test__ = False  # not a pytest class

    def __init__(self, env):
        self.env = env
        self._arenas = {}
        self.last_arena: Optional[Arena] = None

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the env's device seeded with ``seed``."""
        return torch.Generator(device=self.env.device).manual_seed(seed)

    def _arena(self, p0_policy, p1_policy) -> Arena:
        key = (p0_policy, p1_policy)
        if key not in self._arenas:
            self._arenas[key] = Arena(self.env, p0_policy, p1_policy)
        return self._arenas[key]

    def run_test_batch(self, num_games: int, p0_agent: Agent, p1_agent: Agent, rng=None,
                       show_results: bool = True, max_moves: Optional[int] = None
                       ) -> MatchStats:
        """``rng``: a ``torch.Generator`` on the env's device (default seed 0)."""
        arena = self._arena(p0_agent.policy(self.env), p1_agent.policy(self.env))
        self.last_arena = arena
        stats = arena.play(
            num_games, getattr(p0_agent, "variables", None),
            getattr(p1_agent, "variables", None),
            rng if rng is not None else self.generator(0), max_moves,
        )
        if show_results:
            trunc = f" | truncated {stats.truncated}" if stats.truncated else ""
            print(f"{p0_agent.name} (P1) vs {p1_agent.name} (P2): "
                  f"P1 {stats.p0_win_rate:.1%} | P2 {stats.p1_win_rate:.1%} "
                  f"| draws {stats.draw_rate:.1%} | avg length {stats.avg_length:.1f}{trunc}")
        return stats

    def create_agent_from_config(self, agent_cfg: Dict, manager=None,
                                 game_dir: Optional[str] = None) -> Agent:
        agent = self._create_agent(agent_cfg, manager, game_dir)
        cache_cfg = agent_cfg.get("Cache")
        if cache_cfg and cache_cfg.get("cache_choice", "disabled") != "disabled":
            # Serves host-driven play (visual tests, human games); the
            # batched arena has no batch-of-one inference to cache.
            agent.set_cache(create_cache(cache_cfg["cache_choice"],
                                         int(cache_cfg.get("max_size", 10000))))
        return agent

    def _create_agent(self, agent_cfg: Dict, manager, game_dir: Optional[str]) -> Agent:
        agent_type = agent_cfg["agent_type"]
        if agent_type == "random":
            return RandomAgent()
        if agent_type == "goal_rush":
            return GoalRushAgent()

        net_cfg = agent_cfg.get("Network", {})
        iters = int(net_cfg.get("recurrent_iterations", 2))
        if manager is None:
            raise ValueError(f"{agent_type} agent needs a NetworkManager (model source)")
        if net_cfg.get("load_checkpoint", False):
            ck = net_cfg["Checkpoint"]
            root = os.path.join(game_dir or ".", ck["cp_network_name"], "checkpoints")
            tree, _ = restore_checkpoint(root, ck.get("cp_number", "auto"),
                                         device=self.env.device)
            variables = tree["params"]
        else:
            variables = manager.init(self.generator(0))
        if agent_type == "policy":
            return PolicyAgent(manager, variables, iters)
        if agent_type == "mcts":
            sp_path = agent_cfg.get("search_config_path")
            params = load_search_config(sp_path) if sp_path else SearchParams()
            return MctsAgent(manager, variables, params, iters)
        raise ValueError(f"unknown agent type {agent_type!r}")

    def test_from_config(self, config, manager=None, game_dir: Optional[str] = None,
                         seed: int = 0, env_factory=None):
        """Run the test a Testing YAML (path or dict) describes.

        Data tests return ``[(parameter_value, (p0_wr, p1_wr, draw_rate))]``.
        The changing parameter is ``iterations`` or ``checkpoints`` of the
        changing agent, or ``board_size``, which rebuilds the env for each
        value through ``env_factory(size) -> env`` and plays both agents on
        it; the manager's own env is restored afterwards."""
        cfg = load_yaml(config) if isinstance(config, str) else config
        test = cfg["Test"]
        agents_cfg = cfg["Agents"]
        p0 = self.create_agent_from_config(agents_cfg["p1_agent"], manager, game_dir)
        p1 = self.create_agent_from_config(agents_cfg["p2_agent"], manager, game_dir)
        if test["test_type"] == "visual":
            return self.run_visual_test(p0, p1, seed=seed)

        data = test["Data"]
        changing_agent = int(data["Variable"]["changing_agent"])
        num_runs = int(data["Runs"]["num_runs"])
        num_games = int(data["Runs"]["num_games_per_run"])
        sweep_values: List = [None]
        param_name = None
        if changing_agent != 0:
            param = data["Variable"]["changing_parameter"]
            param_name = param["name"]
            r = param["Range"]
            sweep_values = list(range(int(r["first"]), int(r["last"]) + 1, int(r["step"])))

        target = {1: p0, 2: p1}.get(changing_agent)
        results = []
        rng = self.generator(seed)
        orig_env, orig_arenas = self.env, self._arenas
        try:
            for value in sweep_values:
                if target is not None and param_name == "iterations":
                    target.set_recurrent_iterations(value)
                elif target is not None and param_name == "checkpoints":
                    root = self._checkpoint_root(agents_cfg, changing_agent, game_dir)
                    tree, _ = restore_checkpoint(root, value, device=self.env.device)
                    target.set_network(tree["params"])
                elif param_name == "board_size":
                    if env_factory is None:
                        raise ValueError("board_size sweeps need env_factory(size) -> env")
                    self.env = env_factory(value)
                    self._arenas = {}
                wins0 = wins1 = draws = total = 0
                for _ in range(num_runs):
                    stats = self.run_test_batch(num_games, p0, p1, rng, show_results=False)
                    wins0 += stats.p0_wins
                    wins1 += stats.p1_wins
                    draws += stats.draws
                    total += stats.num_games
                point = (value, (wins0 / total, wins1 / total, draws / total))
                results.append(point)
                label = f"{param_name}={value}: " if value is not None else ""
                print(f"{label}P1 {point[1][0]:.1%} | P2 {point[1][1]:.1%} | "
                      f"draws {point[1][2]:.1%}")
        finally:
            self.env, self._arenas = orig_env, orig_arenas
        return results

    @staticmethod
    def _checkpoint_root(agents_cfg, changing_agent, game_dir):
        key = "p1_agent" if changing_agent == 1 else "p2_agent"
        ck = agents_cfg[key]["Network"]["Checkpoint"]
        return os.path.join(game_dir or ".", ck["cp_network_name"], "checkpoints")

    def run_visual_test(self, p0_agent: Agent, p1_agent: Agent, seed: int = 0):
        """Play ONE game move by move -> its action history, final value and
        length (ref ``TestManager.run_visual_test`` + ``Tester``)."""
        env = self.env
        agents = (p0_agent, p1_agent)
        rng = self.generator(seed)
        state = env.init(1)
        history = []
        while not bool(env.terminal(state)[0]):
            seat = int(env.current_player(state)[0])
            agent = agents[seat]
            a = agent.choose_host(env, state, getattr(agent, "variables", None), rng,
                                  len(history))
            if not bool(env.legal_mask(state)[0, a]):
                raise AssertionError("agent chose an illegal move")
            history.append(a)
            state = env.step(state, torch.tensor([a], dtype=torch.int32, device=env.device))
        return {"actions": history, "terminal_value": float(env.terminal_value(state)[0]),
                "length": len(history)}
