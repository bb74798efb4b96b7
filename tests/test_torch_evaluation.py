"""The port's evaluation layer (agents, arena, TestManager) and the
pipeline's in-loop tests against the JAX package.

Agents and the arena are compared with JAX's own draws handed in: the JAX
arena splits its key into (seat 0, seat 1, next) every move, and the port's
arena takes each seat's draws for that move through ``Arena(draws=...)``
(the random agent's Gumbel noise, GoalRush's uniform tie-break noise).  The
networks are the deterministic stand-in of ``tests/test_torch_tictactoe.py``
(bit-identical outputs in both frameworks), so actions and ``MatchStats``
must agree exactly.  The in-loop tests run a tiny TTT training run through
both coordinators and compare the journals' keys."""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuzero_tpu.envs import TicTacToe as JaxTicTacToe
from nuzero_tpu.envs.scs import SCSGame as JaxSCSGame
from nuzero_tpu.envs.scs import load_scenario as jax_load_scenario
from nuzero_tpu.evaluation import agents as jax_agents
from nuzero_tpu.evaluation.arena import Arena as JaxArena
from nuzero_tpu.search.mcts import SearchParams as JaxSearchParams
from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.envs.tictactoe import TicTacToe
from nuzero_tpu_torch.evaluation.agents import (
    GoalRushAgent, MctsAgent, PolicyAgent, RandomAgent,
)
from nuzero_tpu_torch.evaluation.arena import Arena
from nuzero_tpu_torch.evaluation.manager import TestManager
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.mlp import MLPNetwork
from nuzero_tpu_torch.networks.recurrent import RecurrentNet
from nuzero_tpu_torch.search.mcts import SearchParams
from nuzero_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_tictactoe import jax_stand_in, stand_in_table, torch_stand_in

torch.set_num_threads(2)

SCENARIOS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "configs", "scenarios")


class StandInManager:
    """A NetworkManager-shaped wrapper of a stand-in net (either framework)."""

    def __init__(self, net):
        self.net = net

    def apply(self, variables, obs, iters_to_do=2, interim_thought=None):
        p, v = self.net(variables, obs)
        return p, v, None


def _tables(seed):
    table = stand_in_table(seed)
    return tuple(jnp.asarray(t) for t in table), tuple(torch.from_numpy(t) for t in table)


def _jax_seat_draws(kind, key, B, A):
    """What the JAX agent of ``kind`` draws from ``key`` for one move."""
    if kind in ("random", "policy"):
        return jax.random.gumbel(key, (B, A))
    if kind == "goal_rush":
        return jax.vmap(lambda k: jax.random.uniform(k, (A,)))(jax.random.split(key, B))
    return None  # the eval-mode search draws nothing


def _jax_arena_draws(key, kinds, B, A, moves):
    """Per move, each seat's draws as the JAX arena hands them out."""
    rng, _ = jax.random.split(key)
    out = []
    for _ in range(moves):
        k0, k1, rng = jax.random.split(rng, 3)
        out.append(tuple(
            None if d is None else torch.from_numpy(np.array(d))
            for d in (_jax_seat_draws(kinds[0], k0, B, A), _jax_seat_draws(kinds[1], k1, B, A))
        ))
    return out


def _agents(kind, seed, sims=8):
    """(JAX agent, port agent) of ``kind`` over the stand-in net."""
    jvars, tvars = _tables(seed)
    if kind == "random":
        return jax_agents.RandomAgent(), RandomAgent()
    if kind == "goal_rush":
        return jax_agents.GoalRushAgent(), GoalRushAgent()
    jmgr, tmgr = StandInManager(jax_stand_in), StandInManager(torch_stand_in)
    if kind == "policy":
        return jax_agents.PolicyAgent(jmgr, jvars), PolicyAgent(tmgr, tvars)
    return (jax_agents.MctsAgent(jmgr, jvars, JaxSearchParams(num_simulations=sims)),
            MctsAgent(tmgr, tvars, SearchParams(num_simulations=sims)))


def _play_both(jenv, tenv, kinds, B, seed=0, max_moves=None, seeds=(0, 1)):
    ja0, ta0 = _agents(kinds[0], seeds[0])
    ja1, ta1 = _agents(kinds[1], seeds[1])
    key = jax.random.key(seed)
    jstats = JaxArena(jenv, ja0.policy(jenv), ja1.policy(jenv)).play(
        B, getattr(ja0, "variables", None), getattr(ja1, "variables", None), key, max_moves)
    moves = max_moves or tenv.max_game_length
    per_move = _jax_arena_draws(key, kinds, B, tenv.num_actions, moves)
    arena = Arena(tenv, ta0.policy(tenv), ta1.policy(tenv),
                  draws=lambda rng, move: per_move[move])
    tstats = arena.play(B, getattr(ta0, "variables", None), getattr(ta1, "variables", None),
                        None, max_moves)
    return jstats, tstats, arena


@pytest.mark.parametrize("kinds", [("random", "random"), ("policy", "policy"),
                                   ("mcts", "policy"), ("policy", "mcts"),
                                   ("random", "policy")])
def test_ttt_matches_match_stats_of_jax(kinds):
    """Whole TTT matches: every field of ``MatchStats`` equal."""
    jstats, tstats, arena = _play_both(JaxTicTacToe(), TicTacToe(device="cpu"), kinds, B=32)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert tstats.p0_wins + tstats.p1_wins + tstats.draws == 32
    assert 5 <= len(arena.seconds_per_move) <= 9


def test_agent_actions_match_jax_on_positions():
    """Each agent's actions on the same batch of mid-game TTT positions
    (random with JAX's Gumbel draws; the policy agent's three fallbacks
    all taken somewhere in the batch; MCTS)."""
    B = 64
    jenv, tenv = JaxTicTacToe(), TicTacToe(device="cpu")
    rng = np.random.default_rng(0)
    jstate = jax.vmap(jenv.init)(jax.random.split(jax.random.key(0), B))
    tstate = tenv.init(B)
    for _ in range(3):
        acts = np.array([rng.choice(np.flatnonzero(r)) for r in tenv.legal_mask(tstate).numpy()],
                        np.int32)
        jstate = jax.vmap(jenv.step)(jstate, jnp.asarray(acts))
        tstate = tenv.step(tstate, torch.from_numpy(acts))
    lengths = np.full(B, 3, np.int32)
    key = jax.random.key(9)
    for kind in ("random", "policy", "mcts"):
        ja, ta = _agents(kind, seed=2)
        want = ja.policy(jenv)(getattr(ja, "variables", None), jstate, jnp.asarray(lengths), key)
        draws = _jax_seat_draws(kind, key, B, 9)
        got = ta.policy(tenv)(getattr(ta, "variables", None), tstate, torch.from_numpy(lengths),
                              None if draws is None else torch.from_numpy(np.array(draws)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=kind)
        assert tenv.legal_mask(tstate)[torch.arange(B), got.long()].all()
    # The stand-in's rows reach every branch of the policy agent's chain.
    logits = torch_stand_in(_tables(2)[1], tenv.observe(tstate))[0]
    legal = tenv.legal_mask(tstate)
    raw_ok = legal.gather(1, logits.argmax(-1, keepdim=True))[:, 0]
    mass = ((logits == 0) & legal).any(-1)
    assert raw_ok.any() and (~raw_ok & mass).any() and (~mass).any()


@pytest.mark.parametrize("name", ["open_field_5.yml", "solo_scout_5.yml",
                                  "river_crossing_10.yml", "solo_soldier_10.yml"])
def test_goal_rush_distance_fields_match_jax(name):
    path = os.path.join(SCENARIOS, name)
    jenv = JaxSCSGame(jax_load_scenario(path, seed=3))
    tenv = SCSGame(load_scenario(path, seed=3), device="cpu")
    want = jax_agents.GoalRushAgent._distance_fields(jenv)
    got = GoalRushAgent._distance_fields(tenv)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_goal_rush_match_matches_jax():
    """Random against GoalRush on ``solo_scout_5.yml``, cut to 60 moves:
    both seats' draws from JAX; ``MatchStats`` equal."""
    path = os.path.join(SCENARIOS, "solo_scout_5.yml")
    jenv = JaxSCSGame(jax_load_scenario(path, seed=3))
    tenv = SCSGame(load_scenario(path, seed=3), device="cpu")
    jstats, tstats, _ = _play_both(jenv, tenv, ("random", "goal_rush"), B=8, max_moves=60)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)


def test_goal_rush_refuses_randomized_vp():
    env = TicTacToe(device="cpu")
    env.randomize_vp = True
    with pytest.raises(ValueError, match="randomize_vp"):
        GoalRushAgent().policy(env)


def _mlp_manager(env):
    return NetworkManager(MLPNetwork(env.observation_shape, 9, hidden_layers=1,
                                     neurons_per_layer=64), env.observation_shape)


def test_run_test_batch_and_visual_test():
    env = TicTacToe(device="cpu")
    tm = TestManager(env)
    s = tm.run_test_batch(64, RandomAgent(), RandomAgent(), show_results=False)
    assert s.p0_wins + s.p1_wins + s.draws == 64 and s.p0_wins > s.p1_wins
    mgr = _mlp_manager(env)
    agent = PolicyAgent(mgr, mgr.init(torch.Generator().manual_seed(0)))
    out = tm.run_visual_test(agent, RandomAgent(), seed=1)
    assert 5 <= out["length"] <= 9 and out["terminal_value"] in (-1.0, 0.0, 1.0)
    assert out == tm.run_visual_test(agent, RandomAgent(), seed=1)
    assert tm.run_visual_test(RandomAgent(), RandomAgent(), seed=2)["length"] >= 5


def _data_test(name, first, last, step, changing_agent, p1, p2):
    return {
        "Test": {"test_type": "data", "Data": {
            "Variable": {"changing_agent": changing_agent, "changing_parameter": {
                "name": name, "Range": {"first": first, "last": last, "step": step}}},
            "Runs": {"num_runs": 2, "num_games_per_run": 8}}},
        "Agents": {"p1_agent": p1, "p2_agent": p2},
    }


def test_iterations_and_checkpoints_sweeps(tmp_path):
    env = TicTacToe(device="cpu")
    mgr = NetworkManager(RecurrentNet(2, 1, num_filters=8, num_blocks=1, hex=False),
                         env.observation_shape)
    tm = TestManager(env)
    policy = {"agent_type": "policy", "Network": {"recurrent_iterations": 1}}
    results = tm.test_from_config(
        _data_test("iterations", 1, 3, 1, 1, policy, {"agent_type": "random"}), manager=mgr)
    assert [v for v, _ in results] == [1, 2, 3]
    for _, rates in results:
        assert abs(sum(rates) - 1.0) < 1e-6
    # Checkpoints of the port's own format, restored per sweep point.
    root = tmp_path / "net" / "checkpoints"
    for step in (1, 2):
        save_checkpoint(str(root), step,
                        {"params": mgr.init(torch.Generator().manual_seed(step)), "step": step})
    loaded = {"agent_type": "policy", "Network": {
        "load_checkpoint": True, "Checkpoint": {"cp_network_name": "net", "cp_number": 1}}}
    results = tm.test_from_config(
        _data_test("checkpoints", 1, 2, 1, 2, {"agent_type": "random"}, loaded),
        manager=mgr, game_dir=str(tmp_path))
    assert [v for v, _ in results] == [1, 2]
    agent = tm.create_agent_from_config(loaded, mgr, str(tmp_path))
    want = mgr.init(torch.Generator().manual_seed(1))
    assert all(torch.equal(agent.variables[k], want[k]) for k in want)
    visual = tm.test_from_config({"Test": {"test_type": "visual"}, "Agents": {
        "p1_agent": policy, "p2_agent": {"agent_type": "random"}}}, manager=mgr)
    assert 5 <= visual["length"] <= 9


def test_board_size_sweep():
    """The env is rebuilt per size through env_factory; both agents play
    on it, GoalRush's distance fields included; the manager's own env
    comes back afterwards."""
    path = os.path.join(SCENARIOS, "solo_scout_5.yml")
    sizes = []

    def env_factory(size):
        env = SCSGame(load_scenario(path, seed=1, board_size=size,
                                    turns=math.ceil(7 * size / 5)), device="cpu")
        sizes.append((size, env.R, env.C))
        return env

    env4 = env_factory(4)
    mgr = NetworkManager(RecurrentNet(env4.observation_shape[0], env4.action_space_shape[0],
                                      num_filters=8, num_blocks=1), env4.observation_shape)
    tm = TestManager(env4)
    cfg = _data_test("board_size", 4, 6, 2, 2, {"agent_type": "goal_rush"},
                     {"agent_type": "policy", "Network": {"recurrent_iterations": 2}})
    results = tm.test_from_config(cfg, manager=mgr, env_factory=env_factory)
    assert [v for v, _ in results] == [4, 6]
    assert (4, 4, 4) in sizes and (6, 6, 6) in sizes and tm.env is env4
    for _, rates in results:
        assert abs(sum(rates) - 1.0) < 1e-6


def test_agent_cache_section_is_refused():
    """An agent's Cache section was refused while the host caches were not
    ported; it now gives the agent its cache, as in the JAX package, and a
    disabled one none.  A network agent without a manager is still refused."""
    from nuzero_tpu_torch.utils.caches import DictCache, KeylessCache

    tm = TestManager(TicTacToe(device="cpu"))
    agent = tm.create_agent_from_config({"agent_type": "random",
                                         "Cache": {"cache_choice": "dict", "max_size": 8}})
    assert isinstance(agent, RandomAgent) and isinstance(agent.cache, DictCache)
    assert agent.cache.max_length() == 8
    keyless = tm.create_agent_from_config({"agent_type": "goal_rush",
                                           "Cache": {"cache_choice": "keyless"}})
    assert isinstance(keyless.cache, KeylessCache) and keyless.cache.max_length() == 8192
    agent = tm.create_agent_from_config(
        {"agent_type": "random", "Cache": {"cache_choice": "disabled"}})
    assert isinstance(agent, RandomAgent) and agent.cache is None
    with pytest.raises(ValueError, match="NetworkManager"):
        tm.create_agent_from_config({"agent_type": "policy"})


# -- in-loop tests of the pipeline ------------------------------------------------

def _training_dict(**testing):
    return {
        "Running": {"running_mode": "sequential", "num_actors": 4, "early_fill_per_type": 0,
                    "training_steps": 2, "Sequential": {"num_games_per_type_per_step": 1}},
        "Saving": {"save_frequency": 100, "save_buffer": False},
        "Testing": {"testing_actors": 4, "num_policy_test_games": 4, "num_mcts_test_games": 2,
                    "early_testing": False, "policy_test_frequency": 0,
                    "mcts_test_frequency": 0, "asynchronous_testing": False, **testing},
        "Plotting": {"plot_loss": False, "plot_weights": False},
        "Recurrent Options": {"train_iterations": [2], "pred_iterations": [2],
                              "test_iterations": 2, "alpha": 0},
        "Learning": {"replay_window_size": 16, "learning_method": "samples",
                     "Samples": {"batch_size": 4, "num_samples": 1, "with_replacement": True,
                                 "late_heavy": False}},
        "Optimizer": {"optimizer_choice": "SGD"},
    }


def _port_journal(d, run_dir, env=None, net=None):
    from nuzero_tpu_torch.config.schemas import training_config_from_dict
    from nuzero_tpu_torch.training.pipeline import AlphaZero

    env = env or TicTacToe(device="cpu")
    mgr = NetworkManager(net or MLPNetwork(env.observation_shape, env.num_actions,
                                           hidden_layers=1, neurons_per_layer=64),
                         env.observation_shape)
    az = AlphaZero(env, mgr, training_config_from_dict(d), SearchParams(num_simulations=2),
                   run_dir=str(run_dir))
    az.run(seed=0)
    return az.journal.load()


def _key_sets(records):
    return sorted((r["step"], r.get("async_test", False), tuple(sorted(set(r) - {"ts"})))
                  for r in records)


@pytest.mark.parametrize("asynchronous", [False, True], ids=["sync", "async"])
def test_inloop_journal_keys_match_jax(asynchronous, tmp_path):
    """Early testing, policy tests every step and MCTS tests every second
    step, inline or on the worker thread: the port's journal holds the
    records and keys of the JAX coordinator's on the same config."""
    from nuzero_tpu.config.schemas import training_config_from_dict as jax_config
    from nuzero_tpu.networks import MLPNetwork as JaxMLPNetwork
    from nuzero_tpu.networks import NetworkManager as JaxManager
    from nuzero_tpu.training.pipeline import AlphaZero as JaxAlphaZero

    d = _training_dict(early_testing=True, policy_test_frequency=1, mcts_test_frequency=2,
                       asynchronous_testing=asynchronous)
    jenv = JaxTicTacToe()
    jaz = JaxAlphaZero(jenv, JaxManager(JaxMLPNetwork(out_features=9, hidden_layers=1,
                                                      neurons_per_layer=64),
                                        jenv.observation_shape),
                       jax_config(d), JaxSearchParams(num_simulations=2),
                       run_dir=str(tmp_path / "jax"))
    jaz.run(seed=0)
    records = _port_journal(d, tmp_path / "port")
    assert _key_sets(records) == _key_sets(jaz.journal.load())
    tested = [r for r in records if "wr/policy_as_p0" in r]
    assert [r["step"] for r in tested] == [0, 1, 2]
    assert all(r.get("async_test", False) == asynchronous for r in tested)
    assert [r["step"] for r in records if "wr/mcts_as_p1" in r] == [0, 2]
    for r in tested:
        for key in ("policy_as_p0", "policy_as_p1"):
            assert 0.0 <= r[f"wr/{key}"] <= r[f"nonloss/{key}"] <= 1.0


TESTING_OPTIONS = {
    "Testing.early_testing": (dict(early_testing=True, policy_test_frequency=5),
                              {0: {"policy"}}),
    "Testing.policy_test_frequency": (dict(policy_test_frequency=2), {2: {"policy"}}),
    "Testing.mcts_test_frequency": (dict(mcts_test_frequency=1),
                                    {1: {"mcts"}, 2: {"mcts"}}),
    "Testing.asynchronous_testing": (dict(policy_test_frequency=1, mcts_test_frequency=2,
                                          asynchronous_testing=True),
                                     {1: {"policy"}, 2: {"policy", "mcts"}}),
    "Testing.goal_rush_opponent": (dict(policy_test_frequency=2, goal_rush_opponent=True),
                                   {2: {"policy", "policy_vs_gr"}}),
}


@pytest.mark.parametrize("name", sorted(TESTING_OPTIONS))
def test_testing_option_runs(name, tmp_path):
    """Each in-loop testing option the port once refused now runs: the
    tests land at the steps it names, with the JAX pipeline's keys
    (``wr/{tag}_as_p{0,1}`` and ``nonloss/...``; asynchronous records carry
    ``async_test`` and their launch step).  GoalRush needs SCS: that case
    runs on ``open_field_5.yml`` cut to two turns."""
    options, want = TESTING_OPTIONS[name]
    env = net = None
    if "goal_rush" in name:
        env = SCSGame(load_scenario(os.path.join(SCENARIOS, "open_field_5.yml"), seed=42,
                                    turns=2), device="cpu")
        net = RecurrentNet(env.observation_shape[0], env.action_space_shape[0], num_filters=8)
    records = _port_journal(_training_dict(**options), tmp_path, env, net)
    got = {}
    for r in records:
        tags = {k[3:].rsplit("_as_p", 1)[0] for k in r if k.startswith("wr/")}
        if tags:
            assert r.get("async_test", False) == options.get("asynchronous_testing", False)
            for tag in tags:
                assert {f"{m}/{tag}_as_p{s}" for m in ("wr", "nonloss") for s in (0, 1)} <= set(r)
            got.setdefault(r["step"], set()).update(tags)
    assert got == want
    assert all("time/eval" in r for r in records if "games" in r)


@pytest.mark.parametrize("name", ["ttt_default.yaml", "ttt_long.yaml"])
def test_shipped_ttt_configs_are_accepted(name):
    """Both shipped TTT configs, as shipped (plot_loss on), leave nothing
    unported: the coordinator builds with their in-loop tests (early, policy
    every 25, MCTS every 50, asynchronous)."""
    from nuzero_tpu_torch.config.schemas import load_search_config, load_training_config
    from nuzero_tpu_torch.training.pipeline import AlphaZero, unported_options

    root = os.path.dirname(SCENARIOS)
    cfg = load_training_config(os.path.join(root, "training", name))
    assert cfg.testing.early_testing and cfg.testing.asynchronous_testing
    assert cfg.plotting.plot_loss
    assert unported_options() == []
    env = TicTacToe(device="cpu")
    az = AlphaZero(env, _mlp_manager(env), cfg,
                   load_search_config(os.path.join(root, "search", "ttt_search.yaml")))
    assert az._test_executor is not None
    # The worker thread's agents apply a module of their own (functional_call
    # swaps a module's tensors while it runs).
    assert az._policy_agent.manager.module is not az.manager.module
    assert az._mcts_agent.manager is az._policy_agent.manager


def test_test_hook_replaces_the_inloop_tests(tmp_path):
    """``test_hook(state, step)`` runs every ``policy_test_frequency`` steps
    in place of the in-loop tests (early testing included), and its
    metrics go into the step's record."""
    from nuzero_tpu_torch.config.schemas import training_config_from_dict
    from nuzero_tpu_torch.training.pipeline import AlphaZero

    env = TicTacToe(device="cpu")
    calls = []

    def hook(state, step):
        calls.append((step, state.step))
        return {"hook/step": step}

    d = _training_dict(early_testing=True, policy_test_frequency=2, mcts_test_frequency=1)
    az = AlphaZero(env, _mlp_manager(env), training_config_from_dict(d),
                   SearchParams(num_simulations=2), run_dir=str(tmp_path), test_hook=hook)
    az.run(seed=0)
    assert calls == [(2, 2)]
    records = az.journal.load()
    assert [r.get("hook/step") for r in records] == [None, 2]
    assert not any(k.startswith(("wr/", "nonloss/")) for r in records for k in r)
