"""The port's PettingZoo AEC wrapper (``nuzero_tpu_torch/envs/aec.py``; ref
``Run.py:328-345``: the reference runs ``pettingzoo.test.api_test`` over
SCS_Game), mirroring ``tests/test_aec.py``, and held against the JAX
package's wrapper: the same actions give the same observations, masks,
rewards and agent turns (exact).  Skips where pettingzoo is not installed
(the card machine has none)."""

import os

import numpy as np
import pytest

pytest.importorskip("pettingzoo", reason="the AEC wrapper needs pettingzoo")

from nuzero_tpu.envs import TicTacToe as JaxTicTacToe  # noqa: E402
from nuzero_tpu.envs.aec import AECAdapter as JaxAECAdapter  # noqa: E402
from nuzero_tpu.envs.scs import SCSGame as JaxSCSGame  # noqa: E402
from nuzero_tpu.envs.scs import load_scenario as jax_load_scenario  # noqa: E402
from nuzero_tpu_torch.envs.aec import AECAdapter  # noqa: E402
from nuzero_tpu_torch.envs.scs.game import SCSGame  # noqa: E402
from nuzero_tpu_torch.envs.scs.scenario import load_scenario  # noqa: E402
from nuzero_tpu_torch.envs.tictactoe import TicTacToe  # noqa: E402

SCENARIO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "scenarios", "open_field_5.yml")


def _random_aec_playout(aec, seed):
    aec.reset(seed=seed)
    rng = np.random.default_rng(seed)
    steps = 0
    totals = {a: 0.0 for a in aec.agents}
    for agent in aec.agent_iter(max_iter=2000):
        obs, reward, terminated, truncated, info = aec.last()
        totals[agent] += reward
        if terminated or truncated:
            aec.step(None)
            continue
        action = int(rng.choice(np.flatnonzero(info["action_mask"])))
        aec.step(action)
        steps += 1
    return steps, totals


def test_ttt_aec_playout():
    aec = AECAdapter(TicTacToe(device="cpu"))
    steps, totals = _random_aec_playout(aec, 0)
    assert 5 <= steps <= 9
    assert aec.agents == []  # all agents terminated and removed
    assert totals[0] == -totals[1]  # zero-sum


def test_scs_aec_playout():
    aec = AECAdapter(SCSGame(load_scenario(SCENARIO, seed=1), device="cpu"))
    steps, totals = _random_aec_playout(aec, 2)
    assert steps > 10
    assert aec.agents == []
    assert totals[0] == -totals[1]


def test_pettingzoo_api_test():
    from pettingzoo.test import api_test

    api_test(AECAdapter(TicTacToe(device="cpu")), num_cycles=20, verbose_progress=False)


def _trace(aec, actions):
    """(agent, observation, mask, reward, terminated) before each step of
    ``actions`` (None for a dead agent's step)."""
    aec.reset(seed=0)
    out = []
    for agent, a in zip(aec.agent_iter(max_iter=len(actions)), actions):
        obs, reward, term, trunc, info = aec.last()
        out.append((agent, obs, info["action_mask"], reward, term))
        aec.step(a)
    return out


@pytest.mark.parametrize("game", ["ttt", "scs"])
def test_same_observations_as_jax(game):
    """A random legal game played through both wrappers, move for move."""
    if game == "ttt":
        aec, jaec = AECAdapter(TicTacToe(device="cpu")), JaxAECAdapter(JaxTicTacToe())
    else:
        aec = AECAdapter(SCSGame(load_scenario(SCENARIO, seed=1), device="cpu"))
        jaec = JaxAECAdapter(JaxSCSGame(jax_load_scenario(SCENARIO, seed=1)))
    aec.reset(seed=0)
    rng = np.random.default_rng(3)
    actions = []
    for _ in aec.agent_iter(max_iter=20):
        _, _, term, trunc, info = aec.last()
        a = None if term or trunc else int(rng.choice(np.flatnonzero(info["action_mask"])))
        actions.append(a)
        aec.step(a)
    got, want = _trace(aec, actions), _trace(jaec, actions)
    assert len(got) == len(want) == len(actions) > 5
    for (agent, obs, mask, reward, term), (j_agent, j_obs, j_mask, j_reward, j_term) in zip(
            got, want):
        assert (agent, reward, term) == (j_agent, j_reward, j_term)
        np.testing.assert_array_equal(obs, j_obs)
        np.testing.assert_array_equal(mask, j_mask)
    assert aec.render() == jaec.render()
