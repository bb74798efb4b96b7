"""The learning milestone of ``tests/test_learning_milestone.py`` through the
port's ``AlphaZero.run()`` on the card.

Recipe as there: ``configs/training/ttt_long.yaml`` (2400 steps, SGD at lr
0.05, 4x1024 samples per step, in-loop tests early, policy every 25 and
MCTS every 50 steps, asynchronous) with ``configs/search/ttt_search.yaml``
(100 simulations) and ``RecurrentNet(hex=False, num_filters=64,
num_blocks=2)``; plots off (the card machine has no matplotlib).  The bars
are the JAX test's: the raw policy network reaches >= 90% non-loss as
player 0 and >= 70% as player 1 against random, the MCTS agent >= 95% on
both seats, and the policy loss halves.

Slow (a long training run) and card-only:

    NUZERO_SLOW=1 python -m pytest tests/test_torch_milestone.py --noconftest -q -s

It prints the step at which each bar was first met, the last in-loop win
rates and the run's wall time.
"""

import os
import time

import pytest
import torch

pytestmark = [
    pytest.mark.skipif(not os.environ.get("NUZERO_SLOW"),
                       reason="slow learning run; set NUZERO_SLOW=1 to enable"),
    pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card"),
]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _first_step(records, bar):
    hits = sorted(r["step"] for r in records if bar(r))
    return hits[0] if hits else None


def _assert_milestones(records):
    """The JAX test's asserts (``tests/test_learning_milestone.py:50-75``)."""
    pol_hits = [r for r in records if r.get("nonloss/policy_as_p0", 0) >= 0.90
                and r.get("nonloss/policy_as_p1", 0) >= 0.70]
    assert pol_hits, "raw policy never reached 90%/70% non-loss (P0/P1) vs random"
    mcts_hits = [r for r in records if r.get("nonloss/mcts_as_p0", 0) >= 0.95
                 and r.get("nonloss/mcts_as_p1", 0) >= 0.95]
    assert mcts_hits, "MCTS agent never reached 95% non-loss on both seats"
    losses = [r["loss/policy"] for r in records if "loss/policy" in r]
    assert losses[-1] < 0.5 * losses[0]


@pytest.mark.cuda
def test_ttt_policy_network_learns_on_card(tmp_path):
    import dataclasses

    from nuzero_tpu_torch.config.schemas import load_search_config, load_training_config
    from nuzero_tpu_torch.envs.tictactoe import TicTacToe
    from nuzero_tpu_torch.networks.manager import NetworkManager
    from nuzero_tpu_torch.networks.recurrent import RecurrentNet
    from nuzero_tpu_torch.training.pipeline import AlphaZero

    cfg = load_training_config(os.path.join(REPO, "configs", "training", "ttt_long.yaml"))
    cfg = dataclasses.replace(cfg, plotting=dataclasses.replace(cfg.plotting, plot_loss=False))
    search = load_search_config(os.path.join(REPO, "configs", "search", "ttt_search.yaml"))
    env = TicTacToe("cuda")
    net = RecurrentNet(env.observation_shape[0], env.action_space_shape[0], num_filters=64,
                       num_blocks=2, hex=False).cuda()
    az = AlphaZero(env, NetworkManager(net, env.observation_shape), cfg, search,
                   run_dir=str(tmp_path))
    t0 = time.perf_counter()
    az.run(seed=0)
    seconds = time.perf_counter() - t0
    records = az.journal.load()
    tests = sorted((r for r in records if "nonloss/policy_as_p0" in r), key=lambda r: r["step"])
    policy_bar = _first_step(records, lambda r: r.get("nonloss/policy_as_p0", 0) >= 0.90
                             and r.get("nonloss/policy_as_p1", 0) >= 0.70)
    mcts_bar = _first_step(records, lambda r: r.get("nonloss/mcts_as_p0", 0) >= 0.95
                           and r.get("nonloss/mcts_as_p1", 0) >= 0.95)
    losses = [r["loss/policy"] for r in records if "loss/policy" in r]
    last = tests[-1]
    print(f"\nmilestone: {cfg.running.training_steps} steps in {seconds:.1f} s; policy "
          f"90%/70% bar first at step {policy_bar}, MCTS 95%/95% bar first at step "
          f"{mcts_bar}; policy loss {losses[0]:.4f} -> {losses[-1]:.4f}; last tests (step "
          f"{last['step']}): " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(last.items())
                                           if k.startswith(("wr/", "nonloss/"))))
    _assert_milestones(records)
