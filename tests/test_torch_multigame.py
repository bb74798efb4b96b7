"""Training one network on several game types in the port (``AlphaZero``
with a list of envs), against the JAX coordinator on the CPU: two
Tic-Tac-Toe types with a 1-block RecurrentNet, per-type recurrent
iteration counts (``tests/test_multigame.py``'s setup)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from nuzero_tpu_torch.config.schemas import (
    LearningConfig, RecurrentOptions, RunningConfig, TestingFrequencyConfig, TrainingConfig,
)
from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.envs.tictactoe import TicTacToe
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.recurrent import RecurrentNet
from nuzero_tpu_torch.search.mcts import SearchParams
from nuzero_tpu_torch.training.pipeline import AlphaZero

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(**running):
    return TrainingConfig(
        running=RunningConfig(**{"num_actors": 8, "training_steps": 2,
                                 "num_games_per_type_per_step": 2, "early_fill_per_type": 4,
                                 **running}),
        learning=LearningConfig(replay_window_size=64, batch_size=16, num_samples=1),
        recurrent=RecurrentOptions(train_iterations=(1, 3), pred_iterations=(1, 2)),
        testing=TestingFrequencyConfig(policy_test_frequency=0, mcts_test_frequency=0),
    )


def _port(cfg, run_dir):
    envs = [TicTacToe(device="cpu"), TicTacToe(device="cpu")]
    torch.manual_seed(0)
    net = RecurrentNet(envs[0].observation_shape[0], 1, num_filters=8, num_blocks=1, hex=False)
    return AlphaZero(envs, NetworkManager(net, envs[0].observation_shape), cfg,
                     SearchParams(num_simulations=4), run_dir=str(run_dir))


def _jax_keys(cfg, run_dir):
    """Each record's step and keys in the JAX coordinator's run of ``cfg``."""
    from nuzero_tpu.config import schemas as jax_schemas
    from nuzero_tpu.envs import TicTacToe as JaxTicTacToe
    from nuzero_tpu.networks import NetworkManager as JaxManager
    from nuzero_tpu.networks import RecurrentNet as JaxRecurrentNet
    from nuzero_tpu.search import SearchParams as JaxSearchParams
    from nuzero_tpu.training import AlphaZero as JaxAlphaZero

    jcfg = jax_schemas.TrainingConfig(**{
        f.name: type(getattr(jax_schemas.TrainingConfig(), f.name))(
            **dataclasses.asdict(getattr(cfg, f.name)))
        if dataclasses.is_dataclass(getattr(cfg, f.name)) else getattr(cfg, f.name)
        for f in dataclasses.fields(cfg)})
    envs = [JaxTicTacToe(), JaxTicTacToe()]
    mgr = JaxManager(JaxRecurrentNet(policy_channels=1, num_filters=8, num_blocks=1, hex=False),
                     envs[0].observation_shape)
    az = JaxAlphaZero(envs, mgr, jcfg, JaxSearchParams(num_simulations=4), run_dir=str(run_dir))
    az.run(seed=0)
    return _keys(az.journal.load())


def _keys(records):
    return sorted((r["step"], tuple(sorted(set(r) - {"ts"}))) for r in records)


def _types_in_buffer(az):
    return set(az.buffer.game_type[az.buffer.length > 0].tolist())


@pytest.mark.parametrize("mode", ["sequential", "asynchronous"])
def test_two_game_types_with_distinct_iterations(mode, tmp_path):
    """Both types play every step, each self-play step evaluates the net at
    its own ``pred_iterations`` entry and each update forwards each type's
    sub-batch at its ``train_iterations`` entry (``loss/type{t}``); the
    buffer holds both types; the records carry the JAX coordinator's keys
    (``selfplay/type{t}/*`` in the sequential mode)."""
    cfg = _config(running_mode=mode)
    az = _port(cfg, tmp_path / "port")
    assert az.learner.config.train_iterations_per_type == (1, 3)
    assert len(az.sp_steps) == len(az.sp_steps_early) == 2
    predicted, trained = [], []
    apply, forward_loss = az.manager.apply, az.learner._forward_loss

    def apply_spy(variables, obs, iters_to_do=2, interim_thought=None):
        predicted.append(iters_to_do)
        return apply(variables, obs, iters_to_do, interim_thought)

    def loss_spy(*args, train_iters=None):
        trained.append(train_iters)
        return forward_loss(*args, train_iters=train_iters)

    az.manager.apply, az.learner._forward_loss = apply_spy, loss_spy
    state = az.run(seed=0)
    assert state.step == 2
    assert set(predicted) == {1, 2} and trained == [1, 3, 1, 3]
    records = az.journal.load()
    assert len(records) == 2
    for r in records:
        assert np.isfinite(r["loss/combined"])
        assert np.isfinite(r["loss/type0"]) and np.isfinite(r["loss/type1"])
        if mode == "sequential":
            assert r["games"] >= 4
            assert r["selfplay/type0/games"] >= 2 and r["selfplay/type1/games"] >= 2
    assert _types_in_buffer(az) == {0, 1}
    assert _keys(records) == _jax_keys(cfg, tmp_path / "jax")


def test_two_game_types_with_the_epochs_method(tmp_path):
    """The epochs method sweeps each type's positions with its own
    permutation, one sub-batch per type per update."""
    cfg = dataclasses.replace(_config(), learning=LearningConfig(
        replay_window_size=64, learning_method="epochs", epochs_batch_size=8,
        learning_epochs=1))
    az = _port(cfg, tmp_path)
    state = az.run(seed=0)
    assert state.step >= 2
    assert all(np.isfinite(r["loss/type1"]) for r in az.journal.load())
    assert _types_in_buffer(az) == {0, 1}


def test_mismatched_shapes_rejected():
    scn = load_scenario(os.path.join(REPO, "configs", "scenarios", "open_field_5.yml"), seed=1)
    envs = [TicTacToe(device="cpu"), SCSGame(scn, device="cpu")]
    mgr = NetworkManager(
        RecurrentNet(envs[0].observation_shape[0], 1, num_filters=8, num_blocks=1, hex=False),
        envs[0].observation_shape)
    with pytest.raises(ValueError, match="share observation"):
        AlphaZero(envs, mgr, TrainingConfig(), SearchParams(num_simulations=4))
