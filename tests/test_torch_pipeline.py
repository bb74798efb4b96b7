"""The port's sequential training pipeline end to end on the CPU: SCS 5x5
cut to two turns (games end in a few moves), an 8-filter RecurrentNet,
4 actors, 2 simulations, 2 updates per step.  The journal records carry
the JAX pipeline's keys, the update count is steps x num_samples, a
checkpoint is written and a fresh coordinator resumes from it; the epochs
method sweeps each position at most once and journals the JAX
coordinator's keys; every option the port does not run yet is refused by
name."""

import dataclasses
import os

import pytest
import torch

from nuzero_tpu_torch.config.schemas import (
    CheckpointConfig, LearningConfig, PlottingConfig, RecurrentOptions, RunningConfig,
    SavingConfig, TestingFrequencyConfig, TrainingConfig,
)
from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.recurrent import RecurrentNet
from nuzero_tpu_torch.search.mcts import SearchParams
from nuzero_tpu_torch.training import pipeline
from nuzero_tpu_torch.training.pipeline import AlphaZero

torch.set_num_threads(2)

SCENARIO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "scenarios", "open_field_5.yml")

# The record keys of nuzero_tpu/training/pipeline.py:777-875 on a
# one-game-type sequential run without probes, weight stats or MFU; its
# "time/eval" phase times the in-loop tests (none are due here).
RECORD_KEYS = {
    "step", "games", "buffer_games", "buffer_positions", "buffer_seq", "updates",
    "loss/combined", "loss/policy", "loss/value", "selfplay/root_value",
    "selfplay/tree_full_frac", "selfplay/children_per_node", "step_time_s",
    "selfplay/env_steps_per_s", "time/selfplay", "time/train", "time/eval", "ts",
}


def _config(steps=2, **sections):
    base = dict(
        running=RunningConfig(num_actors=4, training_steps=steps,
                              num_games_per_type_per_step=1),
        testing=TestingFrequencyConfig(policy_test_frequency=0, mcts_test_frequency=0),
        plotting=PlottingConfig(plot_loss=False),
        learning=LearningConfig(replay_window_size=16, batch_size=8, num_samples=2),
        saving=SavingConfig(save_frequency=2),
        recurrent=RecurrentOptions(train_iterations=(2,), alpha=0.5),
    )
    base.update(sections)
    return TrainingConfig(**base)


def _coordinator(run_dir, cfg, **kwargs):
    env = SCSGame(load_scenario(SCENARIO, seed=42, turns=2), device="cpu")
    torch.manual_seed(0)
    net = RecurrentNet(env.observation_shape[0], env.action_space_shape[0], num_filters=8)
    return AlphaZero(env, NetworkManager(net, env.observation_shape), cfg,
                     SearchParams(num_simulations=2), run_dir=run_dir, **kwargs)


def test_two_step_sequential_run(tmp_path):
    az = _coordinator(str(tmp_path), _config())
    state = az.run(seed=0)
    assert state.step == 2 * 2  # steps x num_samples
    records = az.journal.load()
    assert [r["step"] for r in records] == [1, 2]
    for r in records:
        assert set(r) == RECORD_KEYS
        assert r["games"] >= 1 and torch.isfinite(torch.tensor(r["loss/combined"]))
    assert records[-1]["updates"] == 4 and records[-1]["buffer_games"] == az.buffer.num_games
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["FORMAT", "step_00000002.pt"]


@pytest.mark.parametrize("keep_scheduler", [True, False])
def test_load_and_continue(tmp_path, keep_scheduler):
    """A fresh coordinator restores params, optimizer state and buffer from
    the step-2 checkpoint and runs step 3; ``keep_scheduler`` resumes the
    schedule at the restored update count or restarts it at 0."""
    first = _coordinator(str(tmp_path), _config())
    saved = first.run(seed=0)
    cfg = _config(steps=3, checkpoint=CheckpointConfig(keep_scheduler=keep_scheduler))
    az = _coordinator(str(tmp_path), cfg)
    state, step = az.load("auto")
    assert step == 2 and state.step == 4
    for k, v in saved.params.items():
        torch.testing.assert_close(state.params[k], v, rtol=0, atol=0)
        torch.testing.assert_close(state.opt_state["mu"][k], saved.opt_state["mu"][k])
    assert state.opt_state["schedule_count"] == (4 if keep_scheduler else 0)
    assert az.buffer.games_added == first.buffer.games_added
    torch.testing.assert_close(az.buffer.states, first.buffer.states, rtol=0, atol=0)
    state = az.run(seed=1, initial_state=state, starting_step=step)
    assert state.step == 6
    assert state.opt_state["schedule_count"] == (6 if keep_scheduler else 2)
    assert [r["step"] for r in az.journal.load()] == [1, 2, 3]


def test_resume_with_another_window_without_the_buffer(tmp_path):
    """A run saved with one replay window resumes with another and
    ``load_buffer: false`` (the JAX pipeline resumes it: the buffer is not
    part of the restore target then): params and optimizer state restore
    exactly, the buffer keeps the new window and the run goes on."""
    first = _coordinator(str(tmp_path), _config())
    saved = first.run(seed=0)
    cfg = _config(steps=3, learning=LearningConfig(replay_window_size=32, batch_size=8,
                                                   num_samples=2),
                  checkpoint=CheckpointConfig(load_buffer=False, keep_scheduler=True))
    az = _coordinator(str(tmp_path), cfg)
    state, step = az.load("auto")
    assert step == 2 and state.step == 4
    for k, v in saved.params.items():
        torch.testing.assert_close(state.params[k], v, rtol=0, atol=0)
        for moment in ("mu", "nu"):
            torch.testing.assert_close(state.opt_state[moment][k], saved.opt_state[moment][k],
                                       rtol=0, atol=0)
    assert state.opt_state["schedule_count"] == saved.opt_state["schedule_count"] == 4
    assert state.opt_state["count"] == saved.opt_state["count"]
    assert az.buffer.states.shape[0] == 32 and az.buffer.games_added == 0
    state = az.run(seed=1, initial_state=state, starting_step=step)
    assert state.step == 6 and az.buffer.games_added > 0
    assert [r["step"] for r in az.journal.load()] == [1, 2, 3]


def test_epochs_sweep_each_position_at_most_once(tmp_path, monkeypatch):
    seen = []
    gather = pipeline.replay_lib.gather

    def spy(buffer, idx):
        seen.append((idx.tolist(), buffer.length.clone()))
        return gather(buffer, idx)

    monkeypatch.setattr(pipeline.replay_lib, "gather", spy)
    cfg = _config(steps=1, learning=LearningConfig(
        replay_window_size=16, learning_method="epochs", epochs_batch_size=8,
        learning_epochs=2, plot_epochs=True))
    az = _coordinator(str(tmp_path), cfg)
    state = az.run(seed=0)
    n_pos = int(az.buffer.num_positions)
    per_epoch = n_pos // 8
    assert per_epoch >= 1 and state.step == 2 * per_epoch == len(seen)
    L = az.buffer.value.shape[1]
    for e in range(2):
        flat = [i for idx, _ in seen[e * per_epoch:(e + 1) * per_epoch] for i in idx]
        assert len(flat) == len(set(flat)) == 8 * per_epoch
        length = seen[0][1]
        assert all(i % L < int(length[i // L]) for i in flat)
    # The JAX coordinator on the same config journals no loss/epoch* key
    # (its record copies only loss/type*): the port's record holds its keys.
    jax_keys = _jax_record_keys(cfg, str(tmp_path / "jax"))
    assert set(az.journal.load()[-1]) == jax_keys
    assert not any(k.startswith("loss/epoch") for k in jax_keys)


def _jax_record_keys(cfg, run_dir):
    """The keys of the last record of the JAX coordinator's run of ``cfg``
    (the same scenario, net width and search)."""
    from nuzero_tpu.config import schemas as jax_schemas
    from nuzero_tpu.envs.scs import SCSGame as JaxSCSGame
    from nuzero_tpu.envs.scs import load_scenario as jax_load_scenario
    from nuzero_tpu.networks import NetworkManager as JaxManager
    from nuzero_tpu.networks import RecurrentNet as JaxRecurrentNet
    from nuzero_tpu.search.mcts import SearchParams as JaxSearchParams
    from nuzero_tpu.training.pipeline import AlphaZero as JaxAlphaZero

    def section(name):
        value = getattr(cfg, name)
        if not dataclasses.is_dataclass(value):
            return value
        return type(getattr(jax_schemas.TrainingConfig(), name))(**dataclasses.asdict(value))

    jcfg = jax_schemas.TrainingConfig(**{f.name: section(f.name)
                                         for f in dataclasses.fields(cfg)})
    env = JaxSCSGame(jax_load_scenario(SCENARIO, seed=42, turns=2))
    mgr = JaxManager(JaxRecurrentNet(policy_channels=env.action_space_shape[0], num_filters=8),
                     env.observation_shape)
    az = JaxAlphaZero(env, mgr, jcfg, JaxSearchParams(num_simulations=2), run_dir=run_dir)
    az.run(seed=0)
    return set(az.journal.load()[-1])


# The in-loop testing options are ported (tests/test_torch_evaluation.py).
UNPORTED = {
    "running_mode 'asynchronous'": dict(running=RunningConfig(running_mode="asynchronous")),
    "Plotting.plot_loss": dict(plotting=PlottingConfig()),
    "Plotting.plot_weights": dict(plotting=PlottingConfig(plot_loss=False, plot_weights=True)),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_config_options_raise(name):
    with pytest.raises(NotImplementedError, match=name.replace("(", r"\(")):
        _coordinator(None, _config(**UNPORTED[name]))


@pytest.mark.parametrize("name,kwargs", [("state_set", dict(state_set=torch.zeros(1))),
                                         ("mesh", dict(mesh=object()))])
def test_unported_arguments_raise(name, kwargs):
    with pytest.raises(NotImplementedError, match=name):
        _coordinator(None, _config(), **kwargs)


def test_more_than_one_game_type_raises():
    env = SCSGame(load_scenario(SCENARIO, seed=42, turns=2), device="cpu")
    mgr = NetworkManager(RecurrentNet(86, 21, num_filters=8), env.observation_shape)
    with pytest.raises(NotImplementedError, match="more than one game type"):
        AlphaZero([env, env], mgr, _config(), SearchParams(num_simulations=2))


@pytest.mark.parametrize("var", ["NUZERO_MFU", "NUZERO_TRACE_DIR"])
def test_unported_environment_switches_raise(var, monkeypatch):
    monkeypatch.setenv(var, "1")
    with pytest.raises(NotImplementedError, match=var):
        _coordinator(None, _config())


def test_partial_buffer_load_raises(tmp_path):
    """Resuming with load_buffer from a checkpoint saved without its buffer
    is the JAX pipeline's load_buffer_at_step, not ported."""
    cfg = _config(saving=SavingConfig(save_frequency=2, save_buffer=False))
    _coordinator(str(tmp_path), cfg).run(seed=0)
    with pytest.raises(NotImplementedError, match="load_buffer_at_step"):
        _coordinator(str(tmp_path), dataclasses.replace(cfg)).load("auto")
