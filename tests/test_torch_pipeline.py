"""The port's sequential training pipeline end to end on the CPU: SCS 5x5
cut to two turns (games end in a few moves), an 8-filter RecurrentNet,
4 actors, 2 simulations, 2 updates per step.  The journal records carry
the JAX pipeline's keys, the update count is steps x num_samples, a
checkpoint is written and a fresh coordinator resumes from it; the epochs
method sweeps each position at most once and journals the JAX
coordinator's keys.

Then the options ported since, against the JAX coordinator on Tic-Tac-Toe
with the MLP (the JAX package's own pipeline tests' setup): value probes,
weight stats, plots, the asynchronous mode, the partial buffer load,
``NUZERO_MFU`` and ``NUZERO_TRACE_DIR``; a mesh is still refused."""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from nuzero_tpu_torch.config.schemas import (
    CheckpointConfig, LearningConfig, OptimizerConfig, PlottingConfig, RecurrentOptions,
    RunningConfig, SavingConfig, TestingFrequencyConfig, TrainingConfig,
)
from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.envs.tictactoe import TicTacToe
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.mlp import MLPNetwork
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

    def spy(buffer, idx, mesh=None):
        seen.append((idx.tolist(), buffer.length.clone()))
        return gather(buffer, idx, mesh)

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


def _jax_config(cfg):
    """The JAX package's ``TrainingConfig`` with the fields of ``cfg``."""
    from nuzero_tpu.config import schemas as jax_schemas

    def section(name):
        value = getattr(cfg, name)
        if not dataclasses.is_dataclass(value):
            return value
        return type(getattr(jax_schemas.TrainingConfig(), name))(**dataclasses.asdict(value))

    return jax_schemas.TrainingConfig(**{f.name: section(f.name)
                                         for f in dataclasses.fields(cfg)})


def _jax_record_keys(cfg, run_dir):
    """The keys of the last record of the JAX coordinator's run of ``cfg``
    (the same scenario, net width and search)."""
    from nuzero_tpu.envs.scs import SCSGame as JaxSCSGame
    from nuzero_tpu.envs.scs import load_scenario as jax_load_scenario
    from nuzero_tpu.networks import NetworkManager as JaxManager
    from nuzero_tpu.networks import RecurrentNet as JaxRecurrentNet
    from nuzero_tpu.search.mcts import SearchParams as JaxSearchParams
    from nuzero_tpu.training.pipeline import AlphaZero as JaxAlphaZero

    jcfg = _jax_config(cfg)
    env = JaxSCSGame(jax_load_scenario(SCENARIO, seed=42, turns=2))
    mgr = JaxManager(JaxRecurrentNet(policy_channels=env.action_space_shape[0], num_filters=8),
                     env.observation_shape)
    az = JaxAlphaZero(env, mgr, jcfg, JaxSearchParams(num_simulations=2), run_dir=run_dir)
    az.run(seed=0)
    return set(az.journal.load()[-1])




def test_a_mesh_is_accepted():
    """Every option of the JAX coordinator runs on the port, a mesh too: a
    one-rank mesh builds a coordinator whose ring holds the whole window."""
    from nuzero_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(rank=0, size=1, device=torch.device("cpu"))
    assert pipeline.unported_options() == []
    assert pipeline.unported_options(mesh=mesh) == []
    az = _coordinator(None, _config(), mesh=mesh)
    assert az.mesh is mesh and az.learner.mesh is mesh
    assert az.buffer.capacity == az.cfg.learning.replay_window_size


def test_shipped_scs_recipe_is_accepted_with_plots_and_a_state_set():
    """``run.py`` training preset 3's recipe as shipped: ``scs_small.yaml``
    (plots on), ``scs_search.yaml``, ``solo_scout_5.yml`` with per-game
    victory points and the solo state set."""
    from nuzero_tpu_torch.config.schemas import load_search_config, load_training_config
    from nuzero_tpu_torch.evaluation import solo_state_set

    root = os.path.dirname(os.path.dirname(SCENARIO))
    cfg = load_training_config(os.path.join(root, "training", "scs_small.yaml"))
    assert cfg.plotting.plot_loss
    env = SCSGame(load_scenario(os.path.join(root, "scenarios", "solo_scout_5.yml"), seed=42),
                  randomize_vp=True, device="cpu")
    net = RecurrentNet(env.observation_shape[0], env.action_space_shape[0], num_filters=8)
    az = AlphaZero(env, NetworkManager(net, env.observation_shape), cfg,
                   load_search_config(os.path.join(root, "search", "scs_search.yaml")),
                   state_set=solo_state_set(env))
    assert az.state_set.shape == (6,) + env.observation_shape


# -- the options against the JAX coordinator: Tic-Tac-Toe with the MLP -------------

def _ttt_config(steps=4, **sections):
    """``tests/test_pipeline.py``'s setup: 8 actors, an early fill of 8
    games, 2 games a step, one update of 16 a step."""
    base = dict(
        running=RunningConfig(num_actors=8, training_steps=steps,
                              num_games_per_type_per_step=2, early_fill_per_type=8),
        testing=TestingFrequencyConfig(policy_test_frequency=0, mcts_test_frequency=0),
        learning=LearningConfig(replay_window_size=64, batch_size=16, num_samples=1),
        optimizer=OptimizerConfig(starting_lr=1e-3),
        saving=SavingConfig(save_frequency=2),
    )
    base.update(sections)
    return TrainingConfig(**base)


def _ttt_port(cfg, run_dir, state_set=None):
    env = TicTacToe(device="cpu")
    torch.manual_seed(0)
    mgr = NetworkManager(MLPNetwork(env.observation_shape, 9, hidden_layers=1,
                                    neurons_per_layer=64), env.observation_shape)
    return AlphaZero(env, mgr, cfg, SearchParams(num_simulations=8),
                     run_dir=None if run_dir is None else str(run_dir),
                     state_set=None if state_set is None else torch.from_numpy(state_set))


def _ttt_jax(cfg, run_dir, state_set=None):
    import jax.numpy as jnp

    from nuzero_tpu.envs import TicTacToe as JaxTicTacToe
    from nuzero_tpu.networks import MLPNetwork as JaxMLPNetwork
    from nuzero_tpu.networks import NetworkManager as JaxManager
    from nuzero_tpu.search.mcts import SearchParams as JaxSearchParams
    from nuzero_tpu.training.pipeline import AlphaZero as JaxAlphaZero

    env = JaxTicTacToe()
    mgr = JaxManager(JaxMLPNetwork(out_features=9, hidden_layers=1, neurons_per_layer=64),
                     env.observation_shape)
    return JaxAlphaZero(env, mgr, _jax_config(cfg), JaxSearchParams(num_simulations=8),
                        run_dir=None if run_dir is None else str(run_dir),
                        state_set=None if state_set is None else jnp.asarray(state_set))


def _key_sets(records):
    """Each record's step and keys, in step order."""
    return sorted((r["step"], tuple(sorted(set(r) - {"ts"}))) for r in records)


def _port_params(jax_params):
    from nuzero_tpu_torch.networks.convert import mlp_state_dict

    return {k: torch.from_numpy(np.array(v)) for k, v in mlp_state_dict(jax_params).items()}


def test_value_probes_match_jax(tmp_path):
    """``tests/test_pipeline.py:221``: probes journaled at steps 2 and 4,
    in [-1, 1], under the JAX coordinator's keys; the port's probe values
    on the JAX run's final parameters equal the JAX run's last probes
    within 1e-5."""
    shape = (3,) + TicTacToe(device="cpu").observation_shape
    probes = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    cfg = _ttt_config(plotting=PlottingConfig(plot_frequency=2))
    jaz = _ttt_jax(cfg, tmp_path / "jax", probes)
    jax_state = jaz.run(seed=0)
    az = _ttt_port(cfg, tmp_path / "port", probes)
    az.run(seed=0)
    records, jax_records = az.journal.load(), jaz.journal.load()
    assert _key_sets(records) == _key_sets(jax_records)
    probed = [r for r in records if "value_probe/0" in r]
    assert [r["step"] for r in probed] == [2, 4]
    for r in probed:
        assert all(-1.0 <= r[f"value_probe/{i}"] <= 1.0 for i in range(3))
    got = az.probe_values(_port_params(jax_state.params))
    want = [jax_records[-1][f"value_probe/{i}"] for i in range(3)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_value_probes_of_the_committed_rvp_run_match_jax():
    """The committed ``scs_solo_rvp_r5`` weights (``run.py`` preset 3's run)
    on the solo state set, each package's coordinator on ``scs_small.yaml``
    (4 prediction iterations): within 1e-5."""
    from nuzero_tpu.config.run_meta import build_from_meta as jax_build_from_meta
    from nuzero_tpu.config.schemas import load_search_config as jax_search
    from nuzero_tpu.config.schemas import load_training_config as jax_training
    from nuzero_tpu.envs.scs import SCSGame as JaxSCSGame
    from nuzero_tpu.envs.scs import load_scenario as jax_load_scenario
    from nuzero_tpu.evaluation import solo_state_set as jax_solo_state_set
    from nuzero_tpu.training.pipeline import AlphaZero as JaxAlphaZero
    from nuzero_tpu.utils.checkpoint import restore_checkpoint as jax_restore
    from nuzero_tpu_torch.config.run_meta import build_from_meta, load_run_meta
    from nuzero_tpu_torch.config.schemas import load_search_config, load_training_config
    from nuzero_tpu_torch.evaluation import solo_state_set
    from nuzero_tpu_torch.utils.checkpoint import restore_checkpoint

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = os.path.join(root, "runs", "scs_solo_rvp_r5")
    asset = os.path.join(root, "nuzero_tpu_torch", "assets", "runs", "scs_solo_rvp_r5")
    train = os.path.join(root, "configs", "training", "scs_small.yaml")
    search = os.path.join(root, "configs", "search", "scs_search.yaml")
    solo = os.path.join(root, "configs", "scenarios", "solo_scout_5.yml")
    meta = load_run_meta(run)

    _, jmgr = jax_build_from_meta(meta, root)
    jenv = JaxSCSGame(jax_load_scenario(solo, seed=42), randomize_vp=True)
    jset = jax_solo_state_set(jenv)
    jaz = JaxAlphaZero(jenv, jmgr, jax_training(train), jax_search(search), state_set=jset)
    tree, _ = jax_restore(os.path.join(run, "checkpoints"), "auto")
    want = np.asarray(jaz._probe_values(tree["params"], jset)).reshape(-1)

    _, mgr = build_from_meta(meta, root, device="cpu")
    env = SCSGame(load_scenario(solo, seed=42), randomize_vp=True, device="cpu")
    az = AlphaZero(env, mgr, load_training_config(train), load_search_config(search),
                   state_set=solo_state_set(env))
    params, _ = restore_checkpoint(os.path.join(asset, "checkpoints"), device="cpu")
    got = az.probe_values(params["params"])
    assert len(got) == 6
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_weight_stats_and_automatic_plots_match_jax(tmp_path):
    """``tests/test_pipeline.py:319``: ``weights/*`` at every step under
    the JAX coordinator's keys, min <= mean <= max (the minimum may be 0:
    zero biases); the port's stats of the JAX run's final parameters equal
    the JAX run's last ones within 1e-6 of ``abs_max``; the run leaves the
    JAX coordinator's plot files with no checkpoint on the way."""
    cfg = _ttt_config(steps=2, plotting=PlottingConfig(plot_weights=True, plot_frequency=1),
                      saving=SavingConfig(save_frequency=100))
    jaz = _ttt_jax(cfg, tmp_path / "jax")
    jax_state = jaz.run(seed=0)
    az = _ttt_port(cfg, tmp_path / "port")
    az.run(seed=0)
    records, jax_records = az.journal.load(), jaz.journal.load()
    assert _key_sets(records) == _key_sets(jax_records)
    r = records[-1]
    assert 0 <= r["weights/abs_min"] <= r["weights/abs_mean"] <= r["weights/abs_max"]
    assert r["weights/abs_max"] > 0
    got = az.weight_stats(_port_params(jax_state.params))
    want = [jax_records[-1][f"weights/abs_{k}"] for k in ("max", "min", "mean")]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * want[0])
    names = set(os.listdir(tmp_path / "port" / "plots"))
    assert {"loss_global.png", "loss_recent.png", "weights.png"} <= names
    assert names == set(os.listdir(tmp_path / "jax" / "plots"))
    assert not os.path.exists(tmp_path / "port" / "checkpoints")


# A journal with every series the plots read.
_SERIES = [
    {"step": i, "loss/combined": 1.0 / (i + 1), "loss/policy": 0.5, "loss/value": 0.25,
     "step_time_s": 0.1, "wr/policy_as_p0": 0.5, "nonloss/policy_as_p0": 0.75,
     "value_probe/0": 0.1, "value_probe/1": -0.2, "weights/abs_max": 1.0,
     "weights/abs_min": 0.001, "weights/abs_mean": 0.1}
    for i in range(1, 4)
]


@pytest.mark.parametrize("include_loss", [True, False], ids=["plot_loss", "plot_loss_off"])
def test_plot_files_equal_jax_on_the_same_journal(include_loss, tmp_path):
    """``tests/test_pipeline.py:356``: ``plot_training_run`` writes the JAX
    package's file names from the same journal; with ``plot_loss`` off no
    loss plot."""
    from nuzero_tpu.utils.plots import plot_training_run as jax_plot_training_run
    from nuzero_tpu_torch.utils.plots import plot_training_run

    got = plot_training_run(_SERIES, str(tmp_path / "port"), include_loss=include_loss)
    want = jax_plot_training_run(_SERIES, str(tmp_path / "jax"), include_loss=include_loss)
    assert sorted(map(os.path.basename, got)) == sorted(map(os.path.basename, want))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(map(os.path.basename, got))
    assert any("loss" in os.path.basename(p) for p in got) == include_loss


def test_asynchronous_mode_matches_jax(tmp_path):
    """``tests/test_pipeline.py:79``: the asynchronous running mode, one
    update a step for 3 steps, journals the JAX coordinator's keys."""
    cfg = _ttt_config(steps=3, running=RunningConfig(num_actors=8, training_steps=3,
                                                     running_mode="asynchronous",
                                                     early_fill_per_type=8))
    jaz = _ttt_jax(cfg, tmp_path / "jax")
    jaz.run(seed=0)
    az = _ttt_port(cfg, tmp_path / "port")
    state = az.run(seed=0)
    assert state.step == 3
    records = az.journal.load()
    assert _key_sets(records) == _key_sets(jaz.journal.load())
    assert all(r["games"] >= 0 and r["selfplay/env_steps_per_s"] > 0 for r in records)


def test_asynchronous_update_delay(tmp_path):
    """``tests/test_pipeline.py:149``: each step plays move-batches until
    ``update_delay`` seconds have passed since it began (always at least
    one), so no step is shorter than the delay; the host never runs more
    than ``PIPELINE_DEPTH`` batches ahead of the counts it has read."""
    import time

    cfg = _ttt_config(steps=2, running=RunningConfig(num_actors=8, training_steps=2,
                                                     running_mode="asynchronous",
                                                     update_delay=0.3, early_fill_per_type=8))
    az = _ttt_port(cfg, tmp_path)
    queued = []
    launch = az._launch

    def counted(move, pending):
        queued.append(len(pending))
        return launch(move, pending)

    az._launch = counted
    t0 = time.time()
    state = az.run(seed=0)
    assert state.step == 2
    assert time.time() - t0 >= 2 * 0.3
    assert queued and max(queued) <= az.PIPELINE_DEPTH
    for r in az.journal.load():
        assert r["step_time_s"] >= 0.3 and r["time/selfplay"] > 0


def test_partial_buffer_load_by_step(tmp_path):
    """``tests/test_pipeline.py:132``: resuming at step 2 from the step-4
    checkpoint's buffer keeps exactly the games inserted up to step 2."""
    az = _ttt_port(_ttt_config(), tmp_path)
    az.run(seed=0)
    seq_at_2 = next(r["buffer_seq"] for r in az.journal.load() if r["step"] == 2)
    az2 = _ttt_port(_ttt_config(), tmp_path)
    assert az2.load_buffer_at_step(2)
    assert int(az2.buffer.games_added) == seq_at_2
    assert int(az2.buffer.seq.max()) == seq_at_2 - 1
    assert not _ttt_port(_ttt_config(), tmp_path).load_buffer_at_step(7)


def test_partial_buffer_load_equals_jax_on_the_same_buffer(tmp_path):
    """The JAX run's buffer and journal, written as a port run: the port's
    ``load_buffer_at_step(2)`` leaves the buffer field for field equal to
    the JAX coordinator's, and so does ``load`` of a step-2 checkpoint that
    holds no buffer."""
    from nuzero_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = _ttt_config()
    jaz = _ttt_jax(cfg, tmp_path / "jax")
    jax_state = jaz.run(seed=0)
    port_dir = tmp_path / "port"
    os.makedirs(port_dir)
    with open(tmp_path / "jax" / "journal.jsonl") as src, \
            open(port_dir / "journal.jsonl", "w") as dst:
        dst.write(src.read())
    az = _ttt_port(cfg, port_dir)
    template = az.learner.init_state(torch.Generator().manual_seed(0))
    tree = {"params": _port_params(jax_state.params), "opt_state": template.opt_state,
            "step": 2}
    save_checkpoint(str(port_dir / "checkpoints"), 2, tree)
    buffer = {f: torch.from_numpy(np.array(getattr(jaz.buffer, f)))
              for f in ("states", "policy", "value", "length", "game_type", "seq")}
    buffer.update(ptr=int(jaz.buffer.ptr), games_added=int(jaz.buffer.games_added))
    save_checkpoint(str(port_dir / "checkpoints"), 4, dict(tree, step=4, buffer=buffer))

    jaz2 = _ttt_jax(cfg, tmp_path / "jax")
    assert jaz2.load_buffer_at_step(2) and az.load_buffer_at_step(2)
    for field in ("states", "policy", "value", "length", "game_type", "seq", "ptr",
                  "games_added"):
        np.testing.assert_array_equal(getattr(az.buffer, field).numpy(),
                                      np.asarray(getattr(jaz2.buffer, field)), err_msg=field)
    os.remove(port_dir / "checkpoints" / "step_00000004.pt")
    save_checkpoint(str(port_dir / "checkpoints"), 4, dict(tree, step=4, buffer=buffer))
    resumed = _ttt_port(cfg, port_dir)
    _, step = resumed.load(2)
    assert step == 2
    np.testing.assert_array_equal(resumed.buffer.seq.numpy(), az.buffer.seq.numpy())


def test_resume_without_any_buffer_warns_and_keeps_the_empty_buffer(tmp_path):
    """``load_buffer`` on, no checkpoint holds a buffer: the JAX coordinator
    goes on with its empty buffer and says nothing; the port reaches the
    same buffer and warns, naming the step."""
    cfg = _ttt_config(steps=2, saving=SavingConfig(save_frequency=2, save_buffer=False))
    jaz = _ttt_jax(cfg, tmp_path / "jax")
    jaz.run(seed=0)
    _ttt_port(cfg, tmp_path / "port").run(seed=0)
    jaz2 = _ttt_jax(cfg, tmp_path / "jax")
    _, jax_step = jaz2.load("auto")
    az = _ttt_port(cfg, tmp_path / "port")
    with pytest.warns(UserWarning, match="no replay buffer to restore at step 2") as caught:
        state, step = az.load("auto")
    assert len(caught) == 1 and step == jax_step == 2 and state.step == 2
    for field in ("length", "seq", "game_type", "ptr", "games_added"):
        np.testing.assert_array_equal(getattr(az.buffer, field).numpy(),
                                      np.asarray(getattr(jaz2.buffer, field)), err_msg=field)
    assert az.buffer.num_games == 0


def _analytic_forward_flops(mgr, batch, iterations):
    """2 * M * 7 * Cin * Cout for each hex conv (``hex_conv_plain`` is one
    ``[M, 7 Cin] @ [7 Cin, Cout]`` product, M = batch x board) and
    2 * batch * K * N for each dense product, each layer as often as the
    forward runs it: the recurrent cell's ``iterations`` times."""
    from nuzero_tpu_torch.networks.blocks import Dense, HexConv

    total = 0
    board = math.prod(mgr.observation_shape[1:])
    for name, module in mgr.module.named_modules():
        times = iterations if name.startswith("cell.") else 1
        if isinstance(module, HexConv):
            _, cin, cout = module.weight.shape
            total += times * 2 * batch * board * 7 * cin * cout
        elif isinstance(module, Dense):
            cout, cin = module.weight.shape
            total += times * 2 * batch * cin * cout
    return total


@pytest.mark.parametrize("game", ["scs", "ttt"])
def test_mfu_counts_the_analytic_flops(game, tmp_path, monkeypatch):
    """``NUZERO_MFU``: every record carries ``train_flops_per_s`` > 0, and the
    count is 3x the analytic FLOPs of one forward at the train batch size
    (the hex RecurrentNet at its prediction iterations; the MLP)."""
    monkeypatch.setenv("NUZERO_MFU", "1")
    if game == "scs":
        az = _coordinator(str(tmp_path), _config())
        batch, iterations = 8, az.cfg.recurrent.pred_iterations[0]
    else:
        az = _ttt_port(_ttt_config(steps=2), tmp_path)
        batch, iterations = 16, 1
    state = az.run(seed=0)
    records = az.journal.load()
    assert records and all(r["train_flops_per_s"] > 0 for r in records)
    flops = _analytic_forward_flops(az.manager, batch, iterations)
    assert flops > 0 and az.train_flops(state.params) == 3 * flops


def test_mfu_journal_keys_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("NUZERO_MFU", "1")
    cfg = _ttt_config(steps=2)
    jaz = _ttt_jax(cfg, tmp_path / "jax")
    jaz.run(seed=0)
    az = _ttt_port(cfg, tmp_path / "port")
    az.run(seed=0)
    assert _key_sets(az.journal.load()) == _key_sets(jaz.journal.load())
    assert all("train_flops_per_s" in r for r in az.journal.load())


def test_flop_count_against_xla_cost_analysis():
    """The basis of the count for ``scs_solo_rvp_r5``'s 64f net at the
    recipe's 4 iterations: the port counts the hex conv's 7 taps; XLA's
    cost analysis of the JAX net (what the JAX coordinator journals, on
    the CPU here) counts its dual 3x3 conv by its own rule."""
    port, xla = flop_counts()
    assert port == _analytic_forward_flops(_rvp_manager(), 1, 4)
    assert 0.6 < xla / port < 0.7


def _rvp_manager():
    from nuzero_tpu_torch.config.run_meta import build_from_meta, load_run_meta

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    meta = load_run_meta(os.path.join(root, "runs", "scs_solo_rvp_r5"))
    return build_from_meta(meta, root, device="cpu")[1]


def flop_counts(batch=1, iterations=4):
    """(the port's count, XLA:CPU's cost analysis) of one forward of the
    64f ``scs_solo_rvp_r5`` net."""
    import jax
    import jax.numpy as jnp

    from nuzero_tpu.config.run_meta import build_from_meta as jax_build_from_meta
    from nuzero_tpu_torch.config.run_meta import load_run_meta

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _, jmgr = jax_build_from_meta(load_run_meta(os.path.join(root, "runs", "scs_solo_rvp_r5")),
                                  root)
    obs = jnp.zeros((batch,) + tuple(jmgr.observation_shape), jnp.float32)
    cost = (jax.jit(lambda v, o: jmgr.apply(v, o, iters_to_do=iterations)[:2])
            .lower(jmgr.init(jax.random.key(0)), obs).compile().cost_analysis())
    cost = cost[0] if isinstance(cost, list) else cost
    mgr = _rvp_manager()
    meta = {k: torch.empty_like(v, device="meta")
            for k, v in mgr.init(torch.Generator().manual_seed(0)).items()}
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        mgr.apply(meta, torch.empty((batch,) + mgr.observation_shape, device="meta"),
                  iters_to_do=iterations)
    return counter.get_total_flops(), float(cost["flops"])


def test_trace_dir_gets_a_chrome_trace(tmp_path, monkeypatch):
    """``NUZERO_TRACE_DIR``: step ``starting_step + 2`` is traced and its
    Chrome trace written into the directory, with the port's spans of the
    step among its events, each launch tagged with its move-batch number."""
    import json

    monkeypatch.setenv("NUZERO_TRACE_DIR", str(tmp_path / "trace"))
    az = _ttt_port(_ttt_config(steps=3), tmp_path / "run")
    az.run(seed=0)
    assert os.listdir(tmp_path / "trace") == ["step_00000002.trace.json"]
    with open(tmp_path / "trace" / "step_00000002.trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    names = {e.get("name") for e in events}
    for span in ("nuzero.phase.selfplay", "nuzero.selfplay.launch", "nuzero.learner.update"):
        assert span in names, span
    tags = [e["args"].get("tag") for e in events if e.get("name") == "nuzero.selfplay.launch"]
    assert tags and all(isinstance(t, int) for t in tags), tags


def test_a_run_without_matplotlib_draws_nothing_and_warns_once(tmp_path, monkeypatch):
    """matplotlib hidden: the run completes, no plot is written, and one
    warning names matplotlib."""
    import sys

    from nuzero_tpu_torch.utils import plots

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    plots._pyplot.cache_clear()
    try:
        az = _ttt_port(_ttt_config(steps=2), tmp_path)
        with pytest.warns(plots.MissingMatplotlibWarning, match="matplotlib") as caught:
            state = az.run(seed=0)
            assert az.render_plots() == []
        assert len([w for w in caught if w.category is plots.MissingMatplotlibWarning]) == 1
    finally:
        plots._pyplot.cache_clear()
    assert state.step == 2 and len(az.journal.load()) == 2
    assert not os.path.exists(tmp_path / "plots")


if __name__ == "__main__":
    port, xla = flop_counts(batch=256)
    print(f"scs_solo_rvp_r5 64f, 4 iterations, B=256: port {port}, XLA:CPU {xla:.0f}, "
          f"ratio {xla / port:.4f}")
