"""Data-parallel training across processes: the port's ``parallel`` package
and ``AlphaZero(..., mesh=...)`` against the JAX package's mesh.

The multi-process cases start ranks as subprocesses of the test (gloo on
the CPU, one thread each, a free port, a timeout): the placements, the
sampler and one learner update (against JAX's learner on a ``make_mesh`` of
the 8 virtual CPU devices, its inputs and result computed here and handed
over by file); a one-rank mesh run against a run without a mesh; and the
mirrors of ``tests/test_distributed.py::test_two_process_integrated_training``
(TTT + MLP) and ``tests/test_mesh_scs.py::test_two_process_scs_training``
(SCS ``solo_scout_5.yml`` with per-game victory points, an 8-filter hex
RecurrentNet), each with params bit-equal across ranks (a SHA-256 of their
bytes), the journal written once, the checkpoint written once and resumed
at 2 ranks.  The learner's tolerance is 1e-5 of each tensor's largest
value: the same sums in another order (XLA's dual 3x3 conv against the
gathered matmul), then one more sum across the ranks."""

import json
import math
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuzero_tpu.networks import NetworkManager as JaxManager
from nuzero_tpu.networks import RecurrentNet as JaxRecurrentNet
from nuzero_tpu.parallel import make_mesh as jax_make_mesh
from nuzero_tpu.parallel import place_batch_sharded as jax_place_batch_sharded
from nuzero_tpu.parallel import place_replicated as jax_place_replicated
from nuzero_tpu.training.learner import Learner as JaxLearner
from nuzero_tpu.training.learner import LearnerConfig as JaxLearnerConfig
from nuzero_tpu.training.learner import TrainState as JaxTrainState
from nuzero_tpu_torch.config.schemas import RunningConfig, TrainingConfig
from nuzero_tpu_torch.envs.tictactoe import TicTacToe
from nuzero_tpu_torch.networks.convert import recurrent_net_state_dict
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.mlp import MLPNetwork
from nuzero_tpu_torch.parallel import distributed
from nuzero_tpu_torch.parallel.mesh import Mesh, batch_sharding
from nuzero_tpu_torch.search.mcts import SearchParams
from nuzero_tpu_torch.training.pipeline import AlphaZero

from conftest import cpu_devices

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS, ACTIONS = (86, 5, 5), 21 * 25

# What every worker starts with: one thread, the repository on the path,
# and this rank joined to a gloo group of WORLD ranks at COORD.
PRELUDE = r"""
import hashlib, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, %(repo)r)
RANK, COORD, WORLD, OUT = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), sys.argv[4]
from nuzero_tpu_torch.parallel.distributed import initialize_distributed, is_multi_host, local_shard
initialize_distributed(COORD, WORLD, RANK, backend="gloo")
from nuzero_tpu_torch.parallel import make_mesh
mesh = make_mesh("cpu")

def digest(params):
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()

def report(**kw):
    with open(os.path.join(OUT, f"rank{RANK}.json"), "w") as f:
        json.dump(kw, f)
"""

# Placements, the sampler and one learner update.
UNIT_WORKER = PRELUDE + r"""
from nuzero_tpu_torch.parallel import place_batch_sharded, place_replicated
from nuzero_tpu_torch.training import replay
from nuzero_tpu_torch.training.learner import Learner, LearnerConfig, TrainState
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.recurrent import RecurrentNet
assert is_multi_host() and local_shard(8) == 4
try:
    local_shard(7)
    raise AssertionError("local_shard(7) over 2 ranks did not raise")
except ValueError as e:
    assert str(e) == "global batch 7 not divisible by 2", e

tree = {"a": torch.arange(8.0) + 100 * RANK, "b": torch.arange(5.0) + 100 * RANK,
        "c": torch.tensor(3.0 + RANK), "d": [torch.ones(4, 2) * RANK]}
sharded = place_batch_sharded(tree, mesh)
replicated = place_replicated(tree, mesh)
placed = {"sharded_a": sharded["a"].tolist(), "sharded_b": sharded["b"].tolist(),
          "sharded_c": sharded["c"].item(), "sharded_d": sharded["d"][0].tolist(),
          "replicated_a": replicated["a"].tolist()}

data = np.load(os.path.join(OUT, "inputs.npz"))
G = data["length"].shape[0] // WORLD
ring = replay.ReplayBuffer(**{
    k: torch.from_numpy(data[k][RANK * G:(RANK + 1) * G].copy())
    for k in ("states", "policy", "value", "length", "game_type", "seq")},
    ptr=0, games_added=int(data["games_added"][RANK]))
draws = {}
for i, wr in enumerate((True, False)):
    rows = replay.sample(ring, torch.Generator().manual_seed(i), 12, with_replacement=wr,
                         mesh=mesh)
    draws.update({f"sample{i}_{j}": r.numpy() for j, r in enumerate(rows)})
perm = replay.epoch_permutation(ring, torch.Generator().manual_seed(5), mesh=mesh)
draws["perm"] = perm.numpy()
draws.update({f"gather_{j}": r.numpy() for j, r in enumerate(replay.gather(ring, perm[:10], mesh))})
n_pos = replay.num_positions(ring, mesh)

net = RecurrentNet(86, 21, num_filters=8, num_blocks=2, hex=True)
learner = Learner(NetworkManager(net, (86, 5, 5)), LearnerConfig(
    optimizer="SGD", learning_rate=1.0, momentum=0.0, weight_decay=0.0), mesh=mesh)
params = {k[len("p/"):]: torch.from_numpy(data[k]) for k in data.files if k.startswith("p/")}
batch = tuple(torch.from_numpy(data[k]) for k in ("obs", "pt", "vt", "gt"))
_, _, grads = learner.value_and_grad(params, batch, None)
state = TrainState(params=params, opt_state=learner.init_opt_state(params), step=0)
new, metrics = learner.train_step(state, batch)
if RANK == 0:
    np.savez(os.path.join(OUT, "port.npz"), **draws,
             **{"p/" + k: v.numpy() for k, v in new.params.items()},
             **{"g/" + k: v.numpy() for k, v in grads.items()},
             loss=np.array([float(metrics[k]) for k in ("loss/combined", "loss/value",
                                                        "loss/policy")]))
report(placed=placed, n_pos=n_pos, digest=digest(new.params))
"""

# A one-rank mesh against no mesh, TTT + MLP, samples and epochs.
ONE_RANK_WORKER = PRELUDE + r"""
import dataclasses
from nuzero_tpu_torch.config.schemas import LearningConfig, RunningConfig, SavingConfig, TestingFrequencyConfig, TrainingConfig
from nuzero_tpu_torch.envs.tictactoe import TicTacToe
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.mlp import MLPNetwork
from nuzero_tpu_torch.search.mcts import SearchParams
from nuzero_tpu_torch.training.pipeline import AlphaZero

out = {}
for method in ("samples", "epochs"):
    cfg = TrainingConfig(
        running=RunningConfig(num_actors=8, training_steps=2, num_games_per_type_per_step=2,
                              early_fill_per_type=4),
        learning=LearningConfig(replay_window_size=16, batch_size=8, num_samples=2,
                                learning_method=method, epochs_batch_size=8, learning_epochs=1,
                                late_heavy=True),
        testing=TestingFrequencyConfig(policy_test_frequency=0, mcts_test_frequency=0),
        saving=SavingConfig(save_frequency=2, save_buffer=True))
    runs = []
    for use_mesh in (False, True):
        env = TicTacToe(device="cpu")
        torch.manual_seed(0)
        mgr = NetworkManager(MLPNetwork(env.observation_shape, env.num_actions),
                             env.observation_shape)
        run_dir = os.path.join(OUT, f"{method}_{use_mesh}")
        az = AlphaZero(env, mgr, cfg, SearchParams(num_simulations=4), run_dir=run_dir,
                       mesh=mesh if use_mesh else None)
        state = az.run(seed=3)
        records = [{k: v for k, v in r.items() if k != "ts" and not k.startswith("time/")
                    and k not in ("step_time_s", "selfplay/env_steps_per_s")}
                   for r in az.journal.load()]
        runs.append((digest(state.params), records, sorted(os.listdir(
            os.path.join(run_dir, "checkpoints")))))
    out[method] = runs
report(**out)
"""

# AlphaZero.run across 2 ranks, then a resume at 2 ranks: TTT + MLP.
TTT_WORKER = PRELUDE + r"""
from nuzero_tpu_torch.config.schemas import LearningConfig, RunningConfig, SavingConfig, TestingFrequencyConfig, TrainingConfig
from nuzero_tpu_torch.envs.tictactoe import TicTacToe
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.mlp import MLPNetwork
from nuzero_tpu_torch.search.mcts import SearchParams
from nuzero_tpu_torch.training.pipeline import AlphaZero

run_dir = os.path.join(OUT, "mp_run")

def make_az(training_steps=3):
    env = TicTacToe(device="cpu")
    torch.manual_seed(RANK)  # rank 0's initial params reach every rank
    mgr = NetworkManager(MLPNetwork(env.observation_shape, env.num_actions),
                         env.observation_shape)
    cfg = TrainingConfig(
        running=RunningConfig(num_actors=16, training_steps=training_steps,
                              num_games_per_type_per_step=2, early_fill_per_type=4),
        learning=LearningConfig(replay_window_size=64, batch_size=16, num_samples=1),
        testing=TestingFrequencyConfig(policy_test_frequency=2, mcts_test_frequency=0,
                                       num_policy_test_games=8, testing_actors=8),
        saving=SavingConfig(save_frequency=2, save_buffer=True))
    return AlphaZero(env, mgr, cfg, SearchParams(num_simulations=8), run_dir=run_dir,
                     mesh=mesh)

az = make_az()
state = az.run(seed=0)
assert state.step == 3
first = digest(state.params)
ring_games = az.buffer.num_games
az2 = make_az(training_steps=3)
state2, step = az2.load("auto")
assert step == 2, step
restored_ring = az2.buffer.num_games
state2 = az2.run(seed=1, initial_state=state2, starting_step=step)
report(first=first, resumed=digest(state2.params), ring_games=ring_games,
       restored_ring=restored_ring, capacity=az.buffer.capacity,
       files=sorted(os.listdir(os.path.join(run_dir, "checkpoints"))))
"""

# The flagship stack across 2 ranks: SCS with per-game victory points.
SCS_WORKER = PRELUDE + r"""
from nuzero_tpu_torch.config.schemas import LearningConfig, RunningConfig, SavingConfig, TestingFrequencyConfig, TrainingConfig
from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.recurrent import RecurrentNet
from nuzero_tpu_torch.search.mcts import SearchParams
from nuzero_tpu_torch.training.pipeline import AlphaZero
from nuzero_tpu_torch.utils.packing import make_packer

run_dir = os.path.join(OUT, "mp_scs")
scenario = os.path.join(%(repo)r, "configs", "scenarios", "solo_scout_5.yml")
env = SCSGame(load_scenario(scenario, seed=3), randomize_vp=True, device="cpu")
mgr = NetworkManager(RecurrentNet(env.observation_shape[0], env.action_space_shape[0],
                                  num_filters=8, num_blocks=1, hex=True),
                     env.observation_shape)
cfg = TrainingConfig(
    running=RunningConfig(num_actors=16, training_steps=2, num_games_per_type_per_step=2,
                          early_fill_per_type=4),
    learning=LearningConfig(replay_window_size=64, batch_size=16, num_samples=1),
    testing=TestingFrequencyConfig(policy_test_frequency=2, mcts_test_frequency=0,
                                   num_policy_test_games=8, testing_actors=8),
    saving=SavingConfig(save_frequency=1, save_buffer=True))
az = AlphaZero(env, mgr, cfg, SearchParams(num_simulations=6), run_dir=run_dir, mesh=mesh)
state = az.run(seed=0)
assert state.step == 2
_, unpack, dim = make_packer(env.init(1, generator=torch.Generator()))
live = az.buffer.length > 0
vps = unpack(az.buffer.states[live][:, 0, :dim]).vp.reshape(int(live.sum()), -1)
layouts = sorted({tuple(v) for v in vps.tolist()})
az2 = AlphaZero(env, mgr, cfg, SearchParams(num_simulations=6), run_dir=run_dir, mesh=mesh)
state2, step = az2.load("auto")
assert step == 2, step
report(digest=digest(state.params), restored=digest(state2.params), layouts=layouts,
       ring_games=az.buffer.num_games, restored_ring=az2.buffer.num_games,
       files=sorted(os.listdir(os.path.join(run_dir, "checkpoints"))))
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(script_text, out_dir, world=2, timeout=80):
    """``world`` ranks of ``script_text`` on a fresh port -> each rank's
    report."""
    script = out_dir / "worker.py"
    script.write_text(script_text % {"repo": REPO})
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, str(script), str(rank), coord, str(world),
                               str(out_dir)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    reports = []
    for rank in range(world):
        with open(out_dir / f"rank{rank}.json") as f:
            reports.append(json.load(f))
    return reports


def _journal(run_dir):
    with open(os.path.join(run_dir, "journal.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("size", [8, 4])
def test_batch_sharding_follows_jax(size):
    """``place_batch_sharded``'s rule on one pytree against the shardings
    JAX's ``place_batch_sharded`` gives it on a mesh of as many devices."""
    tree = {"scalar": np.float32(1.0), "empty": np.zeros((0, 3), np.float32),
            "three": np.zeros(3, np.float32), "eight": np.zeros((8, 2), np.float32),
            "six": np.zeros((6,), np.int32), "sixteen": np.zeros((16, 5, 5), np.float32),
            "twelve": np.zeros((12,), np.float32)}
    placed = jax_place_batch_sharded(tree, jax_make_mesh(cpu_devices()[:size]))
    mesh = Mesh(rank=0, size=size, device=torch.device("cpu"))
    for k, v in tree.items():
        want = tuple(placed[k].sharding.spec)
        assert want in {("dp",), ()}, (k, want)
        assert batch_sharding(torch.as_tensor(v), mesh).split == (want == ("dp",)), k


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_mesh_block_layout(rank):
    """The one layout of a sharded axis: rank r holds the r-th of N equal
    contiguous blocks (what the learner forwards, JAX's sharding of a
    batch), ``owned`` inverts it (what ``replay.gather`` reads), and an
    axis that does not divide over the ranks is refused."""
    mesh = Mesh(rank=rank, size=3, device=torch.device("cpu"))
    assert mesh.block(12) == slice(4 * rank, 4 * rank + 4)
    mine, local = mesh.owned(torch.arange(12), 4)
    assert mine.nonzero().flatten().tolist() == list(range(12))[mesh.block(12)]
    assert local[mine].tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="12 rows does not divide over the mesh size 5"):
        Mesh(rank=0, size=5, device=torch.device("cpu")).block(12)


def test_placements_sampler_and_update_match_jax_across_two_ranks(tmp_path):
    """Two ranks: the placements; the sampler (with and without
    replacement), the epoch permutation and the gather over the two rings
    equal to one ring holding both, draw for draw; the gradient of one
    global batch and one learner update (SGD, lr 1) against JAX's learner
    with the state replicated and the batch sharded over the 8 virtual CPU
    devices, each tensor within 1e-5 of its largest value."""
    from nuzero_tpu_torch.training import replay

    rng = np.random.default_rng(0)
    G, L, D, A = 8, 5, 3, 4
    length = rng.integers(0, L + 1, G).astype(np.int32)
    ring_arrays = {
        "states": rng.standard_normal((G, L, D)).astype(np.float32),
        "policy": rng.random((G, L, A)).astype(np.float32),
        "value": rng.choice([-1.0, 1.0], (G, L)).astype(np.float32),
        "length": length, "game_type": np.zeros(G, np.int32),
        "seq": np.where(length > 0, np.arange(G), -1).astype(np.int32),
    }
    jmgr = JaxManager(JaxRecurrentNet(policy_channels=21, num_filters=8, num_blocks=2,
                                      hex=True), OBS)
    jvars = jax.jit(jmgr.init)(jax.random.key(3))
    batch = 16
    obs = (rng.random((batch,) + OBS) < 0.2).astype(np.float32)
    pt = rng.random((batch, ACTIONS)).astype(np.float32)
    pt /= pt.sum(-1, keepdims=True)
    vt = rng.choice([-1.0, 0.0, 1.0], batch).astype(np.float32)
    gt = np.zeros(batch, np.int32)
    params = recurrent_net_state_dict(jax.tree.map(np.asarray, jvars))
    np.savez(tmp_path / "inputs.npz", **ring_arrays, games_added=np.array([4, 4]),
             obs=obs, pt=pt, vt=vt, gt=gt, **{"p/" + k: v for k, v in params.items()})

    jl = JaxLearner(jmgr, JaxLearnerConfig(optimizer="SGD", learning_rate=1.0, momentum=0.0,
                                           weight_decay=0.0))
    mesh = jax_make_mesh(cpu_devices())
    jstate = jax_place_replicated(
        JaxTrainState(params=jvars, opt_state=jl.tx.init(jvars), step=jnp.int32(0)), mesh)
    jbatch = jax_place_batch_sharded(tuple(map(jnp.asarray, (obs, pt, vt, gt))), mesh)
    jnew, jmetrics = jax.jit(jl.train_step)(jstate, jbatch, jax.random.key(0))
    assert jbatch[0].sharding.spec == ("dp",)

    reports = _run_ranks(UNIT_WORKER, tmp_path)
    for rank, rep in enumerate(reports):
        placed = rep["placed"]
        assert placed["sharded_a"] == [4.0 * rank + i + 100 * rank for i in range(4)]
        assert placed["sharded_b"] == [float(i) for i in range(5)]  # 5 rows: replicated
        assert placed["sharded_c"] == 3.0 and placed["replicated_a"] == list(range(8))
        assert placed["sharded_d"] == [[float(rank)] * 2] * 2  # the caller's block
        assert rep["n_pos"] == int(length.sum())
    assert reports[0]["digest"] == reports[1]["digest"]

    got = np.load(tmp_path / "port.npz")
    full = replay.ReplayBuffer(**{k: torch.from_numpy(v) for k, v in ring_arrays.items()},
                               ptr=0, games_added=8)
    for i, wr in enumerate((True, False)):
        rows = replay.sample(full, torch.Generator().manual_seed(i), 12, with_replacement=wr)
        for j, r in enumerate(rows):
            np.testing.assert_array_equal(got[f"sample{i}_{j}"], r.numpy())
    perm = replay.epoch_permutation(full, torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(got["perm"], perm.numpy())
    for j, r in enumerate(replay.gather(full, perm[:10])):
        np.testing.assert_array_equal(got[f"gather_{j}"], r.numpy())

    jgrads = jax.jit(jax.grad(lambda p, b, r: jl._forward_loss(p, *b[:3], r)[0]))(
        jstate.params, jbatch, jax.random.key(0))
    for name, tree in (("g/", jgrads), ("p/", jnew.params)):
        for k, v in recurrent_net_state_dict(jax.tree.map(np.asarray, tree)).items():
            scale = max(float(np.abs(v).max()), 1e-30)
            err = float(np.abs(got[name + k] - v).max())
            assert err <= 1e-5 * scale, (name + k, err, scale)
    jloss = [float(jmetrics[k]) for k in ("loss/combined", "loss/value", "loss/policy")]
    np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)


def test_mesh_errors_match_jax():
    """JAX's divisibility errors and its refusal of the asynchronous mode
    across processes, with its messages (``local_shard``'s error is held
    across two ranks above), and the port's refusal of a per-type batch
    that does not divide over the ranks."""
    mesh = Mesh(rank=0, size=4, device=torch.device("cpu"))
    env = TicTacToe(device="cpu")
    mgr = NetworkManager(MLPNetwork(env.observation_shape, env.num_actions),
                         env.observation_shape)
    sp = SearchParams(num_simulations=4)
    with pytest.raises(ValueError, match="num_actors=6 must divide the mesh size 4"):
        AlphaZero(env, mgr, TrainingConfig(running=RunningConfig(num_actors=6)), sp, mesh=mesh)
    cfg = TrainingConfig(running=RunningConfig(num_actors=8))
    cfg = cfg.__class__(**{**cfg.__dict__, "learning": cfg.learning.__class__(
        **{**cfg.learning.__dict__, "replay_window_size": 6})})
    with pytest.raises(ValueError, match="replay_window_size=6 must divide the mesh size 4"):
        AlphaZero(env, mgr, cfg, sp, mesh=mesh)
    async_cfg = TrainingConfig(running=RunningConfig(num_actors=8,
                                                     running_mode="asynchronous"))
    with pytest.raises(ValueError, match="'asynchronous' is single-process only"):
        AlphaZero(env, mgr, async_cfg, sp, mesh=mesh)
    # The port's own: each rank forwards an equal block of every batch.
    odd = cfg.__class__(**{**cfg.__dict__, "learning": cfg.learning.__class__(
        **{**cfg.learning.__dict__, "replay_window_size": 8, "batch_size": 18})})
    with pytest.raises(ValueError, match=r"batch size 18 over 2 game type\(s\) gives "
                                         r"batches of \[9, 9\]; each must divide the mesh "
                                         r"size 4"):
        AlphaZero([env, env], mgr, odd, sp, mesh=mesh)
    one = Mesh(rank=0, size=1, device=torch.device("cpu"))
    assert AlphaZero(env, mgr, async_cfg, sp, mesh=one).mesh is one
    assert not distributed.is_multi_host() and distributed.local_shard(6) == 6


def test_one_rank_mesh_is_bit_equal_to_no_mesh(tmp_path):
    """A one-rank gloo group: the same params, journal and checkpoint files
    as a run without a mesh, by the samples and the epochs method."""
    (report,) = _run_ranks(ONE_RANK_WORKER, tmp_path, world=1)
    for method in ("samples", "epochs"):
        (d0, j0, f0), (d1, j1, f1) = report[method]
        assert d0 == d1 and j0 == j1 and f0 == f1, method
        assert [r["step"] for r in j0] == [1, 2]


def test_two_process_integrated_training(tmp_path):
    """Mirror of ``tests/test_distributed.py``: TTT + MLP across 2 ranks,
    early fill, global sampling, the update all-reduced, rank 0's journal
    and in-loop tests, the checkpoint written once, and a resume at 2
    ranks from it."""
    reports = _run_ranks(TTT_WORKER, tmp_path)
    assert reports[0]["first"] == reports[1]["first"]
    assert reports[0]["resumed"] == reports[1]["resumed"]
    for rep in reports:
        assert rep["capacity"] == 32 and 0 < rep["ring_games"] <= 32
        assert rep["restored_ring"] > 0
        assert rep["files"] == ["FORMAT", "step_00000002.pt", "step_00000002.ring0-of-2.pt",
                                "step_00000002.ring1-of-2.pt"]
    records = _journal(tmp_path / "mp_run")
    # 1..3 with the resumed run's step 3 in place of the first run's.
    assert [r["step"] for r in records if "loss/combined" in r] == [1, 2, 3]
    assert all(math.isfinite(r["loss/combined"]) for r in records if "loss/combined" in r)
    assert any("wr/policy_as_p0" in r for r in records)
    for r in records:
        assert r["buffer_seq"] == sum(r["buffer_seq_per_rank"])


def test_two_process_scs_training(tmp_path):
    """Mirror of ``tests/test_mesh_scs.py``: the flagship stack (SCS, hex
    RecurrentNet) across 2 ranks with per-game victory points; each rank's
    games draw their own layouts."""
    reports = _run_ranks(SCS_WORKER, tmp_path, timeout=85)
    assert reports[0]["digest"] == reports[1]["digest"]
    assert reports[0]["restored"] == reports[0]["digest"] == reports[1]["restored"]
    layouts = [{tuple(v) for v in rep["layouts"]} for rep in reports]
    assert len(layouts[0] | layouts[1]) > 1 and layouts[0] != layouts[1]
    for rep in reports:
        assert rep["restored_ring"] == rep["ring_games"] > 0
        assert rep["files"] == ["FORMAT", *[f"step_0000000{s}{suffix}" for s in (1, 2)
                                            for suffix in (".pt", ".ring0-of-2.pt",
                                                           ".ring1-of-2.pt")]]
    assert [r["step"] for r in _journal(tmp_path / "mp_scs") if "loss/combined" in r] == [1, 2]
