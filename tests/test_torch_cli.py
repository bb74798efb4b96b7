"""The port's command line, ``python -m nuzero_tpu_torch`` (``nuzero_tpu_torch/run.py``),
against the repository's ``run.py`` on the CPU.

The two subprocess cases of ``tests/test_cli_subprocess.py`` with ``--device
cpu``; the rest in-process: ``--debug 0`` and ``--debug 1`` print what
``run.py`` prints, string for string (both draw legal moves from
``np.random.default_rng(0)``); ``print_tree`` on the same search (the JAX
MLP's weights converted, no root noise) equals JAX's dump; a preset-0 run
cut to one step writes the same files and ``run_meta.yaml`` keys as
``run.py``, and testing preset 0 reads it back; the refusals (no card, an
Orbax run); two processes launched as torchrun and as SLURM launch them,
which join one process group and train data-parallel.
Every comparison here is exact.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import run as jax_runner
from nuzero_tpu_torch import run as runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def _cli(args, stdin=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "nuzero_tpu_torch", *args], cwd=REPO,
                          input=stdin, capture_output=True, text=True, timeout=timeout, env=env)


def test_debug_preset_0_subprocess():
    r = _cli(["--device", "cpu", "--debug", "0"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "terminal value:" in r.stdout


def test_interactive_quit_subprocess():
    # Option 5 = Quit in the wizard's main menu.
    r = _cli(["--device", "cpu", "--interactive"], stdin="5\n")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "What would you like to do?" in r.stdout


def _run_py_debug_1() -> str:
    """What ``run.py --debug 1`` prints: its loop and its prints, with the
    JAX engine's ``step`` and ``legal_mask`` jitted (the same results; run
    eagerly, as ``run.py`` does, the 66 moves take ~90 s on the CPU)."""
    from nuzero_tpu.utils.render import render_scs_ascii

    env = jax_runner._scs_env("open_field_5.yml")
    step, legal_mask = jax.jit(env.step), jax.jit(env.legal_mask)
    s = env.init(None)
    rng = np.random.default_rng(0)
    moves = 0
    while not bool(env.terminal(s)) and moves < 1000:
        legal = np.flatnonzero(np.asarray(legal_mask(s)))
        s = step(s, jnp.int32(int(rng.choice(legal))))
        moves += 1
    return (f"{render_scs_ascii(env, s)}\n"
            f"moves: {moves} terminal value: {float(s.terminal_value)}\n")


@pytest.mark.parametrize("idx", [0, 1])
def test_debug_preset_prints_what_run_py_prints(idx, capsys):
    if idx == 0:
        jax_runner.debug_preset(0)
        want = capsys.readouterr().out
    else:
        want = _run_py_debug_1()
    runner.debug_preset(idx, device="cpu")
    got = capsys.readouterr().out
    assert "terminal value:" in want
    assert got == want


def test_print_tree_equals_jax_dump(capsys):
    """``--debug 2``'s search (64 simulations, carried-tree capacity, eval
    mode) on the TTT opening with the same MLP weights: the dump, the chosen
    action and the root value equal JAX's."""
    from nuzero_tpu.search import SearchParams as JaxSearchParams
    from nuzero_tpu.search.mcts import make_search_fn as jax_make_search_fn
    from nuzero_tpu.search.tree import print_tree as jax_print_tree
    from nuzero_tpu_torch.networks.convert import mlp_state_dict
    from nuzero_tpu_torch.search.mcts import SearchParams, make_search_fn
    from nuzero_tpu_torch.search.tree import print_tree

    jenv = jax_runner._ttt_env()
    jmgr = jax_runner._managers(jenv, "mlp", hex=False)
    jvars = jmgr.init(jax.random.key(0))

    def jnet(v, obs):
        p, val, _ = jmgr.apply(v, obs)
        return p, val

    jsearch = jax.jit(jax_make_search_fn(jenv, jnet, JaxSearchParams(num_simulations=64,
                                                                     keep_subtree=True),
                                         training=False, with_tree=True))
    states = jax.tree.map(lambda x: jnp.stack([x]), jenv.init(jax.random.key(1)))
    jres, jtree = jsearch(jvars, states, jnp.zeros(1, jnp.int32), jax.random.key(2), None, None)
    want = jax_print_tree(jtree, game_idx=0)

    env = runner._ttt_env("cpu")
    mgr = runner._managers(env, "mlp", hex=False)
    variables = {k: torch.from_numpy(np.array(v)) for k, v in mlp_state_dict(jvars).items()}
    search = make_search_fn(env, lambda v, obs: mgr.apply(v, obs)[:2],
                            SearchParams(num_simulations=64, keep_subtree=True),
                            training=False, with_tree=True)
    with torch.no_grad():
        res, tree = search(variables, env.init(1), torch.zeros(1, dtype=torch.int32),
                           torch.Generator().manual_seed(2), None, None)
    got = print_tree(tree, game_idx=0)
    capsys.readouterr()
    assert got.count("\n") > 10 and got == want
    assert int(res.action[0]) == int(jres.action[0])
    assert f"{float(res.root_value[0]):+.3f}" == f"{float(jres.root_value[0]):+.3f}"


def test_debug_preset_2_names_the_chosen_action(capsys):
    res, _ = runner.debug_preset(2, device="cpu")
    out = capsys.readouterr().out
    assert out.startswith("tree: ")
    assert f"chosen action: {int(res.action[0])}, root value" in out


def _cut_configs(tmp_path):
    """``ttt_default.yaml`` and ``ttt_search.yaml`` cut to one step of 8
    actors and 4 simulations, with a checkpoint and no in-loop tests."""
    from nuzero_tpu_torch.config.yaml_io import load_yaml, save_yaml

    train = load_yaml(os.path.join(REPO, "configs", "training", "ttt_default.yaml"))
    train["Running"].update(num_actors=8, early_fill_per_type=8, training_steps=1,
                            Sequential={"num_games_per_type_per_step": 2})
    train["Saving"].update(save_frequency=1)
    train["Testing"].update(early_testing=False, policy_test_frequency=0,
                            mcts_test_frequency=0)
    train["Learning"]["Samples"].update(batch_size=16, num_samples=1)
    search = load_yaml(os.path.join(REPO, "configs", "search", "ttt_search.yaml"))
    search["Simulation"]["mcts_simulations"] = 4
    paths = str(tmp_path / "train.yaml"), str(tmp_path / "search.yaml")
    save_yaml(train, paths[0])
    save_yaml(search, paths[1])
    return paths


def _files(run_dir):
    """Top-level names, and the checkpoints' step names without extension."""
    names = sorted(os.listdir(run_dir))
    steps = sorted(n.split(".")[0] for n in os.listdir(os.path.join(run_dir, "checkpoints"))
                   if n.startswith("step_"))
    return names, steps


def test_training_preset_0_writes_what_run_py_writes(tmp_path, capsys):
    """Preset 0 cut to one step, the configs and the run directory passed
    as absolute paths: the same files (configs' copies, ``run_meta.yaml``,
    journal, plots, checkpoint step) and the same ``run_meta.yaml``."""
    from nuzero_tpu_torch.config.yaml_io import load_yaml

    train, search = _cut_configs(tmp_path)
    jax_dir, port_dir = str(tmp_path / "jax_run"), str(tmp_path / "port_run")
    jax_runner.training_preset(0, jax_dir, train_cfg=train, search_cfg=search)
    runner.training_preset(0, port_dir, train_cfg=train, search_cfg=search, device="cpu")
    out = capsys.readouterr().out
    assert f"run complete; artifacts in {port_dir}" in out
    assert _files(port_dir) == _files(jax_dir)
    assert _files(port_dir)[1] == ["step_00000001"]
    assert load_yaml(os.path.join(port_dir, "run_meta.yaml")) == load_yaml(
        os.path.join(jax_dir, "run_meta.yaml"))
    for name in ("train_config_copy.yaml", "search_config_copy.yaml"):
        with open(os.path.join(port_dir, name)) as a, open(os.path.join(jax_dir, name)) as b:
            assert a.read() == b.read()
    # Testing preset 0 reads that run back: its policy and MCTS agents
    # against random from both seats, all games played to the end.
    stats = runner.testing_preset(0, port_dir, device="cpu")
    assert [s.num_games for s in stats] == [256, 256, 128, 128]
    assert all(s.p0_wins + s.p1_wins + s.draws == s.num_games for s in stats)


def test_refuses_an_orbax_run(tmp_path, monkeypatch):
    """A run name that points at a JAX (Orbax, FORMAT 2) checkpoint without
    an export is refused with the exporter's command; a committed run
    resolves to its export; the port's own run to itself."""
    monkeypatch.setattr(runner, "RUNS", str(tmp_path))
    (tmp_path / "orbax_run" / "checkpoints").mkdir(parents=True)
    (tmp_path / "orbax_run" / "checkpoints" / "FORMAT").write_text("2\n")
    with pytest.raises(SystemExit, match="Orbax.*tests/test_torch_transfer.py --export"):
        runner.main(["--device", "cpu", "--testing-preset", "2", "--name", "orbax_run"])
    (tmp_path / "scs_solo_r3" / "checkpoints").mkdir(parents=True)
    (tmp_path / "scs_solo_r3" / "checkpoints" / "FORMAT").write_text("2\n")
    assert runner.resolve_run("scs_solo_r3") == os.path.join(runner.ASSET_RUNS, "scs_solo_r3")
    (tmp_path / "mine" / "checkpoints").mkdir(parents=True)
    (tmp_path / "mine" / "checkpoints" / "FORMAT").write_text("1\n")
    assert runner.resolve_run("mine") == str(tmp_path / "mine")


# Runs ``run.main(ARGS)`` as ``python -m nuzero_tpu_torch ARGS`` does, and
# records which files the process copied or wrote as the run's (configs,
# run_meta, journal records, checkpoints), into the file named first.
LAUNCH_DRIVER = """import json, shutil, sys
import torch
torch.set_num_threads(1)
from nuzero_tpu_torch import run
from nuzero_tpu_torch.config import run_meta
from nuzero_tpu_torch.utils import checkpoint, metrics
writes = []

def recorded(name, fn):
    def wrapper(*args, **kwargs):
        writes.append(name)
        return fn(*args, **kwargs)
    return wrapper

shutil.copy = recorded("config copy", shutil.copy)
run_meta.save_run_meta = recorded("run_meta", run_meta.save_run_meta)
checkpoint._write = recorded("checkpoint file", checkpoint._write)
append = metrics.MetricsJournal.append
metrics.MetricsJournal.append = lambda self, record: (
    writes.append("journal") if self.write else None) or append(self, record)
run.main(sys.argv[2:])
with open(sys.argv[1], "w") as f:
    json.dump(writes, f)
"""


# The variables of the launchers the CLI reads.
LAUNCH_KEYS = {"MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_PROCID",
               "SLURM_NTASKS", "SLURM_LOCALID", "JAX_COORDINATOR"}


def _launch_configs(tmp_path):
    """``ttt_default.yaml`` and ``ttt_search.yaml`` cut to two steps of 8
    actors, 4 simulations, no in-loop tests, a checkpoint at step 2."""
    from nuzero_tpu_torch.config.yaml_io import load_yaml, save_yaml

    train = load_yaml(os.path.join(REPO, "configs", "training", "ttt_default.yaml"))
    train["Running"].update(num_actors=8, early_fill_per_type=4, training_steps=2)
    train["Running"]["Sequential"]["num_games_per_type_per_step"] = 2
    train["Saving"]["save_frequency"] = 2
    train["Testing"].update(early_testing=False, policy_test_frequency=0,
                            mcts_test_frequency=0, asynchronous_testing=False)
    train["Plotting"]["plot_loss"] = False
    train["Learning"]["replay_window_size"] = 16
    train["Learning"]["Samples"].update(batch_size=8, num_samples=1)
    search = load_yaml(os.path.join(REPO, "configs", "search", "ttt_search.yaml"))
    search["Simulation"]["mcts_simulations"] = 4
    paths = str(tmp_path / "train.yaml"), str(tmp_path / "search.yaml")
    save_yaml(train, paths[0])
    save_yaml(search, paths[1])
    return paths


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("launcher", ["torchrun", "slurm"])
def test_joins_a_multi_process_launch(launcher, tmp_path):
    """Two CLI processes with the environment torchrun (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK) or a SLURM job of two tasks
    (SLURM_PROCID, SLURM_NTASKS, SLURM_LOCALID, JAX_COORDINATOR) gives them
    join one gloo group and train TTT preset 0 data-parallel: rank 0 alone
    copies the configs and writes run_meta, the journal and the checkpoint's
    main file; each rank writes its own replay ring."""
    train, search = _launch_configs(tmp_path)
    run_dir = str(tmp_path / "run")
    port = _free_port()
    procs = []
    for rank in range(2):
        if launcher == "torchrun":
            env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
                   "WORLD_SIZE": "2", "LOCAL_RANK": str(rank)}
        else:
            env = {"SLURM_PROCID": str(rank), "SLURM_NTASKS": "2", "SLURM_LOCALID": str(rank),
                   "JAX_COORDINATOR": f"127.0.0.1:{port}"}
        inherited = {k: v for k, v in os.environ.items() if k not in LAUNCH_KEYS}
        env = dict(inherited, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", **env)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", LAUNCH_DRIVER, str(tmp_path / f"rank{rank}.json"),
             "--device", "cpu", "--training-preset", "0", "--train-config", train,
             "--search-config", search, "--name", run_dir],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-3000:]}"
        assert f"torch.distributed: rank {rank} of 2 (gloo) on cpu" in out
    writes = []
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            writes.append(json.load(f))
    assert sorted(writes[0]) == sorted(["config copy"] * 2 + ["run_meta"] + ["journal"] * 2
                                       + ["checkpoint file"] * 2)
    assert writes[1] == ["checkpoint file"]
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == [
        "FORMAT", "step_00000002.pt", "step_00000002.ring0-of-2.pt",
        "step_00000002.ring1-of-2.pt"]
    with open(os.path.join(run_dir, "journal.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]
    assert "training on a 2-rank data-parallel mesh" in outs[0]


def test_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device.*--device cpu"):
        runner.main(["--debug", "0"])


def test_play_with_a_cache_reaches_the_end(capsys):
    """``--play mcts --cache keyless``: canned moves 0..8 (occupied cells are
    refused and the next one read) play a whole game; the hit ratio is
    printed."""
    moves = iter(str(i) for i in range(9))
    value = runner.play("mcts", "keyless", device="cpu", input_fn=lambda prompt: next(moves))
    out = capsys.readouterr().out
    assert value in (-1.0, 0.0, 1.0) and "game over" in out
    assert "keyless cache: hit ratio 0.000 (0 hits," in out


def test_slurm_launch_renders_one_task_per_card():
    """The port's SLURM launcher (``--dry-run``): one task per card, each
    running ``python -m nuzero_tpu_torch`` with the given arguments, and
    the rendezvous the tasks read."""
    r = subprocess.run([sys.executable, os.path.join(REPO, "nuzero_tpu_torch", "slurm",
                                                     "launch.py"),
                        "--dry-run", "--job-name", "j", "--num-nodes", "2",
                        "--gpus-per-node", "4", "--args", "--training-preset 2 --filters 256"],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().split("\n")
    for want in ("#SBATCH --nodes=2", "#SBATCH --ntasks-per-node=4",
                 "#SBATCH --gpus-per-node=4", "#SBATCH --job-name=j"):
        assert want in lines
    assert 'export JAX_COORDINATOR="${head_node}:8476"' in lines
    assert lines[-1] == ("srun --kill-on-bad-exit=1 python -m nuzero_tpu_torch "
                         "--training-preset 2 --filters 256")
    assert "${" not in r.stdout.replace("${head_node}", "")
