"""The port's command line (counterpart of the repository's ``run.py``; ref
``Run.py``).  Every mode of ``run.py``, on the card by default:

    python -m nuzero_tpu_torch --training-preset N [--name NAME] [--train-config F]
        [--search-config F] [--filters N] [--net-dtype float32|bfloat16]
    python -m nuzero_tpu_torch --testing-preset N [--name NAME] [--view]
    python -m nuzero_tpu_torch --debug N
    python -m nuzero_tpu_torch --play random|mcts [--cache dict|keyless|disabled]
    python -m nuzero_tpu_torch --analyse RUN
    python -m nuzero_tpu_torch --interactive

``--device`` (default ``cuda``) chooses where everything runs; it stands in
for the JAX package's backend choice (``JAX_PLATFORMS``).  Without a card
the CLI stops with a message unless ``--device cpu`` is given.

Several processes, one per card: under ``torchrun --nproc-per-node N -m
nuzero_tpu_torch ...``, a SLURM job of more than one task (``slurm/launch.py
--command "python -m nuzero_tpu_torch ..."``, or the port's own
``nuzero_tpu_torch/slurm/launch.py``, one task per card) or with
``JAX_COORDINATOR`` set, every process joins the process group
(``parallel/distributed.py``) on its rank's device, ``cuda:LOCAL_RANK %
device_count``, and training runs data-parallel over them
(``training/pipeline.py``), as ``run.py`` trains on a mesh of every device.
``--dist-backend`` is NCCL by default on the card and gloo on the CPU;
ranks that share one card must pass ``--dist-backend gloo`` (NCCL refuses
two ranks on one device).  Rank 0 alone copies the configs and writes
``run_meta.yaml``, the journal and the checkpoint.

Training presets (ref ``Run.py:92-190``): 0 Tic-Tac-Toe + MLP; 1
Tic-Tac-Toe + RecurrentNet; 2 SCS 5x5 open field + hex RecurrentNet; 3 SCS
solo scout with per-game victory points + hex RecurrentNet.  Testing
presets (ref ``Run.py:201-233``): 0 a trained TTT net's policy and MCTS
agents against random; 1 goal-rush against random on SCS; 2 the recurrent
iteration sweep and 3 the board-size sweep (``evaluation/sweeps.py``).
Debug presets (ref ``Run.py:328-345``): 0 a random TTT playout; 1 a random
SCS playout, rendered; 2 an MCTS tree dump on the TTT opening.

Paths resolve as ``run.py`` resolves them: a config name joins
``configs/training`` or ``configs/search`` and a run name joins ``runs/``,
so an absolute path stays as it is.  A run is read from the port's own
checkpoints under ``runs/``; a committed run of the JAX package (an Orbax
checkpoint, ``FORMAT`` 2) from its export under
``nuzero_tpu_torch/assets/runs/``, and refused where it has none.  The
sweeps of a run read from its export write their results into
``runs/<name>/plots_torch/``, never over the JAX run's own plots.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = os.path.join(REPO, "runs")
ASSET_RUNS = os.path.join(REPO, "nuzero_tpu_torch", "assets", "runs")
EXPORTER = "JAX_PLATFORMS=cpu python tests/test_torch_transfer.py --export"

def _ttt_env(device="cuda"):
    from nuzero_tpu_torch.envs.tictactoe import TicTacToe

    return TicTacToe(device=device)


def _scs_env(scenario_file: str, seed: int = 42, randomize_vp: bool = False, device="cuda"):
    from nuzero_tpu_torch.envs.scs.game import SCSGame
    from nuzero_tpu_torch.envs.scs.scenario import load_scenario

    scenario = load_scenario(os.path.join(REPO, "configs", "scenarios", scenario_file),
                             seed=seed)
    return SCSGame(scenario, randomize_vp=randomize_vp, device=device)


def _managers(env, arch: str, hex: bool = True, filters: int = None, net_dtype: str = None):
    """The network of ``arch`` for ``env``, on the env's device: ``filters``
    (--filters, default 64; the reference's flagship presets run 256-filter
    trunks, ref Run.py:148) and ``net_dtype`` (--net-dtype, default f32;
    bfloat16 runs the trunk on the tensor cores with f32 master params)."""
    from nuzero_tpu_torch.networks.convnet import ConvNet
    from nuzero_tpu_torch.networks.manager import NetworkManager
    from nuzero_tpu_torch.networks.mlp import MLPNetwork
    from nuzero_tpu_torch.networks.recurrent import RecurrentNet
    from nuzero_tpu_torch.networks.resnet import ResNet

    filters = filters or 64
    dtype = getattr(torch, net_dtype or "float32")
    channels, planes = env.observation_shape[0], env.action_space_shape[0]
    if arch == "mlp":
        net = MLPNetwork(env.observation_shape, env.num_actions)
    elif arch == "conv":
        net = ConvNet(channels, planes, num_filters=filters, num_layers=2, hex=hex, dtype=dtype)
    elif arch == "recurrent":
        net = RecurrentNet(channels, planes, num_filters=filters, num_blocks=2, hex=hex,
                           dtype=dtype)
    elif arch == "resnet":
        net = ResNet(channels, planes, num_filters=filters, num_blocks=4, hex=hex, dtype=dtype)
    else:
        raise SystemExit(f"unknown architecture {arch!r}")
    return NetworkManager(net.to(env.device), env.observation_shape)


def join_processes(device: torch.device, backend=None) -> torch.device:
    """Join a multi-process launch (torchrun, SLURM, ``JAX_COORDINATOR``;
    ``parallel.distributed.launched_multi_process``) -> this rank's device;
    a single process keeps ``device``.  ``backend`` defaults to NCCL on the
    card and gloo on the CPU (``run.py``'s ``_maybe_init_distributed``)."""
    from nuzero_tpu_torch.parallel.distributed import (
        initialize_distributed, launched_multi_process, local_device,
    )

    if not launched_multi_process():
        return device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    initialize_distributed(backend=backend)
    dev = local_device(device.type)
    print(f"torch.distributed: rank {torch.distributed.get_rank()} of "
          f"{torch.distributed.get_world_size()} ({backend}) on {dev}")
    return dev


def check_device(device: str) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card stops the
    CLI instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("nuzero_tpu_torch: no CUDA device is available; pass --device cpu "
                         "to run on the CPU")
    return dev


def _orbax(run_dir: str) -> bool:
    """True where ``run_dir``'s checkpoints are the JAX package's (Orbax,
    tree-layout FORMAT 2)."""
    fmt = os.path.join(run_dir, "checkpoints", "FORMAT")
    if not os.path.exists(fmt):
        return False
    with open(fmt) as f:
        return f.read().strip() == "2"


def resolve_run(name: str) -> str:
    """The directory a run name reads from: ``runs/<name>`` where it holds
    the port's checkpoints, else the committed run's export under
    ``assets/runs``; an Orbax run without an export is refused."""
    run_dir = os.path.join(RUNS, name)
    asset = os.path.join(ASSET_RUNS, name)
    own = os.path.isdir(os.path.join(run_dir, "checkpoints")) and not _orbax(run_dir)
    if not own and os.path.isdir(asset):
        return asset
    if _orbax(run_dir):
        raise SystemExit(
            f"nuzero_tpu_torch: {run_dir} holds an Orbax checkpoint of the JAX package "
            f"(FORMAT 2), which the port does not read; export it into {asset} with "
            f"`{EXPORTER}`")
    return run_dir


def _results_dir(name: str, run_dir: str) -> str:
    """Where a testing preset writes its results: the run's ``plots/``, or
    ``runs/<name>/plots_torch/`` for a run read from its export."""
    if os.path.dirname(run_dir) == ASSET_RUNS:
        return os.path.join(RUNS, name, "plots_torch")
    return os.path.join(run_dir, "plots")


def _train(env, manager, train_cfg_file, search_cfg_file, name=None, state_set=None,
           meta=None):
    from nuzero_tpu_torch.config.run_meta import save_run_meta
    from nuzero_tpu_torch.config.schemas import load_search_config, load_training_config
    from nuzero_tpu_torch.parallel.mesh import default_mesh
    from nuzero_tpu_torch.training.pipeline import AlphaZero

    train_path = os.path.join(REPO, "configs", "training", train_cfg_file)
    search_path = os.path.join(REPO, "configs", "search", search_cfg_file)
    cfg = load_training_config(train_path)
    search = load_search_config(search_path)
    # Several processes: data-parallel over them (run.py's dp mesh).
    mesh = default_mesh(env.device)
    run_dir = os.path.join(RUNS, name or cfg.network_name)
    os.makedirs(run_dir, exist_ok=True)
    if mesh is None or mesh.rank == 0:
        if mesh is not None:
            print(f"training on a {mesh.size}-rank data-parallel mesh")
        # Back up the configs beside the checkpoints (ref AlphaZero.py:184-187).
        shutil.copy(train_path, os.path.join(run_dir, "train_config_copy.yaml"))
        shutil.copy(search_path, os.path.join(run_dir, "search_config_copy.yaml"))
        if meta:
            # Enough to rebuild the env and the network (resume, testing, wizard).
            save_run_meta(run_dir, **meta)
    az = AlphaZero(env, manager, cfg, search, run_dir=run_dir, state_set=state_set,
                   mesh=mesh)
    if cfg.load_checkpoint:
        state, step = az.load(cfg.checkpoint.iteration_number)
        print(f"resuming from step {step} ({state.step} updates)")
        az.run(initial_state=state, starting_step=step)
    else:
        az.run()
    print(f"run complete; artifacts in {run_dir}")
    return run_dir


def training_preset(idx: int, name, train_cfg=None, search_cfg=None, device="cuda",
                    filters=None, net_dtype=None):
    """``train_cfg`` / ``search_cfg`` replace the preset's config files
    (--train-config / --search-config); ``filters`` and ``net_dtype`` size
    the conv and recurrent nets (--filters / --net-dtype)."""
    net = dict(filters=filters, net_dtype=net_dtype)
    if idx == 0:
        env = _ttt_env(device)
        return _train(env, _managers(env, "mlp"), train_cfg or "ttt_default.yaml",
                      search_cfg or "ttt_search.yaml", name,
                      meta=dict(game="ttt", arch="mlp", hex=False))
    if idx == 1:
        env = _ttt_env(device)
        return _train(env, _managers(env, "recurrent", hex=False, **net),
                      train_cfg or "ttt_default.yaml", search_cfg or "ttt_search.yaml",
                      name or "ttt_recurrent",
                      meta=dict(game="ttt", arch="recurrent", hex=False,
                                num_filters=filters or 64))
    if idx == 2:
        from nuzero_tpu_torch.evaluation import mirrored_state_set

        env = _scs_env("open_field_5.yml", device=device)
        # The value probes of the working reference preset (ref Run.py:144).
        return _train(env, _managers(env, "recurrent", **net), train_cfg or "scs_small.yaml",
                      search_cfg or "scs_search.yaml", name, state_set=mirrored_state_set(env),
                      meta=dict(game="scs", arch="recurrent", scenario="open_field_5.yml",
                                num_filters=filters or 64))
    if idx == 3:
        from nuzero_tpu_torch.evaluation import solo_state_set

        # Per-game victory points: the reference's training distribution
        # (each self-play game reloads the randomized scenario).
        env = _scs_env("solo_scout_5.yml", randomize_vp=True, device=device)
        return _train(env, _managers(env, "recurrent", **net), train_cfg or "scs_small.yaml",
                      search_cfg or "scs_search.yaml", name or "scs_solo_net",
                      state_set=solo_state_set(env),
                      meta=dict(game="scs", arch="recurrent", scenario="solo_scout_5.yml",
                                randomize_vp=True, num_filters=filters or 64))
    raise SystemExit(f"unknown training preset {idx}")


def testing_preset(idx: int, name, device="cuda"):
    from nuzero_tpu_torch.evaluation import (
        GoalRushAgent, MctsAgent, PolicyAgent, RandomAgent, TestManager,
    )
    from nuzero_tpu_torch.evaluation import sweeps
    from nuzero_tpu_torch.search.mcts import SearchParams
    from nuzero_tpu_torch.utils.checkpoint import restore_checkpoint

    if idx == 0:
        env = _ttt_env(device)
        manager = _managers(env, "mlp")
        run_dir = resolve_run(name or "ttt_net")
        tree, step = restore_checkpoint(os.path.join(run_dir, "checkpoints"), "auto",
                                        device=device)
        params = tree["params"]
        tm = TestManager(env)
        print(f"evaluating checkpoint step {step} from {run_dir}")
        policy = PolicyAgent(manager, params)
        results = [tm.run_test_batch(256, policy, RandomAgent()),
                   tm.run_test_batch(256, RandomAgent(), policy)]
        agent = MctsAgent(manager, params, SearchParams(num_simulations=100))
        results += [tm.run_test_batch(128, agent, RandomAgent()),
                    tm.run_test_batch(128, RandomAgent(), agent)]
        return results
    if idx == 1:
        env = _scs_env("solo_scout_5.yml", device=device)
        tm = TestManager(env)
        return [tm.run_test_batch(64, RandomAgent(), GoalRushAgent()),
                tm.run_test_batch(64, RandomAgent(), RandomAgent())]
    if idx in (2, 3):
        # The trained net plays player 1 (the reference's "p2"); on the solo
        # scout map only p2 owns a unit, so a point's win rate is the scout's
        # goal-reaching rate (sweeps.py).
        run_name = name or ("scs_solo_net" if idx == 2 else "scs_solo_rvp_r4")
        run_dir = resolve_run(run_name)
        out_dir = _results_dir(run_name, run_dir)
        game_dir, base = os.path.dirname(run_dir), os.path.basename(run_dir)
        if idx == 2:
            record = sweeps.iteration_sweep(base, game_dir, out_dir, device=device)
            print([(r["iterations"], (r["p0_wr"], r["p1_wr"], r["draw_rate"]))
                   for r in record["results"]])
            print(f"sweep written to {os.path.join(out_dir, 'iteration_sweep.json')}")
        else:
            record = sweeps.size_sweep(base, game_dir, out_dir, device=device)
            print(f"size sweep written to {os.path.join(out_dir, 'size_sweep.json')}")
        return record
    raise SystemExit(f"unknown testing preset {idx}")


def analyse_run(name: str, max_moves: int = 400, auto: bool = False, fps: int = 30,
                device="cuda"):
    """--analyse: play one game with the run's latest network in both seats
    and step through it in the SCS viewer (ref ``SCS_Renderer.analyse``,
    ``SCS_Renderer.py:105-219``, driven from ``Tester.py:27-35``).  The
    action history is saved as ``runs/<name>/analysis_actions.json``."""
    from nuzero_tpu_torch.config.run_meta import build_from_meta, load_run_meta
    from nuzero_tpu_torch.evaluation import PolicyAgent
    from nuzero_tpu_torch.utils.checkpoint import restore_checkpoint
    from nuzero_tpu_torch.utils.viewer import SCSViewer

    run_dir = resolve_run(name)
    meta = load_run_meta(run_dir)
    if meta is None:
        raise SystemExit(f"{run_dir} has no run_meta.yaml; re-launch the run once through "
                         "the CLI to write one")
    if meta.get("game") != "scs":
        raise SystemExit("--analyse renders SCS runs only")
    env, manager = build_from_meta(meta, REPO, device=device)
    tree, step = restore_checkpoint(os.path.join(run_dir, "checkpoints"), "auto",
                                    device=device)
    params = tree["params"]
    agent = PolicyAgent(manager, params)
    print(f"playing one game with checkpoint step {step} ...")
    state = env.init(1)
    actions = []
    rng = torch.Generator(device=env.device).manual_seed(0)
    while not bool(env.terminal(state)[0]) and len(actions) < max_moves:
        a = agent.choose_host(env, state, params, rng, len(actions))
        state = env.step(state, torch.tensor([a], dtype=torch.int32, device=env.device))
        actions.append(a)
    out_dir = os.path.join(RUNS, name)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "analysis_actions.json")
    with open(path, "w") as f:
        json.dump(actions, f)
    print(f"{len(actions)} moves (terminal={bool(env.terminal(state)[0])}); "
          f"history saved to {path}")
    SCSViewer(env).analyse(actions, fps=fps, auto=auto)
    return actions


def live_goalrush(max_moves: int = 400, fps: int = 8, device="cuda"):
    """--testing-preset 1 --view: watch the goal-rush baseline game live
    (ref RemoteTester + ``SCS_Renderer.render``'s polling loop,
    ``SCS_Renderer.py:51-102``)."""
    from nuzero_tpu_torch.evaluation import GoalRushAgent, RandomAgent
    from nuzero_tpu_torch.utils.viewer import SCSViewer

    env = _scs_env("solo_scout_5.yml", device=device)
    agents = {0: GoalRushAgent(), 1: RandomAgent()}
    holder = {"state": env.init(1), "moves": 0}

    def poll():
        s = holder["state"]
        if bool(env.terminal(s)[0]) or holder["moves"] >= max_moves:
            return s
        p = int(env.current_player(s)[0])
        rng = torch.Generator(device=env.device).manual_seed(holder["moves"])
        a = agents[p].choose_host(env, s, None, rng, holder["moves"])
        holder["state"] = env.step(s, torch.tensor([a], dtype=torch.int32, device=env.device))
        holder["moves"] += 1
        return holder["state"]

    SCSViewer(env).live(poll, fps=fps)
    return holder["state"]


def _random_playout(env, state, max_moves: int):
    """Uniformly random legal moves from ``np.random.default_rng(0)`` until
    the game ends or ``max_moves`` -> (state, moves)."""
    from nuzero_tpu_torch.utils.render import legal_actions

    rng = np.random.default_rng(0)
    moves = 0
    while not bool(env.terminal(state)[0]) and moves < max_moves:
        a = int(rng.choice(legal_actions(env, state)))
        state = env.step(state, torch.tensor([a], dtype=torch.int32, device=env.device))
        moves += 1
    return state, moves


def debug_preset(idx: int, device="cuda"):
    if idx == 0:
        env = _ttt_env(device)
        s, _ = _random_playout(env, env.init(1), 9)
        print(env.render(s))
        print("terminal value:", float(s.terminal_value[0]))
        return s
    if idx == 1:
        from nuzero_tpu_torch.utils.render import render_scs_ascii

        env = _scs_env("open_field_5.yml", device=device)
        s, moves = _random_playout(env, env.init(1), 1000)
        print(render_scs_ascii(env, s))
        print("moves:", moves, "terminal value:", float(s.terminal_value[0]))
        return s
    if idx == 2:
        # MCTS tree dump: search the TTT opening and print the array tree
        # (ref Explorer.print_tree, Search/Explorer.py:216).
        from nuzero_tpu_torch.search.mcts import SearchParams, make_search_fn
        from nuzero_tpu_torch.search.tree import print_tree

        env = _ttt_env(device)
        manager = _managers(env, "mlp", hex=False)
        variables = manager.init(torch.Generator(device=env.device).manual_seed(0))

        def net(v, obs):
            p, val, _ = manager.apply(v, obs)
            return p, val

        search = make_search_fn(env, net, SearchParams(num_simulations=64, keep_subtree=True),
                                training=False, with_tree=True)
        lengths = torch.zeros(1, dtype=torch.int32, device=env.device)
        with torch.no_grad():
            res, tree = search(variables, env.init(1), lengths,
                               torch.Generator(device=env.device).manual_seed(2), None, None)
        print_tree(tree, game_idx=0)
        print(f"chosen action: {int(res.action[0])}, "
              f"root value {float(res.root_value[0]):+.3f}")
        return res, tree
    raise SystemExit(f"unknown debug preset {idx}")


def play(agent_name: str, cache: str = "disabled", device="cuda", **play_kwargs) -> float:
    """--play: a game of Tic-Tac-Toe in the terminal against an agent (ref
    ``Tester.ttt_vs_agent``), the agent's decisions through a host cache
    unless ``cache`` is "disabled"; prints the cache's hit ratio."""
    from nuzero_tpu_torch.evaluation import MctsAgent, RandomAgent, play_vs_agent
    from nuzero_tpu_torch.search.mcts import SearchParams
    from nuzero_tpu_torch.utils.caches import create_cache

    env = _ttt_env(device)
    if agent_name == "mcts":
        manager = _managers(env, "mlp", hex=False)
        variables = manager.init(torch.Generator(device=env.device).manual_seed(0))
        agent = MctsAgent(manager, variables, SearchParams(num_simulations=100))
    else:
        agent = RandomAgent()
    if cache != "disabled":
        agent.set_cache(create_cache(cache, 4096))
    value = play_vs_agent(env, agent, human_player=0, **play_kwargs)
    if agent.cache is not None:
        c = agent.cache
        print(f"{cache} cache: hit ratio {c.hit_ratio():.3f} ({c.hits} hits, {c.misses} misses, "
              f"{c.length()} entries)")
    return value


def build_parser() -> argparse.ArgumentParser:
    """``run.py``'s arguments, ``--device`` and ``--dist-backend``."""
    parser = argparse.ArgumentParser(description="NuZero on PyTorch + CUDA")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--training-preset", type=int)
    group.add_argument("--testing-preset", type=int)
    group.add_argument("--debug", type=int)
    group.add_argument("--interactive", action="store_true")
    group.add_argument("--play", choices=["random", "mcts"],
                       help="play Tic-Tac-Toe in the terminal against an agent "
                       "(ref Tester.ttt_vs_agent)")
    group.add_argument("--analyse", type=str, metavar="RUN",
                       help="replay a game played by RUN's latest checkpoint in the SCS "
                       "viewer (ref SCS_Renderer.analyse)")
    parser.add_argument("--view", action="store_true",
                        help="with --testing-preset 1: watch the goal-rush game live "
                        "(ref SCS_RemoteRenderer)")
    parser.add_argument("--name", type=str, default=None, help="run/network name override")
    parser.add_argument("--train-config", type=str, default=None,
                        help="training-config filename under configs/training/ "
                        "(overrides the preset's default)")
    parser.add_argument("--search-config", type=str, default=None,
                        help="search-config filename under configs/search/ "
                        "(overrides the preset's default)")
    parser.add_argument("--filters", type=int, default=None,
                        help="trunk filter count for conv/recurrent/resnet presets "
                        "(default 64; the reference's flagship presets use 256)")
    parser.add_argument("--net-dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="network COMPUTE dtype (params stay float32)")
    parser.add_argument("--cache", choices=["dict", "keyless", "disabled"], default="disabled",
                        help="host inference cache for --play agents (ref Cache config section)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the torch device everything runs on (default cuda)")
    parser.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                        help="the process group's backend in a multi-process launch (default "
                        "nccl on the card, gloo on the CPU; ranks sharing a card need gloo)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = join_processes(check_device(args.device), args.dist_backend)
    try:
        _run_mode(args, device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _run_mode(args, device):
    if args.training_preset is not None:
        training_preset(args.training_preset, args.name, train_cfg=args.train_config,
                        search_cfg=args.search_config, device=device, filters=args.filters,
                        net_dtype=args.net_dtype)
    elif args.testing_preset is not None:
        if args.view and args.testing_preset == 1:
            live_goalrush(device=device)
        testing_preset(args.testing_preset, args.name, device=device)
    elif args.analyse is not None:
        analyse_run(args.analyse, device=device)
    elif args.debug is not None:
        debug_preset(args.debug, device=device)
    elif args.play is not None:
        play(args.play, args.cache, device=device)
    elif args.interactive:
        from nuzero_tpu_torch.interactive import start

        start(device=device)


if __name__ == "__main__":
    main()
