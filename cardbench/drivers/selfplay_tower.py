"""Self-play cells of AlphaZero's batch-norm residual tower: the self-play
driver (``drivers/selfplay.py``) with the port's ``ResNet(batch_norm=True)``
in the recurrent net's place, its weights and yardstick, and its plain
reference (``reference/tower.py``).

Set-up builds the ``AlphaZero`` first (a port whose learner refuses a
batch-norm net fails there, before any kernel is built), draws the weights
on the card from the seed (``tower.draw_params``: the running statistics
from a seeded batch of the scenario's positions), builds the kernels,
captures the move and plays ``warm_moves`` moves.  The window, the metrics
and the checks are the self-play driver's.
"""

from __future__ import annotations

import collections
import sys
import time

import torch

from cardbench import harness
from cardbench.drivers import common
from cardbench.drivers.selfplay import WindowClosed, compare, take_samples
from cardbench.reference import selfplay as ref_selfplay
from cardbench.reference import tower


def build_manager(config: dict, env):
    """The port's ``ResNet`` of the configuration, on the env's device,
    behind a ``NetworkManager``."""
    from nuzero_tpu_torch.networks.manager import NetworkManager
    from nuzero_tpu_torch.networks.resnet import ResNet

    channels, planes = env.observation_shape[0], env.action_space_shape[0]
    net = ResNet(channels, planes, num_filters=config["num_filters"],
                 num_blocks=config["num_blocks"], batch_norm=config["batch_norm"],
                 policy_head=config["policy_head"], value_head=config["value_head"],
                 value_activation=config["value_activation"], hex=config["hex"],
                 dtype=getattr(torch, config["compute_dtype"]))
    return NetworkManager(net.to(env.device), env.observation_shape)


def build(cell, seed: int, device):
    """(AlphaZero, self-play state, step function, parameters, reference env)."""
    from nuzero_tpu_torch.training.learner import TrainState
    from nuzero_tpu_torch.training.pipeline import AlphaZero
    from nuzero_tpu_torch.training.selfplay import init_selfplay

    traffic, config = cell.traffic, cell.config
    env = common.build_env(traffic, device)
    manager = build_manager(config, env)
    # A ResNet has no recurrent iterations; the recipe's fields take 1.
    cfg, search = common.recipe(traffic, dict(config, train_iterations=1, pred_iterations=1))
    az = AlphaZero(env, manager, cfg, search, run_dir=None)
    ref = ref_selfplay.make_env(common.scenario_data(traffic), traffic["scenario_seed"],
                                traffic["randomize_vp"], device)
    named, buffers = tower.layout(env.observation_shape[0], env.action_space_shape[0],
                                  config["num_filters"], config["num_blocks"])
    ports = [(k, tuple(v.shape)) for k, v in manager.module.state_dict().items()]
    if sorted(ports) != sorted(named + buffers):
        raise ValueError("the port's tower and reference/tower.py's layout differ")
    params = tower.draw_params(named, seed, device, tower.positions(ref, seed + 3))
    state = TrainState(params={k: params[k] for k, _ in ports}, opt_state={}, step=0)
    sp = init_selfplay(env, cfg.running.num_actors,
                       torch.Generator(device=device).manual_seed(seed + 1),
                       az.trajectory_length, search_params=search, state_dim=az.state_dim)
    return az, sp, az.sp_steps[0], state, ref


def work(config: dict, env, batch: int, moves: int, sims: int) -> dict:
    """The hex convs that ``moves`` lockstep moves of ``batch`` games need:
    each move evaluates the whole batch once at its root and once per
    simulation (a carried tree's extra simulation included)."""
    c, h, w = env.observation_shape
    evals = moves * (sims + 1)
    shapes = tower.evaluation_convs(config["num_filters"], c, env.action_space_shape[0],
                                    config["num_blocks"])
    return {"dtype": config["compute_dtype"], "units": moves, "evaluations": evals,
            "convs": [(batch * h * w, i, o, "forward", evals) for i, o in shapes]}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control=None):
    """One run of the cell; ``control`` (``calibrate.py`` only) also reads
    the control, the plain tower one precision lower, on the same nodes."""
    traffic = cell.traffic
    az, sp, step_fn, state, ref = build(cell, seed, device)
    build_s = common.build_kernels(device)
    params_ref = {k: v.detach().clone() for k, v in state.params.items()}
    sims = az.search_params.num_simulations
    B = sp.move_count.shape[0]

    t0 = time.perf_counter()
    move = az._mover(step_fn, sp, state.params)
    common.sync(device)
    capture_s = time.perf_counter() - t0
    pending = collections.deque()
    for _ in range(traffic["warm_moves"]):
        az._launch(move, pending)
    while pending:
        az._settle(pending.popleft())
    common.sync(device)

    clock = common.Deadline(seconds)
    launch = az._launch

    def guarded(move_fn, queue):
        if clock.over():
            raise WindowClosed
        return launch(move_fn, queue)

    az._launch = guarded
    errors = []
    moves0 = int(sp.total_moves)
    setup_s = time.perf_counter() - t_start
    clock.open()
    try:
        while True:
            az._selfplay_until(state, sp, step_fn, traffic["games_per_phase"])
    except WindowClosed:
        pass
    except OverflowError as exc:
        errors.append(repr(exc))
    common.sync(device)
    window_s = time.perf_counter() - clock.t0
    az._launch = launch
    graph = az._graphs.get(step_fn)
    if graph is not None and bool(graph.overflow):
        errors.append("a loop bounded for the move's CUDA graph ran past its bound")
    moves = (int(sp.total_moves) - moves0) // B
    rate = moves * B * sims / window_s
    memory = common.memory_peak(device)

    print(f"cardbench: set-up {setup_s:.3f} s, of which kernel build {build_s:.3f} s, "
          f"capture {capture_s:.3f} s", file=sys.stderr)
    context = {"kind": "selfplay", "cell": cell.name, "capture_s": capture_s,
               "window": {"seconds": window_s, **work(cell.config, az.env, B, moves, sims)}}
    if trace and not errors:
        n = traffic["trace_moves"]

        def traced():
            queue = collections.deque()
            for _ in range(n):
                az._launch(move, queue)
            while queue:
                az._settle(queue.popleft())

        _, raw = harness.profile(traced)
        context["trace"] = harness.summarize(raw)
        context["traced"] = work(cell.config, az.env, B, n, sims)
        del raw

    tree, ring = take_samples(az, sp, traffic, seed)
    del az, sp, move, state, step_fn
    common.release(device)
    with torch.no_grad():
        t = tower.judge_trees(tree, ref, params_ref, control)
        r = ref_selfplay.judge_ring(ring, ref, sims)
    low = t.pop("control", None)
    readings = {"window_errors": len(errors), **t,
                "transitions_wrong": t["transitions_wrong"] + r["transitions_wrong"],
                **{k: v for k, v in r.items() if k != "transitions_wrong"}}
    if control is not None:
        context["readings"] = readings
        context["control"] = {**readings, **low}
    checks = compare(readings, cell.limits)
    print("cardbench: readings " + ", ".join(
        f"{k} = {readings[k]!r}" for k in ("value_gap", "value_gap_max", "backup_gap",
                                           "backup_gap_max", "targets_from_full_trees")
        if k in readings), file=sys.stderr)
    for e in errors:
        print(f"cardbench: {e}", file=sys.stderr)
    end_to_end = {"selfplay_env_steps_per_s": {"value": rate, "unit": "env-steps/s"},
                  "setup_s": {"value": setup_s, "unit": "s"}}
    return common.Outcome(checks=checks, attempted=moves, failed=len(errors),
                          end_to_end=end_to_end, memory_peak_bytes=memory, context=context)
