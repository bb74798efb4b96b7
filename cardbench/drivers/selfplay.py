"""Self-play cells: the training pipeline's own self-play phase.

Set-up builds an ``AlphaZero`` from the traffic's recipe (as ``run.py``'s
training presets build it), draws the weights on the card from the seed,
makes the lockstep self-play state as ``AlphaZero.run`` does, captures the
move's CUDA graph (``AlphaZero._mover``) and plays ``warm_moves`` moves
through ``AlphaZero._launch``.  The window then runs phases of
``AlphaZero._selfplay_until`` to ``games_per_phase`` finished games; the
first move-batch due after ``--seconds`` is not launched, which ends the
window inside its phase.  Every phase waits on the moves before it.

``selfplay_env_steps_per_s`` = actors x simulations x moves completed in the
window / the window's seconds, the moves read from the state's
``total_moves`` after a synchronize.  A ``--trace 1`` run then profiles
``trace_moves`` more moves.  After that the search trees of ``tree_games``
games and ``ring_games`` finished games of the replay ring, drawn from the
seed, are judged by ``reference/selfplay.py``: the env's transitions, the
net's priors and values, the visit counts and value sums of the trees, and
every policy target of the ring against the visit counts of its search.

The two pipeline methods are private: a rename in the port needs a
benchmark change.
"""

from __future__ import annotations

import collections
import sys
import time

import torch

from cardbench import harness
from cardbench.drivers import common
from cardbench.reference import measure
from cardbench.reference import selfplay as ref_selfplay

TREE_FIELDS = ("visit", "value_sum", "parent", "is_terminal", "terminal_value", "expanded",
               "prior", "legal", "child", "states", "root", "free")


class WindowClosed(Exception):
    """Raised before the first move-batch launched after the window's close."""


def build(cell, seed: int, device):
    """(AlphaZero, self-play state, step function, parameters) of a cell."""
    from nuzero_tpu_torch.training.learner import TrainState
    from nuzero_tpu_torch.training.pipeline import AlphaZero
    from nuzero_tpu_torch.training.selfplay import init_selfplay

    traffic, config = cell.traffic, cell.config
    env = common.build_env(traffic, device)
    manager = common.build_manager(config, env)
    cfg, search = common.recipe(traffic, config)
    az = AlphaZero(env, manager, cfg, search, run_dir=None)
    params = harness.draw_params(manager.module, seed, device)
    state = TrainState(params=params, opt_state={}, step=0)
    sp = init_selfplay(env, cfg.running.num_actors,
                       torch.Generator(device=device).manual_seed(seed + 1),
                       az.trajectory_length, search_params=search, state_dim=az.state_dim)
    return az, sp, az.sp_steps[0], state


def _sample(n_total: int, n: int, gen) -> torch.Tensor:
    return torch.randperm(n_total, generator=gen)[:n]


def take_samples(az, sp, traffic: dict, seed: int) -> tuple:
    """The trees of ``tree_games`` games whose tree is carried to the next
    move, and ``ring_games`` finished games of the ring with the longest
    among them, drawn from the seed; copies, on the card."""
    gen = torch.Generator().manual_seed(seed + 2)
    valid = sp.tree_valid.nonzero().flatten().cpu()
    games = valid[_sample(valid.numel(), traffic["check"]["tree_games"], gen)].to(
        sp.tree_valid.device)
    tree = {f: getattr(sp.tree, f)[games].clone() for f in TREE_FIELDS}
    b = az.buffer
    held = (b.length > 0).nonzero().flatten().cpu()
    pick = held[_sample(held.numel(), traffic["check"]["ring_games"], gen)]
    if held.numel():
        longest = held[int(b.length[held].argmax())]
        if not (pick == longest).any():
            pick = torch.cat([pick[:-1] if pick.numel() else pick, longest.reshape(1)])
    pick = pick.to(b.length.device)
    ring = {"states": b.states[pick].clone(), "policy": b.policy[pick].clone(),
            "value": b.value[pick].clone(), "length": b.length[pick].clone()}
    return tree, ring


def work(config: dict, env, batch: int, moves: int, sims: int) -> dict:
    """The hex convs that ``moves`` lockstep moves of ``batch`` games need:
    each move evaluates the whole batch once at its root and once per
    simulation (a carried tree's extra simulation included)."""
    c, h, w = env.observation_shape
    evals = moves * (sims + 1)
    shapes = measure.evaluation_convs(config["num_filters"], c, env.action_space_shape[0],
                                      config["pred_iterations"])
    return {"dtype": config["compute_dtype"], "units": moves, "evaluations": evals,
            "convs": [(batch * h * w, i, o, "forward", evals) for i, o in shapes]}


def compare(readings: dict, limits: dict) -> list:
    """The checks of a run's readings against the cell's limits; a gap
    that the limits file gives no limit is read but not compared."""
    exact = ("window_errors", "transitions_wrong", "visits_wrong", "targets_wrong")
    return ([harness.Check(name, float(readings[name]), 0.0) for name in exact]
            + [harness.Check(name, readings[name], limits[name])
               for name in ("prior_gap", "value_gap", "backup_gap") if name in limits]
            + [harness.Check("nodes_compared", float(readings["nodes_compared"]),
                             float(limits["min_nodes_compared"]), at_most=False),
               harness.Check("values_compared", float(readings["values_compared"]), 1.0,
                             at_most=False),
               harness.Check("backups_compared", float(readings["backups_compared"]), 1.0,
                             at_most=False),
               harness.Check("ring_games", float(readings["ring_games"]), 1.0,
                             at_most=False)])


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control=None):
    """One run of the cell; ``control`` (``calibrate.py`` only) also reads
    the control, the plain net one precision lower, on the same nodes."""
    traffic = cell.traffic
    build_s = common.build_kernels(device)
    az, sp, step_fn, state = build(cell, seed, device)
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
        # The flag is sticky over replays: the moves whose counts the cut
        # phase never read are covered too.
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
    ref = ref_selfplay.make_env(common.scenario_data(traffic), traffic["scenario_seed"],
                                traffic["randomize_vp"], device)
    with torch.no_grad():
        t = ref_selfplay.judge_trees(tree, ref, params_ref, cell.config["pred_iterations"],
                                     control)
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
