"""Arena cells: the transfer sweep's far point through the evaluation path.

Set-up builds the traffic's resized SCS env (``board_size``, ``turns``,
victory points drawn per game) and, through ``TestManager``'s agent builder
(as ``TestManager.test_from_config`` builds a Testing YAML's agents), the
random agent as p1 and a ``PolicyAgent`` as p2 at ``iterations`` recurrent
iterations on the committed checkpoint that the traffic names; then it plays
one warm batch.  The window runs ``TestManager.run_test_batch`` on batches of
``games`` games, each from a generator seeded from the seed, until
``--seconds`` have passed.

Every arena move calls the env's ``step`` once; the benchmark stamps each
call on the host clock.  A move lasts from the stamp before it (or its
batch's start) to its own: the host read that opens each move waits for the
move before, and the batch's last read closes the last.  ``arena_move_p95_ms``
is the 95th percentile over every move of the window and
``arena_positions_per_s`` the live games moved over the window's seconds.

After the window the reference (``reference/arena.py``) replays every
recorded move through the frozen engine, recomputes the outcome counts, and
evaluates the plain net on the policy seat's positions at ``check_moves``
moves drawn from the seed.
"""

from __future__ import annotations

import math
import os
import sys
import time

import torch

from cardbench import harness
from cardbench.drivers import common
from cardbench.reference import arena as ref_arena
from cardbench.reference import measure
from cardbench.reference import selfplay as ref_selfplay


class Recorder:
    """The env's ``step`` with a host stamp and the (state, action) of every
    call kept by reference (no copy, no device work), with the policy
    network's logits of the move where it ran (``apply``, which wraps the
    agent's ``NetworkManager.apply``)."""

    def __init__(self, env, manager):
        self.env = env
        self.step = env.step
        self.manager_apply = manager.apply
        self.moves = []  # (batch, state, action, logits or None)
        self.stamps = []  # per batch: [start, stamp of each move]
        self.on = False
        self.calls = 0
        self.logits = None

    def __call__(self, state, action):
        self.calls += 1
        if self.on:
            self.stamps[-1].append(time.perf_counter())
            self.moves.append((len(self.stamps) - 1, state, action, self.logits))
        self.logits = None
        return self.step(state, action)

    def apply(self, *args, **kwargs):
        out = self.manager_apply(*args, **kwargs)
        self.logits = out[0]
        return out

    def open_batch(self):
        self.stamps.append([time.perf_counter()])

    def close_batch(self):
        self.stamps[-1].append(time.perf_counter())


def checkpoint_path(traffic: dict) -> str:
    return os.path.join(harness.ROOT, *traffic["checkpoint"].split("/"))


def build(cell, device):
    from nuzero_tpu_torch.evaluation.manager import TestManager

    traffic, config = cell.traffic, cell.config
    size = traffic["board_size"]
    env = common.build_env(traffic, device, board_size=size, turns=traffic["turns"])
    manager = common.build_manager(config, env)
    tm = TestManager(env)
    run_dir = os.path.dirname(os.path.dirname(checkpoint_path(traffic)))
    p1 = tm.create_agent_from_config({"agent_type": "random"})
    p2 = tm.create_agent_from_config(
        {"agent_type": "policy",
         "Network": {"recurrent_iterations": traffic["iterations"], "load_checkpoint": True,
                     "Checkpoint": {"cp_network_name": os.path.basename(run_dir),
                                    "cp_number": traffic["checkpoint_step"]}}},
        manager=manager, game_dir=os.path.dirname(run_dir))
    return env, tm, p1, p2


def compare(readings: dict, limits: dict) -> list:
    """The checks of a run's readings against the cell's limits."""
    exact = ("window_errors", "transitions_wrong", "counts_wrong", "illegal_actions",
             "actions_off")
    return ([harness.Check(name, float(readings[name]), 0.0) for name in exact]
            + [harness.Check("logit_gap", readings["logit_gap"], limits["logit_gap"]),
               harness.Check("positions_compared", float(readings["positions_compared"]),
                             float(limits["min_positions_compared"]), at_most=False)])


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control=None):
    """One run of the cell; ``control`` (``calibrate.py`` only) also reads
    the control, the plain net one precision lower, at the same positions."""
    traffic, config = cell.traffic, cell.config
    build_s = common.build_kernels(device)
    env, tm, p1, p2 = build(cell, device)
    games = traffic["games"]
    recorder = Recorder(env, p2.manager)
    env.step = recorder
    p2.manager.apply = recorder.apply
    tm.run_test_batch(games, p1, p2, tm.generator(seed), show_results=False)
    common.sync(device)

    clock = common.Deadline(seconds)
    stats, errors = [], []
    setup_s = time.perf_counter() - t_start
    recorder.on = True
    clock.open()
    batch = 0
    try:
        while True:
            batch += 1
            recorder.open_batch()
            stats.append(tm.run_test_batch(games, p1, p2, tm.generator(seed + batch),
                                           show_results=False))
            recorder.close_batch()
            if clock.over():
                break
    except RuntimeError as exc:
        errors.append(repr(exc))
    common.sync(device)
    window_s = time.perf_counter() - clock.t0
    recorder.on = False
    memory = common.memory_peak(device)
    print(f"cardbench: set-up {setup_s:.3f} s, of which kernel build {build_s:.3f} s",
          file=sys.stderr)
    move_s = [b - a for stamps in recorder.stamps for a, b in zip(stamps, stamps[1:])]
    live = torch.stack([(~env.terminal(s)).sum() for _, s, _, _ in recorder.moves]).tolist() \
        if recorder.moves else []
    positions = sum(live)
    c, h, w = env.observation_shape
    policy_moves = sum(1 for *_, lg in recorder.moves if lg is not None)
    context = {"kind": "arena", "cell": cell.name,
               "window": {"seconds": window_s, "units": len(move_s)}}
    if trace and not errors:
        n = traffic["trace_batches"]
        recorder.on = False
        evals = []
        policy = p2.policy(env)

        def counting(variables, states, lengths, rng):
            evals.append(1)
            return policy(variables, states, lengths, rng)

        p2._policy_cache[(id(env), p2._policy_key())] = counting

        def traced():
            for k in range(n):
                tm.run_test_batch(games, p1, p2, tm.generator(seed - 1 - k), show_results=False)

        calls = recorder.calls
        _, raw = harness.profile(traced)
        moves_traced = recorder.calls - calls
        p2._policy_cache[(id(env), p2._policy_key())] = policy
        context["trace"] = harness.summarize(raw)
        shapes = measure.evaluation_convs(config["num_filters"], c, env.action_space_shape[0],
                                          traffic["iterations"])
        context["traced"] = {"dtype": config["compute_dtype"], "units": moves_traced,
                             "evaluations": len(evals),
                             "convs": [(games * h * w, i, o, "forward", len(evals))
                                       for i, o in shapes]}
        del raw

    gen = torch.Generator().manual_seed(seed + 2)
    moves = recorder.moves
    with_logits = [i for i, m in enumerate(moves) if m[3] is not None]
    picks = [with_logits[i] for i in
             torch.randperm(len(with_logits), generator=gen)[:traffic["check_moves"]].tolist()]
    record = {"moves": [(b, {k: v.clone() for k, v in vars(s).items()}, a.clone(),
                         None if lg is None else lg.clone()) for b, s, a, lg in moves],
              "picks": picks,
              "stats": [(st.p0_wins, st.p1_wins, st.draws) for st in stats[:len(recorder.stamps)]]}
    del recorder, tm, p1, p2, moves
    env.step = None
    common.release(device)
    data = common.scenario_data(traffic, traffic["board_size"], traffic["turns"])
    ref = ref_selfplay.make_env(data, traffic["scenario_seed"], traffic["randomize_vp"], device)
    params = ref_arena.load_params(checkpoint_path(traffic), device)
    with torch.no_grad():
        readings = {"window_errors": len(errors),
                    **ref_arena.judge(record, ref, params, traffic["iterations"])}
        if control is not None:
            context["readings"] = readings
            context["control"] = {**readings, **ref_arena.control(
                record, ref, params, traffic["iterations"], control)}
    checks = compare(readings, cell.limits)
    for e in errors:
        print(f"cardbench: {e}", file=sys.stderr)
    ordered = sorted(move_s)
    p95 = ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)] if ordered else float("nan")
    end_to_end = {"arena_positions_per_s": {"value": positions / window_s, "unit": "positions/s"},
                  "arena_move_p95_ms": {"value": p95 * 1e3, "unit": "ms"},
                  "setup_s": {"value": setup_s, "unit": "s"}}
    context["policy_moves"] = policy_moves
    return common.Outcome(checks=checks, attempted=len(move_s), failed=len(errors),
                          end_to_end=end_to_end, memory_peak_bytes=memory, context=context)
