"""Time one MCTS in-loop test of ``ttt_long.yaml``, alone and beside training.

    python -m nuzero_tpu_torch.evaluation.time_inloop [--legs sync,worker,...]
        [--out chiprun_out/time_inloop.json]

The test is the pipeline's own job (``AlphaZero._inloop_test_job``, due
at step 3, with the policy test switched off): the MCTS agent (100
simulations, ``configs/search/ttt_search.yaml``) against the random agent,
``num_mcts_test_games`` games from each seat, with the learning milestone's
network (``RecurrentNet(hex=False, num_filters=64, num_blocks=2)``, random
weights from seed 0).  Each leg runs it once, after a warm-up:

- ``sync``: on the main thread, the card otherwise idle (the eager search's
  own cost: its host reads and launches);
- ``worker``: on the eval worker thread and stream, the main thread waiting;
- ``selfplay``: on the worker while the main thread plays self-play steps
  (replays of the captured move graph: the card busy, little Python);
- ``replay``: on the worker while the main thread only replays the move's
  graph and waits for it, one replay after another (the GIL nearly free);
- ``queued``: as ``replay``, but with ``PIPELINE_DEPTH`` replays in flight
  as in the self-play loop, waiting on the oldest one's event;
- ``learner``: on the worker while the main thread runs the learner's
  steps on a filled buffer (eager updates: much Python, a lighter card);
- ``training`` and ``training-high``: on the worker while ``AlphaZero.run()``
  trains, the eval stream at the default and at the highest priority.

``--moves N`` cuts each arena batch to N moves (``--moves 1``: one MCTS
search and one random move).  Each leg prints the job's seconds, its arena moves and their median
seconds, and for the concurrent legs the main thread's steps and their
median seconds while the job ran.  Nothing is checked here.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import statistics
import tempfile
import time

import torch

from nuzero_tpu_torch.config.schemas import load_search_config, load_training_config
from nuzero_tpu_torch.envs.tictactoe import TicTacToe
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.recurrent import RecurrentNet
from nuzero_tpu_torch.ops.cuda.measure import card_line
from nuzero_tpu_torch.training.pipeline import AlphaZero
from nuzero_tpu_torch.training.selfplay import init_selfplay

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
CONFIG = os.path.join(REPO, "configs", "training", "ttt_long.yaml")
SEARCH = os.path.join(REPO, "configs", "search", "ttt_search.yaml")
LEGS = ("sync", "worker", "training", "training-high", "selfplay", "replay", "queued",
        "learner")
STEP = 3  # the step of the timed job (the training legs train up to it first)


class _Stop(Exception):
    """Ends a training leg once its job has been harvested."""


def _config():
    cfg = load_training_config(CONFIG)
    return dataclasses.replace(
        cfg,
        testing=dataclasses.replace(cfg.testing, early_testing=False,
                                    policy_test_frequency=0, mcts_test_frequency=STEP),
        saving=dataclasses.replace(cfg.saving, save_frequency=10**9),
        plotting=dataclasses.replace(cfg.plotting, plot_loss=False))


def _coordinator(run_dir=None, max_moves=None):
    """An AlphaZero of the milestone's recipe whose in-loop job is timed:
    ``az.jobs`` collects (start, end, seconds of each arena move), start and
    end on the journal's clock (``time.time``)."""
    env = TicTacToe("cuda")
    net = RecurrentNet(env.observation_shape[0], env.action_space_shape[0], num_filters=64,
                       num_blocks=2, hex=False).cuda()
    az = AlphaZero(env, NetworkManager(net, env.observation_shape), _config(),
                   load_search_config(SEARCH), run_dir=run_dir)
    az.jobs, az.max_moves = [], max_moves
    job, batch = az._inloop_test_job, az.test_manager.run_test_batch
    moves: list = []

    def run_test_batch(*args, **kwargs):
        kwargs.setdefault("max_moves", az.max_moves)
        stats = batch(*args, **kwargs)
        moves.extend(az.test_manager.last_arena.seconds_per_move)
        return stats

    def timed_job(params, step):
        moves.clear()
        t0 = time.time()  # the journal's clock
        out = job(params, step)
        torch.cuda.current_stream().synchronize()
        az.jobs.append((t0, time.time(), list(moves)))
        return out

    az.test_manager.run_test_batch = run_test_batch
    az._inloop_test_job = timed_job
    return az


def _warm_up(az, params):
    """One arena move of each agent path, outside any timing."""
    for agent in (az._mcts_agent, az._policy_agent):
        agent.set_network(params)
        az.test_manager.run_test_batch(8, agent, az._random_agent, az.test_manager.generator(0),
                                       show_results=False, max_moves=1)
    torch.cuda.synchronize()


def _concurrent(az, state, work) -> tuple:
    """Submit the job, call ``work()`` until it is done -> seconds of each call."""
    az._run_inloop_tests(state, STEP)
    (_, fut), = az._pending_tests
    seconds = []
    while not fut.done():
        t0 = time.perf_counter()
        work()
        seconds.append(time.perf_counter() - t0)
    az._harvest_async_tests(block=True)
    return seconds


def _leg(name: str, max_moves) -> dict:
    if name.startswith("training"):
        return _training_leg(name == "training-high", max_moves)
    az = _coordinator(max_moves=max_moves)
    state = az.learner.init_state(torch.Generator(device="cuda").manual_seed(0))
    _warm_up(az, state.params)
    main = []
    if name == "sync":
        az._test_executor = None
        az._run_inloop_tests(state, STEP)
    elif name == "worker":
        az._run_inloop_tests(state, STEP)
        az._harvest_async_tests(block=True)
    elif name in ("selfplay", "replay", "queued", "learner"):
        cfg = az.cfg.running
        sp = init_selfplay(az.env, cfg.num_actors, torch.Generator(device="cuda").manual_seed(2),
                           az.trajectory_length, search_params=az.search_params,
                           state_dim=az.state_dim)
        # Captures the move's graph and fills the buffer, as the early fill.
        az._rng = torch.Generator(device="cuda").manual_seed(0)
        az._host_rng = torch.Generator().manual_seed(0)
        az._selfplay_until(state, sp, az.sp_steps[0], cfg.early_fill_per_type)
        if name == "selfplay":
            main = _concurrent(az, state, lambda: az._selfplay_until(
                state, sp, az.sp_steps[0], cfg.num_games_per_type_per_step))
        elif name == "replay":
            graph = az._graphs[az.sp_steps[0]]

            def replay():
                graph.replay()
                torch.cuda.current_stream().synchronize()
            main = _concurrent(az, state, replay)
        elif name == "queued":
            graph, events = az._graphs[az.sp_steps[0]], collections.deque()

            def queued():
                graph.replay()
                events.append(torch.cuda.Event())
                events[-1].record()
                if len(events) > az.PIPELINE_DEPTH:
                    events.popleft().synchronize()
            main = _concurrent(az, state, queued)
        else:
            main = _concurrent(az, state, lambda: az._train_once(state))
    else:
        raise ValueError(f"unknown leg {name!r}")
    return _result(name, az, main)


def _training_leg(high: bool, max_moves) -> dict:
    with tempfile.TemporaryDirectory() as run_dir:
        az = _coordinator(run_dir, max_moves)
        if high:
            low, top = torch.cuda.Stream.priority_range()
            az._eval_stream = torch.cuda.Stream(az.device, priority=top)
        else:
            az._eval_stream = torch.cuda.Stream(az.device, priority=0)
        state = az.learner.init_state(torch.Generator(device="cuda").manual_seed(0))
        _warm_up(az, state.params)
        az._tests_due = lambda step: step == STEP
        harvest = az._harvest_async_tests

        def harvest_then_stop(block=False):
            harvest(block)
            if az.jobs and not az._pending_tests:
                raise _Stop

        az._harvest_async_tests = harvest_then_stop
        try:
            az.run(seed=0, initial_state=state)
        except _Stop:
            pass
        start, end = az.jobs[0][:2]
        records = az.journal.load()
        # Steps that ended while the job ran (the step that launched it ends
        # after the launch).
        main = [r["step_time_s"] for r in records
                if "step_time_s" in r and r["step"] > STEP
                and start < r["ts"] <= end]
        solo = [r["step_time_s"] for r in records
                if "step_time_s" in r and 1 < r["step"] < STEP]
    out = _result("training-high" if high else "training", az, main)
    out["main_s_median_before_job"] = statistics.median(solo) if solo else None
    return out


def _result(name, az, main) -> dict:
    start, end, moves = az.jobs[0]
    # Move 0 of the first batch is the MCTS agent's (seat 0) first search.
    return {"leg": name, "job_s": end - start, "arena_moves": len(moves),
            "first_move_s": moves[0], "s_per_arena_move_median": statistics.median(moves),
            "main_calls": len(main),
            "main_s_median": statistics.median(main) if main else None,
            "games_per_seat": az.cfg.testing.num_mcts_test_games, "max_moves": az.max_moves,
            "simulations": az.search_params.num_simulations}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--legs", default=",".join(LEGS))
    ap.add_argument("--moves", type=int, default=None,
                    help="cut each arena batch to this many moves")
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_inloop needs a CUDA card")
    card = card_line()
    print(card, flush=True)
    results = []
    for name in args.legs.split(","):
        r = _leg(name, args.moves)
        r["card"] = card
        results.append(r)
        print(json.dumps(r), flush=True)
        if args.out:  # rewritten after every leg
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
