"""Time the captured self-play move, and what conditional nodes cost a launch.

    python -m nuzero_tpu_torch.training.time_graph [--filters 64]
        [--dtype float32] [--batch 512] [--replays 6]

1. The move: at one self-play leg (SCS ``open_field_5.yml`` seed 42, a hex
   ``RecurrentNet`` with 2 blocks and recall at 2 iterations, random
   weights, 30 simulations with carried trees, ``training=True``) it
   captures the move (``capture_selfplay_step``) and replays it
   ``--replays`` times, printing each replay's seconds, the host's seconds
   until ``replay()`` returned, and the median of replays 2 on.
2. Conditional nodes: graphs of k ``graphs.run_while`` loops whose
   condition is false at once (a body of one kernel, never run), for k of
   0, 61 (the move's loops: 31 stage machines and 30 descents), 610 and
   3,600 (about one if-node per trip of the move's loops); each replayed
   ``--replays`` times, printing the median host seconds until
   ``replay()`` returned and until the card was done.

Nothing is checked here; ``chip_smoke.py`` checks the move.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

import torch

from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.recurrent import RecurrentNet
from nuzero_tpu_torch.ops.cuda.build import build_all
from nuzero_tpu_torch.ops.cuda.measure import card_line
from nuzero_tpu_torch.search.mcts import SearchParams
from nuzero_tpu_torch.training.selfplay import (
    capture_selfplay_step, init_selfplay, make_selfplay_step,
)
from nuzero_tpu_torch.utils import graphs

SCENARIO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "configs",
                        "scenarios", "open_field_5.yml")
SIMS = 30
LOOPS = (0, 61, 610, 3600)


def _replays(replay, n):
    """(seconds, seconds until replay() returned) of ``n`` replays."""
    seconds, returned = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay()
        returned.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return seconds, returned


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--filters", type=int, default=64)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--replays", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_graph needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_all()
    print(card_line(), flush=True)

    env = SCSGame(load_scenario(SCENARIO, seed=42), device="cuda")
    net = RecurrentNet(env.observation_shape[0], env.action_space_shape[0],
                       num_filters=args.filters, num_blocks=2, recall=True, hex=True,
                       dtype=getattr(torch, args.dtype)).to("cuda")
    mgr = NetworkManager(net, env.observation_shape)
    variables = mgr.init(torch.Generator(device="cuda").manual_seed(0))

    def apply(v, obs):
        p, val, _ = mgr.apply(v, obs, iters_to_do=2)
        return p, val

    params = SearchParams(num_simulations=SIMS)
    step = make_selfplay_step(env, apply, params, training=True)
    sp = init_selfplay(env, args.batch, torch.Generator(device="cuda").manual_seed(1),
                       search_params=params)
    graph = capture_selfplay_step(step, variables, sp)
    seconds, returned = _replays(graph.replay, args.replays)
    print(f"move {args.filters}f {args.dtype} B={args.batch}: replays "
          + " ".join(f"{t:.4f}" for t in seconds) + " s (replay() returned after "
          + " ".join(f"{t:.4f}" for t in returned) + f" s); median of replays "
          f"2-{args.replays} {statistics.median(seconds[1:]):.4f} s", flush=True)
    del graph, sp

    never = torch.zeros((), dtype=torch.bool, device="cuda")
    x = torch.zeros((), device="cuda")
    for loops in LOOPS:
        g = torch.cuda.CUDAGraph()
        with graphs.capture(g):
            for _ in range(loops):
                graphs.run_while(lambda: never, lambda: x.add_(1), 1)
        seconds, returned = _replays(g.replay, args.replays)
        print(f"{loops} while-nodes: median of replays 2-{args.replays}: replay() returned "
              f"after {statistics.median(returned[1:]) * 1e3:.3f} ms, done after "
              f"{statistics.median(seconds[1:]) * 1e3:.3f} ms", flush=True)
        del g


if __name__ == "__main__":
    main()
