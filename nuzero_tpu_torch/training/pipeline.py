"""AlphaZero coordinator: self-play -> replay -> SGD (counterpart of
``nuzero_tpu/training/pipeline.py``; behavioral target the reference's
``Training/AlphaZero.py`` ``run()``).

An early buffer fill with softened exploration, then per training step
self-play, the learner's updates (the samples or the epochs method), a
journal record and, every ``save_frequency`` steps, a checkpoint and the
plots (``utils/plots.py``), which are drawn again at the end of a run.
Self-play, replay and SGD all work on tensors on the env's device; the
host loop sequences them and does the IO.  On the card each self-play move
is a replay of a CUDA graph of the move (``selfplay.capture_selfplay_step``,
captured at first use, once per run and step function), which reads
nothing on the host; the loop reads a move-batch's finished count and
overflow flag ``PIPELINE_DEPTH`` batches later.

Running modes: ``sequential`` plays until the step's games finish;
``asynchronous`` plays move-batches, round-robin over the game types and
always at least one, until ``update_delay`` seconds of wall clock have
passed since the step began.  A list of envs trains one network on several
game types that share observation and action shapes, each with its own
self-play batch, graph and ``pred_iterations`` / ``train_iterations``
entry; each update draws one sub-batch per type.

Journaled every ``plot_frequency`` steps: the value head's output on a
probe ``state_set`` (``value_probe/{i}``, ``evaluation/state_sets.py``)
and, under ``plot_weights``, ``weights/abs_max``, ``abs_min`` and
``abs_mean`` over the network's parameters.

In-loop evaluation (``Testing``): every ``policy_test_frequency`` /
``mcts_test_frequency`` steps, and at step 0 under ``early_testing``, the
policy and MCTS agents play the random agent (and the GoalRush agent under
``goal_rush_opponent``) from both seats; the win and non-loss rates are
journaled under the JAX pipeline's keys.  With ``asynchronous_testing``
a job runs on a worker thread and its own CUDA stream, on a copy of the
parameters, and is journaled under its launch step when it is harvested;
pending jobs are joined before a CUDA graph is captured, since a capture
admits no other thread's launches.

Environment switches: ``NUZERO_MFU=1`` journals ``train_flops_per_s``
(3x the FLOPs of one forward at the train batch size, counted once by
``torch.utils.flop_counter`` on the ``meta`` device, per second of the
step); ``NUZERO_TRACE_DIR=<dir>`` writes a Chrome trace of step
``starting_step + 2`` (``torch.profiler``) into ``<dir>``, with the port's
``nuzero.*`` spans (``utils/profiling.py``) among its events.

Resume: ``load`` restores params, optimizer state and buffer; where the
checkpoint holds no buffer and ``load_buffer`` is on, the newest saved
buffer truncated to the journal's ``buffer_seq`` at the restored step
(``load_buffer_at_step``); where there is none, it warns and goes on with
the empty buffer.

Data parallel (``mesh``, ``parallel/mesh.py``): one process per card over
``torch.distributed``, where the JAX coordinator runs one SPMD program over
a ``dp`` mesh of devices.  Rank r plays ``num_actors / N`` games from a
self-play generator of its own, into a ring of ``replay_window_size / N``
games of its own (``training/replay.py``); the parameters start from rank
0's and stay bit-equal, as every rank applies the same all-reduced update
(``training/learner.py``) to the same global batch, sampled over all the
rings, each forwarding an equal block of it (so every per-type batch must
divide over the ranks).  A move-batch's (finished, overflow) pair is summed over the ranks
when the host reads it, ``PIPELINE_DEPTH`` late, so every rank launches the
same number of move-batches and the early fill's and a step's game targets
are global, as in JAX.  The journal (``games`` and ``buffer_*`` global),
plots, probes, weight stats and in-loop tests run on rank 0, which writes
the checkpoint's params and optimizer state once; each rank writes its own
ring beside it (``utils/checkpoint.py``).  ``NUZERO_MFU`` is off across
processes, and the asynchronous mode is refused there, as in JAX: its
wall-clock exit can differ across ranks, which then launch different
numbers of collectives.  A one-rank mesh runs bit-equal to no mesh.
"""

from __future__ import annotations

import collections
import concurrent.futures
import copy
import dataclasses
import os
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from nuzero_tpu_torch.config.schemas import TrainingConfig
from nuzero_tpu_torch.evaluation.agents import (
    GoalRushAgent, MctsAgent, PolicyAgent, RandomAgent,
)
from nuzero_tpu_torch.evaluation.manager import TestManager
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.search.mcts import SearchParams
from nuzero_tpu_torch.training import replay as replay_lib
from nuzero_tpu_torch.training.learner import Learner, LearnerConfig, TrainState
from nuzero_tpu_torch.training.selfplay import (
    capture_selfplay_step, init_selfplay, make_selfplay_step, play_in_place,
)
from nuzero_tpu_torch.parallel.mesh import place_replicated
from nuzero_tpu_torch.utils.checkpoint import (
    latest_step, restore_checkpoint, restore_ring, save_checkpoint,
)
from nuzero_tpu_torch.utils.metrics import MetricsJournal
from nuzero_tpu_torch.utils.packing import make_packer
from nuzero_tpu_torch.utils.plots import plot_training_run
from nuzero_tpu_torch.utils.printbar import PrintBar
from nuzero_tpu_torch.utils.profiling import PhaseTimers, span


def learner_config_from_training(cfg: TrainingConfig, num_game_types: int = 1) -> LearnerConfig:
    ti = cfg.recurrent.train_iterations
    per_type = (
        tuple(ti[t] if t < len(ti) else ti[0] for t in range(num_game_types))
        if num_game_types > 1 else ()
    )
    return LearnerConfig(
        train_iterations_per_type=per_type,
        policy_loss=cfg.learning.policy_loss,
        value_loss=cfg.learning.value_loss,
        normalize_policy=cfg.learning.normalize_cel,
        optimizer=cfg.optimizer.optimizer_choice,
        learning_rate=cfg.optimizer.starting_lr,
        scheduler_boundaries=cfg.optimizer.scheduler_boundaries,
        scheduler_gamma=cfg.optimizer.scheduler_gamma,
        weight_decay=cfg.optimizer.weight_decay,
        momentum=cfg.optimizer.momentum,
        nesterov=cfg.optimizer.nesterov,
        train_iterations=cfg.recurrent.train_iterations[0],
        prog_alpha=cfg.recurrent.alpha,
    )


def sub_batch_sizes(batch_size: int, num_types: int) -> list:
    """Per-type sub-batch sizes summing to ``batch_size``, the remainder
    spread over the first types."""
    T = num_types
    return [batch_size // T + (1 if t < batch_size % T else 0) for t in range(T)]


def unported_options(mesh=None) -> list:
    """The options of the JAX coordinator that the port does not run: none
    since the mesh (kept so that a caller can ask)."""
    return []


class AlphaZero:
    """Training coordinator (ref class ``AlphaZero``, ``AlphaZero.py:54``).
    Runs on the env's device."""

    # How many move-batches the host runs ahead before it reads a batch's
    # finished-game count (the JAX coordinator's PIPELINE_DEPTH).
    PIPELINE_DEPTH = 3

    def __init__(
        self,
        env,
        manager: NetworkManager,
        train_config: TrainingConfig,
        search_params: SearchParams,
        run_dir: Optional[str] = None,
        test_hook: Optional[Callable] = None,
        state_set: Optional[torch.Tensor] = None,
        mesh=None,
    ):
        """``env`` is one env or a list of envs, one per game type, which
        must share observation and action shapes (one network serves every
        type).  ``test_hook(state, step) -> dict`` replaces the in-loop
        tests: called every ``policy_test_frequency`` steps, its metrics go
        into the step's record.  ``state_set`` holds probe observations
        ``[N, *observation_shape]`` whose values are journaled every
        ``plot_frequency`` steps.  ``mesh`` (``parallel.make_mesh``) makes
        the run data-parallel over its ranks (see the module); the envs and
        the network lie on the mesh's device."""
        envs = list(env) if isinstance(env, (list, tuple)) else [env]
        base = envs[0]
        for e in envs[1:]:
            if (tuple(e.observation_shape) != tuple(base.observation_shape)
                    or e.num_actions != base.num_actions):
                raise ValueError("all game types must share observation and action shapes "
                                 "(one network serves every type)")
        running = train_config.running
        self.mesh = mesh
        if mesh is not None:
            if running.num_actors % mesh.size:
                raise ValueError(f"num_actors={running.num_actors} must divide the mesh size "
                                 f"{mesh.size}")
            if train_config.learning.replay_window_size % mesh.size:
                raise ValueError(
                    f"replay_window_size={train_config.learning.replay_window_size}"
                    f" must divide the mesh size {mesh.size}")
            # Each rank forwards an equal block of every (per-type) batch.
            learning = train_config.learning
            size = (learning.batch_size if learning.learning_method == "samples"
                    else learning.epochs_batch_size)
            subs = sub_batch_sizes(size, len(envs))
            if any(n % mesh.size for n in subs):
                raise ValueError(f"batch size {size} over {len(envs)} game type(s) gives "
                                 f"batches of {subs}; each must divide the mesh size "
                                 f"{mesh.size}")
        if running.running_mode == "sequential" and running.num_games_per_type_per_step < 1:
            raise ValueError(
                "sequential running_mode requires num_games_per_type_per_step >= 1")
        # Several processes (the JAX coordinator's multi-controller run;
        # here every multi-rank mesh): host-side IO on rank 0 only.
        self._multiprocess = mesh is not None and mesh.size > 1
        self._rank0 = mesh is None or mesh.rank == 0
        if self._multiprocess and running.running_mode == "asynchronous":
            # Each rank's loop exits on its own wall clock, while every
            # move-batch's settle is a collective: ranks that launch
            # different numbers of batches deadlock.
            raise ValueError(
                "running_mode 'asynchronous' is single-process only: its "
                "wall-clock loop exit can diverge across hosts while every "
                "self-play step is a cross-process collective. Use "
                "running_mode 'sequential' for multi-host runs.")
        self.envs = envs
        # The env of the in-loop tests and the probes (ref test_game_index).
        self.env = envs[min(train_config.testing.test_game_index, len(envs) - 1)]
        self.device = base.device
        self._world = 1 if mesh is None else mesh.size
        self.manager = manager
        self.cfg = train_config
        self.search_params = search_params
        self.run_dir = run_dir
        self.journal = MetricsJournal(
            os.path.join(run_dir, "journal.jsonl") if run_dir else None, write=self._rank0)
        if train_config.cache.cache_choice not in ("disabled", "none"):
            print("note: Cache.cache_choice is obsolete on this runtime (self-play "
                  "leaf inference is batched on the device); ignoring")

        self.learner = Learner(manager, learner_config_from_training(train_config, len(envs)),
                               mesh=mesh)
        pi = train_config.recurrent.pred_iterations

        def make_net(pred_iters: int):
            def net(variables, obs):
                p, v, _ = manager.apply(variables, obs, iters_to_do=pred_iters)
                return p, v

            return net

        # Early-fill exploration overrides (ref AlphaZero.py:385-387,503-517).
        early_params = dataclasses.replace(
            search_params,
            number_of_softmax_moves=running.early_softmax_moves,
            epsilon_softmax_exploration=running.early_softmax_exploration,
            epsilon_random_exploration=running.early_random_exploration,
        )
        # One self-play step per game type, each at its own pred_iterations.
        self.sp_steps, self.sp_steps_early = [], []
        for t, e in enumerate(envs):
            net_t = make_net(pi[t] if t < len(pi) else pi[0])
            self.sp_steps.append(
                make_selfplay_step(e, net_t, search_params, training=True, game_type=t))
            self.sp_steps_early.append(
                make_selfplay_step(e, net_t, early_params, training=True, game_type=t))
        self._net = make_net(pi[min(train_config.testing.test_game_index, len(pi) - 1)])
        # The buffer stores packed env states; each type's sampler rebuilds
        # observations with its own env (rows are padded to the widest type).
        self._unpackers = []
        for e in envs:
            _, unpack, dim = make_packer(e.init(1, generator=torch.Generator(e.device)))
            self._unpackers.append((unpack, dim))
        self.state_dim = max(dim for _, dim in self._unpackers)
        self.trajectory_length = (
            running.max_trajectory_length or max(e.max_game_length for e in envs))
        # With a mesh, each rank's ring holds its share of the window.
        self.buffer = replay_lib.create_buffer(
            train_config.learning.replay_window_size // self._world, self.trajectory_length,
            self.state_dim, base.num_actions, device=self.device,
        )
        self.state_set = (None if state_set is None else
                          torch.as_tensor(state_set, dtype=torch.float32, device=self.device))
        # The leaves of the weight stats: the network's parameters, as the
        # JAX learner's params (no buffer, such as BatchNorm's statistics).
        self._weight_keys = [name for name, _ in manager.module.named_parameters()]
        self._sp_batches = 0  # move-batches launched this step (throughput)
        # The CUDA graph of each self-play step (card only), and the memory
        # pool they share: they never run at once.
        self._graphs = {}
        self._pool = None

        # In-loop evaluation against RandomAgent, policy and MCTS agents on
        # both seats (ref AlphaZero.run_tests, AlphaZero.py:596-645), at the
        # Testing config's recurrent iteration count.
        self.test_hook = test_hook
        test_iters = train_config.recurrent.test_iterations
        test_mgr = manager
        if train_config.testing.asynchronous_testing:
            # functional_call swaps a module's tensors while it runs, so the
            # worker thread's agents get a module of their own.
            test_mgr = NetworkManager(copy.deepcopy(manager.module), manager.observation_shape)
        self.test_manager = TestManager(self.env)
        self._random_agent = RandomAgent()
        self._policy_agent = PolicyAgent(test_mgr, None, test_iters)
        self._mcts_agent = MctsAgent(test_mgr, None, search_params, test_iters)
        self._goal_rush_agent = (GoalRushAgent() if train_config.testing.goal_rush_opponent
                                 else None)
        # Asynchronous testing: jobs run one at a time on a worker thread (so
        # the shared test agents are never raced), on their own CUDA stream.
        self._test_executor = None
        self._eval_stream = None
        self._pending_tests: list = []
        if train_config.testing.asynchronous_testing:
            self._test_executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="nuzero-eval")
            if self.device.type == "cuda":
                self._eval_stream = torch.cuda.Stream(self.device)

    # -- phases --------------------------------------------------------------

    def _observe(self, states: torch.Tensor, game_type: int = 0) -> torch.Tensor:
        """Observations rebuilt from packed states (``env.observe`` over the
        unpacked batch) by the env of ``game_type``."""
        unpack, dim = self._unpackers[game_type]
        return self.envs[game_type].observe(unpack(states[:, :dim]))

    def _sample_obs(self, rng, batch_size, *, late_heavy, with_replacement, game_type=None):
        """A batch drawn from the buffer (from ``game_type``'s games only,
        where given) with its observations."""
        with span("nuzero.replay.sample"):
            enc, pol, val, gt = replay_lib.sample(
                self.buffer, rng, batch_size, late_heavy=late_heavy,
                with_replacement=with_replacement, game_type=game_type, mesh=self.mesh)
            return self._observe(enc, game_type or 0), pol, val, gt

    def _gather_obs(self, idx, game_type: int = 0):
        with span("nuzero.replay.sample"):
            enc, pol, val, gt = replay_lib.gather(self.buffer, idx, self.mesh)
            return self._observe(enc, game_type), pol, val, gt

    def _mover(self, step_fn, sp, params):
        """A function that plays one move of every game of ``sp`` in place ->
        (FinishedGames, stats, overflow flag): on the card a replay of the
        move's CUDA graph (captured at first use, its parameters loaded from
        ``params``), elsewhere the eager step (whose bounded loops raise at
        once, so its flag stays False)."""
        if self.device.type != "cuda":
            flag = torch.zeros((), dtype=torch.bool, device=self.device)
            return lambda: (*play_in_place(step_fn, params, sp), flag)
        graph = self._graphs.get(step_fn)
        if graph is None or graph.sp is not sp:
            # A capture admits no launch from another thread.
            concurrent.futures.wait([f for _, f in self._pending_tests])
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            with span("nuzero.selfplay.capture"):
                graph = self._graphs[step_fn] = capture_selfplay_step(step_fn, params, sp,
                                                                      self._pool)
        graph.load_params(params)
        return lambda: (*graph.replay(), graph.overflow)

    def _launch(self, move, pending: collections.deque):
        """Play one move-batch, add its finished games to the buffer and
        queue its (finished count, overflow flag) -> the batch's stats."""
        with span("nuzero.selfplay.launch", self._sp_batches):
            with span("nuzero.selfplay.replay"):
                finished, stats, overflow = move()
            self._sp_batches += 1
            with span("nuzero.replay.add_games"):
                self.buffer = replay_lib.add_games(self.buffer, finished)
            pending.append(torch.stack([stats["finished"].to(torch.int64),
                                        overflow.to(torch.int64)]))
            return stats

    def _settle(self, counts) -> int:
        """The finished count of a queued move-batch, over every rank; raises
        where one of its bounded loops overflowed on any rank."""
        with span("nuzero.selfplay.settle"):
            if self.mesh is not None:
                counts = self.mesh.all_reduce(counts)
            n, overflow = counts.tolist()
        if overflow:
            raise OverflowError("self-play: a loop bounded for the move's CUDA graph "
                                "ran past its bound")
        return n

    def _selfplay_until(self, state, sp, step_fn, target_games: int, progress=None):
        """Run lockstep move-batches of ``sp`` (in place) until
        ``target_games`` finish -> (games, stats of the last batch).  The
        finished count and the overflow flag the loop reads lag
        PIPELINE_DEPTH batches behind, so up to that many extra move-batches
        run past the target; their games land in the buffer and in the
        returned total."""
        move = self._mover(step_fn, sp, state.params)
        done = 0
        stats = {}
        pending: collections.deque = collections.deque()

        def settle(counts):
            nonlocal done
            n = self._settle(counts)
            done += n
            if progress is not None and n:
                progress(n)

        while done < target_games:
            stats = self._launch(move, pending)
            if len(pending) > self.PIPELINE_DEPTH:
                settle(pending.popleft())
        for counts in pending:
            settle(counts)
        return done, stats

    def _selfplay_for(self, state, sps, t0: float):
        """The asynchronous running mode's self-play (ref wall-clock-decoupled
        mode, AlphaZero.py:389-404,468-469,1259-1266): rounds of one
        move-batch per game type, always at least one round, until
        ``update_delay`` seconds have passed since ``t0`` -> (games, stats of
        the last batch).  The host reads a batch's count PIPELINE_DEPTH
        batches late, which paces it to the device."""
        movers = [self._mover(self.sp_steps[t], sp, state.params) for t, sp in enumerate(sps)]
        games = 0
        stats = {}
        pending: collections.deque = collections.deque()
        while True:
            for move in movers:
                stats = self._launch(move, pending)
            while len(pending) > self.PIPELINE_DEPTH:
                games += self._settle(pending.popleft())
            if time.time() - t0 >= self.cfg.running.update_delay:
                break
        for counts in pending:
            games += self._settle(counts)
        return games, stats

    def _buffer_counts(self):
        """(games held by each rank's ring, positions held in all, insertions
        into each rank's ring) -> ([int], int, [int]); one all-gather with a
        mesh."""
        b = self.buffer
        row = torch.stack([b.games_added.clamp(max=b.capacity),
                           b.length.sum().to(torch.int64), b.games_added]).reshape(1, 3)
        rows = (row if self.mesh is None else self.mesh.all_gather(row)).tolist()
        return [r[0] for r in rows], sum(r[1] for r in rows), [r[2] for r in rows]

    def _global_means(self, stats: dict) -> dict:
        """A move-batch's float stats averaged over the ranks: every rank
        plays as many games, so the mean of the ranks' means is the mean
        over the global batch, as the JAX coordinator's stats are."""
        keys = [k for k, v in stats.items()
                if isinstance(v, torch.Tensor) and v.dim() == 0 and v.is_floating_point()]
        if not keys:
            return stats
        means = self.mesh.all_reduce(torch.stack([stats[k].float() for k in keys]))
        return {**stats, **dict(zip(keys, (means / self.mesh.size).unbind()))}

    def _update(self, state: TrainState, batches):
        """One SGD update: a single batch for one game type, or one
        sub-batch per type forwarded at its own recurrent iteration count."""
        if len(batches) == 1:
            return self.learner.train_step(state, batches[0], self._host_rng)
        return self.learner.train_step_multi(state, batches, self._host_rng)

    def _train_once(self, state: TrainState):
        cfg = self.cfg.learning
        T = len(self.envs)
        types = [None] if T == 1 else list(range(T))
        metrics = {}
        if cfg.learning_method == "samples":
            for _ in range(cfg.num_samples):
                batches = [
                    self._sample_obs(self._rng, n, late_heavy=cfg.late_heavy,
                                     with_replacement=cfg.with_replacement, game_type=gt)
                    for gt, n in zip(types, sub_batch_sizes(cfg.batch_size, T))]
                state, metrics = self._update(state, batches)
        elif cfg.learning_method == "epochs":
            # Shuffle and sweep (ref AlphaZero.py:686-737): each epoch permutes
            # each type's valid positions once and slices full batches in
            # order; the remainder is dropped.
            sub = sub_batch_sizes(cfg.epochs_batch_size, T)
            n_pos = [replay_lib.num_positions(self.buffer, self.mesh, gt) for gt in types]
            if any(s > n for s, n in zip(sub, n_pos)):
                raise ValueError("Batch size too large; use early_fill to pre-fill "
                                 "the replay buffer (ref AlphaZero.py:690-693)")
            n_batches = min(n // s for s, n in zip(sub, n_pos))
            # No per-epoch loss reaches the journal: the JAX loop writes
            # loss/epoch{e} into the last update's metrics, which the next
            # update replaces, and its record copies only loss/type* keys
            # (nuzero_tpu/training/pipeline.py:499-504,815-817).
            for _ in range(cfg.learning_epochs):
                perms = [replay_lib.epoch_permutation(self.buffer, self._rng, game_type=gt,
                                                      mesh=self.mesh)
                         for gt in types]
                for b in range(n_batches):
                    batches = [self._gather_obs(perm[b * s:(b + 1) * s], t)
                               for t, (perm, s) in enumerate(zip(perms, sub))]
                    state, metrics = self._update(state, batches)
        else:
            raise ValueError(f"bad learning_method {cfg.learning_method!r}")
        return state, metrics

    # -- probes, weight stats, FLOPs, plots -----------------------------------

    @torch.no_grad()
    def probe_values(self, params) -> list:
        """The value head's output on each probe of ``state_set``: one
        batched forward at the probe env's ``pred_iterations``."""
        _, v = self._net(params, self.state_set)
        return v.float().reshape(-1).tolist()

    @torch.no_grad()
    def weight_stats(self, params) -> tuple:
        """(max, min, mean) of |w| over every parameter of the network (ref
        update_weight_data, AlphaZero.py:1164-1173): the mean weights each
        tensor's mean by its size, as the JAX coordinator does."""
        leaves = [params[k].detach().float().abs().reshape(-1) for k in self._weight_keys]
        sizes = torch.tensor([x.numel() for x in leaves], dtype=torch.float32,
                             device=self.device)
        stats = torch.stack([
            torch.stack([x.max() for x in leaves]).max(),
            torch.stack([x.min() for x in leaves]).min(),
            (torch.stack([x.mean() for x in leaves]) * sizes).sum() / sizes.sum(),
        ])
        return tuple(stats.tolist())

    def train_flops(self, params) -> float:
        """3x the FLOPs of one forward (forward and backward of an update)
        at the train batch size per game type, counted once by
        ``FlopCounterMode`` on the ``meta`` device: the plain hex conv's
        shapes, no data, no kernel launched.  A hex conv counts
        2 * M * 7 * Cin * Cout (XLA's cost analysis, which the JAX
        coordinator reads, counts its dual 3x3 conv instead)."""
        cfg = self.cfg.learning
        bs = cfg.batch_size if cfg.learning_method == "samples" else cfg.epochs_batch_size
        meta = {k: torch.empty_like(v, device="meta") for k, v in params.items()}
        obs = torch.empty((max(bs // len(self.envs), 1),) + tuple(self.env.observation_shape),
                          device="meta")
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            self._net(meta, obs)
        return 3.0 * counter.get_total_flops()

    def render_plots(self) -> list:
        """Render the training plot set from the journal into
        ``run_dir/plots`` (ref plot rendering, ``AlphaZero.py:963-1179``)
        -> the written paths."""
        if self.run_dir is None or not self._rank0:
            return []
        records = self.journal.load()
        if not records:
            return []
        return plot_training_run(
            records, os.path.join(self.run_dir, "plots"),
            recent_steps=self.cfg.plotting.recent_steps_loss,
            include_loss=self.cfg.plotting.plot_loss,
        )

    # -- in-loop evaluation ----------------------------------------------------

    def _inloop_test_job(self, params, step: int) -> dict:
        """One eval batch: the policy and MCTS agents against RandomAgent on
        both seats (ref AlphaZero.py:596-645), and against GoalRushAgent
        under ``goal_rush_opponent``.  Seeds come from the step, as in the
        JAX pipeline."""
        cfg = self.cfg.testing
        out = {}

        def run(agent, n_games, tag, seed, opponent=None, suffix=""):
            opponent = opponent or self._random_agent
            agent.set_network(params)
            gen = self.test_manager.generator
            s_p0 = self.test_manager.run_test_batch(n_games, agent, opponent, gen(seed),
                                                    show_results=False)
            s_p1 = self.test_manager.run_test_batch(n_games, opponent, agent, gen(seed + 1),
                                                    show_results=False)
            out[f"wr/{tag}{suffix}_as_p0"] = s_p0.p0_win_rate
            out[f"wr/{tag}{suffix}_as_p1"] = s_p1.p1_win_rate
            out[f"nonloss/{tag}{suffix}_as_p0"] = 1.0 - s_p0.p1_win_rate
            out[f"nonloss/{tag}{suffix}_as_p1"] = 1.0 - s_p1.p0_win_rate

        gr = self._goal_rush_agent
        if cfg.policy_test_frequency and step % cfg.policy_test_frequency == 0:
            run(self._policy_agent, cfg.num_policy_test_games, "policy", 2 * step)
            if gr is not None:
                run(self._policy_agent, cfg.num_policy_test_games, "policy",
                    2 * step + 10_000_001, opponent=gr, suffix="_vs_gr")
        if cfg.mcts_test_frequency and step % cfg.mcts_test_frequency == 0:
            run(self._mcts_agent, cfg.num_mcts_test_games, "mcts", 2 * step + 1)
            if gr is not None:
                run(self._mcts_agent, cfg.num_mcts_test_games, "mcts",
                    2 * step + 10_000_002, opponent=gr, suffix="_vs_gr")
        return out

    def _tests_due(self, step: int) -> bool:
        cfg = self.cfg.testing
        return bool(
            (cfg.policy_test_frequency and step % cfg.policy_test_frequency == 0)
            or (cfg.mcts_test_frequency and step % cfg.mcts_test_frequency == 0))

    def _async_test_job(self, params, ready, step: int) -> dict:
        """``_inloop_test_job`` on the worker thread: on the card on the
        eval stream, after the event ``ready`` that follows the copy of the
        parameters."""
        if self._eval_stream is None:
            return self._inloop_test_job(params, step)
        with torch.cuda.device(self.device), torch.cuda.stream(self._eval_stream):
            self._eval_stream.wait_event(ready)
            return self._inloop_test_job(params, step)

    def _run_inloop_tests(self, state: TrainState, step: int) -> dict:
        if not self._tests_due(step):
            return {}
        if self._test_executor is None:
            return self._inloop_test_job(state.params, step)
        # The job gets its own copy of the parameters, made on this stream
        # before the learner's next update; the eval stream waits for it,
        # and the copies' memory is not reused until the eval stream is done.
        params = {k: v.detach().clone() for k, v in state.params.items()}
        ready = None
        if self._eval_stream is not None:
            ready = torch.cuda.Event()
            ready.record()
            for v in params.values():
                v.record_stream(self._eval_stream)
        self._pending_tests.append(
            (step, self._test_executor.submit(self._async_test_job, params, ready, step)))
        return {}

    def _harvest_async_tests(self, block: bool = False) -> None:
        """Journal finished async eval batches under their launch step (ref
        ``check_pending_tests``, ``AlphaZero.py:1268-1280``; records carry
        their step, so append order does not matter)."""
        remaining = []
        for step, fut in self._pending_tests:
            if block or fut.done():
                res = fut.result()
                if res:
                    self.journal.append({"step": step, "async_test": True, **res})
            else:
                remaining.append((step, fut))
        self._pending_tests = remaining

    # -- main loop -----------------------------------------------------------

    def run(self, seed: int = 0, initial_state: Optional[TrainState] = None,
            starting_step: int = 0) -> TrainState:
        cfg = self.cfg
        dev = self.device
        T = len(self.envs)
        self._rng = torch.Generator(device=dev).manual_seed(seed)  # replay draws
        self._host_rng = torch.Generator().manual_seed(seed)  # progressive (n, k)
        init_rng = torch.Generator(device=dev).manual_seed(seed + 1)
        state = initial_state or self.learner.init_state(init_rng)
        # Rank r plays num_actors / N games from a generator of its own;
        # rank 0 keeps the seeds of a run without a mesh.
        rank = 0 if self.mesh is None else self.mesh.rank
        sps = [
            init_selfplay(e, cfg.running.num_actors // self._world,
                          torch.Generator(device=dev).manual_seed(seed + 2 + t + T * rank),
                          self.trajectory_length, search_params=self.search_params,
                          state_dim=self.state_dim)
            for t, e in enumerate(self.envs)
        ]
        if self.mesh is not None:
            # Rank 0's parameters and optimizer state on every rank.
            state = dataclasses.replace(
                state, params=place_replicated(state.params, self.mesh),
                opt_state=place_replicated(state.opt_state, self.mesh))

        if cfg.running.early_fill_per_type > 0 and starting_step == 0:
            t0 = time.time()
            bar = (PrintBar("early fill", T * cfg.running.early_fill_per_type)
                   if self._rank0 else None)
            total = 0
            for t in range(T):
                n, _ = self._selfplay_until(
                    state, sps[t], self.sp_steps_early[t], cfg.running.early_fill_per_type,
                    progress=bar.next if bar else None)
                total += n
            n_pos = replay_lib.num_positions(self.buffer, self.mesh)
            if bar:
                bar.finish()
                print(f"early fill: {total} games in {time.time() - t0:.1f}s "
                      f"({n_pos} positions)")

        if (cfg.testing.early_testing and starting_step == 0 and self.test_hook is None
                and self._rank0):
            # Baseline eval before any update (ref early_testing).
            res = self._run_inloop_tests(state, 0)
            if res:
                self.journal.append({"step": 0, **res})

        sequential = cfg.running.running_mode == "sequential"
        timers = PhaseTimers(dev)
        train_flops = None
        if os.environ.get("NUZERO_MFU") and not self._multiprocess:
            try:
                train_flops = self.train_flops(state.params)
            except Exception as exc:  # as in the JAX coordinator: MFU is optional
                warnings.warn(f"NUZERO_MFU: the FLOP count failed ({exc!r}); "
                              "train_flops_per_s is not journaled", stacklevel=2)
        trace_dir = os.environ.get("NUZERO_TRACE_DIR") if self._rank0 else None
        trace_at = starting_step + 2
        for step in range(starting_step + 1, cfg.running.training_steps + 1):
            t0 = time.time()
            self._sp_batches = 0
            tracer = self._start_trace() if trace_dir and step == trace_at else None
            per_type_stats = {}
            with timers.phase("selfplay"):
                if sequential:
                    games = 0
                    for t in range(T):
                        g, sp_stats = self._selfplay_until(
                            state, sps[t], self.sp_steps[t],
                            cfg.running.num_games_per_type_per_step)
                        games += g
                        per_type_stats[t] = (g, sp_stats)
                else:
                    games, sp_stats = self._selfplay_for(state, sps, t0)
            updates_before = state.step
            with timers.phase("train"):
                state, tr_metrics = self._train_once(state)

            buffer_games, buffer_positions, buffer_seq = self._buffer_counts()
            if self.mesh is not None:
                sp_stats = self._global_means(sp_stats)
                per_type_stats = {t: (g, self._global_means(st))
                                  for t, (g, st) in per_type_stats.items()}
            record = {
                "step": step,
                "games": games,
                "buffer_games": sum(buffer_games),
                "buffer_positions": buffer_positions,
                # Insertion count at this step (the step_to_size_map equivalent
                # for partial buffer loads, ref ReplayBuffer.py:64-104).
                "buffer_seq": sum(buffer_seq),
                "updates": state.step,
                "loss/combined": float(tr_metrics.get("loss/combined", np.nan)),
                "loss/policy": float(tr_metrics.get("loss/policy", np.nan)),
                "loss/value": float(tr_metrics.get("loss/value", np.nan)),
                "selfplay/root_value": float(sp_stats.get("root_value_mean", np.nan)),
                "selfplay/tree_full_frac": float(sp_stats.get("tree_full_frac", 0.0)),
                "selfplay/children_per_node": float(
                    sp_stats.get("children_per_node_mean", np.nan)),
                "step_time_s": time.time() - t0,
            }
            sp_time = timers._last.get("selfplay", 0.0)
            if self._sp_batches and sp_time > 0:
                record["selfplay/env_steps_per_s"] = round(
                    self._sp_batches * cfg.running.num_actors
                    * self.search_params.num_simulations / sp_time)
            if self._multiprocess:
                # Each rank's insertion count: its ring's truncation point
                # for load_buffer_at_step.
                record["buffer_seq_per_rank"] = buffer_seq
            for k, v in tr_metrics.items():
                if k.startswith("loss/type"):
                    record[k] = float(v)
            if T > 1:
                # Per-type self-play stats (ref Training/Gamer.py:42-92).
                for t, (g, st) in per_type_stats.items():
                    record[f"selfplay/type{t}/games"] = g
                    for key_in, key_out in (("root_value_mean", "root_value"),
                                            ("tree_nodes_mean", "tree_nodes"),
                                            ("children_per_node_mean", "children_per_node"),
                                            ("exploration_bias_mean", "exploration_bias")):
                        if key_in in st:
                            record[f"selfplay/type{t}/{key_out}"] = float(st[key_in])

            with timers.phase("eval"):
                if self.test_hook is not None:
                    freq = cfg.testing.policy_test_frequency
                    if self._rank0 and freq and step % freq == 0:
                        record.update(self.test_hook(state, step) or {})
                elif self._rank0:
                    record.update(self._run_inloop_tests(state, step))
                self._harvest_async_tests()

            if step % cfg.plotting.plot_frequency == 0 and self._rank0:
                if self.state_set is not None:
                    record.update({f"value_probe/{i}": v
                                   for i, v in enumerate(self.probe_values(state.params))})
                if cfg.plotting.plot_weights:
                    w_max, w_min, w_mean = self.weight_stats(state.params)
                    record.update({"weights/abs_max": w_max, "weights/abs_min": w_min,
                                   "weights/abs_mean": w_mean})
            if train_flops:
                # Model FLOP/s over this step's updates (forward and backward
                # at the train batch size; self-play excluded).
                record["train_flops_per_s"] = round(
                    train_flops * max(state.step - updates_before, 0)
                    / max(time.time() - t0, 1e-9))
            record.update(timers.metrics())
            self.journal.append(record)
            if tracer is not None:
                self._stop_trace(tracer, trace_dir, step)

            if self.run_dir and step % cfg.saving.save_frequency == 0:
                with timers.phase("checkpoint"):
                    tree = {"params": state.params, "opt_state": state.opt_state,
                            "step": state.step}
                    ring = replay_lib.to_tree(self.buffer) if cfg.saving.save_buffer else None
                    if self._multiprocess:
                        save_checkpoint(os.path.join(self.run_dir, "checkpoints"), step, tree,
                                        mesh=self.mesh, ring=ring)
                    else:
                        if ring is not None:
                            tree["buffer"] = ring
                        save_checkpoint(os.path.join(self.run_dir, "checkpoints"), step, tree)
                # The plots ride the checkpoint cadence, off the hot loop.
                self.render_plots()
        self._harvest_async_tests(block=True)
        if self.run_dir:
            self.render_plots()
        return state

    def _start_trace(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        # Recording shapes also puts each span's tag into its event.
        tracer = torch.profiler.profile(activities=activities, record_shapes=True)
        tracer.start()
        return tracer

    @staticmethod
    def _stop_trace(tracer, trace_dir: str, step: int) -> None:
        tracer.stop()
        os.makedirs(trace_dir, exist_ok=True)
        tracer.export_chrome_trace(os.path.join(trace_dir, f"step_{step:08d}.trace.json"))

    # -- resume --------------------------------------------------------------

    def _restore(self, step, with_buffer: bool):
        """The checkpoint tree at ``step`` ('auto' = latest), its shapes held
        to this coordinator's (the buffer's only ``with_buffer``) ->
        (tree, step).  Across processes the buffer is this rank's ring, read
        from its own file; a checkpoint that holds no buffer has none."""
        root = os.path.join(self.run_dir, "checkpoints")
        template = self.learner.init_state(torch.Generator(device=self.device).manual_seed(0))
        target = {"params": template.params, "opt_state": template.opt_state, "step": 0}
        ring = replay_lib.to_tree(self.buffer)
        if with_buffer and not self._multiprocess:
            target["buffer"] = ring
        tree, step = restore_checkpoint(root, step, target, device=self.device)
        if self._multiprocess:
            tree.pop("buffer", None)  # a one-process run's whole buffer
            saved = tree.get("world_size", 1)
            if with_buffer and saved != self.mesh.size:
                raise ValueError(f"the checkpoint of step {step} was written by {saved} "
                                 f"rank(s); its replay buffer resumes at that world size "
                                 f"only, not at {self.mesh.size}")
            if with_buffer:
                tree["buffer"] = restore_ring(root, step, self.mesh, ring, device=self.device)
        return tree, step

    def load_buffer_at_step(self, step: int) -> bool:
        """Restore the replay buffer to its state at training step ``step``
        from the NEWEST buffer-bearing checkpoint, dropping games inserted
        after that step (ref ``ReplayBuffer.py:80-104`` partial load by
        ``step_to_size_map``; the insertion count per step lives in the
        journal's ``buffer_seq``).  Returns True on success: False where
        there is no checkpoint, no journal record of ``step``, or no buffer
        of this shape in the newest checkpoint."""
        assert self.run_dir is not None
        newest = latest_step(os.path.join(self.run_dir, "checkpoints"))
        if newest is None:
            return False
        key = "buffer_seq_per_rank" if self._multiprocess else "buffer_seq"
        seq_at_step = next((r[key] for r in self.journal.load()
                            if r.get("step") == step and key in r), None)
        if self._multiprocess and seq_at_step is not None:
            seq_at_step = seq_at_step[self.mesh.rank]
        if seq_at_step is None:
            return False
        try:
            tree, _ = self._restore(newest, with_buffer=True)
        except (ValueError, FileNotFoundError):  # no buffer of this shape and world size
            return False
        if tree.get("buffer") is None:
            return False
        self.buffer = replay_lib.truncate_to_seq(replay_lib.ReplayBuffer(**tree["buffer"]),
                                                 seq_at_step)
        return True

    def load(self, step: int | str = "auto") -> tuple[TrainState, int]:
        """Restore params, optimizer state and buffer from this run's
        checkpoints (ref ``AlphaZero.py:110-146`` + ``ReplayBuffer.py:80-104``)
        -> (state, step).  Where ``load_buffer`` is on and the checkpoint
        holds no buffer, the buffer comes from ``load_buffer_at_step``; where
        that finds none, this warns and the run goes on with the empty
        buffer (the JAX coordinator reaches the same state and says
        nothing)."""
        assert self.run_dir is not None
        ckpt = self.cfg.checkpoint
        # The buffer is restored, and its shapes checked, only when it is
        # both saved and asked for (nuzero_tpu/training/pipeline.py:974-975):
        # a resume without it may change the window, the trajectory length
        # or the action count.
        with_buffer = self.cfg.saving.save_buffer and ckpt.load_buffer
        tree, step = self._restore(step, with_buffer)
        if with_buffer and "buffer" in tree:
            self.buffer = replay_lib.ReplayBuffer(**tree["buffer"])
        elif ckpt.load_buffer and not self.load_buffer_at_step(step):
            warnings.warn(
                f"load_buffer: no replay buffer to restore at step {step} (the checkpoint "
                "holds none, and no newer one holds a buffer to truncate to it); going on "
                "with an empty buffer", stacklevel=2)
        opt_state = (tree["opt_state"] if ckpt.keep_optimizer
                     else self.learner.init_opt_state(tree["params"]))
        # keep_scheduler: resume or restart the LR schedule independently of
        # the optimizer moments (ref AlphaZero.py:110-146).
        opt_state = self.learner.set_schedule_count(
            opt_state, tree["step"] if ckpt.keep_scheduler else 0)
        state = TrainState(params=tree["params"], opt_state=opt_state,
                           step=0 if ckpt.fresh_start else tree["step"])
        if ckpt.fresh_start:
            step = 0
        if self._multiprocess:
            self.mesh.barrier()  # every rank has read the journal
        self.journal.truncate_to_step(0 if ckpt.new_plots else step)
        return state, step
