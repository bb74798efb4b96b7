"""AlphaZero coordinator: self-play -> replay -> SGD (counterpart of
``nuzero_tpu/training/pipeline.py``; behavioral target the reference's
``Training/AlphaZero.py`` ``run()``).

The sequential running mode: an early buffer fill with softened
exploration, then per training step self-play until the step's games
finish, the learner's updates (the samples or the epochs method), a
journal record and, every ``save_frequency`` steps, a checkpoint.  Self-
play, replay and SGD all work on tensors on the env's device; the host
loop sequences them and does the IO.  On the card each self-play move is
a replay of a CUDA graph of the move (``selfplay.capture_selfplay_step``,
captured at first use), which reads nothing on the host; the loop reads a
move-batch's finished count and overflow flag ``PIPELINE_DEPTH`` batches
later.

In-loop evaluation (``Testing``): every ``policy_test_frequency`` /
``mcts_test_frequency`` steps, and at step 0 under ``early_testing``, the
policy and MCTS agents play the random agent (and the GoalRush agent under
``goal_rush_opponent``) from both seats; the win and non-loss rates are
journaled under the JAX pipeline's keys.  With ``asynchronous_testing``
a job runs on a worker thread and its own CUDA stream, on a copy of the
parameters, and is journaled under its launch step when it is harvested;
pending jobs are joined before a CUDA graph is captured, since a capture
admits no other thread's launches.

Not ported yet, and refused with ``NotImplementedError`` naming the
option: the asynchronous running mode, state-set value probes, loss and
weight plots, more than one game type, a mesh, ``NUZERO_MFU`` and
``NUZERO_TRACE_DIR``, and the partial buffer load by step on resume.
"""

from __future__ import annotations

import collections
import concurrent.futures
import copy
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

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
from nuzero_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from nuzero_tpu_torch.utils.metrics import MetricsJournal, PrintBar
from nuzero_tpu_torch.utils.packing import make_packer
from nuzero_tpu_torch.utils.profiling import PhaseTimers


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


def unported_options(cfg: TrainingConfig, envs=1, state_set=None, mesh=None) -> list:
    """The options of this configuration that the port does not run yet."""
    p = cfg.plotting
    named = {
        "running_mode 'asynchronous'": cfg.running.running_mode == "asynchronous",
        "Plotting.plot_loss": p.plot_loss,
        "Plotting.plot_weights": p.plot_weights,
        "state_set (value probes)": state_set is not None,
        "more than one game type": envs > 1,
        "mesh": mesh is not None,
        "NUZERO_MFU": bool(os.environ.get("NUZERO_MFU")),
        "NUZERO_TRACE_DIR": bool(os.environ.get("NUZERO_TRACE_DIR")),
    }
    return [name for name, asked in named.items() if asked]


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
        state_set=None,
        mesh=None,
    ):
        """``test_hook(state, step) -> dict`` replaces the in-loop tests:
        called every ``policy_test_frequency`` steps, its metrics go into
        the step's record."""
        envs = list(env) if isinstance(env, (list, tuple)) else [env]
        missing = unported_options(train_config, len(envs), state_set, mesh)
        if missing:
            raise NotImplementedError(
                "not ported to the PyTorch pipeline yet: " + ", ".join(missing))
        if train_config.running.num_games_per_type_per_step < 1:
            raise ValueError(
                "sequential running_mode requires num_games_per_type_per_step >= 1")
        env = envs[0]
        self.env = env
        self.device = env.device
        self.manager = manager
        self.cfg = train_config
        self.search_params = search_params
        self.run_dir = run_dir
        self.journal = MetricsJournal(
            os.path.join(run_dir, "journal.jsonl") if run_dir else None)
        if train_config.cache.cache_choice not in ("disabled", "none"):
            print("note: Cache.cache_choice is obsolete on this runtime (self-play "
                  "leaf inference is batched on the device); ignoring")

        self.learner = Learner(manager, learner_config_from_training(train_config))
        pred_iters = train_config.recurrent.pred_iterations[0]

        def net(variables, obs):
            p, v, _ = manager.apply(variables, obs, iters_to_do=pred_iters)
            return p, v

        # Early-fill exploration overrides (ref AlphaZero.py:385-387,503-517).
        early_params = dataclasses.replace(
            search_params,
            number_of_softmax_moves=train_config.running.early_softmax_moves,
            epsilon_softmax_exploration=train_config.running.early_softmax_exploration,
            epsilon_random_exploration=train_config.running.early_random_exploration,
        )
        self.sp_step = make_selfplay_step(env, net, search_params, training=True, game_type=0)
        self.sp_step_early = make_selfplay_step(env, net, early_params, training=True,
                                                game_type=0)
        _, self._unpack, self.state_dim = make_packer(
            env.init(1, generator=torch.Generator(env.device)))
        self.trajectory_length = (
            train_config.running.max_trajectory_length or env.max_game_length)
        self.buffer = replay_lib.create_buffer(
            train_config.learning.replay_window_size, self.trajectory_length,
            self.state_dim, env.num_actions, device=self.device,
        )
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
        self.test_manager = TestManager(env)
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

    def _observe(self, states: torch.Tensor) -> torch.Tensor:
        """Observations rebuilt from packed states (``env.observe`` over the
        unpacked batch)."""
        return self.env.observe(self._unpack(states[:, :self.state_dim]))

    def _sample_obs(self, rng, batch_size, *, late_heavy, with_replacement):
        enc, pol, val, gt = replay_lib.sample(
            self.buffer, rng, batch_size, late_heavy=late_heavy,
            with_replacement=with_replacement)
        return self._observe(enc), pol, val, gt

    def _gather_obs(self, idx):
        enc, pol, val, gt = replay_lib.gather(self.buffer, idx)
        return self._observe(enc), pol, val, gt

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
            graph = self._graphs[step_fn] = capture_selfplay_step(step_fn, params, sp,
                                                                  self._pool)
        graph.load_params(params)
        return lambda: (*graph.replay(), graph.overflow)

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
            n, overflow = counts.tolist()
            if overflow:
                raise OverflowError("self-play: a loop bounded for the move's CUDA graph "
                                    "ran past its bound")
            done += n
            if progress is not None and n:
                progress(n)

        while done < target_games:
            finished, stats, overflow = move()
            self._sp_batches += 1
            self.buffer = replay_lib.add_games(self.buffer, finished)
            pending.append(torch.stack([stats["finished"].to(torch.int64),
                                        overflow.to(torch.int64)]))
            if len(pending) > self.PIPELINE_DEPTH:
                settle(pending.popleft())
        for counts in pending:
            settle(counts)
        return done, stats

    def _train_once(self, state: TrainState):
        cfg = self.cfg.learning
        metrics = {}
        if cfg.learning_method == "samples":
            for _ in range(cfg.num_samples):
                batch = self._sample_obs(
                    self._rng, cfg.batch_size, late_heavy=cfg.late_heavy,
                    with_replacement=cfg.with_replacement)
                state, metrics = self.learner.train_step(state, batch, self._host_rng)
        elif cfg.learning_method == "epochs":
            # Shuffle and sweep (ref AlphaZero.py:686-737): each epoch permutes
            # the valid positions once and slices full batches in order; the
            # n_positions % batch_size remainder is dropped.
            bs = cfg.epochs_batch_size
            n_pos = int(self.buffer.num_positions)
            if bs > n_pos:
                raise ValueError("Batch size too large; use early_fill to pre-fill "
                                 "the replay buffer (ref AlphaZero.py:690-693)")
            n_batches = n_pos // bs
            # No per-epoch loss reaches the journal: the JAX loop writes
            # loss/epoch{e} into the last update's metrics, which the next
            # update replaces, and its record copies only loss/type* keys
            # (nuzero_tpu/training/pipeline.py:499-504,815-817).
            for _ in range(cfg.learning_epochs):
                perm = replay_lib.epoch_permutation(self.buffer, self._rng)
                for b in range(n_batches):
                    batch = self._gather_obs(perm[b * bs:(b + 1) * bs])
                    state, metrics = self.learner.train_step(state, batch, self._host_rng)
        else:
            raise ValueError(f"bad learning_method {cfg.learning_method!r}")
        return state, metrics

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
        self._rng = torch.Generator(device=dev).manual_seed(seed)  # replay draws
        self._host_rng = torch.Generator().manual_seed(seed)  # progressive (n, k)
        init_rng = torch.Generator(device=dev).manual_seed(seed + 1)
        state = initial_state or self.learner.init_state(init_rng)
        sp = init_selfplay(
            self.env, cfg.running.num_actors,
            torch.Generator(device=dev).manual_seed(seed + 2),
            self.trajectory_length, search_params=self.search_params,
            state_dim=self.state_dim,
        )

        if cfg.running.early_fill_per_type > 0 and starting_step == 0:
            t0 = time.time()
            bar = PrintBar("early fill", cfg.running.early_fill_per_type)
            total, _ = self._selfplay_until(
                state, sp, self.sp_step_early, cfg.running.early_fill_per_type,
                progress=bar.next)
            bar.finish()
            print(f"early fill: {total} games in {time.time() - t0:.1f}s "
                  f"({int(self.buffer.num_positions)} positions)")

        if cfg.testing.early_testing and starting_step == 0 and self.test_hook is None:
            # Baseline eval before any update (ref early_testing).
            res = self._run_inloop_tests(state, 0)
            if res:
                self.journal.append({"step": 0, **res})

        timers = PhaseTimers(dev)
        for step in range(starting_step + 1, cfg.running.training_steps + 1):
            t0 = time.time()
            self._sp_batches = 0
            with timers.phase("selfplay"):
                games, sp_stats = self._selfplay_until(
                    state, sp, self.sp_step, cfg.running.num_games_per_type_per_step)
            with timers.phase("train"):
                state, tr_metrics = self._train_once(state)

            record = {
                "step": step,
                "games": games,
                "buffer_games": self.buffer.num_games,
                "buffer_positions": int(self.buffer.num_positions),
                # Insertion count at this step (the step_to_size_map equivalent
                # for partial buffer loads, ref ReplayBuffer.py:64-104).
                "buffer_seq": int(self.buffer.games_added),
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
            for k, v in tr_metrics.items():
                if k.startswith("loss/type"):
                    record[k] = float(v)

            with timers.phase("eval"):
                if self.test_hook is not None:
                    freq = cfg.testing.policy_test_frequency
                    if freq and step % freq == 0:
                        record.update(self.test_hook(state, step) or {})
                else:
                    record.update(self._run_inloop_tests(state, step))
                self._harvest_async_tests()
            record.update(timers.metrics())
            self.journal.append(record)

            if self.run_dir and step % cfg.saving.save_frequency == 0:
                with timers.phase("checkpoint"):
                    tree = {"params": state.params, "opt_state": state.opt_state,
                            "step": state.step}
                    if cfg.saving.save_buffer:
                        tree["buffer"] = replay_lib.to_tree(self.buffer)
                    save_checkpoint(os.path.join(self.run_dir, "checkpoints"), step, tree)
        self._harvest_async_tests(block=True)
        return state

    # -- resume --------------------------------------------------------------

    def load(self, step: int | str = "auto") -> tuple[TrainState, int]:
        """Restore params, optimizer state and buffer from this run's
        checkpoints (ref ``AlphaZero.py:110-146`` + ``ReplayBuffer.py:80-104``)
        -> (state, step)."""
        assert self.run_dir is not None
        ckpt = self.cfg.checkpoint
        template = self.learner.init_state(torch.Generator(device=self.device).manual_seed(0))
        target = {"params": template.params, "opt_state": template.opt_state, "step": 0}
        # The buffer is restored, and its shapes checked, only when it is
        # both saved and asked for (nuzero_tpu/training/pipeline.py:974-975):
        # a resume without it may change the window, the trajectory length
        # or the action count.
        with_buffer = self.cfg.saving.save_buffer and ckpt.load_buffer
        if with_buffer:
            target["buffer"] = replay_lib.to_tree(self.buffer)
        tree, step = restore_checkpoint(
            os.path.join(self.run_dir, "checkpoints"), step, target, device=self.device)
        if with_buffer and "buffer" in tree:
            self.buffer = replay_lib.ReplayBuffer(**tree["buffer"])
        elif ckpt.load_buffer:
            raise NotImplementedError(
                "not ported to the PyTorch pipeline yet: load_buffer from a checkpoint "
                "without a buffer (the partial buffer load by step, load_buffer_at_step)")
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
        self.journal.truncate_to_step(0 if ckpt.new_plots else step)
        return state, step
