"""The port's spans (``nuzero_tpu_torch/utils/profiling.py``): their sums
on nested spans and across threads, their events under ``torch.profiler``,
the spans that self-play and the arena open, and the benchmark's readers
of them (``cardbench/metrics/``, the ``program_span`` metrics of
``BENCHMARK.json``).  CPU only, a few seconds."""

import ast
import collections
import importlib.util
import json
import math
import os
import re
import threading
import time

import pytest
import torch

from nuzero_tpu_torch.config import schemas
from nuzero_tpu_torch.envs.tictactoe import TicTacToe
from nuzero_tpu_torch.evaluation.agents import RandomAgent
from nuzero_tpu_torch.evaluation.manager import TestManager
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.mlp import MLPNetwork
from nuzero_tpu_torch.search.mcts import SearchParams
from nuzero_tpu_torch.training import pipeline
from nuzero_tpu_torch.training.selfplay import init_selfplay, play_in_place
from nuzero_tpu_torch.utils import profiling
from nuzero_tpu_torch.utils.profiling import span

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "nuzero_tpu_torch")


@pytest.fixture(autouse=True)
def _fresh_sums():
    profiling.reset()
    yield
    profiling.reset()


def _busy(seconds):
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def test_nested_spans_sum_calls_total_and_self_time():
    for _ in range(2):
        with span("outer") as outer:
            _busy(0.002)
            with span("inner", tag=1) as inner:
                _busy(0.003)
            with span("inner"):
                _busy(0.001)
    got = profiling.snapshot()
    assert got.keys() == {"outer", "inner"}
    assert got["outer"]["calls"] == 2 and got["inner"]["calls"] == 4
    assert got["inner"]["self_s"] == got["inner"]["total_s"] >= 0.008
    assert math.isclose(got["outer"]["self_s"],
                        got["outer"]["total_s"] - got["inner"]["total_s"], abs_tol=1e-9)
    assert 0.004 <= got["outer"]["self_s"] < got["outer"]["total_s"]
    assert inner.seconds >= 0.003 and outer.seconds >= inner.seconds + 0.003


def test_spans_on_two_threads_at_once_keep_their_own_nesting():
    """Each thread's children subtract from its own parent only, and no
    thread's update is lost."""
    n = 2000
    start = threading.Barrier(2)

    def work():
        start.wait()
        for _ in range(n):
            with span("t.outer"):
                with span("t.inner"):
                    pass

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    got = profiling.snapshot()
    assert got["t.outer"]["calls"] == got["t.inner"]["calls"] == 2 * n
    assert math.isclose(got["t.outer"]["self_s"],
                        got["t.outer"]["total_s"] - got["t.inner"]["total_s"], abs_tol=1e-9)


@pytest.mark.parametrize("record_shapes", [False, True])
def test_spans_are_profiler_events_nested_as_opened(record_shapes, tmp_path):
    """Each span is a host operation of its name in the trace, nested as
    opened, its tag the event's argument where shapes are recorded; none is
    a user annotation, which the profiler would copy onto the card's
    timeline as device work."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=record_shapes) as prof:
        with span("nuzero.test.outer", tag=7):
            with span("nuzero.test.inner"):
                torch.ones(4).sum()
    events = {e.name: e for e in prof.events() if e.name.startswith("nuzero.test.")}
    assert events.keys() == {"nuzero.test.outer", "nuzero.test.inner"}
    outer, inner = events["nuzero.test.outer"], events["nuzero.test.inner"]
    assert inner.cpu_parent is not None and inner.cpu_parent.name == outer.name
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert not any(e.is_user_annotation() for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("nuzero."))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        traced = [e for e in json.load(f)["traceEvents"]
                  if e.get("name", "").startswith("nuzero.test.")]
    assert {e["cat"] for e in traced} == {"cpu_op"}
    if record_shapes:
        assert [e["args"].get("tag") for e in traced if e["name"] == "nuzero.test.outer"] == [7]
    # The profiler slows what it records: its spans stay out of the sums.
    assert profiling.snapshot() == {}
    with span("nuzero.test.outer"):
        pass
    assert profiling.snapshot()["nuzero.test.outer"]["calls"] == 1


def test_a_torch_without_the_trace_event_still_times_its_spans(monkeypatch):
    """Where the private ``_RecordFunctionFast`` is missing, a span under a
    profiler makes no event and raises nothing; its duration is still read."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(profiling, "_trace_event", None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("nuzero.test.plain", tag=3) as s:
            _busy(0.001)
    assert s.seconds >= 0.001
    assert not any(e.name.startswith("nuzero.") for e in prof.events())
    assert profiling.snapshot() == {}


def test_no_profiler_enters_no_trace_event(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a trace event entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_trace_event", refuse)
    with span("nuzero.test.quiet", tag=1):
        pass
    assert profiling.snapshot()["nuzero.test.quiet"]["calls"] == 1


def test_phase_timers_time_a_phase_by_its_span():
    timers = profiling.PhaseTimers("cpu")
    with timers.phase("selfplay"):
        _busy(0.002)
    got = profiling.snapshot()["nuzero.phase.selfplay"]
    assert got["calls"] == 1 and timers.metrics()["time/selfplay"] == round(got["total_s"], 6)


# -- the program's spans ------------------------------------------------------

def _coordinator():
    env = TicTacToe(device="cpu")
    torch.manual_seed(0)
    mgr = NetworkManager(MLPNetwork(env.observation_shape, 9, hidden_layers=1,
                                    neurons_per_layer=64), env.observation_shape)
    cfg = schemas.TrainingConfig(
        running=schemas.RunningConfig(num_actors=4, training_steps=1,
                                      num_games_per_type_per_step=2, early_fill_per_type=0),
        testing=schemas.TestingFrequencyConfig(policy_test_frequency=0, mcts_test_frequency=0),
        learning=schemas.LearningConfig(replay_window_size=16, batch_size=8, num_samples=1))
    az = pipeline.AlphaZero(env, mgr, cfg, SearchParams(num_simulations=2), run_dir=None)
    state = az.learner.init_state(torch.Generator().manual_seed(1))
    sp = init_selfplay(env, 4, torch.Generator().manual_seed(2), az.trajectory_length,
                       search_params=az.search_params, state_dim=az.state_dim)
    return az, state, sp


def _selfplay_and_arena():
    """A few self-play move-batches and one arena batch -> (move-batches
    played, env steps of the arena)."""
    az, state, sp = _coordinator()
    az._selfplay_until(state, sp, az.sp_steps[0], 2)
    env = TicTacToe(device="cpu")
    steps = collections.Counter()
    inner = env.step

    def counted(states, action):
        steps["env"] += 1
        return inner(states, action)

    env.step = counted
    tm = TestManager(env)
    tm.run_test_batch(6, RandomAgent(), RandomAgent(), tm.generator(3), show_results=False)
    assert len(tm.last_arena.seconds_per_move) == steps["env"]
    return az._sp_batches, steps["env"]


def test_selfplay_and_the_arena_open_their_spans():
    batches, env_steps = _selfplay_and_arena()
    got = profiling.snapshot()
    assert batches > 0
    for name in ("nuzero.selfplay.launch", "nuzero.selfplay.replay",
                 "nuzero.replay.add_games", "nuzero.selfplay.settle"):
        assert got[name]["calls"] == batches, name
    launch = got["nuzero.selfplay.launch"]
    children = sum(got[n]["total_s"] for n in ("nuzero.selfplay.replay",
                                                "nuzero.replay.add_games"))
    assert math.isclose(launch["self_s"], launch["total_s"] - children, abs_tol=1e-9)
    assert got["nuzero.arena.move"]["calls"] == got["nuzero.arena.env"]["calls"] == env_steps
    # One read opens the match; each move ends with the read for the next.
    assert got["nuzero.arena.read"]["calls"] == env_steps + 1
    assert got["nuzero.arena.policy"]["calls"] >= env_steps
    assert "nuzero.selfplay.capture" not in got  # the CPU plays the eager step


def test_an_update_opens_the_learner_spans():
    az, state, sp = _coordinator()
    az._selfplay_until(state, sp, az.sp_steps[0], 4)
    az._rng, az._host_rng = torch.Generator().manual_seed(4), torch.Generator().manual_seed(5)
    az._train_once(state)
    got = profiling.snapshot()
    for name in ("nuzero.replay.sample", "nuzero.learner.update", "nuzero.learner.forward",
                 "nuzero.learner.backward", "nuzero.learner.optimizer"):
        assert got[name]["calls"] == 1, name
    update = got["nuzero.learner.update"]
    assert update["self_s"] < update["total_s"]


@pytest.mark.parametrize("batch_norm", [True, False], ids=["tower", "recurrent"])
def test_the_norm_stats_span_counts_updates_of_a_batch_norm_net(batch_norm):
    """``nuzero.learner.norm_stats`` opens once per update of a net with
    BatchNorm, around its running statistics' move, and never for the
    recurrent net, which has none."""
    from nuzero_tpu_torch.networks.recurrent import RecurrentNet
    from nuzero_tpu_torch.networks.resnet import ResNet
    from nuzero_tpu_torch.training.learner import Learner, LearnerConfig

    shape = (3, 3, 3)
    net = (ResNet(3, 1, num_filters=4, num_blocks=1, batch_norm=True, hex=False) if batch_norm
           else RecurrentNet(3, 1, num_filters=4, hex=False))
    learner = Learner(NetworkManager(net, shape), LearnerConfig(train_iterations=1))
    state = learner.init_state(torch.Generator().manual_seed(0))
    batch = (torch.randn((4,) + shape), torch.full((4, 9), 1 / 9), torch.zeros(4),
             torch.zeros(4, dtype=torch.int32))
    for _ in range(3):
        state, _ = learner.train_step(state, batch)
    got = profiling.snapshot()
    assert got["nuzero.learner.update"]["calls"] == 3
    assert got.get("nuzero.learner.norm_stats", {}).get("calls", 0) == (3 if batch_norm else 0)


# -- the benchmark's readers --------------------------------------------------

def _span_readers():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    names = [m["name"] for m in spec["per_layer"] if m["source"] == "program_span"]
    assert names
    return [(n, os.path.join(REPO, "cardbench", "metrics", n + ".py")) for n in names]


def _load(name, path):
    spec = importlib.util.spec_from_file_location("tracing_reader_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Graph:
    """A stand-in for the move's CUDA graph: its replay plays the eager move."""

    def __init__(self, step_fn, params, sp, pool):
        self.step_fn, self.params, self.sp = step_fn, params, sp
        self.overflow = torch.zeros((), dtype=torch.bool)

    def load_params(self, params):
        self.params = params

    def replay(self):
        return play_in_place(self.step_fn, self.params, self.sp)


def test_every_reader_reads_the_spans(monkeypatch):
    """After self-play through the graph path (a stand-in capture) and an
    arena batch, each reader returns a finite value; with no spans, none."""
    readers = [(n, _load(n, p)) for n, p in _span_readers()]
    assert all(mod.read({}) is None for _, mod in readers)
    monkeypatch.setattr(pipeline, "capture_selfplay_step", _Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    real = pipeline.AlphaZero.__init__

    def on_the_card(self, *args, **kwargs):
        real(self, *args, **kwargs)
        self.device = torch.device("cuda")  # only _mover reads it here

    monkeypatch.setattr(pipeline.AlphaZero, "__init__", on_the_card)
    _selfplay_and_arena()
    assert profiling.snapshot()["nuzero.selfplay.capture"]["calls"] == 1
    for name, mod in readers:
        value = mod.read({})
        assert value is not None and math.isfinite(value) and value > 0, name


def test_every_span_a_reader_names_is_opened_in_the_port():
    opened = set()
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as src:
                    opened |= set(re.findall(r'span\("(nuzero\.[a-z_.]+)"', src.read()))
    for name, path in _span_readers():
        with open(path) as f:
            tree = ast.parse(f.read())
        asked = {n.value for n in ast.walk(tree)
                 if isinstance(n, ast.Constant) and isinstance(n.value, str)
                 and n.value.startswith("nuzero.")}
        assert asked and asked <= opened, (name, asked - opened)
