"""The SCS env's step replayed as a CUDA graph (``graphs.ReplayCache``).

On the card, outside a capture, ``SCSGame.step`` replays a graph of its
own eager body, ``_step``.  The card tests (marked ``cuda``; they skip
where there is no card) hold the replay to the eager body bit for bit on
the transfer sweep's far point (15x15 ``solo_scout_5``, 21 turns, victory
points per game) at B=64 and B=1, and check that nothing returned aliases
the graph, that an overflow raises at the next call, that each thread
captures its own graph, the counters and the eviction.  The CPU tests hold
the rule that keeps every other call eager.  This file imports neither JAX
nor the JAX package, so it also runs on a card machine without them:

    python -m pytest tests/test_torch_step_graph.py --noconftest -q
"""

import concurrent.futures
import dataclasses
import os

import pytest
import torch

from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.evaluation.sweeps import size_env
from nuzero_tpu_torch.utils import graphs, profiling

SCENARIO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "scenarios", "solo_scout_5.yml")
CAPTURE, REPLAY = "nuzero.env.step_graph.capture", "nuzero.env.step_graph.replay"


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _fields(state):
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def _counts():
    snap = profiling.snapshot()
    return tuple(snap.get(name, {"calls": 0})["calls"] for name in (CAPTURE, REPLAY))


def _random_legal(env, state, gen):
    """A uniformly drawn legal action per game (action 0 where none is
    legal: a finished game, which ``step`` takes as any other)."""
    legal = env.legal_mask(state)
    u = torch.rand(legal.shape, generator=gen, device=legal.device)
    return torch.where(legal, u, -1.0).argmax(-1).to(torch.int32)


def _assert_equal(got, want, where):
    for name, w in _fields(want).items():
        g = getattr(got, name)
        assert g.dtype == w.dtype and torch.equal(g, w), f"{where}: {name}"


def _trajectory_equals_eager(env, batch, moves, seed):
    gen = torch.Generator(device=env.device).manual_seed(seed)
    state = env.init(batch, generator=gen)
    finished = 0
    for move in range(moves):
        action = _random_legal(env, state, gen)
        want = env._step(state, action)
        got = env.step(state, action)
        _assert_equal(got, want, f"move {move}")
        state = got
        finished = max(finished, int(state.terminal.sum()))
    return finished


# ---------------------------------------------------------------- the card


@pytest.mark.cuda
def test_replay_equals_the_eager_step_at_b64(cuda_card):
    """≥200 random legal moves at B=64 on the arena cell's env, finished
    games stepped on: every field of every step equal bit for bit; one
    capture, the other calls replays."""
    env = size_env(15, device="cuda")
    profiling.reset()
    finished = _trajectory_equals_eager(env, 64, 220, seed=2**31 + 17)
    assert finished > 0, "no game finished: the trajectory never stepped a finished game"
    assert _counts() == (1, 219)


@pytest.mark.cuda
def test_replay_equals_the_eager_step_at_b1(cuda_card):
    env = size_env(15, device="cuda")
    profiling.reset()
    _trajectory_equals_eager(env, 1, 120, seed=5)
    assert _counts() == (1, 119)


@pytest.mark.cuda
def test_outputs_alias_neither_the_graph_nor_the_inputs(cuda_card):
    """A returned state keeps its bits through the next calls, and the
    input state is never written."""
    env = size_env(15, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    state = env.init(64, generator=gen)
    first_in = {k: v.clone() for k, v in _fields(state).items()}
    action = _random_legal(env, state, gen)
    out1 = env.step(state, action)
    kept = {k: v.clone() for k, v in _fields(out1).items()}
    out2 = env.step(out1, _random_legal(env, out1, gen))
    env.step(out2, _random_legal(env, out2, gen))
    for name, v in kept.items():
        assert torch.equal(getattr(out1, name), v), f"returned {name} changed"
    for name, v in first_in.items():
        assert torch.equal(getattr(state, name), v), f"input {name} changed"
    ptrs = {t.data_ptr() for t in _fields(out2).values()}
    assert not ptrs & {t.data_ptr() for t in _fields(out1).values()}
    assert not ptrs & {t.data_ptr() for t in _fields(state).values()}


@pytest.mark.cuda
@pytest.mark.parametrize("raised_by", ["step", "terminal_value"])
def test_an_overflow_raises_at_the_next_call(cuda_card, raised_by):
    """With no pass of the stage machine after its first, the eager body
    raises at once; the graph's call returns, and the env's next ``step``
    or ``terminal_value`` raises the same error."""
    env = size_env(15, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    state = env.init(64, generator=gen)
    passes = env.stage_passes
    for _ in range(50):  # to the first move that needs a second pass
        action = _random_legal(env, state, gen)
        env.stage_passes = 0
        try:
            env._step(state, action)
        except OverflowError as exc:
            assert "stage machine's 0 passes" in str(exc)
            break
        env.stage_passes = passes
        state = env._step(state, action)
    else:
        pytest.fail("no move of 50 needed a second pass")
    out = env.step(state, action)
    with pytest.raises(OverflowError, match="stage machine's 0 passes ran past its bound"):
        if raised_by == "step":
            env.step(out, action)
        else:
            env.terminal_value(out)


@pytest.mark.cuda
def test_each_thread_replays_its_own_graph(cuda_card):
    """Two threads step the same env at the same B at once, each its own
    trajectory: two captures (one at a time), and both equal the eager
    body.  Neither synchronizes the whole device, which would break the
    other's capture."""
    env = size_env(15, device="cuda")
    profiling.reset()

    def play(seed):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            _trajectory_equals_eager(env, 64, 40, seed)
        stream.synchronize()

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(play, seed) for seed in (21, 22)]:
            fut.result(timeout=300)
    assert _counts() == (2, 78)


@pytest.mark.cuda
def test_a_fifth_batch_size_evicts_the_least_recently_used(cuda_card):
    env = size_env(15, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    states = {b: env.init(b, generator=gen) for b in (1, 2, 3, 4, 5)}

    def step(b):
        action = _random_legal(env, states[b], gen)
        _assert_equal(env.step(states[b], action), env._step(states[b], action), f"B={b}")

    profiling.reset()
    for b in (1, 2, 3, 4, 1):
        step(b)
    assert _counts() == (4, 1)
    step(5)  # evicts B=2, the least recently used
    step(1)
    assert _counts() == (5, 2)
    step(2)
    assert _counts() == (6, 2)
    assert len(env._step_graphs._graphs()) == 4


# ----------------------------------------------------------------- the CPU


def _cpu_env():
    return SCSGame(load_scenario(SCENARIO, seed=42), randomize_vp=True, device="cpu")


def test_a_cpu_env_never_captures():
    env = _cpu_env()
    gen = torch.Generator().manual_seed(1)
    state = env.init(4, generator=gen)
    profiling.reset()
    for move in range(5):
        action = _random_legal(env, state, gen)
        want = env._step(state, action)
        state = env.step(state, action)
        _assert_equal(state, want, f"move {move}")
    env.terminal_value(state)
    assert _counts() == (0, 0)
    assert env._step_graphs._graphs() == {}


def test_inside_a_capture_warm_up_the_step_is_eager(monkeypatch):
    """With the inputs taken for the card's and the capture made to raise,
    ``step`` under an open ``overflow_into`` (the self-play capture's eager
    warm-up, whose steps the move's graph is about to capture) runs the
    eager body; outside it, it would capture."""
    env = _cpu_env()
    gen = torch.Generator().manual_seed(2)
    state = env.init(4, generator=gen)
    action = _random_legal(env, state, gen)

    def refuse(*args):
        raise AssertionError("captured")

    monkeypatch.setattr(graphs, "_on_card", lambda inputs: True)
    monkeypatch.setattr(graphs.ReplayCache, "_capture", staticmethod(refuse))
    with pytest.raises(AssertionError, match="captured"):
        env.step(state, action)
    with graphs.overflow_into(torch.zeros((), dtype=torch.bool)):
        got = env.step(state, action)
    _assert_equal(got, env._step(state, action), "under overflow_into")


def test_a_replayed_overflow_raises_once_at_the_next_call():
    """A replay whose flag came back set (stood in for here: a graph record
    with its host flag set) raises the bound's ``OverflowError`` at the
    env's next ``terminal_value``, once; its wait is the replay's event."""
    env = _cpu_env()
    state = env.init(2, generator=torch.Generator().manual_seed(4))
    waited = []

    class Done:
        def synchronize(self):
            waited.append(1)

    g = graphs._Replayed()
    g.host_flag, g.done, g.pending = torch.tensor(True), Done(), True
    g.whats = ["the SCS stage machine's 43 passes"]
    env._step_graphs._graphs()["key"] = g
    with pytest.raises(OverflowError,
                       match="the SCS stage machine's 43 passes ran past its bound"):
        env.terminal_value(state)
    assert waited == [1]
    env.terminal_value(state)
    assert waited == [1]


def test_counts_add_calls_and_no_time():
    """A count inside a span adds a call and no time, and takes nothing
    from the span's self time; under a profiler it is left out, as a span
    is."""
    profiling.reset()
    with profiling.span("outer"):
        for _ in range(3):
            profiling.count("inner")
    snap = profiling.snapshot()
    assert snap["inner"] == {"calls": 3, "total_s": 0.0, "self_s": 0.0}
    assert snap["outer"]["self_s"] == snap["outer"]["total_s"] > 0
    with torch.profiler.profile():
        profiling.count("inner")
    assert profiling.snapshot()["inner"]["calls"] == 3


def test_overflow_into_names_the_bounds_it_collects():
    """``overflow_into`` yields the bounds recorded into its flag: the
    message a graph's overflow raises."""
    flag = torch.zeros((), dtype=torch.bool)
    with graphs.overflow_into(flag) as whats:
        graphs.overflowed(torch.tensor(False), "a loop's 3 trips")
        graphs.overflowed(torch.tensor(True), "another loop's 2 trips")
    assert whats == ["a loop's 3 trips", "another loop's 2 trips"]
    assert bool(flag)
