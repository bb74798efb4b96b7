"""The SCS env's step kernel (``ops/cuda/csrc/scs_step.cu``).

On the card ``SCSGame.step`` launches the kernel; its plain version is the
eager body ``SCSGame._step``.  The card tests (marked ``cuda``; they skip
where there is no card) hold the kernel to ``_step`` bit for bit in every
field, at B = 1, 64, 512 and 1,024, on ``open_field_5`` (stacking 2, combat),
``solo_scout_5`` with victory points drawn per game and the transfer sweep's
15x15, 21-turn solo scout, over random legal play to the end with finished
games stepped again; they check that its outputs alias neither its inputs
nor each other, that an overflow of the stage machine raises once at the
next call (eagerly) and is reported after a replay (under a capture), and
that a captured self-play move, with the kernel in its graph, replays the
eager move bit for bit.  The CPU tests hold the rule that keeps the CPU on
the eager body and the wrapper's checks, and run the kernel's own source on
the CPU (``g++`` with ``tests/cuda_warp_shim.h``, a lane a host thread)
against the eager body.  This file imports neither JAX nor
the JAX package, so it also runs on a card machine without them:

    python -m pytest tests/test_torch_scs_step_kernel.py --noconftest -q
"""

import ctypes
import dataclasses
import os
import re
import shutil
import subprocess

import pytest
import torch

from nuzero_tpu_torch.envs.scs.game import SCSGame, SCSState
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.evaluation.sweeps import size_env
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.recurrent import RecurrentNet
from nuzero_tpu_torch.ops.cuda import build, scs_step_kernel
from nuzero_tpu_torch.search import mcts
from nuzero_tpu_torch.training.selfplay import (
    capture_selfplay_step, init_selfplay, make_selfplay_step, move_tensors, play_in_place,
)
from nuzero_tpu_torch.utils import graphs

TESTS = os.path.dirname(os.path.abspath(__file__))
SCENARIOS = os.path.join(os.path.dirname(TESTS), "configs", "scenarios")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _env(name, device):
    if name == "sweep15":  # the arena cell's env: 15x15 solo scout, 21 turns
        return size_env(15, device=device)
    randomize = name == "solo_scout_5"
    return SCSGame(load_scenario(os.path.join(SCENARIOS, name + ".yml"), seed=42),
                   randomize_vp=randomize, device=device)


def _fields(state):
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def _random_legal(env, state, gen):
    """A uniformly drawn legal action per game (action 0 where none is
    legal: a finished game, which ``step`` takes as any other)."""
    legal = env.legal_mask(state)
    u = torch.rand(legal.shape, generator=gen, device=legal.device)
    return torch.where(legal, u, -1.0).argmax(-1).to(torch.int32)


def _assert_equal(got, want, where):
    for name, w in _fields(want).items():
        g = getattr(got, name)
        assert g.dtype == w.dtype and g.shape == w.shape, f"{where}: {name}"
        if not torch.equal(g, w):
            games = (g != w).reshape(g.shape[0], -1).any(-1).nonzero()[:8, 0].tolist()
            pytest.fail(f"{where}: {name} differs in games {games}")


# ---------------------------------------------------------------- the card


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 64, 512, 1024])
@pytest.mark.parametrize("scenario", ["open_field_5", "solo_scout_5", "sweep15"])
def test_kernel_equals_the_eager_step(cuda_card, scenario, batch):
    """Random legal play until every game has finished, then three more
    steps of the finished games: every field of every step equal to the
    eager body's bit for bit, one launch a step, no overflow."""
    env = _env(scenario, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(2**31 + 7 * batch)
    state = env.init(batch, generator=gen)
    scs_step_kernel.reset_launch_count()
    steps, after = 0, 0
    while after < 3:
        action = _random_legal(env, state, gen)
        want = env._step(state, action)
        got = env.step(state, action)
        _assert_equal(got, want, f"{scenario} B={batch} step {steps}")
        state = got
        steps += 1
        after += bool(state.terminal.all())
        assert steps <= env.max_game_length, "a game outlasted the scenario's bound"
    env.terminal_value(state)  # raises if a step overflowed
    assert scs_step_kernel.launch_count[scs_step_kernel.KERNEL] == steps


@pytest.mark.cuda
def test_the_step_takes_int64_actions_and_games_strided_in_a_packed_row(cuda_card):
    """The search hands the step states unpacked from its tree's rows (the
    f32 fields are views with a batch stride), and a caller may pass int64
    actions: the same bits as contiguous int32 inputs."""
    from nuzero_tpu_torch.utils.packing import make_packer

    env = _env("open_field_5", "cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    pack, unpack, _ = make_packer(env.init(1, generator=gen))
    state = env.init(64, generator=gen)
    for step in range(40):
        action = _random_legal(env, state, gen)
        strided = unpack(pack(state))
        assert not strided.mov.is_contiguous()
        want = env._step(state, action)
        _assert_equal(env.step(strided, action.long()), want, f"step {step}")
        state = want


@pytest.mark.cuda
def test_outputs_alias_neither_the_inputs_nor_each_other(cuda_card):
    env = _env("sweep15", "cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    state = env.init(64, generator=gen)
    before = {k: v.clone() for k, v in _fields(state).items()}
    out = env.step(state, _random_legal(env, state, gen))
    kept = {k: v.clone() for k, v in _fields(out).items()}
    env.step(out, _random_legal(env, out, gen))
    for name, v in before.items():
        assert torch.equal(getattr(state, name), v), f"input {name} changed"
    for name, v in kept.items():
        assert torch.equal(getattr(out, name), v), f"returned {name} changed"
    ptrs = [t.data_ptr() for t in _fields(out).values()]
    assert len(set(ptrs)) == len(ptrs)
    assert not set(ptrs) & {t.data_ptr() for t in _fields(state).values()}


def _state_needing_a_second_pass(env, gen):
    """(state, action) whose step needs a pass of the stage machine after
    its first: the eager body raises with no such pass allowed."""
    state = env.init(64, generator=gen)
    passes = env.stage_passes
    for _ in range(50):
        action = _random_legal(env, state, gen)
        env.stage_passes = 0
        try:
            env._step(state, action)
        except OverflowError as exc:
            assert "stage machine's 0 passes" in str(exc)
            return state, action
        finally:
            env.stage_passes = passes
        state = env._step(state, action)
    pytest.fail("no move of 50 needed a second pass")


@pytest.mark.cuda
@pytest.mark.parametrize("raised_by", ["step", "terminal_value"])
def test_an_overflow_raises_once_at_the_next_call(cuda_card, raised_by):
    """With no pass after the first allowed, the kernel's call returns and
    the env's next ``step`` or ``terminal_value`` raises, once."""
    env = _env("sweep15", "cuda")
    state, action = _state_needing_a_second_pass(env, torch.Generator(device="cuda").manual_seed(3))
    env.stage_passes = 0
    out = env.step(state, action)
    with pytest.raises(OverflowError, match="stage machine's 0 passes ran past its bound"):
        if raised_by == "step":
            env.step(out, action)
        else:
            env.terminal_value(out)
    env.terminal_value(out)  # reported once


@pytest.mark.cuda
def test_an_overflow_under_a_capture_is_reported_after_the_replay(cuda_card):
    """Captured, the kernel's flag goes into the capture's: set after a
    replay of the overflowing step, clear after one of a step that rests in
    time, whose fields equal the eager body's."""
    env = _env("sweep15", "cuda")
    state, action = _state_needing_a_second_pass(env, torch.Generator(device="cuda").manual_seed(3))
    fields = {k: v.clone() for k, v in _fields(state).items()}
    want = env._step(state, action)
    for passes, flagged in ((0, True), (env.stage_passes, False)):
        env.stage_passes = passes
        flag = torch.zeros((), dtype=torch.bool, device="cuda")
        graph = torch.cuda.CUDAGraph()
        with graphs.capture(graph, overflow=flag):
            out = env.step(SCSState(**fields), action)
        graph.replay()
        torch.cuda.synchronize()
        assert bool(flag) is flagged
        if not flagged:
            _assert_equal(out, want, "replayed step")


def _selfplay(seed):
    """A small self-play setup on the card: open_field_5, B=8, an 8-filter
    net, 4 simulations with carried trees, training draws."""
    env = _env("open_field_5", "cuda")
    mgr = NetworkManager(RecurrentNet(env.observation_shape[0], env.action_space_shape[0],
                                      num_filters=8, num_blocks=2, recall=True, hex=True,
                                      dtype=torch.float32).cuda(), env.observation_shape)

    def apply(variables, obs):
        p, v, _ = mgr.apply(variables, obs, iters_to_do=2)
        return p, v

    params = mcts.SearchParams(num_simulations=4)
    step = make_selfplay_step(env, apply, params, training=True)
    variables = mgr.init(torch.Generator(device="cuda").manual_seed(0))
    sp = init_selfplay(env, 8, torch.Generator(device="cuda").manual_seed(seed),
                       search_params=params)
    return env, step, variables, sp


@pytest.mark.cuda
def test_a_captured_move_replays_the_eager_move_with_the_kernel_in_its_graph(
        cuda_card, monkeypatch):
    """Four eager moves with the eager body as the step, then four replays
    of the captured move with the kernel in its graph: equal bit for bit.
    The capture launches the kernel once for each step of a move (and as
    often in its warm-up); a replay launches nothing from the host."""
    env, step, variables, eager_sp = _selfplay(5)
    with monkeypatch.context() as patch:
        patch.setattr(env, "step", env._step)
        want = [{k: v.clone() for k, v in move_tensors(
            eager_sp, *play_in_place(step, variables, eager_sp)).items()} for _ in range(4)]
    _, step, variables, graph_sp = _selfplay(5)
    scs_step_kernel.reset_launch_count()
    probe_sp = _selfplay(5)[3]
    play_in_place(step, variables, probe_sp)
    per_move = scs_step_kernel.launch_count[scs_step_kernel.KERNEL]
    assert per_move == 4 + 1  # a step per simulation, and the move's own
    scs_step_kernel.reset_launch_count()
    graph = capture_selfplay_step(step, variables, graph_sp)
    assert scs_step_kernel.launch_count[scs_step_kernel.KERNEL] == 2 * per_move
    for move in range(4):
        got = move_tensors(graph_sp, *graph.replay())
        for name, w in want[move].items():
            assert torch.equal(got[name], w), f"move {move}: {name}"
    graph.check_overflow()
    assert scs_step_kernel.launch_count[scs_step_kernel.KERNEL] == 2 * per_move


# ----------------------------------------------------------------- the CPU


def test_a_cpu_env_never_launches_the_kernel():
    env = _env("solo_scout_5", "cpu")
    gen = torch.Generator().manual_seed(1)
    state = env.init(4, generator=gen)
    scs_step_kernel.reset_launch_count()
    for move in range(5):
        action = _random_legal(env, state, gen)
        want = env._step(state, action)
        state = env.step(state, action)
        _assert_equal(state, want, f"move {move}")
    assert scs_step_kernel.launch_count[scs_step_kernel.KERNEL] == 0


def _cpu_call(env, state, action, overflow=None):
    return scs_step_kernel.scs_step_cuda(
        [getattr(state, f) for f in _fields(state)], action, env._kernel_ftab,
        env._kernel_itab, (env.R, env.C, env.K, env.S), env.scenario.turns,
        env.stage_passes, env._kernel_recip_vp, overflow=overflow)


@pytest.mark.parametrize("fault, error, match", [
    ("mov_f64", TypeError, "field mov is torch.float64, expected torch.float32"),
    ("board_transposed", ValueError, "field board is not contiguous within a game"),
    ("stage_2d", ValueError, r"field stage has shape \(4, 1\), expected \(4,\)"),
    ("action_int64", TypeError, "action must be int32"),
    ("on_the_cpu", ValueError, "on one CUDA device"),
    ("flag_int32", TypeError, "the overflow flag must be a 0-d bool tensor"),
])
def test_the_wrapper_refuses_a_bad_state_before_any_launch(monkeypatch, fault, error, match):
    """A state the kernel does not take raises a clear error before the
    library is built or anything launched."""
    env = _env("open_field_5", "cpu")
    gen = torch.Generator().manual_seed(2)
    state = env.init(4, generator=gen)
    action = _random_legal(env, state, gen)
    if fault == "mov_f64":
        state = state.replace(mov=state.mov.double())
    elif fault == "board_transposed":
        state = state.replace(board=state.board.transpose(1, 2).contiguous().transpose(1, 2))
    elif fault == "stage_2d":
        state = state.replace(stage=state.stage[:, None])
    elif fault == "action_int64":
        action = action.long()
    overflow = torch.zeros((), dtype=torch.int32) if fault == "flag_int32" else None

    def refuse():
        raise AssertionError("built the library")

    monkeypatch.setattr(scs_step_kernel, "scs_step_library", refuse)
    scs_step_kernel.reset_launch_count()
    with pytest.raises(error, match=match):
        _cpu_call(env, state, action, overflow)
    assert scs_step_kernel.launch_count[scs_step_kernel.KERNEL] == 0


def test_a_game_strided_state_passes_the_checks(monkeypatch):
    """Each game's part contiguous is enough: the search's unpacked rows
    (views with a batch stride) reach the launch."""
    from nuzero_tpu_torch.utils.packing import make_packer

    env = _env("open_field_5", "cpu")
    gen = torch.Generator().manual_seed(2)
    pack, unpack, _ = make_packer(env.init(1, generator=gen))
    state = unpack(pack(env.init(4, generator=gen)))
    assert not state.mov.is_contiguous()

    def reached():
        raise RuntimeError("reached the launch")

    monkeypatch.setattr(scs_step_kernel, "scs_step_library", reached)
    with pytest.raises(ValueError, match="on one CUDA device"):
        _cpu_call(env, state, torch.zeros(4, dtype=torch.int32))
    assert scs_step_kernel._rows_contiguous(state.mov)


def test_the_kernel_is_listed_in_build_all(monkeypatch):
    """``build_all`` (which the benchmark runs before its window) builds
    ``csrc/scs_step.cu`` as the ``scs_step`` library."""
    built = []

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(build, "build", lambda name, sources: built.append((name, sources)))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: Lib())
    assert build.LIBRARIES["scs_step"] is build.scs_step_library
    build.scs_step_library.__wrapped__()
    assert built == [("scs_step", ("scs_step.cu",))]
    assert os.path.exists(os.path.join(build.CSRC, "scs_step.cu"))


def test_a_kernel_overflow_raises_once_at_the_next_call():
    """A step whose flag came back set (stood in for here: the env's
    pending flag, set) raises the stage machine's ``OverflowError`` at the
    env's next ``terminal_value``, once; its wait is the step's event."""
    env = _env("solo_scout_5", "cpu")
    state = env.init(2, generator=torch.Generator().manual_seed(4))
    waited = []

    class Done:
        def synchronize(self):
            waited.append(1)

    env._overflow._local.host = torch.tensor(True)
    env._overflow._local.pending = (Done(), "the SCS stage machine's 43 passes")
    with pytest.raises(OverflowError,
                       match="the SCS stage machine's 43 passes ran past its bound"):
        env.terminal_value(state)
    assert waited == [1]
    env.terminal_value(state)
    assert waited == [1]


def test_a_report_inside_overflow_into_goes_into_its_flag():
    """Inside an open ``overflow_into`` (a capture's warm-up, or the capture
    itself) the step hands the kernel the caller's own flag to set, with its
    bound named; outside it gets none and reports its own flag later."""
    flag = torch.zeros((), dtype=torch.bool)
    assert graphs.open_overflow_flag("a bound") is None
    with graphs.overflow_into(flag) as whats:
        graphs.overflowed(torch.tensor(False), "a loop's 3 trips")
        assert graphs.open_overflow_flag("the SCS stage machine's 7 passes") is flag
    assert whats == ["a loop's 3 trips", "the SCS stage machine's 7 passes"]
    assert graphs.open_overflow_flag("a bound") is None


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/scs_step.cu`` built for the CPU by ``g++`` on
    ``tests/cuda_warp_shim.h``: its kernel, parameters and host launcher as
    written, each warp run on 32 host threads."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    with open(os.path.join(build.CSRC, "scs_step.cu")) as f:
        src = f.read()
    subs = (("#include <cuda_runtime.h>", '#include "cuda_warp_shim.h"'),
            ("extern __shared__ __align__(16) unsigned char smem[];",
             "unsigned char* smem = shim_smem;"))
    for old, new in subs:
        assert src.count(old) == 1, f"scs_step.cu no longer holds {old!r}"
        src = src.replace(old, new)
    src, n = re.subn(r"scs_step_kernel<<<\(B \+ kWarps - 1\) / kWarps, kWarps \* 32, smem,"
                     r"\s*static_cast<cudaStream_t>\(stream\)>>>\(p\);",
                     "shim_launch(scs_step_kernel, p, (B + kWarps - 1) / kWarps, kWarps, smem);",
                     src)
    assert n == 1, "scs_step.cu no longer launches as the emulation expects"
    work = tmp_path_factory.mktemp("scs_step")
    (work / "scs_step.cpp").write_text(src)
    lib = work / "libscs_step_cpu.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-I", TESTS,
         "-o", str(lib), str(work / "scs_step.cpp"), "-lpthread"],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(lib))
    pointers = ctypes.POINTER(ctypes.c_void_p)
    lib.scs_step.argtypes = [
        pointers, ctypes.POINTER(ctypes.c_longlong), pointers, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        *[ctypes.c_int] * 7, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.scs_step.restype = ctypes.c_int
    return lib


def _emulated_step(lib, env, state, action):
    """The wrapper's launch, on CPU tensors through the emulation: (next
    state, overflow)."""
    fields = list(_fields(state).values())
    B = action.shape[0]
    outs = [torch.full_like(t, 7) for t in fields]  # never the answer's bits
    flag = torch.zeros((), dtype=torch.bool)
    err = lib.scs_step(
        scs_step_kernel._Pointers(*(t.data_ptr() for t in fields)),
        scs_step_kernel._Strides(*(t.stride(0) for t in fields)),
        scs_step_kernel._Pointers(*(t.data_ptr() for t in outs)),
        action.data_ptr(), action.stride(0), env._kernel_ftab.data_ptr(),
        env._kernel_itab.data_ptr(), flag.data_ptr(),
        B, env.R, env.C, env.K, env.S, env.scenario.turns, env.stage_passes,
        *env._kernel_recip_vp, None)
    assert err == 0
    return SCSState(*outs), bool(flag)


@pytest.mark.parametrize("scenario", ["open_field_5", "solo_scout_5", "sweep15"])
def test_the_kernel_source_equals_the_eager_step_on_the_cpu(emulated, scenario):
    """The kernel's source, run on the CPU, against the eager body at B=8:
    120 steps of random legal actions (combat from about the 60th on
    ``open_field_5``; the solo scout's games end and are stepped on), then
    any action at all (every applier, legal or not), the search's unpacked
    rows as inputs, every field bit for bit; and with no pass after the
    first allowed, the overflow flag where the eager body raises."""
    from nuzero_tpu_torch.utils.packing import make_packer

    env = _env(scenario, "cpu")
    gen = torch.Generator().manual_seed(2**31 + 3)
    pack, unpack, _ = make_packer(env.init(1, generator=gen))
    state = env.init(8, generator=gen)
    for step in range(140):
        action = _random_legal(env, state, gen)
        if step >= 120:
            action = torch.randint(0, env.num_actions, (8,), generator=gen, dtype=torch.int32)
        want = env._step(state, action)
        got, overflow = _emulated_step(emulated, env, unpack(pack(state)), action)
        assert not overflow
        _assert_equal(got, want, f"{scenario} step {step}")
        state = want
    passes = env.stage_passes
    for _ in range(20):
        action = _random_legal(env, state, gen)
        env.stage_passes = 0
        try:
            env._step(state, action)
            raised = False
        except OverflowError:
            raised = True
        assert _emulated_step(emulated, env, state, action)[1] is raised
        env.stage_passes = passes
        state = env._step(state, action)
