"""The search's PUCT descent kernel (``ops/cuda/csrc/search_descend.cu``).

On the card ``mcts._descend`` launches the kernel; its plain version is the
eager body ``mcts._descend_plain``.  The card tests (marked ``cuda``; they
skip where there is no card) hold the kernel to ``_descend_plain`` bit for
bit in all five outputs: at every simulation of two self-play moves (the
second on carried trees) at the benchmark cells' shapes (``solo_scout_5``
with victory points per game at B = 128 and 300 simulations, N = 604;
``open_field_5`` at B = 512 and 1,024 and 100 simulations, N = 204) and on
Tic-Tac-Toe; on made-up trees with exact ties, unexpanded and terminal
nodes, missing children, full trees and chains longer than the depth cap;
and a captured self-play move, with the kernel in its graph, replays the
eager move with the plain descent bit for bit.  The CPU tests hold the rule
that keeps the CPU on the plain body, the wrapper's checks, ``build_all``,
and run the kernel's own source on the CPU (``g++`` with
``tests/cuda_warp_shim.h``, a lane a host thread) against the plain body.
This file imports neither JAX nor the JAX package, so it also runs on a card
machine without them:

    python -m pytest tests/test_torch_descend_kernel.py --noconftest -q
"""

import ctypes
import math
import os
import re
import shutil
import subprocess

import pytest
import torch

from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.envs.tictactoe import TicTacToe
from nuzero_tpu_torch.ops.cuda import build, search_descend_kernel
from nuzero_tpu_torch.search import mcts
from nuzero_tpu_torch.search.tree import Tree
from nuzero_tpu_torch.training.selfplay import (
    capture_selfplay_step, init_selfplay, make_selfplay_step, move_tensors, play_in_place,
)

TESTS = os.path.dirname(os.path.abspath(__file__))
SCENARIOS = os.path.join(os.path.dirname(TESTS), "configs", "scenarios")
OUTPUTS = ("stop_node", "sel_action", "needs_alloc", "path", "capped")
KERNEL = search_descend_kernel.KERNEL
KERNEL_DESCEND = mcts._descend  # the kernel on the card, whatever a test patches in


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _env(name, device):
    if name == "ttt":
        return TicTacToe(device=device)
    return SCSGame(load_scenario(os.path.join(SCENARIOS, name + ".yml"), seed=42),
                   randomize_vp=name == "solo_scout_5", device=device)


def _stand_in_net(env, device, seed):
    """(apply, variables): a linear policy and a tanh value over the
    flattened observation; cheap, and with priors as varied as a trained
    net's."""
    gen = torch.Generator(device=device).manual_seed(seed)
    width = math.prod(env.observation_shape)
    variables = {
        "w": torch.randn(width, env.num_actions, generator=gen, device=device) * 2
        / math.sqrt(width),
        "v": torch.randn(width, generator=gen, device=device) / math.sqrt(width),
    }

    def apply(variables, obs):
        x = obs.reshape(obs.shape[0], -1).to(torch.float32)
        return x @ variables["w"], torch.tanh(x @ variables["v"])

    return apply, variables


def _assert_same(got, want, where):
    for name, g, w in zip(OUTPUTS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{where}: {name}"
        if not torch.equal(g, w):
            differ = g != w
            games = (differ.reshape(g.shape[0], -1).any(-1)).nonzero()[:8, 0].tolist()
            pytest.fail(f"{where}: {name} differs in games {games}")


def _descend_both(tree, params, depth_cap, where):
    """The kernel's outputs, after checking them against the plain body's on
    the same tree (which neither writes)."""
    want = mcts._descend_plain(tree, params, depth_cap)
    got = KERNEL_DESCEND(tree, params, depth_cap)
    _assert_same(got, want, where)
    return got


def made_up_tree(B, N, A, gen, device, *, child_share=0.3, legal_share=0.7,
                 unexpanded_share=0.1, terminal_share=0.05, tied=False, nan_share=0.0):
    """A batch of random trees (not ones a search grows): children anywhere,
    cycles included, so that walks end on every rule and at the depth cap.
    ``tied`` draws priors and values from a few exact numbers, so that legal
    scores tie exactly; ``nan_share`` of the priors are NaN."""
    def rand(*shape):
        return torch.rand(shape, generator=gen)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    if tied:
        prior = torch.tensor([0.125, 0.25, 0.5])[randint(0, 3, B, N, A).long()]
        value_sum = randint(-2, 3, B, N).to(torch.float32)
        visit = randint(0, 3, B, N)
    else:
        prior = rand(B, N, A)
        value_sum = (rand(B, N) * 2 - 1) * 20
        visit = randint(0, 40, B, N)
    prior = torch.where(rand(B, N, A) < nan_share, float("nan"), prior)
    legal = rand(B, N, A) < legal_share
    child = torch.where(rand(B, N, A) < child_share, randint(0, N, B, N, A), -1)
    tree = Tree(
        visit=visit, value_sum=value_sum, parent=torch.full((B, N), -1, dtype=torch.int32),
        to_play=randint(0, 2, B, N), is_terminal=rand(B, N) < terminal_share,
        terminal_value=torch.zeros(B, N), expanded=rand(B, N) >= unexpanded_share,
        prior=prior, legal=legal, child=child, states=torch.zeros(B, N, 1),
        root=randint(0, N, B), free=torch.zeros(B, N, dtype=torch.bool))
    return Tree(**{k: v.to(device) for k, v in vars(tree).items()})


def chain_tree(B, N, A, device):
    """Every node expanded with one legal action, leading to the next node:
    each walk from its root is longer than any depth cap below N."""
    tree = made_up_tree(B, N, A, torch.Generator().manual_seed(1), "cpu")
    nodes = torch.arange(N, dtype=torch.int32)
    tree.expanded.fill_(True)
    tree.is_terminal.fill_(False)
    tree.legal.fill_(False)
    tree.legal[:, :, 0] = True
    tree.child.fill_(-1)
    tree.child[:, :, 0] = (nodes + 1).clamp(max=N - 1)
    tree.root.fill_(0)
    return Tree(**{k: v.to(device) for k, v in vars(tree).items()})


MADE_UP = {  # (B, N, A, depth_cap, tree options)
    "ties": (96, 60, 9, 10, dict(tied=True, child_share=0.5)),
    "unexpanded_and_terminal": (64, 80, 40, 20, dict(unexpanded_share=0.4, terminal_share=0.3)),
    "missing_children": (64, 200, 300, 65, dict(child_share=0.05)),
    "full": (64, 120, 33, 65, dict(child_share=1.0, legal_share=1.0, unexpanded_share=0.0,
                                   terminal_share=0.0)),
    "nan_priors": (32, 50, 70, 12, dict(nan_share=0.1, child_share=0.6)),
    "two_games_a_block": (16, 2000, 20, 30, dict(child_share=0.5)),
    "one_game_a_block": (9, 4000, 9, 65, dict(tied=True, child_share=0.9)),
}


# ---------------------------------------------------------------- the card


# (env, batch, simulations): the cells' shapes and Tic-Tac-Toe.
SEARCHED = {"solo64": ("solo_scout_5", 128, 300), "contested256": ("open_field_5", 512, 100),
            "contested256_b1024": ("open_field_5", 1024, 100), "ttt": ("ttt", 1024, 100)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SEARCHED))
def test_kernel_equals_the_plain_descent_on_searched_trees(cuda_card, monkeypatch, shape):
    """Two self-play moves (the second on the first's carried trees) with a
    stand-in net: at every simulation the kernel and the plain body, on the
    same tree, equal bit for bit in all five outputs."""
    name, batch, sims = SEARCHED[shape]
    env = _env(name, "cuda")
    params = mcts.SearchParams(num_simulations=sims)
    apply, variables = _stand_in_net(env, "cuda", 7)
    step = make_selfplay_step(env, apply, params, training=True)
    sp = init_selfplay(env, batch, torch.Generator(device="cuda").manual_seed(2**31 + batch),
                       search_params=params)
    calls = []

    def checked(tree, p, depth_cap):
        calls.append(tree.visit.shape)
        return _descend_both(tree, p, depth_cap, f"{shape} descent {len(calls)}")

    monkeypatch.setattr(mcts, "_descend", checked)
    for _ in range(2):
        play_in_place(step, variables, sp)
    assert len(calls) == 2 * sims
    assert calls[0] == (batch, 2 * sims + 4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(MADE_UP) + ["chain"])
def test_kernel_equals_the_plain_descent_on_made_up_trees(cuda_card, kind):
    if kind == "chain":
        B, N, A, depth_cap = 8, 100, 5, 65
        tree = chain_tree(B, N, A, "cuda")
    else:
        B, N, A, depth_cap, options = MADE_UP[kind]
        tree = made_up_tree(B, N, A, torch.Generator().manual_seed(3), "cuda", **options)
    before = {k: v.clone() for k, v in vars(tree).items()}
    for value_factor in (1.0, 0.5):
        params = mcts.SearchParams(value_factor=value_factor)
        got = _descend_both(tree, params, depth_cap, kind)
    for k, v in before.items():  # bit for bit, so that NaN priors compare equal
        assert torch.equal(v.view(torch.uint8), getattr(tree, k).view(torch.uint8)), f"wrote {k}"
    if kind in ("chain", "full"):
        assert bool(got[4].all()) and not bool(got[2].any())


def _selfplay(seed):
    """A small self-play setup on the card: open_field_5, B=8, the stand-in
    net, 6 simulations with carried trees, training draws."""
    env = _env("open_field_5", "cuda")
    params = mcts.SearchParams(num_simulations=6)
    apply, variables = _stand_in_net(env, "cuda", 3)
    step = make_selfplay_step(env, apply, params, training=True)
    sp = init_selfplay(env, 8, torch.Generator(device="cuda").manual_seed(seed),
                       search_params=params)
    return step, variables, sp


@pytest.mark.cuda
def test_a_captured_move_replays_the_eager_move_with_the_plain_descent(cuda_card, monkeypatch):
    """Four eager moves with the plain descent, then four replays of the
    captured move with the kernel in its graph: trees, ring and search
    results equal bit for bit.  The capture launches the kernel once for
    each descent of a move (and as often in its warm-up); a replay launches
    nothing from the host."""
    step, variables, eager_sp = _selfplay(5)
    with monkeypatch.context() as patch:
        patch.setattr(mcts, "_descend", mcts._descend_plain)
        want = [{k: v.clone() for k, v in move_tensors(
            eager_sp, *play_in_place(step, variables, eager_sp)).items()} for _ in range(4)]
    step, variables, graph_sp = _selfplay(5)
    search_descend_kernel.reset_launch_count()
    graph = capture_selfplay_step(step, variables, graph_sp)
    assert search_descend_kernel.launch_count[KERNEL] == 2 * 6
    for move in range(4):
        got = move_tensors(graph_sp, *graph.replay())
        for name, w in want[move].items():
            assert torch.equal(got[name], w), f"move {move}: {name}"
    graph.check_overflow()
    assert search_descend_kernel.launch_count[KERNEL] == 2 * 6


# ----------------------------------------------------------------- the CPU


def test_a_cpu_tree_never_launches_the_kernel(monkeypatch):
    def refuse():
        raise AssertionError("built the library")

    monkeypatch.setattr(search_descend_kernel, "search_descend_library", refuse)
    tree = made_up_tree(8, 30, 9, torch.Generator().manual_seed(4), "cpu")
    search_descend_kernel.reset_launch_count()
    params = mcts.SearchParams()
    _assert_same(mcts._descend(tree, params, 10), mcts._descend_plain(tree, params, 10), "cpu")
    assert search_descend_kernel.launch_count[KERNEL] == 0


def _tree_args(tree):
    return (tree.root, tree.visit, tree.value_sum, tree.to_play, tree.expanded,
            tree.is_terminal, tree.prior, tree.legal, tree.child)


@pytest.mark.parametrize("fault, error, match", [
    ("visit_int64", TypeError, "visit is torch.int64, expected torch.int32"),
    ("legal_uint8", TypeError, "legal is torch.uint8, expected torch.bool"),
    ("child_short", ValueError, r"child has shape \(4, 30, 8\), expected \(4, 30, 9\)"),
    ("root_2d", ValueError, r"root has shape \(4, 1\), expected \(1,\)"),
    ("prior_transposed", ValueError, "prior is not contiguous"),
    ("on_the_cpu", ValueError, "on one CUDA device"),
    ("depth_cap_0", ValueError, "depth_cap must be >= 1"),
    ("too_many_nodes", ValueError, "a tree of 29057 nodes passes the 29056"),
])
def test_the_wrapper_refuses_a_bad_tree_before_any_launch(monkeypatch, fault, error, match):
    """A tree the kernel does not take raises a clear error before the
    library is built or anything launched."""
    N = 29057 if fault == "too_many_nodes" else 30
    tree = made_up_tree(4 if N == 30 else 1, N, 9, torch.Generator().manual_seed(2), "cpu")
    args = list(_tree_args(tree))
    if fault == "visit_int64":
        args[1] = args[1].long()
    elif fault == "legal_uint8":
        args[7] = args[7].to(torch.uint8)
    elif fault == "child_short":
        args[8] = args[8][..., :8].contiguous()
    elif fault == "root_2d":
        args[0] = args[0][:, None]
    elif fault == "prior_transposed":
        args[6] = args[6].transpose(1, 2).contiguous().transpose(1, 2)

    def refuse():
        raise AssertionError("built the library")

    monkeypatch.setattr(search_descend_kernel, "search_descend_library", refuse)
    search_descend_kernel.reset_launch_count()
    with pytest.raises(error, match=match):
        search_descend_kernel.search_descend_cuda(
            *args, 0 if fault == "depth_cap_0" else 10, 10000.0, 1.15, 1.0)
    assert search_descend_kernel.launch_count[KERNEL] == 0


def test_the_kernel_is_listed_in_build_all(monkeypatch):
    """``build_all`` (which the benchmark runs before its window) builds
    ``csrc/search_descend.cu`` as the ``search_descend`` library."""
    built = []

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(build, "build", lambda name, sources: built.append((name, sources)))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: Lib())
    assert build.LIBRARIES["search_descend"] is build.search_descend_library
    build.search_descend_library.__wrapped__()
    assert built == [("search_descend", ("search_descend.cu",))]
    assert os.path.exists(os.path.join(build.CSRC, "search_descend.cu"))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/search_descend.cu`` built for the CPU by ``g++`` on
    ``tests/cuda_warp_shim.h``: its kernel, parameters and host launcher as
    written, each warp run on 32 host threads."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    with open(os.path.join(build.CSRC, "search_descend.cu")) as f:
        src = f.read()
    subs = (("#include <cuda_runtime.h>", '#include "cuda_warp_shim.h"'),
            ("extern __shared__ __align__(16) unsigned char smem[];",
             "unsigned char* smem = shim_smem;"))
    for old, new in subs:
        assert src.count(old) == 1, f"search_descend.cu no longer holds {old!r}"
        src = src.replace(old, new)
    src, n = re.subn(r"search_descend_kernel<<<\(B \+ p\.warps - 1\) / p\.warps, p\.warps \* 32,"
                     r" smem,\s*static_cast<cudaStream_t>\(stream\)>>>\(p\);",
                     "shim_launch(search_descend_kernel, p, (B + p.warps - 1) / p.warps, "
                     "p.warps, smem);", src)
    assert n == 1, "search_descend.cu no longer launches as the emulation expects"
    work = tmp_path_factory.mktemp("search_descend")
    (work / "search_descend.cpp").write_text(src)
    lib = work / "libsearch_descend_cpu.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-I", TESTS,
         "-o", str(lib), str(work / "search_descend.cpp"), "-lpthread"],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lib = ctypes.CDLL(str(lib))
    lib.search_descend.argtypes = [*[ctypes.c_void_p] * 14, *[ctypes.c_int] * 4,
                                   *[ctypes.c_float] * 4, ctypes.c_void_p]
    lib.search_descend.restype = ctypes.c_int
    return lib


def _emulated_descend(lib, tree, params, depth_cap):
    """The wrapper's launch, on CPU tensors through the emulation."""
    B, N = tree.visit.shape
    outs = (torch.full((B,), 7, dtype=torch.int32), torch.full((B,), 7, dtype=torch.int32),
            torch.full((B,), True), torch.full((B, depth_cap), 7, dtype=torch.int32),
            torch.full((B,), True))  # never the answer's bits everywhere
    f32 = lambda x: float(torch.tensor(x, dtype=torch.float32))  # noqa: E731
    err = lib.search_descend(
        *(t.data_ptr() for t in _tree_args(tree)), *(t.data_ptr() for t in outs),
        B, N, tree.prior.shape[2], depth_cap, f32(params.pb_c_base),
        mcts._f32_recip(params.pb_c_base), f32(params.pb_c_init), f32(params.value_factor),
        None)
    assert err == 0
    return outs


@pytest.mark.parametrize("kind", sorted(MADE_UP) + ["chain"])
def test_the_kernel_source_equals_the_plain_descent_on_the_cpu(emulated, kind):
    """The kernel's source, run on the CPU, against the plain body on made-up
    trees: all five outputs equal (the walk, the lanes' strides, the
    reduction and its tie-break; the card test holds the score's bits)."""
    if kind == "chain":
        B, N, A, depth_cap = 4, 100, 5, 65
        tree = chain_tree(B, N, A, "cpu")
    else:
        B, N, A, depth_cap, options = MADE_UP[kind]
        tree = made_up_tree(B, N, A, torch.Generator().manual_seed(5), "cpu", **options)
    for value_factor in (1.0, 0.5):
        params = mcts.SearchParams(value_factor=value_factor)
        want = mcts._descend_plain(tree, params, depth_cap)
        _assert_same(_emulated_descend(emulated, tree, params, depth_cap), want, kind)
    if kind in ("chain", "full"):
        assert bool(want[4].all()) and not bool(want[2].any())
    else:  # walks end at a missing child, and at a node that cannot go on
        assert bool(want[2].any()) and bool((~want[2] & ~want[4]).any())
