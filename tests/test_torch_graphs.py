"""The self-play move's loops written for a CUDA graph, on the CPU.

A captured move may not read the host, so its data-dependent loops run
through ``graphs.run_while`` (while-nodes under capture), its bounded
loops record overflows into a device flag, and the replay ring is written
without ``nonzero``.  Here: a move that takes every ``run_while`` trip and
records into a flag reads nothing on the host and equals the eager move
bit for bit; the fixed gamma rounds give the rejection loop's values; the
stage machine's bound holds on the longest chain and equals the JAX
engine there; the masked ring write equals the in-order write."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuzero_tpu.envs.scs import SCSGame as JaxSCSGame
from nuzero_tpu.envs.scs import load_scenario as jax_load_scenario
from nuzero_tpu.utils.packing import make_packer as jax_make_packer
from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.recurrent import RecurrentNet
from nuzero_tpu_torch.search import mcts
from nuzero_tpu_torch.search.mcts import SearchParams
from nuzero_tpu_torch.training import replay
from nuzero_tpu_torch.training.selfplay import (
    capture_selfplay_step, init_selfplay, make_selfplay_step, move_tensors, play_in_place,
)
from nuzero_tpu_torch.utils import graphs
from nuzero_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from nuzero_tpu_torch.utils.packing import make_packer

torch.set_num_threads(2)

PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "scenarios", "open_field_5.yml",
)
B, FILTERS, SIMS, MOVES = 4, 8, 3, 3


def _setup(turns=None, path=PATH, randomize_vp=False):
    env = SCSGame(load_scenario(path, seed=42, turns=turns), randomize_vp=randomize_vp,
                  device="cpu")
    net = RecurrentNet(env.observation_shape[0], env.action_space_shape[0],
                       num_filters=FILTERS, num_blocks=2, recall=True, hex=True)
    mgr = NetworkManager(net, env.observation_shape)

    def apply(variables, obs):
        p, v, _ = mgr.apply(variables, obs, iters_to_do=2)
        return p, v

    params = SearchParams(num_simulations=SIMS)
    step = make_selfplay_step(env, apply, params, training=True)
    variables = mgr.init(torch.Generator().manual_seed(0))
    return env, params, step, variables


def _state_tensors(sp, finished, stats):
    return {k: v.clone() for k, v in move_tensors(sp, finished, stats).items()}


def _no_host_reads(monkeypatch):
    """Make every way of reading a tensor on the host raise."""

    def refuse(*args, **kwargs):
        raise AssertionError("the move read a tensor on the host")

    for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist",
                 "numpy", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)


def _guarded_moves(monkeypatch, env, params, step, variables, moves=MOVES):
    """``moves`` eager moves, and the same moves from the same state with
    every ``run_while`` trip taken, overflows recorded into a flag and every
    host read refused -> (eager tensors, guarded tensors, trips)."""
    eager_sp = init_selfplay(env, B, torch.Generator().manual_seed(1), search_params=params)
    graph_sp = init_selfplay(env, B, torch.Generator().manual_seed(1), search_params=params)
    step(variables, init_selfplay(env, B, torch.Generator().manual_seed(9),
                                  search_params=params))  # fills the fresh-game cache
    eager = [_state_tensors(eager_sp, *play_in_place(step, variables, eager_sp))
             for _ in range(moves)]

    trips = []

    def every_trip(cond, body, max_trips):
        trips.append(max_trips)
        for _ in range(max_trips):
            body()
        return True

    monkeypatch.setattr(graphs, "run_while", every_trip)
    flag = torch.zeros((), dtype=torch.bool)
    with monkeypatch.context() as guard, graphs.overflow_into(flag):
        _no_host_reads(guard)
        guarded = [_state_tensors(graph_sp, *play_in_place(step, variables, graph_sp))
                   for _ in range(moves)]
    assert not flag
    for move, (got, want) in enumerate(zip(guarded, eager)):
        assert got.keys() == want.keys()
        for name in want:
            assert torch.equal(got[name], want[name]), f"move {move}: {name}"
    return eager, guarded, trips


def test_a_move_with_every_trip_reads_nothing_and_equals_the_eager_move(monkeypatch):
    """Every ``run_while`` trip taken up to its bound (a replay's device
    decides where to stop, so nothing in a loop may depend on stopping)
    and overflows recorded into a flag: no host read, and the same bits as
    the eager move that stops each loop early, over three moves."""
    env, params, step, variables = _setup()
    _, _, trips = _guarded_moves(monkeypatch, env, params, step, variables)
    # Per move: the descent's steps after the first (depth_cap - 1, the tree
    # holding 2 * SIMS + 4 nodes) in each of SIMS simulations, and the stage
    # machine's passes in each of SIMS + 1 env steps.
    depth_steps = min(2 * SIMS + 3, env.max_game_length, mcts.MAX_PATH_DEPTH)
    assert sum(trips) == MOVES * (SIMS * depth_steps + (SIMS + 1) * env.stage_passes)


def test_a_randomize_vp_move_reads_nothing_and_draws_layouts_in_the_move(monkeypatch):
    """The same guard with per-game victory points (``solo_scout_5.yml`` cut
    to two turns, so games end and are recycled within the moves): the
    fresh layouts are drawn inside the move from ``sp.rng`` with no host
    read, equal bit for bit to the eager move's, the generator's state
    included, and the recycled games take layouts drawn there."""
    path = os.path.join(os.path.dirname(PATH), "solo_scout_5.yml")
    env, params, step, variables = _setup(turns=2, path=path, randomize_vp=True)
    eager, _, _ = _guarded_moves(monkeypatch, env, params, step, variables, moves=8)
    recycled = [m["move_count"] == 0 for m in eager]
    assert any(r.any() for r in recycled)
    first = eager[0]["games.vp"]
    changed = [(m["games.vp"][r] != first[r]).any() for m, r in zip(eager, recycled)]
    assert any(bool(c) for c in changed)


@pytest.mark.parametrize("alpha", [1.0, 1.15, 3.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gamma_rounds_give_the_rejection_loops_values(alpha, seed):
    """alpha >= 1 (no boost): the fixed rounds keep each entry's first
    accepted draw, as redrawing until all are accepted does."""
    shape = (48, 525)
    got = mcts.sample_gamma(torch.Generator().manual_seed(seed), alpha, shape, "cpu")
    rng = torch.Generator().manual_seed(seed)
    d = alpha - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    want = torch.zeros(shape)
    pending = torch.ones(shape, dtype=torch.bool)
    while pending.any():
        x = torch.randn(shape, generator=rng)
        u = torch.rand(shape, generator=rng)
        v = (1.0 + c * x) ** 3
        accept = (v > 0) & (
            torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v.clamp(min=1e-30)))
        want = torch.where(pending & accept, d * v, want)
        pending = pending & ~accept
    assert torch.equal(got, want)


def test_gamma_rounds_overflow_raises_or_flags(monkeypatch):
    monkeypatch.setattr(mcts, "GAMMA_ROUNDS", 1)
    flag = torch.zeros((), dtype=torch.bool)
    with graphs.overflow_into(flag):
        mcts.sample_gamma(torch.Generator().manual_seed(0), 0.15, (64, 525), "cpu")
    assert flag
    with pytest.raises(OverflowError, match="gamma"):
        mcts.sample_gamma(torch.Generator().manual_seed(0), 0.15, (64, 525), "cpu")


def _longest_chain_states(env):
    """Games that need the most stage-machine passes (no unit stands and
    none arrives, stage -2 of turn 0), beside two ordinary fresh games."""
    s = env.init(4)
    gone = torch.tensor([True, True, False, False])
    s.alive[gone] = False
    s.placed[gone] = False
    s.board[gone] = -1
    s.reinf_next[gone] = env.reinf_count
    s.stage[gone] = -2
    s.turn[gone] = 0
    return s


def test_stage_machine_bound_holds_on_the_longest_chain_and_matches_jax(monkeypatch):
    env = SCSGame(load_scenario(PATH, seed=42), device="cpu")
    jenv = JaxSCSGame(jax_load_scenario(PATH, seed=42))
    start = _longest_chain_states(env)
    calls = []
    advance = env._advance
    monkeypatch.setattr(env, "_advance", lambda s: calls.append(1) or advance(s))
    got = env._update_env(start)
    # 6 * turns + 2 passes: the first, then all stage_passes of the loop.
    assert len(calls) == 6 * env.scenario.turns + 2 == env.stage_passes + 1
    assert got.terminal[:2].all() and (got.stage[:2] == 6).all()
    assert (got.turn[:2] == env.scenario.turns).all()
    pack, _, _ = make_packer(start)
    jpack, junpack, _ = jax_make_packer(jenv.init(jax.random.key(0)))
    jstart = jax.vmap(junpack)(jnp.asarray(pack(start).numpy()))
    want = jax.vmap(jpack)(jax.vmap(jenv._update_env)(jstart))
    np.testing.assert_array_equal(pack(got).numpy(), np.asarray(want))


def test_stage_machine_past_its_bound_raises_or_flags():
    env = SCSGame(load_scenario(PATH, seed=42), device="cpu")
    env.stage_passes -= 1
    flag = torch.zeros((), dtype=torch.bool)
    with graphs.overflow_into(flag):
        env._update_env(_longest_chain_states(env))
    assert flag
    with pytest.raises(OverflowError, match="stage machine"):
        env._update_env(_longest_chain_states(env))
    env.stage_passes += 1
    env._update_env(_longest_chain_states(env))


D, A, L = 6, 5, 7


def _add_in_order(buffer, finished):
    """The in-order ring write: the real rows, by ``nonzero``, into the next
    slots; of more real rows than the ring holds the last ``capacity``."""
    rows = torch.nonzero(finished.mask).squeeze(1)
    n = rows.numel()
    if n == 0:
        return
    G = buffer.capacity
    offset = torch.arange(n)
    if n > G:
        rows, offset = rows[n - G:], offset[n - G:]
    slot = (buffer.ptr + offset) % G
    length = finished.length[rows]
    pos_valid = torch.arange(L)[None, :] < length[:, None]
    buffer.states[slot] = finished.states[rows]
    buffer.policy[slot] = finished.policy[rows]
    buffer.value[slot] = torch.where(pos_valid, finished.final_value[rows][:, None], 0.0)
    buffer.length[slot] = length.to(torch.int32)
    buffer.game_type[slot] = finished.game_type[rows].to(torch.int32)
    buffer.seq[slot] = (buffer.games_added + offset).to(torch.int32)
    buffer.ptr.copy_((buffer.ptr + n) % G)
    buffer.games_added.add_(n)


def _finished(mask, start):
    g = torch.Generator().manual_seed(start)
    b = len(mask)
    return replay.FinishedGames(
        states=torch.rand(b, L, D, generator=g), policy=torch.rand(b, L, A, generator=g),
        final_value=torch.arange(b, dtype=torch.float32) + start,
        length=torch.randint(1, L + 1, (b,), generator=g, dtype=torch.int32),
        game_type=torch.randint(0, 2, (b,), generator=g, dtype=torch.int32),
        mask=torch.tensor(mask))


MASKS = {
    "no rows": [[False] * 5, [False] * 3],
    "all rows": [[True] * 3, [True] * 2, [True] * 3],
    "scattered rows": [[False, True, False, True, True], [True, False, False], [False, True]],
    "more rows than the ring": [[True] * 9, [True, False] + [True] * 6, [False, True]],
}


@pytest.mark.parametrize("case", list(MASKS))
def test_masked_ring_write_equals_the_in_order_write(case):
    G = 4
    got = replay.create_buffer(G, L, D, A, device="cpu")
    want = replay.create_buffer(G, L, D, A, device="cpu")
    for i, mask in enumerate(MASKS[case]):
        finished = _finished(mask, 10 * i)
        replay.add_games(got, finished)
        _add_in_order(want, finished)
        for name in ("states", "policy", "value", "length", "game_type", "seq", "ptr",
                     "games_added"):
            assert torch.equal(getattr(got, name), getattr(want, name)), f"batch {i}: {name}"


def test_ring_counters_come_back_through_a_checkpoint(tmp_path):
    buf = replay.create_buffer(4, L, D, A, device="cpu")
    for i, mask in enumerate(MASKS["more rows than the ring"]):
        replay.add_games(buf, _finished(mask, i))
    tree = replay.to_tree(buf)
    assert (tree["ptr"], tree["games_added"]) == (int(buf.ptr), int(buf.games_added)) == (1, 17)
    save_checkpoint(str(tmp_path), 1, {"buffer": tree})
    restored, _ = restore_checkpoint(str(tmp_path), 1, {"buffer": tree}, device="cpu")
    back = replay.ReplayBuffer(**restored["buffer"])
    for name in ("states", "seq", "ptr", "games_added"):
        assert torch.equal(getattr(back, name), getattr(buf, name)), name
    assert back.num_games == 4


def test_run_while_outside_a_capture_reads_its_condition():
    """It stops where the condition turns false (returns False) or at its
    bound (returns True)."""
    x = torch.zeros(())
    assert not graphs.run_while(lambda: x < 3, lambda: x.add_(1), 10)
    assert float(x) == 3.0
    assert graphs.run_while(lambda: x < 100, lambda: x.add_(1), 2)
    assert float(x) == 5.0


def test_capture_refuses_a_state_on_the_cpu():
    env, params, step, variables = _setup(turns=2)
    sp = init_selfplay(env, B, torch.Generator().manual_seed(1), search_params=params)
    with pytest.raises(ValueError, match="CUDA device"):
        capture_selfplay_step(step, variables, sp)


def test_overflow_flags_are_per_thread():
    """A flag entered on one thread (as a capture does) collects no
    overflow of another thread's eager loop, which raises at once (the
    pipeline's asynchronous in-loop tests run eager searches on a worker
    thread)."""
    import concurrent.futures

    flag = torch.zeros((), dtype=torch.bool)
    with graphs.overflow_into(flag), concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(graphs.overflowed, torch.tensor(True), "a worker's loop")
        with pytest.raises(OverflowError, match="a worker's loop"):
            fut.result(timeout=60)
        graphs.overflowed(torch.tensor(False), "this thread's loop")
    assert not bool(flag)


def test_launch_counts_lose_no_update_across_threads():
    """The kernel wrappers' counter under 8 threads with a short switch
    interval: every increment lands."""
    import concurrent.futures
    import sys

    from nuzero_tpu_torch.ops.cuda import hexconv_kernel

    name = next(iter(hexconv_kernel.launch_count))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        hexconv_kernel.reset_launch_count()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(lambda: [hexconv_kernel.count_launch(name)
                                         for _ in range(5000)]) for _ in range(8)]
            for f in futs:
                f.result(timeout=120)
        assert hexconv_kernel.launch_count[name] == 8 * 5000
    finally:
        sys.setswitchinterval(old)
        hexconv_kernel.reset_launch_count()
