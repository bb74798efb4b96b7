"""The port's Tic-Tac-Toe against the JAX env as the oracle, and search and
self-play on it against the JAX search and self-play step.

Lockstep random playouts (illegal and post-terminal moves included, both
envs are total) must agree in every state field exactly.  Search and
self-play evaluate positions with one deterministic stand-in net whose
outputs are bit-identical in both frameworks: logits and value looked up
in a table by the board's base-3 code, each row with a power-of-two count
of logit-0 actions and -1000 elsewhere, so that every softmax sum is exact
in any order (the protocol of ``tests/test_torch_search.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuzero_tpu.envs import TicTacToe as JaxTicTacToe
from nuzero_tpu.search import mcts as jax_mcts
from nuzero_tpu.training.selfplay import init_selfplay as jax_init_selfplay
from nuzero_tpu.training.selfplay import make_selfplay_step as jax_make_selfplay_step
from nuzero_tpu.utils.packing import make_packer as jax_make_packer
from nuzero_tpu_torch.envs.tictactoe import TicTacToe
from nuzero_tpu_torch.search import mcts
from nuzero_tpu_torch.training.selfplay import init_selfplay, make_selfplay_step
from nuzero_tpu_torch.utils.packing import make_packer

torch.set_num_threads(2)

B = 8
FIELDS = ("board", "current_player", "length", "terminal", "terminal_value")
POW3 = (3 ** np.arange(9)).astype(np.float32).reshape(3, 3)


def stand_in_table(seed=0):
    """Logits [3^9, 9] and values [3^9] of the stand-in net."""
    rng = np.random.default_rng(seed)
    rows = 3 ** 9
    logits = np.full((rows, 9), -1000.0, np.float32)
    for r in range(rows):
        logits[r, rng.choice(9, size=2 ** int(rng.integers(0, 4)), replace=False)] = 0.0
    values = rng.choice([-0.5, -0.25, 0.0, 0.25, 0.5], size=rows).astype(np.float32)
    return logits, values


def jax_stand_in(params, obs):
    logits, values = params
    key = ((obs[:, 0] + 2.0 * obs[:, 1]) * POW3).sum((1, 2)).astype(jnp.int32)
    return logits[key], values[key]


def torch_stand_in(params, obs):
    logits, values = params
    key = ((obs[:, 0] + 2.0 * obs[:, 1]) * torch.from_numpy(POW3)).sum((1, 2)).long()
    return logits[key], values[key]


@functools.lru_cache(maxsize=None)
def _params(seed=0):
    table = stand_in_table(seed)
    return tuple(jnp.asarray(t) for t in table), tuple(torch.from_numpy(t) for t in table)


def _assert_states(tstate, jstate, msg=""):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)),
                                      err_msg=f"{msg} {f}")


@pytest.mark.parametrize("seed,legal_only", [(0, True), (1, True), (2, False)])
def test_lockstep_playout_matches_jax(seed, legal_only):
    """B random playouts of 12 moves (past the end of every game):
    legal-only moves, or any cell at all (occupied cells and terminal
    games step too, as the JAX env's total step does)."""
    jenv, tenv = JaxTicTacToe(), TicTacToe(device="cpu")
    assert (tenv.num_actions, tenv.observation_shape, tenv.max_game_length) == (
        jenv.num_actions, jenv.observation_shape, jenv.max_game_length)
    jstep, jlegal = jax.jit(jax.vmap(jenv.step)), jax.jit(jax.vmap(jenv.legal_mask))
    jobs = jax.jit(jax.vmap(jenv.observe))
    jstate = jax.vmap(jenv.init)(jax.random.split(jax.random.key(0), B))
    tstate = tenv.init(B)
    rng = np.random.default_rng(seed)
    for move in range(12):
        _assert_states(tstate, jstate, f"move {move}")
        legal = np.asarray(jlegal(jstate))
        np.testing.assert_array_equal(tenv.legal_mask(tstate).numpy(), legal)
        np.testing.assert_array_equal(tenv.observe(tstate).numpy(), np.asarray(jobs(jstate)))
        acts = np.array([rng.choice(np.flatnonzero(row)) if legal_only and row.any()
                         else rng.integers(0, 9) for row in legal], np.int32)
        jstate = jstep(jstate, jnp.asarray(acts))
        tstate = tenv.step(tstate, torch.from_numpy(acts))
    _assert_states(tstate, jstate, "end")
    assert tstate.terminal.all() if legal_only else True
    # The packed layout matches the JAX packer's.
    jpack, _, jdim = jax_make_packer(jenv.init(None))
    tpack, tunpack, tdim = make_packer(tenv.init(1))
    assert tdim == jdim
    np.testing.assert_array_equal(tpack(tstate).numpy(), np.asarray(jax.vmap(jpack)(jstate)))
    _assert_states(tunpack(tpack(tstate)), jstate, "unpacked")


def test_wins_draws_and_render():
    """Player 0 takes the top row, player 1 the anti-diagonal, and a draw."""
    env = TicTacToe(device="cpu")
    games = {(0, 3, 1, 4, 2): 1.0, (0, 2, 1, 4, 8, 6): -1.0, (0, 4, 8, 1, 7, 6, 2, 5, 3): 0.0}
    for moves, value in games.items():
        s = env.init(1)
        for i, a in enumerate(moves):
            assert not bool(s.terminal[0]) and bool(env.legal_mask(s)[0, a])
            s = env.step(s, torch.tensor([a]))
            assert int(s.current_player[0]) == (i + 1) % 2
        assert bool(s.terminal[0]) and float(s.terminal_value[0]) == value
        assert not env.legal_mask(s).any()
    assert env.render(env.step(env.init(1), torch.tensor([4])), 0).splitlines()[2] == \
        "   | O |   "
    assert env.init(2).board.dtype == torch.int8 and env.init(2).board.shape == (2, 3, 3)


@functools.lru_cache(maxsize=None)
def _jax_search(sims, training, with_tree):
    return jax.jit(jax_mcts.make_search_fn(
        JaxTicTacToe(), jax_stand_in, jax_mcts.SearchParams(num_simulations=sims), training,
        with_tree=with_tree))


def _positions(steps, seed):
    """B JAX states after ``steps`` (< 5, so no game has ended) random legal
    moves each, and the port's copies."""
    jenv, tenv = JaxTicTacToe(), TicTacToe(device="cpu")
    jstate = jax.vmap(jenv.init)(jax.random.split(jax.random.key(0), B))
    tstate = tenv.init(B)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        legal = tenv.legal_mask(tstate).numpy()
        acts = np.array([rng.choice(np.flatnonzero(r)) for r in legal], np.int32)
        jstate = jax.vmap(jenv.step)(jstate, jnp.asarray(acts))
        tstate = tenv.step(tstate, torch.from_numpy(acts))
    return jstate, tstate


class _JaxDraws(mcts.Draws):
    """The draws the jitted JAX search makes from ``key``, in the order the
    port consumes them (gamma; then softmax gumbel, eps uniform, random
    gumbel)."""

    def __init__(self, key, alpha):
        rng, sub = jax.random.split(key)
        self._gamma = torch.from_numpy(np.array(jax.random.gamma(sub, alpha, (B, 9))))
        _, k_soft, k_eps, k_rand, _ = jax.random.split(rng, 5)
        self._queue = [torch.from_numpy(np.array(x)) for x in (
            jax.random.gumbel(k_soft, (B, 9)), jax.random.uniform(k_eps, (B, 2)),
            jax.random.gumbel(k_rand, (B, 9)))]

    def gamma(self, rng, alpha, shape, device):
        return self._gamma

    def uniform(self, rng, shape, device):
        return self._queue.pop(0)

    def gumbel(self, rng, shape, device):
        return self._queue.pop(0)


@pytest.mark.parametrize("steps,training", [(0, False), (4, False), (3, True)])
def test_search_matches_jax(steps, training):
    jparams, tparams = _params()
    jstates, tstates = _positions(steps, seed=steps)
    lengths = np.full(B, steps, np.int32)
    key = jax.random.key(7)
    draws = _JaxDraws(key, jax_mcts.SearchParams().root_dist_alpha) if training else None
    tsearch = mcts.make_search_fn(TicTacToe(device="cpu"), torch_stand_in,
                                  mcts.SearchParams(num_simulations=24), training, draws=draws)
    jres = _jax_search(24, training, False)(jparams, jstates, jnp.asarray(lengths), key)
    tres = tsearch(tparams, tstates, torch.from_numpy(lengths), None)
    for field in ("action", "root_visits", "tree_nodes", "children_per_node", "depth_capped",
                  "root_value", "exploration_bias"):
        np.testing.assert_array_equal(getattr(tres, field).numpy(),
                                      np.asarray(getattr(jres, field)), err_msg=field)
    np.testing.assert_array_equal(tres.policy_target.numpy(), np.asarray(jres.policy_target))


@pytest.mark.parametrize("training", [False, True])
def test_selfplay_matches_jax(training):
    """Six moves of B games with subtree reuse: positions, policy rows,
    move counts, finished games and tree structure exactly; with
    ``training=True`` the port replays the JAX step's own draws."""
    sims = 12
    jenv, tenv = JaxTicTacToe(), TicTacToe(device="cpu")
    jparams, tparams = _params(1)
    jsp_params = jax_mcts.SearchParams(num_simulations=sims)
    tsp_params = mcts.SearchParams(num_simulations=sims)
    jstep = jax.jit(jax_make_selfplay_step(jenv, jax_stand_in, jsp_params, training=training))
    jsp = jax_init_selfplay(jenv, B, jax.random.key(1), search_params=jsp_params)
    tsp = init_selfplay(tenv, B, torch.Generator().manual_seed(1), search_params=tsp_params)
    jpack, _, _ = jax_make_packer(jenv.init(None))
    tpack, _, _ = make_packer(tsp.games)
    finished_total = 0
    for move in range(6):
        draws = None
        if training:
            _, k_search, _ = jax.random.split(jsp.rng, 3)
            draws = _JaxDraws(k_search, jsp_params.root_dist_alpha)
        tstep = make_selfplay_step(tenv, torch_stand_in, tsp_params, training=training,
                                   draws=draws)
        jsp, jfin, jstats = jstep(jparams, jsp)
        tsp, tfin, tstats = tstep(tparams, tsp)
        msg = f"move {move}"
        np.testing.assert_array_equal(tpack(tsp.games).numpy(),
                                      np.asarray(jax.vmap(jpack)(jsp.games)), msg)
        for name in ("state_buf", "policy_buf", "move_count", "tree_valid"):
            np.testing.assert_array_equal(getattr(tsp, name).numpy(),
                                          np.asarray(getattr(jsp, name)), f"{msg} {name}")
        for name in ("mask", "final_value", "length"):
            np.testing.assert_array_equal(getattr(tfin, name).numpy(),
                                          np.asarray(getattr(jfin, name)), f"{msg} {name}")
        for field in ("visit", "value_sum", "parent", "child", "root", "free"):
            np.testing.assert_array_equal(getattr(tsp.tree, field).numpy(),
                                          np.asarray(getattr(jsp.tree, field)),
                                          err_msg=f"{msg} tree.{field}")
        # The stats are means over the batch: the two frameworks sum B f32
        # O(1) terms in another order (a few f32 rounding steps apart).
        np.testing.assert_array_equal(int(tstats["finished"]), int(jstats["finished"]))
        for k, v in jstats.items():
            np.testing.assert_allclose(float(tstats[k]), float(v), rtol=2.0**-21, atol=1e-6,
                                       err_msg=k)
        finished_total += int(tfin.mask.sum())
    assert finished_total > 0 and int(tsp.total_games) == finished_total
