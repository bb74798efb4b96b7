"""The port's batched MCTS against the JAX search, move for move.

Both searches evaluate positions with one deterministic stand-in net whose
outputs are bit-identical in both frameworks (logits and value looked up
in a fixed table by sub-phase, player and turn), so every descent, action,
visit count and tree slot must agree exactly.  With ``training=True`` the
port replays the JAX search's own gamma, gumbel and uniform draws."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuzero_tpu.envs.scs import SCSGame as JaxSCSGame
from nuzero_tpu.envs.scs import load_scenario as jax_load_scenario
from nuzero_tpu.search import mcts as jax_mcts
from nuzero_tpu.search.tree import reroot as jax_reroot
from nuzero_tpu.utils.packing import make_packer as jax_make_packer
from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.search import mcts
from nuzero_tpu_torch.search.tree import child_stats, reroot
from nuzero_tpu_torch.utils.packing import make_packer

torch.set_num_threads(2)

PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "scenarios", "open_field_5.yml",
)
B = 8


@functools.lru_cache(maxsize=None)
def _envs():
    jenv = JaxSCSGame(jax_load_scenario(PATH, seed=42))
    tenv = SCSGame(load_scenario(PATH, seed=42))
    return jenv, tenv


@functools.lru_cache(maxsize=None)
def _jax_search(sims, training, with_tree, max_depth, scatter_min):
    """The jitted JAX search, built once per configuration (the module
    constants are read when the search is built)."""
    jenv, _ = _envs()
    old = jax_mcts.MAX_PATH_DEPTH, jax_mcts.SCATTER_CREDIT_MIN_NODES
    jax_mcts.MAX_PATH_DEPTH, jax_mcts.SCATTER_CREDIT_MIN_NODES = max_depth, scatter_min
    try:
        search = jax_mcts.make_search_fn(
            jenv, _jax_net(jenv.scenario.turns), jax_mcts.SearchParams(num_simulations=sims),
            training, with_tree=with_tree,
        )
        return jax.jit(search)
    finally:
        jax_mcts.MAX_PATH_DEPTH, jax_mcts.SCATTER_CREDIT_MIN_NODES = old


def _table(env, seed=0, exact=False):
    """Stand-in net parameters: logits [K, A] and values [K] for
    K = 8 * (turns + 2) lookup keys.  Values are small dyadic fractions,
    so value sums are exact in any order.  Generic logits are small
    integers.  ``exact=True`` gives each key a power-of-two count of
    logit-0 actions and -1000 elsewhere: then every softmax sum, and
    every prior, is exact in any summation order (the two frameworks sum
    a row of 525 in different orders)."""
    rng = np.random.default_rng(seed)
    rows = 8 * (env.scenario.turns + 2)
    values = rng.choice([-0.5, -0.25, 0.0, 0.25, 0.5], size=rows).astype(np.float32)
    if not exact:
        logits = rng.integers(-3, 4, size=(rows, env.num_actions))
        return logits.astype(np.float32), values
    logits = np.full((rows, env.num_actions), -1000.0, np.float32)
    for r in range(rows):
        k = 2 ** int(rng.integers(0, 8))
        logits[r, rng.choice(env.num_actions, size=k, replace=False)] = 0.0
    return logits, values


def _jax_net(turns):
    def apply(params, obs):
        logits, values = params
        sub = jnp.argmax(obs[:, -6:-2, 0, 0], axis=-1)
        player = (obs[:, -1, 0, 0] < 0).astype(jnp.int32)
        turn = jnp.round(obs[:, -2, 0, 0] * turns).astype(jnp.int32)
        key = sub + 4 * player + 8 * turn
        return logits[key], values[key]

    return apply


def _torch_net(turns):
    def apply(params, obs):
        logits, values = params
        sub = torch.argmax(obs[:, -6:-2, 0, 0], dim=-1)
        player = (obs[:, -1, 0, 0] < 0).long()
        turn = torch.round(obs[:, -2, 0, 0] * turns).long()
        key = sub + 4 * player + 8 * turn
        return logits[key], values[key]

    return apply


def _params(table):
    return (
        tuple(jnp.asarray(t) for t in table),
        tuple(torch.from_numpy(t) for t in table),
    )


@functools.lru_cache(maxsize=None)
def _jax_env_fns():
    jenv, _ = _envs()
    return jax.jit(jax.vmap(jenv.step)), jax.jit(jax.vmap(jenv.legal_mask))


def _positions(jenv, steps, seed):
    """B JAX game states after ``steps`` random legal moves each."""
    step, legal_fn = _jax_env_fns()
    states = jax.vmap(jenv.init)(jax.random.split(jax.random.key(0), B))
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        legal = np.asarray(legal_fn(states))
        acts = np.array([rng.choice(np.flatnonzero(row)) for row in legal], np.int32)
        states = step(states, jnp.asarray(acts))
    return states


class _JaxDraws(mcts.Draws):
    """The draws the jitted JAX search makes from ``key``, in the order the
    port consumes them (gamma; then softmax gumbel, eps uniform, random
    gumbel)."""

    def __init__(self, key, A, alpha):
        @jax.jit
        def draws(key):
            rng, sub = jax.random.split(key)
            noise = jax.random.gamma(sub, alpha, (B, A))
            _, k_soft, k_eps, k_rand, _ = jax.random.split(rng, 5)
            return (
                noise,
                jax.random.gumbel(k_soft, (B, A)),
                jax.random.uniform(k_eps, (B, 2)),
                jax.random.gumbel(k_rand, (B, A)),
            )

        noise, g_soft, eps, g_rand = (torch.from_numpy(np.array(x)) for x in draws(key))
        self._gamma = noise
        self._queue = [g_soft, eps, g_rand]

    def gamma(self, rng, alpha, shape, device):
        return self._gamma

    def uniform(self, rng, shape, device):
        return self._queue.pop(0)

    def gumbel(self, rng, shape, device):
        return self._queue.pop(0)


def _assert_results(tres, jres, msg=""):
    for field in (
        "action", "policy_target", "root_value", "root_visits", "tree_nodes",
        "exploration_bias", "children_per_node", "depth_capped",
    ):
        np.testing.assert_array_equal(
            getattr(tres, field).numpy(), np.asarray(getattr(jres, field)),
            err_msg=f"{msg} {field}",
        )


def _assert_trees(ttree, jtree, msg="", noisy_priors=False):
    for field in (
        "visit", "value_sum", "parent", "to_play", "is_terminal",
        "terminal_value", "expanded", "legal", "child", "root", "free",
    ):
        np.testing.assert_array_equal(
            getattr(ttree, field).numpy(), np.asarray(getattr(jtree, field)),
            err_msg=f"{msg} {field}",
        )
    # Root noise: XLA on the CPU compiles p * (1 - f) + n * f into a fused
    # multiply-add and the port does not, so noised root priors may differ
    # by one f32 rounding (2^-24 relative); all other priors are exact.
    np.testing.assert_allclose(
        ttree.prior.numpy(), np.asarray(jtree.prior),
        rtol=2.0**-23 if noisy_priors else 0, atol=0, err_msg=f"{msg} prior",
    )
    # Node states: allocated slots only (free slots hold scratch writes).
    alloc = ~np.asarray(jtree.free)
    np.testing.assert_array_equal(
        ttree.states.numpy()[alloc], np.asarray(jtree.states)[alloc], err_msg=msg
    )
    # The JAX tree's dense edge stats == the port's child stats per node.
    N = ttree.visit.shape[1]
    for n in range(N):
        cv, cvs = child_stats(ttree, torch.full((B,), n, dtype=torch.int32))
        np.testing.assert_array_equal(cv.numpy(), np.asarray(jtree.child_visit)[:, n], msg)
        np.testing.assert_array_equal(cvs.numpy(), np.asarray(jtree.child_vsum)[:, n], msg)


@pytest.mark.parametrize(
    "steps,max_depth,jax_scatter",
    [(0, 64, False), (14, 64, False), (14, 1, False), (14, 64, True)],
    ids=["placement", "movement", "depth-capped", "jax-scatter-credit"],
)
def test_fresh_search_matches_jax(steps, max_depth, jax_scatter, monkeypatch):
    """``depth-capped`` binds MAX_PATH_DEPTH in both searches;
    ``jax-scatter-credit`` moves the JAX search to its scatter backprop
    (the port has one backprop for every tree size)."""
    monkeypatch.setattr(mcts, "MAX_PATH_DEPTH", max_depth)
    jenv, tenv = _envs()
    tparams = mcts.SearchParams(num_simulations=16)
    jparams, tparams_net = _params(_table(jenv))
    jsearch = _jax_search(16, False, False, max_depth, 0 if jax_scatter else 1024)
    tsearch = mcts.make_search_fn(tenv, _torch_net(tenv.scenario.turns), tparams, False)
    jstates = _positions(jenv, steps, seed=steps)
    jpack, _, _ = jax_make_packer(jenv.init(jax.random.key(0)))
    _, tunpack, _ = make_packer(tenv.init(1))
    tstates = tunpack(torch.tensor(np.asarray(jax.vmap(jpack)(jstates))))
    lengths = np.zeros(B, np.int32)
    jres = jsearch(jparams, jstates, jnp.asarray(lengths), jax.random.key(1))
    tres = tsearch(tparams_net, tstates, torch.from_numpy(lengths), None)
    _assert_results(tres, jres)
    assert (tres.depth_capped.numpy() > 0).any() == (max_depth == 1)
    # Every search played a legal root action.
    legal = tenv.legal_mask(tstates)
    assert legal[torch.arange(B), tres.action.long()].all()


@pytest.mark.parametrize("training", [False, True])
def test_carried_search_and_reroot_match_jax(training):
    """Three moves with subtree reuse: results, the whole tree after each
    search and after each reroot, and the carried flags."""
    jenv, tenv = _envs()
    params = jax_mcts.SearchParams(num_simulations=12)
    tparams = mcts.SearchParams(num_simulations=12)
    N = 2 * 12 + 4
    jparams, tparams_net = _params(_table(jenv, seed=1, exact=True))
    jsearch = _jax_search(12, training, True, 64, 1024)
    jreroot = jax.jit(jax.vmap(jax_reroot))
    jstep, _ = _jax_env_fns()
    jpack, _, D = jax_make_packer(jenv.init(jax.random.key(0)))
    _, tunpack, _ = make_packer(tenv.init(1))

    from nuzero_tpu.search.tree import init_tree as jax_init_tree
    from nuzero_tpu_torch.search.tree import init_tree

    jtree = jax.vmap(lambda _: jax_init_tree(jenv.num_actions, N, D))(jnp.arange(B))
    ttree = init_tree(B, tenv.num_actions, N, D)
    jstates = _positions(jenv, 10, seed=5)
    tstates = tunpack(torch.tensor(np.asarray(jax.vmap(jpack)(jstates))))
    carried = np.zeros(B, bool)
    lengths = np.zeros(B, np.int32)
    for move in range(3):
        key = jax.random.key(100 + move)
        draws = _JaxDraws(key, jenv.num_actions, params.root_dist_alpha) if training else None
        tsearch = mcts.make_search_fn(
            tenv, _torch_net(tenv.scenario.turns), tparams, training,
            with_tree=True, draws=draws,
        )
        jres, jtree = jsearch(
            jparams, jstates, jnp.asarray(lengths), key, jtree,
            jnp.asarray(carried),
        )
        tres, ttree = tsearch(
            tparams_net, tstates, torch.from_numpy(lengths), None,
            ttree, torch.tensor(carried),
        )
        _assert_results(tres, jres, f"move {move}")
        _assert_trees(ttree, jtree, f"move {move} search", training)
        jtree, jok = jreroot(jtree, jres.action)
        ttree, tok = reroot(ttree, tres.action)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        _assert_trees(ttree, jtree, f"move {move} reroot", training)
        carried = np.asarray(jok)
        jstates = jstep(jstates, jres.action)
        tstates = tenv.step(tstates, tres.action)
        lengths = lengths + 1
    assert carried.any()


def test_gamma_sampler_moments():
    """The generator-driven gamma sampler has Gamma(alpha, 1)'s mean and
    variance (both alpha) within 4 standard errors."""
    alpha, n = 0.15, 200_000
    x = mcts.sample_gamma(torch.Generator().manual_seed(0), alpha, (n,), "cpu")
    assert (x >= 0).all() and torch.isfinite(x).all()
    mean, var = float(x.mean()), float(x.var())
    assert abs(mean - alpha) < 4 * (alpha / n) ** 0.5
    # Var of the sample variance of Gamma(a): (6a + 2a^2)... bound loosely.
    assert abs(var - alpha) < 0.05 * alpha + 4 * ((6 * alpha + 2 * alpha**2) / n) ** 0.5
