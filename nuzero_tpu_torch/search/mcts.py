"""Batched MCTS (PUCT) over array trees.

Counterpart of ``nuzero_tpu/search/mcts.py`` (behavioral target:
``Search/Explorer.py``), with the same semantics:

- PUCT score ``prior * sqrt(N_parent)/(1+N_child) * c + value_factor * q``
  with ``c = log((N_parent + pb_c_base + 1)/pb_c_base) + pb_c_init``; the
  value term is negated for player 1's decisions;
- backprop adds the absolute (player-0 perspective) value along the path;
- root noise is a multiplicative mix of gamma noise into the priors;
- the root evaluation is the search's first simulation; carried roots get
  one extra masked simulation;
- descents stop at ``MAX_PATH_DEPTH`` and report it in ``depth_capped``;
- argmax ties break toward the first index everywhere.

B games search at once and every simulation's leaves are evaluated in one
batched network call.  On the card the descent is one launch of its kernel
(``ops/cuda/csrc/search_descend.cu``, a warp per game).  Its plain version,
the CPU's path, is a loop over depth with per-game masks; the depth steps
after the first run through ``graphs.run_while`` on "some game still
descends", so that an eager descent stops at the first depth where no game
descends.  The trees are updated in place.

Where the JAX search computes ``x / constant``, XLA compiles a multiply by
the f32 reciprocal; this search does the same multiply, so that scores and
priors match the JAX search bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from nuzero_tpu_torch.ops.cuda.search_descend_kernel import search_descend_cuda
from nuzero_tpu_torch.search.tree import Tree, child_stats, init_tree, reset_trees
from nuzero_tpu_torch.utils import graphs
from nuzero_tpu_torch.utils.packing import make_packer

NEG_INF = -1e9

#: Descent path cap (``nuzero_tpu/search/mcts.py:MAX_PATH_DEPTH``).
MAX_PATH_DEPTH = 64

#: Rejection rounds of ``sample_gamma``.  Marsaglia–Tsang accepts a draw
#: with probability at least 0.9516 for every shape a >= 1 (the least at
#: a = 1; 0.9608 at a = 1.15, the root_dist_alpha 0.15 that the configs
#: use, boosted).  After 12 rounds the chance that any of B x A = 768 x 525
#: entries is still pending is at most 768 * 525 * (1 - 0.9516)**12 =
#: 6.6e-11.
GAMMA_ROUNDS = 12


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Static search configuration (ref search-config YAML schema)."""

    num_simulations: int = 100
    keep_subtree: bool = True
    pb_c_base: float = 10000.0
    pb_c_init: float = 1.15
    number_of_softmax_moves: int = 0
    epsilon_softmax_exploration: float = 0.04
    epsilon_random_exploration: float = 0.001
    value_factor: float = 1.0
    root_exploration_fraction: float = 0.2
    root_dist_alpha: float = 0.15
    root_dist_beta: float = 1.0
    # Node budget for trees carried across moves; 0 = 2*num_simulations+4.
    tree_capacity: int = 0


@dataclasses.dataclass
class SearchResults:
    action: torch.Tensor  # i32[B] chosen action
    policy_target: torch.Tensor  # f32[B, A] root child visits, normalized
    root_value: torch.Tensor  # f32[B] root mean value (static convention)
    root_visits: torch.Tensor  # i32[B]
    tree_nodes: torch.Tensor  # i32[B] allocated node count
    exploration_bias: torch.Tensor  # f32[B] final root bias
    children_per_node: torch.Tensor  # f32[B] avg materialized children
    depth_capped: torch.Tensor  # f32[B] fraction of capped descents


def sample_gamma(rng: torch.Generator, alpha: float, shape, device) -> torch.Tensor:
    """Gamma(alpha, 1) draws from ``rng``: Marsaglia–Tsang on alpha + 1,
    boosted by U^(1/alpha) when alpha < 1.  Every round draws the whole
    shape and each entry keeps its first accepted value, so the values are
    those of redrawing until all are accepted; the rounds are a fixed
    ``GAMMA_ROUNDS``, and an entry still pending after them is an overflow
    (``graphs.overflowed``), never a truncation."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(shape, device=device)
    pending = torch.ones(shape, dtype=torch.bool, device=device)
    for _ in range(GAMMA_ROUNDS):
        x = torch.randn(shape, generator=rng, device=device)
        u = torch.rand(shape, generator=rng, device=device)
        v = (1.0 + c * x) ** 3
        accept = (v > 0) & (
            torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v.clamp(min=1e-30))
        )
        out = torch.where(pending & accept, d * v, out)
        pending = pending & ~accept
    graphs.overflowed(pending.any(), f"the gamma sampler's {GAMMA_ROUNDS} rounds")
    if alpha < 1.0:
        u = torch.rand(shape, generator=rng, device=device)
        out = out * u.pow(1.0 / alpha)
    return out


class Draws:
    """The random numbers a search consumes, drawn from a generator.  Tests
    substitute an object with the same methods that replays recorded
    draws."""

    def gamma(self, rng, alpha: float, shape, device) -> torch.Tensor:
        return sample_gamma(rng, alpha, shape, device)

    def uniform(self, rng, shape, device) -> torch.Tensor:
        return torch.rand(shape, generator=rng, device=device)

    def gumbel(self, rng, shape, device) -> torch.Tensor:
        tiny = torch.finfo(torch.float32).tiny
        u = torch.rand(shape, generator=rng, device=device).clamp(min=tiny)
        return -torch.log(-torch.log(u))


def _f32_recip(c: float) -> float:
    return float(np.float32(1.0) / np.float32(c))


def _masked_priors(logits: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """softmax over ALL logits, mask, renormalize; uniform-over-legal
    fallback (ref ``Explorer.py:159-174``)."""
    p = torch.softmax(logits, dim=-1) * legal
    total = p.sum(-1, keepdim=True)
    n_legal = legal.sum(-1, keepdim=True).to(torch.float32)
    uniform = legal / n_legal.clamp(min=1.0)
    return torch.where(total > 0, p / torch.where(total > 0, total, 1.0), uniform)


def _exploration_bias(parent_visit: torch.Tensor, params: SearchParams):
    return (
        torch.log((parent_visit + params.pb_c_base + 1.0) * _f32_recip(params.pb_c_base))
        + params.pb_c_init
    )


def _puct_scores(tree: Tree, node: torch.Tensor, params: SearchParams):
    """f32[B, A] selection scores at each game's ``node``."""
    bi = torch.arange(node.shape[0], device=node.device)
    n = node.long()
    parent_visit = tree.visit[bi, n].to(torch.float32)
    c = _exploration_bias(parent_visit, params)
    cv, cvsum = child_stats(tree, node)
    cv = cv.to(torch.float32)
    q = torch.where(cv > 0, cvsum / cv.clamp(min=1.0), 0.0)
    # Static values: +1 good for player 0.  Negate for player 1's choice.
    sign = torch.where(tree.to_play[bi, n] == 1, -1.0, 1.0)
    u = tree.prior[bi, n] * torch.sqrt(parent_visit)[:, None] / (1.0 + cv) * c[:, None]
    score = u + (params.value_factor * sign)[:, None] * q
    return torch.where(tree.legal[bi, n], score, NEG_INF)


def _descend(tree: Tree, params: SearchParams, depth_cap: int):
    """Walk every game from its root to a frontier.  Returns (stop_node,
    sel_action, needs_alloc, path, capped); ``path`` [B, depth_cap] holds
    the visited nodes, ``N`` (out of range) where unused.

    A tree on the card takes one launch of the descent kernel
    (``search_descend_kernel.search_descend_cuda``), the same outputs bit for
    bit as the plain body and one graph node under capture; a tree on the
    CPU takes the plain body ``_descend_plain``."""
    if tree.visit.device.type != "cuda":
        return _descend_plain(tree, params, depth_cap)
    return search_descend_cuda(
        tree.root, tree.visit, tree.value_sum, tree.to_play, tree.expanded,
        tree.is_terminal, tree.prior, tree.legal, tree.child, depth_cap,
        params.pb_c_base, params.pb_c_init, params.value_factor)


def _descend_plain(tree: Tree, params: SearchParams, depth_cap: int):
    """``_descend``'s plain version: a loop over depth with per-game masks,
    the steps after the first under ``graphs.run_while``."""
    B, N = tree.visit.shape
    dev = tree.visit.device
    bi = torch.arange(B, device=dev)
    node = tree.root.clone()
    sel_action = torch.zeros(B, dtype=torch.int32, device=dev)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    path = torch.full((B, depth_cap), N, dtype=torch.int32, device=dev)
    depth = torch.zeros((B, 1), dtype=torch.int64, device=dev)

    def step():
        """One depth step, in place; a no-op once no game is active."""
        n = node.long()
        # Each column is written at its own depth only, so it still holds N.
        path.scatter_(1, depth, torch.where(active, node, N)[:, None])
        can_continue = tree.expanded[bi, n] & ~tree.is_terminal[bi, n]
        action = torch.argmax(_puct_scores(tree, node, params), dim=-1).to(torch.int32)
        action = torch.where(can_continue, action, 0)
        child = tree.child[bi, n, action.long()]
        follow = can_continue & (child != -1)
        node.copy_(torch.where(active & follow, child, node))
        sel_action.copy_(torch.where(active, action, sel_action))
        stopped.copy_(torch.where(active, ~follow, stopped))
        active.logical_and_(follow)
        depth.add_(1)

    step()
    graphs.run_while(active.any, step, depth_cap - 1)
    # A depth-capped exit re-contributes the frontier node's evaluation
    # without allocating (its path slot was never recorded).
    capped = ~stopped
    n = node.long()
    needs_alloc = (
        tree.expanded[bi, n]
        & ~tree.is_terminal[bi, n]
        & (tree.child[bi, n, sel_action.long()] == -1)
        & ~capped
    )
    return node, sel_action, needs_alloc, path, capped


def _backprop_path(tree: Tree, path, leaf, value, fresh, active) -> None:
    """Add ``value`` and a visit to every node on the recorded path plus a
    freshly allocated leaf (ref Explorer.py:132-135: absolute value, no
    sign alternation).  ``active=False`` drops the game's simulation.
    The edge credit of the JAX search is implied: child stats are read
    through ``child`` (see ``tree.py``)."""
    N = tree.visit.shape[1]
    extra = torch.where(fresh, leaf, N)
    nodes = torch.cat([path, extra[:, None]], dim=1)
    nodes = torch.where(active[:, None], nodes, N)
    live = nodes < N
    idx = nodes.clamp(max=N - 1).long()
    tree.visit.scatter_add_(1, idx, live.to(torch.int32))
    tree.value_sum.scatter_add_(1, idx, torch.where(live, value[:, None], 0.0))


def make_search_fn(
    env,
    apply_fn: Callable[[Any, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    params: SearchParams,
    training: bool,
    with_tree: bool = False,
    draws: Optional[Draws] = None,
):
    """Build the batched search function.

    ``apply_fn(variables, obs[B,C,H,W]) -> (logits[B,A], value[B])``.

    - ``with_tree=False``: ``search(variables, states, game_lengths, rng)
      -> SearchResults``; one fresh tree per move.
    - ``with_tree=True``: ``search(variables, states, game_lengths, rng,
      tree, carried) -> (SearchResults, tree)``; ``tree`` holds the batch
      of trees already re-rooted at the current positions and is updated
      in place; games where ``carried`` is False start from a fresh root.

    ``rng`` is a ``torch.Generator`` on the env's device; ``draws`` turns
    it into the search's random numbers (default ``Draws()``).
    """
    A = env.num_actions
    if with_tree:
        num_nodes = params.tree_capacity or (2 * params.num_simulations + 4)
    else:
        num_nodes = params.num_simulations + 1
    depth_cap = min(num_nodes - 1, env.max_game_length, MAX_PATH_DEPTH) + 1
    pack, unpack, state_dim = make_packer(env.init(1, generator=torch.Generator(env.device)))
    draws = draws or Draws()
    dev = env.device

    def evaluate_batch(variables, states_b):
        obs = env.observe(states_b)
        logits, value = apply_fn(variables, obs)
        legal = env.legal_mask(states_b)
        priors = _masked_priors(logits, legal)
        is_term = env.terminal(states_b)
        term_val = env.terminal_value(states_b)
        value = torch.where(is_term, term_val, value)
        return priors, legal, value, is_term, term_val

    def search(variables, states, game_lengths, rng, tree=None, carried=None):
        B = game_lengths.shape[0]
        bi = torch.arange(B, device=dev)
        if tree is None:
            tree = init_tree(B, A, num_nodes, state_dim, dev)
            fresh_games = torch.ones(B, dtype=torch.bool, device=dev)
        else:
            fresh_games = ~carried
            reset_trees(tree, fresh_games)

        # --- Root evaluation == the reference's first simulation on a
        # fresh root (expand + one backup), batched across games.
        priors0, legal0, value0, term0, tval0 = evaluate_batch(variables, states)
        frac = params.root_exploration_fraction
        noise = None
        if training:
            # One draw serves fresh and carried roots alike: each game
            # noises exactly one of them.
            noise = draws.gamma(rng, params.root_dist_alpha, (B, A), dev)
            noise = noise * params.root_dist_beta
            priors0 = torch.where(legal0, priors0 * (1.0 - frac) + noise * frac, 0.0)
        to_play0 = env.current_player(states)

        def set_root(table, value):
            table[:, 0] = torch.where(
                fresh_games.view((-1,) + (1,) * (value.dim() - 1)), value, table[:, 0]
            )

        set_root(tree.states, pack(states))
        set_root(tree.prior, priors0)
        set_root(tree.legal, legal0)
        set_root(tree.expanded, ~term0)
        set_root(tree.to_play, to_play0)
        set_root(tree.is_terminal, term0)
        set_root(tree.terminal_value, tval0)
        set_root(tree.visit, torch.ones_like(tree.visit[:, 0]))
        set_root(tree.value_sum, value0)

        if with_tree and carried is not None and training:
            # Noise the carried root's stored priors once, now that it has
            # become root (Explorer.py:46,201-210).
            root = tree.root.long()
            root_prior = tree.prior[bi, root]
            noisy = torch.where(
                tree.legal[bi, root], root_prior * (1.0 - frac) + noise * frac, 0.0
            )
            tree.prior[bi, root] = torch.where(carried[:, None], noisy, root_prior)

        # --- Remaining simulations.  Fresh roots spent their first on the
        # root evaluation; carried roots get one extra masked iteration.
        if with_tree and carried is not None:
            extra_active = carried
            n_iters = params.num_simulations
        else:
            extra_active = torch.zeros(B, dtype=torch.bool, device=dev)
            n_iters = params.num_simulations - 1
        all_active = torch.ones(B, dtype=torch.bool, device=dev)
        capped_count = torch.zeros(B, dtype=torch.int32, device=dev)

        for i in range(n_iters):
            active = all_active if i < params.num_simulations - 1 else extra_active
            stop_node, action, needs_alloc, path, capped = _descend(
                tree, params, depth_cap
            )
            # Full trees stop expanding and re-contribute the stop node.
            any_free = tree.free.any(-1)
            first_free = torch.argmax(tree.free.to(torch.int8), dim=-1).to(torch.int32)
            needs_alloc = needs_alloc & active & any_free

            # Allocate: step the stop node's stored state once.
            sn = stop_node.long()
            stop_state = unpack(tree.states[bi, sn])
            stepped = env.step(stop_state, action)
            leaf_packed = torch.where(needs_alloc[:, None], pack(stepped), tree.states[bi, sn])
            leaf_state = unpack(leaf_packed)
            ff = first_free.long()
            act = action.long()
            tree.child[bi, sn, act] = torch.where(needs_alloc, first_free, tree.child[bi, sn, act])
            tree.parent[bi, ff] = torch.where(needs_alloc, stop_node, tree.parent[bi, ff])
            tree.states[bi, ff] = torch.where(
                needs_alloc[:, None], leaf_packed, tree.states[bi, ff]
            )
            tree.free[bi, ff] = tree.free[bi, ff] & ~needs_alloc
            leaf = torch.where(needs_alloc, first_free, stop_node)

            # Evaluate all leaves in ONE batched network call.
            priors, legal, value, is_term, tval = evaluate_batch(variables, leaf_state)
            to_play = env.current_player(leaf_state)
            # Freshly allocated leaves get their metadata + expansion.
            lf = leaf.long()
            w1 = needs_alloc
            w2 = needs_alloc[:, None]
            tree.prior[bi, lf] = torch.where(w2, priors, tree.prior[bi, lf])
            tree.legal[bi, lf] = torch.where(w2, legal, tree.legal[bi, lf])
            tree.expanded[bi, lf] = torch.where(w1, ~is_term, tree.expanded[bi, lf])
            tree.to_play[bi, lf] = torch.where(w1, to_play, tree.to_play[bi, lf])
            tree.is_terminal[bi, lf] = torch.where(w1, is_term, tree.is_terminal[bi, lf])
            tree.terminal_value[bi, lf] = torch.where(w1, tval, tree.terminal_value[bi, lf])
            # Revisited terminal leaves contribute their terminal value.
            value = torch.where(
                tree.is_terminal[bi, lf], tree.terminal_value[bi, lf], value
            )
            _backprop_path(tree, path, leaf, value, needs_alloc, active)
            capped_count += (capped & active).to(torch.int32)

        # --- Policy target: normalized root-child visit counts.
        root = tree.root
        child_visits = child_stats(tree, root)[0].to(torch.float32)
        visit_sum = child_visits.sum(-1, keepdim=True)
        policy_target = child_visits / visit_sum.clamp(min=1.0)

        # --- Action selection (ref Explorer.py:70-97).
        legal_root = tree.legal[bi, root.long()]
        argmax_pick = torch.argmax(torch.where(legal_root, child_visits, -1.0), dim=-1)
        if training:
            soft_logits = torch.where(legal_root, child_visits, NEG_INF)
            softmax_pick = torch.argmax(soft_logits + draws.gumbel(rng, (B, A), dev), -1)
            eps = draws.uniform(rng, (B, 2), dev)
            rand_logits = torch.where(legal_root, 0.0, NEG_INF)
            random_pick = torch.argmax(rand_logits + draws.gumbel(rng, (B, A), dev), -1)
            action = torch.where(
                eps[:, 0] < params.epsilon_softmax_exploration,
                softmax_pick,
                torch.where(
                    eps[:, 1] < params.epsilon_random_exploration,
                    random_pick,
                    argmax_pick,
                ),
            )
            action = torch.where(
                game_lengths < params.number_of_softmax_moves, softmax_pick, action
            )
        else:
            action = argmax_pick
        action = action.to(torch.int32)

        root_visits = tree.visit[bi, root.long()]
        root_value = tree.value_sum[bi, root.long()] / root_visits.to(torch.float32).clamp(
            min=1.0
        )
        alloc = ~tree.free
        n_alloc = alloc.sum(-1).to(torch.int32)
        n_children = ((tree.child != -1).sum(-1) * alloc).sum(-1)
        children_per_node = n_children / n_alloc.to(torch.float32).clamp(min=1.0)
        results = SearchResults(
            action=action,
            policy_target=policy_target,
            root_value=root_value,
            root_visits=root_visits,
            tree_nodes=n_alloc,
            exploration_bias=_exploration_bias(root_visits.to(torch.float32), params),
            children_per_node=children_per_node.to(torch.float32),
            depth_capped=capped_count.to(torch.float32) * _f32_recip(max(n_iters, 1)),
        )
        if with_tree:
            return results, tree
        return results

    return search
