"""Lockstep batched self-play (counterpart of
``nuzero_tpu/training/selfplay.py``; behavioral target: the reference's
``Gamer`` actors, ``Training/Gamer.py:39-97``).

One ``step`` plays one move in each of B games: a batched MCTS over all
games, the pre-move position and its search policy recorded into per-game
trajectory buffers, the envs stepped, finished games emitted as a
``FinishedGames`` batch and their slots reset, and the carried search
trees re-rooted at the played actions.

The trajectory buffers and trees are updated in place.  ``FinishedGames``
views the live buffers: consume or copy it before the next step, which
starts overwriting the rows of the games it reset.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from nuzero_tpu_torch.envs.base import select_state
from nuzero_tpu_torch.search.mcts import Draws, SearchParams, make_search_fn
from nuzero_tpu_torch.search.tree import Tree, init_tree, reroot
from nuzero_tpu_torch.training.replay import FinishedGames
from nuzero_tpu_torch.utils.packing import make_packer


@dataclasses.dataclass
class SelfplayState:
    games: Any  # env state batch [B]
    state_buf: torch.Tensor  # f32[B, L, D] packed env states per position
    policy_buf: torch.Tensor  # f32[B, L, A] search policy targets
    move_count: torch.Tensor  # i32[B] moves played in current game
    rng: torch.Generator
    total_moves: torch.Tensor  # i32 stats: lockstep move-steps taken
    total_games: torch.Tensor  # i32 stats: games completed since init
    # Subtree reuse (ref keep_subtree): trees carried across moves,
    # re-rooted at the played action.  None when reuse is disabled.
    tree: Optional[Tree] = None
    tree_valid: Optional[torch.Tensor] = None  # bool[B]


def _tree_capacity(params: SearchParams) -> int:
    return params.tree_capacity or (2 * params.num_simulations + 4)


def init_selfplay(
    env,
    batch_size: int,
    rng: torch.Generator,
    trajectory_capacity: int = 0,
    search_params: SearchParams | None = None,
) -> SelfplayState:
    """``trajectory_capacity`` bounds stored moves per game (0 = the env's
    ``max_game_length``); games that overrun are discarded and reset.
    ``search_params`` with ``keep_subtree=True`` allocates the carried
    search trees."""
    dev = env.device
    games = env.init(batch_size)
    L = trajectory_capacity or env.max_game_length
    _, _, D = make_packer(games)
    tree = None
    tree_valid = None
    if search_params is not None and search_params.keep_subtree:
        tree = init_tree(
            batch_size, env.num_actions, _tree_capacity(search_params), D, dev
        )
        tree_valid = torch.zeros(batch_size, dtype=torch.bool, device=dev)
    return SelfplayState(
        games=games,
        state_buf=torch.zeros((batch_size, L, D), device=dev),
        policy_buf=torch.zeros((batch_size, L, env.num_actions), device=dev),
        move_count=torch.zeros(batch_size, dtype=torch.int32, device=dev),
        rng=rng,
        total_moves=torch.zeros((), dtype=torch.int32, device=dev),
        total_games=torch.zeros((), dtype=torch.int32, device=dev),
        tree=tree,
        tree_valid=tree_valid,
    )


def make_selfplay_step(
    env,
    apply_fn: Callable,
    search_params: SearchParams,
    training: bool = True,
    draws: Optional[Draws] = None,
):
    """Build ``step(variables, sp) -> (sp, FinishedGames, stats)``: one
    move in every live game.  ``draws`` replaces the search's random
    numbers (tests)."""
    pack, _, _ = make_packer(env.init(1))
    search_fresh = make_search_fn(env, apply_fn, search_params, training, draws=draws)
    search_carry = make_search_fn(
        env, apply_fn, search_params, training, with_tree=True, draws=draws
    )
    tree_cap = _tree_capacity(search_params)
    fresh_games = {}

    @torch.no_grad()
    def step(variables, sp: SelfplayState):
        B = sp.move_count.shape[0]
        bi = torch.arange(B, device=env.device)
        if sp.tree is not None:
            res, tree = search_carry(
                variables, sp.games, sp.move_count, sp.rng, sp.tree, sp.tree_valid
            )
        else:
            res = search_fresh(variables, sp.games, sp.move_count, sp.rng)
            tree = None

        # Record the pre-move position (packed) + its search policy
        # (ref Gamer.py:65-66,74-77).
        L = sp.state_buf.shape[1]
        mc = sp.move_count.long()
        sp.state_buf[bi, mc] = pack(sp.games)
        sp.policy_buf[bi, mc] = res.policy_target

        stepped = env.step(sp.games, res.action)
        done = env.terminal(stepped)
        overflow = ~done & (sp.move_count + 1 >= L)
        finished = FinishedGames(
            states=sp.state_buf,
            policy=sp.policy_buf,
            final_value=env.terminal_value(stepped),
            length=sp.move_count + 1,
            game_type=torch.zeros(B, dtype=torch.int32, device=env.device),
            mask=done,
        )

        # Auto-reset finished games (and discard trajectory overflows).
        recycle = done | overflow
        if B not in fresh_games:
            fresh_games[B] = env.init(B)  # deterministic: computed once
        games = select_state(recycle, fresh_games[B], stepped)
        move_count = torch.where(recycle, 0, sp.move_count + 1)

        # Re-root the carried trees at the played actions; recycled games
        # and actions without a materialized child restart from a fresh
        # tree next move (ref Gamer.py:78-79 keep_subtree root swap).
        tree_valid = None
        if tree is not None:
            tree, ok = reroot(tree, res.action)
            tree_valid = ok & ~recycle

        stats = {
            "finished": done.sum(),
            "root_value_mean": res.root_value.mean(),
            "tree_nodes_mean": res.tree_nodes.to(torch.float32).mean(),
            # Fraction of games whose node budget bound this move.
            "tree_full_frac": (res.tree_nodes >= tree_cap).to(torch.float32).mean(),
            "exploration_bias_mean": res.exploration_bias.mean(),
            "children_per_node_mean": res.children_per_node.mean(),
            # Fraction of descents stopped by MAX_PATH_DEPTH.
            "depth_capped_frac": res.depth_capped.mean(),
        }
        new_sp = dataclasses.replace(
            sp,
            games=games,
            move_count=move_count,
            total_moves=sp.total_moves + B,
            total_games=sp.total_games + done.sum().to(torch.int32),
            tree=tree,
            tree_valid=tree_valid,
        )
        return new_sp, finished, stats

    return step
