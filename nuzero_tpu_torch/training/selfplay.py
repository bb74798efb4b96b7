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

On the card a move is captured once as a CUDA graph and replayed
(``capture_selfplay_step``): the move then runs with no host read, its
data-dependent loops held as while-nodes (``utils/graphs.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from nuzero_tpu_torch.envs.base import select_state
from nuzero_tpu_torch.search.mcts import Draws, SearchParams, make_search_fn
from nuzero_tpu_torch.search.tree import Tree, init_tree, reroot
from nuzero_tpu_torch.training.replay import FinishedGames
from nuzero_tpu_torch.utils import graphs
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
    state_dim: int = 0,
) -> SelfplayState:
    """``trajectory_capacity`` bounds stored moves per game (0 = the env's
    ``max_game_length``); games that overrun are discarded and reset.
    ``search_params`` with ``keep_subtree=True`` allocates the carried
    search trees.  ``state_dim`` widens the packed-state rows beyond this
    env's own width (0 = exactly this env's), so that several game types
    can share one replay buffer."""
    dev = env.device
    games = env.init(batch_size, generator=rng)
    L = trajectory_capacity or env.max_game_length
    _, _, env_dim = make_packer(games)
    D = max(state_dim, env_dim)
    tree = None
    tree_valid = None
    if search_params is not None and search_params.keep_subtree:
        tree = init_tree(
            batch_size, env.num_actions, _tree_capacity(search_params), env_dim, dev
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
    game_type: int = 0,
):
    """Build ``step(variables, sp) -> (sp, FinishedGames, stats)``: one
    move in every live game.  ``draws`` replaces the search's random
    numbers (tests); ``game_type`` tags the emitted games."""
    pack, _, env_dim = make_packer(env.init(1, generator=torch.Generator(env.device)))
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
        sp.state_buf[bi, mc, :env_dim] = pack(sp.games)
        sp.policy_buf[bi, mc] = res.policy_target

        stepped = env.step(sp.games, res.action)
        done = env.terminal(stepped)
        overflow = ~done & (sp.move_count + 1 >= L)
        finished = FinishedGames(
            states=sp.state_buf,
            policy=sp.policy_buf,
            final_value=env.terminal_value(stepped),
            length=sp.move_count + 1,
            game_type=torch.full((B,), game_type, dtype=torch.int32, device=env.device),
            mask=done,
        )

        # Auto-reset finished games (and discard trajectory overflows).
        recycle = done | overflow
        randomize_vp = getattr(env, "randomize_vp", False)
        if B not in fresh_games:
            # Deterministic: computed once.  With per-game layouts the rest
            # of a fresh state does not depend on the layout (no unit stands
            # at init), so it is cached around the static one.
            fresh_games[B] = (env.init(B, vp=env.vp.expand(B, -1, -1, -1)) if randomize_vp
                              else env.init(B))
        fresh = fresh_games[B]
        if randomize_vp:
            # New layouts for every slot, every move (fixed shapes, drawn from
            # sp.rng, no host read); only the recycled games take theirs.
            fresh = fresh.replace(vp=env.draw_vp(B, sp.rng))
        games = select_state(recycle, fresh, stepped)
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


def _rebuilt(sp: SelfplayState):
    """The tensors of ``sp`` that a step returns anew rather than updating
    in place."""
    yield from (getattr(sp.games, f.name) for f in dataclasses.fields(sp.games))
    yield from (sp.move_count, sp.total_moves, sp.total_games)
    if sp.tree_valid is not None:
        yield sp.tree_valid


def play_in_place(step, variables, sp: SelfplayState):
    """One move of ``step`` whose new state is copied back into ``sp``'s own
    tensors -> (FinishedGames, stats).  ``sp`` then stays the one state
    object of a run, as a CUDA graph of the move needs."""
    new, finished, stats = step(variables, sp)
    if new.tree is not sp.tree:
        raise AssertionError("the step replaced the search trees instead of updating them")
    for dst, src in zip(_rebuilt(sp), _rebuilt(new)):
        if dst is not src:
            dst.copy_(src)
    return finished, stats


def move_tensors(sp: SelfplayState, finished: FinishedGames, stats: dict) -> dict:
    """Every tensor that one move writes, by name, and the generator's
    state: what a replay of the move must reproduce.  ``finished.states``
    and ``.policy`` are ``sp``'s buffers and are named once."""
    out = {f"games.{k}": v for k, v in vars(sp.games).items()}
    if sp.tree is not None:
        out.update({f"tree.{k}": v for k, v in vars(sp.tree).items()})
    out.update({k: getattr(sp, k) for k in ("state_buf", "policy_buf", "move_count",
                                            "total_moves", "total_games", "tree_valid")
                if getattr(sp, k) is not None})
    out.update({f"finished.{k}": v for k, v in vars(finished).items()
                if k not in ("states", "policy")})
    out.update({f"stats.{k}": v for k, v in stats.items()})
    out["rng"] = sp.rng.get_state()
    return out


def copy_selfplay(sp: SelfplayState) -> SelfplayState:
    """A deep copy of ``sp``, generator state included."""
    rng = torch.Generator(device=sp.rng.device)
    rng.set_state(sp.rng.get_state())

    def copy(obj):
        return type(obj)(**{f.name: getattr(obj, f.name).clone()
                            for f in dataclasses.fields(obj)})

    return dataclasses.replace(
        sp, games=copy(sp.games), state_buf=sp.state_buf.clone(),
        policy_buf=sp.policy_buf.clone(), move_count=sp.move_count.clone(), rng=rng,
        total_moves=sp.total_moves.clone(), total_games=sp.total_games.clone(),
        tree=None if sp.tree is None else copy(sp.tree),
        tree_valid=None if sp.tree_valid is None else sp.tree_valid.clone(),
    )


class SelfplayGraph:
    """One self-play move captured as a CUDA graph (``capture_selfplay_step``).

    ``replay()`` plays one move of every game of ``sp`` in place and returns
    ``(FinishedGames, stats)``: tensors the graph owns, which the next
    replay overwrites.  The graph reads its own parameter dict, ``params``;
    ``load_params`` copies a learner's parameters into it.  ``overflow`` is
    the move's device flag, set where a bounded loop ran out of trips;
    ``check_overflow()`` reads it and raises.  Nothing is read on the host
    inside a replay."""

    def __init__(self, graph, params, sp, finished, stats, overflow):
        self.graph = graph
        self.params = params
        self.sp = sp
        self.finished = finished
        self.stats = stats
        self.overflow = overflow

    def load_params(self, variables) -> None:
        for name, t in self.params.items():
            t.copy_(variables[name])

    def replay(self):
        self.graph.replay()
        return self.finished, self.stats

    def check_overflow(self) -> None:
        if bool(self.overflow):
            raise OverflowError("self-play move: a loop bounded for the CUDA graph ran past "
                                "its bound")


def capture_selfplay_step(step, variables, sp: SelfplayState, pool=None) -> SelfplayGraph:
    """Capture one move of ``step`` (from ``make_selfplay_step``) on ``sp``
    as a CUDA graph; ``sp`` must lie on a CUDA device, and a failed capture
    raises.  ``variables`` gives the graph's parameters their values and
    shapes; ``pool`` (``torch.cuda.graph_pool_handle()``) lets graphs that
    never run at once share memory.

    One eager move of a copy of ``sp`` runs first, on a side stream, as
    ``torch.cuda.graphs`` asks: it builds the kernels and fills the step's
    fresh-game cache.  It plays the first replay's move, so an overflow it
    meets the first replay reports; its own flag is dropped.  ``sp`` and
    its generator are left as they were, and the generator is registered
    with the graph, so replay k plays what the eager step's k-th move from
    ``sp`` would."""
    dev = sp.move_count.device
    if dev.type != "cuda":
        raise ValueError(f"a CUDA graph of the move needs its state on a CUDA device, not {dev}")
    params = {name: t.detach().clone() for name, t in variables.items()}
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        dropped = torch.zeros((), dtype=torch.bool, device=dev)
        with torch.cuda.stream(side), graphs.overflow_into(dropped):
            step(params, copy_selfplay(sp))
        torch.cuda.current_stream().wait_stream(side)
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(sp.rng)
        with graphs.capture(graph, pool=pool, overflow=overflow):
            finished, stats = play_in_place(step, params, sp)
    return SelfplayGraph(graph, params, sp, finished, stats, overflow)
