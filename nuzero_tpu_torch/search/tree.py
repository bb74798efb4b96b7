"""Array-based search trees for a batch of games.

Counterpart of ``nuzero_tpu/search/tree.py``.  A batch of B trees is a
struct of batch-first tensors with a fixed node budget N per game:

- node stats are ``[B, N]`` (visit counts, value sums, ...),
- edges are ``[B, N, A]`` (priors, legal masks, child indices),
- each node's env state is a packed ``f32[D]`` row of ``states [B, N, D]``.

The JAX tree also keeps dense per-edge copies of the children's stats
(``child_visit``/``child_vsum``) because TPU gathers serialize; here a
node's child stats are read through ``child`` (``child_stats``), which
gives the same numbers: backprop credits a node and the edge into it
together.
"""

from __future__ import annotations

import dataclasses
import math

import torch

UNVISITED = -1


@dataclasses.dataclass
class Tree:
    visit: torch.Tensor  # i32[B, N] visit counts
    value_sum: torch.Tensor  # f32[B, N] sum of backed-up values
    parent: torch.Tensor  # i32[B, N] parent index, -1 at root
    to_play: torch.Tensor  # i32[B, N] player to move at this node
    is_terminal: torch.Tensor  # bool[B, N]
    terminal_value: torch.Tensor  # f32[B, N]
    expanded: torch.Tensor  # bool[B, N]: children priors computed
    prior: torch.Tensor  # f32[B, N, A] masked-renormalized priors
    legal: torch.Tensor  # bool[B, N, A] legal-action mask at each node
    child: torch.Tensor  # i32[B, N, A] child node index or -1
    states: torch.Tensor  # f32[B, N, D] packed env state per node
    root: torch.Tensor  # i32[B] current root slot
    free: torch.Tensor  # bool[B, N] slot unallocated


def init_tree(batch_size: int, num_actions: int, num_nodes: int,
              state_dim: int, device="cuda") -> Tree:
    """B fresh trees (root at slot 0, not yet expanded)."""
    B, N, A = batch_size, num_nodes, num_actions

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return Tree(
        visit=full((B, N), 0, torch.int32),
        value_sum=full((B, N), 0.0, torch.float32),
        parent=full((B, N), UNVISITED, torch.int32),
        to_play=full((B, N), 0, torch.int32),
        is_terminal=full((B, N), False, torch.bool),
        terminal_value=full((B, N), 0.0, torch.float32),
        expanded=full((B, N), False, torch.bool),
        prior=full((B, N, A), 0.0, torch.float32),
        legal=full((B, N, A), False, torch.bool),
        child=full((B, N, A), UNVISITED, torch.int32),
        states=full((B, N, state_dim), 0.0, torch.float32),
        root=full((B,), 0, torch.int32),
        free=(torch.arange(N, device=device) > 0).expand(B, N).clone(),
    )


def reset_trees(tree: Tree, games: torch.Tensor) -> None:
    """In place: return the trees of ``games`` (bool[B]) to ``init_tree``."""
    g = games.view(-1, 1)
    N = tree.visit.shape[1]
    idx = torch.arange(N, device=games.device)
    tree.visit.masked_fill_(g, 0)
    tree.value_sum.masked_fill_(g, 0.0)
    tree.parent.masked_fill_(g, UNVISITED)
    tree.to_play.masked_fill_(g, 0)
    tree.is_terminal.masked_fill_(g, False)
    tree.terminal_value.masked_fill_(g, 0.0)
    tree.expanded.masked_fill_(g, False)
    g3 = games.view(-1, 1, 1)
    tree.prior.masked_fill_(g3, 0.0)
    tree.legal.masked_fill_(g3, False)
    tree.child.masked_fill_(g3, UNVISITED)
    tree.states.masked_fill_(g3, 0.0)
    tree.root.masked_fill_(games, 0)
    tree.free.copy_(torch.where(g, idx > 0, tree.free))


def child_stats(tree: Tree, node: torch.Tensor):
    """(visits i32[B, A], value sums f32[B, A]) of ``node``'s children per
    game; 0 where no child is materialized."""
    bi = torch.arange(node.shape[0], device=node.device)
    child = tree.child[bi, node.long()]  # [B, A]
    has = child >= 0
    safe = child.clamp(min=0).long()
    visit = torch.where(has, tree.visit.gather(1, safe), 0)
    vsum = torch.where(has, tree.value_sum.gather(1, safe), 0.0)
    return visit, vsum


def reroot(tree: Tree, action: torch.Tensor) -> tuple[Tree, torch.Tensor]:
    """Re-root each game's tree at the child reached by ``action`` [B]
    (ref keep_subtree, ``Training/Gamer.py:78-79``).

    Node ids stay stable: the retained subtree is marked by pointer
    doubling over parent links, ``root`` moves to the chosen child, and
    every slot outside the subtree returns to the free list with its
    stats and edges cleared.  Returns ``(tree, ok)``; ``ok`` is False
    where the chosen action has no materialized child (the caller then
    starts that game's next search from a fresh tree).  Updates in place.
    """
    B, N = tree.visit.shape
    dev = tree.visit.device
    bi = torch.arange(B, device=dev)
    idx = torch.arange(N, device=dev, dtype=torch.int32).expand(B, N)
    c = tree.child[bi, tree.root.long(), action.long()]
    ok = c != UNVISITED
    c_safe = torch.where(ok, c, 0)

    mark = idx == c_safe[:, None]
    ptr = torch.where(tree.parent >= 0, tree.parent, idx).long()
    for _ in range(max(1, math.ceil(math.log2(max(N, 2))))):
        mark = mark | mark.gather(1, ptr)
        ptr = ptr.gather(1, ptr)

    # Free and clear everything outside the subtree.  The free list is a
    # union with the previous one: stale parent chains in freed slots may
    # mark spuriously, and a freed slot only comes back via the allocator.
    free = tree.free | ~mark
    # Sever the new root's parent link (its old ancestors are freed).
    tree.parent.copy_(
        torch.where(free | (idx == c_safe[:, None]), UNVISITED, tree.parent)
    )
    tree.visit.masked_fill_(free, 0)
    tree.value_sum.masked_fill_(free, 0.0)
    tree.expanded.masked_fill_(free, False)
    tree.child.masked_fill_(free[..., None], UNVISITED)
    tree.root.copy_(c_safe)
    tree.free.copy_(free)
    return tree, ok


def print_tree(tree: Tree, game_idx: int = 0, max_children: int = 8, file=None) -> str:
    """Host-side dump of game ``game_idx``'s tree (counterpart of the JAX
    ``print_tree``; ref ``Explorer.print_tree``, ``Search/Explorer.py:216``):
    a depth-indented listing of the allocated nodes from the root, children
    by descending visits, with visits, mean value, prior and the terminal
    flag.  Prints it and returns it."""
    import numpy as np

    def host(t):
        return t[game_idx].detach().cpu().numpy()

    visit, vsum, child = host(tree.visit), host(tree.value_sum), host(tree.child)
    prior, to_play, term = host(tree.prior), host(tree.to_play), host(tree.is_terminal)
    n_alloc = int((~host(tree.free)).sum())

    lines = [f"tree: {n_alloc} allocated nodes / {visit.shape[0]} capacity"]

    def rec(node, depth, via_action, via_prior):
        q = vsum[node] / max(int(visit[node]), 1)
        tag = " TERMINAL" if term[node] else ""
        via = f"a={via_action} p={via_prior:.3f} -> " if via_action is not None else ""
        lines.append(f"{'  ' * depth}{via}node {node}: n={int(visit[node])} "
                     f"q={q:+.3f} to_play={int(to_play[node])}{tag}")
        kids = [(int(child[node, a]), a) for a in np.flatnonzero(child[node] >= 0)]
        kids.sort(key=lambda ka: -int(visit[ka[0]]))
        for c, a in kids[:max_children]:
            rec(c, depth + 1, a, float(prior[node, a]))
        if len(kids) > max_children:
            lines.append(f"{'  ' * (depth + 1)}... {len(kids) - max_children} more children")

    if n_alloc > 0:
        rec(int(tree.root[game_idx]), 0, None, None)
    out = "\n".join(lines)
    print(out, file=file)
    return out
