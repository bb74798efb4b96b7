"""Plain reference of the self-play cells: what the timed self-play wrote,
judged against the frozen SCS engine and the plain f32 net.

Two kinds of output are judged, both drawn from the seed after the window:

- **Search trees** (``judge_trees``).  Every node that a move allocated
  holds the env state it was stepped to, its legal mask and terminal flags,
  and the priors that the network gave it (the masked softmax of its
  logits).  For every allocated node but the root of each sampled game,
  the reference steps the parent's state by the edge's action and compares
  the packed state bit for bit; for every node, roots too, it recomputes
  the legal mask and terminal flags and evaluates the plain net on the
  node's observation.  Readings: the widest gap of a legal action's log
  prior (``prior_gap``, roots left out: their priors carry the search's
  noise); a node visited once holds the value it was given (``value_gap``);
  a node's visits are one plus its children's, more only where a full tree
  re-credited it, and a terminal node has no child (``visits_wrong``); and
  a node visited 2 to ``BACKUP_VISITS`` times holds in its value sum its
  own value, its children's sums and its re-credits (``backup_gap``: the
  search backs up the absolute value, with no change of sign).  Value gaps
  are root mean squares over the nodes, relative to that of the net's
  values in the sample.
- **Replay ring** (``judge_ring``).  Each sampled finished game starts at a
  fresh state of its victory-point layout, each position is reached from
  the one before by a legal action and none before the last is terminal, a
  legal action from the last ends the game with the value target stored at
  every position, and every policy target is the root's normalized child
  visits: whole counts on legal actions that sum to the total that the
  carried subtree and the move's simulations give.

Everything runs in blocks, in f32 with TF32 off.  Nothing here imports the
port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cardbench.reference import net as ref_net
from cardbench.reference.scs.game import SCSGame
from cardbench.reference.scs.packing import make_packer
from cardbench.reference.scs.scenario import scenario_from_dict

BLOCK = 16384
#: The most visits of a node whose value sum is checked (``backup_gap``).
BACKUP_VISITS = 16


@dataclasses.dataclass
class RefEnv:
    env: SCSGame
    pack: object
    unpack: object
    dim: int
    state_type: type


def make_env(scenario: dict, seed: int, randomize_vp: bool, device) -> RefEnv:
    env = SCSGame(scenario_from_dict(dict(scenario), seed=seed), randomize_vp=randomize_vp,
                  device=device)
    template = env.init(1, generator=torch.Generator(device))
    pack, unpack, dim = make_packer(template)
    return RefEnv(env, pack, unpack, dim, type(template))


def _blocks(n: int, size: int = BLOCK):
    for s in range(0, n, size):
        yield slice(s, min(n, s + size))


def _step_packed(ref: RefEnv, states: torch.Tensor, actions: torch.Tensor):
    """(packed successors, terminal flags, terminal values) of packed
    ``states`` [N, D] by ``actions`` [N], in blocks."""
    out, term, tval = [], [], []
    for sl in _blocks(states.shape[0]):
        nxt = ref.env.step(ref.unpack(states[sl, :ref.dim]), actions[sl].to(torch.int32))
        out.append(ref.pack(nxt))
        term.append(ref.env.terminal(nxt))
        tval.append(ref.env.terminal_value(nxt))
    if not out:
        d = states.device
        return (torch.zeros((0, ref.dim), device=d), torch.zeros(0, dtype=torch.bool, device=d),
                torch.zeros(0, device=d))
    return torch.cat(out), torch.cat(term), torch.cat(tval)


def _legal(ref: RefEnv, states: torch.Tensor) -> torch.Tensor:
    return torch.cat([ref.env.legal_mask(ref.unpack(states[sl, :ref.dim]))
                      for sl in _blocks(states.shape[0])]) if states.shape[0] else (
        torch.zeros((0, ref.env.num_actions), dtype=torch.bool, device=states.device))


def _children(tree: dict):
    """(visits, value sums in f64) of each node's children, summed: [G, N]."""
    child = tree["child"].long()
    G, N, A = child.shape
    has = child >= 0
    safe = child.clamp(min=0).view(G, N * A)
    cv = torch.where(has, tree["visit"].gather(1, safe).view(G, N, A), 0).sum(-1)
    cs = torch.where(has, tree["value_sum"].double().gather(1, safe).view(G, N, A),
                     0.0).sum(-1)
    return cv, cs, has.any(-1)


def judge_trees(tree: dict, ref: RefEnv, params, iterations: int, control=None) -> dict:
    """Readings of the sampled trees (``tree``: the port's ``Tree`` fields of
    the sampled games, batch-first).  ``control`` also evaluates the net one
    precision lower on the same nodes and gives its readings under
    ``"control"``."""
    free, root = tree["free"], tree["root"]
    G, N = free.shape
    dev = free.device
    visit = tree["visit"]
    idx = torch.arange(N, device=dev).expand(G, N)
    is_root = idx == root[:, None].long()
    alloc = ~free
    wrong = int((free & is_root).sum())

    # -- Edges: every allocated node but the root is its parent's step. ----
    nodes = alloc & ~is_root
    g, c = nodes.nonzero(as_tuple=True)
    p = tree["parent"][g, c].long()
    wrong += int((p < 0).sum())
    ok = p >= 0
    g, c, p = g[ok], c[ok], p[ok]
    wrong += int(free[g, p].sum())
    # The action of each edge: the parent's child slot that holds the node.
    hits = tree["child"][g, p] == c[:, None].to(tree["child"].dtype)
    wrong += int((hits.sum(-1) != 1).sum())
    one = hits.sum(-1) == 1
    g, c, p, a = g[one], c[one], p[one], hits[one].float().argmax(-1)
    nxt, term, tval = _step_packed(ref, tree["states"][g, p], a)
    wrong += int((nxt != tree["states"][g, c, :ref.dim]).any(-1).sum())
    wrong += int(((tval != tree["terminal_value"][g, c]) & term).sum())

    # -- Every allocated node, roots too: legal mask and terminal flag. ----
    ga, ca = alloc.nonzero(as_tuple=True)
    states = tree["states"][ga, ca]
    legal = _legal(ref, states)
    wrong += int((legal != tree["legal"][ga, ca]).any(-1).sum())
    term_a = torch.cat([ref.env.terminal(ref.unpack(states[sl, :ref.dim]))
                        for sl in _blocks(states.shape[0])]) if states.shape[0] else (
        torch.zeros(0, dtype=torch.bool, device=dev))
    tval_a = torch.cat([ref.env.terminal_value(ref.unpack(states[sl, :ref.dim]))
                        for sl in _blocks(states.shape[0])]) if states.shape[0] else (
        torch.zeros(0, device=dev))
    wrong += int((term_a != tree["is_terminal"][ga, ca]).sum())

    # -- Visits: a node's are its own one plus its children's, and more only
    # where a full tree re-credited it; a terminal node has no children. --
    cv, cs, has_child = _children(tree)
    v_a, cv_a = visit[ga, ca], cv[ga, ca]
    visits_wrong = int(((v_a < 1) | (~term_a & (v_a < 1 + cv_a))
                        | (term_a & has_child[ga, ca])).sum())

    # -- The net on every live node, as the reference computes it. --------
    live = ~term_a & (legal == tree["legal"][ga, ca]).all(-1)
    values = torch.where(term_a, tval_a.double(), 0.0)
    low_values = values.clone()
    out = {"transitions_wrong": wrong, "visits_wrong": visits_wrong, "prior_gap": 0.0,
           "value_gap": 0.0, "backup_gap": 0.0, "nodes_compared": 0, "values_compared": 0,
           "backups_compared": 0}
    low = {"prior_gap": 0.0, "value_gap": 0.0, "backup_gap": 0.0}
    if live.any():
        obs = torch.cat([ref.env.observe(ref.unpack(states[live][sl, :ref.dim]))
                         for sl in _blocks(int(live.sum()))])
        logits, v = ref_net.evaluate(params, obs, iterations)
        values[live] = v.double()
        want = ref_net.masked_log_priors(logits, legal[live])
        # Priors: every live node but the roots, whose priors carry noise.
        pr = ~is_root[ga, ca][live]
        gl, cl = ga[live][pr], ca[live][pr]
        got = torch.log(tree["prior"][gl, cl].double().clamp(min=1e-300))
        out["prior_gap"] = float(torch.where(legal[live][pr], (got - want[pr]).abs(), 0.0)
                                 .max()) if pr.any() else 0.0
        out["nodes_compared"] = int(pr.sum())
        if control is not None:
            lg_low, v_low = ref_net.evaluate(params, obs, iterations, control)
            low_values[live] = v_low.double()
            got_low = ref_net.masked_log_priors(lg_low, legal[live])
            low["prior_gap"] = float(torch.where(legal[live][pr], (got_low - want).abs()[pr],
                                                 0.0).max()) if pr.any() else 0.0
    # A node visited once holds the value it was given.
    single = live & (v_a == 1)
    # A node visited a few times: its value sum less its children's, less
    # its re-credits, is its own value.  (Few, so that f32 summation stays
    # under the net's own rounding.)
    few = (v_a >= 2) & (v_a <= BACKUP_VISITS) & (live | term_a)
    # Gaps are root mean squares over the nodes, relative to that of the
    # net's values: the widest single gap swings with the weights from seed
    # to seed, in the program and the control alike (the ``_max`` readings,
    # not compared).  Terminal values, often +-1, are left out of the scale.
    scale = float(values[live].pow(2).mean().sqrt().clamp(min=1e-30)) if live.any() else 1.0

    def rms(x):
        return float(x.pow(2).mean().sqrt()) / scale

    def widest(x):
        return float(x.abs().max()) / scale

    if single.any():
        err = tree["value_sum"][ga, ca][single].double() - values[single]
        low_err = low_values[single] - values[single]
        out.update(value_gap=rms(err), value_gap_max=widest(err))
        low.update(value_gap=rms(low_err), value_gap_max=widest(low_err))
    out["values_compared"] = int(single.sum())
    if few.any():
        # Each evaluation's share: a node re-credited r times holds its own
        # value 1 + r times.
        credits = (v_a - cv_a).double()[few]
        own = tree["value_sum"][ga, ca].double() - cs[ga, ca] - (v_a - cv_a) * values
        err, low_err = own[few] / credits, (low_values - values)[few]
        out.update(backup_gap=rms(err), backup_gap_max=widest(err))
        low.update(backup_gap=rms(low_err), backup_gap_max=widest(low_err))
    out["backups_compared"] = int(few.sum())
    if control is not None:
        out["control"] = low
    return out


def _target_fits(target: np.ndarray, legal: np.ndarray, totals) -> list:
    """The visit totals S among ``totals`` for which ``target`` is a root's
    normalized child visits: each entry S x target within 1e-3 of a whole
    count, the counts summing to S, nothing on an illegal action."""
    if (target < 0).any() or (target[~legal] != 0).any():
        return []
    t = target[target > 0].astype(np.float64)
    cand = np.array(sorted(s for s in totals if s >= 1), dtype=np.float64)
    if not cand.size or not t.size:
        return []
    counts = cand[:, None] * t[None, :]
    whole = np.rint(counts)
    ok = (np.abs(counts - whole) <= 1e-3).all(1) & (whole.sum(1) == cand) & (whole >= 1).all(1)
    return [int(x) for x in cand[ok]]


def judge_ring(ring: dict, ref: RefEnv, sims: int) -> dict:
    """Readings of the sampled ring games (``ring``: states [R, L, D],
    policy [R, L, A], value [R, L], length [R]) searched with ``sims``
    simulations a move: every game's start, every position's terminal flag
    and value target, every position's successor reachable by a legal
    action (the last's ending the game at the stored value), and every
    policy target a root's normalized child visits, the visit totals
    followed along the game from the carried subtrees."""
    states, policy, value, length = ring["states"], ring["policy"], ring["value"], ring["length"]
    R = length.shape[0]
    dev = length.device
    wrong = targets_wrong = 0
    if R == 0:
        return {"transitions_wrong": 0, "targets_wrong": 0, "ring_games": 0}
    # Fresh starts, each with its own victory-point layout.
    s0 = states[:, 0, :ref.dim]
    first = ref.unpack(s0)
    fresh = ref.env.init(R, vp=first.vp) if ref.env.randomize_vp else ref.env.init(R)
    wrong += int((ref.pack(fresh) != s0).any(-1).sum())

    L = states.shape[1]
    pos = torch.arange(L, device=dev)[None, :] < length[:, None].long()
    gi, ti = pos.nonzero(as_tuple=True)
    flat = states[gi, ti, :ref.dim]
    legal = _legal(ref, flat)
    # Positions are not terminal; the value target is the game's at each.
    wrong += int(torch.cat([ref.env.terminal(ref.unpack(flat[sl]))
                            for sl in _blocks(flat.shape[0])]).sum())
    wrong += int((value[gi, ti] != value[gi, 0]).sum())
    # Every legal successor of every position.
    pi, act = legal.nonzero(as_tuple=True)
    nxt, term, tval = _step_packed(ref, flat[pi], act)
    last = (ti == length[gi].long() - 1)[pi]
    g_next, t_next = gi[pi], (ti[pi] + 1).clamp(max=L - 1)
    # A non-final position: the successor is the next recorded position.
    match = (nxt == states[g_next, t_next, :ref.dim]).all(-1) & ~last & ~term
    # The final position: the action ends the game at the stored value.
    ends = last & term & (tval == value[gi[pi], 0])
    played = match | ends
    hit = torch.zeros(flat.shape[0], dtype=torch.int64, device=dev)
    hit = hit.index_add_(0, pi, played.long()) > 0
    wrong += int((~hit).sum())

    # Policy targets.  A move's search adds ``sims`` visits to a carried
    # root, of which its own first one is not a child's: the children's
    # total is S = c + sims - 1, c the played child's visits at the move
    # before (0 for a fresh tree).  A full tree re-credits a stop node
    # instead of growing, the root too, which lowers S: where the exact S
    # does not fit, any S below it may.
    actions = [[] for _ in range(flat.shape[0])]
    for i, a in zip(pi[played].tolist(), act[played].tolist()):
        actions[i].append(a)
    target = policy[gi, ti].double().cpu().numpy()
    legal_h = legal.cpu().numpy()
    row = 0
    full_tree = 0
    for game_len in length.tolist():
        carried = {0}
        for t in range(int(game_len)):
            exact = _target_fits(target[row + t], legal_h[row + t],
                                 {c + sims - 1 for c in carried})
            fits = exact or _target_fits(target[row + t], legal_h[row + t],
                                         {s for c in carried for s in range(1, c + sims - 1)})
            full_tree += int(not exact and bool(fits))
            if not fits:
                targets_wrong += int(game_len) - t
                break
            carried = {int(round(target[row + t][a] * total)) for total in fits
                       for a in actions[row + t]}
        row += int(game_len)
    return {"transitions_wrong": wrong, "targets_wrong": targets_wrong, "ring_games": R,
            "ring_positions": int(gi.numel()), "ring_successors": int(pi.numel()),
            "targets_from_full_trees": full_tree}
