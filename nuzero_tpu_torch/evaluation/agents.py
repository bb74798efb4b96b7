"""Agent zoo for evaluation (counterpart of ``nuzero_tpu/evaluation/agents.py``;
ref ``Testing/Agents/``).

Each agent exposes ``policy(env) -> choose(variables, states, lengths, rng)
-> actions i32[B]``: a batched action chooser over B concurrent games.

- ``RandomAgent``: uniform over the legal mask
  (ref ``Agents/Generic/RandomAgent.py:11-16``).
- ``PolicyAgent``: raw-network argmax with the reference's fallback chain:
  argmax; if illegal, mask the softmax and argmax; if the net puts zero
  mass on legal actions, uniform over legal
  (ref ``Agents/Generic/PolicyAgent.py:19-64``).
- ``MctsAgent``: eval-mode (argmax-visits, no noise) batched MCTS per move
  (ref ``Agents/Generic/MctsAgent.py:28-39``).
- ``GoalRushAgent``: the scripted SCS baseline rushing the nearest enemy
  victory point along a host Dijkstra distance field (the JAX package's
  re-design of ``Agents/SCS/GoalRushAgent.py``).

``rng`` is a ``torch.Generator`` on the env's device, from which an agent
draws what it needs.  In its place a tensor of the draws themselves may be
handed in (tests give the JAX agents' draws): the Gumbel noise [B, A] of a
uniform-over-legal pick, or GoalRush's uniform tie-break noise [B, A].

``Agent.set_cache`` gives an agent a host inference cache
(``utils/caches.py``) that ``choose_host``, the batch-of-one decision of
human games and visual tests, consults: it memoizes the chosen action by
the observation's bytes.  The batched arena path never consults it.
"""

from __future__ import annotations

import heapq
from typing import Callable

import numpy as np
import torch

from nuzero_tpu_torch.envs.scs.hexgrid import neighbor_tables
from nuzero_tpu_torch.search.mcts import SearchParams, make_search_fn

NEG_INF = -1e9


def _gumbel(rng, shape, device) -> torch.Tensor:
    """Gumbel(0, 1) noise drawn from ``rng``, or ``rng`` itself when it is
    a tensor of draws."""
    if isinstance(rng, torch.Tensor):
        return rng
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=rng, device=device).clamp(min=tiny)
    return -torch.log(-torch.log(u))


def uniform_legal(legal: torch.Tensor, rng) -> torch.Tensor:
    """One uniform draw over each row's legal actions (``jax.random.
    categorical`` over logits 0 / -1e9: argmax of logits + Gumbel noise)."""
    logits = torch.where(legal, 0.0, NEG_INF)
    return torch.argmax(logits + _gumbel(rng, legal.shape, legal.device), dim=-1)


class Agent:
    name: str = "agent"
    # Host inference cache of batch-of-one play (ref the Testing YAML's
    # per-agent Cache section, TestManager.py:282-295).
    cache = None

    def set_cache(self, cache) -> None:
        self.cache = cache

    def choose_host(self, env, state, variables, rng, move_count: int = 0) -> int:
        """One action for a single game (``state`` is a batch of one),
        memoized through ``self.cache`` when set: the reference caches
        batch-1 network outputs (``Explorer.py:137-160``); the eval-mode
        agents here are deterministic per position, so the chosen action is
        cached, one level up."""
        obs = None
        if self.cache is not None:
            obs = env.observe(state)[0].cpu().numpy()
            hit = self.cache.get(obs)
            if hit is not None:
                return int(hit)
        lengths = torch.full((1,), move_count, dtype=torch.int32, device=env.device)
        action = int(self.policy(env)(variables, state, lengths, rng)[0])
        if self.cache is not None:
            self.cache.put((obs, action))
        return action

    def policy(self, env) -> Callable:
        """Memoized batched action chooser for ``env``; the key includes what
        changes the chooser (the recurrent iteration count), never the
        parameters, which are arguments."""
        cache = self.__dict__.setdefault("_policy_cache", {})
        key = (id(env), self._policy_key())
        if key not in cache:
            cache[key] = self._build_policy(env)
        return cache[key]

    def _policy_key(self):
        return None

    def _build_policy(self, env) -> Callable:
        raise NotImplementedError

    # Sweep support (ref TestManager.test_from_config setters).
    def set_network(self, variables) -> None:
        pass

    def set_recurrent_iterations(self, iters: int) -> None:
        pass


class RandomAgent(Agent):
    name = "random"

    def _build_policy(self, env):
        def choose(variables, states, lengths, rng):
            return uniform_legal(env.legal_mask(states), rng).to(torch.int32)

        return choose


class _NetworkAgent(Agent):
    def __init__(self, manager, variables, recurrent_iterations: int = 2):
        self.manager = manager
        self.variables = variables
        self.recurrent_iterations = recurrent_iterations

    def set_network(self, variables):
        self.variables = variables

    def set_recurrent_iterations(self, iters):
        self.recurrent_iterations = int(iters)


class PolicyAgent(_NetworkAgent):
    name = "policy"

    def _policy_key(self):
        return self.recurrent_iterations

    def _build_policy(self, env):
        manager = self.manager
        iters = self.recurrent_iterations

        @torch.no_grad()
        def choose(variables, states, lengths, rng):
            logits, _, _ = manager.apply(variables, env.observe(states), iters_to_do=iters)
            legal = env.legal_mask(states)
            raw_argmax = torch.argmax(logits, dim=-1)
            raw_legal = legal.gather(1, raw_argmax[:, None])[:, 0]
            # Fallback 1: mask + renormalize (softmax over logits), argmax.
            probs = torch.softmax(logits, dim=-1) * legal
            masked_argmax = torch.argmax(probs, dim=-1)
            has_mass = probs.sum(-1) > 0
            # Fallback 2: uniform over legal.
            uniform = uniform_legal(legal, rng)
            action = torch.where(raw_legal, raw_argmax,
                                 torch.where(has_mass, masked_argmax, uniform))
            return action.to(torch.int32)

        return choose


class MctsAgent(_NetworkAgent):
    name = "mcts"

    def __init__(self, manager, variables, search_params: SearchParams,
                 recurrent_iterations: int = 2):
        super().__init__(manager, variables, recurrent_iterations)
        self.search_params = search_params

    def _policy_key(self):
        return (self.recurrent_iterations, self.search_params)

    def _build_policy(self, env):
        manager = self.manager
        iters = self.recurrent_iterations

        def net(variables, obs):
            p, v, _ = manager.apply(variables, obs, iters_to_do=iters)
            return p, v

        search = make_search_fn(env, net, self.search_params, training=False)

        @torch.no_grad()
        def choose(variables, states, lengths, rng):
            return search(variables, states, lengths, rng).action

        return choose


class GoalRushAgent(Agent):
    """SCS-only scripted baseline: rush the nearest enemy VP, attacking
    enemies that stand on the path.  Per sub-phase (the legal mask keeps
    actions to one sub-phase, so scores never compete across phases):

    - placement: uniform random;
    - movement: step to the neighbor with the lowest Dijkstra distance to
      the nearest enemy VP; no-move carries a slight malus;
    - choose target: target an adjacent enemy tile that is a forward step
      for one of this player's moved units (an adjacent moved unit sits at
      a larger distance than the enemy's tile); skip combat otherwise;
    - choose attackers: add attackers (uniformly) while any remain; confirm
      only when it is the sole legal action.
    """

    name = "goal_rush"

    def _build_policy(self, env):
        if getattr(env, "randomize_vp", False):
            raise ValueError(
                "GoalRushAgent precomputes Dijkstra fields from the scenario's static VP "
                "masks; it cannot play envs with randomize_vp=True (per-game VP draws)")
        dist = torch.from_numpy(self._distance_fields(env)).to(env.device)  # f32[2, R, C]
        R, C, K = env.R, env.C, env.K
        planes = env.action_space_shape[0]
        nbr_r, nbr_c = env.nbr_r.long(), env.nbr_c.long()

        @torch.no_grad()
        def choose(variables, states, lengths, rng):
            legal = env.legal_mask(states)
            B = legal.shape[0]
            my_dist = dist[env.current_player(states).long()]  # [B, R, C]
            scores = torch.zeros((B, planes, R, C), dtype=torch.float32, device=env.device)
            # -- movement: score by destination distance.
            for d in range(6):
                scores[:, 1 + d * K: 1 + (d + 1) * K] = my_dist[:, nbr_r[d], nbr_c[d]][:, None]
            # no-move: stay put, slight malus.
            scores[:, env.confirm_limit: env.confirm_limit + K] = (my_dist + 0.5)[:, None]
            # -- choose target: the legal no-fight planes mark this player's
            # moved units, so "enemy on the path" = a legal target cell
            # adjacent to a moved unit strictly farther from the VP.
            lp = legal.reshape(B, planes, R, C)
            moved = lp[:, env.no_move_limit: env.no_fight_limit].any(1)
            forward = torch.zeros((B, R, C), dtype=torch.bool, device=env.device)
            for d in range(6):
                m_nbr = moved[:, nbr_r[d], nbr_c[d]] & env.nbr_ok[d]
                d_nbr = my_dist[:, nbr_r[d], nbr_c[d]]
                forward = forward | (m_nbr & (d_nbr > my_dist))
            scores[:, env.movement_limit] = torch.where(forward, my_dist - 0.25, 1e7)
            # no-fight: skip combat (wins when no forward enemy exists).
            scores[:, env.no_move_limit: env.no_move_limit + K] = (my_dist + 0.5)[:, None]
            # -- choose attackers: adding an attacker always beats confirming.
            scores[:, env.target_limit: env.target_limit + K] = -10.0
            scores[:, env.attackers_limit] = 10.0
            flat = scores.reshape(B, -1)
            # Prefer a LOW score; uniform noise breaks ties (and makes
            # placement uniform-random).
            u = rng if isinstance(rng, torch.Tensor) else torch.rand(
                flat.shape, generator=rng, device=env.device)
            score = torch.where(legal, -flat - u * 0.01, NEG_INF)
            return torch.argmax(score, dim=-1).to(torch.int32)

        return choose

    @staticmethod
    def _distance_fields(env) -> np.ndarray:
        """Host Dijkstra over terrain entry costs to the nearest enemy VP
        (ref ``GoalRushAgent.py:119-158``) -> f32[2, R, C]; 1e6 where no
        enemy VP is reachable."""
        R, C = env.R, env.C
        cost = env.t_cost.cpu().numpy()
        vp = env.vp.cpu().numpy()
        dst_r, dst_c, valid = neighbor_tables(R, C)
        out = np.zeros((2, R, C), np.float32)
        for p in (0, 1):
            dist = np.full((R, C), np.inf)
            heap = []
            for (r, c) in np.argwhere(vp[1 - p]):  # enemy VP locations
                dist[r, c] = 0.0
                heapq.heappush(heap, (0.0, int(r), int(c)))
            while heap:
                d0, r, c = heapq.heappop(heap)
                if d0 > dist[r, c]:
                    continue
                for k in range(6):
                    if not valid[k, r, c]:
                        continue
                    nr, nc = dst_r[k, r, c], dst_c[k, r, c]
                    # Moving from the neighbor INTO (r, c) costs cost[r, c]:
                    # the search expands backwards from the targets.
                    nd = d0 + cost[r, c]
                    if nd < dist[nr, nc]:
                        dist[nr, nc] = nd
                        heapq.heappush(heap, (nd, int(nr), int(nc)))
            dist[np.isinf(dist)] = 1e6
            out[p] = dist
        return out
