"""SCS hex-grid wargame as a batch-first PyTorch state machine.

Counterpart of ``nuzero_tpu/envs/scs/game.py`` (behavioral target:
``Games/SCS/SCS_Game.py`` of the reference).  Same fixed-capacity array
model: units live in a flat table indexed by ``player * S + schedule_slot``;
the board is a ``[R, C, K]`` table of unit ids in stacking order (level 0
= bottom), -1 where empty.  Every tensor carries a leading batch dimension.

Where the JAX engine maps one game and dispatches ``step`` through
``lax.switch`` over seven appliers, ``step`` here evaluates all seven
appliers on the whole batch and selects per game by the decoded action
kind; every applier is total on any decoded (r, c, level, direction).  The
stage machine (``_update_env``) loops ``advance`` until no game advanced.
Neighbor reads are plain gathers through the static neighbor tables.

Not ported yet: ``randomize_vp``, ``simple_state`` and the render helpers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nuzero_tpu_torch.envs.base import Env, select_state
from nuzero_tpu_torch.envs.scs.hexgrid import neighbor_tables
from nuzero_tpu_torch.envs.scs.scenario import Scenario

N_STATS = 3  # attack, defense, movement (ref SCS_Game.py:76)
N_STATUSES = 3  # available, moved, attacked (ref SCS_Game.py:75)
N_REINF_SHOWN = 3  # reinforcements represented in the state (ref :202)
SUB_PHASES = 4

I32 = torch.int32
F32 = torch.float32


@dataclasses.dataclass
class SCSState:
    """Batch of B games; fields in the JAX ``SCSState`` declaration order
    (the packed layout follows it)."""

    board: torch.Tensor  # i32[B, R, C, K] unit ids, -1 empty, level 0 = bottom
    alive: torch.Tensor  # bool[B, 2S]
    placed: torch.Tensor  # bool[B, 2S]
    row: torch.Tensor  # i32[B, 2S]
    col: torch.Tensor  # i32[B, 2S]
    mov: torch.Tensor  # f32[B, 2S] movement points left
    status: torch.Tensor  # i32[B, 2S] 0 avail / 1 moved / 2 attacked
    reinf_next: torch.Tensor  # i32[B, 2] next schedule slot per player
    turn: torch.Tensor  # i32[B]
    stage: torch.Tensor  # i32[B] in [-2, 7]
    length: torch.Tensor  # i32[B]
    terminal: torch.Tensor  # bool[B]
    terminal_value: torch.Tensor  # f32[B]
    has_target: torch.Tensor  # bool[B]
    target_row: torch.Tensor  # i32[B]
    target_col: torch.Tensor  # i32[B]
    is_attacker: torch.Tensor  # bool[B, 2S]
    attacker_seq: torch.Tensor  # i32[B, 2S] selection order, big when unset
    n_attackers: torch.Tensor  # i32[B]
    vp: torch.Tensor  # bool[B, 2, R, C] victory-point masks

    def replace(self, **changes) -> "SCSState":
        return dataclasses.replace(self, **changes)


def _stage_player(stage: torch.Tensor) -> torch.Tensor:
    """{-2,0,1,2,3} -> 0; {-1,4,5,6,7} -> 1 (ref SCS_Game.py:783-789)."""
    return ((stage == -1) | (stage >= 4)).to(I32)


def _stage_sub_phase(stage: torch.Tensor) -> torch.Tensor:
    """(ref SCS_Game.py:833-843)."""
    sub = torch.full_like(stage, 3)
    sub = torch.where((stage == 2) | (stage == 6), 2, sub)
    sub = torch.where((stage == 1) | (stage == 5), 1, sub)
    return torch.where(
        (stage == -2) | (stage == -1) | (stage == 0) | (stage == 4), 0, sub
    ).to(I32)


def _recip(c) -> float:
    """f32-rounded 1 / c.  XLA compiles a division by a constant into a
    multiplication by its f32 reciprocal, which rounds differently from
    the division; the port multiplies too, so observations and values
    match the JAX engine bit for bit."""
    return float(np.float32(1.0) / np.float32(c))


def _col(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """[B] -> [B, 1, ..., 1] with ``ndim`` dims, for broadcasting."""
    return v.view((-1,) + (1,) * (ndim - 1))


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per game ``table[b, idx[b, ...]]`` for a [B, N] table."""
    B = table.shape[0]
    out = torch.gather(table, 1, idx.reshape(B, -1).long())
    return out.reshape(idx.shape)


class SCSGame(Env):
    """One instance binds one scenario, like the reference's
    ``SCS_Game(config_path, seed)``; the tensors live on ``device``."""

    def __init__(self, scenario: Scenario, device="cpu"):
        self.scenario = scenario
        self.device = torch.device(device)
        R, C, K = scenario.rows, scenario.cols, scenario.stacking_limit
        self.R, self.C, self.K = R, C, K
        self.S = scenario.units_per_player
        self.U = 2 * self.S

        # Action planes (ref SCS_Game.py:147-180).
        self.placement_planes = 1
        self.movement_planes = 6 * K
        self.choose_target_planes = 1
        self.choose_attackers_planes = K
        self.confirm_attack_planes = 1
        self.no_move_planes = K
        self.no_fight_planes = K
        total = (
            self.placement_planes
            + self.movement_planes
            + self.choose_target_planes
            + self.choose_attackers_planes
            + self.confirm_attack_planes
            + self.no_move_planes
            + self.no_fight_planes
        )
        self.placement_limit = self.placement_planes
        self.movement_limit = self.placement_limit + self.movement_planes
        self.target_limit = self.movement_limit + self.choose_target_planes
        self.attackers_limit = self.target_limit + self.choose_attackers_planes
        self.confirm_limit = self.attackers_limit + self.confirm_attack_planes
        self.no_move_limit = self.confirm_limit + self.no_move_planes
        self.no_fight_limit = self.no_move_limit + self.no_fight_planes

        self.num_actions = total * R * C
        self.action_space_shape = (total, R, C)

        # Observation channels (ref SCS_Game.py:186-239).
        self.n_unit_channels = N_STATS * K * N_STATUSES
        self.n_reinf_channels_pp = N_REINF_SHOWN * N_STATS * 2
        channels = (
            3  # terrain
            + 2  # victory points
            + 2 * self.n_reinf_channels_pp
            + 2 * self.n_unit_channels
            + 1  # target tile
            + K  # attackers
            + SUB_PHASES
            + 1  # turn
            + 1  # player
        )
        self.observation_shape = (channels, R, C)
        self.max_game_length = scenario.max_game_length

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        self.t_attack = dev(scenario.terrain_attack, F32)  # [R, C]
        self.t_defense = dev(scenario.terrain_defense, F32)
        self.t_cost = dev(scenario.terrain_cost, F32)
        self.vp = dev(scenario.vp, torch.bool)  # [2, R, C]
        self.u_attack = dev(scenario.reinf_stats[:, :, 0].reshape(-1), F32)
        self.u_defense = dev(scenario.reinf_stats[:, :, 1].reshape(-1), F32)
        self.u_allowance = dev(scenario.reinf_stats[:, :, 2].reshape(-1), F32)
        self.u_player = dev(np.repeat(np.arange(2), self.S), I32)  # [U]
        self.reinf_turn = dev(scenario.reinf_turn, I32)  # [2, S]
        self.reinf_arrival = dev(scenario.reinf_arrival, torch.bool)  # [2,S,R,C]
        self.reinf_count = dev(scenario.reinf_count, I32)  # [2]
        dst_r, dst_c, valid = neighbor_tables(R, C)
        self.nbr_r = dev(dst_r, I32)  # [6, R, C]
        self.nbr_c = dev(dst_c, I32)
        self.nbr_ok = dev(valid, torch.bool)
        self._nbr_flat = dev(dst_r * C + dst_c, torch.long).reshape(6, R * C)
        cost_np = np.asarray(scenario.terrain_cost)
        nbr_cost = np.where(valid, cost_np[dst_r, dst_c], np.float32(np.inf))
        self.nbr_cost = dev(nbr_cost, F32)  # [6, R, C], inf where invalid
        # Cheapest adjacent-tile movement cost per tile (inf where none).
        self.min_nbr_cost = dev(nbr_cost.min(0), F32)  # [R, C]
        self._iota_r = torch.arange(R, device=self.device).view(1, R, 1, 1)
        self._iota_c = torch.arange(C, device=self.device).view(1, 1, C, 1)
        self._iota_k = torch.arange(K, device=self.device).view(1, 1, 1, K)
        self._iota_u = torch.arange(self.U, device=self.device).view(1, -1)

    # ------------------------------------------------------------------ #
    # helpers                                                            #
    # ------------------------------------------------------------------ #

    def _stack_count(self, board):
        return (board >= 0).sum(-1).to(I32)  # [B, R, C]

    def _tile_owner(self, board):
        """-1 empty else owning player (a tile's units share one owner)."""
        bottom = board[..., 0]
        return torch.where(bottom >= 0, bottom // self.S, -1).to(I32)

    def _nbr_values(self, x):
        """[B, 6, R, C]: each tile's neighbor value per direction (0 where
        there is no valid neighbor)."""
        B = x.shape[0]
        vals = x.reshape(B, -1)[:, self._nbr_flat].reshape(B, 6, self.R, self.C)
        return torch.where(self.nbr_ok, vals, torch.zeros_like(vals))

    def _adjacent_any(self, mask):
        """bool[B, R, C]: tile has any hex neighbor where ``mask`` is True."""
        return self._nbr_values(mask).any(1)

    def _ended_reinforcements(self, state, p: int):
        """(ref player_ended_reinforcements, SCS_Game.py:908-911)."""
        nxt = state.reinf_next[:, p]
        exhausted = nxt >= self.reinf_count[p]
        slot = nxt.clamp(max=self.S - 1).long()
        return exhausted | (self.reinf_turn[p][slot] != state.turn)

    def _no_units_with_status(self, state, p: int, status: int):
        mine = (self.u_player == p) & state.placed & state.alive
        return ~(mine & (state.status == status)).any(-1)

    # ------------------------------------------------------------------ #
    # Env API                                                            #
    # ------------------------------------------------------------------ #

    def init(self, batch_size: int) -> SCSState:
        B, U, dev = batch_size, self.U, self.device

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        state = SCSState(
            board=full((B, self.R, self.C, self.K), -1, I32),
            alive=full((B, U), False, torch.bool),
            placed=full((B, U), False, torch.bool),
            row=full((B, U), 0, I32),
            col=full((B, U), 0, I32),
            mov=full((B, U), 0.0, F32),
            status=full((B, U), 0, I32),
            reinf_next=full((B, 2), 0, I32),
            turn=full((B,), 0, I32),
            stage=full((B,), -2, I32),
            length=full((B,), 0, I32),
            terminal=full((B,), False, torch.bool),
            terminal_value=full((B,), 0.0, F32),
            has_target=full((B,), False, torch.bool),
            target_row=full((B,), 0, I32),
            target_col=full((B,), 0, I32),
            is_attacker=full((B, U), False, torch.bool),
            attacker_seq=full((B, U), 10**6, I32),
            n_attackers=full((B,), 0, I32),
            vp=self.vp.expand(B, -1, -1, -1).clone(),
        )
        return self._update_env(state)

    def current_player(self, state: SCSState) -> torch.Tensor:
        return _stage_player(state.stage)

    def terminal(self, state: SCSState) -> torch.Tensor:
        return state.terminal

    def terminal_value(self, state: SCSState) -> torch.Tensor:
        return state.terminal_value

    # -- legality ------------------------------------------------------- #

    def legal_mask(self, state: SCSState) -> torch.Tensor:
        R, C, K, S = self.R, self.C, self.K, self.S
        B = state.stage.shape[0]
        p = self.current_player(state)
        opp = 1 - p
        sub = _stage_sub_phase(state.stage)
        board = state.board
        count = self._stack_count(board)
        owner = self._tile_owner(board)
        opp3 = _col(opp, 3)

        # ---- sub-phase 0: placement (ref SCS_Game.py:411-420)
        nxt = state.reinf_next.gather(1, p.long()[:, None])[:, 0]
        cnt = self.reinf_count[p.long()]
        slot = (p * S + nxt.clamp(max=S - 1)).long()
        have_next = (nxt < cnt) & (self.reinf_turn.reshape(-1)[slot] == state.turn)
        arrival = self.reinf_arrival.reshape(2 * S, R, C)[slot]  # [B, R, C]
        placement = (
            arrival & (owner != opp3) & (count < K) & _col(have_next, 3)
        )[:, None]  # [B, 1, R, C]

        # ---- per-level unit info
        present = board >= 0
        safe = board.clamp(min=0)
        lvl_player = safe // S
        lvl_status = _take(state.status, safe)
        lvl_mov = _take(state.mov, safe)
        lvl_mine = present & (lvl_player == _col(p, 4))

        # ---- sub-phase 1: movement + no_move (ref :423-441)
        avail = lvl_mine & (lvl_status == 0)  # [B, R, C, K]
        dcount = self._nbr_values(count)  # [B, 6, R, C]
        downer = self._nbr_values(owner)
        ok = self.nbr_ok & (dcount < K) & (downer != _col(opp, 4))
        can = (
            avail[:, None]  # [B, 1, R, C, K]
            & ok[..., None]
            & (lvl_mov[:, None] - self.nbr_cost[None, :, :, :, None] >= 0)
        )  # [B, 6, R, C, K]
        movement = can.permute(0, 1, 4, 2, 3).reshape(B, 6 * K, R, C)
        no_move = avail.permute(0, 3, 1, 2)  # [B, K, R, C]

        # ---- sub-phase 2: choose target + no_fight (ref :447-458)
        moved_lvl = lvl_mine & (lvl_status == 1)
        moved_mask = moved_lvl.any(-1)
        enemy_occ = owner == opp3
        choose_target = (enemy_occ & self._adjacent_any(moved_mask))[:, None]
        no_fight = moved_lvl.permute(0, 3, 1, 2)

        # ---- sub-phase 3: choose attackers + confirm (ref :463-477)
        target_onehot = self._target_onehot(state)
        adj_target = self._adjacent_any(target_onehot)
        lvl_attacker = _take(state.is_attacker, safe) & present
        selectable = (
            lvl_mine & (lvl_status != 2) & ~lvl_attacker & adj_target[..., None]
        )
        choose_attackers = selectable.permute(0, 3, 1, 2)
        confirm = (target_onehot & _col(state.n_attackers > 0, 3))[:, None]

        def pick(sub_idx, planes):
            return planes & _col(sub == sub_idx, 4)

        mask = torch.cat(
            [
                pick(0, placement),
                pick(1, movement),
                pick(2, choose_target),
                pick(3, choose_attackers),
                pick(3, confirm),
                pick(1, no_move),
                pick(2, no_fight),
            ],
            dim=1,
        )
        return (mask & _col(~state.terminal, 4)).reshape(B, -1)

    def _target_onehot(self, state):
        rows = torch.arange(self.R, device=self.device).view(1, -1, 1)
        cols = torch.arange(self.C, device=self.device).view(1, 1, -1)
        return (
            (rows == _col(state.target_row, 3))
            & (cols == _col(state.target_col, 3))
            & _col(state.has_target, 3)
        )

    # -- stepping -------------------------------------------------------- #

    def step(self, state: SCSState, action: torch.Tensor) -> SCSState:
        R, C, K = self.R, self.C, self.K
        action = action.to(I32)
        plane = action // (R * C)
        rc = action % (R * C)
        r, c = rc // C, rc % C

        # Decode (ref parse_action, SCS_Game.py:486-567).
        in_move = (plane >= self.placement_limit) & (plane < self.movement_limit)
        mv_index = (plane - self.placement_limit).clamp(0, 6 * K - 1)
        act = torch.full_like(plane, 6)
        act = torch.where(plane < self.no_move_limit, 5, act)
        act = torch.where(plane < self.confirm_limit, 4, act)
        act = torch.where(plane < self.attackers_limit, 3, act)
        act = torch.where(plane < self.target_limit, 2, act)
        act = torch.where(in_move, 1, act)
        act = torch.where(plane < self.placement_limit, 0, act)
        s_lvl = torch.where(
            plane < self.no_move_limit,
            (plane - self.confirm_limit).clamp(0, K - 1),
            (plane - self.no_move_limit).clamp(0, K - 1),
        )
        s_lvl = torch.where(
            plane < self.confirm_limit, (plane - self.target_limit).clamp(0, K - 1), s_lvl
        )
        s_lvl = torch.where(in_move, mv_index % K, s_lvl)
        direction = mv_index // K

        appliers = (
            self._act_place,
            self._act_move,
            self._act_choose_target,
            self._act_choose_attacker,
            self._act_confirm,
            self._act_no_move,
            self._act_no_fight,
        )
        out = appliers[0](state, r, c, s_lvl, direction)
        for k in range(1, len(appliers)):
            cand = appliers[k](state, r, c, s_lvl, direction)
            out = select_state(act == k, cand, out)
        out = out.replace(length=out.length + 1)
        return self._update_env(out)

    # -- action appliers -------------------------------------------------- #

    def _board_push(self, board, r, c, uid):
        """Put ``uid`` on top of the (r, c) stack (no-op when full)."""
        count = self._stack_count(board)[..., None]  # [B, R, C, 1]
        here = (
            (self._iota_r == _col(r, 4))
            & (self._iota_c == _col(c, 4))
            & (self._iota_k == count)
            & (count < self.K)
        )
        return torch.where(here, _col(uid, 4).to(board.dtype), board)

    def _board_remove(self, board, r, c, uid):
        """list.remove semantics: drop uid from the (r, c) stack and shift
        higher levels down; every stack is re-compacted (the identity for
        compact stacks)."""
        here = (self._iota_r == _col(r, 4)) & (self._iota_c == _col(c, 4))
        keep = (board >= 0) & ((board != _col(uid, 4)) | ~here)
        rank = keep.to(I32).cumsum(-1) - 1
        new = torch.full_like(board, -1)
        for kp in range(self.K):
            slot = torch.full_like(board[..., 0], -1)
            for j in range(self.K):
                slot = torch.where(
                    keep[..., j] & (rank[..., j] == kp), board[..., j], slot
                )
            new[..., kp] = slot
        return new

    def _unit_set(self, arr, uid, value, do=None):
        """Per game ``arr[b, uid[b]] = value[b]`` where ``do[b]``."""
        hit = self._iota_u == uid[:, None]
        if do is not None:
            hit = hit & do[:, None]
        if isinstance(value, torch.Tensor):
            value = value[:, None].to(arr.dtype)
        return torch.where(hit, value, arr)

    def _board_at(self, board, r, c, s_lvl):
        """board[b, r, c, s_lvl] per game."""
        B = board.shape[0]
        idx = (r * self.C + c) * self.K + s_lvl
        return board.reshape(B, -1).gather(1, idx.long()[:, None])[:, 0]

    def _end_movement(self, state, uid):
        """status -> moved; isolated units also end fighting
        (ref end_movement, SCS_Game.py:927-940)."""
        B = uid.shape[0]
        p = self.u_player[uid.clamp(min=0).long()]
        enemy_occ = self._tile_owner(state.board) == _col(1 - p, 3)
        adj_enemy = self._adjacent_any(enemy_occ)  # [B, R, C]
        ur = _take(state.row, uid)
        uc = _take(state.col, uid)
        any_adj_enemy = adj_enemy.reshape(B, -1).gather(
            1, (ur * self.C + uc).long()[:, None]
        )[:, 0]
        new_status = torch.where(any_adj_enemy, 1, 2).to(I32)
        return state.replace(status=self._unit_set(state.status, uid, new_status))

    def _act_place(self, state, r, c, s_lvl, direction):
        """(ref play_action act 0, SCS_Game.py:572-580)."""
        p = self.current_player(state)
        slot = state.reinf_next.gather(1, p.long()[:, None])[:, 0]
        uid = p * self.S + slot.clamp(max=self.S - 1)
        board = self._board_push(state.board, r, c, uid)
        arange2 = torch.arange(2, device=self.device)
        return state.replace(
            board=board,
            alive=self._unit_set(state.alive, uid, True),
            placed=self._unit_set(state.placed, uid, True),
            row=self._unit_set(state.row, uid, r),
            col=self._unit_set(state.col, uid, c),
            mov=self._unit_set(state.mov, uid, self.u_allowance[uid.long()]),
            status=self._unit_set(state.status, uid, 0),
            reinf_next=state.reinf_next + (arange2 == p[:, None]).to(I32),
        )

    def _act_move(self, state, r, c, s_lvl, direction):
        """(ref play_action act 1, SCS_Game.py:582-600)."""
        uid = self._board_at(state.board, r, c, s_lvl).clamp(min=0)
        rc = (r * self.C + c).long()
        d = direction.long()
        dr = self.nbr_r.reshape(6, -1)[d, rc]
        dc = self.nbr_c.reshape(6, -1)[d, rc]
        dst = (dr * self.C + dc).long()
        cost = self.t_cost.reshape(-1)[dst]
        board = self._board_remove(state.board, r, c, uid)
        board = self._board_push(board, dr, dc, uid)
        new_mov = _take(state.mov, uid) - cost
        state = state.replace(
            board=board,
            row=self._unit_set(state.row, uid, dr),
            col=self._unit_set(state.col, uid, dc),
            mov=self._unit_set(state.mov, uid, new_mov),
        )
        # Auto-end movement when no adjacent tile is affordable anymore
        # (consider_other_units=False; ref SCS_Game.py:596-600).
        can_move = new_mov - self.min_nbr_cost.reshape(-1)[dst] >= 0
        ended = self._end_movement(state, uid)
        return select_state(can_move, state, ended)

    def _act_choose_target(self, state, r, c, s_lvl, direction):
        return state.replace(
            has_target=torch.ones_like(state.has_target),
            target_row=r.to(I32),
            target_col=c.to(I32),
        )

    def _act_choose_attacker(self, state, r, c, s_lvl, direction):
        uid = self._board_at(state.board, r, c, s_lvl).clamp(min=0)
        return state.replace(
            is_attacker=self._unit_set(state.is_attacker, uid, True),
            attacker_seq=self._unit_set(state.attacker_seq, uid, state.n_attackers),
            n_attackers=state.n_attackers + 1,
        )

    def _act_no_move(self, state, r, c, s_lvl, direction):
        uid = self._board_at(state.board, r, c, s_lvl).clamp(min=0)
        state = state.replace(status=self._unit_set(state.status, uid, 1))
        # _end_movement re-derives moved/attacked from adjacency:
        return self._end_movement(state, uid)

    def _act_no_fight(self, state, r, c, s_lvl, direction):
        uid = self._board_at(state.board, r, c, s_lvl).clamp(min=0)
        return state.replace(status=self._unit_set(state.status, uid, 2))

    @staticmethod
    def _lexi_pick(cand, k1, k2, k3, order):
        """Reference strongest-unit selection: max (k1, then k2, then k3),
        first-in-``order`` ties (ref SCS_Game.py:1253-1285)."""
        neg = torch.tensor(-1e9, dtype=F32, device=cand.device)
        m1 = cand & (k1 == torch.where(cand, k1, neg).amax(-1, keepdim=True))
        m2 = m1 & (k2 == torch.where(m1, k2, neg).amax(-1, keepdim=True))
        m3 = m2 & (k3 == torch.where(m2, k3, neg).amax(-1, keepdim=True))
        return torch.argmin(torch.where(m3, order, 10**8), -1).to(I32)

    def _destroy(self, state, uid, do):
        """(ref destroy_unit, SCS_Game.py:982-995)."""
        removed = self._board_remove(
            state.board, _take(state.row, uid), _take(state.col, uid), uid
        )
        board = torch.where(_col(do, 4), removed, state.board)
        alive = self._unit_set(state.alive, uid, ~do & _take(state.alive, uid))
        return state.replace(board=board, alive=alive)

    def _act_confirm(self, state, r, c, s_lvl, direction):
        """(ref resolve_combat, SCS_Game.py:997-1027)."""
        B, U = state.alive.shape
        tr, tc = state.target_row, state.target_col
        trc = (tr * self.C + tc).long()

        on_target = (
            (state.row == tr[:, None]) & (state.col == tc[:, None])
            & state.placed & state.alive
        )
        sdef = torch.where(on_target, self.u_defense, 0.0).sum(-1)
        total_def = sdef * self.t_defense.reshape(-1)[trc]

        # Attack: each attacker's attack x its own tile's modifier.
        att = state.is_attacker & state.alive
        atk_mod = self.t_attack.reshape(-1)[(state.row * self.C + state.col).long()]
        total_att = torch.where(att, self.u_attack * atk_mod, 0.0).sum(-1)

        # All attackers end fighting BEFORE losses (ref :1016).
        state = state.replace(status=torch.where(att, 2, state.status).to(I32))

        defender_losses = total_att >= total_def
        attacker_losses = total_att <= total_def

        # Strongest attacker: (attack, defense, allowance), first-chosen
        # wins ties (selection order).
        a_uid = self._lexi_pick(
            att, self.u_attack, self.u_defense, self.u_allowance,
            state.attacker_seq,
        )
        state = self._destroy(state, a_uid, attacker_losses)

        # Strongest defender: (defense, attack, allowance), stack order.
        bi = torch.arange(B, device=self.device)
        stack = state.board.reshape(B, self.R * self.C, self.K)[bi, trc]  # [B, K]
        d_cand = (
            (state.row == tr[:, None]) & (state.col == tc[:, None])
            & state.placed & state.alive
        )
        stack_order = torch.full((B, U), 10**6, dtype=I32, device=self.device)
        for k in range(self.K):
            sk = stack[:, k : k + 1]
            stack_order = torch.where(
                (self._iota_u == sk) & (sk >= 0),
                stack_order.clamp(max=k),
                stack_order,
            )
        d_uid = self._lexi_pick(
            d_cand, self.u_defense, self.u_attack, self.u_allowance, stack_order
        )
        state = self._destroy(state, d_uid, defender_losses)

        # Clear target + attackers (ref play_action act 4, :615-618).
        return state.replace(
            has_target=torch.zeros_like(state.has_target),
            is_attacker=torch.zeros_like(state.is_attacker),
            attacker_seq=torch.full_like(state.attacker_seq, 10**6),
            n_attackers=torch.zeros_like(state.n_attackers),
        )

    # -- stage machine ----------------------------------------------------- #

    def _termination_value(self, state):
        """(ref check_termination, SCS_Game.py:857-894)."""
        owner = self._tile_owner(state.board)
        p2_captured = (state.vp[:, 0] & (owner == 1)).sum((1, 2)).to(F32)
        p1_captured = (state.vp[:, 1] & (owner == 0)).sum((1, 2)).to(F32)
        n_vp = self.scenario.n_vp
        p1_pct = p1_captured * _recip(max(n_vp[1], 1))
        p2_pct = p2_captured * _recip(max(n_vp[0], 1))
        out = torch.where(p1_pct < p2_pct, -1.0, 0.0)
        return torch.where(p1_pct > p2_pct, 1.0, out).to(F32)

    def _advance(self, s: SCSState):
        """One pass of the reference's stage-advance loop
        (ref update_game_env, SCS_Game.py:687-831); returns (state, advanced)."""
        stage = s.stage
        er0 = self._ended_reinforcements(s, 0)
        er1 = self._ended_reinforcements(s, 1)
        nm0 = self._no_units_with_status(s, 0, 0)
        nm1 = self._no_units_with_status(s, 1, 0)
        na0 = self._no_units_with_status(s, 0, 1)
        na1 = self._no_units_with_status(s, 1, 1)
        ht = s.has_target

        def at(v):
            return stage == v

        game_over = at(6) & na1 & (s.turn + 1 > self.scenario.turns)
        next_turn = at(6) & na1 & ~game_over

        new_stage = stage
        for cond, tgt in (
            (at(-2) & er0, -1),
            (at(-1) & er1, 0),
            (at(0) & er0, 1),
            (at(1) & nm0, 2),
            (at(2) & na0, 4),
            (at(2) & ~na0 & ht, 3),
            (at(3) & ~ht, 2),
            (at(4) & er1, 5),
            (at(5) & nm1, 6),
            (next_turn, 0),
            (at(6) & ~na1 & ht, 7),
            (at(7) & ~ht, 6),
        ):
            new_stage = torch.where(cond, tgt, new_stage)
        inc_turn = (at(-1) & er1) | next_turn

        advanced = (new_stage != stage) | inc_turn
        # game_over BREAKS the loop with terminal set (ref :764-766).
        advanced = advanced & ~s.terminal & ~game_over

        s = s.replace(stage=new_stage.to(I32), turn=s.turn + inc_turn.to(I32))
        # new_turn reset on turn rollover (ref new_turn, :845-855).
        on = s.placed & s.alive & next_turn[:, None]
        s = s.replace(
            status=torch.where(on, 0, s.status).to(I32),
            mov=torch.where(on, self.u_allowance, s.mov),
        )
        # Termination value (ref check_termination, :857-894).
        fire = game_over & ~s.terminal
        s = s.replace(
            terminal=s.terminal | game_over,
            terminal_value=torch.where(
                fire, self._termination_value(s), s.terminal_value
            ),
        )
        return s, advanced

    def _update_env(self, state: SCSState) -> SCSState:
        """Advance every game's stage machine until it rests: one pass for
        all games, then more passes while any game advanced, each applied
        only to the games that advanced on the previous pass (the batched
        form of the JAX engine's per-game ``lax.while_loop``).  The loop
        test reads one flag on the host per pass."""
        state, cont = self._advance(state)
        while bool(cont.any()):
            nxt, adv = self._advance(state)
            state = select_state(cont, nxt, state)
            cont = cont & adv
        return state

    # -- observation ------------------------------------------------------- #

    def observe(self, state: SCSState) -> torch.Tensor:
        """(ref generate_state, SCS_Game.py:1348-1505); channel order:
        terrain(3), p1_vp, p2_vp, p1_reinf(18), p2_reinf(18), p1_units,
        p2_units, target(1), attackers(K), sub_phase(4), turn(1),
        player(1)."""
        R, C, K, S = self.R, self.C, self.K, self.S
        B = state.stage.shape[0]
        dev = self.device
        chans = [
            self.t_attack.expand(B, 1, R, C),
            self.t_defense.expand(B, 1, R, C),
            self.t_cost.expand(B, 1, R, C),
            state.vp[:, 0:1].to(F32),
            state.vp[:, 1:2].to(F32),
        ]

        # Reinforcements: next N_REINF_SHOWN unplaced units per player.
        turns_total = np.float32(self.scenario.turns + 1)
        shown = torch.arange(N_REINF_SHOWN, device=dev)
        for p in range(2):
            idx = state.reinf_next[:, p : p + 1] + shown  # [B, 3]
            ok = (idx < self.reinf_count[p]).to(F32)
            slot = idx.clamp(max=S - 1).long()
            uid = p * S + slot
            arrival = self.reinf_arrival[p][slot].to(F32) * ok[..., None, None]
            stats = torch.stack(
                [self.u_attack[uid], self.u_defense[uid], self.u_allowance[uid]],
                dim=2,
            )  # [B, 3, 3stats]
            stats_planes = arrival[:, :, None] * stats[..., None, None]  # [B,3,3,R,C]
            turns_left = self.reinf_turn[p][slot].to(F32) - state.turn.to(F32)[:, None]
            # x / const as x * (1 / const): the JAX engine's compiled form.
            importance = (
                (float(turns_total) - turns_left) * _recip(turns_total) * ok
            )  # [B, 3]
            dur = importance[:, :, None, None, None].expand(B, N_REINF_SHOWN, 3, R, C)
            per_unit = torch.cat([stats_planes, dur], dim=2)
            chans.append(per_unit.reshape(B, N_REINF_SHOWN * 6, R, C))

        # Units by (player, status, stacking level).
        board = state.board
        present = board >= 0
        safe = board.clamp(min=0)
        lvl_player = safe // S
        lvl_status = _take(state.status, safe)
        lvl_stats = torch.stack(
            [
                self.u_attack[safe.long()],
                self.u_defense[safe.long()],
                _take(state.mov, safe),
            ],
            dim=1,
        )  # [B, 3stat, R, C, K]
        pm = lvl_player[:, None] == torch.arange(2, device=dev).view(1, 2, 1, 1, 1)
        sm = lvl_status[:, None] == torch.arange(N_STATUSES, device=dev).view(
            1, N_STATUSES, 1, 1, 1
        )
        m = (present[:, None, None] & pm[:, :, None] & sm[:, None]).to(F32)
        # [B, 2, status, stat, R, C, K] -> [B, 2, status, K, stat, R, C]
        units = m[:, :, :, None] * lvl_stats[:, None, None]
        units = units.permute(0, 1, 2, 6, 3, 4, 5)
        chans.append(units.reshape(B, 2 * N_STATUSES * K * N_STATS, R, C))

        chans.append(self._target_onehot(state).to(F32)[:, None])

        lvl_att = _take(state.is_attacker, safe) & present
        chans.append(lvl_att.permute(0, 3, 1, 2).to(F32))

        sub = _stage_sub_phase(state.stage)
        sub_planes = (
            torch.arange(SUB_PHASES, device=dev).view(1, -1) == sub[:, None]
        ).to(F32)
        chans.append(sub_planes[..., None, None].expand(B, SUB_PHASES, R, C))

        turn = state.turn.to(F32) * _recip(self.scenario.turns)
        chans.append(turn.view(B, 1, 1, 1).expand(B, 1, R, C))

        player = torch.where(self.current_player(state) == 1, -1.0, 1.0).to(F32)
        chans.append(player.view(B, 1, 1, 1).expand(B, 1, R, C))

        return torch.cat(chans, dim=1)
