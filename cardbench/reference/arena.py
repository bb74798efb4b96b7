"""Plain reference of the arena cells: what the timed matches played,
judged against the frozen SCS engine and the plain f32 net.

For every recorded move (the batch's states and actions as the env's
``step`` received them) the reference checks that each live game's action
is legal, steps the states and compares the next recorded states of the
batch bit for bit (finished games stay as they were), recomputes each
batch's outcome counts from its last move, and, at moves drawn from the
seed (moves at which the policy network ran), evaluates the plain net on
every game of the batch: the widest gap of the program's logits from the
reference's over the reference's largest |logit| (``logit_gap``), and the
policy seat's live games whose chosen action's logit lies below the best
legal one by more than ``TIE_BAND`` of that largest |logit|
(``actions_off``: a rounding may swap near-ties, never more).  The
checkpoint is read from its file, as the program reads it.
"""

from __future__ import annotations

import torch

from cardbench.reference import net as ref_net
from cardbench.reference.scs.base import select_state

POLICY_SEAT = 1
#: The band of a near-tie between two legal actions' logits, as a share of
#: the largest |logit|: f32 rounding differs by ~1e-7 of it, TF32's by ~1e-4.
TIE_BAND = 1e-3


def load_params(path: str, device):
    tree = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.to(device=device, dtype=torch.float32) for k, v in tree["params"].items()}


def _state(ref, fields: dict):
    return ref.state_type(**fields)


def judge(record: dict, ref, params, iterations: int) -> dict:
    env = ref.env
    moves = record["moves"]
    wrong = illegal = counts_wrong = 0
    last = {}
    for i, (b, fields, action, _) in enumerate(moves):
        s = _state(ref, fields)
        done = env.terminal(s)
        legal = env.legal_mask(s).gather(1, action.long()[:, None])[:, 0]
        illegal += int((~legal & ~done).sum())
        nxt = select_state(done, s, env.step(s, action))
        if i + 1 < len(moves) and moves[i + 1][0] == b:
            want = ref.pack(_state(ref, moves[i + 1][1]))
            wrong += int((ref.pack(nxt) != want).any(-1).sum())
        last[b] = nxt
    for b, (p0, p1, draws) in enumerate(record["stats"]):
        if b not in last:
            continue
        final = last[b]
        done, value = env.terminal(final), env.terminal_value(final)
        got = (int(((value > 0) & done).sum()), int(((value < 0) & done).sum()))
        counts_wrong += int(got != (p0, p1)) + int(int(done.numel()) - sum(got) != draws)
    gap, off, n = _logits(record, ref, params, iterations, None)
    return {"transitions_wrong": wrong, "illegal_actions": illegal,
            "counts_wrong": counts_wrong, "logit_gap": gap, "actions_off": off,
            "positions_compared": n}


def _logits(record, ref, params, iterations, quant):
    """(logit gap, actions off the tie band, rows compared) at the picked
    moves; ``quant`` puts the plain net one precision lower in the
    program's place."""
    env = ref.env
    gap, off, n = 0.0, 0, 0
    for i in record["picks"]:
        _, fields, action, logits = record["moves"][i]
        s = _state(ref, fields)
        obs, legal = env.observe(s), env.legal_mask(s)
        want, _ = ref_net.evaluate(params, obs, iterations, None, block=256)
        got = logits if quant is None else ref_net.evaluate(params, obs, iterations, quant,
                                                            block=256)[0]
        scale = float(want.abs().max().clamp(min=1e-30))
        gap = max(gap, float((got.double() - want.double()).abs().max()) / scale)
        rows = (env.current_player(s) == POLICY_SEAT) & ~env.terminal(s)
        best = torch.where(legal, want.double(), float("-inf")).max(-1).values
        chosen = want.double().gather(1, action.long()[:, None])[:, 0]
        off += int((((best - chosen) > TIE_BAND * scale) & rows).sum())
        n += int(obs.shape[0])
    return gap, off, n


def control(record, ref, params, iterations: int, quant: str) -> dict:
    gap, _, n = _logits(record, ref, params, iterations, quant)
    return {"logit_gap": gap, "positions_compared": n}
