"""Plain reference of the learner cells: the recipe's first updates, f32.

Each update draws a batch of 256 positions from the replay ring (the
late-heavy ramp, with replacement, ``torch.multinomial`` on a generator in
the program's seed state), rebuilds the observations with the frozen SCS
engine, forwards the plain net at ``m`` iterations and, with the
progressive loss, once more at n + k iterations detached at n ((n, k) drawn
from a host generator in the program's seed state), takes the recipe's
losses (squared error on the value, cross-entropy with label smoothing 0.02
on the policy, mixed by alpha) and applies Adam (b1 0.9, b2 0.999, eps 1e-8,
bias-corrected) at the recipe's learning-rate schedule, as the port's
``training/{replay,losses,learner}.py`` and optax define them.

``quant`` computes the net one precision lower (the control): the products'
inputs rounded, their gradients passed straight through.
"""

from __future__ import annotations

import numpy as np
import torch

from cardbench.reference import net as ref_net

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LABEL_SMOOTHING = 0.02


def position_weights(length, seq, games_added, late_heavy: bool, L: int) -> torch.Tensor:
    """f32[G, L] sampling weights over a ring's valid positions: 0.25 + 0.5
    x the game's normalized insertion rank under ``late_heavy``."""
    valid = torch.arange(L, device=length.device)[None, :] < length[:, None]
    if not late_heavy:
        return valid.to(torch.float32)
    num_games = games_added.clamp(max=length.shape[0])
    num = num_games.clamp(min=1).to(torch.float32)
    oldest = games_added - num_games
    rank = (seq - oldest + 1).to(torch.float32) / num
    w = (1.0 - 0.5) / 2.0 + 0.5 * rank
    return torch.where(valid, w[:, None], 0.0)


def sample(ring: dict, rng: torch.Generator, batch: int, late_heavy: bool):
    """Flat (game, position) indices of one batch, drawn with replacement."""
    L = ring["value"].shape[1]
    w = position_weights(ring["length"], ring["seq"], ring["games_added"], late_heavy, L)
    flat = torch.multinomial(w.reshape(-1), batch, replacement=True, generator=rng)
    return flat // L, flat % L


def progressive_draws(rng: torch.Generator, m: int):
    n = int(torch.randint(0, m, (), generator=rng))
    k = int(torch.randint(1, m - n + 1, (), generator=rng))
    return n, k


def losses(logits, value, policy_target, value_target):
    """(value, policy, combined) batch means: SE and label-smoothed CE."""
    A = logits.shape[-1]
    smoothed = policy_target * (1.0 - LABEL_SMOOTHING) + LABEL_SMOOTHING / A
    p = -(smoothed * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
    v = ((value_target - value) ** 2).mean()
    return v, p, p + v


def loss_of(params, obs, policy_target, value_target, m, alpha, nk, quant=None):
    """The recipe's loss: (1 - alpha) x the full forward's + alpha x the
    progressive forward's (n, k) = ``nk`` -> (value, policy, combined, the
    full forward's logits)."""
    lg, v = ref_net.recurrent_forward(params, obs, m, quant)
    vl, pl, cl = losses(lg, v, policy_target, value_target)
    out = [(1 - alpha) * vl, (1 - alpha) * pl, (1 - alpha) * cl]
    if alpha != 0.0:
        n, k = nk
        lg2, v2 = ref_net.recurrent_forward(params, obs, m, quant,
                                            detach_at=n if n > 0 else None, limit=n + k)
        vl2, pl2, cl2 = losses(lg2, v2, policy_target, value_target)
        out = [out[0] + alpha * vl2, out[1] + alpha * pl2, out[2] + alpha * cl2]
    return out + [lg.detach()]


def learning_rate(lr: float, boundaries, gamma: float, count: int) -> float:
    """optax's piecewise-constant schedule in f32: ``lr`` scaled by
    ``gamma`` once for each distinct boundary that ``count`` has reached."""
    out = np.float32(lr)
    for b in sorted({int(b) for b in boundaries}):
        if count >= b:
            out = np.float32(out * np.float32(gamma))
    return float(out)


def adam(params, grads, opt, lr: float):
    count = opt["count"] + 1
    bc1 = 1.0 - ADAM_B1 ** count
    bc2 = 1.0 - ADAM_B2 ** count
    mu, nu, new = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * opt["mu"][k]
        nu[k] = (1 - ADAM_B2) * g * g + ADAM_B2 * opt["nu"][k]
        new[k] = p - lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
    return new, {"count": count, "schedule_count": opt["schedule_count"] + 1,
                 "mu": mu, "nu": nu}


def follow(params, ring: dict, observe, steps: int, *, batch: int, m: int, alpha: float,
           lr: float, boundaries, gamma: float, late_heavy: bool, opt0, device_rng_state,
           host_rng_state, drawn, quant=None, fault=None):
    """``steps`` updates from ``params`` and Adam's state ``opt0`` (count,
    schedule count, first and second moments) on the positions the
    program drew (``drawn``: flat indices per step) -> per step (the share
    of them that differ from this reference's own draw from the same
    generator state, observations, targets, value/policy/combined loss,
    gradients) and the parameters after the last.  ``observe(packed
    states) -> observations``.  ``fault`` plants one of the faults that the
    limits are held against: ``"half"`` takes the loss over the first half
    of each batch, ``"altered"`` doubles the largest gradient leaf.  The
    draw is ``torch.multinomial`` over f32
    cumulative weights, whose scan on the card need not round alike twice:
    a draw at a rounding boundary may land on the neighbouring position."""
    rng = torch.Generator(device=ring["value"].device)
    rng.set_state(device_rng_state)
    host = torch.Generator()
    host.set_state(host_rng_state)
    params = {k: v.detach().clone().float() for k, v in params.items()}
    opt = {"count": opt0["count"], "schedule_count": opt0["schedule_count"],
           "mu": {k: v.clone().float() for k, v in opt0["mu"].items()},
           "nu": {k: v.clone().float() for k, v in opt0["nu"].items()}}
    out = []
    L = ring["value"].shape[1]
    for step in range(steps):
        own_g, own_p = sample(ring, rng, batch, late_heavy)
        flat = drawn[step].to(own_g.device)
        gi, pi = flat // L, flat % L
        off = float(((own_g * L + own_p) != flat).double().mean())
        weight = position_weights(ring["length"], ring["seq"], ring["games_added"], late_heavy,
                                  L)[gi, pi]
        obs = observe(ring["states"][gi, pi])
        pt, vt = ring["policy"][gi, pi], ring["value"][gi, pi]
        nk = progressive_draws(host, m) if alpha != 0.0 else None
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        rows = slice(0, batch // 2) if fault == "half" else slice(None)
        vl, pl, cl, logits = loss_of(leaves, obs[rows], pt[rows], vt[rows], m, alpha, nk, quant)
        if fault == "half":
            # The rows left out read the mean of the rest.
            rest = logits.mean(0, keepdim=True).expand(batch - logits.shape[0], -1)
            logits = torch.cat([logits, rest])
        got = torch.autograd.grad(cl, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), got)}
        if fault == "altered":
            top = max(grads, key=lambda k: float(grads[k].norm()))
            grads[top] = grads[top] * 2.0
        out.append({"draws_off": off, "invalid": int((weight <= 0).sum()), "obs": obs,
                    "logits": logits,
                    "policy": pt, "value": vt,
                    "losses": (float(vl.detach()), float(pl.detach()), float(cl.detach())),
                    "grads": grads, "nk": nk})
        with torch.no_grad():
            params, opt = adam(params, grads, opt,
                               learning_rate(lr, boundaries, gamma, opt["schedule_count"]))
    return out, params


def worst_leaf_gap(got: dict, want: dict, skip=()) -> tuple:
    """(the largest |norm(got leaf) - norm(want leaf)| over the larger of the
    want leaf's norm and the median leaf's, the leaf it is at), leaves in
    ``skip`` left out."""
    norms = {k: float(v.double().norm()) for k, v in want.items()}
    keys = [k for k in want if k not in skip]
    median = sorted(norms[k] for k in keys)[len(keys) // 2]
    worst, at = 0.0, None
    for k in keys:
        gap = abs(float(got[k].double().norm()) - norms[k]) / max(norms[k], median, 1e-30)
        if gap >= worst:
            worst, at = gap, k
    return worst, at
