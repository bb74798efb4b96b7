"""Learner cells: the training pipeline's own train phase, repeated.

Set-up builds an ``AlphaZero`` from the traffic's recipe, fills its replay
ring with ``ring_games`` games of seeded, uniformly random legal play through
the port's env and ``replay.add_games`` (each position's policy target
uniform over its legal actions, its value the game's end), draws the weights
on the card from the seed, seeds the pipeline's two generators (the
device's for the draws of positions, the host's for the progressive loss's
(n, k)) as ``AlphaZero.run`` does, and runs one ``AlphaZero._train_once``:
``num_samples`` updates of ``batch_size`` positions.  The window then
repeats ``_train_once`` until ``--seconds`` have passed and ends with a
synchronize.

Every call, set-up's and the window's, passes through a ``Recorder`` on
``AlphaZero._update`` and ``replay.gather``, which keeps references to the
call's start and to its first three updates.  Two calls are judged: set-up's
(the start, from the drawn weights and a fresh Adam state) and the window's
last (from the program's own state after the window's earlier updates,
which the reference cannot replay; that they moved every leaf is checked as
``stale_leaves``).  The reference (``reference/learner.py``) follows three
updates of each from the same parameters, Adam state, ring and generator
states: each update's batch and losses, the first gradient (from Adam's
first moment) and the parameters' change after three, leaf by leaf.

``train_samples_per_s`` = updates completed in the window x the batch /
the window's seconds.  A ``--trace 1`` run profiles ``trace_calls`` more
calls.
"""
from __future__ import annotations

import math
import sys
import time

import torch

from cardbench import harness
from cardbench.drivers import common
from cardbench.reference import learner as ref_learner
from cardbench.reference import measure
from cardbench.reference import selfplay as ref_selfplay

FOLLOWED = 3


def fill_ring(az, env, games: int, gen: torch.Generator) -> dict:
    """``games`` games of uniformly random legal play, all at once, into the
    ring through ``replay.add_games`` -> the games as played, in the ring's
    layout (slot i the i-th game, value targets at its valid positions), on
    the host: the reference's ring."""
    from nuzero_tpu_torch.envs.base import select_state
    from nuzero_tpu_torch.training.replay import FinishedGames, add_games
    from nuzero_tpu_torch.utils.packing import make_packer

    dev = env.device
    pack, _, dim = make_packer(env.init(1, generator=torch.Generator(dev)))
    L, D, A = az.trajectory_length, az.state_dim, env.num_actions
    state = env.init(games, generator=gen)
    states = torch.zeros((games, L, D), device=dev)
    policy = torch.zeros((games, L, A), device=dev)
    done = torch.zeros(games, dtype=torch.bool, device=dev)
    length = torch.zeros(games, dtype=torch.int32, device=dev)
    final = torch.zeros(games, device=dev)
    for t in range(L):
        legal = env.legal_mask(state)
        live = ~done
        states[:, t, :dim] = torch.where(live[:, None], pack(state), 0.0)
        policy[:, t] = torch.where(live[:, None], legal / legal.sum(-1, keepdim=True), 0.0)
        u = torch.rand(legal.shape, generator=gen, device=dev)
        action = torch.argmax(torch.where(legal, u, -1.0), dim=-1).to(torch.int32)
        nxt = env.step(state, action)
        ended = env.terminal(nxt) & live
        length = torch.where(ended, t + 1, length)
        final = torch.where(ended, env.terminal_value(nxt), final)
        done = done | ended
        state = select_state(done, state, nxt)
        if bool(done.all()):
            break
    az.buffer = add_games(az.buffer, FinishedGames(
        states=states, policy=policy, final_value=final, length=length,
        game_type=torch.zeros(games, dtype=torch.int32, device=dev), mask=done))
    keep = done.nonzero().flatten()
    n = int(keep.numel())
    valid = torch.arange(L, device=dev)[None, :] < length[keep, None]
    return {"states": states[keep].cpu(), "policy": policy[keep].cpu(),
            "value": torch.where(valid, final[keep, None], 0.0).cpu(),
            "length": length[keep].cpu(), "seq": torch.arange(n, dtype=torch.int32),
            "games_added": torch.tensor(n)}


def build(cell, seed: int, device):
    from nuzero_tpu_torch.training.learner import TrainState
    from nuzero_tpu_torch.training.pipeline import AlphaZero

    traffic, config = cell.traffic, cell.config
    env = common.build_env(traffic, device)
    manager = common.build_manager(config, env)
    cfg, search = common.recipe(traffic, config)
    az = AlphaZero(env, manager, cfg, search, run_dir=None)
    ring = fill_ring(az, env, traffic["ring_games"],
                     torch.Generator(device=device).manual_seed(seed + 3))
    params = harness.draw_params(manager.module, seed, device)
    state = TrainState(params=params, opt_state=az.learner.init_opt_state(params), step=0)
    az._rng = torch.Generator(device=device).manual_seed(seed + 5)
    az._host_rng = torch.Generator().manual_seed(seed + 6)
    return az, env, state, ring


def work(config: dict, env, cfg, updates: int, draws) -> dict:
    """The hex convs that ``updates`` updates need: each a forward, dX and dW
    at ``train_iterations`` and the progressive loss's forward and backward
    at its (n, k) (``draws``, one per update; the mean count where unknown)."""
    c, h, w = env.observation_shape
    pixels = cfg.learning.batch_size * h * w
    planes, m = env.action_space_shape[0], config["train_iterations"]
    convs = []
    for n, k in draws:
        convs += [(pixels, i, o, p, 1) for i, o, p in
                  measure.update_convs(config["num_filters"], c, planes, m, n, k)]
    return {"dtype": config["compute_dtype"], "units": updates, "convs": convs}


def expected_draws(m: int, updates: int) -> list:
    """(n, k) of ``updates`` updates in the proportions the host generator
    draws them: n uniform on 0..m-1, then k uniform on 1..m-n."""
    pairs = [(n, k, 1.0 / m / (m - n)) for n in range(m) for k in range(1, m - n + 1)]
    out = []
    for n, k, p in pairs:
        out += [(n, k)] * round(p * updates)
    return out


def judge(program: dict, steps: list, final: dict, params0: dict, mu0: dict) -> dict:
    """Readings of ``FOLLOWED`` updates of one ``_train_once`` call
    (``program``: per step its batch and losses, its first gradient ``g1``,
    its first forward's logits and its parameters after the last,
    ``final``) against the reference's ``steps`` and ``final`` from the same
    start (``params0``, Adam's first moment ``mu0``): rows of a batch that
    differ, the first step's relative gap of the combined loss, the worst
    leaf's gap in norm of the first gradient and of the parameters' change,
    and the first forward's logits against the reference's, over its
    largest |logit| (``logit_gap``).  Leaves whose reference gradient is
    under a thousandth of the median leaf's move by round-off alone and are
    left out."""
    wrong = sum(w["invalid"] for w in steps)
    wrong_by = {}
    loss_gaps = []
    for got, want in zip(program["steps"], steps):
        rows = torch.zeros(got["obs"].shape[0], dtype=torch.bool, device=got["obs"].device)
        for key in ("obs", "policy", "value"):
            a, b = got[key], want[key]
            diff = (a != b).reshape(a.shape[0], -1).any(-1)
            wrong_by[key] = wrong_by.get(key, 0) + int(diff.sum())
            rows |= diff
        wrong += int(rows.sum())
        loss_gaps.append(abs(got["losses"][2] - want["losses"][2]) / abs(want["losses"][2]))
    # The later steps' losses follow parameters that Adam's updates have
    # moved apart wherever a gradient entry is rounding-small: the first
    # step's is the steady reading.
    norms = {k: float(g.double().norm()) for k, g in steps[0]["grads"].items()}
    median = sorted(norms.values())[len(norms) // 2]
    skip = {k for k, v in norms.items() if v < 1e-3 * median}
    grad_gap, grad_leaf = ref_learner.worst_leaf_gap(program["g1"], steps[0]["grads"], skip)
    want = steps[0]["logits"].double()
    logit_gap = float((program["logits"].double() - want).abs().max()
                      / want.abs().max().clamp(min=1e-30))
    moved = {k: program["final"][k] - params0[k] for k in params0}
    change = {k: final[k] - params0[k] for k in params0}
    change_gap, change_leaf = ref_learner.worst_leaf_gap(moved, change, skip)
    return {"batch_wrong": wrong, "batch_wrong_by": wrong_by,
            "draws_off": max(w["draws_off"] for w in steps), "logit_gap": logit_gap,
            "loss_gap": loss_gaps[0], "loss_gaps": loss_gaps, "grad_gap": grad_gap,
            "grad_leaf": grad_leaf, "change_gap": change_gap, "change_leaf": change_leaf,
            "skipped_leaves": sorted(skip)}


def first_gradient(mu1: dict, mu0: dict) -> dict:
    """The gradient of an update as Adam got it, from its first moment
    before (``mu0``) and after (``mu1``): mu1 = b1 mu0 + (1 - b1) g."""
    return {k: (mu1[k] - ref_learner.ADAM_B1 * mu0[k]) / (1.0 - ref_learner.ADAM_B1)
            for k in mu1}


class Recorder:
    """One ``AlphaZero._train_once`` call as it passes through
    ``AlphaZero._update`` and ``replay.gather``: the state it starts from,
    the two generators' states, the positions drawn, and for its first
    ``FOLLOWED`` updates the batch, the losses and the state after.  It keeps
    references to what the call made (no copy, no host read), so it may
    stay installed through the timed window; ``start`` drops the previous
    call's record."""

    def __init__(self, az):
        from nuzero_tpu_torch.training import replay

        self.az, self.replay = az, replay
        self.update, self.gather = az._update, replay.gather
        self.start(None)

    def start(self, state) -> None:
        self.pre = state
        self.device_rng = self.az._rng.get_state()
        self.host_rng = self.az._host_rng.get_state()
        self.drawn, self.steps, self.logits = [], [], []

    def _gathering(self, buffer, flat_idx, mesh=None):
        self.drawn.append(flat_idx)
        return self.gather(buffer, flat_idx, mesh)

    def _updating(self, st, batches):
        new, metrics = self.update(st, batches)
        if len(self.steps) < FOLLOWED:
            obs, pol, val, _ = batches[0]
            self.steps.append({"obs": obs, "policy": pol, "value": val, "state": new,
                               "losses": [metrics[k] for k in
                                          ("loss/value", "loss/policy", "loss/combined")]})
        return new, metrics

    def _first_forward(self, module, inputs, output):
        # The first update's first forward: the full one at ``m`` iterations.
        if not self.logits:
            (logits, _), _ = output
            self.logits.append(logits.detach())

    def install(self) -> None:
        self.az._update, self.replay.gather = self._updating, self._gathering
        self.hook = self.az.manager.module.register_forward_hook(self._first_forward)

    def remove(self) -> None:
        self.az._update, self.replay.gather = self.update, self.gather
        self.hook.remove()

    def taken(self) -> dict:
        """The record on the host's side of the card: copies, losses read."""
        pre = self.pre
        steps = [{"obs": s["obs"].clone(), "policy": s["policy"].clone(),
                  "value": s["value"].clone(), "losses": tuple(float(x) for x in s["losses"])}
                 for s in self.steps]
        last = self.steps[-1]["state"]
        mu1 = self.steps[0]["state"].opt_state["mu"]
        return {"params0": {k: v.detach().clone() for k, v in pre.params.items()},
                "opt0": {"count": pre.opt_state["count"],
                         "schedule_count": pre.opt_state["schedule_count"],
                         "mu": {k: v.clone() for k, v in pre.opt_state["mu"].items()},
                         "nu": {k: v.clone() for k, v in pre.opt_state["nu"].items()}},
                "device_rng": self.device_rng, "host_rng": self.host_rng,
                "drawn": [d.clone() for d in self.drawn[:FOLLOWED]],
                "program": {"steps": steps, "logits": self.logits[0].float().clone(),
                            "final": {k: v.detach().clone() for k, v in last.params.items()},
                            "g1": first_gradient(mu1, pre.opt_state["mu"])}}


def follow_and_judge(rec: dict, ring: dict, observe, kwargs: dict, control=None) -> dict:
    """The reference's ``FOLLOWED`` updates from a recorded call's start,
    and its readings of the call; with ``control`` also the control's (the
    reference one precision lower in the program's place) and the planted
    faults' readings."""
    args = dict(kwargs, opt0=rec["opt0"], device_rng_state=rec["device_rng"],
                host_rng_state=rec["host_rng"], drawn=rec["drawn"])
    params0, mu0 = rec["params0"], rec["opt0"]["mu"]
    steps, final = ref_learner.follow(params0, ring, observe, FOLLOWED, **args)
    out = {"program": judge(rec["program"], steps, final, params0, mu0)}
    if control is not None:
        for name, extra in (("control", {"quant": control}), ("fault_half", {"fault": "half"}),
                            ("fault_altered", {"fault": "altered"})):
            other, other_final = ref_learner.follow(params0, ring, observe, FOLLOWED,
                                                    **args, **extra)
            out[name] = judge({"steps": other, "final": other_final, "g1": other[0]["grads"],
                               "logits": other[0]["logits"]}, steps, final, params0, mu0)
    return out


#: The numbers held to a limit, for the call that starts from the drawn
#: weights (set-up's) and for the window's last call (``window_`` names).
GAPS = ("draws_off", "logit_gap", "loss_gap", "grad_gap", "change_gap")


def compare(readings: dict, limits: dict) -> list:
    """The checks of a run's readings (``readings["start"]``,
    ``readings["window"]``, the window's errors and stale leaves) against
    the cell's limits."""
    checks = [harness.Check("window_errors", float(readings["window_errors"]), 0.0),
              harness.Check("stale_leaves", float(readings["stale_leaves"]), 0.0)]
    for prefix, part in (("", "start"), ("window_", "window")):
        r = readings[part]
        checks.append(harness.Check(prefix + "batch_wrong", float(r["batch_wrong"]), 0.0))
        for name in GAPS:
            checks.append(harness.Check(prefix + name, r[name], limits[prefix + name]))
    return checks


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control=None):
    """One run of the cell; ``control`` (``calibrate.py`` only) also follows
    the control, the plain net one precision lower, and the planted faults."""
    traffic, config = cell.traffic, cell.config
    build_s = common.build_kernels(device)
    t0 = time.perf_counter()
    az, env, state, ring = build(cell, seed, device)
    fill_s = time.perf_counter() - t0
    cfg = az.cfg

    recorder = Recorder(az)
    recorder.install()
    try:
        recorder.start(state)
        state, _ = az._train_once(state)
        start = recorder.taken()
        setup_params = state.params
        common.sync(device)

        clock = common.Deadline(seconds)
        updates0 = state.step
        errors = []
        setup_s = time.perf_counter() - t_start
        clock.open()
        try:
            while True:
                recorder.start(state)
                state, _ = az._train_once(state)
                if clock.over():
                    break
        except RuntimeError as exc:
            errors.append(repr(exc))
        common.sync(device)
        window_s = time.perf_counter() - clock.t0
    finally:
        recorder.remove()
    updates = state.step - updates0
    rate = updates * cfg.learning.batch_size / window_s
    memory = common.memory_peak(device)
    print(f"cardbench: set-up {setup_s:.3f} s, of which kernel build {build_s:.3f} s, "
          f"objects and ring fill {fill_s:.3f} s", file=sys.stderr)
    m = config["train_iterations"]
    context = {"kind": "learner", "cell": cell.name,
               "window": {"seconds": window_s,
                          **work(config, env, cfg, updates, expected_draws(m, updates))}}
    last = None if errors or len(recorder.steps) < FOLLOWED else recorder.taken()
    # The window's updates before its last call: the leaves they left as
    # set-up left them.
    unmoved = (set(setup_params) if last is None else
               {k for k in setup_params if torch.equal(setup_params[k], last["params0"][k])})
    if trace and not errors:
        calls = traffic["trace_calls"]
        nk_drawn = []
        draws = az.learner.draws

        def counting(rng, mm):
            nk = draws(rng, mm)
            nk_drawn.append(nk)
            return nk

        az.learner.draws = counting

        def traced():
            s = state
            for _ in range(calls):
                s, _ = az._train_once(s)
            return s

        _, raw = harness.profile(traced)
        az.learner.draws = draws
        context["trace"] = harness.summarize(raw)
        context["traced"] = work(config, env, cfg, len(nk_drawn), nk_drawn)
        del raw

    del az, state, recorder, setup_params
    common.release(device)
    ref = ref_selfplay.make_env(common.scenario_data(traffic), traffic["scenario_seed"],
                                traffic["randomize_vp"], device)
    ring = {k: v.to(device) for k, v in ring.items()}

    def observe(states):
        return ref.env.observe(ref.unpack(states[:, :ref.dim]))

    kwargs = dict(batch=cfg.learning.batch_size, m=m, alpha=config["prog_alpha"],
                  lr=cfg.optimizer.starting_lr, boundaries=cfg.optimizer.scheduler_boundaries,
                  gamma=cfg.optimizer.scheduler_gamma, late_heavy=cfg.learning.late_heavy)
    judged = {"start": follow_and_judge(start, ring, observe, kwargs, control)}
    if last is not None:
        judged["window"] = follow_and_judge(last, ring, observe, kwargs, control)
    # No whole call to judge: the window's numbers read as not compared.
    unjudged = {"batch_wrong": 0, **{k: math.inf for k in GAPS}}
    # Every leaf that the reference moves has moved (the start's rule).
    stale = len(unmoved - set(judged["start"]["program"]["skipped_leaves"]))
    readings = {"window_errors": len(errors) + (last is None), "stale_leaves": stale,
                "start": judged["start"]["program"],
                "window": judged["window"]["program"] if last is not None else unjudged}
    if control is not None:
        context["readings"] = readings
        for name in ("control", "fault_half", "fault_altered"):
            context[name] = {**readings, "start": judged["start"][name],
                             "window": judged["window"][name] if last is not None else unjudged}
    checks = compare(readings, cell.limits)
    for e in errors:
        print(f"cardbench: {e}", file=sys.stderr)
    end_to_end = {"train_samples_per_s": {"value": rate, "unit": "samples/s"},
                  "setup_s": {"value": setup_s, "unit": "s"}}
    return common.Outcome(checks=checks, attempted=updates, failed=len(errors),
                          end_to_end=end_to_end, memory_peak_bytes=memory, context=context)
