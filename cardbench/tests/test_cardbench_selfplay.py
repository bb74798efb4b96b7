"""The self-play driver on the CPU at a tiny size: a sound run is correct,
and a run with the timed path broken underneath is not, once for each
fault a self-play cell can have; the control reads above the limits."""

import copy
import itertools
import time
from unittest import mock

import pytest
import torch

from cardbench import harness
from cardbench.drivers import common, selfplay

SEED = 2**31 + 4242


LIMITS = {"prior_gap": 1e-5, "value_gap": 1e-5, "backup_gap": 1e-5}


def tiny(name, **limits):
    cell = harness.find_cell(name)
    cell.config = dict(cell.config, num_filters=8, pred_iterations=2)
    t = copy.deepcopy(cell.traffic)
    t["training_overrides"]["Running"]["num_actors"] = 8
    t["search_overrides"]["Simulation"]["mcts_simulations"] = 4
    t["games_per_phase"] = 2
    t["check"] = {"tree_games": 8, "ring_games": 4}
    cell.traffic = t
    cell.limits = dict(cell.limits, min_nodes_compared=2, **limits)
    return cell


def run(cell, moves=30, control=None):
    """One run whose window closes after ``moves`` move-batches, not after a
    time: the same work on a loaded host."""
    torch.manual_seed(0)
    launches = itertools.count()
    with mock.patch.object(common.Deadline, "over", lambda self: next(launches) >= moves):
        out = selfplay.run(cell, seed=SEED, seconds=0.0, trace=False,
                           device=torch.device("cpu"), t_start=time.perf_counter(),
                           control=control)
    return {c.name: c for c in out.checks}, out


@pytest.fixture(scope="module")
def sound():
    return run(tiny("selfplay.solo64", **LIMITS))


def test_a_sound_run_is_correct(sound):
    checks, out = sound
    assert all(c.ok for c in checks.values()), [c.line() for c in checks.values()]
    assert out.attempted > 0 and out.end_to_end["selfplay_env_steps_per_s"]["value"] > 0


def test_the_control_reads_above_the_program_and_fails(sound):
    cell = tiny("selfplay.solo64", **LIMITS)
    checks, out = run(cell, control="tf32")
    prog, ctrl = out.context["readings"], out.context["control"]
    assert ctrl["prior_gap"] > 3 * prog["prior_gap"]
    assert all(c.ok for c in selfplay.compare(prog, cell.limits))
    assert not all(c.ok for c in selfplay.compare(ctrl, cell.limits))


def test_the_trees_and_targets_are_checked(sound):
    checks, out = sound
    for name in ("visits_wrong", "targets_wrong", "backup_gap", "backups_compared"):
        assert checks[name].ok, checks[name].line()
    assert checks["backups_compared"].value >= 2


def test_a_move_that_leaves_its_state_unchanged(monkeypatch):
    from nuzero_tpu_torch.envs.scs.game import SCSGame

    monkeypatch.setattr(SCSGame, "step", lambda self, state, action: state)
    checks, _ = run(tiny("selfplay.solo64", **LIMITS))
    assert not checks["transitions_wrong"].ok and not checks["ring_games"].ok


def test_half_the_batch_left_out(monkeypatch):
    from nuzero_tpu_torch.networks.recurrent import RecurrentNet

    forward = RecurrentNet.forward

    def half(self, x, *args, **kwargs):
        (p, v), thought = forward(self, x, *args, **kwargs)
        h = max(1, p.shape[0] // 2)
        p = torch.cat([p[:h], p[:h].mean(0, keepdim=True).expand(p.shape[0] - h, -1)])
        v = torch.cat([v[:h], v[:h].mean(0, keepdim=True).expand(v.shape[0] - h)])
        return (p, v), thought

    monkeypatch.setattr(RecurrentNet, "forward", half)
    checks, _ = run(tiny("selfplay.solo64", **LIMITS))
    assert not (checks["prior_gap"].ok and checks["value_gap"].ok)


def test_a_transition_altered_where_it_is_produced(monkeypatch):
    from nuzero_tpu_torch.envs.scs.game import SCSGame

    step = SCSGame.step

    def altered(self, state, action):
        out = step(self, state, action)
        return out.replace(turn=out.turn + 1)

    monkeypatch.setattr(SCSGame, "step", altered)
    checks, _ = run(tiny("selfplay.solo64", **LIMITS))
    assert not checks["transitions_wrong"].ok


def test_a_prior_altered_where_it_is_produced(monkeypatch):
    from nuzero_tpu_torch.search import mcts

    masked = mcts._masked_priors

    def altered(logits, legal):
        return masked(logits, legal) * 1.001

    monkeypatch.setattr(mcts, "_masked_priors", altered)
    checks, _ = run(tiny("selfplay.solo64", **LIMITS))
    assert not checks["prior_gap"].ok


def test_a_policy_target_altered(monkeypatch):
    from nuzero_tpu_torch.training import replay

    add = replay.add_games

    def altered(buffer, finished):
        finished = copy.copy(finished)
        finished.policy = finished.policy * 1.01
        return add(buffer, finished)

    monkeypatch.setattr(replay, "add_games", altered)
    checks, _ = run(tiny("selfplay.solo64", **LIMITS))
    assert not checks["targets_wrong"].ok


def _backprop(sign=None, visits=True):
    """The search's backup with a fault: ``sign`` flips the value added at
    every other depth; ``visits=False`` adds no visit."""
    def backprop(tree, path, leaf, value, fresh, active):
        N = tree.visit.shape[1]
        extra = torch.where(fresh, leaf, N)
        nodes = torch.cat([path, extra[:, None]], dim=1)
        nodes = torch.where(active[:, None], nodes, N)
        live = nodes < N
        idx = nodes.clamp(max=N - 1).long()
        if visits:
            tree.visit.scatter_add_(1, idx, live.to(torch.int32))
        added = value[:, None].expand(-1, nodes.shape[1])
        if sign:
            flips = torch.arange(nodes.shape[1], device=nodes.device) % 2 == 1
            added = torch.where(flips, -added, added)
        tree.value_sum.scatter_add_(1, idx, torch.where(live, added, 0.0))
    return backprop


def test_a_backup_with_a_sign_error(monkeypatch):
    from nuzero_tpu_torch.search import mcts

    monkeypatch.setattr(mcts, "_backprop_path", _backprop(sign=True))
    checks, _ = run(tiny("selfplay.solo64", **LIMITS))
    assert not checks["backup_gap"].ok


def test_visits_that_are_never_counted(monkeypatch):
    from nuzero_tpu_torch.search import mcts

    monkeypatch.setattr(mcts, "_backprop_path", _backprop(visits=False))
    checks, _ = run(tiny("selfplay.solo64", **LIMITS))
    assert not checks["visits_wrong"].ok


def test_targets_written_from_the_legal_actions(monkeypatch):
    """Each policy target replaced by the uniform distribution over its
    position's legal actions: a distribution on legal actions, but no
    search's visit counts."""
    from nuzero_tpu_torch.training import replay

    add = replay.add_games

    def uniform(buffer, finished):
        finished = copy.copy(finished)
        legal = finished.policy > 0
        finished.policy = legal / legal.sum(-1, keepdim=True).clamp(min=1)
        return add(buffer, finished)

    monkeypatch.setattr(replay, "add_games", uniform)
    checks, _ = run(tiny("selfplay.solo64", **LIMITS))
    assert not checks["targets_wrong"].ok


def test_a_gap_without_a_limit_is_read_but_not_compared(sound):
    checks, _ = sound
    readings = {**{n: c.value for n, c in checks.items()}, "value_gap": 1.0, "backup_gap": 1.0}
    got = selfplay.compare(readings, {"prior_gap": 1e-5, "min_nodes_compared": 2})
    assert all(c.ok for c in got)
    assert "prior_gap" in {c.name for c in got}
    assert not {c.name for c in got} & {"value_gap", "backup_gap"}


def test_the_contested_mix_runs_on_the_cpu():
    """The bf16 net on the open field: transitions exact, priors and values
    within a bf16 gap of the f32 reference.  (Open-field games run ~50
    moves or more, so 30 moves may finish none.)"""
    checks, out = run(tiny("selfplay.contested256", prior_gap=0.05, value_gap=0.5,
                           backup_gap=0.5))
    for name in ("transitions_wrong", "visits_wrong", "targets_wrong", "prior_gap",
                 "value_gap", "backup_gap", "nodes_compared"):
        assert checks[name].ok, checks[name].line()
    assert out.context["window"]["dtype"] == "bfloat16"
