"""The tower's self-play driver (``drivers/selfplay_tower.py``) on the CPU at
a tiny size: a sound run is correct, the control reads above the program,
a tower whose norms are left out fails, and a port whose learner refuses
a batch-norm net stops before any kernel is built."""

import copy
import itertools
import time
from unittest import mock

import pytest
import torch

from cardbench import harness
from cardbench.drivers import common, selfplay_tower
from cardbench.reference import tower

SEED = 2**31 + 4242
LIMITS = {"prior_gap": 1e-5, "value_gap": 1e-5, "backup_gap": 1e-5}


def tiny(**limits):
    """The tower's cell at 2 blocks of 8 filters in f32, 8 games, 4 sims."""
    cell = harness.find_cell("selfplay.az19x256")
    cell.config = dict(cell.config, num_filters=8, num_blocks=2, compute_dtype="float32")
    t = copy.deepcopy(cell.traffic)
    t["training_overrides"]["Running"]["num_actors"] = 8
    t["search_overrides"]["Simulation"]["mcts_simulations"] = 4
    t["games_per_phase"] = 2
    t["warm_moves"] = 2
    t["check"] = {"tree_games": 8, "ring_games": 4}
    cell.traffic = t
    cell.limits = dict(cell.limits, min_nodes_compared=2, **limits)
    return cell


def run(cell, moves=60, control=None):
    """One run whose window closes after ``moves`` move-batches."""
    torch.manual_seed(0)
    launches = itertools.count()
    with mock.patch.object(common.Deadline, "over", lambda self: next(launches) >= moves):
        out = selfplay_tower.run(cell, seed=SEED, seconds=0.0, trace=False,
                                 device=torch.device("cpu"), t_start=time.perf_counter(),
                                 control=control)
    return {c.name: c for c in out.checks}, out


def test_a_sound_run_is_correct_and_the_control_is_not():
    cell = tiny(**LIMITS)
    checks, out = run(cell, control="tf32")
    assert all(c.ok for c in checks.values()), [c.line() for c in checks.values()]
    assert out.attempted > 0 and checks["ring_games"].value >= 1
    prog, ctrl = out.context["readings"], out.context["control"]
    assert ctrl["prior_gap"] > 100 * prog["prior_gap"]
    assert not all(c.ok for c in selfplay_tower.compare(ctrl, cell.limits))
    convs = out.context["window"]["convs"]
    assert len(convs) == 2 * 2 + 7 and convs[1][1:3] == (8, 8)


def test_the_norms_left_out(monkeypatch):
    from nuzero_tpu_torch.networks.blocks import BatchNorm

    monkeypatch.setattr(BatchNorm, "forward", lambda self, x: x)
    checks, _ = run(tiny(**LIMITS))
    assert not checks["prior_gap"].ok


def test_the_weights_keep_the_activations_normalized():
    """Each norm's running statistics are its input's over the seeded
    positions, so that the 19 blocks neither blow the activations up nor
    let them vanish; the heads' last convs at ``HEAD_SCALE`` of their bound
    give near-uniform priors and near-zero values."""
    cell = harness.find_cell("selfplay.az19x256")
    ref = tower.ref_selfplay.make_env(common.scenario_data(cell.traffic),
                                      cell.traffic["scenario_seed"], False, "cpu")
    obs = tower.positions(ref, 5, n=64, plies=20)
    named, _ = tower.layout(obs.shape[1], 21, 16, 19)
    params = tower.draw_params(named, 5, "cpu", obs)
    assert len(params) == len(named) + 2 * 24
    logits, value = tower.evaluate(params, obs)
    assert torch.isfinite(logits).all() and value.abs().max() < 0.05
    std = float(logits.std(-1).mean())
    assert 1e-3 < std < 0.1
    full = dict(params, **{k: params[k] / tower.HEAD_SCALE for k in
                           ("policy_head.convs.1.conv.weight", "value_head.convs.3.conv.weight")})
    assert float(tower.evaluate(full, obs)[0].std(-1).mean()) == pytest.approx(
        std / tower.HEAD_SCALE, rel=1e-3)


def test_a_port_that_refuses_the_net_stops_before_building_kernels(monkeypatch):
    from nuzero_tpu_torch.training import learner

    def refuse(self, manager, *args, **kwargs):
        raise NotImplementedError("a network with batch_norm cannot be trained")

    monkeypatch.setattr(learner.Learner, "__init__", refuse)
    built = mock.Mock(return_value=0.0)
    monkeypatch.setattr(common, "build_kernels", built)
    with pytest.raises(NotImplementedError):
        run(tiny(**LIMITS))
    built.assert_not_called()
