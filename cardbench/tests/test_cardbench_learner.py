"""The learner driver on the CPU at a tiny size: a sound run is correct, a
run with the update broken underneath is not, in set-up's call and in the
window's last, and the control reads above the program and fails the
cell's checks."""

import copy
import time

import pytest
import torch

from cardbench import harness
from cardbench.drivers import learner

SEED = 2**31 + 1717
LIMITS = {"draws_off": 0.1, "logit_gap": 0.05, "loss_gap": 1e-4, "grad_gap": 0.05,
          "change_gap": 0.5}
LIMITS.update({"window_" + k: v for k, v in LIMITS.items()})


def tiny():
    cell = harness.find_cell("learner.contested256", spec=harness.spec_with_later())
    cell.config = dict(cell.config, num_filters=8)
    t = copy.deepcopy(cell.traffic)
    t["ring_games"] = 24
    t["training_overrides"] = {"Learning": {"Samples": {
        "batch_size": 32, "num_samples": 4, "with_replacement": True, "late_heavy": True}}}
    cell.traffic = t
    cell.limits = dict(LIMITS)
    return cell


def run(control=None):
    out = learner.run(tiny(), seed=SEED, seconds=1.0, trace=False, device=torch.device("cpu"),
                      t_start=time.perf_counter(), control=control)
    return {c.name: c for c in out.checks}, out


def test_a_sound_run_is_correct():
    checks, out = run()
    assert all(c.ok for c in checks.values()), [c.line() for c in checks.values()]
    assert out.attempted > 0 and out.end_to_end["train_samples_per_s"]["value"] > 0


def test_the_control_reads_above_the_program_and_fails():
    _, out = run(control="fp8")
    prog, ctrl = out.context["readings"], out.context["control"]
    for part in ("start", "window"):
        assert ctrl[part]["batch_wrong"] == 0
        assert ctrl[part]["logit_gap"] > 3 * prog[part]["logit_gap"]
    # Through the cell's own checks: the control is not correct.
    assert all(c.ok for c in learner.compare(prog, LIMITS))
    assert not all(c.ok for c in learner.compare(ctrl, LIMITS))


def test_the_window_s_last_call_is_judged(monkeypatch):
    """A fault that starts only inside the window: set-up's call reads
    sound, the window's last call does not."""
    from nuzero_tpu_torch.training.learner import Learner

    apply = Learner.apply_gradients
    calls = {"n": 0}

    def late(self, state, grads):
        calls["n"] += 1
        if calls["n"] <= 4:  # set-up's call: num_samples updates
            return apply(self, state, grads)
        return type(state)(params=state.params, opt_state=state.opt_state, step=state.step + 1)

    monkeypatch.setattr(Learner, "apply_gradients", late)
    checks, _ = run()
    assert checks["grad_gap"].ok and checks["change_gap"].ok
    assert not checks["window_change_gap"].ok and not checks["stale_leaves"].ok


def test_an_update_that_leaves_the_state_unchanged(monkeypatch):
    from nuzero_tpu_torch.training.learner import Learner

    def unchanged(self, state, grads):
        return type(state)(params=state.params, opt_state=state.opt_state, step=state.step + 1)

    monkeypatch.setattr(Learner, "apply_gradients", unchanged)
    checks, _ = run()
    # Neither a first moment nor a change: both read 1, in either call.
    for prefix in ("", "window_"):
        assert checks[prefix + "grad_gap"].value == pytest.approx(1.0)
        assert checks[prefix + "change_gap"].value == pytest.approx(1.0)
        assert not checks[prefix + "grad_gap"].ok and not checks[prefix + "change_gap"].ok


def test_an_update_that_leaves_the_parameters_unchanged(monkeypatch):
    from nuzero_tpu_torch.training.learner import Learner

    apply = Learner.apply_gradients

    def unmoved(self, state, grads):
        new = apply(self, state, grads)
        return type(new)(params=state.params, opt_state=new.opt_state, step=new.step)

    monkeypatch.setattr(Learner, "apply_gradients", unmoved)
    checks, _ = run()
    assert not checks["change_gap"].ok and not checks["window_change_gap"].ok


def test_half_the_batch_left_out(monkeypatch):
    from nuzero_tpu_torch.training import losses

    combined = losses.combined_loss

    def half(p, v, pt, vt, **kw):
        h = p.shape[0] // 2
        return combined(p[:h], v[:h], pt[:h], vt[:h], **kw)

    monkeypatch.setattr(losses, "combined_loss", half)
    checks, _ = run()
    assert not (checks["loss_gap"].ok and checks["grad_gap"].ok)
    assert not (checks["window_loss_gap"].ok and checks["window_grad_gap"].ok)


def test_positions_drawn_from_the_wrong_weights(monkeypatch):
    from nuzero_tpu_torch.training import replay

    weights = replay.position_weights
    monkeypatch.setattr(replay, "position_weights",
                        lambda buffer, late_heavy: weights(buffer, False))
    checks, _ = run()
    assert not checks["draws_off"].ok and not checks["window_draws_off"].ok


def test_a_gradient_altered_where_it_is_produced(monkeypatch):
    from nuzero_tpu_torch.training.learner import Learner

    grads = Learner._grads

    def altered(self, loss, params):
        g = grads(self, loss, params)
        key = max(g, key=lambda k: float(g[k].norm()))
        return {**g, key: g[key] * 2.0}

    monkeypatch.setattr(Learner, "_grads", altered)
    checks, _ = run()
    assert not checks["grad_gap"].ok and not checks["window_grad_gap"].ok
