"""The arena driver on the CPU at a tiny size, on the committed checkpoint:
a sound run is correct, and a run with the match broken underneath is not."""

import copy
import time

import torch

from cardbench import harness
from cardbench.drivers import arena

SEED = 2**31 + 2929


def tiny():
    cell = harness.find_cell("arena.sweep64_s15")
    t = copy.deepcopy(cell.traffic)
    t.update(board_size=7, turns=10, iterations=2, games=6, check_moves=16)
    cell.traffic = t
    cell.limits = dict(cell.limits, logit_gap=1e-5, min_positions_compared=4)
    return cell


def run(control=None):
    out = arena.run(tiny(), seed=SEED, seconds=1.0, trace=False, device=torch.device("cpu"),
                    t_start=time.perf_counter(), control=control)
    return {c.name: c for c in out.checks}, out


def test_a_sound_run_is_correct():
    checks, out = run()
    assert all(c.ok for c in checks.values()), [c.line() for c in checks.values()]
    assert out.end_to_end["arena_move_p95_ms"]["value"] > 0
    assert out.end_to_end["arena_positions_per_s"]["value"] > 0


def test_a_move_that_leaves_the_state_unchanged(monkeypatch):
    from nuzero_tpu_torch.envs.scs.game import SCSGame

    monkeypatch.setattr(SCSGame, "step", lambda self, state, action: state)
    checks, _ = run()
    assert not checks["transitions_wrong"].ok


def test_half_the_batch_left_out(monkeypatch):
    from nuzero_tpu_torch.networks.recurrent import RecurrentNet

    forward = RecurrentNet.forward

    def half(self, x, *args, **kwargs):
        (p, v), thought = forward(self, x, *args, **kwargs)
        h = max(1, p.shape[0] // 2)
        p = torch.cat([p[:h], p[:h].mean(0, keepdim=True).expand(p.shape[0] - h, -1)])
        return (p, v), thought

    monkeypatch.setattr(RecurrentNet, "forward", half)
    checks, _ = run()
    assert not checks["logit_gap"].ok


def test_an_action_altered_where_it_is_produced(monkeypatch):
    from nuzero_tpu_torch.evaluation import agents

    build = agents.PolicyAgent._build_policy

    def altered(self, env):
        choose = build(self, env)

        def second_best(variables, states, lengths, rng):
            logits, _, _ = self.manager.apply(variables, env.observe(states),
                                              iters_to_do=self.recurrent_iterations)
            legal = env.legal_mask(states)
            best = choose(variables, states, lengths, rng).long()
            masked = torch.where(legal, logits, float("-inf"))
            masked = masked.scatter(1, best[:, None], float("-inf"))
            alt = torch.argmax(masked, dim=-1)
            return torch.where(legal.sum(-1) > 1, alt, best).to(torch.int32)

        return second_best

    monkeypatch.setattr(agents.PolicyAgent, "_build_policy", altered)
    checks, _ = run()
    assert not checks["actions_off"].ok


def test_the_control_reads_above_the_program_and_fails():
    _, out = run(control="tf32")
    prog, ctrl = out.context["readings"], out.context["control"]
    assert ctrl["logit_gap"] > 3 * prog["logit_gap"]
    # Through the cell's own checks: the control is not correct.
    limits = tiny().limits
    assert all(c.ok for c in arena.compare(prog, limits))
    assert not all(c.ok for c in arena.compare(ctrl, limits))


def test_counts_altered(monkeypatch):
    from nuzero_tpu_torch.evaluation import arena as port_arena

    play = port_arena.Arena.play

    def altered(self, *args, **kwargs):
        stats = play(self, *args, **kwargs)
        stats.p1_wins += 1
        return stats

    monkeypatch.setattr(port_arena.Arena, "play", altered)
    checks, _ = run()
    assert not checks["counts_wrong"].ok
