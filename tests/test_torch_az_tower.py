"""AlphaZero's batch-norm residual tower (``networks/resnet.py`` with
``batch_norm=True``) against its plain reference (``tests/plain_az_tower.py``,
plain torch in f32) at a small size: 3 blocks of 16 filters on a 5x5 hex
board.  The forward in both norm modes, one learner update (loss,
gradients, running statistics, Adam's step), the tower through
``AlphaZero``'s self-play, update and checkpoint, its run directory, and a
planted fault the benchmark's comparison must catch.  The card test at the
end skips without a card."""

import json
import os
import sys

import pytest
import torch

from nuzero_tpu_torch.config.run_meta import build_from_meta, load_run_meta, save_run_meta
from nuzero_tpu_torch.config.schemas import (
    LearningConfig, PlottingConfig, RunningConfig, SavingConfig, TestingFrequencyConfig,
    TrainingConfig,
)
from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.networks.blocks import BatchNorm, batch_statistics, update_running_stats
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.resnet import ResNet
from nuzero_tpu_torch.search.mcts import SearchParams
from nuzero_tpu_torch.training.learner import Learner, LearnerConfig, TrainState
from nuzero_tpu_torch.training.pipeline import AlphaZero

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import plain_az_tower as plain  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIO = os.path.join(REPO, "configs", "scenarios", "open_field_5.yml")
OBS, PLANES, FILTERS, BLOCKS = 10, 21, 16, 3


def _tower(dtype=torch.float32, seed=0):
    """(manager, parameters): seeded conv weights at the port's initializer
    bound, norm scales in U(0.5, 1.5), biases in U(-0.25, 0.25), running
    means in U(-0.5, 0.5) and variances in U(0.5, 2)."""
    net = ResNet(OBS, PLANES, num_filters=FILTERS, num_blocks=BLOCKS, batch_norm=True,
                 dtype=dtype)
    mgr = NetworkManager(net, (OBS, 5, 5))
    gen = torch.Generator().manual_seed(seed)
    params = mgr.init(gen)
    for name, t in params.items():
        u = torch.rand(t.shape, generator=gen) * 2 - 1
        if t.dim() == 1 and name.endswith("weight"):
            params[name] = 1 + 0.5 * u
        elif name.endswith("bias"):
            params[name] = 0.25 * u
        elif name.endswith("running_mean"):
            params[name] = 0.5 * u
        elif name.endswith("running_var"):
            params[name] = 1.25 + 0.75 * u
    return mgr, params


def _batch(n=8, seed=1):
    gen = torch.Generator().manual_seed(seed)
    obs = torch.randn((n, OBS, 5, 5), generator=gen)
    target = torch.softmax(3 * torch.randn((n, PLANES * 25), generator=gen), -1)
    return obs, target, torch.rand(n, generator=gen) * 2 - 1


def test_the_layout_is_the_ports():
    mgr, params = _tower()
    named, buffers = plain.layout(OBS, PLANES, FILTERS, BLOCKS)
    assert dict(named + buffers) == {k: tuple(v.shape) for k, v in params.items()}
    assert {k for k, _ in buffers} == {k for k, _ in mgr.module.named_buffers()}
    assert sum(isinstance(m, BatchNorm) for m in mgr.module.modules()) == BLOCKS + 5


# bf16: every conv rounds its inputs to bf16's 8-bit mantissa (relative
# error 2^-9 each) and the norms, rectifiers and skip additions round their
# outputs to bf16, ~14 roundings deep here.  These seeds read 6e-3 of the
# largest logit and 1.3e-2 of the largest value (a tanh of a small mean);
# 3e-2 holds that with room, where a norm left out reads ~1.  f32 reads
# 4.5e-7.
@pytest.mark.parametrize("train", [False, True], ids=["running", "batch"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_forward_matches_the_reference(dtype, tol, train):
    mgr, params = _tower(dtype)
    obs, _, _ = _batch()
    with torch.no_grad():
        if train:
            with batch_statistics(mgr.module) as records:
                p, v, _ = mgr.apply(params, obs)
            moved = update_running_stats(params, records)
        else:
            p, v, _ = mgr.apply(params, obs)
        want_p, want_v, want_moved = plain.forward(params, obs, train=train)
    for got, want in ((p, want_p), (v, want_v)):
        assert got.dtype == torch.float32
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=tol * scale)
    if train:
        assert set(moved) == set(want_moved) and len(moved) == 2 * (BLOCKS + 5)
        # In bf16 the statistics are of the bf16 conv outputs (2.1e-4 off).
        for k in moved:
            torch.testing.assert_close(moved[k], want_moved[k], rtol=0,
                                       atol=1e-6 if dtype == torch.float32 else 2e-3)
    else:
        assert not any(m.record for m in mgr.module.modules() if isinstance(m, BatchNorm))


def test_one_update_matches_the_reference():
    """Loss, every gradient, the moved running statistics and Adam's first
    step of the port's learner against the reference's one update."""
    mgr, params = _tower()
    obs, pt, vt = _batch(16)
    lr = 1e-3
    learner = Learner(mgr, LearnerConfig(optimizer="Adam", learning_rate=lr))
    state = TrainState(params=params, opt_state=learner.init_opt_state(params), step=0)
    assert set(state.opt_state["mu"]) == {k for k, _ in mgr.module.named_parameters()}
    batch = (obs, pt, vt, torch.zeros(16, dtype=torch.int32))
    with batch_statistics(mgr.module):
        _, _, grads = learner.value_and_grad(params, batch, None)
    new, metrics = learner.train_step(state, batch)
    loss, want_grads, want_new = plain.update(params, obs, pt, vt, lr)
    torch.testing.assert_close(metrics["loss/combined"], loss, rtol=1e-6, atol=0)
    assert set(grads) == set(want_grads)
    for k, g in grads.items():
        scale = float(want_grads[k].abs().max())
        torch.testing.assert_close(g, want_grads[k], rtol=0, atol=1e-5 * scale, msg=k)
    assert set(new.params) == set(want_new) and new.step == 1
    for k, p in new.params.items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(p, want_new[k], rtol=0, atol=1e-6, msg=k)
            assert not torch.equal(p, params[k]), k
        else:
            # Adam's first step is lr * g / (|g| + eps): where a gradient is
            # near zero its sign and size follow the last bits of g.
            big = want_grads[k].abs() > 1e-6
            torch.testing.assert_close(p[big], want_new[k][big], rtol=0, atol=1e-3 * lr,
                                       msg=k)
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(torch.sqrt(sum((g ** 2).sum() for g in want_grads.values()))), rel=1e-5)


def test_the_learner_refuses_what_it_cannot_do():
    mgr, params = _tower()
    state = TrainState(params=params, opt_state={}, step=0)
    obs, pt, vt = _batch(4)
    batch = (obs, pt, vt, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="sub-batch"):
        Learner(mgr, LearnerConfig()).train_step_multi(state, [batch, batch])

    class Mesh:
        size, rank = 1, 0

    with pytest.raises(NotImplementedError, match="cross-rank batch statistics"):
        Learner(mgr, LearnerConfig(), mesh=Mesh())


def _config():
    return TrainingConfig(
        running=RunningConfig(num_actors=4, training_steps=1,
                              num_games_per_type_per_step=1),
        testing=TestingFrequencyConfig(policy_test_frequency=0, mcts_test_frequency=0),
        plotting=PlottingConfig(plot_loss=False),
        learning=LearningConfig(replay_window_size=16, batch_size=8, num_samples=1),
        saving=SavingConfig(save_frequency=1))


def _coordinator(run_dir):
    env = SCSGame(load_scenario(SCENARIO, seed=42, turns=2), device="cpu")
    torch.manual_seed(0)
    net = ResNet(env.observation_shape[0], env.action_space_shape[0], num_filters=8,
                 num_blocks=2, batch_norm=True)
    return AlphaZero(env, NetworkManager(net, env.observation_shape), _config(),
                     SearchParams(num_simulations=2), run_dir=run_dir)


def test_a_tower_plays_trains_and_restores(tmp_path):
    """``AlphaZero`` with the tower plays its eager moves, trains once and
    checkpoints; the update's running statistics are in the state, the
    optimizer holds none, and a fresh coordinator restores them; the run
    directory's meta rebuilds the same tower."""
    az = _coordinator(str(tmp_path))
    initial = az.learner.init_state(torch.Generator().manual_seed(0)).params
    state = az.run(seed=0)
    assert state.step == 1 and az.buffer.num_games >= 1
    stats = [k for k, _ in az.manager.module.named_buffers()]
    assert len(stats) == 2 * 7
    for k in stats:
        assert not torch.equal(state.params[k], initial[k]), k
        assert k not in state.opt_state["mu"]
    restored, step = _coordinator(str(tmp_path)).load("auto")
    assert step == 1
    for k, v in state.params.items():
        torch.testing.assert_close(restored.params[k], v, rtol=0, atol=0)

    save_run_meta(str(tmp_path), "scs", "resnet", scenario="open_field_5.yml",
                  num_filters=8, num_blocks=2, batch_norm=True)
    _, mgr = build_from_meta(load_run_meta(str(tmp_path)), REPO, device="cpu")
    assert mgr.has_batch_norm and len(mgr.module.blocks) == 2
    assert {k: v.shape for k, v in mgr.module.state_dict().items()} == {
        k: v.shape for k, v in state.params.items()}
    meta = load_run_meta(str(tmp_path))
    del meta["batch_norm"]  # a meta written before the key
    assert not build_from_meta(meta, REPO, device="cpu")[1].has_batch_norm


def _log_priors(logits, legal):
    z = torch.where(legal, logits.double(), float("-inf"))
    return z - torch.logsumexp(z, dim=-1, keepdim=True)


def test_the_cells_comparison_catches_the_norms_left_out(monkeypatch):
    """The self-play cell's ``prior_gap`` (the widest gap of a legal
    action's log prior) stays under the cell's limit for the tower, and a
    tower whose norms are left out reads above it; the heads' last convs at
    1/32 of their bound, as the cell draws them."""
    with open(os.path.join(REPO, "cardbench", "limits", "selfplay.az19x256.json")) as f:
        limit = json.load(f)["prior_gap"]
    mgr, params = _tower()
    for name in ("policy_head.convs.1.conv.weight", "value_head.convs.3.conv.weight"):
        params[name] = params[name] / 32
    obs, _, _ = _batch(16)
    legal = torch.rand((16, PLANES * 25), generator=torch.Generator().manual_seed(2)) < 0.3
    want = _log_priors(plain.forward(params, obs)[0], legal)

    def gap():
        with torch.no_grad():
            got = _log_priors(mgr.apply(params, obs)[0], legal)
        return float(torch.where(legal, (got - want).abs(), 0.0).max())

    assert gap() <= limit
    monkeypatch.setattr(BatchNorm, "forward", lambda self, x: x)
    assert gap() > limit


@pytest.mark.cuda
def test_the_captured_move_reads_the_updated_statistics():
    """On the card: the tower's move captured as a CUDA graph, one update,
    then the graph's parameters reloaded: they hold the update's running
    statistics, and the next replay plays what the eager move plays with
    them, not with the old ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nuzero_tpu_torch.training.selfplay import (
        copy_selfplay, init_selfplay, move_tensors, play_in_place,
    )

    dev = torch.device("cuda")
    env = SCSGame(load_scenario(SCENARIO, seed=42), device=dev)
    net = ResNet(env.observation_shape[0], env.action_space_shape[0], num_filters=64,
                 num_blocks=4, batch_norm=True, dtype=torch.bfloat16).to(dev)
    cfg = TrainingConfig(
        running=RunningConfig(num_actors=64, training_steps=1, num_games_per_type_per_step=1),
        testing=TestingFrequencyConfig(policy_test_frequency=0, mcts_test_frequency=0),
        learning=LearningConfig(replay_window_size=64, batch_size=32, num_samples=1))
    az = AlphaZero(env, NetworkManager(net, env.observation_shape), cfg,
                   SearchParams(num_simulations=8, keep_subtree=True), run_dir=None)
    state = az.learner.init_state(torch.Generator(device=dev).manual_seed(0))
    sp = init_selfplay(env, 64, torch.Generator(device=dev).manual_seed(1),
                       az.trajectory_length, search_params=az.search_params,
                       state_dim=az.state_dim)
    step = az.sp_steps[0]
    az._selfplay_until(state, sp, step, 8)
    az._rng = torch.Generator(device=dev).manual_seed(2)
    az._host_rng = torch.Generator().manual_seed(3)
    new, _ = az._train_once(state)
    stats = [k for k, _ in net.named_buffers()]
    assert all(not torch.equal(new.params[k], state.params[k]) for k in stats)
    move = az._mover(step, sp, new.params)
    graph = az._graphs[step]
    for k in stats:
        assert torch.equal(graph.params[k], new.params[k]), k
    before = copy_selfplay(sp)
    old = copy_selfplay(sp)
    move()
    torch.cuda.synchronize()
    eager = move_tensors(before, *play_in_place(step, new.params, before))
    stale = move_tensors(old, *play_in_place(step, state.params, old))
    replayed = move_tensors(sp, graph.finished, graph.stats)
    tensors = [k for k, v in replayed.items() if isinstance(v, torch.Tensor) and k != "rng"]
    assert all(torch.equal(replayed[k], eager[k]) for k in tensors)
    assert not all(torch.equal(replayed[k], stale[k]) for k in tensors)
