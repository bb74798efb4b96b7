"""The port's learner against ``nuzero_tpu.training.learner``.

A small hex RecurrentNet (8 filters, SCS 5x5 observations) is initialised
by the JAX package, its Flax variables converted with
``networks/convert.py``, and both learners take 3 updates on the same numpy
batches.  The progressive loss's (n, k) draws come from JAX's keys and are
fed to the port through its ``draws`` hook.

Tolerances, f32, and why:
- losses 1e-5 relative, gradients 1e-5 of each tensor's largest value: the
  same function with sums in another order (XLA's dual 3x3 conv against the
  port's gathered matmul);
- optimizer moments (Adam's mu and nu, SGD's trace) 1e-4 of each tensor's
  largest value after 3 updates: they carry the gradients' differences;
- parameters: Adam moves each parameter by about lr whatever the size of
  its gradient, so for a parameter whose gradient is near zero, a relative
  change of that gradient in the last digits changes its step by a fraction
  of lr.  Parameters are held to 5e-2 of lr per update (SGD's steps scale
  with the gradient: 1e-5 of the largest parameter).
bf16 compute (f32 parameters) takes one Adam update, held to 3e-2 relative
on the losses and 5e-2 of each tensor's largest gradient: bf16 rounds at
other places in the two frameworks, once per conv, through ~20 convs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nuzero_tpu.networks import NetworkManager as JaxManager
from nuzero_tpu.networks import RecurrentNet as JaxRecurrentNet
from nuzero_tpu.training.learner import Learner as JaxLearner
from nuzero_tpu.training.learner import LearnerConfig as JaxLearnerConfig
from nuzero_tpu.training.learner import TrainState as JaxTrainState
from nuzero_tpu_torch.networks.convert import recurrent_net_state_dict
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.recurrent import RecurrentNet
from nuzero_tpu_torch.training.learner import Learner, LearnerConfig, TrainState

torch.set_num_threads(2)

OBS = (86, 5, 5)
ACTIONS = 21 * 25
LR = 1e-3


@functools.lru_cache(maxsize=None)
def _nets(dtype_name="float32"):
    jmgr = JaxManager(JaxRecurrentNet(policy_channels=21, num_filters=8, num_blocks=2,
                                      hex=True, dtype=jnp.dtype(dtype_name)), OBS)
    jvars = jax.jit(jmgr.init)(jax.random.key(3))
    tmgr = NetworkManager(RecurrentNet(OBS[0], 21, num_filters=8, num_blocks=2, hex=True,
                                       dtype=getattr(torch, dtype_name)), OBS)
    return jmgr, jvars, tmgr


def _port_tree(jtree):
    """A Flax-shaped tree (params, a gradient, a moment) as port tensors."""
    return {k: torch.tensor(v) for k, v in
            recurrent_net_state_dict(jax.tree.map(np.asarray, jtree)).items()}


def _batch(seed, batch=8):
    rng = np.random.default_rng(seed)
    obs = (rng.random((batch,) + OBS) < 0.2).astype(np.float32)
    pt = rng.random((batch, ACTIONS)).astype(np.float32)
    pt[rng.random((batch, ACTIONS)) < 0.9] = 0.0
    pt[:, 0] += 1e-3
    pt /= pt.sum(-1, keepdims=True)
    vt = rng.choice([-1.0, 0.0, 1.0], batch).astype(np.float32)
    gt = np.zeros(batch, np.int32)
    return ((jnp.asarray(obs), jnp.asarray(pt), jnp.asarray(vt), jnp.asarray(gt)),
            (torch.from_numpy(obs), torch.from_numpy(pt), torch.from_numpy(vt),
             torch.from_numpy(gt)))


def _jax_draws(rng, m):
    """The JAX learner's progressive draw from ``rng`` (learner.py:147-151)."""
    k_n, k_k = jax.random.split(rng)
    n = int(jax.random.randint(k_n, (), 0, m))
    return n, int(jax.random.randint(k_k, (), 1, m - n + 1))


def _find(tree, cls):
    return next(n for n in jax.tree_util.tree_leaves(tree, is_leaf=lambda n: isinstance(n, cls))
                if isinstance(n, cls))


def _close_tree(got, jtree, tol, what):
    want = _port_tree(jtree)
    assert set(got) == set(want)
    for k in want:
        scale = max(want[k].abs().max().item(), 1e-30)
        err = (got[k] - want[k]).abs().max().item()
        assert err <= tol * scale, f"{what} {k}: {err} > {tol} * {scale}"


def _close_params(got, jparams, atol, what):
    want = _port_tree(jparams)
    for k in want:
        err = (got[k] - want[k]).abs().max().item()
        assert err <= atol, f"{what} {k}: {err} > {atol}"


def _run_pair(cfg: dict, multi_iters=None, updates=3):
    """3 updates of each learner on the same batches; checks losses,
    gradients of the first update, moments and parameters after each."""
    jmgr, jvars, tmgr = _nets()
    jl = JaxLearner(jmgr, JaxLearnerConfig(**cfg))
    queue = []

    def draws(rng, m):
        assert queue, "the port drew more (n, k) than JAX"
        n, k, want_m = queue.pop(0)
        assert m == want_m
        return n, k

    tl = Learner(tmgr, LearnerConfig(**cfg), draws=draws)
    jstate = JaxTrainState(params=jvars, opt_state=jl.tx.init(jvars), step=jnp.int32(0))
    tparams = _port_tree(jvars)
    tstate = TrainState(params=tparams, opt_state=tl.init_opt_state(tparams), step=0)
    alpha = cfg.get("prog_alpha", 0.0)
    j_step, j_multi = jax.jit(jl.train_step), jax.jit(jl.train_step_multi)
    j_grad = jax.jit(jax.grad(lambda p, b, r: jl._forward_loss(p, *b[:3], r)[0]))
    drawn = []
    for u in range(updates):
        rng = jax.random.key(100 + u)
        if multi_iters is None:
            jb, tb = _batch(u)
            if alpha:
                m = cfg["train_iterations"]
                queue.append((*_jax_draws(rng, m), m))
                drawn.append(queue[-1][0])
            if u == 0:
                jg = j_grad(jstate.params, jb, rng)
                _, _, tg = tl.value_and_grad(tstate.params, tb, None)
                queue[:0] = [(*_jax_draws(rng, m), m)] if alpha else []
                _close_tree(tg, jg, 1e-5, "gradient")
            jstate, jm = j_step(jstate, jb, rng)
            tstate, tm = tl.train_step(tstate, tb, None)
        else:
            pairs = [_batch(10 * u + t, batch=4 + 2 * t) for t in range(len(multi_iters))]
            jstate, jm = j_multi(jstate, tuple(p[0] for p in pairs), rng)
            tstate, tm = tl.train_step_multi(tstate, tuple(p[1] for p in pairs), None)
        assert not queue
        assert set(tm) == set(jm)
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
        assert tstate.step == int(jstate.step) == u + 1
        if cfg.get("optimizer", "Adam") == "SGD":
            _close_tree(tstate.opt_state["trace"], _find(jstate.opt_state, optax.TraceState).trace,
                        1e-4, "trace")
            scale = max(v.abs().max().item() for v in tparams.values())
            _close_params(tstate.params, jstate.params, 1e-5 * scale, "params")
        else:
            adam = _find(jstate.opt_state, optax.ScaleByAdamState)
            _close_tree(tstate.opt_state["mu"], adam.mu, 1e-4, "mu")
            _close_tree(tstate.opt_state["nu"], adam.nu, 1e-4, "nu")
            _close_params(tstate.params, jstate.params, 5e-2 * LR * (u + 1), "params")
    return drawn


BOUNDARY = dict(learning_rate=LR, scheduler_boundaries=(2,), scheduler_gamma=0.5)


def test_adam_across_a_schedule_boundary_matches_jax():
    _run_pair(dict(optimizer="Adam", **BOUNDARY))


def test_sgd_nesterov_with_weight_decay_matches_jax():
    _run_pair(dict(optimizer="SGD", nesterov=True, weight_decay=1e-2, momentum=0.9,
                   **BOUNDARY))


@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_progressive_loss_matches_jax(alpha):
    """Both branches (alpha 0.5) and the progressive branch alone (alpha 1)
    at 3 iterations, on JAX's (n, k): a detach at n > 0 among the draws."""
    drawn = _run_pair(dict(optimizer="Adam", train_iterations=3, prog_alpha=alpha,
                           **BOUNDARY))
    assert any(n > 0 for n in drawn), drawn


def test_train_step_multi_matches_jax():
    """Two game types at 2 and 3 iterations, sub-batches of 4 and 6
    positions: the losses weighted by positions, plus loss/type{t}."""
    _run_pair(dict(optimizer="Adam", train_iterations_per_type=(2, 3), **BOUNDARY),
              multi_iters=(2, 3))


def test_unknown_optimizer_falls_back_to_adam():
    _, _, tmgr = _nets()
    learner = Learner(tmgr, LearnerConfig(optimizer="Adagrad"))
    params = {k: torch.zeros(v.shape) for k, v in tmgr.module.named_parameters()}
    assert set(learner.init_opt_state(params)) == {"schedule_count", "count", "mu", "nu"}


def test_schedule_matches_optax():
    """The learning rate at each count, boundaries given unsorted and
    repeated, against optax's piecewise-constant schedule."""
    _, _, tmgr = _nets()
    learner = Learner(tmgr, LearnerConfig(learning_rate=1e-3, scheduler_boundaries=(5, 2, 5),
                                          scheduler_gamma=0.3))
    sched = optax.piecewise_constant_schedule(1e-3, {2: 0.3, 5: 0.3})
    for count in range(8):
        assert learner.learning_rate(count) == float(np.float32(sched(count)))
    opt = Learner.set_schedule_count(learner.init_opt_state({}), 5)
    assert opt["schedule_count"] == 5


def test_bf16_compute_matches_jax():
    """One Adam update with bf16 compute and f32 parameters."""
    jmgr, jvars, tmgr = _nets("bfloat16")
    cfg = dict(optimizer="Adam", learning_rate=LR)
    jl, tl = JaxLearner(jmgr, JaxLearnerConfig(**cfg)), Learner(tmgr, LearnerConfig(**cfg))
    jb, tb = _batch(0)
    rng = jax.random.key(0)
    (jc, (jv, jp)), jg = jax.jit(jax.value_and_grad(
        lambda p: jl._forward_loss(p, *jb[:3], rng), has_aux=True))(jvars)
    tc, (tv, tp), tg = tl.value_and_grad(_port_tree(jvars), tb, None)
    for got, want in ((tc, jc), (tv, jv), (tp, jp)):
        np.testing.assert_allclose(float(got), float(want), rtol=3e-2)
    _close_tree(tg, jg, 5e-2, "bf16 gradient")
