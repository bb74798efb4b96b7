"""The port's losses against ``nuzero_tpu.training.losses`` on the same
numpy inputs (targets with exact zeros), f32, within 1e-6 relative: the
same reductions in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuzero_tpu.training import losses as jax_losses
from nuzero_tpu_torch.training import losses


def _inputs(seed=0, batch=16, actions=525):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((batch, actions))).astype(np.float32)
    target = rng.random((batch, actions)).astype(np.float32)
    target[rng.random((batch, actions)) < 0.8] = 0.0  # most actions unvisited
    target[0] = 0.0
    target[0, 3] = 1.0  # a one-hot row
    target /= target.sum(-1, keepdims=True)
    v_pred = np.tanh(rng.standard_normal(batch)).astype(np.float32)
    v_target = rng.choice([-1.0, 0.0, 1.0], batch).astype(np.float32)
    return logits, target, v_pred, v_target


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["CEL", "KLD", "MSE"])
def test_policy_losses_match_jax(name):
    logits, target, _, _ = _inputs()
    got = losses.POLICY_LOSSES[name](torch.from_numpy(logits), torch.from_numpy(target))
    want = jax_losses.POLICY_LOSSES[name](jnp.asarray(logits), jnp.asarray(target))
    assert got.shape == (16,)
    _close(got.numpy(), want)


@pytest.mark.parametrize("name", ["SE", "AE"])
def test_value_losses_match_jax(name):
    _, _, v_pred, v_target = _inputs(seed=1)
    got = losses.VALUE_LOSSES[name](torch.from_numpy(v_pred), torch.from_numpy(v_target))
    _close(got.numpy(), jax_losses.VALUE_LOSSES[name](jnp.asarray(v_pred), jnp.asarray(v_target)))


@pytest.mark.parametrize("policy_loss", ["CEL", "KLD", "MSE"])
@pytest.mark.parametrize("value_loss", ["SE", "AE"])
@pytest.mark.parametrize("normalize", [False, True])
def test_combined_loss_matches_jax(policy_loss, value_loss, normalize):
    """(value, policy, combined), with and without dividing the policy loss
    by log(num_actions)."""
    logits, target, v_pred, v_target = _inputs(seed=2)
    arrays = (logits, v_pred, target, v_target)
    got = losses.combined_loss(*map(torch.from_numpy, arrays), policy_loss=policy_loss,
                               value_loss=value_loss, normalize_policy=normalize)
    want = jax_losses.combined_loss(*map(jnp.asarray, arrays), policy_loss=policy_loss,
                                    value_loss=value_loss, normalize_policy=normalize)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
