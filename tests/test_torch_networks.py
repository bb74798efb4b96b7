"""The port's RecurrentNet against the JAX RecurrentNet on converted weights.

The JAX net is initialised from a key, its Flax variables go through
``networks/convert.py``, and both nets see the same observations (numpy,
seeded).  f32 tolerance 1e-5 absolute: the nets compute the same
convolutions with sums taken in another order (outputs are O(1)).  bf16
tolerance: 1e-2 of the output scale, a few bf16 roundings (2^-8 relative
each) that the two frameworks place differently."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuzero_tpu.networks import NetworkManager as JaxManager
from nuzero_tpu.networks import RecurrentNet as JaxRecurrentNet
from nuzero_tpu_torch.networks.convert import recurrent_net_state_dict
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.recurrent import RecurrentNet

torch.set_num_threads(2)

OBS = (86, 5, 5)
POLICY_CHANNELS = 21


@functools.lru_cache(maxsize=None)
def _pair(dtype_name="float32", filters=8, hex=True):
    jmod = JaxRecurrentNet(
        policy_channels=POLICY_CHANNELS, num_filters=filters, num_blocks=2,
        hex=hex, dtype=jnp.dtype(dtype_name),
    )
    jmgr = JaxManager(jmod, OBS)
    jvars = jax.jit(jmgr.init)(jax.random.key(3))
    tmod = RecurrentNet(
        OBS[0], POLICY_CHANNELS, num_filters=filters, num_blocks=2, hex=hex,
        dtype=getattr(torch, dtype_name),
    )
    sd = recurrent_net_state_dict(jax.tree.map(np.asarray, jvars))
    tvars = {k: torch.tensor(v) for k, v in sd.items()}
    assert set(tvars) == {k for k, _ in tmod.named_parameters()}
    for k, p in tmod.named_parameters():
        assert tuple(p.shape) == tuple(tvars[k].shape), k
    return jmgr, jvars, NetworkManager(tmod, OBS), tvars


def _obs(batch=4, seed=0):
    return np.random.default_rng(seed).standard_normal((batch,) + OBS).astype(np.float32)


@pytest.mark.parametrize("iters", [1, 2, 6])
def test_recurrent_net_matches_jax_f32(iters):
    jmgr, jvars, tmgr, tvars = _pair()
    obs = _obs()
    jp, jv, jt = map(np.asarray, jmgr.apply(jvars, jnp.asarray(obs), iters))
    with torch.no_grad():
        tp, tv, tt = tmgr.apply(tvars, torch.from_numpy(obs), iters)
    assert tp.shape == jp.shape and tv.shape == jv.shape and tt.shape == jt.shape
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), jt, rtol=0, atol=1e-5)


def test_ortho_recurrent_net_matches_jax_f32():
    jmgr, jvars, tmgr, tvars = _pair(hex=False)
    obs = _obs()
    jp, jv, _ = map(np.asarray, jmgr.apply(jvars, jnp.asarray(obs), 2))
    with torch.no_grad():
        tp, tv, _ = tmgr.apply(tvars, torch.from_numpy(obs), 2)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k,m", [(1, 1), (2, 4)])
def test_interim_thought_resumes(k, m):
    """k iterations, then m more from the interim thought == k + m."""
    jmgr, jvars, tmgr, tvars = _pair()
    obs = torch.from_numpy(_obs())
    with torch.no_grad():
        _, _, mid = tmgr.apply(tvars, obs, k)
        p1, v1, t1 = tmgr.apply(tvars, obs, m, interim_thought=mid)
        p2, v2, t2 = tmgr.apply(tvars, obs, k + m)
    torch.testing.assert_close(t1, t2, rtol=0, atol=0)
    torch.testing.assert_close(p1, p2, rtol=0, atol=0)
    torch.testing.assert_close(v1, v2, rtol=0, atol=0)
    jp, _, _ = jmgr.apply(jvars, jnp.asarray(obs.numpy()), k + m)
    np.testing.assert_allclose(p1.numpy(), np.asarray(jp), rtol=0, atol=1e-5)


def test_limit_masks_iterations():
    """``limit`` turns the later iterations into the identity."""
    _, _, tmgr, tvars = _pair()
    obs = torch.from_numpy(_obs())
    with torch.no_grad():
        (p1, _), t1 = torch.func.functional_call(tmgr.module, tvars, (obs, 5, None, None, 2))
        p2, _, t2 = tmgr.apply(tvars, obs, 2)
    torch.testing.assert_close(t1, t2, rtol=0, atol=0)
    torch.testing.assert_close(p1, p2, rtol=0, atol=0)


@pytest.mark.parametrize("iters", [1, 2, 6])
def test_recurrent_net_matches_jax_bf16(iters):
    jmgr, jvars, tmgr, tvars = _pair("bfloat16")
    obs = _obs()
    jp, jv, jt = jmgr.apply(jvars, jnp.asarray(obs), iters)
    with torch.no_grad():
        tp, tv, tt = tmgr.apply(tvars, torch.from_numpy(obs), iters)
    assert tp.dtype == torch.float32 and tv.dtype == torch.float32
    assert tt.dtype == torch.bfloat16 and jt.dtype == jnp.bfloat16
    for got, want in ((tp, jp), (tv, jv), (tt.float(), jt.astype(jnp.float32))):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2 * scale)


def test_inference_return_conventions():
    _, _, tmgr, tvars = _pair()
    obs = torch.from_numpy(_obs())
    with torch.no_grad():
        p, v = tmgr.inference(tvars, obs)
        (p2, v2), interim = tmgr.inference(tvars, obs, training=True)
    assert p.shape == (4, POLICY_CHANNELS * 25) and v.shape == (4,)
    torch.testing.assert_close(p, p2)
    assert interim.shape == (4, 5, 5, 8)
